"""The port's VAE decoder (dalle_mtf_tpu_torch/models/vae.py) against the
JAX VAE on the same JAX-initialized parameters: decode_tokens in fp32 at
atol 1e-5 pins the HWIO -> torch kernel mapping, and above all the SAME
transpose-conv mapping (a flipped kernel with padding 1 in torch for JAX's
unflipped correlation over the 2x-dilated input padded (2, 2))."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import vae as jvae
from dalle_mtf_tpu_torch.models import vae as tvae
from dalle_mtf_tpu_torch.utils.convert import vae_params_from_numpy


@pytest.mark.parametrize("stack_factor,image_size", [(1, 16), (2, 32)])
def test_decode_tokens_matches_jax(stack_factor, image_size):
    kw = dict(num_tokens=32, image_size=image_size, convblocks=((1, 8), (2, 16)),
              stack_factor=stack_factor)
    jm = jvae.DiscreteVAE(jvae.VAEConfig(**kw))
    tm = tvae.DiscreteVAE(tvae.VAEConfig(**kw))
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    tparams = vae_params_from_numpy(jparams, tm)
    tokens = np.random.default_rng(0).integers(0, 32, (2, jm.cfg.image_seq_len))
    want = np.asarray(jm.decode_tokens(jparams, jnp.asarray(tokens, jnp.int32)))
    got = tm.decode_tokens(tparams, torch.from_numpy(tokens))
    assert tuple(got.shape) == want.shape == (2, image_size, image_size, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_conv_transpose_matches_jax_on_random_input():
    """The up-conv alone, on non-one-hot input and a rectangular map."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)  # NHWC
    p = {"w": rng.standard_normal((4, 4, 6, 7)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    want = np.asarray(jvae._conv_transpose(jnp.asarray(x), jax.tree.map(jnp.asarray, p)))
    got = tvae._conv_transpose(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        {k: torch.from_numpy(v) for k, v in p.items()},
    ).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == (2, 6, 10, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_init_and_config_match_jax():
    from dalle_mtf_tpu.utils.config import fetch_model_params as jfetch

    params = jfetch("vae_coco")
    want = jvae.VAEConfig.from_params(params)
    got = tvae.VAEConfig.from_params(params)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.image_seq_len == want.image_seq_len == 1024

    kw = dict(num_tokens=32, image_size=16, convblocks=((1, 8), (2, 16)))
    jparams = jax.device_get(jvae.DiscreteVAE(jvae.VAEConfig(**kw)).init(
        jax.random.PRNGKey(0)))
    tparams = tvae.DiscreteVAE(tvae.VAEConfig(**kw)).init(
        torch.Generator().manual_seed(0))
    for path, want_leaf in jax.tree_util.tree_leaves_with_path(
        {"codebook": jparams["codebook"], "decoder": jparams["decoder"]}
    ):
        node = tparams
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == want_leaf.shape, path
        # glorot-uniform: same limit, so the same max |w| up to sampling
        np.testing.assert_allclose(node.abs().max().item(), np.abs(want_leaf).max(),
                                   rtol=0.2, atol=1e-7)
