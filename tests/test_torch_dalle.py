"""The port's DALLE (dalle_mtf_tpu_torch/models/dalle.py) against the JAX
model on the same JAX-initialized parameters, carried across as numpy
(utils/convert.py): banded prefill logits and KV cache, then three decode
steps. CPU, tiny shapes; attention on both sides runs its plain version.

Tolerances: fp32 atol 1e-4 (same math, other summation order, through two
layers). bf16 atol 3e-2 on logits of |x| < ~1.5: the two frameworks round
bf16 at different points inside fused ops, ~2^-8 relative per rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.utils.convert import dalle_params_from_numpy

KW = dict(
    n_embd=256, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
    image_seq_len=16, n_layers=2, n_heads=2,
)


def _models(**over):
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW, **over))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW, **over))
    return jm, tm


@pytest.fixture(scope="module")
def jax_params():
    jm, _ = _models()
    return jax.device_get(jm.init(jax.random.PRNGKey(0)))


def _run_both(jm, tm, jparams, steps=3, batch=2):
    """Prefill + ``steps`` decode steps in both packages; yields
    (name, jax array, torch tensor) pairs to compare."""
    tparams = dalle_params_from_numpy(jparams, tm)
    cfg = jm.cfg
    lo, hi = cfg.text_vocab_size, cfg.text_vocab_size + cfg.image_vocab_size
    text = np.random.default_rng(1).integers(0, lo, (batch, cfg.text_seq_len))
    jcache = jm.init_cache(batch)
    jl, jcache = jm.prefill(jparams, jnp.asarray(text, jnp.int32), jcache, band=(lo, hi))
    tcache = tm.init_cache(batch)
    tl = tm.prefill(tparams, torch.from_numpy(text), tcache, band=(lo, hi))
    t = cfg.text_seq_len
    yield "prefill logits", jl, tl
    yield "prefill k", jcache["k"][:, :, :, :t], tcache["k"][:, :, :, :t]
    yield "prefill v", jcache["v"][:, :, :, :t], tcache["v"][:, :, :, :t]
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)) + lo
        jl, jcache = jm.decode_step(
            jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(t + i), band=(lo, hi)
        )
        tl = tm.decode_step(tparams, tcache, torch.from_numpy(tok), t + i, band=(lo, hi))
        yield f"step {i} logits", jl, tl
    yield "cache k", jcache["k"], tcache["k"]
    yield "cache v", jcache["v"], tcache["v"]


@pytest.mark.parametrize("attention_type", ["global", "local"])
def test_prefill_and_decode_match_jax_fp32(jax_params, attention_type):
    jm, tm = _models(attention_type=attention_type, local_attention_radius=5)
    for name, want, got in _run_both(jm, tm, jax_params):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=1e-4, err_msg=name
        )


@pytest.mark.parametrize("ln_dtype", ["float32", "activation"])
def test_prefill_and_decode_match_jax_bf16(jax_params, ln_dtype):
    jm, tm = _models(bf_16=True, ln_dtype=ln_dtype)
    for name, want, got in _run_both(jm, tm, jax_params, steps=1):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), atol=3e-2,
            err_msg=name,
        )


def test_prefill_rows_writes_only_masked_rows(jax_params):
    """prefill_rows against JAX's: the masked row's cache and logits equal a
    plain prefill, the unmasked row's cache keeps its old contents."""
    jm, tm = _models()
    tparams = dalle_params_from_numpy(jax_params, tm)
    text = np.random.default_rng(4).integers(0, 40, (2, 8))
    old = np.random.default_rng(5).standard_normal(
        (2, 2, 2, 24, 128)).astype(np.float32)
    mask = np.array([True, False])
    jl, jcache = jm.prefill_rows(
        jax_params, jnp.asarray(text, jnp.int32),
        {"k": jnp.asarray(old), "v": jnp.asarray(old)}, jnp.asarray(mask),
    )
    tcache = {"k": torch.from_numpy(old.copy()), "v": torch.from_numpy(old.copy())}
    tl = tm.prefill_rows(tparams, torch.from_numpy(text), tcache, torch.from_numpy(mask))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl[0]), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   atol=1e-4)
        np.testing.assert_array_equal(tcache[name][:, 1].numpy(), old[:, 1])


def test_init_matches_jax_shapes_and_stddevs(jax_params):
    _, tm = _models()
    tparams = tm.init(torch.Generator().manual_seed(0))
    jflat = dict(jax.tree_util.tree_leaves_with_path(jax_params))
    jflat = {jax.tree_util.keystr(k): v for k, v in jflat.items()}
    tflat = {}
    for k, v in tparams.items():
        for n, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            tflat[f"['{k}']" + (f"['{n}']" if n else "")] = t
    assert set(tflat) == set(jflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert tuple(got.shape) == want.shape, key
        assert got.dtype == torch.float32, key
        np.testing.assert_allclose(got.std().item(), np.std(want), rtol=0.1,
                                   atol=1e-7, err_msg=key)
        np.testing.assert_allclose(got.mean().item(), np.mean(want), atol=5e-3,
                                   err_msg=key)


def test_config_from_dalle_coco_matches_jax():
    from dalle_mtf_tpu.utils.config import fetch_model_params as jfetch
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params("dalle_coco")
    assert params == jfetch("dalle_coco")
    want = jdalle.DalleConfig.from_params(params, 1024)
    got = tdalle.DalleConfig.from_params(params, 1024)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("total_tokens", "total_seq_len", "head_dim"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.policy.compute_dtype == torch.bfloat16
