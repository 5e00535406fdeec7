"""The port's sampler (dalle_mtf_tpu_torch/sample.py) against the JAX
sampler: greedy image tokens equal token for token in fp32 on the same
parameters, the nucleus mask is equal, and sampled tokens stay in the image
band and inside the top-k / nucleus candidate sets. (Sampled streams cannot
match: the two packages draw from different generators.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu import sample as jsample
from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu_torch import sample as tsample
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.utils.convert import dalle_params_from_numpy

KW = dict(
    n_embd=256, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
    image_seq_len=16, n_layers=2, n_heads=2,
)


def test_greedy_tokens_match_jax_token_for_token():
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW))
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(7)))
    tparams = dalle_params_from_numpy(jparams, tm)
    text = np.random.default_rng(2).integers(0, 40, (2, 8))
    want = jsample.generate_image_tokens(
        jm, jparams, jnp.asarray(text, jnp.int32), jax.random.PRNGKey(0),
        temperature=0.0,
    )
    got = tsample.generate_image_tokens(
        tm, tparams, torch.from_numpy(text), torch.Generator().manual_seed(0),
        temperature=0.0, top_k=8,  # greedy rows ignore the candidate set
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nucleus_mask_matches_jax():
    rng = np.random.default_rng(0)
    vals = -np.sort(-rng.standard_normal((4, 16)).astype(np.float32), axis=-1)
    safe = np.array([[0.5], [1.0], [1.0], [2.0]], np.float32)
    top_p = np.array([0.1, 0.5, 0.9, 1.0], np.float32)
    want = jsample._nucleus_mask(jnp.asarray(vals), jnp.asarray(safe), jnp.asarray(top_p))
    got = tsample._nucleus_mask(
        torch.from_numpy(vals), torch.from_numpy(safe), torch.from_numpy(top_p)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,top_p", [(4, None), (0, 0.5), (6, 0.8), (64, None)])
def test_sampled_tokens_stay_in_candidate_set(top_k, top_p):
    """Many rows of random logits: every sampled token lies in the row's
    top-k (k clamped to the band width) and, with top_p, in its nucleus;
    temperature-0 rows take the full argmax."""
    rows, width = 256, 32
    logits = torch.randn((rows, width), generator=torch.Generator().manual_seed(1)) * 3
    temp = torch.where(torch.arange(rows) % 4 == 0, 0.0, 1.0)
    tp = None if top_p is None else torch.full((rows,), top_p)
    tok = tsample._sample_token(torch.Generator().manual_seed(2), logits, temp, top_k, tp)
    assert tok.shape == (rows,) and tok.min() >= 0 and tok.max() < width
    order = torch.argsort(logits, dim=-1, descending=True)
    rank = torch.argsort(order, dim=-1).gather(1, tok[:, None])[:, 0]
    greedy = temp == 0
    assert torch.equal(tok[greedy], logits[greedy].argmax(-1))
    k = min(top_k, width) if top_k else (width - 1 if top_p else width)
    assert (rank < k).all()
    if top_p is not None:
        vals = logits.gather(1, order)[:, :k]
        keep = tsample._nucleus_mask(vals, temp.clamp_min(1e-6)[:, None], tp)
        assert keep.gather(1, rank[:, None])[:, 0][~greedy].all()
    # temperature 1 rows really sample: not all of them are the argmax
    assert (tok[~greedy] != logits[~greedy].argmax(-1)).any()


def test_generate_images_shape_and_band():
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW))
    tparams = tm.init(torch.Generator().manual_seed(0))
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig

    vae = DiscreteVAE(VAEConfig(num_tokens=32, image_size=16, convblocks=((1, 8), (2, 16))))
    text = torch.randint(0, 40, (3, 8), generator=torch.Generator().manual_seed(0))
    toks = tsample.generate_image_tokens(
        tm, tparams, text, torch.Generator().manual_seed(1),
        temperature=torch.tensor([1.0, 0.5, 2.0]), top_k=5,
        top_p=torch.tensor([0.9, 1.0, 0.3]),
    )
    assert toks.shape == (3, 16) and toks.min() >= 0 and toks.max() < 32
    imgs = tsample.generate_images(
        tm, tparams, vae, vae.init(torch.Generator().manual_seed(2)), text,
        torch.Generator().manual_seed(1), temperature=1.0, top_k=5,
    )
    assert imgs.shape == (3, 16, 16, 3) and torch.isfinite(imgs).all()
