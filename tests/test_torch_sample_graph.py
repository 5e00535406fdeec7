"""The port's device-resident decode step (sample.CapturedDecoder) against
the JAX sampler and the port's eager loops, on the CPU at tiny shapes, with
weights carried across as numpy through ``utils/convert.py``.

On the CPU the decoder runs its step functions eagerly: the functions a CUDA
graph holds on the card, reading and writing the same fixed buffers (the
cache, last logits, position tensor, step index, token buffers and per-row
sampling parameters) and advancing position and step on the device tensors
themselves.

- greedy tokens equal JAX's ``generate_image_tokens`` token for token, for
  every whole-batch key (top_k bucket, top_p present) and in fp32, int8 and
  int4 weights (both packages' dequant form); through the decode-matmul
  wrappers (``decode_kernels``: their plain versions here) they equal the
  port's eager loop, greedy and sampled;
- greedy tokens equal JAX's ``admit_rows`` + ``decode_chunk`` with rows
  admitted at different chunks (mixed positions, rows that finish mid-chunk
  and park);
- sampled tokens equal the port's eager loops (``generate_image_tokens_eager``,
  ``decode_chunk_eager``) drawing from the same seed, and the generator is
  left where the eager loop leaves it.

Greedy tokens are compared exactly: the same fp32 math, and at these widths
no two logits of a row tie within its rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu import quantize as jq
from dalle_mtf_tpu import sample as jsample
from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu_torch import sample as tsample
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.utils.convert import dalle_params_from_numpy

KW = dict(
    n_embd=256, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
    image_seq_len=16, n_layers=2, n_heads=2,
)
QUANTIZE = {"fp32": None, "int8": jq.quantize_layers_int8, "int4": jq.quantize_layers_int4}


def _pair(weights="fp32", seed=7, decode_kernels=False):
    """(JAX model, JAX params, port model, port params) on one draw; int8
    and int4 trees quantized by the JAX package and carried across. Both
    models dequantize as the JAX einsum form does; with ``decode_kernels``
    the port's decode matmuls take the streaming kernels' plain versions
    instead (another order of the fp32 sums than JAX's einsum)."""
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW))
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    if QUANTIZE[weights]:
        jparams = jax.device_get(QUANTIZE[weights](jparams))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW, decode_kernels=decode_kernels), "cpu")
    return jm, jparams, tm, dalle_params_from_numpy(jparams, tm)


def _text(b, seed=2):
    return np.random.default_rng(seed).integers(0, 40, (b, KW["text_seq_len"]))


@pytest.mark.parametrize("weights", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("top_k,top_p", [(0, None), (8, None), (16, 0.9)])
def test_step_greedy_equals_jax_generate_image_tokens(weights, top_k, top_p):
    """Each whole-batch key's step, replayed image_seq_len - 1 times plus the
    last draw, at temperature 0: JAX's scan, token for token."""
    jm, jparams, tm, tparams = _pair(weights)
    text = _text(3)
    want = jsample.generate_image_tokens(jm, jparams, jnp.asarray(text, jnp.int32),
                                         jax.random.PRNGKey(0), temperature=0.0)
    dec = tsample.CapturedDecoder(tm, tparams, 3)
    got = dec.generate(torch.from_numpy(text), 0.0, top_k,
                       None if top_p is None else torch.full((3,), top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the step advanced the device tensors itself: the last token's index
    # and one decoded position a step
    assert int(dec.step) == KW["image_seq_len"] - 1
    assert dec.positions.tolist() == [KW["text_seq_len"] + KW["image_seq_len"] - 1] * 3


@pytest.mark.parametrize("weights", ["int8", "int4"])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_step_through_the_decode_kernels_equals_eager_loop(weights, temperature):
    """With ``decode_kernels`` on (every decode matmul and the banded head
    through the streaming kernels' wrappers, their plain versions here, as
    the graph holds the kernels on the card) the step's tokens equal the
    eager loop's, greedy and sampled."""
    _, _, tm, tparams = _pair(weights, decode_kernels=True)
    assert tm._streaming_eligible(3, KW["n_embd"])
    text = torch.from_numpy(_text(3))
    want = tsample.generate_image_tokens_eager(tm, tparams, text,
                                               torch.Generator().manual_seed(5), temperature, 8)
    dec = tsample.CapturedDecoder(tm, tparams, 3)
    dec.generator.manual_seed(5)
    torch.testing.assert_close(dec.generate(text, temperature, 8), want, rtol=0, atol=0)


def test_decoder_is_reused_across_batches():
    """One decoder (one cache, one set of buffers) serves batch after batch:
    each batch equals a fresh decoder's, whatever the last one left behind."""
    _, _, tm, tparams = _pair()
    dec = tsample.CapturedDecoder(tm, tparams, 2)
    for seed in (3, 4, 5):
        text = torch.from_numpy(_text(2, seed))
        fresh = tsample.CapturedDecoder(tm, tparams, 2)
        torch.testing.assert_close(dec.generate(text, 0.0, 0), fresh.generate(text, 0.0, 0),
                                   rtol=0, atol=0)


def _jax_admit(jm, jparams, state, texts, mask):
    cache, logits, pos = state
    cache, logits, pos = jsample.admit_rows(jm, jparams, cache, logits, pos,
                                            jnp.asarray(texts, jnp.int32), jnp.asarray(mask))
    return cache, logits, pos


@pytest.mark.parametrize("weights", ["fp32", "int8"])
@pytest.mark.parametrize("chunk", [3, 5])
def test_chunk_step_greedy_equals_jax_decode_chunk_and_admit_rows(weights, chunk):
    """Rows admitted at chunks 0, 1 and 3 (so at mixed positions; chunks of
    3 and 5 do not divide 16, so rows finish mid-chunk and park), every
    chunk's tokens and active flags against JAX's engine, greedy."""
    jm, jparams, tm, tparams = _pair(weights)
    b, t, v = 3, KW["text_seq_len"], KW["image_vocab_size"]
    end = t + KW["image_seq_len"]
    texts = _text(b, 9)
    admit_at = {0: [0], 1: [1], 3: [2]}

    jstate = (jm.init_cache(b), jnp.zeros((b, v), jnp.float32), jnp.full((b,), end, jnp.int32))
    dec = tsample.CapturedDecoder(tm, tparams, b, chunk=chunk)
    dec.reset(0)
    zeros = np.zeros((b,), np.float32)
    rng = jax.random.PRNGKey(1)
    for c in range(7):
        if c in admit_at:
            mask = np.isin(np.arange(b), admit_at[c])
            jstate = _jax_admit(jm, jparams, jstate, texts, mask)
            dec.admit(torch.from_numpy(texts), torch.from_numpy(mask))
        cache, logits, pos = jstate
        cache, logits, pos, rng, jtok, jact = jsample.decode_chunk(
            jm, jparams, cache, logits, pos, rng, jnp.asarray(zeros), jnp.zeros((b,), jnp.int32),
            chunk=chunk, k_max=8, top_p_rows=jnp.ones((b,), jnp.float32))
        jstate = (cache, logits, pos)
        tok, act = dec.decode_chunk(zeros, np.zeros((b,), np.int64), np.ones((b,), np.float32),
                                    k_max=8)
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact), err_msg=f"chunk {c}")
        live = act.numpy()
        np.testing.assert_array_equal(tok.numpy()[live], np.asarray(jtok)[live],
                                      err_msg=f"chunk {c}")
        np.testing.assert_array_equal(dec.positions.numpy(), np.asarray(pos))


@pytest.mark.parametrize("top_k,top_p", [(0, None), (8, None), (0, 0.8), (16, 0.9)])
def test_step_sampled_equals_eager_loop(top_k, top_p):
    """At temperature 1 (one row greedy) the step draws what the eager loop
    draws from the same seed, and leaves the generator where it ends."""
    _, _, tm, tparams = _pair()
    text = torch.from_numpy(_text(3))
    temp = torch.tensor([1.0, 0.7, 0.0])
    tp = None if top_p is None else torch.full((3,), top_p)
    g_eager = torch.Generator().manual_seed(11)
    want = tsample.generate_image_tokens_eager(tm, tparams, text, g_eager, temp, top_k, tp)
    g = torch.Generator().manual_seed(11)
    dec = tsample.CapturedDecoder(tm, tparams, 3)
    with dec.drawing_from(g):
        got = dec.generate(text, temp, top_k, tp)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(g.get_state(), g_eager.get_state())
    assert len(set(got[0].tolist())) > 1  # the sampled row's draws move step to step


@pytest.mark.parametrize("nucleus", [False, True])
def test_chunk_step_sampled_equals_eager_decode_chunk(nucleus):
    """The continuous step against ``decode_chunk_eager``, per-row
    temperature/top_k/top_p, rows at mixed positions, same generator."""
    _, _, tm, tparams = _pair()
    b, chunk = 3, 6
    texts = torch.from_numpy(_text(b, 4))
    dec = tsample.CapturedDecoder(tm, tparams, b, chunk=chunk)
    dec.reset(0)
    dec.admit(texts, torch.tensor([True, False, True]))
    temp = np.array([1.0, 0.5, 0.0], np.float32)
    ks = np.array([0, 4, 8], np.int64)
    ps = np.array([0.9, 1.0, 0.5] if nucleus else [1.0] * 3, np.float32)
    # rows 0 and 2 run 6 steps, then row 1 joins mid-sequence
    cache = {k: v.clone() for k, v in dec.cache.items()}
    logits, pos = dec.logits.clone(), dec.positions.clone()
    g_eager = torch.Generator().manual_seed(3)
    dec.generator.manual_seed(3)
    for c in range(3):
        if c == 1:
            mask = torch.tensor([False, True, False])
            logits, pos = tsample.admit_rows(tm, tparams, cache, logits, pos, texts, mask)
            dec.admit(texts, mask)
        logits, pos, want, want_act = tsample.decode_chunk_eager(
            tm, tparams, cache, logits, pos, g_eager, torch.from_numpy(temp),
            torch.from_numpy(ks), chunk=chunk, k_max=8, top_p_rows=torch.from_numpy(ps))
        got, act = dec.decode_chunk(temp, ks, ps, k_max=8)
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"chunk {c}")
        assert torch.equal(act, want_act) and torch.equal(dec.positions, pos)
        torch.testing.assert_close(dec.logits, logits, rtol=0, atol=0)


def test_dispatchers_take_the_eager_loops_on_the_cpu():
    """``generate_image_tokens`` and ``decode_chunk`` on CPU tensors are the
    eager loops (the captured path is for CUDA tensors)."""
    _, _, tm, tparams = _pair()
    text = torch.from_numpy(_text(2))
    a = tsample.generate_image_tokens(tm, tparams, text, torch.Generator().manual_seed(1), 1.0, 8)
    b = tsample.generate_image_tokens_eager(tm, tparams, text,
                                            torch.Generator().manual_seed(1), 1.0, 8)
    assert torch.equal(a, b)
    short = tsample.generate_image_tokens_eager(tm, tparams, text,
                                                torch.Generator().manual_seed(1), 1.0, 8, steps=5)
    assert torch.equal(short, b[:, :5])
