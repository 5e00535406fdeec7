"""The tile walk of the tensor-core attention kernels, on the CPU.

``dalle_mtf_tpu_torch/ops/attention_tiles.py`` writes the kernels' index arithmetic
once in Python (``key_tile_range``, ``query_tile_range``, ``tile_needs_mask``)
and walks it in plain torch (``attention_tiled_reference``,
``attention_backward_tiled_reference``: online softmax in the log2 domain from
the finite NEG_INF, the mask only on edge tiles, p_v and ds rounded where the
kernels round). The CUDA sources point at those functions as the definition of
their walk, so here they are held

(a) against the dense mask, exhaustively: every live (row, key) pair lies in a
    tile the walk visits, and no tile the walk leaves unmasked holds a masked
    pair (or, where q rows are streamed, a row beyond the sequence);
(b) against the one-shot plain versions ``attention_reference`` and
    ``attention_backward_reference`` in fp32, and against the JAX package:
    its ``attention_reference``, and the value and q/k/v grads of its
    ``causal_attention`` through the Pallas kernels in interpret mode, with
    and without hash dropout (one seed on both sides);
(c) with the fp32 kernels' three-product TF32 split (``split=
    "tf32x3"``), backward and forward (the forward also in the fp32
    kernel's two warp groups a q tile, merged at the end), against the
    one-shot fp32 plain versions and the JAX package's fp32 kernels (the
    loop pair ``_flash_kernel``, ``_bwd_dq_kernel`` + ``_bwd_dkv_kernel``,
    and the wedge regime with dropout): each 64-long tile within 1e-5 of its
    own max |plain|, the kernels' own bound; one TF32 product shown to fail
    that bound at the same inputs, and one accumulator down a long sum too.

The kernels carry their own C++ copy of this arithmetic, which no CPU test
can see: tests/test_torch_cuda.py holds the built kernels to the one-shot
plain versions at the same edge cases, and the built kernel's choice of q
tile to ``forward_tile_rows``.

Tolerance: fp32, max |tiled - one-shot| <= 1e-5 * max(1, max |one-shot|): the
same math summed tile by tile, with exp2 in place of exp; lse atol 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.ops import attention as jattn
from dalle_mtf_tpu_torch.ops import attention as tattn
from dalle_mtf_tpu_torch.ops import attention_tiles as tiles

SEQ_LENS = [1, 63, 64, 65, 129, 200, 1280]
WINDOWS = [None, 1, 37, 64, 256, "wider"]  # "wider": S + 5, wider than the sequence
SEED = 2**31 - 7  # near the top of the range: the uint32 add wraps
TILE = tiles.STREAM_TILE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The walk is thousands of 64-row products: a thread pool only adds its
    hand-offs, and beside other test workers it multiplies the run time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _window(window, s):
    return s + 5 if window == "wider" else window


def _dense_masked(s, padded, window):
    """[padded, padded] bool: True where (row, key) is masked or either lies
    at or beyond the sequence's end."""
    i = np.arange(padded)[:, None]
    j = np.arange(padded)[None, :]
    masked = (j > i) | (i >= s) | (j >= s)
    if window is not None:
        masked |= i - j >= window
    return masked


@pytest.mark.parametrize("rows", tiles.TILE_ROWS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("s", SEQ_LENS)
def test_walk_covers_live_pairs_and_masks_every_edge_tile(s, window, rows):
    window = _window(window, s)
    big = max(rows, TILE)
    padded = -(-s // big) * big
    masked = _dense_masked(s, padded, window)

    # the forward and the dQ pass: q tiles of `rows` rows over 64-key tiles
    covered = np.zeros_like(masked)
    for q0 in range(0, s, rows):
        first, last = tiles.key_tile_range(q0, rows, s, window)
        assert 0 <= first <= last < padded // TILE
        valid_rows = slice(q0, min(q0 + rows, s))  # rows beyond S are never written
        for t in range(first, last + 1):
            c0 = t * TILE
            covered[q0:q0 + rows, c0:c0 + TILE] = True
            if not tiles.tile_needs_mask(q0, rows, c0, TILE, s, window):
                assert not masked[valid_rows, c0:c0 + TILE].any(), (q0, c0)
    assert not (~masked & ~covered).any()

    # the dK/dV pass: key tiles of `rows` keys over 64-row q tiles; a streamed
    # row beyond S must be masked, it would add into a live key's sums
    covered = np.zeros_like(masked)
    for c0 in range(0, s, rows):
        first, last = tiles.query_tile_range(c0, rows, s, window)
        assert 0 <= first <= last < padded // TILE
        valid_keys = slice(c0, min(c0 + rows, s))  # keys beyond S are never written
        for t in range(first, last + 1):
            q0 = t * TILE
            covered[q0:q0 + TILE, c0:c0 + rows] = True
            if not tiles.tile_needs_mask(q0, TILE, c0, rows, s, window, ragged_rows=True):
                assert not masked[q0:q0 + TILE, valid_keys].any(), (q0, c0)
    assert not (~masked & ~covered).any()


def _inputs(s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.random((1, 2, s, d)) * 2 - 1).astype(np.float32))
            for _ in range(4)]


def _close(got, want, atol=1e-5):
    err = (got - want).abs().max().item()
    return err <= atol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", tiles.TILE_ROWS)
@pytest.mark.parametrize("d", tattn.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("s", SEQ_LENS)
def test_tiled_versions_equal_the_one_shot_versions(s, window, d, rows, rate):
    window = _window(window, s)
    q, k, v, g = _inputs(s, d, seed=s + d)
    want, want_lse = tattn.attention_reference(q, k, v, True, window, True, rate, SEED)
    got, got_lse = tiles.attention_tiled_reference(q, k, v, window, rate, SEED, rows)
    assert got.shape == want.shape and got_lse.shape == want_lse.shape == (2, s)
    ok, err = _close(got, want)
    assert ok, ("out", err)
    assert (got_lse - want_lse).abs().max().item() <= 1e-5
    # both backwards from the one-shot forward's out and lse: only the walk differs
    want_grads = tattn.attention_backward_reference(q, k, v, want, want_lse, g, window, rate, SEED)
    got_grads = tiles.attention_backward_tiled_reference(q, k, v, want, want_lse, g, window,
                                                         rate, SEED, rows)
    for name, t, w in zip(("dq", "dk", "dv"), got_grads, want_grads):
        assert t.shape == w.shape
        ok, err = _close(t, w)
        assert ok, (name, err)


@pytest.mark.parametrize("rows", tiles.TILE_ROWS)
@pytest.mark.parametrize("window", [None, 37])
def test_tiled_forward_matches_jax_reference(window, rows):
    q, k, v, _ = _inputs(200, 128, seed=7)
    want = np.asarray(jattn.attention_reference(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), True, window))
    got, _ = tiles.attention_tiled_reference(q, k, v, window, rows=rows)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("rows", tiles.TILE_ROWS)
@pytest.mark.parametrize("window,rate", [(None, 0.0), (64, 0.1), (None, 0.1)])
def test_tiled_versions_match_jax_kernels_value_and_grads(window, rate, rows):
    """The tiled forward and backward against the JAX package's
    ``causal_attention`` and its vjp (Pallas kernels in interpret mode), fp32,
    the hash dropout keyed on the seed the JAX side draws from its rng.
    Tolerance: 1e-5 of the largest |want| of each tensor."""
    q, k, v, g = _inputs(256, 128, seed=5 + (window or 0))
    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(key, (1, 1), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)[0, 0])
    jout, vjp = jax.vjp(
        lambda q_, k_, v_: jattn.causal_attention(
            q_, k_, v_, window=window, use_pallas=True, interpret=True,
            dropout_rate=rate, dropout_rng=key if rate else None),
        jq, jk, jv)
    out, lse = tiles.attention_tiled_reference(q, k, v, window, rate, seed, rows)
    grads = tiles.attention_backward_tiled_reference(q, k, v, out, lse, g, window, rate, seed,
                                                     rows)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (jout, *vjp(jg))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_tiled_versions_round_where_the_kernels_round():
    """In bf16 the tiled versions round p_v and ds to bf16 before their
    products, as the one-shot versions do: the two agree to a bf16 rounding
    of the result (atol 1e-2 on unit-scale inputs), not to fp32's 1e-5."""
    q, k, v, g = (t.to(torch.bfloat16) for t in _inputs(200, 64, seed=3))
    want, lse = tattn.attention_reference(q, k, v, True, 37, True, 0.1, SEED)
    got, got_lse = tiles.attention_tiled_reference(q, k, v, 37, 0.1, SEED)
    assert got.dtype == torch.bfloat16
    assert _close(got.float(), want.float(), 1e-2)[0]
    assert (got_lse - lse).abs().max().item() <= 1e-4
    want_grads = tattn.attention_backward_reference(q, k, v, want, lse, g, 37, 0.1, SEED)
    got_grads = tiles.attention_backward_tiled_reference(q, k, v, want, lse, g, 37, 0.1, SEED)
    for t, w in zip(got_grads, want_grads):
        assert t.dtype == torch.bfloat16 and _close(t.float(), w.float(), 1e-2)[0]


def test_wholly_masked_tile_is_wiped_by_the_first_live_tile():
    """A window that is not a multiple of the tile makes the walk's first key
    tile wholly masked for the q tile's later rows: p = 1 there (m starts at
    the finite NEG_INF), and the next tile's alpha = exp2(NEG_INF - m) = 0
    must wipe it."""
    s, window = 200, 70
    first, _ = tiles.key_tile_range(128, 64, s, window)
    assert first * TILE + TILE <= 191 - window + 1  # row 191 sees no key of that tile
    q, k, v, _ = _inputs(s, 64, seed=11)
    want, want_lse = tattn.attention_reference(q, k, v, True, window, True)
    got, got_lse = tiles.attention_tiled_reference(q, k, v, window)
    assert _close(got, want)[0]
    assert (got_lse - want_lse).abs().max().item() <= 1e-5


TILE_CHOICES = [  # (head_dim, B*H, S, rows)
    (128, 32, 256, 64),      # the serving prefill: 64 CTAs of 128 rows would not fill 132 SMs
    (128, 128, 1280, 128),   # the training shape
    (128, 32, 4352, 128),    # dalle_4k
    (128, 1, 1, 64),
    (128, 2, 6200, 64),      # 98 tiles of 128 rows: under one wave
    (128, 4, 4352, 128),     # 136 tiles
    (64, 256, 1280, 64),     # D = 64 gains nothing from 128 rows
]


@pytest.mark.parametrize("head_dim,programs,s,rows", TILE_CHOICES)
def test_forward_tile_rows_fills_the_card(head_dim, programs, s, rows):
    assert tiles.forward_tile_rows(head_dim, programs, s) == rows
    assert rows in tattn.FORWARD_TILES[head_dim]
    assert tiles.BACKWARD_TILE_ROWS in tiles.TILE_ROWS


def test_misaligned_bf16_view_raises():
    """16-byte copies need 16-byte-aligned rows: a bf16 view that starts off a
    16-byte boundary, or whose rows do, raises instead of being copied; so
    does an fp32 one (the fp32 kernels stage their tiles by 16-byte copies
    too)."""
    buf = torch.zeros(2 * 4 * 8 * 64 + 8, dtype=torch.bfloat16)
    aligned = buf[:2 * 4 * 8 * 64].view(2, 4, 8, 64)
    if aligned.data_ptr() % 16 == 0:
        tattn.check_kernel_inputs("causal_attention_fwd", (aligned,) * 3, 64)
    shifted = buf[1:1 + 2 * 4 * 8 * 64].view(2, 4, 8, 64)
    shifted = shifted if shifted.data_ptr() % 16 else buf[2:2 + 2 * 4 * 8 * 64].view(2, 4, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_fwd", (shifted,) * 3, 64)
    odd_rows = torch.zeros((2, 4, 8, 68), dtype=torch.bfloat16)[..., :64]  # row stride 68
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_fwd", (odd_rows,) * 3, 64)
    fp32 = torch.zeros(2 * 4 * 8 * 64 + 4)
    if fp32.data_ptr() % 16 == 0:
        tattn.check_kernel_inputs("causal_attention_fwd",
                                  (fp32[:2 * 4 * 8 * 64].view(2, 4, 8, 64),) * 3, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_fwd",
                                  (fp32[1:1 + 2 * 4 * 8 * 64].view(2, 4, 8, 64),) * 3, 64)
    odd_rows = torch.zeros((2, 4, 8, 66))[..., :64]  # row stride 66: not whole 16-byte chunks
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_fwd", (odd_rows,) * 3, 64)


# ------------------------------------------------ the fp32 kernels' 3xTF32 split
# The fp32 backward kernels run all five products on the tensor cores as
# three TF32 products each (big·big + big·small + small·big, big = tf32(x),
# small = tf32(x - big)). Here that arithmetic, emulated by the tiled
# reference's ``split``, is held to the kernels' own fp32 bound: each 64-long
# tile within 1e-5 of its own max |plain| (a tensor that is zero up to fp32
# rounding, max |plain| <= 1e-5, must be so too); one TF32 product is shown
# to fail that bound at the same inputs.
FP32_TILE_RTOL = 1e-5
SPLIT_CASES = [  # (S, window, D, dropout): ragged S, windows off the tile, dropout
    (1, None, 128, 0.0), (63, None, 64, 0.0), (65, None, 128, 0.1), (129, None, 64, 0.0),
    (129, 1, 128, 0.0), (129, "wider", 64, 0.1), (200, 37, 64, 0.1), (200, None, 128, 0.0),
    (333, 100, 64, 0.1), (256, 64, 128, 0.0),
]


def _tile_bound_errors(got, want, rtol=FP32_TILE_RTOL):
    """{name: error} of the tensors that break the per-tile bound."""
    bad = {}
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        if w.abs().max().item() <= 1e-5:  # zero up to fp32 rounding
            if not t.abs().max().item() <= 1e-5:
                bad[name] = ("zero", t.abs().max().item())
            continue
        err = tiles.tile_rel_err(t, w)
        if not err <= rtol:
            bad[name] = err
    return bad


def _split_case(s, window, d, rate, split):
    window = _window(window, s)
    q, k, v, g = _inputs(s, d, seed=3 * s + d)
    out, lse = tattn.attention_reference(q, k, v, True, window, True, rate, SEED)
    want = tattn.attention_backward_reference(q, k, v, out, lse, g, window, rate, SEED)
    got = tiles.attention_backward_tiled_reference(q, k, v, out, lse, g, window, rate, SEED,
                                                   split=split)
    return got, want


def test_tf32_round_is_nearest_ties_away():
    """10 explicit mantissa bits, ties away from zero (cvt.rna), either sign;
    a TF32 value rounds to itself."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4, -(one + ulp / 2),
                      one + ulp, 0.0, 3.0e-39])
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), one + ulp, 0.0, 3.0e-39])
    got = tiles.tf32_round(x)
    assert torch.equal(got[:6], want[:6])
    assert torch.equal(tiles.tf32_round(got), got)
    big = tiles.tf32_round(torch.tensor([math.pi]))
    small = tiles.tf32_round(torch.tensor([math.pi]) - big)
    assert abs((big + small).item() - math.pi) <= 2.0 ** -21 * math.pi


def test_tf32_round_keeps_infinities_and_positive_nans():
    """Infinities round to themselves; a positive NaN stays a NaN, also the
    card's own, 0x7FFFFFFF, whose rounding add would carry into the sign."""
    bits = torch.tensor([0x7FFFFFFF, 0x7FFFF000, 0x7FC00000, 0x7F801234], dtype=torch.int32)
    assert tiles.tf32_round(bits.view(torch.float32)).isnan().all()
    inf = torch.tensor([math.inf, -math.inf])
    assert torch.equal(tiles.tf32_round(inf), inf)


@pytest.mark.parametrize("s,window,d,rate", SPLIT_CASES)
def test_tf32x3_split_holds_the_fp32_tile_bound(s, window, d, rate):
    got, want = _split_case(s, window, d, rate, "tf32x3")
    for t, w in zip(got, want):
        assert t.shape == w.shape and t.dtype == torch.float32
    assert not _tile_bound_errors(got, want)


@pytest.mark.parametrize("s,window,d,rate", SPLIT_CASES)
def test_one_tf32_product_fails_the_fp32_tile_bound(s, window, d, rate):
    """The bound tells the split from a single TF32 product (about 2^-11
    relative): at the same inputs one product breaks it."""
    got, want = _split_case(s, window, d, rate, "tf32")
    assert _tile_bound_errors(got, want)


@pytest.mark.parametrize("s,window,rate", [(256, None, 0.0), (200, None, 0.0), (320, 48, 0.0),
                                           (256, 64, 0.1)])
def test_tf32x3_split_holds_the_bound_against_jax_kernels(monkeypatch, s, window, rate):
    """The split's backward against the JAX package's fp32 backward kernels
    in interpret mode, each 64-long tile within 1e-5 of its own max |JAX|:
    without dropout the loop regime (``_bwd_dq_kernel`` + ``_bwd_dkv_kernel``,
    forced at this S by ``WHOLE_ROW_MAX_SEQ = 0``; a ragged S included), with
    hash dropout the wedge regime (the one JAX's in-kernel dropout runs in),
    one seed on both sides."""
    ran = []
    if rate == 0.0:
        monkeypatch.setattr(jattn, "WHOLE_ROW_MAX_SEQ", 0)
        orig = jattn._bwd_dq_kernel

        def spy(*a, **kw):
            ran.append("_bwd_dq_kernel")
            return orig(*a, **kw)

        monkeypatch.setattr(jattn, "_bwd_dq_kernel", spy)
    q, k, v, g = _inputs(s, 128, seed=s + (window or 0))
    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    key = jax.random.PRNGKey(9)
    seed = int(jax.random.randint(key, (1, 1), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)[0, 0])
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jattn.causal_attention(
            q_, k_, v_, window=window, use_pallas=True, interpret=True,
            dropout_rate=rate, dropout_rng=key if rate else None),
        jq, jk, jv)
    want = [torch.from_numpy(np.array(t)) for t in vjp(jg)]
    assert bool(ran) == (rate == 0.0)
    out, lse = tattn.attention_reference(q, k, v, True, window, True, rate, seed)
    got = tiles.attention_backward_tiled_reference(q, k, v, out, lse, g, window, rate, seed,
                                                   split="tf32x3")
    assert not _tile_bound_errors(got, want)


@pytest.mark.parametrize("k", [2176, 4352])
def test_long_sums_hold_the_bound_in_chunks(k):
    """The tensor cores round each mma's fp32 sum toward zero, so one
    accumulator over a long sum (p_v^T dO over every q row a key tile sees:
    4352 at dalle_4k's length) drifts by about half an ulp a step, past the
    fp32 bound; with each k step of 8 summed apart and added rounding to
    nearest, as the kernels sum, it holds with room."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.random((2, 16, k)).astype(np.float32))  # probabilities
    b = torch.from_numpy((rng.random((2, k, 64)) * 2 - 1).astype(np.float32))
    exact = torch.matmul(a.double(), b.double())

    def err(chunk):
        got = tiles.split_matmul(a, b, "tf32x3", chunk)
        return ((got.double() - exact).abs().max() / exact.abs().max()).item()

    assert err(1) <= FP32_TILE_RTOL / 4
    assert err(None) > FP32_TILE_RTOL


# ------------------------------------------- the fp32 forward's 3xTF32 split
# The fp32 forward kernels take both products (q k^T and p_v V) as three TF32
# products each and walk a q tile in two warp groups, each taking one 32-key
# half of every key tile with its own online softmax, merged once at the end
# (csrc/attention_tf32.cuh::merge_halves). The tiled forward's ``split``
# emulates both; held here to the kernels' bound: each 64-long tile of out
# within 1e-5 of its own max |plain|, lse within 1e-5.
FWD_SPLIT_CASES = [  # (S, window, D, dropout)
    (1, None, 128, 0.0), (63, None, 64, 0.1), (65, None, 128, 0.0), (129, 1, 128, 0.0),
    (129, "wider", 64, 0.1), (200, 37, 64, 0.0), (256, None, 128, 0.1), (333, 100, 64, 0.1),
    # rows whose live keys lie in one group's half of a tile: the other
    # group sees only masked keys there (m = NEG_INF, p = 1) and the merge's
    # factor 2^(NEG_INF - m) = 0 must wipe its sums
    (200, 20, 128, 0.0), (200, 20, 64, 0.1),
]


def _forward_split_case(s, window, d, rate, split):
    window = _window(window, s)
    q, k, v, _ = _inputs(s, d, seed=7 * s + d)
    want = tattn.attention_reference(q, k, v, True, window, True, rate, SEED)
    got = tiles.attention_tiled_reference(q, k, v, window, rate, SEED, split=split)
    return got, want


@pytest.mark.parametrize("s,window,d,rate", FWD_SPLIT_CASES)
def test_tf32x3_forward_holds_the_fp32_tile_bound(s, window, d, rate):
    (out, lse), (want, want_lse) = _forward_split_case(s, window, d, rate, "tf32x3")
    assert out.shape == want.shape and out.dtype == torch.float32
    assert tiles.tile_rel_err(out, want) <= FP32_TILE_RTOL
    assert (lse - want_lse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("s,window,d,rate", FWD_SPLIT_CASES)
def test_forward_one_tf32_product_fails_the_fp32_tile_bound(s, window, d, rate):
    """One TF32 product a product (about 2^-11 relative) breaks the bound at
    the same inputs: even where p = 1 (S = 1, a window of 1), v itself
    rounds."""
    (out, _), (want, _) = _forward_split_case(s, window, d, rate, "tf32")
    assert tiles.tile_rel_err(out, want) > FP32_TILE_RTOL


def test_fp32_forward_takes_64_row_tiles_only():
    q = torch.zeros((1, 1, 128, 128))
    with pytest.raises(ValueError, match="64-row"):
        tiles.attention_tiled_reference(q, q, q, rows=128, split="tf32x3")


@pytest.mark.parametrize("s,window,rate", [(256, None, 0.0), (200, None, 0.0), (320, 48, 0.0),
                                           (256, 64, 0.1)])
def test_tf32x3_forward_holds_the_bound_against_jax_kernels(monkeypatch, s, window, rate):
    """The split's forward against the JAX package's fp32 forward in
    interpret mode, each 64-long tile within 1e-5 of its own max |JAX|:
    without dropout the loop regime (``_flash_kernel``, forced at this S by
    ``WHOLE_ROW_MAX_SEQ = 0``; a ragged S included), with hash dropout the
    wedge regime (the one JAX's in-kernel dropout runs in), one seed on
    both sides."""
    ran = []
    if rate == 0.0:
        monkeypatch.setattr(jattn, "WHOLE_ROW_MAX_SEQ", 0)
        orig = jattn._flash_kernel

        def spy(*a, **kw):
            ran.append("_flash_kernel")
            return orig(*a, **kw)

        monkeypatch.setattr(jattn, "_flash_kernel", spy)
    q, k, v, _ = _inputs(s, 128, seed=11 * s + (window or 0))
    key = jax.random.PRNGKey(13)
    seed = int(jax.random.randint(key, (1, 1), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)[0, 0])
    want = torch.from_numpy(np.array(jattn.causal_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), window=window, use_pallas=True,
        interpret=True, dropout_rate=rate, dropout_rng=key if rate else None)))
    assert bool(ran) == (rate == 0.0)
    got, _ = tiles.attention_tiled_reference(q, k, v, window, rate, seed, split="tf32x3")
    assert tiles.tile_rel_err(got, want) <= FP32_TILE_RTOL


def test_forward_pv_sums_hold_the_bound_summed_by_step(monkeypatch):
    """The P·V sum of a row runs over every key it sees, up to S: here
    3136, the first whole number of 64-row tiles past 3072, where the JAX
    package's fp32 attention takes its loop kernel (4352, the card's
    ``loop_fp32`` shape, costs twice the CPU time; the ring's test below
    sums 4352 keys). Each k step of 8 summed apart, as the kernels sum,
    holds the bound with room; one accumulator down the sum (the tensor
    cores truncating its running total at every mma) drifts past it."""
    s = 3136
    q, k, v, _ = (t[:, :1] for t in _inputs(s, 64, seed=s))
    want = tattn.attention_reference(q, k, v)
    got, _ = tiles.attention_tiled_reference(q, k, v, split="tf32x3")
    assert tiles.tile_rel_err(got, want) <= FP32_TILE_RTOL / 4
    by_step = tiles.split_matmul
    monkeypatch.setattr(  # one accumulator where a product adds into a running sum: P V
        tiles, "split_matmul", lambda a, b, split=None, chunk=1, into=None: by_step(
            a, b, split, None if into is not None else chunk, into))
    got, _ = tiles.attention_tiled_reference(q, k, v, split="tf32x3")
    assert tiles.tile_rel_err(got, want) > FP32_TILE_RTOL
