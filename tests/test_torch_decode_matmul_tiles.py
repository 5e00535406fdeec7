"""The walk of the decode matmul kernels, on the CPU.

``dalle_mtf_tpu_torch/ops/decode_matmul_tiles.py`` writes the order of the
kernels' arithmetic (``csrc/decode_matmul.cu``) once in numpy: the dequant
without the int-to-float unit (a biased byte in the mantissa of 2^23, a
biased nibble in the mantissa of 128 as bf16, the bias subtracted), each
16-row tile a tensor-core product from a zero accumulator (the exact sum
rounded toward zero), each warp's fp32 sum of its tiles in order, the warps
in order, the slices of a cluster in order, the scale last. Here it is held

(a) exhaustively for the dequant: every int8 byte, and both nibbles of every
    packed byte, equal to the exact values (int8 -> float, and the nibbles of
    both packages' ``quantize.nibble_views``);
(b) for ``ops/decode_matmul.py::plan`` at every decode shape of dalle_coco
    and every M from 1 to 32: each K row in exactly one slice, a cluster of
    at most 8 slices, whole passes, a warp's tiles within the plan's limit,
    the shared memory within a CTA's limit;
(c) against the plain versions and the JAX package's ``int8_matmul`` /
    ``int4_matmul`` in interpret mode, at small sizes with a ragged N, under
    one slice, two, and the most a cluster takes (and slices of several
    chunks); bit for bit where every partial sum is exact; with NaN and inf
    planted in x.

A card test (tests/test_torch_cuda.py) holds the built kernels to this walk
bit for bit.

Tolerance: the same exact products summed in fp32 in another order, so
max |walk - plain| <= 1e-5 * max |plain|; against JAX's ragged tail (columns
past its last 512-column block, which JAX multiplies by a bf16-rounded
dequantized weight) one bf16 rounding of the weight, 2^-8 of |x| @ |w|.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu import quantize as jq
from dalle_mtf_tpu.ops import decode_matmul as jdmm
from dalle_mtf_tpu_torch import quantize as tq
from dalle_mtf_tpu_torch.ops import decode_matmul as tdmm
from dalle_mtf_tpu_torch.ops import decode_matmul_tiles as tiles

# dalle_coco's decode products at batch 4, (name, K, N); int4 packs K / 2 rows
DECODE_SHAPES = [("qkv", 1024, 1024), ("wo", 1024, 1024), ("mlp1", 1024, 4096),
                 ("mlp2", 4096, 1024), ("head_band", 1024, 2048)]
SMEM_LIMIT = 232448  # shared memory a CTA can take on the H100


def test_int8_dequant_is_exact_for_every_byte():
    b = np.arange(-128, 128, dtype=np.int8)
    got = tiles.dequant_int8_words(b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, b.astype(np.float32))


def test_int4_dequant_is_exact_for_every_nibble():
    """Both nibbles of every byte through the bf16 bit arithmetic (the mantissa
    of 128 holds a nibble exactly: 7 bits)."""
    p = np.arange(-128, 128, dtype=np.int8)
    lo, hi = tiles.dequant_int4_words(p)
    want = [v.numpy().astype(np.float32) for v in tq.nibble_views(torch.from_numpy(p))]
    jwant = [np.asarray(v).astype(np.float32) for v in jq.nibble_views(jnp.asarray(p))]
    for got, w, jw in zip((lo, hi), want, jwant):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, jw)
    np.testing.assert_array_equal(lo, ((p.astype(np.int32) << 28) >> 28).astype(np.float32))
    np.testing.assert_array_equal(hi, (p.astype(np.int32) >> 4).astype(np.float32))


@pytest.mark.parametrize("shape", [(3, 5), (7, 16), (2, 1)])
def test_dequant_works_on_whole_words_of_any_row_width(shape):
    """The word view pads the bytes to a whole word; rows whose width is not a
    multiple of 4 straddle words and come out the same."""
    w = np.random.default_rng(sum(shape)).integers(-128, 128, shape).astype(np.int8)
    np.testing.assert_array_equal(tiles.dequant_int8_words(w), w.astype(np.float32))
    lo, hi = tiles.dequant_int4_words(w)
    tlo, thi = tq.nibble_views(torch.from_numpy(w))
    np.testing.assert_array_equal(lo, tlo.numpy().astype(np.float32))
    np.testing.assert_array_equal(hi, thi.numpy().astype(np.float32))


def _check_plan(walk, m, k, n, int4):
    """The invariants every plan keeps."""
    assert walk.k_slice % tdmm.ROWS_PER_PASS == 0 and 1 <= walk.splits <= tdmm.MAX_CLUSTER
    assert (walk.splits - 1) * walk.k_slice < k <= walk.splits * walk.k_slice
    rows = np.concatenate([np.arange(s * walk.k_slice, min(k, (s + 1) * walk.k_slice))
                           for s in range(walk.splits)])
    np.testing.assert_array_equal(rows, np.arange(k))  # each row in exactly one slice
    assert tdmm.smem_bytes(walk, int4) <= SMEM_LIMIT
    static = (tdmm.WARPS + 1) * tdmm.M_TILE * tdmm.BLOCK_N * 4 + tdmm.MAX_CLUSTER * 4
    assert static <= 48 * 1024
    assert math.ceil(n / tdmm.BLOCK_N) <= 65535 and math.ceil(m / tdmm.M_TILE) <= 65535
    work = tdmm.passes(walk) * (2 if int4 else 1)
    # the fewest slices within MAX_WORK, else the most the cluster takes
    assert work <= tdmm.MAX_WORK or walk.splits == tdmm.MAX_CLUSTER
    fewer = [p for p in tdmm.candidates(k) if p.splits < walk.splits]
    assert all(tdmm.passes(p) * (2 if int4 else 1) > tdmm.MAX_WORK for p in fewer)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("name,k,n", DECODE_SHAPES)
def test_plan_at_the_decode_shapes(name, k, n, kind):
    """At M = 4 each decode product gets a plan that holds the invariants:
    one slice a column block (no cluster), except mlp2 (K = 4096 on
    N = 1024), whose warps would read 32 tiles (16 int4 tiles of two
    weights a byte) and which splits K three ways over a cluster."""
    int4 = kind == "int4"
    kp = k // 2 if int4 else k
    walk = tdmm.plan(kp, int4)
    _check_plan(walk, 4, kp, n, int4)
    assert walk.splits == (3 if name == "mlp2" else 1)
    assert tdmm.ctas(walk, 4, n) == walk.splits * n // tdmm.BLOCK_N


@pytest.mark.parametrize("m", range(1, tdmm.M_MAX + 1))
def test_plan_for_every_decode_row_count(m):
    """Every M the kernels take, at every decode shape, int8 and int4, and
    at the ragged full-vocabulary head: the plan depends on K alone, and the
    grid takes ceil(M / 8) row tiles."""
    for _, k, n in DECODE_SHAPES + [("head_full_vocab", 1024, 52307)]:
        for int4 in (False, True):
            kp = k // 2 if int4 else k
            walk = tdmm.plan(kp, int4)
            _check_plan(walk, m, kp, n, int4)
            assert tdmm.ctas(walk, m, n) == \
                walk.splits * math.ceil(n / tdmm.BLOCK_N) * math.ceil(m / tdmm.M_TILE)


def _inputs(m, k, n, seed, int4):
    """bf16 x (as float32 numpy), int8 or packed weights, the scale."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    qmax = 7 if int4 else 127
    q = rng.integers(-qmax, qmax + 1, (k, n)).astype(np.int8)
    scale = (rng.random((1, n)) * 0.01 + 1e-3).astype(np.float32)
    if int4:
        xs = (x[:, : k // 2].contiguous(), x[:, k // 2:].contiguous())
        return xs, tq.pack_int4(torch.from_numpy(q), 0).numpy(), scale
    return (x,), q, scale


def _plain(xs, w, scale):
    fn = tdmm.int4_matmul_reference if len(xs) == 2 else tdmm.int8_matmul_reference
    return fn(*xs, torch.from_numpy(w), torch.from_numpy(scale)).numpy()


def _walk(xs, w, scale, walk):
    return tiles.decode_matmul_emulated([x.float().numpy() for x in xs], w, scale, walk)


def _plans(k):
    """One slice, two, and the most the cluster takes."""
    cands = tdmm.candidates(k)
    return [p for p in cands if p.splits in (1, 2) or p is cands[-1]]


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 200), (1, 512, 96), (9, 4096, 40)])
def test_walk_matches_the_plain_version(m, k, n, kind):
    """Under one slice, two and the most the cluster takes (one slice of
    several chunks at K = 4096), the walk's order stays within 1e-5 of the
    one-shot product."""
    xs, w, scale = _inputs(m, k, n, m * k + n, kind == "int4")
    want = _plain(xs, w, scale)
    for walk in _plans(w.shape[0]):
        got = _walk(xs, w, scale, walk)
        assert got.shape == (m, n) and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), walk


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_walk_is_exact_where_every_sum_is(kind):
    """Small integers in x: every partial sum is an integer below 2^24, so
    each order and each rounding gives the same bits as the one-shot
    product."""
    m, k, n = 3, 1024, 48
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-8, 9, (m, k)).astype(np.float32)).to(torch.bfloat16)
    xs, w, scale = _inputs(m, k, n, 8, kind == "int4")
    xs = (x,) if kind == "int8" else (x[:, : k // 2].contiguous(), x[:, k // 2:].contiguous())
    want = _plain(xs, w, scale)
    for walk in _plans(w.shape[0]):
        np.testing.assert_array_equal(_walk(xs, w, scale, walk), want)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_walk_keeps_nan_and_inf(kind):
    """A NaN and infinities planted in x come out where the plain version
    puts them (a NaN row; inf, -inf or NaN by the weights' signs)."""
    m, k, n = 4, 512, 64
    xs, w, scale = _inputs(m, k, n, 9, kind == "int4")
    xs = tuple(x.clone() for x in xs)
    xs[0][0, 3] = float("nan")
    xs[-1][1, 10] = float("inf")
    xs[0][2, 4] = -float("inf")
    xs[-1][2, 6] = float("inf")
    want = _plain(xs, w, scale)
    for walk in _plans(w.shape[0]):
        got = _walk(xs, w, scale, walk)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        assert np.isnan(got[0]).all()


@pytest.mark.parametrize("m,n", [(4, 1024), (1, 1100)])
def test_walk_matches_the_jax_int8_kernel_in_interpret_mode(m, n):
    k = 512
    xs, w, scale = _inputs(m, k, n, m + n, False)
    x16 = jnp.asarray(xs[0].float().numpy(), jnp.bfloat16)
    want = np.asarray(jdmm.int8_matmul(x16, jnp.asarray(w), jnp.asarray(scale), interpret=True))
    got = _walk(xs, w, scale, tdmm.plan(k))
    body = (n // jdmm.BN) * jdmm.BN
    np.testing.assert_allclose(got[:, :body], want[:, :body], rtol=0,
                               atol=1e-5 * np.abs(want).max())
    mag = np.abs(xs[0].float().numpy()) @ (np.abs(w.astype(np.float32)) * scale)
    assert (np.abs(got[:, body:] - want[:, body:]) <= 2.0**-8 * mag[:, body:] + 1e-6).all()


@pytest.mark.parametrize("m,n", [(3, 1024), (2, 600)])
def test_walk_matches_the_jax_int4_kernel_in_interpret_mode(m, n):
    k = 1024
    xs, packed, scale = _inputs(m, k, n, m * n, True)
    xl, xh = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in xs)
    want = np.asarray(jdmm.int4_matmul(xl, xh, jnp.asarray(packed), jnp.asarray(scale),
                                       interpret=True))
    got = _walk(xs, packed, scale, tdmm.plan(k // 2, True))
    body = (n // jdmm.BN) * jdmm.BN
    np.testing.assert_allclose(got[:, :body], want[:, :body], rtol=0,
                               atol=1e-5 * np.abs(want).max())
    lo, hi = (v.numpy().astype(np.float32) for v in tq.nibble_views(torch.from_numpy(packed)))
    mag = (np.abs(xs[0].float().numpy()) @ (np.abs(lo) * scale)
           + np.abs(xs[1].float().numpy()) @ (np.abs(hi) * scale))
    assert (np.abs(got[:, body:] - want[:, body:]) <= 2.0**-8 * mag[:, body:] + 1e-6).all()
