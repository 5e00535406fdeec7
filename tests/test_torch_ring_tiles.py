"""The tile walk of ring attention's tensor-core per-hop kernels, on the CPU.

``dalle_mtf_tpu_torch/ops/attention_tiles.py`` writes the walk of
``csrc/ring_attention.cu``'s tensor-core kernels once in Python
(``ring_key_tile_range``, ``ring_query_tile_range``, ``ring_tile_needs_mask``)
and walks it in plain torch (``ring_partial_tiled_reference``,
``ring_block_grads_tiled_reference``: an online softmax in the log2 domain
from the finite NEG_INF, the mask only on flagged tiles, p_v and ds rounded
where the kernels round). The CUDA source points at those functions as the
definition of its walk, so here they are held

(a) against the dense mask of ``ops/ring_attention.py::_masks``, exhaustively:
    every live (row, key) pair lies in a tile the walk visits, and no tile the
    walk leaves unmasked holds a masked pair (or, where q rows are streamed, a
    row beyond the shard);
(b) against the one-shot plain versions ``ring_partial_reference`` and
    ``ring_block_grads_reference`` in fp32, and against the JAX package's
    ``_ring_partial`` and ``_ring_block_grads`` (the Pallas TPU kernels in
    interpret mode), with and without hash dropout;
(c) on the rows that see no key in the hop: m = NEG_INF exactly, l = the
    count of the keys the walk visited below Sk, num their sum of v;
(d) in bf16, where they round p_v and ds as the one-shot versions do;
(e) the fp32 kernels' three-product TF32 split, ring_block_grads and
    ring_partial (the forward also in the fp32 kernel's two warp groups a q
    tile, merged at the end), against the one-shot fp32 plain versions and
    JAX's ``_ring_block_grads`` / ``_ring_partial``: each 64-long tile within
    1e-5 of its own max |plain|, m and l within 1e-5; one TF32 product shown
    to fail that bound, and one accumulator down a long P·V sum too; the
    dead-row convention through the merge.

The kernel carries its own C++ copy of this arithmetic, which no CPU test can
see: tests/test_torch_cuda.py holds the built kernels to the one-shot plain
versions at the same edge cases, and the built forward's q tile to
``RING_FORWARD_TILES``.

Tolerance: fp32, max |tiled - one-shot| <= 1e-5 * max(1, max |one-shot|) per
tensor (the same math summed tile by tile, exp2 in place of exp); the triple
on rows with a live key (the others are the fold's to discard, and the two
versions visit different keys there).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu_torch.ops import attention as tattn
from dalle_mtf_tpu_torch.ops import attention_tiles as tiles
from dalle_mtf_tpu_torch.ops import ring_attention as tring

# the module (the package's ``ring_attention`` name is the function)
jring = importlib.import_module("dalle_mtf_tpu.ops.ring_attention")

SHARDS = [1, 63, 65, 200]
HOPS = [0, 1, 3]  # diff in shard lengths: the diagonal hop, a past hop, a far one
WINDOWS = [None, 1, 37, 256, "edge"]
SEED = 2**31 - 7  # near the top of the range: the uint32 add wraps
TILE = tiles.STREAM_TILE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The walk is many small tile products: a thread pool only adds its
    hand-offs, and beside other test workers it multiplies the run time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _window(window, s, diff):
    """"edge": a band that crosses the shard edge, so that about the first
    half of the rows see keys of the visiting shard and the rest none (on the
    diagonal hop, a window of half the shard)."""
    if window != "edge":
        return window
    return diff - s + s // 2 + 2 if diff else s // 2 + 1


def _padded_masked(s, diff, window, padded):
    """[padded, padded] bool: the hop's dense mask, and True for every row or
    key at or beyond the shard's end."""
    masked = np.ones((padded, padded), dtype=bool)
    masked[:s, :s] = tring._masks(s, s, diff, window, "cpu")[2].numpy()
    return masked


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("hops", HOPS)
@pytest.mark.parametrize("s", SHARDS)
def test_ring_walk_covers_live_pairs_and_masks_every_edge_tile(s, hops, window):
    diff = hops * s
    window = _window(window, s, diff)
    padded = -(-s // TILE) * TILE
    masked = _padded_masked(s, diff, window, padded)

    # the forward and the dQ pass: 64-row q tiles over 64-key tiles
    (rows,) = tattn.RING_FORWARD_TILES
    assert rows == tiles.BACKWARD_TILE_ROWS
    covered = np.zeros_like(masked)
    for q0 in range(0, s, rows):
        first, last = tiles.ring_key_tile_range(q0, rows, s, s, diff, window)
        assert last == first - 1 or 0 <= first <= last < -(-s // TILE)  # or none
        valid_rows = slice(q0, min(q0 + rows, s))  # rows beyond Sq are never written
        for t in range(first, last + 1):
            c0 = t * TILE
            covered[q0:q0 + rows, c0:c0 + TILE] = True
            if not tiles.ring_tile_needs_mask(q0, rows, c0, TILE, s, s, diff, window):
                assert not masked[valid_rows, c0:c0 + TILE].any(), (q0, c0)
    assert not (~masked & ~covered).any()

    # the dK/dV pass: 64-key tiles over 64-row q tiles; a streamed row beyond
    # Sq must be masked, it would add into a live key's sums
    covered = np.zeros_like(masked)
    for c0 in range(0, s, TILE):
        first, last = tiles.ring_query_tile_range(c0, TILE, s, s, diff, window)
        assert last == first - 1 or 0 <= first <= last < -(-s // TILE)
        valid_keys = slice(c0, min(c0 + TILE, s))  # keys beyond Sk are never written
        for t in range(first, last + 1):
            q0 = t * TILE
            covered[q0:q0 + TILE, c0:c0 + TILE] = True
            if not tiles.ring_tile_needs_mask(q0, TILE, c0, TILE, s, s, diff, window,
                                              ragged_rows=True):
                assert not masked[q0:q0 + TILE, valid_keys].any(), (q0, c0)
    assert not (~masked & ~covered).any()


def test_past_hop_of_the_ring_slice_masks_no_tile():
    """At the ring slice's past hop (S_local = 1088 = 17 x 64, diff = S, no
    window) the kernels skip the mask on every tile, and visit every key."""
    s, rows = 1088, tiles.STREAM_TILE
    for q0 in range(0, s, rows):
        assert tiles.ring_key_tile_range(q0, rows, s, s, s, None) == (0, s // TILE - 1)
        for t in range(s // TILE):
            assert not tiles.ring_tile_needs_mask(q0, rows, t * TILE, TILE, s, s, s, None)
    for c0 in range(0, s, TILE):
        assert tiles.ring_query_tile_range(c0, TILE, s, s, s, None) == (0, s // TILE - 1)
        for t in range(s // TILE):
            assert not tiles.ring_tile_needs_mask(t * TILE, TILE, c0, TILE, s, s, s, None,
                                                  ragged_rows=True)


def _inputs(s, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.random((1, 2, s, d)) * 2 - 1).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _close(got, want, atol=1e-5):
    if want.numel() == 0:  # a far hop under a window: no row sees a key
        return got.numel() == 0, 0.0
    err = (got.float() - want.float()).abs().max().item()
    return err <= atol * max(1.0, want.float().abs().max().item()), err


def _live(s, diff, window):
    return ~tring._masks(s, s, diff, window, "cpu")[2].all(-1)


def _hop_grad_inputs(m, l, s, seed):
    """A backward input of the hop: lse from its (m, l), and an arbitrary
    dsum."""
    lse = m + torch.log(l.clamp_min(1e-30))
    dsum = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, s))
                            .astype(np.float32))
    return lse, dsum


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("window", [None, 37, "edge"])
@pytest.mark.parametrize("hops", HOPS)
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("d", tattn.KERNEL_HEAD_DIMS)
def test_ring_tiled_versions_equal_the_one_shot_versions(d, s, hops, window, rate):
    diff = hops * s
    window = _window(window, s, diff)
    row0 = 3 * s
    args = (diff, row0, row0 - diff, window, rate, SEED)
    q, k, v, g = _inputs(s, d, seed=s + d + hops)
    want = tring.ring_partial_reference(q, k, v, *args)
    got = tiles.ring_partial_tiled_reference(q, k, v, *args)
    live = _live(s, diff, window)
    for name, t, w in zip(("num", "m", "l"), got, want):
        assert t.shape == w.shape and t.dtype == torch.float32
        ok, err = _close(t[..., live, :] if name == "num" else t[:, live],
                         w[..., live, :] if name == "num" else w[:, live])
        assert ok, (name, err)
    # both backwards from the one-shot forward's lse: only the walk differs
    lse, dsum = _hop_grad_inputs(want[1], want[2], s, seed=s)
    want_grads = tring.ring_block_grads_reference(q, g, lse, dsum, k, v, *args)
    got_grads = tiles.ring_block_grads_tiled_reference(q, g, lse, dsum, k, v, *args)
    for name, t, w in zip(("dq", "dk", "dv"), got_grads, want_grads):
        assert t.shape == w.shape and t.dtype == w.dtype
        ok, err = _close(t, w)
        assert ok, (name, err)


# (name, diff, window, rate) at S = 32, as tests/test_torch_ring_attention.py:
# the diagonal hop, a past hop, the window band across the shard edge, a far
# hop whose rows see no key, and hash dropout on the diagonal and in a band
JAX_HOPS = [
    ("diagonal", 0, None, 0.0),
    ("past", 32, None, 0.0),
    ("window_band", 64, 40, 0.0),
    ("window_far", 96, 40, 0.0),
    ("dropout_diagonal", 0, None, 0.25),
    ("dropout_past_window", 64, 56, 0.25),
]


@pytest.mark.parametrize("name,diff,window,rate", JAX_HOPS, ids=[h[0] for h in JAX_HOPS])
def test_ring_tiled_versions_match_jax_kernels(name, diff, window, rate):
    """The tiled forward and backward against the JAX package's
    ``_ring_partial`` and ``_ring_block_grads`` (``_ring_fwd_kernel`` and
    ``_ring_bwd_kernel`` in interpret mode), fp32, one seed on both sides.
    Tolerance: 1e-5 of each tensor's max; the triple on live rows."""
    b, h, s, d = 1, 2, 32, 128
    rng = np.random.default_rng(diff + int(rate * 100))
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    row0 = 96
    col0, seed = row0 - diff, 1234567
    info = jnp.asarray([[diff, row0, col0, seed]], jnp.int32)
    jnum, jm, jl = jring._ring_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), info,
                                       True, window, rate, h)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    args = (diff, row0, col0, window, rate, seed)
    num, m, l = tiles.ring_partial_tiled_reference(tq, tk, tv, *args)
    live = _live(s, diff, window).numpy()
    assert live.any() == (name != "window_far")
    jm, jl = np.asarray(jm).reshape(b * h, s), np.asarray(jl).reshape(b * h, s)
    for what, got, want in (("m", m.numpy()[:, live], jm[:, live]),
                            ("l", l.numpy()[:, live], jl[:, live]),
                            ("num", num.numpy()[:, :, live], np.asarray(jnum)[:, :, live])):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(initial=0), 1e-30),
                                   err_msg=what)

    lse, dsum = _hop_grad_inputs(m, l, s, seed=diff)
    jgrads = jring._ring_block_grads(
        jnp.asarray(q), jnp.asarray(g), jnp.asarray(lse.numpy().reshape(b, h, s, 1)),
        jnp.asarray(dsum.numpy().reshape(b, h, s, 1)), jnp.asarray(k), jnp.asarray(v),
        info, True, window, rate, h)
    grads = tiles.ring_block_grads_tiled_reference(tq, tg, lse, dsum, tk, tv, *args)
    for what, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=what)


def test_rows_without_a_live_key_keep_the_dead_row_convention():
    """A past hop under a window that crosses the shard edge: rows 0-98 see
    keys, the rest none. A dead row is written m = NEG_INF itself (not
    NEG_INF ln 2), l = the count of the keys the walk visited below Sk, and
    num = their sum of v; a q tile that visits no key tile writes l = 0 and
    num = 0."""
    s, window, rows = 200, 100, tiles.STREAM_TILE
    diff = s
    q, k, v, _ = _inputs(s, 128, seed=17)
    num, m, l = tiles.ring_partial_tiled_reference(q, k, v, diff, 2 * s, s, window)
    live = _live(s, diff, window)
    assert live[:99].all() and not live[99:].any()
    dead = (~live).nonzero()[:, 0].tolist()
    assert (m[:, ~live] == tattn.NEG_INF).all() and (m[:, live] > tattn.NEG_INF / 2).all()
    empty_tiles = 0
    for r in dead:
        q0 = r // rows * rows
        first, last = tiles.ring_key_tile_range(q0, rows, s, s, diff, window)
        keys = [c for c in range(first * TILE, (last + 1) * TILE) if c < s]
        empty_tiles += not keys
        assert (l[:, r] == len(keys)).all(), (r, l[:, r], len(keys))
        want = v[0, :, keys].sum(1) if keys else torch.zeros_like(num[0, :, r])
        assert _close(num[0, :, r], want)[0], r
    assert empty_tiles > 0  # the walk's last q tiles visit no key tile at all


def test_ring_tiled_versions_round_where_the_kernels_round():
    """In bf16 the tiled versions round p_v and ds to bf16 before their
    products, as the one-shot versions do: the two agree to a bf16 rounding
    of the result (atol 1e-2 on unit-scale inputs), not to fp32's 1e-5, and
    dq comes back in bf16, dk and dv in fp32."""
    s, diff, window, rate = 200, 200, 120, 0.1
    args = (diff, 2 * s, s, window, rate, SEED)
    q, k, v, g = _inputs(s, 64, seed=3, dtype=torch.bfloat16)
    want = tring.ring_partial_reference(q, k, v, *args)
    got = tiles.ring_partial_tiled_reference(q, k, v, *args)
    live = _live(s, diff, window)
    assert _close(got[0][..., live, :], want[0][..., live, :], 1e-2)[0]
    for t, w in zip(got[1:], want[1:]):
        assert _close(t[:, live], w[:, live])[0]  # m and l: fp32 on both sides
    # rounding p_v matters: without it the tiled num moves away from the one-shot one
    unrounded = tiles.ring_partial_tiled_reference(q.float(), k.float(), v.float(), *args)
    assert not torch.equal(unrounded[0][..., live, :], got[0][..., live, :])
    lse, dsum = _hop_grad_inputs(want[1], want[2], s, seed=5)
    want_grads = tring.ring_block_grads_reference(q, g, lse, dsum, k, v, *args)
    got_grads = tiles.ring_block_grads_tiled_reference(q, g, lse, dsum, k, v, *args)
    for t, w, dtype in zip(got_grads, want_grads, (torch.bfloat16, torch.float32, torch.float32)):
        assert t.dtype == w.dtype == dtype and _close(t, w, 1e-2)[0]


# ------------------------------------------------ the fp32 kernels' 3xTF32 split
# The fp32 ring_block_grads kernels run the five products on the tensor cores
# as three TF32 products each (``attention_tiles.split_matmul``). The tiled
# reference's ``split`` emulates them; held here to the kernels' fp32 bound,
# each 64-long tile within 1e-5 of its own max |plain| (a tensor zero up to
# fp32 rounding, max |plain| <= 1e-5, must be so too), and one TF32 product
# is shown to fail it at the same inputs.
FP32_TILE_RTOL = 1e-5
RING_SPLIT_CASES = [  # (S_local, hops back, window, dropout, D): ragged shards, bands, dropout
    (1, 1, None, 0.0, 128), (63, 0, None, 0.0, 64), (65, 1, None, 0.1, 128),
    (65, 0, "edge", 0.0, 64), (200, 1, 120, 0.0, 128), (200, 3, "edge", 0.1, 128),
    (200, 0, 37, 0.1, 64), (129, 1, None, 0.0, 128),
]


def _ring_bound_errors(got, want, keep, rtol=FP32_TILE_RTOL):
    """{name: error} of dq (on live rows), dk, dv breaking the tile bound."""
    bad = {}
    for name, t, w in zip(("dq", "dk", "dv"), (got[0] * keep, *got[1:]),
                          (want[0] * keep, *want[1:])):
        if w.abs().max().item() <= 1e-5:  # zero up to fp32 rounding (or no live pair)
            if not t.abs().max().item() <= 1e-5:
                bad[name] = ("zero", t.abs().max().item())
            continue
        err = tiles.tile_rel_err(t, w)
        if not err <= rtol:
            bad[name] = err
    return bad


def _ring_split_case(s, hops, window, rate, d, split):
    diff = hops * s
    window = _window(window, s, diff)
    args = (diff, 3 * s, 3 * s - diff, window, rate, SEED)
    q, k, v, g = _inputs(s, d, seed=5 * s + hops + d)
    _, m, l = tring.ring_partial_reference(q, k, v, *args)
    lse, dsum = _hop_grad_inputs(m, l, s, seed=s + hops)
    want = tring.ring_block_grads_reference(q, g, lse, dsum, k, v, *args)
    got = tiles.ring_block_grads_tiled_reference(q, g, lse, dsum, k, v, *args, split=split)
    return got, want, _live(s, diff, window).reshape(1, 1, s, 1)


@pytest.mark.parametrize("s,hops,window,rate,d", RING_SPLIT_CASES)
def test_ring_tf32x3_split_holds_the_fp32_tile_bound(s, hops, window, rate, d):
    got, want, keep = _ring_split_case(s, hops, window, rate, d, "tf32x3")
    for t, w in zip(got, want):
        assert t.shape == w.shape and t.dtype == w.dtype == torch.float32
    assert not _ring_bound_errors(got, want, keep)


@pytest.mark.parametrize("s,hops,window,rate,d", RING_SPLIT_CASES)
def test_ring_one_tf32_product_fails_the_fp32_tile_bound(s, hops, window, rate, d):
    got, want, keep = _ring_split_case(s, hops, window, rate, d, "tf32")
    assert _ring_bound_errors(got, want, keep)


@pytest.mark.parametrize("name,diff,window,rate", JAX_HOPS, ids=[h[0] for h in JAX_HOPS])
def test_ring_tf32x3_split_holds_the_bound_against_jax_kernels(name, diff, window, rate):
    """The split's hop gradient against the JAX package's
    ``_ring_block_grads`` (``_ring_bwd_kernel`` in interpret mode), fp32, one
    seed on both sides: each 64-long tile within 1e-5 of its own max |JAX|
    (dq on rows with a live key)."""
    b, h, s, d = 1, 2, 32, 128
    rng = np.random.default_rng(7 * diff + int(rate * 100))
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    row0 = 96
    col0, seed = row0 - diff, 7654321
    args = (diff, row0, col0, window, rate, seed)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    _, m, l = tring.ring_partial_reference(tq, tk, tv, *args)
    lse, dsum = _hop_grad_inputs(m, l, s, seed=diff + 1)
    info = jnp.asarray([[diff, row0, col0, seed]], jnp.int32)
    jgrads = jring._ring_block_grads(
        jnp.asarray(q), jnp.asarray(g), jnp.asarray(lse.numpy().reshape(b, h, s, 1)),
        jnp.asarray(dsum.numpy().reshape(b, h, s, 1)), jnp.asarray(k), jnp.asarray(v),
        info, True, window, rate, h)
    want = [torch.from_numpy(np.array(t)) for t in jgrads]
    got = tiles.ring_block_grads_tiled_reference(tq, tg, lse, dsum, tk, tv, *args,
                                                 split="tf32x3")
    keep = _live(s, diff, window).reshape(1, 1, s, 1)
    assert not _ring_bound_errors(got, want, keep)


def test_score_products_hold_the_bound_summed_by_step(monkeypatch):
    """A hop whose last key is seen by one row only (S_local = 65, the
    diagonal; the inputs of the card test's fp32 case): that key's dk is one
    ds = p (dp - dsum), which nearly cancels in one head, so the tile holds
    the score products' error at its own small scale. One accumulator over
    D = 128 (the tensor cores truncating at every step) puts that tile past
    1e-5; every k step summed apart, as the kernels sum, holds it."""
    b, h, s, d = 2, 3, 65, 128
    gen = torch.Generator().manual_seed(s + h)
    q, k, v, g = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1) for _ in range(4))
    args = (0, 3 * s, 3 * s, None, 0.0, SEED)
    _, m, l = tring.ring_partial_reference(q, k, v, *args)
    lse = m + torch.log(l.clamp_min(1e-30))
    dsum = (g * torch.rand((b, h, s, d), generator=gen)).sum(-1).reshape(b * h, s)
    want = tring.ring_block_grads_reference(q, g, lse, dsum, k, v, *args)
    keep = torch.ones((1, 1, s, 1))

    def split_errors():
        got = tiles.ring_block_grads_tiled_reference(q, g, lse, dsum, k, v, *args,
                                                     split="tf32x3")
        return _ring_bound_errors(got, want, keep)

    assert not split_errors()
    by_step = tiles.split_matmul
    monkeypatch.setattr(tiles, "split_matmul",
                        lambda a, b_, split=None, chunk=1: by_step(a, b_, split, None))
    assert "dk" in split_errors()


# ------------------------------------------- the fp32 forward's 3xTF32 split
# The fp32 ring_partial takes both products as three TF32 products and walks
# a q tile in two warp groups, one 32-key half of every key tile each, with
# their own online softmax, merged once at the end. ``split`` emulates both;
# held to the kernel's bound: num per 64-long tile within 1e-5 of its own
# max |plain| and m, l within 1e-5 relative, on rows with a live key.


def _ring_forward_split_case(s, hops, window, rate, d, split):
    diff = hops * s
    window = _window(window, s, diff)
    args = (diff, 3 * s, 3 * s - diff, window, rate, SEED)
    q, k, v, _ = _inputs(s, d, seed=7 * s + hops + d)
    want = tring.ring_partial_reference(q, k, v, *args)
    got = tiles.ring_partial_tiled_reference(q, k, v, *args, split=split)
    return got, want, _live(s, diff, window)


def _ring_forward_errors(got, want, live):
    """(num's tile error on live rows, m's and l's relative errors there)."""
    keep = live.reshape(1, 1, -1, 1)
    errs = [tiles.tile_rel_err(got[0] * keep, want[0] * keep)]
    for t, w in zip(got[1:], want[1:]):
        errs.append(((t - w)[:, live].abs() / w[:, live].abs().clamp_min(1.0)).max().item()
                    if live.any() else 0.0)
    return errs


@pytest.mark.parametrize("s,hops,window,rate,d", RING_SPLIT_CASES)
def test_ring_partial_tf32x3_split_holds_the_fp32_tile_bound(s, hops, window, rate, d):
    got, want, live = _ring_forward_split_case(s, hops, window, rate, d, "tf32x3")
    for t, w in zip(got, want):
        assert t.shape == w.shape and t.dtype == w.dtype == torch.float32
    assert max(_ring_forward_errors(got, want, live)) <= FP32_TILE_RTOL
    assert (got[1][:, ~live] == tattn.NEG_INF).all()


@pytest.mark.parametrize("s,hops,window,rate,d", RING_SPLIT_CASES)
def test_ring_partial_one_tf32_product_fails_the_fp32_tile_bound(s, hops, window, rate, d):
    got, want, live = _ring_forward_split_case(s, hops, window, rate, d, "tf32")
    assert _ring_forward_errors(got, want, live)[0] > FP32_TILE_RTOL


@pytest.mark.parametrize("name,diff,window,rate", JAX_HOPS, ids=[h[0] for h in JAX_HOPS])
def test_ring_partial_tf32x3_split_holds_the_bound_against_jax_kernels(name, diff, window, rate):
    """The split's forward against the JAX package's ``_ring_partial``
    (``_ring_fwd_kernel`` in interpret mode), fp32, one seed on both sides:
    num per 64-long tile within 1e-5 of its own max |JAX| and m, l within
    1e-5 relative, on rows with a live key."""
    b, h, s, d = 1, 2, 32, 128
    rng = np.random.default_rng(5 * diff + int(rate * 100))
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    row0 = 96
    col0, seed = row0 - diff, 2345671
    info = jnp.asarray([[diff, row0, col0, seed]], jnp.int32)
    jnum, jm, jl = jring._ring_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), info,
                                       True, window, rate, h)
    want = (torch.from_numpy(np.array(jnum)), torch.from_numpy(np.array(jm).reshape(b * h, s)),
            torch.from_numpy(np.array(jl).reshape(b * h, s)))
    got = tiles.ring_partial_tiled_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), diff, row0, col0, window, rate, seed,
        split="tf32x3")
    live = _live(s, diff, window)
    assert live.any() == (name != "window_far")
    assert max(_ring_forward_errors(got, want, live)) <= FP32_TILE_RTOL


@pytest.mark.parametrize("s,window", [(200, 100), (65, 40)])
def test_dead_rows_keep_their_convention_through_the_merge(s, window):
    """A past hop under a window that crosses the shard edge, in the fp32
    kernel's two warp groups: a dead row's groups both end at m = NEG_INF,
    so the merge's factors are 1 and it is written m = NEG_INF itself, l =
    the count of the keys the walk visited below Sk (summed over both
    halves) and num = their sum of v. At S_local = 65 the last key tile
    holds one key below Sk: the rest, in both halves, score -inf and count
    nothing, and one group sees no key below Sk at all there."""
    rows, diff = tiles.STREAM_TILE, s
    q, k, v, _ = _inputs(s, 128, seed=19 + s)
    num, m, l = tiles.ring_partial_tiled_reference(q, k, v, diff, 2 * s, s, window,
                                                   split="tf32x3")
    live = _live(s, diff, window)
    assert live.any() and not live.all()
    assert (m[:, ~live] == tattn.NEG_INF).all() and (m[:, live] > tattn.NEG_INF / 2).all()
    for r in (~live).nonzero()[:, 0].tolist():
        q0 = r // rows * rows
        first, last = tiles.ring_key_tile_range(q0, rows, s, s, diff, window)
        keys = [c for c in range(first * TILE, (last + 1) * TILE) if c < s]
        assert (l[:, r] == len(keys)).all(), (r, l[:, r], len(keys))
        want = v[0, :, keys].sum(1) if keys else torch.zeros_like(num[0, :, r])
        assert _close(num[0, :, r], want)[0], r


def test_ring_partial_pv_sums_hold_the_bound_summed_by_step(monkeypatch):
    """One q tile against a long visiting shard (Sk = 4352, a past hop: every
    row sees every key), so each row's P·V sum runs over 4352 keys. Each k
    step of 8 summed apart, as the kernel sums, holds the bound with room;
    one accumulator down the sum (the tensor cores truncating its running
    total at every mma) drifts past it."""
    s_k = 4352
    rng = np.random.default_rng(s_k)
    q = torch.from_numpy((rng.random((1, 2, 64, 64)) * 2 - 1).astype(np.float32))
    k, v = (torch.from_numpy((rng.random((1, 2, s_k, 64)) * 2 - 1).astype(np.float32))
            for _ in range(2))
    args = (s_k, 2 * s_k, s_k, None, 0.0, SEED)
    want = tring.ring_partial_reference(q, k, v, *args)[0]
    got = tiles.ring_partial_tiled_reference(q, k, v, *args, split="tf32x3")[0]
    assert tiles.tile_rel_err(got, want) <= FP32_TILE_RTOL / 4
    by_step = tiles.split_matmul
    monkeypatch.setattr(  # one accumulator where a product adds into a running sum: P V
        tiles, "split_matmul", lambda a, b, split=None, chunk=1, into=None: by_step(
            a, b, split, None if into is not None else chunk, into))
    got = tiles.ring_partial_tiled_reference(q, k, v, *args, split="tf32x3")[0]
    assert tiles.tile_rel_err(got, want) > FP32_TILE_RTOL
