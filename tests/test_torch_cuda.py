"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
with only PyTorch and CUDA (skip the JAX conftest there):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips. Tolerance: max |kernel - plain| <=
atol * max(1, max |plain|), atol 1e-5 in fp32 and 1e-2 in bf16, on
unit-scale inputs (uniform in [-1, 1); one bf16 rounding is 2^-8
relative); lse atol 1e-4. The [B, H, S, D] pair is also held per 64-long
tile of S (query rows for out and dq, keys for dk and dv): max |kernel -
plain| within 2^-6 (bf16) or 1e-5 (fp32) of the tile's own max |plain|, so
the small values far down a long sequence are checked too. The decode
matmuls: the same exact products summed in fp32 in another order, so 1e-5
of max |plain|. LayerNorm: y and
dx atol 1e-5 (fp32) or 1e-2 (bf16) times max(1, max |plain|), dg and db
1e-4 of max |plain| (fp32 sums over the rows in another order); against
the numpy walk of the kernel's own order of sums
(``ops/layer_norm_tiles.py``), 1e-6 of max |walk| (the same additions in the
same order; the row statistics under them are summed in another order).
"""

import importlib.util
import math
import os

import pytest
import torch

from dalle_mtf_tpu_torch.ops import attention as tattn
from dalle_mtf_tpu_torch.ops import attention_packed as tpacked
from dalle_mtf_tpu_torch.ops import attention_tiles as ttiles
from dalle_mtf_tpu_torch.ops import decode_matmul as tdmm
from dalle_mtf_tpu_torch.ops import decode_matmul_tiles as ttiles_dmm
from dalle_mtf_tpu_torch.ops import layer_norm as tln
from dalle_mtf_tpu_torch.ops import layer_norm_tiles as tln_tiles
from dalle_mtf_tpu_torch.quantize import pack_int4

pytestmark = pytest.mark.cuda


def _chip_smoke():
    """chip_smoke.py as a module (its timing helpers)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, atol):
    err = (got.float() - want.float()).abs().max().item()
    return err <= atol * max(1.0, want.float().abs().max().item()), err


def _tile_close(got, want, rtol, tile=64):
    """Each ``tile``-long tile of S of each head of [B, H, S, D] tensors
    (the last one ragged) within ``rtol`` of the tile's own max |want|."""
    b, h, s, d = want.shape
    n = -(-s // tile)

    def tiles(t):
        t = torch.nn.functional.pad(t.float().reshape(b * h, s, d), (0, 0, 0, n * tile - s))
        return t.reshape(b * h, n, tile * d)

    w = tiles(want)
    err = ((tiles(got) - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max().item()
    return err <= rtol, err


def _uniform(shape, dtype, gen, n):
    return [(torch.rand(shape, generator=gen) * 2 - 1).to("cuda", dtype) for _ in range(n)]


@pytest.mark.parametrize("dtype,b,h,s,d,window,rate", [
    (torch.bfloat16, 2, 2, 256, 128, None, 0.0),
    (torch.bfloat16, 2, 2, 320, 128, None, 0.1),
    (torch.float32, 2, 4, 200, 64, 64, 0.1),
    (torch.float32, 1, 2, 130, 128, 5, 0.0),
    (torch.bfloat16, 16, 8, 1280, 128, None, 0.0),  # the training shape
    # the edges of the bf16 tile walk: D = 64 with a window that is not a
    # multiple of the tile, ragged lengths, one head, a window of 1 and one
    # wider than S
    (torch.bfloat16, 2, 4, 333, 64, 100, 0.1),
    (torch.bfloat16, 2, 3, 65, 64, None, 0.0),
    (torch.bfloat16, 2, 1, 200, 128, None, 0.0),
    (torch.bfloat16, 3, 1, 129, 64, 37, 0.1),
    (torch.bfloat16, 2, 2, 63, 128, 1, 0.0),
    (torch.bfloat16, 1, 2, 1, 64, None, 0.0),
    (torch.bfloat16, 2, 2, 129, 128, 1000, 0.1),
    # the fp32 kernels (3xTF32) in the packed layout: one head, S = 1, a
    # window of 1, D = 64 with a window off the tile
    (torch.float32, 2, 1, 200, 128, None, 0.0),
    (torch.float32, 3, 1, 129, 64, 37, 0.1),
    (torch.float32, 1, 2, 1, 64, None, 0.0),
    (torch.float32, 2, 2, 63, 128, 1, 0.0),
    # the fp32 forward (3xTF32): a ragged S under dropout, a window that
    # ends mid-tile, and one wider than S
    (torch.float32, 2, 3, 65, 128, None, 0.1),
    (torch.float32, 2, 2, 333, 64, 100, 0.0),
    (torch.float32, 2, 2, 129, 128, 1000, 0.1),
])
def test_packed_kernels_match_plain(cuda, dtype, b, h, s, d, window, rate):
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    q, k, v, g = _uniform((b, s, h * d), dtype, torch.Generator().manual_seed(s), 4)
    seed = 2**31 - 7
    before = dict(tattn.KERNEL_LAUNCHES)
    out, lse = tpacked._forward(q, k, v, h, window, rate, seed)
    grads = tpacked._backward(q, k, v, out, lse, g, h, window, rate, seed)
    ref, ref_lse = tpacked.attention_packed_reference(q, k, v, h, window, rate, seed,
                                                      with_lse=True)
    ref_grads = tpacked.backward_reference(q, k, v, out, lse, g, h, window, rate, seed)
    torch.cuda.synchronize()
    for key in ("causal_attention_packed_fwd", "causal_attention_packed_bwd"):
        assert tattn.KERNEL_LAUNCHES[key] == before[key] + 1, key
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads)):
        ok, err = _close(got, want, atol)
        assert ok, (name, err)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_packed_autograd_runs_the_kernels(cuda):
    q, k, v = _uniform((2, 192, 256), torch.bfloat16, torch.Generator().manual_seed(0), 3)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = dict(tattn.KERNEL_LAUNCHES)
    out = tpacked.causal_attention_packed(q, k, v, 2, dropout_rate=0.1,
                                          generator=torch.Generator().manual_seed(1))
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert tattn.KERNEL_LAUNCHES["causal_attention_packed_fwd"] == before["causal_attention_packed_fwd"] + 1
    assert tattn.KERNEL_LAUNCHES["causal_attention_packed_bwd"] == before["causal_attention_packed_bwd"] + 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("dtype,window,rate,s,d", [
    (torch.bfloat16, None, 0.1, 200, 128), (torch.float32, 64, 0.1, 200, 128),
    (torch.float32, None, 0.0, 200, 128),
    # the edges of the bf16 tile walk
    (torch.bfloat16, 37, 0.0, 200, 64), (torch.bfloat16, None, 0.0, 1, 128),
    (torch.bfloat16, None, 0.1, 63, 64), (torch.bfloat16, None, 0.0, 65, 128),
    (torch.bfloat16, 1, 0.0, 129, 128), (torch.bfloat16, 1000, 0.1, 129, 64),
    # and of the fp32 forward's (3xTF32, two warp groups a q tile)
    (torch.float32, 37, 0.0, 200, 64), (torch.float32, None, 0.0, 1, 128),
    (torch.float32, None, 0.1, 63, 64), (torch.float32, 1, 0.0, 129, 128),
])
def test_unpacked_forward_matches_plain(cuda, dtype, window, rate, s, d):
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    q, k, v = _uniform((2, 4, s, d), dtype, torch.Generator().manual_seed(3), 3)
    before = tattn.KERNEL_LAUNCHES["causal_attention_fwd"]
    out, lse = tattn.causal_attention(q, k, v, window, rate, True, dropout_seed=12345)
    ref, ref_lse = tattn.attention_reference(q, k, v, True, window, True, rate, 12345)
    torch.cuda.synchronize()
    assert tattn.KERNEL_LAUNCHES["causal_attention_fwd"] == before + 1
    ok, err = _close(out, ref, atol)
    assert ok, err
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    # with grads: the autograd Function launches the backward kernel, held
    # against the plain backward on the kernel's own out and lse
    (g,) = _uniform(q.shape, dtype, torch.Generator().manual_seed(4), 1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(tattn.KERNEL_LAUNCHES)
    out = tattn.causal_attention(*leaves, window, rate, dropout_seed=12345)
    out.backward(g)
    want = tattn.attention_backward_reference(q, k, v, out.detach(), lse, g, window, rate, 12345)
    torch.cuda.synchronize()
    for key in ("causal_attention_fwd", "causal_attention_bwd"):
        assert tattn.KERNEL_LAUNCHES[key] == before[key] + 1, key
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        ok, err = _close(t.grad, w, atol)
        assert ok, (name, err)


BACKWARD_CASES = [  # (dtype, B, H, S, D, window, dropout)
    (torch.bfloat16, 2, 8, 1280, 128, None, 0.0),   # the wedge / whole-row regimes' S
    (torch.bfloat16, 2, 8, 1280, 128, None, 0.1),
    (torch.bfloat16, 1, 8, 4352, 128, None, 0.0),   # the hybrid regime (dalle_4k)
    (torch.bfloat16, 1, 2, 4352, 128, 256, 0.0),
    (torch.float32, 1, 2, 4352, 128, None, 0.0),    # the loop regime: fp32 at S > 3072
    (torch.bfloat16, 1, 2, 6200, 128, None, 0.0),   # the loop regime: S > 6144, ragged
    # the edges of the bf16 tile walk: D = 64 with windows that are not a
    # multiple of the tile, lengths ragged under either q tile
    (torch.bfloat16, 2, 4, 200, 64, 37, 0.0),
    (torch.bfloat16, 2, 4, 1280, 64, 100, 0.1),
    (torch.bfloat16, 2, 3, 63, 128, None, 0.0),
    (torch.bfloat16, 2, 3, 65, 64, None, 0.1),
    (torch.bfloat16, 2, 3, 129, 128, None, 0.0),
    (torch.bfloat16, 2, 3, 129, 64, 1000, 0.1),     # a window wider than S
    # the fp32 kernels (3xTF32) at the edges of the same walk
    # (S = 1 and a window of 1: test_fp32_rows_that_see_only_themselves)
    (torch.float32, 2, 4, 200, 64, 37, 0.0),
    (torch.float32, 2, 3, 63, 128, None, 0.1),
    (torch.float32, 2, 3, 65, 64, None, 0.1),
    (torch.float32, 2, 3, 129, 128, None, 0.0),
    (torch.float32, 2, 3, 129, 64, 1000, 0.1),
    (torch.float32, 1, 8, 1280, 128, None, 0.1),
]


def _with_tiles(cases):
    """Each case with the forward's q tile left to the kernel's rule (None)
    and, in bf16, given: every tile the kernel is built for at that D."""
    for case in cases:
        dtype, d = case[0], case[4]
        given = tattn.FORWARD_TILES[d] if dtype == torch.bfloat16 else ()
        for tile_rows in (None, *given):
            yield (*case, tile_rows)


@pytest.mark.parametrize("dtype,b,h,s,d,window,rate,tile_rows", _with_tiles(BACKWARD_CASES))
def test_unpacked_backward_matches_plain(cuda, dtype, b, h, s, d, window, rate, tile_rows):
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    q, k, v, g = _uniform((b, h, s, d), dtype, torch.Generator().manual_seed(s + h), 4)
    seed = 2**31 - 7
    before = dict(tattn.KERNEL_LAUNCHES)
    out, lse = tattn._forward(q, k, v, window, rate, seed, with_lse=True, tile_rows=tile_rows)
    grads = tattn._backward(q, k, v, out, lse, g, window, rate, seed)
    # no floating-point atomics: a second run gives the same bits
    again = tattn._backward(q, k, v, out, lse, g, window, rate, seed)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    ref, ref_lse = tattn.attention_reference(q, k, v, True, window, True, rate, seed)
    want = tattn.attention_backward_reference(q, k, v, out, lse, g, window, rate, seed)
    torch.cuda.synchronize()
    assert tattn.KERNEL_LAUNCHES["causal_attention_fwd"] == before["causal_attention_fwd"] + 1
    assert tattn.KERNEL_LAUNCHES["causal_attention_bwd"] == before["causal_attention_bwd"] + 2
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    for name, got, w in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *want)):
        ok, err = _close(got, w, atol)
        assert ok, (name, err)
        ok, err = _tile_close(got, w, rtol)
        assert ok, (name, "tile", err)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("head_dim", tattn.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("programs", [1, 2, 4, 32, 33, 128, 256])
def test_kernel_takes_the_q_tile_the_python_rule_names(cuda, head_dim, programs):
    """The kernels carry their own copy of ``forward_tile_rows``: the built
    library's choice must be the Python rule's at every shape, on both sides
    of the 132-CTA edge."""
    import ctypes

    from dalle_mtf_tpu_torch.ops._build import library

    for s in (1, 64, 128, 129, 256, 512, 513, 527, 528, 529, 1280, 4352, 6200, 16896):
        assert tattn.kernel_tile_rows(head_dim, programs, s) == \
            ttiles.forward_tile_rows(head_dim, programs, s), s
    # the library reports each forward it built, by q tile and dtype (1 bf16,
    # 0 fp32), and refuses any other
    out = (ctypes.c_int * 4)()
    for code, built in ((1, tattn.FORWARD_TILES[head_dim]), (0, tattn.FP32_FORWARD_TILES)):
        for rows in (64, 128):
            err = library().causal_attention_fwd_info(head_dim, rows, code, out)
            assert (err == 0) == (rows in built), (code, rows, err)


def test_forward_refuses_a_q_tile_it_is_not_built_for(cuda):
    q = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="tile_rows"):
        tattn._forward(q, q, q, None, 0.0, None, True, tile_rows=128)  # D = 64: 64 rows only
    with pytest.raises(ValueError, match="tile_rows"):
        tattn._forward(q.float(), q.float(), q.float(), None, 0.0, None, True, tile_rows=64)


@pytest.mark.parametrize("s,window", [(1, None), (129, 1)])
def test_rows_that_see_only_themselves_have_zero_dq_dk(cuda, s, window):
    """A row whose only live key is its own has ds = p (dp - dsum) with
    dp = dsum: dq and dk are zero up to fp32 rounding on both sides (no tile
    bound can hold them), out = v and dv = dO exactly."""
    q, k, v, g = _uniform((2, 3, s, 128), torch.bfloat16, torch.Generator().manual_seed(s), 4)
    out, lse = tattn._forward(q, k, v, window, 0.0, 0, with_lse=True)
    dq, dk, dv = tattn._backward(q, k, v, out, lse, g, window, 0.0, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, v) and torch.equal(dv, g)
    own_score = (q.float() * k.float()).sum(-1).reshape(6, s) / 128 ** 0.5
    assert (lse - own_score).abs().max().item() <= 1e-4
    assert dq.float().abs().max().item() <= 1e-5 and dk.float().abs().max().item() <= 1e-5


def test_misaligned_bf16_inputs_raise(cuda):
    """The bf16 tiles are staged by 16-byte copies: the check before every
    causal and packed launch raises on a view that starts off a 16-byte
    boundary or strides by less than a 16-byte chunk, and launches nothing
    (the wrappers copy such a view first:
    test_misaligned_views_are_copied_before_the_kernels)."""
    buf = torch.zeros(2 * 2 * 64 * 128 + 8, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:1 + 2 * 2 * 64 * 128].view(2, 2, 64, 128)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    odd_stride = torch.zeros((2, 2, 64, 129), dtype=torch.bfloat16, device="cuda")[..., :128]
    before = dict(tattn.KERNEL_LAUNCHES)
    for name in ("causal_attention_fwd", "causal_attention_bwd", "causal_attention_packed_fwd",
                 "causal_attention_packed_bwd"):
        for view in (shifted, odd_stride):
            with pytest.raises(ValueError, match="16-byte aligned"):
                tattn.check_kernel_inputs(name, (view, view, view), 128)
    assert tattn.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (17408, 1024)),  # dalle_4k's rows at batch 4
    (torch.float32, (300, 256)),
    (torch.bfloat16, (3, 1, 768)),    # decode rows; E not a power of two
    (torch.float32, (70, 4096)),
    # wide rows: dalle_12B's 5120 and the kernels' widest, 8192, in both
    # dtypes; narrow and ragged ones
    (torch.bfloat16, (8192, 5120)),
    (torch.float32, (257, 5120)),
    (torch.bfloat16, (64, 8192)),
    (torch.float32, (33, 8192)),
    (torch.bfloat16, (301, 136)),
    (torch.float32, (37, 8)),
])
def test_layer_norm_kernels_match_plain(cuda, dtype, shape):
    gen = torch.Generator().manual_seed(shape[-1])
    e = shape[-1]
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to("cuda", dtype)
    dy = torch.randn(shape, generator=gen).to("cuda", dtype)
    g = (1 + 0.3 * torch.randn(e, generator=gen)).cuda()
    b = (0.2 * torch.randn(e, generator=gen)).cuda()
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    before = dict(tln.KERNEL_LAUNCHES)
    y = tln.layer_norm(*leaves)
    y.backward(dy)
    torch.cuda.synchronize()
    for key in ("layer_norm_fwd", "layer_norm_bwd"):
        assert tln.KERNEL_LAUNCHES[key] == before[key] + 1, key
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    ok, err = _close(y, tln.layer_norm_reference(x, g, b), atol)
    assert ok, ("y", err)
    dx, dg, db = tln.layer_norm_backward_reference(x.reshape(-1, e), g, dy.reshape(-1, e))
    ok, err = _close(leaves[0].grad.reshape(-1, e), dx, atol)
    assert ok, ("dx", err)
    for name, got, want in (("dg", leaves[1].grad, dg), ("db", leaves[2].grad, db)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (name, err)
    # the fixed-order reduction: a second run gives the same bits
    again = tln._backward(x.reshape(-1, e), g, dy.reshape(-1, e), 1e-5)
    assert torch.equal(again[1], leaves[1].grad) and torch.equal(again[2], leaves[2].grad)


@pytest.mark.parametrize("dtype,rows,e", [
    (torch.bfloat16, 17408, 1024), (torch.float32, 1001, 768), (torch.bfloat16, 2051, 5120),
    (torch.float32, 300, 8192), (torch.bfloat16, 301, 136), (torch.float32, 37, 8),
])
def test_layer_norm_backward_sums_in_the_walks_order(cuda, dtype, rows, e):
    """The backward's dg/db are the numpy walk's (ops/layer_norm_tiles.py):
    the card's CTA count and tile rows, each CTA's rows in its order, the
    row groups, then the partials in CTA order by 8 warps, within 1e-6 of
    max |walk|; dx within the plain bound of the walk's."""
    gen = torch.Generator().manual_seed(e + rows)
    x = (torch.randn((rows, e), generator=gen) * 2 + 0.5).to("cuda", dtype)
    dy = torch.randn((rows, e), generator=gen).to("cuda", dtype)
    g = (1 + 0.3 * torch.randn(e, generator=gen)).cuda()
    dx, dg, db = tln._backward(x, g, dy, 1e-5)
    tile_rows = tln.bwd_tile_rows(e, dtype)
    n_ctas = tln.bwd_ctas(x.device.index, rows, e, dtype)
    assert n_ctas == min(tln.bwd_resident_ctas(x.device.index, e, dtype), -(-rows // tile_rows))
    wdx, wdg, wdb = tln_tiles.backward_walk(x.float().cpu().numpy(), g.cpu().numpy(),
                                            dy.float().cpu().numpy(), n_ctas, tile_rows)
    for name, got, want in (("dg", dg, wdg), ("db", db, wdb)):
        want = torch.from_numpy(want)
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), (name, err)
    ok, err = _close(dx.cpu(), torch.from_numpy(wdx), 1e-2 if dtype == torch.bfloat16 else 1e-5)
    assert ok, ("dx", err)


def test_layer_norm_kernels_report_their_resources(cuda):
    """Both kernels are built for every width up to 8192 in both dtypes and
    report registers, spills, shared memory and CTAs an SM; the backward's
    cooperative grid fills every SM at least once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for e in (8, 136, 768, 1024, 4096, 4104, 5120, 8192):
            res = tln.kernel_resources(e, dtype)
            for kind, r in res.items():
                assert 0 < r["registers"] <= 255 and r["ctas_per_sm"] >= 1, (e, dtype, kind, r)
            assert res["bwd"]["dynamic_smem_bytes"] <= 232448
            assert tln.bwd_resident_ctas(0, e, dtype) == sms * res["bwd"]["ctas_per_sm"]


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


@pytest.mark.parametrize("n_embd,heads", [(5120, 40), (192, 3)])
def test_model_layer_norm_follows_the_references_rule(cuda, n_embd, heads):
    """A 1-layer fp32 DALLE with ``ln_impl: "pallas"`` on the card: at
    n_embd 5120 (dalle_12B's width, E % 128 == 0) its three LNs a pass run
    the kernels, at 192 the plain forward under autograd (no launch), and
    either way its loss and every grad match the same model with the plain
    LN (``ln_impl: "xla"``): loss within 1e-5, grads within 1e-4 of each
    leaf's max."""
    from dalle_mtf_tpu_torch.models import dalle as tdalle

    cfg = dict(n_embd=n_embd, text_vocab_size=48, image_vocab_size=32, text_seq_len=8,
               image_seq_len=16, n_layers=1, n_heads=heads)
    runs = {}
    for impl in ("pallas", "xla"):
        model = tdalle.DALLE(tdalle.DalleConfig(**cfg, ln_impl=impl), "cuda")
        params = model.init(torch.Generator().manual_seed(0))
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        tokens = torch.randint(0, model.cfg.total_tokens, (2, model.cfg.total_seq_len),
                               generator=torch.Generator().manual_seed(1)).cuda()
        before = dict(tln.KERNEL_LAUNCHES)
        loss = model.loss(params, tokens, train=True)[0]
        loss.backward()
        torch.cuda.synchronize()
        runs[impl] = (loss.item(), [t.grad for t in leaves],
                      {k: tln.KERNEL_LAUNCHES[k] - before[k] for k in before})
    none = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}
    assert runs["pallas"][2] == ({"layer_norm_fwd": 3, "layer_norm_bwd": 3}
                                 if tln.kernel_takes(n_embd) else none)
    assert runs["xla"][2] == none
    assert abs(runs["pallas"][0] - runs["xla"][0]) <= 1e-5
    for got, want in zip(runs["pallas"][1], runs["xla"][1]):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-9


def _quantized(m, k, n, qmax, gen):
    x = torch.randn((m, k), generator=gen).to("cuda", torch.bfloat16)
    w = torch.randn((k, n), generator=gen) * 0.02
    scale = (w.abs().amax(0, keepdim=True) / qmax).clamp_min(1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return x, q, scale


@pytest.mark.parametrize("m,k,n", [
    (4, 1024, 1024), (4, 1024, 4096), (4, 4096, 1024), (4, 1024, 2048),
    (1, 1024, 1024), (32, 1024, 4096), (3, 256, 520), (4, 1024, 52307),
    # every row tile (1, 2, 4 rows) and a ragged last tile
    (2, 1024, 4096), (5, 1024, 1024), (8, 512, 2048), (17, 1024, 1040),
])
def test_decode_matmul_kernels_match_plain(cuda, m, k, n):
    gen = torch.Generator().manual_seed(m * k + n)
    x, q, scale = _quantized(m, k, n, 127.0, gen)
    q, scale = q.cuda(), scale.cuda()
    before = dict(tdmm.KERNEL_LAUNCHES)
    got = tdmm.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert tdmm.KERNEL_LAUNCHES["int8_matmul"] == before["int8_matmul"] + 1
    want = tdmm.int8_matmul_reference(x, q, scale)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()

    x, q, scale = _quantized(m, k, n, 7.0, gen)
    packed, scale = pack_int4(q, 0).cuda(), scale.cuda()
    x_lo, x_hi = x[:, : k // 2].contiguous(), x[:, k // 2:].contiguous()
    got = tdmm.int4_matmul(x_lo, x_hi, packed, scale)
    torch.cuda.synchronize()
    assert tdmm.KERNEL_LAUNCHES["int4_matmul"] == before["int4_matmul"] + 1
    want = tdmm.int4_matmul_reference(x_lo, x_hi, packed, scale)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_decode_matmul_unaligned_weights_and_bad_inputs(cuda):
    """A weight view that starts off a 16-byte boundary takes the byte-wise
    loads; inputs the kernel does not take raise before any launch."""
    gen = torch.Generator().manual_seed(9)
    x, q, scale = _quantized(4, 512, 1025, 127.0, gen)
    q, scale = q.cuda(), scale.cuda()
    w = q[:, 1:]  # a view: not contiguous, so copy, then offset by one byte
    buf = torch.empty(w.numel() + 1, dtype=torch.int8, device="cuda")
    shifted = buf[1:].view(w.shape)
    shifted.copy_(w)
    s = scale[:, 1:].contiguous()
    got = tdmm.int8_matmul(x, shifted, s)
    assert (got - tdmm.int8_matmul_reference(x, shifted, s)).abs().max().item() <= \
        1e-5 * got.abs().max().item()
    with pytest.raises(ValueError, match="contiguous"):
        tdmm.int8_matmul(x, w, s)
    with pytest.raises(ValueError, match="rows"):
        tdmm.int8_matmul(torch.zeros((33, 512), dtype=torch.bfloat16, device="cuda"),
                         shifted, s)
    with pytest.raises(ValueError, match="bf16"):
        tdmm.int8_matmul(x.float(), shifted, s)


def _decode_operands(kind, m, k, n, gen):
    """(x operands, weight, scale) on the card for ``kind`` at [m, k] x [k, n]
    (k: the contraction, halved into packed rows for int4)."""
    x, q, scale = _quantized(m, k, n, 7.0 if kind == "int4" else 127.0, gen)
    if kind == "int8":
        return (x,), q.cuda(), scale.cuda()
    return ((x[:, : k // 2].contiguous(), x[:, k // 2:].contiguous()),
            pack_int4(q, 0).cuda(), scale.cuda())


def _emulated(xs, w, scale, walk):
    return torch.from_numpy(ttiles_dmm.decode_matmul_emulated(
        [x.float().cpu().numpy() for x in xs], w.cpu().numpy(), scale.cpu().numpy(), walk))


def _walk_equal(kind, got, want):
    """int4: the walk's bits. int8: within 2^-20 of max |walk|, a few fp32
    ulps: the tensor cores sum a tile's 16 products (up to 16 significant
    bits each) in a way the walk's exact-then-toward-zero model misses by
    an ulp of the tile's sum in a small share of the outputs (the int4
    tiles' products, up to 12 bits, it models exactly)."""
    if kind == "int4":
        return torch.equal(got, want)
    return (got - want).abs().max().item() <= 2.0**-20 * want.abs().max().item()


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [
    (4, 1024, 1024), (4, 1024, 4096), (4, 4096, 1024), (4, 1024, 2048), (1, 1024, 4096),
    (32, 1024, 4096), (3, 256, 520), (17, 1024, 1040), (4, 1024, 52307),
])
def test_decode_matmul_kernels_equal_the_emulated_walk(cuda, kind, m, k, n):
    """The kernel follows the numpy walk (ops/decode_matmul_tiles.py) under
    the wrapper's plan (``_walk_equal``), and two runs give the same bits."""
    xs, w, scale = _decode_operands(kind, m, k, n, torch.Generator().manual_seed(k + n + m))
    fn = tdmm.int4_matmul if kind == "int4" else tdmm.int8_matmul
    got = fn(*xs, w, scale)
    again = fn(*xs, w, scale)
    assert torch.equal(got, again)
    assert _walk_equal(kind, got.cpu(),
                       _emulated(xs, w, scale, tdmm.plan(w.shape[0], kind == "int4")))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("aligned", [True, False])
def test_every_decode_plan_equals_the_emulated_walk(cuda, kind, aligned):
    """Each built instantiation (rows on 16 bytes, copied asynchronously;
    rows off them, N % 16 != 0, read word by word), under one slice, two and
    the most a cluster takes, over slices of several chunks, follows the
    walk (``_walk_equal``)."""
    gen = torch.Generator().manual_seed(int(aligned) * 10 + len(kind))
    for m, k, n in ((3, 512, 96), (9, 8192, 64)):
        n = n if aligned else n + 3
        xs, w, scale = _decode_operands(kind, m, k, n, gen)
        cands = tdmm.candidates(w.shape[0])
        for walk in [p for p in cands if p.splits in (1, 2) or p is cands[-1]]:
            got = tdmm._launch(f"{kind}_matmul", xs, w, scale, walk)
            assert _walk_equal(kind, got.cpu(), _emulated(xs, w, scale, walk)), (m, k, n, walk)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decode_matmul_keeps_nan_and_inf(cuda, kind):
    """A NaN, a +inf and a -inf planted in x (and a NaN scale) come out where
    the plain version puts them: NaN rows, inf or NaN by the weight's sign,
    a NaN column."""
    m, k, n = 5, 1024, 1024
    xs, w, scale = _decode_operands(kind, m, k, n, torch.Generator().manual_seed(3))
    xs = tuple(x.clone() for x in xs)
    xs[0][0, 7] = float("nan")
    xs[-1][2, 100] = float("inf")
    xs[-1][3, 5] = float("inf")
    xs[0][3, 9] = -float("inf")
    scale = scale.clone()
    scale[0, 33] = float("nan")
    fn, ref = ((tdmm.int4_matmul, tdmm.int4_matmul_reference) if kind == "int4"
               else (tdmm.int8_matmul, tdmm.int8_matmul_reference))
    got, want = fn(*xs, w, scale), ref(*xs, w, scale)
    assert torch.equal(got.isnan(), want.isnan()) and want.isnan()[0].all()
    assert torch.equal(got.isinf(), want.isinf()) and torch.equal(got.isposinf(), want.isposinf())
    finite = want.isfinite()
    assert (got[finite] - want[finite]).abs().max().item() <= \
        1e-5 * want[finite].abs().max().item()


def test_decode_matmul_is_one_kernel_a_call(cuda):
    """The profiler sees one device kernel a call, the decode kernel, and
    nothing else (no second reduction pass, no copy)."""
    cs = _chip_smoke()
    for kind in ("int8", "int4"):
        xs, w, scale = _decode_operands(kind, 4, 1024, 4096, torch.Generator().manual_seed(5))
        fn = tdmm.int4_matmul if kind == "int4" else tdmm.int8_matmul
        ms = cs.kernel_device_ms(torch, lambda _: fn(*xs, w, scale), 1, 10, ("decode_matmul",), 1)
        _, seen = cs.device_profile(torch, lambda _: fn(*xs, w, scale), 1, 10)
        assert ms > 0 and sum(c for c, _ in seen.values()) == 10, seen
        assert all("decode_matmul" in name for name in seen), seen


def test_decode_matmul_kernels_report_their_resources(cuda):
    """Every built instantiation reports its registers, spills and shared
    memory; the shared memory is what ops/decode_matmul.py::smem_bytes
    counts, a CTA fits an SM and a cluster of 8 fits the card."""
    for int4, aligned in tdmm.INSTANTIATIONS:
        walk = tdmm.Plan(tdmm.MAX_PASSES * tdmm.ROWS_PER_PASS, 1)
        res = tdmm.kernel_resources(int4, aligned, walk.k_slice)
        assert res["smem_bytes"] + res["dynamic_smem_bytes"] == tdmm.smem_bytes(walk, int4), \
            (int4, aligned, res)
        assert res["ctas_per_sm"] >= 1 and res["clusters"] >= 1 and res["local_bytes"] == 0, \
            (int4, aligned, res)


# ring attention's per-hop kernels: (dtype, B, H, S_local, diff / S_local,
# window, dropout, D) — the diagonal hop, a past hop, a far past hop, the
# window band crossing the shard edge, a ragged shard with a window whose far
# rows see no key, hash dropout, fp32; and the edges of the bf16 tile walk: a
# ragged bf16 shard under a window, S = 65 (one key past a tile) on the
# diagonal and a past hop, D = 64 with dropout and a window that is not a
# multiple of the tile
RING_CASES = [
    (torch.bfloat16, 2, 4, 1088, 0, None, 0.0, 128),
    (torch.bfloat16, 2, 4, 1088, 1, None, 0.0, 128),
    (torch.bfloat16, 1, 4, 1088, 3, None, 0.0, 128),
    (torch.bfloat16, 2, 4, 1088, 1, 256, 0.0, 128),
    (torch.float32, 1, 2, 200, 1, 120, 0.0, 128),
    (torch.bfloat16, 2, 4, 1088, 1, None, 0.1, 128),
    (torch.float32, 1, 4, 1088, 0, 256, 0.1, 128),
    (torch.bfloat16, 1, 2, 200, 1, 120, 0.0, 128),
    (torch.bfloat16, 2, 3, 65, 0, None, 0.0, 128),
    (torch.bfloat16, 2, 3, 65, 1, None, 0.1, 128),
    (torch.bfloat16, 2, 4, 333, 1, 100, 0.1, 64),
    (torch.bfloat16, 2, 4, 200, 0, 37, 0.0, 64),
    # the fp32 kernels (3xTF32) at the same edges
    (torch.float32, 2, 3, 65, 0, None, 0.0, 128),
    (torch.float32, 2, 3, 65, 1, None, 0.1, 128),
    (torch.float32, 2, 4, 333, 1, 100, 0.1, 64),
    (torch.float32, 2, 4, 200, 0, 37, 0.0, 64),
    (torch.float32, 2, 2, 1, 1, None, 0.0, 128),
    (torch.float32, 2, 4, 1088, 1, None, 0.0, 128),
    # the fp32 forward's two warp groups: a band whose live rows see keys in
    # one half of a tile only and whose last rows see none, the diagonal
    # under a window off the tile with dropout, a far hop
    (torch.float32, 2, 2, 200, 1, 150, 0.0, 128),
    (torch.float32, 2, 3, 65, 0, 40, 0.1, 128),
    (torch.float32, 1, 2, 200, 3, None, 0.1, 128),
]


@pytest.mark.parametrize("dtype,b,h,s,hops,window,rate,d", RING_CASES)
def test_ring_kernels_match_plain(cuda, dtype, b, h, s, hops, window, rate, d):
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    gen = torch.Generator().manual_seed(s + 10 * hops + h)
    q, k, v, g = _uniform((b, h, s, d), dtype, gen, 4)
    diff, row0 = hops * s, 3 * s
    col0, seed = row0 - diff, 2**31 - 7
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    before = dict(tring.KERNEL_LAUNCHES)
    num, m, l = tring.ring_partial(q, k, v, diff, row0, col0, window, rate, seed)
    want = tring.ring_partial_reference(q, k, v, diff, row0, col0, window, rate, seed)
    # rows with a live key in this hop; the others the fold discards
    _, _, mask = tring._masks(s, s, diff, window, q.device)
    live = ~mask.all(-1)
    if window is not None and hops:
        assert not live.all()  # the case does plant rows without a live key
    assert (m[:, ~live] == tring.NEG_INF).all()  # NEG_INF itself, not NEG_INF ln 2
    for name, got, w in (("m", m, want[1]), ("l", l, want[2])):
        err = ((got - w)[:, live].abs() / w[:, live].abs().clamp_min(1.0)).max().item()
        assert err <= 1e-5, (name, err)
    keep = live.reshape(1, 1, s, 1)
    ok, err = _tile_close(num * keep, want[0] * keep, rtol)
    assert ok, ("num", err)
    # no atomics, one order: a second run gives the same bits
    again = tring.ring_partial(q, k, v, diff, row0, col0, window, rate, seed)
    assert all(torch.equal(a, c) for a, c in zip((num, m, l), again))
    lse = (m + torch.log(l.clamp_min(1e-30))).contiguous()
    dsum = (g.float() * torch.rand((b, h, s, d), generator=gen).cuda()).sum(-1)
    dsum = dsum.reshape(b * h, s).contiguous()
    dk, dv = (torch.zeros((b, h, s, d), device="cuda") for _ in range(2))
    args = (diff, row0, col0, window, rate, seed)
    dq = tring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args)
    wq, wk, wv = tring.ring_block_grads_reference(q, g, lse, dsum, k, v, *args)
    torch.cuda.synchronize()
    assert tring.KERNEL_LAUNCHES["ring_partial"] == before["ring_partial"] + 2
    assert tring.KERNEL_LAUNCHES["ring_block_grads"] == before["ring_block_grads"] + 1
    assert dq.dtype == dtype and dk.dtype == dv.dtype == torch.float32
    for name, got, w in (("dq", dq * keep, wq * keep), ("dk", dk, wk), ("dv", dv, wv)):
        ok, err = _close(got, w, atol)
        assert ok, (name, err)
        ok, err = _tile_close(got, w, rtol)
        assert ok, (name, "tile", err)
    # the same bits from fresh accumulators
    dk2, dv2 = (torch.zeros_like(dk) for _ in range(2))
    dq2 = tring.ring_block_grads(q, g, lse, dsum, k, v, dk2, dv2, *args)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    # the accumulators are added into in place: a second hop of the same
    # inputs doubles them exactly (no atomics, one order)
    first = dk.clone(), dv.clone()
    tring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args)
    assert torch.equal(dk, 2 * first[0]) and torch.equal(dv, 2 * first[1])


@pytest.mark.parametrize("head_dim", tattn.KERNEL_HEAD_DIMS)
def test_ring_kernels_take_the_q_tile_the_python_walk_names(cuda, head_dim):
    """The built ring kernels are 64-row owner tiles only, the tile
    ``ops/attention_tiles.py`` walks (``RING_FORWARD_TILES``): the library
    reports the forward for that tile and refuses any other."""
    import ctypes

    from dalle_mtf_tpu_torch.ops._build import library

    res = tattn.kernel_resources(head_dim, "ring")
    assert sorted(res) == sorted([*(f"fwd_{r}" for r in tattn.RING_FORWARD_TILES),
                                  "bwd_dq", "bwd_dkv"])
    assert all(r["registers"] > 0 and r["ctas_per_sm"] >= 1 for r in res.values())
    assert tattn.RING_FORWARD_TILES == (ttiles.BACKWARD_TILE_ROWS,)
    # the fp32 kernels are 64-row owner tiles too
    assert tattn.FP32_FORWARD_TILES == (ttiles.BACKWARD_TILE_ROWS,)
    res32 = tattn.kernel_resources(head_dim, "ring", torch.float32)
    assert sorted(res32) == ["bwd_dkv", "bwd_dq", "fwd_64"]
    assert all(r["registers"] > 0 and r["ctas_per_sm"] >= 1 for r in res32.values())
    out = (ctypes.c_int * 4)()
    for kind in (0, 1, 2):
        for dtype in (0, 1):
            assert library().ring_attention_info(kind, head_dim, 128, dtype, out) != 0


def test_ring_kernels_refuse_misaligned_bf16_views(cuda):
    """The bf16 tiles are staged by 16-byte copies and the fp32 accumulators
    updated by 8-byte pairs: the ring's hop check raises on an input view
    off 16 bytes (the wrappers copy such a view first), and an accumulator
    off 8 bytes, which the kernel adds into and so cannot be copied, raises
    in ``ring_block_grads`` itself; nothing is launched."""
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    shape = (1, 2, 64, 128)
    n = 2 * 64 * 128
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:1 + n].view(shape)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    ok = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    rows = torch.zeros((2, 64), device="cuda")
    acc = torch.zeros(shape, device="cuda")
    odd_acc = torch.zeros(n + 1, device="cuda")[1:].view(shape)
    assert odd_acc.data_ptr() % 8 and odd_acc.is_contiguous()
    before = dict(tring.KERNEL_LAUNCHES)
    for name in ("ring_partial", "ring_block_grads"):
        for args in ((shifted, ok, ok), (ok, ok, shifted)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                tring._check_hop(name, *args)
    with pytest.raises(ValueError, match="8-byte aligned"):
        tring.ring_block_grads(ok, ok, rows, rows, ok, ok, acc, odd_acc, 64, 128, 64)
    assert tring.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("head_dim", [96, 256])
def test_wrappers_refuse_head_dims_without_kernels(cuda, head_dim):
    """The attention wrappers launch their kernels or raise: at a head dim
    with no kernel (96, where the model takes the plain versions itself, and
    256, where the JAX package runs Pallas and no kernel is written yet)
    every one raises on the card before any launch."""
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    b, h, s = 2, 2, 80
    gen = torch.Generator().manual_seed(head_dim)
    q, k, v = _uniform((b, h, s, head_dim), torch.float32, gen, 3)
    pq = q.transpose(1, 2).reshape(b, s, h * head_dim).contiguous()
    hop = (s, 2 * s, s, None, 0.0, 0)
    before = (dict(tattn.KERNEL_LAUNCHES), dict(tring.KERNEL_LAUNCHES))
    for call in (lambda: tattn.causal_attention(q, k, v),
                 lambda: tattn.causal_attention(*(t.clone().requires_grad_(True)
                                                  for t in (q, k, v))),
                 lambda: tpacked.packed_attention(pq, pq, pq, h),
                 lambda: tring.ring_partial(q, k, v, *hop)):
        with pytest.raises(ValueError, match=f"takes D in \\(64, 128\\), got {head_dim}"):
            call()
    assert (dict(tattn.KERNEL_LAUNCHES), dict(tring.KERNEL_LAUNCHES)) == before


@pytest.mark.parametrize("packed", [True, False])
def test_model_takes_plain_attention_where_the_reference_does(cuda, packed):
    """A 2-layer fp32 DALLE on the card at head dim 96 (D % 128 != 0, where
    the JAX package takes its dense reference) runs its attention by the
    plain version: no attention kernel launched, and its loss and every grad
    match the same model on the CPU (loss within 1e-5, grads within 1e-4 of
    each leaf's max). At head dim 256 (the JAX package's Pallas D with no
    kernel yet) the model raises on the card."""
    from dalle_mtf_tpu_torch.models import dalle as tdalle

    cfg = dict(text_vocab_size=48, image_vocab_size=32, text_seq_len=8, image_seq_len=16,
               n_layers=2, n_heads=2, attn_packed=packed)
    runs = {}
    for device in ("cuda", "cpu"):
        model = tdalle.DALLE(tdalle.DalleConfig(n_embd=192, **cfg), device)
        params = model.init(torch.Generator().manual_seed(0))
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        tokens = torch.randint(0, model.cfg.total_tokens, (2, model.cfg.total_seq_len),
                               generator=torch.Generator().manual_seed(1)).to(device)
        before = dict(tattn.KERNEL_LAUNCHES)
        loss = model.loss(params, tokens, train=True)[0]
        loss.backward()
        runs[device] = (loss.item(), [t.grad.cpu() for t in leaves])
        assert tattn.KERNEL_LAUNCHES == before
    assert abs(runs["cuda"][0] - runs["cpu"][0]) <= 1e-5
    for got, want in zip(runs["cuda"][1], runs["cpu"][1]):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-9
    model = tdalle.DALLE(tdalle.DalleConfig(n_embd=512, **cfg), "cuda")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, model.cfg.total_seq_len), dtype=torch.long, device="cuda")
    with pytest.raises(ValueError, match="got 256"):
        model.loss(params, tokens)


@pytest.mark.parametrize("head_dim", tattn.KERNEL_HEAD_DIMS)
def test_fp32_backward_kernels_report_their_resources(cuda, head_dim):
    """The fp32 dQ and dK/dV kernels of both pairs are built and report
    registers, spills, shared memory and CTAs an SM: 384 padded fp32 rows of
    D + 4 words a CTA (two 64-row owner tiles, two buffers of two streamed
    ones), and the dK/dV pass its lse and dsum rows, at least one CTA an SM."""
    tiles = 4 * (head_dim + 4) * 384
    for kind in ("causal", "ring"):
        res = tattn.kernel_resources(head_dim, kind, torch.float32)
        assert sorted(res) == ["bwd_dkv", "bwd_dq", "fwd_64"], kind
        for name, r in res.items():
            assert 0 < r["registers"] <= 255 and r["ctas_per_sm"] >= 1, (kind, name, r)
        assert res["bwd_dq"]["smem_bytes"] == tiles
        assert res["bwd_dkv"]["smem_bytes"] == tiles + 4 * 64 * 4


@pytest.mark.parametrize("head_dim", tattn.KERNEL_HEAD_DIMS)
def test_fp32_forward_kernels_report_their_resources(cuda, head_dim):
    """The fp32 forwards of both pairs (3xTF32, eight warps) are built and
    report registers, spills, shared memory and CTAs an SM: 384 padded fp32
    rows of D + 4 words a CTA (the 64-row q tile split in a big and a small
    tile, two buffers of a k and a v tile), no spills, at least one CTA an
    SM."""
    for kind in ("causal", "ring"):
        r = tattn.kernel_resources(head_dim, kind, torch.float32)["fwd_64"]
        assert r["smem_bytes"] == 4 * (head_dim + 4) * 384, (kind, r)
        assert 0 < r["registers"] <= 255 and r["ctas_per_sm"] >= 1, (kind, r)
        assert r["local_bytes"] == 0, (kind, r)


def test_fp32_forward_refuses_misaligned_views(cuda):
    """The fp32 forwards stage tiles by 16-byte copies: the check before the
    [B, H, S, D], the packed and the ring forward raises on an fp32 view at
    storage offset 1, and launches nothing (the wrappers copy such a view
    first: test_misaligned_views_are_copied_before_the_kernels)."""
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    n = 2 * 2 * 64 * 128
    f = torch.rand(n + 1, device="cuda")[1:].view(2, 2, 64, 128)
    assert f.data_ptr() % 16 and f.is_contiguous() and f.storage_offset() == 1
    ok = torch.rand((2, 2, 64, 128), device="cuda")
    before = dict(tattn.KERNEL_LAUNCHES), dict(tring.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_fwd", (f, ok, ok), 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_packed_fwd",
                                  (ok.reshape(2, 128, 128), f.reshape(2, 128, 128),
                                   ok.reshape(2, 128, 128)), 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tring._check_hop("ring_partial", ok, ok, f)
    assert (dict(tattn.KERNEL_LAUNCHES), dict(tring.KERNEL_LAUNCHES)) == before


@pytest.mark.parametrize("b,h,s,d,window,rate", [
    (1, 8, 1280, 128, None, 0.1), (2, 3, 129, 64, 37, 0.0),
])
def test_fp32_forward_runs_are_bit_equal(cuda, b, h, s, d, window, rate):
    """The fp32 forward's two warp groups are merged in one fixed order and
    nothing is added atomically: two runs of the causal forward, the packed
    one and the ring's give the same bits."""
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    q, k, v = _uniform((b, h, s, d), torch.float32, torch.Generator().manual_seed(s + d), 3)
    seed = 2**31 - 7
    runs = [tattn._forward(q, k, v, window, rate, seed, with_lse=True) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    pq, pk, pv = (t.transpose(1, 2).reshape(b, s, h * d).contiguous() for t in (q, k, v))
    runs = [tpacked._forward(pq, pk, pv, h, window, rate, seed) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    args = (s, 3 * s, 2 * s, window, rate, seed)  # a past hop
    runs = [tring.ring_partial(q, k, v, *args) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF])
@pytest.mark.parametrize("where", ["q", "k", "v"])
def test_fp32_kernels_keep_nans(cuda, where, bits):
    """A NaN in q, k or v stays a NaN through the 3xTF32 split (the card's
    own NaN, 0x7FFFFFFF, and its negative): the causal forward's out, its
    backward's dq, the ring forward's num and the ring backward's dq are NaN
    in every row and column that the NaN reaches, as in any fp32 attention;
    none of them turns it into a zero."""
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    b, h, s, d, r, c = 1, 2, 200, 128, 70, 5
    q, k, v, g = _uniform((b, h, s, d), torch.float32, torch.Generator().manual_seed(9), 4)
    t = {"q": q, "k": k, "v": v}[where]
    t.view(torch.int32)[0, 1, r, c] = bits - 2**32 if bits >= 2**31 else bits
    assert t[0, 1, r, c].isnan()
    cols = [c] if where == "v" else list(range(d))

    def nan_in(x, rows, cols):
        return x[0, 1][rows][:, cols].isnan().all().item()

    # the causal pair: key r reaches the rows at and below it
    rows = [r] if where == "q" else list(range(r, s))
    out, lse = tattn._forward(q, k, v, None, 0.0, 0, with_lse=True)
    dq, _, _ = tattn._backward(q, k, v, out, lse, g, None, 0.0, 0)
    torch.cuda.synchronize()
    assert nan_in(out, rows, cols), "out"
    assert nan_in(dq, rows, list(range(d))), "dq"
    assert not out[0, 0].isnan().any() and not dq[0, 0].isnan().any()
    # the ring pair at a past hop: every key reaches every row
    rows = [r] if where == "q" else list(range(s))
    args = (s, 3 * s, 2 * s, None, 0.0, 0)
    num, m, l = tring.ring_partial(q, k, v, *args)
    lse = (m + torch.log(l.clamp_min(1e-30))).contiguous()
    dsum = (g * num / l.view(b, h, s, 1)).sum(-1).reshape(b * h, s).contiguous()
    dk, dv = (torch.zeros((b, h, s, d), device="cuda") for _ in range(2))
    dq = tring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args)
    torch.cuda.synchronize()
    assert nan_in(num, rows, cols), "num"
    assert nan_in(dq, rows, list(range(d))), "ring dq"
    assert not num[0, 0].isnan().any() and not dq[0, 0].isnan().any()


def test_fp32_backward_refuses_misaligned_views(cuda):
    """The fp32 backward kernels stage tiles by 16-byte copies: the check
    before the causal and the ring backward raises on an fp32 view at
    storage offset 1 (the wrappers copy such a view first), and an fp32
    accumulator off 8 bytes, which the ring kernel adds into, raises in
    ``ring_block_grads`` itself; nothing is launched."""
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    n = 2 * 2 * 64 * 128
    f = torch.rand(n + 1, device="cuda")[1:].view(2, 2, 64, 128)
    assert f.data_ptr() % 16 and f.is_contiguous()
    before = dict(tattn.KERNEL_LAUNCHES), dict(tring.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_bwd", (f, f, f), 128)
    ok = torch.zeros((1, 2, 64, 128), device="cuda")
    rows = torch.zeros((2, 64), device="cuda")
    acc = torch.zeros_like(ok)
    shifted = f.reshape(-1)[:ok.numel()].view(ok.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tring._check_hop("ring_block_grads", shifted, ok, ok)
    odd_acc = torch.zeros(ok.numel() + 1, device="cuda")[1:].view(ok.shape)
    assert odd_acc.data_ptr() % 8
    with pytest.raises(ValueError, match="8-byte aligned"):
        tring.ring_block_grads(ok, ok, rows, rows, ok, ok, acc, odd_acc,
                               64, 128, 64, None, 0.0, 0)
    assert (dict(tattn.KERNEL_LAUNCHES), dict(tring.KERNEL_LAUNCHES)) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_views_are_copied_before_the_kernels(cuda, dtype):
    """A view at storage offset 1 (off 16 bytes in either dtype) given to
    each attention wrapper is copied into a dense tensor before the launch:
    the causal forward and backward, the packed forward and the ring's hop
    pair launch their kernels once each and equal the plain versions on the
    view (atol 1e-5 in fp32, 1e-2 in bf16, of max(1, |plain|))."""
    from dalle_mtf_tpu_torch.ops import ring_attention as tring

    atol = 1e-5 if dtype == torch.float32 else 1e-2
    n = 2 * 2 * 64 * 128
    gen = torch.Generator().manual_seed(7)
    f = (torch.rand(n + 1, generator=gen) * 2 - 1).to("cuda", dtype)[1:].view(2, 2, 64, 128)
    assert f.data_ptr() % 16 and f.is_contiguous() and f.storage_offset() == 1
    ok, g = _uniform((2, 2, 64, 128), dtype, gen, 2)
    before = dict(tattn.KERNEL_LAUNCHES), dict(tring.KERNEL_LAUNCHES)
    out, lse = tattn._forward(f, ok, ok, None, 0.0, None, True)
    good, err = _close(out, tattn.attention_reference(f, ok, ok), atol)
    assert good, err
    grads = tattn._backward(f, ok, ok, out, lse, g, None, 0.0, None)
    for got, want in zip(grads, tattn.attention_backward_reference(f, ok, ok, out, lse, g)):
        good, err = _close(got, want, atol)
        assert good, err
    pf, pok = f.reshape(2, 128, 128), ok.reshape(2, 128, 128)
    got, _ = tpacked._forward(pok, pf, pok, 1, None, 0.0, None)
    good, err = _close(got, tpacked.attention_packed_reference(pok, pf, pok, 1), atol)
    assert good, err
    hop = (64, 128, 64, None, 0.0, 0)
    for t, w in zip(tring.ring_partial(ok, ok, f, *hop),
                    tring.ring_partial_reference(ok, ok, f, *hop)):
        good, err = _close(t, w, atol)
        assert good, err
    rows = torch.zeros((4, 64), device="cuda")
    dk, dv = (torch.zeros((2, 2, 64, 128), device="cuda") for _ in range(2))
    dq = tring.ring_block_grads(f, g, rows, rows, ok, ok, dk, dv, *hop)
    want = tring.ring_block_grads_reference(f, g, rows, rows, ok, ok, *hop)
    for t, w in zip((dq, dk, dv), want):
        good, err = _close(t, w, atol)
        assert good, err
    launched = {k: tattn.KERNEL_LAUNCHES[k] - before[0][k] for k in before[0]}
    assert launched == {"causal_attention_fwd": 1, "causal_attention_bwd": 1,
                        "causal_attention_packed_fwd": 1, "causal_attention_packed_bwd": 0}
    assert {k: tring.KERNEL_LAUNCHES[k] - before[1][k] for k in before[1]} == {
        "ring_partial": 1, "ring_block_grads": 1}


@pytest.mark.parametrize("s,window", [(1, None), (129, 1)])
def test_fp32_rows_that_see_only_themselves(cuda, s, window):
    """fp32 at S = 1 and under a window of 1: every row sees only its own
    key, so out = v (the forward's p = 1), dq and dk are zero up to fp32
    rounding on both sides, and dv = dO to the fp32 bound (p = 1 is one TF32
    value, dO is split in two): each 64-long tile within 1e-5 of its max."""
    q, k, v, g = _uniform((2, 3, s, 64), torch.float32, torch.Generator().manual_seed(s), 4)
    out, lse = tattn._forward(q, k, v, window, 0.0, 0, with_lse=True)
    dq, dk, dv = tattn._backward(q, k, v, out, lse, g, window, 0.0, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, v)
    assert dq.abs().max().item() <= 1e-5 and dk.abs().max().item() <= 1e-5
    ok, err = _tile_close(dv, g, 1e-5)
    assert ok, err


@pytest.mark.parametrize("bf16", [False, True])
def test_vae_step_on_the_card_matches_the_cpu(cuda, bf16):
    """One training step (loss, every grad) and one eval step (loss, PSNR,
    codebook perplexity, Fréchet feature distance) of a small VAE (64 px,
    convblocks ((1, 32), (2, 64)), 256 tokens, batch 4) on the card against
    the CPU, same weights, images and Gumbel draw: chip_smoke.py's values
    check, with its bounds (1e-4 relative in fp32, the convs in IEEE fp32;
    2e-2 in bf16)."""
    values = _chip_smoke().vae_values(torch, bf16)
    assert values["worst_rel"] <= (2e-2 if bf16 else 1e-4)


def test_vae_fp32_convs_ignore_the_tf32_switch(cuda):
    """The VAE's fp32 convs run in IEEE fp32 whatever cuDNN's TF32 switch
    says, forward and backward, and leave the switch as it was."""
    from dalle_mtf_tpu_torch.models import vae as tvae

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 32, 32, generator=gen)
    p = {"w": torch.randn(3, 3, 64, 64, generator=gen) / 24, "b": torch.zeros(64)}
    grads = {}
    for device in ("cpu", "cuda"):
        xd = x.to(device).clone().requires_grad_(True)
        pd = {k: v.to(device).clone().requires_grad_(True) for k, v in p.items()}
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            out = tvae._conv(xd, pd, 1)
            out.square().sum().backward()
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = before
        grads[device] = [t.detach().cpu() for t in (out, xd.grad, pd["w"].grad)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        ok, err = _close(got, want, 1e-5)
        assert ok, err


# ---------------------------------------------- the captured decode loop

def _small_dalle(decode_kernels=False, quant=None):
    """A 2-layer DALLE at n_embd 256 (the decode kernels' smallest K) in
    bf16, its serving weights and a batch of 3 prompts, on the card."""
    from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig
    from dalle_mtf_tpu_torch.quantize import (
        cast_decode_weights,
        quantize_layers_int4,
        quantize_layers_int8,
    )

    cfg = DalleConfig(n_embd=256, text_vocab_size=64, image_vocab_size=128, text_seq_len=16,
                      image_seq_len=64, n_layers=2, n_heads=2, bf_16=True,
                      decode_kernels=decode_kernels)
    dalle = DALLE(cfg, "cuda")
    master = dalle.init(torch.Generator().manual_seed(0))
    params = {None: lambda p: cast_decode_weights(p, torch.bfloat16),
              "int8": quantize_layers_int8, "int4": quantize_layers_int4}[quant](master)
    text = torch.randint(0, 64, (3, 16), generator=torch.Generator().manual_seed(1)).cuda()
    return dalle, params, text


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_captured_decode_equals_the_eager_loop(cuda, quant):
    """The graphs' tokens equal the eager loop's bit for bit, greedy and
    sampled from one seed; with the decode kernels inside the graph each
    replay counts its launches (73 = 6 a layer and the head here: 13)."""
    from dalle_mtf_tpu_torch import sample

    dalle, params, text = _small_dalle(quant is not None, quant)
    dec = sample.CapturedDecoder(dalle, params, 3)
    for temp, top_k in ((0.0, 0), (1.0, 16)):
        want = sample.generate_image_tokens_eager(
            dalle, params, text, torch.Generator("cuda").manual_seed(4), temp, top_k)
        before = dict(tdmm.KERNEL_LAUNCHES)
        got = sample.generate_image_tokens(dalle, params, text,
                                           torch.Generator("cuda").manual_seed(4), temp, top_k,
                                           decoder=dec)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (temp, top_k)
        key = ("batch", top_k, False)
        if quant is not None:
            kind = f"{quant}_matmul"
            per = dec.launches_per_replay(key)
            assert per == {kind: 13}
            made = tdmm.KERNEL_LAUNCHES[kind] - before[kind]
            # the head's one launch in the prefill, the warm-up step, the replays
            assert made == 1 + 13 * sample.WARMUP_STEPS + 13 * 63
    assert dec.replays == {("batch", 0, False): 63, ("batch", 16, False): 63}


def test_captured_draws_advance_across_replays(cuda):
    """The registered generator moves on at every replay: a row sampled
    from the same logits at every step (the step's decode undone by
    resetting the logits buffer) draws a spread of tokens, and two batches
    from one seed repeat exactly."""
    from dalle_mtf_tpu_torch import sample

    dalle, params, text = _small_dalle()
    dec = sample.CapturedDecoder(dalle, params, 3)
    dec.generator.manual_seed(9)
    first = dec.generate(text, 1.0, 0).clone()
    dec.generator.manual_seed(9)
    assert torch.equal(dec.generate(text, 1.0, 0), first)
    graph = dec._graphs[("batch", 0, False)]
    draws = []
    with torch.inference_mode():
        flat = torch.zeros_like(dec.logits)
        for _ in range(40):
            dec.logits.copy_(flat)
            dec.positions.fill_(dalle.cfg.text_seq_len)
            dec.step.zero_()
            graph.replay()
            draws.append(int(dec.image[0, 0]))
    assert len(set(draws)) > 20, draws  # 40 uniform draws over 128 tokens


# ------------------------------------------ the memory-bound training options

def _remat_dalle(**over):
    from dalle_mtf_tpu_torch.models import dalle as tdalle

    cfg = tdalle.DalleConfig(n_embd=256, text_vocab_size=40, image_vocab_size=32,
                             text_seq_len=8, image_seq_len=56, n_layers=2, n_heads=2,
                             bf_16=True, embed_dropout=0.1, residual_dropout=0.1,
                             attention_dropout=0.1, **over)
    return tdalle, cfg


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable", "dots_except_mlp1",
                                    "save_attn", "save_attn_lean"])
def test_remat_is_bit_equal_on_the_card(cuda, policy):
    """The kernels under a recompute: loss and grads bit-equal to no remat
    with every dropout on, the packed forward launched once a layer where
    the policy keeps its out and lse, twice where it re-runs."""
    import dataclasses

    from dalle_mtf_tpu_torch.train.optim import named_leaves

    tdalle, cfg = _remat_dalle()
    params = tdalle.DALLE(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.total_tokens, (2, cfg.total_seq_len),
                           generator=torch.Generator().manual_seed(1)).cuda()
    results = []
    for over in ({}, {"recompute_grad": True, "remat_policy": policy}):
        tree = {k: ({n: t.cuda().requires_grad_(True) for n, t in v.items()}
                    if isinstance(v, dict) else v.cuda().requires_grad_(True))
                for k, v in params.items()}
        before = tattn.KERNEL_LAUNCHES["causal_attention_packed_fwd"]
        gen = torch.Generator().manual_seed(5)
        loss, _ = tdalle.DALLE(dataclasses.replace(cfg, **over), "cuda").loss(tree, tokens, gen)
        loss.backward()
        torch.cuda.synchronize()
        results.append((loss.detach(), [t.grad for _, t in named_leaves(tree)], gen.get_state(),
                        tattn.KERNEL_LAUNCHES["causal_attention_packed_fwd"] - before))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert n0 == cfg.n_layers
    assert n1 == cfg.n_layers * (1 if policy.startswith("save_attn") else 2)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_fused_head_matches_the_plain_fp32_loss_on_the_card(cuda, z_loss):
    """The fused head (bf16 operands, fp32 logits from
    ``torch.mm(..., out_dtype=float32)``) against the fp32 loss of the same
    operands: loss within 1e-4, dx and dw (rounded to bf16) within 2^-7 of
    max |plain|, db within 1e-4 of it."""
    from dalle_mtf_tpu_torch.ops.losses import softmax_cross_entropy_with_logits
    from dalle_mtf_tpu_torch.ops.xent_fused import chunked_softmax_xent

    gen = torch.Generator().manual_seed(3)
    n, e, v = 512, 256, 5000
    x = torch.randn((n, e), generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn((e, v), generator=gen) * 0.05).to("cuda", torch.bfloat16)
    b = (torch.randn(v, generator=gen) * 0.05).cuda()
    t = torch.randint(0, v, (n,), generator=gen).cuda()
    got, want = [], []
    for leaves, fn in (
        (got, lambda xl, wl, bl: chunked_softmax_xent(xl, wl, bl, t, z_loss, 4)),
        (want, lambda xl, wl, bl: softmax_cross_entropy_with_logits(xl @ wl + bl, t, z_loss)),
    ):
        dt = torch.bfloat16 if leaves is got else torch.float32
        xl, wl = (a.detach().to(dt).requires_grad_(True) for a in (x, w))
        bl = b.clone().requires_grad_(True)
        loss = fn(xl, wl, bl)
        loss.sum().backward()
        leaves.extend([loss.detach(), xl.grad, wl.grad, bl.grad])
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    for name, a, ref, bound in zip(("dx", "dw", "db"), got[1:], want[1:],
                                   (2**-7, 2**-7, 1e-4)):
        err = (a.float() - ref).abs().max().item()
        assert err <= bound * ref.abs().max().item(), name


@pytest.mark.parametrize("over", [{}, {"fused_optimizer": True}, {"optimizer": "adafactor"}])
def test_a_nonfinite_step_moves_nothing_on_the_card(cuda, over):
    from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves

    tdalle, cfg = _remat_dalle()
    model = tdalle.DALLE(cfg, "cuda")
    tree = model.init(torch.Generator().manual_seed(0))
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    tokens = torch.randint(0, cfg.total_tokens, (2, cfg.total_seq_len)).cuda()
    opt, _ = get_optimizer({"lr": 1e-3, "warmup_steps": 0, "skip_nonfinite_updates": 3,
                            **over}, tree)
    for poison in (False, True, False):
        before = [t.detach().clone() for _, t in named_leaves(tree)]
        count = opt.count
        opt.zero_grad()
        loss, _ = model.loss(tree, tokens)
        (loss * float("nan") if poison else loss).backward()
        opt.step()
        moved = any(not torch.equal(a, t.detach()) for a, (_, t) in zip(before, named_leaves(tree)))
        assert (moved, opt.count - count) == ((False, 0) if poison else (True, 1))
