"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
with only PyTorch and CUDA (skip the JAX conftest there):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips. Tolerance: max |kernel - plain| <=
atol * max(1, max |plain|), atol 1e-5 in fp32 and 1e-2 in bf16, on
unit-scale inputs (uniform in [-1, 1); one bf16 rounding is 2^-8
relative); lse atol 1e-4. The decode matmuls: the same exact products
summed in fp32 in another order, so 1e-5 of max |plain|.
"""

import pytest
import torch

from dalle_mtf_tpu_torch.ops import attention as tattn
from dalle_mtf_tpu_torch.ops import attention_packed as tpacked
from dalle_mtf_tpu_torch.ops import decode_matmul as tdmm
from dalle_mtf_tpu_torch.quantize import pack_int4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, atol):
    err = (got.float() - want.float()).abs().max().item()
    return err <= atol * max(1.0, want.float().abs().max().item()), err


def _uniform(shape, dtype, gen, n):
    return [(torch.rand(shape, generator=gen) * 2 - 1).to("cuda", dtype) for _ in range(n)]


@pytest.mark.parametrize("dtype,b,h,s,d,window,rate", [
    (torch.bfloat16, 2, 2, 256, 128, None, 0.0),
    (torch.bfloat16, 2, 2, 320, 128, None, 0.1),
    (torch.float32, 2, 4, 200, 64, 64, 0.1),
    (torch.float32, 1, 2, 130, 128, 5, 0.0),
    (torch.bfloat16, 16, 8, 1280, 128, None, 0.0),  # the training shape
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


@pytest.mark.parametrize("dtype,window,rate", [
    (torch.bfloat16, None, 0.1), (torch.float32, 64, 0.1), (torch.float32, None, 0.0),
])
def test_unpacked_forward_matches_plain(cuda, dtype, window, rate):
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    q, k, v = _uniform((2, 4, 200, 128), dtype, torch.Generator().manual_seed(3), 3)
    before = tattn.KERNEL_LAUNCHES["causal_attention_fwd"]
    out, lse = tattn.causal_attention(q, k, v, window, rate, True, dropout_seed=12345)
    ref, ref_lse = tattn.attention_reference(q, k, v, True, window, True, rate, 12345)
    torch.cuda.synchronize()
    assert tattn.KERNEL_LAUNCHES["causal_attention_fwd"] == before + 1
    ok, err = _close(out, ref, atol)
    assert ok, err
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        tattn.causal_attention(q, k, v)


def _quantized(m, k, n, qmax, gen):
    x = torch.randn((m, k), generator=gen).to("cuda", torch.bfloat16)
    w = torch.randn((k, n), generator=gen) * 0.02
    scale = (w.abs().amax(0, keepdim=True) / qmax).clamp_min(1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return x, q, scale


@pytest.mark.parametrize("m,k,n", [
    (4, 1024, 1024), (4, 1024, 4096), (4, 4096, 1024), (4, 1024, 2048),
    (1, 1024, 1024), (32, 1024, 4096), (3, 256, 520), (4, 1024, 52307),
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
