"""Fused LayerNorm, forward and backward (port of
``dalle_mtf_tpu/ops/layer_norm.py``, the model's ``ln_impl: "pallas"``).

- ``layer_norm_reference``: the plain forward, normalise in fp32 then the
  affine, output in x's dtype (the JAX ``layer_norm_reference``).
- ``layer_norm_backward_reference``: the plain backward, the TPU kernel
  ``_ln_bwd_kernel``'s formula step by step in fp32 (mean and rstd
  recomputed from x), not autograd through the forward.
- ``layer_norm``: LayerNorm over the last axis with gradients, through
  ``_LayerNorm`` (a ``torch.autograd.Function``). On CUDA tensors it runs
  the hand-written kernels ``csrc/layer_norm.cu`` (the port of
  ``_ln_fwd_kernel`` and ``_ln_bwd_kernel``), which take any E that is a
  multiple of 8 up to 4096, and raises for any other E. On CPU tensors it
  runs the two plain versions at every E, which is what the JAX
  ``layer_norm`` computes at E % 128 != 0 through its XLA reference (its
  128-lane bound is the TPU's layout, not the CUDA kernel's). The forward
  saves only x (and g): the backward recomputes the row statistics, as the
  TPU kernel does.

What bounds the kernels on the H100: bytes (x read and y written; x and dy
read and dx written), ~10 fp32 operations an element. See the source.
"""

from __future__ import annotations

import math

import torch

# Launches of each wrapper's kernel, counted where (and only where) it is
# launched; chip_smoke.py reads and resets them. One backward call is two
# launches (the rows, then the fixed-order sum of the partials), counted once.
KERNEL_LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_E = 4096         # 16 steps of 256 columns a warp (csrc/layer_norm.cu)
ROWS_PER_CTA = 8     # one warp a row
BWD_CTAS = 264       # backward CTAs at most: two per SM on the H100's 132


def layer_norm_reference(x, g, b, eps: float = 1e-5):
    """Plain LayerNorm over the last axis: fp32 mean, two-pass variance,
    (x - mean) * rsqrt(var + eps) * g + b, in x's dtype."""
    xc = x.float()
    mean = xc.mean(dim=-1, keepdim=True)
    xm = xc - mean
    var = (xm * xm).mean(dim=-1, keepdim=True)
    out = xm * torch.rsqrt(var + eps) * g.float() + b.float()
    return out.to(x.dtype)


def layer_norm_backward_reference(x, g, dy, eps: float = 1e-5):
    """The plain backward over rows x, dy [R, E]: ``_ln_bwd_kernel`` in
    fp32. Returns dx in x's dtype and dg, db [E] in g's dtype."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    r = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * r
    dxhat = dyf * g.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = r * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype), (dyf * xhat).sum(0).to(g.dtype), dyf.sum(0).to(g.dtype))


def _check(name, params, *tensors):
    """The checks before a launch: CUDA tensors on one device, rows [R, E]
    of one kernel dtype, fp32 ``params`` (g, and b) [E], contiguous and
    16-byte aligned (the kernels read 16 bytes at a time)."""
    first = tensors[0]
    if first.dtype not in KERNEL_DTYPES or any(t.dtype != first.dtype for t in tensors):
        raise ValueError(f"{name} takes float32 or bfloat16 rows alike, got "
                         f"{[t.dtype for t in tensors]}")
    if first.dim() != 2 or first.shape[0] < 1 or any(t.shape != first.shape for t in tensors):
        raise ValueError(f"{name}: rows must share one [R, E] shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    e = first.shape[1]
    if e % 8 or e > MAX_E:
        raise ValueError(f"{name} takes E a multiple of 8 up to {MAX_E}, got {e}")
    for p in params:
        if p.dtype != torch.float32 or p.shape != (e,):
            raise ValueError(f"{name}: g and b must be fp32 [{e}], got {p.dtype} "
                             f"{tuple(p.shape)}")
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    everything = (*tensors, *params)
    if any(t.device != first.device for t in everything):
        raise ValueError(f"{name}: inputs must lie on one device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in everything):
        raise ValueError(f"{name} needs contiguous, 16-byte aligned inputs")


def _forward(x, g, b, eps):
    if all(t.device.type == "cpu" for t in (x, g, b)):
        return layer_norm_reference(x, g, b, eps)
    _check("layer_norm_fwd", (g, b), x)
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        err = library().layer_norm_fwd(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), *x.shape,
            KERNEL_DTYPES[x.dtype], eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_fwd launch failed: cudaError {err}")
    KERNEL_LAUNCHES["layer_norm_fwd"] += 1
    return y


def _backward(x, g, dy, eps):
    if all(t.device.type == "cpu" for t in (x, g, dy)):
        return layer_norm_backward_reference(x, g, dy, eps)
    dy = dy.contiguous()
    rows, e = x.shape
    _check("layer_norm_bwd", (g,), x, dy)
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    n_ctas = min(math.ceil(rows / ROWS_PER_CTA), BWD_CTAS)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        partial = torch.empty((n_ctas, 2, e), dtype=torch.float32, device=x.device)
        dg, db = (torch.empty(e, dtype=torch.float32, device=x.device) for _ in range(2))
        err = library().layer_norm_bwd(
            x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dg.data_ptr(), db.data_ptr(), rows, e, n_ctas, KERNEL_DTYPES[x.dtype], eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd launch failed: cudaError {err}")
    KERNEL_LAUNCHES["layer_norm_bwd"] += 1
    return dx, dg, db


class _LayerNorm(torch.autograd.Function):
    """y = LN(x2d) over rows [R, E] with fp32 g, b [E]; saves x and g."""

    @staticmethod
    def forward(ctx, x2d, g, b, eps):
        ctx.save_for_backward(x2d, g)
        ctx.eps = eps
        return _forward(x2d, g, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x2d, g = ctx.saved_tensors
        dx, dg, db = _backward(x2d, g, dy, ctx.eps)
        return dx, dg, db, None


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; g, b are [E]. Normalises in fp32 and
    returns x's dtype; gradients for x, g and b (dg, db in their own
    dtypes)."""
    e = x.shape[-1]
    if g.shape != (e,) or b.shape != (e,):
        raise ValueError(f"g and b must be [{e}], got {tuple(g.shape)}, {tuple(b.shape)}")
    y = _LayerNorm.apply(x.reshape(-1, e).contiguous(), g.float(), b.float(), float(eps))
    return y.reshape(x.shape)
