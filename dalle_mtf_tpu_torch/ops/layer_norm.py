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
  multiple of 8 up to 8192, and raises for any other E. On CPU tensors it
  runs the two plain versions at every E. The forward saves only x (and
  g): the backward recomputes the row statistics, as the TPU kernel does.
- ``kernel_takes``: the E at which the model takes these kernels, the JAX
  ``layer_norm``'s own rule (E % 128 == 0; its XLA reference elsewhere),
  within ``MAX_E``. The model runs the plain forward under autograd at any
  other E, on the card too.

What bounds the kernels on the H100: bytes (x read and y written; x and dy
read and dx written), ~10-16 fp32 operations an element. The forward keeps
a row in registers (a warp a row up to E = 4096, a CTA a row past it). The
backward is one cooperative launch of a persistent grid: tiles of
``bwd_tile_rows(e, dtype)`` rows staged into shared memory by 1-D bulk copies
(TMA) in a ring of two stages, the row statistics from shared memory, dx and the
per-column dg/db sums by a thread that keeps its columns for every row, and
dg/db added across CTAs in a fixed order after a grid barrier, in the same
launch. ``ops/layer_norm_tiles.py`` walks that order in numpy. See the
source.
"""

from __future__ import annotations

import functools
import math

import torch

# Launches of each wrapper's kernel, counted where (and only where) it is
# launched; chip_smoke.py reads and resets them.
KERNEL_LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_E = 8192          # both kernels (csrc/layer_norm.cu kMaxE)
_STAGES = 2           # the backward's ring of tiles (csrc/layer_norm.cu kStages)
_SMEM_BUDGET = 112 * 1024  # two CTAs' share of an SM's 228 KB
_MAX_TILE_ROWS = 64


def kernel_takes(e: int) -> bool:
    """Whether the model takes the fused kernels at row width ``e``: the
    JAX ``layer_norm``'s rule (its Pallas pair at E % 128 == 0, its XLA
    reference elsewhere), within what the kernels take."""
    return e % 128 == 0 and e <= MAX_E


def bwd_tile_rows(e: int, dtype: torch.dtype) -> int:
    """Rows a tile of the backward at row width ``e``: the most, a power of
    two up to 64, whose x and dy in both stages, with g, fit in two CTAs'
    share of an SM (one row at the least)."""
    pair = 2 * e * (torch.finfo(dtype).bits // 8)
    rows = 1
    while rows < _MAX_TILE_ROWS and _STAGES * 2 * rows * pair + 4 * e <= _SMEM_BUDGET:
        rows *= 2
    return rows


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


def _info(kind: int, e: int, dtype: torch.dtype) -> dict[str, int]:
    import ctypes  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    out = (ctypes.c_int * 5)()
    err = library().layer_norm_info(kind, e, KERNEL_DTYPES[dtype], bwd_tile_rows(e, dtype), out)
    if err != 0:
        raise RuntimeError(f"layer_norm_info({kind}, {e}, {dtype}): cudaError {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "dynamic_smem_bytes",
                     "ctas_per_sm"), (int(v) for v in out)))


def kernel_resources(e: int, dtype: torch.dtype = torch.bfloat16) -> dict[str, dict[str, int]]:
    """What the built kernels take at row width ``e`` in ``dtype``, read
    from the card's runtime: {"fwd" | "bwd": {"registers", "local_bytes"
    (spills), "smem_bytes" (static), "dynamic_smem_bytes", "ctas_per_sm"}},
    the backward at its ``bwd_tile_rows``."""
    return {"fwd": _info(0, e, dtype), "bwd": _info(1, e, dtype)}


@functools.lru_cache(maxsize=None)
def bwd_resident_ctas(device_index: int, e: int, dtype: torch.dtype) -> int:
    """CTAs of the backward the card holds at once at row width ``e``: its
    SMs times the CTAs an SM holds at that shared-memory size. The
    cooperative launch takes no more."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    with torch.cuda.device(device_index):
        return sms * _info(1, e, dtype)["ctas_per_sm"]


_BARRIERS: dict[tuple[int, int], torch.Tensor] = {}


def _barrier(device: torch.device, stream) -> torch.Tensor:
    """The backward's grid-barrier words for launches on ``stream``: zeroed
    once, and left zero by every launch (launches on one stream never
    overlap; each stream has its own)."""
    key = (device.index, stream.cuda_stream)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _BARRIERS[key]


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


def bwd_ctas(device_index: int, rows: int, e: int, dtype: torch.dtype) -> int:
    """The backward's CTAs for ``rows`` rows: as many as the card holds at
    once, at most one a tile."""
    return min(bwd_resident_ctas(device_index, e, dtype),
               math.ceil(rows / bwd_tile_rows(e, dtype)))


def _backward(x, g, dy, eps):
    if all(t.device.type == "cpu" for t in (x, g, dy)):
        return layer_norm_backward_reference(x, g, dy, eps)
    dy = dy.contiguous()
    rows, e = x.shape
    _check("layer_norm_bwd", (g,), x, dy)
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    with torch.cuda.device(x.device):
        n_ctas = bwd_ctas(x.device.index, rows, e, x.dtype)
        stream = torch.cuda.current_stream(x.device)
        dx = torch.empty_like(x)
        partial = torch.empty((n_ctas, 2, e), dtype=torch.float32, device=x.device)
        dg, db = torch.empty((2, e), dtype=torch.float32, device=x.device)
        err = library().layer_norm_bwd(
            x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            _barrier(x.device, stream).data_ptr(), dg.data_ptr(), db.data_ptr(), rows, e,
            bwd_tile_rows(e, x.dtype), n_ctas, KERNEL_DTYPES[x.dtype], eps, stream.cuda_stream)
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
