"""Streaming dequant matmuls for the decode hot path (port of
``dalle_mtf_tpu/ops/decode_matmul.py``).

- ``int8_matmul(x, w, scale)``: x [M, K] bf16, w [K, N] int8, scale [1, N]
  fp32 -> [M, N] fp32 = (x @ w) * scale.
- ``int4_matmul(x_lo, x_hi, packed, scale)``: x_lo/x_hi [M, Kp] bf16, packed
  [Kp, N] int8 (split-half nibbles, quantize.py), scale [1, N] fp32 -> [M, N]
  fp32 = (x_lo @ low nibbles + x_hi @ high nibbles) * scale. Callers build
  x_lo/x_hi to match the packing: a half-split of the contraction axis, or
  for wo the per-head halves of head_dim.

M <= 32 (decode rows). On a CUDA tensor each wrapper launches its
hand-written kernel (``csrc/decode_matmul.cu``) or raises; on a CPU tensor
it runs its plain version (``*_reference``). The plain versions compute what
the TPU kernels compute: int8 (or nibble) values converted exactly to bf16
and fp32, products of bf16 x and those values exact in fp32, an fp32 sum
over K, then one multiply by the column scale. Kernel and plain version
agree up to the order of the fp32 sum. The JAX wrappers compute a ragged
tail of N (past the last 512-column block) as an einsum against a bf16
dequantized weight; the CUDA kernel masks the ragged edge itself, so every
column takes the body's arithmetic.

Replaces ``dalle_mtf_tpu/ops/decode_matmul.py::_int8_kernel`` (driven by
``int8_matmul``) and ``::_int4_kernel`` (driven by ``int4_matmul``). What
bounds them on the H100: the weight stream, K*N bytes (Kp*N packed) read
once at 3.35 TB/s; the activations are a few KB and the arithmetic is a few
operations per weight byte. The design answers with 16-byte loads of weight
rows, every load of a thread's slice issued before its arithmetic, split-K
across CTAs to fill the 132 SMs, and a fixed-order second pass over the
partial sums instead of atomics (see the source).
"""

from __future__ import annotations

import math

import torch

# Launches of each kernel, counted by its wrapper where (and only where) the
# kernel is launched; chip_smoke.py reads and resets them.
KERNEL_LAUNCHES = {"int8_matmul": 0, "int4_matmul": 0}

M_MAX = 32            # decode rows the kernels take
BLOCK_N = 128         # output columns per CTA (8 lanes x 16 bytes)
ROWS_PER_PASS = 32    # weight rows a CTA reads per pass (8 warps x 4)
MAX_K_SLICE = 256     # weight rows per CTA at most (its x slice in shared)
TARGET_CTAS = 264     # two CTAs per SM on the H100's 132


def int8_matmul_reference(x, w, scale):
    """Plain version: exact products in fp32, fp32 sum, then the scale."""
    return (x.float() @ w.to(torch.bfloat16).float()) * scale.float()


def int4_matmul_reference(x_lo, x_hi, packed, scale):
    """Plain version of the int4 product: both nibble halves, fp32 sum."""
    p = packed.int()
    lo = ((p << 28) >> 28).to(torch.bfloat16).float()
    hi = (p >> 4).to(torch.bfloat16).float()
    return (x_lo.float() @ lo + x_hi.float() @ hi) * scale.float()


def m_tile(m: int) -> int:
    """Rows of x one CTA carries: the power of two >= m, at most 4 (more
    rows take more CTAs along the grid's z axis)."""
    return 1 if m <= 1 else 2 if m == 2 else 4


def split_k(m: int, k: int, n: int) -> tuple[int, int]:
    """(rows per K slice, number of slices) for a [m, k] x [k, n] product:
    enough CTAs to fill the card (TARGET_CTAS), slices of whole passes of
    ROWS_PER_PASS rows and at most MAX_K_SLICE rows."""
    ctas = math.ceil(n / BLOCK_N) * math.ceil(m / m_tile(m))
    splits = max(math.ceil(k / MAX_K_SLICE),
                 min(math.ceil(TARGET_CTAS / ctas), max(1, k // ROWS_PER_PASS)))
    ks = math.ceil(math.ceil(k / splits) / ROWS_PER_PASS) * ROWS_PER_PASS
    return ks, math.ceil(k / ks)


def _check(name, xs, w, scale):
    m, k = xs[0].shape
    if any(x.dtype != torch.bfloat16 for x in xs) or w.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise ValueError(f"{name} takes bf16 x, int8 weights and fp32 scales, got "
                         f"{[x.dtype for x in xs]}, {w.dtype}, {scale.dtype}")
    if any(x.shape != (m, k) for x in xs) or w.dim() != 2 or w.shape[0] != k \
            or tuple(scale.shape) != (1, w.shape[1]):
        raise ValueError(f"{name}: shapes {[tuple(x.shape) for x in xs]} x "
                         f"{tuple(w.shape)} with scale {tuple(scale.shape)}")
    if not 1 <= m <= M_MAX:
        raise ValueError(f"{name} takes 1 <= M <= {M_MAX} rows, got {m}")
    tensors = (*xs, w, scale)
    if any(t.device != w.device for t in tensors):
        raise ValueError(f"{name}: inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def _launch(name, xs, w, scale):
    """Launch ``name`` on CUDA tensors: allocate the output and the split-K
    partials, launch, raise on a launch error."""
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    m, k = xs[0].shape
    n = w.shape[1]
    mt = m_tile(m)
    ks, splits = split_k(m, k, n)
    with torch.cuda.device(w.device):
        out = torch.empty((m, n), dtype=torch.float32, device=w.device)
        partial = (torch.empty((splits, m, n), dtype=torch.float32, device=w.device)
                   if splits > 1 else out)
        err = getattr(library(), name)(
            *(x.data_ptr() for x in xs), w.data_ptr(), scale.data_ptr(),
            out.data_ptr(), partial.data_ptr(), m, k, n, mt, ks, splits,
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    KERNEL_LAUNCHES[name] += 1
    return out


def _dispatch(name, xs, w, scale, reference):
    tensors = (*xs, w, scale)
    if all(t.device.type == "cpu" for t in tensors):
        return reference(*xs, w, scale)
    _check(name, xs, w, scale)
    if w.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {w.device}")
    return _launch(name, xs, w, scale)


def int8_matmul(x, w, scale):
    """x [M, K] bf16 @ w [K, N] int8, times scale [1, N] -> fp32 [M, N]."""
    return _dispatch("int8_matmul", (x,), w, scale, int8_matmul_reference)


def int4_matmul(x_lo, x_hi, packed, scale):
    """x_lo/x_hi [M, Kp] bf16 against the low/high nibbles of packed
    [Kp, N] int8, times scale [1, N] -> fp32 [M, N]."""
    return _dispatch("int4_matmul", (x_lo, x_hi), packed, scale, int4_matmul_reference)
