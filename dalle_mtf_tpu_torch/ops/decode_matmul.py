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
agree up to the order and rounding of the fp32 sum (the kernel's tensor
cores sum each 16-row tile and round it toward zero). The JAX wrappers compute a ragged
tail of N (past the last 512-column block) as an einsum against a bf16
dequantized weight; the CUDA kernel masks the ragged edge itself, so every
column takes the body's arithmetic.

Replaces ``dalle_mtf_tpu/ops/decode_matmul.py::_int8_kernel`` (driven by
``int8_matmul``) and ``::_int4_kernel`` (driven by ``int4_matmul``). What
bounds them on the H100: the weight stream, K*N bytes (Kp*N packed) read
once at 3.35 TB/s; the activations are a few KB. The design: an exact
dequant to bf16 without the int-to-float unit, the products and the sum
down each 16-row tile on the tensor cores (mma.sync), every tile a zero
accumulator added to fp32 sums, a ring of asynchronous copies a warp, and
where K is long, split-K over a thread-block cluster: one launch a call, the
slices' sums added in slice order through distributed shared memory (see
the source). ``plan`` chooses the slices; ``ops/decode_matmul_tiles.py``
follows the kernel's order in numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Launches of each kernel, counted by its wrapper where (and only where) the
# kernel is launched; chip_smoke.py reads and resets them.
KERNEL_LAUNCHES = {"int8_matmul": 0, "int4_matmul": 0}

M_MAX = 32            # decode rows the kernels take
THREADS = 256         # threads a CTA: 8 warps
WARPS = THREADS // 32
BLOCK_N = 32          # output columns a CTA: two mma tiles of 16
M_TILE = 8            # rows of x a CTA: the mma's n
TILE_K = 16           # rows of K a tile: the mma's k
ROWS_PER_PASS = WARPS * TILE_K  # a pass: one tile a warp
MAX_PASSES = 16       # passes between copies of x (a chunk)
DEPTH = 8             # tiles in flight a warp
TILE_BYTES = 20 * 32  # a tile's 16 rows of 32 bytes, a 32-byte gap after every 4th
MAX_CLUSTER = 8       # K slices a cluster: the portable cluster size
MAX_WORK = 12         # tiles a warp of a plan reads at most, an int4 tile counting 2


class Plan(NamedTuple):
    """How the kernel walks an [M, K] x [K, N] product: K slices of
    ``k_slice`` rows, ``splits`` of them a cluster (one slice: no
    cluster). A CTA covers BLOCK_N columns and M_TILE rows of x."""

    k_slice: int
    splits: int


def passes(p: Plan) -> int:
    """Tiles a warp of the plan reads."""
    return p.k_slice // ROWS_PER_PASS


def ctas(p: Plan, m: int, n: int) -> int:
    return p.splits * math.ceil(n / BLOCK_N) * math.ceil(m / M_TILE)


def smem_bytes(p: Plan, int4: bool) -> int:
    """The kernel's shared memory a CTA: each warp's sums and the cluster's
    gathered sums (static); each warp's ring of DEPTH tile slots, and x as
    bf16 for one chunk of at most MAX_PASSES passes of the slice
    (dynamic)."""
    sums = M_TILE * BLOCK_N
    chunk = min(p.k_slice, MAX_PASSES * ROWS_PER_PASS)
    return ((WARPS * sums + sums + MAX_CLUSTER) * 4 + WARPS * DEPTH * TILE_BYTES
            + (2 if int4 else 1) * M_TILE * chunk * 2)


def candidates(k: int) -> list[Plan]:
    """Every split of K rows (the weight's rows, Kp for int4) into at most
    MAX_CLUSTER slices of whole passes."""
    out = []
    for c in range(1, MAX_CLUSTER + 1):
        ks = math.ceil(math.ceil(k / c) / ROWS_PER_PASS) * ROWS_PER_PASS
        if math.ceil(k / ks) == c:  # a c that rounds to fewer slices is another c
            out.append(Plan(ks, c))
    return out


def plan(k: int, int4: bool = False) -> Plan:
    """The fewest slices (one: no cluster) that leave a warp at most
    MAX_WORK tiles (an int4 tile holds two weights a byte and counts 2), or
    the most slices where none does. Measured on the H100 (PERF.md):
    a cluster costs its barrier and the scheduler's placement, so a decode
    product splits K only where a warp would otherwise stream far longer
    than the rest of the card (mlp2, K = 4096 on N = 1024)."""
    cands = candidates(k)
    fit = [p for p in cands if passes(p) * (2 if int4 else 1) <= MAX_WORK]
    return min(fit, key=lambda p: p.splits) if fit else cands[-1]


def int8_matmul_reference(x, w, scale):
    """Plain version: exact products in fp32, fp32 sum, then the scale."""
    return (x.float() @ w.to(torch.bfloat16).float()) * scale.float()


def int4_matmul_reference(x_lo, x_hi, packed, scale):
    """Plain version of the int4 product: both nibble halves, fp32 sum."""
    p = packed.int()
    lo = ((p << 28) >> 28).to(torch.bfloat16).float()
    hi = (p >> 4).to(torch.bfloat16).float()
    return (x_lo.float() @ lo + x_hi.float() @ hi) * scale.float()


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


def _launch(name, xs, w, scale, walk: Plan | None = None):
    """Launch ``name`` on CUDA tensors with the plan ``walk`` (by default
    ``plan``'s): allocate the output, launch once, raise on a launch error."""
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    m, k = xs[0].shape
    n = w.shape[1]
    p = walk or plan(k, name == "int4_matmul")
    with torch.cuda.device(w.device):
        out = torch.empty((m, n), dtype=torch.float32, device=w.device)
        err = getattr(library(), name)(
            *(x.data_ptr() for x in xs), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, *p, torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    KERNEL_LAUNCHES[name] += 1
    return out


def kernel_resources(int4: bool, aligned: bool = True, k_slice: int | None = None,
                     cluster: int = MAX_CLUSTER) -> dict[str, int]:
    """What the built instantiation (``aligned``: the weight's rows start on
    16 bytes) takes at a slice of ``k_slice`` rows (by default a whole
    chunk), read from the card's runtime: {"registers", "local_bytes"
    (spills), "smem_bytes" (static), "dynamic_smem_bytes", "ctas_per_sm",
    "clusters" (clusters of ``cluster`` CTAs resident at once; 0 for a
    cluster of 1, which launches without one)}."""
    import ctypes  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    k_slice = k_slice or MAX_PASSES * ROWS_PER_PASS
    out = (ctypes.c_int * 6)()
    err = library().decode_matmul_info(int(int4), int(aligned), k_slice, cluster, out)
    if err != 0:
        raise RuntimeError(f"decode_matmul_info({int4}, {aligned}, {k_slice}, {cluster}): "
                           f"cudaError {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "dynamic_smem_bytes",
                     "ctas_per_sm", "clusters"), (int(v) for v in out)))


INSTANTIATIONS = [(int4, aligned) for int4 in (False, True) for aligned in (True, False)]


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
