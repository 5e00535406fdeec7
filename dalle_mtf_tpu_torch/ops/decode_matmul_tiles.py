"""The walk of the decode matmul kernels (``csrc/decode_matmul.cu``), in numpy.

The kernels' order of arithmetic is written once here, and the CUDA source
points at it:

- ``dequant_int8_words`` / ``dequant_int4_words``: the dequant without the
  int-to-float unit, on the int32 bit patterns of the weight's 4-byte words.
  int8: a byte biased (``^ 0x80``) and put into the mantissa of 2^23
  (``__byte_perm(word, 0x4B000000, 0x7540 | j)``: the float 2^23 + u), the
  bias (2^23 + 128) taken away in one subtraction. int4: a nibble biased
  (``^ 0x8``) and put into the mantissa of 128 as bf16 (``lop3``: 0x4300 |
  u, the bf16 128 + u), 136 taken away in one bf16 subtraction;
- ``decode_matmul_emulated``: the product as the kernel sums it under a
  ``decode_matmul.Plan``. Warp w of the CTA of slice s takes the 16-row
  tiles s * k_slice + (q * 8 + w) * 16, q = 0, 1, ...; a tile is one
  tensor-core product from a zero accumulator (int4: two, the low nibbles'
  with x_lo, then the high nibbles' with x_hi), whose fp32 result is the
  exact sum of its 16 exact products rounded toward zero, and which the warp
  adds to its fp32 sums rounding to nearest, in q order; the 8 warps' sums
  are added in warp order, the slices' in slice order, and the scale
  multiplies last.

A card test holds the kernels to this walk: bit for bit for int4, whose
tiles' products have at most 12 significant bits; for int8 (up to 16 bits)
the tensor cores' own sum of a tile differs from the exact sum rounded
toward zero by an ulp in a small share of the outputs (measured on the
H100), so there within 2^-20 of the largest output. Nothing on the serving
path imports this module.
"""

from __future__ import annotations

import numpy as np

from dalle_mtf_tpu_torch.ops.decode_matmul import ROWS_PER_PASS, TILE_K, WARPS, Plan

MAGIC = 0x4B000000                   # 2^23 as fp32 bits
BYTE_BIAS = np.float32(8388736.0)    # 2^23 + 128
NIBBLE_MAGIC = 0x4300                # 128 as bf16 bits
NIBBLE_BIAS = np.float32(136.0)      # 128 + 8, a bf16


def _words(w: np.ndarray) -> np.ndarray:
    """The int8 array's bytes as little-endian uint32 words (zero-padded to a
    whole word)."""
    b = np.ascontiguousarray(w).view(np.uint8).reshape(-1)
    b = np.concatenate([b, np.zeros(-len(b) % 4, np.uint8)])
    return b.view("<u4").astype(np.uint32)


def _bytes_of(words: np.ndarray) -> np.ndarray:
    """[n_words, 4]: byte j of each word, as uint32."""
    return (words[:, None] >> (np.arange(4, dtype=np.uint32) * 8)) & np.uint32(0xFF)


def dequant_int8_words(w: np.ndarray) -> np.ndarray:
    """int8 ``w`` as exact float32 values, by the kernel's bit arithmetic."""
    bits = _bytes_of(_words(w) ^ np.uint32(0x80808080)) | np.uint32(MAGIC)
    f = bits.astype(np.uint32).view(np.float32) - BYTE_BIAS
    return f.reshape(-1)[: w.size].reshape(w.shape)


def _bf16_bits(bits: np.ndarray) -> np.ndarray:
    """16-bit bf16 patterns as float32 values."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def dequant_int4_words(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The low and high nibbles of packed int8 ``packed`` as exact float32
    values (lo = (p << 28) >> 28, hi = p >> 4), by the kernel's bit
    arithmetic: ((nibble ^ 8) | 0x4300 as bf16) - 136."""
    b = _bytes_of(_words(packed))
    out = []
    for nib in (b & np.uint32(0xF), b >> np.uint32(4)):
        f = _bf16_bits((nib ^ np.uint32(8)) | np.uint32(NIBBLE_MAGIC)) - NIBBLE_BIAS
        out.append(f.reshape(-1)[: packed.size].reshape(packed.shape))
    return tuple(out)


def _toward_zero(s: np.ndarray) -> np.ndarray:
    """float64 ``s`` rounded toward zero to float32."""
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def decode_matmul_emulated(xs, w: np.ndarray, scale: np.ndarray, walk: Plan) -> np.ndarray:
    """[M, N] float32: ``xs`` (one [M, K] float32 array of bf16 values for
    int8, two for int4: x_lo, x_hi) against int8 ``w`` [K, N] (packed
    nibbles for int4), times ``scale`` [1, N], summed in the kernel's order
    under ``walk``. Each tile's 16 products are summed exactly in float64
    (exact while the tile's products span fewer than 2^37 in magnitude)."""
    int4 = len(xs) == 2
    vals = dequant_int4_words(w) if int4 else (dequant_int8_words(w),)
    k, n = w.shape
    m = xs[0].shape[0]
    q_count = walk.k_slice // ROWS_PER_PASS
    pad = walk.splits * walk.k_slice - k
    # [slice, q, warp, row of the tile]; rows past K are zeros, whose tiles
    # the kernel skips: adding +0 leaves a sum that started at +0 as it is
    xk = [np.pad(x.astype(np.float64), ((0, 0), (0, pad))).reshape(
        m, walk.splits, q_count, WARPS, TILE_K) for x in xs]
    wk = [np.pad(v.astype(np.float64), ((0, pad), (0, 0))).reshape(
        walk.splits, q_count, WARPS, TILE_K, n) for v in vals]
    with np.errstate(invalid="ignore", over="ignore"):  # NaN and inf go through as on the card
        tiles = [_toward_zero(np.einsum("msqwr,sqwrn->sqwmn", x, v)) for x, v in zip(xk, wk)]
        acc = np.zeros((walk.splits, WARPS, m, n), np.float32)
        for q in range(q_count):  # each warp's tiles in order (int4: low, then high)
            for t in tiles:
                acc = acc + t[:, q]
        part = acc[:, 0]  # the warps in order
        for wi in range(1, WARPS):
            part = part + acc[:, wi]
        total = part[0]  # the slices in order
        for s in range(1, walk.splits):
            total = total + part[s]
        return total * np.asarray(scale, np.float32).reshape(1, n)
