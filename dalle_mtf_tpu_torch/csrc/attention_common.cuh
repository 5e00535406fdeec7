// Pieces shared by the attention kernels: the tile geometry, the strided
// layout, the mask and the dropout hash. Everything here is inline, so each
// .cu file can include it.

#pragma once

#include <stdint.h>

namespace dalle_attn {

constexpr int kBlock = 64;  // rows of a q tile, and keys of a key tile
constexpr float kNegInf = -1e10f;

// Where (b, h, row, d) lies: b*stride_b + h*stride_h + row*stride_r + d. The
// flat program index is bh = b*heads + h, as in the TPU kernels' grid.
struct Layout {
  int batch, heads, seq_len;
  long long stride_b, stride_h, stride_r;
  __device__ __forceinline__ int64_t base(int bh) const {
    return (int64_t)(bh / heads) * stride_b + (int64_t)(bh % heads) * stride_h;
  }
};

struct Dropout {
  bool enabled;
  uint32_t seed;       // the caller's seed; each program adds its index
  uint32_t threshold;  // keep when hash >> 8 < threshold (24-bit fixed point)
  float scale;         // 1 / (1 - rate)
  // The launch's heads are heads [head0, head0 + heads) of heads_total (a
  // tensor-parallel rank's block): program bh hashes with the index it has
  // in one launch over every head, (bh / heads) * heads_total + head0 +
  // bh % heads. heads_total = heads and head0 = 0 give bh itself. The causal
  // and the ring kernels all hash with it.
  int heads_total;
  int head0;
  // seed + that index, wrapping, as XLA's int32 add
  __device__ __forceinline__ uint32_t program_seed(int bh, int heads) const {
    return seed + (uint32_t)((bh / heads) * heads_total + head0 + bh % heads);
  }
};

// causal (col > row) or outside the local window (row - col >= window)
__device__ __forceinline__ bool is_masked(int row, int col, int window) {
  return col > row || (window > 0 && row - col >= window);
}

// dalle_mtf_tpu/ops/attention.py::_dropout_keep, bit for bit: wrapping uint32
// arithmetic on (query row, key col, seed + bh).
__device__ __forceinline__ bool dropout_keep(int row, int col, uint32_t seed,
                                             uint32_t threshold) {
  uint32_t x = (uint32_t)row * 2654435761u + (uint32_t)col * 97929647u + seed;
  x ^= x >> 13;
  x *= 0x5BD1E995u;
  x ^= x >> 15;
  x *= 0x27D4EB2Fu;
  x ^= x >> 16;
  return (x >> 8) < threshold;
}

}  // namespace dalle_attn
