// Pieces shared by the causal-attention forward and backward kernels: the
// tile geometry, the strided layout, the mask, the dropout hash and the dtype
// conversions. Everything here is inline, so each .cu file can include it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dalle_attn {

constexpr int kBlock = 64;     // rows of a q tile, and keys of a key tile
constexpr int kThreads = 256;  // 4 threads per tile row
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
  uint32_t seed;       // the caller's seed; each program adds its bh
  uint32_t threshold;  // keep when hash >> 8 < threshold (24-bit fixed point)
  float scale;         // 1 / (1 - rate)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: where the TPU kernels cast an operand to the
// input dtype before a matmul.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

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

// Rows [r0, r0 + 64) of one (b, h) head into a [64][D+1] fp32 tile; rows at or
// beyond seq_len load as zeros. All kThreads threads take part.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t base, long long stride_r, int r0,
                                          int seq_len) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int gr = r0 + rr;
    dst[rr * (D + 1) + dd] =
        gr < seq_len ? to_float(src[base + (int64_t)gr * stride_r + dd]) : 0.f;
  }
}

}  // namespace dalle_attn
