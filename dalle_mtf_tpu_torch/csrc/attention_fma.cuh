// The causal-attention forward on the CUDA cores: every product an fp32 FMA
// from fp32 tiles in shared memory. It is the float32 instantiation of
// causal_attention_fwd.cu (the contract is stated there); bf16 inputs go to
// the tensor-core kernel in that source. It has not been redesigned yet: one
// TF32 product (about three decimal digits) cannot hold the fp32 callers'
// 1e-5, but the three-product split the fp32 backward kernels run
// (attention_tf32.cuh) can, and is the candidate for this kernel too.
//
// Design: one CTA per (b*h, 64-row tile), 256 threads, 4 per tile row, each
// owning 16 of the 64 score columns and D/4 of the output columns; tiles in
// shared memory as fp32 with rows padded by one word, so the 8 rows a warp
// reads at once fall in 8 banks; synchronous element-wise loads; one CTA an
// SM at D = 128 (116 KB of tiles). Bound by the FMA rate fed from shared
// memory, one shared load per FMA. It walks the key tiles of a q tile up to
// the diagonal with an online softmax.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace dalle_attn {
namespace fp32 {

// ---------------------------------------------------------------- forward

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D+1] and the probability tile [64][65], all fp32
  return sizeof(float) * (size_t)(3 * kBlock * (D + 1) + kBlock * (kBlock + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
causal_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, Layout lay, int window,
                            Dropout drop, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kLdP = kBlock + 1;
  constexpr int kColsPerThread = kBlock / 4;
  constexpr int kDimsPerThread = D / 4;

  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlock * kLd;
  float* sv = sk + kBlock * kLd;
  float* sp = sv + kBlock * kLd;

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // deepest tiles first
  const int q0 = q_tile * kBlock;
  const int64_t base = lay.base(bh);
  const uint32_t seed = drop.seed + (uint32_t)bh;  // wrapping, as XLA's int32 add
  const int tid = threadIdx.x;
  const int r = tid >> 2;      // local q row
  const int quad = tid & 3;    // which quarter of the row's columns
  const int row = q0 + r;

  load_tile<T, D>(sq, q, base, lay.stride_r, q0, seq_len);

  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;
  // m starts at NEG_INF (finite): a tile where a row is wholly masked gives
  // p = exp(0) there, and the first unmasked tile's alpha = exp(NEG_INF - m)
  // = 0 wipes it, exactly as the one-shot softmax would never have seen it.
  float m = kNegInf, l = 0.f;

  const int q_last = min(q0 + kBlock, seq_len) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / kBlock, t_end = q_last / kBlock;

  for (int t = t_begin; t <= t_end; ++t) {
    const int c0 = t * kBlock;
    __syncthreads();  // q stored; previous tile's k/v/p reads finished
    load_tile<T, D>(sk, k, base, lay.stride_r, c0, seq_len);
    load_tile<T, D>(sv, v, base, lay.stride_r, c0, seq_len);
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = 0.f;
    const float* qr = sq + r * kLd;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s[j] = fmaf(qv, sk[(quad + 4 * j) * kLd + d], s[j]);
    }

    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = c0 + quad + 4 * j;
      s[j] = is_masked(row, col, window) ? kNegInf : s[j] * scale;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // the 4 threads of a row are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
    float* pr = sp + r * kLdP;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = c0 + quad + 4 * j;
      const float p = expf(s[j] - m_new);
      p_sum += p;  // the normalizer of the UNdropped weights
      float p_v = p;
      if (drop.enabled) p_v = dropout_keep(row, col, seed, drop.threshold) ? p * drop.scale : 0.f;
      pr[quad + 4 * j] = round_to<T>(p_v);
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = l * alpha + p_sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[j] *= alpha;
    __syncwarp();  // a row's p is written and read by the same 4 lanes

    for (int c = 0; c < kBlock; ++c) {
      const float p = pr[c];
      const float* vr = sv + c * kLd;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j)
        acc[j] = fmaf(p, vr[quad + 4 * j], acc[j]);
    }
  }

  if (row < seq_len) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = o + base + (int64_t)row * lay.stride_r;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j)
      orow[quad + 4 * j] = from_float<T>(acc[j] / l_safe);
    if (lse != nullptr && quad == 0) lse[(int64_t)bh * seq_len + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       const Layout& lay, int window, const Dropout& drop,
                       cudaStream_t stream) {
  auto kernel = causal_attention_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lay.batch * lay.heads, (lay.seq_len + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), lay, window, drop,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace fp32
}  // namespace dalle_attn
