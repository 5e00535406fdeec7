// The causal-attention kernels on the CUDA cores: every product an fp32 FMA
// from fp32 tiles in shared memory. They are the float32 instantiation of
// causal_attention_fwd.cu and causal_attention_bwd.cu (the contract is stated
// there): the tensor cores take fp32 only as TF32, about three decimal digits,
// which cannot hold the 1e-5 agreement the fp32 callers are checked to. bf16
// inputs go to the tensor-core kernels in those two sources instead.
//
// Design: one CTA per (b*h, 64-row tile), 256 threads, 4 per tile row, each
// owning 16 of the 64 score columns and D/4 of the output columns; tiles in
// shared memory as fp32 with rows padded by one word, so the 8 rows a warp
// reads at once fall in 8 banks; synchronous element-wise loads; one CTA an
// SM (145-166 KB of tiles). Bound by the FMA rate fed from shared memory, one
// shared load per FMA. The forward walks the key tiles of a q tile up to the
// diagonal with an online softmax; the backward is a dQ launch (same walk) and
// a dK/dV launch (a key tile walks the q tiles from the diagonal down), no
// atomics.

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

// --------------------------------------------------------------- backward

constexpr int kLdP = kBlock + 1;
constexpr int kColsPerThread = kBlock / 4;

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles [64][D+1] and the ds tile [64][65], fp32
  return sizeof(float) * (size_t)(4 * kBlock * (D + 1) + kBlock * kLdP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles [64][D+1], the p_v and ds tiles [64][65], lse and dsum
  return sizeof(float) * (size_t)(4 * kBlock * (D + 1) + 2 * kBlock * kLdP + 2 * kBlock);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        T* __restrict__ dq, Layout lay, int window, Dropout drop,
                        float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDimsPerThread = D / 4;

  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBlock * kLd;
  float* sk = sdo + kBlock * kLd;
  float* sv = sk + kBlock * kLd;
  float* sds = sv + kBlock * kLd;

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // deepest tiles first
  const int q0 = q_tile * kBlock;
  const int64_t base = lay.base(bh);
  const uint32_t seed = drop.seed + (uint32_t)bh;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int quad = tid & 3;
  const int row = q0 + r;

  load_tile<T, D>(sq, q, base, lay.stride_r, q0, seq_len);
  load_tile<T, D>(sdo, dout, base, lay.stride_r, q0, seq_len);
  const int64_t row_base = (int64_t)bh * seq_len;
  const float lse_r = row < seq_len ? lse[row_base + row] : 0.f;
  const float dsum_r = row < seq_len ? dsum[row_base + row] : 0.f;

  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;

  const int q_last = min(q0 + kBlock, seq_len) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / kBlock, t_end = q_last / kBlock;

  for (int t = t_begin; t <= t_end; ++t) {
    const int c0 = t * kBlock;
    __syncthreads();  // q/dO stored; previous tile's k/v/ds reads finished
    load_tile<T, D>(sk, k, base, lay.stride_r, c0, seq_len);
    load_tile<T, D>(sv, v, base, lay.stride_r, c0, seq_len);
    __syncthreads();

    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = dp[j] = 0.f;
    const float* qr = sq + r * kLd;
    const float* gr = sdo + r * kLd;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d], gv = gr[d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int off = (quad + 4 * j) * kLd + d;
        s[j] = fmaf(qv, sk[off], s[j]);
        dp[j] = fmaf(gv, sv[off], dp[j]);
      }
    }

    float* dsr = sds + r * kLdP;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = c0 + quad + 4 * j;
      const float p = is_masked(row, col, window) ? 0.f : expf(s[j] * scale - lse_r);
      float dpj = dp[j];
      if (drop.enabled) dpj = dropout_keep(row, col, seed, drop.threshold) ? dpj * drop.scale : 0.f;
      dsr[quad + 4 * j] = round_to<T>(p * (dpj - dsum_r));
    }
    __syncwarp();  // a row's ds is written and read by the same 4 lanes

    for (int c = 0; c < kBlock; ++c) {
      const float dsv = dsr[c];
      const float* kr = sk + c * kLd;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j)
        acc[j] = fmaf(dsv, kr[quad + 4 * j], acc[j]);
    }
  }

  if (row < seq_len) {
    T* out = dq + base + (int64_t)row * lay.stride_r;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) out[quad + 4 * j] = from_float<T>(acc[j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         T* __restrict__ dk, T* __restrict__ dv, Layout lay, int window,
                         Dropout drop, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDimsPerThread = D / 4;

  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kBlock * kLd;
  float* sq = sv + kBlock * kLd;
  float* sdo = sq + kBlock * kLd;
  float* sp = sdo + kBlock * kLd;
  float* sds = sp + kBlock * kLdP;
  float* slse = sds + kBlock * kLdP;
  float* sdsum = slse + kBlock;

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int k_tile = blockIdx.y;  // key tile 0 sees every q tile: heaviest first
  const int c0 = k_tile * kBlock;
  const int64_t base = lay.base(bh);
  const int64_t row_base = (int64_t)bh * seq_len;
  const uint32_t seed = drop.seed + (uint32_t)bh;
  const int tid = threadIdx.x;
  const int r = tid >> 2;      // local key row
  const int quad = tid & 3;
  const int krow = c0 + r;

  load_tile<T, D>(sk, k, base, lay.stride_r, c0, seq_len);
  load_tile<T, D>(sv, v, base, lay.stride_r, c0, seq_len);

  float dk_acc[kDimsPerThread], dv_acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int k_last = min(c0 + kBlock, seq_len) - 1;
  const int q_last = window > 0 ? min(seq_len - 1, k_last + window - 1) : seq_len - 1;
  const int t_end = q_last / kBlock;

  for (int t = k_tile; t <= t_end; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();  // k/v stored; previous tile's q/dO/p/ds reads finished
    load_tile<T, D>(sq, q, base, lay.stride_r, q0, seq_len);
    load_tile<T, D>(sdo, dout, base, lay.stride_r, q0, seq_len);
    load_rows(slse, lse, row_base, q0, seq_len);
    load_rows(sdsum, dsum, row_base, q0, seq_len);
    __syncthreads();

    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = dp[j] = 0.f;
    const float* kr = sk + r * kLd;
    const float* vr = sv + r * kLd;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d], vv = vr[d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int off = (quad + 4 * j) * kLd + d;
        s[j] = fmaf(kv, sq[off], s[j]);
        dp[j] = fmaf(vv, sdo[off], dp[j]);
      }
    }

    float* pr = sp + r * kLdP;
    float* dsr = sds + r * kLdP;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int qc = quad + 4 * j;
      const int qrow = q0 + qc;
      const bool masked = qrow >= seq_len || is_masked(qrow, krow, window);
      const float p = masked ? 0.f : expf(s[j] * scale - slse[qc]);
      float p_v = p, dpj = dp[j];
      if (drop.enabled) {
        // the transposed tile of the forward's mask: hash(query, key)
        const bool keep = dropout_keep(qrow, krow, seed, drop.threshold);
        p_v = keep ? p * drop.scale : 0.f;
        dpj = keep ? dpj * drop.scale : 0.f;
      }
      pr[qc] = round_to<T>(p_v);
      dsr[qc] = round_to<T>(p * (dpj - sdsum[qc]));
    }
    __syncwarp();  // a key row's p_v and ds are written and read by the same 4 lanes

    for (int c = 0; c < kBlock; ++c) {
      const float pv = pr[c], dsv = dsr[c];
      const float* gq = sdo + c * kLd;
      const float* qq = sq + c * kLd;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) {
        dv_acc[j] = fmaf(pv, gq[quad + 4 * j], dv_acc[j]);
        dk_acc[j] = fmaf(dsv, qq[quad + 4 * j], dk_acc[j]);
      }
    }
  }

  if (krow < seq_len) {
    const int64_t off = base + (int64_t)krow * lay.stride_r;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) {
      dk[off + quad + 4 * j] = from_float<T>(dk_acc[j] * scale);
      dv[off + quad + 4 * j] = from_float<T>(dv_acc[j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dsum, void* dq, void* dk, void* dv,
                       const Layout& lay, int window, const Dropout& drop,
                       cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid(lay.batch * lay.heads, (lay.seq_len + kBlock - 1) / kBlock);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdsum = static_cast<const float*>(dsum);

  auto dq_kernel = attention_bwd_dq_kernel<T, D>;
  constexpr size_t dq_smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<T*>(dq), lay, window, drop, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = attention_bwd_dkv_kernel<T, D>;
  constexpr size_t dkv_smem = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThreads, dkv_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<T*>(dk), static_cast<T*>(dv), lay,
      window, drop, scale);
  return cudaGetLastError();
}

}  // namespace fp32
}  // namespace dalle_attn
