// Causal attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// dalle_mtf_tpu/ops/attention_packed.py::_fused_bwd_kernel (driven by
// _fused_backward): dQ, dK and dV of every layer's attention on the training
// path, over the packed [B, S, H*D] layout (head h = column block
// [h*D, (h+1)*D) of rows of stride H*D). Strided like the forward, so the
// same source takes [B, H, S, D] as well.
//
// What it computes (the TPU kernel's contract), from the forward's fp32 lse
// and dsum = rowsum(dO * O) (one torch reduction outside the kernel):
//   p   = masked ? 0 : exp(q k^T * D^-0.5 - lse)     (masked p is exactly 0)
//   dp  = dO v^T; with hash dropout dp = keep ? dp / (1 - rate) : 0
//   ds  = p * (dp - dsum), rounded to the input dtype
//   dQ  = (ds k) * D^-0.5
//   dV  = p_v^T dO, with p_v = keep ? p / (1 - rate) : 0 rounded to the
//         input dtype
//   dK  = (ds^T q) * D^-0.5
// The dropout bits are the forward's: the hash of (query row, key col,
// seed + b*H + h), also in the transposed dK/dV half.
//
// Design: two launches, no atomics, nothing carried between CTAs.
//   - dQ: one CTA per (b*h, 64-row q tile), walking the key tiles from the
//     window's first up to the diagonal (the forward's causal skip).
//   - dK/dV: one CTA per (b*h, 64-key tile), walking the q tiles from the
//     diagonal down to the last row the window lets see the tile.
// Each recomputes the scores it needs from q, k and lse, so no [S, S] tensor
// exists. Thread layout and tiles as in the forward: 256 threads, 4 per tile
// row, each owning 16 of the 64 columns of a score tile and D/4 of the output
// columns; fp32 tiles in shared memory with rows padded by one word.
//
// What bounds it: at the training shape (B=16, H=8, S=1280, D=128) the pair
// does ~2.5x the forward's FLOPs (five tile products instead of two), all as
// fp32 FMAs on the CUDA cores fed from shared memory. One CTA per SM fits the
// 145-166 KB of tiles. Tensor cores (mma.sync / wgmma) and TMA are the remedy;
// they are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

using namespace dalle_attn;

namespace {

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
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
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

}  // namespace

// q, k, v, dout, dq, dk, dv share one layout (see causal_attention_fwd); lse
// and dsum are fp32 [batch*heads, seq_len]. Other arguments as in
// causal_attention_fwd. Returns the first cudaError_t of the two launches.
extern "C" int causal_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* dsum,
                                    void* dq, void* dk, void* dv, int batch, int heads,
                                    int seq_len, int head_dim, long long stride_b,
                                    long long stride_h, long long stride_r, int dtype,
                                    int window, int dropout, unsigned int seed,
                                    unsigned int keep_threshold, float keep_scale,
                                    void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlock - 1) / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout lay{batch, heads, seq_len, stride_b, stride_h, stride_r};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DALLE_BWD(T, D) \
  launch<T, D>(q, k, v, dout, lse, dsum, dq, dk, dv, lay, window, drop, s)
  if (dtype == 0 && head_dim == 64) return (int)DALLE_BWD(float, 64);
  if (dtype == 0 && head_dim == 128) return (int)DALLE_BWD(float, 128);
  if (dtype == 1 && head_dim == 64) return (int)DALLE_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) return (int)DALLE_BWD(__nv_bfloat16, 128);
#undef DALLE_BWD
  return (int)cudaErrorInvalidValue;
}
