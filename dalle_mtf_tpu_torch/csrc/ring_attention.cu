// Ring attention's per-hop kernels for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of dalle_mtf_tpu/ops/ring_attention.py:
//   - _ring_fwd_kernel (driven by _ring_partial): ring_partial, the partial
//     softmax triple of one visiting k/v shard against the local q shard;
//   - _ring_bwd_kernel (driven by _ring_block_grads): ring_block_grads, that
//     hop's dq, and dk, dv added into the rotating fp32 accumulators.
//
// Coordinates are global: the local q row r is global row0 + r, the visiting
// key c is global col0 + c, and diff = row0 - col0. A score is masked where
// (c - r) > diff (causal), where (r - c) + diff >= window (local window, when
// window > 0), and where c >= Sk (the ragged last key tile). Hash dropout
// keys on (row0 + r, col0 + c, seed + bh), the bits of
// dalle_mtf_tpu/ops/attention.py::_dropout_keep, the same in both kernels.
//
// ring_partial: num = sum_c exp(s - m) p_v v (unnormalised, fp32), m the row
// max of the masked scores, l = sum_c exp(s - m) over the UNdropped weights;
// one value per row (the TPU kernel replicated m and l over 128 lanes). p_v
// is rounded to the input dtype before the product with v, where the TPU
// kernel casts it for the MXU. One CTA per (b*h, 64-row q tile) runs an
// online softmax over only the key tiles that hold a live key for one of its
// rows: [q0 + diff - window + 1, q_last + diff], clamped to [0, Sk). A row
// with no live key in this hop (only under a window) is written m = NEG_INF,
// l = the count of its visited keys and num = their sum of v (all keys, when
// no tile is visited: l = 0, num = 0); the fold's beta = exp(NEG_INF - m) = 0
// discards it, since every row's diagonal hop is live and folds first.
//
// ring_block_grads, from the forward's fp32 lse and dsum = rowsum(dO * O):
//   p = masked ? 0 : exp(s * D^-0.5 - lse); dp = dO v^T (dropout-masked and
//   scaled); ds = p (dp - dsum) rounded to the input dtype;
//   dq = ds k * D^-0.5 in the input dtype; dk += ds^T q * D^-0.5 and
//   dv += p_v^T dO in fp32, p_v rounded to the input dtype.
// Two launches, no atomics: dQ, one CTA per (b*h, q tile) over the live key
// tiles; dK/dV, one CTA per (b*h, key tile) over the q tiles that can see it,
// [c0 - diff, k_last - diff + window - 1]. A dK/dV CTA owns its key rows, so
// it adds into dk_acc and dv_acc in place and no other CTA writes there.
//
// What bounds it: at the ring slice's shapes (B*H = 32, Sq = Sk = 1088,
// D = 128, bf16) a past hop is 2 products over 1088^2 pairs a head (19.4
// GFLOP forward, 48.5 backward: operation-bound, 0.020 / 0.049 ms at the
// tensor cores' 989 TFLOP/s). Like the causal pair this builds on
// (causal_attention_fwd.cu, causal_attention_bwd.cu), it runs fp32 FMAs on
// the CUDA cores fed from shared memory, 256 threads with 4 per tile row.
// Tensor cores (mma.sync / wgmma) and TMA are the remedy; they are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

using namespace dalle_attn;

namespace {

constexpr int kLdP = kBlock + 1;
constexpr int kColsPerThread = kBlock / 4;

// The global hop: local sizes, the offsets and the window.
struct Hop {
  int s_q, s_k;
  int diff, row0, col0, window;
  __device__ __forceinline__ bool masked(int r, int c) const {
    return c >= s_k || r >= s_q || c - r > diff || (window > 0 && (r - c) + diff >= window);
  }
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (size_t)(3 * kBlock * (D + 1) + kBlock * kLdP);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBlock * (D + 1) + kBlock * kLdP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBlock * (D + 1) + 2 * kBlock * kLdP + 2 * kBlock);
}

// Key tiles [*t_begin, *t_end] holding a live key for local rows [q0, q_last].
__device__ __forceinline__ void key_tiles(const Hop& hop, int q0, int q_last, int* t_begin,
                                          int* t_end) {
  const int c_hi = min(hop.s_k - 1, q_last + hop.diff);
  const int c_lo = hop.window > 0 ? max(0, q0 + hop.diff - hop.window + 1) : 0;
  *t_begin = c_lo / kBlock;
  *t_end = c_hi < c_lo ? *t_begin - 1 : c_hi / kBlock;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ring_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ num,
                    float* __restrict__ m_out, float* __restrict__ l_out, Hop hop,
                    Dropout drop, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDimsPerThread = D / 4;

  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlock * kLd;
  float* sv = sk + kBlock * kLd;
  float* sp = sv + kBlock * kLd;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const uint32_t seed = drop.seed + (uint32_t)bh;  // wrapping, as XLA's int32 add
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int quad = tid & 3;
  const int row = q0 + r;

  load_tile<T, D>(sq, q, q_base, D, q0, hop.s_q);

  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  int t_begin, t_end;
  key_tiles(hop, q0, min(q0 + kBlock, hop.s_q) - 1, &t_begin, &t_end);

  for (int t = t_begin; t <= t_end; ++t) {
    const int c0 = t * kBlock;
    __syncthreads();  // q stored; previous tile's k/v/p reads finished
    load_tile<T, D>(sk, k, k_base, D, c0, hop.s_k);
    load_tile<T, D>(sv, v, k_base, D, c0, hop.s_k);
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
      s[j] = hop.masked(row, col) ? kNegInf : s[j] * scale;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
    float* pr = sp + r * kLdP;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = c0 + quad + 4 * j;
      // a key beyond Sk is no key at all: it adds nothing to l
      const float p = col < hop.s_k ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      float p_v = p;
      if (drop.enabled)
        p_v = dropout_keep(hop.row0 + row, hop.col0 + col, seed, drop.threshold) ? p * drop.scale
                                                                                  : 0.f;
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
      for (int j = 0; j < kDimsPerThread; ++j) acc[j] = fmaf(p, vr[quad + 4 * j], acc[j]);
    }
  }

  if (row < hop.s_q) {
    float* nrow = num + q_base + (int64_t)row * D;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) nrow[quad + 4 * j] = acc[j];
    if (quad == 0) {
      m_out[(int64_t)bh * hop.s_q + row] = m;
      l_out[(int64_t)bh * hop.s_q + row] = l;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ring_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ dsum, T* __restrict__ dq, Hop hop, Dropout drop,
               float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDimsPerThread = D / 4;

  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBlock * kLd;
  float* sk = sdo + kBlock * kLd;
  float* sv = sk + kBlock * kLd;
  float* sds = sv + kBlock * kLd;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const uint32_t seed = drop.seed + (uint32_t)bh;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int quad = tid & 3;
  const int row = q0 + r;

  load_tile<T, D>(sq, q, q_base, D, q0, hop.s_q);
  load_tile<T, D>(sdo, dout, q_base, D, q0, hop.s_q);
  const int64_t row_base = (int64_t)bh * hop.s_q;
  const float lse_r = row < hop.s_q ? lse[row_base + row] : 0.f;
  const float dsum_r = row < hop.s_q ? dsum[row_base + row] : 0.f;

  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;

  int t_begin, t_end;
  key_tiles(hop, q0, min(q0 + kBlock, hop.s_q) - 1, &t_begin, &t_end);

  for (int t = t_begin; t <= t_end; ++t) {
    const int c0 = t * kBlock;
    __syncthreads();
    load_tile<T, D>(sk, k, k_base, D, c0, hop.s_k);
    load_tile<T, D>(sv, v, k_base, D, c0, hop.s_k);
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
      const float p = hop.masked(row, col) ? 0.f : expf(s[j] * scale - lse_r);
      float dpj = dp[j];
      if (drop.enabled)
        dpj = dropout_keep(hop.row0 + row, hop.col0 + col, seed, drop.threshold) ? dpj * drop.scale
                                                                                  : 0.f;
      dsr[quad + 4 * j] = round_to<T>(p * (dpj - dsum_r));
    }
    __syncwarp();

    for (int c = 0; c < kBlock; ++c) {
      const float dsv = dsr[c];
      const float* kr = sk + c * kLd;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) acc[j] = fmaf(dsv, kr[quad + 4 * j], acc[j]);
    }
  }

  if (row < hop.s_q) {
    T* out = dq + q_base + (int64_t)row * D;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) out[quad + 4 * j] = from_float<T>(acc[j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ring_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dsum, float* __restrict__ dk_acc,
                float* __restrict__ dv_acc, Hop hop, Dropout drop, float scale) {
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

  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kBlock;
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const int64_t row_base = (int64_t)bh * hop.s_q;
  const uint32_t seed = drop.seed + (uint32_t)bh;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // local key row
  const int quad = tid & 3;
  const int krow = c0 + r;

  // q rows that can see one of keys [c0, k_last]: r >= c - diff, and under a
  // window r <= c - diff + window - 1
  const int k_last = min(c0 + kBlock, hop.s_k) - 1;
  const int r_lo = max(0, c0 - hop.diff);
  const int r_hi = hop.window > 0 ? min(hop.s_q - 1, k_last - hop.diff + hop.window - 1)
                                  : hop.s_q - 1;
  if (r_hi < r_lo) return;  // nothing to add: the accumulators keep their values

  load_tile<T, D>(sk, k, k_base, D, c0, hop.s_k);
  load_tile<T, D>(sv, v, k_base, D, c0, hop.s_k);

  float dk[kDimsPerThread], dv[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) dk[j] = dv[j] = 0.f;

  for (int t = r_lo / kBlock; t <= r_hi / kBlock; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();
    load_tile<T, D>(sq, q, q_base, D, q0, hop.s_q);
    load_tile<T, D>(sdo, dout, q_base, D, q0, hop.s_q);
    load_rows(slse, lse, row_base, q0, hop.s_q);
    load_rows(sdsum, dsum, row_base, q0, hop.s_q);
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
      const float p = hop.masked(qrow, krow) ? 0.f : expf(s[j] * scale - slse[qc]);
      float p_v = p, dpj = dp[j];
      if (drop.enabled) {
        // the transposed tile of the forward's mask: hash(query, key)
        const bool keep = dropout_keep(hop.row0 + qrow, hop.col0 + krow, seed, drop.threshold);
        p_v = keep ? p * drop.scale : 0.f;
        dpj = keep ? dpj * drop.scale : 0.f;
      }
      pr[qc] = round_to<T>(p_v);
      dsr[qc] = round_to<T>(p * (dpj - sdsum[qc]));
    }
    __syncwarp();

    for (int c = 0; c < kBlock; ++c) {
      const float pv = pr[c], dsv = dsr[c];
      const float* gq = sdo + c * kLd;
      const float* qq = sq + c * kLd;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) {
        dv[j] = fmaf(pv, gq[quad + 4 * j], dv[j]);
        dk[j] = fmaf(dsv, qq[quad + 4 * j], dk[j]);
      }
    }
  }

  if (krow < hop.s_k) {
    const int64_t off = k_base + (int64_t)krow * D;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) {
      dk_acc[off + quad + 4 * j] += dk[j] * scale;
      dv_acc[off + quad + 4 * j] += dv[j];
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_partial(const void* q, const void* k, const void* v, void* num, void* m,
                           void* l, int bh, const Hop& hop, const Dropout& drop,
                           cudaStream_t stream) {
  auto kernel = ring_partial_kernel<T, D>;
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (hop.s_q + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(num), static_cast<float*>(m), static_cast<float*>(l), hop, drop,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_grads(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dsum, void* dq, void* dk_acc,
                         void* dv_acc, int bh, const Hop& hop, const Dropout& drop,
                         cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdsum = static_cast<const float*>(dsum);

  auto dq_kernel = ring_dq_kernel<T, D>;
  cudaError_t err = set_smem(dq_kernel, dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(bh, (hop.s_q + kBlock - 1) / kBlock), kThreads, dq_smem_bytes<D>(),
              stream>>>(tq, tk, tv, tdo, flse, fdsum, static_cast<T*>(dq), hop, drop, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = ring_dkv_kernel<T, D>;
  err = set_smem(dkv_kernel, dkv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(bh, (hop.s_k + kBlock - 1) / kBlock), kThreads, dkv_smem_bytes<D>(),
               stream>>>(tq, tk, tv, tdo, flse, fdsum, static_cast<float*>(dk_acc),
                         static_cast<float*>(dv_acc), hop, drop, scale);
  return cudaGetLastError();
}

bool bad_shape(int bh, int s_q, int s_k) {
  return bh <= 0 || s_q <= 0 || s_k <= 0 || (s_q + kBlock - 1) / kBlock > 65535 ||
         (s_k + kBlock - 1) / kBlock > 65535;
}

}  // namespace

// q [bh, s_q, head_dim], k and v [bh, s_k, head_dim], contiguous, of one
// dtype (0 = float32, 1 = bfloat16). Writes num fp32 [bh, s_q, head_dim] and
// m, l fp32 [bh, s_q]. diff = row0 - col0; window <= 0: no local window.
// dropout != 0 enables the hash dropout (keep when hash >> 8 <
// keep_threshold, kept weights times keep_scale; program bh adds bh to the
// seed). Returns the cudaError_t of the launch (0 on success).
extern "C" int ring_partial(const void* q, const void* k, const void* v, void* num, void* m,
                            void* l, int bh, int s_q, int s_k, int head_dim, int dtype,
                            int diff, int row0, int col0, int window, int dropout,
                            unsigned int seed, unsigned int keep_threshold, float keep_scale,
                            void* stream) {
  if (bad_shape(bh, s_q, s_k)) return (int)cudaErrorInvalidValue;
  const Hop hop{s_q, s_k, diff, row0, col0, window};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DALLE_RING_FWD(T, D) launch_partial<T, D>(q, k, v, num, m, l, bh, hop, drop, s)
  if (dtype == 0 && head_dim == 64) return (int)DALLE_RING_FWD(float, 64);
  if (dtype == 0 && head_dim == 128) return (int)DALLE_RING_FWD(float, 128);
  if (dtype == 1 && head_dim == 64) return (int)DALLE_RING_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) return (int)DALLE_RING_FWD(__nv_bfloat16, 128);
#undef DALLE_RING_FWD
  return (int)cudaErrorInvalidValue;
}

// q, dout [bh, s_q, head_dim], k, v [bh, s_k, head_dim] of one dtype; lse
// and dsum fp32 [bh, s_q]; writes dq [bh, s_q, head_dim] in the input dtype
// and ADDS into dk_acc, dv_acc fp32 [bh, s_k, head_dim]. Other arguments as
// in ring_partial. Returns the first cudaError_t of the two launches.
extern "C" int ring_block_grads(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* dsum,
                                void* dq, void* dk_acc, void* dv_acc, int bh, int s_q,
                                int s_k, int head_dim, int dtype, int diff, int row0,
                                int col0, int window, int dropout, unsigned int seed,
                                unsigned int keep_threshold, float keep_scale, void* stream) {
  if (bad_shape(bh, s_q, s_k)) return (int)cudaErrorInvalidValue;
  const Hop hop{s_q, s_k, diff, row0, col0, window};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DALLE_RING_BWD(T, D) \
  launch_grads<T, D>(q, k, v, dout, lse, dsum, dq, dk_acc, dv_acc, bh, hop, drop, s)
  if (dtype == 0 && head_dim == 64) return (int)DALLE_RING_BWD(float, 64);
  if (dtype == 0 && head_dim == 128) return (int)DALLE_RING_BWD(float, 128);
  if (dtype == 1 && head_dim == 64) return (int)DALLE_RING_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) return (int)DALLE_RING_BWD(__nv_bfloat16, 128);
#undef DALLE_RING_BWD
  return (int)cudaErrorInvalidValue;
}
