// Causal attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel dalle_mtf_tpu/ops/attention.py::_wedge_fwd_kernel
// (driven by _wedge_forward), the one kernel on the serving path: prefill runs
// every layer's attention over the text prompt through it.
//
// What it computes (exactly _wedge_forward's contract):
//   q, k, v [BH, S, D] (contiguous [B, H, S, D]), bf16 or fp32, D in {64, 128};
//   scores = (q k^T) * D^-0.5 in fp32; masked scores are REPLACED by
//   NEG_INF = -1e10 (causal col > row, and row - col >= window when a local
//   window is given); fp32 softmax; l_safe = max(l, 1e-30);
//   o = (p v) / l_safe in the input dtype; optionally lse = m + log(l_safe),
//   fp32 [BH, S].
//
// Design. One launch covers everything: one CTA per (b*h, 64-row q tile). The
// CTA walks the key tiles from the first one the window can reach up to the
// diagonal tile with an online softmax (running m, l per row), so tiles above
// the diagonal (and, with a window, wholly below the band) are never touched:
// that causal skip is what the TPU's per-q-block "wedge" of calls was for.
// There is no 128-row padding: rows >= S are computed on zero q and never
// stored, keys >= S load as zeros and are masked by the causal test
// (col >= S > row). lse is one fp32 per row, not lane-replicated.
//
// Inner products run in fp32 on the CUDA cores: 256 threads, 4 per q row, each
// thread owning 16 of the 64 score columns and D/4 of the output columns. The
// tiles live in shared memory as fp32 with rows padded by one word, so the 8
// rows a warp reads at once fall in 8 banks.
//
// What bounds it at the serving prefill shape (B=4, H=8, S=256, D=128): the
// whole problem is 32 heads x 256 rows, about 0.1 GFLOP after the causal skip,
// and a launch yields only 32 x 4 = 128 CTAs, under one per SM on the H100's
// 132. It is a small, latency-bound launch: the time is the launch, one wave
// of CTAs and each CTA's serial walk over at most 4 key tiles, not FLOPs or
// bytes. The design answers with a single launch (no per-q-block calls and no
// padding copies around it), heaviest tiles scheduled first (blockIdx.y is
// reversed so the diagonal-deep tiles start in the first wave), and nothing
// written but o and lse. Tensor cores (mma.sync / wgmma) and TMA would speed
// the inner products and matter at long S; they are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;   // q rows per CTA
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 256;  // 4 threads per q row
constexpr float kNegInf = -1e10f;

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

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D+1] and the probability tile [64][65], all fp32
  return sizeof(float) * (size_t)(3 * kBlockM * (D + 1) + kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
causal_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, int seq_len, int window,
                            float scale) {
  constexpr int kLd = D + 1;
  constexpr int kLdP = kBlockN + 1;
  constexpr int kColsPerThread = kBlockN / 4;
  constexpr int kDimsPerThread = D / 4;

  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlockM * kLd;
  float* sv = sk + kBlockN * kLd;
  float* sp = sv + kBlockN * kLd;

  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // deepest tiles first
  const int q0 = q_tile * kBlockM;
  const size_t base = (size_t)bh * seq_len * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;      // local q row
  const int quad = tid & 3;    // which quarter of the row's columns
  const int row = q0 + r;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int gr = q0 + rr;
    sq[rr * kLd + dd] = gr < seq_len ? to_float(q[base + (size_t)gr * D + dd]) : 0.f;
  }

  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;
  // m starts at NEG_INF (finite): a tile where a row is wholly masked gives
  // p = exp(0) there, and the first unmasked tile's alpha = exp(NEG_INF - m)
  // = 0 wipes it, exactly as the one-shot softmax would never have seen it.
  float m = kNegInf, l = 0.f;

  const int q_last = min(q0 + kBlockM, seq_len) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / kBlockN, t_end = q_last / kBlockN;

  for (int t = t_begin; t <= t_end; ++t) {
    const int c0 = t * kBlockN;
    __syncthreads();  // q stored; previous tile's k/v/p reads finished
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int cc = i / D, dd = i % D;
      const int gc = c0 + cc;
      const bool ok = gc < seq_len;
      const size_t off = base + (size_t)gc * D + dd;
      sk[cc * kLd + dd] = ok ? to_float(k[off]) : 0.f;
      sv[cc * kLd + dd] = ok ? to_float(v[off]) : 0.f;
    }
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
      const bool masked = col > row || (window > 0 && row - col >= window);
      s[j] = masked ? kNegInf : s[j] * scale;
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
      const float p = expf(s[j] - m_new);
      p_sum += p;
      pr[quad + 4 * j] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = l * alpha + p_sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[j] *= alpha;
    __syncwarp();  // a row's p is written and read by the same 4 lanes

    for (int c = 0; c < kBlockN; ++c) {
      const float p = pr[c];
      const float* vr = sv + c * kLd;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j)
        acc[j] = fmaf(p, vr[quad + 4 * j], acc[j]);
    }
  }

  if (row < seq_len) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = o + base + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j)
      orow[quad + 4 * j] = from_float<T>(acc[j] / l_safe);
    if (lse != nullptr && quad == 0) lse[(size_t)bh * seq_len + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int bh, int seq_len, int window, cudaStream_t stream) {
  auto kernel = causal_attention_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_len + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq_len, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no local window. lse may be
// null. Returns the cudaError_t of the launch (0 on success).
extern "C" int causal_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int bh, int seq_len, int head_dim,
                                    int dtype, int window, void* stream) {
  if (bh <= 0 || seq_len <= 0 || (seq_len + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch<float, 64>(q, k, v, o, lse, bh, seq_len, window, s);
  if (dtype == 0 && head_dim == 128) return (int)launch<float, 128>(q, k, v, o, lse, bh, seq_len, window, s);
  if (dtype == 1 && head_dim == 64) return (int)launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, seq_len, window, s);
  if (dtype == 1 && head_dim == 128) return (int)launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, seq_len, window, s);
  return (int)cudaErrorInvalidValue;
}
