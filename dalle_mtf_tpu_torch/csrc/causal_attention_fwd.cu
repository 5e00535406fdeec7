// Causal attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels with one source, by strides:
//   - dalle_mtf_tpu/ops/attention.py::_wedge_fwd_kernel (driven by
//     _wedge_forward), over [B, H, S, D]: the serving path's prefill;
//   - dalle_mtf_tpu/ops/attention_packed.py::_fused_fwd_kernel (driven by
//     _fused_forward), over the packed [B, S, H*D] layout the QKV matmuls
//     produce: every layer's forward on the training path. Head h is the
//     column block [h*D, (h+1)*D) of a row of stride H*D; no transpose exists.
//
// What it computes (the TPU kernels' contract):
//   scores = (q k^T) * D^-0.5 in fp32; masked scores are REPLACED by
//   NEG_INF = -1e10 (causal col > row, and row - col >= window when a local
//   window is given); fp32 softmax; l_safe = max(l, 1e-30);
//   o = (p_v v) / l_safe in the input dtype; optionally lse = m + log(l_safe),
//   fp32 [B*H, S], one per row (the backward reads it).
//   Hash dropout (when enabled): p_v = keep ? p / (1 - rate) : 0 with keep from
//   the counter hash of (query row, key col, seed + b*H + h), the bits of
//   dalle_mtf_tpu/ops/attention.py::_dropout_keep; l and lse come from the
//   undropped p. p_v is rounded to the input dtype before the product with v,
//   where the TPU kernel casts it for the MXU.
//
// Design. One launch covers everything: one CTA per (b*h, 64-row q tile). The
// CTA walks the key tiles from the first one the window can reach up to the
// diagonal tile with an online softmax (running m, l per row), so tiles above
// the diagonal (and, with a window, wholly below the band) are never touched:
// that causal skip is what the TPU's per-q-block "wedge" was for. There is no
// 128-row padding: rows >= S are computed on zero q and never stored, keys
// >= S load as zeros and are masked by the causal test (col >= S > row).
//
// Inner products run in fp32 on the CUDA cores: 256 threads, 4 per q row, each
// thread owning 16 of the 64 score columns and D/4 of the output columns. The
// tiles live in shared memory as fp32 with rows padded by one word, so the 8
// rows a warp reads at once fall in 8 banks.
//
// What bounds it. At the serving prefill shape (B=4, H=8, S=256, D=128) a
// launch yields 128 CTAs, under one wave on the H100's 132 SMs: it is latency
// bound, and the design answers with a single launch, heaviest tiles first
// (blockIdx.y is reversed so diagonal-deep tiles start in the first wave), and
// nothing written but o and lse. At the training shape (B=16, H=8, S=1280,
// D=128: 2560 CTAs, ~54 GFLOP after the causal skip) it is bound by fp32 FMAs
// fed from shared memory, one shared load per FMA. Tensor cores (mma.sync /
// wgmma) and TMA are the remedy; they are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

using namespace dalle_attn;

namespace {

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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
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

}  // namespace

// q, k, v, o share one layout: element (b, h, row, d) lies at
// b*stride_b + h*stride_h + row*stride_r + d. [B, H, S, D] contiguous is
// (H*S*D, S*D, D); packed [B, S, H*D] is (S*H*D, D, H*D).
// dtype: 0 = float32, 1 = bfloat16. window <= 0: no local window. lse may be
// null. dropout != 0 enables the hash dropout (keep when hash >> 8 <
// keep_threshold, kept weights times keep_scale). Returns the cudaError_t of
// the launch (0 on success).
extern "C" int causal_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int batch, int heads, int seq_len,
                                    int head_dim, long long stride_b, long long stride_h,
                                    long long stride_r, int dtype, int window, int dropout,
                                    unsigned int seed, unsigned int keep_threshold,
                                    float keep_scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlock - 1) / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout lay{batch, heads, seq_len, stride_b, stride_h, stride_r};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch<float, 64>(q, k, v, o, lse, lay, window, drop, s);
  if (dtype == 0 && head_dim == 128) return (int)launch<float, 128>(q, k, v, o, lse, lay, window, drop, s);
  if (dtype == 1 && head_dim == 64) return (int)launch<__nv_bfloat16, 64>(q, k, v, o, lse, lay, window, drop, s);
  if (dtype == 1 && head_dim == 128) return (int)launch<__nv_bfloat16, 128>(q, k, v, o, lse, lay, window, drop, s);
  return (int)cudaErrorInvalidValue;
}
