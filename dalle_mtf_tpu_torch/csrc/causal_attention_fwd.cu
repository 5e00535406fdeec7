// Causal attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU forward kernels with one source, by strides:
//   - dalle_mtf_tpu/ops/attention_packed.py::_fused_fwd_kernel, over the
//     packed [B, S, H*D] layout the QKV matmuls produce: every layer's forward
//     on the training path. Head h is the column block [h*D, (h+1)*D) of a row
//     of stride H*D; no transpose exists;
//   - dalle_mtf_tpu/ops/attention.py::_wedge_fwd_kernel, _wr_fwd_kernel and
//     _flash_kernel, over [B, H, S, D]: the serving prefill, unpacked and
//     long-sequence training. The TPU's three families existed for its fast
//     memory's size; one tiled kernel covers every length here.
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
// Two instantiations behind the one entry point:
//   - float32: the FMA kernel of attention_fma.cuh, unchanged (the tensor
//     cores' TF32 cannot hold the fp32 callers' 1e-5);
//   - bfloat16: the tensor-core kernel below.
//
// The bf16 design. One CTA of 4 warps per (b*h, q tile); a warp owns one or
// two blocks of 16 q rows, so the q tile has 64 or 128 rows: 128 at D = 128
// when those tiles still give every SM a CTA (each B fragment read from
// shared memory then feeds four products, 18-21% faster at S = 1280 and
// 4352), else 64: the serving prefill (B=4, H=8, S=256) stays at 128 CTAs of
// 64 rows (attention_mma.cuh::forward_tile_rows).
// The CTA walks the 64-key tiles from the first the window can reach up to
// the diagonal, deepest q tiles first (blockIdx.y reversed), with an online
// softmax whose running max starts at the finite NEG_INF: a tile where a row
// is wholly masked gives p = 1 there, and the first live tile's
// alpha = exp(NEG_INF - m) = 0 wipes it.
//   - Tiles: q, k, v as bf16 in shared memory under the 128-byte XOR swizzle
//     (attention_mma.cuh), 16 KB a 64 x 128 tile; K and V double-buffered.
//   - Copies: cp.async.cg, 16 bytes a thread, zero-filled for rows >= S;
//     tile t + 1 is in flight while tile t is multiplied, one __syncthreads a
//     tile. TMA is not used: its descriptor is made by
//     cuTensorMapEncodeTiled, which a library with a plain C interface does
//     not link, and cp.async already hides the loads.
//   - Products: mma.sync.m16n8k16 with ldmatrix, fp32 accumulators in
//     registers. wgmma was the other candidate; mma.sync was taken because
//     its fragment layouts let the score tile stay in registers as the next
//     product's A operand with no descriptor for the transposed V operand,
//     and a 16-row warp tile keeps the q tile choice (64 or 128 rows) free.
//   - Softmax on the accumulator fragment: a row lives in the 4 lanes of a
//     quad, its max and sum are two shuffles; exp2f with log2(e) folded into
//     the scale (lse = m ln 2 + log l, within fp32 rounding of the exp/log
//     form: the checks hold lse to 1e-4). The mask runs only on tiles the
//     diagonal or the window's edge crosses, the hash only with dropout on.
//   - Output staged through the warp's own q rows in shared memory and
//     written with 16-byte stores.
// Registers a thread, shared memory a CTA, CTAs an SM (as nvcc builds them
// for sm_90a): D = 128, 128 rows: 255 with 32 bytes spilled, 96 KB, 2; D = 128,
// 64 rows: 168, 80 KB, 2; D = 64, 64 rows: 126, 40 KB, 4. D = 64 is built
// with 64 rows only (128 measured no faster there).
// causal_attention_fwd_info reports them from the built kernel (chip_smoke.py
// prints the line).
//
// What bounds it. At S >= 1280 (2 * 2 * D operations a live pair) the
// operations at the bf16 tensor-core rate, two orders above the bytes. What
// holds the kernel below that rate, by count: mma.sync reaches about two
// thirds of wgmma's; a warp's 32 rows use each B fragment it reads from
// shared memory for four products (one 512-byte ldmatrix.x4 for every four
// mma: at 128 bytes a clock the shared memory and the tensor cores then take
// the same time; with 16 rows a warp it is twice the tensor cores'); and
// with two CTAs of four warps an SM each scheduler has two warps, so little
// of the softmax's exp2 and shuffles hides behind another warp's products.
// At the serving prefill
// shape a launch is under one wave: latency bound, a single launch and
// nothing written but o and lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_fma.cuh"
#include "attention_mma.cuh"

using namespace dalle_attn;
using namespace dalle_attn::mma;

namespace {

// WARPS warps, each owning MB blocks of 16 q rows
template <int D, int WARPS, int MB>
constexpr size_t fwd_smem_bytes() {
  // the q tile, and two buffers of a k and a v tile, bf16
  return (size_t)(WARPS * MB * 16 + 4 * kStream) * D * 2;
}

template <int D, int WARPS, int MB>
__global__ void __launch_bounds__(WARPS * 32)
causal_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                            Layout lay, int window, Dropout drop, float scale_log2) {
  constexpr int kRows = WARPS * MB * 16;
  constexpr int kThr = WARPS * 32;
  constexpr uint32_t kTileBytes = kStream * D * 2;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sq = smem_u32(smem_raw);
  const uint32_t skv = sq + kRows * D * 2;  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // deepest tiles first
  const int q0 = q_tile * kRows;
  const int64_t base = lay.base(bh);
  const uint32_t seed = drop.seed + (uint32_t)bh;  // wrapping, as XLA's int32 add
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_row0 = warp * MB * 16;  // this warp's first row of the tile
  const int row0 = q0 + warp_row0;       // and of the sequence

  // ops/attention_tiles.py::key_tile_range
  const int q_last = min(q0 + kRows, seq_len) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / kStream, t_end = q_last / kStream;

  load_tile_async<D, kThr>(sq, q, base, lay.stride_r, q0, kRows, seq_len);
  load_tile_async<D, kThr>(skv, k, base, lay.stride_r, t_begin * kStream, kStream, seq_len);
  load_tile_async<D, kThr>(skv + kTileBytes, v, base, lay.stride_r, t_begin * kStream, kStream,
                           seq_len);
  cp_async_commit();

  float acc[MB][D / 8][4];
  // per thread and block: rows g (index 0) and g + 8 (index 1) of the block's
  // 16, in the log2 domain (scores times D^-0.5 log2 e)
  float m[MB][2], l[MB][2];
  zero(acc);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    m[mb][0] = m[mb][1] = kNegInf;
    l[mb][0] = l[mb][1] = 0.f;
  }

  for (int t = t_begin; t <= t_end; ++t) {
    const uint32_t sk = skv + ((t - t_begin) & 1) * 2 * kTileBytes;
    const uint32_t sv = sk + kTileBytes;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t < t_end) {
      const uint32_t nk = skv + ((t + 1 - t_begin) & 1) * 2 * kTileBytes;
      load_tile_async<D, kThr>(nk, k, base, lay.stride_r, (t + 1) * kStream, kStream, seq_len);
      load_tile_async<D, kThr>(nk + kTileBytes, v, base, lay.stride_r, (t + 1) * kStream, kStream,
                               seq_len);
      cp_async_commit();
    }

    float s[MB][kStream / 8][4];
    zero(s);
    product_nt<D, kStream, MB>(s, sq, warp_row0, sk, 0, lane);

    const int c0 = t * kStream;
    // ops/attention_tiles.py::tile_needs_mask: the diagonal or the window's edge
    // crosses this (q tile, key tile) pair
    const bool edge = c0 + kStream - 1 > q0 || (window > 0 && q0 + kRows - 1 - c0 >= window);
    uint32_t p[MB][kStream / 16][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int brow0 = row0 + mb * 16;  // this block's first global row
      float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kStream / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mb][n][e] * scale_log2;
          if (edge && is_masked(brow0 + frag_row(lane, e), c0 + frag_col(lane, n, e), window))
            x = kNegInf;
          s[mb][n][e] = x;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 lanes of a quad hold one row
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        const float m_new = fmaxf(m[mb][r], tile_max[r]);
        alpha[r] = exp2f(m[mb][r] - m_new);
        m[mb][r] = m_new;
      }

      float p_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kStream / 8; ++n) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[mb][n][e] - m[mb][e >> 1]);
          p_sum[e >> 1] += pe;  // the normalizer of the UNdropped weights
          pv[e] = pe;
          if (drop.enabled)
            pv[e] = dropout_keep(brow0 + frag_row(lane, e), c0 + frag_col(lane, n, e), seed,
                                 drop.threshold)
                        ? pe * drop.scale
                        : 0.f;
        }
        // C fragments 2j and 2j + 1 are the A fragment of key step j
        p[mb][n >> 1][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
        p[mb][n >> 1][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 1);
        p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 2);
        l[mb][r] = l[mb][r] * alpha[r] + p_sum[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[mb][n][0] *= alpha[0];
        acc[mb][n][1] *= alpha[0];
        acc[mb][n][2] *= alpha[1];
        acc[mb][n][3] *= alpha[1];
      }
    }
    product_pn<D, kStream, MB>(acc, p, sv, 0, lane);
  }

#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const float l_safe[2] = {fmaxf(l[mb][0], 1e-30f), fmaxf(l[mb][1], 1e-30f)};
    const float inv[2] = {1.f / l_safe[0], 1.f / l_safe[1]};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[mb][n][0] *= inv[0];
      acc[mb][n][1] *= inv[0];
      acc[mb][n][2] *= inv[1];
      acc[mb][n][3] *= inv[1];
    }
    // the warp's q rows are read by this warp alone, and it is done with them
    store_warp_rows<D>(smem_raw, warp_row0 + mb * 16, acc[mb], o, base, lay.stride_r,
                       row0 + mb * 16, seq_len, lane);
    if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + mb * 16 + (lane >> 2) + r * 8;
        if (row < seq_len) lse[(int64_t)bh * seq_len + row] = m[mb][r] * kLn2 + logf(l_safe[r]);
      }
    }
  }
}

template <int D, int WARPS, int MB>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                       const Layout& lay, int window, const Dropout& drop,
                       cudaStream_t stream) {
  auto kernel = causal_attention_fwd_kernel<D, WARPS, MB>;
  constexpr size_t smem = fwd_smem_bytes<D, WARPS, MB>();
  constexpr int kRows = WARPS * MB * 16;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lay.batch * lay.heads, (lay.seq_len + kRows - 1) / kRows);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), lay, window, drop, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D, int WARPS, int MB>
cudaError_t info(int* out) {
  return kernel_info(causal_attention_fwd_kernel<D, WARPS, MB>, WARPS * 32,
                     fwd_smem_bytes<D, WARPS, MB>(), out);
}

// tile_rows: 0 takes the q tile by forward_tile_rows, 64 or 128 forces it
int forward(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
            int heads, int seq_len, int head_dim, long long stride_b, long long stride_h,
            long long stride_r, int dtype, int window, int dropout, unsigned int seed,
            unsigned int keep_threshold, float keep_scale, void* stream, int tile_rows) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlock - 1) / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout lay{batch, heads, seq_len, stride_b, stride_h, stride_r};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)fp32::launch_fwd<float, 64>(q, k, v, o, lse, lay, window, drop, s);
  if (dtype == 0 && head_dim == 128)
    return (int)fp32::launch_fwd<float, 128>(q, k, v, o, lse, lay, window, drop, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)) ||
      ((stride_b | stride_h | stride_r) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int rows = tile_rows != 0 ? tile_rows : forward_tile_rows(head_dim, batch * heads, seq_len);
  // 64 rows: 4 warps of one 16-row block; 128 rows (D = 128 only): 4 warps of two
#define DALLE_FWD(D, MB) (int)launch_mma<D, 4, MB>(q, k, v, o, lse, lay, window, drop, s)
  if (head_dim == 64 && rows == 64) return DALLE_FWD(64, 1);
  if (head_dim == 128 && rows == 64) return DALLE_FWD(128, 1);
  if (head_dim == 128 && rows == 128) return DALLE_FWD(128, 2);
#undef DALLE_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o share one layout: element (b, h, row, d) lies at
// b*stride_b + h*stride_h + row*stride_r + d. [B, H, S, D] contiguous is
// (H*S*D, S*D, D); packed [B, S, H*D] is (S*H*D, D, H*D).
// dtype: 0 = float32, 1 = bfloat16 (pointers 16-byte aligned, strides
// multiples of 8). window <= 0: no local window. lse may be null.
// dropout != 0 enables the hash dropout (keep when hash >> 8 <
// keep_threshold, kept weights times keep_scale). Returns the cudaError_t of
// the launch (0 on success).
extern "C" int causal_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int batch, int heads, int seq_len,
                                    int head_dim, long long stride_b, long long stride_h,
                                    long long stride_r, int dtype, int window, int dropout,
                                    unsigned int seed, unsigned int keep_threshold,
                                    float keep_scale, void* stream) {
  return forward(q, k, v, o, lse, batch, heads, seq_len, head_dim, stride_b, stride_h, stride_r,
                 dtype, window, dropout, seed, keep_threshold, keep_scale, stream, 0);
}

// causal_attention_fwd with the bf16 q tile given (64, or 128 at D = 128)
// instead of chosen by shape: for tests and measurements of either tile.
extern "C" int causal_attention_fwd_tiled(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int batch, int heads, int seq_len,
                                          int head_dim, long long stride_b, long long stride_h,
                                          long long stride_r, int dtype, int window,
                                          int dropout, unsigned int seed,
                                          unsigned int keep_threshold, float keep_scale,
                                          void* stream, int tile_rows) {
  if (tile_rows != 64 && tile_rows != 128) return (int)cudaErrorInvalidValue;
  return forward(q, k, v, o, lse, batch, heads, seq_len, head_dim, stride_b, stride_h, stride_r,
                 dtype, window, dropout, seed, keep_threshold, keep_scale, stream, tile_rows);
}

// The q tile's rows causal_attention_fwd takes for bf16 inputs of this shape.
extern "C" int causal_attention_fwd_tile_rows(int head_dim, int programs, int seq_len) {
  return forward_tile_rows(head_dim, programs, seq_len);
}

// out[0..4) = registers a thread, local (spill) bytes a thread, dynamic
// shared memory a CTA, CTAs an SM, of the bf16 forward kernel for head_dim
// and tile rows (64, or 128 at D = 128).
extern "C" int causal_attention_fwd_info(int head_dim, int tile_rows, int* out) {
  if (head_dim == 64 && tile_rows == 64) return (int)info<64, 4, 1>(out);
  if (head_dim == 128 && tile_rows == 64) return (int)info<128, 4, 1>(out);
  if (head_dim == 128 && tile_rows == 128) return (int)info<128, 4, 2>(out);
  return (int)cudaErrorInvalidValue;
}
