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
// Two instantiations behind the one entry point, both on the tensor cores
// and both with the walk below:
//   - bfloat16: mma.sync.m16n8k16 from swizzled bf16 tiles;
//   - float32 (namespace tc32): mma.sync.m16n8k8 on TF32, every operand split
//     into two TF32 values and each product taken as three
//     (attention_tf32.cuh). One TF32 product, about 2^-11 relative, cannot
//     hold the fp32 callers' 1e-5; the split, about 2^-22, does
//     (tests/test_torch_attention_tiles.py emulates both on the CPU).
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
// The fp32 design differs from the bf16 one where fp32 forces it (the fp32
// backward's, causal_attention_bwd.cu):
//   - Tiles: fp32 rows padded to D + 4 words, no swizzle (fragments are plain
//     32-bit shared loads; the padding keeps them free of bank conflicts);
//     the q tile, split once into a big and a small tile (tf32::split_tile:
//     no key tile splits it again, 3-4% faster at loop_fp32's shape on an
//     H100), and two buffers of a k and a v tile, copied by 16-byte
//     cp.async: 203 KB a CTA at D = 128, 104 KB at 64. So one 64-row q tile
//     a CTA.
//   - Warps: eight, two groups of four over the same 16-row blocks of the q
//     tile, group h taking keys [32 h, 32 h + 32) of every streamed tile
//     with its own online softmax (m, l, acc); the groups are merged once at
//     the end in a fixed order (tf32::merge_halves: m = max(m0, m1), each
//     group's acc and l scaled by 2^(m_h - m)), so two runs give the same
//     bits.
//   - Products: each k and v fragment element split at its load
//     (tf32::split: integer adds and masks, a min, one subtract); each k step of 8 is three
//     mma.sync.m16n8k8 into a fresh accumulator, added into the result
//     rounding to nearest (the tensor cores truncate each mma's sum: one
//     accumulator down a 4352-long P V sum drifts past 1e-5 of a tile). The
//     scores' C fragments are the A fragments of p_v V with each 8-key step
//     taken in a permuted order, so P stays in registers; p_v is not rounded
//     (fp32).
//   - Output: written in fp32 straight from the C fragments, 8-byte stores.
//   - Registers a thread, spills, CTAs an SM, as nvcc builds them for sm_90a:
//     D = 128: 197, none, 1; D = 64: 140, none, 1 (the registers bound it).
//     causal_attention_fwd_info with dtype 0 reports them (chip_smoke.py's
//     "resources" line).
//   - What bounds it: the operations, three TF32 products for each of the
//     two (494.7 TFLOP/s dense); at S >= 1280 the bytes are two orders
//     below. What holds it below that rate, by count: every k and v element
//     a warp loads costs three ALU operations to split, about as many
//     issue slots as its share of the mma; a warp's 16 rows use each split
//     B fragment for one m16n8k8 triple only; with one CTA an SM each
//     scheduler has two warps.
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
#include "attention_mma.cuh"
#include "attention_tf32.cuh"

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
  const uint32_t seed = drop.program_seed(bh, lay.heads);
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

// ------------------------------------------ fp32: 3xTF32 on the tensor cores

namespace tc32 {

using namespace dalle_attn::tf32;

// Two groups of four warps: each warp owns 16 rows of the 64-row q tile, and
// group h takes keys [32 h, 32 h + 32) of every streamed tile.
constexpr int kRows = 64;
constexpr int kHalf = 32;
constexpr int kThr = 256;

template <int D>
constexpr size_t smem_bytes() {
  // the q tile split in two (big, small), and two buffers of a k and a v
  // tile, padded fp32
  return (size_t)tile_bytes<D>(2 * kRows + 4 * kStream);
}

template <int D>
__global__ void __launch_bounds__(kThr)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     Layout lay, int window, Dropout drop, float scale_log2) {
  constexpr int kTile = kStream * (D + 4);  // words of a streamed tile

  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sq_small = sq + kRows * (D + 4);   // sq holds q's big part once split
  float* skv = sq_small + kRows * (D + 4);  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // deepest tiles first
  const int64_t base = lay.base(bh);
  const uint32_t seed = drop.program_seed(bh, lay.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 2;             // this warp's group: its half of the streamed tile
  const int warp_row0 = (warp & 3) * 16;  // this warp's first row of the tile
  const int row0 = q0 + warp_row0;        // and of the sequence

  // ops/attention_tiles.py::key_tile_range
  const int q_last = min(q0 + kRows, seq_len) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / kStream, t_end = q_last / kStream;

  load_tile_async<D, kThr>(smem_u32(sq), q, base, lay.stride_r, q0, kRows, seq_len);
  cp_async_commit();
  load_tile_async<D, kThr>(smem_u32(skv), k, base, lay.stride_r, t_begin * kStream, kStream,
                           seq_len);
  load_tile_async<D, kThr>(smem_u32(skv + kTile), v, base, lay.stride_r, t_begin * kStream,
                           kStream, seq_len);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // q has landed (the first k and v tiles may still be in flight)
  split_tile<D, kThr>(sq, sq_small, kRows);  // the loop's first __syncthreads orders it

  float acc[D / 8][4];
  // rows g (index 0) and g + 8 (index 1) of the warp's 16, this group's
  // keys only, in the log2 domain
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  tf32::zero(acc);

  for (int t = t_begin; t <= t_end; ++t) {
    const float* sk = skv + ((t - t_begin) & 1) * 2 * kTile;
    const float* sv = sk + kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t < t_end) {
      float* nk = skv + ((t + 1 - t_begin) & 1) * 2 * kTile;
      load_tile_async<D, kThr>(smem_u32(nk), k, base, lay.stride_r, (t + 1) * kStream, kStream,
                               seq_len);
      load_tile_async<D, kThr>(smem_u32(nk + kTile), v, base, lay.stride_r, (t + 1) * kStream,
                               kStream, seq_len);
      cp_async_commit();
    }
    const int c0 = t * kStream;
    const int h0 = c0 + half * kHalf;  // this group's first key
    // ops/attention_tiles.py::tile_needs_mask
    const bool edge = c0 + kStream - 1 > q0 || (window > 0 && q0 + kRows - 1 - c0 >= window);

    float s[kHalf / 8][4];
    tf32::zero(s);
    tf32::product_nt<D, kHalf, 2>(s, sq, sq_small, warp_row0, sk, half * kHalf, lane);
#pragma unroll
    for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale_log2;
        if (edge && is_masked(row0 + frag_row(lane, e), h0 + frag_col(lane, n, e), window))
          s[n][e] = kNegInf;
      }
    softmax_step<D, kHalf>(s, m, l, acc, drop, [&](int n, int e) {
      return dropout_keep(row0 + frag_row(lane, e), h0 + frag_col(lane, n, e), seed,
                          drop.threshold);
    });
    tf32::product_pn<D, kHalf>(acc, s, sv, half * kHalf, lane);
  }

  __syncthreads();  // every warp is done with the streamed tiles: group 1 parks there
  merge_halves<D>(acc, m, l, skv, half, warp_row0, lane);
  if (half == 1) return;

  // o = acc / l_safe in fp32 straight from the C fragments; every row < S
  // saw its own key, so m is finite
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] /= l_safe[0];
    acc[n][1] /= l_safe[0];
    acc[n][2] /= l_safe[1];
    acc[n][3] /= l_safe[1];
  }
  store_rows<D>(acc, 1.f, o, base, lay.stride_r, row0, seq_len, lane);
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + r * 8;
      if (row < seq_len) lse[(int64_t)bh * seq_len + row] = m[r] * kLn2 + logf(l_safe[r]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const Layout& lay, int window, const Dropout& drop, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lay.batch * lay.heads, (lay.seq_len + kRows - 1) / kRows);
  kernel<<<grid, kThr, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), lay, window, drop,
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int* out) {
  return kernel_info(attention_fwd_kernel<D>, kThr, smem_bytes<D>(), out);
}

}  // namespace tc32

// tile_rows: 0 takes the q tile by forward_tile_rows, 64 or 128 forces it
// (bf16; the fp32 kernel has 64-row tiles only)
int forward(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
            int heads, int seq_len, int head_dim, long long stride_b, long long stride_h,
            long long stride_r, int dtype, int window, int dropout, unsigned int seed,
            unsigned int keep_threshold, float keep_scale, int heads_total, int head0,
            void* stream, int tile_rows) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlock - 1) / kBlock > 65535 || head0 < 0 || head0 > heads_total - heads)
    return (int)cudaErrorInvalidValue;
  const Layout lay{batch, heads, seq_len, stride_b, stride_h, stride_r};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale, heads_total, head0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  // 16-byte copies: 16-byte-aligned pointers, rows of whole 16-byte chunks
  // (4 fp32 or 8 bf16 elements)
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)) ||
      ((stride_b | stride_h | stride_r) & (dtype == 0 ? 3 : 7)) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 0 && (tile_rows == 0 || tile_rows == tc32::kRows)) {
    if (head_dim == 64) return (int)tc32::launch<64>(q, k, v, o, lse, lay, window, drop, s);
    if (head_dim == 128) return (int)tc32::launch<128>(q, k, v, o, lse, lay, window, drop, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
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
// dtype: 0 = float32 (pointers 16-byte aligned, strides multiples of 4),
// 1 = bfloat16 (pointers 16-byte aligned, strides multiples of 8).
// window <= 0: no local window. lse may be null.
// dropout != 0 enables the hash dropout (keep when hash >> 8 <
// keep_threshold, kept weights times keep_scale); the heads are heads
// [head0, head0 + heads) of heads_total for its hash (Dropout::program_seed;
// heads_total = heads, head0 = 0 for a launch over every head). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int causal_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int batch, int heads, int seq_len,
                                    int head_dim, long long stride_b, long long stride_h,
                                    long long stride_r, int dtype, int window, int dropout,
                                    unsigned int seed, unsigned int keep_threshold,
                                    float keep_scale, int heads_total, int head0,
                                    void* stream) {
  return forward(q, k, v, o, lse, batch, heads, seq_len, head_dim, stride_b, stride_h, stride_r,
                 dtype, window, dropout, seed, keep_threshold, keep_scale, heads_total, head0,
                 stream, 0);
}

// causal_attention_fwd with the bf16 q tile given (64, or 128 at D = 128)
// instead of chosen by shape: for tests and measurements of either tile
// (fp32: 64 only).
extern "C" int causal_attention_fwd_tiled(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int batch, int heads, int seq_len,
                                          int head_dim, long long stride_b, long long stride_h,
                                          long long stride_r, int dtype, int window,
                                          int dropout, unsigned int seed,
                                          unsigned int keep_threshold, float keep_scale,
                                          int heads_total, int head0, void* stream,
                                          int tile_rows) {
  if (tile_rows != 64 && tile_rows != 128) return (int)cudaErrorInvalidValue;
  return forward(q, k, v, o, lse, batch, heads, seq_len, head_dim, stride_b, stride_h, stride_r,
                 dtype, window, dropout, seed, keep_threshold, keep_scale, heads_total, head0,
                 stream, tile_rows);
}

// The q tile's rows causal_attention_fwd takes for bf16 inputs of this shape.
extern "C" int causal_attention_fwd_tile_rows(int head_dim, int programs, int seq_len) {
  return forward_tile_rows(head_dim, programs, seq_len);
}

// out[0..4) = registers a thread, local (spill) bytes a thread, dynamic
// shared memory a CTA, CTAs an SM, of the forward kernel for head_dim, tile
// rows and dtype (0 = float32: 64 rows; 1 = bfloat16: 64, or 128 at
// D = 128).
extern "C" int causal_attention_fwd_info(int head_dim, int tile_rows, int dtype, int* out) {
  if (dtype == 0 && tile_rows == tc32::kRows) {
    if (head_dim == 64) return (int)tc32::info<64>(out);
    if (head_dim == 128) return (int)tc32::info<128>(out);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (head_dim == 64 && tile_rows == 64) return (int)info<64, 4, 1>(out);
  if (head_dim == 128 && tile_rows == 64) return (int)info<128, 4, 1>(out);
  if (head_dim == 128 && tile_rows == 128) return (int)info<128, 4, 2>(out);
  return (int)cudaErrorInvalidValue;
}
