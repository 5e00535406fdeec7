// Causal attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU backward kernels with one source, by strides:
//   - dalle_mtf_tpu/ops/attention_packed.py::_fused_bwd_kernel, over the
//     packed [B, S, H*D] layout (head h = column block [h*D, (h+1)*D) of rows
//     of stride H*D): dQ, dK and dV of every layer on the training path;
//   - dalle_mtf_tpu/ops/attention.py::_wedge_bwd_kernel, _wr_bwd_kernel,
//     _bwd_dq_kernel + _bwd_dkv_kernel and _hybrid_bwd_kernel, over
//     [B, H, S, D]: unpacked and long-sequence training.
//
// What it computes (the TPU kernels' contract), from the forward's fp32 lse
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
// Two launches, no atomics, nothing carried between CTAs, so two runs on the
// same inputs give the same bits:
//   - dQ: one CTA per (b*h, q tile), walking the 64-key tiles from the
//     window's first up to the diagonal (the forward's walk);
//   - dK/dV: one CTA per (b*h, key tile), walking the 64-row q tiles from the
//     diagonal down to the last row the window lets see the tile.
// Each recomputes the scores it needs from q, k and lse, so no [S, S] tensor
// exists. Two instantiations behind the one entry point, both on the tensor
// cores and both with the structure below:
//   - bfloat16: mma.sync.m16n8k16 from swizzled bf16 tiles;
//   - float32 (namespace tc32): mma.sync.m16n8k8 on TF32, every operand split
//     into two TF32 values and each product taken as three
//     (attention_tf32.cuh). One TF32 product, about 2^-11 relative, cannot
//     hold the fp32 callers' 1e-5; the split, about 2^-22, does
//     (tests/test_torch_attention_tiles.py emulates both on the CPU).
//
// The bf16 design (pieces in attention_mma.cuh). The owner tile (q rows in the
// dQ pass, keys in the dK/dV pass) has 64 rows: 4 warps of one 16-row block
// (the products of attention_mma.cuh with MB = 1). A 128-row tile (two blocks
// a warp; 8 warps of one in the dK/dV pass at D = 128) measured 15-20% slower
// in both passes on an H100 at S = 1280 and 4352 (255 registers with spills,
// one CTA an SM): the kernels are written for 64 rows only.
//   - Tiles: bf16 under the 128-byte XOR swizzle; the owner's two tiles (q and
//     dO, or k and v) stay, the streamed pair (k and v, or q and dO, with the
//     64 lse and dsum values in the dK/dV pass) is double-buffered.
//   - Copies: cp.async (16 bytes a thread for tiles, 4 for lse and dsum),
//     zero-filled beyond S; tile t + 1 in flight while tile t is multiplied.
//     TMA is not used (its descriptor needs cuTensorMapEncodeTiled, which
//     this library does not link; cp.async hides the loads already).
//   - Products: all on the tensor cores, mma.sync.m16n8k16 with ldmatrix and
//     fp32 accumulators in registers. The dQ pass computes S = q k^T and
//     dP = dO v^T; the dK/dV pass the transposes S^T = k q^T and
//     dP^T = v dO^T, so ds, and p_v^T and ds^T, come out of the accumulator
//     fragments already in A-operand order for ds k, p_v^T dO and ds^T q
//     (the right-hand tiles read through ldmatrix.trans). mma.sync rather
//     than wgmma: the dK/dV pass holds two 16 x D accumulators a warp (128
//     registers at D = 128) beside the score fragments; wgmma's 64-row tile
//     a warpgroup gives the same registers a thread but fixes the tile at 64
//     rows and needs descriptors for the transposed operands, and the score
//     tile would not split. Here a streamed tile is taken in two halves of 32
//     columns, so the score, dP and packed fragments need 16 + 16 + 16
//     registers. Registers a thread, shared memory a CTA, CTAs an SM (64-row
//     tile, as nvcc builds it for sm_90a): dQ at D = 128: 176, 96 KB, 2;
//     at D = 64: 130, 48 KB, 3; dK/dV at D = 128: 255 with 16 bytes spilled,
//     97 KB, 2; at D = 64: 174, 49 KB, 2 (causal_attention_bwd_info reports
//     them from the built kernels; chip_smoke.py prints the line).
//   - p = exp2f(s * D^-0.5 log2 e - lse log2 e): one FMA and one exp2 an
//     element; the mask only on tiles the diagonal, the window's edge or the
//     ragged end crosses, the hash only with dropout on.
//   - Results staged through the warp's own rows of the owner tiles and
//     written with 16-byte stores.
//
// The fp32 design differs from the bf16 one where fp32 forces it:
//   - Tiles: fp32 rows padded to D + 4 words (no swizzle: ldmatrix moves
//     16-bit elements only, so fragments are plain 32-bit shared loads, and
//     the padding keeps both the row-major and the transposed reads free of
//     bank conflicts); the same owner and double-buffered streamed tiles,
//     copied by 16-byte cp.async: 203 KB a CTA at D = 128, 104 KB at 64.
//   - Warps: eight, two groups of four over the same 16-row blocks of the
//     owner tile, group h taking columns [32 h, 32 h + 32) of each streamed
//     tile (where the bf16 warp takes both halves in turn); the groups' sums
//     are added in a fixed order at the end, through the freed streamed
//     buffers. With one CTA an SM, four warps measured 1.8-2.0x slower on
//     an H100.
//   - Products: each fragment element is split at its load (tf32::split:
//     integer adds and masks, a min, one subtract); each k step of 8 is three mma.sync.m16n8k8 into a
//     fresh accumulator, added into the result rounding to nearest (the
//     tensor cores truncate each mma's sum: one accumulator down a 4352-long
//     sum measured 6.7e-5 of a tile on an H100, past the 1e-5 bound). The
//     two score products of a pass run in one loop. The scores' C fragments
//     become the A fragments of the second products with the keys of each
//     8-key step taken in a permuted order (attention_tf32.cuh), so P and dS
//     stay in registers as in bf16.
//   - Results: written in fp32 straight from the C fragments, 8-byte stores.
//   - Registers a thread, spills, CTAs an SM, as nvcc builds them for
//     sm_90a: D = 128 dQ 192 / 0 / 1, dK/dV 255 / 120 bytes / 1; D = 64 dQ
//     145 / 0 / 1, dK/dV 192 / 0 / 1 (causal_attention_bwd_info with dtype 0).
//
// What bounds it: the operations at the bf16 tensor-core rate; at S >= 1280
// the bytes are two orders below. What holds the kernels below that rate: the
// two passes run seven tile products where the gradient needs five (S and dP
// are computed in both), all at the mma.sync rate, about two thirds of
// wgmma's; a warp's 16 rows use each B fragment read from shared memory for
// two products only, so by count the shared memory's 128 bytes a clock cap
// the SM at half the tensor cores' peak; with two warps a scheduler little
// of the exp2 and the hash hides behind another warp's products. The dsum
// reduction outside (one read of dO and O) is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"
#include "attention_tf32.cuh"

using namespace dalle_attn;
using namespace dalle_attn::mma;

namespace {

constexpr int kHalf = 32;   // score columns taken at once
constexpr int kWarps = 4;   // each owning one block of 16 rows of the owner tile
constexpr int kRows = kWarps * 16;  // the owner tile: q rows (dQ pass) or keys (dK/dV pass)
constexpr int kThr = kWarps * 32;

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO owner tiles, two buffers of a k and a v tile, bf16
  return (size_t)(2 * kRows + 4 * kStream) * D * 2;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k and v owner tiles, two buffers of a q and a dO tile, bf16; two buffers
  // of lse and dsum, fp32
  return (size_t)(2 * kRows + 4 * kStream) * D * 2 + 4 * kStream * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThr)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq,
                        Layout lay, int window, Dropout drop, float scale, float scale_log2) {
  constexpr uint32_t kTileBytes = kStream * D * 2;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sq = smem_u32(smem_raw);
  const uint32_t sdo = sq + kRows * D * 2;
  const uint32_t skv = sdo + kRows * D * 2;  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // deepest tiles first
  const int q0 = q_tile * kRows;
  const int64_t base = lay.base(bh);
  const uint32_t seed = drop.program_seed(bh, lay.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_row0 = warp * 16;  // this warp's first row of the tile
  const int row0 = q0 + warp_row0;       // and of the sequence

  // ops/attention_tiles.py::key_tile_range
  const int q_last = min(q0 + kRows, seq_len) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / kStream, t_end = q_last / kStream;

  load_tile_async<D, kThr>(sq, q, base, lay.stride_r, q0, kRows, seq_len);
  load_tile_async<D, kThr>(sdo, dout, base, lay.stride_r, q0, kRows, seq_len);
  load_tile_async<D, kThr>(skv, k, base, lay.stride_r, t_begin * kStream, kStream, seq_len);
  load_tile_async<D, kThr>(skv + kTileBytes, v, base, lay.stride_r, t_begin * kStream, kStream,
                           seq_len);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: lse in the log2 domain, and dsum
  float lse2[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    const int64_t at = (int64_t)bh * seq_len + row;
    lse2[r] = row < seq_len ? lse[at] * kLog2e : 0.f;
    dsum_r[r] = row < seq_len ? dsum[at] : 0.f;
  }

  float acc[1][D / 8][4];
  zero(acc);

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
    const int c0 = t * kStream;
    // ops/attention_tiles.py::tile_needs_mask
    const bool edge = c0 + kStream - 1 > q0 || (window > 0 && q0 + kRows - 1 - c0 >= window);

#pragma unroll
    for (int half = 0; half < kStream / kHalf; ++half) {
      float s[1][kHalf / 8][4], dp[1][kHalf / 8][4];
      zero(s);
      zero(dp);
      product_nt<D, kHalf, 1>(s, sq, warp_row0, sk, half * kHalf, lane);
      product_nt<D, kHalf, 1>(dp, sdo, warp_row0, sv, half * kHalf, lane);

      uint32_t ds[1][kHalf / 16][4];
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n) {
        float dse[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + frag_row(lane, e);
          const int col = c0 + half * kHalf + frag_col(lane, n, e);
          float p = exp2f(fmaf(s[0][n][e], scale_log2, -lse2[e >> 1]));
          if (edge && is_masked(row, col, window)) p = 0.f;
          float dpe = dp[0][n][e];
          if (drop.enabled)
            dpe = dropout_keep(row, col, seed, drop.threshold) ? dpe * drop.scale : 0.f;
          dse[e] = p * (dpe - dsum_r[e >> 1]);
        }
        ds[0][n >> 1][(n & 1) * 2] = pack_bf16(dse[0], dse[1]);
        ds[0][n >> 1][(n & 1) * 2 + 1] = pack_bf16(dse[2], dse[3]);
      }
      product_pn<D, kHalf, 1>(acc, ds, sk, half * kHalf, lane);
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] *= scale;
  // the warp's q rows are read by this warp alone, and it is done with them
  store_warp_rows<D>(smem_raw, warp_row0, acc[0], dq, base, lay.stride_r, row0, seq_len, lane);
}

template <int D>
__global__ void __launch_bounds__(kThr)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, Layout lay, int window, Dropout drop,
                         float scale, float scale_log2) {
  constexpr uint32_t kTileBytes = kStream * D * 2;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sk = smem_u32(smem_raw);
  const uint32_t sv = sk + kRows * D * 2;
  const uint32_t sqd = sv + kRows * D * 2;  // buffer b: q at sqd + b * 2 tiles, dO one tile on
  const uint32_t srows = sqd + 4 * kTileBytes;  // buffer b: lse[64] then dsum[64]
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + 2 * kRows * D * 2 + 4 * kTileBytes);

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kRows;  // key tile 0 sees every q tile: heaviest first
  const int64_t base = lay.base(bh);
  const int64_t row_base = (int64_t)bh * seq_len;
  const uint32_t seed = drop.program_seed(bh, lay.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_row0 = warp * 16;  // this warp's first key of the tile
  const int key0 = c0 + warp_row0;       // and of the sequence

  // ops/attention_tiles.py::query_tile_range
  const int k_last = min(c0 + kRows, seq_len) - 1;
  const int q_last = window > 0 ? min(seq_len - 1, k_last + window - 1) : seq_len - 1;
  const int t_begin = c0 / kStream, t_end = q_last / kStream;

  load_tile_async<D, kThr>(sk, k, base, lay.stride_r, c0, kRows, seq_len);
  load_tile_async<D, kThr>(sv, v, base, lay.stride_r, c0, kRows, seq_len);
  load_tile_async<D, kThr>(sqd, q, base, lay.stride_r, t_begin * kStream, kStream, seq_len);
  load_tile_async<D, kThr>(sqd + kTileBytes, dout, base, lay.stride_r, t_begin * kStream, kStream,
                           seq_len);
  load_rows_async<kThr>(srows, lse, row_base, t_begin * kStream, seq_len);
  load_rows_async<kThr>(srows + kStream * 4, dsum, row_base, t_begin * kStream, seq_len);
  cp_async_commit();

  float dk_acc[1][D / 8][4], dv_acc[1][D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int t = t_begin; t <= t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const uint32_t sq = sqd + buf * 2 * kTileBytes;
    const uint32_t sdo = sq + kTileBytes;
    const float* slse = rows_f + buf * 2 * kStream;
    const float* sdsum = slse + kStream;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t < t_end) {
      const uint32_t nq = sqd + (buf ^ 1) * 2 * kTileBytes;
      const uint32_t nrows = srows + (buf ^ 1) * 2 * kStream * 4;
      load_tile_async<D, kThr>(nq, q, base, lay.stride_r, (t + 1) * kStream, kStream, seq_len);
      load_tile_async<D, kThr>(nq + kTileBytes, dout, base, lay.stride_r, (t + 1) * kStream,
                               kStream, seq_len);
      load_rows_async<kThr>(nrows, lse, row_base, (t + 1) * kStream, seq_len);
      load_rows_async<kThr>(nrows + kStream * 4, dsum, row_base, (t + 1) * kStream, seq_len);
      cp_async_commit();
    }
    const int q0 = t * kStream;
    // ops/attention_tiles.py::tile_needs_mask, transposed: the diagonal, the
    // window's edge or the end of the sequence crosses this pair
    const bool edge = c0 + kRows - 1 > q0 || (window > 0 && q0 + kStream - 1 - c0 >= window) ||
                      q0 + kStream > seq_len;

#pragma unroll
    for (int half = 0; half < kStream / kHalf; ++half) {
      // the transposed tiles: rows are this warp's keys, columns are q rows
      float st[1][kHalf / 8][4], dpt[1][kHalf / 8][4];
      zero(st);
      zero(dpt);
      product_nt<D, kHalf, 1>(st, sk, warp_row0, sq, half * kHalf, lane);
      product_nt<D, kHalf, 1>(dpt, sv, warp_row0, sdo, half * kHalf, lane);

      uint32_t pv[1][kHalf / 16][4], ds[1][kHalf / 16][4];
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n) {
        float pve[4], dse[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = half * kHalf + frag_col(lane, n, e);
          const int qrow = q0 + qc;
          const int krow = key0 + frag_row(lane, e);
          float p = exp2f(fmaf(st[0][n][e], scale_log2, -slse[qc] * kLog2e));
          if (edge && (qrow >= seq_len || is_masked(qrow, krow, window))) p = 0.f;
          float p_v = p, dpe = dpt[0][n][e];
          if (drop.enabled) {
            // the transposed tile of the forward's mask: hash(query, key)
            const bool keep = dropout_keep(qrow, krow, seed, drop.threshold);
            p_v = keep ? p * drop.scale : 0.f;
            dpe = keep ? dpe * drop.scale : 0.f;
          }
          pve[e] = p_v;
          dse[e] = p * (dpe - sdsum[qc]);
        }
        pv[0][n >> 1][(n & 1) * 2] = pack_bf16(pve[0], pve[1]);
        pv[0][n >> 1][(n & 1) * 2 + 1] = pack_bf16(pve[2], pve[3]);
        ds[0][n >> 1][(n & 1) * 2] = pack_bf16(dse[0], dse[1]);
        ds[0][n >> 1][(n & 1) * 2 + 1] = pack_bf16(dse[2], dse[3]);
      }
      product_pn<D, kHalf, 1>(dv_acc, pv, sdo, half * kHalf, lane);
      product_pn<D, kHalf, 1>(dk_acc, ds, sq, half * kHalf, lane);
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[0][n][e] *= scale;
  // the warp's k and v rows are read by this warp alone, and it is done with them
  store_warp_rows<D>(smem_raw, warp_row0, dk_acc[0], dk, base, lay.stride_r, key0, seq_len,
                     lane);
  store_warp_rows<D>(smem_raw + kRows * D * 2, warp_row0, dv_acc[0], dv, base, lay.stride_r,
                     key0, seq_len, lane);
}

template <int D>
cudaError_t info(int pass, int* out) {
  if (pass == 0) return kernel_info(attention_bwd_dq_kernel<D>, kThr, dq_smem_bytes<D>(), out);
  return kernel_info(attention_bwd_dkv_kernel<D>, kThr, dkv_smem_bytes<D>(), out);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dsum, void* dq, void* dk, void* dv,
                       const Layout& lay, int window, const Dropout& drop,
                       cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid(lay.batch * lay.heads, (lay.seq_len + kRows - 1) / kRows);
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdsum = static_cast<const float*>(dsum);

  auto dq_kernel = attention_bwd_dq_kernel<D>;
  constexpr size_t dq_smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThr, dq_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<bf16*>(dq), lay, window, drop, scale,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = attention_bwd_dkv_kernel<D>;
  constexpr size_t dkv_smem = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThr, dkv_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lay,
      window, drop, scale, scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------ fp32: 3xTF32 on the tensor cores

namespace tc32 {

using namespace dalle_attn::tf32;

// Two groups of four warps: each warp owns 16 rows of the 64-row owner tile,
// and group h takes columns [32 h, 32 h + 32) of every streamed tile.
constexpr int kThr32 = 2 * kThr;

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO owner tiles, two buffers of a k and a v tile, padded fp32
  return (size_t)tile_bytes<D>(2 * kRows + 4 * kStream);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k and v owner tiles, two buffers of a q and a dO tile, padded fp32; two
  // buffers of lse and dsum
  return (size_t)tile_bytes<D>(2 * kRows + 4 * kStream) + 4 * kStream * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThr32)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        float* __restrict__ dq, Layout lay, int window, Dropout drop,
                        float scale, float scale_log2) {
  constexpr int kTile = kStream * (D + 4);  // words of a streamed tile

  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sdo = sq + kRows * (D + 4);
  float* skv = sdo + kRows * (D + 4);  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // deepest tiles first
  const int q0 = q_tile * kRows;
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

  load_tile_async<D, kThr32>(smem_u32(sq), q, base, lay.stride_r, q0, kRows, seq_len);
  load_tile_async<D, kThr32>(smem_u32(sdo), dout, base, lay.stride_r, q0, kRows, seq_len);
  load_tile_async<D, kThr32>(smem_u32(skv), k, base, lay.stride_r, t_begin * kStream, kStream,
                           seq_len);
  load_tile_async<D, kThr32>(smem_u32(skv + kTile), v, base, lay.stride_r, t_begin * kStream,
                           kStream, seq_len);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: lse in the log2 domain, and dsum
  float lse2[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    const int64_t at = (int64_t)bh * seq_len + row;
    lse2[r] = row < seq_len ? lse[at] * kLog2e : 0.f;
    dsum_r[r] = row < seq_len ? dsum[at] : 0.f;
  }

  float acc[D / 8][4];
  tf32::zero(acc);

  for (int t = t_begin; t <= t_end; ++t) {
    const float* sk = skv + ((t - t_begin) & 1) * 2 * kTile;
    const float* sv = sk + kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t < t_end) {
      float* nk = skv + ((t + 1 - t_begin) & 1) * 2 * kTile;
      load_tile_async<D, kThr32>(smem_u32(nk), k, base, lay.stride_r, (t + 1) * kStream, kStream,
                               seq_len);
      load_tile_async<D, kThr32>(smem_u32(nk + kTile), v, base, lay.stride_r, (t + 1) * kStream,
                               kStream, seq_len);
      cp_async_commit();
    }
    const int c0 = t * kStream;
    // ops/attention_tiles.py::tile_needs_mask
    const bool edge = c0 + kStream - 1 > q0 || (window > 0 && q0 + kRows - 1 - c0 >= window);

    {
      float s[kHalf / 8][4], dp[kHalf / 8][4];
      tf32::zero(s);
      tf32::zero(dp);
      product_nt2<D, kHalf>(s, dp, sq, sdo, warp_row0, sk, sv, half * kHalf, lane);
      // ds, in place of the scores: the A operand of ds k
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + frag_row(lane, e);
          const int col = c0 + half * kHalf + frag_col(lane, n, e);
          float p = exp2f(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
          if (edge && is_masked(row, col, window)) p = 0.f;
          float dpe = dp[n][e];
          if (drop.enabled)
            dpe = dropout_keep(row, col, seed, drop.threshold) ? dpe * drop.scale : 0.f;
          s[n][e] = p * (dpe - dsum_r[e >> 1]);
        }
      product_pn<D, kHalf>(acc, s, sk, half * kHalf, lane);
    }
  }

  __syncthreads();  // every warp is done with the streamed tiles: group 1 parks there
  if (half == 1) park<D>(skv, warp_row0, acc, lane);
  __syncthreads();
  if (half == 0) {
    add_parked<D>(acc, skv, warp_row0, lane);
    store_rows<D>(acc, scale, dq, base, lay.stride_r, row0, seq_len, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(kThr32)
attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         float* __restrict__ dk, float* __restrict__ dv, Layout lay, int window,
                         Dropout drop, float scale, float scale_log2) {
  constexpr int kTile = kStream * (D + 4);

  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + kRows * (D + 4);
  float* sqd = sv + kRows * (D + 4);  // buffer b: q at sqd + b * 2 tiles, dO one tile on
  float* srows = sqd + 4 * kTile;     // buffer b: lse[64] then dsum[64]

  const int seq_len = lay.seq_len;
  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kRows;  // key tile 0 sees every q tile: heaviest first
  const int64_t base = lay.base(bh);
  const int64_t row_base = (int64_t)bh * seq_len;
  const uint32_t seed = drop.program_seed(bh, lay.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 2;             // this warp's group: its half of the streamed tile
  const int warp_row0 = (warp & 3) * 16;  // this warp's first key of the tile
  const int key0 = c0 + warp_row0;        // and of the sequence

  // ops/attention_tiles.py::query_tile_range
  const int k_last = min(c0 + kRows, seq_len) - 1;
  const int q_last = window > 0 ? min(seq_len - 1, k_last + window - 1) : seq_len - 1;
  const int t_begin = c0 / kStream, t_end = q_last / kStream;

  load_tile_async<D, kThr32>(smem_u32(sk), k, base, lay.stride_r, c0, kRows, seq_len);
  load_tile_async<D, kThr32>(smem_u32(sv), v, base, lay.stride_r, c0, kRows, seq_len);
  load_tile_async<D, kThr32>(smem_u32(sqd), q, base, lay.stride_r, t_begin * kStream, kStream,
                           seq_len);
  load_tile_async<D, kThr32>(smem_u32(sqd + kTile), dout, base, lay.stride_r, t_begin * kStream,
                           kStream, seq_len);
  load_rows_async<kThr32>(smem_u32(srows), lse, row_base, t_begin * kStream, seq_len);
  load_rows_async<kThr32>(smem_u32(srows + kStream), dsum, row_base, t_begin * kStream, seq_len);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  tf32::zero(dk_acc);
  tf32::zero(dv_acc);

  for (int t = t_begin; t <= t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const float* sq = sqd + buf * 2 * kTile;
    const float* sdo = sq + kTile;
    const float* slse = srows + buf * 2 * kStream;
    const float* sdsum = slse + kStream;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t < t_end) {
      float* nq = sqd + (buf ^ 1) * 2 * kTile;
      float* nrows = srows + (buf ^ 1) * 2 * kStream;
      load_tile_async<D, kThr32>(smem_u32(nq), q, base, lay.stride_r, (t + 1) * kStream, kStream,
                               seq_len);
      load_tile_async<D, kThr32>(smem_u32(nq + kTile), dout, base, lay.stride_r,
                               (t + 1) * kStream, kStream, seq_len);
      load_rows_async<kThr32>(smem_u32(nrows), lse, row_base, (t + 1) * kStream, seq_len);
      load_rows_async<kThr32>(smem_u32(nrows + kStream), dsum, row_base, (t + 1) * kStream,
                            seq_len);
      cp_async_commit();
    }
    const int q0 = t * kStream;
    // ops/attention_tiles.py::tile_needs_mask, transposed: the diagonal, the
    // window's edge or the end of the sequence crosses this pair
    const bool edge = c0 + kRows - 1 > q0 || (window > 0 && q0 + kStream - 1 - c0 >= window) ||
                      q0 + kStream > seq_len;

    {
      // the transposed tiles: rows are this warp's keys, columns are q rows
      float st[kHalf / 8][4], dpt[kHalf / 8][4];
      tf32::zero(st);
      tf32::zero(dpt);
      product_nt2<D, kHalf>(st, dpt, sk, sv, warp_row0, sq, sdo, half * kHalf, lane);
      // p_v^T in place of st and ds^T in place of dpt: the A operands of
      // p_v^T dO and ds^T q
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = half * kHalf + frag_col(lane, n, e);
          const int qrow = q0 + qc;
          const int krow = key0 + frag_row(lane, e);
          float p = exp2f(fmaf(st[n][e], scale_log2, -slse[qc] * kLog2e));
          if (edge && (qrow >= seq_len || is_masked(qrow, krow, window))) p = 0.f;
          float p_v = p, dpe = dpt[n][e];
          if (drop.enabled) {
            // the transposed tile of the forward's mask: hash(query, key)
            const bool keep = dropout_keep(qrow, krow, seed, drop.threshold);
            p_v = keep ? p * drop.scale : 0.f;
            dpe = keep ? dpe * drop.scale : 0.f;
          }
          st[n][e] = p_v;
          dpt[n][e] = p * (dpe - sdsum[qc]);
        }
      product_pn<D, kHalf>(dv_acc, st, sdo, half * kHalf, lane);
      product_pn<D, kHalf>(dk_acc, dpt, sq, half * kHalf, lane);
    }
  }

  __syncthreads();  // every warp is done with the streamed tiles: group 1 parks there
  if (half == 1) {
    park<D>(sqd, warp_row0, dk_acc, lane);
    park<D>(sqd + kRows * (D + 4), warp_row0, dv_acc, lane);
  }
  __syncthreads();
  if (half == 0) {
    add_parked<D>(dk_acc, sqd, warp_row0, lane);
    add_parked<D>(dv_acc, sqd + kRows * (D + 4), warp_row0, lane);
    store_rows<D>(dk_acc, scale, dk, base, lay.stride_r, key0, seq_len, lane);
    store_rows<D>(dv_acc, 1.f, dv, base, lay.stride_r, key0, seq_len, lane);
  }
}

template <int D>
cudaError_t info(int pass, int* out) {
  if (pass == 0) return kernel_info(attention_bwd_dq_kernel<D>, kThr32, dq_smem_bytes<D>(), out);
  return kernel_info(attention_bwd_dkv_kernel<D>, kThr32, dkv_smem_bytes<D>(), out);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dsum, void* dq, void* dk, void* dv,
                   const Layout& lay, int window, const Dropout& drop, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid(lay.batch * lay.heads, (lay.seq_len + kRows - 1) / kRows);
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdsum = static_cast<const float*>(dsum);

  auto dq_kernel = attention_bwd_dq_kernel<D>;
  constexpr size_t dq_smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThr32, dq_smem, stream>>>(tq, tk, tv, tdo, flse, fdsum,
                                             static_cast<float*>(dq), lay, window, drop, scale,
                                             scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = attention_bwd_dkv_kernel<D>;
  constexpr size_t dkv_smem = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThr32, dkv_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<float*>(dk), static_cast<float*>(dv), lay,
      window, drop, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc32

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
                                    int heads_total, int head0, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlock - 1) / kBlock > 65535 || head0 < 0 || head0 > heads_total - heads)
    return (int)cudaErrorInvalidValue;
  const Layout lay{batch, heads, seq_len, stride_b, stride_h, stride_r};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale, heads_total, head0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  // 16-byte copies: 16-byte-aligned pointers, rows of whole 16-byte chunks
  // (4 fp32 or 8 bf16 elements)
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq) &&
        aligned16(dk) && aligned16(dv)) ||
      ((stride_b | stride_h | stride_r) & (dtype == 0 ? 3 : 7)) != 0)
    return (int)cudaErrorMisalignedAddress;
#define DALLE_BWD(LAUNCH, D) \
  LAUNCH<D>(q, k, v, dout, lse, dsum, dq, dk, dv, lay, window, drop, s)
  if (dtype == 0 && head_dim == 64) return (int)DALLE_BWD(tc32::launch, 64);
  if (dtype == 0 && head_dim == 128) return (int)DALLE_BWD(tc32::launch, 128);
  if (head_dim == 64) return (int)DALLE_BWD(launch_mma, 64);
  if (head_dim == 128) return (int)DALLE_BWD(launch_mma, 128);
#undef DALLE_BWD
  return (int)cudaErrorInvalidValue;
}

// out[0..4) = registers a thread, local (spill) bytes a thread, dynamic
// shared memory a CTA, CTAs an SM, of a backward kernel (pass 0: dQ, 1:
// dK/dV) for head_dim and dtype (0 = float32, 1 = bfloat16).
extern "C" int causal_attention_bwd_info(int pass, int head_dim, int dtype, int* out) {
  if (pass != 0 && pass != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return (int)tc32::info<64>(pass, out);
  if (dtype == 0 && head_dim == 128) return (int)tc32::info<128>(pass, out);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (head_dim == 64) return (int)info<64>(pass, out);
  if (head_dim == 128) return (int)info<128>(pass, out);
  return (int)cudaErrorInvalidValue;
}
