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
// keys on (row0 + r, col0 + c, Dropout::program_seed), the bits of
// dalle_mtf_tpu/ops/attention.py::_dropout_keep, the same in both kernels:
// the launch's heads are heads [head0, head0 + heads) of heads_total (a
// tensor-parallel rank's block), so program bh = b * heads + h hashes with
// seed + b * heads_total + head0 + h, the mask one launch over every head
// draws on them (heads_total = heads, head0 = 0: seed + bh).
//
// ring_partial: num = sum_c exp(s - m) p_v v (unnormalised, fp32), m the row
// max of the masked scores, l = sum_c exp(s - m) over the UNdropped weights;
// one value per row (the TPU kernel replicated m and l over 128 lanes). p_v
// is rounded to the input dtype before the product with v, where the TPU
// kernel casts it for the MXU. One CTA per (b*h, q tile) runs an online
// softmax over only the key tiles that hold a live key for one of its rows:
// [q0 + diff - window + 1, q_last + diff], clamped to [0, Sk). A row with no
// live key in this hop (only under a window) is written m = NEG_INF, l = the
// count of its visited keys below Sk and num = their sum of v (all zero when
// no tile is visited); the fold's beta = exp(NEG_INF - m) = 0 discards it,
// since every row's diagonal hop is live and folds first.
//
// ring_block_grads, from the forward's fp32 lse and dsum = rowsum(dO * O):
//   p = masked ? 0 : exp(s * D^-0.5 - lse); dp = dO v^T (dropout-masked and
//   scaled); ds = p (dp - dsum) rounded to the input dtype;
//   dq = ds k * D^-0.5 in the input dtype; dk += ds^T q * D^-0.5 and
//   dv += p_v^T dO in fp32, p_v rounded to the input dtype.
// Two launches, no atomics: dQ, one CTA per (b*h, q tile) over the live key
// tiles; dK/dV, one CTA per (b*h, key tile) over the q tiles that can see it,
// [c0 - diff, k_last - diff + window - 1]. A dK/dV CTA owns its key rows, so
// it adds into dk_acc and dv_acc in place, one read and one write of each
// element a launch, and no other CTA writes there: two identical calls
// double the accumulators bit for bit.
//
// The tile walk (which key tiles a q tile visits, which q tiles a key tile
// visits, which tiles need the mask) is written once in Python, in
// dalle_mtf_tpu_torch/ops/attention_tiles.py: ring_key_tile_range,
// ring_query_tile_range and ring_tile_needs_mask, with
// ring_partial_tiled_reference and ring_block_grads_tiled_reference as the
// plain versions of the walk. Those functions are the definition; the CPU
// tests hold them against the dense mask, the one-shot plain versions and the
// JAX package, and the kernels' results on the card against the one-shot
// plain versions at the same edge cases.
//
// Two instantiations behind each entry point:
//   - bfloat16: the tensor-core kernels (namespace tc), built from the pieces
//     of attention_mma.cuh that the causal pair uses;
//   - float32: on the tensor cores too (namespace tc32, the design of the
//     causal pair's fp32 kernels: the three-product TF32 split of
//     attention_tf32.cuh, which holds the fp32 callers' 1e-5 where one TF32
//     product cannot, each k step summed apart; fp32 tiles padded to D + 4
//     words; two groups of four warps, one a half of every streamed tile,
//     combined in one fixed order at the end: in ring_partial each group runs
//     its own online softmax and tf32::merge_halves rescales the two to the
//     common max, so the dead-row convention holds across the halves; num,
//     dq written and the accumulators added in fp32 from the C fragments, one
//     add an element a launch).
//
// What bounds them. At the ring slice's shapes (B*H = 32, Sq = Sk = 1088,
// D = 128, bf16) a past hop is 37.9 M live pairs: 2 products of 2 D
// operations a pair forward (19.4 GFLOP, 0.0196 ms at the tensor cores' 989
// TFLOP/s) and 5 backward (48.5 GFLOP, 0.049 ms); the bytes (q, k, v, dO
// read once, num and the accumulators in fp32) take 0.013 ms forward and
// 0.035 ms backward at 3.35 TB/s. So a past hop is bound by the operations
// at the bf16 tensor-core rate; the diagonal hop, with half the pairs, by
// its bytes.
//
// The bf16 design, that of the causal pair (causal_attention_fwd.cu,
// causal_attention_bwd.cu):
//   - Forward: one CTA of 4 warps per (b*h, 64-row q tile), a warp owning 16
//     q rows. The causal forward takes 128-row tiles (two 16-row blocks a
//     warp) when they give every SM a CTA, and the ring shard's 32 x 9 = 288
//     would; but on an H100 the 64-row tile measured faster at every hop of
//     the ring shard (card time, past hop 0.110 against 0.119 ms, diagonal
//     0.051 against 0.067): 288 equal CTAs on 264 slots leave a second wave
//     9% full, and the 128-row build spills. So only 64 rows are built.
//     K and V tiles double-buffered by cp.async into swizzled bf16 tiles;
//     S = q k^T and p_v V by mma.sync.m16n8k16 with ldmatrix, P kept in
//     registers as the A operand of the second product; an online softmax in
//     the log2 domain (exp2 with log2 e folded into the scale) from the finite
//     NEG_INF, m converted at the store (m2 ln 2, NEG_INF itself for a row
//     that saw no live key). The mask runs only on tiles the diagonal
//     (c0 + 63 - q0 > diff), the window's edge or the ragged key end crosses:
//     at a past hop (diff = Sk, no window) no tile. num is written in fp32
//     straight from the C fragments, 8-byte stores, a quad's four lanes on 32
//     contiguous bytes of a row.
//   - Backward: a dQ launch and a dK/dV launch, 4 warps of 16 owner rows (64:
//     the causal backward measured 15-20% slower with 128), the streamed
//     tile taken in two halves of 32 columns. dQ computes S = q k^T and
//     dP = dO v^T, ds in registers as the A operand of ds K, and writes dq in
//     bf16 through the warp's own q rows in shared memory with 16-byte
//     stores. dK/dV computes S^T = k q^T and dP^T = v dO^T, so p_v^T and ds^T
//     come out in A-operand order for p_v^T dO and ds^T q; lse and dsum come
//     in by 4-byte cp.async; it reads, adds and writes the fp32 dk_acc and
//     dv_acc rows it owns from its fp32 C fragments (never through bf16).
//     Both take p = exp2(s D^-0.5 log2 e - lse log2 e); the dK/dV mask also
//     covers ragged q rows.
// What holds them below the bound, counted as for the causal pair: mma.sync
// reaches about two thirds of wgmma's rate; a warp's 16 rows use each B
// fragment read from shared memory for two products only (one ldmatrix.x4 of
// 512 bytes for every two mma), so shared memory caps the SM near half the
// tensor cores' peak; the two backward passes run seven tile products where
// five are needed (S and dP in both); two CTAs of four warps an SM leave two
// warps a scheduler (the D = 128 kernels),
// so little of the exp2, the shuffles and the hash hides behind another
// warp's products; and at the ring shard's size each of the three grids is
// 544 CTAs on 264 slots, so its last wave is 6% full.
// Not wgmma: its 64-row tile a warpgroup fixes the owner tile, needs
// descriptors for the transposed V, q and dO operands, and the score tile
// would not stay in registers as the next product's A operand in halves.
// Not TMA: its descriptor is made by cuTensorMapEncodeTiled, which a library
// with a plain C interface does not link, and cp.async already hides the
// loads.
// Registers a thread, shared memory a CTA, CTAs an SM, as nvcc builds them
// for sm_90a: D = 128: forward 168, 80 KB, 2; dQ 176, 96 KB, 2; dK/dV 254,
// 97 KB, 2 (no spills). D = 64: forward 127, 40 KB, 4; dQ 130, 48 KB, 3;
// dK/dV 168, 49 KB, 3. The fp32 dQ and dK/dV kernels (eight warps): D = 128
// 199 and 255 registers (128 bytes spilled), 203 KB, 1; D = 64 143 and 187,
// 104 KB, 1. The fp32 forward (eight warps, the q tile split once as in
// causal_attention_fwd.cu's): D = 128 160 registers, 203 KB, 1; D = 64 144,
// 104 KB, 1; no spills. Its bound: the operations, three TF32 products for
// each of the two (494.7 TFLOP/s dense); at the ring shard's past hop its
// 544 equal CTAs on 132 single-CTA SMs leave a fifth wave 12% full.
// ring_attention_info reports them from the built kernels (chip_smoke.py
// prints the "resources" line).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"
#include "attention_tf32.cuh"

using namespace dalle_attn;

namespace {

// The global hop: local sizes, the offsets and the window, and the heads a
// batch row holds in this launch (program bh = b * heads + h).
struct Hop {
  int s_q, s_k;
  int diff, row0, col0, window;
  int heads;
  // the causal and window bands (the kernels test the shard ends apart)
  __device__ __forceinline__ bool band_masked(int r, int c) const {
    return c - r > diff || (window > 0 && (r - c) + diff >= window);
  }
  // ops/attention_tiles.py::ring_tile_needs_mask: whether rows [q0, q0 +
  // q_rows) and keys [c0, c0 + k_rows) may hold a masked pair
  __device__ __forceinline__ bool crosses(int q0, int q_rows, int c0, int k_rows,
                                          bool ragged_rows) const {
    return c0 + k_rows - 1 - q0 > diff || (window > 0 && q0 + q_rows - 1 - c0 + diff >= window) ||
           c0 + k_rows > s_k || (ragged_rows && q0 + q_rows > s_q);
  }
};

// Key tiles [*t_begin, *t_end] holding a live key for local rows [q0, q_last]
// (ops/attention_tiles.py::ring_key_tile_range).
__device__ __forceinline__ void key_tiles(const Hop& hop, int q0, int q_last, int* t_begin,
                                          int* t_end) {
  const int c_hi = min(hop.s_k - 1, q_last + hop.diff);
  const int c_lo = hop.window > 0 ? max(0, q0 + hop.diff - hop.window + 1) : 0;
  *t_begin = c_lo / kBlock;
  *t_end = c_hi < c_lo ? *t_begin - 1 : c_hi / kBlock;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int bh, int s_q, int s_k, int heads, int heads_total, int head0) {
  return bh <= 0 || s_q <= 0 || s_k <= 0 || (s_q + kBlock - 1) / kBlock > 65535 ||
         (s_k + kBlock - 1) / kBlock > 65535 || heads <= 0 || bh % heads != 0 || head0 < 0 ||
         head0 > heads_total - heads;
}

// ------------------------------------------- bf16: the tensor-core kernels

namespace tc {

using bf16 = __nv_bfloat16;
using namespace dalle_attn::mma;

constexpr int kWarps = 4;            // a CTA: 4 warps, each owning 16 rows
constexpr int kThr = kWarps * 32;
constexpr int kOwner = kWarps * 16;  // rows of the owner tile (q, or keys in dK/dV)
constexpr int kHalf = 32;            // backward: score columns taken at once

template <int D>
constexpr size_t fwd_smem_bytes() {
  // the q tile, and two buffers of a k and a v tile, bf16
  return (size_t)(kOwner + 4 * kStream) * D * 2;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO owner tiles, two buffers of a k and a v tile, bf16
  return (size_t)(2 * kOwner + 4 * kStream) * D * 2;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k and v owner tiles, two buffers of a q and a dO tile, bf16; two buffers
  // of lse and dsum, fp32
  return (size_t)(2 * kOwner + 4 * kStream) * D * 2 + 4 * kStream * sizeof(float);
}

// Two fp32 values added into dst[0..2) (8-byte aligned), one read and one
// write each: the rotating accumulators' update, no atomics.
__device__ __forceinline__ void add_pair(float* dst, float a, float b) {
  float2 x = *reinterpret_cast<float2*>(dst);
  x.x += a;
  x.y += b;
  *reinterpret_cast<float2*>(dst) = x;
}

template <int D>
__global__ void __launch_bounds__(kThr)
ring_partial_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, float* __restrict__ num,
                        float* __restrict__ m_out, float* __restrict__ l_out, Hop hop,
                        Dropout drop, float scale_log2) {
  constexpr uint32_t kTileBytes = kStream * D * 2;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sq = smem_u32(smem_raw);
  const uint32_t skv = sq + kOwner * D * 2;  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwner;  // deepest tiles first
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const uint32_t seed = drop.program_seed(bh, hop.heads);  // wrapping, as XLA's int32 add
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_row0 = warp * 16;  // this warp's first row of the tile
  const int row0 = q0 + warp_row0;  // and of the local shard

  int t_begin, t_end;  // ops/attention_tiles.py::ring_key_tile_range
  key_tiles(hop, q0, min(q0 + kOwner, hop.s_q) - 1, &t_begin, &t_end);

  load_tile_async<D, kThr>(sq, q, q_base, D, q0, kOwner, hop.s_q);
  if (t_begin <= t_end) {
    load_tile_async<D, kThr>(skv, k, k_base, D, t_begin * kStream, kStream, hop.s_k);
    load_tile_async<D, kThr>(skv + kTileBytes, v, k_base, D, t_begin * kStream, kStream,
                             hop.s_k);
  }
  cp_async_commit();

  float acc[1][D / 8][4];
  // rows g (index 0) and g + 8 (index 1) of the warp's 16, in the log2 domain
  // (scores times D^-0.5 log2 e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(acc);

  for (int t = t_begin; t <= t_end; ++t) {
    const uint32_t sk = skv + ((t - t_begin) & 1) * 2 * kTileBytes;
    const uint32_t sv = sk + kTileBytes;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t < t_end) {
      const uint32_t nk = skv + ((t + 1 - t_begin) & 1) * 2 * kTileBytes;
      load_tile_async<D, kThr>(nk, k, k_base, D, (t + 1) * kStream, kStream, hop.s_k);
      load_tile_async<D, kThr>(nk + kTileBytes, v, k_base, D, (t + 1) * kStream, kStream,
                               hop.s_k);
      cp_async_commit();
    }

    float s[1][kStream / 8][4];
    zero(s);
    product_nt<D, kStream, 1>(s, sq, warp_row0, sk, 0, lane);

    const int c0 = t * kStream;
    // ops/attention_tiles.py::ring_tile_needs_mask
    const bool edge = hop.crosses(q0, kOwner, c0, kStream, false);
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kStream / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[0][n][e] * scale_log2;
        if (edge) {
          const int r = row0 + frag_row(lane, e), c = c0 + frag_col(lane, n, e);
          // a key beyond Sk is no key at all: p = exp2(-inf) = 0 even in a
          // row whose max is still NEG_INF, so it adds nothing to l
          if (c >= hop.s_k) x = __int_as_float(0xff800000);  // -inf
          else if (hop.band_masked(r, c)) x = kNegInf;
        }
        s[0][n][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a quad hold one row
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }

    uint32_t p[1][kStream / 16][4];
    float p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kStream / 8; ++n) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[0][n][e] - m[e >> 1]);
        p_sum[e >> 1] += pe;  // the normalizer of the UNdropped weights
        pv[e] = pe;
        if (drop.enabled)
          pv[e] = dropout_keep(hop.row0 + row0 + frag_row(lane, e),
                               hop.col0 + c0 + frag_col(lane, n, e), seed, drop.threshold)
                      ? pe * drop.scale
                      : 0.f;
      }
      // C fragments 2j and 2j + 1 are the A fragment of key step j
      p[0][n >> 1][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
      p[0][n >> 1][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 1);
      p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 2);
      l[r] = l[r] * alpha[r] + p_sum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[0][n][0] *= alpha[0];
      acc[0][n][1] *= alpha[0];
      acc[0][n][2] *= alpha[1];
      acc[0][n][3] *= alpha[1];
    }
    product_pn<D, kStream, 1>(acc, p, sv, 0, lane);
  }
  cp_async_wait<0>();  // nothing left in flight when the CTA ends (no tile: the q load)

  // num in fp32 straight from the C fragments: a quad's 4 lanes write 32
  // contiguous bytes of a row, 8-byte stores; m in the natural log domain,
  // a row that saw no live key keeps m = NEG_INF itself
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    if (row >= hop.s_q) continue;
    float* nrow = num + q_base + (int64_t)row * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(nrow + frag_col(lane, n, 0)) =
          make_float2(acc[0][n][2 * r], acc[0][n][2 * r + 1]);
    if ((lane & 3) == 0) {
      m_out[(int64_t)bh * hop.s_q + row] = m[r] == kNegInf ? kNegInf : m[r] * kLn2;
      l_out[(int64_t)bh * hop.s_q + row] = l[r];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThr)
ring_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   bf16* __restrict__ dq, Hop hop, Dropout drop, float scale, float scale_log2) {
  constexpr uint32_t kTileBytes = kStream * D * 2;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sq = smem_u32(smem_raw);
  const uint32_t sdo = sq + kOwner * D * 2;
  const uint32_t skv = sdo + kOwner * D * 2;  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwner;  // deepest tiles first
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const uint32_t seed = drop.program_seed(bh, hop.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_row0 = warp * 16;  // this warp's first row of the tile
  const int row0 = q0 + warp_row0;  // and of the local shard

  int t_begin, t_end;  // ops/attention_tiles.py::ring_key_tile_range
  key_tiles(hop, q0, min(q0 + kOwner, hop.s_q) - 1, &t_begin, &t_end);

  load_tile_async<D, kThr>(sq, q, q_base, D, q0, kOwner, hop.s_q);
  load_tile_async<D, kThr>(sdo, dout, q_base, D, q0, kOwner, hop.s_q);
  if (t_begin <= t_end) {
    load_tile_async<D, kThr>(skv, k, k_base, D, t_begin * kStream, kStream, hop.s_k);
    load_tile_async<D, kThr>(skv + kTileBytes, v, k_base, D, t_begin * kStream, kStream,
                             hop.s_k);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: lse in the log2 domain, and dsum
  float lse2[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    const int64_t at = (int64_t)bh * hop.s_q + row;
    lse2[r] = row < hop.s_q ? lse[at] * kLog2e : 0.f;
    dsum_r[r] = row < hop.s_q ? dsum[at] : 0.f;
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
      load_tile_async<D, kThr>(nk, k, k_base, D, (t + 1) * kStream, kStream, hop.s_k);
      load_tile_async<D, kThr>(nk + kTileBytes, v, k_base, D, (t + 1) * kStream, kStream,
                               hop.s_k);
      cp_async_commit();
    }
    const int c0 = t * kStream;
    // ops/attention_tiles.py::ring_tile_needs_mask
    const bool edge = hop.crosses(q0, kOwner, c0, kStream, false);

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
          if (edge && (col >= hop.s_k || hop.band_masked(row, col))) p = 0.f;
          float dpe = dp[0][n][e];
          if (drop.enabled)
            dpe = dropout_keep(hop.row0 + row, hop.col0 + col, seed, drop.threshold)
                      ? dpe * drop.scale
                      : 0.f;
          dse[e] = p * (dpe - dsum_r[e >> 1]);
        }
        ds[0][n >> 1][(n & 1) * 2] = pack_bf16(dse[0], dse[1]);
        ds[0][n >> 1][(n & 1) * 2 + 1] = pack_bf16(dse[2], dse[3]);
      }
      product_pn<D, kHalf, 1>(acc, ds, sk, half * kHalf, lane);
    }
  }
  // with no key tile the q and dO copies may still be in flight; with some,
  // this is the last tile's wait again
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] *= scale;
  // the warp's q rows are read by this warp alone, and it is done with them
  store_warp_rows<D>(smem_raw, warp_row0, acc[0], dq, q_base, D, row0, hop.s_q, lane);
}

template <int D>
__global__ void __launch_bounds__(kThr)
ring_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    float* __restrict__ dk_acc, float* __restrict__ dv_acc, Hop hop,
                    Dropout drop, float scale, float scale_log2) {
  constexpr uint32_t kTileBytes = kStream * D * 2;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sk = smem_u32(smem_raw);
  const uint32_t sv = sk + kOwner * D * 2;
  const uint32_t sqd = sv + kOwner * D * 2;      // buffer b: q at sqd + b * 2 tiles, dO one on
  const uint32_t srows = sqd + 4 * kTileBytes;  // buffer b: lse[64] then dsum[64]
  const float* rows_f =
      reinterpret_cast<const float*>(smem_raw + 2 * kOwner * D * 2 + 4 * kTileBytes);

  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kOwner;
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const int64_t row_base = (int64_t)bh * hop.s_q;
  const uint32_t seed = drop.program_seed(bh, hop.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_row0 = warp * 16;  // this warp's first key of the tile
  const int key0 = c0 + warp_row0;  // and of the visiting shard

  // ops/attention_tiles.py::ring_query_tile_range: q rows that can see one of
  // keys [c0, k_last]: r >= c - diff, and under a window r <= c - diff + window - 1
  const int k_last = min(c0 + kOwner, hop.s_k) - 1;
  const int r_lo = max(0, c0 - hop.diff);
  const int r_hi = hop.window > 0 ? min(hop.s_q - 1, k_last - hop.diff + hop.window - 1)
                                  : hop.s_q - 1;
  if (r_hi < r_lo) return;  // nothing to add: the accumulators keep their values
  const int t_begin = r_lo / kStream, t_end = r_hi / kStream;

  load_tile_async<D, kThr>(sk, k, k_base, D, c0, kOwner, hop.s_k);
  load_tile_async<D, kThr>(sv, v, k_base, D, c0, kOwner, hop.s_k);
  load_tile_async<D, kThr>(sqd, q, q_base, D, t_begin * kStream, kStream, hop.s_q);
  load_tile_async<D, kThr>(sqd + kTileBytes, dout, q_base, D, t_begin * kStream, kStream,
                           hop.s_q);
  load_rows_async<kThr>(srows, lse, row_base, t_begin * kStream, hop.s_q);
  load_rows_async<kThr>(srows + kStream * 4, dsum, row_base, t_begin * kStream, hop.s_q);
  cp_async_commit();

  float dk[1][D / 8][4], dv[1][D / 8][4];
  zero(dk);
  zero(dv);

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
      load_tile_async<D, kThr>(nq, q, q_base, D, (t + 1) * kStream, kStream, hop.s_q);
      load_tile_async<D, kThr>(nq + kTileBytes, dout, q_base, D, (t + 1) * kStream, kStream,
                               hop.s_q);
      load_rows_async<kThr>(nrows, lse, row_base, (t + 1) * kStream, hop.s_q);
      load_rows_async<kThr>(nrows + kStream * 4, dsum, row_base, (t + 1) * kStream, hop.s_q);
      cp_async_commit();
    }
    const int q0 = t * kStream;
    // ops/attention_tiles.py::ring_tile_needs_mask with ragged_rows: the
    // diagonal, the window's edge, the key end or the end of the q shard
    const bool edge = hop.crosses(q0, kStream, c0, kOwner, true);

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
          if (edge && (qrow >= hop.s_q || krow >= hop.s_k || hop.band_masked(qrow, krow)))
            p = 0.f;
          float p_v = p, dpe = dpt[0][n][e];
          if (drop.enabled) {
            // the transposed tile of the forward's mask: hash(query, key)
            const bool keep =
                dropout_keep(hop.row0 + qrow, hop.col0 + krow, seed, drop.threshold);
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
      product_pn<D, kHalf, 1>(dv, pv, sdo, half * kHalf, lane);
      product_pn<D, kHalf, 1>(dk, ds, sq, half * kHalf, lane);
    }
  }

  // this CTA alone owns keys [c0, c0 + 64) of this head: read, add, write the
  // fp32 accumulators from the fp32 C fragments (never through bf16)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = key0 + (lane >> 2) + r * 8;
    if (krow >= hop.s_k) continue;
    const int64_t off = k_base + (int64_t)krow * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = frag_col(lane, n, 0);
      add_pair(dk_acc + off + col, dk[0][n][2 * r] * scale, dk[0][n][2 * r + 1] * scale);
      add_pair(dv_acc + off + col, dv[0][n][2 * r], dv[0][n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_partial(const void* q, const void* k, const void* v, void* num, void* m,
                           void* l, int bh, const Hop& hop, const Dropout& drop,
                           cudaStream_t stream) {
  auto kernel = ring_partial_mma_kernel<D>;
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (hop.s_q + kOwner - 1) / kOwner);
  kernel<<<grid, kThr, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(num), static_cast<float*>(m), static_cast<float*>(l), hop, drop,
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_grads(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dsum, void* dq, void* dk_acc,
                         void* dv_acc, int bh, const Hop& hop, const Dropout& drop,
                         cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdsum = static_cast<const float*>(dsum);

  auto dq_kernel = ring_dq_mma_kernel<D>;
  cudaError_t err = set_smem(dq_kernel, dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(bh, (hop.s_q + kOwner - 1) / kOwner), kThr, dq_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<bf16*>(dq), hop, drop, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = ring_dkv_mma_kernel<D>;
  err = set_smem(dkv_kernel, dkv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(bh, (hop.s_k + kOwner - 1) / kOwner), kThr, dkv_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<float*>(dk_acc), static_cast<float*>(dv_acc),
      hop, drop, scale, scale * kLog2e);
  return cudaGetLastError();
}

// kind 0: the forward; 1: dQ; 2: dK/dV; all on 64-row owner tiles
template <int D>
cudaError_t info(int kind, int tile_rows, int* out) {
  if (tile_rows != kOwner) return cudaErrorInvalidValue;
  if (kind == 0) return kernel_info(ring_partial_mma_kernel<D>, kThr, fwd_smem_bytes<D>(), out);
  if (kind == 1) return kernel_info(ring_dq_mma_kernel<D>, kThr, dq_smem_bytes<D>(), out);
  if (kind == 2) return kernel_info(ring_dkv_mma_kernel<D>, kThr, dkv_smem_bytes<D>(), out);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------- fp32: 3xTF32 on the tensor cores

namespace tc32 {

using namespace dalle_attn::mma;
using namespace dalle_attn::tf32;
using tc::kHalf;
using tc::kOwner;

// Two groups of four warps: each warp owns 16 rows of the 64-row owner tile,
// and group h takes columns [32 h, 32 h + 32) of every streamed tile.
constexpr int kThr = 2 * tc::kThr;

template <int D>
constexpr size_t fwd_smem_bytes() {
  // the q tile split in two (big, small), and two buffers of a k and a v
  // tile, padded fp32
  return (size_t)tile_bytes<D>(2 * kOwner + 4 * kStream);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO owner tiles, two buffers of a k and a v tile, padded fp32
  return (size_t)tile_bytes<D>(2 * kOwner + 4 * kStream);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k and v owner tiles, two buffers of a q and a dO tile, padded fp32; two
  // buffers of lse and dsum
  return (size_t)tile_bytes<D>(2 * kOwner + 4 * kStream) + 4 * kStream * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThr)
ring_partial_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ num,
                    float* __restrict__ m_out, float* __restrict__ l_out, Hop hop, Dropout drop,
                    float scale_log2) {
  constexpr int kTile = kStream * (D + 4);  // words of a streamed tile

  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sq_small = sq + kOwner * (D + 4);   // sq holds q's big part once split
  float* skv = sq_small + kOwner * (D + 4);  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwner;  // deepest tiles first
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const uint32_t seed = drop.program_seed(bh, hop.heads);  // wrapping, as XLA's int32 add
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 2;             // this warp's group: its half of the streamed tile
  const int warp_row0 = (warp & 3) * 16;  // this warp's first row of the tile
  const int row0 = q0 + warp_row0;        // and of the local shard

  int t_begin, t_end;  // ops/attention_tiles.py::ring_key_tile_range
  key_tiles(hop, q0, min(q0 + kOwner, hop.s_q) - 1, &t_begin, &t_end);

  load_tile_async<D, kThr>(smem_u32(sq), q, q_base, D, q0, kOwner, hop.s_q);
  cp_async_commit();
  if (t_begin <= t_end) {
    load_tile_async<D, kThr>(smem_u32(skv), k, k_base, D, t_begin * kStream, kStream, hop.s_k);
    load_tile_async<D, kThr>(smem_u32(skv + kTile), v, k_base, D, t_begin * kStream, kStream,
                             hop.s_k);
  }
  cp_async_commit();  // (an empty group when no key tile is visited)
  cp_async_wait<1>();
  __syncthreads();  // q has landed (the first k and v tiles may still be in flight)
  split_tile<D, kThr>(sq, sq_small, kOwner);  // the loop's first __syncthreads orders it

  float acc[D / 8][4];
  // rows g (index 0) and g + 8 (index 1) of the warp's 16, this group's keys
  // only, in the log2 domain (scores times D^-0.5 log2 e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  tf32::zero(acc);

  for (int t = t_begin; t <= t_end; ++t) {
    const float* sk = skv + ((t - t_begin) & 1) * 2 * kTile;
    const float* sv = sk + kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t < t_end) {
      float* nk = skv + ((t + 1 - t_begin) & 1) * 2 * kTile;
      load_tile_async<D, kThr>(smem_u32(nk), k, k_base, D, (t + 1) * kStream, kStream, hop.s_k);
      load_tile_async<D, kThr>(smem_u32(nk + kTile), v, k_base, D, (t + 1) * kStream, kStream,
                               hop.s_k);
      cp_async_commit();
    }
    const int c0 = t * kStream;
    const int h0 = c0 + half * kHalf;  // this group's first key
    // ops/attention_tiles.py::ring_tile_needs_mask
    const bool edge = hop.crosses(q0, kOwner, c0, kStream, false);

    float s[kHalf / 8][4];
    tf32::zero(s);
    tf32::product_nt<D, kHalf, D / 8>(s, sq, sq_small, warp_row0, sk, half * kHalf, lane);
#pragma unroll
    for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale_log2;
        if (edge) {
          const int r = row0 + frag_row(lane, e), c = h0 + frag_col(lane, n, e);
          // a key beyond Sk is no key at all: p = exp2(-inf) = 0 even in a
          // row whose max is still NEG_INF, so it adds nothing to l
          if (c >= hop.s_k) s[n][e] = __int_as_float(0xff800000);  // -inf
          else if (hop.band_masked(r, c)) s[n][e] = kNegInf;
        }
      }
    softmax_step<D, kHalf>(s, m, l, acc, drop, [&](int n, int e) {
      return dropout_keep(hop.row0 + row0 + frag_row(lane, e), hop.col0 + h0 + frag_col(lane, n, e),
                          seed, drop.threshold);
    });
    tf32::product_pn<D, kHalf>(acc, s, sv, half * kHalf, lane);
  }
  __syncthreads();  // every warp is done with the streamed tiles: group 1 parks there
  merge_halves<D>(acc, m, l, skv, half, warp_row0, lane);
  if (half == 1) return;

  // num in fp32 straight from the C fragments (zero for a q tile that sees no
  // key tile); m in the natural log domain, a row that saw no live key keeps
  // m = NEG_INF itself
  store_rows<D>(acc, 1.f, num, q_base, D, row0, hop.s_q, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + r * 8;
      if (row >= hop.s_q) continue;
      m_out[(int64_t)bh * hop.s_q + row] = m[r] == kNegInf ? kNegInf : m[r] * kLn2;
      l_out[(int64_t)bh * hop.s_q + row] = l[r];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThr)
ring_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               float* __restrict__ dq, Hop hop, Dropout drop, float scale, float scale_log2) {
  constexpr int kTile = kStream * (D + 4);  // words of a streamed tile

  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sdo = sq + kOwner * (D + 4);
  float* skv = sdo + kOwner * (D + 4);  // buffer b: k at skv + b * 2 tiles, v one tile on

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwner;  // deepest tiles first
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const uint32_t seed = drop.program_seed(bh, hop.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 2;             // this warp's group: its half of the streamed tile
  const int warp_row0 = (warp & 3) * 16;  // this warp's first row of the tile
  const int row0 = q0 + warp_row0;        // and of the local shard

  int t_begin, t_end;  // ops/attention_tiles.py::ring_key_tile_range
  key_tiles(hop, q0, min(q0 + kOwner, hop.s_q) - 1, &t_begin, &t_end);

  load_tile_async<D, kThr>(smem_u32(sq), q, q_base, D, q0, kOwner, hop.s_q);
  load_tile_async<D, kThr>(smem_u32(sdo), dout, q_base, D, q0, kOwner, hop.s_q);
  if (t_begin <= t_end) {
    load_tile_async<D, kThr>(smem_u32(skv), k, k_base, D, t_begin * kStream, kStream, hop.s_k);
    load_tile_async<D, kThr>(smem_u32(skv + kTile), v, k_base, D, t_begin * kStream, kStream,
                             hop.s_k);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: lse in the log2 domain, and dsum
  float lse2[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    const int64_t at = (int64_t)bh * hop.s_q + row;
    lse2[r] = row < hop.s_q ? lse[at] * kLog2e : 0.f;
    dsum_r[r] = row < hop.s_q ? dsum[at] : 0.f;
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
      load_tile_async<D, kThr>(smem_u32(nk), k, k_base, D, (t + 1) * kStream, kStream, hop.s_k);
      load_tile_async<D, kThr>(smem_u32(nk + kTile), v, k_base, D, (t + 1) * kStream, kStream,
                               hop.s_k);
      cp_async_commit();
    }
    const int c0 = t * kStream;
    // ops/attention_tiles.py::ring_tile_needs_mask
    const bool edge = hop.crosses(q0, kOwner, c0, kStream, false);

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
          if (edge && (col >= hop.s_k || hop.band_masked(row, col))) p = 0.f;
          float dpe = dp[n][e];
          if (drop.enabled)
            dpe = dropout_keep(hop.row0 + row, hop.col0 + col, seed, drop.threshold)
                      ? dpe * drop.scale
                      : 0.f;
          s[n][e] = p * (dpe - dsum_r[e >> 1]);
        }
      product_pn<D, kHalf>(acc, s, sk, half * kHalf, lane);
    }
  }
  // with no key tile the q and dO copies may still be in flight (a CTA must
  // not end with a copy into its shared memory pending); with some, this is
  // the last tile's wait again
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the streamed tiles: group 1 parks there
  if (half == 1) park<D>(skv, warp_row0, acc, lane);
  __syncthreads();
  if (half == 1) return;
  add_parked<D>(acc, skv, warp_row0, lane);

  // dq in fp32 straight from the C fragments (zero for a q tile that sees no
  // key tile)
  store_rows<D>(acc, scale, dq, q_base, D, row0, hop.s_q, lane);
}

template <int D>
__global__ void __launch_bounds__(kThr)
ring_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dk_acc, float* __restrict__ dv_acc, Hop hop, Dropout drop,
                float scale, float scale_log2) {
  constexpr int kTile = kStream * (D + 4);

  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + kOwner * (D + 4);
  float* sqd = sv + kOwner * (D + 4);  // buffer b: q at sqd + b * 2 tiles, dO one tile on
  float* srows = sqd + 4 * kTile;      // buffer b: lse[64] then dsum[64]

  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kOwner;
  const int64_t q_base = (int64_t)bh * hop.s_q * D;
  const int64_t k_base = (int64_t)bh * hop.s_k * D;
  const int64_t row_base = (int64_t)bh * hop.s_q;
  const uint32_t seed = drop.program_seed(bh, hop.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 2;             // this warp's group: its half of the streamed tile
  const int warp_row0 = (warp & 3) * 16;  // this warp's first key of the tile
  const int key0 = c0 + warp_row0;        // and of the visiting shard

  // ops/attention_tiles.py::ring_query_tile_range: q rows that can see one of
  // keys [c0, k_last]: r >= c - diff, and under a window r <= c - diff + window - 1
  const int k_last = min(c0 + kOwner, hop.s_k) - 1;
  const int r_lo = max(0, c0 - hop.diff);
  const int r_hi = hop.window > 0 ? min(hop.s_q - 1, k_last - hop.diff + hop.window - 1)
                                  : hop.s_q - 1;
  if (r_hi < r_lo) return;  // nothing to add: the accumulators keep their values
  const int t_begin = r_lo / kStream, t_end = r_hi / kStream;

  load_tile_async<D, kThr>(smem_u32(sk), k, k_base, D, c0, kOwner, hop.s_k);
  load_tile_async<D, kThr>(smem_u32(sv), v, k_base, D, c0, kOwner, hop.s_k);
  load_tile_async<D, kThr>(smem_u32(sqd), q, q_base, D, t_begin * kStream, kStream, hop.s_q);
  load_tile_async<D, kThr>(smem_u32(sqd + kTile), dout, q_base, D, t_begin * kStream, kStream,
                           hop.s_q);
  load_rows_async<kThr>(smem_u32(srows), lse, row_base, t_begin * kStream, hop.s_q);
  load_rows_async<kThr>(smem_u32(srows + kStream), dsum, row_base, t_begin * kStream, hop.s_q);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
  tf32::zero(dk);
  tf32::zero(dv);

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
      load_tile_async<D, kThr>(smem_u32(nq), q, q_base, D, (t + 1) * kStream, kStream, hop.s_q);
      load_tile_async<D, kThr>(smem_u32(nq + kTile), dout, q_base, D, (t + 1) * kStream,
                               kStream, hop.s_q);
      load_rows_async<kThr>(smem_u32(nrows), lse, row_base, (t + 1) * kStream, hop.s_q);
      load_rows_async<kThr>(smem_u32(nrows + kStream), dsum, row_base, (t + 1) * kStream,
                            hop.s_q);
      cp_async_commit();
    }
    const int q0 = t * kStream;
    // ops/attention_tiles.py::ring_tile_needs_mask with ragged_rows: the
    // diagonal, the window's edge, the key end or the end of the q shard
    const bool edge = hop.crosses(q0, kStream, c0, kOwner, true);

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
          if (edge && (qrow >= hop.s_q || krow >= hop.s_k || hop.band_masked(qrow, krow)))
            p = 0.f;
          float p_v = p, dpe = dpt[n][e];
          if (drop.enabled) {
            // the transposed tile of the forward's mask: hash(query, key)
            const bool keep =
                dropout_keep(hop.row0 + qrow, hop.col0 + krow, seed, drop.threshold);
            p_v = keep ? p * drop.scale : 0.f;
            dpe = keep ? dpe * drop.scale : 0.f;
          }
          st[n][e] = p_v;
          dpt[n][e] = p * (dpe - sdsum[qc]);
        }
      product_pn<D, kHalf>(dv, st, sdo, half * kHalf, lane);
      product_pn<D, kHalf>(dk, dpt, sq, half * kHalf, lane);
    }
  }

  __syncthreads();  // every warp is done with the streamed tiles: group 1 parks there
  if (half == 1) {
    park<D>(sqd, warp_row0, dk, lane);
    park<D>(sqd + kOwner * (D + 4), warp_row0, dv, lane);
  }
  __syncthreads();
  if (half == 1) return;
  add_parked<D>(dk, sqd, warp_row0, lane);
  add_parked<D>(dv, sqd + kOwner * (D + 4), warp_row0, lane);

  // this CTA alone owns keys [c0, c0 + 64) of this head: read, add, write the
  // fp32 accumulators from the C fragments, one add an element a launch
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = key0 + (lane >> 2) + r * 8;
    if (krow >= hop.s_k) continue;
    const int64_t off = k_base + (int64_t)krow * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = frag_col(lane, n, 0);
      tc::add_pair(dk_acc + off + col, dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
      tc::add_pair(dv_acc + off + col, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_partial(const void* q, const void* k, const void* v, void* num, void* m,
                           void* l, int bh, const Hop& hop, const Dropout& drop,
                           cudaStream_t stream) {
  auto kernel = ring_partial_kernel<D>;
  cudaError_t err = set_smem(kernel, fwd_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, (hop.s_q + kOwner - 1) / kOwner), kThr, fwd_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(num), static_cast<float*>(m), static_cast<float*>(l), hop, drop,
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_grads(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dsum, void* dq, void* dk_acc,
                         void* dv_acc, int bh, const Hop& hop, const Dropout& drop,
                         cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdsum = static_cast<const float*>(dsum);

  auto dq_kernel = ring_dq_kernel<D>;
  cudaError_t err = set_smem(dq_kernel, dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(bh, (hop.s_q + kOwner - 1) / kOwner), kThr, dq_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<float*>(dq), hop, drop, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = ring_dkv_kernel<D>;
  err = set_smem(dkv_kernel, dkv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(bh, (hop.s_k + kOwner - 1) / kOwner), kThr, dkv_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, flse, fdsum, static_cast<float*>(dk_acc), static_cast<float*>(dv_acc),
      hop, drop, scale, scale * kLog2e);
  return cudaGetLastError();
}

// kind 0: the forward; 1: dQ; 2: dK/dV; all on 64-row owner tiles
template <int D>
cudaError_t info(int kind, int tile_rows, int* out) {
  if (tile_rows != kOwner) return cudaErrorInvalidValue;
  if (kind == 0) return kernel_info(ring_partial_kernel<D>, kThr, fwd_smem_bytes<D>(), out);
  if (kind == 1) return kernel_info(ring_dq_kernel<D>, kThr, dq_smem_bytes<D>(), out);
  if (kind == 2) return kernel_info(ring_dkv_kernel<D>, kThr, dkv_smem_bytes<D>(), out);
  return cudaErrorInvalidValue;
}

}  // namespace tc32

// 8-byte accesses (the fp32 outputs the bf16 kernels write by pairs)
bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

}  // namespace

// q [bh, s_q, head_dim], k and v [bh, s_k, head_dim], contiguous, of one
// dtype (0 = float32, 1 = bfloat16, pointers 16-byte aligned). Writes num
// fp32 [bh, s_q, head_dim] (8-byte aligned) and m, l fp32 [bh, s_q].
// diff = row0 - col0; window <= 0: no local window. dropout != 0 enables the
// hash dropout (keep when hash >> 8 < keep_threshold, kept weights times
// keep_scale). The bh programs are (b, h) of bh / heads batch rows by heads
// heads, which are heads [head0, head0 + heads) of heads_total for the
// hash (Dropout::program_seed; heads_total = heads, head0 = 0 for a launch
// over every head); a block that does not lie in heads_total, or heads that
// do not divide bh, are refused. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ring_partial(const void* q, const void* k, const void* v, void* num, void* m,
                            void* l, int bh, int s_q, int s_k, int head_dim, int dtype,
                            int diff, int row0, int col0, int window, int dropout,
                            unsigned int seed, unsigned int keep_threshold, float keep_scale,
                            int heads, int heads_total, int head0, void* stream) {
  if (bad_shape(bh, s_q, s_k, heads, heads_total, head0)) return (int)cudaErrorInvalidValue;
  const Hop hop{s_q, s_k, diff, row0, col0, window, heads};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale, heads_total, head0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!(mma::aligned16(q) && mma::aligned16(k) && mma::aligned16(v) && aligned8(num)))
    return (int)cudaErrorMisalignedAddress;
#define DALLE_RING_FWD(NS, D) NS::launch_partial<D>(q, k, v, num, m, l, bh, hop, drop, s)
  if (dtype == 0 && head_dim == 64) return (int)DALLE_RING_FWD(tc32, 64);
  if (dtype == 0 && head_dim == 128) return (int)DALLE_RING_FWD(tc32, 128);
  if (head_dim == 64) return (int)DALLE_RING_FWD(tc, 64);
  if (head_dim == 128) return (int)DALLE_RING_FWD(tc, 128);
#undef DALLE_RING_FWD
  return (int)cudaErrorInvalidValue;
}

// q, dout [bh, s_q, head_dim], k, v [bh, s_k, head_dim] of one dtype, 16-byte
// aligned; lse and dsum fp32 [bh, s_q]; writes dq [bh, s_q, head_dim] in the
// input dtype (16-byte aligned) and ADDS into dk_acc, dv_acc fp32 [bh, s_k,
// head_dim] (8-byte aligned). Other arguments as in ring_partial. Returns the
// first cudaError_t of the two launches.
extern "C" int ring_block_grads(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* dsum,
                                void* dq, void* dk_acc, void* dv_acc, int bh, int s_q,
                                int s_k, int head_dim, int dtype, int diff, int row0,
                                int col0, int window, int dropout, unsigned int seed,
                                unsigned int keep_threshold, float keep_scale, int heads,
                                int heads_total, int head0, void* stream) {
  if (bad_shape(bh, s_q, s_k, heads, heads_total, head0)) return (int)cudaErrorInvalidValue;
  const Hop hop{s_q, s_k, diff, row0, col0, window, heads};
  const Dropout drop{dropout != 0, seed, keep_threshold, keep_scale, heads_total, head0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!(mma::aligned16(q) && mma::aligned16(k) && mma::aligned16(v) && mma::aligned16(dout) &&
        mma::aligned16(dq) && aligned8(dk_acc) && aligned8(dv_acc)))
    return (int)cudaErrorMisalignedAddress;
#define DALLE_RING_BWD(NS, D) \
  NS::launch_grads<D>(q, k, v, dout, lse, dsum, dq, dk_acc, dv_acc, bh, hop, drop, s)
  if (dtype == 0 && head_dim == 64) return (int)DALLE_RING_BWD(tc32, 64);
  if (dtype == 0 && head_dim == 128) return (int)DALLE_RING_BWD(tc32, 128);
  if (head_dim == 64) return (int)DALLE_RING_BWD(tc, 64);
  if (head_dim == 128) return (int)DALLE_RING_BWD(tc, 128);
#undef DALLE_RING_BWD
  return (int)cudaErrorInvalidValue;
}

// out[0..4) = registers a thread, local (spill) bytes a thread, dynamic
// shared memory a CTA, CTAs an SM, of a ring kernel on the tensor cores: kind
// 0 the forward, 1 the dQ and 2 the dK/dV kernel, of dtype 0
// (float32) or 1 (bfloat16), each built for tile_rows = 64 owner rows only
// (any other value is refused).
extern "C" int ring_attention_info(int kind, int head_dim, int tile_rows, int dtype, int* out) {
  if (dtype == 0 && head_dim == 64) return (int)tc32::info<64>(kind, tile_rows, out);
  if (dtype == 0 && head_dim == 128) return (int)tc32::info<128>(kind, tile_rows, out);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (head_dim == 64) return (int)tc::info<64>(kind, tile_rows, out);
  if (head_dim == 128) return (int)tc::info<128>(kind, tile_rows, out);
  return (int)cudaErrorInvalidValue;
}
