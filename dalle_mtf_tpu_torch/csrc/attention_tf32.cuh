// Tensor-core pieces for the fp32 attention kernels (the causal pair's in
// causal_attention_fwd.cu and causal_attention_bwd.cu, the ring pair's in
// ring_attention.cu): fp32 tiles in shared memory with padded rows, 16-byte
// cp.async copies, the three-product TF32 split, mma.sync.m16n8k8 wrappers,
// the warp-level tile products, the forward's online-softmax step and the
// merge of two warp groups. The kernels keep the structure of the bf16 ones
// (attention_mma.cuh): a warp owns 16 rows of a 64-row owner tile and the
// same tile walk, the streamed tiles are double-buffered, scores, P and dS
// stay in registers, and the C fragment of m16n8k8 has the layout of
// m16n8k16's, so frag_row / frag_col, the masks and the dropout hash carry
// over unchanged. One difference: fp32 tiles take twice the bytes, so at
// D = 128 one CTA fills an SM's shared memory (203 KB), and a CTA of four
// warps left one warp a scheduler; a CTA runs two groups of four warps
// instead, each taking one 32-column half of every streamed tile, and
// combines the two groups' results in one fixed order at the end (park,
// add_parked; the forward's merge_halves, which also rescales each group to
// the common running max).
//
// The split. One TF32 product keeps 10 mantissa bits, about 2^-11 relative,
// far outside the fp32 callers' 1e-5. Each operand x is split into
// big = tf32(x) and small = tf32(x - big) (nearest with ties away, the
// rounding of cvt.rna.tf32.f32: to_tf32; x - big is exact in fp32), and a b
// is taken as
// a_small b_big + a_big b_small + a_big b_big, three mma.sync into one fp32
// accumulator: the dropped small·small term is about 2^-22 of the product.
// ops/attention_tiles.py::split_matmul is this arithmetic in torch, with the
// tensor cores' truncating accumulation (add_part below); the CPU tests hold
// it to the kernels' bound (each 64-long tile within 1e-5 of its own max
// |plain|) and show that one TF32 product, or one accumulator down a long
// sum, fails it.
//
// Geometry (g = lane / 4, t = lane % 4), mma.sync.m16n8k8 tf32:
//   A (16 x 8): a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4),
//               a[3] = (g + 8, t + 4)
//   B (8 x 8):  b0 = (k = t, n = g), b1 = (k = t + 4, n = g)
//   C (16 x 8): c[0], c[1] = (g, 2t), (g, 2t + 1); c[2], c[3] = (g + 8, 2t),
//               (g + 8, 2t + 1)
// A score tile's C fragment n becomes the A fragment of key step n of the
// next product as {c[0], c[2], c[1], c[3]}: the step's 8 keys are taken in
// the order 0, 2, 4, 6, 1, 3, 5, 7, so B's rows b0 and b1 are keys 2t and
// 2t + 1. A sum over k does not care about its order; no shuffle is needed.
//
// Shared memory. ldmatrix moves 16-bit elements only, so fragments come from
// plain 32-bit loads. A tile row is D fp32 words padded to D + 4 (D is 64 or
// 128, so the stride is 4 modulo the 32 banks): the row-major reads of the
// score products (a warp reads word 4g + t of 8 rows) and the transposed
// reads of the second products (word 8t + g of rows 2t and 2t + 1) both fall
// in 32 different banks. 16-byte copies keep rows of 16-byte chunks, so the
// pointers and row strides of the inputs must be 16-byte aligned.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace dalle_attn {
namespace tf32 {

using mma::kStream;

// bytes of a padded [rows][D + 4] fp32 tile
template <int D>
constexpr uint32_t tile_bytes(int rows) {
  return (uint32_t)rows * (D + 4) * 4;
}

// Rows [r0, r0 + rows) of one head into a padded fp32 tile at shared address
// dst; rows at or beyond seq_len arrive as zeros. All THREADS threads of the
// CTA take part; the caller commits and waits.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const float* __restrict__ src,
                                                int64_t base, long long stride_r, int r0,
                                                int rows, int seq_len) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += THREADS) {
    const int rr = i / kChunks, ch = i % kChunks;
    const int gr = r0 + rr;
    const bool valid = gr < seq_len;
    const float* p = src + base + (int64_t)(valid ? gr : seq_len - 1) * stride_r + ch * 4;
    mma::cp_async_16(dst + (uint32_t)(rr * (D + 4) + ch * 4) * 4, p, valid);
  }
}

// x rounded to TF32, nearest with ties away from zero, in a 32-bit register:
// the bits of cvt.rna.tf32.f32 for every x that is not a NaN, in two integer
// operations (add half a TF32 ulp to the magnitude, clear the 13 low bits;
// ops/attention_tiles.py::tf32_round is the same). On sm_90 the cvt itself
// compiles to that add and mask inside a guard for infinities and NaNs (a
// compare and two selects more), and the split's conversions are most of
// the ALU work of every tile product.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each a TF32 value in a 32-bit register. A NaN x stays a
// NaN in small, so every product the split feeds is a NaN: big may come out
// as a zero or an infinity (the add carries the NaNs whose 11 high mantissa
// bits are all ones, such as 0x7fffffff, into the sign bit or out of the
// word), but x - big is then the card's own NaN, 0x7fffffff, and the signed
// min ahead of small's add keeps that one a NaN. The min costs an
// operation, so it is taken on small only: for a finite x, |x - big| is far
// below the values it changes (an infinite x makes x - big a NaN, as the
// cvt did).
// (tests/test_torch_cuda.py::test_fp32_kernels_keep_nans)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  const int rest = __float_as_int(x - __uint_as_float(big));
  small = ((uint32_t)min(rest, 0x7fffefff) + 0x1000u) & 0xffffe000u;
}

// d += a b, one m16n8k8 TF32 product with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b as three TF32 products: the small terms first, then big·big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// The tensor cores' accumulation truncates: an mma.sync rounds its fp32 sum
// toward zero, so a chain of them into one accumulator drifts by about half
// an ulp a step (3e-5 of the result over a 4352-long sum, and over D = 128 a
// score error that a tile whose ds cancels, dp close to dsum, turns into
// 2e-5 of the tile). So every product below sums each k step of 8 in a
// fresh accumulator (three mma, one truncation at the step's own magnitude)
// and adds it into its result with an fp32 add that rounds to nearest.
__device__ __forceinline__ void add_part(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// The split A fragment of k step ks (columns 8 ks .. 8 ks + 8) of rows
// [row0, row0 + 16) of a padded tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                       const float* tile, int row0, int ks, int lane) {
  const float* p = tile + (row0 + (lane >> 2)) * (D + 4) + ks * 8 + (lane & 3);
  split(p[0], big[0], small[0]);
  split(p[8 * (D + 4)], big[1], small[1]);
  split(p[4], big[2], small[2]);
  split(p[8 * (D + 4) + 4], big[3], small[3]);
}

// One k step (columns 8 ks .. 8 ks + 8) of a score product: x[n] += A B^T
// over the step, A the split fragment of the warp's 16 rows, B the NCOLS
// rows at b_off of a streamed tile, each 8-column block summed in a fresh
// accumulator (add_part).
template <int D, int NCOLS>
__device__ __forceinline__ void product_nt_step(float (&x)[NCOLS / 8][4], const uint32_t (&a_big)[4],
                                                const uint32_t (&a_small)[4], const float* b,
                                                int b_off, int ks) {
#pragma unroll
  for (int n = 0; n < NCOLS / 8; ++n) {
    const int off = b_off + n * 8 * (D + 4) + ks * 8;
    uint32_t b_big[2], b_small[2];
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    split(b[off], b_big[0], b_small[0]);
    split(b[off + 4], b_big[1], b_small[1]);
    mma_3xtf32(part, a_big, a_small, b_big, b_small);
    add_part(x[n], part);
  }
}

// A tile split once in shared memory: each x of a padded [rows][D + 4] fp32
// tile becomes big = tf32(x) in place and small = tf32(x - big) at the same
// place of `small`, so a tile read by every key tile of a walk (the
// forward's q tile) is split once and not at every load. All THREADS
// threads of the CTA take part; the caller syncs before and after.
template <int D, int THREADS>
__device__ __forceinline__ void split_tile(float* tile, float* small, int rows) {
  // x becomes its big part, lo gets the small one
  auto halve = [](float& x, float& lo) {
    uint32_t big, rest;
    split(x, big, rest);
    x = __uint_as_float(big);
    lo = __uint_as_float(rest);
  };
  for (int i = threadIdx.x; i < rows * D / 4; i += THREADS) {
    const int at = (i / (D / 4)) * (D + 4) + (i % (D / 4)) * 4;  // 16-byte chunks
    float4 x = *reinterpret_cast<float4*>(tile + at), lo;
    halve(x.x, lo.x);
    halve(x.y, lo.y);
    halve(x.z, lo.z);
    halve(x.w, lo.w);
    *reinterpret_cast<float4*>(tile + at) = x;
    *reinterpret_cast<float4*>(small + at) = lo;
  }
}

// A score product: x[n] += A B^T, 16 x NCOLS in C fragments, A the warp's 16
// rows at a_row0 of an owner tile split by split_tile (a_big, a_small), B
// NCOLS rows at b_row0 of a streamed tile, summed over D (the forward's
// q k^T). UNROLL k steps are unrolled: the kernel that calls it picks the
// depth it measured fastest (on an H100 at D = 128, the ring forward's
// past hop 7% faster with the loop unrolled fully, the causal forward 10%
// slower than with 2).
template <int D, int NCOLS, int UNROLL>
__device__ __forceinline__ void product_nt(float (&x)[NCOLS / 8][4], const float* a_big,
                                           const float* a_small, int a_row0, const float* b,
                                           int b_row0, int lane) {
  const int a_off = (a_row0 + (lane >> 2)) * (D + 4) + (lane & 3);
  const int b_off = (b_row0 + (lane >> 2)) * (D + 4) + (lane & 3);
#pragma unroll(UNROLL)
  for (int ks = 0; ks < D / 8; ++ks) {
    // the A fragment's four elements (load_a's), already split
    const int at[4] = {a_off + ks * 8, a_off + 8 * (D + 4) + ks * 8, a_off + ks * 8 + 4,
                       a_off + 8 * (D + 4) + ks * 8 + 4};
    uint32_t big[4], small[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      big[i] = __float_as_uint(a_big[at[i]]);
      small[i] = __float_as_uint(a_small[at[i]]);
    }
    product_nt_step<D, NCOLS>(x, big, small, b, b_off, ks);
  }
}

// The two score products of a backward pass at once (eight independent
// accumulator chains a k step): x[n] += A0 B0^T and y[n] += A1 B1^T, as
// product_nt, A0 and A1 the same rows of two owner tiles, B0 and B1 the same
// rows of two streamed tiles (q k^T and dO v^T in the dQ pass, k q^T and
// v dO^T in the dK/dV pass).
template <int D, int NCOLS>
__device__ __forceinline__ void product_nt2(float (&x)[NCOLS / 8][4], float (&y)[NCOLS / 8][4],
                                            const float* a0, const float* a1, int a_row0,
                                            const float* b0, const float* b1, int b_row0,
                                            int lane) {
  const int b_off = (b_row0 + (lane >> 2)) * (D + 4) + (lane & 3);
#pragma unroll 2
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t xa_big[4], xa_small[4], ya_big[4], ya_small[4];
    load_a<D>(xa_big, xa_small, a0, a_row0, ks, lane);
    load_a<D>(ya_big, ya_small, a1, a_row0, ks, lane);
    product_nt_step<D, NCOLS>(x, xa_big, xa_small, b0, b_off, ks);
    product_nt_step<D, NCOLS>(y, ya_big, ya_small, b1, b_off, ks);
  }
}

// out[nb] (16 x D, C fragments) += P B[b_row0 .. +NK][0 .. D): P is 16 x NK
// fp32 C fragments of a score tile (p_v, ds or their transposes), taken as A
// fragments in the permuted key order above; B is read down its rows (p_v v,
// ds k, p_v^T dO, ds^T q). These are the long sums (over every key, or every
// q row, a CTA visits), each k step summed apart (add_part).
template <int D, int NK>
__device__ __forceinline__ void product_pn(float (&out)[D / 8][4], const float (&p)[NK / 8][4],
                                           const float* b, int b_row0, int lane) {
  const float* col = b + (b_row0 + 2 * (lane & 3)) * (D + 4) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    uint32_t a_big[4], a_small[4];
    split(p[j][0], a_big[0], a_small[0]);
    split(p[j][2], a_big[1], a_small[1]);
    split(p[j][1], a_big[2], a_small[2]);
    split(p[j][3], a_big[3], a_small[3]);
    const float* rows = col + j * 8 * (D + 4);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      uint32_t b_big[2], b_small[2];
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      split(rows[nb * 8], b_big[0], b_small[0]);
      split(rows[D + 4 + nb * 8], b_big[1], b_small[1]);
      mma_3xtf32(part, a_big, a_small, b_big, b_small);
      add_part(out[nb], part);
    }
  }
}

// A warp's 16 x D fp32 result (C fragments, times `scale`) to global rows
// row0.. of one head: a quad's four lanes write 32 contiguous bytes of a row
// by 8-byte stores; rows at or beyond seq_len are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float scale,
                                           float* __restrict__ dst, int64_t base,
                                           long long stride_r, int row0, int seq_len, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    if (row >= seq_len) continue;
    float* out = dst + base + (int64_t)row * stride_r;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + mma::frag_col(lane, n, 0)) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// Two groups of four warps share a CTA's owner tile, each taking one
// 32-column half of every streamed tile, so each holds a partial sum of its
// 16 x D results. Group 1 parks its C fragments in rows [row0, row0 + 16) of
// a padded [64][D + 4] shared scratch tile (park), and group 0 adds them to
// its own (add_parked), or, with factors, takes acc own[r] + parked[r] times
// the parked rows (row g: r = 0, row g + 8: r = 1): one fixed order, so two
// runs give the same bits. The caller syncs the CTA before park (the scratch
// is a streamed tile's buffer) and between the two.
template <int D>
__device__ __forceinline__ void park(float* scratch, int row0, const float (&acc)[D / 8][4],
                                     int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = scratch + (row0 + (lane >> 2) + r * 8) * (D + 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + mma::frag_col(lane, n, 0)) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
__device__ __forceinline__ void add_parked(float (&acc)[D / 8][4], const float* scratch, int row0,
                                           int lane, const float (&own)[2],
                                           const float (&parked)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = scratch + (row0 + (lane >> 2) + r * 8) * (D + 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(row + mma::frag_col(lane, n, 0));
      acc[n][2 * r] = acc[n][2 * r] * own[r] + x.x * parked[r];
      acc[n][2 * r + 1] = acc[n][2 * r + 1] * own[r] + x.y * parked[r];
    }
  }
}

template <int D>
__device__ __forceinline__ void add_parked(float (&acc)[D / 8][4], const float* scratch, int row0,
                                           int lane) {
  const float one[2] = {1.f, 1.f};  // x * 1 is exact: acc + parked
  add_parked<D>(acc, scratch, row0, lane, one, one);
}

// ------------------------------------------------------------ the forward
// (causal_attention_fwd.cu's tc32 kernel and ring_attention.cu's)

// One online-softmax step of a warp's 16 rows over one 32-key half of a
// streamed tile, in the log2 domain (scores times D^-0.5 log2 e). x holds
// the half's scores, masked: NEG_INF where the mask says so, -inf for a key
// that is no key at all (the ring's keys at or beyond Sk: p = 0 even in a
// row whose max is still NEG_INF). m and l are the group's running max
// (from the finite NEG_INF) and sum of the UNdropped weights for rows g
// (index 0) and g + 8 (index 1); acc its 16 x D sum, rescaled here by
// alpha = 2^(m_old - m_new). On return x holds p_v, the A operand of p_v V:
// p, or with dropout keep(n, e) ? p / (1 - rate) : 0 for element e of C
// fragment n. fp32 p_v is not rounded: the split takes it as it is.
template <int D, int NC, typename Keep>
__device__ __forceinline__ void softmax_step(float (&x)[NC / 8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 8][4], const Dropout& drop,
                                             Keep keep) {
  float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x[n][e]);
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
  float p_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(x[n][e] - m[e >> 1]);
      p_sum[e >> 1] += p;
      x[n][e] = drop.enabled ? (keep(n, e) ? p * drop.scale : 0.f) : p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 1);
    p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 2);
    l[r] = l[r] * alpha[r] + p_sum[r];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// The end of the forward's walk: the two groups' (m, l, acc) of the same
// rows become one. Group 1 (half == 1) parks acc in the padded [64][D + 4]
// scratch tile and m, l in the 128 floats after it (the freed buffers of a
// streamed k and v tile); group 0 takes them in one fixed order:
// m = max(m0, m1), f0 = 2^(m0 - m), f1 = 2^(m1 - m), acc = acc0 f0 + acc1 f1,
// l = l0 f0 + l1 f1. Two NEG_INF maxima (a row that saw no live key in
// either half) give factors of 1, so l counts both halves' keys and acc sums
// both; a NEG_INF max beside a live one gets the factor 0. Every thread of
// the CTA calls it, after a __syncthreads that ends the walk; on return
// group 0 holds the CTA's result (m still in the log2 domain).
template <int D>
__device__ __forceinline__ void merge_halves(float (&acc)[D / 8][4], float (&m)[2], float (&l)[2],
                                             float* scratch, int half, int row0, int lane) {
  float* stats = scratch + kStream * (D + 4);  // m of the 64 rows, then l
  if (half == 1) {
    park<D>(scratch, row0, acc, lane);
    if ((lane & 3) == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + (lane >> 2) + r * 8;
        stats[row] = m[r];
        stats[kStream + row] = l[r];
      }
  }
  __syncthreads();
  if (half == 0) {
    float own[2], parked[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + r * 8;
      const float m1 = stats[row];
      const float m_new = fmaxf(m[r], m1);
      own[r] = exp2f(m[r] - m_new);
      parked[r] = exp2f(m1 - m_new);
      l[r] = l[r] * own[r] + stats[kStream + row] * parked[r];
      m[r] = m_new;
    }
    add_parked<D>(acc, scratch, row0, lane, own, parked);
  }
}

}  // namespace tf32
}  // namespace dalle_attn
