// Tensor-core pieces for the bf16 attention kernels: swizzled bf16 tiles in
// shared memory, asynchronous 16-byte copies, ldmatrix and mma.sync wrappers,
// the two warp-level tile products and the maps from an accumulator fragment
// to (row, col). Everything here is inline and layout-agnostic (a tile is
// rows of D bf16 values, whatever they mean), so the per-hop ring kernels can
// take the same design.
//
// The tile walk these kernels follow (first and last streamed tile of an
// owner tile, and which tiles need the mask) is written once in Python, in
// dalle_mtf_tpu_torch/ops/attention_tiles.py: key_tile_range,
// query_tile_range and tile_needs_mask, with attention_tiled_reference and
// attention_backward_tiled_reference as the plain versions of the walk. Those
// functions are the definition; the CPU tests hold them against the dense
// mask and the JAX package, and the kernels' results on the card are held
// against the one-shot plain versions at the same edge cases.
//
// Geometry. A warp owns MB blocks of 16 rows of its CTA's "owner" tile (64
// rows: 4 warps of one block; the forward's 128 rows: 4 warps of two); a
// streamed tile has kStream = 64 rows. A warp's products are
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), each on one 16-row block:
//   A fragment (16 x 16): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//                         a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..)
//   B fragment (16 x 8):  b0 = (k = 2t..2t+1, n = g), b1 = (k = 2t + 8.., n = g)
//   C fragment (16 x 8):  c[0], c[1] = (g, 2t), (g, 2t + 1);
//                         c[2], c[3] = (g + 8, 2t), (g + 8, 2t + 1)
// with g = lane / 4 and t = lane % 4. Two neighbouring C fragments of a score
// tile, rounded to bf16, are therefore the A fragment of the next product:
// P and dS never pass through shared memory.
//
// Shared-memory layout. A tile row is D bf16 = D / 8 chunks of 16 bytes; chunk
// c of row r is stored at chunk c ^ (r & 7) (the 128-byte XOR swizzle). The 8
// rows an ldmatrix phase reads at one logical chunk land in 8 different
// 16-byte slots of a 128-byte line: no bank conflict, no padding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace dalle_attn {
namespace mma {

constexpr int kStream = 64;  // rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a [rows][D] bf16 tile
template <int D>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return (uint32_t)(row * (D * 2) + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src-size 0:
// nothing is read, src only has to be a mapped address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) of one (b, h) head into a swizzled [rows][D] bf16 tile
// at shared address dst; rows at or beyond seq_len arrive as zeros. All
// THREADS threads of the CTA take part; the caller commits and waits.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                                int64_t base, long long stride_r, int r0,
                                                int rows, int seq_len) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += THREADS) {
    const int rr = i / kChunks, ch = i % kChunks;
    const int gr = r0 + rr;
    const bool valid = gr < seq_len;
    const __nv_bfloat16* p = src + base + (int64_t)(valid ? gr : seq_len - 1) * stride_r + ch * 8;
    cp_async_16(dst + swizzled<D>(rr, ch), p, valid);
  }
}

// Per-row fp32 scalars (lse, dsum) of rows [r0, r0 + kStream) into shared
// floats at dst; rows beyond seq_len arrive as 0.
template <int THREADS>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const float* __restrict__ src,
                                                int64_t bh_base, int r0, int seq_len) {
  for (int i = threadIdx.x; i < kStream; i += THREADS) {
    const bool valid = r0 + i < seq_len;
    cp_async_4(dst + 4 * i, src + bh_base + (valid ? r0 + i : seq_len - 1), valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b, one m16n8k16 bf16 product with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even, as __float2bfloat16), lo in the
// low half: the order of an A fragment's register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// MB blocks of N C fragments, set to zero
template <int MB, int N>
__device__ __forceinline__ void zero(float (&x)[MB][N][4]) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[mb][n][e] = 0.f;
}

// A warp owns MB blocks of 16 rows, block mb at rows a_row0 + 16 mb. Every B
// fragment read from shared memory then feeds 2 MB products.
//
// acc[mb][n][.] (MB blocks of 16 x NCOLS, C fragments) +=
// A[a_row0 .. +16 MB][0 .. D) times B[b_row0 .. +NCOLS][0 .. D)^T, both tiles
// swizzled [rows][D] in shared memory with D contiguous: the score products
// (q k^T, dO v^T and their transposes).
template <int D, int NCOLS, int MB>
__device__ __forceinline__ void product_nt(float (&acc)[MB][NCOLS / 8][4], uint32_t a_tile,
                                           int a_row0, uint32_t b_tile, int b_row0, int lane) {
  const int a_row = a_row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chunk = lane >> 4;
  const int b_row = b_row0 + (lane & 7) + (lane >> 4) * 8;
  const int b_chunk = (lane >> 3) & 1;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[MB][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
      ldmatrix_x4(a[mb], a_tile + swizzled<D>(a_row + mb * 16, ks * 2 + a_chunk));
#pragma unroll
    for (int nb = 0; nb < NCOLS / 16; ++nb) {
      uint32_t b[4];
      ldmatrix_x4(b, b_tile + swizzled<D>(b_row + nb * 16, ks * 2 + b_chunk));
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        mma_bf16(acc[mb][2 * nb], a[mb], b[0], b[1]);
        mma_bf16(acc[mb][2 * nb + 1], a[mb], b[2], b[3]);
      }
    }
  }
}

// out[mb][n][.] (MB blocks of 16 x D, C fragments) += P (MB blocks of
// 16 x NK, A fragments in registers) times B[b_row0 .. +NK][0 .. D), a
// swizzled [rows][D] tile read through ldmatrix.trans: the products with a
// probability tile on the left (p_v v, ds k, p_v^T dO, ds^T q).
template <int D, int NK, int MB>
__device__ __forceinline__ void product_pn(float (&out)[MB][D / 8][4],
                                           const uint32_t (&p)[MB][NK / 16][4], uint32_t b_tile,
                                           int b_row0, int lane) {
  const int b_row = b_row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_chunk = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < NK / 16; ++ks) {
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_tile + swizzled<D>(b_row + ks * 16, nb * 2 + b_chunk));
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        mma_bf16(out[mb][2 * nb], p[mb][ks], b[0], b[1]);
        mma_bf16(out[mb][2 * nb + 1], p[mb][ks], b[2], b[3]);
      }
    }
  }
}

// Element e (0..3) of C fragment n of a 16-row block lies at local
// (row, col) = (frag_row(lane, e), frag_col(lane, n, e)).
__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + ((e & 2) ? 8 : 0); }
__device__ __forceinline__ int frag_col(int lane, int n, int e) {
  return n * 8 + (lane & 3) * 2 + (e & 1);
}

// A warp's 16 x D fp32 result (C fragments, already scaled), rounded to bf16,
// into rows [warp_row0, warp_row0 + 16) of a swizzled shared tile that only
// this warp reads, then out to global rows g_row0.. with 16-byte stores; rows
// at or beyond seq_len are not written.
template <int D>
__device__ __forceinline__ void store_warp_rows(uint8_t* tile, int warp_row0,
                                                const float (&acc)[D / 8][4],
                                                __nv_bfloat16* __restrict__ dst, int64_t base,
                                                long long stride_r, int g_row0, int seq_len,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + swizzled<D>(warp_row0 + g, n) + t * 4) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(tile + swizzled<D>(warp_row0 + g + 8, n) + t * 4) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int rr = i / kChunks, ch = i % kChunks;
    const int gr = g_row0 + rr;
    if (gr < seq_len)
      *reinterpret_cast<uint4*>(dst + base + (int64_t)gr * stride_r + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + swizzled<D>(warp_row0 + rr, ch));
  }
}

// The forward's q tile: 64 rows (4 warps of one 16-row block) or, at D = 128,
// 128 (4 warps of two blocks: every B fragment read from shared memory feeds
// four products instead of two, for twice the accumulator registers a
// thread). Measured on an H100 (S = 1280 and 4352, with and without dropout):
// at D = 128 the forward is 18-21% faster with 128 rows; at D = 64 it
// measured no faster (+2%), so that instantiation is not built. The forward
// takes 128 rows at D = 128 when those tiles still give every SM a CTA (the
// serving prefill, B*H = 32 and S = 256, would be 64 CTAs on 132 SMs: it
// stays at 128 CTAs of 64 rows), else 64. Both backward passes measured
// 15-20% slower with 128 rows and always take 64.
// ops/attention_tiles.py::forward_tile_rows is the same rule in Python;
// causal_attention_fwd_tile_rows reports this one, so a test on the card
// holds the two together.
constexpr int kSms = 132;  // an H100's SMs
inline int forward_tile_rows(int head_dim, int programs, int seq_len) {
  return head_dim == 128 && (long long)programs * ((seq_len + 127) / 128) >= kSms ? 128 : 64;
}

// out[0..4) = registers a thread, local (spill) bytes a thread, dynamic shared
// memory a CTA and CTAs an SM of a built kernel launched with `threads` and
// `smem` bytes.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = ctas;
  return err;
}

// 16-byte copies need 16-byte-aligned pointers and strides of whole chunks
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace mma
}  // namespace dalle_attn
