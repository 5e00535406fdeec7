// Streaming dequant matmuls for the decode loop, for Hopper (sm_90a), plain C
// interface.
//
// Replaces two Pallas TPU kernels:
//   - dalle_mtf_tpu/ops/decode_matmul.py::_int8_kernel (driven by int8_matmul):
//     x [M, K] bf16 times w [K, N] int8, times a per-column fp32 scale;
//   - dalle_mtf_tpu/ops/decode_matmul.py::_int4_kernel (driven by int4_matmul):
//     x_lo, x_hi [M, Kp] bf16 times the low and high nibbles of packed
//     [Kp, N] int8 (split-half int4, dalle_mtf_tpu/quantize.py), times the scale.
// Output [M, N] fp32, M <= 32. Each product of a bf16 x and an integer weight
// is exact; the sum over K is fp32; the scale multiplies the whole sum once at
// the end (the TPU kernel's acc * s). int4 nibbles are the signed values
// lo = (p << 28) >> 28 and hi = p >> 4 of each byte p.
//
// What bounds it. Every decode step reads each weight matrix once, and reads
// nothing else of size: the activations are M rows of K bf16. At dalle_coco
// width (K, N in {1024, 4096}, M = 4) a matrix is 1-4 MiB of int8, at most
// 1.25 us at the H100's 3.35 TB/s. On the CUDA cores the M FMAs a weight, its
// conversion and the sum across the lanes that share a column took about as
// long as the read (measured on the H100: PERF.md), so the products go to
// the tensor cores:
//   - a CTA (8 warps) covers 32 output columns and 8 rows of x; warp w takes
//     the 16-row k-tiles w, w + 8, w + 16, ... of the CTA's K slice. A k-tile
//     is two mma.sync.m16n8k16 (bf16 in, fp32 out): the weights transposed
//     are A (16 output columns by 16 rows of K), x is B (16 rows of K by the
//     8 rows of x). The columns and the rows of K are permuted inside a tile
//     so that a lane's A fragments are four 32-bit words of shared memory (4
//     columns of 4 rows: mma j takes columns 4g + 2j and 4g + 2j + 1) and its
//     B fragment one 8-byte read of x (rows 4t .. 4t + 3);
//   - the dequant never touches the int-to-float unit. int8: one byte_perm
//     puts a biased byte (^ 0x80) into the mantissa of 2^23 (0x4B0000uu is
//     2^23 + u), one FADD takes the bias away, and two such floats pack to a
//     bf16 pair, exact for every byte. int4: a byte_perm gathers a byte of two
//     rows, one lop3 puts each biased nibble (^ 0x8) into the mantissa of 128
//     as bf16 (0x4300 | u is 128 + u), and one bf16x2 subtraction of 136
//     leaves the nibbles' values, exact for every nibble, two at a time;
//   - each mma starts from a zero accumulator and its result is added to the
//     lane's fp32 sums rounding to nearest (the tensor cores round a sum
//     toward zero: summed so, the error stays that of one fp32 add a tile);
//   - the weight read: lane l of a warp copies row l / 2, half l % 2 (16
//     bytes) of each of the warp's k-tiles into the warp's ring of kDepth tile
//     slots (cp.async, one group a tile), so a tile waits for its own rows
//     only and kDepth tiles a warp are in flight; a slot's rows sit 32 bytes
//     apart with a 32-byte gap after every fourth, so the four words of the A
//     fragments read without bank conflicts. x of the CTA's rows and slice is
//     copied to shared memory first (rows past M zero-filled);
//   - one launch a call, no scratch in device memory, no atomics, the same
//     bits every run. The 8 warps' sums are added in warp order. Where one
//     slice a column block leaves a warp too many tiles (mlp2: K = 4096 on
//     N = 1024), the K slices of a column block form a thread-block cluster
//     of up to 8: each CTA stores its sums into the shared memory of the CTA
//     that owns them (distributed shared memory), and after one cluster
//     barrier each owner adds its outputs' sums in slice order, applies the
//     scale and writes out. ops/decode_matmul.py::plan picks the slices;
//     ops/decode_matmul_tiles.py walks the same order in numpy;
//   - a ragged N (the full vocabulary, 52,307 columns) is masked per column.
//     Rows of such a matrix are not 16-byte aligned, so a lane reads its 16
//     bytes as the five aligned words that hold them (byte by byte at the
//     edge) and stores them to the slot itself (the band the decode loop
//     reads is aligned).

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 32;                          // output columns a CTA: two mma tiles
constexpr int kMT = 8;                               // rows of x a CTA: the mma's n
constexpr int kTileK = 16;                           // rows of K a tile: the mma's k
constexpr int kRowsPerPass = kWarps * kTileK;        // a pass: one tile a warp
constexpr int kMaxPasses = 16;                       // passes between copies of x (a chunk)
constexpr int kChunk = kMaxPasses * kRowsPerPass;    // 2048 rows
constexpr int kDepth = 8;                            // tiles in flight a warp
constexpr int kTileBytes = 20 * 32;                  // 16 rows of 32 bytes, a gap after every 4th
constexpr int kWeightSmem = kWarps * kDepth * kTileBytes;
constexpr int kTotal = kMT * kBlockN;                // outputs of a CTA
constexpr int kMaxCluster = 8;                       // K slices a cluster: the portable size

constexpr uint32_t kMagic = 0x4B000000u;        // 2^23 as fp32
constexpr float kByteBias = 8388736.0f;         // 2^23 + 128: int8 b = (2^23 + (b ^ 0x80)) - this
constexpr uint32_t kNibbleMagic = 0x43084308u;  // the bf16 pair (136, 136)

// byte j of a word of biased int8 values as the float 2^23 + (b ^ 0x80)
__device__ __forceinline__ float magic_byte(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, kMagic, 0x7540 | j));
}

// the low nibbles of bytes 0 and 2 of `pair` as the bf16 pair of their signed
// values v: lop3 (mask ? pair ^ c : c) gives 0x4300 | (v ^ 8), i.e. 136 + v
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t pair) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(d) : "r"(pair), "r"(0x000F000Fu), "r"(kNibbleMagic));
  const uint32_t bias = kNibbleMagic;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&d),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // exact: integers of 8 bits
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d = A B with a zero accumulator (16x16 bf16 A, 16x8 bf16 B, fp32 out)
__device__ __forceinline__ void mma_fresh(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(0.f));
}

// a 16-byte asynchronous copy to shared memory; zeros when !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 .. kDepth) of the thread's cp.async groups are
// pending (n a constant once the caller's loop is unrolled)
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
#define DECODE_WAIT(N) \
  case N: asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break;
    DECODE_WAIT(0) DECODE_WAIT(1) DECODE_WAIT(2) DECODE_WAIT(3) DECODE_WAIT(4) DECODE_WAIT(5)
    DECODE_WAIT(6) DECODE_WAIT(7)
#undef DECODE_WAIT
    default: asm volatile("cp.async.wait_group 8;\n" ::: "memory");
  }
}

// 16 weight bytes of row k, columns [col, col + 16), of a weight whose rows
// are not 16-byte aligned, as four little-endian words; zeros past the slice
// or past N: the five aligned words that hold the 16 bytes, funnel-shifted
// into place, or, at the ragged edge of N, byte by byte.
__device__ __forceinline__ uint4 load_row(const int8_t* __restrict__ w, int k, int k_end, int n,
                                          int col) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= k_end || col >= n) return v;
  const int8_t* row = w + (int64_t)k * n + col;
  if (col + 16 <= n) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(row);
    const uint32_t* a = reinterpret_cast<const uint32_t*>(at & ~(uintptr_t)3);
    const uint32_t sh = (uint32_t)(at & 3) * 8;
    const uint32_t w0 = __ldg(a), w1 = __ldg(a + 1), w2 = __ldg(a + 2), w3 = __ldg(a + 3);
    const uint32_t w4 = sh ? __ldg(a + 4) : 0u;
    v = make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                   __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
  } else {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + j < n) words[j >> 2] |= (uint32_t)(uint8_t)__ldg(row + j) << (8 * (j & 3));
    v = make_uint4(words[0], words[1], words[2], words[3]);
  }
  return v;
}

// byte offset of row r (0..15) in a tile slot: 32 bytes a row, a 32-byte gap
// after every fourth row
__device__ __forceinline__ int tile_row(int r) { return (r + (r >> 2)) * 32; }

// grid (splits, ceil(N / 32), ceil(M / 8)); with splits > 1 the splits CTAs
// of a column block are one cluster. CTA (s, bn, bm) sums rows
// [s * k_slice, min(K, (s + 1) * k_slice)) for columns [bn * 32, +32) and
// rows [bm * 8, +8) of x. K is the weight's row count (Kp for int4), which is
// also x's row stride. VEC: N % 16 == 0 and w 16-byte aligned (cp.async of
// the rows); x_vec: x 16-byte aligned and K % 8 == 0 (cp.async of x).
// Dynamic shared memory: the warps' rings, then x of the slice,
// [kX][8][x_rows] bf16.
template <bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const __nv_bfloat16* __restrict__ x_lo,
                     const __nv_bfloat16* __restrict__ x_hi,
                     const int8_t* __restrict__ w, const float* __restrict__ scale,
                     float* __restrict__ out, int M, int K, int N, int k_slice, bool x_vec) {
  constexpr int kX = INT4 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float red[kWarps][kTotal];
  __shared__ float gather[kTotal + kMaxCluster];  // the owned outputs' sums, by slice
  uint16_t* xs = reinterpret_cast<uint16_t*>(dyn + kWeightSmem);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the mma's groupID and thread in group
  const int split = blockIdx.x, splits = gridDim.x;  // the CTA's rank in its cluster
  const int n0 = blockIdx.y * kBlockN;
  const int m0 = blockIdx.z * kMT;
  const int k_begin = split * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  const int x_rows = min(k_slice, kChunk);
  unsigned char* ring = dyn + warp * kDepth * kTileBytes;
  const int copy_row = lane >> 1, copy_col = n0 + (lane & 1) * 16;  // the lane's 16 bytes

  float acc[2][4];  // mma j's C fragment
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c0 = k_begin; c0 < k_end; c0 += kChunk) {
    const int c_end = min(k_end, c0 + kChunk);
    const int rows = c_end - c0;
    if (c0 != k_begin) __syncthreads();  // every warp is done with the last chunk's x
    // x first: a few KB that every tile waits for (one cp.async group)
    if (x_vec) {
      const int groups = rows / 8;
      for (int i = tid; i < kX * kMT * groups; i += kThreads) {
        const int q = i % groups, mx = i / groups, m = mx % kMT, xi = mx / kMT;
        const bool in = m0 + m < M;
        const __nv_bfloat16* src =
            (xi ? x_hi : x_lo) + (in ? (int64_t)(m0 + m) * K + c0 + 8 * q : 0);
        cp_async_16(&xs[mx * x_rows + 8 * q], src, in);
      }
    } else {
      for (int i = tid; i < kX * kMT * rows; i += kThreads) {
        const int kk = i % rows, mx = i / rows, m = mx % kMT, xi = mx / kMT;
        const bool in = m0 + m < M;
        xs[mx * x_rows + kk] =
            in ? __bfloat16_as_ushort((xi ? x_hi : x_lo)[(int64_t)(m0 + m) * K + c0 + kk])
               : (uint16_t)0;
      }
    }
    cp_async_commit();
    // then the weight stream: tile p of the warp into slot p % kDepth, one
    // cp.async group a tile
    auto copy_tile = [&](int p) {
      const int k = c0 + (p * kWarps + warp) * kTileK + copy_row;
      unsigned char* dst = ring + (p % kDepth) * kTileBytes + tile_row(copy_row) + (lane & 1) * 16;
      if constexpr (VEC) {
        const bool in = k < c_end && copy_col < N;
        cp_async_16(dst, in ? w + (int64_t)k * N + copy_col : w, in);
      } else {
        *reinterpret_cast<uint4*>(dst) = load_row(w, k, c_end, N, copy_col);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int p = 0; p < kDepth; ++p) copy_tile(p);
    wait_pending(kDepth);  // the x group
    __syncthreads();

#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      const int k0 = c0 + (p * kWarps + warp) * kTileK;
      if (k0 >= c_end) break;
      wait_pending(min(kDepth - 1, kMaxPasses - 1 - p));
      __syncwarp();  // the other lanes' rows of the tile are in
      const unsigned char* t = ring + (p % kDepth) * kTileBytes;
      uint32_t wd[4];  // row 4 tq + r, columns [4 g, 4 g + 4)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wd[r] = *reinterpret_cast<const uint32_t*>(t + tile_row(4 * tq + r) + 4 * g);
      uint2 xb[kX];  // x row g, rows 4 tq .. 4 tq + 3 of the tile
#pragma unroll
      for (int xi = 0; xi < kX; ++xi)
        xb[xi] = *reinterpret_cast<const uint2*>(&xs[(xi * kMT + g) * x_rows + k0 - c0 + 4 * tq]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // A register q: rows 4 tq + {0, 1} (q < 2) or + {2, 3}, column 4 g + 2 j + q % 2
        float d[4];
        if constexpr (INT4) {
          uint32_t alo[4], ahi[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ra = (q >> 1) * 2, bj = 2 * j + (q & 1);
            const uint32_t pair = __byte_perm(wd[ra], wd[ra + 1], bj | ((4 + bj) << 8));
            alo[q] = nibbles_bf16(pair);
            ahi[q] = nibbles_bf16(pair >> 4);
          }
          mma_fresh(d, alo, xb[0]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
          mma_fresh(d, ahi, xb[1]);
        } else {
          uint32_t a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ra = (q >> 1) * 2, bj = 2 * j + (q & 1);
            a[q] = pack_bf16(magic_byte(wd[ra] ^ 0x80808080u, bj) - kByteBias,
                             magic_byte(wd[ra + 1] ^ 0x80808080u, bj) - kByteBias);
          }
          mma_fresh(d, a, xb[0]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
      }
      if (p + kDepth < kMaxPasses) {
        __syncwarp();  // every lane has read the slot
        copy_tile(p + kDepth);
      }
    }
    wait_pending(0);  // the groups of rows past the slice (zero-filled) too
  }

  // C fragment element e of mma j: x row 2 tq + e % 2, column 4 g + 2 j + e / 2
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp][(2 * tq + (e & 1)) * kBlockN + 4 * g + 2 * j + (e >> 1)] = acc[j][e];
  __syncthreads();

  // the warps' sums in warp order: the slice's sum of each output
  const int share = (kTotal + splits - 1) / splits;  // outputs a CTA of the cluster owns
  for (int i = tid; i < kTotal; i += kThreads) {
    float s = red[0][i];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s += red[wi][i];
    const int m = i / kBlockN, c = i - m * kBlockN;
    if (splits == 1) {  // one slice, launched without a cluster: the CTA writes its block
      if (m0 + m < M && n0 + c < N) out[(int64_t)(m0 + m) * N + n0 + c] = s * scale[n0 + c];
    } else {  // into the shared memory of the CTA that owns output i
      const int owner = i / share;
      cg::this_cluster().map_shared_rank(gather, owner)[split * share + i - owner * share] = s;
    }
  }
  if (splits == 1) return;

  // every slice's sum of the owned outputs is here: add them in slice order
  cg::this_cluster().sync();
  const int first = split * share;
  for (int j = tid; j < share && first + j < kTotal; j += kThreads) {
    const int i = first + j, m = i / kBlockN, c = i - m * kBlockN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float s = gather[j];
    for (int r = 1; r < splits; ++r) s += gather[r * share + j];
    out[(int64_t)(m0 + m) * N + n0 + c] = s * scale[n0 + c];
  }
}

// the dynamic shared memory at a slice of k_slice rows: the rings and x
template <bool INT4>
size_t dyn_smem(int k_slice) {
  return kWeightSmem + (size_t)(INT4 ? 2 : 1) * kMT * std::min(k_slice, kChunk) * 2;
}

inline cudaLaunchConfig_t launch_config(dim3 grid, int splits, size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one slice needs no cluster
  return cfg;
}

template <bool INT4, bool VEC>
cudaError_t launch_one(int splits, cudaStream_t stream, const void* x_lo, const void* x_hi,
                       const void* w, const void* scale, void* out, int M, int K, int N,
                       int k_slice, bool x_vec) {
  auto kernel = decode_matmul_kernel<INT4, VEC>;
  static const cudaError_t opted = cudaFuncSetAttribute(  // once: the most a slice takes
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_smem<INT4>(kChunk));
  if (opted != cudaSuccess) return opted;
  const dim3 grid(splits, (N + kBlockN - 1) / kBlockN, (M + kMT - 1) / kMT);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(grid, splits, dyn_smem<INT4>(k_slice), stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x_lo),
                            static_cast<const __nv_bfloat16*>(x_hi),
                            static_cast<const int8_t*>(w), static_cast<const float*>(scale),
                            static_cast<float*>(out), M, K, N, k_slice, x_vec);
}

// out[0..6) = registers a thread, local (spill) bytes a thread, static shared
// memory a CTA, the dynamic shared memory at k_slice, CTAs an SM, and
// clusters of `cluster` CTAs the card holds at once (0 for cluster 1, which
// launches without one)
template <bool INT4, bool VEC>
cudaError_t info_one(int k_slice, int cluster, int* out) {
  auto kernel = decode_matmul_kernel<INT4, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn_smem<INT4>(kChunk));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t smem = dyn_smem<INT4>(k_slice);
  int ctas = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 1) {
    cudaLaunchAttribute cattr;
    const cudaLaunchConfig_t cfg =
        launch_config(dim3(cluster, 1, 1), cluster, smem, nullptr, &cattr);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = ctas;
  out[5] = clusters;
  return err;
}

template <bool INT4>
int launch(const void* x_lo, const void* x_hi, const void* w, const void* scale, void* out,
           int M, int K, int N, int k_slice, int splits, void* stream) {
  if (M < 1 || M > 32 || K < 1 || N < 1 || k_slice < 1 || k_slice % kRowsPerPass != 0 ||
      splits < 1 || splits > kMaxCluster || (int64_t)(splits - 1) * k_slice >= K ||
      (int64_t)splits * k_slice < K || (N + kBlockN - 1) / kBlockN > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x_lo) % 16 == 0 &&
                     (!INT4 || reinterpret_cast<uintptr_t>(x_hi) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_one<INT4, true>(splits, s, x_lo, x_hi, w, scale, out, M, K, N, k_slice, x_vec)
          : launch_one<INT4, false>(splits, s, x_lo, x_hi, w, scale, out, M, K, N, k_slice, x_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [K, N] int8, scale [N] fp32, out [M, N] fp32, all dense.
// The K slices are [s * k_slice, (s + 1) * k_slice), splits = ceil(K /
// k_slice) <= 8 of them a cluster, k_slice a multiple of 128 (a tile of 16
// rows for each of the 8 warps). The wrapper (ops/decode_matmul.py::plan)
// makes this plan. One launch; returns its cudaError_t (0 on success).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out, int M,
                           int K, int N, int k_slice, int splits, void* stream) {
  return launch<false>(x, x, w, scale, out, M, K, N, k_slice, splits, stream);
}

// as int8_matmul, with x_lo, x_hi [M, Kp] bf16 and packed [Kp, N] int8 (K = Kp)
extern "C" int int4_matmul(const void* x_lo, const void* x_hi, const void* packed,
                           const void* scale, void* out, int M, int K, int N, int k_slice,
                           int splits, void* stream) {
  return launch<true>(x_lo, x_hi, packed, scale, out, M, K, N, k_slice, splits, stream);
}

// what the built instantiation (int4, vec: the weight's rows 16-byte aligned)
// takes at a slice of k_slice rows in clusters of `cluster`: out[0..6) =
// registers a thread, spill bytes a thread, static and dynamic shared memory a
// CTA, CTAs an SM, and clusters resident at once (0 for cluster 1: no
// cluster). Returns the cudaError_t.
extern "C" int decode_matmul_info(int int4, int vec, int k_slice, int cluster, int* out) {
  if (k_slice < 1 || cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (int4) return (int)(vec ? info_one<true, true>(k_slice, cluster, out)
                             : info_one<true, false>(k_slice, cluster, out));
  return (int)(vec ? info_one<false, true>(k_slice, cluster, out)
                   : info_one<false, false>(k_slice, cluster, out));
}
