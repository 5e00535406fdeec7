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
// is exact in fp32; the sum over K is fp32; the scale multiplies the whole
// sum once at the end (the TPU kernel's acc * s). int4 nibbles are
// sign-extended in 32-bit registers: lo = (p << 28) >> 28, hi = p >> 4.
//
// What bounds it. Every decode step reads each weight matrix once, and reads
// nothing else of size: the activations are M rows of K bf16. At dalle_coco
// width (K, N in {1024, 4096}, M = 4) a matrix is 1-4 MiB of int8, 1.25 us at
// the H100's 3.35 TB/s, and the arithmetic is 2 M operations per weight byte
// (4 M for int4), far under the CUDA cores' rate. So the design is for the
// read:
//   - a lane loads 16 bytes (16 columns) of a weight row at a time; the 8
//     lanes of a warp row cover 128 contiguous bytes and a warp reads 4 rows;
//   - each thread issues all the loads of its K slice (up to 8 rows) before
//     any arithmetic, so a CTA keeps 32 KB in flight;
//   - x for the CTA's rows and K slice sits in shared memory as fp32;
//   - fp32 sums in registers (16 columns x up to 4 rows per thread);
//   - split-K: a CTA covers 128 columns and a slice of at most 256 rows, so
//     N = 1024 still gives ~256 CTAs for 132 SMs. The slices' partial sums go
//     to a scratch buffer and a second small kernel adds them in slice order
//     and applies the scale: deterministic, no atomics. With one slice the
//     first kernel writes the scaled output itself;
//   - a ragged N (the full vocabulary, 52,307 columns) is masked per column
//     in the kernel. Rows of such a matrix are not 16-byte aligned, so it
//     reads bytes one at a time (the band the decode loop reads is aligned).
// Tensor cores, cp.async/TMA pipelining and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                           // columns (bytes) per lane
constexpr int kLanesN = 8;                         // lanes across a row
constexpr int kBlockN = kLanesN * kVec;            // 128 columns per CTA
constexpr int kRowsPerWarp = 32 / kLanesN;         // 4
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;  // 32
constexpr int kMaxKSlice = 256;
constexpr int kMaxPasses = kMaxKSlice / kRowsPerPass;  // 8

// 16 weight bytes of row k, columns [col, col + 16), as four little-endian
// words; zeros past the slice or past N. VEC: one 16-byte load (N % 16 == 0
// and w 16-byte aligned, so every row is aligned); else byte by byte.
template <bool VEC>
__device__ __forceinline__ uint4 load_row(const int8_t* __restrict__ w, int k, int k_end,
                                          int n, int col) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= k_end) return v;
  const int8_t* row = w + (int64_t)k * n + col;
  if constexpr (VEC) {
    if (col < n) v = __ldg(reinterpret_cast<const uint4*>(row));
  } else {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (col + j < n) words[j >> 2] |= (uint32_t)(uint8_t)__ldg(row + j) << (8 * (j & 3));
    v = make_uint4(words[0], words[1], words[2], words[3]);
  }
  return v;
}

// byte j of the 16 as a sign-extended int32
__device__ __forceinline__ int32_t byte_at(const uint4& v, int j) {
  const uint32_t word = (j >> 2) == 0 ? v.x : (j >> 2) == 1 ? v.y : (j >> 2) == 2 ? v.z : v.w;
  return (int32_t)(word << (24 - 8 * (j & 3))) >> 24;
}

// grid (ceil(N / 128), splits, ceil(M / MT)); CTA (bx, s, bz) sums rows
// [s * k_slice, min(K, (s + 1) * k_slice)) for columns [bx * 128, +128) and x
// rows [bz * MT, +MT). K is the weight's row count (Kp for int4), which is also
// x's row stride.
template <int MT, bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const __nv_bfloat16* __restrict__ x_lo,
                     const __nv_bfloat16* __restrict__ x_hi,
                     const int8_t* __restrict__ w, const float* __restrict__ scale,
                     float* __restrict__ out, float* __restrict__ partial, int M, int K,
                     int N, int k_slice) {
  constexpr int kX = INT4 ? 2 : 1;
  __shared__ float xs[kX][MT][kMaxKSlice];
  __shared__ float red[kWarps][MT][kBlockN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane % kLanesN;  // column group of the lane
  const int ty = lane / kLanesN;  // row of the warp's 4
  const int n0 = blockIdx.x * kBlockN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  const int ks = k_end - k_begin;
  const int col = n0 + tx * kVec;
  const int k_row = k_begin + warp * kRowsPerWarp + ty;

  // the loads first: they do not wait for x
  uint4 wv[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p)
    wv[p] = load_row<VEC>(w, k_row + p * kRowsPerPass, k_end, N, col);

  for (int i = tid; i < MT * ks; i += kThreads) {
    const int m = i / ks, kk = i - m * ks;
    const int64_t at = (int64_t)(m0 + m) * K + k_begin + kk;
    const bool in = m0 + m < M;
    xs[0][m][kk] = in ? __bfloat162float(x_lo[at]) : 0.f;
    if constexpr (INT4) xs[kX - 1][m][kk] = in ? __bfloat162float(x_hi[at]) : 0.f;
  }
  __syncthreads();

  float acc[MT][kVec];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;

#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int k = k_row + p * kRowsPerPass;
    if (k >= k_end) break;
    const int kk = k - k_begin;
    if constexpr (INT4) {
      float lo[kVec], hi[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int32_t b = byte_at(wv[p], j);
        lo[j] = (float)((int32_t)((uint32_t)b << 28) >> 28);
        hi[j] = (float)(b >> 4);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs[0][m][kk], xh = xs[kX - 1][m][kk];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          acc[m][j] = fmaf(xl, lo[j], acc[m][j]);
          acc[m][j] = fmaf(xh, hi[j], acc[m][j]);
        }
      }
    } else {
      float wf[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) wf[j] = (float)byte_at(wv[p], j);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[0][m][kk];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
      }
    }
  }

  // the 4 lanes of a warp that share a column group (lane bits 3-4) sum
  // their rows; then the 8 warps' sums are added in warp order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (ty == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp][m][tx * kVec + j] = acc[m][j];
  }
  __syncthreads();

  const bool one_slice = gridDim.y == 1;
  for (int i = tid; i < MT * kBlockN; i += kThreads) {
    const int m = i / kBlockN, c = i % kBlockN;
    const int gm = m0 + m, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][m][c];
    if (one_slice)
      out[(int64_t)gm * N + gn] = s * scale[gn];
    else
      partial[((int64_t)split * M + gm) * N + gn] = s;
  }
}

// out[m, n] = (sum over slices, in slice order, of partial[s, m, n]) * scale[n]
__global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                     float* __restrict__ out, int M, int N, int splits) {
  const int64_t total = (int64_t)M * N;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[(int64_t)sp * total + i];
    out[i] = s * scale[i % N];
  }
}

template <int MT, bool INT4>
void launch_main(bool vec, dim3 grid, cudaStream_t stream, const void* x_lo,
                 const void* x_hi, const void* w, const void* scale, void* out,
                 void* partial, int M, int K, int N, int k_slice) {
  const auto* xl = static_cast<const __nv_bfloat16*>(x_lo);
  const auto* xh = static_cast<const __nv_bfloat16*>(x_hi);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(partial);
  if (vec)
    decode_matmul_kernel<MT, INT4, true>
        <<<grid, kThreads, 0, stream>>>(xl, xh, wp, sp, op, pp, M, K, N, k_slice);
  else
    decode_matmul_kernel<MT, INT4, false>
        <<<grid, kThreads, 0, stream>>>(xl, xh, wp, sp, op, pp, M, K, N, k_slice);
}

template <bool INT4>
int launch(const void* x_lo, const void* x_hi, const void* w, const void* scale, void* out,
           void* partial, int M, int K, int N, int mt, int k_slice, int splits,
           void* stream_ptr) {
  if (M < 1 || M > 32 || K < 1 || N < 1 || (mt != 1 && mt != 2 && mt != 4) ||
      k_slice < 1 || k_slice > kMaxKSlice || splits < 1 || splits > 65535 ||
      (int64_t)(splits - 1) * k_slice >= K || (int64_t)splits * k_slice < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = N % kVec == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits, (M + mt - 1) / mt);
  if (mt == 1)
    launch_main<1, INT4>(vec, grid, stream, x_lo, x_hi, w, scale, out, partial, M, K, N, k_slice);
  else if (mt == 2)
    launch_main<2, INT4>(vec, grid, stream, x_lo, x_hi, w, scale, out, partial, M, K, N, k_slice);
  else
    launch_main<4, INT4>(vec, grid, stream, x_lo, x_hi, w, scale, out, partial, M, K, N, k_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t total = (int64_t)M * N;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 1024
                               ? (total + kThreads - 1) / kThreads : 1024);
  splitk_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<float*>(out), M, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [K, N] int8, scale [N] fp32, out [M, N] fp32, all dense;
// partial: [splits, M, N] fp32 scratch (may be out when splits == 1). A CTA
// carries m_tile (1, 2 or 4) rows of x. The K slices are [s * k_slice,
// (s + 1) * k_slice), splits = ceil(K / k_slice), k_slice <= 256. The wrapper
// (ops/decode_matmul.py) makes this plan. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out,
                           void* partial, int M, int K, int N, int m_tile, int k_slice,
                           int splits, void* stream) {
  return launch<false>(x, nullptr, w, scale, out, partial, M, K, N, m_tile, k_slice, splits,
                       stream);
}

// as int8_matmul, with x_lo, x_hi [M, Kp] bf16 and packed [Kp, N] int8 (K = Kp)
extern "C" int int4_matmul(const void* x_lo, const void* x_hi, const void* packed,
                           const void* scale, void* out, void* partial, int M, int K, int N,
                           int m_tile, int k_slice, int splits, void* stream) {
  return launch<true>(x_lo, x_hi, packed, scale, out, partial, M, K, N, m_tile, k_slice,
                      splits, stream);
}
