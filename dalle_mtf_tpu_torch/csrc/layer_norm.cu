// LayerNorm forward and backward for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels:
//   - dalle_mtf_tpu/ops/layer_norm.py::_ln_fwd_kernel (driven by
//     _ln_pallas_fwd): y = (x - mean) * rsqrt(var + eps) * g + b over the rows
//     of x [R, E], normalised in fp32, y in x's dtype;
//   - dalle_mtf_tpu/ops/layer_norm.py::_ln_bwd_kernel (driven by
//     _ln_pallas_bwd): mean and rstd recomputed from x (nothing is saved by
//     the forward), dxhat = dy * g,
//     dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) in x's
//     dtype, dg = sum over rows of dy * xhat and db = sum of dy, in fp32.
// x and dy are float32 or bfloat16; g and b are float32 [E]. The variance is
// the two-pass mean((x - mean)^2) from registers, as the TPU kernel computes
// it, not E[x^2] - mean^2.
//
// What bounds it. At the dalle_4k shape (R = 4 x 4352 = 17,408 rows, E = 1024,
// bf16) the forward reads x and writes y (71 MB, 21 us at 3.35 TB/s) and the
// backward reads x and dy and writes dx (107 MB, 32 us); the arithmetic is ~10
// fp32 operations per element, far under the card's rate. So the design is for
// the bytes:
//   - one warp per row, 8 rows per CTA; a lane loads 8 elements at a time (16
//     bytes of bf16, two 16-byte loads of fp32), so a warp reads 256 contiguous
//     columns per step and holds its row in registers (E / 32 values a lane):
//     x is read once, the mean and the variance are two warp reductions over
//     registers, and y is written once;
//   - the backward's dg/db are sums over all rows. The TPU kernel adds them
//     into one VMEM block across its sequential grid; here CTAs run in
//     parallel, so each of a fixed number of CTAs walks its rows (warp w of
//     CTA c takes rows c*8 + w, then every n_ctas*8 rows further), keeps the
//     per-column sums in registers, adds its 8 warps' sums through shared
//     memory in warp order into an fp32 partial [n_ctas, 2, E], and a second
//     launch adds the partials in CTA order. No atomics: repeated runs agree
//     bit for bit.
// E must be a multiple of 8 and at most 4096 (16 steps of 256 columns a warp);
// the model takes this kernel only at E % 128 == 0, as the JAX dispatch does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows per CTA
constexpr int kVec = 8;                // elements a lane loads at once
constexpr int kStep = 32 * kVec;       // columns a warp covers per step
constexpr int kMaxE = 4096;

__device__ __forceinline__ void load8(const float* __restrict__ p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Row `row` of x into v (VPL steps of 8 values a lane; columns past e read 0);
// returns the row's mean and rstd, the two-pass fp32 statistics.
template <typename T, int VPL>
__device__ __forceinline__ float2 row_stats(const T* __restrict__ x, int64_t row, int e,
                                            float eps, int lane, float* v) {
  const T* xr = x + row * e;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int col = i * kStep + lane * kVec;
    if (col < e) {
      load8(xr + col, v + i * kVec);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += v[i * kVec + j];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[i * kVec + j] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / (float)e;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (i * kStep + lane * kVec < e) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[i * kVec + j] - mean;
        sq += d * d;
      }
    }
  }
  const float var = warp_sum(sq) / (float)e;
  return make_float2(mean, rsqrtf(var + eps));
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y, int rows, int e,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[VPL * kVec];
  const float2 st = row_stats<T, VPL>(x, row, e, eps, lane, v);
  T* yr = y + row * e;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int col = i * kStep + lane * kVec;
    if (col < e) {
      float gv[kVec], bv[kVec], out[kVec];
      load8(g + col, gv);
      load8(b + col, bv);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        out[j] = (v[i * kVec + j] - st.x) * st.y * gv[j] + bv[j];
      store8(yr + col, out);
    }
  }
}

// The CTA's 8 warps' per-column sums `acc` added in warp order through
// shared memory `red` [kWarps][e], written to out[0, e).
template <int VPL>
__device__ __forceinline__ void cta_column_sum(const float* acc, float* red, float* out,
                                               int e, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int col = i * kStep + lane * kVec;
    if (col < e) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp * e + col + j] = acc[i * kVec + j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < e; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * e + c];
    out[c] = s;
  }
  __syncthreads();  // red is reused by the next call
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ partial, int rows, int e, float eps) {
  extern __shared__ float red[];  // [kWarps][e]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float dg[VPL * kVec], db[VPL * kVec];
#pragma unroll
  for (int j = 0; j < VPL * kVec; ++j) dg[j] = db[j] = 0.f;

  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < rows; row += stride) {
    float xh[VPL * kVec], d[VPL * kVec];
    const float2 st = row_stats<T, VPL>(x, row, e, eps, lane, xh);
    const T* dyr = dy + row * e;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int col = i * kStep + lane * kVec;
      if (col < e) {
        float gv[kVec];
        load8(dyr + col, d + i * kVec);
        load8(g + col, gv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int n = i * kVec + j;
          xh[n] = (xh[n] - st.x) * st.y;  // xhat
          dg[n] += d[n] * xh[n];
          db[n] += d[n];
          d[n] *= gv[j];                  // dxhat
          m1 += d[n];
          m2 += d[n] * xh[n];
        }
      }
    }
    m1 = warp_sum(m1) / (float)e;
    m2 = warp_sum(m2) / (float)e;
    T* dxr = dx + row * e;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int col = i * kStep + lane * kVec;
      if (col < e) {
        float out[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int n = i * kVec + j;
          out[j] = st.y * (d[n] - m1 - xh[n] * m2);
        }
        store8(dxr + col, out);
      }
    }
  }
  float* part = partial + (int64_t)blockIdx.x * 2 * e;
  cta_column_sum<VPL>(dg, red, part, e, warp, lane);
  cta_column_sum<VPL>(db, red, part + e, e, warp, lane);
}

// dg, db = the partials [n_ctas, 2, e] added in CTA order.
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dg,
                             float* __restrict__ db, int n_ctas, int e) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= e) return;
  float sg = 0.f, sb = 0.f;
  for (int i = 0; i < n_ctas; ++i) {
    sg += partial[(int64_t)(2 * i) * e + c];
    sb += partial[(int64_t)(2 * i + 1) * e + c];
  }
  dg[c] = sg;
  db[c] = sb;
}

template <typename T, int VPL>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, void* y, int rows,
                       int e, float eps, cudaStream_t stream) {
  const int ctas = (rows + kWarps - 1) / kWarps;
  layer_norm_fwd_kernel<T, VPL><<<ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(y), rows, e, eps);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t launch_bwd(const void* x, const void* dy, const void* g, void* dx, void* partial,
                       void* dg, void* db, int rows, int e, int n_ctas, float eps,
                       cudaStream_t stream) {
  auto kernel = layer_norm_bwd_kernel<T, VPL>;
  const int smem = (int)(sizeof(float) * kWarps * e);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(g),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, e, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_bwd_reduce_kernel<<<(e + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dg), static_cast<float*>(db),
      n_ctas, e);
  return cudaGetLastError();
}

// Steps of 256 columns a warp takes for a row of e: the power of two >= e / 256.
int steps_for(int e) {
  int vpl = 1;
  while (vpl * kStep < e) vpl *= 2;
  return vpl;
}

bool valid(int rows, int e) { return rows > 0 && e > 0 && e % kVec == 0 && e <= kMaxE; }

}  // namespace

#define DALLE_LN_DISPATCH(CALL)                                   \
  switch (steps_for(e)) {                                         \
    case 1: return (int)CALL(1);                                  \
    case 2: return (int)CALL(2);                                  \
    case 4: return (int)CALL(4);                                  \
    case 8: return (int)CALL(8);                                  \
    case 16: return (int)CALL(16);                                \
    default: return (int)cudaErrorInvalidValue;                   \
  }

// x, y [rows, e] row-major, 16-byte aligned; g, b fp32 [e], 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int layer_norm_fwd(const void* x, const void* g, const void* b, void* y, int rows,
                              int e, int dtype, float eps, void* stream) {
  if (!valid(rows, e)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_F32(V) launch_fwd<float, V>(x, g, b, y, rows, e, eps, s)
#define LN_BF16(V) launch_fwd<__nv_bfloat16, V>(x, g, b, y, rows, e, eps, s)
  if (dtype == 0) { DALLE_LN_DISPATCH(LN_F32) }
  if (dtype == 1) { DALLE_LN_DISPATCH(LN_BF16) }
#undef LN_F32
#undef LN_BF16
  return (int)cudaErrorInvalidValue;
}

// x, dy, dx [rows, e] as the forward's x; g fp32 [e]; partial fp32
// [n_ctas, 2, e] scratch; dg, db fp32 [e]. Two launches (the rows, then the
// fixed-order sum of the partials). Returns the first cudaError_t.
extern "C" int layer_norm_bwd(const void* x, const void* dy, const void* g, void* dx,
                              void* partial, void* dg, void* db, int rows, int e, int n_ctas,
                              int dtype, float eps, void* stream) {
  if (!valid(rows, e) || n_ctas <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_F32(V) launch_bwd<float, V>(x, dy, g, dx, partial, dg, db, rows, e, n_ctas, eps, s)
#define LN_BF16(V) \
  launch_bwd<__nv_bfloat16, V>(x, dy, g, dx, partial, dg, db, rows, e, n_ctas, eps, s)
  if (dtype == 0) { DALLE_LN_DISPATCH(LN_F32) }
  if (dtype == 1) { DALLE_LN_DISPATCH(LN_BF16) }
#undef LN_F32
#undef LN_BF16
  return (int)cudaErrorInvalidValue;
}
