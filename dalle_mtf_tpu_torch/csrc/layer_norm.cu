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
// the two-pass mean((x - mean)^2), as the TPU kernel computes it, not
// E[x^2] - mean^2. E is any multiple of 8 up to 8192 in both kernels.
//
// What bounds them. At the dalle_4k shape (R = 4 x 4352 = 17,408 rows,
// E = 1024, bf16) the forward reads x and writes y (71 MB, 21 us at 3.35 TB/s)
// and the backward reads x and dy and writes dx (107 MB, 32 us); the
// arithmetic is ~10-16 fp32 operations an element, far under the card's rate.
// So both are designed for the bytes: enough loads in flight on every SM.
//
// Forward. Up to E = 4096, one warp a row, 8 rows a CTA: a lane loads 8
// elements at a time (16 bytes of bf16, two 16-byte loads of fp32) and holds
// its share of the row in registers, so x is read once, the mean and the
// variance are two warp reductions over registers, and y is written once.
// Wider rows would spill, so past 4096 a CTA takes a row (its 256 threads 8
// elements a step, 3 or 4 steps), with the two reductions across its warps.
//
// Backward: one cooperative launch of a persistent grid (every CTA resident:
// the SMs times the CTAs an SM holds at this shared-memory size).
//   - CTA c takes the contiguous rows [c R / n_ctas, (c + 1) R / n_ctas)
//     (the rows split evenly: no CTA holds more than a row over another), in
//     tiles of `rt` rows (a power of two; ops/layer_norm.py::bwd_tile_rows),
//     the last one ragged. Thread 0 stages a tile's x and dy into shared
//     memory with two 1-D bulk copies (TMA) that complete on the stage's
//     mbarrier, in a ring of kStages = 2 stages, so the next tile's loads are
//     in flight while the present one is reduced and written.
//   - Phase A, the row statistics from shared memory: a warp a row (rt >= 8)
//     or 8 / rt warps a row (wide rows), two passes over the row: the mean,
//     then the variance, mean(dxhat) and mean(dxhat * xhat), the last as
//     rstd * mean(dxhat * (x - mean)).
//   - Phase B, owned by column: thread t keeps the same 8-column chunks for
//     every row it touches (chunk t % n_chunks of the rows j = t / n_chunks
//     mod G of a tile when E / 8 < 256, G = 256 / (E / 8) row groups; chunks
//     t, t + 256, ... of every row otherwise), writes dx, and adds dy * xhat
//     (an fma) and dy into its dg/db registers in row order. g is read once a
//     CTA (into registers at E <= 2048, into shared memory past it, where the
//     registers go to the wider row's dg/db). No sum crosses warps per row.
//   - dg/db: the CTA adds its row groups in group order into its fp32 partial
//     [2, E]; a grid barrier (an arrival counter the last CTA resets, and a
//     generation word); then CTA c sums its ceil(2E / n_ctas) columns of the
//     [n_ctas, 2E] partials, min(that, 256) columns at a time: 256 / width
//     groups of threads each add every (256 / width)-th partial in CTA order,
//     and the groups' sums are added in group order. No float atomics:
//     repeated runs agree bit for bit. ops/layer_norm_tiles.py walks the same
//     order in numpy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The backward's timeline, built only with -DDALLE_LN_TIMELINE
// (tools/ln_timeline.py): thread 0 of each CTA stamps the card's clock on
// entry, when its first tile has arrived, after its last tile, with its
// partial written, past the grid barrier, and at the end. Compiled out
// otherwise.
#ifdef DALLE_LN_TIMELINE
__device__ unsigned long long ln_timeline[4096][6];
#define LN_STAMP(k)                                                         \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      unsigned long long t;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                 \
      ln_timeline[blockIdx.x][k] = t;                                       \
    }                                                                       \
  } while (0)
extern "C" int layer_norm_timeline(void* out) {
  return (int)cudaMemcpyFromSymbol(out, ln_timeline, sizeof(ln_timeline));
}
#else
#define LN_STAMP(k) \
  do {              \
  } while (0)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                // elements a thread loads at once
constexpr int kStep = 32 * kVec;       // columns a warp covers per step
constexpr int kMaxE = 8192;
constexpr int kMaxWarpRowE = 4096;     // the forward's warp-a-row kernel: 16 steps
constexpr int kCtaStep = kThreads * kVec;  // columns a CTA covers per step
constexpr int kMaxTileRows = 64;
constexpr int kStages = 2;             // the backward's ring of tiles
constexpr int kMaxSmem = 232448;       // 227 KB, the most a block may use
constexpr int kBarBytes = 128;         // the stages' mbarriers, padded

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

// ---------------------------------------------------------------- forward

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

// The sum over the CTA of each thread's v, in warp order; `red` holds the 8
// warps' sums (a slot of its own for each reduction of a row, so one barrier
// each).
__device__ __forceinline__ float cta_sum(float v, float* red, int warp, int lane) {
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Rows wider than the warp kernel holds: a CTA a row, STEPS steps of 2048
// columns a CTA, the row in registers.
template <typename T, int STEPS>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ b, T* __restrict__ y, int e,
                           float eps) {
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * e;
  float v[STEPS * kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int col = i * kCtaStep + tid * kVec;
    if (col < e) {
      load8(xr + col, v + i * kVec);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += v[i * kVec + j];
    }
  }
  const float mean = cta_sum(sum, red[0], warp, lane) / (float)e;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    if (i * kCtaStep + tid * kVec < e) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[i * kVec + j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(cta_sum(sq, red[1], warp, lane) / (float)e + eps);
  T* yr = y + row * e;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int col = i * kCtaStep + tid * kVec;
    if (col < e) {
      float gv[kVec], bv[kVec], out[kVec];
      load8(g + col, gv);
      load8(b + col, bv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = (v[i * kVec + j] - mean) * rstd * gv[j] + bv[j];
      store8(yr + col, out);
    }
  }
}

// --------------------------------------------------------------- backward

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every CTA of the (cooperative, all-resident) grid arrives before any
// leaves. bar[0] counts arrivals and is reset by the last CTA, which then
// advances the generation bar[1] that the others wait on.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == seen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The layout of the backward's dynamic shared memory.
struct BwdSmem {
  int stage_bytes, stages_off, g_off, stats_off, wred_off, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int e, int elem, int rt) {
  BwdSmem s;
  const int n_chunks = e / kVec;
  const int groups = n_chunks >= kThreads ? 1 : kThreads / n_chunks;
  s.stage_bytes = 2 * rt * e * elem;
  s.stages_off = kBarBytes;
  int ring = kStages * s.stage_bytes;
  const int red = 2 * groups * e * 4;  // the row groups' dg/db, after the ring
  if (red > ring) ring = red;
  s.g_off = s.stages_off + ring;
  s.stats_off = s.g_off + e * 4;
  s.wred_off = s.stats_off + rt * 16;
  s.total = s.wred_off + 4 * kWarps * 4;
  return s;
}

// Each of the N values v summed over a row's warps (wpr of them,
// consecutive): a warp sum, then through `wred` slots [slot, slot + N) when
// a row spans warps, one barrier for the N. wpr is the same for the whole
// CTA, so the barrier is reached by every thread or none.
template <int N>
__device__ __forceinline__ void row_sums(float (&v)[N], int slot, int wpr, float* wred,
                                         int warp, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (wpr == 1) return;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) wred[(slot + k) * kWarps + warp] = v[k];
  }
  __syncthreads();
  const int first = warp - warp % wpr;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
    for (int i = 0; i < wpr; ++i) s += wred[(slot + k) * kWarps + first + i];
    v[k] = s;
  }
}

// Three CTAs an SM at one chunk a thread (80 registers), two at more.
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads, CPT == 1 ? 3 : 2)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ partial, unsigned int* __restrict__ barrier,
                      float* __restrict__ dg_out, float* __restrict__ db_out, int rows, int e,
                      int rt, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem L = bwd_smem(e, (int)sizeof(T), rt);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* gs = reinterpret_cast<float*>(smem + L.g_off);
  float4* stats = reinterpret_cast<float4*>(smem + L.stats_off);
  float* wred = reinterpret_cast<float*>(smem + L.wred_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cta = blockIdx.x, n_ctas = gridDim.x;
  const int n_chunks = e / kVec;
  const int groups = n_chunks >= kThreads ? 1 : kThreads / n_chunks;
  const int group = n_chunks >= kThreads ? 0 : tid / n_chunks;
  const int wpr = rt >= kWarps ? 1 : kWarps / rt;  // warps a row in phase A
  const int row_elems = rt * e;

  // this CTA's rows: a contiguous range, the rows split as evenly as they go
  const int64_t r_begin = (int64_t)cta * rows / n_ctas;
  const int64_t r_end = (int64_t)(cta + 1) * rows / n_ctas;
  const int my_tiles = (int)((r_end - r_begin + rt - 1) / rt);

  auto stage_tile = [&](int local) {  // thread 0: stage the CTA's tile `local`
    const int64_t r0 = r_begin + (int64_t)local * rt;
    const int nr = (int)min((int64_t)rt, r_end - r0);
    const uint32_t bytes = (uint32_t)nr * e * sizeof(T);
    unsigned char* st = smem + L.stages_off + (local % kStages) * L.stage_bytes;
    uint64_t* bar = bars + local % kStages;
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(st, x + r0 * e, bytes, bar);
    bulk_load(st + (size_t)row_elems * sizeof(T), dy + r0 * e, bytes, bar);
  };

  LN_STAMP(0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages && i < my_tiles; ++i) stage_tile(i);
  }
  for (int c = tid; c < e; c += kThreads) gs[c] = g[c];
  // this thread's columns (phase B); their g in registers at one chunk a
  // thread, read from shared memory at more (so that two CTAs fit an SM)
  constexpr bool kGInRegs = CPT == 1;
  float gv[kGInRegs ? kVec : 1], dgv[CPT][kVec], dbv[CPT][kVec];
  bool owns[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int chunk = n_chunks >= kThreads ? tid + k * kThreads : tid % n_chunks;
    owns[k] = group < groups && chunk < n_chunks && (k == 0 || n_chunks >= kThreads);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dgv[k][j] = dbv[k][j] = 0.f;
  }
  if constexpr (kGInRegs) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) gv[j] = 0.f;
    if (owns[0]) load8(g + (tid % n_chunks) * kVec, gv);
  }
  __syncthreads();

  for (int i = 0; i < my_tiles; ++i) {
    const int64_t r0 = r_begin + (int64_t)i * rt;
    const int nr = (int)min((int64_t)rt, r_end - r0);
    const T* xs = reinterpret_cast<const T*>(smem + L.stages_off + (i % kStages) * L.stage_bytes);
    const T* dys = xs + row_elems;
    mbar_wait(bars + i % kStages, (uint32_t)(i / kStages) & 1u);
    if (i == 0) LN_STAMP(1);

    // phase A: mean, rstd, mean(dxhat), mean(dxhat * xhat) of each row
    const int seg = warp % wpr;
    for (int j = warp / wpr; j < rt; j += kWarps / wpr) {
      const bool live = j < nr;
      const T* xr = xs + j * e;
      const T* dyr = dys + j * e;
      float s[1] = {0.f};
      if (live) {
        for (int c = seg * 32 + lane; c < n_chunks; c += 32 * wpr) {
          float v[kVec];
          load8(xr + c * kVec, v);
#pragma unroll
          for (int q = 0; q < kVec; ++q) s[0] += v[q];
        }
      }
      row_sums(s, 0, wpr, wred, warp, lane);
      const float mean = s[0] / (float)e;
      // the variance and both means of dxhat in one pass: dxhat * xhat is
      // summed as dxhat * (x - mean), times rstd after the sum
      float sums[3] = {0.f, 0.f, 0.f};
      if (live) {
        for (int c = seg * 32 + lane; c < n_chunks; c += 32 * wpr) {
          float v[kVec], d[kVec];
          load8(xr + c * kVec, v);
          load8(dyr + c * kVec, d);
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            const float xc = v[q] - mean;
            const float dxh = d[q] * gs[c * kVec + q];
            sums[0] += xc * xc;
            sums[1] += dxh;
            sums[2] += dxh * xc;
          }
        }
      }
      row_sums(sums, 1, wpr, wred, warp, lane);
      const float rstd = rsqrtf(sums[0] / (float)e + eps);
      const float m1 = sums[1] / (float)e, m2 = sums[2] / (float)e * rstd;
      if (live && seg == 0 && lane == 0) stats[j] = make_float4(mean, rstd, m1, m2);
    }
    __syncthreads();

    // phase B: dx, and dg/db by column in row order
    for (int j = group; j < nr; j += groups) {
      const float4 st = stats[j];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        if (!owns[k]) continue;
        const int col = (n_chunks >= kThreads ? tid + k * kThreads : tid % n_chunks) * kVec;
        float v[kVec], d[kVec], gk[kVec], out[kVec];
        load8(xs + j * e + col, v);
        load8(dys + j * e + col, d);
        if constexpr (kGInRegs) {
#pragma unroll
          for (int q = 0; q < kVec; ++q) gk[q] = gv[q];
        } else {
          load8(gs + col, gk);
        }
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          const float xh = (v[q] - st.x) * st.y;
          dgv[k][q] = fmaf(d[q], xh, dgv[k][q]);
          dbv[k][q] += d[q];
          out[q] = st.y * (d[q] * gk[q] - st.z - xh * st.w);
        }
        store8(dx + (r0 + j) * e + col, out);
      }
    }
    __syncthreads();  // the stage and the stats are free
    if (tid == 0 && i + kStages < my_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_tile(i + kStages);
    }
  }

  LN_STAMP(2);
  // this CTA's partial [2, e]: its row groups added in group order
  float* part = partial + (int64_t)cta * 2 * e;
  if (groups == 1) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (!owns[k]) continue;
      const int col = (tid + k * kThreads) * kVec;
      store8(part + col, dgv[k]);
      store8(part + e + col, dbv[k]);
    }
  } else {
    float* red = reinterpret_cast<float*>(smem + L.stages_off);  // [groups][2e]
    if (owns[0]) {
      const int col = (tid % n_chunks) * kVec;
      store8(red + group * 2 * e + col, dgv[0]);
      store8(red + group * 2 * e + e + col, dbv[0]);
    }
    __syncthreads();
    for (int c = tid; c < 2 * e; c += kThreads) {
      float s = 0.f;
      for (int gi = 0; gi < groups; ++gi) s += red[gi * 2 * e + c];
      part[c] = s;
    }
  }

#ifdef DALLE_LN_TIMELINE
  __syncthreads();
#endif
  LN_STAMP(3);
  grid_barrier(barrier);
  LN_STAMP(4);

  // dg, db: CTA c sums the `cols` columns [c cols, (c + 1) cols) of the
  // [n_ctas, 2e] partials, `width` at a time; column thread pc of partial
  // group pg adds the partials pg, pg + groups, ... in order (8 loads in
  // flight), then the groups' sums are added in group order
  const int cols = (2 * e + n_ctas - 1) / n_ctas;
  const int width = min(cols, kThreads), pgroups = kThreads / width;
  const int pg = tid / width, pc = tid % width;
  const int first = cta * cols, last = min(2 * e, first + cols);
  float* fin = reinterpret_cast<float*>(smem + L.stages_off);  // [pgroups][width]
  for (int c0 = first; c0 < last; c0 += width) {
    const int c = c0 + pc;
    if (pg < pgroups) {
      float s = 0.f;
      if (c < last) {
        int p = pg;
        for (; p + 7 * pgroups < n_ctas; p += 8 * pgroups) {
          float t[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            t[q] = __ldcg(partial + (int64_t)(p + q * pgroups) * 2 * e + c);
#pragma unroll
          for (int q = 0; q < 8; ++q) s += t[q];
        }
        for (; p < n_ctas; p += pgroups) s += __ldcg(partial + (int64_t)p * 2 * e + c);
      }
      fin[pg * width + pc] = s;
    }
    __syncthreads();
    if (tid < width && c0 + tid < last) {
      float t = 0.f;
      for (int r = 0; r < pgroups; ++r) t += fin[r * width + tid];
      if (c0 + tid < e) dg_out[c0 + tid] = t;
      else db_out[c0 + tid - e] = t;
    }
    __syncthreads();
  }
  LN_STAMP(5);
}

// ------------------------------------------------------------- launchers

template <typename T, int VPL>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, void* y, int rows,
                       int e, float eps, cudaStream_t stream) {
  const int ctas = (rows + kWarps - 1) / kWarps;
  layer_norm_fwd_kernel<T, VPL><<<ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(y), rows, e, eps);
  return cudaGetLastError();
}

template <typename T, int STEPS>
cudaError_t launch_fwd_wide(const void* x, const void* g, const void* b, void* y, int rows,
                            int e, float eps, cudaStream_t stream) {
  layer_norm_fwd_wide_kernel<T, STEPS><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(y), e, eps);
  return cudaGetLastError();
}

template <typename T, int CPT>
cudaError_t bwd_opt_in() {  // once an instantiation: the most a block may use
  static const cudaError_t err = cudaFuncSetAttribute(
      layer_norm_bwd_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

template <typename T, int CPT>
cudaError_t launch_bwd(const void* x, const void* dy, const void* g, void* dx, void* partial,
                       void* barrier, void* dg, void* db, int rows, int e, int rt, int n_ctas,
                       float eps, cudaStream_t stream) {
  cudaError_t err = bwd_opt_in<T, CPT>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bwd_smem(e, (int)sizeof(T), rt).total;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, layer_norm_bwd_kernel<T, CPT>, static_cast<const T*>(x),
                           static_cast<const T*>(dy), static_cast<const float*>(g),
                           static_cast<T*>(dx), static_cast<float*>(partial),
                           static_cast<unsigned int*>(barrier), static_cast<float*>(dg),
                           static_cast<float*>(db), rows, e, rt, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// out[0..5) = registers a thread, local (spill) bytes a thread, static
// shared memory a CTA, dynamic shared memory a CTA, CTAs an SM.
template <typename K>
cudaError_t info_of(K kernel, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = smem;
  out[4] = ctas;
  return err;
}

// The forward's steps a lane takes (warp kernel): the power of two >= e / 256.
int warp_steps(int e) {
  int vpl = 1;
  while (vpl * kStep < e) vpl *= 2;
  return vpl;
}

bool valid(int rows, int e) { return rows > 0 && e > 0 && e % kVec == 0 && e <= kMaxE; }

// Rows a tile the backward takes: a power of two up to 64 whose stages fit
// in what a block may use.
bool valid_tile_rows(int e, int elem, int rt) {
  return rt >= 1 && rt <= kMaxTileRows && !(rt & (rt - 1)) &&
         bwd_smem(e, elem, rt).total <= kMaxSmem;
}

// Chunks of 8 columns a thread owns in the backward: ceil(e / 2048).
int bwd_cpt(int e) { return (e + kCtaStep - 1) / kCtaStep; }

}  // namespace

#define DALLE_LN_FWD(T)                                                           \
  if (e > kMaxWarpRowE)                                                           \
    return (int)(e > 3 * kCtaStep ? launch_fwd_wide<T, 4>(x, g, b, y, rows, e, eps, s) \
                                  : launch_fwd_wide<T, 3>(x, g, b, y, rows, e, eps, s)); \
  switch (warp_steps(e)) {                                                        \
    case 1: return (int)launch_fwd<T, 1>(x, g, b, y, rows, e, eps, s);            \
    case 2: return (int)launch_fwd<T, 2>(x, g, b, y, rows, e, eps, s);            \
    case 4: return (int)launch_fwd<T, 4>(x, g, b, y, rows, e, eps, s);            \
    case 8: return (int)launch_fwd<T, 8>(x, g, b, y, rows, e, eps, s);            \
    default: return (int)launch_fwd<T, 16>(x, g, b, y, rows, e, eps, s);         \
  }

// x, y [rows, e] row-major, 16-byte aligned; g, b fp32 [e], 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int layer_norm_fwd(const void* x, const void* g, const void* b, void* y, int rows,
                              int e, int dtype, float eps, void* stream) {
  if (!valid(rows, e) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) { DALLE_LN_FWD(float) }
  DALLE_LN_FWD(__nv_bfloat16)
  return (int)cudaErrorInvalidValue;
}

#define DALLE_LN_BWD(T)                                                                     \
  switch (bwd_cpt(e)) {                                                                     \
    case 1: return (int)launch_bwd<T, 1>(x, dy, g, dx, partial, barrier, dg, db, rows, e,   \
                                         rt, n_ctas, eps, s);                               \
    case 2: return (int)launch_bwd<T, 2>(x, dy, g, dx, partial, barrier, dg, db, rows, e,   \
                                         rt, n_ctas, eps, s);                               \
    case 3: return (int)launch_bwd<T, 3>(x, dy, g, dx, partial, barrier, dg, db, rows, e,   \
                                         rt, n_ctas, eps, s);                               \
    default: return (int)launch_bwd<T, 4>(x, dy, g, dx, partial, barrier, dg, db, rows, e,  \
                                          rt, n_ctas, eps, s);                              \
  }

// x, dy, dx [rows, e] as the forward's x; g fp32 [e]; partial fp32
// [n_ctas, 2, e] scratch; barrier two uint32 words, zero before the first
// call and left zero by every call (one per stream: launches that overlap
// must not share it); dg, db fp32 [e]. rt rows a tile
// (ops/layer_norm.py::bwd_tile_rows); n_ctas CTAs, at most the tiles and at
// most the SMs times the CTAs an SM holds (layer_norm_info). One cooperative
// launch. Returns its cudaError_t.
extern "C" int layer_norm_bwd(const void* x, const void* dy, const void* g, void* dx,
                              void* partial, void* barrier, void* dg, void* db, int rows, int e,
                              int rt, int n_ctas, int dtype, float eps, void* stream) {
  if (!valid(rows, e) || (dtype != 0 && dtype != 1) ||
      !valid_tile_rows(e, dtype == 0 ? 4 : 2, rt) || n_ctas <= 0 || n_ctas > (rows + rt - 1) / rt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) { DALLE_LN_BWD(float) }
  DALLE_LN_BWD(__nv_bfloat16)
  return (int)cudaErrorInvalidValue;
}

// What a kernel takes at e: kind 0 the forward (the warp kernel up to 4096,
// the CTA-a-row kernel past it), 1 the backward at rt rows a tile.
// out[0..5) = registers, spill bytes, static and dynamic shared memory, CTAs
// an SM.
extern "C" int layer_norm_info(int kind, int e, int dtype, int rt, int* out) {
  if (!valid(1, e) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (kind == 0) {
    if (e > kMaxWarpRowE) {
      const bool four = e > 3 * kCtaStep;
      if (dtype == 0)
        return (int)(four ? info_of(layer_norm_fwd_wide_kernel<float, 4>, 0, out)
                          : info_of(layer_norm_fwd_wide_kernel<float, 3>, 0, out));
      return (int)(four ? info_of(layer_norm_fwd_wide_kernel<__nv_bfloat16, 4>, 0, out)
                        : info_of(layer_norm_fwd_wide_kernel<__nv_bfloat16, 3>, 0, out));
    }
#define LN_FWD_INFO(T)                                                       \
  switch (warp_steps(e)) {                                                   \
    case 1: return (int)info_of(layer_norm_fwd_kernel<T, 1>, 0, out);        \
    case 2: return (int)info_of(layer_norm_fwd_kernel<T, 2>, 0, out);        \
    case 4: return (int)info_of(layer_norm_fwd_kernel<T, 4>, 0, out);        \
    case 8: return (int)info_of(layer_norm_fwd_kernel<T, 8>, 0, out);        \
    default: return (int)info_of(layer_norm_fwd_kernel<T, 16>, 0, out);      \
  }
    if (dtype == 0) { LN_FWD_INFO(float) }
    LN_FWD_INFO(__nv_bfloat16)
#undef LN_FWD_INFO
  }
  if (kind != 1 || !valid_tile_rows(e, dtype == 0 ? 4 : 2, rt)) return (int)cudaErrorInvalidValue;
  const int smem = bwd_smem(e, dtype == 0 ? 4 : 2, rt).total;
#define LN_BWD_INFO(T)                                                                     \
  {                                                                                        \
    cudaError_t err;                                                                       \
    switch (bwd_cpt(e)) {                                                                  \
      case 1: err = bwd_opt_in<T, 1>(); if (err) return (int)err;                         \
        return (int)info_of(layer_norm_bwd_kernel<T, 1>, smem, out);                       \
      case 2: err = bwd_opt_in<T, 2>(); if (err) return (int)err;                         \
        return (int)info_of(layer_norm_bwd_kernel<T, 2>, smem, out);                       \
      case 3: err = bwd_opt_in<T, 3>(); if (err) return (int)err;                         \
        return (int)info_of(layer_norm_bwd_kernel<T, 3>, smem, out);                       \
      default: err = bwd_opt_in<T, 4>(); if (err) return (int)err;                        \
        return (int)info_of(layer_norm_bwd_kernel<T, 4>, smem, out);                       \
    }                                                                                      \
  }
  if (dtype == 0) LN_BWD_INFO(float)
  LN_BWD_INFO(__nv_bfloat16)
#undef LN_BWD_INFO
  return (int)cudaErrorInvalidValue;
}
