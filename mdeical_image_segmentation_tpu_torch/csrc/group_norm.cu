// GroupNorm streaming kernels for Hopper (sm_90a), channels-last x (N, S, C):
//   tpuseg_gn_stats:      per-(sample n, channel c) fp32 sums  s1 = sum x,
//                         s2 = sum x^2  over the spatial positions of x
//   tpuseg_gn_affine:     y = x * a[n, c] + b[n, c], rounded to x's dtype
//   tpuseg_gn_bwd_reduce: per-(n, c) fp32 sums  c1 = sum g,
//                         c2 = sum g * xhat  with xhat = (x - mean) * inv
//                         formed in registers from the residual x
//   tpuseg_gn_bwd_dx:     dx = g * A[n, c] + x * C[n, c] + D[n, c], rounded
//                         to x's dtype
// x, g, y and dx are fp32 or bf16 (g in x's dtype); a, b, mean, inv, A, C,
// D and the sums are (N, C) fp32.
//
// Replace the Pallas TPU kernels `_stats_kernel`, `_affine_kernel`,
// `_bwd_reduce_kernel` and `_bwd_dx_kernel` (run through `_gn_grid` /
// `_gn_pallas_stats` / `_gn_fwd_pallas` / `_gn_bwd_reduce` /
// `_gn_bwd_pallas`) in mdeical_image_segmentation_tpu/ops/norm.py.  The
// group combine of the (N, C) sums, the variance max(0, E[x^2] - mean^2),
// rsqrt(var + eps) and the backward coefficients (`_gn_bwd_coeffs`) stay
// outside, on the tiny (N, C) arrays, as in the JAX package.
//
// What bounds them on the H100.  All four are streaming passes with a
// handful of FLOP per element: device-memory bandwidth is the limit
// (3.35 TB/s), so each reads its full-size inputs once, in their own dtype,
// and the affine and dx passes write their output once.  The backward
// keeps no normalized tensor: x-hat is recomputed in registers.
//
// Design of stats and bwd_reduce (one partial kernel, templated on what an
// element adds).  A grid-stride walk over the 16-byte vectors of one sample
// (V = 4 fp32 or 8 bf16 consecutive values), the grid sized from the card
// (at most REDUCE_WAVES waves of resident blocks over the SMs, shared by the
// N samples) and from the work (about REDUCE_STEPS steps per thread), not
// from the row count.  Vector t of the walk holds channels
// (t % (C / V)) * V .. + V - 1 and the stride is a multiple of C / V, so a
// thread keeps V channels, and in the backward their V (mean, inv) pairs,
// for its whole walk, with V x 2 fp32 sums in registers; it keeps UNROLL
// independent 16-byte loads in flight per step (of x, and of g in the
// backward, through the read-only path).  Where C divides V (C = 1 at the
// UNet's input) and S * C is a multiple of V, a vector holds V / C whole
// rows and slot k of every thread is channel k % C.  Ragged C and
// unaligned pointers take the same kernel with scalar units (V = 1, the
// stride a multiple of C); where a row holds more units than a block has
// threads, no two threads of a block share channels.  The grid is large
// enough that no fp32 accumulator adds more than MAX_TERMS terms in
// sequence (the launcher refuses a grid that is not).
// The TPU grid runs in order and carries row accumulators from step to
// step; a GPU grid runs in parallel, so the sum is hierarchical and
// deterministic (no atomics, the same bits on every call on one card):
// the threads of a block that share a channel group (thread ids congruent
// modulo C / V) combine through shared memory in a fixed tree, the block
// writes one partial per (n, c, block) to scratch, and a second kernel
// reduces the G partials of each (n, c) with a fixed tree.
// Design of dx.  A block owns a contiguous range of rows (spatial
// positions) of one sample, its threads laid out as RL row lanes x CL
// channel lanes (CL = min(C, 256), RL = 256 / CL), each thread keeping one
// channel's coefficients in registers.  Every product and sum rounds on its
// own (__fmul_rn / __fadd_rn, no contraction into an FMA), in the order the
// plain PyTorch version computes them, so the kernel agrees with it bit
// for bit.
// All offsets into the full-size tensors are 64-bit (a decoder input of the
// 3D UNet at batch 4 holds 4.7e9 elements).
// Row windows (the cross-shard GroupNorm of spatial sharding,
// ops/norm.py::cross_shard_group_stats).  x is (N, outer, extent, inner, C)
// around one spatial axis of `extent` rows, and [lo, hi) is the slab's
// interior along it.  tpuseg_gn_stats then sums only the interior rows, and
// tpuseg_gn_bwd_dx writes g * A + x * C + D there and g * A on the rest.
// The window is walked in place: the statistics walk runs over the units of
// the interior as one flat range and maps each to its address (a 32-bit
// divide by the window's units a run), so no copy of the interior is made
// and no halo sums are subtracted from whole-slab sums (which would lose
// the precision of sum x^2); the dx kernel tests each row's place along the
// axis.  The full window (lo = 0, hi = extent) launches the instantiation
// without a window, the same kernel and grid as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 16-byte vector of the walks: 4 fp32 or 8 bf16 values in a uint4.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ float lo(unsigned w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
  }
  static __device__ __forceinline__ float hi(unsigned w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
  }
  static __device__ __forceinline__ unsigned two(float a, float b) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = lo(u.x); f[1] = hi(u.x); f[2] = lo(u.y); f[3] = hi(u.y);
    f[4] = lo(u.z); f[5] = hi(u.z); f[6] = lo(u.w); f[7] = hi(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]),
                      two(f[6], f[7]));
  }
};

constexpr int UNROLL = 4;  // independent 16-byte loads in flight per thread

// The units a windowed statistics walk covers: the sample's units are
// `outer` runs of `ext` units, and units [lo, lo + win) of each run are
// walked, as one flat range of outer * win units.  All below 2^31 (the
// launcher refuses more).
struct UnitWindow {
  uint32_t win, ext, lo;
};

template <bool WIN>
__device__ __forceinline__ int64_t unit_at(int64_t i, const UnitWindow& w) {
  if constexpr (!WIN) {
    return i;
  } else {
    const uint32_t u = (uint32_t)i;
    const uint32_t run = u / w.win;
    return (int64_t)run * w.ext + w.lo + (u - run * w.win);
  }
}

// The interior rows of a windowed dx launch: row r of a sample is interior
// when lo <= r % plane < hi (plane = extent * inner rows, lo and hi scaled
// by inner).  Below 2^31 rows (the launcher refuses more).
struct RowWindow {
  uint32_t plane, lo, hi;
};

// The reductions' grid (see reduce_blocks): at most REDUCE_WAVES waves of
// resident blocks, about REDUCE_STEPS walk steps per thread, and no fp32
// accumulator adding more than MAX_TERMS terms in sequence.
constexpr int REDUCE_WAVES = 2;
constexpr int REDUCE_STEPS = 8;
constexpr int MAX_TERMS = 1024;

// The unit of a reduction's walk: 0 = one scalar, 1 = a 16-byte vector of
// V channels of one row (C % V == 0), 2 = a 16-byte vector of V / C whole
// rows (V % C == 0 and S * C % V == 0).  Vectors need x (and g) 16-byte
// aligned.
int reduce_mode(bool aligned, long long S, int C, int V) {
  if (!aligned) return 0;
  if (C % V == 0) return 1;
  if (V % C == 0 && S * C % V == 0) return 2;
  return 0;
}

// Thread t of the walk: the channel group of its units (all of them the
// same, the stride a multiple of `lanes`).
__host__ __device__ __forceinline__ int reduce_lanes(int mode, int C, int V) {
  return mode == 1 ? C / V : (mode == 2 ? 1 : C);
}

// One thread's walk over units t, t + stride, ... below `units` of one
// sample, W values a unit (W = V or 1), UNROLL loads in flight a step;
// slot k of the sums is channel (c0 + k) % C.
// BWD = false: s1 += x, s2 += x * x.
// BWD = true:  s1 += g, s2 += g * (x - mean) * inv.
// WIN: unit i of the walk is unit unit_at(i, w) of the sample.
template <typename T, bool BWD, bool WIN, int W>
__device__ __forceinline__ void partial_walk(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ inv,
    int64_t units, int C, int c0, int64_t t, int64_t stride,
    const UnitWindow& w, float* s1, float* s2) {
  float m[W], v[W];
  if constexpr (BWD) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int c = (c0 + k) % C;
      m[k] = mean[c];
      v[k] = inv[c];
    }
  }
  for (int64_t i = t; i < units; i += UNROLL * stride) {
    if constexpr (W == 1) {
      T xr[UNROLL], gr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u * stride < units) {
          const int64_t a = unit_at<WIN>(i + u * stride, w);
          xr[u] = __ldg(x + a);
          if constexpr (BWD) gr[u] = __ldg(g + a);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u * stride < units) {
          const float xv = to_f(xr[u]);
          if constexpr (BWD) {
            const float gv = to_f(gr[u]);
            s1[0] += gv;
            s2[0] = fmaf(gv, __fmul_rn(__fsub_rn(xv, m[0]), v[0]), s2[0]);
          } else {
            s1[0] += xv;
            s2[0] = fmaf(xv, xv, s2[0]);
          }
        }
      }
    } else {
      const uint4* xv = reinterpret_cast<const uint4*>(x);
      const uint4* gv = reinterpret_cast<const uint4*>(g);
      uint4 xr[UNROLL], gr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u * stride < units) {
          const int64_t a = unit_at<WIN>(i + u * stride, w);
          xr[u] = __ldg(xv + a);
          if constexpr (BWD) gr[u] = __ldg(gv + a);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u * stride < units) {
          float f[W];
          Vec16<T>::unpack(xr[u], f);
          if constexpr (BWD) {
            float gf[W];
            Vec16<T>::unpack(gr[u], gf);
#pragma unroll
            for (int k = 0; k < W; ++k) {
              s1[k] += gf[k];
              s2[k] = fmaf(gf[k], __fmul_rn(__fsub_rn(f[k], m[k]), v[k]),
                           s2[k]);
            }
          } else {
#pragma unroll
            for (int k = 0; k < W; ++k) {
              s1[k] += f[k];
              s2[k] = fmaf(f[k], f[k], s2[k]);
            }
          }
        }
      }
    }
  }
}

// Pass 1: grid (G, N).  partial layout: [2][N][C][G] (s1 then s2); every
// block writes all C of its partials (0 for a channel none of its threads
// walked).  The walk covers `units` units of each sample of S rows: all of
// them, or with WIN the window w's.
template <typename T, bool BWD, bool WIN>
__global__ void __launch_bounds__(NT) gn_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ partial, int N, int64_t S, int C, int G, int mode,
    int64_t units, UnitWindow w) {
  constexpr int V = Vec16<T>::V;
  __shared__ float sh1[V * NT];  // [slot k][thread]
  __shared__ float sh2[V * NT];
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int W = mode ? V : 1;
  const int lanes = reduce_lanes(mode, C, V);
  const int64_t stride = (int64_t)gridDim.x * NT / lanes * lanes;
  const int64_t t = (int64_t)blockIdx.x * NT + tid;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (t < stride) {  // the threads beyond the stride add nothing
    const int64_t sample = (int64_t)n * S * C;
    const int c0 = (int)(t % lanes) * W;
    const T* gs = BWD ? g + sample : nullptr;
    const float* ms = BWD ? mean + (int64_t)n * C : nullptr;
    const float* vs = BWD ? inv + (int64_t)n * C : nullptr;
    if (mode)
      partial_walk<T, BWD, WIN, V>(x + sample, gs, ms, vs, units, C, c0, t,
                                   stride, w, s1, s2);
    else
      partial_walk<T, BWD, WIN, 1>(x + sample, gs, ms, vs, units, C, c0, t,
                                   stride, w, s1, s2);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sh1[k * NT + tid] = s1[k];
    sh2[k * NT + tid] = s2[k];
  }
  __syncthreads();
  // threads tid, tid + lanes, ... walk the same channels: a tree over
  // their rows (tid / lanes) leaves the block's sum in thread (tid % lanes)
  // of row 0; with lanes >= NT every thread is its own root
  const int rows = (NT + lanes - 1) / lanes;
  const int r = tid / lanes;
  for (int step = 1; step < rows; step *= 2) {
    if (r % (2 * step) == 0 && tid + step * lanes < NT) {
      for (int k = 0; k < W; ++k) {
        sh1[k * NT + tid] += sh1[k * NT + tid + step * lanes];
        sh2[k * NT + tid] += sh2[k * NT + tid + step * lanes];
      }
    }
    __syncthreads();
  }
  // channel c lies in group j, held by root o (the thread of the block whose
  // walk has group j), in slot k (or, mode 2, slots c, c + C, ...)
  const int base = (int)((int64_t)blockIdx.x * NT % lanes);
  float* p1 = partial + (int64_t)n * C * G;
  float* p2 = partial + ((int64_t)N + n) * C * G;
  for (int c = tid; c < C; c += NT) {
    const int j = mode == 1 ? c / V : (mode == 2 ? 0 : c);
    const int o = (j - base + lanes) % lanes;
    float a1 = 0.f, a2 = 0.f;
    if (o < NT) {
      const int k0 = mode == 1 ? c % V : (mode == 2 ? c : 0);
      const int kstep = mode == 2 ? C : V;
      for (int k = k0; k < W; k += kstep) {
        a1 += sh1[k * NT + o];
        a2 += sh2[k * NT + o];
      }
    }
    p1[(int64_t)c * G + blockIdx.x] = a1;
    p2[(int64_t)c * G + blockIdx.x] = a2;
  }
}

// Pass 2: grid (C, N), one block per (n, c) reduces its G partials.
__global__ void __launch_bounds__(NT) gn_stats_final_kernel(
    const float* __restrict__ partial, float* __restrict__ s1,
    float* __restrict__ s2, int N, int C, int G) {
  __shared__ float sh1[NT];
  __shared__ float sh2[NT];
  const int c = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const float* p1 = partial + ((int64_t)n * C + c) * G;
  const float* p2 = partial + (((int64_t)N + n) * C + c) * G;
  float a1 = 0.f, a2 = 0.f;
  for (int g = tid; g < G; g += NT) {
    a1 += p1[g];
    a2 += p2[g];
  }
  sh1[tid] = a1;
  sh2[tid] = a2;
  __syncthreads();
  for (int half = NT / 2; half > 0; half /= 2) {
    if (tid < half) {
      sh1[tid] += sh1[tid + half];
      sh2[tid] += sh2[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    s1[(int64_t)n * C + c] = sh1[0];
    s2[(int64_t)n * C + c] = sh2[0];
  }
}

// The walk of one thread over units of V values (a 16-byte vector, or V = 1
// scalar) of sample n: unit t, t + stride, ... below `units`, with stride a
// multiple of C / V so the unit's channels stay c0 .. c0 + V - 1.
template <typename T, int V>
__device__ __forceinline__ void affine_walk(
    const T* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, T* __restrict__ y, int64_t units, int C,
    int64_t t, int64_t stride) {
  const int c0 = (int)(t % (C / V)) * V;
  float av[V], bv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    av[k] = a[c0 + k];
    bv[k] = b[c0 + k];
  }
  for (int64_t i = t; i < units; i += UNROLL * stride) {
    if constexpr (V == 1) {
      T raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i + u * stride < units) raw[u] = x[i + u * stride];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i + u * stride < units)
          y[i + u * stride] =
              from_f<T>(__fadd_rn(__fmul_rn(to_f(raw[u]), av[0]), bv[0]));
    } else {
      const uint4* xv = reinterpret_cast<const uint4*>(x);
      uint4* yv = reinterpret_cast<uint4*>(y);
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i + u * stride < units) raw[u] = __ldg(xv + i + u * stride);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u * stride < units) {
          float f[V];
          Vec16<T>::unpack(raw[u], f);
#pragma unroll
          for (int k = 0; k < V; ++k)
            f[k] = __fadd_rn(__fmul_rn(f[k], av[k]), bv[k]);
          yv[i + u * stride] = Vec16<T>::pack(f);
        }
      }
    }
  }
}

// grid (G, N): the G * NT threads of sample n walk its S * C values, as
// 16-byte vectors when `vec` (C % V == 0, x and y 16-byte aligned), else as
// scalars.
template <typename T>
__global__ void __launch_bounds__(NT) gn_affine_kernel(
    const T* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, T* __restrict__ y, int64_t S, int C,
    bool vec) {
  constexpr int V = Vec16<T>::V;
  const int n = blockIdx.y;
  const int64_t sample = (int64_t)n * S * C;
  const int64_t t = (int64_t)blockIdx.x * NT + threadIdx.x;
  // units per row; the stride is the largest multiple of it that the grid
  // holds (the launcher gives at least `lanes` threads)
  const int lanes = vec ? C / V : C;
  const int64_t stride = (int64_t)gridDim.x * NT / lanes * lanes;
  if (t >= stride) return;
  if (vec)
    affine_walk<T, V>(x + sample, a + (int64_t)n * C, b + (int64_t)n * C,
                      y + sample, S * C / V, C, t, stride);
  else
    affine_walk<T, 1>(x + sample, a + (int64_t)n * C, b + (int64_t)n * C,
                      y + sample, S * C, C, t, stride);
}

// Blocks per sample of the affine: enough for every unit once with
// UNROLL in flight, at most AFFINE_WAVES waves of resident blocks
// over the card's SMs (shared by the N samples), and at least one thread
// per unit of a row.  -1 if the card cannot be queried.
constexpr int AFFINE_WAVES = 4;

template <typename T>
int affine_blocks(int N, long long units, int lanes, int device) {
  static int sms[64], per_sm[64];
  if (device < 0 || device >= 64) return -1;
  if (!sms[device]) {
    int v = 0, occ = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, gn_affine_kernel<T>, NT, 0) != cudaSuccess)
      return -1;
    per_sm[device] = occ > 0 ? occ : 1;
    sms[device] = v;
  }
  const long long per_block = (long long)NT * UNROLL;
  const long long need = (units + per_block - 1) / per_block;
  const long long cap =
      (long long)sms[device] * per_sm[device] * AFFINE_WAVES / N;
  long long g = need < cap ? need : cap;
  const long long min_g = (lanes + NT - 1) / NT;
  if (g < min_g) g = min_g;
  return (int)(g < 1 ? 1 : g);
}

template <typename T>
int launch_affine(const void* x, const float* a, const float* b, void* y,
                  int N, long long S, int C, int device, cudaStream_t s) {
  constexpr int V = Vec16<T>::V;
  const bool vec = C % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int lanes = vec ? C / V : C;
  const int g = affine_blocks<T>(N, vec ? S * C / V : S * C, lanes, device);
  if (g < 0) return (int)cudaErrorInvalidDevice;
  gn_affine_kernel<T><<<dim3(g, N), NT, 0, s>>>(
      static_cast<const T*>(x), a, b, static_cast<T*>(y), S, C, vec);
  return (int)cudaGetLastError();
}

// grid (G, N).  WIN: rows outside the window rw get g * A alone.
template <typename T, bool WIN>
__global__ void __launch_bounds__(NT) gn_bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ A, const float* __restrict__ Cc,
    const float* __restrict__ D, T* __restrict__ dx, int64_t S, int C,
    int G, RowWindow rw) {
  const int blk = blockIdx.x;
  const int n = blockIdx.y;
  const int CL = C < NT ? C : NT;
  const int RL = NT / CL;
  const int tid = threadIdx.x;
  const int lane_c = tid % CL;
  const int lane_r = tid / CL;
  if (lane_r >= RL) return;
  const int64_t rows_per_block = (S + G - 1) / G;
  const int64_t r0 = (int64_t)blk * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
  const int64_t base = (int64_t)n * S * C;
  for (int c = lane_c; c < C; c += CL) {
    const float av = A[(int64_t)n * C + c];
    const float cv = Cc[(int64_t)n * C + c];
    const float dv = D[(int64_t)n * C + c];
    for (int64_t r = r0 + lane_r; r < r1; r += RL) {
      const int64_t i = base + r * C + c;
      if constexpr (WIN) {
        const uint32_t p = (uint32_t)r % rw.plane;
        if (p < rw.lo || p >= rw.hi) {
          dx[i] = from_f<T>(__fmul_rn(to_f(g[i]), av));
          continue;
        }
      }
      const float t = __fadd_rn(__fmul_rn(to_f(g[i]), av),
                                __fmul_rn(to_f(x[i]), cv));
      dx[i] = from_f<T>(__fadd_rn(t, dv));
    }
  }
}

bool bad_args(int N, long long S, int C, int G) {
  return N <= 0 || S <= 0 || C <= 0 || G <= 0 || N > 65535 || C > 65535;
}

// Make `device` current, calling cudaSetDevice only when it is not (the
// launch's host cost counts where the kernel is short).
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// Blocks per sample of a reduction: about REDUCE_STEPS steps of UNROLL
// units per thread, at least one block per SM and at most REDUCE_WAVES waves
// of resident blocks (both shared by the N samples), then as many more as
// keep every accumulator at MAX_TERMS terms or fewer and give every lane a
// thread.  The SM count and the occupancy are queried once per device.  -1
// if the card cannot be queried.
template <typename T, bool BWD>
int reduce_blocks(int N, long long units, int lanes, int device) {
  static int sms[64], per_sm[64];
  if (device < 0 || device >= 64) return -1;
  if (!sms[device]) {
    int v = 0, occ = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, gn_partial_kernel<T, BWD, false>, NT, 0) != cudaSuccess)
      return -1;
    per_sm[device] = occ > 0 ? occ : 1;
    sms[device] = v;
  }
  const long long per_block = (long long)NT * UNROLL * REDUCE_STEPS;
  long long g = (units + per_block - 1) / per_block;
  const long long fill = (sms[device] + N - 1) / N;
  const long long cap =
      (long long)sms[device] * per_sm[device] * REDUCE_WAVES / N;
  if (g < fill) g = fill;
  if (g > cap) g = cap;
  // rows of the stride (units of one lane a step) that MAX_TERMS needs
  const long long rows =
      ((units + MAX_TERMS - 1) / MAX_TERMS + lanes - 1) / lanes;
  const long long g_terms = (rows * lanes + NT - 1) / NT;
  if (g < g_terms) g = g_terms;
  return (int)(g < 1 ? 1 : g);
}

// Whether a grid of G blocks per sample covers `units` with at most
// MAX_TERMS terms per accumulator.
bool reduce_grid_ok(long long units, int lanes, int G) {
  const long long stride = (long long)G * NT / lanes * lanes;
  return stride > 0 && (units + stride - 1) / stride <= MAX_TERMS;
}

bool aligned16(const void* x, const void* g) {
  return ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) &
          15) == 0;
}

template <typename T, bool BWD>
int blocks_for(bool aligned, int N, long long S, int C, int device) {
  constexpr int V = Vec16<T>::V;
  const int mode = reduce_mode(aligned, S, C, V);
  return reduce_blocks<T, BWD>(N, S * C / (mode ? V : 1),
                               reduce_lanes(mode, C, V), device);
}

// A window of rows [lo, hi) along one spatial axis of x seen as
// (N, outer, extent, inner, C); the full window is lo = 0, hi = extent.
struct Window {
  long long outer, extent, inner, lo, hi;
  bool full() const { return lo == 0 && hi == extent; }
  bool bad() const {
    return outer <= 0 || extent <= 0 || inner <= 0 || lo < 0 || hi > extent ||
           lo >= hi;
  }
  long long rows() const { return outer * (hi - lo) * inner; }
};

// Both passes of a reduction on stream s, over the rows of window w (all of
// them for the full window).  A window's units must tile its runs: vectors
// only where inner * C values fill whole 16-byte vectors.
template <typename T, bool BWD>
int launch_reduce(const void* x, const void* g, const float* mean,
                  const float* inv, void* partial, void* s1, void* s2, int N,
                  const Window& w, int C, int G, cudaStream_t s) {
  constexpr int V = Vec16<T>::V;
  const long long S = w.outer * w.extent * w.inner;
  const long long row_bytes = w.inner * C * (long long)sizeof(T);
  const bool aligned = aligned16(x, g) && (w.full() || row_bytes % 16 == 0);
  const int mode = reduce_mode(aligned, w.rows(), C, V);
  const int W = mode ? V : 1;
  const long long units = w.rows() * C / W;
  if (!reduce_grid_ok(units, reduce_lanes(mode, C, V), G))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partial);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (w.full()) {
    gn_partial_kernel<T, BWD, false><<<dim3(G, N), NT, 0, s>>>(
        xt, gt, mean, inv, part, N, S, C, G, mode, units, UnitWindow{});
  } else {
    const long long run = w.inner * C / W;  // units of one row of the axis
    if (S * C / W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const UnitWindow uw{(uint32_t)((w.hi - w.lo) * run),
                        (uint32_t)(w.extent * run), (uint32_t)(w.lo * run)};
    gn_partial_kernel<T, BWD, true><<<dim3(G, N), NT, 0, s>>>(
        xt, gt, mean, inv, part, N, S, C, G, mode, units, uw);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_stats_final_kernel<<<dim3(C, N), NT, 0, s>>>(
      part, static_cast<float*>(s1), static_cast<float*>(s2), N, C, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* x, const void* g, const float* A, const float* Cc,
              const float* D, void* dx, int N, const Window& w, int C, int G,
              cudaStream_t s) {
  const long long S = w.outer * w.extent * w.inner;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (w.full()) {
    gn_bwd_dx_kernel<T, false><<<dim3(G, N), NT, 0, s>>>(
        xt, gt, A, Cc, D, dxt, S, C, G, RowWindow{});
  } else {
    if (S >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const RowWindow rw{(uint32_t)(w.extent * w.inner),
                       (uint32_t)(w.lo * w.inner), (uint32_t)(w.hi * w.inner)};
    gn_bwd_dx_kernel<T, true><<<dim3(G, N), NT, 0, s>>>(
        xt, gt, A, Cc, D, dxt, S, C, G, rw);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks per sample G of a reduction (bwd = 0: tpuseg_gn_stats, 1:
// tpuseg_gn_bwd_reduce) on inputs of this shape and dtype (0 = float32,
// 1 = bfloat16), with x (and g) 16-byte aligned or not, sized from the card;
// the caller allocates the 2*N*C*G floats of scratch.  Negative on error: a
// CUDA error code, negated.
extern "C" int tpuseg_gn_reduce_blocks(int aligned, int bwd, int N,
                                       long long S, int C, int dtype,
                                       int device) {
  if (bad_args(N, S, C, 1)) return -(int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return -(int)err;
  int blocks;
  if (dtype == 0)
    blocks = bwd ? blocks_for<float, true>(aligned, N, S, C, device)
                 : blocks_for<float, false>(aligned, N, S, C, device);
  else if (dtype == 1)
    blocks = bwd ? blocks_for<__nv_bfloat16, true>(aligned, N, S, C, device)
                 : blocks_for<__nv_bfloat16, false>(aligned, N, S, C, device);
  else
    return -(int)cudaErrorInvalidValue;
  return blocks < 0 ? -(int)cudaErrorInvalidDevice : blocks;
}

// dtype: 0 = float32, 1 = bfloat16.  partial is fp32 scratch of 2*N*C*G
// floats, G from tpuseg_gn_reduce_blocks (a grid that leaves an accumulator
// more than MAX_TERMS terms is refused).  x is (N, outer, extent, inner, C)
// and the sums cover rows [lo, hi) of the extent axis (all of x for lo = 0,
// hi = extent; G then asked for outer * (hi - lo) * inner rows, aligned only
// where inner * C values fill whole 16-byte vectors).  Returns the CUDA
// error code of the launches (0 on success); the kernels do not
// synchronise.
extern "C" int tpuseg_gn_stats(const void* x, void* partial, void* s1,
                               void* s2, int N, long long outer,
                               long long extent, long long inner,
                               long long lo, long long hi, int C, int G,
                               int dtype, int device, void* stream) {
  const Window w{outer, extent, inner, lo, hi};
  if (w.bad() || bad_args(N, outer * extent * inner, C, G))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_reduce<float, false>(x, nullptr, nullptr, nullptr, partial,
                                       s1, s2, N, w, C, G, s);
  if (dtype == 1)
    return launch_reduce<__nv_bfloat16, false>(x, nullptr, nullptr, nullptr,
                                               partial, s1, s2, N, w, C, G, s);
  return (int)cudaErrorInvalidValue;
}

// The grid is sized here, from the card (see affine_blocks).
extern "C" int tpuseg_gn_affine(const void* x, const void* a, const void* b,
                                void* y, int N, long long S, int C, int dtype,
                                int device, void* stream) {
  if (bad_args(N, S, C, 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0)
    return launch_affine<float>(x, af, bf, y, N, S, C, device, s);
  if (dtype == 1)
    return launch_affine<__nv_bfloat16>(x, af, bf, y, N, S, C, device, s);
  return (int)cudaErrorInvalidValue;
}

// dtype of x and g; partial and G as for tpuseg_gn_stats.
extern "C" int tpuseg_gn_bwd_reduce(const void* x, const void* g,
                                    const void* mean, const void* inv,
                                    void* partial, void* c1, void* c2, int N,
                                    long long S, int C, int G, int dtype,
                                    int device, void* stream) {
  if (bad_args(N, S, C, G)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(inv);
  const Window w{1, S, 1, 0, S};
  if (dtype == 0)
    return launch_reduce<float, true>(x, g, m, v, partial, c1, c2, N, w, C,
                                      G, s);
  if (dtype == 1)
    return launch_reduce<__nv_bfloat16, true>(x, g, m, v, partial, c1, c2, N,
                                              w, C, G, s);
  return (int)cudaErrorInvalidValue;
}

// x (N, outer, extent, inner, C): C and D apply on rows [lo, hi) of the
// extent axis, g * A alone on the rest (lo = 0, hi = extent: everywhere).
extern "C" int tpuseg_gn_bwd_dx(const void* x, const void* g, const void* A,
                                const void* Cc, const void* D, void* dx,
                                int N, long long outer, long long extent,
                                long long inner, long long lo, long long hi,
                                int C, int G, int dtype, int device,
                                void* stream) {
  const Window w{outer, extent, inner, lo, hi};
  if (w.bad() || bad_args(N, outer * extent * inner, C, G))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* cf = static_cast<const float*>(Cc);
  const float* df = static_cast<const float*>(D);
  if (dtype == 0)
    return launch_dx<float>(x, g, af, cf, df, dx, N, w, C, G, s);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16>(x, g, af, cf, df, dx, N, w, C, G, s);
  return (int)cudaErrorInvalidValue;
}
