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
// Design.  A block owns a contiguous range of rows (spatial positions) of
// one sample.  Its threads are laid out as RL row lanes x CL channel lanes
// (CL = min(C, 256), RL = 256 / CL), so neighbouring threads read
// neighbouring addresses and each thread keeps ONE channel (and its
// per-channel coefficients, in registers) for its whole walk (channels
// beyond 256 are walked in chunks of 256).
// - Reductions (stats, bwd_reduce): the TPU grid runs in order and carries
//   row accumulators from step to step; a GPU grid runs in parallel, so the
//   sum is hierarchical and deterministic (no atomics): each thread sums its
//   rows (a few hundred at most), the block combines its row lanes with a
//   tree in shared memory and writes one partial per (n, c, block) to
//   scratch, and a second kernel reduces the G partials of each (n, c) with
//   a tree.  One partial kernel serves both, templated on what a row adds.
// - Elementwise (affine, dx): the same row/channel map; every product and
//   sum rounds on its own (__fmul_rn / __fadd_rn, no contraction into an
//   FMA), in the order the plain PyTorch versions compute them, so the
//   kernels agree with those bit for bit.
// All offsets into the full-size tensors are 64-bit (a decoder input of the
// 3D UNet at batch 4 holds 4.7e9 elements).

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

// Pass 1: grid (G, N).  partial layout: [2][N][C][G] (s1 then s2).
// BWD = false: s1 += x, s2 += x * x (g, mean and inv unused).
// BWD = true:  s1 += g, s2 += g * (x - mean) * inv.
template <typename T, bool BWD>
__global__ void __launch_bounds__(NT) gn_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ partial, int N, int64_t S, int C, int G) {
  __shared__ float sh1[NT];
  __shared__ float sh2[NT];
  const int blk = blockIdx.x;
  const int n = blockIdx.y;
  const int CL = C < NT ? C : NT;
  const int RL = NT / CL;
  const int tid = threadIdx.x;
  const int lane_c = tid % CL;
  const int lane_r = tid / CL;
  const bool active = lane_r < RL;
  const int64_t rows_per_block = (S + G - 1) / G;
  const int64_t r0 = (int64_t)blk * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
  const T* xn = x + (int64_t)n * S * C;
  const T* gn = BWD ? g + (int64_t)n * S * C : nullptr;
  float* p1 = partial + (int64_t)n * C * G;
  float* p2 = partial + ((int64_t)N + n) * C * G;

  for (int c0 = 0; c0 < C; c0 += CL) {
    const int c = c0 + lane_c;
    float s1 = 0.f, s2 = 0.f;
    if (active && c < C) {
      if constexpr (BWD) {
        const float m = mean[(int64_t)n * C + c];
        const float v = inv[(int64_t)n * C + c];
        for (int64_t r = r0 + lane_r; r < r1; r += RL) {
          const float gv = to_f(gn[r * C + c]);
          const float xh = __fmul_rn(__fsub_rn(to_f(xn[r * C + c]), m), v);
          s1 += gv;
          s2 = fmaf(gv, xh, s2);
        }
      } else {
        for (int64_t r = r0 + lane_r; r < r1; r += RL) {
          const float v = to_f(xn[r * C + c]);
          s1 += v;
          s2 = fmaf(v, v, s2);
        }
      }
    }
    sh1[tid] = s1;
    sh2[tid] = s2;
    __syncthreads();
    // tree over the row lanes of each channel lane (RL is a power of two
    // only when CL divides 256, so halve with a bound check)
    for (int step = 1; step < RL; step *= 2) {
      if (active && lane_r % (2 * step) == 0 && lane_r + step < RL) {
        sh1[tid] += sh1[tid + step * CL];
        sh2[tid] += sh2[tid + step * CL];
      }
      __syncthreads();
    }
    if (lane_r == 0 && c < C) {
      p1[(int64_t)c * G + blk] = sh1[tid];
      p2[(int64_t)c * G + blk] = sh2[tid];
    }
    __syncthreads();
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

// grid (G, N)
template <typename T>
__global__ void __launch_bounds__(NT) gn_affine_kernel(
    const T* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, T* __restrict__ y, int64_t S, int C,
    int G) {
  const int g = blockIdx.x;
  const int n = blockIdx.y;
  const int CL = C < NT ? C : NT;
  const int RL = NT / CL;
  const int tid = threadIdx.x;
  const int lane_c = tid % CL;
  const int lane_r = tid / CL;
  if (lane_r >= RL) return;
  const int64_t rows_per_block = (S + G - 1) / G;
  const int64_t r0 = (int64_t)g * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
  const int64_t base = (int64_t)n * S * C;
  for (int c = lane_c; c < C; c += CL) {
    const float av = a[(int64_t)n * C + c];
    const float bv = b[(int64_t)n * C + c];
    for (int64_t r = r0 + lane_r; r < r1; r += RL) {
      const int64_t i = base + r * C + c;
      y[i] = from_f<T>(__fadd_rn(__fmul_rn(to_f(x[i]), av), bv));
    }
  }
}

// grid (G, N)
template <typename T>
__global__ void __launch_bounds__(NT) gn_bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ A, const float* __restrict__ Cc,
    const float* __restrict__ D, T* __restrict__ dx, int64_t S, int C,
    int G) {
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
      const float t = __fadd_rn(__fmul_rn(to_f(g[i]), av),
                                __fmul_rn(to_f(x[i]), cv));
      dx[i] = from_f<T>(__fadd_rn(t, dv));
    }
  }
}

bool bad_args(int N, long long S, int C, int G) {
  return N <= 0 || S <= 0 || C <= 0 || G <= 0 || N > 65535 || C > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  partial is fp32 scratch of 2*N*C*G
// floats.  Returns the CUDA error code of the launches (0 on success); the
// kernels do not synchronise.
extern "C" int tpuseg_gn_stats(const void* x, void* partial, void* s1,
                               void* s2, int N, long long S, int C, int G,
                               int dtype, int device, void* stream) {
  if (bad_args(N, S, C, G)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, N);
  float* part = static_cast<float*>(partial);
  if (dtype == 0)
    gn_partial_kernel<float, false><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), nullptr, nullptr, nullptr, part, N, S,
        C, G);
  else if (dtype == 1)
    gn_partial_kernel<__nv_bfloat16, false><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), nullptr, nullptr, nullptr, part,
        N, S, C, G);
  else
    return (int)cudaErrorInvalidValue;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_stats_final_kernel<<<dim3(C, N), NT, 0, s>>>(
      part, static_cast<float*>(s1), static_cast<float*>(s2), N, C, G);
  return (int)cudaGetLastError();
}

extern "C" int tpuseg_gn_affine(const void* x, const void* a, const void* b,
                                void* y, int N, long long S, int C, int G,
                                int dtype, int device, void* stream) {
  if (bad_args(N, S, C, G)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, N);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0)
    gn_affine_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), af, bf, static_cast<float*>(y), S, C,
        G);
  else if (dtype == 1)
    gn_affine_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), af, bf,
        static_cast<__nv_bfloat16*>(y), S, C, G);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype of x and g.  partial is fp32 scratch of 2*N*C*G floats.
extern "C" int tpuseg_gn_bwd_reduce(const void* x, const void* g,
                                    const void* mean, const void* inv,
                                    void* partial, void* c1, void* c2, int N,
                                    long long S, int C, int G, int dtype,
                                    int device, void* stream) {
  if (bad_args(N, S, C, G)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, N);
  float* part = static_cast<float*>(partial);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(inv);
  if (dtype == 0)
    gn_partial_kernel<float, true><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), m, v,
        part, N, S, C, G);
  else if (dtype == 1)
    gn_partial_kernel<__nv_bfloat16, true><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), m, v, part, N, S, C, G);
  else
    return (int)cudaErrorInvalidValue;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_stats_final_kernel<<<dim3(C, N), NT, 0, s>>>(
      part, static_cast<float*>(c1), static_cast<float*>(c2), N, C, G);
  return (int)cudaGetLastError();
}

extern "C" int tpuseg_gn_bwd_dx(const void* x, const void* g, const void* A,
                                const void* Cc, const void* D, void* dx,
                                int N, long long S, int C, int G, int dtype,
                                int device, void* stream) {
  if (bad_args(N, S, C, G)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, N);
  const float* af = static_cast<const float*>(A);
  const float* cf = static_cast<const float*>(Cc);
  const float* df = static_cast<const float*>(D);
  if (dtype == 0)
    gn_bwd_dx_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), af, cf,
        df, static_cast<float*>(dx), S, C, G);
  else if (dtype == 1)
    gn_bwd_dx_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), af, cf, df,
        static_cast<__nv_bfloat16*>(dx), S, C, G);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
