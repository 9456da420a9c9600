// GroupNorm forward streaming kernels for Hopper (sm_90a), channels-last:
//   tpuseg_gn_stats:  per-(sample n, channel c) fp32 sums  s1 = sum x,
//                     s2 = sum x^2  over the spatial positions of x (N, S, C)
//   tpuseg_gn_affine: y = x * a[n, c] + b[n, c], rounded to x's dtype
// x and y are fp32 or bf16; a, b, s1, s2 are (N, C) fp32.
//
// Replace the Pallas TPU kernels `_stats_kernel` and `_affine_kernel` (run
// through `_gn_grid` / `_gn_pallas_stats` / `_gn_fwd_pallas`) in
// mdeical_image_segmentation_tpu/ops/norm.py.  The group combine of the
// (N, C) sums, the variance max(0, E[x^2] - mean^2) and rsqrt(var + eps)
// stay outside, on the tiny (N, C) arrays, as in the JAX package.
//
// What bounds them on the H100.  Both are streaming passes with a handful of
// FLOP per element: device-memory bandwidth is the limit (3.35 TB/s), so
// each reads x once, in its own dtype, and the affine writes y once.
//
// Design.  A block owns a contiguous range of rows (spatial positions) of
// one sample.  Its threads are laid out as RL row lanes x CL channel lanes
// (CL = min(C, 256), RL = 256 / CL), so neighbouring threads read
// neighbouring addresses and each thread keeps ONE channel for its whole
// walk (channels beyond 256 are walked in chunks of 256).
// - Stats: the TPU grid runs in order and carries row accumulators from
//   step to step; a GPU grid runs in parallel, so the sum is hierarchical
//   and deterministic (no atomics): each thread sums its rows (a few
//   hundred at most), the block combines its row lanes with a tree in
//   shared memory and writes one partial per (n, c, block) to scratch, and
//   a second kernel reduces the G partials of each (n, c) with a tree.
// - Affine: the same row/channel map, a[n, c] and b[n, c] held in
//   registers; x*a + b rounds after the product and after the sum
//   (__fmul_rn / __fadd_rn), exactly as the plain PyTorch version computes.
// All offsets into x and y are 64-bit (a decoder input of the 3D UNet at
// batch 4 holds 4.7e9 elements).

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
template <typename T>
__global__ void __launch_bounds__(NT) gn_stats_partial_kernel(
    const T* __restrict__ x, float* __restrict__ partial, int N, int64_t S,
    int C, int G) {
  __shared__ float sh1[NT];
  __shared__ float sh2[NT];
  const int g = blockIdx.x;
  const int n = blockIdx.y;
  const int CL = C < NT ? C : NT;
  const int RL = NT / CL;
  const int tid = threadIdx.x;
  const int lane_c = tid % CL;
  const int lane_r = tid / CL;
  const bool active = lane_r < RL;
  const int64_t rows_per_block = (S + G - 1) / G;
  const int64_t r0 = (int64_t)g * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
  const T* xn = x + (int64_t)n * S * C;
  float* p1 = partial + (int64_t)n * C * G;
  float* p2 = partial + ((int64_t)N + n) * C * G;

  for (int c0 = 0; c0 < C; c0 += CL) {
    const int c = c0 + lane_c;
    float s1 = 0.f, s2 = 0.f;
    if (active && c < C) {
      for (int64_t r = r0 + lane_r; r < r1; r += RL) {
        const float v = to_f(xn[r * C + c]);
        s1 += v;
        s2 = fmaf(v, v, s2);
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
      p1[(int64_t)c * G + g] = sh1[tid];
      p2[(int64_t)c * G + g] = sh2[tid];
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
    gn_stats_partial_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), part, N, S, C, G);
  else if (dtype == 1)
    gn_stats_partial_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), part, N, S, C, G);
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
