// Fused GroupNorm-apply + conv3d + ReLU forward for Hopper (sm_90a): the
// SingleConv('gcr') of the 3D UNet family,
//   xa = round_T(relu?(x * a[n, ci] + b[n, ci]))   inside the volume, 0 outside
//   y  = round_T(relu?(conv3d_{KD x 3 x 3}(xa, w)))
// stride 1, padding ((KD-1)/2, 1, 1), no bias, fp32 accumulation.  NDHWC
// activations, (KD, 3, 3, Ci, Co) weights in x's dtype, KD in {1, 3}; a, b
// are (N, Ci) fp32 (the GroupNorm coefficients, from tpuseg_gn_stats).
//
// Replaces the Pallas TPU kernel `_gcr_kernel` reached through
// `fused_conv3d` in mdeical_image_segmentation_tpu/ops/fused_conv.py.
//
// What bounds it on the H100.  At the 3D UNet's widths (Ci, Co 32-768) a
// 3x3x3 conv does 54*Ci*Co FLOP per output voxel against a few bytes read
// and written: compute-bound.  This first version runs on the CUDA cores in
// fp32 FMA (no tensor cores), so its ceiling is the fp32 non-tensor rate.
// The saving the fusion buys is that the normalized tensor never makes a
// round trip through device memory.
//
// Design.  One block owns one (sample n, output depth d, 8 x 8 tile of
// (h, w), COB-wide chunk of output channels).  It walks the KD depth taps
// and, for each, Ci in chunks of CIB: the 10 x 10 x CIB input halo of that
// depth plane is read, normalized (a*x + b, rounded after the product and
// after the sum, relu when asked, rounded to T) and staged in shared
// memory; positions outside the volume stay ZERO -- the conv pads the
// normalized tensor, it does not see a*0 + b.  A depth tap that falls
// outside the volume is skipped whole.  The weights of the chunk are
// staged beside it, and each thread accumulates 4 pixels x 4*HALVES output
// channels in fp32 registers.  All offsets into x and y are 64-bit.
// Later work: tensor cores (mma.sync / wgmma), TMA staging, reuse of a
// staged plane across the output depths that read it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;            // output tile rows
constexpr int TW = 8;            // output tile columns
constexpr int XH = TH + 2;       // input tile with the conv halo
constexpr int XW = TW + 2;
constexpr int XP = XH * XW;      // 100 input pixels
constexpr int CIB = 16;          // input channels staged per step
constexpr int NT = 256;          // threads per block

static_assert(TH * TW == 64, "thread map assumes a 64-pixel tile");

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

template <int COB>
constexpr size_t smem_floats() {
  return (size_t)CIB * XP + 9 * CIB * COB;
}

template <typename T, int COB>
__global__ void __launch_bounds__(NT, 2) gcr_conv3d_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ a, const float* __restrict__ b,
    T* __restrict__ y, int D, int H, int W, int Ci, int Co, int KD,
    int pre_relu, int post_relu, int tiles_w) {
  constexpr int HALVES = COB / 64;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // [CIB][XP]
  float* w_s = x_s + CIB * XP;                   // [9][CIB][COB]

  const int tid = threadIdx.x;
  const int n = blockIdx.z / D;
  const int d = blockIdx.z % D;
  const int co0 = blockIdx.y * COB;
  const int th0 = (blockIdx.x / tiles_w) * TH;
  const int tw0 = (blockIdx.x % tiles_w) * TW;
  const int off = (KD - 1) / 2;
  const float* an = a + (int64_t)n * Ci;
  const float* bn = b + (int64_t)n * Ci;

  // thread map: 4 pixels of one tile row x 4*HALVES output channels
  // (channels cg*4 + 64*h + k, so each float4 read of a warp is contiguous)
  const int cg = tid % 16;
  const int pg = tid / 16;
  const int orow = pg / 2;
  const int ocol0 = (pg % 2) * 4;
  float acc[4][4 * HALVES];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4 * HALVES; ++k) acc[i][k] = 0.f;

  for (int kd = 0; kd < KD; ++kd) {
    const int ds = d + kd - off;
    if (ds < 0 || ds >= D) continue;  // the whole plane is padding
    const T* xp = x + ((int64_t)n * D + ds) * H * W * Ci;
    for (int ci0 = 0; ci0 < Ci; ci0 += CIB) {
      const int cin = min(CIB, Ci - ci0);
      for (int i = tid; i < XP * CIB; i += NT) {
        const int c = i % CIB;
        const int p = i / CIB;
        const int hh = th0 - 1 + p / XW;
        const int ww = tw0 - 1 + p % XW;
        float v = 0.f;
        if (c < cin && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          const int ci = ci0 + c;
          v = __fadd_rn(__fmul_rn(to_f(xp[((int64_t)hh * W + ww) * Ci + ci]),
                                  an[ci]),
                        bn[ci]);
          if (pre_relu) v = fmaxf(v, 0.f);
          v = to_f(from_f<T>(v));
        }
        x_s[c * XP + p] = v;
      }
      for (int i = tid; i < 9 * CIB * COB; i += NT) {
        const int co = i % COB;
        const int r = i / COB;
        const int c = r % CIB;
        const int tap = r / CIB;
        float v = 0.f;
        if (c < cin && co0 + co < Co)
          v = to_f(w[((int64_t)(kd * 9 + tap) * Ci + ci0 + c) * Co + co0 +
                     co]);
        w_s[i] = v;
      }
      __syncthreads();

#pragma unroll 2
      for (int c = 0; c < cin; ++c) {
        const float* xc = x_s + c * XP;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float* wp = w_s + ((dh * 3 + dw) * CIB + c) * COB + cg * 4;
            float wv[4 * HALVES];
#pragma unroll
            for (int h = 0; h < HALVES; ++h) {
              const float4 q = *reinterpret_cast<const float4*>(wp + 64 * h);
              wv[4 * h + 0] = q.x;
              wv[4 * h + 1] = q.y;
              wv[4 * h + 2] = q.z;
              wv[4 * h + 3] = q.w;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xv = xc[(orow + dh) * XW + ocol0 + i + dw];
#pragma unroll
              for (int k = 0; k < 4 * HALVES; ++k)
                acc[i][k] = fmaf(xv, wv[k], acc[i][k]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  const int hh = th0 + orow;
  if (hh >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ww = tw0 + ocol0 + i;
    if (ww >= W) continue;
    T* yp = y + ((((int64_t)n * D + d) * H + hh) * W + ww) * Co;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int co = co0 + cg * 4 + 64 * h + k;
        if (co < Co) {
          float v = acc[i][4 * h + k];
          if (post_relu) v = fmaxf(v, 0.f);
          yp[co] = from_f<T>(v);
        }
      }
    }
  }
}

template <typename T, int COB>
cudaError_t launch(const void* x, const void* w, const void* a,
                   const void* b, void* y, int N, int D, int H, int W,
                   int Ci, int Co, int KD, int pre_relu, int post_relu,
                   cudaStream_t stream) {
  const int smem = (int)(smem_floats<COB>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gcr_conv3d_kernel<T, COB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (Co + COB - 1) / COB, N * D);
  gcr_conv3d_kernel<T, COB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(y), D, H, W, Ci, Co, KD, pre_relu, post_relu, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cob(const void* x, const void* w, const void* a,
                         const void* b, void* y, int N, int D, int H, int W,
                         int Ci, int Co, int KD, int pre_relu, int post_relu,
                         cudaStream_t stream) {
  if (Co > 64)
    return launch<T, 128>(x, w, a, b, y, N, D, H, W, Ci, Co, KD, pre_relu,
                          post_relu, stream);
  return launch<T, 64>(x, w, a, b, y, N, D, H, W, Ci, Co, KD, pre_relu,
                       post_relu, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error code of the
// launch (0 on success); the kernel does not synchronise.
extern "C" int tpuseg_gcr_conv3d_forward(
    const void* x, const void* w, const void* a, const void* b, void* y,
    int N, int D, int H, int W, int Ci, int Co, int KD, int pre_relu,
    int post_relu, int dtype, int device, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
      (KD != 1 && KD != 3) || (long long)N * D > 65535 ||
      (Co + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_cob<float>(x, w, a, b, y, N, D, H, W, Ci, Co, KD, pre_relu,
                              post_relu, s);
  else if (dtype == 1)
    err = dispatch_cob<__nv_bfloat16>(x, w, a, b, y, N, D, H, W, Ci, Co, KD,
                                      pre_relu, post_relu, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
