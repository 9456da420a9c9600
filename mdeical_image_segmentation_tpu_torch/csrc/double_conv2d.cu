// Fused DoubleConvolution forward for Hopper (sm_90a):
//   z = relu(conv3x3(x, w1) + b1), rounded to x's dtype
//   y = relu(conv3x3(z, w2) + b2)
// stride 1, zero padding 1, fp32 accumulation.  NHWC activations, HWIO
// weights, fp32 or bf16 (all operands of one dtype).
//
// Replaces the Pallas TPU kernel `_double2d_kernel` reached through
// `fused_double2d` in mdeical_image_segmentation_tpu/ops/fused_conv.py.
//
// What bounds it on the H100.  The UNet's DoubleConvs do 2*9*(Ci*C1+C1*Co)
// FLOP per output pixel at Ci, C1, Co from 64 to 1024: this is compute-bound
// work (hundreds of FLOP per byte of x and y), so the bound is arithmetic
// throughput, and the saving the fusion buys is that z never makes a round
// trip through device memory.  This first version runs on the CUDA cores
// in fp32 FMA (no tensor cores), so its ceiling is the fp32 non-tensor rate,
// far below what cuDNN reaches with bf16 tensor-core convolutions.
//
// Design.  One block owns one (sample n, TH x TW output tile, COB-wide chunk
// of output channels).  It walks C1 in chunks of C1B:
//   1. conv1 computes the (TH+2) x (TW+2) z slice of this C1 chunk from the
//      (TH+4) x (TW+4) x halo, Ci in steps of CIB staged through shared
//      memory; z is biased, relu'd, rounded to T and written to shared
//      memory.  Halo positions outside the image are ZERO (conv2's own
//      padding), not relu(b1 + conv1 of the padding).
//   2. conv2 accumulates this z slice's contribution into fp32 registers
//      (4 pixels x COB/16 channels per thread).
// z never goes to device memory unless the caller asks for it (then only the
// blocks of the first channel chunk write their tile's interior).
// Known cost: conv1 is recomputed once per COB chunk of Co (ceil(Co/COB)
// times) and over the 1-pixel z halo of each tile ((TH+2)(TW+2)/(TH*TW) =
// 1.56x).  COB is 128 when Co > 64, else 64.  Later work: tensor cores
// (mma.sync / wgmma), TMA staging, and sharing z between the Co chunks of
// one tile through a thread block cluster's distributed shared memory.
//
// Shared memory, fp32 staging: x 9 KB + w1 9 KB + z 6.25 KB + w2 36 or 72 KB
// (62 KB at COB=64, 96 KB at COB=128) of the 227 KB a block may use.
// Ragged H, W, Ci, C1 and Co are handled by zero-filled staging and masked
// stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 8;            // output tile rows
constexpr int TW = 8;            // output tile columns
constexpr int ZH = TH + 2;       // z tile with conv2's halo
constexpr int ZW = TW + 2;
constexpr int XH = TH + 4;       // x tile with both halos
constexpr int XW = TW + 4;
constexpr int ZP = ZH * ZW;      // 100 z pixels
constexpr int XP = XH * XW;      // 144 x pixels
constexpr int CIB = 16;          // x channels staged per conv1 step
constexpr int C1B = 16;          // z channels per chunk
constexpr int NT = 256;          // threads per block

static_assert(TH * TW == 64, "conv2 thread map assumes a 64-pixel tile");
static_assert(NT / (C1B / 4) * 2 >= ZP, "conv1 thread map must cover ZP");

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
  return (size_t)CIB * XP + 9 * CIB * C1B + C1B * ZP + 9 * C1B * COB;
}

template <typename T, int COB>
__global__ void __launch_bounds__(NT, 2) double_conv2d_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, T* __restrict__ y, T* __restrict__ z,
    int H, int W, int Ci, int C1, int Co, int tiles_w) {
  constexpr int HALVES = COB / 64;  // conv2 float4 groups per thread
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // [CIB][XP]
  float* w1_s = x_s + CIB * XP;                  // [9][CIB][C1B]
  float* z_s = w1_s + 9 * CIB * C1B;             // [C1B][ZP]
  float* w2_s = z_s + C1B * ZP;                  // [9][C1B][COB]

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * COB;
  const int th0 = (blockIdx.x / tiles_w) * TH;
  const int tw0 = (blockIdx.x % tiles_w) * TW;
  const T* xn = x + (size_t)n * H * W * Ci;

  // conv1 map: 4 consecutive z channels x 2 z pixels (zpg, zpg + 64)
  const int c1g = tid % (C1B / 4);
  const int zpg = tid / (C1B / 4);
  int zoff[2];
  bool zvalid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int zp = zpg + 64 * j;
    zvalid[j] = zp < ZP;
    zp = zvalid[j] ? zp : ZP - 1;
    zoff[j] = (zp / ZW) * XW + (zp % ZW);
  }

  // conv2 map: 4 pixels of one tile row x 4*HALVES output channels
  // (channels cg*4 + 64*h + k, so each float4 read of a warp is contiguous)
  const int cg = tid % 16;
  const int pg = tid / 16;
  const int orow = pg / 2;
  const int ocol0 = (pg % 2) * 4;
  float acc2[4][4 * HALVES];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4 * HALVES; ++k) acc2[i][k] = 0.f;

  for (int c1_0 = 0; c1_0 < C1; c1_0 += C1B) {
    const int c1n = min(C1B, C1 - c1_0);

    // stage this chunk's w2 slice, zero beyond C1 and Co
    for (int i = tid; i < 9 * C1B * COB; i += NT) {
      const int co = i % COB;
      const int r = i / COB;
      const int c = r % C1B;
      const int tap = r / C1B;
      float v = 0.f;
      if (c < c1n && co0 + co < Co)
        v = to_f(w2[((size_t)tap * C1 + c1_0 + c) * Co + co0 + co]);
      w2_s[i] = v;
    }

    float acc1[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc1[j][k] = 0.f;

    for (int ci0 = 0; ci0 < Ci; ci0 += CIB) {
      const int cin = min(CIB, Ci - ci0);
      for (int i = tid; i < XP * CIB; i += NT) {
        const int c = i % CIB;
        const int p = i / CIB;
        const int hh = th0 - 2 + p / XW;
        const int ww = tw0 - 2 + p % XW;
        float v = 0.f;
        if (c < cin && hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = to_f(xn[((size_t)hh * W + ww) * Ci + ci0 + c]);
        x_s[c * XP + p] = v;
      }
      for (int i = tid; i < 9 * CIB * C1B; i += NT) {
        const int c1 = i % C1B;
        const int r = i / C1B;
        const int c = r % CIB;
        const int tap = r / CIB;
        float v = 0.f;
        if (c < cin && c1 < c1n)
          v = to_f(w1[((size_t)tap * Ci + ci0 + c) * C1 + c1_0 + c1]);
        w1_s[i] = v;
      }
      __syncthreads();

#pragma unroll 2
      for (int c = 0; c < cin; ++c) {
        const float* xc = x_s + c * XP;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float4 wv = *reinterpret_cast<const float4*>(
                w1_s + ((dh * 3 + dw) * CIB + c) * C1B + c1g * 4);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float xv = xc[zoff[j] + dh * XW + dw];
              acc1[j][0] = fmaf(xv, wv.x, acc1[j][0]);
              acc1[j][1] = fmaf(xv, wv.y, acc1[j][1]);
              acc1[j][2] = fmaf(xv, wv.z, acc1[j][2]);
              acc1[j][3] = fmaf(xv, wv.w, acc1[j][3]);
            }
          }
        }
      }
      __syncthreads();
    }

    // z slice -> shared memory: bias, relu, round to T; zero outside the
    // image (conv2's padding).  Optionally emit the tile interior.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!zvalid[j]) continue;
      const int zp = zpg + 64 * j;
      const int zr = zp / ZW;
      const int zc = zp % ZW;
      const int hh = th0 - 1 + zr;
      const int ww = tw0 - 1 + zc;
      const bool inside = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const bool emit = z != nullptr && blockIdx.y == 0 && inside &&
                        zr >= 1 && zr <= TH && zc >= 1 && zc <= TW;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c1 = c1g * 4 + k;
        float v = 0.f;
        if (inside && c1 < c1n) {
          const T t = from_f<T>(fmaxf(acc1[j][k] + to_f(b1[c1_0 + c1]), 0.f));
          v = to_f(t);
          if (emit) z[(((size_t)n * H + hh) * W + ww) * C1 + c1_0 + c1] = t;
        }
        z_s[c1 * ZP + zp] = v;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < c1n; ++c) {
      const float* zc = z_s + c * ZP;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* wp = w2_s + ((dh * 3 + dw) * C1B + c) * COB + cg * 4;
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
            const float zv = zc[(orow + dh) * ZW + ocol0 + i + dw];
#pragma unroll
            for (int k = 0; k < 4 * HALVES; ++k)
              acc2[i][k] = fmaf(zv, wv[k], acc2[i][k]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int hh = th0 + orow;
  if (hh >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ww = tw0 + ocol0 + i;
    if (ww >= W) continue;
    T* yp = y + (((size_t)n * H + hh) * W + ww) * Co;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int co = co0 + cg * 4 + 64 * h + k;
        if (co < Co)
          yp[co] = from_f<T>(fmaxf(acc2[i][4 * h + k] + to_f(b2[co]), 0.f));
      }
    }
  }
}

template <typename T, int COB>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, void* z, int N,
                   int H, int W, int Ci, int C1, int Co,
                   cudaStream_t stream) {
  const int smem = (int)(smem_floats<COB>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      double_conv2d_kernel<T, COB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (Co + COB - 1) / COB, N);
  double_conv2d_kernel<T, COB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), static_cast<T*>(z), H,
      W, Ci, C1, Co, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cob(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* y, void* z,
                         int N, int H, int W, int Ci, int C1, int Co,
                         cudaStream_t stream) {
  if (Co > 64)
    return launch<T, 128>(x, w1, b1, w2, b2, y, z, N, H, W, Ci, C1, Co,
                          stream);
  return launch<T, 64>(x, w1, b1, w2, b2, y, z, N, H, W, Ci, C1, Co, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  z may be null.  Returns the CUDA error
// code of the launch (0 on success); the kernel does not synchronise.
extern "C" int tpuseg_double_conv2d_forward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, void* y, void* z, int N, int H, int W, int Ci, int C1,
    int Co, int dtype, int device, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || C1 <= 0 || Co <= 0 ||
      N > 65535 || (Co + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_cob<float>(x, w1, b1, w2, b2, y, z, N, H, W, Ci, C1, Co, s);
  else if (dtype == 1)
    err = dispatch_cob<__nv_bfloat16>(x, w1, b1, w2, b2, y, z, N, H, W, Ci,
                                      C1, Co, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* tpuseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
