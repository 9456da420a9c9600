// DoubleConvolution forward for Hopper (sm_90a), on the tensor cores:
//   z = relu(conv3x3(x, w1) + b1), rounded to x's dtype
//   y = relu(conv3x3(z, w2) + b2)
// stride 1, zero padding 1, fp32 accumulation.  NHWC activations, HWIO
// weights, fp32 or bf16 (all operands of one dtype).
//
// Replaces the Pallas TPU kernel `_double2d_kernel` reached through
// `fused_double2d` in mdeical_image_segmentation_tpu/ops/fused_conv.py.
//
// What bounds it on the H100.  The UNet's DoubleConvs do 2*9*(Ci*C1+C1*Co)
// FLOP per output pixel at Ci, C1, Co from 64 to 1024: compute-bound work
// (hundreds of FLOP per byte of x, z and y), bounded by the tensor-core
// rate (989 TFLOP/s bf16; fp32 runs 3xTF32 against 495 TFLOP/s TF32).
//
// Design.  Two launches of the shared implicit-GEMM core (conv_tc.cuh),
// with z through device memory: conv1 runs once over the whole image at
// C1 (bias, relu, rounded to T, written to z), then conv2 reads z (bias,
// relu).  conv1 is never recomputed per output-channel chunk, and z's halo
// outside the image is zero because conv2 pads z with zeros itself (not
// relu(b1 + conv1 of the padding)).  z costs one write and one read of
// N*H*W*C1 elements: at N = 8 in bf16 about 256 MB over the base-64 UNet's
// 9 DoubleConvs, ~0.15 ms at 3.35 TB/s and mostly L2-resident at the small
// levels, against ~0.7 ms of tensor-core work at the bound.  The caller
// provides z (a scratch buffer when it does not want z back).
//
// Each launch's error is checked with cudaGetLastError() before the next.
//
// Under channel tensor parallelism the two convs run apart, on each rank's
// out-channel blocks of (w1, b1) and (w2, b2), with the all-gather of z
// between them: tpuseg_conv2d_bias_relu_forward is one launch of the same
// core, y = relu(conv3x3(x, w) + b).

#include "conv_tc.cuh"

namespace {

using tpuseg_conv::ConvParams;

template <typename T>
cudaError_t double_conv(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* y, void* z,
                        int N, int H, int W, int Ci, int C1, int Co,
                        int device, cudaStream_t stream) {
  ConvParams p{};
  p.D = 1;
  p.H = H;
  p.W = W;
  p.KD = 1;
  p.post_relu = 1;
  p.x = x;
  p.w = w1;
  p.bias = b1;
  p.y = z;
  p.Ci = Ci;
  p.Co = C1;
  cudaError_t err = tpuseg_conv::conv_tc<T, false>(p, N, device, stream);
  if (err != cudaSuccess) return err;
  p.x = z;
  p.w = w2;
  p.bias = b2;
  p.y = y;
  p.Ci = C1;
  p.Co = Co;
  return tpuseg_conv::conv_tc<T, false>(p, N, device, stream);
}

template <typename T>
cudaError_t conv_bias_relu(const void* x, const void* w, const void* b,
                           void* y, int N, int H, int W, int Ci, int Co,
                           int device, cudaStream_t stream) {
  ConvParams p{};
  p.D = 1;
  p.H = H;
  p.W = W;
  p.KD = 1;
  p.post_relu = 1;
  p.x = x;
  p.w = w;
  p.bias = b;
  p.y = y;
  p.Ci = Ci;
  p.Co = Co;
  return tpuseg_conv::conv_tc<T, false>(p, N, device, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  z (N, H, W, C1) is required: conv1's
// output, which conv2 reads.  Two launches; returns the CUDA error code of
// the first that failed (0 on success); the kernels do not synchronise.
extern "C" int tpuseg_double_conv2d_forward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, void* y, void* z, int N, int H, int W, int Ci, int C1,
    int Co, int dtype, int device, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || C1 <= 0 || Co <= 0 ||
      z == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = tpuseg_conv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = double_conv<float>(x, w1, b1, w2, b2, y, z, N, H, W, Ci, C1, Co,
                             device, s);
  else if (dtype == 1)
    err = double_conv<__nv_bfloat16>(x, w1, b1, w2, b2, y, z, N, H, W, Ci, C1,
                                     Co, device, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// y = relu(conv3x3(x, w) + b): x (N, H, W, Ci), w (3, 3, Ci, Co), b (Co,),
// y (N, H, W, Co); dtype 0 = float32, 1 = bfloat16.  One launch; returns
// its CUDA error code (0 on success); does not synchronise.
extern "C" int tpuseg_conv2d_bias_relu_forward(const void* x, const void* w,
                                               const void* b, void* y, int N,
                                               int H, int W, int Ci, int Co,
                                               int dtype, int device,
                                               void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || b == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = tpuseg_conv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = conv_bias_relu<float>(x, w, b, y, N, H, W, Ci, Co, device, s);
  else if (dtype == 1)
    err = conv_bias_relu<__nv_bfloat16>(x, w, b, y, N, H, W, Ci, Co, device,
                                        s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* tpuseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
