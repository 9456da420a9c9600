// Fused GroupNorm-apply + conv3d + ReLU forward for Hopper (sm_90a), on the
// tensor cores: the SingleConv('gcr') of the 3D UNet family,
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
// and written: compute-bound, by the tensor-core rate.  fp32 runs as
// 3xTF32 (three TF32 products per multiply-add, see conv_tc.cuh), so its
// bound is 3x the 495 TFLOP/s TF32 rate in tensor-core work; bf16 runs on
// bf16 mma.sync.  The saving the fusion buys is that the normalized tensor
// never makes a round trip through device memory.
//
// Design.  One launch of the shared implicit-GEMM core (conv_tc.cuh) with
// the GroupNorm affine as its prologue: each A element is normalized once
// per stage after it lands in shared memory, rounded after the product and
// after the sum (__fmul_rn, __fadd_rn), relu'd when asked and rounded to T
// -- the bf16 operand of the mma is the affine's result rounded to bf16.
// Positions outside the volume are zero-filled and never normalized: the
// conv pads the normalized tensor, it does not see a*0 + b.  A depth tap
// outside the volume contributes exact zeros, as if skipped.  Element
// offsets are int64_t: decoder inputs reach 4.7e9 elements.  The launch's
// error comes from cudaGetLastError().

#include "conv_tc.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error code of the
// launch (0 on success); the kernel does not synchronise.
extern "C" int tpuseg_gcr_conv3d_forward(
    const void* x, const void* w, const void* a, const void* b, void* y,
    int N, int D, int H, int W, int Ci, int Co, int KD, int pre_relu,
    int post_relu, int dtype, int device, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
      (KD != 1 && KD != 3) || (int64_t)N * D * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = tpuseg_conv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  tpuseg_conv::ConvParams p{};
  p.x = x;
  p.w = w;
  p.bias = nullptr;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.y = y;
  p.D = D;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Co = Co;
  p.KD = KD;
  p.pre_relu = pre_relu;
  p.post_relu = post_relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = tpuseg_conv::conv_tc<float, true>(p, N, device, s);
  else if (dtype == 1)
    err = tpuseg_conv::conv_tc<__nv_bfloat16, true>(p, N, device, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
