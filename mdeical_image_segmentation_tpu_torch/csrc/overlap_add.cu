// Overlap-add of a batch of patch predictions into running sum and count
// maps, for sliding-window inference on Hopper (sm_90a):
//   for each patch i in order:  acc[z:z+pd, y:y+ph, x:x+pw, :] += w_i * patch_i
//                               cnt[same region]              += w_i
// acc, cnt (D, H, W, C) fp32, updated in place; patches (P, pd, ph, pw, C)
// fp32 or bf16; starts (P, 3) int32 (z, y, x); weights (P,) fp32 (the valid
// mask of a padded tail batch: 0 adds nothing to either map).
//
// Replaces the Pallas TPU kernel `_overlap_kernel` reached through
// `overlap_add_into_pallas` in mdeical_image_segmentation_tpu/ops/overlap.py.
//
// What bounds it on the H100.  One add per element: device-memory bandwidth.
// It reads each patch element once and reads and writes each covered
// voxel of the two maps once.
//
// Design.  The TPU grid walks the patches in order, so its read-modify-write
// of overlapping regions never races; on a GPU, patches added by parallel
// blocks would.  Here each output element (voxel, channel) of the batch's
// bounding box -- which the host knows from `starts` -- has ONE owner
// thread, which sums the covering patches in patch order.  With weights in
// {0, 1} that is bit-identical to the plain sequential version: the same
// fp32 adds in the same order (product and sum rounded separately, no FMA
// contraction).  A voxel that no patch covers is not written.  The starts
// and weights sit in shared memory.  The grid is (ceil(bx*C/256), by, bz),
// so no thread divides a 64-bit index; all offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_P = 1024;  // patches per call (shared-memory table)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT) overlap_add_kernel(
    float* __restrict__ acc, float* __restrict__ cnt,
    const T* __restrict__ patches, const int* __restrict__ starts,
    const float* __restrict__ weights, int P, int pd, int ph, int pw, int C,
    int H, int W, int z0, int y0, int x0, int bx) {
  __shared__ int s_start[3 * MAX_P];
  __shared__ float s_w[MAX_P];
  for (int i = threadIdx.x; i < P; i += NT) {
    s_start[3 * i + 0] = starts[3 * i + 0];
    s_start[3 * i + 1] = starts[3 * i + 1];
    s_start[3 * i + 2] = starts[3 * i + 2];
    s_w[i] = weights[i];
  }
  __syncthreads();

  const int e = blockIdx.x * NT + threadIdx.x;  // (x, c) within the row
  if (e >= bx * C) return;
  const int c = e % C;
  const int xx = x0 + e / C;
  const int yy = y0 + blockIdx.y;
  const int zz = z0 + blockIdx.z;
  const int64_t patch_elems = (int64_t)pd * ph * pw * C;

  float a = 0.f, k = 0.f;
  bool covered = false;
  for (int i = 0; i < P; ++i) {
    const int pz = zz - s_start[3 * i + 0];
    const int py = yy - s_start[3 * i + 1];
    const int px = xx - s_start[3 * i + 2];
    if (pz < 0 || pz >= pd || py < 0 || py >= ph || px < 0 || px >= pw)
      continue;
    const int64_t o = (int64_t)i * patch_elems +
                      (((int64_t)pz * ph + py) * pw + px) * C + c;
    if (!covered) {
      const int64_t v = (((int64_t)zz * H + yy) * W + xx) * C + c;
      a = acc[v];
      k = cnt[v];
      covered = true;
    }
    const float wi = s_w[i];
    a = __fadd_rn(a, __fmul_rn(wi, to_f(patches[o])));
    k = __fadd_rn(k, wi);
  }
  if (covered) {
    const int64_t v = (((int64_t)zz * H + yy) * W + xx) * C + c;
    acc[v] = a;
    cnt[v] = k;
  }
}

}  // namespace

// dtype (of the patches): 0 = float32, 1 = bfloat16.  The box
// [z0, z0+bz) x [y0, y0+by) x [x0, x0+bx) must hold every patch.  Returns
// the CUDA error code of the launch (0 on success); no synchronisation.
extern "C" int tpuseg_overlap_add(void* acc, void* cnt, const void* patches,
                                  const void* starts, const void* weights,
                                  int P, int pd, int ph, int pw, int C, int D,
                                  int H, int W, int z0, int y0, int x0,
                                  int bz, int by, int bx, int dtype,
                                  int device, void* stream) {
  if (P <= 0 || P > MAX_P || pd <= 0 || ph <= 0 || pw <= 0 || C <= 0 ||
      bz <= 0 || by <= 0 || bx <= 0 || bz > 65535 || by > 65535 ||
      z0 < 0 || y0 < 0 || x0 < 0 || z0 + bz > D || y0 + by > H ||
      x0 + bx > W || (long long)bx * C > 0x7fffffffLL - NT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((bx * C + NT - 1) / NT, by, bz);
  float* a = static_cast<float*>(acc);
  float* k = static_cast<float*>(cnt);
  const int* st = static_cast<const int*>(starts);
  const float* w = static_cast<const float*>(weights);
  if (dtype == 0)
    overlap_add_kernel<float><<<grid, NT, 0, s>>>(
        a, k, static_cast<const float*>(patches), st, w, P, pd, ph, pw, C, H,
        W, z0, y0, x0, bx);
  else if (dtype == 1)
    overlap_add_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        a, k, static_cast<const __nv_bfloat16*>(patches), st, w, P, pd, ph,
        pw, C, H, W, z0, y0, x0, bx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
