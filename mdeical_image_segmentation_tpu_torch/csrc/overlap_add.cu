// Overlap-add of a batch of patch predictions into running sum and count
// maps, for sliding-window inference on Hopper (sm_90a):
//   for each patch i in order:  acc[z:z+pd, y:y+ph, x:x+pw, :] += w_i * patch_i
//                               cnt[same region]              += w_i
// acc, cnt (D, H, W, C) fp32, contiguous, updated in place; patches
// (P, pd, ph, pw, C) fp32 or bf16 with any strides (the predictor passes
// the halo-stripped view of the network output, read in place); starts
// (z, y, x) and weights w (the valid mask of a padded tail batch: 0 adds
// nothing to either map) come by value, in the kernel's parameter table.
//
// Replaces the Pallas TPU kernel `_overlap_kernel` reached through
// `overlap_add_into_pallas` in mdeical_image_segmentation_tpu/ops/overlap.py.
//
// What bounds it on the H100.  One add per element: device-memory bandwidth.
// It reads each patch element once and reads and writes each covered
// element of the two maps once.
//
// Design.  The TPU grid walks the patches in order, so its read-modify-write
// of overlapping regions never races; on a GPU, patches added by parallel
// blocks would.  Here each output element (voxel, channel) has ONE owner
// thread, which sums the patches that cover it in patch order.  With
// weights in {0, 1} that is bit-identical to the plain sequential version:
// the same fp32 adds in the same order (product and sum rounded
// separately, no FMA contraction).  An element that no patch covers is not
// written.
// - The host launches once per chunk of up to K patches, in patch order,
//   with the chunk's (z, y, x) starts and weights in a __grid_constant__
//   table: no host-to-device copy and no synchronisation, and a later
//   chunk reads what the earlier one wrote.
// - A block owns a segment of one (z, y) row of the chunk's bounding box.
//   Warp 0 lists in shared memory, in patch order (a ballot per 32
//   patches), the patches that cover the row and overlap the segment; a
//   block whose list is empty returns at once.
// - A thread owns V = 4 consecutive (x, c) elements of the row, aligned to
//   16 bytes of acc, and loops over that short list only.  acc and cnt are
//   read and written as one 16-byte vector each where all 4 elements are
//   covered (scalars at the row's head and tail, and beside a patch's
//   edge); a patch's 4 values are one 8- or 16-byte load where its (x, c)
//   run is contiguous and aligned, else 4 scalar loads through the strides.
//   One channel (the predictor's maps) is its own instantiation: voxel x
//   is the element's offset in the row, with no division.
// All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NT = 256;  // threads per block at most
constexpr int V = 4;         // elements per thread: 16 bytes of acc
constexpr int K = 128;       // patches per launch (the parameter table)

struct PatchTable {
  int z[K], y[K], x[K];
  float w[K];
};

struct Geometry {
  long long sb, sz, sy, sx, sc;  // patch strides, in elements
  int n, pd, ph, pw, C;          // patches in this launch, patch extent
  int H, W;                      // map extent (rows of W * C elements)
  int z0, y0, x0, bx;            // the chunk's bounding box
  int seg;                       // elements per block segment (NT * V)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 consecutive patch values from one aligned 16-byte (fp32) or 8-byte
// (bf16) load.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  f[0] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(v.x & 0xffffu)));
  f[1] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(v.x >> 16)));
  f[2] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(v.y & 0xffffu)));
  f[3] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(v.y >> 16)));
}

// grid (segments, by, bz); block NT threads; vec_maps: acc and cnt 16-byte
// aligned.
template <typename T, bool ONE_C>
__global__ void __launch_bounds__(MAX_NT) overlap_add_kernel(
    float* __restrict__ acc, float* __restrict__ cnt,
    const T* __restrict__ patches, __grid_constant__ const PatchTable tab,
    __grid_constant__ const Geometry g, bool vec_maps) {
  __shared__ int s_list[K];
  __shared__ int s_count;
  const int C = ONE_C ? 1 : g.C;
  const int zz = g.z0 + blockIdx.z;
  const int yy = g.y0 + blockIdx.y;
  const int64_t rowbase = ((int64_t)zz * g.H + yy) * g.W * C;
  const int64_t lo = rowbase + (int64_t)g.x0 * C;      // the box's elements
  const int64_t hi = lo + (int64_t)g.bx * C;           // of this row
  const int64_t seg0 = lo - lo % V + (int64_t)blockIdx.x * g.seg;
  const int64_t seg_lo = seg0 > lo ? seg0 : lo;
  const int64_t seg_hi = seg0 + g.seg < hi ? seg0 + g.seg : hi;
  if (seg_lo >= seg_hi) return;
  // the segment's voxels x in [vx_lo, vx_hi]
  const int vx_lo = (int)((seg_lo - rowbase) / C);
  const int vx_hi = (int)((seg_hi - 1 - rowbase) / C);

  if (threadIdx.x < 32) {  // warp 0: the covering patches, in order
    const unsigned lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < g.n; base += 32) {
      const int i = base + lane;
      bool cov = false;
      if (i < g.n) {
        const int dz = zz - tab.z[i], dy = yy - tab.y[i];
        cov = dz >= 0 && dz < g.pd && dy >= 0 && dy < g.ph &&
              tab.x[i] <= vx_hi && tab.x[i] + g.pw > vx_lo;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, cov);
      if (cov) s_list[count + __popc(mask & ((1u << lane) - 1u))] = i;
      count += __popc(mask);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  const int listed = s_count;
  if (listed == 0) return;

  const int64_t e0 = seg0 + (int64_t)threadIdx.x * V;
  if (e0 >= seg_hi || e0 + V <= seg_lo) return;
  // each element's voxel x and channel c (only for elements of the box)
  int ex[V], ec[V];
  bool in_box[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    in_box[k] = e0 + k >= seg_lo && e0 + k < seg_hi;
    const int r = in_box[k] ? (int)(e0 + k - rowbase) : 0;
    ex[k] = r / C;
    ec[k] = r % C;
  }
  // which elements some listed patch covers
  bool cov[V] = {};
  for (int j = 0; j < listed; ++j) {
    const int px = tab.x[s_list[j]];
#pragma unroll
    for (int k = 0; k < V; ++k)
      cov[k] = cov[k] || (in_box[k] && ex[k] >= px && ex[k] < px + g.pw);
  }
  bool any = false, all = true;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    any = any || cov[k];
    all = all && cov[k];
  }
  if (!any) return;
  const bool vec = all && vec_maps;

  float a[V], m[V];  // sum and count of each element
  if (vec) {
    const float4 va = *reinterpret_cast<const float4*>(acc + e0);
    const float4 vm = *reinterpret_cast<const float4*>(cnt + e0);
    a[0] = va.x; a[1] = va.y; a[2] = va.z; a[3] = va.w;
    m[0] = vm.x; m[1] = vm.y; m[2] = vm.z; m[3] = vm.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a[k] = cov[k] ? acc[e0 + k] : 0.f;
      m[k] = cov[k] ? cnt[e0 + k] : 0.f;
    }
  }

  const bool run = g.sc == 1 && g.sx == C;  // a patch row's (x, c) contiguous
  for (int j = 0; j < listed; ++j) {
    const int i = s_list[j];
    const int px = tab.x[i];
    const float w = tab.w[i];
    const T* prow = patches + (int64_t)i * g.sb +
                    (int64_t)(zz - tab.z[i]) * g.sz +
                    (int64_t)(yy - tab.y[i]) * g.sy;
    bool inside[V];
    bool whole = true;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      inside[k] = in_box[k] && ex[k] >= px && ex[k] < px + g.pw;
      whole = whole && inside[k];
    }
    float p[V];
    const T* p0 = prow + (int64_t)(ex[0] - px) * g.sx + (int64_t)ec[0] * g.sc;
    if (whole && run &&
        (reinterpret_cast<uintptr_t>(p0) & (V * sizeof(T) - 1)) == 0) {
      load4(p0, p);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        p[k] = inside[k] ? to_f(prow[(int64_t)(ex[k] - px) * g.sx +
                                     (int64_t)ec[k] * g.sc])
                         : 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (inside[k]) {
        a[k] = __fadd_rn(a[k], __fmul_rn(w, p[k]));
        m[k] = __fadd_rn(m[k], w);
      }
    }
  }

  if (vec) {
    *reinterpret_cast<float4*>(acc + e0) = make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(cnt + e0) = make_float4(m[0], m[1], m[2], m[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (cov[k]) {
        acc[e0 + k] = a[k];
        cnt[e0 + k] = m[k];
      }
    }
  }
}

template <typename T>
void launch(float* acc, float* cnt, const void* patches, const PatchTable& tab,
            const Geometry& g, bool vec_maps, dim3 grid, long long nt,
            cudaStream_t s) {
  const T* p = static_cast<const T*>(patches);
  if (g.C == 1)
    overlap_add_kernel<T, true><<<grid, (unsigned)nt, 0, s>>>(
        acc, cnt, p, tab, g, vec_maps);
  else
    overlap_add_kernel<T, false><<<grid, (unsigned)nt, 0, s>>>(
        acc, cnt, p, tab, g, vec_maps);
}

// Make `device` current, calling cudaSetDevice only when it is not (the
// launch's host cost counts where the kernel is short).
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

// One launch: patches i = 0 .. P-1 of the chunk at `patches` (its first
// patch), with strides sb, sz, sy, sx, sc in elements; starts (P, 3) int32
// and weights (P,) fp32 in HOST memory, copied into the launch's parameter
// table.  dtype (of the patches): 0 = float32, 1 = bfloat16.  The box
// [z0, z0+bz) x [y0, y0+by) x [x0, x0+bx) must hold every patch.  Returns
// the CUDA error code of the launch (0 on success); no synchronisation.
extern "C" int tpuseg_overlap_add(void* acc, void* cnt, const void* patches,
                                  const void* starts, const void* weights,
                                  int P, int pd, int ph, int pw, int C,
                                  long long sb, long long sz, long long sy,
                                  long long sx, long long sc, int D, int H,
                                  int W, int z0, int y0, int x0, int bz,
                                  int by, int bx, int dtype, int device,
                                  void* stream) {
  if (P <= 0 || P > K || pd <= 0 || ph <= 0 || pw <= 0 || C <= 0 ||
      bz <= 0 || by <= 0 || bx <= 0 || bz > 65535 || by > 65535 ||
      z0 < 0 || y0 < 0 || x0 < 0 || z0 + bz > D || y0 + by > H ||
      x0 + bx > W || (long long)W * C > 0x7fffffffLL - V ||
      sb < 0 || sz < 0 || sy < 0 || sx < 0 || sc < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  PatchTable tab;
  const int* st = static_cast<const int*>(starts);
  const float* w = static_cast<const float*>(weights);
  for (int i = 0; i < P; ++i) {
    tab.z[i] = st[3 * i + 0];
    tab.y[i] = st[3 * i + 1];
    tab.x[i] = st[3 * i + 2];
    tab.w[i] = w[i];
  }
  for (int i = P; i < K; ++i) {
    tab.z[i] = tab.y[i] = tab.x[i] = 0;
    tab.w[i] = 0.f;
  }
  // threads: one per 4 elements of a row of the box (plus the alignment
  // shift of its head), in whole warps, at most MAX_NT; longer rows take
  // several segments
  const long long row = (long long)bx * C + V - 1;
  long long nt = (row + V - 1) / V;
  nt = (nt + 31) / 32 * 32;
  if (nt > MAX_NT) nt = MAX_NT;
  Geometry g{sb, sz, sy, sx, sc, P, pd, ph, pw, C, H, W, z0, y0, x0, bx,
             (int)(nt * V)};
  const long long segs = (row + g.seg - 1) / g.seg;
  const dim3 grid((unsigned)segs, by, bz);
  const bool vec_maps =
      ((reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(cnt)) &
       15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  float* k = static_cast<float*>(cnt);
  if (dtype == 0)
    launch<float>(a, k, patches, tab, g, vec_maps, grid, nt, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(a, k, patches, tab, g, vec_maps, grid, nt, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
