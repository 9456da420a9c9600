// Tensor-core implicit-GEMM convolution for Hopper (sm_90a), shared by the
// DoubleConv kernel (double_conv2d.cu) and the fused GroupNorm-conv kernel
// (gcr_conv3d.cu).
//
//   y[m, co] = round_T(relu?(bias?[co] + sum_k A[m, k] * W[k, co]))
//
// for a stride-1 convolution with a KD x 3 x 3 window (KD in {1, 3}),
// padding ((KD-1)/2, 1, 1), on NDHWC activations (2D is D = 1, KD = 1).
// The GEMM view: M = output positions, N = Co, K = taps * Ci flattened as
// k = tap * Ci + ci, which is the row index of the (KD, 3, 3, Ci, Co)
// weight array.  A[m, k] is the input at position m shifted by the tap,
// zero outside the volume (the conv pads its operand with zeros).
// Accumulation is in fp32 registers.
//
// What bounds it.  At the UNets' widths the convs do hundreds of FLOP per
// byte of activation: the tensor-core rate bounds them (989 TFLOP/s bf16,
// 495 TFLOP/s TF32 on an H100 SXM; fp32 costs three TF32 products).
//
// Two main loops, chosen by the shape alone:
//   * halo (conv_halo_kernel), when Ci and Co are multiples of 16 bytes:
//     a block owns a TH x 16 patch of one output plane x 64 or 128 output
//     channels.  A stage is one 32-byte channel chunk of one depth tap:
//     the (TH+2) x 18 input halo, copied by cp.async (zero-filled outside
//     the volume) and normalized once, and that chunk's weights for all 9
//     (kh, kw) taps.  The 9 taps read the halo through shifted ldmatrix row
//     addresses, the 9x reuse the TPU kernel got from its zero-framed tile.
//     Depth taps outside the volume are skipped whole.
//   * gather (conv_gather_kernel), for the rest (Ci = 1 or 3, ragged Ci or
//     Co): BM consecutive positions x BN channels, K walked 64 bytes per
//     stage by element-wise loads in the flattened order, so Ci = 1 costs
//     K = 9 (2D) or 27 (3D), padded to one or two stages, instead of a
//     16-channel chunk per tap.
// Both apply the prologue to the A tile before any fragment load: the
// identity (kernel 1), or the GroupNorm affine
// round_T(relu?(fadd(fmul(x, a[n, ci]), b[n, ci]))) (kernel 2) on in-volume
// elements only, so the padding stays zero after the affine.  The epilogue
// adds the optional bias, applies the optional ReLU and rounds to T on the
// store, straight from the accumulator fragments.
//
// Fragments.  bf16: ldmatrix.x4 for A, ldmatrix.x4.trans for W (stored
// [k][co]) and mma.sync m16n8k16 with fp32 accumulation.  fp32: ldmatrix.x4
// on the fp32 A tile (a 16-byte ldmatrix row is 4 fp32, exactly the TF32
// m16n8k8 A fragment), W by scalar loads from [k][co], and 3xTF32: each
// operand is split as v = big + small (split_tf32) and each 8-deep K step
// adds a_small*b_big, a_big*b_small and a_big*b_big (CUTLASS's
// OpMultiplyAddFastF32; the dropped small*small term is ~2^-22 of each
// product).  The tensor core adds into its accumulator with truncation:
// summed straight into one fragment over K = 27 * 768 that drifted by
// ~1e-3 (measured on the H100).  So the products of one to three taps are
// summed into a fresh fragment and folded into the running sum with a
// rounded fp32 add (__fadd_rn).  Row strides in shared memory are odd
// multiples of 16 bytes (ldmatrix) or 8 mod 32 words (scalar W loads), so
// fragment loads do not conflict on banks.
//
// Filling the card.  The launcher picks the tile from the shape: the
// largest whose grid gives every SM two blocks (halo: 8 x 16 positions x
// 128 channels, then 8 x 16 x 64, else 4 x 16 x 64; Co <= 64 never takes
// 128 channels; gather: 128 x 64, else 64 x 64).  One launch per conv, no
// split-K.  Offsets into activations are 64-bit (4.7e9-element
// decoder inputs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuseg_conv {

constexpr int NTHREADS = 256;
constexpr int GATHER_STAGES = 2;
constexpr int KBYTES = 64;              // K depth of one stage, in bytes
constexpr int A_STRIDE = KBYTES + 16;   // bytes between A rows in smem

struct ConvParams {
  const void* x;        // (N, D, H, W, Ci) in T
  const void* w;        // (KD, 3, 3, Ci, Co) in T, i.e. (K, Co)
  const void* bias;     // (Co,) in T, or null
  const float* a;       // (N, Ci) affine scale, or null (identity prologue)
  const float* b;       // (N, Ci) affine shift
  void* y;              // (N, D, H, W, Co) in T
  int M, N, D, H, W, Ci, Co, KD, K;  // M = N * D * H * W
  int pre_relu, post_relu;
};

template <int BM_, int BN_, int WARPS_M_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = (NTHREADS / 32) / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;    // m16 tiles per warp
  static constexpr int NT = WN / 8;     // n8 tiles per warp
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "bad warp tile");
};
using TileM = Tile<128, 64, 4>;  // warp: 32 positions x 32 channels
using TileS = Tile<64, 64, 2>;   // warp: 32 positions x 16 channels

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int B_PAD = 32;  // row stride = 8 mod 32 words
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int B_PAD = 16;  // row stride = odd count of 16 B
};

template <typename T, class TL>
struct Layout {
  static constexpr int ES = sizeof(T);
  static constexpr int BK = KBYTES / ES;      // K elements per stage
  static constexpr int B_STRIDE = TL::BN * ES + Elem<T>::B_PAD;
  static constexpr int A_BYTES = TL::BM * A_STRIDE;
  static constexpr int STAGE_BYTES = A_BYTES + BK * B_STRIDE;
  static constexpr int SMEM = GATHER_STAGES * STAGE_BYTES;
};

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; zero-filled when !valid (src not read).
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src,
                                              bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src,
                                              bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = big + small exactly: big is v cut to TF32 (sign, exponent, 10
// mantissa bits), small the exact fp32 remainder.  The tensor core reads a
// TF32 operand's top 19 bits and drops the low 13, so small enters cut to
// TF32 as well: an error of at most 2^-21 of v.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(v, __uint_as_float(big)));
}

// ---- element helpers ------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The GroupNorm affine of one element, rounded as the plain version rounds
// it: after the product, after the sum, then relu, then to T.
template <typename T>
__device__ __forceinline__ float affine(float v, float a, float b,
                                        int relu) {
  v = __fadd_rn(__fmul_rn(v, a), b);
  if (relu) v = fmaxf(v, 0.f);
  return to_f(from_f<T>(v));
}

// Where the tap of flattened index k puts output position (d, h, w):
// returns false outside the volume or beyond K; else the element offset.
__device__ __forceinline__ bool tap_source(const ConvParams& p, int k, int m,
                                           int d, int h, int w, int64_t& off,
                                           int& ci) {
  if (k >= p.K) return false;
  const int tap = k / p.Ci;
  ci = k - tap * p.Ci;
  const int kd = tap / 9;
  const int r = tap - kd * 9;
  const int kh = r / 3;
  const int kw = r - kh * 3;
  const int dd = kd - (p.KD - 1) / 2, dh = kh - 1, dw = kw - 1;
  if ((unsigned)(d + dd) >= (unsigned)p.D ||
      (unsigned)(h + dh) >= (unsigned)p.H ||
      (unsigned)(w + dw) >= (unsigned)p.W)
    return false;
  off = ((int64_t)m + ((int64_t)dd * p.H + dh) * p.W + dw) * p.Ci + ci;
  return true;
}

struct RowInfo {
  int m, d, h, w, n;
};

__device__ __forceinline__ RowInfo row_info(const ConvParams& p, int m) {
  RowInfo r;
  r.m = m;
  if (m < p.M) {
    r.w = m % p.W;
    int t = m / p.W;
    r.h = t % p.H;
    t /= p.H;
    r.d = t % p.D;
    r.n = t / p.D;
  } else {  // beyond M: every tap falls outside
    r.d = -(1 << 28);
    r.h = r.w = r.n = 0;
  }
  return r;
}

// ---- the gather kernel: Ci or Co not a multiple of 16 bytes ---------------

template <typename T, class TL, bool AFFINE>
__global__ void __launch_bounds__(NTHREADS, 2)
    conv_gather_kernel(const __grid_constant__ ConvParams p,
                       const int n_tiles) {
  using L = Layout<T, TL>;
  constexpr int BK = L::BK;
  constexpr int ES = L::ES;
  constexpr int MT = TL::MT;
  constexpr int NT = TL::NT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = (int)(blockIdx.x / n_tiles) * TL::BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * TL::BN;
  const int KT = (p.K + BK - 1) / BK;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ wt = static_cast<const T*>(p.w);

  // this thread loads row tid % BM of every A tile
  const RowInfo r = row_info(p, m0 + tid % TL::BM);

  // ---- stage loaders ----
  // Element-wise gather of A (k = tap * Ci + ci), the affine applied on the
  // way in; taps outside the volume and k >= K give zero.
  auto load_a = [&](unsigned char* As, int it) {
    constexpr int STEP = NTHREADS / TL::BM;
    const int row = tid % TL::BM;
#pragma unroll 4
    for (int kk = tid / TL::BM; kk < BK; kk += STEP) {
      int64_t off = 0;
      int ci = 0;
      T v = from_f<T>(0.f);
      if (tap_source(p, it * BK + kk, r.m, r.d, r.h, r.w, off, ci)) {
        v = x[off];
        if constexpr (AFFINE) {
          const int64_t ni = (int64_t)r.n * p.Ci + ci;
          v = from_f<T>(affine<T>(to_f(v), p.a[ni], p.b[ni], p.pre_relu));
        }
      }
      *reinterpret_cast<T*>(As + row * A_STRIDE + kk * ES) = v;
    }
  };

  auto load_b = [&](unsigned char* Bs, int it) {
#pragma unroll 4
    for (int id = tid; id < BK * TL::BN; id += NTHREADS) {
      const int kr = id / TL::BN;
      const int col = id - kr * TL::BN;
      const int k = it * BK + kr;
      T v = from_f<T>(0.f);
      if (k < p.K && n0 + col < p.Co) v = wt[(int64_t)k * p.Co + n0 + col];
      *reinterpret_cast<T*>(Bs + kr * L::B_STRIDE + col * ES) = v;
    }
  };

  auto load_stage = [&](int slot, int it) {
    unsigned char* As = smem + slot * L::STAGE_BYTES;
    load_a(As, it);
    load_b(As + L::A_BYTES, it);
  };

  // ---- warp tile and fragments ----
  const int wm0 = (warp % TL::WARPS_M) * TL::WM;
  const int wn0 = (warp / TL::WARPS_M) * TL::WN;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // ldmatrix row address of this lane: row (lane & 7) + 8 * ((lane >> 3) & 1)
  // of the 16-row block, 16-byte column (lane >> 4)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_lane = (wm0 + lrow) * A_STRIDE + (lane >> 4) * 16;
  const int b_lane = lrow * L::B_STRIDE + (wn0 + (lane >> 4) * 8) * ES;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto compute = [&](int slot) {
    const unsigned char* As = smem + slot * L::STAGE_BYTES;
    const unsigned char* Bs = As + L::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < KBYTES / 32; ++ks) {
      if constexpr (ES == 2) {
        uint32_t bf[NT][2];
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_u32(Bs + b_lane + ks * 16 * L::B_STRIDE +
                                        jj * 16 * ES));
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, smem_u32(As + a_lane + i * 16 * A_STRIDE + ks * 32));
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      } else {
        constexpr int SBW = L::B_STRIDE / 4;
        const float* Bf = reinterpret_cast<const float*>(Bs);
        uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* bp = Bf + (ks * 8 + t4) * SBW + wn0 + j * 8 + g;
          split_tf32(bp[0], bb[j][0], bsm[j][0]);
          split_tf32(bp[4 * SBW], bb[j][1], bsm[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4], ab[4], as[4];
          ldmatrix_x4(af, smem_u32(As + a_lane + i * 16 * A_STRIDE + ks * 32));
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_tf32(__uint_as_float(af[q]), ab[q], as[q]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            // a fresh fragment per K step, folded with a rounded add
            // (the tensor core's own accumulate truncates; see the top)
            float s[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(s, as, bb[j][0], bb[j][1]);
            mma_tf32(s, ab, bsm[j][0], bsm[j][1]);
            mma_tf32(s, ab, bb[j][0], bb[j][1]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = __fadd_rn(acc[i][j][q], s[q]);
          }
        }
      }
    }
  };

  // ---- main loop: two slots, one barrier per stage ----
  load_stage(0, 0);
  for (int it = 0; it < KT; ++it) {
    __syncthreads();
    if (it + 1 < KT) load_stage((it + 1) % GATHER_STAGES, it + 1);
    compute(it % GATHER_STAGES);
  }

  // ---- epilogue: bias, relu, round to T, masked stores ----
  T* __restrict__ y = static_cast<T*>(p.y);
  const T* __restrict__ bias = static_cast<const T*>(p.bias);
  const bool pairs = (p.Co & 1) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn0 + j * 8 + 2 * t4;
    if (col >= p.Co) continue;
    const bool has1 = col + 1 < p.Co;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = to_f(bias[col]);
      if (has1) b1 = to_f(bias[col + 1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        if (row >= p.M) continue;
        float v0 = acc[i][j][2 * h] + b0;
        float v1 = acc[i][j][2 * h + 1] + b1;
        if (p.post_relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        T* yp = y + (int64_t)row * p.Co + col;
        if (pairs) {  // col is even, so the pair is aligned
          if constexpr (ES == 2) {
            *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(yp) = make_float2(v0, v1);
          }
        } else {
          yp[0] = from_f<T>(v0);
          if (has1) yp[1] = from_f<T>(v1);
        }
      }
    }
  }
}

// ---- the halo kernel: Ci and Co multiples of 16 bytes ----------------------
//
// A block owns a TH x 16 patch of one output plane (n, d) x BN output
// channels.  A stage is one 32-byte channel chunk (one mma k-step) of one
// depth tap: the (TH+2) x 18 input halo of that plane and chunk, copied and
// normalized ONCE, and the chunk's weights of all 9 (kh, kw) taps.  The 9
// taps then read the halo through shifted ldmatrix row addresses: an m16
// fragment is one patch row, and tap (kh, kw) moves its 16 rows by kh halo
// rows and kw pixels.  Halo pixels are 48 bytes apart (3 chunks, odd: the
// 8 rows of an ldmatrix phase fall in 8 distinct bank groups).  Depth taps
// outside the volume are skipped whole; pixels outside it stay zero.

constexpr int H_CBYTES = 32;           // channel bytes per stage
constexpr int H_PIX = H_CBYTES + 16;   // bytes between halo pixels
// Each stage holds 9 taps of work.  Two stages of the 8 x 16 x 128 tile
// (47,808 B each) let two blocks share an SM's 228 KiB; a third would not.
constexpr int H_STAGES = 2;

template <int TH_, int BN_, int WARPS_M_>
struct HTile {
  static constexpr int TH = TH_;
  static constexpr int TW = 16;
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = (NTHREADS / 32) / WARPS_M;
  static constexpr int MT = TH / WARPS_M;  // patch rows (m16 tiles) per warp
  static constexpr int WN = BN / WARPS_N;
  static constexpr int NT = WN / 8;
  static constexpr int HWP = TW + 2;       // halo pixels per row
  static constexpr int HP = (TH + 2) * HWP;
  static_assert(MT >= 1 && TH % WARPS_M == 0 && NT >= 2 && NT % 2 == 0,
                "bad warp tile");
};
using HTileL = HTile<8, 128, 2>;  // warp: 4 rows x 32 channels
using HTileM = HTile<8, 64, 4>;   // warp: 2 rows x 32 channels
using HTileS = HTile<4, 64, 4>;   // warp: 1 row x 32 channels

template <typename T, class HT>
struct HLayout {
  static constexpr int ES = sizeof(T);
  static constexpr int BKC = H_CBYTES / ES;  // channels per stage
  static constexpr int VECN = 16 / ES;
  static constexpr int B_STRIDE = HT::BN * ES + Elem<T>::B_PAD;
  static constexpr int A_BYTES = HT::HP * H_PIX;
  static constexpr int STAGE_BYTES = A_BYTES + 9 * BKC * B_STRIDE;
  static constexpr int SMEM = H_STAGES * STAGE_BYTES;
  static constexpr int A_CHUNKS = HT::HP * (H_CBYTES / 16);
  static constexpr int AJ = (A_CHUNKS + NTHREADS - 1) / NTHREADS;
};

template <typename T, class HT, bool AFFINE>
__global__ void __launch_bounds__(NTHREADS, 2)
    conv_halo_kernel(const __grid_constant__ ConvParams p, const int tiles_w,
                     const int tiles_h, const int n_tiles) {
  using L = HLayout<T, HT>;
  constexpr int BKC = L::BKC;
  constexpr int VECN = L::VECN;
  constexpr int ES = L::ES;
  constexpr int MT = HT::MT;
  constexpr int NT = HT::NT;
  constexpr int HWP = HT::HWP;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int t = (int)(blockIdx.x / n_tiles);
  const int n0 = (int)(blockIdx.x % n_tiles) * HT::BN;
  const int w0 = (t % tiles_w) * HT::TW;
  t /= tiles_w;
  const int h0 = (t % tiles_h) * HT::TH;
  t /= tiles_h;
  const int d = t % p.D;
  const int n = t / p.D;
  const int pd = (p.KD - 1) / 2;
  const int kd_lo = max(0, pd - d);
  const int kd_hi = min(p.KD - 1, p.D - 1 - d + pd);
  const int cch = (p.Ci + BKC - 1) / BKC;
  const int KT = (kd_hi - kd_lo + 1) * cch;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ wt = static_cast<const T*>(p.w);

  // the halo chunks this thread copies: in-plane element offset of pixel
  // (h, w) and 16-byte column c, or -1 where the pixel is outside the plane
  int a_off[L::AJ];
#pragma unroll
  for (int j = 0; j < L::AJ; ++j) {
    const int id = tid + j * NTHREADS;
    const int px = id >> 1;
    const int hr = px / HWP;
    const int h = h0 - 1 + hr;
    const int w = w0 - 1 + (px - hr * HWP);
    a_off[j] = (id < L::A_CHUNKS && (unsigned)h < (unsigned)p.H &&
                (unsigned)w < (unsigned)p.W)
                   ? (h * p.W + w) * p.Ci + (id & 1) * VECN
                   : -1;
  }

  auto load_stage = [&](int slot, int it) {
    unsigned char* As = smem + slot * L::STAGE_BYTES;
    unsigned char* Bs = As + L::A_BYTES;
    const int kd = kd_lo + it / cch;
    const int ci0 = (it % cch) * BKC;
    const T* plane =
        x + (((int64_t)n * p.D + d + kd - pd) * p.H * p.W) * p.Ci + ci0;
#pragma unroll
    for (int j = 0; j < L::AJ; ++j) {
      const int id = tid + j * NTHREADS;
      if (id < L::A_CHUNKS) {
        const bool ok = a_off[j] >= 0 && ci0 + (id & 1) * VECN < p.Ci;
        cp_async16_ca(smem_u32(As + (id >> 1) * H_PIX + (id & 1) * 16),
                      ok ? (const void*)(plane + a_off[j]) : (const void*)x,
                      ok);
      }
    }
    constexpr int CPR = HT::BN * ES / 16;  // 16-byte chunks per W row
    for (int id = tid; id < 9 * BKC * CPR; id += NTHREADS) {
      const int r = id / CPR;  // tap * BKC + kr
      const int cc = id - r * CPR;
      const int tap = r / BKC;
      const int ci = ci0 + r - tap * BKC;
      const int col = n0 + cc * VECN;
      const bool ok = ci < p.Ci && col < p.Co;
      cp_async16_cg(
          smem_u32(Bs + r * L::B_STRIDE + cc * 16),
          ok ? (const void*)(wt + ((int64_t)(kd * 9 + tap) * p.Ci + ci) * p.Co +
                             col)
             : (const void*)wt,
          ok);
    }
  };

  // The GroupNorm affine on the halo chunks this thread copied; pixels
  // outside the volume stay zero.
  auto transform = [&](int slot, int it) {
    unsigned char* As = smem + slot * L::STAGE_BYTES;
    const int ci0 = (it % cch) * BKC;
#pragma unroll
    for (int j = 0; j < L::AJ; ++j) {
      const int id = tid + j * NTHREADS;
      const int ci = ci0 + (id & 1) * VECN;
      if (id >= L::A_CHUNKS || a_off[j] < 0 || ci >= p.Ci) continue;
      const int64_t ni = (int64_t)n * p.Ci + ci;
      unsigned char* q = As + (id >> 1) * H_PIX + (id & 1) * 16;
      alignas(16) T vals[VECN];
      alignas(16) float av[VECN];
      alignas(16) float bv[VECN];
      *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(q);
#pragma unroll
      for (int e = 0; e < VECN / 4; ++e) {
        *reinterpret_cast<float4*>(av + 4 * e) =
            __ldg(reinterpret_cast<const float4*>(p.a + ni) + e);
        *reinterpret_cast<float4*>(bv + 4 * e) =
            __ldg(reinterpret_cast<const float4*>(p.b + ni) + e);
      }
#pragma unroll
      for (int e = 0; e < VECN; ++e)
        vals[e] = from_f<T>(affine<T>(to_f(vals[e]), av[e], bv[e],
                                      p.pre_relu));
      *reinterpret_cast<uint4*>(q) = *reinterpret_cast<const uint4*>(vals);
    }
  };

  const int wrow0 = (warp % HT::WARPS_M) * MT;
  const int wn0 = (warp / HT::WARPS_M) * HT::WN;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_lane = (wrow0 * HWP + lrow) * H_PIX + (lane >> 4) * 16;
  const int b_lane = lrow * L::B_STRIDE + (wn0 + (lane >> 4) * 8) * ES;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // Small warp tiles unroll the 9 taps; the 4 x 4 one keeps them in a loop
  // (fragments of several taps in flight at once spill its registers).
  constexpr bool UNROLL = MT * NT <= 8;
  // fp32: taps summed into one fresh fragment before the rounded fold (a
  // kernel row of 3 where the registers allow)
  constexpr int G = UNROLL ? 3 : 1;

  auto tap_bf16 = [&](const unsigned char* As, const unsigned char* Bs,
                      int tap) {
    const int shift = ((tap / 3) * HWP + tap % 3) * H_PIX;
    const unsigned char* Bt = Bs + tap * BKC * L::B_STRIDE;
    uint32_t bf[NT][2];
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, smem_u32(Bt + b_lane + jj * 16 * ES));
      bf[2 * jj][0] = r[0];
      bf[2 * jj][1] = r[1];
      bf[2 * jj + 1][0] = r[2];
      bf[2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t af[4];
      ldmatrix_x4(af, smem_u32(As + a_lane + i * HWP * H_PIX + shift));
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
    }
  };

  // taps tap0 .. tap0 + count - 1 (count <= G), 3xTF32
  auto taps_fp32 = [&](const unsigned char* As, const unsigned char* Bs,
                       int tap0, int count) {
    constexpr int SBW = L::B_STRIDE / 4;
    uint32_t bb[G][NT][2], bsm[G][NT][2];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (u >= count) break;
      const float* Bf = reinterpret_cast<const float*>(
          Bs + (tap0 + u) * BKC * L::B_STRIDE);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* bp = Bf + t4 * SBW + wn0 + j * 8 + g;
        split_tf32(bp[0], bb[u][j][0], bsm[u][j][0]);
        split_tf32(bp[4 * SBW], bb[u][j][1], bsm[u][j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ab[G][4], as[G][4];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (u >= count) break;
        const int tap = tap0 + u;
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(As + a_lane + i * HWP * H_PIX +
                                 ((tap / 3) * HWP + tap % 3) * H_PIX));
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(__uint_as_float(af[q]), ab[u][q], as[u][q]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};  // fresh: see the top
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (u >= count) break;
          mma_tf32(s, as[u], bb[u][j][0], bb[u][j][1]);
          mma_tf32(s, ab[u], bsm[u][j][0], bsm[u][j][1]);
          mma_tf32(s, ab[u], bb[u][j][0], bb[u][j][1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[i][j][q] = __fadd_rn(acc[i][j][q], s[q]);
      }
    }
  };

  auto compute = [&](int slot) {
    const unsigned char* As = smem + slot * L::STAGE_BYTES;
    const unsigned char* Bs = As + L::A_BYTES;
    if constexpr (ES == 2) {
      if constexpr (UNROLL) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) tap_bf16(As, Bs, tap);
      } else {
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) tap_bf16(As, Bs, tap);
      }
    } else {
      if constexpr (UNROLL) {
#pragma unroll
        for (int tap = 0; tap < 9; tap += G) taps_fp32(As, Bs, tap, min(G, 9 - tap));
      } else {
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) taps_fp32(As, Bs, tap, 1);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < H_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < KT; ++it) {
    cp_async_wait<H_STAGES - 2>();
    if constexpr (AFFINE) transform(it % H_STAGES, it);
    __syncthreads();
    const int nxt = it + H_STAGES - 1;
    if (nxt < KT) load_stage(nxt % H_STAGES, nxt);
    cp_async_commit();
    compute(it % H_STAGES);
  }
  cp_async_wait<0>();

  T* __restrict__ y = static_cast<T*>(p.y);
  const T* __restrict__ bias = static_cast<const T*>(p.bias);
  const int64_t plane_out = ((int64_t)n * p.D + d) * p.H;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn0 + j * 8 + 2 * t4;
    if (col >= p.Co) continue;  // Co is a multiple of VECN: col + 1 < Co
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = to_f(bias[col]);
      b1 = to_f(bias[col + 1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int h = h0 + wrow0 + i;
      if (h >= p.H) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int w = w0 + g + 8 * hh;
        if (w >= p.W) continue;
        float v0 = acc[i][j][2 * hh] + b0;
        float v1 = acc[i][j][2 * hh + 1] + b1;
        if (p.post_relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        T* yp = y + ((plane_out + h) * p.W + w) * p.Co + col;
        if constexpr (ES == 2) {
          *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(yp) = make_float2(v0, v1);
        }
      }
    }
  }
}

// ---- launcher ---------------------------------------------------------------

template <typename T, class HT, bool AFFINE>
cudaError_t launch_halo(const ConvParams& p, cudaStream_t stream) {
  using L = HLayout<T, HT>;
  auto kernel = conv_halo_kernel<T, HT, AFFINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_w = (p.W + HT::TW - 1) / HT::TW;
  const int tiles_h = (p.H + HT::TH - 1) / HT::TH;
  const int n_tiles = (p.Co + HT::BN - 1) / HT::BN;
  const long long blocks =
      (long long)p.N * p.D * tiles_h * tiles_w * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NTHREADS, L::SMEM, stream>>>(p, tiles_w, tiles_h,
                                                          n_tiles);
  return cudaGetLastError();
}

inline long long halo_blocks(const ConvParams& p, int th, int bn) {
  return (long long)p.N * p.D * ((p.H + th - 1) / th) *
         ((p.W + 15) / 16) * ((p.Co + bn - 1) / bn);
}

template <typename T, class TL, bool AFFINE>
cudaError_t launch_gather(const ConvParams& p, cudaStream_t stream) {
  using L = Layout<T, TL>;
  auto kernel = conv_gather_kernel<T, TL, AFFINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (p.M + TL::BM - 1) / TL::BM;
  const long long n_tiles = (p.Co + TL::BN - 1) / TL::BN;
  if (m_tiles * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(m_tiles * n_tiles), NTHREADS, L::SMEM, stream>>>(
      p, (int)n_tiles);
  return cudaGetLastError();
}

inline bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// Fills the derived fields of p and launches one conv on `stream`.
template <typename T, bool AFFINE>
cudaError_t conv_tc(ConvParams p, int N, int device, cudaStream_t stream) {
  const long long m = (long long)N * p.D * p.H * p.W;
  if (m <= 0 || m > 0x7fffffffLL || p.Ci <= 0 || p.Co <= 0 ||
      (p.KD != 1 && p.KD != 3) || (long long)p.KD * 9 * p.Ci > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  p.M = (int)m;
  p.N = N;
  p.K = p.KD * 9 * p.Ci;
  constexpr int VECN = 16 / (int)sizeof(T);
  const bool vec = p.Ci % VECN == 0 && p.Co % VECN == 0 && aligned16(p.x) &&
                   aligned16(p.w) &&
                   (!AFFINE || (aligned16(p.a) && aligned16(p.b)));
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (vec) {
    // in-plane offsets of the halo path are 32-bit
    if ((long long)p.H * p.W * p.Ci > 0x7fffffffLL) return cudaErrorInvalidValue;
    const long long want = 2LL * sms;
    if (p.Co > 64 && halo_blocks(p, 8, 128) >= want)
      return launch_halo<T, HTileL, AFFINE>(p, stream);
    if (halo_blocks(p, 8, 64) >= want)
      return launch_halo<T, HTileM, AFFINE>(p, stream);
    return launch_halo<T, HTileS, AFFINE>(p, stream);
  }
  // the gather path (first layers, ragged shapes): 128 positions when
  // that gives every SM two blocks, else 64
  if ((long long)((p.M + 127) / 128) * ((p.Co + 63) / 64) >= 2LL * sms)
    return launch_gather<T, TileM, AFFINE>(p, stream);
  return launch_gather<T, TileS, AFFINE>(p, stream);
}

// Make `device` current, calling cudaSetDevice only when it is not (a
// launch's host cost counts where the kernel is short).
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace tpuseg_conv
