// W8A8 quantized convolution for Hopper (sm_90a), on the int8 tensor cores:
// the int8 post-training-quantization conv of the port's TorchConv
//   x_q[m, ci] = clamp(rint(x[m, ci] / x_scale), -127, 127)          (int8)
//   acc[m, co] = sum_k x_q[m shifted by tap k, ci] * w_q[co, k]        (int32)
//   y[m, co]   = round_TO(float(acc) * cs[co] + bias?[co])
// for a stride-1 convolution with a KD x KH x KW window and symmetric zero
// padding (PD, PH, PW), on NDHWC activations (2D is D = 1, KD = 1).  x is
// float32 or bfloat16; y is float32, bfloat16, or the raw int32 sums.
// cs[co] = x_scale * w_scale[co] is computed by the caller, once.
//
// No TPU kernel behind it: the JAX package leaves its int8 conv
// (`Int8Conv` in mdeical_image_segmentation_tpu/ops/quant.py) to XLA.
//
// Bit-exact with the plain version (int8_conv_reference in ops/quant.py):
// the quantization divides and rounds to nearest even (__fdiv_rn, rintf: no
// reciprocal multiply); the integer sum is exact in any order; the epilogue
// is __int2float_rn, __fmul_rn, __fadd_rn, each rounded on its own (nvcc
// would contract a*b+c into an FMA, whose single rounding differs).
//
// What bounds it on the H100.  At the UNets' widths a 3x3(x3) conv does
// 2 * taps * Ci ops per output element against a few bytes moved:
// operations bound, by the 1979 TOP/s dense int8 tensor-core rate.  This
// first version is far from it: the prologue quantizes each input element
// once per tap and per 64 output channels (a division each), and the mma
// waits on those ALU instructions.  Quantizing a halo once per stage for
// all taps (as conv_tc.cuh's halo loop reuses its tile), wgmma and TMA are
// for a later version.
//
// Design.  An implicit GEMM: M = output positions, N = Co, K = taps * Ci
// flattened as k = tap * Ci + ci, taps in (kd, kh, kw) order.  The weights
// come quantized and packed K-contiguous, (Co, Kp) int8 with Kp = K rounded
// up to 16 and zero-filled, because ldmatrix's .trans works on 16-bit
// elements only: the B fragment of mma.m16n8k32 (.col) is then a plain
// ldmatrix of [co][k] rows.  A block owns 128 positions x 64 channels, 8
// warps of 32 x 32; a stage is 64 int8 of K (two k32 steps).  The next
// stage's activations are loaded into registers before the current stage's
// mma and quantized into shared memory after it; the weights go by
// cp.async.  With Ci a multiple of 16 a thread loads 16 channels of one tap
// at once (vector loads); otherwise element by element.  Positions and taps
// outside the volume give 0, the quantized zero.

#include <type_traits>

#include "conv_tc.cuh"

namespace tpuseg_int8 {

using tpuseg_conv::cp_async16_cg;
using tpuseg_conv::cp_async_commit;
using tpuseg_conv::cp_async_wait;
using tpuseg_conv::ldmatrix_x4;
using tpuseg_conv::smem_u32;

constexpr int THREADS = 256;
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;            // int8 K values per stage
constexpr int ROW = BK + 16;      // smem row stride, an odd count of 16 B
constexpr int WARPS_M = 4;
constexpr int WM = BM / WARPS_M;  // 32 positions a warp
constexpr int WN = BN / (THREADS / 32 / WARPS_M);  // 32 channels a warp
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;
constexpr int A_BYTES = BM * ROW;
constexpr int STAGE_BYTES = A_BYTES + BN * ROW;
constexpr int VEC_CHUNKS = BM * BK / 16 / THREADS;  // 16-channel chunks
constexpr int ELEMS = BM * BK / THREADS;            // elements (no VEC)

struct Params {
  const void* x;       // (N, D, H, W, Ci) in TI
  const int8_t* w;     // (Co, Kp)
  const float* xs;     // x_scale, one float
  const float* cs;     // (Co,) x_scale * w_scale
  const float* bias;   // (Co,) or null
  void* y;             // (N, Do, Ho, Wo, Co) in TO
  int N, D, H, W, Ci, Co, Do, Ho, Wo;
  int KD, KH, KW, PD, PH, PW;
  int K, Kp, M;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t quant1(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Pos {
  int n, d, h, w;  // output position; n < 0 beyond M
};

__device__ __forceinline__ Pos position(const Params& p, int m) {
  Pos r;
  if (m >= p.M) {
    r.n = -1;
    r.d = r.h = r.w = 0;
    return r;
  }
  r.w = m % p.Wo;
  int t = m / p.Wo;
  r.h = t % p.Ho;
  t /= p.Ho;
  r.d = t % p.Do;
  r.n = t / p.Do;
  return r;
}

// The input offset of tap-flattened index k at output position r, or -1
// where it falls outside the volume (or r is beyond M, or k beyond K).
__device__ __forceinline__ int64_t source(const Params& p, const Pos& r,
                                          int k) {
  if (r.n < 0 || k >= p.K) return -1;
  const int tap = k / p.Ci;
  const int ci = k - tap * p.Ci;
  const int khw = p.KH * p.KW;
  const int kd = tap / khw;
  const int rem = tap - kd * khw;
  const int kh = rem / p.KW;
  const int kw = rem - kh * p.KW;
  const int d = r.d + kd - p.PD, h = r.h + kh - p.PH, w = r.w + kw - p.PW;
  if ((unsigned)d >= (unsigned)p.D || (unsigned)h >= (unsigned)p.H ||
      (unsigned)w >= (unsigned)p.W)
    return -1;
  return ((((int64_t)r.n * p.D + d) * p.H + h) * p.W + w) * p.Ci + ci;
}

template <typename TO>
__device__ __forceinline__ void store2(TO* yp, float v0, float v1, bool has1);
template <>
__device__ __forceinline__ void store2<float>(float* yp, float v0, float v1,
                                              bool has1) {
  yp[0] = v0;
  if (has1) yp[1] = v1;
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* yp,
                                                      float v0, float v1,
                                                      bool has1) {
  yp[0] = __float2bfloat16_rn(v0);
  if (has1) yp[1] = __float2bfloat16_rn(v1);
}

// One output pair (col, col + 1) of row `row`: the raw sums, or
// float(acc) * cs + bias rounded to TO, each op rounded on its own.
template <typename TO>
__device__ __forceinline__ void emit(const Params& p, int64_t row, int col,
                                     int a0, int a1) {
  const bool has1 = col + 1 < p.Co;
  TO* yp = static_cast<TO*>(p.y) + row * p.Co + col;
  if constexpr (std::is_same<TO, int>::value) {
    yp[0] = a0;
    if (has1) yp[1] = a1;
  } else {
    float v0 = __fmul_rn(__int2float_rn(a0), __ldg(p.cs + col));
    float v1 = has1 ? __fmul_rn(__int2float_rn(a1), __ldg(p.cs + col + 1))
                    : 0.f;
    if (p.bias != nullptr) {
      v0 = __fadd_rn(v0, __ldg(p.bias + col));
      if (has1) v1 = __fadd_rn(v1, __ldg(p.bias + col + 1));
    }
    store2<TO>(yp, v0, v1, has1);
  }
}

template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    int8_conv_kernel(const __grid_constant__ Params p, const int n_tiles) {
  __shared__ __align__(16) unsigned char smem[2 * STAGE_BYTES];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int KT = (p.Kp + BK - 1) / BK;
  const TI* __restrict__ x = static_cast<const TI*>(p.x);
  const float s = __ldg(p.xs);

  // A: VEC loads chunks tid + j * THREADS (row chunk / 4, 16-channel
  // column chunk % 4); else row tid % BM, columns tid / BM + 2 * e.
  constexpr int NROWS = VEC ? VEC_CHUNKS : 1;
  Pos rows[NROWS];
#pragma unroll
  for (int j = 0; j < NROWS; ++j)
    rows[j] = position(p, m0 + (VEC ? (tid + j * THREADS) / (BK / 16)
                                     : tid % BM));
  constexpr int NRAW = VEC ? VEC_CHUNKS * 16 : ELEMS;
  float raw[NRAW];

  auto fetch_a = [&](int it) {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < VEC_CHUNKS; ++j) {
        const int k = it * BK + ((tid + j * THREADS) % (BK / 16)) * 16;
        const int64_t off = source(p, rows[j], k);
        if (off < 0) {
#pragma unroll
          for (int e = 0; e < 16; ++e) raw[j * 16 + e] = 0.f;
        } else if constexpr (sizeof(TI) == 4) {
          const float4* src = reinterpret_cast<const float4*>(x + off);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = __ldg(src + q);
            raw[j * 16 + 4 * q] = v.x;
            raw[j * 16 + 4 * q + 1] = v.y;
            raw[j * 16 + 4 * q + 2] = v.z;
            raw[j * 16 + 4 * q + 3] = v.w;
          }
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(x + off);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint4 v = __ldg(src + q);
            const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
            for (int e = 0; e < 8; ++e) raw[j * 16 + 8 * q + e] = to_f(h[e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) {
        const int64_t off =
            source(p, rows[0], it * BK + tid / BM + e * (THREADS / BM));
        raw[e] = off < 0 ? 0.f : to_f(x[off]);
      }
    }
  };

  auto store_a = [&](int slot) {
    unsigned char* As = smem + slot * STAGE_BYTES;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < VEC_CHUNKS; ++j) {
        const int c = tid + j * THREADS;
        uint32_t wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = quant1(raw[j * 16 + 4 * q], s) |
                  (quant1(raw[j * 16 + 4 * q + 1], s) << 8) |
                  (quant1(raw[j * 16 + 4 * q + 2], s) << 16) |
                  (quant1(raw[j * 16 + 4 * q + 3], s) << 24);
        *reinterpret_cast<uint4*>(As + (c / (BK / 16)) * ROW +
                                  (c % (BK / 16)) * 16) =
            make_uint4(wv[0], wv[1], wv[2], wv[3]);
      }
    } else {
      const int row = tid % BM;
#pragma unroll
      for (int e = 0; e < ELEMS; ++e)
        As[row * ROW + tid / BM + e * (THREADS / BM)] =
            static_cast<unsigned char>(quant1(raw[e], s));
    }
  };

  // B: one 16-byte chunk of the (BN, BK) weight tile per thread
  auto load_b = [&](int slot, int it) {
    unsigned char* Bs = smem + slot * STAGE_BYTES + A_BYTES;
    const int row = tid / (BK / 16);
    const int kc = (tid % (BK / 16)) * 16;
    const int co = n0 + row;
    const int k = it * BK + kc;
    const bool ok = co < p.Co && k < p.Kp;
    cp_async16_cg(smem_u32(Bs + row * ROW + kc),
                  ok ? (const void*)(p.w + (int64_t)co * p.Kp + k)
                     : (const void*)p.w,
                  ok);
  };

  const int wm0 = (warp % WARPS_M) * WM;
  const int wn0 = (warp / WARPS_M) * WN;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // ldmatrix row addresses: A as (rows 0-7 | 8-15) x (bytes 0-15 | 16-31)
  // -> a0..a3; B as (co 0-7: bytes 0-15, 16-31 | co 8-15: ...) -> b0, b1 of
  // two n8 tiles
  const int a_lane =
      (wm0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW + (lane >> 4) * 16;
  const int b_lane =
      (wn0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ROW + ((lane >> 3) & 1) * 16;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  auto compute = [&](int slot) {
    const unsigned char* As = smem + slot * STAGE_BYTES;
    const unsigned char* Bs = As + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(Bs + b_lane + jj * 16 * ROW + ks * 32));
        bf[2 * jj][0] = r[0];
        bf[2 * jj][1] = r[1];
        bf[2 * jj + 1][0] = r[2];
        bf[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(As + a_lane + i * 16 * ROW + ks * 32));
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  };

  // ---- main loop: two slots, one barrier per stage ----
  fetch_a(0);
  load_b(0, 0);
  cp_async_commit();
  store_a(0);
  for (int it = 0; it < KT; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const bool next = it + 1 < KT;
    if (next) {
      fetch_a(it + 1);
      load_b((it + 1) & 1, it + 1);
    }
    cp_async_commit();
    compute(it & 1);
    if (next) store_a((it + 1) & 1);
  }

  // ---- epilogue ----
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn0 + j * 8 + 2 * t4;
    if (col >= p.Co) continue;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm0 + i * 16 + g + 8 * hh;
        if (row < p.M)
          emit<TO>(p, row, col, acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    }
  }
}

// ---- the halo kernel: 3x3 windows (KD in {1, 3}), Ci a multiple of 16 ----
//
// A block owns a TH x 16 patch of one output plane (n, d) x 64 output
// channels, as conv_tc.cuh's halo loop does.  A stage is one 32-channel
// chunk (one k32 step) of one depth tap: the (TH+2) x 18 input halo of that
// chunk, loaded into registers and quantized ONCE into shared memory, and
// that chunk's weights of all 9 (kh, kw) taps.  The 9 taps then read the
// halo through shifted ldmatrix row addresses, so each input element is
// quantized once per depth tap and 64 output channels instead of once per
// tap.  An s8 A fragment is 16 rows x 32 bytes, the byte layout of the bf16
// one, so the halo layout (48 bytes a pixel) and its ldmatrix addresses are
// the bf16 loop's.

constexpr int HB_STRIDE = 48;  // bytes between weight rows: 32 + 16

template <class HT>
struct HLay {
  static constexpr int A_BYTES = HT::HP * tpuseg_conv::H_PIX;
  static constexpr int STAGE = A_BYTES + 9 * HT::BN * HB_STRIDE;
  static constexpr int SMEM = 2 * STAGE;
  static constexpr int A_CHUNKS = HT::HP * 2;  // 16-channel halves
  static constexpr int AJ = (A_CHUNKS + THREADS - 1) / THREADS;
  static constexpr int B_CHUNKS = 9 * HT::BN * 2;
};

template <typename TI, typename TO, class HT>
__global__ void __launch_bounds__(THREADS, 2)
    int8_halo_kernel(const __grid_constant__ Params p, const int tiles_w,
                     const int tiles_h, const int n_tiles) {
  using L = HLay<HT>;
  constexpr int MT = HT::MT;
  constexpr int NT = HT::NT;
  constexpr int HWP = HT::HWP;
  constexpr int H_PIX = tpuseg_conv::H_PIX;
  extern __shared__ __align__(16) unsigned char hsmem[];

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
  const int kd_lo = max(0, p.PD - d);
  const int kd_hi = min(p.KD - 1, p.D - 1 - d + p.PD);
  const int cch = (p.Ci + 31) / 32;  // Ci = 16 mod 32: the last half is 0
  const int KT = (kd_hi - kd_lo + 1) * cch;
  const TI* __restrict__ x = static_cast<const TI*>(p.x);
  const float s = __ldg(p.xs);

  // the halo chunks this thread loads: in-plane element offset of pixel
  // (h, w) and 16-channel half, or -1 outside the plane (or past the halo)
  int a_off[L::AJ];
#pragma unroll
  for (int j = 0; j < L::AJ; ++j) {
    const int id = tid + j * THREADS;
    const int px = id >> 1;
    const int hr = px / HWP;
    const int h = h0 - 1 + hr;
    const int w = w0 - 1 + (px - hr * HWP);
    a_off[j] = (id < L::A_CHUNKS && (unsigned)h < (unsigned)p.H &&
                (unsigned)w < (unsigned)p.W)
                   ? (h * p.W + w) * p.Ci + (id & 1) * 16
                   : -1;
  }
  float raw[L::AJ * 16];

  auto fetch_a = [&](int it) {
    const int kd = kd_lo + it / cch;
    const TI* plane = x + (((int64_t)n * p.D + d + kd - p.PD) * p.H * p.W) *
                              p.Ci + (it % cch) * 32;
#pragma unroll
    for (int j = 0; j < L::AJ; ++j) {
      const int half = ((tid + j * THREADS) & 1) * 16;
      if (a_off[j] < 0 || (it % cch) * 32 + half >= p.Ci) {
#pragma unroll
        for (int e = 0; e < 16; ++e) raw[j * 16 + e] = 0.f;
      } else if constexpr (sizeof(TI) == 4) {
        const float4* src = reinterpret_cast<const float4*>(plane + a_off[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = __ldg(src + q);
          raw[j * 16 + 4 * q] = v.x;
          raw[j * 16 + 4 * q + 1] = v.y;
          raw[j * 16 + 4 * q + 2] = v.z;
          raw[j * 16 + 4 * q + 3] = v.w;
        }
      } else {
        const uint4* src = reinterpret_cast<const uint4*>(plane + a_off[j]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 v = __ldg(src + q);
          const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e) raw[j * 16 + 8 * q + e] = to_f(hv[e]);
        }
      }
    }
  };

  auto store_a = [&](int slot) {
    unsigned char* As = hsmem + slot * L::STAGE;
#pragma unroll
    for (int j = 0; j < L::AJ; ++j) {
      const int id = tid + j * THREADS;
      if (id >= L::A_CHUNKS) continue;
      uint32_t wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = quant1(raw[j * 16 + 4 * q], s) |
                (quant1(raw[j * 16 + 4 * q + 1], s) << 8) |
                (quant1(raw[j * 16 + 4 * q + 2], s) << 16) |
                (quant1(raw[j * 16 + 4 * q + 3], s) << 24);
      *reinterpret_cast<uint4*>(As + (id >> 1) * H_PIX + (id & 1) * 16) =
          make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
  };

  // the chunk's weights of the 9 (kh, kw) taps: row tap * BN + channel
  auto load_b = [&](int slot, int it) {
    unsigned char* Bs = hsmem + slot * L::STAGE + L::A_BYTES;
    const int kd = kd_lo + it / cch;
    const int ci0 = (it % cch) * 32;
    for (int id = tid; id < L::B_CHUNKS; id += THREADS) {
      const int r = id >> 1;
      const int tap = r / HT::BN;
      const int co = n0 + r - tap * HT::BN;
      const bool ok = co < p.Co && ci0 + (id & 1) * 16 < p.Ci;
      const int64_t k = (int64_t)(kd * 9 + tap) * p.Ci + ci0 + (id & 1) * 16;
      cp_async16_cg(smem_u32(Bs + r * HB_STRIDE + (id & 1) * 16),
                    ok ? (const void*)(p.w + (int64_t)co * p.Kp + k)
                       : (const void*)p.w,
                    ok);
    }
  };

  const int wrow0 = (warp % HT::WARPS_M) * MT;
  const int wn0 = (warp / HT::WARPS_M) * HT::WN;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int a_lane = (wrow0 * HWP + (lane & 7) + ((lane >> 3) & 1) * 8) *
                         H_PIX + (lane >> 4) * 16;
  const int b_lane = (wn0 + (lane & 7) + ((lane >> 4) & 1) * 8) * HB_STRIDE +
                     ((lane >> 3) & 1) * 16;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  auto compute = [&](int slot) {
    const unsigned char* As = hsmem + slot * L::STAGE;
    const unsigned char* Bs = As + L::A_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * HWP + tap % 3) * H_PIX;
      uint32_t bf[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(Bs + tap * HT::BN * HB_STRIDE + b_lane +
                                jj * 16 * HB_STRIDE));
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
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  };

  fetch_a(0);
  load_b(0, 0);
  cp_async_commit();
  store_a(0);
  for (int it = 0; it < KT; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const bool next = it + 1 < KT;
    if (next) {
      fetch_a(it + 1);
      load_b((it + 1) & 1, it + 1);
    }
    cp_async_commit();
    compute(it & 1);
    if (next) store_a((it + 1) & 1);
  }

  const int64_t plane_out = ((int64_t)n * p.D + d) * p.H;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn0 + j * 8 + 2 * t4;
    if (col >= p.Co) continue;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int h = h0 + wrow0 + i;
      if (h >= p.H) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int w = w0 + g + 8 * hh;
        if (w < p.W)
          emit<TO>(p, (plane_out + h) * p.W + w, col, acc[i][j][2 * hh],
                   acc[i][j][2 * hh + 1]);
      }
    }
  }
}

template <typename TI, typename TO, class HT>
cudaError_t launch_halo(const Params& p, cudaStream_t stream) {
  using L = HLay<HT>;
  auto kernel = int8_halo_kernel<TI, TO, HT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_w = (p.W + HT::TW - 1) / HT::TW;
  const int tiles_h = (p.H + HT::TH - 1) / HT::TH;
  const int n_tiles = (p.Co + HT::BN - 1) / HT::BN;
  const long long blocks = (long long)p.N * p.D * tiles_h * tiles_w * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, L::SMEM, stream>>>(p, tiles_w, tiles_h,
                                                         n_tiles);
  return cudaGetLastError();
}

// The halo loop for 3x3 windows (KD 1 or 3, 'same' padding) with Ci a
// multiple of 16 (16 mod 32 pads its last chunk with zeros) and x 16-byte
// aligned; the gather loop for the rest (1x1 convs, ragged Ci, other
// windows).
inline bool halo_shape(const Params& p, bool vec) {
  return vec && p.KH == 3 && p.KW == 3 && p.PH == 1 &&
         p.PW == 1 && (p.KD == 1 || p.KD == 3) && p.PD == (p.KD - 1) / 2 &&
         (long long)p.H * p.W * p.Ci <= 0x7fffffffLL;
}

template <typename TI, typename TO>
cudaError_t launch(const Params& p, bool vec, int sms, cudaStream_t stream) {
  if (halo_shape(p, vec)) {
    // 8 rows a block when that gives every SM two blocks, else 4
    const long long blocks8 = (long long)p.N * p.D * ((p.H + 7) / 8) *
                              ((p.W + 15) / 16) * ((p.Co + 63) / 64);
    if (blocks8 >= 2LL * sms)
      return launch_halo<TI, TO, tpuseg_conv::HTileM>(p, stream);
    return launch_halo<TI, TO, tpuseg_conv::HTileS>(p, stream);
  }
  const long long m_tiles = (p.M + BM - 1) / BM;
  const long long n_tiles = (p.Co + BN - 1) / BN;
  if (m_tiles * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(m_tiles * n_tiles);
  if (vec)
    int8_conv_kernel<TI, TO, true><<<blocks, THREADS, 0, stream>>>(
        p, (int)n_tiles);
  else
    int8_conv_kernel<TI, TO, false><<<blocks, THREADS, 0, stream>>>(
        p, (int)n_tiles);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_out(const Params& p, bool vec, int sms, int out_dtype,
                       cudaStream_t stream) {
  if (out_dtype == 0) return launch<TI, float>(p, vec, sms, stream);
  if (out_dtype == 1) return launch<TI, __nv_bfloat16>(p, vec, sms, stream);
  if (out_dtype == 2) return launch<TI, int>(p, vec, sms, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tpuseg_int8

// in_dtype: 0 = float32, 1 = bfloat16; out_dtype: 0 = float32,
// 1 = bfloat16, 2 = int32 (the raw sums).  Returns the CUDA error code of
// the launch (0 on success); the kernel does not synchronise.
extern "C" int tpuseg_int8_conv_forward(
    const void* x, const void* w, const void* xs, const void* cs,
    const void* bias, void* y, int N, int D, int H, int W, int Ci, int Co,
    int KD, int KH, int KW, int PD, int PH, int PW, int Kp, int in_dtype,
    int out_dtype, int device, void* stream) {
  using namespace tpuseg_int8;
  Params p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.xs = static_cast<const float*>(xs);
  p.cs = static_cast<const float*>(cs);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.N = N;
  p.D = D;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Co = Co;
  p.KD = KD;
  p.KH = KH;
  p.KW = KW;
  p.PD = PD;
  p.PH = PH;
  p.PW = PW;
  p.Do = D + 2 * PD - KD + 1;
  p.Ho = H + 2 * PH - KH + 1;
  p.Wo = W + 2 * PW - KW + 1;
  const long long K = (long long)KD * KH * KW * Ci;
  const long long M = (long long)N * p.Do * p.Ho * p.Wo;
  if (N <= 0 || Ci <= 0 || Co <= 0 || KD <= 0 || KH <= 0 || KW <= 0 ||
      PD < 0 || PH < 0 || PW < 0 || p.Do <= 0 || p.Ho <= 0 || p.Wo <= 0 ||
      K > Kp || Kp % 16 != 0 || M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.K = (int)K;
  p.Kp = Kp;
  p.M = (int)M;
  cudaError_t err = tpuseg_conv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  // 16 channels of one tap per vector load: Ci a multiple of 16, x on a
  // 16-byte boundary
  const bool vec = Ci % 16 == 0 && tpuseg_conv::aligned16(x);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    err = launch_out<float>(p, vec, sms, out_dtype, s);
  else if (in_dtype == 1)
    err = launch_out<__nv_bfloat16>(p, vec, sms, out_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
