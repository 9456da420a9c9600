// W8A8 quantized convolution for Hopper (sm_90a): the int8 post-training-
// quantization conv of the port's TorchConv, in two launches
//   int8_quantize:  x_q[m, ci] = clamp(rint(x[m, ci] / x_scale), -127, 127)
//   int8_conv:      acc[m, co] = sum_k x_q[m shifted by tap k, ci] * w_q[co, k]
//                   y[m, co]   = round_TO(float(acc) * cs[co] + bias?[co])
//                   cs[co]     = x_scale * w_scale[co]
// for a stride-1 convolution with a KD x KH x KW window and symmetric zero
// padding (PD, PH, PW), on NDHWC activations (2D is D = 1, KD = 1).  x is
// float32 or bfloat16; y is float32, bfloat16, or the raw int32 sums.
//
// No TPU kernel behind it: the JAX package leaves its int8 conv
// (`Int8Conv` in mdeical_image_segmentation_tpu/ops/quant.py) to XLA.
//
// Bit-exact with the plain version (int8_conv_reference in ops/quant.py):
// the quantization divides and rounds to nearest even (__fdiv_rn, rintf: no
// reciprocal multiply); the integer sum is exact in any order, so neither
// the tensor cores' order nor the tiling changes a bit; the epilogue is
// __int2float_rn, __fmul_rn, __fadd_rn, each rounded on its own (nvcc would
// contract a*b+c into an FMA, whose single rounding differs).
//
// What bounds it on the H100.  At the UNets' widths a 3x3(x3) conv does
// 2 * taps * Ci ops per output element against a few bytes moved: bound by
// the 1979 TOP/s dense int8 tensor-core rate, which only wgmma reaches.
// The first version (mma.sync from 8 warps, the quantization in its
// prologue) reached 6-13% of that bound: each input element was divided
// once per depth tap and per 64 output channels (up to 24 IEEE divisions
// at Co 512), and the mma waited on those ALU instructions.
//
// Design.
//   * int8_quantize, once per conv call: a streaming pass, x in, x_q out
//     (4 or 2 bytes read and 1 written per element, 8 elements a thread and
//     step).  It reads x_scale on the device, so nothing waits on the host.
//     It is the only division in this file: both conv loops read x_q.
//   * The halo loop (int8_conv_wgmma_kernel; 3x3 windows, KD 1 or 3, Ci a
//     multiple of 16) is warp-specialised and persistent: one block an SM
//     walks output tiles of TH x 16 positions of one plane (n, d) x BN
//     output channels (BN 32, 64 or 128 by Co; TH 4 to 32 by the
//     grid).  One producer thread keeps a ring of 2-4 stages full by TMA,
//     each stage one 32-channel chunk of one depth tap: the (TH+2) x 18 x
//     32-byte halo of x_q, a box of a 5-D tensor map (Ci, W, H, D, N) whose
//     out-of-bounds fill is zero, the quantized zero, so the padding, the
//     volume's edges and Ci = 16 mod 32 need no code; and the chunk's
//     weights of the 9 (kh, kw) taps, one box of a (taps, Co, Ci rounded up
//     to 32) layout with zero pad channels (pack_taps in ops/quant.py).
//     mbarriers carry a stage from producer to consumers (TMA's byte
//     count) and back; the ring runs on across tiles, so the next tile
//     loads while this one's epilogue stores.  One or two consumer
//     warpgroups (the producer's warpgroup hands them its registers by
//     setmaxnreg) each own 4 * MT output rows as MT m64 tiles, a warp MT
//     consecutive rows, and issue per stage 9 * MT wgmma.m64nBNk32.s32.s8.
//     s8: A from registers, loaded by ldmatrix from the halo rows shifted
//     by the tap, MT + 2 fragments serving the 3 * MT products of one
//     kernel column (the halo's reuse across taps and rows); B from shared
//     memory through a descriptor.  The products go in three groups, one a
//     kernel column, one group in flight while the next loads its
//     fragments.  Taller tiles read each weight byte for more products:
//     the weights, 9 * BN * 32 bytes a stage, are most of what the stage
//     moves.  Depth taps outside the volume are skipped whole.
//   * Swizzle.  Both tensor maps use TMA's 32-byte swizzle: a 32-byte row
//     (a pixel's 32 channels, a weight row's 32 k) keeps its two 16-byte
//     halves in place or swapped by bit 2 of the row index.  The wgmma
//     descriptor names that layout (B32), and the ldmatrix addresses XOR
//     the same bit: the 8 rows of an ldmatrix phase, 8 consecutive pixels,
//     fall on 8 distinct 16-byte bank groups for any shift of the tap.
//   * The gather loop (int8_conv_gather_kernel; 1x1 convs, ragged Ci, other
//     windows) keeps mma.sync.m16n8k32: an implicit GEMM over M = output
//     positions, N = Co, K = taps * Ci flattened as k = tap * Ci + ci, the
//     weights (Co, Kp) K-contiguous (pack in ops/quant.py; ldmatrix's
//     .trans works on 16-bit elements only).  With Ci a multiple of 16 it
//     copies x_q 16 bytes at a time by cp.async (zero-filled outside the
//     volume), else byte by byte.  A block owns 128 positions x 64
//     channels, or 128 x 8 when Co <= 8 (the heads' 1x1 conv to 1 channel).

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked up

#include <algorithm>

#include "conv_tc.cuh"

namespace tpuseg_int8 {

using tpuseg_conv::cp_async16_cg;
using tpuseg_conv::cp_async_commit;
using tpuseg_conv::cp_async_wait;
using tpuseg_conv::ldmatrix_x4;
using tpuseg_conv::smem_u32;
using tpuseg_conv::to_f;

// ---- the quantize pass ----------------------------------------------------

__device__ __forceinline__ uint32_t quant1(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ uint32_t quant4(const float* v, float s) {
  return quant1(v[0], s) | (quant1(v[1], s) << 8) | (quant1(v[2], s) << 16) |
         (quant1(v[3], s) << 24);
}

// vec: 8 elements a thread and step (x 16-byte and x_q 8-byte aligned),
// the tail and the unaligned case element by element; grid-stride.
template <typename TI>
__global__ void __launch_bounds__(256)
    int8_quantize_kernel(const TI* __restrict__ x, int8_t* __restrict__ q,
                         const float* __restrict__ xs, const long long n,
                         const int vec) {
  const float s = __ldg(xs);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long groups = vec ? n / 8 : 0;
  for (long long g = first; g < groups; g += stride) {
    float v[8];
    if constexpr (sizeof(TI) == 4) {
      const float4* src = reinterpret_cast<const float4*>(x) + 2 * g;
      const float4 a = __ldg(src), b = __ldg(src + 1);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + g);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = to_f(h[e]);
    }
    reinterpret_cast<uint2*>(q)[g] = make_uint2(quant4(v, s), quant4(v + 4, s));
  }
  for (long long i = groups * 8 + first; i < n; i += stride)
    q[i] = static_cast<int8_t>(quant1(to_f(x[i]), s));
}

// ---- shared by both conv loops --------------------------------------------

struct Params {
  const int8_t* x;     // x_q: (N, D, H, W, Ci)
  const int8_t* w;     // (Co, Kp): the gather loop's layout
  const float* xs;     // x_scale, one float
  const float* ws;     // (Co,) w_scale
  const float* bias;   // (Co,) or null
  void* y;             // (N, Do, Ho, Wo, Co) in `out`
  int N, D, H, W, Ci, Co, Do, Ho, Wo;
  int KD, KH, KW, PD, PH, PW;
  int K, Kp, M;
  int out;             // 0 float32, 1 bfloat16, 2 int32 (the raw sums)
};

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
// float(acc) * cs + bias rounded to the output type, each op rounded on its
// own.
__device__ __forceinline__ void emit(const Params& p, int64_t row, int col,
                                     int a0, int a1) {
  const bool has1 = col + 1 < p.Co;
  const int64_t at = row * p.Co + col;
  if (p.out == 2) {
    int* yp = static_cast<int*>(p.y) + at;
    yp[0] = a0;
    if (has1) yp[1] = a1;
    return;
  }
  const float xs = __ldg(p.xs);
  float v0 = __fmul_rn(__int2float_rn(a0), __fmul_rn(xs, __ldg(p.ws + col)));
  float v1 = has1 ? __fmul_rn(__int2float_rn(a1),
                              __fmul_rn(xs, __ldg(p.ws + col + 1)))
                  : 0.f;
  if (p.bias != nullptr) {
    v0 = __fadd_rn(v0, __ldg(p.bias + col));
    if (has1) v1 = __fadd_rn(v1, __ldg(p.bias + col + 1));
  }
  if (p.out == 0)
    store2<float>(static_cast<float*>(p.y) + at, v0, v1, has1);
  else
    store2<__nv_bfloat16>(static_cast<__nv_bfloat16*>(p.y) + at, v0, v1,
                          has1);
}

// ---- the gather loop: mma.sync on x_q -------------------------------------

constexpr int THREADS = 256;
constexpr int BM = 128;
constexpr int BK = 64;            // int8 K values per stage
constexpr int ROW = BK + 16;      // smem row stride, an odd count of 16 B
constexpr int VEC_CHUNKS = BM * BK / 16 / THREADS;  // 16-byte chunks
constexpr int ELEMS = BM * BK / THREADS;            // bytes (no VEC)

template <int BN_>
struct GTile {
  static constexpr int BN = BN_;
  static constexpr int WARPS_N = BN >= 64 ? 2 : 1;
  static constexpr int WARPS_M = THREADS / 32 / WARPS_N;
  static constexpr int WM = BM / WARPS_M;  // positions a warp
  static constexpr int WN = BN / WARPS_N;  // channels a warp
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int STAGE = A_BYTES + BN * ROW;
  static_assert(MT >= 1 && (NT == 1 || NT % 2 == 0), "bad warp tile");
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
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

// The x_q offset of tap-flattened index k at output position r, or -1
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

template <bool VEC, int BN>
__global__ void __launch_bounds__(THREADS, 2)
    int8_conv_gather_kernel(const __grid_constant__ Params p,
                            const int n_tiles) {
  using G = GTile<BN>;
  constexpr int MT = G::MT;
  constexpr int NT = G::NT;
  __shared__ __align__(16) unsigned char smem[2 * G::STAGE];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int KT = (p.Kp + BK - 1) / BK;
  const int8_t* __restrict__ x = p.x;

  // A: VEC copies chunks tid + j * THREADS (row chunk / 4, 16-byte column
  // chunk % 4); else row tid % BM, columns tid / BM + 2 * e.
  constexpr int NROWS = VEC ? VEC_CHUNKS : 1;
  Pos rows[NROWS];
#pragma unroll
  for (int j = 0; j < NROWS; ++j)
    rows[j] = position(p, m0 + (VEC ? (tid + j * THREADS) / (BK / 16)
                                     : tid % BM));
  constexpr int NRAW = VEC ? 1 : ELEMS;
  int8_t raw[NRAW];

  auto copy_a = [&](int slot, int it) {  // VEC
    unsigned char* As = smem + slot * G::STAGE;
#pragma unroll
    for (int j = 0; j < VEC_CHUNKS; ++j) {
      const int c = tid + j * THREADS;
      const int64_t off = source(p, rows[j], it * BK + (c % (BK / 16)) * 16);
      cp_async16_cg(smem_u32(As + (c / (BK / 16)) * ROW + (c % (BK / 16)) * 16),
                    off < 0 ? (const void*)x : (const void*)(x + off),
                    off >= 0);
    }
  };
  auto fetch_a = [&](int it) {  // !VEC
#pragma unroll
    for (int e = 0; e < NRAW; ++e) {
      const int64_t off =
          source(p, rows[0], it * BK + tid / BM + e * (THREADS / BM));
      raw[e] = off < 0 ? int8_t(0) : x[off];
    }
  };
  auto store_a = [&](int slot) {  // !VEC
    unsigned char* As = smem + slot * G::STAGE;
    const int row = tid % BM;
#pragma unroll
    for (int e = 0; e < NRAW; ++e)
      As[row * ROW + tid / BM + e * (THREADS / BM)] =
          static_cast<unsigned char>(raw[e]);
  };

  // B: 16-byte chunks of the (BN, BK) weight tile
  auto load_b = [&](int slot, int it) {
    unsigned char* Bs = smem + slot * G::STAGE + G::A_BYTES;
#pragma unroll
    for (int id = tid; id < BN * (BK / 16); id += THREADS) {
      const int row = id / (BK / 16);
      const int kc = (id % (BK / 16)) * 16;
      const int co = n0 + row;
      const int k = it * BK + kc;
      const bool ok = co < p.Co && k < p.Kp;
      cp_async16_cg(smem_u32(Bs + row * ROW + kc),
                    ok ? (const void*)(p.w + (int64_t)co * p.Kp + k)
                       : (const void*)p.w,
                    ok);
    }
  };

  const int wm0 = (warp % G::WARPS_M) * G::WM;
  const int wn0 = (warp / G::WARPS_M) * G::WN;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // ldmatrix row addresses: A as (rows 0-7 | 8-15) x (bytes 0-15 | 16-31)
  // -> a0..a3; B as (co 0-7: bytes 0-15, 16-31 | co 8-15: ...) -> b0, b1 of
  // two n8 tiles (one n8 tile, x2, when NT is 1)
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
    const unsigned char* As = smem + slot * G::STAGE;
    const unsigned char* Bs = As + G::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t bf[NT][2];
      if constexpr (NT == 1) {
        ldmatrix_x2(bf[0], smem_u32(Bs + b_lane + ks * 32));
      } else {
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4(r, smem_u32(Bs + b_lane + jj * 16 * ROW + ks * 32));
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
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
  if constexpr (VEC) {
    copy_a(0, 0);
  } else {
    fetch_a(0);
  }
  load_b(0, 0);
  cp_async_commit();
  if constexpr (!VEC) store_a(0);
  for (int it = 0; it < KT; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const bool next = it + 1 < KT;
    if (next) {
      if constexpr (VEC) {
        copy_a((it + 1) & 1, it + 1);
      } else {
        fetch_a(it + 1);
      }
      load_b((it + 1) & 1, it + 1);
    }
    cp_async_commit();
    compute(it & 1);
    if constexpr (!VEC) {
      if (next) store_a((it + 1) & 1);
    }
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
          emit(p, row, col, acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    }
  }
}

// ---- the halo loop: TMA and wgmma on x_q ----------------------------------

constexpr int HW = 18;          // halo pixels a row: 16 + 2
constexpr int CH = 32;          // channels (bytes) a stage
constexpr int SMEM_MAX = 232448;

// BN output channels; CW consumer warpgroups of MT m64 tiles each
template <int BN, int CW, int MT>
struct WTile {
  static constexpr int TH = 4 * CW * MT;  // output rows, MT a warp
  static constexpr int THREADS = 128 * (CW + 1);  // + the producer's
  static constexpr int HALO = (TH + 2) * HW * CH;
  static constexpr int HALO_ALLOC = (HALO + 1023) / 1024 * 1024;
  static constexpr int WBYTES = 9 * BN * CH;
  static constexpr int STAGE = HALO_ALLOC + WBYTES;
  static constexpr int STAGES =
      (SMEM_MAX - 1024 - 64) / STAGE < 4 ? (SMEM_MAX - 1024 - 64) / STAGE : 4;
  // 1024 for aligning the base, then the stages, then 2 mbarriers a stage
  static constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;
  static constexpr uint32_t TX = HALO + WBYTES;  // bytes TMA lands a stage
  static_assert(STAGES >= 2 && BN % 32 == 0 && BN <= 128, "bad tile");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Spin until the phase of parity `parity` has completed.  A stage never
// takes seconds: past ~2^35 cycles the kernel traps (an error the caller
// sees) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 35))
      __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A K-major operand in the 32-byte swizzle: rows of 32 bytes, 8-row groups
// 256 bytes apart (SBO), layout B32; LBO is unused for a swizzled K-major
// operand whose K (32 bytes) fits the swizzle width.
__device__ __forceinline__ uint64_t desc_b32(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma
// fence, commit or wait
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma.m64nNk32.s32.s8.s8, A (64 x 32 bytes) from registers in the
// mma.m16n8k32 A-fragment layout, one 16-row slice a warp; B (N x 32 bytes,
// K-major) by descriptor; d += A * B^T, d in the mma C-fragment layout
// repeated over N / 8 (d[4j..4j+3]: rows g, g + 8 of the warp's slice,
// columns 8j + 2 * (lane % 4) and + 1).  The register form of CUTLASS's
// SM90_64xNx32_S32S8S8_RS_TN.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// One output tile: TH rows x 16 columns of plane (n, d) x BN channels from
// n0, and its depth taps kd_lo..kd_hi (those inside the volume).
struct WTileAt {
  int n, d, h0, w0, n0, kd_lo, kd_hi;
};

template <int TH, int BN>
__device__ __forceinline__ WTileAt tile_at(const Params& p, int tile,
                                           int tiles_w, int tiles_h,
                                           int n_tiles) {
  WTileAt r;
  r.n0 = (tile % n_tiles) * BN;
  int t = tile / n_tiles;
  r.w0 = (t % tiles_w) * 16;
  t /= tiles_w;
  r.h0 = (t % tiles_h) * TH;
  t /= tiles_h;
  r.d = t % p.D;
  r.n = t / p.D;
  r.kd_lo = max(0, p.PD - r.d);
  r.kd_hi = min(p.KD - 1, p.D - 1 - r.d + p.PD);
  return r;
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; the ring runs on
// across tiles, so the producer loads the next tile while the consumers
// store this one.
template <int BN, int CW, int MT>
__global__ void __launch_bounds__(WTile<BN, CW, MT>::THREADS, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ Params p,
                           const int tiles_w, const int tiles_h,
                           const int n_tiles, const int tiles) {
  using L = WTile<BN, CW, MT>;
  extern __shared__ unsigned char wsmem[];
  // stage s: the halo at stage(s), the 9 taps' weights HALO_ALLOC past it;
  // the mbarriers after the stages (full[s], then empty[s])
  const uint32_t base = (smem_u32(wsmem) + 1023u) & ~1023u;
  const uint32_t bars = base + L::STAGES * L::STAGE;
  auto stage = [&](int s) { return base + (uint32_t)(s * L::STAGE); };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cch = (p.Ci + CH - 1) / CH;  // Ci = 16 mod 32: TMA fills zeros

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CW);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // With two consumer warpgroups the block has 384 threads, 168 registers
  // each at launch: the producer's warpgroup gives most of its own to the
  // consumers (accumulators and three A buffers).
  if (warp >= 4 * CW) {  // the producer's warpgroup: one thread works
    if constexpr (CW == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * CW && lane == 0) {
      int q = 0;  // stages issued so far, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const WTileAt r = tile_at<L::TH, BN>(p, tile, tiles_w, tiles_h,
                                             n_tiles);
        const int KT = (r.kd_hi - r.kd_lo + 1) * cch;
        for (int it = 0; it < KT; ++it, ++q) {
          const int s = q % L::STAGES;
          if (q >= L::STAGES) mbar_wait(empty(s), ((q / L::STAGES) - 1) & 1);
          mbar_expect_tx(full(s), L::TX);
          const int kd = r.kd_lo + it / cch;
          const int c0 = (it % cch) * CH;
          tma_load_5d(stage(s), &xmap, full(s), c0, r.w0 - 1, r.h0 - 1,
                      r.d + kd - p.PD, r.n);
          tma_load_3d(stage(s) + L::HALO_ALLOC, &wmap, full(s), c0, r.n0,
                      kd * 9);
        }
      }
    }
    return;
  }

  if constexpr (CW == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumers: warpgroup k owns output rows 4 * MT * k .. + 4 * MT - 1 of
  // the tile as MT m64 tiles; warp w holds MT consecutive rows r0 + i, r0
  // = 4 * MT * (w / 4) + MT * (w % 4) (columns w0 .. w0 + 15), row r0 + i
  // as the 16-row slice (w % 4) of m64 tile i.  ldmatrix: lane l addresses
  // row (l & 7) + 8 * ((l >> 3) & 1) of a slice (an output column) and
  // 16-byte half l >> 4.
  const int r0 = 4 * MT * (warp / 4) + MT * (warp % 4);
  const int lcol = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // A stage runs as three groups of wgmma, one a kernel column kw.  Its A
  // fragments are the halo rows r0 .. r0 + MT + 1 shifted by kw, MT + 2
  // ldmatrix that serve all 3 * MT products of the group (row r0 + i, tap
  // (kh, kw) reads halo row r0 + i + kh), kept in buffer a[kw].  One group
  // stays in flight while the next one's fragments load, so the tensor
  // cores do not drain between groups; buffer kw is written again three
  // groups later, when wait_group 1 has retired its readers.
  uint32_t a[3][MT + 2][4];
  int q = 0;  // stages consumed so far, over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const WTileAt r = tile_at<L::TH, BN>(p, tile, tiles_w, tiles_h, n_tiles);
    const int KT = (r.kd_hi - r.kd_lo + 1) * cch;
    int acc[MT][BN / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0;
    for (int it = 0; it < KT; ++it, ++q) {
      const int s = q % L::STAGES;
      mbar_wait(full(s), (q / L::STAGES) & 1);
      const uint32_t halo = stage(s);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int j = 0; j < MT + 2; ++j) {
          const int px = (r0 + j) * HW + lcol + kw;
          ldmatrix_x4(a[kw][j],
                      halo + px * CH + ((lhalf ^ ((px >> 2) & 1)) << 4));
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            wgmma_s8<BN>(acc[i], a[kw][i + kh],
                         desc_b32(halo + L::HALO_ALLOC +
                                  (kh * 3 + kw) * BN * CH));
        wgmma_commit();
        wgmma_wait<1>();  // the group before this one has retired
#pragma unroll
        for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
#pragma unroll
        for (int j = 0; j < MT + 2; ++j) fence_regs(a[(kw + 2) % 3][j]);
        // the previous stage's last group has retired: release its slot
        if (kw == 0 && it > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty((q - 1) % L::STAGES));
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int j = 0; j < MT + 2; ++j) fence_regs(a[kw][j]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty((q - 1) % L::STAGES));

#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int h = r.h0 + r0 + i;
      if (h >= p.H) continue;
      const int64_t row0 = (((int64_t)r.n * p.D + r.d) * p.H + h) * p.W;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = r.n0 + j * 8 + 2 * t4;
        if (col >= p.Co) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int w = r.w0 + g + 8 * hh;
          if (w < p.W)
            emit(p, row0 + w, col, acc[i][4 * j + 2 * hh],
                 acc[i][4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: looked up once through the
// runtime, so the library links no libcuda.
inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || f == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// int8 tensor maps in the 32-byte swizzle, zeros outside the tensor; a map
// that cannot be encoded returns cudaErrorNotSupported.
inline cudaError_t encode(CUtensorMap* map, const void* ptr, int rank,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box) {
  EncodeTiled fn;
  cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorNotSupported;
}

template <int BN, int CW, int MT>
cudaError_t launch_wgmma(const Params& p, const int8_t* taps, int cip,
                         int sms, int device, cudaStream_t stream) {
  using L = WTile<BN, CW, MT>;
  CUtensorMap xmap, wmap;
  const cuuint64_t ci = p.Ci;
  const cuuint64_t xdims[5] = {ci, (cuuint64_t)p.W, (cuuint64_t)p.H,
                               (cuuint64_t)p.D, (cuuint64_t)p.N};
  const cuuint64_t xstrides[4] = {ci, ci * p.W, ci * p.W * p.H,
                                  ci * p.W * p.H * p.D};
  const cuuint32_t xbox[5] = {CH, HW, L::TH + 2, 1, 1};
  cudaError_t err = encode(&xmap, p.x, 5, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)cip, (cuuint64_t)p.Co,
                               (cuuint64_t)p.KD * 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)cip,
                                  (cuuint64_t)cip * p.Co};
  const cuuint32_t wbox[3] = {CH, BN, 9};
  err = encode(&wmap, taps, 3, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  auto kernel = int8_conv_wgmma_kernel<BN, CW, MT>;
  // once a device and instantiation (host calls cost where kernels are
  // short)
  static unsigned long long set_on = 0;
  if (device >= 64 || !((set_on >> device) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    if (device < 64) set_on |= 1ull << device;
  }
  const int tiles_w = (p.W + 15) / 16;
  const int tiles_h = (p.H + L::TH - 1) / L::TH;
  const int n_tiles = (p.Co + BN - 1) / BN;
  const long long tiles = (long long)p.N * p.D * tiles_h * tiles_w * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // as many blocks as the card holds at once, none idle
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        L::THREADS, L::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const long long blocks = std::min<long long>(tiles, (long long)per_sm * sms);
  kernel<<<(unsigned)blocks, L::THREADS, L::SMEM, stream>>>(
      xmap, wmap, p, tiles_w, tiles_h, n_tiles, (int)tiles);
  return cudaGetLastError();
}

// The halo loop for 3x3 windows (KD 1 or 3, 'same' padding) with Ci a
// multiple of 16 (TMA's global strides are multiples of 16 bytes) and the
// per-tap weights; the gather loop for the rest.
inline bool halo_shape(const Params& p, const int8_t* taps, int cip) {
  return taps != nullptr && p.Ci % 16 == 0 && cip % CH == 0 && cip >= p.Ci &&
         p.KH == 3 && p.KW == 3 && p.PH == 1 && p.PW == 1 &&
         (p.KD == 1 || p.KD == 3) && p.PD == (p.KD - 1) / 2 &&
         tpuseg_conv::aligned16(p.x) && tpuseg_conv::aligned16(taps);
}

cudaError_t launch(const Params& p, const int8_t* taps, int cip, int sms,
                   int device, cudaStream_t stream) {
  if (halo_shape(p, taps, cip)) {
    // BN: the least of 32, 64, 128 that holds Co, or 64 where 128 would
    // not give every SM two 8-row tiles.  (Measured on the H100: at Co 256
    // two 128-channel tiles of 16 rows beat one 256-channel tile of 8
    // rows, whose accumulators leave no registers for a second m64 tile.)
    // Then the most rows a tile whose grid still fills the card, since
    // taller tiles read each weight byte for more products: 32 (four m64
    // tiles a warpgroup; BN <= 64, every SM two tiles), 16 (two), 8 (one),
    // else 4 (one consumer warpgroup).
    auto tiles = [&](int th, int bn) {
      return (long long)p.N * p.D * ((p.H + th - 1) / th) * ((p.W + 15) / 16) *
             ((p.Co + bn - 1) / bn);
    };
    int bn = p.Co <= 32 ? 32 : p.Co <= 64 ? 64 : 128;
    if (bn == 128 && tiles(8, bn) < 2LL * sms) bn = 64;
    const int mt = bn <= 64 && tiles(32, bn) >= 2LL * sms ? 4
                   : tiles(16, bn) >= sms                 ? 2
                   : tiles(8, bn) >= sms                  ? 1
                                                          : 0;
    cudaError_t (*go)(const Params&, const int8_t*, int, int, int,
                      cudaStream_t);
    switch (bn * 8 + mt) {
      case 32 * 8 + 4: go = launch_wgmma<32, 2, 4>; break;
      case 32 * 8 + 2: go = launch_wgmma<32, 2, 2>; break;
      case 32 * 8 + 1: go = launch_wgmma<32, 2, 1>; break;
      case 32 * 8: go = launch_wgmma<32, 1, 1>; break;
      case 64 * 8 + 4: go = launch_wgmma<64, 2, 4>; break;
      case 64 * 8 + 2: go = launch_wgmma<64, 2, 2>; break;
      case 64 * 8 + 1: go = launch_wgmma<64, 2, 1>; break;
      case 64 * 8: go = launch_wgmma<64, 1, 1>; break;
      case 128 * 8 + 2: go = launch_wgmma<128, 2, 2>; break;
      case 128 * 8 + 1: go = launch_wgmma<128, 2, 1>; break;
      default: go = launch_wgmma<128, 1, 1>;
    }
    return go(p, taps, cip, sms, device, stream);
  }
  // the gather loop: 16-byte copies of x_q when Ci is a multiple of 16;
  // an 8-channel tile for Co <= 8
  const bool vec = p.Ci % 16 == 0 && tpuseg_conv::aligned16(p.x);
  const int bn = p.Co <= 8 ? 8 : 64;
  const long long m_tiles = (p.M + BM - 1) / BM;
  const long long n_tiles = (p.Co + bn - 1) / bn;
  if (m_tiles * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(m_tiles * n_tiles);
  if (vec && bn == 8)
    int8_conv_gather_kernel<true, 8><<<blocks, THREADS, 0, stream>>>(
        p, (int)n_tiles);
  else if (vec)
    int8_conv_gather_kernel<true, 64><<<blocks, THREADS, 0, stream>>>(
        p, (int)n_tiles);
  else if (bn == 8)
    int8_conv_gather_kernel<false, 8><<<blocks, THREADS, 0, stream>>>(
        p, (int)n_tiles);
  else
    int8_conv_gather_kernel<false, 64><<<blocks, THREADS, 0, stream>>>(
        p, (int)n_tiles);
  return cudaGetLastError();
}

// The SM count of `device`, asked of the runtime once a device.
inline cudaError_t sm_count(int device, int* sms) {
  static int known[64] = {};
  if (device >= 0 && device < 64 && known[device] > 0) {
    *sms = known[device];
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < 64) known[device] = *sms;
  return err;
}

}  // namespace tpuseg_int8

// x (float32 if in_dtype is 0, bfloat16 if 1) -> x_q int8, n elements.
// Returns the CUDA error code of the launch (0 on success); does not
// synchronise.
extern "C" int tpuseg_int8_quantize(const void* x, void* x_q, const void* xs,
                                    long long n, int in_dtype, int device,
                                    void* stream) {
  using namespace tpuseg_int8;
  if (n <= 0 || (in_dtype != 0 && in_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = tpuseg_conv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;
  const bool vec = tpuseg_conv::aligned16(x) &&
                   (reinterpret_cast<uintptr_t>(x_q) & 7) == 0;
  const long long work = vec ? (n + 7) / 8 : n;
  const long long blocks = std::min<long long>((work + 255) / 256, 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(x_q);
  const float* scale = static_cast<const float*>(xs);
  if (in_dtype == 0)
    int8_quantize_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float*>(x), q, scale, n, vec);
  else
    int8_quantize_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), q, scale, n, vec);
  return (int)cudaGetLastError();
}

// x_q int8 (N, D, H, W, Ci); w (Co, Kp) int8, the gather layout; taps
// (KD * KH * KW, Co, Cip) int8, the halo layout, or null; xs the one float
// x_scale and ws the (Co,) float w_scale, on the card; out_dtype: 0 =
// float32, 1 = bfloat16, 2 = int32 (the raw sums).  Returns the CUDA error
// code of the launch (0 on success); the kernel does not synchronise.
extern "C" int tpuseg_int8_conv_forward(
    const void* x_q, const void* w, const void* taps, const void* xs,
    const void* ws, const void* bias, void* y, int N, int D, int H, int W,
    int Ci, int Co,
    int KD, int KH, int KW, int PD, int PH, int PW, int Kp, int Cip,
    int out_dtype, int device, void* stream) {
  using namespace tpuseg_int8;
  Params p{};
  p.x = static_cast<const int8_t*>(x_q);
  p.w = static_cast<const int8_t*>(w);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
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
  p.out = out_dtype;
  const long long K = (long long)KD * KH * KW * Ci;
  const long long M = (long long)N * p.Do * p.Ho * p.Wo;
  if (N <= 0 || Ci <= 0 || Co <= 0 || KD <= 0 || KH <= 0 || KW <= 0 ||
      PD < 0 || PH < 0 || PW < 0 || p.Do <= 0 || p.Ho <= 0 || p.Wo <= 0 ||
      K > Kp || Kp % 16 != 0 || M > 0x7fffffffLL || out_dtype < 0 ||
      out_dtype > 2)
    return (int)cudaErrorInvalidValue;
  p.K = (int)K;
  p.Kp = Kp;
  p.M = (int)M;
  cudaError_t err = tpuseg_conv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(p, static_cast<const int8_t*>(taps), Cip, sms, device,
                     static_cast<cudaStream_t>(stream));
}
