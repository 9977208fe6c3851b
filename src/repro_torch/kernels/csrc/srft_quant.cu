// Fused rotate + lambda + per-group absmax + int4/int8 pack for Hopper
// (sm_90a), and its inverse.
//
// B3 replaces the TPU kernel srft_quant_fwd / _quant_kernel in
// src/repro/kernels/srft_quant/srft_quant.py.  Computes, for N rows of d:
//     y      = x @ M^T            (M the d x d rotation, fp32 FMAs)
//     y      = y * lam            (optional epilogue; lam == nullptr skips it)
//     scale  = max(absmax_group(y), 1e-12) / qmax
//     codes  = clip(rint(y / scale), -qmax, qmax)
//     out    = nibble pack (odd << 4) | (even & 0xF)   (bits 4) or int8 (bits 8)
// With M == nullptr the rotation is skipped (y = x): the residual-window
// flush and the batch ring quantize values that are already rotated.
//
// B4 replaces srft_dequant_fwd / _dequant_kernel in the same file:
//     y      = codes * scale[group]   (int4 low nibble = even index,
//                                      sign-extended at >= 8; or int8)
//     x      = y @ Minv^T             (Minv the folded inverse, fp32 FMAs)
//
// What bounds each on this card, and what the design does about it:
//
// * B3 without a matrix (quant_rows_kernel).  A W-flush or a batch ring is
//   128-512 rows: 76-300 KB, a fraction of a microsecond of HBM time, so
//   the launch and one dependent chain of load -> reduce -> divide -> store
//   bound it.  There is no shared memory: a lane loads 16 bytes (four fp32
//   values, or four bf16 in 8 bytes), a group's lanes are consecutive and
//   aligned (8 lanes for group 32; at d = 128 a warp holds a row) and take
//   the absmax by xor shuffles, each lane divides its own four values by
//   the scale, rounds half to even, packs four codes into one 16-bit word
//   (int4) or 32-bit word (int8) and stores it; the group's first lane
//   stores the scale.  Groups that are not 4 to 128 in a power of two take
//   quant_units_kernel: one aligned set of lanes per (row, group), two
//   values a lane, also without shared memory.
//
// * B3 and B4 with a matrix (srft_tile_kernel).  The d x d fp32 product is
//   2d FLOP per value: 64 FLOP per input byte at d = 128, above the H100's
//   fp32 (non-tensor-core) ridge of 67 TFLOP/s / 3.35 TB/s = 20, so fp32
//   operations bound it.  TF32 would flip codes at .5 boundaries, so the
//   product stays on the fp32 FMA pipes.  Register tiling: a block of 4
//   warps holds a TR-row tile (32 rows at d = 128); a thread owns 4 rows x
//   8 consecutive columns, so the 16 lanes of a row set span a row and a
//   group of 32 columns is 4 consecutive lanes.  Per 4 k a thread loads
//   M[e, k..k+3] for its 8 columns and x[r, k..k+3] for its 4 rows (12
//   16-byte shared loads, the x loads broadcast) and does 128 FMAs, 10.7 a
//   load against 3.6 in the first version.  Staging: the x tile (fp32,
//   rows padded to d + 4 words; bf16 widened in registers, every load
//   issued before the first store) is copied once; M streams through a
//   double buffer of 32-k chunks by 16-byte cp.async, the next chunk in
//   flight while this one is consumed (d = 256's 256 KB matrix does not
//   fit whole).  Both are row-major, as in device memory.  A thread reads
//   M rows 8c..8c+7 at one k offset, so padding cannot spread a
//   quarter-warp's 16-byte reads over the banks; the chunk's 16-byte slots
//   are XOR-swizzled by (row / 8) % 8 instead, which makes them
//   conflict-free.  Each output sums in k order with fmaf, as cuBLAS's
//   fp32 GEMM does at large row counts.  Epilogues stay in registers: B3
//   applies lambda and the group quantize above to the accumulators, B4
//   stores float4s; B4's prologue dequantizes the codes once into the x
//   tile.  Measured on the card (PERF.md section 6), the loop runs at
//   about half the fp32 peak, as cuBLAS's fp32 product does at this
//   shape; it is bound neither by shared-memory traffic nor by load
//   latency (cutting the loads, or pipelining them, gains 0-3 us of 43),
//   and larger thread tiles (8 x 8, 16 x 8) or a resident, persistent M
//   measured no faster for B3.  32-row tiles give the shortest batch
//   prompt's write (4,096 rows) 128 blocks for the 132 SMs.  Other shapes
//   (d not in {64, 128, 256}, or a group not a power of two from 8) take
//   the same loop's generic instantiation: scalar staging with zero
//   padding to a multiple of 8, and for B3 an epilogue through shared
//   memory in quant_units' lane layout.
//
// Codes: one correctly rounded reciprocal a group, then each quotient from
// it by Markstein's correction step, which gives the bits of an IEEE
// division; __float2int_rn rounds half to even, as rintf.
// Build without --use_fast_math: the scale needs an IEEE division, the
// codes correctly rounded reciprocals and products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsThreads = 256;  // the no-matrix kernels' block
constexpr int kWarps = 4;          // the product's block
constexpr int kRT = 4;             // rows a thread owns in the product
constexpr int kChunk = 32;         // k per streamed chunk of M (8 slots)
constexpr int kMaxD = 256;

enum Mode { kQuant, kDequant };

// ----------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// bf16 -> fp32 is exact: the bf16 bits are the fp32's upper half
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if (kBf16) {
    const uint16_t b = reinterpret_cast<const uint16_t*>(x)[i];
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  return reinterpret_cast<const float*>(x)[i];
}

// ------------------------------------------------------ group quantize

// absmax over the gl consecutive lanes of a group (gl a power of two, the
// group's lanes aligned to gl); every lane of the warp must call it
__device__ __forceinline__ float group_absmax(float a, int gl) {
  for (int o = 1; o < gl; o <<= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// rint(v / scale) clipped to +-qmax.  inv is __frcp_rn(scale), taken once
// a group: with a correctly rounded reciprocal, q0 = v * inv and one
// correction step give the correctly rounded quotient (Markstein), the
// bits of an IEEE division; __float2int_rn rounds half to even, as rintf.
__device__ __forceinline__ int code_of(float v, float scale, float inv,
                                       int qmax) {
  const float q0 = __fmul_rn(v, inv);
  const float q = fmaf(fmaf(-scale, q0, v), inv, q0);
  return min(max(__float2int_rn(q), -qmax), qmax);
}

// four consecutive values of one group, flat element index e (a multiple
// of 4): one 16-bit word of two nibble-packed bytes, or four int8 bytes
__device__ __forceinline__ void store_codes4(uint8_t* out, size_t e,
                                             const float v[4], float scale,
                                             int bits) {
  const int qmax = bits == 4 ? 7 : 127;
  const float inv = __frcp_rn(scale);
  const int q0 = code_of(v[0], scale, inv, qmax);
  const int q1 = code_of(v[1], scale, inv, qmax);
  const int q2 = code_of(v[2], scale, inv, qmax);
  const int q3 = code_of(v[3], scale, inv, qmax);
  if (bits == 4) {
    const uint32_t w = (q0 & 0xF) | ((q1 & 0xF) << 4) | ((q2 & 0xF) << 8) |
                       ((q3 & 0xF) << 12);
    *reinterpret_cast<uint16_t*>(out + e / 2) = static_cast<uint16_t>(w);
  } else {
    const uint32_t w = (q0 & 0xFF) | ((q1 & 0xFF) << 8) |
                       ((q2 & 0xFF) << 16) |
                       (static_cast<uint32_t>(q3 & 0xFF) << 24);
    *reinterpret_cast<uint32_t*>(out + e) = w;
  }
}

// ---------------------------------------------------- B3, no matrix

// One lane per four values of the flat (n * d) array: groups (of 4 * gl
// values, gl a power of two <= 32) never straddle rows, and their lanes
// are consecutive and aligned.
template <bool kBf16>
__global__ void __launch_bounds__(kRowsThreads)
quant_rows_kernel(const void* __restrict__ x, const float* __restrict__ lam,
                  uint8_t* __restrict__ out, float* __restrict__ scales,
                  size_t quads, int d, int gl, int bits) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kRowsThreads +
                   threadIdx.x;
  const int lg = __ffs(gl) - 1;  // gl = 2^lg lanes a group
  const bool live = t < quads;  // a group's lanes are all live or all not
  const size_t q = live ? t : 0;
  float v[4];
  if (kBf16) {
    const uint2 w = reinterpret_cast<const uint2*>(x)[q];
    v[0] = bf16_lo(w.x); v[1] = bf16_hi(w.x);
    v[2] = bf16_lo(w.y); v[3] = bf16_hi(w.y);
  } else {
    const float4 w = reinterpret_cast<const float4*>(x)[q];
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
  if (lam != nullptr) {
    const float4 l = reinterpret_cast<const float4*>(lam)[q % (d / 4)];
    v[0] *= l.x; v[1] *= l.y; v[2] *= l.z; v[3] *= l.w;
  }
  float a = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                  fmaxf(fabsf(v[2]), fabsf(v[3])));
  a = group_absmax(a, gl);
  const float scale = fmaxf(a, 1e-12f) / (bits == 4 ? 7.0f : 127.0f);
  if (live) {
    store_codes4(out, 4 * q, v, scale, bits);
    if ((t & (gl - 1)) == 0) scales[t >> lg] = scale;
  }
}

// The generic layout: one aligned set of L lanes (a power of two <= 32)
// per (row, group) unit, lane i holding the pairs i, i + L, ... of the
// group (at most 4 a lane: group <= 256).  Consecutive lanes read
// consecutive pairs, so a unit's reads are conflict-free from shared
// memory and coalesced from device memory.  Pairs keep int4 bytes whole.
// src(r, c) returns the values at columns c, c + 1 of tile row r.
template <class Src>
__device__ __forceinline__ void quant_units(const Src& src, int rows,
                                            size_t row0, int d, int group,
                                            int bits, uint8_t* out,
                                            float* scales, int unit0,
                                            int stride) {
  const int lane = threadIdx.x & 31;
  const int pairs = group / 2;
  int L = 1;
  while (L < 32 && L < pairs) L <<= 1;
  const int per_lane = (pairs + L - 1) / L;
  const int li = lane % L;
  const int ng = d / group;
  const int qmax = bits == 4 ? 7 : 127;
  // unit0, stride: this warp's first unit and its step, multiples of 32/L
  for (int u0 = unit0; u0 < rows * ng; u0 += stride) {
    const int u = u0 + lane / L;
    const bool live = u < rows * ng;
    const int r = live ? u / ng : 0, gi = live ? u % ng : 0;
    float2 v[4];
    float a = 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int pi = li + L * p;
      v[p] = make_float2(0.0f, 0.0f);
      if (p < per_lane && pi < pairs) v[p] = src(r, gi * group + 2 * pi);
      a = fmaxf(a, fmaxf(fabsf(v[p].x), fabsf(v[p].y)));
    }
    a = group_absmax(a, L);
    const float scale = fmaxf(a, 1e-12f) / (bits == 4 ? 7.0f : 127.0f);
    const float inv = __frcp_rn(scale);
    if (!live) continue;
    const size_t row = row0 + r;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int pi = li + L * p;
      if (p >= per_lane || pi >= pairs) continue;
      const int c = gi * group + 2 * pi;
      const int q0 = code_of(v[p].x, scale, inv, qmax);
      const int q1 = code_of(v[p].y, scale, inv, qmax);
      if (bits == 4) {
        out[row * (d / 2) + c / 2] =
            static_cast<uint8_t>(((q1 & 0xF) << 4) | (q0 & 0xF));
      } else {
        out[row * d + c] = static_cast<uint8_t>(q0 & 0xFF);
        out[row * d + c + 1] = static_cast<uint8_t>(q1 & 0xFF);
      }
    }
    if (li == 0) scales[row * ng + gi] = scale;
  }
}

template <bool kBf16>
struct GlobalRows {  // x (n, d) in device memory, lambda applied
  const void* x;
  const float* lam;
  int d;
  __device__ float2 operator()(int r, int c) const {
    const size_t i = static_cast<size_t>(r) * d + c;
    float2 v = make_float2(load_x<kBf16>(x, i), load_x<kBf16>(x, i + 1));
    if (lam != nullptr) {
      v.x *= lam[c];
      v.y *= lam[c + 1];
    }
    return v;
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(kRowsThreads)
quant_units_kernel(const void* __restrict__ x, const float* __restrict__ lam,
                   uint8_t* __restrict__ out, float* __restrict__ scales,
                   int n, int d, int group, int bits) {
  int L = 1;
  while (L < 32 && L < group / 2) L <<= 1;
  const int per_warp = 32 / L;
  const int warp = blockIdx.x * (kRowsThreads / 32) + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * (kRowsThreads / 32);
  quant_units(GlobalRows<kBf16>{x, lam, d}, n, 0, d, group, bits, out,
              scales, warp * per_warp, n_warps * per_warp);
}

// ------------------------------------------------ the product (B3, B4)

// Tile geometry for d = D (D = 0: any d <= 256, known at run time).  A
// block is kWarps warps; a thread owns kRT rows x 8 consecutive columns,
// and the LR lanes of a row set cover a row's columns.
template <int D>
struct Tile {
  static constexpr int LR = D == 0 ? 32 : D / 8;
  static constexpr int RS = 32 / LR;           // row sets per warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowSets = kWarps * RS;
  static constexpr int TR = kRowSets * kRT;    // rows per block
};

__host__ __device__ constexpr int pad8(int d) { return (d + 7) / 8 * 8; }

struct SmemRows {  // the B3 generic epilogue's y tile in shared memory
  const float* ys;
  int ld;
  __device__ float2 operator()(int r, int c) const {
    return *reinterpret_cast<const float2*>(ys + r * ld + c);
  }
};

// Chunk of M (rows e < dp, k in [k0, k0 + kc)) into dst[e][kChunk], with
// 16-byte slot s of row e stored at slot s ^ ((e / 8) % 8): a thread reads
// rows 8c..8c+7, so the 8 lanes of a quarter-warp read 8 distinct slots.
template <int D, int NT>
__device__ __forceinline__ void stage_m(float* dst, const float* m, int d,
                                        int k0, int kc) {
  if constexpr (D != 0) {
    constexpr int slots = kChunk / 4;
    for (int i = threadIdx.x; i < D * slots; i += NT) {
      const int e = i / slots, s = i % slots;
      cp_async16(dst + e * kChunk + 4 * (s ^ ((e >> 3) & 7)),
                 m + static_cast<size_t>(e) * D + k0 + 4 * s, true);
    }
  } else {
    const int dp = pad8(d);
    for (int i = threadIdx.x; i < dp * kc; i += NT) {
      const int e = i / kc, k = i % kc;
      dst[e * kChunk + 4 * ((k >> 2) ^ ((e >> 3) & 7)) + (k & 3)] =
          (e < d && k0 + k < d) ? m[static_cast<size_t>(e) * d + k0 + k]
                                : 0.0f;
    }
  }
}

// x rows [row0, row0 + TR) into xs[r][ld], fp32, zero past n and past d.
// bf16 goes through registers: every load is issued before the first
// conversion, so a thread waits for device memory once.
template <class T, int D, bool kBf16>
__device__ __forceinline__ void stage_x(float* xs, int ld, const void* x,
                                        int n, int d, size_t row0) {
  if constexpr (D != 0 && !kBf16) {
    constexpr int q = D / 4;
    for (int i = threadIdx.x; i < T::TR * q; i += T::kThreads) {
      const int r = i / q, s = i % q;
      const bool ok = row0 + r < static_cast<size_t>(n);
      const float* src = reinterpret_cast<const float*>(x) +
                         (ok ? (row0 + r) * D + 4 * s : 0);
      cp_async16(xs + r * ld + 4 * s, src, ok);
    }
  } else if constexpr (D != 0) {
    constexpr int o = D / 8;  // 16-byte pieces of 8 bf16 a row
    constexpr int P = T::TR * o / T::kThreads;  // pieces a thread
    uint4 w[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = threadIdx.x + p * T::kThreads, r = i / o, s = i % o;
      w[p] = row0 + r < static_cast<size_t>(n)
                 ? reinterpret_cast<const uint4*>(x)[(row0 + r) * o + s]
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = threadIdx.x + p * T::kThreads, r = i / o, s = i % o;
      float4* dst = reinterpret_cast<float4*>(xs + r * ld + 8 * s);
      dst[0] = make_float4(bf16_lo(w[p].x), bf16_hi(w[p].x),
                           bf16_lo(w[p].y), bf16_hi(w[p].y));
      dst[1] = make_float4(bf16_lo(w[p].z), bf16_hi(w[p].z),
                           bf16_lo(w[p].w), bf16_hi(w[p].w));
    }
  } else {
    const int dp = pad8(d);
    for (int i = threadIdx.x; i < T::TR * dp; i += T::kThreads) {
      const int r = i / dp, k = i % dp;
      xs[r * ld + k] = (row0 + r < static_cast<size_t>(n) && k < d)
                           ? load_x<kBf16>(x, (row0 + r) * d + k)
                           : 0.0f;
    }
  }
}

// B4's prologue: codes * scale of rows [row0, row0 + TR) into xs[r][ld].
// D != 0 reads a 32-bit word at a time, 8 int4 codes (low nibble first) or
// 4 int8 codes, with its scale where the group allows; every word and
// scale load is issued before the first conversion.
template <class T, int D, int kPer>
__device__ __forceinline__ void stage_words(float* xs, int ld,
                                            const uint8_t* packed,
                                            const float* scales, int n,
                                            int group, size_t row0) {
  constexpr int o = D / kPer;                 // words a row
  constexpr int P = T::TR * o / T::kThreads;  // words a thread
  const int ng = D / group;
  uint32_t w[P];
  float s0[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = threadIdx.x + p * T::kThreads, r = i / o, s = i % o;
    const size_t row = row0 + r;
    const bool ok = row < static_cast<size_t>(n);
    w[p] = ok ? reinterpret_cast<const uint32_t*>(packed)[row * o + s] : 0;
    s0[p] = ok ? scales[row * ng + kPer * s / group] : 0.0f;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = threadIdx.x + p * T::kThreads, r = i / o, s = i % o;
    // one scale a word, or a row past n (codes 0): no second scale load
    const bool one = group % kPer == 0 || row0 + r >= static_cast<size_t>(n);
    const float* sc = scales + (row0 + r) * ng;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      constexpr int b = 32 / kPer;  // bits a code
      const int code = static_cast<int>(w[p] << (32 - b * (j + 1))) >> (32 - b);
      v[j] = static_cast<float>(code) *
             (one ? s0[p] : sc[(kPer * s + j) / group]);
    }
    float4* dst = reinterpret_cast<float4*>(xs + r * ld + kPer * s);
#pragma unroll
    for (int h = 0; h < kPer / 4; ++h)
      dst[h] = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                           v[4 * h + 3]);
  }
}

template <class T, int D>
__device__ __forceinline__ void stage_codes(float* xs, int ld,
                                            const uint8_t* packed,
                                            const float* scales, int n,
                                            int d, int group, int bits,
                                            size_t row0) {
  if constexpr (D != 0) {
    if (bits == 4)
      stage_words<T, D, 8>(xs, ld, packed, scales, n, group, row0);
    else
      stage_words<T, D, 4>(xs, ld, packed, scales, n, group, row0);
  } else {
    const int dp = pad8(d), ng = d / group;
    for (int i = threadIdx.x; i < T::TR * dp; i += T::kThreads) {
      const int r = i / dp, c = i % dp;
      const size_t row = row0 + r;
      float v = 0.0f;
      if (row < static_cast<size_t>(n) && c < d) {
        int code;
        if (bits == 4) {
          const int b = packed[row * (d / 2) + c / 2];
          code = ((c & 1) ? b >> 4 : b) & 0xF;
          code = code >= 8 ? code - 16 : code;
        } else {
          code = reinterpret_cast<const int8_t*>(packed)[row * d + c];
        }
        v = static_cast<float>(code) * scales[row * ng + c / group];
      }
      xs[r * ld + c] = v;
    }
  }
}

// eight consecutive values of one group at flat element index e (a
// multiple of 8): 4 nibble-packed bytes or 8 int8 bytes, one store
__device__ __forceinline__ void store_codes8(uint8_t* out, size_t e,
                                             const float v[8], float scale,
                                             int bits) {
  const int qmax = bits == 4 ? 7 : 127;
  const float inv = __frcp_rn(scale);
  int q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = code_of(v[i], scale, inv, qmax);
  if (bits == 4) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w |= static_cast<uint32_t>(q[i] & 0xF) << (4 * i);
    *reinterpret_cast<uint32_t*>(out + e / 2) = w;
  } else {
    uint2 w = make_uint2(0, 0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w.x |= static_cast<uint32_t>(q[i] & 0xFF) << (8 * i);
      w.y |= static_cast<uint32_t>(q[i + 4] & 0xFF) << (8 * i);
    }
    *reinterpret_cast<uint2*>(out + e) = w;
  }
}

// One TR-row tile of y = x @ M^T with M streamed in kChunk-k chunks, then
// B3's quantize or B4's store.  B3: x (n, d) fp32/bf16, lam or null, out
// and scales as srft_quant_launch.  B4: packed/scales in, out fp32 (n, d).
template <int D, bool kBf16, Mode kMode>
__global__ void __launch_bounds__(32 * kWarps)
srft_tile_kernel(const void* __restrict__ x, const float* __restrict__ m,
                 const float* __restrict__ lam, uint8_t* __restrict__ codes,
                 float* __restrict__ scales, float* __restrict__ y_out,
                 int n, int d, int group, int bits) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  const int dp = D != 0 ? D : pad8(d);
  const int ld = dp + 4;
  float* xs = smem;                    // T::TR x ld
  float* ms = smem + T::TR * ld;       // 2 x dp x kChunk, swizzled
  const int row0i = blockIdx.x * T::TR;
  const size_t row0 = row0i;
  const int rows = min(T::TR, n - row0i);

  stage_m<D, T::kThreads>(ms, m, d, 0, min(kChunk, dp));
  if constexpr (kMode == kQuant)
    stage_x<T, D, kBf16>(xs, ld, x, n, d, row0);
  else
    stage_codes<T, D>(xs, ld, codes, scales, n, d, group, bits, row0);
  cp_async_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rset = warp * T::RS + lane / T::LR;  // rows rset + kRowSets * j
  const int cl = lane % T::LR;                   // columns 8cl .. 8cl + 7
  const bool has_cols = D != 0 || 8 * cl < dp;
  const float* xr = xs + rset * ld;
  float acc[kRT][8];
#pragma unroll
  for (int j = 0; j < kRT; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;

  for (int k0 = 0, buf = 0; k0 < dp; k0 += kChunk, buf ^= 1) {
    const int kc = min(kChunk, dp - k0);
    if (k0 + kChunk < dp) {  // the next chunk streams in behind this one
      stage_m<D, T::kThreads>(ms + (buf ^ 1) * dp * kChunk, m, d,
                              k0 + kChunk, min(kChunk, dp - k0 - kChunk));
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* mb = ms + (buf * dp + 8 * cl) * kChunk;
    const int quads = D != 0 ? kChunk / 4 : kc / 4;  // D: every chunk full
    if (has_cols) {
#pragma unroll
      for (int q = 0; q < quads; ++q) {  // 4 k: 8 + kRT loads, 32 * kRT FMAs
        float4 mv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mv[i] = *reinterpret_cast<const float4*>(
              mb + i * kChunk + 4 * (q ^ (cl & 7)));
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xr + j * T::kRowSets * ld + k0 + 4 * q);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float& a = acc[j][i];
            a = fmaf(xv.x, mv[i].x, a);
            a = fmaf(xv.y, mv[i].y, a);
            a = fmaf(xv.z, mv[i].z, a);
            a = fmaf(xv.w, mv[i].w, a);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two chunks on
  }

  const int col = 8 * cl;
  if constexpr (kMode == kDequant) {
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
      const int r = rset + T::kRowSets * j;
      if (r >= rows || !has_cols) continue;
      float* o = y_out + (row0 + r) * d + col;
      if constexpr (D != 0) {
        reinterpret_cast<float4*>(o)[0] =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        reinterpret_cast<float4*>(o)[1] =
            make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (col + i < d) o[i] = acc[j][i];
      }
    }
  } else if constexpr (D != 0) {
    const int gl = group / 8, ng = D / group;  // a group: gl lanes
    float l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) l[i] = lam != nullptr ? lam[col + i] : 1.0f;
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
      const int r = rset + T::kRowSets * j;
      float v[8], a = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = lam != nullptr ? acc[j][i] * l[i] : acc[j][i];
        a = fmaxf(a, fabsf(v[i]));
      }
      a = group_absmax(a, gl);
      const float scale = fmaxf(a, 1e-12f) / (bits == 4 ? 7.0f : 127.0f);
      if (r < rows) {
        const size_t row = row0 + r;
        store_codes8(codes, row * D + col, v, scale, bits);
        if (cl % gl == 0) scales[row * ng + col / group] = scale;
      }
    }
  } else {  // generic B3: y to shared memory, then the unit layout
    if (has_cols) {
#pragma unroll
      for (int j = 0; j < kRT; ++j) {
        float* yr = xs + (rset + T::kRowSets * j) * ld + col;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          yr[i] = acc[j][i] *
                  (lam != nullptr && col + i < d ? lam[col + i] : 1.0f);
      }
    }
    __syncthreads();
    int L = 1;
    while (L < 32 && L < group / 2) L <<= 1;
    quant_units(SmemRows{xs, ld}, rows, row0, d, group, bits, codes, scales,
                warp * (32 / L), kWarps * (32 / L));
  }
}

// ------------------------------------------------------------ launches

template <class K>
int set_smem(K kern, int bytes, int& have) {
  if (bytes > have) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    have = bytes;
  }
  return 0;
}

template <int D, bool kBf16, Mode kMode>
int launch_tile(const void* x, const float* m, const float* lam,
                uint8_t* codes, float* scales, float* y_out, int n, int d,
                int group, int bits, cudaStream_t stream) {
  using T = Tile<D>;
  const int dp = D != 0 ? D : pad8(d);
  const int bytes = static_cast<int>(
      (static_cast<size_t>(T::TR) * (dp + 4) + 2 * dp * kChunk) *
      sizeof(float));
  auto kern = srft_tile_kernel<D, kBf16, kMode>;
  static int have = 0;
  const int err = set_smem(kern, bytes, have);
  if (err) return err;
  const int grid = (n + T::TR - 1) / T::TR;
  kern<<<grid, T::kThreads, bytes, stream>>>(x, m, lam, codes, scales,
                                             y_out, n, d, group, bits);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, Mode kMode>
int launch_product(int D, const void* x, const float* m, const float* lam,
                   uint8_t* codes, float* scales, float* y_out, int n, int d,
                   int group, int bits, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_tile<64, kBf16, kMode>(x, m, lam, codes, scales, y_out,
                                           n, d, group, bits, s);
    case 128:
      return launch_tile<128, kBf16, kMode>(x, m, lam, codes, scales, y_out,
                                            n, d, group, bits, s);
    case 256:
      return launch_tile<256, kBf16, kMode>(x, m, lam, codes, scales, y_out,
                                            n, d, group, bits, s);
    default:
      return launch_tile<0, kBf16, kMode>(x, m, lam, codes, scales, y_out, n,
                                          d, group, bits, s);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

bool bad_shape(int d, int group, int bits) {
  return d <= 0 || d > kMaxD || d % 2 || group <= 0 || d % group ||
         group % 2 || (bits != 4 && bits != 8);
}

// the register-tiled product's own shapes: d in {64, 128, 256} and a
// power-of-two group of 8 values up to a row set's d (a group's lanes are
// then consecutive, and each lane's 8 values lie in one group)
bool tiled(int d, int group) {
  return (d == 64 || d == 128 || d == 256) && pow2(group) && group >= 8;
}

template <bool kBf16>
int quant_with_matrix(const void* x, const float* m, const float* lam,
                      uint8_t* out, float* scales, int n, int d, int group,
                      int bits, cudaStream_t s) {
  const bool fast = tiled(d, group) && aligned16(x) && aligned16(m) &&
                    aligned16(lam);
  return launch_product<kBf16, kQuant>(fast ? d : 0, x, m, lam, out, scales,
                                       nullptr, n, d, group, bits, s);
}

template <bool kBf16>
int quant_no_matrix(const void* x, const float* lam, uint8_t* out,
                    float* scales, int n, int d, int group, int bits,
                    cudaStream_t s) {
  const size_t quads = static_cast<size_t>(n) * d / 4;
  const bool fast = group % 4 == 0 && pow2(group / 4) && group <= 128 &&
                    aligned16(x) && aligned16(lam);
  if (fast) {
    const int grid = static_cast<int>((quads + kRowsThreads - 1) /
                                      kRowsThreads);
    quant_rows_kernel<kBf16><<<grid, kRowsThreads, 0, s>>>(
        x, lam, out, scales, quads, d, group / 4, bits);
  } else {
    int L = 1;
    while (L < 32 && L < group / 2) L <<= 1;
    const long long units = static_cast<long long>(n) * (d / group);
    const long long per_block = (kRowsThreads / 32) * (32 / L);
    const long long grid = (units + per_block - 1) / per_block;
    quant_units_kernel<kBf16><<<static_cast<int>(grid < 65535 ? grid : 65535),
                                kRowsThreads, 0, s>>>(x, lam, out, scales, n,
                                                      d, group, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n, d) fp32 (x_bf16 == 0) or bf16; m: (d, d) fp32 or null; lam: (d,)
// fp32 or null; out: (n, d/2) uint8 (bits 4) or (n, d) int8 (bits 8);
// scales: (n, d/group) fp32.  Picks the kernel; returns cudaGetLastError()
// after the launch.
int srft_quant_launch(const void* x, int x_bf16, const float* m,
                      const float* lam, void* out, float* scales, int n, int d,
                      int group, int bits, void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(d, group, bits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (m == nullptr)
    return x_bf16 ? quant_no_matrix<true>(x, lam, o, scales, n, d, group,
                                          bits, s)
                  : quant_no_matrix<false>(x, lam, o, scales, n, d, group,
                                           bits, s);
  return x_bf16 ? quant_with_matrix<true>(x, m, lam, o, scales, n, d, group,
                                          bits, s)
                : quant_with_matrix<false>(x, m, lam, o, scales, n, d, group,
                                           bits, s);
}

// packed: (n, d/2) uint8 (bits 4) or (n, d) int8 (bits 8); scales: (n,
// d/group) fp32; minv: (d, d) fp32; out: (n, d) fp32.  Returns
// cudaGetLastError() after the launch.
int srft_dequant_launch(const void* packed, const float* scales,
                        const float* minv, float* out, int n, int d,
                        int group, int bits, void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(d, group, bits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  uint8_t* c = const_cast<uint8_t*>(p);
  float* sc = const_cast<float*>(scales);
  const bool fast = (d == 64 || d == 128 || d == 256) && aligned16(packed) &&
                    aligned16(minv) && aligned16(out);
  return launch_product<false, kDequant>(fast ? d : 0, nullptr, minv,
                                         nullptr, c, sc, out, n, d, group,
                                         bits, s);
}

const char* srft_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
