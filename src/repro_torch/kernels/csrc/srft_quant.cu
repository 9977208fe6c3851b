// Fused rotate + lambda + per-group absmax + int4/int8 pack for Hopper
// (sm_90a), and its inverse.
//
// Replaces the TPU kernel B3: srft_quant_fwd / _quant_kernel in
// src/repro/kernels/srft_quant/srft_quant.py.  Computes, for N rows of d:
//     y      = x @ M^T            (M the d x d rotation, fp32 FMAs)
//     y      = y * lam            (optional epilogue; lam == nullptr skips it)
//     scale  = max(absmax_group(y), 1e-12) / qmax
//     codes  = clip(rint(y / scale), -qmax, qmax)
//     out    = nibble pack (odd << 4) | (even & 0xF)   (bits 4) or int8 (bits 8)
// With M == nullptr the rotation is skipped (y = x): the residual-window
// flush quantizes values that are already rotated.
//
// What bounds it on the card: at the cache write's shapes (d = 128, N =
// tokens x kv-heads) the d x d fp32 product is 2*d FLOP per input byte read
// over 4 bytes, i.e. 64 FLOP/byte, above the H100's fp32 (non-tensor-core)
// ridge of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte: the kernel is bound by
// fp32 operations, not bytes.  The design keeps it a single pass: one read
// of x, the matrix streamed through shared memory in kChunk-row chunks (so
// d = 256 fits as well as d = 128), y kept in shared memory, and a write
// of a quarter of the input's bytes.  Each block takes kRows rows; every
// thread owns output columns and keeps kRows fp32 accumulators in
// registers.  The x tile is stored transposed, so one broadcast float4
// load feeds four FMAs (shared-memory loads, not FMAs, bounded the first
// version), and the matrix chunk is stored transposed with one word of
// padding per row, so its reads have no bank conflicts.  Codes need a
// true IEEE division and rintf (round half to even): build without
// --use_fast_math.
// Not yet: tensor cores (TF32 would change codes at .5 boundaries; a 3xTF32
// split would not), TMA staging.
//
// Also replaces the TPU kernel B4: srft_dequant_fwd / _dequant_kernel in
// the same file.  Computes, for N rows of packed codes:
//     y      = codes * scale[group]   (int4 low nibble = even index,
//                                      sign-extended at >= 8; or int8)
//     x      = y @ Minv^T             (Minv the folded inverse, fp32 FMAs)
// What bounds it: the same d x d fp32 product per row as B3; at d = 128
// and int4 a row costs 2*d^2 = 32,768 FLOP against 80 bytes read (codes
// and scales) and 512 written, about 55 FLOP per byte moved, above the
// H100's fp32 ridge of 20: bound by fp32 operations.  The design is B3's product loop with the
// dequantize as its prologue: codes are unpacked and scaled once, straight
// into the transposed shared-memory tile, and the fp32 result goes out
// once.  Accumulation is in fp32 FMAs in input order; no TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;     // rows of x per block
constexpr int kChunk = 32;    // matrix rows (input coordinates) staged per step
constexpr int kMaxCols = 2;   // output columns per thread: d <= 256
constexpr int kLdx = kRows + 4;  // transposed x row stride (16-byte aligned)

template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if (kBf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
  return reinterpret_cast<const float*>(x)[i];
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
srft_quant_kernel(const void* __restrict__ x, const float* __restrict__ m,
                  const float* __restrict__ lam, uint8_t* __restrict__ out,
                  float* __restrict__ scales, int n, int d, int group, int bits) {
  extern __shared__ __align__(16) float smem[];
  const bool has_m = (m != nullptr);
  float* ys = smem;                                    // kRows * d
  float* xt = ys + kRows * d;                          // d * kLdx (has_m only)
  float* mt = xt + d * kLdx;                           // kChunk * (d + 1)
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);

  if (!has_m) {
    for (int i = tid; i < kRows * d; i += kThreads)
      ys[i] = i / d < rows ? load_x<kBf16>(x, (size_t)row0 * d + i) : 0.0f;
    __syncthreads();
    if (lam != nullptr) {
      for (int i = tid; i < kRows * d; i += kThreads) ys[i] *= lam[i % d];
      __syncthreads();
    }
  } else {
    // x tile transposed, xt[k][r]: a thread reads 4 rows of one input
    // coordinate with one broadcast float4 load
    for (int i = tid; i < kRows * d; i += kThreads) {
      const int r = i / d, k = i % d;
      xt[k * kLdx + r] = r < rows ? load_x<kBf16>(x, (size_t)row0 * d + i) : 0.0f;
    }
    float acc[kMaxCols][kRows];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[c][r] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int kc = min(kChunk, d - k0);
      __syncthreads();  // previous chunk consumed (and xt staged, first time)
      // mt[kk][e] = m[e][k0 + kk]: coalesced along kk in global memory
      for (int i = tid; i < d * kc; i += kThreads) {
        const int e = i / kc, kk = i % kc;
        mt[kk * (d + 1) + e] = m[(size_t)e * d + k0 + kk];
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int e = tid + c * kThreads;
        if (e < d) {
          for (int kk = 0; kk < kc; ++kk) {
            const float mv = mt[kk * (d + 1) + e];
            const float4* xr = reinterpret_cast<const float4*>(xt + (k0 + kk) * kLdx);
#pragma unroll
            for (int r4 = 0; r4 < kRows / 4; ++r4) {
              const float4 xv = xr[r4];
              acc[c][4 * r4 + 0] = fmaf(xv.x, mv, acc[c][4 * r4 + 0]);
              acc[c][4 * r4 + 1] = fmaf(xv.y, mv, acc[c][4 * r4 + 1]);
              acc[c][4 * r4 + 2] = fmaf(xv.z, mv, acc[c][4 * r4 + 2]);
              acc[c][4 * r4 + 3] = fmaf(xv.w, mv, acc[c][4 * r4 + 3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int e = tid + c * kThreads;
      if (e < d) {
        const float lv = lam != nullptr ? lam[e] : 1.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          ys[r * d + e] = lam != nullptr ? acc[c][r] * lv : acc[c][r];
      }
    }
    __syncthreads();
  }

  // one (row, group) pair per thread: absmax, scale, quantize, pack
  const int ng = d / group;
  const float qmax = bits == 4 ? 7.0f : 127.0f;
  for (int p = tid; p < rows * ng; p += kThreads) {
    const int r = p / ng, gi = p % ng;
    const float* yv = ys + r * d + gi * group;
    float amax = 0.0f;
    for (int j = 0; j < group; ++j) amax = fmaxf(amax, fabsf(yv[j]));
    const float scale = fmaxf(amax, 1e-12f) / qmax;
    const size_t row = (size_t)row0 + r;
    scales[row * ng + gi] = scale;
    if (bits == 4) {
      uint8_t* o = out + row * (d / 2) + gi * (group / 2);
      for (int j = 0; j < group; j += 2) {
        const int q0 = (int)fminf(fmaxf(rintf(yv[j] / scale), -qmax), qmax);
        const int q1 = (int)fminf(fmaxf(rintf(yv[j + 1] / scale), -qmax), qmax);
        o[j / 2] = (uint8_t)(((q1 & 0xF) << 4) | (q0 & 0xF));
      }
    } else {
      int8_t* o = reinterpret_cast<int8_t*>(out) + row * d + gi * group;
      for (int j = 0; j < group; ++j)
        o[j] = (int8_t)(int)fminf(fmaxf(rintf(yv[j] / scale), -qmax), qmax);
    }
  }
}

// B4: unpack + dequantize + inverse rotation, x = (codes * scale) @ Minv^T.
// The same layout as the product above: kRows rows per block, the
// dequantized y tile stored transposed (yt[e][r]) so one broadcast float4
// load feeds four FMAs, Minv streamed in kChunk-row chunks with one word
// of padding per row, kRows fp32 accumulators per output column in
// registers.  Each output row is written once, coalesced across threads.
__global__ void __launch_bounds__(kThreads)
srft_dequant_kernel(const uint8_t* __restrict__ packed,
                    const float* __restrict__ scales,
                    const float* __restrict__ minv, float* __restrict__ out,
                    int n, int d, int group, int bits) {
  extern __shared__ __align__(16) float smem[];
  float* yt = smem;                 // d * kLdx
  float* mt = yt + d * kLdx;        // kChunk * (d + 1)
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int ng = d / group;

  if (bits == 4) {
    // one byte = codes 2j (low nibble) and 2j+1 (high nibble), signed
    const int half = d / 2;
    for (int i = tid; i < kRows * half; i += kThreads) {
      const int r = i / half, j = i % half;
      float lo = 0.0f, hi = 0.0f;
      if (r < rows) {
        const size_t row = (size_t)row0 + r;
        const int b = packed[row * half + j];
        const int l = b & 0xF, h = b >> 4;
        const float* sc = scales + row * ng;
        lo = (float)(l >= 8 ? l - 16 : l) * sc[(2 * j) / group];
        hi = (float)(h >= 8 ? h - 16 : h) * sc[(2 * j + 1) / group];
      }
      yt[(2 * j) * kLdx + r] = lo;
      yt[(2 * j + 1) * kLdx + r] = hi;
    }
  } else {
    const int8_t* codes = reinterpret_cast<const int8_t*>(packed);
    for (int i = tid; i < kRows * d; i += kThreads) {
      const int r = i / d, e = i % d;
      float v = 0.0f;
      if (r < rows) {
        const size_t row = (size_t)row0 + r;
        v = (float)codes[row * d + e] * scales[row * ng + e / group];
      }
      yt[e * kLdx + r] = v;
    }
  }

  float acc[kMaxCols][kRows];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    __syncthreads();  // previous chunk consumed (and yt staged, first time)
    // mt[kk][o] = minv[o][k0 + kk]: coalesced along kk in global memory
    for (int i = tid; i < d * kc; i += kThreads) {
      const int o = i / kc, kk = i % kc;
      mt[kk * (d + 1) + o] = minv[(size_t)o * d + k0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int o = tid + c * kThreads;
      if (o < d) {
        for (int kk = 0; kk < kc; ++kk) {
          const float mv = mt[kk * (d + 1) + o];
          const float4* yr = reinterpret_cast<const float4*>(yt + (k0 + kk) * kLdx);
#pragma unroll
          for (int r4 = 0; r4 < kRows / 4; ++r4) {
            const float4 yv = yr[r4];
            acc[c][4 * r4 + 0] = fmaf(yv.x, mv, acc[c][4 * r4 + 0]);
            acc[c][4 * r4 + 1] = fmaf(yv.y, mv, acc[c][4 * r4 + 1]);
            acc[c][4 * r4 + 2] = fmaf(yv.z, mv, acc[c][4 * r4 + 2]);
            acc[c][4 * r4 + 3] = fmaf(yv.w, mv, acc[c][4 * r4 + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int o = tid + c * kThreads;
    if (o < d) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) out[((size_t)row0 + r) * d + o] = acc[c][r];
    }
  }
}

}  // namespace

extern "C" {

// x: (n, d) fp32 (x_bf16 == 0) or bf16; m: (d, d) fp32 or null; lam: (d,)
// fp32 or null; out: (n, d/2) uint8 (bits 4) or (n, d) int8 (bits 8);
// scales: (n, d/group) fp32.  Returns cudaGetLastError() after the launch.
int srft_quant_launch(const void* x, int x_bf16, const float* m,
                      const float* lam, void* out, float* scales, int n, int d,
                      int group, int bits, void* stream) {
  if (n <= 0) return 0;
  if (d > kThreads * kMaxCols || d % 2 || group <= 0 || d % group ||
      group % 2 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)kRows * d +
                       (m != nullptr ? (size_t)d * kLdx + (size_t)kChunk * (d + 1) : 0);
  const int smem = (int)(words * sizeof(float));
  void (*kern)(const void*, const float*, const float*, uint8_t*, float*, int,
               int, int, int) =
      x_bf16 ? srft_quant_kernel<true> : srft_quant_kernel<false>;
  // raise the dynamic shared memory limit once per kernel, as far as needed
  static int configured[2] = {0, 0};
  int& have = configured[x_bf16 ? 1 : 0];
  if (smem > have) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    have = smem;
  }
  const int grid = (n + kRows - 1) / kRows;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, m, lam, (uint8_t*)out, scales, n, d, group, bits);
  return (int)cudaGetLastError();
}

// packed: (n, d/2) uint8 (bits 4) or (n, d) int8 (bits 8); scales: (n,
// d/group) fp32; minv: (d, d) fp32; out: (n, d) fp32.  Returns
// cudaGetLastError() after the launch.
int srft_dequant_launch(const void* packed, const float* scales,
                        const float* minv, float* out, int n, int d,
                        int group, int bits, void* stream) {
  if (n <= 0) return 0;
  if (d > kThreads * kMaxCols || d % 2 || group <= 0 || d % group ||
      group % 2 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)d * kLdx + (size_t)kChunk * (d + 1);
  const int smem = (int)(words * sizeof(float));
  static int configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        srft_dequant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  const int grid = (n + kRows - 1) / kRows;
  srft_dequant_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, scales, minv, out, n, d, group, bits);
  return (int)cudaGetLastError();
}

const char* srft_quant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
