// Split-K flash-decode over nibble-packed int4 K/V for Hopper (sm_90a),
// over a dense cache (B1) and over a paged pool (B2).
//
// Replaces the TPU kernels B1: quant_decode_attention_fwd / _kernel_impl /
// _unpack_dequant, and B2: quant_decode_attention_paged_fwd, both in
// src/repro/kernels/quant_attention/quant_attention.py.
// One decode step for each (batch * kv-head) row and its G grouped query
// heads, in rotated space: the wrapper has folded diag(1/lam_k) B and the
// softmax scale into q_eff, so scores are q_eff . (code * scale).
//   * packed part: tokens [0, packed_len) read as int4 codes + fp32 group
//     scales, online softmax over kTile-token tiles, -1e30 mask sentinel,
//     tiles at or past packed_len skipped, tokens at or past it never
//     loaded;
//   * residual part: the fp32 window (positions packed_len + i, masked
//     < total_len) folded in last, with the same update rule;
//   * out = acc / max(l, 1e-30): finite on empty rows, as the reference.
//
// B2 is B1's pass 1 with another address for token t of row r = b*H + h:
//   dense (B1): row r*S + t of the (BH, S, .) arrays;
//   paged (B2): row (page_table[b*MP + t/ps]*H + h)*ps + t%ps of the
//               (n_pages*H, ps, .) pools.
// The address is the pass's template parameter (DenseRows / PagedRows);
// the arithmetic, the split plan (chosen by the wrapper from S = MP*ps for
// both when lengths are per row), the tile and the combine pass are the
// same code, so B2 equals B1 bitwise on the gathered view.  Every token is
// addressed on its own, so a tile may span pages of any size; the wrapper
// still requires page_size to divide or be a multiple of kTile.  The TPU
// kernel runs one grid step per page; this one keeps B1's 64-token tiles.
//
// What bounds it on the card: bytes.  A decode step reads each cached
// token's d/2 code bytes and d/group fp32 scales for K and V once and does
// about 4*G FLOP per byte -- far below the H100's ridge.  At batch 1 there
// are only B * Hkv rows (8 for internlm2-1.8b); one block per row, as the
// TPU's sequential grid does, would use 8 of 132 SMs.  So the sequence is
// split (split-K): pass 1 runs a (splits, rows) grid, each block streaming
// its share of the tiles into shared memory and writing (m, l, acc)
// partials; pass 2 runs one block per row, combines the partials and folds
// in the residual window.  The wrapper picks the number of splits so that
// about four blocks land on every SM, as far as pass 2's shared memory
// holds their partials.  Tiles arrive by cp.async, all of a tile's loads
// in flight at once and the next tile's loads overlapping the current
// tile's arithmetic (double buffering): the first version staged tiles
// through registers, one load at a time, and was bound by DRAM latency.
// Packed rows are stored in shared memory with one word of padding, so the
// per-token score loop reads them without bank conflicts.  The combine
// pass stages its row's partials and residual window in shared memory with
// every load in flight at once (the first version read them from global
// memory in dependent loops), then reduces with warp shuffles.  expf is
// the accurate one: build without --use_fast_math.
// Not yet: TMA, tensor-core scores, one fused pass, 16-byte page copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // tokens per tile
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kMaxCols = 2;    // coordinates per thread: d <= 256
constexpr float kNeg = -1e30f;

// code i of a word: byte i/2, low nibble = even index, sign-extended by
// an arithmetic shift
__device__ __forceinline__ int nibble(uint32_t word, int i) {
  return static_cast<int32_t>(word << (28 - 4 * i)) >> 28;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Token addresses: row index of token t of row bh in the packed (., d/2)
// and scales (., d/group) arrays.
struct DenseRows {  // B1: (BH, S, .) arrays
  int S;
  __device__ __forceinline__ size_t operator()(int bh, int t) const {
    return (size_t)bh * S + t;
  }
};
struct PagedRows {  // B2: (n_pages*H, ps, .) pools behind a (B, MP) table
  const int* page_table;
  int MP, H, ps;
  __device__ __forceinline__ size_t operator()(int bh, int t) const {
    const int page = page_table[(size_t)(bh / H) * MP + t / ps];
    return ((size_t)page * H + bh % H) * ps + t % ps;
  }
};

// Pass 1: grid (n_splits, BH).  Writes part_ml[bh][split][g] = (m, l) and
// part_acc[bh][split][g][d].  S is the logical length of every row.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
qda_split_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kp,
                 const float* __restrict__ ks, const uint8_t* __restrict__ vp,
                 const float* __restrict__ vs, const int* __restrict__ plen_rows,
                 int plen_all, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int S, int G, int d, int group,
                 int tiles_per_split, Rows rows) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x, bh = blockIdx.y, n_splits = gridDim.x;
  const int tid = threadIdx.x;
  const int wpr = d / 8;        // 4-byte words per packed row
  const int ldw = wpr + 1;      // padded row stride (words)
  const int ng = d / group;
  const int tile_words = kTile * ldw;
  const int tile_scales = kTile * ng;
  float* qs = smem;                                          // G * d
  uint32_t* kw = reinterpret_cast<uint32_t*>(qs + G * d);    // 2 * tile_words
  uint32_t* vw = kw + 2 * tile_words;                        // 2 * tile_words
  float* kss = reinterpret_cast<float*>(vw + 2 * tile_words);  // 2 * tile_scales
  float* vss = kss + 2 * tile_scales;                        // 2 * tile_scales
  float* ps = vss + 2 * tile_scales;                         // G * kTile
  float* ms = ps + G * kTile;                                // G
  float* ls = ms + G;                                        // G
  float* cs = ls + G;                                        // G

  const int plen = min(plen_rows != nullptr ? plen_rows[bh] : plen_all, S);
  const uint32_t* kp32 = reinterpret_cast<const uint32_t*>(kp);
  const uint32_t* vp32 = reinterpret_cast<const uint32_t*>(vp);
  const int t_begin = split * tiles_per_split;
  const int t_live = min(t_begin + tiles_per_split, (plen + kTile - 1) / kTile);
  const int n_my = max(t_live - t_begin, 0);  // tiles past packed_len skipped

  // tokens [s0, s0 + n_tok) of a live tile: those below packed_len only
  auto issue = [&](int buf, int tile) {
    const int s0 = tile * kTile;
    const int n_tok = min(kTile, plen - s0);
    uint32_t* kb = kw + buf * tile_words;
    uint32_t* vb = vw + buf * tile_words;
    for (int i = tid; i < n_tok * wpr; i += kThreads) {
      const int t = i / wpr, w = i % wpr;
      const size_t r = rows(bh, s0 + t);
      cp_async4(kb + t * ldw + w, kp32 + r * wpr + w);
      cp_async4(vb + t * ldw + w, vp32 + r * wpr + w);
    }
    for (int i = tid; i < n_tok * ng; i += kThreads) {
      const int t = i / ng, j = i % ng;
      const size_t r = rows(bh, s0 + t);
      cp_async4(kss + buf * tile_scales + i, ks + r * ng + j);
      cp_async4(vss + buf * tile_scales + i, vs + r * ng + j);
    }
    cp_async_commit();
  };

  if (n_my > 0) issue(0, t_begin);
  for (int i = tid; i < G * d; i += kThreads) qs[i] = q[(size_t)bh * G * d + i];
  if (tid < G) { ms[tid] = kNeg; ls[tid] = 0.0f; }
  float acc[kMaxCols][kMaxG];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[c][g] = 0.0f;
  const int warp = tid / 32, lane = tid % 32;

  for (int j = 0; j < n_my; ++j) {
    const int buf = j & 1;
    const int s0 = (t_begin + j) * kTile;
    const int n_tok = min(kTile, plen - s0);
    if (j + 1 < n_my) {
      issue(buf ^ 1, t_begin + j + 1);  // buffer freed by the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* kb = kw + buf * tile_words;
    const uint32_t* vb = vw + buf * tile_words;
    const float* ksb = kss + buf * tile_scales;
    const float* vsb = vss + buf * tile_scales;
    // scores: one (g, t) pair per thread
    for (int p = tid; p < G * kTile; p += kThreads) {
      const int g = p / kTile, t = p % kTile;
      float s = kNeg;
      if (t < n_tok) {
        const float* qg = qs + g * d;
        const uint32_t* row = kb + t * ldw;
        const float* sc = ksb + t * ng;
        float part = 0.0f;
        s = 0.0f;
        int gi = 0, left = group;
        for (int w = 0; w < wpr; ++w) {
          const uint32_t word = row[w];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            part = fmaf(qg[8 * w + i], (float)nibble(word, i), part);
            if (--left == 0) {
              s = fmaf(part, sc[gi], s);
              part = 0.0f;
              ++gi;
              left = group;
            }
          }
        }
      }
      ps[g * kTile + t] = s;
    }
    __syncthreads();
    // online softmax statistics, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNeg;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, ps[g * kTile + t]);
      mx = warp_max(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < kTile; t += 32) {
        const float e = expf(ps[g * kTile + t] - m_new);
        ps[g * kTile + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p . v, one coordinate per thread per column slot
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int e = tid + c * kThreads;
      if (e < d) {
        const int w = e / 8, i = e % 8, gi = e / group;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[c][g] *= cs[g];
        for (int t = 0; t < n_tok; ++t) {
          const float v = (float)nibble(vb[t * ldw + w], i) * vsb[t * ng + gi];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[c][g] = fmaf(ps[g * kTile + t], v, acc[c][g]);
        }
      }
    }
    __syncthreads();  // tile buffer and ps consumed
  }
  const size_t base = ((size_t)bh * n_splits + split) * G;
  if (tid < G) {
    part_ml[(base + tid) * 2 + 0] = ms[tid];
    part_ml[(base + tid) * 2 + 1] = ls[tid];
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int e = tid + c * kThreads;
    if (e < d) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) part_acc[(base + g) * d + e] = acc[c][g];
    }
  }
}

// Pass 2: one block per row.  Stages the row's partials and residual
// window in shared memory (every load in flight at once), combines the
// partials, folds in the residual window, normalizes.
__global__ void __launch_bounds__(kThreads)
qda_combine_kernel(const float* __restrict__ q, const float* __restrict__ kr,
                   const float* __restrict__ vr, const int* __restrict__ plen_rows,
                   const int* __restrict__ tlen_rows, int plen_all, int tlen_all,
                   const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, float* __restrict__ out,
                   int n_splits, int G, int d, int W) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_acc = n_splits * G * d;   // multiple of 8 floats (d % 8 == 0)
  float* accs = smem;                   // n_splits * G * d partial accs
  float* krs = accs + n_acc;            // W * d
  float* vrs = krs + W * d;             // W * d
  float* mls = vrs + W * d;             // n_splits * G * 2
  float* ws = mls + n_splits * G * 2;   // G * n_splits: split weights
  float* rs = ws + G * n_splits;        // G * W: residual scores, then p
  float* mp = rs + G * W;               // G: max of the packed partials
  float* lp = mp + G;                   // G: l, then the final denominator
  float* cr = lp + G;                   // G: correction of the packed acc
  const int plen = plen_rows != nullptr ? plen_rows[bh] : plen_all;
  const int tlen = tlen_rows != nullptr ? tlen_rows[bh] : tlen_all;
  const float* qrow = q + (size_t)bh * G * d;

  const float* acc_src = part_acc + (size_t)bh * n_acc;
  for (int i = 4 * tid; i < n_acc; i += 4 * kThreads) cp_async16(accs + i, acc_src + i);
  for (int i = 4 * tid; i < W * d; i += 4 * kThreads) {
    cp_async16(krs + i, kr + (size_t)bh * W * d + i);
    cp_async16(vrs + i, vr + (size_t)bh * W * d + i);
  }
  for (int i = tid; i < n_splits * G * 2; i += kThreads)
    cp_async4(mls + i, part_ml + (size_t)bh * n_splits * G * 2 + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // packed partials: m = max_s m_s, w_s = exp(m_s - m), l = sum_s w_s l_s
  for (int g = warp; g < G; g += kWarps) {
    float m = kNeg;
    for (int s = lane; s < n_splits; s += 32) m = fmaxf(m, mls[(s * G + g) * 2]);
    m = warp_max(m);
    float l = 0.0f;
    for (int s = lane; s < n_splits; s += 32) {
      const float w = expf(mls[(s * G + g) * 2] - m);
      ws[g * n_splits + s] = w;
      l += w * mls[(s * G + g) * 2 + 1];
    }
    l = warp_sum(l);
    if (lane == 0) { mp[g] = m; lp[g] = l; }
  }
  // residual scores (g, i), one warp per pair, masked past total_len
  for (int p = warp; p < G * W; p += kWarps) {
    const int g = p / W, i = p % W;
    float s = 0.0f;
    for (int e = lane; e < d; e += 32) s = fmaf(qrow[g * d + e], krs[i * d + e], s);
    s = warp_sum(s);
    if (lane == 0) rs[p] = plen + i < tlen ? s : kNeg;
  }
  __syncthreads();
  // residual fold-in: the reference's online update, as its last tile
  for (int g = warp; g < G; g += kWarps) {
    float mr = kNeg;
    for (int i = lane; i < W; i += 32) mr = fmaxf(mr, rs[g * W + i]);
    mr = warp_max(mr);
    const float m_new = fmaxf(mp[g], mr);
    float sum = 0.0f;
    for (int i = lane; i < W; i += 32) {
      const float e = expf(rs[g * W + i] - m_new);
      rs[g * W + i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(mp[g] - m_new);
      cr[g] = corr;
      lp[g] = fmaxf(lp[g] * corr + sum, 1e-30f);
    }
  }
  __syncthreads();
  for (int p = tid; p < G * d; p += kThreads) {
    const int g = p / d, e = p % d;
    float a = 0.0f;
    for (int s = 0; s < n_splits; ++s)
      a = fmaf(ws[g * n_splits + s], accs[(s * G + g) * d + e], a);
    a *= cr[g];
    for (int i = 0; i < W; ++i) a = fmaf(rs[g * W + i], vrs[i * d + e], a);
    out[((size_t)bh * G + g) * d + e] = a / lp[g];
  }
}

// raise a kernel's dynamic shared memory limit once, as far as needed;
// ``have`` must be the one record of that kernel's limit (setting the
// attribute lower than an earlier launch needed would make that launch
// fail later)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* have) {
  if (bytes <= *have) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *have = bytes;
  return err;
}

// qda_combine_kernel's limit: one kernel, shared by B1 and B2
int combine_smem_have = 0;

// The two passes; Rows picks B1's or B2's token address.  Returns
// cudaGetLastError() after the launches.
template <class Rows>
int launch_passes(const float* q, const uint8_t* kp, const float* ks,
                  const uint8_t* vp, const float* vs, const float* kr,
                  const float* vr, const int* plen_rows, const int* tlen_rows,
                  int plen, int tlen, float* part_ml, float* part_acc,
                  float* out, int BH, int S, int G, int d, int group, int W,
                  int n_splits, int tiles_per_split, Rows rows,
                  cudaStream_t st) {
  static int smem1_have = 0;  // one qda_split_kernel<Rows> per Rows
  if (BH <= 0) return 0;
  if (G < 1 || G > kMaxG || d > kThreads * kMaxCols || d % 8 || group <= 0 ||
      d % group || n_splits < 1 || W < 0)
    return (int)cudaErrorInvalidValue;
  const int ng = d / group;
  const int ldw = d / 8 + 1;
  const size_t words1 = (size_t)G * d + 4 * (size_t)kTile * ldw +
                        4 * (size_t)kTile * ng + (size_t)G * kTile + 3 * G;
  const int smem1 = (int)(words1 * sizeof(float));
  cudaError_t err = allow_smem(qda_split_kernel<Rows>, smem1, &smem1_have);
  if (err != cudaSuccess) return (int)err;
  qda_split_kernel<Rows><<<dim3(n_splits, BH), kThreads, smem1, st>>>(
      q, kp, ks, vp, vs, plen_rows, plen, part_ml, part_acc, S, G, d, group,
      tiles_per_split, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t words2 = (size_t)n_splits * G * (d + 3) + 2 * (size_t)W * d +
                        (size_t)G * W + 3 * G;
  const int smem2 = (int)(words2 * sizeof(float));
  err = allow_smem(qda_combine_kernel, smem2, &combine_smem_have);
  if (err != cudaSuccess) return (int)err;
  qda_combine_kernel<<<BH, kThreads, smem2, st>>>(
      q, kr, vr, plen_rows, tlen_rows, plen, tlen, part_ml, part_acc, out,
      n_splits, G, d, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B1.  q: (BH, G, d) f32; kp/vp: (BH, S, d/2) u8; ks/vs: (BH, S, d/group)
// f32; kr/vr: (BH, W, d) f32; plen_rows/tlen_rows: (BH,) i32 or null (then
// the scalars apply to every row); part_ml: (BH, n_splits, G, 2) f32 and
// part_acc: (BH, n_splits, G, d) f32 scratch; out: (BH, G, d) f32.
int quant_decode_attention_launch(
    const float* q, const uint8_t* kp, const float* ks, const uint8_t* vp,
    const float* vs, const float* kr, const float* vr, const int* plen_rows,
    const int* tlen_rows, int plen, int tlen, float* part_ml, float* part_acc,
    float* out, int BH, int S, int G, int d, int group, int W, int n_splits,
    int tiles_per_split, void* stream) {
  return launch_passes(q, kp, ks, vp, vs, kr, vr, plen_rows, tlen_rows, plen,
                       tlen, part_ml, part_acc, out, BH, S, G, d, group, W,
                       n_splits, tiles_per_split, DenseRows{S},
                       (cudaStream_t)stream);
}

// B2.  As B1, but kp/vp: (n_pages*H, ps, d/2) u8 and ks/vs: (n_pages*H,
// ps, d/group) f32 pools, page_table: (BH/H, MP) i32, and per-row lengths
// (plen_rows, tlen_rows: (BH,) i32) always.
int quant_decode_attention_paged_launch(
    const float* q, const uint8_t* kp, const float* ks, const uint8_t* vp,
    const float* vs, const float* kr, const float* vr, const int* page_table,
    const int* plen_rows, const int* tlen_rows, float* part_ml,
    float* part_acc, float* out, int BH, int H, int MP, int ps, int G, int d,
    int group, int W, int n_splits, int tiles_per_split, void* stream) {
  if (H < 1 || MP < 1 || ps < 1 || BH % H) return (int)cudaErrorInvalidValue;
  return launch_passes(q, kp, ks, vp, vs, kr, vr, plen_rows, tlen_rows, 0, 0,
                       part_ml, part_acc, out, BH, MP * ps, G, d, group, W,
                       n_splits, tiles_per_split,
                       PagedRows{page_table, MP, H, ps},
                       (cudaStream_t)stream);
}

const char* quant_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
