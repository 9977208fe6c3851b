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
//   * out = acc / max(l, 1e-30): finite on empty rows, as the reference;
//   * optionally (B1, a non-null lse): the row's log-sum-exp of its scores,
//     m + log(max(l, 1e-30)), in the kernel's score units (q_eff carries the
//     softmax scale), so that reads of one query over disjoint segments of
//     the sequence (a cache split by position over shards) can be combined
//     by their weights exp(lse_j - max_j lse_j).  A row with nothing to
//     read keeps the -1e30 sentinel: its lse is -1e30 + log(W), which is
//     -1e30 in fp32, so its weight beside any row with a valid score is
//     exactly 0 and its output (the mean of its masked window) is finite.
//     A -inf there would make the combine of all-empty rows NaN.
//
// B2 is B1's pass 1 with another address for token t of row r = b*H + h:
//   dense (B1): row r*S + t of the (BH, S, .) arrays;
//   paged (B2): row (page_table[b*MP + t/ps]*H + h)*ps + t%ps of the
//               (n_pages*H, ps, .) pools.
// The address is the pass's template parameter (DenseRows / PagedRows);
// the arithmetic, the split plan (chosen by the wrapper from S = MP*ps for
// both when lengths are per row), the tile and the combine pass are the
// same code, so B2 equals B1 bitwise on the gathered view.  Every token is
// addressed on its own, so a tile may span pages of any size (the card
// tests run 16, 32, 48, 64, 80 and 128).  The TPU kernel runs one grid
// step per page; this one keeps B1's 64-token tiles.
//
// What bounds it on the card: bytes.  A decode step reads each cached
// token's d/2 code bytes and d/group fp32 scales for K and V once and does
// about 3.2*G FLOP per byte at d 128, group 32 -- below the H100's fp32
// ridge (20) for G <= 5.  At batch 1 there are only B * Hkv rows (8 for
// internlm2-1.8b); one block per row, as the TPU's sequential grid does,
// would use 8 of 132 SMs.  So the sequence is split (split-K): pass 1 runs
// a (rows, splits) grid, each block reading its share of the 64-token
// tiles and writing (m, l, acc) partials; pass 2 runs one block per row,
// combines the partials and folds in the residual window.  The wrapper
// picks the number of splits so that about four blocks land on every SM,
// as far as pass 2's shared memory holds their partials; at batch 1 that
// is one tile per block.  Blocks run split-major, so a long row's splits
// reach the SMs before the empty splits past the shorter rows' ends.
//
// Pass 1 on the tensor cores (qda_split_kernel_tc), where G >= 2 and d and
// group are multiples of 32 (ops.tensor_core_pass says the same):
//   * Warps.  A warp reads 16 tokens a step: a quarter of a 64-token tile.
//     A one-tile split (batch 1) runs 4 warps, a split of 2 to 7 tiles 8,
//     a longer one 16 (d <= 128; 8 above), the warps past the first four
//     taking the next tiles in turn, so each walks a share of the chain.
//     A warp copies its own tokens into its own cp.async double buffer and
//     synchronises by __syncwarp alone; the block meets at the start (q's
//     fragments) and at the merge.  Where a step's 16 rows follow each
//     other (dense rows, pages of a multiple of 16 tokens) its first row is
//     looked up a step ahead, so the page-table load is in flight during
//     the math; other pages look each token up at its copy.  Code rows are
//     padded to an odd number of 16-byte units, so ldmatrix reads them
//     without bank conflicts.
//   * q.k: mma.sync m16n8k16, bf16 in, fp32 accumulate, M = 16 tokens,
//     N = 8 heads (G up to 8; 9 to 16 run as two head groups along the
//     grid's z), K = 16 channels.  ldmatrix hands lane (g, t) word t of a
//     32-channel block of tokens g and g + 8; the nibbles j and j + 4 of a
//     word become one bf16 pair by a mask, an XOR and one bf16x2 FMA
//     (codes -8..7 are exact in bf16).  A k-step's channels are a
//     permutation of its block's, so q is stored permuted to match, once,
//     in shared memory.  Both k-steps of a block lie in one scale group:
//     each block's fp32 sum is multiplied by the token's group scale and
//     the blocks are summed into the score in fp32.
//   * p.v: M = 16 channels, N = 8 heads, K = 16 tokens.  ldmatrix.trans
//     hands lane (g, t) the 4 channels 4g..4g+3 of a block for tokens 2t
//     and 2t + 1, which unpack into the token pairs the A fragment takes;
//     each block's p is multiplied by the token's V group scale first.
//   * Precision: q and p * scale are fp32.  Each enters the tensor cores
//     as three bf16 parts, hi + mid + lo == x exactly (two truncations to
//     8 significant bits leave at most 8), and the products accumulate in
//     fp32: the read's precision, not bf16's.  At G > 2 the three parts
//     are three mmas into one accumulator.  At G <= 2 (PN) they lie along
//     N instead, column 2 * part + head, so each product is one mma a
//     k-step, and the parts' fp32 sums meet by xor shuffles over a row's
//     four lanes (the scores each step, acc once at the end).
//   * Softmax: the scores move by shuffles from the C layout (tokens on
//     lanes' rows) to P's B layout (head g, tokens 2t, 2t+1, 2t+8, 2t+9);
//     one online update a head per 16 tokens, its maximum by two xor
//     shuffles, the sums rescaled only when some head's maximum grows.
//     Tokens at or past packed_len score -1e30 and their scales are zeroed
//     when the tile is copied, so they add no mass and no NaN.
//   * The warps merge through shared memory, laid over their buffers,
//     into the same (m, l, acc) partials as the first design's, so pass 2
//     and the split plan are shared.
// What bounds it now: still issue slots, not bytes (about 2.4x the byte
// bound at G = 2 and 3x at G = 5 at the benchmark's long-context shapes):
// the integer work of unpacking (two codes a shift, a LOP3 and an HFMA2,
// on the half-rate integer pipe), the three-part splits of p * scale and
// the copies' addressing; the tensor cores are far from busy.  The split
// plan also leaves a tail where rows of 2k and 9k tokens share a grid.
//
// Pass 1, first design (qda_split_kernel), for what the fragments do not
// fit: G = 1 (an MHA row fills one column of eight) and d or group not a
// multiple of 32 (zamba2-7b's d 112, group 28).
//   * Warps.  A block of NW warps gives each kTile/NW tokens of every tile
//     of its split (16 with 4 warps).  A warp copies its tokens into its own
//     double buffer and scores them, synchronising by __syncwarp alone; the
//     block meets once, at the merge.  The next tile's copies overlap the
//     current tile's math.  A one-tile split (batch 1) runs 4 warps, so
//     four blocks share an SM and the whole grid is resident at once; a
//     longer split runs 8, halving the chain of tiles each warp walks.
//   * Lanes.  A token's d/8 packed words are spread over sw lanes (a power
//     of two), WPL words a lane; a warp step scores 32/sw tokens.  WPL is
//     4 at G = 1, 2 at G = 2 (8 lanes a token at d = 128: 4 tokens a
//     step) and 1 above, so that q's and acc's 8*WPL coordinates of the
//     lane's words for every head take <= 32 registers each (64 at G > 4;
//     the kernel is instantiated for at most 1, 2, 4 or 8 heads; 9 to 16
//     heads run the 8-head code once per group of 8 along the grid's z,
//     since 16 heads' q and acc would spill).  The lane
//     dots q with its codes, scales by the token's group scale (per
//     coordinate in a second instantiation, where group % 8 != 0 and a
//     word straddles groups) and sums over the slot's lanes by xor
//     shuffles.  P.V keeps the mapping: the lanes that scored a token hold
//     its probability and accumulate their coordinates x G heads.  One
//     word a lane, the mapping first tried, spent most of each step on
//     per-token shuffles and softmax; WPL halves the steps.
//   * Unpacking (unpack8): three logic ops a word, then a byte permute and
//     an FADD a code, where a shift, a shift and a convert were.
//   * Softmax.  Every slot runs its own online softmax (m, l, acc) over
//     its tokens, updated only for tokens below packed_len (a slot with
//     none keeps l = 0, acc = 0, so no ghost mass), rescaling its sums
//     only when its maximum grows.  At the end of the split the slots
//     merge by xor shuffles and the warps through shared memory, each
//     weighted by exp(m_i - m), into the split's (m, l, acc).
//   * Copies.  Rows are stored unpadded (the lanes read consecutive
//     words, so no bank conflict) and copied by cp.async in the widest of
//     16 / 8 / 4 bytes that divides the row and both addresses: codes in 16
//     when d % 32 == 0 (8 at d = 112), scales in 16 when d/group % 4 == 0
//     (8 at d = 64, group 32).  The lanes that copy a token's four rows
//     resolve its address once (B2: one page-table load) and share it by
//     shuffle.  A deeper ring of copies measured slower (more registers),
//     so two tiles are in flight.
// What bounds the first design: instruction throughput.  A step spends
// more on per-token work (the slot shuffles, the softmax each of a token's
// lanes repeats, loop and addressing) than on unpacking and FMAs, and the
// work grows with G (padded to 8 heads above 4).
//
// At batch 1 a block also waits out one tile's copy latency, and the read
// pays for two launches and pass 2's combine of every split.  The combine
// pass stages its row's partials and residual window in shared memory with
// every load in flight at once, then reduces with warp shuffles.  expf is
// the accurate one: build without --use_fast_math.
// Not yet: TMA, one fused pass, fusing the per-token rotations into the
// read, a split plan chosen from the lengths the device holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // tokens per tile
constexpr int kMaxG = 16;                  // query heads per kv head
constexpr int kGroupG = 8;                 // of them, per pass-1 block
constexpr int kMaxD = 256;                 // head dim: 32 words a row at most
constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

// The 8 codes of a packed word as exact floats.  Code i sits in bits
// 4i..4i+3, two's complement; XOR with 0x8 makes it n = code + 8 in
// [0, 15].  The even codes, masked to the low nibble of each byte, and the
// odd ones, shifted down and masked, are each moved by one byte permute
// into the low byte of 0x4B000000, which makes the float 2^23 + n exactly;
// one FADD of -(2^23 + 8) leaves the code.  Three logic ops per word and
// a PRMT and an FADD per code, where a shift, a shift and a convert were.
__device__ __forceinline__ void unpack8(uint32_t word, float (&c)[8]) {
  const uint32_t x = word ^ 0x88888888u;
  const uint32_t ev = x & 0x0F0F0F0Fu, od = (x >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t sel = 0x7540u + b;  // byte b, then 0, 0, 0x4B
    c[2 * b] = __uint_as_float(__byte_perm(ev, 0x4B000000u, sel)) - 8388616.0f;
    c[2 * b + 1] = __uint_as_float(__byte_perm(od, 0x4B000000u, sel)) - 8388616.0f;
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
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
// one row of ``bytes`` bytes by ``vec``-byte copies (vec divides bytes and
// both addresses)
__device__ __forceinline__ void copy_row(void* dst, const void* src, int bytes,
                                         int vec) {
  char* o = static_cast<char*>(dst);
  const char* i = static_cast<const char*>(src);
  if (vec == 16) {
    for (int b = 0; b < bytes; b += 16) cp_async16(o + b, i + b);
  } else if (vec == 8) {
    for (int b = 0; b < bytes; b += 8) cp_async8(o + b, i + b);
  } else {
    for (int b = 0; b < bytes; b += 4) cp_async4(o + b, i + b);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Merge a pass-1 block's NW warps into its split's partials: each warp's
// (m, l) a head in wm / wl and its (G, d) acc in wacc, each weighted by
// exp(m_w - max_w m_w); the (m, l, acc) of heads 0..G-1 go to
// part_ml / part_acc at row ``base`` on.  One output per thread.
template <int NW>
__device__ __forceinline__ void merge_warps(const float* wacc, const float* wm,
                                            const float* wl, float* part_ml,
                                            float* part_acc, size_t base,
                                            int G, int d) {
  for (int p = threadIdx.x; p < G * d; p += NW * 32) {
    const int g = p / d, e = p % d;
    float mx = kNeg;
    for (int v = 0; v < NW; ++v) mx = fmaxf(mx, wm[v * G + g]);
    float a = 0.0f, ls = 0.0f;
    for (int v = 0; v < NW; ++v) {
      const float f = expf(wm[v * G + g] - mx);
      a = fmaf(f, wacc[(v * G + g) * d + e], a);
      ls = fmaf(f, wl[v * G + g], ls);
    }
    part_acc[(base + g) * d + e] = a;
    if (e == 0) {
      part_ml[(base + g) * 2 + 0] = mx;
      part_ml[(base + g) * 2 + 1] = ls;
    }
  }
}

// Token addresses: row index of token t of row bh in the packed (., d/2)
// and scales (., d/group) arrays.
// follow(n): whether n tokens from a multiple of n have consecutive rows.
struct DenseRows {  // B1: (BH, S, .) arrays
  int S;
  __device__ __forceinline__ size_t operator()(int bh, int t) const {
    return (size_t)bh * S + t;
  }
  __device__ __forceinline__ bool follow(int) const { return true; }
};
struct PagedRows {  // B2: (n_pages*H, ps, .) pools behind a (B, MP) table
  const int* page_table;
  int MP, H, ps;
  __device__ __forceinline__ size_t operator()(int bh, int t) const {
    const int page = page_table[(size_t)(bh / H) * MP + t / ps];
    return ((size_t)page * H + bh % H) * ps + t % ps;
  }
  __device__ __forceinline__ bool follow(int n) const { return ps % n == 0; }
};

// Pass 1: grid (BH, n_splits), or (BH, n_splits, ceil(G_row / MG)) with
// HG.  Writes part_ml[bh][split][g] = (m, l) and part_acc[bh][split][g][d]
// for the row's G_row query heads.  S is the logical length of every row.
// MG >= G bounds the per-lane arrays, WPL is the words a lane, NW the
// warps; OG: every word lies in one scale group (group % 8 == 0).  HG (head
// groups, G_row > kGroupG): block z takes heads z*MG .. z*MG + G - 1 of its
// row, so each K/V tile is read once per head group; without HG, g0 = 0
// and G = G_row fold away and the code is the one-group kernel's.
template <class Rows, int MG, int WPL, int NW, bool OG, bool HG>
__global__ void __launch_bounds__(NW * 32)
qda_split_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kp,
                 const float* __restrict__ ks, const uint8_t* __restrict__ vp,
                 const float* __restrict__ vs, const int* __restrict__ plen_rows,
                 int plen_all, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int S, int G_row, int d, int group,
                 int tiles_per_split, int code_vec, int scale_vec, Rows rows) {
  extern __shared__ __align__(16) float smem[];
  // split-major order: every row's first splits, which hold its tokens,
  // reach the SMs before the empty splits past shorter rows' ends
  const int bh = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = HG ? blockIdx.z * MG : 0;           // the block's first head
  const int G = HG ? min(MG, G_row - g0) : G_row;    // and its head count
  const int wpr = d / 8;  // 4-byte words per packed row
  const int ng = d / group;
  int sw = 1;  // lanes per token slot
  while (sw * WPL < wpr) sw <<= 1;
  const int slot = lane / sw, w0 = WPL * (lane % sw);  // the lane's first word
  const int tpw = 32 / sw;  // tokens a warp step scores
  bool live_w[WPL];  // the lane's words that exist
  int gw[WPL];       // their groups, if OG
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    live_w[k] = w0 + k < wpr;
    gw[k] = live_w[k] ? 8 * (w0 + k) / group : 0;
  }
  constexpr int TPW = kTile / NW;  // tokens per warp per tile
  constexpr int LPC = 32 / TPW;    // lanes copying one token's rows
  // this warp's two buffers, each [K codes | V codes | K scales | V scales]
  // of TPW unpadded rows; then the warps' sums for the merge
  const int buf_words = TPW * (2 * wpr + 2 * ng);
  uint32_t* wbuf = reinterpret_cast<uint32_t*>(smem) + warp * 2 * buf_words;
  float* wacc = smem + NW * 2 * buf_words;  // NW * G * d
  float* wm = wacc + NW * G * d;            // NW * G
  float* wl = wm + NW * G;                  // NW * G

  const int plen = min(plen_rows != nullptr ? plen_rows[bh] : plen_all, S);
  const int t_begin = split * tiles_per_split;
  const int t_live = min(t_begin + tiles_per_split, (plen + kTile - 1) / kTile);
  const int n_my = max(t_live - t_begin, 0);  // tiles past packed_len skipped

  // the warp's live tokens of a tile (those below packed_len): lanes
  // LPC*t .. LPC*t + LPC-1 copy token t's four rows (K codes, V codes, K
  // scales, V scales); the first resolves the token's address, once, and
  // hands it to the others
  auto copy_tile = [&](int buf, int tile) {
    const int s0 = tile * kTile + warp * TPW;
    const int n = min(TPW, plen - s0);
    const int t = lane / LPC, part = lane % LPC;
    unsigned long long r = 0;
    if (t < n && part == 0) r = rows(bh, s0 + t);
    r = __shfl_sync(kAll, r, lane - part);
    if (t < n) {
      uint32_t* b = wbuf + buf * buf_words;
      float* sc = reinterpret_cast<float*>(b + 2 * TPW * wpr);
      for (int job = part; job < 4; job += LPC) {
        const int v = job & 1;  // 0: K, 1: V
        if (job < 2)
          copy_row(b + (v * TPW + t) * wpr, (v ? vp : kp) + r * (d / 2),
                   d / 2, code_vec);
        else
          copy_row(sc + (v * TPW + t) * ng, (v ? vs : ks) + r * ng, ng * 4,
                   scale_vec);
      }
    }
  };

  // one commit group per tile, the last one empty, so that waiting for
  // all but the newest group waits for the tile about to be read
  if (n_my > 0) copy_tile(0, t_begin);
  cp_async_commit();
  float qr[MG][WPL][8];  // q's coordinates of the lane's words, every head
#pragma unroll
  for (int g = 0; g < MG; ++g)
#pragma unroll
    for (int k = 0; k < WPL; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qr[g][k][i] = g < G && live_w[k]
                          ? q[((size_t)bh * G_row + g0 + g) * d + 8 * (w0 + k) + i]
                          : 0.0f;
  float m[MG], l[MG], acc[MG][WPL][8];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int k = 0; k < WPL; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][k][i] = 0.0f;
  }
  // per-step strides in shared memory, and the lane's offsets in a buffer
  const int code_step = tpw * wpr, scale_step = tpw * ng;
  const int code_at = slot * wpr + w0, scale_at = slot * ng;

  for (int j = 0; j < n_my; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_my) copy_tile(buf ^ 1, t_begin + j + 1);  // freed at j - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // every lane's copies of this tile seen by the warp
    const int n = min(TPW, plen - ((t_begin + j) * kTile + warp * TPW));
    const uint32_t* kc = wbuf + buf * buf_words + code_at;
    const uint32_t* vc = kc + TPW * wpr;
    const float* ksc = reinterpret_cast<const float*>(
                           wbuf + buf * buf_words + 2 * TPW * wpr) + scale_at;
    const float* vsc = ksc + TPW * ng;
    for (int t = slot; t - slot < n; t += tpw) {  // n <= 0: no live token
      const bool live = t < n;  // the same for every lane of the slot
      float c[WPL][8], s[MG];
#pragma unroll
      for (int g = 0; g < MG; ++g) s[g] = 0.0f;
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        const bool mine = live && live_w[k];
        unpack8(mine ? kc[k] : 0u, c[k]);
        if (OG) {
          const float sc = mine ? ksc[gw[k]] : 0.0f;
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            float a = 0.0f;
#pragma unroll
            for (int i = 0; i < 8; ++i) a = fmaf(qr[g][k][i], c[k][i], a);
            s[g] = fmaf(a, sc, s[g]);
          }
        } else {  // the word straddles groups: a scale per coordinate
#pragma unroll
          for (int i = 0; i < 8; ++i)
            c[k][i] *= mine ? ksc[(8 * (w0 + k) + i) / group] : 0.0f;
#pragma unroll
          for (int g = 0; g < MG; ++g)
#pragma unroll
            for (int i = 0; i < 8; ++i) s[g] = fmaf(qr[g][k][i], c[k][i], s[g]);
        }
      }
      // the token's score, summed over the slot's lanes (no branch: a
      // partner in another slot adds 0)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const bool in_slot = o < sw;
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          const float other = __shfl_xor_sync(kAll, s[g], o);
          s[g] += in_slot ? other : 0.0f;
        }
      }
      if (live) {  // a slot past packed_len adds nothing
        float vsk[WPL];
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
          unpack8(live_w[k] ? vc[k] : 0u, c[k]);
          vsk[k] = 1.0f;
          if (OG) {
            vsk[k] = live_w[k] ? vsc[gw[k]] : 0.0f;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              c[k][i] *= live_w[k] ? vsc[(8 * (w0 + k) + i) / group] : 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g >= G) continue;
          if (s[g] > m[g]) {  // a new maximum: rescale the slot's sums
            const float corr = expf(m[g] - s[g]);
            m[g] = s[g];
            l[g] *= corr;
#pragma unroll
            for (int k = 0; k < WPL; ++k)
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[g][k][i] *= corr;
          }
          const float p = expf(s[g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int k = 0; k < WPL; ++k) {
            const float pv = p * vsk[k];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              acc[g][k][i] = fmaf(pv, c[k][i], acc[g][k][i]);
          }
        }
      }
      kc += code_step;
      vc += code_step;
      ksc += scale_step;
      vsc += scale_step;
    }
    __syncwarp();  // the warp is done with buf before it is refilled
  }

  // merge the slots (lanes with the same words): an empty slot has l = 0
  // and acc = 0, and weighs exp(-1e30 - m) = 0 against a live one
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < sw) continue;
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= G) continue;
      const float mo = __shfl_xor_sync(kAll, m[g], o);
      const float lo = __shfl_xor_sync(kAll, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), b = expf(mo - mn);
      l[g] = l[g] * a + lo * b;
      m[g] = mn;
#pragma unroll
      for (int k = 0; k < WPL; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ao = __shfl_xor_sync(kAll, acc[g][k][i], o);
          acc[g][k][i] = acc[g][k][i] * a + ao * b;
        }
    }
  }
  if (lane < sw) {  // slot 0 holds the warp's sums now
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        if (!live_w[k]) continue;
        float4* dst = reinterpret_cast<float4*>(wacc + (warp * G + g) * d +
                                                8 * (w0 + k));
        dst[0] = make_float4(acc[g][k][0], acc[g][k][1], acc[g][k][2], acc[g][k][3]);
        dst[1] = make_float4(acc[g][k][4], acc[g][k][5], acc[g][k][6], acc[g][k][7]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= G) continue;
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  merge_warps<NW>(wacc, wm, wl, part_ml, part_acc,
                  ((size_t)bh * n_splits + split) * G_row + g0, G, d);
}

// ---- pass 1 on the tensor cores ----

constexpr int kStep = 16;  // tokens a warp reads a step (the mma's M)

// Nibble j of each 16-bit half of w, as bf16 pair of its code: the mask
// and the XOR (one LOP3) make 0x4300 | (n ^ 8), the bf16 of 136 + code,
// and one bf16x2 FMA subtracts 136.  Exact: the codes are -8..7.
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int j) {
  const uint32_t biased = ((w >> (4 * j)) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // x * 1 - 136
  return out;
}

// x0 and x1 as three bf16 pairs (x0 in the low halves) with
// hi + mid + lo == x exactly: hi is x truncated to its top 16 bits, mid
// the remainder's, and what is left has at most 8 significant bits.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  uint32_t a = __float_as_uint(x0), b = __float_as_uint(x1);
  hi = __byte_perm(a, b, 0x7632);
  x0 -= __uint_as_float(a & 0xFFFF0000u);
  x1 -= __uint_as_float(b & 0xFFFF0000u);
  a = __float_as_uint(x0);
  b = __float_as_uint(x1);
  mid = __byte_perm(a, b, 0x7632);
  x0 -= __uint_as_float(a & 0xFFFF0000u);
  x1 -= __uint_as_float(b & 0xFFFF0000u);
  lo = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// Part ``part`` (0 hi, 1 mid, 2 lo) of split3's, or 0 for part 3.
__device__ __forceinline__ uint32_t pick_part(uint32_t hi, uint32_t mid,
                                              uint32_t lo, int part) {
  return part == 0 ? hi : part == 1 ? mid : part == 2 ? lo : 0u;
}

// c += a (16 x 16, row-major) * b (16 x 8): bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8 x 8 matrices of 16-bit units, rows at the addresses lanes 0-7 and
// 8-15 give: lane (g, t) gets units 2t, 2t+1 of row g (trans: units g of
// rows 2t, 2t+1).
__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1,
                                      const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(s) : "memory");
}
__device__ __forceinline__ void ldsm2_trans(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(s) : "memory");
}

// Pass 1 on the tensor cores: grid (BH, n_splits, ceil(G_row / 8)); block
// z takes heads 8z .. 8z + G - 1 of its row.  Writes the partials of
// qda_split_kernel.  NB >= d / 32 bounds the 32-channel blocks a row has.
// Lane (g, t) = (lane / 4, lane % 4) in the mma's fragments.  Shared
// memory: q's fragments, then each warp's two buffers of kStep tokens
// ([K codes | V codes], rows of ``pitch`` bytes, then [K | V] scales),
// later overlaid by the warps' (acc, m, l) for the merge.  PN (G <= 2):
// the three parts of q and of p * scale lie along the mma's N, column
// 2 * part + head, so each product takes one mma a k-step, not three, and
// the parts' sums meet by xor shuffles over the four lanes of a row.
template <class Rows, int NW, int NB, bool PN>
__global__ void __launch_bounds__(NW * 32, NW < 16 ? (NB <= 4 ? 16 : 8) / NW : 1)
qda_split_kernel_tc(const float* __restrict__ q,
                    const uint8_t* __restrict__ kp,
                    const float* __restrict__ ks,
                    const uint8_t* __restrict__ vp,
                    const float* __restrict__ vs,
                    const int* __restrict__ plen_rows, int plen_all,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int S, int G_row, int d, int group, int tiles_per_split,
                    int code_vec, int scale_vec, Rows rows) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int bh = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int g0 = blockIdx.z * kGroupG, G = min(kGroupG, G_row - g0);
  const int nb = d / 32, ng = d / group;
  const int pitch = 16 * (nb | 1);  // an odd number of 16-byte units
  const int stage = 2 * kStep * pitch + 2 * kStep * ng * 4;
  constexpr int QP = PN ? 1 : 3;  // q's parts a k-step and lane holds
  const int qf_bytes = 2 * nb * QP * 32 * 8;
  // q's fragment of k-step k, part p (0 hi, 1 mid, 2 lo) for lane L:
  // qf[(k * 3 + p) * 32 + L]; PN: lane L's one part, qf[k * 32 + L]
  uint2* qf = reinterpret_cast<uint2*>(tc_smem);
  unsigned char* wbuf = tc_smem + qf_bytes + warp * 2 * stage;
  float* wacc = reinterpret_cast<float*>(tc_smem + qf_bytes);  // NW * G * d
  float* wm = wacc + NW * G * d;                                // NW * G
  float* wl = wm + NW * G;                                      // NW * G

  const int plen = min(plen_rows != nullptr ? plen_rows[bh] : plen_all, S);
  const int t_begin = split * tiles_per_split;
  const int t_live = min(t_begin + tiles_per_split, (plen + kTile - 1) / kTile);
  // warp w reads quarter w % 4 of tiles t_begin + w / 4, + NW / 4, ...
  constexpr int TS = NW / 4;
  const int wq = warp % 4, wp = warp / 4;
  const int n_my = max(t_live - t_begin - wp + TS - 1, 0) / TS;
  auto first_token = [&](int i) {
    return (t_begin + wp + TS * i) * kTile + wq * kStep;
  };

  // A step's rows.  Where they follow (dense rows, or pages that hold
  // whole steps) token k's row is the step's first row + k, looked up a
  // step before its copy, so that the page-table load is in flight while
  // the warp computes; otherwise each token's row is looked up at its copy.
  // Lane L copies 16-byte chunk L % nb of token L / nb, then of the tokens
  // tpi, 2 tpi, ... after it, so that a warp instruction reads whole lines;
  // lanes 2k and 2k + 1 copy token k's K and V scales.  A token at or past
  // packed_len gets zero scales.
  const bool follow = rows.follow(kStep);
  const int tpi = 32 / nb, ck = lane / nb, cpart = lane % nb;
  const int tk = lane / 2, v = lane % 2;
  auto step_row = [&](int i) -> unsigned long long {
    const int t0 = first_token(i);
    return follow && i < n_my && t0 < plen ? rows(bh, t0) : 0;
  };
  auto copy_step = [&](int buf, int i, unsigned long long r0) {
    const int s0 = first_token(i);
    const int n = min(kStep, plen - s0);
    auto row = [&](int k) -> unsigned long long {
      return follow ? r0 + k : rows(bh, s0 + k);
    };
    unsigned char* b = wbuf + buf * stage;
    if (lane < tpi * nb)
      for (int k = ck; k < n; k += tpi) {
        const size_t at = row(k) * (d / 2) + 16 * cpart;
        copy_row(b + k * pitch + 16 * cpart, kp + at, 16, code_vec);
        copy_row(b + (kStep + k) * pitch + 16 * cpart, vp + at, 16, code_vec);
      }
    float* sc = reinterpret_cast<float*>(b + 2 * kStep * pitch) +
                (v * kStep + tk) * ng;
    if (tk < n)
      copy_row(sc, (v ? vs : ks) + row(tk) * ng, ng * 4, scale_vec);
    else
      for (int e = 0; e < ng; ++e) sc[e] = 0.0f;
  };

  // one commit group per step, the last one empty, as qda_split_kernel's
  unsigned long long r_next = step_row(0);
  if (n_my > 0) copy_step(0, 0, r_next);
  cp_async_commit();
  r_next = step_row(1);
  // q's B fragments: k-step k = 2s + h, lane (gq, tq) holds head gq's
  // (PN: part gq / 2 of head gq % 2's) channels 32s + 8tq + 2h + {0, 4}
  // and + {1, 5}: the channels of the codes code_pair gives lane tq from
  // word tq of block s
  for (int i = tid; i < 2 * nb * 32; i += NW * 32) {
    const int k = i / 32, L = i % 32, gq = L / 4, tq = L % 4;
    const int c = 32 * (k / 2) + 8 * tq + 2 * (k % 2);
    const int hq = PN ? gq % 2 : gq;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (hq < G) {
      const float* qh = q + ((size_t)bh * G_row + g0 + hq) * d + c;
      x[0] = qh[0]; x[1] = qh[4]; x[2] = qh[1]; x[3] = qh[5];
    }
    uint32_t hi[2], mid[2], lo[2];
    split3(x[0], x[1], hi[0], mid[0], lo[0]);
    split3(x[2], x[3], hi[1], mid[1], lo[1]);
    if (PN) {
      qf[k * 32 + L] = make_uint2(pick_part(hi[0], mid[0], lo[0], gq / 2),
                                  pick_part(hi[1], mid[1], lo[1], gq / 2));
    } else {
      qf[(k * 3 + 0) * 32 + L] = make_uint2(hi[0], hi[1]);
      qf[(k * 3 + 1) * 32 + L] = make_uint2(mid[0], mid[1]);
      qf[(k * 3 + 2) * 32 + L] = make_uint2(lo[0], lo[1]);
    }
  }
  __syncthreads();

  // head g's running max, this lane's share of its sum, and acc: channel
  // 32s + 4g + 2h (rows g) and + 1 (rows g + 8) of heads 2t, 2t + 1
  float m = kNeg, l = 0.0f, acc[NB][2][4];
#pragma unroll
  for (int s = 0; s < NB; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][h][e] = 0.0f;
  // P's B fragment: head g, tokens 2t, 2t + 1, 2t + 8, 2t + 9 of the step
  const int tok[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
  const int row_at = (lane % 16) * pitch;  // the row lane gives ldmatrix
  // offsets into a step's scales: K of tokens g and g + 8, V of tok, and
  // each block's group
  const int ko0 = g * ng, ko1 = (g + 8) * ng;
  int vo[4], sg[NB];
#pragma unroll
  for (int e = 0; e < 4; ++e) vo[e] = tok[e] * ng;
#pragma unroll
  for (int s = 0; s < NB; ++s) sg[s] = 32 * s / group;

  for (int i = 0; i < n_my; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_my) copy_step(buf ^ 1, i + 1, r_next);  // freed at i - 1
    cp_async_commit();
    r_next = step_row(i + 2);
    cp_async_wait<1>();
    __syncwarp();  // every lane's copies of this step seen by the warp
    const int n = min(kStep, plen - first_token(i));
    if (n > 0) {
      const unsigned char* kc = wbuf + buf * stage;
      const unsigned char* vc = kc + kStep * pitch;
      const float* ksc = reinterpret_cast<const float*>(kc + 2 * kStep * pitch);
      const float* vsc = ksc + kStep * ng;
      // q.k: C rows tokens g and g + 8, columns heads 2t and 2t + 1 (PN:
      // part t of heads 0 and 1)
      float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        if (s >= nb) break;
        uint32_t ka, kb;  // word t of block s of tokens g and g + 8
        ldsm2(ka, kb, kc + row_at + 16 * s);
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a[4] = {code_pair(ka, 2 * h), code_pair(kb, 2 * h),
                                 code_pair(ka, 2 * h + 1),
                                 code_pair(kb, 2 * h + 1)};
          if (PN) {
            const uint2 b = qf[(2 * s + h) * 32 + lane];
            mma_bf16(c, a, b.x, b.y);
          } else {
#pragma unroll
            for (int part = 2; part >= 0; --part) {
              const uint2 b = qf[((2 * s + h) * 3 + part) * 32 + lane];
              mma_bf16(c, a, b.x, b.y);
            }
          }
        }
        const float k0 = ksc[ko0 + sg[s]], k1 = ksc[ko1 + sg[s]];
        sc[0] = fmaf(c[0], k0, sc[0]);
        sc[1] = fmaf(c[1], k0, sc[1]);
        sc[2] = fmaf(c[2], k1, sc[2]);
        sc[3] = fmaf(c[3], k1, sc[3]);
      }
      // to P's layout: lane 8t + g/2 holds tokens 2t and 2t + 8 of heads
      // g & ~1 and g | 1, lane 8t + 4 + g/2 tokens 2t + 1 and 2t + 9.
      // PN: the parts summed over a row's lanes, lane t & 1 of quad 2t
      // (2t + 1) gives head g & 1's tokens 2t and 2t + 8 (2t + 1, 2t + 9)
      float x[4];
      if (PN) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[e] += __shfl_xor_sync(kAll, sc[e], 1);
          sc[e] += __shfl_xor_sync(kAll, sc[e], 2);
        }
        const float s0 = t & 1 ? sc[1] : sc[0], s2 = t & 1 ? sc[3] : sc[2];
        const int src = 8 * t + (g & 1);
        x[0] = __shfl_sync(kAll, s0, src);
        x[1] = __shfl_sync(kAll, s0, src + 4);
        x[2] = __shfl_sync(kAll, s2, src);
        x[3] = __shfl_sync(kAll, s2, src + 4);
      } else {
        const int src = 8 * t + g / 2;
        const bool odd = g & 1;
        float a[4], b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = __shfl_sync(kAll, sc[e], src);
          b[e] = __shfl_sync(kAll, sc[e], src + 4);
        }
        x[0] = odd ? a[1] : a[0];
        x[1] = odd ? b[1] : b[0];
        x[2] = odd ? a[3] : a[2];
        x[3] = odd ? b[3] : b[2];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = tok[e] < n ? x[e] : kNeg;
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 2));
      const float m_new = fmaxf(m, mx);
      if (__any_sync(kAll, m_new > m)) {  // a new maximum: rescale the sums
        const float corr = expf(m - m_new);
        l *= corr;
        const int h0 = PN ? 0 : 8 * t;  // a lane of head 2t (PN: head 0)
        const float c0 = __shfl_sync(kAll, corr, h0);
        const float c1 = __shfl_sync(kAll, corr, h0 + 4);  // the next head
#pragma unroll
        for (int s = 0; s < NB; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[s][h][0] *= c0;
            acc[s][h][1] *= c1;
            acc[s][h][2] *= c0;
            acc[s][h][3] *= c1;
          }
        m = m_new;
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(x[e] - m);  // 0 past plen
      l += (p[0] + p[1]) + (p[2] + p[3]);
      // p.v: A rows channels, columns tokens; B = p * the V group scale
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        if (s >= nb) break;
        uint32_t hi[2], mid[2], lo[2];
        split3(__fmul_rn(p[0], vsc[vo[0] + sg[s]]),
               __fmul_rn(p[1], vsc[vo[1] + sg[s]]), hi[0], mid[0], lo[0]);
        split3(__fmul_rn(p[2], vsc[vo[2] + sg[s]]),
               __fmul_rn(p[3], vsc[vo[3] + sg[s]]), hi[1], mid[1], lo[1]);
        uint32_t va, vb;  // channels 4g..4g+3 of block s, tokens 2t, 2t+1
        ldsm2_trans(va, vb, vc + row_at + 16 * s);  // and 2t + 8, 2t + 9
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a[4] = {code_pair(va, 2 * h), code_pair(va, 2 * h + 1),
                                 code_pair(vb, 2 * h),
                                 code_pair(vb, 2 * h + 1)};
          if (PN) {  // column g: part g / 2 of head g & 1
            mma_bf16(acc[s][h], a, pick_part(hi[0], mid[0], lo[0], g / 2),
                     pick_part(hi[1], mid[1], lo[1], g / 2));
          } else {
            mma_bf16(acc[s][h], a, lo[0], lo[1]);
            mma_bf16(acc[s][h], a, mid[0], mid[1]);
            mma_bf16(acc[s][h], a, hi[0], hi[1]);
          }
        }
      }
    }
    __syncwarp();  // the warp is done with buf before it is refilled
  }

  l += __shfl_xor_sync(kAll, l, 1);  // head g's sum over the warp's tokens
  l += __shfl_xor_sync(kAll, l, 2);
  if (PN)  // acc's parts, summed over a row's lanes: lane t = 0 writes
#pragma unroll
    for (int s = 0; s < NB; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[s][h][e] += __shfl_xor_sync(kAll, acc[s][h][e], 1);
          acc[s][h][e] += __shfl_xor_sync(kAll, acc[s][h][e], 2);
        }
  __syncthreads();  // every warp is done with its buffers, which wacc overlays
  if (g < G && t == 0) {
    wm[warp * G + g] = m;
    wl[warp * G + g] = l;
  }
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    if (s >= nb) break;
    const int e = 32 * s + 4 * g;
    if (2 * t < G)
      *reinterpret_cast<float4*>(wacc + (warp * G + 2 * t) * d + e) =
          make_float4(acc[s][0][0], acc[s][0][2], acc[s][1][0], acc[s][1][2]);
    if (2 * t + 1 < G)
      *reinterpret_cast<float4*>(wacc + (warp * G + 2 * t + 1) * d + e) =
          make_float4(acc[s][0][1], acc[s][0][3], acc[s][1][1], acc[s][1][3]);
  }
  __syncthreads();
  merge_warps<NW>(wacc, wm, wl, part_ml, part_acc,
                  ((size_t)bh * n_splits + split) * G_row + g0, G, d);
}

// Pass 2: one block per row.  Stages the row's partials and residual
// window in shared memory (every load in flight at once), combines the
// partials, folds in the residual window, normalizes; with a non-null lse,
// stores each (row, head)'s log-sum-exp too.
__global__ void __launch_bounds__(kThreads)
qda_combine_kernel(const float* __restrict__ q, const float* __restrict__ kr,
                   const float* __restrict__ vr, const int* __restrict__ plen_rows,
                   const int* __restrict__ tlen_rows, int plen_all, int tlen_all,
                   const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, float* __restrict__ out,
                   float* __restrict__ lse, int n_splits, int G, int d, int W) {
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
      // stored only when asked for: a null lse computes and stores what
      // the read stored before the output existed
      if (lse != nullptr) lse[(size_t)bh * G + g] = m_new + logf(lp[g]);
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

// the widest cp.async (16, 8 or 4 bytes) that divides a row of ``bytes``
// bytes and the addresses of both arrays
int copy_width(int bytes, const void* a, const void* b) {
  for (int v = 16; v > 4; v /= 2)
    if (bytes % v == 0 && (uintptr_t)a % v == 0 && (uintptr_t)b % v == 0)
      return v;
  return 4;
}

// Pass 1 for at most MG query heads a block, WPL words a lane, NW warps;
// HG: ceil(G / MG) head groups along the grid's z.  Its shared memory: each
// warp's two buffers of kTile/NW unpadded K and V code and scale rows, then
// the warps' (acc, m, l) for the merge.
template <class Rows, int MG, int WPL, int NW, bool OG, bool HG>
cudaError_t launch_split(const float* q, const uint8_t* kp, const float* ks,
                         const uint8_t* vp, const float* vs,
                         const int* plen_rows, int plen, float* part_ml,
                         float* part_acc, int BH, int S, int G, int d,
                         int group, int n_splits, int tiles_per_split,
                         Rows rows, cudaStream_t st) {
  static int smem_have = 0;  // the one record of this instantiation
  const int wpr = d / 8, ng = d / group;
  const int gb = HG ? MG : G;  // heads a block merges
  const size_t words = 2 * (size_t)kTile * (2 * wpr + 2 * ng) +
                       (size_t)NW * gb * (d + 2);
  const int smem = (int)(words * sizeof(float));
  cudaError_t err = allow_smem(qda_split_kernel<Rows, MG, WPL, NW, OG, HG>,
                               smem, &smem_have);
  if (err != cudaSuccess) return err;
  qda_split_kernel<Rows, MG, WPL, NW, OG, HG>
      <<<dim3(BH, n_splits, HG ? (G + MG - 1) / MG : 1), NW * 32, smem, st>>>(
          q, kp, ks, vp, vs, plen_rows, plen, part_ml, part_acc, S, G, d,
          group, tiles_per_split, copy_width(d / 2, kp, vp),
          copy_width(ng * 4, ks, vs), rows);
  return cudaGetLastError();
}

// A split of one tile (batch 1) runs 4 warps, so that four blocks share an
// SM; a longer split runs 8, halving the chain of tiles each warp walks.
// B1 on B2's gathered view plans the same splits, so picks the same code.
template <class Rows, int MG, int WPL, bool HG>
cudaError_t launch_split_nw(const float* q, const uint8_t* kp,
                            const float* ks, const uint8_t* vp,
                            const float* vs, const int* plen_rows, int plen,
                            float* part_ml, float* part_acc, int BH, int S,
                            int G, int d, int group, int n_splits,
                            int tiles_per_split, Rows rows, cudaStream_t st) {
  const bool og = group % 8 == 0;
  auto split = tiles_per_split > 1
                   ? (og ? launch_split<Rows, MG, WPL, 8, true, HG>
                         : launch_split<Rows, MG, WPL, 8, false, HG>)
                   : (og ? launch_split<Rows, MG, WPL, 4, true, HG>
                         : launch_split<Rows, MG, WPL, 4, false, HG>);
  return split(q, kp, ks, vp, vs, plen_rows, plen, part_ml, part_acc, BH, S,
               G, d, group, n_splits, tiles_per_split, rows, st);
}

// The tensor-core pass 1 with NW warps for rows of at most 32 * NB
// channels, q's parts along N where PN.  Its shared memory: q's fragments,
// then the larger of the warps' double buffers and their (acc, m, l) for
// the merge.
template <class Rows, int NW, int NB, bool PN>
cudaError_t launch_split_tc(const float* q, const uint8_t* kp,
                            const float* ks, const uint8_t* vp,
                            const float* vs, const int* plen_rows, int plen,
                            float* part_ml, float* part_acc, int BH, int S,
                            int G, int d, int group, int n_splits,
                            int tiles_per_split, Rows rows, cudaStream_t st) {
  static int smem_have = 0;  // the one record of this instantiation
  const int nb = d / 32, ng = d / group, gb = G < kGroupG ? G : kGroupG;
  const size_t stage = 2 * kStep * 16 * (nb | 1) + 2 * kStep * ng * 4;
  const size_t bufs = NW * 2 * stage;
  const size_t merge = (size_t)NW * gb * (d + 2) * sizeof(float);
  const int smem = (int)(2 * nb * (PN ? 1 : 3) * 32 * 8 +
                         (bufs > merge ? bufs : merge));
  cudaError_t err = allow_smem(qda_split_kernel_tc<Rows, NW, NB, PN>, smem,
                               &smem_have);
  if (err != cudaSuccess) return err;
  qda_split_kernel_tc<Rows, NW, NB, PN>
      <<<dim3(BH, n_splits, (G + kGroupG - 1) / kGroupG), NW * 32, smem,
         st>>>(q, kp, ks, vp, vs, plen_rows, plen, part_ml, part_acc, S, G,
               d, group, tiles_per_split, copy_width(d / 2, kp, vp),
               copy_width(ng * 4, ks, vs), rows);
  return cudaGetLastError();
}

// Which pass 1 a shape takes (ops.tensor_core_pass mirrors it): the
// tensor cores where the fragments fit, G >= 2 heads and 32-channel
// blocks each inside one scale group; the first design otherwise.
bool tensor_core_pass(int G, int d, int group) {
  return G >= 2 && d % 32 == 0 && group % 32 == 0;
}

// The two passes; Rows picks B1's or B2's token address.  Returns
// cudaGetLastError() after the launches.
template <class Rows>
int launch_passes(const float* q, const uint8_t* kp, const float* ks,
                  const uint8_t* vp, const float* vs, const float* kr,
                  const float* vr, const int* plen_rows, const int* tlen_rows,
                  int plen, int tlen, float* part_ml, float* part_acc,
                  float* out, float* lse, int BH, int S, int G, int d,
                  int group, int W,
                  int n_splits, int tiles_per_split, Rows rows,
                  cudaStream_t st) {
  if (BH <= 0) return 0;
  if (G < 1 || G > kMaxG || d > kMaxD || d % 8 || group <= 0 || d % group ||
      n_splits < 1 || W < 0)
    return (int)cudaErrorInvalidValue;
  // G > 8: the 8-head code, once per head group (grid z); as
  // launch_split_nw, 4 warps for a one-tile split and 8 for longer ones
  auto split =
      tensor_core_pass(G, d, group)
          ? (d > 128 ? (tiles_per_split > 1
                            ? launch_split_tc<Rows, 8, 8, false>
                            : launch_split_tc<Rows, 4, 8, false>)
             : G <= 2 ? (tiles_per_split >= 8 ? launch_split_tc<Rows, 16, 4, true>
                         : tiles_per_split > 1 ? launch_split_tc<Rows, 8, 4, true>
                                               : launch_split_tc<Rows, 4, 4, true>)
             : tiles_per_split >= 8 ? launch_split_tc<Rows, 16, 4, false>
             : tiles_per_split > 1  ? launch_split_tc<Rows, 8, 4, false>
                                    : launch_split_tc<Rows, 4, 4, false>)
      : G <= 1       ? launch_split_nw<Rows, 1, 4, false>
      : G <= 2       ? launch_split_nw<Rows, 2, 2, false>
      : G <= 4       ? launch_split_nw<Rows, 4, 1, false>
      : G <= kGroupG ? launch_split_nw<Rows, kGroupG, 1, false>
                     : launch_split_nw<Rows, kGroupG, 1, true>;
  cudaError_t err = split(q, kp, ks, vp, vs, plen_rows, plen, part_ml,
                          part_acc, BH, S, G, d, group, n_splits,
                          tiles_per_split, rows, st);
  if (err != cudaSuccess) return (int)err;
  const size_t words2 = (size_t)n_splits * G * (d + 3) + 2 * (size_t)W * d +
                        (size_t)G * W + 3 * G;
  const int smem2 = (int)(words2 * sizeof(float));
  err = allow_smem(qda_combine_kernel, smem2, &combine_smem_have);
  if (err != cudaSuccess) return (int)err;
  qda_combine_kernel<<<BH, kThreads, smem2, st>>>(
      q, kr, vr, plen_rows, tlen_rows, plen, tlen, part_ml, part_acc, out,
      lse, n_splits, G, d, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B1.  q: (BH, G, d) f32; kp/vp: (BH, S, d/2) u8; ks/vs: (BH, S, d/group)
// f32; kr/vr: (BH, W, d) f32; plen_rows/tlen_rows: (BH,) i32 or null (then
// the scalars apply to every row); part_ml: (BH, n_splits, G, 2) f32 and
// part_acc: (BH, n_splits, G, d) f32 scratch; out: (BH, G, d) f32; lse:
// (BH, G) f32 or null (then no log-sum-exp is stored).
int quant_decode_attention_launch(
    const float* q, const uint8_t* kp, const float* ks, const uint8_t* vp,
    const float* vs, const float* kr, const float* vr, const int* plen_rows,
    const int* tlen_rows, int plen, int tlen, float* part_ml, float* part_acc,
    float* out, float* lse, int BH, int S, int G, int d, int group, int W,
    int n_splits, int tiles_per_split, void* stream) {
  return launch_passes(q, kp, ks, vp, vs, kr, vr, plen_rows, tlen_rows, plen,
                       tlen, part_ml, part_acc, out, lse, BH, S, G, d, group,
                       W, n_splits, tiles_per_split, DenseRows{S},
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
                       part_ml, part_acc, out, nullptr, BH, MP * ps, G, d,
                       group, W, n_splits, tiles_per_split,
                       PagedRows{page_table, MP, H, ps},
                       (cudaStream_t)stream);
}

const char* quant_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
