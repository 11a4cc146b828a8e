// Word2vec skip-gram chunk update for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_word2vec.py:
// _kernel (:91), launched by fused_chunk_update (:207, pallas_call at :236),
// and the apply that follows it there (:272-278).
//
// What it computes, for one chunk of B (input, target) pairs at rate alpha,
// with every table read as it stood at the start of the chunk:
//   l1 = syn0[input]
//   hierarchical softmax, for each level l with m = mask[b,l] * pmask[b] != 0:
//     f = l1 . syn1[points[b,l]];  g = (1 - codes[b,l] - sigmoid(f)) * alpha * m
//     neu_hs += g * syn1[point];   syn1[point] gets (g * l1, count m)
//   negative sampling, for k = 0..K with row = target (label 1), then
//   negs[b,k-1] (label 0), valid = pmask[b] (0 for a negative equal to its
//   target):
//     f = l1 . syn1neg[row];  g = (label - sigmoid(f)) * alpha * valid
//     neu_ng += g * syn1neg[row];  syn1neg[row] gets (g * l1, count valid)
//   syn0[input] gets (neu_hs, count 1) when any level is live and
//   (neu_ng, count pmask) when K > 0 and pmask != 0;
// then every touched row of each table takes syn += sum / max(count, 1),
// per objective for syn0, IN PLACE.  An untouched row has count 0 and sum 0,
// so updating only the touched rows is the whole function.
//
// Bound on an H100 SXM: bytes.  The least work is each touched table row read
// once and written once plus the chunk's index arrays (about 1.5 FLOP a byte
// at D=100, far below the 67 TFLOP/s fp32 ridge).  Tensor cores do not help:
// each product is a D=100 fp32 dot against a gathered row, and the fp32
// tolerances rule out TF32.  What held the earlier design back was not bytes
// but L2 atomic throughput: one fp32 atomic per column per (pair, partner),
// about 28 M a text8 chunk, the same rate whether the tables sat in L2 or
// not, plus dense [V, D+1] accumulators zeroed and applied over whole tables.
//
// Design: destination-owned row reductions (row_segments.cuh).
// - phase A, w2v_phase_a_kernel, two kinds of blocks in one grid:
//   - hit counting (count_hits), one thread per potential hit: count the
//     hit into its destination row, one integer atomic a warp and row
//     (the earlier design issued 28 M fp32 atomics a text8 chunk).  Which
//     hits live follows from the inputs alone, so this runs beside the
//     scores and keeps the atomics' round trips off their chains;
//   - scores (score_pairs): one warp per pair, D across the lanes (column
//     lane + 32 j), l1 and both neu sums in registers, the indices loaded
//     by the lanes up front and the partner rows gathered a few at a time
//     so their loads overlap; every live (pair, partner)'s (g, count
//     weight) goes to a [B, L] / [B, K+1] buffer and the neu sums to a
//     [B, 2, D] buffer, with plain stores.
// - scan and scatter (row_segments.cuh): the hits of every touched row of
//   syn1 (keyed by points), syn1neg (by target and negatives) and syn0 (by
//   input, one hit per live objective) become a contiguous list, cut into
//   segments of at most `seg` hits.
// - phase C, w2v_reduce_syn_kernel (syn1 and syn1neg), then
//   w2v_reduce_syn0_kernel: one warp per segment sums g * l1 (or the neu
//   rows) in registers, gathering the rows through a cp.async ring, and
//   writes the row once.  A row of more than `seg` hits (the Huffman root
//   gets one a pair) is split across warps whose partials meet in scratch
//   with one atomic per column a segment; the last to arrive applies it.
//   syn1 and syn1neg go first because they read syn0's chunk-start rows;
//   syn0 goes last because it reads only the neu buffer.
// - rows wider than 512 floats: phase A keeps neu in the [B, 2, D] buffer and
//   re-reads l1 per partner (score_pairs_wide); phase C walks the row in
//   512-column windows.
// The TPU kernel's one-hot matrix products, bf16 table casts and dense
// [BLK, V] score planes are not carried over: they existed because VMEM held
// the tables.

#include <cuda_runtime.h>

#include "row_segments.cuh"

namespace {

using rowseg::HitInfo;
using rowseg::kFull;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct W2vParams {
  float* syn0;
  float* syn1;
  float* syn1neg;
  const int* inputs;
  const int* targets;
  const float* pmask;
  const float* codes;
  const int* points;
  const float* mask;
  const int* negs;
  float2* g_hs;   // [B, L]: (g, count weight) of each live HS level
  float2* g_ng;   // [B, K+1]: (g, count weight) of each live partner
  float* neu;     // [B, 2, D]: (neu_hs | neu_ng) of each pair
  int B, L, K, D, V0, V1, Vn;  // L = 0 without HS
  float alpha;
};

// tables: 0 = syn1 (ids b * L + l), 1 = syn1neg (ids b * (K+1) + k),
// 2 = syn0 (ids b * 2 + objective)
using W2vTables = rowseg::Tables<3>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float score(float dot, float label, float w,
                                       float alpha) {
  return (label - 1.f / (1.f + expf(-dot))) * alpha * w;
}

// Pair b's input row, or -1 when it is out of range and the pair dropped.
__device__ __forceinline__ int pair_input(const W2vParams& p, int b) {
  const int inp = p.inputs[b];
  return inp >= 0 && inp < p.V0 ? inp : -1;
}

// HS level (point pt, m = mask * pmask, code): its syn1 row, or -1 when
// the level is no hit; *w = m (nonzero makes syn0's HS hit live even when
// the point is out of range, as the plain twin counts it), *label = 1 -
// code.
__device__ __forceinline__ int hs_rule(const W2vParams& p, int pt, float m,
                                       float code, float* w, float* label) {
  *w = m;
  *label = 1.f - code;
  return m != 0.f && pt >= 0 && pt < p.V1 ? pt : -1;
}

__device__ __forceinline__ int hs_row(const W2vParams& p, int b, int l,
                                      float pm, float* w, float* label) {
  const int id = b * p.L + l;
  return hs_rule(p, p.points[id], p.mask[id] * pm, p.codes[id], w, label);
}

// Negative-sampling partner k (row = the target for k = 0, else negative
// k - 1): its syn1neg row, or -1 when it is no hit; *w = pmask, *label = 1
// for the target, 0 for a negative.
__device__ __forceinline__ int neg_rule(const W2vParams& p, int k, int row,
                                        int tgt, float pm, float* w,
                                        float* label) {
  *w = pm;
  *label = k == 0 ? 1.f : 0.f;
  if (pm == 0.f || (k > 0 && row == tgt)) return -1;  // a collision: no hit
  return row >= 0 && row < p.Vn ? row : -1;
}

__device__ __forceinline__ int neg_input(const W2vParams& p, int b, int k,
                                         int tgt) {
  return k == 0 ? tgt : p.negs[static_cast<size_t>(b) * p.K + k - 1];
}

// Whether pair b's HS objective is live: some level has mask * pmask != 0.
__device__ __forceinline__ bool hs_live(const W2vParams& p, int b, float pm) {
  bool live = false;
#pragma unroll 4
  for (int l = 0; l < p.L; ++l) live |= p.mask[b * p.L + l] * pm != 0.f;
  return live;
}

// The histogram: every potential hit of the three tables is counted into
// its destination row.  It needs no score, so it runs beside the scores
// (in blocks of its own, see w2v_phase_a_kernel) and keeps the atomics'
// round trips off the score chains.  Thread t of a table takes level (or
// partner, or objective) t / B of pair t % B, so a warp's lanes share a
// level and the rows they share (the root at level 0, a center's target)
// take one atomic a warp.
__device__ __forceinline__ void count_hits(const W2vParams& p,
                                           const W2vTables& ts, int block,
                                           int n_blocks) {
  const int lane = threadIdx.x & 31;
  const int warp0 = block * kWarps + (threadIdx.x >> 5);
  const int stride = n_blocks * kWarps * 32;
  const int K1 = p.K > 0 ? p.K + 1 : 0;
  float w, label;
  for (int t0 = warp0 * 32; t0 < p.B * p.L; t0 += stride) {
    const int t = t0 + lane, l = t / p.B, b = t - l * p.B;
    const bool live = t < p.B * p.L;
    const int row = live && pair_input(p, b) >= 0
                        ? hs_row(p, b, l, p.pmask[b], &w, &label)
                        : -1;
    rowseg::record_hit_warp(ts.t[0], b * p.L + l, row, live);
  }
  for (int t0 = warp0 * 32; t0 < p.B * K1; t0 += stride) {
    const int t = t0 + lane, k = t / p.B, b = t - k * p.B;
    const bool live = t < p.B * K1;
    int row = -1;
    if (live && pair_input(p, b) >= 0) {
      const int tgt = p.targets[b];
      row = neg_rule(p, k, neg_input(p, b, k, tgt), tgt, p.pmask[b], &w,
                     &label);
    }
    rowseg::record_hit_warp(ts.t[1], b * K1 + k, row, live);
  }
  for (int t0 = warp0 * 32; t0 < 2 * p.B; t0 += stride) {
    const int t = t0 + lane, obj = t / p.B, b = t - obj * p.B;
    const bool live = t < 2 * p.B;
    const int inp = live ? pair_input(p, b) : -1;
    const float pm = inp >= 0 ? p.pmask[b] : 0.f;
    const bool hit = inp >= 0 && (obj ? p.K > 0 && pm != 0.f
                                      : hs_live(p, b, pm));
    rowseg::record_hit_warp(ts.t[2], b * 2 + obj, hit ? inp : -1, live);
  }
}

// Phase A's grid: n_hit blocks that count hits spread evenly among the
// blocks that score pairs, so both run from the start.  Returns the role
// of this block: its index among the hit blocks (*hit = true) or among
// the score blocks.
__device__ __forceinline__ int phase_a_role(int n_hit, bool* hit) {
  const int i = blockIdx.x;
  const int every = (gridDim.x - n_hit) / n_hit + 1;
  *hit = i < n_hit * every && i % every == 0;
  if (*hit) return i / every;
  return i - min(i / every + 1, n_hit);
}

template <int NC>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int lane, int D, float (&r)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    r[j] = c < D ? __ldg(row + c) : 0.f;
  }
}

// n partners of one pair, G at a time with their rows loaded together (so
// G gathers are in flight, not one): f = l1 . row, g = score, neu += g *
// row, and lane 0 stores (g, w) of each live partner at gw[j].
// info(j, &w, &label) gives partner j's row, or -1 when it is no hit.
// Returns whether some partner had w != 0.
template <int NC, int G, class Info>
__device__ __forceinline__ bool score_partners(
    const float* __restrict__ syn, int n, const Info& info, float alpha,
    float2* gw, int lane, int D, const float (&l1)[NC], float (&neu)[NC]) {
  bool any_w = false;
  for (int j0 = 0; j0 < n; j0 += G) {
    int row[G];
    float w[G], label[G], r[G][NC], dot[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      w[q] = label[q] = 0.f;
      row[q] = j0 + q < n ? info(j0 + q, &w[q], &label[q]) : -1;
      any_w |= w[q] != 0.f;
      if (row[q] >= 0) {
        load_row<NC>(syn + static_cast<size_t>(row[q]) * D, lane, D, r[q]);
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) r[q][j] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      dot[q] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) dot[q] += l1[j] * r[q][j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < G; ++q)
        dot[q] += __shfl_xor_sync(kFull, dot[q], o);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (row[q] < 0) continue;
      const float g = score(dot[q], label[q], w[q], alpha);
#pragma unroll
      for (int j = 0; j < NC; ++j) neu[j] += g * r[q][j];
      if (lane == 0) gw[j0 + q] = make_float2(g, w[q]);
    }
  }
  return any_w;
}

template <int NC>
__device__ __forceinline__ void store_neu(float* dst, const float (&v)[NC],
                                          int lane, int D) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < D) dst[c] = v[j];
  }
}

// Phase A's scores, rows of at most 32 * NC floats: neu sums, no atomics.
// Lane j loads HS level j's and partner j's indices up front, so a group's
// indices come by shuffle and its rows are the only round trip.
template <int NC>
__device__ __forceinline__ void score_pairs(const W2vParams& p, int block,
                                            int n_blocks) {
  constexpr int G = NC <= 4 ? 4 : (NC <= 8 ? 2 : 1);
  const int lane = threadIdx.x & 31;
  const int n_warps = n_blocks * kWarps;
  const int D = p.D;
  for (int b = block * kWarps + (threadIdx.x >> 5); b < p.B; b += n_warps) {
    const int inp = pair_input(p, b);
    if (inp < 0) continue;
    const float pm = p.pmask[b];
    const int tgt = p.targets[b];
    const int lvl = b * p.L + lane;
    const bool mine_hs = lane < p.L, mine_ng = p.K > 0 && lane <= p.K;
    const int my_pt = mine_hs ? p.points[lvl] : -1;
    const float my_m = mine_hs ? p.mask[lvl] * pm : 0.f;
    const float my_code = mine_hs ? p.codes[lvl] : 0.f;
    const int my_row = mine_ng ? neg_input(p, b, lane, tgt) : -1;
    float l1[NC], neu_hs[NC], neu_ng[NC];
    load_row<NC>(p.syn0 + static_cast<size_t>(inp) * D, lane, D, l1);
#pragma unroll
    for (int j = 0; j < NC; ++j) neu_hs[j] = neu_ng[j] = 0.f;
    const bool row_hs = score_partners<NC, G>(
        p.syn1, p.L,
        [&](int l, float* w, float* label) {
          if (l >= 32) return hs_row(p, b, l, pm, w, label);
          return hs_rule(p, __shfl_sync(kFull, my_pt, l),
                         __shfl_sync(kFull, my_m, l),
                         __shfl_sync(kFull, my_code, l), w, label);
        },
        p.alpha, p.g_hs + static_cast<size_t>(b) * p.L, lane, D, l1, neu_hs);
    const bool live_ng = p.K > 0 && pm != 0.f;
    if (live_ng) {
      score_partners<NC, G>(
          p.syn1neg, p.K + 1,
          [&](int k, float* w, float* label) {
            const int row = k < 32 ? __shfl_sync(kFull, my_row, k)
                                   : neg_input(p, b, k, tgt);
            return neg_rule(p, k, row, tgt, pm, w, label);
          },
          p.alpha, p.g_ng + static_cast<size_t>(b) * (p.K + 1), lane, D, l1,
          neu_ng);
    }
    float* nb = p.neu + static_cast<size_t>(b) * 2 * D;
    if (row_hs) store_neu<NC>(nb, neu_hs, lane, D);
    if (live_ng) store_neu<NC>(nb + D, neu_ng, lane, D);
  }
}

// Phase A: hit counting and scores, in one grid (see phase_a_role).
template <int NC>
__global__ void __launch_bounds__(kThreads)
    w2v_phase_a_kernel(W2vParams p, W2vTables ts, int n_hit) {
  bool hit;
  const int block = phase_a_role(n_hit, &hit);
  if (hit)
    count_hits(p, ts, block, n_hit);
  else
    score_pairs<NC>(p, block, gridDim.x - n_hit);
}

// The wide path's (pair, partner): every column read from global memory,
// neu the pair's row of the neu buffer (each lane owns its columns).
__device__ __forceinline__ void partner_wide(const float* __restrict__ syn,
                                             int row, float label, float w,
                                             float alpha, float2* gw,
                                             int lane, int D,
                                             const float* __restrict__ l1,
                                             float* neu) {
  const float* r = syn + static_cast<size_t>(row) * D;
  float dot = 0.f;
  for (int c = lane; c < D; c += 32) dot += __ldg(l1 + c) * __ldg(r + c);
  const float g = score(warp_sum(dot), label, w, alpha);
  for (int c = lane; c < D; c += 32) neu[c] += g * __ldg(r + c);
  if (lane == 0) *gw = make_float2(g, w);
}

// Phase A's scores, rows wider than 512 floats.
__device__ __forceinline__ void score_pairs_wide(const W2vParams& p,
                                                 int block, int n_blocks) {
  const int lane = threadIdx.x & 31;
  const int n_warps = n_blocks * kWarps;
  const int D = p.D;
  float w, label;
  for (int b = block * kWarps + (threadIdx.x >> 5); b < p.B; b += n_warps) {
    const int inp = pair_input(p, b);
    if (inp < 0) continue;
    const float pm = p.pmask[b];
    const float* l1 = p.syn0 + static_cast<size_t>(inp) * D;
    float* nb = p.neu + static_cast<size_t>(b) * 2 * D;
    for (int c = lane; c < 2 * D; c += 32) nb[c] = 0.f;
    for (int l = 0; l < p.L; ++l) {
      const int pt = hs_row(p, b, l, pm, &w, &label);
      if (pt >= 0)
        partner_wide(p.syn1, pt, label, w, p.alpha,
                     p.g_hs + static_cast<size_t>(b) * p.L + l, lane, D, l1,
                     nb);
    }
    if (p.K > 0 && pm != 0.f) {
      const int tgt = p.targets[b];
      for (int k = 0; k <= p.K; ++k) {
        const int row =
            neg_rule(p, k, neg_input(p, b, k, tgt), tgt, pm, &w, &label);
        if (row >= 0)
          partner_wide(p.syn1neg, row, label, w, p.alpha,
                       p.g_ng + static_cast<size_t>(b) * (p.K + 1) + k, lane,
                       D, l1, nb + D);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    w2v_phase_a_wide_kernel(W2vParams p, W2vTables ts, int n_hit) {
  bool hit;
  const int block = phase_a_role(n_hit, &hit);
  if (hit)
    count_hits(p, ts, block, n_hit);
  else
    score_pairs_wide(p, block, gridDim.x - n_hit);
}

// Sources of phase C.  syn1 / syn1neg: hit (b, partner) is g * l1.
struct PairSrc {
  const float* syn0;
  const int* inputs;
  const float2* gw;
  int D, per;
  __device__ __forceinline__ HitInfo hit(int id) const {
    const float2 g = gw[id];
    return {syn0 + static_cast<size_t>(inputs[id / per]) * D, g.x, g.y, 0};
  }
};

// syn0: hit (b, objective) is that objective's neu row.
struct NeuSrc {
  const float* neu;
  const float* pmask;
  int D;
  __device__ __forceinline__ HitInfo hit(int id) const {
    const int obj = id & 1;
    return {neu + static_cast<size_t>(id) * D, 1.f,
            obj ? pmask[id >> 1] : 1.f, obj};
  }
};

// syn[row] += sum / max(count, 1), per objective for syn0.
struct SynApply {
  float* syn;
  int D;
  template <int NC>
  __device__ __forceinline__ void apply(int, int row, int c0,
                                        const float (&a0)[NC],
                                        const float (&a1)[NC], float w0,
                                        float w1, int lane) const {
    float* r = syn + static_cast<size_t>(row) * D;
    const float n0 = fmaxf(w0, 1.f), n1 = fmaxf(w1, 1.f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < D) r[c] += a0[j] / n0 + a1[j] / n1;
    }
  }
};

// Phase C for syn1 then syn1neg (their segments share one grid).
template <int NC>
__global__ void __launch_bounds__(rowseg::kWalkWarps * 32)
    w2v_reduce_syn_kernel(W2vParams p, W2vTables ts, int seg, int nwin) {
  __shared__ float stage[rowseg::kWalkWarps][rowseg::kStages][32 * NC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n1 = rowseg::n_items(ts.t[0], nwin);
  const int nn = rowseg::n_items(ts.t[1], nwin);
  const PairSrc hs{p.syn0, p.inputs, p.g_hs, p.D, p.L};
  const PairSrc ng{p.syn0, p.inputs, p.g_ng, p.D, p.K + 1};
  const SynApply a1{p.syn1, p.D}, an{p.syn1neg, p.D};
  const rowseg::Remap none{-1, -1};
  for (int item = blockIdx.x * rowseg::kWalkWarps + warp; item < n1 + nn;
       item += gridDim.x * rowseg::kWalkWarps) {
    if (item < n1)
      rowseg::reduce_item<NC, rowseg::kSum>(ts.t[0], item, nwin, p.D, seg,
                                            none, hs, a1, &stage[warp][0][0],
                                            lane);
    else
      rowseg::reduce_item<NC, rowseg::kSum>(ts.t[1], item - n1, nwin, p.D,
                                            seg, none, ng, an,
                                            &stage[warp][0][0], lane);
  }
}

// Phase C for syn0, after the syn1/syn1neg launch has read its rows.
template <int NC>
__global__ void __launch_bounds__(rowseg::kWalkWarps * 32)
    w2v_reduce_syn0_kernel(W2vParams p, W2vTables ts, int seg, int nwin) {
  __shared__ float stage[rowseg::kWalkWarps][rowseg::kStages][32 * NC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = rowseg::n_items(ts.t[2], nwin);
  const NeuSrc src{p.neu, p.pmask, p.D};
  const SynApply a0{p.syn0, p.D};
  for (int item = blockIdx.x * rowseg::kWalkWarps + warp; item < n0;
       item += gridDim.x * rowseg::kWalkWarps)
    rowseg::reduce_item<NC, rowseg::kTwoObj>(ts.t[2], item, nwin, p.D, seg,
                                             rowseg::Remap{-1, -1}, src, a0,
                                             &stage[warp][0][0], lane);
}

// Scratch layout: the zeroed part (row counts and counters of the three
// tables) first, then the rest.  Returns the bytes it takes.
size_t carve(W2vParams& p, W2vTables& ts, int seg, char* base,
             size_t* zeroed) {
  const int K1 = p.K > 0 ? p.K + 1 : 0;
  ts.t[0] = rowseg::plan(p.V1, p.B * p.L, seg, p.D);
  ts.t[1] = rowseg::plan(p.Vn, p.B * K1, seg, p.D);
  ts.t[2] = rowseg::plan(p.V0, p.B * 2, seg, p.D);
  rowseg::Carver c{base};
  for (auto& t : ts.t) rowseg::carve_zeroed(t, c);
  *zeroed = c.off;
  for (auto& t : ts.t) rowseg::carve_rest(t, c);
  p.g_hs = c.take<float2>(static_cast<size_t>(p.B) * p.L);
  p.g_ng = c.take<float2>(static_cast<size_t>(p.B) * K1);
  p.neu = c.take<float>(static_cast<size_t>(p.B) * 2 * p.D);
  return c.off;
}

template <int NC>
void launch_reduce(const W2vParams& p, const W2vTables& ts, int seg,
                   int nwin, cudaStream_t s) {
  const long long syn_items =
      static_cast<long long>(ts.t[0].seg_cap + ts.t[1].seg_cap) * nwin;
  w2v_reduce_syn_kernel<NC>
      <<<rowseg::reduce_grid(syn_items), rowseg::kWalkWarps * 32, 0, s>>>(
          p, ts, seg, nwin);
  w2v_reduce_syn0_kernel<NC><<<
      rowseg::reduce_grid(static_cast<long long>(ts.t[2].seg_cap) * nwin),
      rowseg::kWalkWarps * 32, 0, s>>>(p, ts, seg, nwin);
}

template <int NC>
void launch_phase_a(const W2vParams& p, const W2vTables& ts, int n_hit,
                    cudaStream_t s) {
  w2v_phase_a_kernel<NC>
      <<<(p.B + kWarps - 1) / kWarps + n_hit, kThreads, 0, s>>>(p, ts, n_hit);
}

}  // namespace

extern "C" {

// Bytes of scratch w2v_chunk needs for these shapes (seg >= 1).
size_t w2v_chunk_scratch_bytes(int B, int L, int K, int D, int V0, int V1,
                               int Vn, int seg) {
  W2vParams p{};
  p.B = B;
  p.L = L;
  p.K = K;
  p.D = D;
  p.V0 = V0;
  p.V1 = V1;
  p.Vn = Vn;
  W2vTables ts;
  size_t zeroed = 0;
  return carve(p, ts, seg, nullptr, &zeroed);
}

// One chunk, updating syn0, syn1 and syn1neg IN PLACE.  Tables are
// contiguous row-major fp32; index arrays contiguous int32, codes/mask/pmask
// fp32; scratch holds w2v_chunk_scratch_bytes(...) bytes, 16-byte aligned,
// of any content.  With use_hs == 0 (pass L = 0) the codes, points, mask and
// syn1 arguments are never read; with K == 0 neither are negs and syn1neg.
// Segments hold at most seg hits (seg >= 1).  Returns a cudaError_t: 0 when
// every launch was accepted (or B == 0, when nothing is launched).
int w2v_chunk(float* syn0, float* syn1, float* syn1neg, const int* inputs,
              const int* targets, const float* pmask, const float* codes,
              const int* points, const float* mask, const int* negs,
              void* scratch, int B, int L, int K, int D, int V0, int V1,
              int Vn, int use_hs, int seg, float alpha, void* stream) {
  if (D <= 0 || B < 0 || L < 0 || K < 0 || seg < 1 || (use_hs && L == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (!use_hs) L = 0;
  W2vParams p{syn0,   syn1,   syn1neg, inputs,  targets, pmask,
              codes,  points, mask,    negs,    nullptr, nullptr,
              nullptr, B,     L,       K,       D,       V0,
              V1,     Vn,     alpha};
  W2vTables ts;
  size_t zeroed = 0;
  carve(p, ts, seg, static_cast<char*>(scratch), &zeroed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // hit counting takes one block an SM beside the score blocks
  const int n_hit = rowseg::sm_count();
  const int nc = (D + 31) / 32;
  if (nc <= 1) launch_phase_a<1>(p, ts, n_hit, s);
  else if (nc <= 2) launch_phase_a<2>(p, ts, n_hit, s);
  else if (nc <= 4) launch_phase_a<4>(p, ts, n_hit, s);
  else if (nc <= 8) launch_phase_a<8>(p, ts, n_hit, s);
  else if (nc <= 12) launch_phase_a<12>(p, ts, n_hit, s);
  else if (nc <= 16) launch_phase_a<16>(p, ts, n_hit, s);
  else
    w2v_phase_a_wide_kernel<<<(B + kWarps - 1) / kWarps + n_hit, kThreads, 0,
                              s>>>(p, ts, n_hit);

  int max_cap = 0;
  for (const auto& t : ts.t) max_cap = t.cap > max_cap ? t.cap : max_cap;
  rowseg::scan_kernel<3>
      <<<dim3((max_cap + rowseg::kScanThreads - 1) / rowseg::kScanThreads,
              3),
         rowseg::kScanThreads, 0, s>>>(ts, seg);
  const int most_pot = B * (L > K + 1 ? L : K + 1);
  int scatter_blocks = (most_pot + 255) / 256;
  if (scatter_blocks > 16 * rowseg::sm_count())
    scatter_blocks = 16 * rowseg::sm_count();
  rowseg::scatter_kernel<3><<<scatter_blocks, 256, 0, s>>>(ts);

  if (nc <= 1) launch_reduce<1>(p, ts, seg, 1, s);
  else if (nc <= 2) launch_reduce<2>(p, ts, seg, 1, s);
  else if (nc <= 4) launch_reduce<4>(p, ts, seg, 1, s);
  else if (nc <= 8) launch_reduce<8>(p, ts, seg, 1, s);
  else if (nc <= 12) launch_reduce<12>(p, ts, seg, 1, s);
  else launch_reduce<16>(p, ts, seg, (D + 511) / 512, s);
  return static_cast<int>(cudaGetLastError());
}

const char* w2v_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
