// GloVe chunk update for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_glove.py:
// _kernel (:64), launched by fused_glove_chunk (:118, pallas_call at :135),
// and the AdaGrad step apply_chunk (:164-175) that follows it.
//
// What it computes, for one chunk of B co-occurrence triples (row i, col j,
// count x, mask m) over the extended tables
//   wext[i]  = (w[i]  | b[i] | 1)      [V, D+2]
//   wtext[j] = (wt[j] | 1 | bt[j])     [V, D+2]
// so that wext[i] . wtext[j] = w[i].wt[j] + b[i] + bt[j]:
//   diff = wext[i] . wtext[j] - log(max(x, 1e-12))
//   f    = min((x / x_max)^power, 1),  g = f * diff * m
//   side i, row i gets (g*p | (g*p)^2 | m) with p = (wt[j] | 1) = wtext[j, :D+1]
//   side j, row j gets (g*p | (g*p)^2 | m) with p = (w[i] | 1) = (wext[i, :D], wext[i, D+1])
//   loss += (0.5 * f * diff^2 * m, m)
// and then, in step mode, each touched row of a side takes the AdaGrad step
// of apply_chunk on its (weights | bias) columns with k = max(hits, 1):
//   gsq += sum_sq / k^2;  w -= alpha * (sum / k) / sqrt(gsq + 1e-8)
// IN PLACE: side i into wext[:, :D+1] and gext, side j into wtext's columns
// :D and D+1 and gtext.  An untouched row has sums 0 and is left as it is.
// In accumulator mode (the JAX signature) the sums instead go to the touched
// rows of zeroed [V, 2D+3] accumulators.  The "1" column of wext is D+1, of
// wtext D.
//
// Bound on an H100 SXM: bytes.  The least work is each touched row of the four
// tables read once and written once plus the four [B] inputs.  The earlier
// design issued 2(2D+3) fp32 atomics a triple into dense [V, 2D+3]
// accumulators, which the epoch loop zeroed, applied over whole tables and
// copied (about 635 MB a chunk at V=71,290 by shapes).
//
// Design: destination-owned row reductions (row_segments.cuh), as the
// word2vec chunk kernel.
// - phase A, glove_score_kernel: one warp per triple, D across the lanes in
//   registers (rows wider than 512 floats stride over the columns), the
//   score a butterfly shuffle reduction; lane 0 stores g and counts the hit
//   into row i of side i and row j of side j (integer atomics); the loss sums
//   reduce over a block, then one atomic each.
// - scan and scatter: the hits of every touched row of each side become a
//   contiguous list, cut into segments of at most `seg` hits.
// - phase C, glove_reduce_kernel: one warp per segment sums g*p and (g*p)^2
//   in registers, gathering the partner rows through a cp.async ring; the
//   sums of a row go to a compact [touched rows, 2D+4] buffer (split rows
//   meet in scratch, the last segment copies them).  Neither side writes a
//   table here, because each side reads the other side's table.
// - glove_apply_kernel: one warp per touched row of either side takes the
//   AdaGrad step in place (or writes the accumulator row).

#include <cuda_runtime.h>
#include <math.h>

#include "row_segments.cuh"

namespace {

using rowseg::HitInfo;
using rowseg::kFull;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct GloveParams {
  const int* rows;
  const int* cols;
  const float* x;
  const float* mask;
  float* wext;
  float* wtext;
  float* gext;    // [V, D+1] (step mode)
  float* gtext;
  float* accw;    // [V, 2D+3], zeroed (accumulator mode)
  float* accwt;
  float* loss;    // [2]
  float* g;       // [B] scratch: g of each live triple
  float* sums_i;  // [cap_i, 2D+4] scratch: a touched row's sums, side i
  float* sums_j;
  int B, D, V;
  float x_max, power, alpha;
  int step;       // 1: AdaGrad step in place, 0: accumulators
};

// tables: 0 = side i (keyed by rows), 1 = side j (by cols); hit id = triple
using GloveTables = rowseg::Tables<2>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A live triple's g = f * diff * m, with its loss term added to the warp's
// running sums.
__device__ __forceinline__ float triple_g(const GloveParams& p, int b,
                                          float dot, float m, float& loss,
                                          float& count) {
  const float x = p.x[b];
  const float diff = dot - logf(fmaxf(x, 1e-12f));
  const float fx = fminf(powf(x / p.x_max, p.power), 1.f);
  loss += 0.5f * fx * diff * diff * m;
  count += m;
  return fx * diff * m;
}

// The block's loss sums: a shared-memory reduction over its warps, then one
// atomic for each.
__device__ __forceinline__ void add_block_loss(float loss, float count,
                                               float* out) {
  __shared__ float s_loss[kWarps][2];
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_loss[threadIdx.x >> 5][0] = loss;
    s_loss[threadIdx.x >> 5][1] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f, n = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      l += s_loss[w][0];
      n += s_loss[w][1];
    }
    if (n != 0.f) {
      atomicAdd(out, l);
      atomicAdd(out + 1, n);
    }
  }
}

// Triple b's rows when it is live, else its hits are marked dead.
__device__ __forceinline__ bool live_triple(const GloveParams& p,
                                           const GloveTables& ts, int b,
                                           int lane, float& m, int& r,
                                           int& c) {
  m = p.mask[b];
  r = p.rows[b];
  c = p.cols[b];
  const bool live =
      m != 0.f && r >= 0 && r < p.V && c >= 0 && c < p.V;  // else dropped
  if (!live && lane == 0) {
    ts.t[0].hitrow[b] = make_int2(-1, -1);
    ts.t[1].hitrow[b] = make_int2(-1, -1);
  }
  return live;
}

__device__ __forceinline__ void record(const GloveParams& p,
                                       const GloveTables& ts, int b, int r,
                                       int c, float g) {
  p.g[b] = g;
  rowseg::record_hit(ts.t[0], b, r);
  rowseg::record_hit(ts.t[1], b, c);
}

// Phase A, extended rows of at most 32 * NC floats.
template <int NC>
__global__ void __launch_bounds__(kThreads)
    glove_score_kernel(GloveParams p, GloveTables ts) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int E = p.D + 2;
  float loss = 0.f, count = 0.f;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < p.B;
       b += n_warps) {
    float m;
    int r, c;
    if (!live_triple(p, ts, b, lane, m, r, c)) continue;
    const float* wi = p.wext + static_cast<size_t>(r) * E;
    const float* wj = p.wtext + static_cast<size_t>(c) * E;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col < E) dot += __ldg(wi + col) * __ldg(wj + col);
    }
    const float g = triple_g(p, b, warp_sum(dot), m, loss, count);
    if (lane == 0) record(p, ts, b, r, c, g);
  }
  add_block_loss(loss, count, p.loss);
}

// Phase A, extended rows wider than 512 floats.
__global__ void __launch_bounds__(kThreads)
    glove_score_wide_kernel(GloveParams p, GloveTables ts) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int E = p.D + 2;
  float loss = 0.f, count = 0.f;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < p.B;
       b += n_warps) {
    float m;
    int r, c;
    if (!live_triple(p, ts, b, lane, m, r, c)) continue;
    const float* wi = p.wext + static_cast<size_t>(r) * E;
    const float* wj = p.wtext + static_cast<size_t>(c) * E;
    float dot = 0.f;
    for (int col = lane; col < E; col += 32)
      dot += __ldg(wi + col) * __ldg(wj + col);
    const float g = triple_g(p, b, warp_sum(dot), m, loss, count);
    if (lane == 0) record(p, ts, b, r, c, g);
  }
  add_block_loss(loss, count, p.loss);
}

// Sources of phase C: hit b of side i is g * wtext[cols[b]], of side j
// g * wext[rows[b]] (its column D read from the "1" column D+1).
struct SideSrc {
  const float* table;
  const int* idx;
  const float* g;
  const float* mask;
  int E;
  __device__ __forceinline__ HitInfo hit(int b) const {
    return {table + static_cast<size_t>(idx[b]) * E, g[b], mask[b], 0};
  }
};

// A touched row's sums into the compact buffer: (sum | sum_sq | hits).
struct SumStore {
  float* sums;
  int W, ncols;
  template <int NC>
  __device__ __forceinline__ void apply(int u, int, int c0,
                                        const float (&a0)[NC],
                                        const float (&a1)[NC], float w0,
                                        float, int lane) const {
    float* s = sums + static_cast<size_t>(u) * W;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < ncols) {
        s[c] = a0[j];
        s[ncols + c] = a1[j];
      }
    }
    if (c0 == 0 && lane == 0) s[2 * ncols] = w0;
  }
};

template <int NC>
__global__ void __launch_bounds__(rowseg::kWalkWarps * 32)
    glove_reduce_kernel(GloveParams p, GloveTables ts, int seg, int nwin) {
  __shared__ float stage[rowseg::kWalkWarps][rowseg::kStages][32 * NC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = p.D, E = D + 2, ncols = D + 1;
  const int ni = rowseg::n_items(ts.t[0], nwin);
  const int nj = rowseg::n_items(ts.t[1], nwin);
  const SideSrc si{p.wtext, p.cols, p.g, p.mask, E};
  const SideSrc sj{p.wext, p.rows, p.g, p.mask, E};
  const SumStore fi{p.sums_i, ts.t[0].W, ncols};
  const SumStore fj{p.sums_j, ts.t[1].W, ncols};
  for (int item = blockIdx.x * rowseg::kWalkWarps + warp; item < ni + nj;
       item += gridDim.x * rowseg::kWalkWarps) {
    if (item < ni)
      rowseg::reduce_item<NC, rowseg::kSquares>(
          ts.t[0], item, nwin, ncols, seg, rowseg::Remap{-1, -1}, si, fi,
          &stage[warp][0][0], lane);
    else
      rowseg::reduce_item<NC, rowseg::kSquares>(
          ts.t[1], item - ni, nwin, ncols, seg, rowseg::Remap{D, D + 1}, sj,
          fj, &stage[warp][0][0], lane);
  }
}

// One warp per touched row of either side: the AdaGrad step in place
// (apply_chunk's algebra), or the row of the zeroed accumulator.
__global__ void __launch_bounds__(kThreads)
    glove_apply_kernel(GloveParams p, GloveTables ts) {
  const int lane = threadIdx.x & 31;
  const int D = p.D, E = D + 2, ncols = D + 1, W = ts.t[0].W;
  const int ui = ts.t[0].counters[0], uj = ts.t[1].counters[0];
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < ui + uj;
       item += gridDim.x * kWarps) {
    const int side = item < ui ? 0 : 1;
    const int u = side ? item - ui : item;
    const int row = ts.t[side].touched[u];
    const float* s = (side ? p.sums_j : p.sums_i) + static_cast<size_t>(u) * W;
    if (!p.step) {
      float* acc = (side ? p.accwt : p.accw) +
                   static_cast<size_t>(row) * (2 * ncols + 1);
      for (int c = lane; c <= 2 * ncols; c += 32) acc[c] = s[c];
      continue;
    }
    float* tab = (side ? p.wtext : p.wext) + static_cast<size_t>(row) * E;
    float* gsq = (side ? p.gtext : p.gext) + static_cast<size_t>(row) * ncols;
    const float k = fmaxf(s[2 * ncols], 1.f);
    for (int c = lane; c < ncols; c += 32) {
      const float grad = s[c] / k;
      const float g2 = gsq[c] + s[ncols + c] / (k * k);
      gsq[c] = g2;
      const int dc = (side && c == D) ? D + 1 : c;  // wtext's bias is D+1
      tab[dc] = tab[dc] - p.alpha * grad / sqrtf(g2 + 1e-8f);
    }
  }
}

// Scratch layout: the zeroed part (row counts and counters) first.
size_t carve(GloveParams& p, GloveTables& ts, int seg, char* base,
             size_t* zeroed) {
  for (auto& t : ts.t) t = rowseg::plan(p.V, p.B, seg, p.D + 1);
  rowseg::Carver c{base};
  for (auto& t : ts.t) rowseg::carve_zeroed(t, c);
  *zeroed = c.off;
  for (auto& t : ts.t) rowseg::carve_rest(t, c);
  p.g = c.take<float>(p.B);
  p.sums_i = c.take<float>(static_cast<size_t>(ts.t[0].cap) * ts.t[0].W);
  p.sums_j = c.take<float>(static_cast<size_t>(ts.t[1].cap) * ts.t[1].W);
  return c.off;
}

template <int NC>
void launch_score(const GloveParams& p, const GloveTables& ts,
                  cudaStream_t s) {
  glove_score_kernel<NC><<<(p.B + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      p, ts);
}

template <int NC>
void launch_reduce(const GloveParams& p, const GloveTables& ts, int seg,
                   int nwin, cudaStream_t s) {
  const long long items =
      static_cast<long long>(ts.t[0].seg_cap + ts.t[1].seg_cap) * nwin;
  glove_reduce_kernel<NC>
      <<<rowseg::reduce_grid(items), rowseg::kWalkWarps * 32, 0, s>>>(
          p, ts, seg, nwin);
}

}  // namespace

extern "C" {

// Bytes of scratch glove_chunk needs for these shapes (seg >= 1).
size_t glove_chunk_scratch_bytes(int B, int D, int V, int seg) {
  GloveParams p{};
  p.B = B;
  p.D = D;
  p.V = V;
  GloveTables ts;
  size_t zeroed = 0;
  return carve(p, ts, seg, nullptr, &zeroed);
}

// One chunk.  Tables contiguous row-major fp32 (wext/wtext [V, D+2],
// gext/gtext [V, D+1]), rows/cols int32, x/mask fp32, loss [2] fp32 (zeroed
// here).  step = 1 updates wext, wtext, gext and gtext IN PLACE (accw and
// accwt are not read); step = 0 leaves the tables alone and writes the
// touched rows of accw/accwt [V, 2D+3], which the caller zeroed (gext and
// gtext are not read).  scratch holds glove_chunk_scratch_bytes(...) bytes,
// 16-byte aligned, of any content.  Returns a cudaError_t: 0 when every
// launch was accepted (or B == 0, when nothing is launched beyond zeroing
// the loss).
int glove_chunk(const int* rows, const int* cols, const float* x,
                const float* mask, float* wext, float* wtext, float* gext,
                float* gtext, float* accw, float* accwt, float* loss,
                void* scratch, int B, int D, int V, int seg, float x_max,
                float power, float alpha, int step, void* stream) {
  if (D <= 0 || B < 0 || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(loss, 0, 2 * sizeof(float), s);
  if (err != cudaSuccess || B == 0) return static_cast<int>(err);
  GloveParams p{rows,  cols,  x,       mask,    wext,    wtext, gext,
                gtext, accw,  accwt,   loss,    nullptr, nullptr, nullptr,
                B,     D,     V,       x_max,   power,   alpha, step};
  GloveTables ts;
  size_t zeroed = 0;
  carve(p, ts, seg, static_cast<char*>(scratch), &zeroed);
  err = cudaMemsetAsync(scratch, 0, zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int nce = (D + 2 + 31) / 32;
  if (nce <= 1) launch_score<1>(p, ts, s);
  else if (nce <= 2) launch_score<2>(p, ts, s);
  else if (nce <= 4) launch_score<4>(p, ts, s);
  else if (nce <= 8) launch_score<8>(p, ts, s);
  else if (nce <= 12) launch_score<12>(p, ts, s);
  else if (nce <= 16) launch_score<16>(p, ts, s);
  else
    glove_score_wide_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        p, ts);

  const int cap = ts.t[0].cap;
  rowseg::scan_kernel<2>
      <<<dim3((cap + rowseg::kScanThreads - 1) / rowseg::kScanThreads, 2),
         rowseg::kScanThreads, 0, s>>>(ts, seg);
  int scatter_blocks = (B + 255) / 256;
  if (scatter_blocks > 16 * rowseg::sm_count())
    scatter_blocks = 16 * rowseg::sm_count();
  rowseg::scatter_kernel<2><<<scatter_blocks, 256, 0, s>>>(ts);

  const int nc = (D + 1 + 31) / 32;
  if (nc <= 1) launch_reduce<1>(p, ts, seg, 1, s);
  else if (nc <= 2) launch_reduce<2>(p, ts, seg, 1, s);
  else if (nc <= 4) launch_reduce<4>(p, ts, seg, 1, s);
  else if (nc <= 8) launch_reduce<8>(p, ts, seg, 1, s);
  else if (nc <= 12) launch_reduce<12>(p, ts, seg, 1, s);
  else launch_reduce<16>(p, ts, seg, (D + 1 + 511) / 512, s);

  int apply_blocks = (2 * cap + kWarps - 1) / kWarps;
  if (apply_blocks > 16 * rowseg::sm_count())
    apply_blocks = 16 * rowseg::sm_count();
  glove_apply_kernel<<<apply_blocks, kThreads, 0, s>>>(p, ts);
  return static_cast<int>(cudaGetLastError());
}

const char* glove_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
