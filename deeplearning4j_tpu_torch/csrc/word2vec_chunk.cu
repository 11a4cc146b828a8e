// Word2vec skip-gram chunk update for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_word2vec.py:
// _kernel (:91), launched by fused_chunk_update (:207, pallas_call at :236).
//
// What it computes, for one chunk of B (input, target) pairs at rate alpha,
// with every table read as it stood at the start of the chunk:
//   l1 = syn0[input]
//   hierarchical softmax, for each level l with m = mask[b,l] * pmask[b] > 0:
//     f = l1 . syn1[points[b,l]];  g = (1 - codes[b,l] - sigmoid(f)) * alpha * m
//     neu_hs += g * syn1[point];  acc1[point] += (g * l1 | m)
//   negative sampling, for k = 0..K with row = target (label 1), then
//   negs[b,k-1] (label 0), valid = pmask[b] (0 for a negative equal to its
//   target):
//     f = l1 . syn1neg[row];  g = (label - sigmoid(f)) * alpha * valid
//     neu_ng += g * syn1neg[row];  accn[row] += (g * l1 | valid)
//   acc0[input] += (neu_hs | row_hs | neu_ng | pmask), row_hs = any m > 0
// acc0 is [V0, 2(D+1)], acc1/accn [V, D+1], fp32, zeroed by the caller; the
// caller then applies syn += sum / max(count, 1) (pallas_word2vec.py:272-278).
// The kernel writes no table, so both objectives see chunk-start values.
//
// Bound on an H100 SXM: bytes.  A live (pair, partner) reads one D-float row,
// does about 6*D FLOPs and issues D+1 fp32 atomic adds; at D=100 that is
// ~1.5 FLOP per byte of rows alone, far below the 67 TFLOP/s fp32 ridge.
// The least work is each distinct table row read once, the chunk's index
// arrays read once and each distinct accumulator row written once.
//
// Design, right before fast:
// - one warp per pair, a grid-stride loop over pairs; D across the lanes
//   (column lane + 32*j, so a row load is coalesced), up to 16 columns a
//   lane (D <= 512), the input row l1 and both neu sums in registers;
// - wider rows (D > 512) take w2v_chunk_wide_kernel: each lane strides over
//   the columns, l1 is re-read per partner and each partner's g * row goes
//   straight into acc0 with atomics, so any D runs;
// - each dot product is a butterfly shuffle reduction, so every lane holds f
//   and g and adds its own columns;
// - the TPU kernel's one-hot matrix products, bf16 table casts and dense
//   [BLK, V] score planes are not carried over: they existed because VMEM
//   held the tables.  Here rows are gathered from HBM in fp32 and the
//   scatter is plain fp32 atomicAdd (RED) into the accumulators.
// - hot rows: every HS pair's level 0 is the Huffman root, so a chunk puts
//   B adds on each of that row's D+1 addresses; they serialise in L2.
//   Warp aggregation or a shared-memory partial for hot rows is later work.
// fp32 atomics sum in no fixed order, so two runs differ in the last bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct W2vParams {
  const float* syn0;
  const float* syn1;
  const float* syn1neg;
  const int* inputs;
  const int* targets;
  const float* pmask;
  const float* codes;
  const int* points;
  const float* mask;
  const int* negs;
  float* acc0;
  float* acc1;
  float* accn;
  int B, L, K, D, V0, V1, Vn, use_hs;
  float alpha;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// One (pair, partner): f = l1 . syn[row], g = (label - sigmoid(f)) * alpha * w,
// neu += g * syn[row], acc[row] += (g * l1 | w).
template <int NC>
__device__ __forceinline__ void partner(const float* __restrict__ syn,
                                        float* __restrict__ acc, int row,
                                        float label, float w, float alpha,
                                        int lane, int D, const float (&l1)[NC],
                                        float (&neu)[NC]) {
  float r[NC];
  load_row<NC>(syn + static_cast<size_t>(row) * D, lane, D, r);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) dot += l1[j] * r[j];
  dot = warp_sum(dot);
  const float g = (label - 1.f / (1.f + expf(-dot))) * alpha * w;
  float* a = acc + static_cast<size_t>(row) * (D + 1);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < D) {
      neu[j] += g * r[j];
      atomicAdd(a + c, g * l1[j]);
    }
  }
  if (lane == 0) atomicAdd(a + D, w);
}

template <int NC>
__global__ void __launch_bounds__(kThreads) w2v_chunk_kernel(W2vParams p) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int D = p.D;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < p.B;
       b += n_warps) {
    const int inp = p.inputs[b];
    if (inp < 0 || inp >= p.V0) continue;  // out of range: dropped
    const float pm = p.pmask[b];
    float l1[NC], neu_hs[NC], neu_ng[NC];
    load_row<NC>(p.syn0 + static_cast<size_t>(inp) * D, lane, D, l1);
#pragma unroll
    for (int j = 0; j < NC; ++j) neu_hs[j] = neu_ng[j] = 0.f;

    float row_hs = 0.f;
    if (p.use_hs) {
      const size_t base = static_cast<size_t>(b) * p.L;
      for (int l = 0; l < p.L; ++l) {
        const float m = p.mask[base + l] * pm;
        if (m == 0.f) continue;
        row_hs = 1.f;
        const int pt = p.points[base + l];
        if (pt < 0 || pt >= p.V1) continue;
        partner<NC>(p.syn1, p.acc1, pt, 1.f - p.codes[base + l], m, p.alpha,
                    lane, D, l1, neu_hs);
      }
    }
    if (p.K > 0 && pm != 0.f) {
      const int tgt = p.targets[b];
      for (int k = 0; k <= p.K; ++k) {
        const int row =
            k == 0 ? tgt : p.negs[static_cast<size_t>(b) * p.K + k - 1];
        if (k > 0 && row == tgt) continue;  // a collision is no hit
        if (row < 0 || row >= p.Vn) continue;
        partner<NC>(p.syn1neg, p.accn, row, k == 0 ? 1.f : 0.f, pm, p.alpha,
                    lane, D, l1, neu_ng);
      }
    }

    float* a = p.acc0 + static_cast<size_t>(inp) * 2 * (D + 1);
    if (row_hs != 0.f) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c < D) atomicAdd(a + c, neu_hs[j]);
      }
      if (lane == 0) atomicAdd(a + D, row_hs);
    }
    if (p.K > 0 && pm != 0.f) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c < D) atomicAdd(a + D + 1 + c, neu_ng[j]);
      }
      if (lane == 0) atomicAdd(a + 2 * D + 1, pm);
    }
  }
}

// The wide path's (pair, partner): as partner() with every column read
// from global memory, and neu the pair's acc0 columns, added atomically.
__device__ __forceinline__ void partner_wide(const float* __restrict__ syn,
                                             float* __restrict__ acc,
                                             float* __restrict__ neu, int row,
                                             float label, float w,
                                             float alpha, int lane, int D,
                                             const float* __restrict__ l1) {
  const float* r = syn + static_cast<size_t>(row) * D;
  float dot = 0.f;
  for (int c = lane; c < D; c += 32) dot += __ldg(l1 + c) * __ldg(r + c);
  dot = warp_sum(dot);
  const float g = (label - 1.f / (1.f + expf(-dot))) * alpha * w;
  float* a = acc + static_cast<size_t>(row) * (D + 1);
  for (int c = lane; c < D; c += 32) {
    atomicAdd(a + c, g * __ldg(l1 + c));
    atomicAdd(neu + c, g * __ldg(r + c));
  }
  if (lane == 0) atomicAdd(a + D, w);
}

__global__ void __launch_bounds__(kThreads) w2v_chunk_wide_kernel(
    W2vParams p) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int D = p.D;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < p.B;
       b += n_warps) {
    const int inp = p.inputs[b];
    if (inp < 0 || inp >= p.V0) continue;  // out of range: dropped
    const float pm = p.pmask[b];
    const float* l1 = p.syn0 + static_cast<size_t>(inp) * D;
    float* a0 = p.acc0 + static_cast<size_t>(inp) * 2 * (D + 1);
    float row_hs = 0.f;
    if (p.use_hs) {
      const size_t base = static_cast<size_t>(b) * p.L;
      for (int l = 0; l < p.L; ++l) {
        const float m = p.mask[base + l] * pm;
        if (m == 0.f) continue;
        row_hs = 1.f;
        const int pt = p.points[base + l];
        if (pt < 0 || pt >= p.V1) continue;
        partner_wide(p.syn1, p.acc1, a0, pt, 1.f - p.codes[base + l], m,
                     p.alpha, lane, D, l1);
      }
    }
    if (p.K > 0 && pm != 0.f) {
      const int tgt = p.targets[b];
      for (int k = 0; k <= p.K; ++k) {
        const int row =
            k == 0 ? tgt : p.negs[static_cast<size_t>(b) * p.K + k - 1];
        if (k > 0 && row == tgt) continue;  // a collision is no hit
        if (row < 0 || row >= p.Vn) continue;
        partner_wide(p.syn1neg, p.accn, a0 + D + 1, row, k == 0 ? 1.f : 0.f,
                     pm, p.alpha, lane, D, l1);
      }
    }
    if (lane == 0) {
      if (row_hs != 0.f) atomicAdd(a0 + D, row_hs);
      if (p.K > 0 && pm != 0.f) atomicAdd(a0 + 2 * D + 1, pm);
    }
  }
}

int grid_of(const W2vParams& p) { return (p.B + kWarps - 1) / kWarps; }

template <int NC>
int launch(const W2vParams& p, cudaStream_t stream) {
  w2v_chunk_kernel<NC><<<grid_of(p), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All tables and accumulators are contiguous row-major fp32; index arrays
// are contiguous int32, codes/mask/pmask fp32.  With use_hs == 0 the codes,
// points, mask and syn1 arguments are never read; with K == 0 neither are
// negs and syn1neg.  Returns a cudaError_t; 0 when the launch was accepted
// (or B == 0, when nothing is launched).
int w2v_chunk(const float* syn0, const float* syn1, const float* syn1neg,
              const int* inputs, const int* targets, const float* pmask,
              const float* codes, const int* points, const float* mask,
              const int* negs, float* acc0, float* acc1, float* accn, int B,
              int L, int K, int D, int V0, int V1, int Vn, int use_hs,
              float alpha, void* stream) {
  if (D <= 0 || B < 0 || L < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  W2vParams p{syn0,  syn1, syn1neg, inputs, targets, pmask, codes,
              points, mask, negs,   acc0,   acc1,    accn,  B,
              L,     K,    D,       V0,     V1,      Vn,    use_hs,
              alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (D + 31) / 32;
  if (nc <= 1) return launch<1>(p, s);
  if (nc <= 2) return launch<2>(p, s);
  if (nc <= 4) return launch<4>(p, s);
  if (nc <= 8) return launch<8>(p, s);
  if (nc <= 12) return launch<12>(p, s);
  if (nc <= 16) return launch<16>(p, s);
  w2v_chunk_wide_kernel<<<grid_of(p), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* w2v_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
