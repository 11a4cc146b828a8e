// GloVe chunk accumulation for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_glove.py:
// _kernel (:64), launched by fused_glove_chunk (:118, pallas_call at :135).
//
// What it computes, for one chunk of B co-occurrence triples (row i, col j,
// count x, mask m) over the extended tables
//   wext[i]  = (w[i]  | b[i] | 1)      [V, D+2]
//   wtext[j] = (wt[j] | 1 | bt[j])     [V, D+2]
// so that wext[i] . wtext[j] = w[i].wt[j] + b[i] + bt[j]:
//   diff = wext[i] . wtext[j] - log(max(x, 1e-12))
//   f    = min((x / x_max)^power, 1),  g = f * diff * m
//   accw[i]  += (g*p | (g*p)^2 | m) with p = (wt[j] | 1) = wtext[j, :D+1]
//   accwt[j] += (g*p | (g*p)^2 | m) with p = (w[i] | 1) = (wext[i, :D], wext[i, D+1])
//   loss     += (0.5 * f * diff^2 * m, m)
// accw/accwt are [V, 2D+3] fp32 and loss [1, 2], zeroed by the caller;
// apply_chunk then takes the AdaGrad step outside the kernel
// (pallas_glove.py:164-175).  The "1" column of wext is D+1, of wtext D.
//
// Bound on an H100 SXM: bytes.  A live triple reads two (D+2)-float rows,
// does about 6*D FLOPs and issues 2(2D+3) fp32 atomic adds.  The least work
// is each distinct table row read once, the four [B] inputs read once and
// each distinct accumulator row written once.
//
// Design, right before fast: one warp per triple (grid-stride), D across the
// lanes (column lane + 32*j, coalesced, in registers up to D+2 = 512; wider
// rows take glove_chunk_wide_kernel, which strides over the columns), the
// score a butterfly shuffle reduction so every lane holds g; fp32 atomicAdd
// into the accumulators.
// The loss sums reduce over a block in shared memory, then one atomic per
// block for each.  The TPU kernel's one-hot products and bf16 casts are not
// carried over: they existed because VMEM held the tables.  Here the
// squared-gradient columns accumulate in fp32, not bf16.  fp32 atomics sum
// in no fixed order, so two runs differ in the last bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct GloveParams {
  const int* rows;
  const int* cols;
  const float* x;
  const float* mask;
  const float* wext;
  const float* wtext;
  float* accw;
  float* accwt;
  float* loss;
  int B, D, V;
  float x_max, power;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A live triple's g = f * diff * m, with its loss term added to the
// warp's running sums.
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

// Update column col of both sides: (g*p | (g*p)^2) into accw[i] with
// p = gw / g and into accwt[j] with p = gt / g.
__device__ __forceinline__ void add_column(float* aw, float* awt, int col,
                                           int D, float gw, float gt) {
  atomicAdd(aw + col, gw);
  atomicAdd(aw + D + 1 + col, gw * gw);
  atomicAdd(awt + col, gt);
  atomicAdd(awt + D + 1 + col, gt * gt);
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

template <int NC>
__global__ void __launch_bounds__(kThreads) glove_chunk_kernel(GloveParams p) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int D = p.D, E = p.D + 2, W = 2 * p.D + 3;
  float loss = 0.f, count = 0.f;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < p.B;
       b += n_warps) {
    const float m = p.mask[b];
    if (m == 0.f) continue;
    const int r = p.rows[b], c = p.cols[b];
    if (r < 0 || r >= p.V || c < 0 || c >= p.V) continue;  // dropped
    const float* wi_row = p.wext + static_cast<size_t>(r) * E;
    const float* wj_row = p.wtext + static_cast<size_t>(c) * E;
    float wi[NC], wj[NC];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      wi[j] = col < E ? __ldg(wi_row + col) : 0.f;
      wj[j] = col < E ? __ldg(wj_row + col) : 0.f;
      dot += wi[j] * wj[j];
    }
    const float g = triple_g(p, b, warp_sum(dot), m, loss, count);
    const float wi_one = __ldg(wi_row + D + 1);
    float* aw = p.accw + static_cast<size_t>(r) * W;
    float* awt = p.accwt + static_cast<size_t>(c) * W;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col <= D)   // the D+1 update columns: partners (wt_j | 1), (w_i | 1)
        add_column(aw, awt, col, D, g * wj[j],
                   g * (col < D ? wi[j] : wi_one));
    }
    if (lane == 0) {
      atomicAdd(aw + W - 1, m);
      atomicAdd(awt + W - 1, m);
    }
  }
  add_block_loss(loss, count, p.loss);
}

// E > 512: the same work with each lane striding over the columns and
// reading them from global memory, so any D runs.
__global__ void __launch_bounds__(kThreads) glove_chunk_wide_kernel(
    GloveParams p) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int D = p.D, E = p.D + 2, W = 2 * p.D + 3;
  float loss = 0.f, count = 0.f;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < p.B;
       b += n_warps) {
    const float m = p.mask[b];
    if (m == 0.f) continue;
    const int r = p.rows[b], c = p.cols[b];
    if (r < 0 || r >= p.V || c < 0 || c >= p.V) continue;  // dropped
    const float* wi_row = p.wext + static_cast<size_t>(r) * E;
    const float* wj_row = p.wtext + static_cast<size_t>(c) * E;
    float dot = 0.f;
    for (int col = lane; col < E; col += 32)
      dot += __ldg(wi_row + col) * __ldg(wj_row + col);
    const float g = triple_g(p, b, warp_sum(dot), m, loss, count);
    const float wi_one = __ldg(wi_row + D + 1);
    float* aw = p.accw + static_cast<size_t>(r) * W;
    float* awt = p.accwt + static_cast<size_t>(c) * W;
    for (int col = lane; col <= D; col += 32)
      add_column(aw, awt, col, D, g * __ldg(wj_row + col),
                 g * (col < D ? __ldg(wi_row + col) : wi_one));
    if (lane == 0) {
      atomicAdd(aw + W - 1, m);
      atomicAdd(awt + W - 1, m);
    }
  }
  add_block_loss(loss, count, p.loss);
}

int grid_of(const GloveParams& p) { return (p.B + kWarps - 1) / kWarps; }

template <int NC>
int launch(const GloveParams& p, cudaStream_t stream) {
  glove_chunk_kernel<NC><<<grid_of(p), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tables and accumulators contiguous row-major fp32, rows/cols int32,
// x/mask fp32.  Returns a cudaError_t; 0 when the launch was accepted (or
// B == 0, when nothing is launched).
int glove_chunk(const int* rows, const int* cols, const float* x,
                const float* mask, const float* wext, const float* wtext,
                float* accw, float* accwt, float* loss, int B, int D, int V,
                float x_max, float power, void* stream) {
  if (D <= 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  GloveParams p{rows, cols, x, mask, wext, wtext, accw, accwt, loss,
                B,    D,    V, x_max, power};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (D + 2 + 31) / 32;
  if (nc <= 1) return launch<1>(p, s);
  if (nc <= 2) return launch<2>(p, s);
  if (nc <= 4) return launch<4>(p, s);
  if (nc <= 8) return launch<8>(p, s);
  if (nc <= 12) return launch<12>(p, s);
  if (nc <= 16) return launch<16>(p, s);
  glove_chunk_wide_kernel<<<grid_of(p), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* glove_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
