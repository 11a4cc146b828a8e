// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_attention.py:
// _fwd_kernel (:83), launched by _fwd (:145, pallas_call at :155).
//
// What it computes, for every (batch*head bh, query row i):
//   s_ij = (q_i . k_j) * D^-1/2 + bias[bh / bias_nh, j]
//   causal: s_ij = -1e5 where i < j (key tiles wholly above the diagonal
//           are skipped, as the TPU kernel skips those key blocks)
//   o_i   = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)   (online softmax)
//   lse_i = m_i + log(max(l_i, 1e-30))                     (fp32, [BH, Tq])
// with the running max m, row sum l and the accumulator in fp32.  The mask
// value stays -1e5 (not -inf or -1e9): the backward kernels rebuild
// p = exp(s - lse) from the saved lse, and a fully masked row must keep
// log(Tk) beside the mask value in fp32.  p is cast to v's dtype before p.V.
//
// Bound on an H100 SXM: the larger of
//   operations: 4*B*NH*Tq*Tk*D FLOPs (halved when causal) at 989 TFLOP/s bf16
//   bytes: q, k, v, o once each (plus bias and lse) at 3.35 TB/s.
// The ratio is about Tk/2 FLOP per byte, so below the card's ~295 FLOP/byte
// ridge (Tk < ~600, which includes BERT's 128 and 512) the bytes bound it,
// and above it the tensor cores do.
//
// Design, right before fast:
// - one CTA of 4 warps per (bh, 64-row query tile); each warp owns 16 rows;
//   the query tile is staged in shared memory once;
// - a loop over 64-key tiles takes the place of the TPU grid's sequential
//   key axis: K and V tiles are staged in shared memory with 16-byte loads,
//   and nothing is carried between CTAs;
// - bf16: q.k^T and p.V run on tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 accumulate).  The S accumulator fragment is already the A-operand
//   layout of the second product, so p never leaves registers;
// - fp32 (the compute_dtype="float32" configuration): a CUDA-core kernel,
//   four threads per query row, since bf16 or TF32 tensor cores would not
//   hold fp32's tolerance;
// - the ragged tails of Tq and Tk are zero-filled on load and masked here
//   (keys past Tk get -inf and drop out of the softmax altogether).
// Not yet: wgmma, TMA, cp.async double buffering, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegInit = -1e30f;   // running-max seed only; never stored

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, Tk] rows or nullptr
  void* o;
  float* lse;          // [BH, Tq]
  long long q_sb, q_sh, q_st;   // element strides of batch, head, token
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int nh;        // heads in the layout: bh = b * nh + h
  int bias_nh;   // heads sharing one bias row: row = bh / bias_nh
  int tq, tk, d, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = kFlashKeyTile;   // keys per tile
static_assert(kBQ == kBK, "causal: a CTA's key tiles end with its own rows");
constexpr int kThreads = 128;  // 4 warps x 16 rows

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const FwdParams p) {
  constexpr int LDS = DMAX + 8;  // padded row: conflict-free fragment reads
  constexpr int NT_D = DMAX / 8;
  constexpr int NT_K = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBQ * LDS;
  __nv_bfloat16* sV = sK + kBK * LDS;
  float* sBias = reinterpret_cast<float*>(sV + kBK * LDS);

  const int bh = blockIdx.y;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  const int q0 = blockIdx.x * kBQ;
  const int D = p.d;
  const int dpad = (D + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh + q0 * p.q_st;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* biasg =
      p.bias ? p.bias + static_cast<long long>(bh / p.bias_nh) * p.tk
             : nullptr;

  load_tile_bf16<LDS>(sQ, qg, p.q_st, min(kBQ, p.tq - q0), D, dpad);

  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInit, kNegInit};
  float l_run[2] = {0.f, 0.f};   // this thread's share of the row sum
  const int row0 = q0 + warp * 16 + g;   // c0,c1 rows; c2,c3 are row0 + 8

  int n_kt = (p.tk + kBK - 1) / kBK;
  if (p.causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile_bf16<LDS>(sK, kg + k0 * p.k_st, p.k_st, min(kBK, p.tk - k0), D,
                        dpad);
    load_tile_bf16<LDS>(sV, vg + k0 * p.v_st, p.v_st, min(kBK, p.tk - k0), D,
                        dpad);
    for (int j = threadIdx.x; j < kBK; j += blockDim.x)
      sBias[j] = (biasg != nullptr && k0 + j < p.tk) ? biasg[k0 + j] : 0.f;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT_K][4];
#pragma unroll
    for (int j = 0; j < NT_K; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < D) {
        const __nv_bfloat16* qa = sQ + (warp * 16 + g) * LDS + kk * 16 + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(qa);
        a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LDS);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LDS + 8);
#pragma unroll
        for (int j = 0; j < NT_K; ++j) {
          const __nv_bfloat16* kb = sK + (j * 8 + g) * LDS + kk * 16 + 2 * t;
          mma_16816(s[j], a, *reinterpret_cast<const uint32_t*>(kb),
                    *reinterpret_cast<const uint32_t*>(kb + 8));
        }
      }
    }

    // scale, bias, masks; the tile's row max joins the running max
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int key = k0 + col;
        const int row = row0 + (e >> 1) * 8;
        float x = s[j][e] * p.scale + sBias[col];
        if (p.causal && row < key) x = kMaskVal;
        if (key >= p.tk) x = -INFINITY;
        s[j][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      const float alpha = expf(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
      l_run[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = pe;
        l_run[e >> 1] += pe;
      }
    }

    // O += P V: two S fragments (16 keys) form one A fragment
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32_to_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32_to_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32_to_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32_to_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        if (n * 8 < D) {
          const __nv_bfloat16* vb = sV + (kk * 16 + 2 * t) * LDS + n * 8 + g;
          const uint32_t b0 = pack_bf16x2(vb[0], vb[LDS]);
          const uint32_t b1 = pack_bf16x2(vb[8 * LDS], vb[9 * LDS]);
          mma_16816(acc[n], a, b0, b1);
        }
      }
    }
  }

  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);   // fully masked rows
    const int row = row0 + r * 8;
    if (row < p.tq) {
      __nv_bfloat16* orow = og + row * p.o_st;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        if (n * 8 < D) {
          *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
              pack_f32_to_bf16x2(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
        }
      }
      if (t == 0)
        p.lse[static_cast<long long>(bh) * p.tq + row] = m_run[r] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, four threads per query row
// ---------------------------------------------------------------------------

constexpr int kBQF = 64;          // query rows per CTA
constexpr int kBKF = 32;          // keys per tile
// causal: a CTA's key tiles end with its own 64 rows, the tiles the
// backward rebuilds p over
static_assert(kBQF == kFlashKeyTile && kFlashKeyTile % kBKF == 0,
              "the fp32 forward's causal tiles must match kFlashKeyTile");
constexpr int kTPR = 4;           // threads per row
constexpr int kThreadsF = kBQF * kTPR;

template <int DMAX>
__global__ void __launch_bounds__(kThreadsF)
flash_fwd_f32_kernel(const FwdParams p) {
  constexpr int LD = DMAX + 1;
  constexpr int LDP = kBKF + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [kBQF][LD]
  float* sK = sQ + kBQF * LD;                   // [kBKF][LD]
  float* sV = sK + kBKF * LD;                   // [kBKF][LD]
  float* sP = sV + kBKF * LD;                   // [kBQF][LDP]

  const int bh = blockIdx.y;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  const int q0 = blockIdx.x * kBQF;
  const int D = p.d;
  const int r = threadIdx.x / kTPR, sub = threadIdx.x - r * kTPR;
  const int row = q0 + r;

  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_st;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* biasg =
      p.bias ? p.bias + static_cast<long long>(bh / p.bias_nh) * p.tk
             : nullptr;

  const int q_rows = min(kBQF, p.tq - q0);
  for (int i = threadIdx.x; i < kBQF * D; i += blockDim.x) {
    const int rr = i / D, dd = i - rr * D;
    sQ[rr * LD + dd] = rr < q_rows ? qg[rr * p.q_st + dd] : 0.f;
  }

  float acc[DMAX / kTPR];
#pragma unroll
  for (int i = 0; i < DMAX / kTPR; ++i) acc[i] = 0.f;
  float m_run = kNegInit, l_run = 0.f;

  int n_kt = (p.tk + kBKF - 1) / kBKF;
  if (p.causal) n_kt = min(n_kt, (q0 + kBQF - 1) / kBKF + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBKF;
    const int k_rows = min(kBKF, p.tk - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kBKF * D; i += blockDim.x) {
      const int rr = i / D, dd = i - rr * D;
      const bool live = rr < k_rows;
      sK[rr * LD + dd] = live ? kg[(k0 + rr) * p.k_st + dd] : 0.f;
      sV[rr * LD + dd] = live ? vg[(k0 + rr) * p.v_st + dd] : 0.f;
    }
    __syncthreads();

    // this thread scores keys sub, sub + 4, ... of the tile
#pragma unroll
    for (int jj = 0; jj < kBKF / kTPR; ++jj) {
      const int col = sub + kTPR * jj;
      const int key = k0 + col;
      float dot = 0.f;
      for (int dd = 0; dd < D; ++dd)
        dot = fmaf(sQ[r * LD + dd], sK[col * LD + dd], dot);
      float x = dot * p.scale + (biasg != nullptr && key < p.tk ? biasg[key] : 0.f);
      if (p.causal && row < key) x = kMaskVal;
      if (key >= p.tk) x = -INFINITY;
      sP[r * LDP + col] = x;
    }
    __syncwarp();   // a row's four threads share one warp

    float m_new = m_run;
    for (int c = 0; c < kBKF; ++c) m_new = fmaxf(m_new, sP[r * LDP + c]);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < DMAX / kTPR; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBKF; ++c) {
      const float pc = expf(sP[r * LDP + c] - m_new);
      l_run += pc;
#pragma unroll
      for (int i = 0; i < DMAX / kTPR; ++i) {
        const int dd = sub + kTPR * i;
        if (dd < D) acc[i] = fmaf(pc, sV[c * LD + dd], acc[i]);
      }
    }
  }

  const float l = fmaxf(l_run, 1e-30f);
  if (row < p.tq) {
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                  row * p.o_st;
#pragma unroll
    for (int i = 0; i < DMAX / kTPR; ++i) {
      const int dd = sub + kTPR * i;
      if (dd < D) orow[dd] = acc[i] / l;
    }
    if (sub == 0)
      p.lse[static_cast<long long>(bh) * p.tq + row] = m_run + logf(l);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int DMAX>
int launch_bf16(const FwdParams& p, int bh, cudaStream_t stream) {
  const int smem = (kBQ + 2 * kBK) * (DMAX + 8) * 2 + kBK * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.tq + kBQ - 1) / kBQ, bh);
  flash_fwd_bf16_kernel<DMAX><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_f32(const FwdParams& p, int bh, cudaStream_t stream) {
  const int smem = ((kBQF + 2 * kBKF) * (DMAX + 1) + kBQF * (kBKF + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.tq + kBQF - 1) / kBQF, bh);
  flash_fwd_f32_kernel<DMAX><<<grid, kThreadsF, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, token) for q, k, v, o.
// Returns a cudaError_t; 0 when the launch was accepted.
int flash_fwd(const void* q, const void* k, const void* v, const float* bias,
              void* o, float* lse, const long long* strides, int is_bf16,
              int bh, int nh, int bias_nh, int tq, int tk, int d, int causal,
              float scale, void* stream) {
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.nh = nh;
  p.bias_nh = bias_nh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > 256 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    if (d <= 64) return launch_bf16<64>(p, bh, s);
    if (d <= 128) return launch_bf16<128>(p, bh, s);
    return launch_bf16<256>(p, bh, s);
  }
  if (d <= 64) return launch_f32<64>(p, bh, s);
  if (d <= 128) return launch_f32<128>(p, bh, s);
  return launch_f32<256>(p, bh, s);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
