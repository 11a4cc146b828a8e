// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/pallas_attention.py:
//   B2 flash_bwd_dkv: _bwd_dkv_kernel (:188), pallas_call at :302
//   B3 flash_bwd_dq:  _bwd_dq_kernel  (:240), pallas_call at :329
// both launched by _bwd (:281).
//
// What they compute, for every (batch*head bh, query row i, key j), from the
// fp32 logsumexp the forward (flash_fwd.cu) saved and delta_i = sum_d dO*O:
//   s_ij  = (q_i . k_j) * D^-1/2 + bias[bh / bias_nh, j]
//   causal: s_ij = -1e5 where i < j
//   p_ij  = exp(s_ij - lse_i)
//   dS_ij = p_ij * (dO_i . v_j - delta_i) * D^-1/2
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
// with fp32 sums.  As in the TPU kernel, p is rounded to dO's dtype before
// P^T dO and dS to the input dtype before its two products; the outputs are
// the fp32 sums cast to the input dtype.
//
// p is rebuilt over exactly the (i, j) the forward scored: keys past Tk and
// rows past Tq get p = 0, and under causal masking the forward skipped every
// 64-key tile past the one that holds row i's 64-row tile, so those keys get
// p = 0 too (the saved lse of a row whose every key is masked counts only the
// keys it saw).  Bias-masked keys keep -1e5, so a fully masked row gets
// p = 1/(keys seen), as in the TPU kernel.
//
// Bound on an H100 SXM: the larger of
//   operations: B2 8*BH*Tq*Tk*D FLOPs (four products), B3 6*BH*Tq*Tk*D
//               (three), halved when causal, at 989 TFLOP/s bf16
//   bytes: q, k, v, dO read and the gradients written once, plus lse, delta
//          and the bias, at 3.35 TB/s.
// Like the forward, at BERT's T=128/512 the bytes side is the larger.
//
// Design, right before fast:
// - B2: one CTA of 4 warps per (bh, 64-key tile); each warp owns 16 keys.
//   K and V stay in shared memory while the CTA walks the 64-row query tiles
//   (from the diagonal tile under causal masking); the dK and dV sums stay
//   in registers and are written once.  It computes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T leave the mma.sync accumulators already
//   in the A-operand layout of dV += P^T dO and dK += dS^T Q;
// - B3: one CTA of 4 warps per (bh, 64-row query tile); each warp owns 16
//   rows and walks the 64-key tiles as the forward does, with dS kept in
//   registers for dQ += dS K;
// - bf16 runs on tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums);
// - fp32 (compute_dtype="float32") runs on CUDA cores, four threads per key
//   (B2) or per row (B3), over 32 x 32 tiles; its dot products run in the
//   forward fp32 kernel's order, so s matches the scores behind lse.
// Not yet: wgmma, TMA, cp.async double buffering, ldmatrix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kMaskVal = -1e5f;
constexpr int kCausalTile = 64;   // the forward's key tile under causal masking

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;    // [B, Tk] rows or nullptr
  const float* lse;     // [BH, Tq]
  const float* delta;   // [BH, Tq]
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_st;   // element strides of batch, head, token
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  int nh;        // heads in the layout: bh = b * nh + h
  int bias_nh;   // heads sharing one bias row: row = bh / bias_nh
  int tq, tk, d, causal;
  float scale;
};

// p of (row, key) from the raw dot product q.k, or 0 where the forward
// never scored the pair.
__device__ __forceinline__ float prob(const BwdParams& p, float dot,
                                      float bias, int row, int key,
                                      float lse) {
  if (row >= p.tq || key >= p.tk) return 0.f;
  if (p.causal && key / kCausalTile > row / kCausalTile) return 0.f;
  float x = dot * p.scale + bias;
  if (p.causal && row < key) x = kMaskVal;
  return expf(x - lse);
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, int b, int h,
                                             long long sb, long long sh) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

template <typename T>
__device__ __forceinline__ T* head_ptr_out(void* base, int b, int h,
                                           long long sb, long long sh) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kB = 64;          // keys (B2) or query rows (B3) per CTA, and
                                // the tile walked by the loop
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kNT = kB / 8;     // 8-column C fragments across a 64 tile

using bf16 = __nv_bfloat16;

// B2: dK and dV for one 64-key tile.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const BwdParams p) {
  constexpr int LDS = DMAX + 8;   // padded row: conflict-free fragment reads
  constexpr int NT_D = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB * LDS;
  bf16* sQ = sV + kB * LDS;
  bf16* sdO = sQ + kB * LDS;
  float* sLse = reinterpret_cast<float*>(sdO + kB * LDS);
  float* sDelta = sLse + kB;

  const int bh = blockIdx.y;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  const int k0 = blockIdx.x * kB;
  const int D = p.d;
  const int dpad = (D + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qg = head_ptr<bf16>(p.q, b, h, p.q_sb, p.q_sh);
  const bf16* kg = head_ptr<bf16>(p.k, b, h, p.k_sb, p.k_sh);
  const bf16* vg = head_ptr<bf16>(p.v, b, h, p.v_sb, p.v_sh);
  const bf16* dog = head_ptr<bf16>(p.dout, b, h, p.do_sb, p.do_sh);
  const float* lseg = p.lse + static_cast<long long>(bh) * p.tq;
  const float* deltag = p.delta + static_cast<long long>(bh) * p.tq;

  const int k_rows = min(kB, p.tk - k0);
  load_tile_bf16<LDS>(sK, kg + k0 * p.k_st, p.k_st, k_rows, D, dpad);
  load_tile_bf16<LDS>(sV, vg + k0 * p.v_st, p.v_st, k_rows, D, dpad);

  // this thread's keys: accumulator rows g and g + 8 of its warp's 16
  const int key0 = k0 + warp * 16 + g;
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias_r[r] = (p.bias != nullptr && key < p.tk)
                    ? p.bias[static_cast<long long>(bh / p.bias_nh) * p.tk + key]
                    : 0.f;
  }

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = (p.tq + kB - 1) / kB;
  // under causal masking, query tiles before this key tile never saw it
  const int qt0 = p.causal ? blockIdx.x : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    const int q_rows = min(kB, p.tq - q0);
    __syncthreads();   // every warp is done with the previous Q/dO tile
    load_tile_bf16<LDS>(sQ, qg + q0 * p.q_st, p.q_st, q_rows, D, dpad);
    load_tile_bf16<LDS>(sdO, dog + q0 * p.do_st, p.do_st, q_rows, D, dpad);
    for (int i = threadIdx.x; i < kB; i += blockDim.x) {
      sLse[i] = i < q_rows ? lseg[q0 + i] : 0.f;
      sDelta[i] = i < q_rows ? deltag[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < D) {
        uint32_t ka[4], va[4];
        load_a_frag<LDS>(ka, sK, warp * 16, kk * 16, g, t);
        load_a_frag<LDS>(va, sV, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_a_xt<LDS>(s[j], ka, sQ, j * 8, kk * 16, g, t);
          mma_a_xt<LDS>(dp[j], va, sdO, j * 8, kk * 16, g, t);
        }
      }
    }

    // P^T and dS^T in place of S^T and dP^T
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);   // query within the tile
        const float pr = prob(p, s[j][e], bias_r[e >> 1], q0 + col,
                              key0 + 8 * (e >> 1), sLse[col]);
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - sDelta[col]) * p.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, 16 queries per step
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a_frag(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        if (n * 8 < D) {
          mma_a_x<LDS>(dv_acc[n], pa, sdO, kk * 16, n * 8, g, t);
          mma_a_x<LDS>(dk_acc[n], da, sQ, kk * 16, n * 8, g, t);
        }
      }
    }
  }

  bf16* dkg = head_ptr_out<bf16>(p.dk, b, h, p.dk_sb, p.dk_sh);
  bf16* dvg = head_ptr_out<bf16>(p.dv, b, h, p.dv_sb, p.dv_sh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < p.tk) {
      bf16* dkrow = dkg + key * p.dk_st;
      bf16* dvrow = dvg + key * p.dv_st;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        if (n * 8 < D) {
          *reinterpret_cast<uint32_t*>(dkrow + n * 8 + 2 * t) =
              pack_f32_to_bf16x2(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvrow + n * 8 + 2 * t) =
              pack_f32_to_bf16x2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
        }
      }
    }
  }
}

// B3: dQ for one 64-row query tile.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const BwdParams p) {
  constexpr int LDS = DMAX + 8;
  constexpr int NT_D = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kB * LDS;
  bf16* sK = sdO + kB * LDS;
  bf16* sV = sK + kB * LDS;
  float* sBias = reinterpret_cast<float*>(sV + kB * LDS);

  const int bh = blockIdx.y;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  const int q0 = blockIdx.x * kB;
  const int D = p.d;
  const int dpad = (D + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qg = head_ptr<bf16>(p.q, b, h, p.q_sb, p.q_sh);
  const bf16* kg = head_ptr<bf16>(p.k, b, h, p.k_sb, p.k_sh);
  const bf16* vg = head_ptr<bf16>(p.v, b, h, p.v_sb, p.v_sh);
  const bf16* dog = head_ptr<bf16>(p.dout, b, h, p.do_sb, p.do_sh);
  const float* biasg =
      p.bias ? p.bias + static_cast<long long>(bh / p.bias_nh) * p.tk
             : nullptr;

  const int q_rows = min(kB, p.tq - q0);
  load_tile_bf16<LDS>(sQ, qg + q0 * p.q_st, p.q_st, q_rows, D, dpad);
  load_tile_bf16<LDS>(sdO, dog + q0 * p.do_st, p.do_st, q_rows, D, dpad);

  // this thread's rows: accumulator rows g and g + 8 of its warp's 16
  const int row0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = static_cast<long long>(bh) * p.tq + row;
    lse_r[r] = row < p.tq ? p.lse[at] : 0.f;
    delta_r[r] = row < p.tq ? p.delta[at] : 0.f;
  }

  float dq_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  int n_kt = (p.tk + kB - 1) / kB;
  if (p.causal) n_kt = min(n_kt, static_cast<int>(blockIdx.x) + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    const int k_rows = min(kB, p.tk - k0);
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile_bf16<LDS>(sK, kg + k0 * p.k_st, p.k_st, k_rows, D, dpad);
    load_tile_bf16<LDS>(sV, vg + k0 * p.v_st, p.v_st, k_rows, D, dpad);
    for (int j = threadIdx.x; j < kB; j += blockDim.x)
      sBias[j] = (biasg != nullptr && j < k_rows) ? biasg[k0 + j] : 0.f;
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < D) {
        uint32_t qa[4], oa[4];
        load_a_frag<LDS>(qa, sQ, warp * 16, kk * 16, g, t);
        load_a_frag<LDS>(oa, sdO, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_a_xt<LDS>(s[j], qa, sK, j * 8, kk * 16, g, t);
          mma_a_xt<LDS>(dp[j], oa, sV, j * 8, kk * 16, g, t);
        }
      }
    }

    // dS in place of S
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);   // key within the tile
        const int r = e >> 1;
        const float pr = prob(p, s[j][e], sBias[col], row0 + 8 * r, k0 + col,
                              lse_r[r]);
        s[j][e] = pr * (dp[j][e] - delta_r[r]) * p.scale;
      }
    }

    // dQ += dS K, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t da[4];
      c_to_a_frag(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        if (n * 8 < D) mma_a_x<LDS>(dq_acc[n], da, sK, kk * 16, n * 8, g, t);
    }
  }

  bf16* dqg = head_ptr_out<bf16>(p.dq, b, h, p.dq_sb, p.dq_sh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.tq) {
      bf16* dqrow = dqg + row * p.dq_st;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        if (n * 8 < D) {
          *reinterpret_cast<uint32_t*>(dqrow + n * 8 + 2 * t) =
              pack_f32_to_bf16x2(dq_acc[n][2 * r], dq_acc[n][2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, four threads per key (B2) or per query row (B3)
// ---------------------------------------------------------------------------

constexpr int kBF = 32;                 // keys and query rows per tile
constexpr int kTPR = 4;                 // threads per key or row
constexpr int kThreadsF = kBF * kTPR;   // 128

// Stage a [kBF, d] fp32 tile with row stride LD; rows past `rows` are zero.
template <int LD>
__device__ __forceinline__ void load_tile_f32(float* s, const float* g,
                                              long long st, int rows, int d) {
  for (int i = threadIdx.x; i < kBF * d; i += blockDim.x) {
    const int r = i / d, c = i - (i / d) * d;
    s[r * LD + c] = r < rows ? g[r * st + c] : 0.f;
  }
}

// B2, fp32: dK and dV for one 32-key tile; thread (r, sub) owns key r and
// columns sub, sub + 4, ... of its dK and dV rows.
template <int DMAX>
__global__ void __launch_bounds__(kThreadsF)
flash_bwd_dkv_f32_kernel(const BwdParams p) {
  constexpr int LD = DMAX + 1;
  constexpr int LDP = kBF + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);   // [kBF][LD]
  float* sV = sK + kBF * LD;
  float* sQ = sV + kBF * LD;
  float* sdO = sQ + kBF * LD;
  float* sP = sdO + kBF * LD;                   // [kBF keys][LDP queries]
  float* sDS = sP + kBF * LDP;
  float* sLse = sDS + kBF * LDP;
  float* sDelta = sLse + kBF;

  const int bh = blockIdx.y;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  const int k0 = blockIdx.x * kBF;
  const int D = p.d;
  const int r = threadIdx.x / kTPR, sub = threadIdx.x - r * kTPR;
  const int key = k0 + r;

  const float* qg = head_ptr<float>(p.q, b, h, p.q_sb, p.q_sh);
  const float* kg = head_ptr<float>(p.k, b, h, p.k_sb, p.k_sh);
  const float* vg = head_ptr<float>(p.v, b, h, p.v_sb, p.v_sh);
  const float* dog = head_ptr<float>(p.dout, b, h, p.do_sb, p.do_sh);
  const float* lseg = p.lse + static_cast<long long>(bh) * p.tq;
  const float* deltag = p.delta + static_cast<long long>(bh) * p.tq;

  const int k_rows = min(kBF, p.tk - k0);
  load_tile_f32<LD>(sK, kg + k0 * p.k_st, p.k_st, k_rows, D);
  load_tile_f32<LD>(sV, vg + k0 * p.v_st, p.v_st, k_rows, D);
  const float bias_k =
      (p.bias != nullptr && key < p.tk)
          ? p.bias[static_cast<long long>(bh / p.bias_nh) * p.tk + key]
          : 0.f;

  float dk[DMAX / kTPR], dv[DMAX / kTPR];
#pragma unroll
  for (int i = 0; i < DMAX / kTPR; ++i) dk[i] = dv[i] = 0.f;

  const int n_qt = (p.tq + kBF - 1) / kBF;
  // under causal masking, rows before this key's 64-tile never saw it
  const int qt0 = p.causal ? (k0 / kCausalTile) * (kCausalTile / kBF) : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBF;
    const int q_rows = min(kBF, p.tq - q0);
    __syncthreads();
    load_tile_f32<LD>(sQ, qg + q0 * p.q_st, p.q_st, q_rows, D);
    load_tile_f32<LD>(sdO, dog + q0 * p.do_st, p.do_st, q_rows, D);
    for (int i = threadIdx.x; i < kBF; i += blockDim.x) {
      sLse[i] = i < q_rows ? lseg[q0 + i] : 0.f;
      sDelta[i] = i < q_rows ? deltag[q0 + i] : 0.f;
    }
    __syncthreads();

    // this thread scores queries sub, sub + 4, ... of the tile
#pragma unroll
    for (int jj = 0; jj < kBF / kTPR; ++jj) {
      const int c = sub + kTPR * jj;
      float dot = 0.f, dpv = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        dot = fmaf(sQ[c * LD + dd], sK[r * LD + dd], dot);
        dpv = fmaf(sdO[c * LD + dd], sV[r * LD + dd], dpv);
      }
      const float pr = prob(p, dot, bias_k, q0 + c, key, sLse[c]);
      sP[r * LDP + c] = pr;
      sDS[r * LDP + c] = pr * (dpv - sDelta[c]) * p.scale;
    }
    __syncwarp();   // a key's four threads share one warp

    for (int c = 0; c < kBF; ++c) {
      const float pc = sP[r * LDP + c];
      const float dc = sDS[r * LDP + c];
#pragma unroll
      for (int i = 0; i < DMAX / kTPR; ++i) {
        const int dd = sub + kTPR * i;
        if (dd < D) {
          dv[i] = fmaf(pc, sdO[c * LD + dd], dv[i]);
          dk[i] = fmaf(dc, sQ[c * LD + dd], dk[i]);
        }
      }
    }
  }

  if (key < p.tk) {
    float* dkrow = head_ptr_out<float>(p.dk, b, h, p.dk_sb, p.dk_sh) +
                   key * p.dk_st;
    float* dvrow = head_ptr_out<float>(p.dv, b, h, p.dv_sb, p.dv_sh) +
                   key * p.dv_st;
#pragma unroll
    for (int i = 0; i < DMAX / kTPR; ++i) {
      const int dd = sub + kTPR * i;
      if (dd < D) {
        dkrow[dd] = dk[i];
        dvrow[dd] = dv[i];
      }
    }
  }
}

// B3, fp32: dQ for one 32-row query tile; thread (r, sub) owns row r and
// columns sub, sub + 4, ... of its dQ row.
template <int DMAX>
__global__ void __launch_bounds__(kThreadsF)
flash_bwd_dq_f32_kernel(const BwdParams p) {
  constexpr int LD = DMAX + 1;
  constexpr int LDP = kBF + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [kBF][LD]
  float* sdO = sQ + kBF * LD;
  float* sK = sdO + kBF * LD;
  float* sV = sK + kBF * LD;
  float* sDS = sV + kBF * LD;                   // [kBF rows][LDP keys]
  float* sBias = sDS + kBF * LDP;

  const int bh = blockIdx.y;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  const int q0 = blockIdx.x * kBF;
  const int D = p.d;
  const int r = threadIdx.x / kTPR, sub = threadIdx.x - r * kTPR;
  const int row = q0 + r;

  const float* qg = head_ptr<float>(p.q, b, h, p.q_sb, p.q_sh);
  const float* kg = head_ptr<float>(p.k, b, h, p.k_sb, p.k_sh);
  const float* vg = head_ptr<float>(p.v, b, h, p.v_sb, p.v_sh);
  const float* dog = head_ptr<float>(p.dout, b, h, p.do_sb, p.do_sh);
  const float* biasg =
      p.bias ? p.bias + static_cast<long long>(bh / p.bias_nh) * p.tk
             : nullptr;

  const int q_rows = min(kBF, p.tq - q0);
  load_tile_f32<LD>(sQ, qg + q0 * p.q_st, p.q_st, q_rows, D);
  load_tile_f32<LD>(sdO, dog + q0 * p.do_st, p.do_st, q_rows, D);
  const long long at = static_cast<long long>(bh) * p.tq + row;
  const float lse = row < p.tq ? p.lse[at] : 0.f;
  const float delta = row < p.tq ? p.delta[at] : 0.f;

  float dq[DMAX / kTPR];
#pragma unroll
  for (int i = 0; i < DMAX / kTPR; ++i) dq[i] = 0.f;

  int n_kt = (p.tk + kBF - 1) / kBF;
  if (p.causal) {
    // keys up to the end of the 64-tile of the tile's last row
    const int last_tile = (q0 + kBF - 1) / kCausalTile;
    n_kt = min(n_kt, (last_tile + 1) * (kCausalTile / kBF));
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBF;
    const int k_rows = min(kBF, p.tk - k0);
    __syncthreads();
    load_tile_f32<LD>(sK, kg + k0 * p.k_st, p.k_st, k_rows, D);
    load_tile_f32<LD>(sV, vg + k0 * p.v_st, p.v_st, k_rows, D);
    for (int j = threadIdx.x; j < kBF; j += blockDim.x)
      sBias[j] = (biasg != nullptr && j < k_rows) ? biasg[k0 + j] : 0.f;
    __syncthreads();

    // this thread scores keys sub, sub + 4, ... of the tile
#pragma unroll
    for (int jj = 0; jj < kBF / kTPR; ++jj) {
      const int c = sub + kTPR * jj;
      float dot = 0.f, dpv = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        dot = fmaf(sQ[r * LD + dd], sK[c * LD + dd], dot);
        dpv = fmaf(sdO[r * LD + dd], sV[c * LD + dd], dpv);
      }
      const float pr = prob(p, dot, sBias[c], row, k0 + c, lse);
      sDS[r * LDP + c] = pr * (dpv - delta) * p.scale;
    }
    __syncwarp();   // a row's four threads share one warp

    for (int c = 0; c < kBF; ++c) {
      const float dc = sDS[r * LDP + c];
#pragma unroll
      for (int i = 0; i < DMAX / kTPR; ++i) {
        const int dd = sub + kTPR * i;
        if (dd < D) dq[i] = fmaf(dc, sK[c * LD + dd], dq[i]);
      }
    }
  }

  if (row < p.tq) {
    float* dqrow = head_ptr_out<float>(p.dq, b, h, p.dq_sb, p.dq_sh) +
                   row * p.dq_st;
#pragma unroll
    for (int i = 0; i < DMAX / kTPR; ++i) {
      const int dd = sub + kTPR * i;
      if (dd < D) dqrow[dd] = dq[i];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_dkv(const BwdParams& p, int is_bf16, int bh, cudaStream_t s) {
  if (is_bf16) {
    const int smem = 4 * kB * (DMAX + 8) * 2 + 2 * kB * 4;
    return launch(flash_bwd_dkv_bf16_kernel<DMAX>,
                  dim3((p.tk + kB - 1) / kB, bh), kThreads, smem, p, s);
  }
  const int smem =
      (4 * kBF * (DMAX + 1) + 2 * kBF * (kBF + 1) + 2 * kBF) * 4;
  return launch(flash_bwd_dkv_f32_kernel<DMAX>,
                dim3((p.tk + kBF - 1) / kBF, bh), kThreadsF, smem, p, s);
}

template <int DMAX>
int launch_dq(const BwdParams& p, int is_bf16, int bh, cudaStream_t s) {
  if (is_bf16) {
    const int smem = 4 * kB * (DMAX + 8) * 2 + kB * 4;
    return launch(flash_bwd_dq_bf16_kernel<DMAX>,
                  dim3((p.tq + kB - 1) / kB, bh), kThreads, smem, p, s);
  }
  const int smem = (4 * kBF * (DMAX + 1) + kBF * (kBF + 1) + kBF) * 4;
  return launch(flash_bwd_dq_f32_kernel<DMAX>,
                dim3((p.tq + kBF - 1) / kBF, bh), kThreadsF, smem, p, s);
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const float* bias, const float* lse,
                      const float* delta, void* dq, void* dk, void* dv,
                      const long long* st, int nh, int bias_nh, int tq,
                      int tk, int d, int causal, float scale) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.bias = bias;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = st[0];   p.q_sh = st[1];   p.q_st = st[2];
  p.k_sb = st[3];   p.k_sh = st[4];   p.k_st = st[5];
  p.v_sb = st[6];   p.v_sh = st[7];   p.v_st = st[8];
  p.do_sb = st[9];  p.do_sh = st[10]; p.do_st = st[11];
  p.dq_sb = st[12]; p.dq_sh = st[13]; p.dq_st = st[14];
  p.dk_sb = st[15]; p.dk_sh = st[16]; p.dk_st = st[17];
  p.dv_sb = st[18]; p.dv_sh = st[19]; p.dv_st = st[20];
  p.nh = nh;
  p.bias_nh = bias_nh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// strides: 21 element strides, (batch, head, token) for q, k, v, dout, dq,
// dk, dv.  Each entry point returns a cudaError_t; 0 when the launch was
// accepted.  flash_bwd_dkv writes dk and dv (dq unused); flash_bwd_dq
// writes dq (dk, dv unused).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* bias, const float* lse,
                  const float* delta, void* dq, void* dk, void* dv,
                  const long long* strides, int is_bf16, int bh, int nh,
                  int bias_nh, int tq, int tk, int d, int causal, float scale,
                  void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p = make_params(q, k, v, dout, bias, lse, delta, dq, dk,
                                  dv, strides, nh, bias_nh, tq, tk, d,
                                  causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dkv<64>(p, is_bf16, bh, s);
  if (d <= 128) return launch_dkv<128>(p, is_bf16, bh, s);
  return launch_dkv<256>(p, is_bf16, bh, s);
}

int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* bias, const float* lse,
                 const float* delta, void* dq, void* dk, void* dv,
                 const long long* strides, int is_bf16, int bh, int nh,
                 int bias_nh, int tq, int tk, int d, int causal, float scale,
                 void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p = make_params(q, k, v, dout, bias, lse, delta, dq, dk,
                                  dv, strides, nh, bias_nh, tq, tk, d,
                                  causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dq<64>(p, is_bf16, bh, s);
  if (d <= 128) return launch_dq<128>(p, is_bf16, bh, s);
  return launch_dq<256>(p, is_bf16, bh, s);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
