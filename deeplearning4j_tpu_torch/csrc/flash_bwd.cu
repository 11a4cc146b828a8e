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
// At BERT's T=128 the bytes side is the larger, from T=512 on the
// operations side (B=8, NH=12, D=64).
//
// Design.  bf16 with D = 64 or 128 takes the Hopper path (wgmma + TMA);
// every other case keeps the first kernels (mma.sync for bf16, CUDA cores
// for fp32).  The C entry points choose by that rule alone
// (flash_bwd_route), and nothing falls back at run time.
//
// Hopper path (one or two consumer warpgroups of 64 keys or rows each,
// and one producer warp that issues every load):
// - B2: a CTA per (bh, 128-key block; 64 keys at D = 128, see DkvShape);
//   each consumer warpgroup owns 64 keys.  K and V arrive once by TMA; the
//   producer warp streams the query tiles (64 rows, 32 for D = 128) of Q
//   and dO by TMA, with lse and delta, into a ring of 3 stages guarded by
//   mbarriers, so later tiles load while the consumers compute on this
//   one.  S^T = K Q^T and dP^T = V dO^T are wgmma m64nNk16 with both
//   operands in shared memory; P^T and dS^T go from the fp32 accumulators
//   straight into the register A operand of dV += P^T dO and dK += dS^T Q,
//   whose B operand (dO, Q) is read transposed through the descriptor's
//   transpose bit.  p is formed while dP^T is still running, and dV/dK of
//   one tile run while the next tile's S^T and P^T are formed.  dK and dV
//   stay in registers and are written once.
// - B3: a CTA per (bh, 128-row block), Q and dO once by TMA, K, V and the
//   bias streamed in 64-key tiles (32 at D = 128); dS feeds dQ += dS K the
//   same way.
// - Tiles sit in shared memory in the 128-byte-swizzled layout that a row
//   of 64 bf16 fills exactly (hopper_sm90.cuh); D = 128 is two such
//   column halves.  The tensor maps describe [B, T, NH, D] through the
//   wrapper's strides and are built in the entry point (make_map, shared
//   with the forward in flash_sm90.cuh).
// - Under causal masking the CTAs with the most tiles launch first, and a
//   warpgroup whose keys (B2) or rows (B3) a tile cannot reach skips its
//   products for that tile.
// First path (mma.sync m16n8k16 for bf16; CUDA cores for fp32):
// - B2: one CTA of 4 warps per (bh, 64-key tile); each warp owns 16 keys.
//   K and V stay in shared memory while the CTA walks the 64-row query tiles
//   (from the diagonal tile under causal masking); the dK and dV sums stay
//   in registers and are written once.  It computes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T leave the mma.sync accumulators already
//   in the A-operand layout of dV += P^T dO and dK += dS^T Q;
// - B3: one CTA of 4 warps per (bh, 64-row query tile); each warp owns 16
//   rows and walks the 64-key tiles as the forward does, with dS kept in
//   registers for dQ += dS K;
// - fp32 (compute_dtype="float32") runs on CUDA cores, four threads per key
//   (B2) or per row (B3), over 32 x 32 tiles; its dot products run in the
//   forward fp32 kernel's order, so s matches the scores behind lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kCausalTile = kFlashKeyTile;

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
// bf16, D = 64 or 128: wgmma and TMA (Hopper)
// ---------------------------------------------------------------------------
//
// A CTA is 64 * WGS consumer rows (B2: keys, B3: query rows), one consumer
// warpgroup per 64, plus one producer warp.  ptxas holds every thread of a
// CTA to the same register budget, which the register file's four
// quarters set: 168 a thread where a quarter hosts 3 warps (two consumer
// warpgroups + the producer), 255 where it hosts 2.  B2 at D = 128 keeps
// 2 x 64 x 128 fp32 sums (dK, dV) a warpgroup, so it runs one consumer
// warpgroup (64 keys); every other case runs two.

constexpr int kStages = 3;   // streamed tiles in flight

// B2: keys per warpgroup are 64; the query tile is 64 rows, 32 at D = 128
template <int D>
struct DkvShape {
  static constexpr int WGS = D == 64 ? 2 : 1;
  static constexpr int KEYS = 64 * WGS;
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int THREADS = WGS * 128 + 32;
  static constexpr int SMEM = 2 * KEYS * D * 2 + 2 * kStages * BQ * D * 2 +
                              2 * kStages * BQ * 4 + (2 * kStages + 1) * 8 +
                              1024;
};

// B3: 128 query rows; the key tile is 64 keys, 32 at D = 128
template <int D>
struct DqShape {
  static constexpr int WGS = 2;
  static constexpr int ROWS = 64 * WGS;
  static constexpr int BK = D == 64 ? 64 : 32;
  static constexpr int THREADS = WGS * 128 + 32;
  static constexpr int SMEM = 2 * ROWS * D * 2 + 2 * kStages * BK * D * 2 +
                              kStages * BK * 4 + (2 * kStages + 1) * 8 + 1024;
};

// The exponent of p, log2(e) * (s - lse), of a pair at a tile's edge:
// prob()'s cases.  -inf (p = 0) where the forward never scored the pair;
// the mask value's where causal masking hides the key inside the row's
// own tile; x, the exponent of an unmasked pair, otherwise.
__device__ __forceinline__ float edge_exponent(const BwdParams& p, float x,
                                               int row, int key, float lse) {
  if (row >= p.tq || key >= p.tk) return -INFINITY;
  if (p.causal) {
    if (key / kCausalTile > row / kCausalTile) return -INFINITY;
    if (row < key) return (kMaskVal - lse) * kLog2e;
  }
  return x;
}

// B2: dK and dV for one block of 64 * WGS keys.
template <int D>
__global__ void __launch_bounds__(DkvShape<D>::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const BwdParams p,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do) {
  constexpr int BQ = DkvShape<D>::BQ;
  constexpr int KEYS = DkvShape<D>::KEYS;
  constexpr int CONSUMER_WARPS = 4 * DkvShape<D>::WGS;
  constexpr int KV_BYTES = KEYS * D * 2;
  constexpr int Q_BYTES = BQ * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + KV_BYTES;
  unsigned char* sQ = sV + KV_BYTES;              // [kStages] tiles
  unsigned char* sdO = sQ + kStages * Q_BYTES;    // [kStages] tiles
  float* sLse = reinterpret_cast<float*>(sdO + kStages * Q_BYTES);
  float* sDelta = sLse + kStages * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(sDelta + kStages * BQ);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  const int k0 = blockIdx.y * KEYS;
  const int n_qt = (p.tq + BQ - 1) / BQ;
  // under causal masking, rows before this key block never saw it
  const int qt0 = p.causal ? k0 / BQ : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                // the producer warp's lanes
      mbar_init(&empty[s], CONSUMER_WARPS);   // one lane per consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: K and V once, then the Q/dO/lse/delta ring
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
      tma_tile<D>(sK, KEYS, &tm_k, kv_full, k0, h, b);
      tma_tile<D>(sV, KEYS, &tm_v, kv_full, k0, h, b);
    }
    const float* lseg = p.lse + static_cast<long long>(bh) * p.tq;
    const float* deltag = p.delta + static_cast<long long>(bh) * p.tq;
    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      const int q0 = qt * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const bool live = q0 + i < p.tq;
        sLse[s * BQ + i] = live ? lseg[q0 + i] : 0.f;
        sDelta[s * BQ + i] = live ? deltag[q0 + i] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * Q_BYTES);
        tma_tile<D>(sQ + s * Q_BYTES, BQ, &tm_q, &full[s], q0, h, b);
        tma_tile<D>(sdO + s * Q_BYTES, BQ, &tm_do, &full[s], q0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys kw0..kw0+63; this thread's keys are
  // accumulator rows g and g + 8 of its warp's 16
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * wl + g;
  const float sl2 = p.scale * kLog2e;
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias_r[r] = (p.bias != nullptr && key < p.tk)
                    ? p.bias[static_cast<long long>(bh / p.bias_nh) * p.tk + key]
                    : 0.f;
  }
  float dk[D / 64][32], dv[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[hh][i] = dv[hh][i] = 0.f;

  const uint32_t aK = smem_u32(sK), aV = smem_u32(sV);
  const bool wg_live = kw0 < p.tk;
  int held = -1;   // the stage the last dV/dK products still read
  mbar_wait(kv_full, 0);
  for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const int q0 = qt * BQ;
    // a tile whose rows all lie in causal tiles before this warpgroup's
    // keys has p = 0 throughout
    if (!wg_live || (p.causal && q0 / kCausalTile < kw0 / kCausalTile)) {
      release_stage(&empty[s], lane);
      continue;
    }
    const uint32_t aQ = smem_u32(sQ + s * Q_BYTES);
    const uint32_t adO = smem_u32(sdO + s * Q_BYTES);
    // S^T = K Q^T and dP^T = V dO^T (64 keys x BQ queries), in two
    // groups behind the previous tile's dV/dK products
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, desc_kmajor(aK, KEYS, 64 * wg, kk),
               desc_kmajor(aQ, BQ, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, desc_kmajor(aV, KEYS, 64 * wg, kk),
               desc_kmajor(adO, BQ, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // the previous dV/dK products and S^T are done
    fence_regs(st);
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) {
      fence_regs(dv[hh]);
      fence_regs(dk[hh]);
    }
    if (held >= 0) release_stage(&empty[held], lane);

    // P^T in place of S^T, while dP^T runs: p = 2^(log2e (s - lse))
    const bool interior = q0 + BQ <= p.tq && kw0 + 64 <= p.tk &&
                          (!p.causal || q0 >= kw0 + 64);
    const float2* lse2 = reinterpret_cast<const float2*>(sLse + s * BQ);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = lse2[4 * j + t];   // queries 8j + 2t and + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e >> 1;
        const float lse = (e & 1) ? l2.y : l2.x;
        float x = fmaf(st[i], sl2, (bias_r[r] - lse) * kLog2e);
        if (!interior)
          x = edge_exponent(p, x, q0 + 8 * j + 2 * t + (e & 1), key0 + 8 * r,
                            lse);
        st[i] = exp2f(x);
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    // dS^T in place of dP^T
    const float2* delta2 = reinterpret_cast<const float2*>(sDelta + s * BQ);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = delta2[4 * j + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x)) * p.scale;
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a(pa[kk], st, kk);
      acc_to_a(da[kk], dpt, kk);
    }

    // dV += P^T dO and dK += dS^T Q, 16 queries per step; they run on
    // while the next tile's S^T and P^T are computed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh) {
        wgmma_rs_tb_n64(dv[hh], pa[kk], desc_mnmajor(adO, BQ, kk, hh));
        wgmma_rs_tb_n64(dk[hh], da[kk], desc_mnmajor(aQ, BQ, kk, hh));
      }
    }
    wgmma_commit();
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) {
      fence_regs(dv[hh]);
      fence_regs(dk[hh]);
    }
    held = s;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
    fence_regs(dv[hh]);
    fence_regs(dk[hh]);
  }
  if (held >= 0) release_stage(&empty[held], lane);

  bf16* dkg = head_ptr_out<bf16>(p.dk, b, h, p.dk_sb, p.dk_sh);
  bf16* dvg = head_ptr_out<bf16>(p.dv, b, h, p.dv_sb, p.dv_sh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < p.tk) {
      bf16* dkrow = dkg + key * p.dk_st;
      bf16* dvrow = dvg + key * p.dv_st;
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * hh + 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(dkrow + col) = pack_f32_to_bf16x2(
              dk[hh][4 * j + 2 * r], dk[hh][4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvrow + col) = pack_f32_to_bf16x2(
              dv[hh][4 * j + 2 * r], dv[hh][4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// B3: dQ for one block of 128 query rows.
template <int D>
__global__ void __launch_bounds__(DqShape<D>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const BwdParams p,
                          const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do) {
  constexpr int ROWS = DqShape<D>::ROWS;
  constexpr int BK = DqShape<D>::BK;
  constexpr int CONSUMER_WARPS = 4 * DqShape<D>::WGS;
  constexpr int Q_BYTES = ROWS * D * 2;
  constexpr int K_BYTES = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + Q_BYTES;
  unsigned char* sK = sdO + Q_BYTES;              // [kStages] tiles
  unsigned char* sV = sK + kStages * K_BYTES;     // [kStages] tiles
  float* sBias = reinterpret_cast<float*>(sV + kStages * K_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + kStages * BK);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.nh, h = bh - (bh / p.nh) * p.nh;
  // under causal masking the last row blocks walk the most key tiles:
  // launch them first
  const int rb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = rb * ROWS;
  int n_kt = (p.tk + BK - 1) / BK;
  if (p.causal) {
    // keys up to the end of the causal tile of the block's last row
    const int last_row = min(q0 + ROWS, p.tq) - 1;
    n_kt = min(n_kt, (last_row / kCausalTile + 1) * kCausalTile / BK);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: Q and dO once, then the K/V/bias ring
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * Q_BYTES);
      tma_tile<D>(sQ, ROWS, &tm_q, q_full, q0, h, b);
      tma_tile<D>(sdO, ROWS, &tm_do, q_full, q0, h, b);
    }
    const float* biasg =
        p.bias ? p.bias + static_cast<long long>(bh / p.bias_nh) * p.tk
               : nullptr;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
      const int k0 = kt * BK;
      for (int j = lane; j < BK; j += 32)
        sBias[s * BK + j] =
            (biasg != nullptr && k0 + j < p.tk) ? biasg[k0 + j] : 0.f;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * K_BYTES);
        tma_tile<D>(sK + s * K_BYTES, BK, &tm_k, &full[s], k0, h, b);
        tma_tile<D>(sV + s * K_BYTES, BK, &tm_v, &full[s], k0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows rw0..rw0+63; this thread's rows are
  // accumulator rows g and g + 8 of its warp's 16
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int rw0 = q0 + 64 * wg;
  const int row0 = rw0 + 16 * wl + g;
  const float sl2 = p.scale * kLog2e;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = static_cast<long long>(bh) * p.tq + row;
    lse_r[r] = row < p.tq ? p.lse[at] : 0.f;
    delta_r[r] = row < p.tq ? p.delta[at] : 0.f;
  }
  float dq[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[hh][i] = 0.f;

  const uint32_t aQ = smem_u32(sQ), adO = smem_u32(sdO);
  const bool wg_live = rw0 < p.tq;
  int held = -1;   // the stage the last dQ products still read
  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const int k0 = kt * BK;
    // a key tile past the causal tile of every row of this warpgroup has
    // p = 0 throughout
    if (!wg_live || (p.causal && k0 / kCausalTile > rw0 / kCausalTile)) {
      release_stage(&empty[s], lane);
      continue;
    }
    const uint32_t aK = smem_u32(sK + s * K_BYTES);
    const uint32_t aV = smem_u32(sV + s * K_BYTES);
    // S = Q K^T and dP = dO V^T (64 rows x 64 keys), in two groups
    // behind the previous tile's dQ products
    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_kmajor(aQ, ROWS, 64 * wg, kk),
               desc_kmajor(aK, BK, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_kmajor(adO, ROWS, 64 * wg, kk),
               desc_kmajor(aV, BK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // the previous dQ products and S are done
    fence_regs(sc);
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) fence_regs(dq[hh]);
    if (held >= 0) release_stage(&empty[held], lane);

    // P in place of S, while dP runs
    const bool interior = rw0 + 64 <= p.tq && k0 + BK <= p.tk &&
                          (!p.causal || k0 + BK <= rw0);
    const float2* bias2 =
        reinterpret_cast<const float2*>(sBias + s * BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 b2 = bias2[4 * j + t];   // keys 8j + 2t and + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e >> 1;
        float x = fmaf(sc[i], sl2,
                       (((e & 1) ? b2.y : b2.x) - lse_r[r]) * kLog2e);
        if (!interior)
          x = edge_exponent(p, x, row0 + 8 * r, k0 + 8 * j + 2 * t + (e & 1),
                            lse_r[r]);
        sc[i] = exp2f(x);
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS in place of P
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = sc[i] * (dp[i] - delta_r[(i >> 1) & 1]) * p.scale;
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(da[kk], sc, kk);

    // dQ += dS K, 16 keys per step; it runs on while the next tile's S
    // and P are computed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh)
        wgmma_rs_tb_n64(dq[hh], da[kk], desc_mnmajor(aK, BK, kk, hh));
    wgmma_commit();
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) fence_regs(dq[hh]);
    held = s;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) fence_regs(dq[hh]);
  if (held >= 0) release_stage(&empty[held], lane);

  bf16* dqg = head_ptr_out<bf16>(p.dq, b, h, p.dq_sb, p.dq_sh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.tq) {
      bf16* dqrow = dqg + row * p.dq_st;
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dqrow + 64 * hh + 8 * j + 2 * t) =
              pack_f32_to_bf16x2(dq[hh][4 * j + 2 * r],
                                 dq[hh][4 * j + 2 * r + 1]);
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

// Tensor maps of q, k, v and dout; q and dout in boxes of q_rows tokens,
// k and v of k_rows.
int make_maps(CUtensorMap (&m)[4], const BwdParams& p, int bh, int q_rows,
              int k_rows) {
  int err = make_map(&m[0], p.q, p.q_sb, p.q_sh, p.q_st, p.nh, bh, p.tq, p.d,
                     q_rows, "flash_bwd");
  if (!err)
    err = make_map(&m[1], p.k, p.k_sb, p.k_sh, p.k_st, p.nh, bh, p.tk, p.d,
                   k_rows, "flash_bwd");
  if (!err)
    err = make_map(&m[2], p.v, p.v_sb, p.v_sh, p.v_st, p.nh, bh, p.tk, p.d,
                   k_rows, "flash_bwd");
  if (!err)
    err = make_map(&m[3], p.dout, p.do_sb, p.do_sh, p.do_st, p.nh, bh, p.tq,
                   p.d, q_rows, "flash_bwd");
  return err;
}

template <typename Kernel>
int launch_wgmma(Kernel kernel, dim3 grid, int threads, int smem,
                 const BwdParams& p, const CUtensorMap (&m)[4],
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p, m[0], m[1], m[2], m[3]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_wgmma(const BwdParams& p, int bh, cudaStream_t s) {
  using S = DkvShape<D>;
  CUtensorMap m[4];
  const int err = make_maps(m, p, bh, S::BQ, S::KEYS);
  if (err) return err;
  return launch_wgmma(flash_bwd_dkv_wgmma_kernel<D>,
                      dim3(bh, (p.tk + S::KEYS - 1) / S::KEYS), S::THREADS,
                      S::SMEM, p, m, s);
}

template <int D>
int launch_dq_wgmma(const BwdParams& p, int bh, cudaStream_t s) {
  using S = DqShape<D>;
  CUtensorMap m[4];
  const int err = make_maps(m, p, bh, S::ROWS, S::BK);
  if (err) return err;
  return launch_wgmma(flash_bwd_dq_wgmma_kernel<D>,
                      dim3(bh, (p.tq + S::ROWS - 1) / S::ROWS), S::THREADS,
                      S::SMEM, p, m, s);
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
  if (flash_route(is_bf16, d) == kRouteWgmma)
    return d == 64 ? launch_dkv_wgmma<64>(p, bh, s)
                   : launch_dkv_wgmma<128>(p, bh, s);
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
  if (flash_route(is_bf16, d) == kRouteWgmma)
    return d == 64 ? launch_dq_wgmma<64>(p, bh, s)
                   : launch_dq_wgmma<128>(p, bh, s);
  if (d <= 64) return launch_dq<64>(p, is_bf16, bh, s);
  if (d <= 128) return launch_dq<128>(p, is_bf16, bh, s);
  return launch_dq<256>(p, is_bf16, bh, s);
}

// The kernels a case takes: 2 wgmma + TMA, 1 mma.sync, 0 CUDA cores.
int flash_bwd_route(int is_bf16, int d) { return flash_route(is_bf16, d); }

// Dynamic shared memory of a Hopper kernel (kernel 0: B2, 1: B3) at head
// dim d, in bytes; 0 where the case takes another route.
int flash_bwd_wgmma_smem(int kernel, int d) {
  if (d == 64) return kernel == 0 ? DkvShape<64>::SMEM : DqShape<64>::SMEM;
  if (d == 128) return kernel == 0 ? DkvShape<128>::SMEM : DqShape<128>::SMEM;
  return 0;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
