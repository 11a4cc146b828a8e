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
// Design.  bf16 with D = 64 or 128 takes the Hopper kernel (wgmma + TMA);
// every other case keeps the first kernels (mma.sync for bf16, CUDA cores
// for fp32).  The C entry point chooses by that rule alone (flash_route in
// flash_sm90.cuh, the backward's rule; flash_fwd_route reports it), and
// nothing falls back at run time.
//
// Hopper kernel (flash_fwd_wgmma_kernel<D>):
// - persistent: one CTA an SM walks the work items, blocks of 128 query
//   rows of one bh (bh fastest; under causal masking the row blocks with
//   the most key tiles first), so the next block's loads run under this
//   one's tiles and epilogue.  A CTA is two consumer warpgroups of 64 rows
//   and one producer warp (288 threads; ptxas holds every thread to 168
//   registers);
// - the producer loads each block's Q by TMA into one of two buffers and
//   streams 64-key tiles of K and V (TMA) and of the bias (cp.async, whose
//   arrival on the stage's barrier waits for the copies, so no load
//   latency stalls the producer) through a 4-stage ring guarded by
//   mbarriers, its count running on across blocks; rows past Tq and Tk
//   arrive as zeros;
// - S = Q K^T is a wgmma m64n64k16 chain with both operands in shared
//   memory, K-major; O += P V takes P from the fp32 accumulator, packed to
//   bf16, as the register A operand, and reads V MN-major through the
//   descriptor's transpose bit;
// - one tile's P V runs on the tensor cores while the next tile's S is
//   scaled, masked and exponentiated, and the two warpgroups take turns
//   to issue their products (named barriers), so one's softmax runs under
//   the other's products; a ring stage goes back to the producer once
//   wgmma.wait_group shows the P V reading it is done.  No product is
//   issued under a data-dependent branch: ptxas would serialize them all;
// - the softmax runs in registers, a row's max and sum over its quad of
//   threads.  x = s * scale + bias is formed in fp32 on the natural-log
//   scale, as the plain twin forms it; p = 2^(x * log2(e) - m) is one FMA,
//   whose exact inner product cancels a fully masked row's -1e5 against
//   the row max m (kept in log2 units), and one ex2; lse = m * ln(2) +
//   log(l).  Only edge tiles (ragged Tk, the causal diagonal) run the mask
//   pass, kept apart from the interior tiles' loop;
// - causal: each warpgroup walks the 64-key tiles up to the one that
//   holds its own 64 rows (kFlashKeyTile), so its first warpgroup stops a
//   tile before its second and only releases the last stage.
// First kernels:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegInit = -1e30f;   // running-max seed only; never stored
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU op (ex2.approx, flushing results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
// bf16, D = 64 or 128: wgmma and TMA (Hopper)
// ---------------------------------------------------------------------------

// 128 query rows (two consumer warpgroups) and one producer warp a CTA;
// 64-key tiles, the causal tile, through a ring of STAGES stages; the Q
// tile double-buffered, so the next row block's Q loads during this one
template <int D>
struct FwdShape {
  static constexpr int WGS = 2;
  static constexpr int ROWS = 64 * WGS;
  static constexpr int BK = kFlashKeyTile;
  static constexpr int STAGES = 4;
  static constexpr int QBUF = 2;
  static constexpr int THREADS = WGS * 128 + 32;
  static constexpr int SMEM = QBUF * ROWS * D * 2 + 2 * STAGES * BK * D * 2 +
                              STAGES * BK * 4 +
                              (2 * STAGES + 2 * QBUF) * 8 + 1024;
};

// A row block of one bh: work item idx of n_bh * n_rb, bh fastest; under
// causal masking the last row blocks, which walk the most key tiles, come
// first.
struct FwdItem {
  int bh, b, h, q0, n_kt;
};

template <int ROWS, int BK>
__device__ __forceinline__ FwdItem fwd_item(const FwdParams& p, int idx,
                                            int n_bh, int n_rb) {
  FwdItem w;
  const int rbi = idx / n_bh;
  w.bh = idx - rbi * n_bh;
  w.b = w.bh / p.nh;
  w.h = w.bh - w.b * p.nh;
  w.q0 = (p.causal ? n_rb - 1 - rbi : rbi) * ROWS;
  w.n_kt = (p.tk + BK - 1) / BK;
  // causal: up to the key tile that holds the block's last row
  if (p.causal) w.n_kt = min(w.n_kt, (min(w.q0 + ROWS, p.tq) - 1) / BK + 1);
  return w;
}

// Persistent: each CTA walks the work items blockIdx.x, + gridDim.x, ...
template <int D>
__global__ void __launch_bounds__(FwdShape<D>::THREADS, 1)
flash_fwd_wgmma_kernel(const FwdParams p, int n_bh,
                       const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v) {
  using S = FwdShape<D>;
  constexpr int ROWS = S::ROWS;
  constexpr int BK = S::BK;
  constexpr int STAGES = S::STAGES;
  constexpr int QBUF = S::QBUF;
  constexpr int CONSUMER_WARPS = 4 * S::WGS;
  constexpr int Q_BYTES = ROWS * D * 2;
  constexpr int KV_BYTES = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);         // [QBUF] tiles
  unsigned char* sK = sQ + QBUF * Q_BYTES;         // [STAGES] tiles
  unsigned char* sV = sK + STAGES * KV_BYTES;      // [STAGES] tiles
  float* sBias = reinterpret_cast<float*>(sV + STAGES * KV_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + STAGES * BK);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_empty = q_full + QBUF;

  const int n_rb = (p.tq + ROWS - 1) / ROWS;
  const int n_items = n_bh * n_rb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // lane 0's expect_tx, and one arrival per producer lane once its
      // bias copies have landed
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], CONSUMER_WARPS);   // one lane per consumer warp
    }
    for (int qb = 0; qb < QBUF; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: per item, Q into its buffer, then the item's K/V/bias
    // tiles through the ring, whose stage count runs on across items
    int it = 0;
    for (int idx = blockIdx.x, j = 0; idx < n_items;
         idx += gridDim.x, ++j) {
      const FwdItem w = fwd_item<ROWS, BK>(p, idx, n_bh, n_rb);
      const int qb = j % QBUF;
      mbar_wait(&q_empty[qb], ((j / QBUF) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&q_full[qb], Q_BYTES);
        tma_tile<D>(sQ + qb * Q_BYTES, ROWS, &tm_q, &q_full[qb], w.q0, w.h,
                    w.b);
      }
      const float* biasg =
          p.bias ? p.bias + static_cast<long long>(w.bh / p.bias_nh) * p.tk
                 : nullptr;
      for (int kt = 0; kt < w.n_kt; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int k0 = kt * BK;
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * KV_BYTES);
          tma_tile<D>(sK + s * KV_BYTES, BK, &tm_k, &full[s], k0, w.h, w.b);
          tma_tile<D>(sV + s * KV_BYTES, BK, &tm_v, &full[s], k0, w.h, w.b);
        }
        // the bias by cp.async (zeros past Tk): no lane waits for it, and
        // the stage completes once every lane's copies have landed
        if (biasg != nullptr) {
          for (int jj = lane; jj < BK; jj += 32) {
            const int key = k0 + jj;
            cp_async_f32(sBias + s * BK + jj, biasg + min(key, p.tk - 1),
                         key < p.tk);
          }
          mbar_arrive_on_cp_async(&full[s]);
        } else {
          for (int jj = lane; jj < BK; jj += 32) sBias[s * BK + jj] = 0.f;
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows rw0..rw0+63 of an item; this
  // thread's rows are accumulator rows g and g + 8 of its warp's 16
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float o[D / 64][32];
  // the running row max in log2 units, m = round(max x * log2(e)): every
  // p = 2^(x * log2(e) - m) is one FMA (x * log2(e) exact inside it) and
  // one ex2, and lse = m * ln(2) + log(l) holds for whatever m rounded to
  float m_run[2];
  float l_run[2];                // this thread's share of the row sum
  float sc[BK / 2];              // S of the tile, then its P
  uint32_t pa[BK / 16][4];       // P of the last tile, the A operand of P V
  float alpha[2];
  const float2* bias2 = reinterpret_cast<const float2*>(sBias);
  int it = 0;   // ring tiles of the items before this one

  for (int idx = blockIdx.x, j = 0; idx < n_items; idx += gridDim.x, ++j) {
    const FwdItem w = fwd_item<ROWS, BK>(p, idx, n_bh, n_rb);
    const int qb = j % QBUF;
    const uint32_t aQ = smem_u32(sQ + qb * Q_BYTES);
    const int rw0 = w.q0 + 64 * wg;
    const int row0 = rw0 + 16 * wl + g;
    // the key tiles this warpgroup walks: under causal masking those up
    // to the tile of its own rows.  A warpgroup whose rows all lie past
    // Tq walks them too, on zero rows it never writes: no product is
    // issued under a branch, which would make ptxas serialize every wgmma.
    int wg_kt = w.n_kt;
    if (p.causal) wg_kt = min(wg_kt, rw0 / kFlashKeyTile + 1);
    // The two warpgroups take turns to issue their products (ping-pong on
    // named barriers 1 and 2), so one's softmax runs while the other's
    // products hold the tensor cores.  Turn k of a warpgroup issues tile
    // k's S and tile k-1's P V (k = 0..its tiles), warpgroup 0 first.
    // Warpgroup 1 walks at least the tiles warpgroup 0 walks (one more on
    // a causal diagonal); only their common turns alternate, and turn 0
    // of an item waits for the other warpgroup's last common turn of the
    // item before.
    const int turns0 =
        (p.causal ? min(w.n_kt, w.q0 / kFlashKeyTile + 1) : w.n_kt) + 1;
    auto turn_begin = [&](int k) {
      if (wg == 0 ? (k > 0 || j > 0) : k < turns0)
        named_bar_sync(1 + wg, 256);
    };
    auto turn_end = [&](int k) {
      if (wg == 0 ||
          (k < turns0 && (k < turns0 - 1 || idx + gridDim.x < n_items)))
        named_bar_arrive(2 - wg, 256);
    };
    // S = Q K^T of the tile in stage s (64 rows x 64 keys)
    auto issue_s = [&](int s) {
      const uint32_t aK = smem_u32(sK + s * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_kmajor(aQ, ROWS, 64 * wg, kk),
                 desc_kmajor(aK, BK, 0, kk), kk > 0);
      wgmma_commit();
    };
    // O += P V with the V of stage s
    auto issue_pv = [&](int s) {
      const uint32_t aV = smem_u32(sV + s * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < D / 64; ++hh)
          wgmma_rs_tb_n64(o[hh], pa[kk], desc_mnmajor(aV, BK, kk, hh));
      wgmma_commit();
    };
    // P in place of S for key tile kt (stage s): x = s * scale + bias,
    // masked at the edges; the tile's row max joins the running max, and
    // alpha rescales what was summed before
    auto softmax = [&](int kt, int s) {
      const int k0 = kt * BK;
      const bool interior =
          k0 + BK <= p.tk && (!p.causal || k0 + BK <= rw0);
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const float2 b2 = bias2[s * (BK / 2) + 4 * jj + t];   // keys 8jj + 2t, +1
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * jj + e] = fmaf(sc[4 * jj + e], p.scale, (e & 1) ? b2.y : b2.x);
      }
      // a pass of its own: inside the loop above it slows interior tiles
      if (!interior) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (p.causal && row0 + 8 * ((i >> 1) & 1) < key) sc[i] = kMaskVal;
          if (key >= p.tk) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r] * kLog2e);
        alpha[r] = ex2(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float pe = ex2(fmaf(sc[i], kLog2e, -m_run[r]));
        sc[i] = pe;
        l_run[r] += pe;
      }
    };

#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
    m_run[0] = m_run[1] = kNegInit;
    l_run[0] = l_run[1] = 0.f;

    mbar_wait(&q_full[qb], (j / QBUF) & 1);
    // tile 0: S, then P (O is still zero)
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    turn_begin(0);
    wgmma_fence();
    issue_s(it % STAGES);
    turn_end(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, it % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    for (int kt = 1; kt < wg_kt; ++kt) {
      const int s = (it + kt) % STAGES, held = (it + kt - 1) % STAGES;
      mbar_wait(&full[s], ((it + kt) / STAGES) & 1);
      // this tile's S, then the last tile's O += P V behind it: P V runs
      // while this tile's softmax is formed
      turn_begin(kt);
      wgmma_fence();
      issue_s(s);
      issue_pv(held);
      turn_end(kt);
      wgmma_wait<1>();   // S is done; P V runs on
      fence_regs(sc);
      softmax(kt, s);
      wgmma_wait<0>();   // the last tile's P V is done with its stage
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh) fence_regs(o[hh]);
      release_stage(&empty[held], lane);
      fence_regs(sc);   // P is packed only once P V no longer reads pa
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hh][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    }
    // this warpgroup's S products are done with the Q buffer
    release_stage(&q_empty[qb], lane);
    // the last walked tile's O += P V
    const int last = (it + wg_kt - 1) % STAGES;
    turn_begin(wg_kt);
    wgmma_fence();
    issue_pv(last);
    turn_end(wg_kt);
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) fence_regs(o[hh]);
    release_stage(&empty[last], lane);
    // the other warpgroup's causal diagonal tile: released unread
    for (int kt = wg_kt; kt < w.n_kt; ++kt) {
      const int s = (it + kt) % STAGES;
      mbar_wait(&full[s], ((it + kt) / STAGES) & 1);
      release_stage(&empty[s], lane);
    }
    it += w.n_kt;

    // the item's bh, b and h again: not held in registers across its tiles
    const FwdItem wo = fwd_item<ROWS, BK>(p, idx, n_bh, n_rb);
    __nv_bfloat16* og =
        static_cast<__nv_bfloat16*>(p.o) + wo.b * p.o_sb + wo.h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);   // fully masked rows
      const int row = row0 + 8 * r;
      if (row < p.tq) {
        __nv_bfloat16* orow = og + row * p.o_st;
#pragma unroll
        for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<uint32_t*>(orow + 64 * hh + 8 * jj + 2 * t) =
                pack_f32_to_bf16x2(o[hh][4 * jj + 2 * r] / l,
                                   o[hh][4 * jj + 2 * r + 1] / l);
        if (t == 0)
          p.lse[static_cast<long long>(wo.bh) * p.tq + row] =
              m_run[r] * kLn2 + logf(l);
      }
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

template <int D>
int launch_fwd_wgmma(const FwdParams& p, int bh, cudaStream_t stream) {
  using S = FwdShape<D>;
  CUtensorMap m[3];
  int err = make_map(&m[0], p.q, p.q_sb, p.q_sh, p.q_st, p.nh, bh, p.tq, D,
                     S::ROWS, "flash_fwd");
  if (!err)
    err = make_map(&m[1], p.k, p.k_sb, p.k_sh, p.k_st, p.nh, bh, p.tk, D,
                   S::BK, "flash_fwd");
  if (!err)
    err = make_map(&m[2], p.v, p.v_sb, p.v_sh, p.v_st, p.nh, bh, p.tk, D,
                   S::BK, "flash_fwd");
  if (err) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one persistent CTA an SM, or one a work item when there are fewer
  const long long items =
      static_cast<long long>(bh) * ((p.tq + S::ROWS - 1) / S::ROWS);
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_wgmma_kernel<D><<<grid, S::THREADS, S::SMEM, stream>>>(
      p, bh, m[0], m[1], m[2]);
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
  if (flash_route(is_bf16, d) == kRouteWgmma)
    return d == 64 ? launch_fwd_wgmma<64>(p, bh, s)
                   : launch_fwd_wgmma<128>(p, bh, s);
  if (is_bf16) {
    if (d <= 64) return launch_bf16<64>(p, bh, s);
    if (d <= 128) return launch_bf16<128>(p, bh, s);
    return launch_bf16<256>(p, bh, s);
  }
  if (d <= 64) return launch_f32<64>(p, bh, s);
  if (d <= 128) return launch_f32<128>(p, bh, s);
  return launch_f32<256>(p, bh, s);
}

// The kernel a case takes: 2 wgmma + TMA, 1 mma.sync, 0 CUDA cores.
int flash_fwd_route(int is_bf16, int d) { return flash_route(is_bf16, d); }

// Dynamic shared memory of the Hopper kernel at head dim d, in bytes; 0
// where the case takes another route.
int flash_fwd_wgmma_smem(int d) {
  if (d == 64) return FwdShape<64>::SMEM;
  if (d == 128) return FwdShape<128>::SMEM;
  return 0;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
