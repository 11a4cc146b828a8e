// Destination-owned row reductions, shared by the word2vec (word2vec_chunk.cu)
// and GloVe (glove_chunk.cu) chunk kernels.
//
// A chunk scores B items (pairs or triples); each item adds a term to a few
// destination rows of a table (a "hit").  Instead of one fp32 atomic per
// column per hit, the hits are bucketed by destination row and each row is
// summed by one warp in registers and written once:
//
//   phase A (the caller's kernel): score the items, store each hit's
//     coefficient, and count the hits per row with record_hit(): one integer
//     atomic per hit, which also hands the hit its slot within the row and
//     lists the rows a chunk touches;
//   scan_kernel: give every touched row a range of the hit list, its
//     segments of at most `seg` hits, and a split index when it has more
//     than one segment (ranges are taken by block-aggregated atomics: rows
//     need disjoint ranges, not sorted ones);
//   scatter_kernel: write each hit id at its row's offset + its slot, and
//     zero the scratch rows of split rows;
//   reduce_item(): one warp sums a segment's hits, sum(coef * src row)
//     (and a second sum, see Mode), gathering the source rows through a
//     per-warp ring of shared memory filled by cp.async kStages hits ahead;
//     a row of one segment goes straight to the caller's finisher, a split
//     row's segments add their sums into scratch with one atomic per column
//     and the last to arrive hands the whole row to the finisher.
//
// Columns past 32 * NC (rows wider than the registers hold) are walked in
// windows of 32 * NC columns: a work item is one (segment, window).
//
// Hits of a row are summed in the order their slots were taken, which
// varies from run to run, so two runs differ in the last bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace rowseg {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 256;
constexpr int kWalkWarps = 4;   // warps of a reduce block
constexpr int kStages = 4;      // cp.async ring depth of a warp, in rows

// One table's hits, bucketed by destination row.  Hit ids are the caller's
// (0 .. n_pot - 1), one per potential hit.
struct Table {
  int V;          // rows of the destination table
  int n_pot;      // potential hits
  int cap;        // touched rows at most: min(V, n_pot)
  int seg_cap;    // segments at most
  int split_cap;  // rows of more than one segment at most
  int W;          // floats of a split row's scratch: 2 * ncols + 2
  int* cnt;       // [V], zeroed: hits of a row, then its first hit offset
  int* counters;  // [4], zeroed: touched rows, hits, segments, split rows
  int2* hitrow;   // [n_pot]: (row, slot) of a live hit, (-1, -1) otherwise
  int* touched;   // [cap]: rows in first-hit order
  int* hits;      // [n_pot]: hit ids grouped by row
  int* uoff;      // [cap]: first hit of touched row u
  int* ucnt;      // [cap]: hits of touched row u
  int* usplit;    // [cap]: split index of touched row u, or -1
  int2* segs;     // [seg_cap]: (u, first hit within the row)
  float* partial; // [split_cap, W]: a split row's sums (acc0 | acc1 | w0 | w1)
  int* arrive;    // [split_cap]: segments of a split row done
};

// Lays scratch out in one buffer; with base == nullptr it only measures.
struct Carver {
  char* base;
  size_t off = 0;
  template <class T>
  T* take(size_t n) {
    off = (off + 15) & ~static_cast<size_t>(15);
    T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += n * sizeof(T);
    return p;
  }
};

inline Table plan(int V, int n_pot, int seg, int ncols) {
  Table t{};
  t.V = V;
  t.n_pot = n_pot;
  t.cap = V < n_pot ? V : n_pot;
  t.seg_cap = n_pot / seg + t.cap + 1;
  t.split_cap = n_pot / (seg + 1) + 1;
  t.W = 2 * ncols + 2;
  return t;
}

// The part of the scratch that must start at zero; carve every table's
// before any table's rest, so one memset clears them all.
inline void carve_zeroed(Table& t, Carver& c) {
  t.cnt = c.take<int>(t.V);
  t.counters = c.take<int>(4);
}

inline void carve_rest(Table& t, Carver& c) {
  t.hitrow = c.take<int2>(t.n_pot);
  t.touched = c.take<int>(t.cap);
  t.hits = c.take<int>(t.n_pot);
  t.uoff = c.take<int>(t.cap);
  t.ucnt = c.take<int>(t.cap);
  t.usplit = c.take<int>(t.cap);
  t.segs = c.take<int2>(t.seg_cap);
  t.partial = c.take<float>(static_cast<size_t>(t.split_cap) * t.W);
  t.arrive = c.take<int>(t.split_cap);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Phase A: potential hit `id` lands on `row`, or on none when row < 0.
// One thread calls it per hit.
__device__ __forceinline__ void record_hit(const Table& t, int id, int row) {
  int slot = -1;
  if (row >= 0) {
    slot = atomicAdd(t.cnt + row, 1);
    if (slot == 0) t.touched[atomicAdd(t.counters, 1)] = row;
  }
  t.hitrow[id] = make_int2(row, slot);
}

// record_hit() for a warp at once: every lane calls it (row < 0: no hit).
// Lanes hitting the same row take one atomic between them, so a row that
// every item of the chunk hits (the Huffman root) costs one atomic a warp,
// not one a hit.
__device__ __forceinline__ void record_hit_warp(const Table& t, int id,
                                                int row, bool store) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, row);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (row >= 0 && lane == leader) {
    base = atomicAdd(t.cnt + row, __popc(peers));
    if (base == 0) t.touched[atomicAdd(t.counters, 1)] = row;
  }
  base = __shfl_sync(kFull, base, leader);
  if (store)
    t.hitrow[id] = row >= 0
        ? make_int2(row, base + __popc(peers & ((1u << lane) - 1)))
        : make_int2(-1, -1);
}

template <int N>
struct Tables {
  Table t[N];
};

// Inclusive warp scan of v.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive block scan of v over kScanThreads threads; *total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int base = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w) {
    base += w < warp ? warp_sums[w] : 0;
    sum += warp_sums[w];
  }
  __syncthreads();
  *total = sum;
  return base + incl - v;
}

// grid (ceil(max cap / kScanThreads), N): block x of table y takes touched
// rows [x * kScanThreads, ...) and one range of hits, segments and split
// indices for all of them.
template <int N>
__global__ void __launch_bounds__(kScanThreads) scan_kernel(Tables<N> ts,
                                                            int seg) {
  const Table& t = ts.t[blockIdx.y];
  const int U = t.counters[0];
  if (static_cast<int>(blockIdx.x) * kScanThreads >= U) return;
  const int u = blockIdx.x * kScanThreads + threadIdx.x;
  const int row = u < U ? t.touched[u] : 0;
  const int c = u < U ? t.cnt[row] : 0;
  const int ns = (c + seg - 1) / seg;
  int n_hits, n_segs, n_split;
  int h = block_scan(c, &n_hits);
  int s = block_scan(ns, &n_segs);
  int p = block_scan(ns > 1 ? 1 : 0, &n_split);
  __shared__ int base[3];
  if (threadIdx.x == 0) {
    base[0] = atomicAdd(t.counters + 1, n_hits);
    base[1] = atomicAdd(t.counters + 2, n_segs);
    base[2] = atomicAdd(t.counters + 3, n_split);
  }
  __syncthreads();
  if (u >= U) return;
  h += base[0];
  s += base[1];
  p += base[2];
  t.uoff[u] = h;
  t.ucnt[u] = c;
  t.usplit[u] = ns > 1 ? p : -1;
  t.cnt[row] = h;
  for (int k = 0; k < ns; ++k) t.segs[s + k] = make_int2(u, k * seg);
}

// Each live hit id to its row's range; the split rows' scratch to zero.
template <int N>
__global__ void __launch_bounds__(256) scatter_kernel(Tables<N> ts) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const Table& t = ts.t[k];
    for (int i = tid; i < t.n_pot; i += stride) {
      const int2 rs = t.hitrow[i];
      if (rs.y >= 0) t.hits[t.cnt[rs.x] + rs.y] = i;
    }
    const int n_split = t.counters[3];
    const size_t nz = static_cast<size_t>(n_split) * t.W;
    for (size_t i = tid; i < nz; i += stride) t.partial[i] = 0.f;
    for (int i = tid; i < n_split; i += stride) t.arrive[i] = 0;
  }
}

// A hit as its source sees it: the row gathered, the coefficient it is
// scaled by, the weight added to the row's count, and its objective.
struct HitInfo {
  const float* src;
  float coef;
  float weight;
  int obj;
};

// What a segment sums, per column c of the source row x:
//   kSum:     acc0 += coef * x,                    w0 += weight
//   kTwoObj:  acc[obj] += coef * x,                w[obj] += weight
//   kSquares: acc0 += coef * x, acc1 += (coef * x)^2, w0 += weight
enum Mode { kSum = 0, kTwoObj = 1, kSquares = 2 };

// Source column of column c: c, except that column `from` reads `to`.
struct Remap {
  int from, to;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ const float* shfl_ptr(const float* p, int src) {
  return reinterpret_cast<const float*>(__shfl_sync(
      kFull, reinterpret_cast<unsigned long long>(p), src));
}

// Work item `item` = (segment, column window) of table t, by one warp.
// `stage` is the warp's [kStages][32 * NC] ring.  Src::hit(id) -> HitInfo;
// Fin::apply(u, row, c0, acc0, acc1, w0, w1, lane) finishes columns
// [c0, c0 + 32 * NC) of a row.
template <int NC, int MODE, class Src, class Fin>
__device__ __forceinline__ void reduce_item(const Table& t, int item,
                                            int nwin, int ncols, int seg,
                                            Remap rm, const Src& src,
                                            const Fin& fin, float* stage,
                                            int lane) {
  constexpr int RW = 32 * NC;
  const int si = item / nwin, win = item - si * nwin;
  const int2 sg = t.segs[si];
  const int u = sg.x;
  const int row = t.touched[u], total = t.ucnt[u];
  const int n = min(seg, total - sg.y);
  const int* hits = t.hits + t.uoff[u] + sg.y;
  const int c0 = win * RW;
  float acc0[NC], acc1[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc0[j] = acc1[j] = 0.f;
  float w0 = 0.f, w1 = 0.f;

  for (int k0 = 0; k0 < n; k0 += 32) {
    const int nb = min(32, n - k0);
    HitInfo mine{nullptr, 0.f, 0.f, 0};
    if (lane < nb) mine = src.hit(hits[k0 + lane]);
    auto issue = [&](int i) {
      const float* s = shfl_ptr(mine.src, i);
      float* st = stage + (i % kStages) * RW;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = c0 + lane + 32 * j;
        const bool live = c < ncols;
        const int sc = c == rm.from ? rm.to : c;
        cp_async_f32(st + lane + 32 * j, live ? s + sc : s, live);
      }
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < nb) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < nb; ++i) {
      if (i + kStages - 1 < nb) issue(i + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();   // hit i's row has landed
      const float coef = __shfl_sync(kFull, mine.coef, i);
      const float wt = __shfl_sync(kFull, mine.weight, i);
      const int obj = __shfl_sync(kFull, mine.obj, i);
      const float* st = stage + (i % kStages) * RW;
      // each lane reads only the columns it copied: no warp barrier
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float v = coef * st[lane + 32 * j];
        if (MODE == kSquares) {
          acc0[j] += v;
          acc1[j] += v * v;
        } else if (MODE == kTwoObj && obj) {
          acc1[j] += v;
        } else {
          acc0[j] += v;
        }
      }
      if (MODE == kTwoObj && obj)
        w1 += wt;
      else
        w0 += wt;
    }
  }

  if (total <= seg) {
    fin.apply(u, row, c0, acc0, acc1, w0, w1, lane);
    return;
  }
  // a split row: add this segment's sums into the row's scratch; the last
  // segment to arrive applies the whole row from there
  const int k = t.usplit[u];
  float* part = t.partial + static_cast<size_t>(k) * t.W;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = c0 + lane + 32 * j;
    if (c < ncols) {
      atomicAdd(part + c, acc0[j]);
      if (MODE != kSum) atomicAdd(part + ncols + c, acc1[j]);
    }
  }
  if (lane == 0 && win == 0) {
    atomicAdd(part + 2 * ncols, w0);
    if (MODE == kTwoObj) atomicAdd(part + 2 * ncols + 1, w1);
  }
  __threadfence();
  __syncwarp();
  int prev = 0;
  if (lane == 0) prev = atomicAdd(t.arrive + k, 1);
  prev = __shfl_sync(kFull, prev, 0);
  if (prev != ((total + seg - 1) / seg) * nwin - 1) return;
  __threadfence();
  w0 = __ldcg(part + 2 * ncols);
  w1 = MODE == kTwoObj ? __ldcg(part + 2 * ncols + 1) : 0.f;
  for (int w = 0; w < nwin; ++w) {
    const int cw = w * RW;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = cw + lane + 32 * j;
      acc0[j] = c < ncols ? __ldcg(part + c) : 0.f;
      acc1[j] = (MODE != kSum && c < ncols) ? __ldcg(part + ncols + c) : 0.f;
    }
    fin.apply(u, row, cw, acc0, acc1, w0, w1, lane);
  }
}

// Work items of table t: its segments times the column windows.
__device__ __forceinline__ int n_items(const Table& t, int nwin) {
  return t.counters[2] * nwin;
}

// Blocks for a reduce launch over at most `items` work items.
inline int reduce_grid(long long items) {
  const long long want = (items + kWalkWarps - 1) / kWalkWarps;
  const long long most = 16LL * sm_count();
  return static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
}

}  // namespace rowseg
