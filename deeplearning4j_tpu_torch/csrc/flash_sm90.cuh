// Pieces the Hopper flash-attention kernels share: the forward B1
// (flash_fwd.cu) and the backward B2/B3 (flash_bwd.cu).
//
// Device side: wgmma descriptors over the 128-byte-swizzled tiles of
// hopper_sm90.cuh, the accumulator-to-A-operand repacking, TMA tile loads
// and the release of a ring stage.  Host side: the route rule and the TMA
// tensor maps over the [B, T, NH, D] strides, built through
// cudaGetDriverEntryPoint so no library links -lcuda.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"

constexpr float kLog2e = 1.4426950408889634f;

// Which kernels take a case: bf16 with D = 64 or 128 the Hopper kernels
// (wgmma + TMA), other bf16 the mma.sync kernels, fp32 the CUDA-core ones.
enum FlashRoute { kRouteCudaCores = 0, kRouteMmaSync = 1, kRouteWgmma = 2 };

inline int flash_route(int is_bf16, int d) {
  if (!is_bf16) return kRouteCudaCores;
  return (d == 64 || d == 128) ? kRouteWgmma : kRouteMmaSync;
}

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Descriptor of k-step kk (16 k-values) of a K-major [rows][D] tile of
// `rows` rows, from row r0 on: k runs along the 64-column halves.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int r0, int kk) {
  return wgmma_desc(tile + (kk / 4) * rows * 128 + r0 * 128 + (kk % 4) * 32,
                    16, 1024);
}

// Descriptor of k-step kk (rows 16kk..16kk+15) of column half hh of an
// MN-major [rows][D] tile, read through the transpose bit.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows,
                                                 int kk, int hh) {
  return wgmma_desc(tile + hh * rows * 128 + kk * 16 * 128, rows * 128, 1024);
}

// Two 8-column accumulator blocks (registers 8kk..8kk+7), rounded to bf16,
// as the register A operand of a k16 step.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[R],
                                         int kk) {
  a[0] = pack_f32_to_bf16x2(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_f32_to_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_f32_to_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_f32_to_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
}

// Load a [rows][D] bf16 box at (row, h, b) as D / 64 column halves.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, int rows,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int row, int h, int b) {
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
    tma_load_4d(dst + hh * rows * 128, map, bar, hh * 64, row, h, b);
}

// A consumer warp is done with a ring stage.
__device__ __forceinline__ void release_stage(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ---------------------------------------------------------------------------
// host side: TMA tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled (a libcuda function), taken through the runtime
// so the library links without -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 tensor of `bh` = batch * nh heads, `t` tokens and 64 or 128
// columns, with element strides (sb, sh, st) of batch, head and token, as
// the 4-D map (column, token, head, batch) read in boxes of 64 columns x
// `rows` tokens with the 128-byte swizzle.  Tokens past t load as zeros.
// `who` names the caller in the message of a refused map.
inline int make_map(CUtensorMap* map, const void* base, long long sb,
                    long long sh, long long st, int nh, int bh, int t, int d,
                    int rows, const char* who) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (nh == 1) sh = st;   // one head: its stride is never used, must be > 0
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(nh),
                              static_cast<cuuint64_t>(bh / nh)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "%s: cuTensorMapEncodeTiled returned %d\n", who,
            static_cast<int>(r));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
