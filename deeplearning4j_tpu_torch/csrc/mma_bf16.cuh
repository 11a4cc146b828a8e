// bf16 tensor-core helpers shared by the flash-attention kernels.
//
// mma.sync.m16n8k16 fragment layout (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                      a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B 16x8:            b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C 16x8 fp32:       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// Two C fragments side by side (16 columns) are therefore one A fragment
// once packed to bf16, which keeps probabilities in registers between the
// two products of every flash kernel.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t pack_f32_to_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major bf16 tile
// with row stride LDS (elements).
template <int LDS>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* s, int r0,
                                            int k0, int g, int t) {
  const __nv_bfloat16* p = s + (r0 + g) * LDS + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
}

// A fragment from two fp32 C fragments (columns 0-7 and 8-15), rounded to
// bf16.
__device__ __forceinline__ void c_to_a_frag(uint32_t (&a)[4],
                                            const float (&lo)[4],
                                            const float (&hi)[4]) {
  a[0] = pack_f32_to_bf16x2(lo[0], lo[1]);
  a[1] = pack_f32_to_bf16x2(lo[2], lo[3]);
  a[2] = pack_f32_to_bf16x2(hi[0], hi[1]);
  a[3] = pack_f32_to_bf16x2(hi[2], hi[3]);
}

// c += A * X^T where X is a row-major tile (rows = the product's n
// columns): B[k][n] = X[n0 + n][k0 + k], two contiguous bf16 per register.
template <int LDS>
__device__ __forceinline__ void mma_a_xt(float (&c)[4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* s, int n0,
                                         int k0, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * LDS + k0 + 2 * t;
  mma_16816(c, a, *reinterpret_cast<const uint32_t*>(p),
            *reinterpret_cast<const uint32_t*>(p + 8));
}

// c += A * X where X is a row-major tile (rows = the product's k):
// B[k][n] = X[k0 + k][n0 + n], gathered two rows apart.
template <int LDS>
__device__ __forceinline__ void mma_a_x(float (&c)[4], const uint32_t (&a)[4],
                                        const __nv_bfloat16* s, int k0,
                                        int n0, int g, int t) {
  const __nv_bfloat16* p = s + (k0 + 2 * t) * LDS + n0 + g;
  mma_16816(c, a, pack_bf16x2(p[0], p[LDS]),
            pack_bf16x2(p[8 * LDS], p[9 * LDS]));
}

// Stage a [64, dpad] bf16 tile: rows past `rows` and columns past d are
// zero.  d % 8 == 0 and 16-byte aligned rows are checked by the wrapper.
template <int LDS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* s,
                                               const __nv_bfloat16* g,
                                               long long st, int rows, int d,
                                               int dpad) {
  const int chunks = dpad / 8;
  for (int c = threadIdx.x; c < 64 * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < d)
      val = *reinterpret_cast<const uint4*>(g + r * st + col);
    *reinterpret_cast<uint4*>(s + r * LDS + col) = val;
  }
}
