// Split-TF32 ("3xTF32") tensor-core products for float32 operands on
// Hopper (sm_90a) through mma.sync.
//
// A float32 x is split into two TF32 values, big = tf32(x) and
// small = tf32(x - big), both rounded to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding).  x - big is exact in float32,
// |small| <= 2^-11 |x| and x - (big + small) is at most 2^-22 |x|.  A
// product a b is taken as three TF32 products summed into one float32
// accumulator, small terms first:
//     a_small b_big + a_big b_small + a_big b_big
// which drops only a_small b_small (<= 2^-22 |a b|): each term is within
// ~3 2^-22 |a b| of the float32 product, against 2^-11 for one TF32
// product of the rounded operands.  This is the scheme of CUTLASS's
// OpMultiplyAddFastF32, through which PyTorch's float32 memory-efficient
// attention reaches the tensor cores.
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// (PTX ISA, "Matrix fragments for mma.m16n8k8"), lane l, g = l / 4 (the
// group), t = l % 4 (the thread in the group), one tf32 a .b32:
//   A (16 x 8, row):  a0 = A[g][t]     a1 = A[g+8][t]
//                     a2 = A[g][t+4]   a3 = A[g+8][t+4]
//   B (8 x 8, col):   b0 = B[t][g]     b1 = B[t+4][g]
//   C/D (16 x 8 f32): c0, c1 = C[g][2t, 2t+1]   c2, c3 = C[g+8][2t, 2t+1]
// Unlike bf16's m16n8k16, a C fragment's column pair (2t, 2t+1) is not an
// A fragment's column pair (t, t+4), so a product's output does not
// repack into the next product's A operand as it is.  The k index of a
// product is summed over, so any permutation of it that A and B share
// gives the same sum: with k slot t holding column 2t and slot t+4
// column 2t+1 of an 8-wide chunk, C's (c0, c2, c1, c3) is the A fragment,
// and B reads rows k0 + 2t and k0 + 2t + 1 (c_to_a, load_b_kn).
//
// Tiles are float32 in shared memory, row-major with a padded row of LD
// floats, filled by load_tile's 16-byte cp.async copies.  LD = D + 4
// (LD % 32 == 4) puts the 32 words of every fragment read below on 32
// distinct banks: rows g (A, load_b_nk) at 4 g + t, and rows 2t, 2t + 1
// (load_b_kn) at 8 t + g and 8 t + 4 + g.

#pragma once

#include <stdint.h>

#include "tc_tile.cuh"

namespace tf32x3 {

// Rows [row0, row0 + ROWS) of a float32 tensor (row stride ss elements,
// contiguous rows of COLS floats) into a tile of rows of LD floats at
// shared address dst, as 16-byte cp.async copies shared by NT threads;
// rows at or past `valid` are zero-filled.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src,
                                          long long ss, int row0,
                                          int valid) {
  constexpr int CH = COLS / 4;  // 16-byte chunks a row
  static_assert(ROWS * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    const float* p = ok ? src + (row0 + r) * ss + c * 4 : src;
    tc::cp_async16(dst + 4 * (r * LD + c * 4), p, ok);
  }
}

// x = big + small (+ <= 2^-22 |x|), each a TF32 operand.  On sm_90a
// ptxas expands cvt.rna.tf32.f32 into an inf/NaN test, an add of half a
// TF32 ulp (0x1000), a select and, where the value is used as a float,
// a mask of the 13 low bits: 7 instructions a split, the largest share of
// the kernels' issue slots.  Here the same rounding for finite x in 4:
// big = (bits + 0x1000) & ~0x1fff (exact, as a float), small's half ulp
// added and its low bits left for the tensor core, which reads the 19
// high bits of a .tf32 operand (as ptxas's own expansion relies on).
// Non-finite x: inf stays inf; a NaN gives NaN through small.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// a fragment of 4 (A) or 2 (B) elements, split
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split_frag(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], f.big[i], f.small[i]);
  return f;
}

// c += A (16 x 8 tf32) . B (8 x 8 tf32), float32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in three TF32 products, small terms first
__device__ __forceinline__ void mma3(float c[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma(c, a.small, b.big);
  mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// A fragment of the 16 x 8 block at rows r0.., columns c0.. of a tile
// (e.g. K as [key][d] for S^T = K Q^T)
template <int LD>
__device__ __forceinline__ Frag<4> load_a(const float* tile, int r0, int c0,
                                          int g, int t) {
  const float* p = tile + (r0 + g) * LD + c0 + t;
  const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
  return split_frag(x);
}

// B fragment of an 8 x 8 block from a tile stored [n][k] (Q as [q][d] for
// S^T = K Q^T: n = q rows n0.., k = d columns k0..)
template <int LD>
__device__ __forceinline__ Frag<2> load_b_nk(const float* tile, int n0,
                                             int k0, int g, int t) {
  const float* p = tile + (n0 + g) * LD + k0 + t;
  const float x[2] = {p[0], p[4]};
  return split_frag(x);
}

// B fragment of an 8 x 8 block from a tile stored [k][n] (dO as [q][d]
// for dV += P^T dO: k = q rows k0.., n = d columns n0..), with the k
// slots permuted as c_to_a's: slot t is row k0 + 2t, slot t + 4 row
// k0 + 2t + 1
template <int LD>
__device__ __forceinline__ Frag<2> load_b_kn(const float* tile, int k0,
                                             int n0, int g, int t) {
  const float* p = tile + (k0 + 2 * t) * LD + n0 + g;
  const float x[2] = {p[0], p[LD]};
  return split_frag(x);
}

// The C fragment of one 16 x 8 product (columns k0 + 2t, k0 + 2t + 1)
// as the A fragment of the next product's k chunk k0.., with load_b_kn's
// slot permutation, split
__device__ __forceinline__ Frag<4> c_to_a(const float c[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split_frag(x);
}

}  // namespace tf32x3
