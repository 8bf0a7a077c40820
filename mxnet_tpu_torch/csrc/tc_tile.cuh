// Tensor-core tile building blocks for Hopper (sm_90a) through mma.sync.
//
// The pieces a flash-attention kernel (forward, dQ, dK/dV) is built from:
//   - cp.async 16-byte copies global -> shared, with zero-fill, in commit
//     groups, so the next tile is in flight while this one is multiplied;
//   - a swizzled bf16 tile in shared memory (16-byte chunks XOR row), so
//     ldmatrix and cp.async hit 8 different bank groups for 8 rows;
//   - ldmatrix x4 loaders (plain and .trans) that give mma fragments;
//   - the m16n8k16 bf16 mma with float32 accumulators, and the repacking
//     of two f32 C fragments into one bf16 A fragment (a product's output
//     becomes the next product's left operand without leaving registers).
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA, "Matrix fragments for mma.m16n8k16"), for lane l of a warp,
// with g = l / 4 (the group, a row) and t = l % 4 (the thread in the
// group, a column pair):
//   A (16 x 16, row-major), 4 x b32 = 8 bf16:
//     a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col": element (k, n) with k contiguous), 2 x b32:
//     b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C/D (16 x 8, f32), 4 floats:
//     c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// In each b32 the lower 16 bits hold the element of the lower index.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

// -- asynchronous copies ------------------------------------------------------
// shared-space address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1 (.cg).  With valid false no
// byte is read and the 16 bytes are zero-filled (src-size 0); src must
// still be a mapped address, so pass any in-bounds pointer.  dst and src
// are 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// closes the group of copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most N of this thread's groups are still in flight; a
// __syncthreads() after it makes every thread's copies visible to all
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- swizzled tiles -----------------------------------------------------------
// A tile of rows of COLS bf16 (COLS a multiple of 64: 128-byte multiples),
// stored row-major in 16-byte chunks of 8 elements, chunk c of row r at
// chunk position c ^ (r & 7).  Eight consecutive rows read at the same
// logical chunk (one ldmatrix 8 x 8 matrix, or 8 lanes of a cp.async
// row) land on 8 distinct 16-byte bank groups: no bank conflict.
// Byte offset of chunk c of row r:
template <int COLS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(COLS % 64 == 0, "rows of 128-byte multiples");
  return static_cast<uint32_t>(r * COLS * 2 + ((c ^ (r & 7)) << 4));
}

// Copies rows [row0, row0 + ROWS) of a global tensor (row stride ss
// elements, contiguous rows of COLS bf16) into the swizzled tile at
// shared address dst, NT threads sharing the chunks; rows at or past
// `valid` are zero-filled and never read.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long ss, int row0,
                                                int valid) {
  constexpr int CH = COLS / 8;
  static_assert(ROWS * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    const __nv_bfloat16* p = ok ? src + (row0 + r) * ss + c * 8 : src;
    cp_async16(dst + swz<COLS>(r, c), p, ok);
  }
}

// -- ldmatrix -----------------------------------------------------------------
// Four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i (16 bytes each), and register ri of lane l receives matrix i's
// row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed: register ri of lane l receives rows
// 2 (l % 4) and 2 (l % 4) + 1 of matrix i, column l / 4.  This makes a
// "col" B fragment of a matrix stored row-major as [k][n] (V as [key][d]).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Addresses that make the x4 loaders give whole fragments from a swizzled
// tile of COLS columns (r0: the tile's first row, c0: its first 16-byte
// chunk; 16 columns are 2 chunks):
// A fragment of the 16 x 16 block at rows r0.., chunks c0, c0+1 (row-major
// A, e.g. Q as [row][d]): registers a0..a3 in order.
template <int COLS>
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t base, int r0,
                                                int c0, int lane) {
  return base + swz<COLS>(r0 + (lane & 15), c0 + (lane >> 4));
}
// B fragments of two n-tiles from a tile stored [n][k] (K as [key][d]):
// the 16 n rows at n0.., k chunks c0, c0+1.  Registers {r0, r1} are the
// fragment of n-tile n0, {r2, r3} of n-tile n0 + 8.
template <int COLS>
__device__ __forceinline__ uint32_t b_frag_addr(uint32_t base, int n0,
                                                int c0, int lane) {
  return base + swz<COLS>(n0 + (lane & 7) + ((lane >> 4) << 3),
                          c0 + ((lane >> 3) & 1));
}
// B fragments of two n-tiles from a tile stored [k][n] (V as [key][d]),
// for ldmatrix_x4_trans: k rows k0 .. k0+15, n chunks c0 (n-tile of
// {r0, r1}) and c0 + 1 (n-tile of {r2, r3}).
template <int COLS>
__device__ __forceinline__ uint32_t bt_frag_addr(uint32_t base, int k0,
                                                 int c0, int lane) {
  return base + swz<COLS>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                          c0 + (lane >> 4));
}

// -- mma ----------------------------------------------------------------------
// c += A (16 x 16 bf16) . B (16 x 8 bf16), float32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest bf16, lo in the lower 16 bits
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C fragments of n-tiles 2j and 2j+1 (columns 16j .. 16j+15 of a
// 16-row product) are, rounded to bf16, the A fragment of k-chunk j of
// the next product: a0 = C0[g][2t..], a1 = C0[g+8][2t..],
// a2 = C1[g][2t..] (columns 8 + 2t), a3 = C1[g+8][2t..].
__device__ __forceinline__ void c_pair_to_a(uint32_t a[4], const float c0[4],
                                            const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// max / sum over the 4 lanes of a quad (the lanes that share a C row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tc
