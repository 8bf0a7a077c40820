// Flash-attention dQ for Hopper (sm_90a) in float32, on tensor cores
// through split-TF32 products.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py _bwd (:550) ->
// _bwd_dq_kernel (:451, call :579) for float32 inputs: with P recomputed
// from the forward's lse, p = exp(s scale - lse) and ds = p (dp - delta +
// dlse) scale, it computes dQ = sum dS K over the live k tiles of a q
// tile, with _mask_for's causal / window / offset rules, _tile_live's
// tile skip and p = 0 on masked scores (fully-masked q rows, lse = -1e30,
// get dq = 0).  q head h reads kv head h / group.  Nothing is rounded to a
// narrower type: the reference's ds.astype(k.dtype) (:489) is the
// identity for float32, and every sum is float32.  bfloat16 runs
// flash_dq_tc.cu; float32 outside the limits below runs flash_dq_kernel
// in flash_attention.cu.
//
// What bounds it.  At the training shape (B 16, H 8, S 1024, D 64,
// causal) the kept (q, k) pairs need 25.8 GFLOP (6 D a pair: S, dP and
// dQ).  Each product here is three TF32 products (tf32x3.cuh), so the
// tensor cores do 77.4 GFLOP: 0.156 ms at the dense TF32 peak of 495
// TFLOP/s.  q, dO, dq, k and v are 33.5 MB each and the three row terms
// 0.5 MB each: 0.051 ms at 3.35 TB/s.  The products set the bound.  (As
// float32 FMAs the same work takes 0.385 ms at 67 TFLOP/s.)
//
// What the design does about it.
//   - All three products run on the tensor cores: mma.sync m16n8k8 tf32,
//     each float32 operand split into big + small TF32 halves in
//     registers as it is read, three products a block (tf32x3.cuh).  The
//     result is held to the float32 bound the float32-FMA kernel meets;
//     one TF32 product of rounded operands is not (chip_smoke.py's
//     planted one-product model fails it).
//   - One CTA of 4 warps owns 64 q rows of one (q head, batch); each warp
//     owns 16 q rows and keeps its dQ accumulator (16 x 64 floats / 32
//     lanes = 32 registers).  S = Q K^T and dP = dO V^T put q on the
//     rows, so dS comes out as C fragments (rows g and g + 8 of the
//     warp's 16 for each lane), and those are the A operand of dQ += dS K
//     through tf32x3::c_to_a, with K's B fragments read by rows of key
//     (tf32x3::load_b_kn, the same slot permutation).  dS never goes to
//     shared memory, and no __syncthreads separates the products.  One K
//     tile in shared memory serves both of K's operand layouts (load_b_nk
//     for S, load_b_kn for dQ); rows of D + 4 floats put both reads on 32
//     distinct banks.
//   - The row terms index the C fragment's rows: each thread reads lse,
//     delta and dlse of its two rows once, into registers.  exp is one
//     ex2.approx with log2(e) folded into the score scale and the lse.
//   - Trouble 1, registers.  A lane holds dQ (32), S/P (32) and dP/dS
//     (32) through the first two products; P is folded into dS, so the
//     tile's dS K partial (32) takes S's place for the third.  Keeping
//     Q's and dO's split A fragments in registers too would add 128.
//     Here both are re-read from shared memory and split every k tile
//     (64 elements a lane, against 384 of K's and V's B fragments).
//     ptxas for sm_90a: 255 registers, no spill.  Keeping Q's split
//     fragments in registers instead (chip_ptxas_probe.py --flash, with
//     the qa read replaced by a qf[ND] array loaded before the k loop):
//     also 255, no spill, the same dq shares, and slower on an H100
//     (0.667 ms against 0.640 at the training shape), so it is not built.
//     Storing Q and dO pre-split in shared memory would save the same 64
//     splits a tile for 35 KB more a CTA: 139 KB, one CTA an SM.
//   - Trouble 2, the tensor core's float32 accumulation truncates
//     (flash_dkv_f32tc.cu's trouble 5).  S is summed from zero each k
//     tile (8 chunks x 3 products), and so is the tile's dS K, which is
//     then added into dQ by float32 adds, rather than chaining every
//     tile's products into dQ.
//   - Trouble 3, dS cancels.  ds = p (dp - delta + dlse) scale, and delta
//     = sum_k p dp, so dp - delta is a difference of two near-equal
//     values wherever one key holds most of a row's p (a causal row's
//     first keys).  There |ds| is ~|dlse| scale while dp is ~8 (|dO| |V|
//     over 64 d), and an error of a few float32 ulps of dp is a large
//     share of the bound 1e-5 |dS| |K| + 1e-6: plain float32 itself
//     reads 1.04-1.10 of it at such rows against float64 on an H100
//     (chip_smoke.py's float32 train cases), so chip_smoke.py holds
//     the float32 kernels to the plain version in float64.  dP's 24
//     products chained on the tensor core truncate each partial sum
//     (about an ulp of ~8 each, one way), and dq read 1.44-3.14 of the
//     bound there over three draws of the train and train_fused cases
//     (chip_ptxas_probe.py --flash with part aliased to dp[n]: 239
//     registers, 0.533 ms).  So dP is summed a d chunk at a time (3
//     products from zero) and the chunks are added by float32 adds with
//     round-to-nearest: 256 adds a lane and tile, 0.45-0.79 of the bound
//     over the same draws, 0.640 ms.  S needs no such care: its error
//     enters p as a relative error.
//   - Trouble 4, no wgmma: Hopper's tf32 wgmma takes only K-major
//     operands, and dQ's B operand (K by rows of key) is MN-major, so
//     mma.sync is the instruction here.
//   - The split is tf32x3::split (4 instructions an element): the splits
//     of K's and V's B fragments, which each of the four warps re-reads,
//     are most of the kernel's issue slots.
//   - K and V stream through a 2-stage cp.async ring of 16-byte copies;
//     Q and dO are loaded once.  Rows past Sq and Sk are zero-filled.  A
//     zero K row past Sk would give s = 0 and p = exp(-lse) != 0, so the
//     test kj < Sk masks it, and qi < Sq masks the rows past Sq.  The
//     per-element mask test runs only on a warp's tiles that straddle the
//     causal diagonal, a window edge, Sq or Sk (tile_full clears the
//     rest).
//   - The heaviest causal q tiles start first across every (q head,
//     batch): the grid's x runs over (q head, batch), its y over q tiles
//     from the last.  dq leaves as 8-byte row stores from the
//     accumulators through the strides the tensor comes with (bhsd, bshd,
//     dq made by empty_like of a fused-QKV view).  Nothing is summed
//     across heads, so there are no atomics: dq is bitwise the same from
//     run to run.
//   - Two CTAs an SM: 104,448 bytes of shared memory each (Q, dO and two
//     stages of K and V, rows of 68 floats) and 255 registers a thread.
//
// Limits: float32; head_dim 64 (at 128 ptxas for sm_90a reports 255
// registers and 92 bytes of spill stores, chip_ptxas_probe.py, so it is
// not built); q, k, v, dO and dq 16-byte
// aligned; every batch, head and sequence stride a multiple of 4
// elements; the last dimension contiguous.  A launch outside them returns
// cudaErrorInvalidValue without running.  Geo, Str and the mask rules
// come from flash_geo.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_geo.cuh"
#include "tc_tile.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int D = 64;             // head_dim
constexpr int LD = D + 4;         // padded row of a shared tile, floats
constexpr int BM = 64;            // q rows per CTA, 16 per warp
constexpr int BN = 64;            // k rows per tile
constexpr int NT = 32 * BM / 16;  // 4 warps
constexpr int NS = BN / 8;        // n-tiles of S, dP (8 keys); k chunks of dQ
constexpr int ND = D / 8;         // k chunks of S, dP; n-tiles of dQ
constexpr int STAGES = 2;         // K/V ring depth
constexpr int TILE = BM * LD;     // floats of one Q, dO, K or V tile
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BM == BN, "one tile size for Q, dO, K and V");
static_assert(LD % 32 == 4, "fragment reads on 32 distinct banks");

using namespace flash;

// dS of one k tile for a warp's 16 q rows, as flash_dq_tc.cu's ds_step
// without the rounding.  s holds the raw Q K^T block and dp the dO V^T
// block on entry; on exit dp holds ds.  C element (n, e) is q row qi0 +
// 8 (e >> 1) and key kj0 + 8 n + (e & 1); l2 (lse in base-2 units), dd
// (delta) and dl (dlse) hold the terms of the lane's two rows.  MASK: the
// tile straddles the band, Sq or Sk, so each score is tested; masked
// scores give p = 0 (and ds = 0) by the mask, never by the value.
template <bool MASK>
__device__ __forceinline__ void ds_step(const float (&s)[NS][4],
                                        float (&dp)[NS][4],
                                        const float (&l2)[2],
                                        const float (&dd)[2],
                                        const float (&dl)[2], const Geo& g,
                                        int qi0, int kj0, float sl2) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      bool in = true;
      if (MASK) {
        const int qi = qi0 + 8 * r, kj = kj0 + 8 * n + (e & 1);
        in = qi < g.Sq && kj < g.Sk && keep(g, qi, kj);
      }
      const float p = in ? exp2_ftz(fmaf(s[n][e], sl2, -l2[r])) : 0.f;
      dp[n][e] = p * (dp[n][e] - dd[r] + dl[r]) * g.scale;
    }
}

// one CTA per (q head and batch, 64-row q tile)
__global__ void __launch_bounds__(NT)
    flash_dq_f32tc_kernel(Geo g, const float* __restrict__ q, Str qs,
                          const float* __restrict__ k, Str ks,
                          const float* __restrict__ v, Str vs,
                          const float* __restrict__ dO, Str dos,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dlse,
                          float* __restrict__ dq, Str dqs) {
  extern __shared__ __align__(128) float smem[];
  float* sQ = smem;
  float* sO = sQ + TILE;
  float* sK = sO + TILE;            // STAGES tiles
  float* sV = sK + STAGES * TILE;   // STAGES tiles

  // heaviest causal tiles (the last q rows) first, across every head
  const int h = blockIdx.x % g.Hq, b = blockIdx.x / g.Hq;
  const int hk = h / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int qn = min(BM, g.Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // fragment group and thread
  const int wr = warp * 16;                 // the warp's first q row
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* dqb = dq + b * dqs.b + h * dqs.h;

  // the live k tiles form one run (tile_live is a band)
  const int q_lo = g.qo + q0, q_hi = q_lo + qn - 1;
  const int nk = (g.Sk + BN - 1) / BN;
  int kt_lo = nk, kt_hi = -1;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
    if (tile_live(g, q_lo, q_hi, g.ko + k0, g.ko + k0 + kn - 1)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt;
    }
  }
  const int n_live = kt_hi - kt_lo + 1;
  if (n_live <= 0) {  // no row of the tile sees a key: dq = 0
    for (int i = threadIdx.x; i < qn * (D / 4); i += NT) {
      const long long r = q0 + i / (D / 4);
      *reinterpret_cast<float4*>(dqb + r * dqs.s + (i % (D / 4)) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  auto load_kv = [&](int stage, int it) {
    const int k0 = (kt_lo + it) * BN, kn = min(BN, g.Sk - k0);
    tf32x3::load_tile<BN, D, LD, NT>(tc::smem_addr(sK + stage * TILE), kb,
                                     ks.s, k0, kn);
    tf32x3::load_tile<BN, D, LD, NT>(tc::smem_addr(sV + stage * TILE), vb,
                                     vs.s, k0, kn);
  };
  // groups: Q and dO, then one per K/V tile (empty past the last one)
  tf32x3::load_tile<BM, D, LD, NT>(tc::smem_addr(sQ), q + b * qs.b + h * qs.h,
                                   qs.s, q0, qn);
  tf32x3::load_tile<BM, D, LD, NT>(tc::smem_addr(sO),
                                   dO + b * dos.b + h * dos.h, dos.s, q0, qn);
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_live) load_kv(st, st);
    tc::cp_async_commit();
  }

  // the row terms of this lane's rows qi0 and qi0 + 8 (0 past Sq: those
  // rows are masked and never stored)
  const int qi0 = q0 + wr + gr;
  float l2[2], dd[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qi0 + 8 * i;
    const long long r = ((long long)b * g.Hq + h) * g.Sq + qi;
    const bool ok = qi < g.Sq;
    l2[i] = ok ? lse[r] * LOG2E : 0.f;
    dd[i] = ok ? delta[r] : 0.f;
    dl[i] = ok ? dlse[r] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int m = 0; m < ND; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  const float sl2 = g.scale * LOG2E;
  const int kj0 = 2 * tq;
  // the warp's 16 rows: the mask test can be skipped on a tile only if
  // they all lie below Sq
  const bool q_whole = q0 + wr + 16 <= g.Sq;
  const int wq_lo = g.qo + q0 + wr;

  for (int it = 0; it < n_live; ++it) {
    tc::cp_async_wait<STAGES - 2>();  // tile it (and Q, dO) landed ...
    __syncthreads();  // ... for every thread, and tile it-1 is consumed
    if (it + STAGES - 1 < n_live)
      load_kv((it + STAGES - 1) % STAGES, it + STAGES - 1);
    tc::cp_async_commit();
    const int stage = it % STAGES;
    const float* kS = sK + stage * TILE;
    const float* vS = sV + stage * TILE;
    const int k0 = (kt_lo + it) * BN, kn = min(BN, g.Sk - k0);

    // S = Q K^T and dP = dO V^T (16 x 64 per warp), d chunks of 8, S
    // summed from zero, dP chunk by chunk (trouble 3); Q's and dO's
    // fragments re-read and split
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const tf32x3::Frag<4> qa = tf32x3::load_a<LD>(sQ, wr, 8 * c, gr, tq);
      const tf32x3::Frag<4> oa = tf32x3::load_a<LD>(sO, wr, 8 * c, gr, tq);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        tf32x3::mma3(s[n], qa,
                     tf32x3::load_b_nk<LD>(kS, 8 * n, 8 * c, gr, tq));
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        tf32x3::mma3(part, oa,
                     tf32x3::load_b_nk<LD>(vS, 8 * n, 8 * c, gr, tq));
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] += part[e];
      }
    }

    if (q_whole && kn == BN &&
        tile_full(g, wq_lo, wq_lo + 15, g.ko + k0, g.ko + k0 + BN - 1))
      ds_step<false>(s, dp, l2, dd, dl, g, qi0, k0 + kj0, sl2);
    else
      ds_step<true>(s, dp, l2, dd, dl, g, qi0, k0 + kj0, sl2);

    // dQ += dS K: this tile's product summed from zero on the tensor cores
    // (key chunk j = dP's n-tile j), then added by float32 adds: the
    // tensor core's accumulation truncates
    float part[ND][4];
#pragma unroll
    for (int m = 0; m < ND; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const tf32x3::Frag<4> a = tf32x3::c_to_a(dp[j]);
#pragma unroll
      for (int m = 0; m < ND; ++m)
        tf32x3::mma3(part[m], a,
                     tf32x3::load_b_kn<LD>(kS, 8 * j, 8 * m, gr, tq));
    }
#pragma unroll
    for (int m = 0; m < ND; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] += part[m][e];
  }
  tc::cp_async_wait<0>();  // the groups after the last tile are empty

  // epilogue: C element (m, e) is q row wr + g + 8 (e >> 1), d column
  // 8 m + 2 t + (e & 1): 8-byte row stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + gr + 8 * i;
    if (row >= qn) continue;
    const long long r = q0 + row;
#pragma unroll
    for (int m = 0; m < ND; ++m)
      *reinterpret_cast<float2*>(dqb + r * dqs.s + 8 * m + 2 * tq) =
          make_float2(acc[m][2 * i], acc[m][2 * i + 1]);
  }
}

}  // namespace

// C entry point (ctypes), with mxtt_flash_dq's signature.  dtype must be
// 0 (float32).  dims: B, Hq, Hkv, Sq, Sk, D.  strides: 3 per tensor
// (batch, head, sequence) for q, k, v, dO, dq.  lse, delta, dlse: float32
// (B, Hq, Sq) contiguous.  Returns the cudaError_t.
extern "C" int mxtt_flash_dq_f32tc(int dtype, const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const void* lse, const void* delta,
                                   const void* dlse, void* dq,
                                   const int* dims, const long long* strides,
                                   int causal, int window, int q_offset,
                                   int k_offset, float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  const bool geo_ok = g.B > 0 && g.Hq > 0 && g.Hkv > 0 && g.Hq % g.Hkv == 0 &&
                      g.Sq > 0 && g.Sk > 0 && g.D == D && g.window >= 0 &&
                      (long long)g.B * g.Hq <= 0x7fffffff &&
                      (g.Sq + BM - 1) / BM <= 65535;
  if (dtype != 0 || !geo_ok || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dO) || !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 15; ++i)
    if (strides[i] % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 + 2 * STAGES) * TILE * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_f32tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.B * g.Hq, (g.Sq + BM - 1) / BM);
  flash_dq_f32tc_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      g, (const float*)q, str_at(strides, 0), (const float*)k,
      str_at(strides, 1), (const float*)v, str_at(strides, 2),
      (const float*)dO, str_at(strides, 3), (const float*)lse,
      (const float*)delta, (const float*)dlse, (float*)dq,
      str_at(strides, 4));
  return (int)cudaGetLastError();
}
