// Flash-attention dK/dV for Hopper (sm_90a) in float32, on tensor cores
// through split-TF32 products.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py _bwd (:550) ->
// _bwd_dkv_kernel (:497, call :607) for float32 inputs: with P recomputed
// from the forward's lse, p = exp(s scale - lse) and ds = p (dp - delta +
// dlse) scale, it computes dV = sum P^T dO and dK = sum dS^T Q over the
// live q tiles of every q head of a kv head's GQA group, with _mask_for's
// causal / window / offset rules, _tile_live's tile skip and p = 0 on
// masked scores (fully-masked q rows, lse = -1e30, add nothing).  Nothing
// is rounded to a narrower type: the inputs are float32, and every sum is
// float32.  bfloat16 runs flash_dkv_tc.cu; float32 outside the limits
// below runs flash_dkv_kernel in flash_attention.cu.
//
// What bounds it.  At the training shape (B 16, H 8, S 1024, D 64,
// causal) the kept (q, k) pairs need 34.4 GFLOP (8 D a pair: S^T, dP^T,
// dV and dK).  Each product here is three TF32 products (tf32x3.cuh), so
// the tensor cores do 103 GFLOP: 0.208 ms at the dense TF32 peak of 495
// TFLOP/s.  q, dO, k, v, dk and dv are 33.5 MB each and the three row
// terms 0.5 MB each: 0.061 ms at 3.35 TB/s.  The products set the bound.
// (As float32 FMAs the same work takes 0.513 ms at 67 TFLOP/s.)
//
// What the design does about it.
//   - All four products run on the tensor cores: mma.sync m16n8k8 tf32,
//     each float32 operand split into big + small TF32 halves in
//     registers as it is read, three products a block (tf32x3.cuh).  The
//     result is held to the float32 bound the float32-FMA kernel meets;
//     one TF32 product of rounded operands is not (chip_smoke.py's
//     planted one-product model fails it).
//   - One CTA of 4 warps owns 64 k rows of one (kv head, batch); each
//     warp owns 16 k rows and keeps its dK and dV accumulators in
//     registers (16 x 64 x 2 floats / 32 lanes = 64 registers).  The
//     transposed products S^T = K Q^T and dP^T = V dO^T put k on the
//     rows, so P^T and dS^T come out as the A operands of dV += P^T dO
//     and dK += dS^T Q without leaving registers.
//   - Trouble 1, fragment layouts: a tf32 C fragment's column pair
//     (2t, 2t+1) is not an A fragment's (t, t+4).  dV's and dK's k index
//     (q) is summed over, so it is permuted instead of shuffled: column
//     2t of an 8-q chunk goes to k slot t and column 2t+1 to slot t+4,
//     and the B operand reads rows q0 + 2t and q0 + 2t + 1 of dO and Q
//     (tf32x3::c_to_a, load_b_kn).  P^T and dS^T split into big and small
//     in registers.
//   - Trouble 2, registers: the bf16 kernel keeps its K and V A fragments
//     in registers at 248 registers; split float32 fragments need 4x
//     that.  Here K and V stay in shared memory and their fragments are
//     re-read and split every q tile (64 elements a lane, against 512 of
//     Q and dO), leaving the accumulators (64), S^T and dP^T (64) and the
//     fragments in flight.
//   - Trouble 3, bank conflicts: a float32 [q][d] tile with rows of 64
//     floats would put the 8 rows of a B fragment on one bank.  Every
//     tile here has rows padded to D + 4 floats, which puts each
//     fragment read (rows g: 4 g + t; rows 2t, 2t+1: 8 t + g, 8 t + 4 + g)
//     on 32 distinct banks.  ldmatrix moves 16-bit elements and is of no
//     use for 32-bit transposed reads; fragments are plain shared loads.
//   - Trouble 4, no wgmma: Hopper's tf32 wgmma takes only K-major
//     operands, and dV's and dK's B operands (dO and Q by rows of q) are
//     MN-major, so mma.sync is the instruction here.
//   - Trouble 5, the tensor core's float32 accumulation truncates.  With
//     every q tile's products chained into one accumulator (up to 16
//     tiles x 8 chunks x 3 products at the training shape), dK and dV
//     came out at 0.98 and 1.04 of the float32 bound on an H100, where
//     a torch model of the same split reads 0.16 and 0.18.  So each q
//     tile's dV and dK products are summed from zero (24 products) and
//     added into the totals by float32 adds (tile_sum): 0.28 and 0.22.
//     dV's partial, then dK's, so only 32 more registers live.
//   - The split is 4 integer and float instructions an element instead
//     of the 7 of ptxas's cvt.rna.tf32.f32 (tf32x3::split): the splits
//     of the Q and dO B fragments, which every warp re-reads, are most
//     of the kernel's issue slots.
//   - Q, dO and their lse, delta and dlse rows stream through a 2-stage
//     cp.async ring: 16-byte copies for the float32 tiles, 4-byte ones for
//     the rows, whose starts are only 4-byte aligned when Sq % 4 != 0.
//     The live (q head of the group, q tile) pairs form one flat sequence,
//     so the prefetch crosses head boundaries and the group sum stays in
//     registers, with no atomics: gradients are bitwise the same from run
//     to run.
//   - The per-element mask test runs only on tiles that straddle the
//     causal diagonal, a window edge, Sq or Sk.  Rows past Sq and Sk are
//     zero-filled; the test qi < Sq masks them.  exp is one ex2.approx
//     with log2(e) folded into the score scale and the lse.
//   - The heaviest causal k tiles start first across every (kv head,
//     batch): the grid's x runs over (kv head, batch), its y over k
//     tiles, and k tile 0 meets every q tile.  dK and dV leave as 8-byte
//     row stores from the accumulators, through the strides the tensors
//     come with (bhsd, bshd, GQA h / group, fused-QKV views).
//   - Two CTAs an SM: 106 KB of shared memory each (K, V and two stages
//     of Q and dO, rows of 68 floats) and 253 registers a thread, no
//     spill (ptxas -v, sm_90a).
//
// Limits: float32; head_dim 64 (at 128 ptxas for sm_90a reports 255
// registers and 436 bytes of spill stores, chip_ptxas_probe.py, so it is
// not built); q, k, v, dO, dk and dv 16-byte aligned; every batch, head
// and sequence stride a multiple of 4 elements; the last dimension
// contiguous.  A launch outside them returns cudaErrorInvalidValue
// without running.  Geo, Str and the mask rules come from flash_geo.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_geo.cuh"
#include "tc_tile.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int D = 64;             // head_dim
constexpr int LD = D + 4;         // padded row of a shared tile, floats
constexpr int BM = 64;            // q rows per tile
constexpr int BN = 64;            // k rows per CTA, 16 per warp
constexpr int NT = 32 * BN / 16;  // 4 warps
constexpr int NS = BM / 8;        // n-tiles of an S^T block (8 q each)
constexpr int ND = D / 8;         // n-tiles of dK, dV; k chunks of S^T
constexpr int STAGES = 2;         // Q/dO ring depth
constexpr int NROW = 3;           // row terms a q tile: lse, delta, dlse
constexpr int TILE = BM * LD;     // floats of one Q, dO, K or V tile
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BM == BN, "one tile size for Q, dO, K and V");
static_assert(LD % 32 == 4, "fragment reads on 32 distinct banks");

using namespace flash;

// P^T and dS^T of one q tile for a warp's 16 k rows, as flash_dkv_tc.cu's
// p_ds_step without the rounding: s holds the raw K Q^T block and dp the
// V dO^T block on entry; on exit s holds p and dp holds ds.  C element
// (n, e) is k row kj0 + 8 (e >> 1) and q column 8 n + 2 t + (e & 1) of
// the tile (q row q0 + that column); rt holds the tile's lse, delta and
// dlse rows (BM floats each).  MASK: the tile straddles the band, Sq or
// Sk, so each score is tested; masked scores give p = 0 (and ds = 0) by
// the mask, never by the value.
template <bool MASK>
__device__ __forceinline__ void p_ds_step(float (&s)[NS][4],
                                          float (&dp)[NS][4],
                                          const float* rt, const Geo& g,
                                          int q0, int kj0, int t,
                                          float sl2) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int qc = 8 * n + 2 * t;
    const float2 lse = *reinterpret_cast<const float2*>(rt + qc);
    const float2 delta = *reinterpret_cast<const float2*>(rt + BM + qc);
    const float2 dlse = *reinterpret_cast<const float2*>(rt + 2 * BM + qc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e & 1;
      bool in = true;
      if (MASK) {
        const int qi = q0 + qc + hi, kj = kj0 + 8 * (e >> 1);
        in = qi < g.Sq && kj < g.Sk && keep(g, qi, kj);
      }
      const float l2 = (hi ? lse.y : lse.x) * LOG2E;
      const float p = in ? exp2_ftz(fmaf(s[n][e], sl2, -l2)) : 0.f;
      const float dd = hi ? delta.y : delta.x;
      const float dl = hi ? dlse.y : dlse.x;
      s[n][e] = p;
      dp[n][e] = p * (dp[n][e] - dd + dl) * g.scale;
    }
  }
}

// acc += C^T B over one q tile: C the tile's P^T or dS^T (C fragments,
// k rows by q columns), B the tile's dO or Q ([q][d]); the 16 x D
// product is summed from zero on the tensor cores, then added into acc
__device__ __forceinline__ void tile_sum(float (&acc)[ND][4],
                                         const float (&c)[NS][4],
                                         const float* b, int g, int t) {
  float part[ND][4];
#pragma unroll
  for (int m = 0; m < ND; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[m][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const tf32x3::Frag<4> a = tf32x3::c_to_a(c[j]);
#pragma unroll
    for (int m = 0; m < ND; ++m)
      tf32x3::mma3(part[m], a, tf32x3::load_b_kn<LD>(b, 8 * j, 8 * m, g, t));
  }
#pragma unroll
  for (int m = 0; m < ND; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] += part[m][e];
}

// one CTA per (kv head and batch, 64-row k tile)
__global__ void __launch_bounds__(NT)
    flash_dkv_f32tc_kernel(Geo g, const float* __restrict__ q, Str qs,
                           const float* __restrict__ k, Str ks,
                           const float* __restrict__ v, Str vs,
                           const float* __restrict__ dO, Str dos,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ dlse,
                           float* __restrict__ dk, Str dks,
                           float* __restrict__ dv, Str dvs) {
  extern __shared__ __align__(128) float smem[];
  float* sK = smem;
  float* sV = sK + TILE;
  float* sQ = sV + TILE;            // STAGES tiles
  float* sO = sQ + STAGES * TILE;   // STAGES dO tiles
  float* rows = sO + STAGES * TILE;

  // heaviest causal tiles first: k tile 0 meets every q tile
  const int hk = blockIdx.x % g.Hkv, b = blockIdx.x / g.Hkv;
  const int kt = blockIdx.y;
  const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // fragment group and thread
  const int wr = warp * 16;                 // the warp's first k row
  float* dkb = dk + b * dks.b + hk * dks.h;
  float* dvb = dv + b * dvs.b + hk * dvs.h;

  // the live q tiles form one run (tile_live is a band), the same for
  // every head of the group
  const int k_lo = g.ko + k0, k_hi = k_lo + kn - 1;
  const int nq = (g.Sq + BM - 1) / BM;
  int qt_lo = nq, qt_hi = -1;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
    if (tile_live(g, g.qo + q0, g.qo + q0 + qn - 1, k_lo, k_hi)) {
      qt_lo = min(qt_lo, qt);
      qt_hi = qt;
    }
  }
  const int nqt = qt_hi - qt_lo + 1;
  if (nqt <= 0) {  // no q row sees these keys: dk = dv = 0
    for (int i = threadIdx.x; i < kn * (D / 4); i += NT) {
      const long long r = k0 + i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(dkb + r * dks.s + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dvb + r * dvs.s + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int n_live = g.group * nqt;  // (head, q tile) pairs, head-major

  auto load_q = [&](int stage, int it) {
    const int gi = it / nqt, qt = qt_lo + it - gi * nqt;
    const int h = hk * g.group + gi;
    const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
    tf32x3::load_tile<BM, D, LD, NT>(tc::smem_addr(sQ + stage * TILE),
                                     q + b * qs.b + h * qs.h, qs.s, q0, qn);
    tf32x3::load_tile<BM, D, LD, NT>(tc::smem_addr(sO + stage * TILE),
                                     dO + b * dos.b + h * dos.h, dos.s, q0,
                                     qn);
    const long long r0 = ((long long)b * g.Hq + h) * g.Sq + q0;
    const uint32_t dst = tc::smem_addr(rows + stage * NROW * BM);
    for (int i = threadIdx.x; i < NROW * BM; i += NT) {
      const int t = i / BM, r = i - t * BM;
      const float* src = (t == 0 ? lse : t == 1 ? delta : dlse) + r0;
      const bool ok = r < qn;
      tc::cp_async4(dst + 4 * i, ok ? src + r : src, ok);
    }
  };
  // groups: K and V, then one per Q/dO tile (empty past the last one)
  tf32x3::load_tile<BN, D, LD, NT>(tc::smem_addr(sK),
                                   k + b * ks.b + hk * ks.h, ks.s, k0, kn);
  tf32x3::load_tile<BN, D, LD, NT>(tc::smem_addr(sV),
                                   v + b * vs.b + hk * vs.h, vs.s, k0, kn);
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_live) load_q(st, st);
    tc::cp_async_commit();
  }

  float gk[ND][4], gv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;
  const float sl2 = g.scale * LOG2E;
  const int kj0 = k0 + wr + gr;
  const bool k_whole = kn == BN;

  for (int it = 0; it < n_live; ++it) {
    tc::cp_async_wait<STAGES - 2>();  // tile it (and K, V) landed ...
    __syncthreads();  // ... for every thread, and tile it-1 is consumed
    if (it + STAGES - 1 < n_live)
      load_q((it + STAGES - 1) % STAGES, it + STAGES - 1);
    tc::cp_async_commit();
    const int stage = it % STAGES;
    const float* qS = sQ + stage * TILE;
    const float* oS = sO + stage * TILE;
    const float* rt = rows + stage * NROW * BM;
    const int gi = it / nqt;
    const int q0 = (qt_lo + it - gi * nqt) * BM, qn = min(BM, g.Sq - q0);

    // S^T = K Q^T and dP^T = V dO^T (16 x 64 per warp), d chunks of 8
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const tf32x3::Frag<4> ka = tf32x3::load_a<LD>(sK, wr, 8 * c, gr, tq);
      const tf32x3::Frag<4> va = tf32x3::load_a<LD>(sV, wr, 8 * c, gr, tq);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        tf32x3::mma3(s[n], ka,
                     tf32x3::load_b_nk<LD>(qS, 8 * n, 8 * c, gr, tq));
        tf32x3::mma3(dp[n], va,
                     tf32x3::load_b_nk<LD>(oS, 8 * n, 8 * c, gr, tq));
      }
    }

    if (k_whole && qn == BM &&
        tile_full(g, g.qo + q0, g.qo + q0 + BM - 1, k_lo, k_hi))
      p_ds_step<false>(s, dp, rt, g, q0, kj0, tq, sl2);
    else
      p_ds_step<true>(s, dp, rt, g, q0, kj0, tq, sl2);

    // dV += P^T dO, then dK += dS^T Q (q chunk j = S^T's n-tile j),
    // each first as this tile's sum, then added into the total by
    // float32 adds: the tensor core's accumulation truncates, and over
    // one tile it runs through 24 products instead of the whole sum
    tile_sum(gv, s, oS, gr, tq);
    tile_sum(gk, dp, qS, gr, tq);
  }
  tc::cp_async_wait<0>();  // the groups after the last tile are empty

  // epilogue: C element (m, e) is k row wr + g + 8 (e >> 1), d column
  // 8 m + 2 t + (e & 1): two 8-byte stores a row pair
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + gr + 8 * i;
    if (row >= kn) continue;
    const long long r = k0 + row;
#pragma unroll
    for (int m = 0; m < ND; ++m) {
      const int c = 8 * m + 2 * tq;
      *reinterpret_cast<float2*>(dkb + r * dks.s + c) =
          make_float2(gk[m][2 * i], gk[m][2 * i + 1]);
      *reinterpret_cast<float2*>(dvb + r * dvs.s + c) =
          make_float2(gv[m][2 * i], gv[m][2 * i + 1]);
    }
  }
}

}  // namespace

// C entry point (ctypes), with mxtt_flash_dkv's signature.  dtype must be
// 0 (float32).  dims: B, Hq, Hkv, Sq, Sk, D.  strides: 3 per tensor
// (batch, head, sequence) for q, k, v, dO, dk, dv.  lse, delta, dlse:
// float32 (B, Hq, Sq) contiguous.  Returns the cudaError_t.
extern "C" int mxtt_flash_dkv_f32tc(int dtype, const void* q, const void* k,
                                    const void* v, const void* dO,
                                    const void* lse, const void* delta,
                                    const void* dlse, void* dk, void* dv,
                                    const int* dims, const long long* strides,
                                    int causal, int window, int q_offset,
                                    int k_offset, float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  const bool geo_ok = g.B > 0 && g.Hq > 0 && g.Hkv > 0 && g.Hq % g.Hkv == 0 &&
                      g.Sq > 0 && g.Sk > 0 && g.D == D && g.window >= 0 &&
                      (long long)g.B * g.Hkv <= 0x7fffffff &&
                      (g.Sk + BN - 1) / BN <= 65535;
  if (dtype != 0 || !geo_ok || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dO) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 18; ++i)
    if (strides[i] % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 + 2 * STAGES) * TILE * sizeof(float) +
                      (size_t)STAGES * NROW * BM * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_f32tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.B * g.Hkv, (g.Sk + BN - 1) / BN);
  flash_dkv_f32tc_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      g, (const float*)q, str_at(strides, 0), (const float*)k,
      str_at(strides, 1), (const float*)v, str_at(strides, 2),
      (const float*)dO, str_at(strides, 3), (const float*)lse,
      (const float*)delta, (const float*)dlse, (float*)dk, str_at(strides, 4),
      (float*)dv, str_at(strides, 5));
  return (int)cudaGetLastError();
}
