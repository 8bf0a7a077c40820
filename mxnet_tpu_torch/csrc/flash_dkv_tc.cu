// Flash-attention dK/dV for Hopper (sm_90a) on bf16 tensor cores.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py _bwd (:550) ->
// _bwd_dkv_kernel (:497) for bfloat16 inputs: with P recomputed from the
// forward's lse, p = exp(s scale - lse) and ds = p (dp - delta + dlse)
// scale, it computes dV = sum P^T dO and dK = sum dS^T Q over the live q
// tiles of every q head of a kv head's GQA group, with _mask_for's causal /
// window / offset rules, _tile_live's tile skip and p = 0 on masked scores
// (fully-masked q rows, lse = -1e30, add nothing).  p is rounded to bf16
// where the TPU kernel casts p.astype(do.dtype) (:534) and ds where it
// casts ds.astype(q.dtype) (:540); every sum is float32.  float32, and
// bf16 geometries outside the limits below, run flash_dkv_kernel in
// flash_attention.cu.
//
// What bounds it.  At the training shape (B 16, H 8, S 1024, D 64,
// causal) the kept (q, k) pairs need 34.4 GFLOP (8 D a pair: S^T, dP^T,
// dV and dK), 0.0348 ms at the bf16 tensor-core peak of 989 TFLOP/s; q,
// dO, k, v, dk and dv are 16.8 MB each and the three row terms 0.5 MB
// each, 0.0305 ms at 3.35 TB/s.  The products set the bound.
//
// What the design does about it.
//   - All four products run on the tensor cores: mma.sync m16n8k16 bf16
//     with float32 accumulators (tc_tile.cuh).  One CTA of 4 warps owns 64
//     k rows of one (kv head, batch); each warp owns 16 k rows and keeps
//     its dK and dV accumulators (16 x D each) and its K and V A fragments
//     (ldmatrix once) in registers: 248 registers at D 64, no spill.  At
//     D 128 the accumulators alone take 128 registers; with the K and V
//     fragments re-read from shared memory each q tile, ptxas still needed
//     255 and spilled, so D 128 stays on flash_dkv_kernel.
//   - The transposed products put k on the rows: S^T = K Q^T and
//     dP^T = V dO^T read Q and dO ([q][d] tiles) as mma's "col" B operand
//     by plain ldmatrix; P^T and dS^T (C fragments) are rounded to bf16 and
//     repacked straight into the A fragments of dV += P^T dO and
//     dK += dS^T Q, whose B operands are the same Q and dO tiles read
//     through ldmatrix.trans.  P and dS never touch shared memory.
//   - Q and dO tiles of 64 rows, with their lse, delta and dlse rows,
//     stream through a 2-stage cp.async ring of swizzled tiles: tile i+1
//     is in flight while tile i is multiplied; one __syncthreads a tile.
//     The live (q head of the group, q tile) pairs form one flat sequence
//     (for each head, the band of live q tiles), so the prefetch runs
//     across head boundaries and the group sum stays in registers, with
//     no atomics: gradients are bitwise the same from run to run.
//   - In S^T the row terms index columns (q): each thread reads the two of
//     its column pair from shared memory (float2).  The row terms' starts
//     are only 4-byte aligned (Sq need not be a multiple of 4), so they
//     travel as 4-byte copies.
//   - The per-element mask test runs only on tiles that straddle the
//     causal diagonal, a window edge, Sq or Sk (p_ds_step<true>).  Rows
//     past Sq are zero-filled, which would give p = exp(0 - 0) = 1 there:
//     the test qi < Sq masks them.  exp is one ex2.approx with log2(e)
//     folded into the score scale and the lse.
//   - Heaviest causal k tiles (k tile 0 meets every q tile) start first;
//     dK and dV leave through shared memory as 16-byte row stores, through
//     the strides the tensors come with (bhsd, bshd, GQA h / group, dk/dv
//     made by empty_like of fused-QKV views).
//
// Limits: bfloat16; head_dim 64; q, k, v, dO, dk and dv 16-byte
// aligned; every batch, head and sequence stride a multiple of 8
// elements; the last dimension contiguous.  A launch outside them returns
// cudaErrorInvalidValue without running.  Geo, Str and the mask rules
// come from flash_geo.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_geo.cuh"
#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;            // q rows per tile
constexpr int BN = 64;            // k rows per CTA, 16 per warp
constexpr int NT = 32 * BN / 16;  // 4 warps
constexpr int NS = BM / 8;        // n-tiles of an S^T block (8 q each)
constexpr int STAGES = 2;         // Q/dO ring depth
constexpr int NROW = 3;           // row terms a q tile: lse, delta, dlse
constexpr float LOG2E = 1.4426950408889634f;

using namespace flash;

// P^T and dS^T of one q tile for a warp's 16 k rows.  s holds the raw
// K Q^T block and dp the V dO^T block on entry; on exit s holds p and dp
// holds ds, both float32.  C element (n, e) is k row kj0 + 8 (e >> 1) and
// q column 8 n + 2 tq + (e & 1) of the tile (q row q0 + that column); rt
// holds the tile's lse, delta and dlse rows (BM floats each).  MASK: the
// tile straddles the band, Sq or Sk, so each score is tested; masked
// scores give p = 0 (and ds = 0) by the mask, never by the value.
template <bool MASK>
__device__ __forceinline__ void p_ds_step(float (&s)[NS][4],
                                          float (&dp)[NS][4],
                                          const float* rt, const Geo& g,
                                          int q0, int kj0, int tq,
                                          float sl2) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int qc = 8 * n + 2 * tq;
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

// one CTA per (64-row k tile, kv head, batch)
template <int D>
__global__ void __launch_bounds__(NT)
    flash_dkv_tc_kernel(Geo g, const bf16* __restrict__ q, Str qs,
                        const bf16* __restrict__ k, Str ks,
                        const bf16* __restrict__ v, Str vs,
                        const bf16* __restrict__ dO, Str dos,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ dlse,
                        bf16* __restrict__ dk, Str dks,
                        bf16* __restrict__ dv, Str dvs) {
  constexpr int KC = D / 16;        // 16-wide d chunks of K Q^T, V dO^T
  constexpr int ND = D / 8;         // n-tiles of dK, dV = 16-byte chunks
  constexpr int TILE = BM * D * 2;  // bytes of one Q, dO, K or V tile
  static_assert(BM == BN, "one tile size for Q, dO, K and V");
  static_assert(D == 64, "at D 128 the fragments held here spill");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sK = tc::smem_addr(smem);  // then dK's staging
  const uint32_t sV = sK + TILE;            // then dV's staging
  const uint32_t sQ = sV + TILE;            // STAGES tiles
  const uint32_t sO = sQ + STAGES * TILE;   // STAGES dO tiles
  float* rows = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * TILE);

  // heaviest causal tiles first: k tile 0 meets every q tile
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // C row g and column pair t
  const int wr = warp * 16;                 // the warp's first k row
  bf16* dkb = dk + b * dks.b + hk * dks.h;
  bf16* dvb = dv + b * dvs.b + hk * dvs.h;

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
    for (int i = threadIdx.x; i < kn * ND; i += NT) {
      const long long r = k0 + i / ND;
      const int c = (i % ND) * 8;
      *reinterpret_cast<uint4*>(dkb + r * dks.s + c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dvb + r * dvs.s + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int n_live = g.group * nqt;  // (head, q tile) pairs, head-major

  auto load_q = [&](int stage, int it) {
    const int gi = it / nqt, qt = qt_lo + it - gi * nqt;
    const int h = hk * g.group + gi;
    const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
    tc::load_tile_async<BM, D, NT>(sQ + stage * TILE, q + b * qs.b + h * qs.h,
                                   qs.s, q0, qn);
    tc::load_tile_async<BM, D, NT>(sO + stage * TILE,
                                   dO + b * dos.b + h * dos.h, dos.s, q0, qn);
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
  tc::load_tile_async<BN, D, NT>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, kn);
  tc::load_tile_async<BN, D, NT>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, kn);
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_live) load_q(st, st);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<STAGES - 1>();  // K and V have landed
  __syncthreads();
  uint32_t kf[KC][4], vf[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    tc::ldmatrix_x4(kf[c], tc::a_frag_addr<D>(sK, wr, 2 * c, lane));
    tc::ldmatrix_x4(vf[c], tc::a_frag_addr<D>(sV, wr, 2 * c, lane));
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
    tc::cp_async_wait<STAGES - 2>();  // tile it has landed ...
    __syncthreads();  // ... for every thread, and tile it-1 is consumed
    if (it + STAGES - 1 < n_live)
      load_q((it + STAGES - 1) % STAGES, it + STAGES - 1);
    tc::cp_async_commit();
    const int stage = it % STAGES;
    const uint32_t qS = sQ + stage * TILE, oS = sO + stage * TILE;
    const float* rt = rows + stage * NROW * BM;
    const int gi = it / nqt;
    const int q0 = (qt_lo + it - gi * nqt) * BM, qn = min(BM, g.Sq - q0);

    // S^T = K Q^T and dP^T = V dO^T (16 x 64 per warp)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t f[4];
        tc::ldmatrix_x4(f, tc::b_frag_addr<D>(qS, 8 * n, 2 * c, lane));
        tc::mma_bf16(s[n], kf[c], f[0], f[1]);
        tc::mma_bf16(s[n + 1], kf[c], f[2], f[3]);
        tc::ldmatrix_x4(f, tc::b_frag_addr<D>(oS, 8 * n, 2 * c, lane));
        tc::mma_bf16(dp[n], vf[c], f[0], f[1]);
        tc::mma_bf16(dp[n + 1], vf[c], f[2], f[3]);
      }

    if (k_whole && qn == BM &&
        tile_full(g, g.qo + q0, g.qo + q0 + BM - 1, k_lo, k_hi))
      p_ds_step<false>(s, dp, rt, g, q0, kj0, tq, sl2);
    else
      p_ds_step<true>(s, dp, rt, g, q0, kj0, tq, sl2);

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
    // registers (q chunk c: columns 16 c .. 16 c + 15)
#pragma unroll
    for (int c = 0; c < BM / 16; ++c) {
      uint32_t pa[4], da[4];
      tc::c_pair_to_a(pa, s[2 * c], s[2 * c + 1]);
      tc::c_pair_to_a(da, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t f[4];
        tc::ldmatrix_x4_trans(f, tc::bt_frag_addr<D>(oS, 16 * c, j, lane));
        tc::mma_bf16(gv[j], pa, f[0], f[1]);
        tc::mma_bf16(gv[j + 1], pa, f[2], f[3]);
        tc::ldmatrix_x4_trans(f, tc::bt_frag_addr<D>(qS, 16 * c, j, lane));
        tc::mma_bf16(gk[j], da, f[0], f[1]);
        tc::mma_bf16(gk[j + 1], da, f[2], f[3]);
      }
    }
  }

  // epilogue: dK and dV to bf16, staged in the warp's own 16 rows of the
  // K and V tiles (only this warp read them; every copy has landed: the
  // groups after the last tile are empty), then 16-byte row stores
  tc::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + gr + 8 * i;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const uint32_t off = tc::swz<D>(row, j) + 4 * tq;
      *reinterpret_cast<uint32_t*>(smem + off) =
          tc::pack_bf16(gk[j][2 * i], gk[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(smem + TILE + off) =
          tc::pack_bf16(gv[j][2 * i], gv[j][2 * i + 1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16 * ND / 32; ++j) {
    const int row = wr + (lane + 32 * j) / ND, c = (lane + 32 * j) % ND;
    if (row < kn) {
      const long long r = k0 + row;
      *reinterpret_cast<uint4*>(dkb + r * dks.s + c * 8) =
          *reinterpret_cast<const uint4*>(smem + tc::swz<D>(row, c));
      *reinterpret_cast<uint4*>(dvb + r * dvs.s + c * 8) =
          *reinterpret_cast<const uint4*>(smem + TILE + tc::swz<D>(row, c));
    }
  }
}

bool geo_ok(const Geo& g) {
  return g.B > 0 && g.Hq > 0 && g.Hkv > 0 && g.Hq % g.Hkv == 0 &&
         g.Sq > 0 && g.Sk > 0 && g.D == 64 &&
         g.window >= 0 && g.Hkv <= 65535 && g.B <= 65535;
}

template <int D>
cudaError_t launch(const Geo& g, const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* delta,
                   const float* dlse, void* dk, void* dv, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 + 2 * STAGES) * BM * D * sizeof(bf16) +
                      (size_t)STAGES * NROW * BM * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Sk + BN - 1) / BN, g.Hkv, g.B);
  flash_dkv_tc_kernel<D><<<grid, NT, smem, stream>>>(
      g, (const bf16*)q, str_at(st, 0), (const bf16*)k, str_at(st, 1),
      (const bf16*)v, str_at(st, 2), (const bf16*)dO, str_at(st, 3), lse,
      delta, dlse, (bf16*)dk, str_at(st, 4), (bf16*)dv, str_at(st, 5));
  return cudaGetLastError();
}

}  // namespace

// C entry point (ctypes), with mxtt_flash_dkv's signature.  dtype must be
// 1 (bfloat16).  dims: B, Hq, Hkv, Sq, Sk, D.  strides: 3 per tensor
// (batch, head, sequence) for q, k, v, dO, dk, dv.  lse, delta, dlse:
// float32 (B, Hq, Sq) contiguous.  Returns the cudaError_t.
extern "C" int mxtt_flash_dkv_tc(int dtype, const void* q, const void* k,
                                 const void* v, const void* dO,
                                 const void* lse, const void* delta,
                                 const void* dlse, void* dk, void* dv,
                                 const int* dims, const long long* strides,
                                 int causal, int window, int q_offset,
                                 int k_offset, float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  if (dtype != 1 || !geo_ok(g) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dO) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 18; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* de = (const float*)delta;
  const float* dl = (const float*)dlse;
  return (int)launch<64>(g, q, k, v, dO, l, de, dl, dk, dv, strides, s);
}
