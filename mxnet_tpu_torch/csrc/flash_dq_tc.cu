// Flash-attention dQ for Hopper (sm_90a) on bf16 tensor cores.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py _bwd (:550) ->
// _bwd_dq_kernel (:451) for bfloat16 inputs: with P recomputed from the
// forward's lse, p = exp(s scale - lse) and ds = p (dp - delta + dlse)
// scale, it computes dQ = sum dS K over the live k tiles of a q tile, with
// _mask_for's causal / window / offset rules, _tile_live's tile skip and
// p = 0 on masked scores (fully-masked q rows, lse = -1e30, get dq = 0).
// ds is rounded to bf16 where the TPU kernel casts ds.astype(k.dtype)
// (:489); p is never rounded (that kernel never casts it); every sum is
// float32.  float32, and bf16 geometries outside the limits below, run
// flash_dq_kernel in flash_attention.cu.
//
// What bounds it.  At the training shape (B 16, H 8, S 1024, D 64,
// causal) the kept (q, k) pairs need 25.8 GFLOP (6 D a pair: S, dP and
// dQ), 0.0261 ms at the bf16 tensor-core peak of 989 TFLOP/s; q, dO, k, v
// and dq are 16.8 MB each and the three row terms 0.5 MB each, 0.0255 ms
// at 3.35 TB/s.  The products set the bound, the bytes close behind.
//
// What the design does about it.
//   - All three products run on the tensor cores: mma.sync m16n8k16 bf16
//     with float32 accumulators (tc_tile.cuh).  One CTA of 4 warps owns 64
//     q rows of one (q head, batch), as the forward does; each warp owns 16
//     rows and keeps its dQ accumulator (16 x D) in registers.  At D 64 it
//     also keeps its Q and dO A fragments (ldmatrix once); at D 128 those
//     would double the registers, so it re-reads them from the shared Q
//     and dO tiles each k tile.
//   - K/V tiles of 64 rows stream through a 2-stage cp.async ring in
//     swizzled shared memory: tile j+1 is in flight while tile j is
//     multiplied; one __syncthreads a tile.  Rows past Sk are zero-filled
//     and never read.  GQA: q head h reads kv head h / group; nothing is
//     summed across heads, so there are no atomics and dq is bitwise the
//     same from run to run.
//   - S = Q K^T and dP = dO V^T read K and V ([key][d]) as mma's "col" B
//     operand by plain ldmatrix.  dS (C fragments) is rounded to bf16 and
//     repacked straight into the A fragments of dQ += dS K, whose B operand
//     is the same K tile read through ldmatrix.trans.  P and dS never touch
//     shared memory.
//   - The row terms index the C fragment's rows: each thread reads lse,
//     delta and dlse of its two rows once, into registers.
//   - The per-element mask test runs only on tiles that straddle the
//     causal diagonal, a window edge, Sq or Sk (ds_step<true>).  A
//     zero-filled K row past Sk would give s = 0 and p = exp(-lse) != 0:
//     the test kj < Sk masks it.  exp is one ex2.approx with log2(e)
//     folded into the score scale and the lse.
//   - Heaviest causal q tiles start first; dq leaves through shared memory
//     (the warp's own rows of the Q tile) as 16-byte row stores, through
//     the strides the tensor comes with (bhsd, bshd, dq made by
//     empty_like of a fused-QKV view).
//
// Limits: bfloat16; head_dim 64 or 128; q, k, v, dO and dq 16-byte
// aligned; every batch, head and sequence stride a multiple of 8
// elements; the last dimension contiguous.  A launch outside them returns
// cudaErrorInvalidValue without running.  Geo, Str, keep, tile_live and
// tile_full repeat flash_fwd_tc.cu's, which this unit does not link
// against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;            // q rows per CTA, 16 per warp
constexpr int BN = 64;            // k rows per tile
constexpr int NT = 32 * BM / 16;  // 4 warps
constexpr int NS = BN / 8;        // n-tiles of a score block (8 keys each)
constexpr int STAGES = 2;         // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

struct Geo {
  int B, Hq, Hkv, Sq, Sk, D, group;
  int causal, window, qo, ko;
  float scale;
};

// element strides of a 4-D tensor: batch, head, sequence (last dim is 1)
struct Str {
  long long b, h, s;
};

// _mask_for: keep score (q row qi, k row kj) of global positions
// qo + qi and ko + kj
__device__ __forceinline__ bool keep(const Geo& g, int qi, int kj) {
  const int qp = g.qo + qi, kp = g.ko + kj;
  if (g.causal) {
    if (qp < kp) return false;
    return !g.window || qp - kp < g.window;
  }
  if (g.window) return qp - kp < g.window && kp - qp < g.window;
  return true;
}

// _tile_live: the tile of q positions [q_lo, q_hi] x k positions
// [k_lo, k_hi] holds at least one kept score
__device__ __forceinline__ bool tile_live(const Geo& g, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  bool live = true;
  if (g.causal) live = live && q_hi >= k_lo;
  if (g.window) {
    live = live && q_lo - k_hi < g.window;
    if (!g.causal) live = live && k_lo - q_hi < g.window;
  }
  return live;
}

// every score of the tile is kept: the per-element test can be skipped
__device__ __forceinline__ bool tile_full(const Geo& g, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  if (g.causal) return q_lo >= k_hi && (!g.window || q_hi - k_lo < g.window);
  if (g.window) return q_hi - k_lo < g.window && k_hi - q_lo < g.window;
  return true;
}

// 2^x in one MUFU op; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dS of one k tile for a warp's 16 rows.  s holds the raw Q K^T block and
// dp the dO V^T block on entry; on exit dp holds ds (float32).  C element
// (n, e) is q row qi0 + 8 (e >> 1) and key k0 + 8 n + 2 tq + (e & 1); l2
// (lse in base-2 units), dd (delta) and dl (dlse) hold the terms of the
// thread's two rows.  MASK: the tile straddles the band, Sq or Sk, so each
// score is tested; masked scores give p = 0 (and ds = 0) by the mask,
// never by the value.
template <bool MASK>
__device__ __forceinline__ void ds_step(const float (&s)[NS][4],
                                        float (&dp)[NS][4],
                                        const float (&l2)[2],
                                        const float (&dd)[2],
                                        const float (&dl)[2], const Geo& g,
                                        int qi0, int k0, int tq, float sl2) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      bool in = true;
      if (MASK) {
        const int qi = qi0 + 8 * r, kj = k0 + 8 * n + 2 * tq + (e & 1);
        in = qi < g.Sq && kj < g.Sk && keep(g, qi, kj);
      }
      const float p = in ? exp2_ftz(fmaf(s[n][e], sl2, -l2[r])) : 0.f;
      dp[n][e] = p * (dp[n][e] - dd[r] + dl[r]) * g.scale;
    }
}

// one CTA per (64-row q tile, q head, batch)
template <int D>
__global__ void __launch_bounds__(NT)
    flash_dq_tc_kernel(Geo g, const bf16* __restrict__ q, Str qs,
                       const bf16* __restrict__ k, Str ks,
                       const bf16* __restrict__ v, Str vs,
                       const bf16* __restrict__ dO, Str dos,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ dlse,
                       bf16* __restrict__ dq, Str dqs) {
  constexpr int KC = D / 16;        // 16-wide d chunks of Q K^T, dO V^T
  constexpr int ND = D / 8;         // n-tiles of dQ = 16-byte chunks of a row
  constexpr int TILE = BN * D * 2;  // bytes of one Q, dO, K or V tile
  constexpr bool HOLD = D == 64;    // Q and dO fragments kept in registers
  static_assert(BM == BN, "one tile size for Q, dO, K and V");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = tc::smem_addr(smem);  // then dq's staging
  const uint32_t sO = sQ + TILE;            // the dO tile
  const uint32_t sK = sO + TILE;            // STAGES tiles
  const uint32_t sV = sK + STAGES * TILE;   // STAGES tiles

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.group;
  const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // C row g and column pair t
  const int wr = warp * 16;                 // the warp's first tile row
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  bf16* dqb = dq + b * dqs.b + h * dqs.h;

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
  if (kt_hi < 0) {  // no row of the tile sees a key: dq = 0
    for (int i = threadIdx.x; i < qn * ND; i += NT)
      *reinterpret_cast<uint4*>(dqb + (long long)(q0 + i / ND) * dqs.s +
                                (i % ND) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  auto load_kv = [&](int stage, int kt) {
    const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
    tc::load_tile_async<BN, D, NT>(sK + stage * TILE, kb, ks.s, k0, kn);
    tc::load_tile_async<BN, D, NT>(sV + stage * TILE, vb, vs.s, k0, kn);
  };
  // groups: Q and dO, then one per K/V tile (empty past the last live one)
  tc::load_tile_async<BM, D, NT>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, qn);
  tc::load_tile_async<BM, D, NT>(sO, dO + b * dos.b + h * dos.h, dos.s, q0,
                                 qn);
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (kt_lo + st <= kt_hi) load_kv(st, kt_lo + st);
    tc::cp_async_commit();
  }

  // the row terms of this thread's rows qi0 and qi0 + 8 (0 past Sq: those
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

  tc::cp_async_wait<STAGES - 1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qf[KC][4], of[KC][4];  // unused (and dropped) at D 128
  if constexpr (HOLD) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      tc::ldmatrix_x4(qf[c], tc::a_frag_addr<D>(sQ, wr, 2 * c, lane));
      tc::ldmatrix_x4(of[c], tc::a_frag_addr<D>(sO, wr, 2 * c, lane));
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float sl2 = g.scale * LOG2E;
  const bool q_whole = qn == BM;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int it = kt - kt_lo;
    tc::cp_async_wait<STAGES - 2>();  // tile kt has landed ...
    __syncthreads();  // ... for every thread, and tile kt-1 is consumed
    if (kt + STAGES - 1 <= kt_hi)
      load_kv((it + STAGES - 1) % STAGES, kt + STAGES - 1);
    tc::cp_async_commit();
    const uint32_t kS = sK + (it % STAGES) * TILE;
    const uint32_t vS = sV + (it % STAGES) * TILE;

    // S = Q K^T and dP = dO V^T (16 x 64 per warp)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t qc[4], oc[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qc[e] = qf[c][e];
          oc[e] = of[c][e];
        }
      } else {
        tc::ldmatrix_x4(qc, tc::a_frag_addr<D>(sQ, wr, 2 * c, lane));
        tc::ldmatrix_x4(oc, tc::a_frag_addr<D>(sO, wr, 2 * c, lane));
      }
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t f[4];
        tc::ldmatrix_x4(f, tc::b_frag_addr<D>(kS, 8 * n, 2 * c, lane));
        tc::mma_bf16(s[n], qc, f[0], f[1]);
        tc::mma_bf16(s[n + 1], qc, f[2], f[3]);
        tc::ldmatrix_x4(f, tc::b_frag_addr<D>(vS, 8 * n, 2 * c, lane));
        tc::mma_bf16(dp[n], oc, f[0], f[1]);
        tc::mma_bf16(dp[n + 1], oc, f[2], f[3]);
      }
    }

    const int k0 = kt * BN;
    if (q_whole && g.Sk - k0 >= BN &&
        tile_full(g, q_lo, q_hi, g.ko + k0, g.ko + k0 + BN - 1))
      ds_step<false>(s, dp, l2, dd, dl, g, qi0, k0, tq, sl2);
    else
      ds_step<true>(s, dp, l2, dd, dl, g, qi0, k0, tq, sl2);

    // dQ += dS K, dS rounded to bf16 in registers (key chunk c: columns
    // 16 c .. 16 c + 15)
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      uint32_t a[4];
      tc::c_pair_to_a(a, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t f[4];
        tc::ldmatrix_x4_trans(f, tc::bt_frag_addr<D>(kS, 16 * c, j, lane));
        tc::mma_bf16(acc[j], a, f[0], f[1]);
        tc::mma_bf16(acc[j + 1], a, f[2], f[3]);
      }
    }
  }

  // epilogue: dQ to bf16, staged in the warp's own 16 rows of the Q tile
  // (only this warp read them; every copy has landed: the groups after
  // the last live tile are empty), then 16-byte row stores
  tc::cp_async_wait<0>();
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + gr + 8 * i;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(smem + tc::swz<D>(row, j) + 4 * tq) =
          tc::pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16 * ND / 32; ++j) {
    const int row = wr + (lane + 32 * j) / ND, c = (lane + 32 * j) % ND;
    if (row < qn)
      *reinterpret_cast<uint4*>(dqb + (long long)(q0 + row) * dqs.s + c * 8) =
          *reinterpret_cast<const uint4*>(smem + tc::swz<D>(row, c));
  }
}

Geo make_geo(const int* dims, int causal, int window, int qo, int ko,
             float scale) {
  Geo g;
  g.B = dims[0];
  g.Hq = dims[1];
  g.Hkv = dims[2];
  g.Sq = dims[3];
  g.Sk = dims[4];
  g.D = dims[5];
  g.group = g.Hkv > 0 ? g.Hq / g.Hkv : 0;
  g.causal = causal;
  g.window = window;
  g.qo = qo;
  g.ko = ko;
  g.scale = scale;
  return g;
}

bool geo_ok(const Geo& g) {
  return g.B > 0 && g.Hq > 0 && g.Hkv > 0 && g.Hq % g.Hkv == 0 &&
         g.Sq > 0 && g.Sk > 0 && (g.D == 64 || g.D == 128) &&
         g.window >= 0 && g.Hq <= 65535 && g.B <= 65535;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

Str str_at(const long long* s, int i) {
  Str r;
  r.b = s[3 * i];
  r.h = s[3 * i + 1];
  r.s = s[3 * i + 2];
  return r;
}

template <int D>
cudaError_t launch(const Geo& g, const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* delta,
                   const float* dlse, void* dq, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BM + 2 * STAGES * BN) * D * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Sq + BM - 1) / BM, g.Hq, g.B);
  flash_dq_tc_kernel<D><<<grid, NT, smem, stream>>>(
      g, (const bf16*)q, str_at(st, 0), (const bf16*)k, str_at(st, 1),
      (const bf16*)v, str_at(st, 2), (const bf16*)dO, str_at(st, 3), lse,
      delta, dlse, (bf16*)dq, str_at(st, 4));
  return cudaGetLastError();
}

}  // namespace

// C entry point (ctypes), with mxtt_flash_dq's signature.  dtype must be
// 1 (bfloat16).  dims: B, Hq, Hkv, Sq, Sk, D.  strides: 3 per tensor
// (batch, head, sequence) for q, k, v, dO, dq.  lse, delta, dlse: float32
// (B, Hq, Sq) contiguous.  Returns the cudaError_t.
extern "C" int mxtt_flash_dq_tc(int dtype, const void* q, const void* k,
                                const void* v, const void* dO,
                                const void* lse, const void* delta,
                                const void* dlse, void* dq, const int* dims,
                                const long long* strides, int causal,
                                int window, int q_offset, int k_offset,
                                float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  if (dtype != 1 || !geo_ok(g) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dO) || !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 15; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* de = (const float*)delta;
  const float* dl = (const float*)dlse;
  if (g.D == 64)
    return (int)launch<64>(g, q, k, v, dO, l, de, dl, dq, strides, s);
  return (int)launch<128>(g, q, k, v, dO, l, de, dl, dq, strides, s);
}
