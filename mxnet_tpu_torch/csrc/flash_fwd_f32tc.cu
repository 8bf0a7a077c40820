// Flash-attention forward for Hopper (sm_90a) in float32, on tensor cores
// through split-TF32 products.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py _fwd (:406) ->
// _fwd_kernel (:283, call :420) for float32 inputs: o = softmax(Q K^T
// scale) V and the float32 per-row lse = m + log(l), with _mask_for's
// causal / window / offset rules, _tile_live's tile skip, and o = 0,
// lse = -1e30 on fully-masked rows (never NaN).  q head h reads kv head
// h / group.  Nothing is rounded to a narrower type: the inputs are
// float32, and every sum is float32.  bfloat16 runs flash_fwd_tc.cu;
// float32 outside the limits below runs flash_fwd_kernel in
// flash_attention.cu.
//
// What bounds it.  At the training shape (B 16, H 8, S 1024, D 64,
// causal) the kept (q, k) pairs need 17.2 GFLOP (4 D a pair: S, then
// P V).  Each product here is three TF32 products (tf32x3.cuh), so the
// tensor cores do 51.6 GFLOP: 0.104 ms at the dense TF32 peak of 495
// TFLOP/s.  q, k, v and o are 33.5 MB each and lse 0.5 MB: 0.040 ms at
// 3.35 TB/s.  The products set the bound.  (As float32 FMAs the same
// work takes 0.257 ms at 67 TFLOP/s.)
//
// What the design does about it.
//   - Both products run on the tensor cores: mma.sync m16n8k8 tf32, each
//     float32 operand split into big + small TF32 halves in registers,
//     three products a block (tf32x3.cuh).  The result is held to the
//     float32 bound the float32-FMA kernel meets; one TF32 product of
//     rounded operands is not (chip_smoke.py's planted one-product model
//     fails it).
//   - One CTA of 4 warps owns 64 q rows of one (q head, batch); each warp
//     owns 16 q rows.  S = Q K^T puts q on the rows, so the scores come
//     out as C fragments (rows g and g + 8 of the warp's 16 for each
//     lane) and P's C fragments are the A operand of O += P V through
//     tf32x3::c_to_a, with V's B fragments read by rows of k
//     (tf32x3::load_b_kn, the same slot permutation).  The scores never
//     go to shared memory, and no __syncthreads separates the products.
//   - The online softmax runs on the C fragments in registers: a row's
//     max is reduced over the 4 lanes of its group (__shfl_xor_sync 1,
//     2), its sum is kept per lane and reduced once, in the epilogue.
//     exp is one ex2.approx with log2(e) folded into the score scale; the
//     lse returns to the natural log at the end.  A masked score is set
//     to -inf before the max, so its p is exactly 0, and every p of a
//     row with no kept score so far is 0 (its max stays at -1e30).
//   - Trouble 1, registers: Q's split A fragments (8 d chunks x 4 x 2 =
//     64 registers a lane) are split once and kept in registers for the
//     whole k loop, beside O (32), S (32) and one tile's P V partial (32).
//     ptxas gives 253 registers a thread, no spill; re-reading and
//     splitting Q from shared memory every k tile instead gave 213, also
//     2 CTAs an SM, and was not timed.  K's and V's B fragments are
//     re-read from shared memory and split every k tile.
//   - Trouble 2, the tensor core's float32 accumulation truncates
//     (flash_dkv_f32tc.cu's trouble 5).  S is summed from zero each k
//     tile (8 chunks x 3 products).  P V is summed from zero each k tile
//     too, then O = alpha O + partial by a float32 fma, rather than
//     chaining every tile's products into O.
//   - Trouble 3, bank conflicts: every tile's rows are padded to D + 4
//     floats (tf32x3.cuh), so each fragment read falls on 32 distinct
//     banks.
//   - Trouble 4, no wgmma: S = Q K^T could take Hopper's tf32 wgmma
//     (both operands K-major), but P V's B operand (V by rows of k) is
//     MN-major, which tf32 wgmma does not take; so both stay on mma.sync.
//   - K and V stream through a 2-stage cp.async ring of 16-byte copies;
//     Q is loaded once.  Rows past Sq and Sk are zero-filled; the test
//     qi < Sq, kj < Sk masks them.  The per-element mask test runs only
//     on a warp's tiles that straddle the causal diagonal, a window edge,
//     Sq or Sk (tile_full clears the rest).
//   - The heaviest causal q tiles start first across every (q head,
//     batch): the grid's x runs over (q head, batch), its y over q tiles
//     from the last.  o leaves as 8-byte row stores from the
//     accumulators, lse as one store a row, through the strides the
//     tensors come with (bhsd, bshd, GQA, fused-QKV views).
//   - Two CTAs an SM: 87,040 bytes of shared memory each (Q and two
//     stages of K and V, rows of 68 floats).
//
// Limits: float32; head_dim 64; q, k, v and o 16-byte aligned; every
// batch, head and sequence stride a multiple of 4 elements; the last
// dimension contiguous.  A launch outside them returns
// cudaErrorInvalidValue without running.  Geo, Str and the mask rules
// come from flash_geo.cuh.

#include <cuda_runtime.h>
#include <math.h>
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
constexpr int NS = BN / 8;        // n-tiles of S (8 keys); k chunks of P V
constexpr int ND = D / 8;         // k chunks of S; n-tiles of O
constexpr int STAGES = 2;         // K/V ring depth
constexpr int TILE = BM * LD;     // floats of one Q, K or V tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;     // the reference's fully-masked sentinel
static_assert(BM == BN, "one tile size for Q, K and V");
static_assert(LD % 32 == 4, "fragment reads on 32 distinct banks");

using namespace flash;

// The online softmax of one k tile for a warp's 16 q rows.  s holds the
// raw Q K^T block on entry and p on exit: C element (n, e) is q row
// qi0 + 8 (e >> 1) and key kj0 + 8 n + (e & 1).  m2 is each of the
// lane's two rows' running max of s scale log2(e) (-1e30 before any kept
// score), l the lane's share of its running sum of p; alpha receives the
// factor by which the row's earlier p (in l and O) are rescaled.  MASK:
// the tile straddles the band, Sq or Sk, so each score is tested.
template <bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4],
                                             float (&m2)[2], float (&l)[2],
                                             float (&alpha)[2], const Geo& g,
                                             int qi0, int kj0, float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int qi = qi0 + 8 * (e >> 1), kj = kj0 + 8 * n + (e & 1);
        if (!(qi < g.Sq && kj < g.Sk && keep(g, qi, kj))) s[n][e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m2[i], mx[i] * sl2);
    alpha[i] = exp2_ftz(m2[i] - m_new);
    m2[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked score (-inf) gives exp2(-inf) = 0
      const float p = exp2_ftz(fmaf(s[n][e], sl2, -m2[e >> 1]));
      s[n][e] = p;
      l[e >> 1] += p;
    }
}

// one CTA per (q head and batch, 64-row q tile)
__global__ void __launch_bounds__(NT)
    flash_fwd_f32tc_kernel(Geo g, const float* __restrict__ q, Str qs,
                           const float* __restrict__ k, Str ks,
                           const float* __restrict__ v, Str vs,
                           float* __restrict__ o, Str os,
                           float* __restrict__ lse) {
  extern __shared__ __align__(128) float smem[];
  float* sQ = smem;
  float* sK = sQ + TILE;            // STAGES tiles
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
  float* ob = o + b * os.b + h * os.h;
  float* lrow = lse + ((long long)b * g.Hq + h) * g.Sq + q0;

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
  if (n_live <= 0) {  // no key is seen by these rows: o = 0, lse = -1e30
    for (int i = threadIdx.x; i < qn * (D / 4); i += NT) {
      const long long r = q0 + i / (D / 4);
      *reinterpret_cast<float4*>(ob + r * os.s + (i % (D / 4)) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r = threadIdx.x; r < qn; r += NT) lrow[r] = NEG;
    return;
  }

  auto load_kv = [&](int stage, int it) {
    const int k0 = (kt_lo + it) * BN, kn = min(BN, g.Sk - k0);
    tf32x3::load_tile<BN, D, LD, NT>(tc::smem_addr(sK + stage * TILE), kb,
                                     ks.s, k0, kn);
    tf32x3::load_tile<BN, D, LD, NT>(tc::smem_addr(sV + stage * TILE), vb,
                                     vs.s, k0, kn);
  };
  // groups: Q, then one per K/V tile (empty past the last one)
  tf32x3::load_tile<BM, D, LD, NT>(tc::smem_addr(sQ), q + b * qs.b + h * qs.h,
                                   qs.s, q0, qn);
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_live) load_kv(st, st);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<STAGES - 1>();  // Q landed ...
  __syncthreads();                  // ... for every thread
  tf32x3::Frag<4> qf[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c)
    qf[c] = tf32x3::load_a<LD>(sQ, wr, 8 * c, gr, tq);

  float acc[ND][4];
#pragma unroll
  for (int m = 0; m < ND; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  float m2[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const float sl2 = g.scale * LOG2E;
  const int qi0 = q0 + wr + gr, kj0 = 2 * tq;
  // the warp's 16 rows: the mask test can be skipped on a tile only if
  // they all lie below Sq
  const bool q_whole = q0 + wr + 16 <= g.Sq;
  const int wq_lo = g.qo + q0 + wr;

  for (int it = 0; it < n_live; ++it) {
    tc::cp_async_wait<STAGES - 2>();  // tile it landed ...
    __syncthreads();  // ... for every thread, and tile it-1 is consumed
    if (it + STAGES - 1 < n_live)
      load_kv((it + STAGES - 1) % STAGES, it + STAGES - 1);
    tc::cp_async_commit();
    const int stage = it % STAGES;
    const float* kS = sK + stage * TILE;
    const float* vS = sV + stage * TILE;
    const int k0 = (kt_lo + it) * BN, kn = min(BN, g.Sk - k0);

    // S = Q K^T (16 x 64 per warp), d chunks of 8, summed from zero
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        tf32x3::mma3(s[n], qf[c],
                     tf32x3::load_b_nk<LD>(kS, 8 * n, 8 * c, gr, tq));

    float alpha[2];
    if (q_whole && kn == BN &&
        tile_full(g, wq_lo, wq_lo + 15, g.ko + k0, g.ko + k0 + BN - 1))
      softmax_step<false>(s, m2, l, alpha, g, qi0, k0 + kj0, sl2);
    else
      softmax_step<true>(s, m2, l, alpha, g, qi0, k0 + kj0, sl2);

    // O = alpha O + P V: this tile's P V summed from zero on the tensor
    // cores (key chunk j = S's n-tile j), then added by float32 fmas: the
    // tensor core's accumulation truncates
    float part[ND][4];
#pragma unroll
    for (int m = 0; m < ND; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const tf32x3::Frag<4> a = tf32x3::c_to_a(s[j]);
#pragma unroll
      for (int m = 0; m < ND; ++m)
        tf32x3::mma3(part[m], a,
                     tf32x3::load_b_kn<LD>(vS, 8 * j, 8 * m, gr, tq));
    }
#pragma unroll
    for (int m = 0; m < ND; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[m][e] = fmaf(acc[m][e], alpha[e >> 1], part[m][e]);
  }
  tc::cp_async_wait<0>();  // the groups after the last tile are empty

  // epilogue: C element (m, e) is q row wr + g + 8 (e >> 1), d column
  // 8 m + 2 t + (e & 1); a row's sum is its 4 lanes' shares
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = wr + gr + 8 * i;
    if (row >= qn) continue;
    const bool valid = lt > 0.f;  // false only for fully-masked rows
    const long long r = q0 + row;
#pragma unroll
    for (int m = 0; m < ND; ++m)
      *reinterpret_cast<float2*>(ob + r * os.s + 8 * m + 2 * tq) =
          valid ? make_float2(acc[m][2 * i] / lt, acc[m][2 * i + 1] / lt)
                : make_float2(0.f, 0.f);
    if (tq == 0) lrow[row] = valid ? (m2[i] + log2f(lt)) * LN2 : NEG;
  }
}

}  // namespace

// C entry point (ctypes), with mxtt_flash_fwd's signature.  dtype must be
// 0 (float32).  dims: B, Hq, Hkv, Sq, Sk, D.  strides: 3 per tensor
// (batch, head, sequence) for q, k, v, o.  lse: float32 (B, Hq, Sq)
// contiguous.  Returns the cudaError_t.
extern "C" int mxtt_flash_fwd_f32tc(int dtype, const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    const int* dims, const long long* strides,
                                    int causal, int window, int q_offset,
                                    int k_offset, float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  const bool geo_ok = g.B > 0 && g.Hq > 0 && g.Hkv > 0 && g.Hq % g.Hkv == 0 &&
                      g.Sq > 0 && g.Sk > 0 && g.D == D && g.window >= 0 &&
                      (long long)g.B * g.Hq <= 0x7fffffff &&
                      (g.Sq + BM - 1) / BM <= 65535;
  if (dtype != 0 || !geo_ok || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(1 + 2 * STAGES) * TILE * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.B * g.Hq, (g.Sq + BM - 1) / BM);
  flash_fwd_f32tc_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      g, (const float*)q, str_at(strides, 0), (const float*)k,
      str_at(strides, 1), (const float*)v, str_at(strides, 2), (float*)o,
      str_at(strides, 3), (float*)lse);
  return (int)cudaGetLastError();
}
