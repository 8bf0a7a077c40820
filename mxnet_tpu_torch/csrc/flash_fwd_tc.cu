// Flash-attention forward for Hopper (sm_90a) on bf16 tensor cores.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py _fwd (:406) /
// _fwd_kernel (:283) for bfloat16 inputs: o = softmax(Q K^T scale) V and
// the per-row log-sum-exp, with _mask_for's causal / window / offset
// rules, _tile_live's tile skip and the -1e30 sentinel (fully-masked rows
// give o = 0 and lse = -1e30, never NaN).  float32, and bf16 geometries
// outside the limits below, run flash_fwd_kernel in flash_attention.cu.
//
// What bounds it.  At the training shape (B 16, H 8, S 1024, D 64,
// causal) q, k, v and o are 16.8 MB each and lse 0.5 MB: 67.6 MB at
// 3.35 TB/s is 0.0202 ms.  The kept (q, k) pairs need 17.2 GFLOP (4 D a
// pair), 0.0174 ms at the bf16 tensor-core peak of 989 TFLOP/s.  The two
// are close: the kernel must keep the tensor cores fed and read each
// tensor about once.
//
// What the design does about it.
//   - Both products run on the tensor cores: mma.sync m16n8k16 bf16 with
//     float32 accumulators (tc_tile.cuh).  One CTA of 4 warps owns 64 q
//     rows of one (q head, batch); each warp owns 16 rows, keeps its Q
//     fragments in registers (ldmatrix once) and its O accumulator and
//     softmax state in registers, so scores never touch shared memory.
//   - K/V tiles of 64 rows stream through a 2-stage cp.async ring in
//     swizzled shared memory: tile j+1 is in flight while tile j is
//     multiplied; one __syncthreads a tile.  Rows past Sk are zero-filled
//     and never read.
//   - S = Q K^T: K stored [key][d] is mma's "col" B operand, read by plain
//     ldmatrix.  P is rounded to bf16 where the TPU kernel casts
//     p.astype(v.dtype) (:321-322) and repacked from the C fragments
//     straight into A fragments; V enters through ldmatrix.trans.
//   - The per-element mask test runs only on tiles that straddle the
//     causal diagonal, a window edge or Sk (softmax_step<true>); tiles
//     wholly inside the band take softmax_step<false>, which has no test.
//     Masked scores give p = 0 by the mask, never by the value, so a row
//     with nothing kept yet stays at l = 0.  l sums the unrounded float32
//     p, as _fwd_kernel:316 does.
//   - exp2 (one ex2.approx) with log2(e) folded into the score scale; m is
//     kept in that base-2 unit and turned back (times ln 2) for lse.
//   - Heaviest causal q tiles start first; o leaves through shared memory
//     as 16-byte row stores, through the strides the tensors come with
//     (bhsd, bshd, GQA h / group, fused-QKV views).
//
// Limits: bfloat16; head_dim 64 or 128; q, k, v and o 16-byte aligned;
// every batch, head and sequence stride a multiple of 8 elements; the last
// dimension contiguous.  A launch outside them returns
// cudaErrorInvalidValue without running.  Geo, Str, keep and tile_live
// repeat flash_attention.cu's, which this unit does not link against.

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
constexpr float NEG = -1e30f;     // the TPU kernel's _NEG_INF
constexpr float TINY = 1e-30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// 2^x in one MUFU op; results below 2^-126 flush to 0 (a p that small
// is below float32's resolution of l >= 1 anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One k tile's online-softmax step for a warp's 16 rows.  s holds the
// raw Q K^T block on entry and p on exit; m_r (base-2 units) and l_r (this
// thread's share of the row sum) of the thread's two rows are updated and
// alpha receives the factor that rescales the O accumulator.  MASK: the
// tile straddles the band or Sk, so each score is tested (qi0: the
// thread's first row, k0: the tile's first key); masked scores give p = 0
// by the mask, even when the whole row is masked and m is still NEG.
template <bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4],
                                             float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&alpha)[2], const Geo& g,
                                             int qi0, int k0, int tq,
                                             float sl2) {
  uint32_t kept = 0xffffffffu;  // bit 4n + e: s[n][e] is kept
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * sl2;
      if (MASK) {
        const int kj = k0 + 8 * n + 2 * tq + (e & 1);
        if (!(kj < g.Sk && keep(g, qi0 + 8 * (e >> 1), kj))) {
          kept &= ~(1u << (4 * n + e));
          x = NEG;
        }
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = tc::quad_max(mx[i]);
    alpha[i] = exp2_ftz(m_r[i] - mx[i]);
    m_r[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (!MASK || ((kept >> (4 * n + e)) & 1u))
                          ? exp2_ftz(s[n][e] - m_r[e >> 1])
                          : 0.f;
      s[n][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rs[i];
}

// one CTA per (64-row q tile, q head, batch)
template <int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_tc_kernel(Geo g, const bf16* __restrict__ q, Str qs,
                        const bf16* __restrict__ k, Str ks,
                        const bf16* __restrict__ v, Str vs,
                        bf16* __restrict__ o, Str os,
                        float* __restrict__ lse) {
  constexpr int KC = D / 16;        // 16-wide d chunks of Q K^T
  constexpr int NO = D / 8;         // n-tiles of O = 16-byte chunks of a row
  constexpr int TILE = BN * D * 2;  // bytes of one K or V tile
  static_assert(NS * 4 == 32, "one bit of `kept` per score of a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = tc::smem_addr(smem);  // BM x D, then o's staging
  const uint32_t sK = sQ + BM * D * 2;      // STAGES tiles
  const uint32_t sV = sK + STAGES * TILE;   // STAGES tiles

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.group;
  const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // C row g and column pair t
  const int wr = warp * 16;                 // the warp's first tile row
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

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
  // o and lse rows of the tile are formed where they are written, so that
  // they hold no registers through the k loop
  if (kt_hi < 0) {  // every row of the tile fully masked
    bf16* ob = o + b * os.b + h * os.h;
    float* lrow = lse + ((long long)b * g.Hq + h) * g.Sq + q0;
    for (int i = threadIdx.x; i < qn * NO; i += NT)
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + i / NO) * os.s +
                                (i % NO) * 8) = make_uint4(0, 0, 0, 0);
    for (int r = threadIdx.x; r < qn; r += NT) lrow[r] = NEG;
    return;
  }

  auto load_kv = [&](int stage, int kt) {
    const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
    tc::load_tile_async<BN, D, NT>(sK + stage * TILE, kb, ks.s, k0, kn);
    tc::load_tile_async<BN, D, NT>(sV + stage * TILE, vb, vs.s, k0, kn);
  };
  // groups: Q, then one per K/V tile (empty past the last live tile)
  tc::load_tile_async<BM, D, NT>(sQ, qb, qs.s, q0, qn);
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (kt_lo + st <= kt_hi) load_kv(st, kt_lo + st);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<STAGES - 1>();  // Q has landed
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c)
    tc::ldmatrix_x4(qf[c], tc::a_frag_addr<D>(sQ, wr, 2 * c, lane));

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows qi0 and qi0 + 8 of this thread: running max (base-2 units) and
  // this thread's share of the running sum of p
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const float sl2 = g.scale * LOG2E;
  const int qi0 = q0 + wr + gr;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int it = kt - kt_lo;
    tc::cp_async_wait<STAGES - 2>();  // tile kt has landed ...
    __syncthreads();  // ... for every thread, and tile kt-1 is consumed
    if (kt + STAGES - 1 <= kt_hi)
      load_kv((it + STAGES - 1) % STAGES, kt + STAGES - 1);
    tc::cp_async_commit();
    const uint32_t kS = sK + (it % STAGES) * TILE;
    const uint32_t vS = sV + (it % STAGES) * TILE;

    // S = Q K^T (16 x 64 per warp)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t f[4];
        tc::ldmatrix_x4(f, tc::b_frag_addr<D>(kS, 8 * n, 2 * c, lane));
        tc::mma_bf16(s[n], qf[c], f[0], f[1]);
        tc::mma_bf16(s[n + 1], qf[c], f[2], f[3]);
      }

    const int k0 = kt * BN;
    float alpha[2];
    if (g.Sk - k0 >= BN &&
        tile_full(g, q_lo, q_hi, g.ko + k0, g.ko + k0 + BN - 1))
      softmax_step<false>(s, m_r, l_r, alpha, g, qi0, k0, tq, sl2);
    else
      softmax_step<true>(s, m_r, l_r, alpha, g, qi0, k0, tq, sl2);
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      uint32_t a[4];
      tc::c_pair_to_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t f[4];
        tc::ldmatrix_x4_trans(f, tc::bt_frag_addr<D>(vS, 16 * c, j, lane));
        tc::mma_bf16(acc[j], a, f[0], f[1]);
        tc::mma_bf16(acc[j + 1], a, f[2], f[3]);
      }
    }
  }

  // epilogue: o = acc / max(l, TINY), 0 where l == 0, staged in the warp's
  // own 16 rows of the Q tile (no other warp reads them, and every copy
  // has landed: the groups after the last live tile are empty)
  bf16* ob = o + b * os.b + h * os.h;
  float* lrow = lse + ((long long)b * g.Hq + h) * g.Sq + q0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = tc::quad_sum(l_r[i]);
    const bool valid = l > 0.f;  // false only for fully-masked rows
    const float l_fin = fmaxf(l, TINY);
    const int row = wr + gr + 8 * i;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float o0 = valid ? acc[j][2 * i] / l_fin : 0.f;
      const float o1 = valid ? acc[j][2 * i + 1] / l_fin : 0.f;
      *reinterpret_cast<uint32_t*>(smem + tc::swz<D>(row, j) + 4 * tq) =
          tc::pack_bf16(o0, o1);
    }
    if (tq == 0 && row < qn)
      lrow[row] = valid ? m_r[i] * LN2 + logf(l_fin) : NEG;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16 * NO / 32; ++j) {
    const int row = wr + (lane + 32 * j) / NO, c = (lane + 32 * j) % NO;
    if (row < qn)
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + row) * os.s + c * 8) =
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
                   void* o, float* lse, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(BM + 2 * STAGES * BN) * D * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Sq + BM - 1) / BM, g.Hq, g.B);
  flash_fwd_tc_kernel<D><<<grid, NT, smem, stream>>>(
      g, (const bf16*)q, str_at(st, 0), (const bf16*)k, str_at(st, 1),
      (const bf16*)v, str_at(st, 2), (bf16*)o, str_at(st, 3), lse);
  return cudaGetLastError();
}

}  // namespace

// C entry point (ctypes), with mxtt_flash_fwd's signature.  dtype must be
// 1 (bfloat16).  dims: B, Hq, Hkv, Sq, Sk, D.  strides: 3 per tensor
// (batch, head, sequence) for q, k, v, o.  lse: float32 (B, Hq, Sq)
// contiguous.  Returns the cudaError_t.
extern "C" int mxtt_flash_fwd_tc(int dtype, const void* q, const void* k,
                                 const void* v, void* o, void* lse,
                                 const int* dims, const long long* strides,
                                 int causal, int window, int q_offset,
                                 int k_offset, float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  if (dtype != 1 || !geo_ok(g) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g.D == 64)
    return (int)launch<64>(g, q, k, v, o, (float*)lse, strides, s);
  return (int)launch<128>(g, q, k, v, o, (float*)lse, strides, s);
}
