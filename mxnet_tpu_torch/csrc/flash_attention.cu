// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the TPU kernels of mxnet_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd / _fwd_kernel       (call at :420)
//   flash_dq_kernel   <- _bwd / _bwd_dq_kernel    (call at :579)
//   flash_dkv_kernel  <- _bwd / _bwd_dkv_kernel   (call at :607)
// Each computes what its TPU kernel computes, with the same masks
// (_mask_for), the same tile skip (_tile_live), the same -1e30 sentinel
// for fully-masked rows (o = 0, lse = -1e30, never NaN) and the same
// rounding points for bfloat16 inputs: p is rounded to the input type
// before P.V and P^T.dO, ds before dS.K and dS^T.Q; every sum is float32.
//
// What differs from the TPU design.  The TPU grid ran its k (or q) axis
// in order on one core and carried the softmax state / gradient sums in
// VMEM scratch from one grid step to the next.  CUDA blocks run in no
// order, so each CTA owns one (batch, head, 64-row tile) and a loop
// inside the CTA walks the live tiles of the other axis, keeping the
// running state in registers and shared memory.  The dK/dV CTA owns one
// KV head and loops over every q head of its GQA group, so the group sum
// happens in registers, without atomics: gradients are bitwise the same
// from run to run.  Tensors are read through the strides they come with,
// so the bhsd and bshd layouts both run without a transpose; q head h
// reads kv head h / group in both.  Any sequence length runs: ragged
// last tiles are masked by position.
//
// What bounds it.  At the training shape (B 16, H 8, S 1024, D 64,
// causal) the work is ~17 GFLOP forward and ~26 / ~34 GFLOP for dQ and
// dK/dV against ~17 MB per tensor, so the tensor cores' rate sets the
// bound (tens of microseconds).  These kernels do their products as
// float32 FMAs from shared memory, each thread owning a 4 x 4 score tile
// and a 4 x D/16 accumulator; they are bound by shared-memory reads and
// the FMA rate, far from that bound.  The bfloat16 forward, dQ and dK/dV
// within their limits run on the tensor cores in flash_fwd_tc.cu,
// flash_dq_tc.cu and flash_dkv_tc.cu (mma.sync on cp.async-fed tiles,
// tc_tile.cuh), and the float32 forward, dQ and dK/dV at head_dim 64 in
// flash_fwd_f32tc.cu, flash_dq_f32tc.cu and flash_dkv_f32tc.cu
// (split-TF32 mma.sync, tf32x3.cuh); the three kernels here now serve
// only the geometries of either dtype outside those kernels' limits.
//
// Limits: head_dim <= 128; float32 or bfloat16; the last dimension of
// every tensor contiguous.  A launch outside them returns
// cudaErrorInvalidValue without running.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;            // q rows per tile
constexpr int BN = 64;            // k rows per tile
constexpr int NT = 256;           // threads per CTA: a 16 x 16 grid
constexpr int MAX_D = 128;
constexpr int MJ = MAX_D / 16;    // accumulator columns per thread
constexpr int LDP = BN + 1;       // padded row of a score tile
constexpr float NEG = -1e30f;     // the TPU kernel's _NEG_INF
constexpr float TINY = 1e-30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// the value x takes once stored in T (the TPU kernel's astype points)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

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

// dst[r][c] (row stride ld) = src row (row0 + r), column c, as float;
// rows at or past `valid` are zero
template <typename T>
__device__ void load_tile(float* dst, const T* src, long long ss, int row0,
                          int valid, int D, int ld) {
  for (int idx = threadIdx.x; idx < BM * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    dst[r * ld + c] =
        r < valid ? to_f(src[(long long)(row0 + r) * ss + c]) : 0.f;
  }
}

__device__ void load_rows(float* dst, const float* src, int row0,
                          int valid) {
  for (int r = threadIdx.x; r < BM; r += NT)
    dst[r] = r < valid ? src[row0 + r] : 0.f;
}

// ---------------------------------------------------------------------------
// forward: one CTA per (q tile, q head, batch)
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(Geo g, const T* __restrict__ q, Str qs,
                     const T* __restrict__ k, Str ks,
                     const T* __restrict__ v, Str vs, T* __restrict__ o,
                     Str os, float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int D = g.D, ld = D + 1;
  float* Qs = smem;               // BM x ld
  float* Ks = Qs + BM * ld;       // BN x ld
  float* Vs = Ks + BN * ld;       // BN x ld
  float* Ps = Vs + BN * ld;       // BM x LDP: scores, then p
  float* m_s = Ps + BM * LDP;     // running max
  float* l_s = m_s + BM;          // running sum of p
  float* a_s = l_s + BM;          // this tile's rescale factor

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.group;
  const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(Qs, qb, qs.s, q0, qn, D, ld);
  for (int r = threadIdx.x; r < BM; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  float acc[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;

  const int q_lo = g.qo + q0, q_hi = g.qo + q0 + qn - 1;
  const int nk = (g.Sk + BN - 1) / BN;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
    if (!tile_live(g, q_lo, q_hi, g.ko + k0, g.ko + k0 + kn - 1)) continue;
    __syncthreads();  // the last tile's readers are done
    load_tile(Ks, kb, ks.s, k0, kn, D, ld);
    load_tile(Vs, vb, vs.s, k0, kn, D, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j] * g.scale;
    __syncthreads();

    // online softmax: one warp per 8 rows, two columns per lane
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr;
      float* row = Ps + r * LDP;
      const bool in0 = r < qn && lane < kn && keep(g, q0 + r, k0 + lane);
      const bool in1 =
          r < qn && lane + 32 < kn && keep(g, q0 + r, k0 + lane + 32);
      const float v0 = in0 ? row[lane] : NEG;
      const float v1 = in1 ? row[lane + 32] : NEG;
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      // masked scores give p = 0 even when the whole row is masked
      // (m_cur == NEG would otherwise make exp(0) == 1)
      const float p0 = in0 ? expf(v0 - m_cur) : 0.f;
      const float p1 = in1 ? expf(v1 - m_cur) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = round_to<T>(p0);
      row[lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < MJ; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < BN; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= qn) continue;
    const float l = l_s[r];
    const bool valid = l > 0.f;  // false only for fully-masked rows
    const float l_fin = fmaxf(l, TINY);
    T* orow = o + b * os.b + h * os.h + (long long)(q0 + r) * os.s;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f<T>(valid ? acc[i][j] / l_fin : 0.f);
    }
  }
  float* lrow = lse + ((long long)b * g.Hq + h) * g.Sq + q0;
  for (int r = threadIdx.x; r < qn; r += NT) {
    const float l = l_s[r];
    lrow[r] = l > 0.f ? m_s[r] + logf(fmaxf(l, TINY)) : NEG;
  }
}

// Scores and dP of one (q tile, k tile) pair into ds, as the dQ and dK/dV
// kernels both need them: p = exp(s - lse), ds = p (dp - delta + dlse)
// scale.  Writes p rounded to T into Ps (when Ps is not null) and ds
// rounded to T into Ds.
template <typename T>
__device__ void tile_p_ds(const Geo& g, const float* Qs, const float* dOs,
                          const float* Ks, const float* Vs,
                          const float* lse_s, const float* delta_s,
                          const float* dlse_s, float* Ps, float* Ds, int q0,
                          int qn, int k0, int kn, int ld) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < g.D; ++d) {
    float a[4], o[4], c[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty + 16 * i) * ld + d];
      o[i] = dOs[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = Ks[(tx + 16 * j) * ld + d];
      w[j] = Vs[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], c[j], s[i][j]);
        dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool in = r < qn && c < kn && keep(g, q0 + r, k0 + c);
      // fully-masked rows carry lse = -1e30; their p is 0 by the mask
      const float p = in ? expf(s[i][j] * g.scale - lse_s[r]) : 0.f;
      const float ds = p * (dp[i][j] - delta_s[r] + dlse_s[r]) * g.scale;
      if (Ps) Ps[r * LDP + c] = round_to<T>(p);
      Ds[r * LDP + c] = round_to<T>(ds);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (q tile, q head, batch); loops over the live k tiles
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(Geo g, const T* __restrict__ q, Str qs,
                    const T* __restrict__ k, Str ks,
                    const T* __restrict__ v, Str vs,
                    const T* __restrict__ dO, Str dos,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dlse, T* __restrict__ dq,
                    Str dqs) {
  extern __shared__ float smem[];
  const int D = g.D, ld = D + 1;
  float* Qs = smem;
  float* dOs = Qs + BM * ld;
  float* Ks = dOs + BM * ld;
  float* Vs = Ks + BN * ld;
  float* Ds = Vs + BN * ld;       // BM x LDP
  float* lse_s = Ds + BM * LDP;
  float* delta_s = lse_s + BM;
  float* dlse_s = delta_s + BM;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.group;
  const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const long long row0 = ((long long)b * g.Hq + h) * g.Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(Qs, q + b * qs.b + h * qs.h, qs.s, q0, qn, D, ld);
  load_tile(dOs, dO + b * dos.b + h * dos.h, dos.s, q0, qn, D, ld);
  load_rows(lse_s, lse + row0, q0, qn);
  load_rows(delta_s, delta + row0, q0, qn);
  load_rows(dlse_s, dlse + row0, q0, qn);
  float acc[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;

  const int q_lo = g.qo + q0, q_hi = g.qo + q0 + qn - 1;
  const int nk = (g.Sk + BN - 1) / BN;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
    if (!tile_live(g, q_lo, q_hi, g.ko + k0, g.ko + k0 + kn - 1)) continue;
    __syncthreads();
    load_tile(Ks, kb, ks.s, k0, kn, D, ld);
    load_tile(Vs, vb, vs.s, k0, kn, D, ld);
    __syncthreads();
    tile_p_ds<T>(g, Qs, dOs, Ks, Vs, lse_s, delta_s, dlse_s, nullptr, Ds,
                 q0, qn, k0, kn, ld);
    __syncthreads();
    for (int c = 0; c < BN; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ds[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kk = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kk, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= qn) continue;
    T* out = dq + b * dqs.b + h * dqs.h + (long long)(q0 + r) * dqs.s;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[d] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (k tile, kv head, batch); loops over the q heads of
// the GQA group and their live q tiles, summing in registers
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(Geo g, const T* __restrict__ q, Str qs,
                     const T* __restrict__ k, Str ks,
                     const T* __restrict__ v, Str vs,
                     const T* __restrict__ dO, Str dos,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dlse, T* __restrict__ dk,
                     Str dks, T* __restrict__ dv, Str dvs) {
  extern __shared__ float smem[];
  const int D = g.D, ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + BN * ld;
  float* Qs = Vs + BN * ld;
  float* dOs = Qs + BM * ld;
  float* Ps = dOs + BM * ld;      // BM x LDP
  float* Ds = Ps + BM * LDP;      // BM x LDP
  float* lse_s = Ds + BM * LDP;
  float* delta_s = lse_s + BM;
  float* dlse_s = delta_s + BM;

  // heaviest causal tiles first: k tile 0 meets every q tile, the last
  // k tile only the last q tile
  const int kt = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BN, kn = min(BN, g.Sk - k0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, kn, D, ld);
  load_tile(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, kn, D, ld);
  float gk[4][MJ], gv[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int k_lo = g.ko + k0, k_hi = g.ko + k0 + kn - 1;
  const int nq = (g.Sq + BM - 1) / BM;
  for (int gi = 0; gi < g.group; ++gi) {
    const int h = hk * g.group + gi;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dO + b * dos.b + h * dos.h;
    const long long row0 = ((long long)b * g.Hq + h) * g.Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BM, qn = min(BM, g.Sq - q0);
      if (!tile_live(g, g.qo + q0, g.qo + q0 + qn - 1, k_lo, k_hi)) continue;
      __syncthreads();
      load_tile(Qs, qb, qs.s, q0, qn, D, ld);
      load_tile(dOs, ob, dos.s, q0, qn, D, ld);
      load_rows(lse_s, lse + row0, q0, qn);
      load_rows(delta_s, delta + row0, q0, qn);
      load_rows(dlse_s, dlse + row0, q0, qn);
      __syncthreads();
      tile_p_ds<T>(g, Qs, dOs, Ks, Vs, lse_s, delta_s, dlse_s, Ps, Ds, q0,
                   qn, k0, kn, ld);
      __syncthreads();
      // this thread's k rows c = ty + 16 i, columns d = tx + 16 j
      for (int r = 0; r < BM; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * LDP + ty + 16 * i];
          ds[i] = Ds[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float od = dOs[r * ld + d], qd = Qs[r * ld + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gv[i][j] = fmaf(p[i], od, gv[i][j]);
              gk[i][j] = fmaf(ds[i], qd, gk[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c >= kn) continue;
    T* krow = dk + b * dks.b + hk * dks.h + (long long)(k0 + c) * dks.s;
    T* vrow = dv + b * dvs.b + hk * dvs.h + (long long)(k0 + c) * dvs.s;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        krow[d] = from_f<T>(gk[i][j]);
        vrow[d] = from_f<T>(gv[i][j]);
      }
    }
  }
}

size_t fwd_smem(int D) {
  return sizeof(float) * ((size_t)(BM + 2 * BN) * (D + 1) + BM * LDP + 3 * BM);
}
size_t dq_smem(int D) {
  return sizeof(float) *
         ((size_t)(2 * BM + 2 * BN) * (D + 1) + BM * LDP + 3 * BM);
}
size_t dkv_smem(int D) {
  return sizeof(float) *
         ((size_t)(2 * BM + 2 * BN) * (D + 1) + 2 * BM * LDP + 3 * BM);
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
         g.Sq > 0 && g.Sk > 0 && g.D > 0 && g.D <= MAX_D && g.window >= 0 &&
         g.Hq <= 65535 && g.B <= 65535;
}

Str str_at(const long long* s, int i) {
  Str r;
  r.b = s[3 * i];
  r.h = s[3 * i + 1];
  r.s = s[3 * i + 2];
  return r;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_fwd(const Geo& g, const void* q, const void* k,
                       const void* v, void* o, float* lse,
                       const long long* st, cudaStream_t stream) {
  const size_t smem = fwd_smem(g.D);
  cudaError_t e = allow_smem(flash_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Sq + BM - 1) / BM, g.Hq, g.B);
  flash_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      g, (const T*)q, str_at(st, 0), (const T*)k, str_at(st, 1),
      (const T*)v, str_at(st, 2), (T*)o, str_at(st, 3), lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const Geo& g, const void* q, const void* k,
                      const void* v, const void* dO, const float* lse,
                      const float* delta, const float* dlse, void* dq,
                      const long long* st, cudaStream_t stream) {
  const size_t smem = dq_smem(g.D);
  cudaError_t e = allow_smem(flash_dq_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Sq + BM - 1) / BM, g.Hq, g.B);
  flash_dq_kernel<T><<<grid, NT, smem, stream>>>(
      g, (const T*)q, str_at(st, 0), (const T*)k, str_at(st, 1),
      (const T*)v, str_at(st, 2), (const T*)dO, str_at(st, 3), lse, delta,
      dlse, (T*)dq, str_at(st, 4));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Geo& g, const void* q, const void* k,
                       const void* v, const void* dO, const float* lse,
                       const float* delta, const float* dlse, void* dk,
                       void* dv, const long long* st, cudaStream_t stream) {
  const size_t smem = dkv_smem(g.D);
  cudaError_t e = allow_smem(flash_dkv_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Sk + BN - 1) / BN, g.Hkv, g.B);
  flash_dkv_kernel<T><<<grid, NT, smem, stream>>>(
      g, (const T*)q, str_at(st, 0), (const T*)k, str_at(st, 1),
      (const T*)v, str_at(st, 2), (const T*)dO, str_at(st, 3), lse, delta,
      dlse, (T*)dk, str_at(st, 4), (T*)dv, str_at(st, 5));
  return cudaGetLastError();
}

}  // namespace

// C entry points (ctypes).  dtype: 0 float32, 1 bfloat16.  dims: B, Hq,
// Hkv, Sq, Sk, D.  strides: 3 per tensor (batch, head, sequence), in
// argument order (q, k, v, then o | dO, dq | dO, dk, dv).  lse, delta,
// dlse: float32 (B, Hq, Sq) contiguous.  Returns the cudaError_t.
extern "C" int mxtt_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse,
                              const int* dims, const long long* strides,
                              int causal, int window, int q_offset,
                              int k_offset, float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  if (!geo_ok(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd<float>(g, q, k, v, o, (float*)lse, strides, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(g, q, k, v, o, (float*)lse,
                                          strides, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_dq(int dtype, const void* q, const void* k,
                             const void* v, const void* dO, const void* lse,
                             const void* delta, const void* dlse, void* dq,
                             const int* dims, const long long* strides,
                             int causal, int window, int q_offset,
                             int k_offset, float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  if (!geo_ok(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_dq<float>(g, q, k, v, dO, (const float*)lse,
                                 (const float*)delta, (const float*)dlse, dq,
                                 strides, s);
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(
        g, q, k, v, dO, (const float*)lse, (const float*)delta,
        (const float*)dlse, dq, strides, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_dkv(int dtype, const void* q, const void* k,
                              const void* v, const void* dO, const void* lse,
                              const void* delta, const void* dlse, void* dk,
                              void* dv, const int* dims,
                              const long long* strides, int causal,
                              int window, int q_offset, int k_offset,
                              float scale, void* stream) {
  const Geo g = make_geo(dims, causal, window, q_offset, k_offset, scale);
  if (!geo_ok(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_dkv<float>(g, q, k, v, dO, (const float*)lse,
                                  (const float*)delta, (const float*)dlse,
                                  dk, dv, strides, s);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(
        g, q, k, v, dO, (const float*)lse, (const float*)delta,
        (const float*)dlse, dk, dv, strides, s);
  return (int)cudaErrorInvalidValue;
}
