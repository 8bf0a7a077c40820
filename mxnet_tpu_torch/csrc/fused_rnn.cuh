// Fused LSTM and GRU layers for Hopper (sm_90a): forward and backward.
// The kernels are templates on the element type T and the gate count G;
// fused_{lstm,gru}_{fwd,bwd}.cu instantiate them behind their C entry
// points, one translation unit per kernel, which nvcc builds in parallel.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_lstm.py and
// mxnet_tpu/ops/pallas_gru.py:
//   rnn_fwd_kernel<T, 4>  <- pallas_lstm.py _fwd / _fwd_kernel      (call :126)
//   rnn_bwd_kernel<T, 4>  <- pallas_lstm.py _bwd_call / _bwd_kernel (call :216)
//   rnn_fwd_kernel<T, 3>  <- pallas_gru.py  _fwd / _fwd_kernel      (call :94)
//   rnn_bwd_kernel<T, 3>  <- pallas_gru.py  _bwd_call / _bwd_kernel (call :169)
// Within their limits the forward and the backward run instead on the
// tensor cores, in bfloat16 (fused_rnn_fwd_tc.cuh, fused_rnn_bwd_tc.cuh)
// and in float32 through split-TF32 products (fused_rnn_fwd_f32tc.cuh,
// fused_rnn_bwd_f32tc.cuh), picked on the host by ops/fused_rnn_cuda.py
// _fwd_variant and _bwd_variant; rnn_fwd_kernel and rnn_bwd_kernel take
// every other geometry.
// Each computes what its TPU kernel computes, at the same cast points: the
// recurrent products take operands in gx's type T (h, Wh; dgates, Wh;
// dgates, h_prev) and sum in float32; gx, bh and the carried state are
// float32; the saved activations and cells are float32; ys, hT, cT and dgx
// are T; dWh, dbh, dh0 and dc0 are float32.  The LSTM's gates are i, f, g, o;
// the GRU's r, z, n with the reset gate applied to the hidden projection
// (the cuDNN variant), saving (r, z, n, hp_n).
//
// What differs from the TPU design.  The TPU ran grid=(T,) in order on one
// core with Wh and the state resident in VMEM.  Here Wh (4H x H: 2 MiB in
// bf16 at H 512) does not fit one SM, so the hidden units are split across
// a persistent cooperative grid: CTA k owns units [j0, j0 + Hs), Hs =
// ceil(H / 132), and keeps the G*Hs rows of Wh for those units (all gates)
// in shared memory for the whole sequence, with its units' float32 state
// (c for the LSTM, h for the GRU's z * h).  Each cell's gate math is then
// local to its CTA.  The one value every CTA needs from every other is the
// matmul operand h_{t-1} in T, which is exactly ys[t-1]: each CTA writes
// its slice of ys[t], the grid synchronises once (cooperative launch,
// grid.sync()), and every CTA reads all of ys[t] as the next operand.
//
// The backward walks t = T-1 .. 0 with one grid barrier per step.  The CTA
// owning units [j0, j0 + Hs) (1) computes its slice of dgates from the saved
// residuals (dh = dh_carry + dys[t]; the LSTM's c_prev is cells[t-1], or c0
// at t = 0) and writes dgx[t] = dgates in T, which is also the matmul operand
// dg_lo, so dgx itself is the exchange buffer (the GRU's operand is
// dhp_lo = [dr_pre, dz_pre, dnh] in T, not dgx, so it goes through an
// exchange buffer of its own); (2) after the barrier computes its slice of
// dh_{t-1} = dg_lo[t] (N, G*H) @ Wh[:, slice] from a second resident block,
// the G*H x Hs columns of Wh (the GRU adds dh * z); (3) accumulates
// dWh[rows of slice, :] += dg_lo[:, rows]^T @ h_prev (h_prev = ys[t-1], or
// h0 in T at t = 0) and dbh[rows] += sum_N dgates (the float32 dgates, as
// the reference sums them) in shared memory.  dWh and dbh stay in the
// kernel, as in the TPU kernel.  One barrier per step suffices: dh_{t-1} of
// a slice is read next only by the CTA that owns it; dgx[t-1] is another
// row than dgx[t], so a CTA that runs ahead into step t-1's phase (1) never
// overwrites what a slower CTA still reads in step t's phase (2); and the
// GRU's exchange buffer alternates between two halves by the parity of t (a
// CTA reaches step t-2's phase (1) only after every CTA has passed the
// barrier of step t-1, which follows their phase (2) of step t).
//
// Values written in this kernel by other CTAs (ys in the forward, dgx or the
// exchange buffer in the backward) are read with ld.global.cg (__ldcg), from
// L2: never through the non-coherent path (a const __restrict__ or __ldg read
// can compile to LDG.NC) nor from a possibly stale L1 line.
//
// Products.  Both recurrent products are long-K, small-output: per step a CTA
// computes N x G*Hs gate sums over K = H (forward) or N x Hs sums over
// K = G*H (backward).  An operand tile of 32 batch rows is staged in shared
// memory (float32 copies of the T values) and each of the 256 threads owns a
// 4 x 4 block of outputs over a stripe of K (split-K), reading float4s from
// shared memory (row strides padded to 4 mod 8 words: conflict-free), then
// the stripes are summed.  float32 FMAs: no tensor cores yet.
//
// What bounds it.  At the language model's shape (T 128, N 32, H 512) one
// layer's forward is 2*T*N*4H*H = 8.6 GFLOP and its backward twice that,
// against ~50 MB of residuals: the tensor cores would take ~10 us and HBM
// ~15-30 us.  The serial dependence sets the time instead: each step waits
// for the previous step's h (or dh) from every CTA, so a step costs a grid
// barrier plus one small product's latency; the barrier floor (an empty
// cooperative kernel of T barriers) is measured beside the kernels.
//
// Limits: float32 or bfloat16; every tensor contiguous; a geometry whose
// shared memory (smem_bytes) exceeds a block's 227 KB, or whose grid is
// not co-resident on the card, returns an error without running.  The
// dispatch rule (ops/fused_lstm.py, fused_rnn_fits) bounds smem_bytes from
// above in closed form, in float32 words, with hs = ceil(H / 132),
// R = G hs, K = H + 12 (a padded row of H), rows(x) = x rounded up to 4
// times a power of two and r4 = R rounded up to 4:
//   forward  (rows(R) + NB) K + NB rows(R) + PART + N hs
//   backward (G rows(hs) + NB + r4) K + NB rows(hs) + PART
//            + (2 N + 1) r4 + 2 N hs
// each at most 227 KB / 4, and rows(R) <= 128 (TRf <= NT / 8).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NB = 32;            // batch rows per operand tile
constexpr int SMS = 132;          // H100 SXM: hidden units are split 132 ways
constexpr int PART = NT * 16;     // split-K partial sums (floats)
constexpr int SMEM_MAX = 232448;  // bytes one block may use

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

// a value another CTA wrote earlier in this kernel: from L2 (ld.global.cg)
__device__ __forceinline__ float ld_x(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_x(const __nv_bfloat16* p) {
  const unsigned short b = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}
__host__ __device__ inline int pad8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Geo {
  int G, T, N, H, save;
  int hs;    // hidden units per CTA
  int P;     // CTAs
  int R;     // G * hs: the CTA's rows of Wh
  int TRf;   // forward product: output rows R in 4 * TRf
  int TRb;   // backward product: output rows hs in 4 * TRb
  int HP;    // H padded to 8
  int LDA;   // operand tile row stride (HP + 4)
  int nck;   // K chunks of HP over G * H
  int LDB;   // backward resident row stride (nck * HP + 4)
  int RPc;   // R padded to 4
};

__host__ __device__ inline Geo make_geo(int G, int T, int N, int H,
                                        int save) {
  Geo g;
  g.G = G, g.T = T, g.N = N, g.H = H, g.save = save;
  g.hs = cdiv(H, SMS);
  g.P = cdiv(H, g.hs);
  g.R = G * g.hs;
  g.TRf = pow2_at_least(cdiv(g.R, 4));
  g.TRb = pow2_at_least(cdiv(g.hs, 4));
  g.HP = pad8(H);
  g.LDA = g.HP + 4;
  g.nck = cdiv(G * H, g.HP);
  g.LDB = g.nck * g.HP + 4;
  g.RPc = 4 * cdiv(g.R, 4);
  return g;
}

// shared-memory layouts, as float offsets (every piece 16-byte aligned)
struct FwdSmem {
  int w, a, part, out, st, total;
};
struct BwdSmem {
  int w, a, part, out, dw, dgl, dgf, dbs, c1, c2, total;
};

__host__ __device__ inline FwdSmem fwd_smem(const Geo& g) {
  FwdSmem s;
  s.w = 0;                                  // [4 TRf][LDA]: Wh rows
  s.a = s.w + 4 * g.TRf * g.LDA;            // [NB][LDA]: operand tile
  s.part = s.a + NB * g.LDA;                // [PART]
  s.out = s.part + PART;                    // [NB][4 TRf]: gate sums
  s.st = s.out + NB * 4 * g.TRf;            // [N][hs]: c or h, float32
  s.total = s.st + g.N * g.hs;
  return s;
}

__host__ __device__ inline BwdSmem bwd_smem(const Geo& g) {
  BwdSmem s;
  s.w = 0;                                  // [4 TRb][LDB]: Wh columns
  s.a = s.w + 4 * g.TRb * g.LDB;            // [NB][LDA]: operand tile
  s.part = s.a + NB * g.LDA;                // [PART]
  s.out = s.part + PART;                    // [NB][4 TRb]: dh sums
  s.dw = s.out + NB * 4 * g.TRb;            // [RPc][HP]: dWh rows
  s.dgl = s.dw + g.RPc * g.HP;              // [N][RPc]: dgates in T
  s.dgf = s.dgl + g.N * g.RPc;              // [N][RPc]: dgates, float32
  s.dbs = s.dgf + g.N * g.RPc;              // [RPc]: dbh rows
  s.c1 = s.dbs + g.RPc;                     // [N][hs]: dh carry
  s.c2 = s.c1 + g.N * g.hs;                 // [N][hs]: dc, or dh * z
  s.total = s.c2 + g.N * g.hs;
  return s;
}

inline long long smem_bytes(const Geo& g, bool bwd) {
  return 4LL * (bwd ? bwd_smem(g).total : fwd_smem(g).total);
}

// eight bfloat16 or four float32 values of one 16-byte load
__device__ __forceinline__ void unpack(uint4 u, float* v, float) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* v, __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A[n][k] (row stride lda) = src row (n0 + n), column (k0 + k), as float,
// for n < NB and k < kw (kw a multiple of 8); zero where n >= nv or
// k >= kv.  `fresh`: the source was written earlier in this kernel by other
// CTAs.  16-byte loads where the rows are 16-byte aligned, else scalar ones.
// The load is latency-bound (the tile comes from L2 right after a grid
// barrier), so each thread issues LB 16-byte loads before storing any.
constexpr int LB = 8;
template <bool fresh, typename T>
__device__ void load_tile(float* A, int lda, const T* src, long long ld,
                          int n0, int nv, int k0, int kv, int kw) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = ld % V == 0 && k0 % V == 0 &&
                   (reinterpret_cast<unsigned long long>(src) & 15) == 0;
  if (vec) {
    const int kwv = kw / V, total = NB * kwv;
    for (int base = threadIdx.x; base < total; base += LB * NT) {
      uint4 u[LB];
      bool full[LB];
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const int idx = base + i * NT;
        const int n = idx / kwv, k = (idx - n * kwv) * V;
        full[i] = idx < total && n < nv && k + V <= kv;
        if (full[i]) {
          const uint4* q = reinterpret_cast<const uint4*>(
              src + (long long)(n0 + n) * ld + k0 + k);
          u[i] = fresh ? __ldcg(q) : *q;
        }
      }
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const int idx = base + i * NT;
        if (idx >= total) break;
        const int n = idx / kwv, k = (idx - n * kwv) * V;
        const T* p = src + (long long)(n0 + n) * ld + k0 + k;
        float v[V];
        if (full[i]) {
          unpack(u[i], v, T());
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            v[e] = (n < nv && k + e < kv)
                       ? (fresh ? ld_x(p + e) : to_f(p[e]))
                       : 0.f;
        }
        float4* a = reinterpret_cast<float4*>(A + n * lda + k);
#pragma unroll
        for (int e = 0; e < V / 4; ++e)
          a[e] =
              make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]);
      }
    }
    return;
  }
#pragma unroll 4
  for (int idx = threadIdx.x; idx < NB * kw; idx += NT) {
    const int n = idx / kw, k = idx - n * kw;
    float v = 0.f;
    if (n < nv && k < kv) {
      const T* p = src + (long long)(n0 + n) * ld + k0 + k;
      v = fresh ? ld_x(p) : to_f(*p);
    }
    A[n * lda + k] = v;
  }
}

// the float32 h0 as the matmul operand: rounded to T
template <typename T>
__device__ void load_h0(float* A, int lda, const float* h0, int H, int n0,
                        int nv, int kw) {
  for (int idx = threadIdx.x; idx < NB * kw; idx += NT) {
    const int n = idx / kw, k = idx - n * kw;
    A[n * lda + k] = (n < nv && k < H)
                         ? round_to<T>(h0[(long long)(n0 + n) * H + k])
                         : 0.f;
  }
}

// acc[i][j] += sum over k < 4 kw4 of A[tn + 8 i][k] * B[tr + TR j][k]:
// thread (tn, tr, ks) owns 4 batch rows x 4 output rows and the K stripe of
// float4 groups ks, ks + KS, ...
__device__ __forceinline__ void rowdot(float (&acc)[4][4], const float* A,
                                       int lda, const float* B, int ldb,
                                       int kw4, int TR) {
  const int tn = threadIdx.x & 7;
  const int tr = (threadIdx.x >> 3) & (TR - 1);
  const int ks = threadIdx.x / (8 * TR), KS = NT / (8 * TR);
  for (int k4 = ks; k4 < kw4; k4 += KS) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (tn + 8 * i) * lda + 4 * k4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tr + TR * j) * ldb + 4 * k4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// out[n][r] (row stride 4 TR) = the sum of the K stripes' partial sums
__device__ void reduce_out(float* out, float* part, const float (&acc)[4][4],
                           int TR) {
  const int tn = threadIdx.x & 7;
  const int tr = (threadIdx.x >> 3) & (TR - 1);
  const int ks = threadIdx.x / (8 * TR), KS = NT / (8 * TR);
  const int RP = 4 * TR;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(ks * NB + tn + 8 * i) * RP + tr + TR * j] = acc[i][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NB * RP; idx += NT) {
    float s = 0.f;
    for (int q = 0; q < KS; ++q) s += part[q * NB * RP + idx];
    out[idx] = s;
  }
  __syncthreads();
}

// -- forward ------------------------------------------------------------------
template <typename T, int G>
__global__ void __launch_bounds__(NT)
    rnn_fwd_kernel(Geo g, const T* gx, const float* h0, const float* c0,
                   const T* wh, const float* bh, T* ys, T* hT, T* cT,
                   float* acts, float* cells) {
  extern __shared__ __align__(16) float sm[];
  const FwdSmem L = fwd_smem(g);
  float* W = sm + L.w;
  float* A = sm + L.a;
  float* part = sm + L.part;
  float* out = sm + L.out;
  float* st = sm + L.st;
  const int H = g.H, N = g.N, GH = G * H, HS = g.hs;
  const int j0 = blockIdx.x * HS, hs = min(HS, H - j0);
  const int RP = 4 * g.TRf;

  // resident: the CTA's rows of Wh (row q * HS + jl <- Wh row q H + j0 + jl)
  for (int idx = threadIdx.x; idx < RP * g.HP; idx += NT) {
    const int lr = idx / g.HP, k = idx - lr * g.HP;
    const int q = lr / HS, jl = lr - q * HS;
    float v = 0.f;
    if (lr < g.R && jl < hs && k < H)
      v = to_f(wh[(long long)(q * H + j0 + jl) * H + k]);
    W[lr * g.LDA + k] = v;
  }
  // the float32 state of the CTA's units: c (LSTM) or h (GRU)
  const float* s0 = G == 4 ? c0 : h0;
  for (int idx = threadIdx.x; idx < N * HS; idx += NT) {
    const int n = idx / HS, jl = idx - n * HS;
    st[idx] = jl < hs ? s0[(long long)n * H + j0 + jl] : 0.f;
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < g.T; ++t) {
    for (int n0 = 0; n0 < N; n0 += NB) {
      const int nv = min(NB, N - n0);
      // the thread's first cell's gate inputs and biases, fetched before the
      // operand tile so that their latency overlaps its load
      float xpre[G], bpre[G];
      if (threadIdx.x < nv * hs) {
        const int n = threadIdx.x / hs, j = j0 + threadIdx.x - n * hs;
        const T* x = gx + ((long long)t * N + n0 + n) * GH;
#pragma unroll
        for (int q = 0; q < G; ++q)
          xpre[q] = to_f(x[q * H + j]), bpre[q] = bh[q * H + j];
      }
      // h_{t-1} in T: h0 rounded at t = 0, else ys[t-1] (written by all CTAs)
      if (t == 0)
        load_h0<T>(A, g.LDA, h0, H, n0, nv, g.HP);
      else
        load_tile<true>(A, g.LDA, ys + (long long)(t - 1) * N * H, H, n0, nv,
                        0, H, g.HP);
      __syncthreads();
      float acc[4][4] = {};
      rowdot(acc, A, g.LDA, W, g.LDA, g.HP / 4, g.TRf);
      reduce_out(out, part, acc, g.TRf);
      for (int idx = threadIdx.x; idx < nv * hs; idx += NT) {
        const int n = idx / hs, jl = idx - n * hs, j = j0 + jl;
        const long long row = (long long)t * N + n0 + n;
        const T* x = gx + row * GH;
        const float* o = out + n * RP;
        float* s = st + (n0 + n) * HS + jl;
        float xq[G], bq[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const bool pre = idx == (int)threadIdx.x;
          xq[q] = pre ? xpre[q] : to_f(x[q * H + j]);
          bq[q] = pre ? bpre[q] : bh[q * H + j];
        }
        float h;
        if (G == 4) {
          // gates = gx + h Wh^T + bh, in float32
          const float i = sigm(xq[0] + o[jl] + bq[0]);
          const float f = sigm(xq[1] + o[HS + jl] + bq[1]);
          const float gg = tanhf(xq[2] + o[2 * HS + jl] + bq[2]);
          const float og = sigm(xq[3] + o[3 * HS + jl] + bq[3]);
          const float c = f * *s + i * gg;
          h = og * tanhf(c);
          *s = c;
          if (g.save) {
            float* a = acts + row * GH;
            a[j] = i, a[H + j] = f, a[2 * H + j] = gg, a[3 * H + j] = og;
            cells[row * H + j] = c;
          }
          if (t == g.T - 1) cT[(long long)(n0 + n) * H + j] = from_f<T>(c);
        } else {
          // hp = h Wh^T + bh; r, z on gx + hp; n = tanh(gx_n + r hp_n)
          const float hr = o[jl] + bq[0], hz = o[HS + jl] + bq[1];
          const float nh = o[2 * HS + jl] + bq[2];
          const float r = sigm(xq[0] + hr);
          const float z = sigm(xq[1] + hz);
          const float nn = tanhf(xq[2] + r * nh);
          h = (1.f - z) * nn + z * *s;
          *s = h;
          if (g.save) {
            float* a = acts + row * 4 * H;
            a[j] = r, a[H + j] = z, a[2 * H + j] = nn, a[3 * H + j] = nh;
          }
        }
        ys[row * H + j] = from_f<T>(h);
        if (t == g.T - 1) hT[(long long)(n0 + n) * H + j] = from_f<T>(h);
      }
      __syncthreads();   // A and out are reused by the next tile
    }
    if (t + 1 < g.T) grid.sync();   // ys[t] complete
  }
}

// -- backward -----------------------------------------------------------------
template <typename T, int G>
__global__ void __launch_bounds__(NT)
    rnn_bwd_kernel(Geo g, const float* acts, const float* cells, const T* ys,
                   const float* h0, const float* c0, const T* wh, const T* dys,
                   const T* dhT, const T* dcT, T* dgx, T* xbuf, float* dwh,
                   float* dbh, float* dh0, float* dc0) {
  extern __shared__ __align__(16) float sm[];
  const BwdSmem L = bwd_smem(g);
  float* W = sm + L.w;
  float* A = sm + L.a;
  float* part = sm + L.part;
  float* out = sm + L.out;
  float* dw = sm + L.dw;
  float* dgl = sm + L.dgl;
  float* dgf = sm + L.dgf;
  float* dbs = sm + L.dbs;
  float* c1 = sm + L.c1;
  float* c2 = sm + L.c2;
  const int H = g.H, N = g.N, GH = G * H, HS = g.hs, RPc = g.RPc;
  const int j0 = blockIdx.x * HS, hs = min(HS, H - j0);
  const int RPb = 4 * g.TRb, HP4 = g.HP / 4;

  // resident: Wh's columns of the CTA's units, W[jl][row] = Wh[row][j0+jl]
  const int wcols = g.nck * g.HP;
  for (int idx = threadIdx.x; idx < RPb * wcols; idx += NT) {
    const int r = idx / RPb, jl = idx - r * RPb;
    W[jl * g.LDB + r] = (jl < hs && r < GH)
                            ? to_f(wh[(long long)r * H + j0 + jl])
                            : 0.f;
  }
  for (int idx = threadIdx.x; idx < RPc * g.HP; idx += NT) dw[idx] = 0.f;
  for (int idx = threadIdx.x; idx < N * RPc; idx += NT)
    dgl[idx] = 0.f, dgf[idx] = 0.f;
  for (int idx = threadIdx.x; idx < RPc; idx += NT) dbs[idx] = 0.f;
  for (int idx = threadIdx.x; idx < N * HS; idx += NT) {
    const int n = idx / HS, jl = idx - n * HS;
    const long long e = (long long)n * H + j0 + jl;
    c1[idx] = jl < hs ? to_f(dhT[e]) : 0.f;
    c2[idx] = (G == 4 && jl < hs) ? to_f(dcT[e]) : 0.f;
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int t = g.T - 1; t >= 0; --t) {
    // (1) the slice's dgates, from the saved residuals
    T* xt = G == 4 ? dgx + (long long)t * N * GH
                   : xbuf + (long long)(t & 1) * N * GH;
    for (int idx = threadIdx.x; idx < N * hs; idx += NT) {
      const int n = idx / hs, jl = idx - n * hs, j = j0 + jl;
      const int e = n * HS + jl;
      const long long row = (long long)t * N + n;
      const float* a = acts + row * 4 * H;
      const float dh = c1[e] + to_f(dys[row * H + j]);
      float d[3 + (G == 4)], x[3 + (G == 4)];    // operand, float32 dgates
      T* dxr = dgx + row * GH;
      if (G == 4) {
        const float i = a[j], f = a[H + j], gg = a[2 * H + j];
        const float og = a[3 * H + j], c = cells[row * H + j];
        const float cp = t ? cells[(row - N) * H + j] : c0[(long long)n * H + j];
        const float tc = tanhf(c);
        const float dO = dh * tc;
        const float dc = c2[e] + dh * og * (1.f - tc * tc);
        x[0] = dc * gg * i * (1.f - i);
        x[1] = dc * cp * f * (1.f - f);
        x[2] = dc * i * (1.f - gg * gg);
        x[3] = dO * og * (1.f - og);
        c2[e] = dc * f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T lo = from_f<T>(x[q]);
          dxr[q * H + j] = lo;          // dgx[t]: also the product's operand
          d[q] = to_f(lo);
        }
      } else {
        const float r = a[j], z = a[H + j], nn = a[2 * H + j];
        const float nh = a[3 * H + j];
        const float hp = t ? to_f(ys[(row - N) * H + j])
                           : h0[(long long)n * H + j];
        const float dz = dh * (hp - nn);
        const float dn = dh * (1.f - z);
        const float dnp = dn * (1.f - nn * nn);
        const float dr = dnp * nh;
        x[0] = dr * r * (1.f - r);
        x[1] = dz * z * (1.f - z);
        x[2] = dnp * r;                 // dnh: dhp = [dr_pre, dz_pre, dnh]
        dxr[j] = from_f<T>(x[0]);
        dxr[H + j] = from_f<T>(x[1]);
        dxr[2 * H + j] = from_f<T>(dnp);
        c2[e] = dh * z;
        T* xr = xt + (long long)n * GH;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const T lo = from_f<T>(x[q]);
          xr[q * H + j] = lo;
          d[q] = to_f(lo);
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        dgl[n * RPc + q * HS + jl] = d[q];
        dgf[n * RPc + q * HS + jl] = x[q];
      }
    }
    __syncthreads();
    for (int lr = threadIdx.x; lr < g.R; lr += NT) {
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += dgf[n * RPc + lr];
      dbs[lr] += s;
    }
    grid.sync();   // dgx[t] (or the exchange half) complete

    // (2) dh_{t-1}[:, slice] = X[t] (N, G H) @ Wh[:, slice]  (+ dh z, GRU)
    for (int n0 = 0; n0 < N; n0 += NB) {
      const int nv = min(NB, N - n0);
      float acc[4][4] = {};
      for (int c = 0; c < g.nck; ++c) {
        load_tile<true>(A, g.LDA, xt, GH, n0, nv, c * g.HP,
                        min(g.HP, GH - c * g.HP), g.HP);
        __syncthreads();
        rowdot(acc, A, g.LDA, W + c * g.HP, g.LDB, HP4, g.TRb);
        __syncthreads();
      }
      reduce_out(out, part, acc, g.TRb);
      for (int idx = threadIdx.x; idx < nv * hs; idx += NT) {
        const int n = idx / hs, jl = idx - n * hs;
        const int e = (n0 + n) * HS + jl;
        const float v = out[n * RPb + jl];
        c1[e] = G == 4 ? v : c2[e] + v;
      }
      __syncthreads();
    }

    // (3) dWh[rows, :] += dg_lo[:, rows]^T @ h_prev, h_prev in T
    for (int n0 = 0; n0 < N; n0 += NB) {
      const int nv = min(NB, N - n0);
      if (t == 0)
        load_h0<T>(A, g.LDA, h0, H, n0, nv, g.HP);
      else
        load_tile<false>(A, g.LDA, ys + (long long)(t - 1) * N * H, H, n0,
                         nv, 0, H, g.HP);
      __syncthreads();
      for (int q = threadIdx.x; q < (RPc / 4) * HP4; q += NT) {
        const int ra = q / HP4, kb = q - ra * HP4;
        float acc[4][4] = {};
        for (int n = 0; n < nv; ++n) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dgl + (n0 + n) * RPc + 4 * ra);
          const float4 hv =
              *reinterpret_cast<const float4*>(A + n * g.LDA + 4 * kb);
          const float da[4] = {dv.x, dv.y, dv.z, dv.w};
          const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(da[i], ha[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* w = reinterpret_cast<float4*>(dw + (4 * ra + i) * g.HP + 4 * kb);
          float4 v = *w;
          v.x += acc[i][0], v.y += acc[i][1], v.z += acc[i][2], v.w += acc[i][3];
          *w = v;
        }
      }
      __syncthreads();
    }
  }

  // dh0, dc0, and the slice's rows of dWh and dbh, all float32
  for (int idx = threadIdx.x; idx < N * hs; idx += NT) {
    const int n = idx / hs, jl = idx - n * hs;
    const long long e = (long long)n * H + j0 + jl;
    dh0[e] = c1[n * HS + jl];
    if (G == 4) dc0[e] = c2[n * HS + jl];
  }
  for (int idx = threadIdx.x; idx < G * hs * H; idx += NT) {
    const int lr0 = idx / H, k = idx - lr0 * H;
    const int q = lr0 / hs, jl = lr0 - q * hs;
    dwh[(long long)(q * H + j0 + jl) * H + k] = dw[(q * HS + jl) * g.HP + k];
  }
  for (int idx = threadIdx.x; idx < G * hs; idx += NT) {
    const int q = idx / hs, jl = idx - q * hs;
    dbh[q * H + j0 + jl] = dbs[q * HS + jl];
  }
}

// the geometry's checks: a geometry the kernels do not take is refused with
// cudaErrorInvalidValue, a grid that is not co-resident with
// cudaErrorCooperativeLaunchTooLarge
template <typename K>
cudaError_t prepare(K kernel, const Geo& g, long long smem) {
  if (g.T < 1 || g.N < 1 || g.H < 1 || g.TRf > NT / 8 || smem > SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NT, (size_t)smem)) != cudaSuccess)
    return e;
  if (per_sm * sms < g.P) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

template <typename T, int G>
cudaError_t launch_fwd(const Geo& g, const void* gx, const void* h0,
                       const void* c0, const void* wh, const void* bh,
                       void* ys, void* hT, void* cT, void* acts, void* cells,
                       cudaStream_t stream) {
  auto kernel = rnn_fwd_kernel<T, G>;
  const long long smem = smem_bytes(g, false);
  cudaError_t e = prepare(kernel, g, smem);
  if (e != cudaSuccess) return e;
  Geo geo = g;
  const T* a0 = static_cast<const T*>(gx);
  const float *a1 = static_cast<const float*>(h0),
              *a2 = static_cast<const float*>(c0);
  const T* a3 = static_cast<const T*>(wh);
  const float* a4 = static_cast<const float*>(bh);
  T *o0 = static_cast<T*>(ys), *o1 = static_cast<T*>(hT),
    *o2 = static_cast<T*>(cT);
  float *o3 = static_cast<float*>(acts), *o4 = static_cast<float*>(cells);
  void* args[] = {&geo, &a0, &a1, &a2, &a3, &a4, &o0, &o1, &o2, &o3, &o4};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(g.P), dim3(NT),
                                  args, (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_bwd(const Geo& g, const void* acts, const void* cells,
                       const void* ys, const void* h0, const void* c0,
                       const void* wh, const void* dys, const void* dhT,
                       const void* dcT, void* dgx, void* xbuf, void* dwh,
                       void* dbh, void* dh0, void* dc0, cudaStream_t stream) {
  auto kernel = rnn_bwd_kernel<T, G>;
  const long long smem = smem_bytes(g, true);
  cudaError_t e = prepare(kernel, g, smem);
  if (e != cudaSuccess) return e;
  Geo geo = g;
  const float *a0 = static_cast<const float*>(acts),
              *a1 = static_cast<const float*>(cells);
  const T* a2 = static_cast<const T*>(ys);
  const float *a3 = static_cast<const float*>(h0),
              *a4 = static_cast<const float*>(c0);
  const T *a5 = static_cast<const T*>(wh), *a6 = static_cast<const T*>(dys),
          *a7 = static_cast<const T*>(dhT), *a8 = static_cast<const T*>(dcT);
  T *o0 = static_cast<T*>(dgx), *o1 = static_cast<T*>(xbuf);
  float *o2 = static_cast<float*>(dwh), *o3 = static_cast<float*>(dbh),
        *o4 = static_cast<float*>(dh0), *o5 = static_cast<float*>(dc0);
  void* args[] = {&geo, &a0, &a1, &a2, &a3, &a4, &a5, &a6,
                  &a7,  &a8, &o0, &o1, &o2, &o3, &o4, &o5};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(g.P), dim3(NT),
                                  args, (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The C entry points' bodies, for one gate count G (4 LSTM, 3 GRU).
// dtype: 0 float32, 1 bfloat16.  All tensors contiguous: gx (T, N, G H)
// and wh (G H, H) in T; h0, c0 (N, H) and bh (G H) float32; ys (T, N, H),
// hT, cT (N, H) in T; with save, acts (T, N, 4 H) and cells (T, N, H)
// float32.  The GRU has no c0, cT or cells (null).
template <int G>
int rnn_fwd_entry(int dtype, const void* gx, const void* h0, const void* c0,
                  const void* wh, const void* bh, void* ys, void* hT,
                  void* cT, void* acts, void* cells, int T, int N, int H,
                  int save, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(G, T, N, H, save);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch_fwd<float, G>(g, gx, h0, c0, wh, bh, ys, hT, cT,
                                          acts, cells, s)
                   : launch_fwd<__nv_bfloat16, G>(g, gx, h0, c0, wh, bh, ys,
                                                  hT, cT, acts, cells, s));
}

// The backward from the forward's residuals: dys (T, N, H), dhT, dcT (N, H)
// in T; outputs dgx (T, N, G H) in T, dwh (G H, H), dbh (G H), dh0, dc0
// (N, H) float32.  The GRU takes xbuf, a (2, N, 3 H) exchange buffer in T;
// the LSTM's is null (its exchange is dgx).
template <int G>
int rnn_bwd_entry(int dtype, const void* acts, const void* cells,
                  const void* ys, const void* h0, const void* c0,
                  const void* wh, const void* dys, const void* dhT,
                  const void* dcT, void* dgx, void* xbuf, void* dwh, void* dbh,
                  void* dh0, void* dc0, int T, int N, int H, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(G, T, N, H, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch_bwd<float, G>(g, acts, cells, ys, h0, c0, wh, dys,
                                          dhT, dcT, dgx, xbuf, dwh, dbh, dh0,
                                          dc0, s)
                   : launch_bwd<__nv_bfloat16, G>(g, acts, cells, ys, h0, c0,
                                                  wh, dys, dhT, dcT, dgx,
                                                  xbuf, dwh, dbh, dh0, dc0,
                                                  s));
}

}  // namespace
