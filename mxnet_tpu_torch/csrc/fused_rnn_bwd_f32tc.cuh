// The fused-LSTM and fused-GRU backward for Hopper (sm_90a) in float32, on
// tensor cores through split-TF32 products, with the recurrent product split
// across a thread-block cluster.  fused_{lstm,gru}_bwd_f32tc.cu instantiate
// rnn_bwd_f32tc_kernel<G> behind their C entry points, one translation unit
// per gate count.
//
// Replaces, for float32, the TPU kernels
//   rnn_bwd_f32tc_kernel<4> <- mxnet_tpu/ops/pallas_lstm.py _bwd_call (:206)
//                              / _bwd_kernel (:148), call :216
//   rnn_bwd_f32tc_kernel<3> <- mxnet_tpu/ops/pallas_gru.py _bwd_call (:161)
//                              / _bwd_kernel (:112), call :169
// and computes what they compute in float32, at their cast points, which
// are all float32 here: dgx is the float32 dgates (the GRU's dn_pre in its
// third block); dbh sums the float32 dgates over the batch; dWh adds one
// product a step, dgates^T h_prev (the GRU's dhp = [dr_pre, dz_pre, dnh]),
// summed over t in the reference's order; dh_{t-1} = X_t Wh with X_t the
// dgates (the GRU's dhp, plus dh z); at t = 0, h_prev = h0 and c_prev = c0.
// bfloat16 runs fused_rnn_bwd_tc.cuh; float32 outside the limits below runs
// rnn_bwd_kernel in fused_rnn.cuh.
//
// What bounds it.  At the language model's shape (T 128, N 32, H 512) the
// backward is 4 T N G H^2 = 17.2 GFLOP (LSTM).  Each product is three TF32
// products (tf32x3.cuh), 51.5 GFLOP: 0.104 ms at the dense TF32 peak of
// 495 TFLOP/s (0.256 ms as float32 FMAs at 67).  The recurrence sets the
// time instead, as in the bf16 kernel: step t - 1 needs dh_{t-1} = X_t Wh
// from every CTA's dgates, so a step is a chain of dependent latencies (the
// cell math, a grid-wide barrier, the exchange of X_t and one product).
//
// The design is the bf16 kernel's (fused_rnn_bwd_tc.cuh), in float32:
//
//  1. The product split by K inside a cluster.  CTA k owns HS = 8 hidden
//     units; clusters of CL = 16 CTAs own 128 consecutive units (64 CTAs in
//     4 clusters at H 512).  Rank r multiplies only its K slice of X_t,
//     KC = G H / 16 rows (128 for the LSTM: 32 x 128 floats, 16 KB from L2
//     a step, where the FMA kernel read all 256 KB of X_t into every CTA),
//     against the cluster's 128 columns of Wh, and sends each owner its
//     N x 8 float32 partial dh into the owner's shared memory (st.async on
//     the owner's mbarrier); the owner sums the 16 partials.
//  2. The products as split-TF32 mma.sync m16n8k8 (tf32x3.cuh): each
//     operand x = big + small, three products summed small terms first,
//     a_small b_big + a_big b_small + a_big b_big.  X_t's slice is split
//     once, as it is staged (every warp reads all of it); the dgates once,
//     as the cell threads store them; Wh and h_prev as each lane reads its
//     B fragment.  A fragments come by ldmatrix (a non-transposed tf32 A
//     fragment is an 8 x 4-word ldmatrix matrix); rows padded to 4 mod 8
//     words (slice, dg^T) or 8 mod 32 (h_prev, read by [k][n] B fragments)
//     keep every read on distinct banks.
//  3. dWh off the serial path, between the split barrier's arrive and its
//     wait (rnn_tc_sync.cuh), as in the bf16 kernel: each warp owns 64
//     columns (8 n-tiles) of the CTA's rows of dWh, and multiplies k-step
//     by k-step with its 8 n-tiles side by side (16 independent
//     accumulator chains; one n-tile at a time left 2 chains and ran
//     slower).  dbh: each cell thread sums its dgates over t, and the batch
//     is summed once, after the last step.
//  4. The tensor core's float32 accumulation truncates (flash_dkv_f32tc.cu,
//     trouble 5).  So no accumulator chains many products: dh's partial is
//     summed from zero in groups of KG k-steps (12 products) and the groups
//     are added by float32 adds; each step's dWh product (K = the batch, 12
//     products) is summed from zero and added into the running sums by
//     float32 adds, as the reference adds one product a step.
//  5. Prefetch.  The residuals of step t - 1 (activations, cells, c_prev or
//     h_prev, dys) are loaded into registers a step ahead; each warp
//     refills its own h_prev columns for step t - 1 by 16-byte cp.async
//     copies as soon as it has finished step t's dWh product with them,
//     and waits for its own copies only, so no barrier orders the buffer.
//
// The budget.  In float32 three objects of 64 KiB each compete: the
// cluster's Wh columns over the CTA's K slice (128 x 128 floats), the dWh
// sums (32 x 512) and h_prev (32 x 512).  The bf16 kernel kept Wh and dWh
// in registers and two halves of h_prev in shared memory.  Here:
//   - Wh stays in registers as float32 (64 registers at G 4, 48 at G 3)
//     and is split as it is read, 4 integer and float instructions an
//     element on the chain.  An empty asm keeps the compiler from hoisting
//     that loop-invariant split out of the step loop: held split (128
//     registers) it spilled ~400 bytes at G 4 and ran slower;
//   - the dWh sums live in shared memory, in fragment order (each lane's
//     16 x 4 floats in 16-byte chunks), read, added to and written back
//     once a step in the window: 32 16-byte accesses a lane, off the chain;
//   - one h_prev buffer, each warp's columns its own (item 5).
// At (N 32, H 512, G 4) that is 195,600 bytes of shared memory (tc32_geo),
// one CTA an SM, and 252 registers without spills (233 at G 3).  A
// 512-thread CTA holding Wh and dWh in registers would have 128 registers
// a thread, too few for 96 of state.
//
// What is left.  A step does 3072 mma.sync a CTA: 1536 for dh on the chain
// and 1536 for dWh in the window, which outlasts the barrier.  Both are
// bound by the tensor pipe's mma.sync TF32 rate; wgmma (a warpgroup's
// 64-row products at the full TF32 rate) is the next step, not taken here.
//
// Barriers, co-residency and hang-proofing are rnn_tc_sync.cuh's: a
// cluster launch with the cooperative attribute, checked beforehand by
// cudaOccupancyMaxActiveClusters (cudaErrorCooperativeLaunchTooLarge when
// the clusters do not fit; no fallback).  A grid padded to a multiple of 16
// has CTAs without units: they arrive, wait, load their slice and send
// their partials like the others.  Values other CTAs wrote in this kernel
// (dgx, xbuf) are read with ld.global.cg only, from L2.
//
// Limits (the wrapper's rule, ops/fused_rnn_cuda.py _bwd_variant, states
// them in closed form, tc32_smem_bytes): float32; 1 <= N <= 32 (two m16
// tiles of the batch, four k8 steps of dWh's K); H a multiple of 8 and at
// most 512 (Wh's fragments: 16 k-steps a warp; dWh: 64 columns a warp);
// the shared memory of tc32_geo within a block's 227 KB (it is at every
// such shape).  Anything else returns cudaErrorInvalidValue without running.

#pragma once

#include "rnn_tc_sync.cuh"
#include "tf32x3.cuh"

namespace rnn_tc {
namespace {   // internal to each translation unit
namespace f32 {

constexpr int MAX_N = 32;           // batch rows: two m16 tiles
constexpr int MAX_H = 512;          // dWh: 64 columns a warp
constexpr int NPW = MAX_H / NW / 8; // dWh n-tiles a warp: 8
constexpr int KG = 4;               // dh k-steps summed from zero

struct Geo {
  int T, N, H, G;
  int P;        // CTAs with units: ceil(H / HS)
  int MT;       // m16 tiles of the batch (dh's M)
  int KB;       // k8 steps of the batch (dWh's K)
  int KC;       // rows of K a CTA: G H / 16, padded to 8
  int LDT;      // slice row stride: KC + 4 floats
  int LDH;      // h_prev row stride: H padded to 32, + 8 floats
  int LDG;      // dg^T row stride: 8 KB + 4 floats
  int bytes;    // the partials one CTA receives a step
  // byte offsets into dynamic shared memory
  int o_ts, o_h, o_w, o_gb, o_gs, o_xs, o_recv, o_bar, total;
};

// The layout, in bytes (every piece 16-byte aligned):
//   tb, ts [16 MT][LDT] u32       the slice of X_t, split: big, small
//   h      [8 KB][LDH] float      h_prev, 64 columns a warp
//   w      [NW][NPW][2][32][4]    the dWh sums in fragment order
//   gb, gs [32][LDG] u32          the CTA's dgates transposed (gate rows
//                                 x batch), split: big, small
//   xs     [N][G][HS] float       the CTA's part of X_t, staged for 16-byte
//                                 stores
//   recv   [CL][16 MT][8] float   the cluster's partial dh of the CTA's
//                                 units
//   bar    the partials' mbarrier (8 bytes, padded to 16)
__host__ __device__ inline Geo tc32_geo(int G, int T, int N, int H) {
  Geo g;
  g.T = T, g.N = N, g.H = H, g.G = G;
  g.P = cdiv(H, HS);
  g.MT = cdiv(N, 16);
  g.KB = cdiv(N, 8);
  g.KC = up(cdiv(G * H, CL), 8);
  g.LDT = g.KC + 4;
  g.LDH = up(H, 32) + 8;
  g.LDG = 8 * g.KB + 4;
  g.bytes = CL * 16 * g.MT * 8 * 4;
  g.o_ts = 16 * g.MT * g.LDT * 4;
  g.o_h = 2 * g.o_ts;
  g.o_w = g.o_h + 8 * g.KB * g.LDH * 4;
  g.o_gb = g.o_w + NW * NPW * 2 * 32 * 4 * 4;
  g.o_gs = g.o_gb + 32 * g.LDG * 4;
  g.o_xs = g.o_gs + 32 * g.LDG * 4;
  g.o_recv = g.o_xs + N * G * HS * 4;
  g.o_bar = g.o_recv + g.bytes;
  g.total = g.o_bar + 16;
  return g;
}

inline bool tc32_geo_ok(const Geo& g) {
  return g.T >= 1 && g.N >= 1 && g.N <= MAX_N && g.H >= 8 &&
         g.H <= MAX_H && g.H % 8 == 0 && g.total <= SMEM_MAX;
}

__device__ __forceinline__ void split4(const float4& v, uint4& b, uint4& s) {
  tf32x3::split(v.x, b.x, s.x);
  tf32x3::split(v.y, b.y, s.y);
  tf32x3::split(v.z, b.z, s.z);
  tf32x3::split(v.w, b.w, s.w);
}

// c += a b in three TF32 products, small terms first (tf32x3::mma3 over
// fragments held as separate big and small words)
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4],
                                     const uint32_t as[4],
                                     const uint32_t bb[2],
                                     const uint32_t bs[2]) {
  tf32x3::mma(c, as, bb);
  tf32x3::mma(c, ab, bs);
  tf32x3::mma(c, ab, bb);
}

// -- the kernel ---------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(NT, 1)
    rnn_bwd_f32tc_kernel(Geo g, const float* __restrict__ acts,
                         const float* __restrict__ cells,
                         const float* __restrict__ ys,
                         const float* __restrict__ h0,
                         const float* __restrict__ c0,
                         const float* __restrict__ wh,
                         const float* __restrict__ dys,
                         const float* __restrict__ dhT,
                         const float* __restrict__ dcT, float* dgx,
                         float* xbuf, float* dwh, float* dbh, float* dh0,
                         float* dc0, unsigned* ctr) {
  constexpr int R = G * HS;                  // the CTA's rows of dWh
  constexpr int NTW = CL * HS / 8 / NW;      // dh n-tiles a warp: 2
  constexpr int MAX_KS = G * MAX_H / CL / 8; // dh k-steps a CTA: 16 or 12
  static_assert(R <= 32, "two m16 tiles of dWh rows");
  static_assert(NTW >= 1 && NTW * NW * 8 == CL * HS, "one owner an n-tile");
  static_assert(MAX_KS % KG == 0, "whole groups");
  extern __shared__ __align__(16) unsigned char sm[];
  uint32_t* tb = reinterpret_cast<uint32_t*>(sm);
  uint32_t* ts = reinterpret_cast<uint32_t*>(sm + g.o_ts);
  float* hbuf = reinterpret_cast<float*>(sm + g.o_h);
  float4* dws = reinterpret_cast<float4*>(sm + g.o_w);
  uint32_t* gb = reinterpret_cast<uint32_t*>(sm + g.o_gb);
  uint32_t* gs = reinterpret_cast<uint32_t*>(sm + g.o_gs);
  float* xs = reinterpret_cast<float*>(sm + g.o_xs);
  float* recv = reinterpret_cast<float*>(sm + g.o_recv);
  const uint32_t bar_s = tc::smem_addr(sm + g.o_bar);   // the partials
  const uint32_t recv_s = tc::smem_addr(recv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // mma fragment row, column
  const int H = g.H, N = g.N, GH = G * H, MT = g.MT, KB = g.KB;
  const uint32_t crank = cluster_rank();
  const int j0 = blockIdx.x * HS;            // the CTA's units
  const int hs = max(0, min(HS, H - j0));    // 0: a CTA of the padding
  const int cbase = (blockIdx.x - crank) * HS;   // the cluster's first unit
  const int k0 = crank * g.KC;               // the CTA's slice of K
  const SplitBarrier bar{ctr, crank == 0 && warp == 0};
  const unsigned nclusters = gridDim.x / CL;
  const int wc0 = 64 * warp;                 // the warp's dWh columns
  const int wcols = max(0, min(64, H - wc0));
  const bool dw_warp = hs && wcols;

  for (int i = tid; i < g.total / 16; i += NT)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) mbar_init(bar_s, 1);

  // B fragments of the dh product as float32, for the whole sequence (split
  // as they are read): n-tile o = warp NTW + i (the units of rank o),
  // k-steps of the slice (b0 = B[t][g], b1 = B[t+4][g], B[k][n] =
  // Wh[k0 + k][cbase + 8 o + n]; zero past G H, past the slice and past H)
  uint32_t wr[NTW][MAX_KS][2];
  {
    const int kend = min(GH, k0 + g.KC);
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int col = cbase + 8 * (warp * NTW + i) + gq;
#pragma unroll
      for (int ks = 0; ks < MAX_KS; ++ks)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + 8 * ks + tq + 4 * e;
          const float w =
              (col < H && k < kend) ? wh[(long long)k * H + col] : 0.f;
          wr[i][ks][e] = __float_as_uint(w);
        }
    }
  }

  // this thread's cell (batch row cn, unit j) in the dgates phase, and its
  // carries: dh, and dc (LSTM) or dh z (GRU)
  const int cn = tid / HS, cj = tid % HS, j = j0 + cj;
  const bool cell = cn < N && cj < hs;
  float c1 = 0.f, c2 = 0.f;
  float dbq[G];                // the cell's dgates summed over t (for dbh)
#pragma unroll
  for (int q = 0; q < G; ++q) dbq[q] = 0.f;
  if (cell) {
    c1 = dhT[(long long)cn * H + j];
    if (G == 4) c2 = dcT[(long long)cn * H + j];
  }

  // the next step's residuals, loaded a step ahead
  float pa[4] = {0.f, 0.f, 0.f, 0.f}, pc = 0.f, pcp = 0.f, pd = 0.f,
        ph = 0.f;
  auto prefetch = [&](int t) {
    if (!cell) return;
    const long long row = (long long)t * N + cn;
    const float* a = acts + row * 4 * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) pa[q] = a[q * H + j];
    pd = dys[row * H + j];
    if (G == 4) {
      pc = cells[row * H + j];
      pcp = t ? cells[(row - N) * H + j] : c0[(long long)cn * H + j];
    } else {
      ph = t ? ys[(row - N) * H + j] : h0[(long long)cn * H + j];
    }
  };
  // this warp's columns of h_prev of step t (ys[t-1], or h0 at t = 0),
  // once the warp has read them: 16-byte cp.async copies into the warp's
  // own columns (rows past N stay zero), waited for by the warp itself
  auto load_h = [&](int t) {
    const float* src = t ? ys + (long long)(t - 1) * N * H : h0;
    const int c4 = wcols / 4;                // 16-byte chunks a row
    __syncwarp();
    for (int c = lane; c < N * c4; c += 32) {
      const int n = c / c4, cc = c - n * c4;
      tc::cp_async16(tc::smem_addr(hbuf + n * g.LDH + wc0 + 4 * cc),
                     src + (long long)n * H + wc0 + 4 * cc, true);
    }
    tc::cp_async_commit();
  };

  // dWh += dg^T h_prev of step t over this warp's n-tiles, once its
  // h_prev columns have landed: k-steps outer (dg^T's split fragments of
  // one k-step live at a time), the n-tiles' products summed from zero side
  // by side (16 independent accumulator chains), then added to the sums;
  // then the warp's h_prev columns of step t-1
  auto window = [&](int t) {
    if (!dw_warp) return;
    tc::cp_async_wait<0>();
    __syncwarp();
    const uint32_t gbs = tc::smem_addr(gb), gss = tc::smem_addr(gs);
    float acc[NPW][2][4] = {};
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb >= KB) break;
      uint32_t ab[2][4], as[2][4];          // [m16 tile]
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t off =
            ((16 * m + (lane & 15)) * g.LDG + 8 * kb + 4 * (lane >> 4)) * 4;
        tc::ldmatrix_x4(ab[m], gbs + off);
        tc::ldmatrix_x4(as[m], gss + off);
      }
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int col = wc0 + 8 * i + gq;
        if (8 * i >= wcols) break;
        const float x[2] = {hbuf[(8 * kb + tq) * g.LDH + col],
                            hbuf[(8 * kb + tq + 4) * g.LDH + col]};
        uint32_t bb[2], bs[2];
        tf32x3::split(x[0], bb[0], bs[0]);
        tf32x3::split(x[1], bb[1], bs[1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3(acc[i][m], ab[m], as[m], bb, bs);
      }
    }
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      if (8 * i >= wcols) break;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float4* p = dws + ((warp * NPW + i) * 2 + m) * 32 + lane;
        float4 v = *p;
        v.x += acc[i][m][0], v.y += acc[i][m][1], v.z += acc[i][m][2],
            v.w += acc[i][m][3];
        *p = v;
      }
    }
    if (t > 0) load_h(t - 1);
  };

  prefetch(g.T - 1);
  if (tid == 0) mbar_expect(bar_s, g.bytes);     // the first step's phase
  cluster_arrive_release();                 // every peer has started, and
  cluster_wait();                           // its mbarriers are initialised
  if (dw_warp) load_h(g.T - 1);

  unsigned target = 0;
  for (int t = g.T - 1; t >= 0; --t) {
    // (1) the CTA's dgates from the prefetched residuals
    float* xt = G == 4 ? dgx + (long long)t * N * GH
                       : xbuf + (long long)(t & 1) * N * GH;
    if (cell) {
      const float dh = c1 + pd;
      float x[G];
      if (G == 4) {
        const float i = pa[0], f = pa[1], gg = pa[2], og = pa[3];
        const float tc_ = tanhf(pc);
        const float dO = dh * tc_;
        const float dc = c2 + dh * og * (1.f - tc_ * tc_);
        x[0] = dc * gg * i * (1.f - i);
        x[1] = dc * pcp * f * (1.f - f);
        x[2] = dc * i * (1.f - gg * gg);
        x[G - 1] = dO * og * (1.f - og);
        c2 = dc * f;
      } else {
        const float r = pa[0], z = pa[1], nn = pa[2], nh = pa[3];
        const float dz = dh * (ph - nn);
        const float dn = dh * (1.f - z);
        const float dnp = dn * (1.f - nn * nn);
        const float dr = dnp * nh;
        x[0] = dr * r * (1.f - r);
        x[1] = dz * z * (1.f - z);
        x[2] = dnp * r;                     // dnh: dhp = [dr_pre, dz_pre, dnh]
        float* dxr = dgx + ((long long)t * N + cn) * GH;
        dxr[0 * H + j] = x[0];
        dxr[1 * H + j] = x[1];
        dxr[2 * H + j] = dnp;
        c2 = dh * z;
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        uint32_t b, s;
        tf32x3::split(x[q], b, s);
        xs[(cn * G + q) * HS + cj] = x[q];   // X_t (the LSTM's dgx[t])
        gb[(q * HS + cj) * g.LDG + cn] = b;
        gs[(q * HS + cj) * g.LDG + cn] = s;
        dbq[q] += x[q];
      }
    }
    __syncthreads();              // X_t staged; dg^T and the dgates complete
    // the CTA's part of X_t in 16-byte stores (two a row of 8 units), one
    // fence each, then the arrive
    if (hs && tid < N * G * 2) {
      const int rw = tid >> 1, n = rw / G, q = rw - n * G;
      *reinterpret_cast<float4*>(xt + (long long)n * GH + q * H + j0 +
                                 4 * (tid & 1)) =
          *reinterpret_cast<const float4*>(xs + tid * 4);
      fence_gpu();
    }
    bar.arrive();

    // (2) off the chain, until the wait: the next step's residuals, and
    // dWh += dg^T h_prev
    if (t > 0) prefetch(t - 1);
    window(t);
    target += nclusters;
    bar.wait(target);

    // (3) this CTA's slice of X_t from L2 (at most N KC / 4 <= 4 NT 16-byte
    // loads, four a thread, all in flight), split as it is staged
    {
      const int kc4 = g.KC / 4, nch = N * kc4;
      float4 v[4];
      int off[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        off[i] = -1;
        const int c = tid + i * NT;
        if (c < nch) {
          const int n = c / kc4, cc = c - n * kc4;
          if (k0 + 4 * cc < GH) {
            v[i] = __ldcg(reinterpret_cast<const float4*>(
                xt + (long long)n * GH + k0 + 4 * cc));
            off[i] = n * g.LDT + 4 * cc;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (off[i] >= 0) {
          uint4 b, s;
          split4(v[i], b, s);
          *reinterpret_cast<uint4*>(tb + off[i]) = b;
          *reinterpret_cast<uint4*>(ts + off[i]) = s;
        }
    }
    __syncthreads();

    // (4) the partial dh of the cluster's units over the slice, in groups
    // of KG k-steps each summed from zero, each n-tile sent to the CTA
    // that owns its 8 units
    {
      float part[2][NTW][4] = {};
      const uint32_t tbs = tc::smem_addr(tb), tss = tc::smem_addr(ts);
#pragma unroll
      for (int kg = 0; kg < MAX_KS; kg += KG) {
        if (kg * 8 >= g.KC) break;
        float acc[2][NTW][4] = {};
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
          const int ks = kg + kk;
          if (ks * 8 >= g.KC) break;
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT) {
              const uint32_t off = ((16 * m + (lane & 15)) * g.LDT + 8 * ks +
                                    4 * (lane >> 4)) * 4;
              tc::ldmatrix_x4(ab[m], tbs + off);
              tc::ldmatrix_x4(as[m], tss + off);
            }
#pragma unroll
          for (int i = 0; i < NTW; ++i) {
            // Wh's fragment, split as it is read: the empty asm keeps the
            // compiler from hoisting the split out of the step loop (which
            // would hold both halves in registers for the whole sequence)
            uint32_t bb[2], bs[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              uint32_t w = wr[i][ks][e];
              asm volatile("" : "+r"(w));
              tf32x3::split(__uint_as_float(w), bb[e], bs[e]);
            }
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (m < MT) mma3(acc[m][i], ab[m], as[m], bb, bs);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < NTW; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][i][e] += acc[m][i][e];
      }
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const uint32_t o = warp * NTW + i;
        const uint32_t rr = map_rank(recv_s, o), rb = map_rank(bar_s, o);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (m < MT)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = (crank * MT + m) * 16 + gq + 8 * e;
              st_async2(rr + (row * 8 + 2 * tq) * 4, part[m][i][2 * e],
                        part[m][i][2 * e + 1], rb);
            }
      }
    }

    // (5) the cluster's partials of this CTA's units: dh_{t-1}
    mbar_wait(bar_s, (g.T - 1 - t) & 1);
    if (tid == 0 && t > 0) mbar_expect(bar_s, g.bytes);   // the next phase
    if (cell) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < CL; ++r)
        v[r & 3] += recv[(r * 16 * MT + cn) * 8 + cj];
      const float s = (v[0] + v[1]) + (v[2] + v[3]);
      c1 = G == 4 ? s : c2 + s;
    }
  }

  // dh0, dc0, and the CTA's rows of dbh and dWh, all float32
  if (cell) {
    dh0[(long long)cn * H + j] = c1;
    if (G == 4) dc0[(long long)cn * H + j] = c2;
  }
  // dbh: each cell's sums over t, summed over the batch (the 4 rows of a
  // warp by shuffles, then the 8 warps in order through recv, which no
  // peer writes after the last step)
  __syncthreads();                          // the last step's recv is read
#pragma unroll
  for (int q = 0; q < G; ++q) {
    dbq[q] += __shfl_xor_sync(0xffffffffu, dbq[q], 8);
    dbq[q] += __shfl_xor_sync(0xffffffffu, dbq[q], 16);
    if (lane < HS) recv[(warp * G + q) * HS + lane] = dbq[q];
  }
  __syncthreads();
  if (tid < G * HS) {
    const int q = tid / HS, jl = tid - q * HS;
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += recv[(w * G + q) * HS + jl];
    if (jl < hs) dbh[q * H + j0 + jl] = s;
  }
  if (dw_warp) {
    for (int i = 0; i < NPW; ++i) {
      if (8 * i >= wcols) break;
      const int col = wc0 + 8 * i + 2 * tq;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float4 v = dws[((warp * NPW + i) * 2 + m) * 32 + lane];
        const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lr = 16 * m + gq + 8 * e;
          const int q = lr / HS, jl = lr - q * HS;
          if (q < G && jl < hs)
            *reinterpret_cast<float2*>(
                dwh + (long long)(q * H + j0 + jl) * H + col) =
                make_float2(c[2 * e], c[2 * e + 1]);
        }
      }
    }
  }
}

// The C entry points' body for one gate count.  Tensors as rnn_bwd_entry's
// (fused_rnn.cuh), float32 only, every one contiguous, ys and h0 16-byte
// aligned (their rows are bulk-copied); ctr one zeroed unsigned; info
// receives (cluster size, grid CTAs, shared-memory bytes) of the launch.
template <int G>
int rnn_bwd_f32tc_entry(const void* acts, const void* cells, const void* ys,
                        const void* h0, const void* c0, const void* wh,
                        const void* dys, const void* dhT, const void* dcT,
                        void* dgx, void* xbuf, void* dwh, void* dbh,
                        void* dh0, void* dc0, void* ctr, int T, int N, int H,
                        int* info, void* stream) {
  Geo g = tc32_geo(G, T, N, H);
  info[0] = CL, info[1] = up(g.P, CL), info[2] = g.total;
  const float *a0 = static_cast<const float*>(acts),
              *a1 = static_cast<const float*>(cells),
              *a2 = static_cast<const float*>(ys),
              *a3 = static_cast<const float*>(h0),
              *a4 = static_cast<const float*>(c0),
              *a5 = static_cast<const float*>(wh),
              *a6 = static_cast<const float*>(dys),
              *a7 = static_cast<const float*>(dhT),
              *a8 = static_cast<const float*>(dcT);
  float *o0 = static_cast<float*>(dgx), *o1 = static_cast<float*>(xbuf),
        *o2 = static_cast<float*>(dwh), *o3 = static_cast<float*>(dbh),
        *o4 = static_cast<float*>(dh0), *o5 = static_cast<float*>(dc0);
  unsigned* o6 = static_cast<unsigned*>(ctr);
  void* args[] = {&g,  &a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7,
                  &a8, &o0, &o1, &o2, &o3, &o4, &o5, &o6};
  if (!tc32_geo_ok(g)) return (int)cudaErrorInvalidValue;
  return (int)tc_launch(rnn_bwd_f32tc_kernel<G>, up(g.P, CL), g.total, args,
                        static_cast<cudaStream_t>(stream));
}

}  // namespace f32
}  // namespace
}  // namespace rnn_tc
