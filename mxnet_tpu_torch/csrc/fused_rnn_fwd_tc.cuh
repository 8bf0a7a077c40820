// The fused-LSTM and fused-GRU forward for Hopper (sm_90a) on bf16 tensor
// cores, with h_{t-1} multicast across a thread-block cluster.
// fused_{lstm,gru}_fwd_tc.cu instantiate rnn_fwd_tc_kernel<G> behind their
// C entry points, one translation unit per gate count.
//
// Replaces, for bfloat16, the TPU kernels
//   rnn_fwd_tc_kernel<4> <- mxnet_tpu/ops/pallas_lstm.py _fwd (:102) /
//                           _fwd_kernel (:57), call :126
//   rnn_fwd_tc_kernel<3> <- mxnet_tpu/ops/pallas_gru.py _fwd (:79) /
//                           _fwd_kernel (:43), call :94
// and computes what they compute, at the same cast points: the recurrent
// product takes h_{t-1} and Wh in bf16 and sums in float32 (h_{t-1} is h0
// rounded to bf16 at t = 0, else ys[t-1]); the gates add gx (bf16) and bh
// (float32) in float32; the carried state (c for the LSTM, h for the
// GRU's z h) stays float32; ys, hT and cT are bf16; the saved activations
// (T, N, 4 H: i, f, g, o or r, z, n, hp_n) and cells (T, N, H) are
// float32, and without `save` nothing of them is written.  float32 (and
// every geometry outside the limits below) runs rnn_fwd_kernel in
// fused_rnn.cuh.
//
// What bounds it.  At the language model's shape (T 128, N 32, H 512) the
// forward is 2 T N G H^2 = 8.6 GFLOP and ~26 MB: ~0.02 ms on the card.
// The recurrence sets the time instead: step t needs all of h_{t-1}, made
// by every CTA, so each step is a chain of dependent latencies: a
// grid-wide barrier, the exchange of h_{t-1}, one small product and the
// cell math.  The design shortens that chain:
//
//  1. Wh on the tensor cores, in registers.  CTA k owns HS = 8 hidden units
//     (all G gates: G 8 output columns, one m16n8k16 n-tile a gate) and the
//     grid runs in clusters of CL = 16 CTAs (at H 512, 64 CTAs: 4
//     clusters).  The product gates[n][q 8 + jl] = h_{t-1}[n, :] .
//     Wh[q H + j0 + jl, :] is split over the 8 warps by m-tile and by K:
//     warp w takes m-tile w % 2 and the k-steps w / 2 + 4 i (i < 8) of 16
//     columns (128 of H 512), and keeps their B fragments of all G n-tiles
//     in registers for the whole sequence (G 8 2 = 64 registers for the
//     LSTM); a step is then G n-tiles x 8 k-steps = 32 mma.sync a warp on
//     8 ldmatrix, and the 4 K-quarters' float32 partials are summed through
//     shared memory by the cell threads.  Split by K alone over the 8
//     warps (both m-tiles a warp, 32 B registers), the partials' shared-
//     memory traffic doubles, and a one-off comparison on the H100 found
//     the step slower.  Split by (m, n) instead, each warp over the full K,
//     a warp would read its m-tile's whole row (4x the ldmatrix of the
//     operand a CTA) and run a 32-deep dependent mma chain.
//  2. h_{t-1} multicast once per cluster, in bf16.  After the barrier of
//     step t-1, rank r of each cluster issues one bulk copy of each row
//     n = r (mod 16) of ys[t-1] with .multicast::cluster to all 16 CTAs:
//     the row lands at the same offset of every CTA's shared memory (rows
//     of H + 8 bf16, so the 8 rows of an ldmatrix hit 8 bank groups) and
//     completes on each CTA's mbarrier, armed for N H 2 bytes.  A cluster
//     reads ys[t-1] from L2 once a step (4 x 32 KB at H 512, against 128
//     x 32 KB for the old kernel), and no thread widens it: ldmatrix reads
//     it as the A operand.  The tile and its mbarrier are double-buffered
//     by the parity of t: a rank writes step t+1's half only after the
//     barrier of step t, which every peer reaches after its product of
//     step t-1 consumed that half, and after its own wait on that half's
//     previous phase (bytes may land before the local expect, within one
//     phase, never after a completed one).  At t = 0 each CTA writes h0,
//     rounded to bf16, itself and arrives once.
//  3. One cell a thread, its state in a register.  At N 32 and HS 8 the
//     256 cells of a CTA are its 256 threads: thread (n, jl) sums its G
//     gates over the 4 partials, keeps c (or h) in float32 across the
//     sequence, and holds its G bh values; the next step's G gx values are
//     loaded during the barrier wait.
//  4. Only h_t on the chain.  A batch row's 8 units of h_t (16 bytes of
//     bf16) are staged in shared memory and written to ys[t] as N 16-byte
//     stores by the first N threads, which fence once at gpu scope and
//     arrive at the split barrier (rnn_tc_sync.cuh); 2-byte stores from
//     every cell would put 256 stores in flight before the fence, whose
//     cost grows with them and with the fencing warps (every warp storing
//     and fencing its own 4 rows was slower on the H100).  Between arrive
//     and wait every cell writes its residuals (acts, cells; hT, cT at
//     t = T-1): they are off the chain.
//
// Proxies.  ys[t] is written by generic stores and read, after the
// barrier, by the bulk-copy engine (the async proxy) of other CTAs; the
// issuing thread fences the proxies (fence.proxy.async) after its acquire,
// which also orders the peers' ldmatrix reads of the half it overwrites.
// No ys row written in this kernel is read through LDG.NC or L1.
//
// Co-residency.  A cooperative cluster launch (rnn_tc_sync.cuh tc_launch,
// cudaErrorCooperativeLaunchTooLarge when the clusters do not fit).  A
// grid padded to a multiple of 16 has CTAs without units: they wait on
// their mbarriers, arrive, wait at the barrier and issue their rank's
// multicast rows like the others, and skip the product and the stores.
// A last cluster barrier keeps every CTA resident until no peer's copy
// can still target it.
//
// Limits (the wrapper's rule, ops/fused_rnn_cuda.py _fwd_variant, states
// them in closed form): bfloat16; 1 <= N <= 32 (two m16 tiles); H a
// multiple of 8 (16-byte rows; every CTA with units has all 8) and at most
// 512 (8 k-steps a warp); the shared memory of fwd_geo within a block's
// 227 KB.  Anything else returns cudaErrorInvalidValue without running.

#pragma once

#include "rnn_tc_sync.cuh"
#include "tc_tile.cuh"

namespace rnn_tc {
namespace {   // internal to each translation unit

constexpr int FWD_MAX_N = 32;     // batch rows: at most two m16 tiles
constexpr int FWD_MAX_H = 512;    // the product: 4 K-quarters of 8 k-steps
constexpr int FWD_KQ = NW / 2;    // K-quarters: a warp is (m-tile, quarter)
constexpr int FWD_KSW = FWD_MAX_H / 16 / FWD_KQ;   // k-steps a warp: 8
constexpr int RS = 40;            // row stride of the partials (floats):
                                  // the 4 rows a warp's cells read hit
                                  // 4 different groups of 8 banks

struct FwdGeo {
  int T, N, H, save;
  int P;        // CTAs with units: H / HS
  int MT;       // m16 tiles of the batch
  int KS;       // k-steps of the product: ceil(H / 16)
  int LDH;      // h tile row stride: H padded to 16, + 8 elements
  // byte offsets into dynamic shared memory
  int o_red, o_st, o_bar, total;
};

// The layout, in bytes (every piece 16-byte aligned):
//   h    [2][16 MT][LDH] bf16   h_{t-1} by the parity of t
//   red  [KQ][16 MT][RS] float  each K-quarter's partial gate sums
//   st   [N][HS] bf16           h_t of the CTA's units, staged for 16-byte
//                               stores
//   bar  two mbarriers: the h halves'
__host__ __device__ inline FwdGeo fwd_geo(int T, int N, int H, int save) {
  FwdGeo g;
  g.T = T, g.N = N, g.H = H, g.save = save;
  g.P = cdiv(H, HS);
  g.MT = cdiv(N, 16);
  g.KS = cdiv(H, 16);
  g.LDH = up(H, 16) + 8;
  g.o_red = 2 * 16 * g.MT * g.LDH * 2;
  g.o_st = g.o_red + FWD_KQ * 16 * g.MT * RS * 4;
  g.o_bar = g.o_st + N * HS * 2;
  g.total = g.o_bar + 16;
  return g;
}

inline bool fwd_geo_ok(const FwdGeo& g) {
  return g.T >= 1 && g.N >= 1 && g.N <= FWD_MAX_N && g.H >= 8 &&
         g.H <= FWD_MAX_H && g.H % 8 == 0 && g.total <= SMEM_MAX;
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// -- the kernel ---------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(NT, 1)
    rnn_fwd_tc_kernel(FwdGeo g, const bf16* __restrict__ gx,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const bf16* __restrict__ wh,
                      const float* __restrict__ bh, bf16* ys, bf16* hT,
                      bf16* cT, float* acts, float* cells, unsigned* ctr) {
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* hbuf = reinterpret_cast<bf16*>(sm);
  float* red = reinterpret_cast<float*>(sm + g.o_red);
  bf16* st = reinterpret_cast<bf16*>(sm + g.o_st);
  const uint32_t bar0 = tc::smem_addr(sm + g.o_bar);   // half b's: + 8 b
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // mma fragment row, column pair
  const int mw = warp & 1, kq = warp >> 1;   // the warp's m-tile, K-quarter
  const int H = g.H, N = g.N, GH = G * H, MT = g.MT, LDH = g.LDH;
  const uint32_t crank = cluster_rank();
  const int j0 = blockIdx.x * HS;            // the CTA's units
  const bool units = j0 < H;                 // false: a CTA of the padding
  const SplitBarrier bar{ctr, crank == 0 && warp == 0};
  const unsigned nclusters = gridDim.x / CL;
  const int hstride = 16 * MT * LDH;         // elements of one h half
  const int rstride = 16 * MT * RS;          // floats of a quarter's partials
  const unsigned hbytes = N * H * 2;         // a step's multicast bytes

  for (int i = tid; i < g.total / 16; i += NT)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) mbar_init(bar0, 1), mbar_init(bar0 + 8, 1);

  // B fragments of this warp's k-steps, for the whole sequence: n-tile q
  // (gate q of the CTA's units), k-step kq + KQ i (b0 = B[2t, 2t+1][g],
  // b1 = B[2t+8, 2t+9][g], B[k][n] = Wh[q H + j0 + n][k]; zero past H)
  uint32_t bw[G][FWD_KSW][2];
  {
    const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const bf16* wr = wh + (long long)(q * H + j0 + gq) * H;
#pragma unroll
      for (int i = 0; i < FWD_KSW; ++i) {
        bf16 w[4] = {zero, zero, zero, zero};
        const int k = 16 * (kq + FWD_KQ * i) + 2 * tq;
        const int kk[4] = {k, k + 1, k + 8, k + 9};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (units && kk[e] < H) w[e] = wr[kk[e]];
        bw[q][i][0] = pack2(w[0], w[1]);
        bw[q][i][1] = pack2(w[2], w[3]);
      }
    }
  }

  // this thread's cell (batch row cn, unit j): its float32 state (c, or
  // the GRU's h), its bh, and gx of the step ahead
  const int cn = tid / HS, cj = tid % HS, j = j0 + cj;
  const bool cell = units && cn < N;
  float s = 0.f, bq[G], xq[G];
#pragma unroll
  for (int q = 0; q < G; ++q) bq[q] = xq[q] = 0.f;
  if (cell) {
    s = (G == 4 ? c0 : h0)[(long long)cn * H + j];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      bq[q] = bh[q * H + j];
      xq[q] = __bfloat162float(gx[(long long)cn * GH + q * H + j]);
    }
  }

  // step 0's operand: h0 rounded to bf16 into half 0, one arrival
  for (int i = tid; i < N * H; i += NT) {
    const int n = i / H, k = i - n * H;
    hbuf[n * LDH + k] = __float2bfloat16_rn(h0[i]);
  }
  __syncthreads();
  if (tid == 0) mbar_arrive(bar0);
  cluster_arrive_release();                 // every peer has started, and
  cluster_wait();                           // its mbarriers are initialised

  unsigned target = 0;
  for (int t = 0; t < g.T; ++t) {
    const int b = t & 1;
    const bool more = t + 1 < g.T;
    // (1) h_{t-1} in half b; then arm step t+1's phase of the other half,
    // whose previous phase (step t-1) this CTA has seen complete
    mbar_wait(bar0 + 8 * b, (t >> 1) & 1);
    if (tid == 0 && more) mbar_expect(bar0 + 8 * (b ^ 1), hbytes);

    // (2) this warp's partial gate sums: its m-tile over its K-quarter
    if (units && mw < MT) {
      const uint32_t hb = tc::smem_addr(hbuf + b * hstride);
      uint32_t a[FWD_KSW][4];
#pragma unroll
      for (int i = 0; i < FWD_KSW; ++i) {
        const int ks = kq + FWD_KQ * i;
        if (ks < g.KS)
          tc::ldmatrix_x4(a[i], hb + ((16 * mw + (lane & 15)) * LDH +
                                      16 * ks + 8 * (lane >> 4)) * 2);
      }
      float acc[G][4];
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
      for (int i = 0; i < FWD_KSW; ++i)
        if (kq + FWD_KQ * i < g.KS)
#pragma unroll
          for (int q = 0; q < G; ++q)
            tc::mma_bf16(acc[q], a[i], bw[q][i][0], bw[q][i][1]);
      float* rw = red + kq * rstride;
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(
              rw + (16 * mw + gq + 8 * e) * RS + 8 * q + 2 * tq) =
              make_float2(acc[q][2 * e], acc[q][2 * e + 1]);
    }
    __syncthreads();

    // (3) the cell: gates in float32 from the partials, gx and bh
    float h = 0.f, act[4] = {0.f, 0.f, 0.f, 0.f};
    if (cell) {
      float o[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < FWD_KQ; ++w)
          v += red[w * rstride + cn * RS + 8 * q + cj];
        o[q] = v;
      }
      if (G == 4) {
        // gates = gx + h Wh^T + bh
        act[0] = sigm(xq[0] + o[0] + bq[0]);
        act[1] = sigm(xq[1] + o[1] + bq[1]);
        act[2] = tanhf(xq[2] + o[2] + bq[2]);
        act[3] = sigm(xq[G - 1] + o[G - 1] + bq[G - 1]);
        s = act[1] * s + act[0] * act[2];
        h = act[3] * tanhf(s);
      } else {
        // hp = h Wh^T + bh; r, z on gx + hp; n = tanh(gx_n + r hp_n)
        act[3] = o[2] + bq[2];
        act[0] = sigm(xq[0] + (o[0] + bq[0]));
        act[1] = sigm(xq[1] + (o[1] + bq[1]));
        act[2] = tanhf(xq[2] + act[0] * act[3]);
        h = (1.f - act[1]) * act[2] + act[1] * s;
        s = h;
      }
      st[cn * HS + cj] = __float2bfloat16_rn(h);
    }
    __syncthreads();

    // (4) h_t into ys[t]: N 16-byte stores, each fenced once, then the
    // arrive
    if (units && tid < N) {
      *reinterpret_cast<uint4*>(ys + ((long long)t * N + tid) * H + j0) =
          *reinterpret_cast<const uint4*>(st + tid * HS);
      if (more) fence_gpu();
    }
    if (more) bar.arrive();

    // (5) off the chain, until the wait: the residuals, hT and cT, and
    // the next step's gx
    if (cell) {
      const long long row = (long long)t * N + cn;
      if (g.save) {
        float* a = acts + row * 4 * H + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q * H] = act[q];
        if (G == 4) cells[row * H + j] = s;
      }
      if (!more) {
        hT[(long long)cn * H + j] = __float2bfloat16_rn(h);
        if (G == 4) cT[(long long)cn * H + j] = __float2bfloat16_rn(s);
      } else {
        const bf16* x = gx + (row + N) * GH + j;
#pragma unroll
        for (int q = 0; q < G; ++q) xq[q] = __bfloat162float(x[q * H]);
      }
    }
    if (!more) break;
    target += nclusters;
    bar.wait(target);

    // (6) this rank's rows of ys[t], multicast to the cluster's half b^1
    // as step t+1's operand
    if (warp == 1) {
      const int n = crank + CL * lane;
      if (n < N) {
        fence_proxy_async_all();
        bulk_load_multicast(
            tc::smem_addr(hbuf + (b ^ 1) * hstride + n * LDH),
            ys + ((long long)t * N + n) * H, H * 2, bar0 + 8 * (b ^ 1),
            (uint16_t)0xffffu);
      }
    }
  }
  cluster_arrive_release();   // no CTA leaves while a peer's multicast
  cluster_wait();             // may still target its shared memory
}

// The C entry points' body for one gate count.  Tensors as rnn_fwd_entry's
// (fused_rnn.cuh), bfloat16 only (the GRU's c0, cT and cells are null;
// without save, acts and cells are null); ctr one zeroed unsigned; info
// receives (cluster size, grid CTAs, shared-memory bytes) of the launch.
template <int G>
int rnn_fwd_tc_entry(const void* gx, const void* h0, const void* c0,
                     const void* wh, const void* bh, void* ys, void* hT,
                     void* cT, void* acts, void* cells, void* ctr, int T,
                     int N, int H, int save, int* info, void* stream) {
  FwdGeo g = fwd_geo(T, N, H, save);
  info[0] = CL, info[1] = up(g.P, CL), info[2] = g.total;
  const bf16* a0 = static_cast<const bf16*>(gx);
  const float *a1 = static_cast<const float*>(h0),
              *a2 = static_cast<const float*>(c0);
  const bf16* a3 = static_cast<const bf16*>(wh);
  const float* a4 = static_cast<const float*>(bh);
  bf16 *o0 = static_cast<bf16*>(ys), *o1 = static_cast<bf16*>(hT),
       *o2 = static_cast<bf16*>(cT);
  float *o3 = static_cast<float*>(acts), *o4 = static_cast<float*>(cells);
  unsigned* o5 = static_cast<unsigned*>(ctr);
  void* args[] = {&g, &a0, &a1, &a2, &a3, &a4, &o0, &o1, &o2, &o3, &o4, &o5};
  if (!fwd_geo_ok(g)) return (int)cudaErrorInvalidValue;
  return (int)tc_launch(rnn_fwd_tc_kernel<G>, up(g.P, CL), g.total, args,
                        static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace rnn_tc
