// The fused-LSTM and fused-GRU forward for Hopper (sm_90a) in float32, on
// tensor cores through split-TF32 products, with h_{t-1} multicast across a
// thread-block cluster.  fused_{lstm,gru}_fwd_f32tc.cu instantiate
// rnn_fwd_f32tc_kernel<G> behind their C entry points, one translation unit
// per gate count.
//
// Replaces, for float32, the TPU kernels
//   rnn_fwd_f32tc_kernel<4> <- mxnet_tpu/ops/pallas_lstm.py _fwd (:102) /
//                              _fwd_kernel (:57), call :126
//   rnn_fwd_f32tc_kernel<3> <- mxnet_tpu/ops/pallas_gru.py _fwd (:79) /
//                              _fwd_kernel (:43), call :94
// and computes what they compute in float32, at their cast points, which
// are all float32 here: gates = gx + h_{t-1} Wh^T + bh (h_{t-1} is h0 at
// t = 0, else ys[t-1]); the carried state (c for the LSTM, h for the GRU's
// z h); ys, hT and cT; with `save` the residuals the float32 backward reads,
// acts (T, N, 4 H: i, f, g, o or r, z, n, hp_n with hp_n = h Wh_n^T +
// bh_n) and the LSTM's cells (T, N, H).  Without `save` none of them is
// written.  bfloat16 runs fused_rnn_fwd_tc.cuh; float32 outside the limits
// below runs rnn_fwd_kernel in fused_rnn.cuh.
//
// What bounds it.  At the language model's shape (T 128, N 32, H 512) the
// forward is 2 T N G H^2 = 8.6 GFLOP (LSTM); as three TF32 products each
// (tf32x3.cuh), 25.8 GFLOP: 0.052 ms at the dense TF32 peak of 495
// TFLOP/s (0.128 ms as float32 FMAs at 67).  The recurrence sets the time
// instead, as in the bf16 kernel: step t needs all of h_{t-1}, made by
// every CTA, so a step is a chain of dependent latencies (a grid-wide
// barrier, the exchange of h_{t-1}, one product and the cell math).
//
// The design is the bf16 forward's (fused_rnn_fwd_tc.cuh), in float32:
//
//  1. Wh on the tensor cores, held split in registers.  CTA k owns HS = 8
//     hidden units (all G gates: G n-tiles of 8 columns) and the grid runs
//     in clusters of CL = 16 CTAs (64 CTAs at H 512).  The product
//     gates[n][q 8 + jl] = h_{t-1}[n, :] . Wh[q H + j0 + jl, :] is split by
//     K over the 8 warps: warp w takes both m-tiles and the k8-steps w + 8 i
//     (i < 8: 64 of H 512's columns), and holds their B fragments of all G
//     n-tiles split, big and small (2 x G x 8 x 2 = 128 registers at G 4),
//     for the whole sequence: no split of Wh on the chain.  A step is 2
//     m-tiles x G n-tiles x 8 k-steps x 3 = 192 mma.sync a warp on 16
//     ldmatrix; each A fragment (h_{t-1}) is split as it is read and used
//     for G n-tiles x 3 products.  The bf16 kernel's split, by (m-tile,
//     K-quarter), would hold 256 registers of split B fragments a warp; its
//     float32 draft, which split Wh as read, and one of 4 units a CTA both
//     measured slower (PERF.md §6).
//  2. The tensor core's float32 accumulation truncates (flash_dkv_f32tc.cu,
//     trouble 5).  So each warp sums only its own K part from zero (8
//     k-steps, 24 products), and the cell thread adds the 8 partials of
//     each gate in float32, in order, through shared memory.
//  3. h_{t-1} multicast once per cluster, in float32.  After the barrier of
//     step t-1, rank r of each cluster issues one bulk copy of each row
//     n = r (mod CL) of ys[t-1] with .multicast::cluster to all its CTAs:
//     the row lands at the same offset of every CTA's shared memory (rows
//     of LDH floats, LDH % 32 == 4, so the 8 rows of an ldmatrix hit 8
//     different groups of 4 banks) and completes on each CTA's mbarrier,
//     armed for N H 4 bytes (64 KB at N 32, H 512).  The tile and its
//     mbarrier are double-buffered by the parity of t, as in the bf16
//     kernel: a rank writes step t+1's half only after the barrier of step
//     t, which every peer reaches after its product of step t-1 consumed
//     that half, and after its own wait on that half's previous phase.  At
//     t = 0 each CTA writes h0 itself and arrives once.
//  4. One cell a thread, its state in a register.  At N 32 and 8 units the
//     256 cells of a CTA are its 256 threads: thread (n, jl) sums its G gates
//     over the 8 partials, keeps c (or h) in float32 across the sequence,
//     and holds its G bh values; the next step's G gx values are loaded
//     during the barrier wait.
//  5. Only h_t on the chain.  A batch row's 8 units of h_t (32 bytes) are
//     staged in shared memory and written to ys[t] as two 16-byte stores by
//     each of the first N threads, which fence once at gpu scope and
//     arrive at the split barrier (rnn_tc_sync.cuh).  Between arrive and
//     wait every cell writes its residuals (acts, cells; hT, cT at t =
//     T-1): they are off the chain.
//
// The budget.  At (N 32, H 512) the shared memory is 174,096 bytes
// (fwd32_geo: two halves of the h tile, 132 KB, and the 8 parts' partials,
// 40 KB), one CTA an SM.
//
// Proxies.  ys[t] is written by generic stores and read, after the
// barrier, by the bulk-copy engine (the async proxy) of other CTAs; the
// issuing thread fences the proxies (fence.proxy.async) after its acquire,
// which also orders the peers' ldmatrix reads of the half it overwrites.
// No ys row written in this kernel is read through LDG.NC or L1.
//
// Co-residency.  A cooperative cluster launch (rnn_tc_sync.cuh tc_launch,
// cudaErrorCooperativeLaunchTooLarge when the clusters do not fit; no
// fallback).  A grid padded to a multiple of CL has CTAs without units:
// they wait on their mbarriers, arrive, wait at the barrier and issue their
// rank's multicast rows like the others, and skip the product and the
// stores.  A last cluster barrier keeps every CTA resident until no peer's
// copy can still target it.
//
// Limits (the wrapper's rule, ops/fused_rnn_cuda.py _fwd_variant, states
// them in closed form, fwd_tc32_smem_bytes): float32; 1 <= N <= 32 (two m16
// tiles); H a multiple of 8 (whole k8-steps, 16-byte rows) and at most 512
// (8 k-steps a warp); the shared memory of fwd32_geo within a block's 227
// KB (it is at every such shape).  Anything else returns
// cudaErrorInvalidValue without running.

#pragma once

#include "rnn_tc_sync.cuh"
#include "tf32x3.cuh"

namespace rnn_tc {
namespace {   // internal to each translation unit
namespace f32fwd {

constexpr int MAX_N = 32;             // batch rows: two m16 tiles
constexpr int MAX_H = 512;            // the product: 64 k8-steps
constexpr int KSW = MAX_H / 8 / NW;   // k8-steps a warp (its K part): 8
constexpr int RS = 40;                // row stride of the partials (floats):
                                      // the rows a warp's cells read hit
                                      // different bank groups

struct Geo {
  int T, N, H, save;
  int P;        // CTAs with units: H / HS
  int MT;       // m16 tiles of the batch
  int KS;       // k8-steps of the product: H / 8
  int LDH;      // h tile row stride: H padded to 32, + 4 floats
  // byte offsets into dynamic shared memory
  int o_red, o_st, o_bar, total;
};

// The layout, in bytes (every piece 16-byte aligned):
//   h    [2][16 MT][LDH] float   h_{t-1} by the parity of t
//   red  [NW][16 MT][RS] float   each warp's partial gate sums
//   st   [N][HS] float           h_t of the CTA's units, staged for 16-byte
//                                stores
//   bar  two mbarriers: the h halves'
__host__ __device__ inline Geo fwd32_geo(int T, int N, int H, int save) {
  Geo g;
  g.T = T, g.N = N, g.H = H, g.save = save;
  g.P = cdiv(H, HS);
  g.MT = cdiv(N, 16);
  g.KS = H / 8;
  g.LDH = up(H, 32) + 4;
  g.o_red = 2 * 16 * g.MT * g.LDH * 4;
  g.o_st = g.o_red + NW * 16 * g.MT * RS * 4;
  g.o_bar = g.o_st + N * HS * 4;
  g.total = g.o_bar + 16;
  return g;
}

inline bool fwd32_geo_ok(const Geo& g) {
  return g.T >= 1 && g.N >= 1 && g.N <= MAX_N && g.H >= 8 &&
         g.H <= MAX_H && g.H % 8 == 0 && g.total <= SMEM_MAX;
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// -- the kernel ---------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(NT, 1)
    rnn_fwd_f32tc_kernel(Geo g, const float* __restrict__ gx,
                         const float* __restrict__ h0,
                         const float* __restrict__ c0,
                         const float* __restrict__ wh,
                         const float* __restrict__ bh, float* ys, float* hT,
                         float* cT, float* acts, float* cells,
                         unsigned* ctr) {
  extern __shared__ __align__(16) unsigned char sm[];
  float* hbuf = reinterpret_cast<float*>(sm);
  float* red = reinterpret_cast<float*>(sm + g.o_red);
  float* st = reinterpret_cast<float*>(sm + g.o_st);
  const uint32_t bar0 = tc::smem_addr(sm + g.o_bar);   // half b's: + 8 b
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // mma fragment row, column
  const int H = g.H, N = g.N, GH = G * H, MT = g.MT, LDH = g.LDH;
  const uint32_t crank = cluster_rank();
  const int j0 = blockIdx.x * HS;            // the CTA's units
  const bool units = j0 < H;                 // false: a CTA of the padding
  const SplitBarrier bar{ctr, crank == 0 && warp == 0};
  const unsigned nclusters = gridDim.x / CL;
  const int hstride = 16 * MT * LDH;         // floats of one h half
  const int rstride = 16 * MT * RS;          // floats of a part's partials
  const unsigned hbytes = N * H * 4;         // a step's multicast bytes

  for (int i = tid; i < g.total / 16; i += NT)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) mbar_init(bar0, 1), mbar_init(bar0 + 8, 1);

  // B fragments of this warp's k-steps, for the whole sequence, split
  // (wb big, ws small): n-tile q (gate q of the CTA's units), k-step warp +
  // NW i (b0 = B[t][g], b1 = B[t+4][g], B[k][jl] = Wh[q H + j0 + jl][k];
  // zero past H)
  uint32_t wb[G][KSW][2], ws[G][KSW][2];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float* wr = wh + (long long)(q * H + j0 + gq) * H;
#pragma unroll
    for (int i = 0; i < KSW; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ks = warp + NW * i;
        const float w = (units && ks < g.KS) ? wr[8 * ks + tq + 4 * e] : 0.f;
        tf32x3::split(w, wb[q][i][e], ws[q][i][e]);
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
      xq[q] = gx[(long long)cn * GH + q * H + j];
    }
  }

  // step 0's operand: h0 into half 0, one arrival
  for (int i = tid; i < N * H; i += NT) {
    const int n = i / H, k = i - n * H;
    hbuf[n * LDH + k] = h0[i];
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

    // (2) this warp's partial gate sums: both m-tiles over its K part,
    // summed from zero, k-step by k-step (A's fragments split as read)
    if (units) {
      const uint32_t hb = tc::smem_addr(hbuf + b * hstride);
      float acc[2][G][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
#pragma unroll
      for (int i = 0; i < KSW; ++i) {
        const int ks = warp + NW * i;
        if (ks >= g.KS) break;
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (m < MT) {
            uint32_t a[4];
            tc::ldmatrix_x4(a, hb + ((16 * m + (lane & 15)) * LDH + 8 * ks +
                                     4 * (lane >> 4)) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tf32x3::split(__uint_as_float(a[e]), ab[m][e], as[m][e]);
          }
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT) {
              tf32x3::mma(acc[m][q], as[m], wb[q][i]);
              tf32x3::mma(acc[m][q], ab[m], ws[q][i]);
              tf32x3::mma(acc[m][q], ab[m], wb[q][i]);
            }
      }
      float* rw = red + warp * rstride;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        if (m < MT)
#pragma unroll
          for (int q = 0; q < G; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float2*>(
                  rw + (16 * m + gq + 8 * e) * RS + 8 * q + 2 * tq) =
                  make_float2(acc[m][q][2 * e], acc[m][q][2 * e + 1]);
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
        for (int w = 0; w < NW; ++w)
          v += red[w * rstride + cn * RS + q * HS + cj];
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
      st[cn * HS + cj] = h;
    }
    __syncthreads();

    // (4) h_t into ys[t]: a batch row's 16-byte stores (two at 8 units),
    // by the first N threads, each fenced once, then the arrive
    if (units && tid < N) {
      const uint4* src = reinterpret_cast<const uint4*>(st + tid * HS);
      uint4* dst = reinterpret_cast<uint4*>(ys + ((long long)t * N + tid) * H +
                                            j0);
#pragma unroll
      for (int c = 0; c < HS / 4; ++c) dst[c] = src[c];
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
        hT[(long long)cn * H + j] = h;
        if (G == 4) cT[(long long)cn * H + j] = s;
      } else {
        const float* x = gx + (row + N) * GH + j;
#pragma unroll
        for (int q = 0; q < G; ++q) xq[q] = x[q * H];
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
            ys + ((long long)t * N + n) * H, H * 4, bar0 + 8 * (b ^ 1),
            (uint16_t)((1u << CL) - 1u));
      }
    }
  }
  cluster_arrive_release();   // no CTA leaves while a peer's multicast
  cluster_wait();             // may still target its shared memory
}

// The C entry points' body for one gate count.  Tensors as rnn_fwd_entry's
// (fused_rnn.cuh), float32 only, every one contiguous, ys 16-byte aligned
// (its rows are bulk-copied; the GRU's c0, cT and cells are null; without
// save, acts and cells are null); ctr one zeroed unsigned; info receives
// (cluster size, grid CTAs, shared-memory bytes) of the launch.
template <int G>
int rnn_fwd_f32tc_entry(const void* gx, const void* h0, const void* c0,
                        const void* wh, const void* bh, void* ys, void* hT,
                        void* cT, void* acts, void* cells, void* ctr, int T,
                        int N, int H, int save, int* info, void* stream) {
  Geo g = fwd32_geo(T, N, H, save);
  info[0] = CL, info[1] = up(g.P, CL), info[2] = g.total;
  const float *a0 = static_cast<const float*>(gx),
              *a1 = static_cast<const float*>(h0),
              *a2 = static_cast<const float*>(c0),
              *a3 = static_cast<const float*>(wh),
              *a4 = static_cast<const float*>(bh);
  float *o0 = static_cast<float*>(ys), *o1 = static_cast<float*>(hT),
        *o2 = static_cast<float*>(cT), *o3 = static_cast<float*>(acts),
        *o4 = static_cast<float*>(cells);
  unsigned* o5 = static_cast<unsigned*>(ctr);
  void* args[] = {&g, &a0, &a1, &a2, &a3, &a4, &o0, &o1, &o2, &o3, &o4, &o5};
  if (!fwd32_geo_ok(g)) return (int)cudaErrorInvalidValue;
  return (int)tc_launch(rnn_fwd_f32tc_kernel<G>, up(g.P, CL), g.total,
                        args, static_cast<cudaStream_t>(stream));
}

}  // namespace f32fwd
}  // namespace
}  // namespace rnn_tc
