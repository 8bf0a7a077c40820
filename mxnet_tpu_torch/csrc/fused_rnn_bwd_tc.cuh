// The fused-LSTM and fused-GRU backward for Hopper (sm_90a) on bf16 tensor
// cores, with the recurrent product split across a thread-block cluster.
// fused_{lstm,gru}_bwd_tc.cu instantiate rnn_bwd_tc_kernel<G> behind
// their C entry points, one translation unit per gate count.
//
// Replaces, for bfloat16, the TPU kernels
//   rnn_bwd_tc_kernel<4> <- mxnet_tpu/ops/pallas_lstm.py _bwd_call (:206) /
//                           _bwd_kernel (:148), call :216
//   rnn_bwd_tc_kernel<3> <- mxnet_tpu/ops/pallas_gru.py _bwd_call (:161) /
//                           _bwd_kernel (:112), call :169
// and computes what they compute, at the same cast points: the recurrent
// products take bf16 operands (dg_lo or dhp_lo, Wh, h_prev) and sum in
// float32; dWh, dbh, dh0 and dc0 are float32; dgx is bf16; dbh sums the
// float32 dgates; at t = 0, h0 is rounded to bf16.  float32 (and every
// geometry outside the limits below) runs rnn_bwd_kernel in fused_rnn.cuh.
//
// What bounds it.  At the language model's shape (T 128, N 32, H 512) the
// backward is 4 T N G H^2 = 17 GFLOP and ~74 MB: ~0.02 ms on the card.  The
// recurrence sets the time instead: step t - 1 needs dh_{t-1} = X_t Wh,
// X_t (N x G H, bf16: dg_lo for the LSTM, dhp_lo for the GRU) made of every
// CTA's dgates, so each step is a chain of dependent latencies: the cell
// math, a grid-wide barrier, the exchange of X_t and one small product.
// The design shortens that chain:
//
//  1. The product split by K inside a cluster.  CTA k owns HS = 8 hidden
//     units (all G gates: its dgates, its dh, its rows of dWh); the grid
//     runs in clusters of CL = 16 CTAs, a cluster owning 128 consecutive
//     units (at H 512, 64 CTAs: 4 clusters, which the H100 holds at once;
//     it does not hold 8 clusters of 16, which 4 units a CTA would need).
//     Rank r of a cluster multiplies only its slice of K, X_t[:, r KC ..
//     (r+1) KC), against the cluster's columns of Wh (KC = G H / 16: 128
//     rows of the LSTM's 2048), and sends each CTA of the cluster its
//     partial dh for that CTA's units, N x 8 float32, straight into the
//     owner's shared memory (st.async, which completes bytes on the
//     owner's mbarrier);
//     the owner sums the CL partials.  A CTA so reads 1/CL of X_t from L2
//     a step (8 KB instead of the old kernel's 128 KB, which every CTA
//     read and widened to float32) and exchanges 16 KB of partials over
//     the cluster, with no cluster barrier and no fence on that path.
//     One buffer each is enough: an owner's partials of step t-1 are sent
//     only after the grid barrier of step t-1, which the owner reaches
//     after summing those of step t; a slice of X_{t-1} is loaded only
//     after that barrier, which every CTA reaches after its product of t.
//  2. The products on the tensor cores: mma.sync m16n8k16 bf16 with
//     float32 sums.  dh: A (the slice of X_t, 16-byte-padded rows, so the
//     8 rows of an ldmatrix hit 8 bank groups) by ldmatrix, B (the
//     cluster's columns of Wh over the slice: each warp two n-tiles of 8
//     units, i.e. two owners' units) loaded once into registers for the
//     whole sequence.
//  3. dWh and dbh off the serial path.  The grid barrier is split into an
//     arrive and a wait, written by hand: the threads that stored X_t
//     fence at gpu scope and every thread arrives at the cluster barrier;
//     the leader warp (warp 0 of rank 0) waits there for its cluster and
//     adds 1 (red.release.gpu) to a generation counter; at the wait, warp
//     0 of every CTA polls the counter (ld.acquire.gpu) and __syncthreads
//     lets its CTA on.  Between its arrive and its wait a CTA accumulates
//     dWh[rows, :] += dg_lo[:, rows]^T @ h_prev (mma.sync; M = G HS rows,
//     N = H, K = batch) into float32 registers kept for the whole
//     sequence, and dbh over the batch, so dWh costs the chain nothing
//     unless it outlasts the wait.  The sum over t is the reference's, one
//     product a step.  dg_lo^T and the float32 dgates live in two halves
//     by the parity of t.  The GRU's operand dhp_lo is not dgx: it goes
//     through xbuf, two halves by the parity of t (a CTA writes step t-2's
//     half only after the barrier of step t-1, which every CTA reaches
//     after loading its slice of step t's half).
//  4. Prefetch.  What does not depend on the recurrence is loaded a step
//     ahead: each cell's saved activations, cells, c_prev (or h_prev for
//     the GRU) and dys into registers, and the dWh operand h_prev = ys[t-2]
//     for step t-1 into the other half of a double buffer, by the bulk
//     copy engine (one cp.async.bulk a row, issued by one warp, completing
//     on an mbarrier), so that no thread spends its issue slots on it.
//
// Barriers (rnn_tc_sync.cuh).  The step's cluster arrives are .relaxed,
// and the writers of X_t fence once, before them.  The gpu-scope fence is
// the costliest link of the step's chain, so X_t is staged in shared
// memory and written as N G 16-byte stores (one a thread, for N G <= 128
// threads) rather than as 2-byte stores from every cell.
//
// Co-residency.  The launch is a cluster launch with the cooperative
// attribute: the runtime refuses it unless the whole grid is resident,
// which the spin barrier needs; cudaOccupancyMaxActiveClusters checks it
// beforehand (cudaErrorCooperativeLaunchTooLarge when the clusters do not
// fit).  A grid padded to a multiple of 16 has CTAs without units:
// they arrive, wait, load their slice and send their partials like the
// others.  Values other CTAs wrote in this kernel (dgx, xbuf) are read
// with ld.global.cg only, from L2: never through LDG.NC or a stale L1 line.
//
// Limits (the wrapper's rule, ops/fused_rnn_cuda.py _bwd_variant, states
// them in closed form): bfloat16; 1 <= N <= 32 (two m16 tiles); H a
// multiple of 8 and at most 512 (the dWh accumulators: 4 pairs of n-tiles
// a warp; the Wh fragments: 8 k-steps a warp); the shared memory of
// tc_geo within a block's 227 KB.  Anything else returns
// cudaErrorInvalidValue without running.

#pragma once

#include "rnn_tc_sync.cuh"
#include "tc_tile.cuh"

namespace rnn_tc {
namespace {   // internal to each translation unit

constexpr int MAX_N = 32;         // batch rows: at most two m16 tiles
constexpr int MAX_H = 512;        // dWh: at most 4 n-tile pairs a warp
constexpr int MAX_GH = 4 * MAX_H; // dh: at most 2048 / 16 rows of K a CTA
constexpr int MAX_PW = 4;         // dWh: 16-column pairs a warp

struct TcGeo {
  int T, N, H, G;
  int P;        // CTAs with units: ceil(H / HS)
  int MT;       // m16 tiles of the batch
  int KC;       // rows of K a CTA: G H / 16, padded to 16
  int LDT;      // slice row stride: KC + 8 elements
  int LDH;      // h_prev row stride: H padded to 16, + 8
  int RP;       // G HS rows of dWh, padded to 16
  int LDG;      // dg_lo^T row stride: 16 MT + 8
  int bytes;    // the partials one CTA receives a step
  // byte offsets into dynamic shared memory
  int o_h, o_dgl, o_dgf, o_xs, o_recv, o_bar, total;
};

// The layout, in bytes (every piece 16-byte aligned):
//   tile  [16 MT][LDT] bf16      this CTA's slice of X_t
//   h     [2][16 MT][LDH] bf16   h_prev of this step and of the next
//   dgl   [2][RP][LDG] bf16      the CTA's dg_lo, transposed (rows x
//                                batch), by the parity of t
//   dgf   [2][N][G HS] float     the CTA's float32 dgates (for dbh), ditto
//   xs    [N][G][HS] bf16        the CTA's part of X_t, staged for 16-byte
//                                stores
//   recv  [CL][16 MT][8] float   the cluster's partial dh of the CTA's units
//   bar   two mbarriers: the partials', and h_prev's
__host__ __device__ inline TcGeo tc_geo(int G, int T, int N, int H) {
  TcGeo g;
  g.T = T, g.N = N, g.H = H, g.G = G;
  g.P = cdiv(H, HS);
  g.MT = cdiv(N, 16);
  g.KC = up(cdiv(G * H, CL), 16);
  g.LDT = g.KC + 8;
  g.LDH = up(H, 16) + 8;
  g.RP = up(G * HS, 16);
  g.LDG = 16 * g.MT + 8;
  g.bytes = CL * 16 * g.MT * 8 * 4;
  g.o_h = 16 * g.MT * g.LDT * 2;
  g.o_dgl = g.o_h + 2 * 16 * g.MT * g.LDH * 2;
  g.o_dgf = g.o_dgl + 2 * g.RP * g.LDG * 2;
  g.o_xs = g.o_dgf + 2 * up(N * G * HS * 4, 16);
  g.o_recv = g.o_xs + N * G * HS * 2;
  g.o_bar = g.o_recv + g.bytes;
  g.total = g.o_bar + 16;
  return g;
}

inline bool tc_geo_ok(const TcGeo& g) {
  return g.T >= 1 && g.N >= 1 && g.N <= MAX_N && g.H >= 8 &&
         g.H <= MAX_H && g.H % 8 == 0 && g.total <= SMEM_MAX;
}

// -- the kernel ---------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(NT, 1)
    rnn_bwd_tc_kernel(TcGeo g, const float* __restrict__ acts,
                      const float* __restrict__ cells,
                      const bf16* __restrict__ ys,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const bf16* __restrict__ wh,
                      const bf16* __restrict__ dys,
                      const bf16* __restrict__ dhT,
                      const bf16* __restrict__ dcT, bf16* dgx, bf16* xbuf,
                      float* dwh, float* dbh, float* dh0, float* dc0,
                      unsigned* ctr) {
  constexpr int R = G * HS;                  // the CTA's rows of dWh
  constexpr int MR = (R + 15) / 16;          // their m16 tiles
  constexpr int NTW = CL * HS / 8 / NW;      // dh n-tiles a warp: 2
  constexpr int MAX_KS = MAX_GH / CL / 16;   // dh k-steps a CTA: 8
  static_assert(NTW >= 1 && NTW * NW * 8 == CL * HS, "one owner an n-tile");
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* tile = reinterpret_cast<bf16*>(sm);
  bf16* hbuf = reinterpret_cast<bf16*>(sm + g.o_h);
  bf16* dgl = reinterpret_cast<bf16*>(sm + g.o_dgl);
  float* dgf = reinterpret_cast<float*>(sm + g.o_dgf);
  bf16* xs = reinterpret_cast<bf16*>(sm + g.o_xs);
  float* recv = reinterpret_cast<float*>(sm + g.o_recv);
  const uint32_t bar_s = tc::smem_addr(sm + g.o_bar);   // the partials
  const uint32_t hbar_s = bar_s + 8;                      // h_prev
  const uint32_t recv_s = tc::smem_addr(recv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // mma fragment row, column pair
  const int H = g.H, N = g.N, GH = G * H, MT = g.MT;
  const uint32_t crank = cluster_rank();
  const int j0 = blockIdx.x * HS;            // the CTA's units
  const int hs = max(0, min(HS, H - j0));    // 0: a CTA of the padding
  const int cbase = (blockIdx.x - crank) * HS;   // the cluster's first unit
  const int k0 = crank * g.KC;               // the CTA's slice of K
  const SplitBarrier bar{ctr, crank == 0 && warp == 0};
  const unsigned nclusters = gridDim.x / CL;
  const int hstride = 16 * MT * g.LDH;       // elements of one h half
  const int dgl_n = g.RP * g.LDG;            // elements of one dgl half
  const int dgf_n = up(N * R * 4, 16) / 4;   // and of one dgf half

  for (int i = tid; i < g.total / 16; i += NT)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) mbar_init(bar_s, 1), mbar_init(hbar_s, 1);

  // B fragments of the dh product, for the whole sequence: n-tile
  // o = warp NTW + i (the units of rank o), k-steps of the slice (b0 =
  // B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g], B[k][n] = Wh[k0 + k][cbase +
  // 8 o + n]; zero past G H, past the slice and past H)
  uint32_t bw[NTW][MAX_KS][2];
  {
    const bf16 zero = __float2bfloat16_rn(0.f);
    const int kend = min(GH, k0 + g.KC);
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int col = cbase + 8 * (warp * NTW + i) + gq;
#pragma unroll
      for (int ks = 0; ks < MAX_KS; ++ks) {
        bf16 w[4] = {zero, zero, zero, zero};
        const int k = k0 + ks * 16 + 2 * tq;
        const int kk[4] = {k, k + 1, k + 8, k + 9};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col < H && kk[e] < kend)
            w[e] = wh[(long long)kk[e] * H + col];
        bw[i][ks][0] = pack2(w[0], w[1]);
        bw[i][ks][1] = pack2(w[2], w[3]);
      }
    }
  }

  // this thread's cell (batch row cn, unit j) in the dgates phase, and its
  // carries: dh, and dc (LSTM) or dh z (GRU)
  const int cn = tid / HS, cj = tid % HS, j = j0 + cj;
  const bool cell = cn < N && cj < hs;
  float c1 = 0.f, c2 = 0.f;
  if (cell) {
    c1 = __bfloat162float(dhT[(long long)cn * H + j]);
    if (G == 4) c2 = __bfloat162float(dcT[(long long)cn * H + j]);
  }
  // the chunk walk of the slice (rows of KC / 8 chunks): this thread's
  // first chunk, and the step of NT chunks
  const int kc8 = g.KC / 8, sn0 = tid / kc8, sc0 = tid % kc8;
  const int sdn = NT / kc8, sdc = NT % kc8;

  // the next step's residuals, loaded a step ahead
  float pa[4] = {0.f, 0.f, 0.f, 0.f}, pc = 0.f, pcp = 0.f;
  bf16 pd = __float2bfloat16_rn(0.f), ph = pd;
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
    } else if (t) {
      ph = ys[(row - N) * H + j];
    } else {
      pcp = h0[(long long)cn * H + j];
    }
  };
  // h_prev of step t (ys[t-1]; h0 rounded to bf16 at t = 0) into half b,
  // by warp 1, completing one phase of hbar: a bulk copy a row of ys
  // (lane n, row n), or the rounded h0 stored by the warp and one arrival
  auto load_h = [&](int t, int b) {
    bf16* hb = hbuf + b * hstride;
    if (t > 0) {
      fence_proxy_async();
      if (lane == 0) mbar_expect(hbar_s, N * H * 2);
      __syncwarp();
      if (lane < N)
        bulk_load(tc::smem_addr(hb + lane * g.LDH),
                  ys + ((long long)(t - 1) * N + lane) * H, H * 2, hbar_s);
    } else {
      for (int n = 0; n < N; ++n)
        for (int k = lane; k < H; k += 32)
          hb[n * g.LDH + k] = __float2bfloat16_rn(h0[(long long)n * H + k]);
      __syncwarp();
      if (lane == 0) mbar_arrive(hbar_s);
    }
  };

  float dw[MR][2 * MAX_PW][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int i = 0; i < 2 * MAX_PW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[m][i][e] = 0.f;
  float dbs = 0.f;             // dbh of row tid / 8 (tid % 8 == 0, < 8 R)
  const int npairs = cdiv(H, 16);

  // dbh and dWh += dg_lo^T h_prev of step t, this warp's share; issues the
  // cp.async of step t-1's h_prev
  auto window = [&](int t) {
    const float* df = dgf + (t & 1) * dgf_n;
    if (warp < R / 4) {                     // 8 lanes a row, N / 8 each
      const int lr = tid >> 3, sub = tid & 7;
      float s = 0.f;
      for (int n = sub; n < N; n += 8) s += df[n * R + lr];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      dbs += s;
    }
    if (hs) {
      if (t > 0 && warp == 1) load_h(t - 1, (t - 1) & 1);
      const uint32_t hb = tc::smem_addr(hbuf + (t & 1) * hstride);
      const uint32_t gb = tc::smem_addr(dgl + (t & 1) * dgl_n);
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        if (kb >= MT) break;
        uint32_t a[MR][4], b[MAX_PW][4];
#pragma unroll
        for (int m = 0; m < MR; ++m)
          tc::ldmatrix_x4(a[m], gb + ((16 * m + (lane & 15)) * g.LDG +
                                      16 * kb + 8 * (lane >> 4)) * 2);
#pragma unroll
        for (int pi = 0; pi < MAX_PW; ++pi) {
          const int p = min(warp + NW * pi, npairs - 1);
          tc::ldmatrix_x4_trans(
              b[pi], hb + ((16 * kb + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               g.LDH + 16 * p + 8 * (lane >> 4)) * 2);
        }
#pragma unroll
        for (int pi = 0; pi < MAX_PW; ++pi)
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            // pairs past H repeat the last pair into accumulators that are
            // never written out
            tc::mma_bf16(dw[m][2 * pi], a[m], b[pi][0], b[pi][1]);
            tc::mma_bf16(dw[m][2 * pi + 1], a[m], b[pi][2], b[pi][3]);
          }
      }
    }
  };

  prefetch(g.T - 1);
  if (tid == 0) mbar_expect(bar_s, g.bytes);     // the first step's phase
  cluster_arrive_release();                 // every peer has started, and
  cluster_wait();                           // its mbarriers are initialised
  if (hs && warp == 1) load_h(g.T - 1, (g.T - 1) & 1);

  unsigned target = 0;
  for (int t = g.T - 1; t >= 0; --t) {
    // (1) the CTA's dgates from the prefetched residuals
    bf16* xt = G == 4 ? dgx + (long long)t * N * GH
                      : xbuf + (long long)(t & 1) * N * GH;
    if (cell) {
      const float dh = c1 + __bfloat162float(pd);
      const long long row = (long long)t * N + cn;
      bf16* dxr = dgx + row * GH;
      float x[G];
      bf16 lo[G];
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
#pragma unroll
        for (int q = 0; q < G; ++q) lo[q] = __float2bfloat16_rn(x[q]);
      } else {
        const float r = pa[0], z = pa[1], nn = pa[2], nh = pa[3];
        const float hp = t ? __bfloat162float(ph) : pcp;
        const float dz = dh * (hp - nn);
        const float dn = dh * (1.f - z);
        const float dnp = dn * (1.f - nn * nn);
        const float dr = dnp * nh;
        x[0] = dr * r * (1.f - r);
        x[1] = dz * z * (1.f - z);
        x[2] = dnp * r;                     // dnh: dhp = [dr_pre, dz_pre, dnh]
        dxr[0 * H + j] = __float2bfloat16_rn(x[0]);
        dxr[1 * H + j] = __float2bfloat16_rn(x[1]);
        dxr[2 * H + j] = __float2bfloat16_rn(dnp);
        c2 = dh * z;
#pragma unroll
        for (int q = 0; q < G; ++q) lo[q] = __float2bfloat16_rn(x[q]);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        xs[(cn * G + q) * HS + cj] = lo[q];   // X_t (the LSTM's dgx[t])
        dgl[(t & 1) * dgl_n + (q * HS + cj) * g.LDG + cn] = lo[q];
        dgf[(t & 1) * dgf_n + cn * R + q * HS + cj] = x[q];
      }
    }
    if (hs) mbar_wait(hbar_s, (g.T - 1 - t) & 1);   // h_prev of step t
    __syncthreads();              // X_t staged; dgl, dgf and h_prev complete
    // the CTA's part of X_t in 16-byte stores, one fence each, then the
    // arrive: few stores, so the fences wait on few acknowledgements
    if (hs && tid < N * G) {
      const int n = tid / G, q = tid - n * G;
      *reinterpret_cast<uint4*>(xt + (long long)n * GH + q * H + j0) =
          *reinterpret_cast<const uint4*>(xs + tid * HS);
      fence_gpu();
    }
    bar.arrive();
    if (t > 0) prefetch(t - 1);

    // (2) off the chain, until the wait: dbh, and dWh += dg_lo^T h_prev
    window(t);
    target += nclusters;
    bar.wait(target);

    // (3) this CTA's slice of X_t, from L2: every load of a batch in
    // flight before the first store
    for (int n = sn0, c = sc0; n < N;) {
      uint4 v[4];
      int off[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        off[i] = -1;
        if (n < N) {
          if (k0 + 8 * c < GH) {
            v[i] = __ldcg(reinterpret_cast<const uint4*>(
                xt + (long long)n * GH + k0 + 8 * c));
            off[i] = n * g.LDT + 8 * c;
          }
          n += sdn, c += sdc;
          if (c >= kc8) c -= kc8, ++n;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (off[i] >= 0) *reinterpret_cast<uint4*>(tile + off[i]) = v[i];
    }
    __syncthreads();

    // (4) the partial dh of the cluster's units over the slice, each
    // n-tile sent to the CTA that owns its 8 units
    {
      float acc[2][NTW][4] = {};
      const uint32_t tb = tc::smem_addr(tile);
#pragma unroll
      for (int ks0 = 0; ks0 < MAX_KS; ks0 += 4) {
        if (ks0 * 16 >= g.KC) break;
        uint32_t a[4][2][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT)
              tc::ldmatrix_x4(a[kk][m],
                              tb + ((16 * m + (lane & 15)) * g.LDT +
                                    16 * (ks0 + kk) + 8 * (lane >> 4)) * 2);
        // k-steps past the slice read finite data against zero B
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT)
#pragma unroll
              for (int i = 0; i < NTW; ++i)
                tc::mma_bf16(acc[m][i], a[kk][m], bw[i][ks0 + kk][0],
                             bw[i][ks0 + kk][1]);
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
              st_async2(rr + (row * 8 + 2 * tq) * 4, acc[m][i][2 * e],
                        acc[m][i][2 * e + 1], rb);
            }
      }
    }

    // (5) the cluster's partials of this CTA's units: dh_{t-1}
    mbar_wait(bar_s, (g.T - 1 - t) & 1);
    if (tid == 0 && t > 0) mbar_expect(bar_s, g.bytes);   // the next phase
    if (cell) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < CL; ++r) v[r & 3] += recv[(r * 16 * MT + cn) * 8 + cj];
      const float s = (v[0] + v[1]) + (v[2] + v[3]);
      c1 = G == 4 ? s : c2 + s;
    }
  }

  // dh0, dc0, and the CTA's rows of dbh and dWh, all float32
  if (cell) {
    dh0[(long long)cn * H + j] = c1;
    if (G == 4) dc0[(long long)cn * H + j] = c2;
  }
  if (warp < R / 4 && (tid & 7) == 0) {
    const int lr = tid >> 3, q = lr / HS, jl = lr - q * HS;
    if (jl < hs) dbh[q * H + j0 + jl] = dbs;
  }
  if (hs) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int pi = 0; pi < MAX_PW; ++pi) {
        const int p = warp + NW * pi;
        if (p >= npairs) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 16 * p + 8 * h + 2 * tq;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lr = 16 * m + gq + 8 * e;
            const int q = lr / HS, jl = lr - q * HS;
            if (q < G && jl < hs && col < H)
              *reinterpret_cast<float2*>(
                  dwh + (long long)(q * H + j0 + jl) * H + col) =
                  make_float2(dw[m][2 * pi + h][2 * e],
                              dw[m][2 * pi + h][2 * e + 1]);
          }
        }
      }
  }
}

// The C entry points' body for one gate count.  Tensors as rnn_bwd_entry's
// (fused_rnn.cuh), bfloat16 only; ctr one zeroed unsigned; info receives
// (cluster size, grid CTAs, shared-memory bytes) of the launch.
template <int G>
int rnn_bwd_tc_entry(const void* acts, const void* cells, const void* ys,
                     const void* h0, const void* c0, const void* wh,
                     const void* dys, const void* dhT, const void* dcT,
                     void* dgx, void* xbuf, void* dwh, void* dbh, void* dh0,
                     void* dc0, void* ctr, int T, int N, int H, int* info,
                     void* stream) {
  TcGeo g = tc_geo(G, T, N, H);
  info[0] = CL, info[1] = up(g.P, CL), info[2] = g.total;
  const float *a0 = static_cast<const float*>(acts),
              *a1 = static_cast<const float*>(cells);
  const bf16* a2 = static_cast<const bf16*>(ys);
  const float *a3 = static_cast<const float*>(h0),
              *a4 = static_cast<const float*>(c0);
  const bf16 *a5 = static_cast<const bf16*>(wh),
             *a6 = static_cast<const bf16*>(dys),
             *a7 = static_cast<const bf16*>(dhT),
             *a8 = static_cast<const bf16*>(dcT);
  bf16 *o0 = static_cast<bf16*>(dgx), *o1 = static_cast<bf16*>(xbuf);
  float *o2 = static_cast<float*>(dwh), *o3 = static_cast<float*>(dbh),
        *o4 = static_cast<float*>(dh0), *o5 = static_cast<float*>(dc0);
  unsigned* o6 = static_cast<unsigned*>(ctr);
  void* args[] = {&g,  &a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7,
                  &a8, &o0, &o1, &o2, &o3, &o4, &o5, &o6};
  if (!tc_geo_ok(g)) return (int)cudaErrorInvalidValue;
  return (int)tc_launch(rnn_bwd_tc_kernel<G>, up(g.P, CL), g.total, args,
                        static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace rnn_tc
