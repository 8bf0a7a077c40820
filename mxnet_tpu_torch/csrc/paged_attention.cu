// Paged-attention decode for NVIDIA Hopper (sm_90a): a split kernel and a
// combine kernel (flash-decoding).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_paged_attention.py
// `paged_attention_kernel` (body `_kernel`): single-token decode
// attention through per-request block tables, online float32 softmax,
// native grouped-query heads, an optional sliding window, and optional
// int8 K/V with per-slot-per-head float32 scales dequantized in-kernel.
//
// What bounds it: the bytes of live K/V.  A decode step reads every live
// cache position of every kv head once and does ~4*Dh flops per position
// and q head, far below the card's ~295 flop/byte balance point, so the
// floor is (live K/V bytes + q/out bytes) / 3.35 TB/s.  Reaching it needs
// enough bytes in flight on every SM, and no latency in series per block.
//
// What the design does about it:
//   * The context is split across CTAs.  The split kernel's grid is
//     (Hkv, B, splits): split s covers table columns [s*bps, (s+1)*bps)
//     of its row, intersected with the row's live range [w_lo, n_blocks)
//     (computed per row on the device), so a long row is walked by many
//     CTAs at once: one CTA per (kv head, row) alone would be B*Hkv = 24
//     CTAs on 132 SMs at the serving shape, each walking its row in
//     series.  Each split writes its float32 partial softmax state:
//     unnormalised acc (B, Hq, splits, Dh), running max m and sum l
//     (B, Hq, splits), m in natural-log units of the scaled score.  A
//     split with nothing live writes m = -1e30, l = 0, acc = 0.  The
//     combine kernel merges a row's splits, M = max m_s, L = sum l_s
//     e^(m_s - M), out = sum acc_s e^(m_s - M) / L (zeros where L == 0),
//     and rounds to q's dtype once, at the store.  It is launched as a
//     programmatic dependent of the split kernel (griddepcontrol), so its
//     launch overlaps the split kernel's tail.  With one split the split
//     kernel normalises and writes the output itself, and no combine
//     runs.  The wrapper plans (splits, bps) from shapes and the
//     SM count only (ops/paged_attention_cuda.py `_split_plan`), never
//     from context_lens's values: no host sync, and one launch geometry
//     per batch shape.
//   * The block table is read once per CTA: before its first copy the
//     CTA stages its <= bps table entries in shared memory (the TPU
//     kernel's scalar prefetch), loaded together with the row's ctx and
//     its q, so no cp.async waits on a dependent global load of the
//     table, and one round trip precedes the first copy.
//   * Every lane scores.  A K or V row is cut into units of 8 elements
//     (32 bytes f32, 16 bf16, 8 int8); lpr = the next power of two >=
//     Dh/8 lanes share a row, one unit each, so a warp scores 32/lpr
//     positions a step (bf16 Dh 64: 8 lanes a row, 4 rows a step).  Each
//     dot is summed over its lanes with xor shuffles; the same lanes then
//     multiply V over the same units, so probabilities never go through
//     shared memory.  The lanes' accumulators are summed across the
//     warp's row groups once, at the end.  Rows whose Dh/8 is not a power
//     of two leave lpr - Dh/8 lanes of each row idle.  A chunk of kSteps
//     rows a row group is unrolled without a branch: a row past the
//     slot's positions reads the slot's last row and is masked (the V rows
//     past them are zeroed), so the rows' loads, dots and shuffles
//     overlap instead of running in series.
//   * One warp per q head of the kv head's group, so each K/V byte is read
//     from device memory once per group.
//   * The loads are asynchronous 16-byte (8-byte for int8 rows of an odd
//     number of 8-byte units) cp.async copies into a ring of STAGES slots
//     of several whole table blocks (about kSlotRows positions), so the
//     ring's two __syncthreads are paid once a slot; the copy loop
//     divides by the row width and block size with a multiply-high, not
//     a division.  Rows are unpadded:
//     the 8 lanes of a 16-byte phase read 128 contiguous bytes (f32 units
//     are read as two 16-byte halves, Dh/2 elements apart, for that).
//   * Only live blocks are visited: blocks wholly beyond ctx or wholly
//     below the window band are never loaded.
//   * The null block 0 holds garbage (padded prefill rows and dead
//     decode slots write into it), so every position is masked by its
//     position against ctx/window, never by its block id.
//
// Limits: Dh % 8 == 0, Dh <= 256, block_size <= 128, GQA group <= 32,
// blocks per split <= kMaxTable, splits <= 65535, splits * bps >= W, and
// the ring of at least two one-block slots plus the table within 227 KB.
//
// Plain C interface (built with nvcc into a shared library and loaded
// with ctypes by mxnet_tpu_torch/ops/paged_attention_cuda.py).  Each
// entry point returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDh = 256;
constexpr int kMaxBs = 128;
constexpr int kMaxGroup = 32;
constexpr int kSmallGroup = 8;  // groups up to this get 256-thread bounds
constexpr int kMaxTable = 512;  // table entries a CTA stages (bps cap)
constexpr int kSlotRows = 64;   // positions a ring slot aims to hold
constexpr int kSteps = 8;       // rows a lane scores between max updates
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;  // finite: no inf - inf NaN
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// A lane's unit of a K/V row in shared memory: 8 elements as float.
// `u` is the unit (lane within its row group), `nv` = Dh / 8.
template <typename CT>
struct Unit;

template <>
struct Unit<float> {
  // elements [4u, 4u+4) and [Dh/2 + 4u, Dh/2 + 4u + 4): two 16-byte reads,
  // so 8 lanes of a row read 128 contiguous bytes in each
  __device__ static __forceinline__ void load(const unsigned char* row,
                                              int u, int nv, float (&x)[8]) {
    const float4 a = reinterpret_cast<const float4*>(row)[u];
    const float4 b = reinterpret_cast<const float4*>(row)[nv + u];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  }
  __device__ static __forceinline__ int elem(int u, int nv, int j) {
    return j < 4 ? 4 * u + j : 4 * (nv + u) + j - 4;
  }
};

template <>
struct Unit<__nv_bfloat16> {
  // elements [8u, 8u+8): one 16-byte read
  __device__ static __forceinline__ void load(const unsigned char* row,
                                              int u, int, float (&x)[8]) {
    const uint4 w = reinterpret_cast<const uint4*>(row)[u];
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(ws[i] << 16);
      x[2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ int elem(int u, int, int j) {
    return 8 * u + j;
  }
};

template <>
struct Unit<int8_t> {
  // elements [8u, 8u+8): one 8-byte read
  __device__ static __forceinline__ void load(const unsigned char* row,
                                              int u, int, float (&x)[8]) {
    const uint2 w = reinterpret_cast<const uint2*>(row)[u];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = static_cast<float>(static_cast<int8_t>(w.x >> (8 * i)));
      x[4 + i] = static_cast<float>(static_cast<int8_t>(w.y >> (8 * i)));
    }
  }
  __device__ static __forceinline__ int elem(int u, int, int j) {
    return 8 * u + j;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lanes that share a row: one 8-element unit each, a power of two.
__device__ __forceinline__ int lanes_per_row(int Dh) {
  int lpr = 1;
  while (lpr < Dh / 8) lpr <<= 1;
  return lpr;
}

// Shared-memory layout of one ring slot, in bytes (host and device agree
// through these): K rows, V rows (unpadded), then K and V scales.
struct Layout {
  int rows;         // positions a slot holds (whole blocks)
  int row_bytes;    // one K or V row
  int kv_bytes;     // rows * row_bytes
  int stage_bytes;  // K + V (+ 2 * rows scales), 16-aligned
  __host__ __device__ Layout(int rows_, int Dh, int elt, bool quant) {
    rows = rows_;
    row_bytes = Dh * elt;
    kv_bytes = rows * row_bytes;
    stage_bytes = (2 * kv_bytes + (quant ? 2 * rows * 4 : 0) + 15) & ~15;
  }
};

// x / d for the small x of the copy loops, without a division: one
// multiply-high by ceil(2^32 / d), exact while x * d < 2^32.
struct FastDiv {
  unsigned d, mul;
  __device__ explicit FastDiv(unsigned d_)
      : d(d_),
        mul(d_ == 1 ? 0u
                    : static_cast<unsigned>((0x100000000ull + d_ - 1) / d_)) {}
  __device__ __forceinline__ unsigned div(unsigned x) const {
    return d == 1 ? x : __umulhi(x, mul);
  }
};

inline size_t smem_bytes(int stages, const Layout& L, int bps) {
  return static_cast<size_t>(stages) * L.stage_bytes +
         ((static_cast<size_t>(bps) * 4 + 15) & ~static_cast<size_t>(15));
}

// grid (Hkv, B, splits), block (group * 32 <= MAXT): warp g serves q
// head h * group + g.  T: q/out type; CT: cache type.  nbs: table blocks
// a ring slot holds.  MAXT bounds the block, and so the registers.
template <typename T, typename CT, bool QUANT, int STAGES, int MAXT>
__global__ void __launch_bounds__(MAXT) paged_attention_split(
    const T* __restrict__ q, const CT* __restrict__ k_cache,
    const CT* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int W, int bs, int Hkv, int Dh, int group,
    int window, float scale, int bps, int nbs) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the combine kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int warp = threadIdx.x >> 5;  // q head within the group
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int Hq = Hkv * group;
  const int qh = h * group + warp;
  const int nv = Dh >> 3;  // units a row
  const int lpr = lanes_per_row(Dh);
  const int rpw = 32 / lpr;  // rows a warp step
  const int u = lane & (lpr - 1);
  const int rg = lane / lpr;  // row group
  const bool has_unit = u < nv;
  const int ul = has_unit ? u : 0;  // idle lanes read unit 0, weigh it 0
  const Layout L(nbs * bs, Dh, sizeof(CT), QUANT);
  const size_t prow = (static_cast<size_t>(b) * Hq + qh) * splits + split;
  T* orow = out + (static_cast<size_t>(b) * Hq + qh) * Dh;

  // The split's slice of the block table, its q unit and the row's ctx
  // are loaded together: the slice [t0, t0 + bps) needs no ctx, so one
  // round trip to device memory precedes the first K/V copy, not two.
  const int t0 = split * bps;
  int* tbl = reinterpret_cast<int*>(smem + STAGES * L.stage_bytes);
  const int ctx = context_lens[b];
  for (int i = threadIdx.x; i < min(bps, W - t0); i += nthreads)
    tbl[i] = block_tables[static_cast<size_t>(b) * W + t0 + i];
  // this lane's unit of q, in log2 units of the scaled score
  float qv[8];
  const float qscale = scale * kLog2e;
  const T* qrow = q + (static_cast<size_t>(b) * Hq + qh) * Dh;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    qv[j] = has_unit ? to_f32(qrow[Unit<CT>::elem(u, nv, j)]) * qscale : 0.f;

  const int lo = ctx - 1 - window;  // with a window, keep pos > lo
  int n_blocks = (ctx + bs - 1) / bs;
  if (n_blocks > W) n_blocks = W;
  // first block with a position inside the window band
  const int w_lo = (window && ctx - window > 0) ? (ctx - window) / bs : 0;
  const int c0 = max(t0, w_lo);
  const int c1 = min(t0 + bps, n_blocks);
  if (c0 >= c1) {  // nothing live: the same for the whole CTA
    if (splits == 1) {
      for (int d = lane; d < Dh; d += 32) orow[d] = from_f32<T>(0.f);
    } else {
      for (int d = lane; d < Dh; d += 32) part_acc[prow * Dh + d] = 0.f;
      if (lane == 0) {
        part_m[prow] = kNegInf;
        part_l[prow] = 0.f;
      }
    }
    return;
  }
  const int ncols = c1 - c0;
  const int* ctbl = tbl + (c0 - t0);  // table entry of column c0 + i
  __syncthreads();  // the table is visible

  const int row_data = L.row_bytes;
  const int vec = (row_data % 16 == 0) ? 16 : 8;
  const int vpr = row_data / vec;
  const FastDiv div_vpr(vpr), div_bs(bs);
  const int n_slots = (ncols + nbs - 1) / nbs;

  // stage slot `slot` (table columns c0 + slot*nbs ...) into ring stage
  // `st_i` (async; every thread issues its share, completion is awaited
  // per commit group).  V rows past the slot's positions are zeroed, so
  // a zero weight never meets a stale NaN.
  auto issue = [&](int slot, int st_i) {
    unsigned char* st = smem + st_i * L.stage_bytes;
    const int col0 = slot * nbs;
    const int nrows = min(nbs, ncols - col0) * bs;
    const unsigned n = nrows * vpr;
    for (unsigned i = threadIdx.x; i < 2 * n; i += nthreads) {
      const unsigned which = i >= n;  // 0: K, 1: V
      const unsigned j = i - which * n;
      const unsigned r = div_vpr.div(j), c = j - r * vpr;
      const unsigned cc = div_bs.div(r), p = r - cc * bs;
      const size_t slot_idx =
          (static_cast<size_t>(ctbl[col0 + cc]) * bs + p) * Hkv + h;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(which ? v_cache : k_cache) +
          slot_idx * row_data + c * vec;
      unsigned char* dst = st + which * L.kv_bytes + r * row_data + c * vec;
      if (vec == 16)
        cp_async16(dst, src);
      else
        cp_async8(dst, src);
    }
    if (!QUANT) {
      uint2* tail = reinterpret_cast<uint2*>(st + L.kv_bytes +
                                             nrows * row_data);
      const int n8 = (L.rows - nrows) * row_data / 8;
      for (int i = threadIdx.x; i < n8; i += nthreads)
        tail[i] = make_uint2(0u, 0u);
    }
    if (QUANT) {
      float* sc = reinterpret_cast<float*>(st + 2 * L.kv_bytes);
      for (unsigned i = threadIdx.x; i < 2u * nrows; i += nthreads) {
        const unsigned which = i >= static_cast<unsigned>(nrows);
        const unsigned r = i - which * nrows;
        const unsigned cc = div_bs.div(r), p = r - cc * bs;
        const size_t slot_idx =
            (static_cast<size_t>(ctbl[col0 + cc]) * bs + p) * Hkv + h;
        cp_async4(sc + which * L.rows + r,
                  (which ? v_scale : k_scale) + slot_idx);
      }
    }
  };

  // m: running max (log2 units, warp-uniform); l: this row group's sum
  float m = kNegInf, l = 0.f;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_slots) issue(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_slots; ++i) {
    const int nxt = i + STAGES - 1;
    if (nxt < n_slots) issue(nxt, nxt % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // slot i's group has landed
    __syncthreads();
    const unsigned char* kb = smem + (i % STAGES) * L.stage_bytes;
    const unsigned char* vb = kb + L.kv_bytes;
    const float* ksc = reinterpret_cast<const float*>(kb + 2 * L.kv_bytes);
    const float* vsc = ksc + L.rows;
    const int nrows = min(nbs, ncols - i * nbs) * bs;
    const int pos0 = (c0 + i * nbs) * bs;
    for (int r0 = 0; r0 < nrows; r0 += kSteps * rpw) {
      // kSteps rows a row group, every row read without a branch (a row
      // past the slot's positions reads the slot's last row and is
      // masked): their dots, then their shuffles, are independent, so
      // each phase overlaps its rows' latencies
      float s[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int rr = min(r0 + j * rpw + rg, L.rows - 1);
        float x[8];
        Unit<CT>::load(kb + rr * row_data, ul, nv, x);
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d0 = fmaf(qv[e], x[e], d0);
          d1 = fmaf(qv[e + 4], x[e + 4], d1);
        }
        s[j] = d0 + d1;
      }
      for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kSteps; ++j)
          s[j] += __shfl_xor_sync(kFull, s[j], o);
      }
      unsigned keep = 0u;
      float mloc = kNegInf;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int r = r0 + j * rpw + rg;
        const int pos = pos0 + r;
        const bool kept = r < nrows && pos < ctx && (!window || pos > lo);
        if (QUANT) s[j] *= ksc[min(r, L.rows - 1)];
        s[j] = kept ? s[j] : kNegInf;
        keep |= static_cast<unsigned>(kept) << j;
        mloc = fmaxf(mloc, s[j]);
      }
      for (int o = lpr; o < 32; o <<= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(kFull, mloc, o));
      const float m_new = fmaxf(m, mloc);
      const float alpha = exp2f(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const float p = exp2f(s[j] - m_new);
        const bool kept = keep >> j & 1u;
        l += kept ? p : 0.f;
        // fold V's dequant scale in; masked rows weigh exactly 0
        const int rr = min(r0 + j * rpw + rg, L.rows - 1);
        const float w = kept ? (QUANT ? p * vsc[rr] : p) : 0.f;
        float x[8];
        Unit<CT>::load(vb + rr * row_data, ul, nv, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, x[e], acc[e]);
      }
    }
    __syncthreads();  // slot i % STAGES is free for slot i + STAGES
  }
  cp_async_wait<0>();

  // sum the row groups' accumulators and sums, once
  for (int o = lpr; o < 32; o <<= 1) {
    l += __shfl_xor_sync(kFull, l, o);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  }
  if (splits == 1) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if (rg == 0 && has_unit) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        orow[Unit<CT>::elem(u, nv, j)] = from_f32<T>(acc[j] * inv);
    }
  } else {
    if (rg == 0 && has_unit) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part_acc[prow * Dh + Unit<CT>::elem(u, nv, j)] = acc[j];
    }
    if (lane == 0) {
      part_m[prow] = m > kNegInf ? m * kLn2 : kNegInf;
      part_l[prow] = l;
    }
  }
}

// (M, L) <- the merge of two partial softmax states (max, sum).
__device__ __forceinline__ void merge_ml(float& M, float& L, float m2,
                                         float l2) {
  const float Mn = fmaxf(M, m2);
  L = L * expf(M - Mn) + l2 * expf(m2 - Mn);
  M = Mn;
}

// grid (B * Hq), block (Dh rounded up to 32): one (row, q head) a CTA,
// one head-dim element a thread, all in float32, rounded once at the
// store.  Launched as a programmatic dependent of the split kernel: its
// launch overlaps the split kernel's tail, and griddepcontrol.wait holds
// it until the partials are written.  Each thread merges its strided
// splits' (m, l) online, the warps' pairs are merged in shared memory,
// and the acc loop is unrolled so its loads overlap.
template <typename T>
__global__ void paged_attention_combine(const float* __restrict__ part_acc,
                                        const float* __restrict__ part_m,
                                        const float* __restrict__ part_l,
                                        T* __restrict__ out, int splits,
                                        int Dh) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float red_m[kMaxDh / 32], red_l[kMaxDh / 32];
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5, nwarps = blockDim.x >> 5;
  const float* mr = part_m + row * splits;
  const float* lr = part_l + row * splits;
  float M = kNegInf, L = 0.f;
  for (int s = d; s < splits; s += blockDim.x) merge_ml(M, L, mr[s], lr[s]);
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, M, o);
    const float l2 = __shfl_xor_sync(kFull, L, o);
    merge_ml(M, L, m2, l2);
  }
  if (lane == 0) {
    red_m[warp] = M;
    red_l[warp] = L;
  }
  __syncthreads();
  M = red_m[0];
  L = red_l[0];
  for (int w = 1; w < nwarps; ++w) merge_ml(M, L, red_m[w], red_l[w]);
  if (d >= Dh) return;
  const float* a = part_acc + row * splits * Dh + d;
  float o = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s)
    o = fmaf(a[static_cast<size_t>(s) * Dh], expf(mr[s] - M), o);
  // a row whose every split is empty (context_lens == 0) emits zeros
  out[row * Dh + d] = from_f32<T>(L > 0.f ? o / L : 0.f);
}

template <typename T>
cudaError_t launch_combine(const float* acc, const float* m, const float* l,
                           void* out, int rows, int splits, int Dh,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3((Dh + 31) / 32 * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_attention_combine<T>, acc, m, l,
                            static_cast<T*>(out), splits, Dh);
}

struct SplitArgs {
  const void *q, *kc, *vc, *ksc, *vsc, *bt, *ctx;
  void *out, *acc, *m, *l;
  int B, Hq, Hkv, Dh, bs, W, window;
  float scale;
  int splits, bps;
  cudaStream_t stream;
};

template <typename T, typename CT, bool QUANT, int STAGES, int MAXT>
cudaError_t launch_stages(const SplitArgs& a, int nbs, size_t smem) {
  auto kernel = paged_attention_split<T, CT, QUANT, STAGES, MAXT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int group = a.Hq / a.Hkv;
  dim3 grid(a.Hkv, a.B, a.splits);
  dim3 block(group * 32);
  kernel<<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const CT*>(a.kc),
      static_cast<const CT*>(a.vc), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.ctx), static_cast<T*>(a.out),
      static_cast<float*>(a.acc), static_cast<float*>(a.m),
      static_cast<float*>(a.l), a.W, a.bs, a.Hkv, a.Dh, group, a.window,
      a.scale, a.bps, nbs);
  return cudaGetLastError();
}

// Slots of about kSlotRows positions (whole blocks, at most bps), four
// in flight where the ring fits in half an SM's shared memory (two CTAs
// an SM), else two; else fewer blocks a slot; else the whole SM.
template <typename T, typename CT, bool QUANT>
cudaError_t launch(const SplitArgs& a) {
  int nbs = kSlotRows / a.bs;
  if (nbs < 1) nbs = 1;
  if (nbs > a.bps) nbs = a.bps;
  const size_t budgets[2] = {kMaxSmem / 2, kMaxSmem};
  for (size_t budget : budgets) {
    for (int n = nbs; n >= 1; n = n > 1 ? n / 2 : 0) {
      const Layout L(n * a.bs, a.Dh, sizeof(CT), QUANT);
      size_t smem = smem_bytes(4, L, a.bps);
      if (smem <= budget)
        return a.Hq / a.Hkv <= kSmallGroup
                   ? launch_stages<T, CT, QUANT, 4, kSmallGroup * 32>(a, n,
                                                                     smem)
                   : launch_stages<T, CT, QUANT, 4, kMaxGroup * 32>(a, n,
                                                                   smem);
      smem = smem_bytes(2, L, a.bps);
      if (smem <= budget)
        return a.Hq / a.Hkv <= kSmallGroup
                   ? launch_stages<T, CT, QUANT, 2, kSmallGroup * 32>(a, n,
                                                                     smem)
                   : launch_stages<T, CT, QUANT, 2, kMaxGroup * 32>(a, n,
                                                                   smem);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only).
// With splits == 1 the kernel writes `out`; otherwise the float32
// partials part_acc (B, Hq, splits, Dh), part_m and part_l (B, Hq,
// splits), which mxtt_paged_attention_combine merges into `out`.
extern "C" int mxtt_paged_attention_split(
    int q_dtype, int cache_dtype, const void* q, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* context_lens, void* out,
    void* part_acc, void* part_m, void* part_l, int B, int Hq, int Hkv,
    int Dh, int bs, int W, int window, float scale, int splits, int bps,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxGroup || Dh <= 0 ||
      Dh > kMaxDh || Dh % 8 || bs <= 0 || bs > kMaxBs || W <= 0 ||
      splits < 1 || splits > 65535 || bps < 1 || bps > kMaxTable ||
      static_cast<long long>(splits) * bps < W ||
      (splits > 1 && (!part_acc || !part_m || !part_l)))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q,     k_cache, v_cache, k_scale, v_scale, block_tables,
                    context_lens,   out,     part_acc, part_m, part_l,
                    B,     Hq,      Hkv,     Dh,      bs,      W,
                    window, scale,  splits,  bps,
                    static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0)
    return static_cast<int>(launch<float, float, false>(a));
  if (q_dtype == 1 && cache_dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16, false>(a));
  if (q_dtype == 0 && cache_dtype == 2)
    return static_cast<int>(launch<float, int8_t, true>(a));
  if (q_dtype == 1 && cache_dtype == 2)
    return static_cast<int>(launch<__nv_bfloat16, int8_t, true>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// rows = B * Hq partial rows of `splits` splits each; out (rows, Dh).
extern "C" int mxtt_paged_attention_combine(int q_dtype, const void* part_acc,
                                            const void* part_m,
                                            const void* part_l, void* out,
                                            int rows, int splits, int Dh,
                                            void* stream) {
  if (rows <= 0 || splits < 1 || Dh <= 0 || Dh > kMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* acc = static_cast<const float*>(part_acc);
  const float* m = static_cast<const float*>(part_m);
  const float* l = static_cast<const float*>(part_l);
  cudaError_t e;
  if (q_dtype == 0)
    e = launch_combine<float>(acc, m, l, out, rows, splits, Dh, s);
  else if (q_dtype == 1)
    e = launch_combine<__nv_bfloat16>(acc, m, l, out, rows, splits, Dh, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
