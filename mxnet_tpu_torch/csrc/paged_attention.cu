// Paged-attention decode kernel for NVIDIA Hopper (sm_90a).
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
// floor is (live K/V bytes + q/out bytes) / 3.35 TB/s.
//
// What the design does about it:
//   * One CTA per (batch row b, kv head h) serves all `group = Hq/Hkv`
//     q heads (one warp each), so each K/V block is read from device
//     memory once per group, not once per q head.
//   * The TPU kernel's sequential `table_slot` grid axis, which carried
//     the softmax state between grid steps, becomes a loop inside the
//     CTA over the row's live blocks; nothing carries across CTAs.  There
//     is no scalar prefetch: the CTA reads block_tables[b, w] itself.
//   * Only live blocks are visited: blocks wholly beyond ctx or wholly
//     below the window band are never loaded (the TPU kernel still ran
//     their DMA).
//   * The loads are asynchronous 16-byte (8-byte for narrow rows)
//     cp.async copies into a ring of STAGES shared-memory block buffers,
//     issued STAGES-1 blocks ahead of the block being computed, so the
//     device-memory latency of the next blocks overlaps this block's
//     math instead of stalling it.  Rows are padded by 16 bytes in shared
//     memory to spread per-position reads over the banks.
//   * The null block 0 holds garbage (padded prefill rows and dead
//     decode slots write into it), so every position is masked by its
//     position against ctx/window, never by its block id.
//
// Still simple: scores one position per lane, PV with the head
// dimension split across lanes, float32 throughout.  At the serving
// shape (B*Hkv = 24 CTAs on 132 SMs) the kernel is latency-bound;
// wgmma/TMA and split-context parallelism are later work.
//
// Plain C interface (built with nvcc into a shared library and loaded
// with ctypes by mxnet_tpu_torch/ops/paged_attention_cuda.py).  Returns
// the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDh = 256;
constexpr int kAccPerLane = kMaxDh / 32;  // head-dim slots per lane
constexpr int kMaxPosPerLane = 4;         // block_size <= 128
constexpr int kRowPad = 16;               // bytes of padding per smem row
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;         // finite: no inf - inf NaN

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Shared-memory layout, in bytes (host and device agree through these).
struct Layout {
  int row_bytes;    // one padded K or V row
  int blk_bytes;    // bs rows
  int stage_bytes;  // K block + V block (+ 2*bs scales), 16-aligned
  __host__ __device__ Layout(int bs, int Dh, int elt, bool quant) {
    row_bytes = Dh * elt + kRowPad;
    blk_bytes = bs * row_bytes;
    stage_bytes = (2 * blk_bytes + (quant ? 2 * bs * 4 : 0) + 15) & ~15;
  }
};

inline size_t smem_bytes(int stages, int bs, int Dh, int elt, bool quant,
                         int group) {
  Layout L(bs, Dh, elt, quant);
  return static_cast<size_t>(stages) * L.stage_bytes +
         sizeof(float) * (group * Dh + group * bs);
}

// grid (Hkv, B), block (group * 32).  T: q/out type; CT: cache type.
template <typename T, typename CT, bool QUANT, int STAGES>
__global__ void paged_attention_decode(
    const T* __restrict__ q, const CT* __restrict__ k_cache,
    const CT* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out, int W, int bs,
    int Hkv, int Dh, int group, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;  // q head within the group
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const Layout L(bs, Dh, sizeof(CT), QUANT);
  float* qs = reinterpret_cast<float*>(smem + STAGES * L.stage_bytes);
  float* ps = qs + group * Dh;  // (group, bs) weights of one block
  const int Hq = Hkv * group;
  const int row_data = Dh * static_cast<int>(sizeof(CT));
  const int vec = (row_data % 16 == 0) ? 16 : 8;
  const int vec_per_row = row_data / vec;

  for (int i = threadIdx.x; i < group * Dh; i += nthreads) {
    const int g = i / Dh, d = i - (i / Dh) * Dh;
    qs[i] = to_f32(q[(static_cast<size_t>(b) * Hq + h * group + g) * Dh + d]);
  }

  const int ctx = context_lens[b];
  const int lo = ctx - 1 - window;  // with a window, keep pos > lo
  int n_blocks = (ctx + bs - 1) / bs;
  if (n_blocks > W) n_blocks = W;
  // first block with a position inside the window band
  const int w_lo = (window && ctx - window > 0) ? (ctx - window) / bs : 0;
  const int n_live = n_blocks > w_lo ? n_blocks - w_lo : 0;

  // stage block w of the table into ring slot s (async; every thread
  // issues its share, completion is awaited per commit group)
  auto issue = [&](int w, int s) {
    unsigned char* st = smem + s * L.stage_bytes;
    const size_t row0 =
        static_cast<size_t>(block_tables[static_cast<size_t>(b) * W + w]) *
        bs;
    const int n = bs * vec_per_row;
    for (int i = threadIdx.x; i < 2 * n; i += nthreads) {
      const int which = i >= n;  // 0: K, 1: V
      const int j = i - which * n;
      const int p = j / vec_per_row, c = j - (j / vec_per_row) * vec_per_row;
      const size_t slot = (row0 + p) * Hkv + h;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(which ? v_cache : k_cache) +
          slot * row_data + c * vec;
      unsigned char* dst = st + which * L.blk_bytes + p * L.row_bytes + c * vec;
      if (vec == 16)
        cp_async16(dst, src);
      else
        cp_async8(dst, src);
    }
    if (QUANT) {
      float* sc = reinterpret_cast<float*>(st + 2 * L.blk_bytes);
      for (int i = threadIdx.x; i < 2 * bs; i += nthreads) {
        const int which = i >= bs;
        const size_t slot = (row0 + (i - which * bs)) * Hkv + h;
        cp_async4(sc + i, (which ? v_scale : k_scale) + slot);
      }
    }
  };

  float m = kNegInf, l = 0.f;
  float acc[kAccPerLane];
#pragma unroll
  for (int i = 0; i < kAccPerLane; ++i) acc[i] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_live) issue(w_lo + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_live; ++i) {
    const int nxt = i + STAGES - 1;
    if (nxt < n_live) issue(w_lo + nxt, nxt % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // block i's group has landed
    __syncthreads();
    const unsigned char* st = smem + (i % STAGES) * L.stage_bytes;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L.blk_bytes);
    const float* vsc = ksc + bs;
    const int base = (w_lo + i) * bs;
    if (warp < group) {
      const float* qg = qs + warp * Dh;
      float s[kMaxPosPerLane];
      unsigned keep = 0u;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < kMaxPosPerLane; ++j) {
        const int p = lane + 32 * j;
        const int pos = base + p;
        s[j] = kNegInf;
        if (p < bs && pos < ctx && (!window || pos > lo)) {
          const CT* kr = reinterpret_cast<const CT*>(st + p * L.row_bytes);
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d) dot = fmaf(qg[d], to_f32(kr[d]), dot);
          if (QUANT) dot *= ksc[p];
          s[j] = dot * scale;
          keep |= 1u << j;
          mb = fmaxf(mb, s[j]);
        }
      }
      mb = warp_max(mb);
      const float m_new = fmaxf(m, mb);
      const float alpha = expf(m - m_new);
      float* pw = ps + warp * bs;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxPosPerLane; ++j) {
        const int p = lane + 32 * j;
        if (p < bs) {
          const float pj = (keep >> j & 1u) ? expf(s[j] - m_new) : 0.f;
          psum += pj;
          pw[p] = QUANT ? pj * vsc[p] : pj;  // fold V's dequant scale in
        }
      }
      psum = warp_sum(psum);
      l = l * alpha + psum;
      m = m_new;
      __syncwarp();
      const unsigned char* vb = st + L.blk_bytes;
#pragma unroll
      for (int k = 0; k < kAccPerLane; ++k) {
        const int d = lane + 32 * k;
        if (d < Dh) {
          float a = acc[k] * alpha;
          for (int p = 0; p < bs; ++p)
            a = fmaf(pw[p],
                     to_f32(reinterpret_cast<const CT*>(vb + p * L.row_bytes)[d]),
                     a);
          acc[k] = a;
        }
      }
    }
    __syncthreads();  // slot i % STAGES is free for block i + STAGES
  }
  cp_async_wait<0>();

  if (warp < group) {
    // a row that accumulated nothing (context_lens == 0) emits zeros
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out + (static_cast<size_t>(b) * Hq + h * group + warp) * Dh;
#pragma unroll
    for (int k = 0; k < kAccPerLane; ++k) {
      const int d = lane + 32 * k;
      if (d < Dh) o[d] = from_f32<T>(acc[k] * inv);
    }
  }
}

template <typename T, typename CT, bool QUANT, int STAGES>
cudaError_t launch_stages(const void* q, const void* kc, const void* vc,
                          const void* ksc, const void* vsc, const void* bt,
                          const void* ctx, void* out, int B, int Hq, int Hkv,
                          int Dh, int bs, int W, int window, float scale,
                          cudaStream_t stream) {
  const int group = Hq / Hkv;
  const size_t smem = smem_bytes(STAGES, bs, Dh, sizeof(CT), QUANT, group);
  auto kernel = paged_attention_decode<T, CT, QUANT, STAGES>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hkv, B);
  dim3 block(group * 32);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const CT*>(kc),
      static_cast<const CT*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(bt),
      static_cast<const int*>(ctx), static_cast<T*>(out), W, bs, Hkv, Dh,
      group, window, scale);
  return cudaGetLastError();
}

// four blocks in flight where they fit in shared memory, else two
template <typename T, typename CT, bool QUANT>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ksc, const void* vsc, const void* bt,
                   const void* ctx, void* out, int B, int Hq, int Hkv, int Dh,
                   int bs, int W, int window, float scale,
                   cudaStream_t stream) {
  const int group = Hq / Hkv;
  if (smem_bytes(4, bs, Dh, sizeof(CT), QUANT, group) <= kMaxSmem)
    return launch_stages<T, CT, QUANT, 4>(q, kc, vc, ksc, vsc, bt, ctx, out,
                                          B, Hq, Hkv, Dh, bs, W, window,
                                          scale, stream);
  if (smem_bytes(2, bs, Dh, sizeof(CT), QUANT, group) <= kMaxSmem)
    return launch_stages<T, CT, QUANT, 2>(q, kc, vc, ksc, vsc, bt, ctx, out,
                                          B, Hq, Hkv, Dh, bs, W, window,
                                          scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only).
extern "C" int mxtt_paged_attention_decode(
    int q_dtype, int cache_dtype, const void* q, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* context_lens, void* out, int B,
    int Hq, int Hkv, int Dh, int bs, int W, int window, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > 32 || Dh <= 0 ||
      Dh > kMaxDh || Dh % 8 || bs <= 0 || bs > 32 * kMaxPosPerLane || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXTT_ARGS                                                          \
  q, k_cache, v_cache, k_scale, v_scale, block_tables, context_lens, out, \
      B, Hq, Hkv, Dh, bs, W, window, scale, s
  if (q_dtype == 0 && cache_dtype == 0)
    return static_cast<int>(launch<float, float, false>(MXTT_ARGS));
  if (q_dtype == 1 && cache_dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16, __nv_bfloat16, false>(MXTT_ARGS));
  if (q_dtype == 0 && cache_dtype == 2)
    return static_cast<int>(launch<float, int8_t, true>(MXTT_ARGS));
  if (q_dtype == 1 && cache_dtype == 2)
    return static_cast<int>(launch<__nv_bfloat16, int8_t, true>(MXTT_ARGS));
#undef MXTT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
