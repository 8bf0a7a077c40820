// What the tensor-core fused-RNN kernels for Hopper (sm_90a) share: the
// launch geometry (8 hidden units a CTA, clusters of 16 CTAs), the PTX
// wrappers of cluster barriers, mbarriers and bulk copies, the split grid
// barrier, and the cooperative cluster launch.  Included by
// fused_rnn_fwd_tc.cuh (the forward) and fused_rnn_bwd_tc.cuh (the
// backward); everything is internal to each translation unit.
//
// Hang-proofing.  Every spin or mbarrier wait traps after a bounded number
// of polls rather than hanging the card, and the barrier's leader is a
// whole warp, never one thread: a warp with one lane blocked in a cluster
// wait while the others reached __syncthreads hung the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rnn_tc {
namespace {   // internal to each translation unit

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps
constexpr int HS = 8;             // hidden units a CTA: one n-tile
constexpr int CL = 16;            // CTAs a cluster
constexpr int SMEM_MAX = 232448;  // bytes one block may use

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up(int a, int b) { return cdiv(a, b) * b; }

// -- cluster, grid and mbarrier synchronisation -------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// the halves of the cluster barrier (every thread of every CTA of the
// cluster arrives, then waits, in turn)
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the shared::cluster address of the same offset in CTA `rank`'s memory
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}
__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of asynchronous completions
__device__ __forceinline__ void mbar_expect(uint32_t bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// waits for the phase of the given parity to complete; a phase that never
// completes (a fault) traps after ~2^22 tries rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done = 0, tries = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++tries == (1u << 22)) __trap();
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// orders this thread's generic-proxy accesses before its later async-proxy
// ones (bulk copies): in this CTA's shared memory, or in every state space
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// `bytes` from global memory into this CTA's shared memory by the bulk
// copy engine, completing them on the mbarrier (16-byte aligned, sizes a
// multiple of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the same bytes into the shared memory of every CTA of the cluster named
// in `mask`, at the same offset dst in each, each copy completing on the
// mbarrier at offset bar of its own CTA
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    unsigned bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}
// two floats into a peer's shared memory, completing 8 bytes on its
// mbarrier
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// The grid barrier, split.  arrive: the caller's global writes are fenced
// by their writers (fence_gpu) before it; every thread arrives at the
// cluster barrier, and the leader warp (warp 0 of rank 0) waits for its
// cluster there and counts it in.  wait: warp 0 of every CTA (the poller)
// polls until `target` clusters have arrived in all; the other threads
// complete their cluster-barrier phase; __syncthreads lets the CTA on.
// What a thread does between the two, the barrier does not wait for,
// except the poller's own work: warp 0 polls first and does its share of
// that work later.  A cluster barrier's .release arrive compiles to a
// gpu-scope MEMBAR, which also waits for the thread's loads in flight: the
// arrives are .relaxed, and the writers fence once, before them.
struct SplitBarrier {
  unsigned* ctr;
  bool leader;      // warp 0 of rank 0: uniform over a warp
  __device__ __forceinline__ void arrive() const {
    cluster_arrive_relaxed();
    if (leader) {
      cluster_wait();
      if ((threadIdx.x & 31) == 0) red_release(ctr, 1u);
      __syncwarp();
    }
  }
  __device__ __forceinline__ void wait(unsigned target) const {
    if (!leader) cluster_wait();
    if (threadIdx.x < 32) {
      // a grid that never completes the barrier (a fault) traps, after
      // ~2^26 polls (seconds), rather than hanging the card
      unsigned polls = 0;
      while (!__all_sync(0xffffffffu, ld_acquire(ctr) >= target))
        if (++polls == (1u << 26)) __trap();
    }
    __syncthreads();
  }
};

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The split barrier alone: T arrive/wait pairs over a kernel's launch
// (same grid, clusters and shared memory), the serial floor of a step.
__global__ void __launch_bounds__(NT, 1)
    split_barrier_floor_kernel(int T, unsigned* ctr) {
  const SplitBarrier bar{ctr, cluster_rank() == 0 && threadIdx.x < 32};
  const unsigned nclusters = gridDim.x / cluster_size();
  unsigned target = 0;
  for (int t = 0; t < T; ++t) {
    bar.arrive();
    target += nclusters;
    bar.wait(target);
  }
}

// -- launch -------------------------------------------------------------------
// Whether clusters of 16 CTAs of `kernel`, over a grid of `grid` CTAs (a
// multiple of 16) with `smem` bytes of dynamic shared memory each, are all
// resident at once; sets the kernel's attributes.
template <typename K>
cudaError_t tc_fits(K kernel, int grid, int smem, bool* fits) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, (const void*)kernel, &cfg);
  *fits = e == cudaSuccess && active * CL >= grid;
  return e;
}

// The cooperative cluster launch: cudaErrorCooperativeLaunchTooLarge when
// the clusters do not fit the card at once; a refused launch returns its
// error.  The caller checks its geometry first.
template <typename K>
cudaError_t tc_launch(K kernel, int grid, int smem, void** args,
                      cudaStream_t stream) {
  bool fits = false;
  cudaError_t e = tc_fits(kernel, grid, smem, &fits);
  if (e != cudaSuccess) return e;
  if (!fits) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace rnn_tc
