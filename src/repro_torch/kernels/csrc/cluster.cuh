// Thread-block cluster helpers shared by the port's cluster kernels
// (beam_stream.cu, viterbi_dp.cu): the column split of a K-wide row across
// the CTAs of a cluster, shared-memory layout arithmetic, the launch of a
// persistent grid of as many clusters as the card holds at once, and a
// data-driven exchange through distributed shared memory: stores into
// another CTA's shared memory that count their bytes on a transaction
// barrier (mbarrier) there, which the receiving CTA waits on.
//
// Included, not compiled on its own: kernels/build.py hashes it with the
// sources so that an edit to it builds every library afresh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "cp_async.cuh"

namespace {

// CTAs per cluster: the portable maximum.
constexpr int kCluster = 8;

// Columns each CTA of a cluster owns: CTA r owns [r W, (r + 1) W) clipped
// to K, so the last CTAs own a tail or none.
__host__ __device__ inline int cols_per_cta(int K) {
  return (K + kCluster - 1) / kCluster;
}

// Threads per part: W columns rounded up to whole warps, at most `threads`.
__host__ __device__ inline int lane_width(int W, int threads) {
  const int w = ((W > 1 ? W : 1) + 31) / 32 * 32;
  return w < threads ? w : threads;
}

// Rounds a count of 4-byte words up to a 16-byte boundary.
__host__ __device__ inline int64_t align4(int64_t words) {
  return (words + 3) / 4 * 4;
}

// A transaction barrier (mbarrier) in this CTA's shared memory, completing a
// phase when its one arrival (mbar_expect) and the bytes it expects have
// come.  Initialise before the cluster barrier that precedes any remote
// store into it (mbar_init_fence makes the initialisation visible to the
// cluster).
__device__ __forceinline__ void mbar_init(uint64_t* mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(mbar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on the current phase, which then completes once `bytes` more
// bytes have been counted on it (some may have come already).
__device__ __forceinline__ void mbar_expect(uint64_t* mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(mbar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed; the stores it
// counted are then visible to the calling thread.  A phase that never
// completes traps after about 2^34 cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* mbar, uint32_t parity) {
  const uint32_t addr = smem_addr(mbar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Stores v into `dst`, a word of this CTA's shared memory, at the same
// offset in CTA `rank` of the cluster, and counts its 4 bytes on the
// mbarrier at `mbar`'s offset there.  Asynchronous: the receiver sees it
// after waiting on that mbarrier.
__device__ __forceinline__ void st_async(float* dst, uint64_t* mbar, int rank,
                                         float v) {
  uint32_t d, m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(m)
               : "r"(smem_addr(mbar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(d),
      "r"(__float_as_uint(v)), "r"(m)
      : "memory");
}

// Launches `kernel(a)` as a persistent grid of clusters of kCluster CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory: as many
// clusters as fit on the card at once (at most `tasks`), each of which walks
// the tasks blockIdx.x / kCluster, + gridDim.x / kCluster, ...  The
// occupancy query is cached per (device, kernel, smem): the current device
// is part of the key, as the answer differs between cards, and the cache is
// guarded by a mutex, as launches may come from several host threads at
// once (the wrappers call in through ctypes, which releases the GIL).
template <typename Arg>
cudaError_t launch_persistent_clusters(void (*kernel)(Arg), const Arg& a,
                                       int tasks, int threads, size_t smem,
                                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;

  struct Fit {
    int device;
    const void* fn;
    size_t smem;
    int clusters;
  };
  static Fit cache[32];   // a ring of the last 32 queries
  static int cached = 0, next = 0;
  static std::mutex cache_lock;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  {
    std::lock_guard<std::mutex> hold(cache_lock);
    for (int i = 0; i < cached; ++i) {
      if (cache[i].device == device && cache[i].fn == (const void*)kernel &&
          cache[i].smem == smem) {
        clusters = cache[i].clusters;
        break;
      }
    }
  }
  if (clusters == 0) {
    cfg.gridDim = dim3(kCluster);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    std::lock_guard<std::mutex> hold(cache_lock);
    cache[next] = Fit{device, (const void*)kernel, smem, clusters};
    next = (next + 1) % 32;
    if (cached < 32) ++cached;
  }
  if (tasks < clusters) clusters = tasks;
  cfg.gridDim = dim3(clusters * kCluster);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
