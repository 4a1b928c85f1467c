// Thread-block cluster helpers shared by the port's cluster kernels
// (beam_stream.cu, viterbi_dp.cu): the column split of a K-wide row across
// the CTAs of a cluster, shared-memory layout arithmetic, and the launch of
// a persistent grid of as many clusters as the card holds at once.
//
// Included, not compiled on its own: kernels/build.py hashes it with the
// sources so that an edit to it builds every library afresh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// Launches `kernel(a)` as a persistent grid of clusters of kCluster CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory: as many
// clusters as fit on the card at once (at most `tasks`), each of which walks
// the tasks blockIdx.x / kCluster, + gridDim.x / kCluster, ...  The
// occupancy query is cached per (kernel, smem).
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
    const void* fn;
    size_t smem;
    int clusters;
  };
  static Fit cache[32];   // a ring of the last 32 queries
  static int cached = 0, next = 0;
  int clusters = 0;
  for (int i = 0; i < cached; ++i) {
    if (cache[i].fn == (const void*)kernel && cache[i].smem == smem) {
      clusters = cache[i].clusters;
      break;
    }
  }
  if (clusters == 0) {
    cfg.gridDim = dim3(kCluster);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    cache[next] = Fit{(const void*)kernel, smem, clusters};
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
