// Asynchronous copies from global to shared memory, for the port's kernels
// that stage their inputs ahead of use (tropical.cu): cp.async (sm_80 and
// later), where a thread issues copies, closes them into a commit group,
// and waits for all but its newest N groups, a barrier then making every
// thread's copies visible to the CTA.  Also the shared-memory address
// helper that cluster.cuh's mbarrier and remote-store helpers use.
//
// Included, not compiled on its own: kernels/build.py hashes it with the
// sources so that an edit to it builds every library afresh.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes: any 4-byte aligned source and destination.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes: source and destination 16-byte aligned; bypasses L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
