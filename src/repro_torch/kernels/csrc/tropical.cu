// Batched tropical (max, +) matrix product for NVIDIA Hopper (sm_90a).
//
// tropical_matmul_batch replaces the Pallas TPU kernel `_tropical_kernel`
// behind `tropical_matmul` (src/repro/kernels/tropical.py:30, :66).  For each
// of N independent products of A (I, K) and B (K, J) it computes
//     vals[n, i, j] = max_k (A[n, i, k] + B[n, k, j])
//     args[n, i, j] = the lowest k that attains the max
// in f32 or bf16.  In bf16 each sum is formed in f32 and rounded to bf16
// (round to nearest even) before the max, which is what XLA's bf16 add does
// on the CPU; the max and its argmax compare the rounded values.
//
// Design.  The TPU kernel tiles (I, J, K) for the VPU (the MXU cannot do a
// (max, +) product) and carries the running max across K tiles in its
// output block.  Here one thread owns one output element and scans k upward
// with a strict '>', so the lowest index wins ties, as `jnp.argmax` and the
// TPU kernel's strict '>' across K tiles do.  Threads of a warp share i and
// take consecutive j: the row of A is a broadcast read, the column of B
// coalesced.  Blocks are (32, 8) threads over (j, i) and the grid's z axis
// walks the N products, so one launch combines every pair of one level of
// the associative scan (`core/assoc.py`).
//
// What bounds it.  2 * N * I * J * K f32 operations against the bytes of A,
// B, vals and args once each; at the assoc shape (N, I, K, J) = (2048, 64,
// 64, 64) the operations bound it.  A and B are re-read from L1/L2 for every
// output; tiling both through shared memory is the faster design left for
// later.
//
// Exactness: no fast-math; one add (and in bf16 one rounding) per candidate,
// then an exact max.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() (0 on success); the launch goes on the caller's stream
// and the calling thread's current device, which the Python wrapper sets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float add_round(float a, float b, float) {
  return a + b;
}
__device__ __forceinline__ float add_round(float a, float b, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(a + b));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // v is already a bf16 value: exact
}

template <typename T>
__global__ void tropical_matmul_batch_kernel(
    const T* __restrict__ a,     // (N, I, K) contiguous
    const T* __restrict__ b,     // (N, K, J) contiguous
    int I, int K, int J,
    T* __restrict__ vals,        // (N, I, J) contiguous
    int* __restrict__ args) {    // (N, I, J) contiguous
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= I || j >= J) return;
  const int64_t n = blockIdx.z;
  const T* a_row = a + (n * I + i) * (int64_t)K;
  const T* b_col = b + n * (int64_t)K * J + j;
  float best = add_round(load_f32(a_row), load_f32(b_col), T());
  int arg = 0;
  for (int k = 1; k < K; ++k) {
    const float v =
        add_round(load_f32(a_row + k), load_f32(b_col + (int64_t)k * J), T());
    if (v > best) {
      best = v;
      arg = k;
    }
  }
  const int64_t o = (n * I + i) * (int64_t)J + j;
  store(vals + o, best);
  args[o] = arg;
}

template <typename T>
int launch(const void* a, const void* b, int N, int I, int K, int J,
           void* vals, void* args, void* stream) {
  const dim3 block(32, 8);
  const int kMaxZ = 65535;   // the grid's z limit: launch N in slices
  for (int n0 = 0; n0 < N; n0 += kMaxZ) {
    const int nz = N - n0 < kMaxZ ? N - n0 : kMaxZ;
    const dim3 grid((J + 31) / 32, (I + 7) / 8, nz);
    tropical_matmul_batch_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)a + (int64_t)n0 * I * K, (const T*)b + (int64_t)n0 * K * J,
        I, K, J, (T*)vals + (int64_t)n0 * I * J,
        (int*)args + (int64_t)n0 * I * J);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// bf16 != 0 selects bfloat16 operands and values; else float32.
extern "C" int tropical_matmul_batch(const void* a, const void* b, int bf16,
                                     int N, int I, int K, int J, void* vals,
                                     void* args, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(a, b, N, I, K, J, vals, args, stream);
  return launch<float>(a, b, N, I, K, J, vals, args, stream);
}
