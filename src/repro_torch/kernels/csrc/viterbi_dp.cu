// Fused Viterbi forward pass and batched backtrack for NVIDIA Hopper (sm_90a).
//
// viterbi_fwd_batch replaces the Pallas TPU kernel `_viterbi_fwd_kernel`
// behind `viterbi_forward_batch` (src/repro/kernels/viterbi_dp.py:45, :74).
// For each sequence b and step t it computes
//     delta_t[j] = max_k (delta_{t-1}[k] + log_A[k, j]) + em[b, t, j]
// and psi[b, t, j], the lowest k that attains the max.  Steps whose pad flag
// is > 0.5 freeze delta and write the identity row.
//
// Design.  The TPU kernel carries delta across sequential "arbitrary" grid
// steps in VMEM scratch; CUDA blocks run concurrently and carry nothing
// between them.  So one block owns one sequence and runs the whole time loop
// itself: delta lives in shared memory, double-buffered (2*K floats), with
// one __syncthreads() per step.  Thread i owns the columns j = i, i + blockDim,
// ..., which covers any K >= 1.  log_A (1 MiB at K = 512) does not fit in a
// block's 227 KB of shared memory, so it is read from global memory, where it
// stays hot in the 50 MB L2 for the whole launch.
//
// What bounds it.  Each step streams all K*K entries of log_A from L2 into
// one SM, so the kernel is bound by the rate at which one SM draws from L2,
// times B resident SMs, far above both the card's memory-bandwidth bound (em
// in, psi out) and its f32 operation bound (2*B*T*K^2 adds and compares).
// With B = 8 it uses 8 of the 132 SMs.  chip_smoke.py measured 21.7 ms at
// (B, T, K) = (8, 511, 512) against a 0.032 ms bound, about 25 GB/s of L2
// reads per SM, on an NVIDIA H100 80GB HBM3 at 700 W.  Splitting each
// sequence's columns across a cluster of blocks, each holding its slice of
// log_A in shared memory, is the redesign that closes that gap; it is left
// to a later change.
//
// Exactness.  One f32 add per score, an exact max, then one f32 add of em, in
// that order, as in the TPU kernel; k is scanned in ascending order with a
// strict '>' so the lowest index wins ties.  Ties are the normal case: in a
// left-to-right HMM every off-band transition is -1e9 and -1e9 + em rounds
// back to -1e9 in f32.  Build without --use_fast_math.
//
// viterbi_backtrack_batch replaces the XLA reverse scans of
// `viterbi_decode_fused_batch` (src/repro/kernels/ops.py:213-220).  One
// thread per sequence takes the lowest-index argmax of delta_T[b] and walks
// psi back.  It is bound by the latency of T dependent loads, not by bytes.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() (0 on success); launches go on the caller's stream and
// the calling thread's current device, which the Python wrapper sets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void viterbi_fwd_batch_kernel(
    const float* __restrict__ log_A,   // (K, K) [src, dst], contiguous
    const float* __restrict__ em,      // (B, T, K), strides (em_sb, em_st, 1)
    int64_t em_sb, int64_t em_st,
    const float* __restrict__ delta0,  // (B, K) contiguous
    const float* __restrict__ pad,     // (B, T) contiguous, or nullptr
    int T, int K,
    int* __restrict__ psi,             // (B, T, K) contiguous
    float* __restrict__ delta_T) {     // (B, K) contiguous
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + K;
  const int64_t b = blockIdx.x;
  for (int j = threadIdx.x; j < K; j += blockDim.x) cur[j] = delta0[b * K + j];
  __syncthreads();

  const float* em_b = em + b * em_sb;
  int* psi_b = psi + b * (int64_t)T * K;
  for (int t = 0; t < T; ++t) {
    const bool is_pad = pad != nullptr && pad[b * T + t] > 0.5f;
    const float* em_t = em_b + (int64_t)t * em_st;
    int* psi_t = psi_b + (int64_t)t * K;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      if (is_pad) {                      // tropical identity step
        nxt[j] = cur[j];
        psi_t[j] = j;
        continue;
      }
      const float* a = log_A + j;
      float best = cur[0] + a[0];
      int arg = 0;
#pragma unroll 8
      for (int k = 1; k < K; ++k) {
        const float v = cur[k] + a[(int64_t)k * K];
        if (v > best) {
          best = v;
          arg = k;
        }
      }
      nxt[j] = best + em_t[j];
      psi_t[j] = arg;
    }
    __syncthreads();                     // nxt complete, cur no longer read
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) delta_T[b * K + j] = cur[j];
}

__global__ void viterbi_backtrack_batch_kernel(
    const int* __restrict__ psi,         // (B, T, K) contiguous
    const float* __restrict__ delta_T,   // (B, K) contiguous
    int B, int T, int K,
    int* __restrict__ paths,             // (B, T + 1) contiguous
    float* __restrict__ scores) {        // (B,)
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* d = delta_T + b * K;
  float best = d[0];
  int q = 0;
  for (int k = 1; k < K; ++k) {
    if (d[k] > best) {
      best = d[k];
      q = k;
    }
  }
  scores[b] = best;
  int* path = paths + b * (int64_t)(T + 1);
  path[T] = q;
  const int* psi_b = psi + b * (int64_t)T * K;
  for (int t = T - 1; t >= 0; --t) {
    q = psi_b[(int64_t)t * K + q];
    path[t] = q;
  }
}

}  // namespace

extern "C" int viterbi_fwd_batch(const void* log_A, const void* em,
                                 int64_t em_sb, int64_t em_st,
                                 const void* delta0, const void* pad,
                                 int B, int T, int K, void* psi, void* delta_T,
                                 void* stream) {
  const size_t smem = 2 * (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(viterbi_fwd_batch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = ((K + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  viterbi_fwd_batch_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)log_A, (const float*)em, em_sb, em_st,
      (const float*)delta0, (const float*)pad, T, K, (int*)psi,
      (float*)delta_T);
  return cudaGetLastError();
}

extern "C" int viterbi_backtrack_batch(const void* psi, const void* delta_T,
                                       int B, int T, int K, void* paths,
                                       void* scores, void* stream) {
  const int threads = 128;
  viterbi_backtrack_batch_kernel<<<(B + threads - 1) / threads, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const int*)psi, (const float*)delta_T, B, T, K, (int*)paths,
      (float*)scores);
  return cudaGetLastError();
}
