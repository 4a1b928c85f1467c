// Fused Viterbi forward pass (plain and constraint-masked), the banded
// forward pass and the batched backtrack for NVIDIA Hopper (sm_90a).
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
// viterbi_fwd_batch_masked replaces the Pallas TPU kernel
// `_viterbi_fwd_masked_kernel` behind `viterbi_forward_batch_masked`
// (src/repro/kernels/viterbi_dp.py:120, :175).  It is the same kernel with
// two optional additive penalties ({0, -1e9} f32, compiled from a
// constraint): tmask (K, K) on log_A and smask (T, K), shared by the batch,
// on em:
//     delta_t[j] = max_k (delta[k] + (log_A[k, j] + tmask[k, j]))
//                  + (em[b, t, j] + smask[t, j])
// One template, instantiated on <HAS_T, HAS_S>, carries both; the unmasked
// viterbi_fwd_batch is its <false, false> instance.  Pad steps ignore smask.
// What bounds it: the TPU kernel adds tmask once per grid step into VMEM;
// here no K*K masked copy fits in shared memory either, so every score reads
// log_A and tmask both from L2, doubling the per-step L2 stream that already
// bounds the unmasked kernel.  smask adds one (K,) row a step, nothing.
// Keeping log_A + tmask resident across a cluster is the redesign shared
// with viterbi_fwd_batch.  Exactness: each score is
// cur[k] + (log_A[k, j] + tmask[k, j]), never (cur[k] + log_A) + tmask, and
// the max comes first, then best + (em + smask): the TPU kernel's operand
// order (viterbi_dp.py:151, :160).  -1e9 + -1e9, -1e9 + em and -2e9 + delta
// all round in f32, so any other grouping changes bits and tie order.
//
// viterbi_banded_fwd replaces the lax.scan of `viterbi_decode_banded`
// (src/repro/kernels/ops.py:387-411), which is not Pallas.  One block walks
// the whole time loop over a Kb = min(2*width + 1, K) wide window of states
// that starts at starts[t]: thread j scores
//     delta_w[k] + log_A[starts[t-1] + k, starts[t] + j]
// and adds em[t, starts[t] + j] + pen, pen = 0 if
// |starts[t] + j - centers[t]| <= width, else -1e9.  delta_w is
// double-buffered in shared memory.  It is bound by the latency of T
// dependent steps (2*T*Kb^2 operations, a few microseconds of the card's
// f32 rate), so one block is enough; the Kb*Kb block of log_A each step
// reads comes from L2.  Bit-identity with the dense masked decode needs a
// dense log_A (see `viterbi_decode_banded`'s docstring in the JAX package).
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

constexpr float kNegInf = -1.0e9f;

template <bool HAS_T, bool HAS_S>
__global__ void viterbi_fwd_batch_kernel(
    const float* __restrict__ log_A,   // (K, K) [src, dst], contiguous
    const float* __restrict__ tmask,   // (K, K) contiguous; read iff HAS_T
    const float* __restrict__ em,      // (B, T, K), strides (em_sb, em_st, 1)
    int64_t em_sb, int64_t em_st,
    const float* __restrict__ smask,   // (T, K), strides (sm_st, 1); iff HAS_S
    int64_t sm_st,
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
      const float* m = HAS_T ? tmask + j : nullptr;
      float best = HAS_T ? cur[0] + (a[0] + m[0]) : cur[0] + a[0];
      int arg = 0;
#pragma unroll 8
      for (int k = 1; k < K; ++k) {
        const int64_t kk = (int64_t)k * K;
        const float v = HAS_T ? cur[k] + (a[kk] + m[kk]) : cur[k] + a[kk];
        if (v > best) {
          best = v;
          arg = k;
        }
      }
      nxt[j] = HAS_S ? best + (em_t[j] + smask[(int64_t)t * sm_st + j])
                     : best + em_t[j];
      psi_t[j] = arg;
    }
    __syncthreads();                     // nxt complete, cur no longer read
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) delta_T[b * K + j] = cur[j];
}

__global__ void viterbi_banded_fwd_kernel(
    const float* __restrict__ log_A,    // (K, K) contiguous
    const float* __restrict__ log_pi,   // (K,)
    const float* __restrict__ em,       // (T, K), strides (em_st, 1)
    int64_t em_st,
    const int* __restrict__ centers,    // (T,) clipped into [0, K-1]
    const int* __restrict__ starts,     // (T,) in [0, K-Kb]
    int width, int T, int K, int Kb,
    int* __restrict__ psi,              // (T-1, Kb) contiguous, local ids
    float* __restrict__ delta_w) {      // (Kb,)
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + Kb;
  {
    const int s0 = starts[0], c0 = centers[0];
    for (int j = threadIdx.x; j < Kb; j += blockDim.x) {
      const int idx = s0 + j;
      const float pen = abs(idx - c0) <= width ? 0.0f : kNegInf;
      cur[j] = log_pi[idx] + (em[idx] + pen);
    }
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const int prev = starts[t - 1], start = starts[t], c = centers[t];
    const float* em_t = em + (int64_t)t * em_st;
    int* psi_t = psi + (int64_t)(t - 1) * Kb;
    for (int j = threadIdx.x; j < Kb; j += blockDim.x) {
      const int idx = start + j;
      const float* a = log_A + (int64_t)prev * K + idx;
      float best = cur[0] + a[0];
      int arg = 0;
#pragma unroll 8
      for (int k = 1; k < Kb; ++k) {
        const float v = cur[k] + a[(int64_t)k * K];
        if (v > best) {
          best = v;
          arg = k;
        }
      }
      const float pen = abs(idx - c) <= width ? 0.0f : kNegInf;
      nxt[j] = best + (em_t[idx] + pen);
      psi_t[j] = arg;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int j = threadIdx.x; j < Kb; j += blockDim.x) delta_w[j] = cur[j];
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

// Threads for a row of n columns: one per column, whole warps, at most 1024.
int row_threads(int n) {
  const int threads = ((n + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

// Opts a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool HAS_T, bool HAS_S>
int launch_fwd(const void* log_A, const void* tmask, const void* em,
               int64_t em_sb, int64_t em_st, const void* smask,
               int64_t sm_st, const void* delta0, const void* pad, int B,
               int T, int K, void* psi, void* delta_T, void* stream) {
  auto kernel = viterbi_fwd_batch_kernel<HAS_T, HAS_S>;
  const size_t smem = 2 * (size_t)K * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, row_threads(K), smem, (cudaStream_t)stream>>>(
      (const float*)log_A, (const float*)tmask, (const float*)em, em_sb,
      em_st, (const float*)smask, sm_st, (const float*)delta0,
      (const float*)pad, T, K, (int*)psi, (float*)delta_T);
  return cudaGetLastError();
}

}  // namespace

extern "C" int viterbi_fwd_batch(const void* log_A, const void* em,
                                 int64_t em_sb, int64_t em_st,
                                 const void* delta0, const void* pad,
                                 int B, int T, int K, void* psi, void* delta_T,
                                 void* stream) {
  return launch_fwd<false, false>(log_A, nullptr, em, em_sb, em_st, nullptr,
                                  0, delta0, pad, B, T, K, psi, delta_T,
                                  stream);
}

// tmask and smask may each be null (no penalty on that operand).
extern "C" int viterbi_fwd_batch_masked(
    const void* log_A, const void* tmask, const void* em, int64_t em_sb,
    int64_t em_st, const void* smask, int64_t sm_st, const void* delta0,
    const void* pad, int B, int T, int K, void* psi, void* delta_T,
    void* stream) {
  if (tmask != nullptr && smask != nullptr)
    return launch_fwd<true, true>(log_A, tmask, em, em_sb, em_st, smask,
                                  sm_st, delta0, pad, B, T, K, psi, delta_T,
                                  stream);
  if (tmask != nullptr)
    return launch_fwd<true, false>(log_A, tmask, em, em_sb, em_st, smask,
                                   sm_st, delta0, pad, B, T, K, psi, delta_T,
                                   stream);
  if (smask != nullptr)
    return launch_fwd<false, true>(log_A, tmask, em, em_sb, em_st, smask,
                                   sm_st, delta0, pad, B, T, K, psi, delta_T,
                                   stream);
  return launch_fwd<false, false>(log_A, tmask, em, em_sb, em_st, smask,
                                  sm_st, delta0, pad, B, T, K, psi, delta_T,
                                  stream);
}

extern "C" int viterbi_banded_fwd(const void* log_A, const void* log_pi,
                                  const void* em, int64_t em_st,
                                  const void* centers, const void* starts,
                                  int width, int T, int K, int Kb, void* psi,
                                  void* delta_w, void* stream) {
  const size_t smem = 2 * (size_t)Kb * sizeof(float);
  cudaError_t err = allow_smem(viterbi_banded_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  viterbi_banded_fwd_kernel<<<1, row_threads(Kb), smem,
                              (cudaStream_t)stream>>>(
      (const float*)log_A, (const float*)log_pi, (const float*)em, em_st,
      (const int*)centers, (const int*)starts, width, T, K, Kb, (int*)psi,
      (float*)delta_w);
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
