// FLASH-BS beam transition for NVIDIA Hopper (sm_90a), N beams per launch.
//
// beam_step_batch replaces the Pallas TPU kernel `_beam_step_kernel` and its
// merge `_select_top_b` behind `beam_step` (src/repro/kernels/beam_stream.py:
// 36, :60, :121).  For each beam n with B slots (scores[n, b], states[n, b])
// and the emissions em[n, :] of the next step it computes the chunked,
// sentinel-seeded transition of `core/flash_bs.py::_beam_transition`:
//     cand[b, c] = (scores[n, b] + log_A[states[n, b], c]) + em[n, c]
//     best[c] = max_b cand[b, c],  from[c] = the lowest b that attains it
// and merges each chunk of C targets into a running top-B that starts as B
// sentinel entries (-4e9, state 0, slot 0).  The merge orders [running ++
// chunk] by value descending, then by position ascending, as the stable
// `lax.top_k` of the JAX code does; the first B entries are the new running
// beam.  After the last chunk the running beam is (new_scores, new_states,
// from_slots).
//
// Design.  The TPU kernel walks the chunks as sequential grid steps with the
// running beam in VMEM scratch, gathers beam rows with a one-hot matmul on
// the MXU (which on this card would round through TF32) and selects the
// top-B in B rounds of argmax.  Here one block owns one beam and walks the
// chunks itself; the B rows of log_A are read by index, so every candidate
// is the same two f32 adds as the JAX code.  Thread j scores target c*C + j
// against the slots in ascending order with a strict '>'.  The merge is a
// rank computation: a running entry i (the running beam is always sorted)
// has rank i + #{chunk values > its value}; a chunk entry j has rank
// #{running values >= its value} + #{chunk entries before it in the order}.
// The ranks are a permutation of 0 .. B+C-1; entries with rank < B are
// written to that slot of the output in global memory, which after a
// __syncthreads() is read back as the next running beam.  Shared memory holds
// the running beam (12 B bytes) and the chunk's values and slots (8 C bytes),
// so any B <= K_pad and C dividing K_pad with (B + C) * 12 bytes <= 227 KB
// fit.
//
// What bounds it.  Per beam and step it reads B rows of log_A (B * K_pad
// floats, from L2: log_A is 1 MiB at K = 512), does B * K_pad adds and
// compares and (B + C)^2 compares per chunk for the ranks.  At the serve
// shapes the rank loops dominate the shared-memory traffic; a merge of two
// sorted runs (the chunk sorted first) is the faster design left for later.
//
// Exactness: no fast-math; the values are compared as f32, equal values
// keep their order, so the result equals the plain version bit for bit.
//
// Plain C interface, loaded with ctypes.  The entry returns
// cudaGetLastError() (0 on success); the launch goes on the caller's stream
// and the calling thread's current device, which the Python wrapper sets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSentinel = -4.0e9f;

__global__ void beam_step_batch_kernel(
    const float* __restrict__ log_A,    // (K, K) contiguous, K = K_pad
    const float* __restrict__ em,       // (N, K), strides (em_sn, 1)
    int64_t em_sn,
    const float* __restrict__ scores,   // (N, B) contiguous
    const int* __restrict__ states,     // (N, B) contiguous
    int K, int B, int C,
    float* __restrict__ out_s,          // (N, B) contiguous
    int* __restrict__ out_st,           // (N, B) contiguous
    int* __restrict__ out_f) {          // (N, B) contiguous
  extern __shared__ float smem[];
  float* run_s = smem;                              // (B,)
  int* run_st = (int*)(run_s + B);                  // (B,)
  int* run_f = run_st + B;                          // (B,)
  float* chk_s = (float*)(run_f + B);               // (C,)
  int* chk_f = (int*)(chk_s + C);                   // (C,)

  const int64_t n = blockIdx.x;
  const float* em_n = em + n * em_sn;
  const float* s_n = scores + n * B;
  const int* st_n = states + n * B;
  float* os = out_s + n * B;
  int* ost = out_st + n * B;
  int* of = out_f + n * B;

  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    run_s[i] = kSentinel;
    run_st[i] = 0;
    run_f[i] = 0;
  }
  const int nchunks = K / C;
  for (int c = 0; c < nchunks; ++c) {
    const int base = c * C;
    // candidates of this chunk: best over the slots, lowest slot on ties
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const int tgt = base + j;
      const float e = em_n[tgt];
      float best = (s_n[0] + log_A[(int64_t)st_n[0] * K + tgt]) + e;
      int arg = 0;
#pragma unroll 4
      for (int b = 1; b < B; ++b) {
        const float v = (s_n[b] + log_A[(int64_t)st_n[b] * K + tgt]) + e;
        if (v > best) {
          best = v;
          arg = b;
        }
      }
      chk_s[j] = best;
      chk_f[j] = arg;
    }
    __syncthreads();   // chunk complete; running beam of the last chunk read
    // ranks in the order (value descending, position in [running ++ chunk]
    // ascending); the entries that rank below B form the next running beam
    for (int e = threadIdx.x; e < B + C; e += blockDim.x) {
      float v;
      int st, fr, rank;
      if (e < B) {
        v = run_s[e];
        st = run_st[e];
        fr = run_f[e];
        rank = e;
        for (int q = 0; q < C; ++q) rank += chk_s[q] > v;
      } else {
        const int j = e - B;
        v = chk_s[j];
        st = base + j;
        fr = chk_f[j];
        rank = 0;
        for (int q = 0; q < B; ++q) rank += run_s[q] >= v;
        for (int q = 0; q < j; ++q) rank += chk_s[q] >= v;
        for (int q = j + 1; q < C; ++q) rank += chk_s[q] > v;
      }
      if (rank < B) {
        os[rank] = v;
        ost[rank] = st;
        of[rank] = fr;
      }
    }
    __syncthreads();   // every rank written to the output; shared memory free
    if (c + 1 < nchunks) {
      for (int i = threadIdx.x; i < B; i += blockDim.x) {
        run_s[i] = os[i];
        run_st[i] = ost[i];
        run_f[i] = of[i];
      }
      __syncthreads();
    }
  }
}

}  // namespace

// em rows may be strided (em_sn floats apart); everything else contiguous.
// Requires C | K and B <= K; the wrapper checks both and the shared memory.
extern "C" int beam_step_batch(const void* log_A, const void* em,
                               int64_t em_sn, const void* scores,
                               const void* states, int N, int K, int B, int C,
                               void* out_s, void* out_st, void* out_f,
                               void* stream) {
  const size_t smem = 12 * (size_t)B + 8 * (size_t)C;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_step_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = ((B + C + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  beam_step_batch_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const float*)log_A, (const float*)em, em_sn, (const float*)scores,
      (const int*)states, K, B, C, (float*)out_s, (int*)out_st, (int*)out_f);
  return cudaGetLastError();
}
