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
// viterbi_fwd_batch_masked replaces the Pallas TPU kernel
// `_viterbi_fwd_masked_kernel` behind `viterbi_forward_batch_masked`
// (src/repro/kernels/viterbi_dp.py:120, :175): the same recursion with two
// optional additive penalties ({0, -1e9} f32, compiled from a constraint),
// tmask (K, K) on log_A and smask (T, K), shared by the batch, on em:
//     delta_t[j] = max_k (delta[k] + (log_A[k, j] + tmask[k, j]))
//                  + (em[b, t, j] + smask[t, j])
// Pad steps ignore smask.  One template, instantiated on <HAS_T, HAS_S,
// RESIDENT>, carries both entries; viterbi_fwd_batch is <false, false, *>.
//
// Design.  The TPU kernel carries delta across sequential "arbitrary" grid
// steps in VMEM scratch, with log_A resident in VMEM.  Here each sequence is
// owned by one thread-block cluster of C = kCluster = 8 CTAs (the portable
// size; a non-portable cluster of 16 was timed once and was slower), and a
// persistent grid of as many clusters as fit on the card walks the
// sequences.  CTA r owns the target columns
// [r W, (r + 1) W), W = ceil(K / C) (for K < C the last CTAs own none and
// only take part in the barriers).  In the resident instance the CTA holds
// its K x W column slice of log_A in shared memory for the whole launch
// (128 KiB at K = 512, C = 8), loaded once per launch; the masked instances
// hold log_A + tmask there instead, added once with __fadd_rn, which is the
// add the TPU kernel makes once per grid step before scoring
// (viterbi_dp.py:151), so the masked kernel streams no more than the plain
// one.  Where the slice does not fit (K above 665 at C = 8), the
// global instance reads it from L2 (the masked one adds tmask per score, in
// the same operand order), now spread over C SMs per sequence.  Every CTA
// keeps a full copy of delta, double-buffered (2 K floats, so K up to 29056
// still runs).  A real step:
//   1. thread (j, part) scores column c0 + j against one contiguous range
//      of sources from its local delta, in kChains independent chains
//      (more loads in flight), and the chains and then the parts combine in
//      ascending k order, a later one winning only if strictly greater;
//   2. the column's best + (em [+ smask]) is pushed into every CTA's next
//      delta through distributed shared memory, psi written;
//   3. one cluster barrier.  Double buffering makes one barrier a step
//      enough: a CTA writes into a buffer only after every CTA has passed
//      the barrier that ends its last read of it.
// A pad step (the flag is per sequence, so the whole cluster sees it)
// writes the identity psi row and keeps delta: no exchange, no barrier.  A
// cluster barrier ends each sequence, so that no CTA re-seeds from delta0,
// or leaves, while another may still push into it.  The next step's
// emission and pad flag are loaded into registers while a step computes.
//
// What bounds it.  Steps are serially dependent, so a launch takes at least
// T times the latency of one step: the scoring of K W (add, compare) pairs
// per CTA from shared memory (32 K per CTA at K = 512, C = 8), the push and
// one cluster barrier.  That is far above the bytes bound (em in, psi out)
// and the f32 operations bound (2 B T K^2).  The global instance is bound by
// the rate at which the C SMs of a cluster draw the slice from L2 each step.
// chip_smoke.py measured, on an NVIDIA H100 80GB HBM3 at 700.00 W: 1.44 ms
// a launch, 2.8 us a step, at (B, T, K) = (8, 511, 512), resident, against
// a 0.032 ms bound (the one-block design it replaces took 21.5 ms); the
// masked entry with both masks 1.45 ms at the same shape (was 27.5 ms); the
// map-matching shape (8, 511, 1024) with smask, global, 6.01 ms, 11.8 us a
// step (was 25.6 ms).  Clusters of 16 took 2.24 ms and 6.98 ms there, in
// a one-off timing (PERF.md).
//
// Exactness.  One f32 add per score, an exact max, then best + em or
// best + (em + smask), in that order, as in the TPU kernel (viterbi_dp.py:
// 151, :160); the lowest index wins ties, as jnp.argmax.  Ties are the
// normal case: in a left-to-right HMM every off-band transition is -1e9 and
// -1e9 + em rounds back to -1e9 in f32, so any other grouping or a combine
// that let a later equal value win would change psi.  Build without
// --use_fast_math.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1.0e9f;

// The forward template's arguments; one struct for every instance.
struct FwdArgs {
  const float* log_A;   // (K, K) [src, dst], contiguous
  const float* tmask;   // (K, K) contiguous; read iff HAS_T
  const float* em;      // (B, T, K), strides (em_sb, em_st, 1)
  int64_t em_sb, em_st;
  const float* smask;   // (T, K), strides (sm_st, 1); read iff HAS_S
  int64_t sm_st;
  const float* delta0;  // (B, K) contiguous
  const float* pad;     // (B, T) contiguous, or nullptr
  int B, T, K;
  int* psi;             // (B, T, K) contiguous
  float* delta_T;       // (B, K) contiguous
};

constexpr int kFwdThreads = 512;
// independent partial maxima a thread keeps over its k range
constexpr int kChains = 4;

// Offsets into the dynamic shared memory, in 4-byte words, each 16-byte
// aligned: the CTA's K x W column slice (resident instance), delta
// double-buffered, and the per-part maxima (only when a column is scored
// by more than one part).
struct FwdSmem {
  int64_t a, delta, pv, pf, total;
};

__host__ __device__ inline FwdSmem fwd_smem_layout(int K, bool resident) {
  const int W = cols_per_cta(K);
  const int parts = kFwdThreads / lane_width(W, kFwdThreads);
  const int64_t partial = parts > 1 ? (int64_t)parts * W : 0;
  FwdSmem s;
  int64_t o = 0;
  s.a = o;     o = align4(o + (resident ? (int64_t)K * W : 0));
  s.delta = o; o = align4(o + 2 * (int64_t)K);
  s.pv = o;    o = align4(o + partial);
  s.pf = o;    o = align4(o + partial);
  s.total = o;
  return s;
}

// The lowest k in [k0, k1) (k0 < k1) that maximises score(k), and its
// value, bit for bit as one upward scan with a strict '>': the range is cut
// into kChains contiguous chains, scanned in lockstep (their loads are
// independent), the last chain taking the remainder; the chains then
// combine in ascending order, a later one winning only if strictly greater.
template <typename Score>
__device__ inline void first_max(const Score& score, int k0, int k1,
                                 float& best, int& arg) {
  const int m = (k1 - k0) / kChains;
  if (m == 0) {
    best = score(k0);
    arg = k0;
    for (int k = k0 + 1; k < k1; ++k) {
      const float v = score(k);
      if (v > best) {
        best = v;
        arg = k;
      }
    }
    return;
  }
  float bv[kChains];
  int ba[kChains];
#pragma unroll
  for (int u = 0; u < kChains; ++u) {
    ba[u] = k0 + u * m;
    bv[u] = score(ba[u]);
  }
  for (int i = 1; i < m; ++i) {
    float v[kChains];
#pragma unroll
    for (int u = 0; u < kChains; ++u) v[u] = score(k0 + u * m + i);
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      if (v[u] > bv[u]) {
        bv[u] = v[u];
        ba[u] = k0 + u * m + i;
      }
    }
  }
  for (int k = k0 + kChains * m; k < k1; ++k) {   // the last chain's rest
    const float v = score(k);
    if (v > bv[kChains - 1]) {
      bv[kChains - 1] = v;
      ba[kChains - 1] = k;
    }
  }
  best = bv[0];
  arg = ba[0];
#pragma unroll
  for (int u = 1; u < kChains; ++u) {
    if (bv[u] > best) {
      best = bv[u];
      arg = ba[u];
    }
  }
}

template <bool HAS_T, bool HAS_S, bool RESIDENT>
__global__ void __launch_bounds__(kFwdThreads, 1)
viterbi_fwd_cluster_kernel(const FwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int r = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int K = p.K, T = p.T;
  const FwdSmem L = fwd_smem_layout(K, RESIDENT);
  const int W = cols_per_cta(K);
  const int Wp = lane_width(W, kFwdThreads), parts = kFwdThreads / Wp;
  const int c0 = min(r * W, K), nw = min(c0 + W, K) - c0;
  // thread (jl, part) scores the columns jl, jl + Wp, ... over the sources
  // [k0, k1); `live` parts have a non-empty range
  const int jl = tid % Wp, part = tid / Wp;
  const int Kp = (K + parts - 1) / parts, live = (K + Kp - 1) / Kp;
  const int k0 = min(part * Kp, K), k1 = min(k0 + Kp, K);
  // the column whose emission this thread prefetches: the first it finishes
  const int fj = parts == 1 ? (part == 0 ? jl : nw) : tid;

  float* A_s = smem + L.a;
  float* pv = smem + L.pv;
  int* pf = (int*)(smem + L.pf);

  if (RESIDENT) {   // this CTA's slice of log_A (+ tmask), once per launch
    for (int k = part; k < K && part < parts; k += parts) {
      for (int j = jl; j < nw; j += Wp) {
        const int64_t i = (int64_t)k * K + c0 + j;
        A_s[(int64_t)k * W + j] =
            HAS_T ? __fadd_rn(__ldg(p.log_A + i), __ldg(p.tmask + i))
                  : __ldg(p.log_A + i);
      }
    }
  }
  auto A = [&](int k, int j) -> float {
    if (RESIDENT) return A_s[(int64_t)k * W + j];
    const int64_t i = (int64_t)k * K + c0 + j;
    return HAS_T ? __fadd_rn(__ldg(p.log_A + i), __ldg(p.tmask + i))
                 : __ldg(p.log_A + i);
  };

  const int ncl = gridDim.x / C;
  for (int b = blockIdx.x / C; b < p.B; b += ncl) {
    float* cur = smem + L.delta;
    float* nxt = cur + K;
    for (int k = tid; k < K; k += kFwdThreads)
      cur[k] = p.delta0[(int64_t)b * K + k];
    const float* em_b = p.em + (int64_t)b * p.em_sb;
    const float* pad_b = p.pad == nullptr ? nullptr : p.pad + (int64_t)b * T;
    int* psi_b = p.psi + (int64_t)b * T * K + c0;
    // step t's emission (+ smask) of column c0 + j
    auto emission = [&](int t, int j) -> float {
      const float e = em_b[(int64_t)t * p.em_st + c0 + j];
      return HAS_S ? __fadd_rn(e, p.smask[(int64_t)t * p.sm_st + c0 + j]) : e;
    };
    float e_next = 0.f;
    bool pad_next = false;
    if (T > 0) {
      if (fj < nw) e_next = emission(0, fj);
      pad_next = pad_b != nullptr && pad_b[0] > 0.5f;
    }
    __syncthreads();   // the seed and the slice are in place

    for (int t = 0; t < T; ++t) {
      const float e_cur = e_next;
      const bool is_pad = pad_next;
      if (t + 1 < T) {   // prefetch the next step while this one computes
        if (fj < nw) e_next = emission(t + 1, fj);
        pad_next = pad_b != nullptr && pad_b[t + 1] > 0.5f;
      }
      int* psi_t = psi_b + (int64_t)t * K;
      if (is_pad) {   // the whole cluster sees it: identity, no exchange
        for (int j = tid; j < nw; j += kFwdThreads) psi_t[j] = c0 + j;
        continue;
      }
      // best + (em [+ smask]) into every CTA's next delta
      auto finish = [&](int j, float best, int arg) {
        const float v = __fadd_rn(best, j == fj ? e_cur : emission(t, j));
        psi_t[j] = arg;
#pragma unroll
        for (int q = 0; q < C; ++q)
          cluster.map_shared_rank(nxt, q)[c0 + j] = v;
      };
      if (part < live) {
        for (int j = jl; j < nw; j += Wp) {
          float best;
          int arg;
          first_max([&](int k) { return __fadd_rn(cur[k], A(k, j)); }, k0,
                    k1, best, arg);
          if (parts == 1) {
            finish(j, best, arg);
          } else {
            pv[part * W + j] = best;
            pf[part * W + j] = arg;
          }
        }
      }
      if (parts > 1) {
        __syncthreads();
        for (int j = tid; j < nw; j += kFwdThreads) {   // parts in k order
          float best = pv[j];
          int arg = pf[j];
          for (int q = 1; q < live; ++q) {
            if (pv[q * W + j] > best) {
              best = pv[q * W + j];
              arg = pf[q * W + j];
            }
          }
          finish(j, best, arg);
        }
      }
      // every push of this step has landed, and every read of cur is done
      // before any CTA writes into it as the next step's nxt
      cluster.sync();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int j = tid; j < nw; j += kFwdThreads)
      p.delta_T[(int64_t)b * K + c0 + j] = cur[c0 + j];
    // no CTA re-seeds for its next sequence, or leaves, while another may
    // still read its delta or push into it
    cluster.sync();
  }
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

template <bool HAS_T, bool HAS_S, bool RESIDENT>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)fwd_smem_layout(a.K, RESIDENT).total;
  return launch_persistent_clusters(
      viterbi_fwd_cluster_kernel<HAS_T, HAS_S, RESIDENT>, a, a.B,
      kFwdThreads, smem, stream);
}

template <bool HAS_T, bool HAS_S>
int launch_fwd_instance(const FwdArgs& a, int resident, void* stream) {
  if (a.B == 0) return cudaSuccess;
  return resident ? launch_fwd<HAS_T, HAS_S, true>(a, (cudaStream_t)stream)
                  : launch_fwd<HAS_T, HAS_S, false>(a, (cudaStream_t)stream);
}

}  // namespace

// Shared memory bytes of a CTA of a forward launch, resident (the column
// slices of log_A held in shared memory) or not.  The masked entry holds
// log_A + tmask in the same space.
extern "C" int viterbi_fwd_smem_bytes(int K, int resident) {
  const int64_t bytes = 4 * fwd_smem_layout(K, resident != 0).total;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// em (B, T, K) with strides (em_sb, em_st, 1); everything else contiguous.
extern "C" int viterbi_fwd_batch(const void* log_A, const void* em,
                                 int64_t em_sb, int64_t em_st,
                                 const void* delta0, const void* pad, int B,
                                 int T, int K, int resident, void* psi,
                                 void* delta_T, void* stream) {
  const FwdArgs a = {(const float*)log_A, nullptr, (const float*)em, em_sb,
                     em_st, nullptr, 0, (const float*)delta0,
                     (const float*)pad, B, T, K, (int*)psi, (float*)delta_T};
  return launch_fwd_instance<false, false>(a, resident, stream);
}

// tmask and smask may each be null (no penalty on that operand); smask
// (T, K) has strides (sm_st, 1).
extern "C" int viterbi_fwd_batch_masked(
    const void* log_A, const void* tmask, const void* em, int64_t em_sb,
    int64_t em_st, const void* smask, int64_t sm_st, const void* delta0,
    const void* pad, int B, int T, int K, int resident, void* psi,
    void* delta_T, void* stream) {
  const FwdArgs a = {(const float*)log_A, (const float*)tmask,
                     (const float*)em, em_sb, em_st, (const float*)smask,
                     sm_st, (const float*)delta0, (const float*)pad, B, T, K,
                     (int*)psi, (float*)delta_T};
  if (tmask != nullptr && smask != nullptr)
    return launch_fwd_instance<true, true>(a, resident, stream);
  if (tmask != nullptr)
    return launch_fwd_instance<true, false>(a, resident, stream);
  if (smask != nullptr)
    return launch_fwd_instance<false, true>(a, resident, stream);
  return launch_fwd_instance<false, false>(a, resident, stream);
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
