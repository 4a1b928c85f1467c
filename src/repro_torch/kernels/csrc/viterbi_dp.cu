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
// cluster barrier after the seed makes sure every CTA of the cluster has
// started before any pushes into it; one ends each sequence, so that no CTA
// re-seeds from delta0, or leaves, while another may still push into it.
// The next step's emission and pad flag are loaded into registers while a
// step computes.
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
// (src/repro/kernels/ops.py:387-411), which is not Pallas.  Over a window of
// Kb = min(2*width + 1, K) states that starts at starts[t] it computes, for
// 1 <= t < T,
//     delta_w'[j] = max_k (delta_w[k] + log_A[starts[t-1] + k, starts[t] + j])
//                   + (em[t, starts[t] + j] + pen)
// with pen = 0 if |starts[t] + j - centers[t]| <= width, else -1e9, and psi
// the lowest-index argmax as local window ids.
//
// Design.  The step is the forward template's step over a window: one
// cluster of kCluster CTAs owns the sequence, CTA r scores the window
// columns [r W, (r + 1) W), W = ceil(Kb / C) (25 at Kb = 193), with the
// same split of k over parts and chains and the same ascending strict-'>'
// combine (score_columns), reading each step's Kb x W block of log_A from
// L2.  The exchange is data-driven: each value of delta_w goes to every CTA
// by a remote store (st.async) that counts its 4 bytes on that CTA's
// mbarrier of the buffer, and a CTA starts the next step as soon as all Kb
// values of this one have come, with a CTA barrier a step and no cluster
// barrier: a cluster barrier a step, with the release of every store
// before it, cost more (below).  That order holds only if every CTA owns
// columns (the stores of one step into a CTA are ordered after those of
// the step before by that CTA's own values, which the others wait for), so
// the windows that leave a CTA without any (28 widths, all Kb <= 49: Kb <
// 8, 9 .. 14, 17 .. 21, ...) end each step with a cluster barrier instead,
// as the forward template does; so do the two widest (Kb = 29055 and
// 29056, whose delta buffers fill the shared memory, leaving no room for
// the mbarriers).  The next step's emission and the windows' starts and
// centres are loaded into registers a step or two ahead.
//
// What bounds it.  T - 1 serially dependent steps: a launch takes at least
// T times one step's latency (Kb W (add, compare) pairs per CTA, the
// exchange and the block of log_A each step brings into each SM), far
// above the bytes bound (the touched log_A entries, em and psi once) and
// the f32 operations bound (2 (T-1) Kb^2).  chip_smoke.py measured, on an
// NVIDIA H100 80GB HBM3 at 700.00 W, at (T, K, Kb) = (512, 1024, 193):
// 0.914 ms a launch, 1.79 us a step, against a 0.000568 ms bound; the
// one-block design it replaces took 2.18 ms, 4.26 us a step.  A first
// cluster design with a cluster barrier a step took 1.13 ms.  Bringing the
// next step's block into shared memory ahead of use (a Tensor Memory
// Accelerator copy a step into a two-stage ring) tied with reading it from
// L2 at Kb = 193 (within 1.5 %) and led by 6 % only at Kb = 255, a width
// no path uses, so the kernel has no such stage.  A guard that skipped the
// stores to CTAs without columns, in place of their cluster-barrier
// instance, cost 6 % at Kb = 193 (PERF.md).
// Bit-identity with the dense masked decode needs a dense log_A (see
// `viterbi_decode_banded`'s docstring in the JAX package).
//
// viterbi_backtrack_batch replaces the XLA reverse scans of
// `viterbi_decode_fused_batch` (src/repro/kernels/ops.py:177-182, 213-220).
// For each sequence b: paths[b, T] = q, the lowest-index argmax of
// delta_T[b]; paths[b, t] = psi[b, t, paths[b, t + 1]]; scores[b] =
// delta_T[b, q] (a load, not a computed value).
//
// Design.  The walk is a chain of T dependent loads, but the backpointer
// rows compose: the rows [s, e) map each state k after row e - 1 to the
// state f(k) at row s, for all K end states at once, in parallel.  One
// thread-block cluster of kCluster CTAs owns a sequence, on the persistent
// cluster grid of the forward template.  CTA r owns the rows [r R, (r + 1)
// R), R = ceil(T / C), and cuts them into S sub-blocks (S a power of two,
// at most kBtMaxSub and R), each owned by kBtThreads / S threads:
//   1. the CTA stages its rows in shared memory with cp.async, where they
//      fit beside the maps (the "staged" instance; else, "global", it reads
//      them from L2 as it goes), and meanwhile takes the argmax of delta_T
//      by a block reduction: each thread scans its strided share upward with
//      a strict '>', and the partial results combine by warp shuffles and
//      then across warps, a larger value winning and, between equal ones,
//      the lower index: the lowest-index argmax for every input without NaN;
//   2. compose: the threads of sub-block j build its map f_j over all K end
//      states, a thread following kBtIlp states back through the rows at
//      once (one gather from one row a step);
//   3. the CTA's whole map F_r = f_0 o f_1 o ... o f_{S-1}, each thread
//      composing it for its own states;
//   4. a cluster barrier, then stitch: the first thread of each sub-block
//      starts from the argmax and follows the whole maps of the CTAs after
//      its own through distributed shared memory (at most C - 1 remote
//      reads), then the maps of the later sub-blocks of its CTA, which gives
//      the state after its last row;
//   5. fill: it walks its rows from that state and writes the path;
//   6. a cluster barrier: no CTA overwrites its maps for the next sequence,
//      or exits, while another may still read them.
// Where the maps of S sub-blocks do not fit beside the staged rows, S is
// halved; where the rows do not fit even beside one map (large R K), they
// are read from L2, with the most sub-blocks whose maps fit.  The instance
// is chosen by shape (viterbi_backtrack_plan), never by a failure.
//
// What bounds it.  Not bytes: the dependent chain of the walk.  A single
// walker follows T dependent L2 loads, about one L2 round trip a step.
// With Ls = ceil(T / (C S)) rows a sub-block and G = kBtThreads / S
// threads, this design follows ceil(K / (kBtIlp G)) Ls + Ls row gathers
// (compose, whose passes over a thread's states run one after another, and
// fill), about 2 S map reads (the whole map and the maps of the later
// sub-blocks), C - 1 remote reads and two cluster barriers: at (B, T, K) =
// (8, 511, 512), S = 16 and G = 32, 16 + 4 shared-memory row gathers, 16 +
// 15 map reads and 7 remote reads in place of 511 L2 loads.  To get there
// it reads the whole of psi once (B T K 4 bytes: 8.4 MB at (8, 511, 512),
// still in L2 from the forward launch just before) instead of the T
// entries on the path, plus delta_T once per CTA.  tools/backtrack_timing.py
// measured, on an NVIDIA H100 80GB HBM3 at 700.00 W, by CUDA-graph replay:
// 0.0079 ms at (8, 511, 512), where the one-thread-per-sequence kernel it
// replaces took 0.0965 ms in the same call; 0.0087 ms at (1, 4095, 64)
// (was 0.6057) and 0.027 ms at (40, 511, 512), psi 42 MB (was 0.118)
// (PERF.md).  Staging pays: the same kernel with its rows read from L2
// took, in one call, 0.0095 ms at (8, 511, 512) against 0.0078, and 0.0158
// against 0.0087 at (1, 4095, 64), whose chain is 32 + 32 gathers.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() (0 on success); launches go on the caller's stream and
// the calling thread's current device, which the Python wrapper sets.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
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
// a block's shared memory on the card (227 KB)
constexpr size_t kSmemBytes = 232448;
// independent partial maxima a thread keeps over its k range
constexpr int kChains = 4;

// Offsets into the dynamic shared memory of a cluster kernel over a K-wide
// row, in 4-byte words, each 16-byte aligned: `slice` words of log_A (the
// forward template's resident K x W column slice), delta double-buffered,
// the per-part maxima (only when a column is scored by more than one part),
// and `mbars` mbarriers.
struct FwdSmem {
  int64_t a, delta, pv, pf, mbar, total;
};

__host__ __device__ inline FwdSmem cluster_smem_layout(int K, int64_t slice,
                                                       int mbars) {
  const int W = cols_per_cta(K);
  const int parts = kFwdThreads / lane_width(W, kFwdThreads);
  const int64_t partial = parts > 1 ? (int64_t)parts * W : 0;
  FwdSmem s;
  int64_t o = 0;
  s.a = o;     o = align4(o + slice);
  s.delta = o; o = align4(o + 2 * (int64_t)K);
  s.pv = o;    o = align4(o + partial);
  s.pf = o;    o = align4(o + partial);
  s.mbar = o;  o = align4(o + 2 * (int64_t)mbars);
  s.total = o;
  return s;
}

__host__ __device__ inline FwdSmem fwd_smem_layout(int K, bool resident) {
  return cluster_smem_layout(K, resident ? (int64_t)K * cols_per_cta(K) : 0,
                             0);
}

// The banded kernel over a Kb-wide window: with `mbars`, one mbarrier per
// delta buffer.
__host__ __device__ inline FwdSmem band_smem_layout(int Kb, bool mbars) {
  return cluster_smem_layout(Kb, 0, mbars ? 2 : 0);
}

// The split of one DP step's scoring over a CTA of kFwdThreads threads:
// CTA r owns the target columns [c0, c0 + nw) of a K-wide row, and thread
// (jl, part) scores the columns jl, jl + Wp, ... over the sources [k0, k1);
// `live` parts have a non-empty range.
struct ColSplit {
  int W, Wp, parts, live, c0, nw, jl, part, k0, k1;
};

__device__ inline ColSplit col_split(int K, int r, int tid) {
  ColSplit s;
  s.W = cols_per_cta(K);
  s.Wp = lane_width(s.W, kFwdThreads);
  s.parts = kFwdThreads / s.Wp;
  s.c0 = min(r * s.W, K);
  s.nw = min(s.c0 + s.W, K) - s.c0;
  s.jl = tid % s.Wp;
  s.part = tid / s.Wp;
  const int Kp = (K + s.parts - 1) / s.parts;
  s.live = (K + Kp - 1) / Kp;
  s.k0 = min(s.part * Kp, K);
  s.k1 = min(s.k0 + Kp, K);
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

// One DP step's scoring in a CTA, shared by the forward template and the
// banded kernel: for each of the CTA's columns j, the lowest source k that
// maximises score(k, j), found by first_max over each part's range and
// combined over the parts in ascending k order, a later part winning only
// if strictly greater; then finish(j, best, arg) once per column.  pv and
// pf hold the parts' maxima (parts > 1).  Every thread of the CTA calls it.
template <typename Score, typename Finish>
__device__ inline void score_columns(const ColSplit& s, const Score& score,
                                     const Finish& finish, float* pv,
                                     int* pf) {
  if (s.part < s.live) {
    for (int j = s.jl; j < s.nw; j += s.Wp) {
      float best;
      int arg;
      first_max([&](int k) { return score(k, j); }, s.k0, s.k1, best, arg);
      if (s.parts == 1) {
        finish(j, best, arg);
      } else {
        pv[s.part * s.W + j] = best;
        pf[s.part * s.W + j] = arg;
      }
    }
  }
  if (s.parts > 1) {
    __syncthreads();
    for (int j = threadIdx.x; j < s.nw; j += kFwdThreads) {   // k order
      float best = pv[j];
      int arg = pf[j];
      for (int q = 1; q < s.live; ++q) {
        if (pv[q * s.W + j] > best) {
          best = pv[q * s.W + j];
          arg = pf[q * s.W + j];
        }
      }
      finish(j, best, arg);
    }
  }
}

// Writes v into element i of `buf` in every CTA of the cluster (distributed
// shared memory; visible to the other CTAs after the next cluster barrier).
__device__ inline void push_all(cg::cluster_group& cluster, float* buf, int i,
                                float v) {
#pragma unroll
  for (int q = 0; q < kCluster; ++q) cluster.map_shared_rank(buf, q)[i] = v;
}

template <bool HAS_T, bool HAS_S, bool RESIDENT>
__global__ void __launch_bounds__(kFwdThreads, 1)
viterbi_fwd_cluster_kernel(const FwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int K = p.K, T = p.T;
  const FwdSmem L = fwd_smem_layout(K, RESIDENT);
  const ColSplit s = col_split(K, (int)cluster.block_rank(), tid);
  const int W = s.W, Wp = s.Wp, parts = s.parts, c0 = s.c0, nw = s.nw;
  const int jl = s.jl, part = s.part;
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

  const int ncl = gridDim.x / kCluster;
  for (int b = blockIdx.x / kCluster; b < p.B; b += ncl) {
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
    // the seed and the slice are in place, and every CTA of the cluster has
    // started before any pushes into its shared memory
    cluster.sync();

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
      score_columns(
          s, [&](int k, int j) { return __fadd_rn(cur[k], A(k, j)); },
          [&](int j, float best, int arg) {   // best + (em [+ smask])
            psi_t[j] = arg;
            push_all(cluster, nxt, c0 + j,
                     __fadd_rn(best, j == fj ? e_cur : emission(t, j)));
          },
          pv, pf);
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

// The banded kernel's arguments.
struct BandArgs {
  const float* log_A;    // (K, K) contiguous
  const float* log_pi;   // (K,)
  const float* em;       // (T, K), strides (em_st, 1)
  int64_t em_st;
  const int* centers;    // (T,) clipped into [0, K-1]
  const int* starts;     // (T,) in [0, K - Kb]
  int width, T, K, Kb;
  int* psi;              // (T-1, Kb) contiguous, local window ids
  float* delta_w;        // (Kb,)
};

// The banded forward pass of one sequence on one cluster.  Step t (1 <= t <
// T) is the forward template's step over a Kb-wide window: rows from
// starts[t-1], columns from starts[t], and the emission em[t, starts[t] +
// j] + pen; each step reads its block of log_A from L2.  delta_w is
// double-buffered, step t writing buf[t & 1].  MBAR (launched only when
// every CTA owns columns): each value goes to every CTA by a remote store
// that counts its bytes on that CTA's mbarrier of the buffer, and a CTA
// starts step t + 1 once all Kb values of step t have come (no cluster
// barrier a step).  Stores of step t + 1 into a CTA's buffer cannot
// overtake those of step t - 1: a CTA stores step t + 1 only after every
// CTA's values of step t have come to it, including the receiver's, which
// the receiver computes only after all of step t - 1 has come to it.  A
// CTA without columns would break that chain.  Else each step ends with a
// cluster barrier, as in the forward template.
template <bool MBAR>
__global__ void __launch_bounds__(kFwdThreads, 1)
viterbi_banded_cluster_kernel(const BandArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int K = p.K, Kb = p.Kb, T = p.T, width = p.width;
  const FwdSmem L = band_smem_layout(Kb, MBAR);
  const ColSplit s = col_split(Kb, (int)cluster.block_rank(), tid);
  const int c0 = s.c0, nw = s.nw;
  // the column whose emission this thread prefetches: the first it finishes
  const int fj = s.parts == 1 ? (s.part == 0 ? s.jl : nw) : tid;
  float* buf = smem + L.delta;                    // delta_w of step t: t & 1
  uint64_t* mbar = (uint64_t*)(smem + L.mbar);    // one per buffer
  float* pv = smem + L.pv;
  int* pf = (int*)(smem + L.pf);
  const uint32_t fill = 4u * (uint32_t)Kb;        // bytes of one step's delta_w
  // the penalty of state idx at a step centred on c
  auto pen = [&](int idx, int c) {
    return abs(idx - c) <= width ? 0.0f : kNegInf;
  };
  // the emission of column j at a step whose window starts at `start`
  auto emission = [&](int t, int start, int j) {
    return p.em[(int64_t)t * p.em_st + start + c0 + j];
  };

  // the windows in registers, loaded ahead: starts of steps t-1 .. t+2,
  // centres of steps t and t+1
  auto start_of = [&](int t) { return t < T ? p.starts[t] : 0; };
  auto centre_of = [&](int t) { return t < T ? p.centers[t] : 0; };
  int prev = p.starts[0], start = start_of(1), start_n = start_of(2);
  int start_nn = start_of(3), c = centre_of(1), c_n = centre_of(2);
  float e_next = 0.f;
  if (T > 1 && fj < nw) e_next = emission(1, start, fj);
  if (MBAR && tid == 0) {   // armed for the fills of steps 1 and 2
    for (int i = 0; i < 2; ++i) mbar_init(&mbar[i]);
    mbar_init_fence();
    if (T > 1) mbar_expect(&mbar[1], fill);
    if (T > 2) mbar_expect(&mbar[0], fill);
  }
  for (int j = tid; j < Kb; j += kFwdThreads) {   // every CTA seeds it all
    const int idx = prev + j;
    buf[j] = __fadd_rn(p.log_pi[idx],
                       __fadd_rn(p.em[idx], pen(idx, p.centers[0])));
  }
  // the seed and the mbarriers are in place, and every CTA of the cluster
  // has started before any stores into its shared memory
  cluster.sync();

  for (int t = 1; t < T; ++t) {
    const float e_cur = e_next;
    const int start_3 = start_of(t + 3), c_nn = centre_of(t + 2);
    if (t + 1 < T && fj < nw) e_next = emission(t + 1, start_n, fj);
    const float* cur = buf + ((t - 1) & 1) * Kb;
    float* nxt = buf + (t & 1) * Kb;
    if (MBAR && t >= 2) {
      // every CTA's values of step t-1 are in cur.  Then every CTA has read
      // its last of nxt (in step t-1, before it stored those values), so
      // stores into nxt may start; and this buffer's next fill is step t+1
      uint64_t* mb = &mbar[(t - 1) & 1];
      mbar_wait(mb, ((t - 2) >> 1) & 1);
      if (tid == 0 && t + 1 < T) mbar_expect(mb, fill);
    }
    const float* a_g = p.log_A + (int64_t)prev * K + start + c0;
    int* psi_t = p.psi + (int64_t)(t - 1) * Kb + c0;
    uint64_t* mb_nxt = &mbar[t & 1];
    score_columns(
        s,
        [&](int k, int j) {
          return __fadd_rn(cur[k], __ldg(a_g + (int64_t)k * K + j));
        },
        [&](int j, float best, int arg) {   // best + (em + pen)
          const float e = j == fj ? e_cur : emission(t, start, j);
          const float v = __fadd_rn(best, __fadd_rn(e, pen(start + c0 + j, c)));
          psi_t[j] = arg;
          if (MBAR) {
#pragma unroll
            for (int q = 0; q < kCluster; ++q)
              st_async(nxt + c0 + j, mb_nxt, q, v);
          } else {
            push_all(cluster, nxt, c0 + j, v);
          }
        },
        pv, pf);
    // every read of the partial maxima ends before the next step's scoring
    // writes them (the cluster barrier also lands every push of this step
    // and ends every read of cur before any CTA pushes into it)
    if (MBAR)
      __syncthreads();
    else
      cluster.sync();
    prev = start;
    start = start_n;
    start_n = start_nn;
    start_nn = start_3;
    c = c_n;
    c_n = c_nn;
  }
  if (MBAR && T > 1) mbar_wait(&mbar[(T - 1) & 1], ((T - 2) >> 1) & 1);
  const float* last = buf + ((T - 1) & 1) * Kb;
  for (int j = tid; j < nw; j += kFwdThreads) p.delta_w[c0 + j] = last[c0 + j];
  // no CTA leaves while another may still store into it
  cluster.sync();
}

// The backtrack's threads a CTA, the most sub-blocks a CTA cuts its rows
// into, and the states a thread follows at once when it composes a map.
constexpr int kBtThreads = 512;
constexpr int kBtWarps = kBtThreads / 32;
constexpr int kBtMaxSub = 16;
constexpr int kBtIlp = 4;

struct BtArgs {
  const int* psi;        // (B, T, K) contiguous
  const float* delta_T;  // (B, K) contiguous
  int B, T, K;
  int sub;               // sub-blocks a CTA: a power of two
  int* paths;            // (B, T + 1) contiguous
  float* scores;         // (B,)
};

// Rows each CTA of a cluster owns: CTA r owns [r R, (r + 1) R) clipped to T.
__host__ __device__ inline int bt_rows_per_cta(int T) {
  return (T + kCluster - 1) / kCluster;
}

// Offsets into a backtrack CTA's dynamic shared memory, in 4-byte words,
// each 16-byte aligned: the staged rows (R K words and 3 for the alignment
// of the first), the S sub-block maps, the whole map (the only map when S
// is 1) and the argmax's per-warp partials and result.
struct BtSmem {
  int64_t rows, maps, whole, red, total;
};

__host__ __device__ inline BtSmem bt_smem_layout(int T, int K, bool staged,
                                                 int sub) {
  BtSmem s;
  int64_t o = 0;
  s.rows = o;  o = align4(o + (staged ? (int64_t)bt_rows_per_cta(T) * K + 3
                                      : 0));
  s.maps = o;  o = align4(o + (int64_t)sub * K);
  s.whole = sub > 1 ? o : s.maps;
  o = align4(o + (sub > 1 ? K : 0));
  s.red = o;   o = align4(o + 2 * kBtWarps + 1);
  s.total = o;
  return s;
}

// The instance at (T, K): the most sub-blocks (a power of two, at most
// kBtMaxSub and R) whose maps fit beside the staged rows; else the rows
// read from L2 and the most sub-blocks whose maps fit alone.
struct BtPlan {
  bool staged;
  int sub;
};

inline BtPlan bt_plan(int T, int K) {
  const int R = bt_rows_per_cta(T);
  int most = 1;
  while (2 * most <= kBtMaxSub && 2 * most <= R) most *= 2;
  for (int s = most; s >= 1; s /= 2)
    if (4 * bt_smem_layout(T, K, true, s).total <= (int64_t)kSmemBytes)
      return {true, s};
  for (int s = most; s > 1; s /= 2)
    if (4 * bt_smem_layout(T, K, false, s).total <= (int64_t)kSmemBytes)
      return {false, s};
  return {false, 1};   // one map and the partials fit for any K <= 29056
}

// (v, i) beats (bv, bi): a larger value, or an equal one at a lower index.
__device__ __forceinline__ bool bt_better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool STAGED>
__global__ void __launch_bounds__(kBtThreads, 1)
viterbi_backtrack_cluster_kernel(const BtArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.T, K = p.K, S = p.sub;
  const int r = (int)cluster.block_rank();
  const BtSmem L = bt_smem_layout(T, K, STAGED, S);
  int* rows_s = (int*)smem + L.rows;
  int* maps = (int*)smem + L.maps;
  int* whole = (int*)smem + L.whole;
  float* red_v = smem + L.red;
  int* red_i = (int*)smem + L.red + kBtWarps;
  int* q_s = (int*)smem + L.red + 2 * kBtWarps;

  const int R = bt_rows_per_cta(T);
  auto row0 = [&](int c) { return min(c * R, T); };   // CTA c's first row
  const int r0 = row0(r), n = row0(r + 1) - r0;
  const int Ls = (n + S - 1) / S;                     // rows a sub-block
  const int nsub = Ls == 0 ? 0 : (n + Ls - 1) / Ls;   // sub-blocks with rows
  const int G = kBtThreads / S;                       // threads a sub-block
  const int j = tid / G, gt = tid % G;                // this thread's
  const int s0 = r0 + min(j * Ls, n), s1 = r0 + min((j + 1) * Ls, n);

  const int ncl = gridDim.x / kCluster;
  for (int b = blockIdx.x / kCluster; b < p.B; b += ncl) {
    const int* psi_b = p.psi + (int64_t)b * T * K;
    // 1. stage the CTA's rows: element i of the block goes to rows_s[off +
    // i], where off matches the block's 16-byte alignment in global memory,
    // so that the copies between the first and last aligned words take 16
    // bytes each
    int off = 0;
    if (STAGED && n > 0) {
      const int* src = psi_b + (int64_t)r0 * K;
      const int cnt = n * K;
      off = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
      const int head = min((4 - off) & 3, cnt);
      const int quads = (cnt - head) / 4;
      for (int i = tid; i < head; i += kBtThreads)
        cp_async4(rows_s + off + i, src + i);
      for (int q = tid; q < quads; q += kBtThreads)
        cp_async16(rows_s + off + head + 4 * q, src + head + 4 * q);
      for (int i = head + 4 * quads + tid; i < cnt; i += kBtThreads)
        cp_async4(rows_s + off + i, src + i);
      cp_async_commit();
    }
    auto at = [&](int t, int c) -> int {   // psi[b, t, c]
      if (STAGED) return rows_s[off + (t - r0) * K + c];
      return __ldg(psi_b + (int64_t)t * K + c);
    };

    // argmax of delta_T[b] while the copies fly
    const float* d = p.delta_T + (int64_t)b * K;
    float bv = -INFINITY;
    int bi = INT_MAX;   // no entry yet
    for (int k = tid; k < K; k += kBtThreads) {
      const float v = d[k];
      if (bi == INT_MAX || v > bv) {
        bv = v;
        bi = k;
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, m);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
      if (bt_better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kBtWarps ? red_v[lane] : -INFINITY;
      bi = lane < kBtWarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int m = 16; m >= 1; m /= 2) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, m);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
        if (bt_better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) *q_s = bi;
    }
    if (STAGED) cp_async_wait<0>();
    __syncthreads();
    const int q_last = *q_s;

    // 2. compose: f_j(k) for the states k = gt, gt + G, ..., kBtIlp at once
    if (s1 > s0) {
      int* f = maps + (int64_t)j * K;
      for (int k0 = gt; k0 < K; k0 += kBtIlp * G) {
        int c[kBtIlp];
#pragma unroll
        for (int u = 0; u < kBtIlp; ++u) c[u] = min(k0 + u * G, K - 1);
        for (int t = s1 - 1; t >= s0; --t) {
#pragma unroll
          for (int u = 0; u < kBtIlp; ++u) c[u] = at(t, c[u]);
        }
#pragma unroll
        for (int u = 0; u < kBtIlp; ++u)
          if (k0 + u * G < K) f[k0 + u * G] = c[u];
      }
    }
    __syncthreads();
    // 3. the whole map F_r = f_0 o ... o f_{nsub-1} (f_0 itself when S = 1)
    if (S > 1) {
      for (int k = tid; k < K && n > 0; k += kBtThreads) {
        int c = k;
        for (int i = nsub - 1; i >= 0; --i) c = maps[(int64_t)i * K + c];
        whole[k] = c;
      }
    }
    // every CTA's whole map is in place before the first remote read
    cluster.sync();

    // 4. stitch: the state after row s1 - 1, through the later CTAs' whole
    // maps and this CTA's later sub-blocks; 5. fill rows [s0, s1)
    if (gt == 0 && s1 > s0) {
      int q = q_last;
      for (int c = kCluster - 1; c > r; --c)
        if (row0(c + 1) > row0(c)) q = cluster.map_shared_rank(whole, c)[q];
      for (int i = nsub - 1; i > j; --i) q = maps[(int64_t)i * K + q];
      int* path = p.paths + (int64_t)b * (T + 1);
      for (int t = s1 - 1; t >= s0; --t) {
        q = at(t, q);
        path[t] = q;
      }
    }
    if (r == 0 && tid == 0) {
      p.paths[(int64_t)b * (T + 1) + T] = q_last;
      p.scores[b] = d[q_last];
    }
    // 6. no CTA overwrites its maps (the next sequence) or leaves while
    // another may still read them
    cluster.sync();
  }
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
  const BandArgs a = {(const float*)log_A, (const float*)log_pi,
                      (const float*)em, em_st, (const int*)centers,
                      (const int*)starts, width, T, K, Kb, (int*)psi,
                      (float*)delta_w};
  const cudaStream_t s = (cudaStream_t)stream;
  const int W = cols_per_cta(Kb);
  const bool all_own = (Kb + W - 1) / W == kCluster;   // every CTA has columns
  size_t smem = 4 * (size_t)band_smem_layout(Kb, true).total;
  if (all_own && smem <= kSmemBytes)
    return launch_persistent_clusters(viterbi_banded_cluster_kernel<true>, a,
                                      1, kFwdThreads, smem, s);
  // a CTA without columns, or no room for the mbarriers beside the two
  // delta buffers: a cluster barrier a step
  smem = 4 * (size_t)band_smem_layout(Kb, false).total;
  return launch_persistent_clusters(viterbi_banded_cluster_kernel<false>, a,
                                    1, kFwdThreads, smem, s);
}

// The backtrack's instance at (T, K): 2 * sub-blocks a CTA + 1 if the rows
// are staged in shared memory.
extern "C" int viterbi_backtrack_plan(int T, int K) {
  const BtPlan pl = bt_plan(T, K);
  return 2 * pl.sub + (pl.staged ? 1 : 0);
}

extern "C" int viterbi_backtrack_batch(const void* psi, const void* delta_T,
                                       int B, int T, int K, void* paths,
                                       void* scores, void* stream) {
  if (B == 0) return cudaSuccess;
  const BtPlan pl = bt_plan(T, K);
  const BtArgs a = {(const int*)psi, (const float*)delta_T, B, T, K, pl.sub,
                    (int*)paths, (float*)scores};
  const size_t smem =
      4 * (size_t)bt_smem_layout(T, K, pl.staged, pl.sub).total;
  const cudaStream_t s = (cudaStream_t)stream;
  if (pl.staged)
    return launch_persistent_clusters(viterbi_backtrack_cluster_kernel<true>,
                                      a, B, kBtThreads, smem, s);
  return launch_persistent_clusters(viterbi_backtrack_cluster_kernel<false>,
                                    a, B, kBtThreads, smem, s);
}
