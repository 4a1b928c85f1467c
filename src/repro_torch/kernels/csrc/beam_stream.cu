// FLASH-BS beam passes for NVIDIA Hopper (sm_90a): one launch per pass.
//
// Replaces the Pallas TPU kernel `_beam_step_kernel` and its merge
// `_select_top_b` behind `beam_step` (src/repro/kernels/beam_stream.py:36,
// :60, :121), and the host loop around it: one template, four C entries.
//
//   bs_initial_pass_batch    the FLASH-BS initial pass of N sequences
//                            (`core/flash_bs.py::_bs_initial_pass` of the
//                            JAX package): the seeding top-B, the Tp - 1
//                            transitions with the pad identity, the
//                            division-state bookkeeping, the best slot.
//   bs_segment_decode_batch  one layer of the wavefront, M tiles of s steps
//                            (`_bs_segment_decode`): the seed from log_pi or
//                            log_A[entry], s - 1 transitions, the midpoint
//                            carry from step s / 2 on, the exit fallback.
//   beam_step_batch          one transition of N given beams.
//   bs_chunk_batch           N streaming beams through C rows of emissions
//                            (`_beam_init` and the `lax.scan` of
//                            `_beam_chunk_scan`, src/repro/core/online.py:
//                            434-450, not Pallas): a beam flagged first seeds
//                            from log_pi + em[0], the others carry their beam
//                            into a transition on row 0; then a transition
//                            per row, each row's slot states and from-slots
//                            written out, and the final beam.
//
// A transition of a beam with B slots (scores[b], states[b]) and emissions
// em[c] of the next step scores every target c against every slot,
//     cand[b, c] = (scores[b] + log_A[states[b], c]) + em[c],
// keeps best[c] = max_b cand[b, c] and from[c] = the lowest b attaining it,
// and selects the stable top-B of the list
//     [B sentinels (-4e9, state 0, slot 0)] ++ [best of target 0, 1, ...]
// by value descending, then by position ascending.  The JAX code merges the
// targets chunk by chunk into a running top-B seeded with those sentinels;
// its merge is stable and the chunks arrive in target order, so its result
// is this single selection whatever the chunk (tests/test_torch_kernels.py
// holds the plain version to that over chunk sizes).  A pad step keeps the
// beam and points every slot at itself.
//
// Design.  Each task (a sequence of the initial pass, a tile of a layer, a
// beam) is owned by one thread-block cluster of 8 CTAs; a persistent grid of
// as many clusters as fit on the card walks the tasks.  CTA r owns the
// target columns [r W, (r + 1) W), W = ceil(K / 8), and in the resident
// instance holds that column slice of log_A in shared memory for the whole
// launch (K W floats: 128 KiB at K = 512), loaded once per cluster and
// launch; where it does not fit (K >~ 700) the global instance reads the
// slice from L2.  Every CTA keeps a full copy of the beam, 16-byte slots
// (score, state, from-slot) double-buffered.  A step:
//   1. every slot of the next buffer starts as a sentinel, so the targets
//      above the sentinel value take the first slots and sentinels the rest;
//   2. score: thread (j, part) scores target c0 + j against one contiguous
//      range of slots, ascending with a strict '>', the two f32 adds in the
//      order above (__fadd_rn: no contraction, no fast-math); the parts
//      combine in slot order, so ties keep the lowest slot;
//   3. each target gets a 64-bit key whose unsigned order is the selection
//      order (value descending, target ascending); each CTA ranks its keys
//      among its own by counting and writes them, sorted, into every CTA's
//      copy of the 8 lists through distributed shared memory; cluster
//      barrier;
//   4. a target's rank is its rank in its own list plus, for every other
//      list, the keys above it (a binary search); targets ranked below B and
//      above the sentinel value are written into every CTA's next beam
//      through distributed shared memory; cluster barrier.
// CTA r keeps the bookkeeping columns k = r, r + 8, ... (the division
// states of each slot, or CTA 0 the midpoint) double-buffered in shared
// memory and updates them after each step from the from-slots and the old
// states, pad steps included.  The next step's emission and pad flag are
// loaded into registers while the current step computes.
//
// What bounds it.  A transition is 3 B K flops and two cluster barriers;
// steps are serially dependent, so a pass takes at least its steps times
// the latency of one step, far above both the bytes bound (log_A once per
// cluster, em once) and the operations bound.  At the serve's K = 512,
// B = 128 the scoring (B K / 8 candidates a CTA), the two cluster barriers
// and the selection take most of a step.
//
// Exactness: values are compared as f32, equal values keep their order,
// so every entry equals its plain version in `ref.py` bit for bit.
//
// Plain C interface, loaded with ctypes.  The entries return
// cudaGetLastError() (0 on success); the launch goes on the caller's stream
// and the calling thread's current device, which the Python wrapper sets.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kSentinel = -4.0e9f;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kStep = 0, kInitial = 1, kSegment = 2, kChunk = 3 };

struct Args {
  const float* log_pi;         // (K,), the passes
  const float* log_A;          // (K, K) contiguous
  const float* em;             // (N, T, K), strides (em_sn, em_st, 1)
  int64_t em_sn, em_st;
  const uint8_t* pad;          // (N, T) bool, strides (pad_sn, 1)
  int64_t pad_sn;
  const float* scores;         // (N, B), kStep and kChunk
  const int* states;           // (N, B), kStep and kChunk
  const int* bounds;           // (nb,), kInitial
  int nb;
  const int64_t* entry;        // (N,), kSegment
  const int64_t* exit_state;   // (N,), kSegment
  const uint8_t* is_first;     // (N,) bool, kSegment and kChunk
  int N, T, K, B;
  float* out_s;                // (N, B), kStep and kChunk
  int* out_st;                 // (N, B), kStep and kChunk
  int* out_f;                  // (N, B), kStep
  int* out_hst;                // (N, T, B), kChunk: each row's slot states
  int* out_hf;                 // (N, T, B), kChunk: ... and from-slots
  int* out_div;                // (N, nb), kInitial
  int* out_q;                  // (N,): q_last (kInitial), midpoint (kSegment)
  float* out_score;            // (N,), kInitial
};

// bookkeeping columns (division states, or the midpoint) of the busiest
// CTA: CTA r keeps the columns k = r, r + 8, ...
__host__ __device__ inline int book_cols(int book) {
  return (book + kCluster - 1) / kCluster;
}

// Offsets into the dynamic shared memory, in 4-byte words, each 16-byte
// aligned.
struct Smem {
  int64_t a, beam, lists, mykey, myv, myf, mylr, pv, pf, book, cross, total;
};

__host__ __device__ inline Smem smem_layout(int K, int B, int book,
                                            bool resident) {
  const int W = cols_per_cta(K);
  const int parts = kThreads / lane_width(W, kThreads);
  const int cols = book_cols(book);
  Smem s;
  int64_t o = 0;
  s.a = o;     o = align4(o + (resident ? (int64_t)K * W : 0));  // log_A cols
  s.beam = o;  o = align4(o + 8 * (int64_t)B);     // 2 buffers of B slots
  s.lists = o; o = align4(o + 2 * (int64_t)kCluster * W);  // sorted keys
  s.mykey = o; o = align4(o + 2 * (int64_t)W);     // own targets' order keys
  s.myv = o;   o = align4(o + W);                  // ... best values
  s.myf = o;   o = align4(o + W);                  // ... from-slots
  s.mylr = o;  o = align4(o + W);                  // ... rank among own
  s.pv = o;    o = align4(o + (int64_t)parts * W); // per-part values
  s.pf = o;    o = align4(o + (int64_t)parts * W); // per-part slots / counts
  s.book = o;  o = align4(o + 2 * (int64_t)cols * B);  // 2 buffers
  s.cross = o; o = align4(o + cols);               // each column's step
  s.total = o;
  return s;
}

// A beam slot; 16 bytes, so a slot moves in one store.
struct __align__(16) Slot {
  float score;
  int state;
  int from;
  int unused;
};

// A key whose unsigned order is (value descending, target ascending):
// rank(c) = #{q : key_q > key_c}.  -0 maps to +0, as f32 compares them.
__device__ inline unsigned long long order_key(float v, int c) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)c);
}

// the lowest-index maximum over a warp; i == INT_MAX marks "no entry"
__device__ inline void warp_first_max(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    if (oi != INT_MAX &&
        (i == INT_MAX || ov > v || (ov == v && oi < i))) {
      v = ov;
      i = oi;
    }
  }
}

template <int MODE, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
beam_pass_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int K = p.K, B = p.B;
  const int bw = MODE == kInitial ? p.nb : (MODE == kSegment ? 1 : 0);
  const Smem L = smem_layout(K, B, bw, RESIDENT);
  const int W = cols_per_cta(K);
  const int Wp = lane_width(W, kThreads), parts = kThreads / Wp;
  const int c0 = min(r * W, K), nw = min(c0 + W, K) - c0;
  const int jl = tid % Wp, part = tid / Wp;
  // this CTA's bookkeeping columns k = r + 8 i, i < mine
  const int mine = bw > r ? (bw - r + kCluster - 1) / kCluster : 0;

  float* A_s = smem + L.a;
  unsigned long long* lists = (unsigned long long*)(smem + L.lists);
  unsigned long long* mykey = (unsigned long long*)(smem + L.mykey);
  float* myv = smem + L.myv;
  int* myf = (int*)(smem + L.myf);
  int* mylr = (int*)(smem + L.mylr);
  float* pv = smem + L.pv;
  int* pf = (int*)(smem + L.pf);
  int* cross = (int*)(smem + L.cross);
  auto beam = [&](int i) { return (Slot*)(smem + L.beam) + (int64_t)B * i; };
  auto book = [&](int i) {
    return (int*)(smem + L.book) + (int64_t)book_cols(bw) * B * i;
  };
  auto A = [&](int k, int j) -> float {
    return RESIDENT ? A_s[(int64_t)k * W + j]
                    : __ldg(p.log_A + (int64_t)k * K + c0 + j);
  };

  if (RESIDENT) {   // this CTA's column slice of log_A, once per launch
    for (int k = part; k < K; k += parts)
      for (int j = jl; j < nw; j += Wp)
        A_s[(int64_t)k * W + j] = __ldg(p.log_A + (int64_t)k * K + c0 + j);
  }
  for (int i = tid; i < mine; i += kThreads)   // a column's crossing step
    cross[i] = MODE == kInitial ? p.bounds[r + kCluster * i] + 1 : p.T / 2;
  // the slice is in place, and every CTA of the cluster has started before
  // any stores into its shared memory
  cluster.sync();

  // Every slot of `dst` starts as a sentinel (-4e9, state 0, slot 0): the
  // targets above the sentinel value take the first slots, the sentinels
  // keep the rest.  Before the list is complete, so that no winner is
  // overwritten.
  auto prefill = [&](int dst) {
    Slot* d = beam(dst);
    for (int i = tid; i < B; i += kThreads) d[i] = Slot{kSentinel, 0, 0, 0};
  };

  // Select the stable top-B of [B sentinels] ++ [every target's best] into
  // every CTA's beam buffer `dst`, from this CTA's targets (myv, myf).
  // Each CTA sorts its targets' order keys (by counting) and publishes the
  // sorted list to every CTA; a target's rank is then its rank among its
  // own CTA's plus, for each other CTA, the number of its keys above (a
  // binary search of a sorted list).
  auto select = [&](int dst) {
    for (int j = tid; j < nw; j += kThreads)
      mykey[j] = order_key(myv[j], c0 + j);
    __syncthreads();
    const int lper = (nw + parts - 1) / parts;
    const int l0 = min(part * lper, nw), l1 = min(l0 + lper, nw);
    for (int j = jl; j < nw; j += Wp) {
      const unsigned long long key = mykey[j];
      int cnt = 0;
      for (int i = l0; i < l1; ++i) cnt += mykey[i] > key;
      pf[part * W + j] = cnt;
    }
    __syncthreads();
    for (int j = tid; j < nw; j += kThreads) {
      int lr = 0;
      for (int q = 0; q < parts; ++q) lr += pf[q * W + j];
      mylr[j] = lr;
      for (int q = 0; q < kCluster; ++q)
        cluster.map_shared_rank(lists, q)[r * W + lr] = mykey[j];
    }
    cluster.sync();
    for (int j = jl; j < nw; j += Wp) {
      int cnt = B;   // at or below the sentinel value: never selected
      if (myv[j] > kSentinel) {
        const unsigned long long key = mykey[j];
        cnt = 0;
        for (int q = part; q < kCluster; q += parts) {
          if (q == r) continue;
          const unsigned long long* list = lists + q * W;
          int lo = 0, hi = min(q * W + W, K) - min(q * W, K);
          while (lo < hi) {   // the keys of CTA q above `key`
            const int mid = (lo + hi) >> 1;
            if (list[mid] > key) lo = mid + 1;
            else hi = mid;
          }
          cnt += lo;
        }
      }
      pf[part * W + j] = cnt;
    }
    __syncthreads();
    for (int j = tid; j < nw; j += kThreads) {
      int rank = mylr[j];
      for (int q = 0; q < parts; ++q) rank += pf[q * W + j];
      if (rank < B) {
        const Slot x = {myv[j], c0 + j, myf[j], 0};
        for (int q = 0; q < kCluster; ++q)
          cluster.map_shared_rank(beam(dst), q)[rank] = x;
      }
    }
    cluster.sync();
  };

  // One transition of beam buffer `src` into `dst`; `e0` is the emission of
  // this thread's first target (loaded a step ahead), erow the step's row.
  auto transition = [&](int src, int dst, const float* erow, float e0) {
    prefill(dst);
    const Slot* sb = beam(src);
    const int per = (B + parts - 1) / parts;
    const int b0 = min(part * per, B), b1 = min(b0 + per, B);
    for (int j = jl; j < nw; j += Wp) {
      const float e = j == jl ? e0 : erow[c0 + j];
      float best = -INFINITY;   // an empty part never wins the combine
      int arg = B;
      if (b0 < b1) {
        const Slot x = sb[b0];
        best = __fadd_rn(__fadd_rn(x.score, A(x.state, j)), e);
        arg = b0;
      }
      int b = b0 + 1;
      for (; b + 4 <= b1; b += 4) {   // four slots' loads in flight
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const Slot y = sb[b + u];
          v[u] = __fadd_rn(__fadd_rn(y.score, A(y.state, j)), e);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (v[u] > best) {
            best = v[u];
            arg = b + u;
          }
        }
      }
      for (; b < b1; ++b) {
        const Slot y = sb[b];
        const float v = __fadd_rn(__fadd_rn(y.score, A(y.state, j)), e);
        if (v > best) {
          best = v;
          arg = b;
        }
      }
      pv[part * W + j] = best;
      pf[part * W + j] = arg;
    }
    __syncthreads();
    for (int j = tid; j < nw; j += kThreads) {   // parts in slot order
      float best = pv[j];
      int arg = pf[j];
      for (int q = 1; q < parts; ++q) {
        if (pv[q * W + j] > best) {
          best = pv[q * W + j];
          arg = pf[q * W + j];
        }
      }
      myv[j] = best;
      myf[j] = arg;
    }
    select(dst);
  };

  const int ncl = gridDim.x / kCluster;
  for (int n = blockIdx.x / kCluster; n < p.N; n += ncl) {
    const float* em_n = p.em + (int64_t)n * p.em_sn;
    if (MODE == kStep) {
      for (int i = tid; i < B; i += kThreads) {
        beam(0)[i] = Slot{p.scores[(int64_t)n * B + i],
                          p.states[(int64_t)n * B + i], 0, 0};
      }
      __syncthreads();
      transition(0, 1, em_n, jl < nw ? em_n[c0 + jl] : 0.f);
      if (r == 0) {
        for (int i = tid; i < B; i += kThreads) {
          const Slot x = beam(1)[i];
          p.out_s[(int64_t)n * B + i] = x.score;
          p.out_st[(int64_t)n * B + i] = x.state;
          p.out_f[(int64_t)n * B + i] = x.from;
        }
      }
      continue;
    }

    if (MODE == kChunk) {
      // row t's beam into row t of the history, and the final beam, by CTA 0
      auto record = [&](int t, int src) {
        const Slot* sb = beam(src);
        const int64_t o = ((int64_t)n * p.T + t) * B;
        for (int i = tid; i < B; i += kThreads) {
          const Slot x = sb[i];
          p.out_hst[o + i] = x.state;
          p.out_hf[o + i] = x.from;
        }
      };
      const bool first = p.is_first[n] != 0;
      if (first) {   // the stable top-B of log_pi + em[0], from-slots 0
        prefill(0);
        for (int j = tid; j < nw; j += kThreads) {
          myv[j] = __fadd_rn(p.log_pi[c0 + j], em_n[c0 + j]);
          myf[j] = 0;
        }
        select(0);
        if (r == 0) record(0, 0);
      } else {
        for (int i = tid; i < B; i += kThreads) {
          beam(0)[i] = Slot{p.scores[(int64_t)n * B + i],
                            p.states[(int64_t)n * B + i], 0, 0};
        }
        __syncthreads();
      }
      const int T = p.T, t0 = first ? 1 : 0;
      int cur = 0;
      float e_next = 0.f;
      if (t0 < T && jl < nw) e_next = em_n[(int64_t)t0 * p.em_st + c0 + jl];
      for (int t = t0; t < T; ++t) {
        const float e_cur = e_next;
        if (t + 1 < T && jl < nw)   // the next row, while this one computes
          e_next = em_n[(int64_t)(t + 1) * p.em_st + c0 + jl];
        transition(cur, 1 - cur, em_n + (int64_t)t * p.em_st, e_cur);
        cur = 1 - cur;
        if (r == 0) record(t, cur);
      }
      if (r == 0) {
        const Slot* sb = beam(cur);
        for (int i = tid; i < B; i += kThreads) {
          p.out_s[(int64_t)n * B + i] = sb[i].score;
          p.out_st[(int64_t)n * B + i] = sb[i].state;
        }
      }
      __syncthreads();
      continue;
    }

    // seed: the stable top-B of the first step's scores
    const bool first = MODE == kInitial || p.is_first[n];
    const int entry = MODE == kSegment ? (int)p.entry[n] : 0;
    prefill(0);
    for (int j = tid; j < nw; j += kThreads) {
      const float base = first ? p.log_pi[c0 + j] : A(entry, j);
      myv[j] = __fadd_rn(base, em_n[c0 + j]);
      myf[j] = 0;
    }
    for (int i = tid; i < mine * B; i += kThreads) book(0)[i] = 0;
    select(0);

    const uint8_t* pad_n = p.pad + (int64_t)n * p.pad_sn;
    const int T = p.T;
    int cur = 0, bk = 0;
    float e_next = 0.f;
    bool pad_next = false;
    if (T > 1) {
      e_next = jl < nw ? em_n[p.em_st + c0 + jl] : 0.f;
      pad_next = pad_n[1] != 0;
    }
    for (int t = 1; t < T; ++t) {
      const float e_cur = e_next;
      const bool is_pad = pad_next;
      if (t + 1 < T) {   // prefetch the next step while this one computes
        if (jl < nw) e_next = em_n[(int64_t)(t + 1) * p.em_st + c0 + jl];
        pad_next = pad_n[t + 1] != 0;
      }
      int nxt = cur;
      if (!is_pad) {
        nxt = 1 - cur;
        transition(cur, nxt, em_n + (int64_t)t * p.em_st, e_cur);
      }
      // follow the from-slots (a pad step's are the identity); a column
      // whose step this is takes the old state
      const Slot* old = beam(cur);
      const Slot* now = beam(nxt);
      for (int ci = 0; ci < mine; ++ci) {
        const int* bo = book(bk) + (int64_t)ci * B;
        int* bn = book(1 - bk) + (int64_t)ci * B;
        const bool crossing = t == cross[ci];
        for (int i = tid; i < B; i += kThreads) {
          const int f = is_pad ? i : now[i].from;
          bn[i] = crossing ? old[f].state : bo[f];
        }
      }
      __syncthreads();
      cur = nxt;
      bk = 1 - bk;
    }

    if ((r == 0 || mine > 0) && tid < 32) {
      const Slot* sb = beam(cur);
      int idx = INT_MAX;
      if (MODE == kSegment) {   // the first slot holding the exit state
        const int want = (int)p.exit_state[n];
        for (int i = tid; i < B; i += 32)
          if (sb[i].state == want) {
            idx = i;
            break;
          }
        for (int off = 16; off > 0; off >>= 1)
          idx = min(idx, __shfl_xor_sync(kFull, idx, off));
      }
      if (idx == INT_MAX) {     // else the first best slot
        float v = -INFINITY;
        for (int i = tid; i < B; i += 32)
          if (idx == INT_MAX || sb[i].score > v) {
            v = sb[i].score;
            idx = i;
          }
        warp_first_max(v, idx);
        idx = __shfl_sync(kFull, idx, 0);
      }
      const int* bk_now = book(bk);
      if (MODE == kInitial) {
        for (int ci = tid; ci < mine; ci += 32)
          p.out_div[(int64_t)n * bw + r + kCluster * ci] =
              bk_now[(int64_t)ci * B + idx];
        if (r == 0 && tid == 0) {
          p.out_q[n] = sb[idx].state;
          p.out_score[n] = sb[idx].score;
        }
      } else if (r == 0 && tid == 0) {
        p.out_q[n] = bk_now[idx];
      }
    }
    __syncthreads();
  }
  cluster.sync();   // no CTA leaves while another may still write to it
}

template <int MODE, bool RESIDENT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int bw = MODE == kInitial ? a.nb : (MODE == kSegment ? 1 : 0);
  const size_t smem = 4 * (size_t)smem_layout(a.K, a.B, bw, RESIDENT).total;
  return launch_persistent_clusters(beam_pass_kernel<MODE, RESIDENT>, a, a.N,
                                    kThreads, smem, stream);
}

template <int MODE>
cudaError_t launch_instance(const Args& a, int resident, void* stream) {
  return resident ? launch<MODE, true>(a, (cudaStream_t)stream)
                  : launch<MODE, false>(a, (cudaStream_t)stream);
}

}  // namespace

// Shared memory bytes a launch needs; `book` is the bookkeeping words per
// slot (nb for the initial pass, 1 for tiles, 0 for a step).
extern "C" int beam_pass_smem_bytes(int K, int B, int book, int resident) {
  const int64_t bytes = 4 * smem_layout(K, B, book, resident != 0).total;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// em (N, T, K) with strides (em_sn, em_st, 1), pad (N, T) bool with strides
// (pad_sn, 1), everything else contiguous.
extern "C" int bs_initial_pass_batch(
    const void* log_pi, const void* log_A, const void* em, int64_t em_sn,
    int64_t em_st, const void* pad, int64_t pad_sn, const void* bounds,
    int nb, int N, int T, int K, int B, int resident, void* q_bounds,
    void* q_last, void* score, void* stream) {
  Args a = {};
  a.log_pi = (const float*)log_pi;
  a.log_A = (const float*)log_A;
  a.em = (const float*)em;
  a.em_sn = em_sn;
  a.em_st = em_st;
  a.pad = (const uint8_t*)pad;
  a.pad_sn = pad_sn;
  a.bounds = (const int*)bounds;
  a.nb = nb;
  a.N = N;
  a.T = T;
  a.K = K;
  a.B = B;
  a.out_div = (int*)q_bounds;
  a.out_q = (int*)q_last;
  a.out_score = (float*)score;
  return launch_instance<kInitial>(a, resident, stream);
}

// em (M, s, K) and pad (M, s) as above; entry, exit_state (M,) int64 and
// is_first (M,) bool contiguous.
extern "C" int bs_segment_decode_batch(
    const void* log_pi, const void* log_A, const void* em, int64_t em_sn,
    int64_t em_st, const void* pad, int64_t pad_sn, const void* entry,
    const void* exit_state, const void* is_first, int M, int s, int K, int B,
    int resident, void* mid, void* stream) {
  Args a = {};
  a.log_pi = (const float*)log_pi;
  a.log_A = (const float*)log_A;
  a.em = (const float*)em;
  a.em_sn = em_sn;
  a.em_st = em_st;
  a.pad = (const uint8_t*)pad;
  a.pad_sn = pad_sn;
  a.entry = (const int64_t*)entry;
  a.exit_state = (const int64_t*)exit_state;
  a.is_first = (const uint8_t*)is_first;
  a.N = M;
  a.T = s;
  a.K = K;
  a.B = B;
  a.out_q = (int*)mid;
  return launch_instance<kSegment>(a, resident, stream);
}

// em (N, C, K) with strides (em_sn, em_st, 1); log_pi, log_A, scores,
// states (N, B), is_first (N,) bool and the outputs contiguous.  scores and
// states are read only for beams not flagged first.  hist_st and hist_f are
// (N, C, B).
extern "C" int bs_chunk_batch(const void* log_pi, const void* log_A,
                              const void* em, int64_t em_sn, int64_t em_st,
                              const void* scores, const void* states,
                              const void* is_first, int N, int C, int K,
                              int B, int resident, void* out_s, void* out_st,
                              void* hist_st, void* hist_f, void* stream) {
  Args a = {};
  a.log_pi = (const float*)log_pi;
  a.log_A = (const float*)log_A;
  a.em = (const float*)em;
  a.em_sn = em_sn;
  a.em_st = em_st;
  a.scores = (const float*)scores;
  a.states = (const int*)states;
  a.is_first = (const uint8_t*)is_first;
  a.N = N;
  a.T = C;
  a.K = K;
  a.B = B;
  a.out_s = (float*)out_s;
  a.out_st = (int*)out_st;
  a.out_hst = (int*)hist_st;
  a.out_hf = (int*)hist_f;
  return launch_instance<kChunk>(a, resident, stream);
}

// em rows may be strided (em_sn floats apart); everything else contiguous.
// A single step reads its slots' rows of log_A from L2.
extern "C" int beam_step_batch(const void* log_A, const void* em,
                               int64_t em_sn, const void* scores,
                               const void* states, int N, int K, int B,
                               void* out_s, void* out_st, void* out_f,
                               void* stream) {
  Args a = {};
  a.log_A = (const float*)log_A;
  a.em = (const float*)em;
  a.em_sn = em_sn;
  a.scores = (const float*)scores;
  a.states = (const int*)states;
  a.N = N;
  a.T = 2;
  a.K = K;
  a.B = B;
  a.out_s = (float*)out_s;
  a.out_st = (int*)out_st;
  a.out_f = (int*)out_f;
  return launch_instance<kStep>(a, 0, stream);
}
