// Batched tropical (max, +) matrix product for NVIDIA Hopper (sm_90a).
//
// tropical_matmul_batch replaces the Pallas TPU kernel `_tropical_kernel`
// behind `tropical_matmul` (src/repro/kernels/tropical.py:30, :66) and, with
// args = null, the values-only combine of the JAX package's associative
// scan, `_tropical_matmul` (src/repro/core/assoc.py:18).  For each of N
// independent products of A (I, K) and B (K, J) it computes
//     vals[n, i, j] = max_k (A[n, i, k] + B[n, k, j])
//     args[n, i, j] = the lowest k that attains the max
// in f32 or bf16.  In bf16 each sum is formed in f32 and rounded to bf16
// (round to nearest even) before the max, which is what XLA's bf16 add does
// on the CPU; the max and its argmax compare the rounded values.
//
// What bounds it.  Each (i, j, k) costs an add, a compare and a select (two
// with the argmax), so 2 N I J K f32 operations against the bytes of A, B,
// vals and args once each.  At the associative scan's shape, 64 x 64 x 64
// products, that is 8 operations a byte, below the card's 20: the bytes
// bound it on paper, but the compare and the selects issue 3-4
// instructions a pair, and those set the pace.  The one-thread-per-output
// design it replaces re-read A and B from L1/L2 for every (add, compare)
// pair.  tools/tropical_timing.py measured both designs in one call, on an
// NVIDIA H100 80GB HBM3 at 700.00 W, in device time (CUDA-graph replay):
// at (N, I, K, J) = (256, 64, 64, 64) 0.0132 ms values-only and 0.0179 ms
// with the argmax, against 0.0038 / 0.0050 ms bounds (the replaced design:
// 0.0315 ms, argmax only); 0.0948 / 0.1317 ms at (2047, 64, 64, 64) (was
// 0.376); 0.0510 / 0.0677 ms at (1, 512, 512, 512), 64 tiles on 132 SMs
// (was 0.0745); 0.48-0.49 ms for the 22 launches of one assoc decode at
// (T, K) = (4096, 64), against a 0.12 ms bound (was 1.65-1.66).  At N = 1,
// 64^3, one CTA computes the product: 0.0076 / 0.0098 ms, slower than the
// replaced design's 0.0063.
//
// Design.  The TPU kernel tiles (I, J, K) for the VPU (the MXU cannot do a
// (max, +) product) and carries the running max across K tiles in its
// output block.  Here a CTA of 256 threads computes a 64 x 64 output tile
// (one whole product of the scan), each thread a 4 x 4 register micro-tile
// of (value, argmax).  A and B pass through shared memory in chunks of 32
// along K, in a two-stage ring: f32 operands by cp.async, 16-byte copies
// where the row stride and the pointer allow, 4-byte copies elsewhere;
// bf16 operands are loaded and converted to f32 once, on staging (cp.async
// cannot convert).  A thread reads 4 rows of A and 4 columns of B as 16-byte
// vectors per 4 k, so each value read from shared memory feeds 4 pairs.  A
// persistent grid (as many CTAs as fit) walks the (product, tile) tasks as
// one stream of chunks, so the next task's loads are in flight while the
// current one is scored and stored; one launch takes any N.  vals and args
// go out in 16-byte (bf16 vals: 8-byte) stores where J and the pointers
// allow.  With args = null the values-only instance keeps no argmax and
// writes no args: 48 KB per scan product instead of 64 KB.
//
// Exactness: no fast-math; one add (and in bf16 one rounding) per
// candidate, then an exact compare.  Each thread scans k upward with a
// strict '>' from the k = 0 sum, k is never split across threads, so ties go
// to the lowest k, as `jnp.argmax` and the TPU kernel's strict '>' across K
// tiles; both instances take the same scan, so their vals are the same
// bits.  Chunk positions past K hold -inf: never strictly greater.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() (0 on success); the launch goes on the caller's stream
// and the calling thread's current device, which the Python wrapper sets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kTile = 64;              // output tile: kTile x kTile
constexpr int kChunk = 32;             // K per shared-memory stage
constexpr int kMicro = 4;              // a thread's micro-tile: 4 x 4
constexpr int kSide = kTile / kMicro;  // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kARow = kChunk + 4;      // A rows, padded, 16-byte aligned

struct Stage {
  float a[kTile][kARow];    // A[i0 + i, k0 + k]
  float b[kChunk][kTile];   // B[k0 + k, j0 + j]
};

template <typename T>
struct TropArgs {
  const T* a;   // (N, I, K) contiguous
  const T* b;   // (N, K, J) contiguous
  int64_t N;
  int I, K, J;
  T* vals;      // (N, I, J) contiguous
  int* args;    // (N, I, J) contiguous, or null: the values-only instance
  bool vec_a, vec_b, vec_out;   // 16-byte copies of A, of B; vector stores
};

__device__ __forceinline__ float add_round(float a, float b, float) {
  return a + b;
}
__device__ __forceinline__ float add_round(float a, float b, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(a + b));
}

// One operand tile of rows x cols into shared memory at row stride `ld`:
// element (r, c) is src[(r0 + r) * stride + c0 + c] where r0 + r < nr and
// c0 + c < nc, else -inf.  f32 by cp.async (16-byte copies of 4 columns if
// `vec`), bf16 by loads converted to f32.
template <int ROWS, int COLS>
__device__ inline void stage_tile(float* dst, int ld, const float* src,
                                  int64_t stride, int r0, int nr, int c0,
                                  int nc, bool vec) {
  if (vec) {   // stride and c0 are multiples of 4, src 16-byte aligned
    constexpr int kVecs = ROWS * COLS / 4;
    for (int v = threadIdx.x; v < kVecs; v += kThreads) {
      const int r = v / (COLS / 4), c = v % (COLS / 4) * 4;
      float* d = dst + r * ld + c;
      if (r0 + r < nr && c0 + c < nc) {
        cp_async16(d, src + (int64_t)(r0 + r) * stride + c0 + c);
      } else {
        *reinterpret_cast<float4*>(d) =
            make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
    const int r = e / COLS, c = e % COLS;
    float* d = dst + r * ld + c;
    if (r0 + r < nr && c0 + c < nc)
      cp_async4(d, src + (int64_t)(r0 + r) * stride + c0 + c);
    else
      *d = -INFINITY;
  }
}

template <int ROWS, int COLS>
__device__ inline void stage_tile(float* dst, int ld, const __nv_bfloat16* src,
                                  int64_t stride, int r0, int nr, int c0,
                                  int nc, bool) {
  for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
    const int r = e / COLS, c = e % COLS;
    dst[r * ld + c] =
        r0 + r < nr && c0 + c < nc
            ? __bfloat162float(src[(int64_t)(r0 + r) * stride + c0 + c])
            : -INFINITY;
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[kMicro]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[kMicro]) {
  // each v is already a bf16 value: the conversions are exact
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Element q of v; q is a constant once the loops over it unroll.
__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <typename T, bool ARGS>
__global__ void __launch_bounds__(kThreads, 2)
tropical_tile_kernel(const TropArgs<T> p) {
  __shared__ __align__(16) Stage st[2];
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int I = p.I, K = p.K, J = p.J;
  const int tiles_j = (J + kTile - 1) / kTile;
  const int64_t tiles = (int64_t)((I + kTile - 1) / kTile) * tiles_j;
  const int64_t tasks = p.N * tiles;
  const int chunks = (K + kChunk - 1) / kChunk;

  // task -> (product n, tile origin i0, j0); stages chunk c of it into st[s]
  auto origin = [&](int64_t task, int64_t& n, int& i0, int& j0) {
    n = task / tiles;
    const int tile = (int)(task - n * tiles);
    i0 = tile / tiles_j * kTile;
    j0 = tile % tiles_j * kTile;
  };
  auto stage = [&](int s, int64_t task, int c) {
    int64_t n;
    int i0, j0;
    origin(task, n, i0, j0);
    const int k0 = c * kChunk;
    stage_tile<kTile, kChunk>(&st[s].a[0][0], kARow, p.a + n * I * K, K, i0,
                              I, k0, K, p.vec_a);
    stage_tile<kChunk, kTile>(&st[s].b[0][0], kTile, p.b + n * K * J, J, k0,
                              K, j0, J, p.vec_b);
    cp_async_commit();
  };

  float best[kMicro][kMicro];
  int arg[kMicro][kMicro];
  int64_t task = blockIdx.x;
  int c = 0, s = 0;
  if (task < tasks) stage(0, task, 0);
  while (task < tasks) {
    // the next chunk of this CTA's stream: of this task, or of its next one
    int64_t next = task;
    int nc = c + 1;
    if (nc == chunks) {
      next += gridDim.x;
      nc = 0;
    }
    if (next < tasks) {   // into the stage the chunk before this one used
      stage(s ^ 1, next, nc);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // every thread's copies of chunk c are visible

    const Stage& cur = st[s];
    const int k0 = c * kChunk;
    if (c == 0) {   // the k = 0 sums
#pragma unroll
      for (int u = 0; u < kMicro; ++u) {
#pragma unroll
        for (int v = 0; v < kMicro; ++v) {
          best[u][v] = add_round(cur.a[ty * kMicro + u][0],
                                 cur.b[0][tx * kMicro + v], T());
          if (ARGS) arg[u][v] = 0;
        }
      }
    }
    const int kn = min(kChunk, K - k0);
    for (int kk = 0; kk < kn; kk += 4) {   // k upward; past K: -inf
      float4 a[kMicro], b[4];   // rows of A at k .. k+3; rows k .. k+3 of B
#pragma unroll
      for (int u = 0; u < kMicro; ++u)
        a[u] = *reinterpret_cast<const float4*>(&cur.a[ty * kMicro + u][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(&cur.b[kk + q][tx * kMicro]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int u = 0; u < kMicro; ++u) {
#pragma unroll
          for (int v = 0; v < kMicro; ++v) {
            const float x = add_round(lane(a[u], q), lane(b[q], v), T());
            if (x > best[u][v]) {
              best[u][v] = x;
              if (ARGS) arg[u][v] = k0 + kk + q;
            }
          }
        }
      }
    }

    if (c == chunks - 1) {   // the task's last chunk: store its tile
      int64_t n;
      int i0, j0;
      origin(task, n, i0, j0);
      const int j = j0 + tx * kMicro;
#pragma unroll
      for (int u = 0; u < kMicro; ++u) {
        const int i = i0 + ty * kMicro + u;
        if (i >= I) break;
        const int64_t o = (n * I + i) * (int64_t)J + j;
        if (p.vec_out && j + kMicro <= J) {
          store4(p.vals + o, best[u]);
          if (ARGS)
            *reinterpret_cast<int4*>(p.args + o) =
                make_int4(arg[u][0], arg[u][1], arg[u][2], arg[u][3]);
        } else {
#pragma unroll
          for (int v = 0; v < kMicro; ++v) {
            if (j + v < J) {
              store1(p.vals + o + v, best[u][v]);
              if (ARGS) p.args[o + v] = arg[u][v];
            }
          }
        }
      }
    }
    __syncthreads();   // every read of st[s] is done before it is restaged
    task = next;
    c = nc;
    s ^= 1;
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (uintptr_t)ptr % bytes == 0;
}

template <typename T, bool ARGS>
int launch(const void* a, const void* b, int N, int I, int K, int J,
           void* vals, void* args, void* stream) {
  const auto kernel = tropical_tile_kernel<T, ARGS>;
  static int per_sm = 0;   // resident CTAs per SM, once per instance
  cudaError_t err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tasks = (int64_t)N * ((I + kTile - 1) / kTile) *
                        ((J + kTile - 1) / kTile);
  const int64_t fit = (int64_t)sms * per_sm;
  const int blocks = (int)(tasks < fit ? tasks : fit);
  // 16-byte copies need 16-byte rows and a 16-byte aligned base (f32 only)
  const bool f32 = sizeof(T) == 4;
  const TropArgs<T> p = {
      (const T*)a, (const T*)b, N, I, K, J, (T*)vals, (int*)args,
      f32 && K % 4 == 0 && aligned(a, 16),
      f32 && J % 4 == 0 && aligned(b, 16),
      J % 4 == 0 && aligned(vals, 4 * sizeof(T)) &&
          (!ARGS || aligned(args, 16))};
  tropical_tile_kernel<T, ARGS><<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_instance(const void* a, const void* b, int N, int I, int K, int J,
                    void* vals, void* args, void* stream) {
  if (args == nullptr)
    return launch<T, false>(a, b, N, I, K, J, vals, args, stream);
  return launch<T, true>(a, b, N, I, K, J, vals, args, stream);
}

}  // namespace

// bf16 != 0 selects bfloat16 operands and values; else float32.  args may
// be null: the values-only instance, which computes the same vals.
extern "C" int tropical_matmul_batch(const void* a, const void* b, int bf16,
                                     int N, int I, int K, int J, void* vals,
                                     void* args, void* stream) {
  if (N == 0 || I == 0 || J == 0) return cudaSuccess;
  if (bf16)
    return launch_instance<__nv_bfloat16>(a, b, N, I, K, J, vals, args,
                                          stream);
  return launch_instance<float>(a, b, N, I, K, J, vals, args, stream);
}
