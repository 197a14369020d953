// Window-first counts of the cache simulator's contested-revisit scan.
//
// Replaces _jax_window_kernel / _jax_window_counts of
// src/repro/core/cachesim_vec.py (:307-352), a jitted jax.numpy
// gather-compare-reduce (the reference's one accelerator scan; not a
// pallas_call).  For each row r of one chunk step of the scan:
//
//   out[r] = #{ j in [0, chunk) : j < span[r]
//                                 and q[min(lo[r] + j, m - 1)] <= thr[r] }
//
// q is the set-major previous-occurrence index of the collapsed stream
// (-1 for a cold slot); a row is one live query window.  Bound on the card:
// HBM bytes, each q slot that some row's window covers (span capped at
// chunk) read once, plus each row's (lo, thr, span) and its count; there
// is no arithmetic to speak of.  The windows are short (8-32 slots at the
// scan's first chunks), overlap, and lie at scattered places of q, so what
// the card must hide is latency and the instructions a row costs: a row
// is a dependent pair of loads (its lo, then its window).  The design
// (kernels/window_scan/plan.py picks its numbers):
//  - a row gets L lanes (the next power of two >= chunk, at most 4) that
//    walk its window in S steps of L slots, so a warp walks 32 / L rows at
//    once; a row's hits are a ballot a step masked to its lane segment.
//    Few lanes a row keep each warp instruction busy with many rows (on
//    the card 4 lanes beat 8, 16 and 32 at chunk 32);
//  - each lane issues the loads of all its rows' steps (up to kLoads)
//    before any compare;
//  - a persistent block takes tiles of rows: their lo, thr and span arrive
//    as three coalesced cp.async streams into a double-buffered shared
//    tile (tile t+1's while tile t's windows are read), which takes the
//    first load of the pair off every row; the tile's counts leave in one
//    coalesced store;
//  - chunks of 64-256 slots take 32 lanes in S steps, and longer ones
//    (L = 32, S = 1) the full-warp walk with kLongSteps 32-slot steps
//    loaded at once.
// q, the rows and the counts share one integer type: int32 while m < 2^31,
// else int64 (the host's qdt).
#include "common.cuh"

namespace {

// plan.THREADS, LONG_STEPS, LOADS, MAX_TILE_ROWS
constexpr int kThreads = 256;
constexpr int kLongSteps = 4;
constexpr int kLoads = 16;
constexpr int kMaxTileRows = 512;

// Rows in flight a lane segment (plan.rows_in_flight) and rows a tile, for
// L lanes a row and S steps.
template <int L, int S>
struct Shape {
  static constexpr int kByTile = kMaxTileRows * L / kThreads;
  static constexpr int kByLoads = kLoads / S;
  static constexpr int kMin = kByTile < kByLoads ? kByTile : kByLoads;
  static constexpr int kInFlight = kMin > 0 ? kMin : 1;
  static constexpr int kSegs = kThreads / L;
  static constexpr int kTile = kSegs * kInFlight;
};

// Unsigned index wide enough for lo + j (lo < m, j < span, both < 2^31 for
// int32).
template <typename T>
struct Index;
template <>
struct Index<int32_t> {
  using type = uint32_t;
};
template <>
struct Index<int64_t> {
  using type = uint64_t;
};

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Tile t's lo, thr and span rows into buf [3][kTile], three coalesced
// streams; rows past n_rows are not loaded.
template <typename T, int kTile>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ rows,
                                      int64_t n_rows, int64_t t) {
  const int64_t r0 = t * kTile;
  for (int e = threadIdx.x; e < 3 * kTile; e += kThreads) {
    const int s = e / kTile, i = e % kTile;
    if (r0 + i < n_rows) cp_async(buf + e, rows + s * n_rows + r0 + i);
  }
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int L, int S>
__global__ void __launch_bounds__(kThreads)
window_count_kernel(const T* __restrict__ q, int64_t m,
                    const T* __restrict__ rows, int64_t n_rows, int64_t chunk,
                    T* __restrict__ out) {
  using Sh = Shape<L, S>;
  using I = typename Index<T>::type;
  constexpr int kTile = Sh::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][3][kTile]: lo, thr, span
  T* counts = buf + 6 * kTile;              // [kTile]
  const int seg = threadIdx.x / L, lane = threadIdx.x % L;
  const unsigned seg_mask = (0xffffffffu >> (32 - L))
                            << ((threadIdx.x & 31) & ~(L - 1));
  const I last = static_cast<I>(m - 1);
  const int64_t n_tiles = (n_rows + kTile - 1) / kTile;

  int64_t t = blockIdx.x;
  if (t < n_tiles) stage<T, kTile>(buf, rows, n_rows, t);
  cp_async_commit();
  for (int b = 0; t < n_tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < n_tiles)
      stage<T, kTile>(buf + (b ^ 1) * 3 * kTile, rows, n_rows,
                      t + gridDim.x);
    cp_async_commit();
    cp_async_wait_one();  // tile t has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    const T* lo_s = buf + b * 3 * kTile;
    const T* thr_s = lo_s + kTile;
    const T* span_s = thr_s + kTile;
    const int64_t r0 = t * kTile;
    if (chunk <= L * S) {
      // S steps of L lanes cover the whole window (n <= L S): every load
      // of the segment's rows first, then a masked ballot a step.
      T v[Sh::kInFlight][S];
      bool live[Sh::kInFlight][S];
#pragma unroll
      for (int k = 0; k < Sh::kInFlight; ++k) {
        const int i = seg + k * Sh::kSegs;
        const int64_t span = span_s[i];
        const int64_t n = r0 + i < n_rows ? (span < chunk ? span : chunk) : 0;
        const I lo = static_cast<I>(lo_s[i]);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          live[k][s] = lane + L * s < n;
          v[k][s] = 0;
          if (live[k][s]) {
            const I x = lo + static_cast<I>(lane + L * s);
            v[k][s] = q[x < last ? x : last];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < Sh::kInFlight; ++k) {
        const int i = seg + k * Sh::kSegs;
        const T thr = thr_s[i];
        int c = 0;
#pragma unroll
        for (int s = 0; s < S; ++s)
          c += __popc(__ballot_sync(0xffffffffu,
                                    live[k][s] && v[k][s] <= thr) &
                      seg_mask);
        if (lane == 0) counts[i] = static_cast<T>(c);
      }
    } else if constexpr (L == 32 && S == 1) {
      // chunk > 32: the warp walks each of its rows in kLongSteps 32-slot
      // steps at a time (n is uniform in the warp).
      for (int k = 0; k < Sh::kInFlight; ++k) {
        const int i = seg + k * Sh::kSegs;
        const int64_t span = span_s[i];
        const int64_t n = r0 + i < n_rows ? (span < chunk ? span : chunk) : 0;
        const I lo = static_cast<I>(lo_s[i]);
        const T thr = thr_s[i];
        long long c = 0;
        for (int64_t j0 = 0; j0 < n; j0 += 32 * kLongSteps) {
          T v[kLongSteps];
          bool ok[kLongSteps];
#pragma unroll
          for (int s = 0; s < kLongSteps; ++s) {
            const int64_t j = j0 + 32 * s + lane;
            ok[s] = j < n;
            v[s] = 0;
            if (ok[s]) {
              const I x = lo + static_cast<I>(j);
              v[s] = q[x < last ? x : last];
            }
          }
#pragma unroll
          for (int s = 0; s < kLongSteps; ++s) c += ok[s] && v[s] <= thr;
        }
        c = warp_sum(c);
        if (lane == 0) counts[i] = static_cast<T>(c);
      }
    }
    __syncthreads();  // counts complete; buf[b] free for tile t + 2 grid
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      if (r0 + i < n_rows) out[r0 + i] = counts[i];
  }
}

template <typename T>
using KernelFn = void (*)(const T*, int64_t, const T*, int64_t, int64_t, T*);

// The kernel for (lanes, steps) and its dynamic shared memory
// (plan.smem_bytes); null for a pair the plan never picks.
template <typename T>
KernelFn<T> kernel_for(int lanes, int steps, size_t* smem) {
  switch (lanes * 64 + steps) {
#define REPRO_WINDOW_SHAPE(L, S)                \
  case L * 64 + S:                              \
    *smem = 7 * Shape<L, S>::kTile * sizeof(T); \
    return window_count_kernel<T, L, S>;
    REPRO_WINDOW_SHAPE(1, 1)
    REPRO_WINDOW_SHAPE(2, 1)
    REPRO_WINDOW_SHAPE(4, 1)
    REPRO_WINDOW_SHAPE(4, 2)
    REPRO_WINDOW_SHAPE(4, 4)
    REPRO_WINDOW_SHAPE(4, 8)
    REPRO_WINDOW_SHAPE(32, 1)
    REPRO_WINDOW_SHAPE(32, 2)
    REPRO_WINDOW_SHAPE(32, 4)
    REPRO_WINDOW_SHAPE(32, 8)
#undef REPRO_WINDOW_SHAPE
    default:
      return nullptr;
  }
}

template <typename T>
cudaError_t launch_type(const void* q, int64_t m, const void* rows,
                        int64_t n_rows, int64_t chunk, void* out, int lanes,
                        int steps, int grid, cudaStream_t s) {
  size_t smem = 0;
  const KernelFn<T> kern = kernel_for<T>(lanes, steps, &smem);
  if (kern == nullptr) return cudaErrorInvalidValue;
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), m,
                                    static_cast<const T*>(rows), n_rows,
                                    chunk, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy_type(int lanes, int steps, int* blocks) {
  size_t smem = 0;
  const KernelFn<T> kern = kernel_for<T>(lanes, steps, &smem);
  if (kern == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads,
                                                       smem);
}

}  // namespace

// rows: [3, n_rows] (lo, thr, span) of the same type as q; elem_bytes is 4
// (int32) or 8 (int64); lanes, steps and grid from plan.window_plan (lanes x
// steps must cover chunk, but for the full-warp walk: 32 lanes, 1 step).
REPRO_EXPORT int window_count_launch(const void* q, int64_t m,
                                     const void* rows, int64_t n_rows,
                                     int64_t chunk, void* out, int elem_bytes,
                                     int lanes, int steps, int grid,
                                     void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0 || grid <= 0 || chunk < 0 ||
      (!(lanes == 32 && steps == 1) &&
       chunk > static_cast<int64_t>(lanes) * steps) ||
      (elem_bytes != 4 && elem_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      elem_bytes == 4
          ? launch_type<int32_t>(q, m, rows, n_rows, chunk, out, lanes, steps,
                                 grid, s)
          : launch_type<int64_t>(q, m, rows, n_rows, chunk, out, lanes, steps,
                                 grid, s);
  return static_cast<int>(err);
}

// Blocks of the kernel for (elem_bytes, lanes, steps) that fit on one SM
// at once (registers and shared memory), for the plan's persistent grid.
REPRO_EXPORT int window_count_occupancy(int elem_bytes, int lanes, int steps,
                                        int* blocks) {
  if (elem_bytes != 4 && elem_bytes != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = elem_bytes == 4
                              ? occupancy_type<int32_t>(lanes, steps, blocks)
                              : occupancy_type<int64_t>(lanes, steps, blocks);
  return static_cast<int>(err);
}
