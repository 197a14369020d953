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
// HBM bytes, each row's window of q read once plus its (lo, thr, span) and
// its count; there is no arithmetic to speak of.  One warp walks one row in
// coalesced 32-slot steps, four steps loaded before their __ballot_sync +
// __popc, and a grid-stride loop covers the rows.  q, the rows and the
// counts share one integer type: int32 while m < 2^31, else int64 (the
// host's qdt).
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
window_count_kernel(const T* __restrict__ q, int64_t m,
                    const T* __restrict__ rows, int64_t n_rows, int64_t chunk,
                    T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps_per_block;
  for (int64_t r = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
       r < n_rows; r += stride) {
    const int64_t lo = rows[r];
    const T thr = rows[n_rows + r];
    const int64_t span = rows[2 * n_rows + r];
    const int64_t n = span < chunk ? span : chunk;  // j < span, j < chunk
    int64_t count = 0;
    for (int64_t j0 = 0; j0 < n; j0 += 128) {       // uniform in the warp
      bool hit[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t j = j0 + 32 * k + lane;
        hit[k] = false;
        if (j < n) {
          const int64_t i = lo + j < m - 1 ? lo + j : m - 1;
          hit[k] = q[i] <= thr;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        count += __popc(__ballot_sync(0xffffffffu, hit[k]));
    }
    if (lane == 0) out[r] = static_cast<T>(count);
  }
}

// rows: [3, n_rows] (lo, thr, span) of the same type as q; elem_bytes is 4
// (int32) or 8 (int64); grid is the number of blocks (8 rows each at once).
REPRO_EXPORT int window_count_launch(const void* q, int64_t m,
                                     const void* rows, int64_t n_rows,
                                     int64_t chunk, void* out, int elem_bytes,
                                     int grid, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0 || grid <= 0 || (elem_bytes != 4 && elem_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    window_count_kernel<int32_t><<<grid, 256, 0, s>>>(
        static_cast<const int32_t*>(q), m, static_cast<const int32_t*>(rows),
        n_rows, chunk, static_cast<int32_t*>(out));
  else
    window_count_kernel<int64_t><<<grid, 256, 0, s>>>(
        static_cast<const int64_t*>(q), m, static_cast<const int64_t*>(rows),
        n_rows, chunk, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
