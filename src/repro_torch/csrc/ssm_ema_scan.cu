// Gated EMA scan h_t = dt_t * h_{t-1} + x_t, y_t = g_t * h_t on Hopper.
//
// Replaces the Pallas kernel ssm_ema_scan (_ema_kernel) of
// src/repro/kernels/ssm_scan/kernel.py (pallas_call at :59).  Its grid
// walks the time chunks in order, carrying a [1, D] f32 state in VMEM
// scratch, and evaluates each chunk in closed form (cumprod of dt, cumsum
// of x over it).  Hopper blocks run in no order, so here the chunk axis is
// a loop inside the thread and the channels are the parallel axis: one
// thread per channel, adjacent threads on adjacent channels, so every load
// and store of a time step is coalesced across the warp.
//
// The recurrence is evaluated directly, not in closed form: f32, rounded
// op by op (__fmul_rn, __fadd_rn) in the order of the plain version, so in
// f32 the result is bit-identical to it, and no division by a running
// decay product can lose precision when dt is small.
//
// Bound on the card: bytes (x, dt and g read once, y written once).  Each
// thread issues the loads of kUnroll steps before the dependent chain
// consumes them, so that many loads per thread are in flight at once.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kUnroll = 16;   // time steps loaded ahead of the chain

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_ema_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const T* __restrict__ g, T* __restrict__ y, int n_steps,
               int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= n_steps; t += kUnroll) {
    float xs[kUnroll], ds[kUnroll], gs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = static_cast<int64_t>(t + u) * D + d;
      xs[u] = to_f32(x[off]);
      ds[u] = to_f32(dt[off]);
      gs[u] = to_f32(g[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(ds[u], h), xs[u]);
      y[static_cast<int64_t>(t + u) * D + d] = from_f32<T>(__fmul_rn(gs[u], h));
    }
  }
  for (; t < n_steps; ++t) {
    const int64_t off = static_cast<int64_t>(t) * D + d;
    h = __fadd_rn(__fmul_rn(to_f32(dt[off]), h), to_f32(x[off]));
    y[off] = from_f32<T>(__fmul_rn(to_f32(g[off]), h));
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* g, void* y, int n_steps,
           int D, cudaStream_t stream) {
  ssm_ema_kernel<T><<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(g), static_cast<T*>(y), n_steps, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Contract (checked by the Python wrapper): contiguous x, dt, g, y [T, D].
REPRO_EXPORT int ssm_ema_launch(int dtype, const void* x, const void* dt,
                                const void* g, void* y, int n_steps, int D,
                                void* stream) {
  if (n_steps == 0 || D == 0) return static_cast<int>(cudaSuccess);
  if (n_steps < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32) return launch<float>(x, dt, g, y, n_steps, D, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, dt, g, y, n_steps, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
