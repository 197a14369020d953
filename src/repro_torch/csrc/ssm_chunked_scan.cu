// State-expanded selective scan (Mamba-2 form) on Hopper:
//   h_t = dt_t * h_{t-1} + b_t (outer) x_t   ([N, D] state),
//   y_t = c_t . h_t.
//
// Replaces the Pallas kernel ssm_chunked_scan (_chunked_kernel) of
// src/repro/kernels/ssm_scan/kernel.py (pallas_call at :112).  Its grid
// walks the time chunks in order with the [N, D] f32 state in VMEM
// scratch, and evaluates each chunk in closed form as two chunk-local
// matmuls (y = P (tril(C B^T)(x / P) + C h), h' = P[-1] (h + B^T (x / P))).
// Hopper blocks run in no order, so here the chunk axis is a loop inside
// the block and the channels are the parallel axis: one block per tile of
// kThreads / (N / kRowsPerThread) channels, its [N, tile] f32 state held in
// registers for the whole sequence, kRowsPerThread state rows per thread
// and N / kRowsPerThread neighbouring lanes per channel (their partial
// y_t sums meet by warp shuffles).  Each stage of kStage time steps of x,
// dt, b and c is staged through shared memory with coalesced loads, and y
// leaves through shared memory the same way.
//
// The recurrence is evaluated directly, not in closed form, in f32: the
// state update is rounded op by op as the plain version rounds it, so the
// state is bit-identical to the plain version's in f32, and no division
// by a running decay product can lose precision when dt is small.  Only
// y_t's sum over N is taken in another order than the plain version's.
//
// Bound on the card: operations.  The direct recurrence needs 5*N*D*T
// (update: two products and a sum; output: a product and a sum per state
// element), fewer than the closed form's chunk matmuls; they are CUDA-core
// f32 work.  The bytes (x, dt, y of [T, D]; b, c of [T, N]) take less time
// at full width (Zamba2-7B: T = 4096, D = 7168, N = 64).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;  // state rows of one channel per thread
constexpr int kStage = 64;          // time steps per shared-memory stage

__host__ __device__ inline int channels_per_block(int N) {
  return kThreads / (N / kRowsPerThread);
}

__host__ inline size_t smem_bytes(int N) {
  const size_t ch = static_cast<size_t>(channels_per_block(N));
  return (2 * static_cast<size_t>(kStage) * N + 3 * kStage * ch) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_chunked_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const T* __restrict__ b, const T* __restrict__ c,
                   T* __restrict__ y, int n_steps, int D, int N) {
  extern __shared__ __align__(16) float smem[];
  const int split = N / kRowsPerThread;  // lanes per channel
  const int CH = kThreads / split;       // channels per block
  float* sB = smem;                      // [kStage][N]
  float* sC = sB + kStage * N;           // [kStage][N]
  float* sX = sC + kStage * N;           // [kStage][CH]
  float* sDt = sX + kStage * CH;         // [kStage][CH]
  float* sY = sDt + kStage * CH;         // [kStage][CH]
  const int tid = threadIdx.x;
  const int ch = tid / split, part = tid % split;
  const int d0 = blockIdx.x * CH;
  const int n0 = part * kRowsPerThread;

  float h[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) h[j] = 0.f;

  for (int t0 = 0; t0 < n_steps; t0 += kStage) {
    const int steps = min(kStage, n_steps - t0);
    for (int i = tid; i < steps * N; i += kThreads) {
      const int64_t off = static_cast<int64_t>(t0) * N + i;
      sB[i] = to_f32(b[off]);
      sC[i] = to_f32(c[off]);
    }
    for (int i = tid; i < steps * CH; i += kThreads) {
      const int s = i / CH, d = d0 + i % CH;
      const int64_t off = static_cast<int64_t>(t0 + s) * D + d;
      sX[i] = d < D ? to_f32(x[off]) : 0.f;
      sDt[i] = d < D ? to_f32(dt[off]) : 0.f;
    }
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const float xv = sX[s * CH + ch];
      const float dv = sDt[s * CH + ch];
      const float* bs = sB + s * N + n0;
      const float* cs = sC + s * N + n0;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        h[j] = __fadd_rn(__fmul_rn(dv, h[j]), __fmul_rn(bs[j], xv));
        acc = fmaf(cs[j], h[j], acc);
      }
      for (int off = 1; off < split; off *= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0) sY[s * CH + ch] = acc;
    }
    __syncthreads();

    for (int i = tid; i < steps * CH; i += kThreads) {
      const int s = i / CH, d = d0 + i % CH;
      if (d < D) y[static_cast<int64_t>(t0 + s) * D + d] = from_f32<T>(sY[i]);
    }
    // The next stage's loads write sB..sDt only; sY is rewritten after the
    // barrier that follows them, which every thread reaches after this loop.
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* b, const void* c,
           void* y, int n_steps, int D, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  auto* kern = ssm_chunked_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ch = channels_per_block(N);
  kern<<<(D + ch - 1) / ch, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      n_steps, D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Contract (checked by the Python wrapper): contiguous x, dt, y [T, D] and
// b, c [T, N], with N in {16, 32, 64, 128, 256}.
REPRO_EXPORT int ssm_chunked_launch(int dtype, const void* x, const void* dt,
                                    const void* b, const void* c, void* y,
                                    int n_steps, int D, int N, void* stream) {
  if (N < kRowsPerThread || N > 16 * kRowsPerThread || N % kRowsPerThread ||
      ((N / kRowsPerThread) & (N / kRowsPerThread - 1)) || n_steps < 0 ||
      D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps == 0 || D == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(x, dt, b, c, y, n_steps, D, N, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, dt, b, c, y, n_steps, D, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
