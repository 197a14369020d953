// MoE dispatch (row gather, per-expert GEMM, row scatter) on Hopper.
//
// Replaces the Pallas kernel moe_dispatch_sorted of
// src/repro/kernels/moe_dispatch/kernel.py (pallas_call at :60).  Its grid
// walks the expert-sorted token stream one token a step, with the token
// order and the expert ids scalar-prefetched: x[tok[i]] is gathered,
// w[eid[i]] stays resident in VMEM across each run of one expert
// (revisiting), and y[tok[i]] = x[tok[i]] @ w[eid[i]] is scattered back.
//
// Here the sorted stream is cut into tiles of kRows consecutive rows, and
// block (r, c) takes tile r and the F columns [c*kCols, (c+1)*kCols).  The
// block loads its own slice of tok and eid and splits the tile where the
// expert changes.  For each run of one expert it streams that expert's
// [D, kCols] weight slab through shared memory once, kK rows of D at a
// time, against the run's gathered x rows (also staged kK columns at a
// time): a grouped GEMM whose weight traffic is one slab per (tile,
// expert), the Hopper form of the revisiting.  The sum is kept in f32
// registers, a 4x4 tile per thread, and rounded once to the output type.
//
// Bound on the card: at a routed layer's width (DeepSeek-MoE-16B: 24576
// routed rows, D = 2048, F = 1408, 64 experts) the GEMM's 2*T*D*F
// operations over the CUDA cores' f32 rate in f32, and the bytes of x, w
// and y in bf16.  This first version runs on the CUDA cores; wgmma on the
// tensor cores is a later version.  A token outside [0, T) or an expert
// id outside [0, E) traps, so the launch fails; so does a token order that
// is not a permutation of [0, T) (a pre-pass counts each token in a zeroed
// buffer), which would leave rows of y unwritten and race on others.
#include "common.cuh"

namespace {

constexpr int kRows = 64;     // sorted rows per tile
constexpr int kCols = 64;     // output columns per tile
constexpr int kK = 32;        // rows of D per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// Traps unless tok is a permutation of [0, n_tokens): seen starts zeroed
// and every token must be counted exactly once.
__global__ void check_permutation(const int* __restrict__ tok,
                                  int* __restrict__ seen, int n_tokens) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tokens) return;
  const int t = tok[i];
  if (t < 0 || t >= n_tokens || atomicAdd(&seen[t], 1) != 0) __trap();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ tok, const int* __restrict__ eid,
                    T* __restrict__ y, int n_tokens, int D, int F,
                    int n_experts) {
  __shared__ int sTok[kRows];
  __shared__ int sEid[kRows];
  __shared__ float sX[kK][kRows + 1];  // gathered x rows, k-major (+1: banks)
  __shared__ float sW[kK][kCols];      // one stage of the weight slab
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int rows = min(kRows, n_tokens - row0);
  if (tid < rows) {
    const int t = tok[row0 + tid];
    const int e = eid[row0 + tid];
    if (t < 0 || t >= n_tokens || e < 0 || e >= n_experts) __trap();
    sTok[tid] = t;
    sEid[tid] = e;
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;  // columns tx*4.., rows ty*4..
  for (int start = 0; start < rows;) {
    const int e = sEid[start];
    int end = start + 1;
    while (end < rows && sEid[end] == e) ++end;
    const int m = end - start;  // rows of this run in the tile
    const T* we = w + static_cast<int64_t>(e) * D * F + col0;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += kK) {
      for (int i = tid; i < kRows * kK; i += kThreads) {
        const int r = i / kK, k = i % kK;
        sX[k][r] = r < m ? to_f32(x[static_cast<int64_t>(sTok[start + r]) * D +
                                    k0 + k])
                         : 0.f;
      }
      for (int i = tid; i < kK * kCols; i += kThreads) {
        const int k = i / kCols, c = i % kCols;
        sW[k][c] = to_f32(we[static_cast<int64_t>(k0 + k) * F + c]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sX[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sW[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // the stage buffers are refilled next
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < m) {
        T* dst = y + static_cast<int64_t>(sTok[start + r]) * F + col0 + tx * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[j] = from_f32<T>(acc[i][j]);
      }
    }
    start = end;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* tok, const void* eid,
           void* seen, void* y, int n_tokens, int D, int F, int n_experts,
           cudaStream_t stream) {
  check_permutation<<<(n_tokens + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(static_cast<const int*>(tok),
                                static_cast<int*>(seen), n_tokens);
  const dim3 grid((n_tokens + kRows - 1) / kRows, F / kCols);
  moe_dispatch_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(tok), static_cast<const int*>(eid),
      static_cast<T*>(y), n_tokens, D, F, n_experts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Contract (checked by the Python wrapper): contiguous x [T, D], w [E, D,
// F], int32 tok and eid [T], a zeroed int32 scratch seen [T], y [T, F];
// D % 32 == 0 and F % 64 == 0.  That tok is a permutation of [0, T) is
// checked here, on the card, by check_permutation.
REPRO_EXPORT int moe_dispatch_launch(int dtype, const void* x, const void* w,
                                     const void* tok, const void* eid,
                                     void* seen, void* y, int n_tokens, int D,
                                     int F, int n_experts, void* stream) {
  if (n_tokens == 0) return static_cast<int>(cudaSuccess);
  if (n_tokens < 0 || D < kK || D % kK || F < kCols || F % kCols ||
      F / kCols > 65535 || n_experts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(x, w, tok, eid, seen, y, n_tokens, D, F, n_experts,
                         s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, w, tok, eid, seen, y, n_tokens, D, F,
                                 n_experts, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
