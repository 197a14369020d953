// State-expanded selective scan (Mamba-2 form) on Hopper:
//   h_t = dt_t * h_{t-1} + b_t (outer) x_t   ([N, D] state),
//   y_t = c_t . h_t.
//
// Replaces the Pallas kernel ssm_chunked_scan (_chunked_kernel) of
// src/repro/kernels/ssm_scan/kernel.py (pallas_call at :112).  Its grid
// walks the time chunks in order with the [N, D] f32 state in VMEM
// scratch, and evaluates each chunk in closed form as two chunk-local
// matmuls (y = P (tril(C B^T)(x / P) + C h), h' = P[-1] (h + B^T (x / P))).
// Hopper blocks run in no order, so here the time axis is a loop inside
// the block and the channels are the parallel axis.
//
// The recurrence is evaluated directly, not in closed form, in f32: the
// state update is rounded op by op as the plain version rounds it
// (__fmul_rn, __fmul_rn, __fadd_rn; no contraction), so the state is
// bit-identical to the plain version's, and no division by a running decay
// product can lose precision when dt is small.  Only y_t's sum over N is
// taken in another order than the plain version's.
//
// Bound on the card: operations.  The direct recurrence needs 5*N*D*T
// (update: two products and a sum; output: a product and a sum per state
// element), fewer than the closed form's chunk matmuls; they are CUDA-core
// f32 work, issued as 4 instructions per state element per step (the
// output's product and sum fuse, the update's may not).  The bytes (x, dt,
// y of [T, D]; b, c of [T, N]) take less time at full width (Zamba2-7B:
// T = 4096, D = 7168, N = 64).
//
// Design.  A thread holds R state rows (a template: 4, 8 or 16) of one
// channel in registers for the whole sequence; thread tid of a block is row
// group g = tid / CH of channel ch = tid % CH, so the lanes of a warp share
// one row group whenever CH >= 32, and their reads of b_t and c_t are one
// broadcast 128-bit load each per 4 rows.  plan.py picks R and CH (the
// channels a block holds, a power of two): the most rows that still give
// each of the card's schedulers a warp, and blocks that fill the card or
// hold 4 warps.
// x, dt, b and c come in stages of S time steps through a 3-stage ring of
// 16-byte cp.async copies (x and dt as a window of at least 16 bytes of
// channels around the block's), so the next two stages load while one is
// computed, with one block barrier per stage.  A step's y partial over the
// thread's R rows is four independent sums, added pairwise, and goes to
// shared memory; after the next barrier the block adds the row groups'
// partials of a whole stage (four running sums over the groups, added
// pairwise) and writes y.  No warp shuffle is on the per-step path.
#include "common.cuh"

namespace {

constexpr int kRing = 3;          // cp.async ring depth (stages)
constexpr int kMaxThreads = 256;  // threads a block may have (plan.py)

__host__ __device__ inline int window(int CH, int elem_bytes) {
  return CH * elem_bytes >= 16 ? CH : 16 / elem_bytes;
}

// Floats between two steps' rows of y partials: the block's CH * G partials
// and a pad of 4, so that the reduction's lanes, which read several steps
// of a few channels at once, fall in distinct banks.
__host__ __device__ inline int partial_stride(int CH, int G) {
  return CH * G + 4;
}

// Shared memory of one block: the ring, then two stages of y partials.
__host__ inline size_t smem_bytes(int N, int CH, int R, int S,
                                  int elem_bytes) {
  const int W = window(CH, elem_bytes);
  return kRing * static_cast<size_t>(S) * (2 * N + 2 * W) * elem_bytes +
         2 * static_cast<size_t>(S) * partial_stride(CH, N / R) *
             sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R consecutive elements of shared memory as floats, in 16-byte loads (or
// one 8-byte load: 4 bf16).
template <int R>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[R]) {
#pragma unroll
  for (int j = 0; j < R; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    out[j] = v.x, out[j + 1] = v.y, out[j + 2] = v.z, out[j + 3] = v.w;
  }
}
__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
template <int R>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[R]) {
  if constexpr (R == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = bf2(v.x), hi = bf2(v.y);
    out[0] = lo.x, out[1] = lo.y, out[2] = hi.x, out[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < R; j += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + j);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = bf2(w[e]);
        out[j + 2 * e] = f.x, out[j + 2 * e + 1] = f.y;
      }
    }
  }
}

// grid (D / CH), CH * (N / R) threads; S time steps a stage.  Thread tid is
// row group g = tid / CH (state rows g*R..g*R+R-1) of channel tid % CH.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads)
ssm_chunked_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const T* __restrict__ b, const T* __restrict__ c,
                   T* __restrict__ y, int n_steps, int D, int N, int CH,
                   int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a copy
  const int W = window(CH, sizeof(T));
  const int G = N / R;                // row groups
  const int n_thr = CH * G;
  const int P = partial_stride(CH, G);
  const int stage_elems = S * (2 * N + 2 * W);
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sP = reinterpret_cast<float*>(ring + kRing * stage_elems);

  const int tid = threadIdx.x;
  const int ch = tid % CH;
  const int d0 = blockIdx.x * CH;
  const int base = d0 - d0 % W;       // first channel of the staged window
  const int xo = d0 - base + ch;      // this thread's channel in the window
  const int n0 = (tid / CH) * R;
  const int n_stages = (n_steps + S - 1) / S;

  auto stage_ptr = [&](int st) { return ring + (st % kRing) * stage_elems; };
  auto load_stage = [&](int st) {
    const int t0 = st * S;
    const int steps = min(S, n_steps - t0);
    T* sB = stage_ptr(st);
    T* sC = sB + S * N;
    T* sX = sC + S * N;
    T* sDt = sX + S * W;
    const int bc_chunks = steps * N / kVec;   // b, c rows are contiguous
    const int64_t bc0 = static_cast<int64_t>(t0) * N;
#pragma unroll 1
    for (int e = tid; e < bc_chunks; e += n_thr) {
      cp_async16(sB + e * kVec, b + bc0 + e * kVec);
      cp_async16(sC + e * kVec, c + bc0 + e * kVec);
    }
    const int per_row = W / kVec;
#pragma unroll 1
    for (int e = tid; e < steps * per_row; e += n_thr) {
      const int r = e / per_row, k = (e % per_row) * kVec;
      const int64_t off = static_cast<int64_t>(t0 + r) * D + base + k;
      cp_async16(sX + r * W + k, x + off);
      cp_async16(sDt + r * W + k, dt + off);
    }
  };
  // Row groups' partials of stage st to y: group g's part of channel k at
  // step s is part[s * P + g * CH + k].  Thread tid adds channel tid % CH at
  // steps tid / CH, + G, ...; over g, four running sums (g mod 4), added
  // pairwise.
  auto reduce = [&](int st) {
    const int t0 = st * S;
    const int steps = min(S, n_steps - t0);
    const float* part = sP + (st & 1) * S * P + ch;
    T* yp = y + static_cast<int64_t>(t0) * D + d0 + ch;
#pragma unroll 1
    for (int s = tid / CH; s < steps; s += G) {
      const float* col = part + s * P;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      if (G < 4) {  // G is a power of two
        a0 = col[0];
        if (G == 2) a1 = col[CH];
      } else {
#pragma unroll 1
        for (int gg = 0; gg < G; gg += 4) {
          a0 += col[gg * CH];
          a1 += col[(gg + 1) * CH];
          a2 += col[(gg + 2) * CH];
          a3 += col[(gg + 3) * CH];
        }
      }
      yp[static_cast<int64_t>(s) * D] = from_f32<T>((a0 + a1) + (a2 + a3));
    }
  };

#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) {
    if (st < n_stages) load_stage(st);
    cp_async_commit();
  }

  float h[R];
#pragma unroll
  for (int j = 0; j < R; ++j) h[j] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kRing - 2>();  // stage st has landed (this thread's part)
    __syncthreads();             // ... everyone's; st-1's partials written
    if (st + kRing - 1 < n_stages) load_stage(st + kRing - 1);
    cp_async_commit();
    if (st > 0) reduce(st - 1);

    const T* bp = stage_ptr(st) + n0;
    const T* cp = bp + S * N;
    const T* xp = stage_ptr(st) + 2 * S * N + xo;
    const T* dp = xp + S * W;
    float* pp = sP + (st & 1) * S * P + tid;
    const int steps = min(S, n_steps - st * S);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float xv = to_f32(*xp), dv = to_f32(*dp);
      float bv[R], cv[R];
      load_vec<R>(bp, bv);
      load_vec<R>(cp, cv);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < R; ++j) {
        h[j] = __fadd_rn(__fmul_rn(dv, h[j]), __fmul_rn(bv[j], xv));
        acc[j & 3] = fmaf(cv[j], h[j], acc[j & 3]);
      }
      *pp = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      bp += N, cp += N, xp += W, dp += W, pp += P;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (n_stages > 0) reduce(n_stages - 1);
}

template <typename T, int R>
int launch(const void* x, const void* dt, const void* b, const void* c,
           void* y, int n_steps, int D, int N, int CH, int S,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(N, CH, R, S, sizeof(T));
  auto* kern = ssm_chunked_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<D / CH, CH * (N / R), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      n_steps, D, N, CH, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_r(int R, const void* x, const void* dt, const void* b,
             const void* c, void* y, int n_steps, int D, int N, int CH, int S,
             cudaStream_t stream) {
  switch (R) {
    case 4: return launch<T, 4>(x, dt, b, c, y, n_steps, D, N, CH, S, stream);
    case 8: return launch<T, 8>(x, dt, b, c, y, n_steps, D, N, CH, S, stream);
    case 16: return launch<T, 16>(x, dt, b, c, y, n_steps, D, N, CH, S, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Contract (checked by the Python wrapper): contiguous, 16-byte aligned x,
// dt, y [T, D] and b, c [T, N]; N in {16, 32, 64, 128, 256}, D % 128 == 0;
// the plan from plan.py: R state rows a thread (4, 8 or 16), CH channels a
// block (a power of two dividing D, CH * N / R <= 256 threads), S steps a
// stage.
REPRO_EXPORT int ssm_chunked_launch(int dtype, const void* x, const void* dt,
                                    const void* b, const void* c, void* y,
                                    int n_steps, int D, int N, int R, int CH,
                                    int S, void* stream) {
  const int elem = dtype == REPRO_BF16 ? 2 : 4;
  if ((R != 4 && R != 8 && R != 16) || n_steps < 0 || D < 0 || N < 16 ||
      N > 256 || (N & (N - 1)) || CH < 1 || (CH & (CH - 1)) ||
      (D > 0 && D % CH) || CH * (N / R) > kMaxThreads || S < 1 ||
      D % (16 / elem) || smem_bytes(N, CH, R, S, elem) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps == 0 || D == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_r<float>(R, x, dt, b, c, y, n_steps, D, N, CH, S, s);
  if (dtype == REPRO_BF16)
    return launch_r<__nv_bfloat16>(R, x, dt, b, c, y, n_steps, D, N, CH, S,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
