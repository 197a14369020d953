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
//
// Every D >= 1 and N >= 1 (plan.py).  The grid is ceil(D / CH) channel
// tiles; the threads of the last tile's channels past D compute from
// whatever the window holds and store nothing.  The state's N rows come in
// `parts` of at most 256 (grid y), a part's rows padded in shared memory
// to NP, the next of 16 ... 256, with zero rows of b and c, which add
// nothing to y (the ring is zeroed once where NP exceeds the part's rows).
// h[n, :] depends on b[:, n] alone, so the parts are independent: with
// more than one, each block writes its part of y in f32 to a scratch
// [parts, T, D], and ssm_chunked_combine adds the parts in part order, so
// a rerun is bit-identical.  The copies are 16-byte cp.async where a row's
// bytes allow it, else 8- or 4-byte cp.async, else (bf16 or f16 rows of
// odd length) plain loads (plan.py's copy_piece).  f32, bf16 and f16
// (each kernel instanced on its element type; the 2-byte types share the
// plans, plan.py's itemsize): every value is read as f32, the state and
// sums stay f32, and y is rounded once.
#include <algorithm>

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

// Shared memory of one block: the ring, then two stages of y partials (NP
// padded state rows).
__host__ inline size_t smem_bytes(int NP, int CH, int R, int S,
                                  int elem_bytes) {
  const int W = window(CH, elem_bytes);
  return kRing * static_cast<size_t>(S) * (2 * NP + 2 * W) * elem_bytes +
         2 * static_cast<size_t>(S) * partial_stride(CH, NP / R) *
             sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// One copy of `piece` bytes into shared memory: cp.async for 16, 8 and 4,
// a plain load and store for 2.
template <typename T>
__device__ __forceinline__ void copy_piece(T* smem, const T* gmem, int piece) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (piece == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else if (piece == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else if (piece == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else
    *smem = *gmem;
}

// `rows` rows of `cols` elements (a multiple of the piece's) from src (row
// stride src_stride) to dst (row stride dst_stride), pieces dealt to the
// block's threads in turn.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_stride,
                                          const T* src, int64_t src_stride,
                                          int rows, int cols, int piece,
                                          int tid, int n_thr) {
  const int vec = piece / static_cast<int>(sizeof(T));
  const int per_row = cols / vec;
  if (rows == 1) {
#pragma unroll 1
    for (int e = tid; e < per_row; e += n_thr)
      copy_piece(dst + e * vec, src + e * vec, piece);
    return;
  }
#pragma unroll 1
  for (int e = tid; e < rows * per_row; e += n_thr) {
    const int r = e / per_row, k = (e % per_row) * vec;
    copy_piece(dst + r * dst_stride + k, src + r * src_stride + k, piece);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R consecutive elements of shared memory as floats, in 16-byte loads (or
// one 8-byte load: 4 bf16 or f16).
template <int R>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[R]) {
#pragma unroll
  for (int j = 0; j < R; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    out[j] = v.x, out[j + 1] = v.y, out[j + 2] = v.z, out[j + 3] = v.w;
  }
}
// Two 2-byte elements of one 32-bit word as floats.
__device__ __forceinline__ float2 pair2(uint32_t w, const __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 pair2(uint32_t w, const __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
template <int R, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[R]) {
  static_assert(sizeof(T) == 2, "bf16 or f16");
  if constexpr (R == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = pair2(v.x, p), hi = pair2(v.y, p);
    out[0] = lo.x, out[1] = lo.y, out[2] = hi.x, out[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < R; j += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + j);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = pair2(w[e], p);
        out[j + 2 * e] = f.x, out[j + 2 * e + 1] = f.y;
      }
    }
  }
}

// The shapes of the reference's kernel route (one part of N in {16, ...,
// 256} rows, CH dividing D, 16-byte rows) have a kernel of their own,
// with none of the general case's tests and copies: in one kernel those
// cost these shapes 1.5-17% (PERF.md).
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

// The general case: grid (ceil(D / CH), parts), CH * (NP / R) threads; S
// time steps a stage.  Thread tid is row group g = tid / CH (padded state
// rows g*R..g*R+R-1 of part blockIdx.y, which holds rows blockIdx.y * per
// .. of N) of channel tid % CH.  With one part y is written directly, else
// this part's y in f32 to part_y + blockIdx.y * T * D.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads)
ssm_chunked_general(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ b, const T* __restrict__ c,
                    T* __restrict__ y, float* __restrict__ part_y,
                    int n_steps, int D, int N, int NP, int per, int CH, int S,
                    int x_piece, int bc_piece) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = window(CH, sizeof(T));
  const int G = NP / R;               // row groups
  const int n_thr = CH * G;
  const int P = partial_stride(CH, G);
  const int stage_elems = S * (2 * NP + 2 * W);
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sP = reinterpret_cast<float*>(ring + kRing * stage_elems);

  const int tid = threadIdx.x;
  const int ch = tid % CH;
  const int d0 = blockIdx.x * CH;
  const int base = d0 - d0 % W;       // first channel of the staged window
  const int x_cols = min(W, D - base);
  const int xo = d0 - base + ch;      // this thread's channel in the window
  const bool stores = d0 + ch < D;
  const int n_begin = blockIdx.y * per;
  const int n_rows = min(per, N - n_begin);
  const bool bc_whole = n_rows == NP && NP == N;  // rows contiguous both sides
  const int n0 = (tid / CH) * R;
  const int n_stages = (n_steps + S - 1) / S;

  if (n_rows < NP) {  // padded rows of b and c stay zero
#pragma unroll 1
    for (int e = tid; e < kRing * stage_elems; e += n_thr)
      ring[e] = from_f32<T>(0.f);
    __syncthreads();
  }

  auto stage_ptr = [&](int st) { return ring + (st % kRing) * stage_elems; };
  auto load_stage = [&](int st) {
    const int t0 = st * S;
    const int steps = min(S, n_steps - t0);
    T* sB = stage_ptr(st);
    T* sC = sB + S * NP;
    T* sX = sC + S * NP;
    T* sDt = sX + S * W;
    const int64_t bc0 = static_cast<int64_t>(t0) * N + n_begin;
    if (bc_whole) {  // one contiguous run of steps * N elements
      copy_rows(sB, 0, b + bc0, 0, 1, steps * N, bc_piece, tid, n_thr);
      copy_rows(sC, 0, c + bc0, 0, 1, steps * N, bc_piece, tid, n_thr);
    } else {
      copy_rows(sB, NP, b + bc0, N, steps, n_rows, bc_piece, tid, n_thr);
      copy_rows(sC, NP, c + bc0, N, steps, n_rows, bc_piece, tid, n_thr);
    }
    const int64_t x0 = static_cast<int64_t>(t0) * D + base;
    copy_rows(sX, W, x + x0, D, steps, x_cols, x_piece, tid, n_thr);
    copy_rows(sDt, W, dt + x0, D, steps, x_cols, x_piece, tid, n_thr);
  };
  // As ssm_chunked_kernel's reduce, storing only channels below D, to y or
  // to this part's f32 scratch.
  auto reduce = [&](int st) {
    if (!stores) return;
    const int t0 = st * S;
    const int steps = min(S, n_steps - t0);
    const float* part = sP + (st & 1) * S * P + ch;
    const int64_t y0 = static_cast<int64_t>(t0) * D + d0 + ch;
    T* yp = y + y0;
    float* fp = part_y == nullptr
                    ? nullptr
                    : part_y + blockIdx.y * static_cast<int64_t>(n_steps) * D +
                          y0;
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
      const float sum = (a0 + a1) + (a2 + a3);
      if (fp == nullptr)
        yp[static_cast<int64_t>(s) * D] = from_f32<T>(sum);
      else
        fp[static_cast<int64_t>(s) * D] = sum;
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
    const T* cp = bp + S * NP;
    const T* xp = stage_ptr(st) + 2 * S * NP + xo;
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
      bp += NP, cp += NP, xp += W, dp += W, pp += P;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (n_stages > 0) reduce(n_stages - 1);
}

// y[i] = the parts' f32 partials of y[i] added in part order.
template <typename T>
__global__ void __launch_bounds__(256)
ssm_chunked_combine(const float* __restrict__ part_y, T* __restrict__ y,
                    int64_t n, int parts) {
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    float sum = part_y[i];
    for (int p = 1; p < parts; ++p) sum += part_y[p * n + i];
    y[i] = from_f32<T>(sum);
  }
}

struct Shape {
  int n_steps, D, N, NP, per, parts, CH, S, x_piece, bc_piece;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel* kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int R>
int launch(const void* x, const void* dt, const void* b, const void* c,
           void* y, float* part_y, const Shape& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.NP, p.CH, R, p.S, sizeof(T));
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  T* yt = static_cast<T*>(y);
  const bool general = p.parts > 1 || p.NP != p.N || p.D % p.CH ||
                       p.x_piece != 16 || p.bc_piece != 16;
  cudaError_t err;
  if (!general) {
    err = allow_smem(ssm_chunked_kernel<T, R>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssm_chunked_kernel<T, R><<<p.D / p.CH, p.CH * (p.N / R), smem, stream>>>(
        xt, dtt, bt, ct, yt, p.n_steps, p.D, p.N, p.CH, p.S);
    return static_cast<int>(cudaGetLastError());
  }
  err = allow_smem(ssm_chunked_general<T, R>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.D + p.CH - 1) / p.CH, p.parts);
  ssm_chunked_general<T, R><<<grid, p.CH * (p.NP / R), smem, stream>>>(
      xt, dtt, bt, ct, yt, p.parts > 1 ? part_y : nullptr, p.n_steps, p.D,
      p.N, p.NP, p.per, p.CH, p.S, p.x_piece, p.bc_piece);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.parts == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(p.n_steps) * p.D;
  const int blocks =
      static_cast<int>(std::min<int64_t>((n + 255) / 256, 4096));
  ssm_chunked_combine<T><<<blocks, 256, 0, stream>>>(part_y, yt, n, p.parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_r(int R, const void* x, const void* dt, const void* b,
             const void* c, void* y, float* part_y, const Shape& p,
             cudaStream_t stream) {
  switch (R) {
    case 4: return launch<T, 4>(x, dt, b, c, y, part_y, p, stream);
    case 8: return launch<T, 8>(x, dt, b, c, y, part_y, p, stream);
    case 16: return launch<T, 16>(x, dt, b, c, y, part_y, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid_piece(int piece, int elem, int64_t bytes) {
  return (piece == 16 || piece == 8 || piece == 4 || piece == elem) &&
         bytes % piece == 0;
}

}  // namespace

// Contract (checked by the Python wrapper): contiguous, 16-byte aligned x,
// dt, y [T, D] and b, c [T, N] of one dtype (a ReproDType: f32, bf16 or
// f16), D >= 1, N >= 1; the plan from plan.py: R
// state rows a thread (4, 8 or 16), CH channels a block (a power of two,
// CH * NP / R <= 256 threads), S steps a stage, NP the padded rows of a
// part of `per` rows (parts = ceil(N / per)), x_piece and bc_piece the
// bytes of the copies (plan.copy_piece); part_y a float32 scratch of parts
// * T * D where parts > 1 (else null).
REPRO_EXPORT int ssm_chunked_launch(int dtype, const void* x, const void* dt,
                                    const void* b, const void* c, void* y,
                                    void* part_y, int n_steps, int D, int N,
                                    int R, int CH, int S, int NP, int per,
                                    int x_piece, int bc_piece, void* stream) {
  const int elem = repro_elem_bytes(dtype);
  const int parts = per > 0 ? (N + per - 1) / per : 0;
  if ((R != 4 && R != 8 && R != 16) || n_steps < 0 || D < 0 || N < 1 ||
      per < 1 || per > NP || NP < 16 || NP > 256 || (NP & (NP - 1)) ||
      CH < 1 || (CH & (CH - 1)) || CH * (NP / R) > kMaxThreads || S < 1 ||
      parts > 65535 || (parts > 1 && part_y == nullptr) ||
      !valid_piece(x_piece, elem, static_cast<int64_t>(D) * elem) ||
      !valid_piece(bc_piece, elem, static_cast<int64_t>(N) * elem) ||
      (parts > 1 && (static_cast<int64_t>(per) * elem) % bc_piece) ||
      smem_bytes(NP, CH, R, S, elem) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps == 0 || D == 0) return static_cast<int>(cudaSuccess);
  const Shape p{n_steps, D, N, NP, per, parts, CH, S, x_piece, bc_piece};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* py = static_cast<float*>(part_y);
  if (dtype == REPRO_F32)
    return launch_r<float>(R, x, dt, b, c, y, py, p, s);
  if (dtype == REPRO_BF16)
    return launch_r<__nv_bfloat16>(R, x, dt, b, c, y, py, p, s);
  if (dtype == REPRO_F16)
    return launch_r<__half>(R, x, dt, b, c, y, py, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
