// Paged-KV decode attention (one decode step of one GQA group) on Hopper.
//
// Replaces the Pallas kernel paged_decode_attention of
// src/repro/kernels/paged_kv_decode/kernel.py (pallas_call at :96), whose
// sequential grid walks the pages named by the scalar-prefetched page
// table in order, with q resident and (m, l, acc) in VMEM scratch.
//
// Bound on the card: HBM bytes (each active page's K and V read once, ~H
// flops per byte).  So the design is flash decoding: the table is split
// into n_splits ranges of consecutive pages (kernels/paged_kv_decode/
// plan.py chooses them: a few splits per SM, each large enough that the
// partials it writes are small beside the K/V it reads), and paged_split
// takes one range a block.  Each block walks its range in table order, a
// stage of whole pages (kStageElems elements of K, 32 rows at D = 128) at
// a time, with the running max starting at -1e30 as in the reference.
// What sets the bytes in flight: every block keeps one stage of K and V
// (32 KB at D = 128 in f32) in cp.async copies while it computes on the
// previous stage, and two blocks share an SM (64 KB of stage buffers each
// in f32; the registers of up to 8 heads at D = 128): ~64 KB in flight on
// each SM, beyond the ~18 KB (3.35 TB/s x ~0.7 us / 132 SMs) that Little's
// law asks.  A block reads its split's page-table entries into shared
// memory once, so no copy waits on a load of the table.
// In a stage each warp owns a slice of the rows: q lives in registers (each
// lane holds D/32 columns of every head), a dot product is reduced with
// warp shuffles, and the warp keeps its own f32 accumulator slice, rescaled
// by the shared running max and summed across warps once at the end.
//
// With one split the block writes o = acc / max(l, 1e-30) itself (one
// launch, as for a short sequence).  Otherwise it writes f32 partials m, l
// [n_splits, H] and the unnormalized acc [n_splits, H, D], and
// paged_combine reads them in split order: M = max m_s, L = sum l_s
// exp(m_s - M), o = sum acc_s exp(m_s - M) / max(L, 1e-30), rounded once to
// the output type.  Each warp of the combine sums a contiguous run of
// splits in order and the runs are added in order: no atomics, so the
// result is the same on every run.  bf16 takes the same design: at H <= 16
// heads it is bound by bytes too, so there is no tensor-core path.
#include <math.h>  // INFINITY

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageElems = 4096;  // K elements per stage buffer

__host__ __device__ inline int pages_per_stage(int D, int page) {
  const int rows = kStageElems / D;
  return rows >= page ? rows / page : 1;
}

// Dynamic shared memory of paged_split: the stage buffers (or, once they
// are free, the warps' accumulators), the scores, m, l and alpha, and the
// split's page-table entries.
template <typename T>
__host__ __device__ inline size_t smem_bytes_for(int H, int D, int page,
                                                 int per_split) {
  const size_t R = static_cast<size_t>(pages_per_stage(D, page)) * page;
  const size_t stages = 4 * R * D * sizeof(T);  // K and V, two buffers each
  const size_t red = static_cast<size_t>(kWarps) * H * D * sizeof(float);
  const size_t scores = (static_cast<size_t>(H) * R + 3 * H) * sizeof(float);
  return (stages > red ? stages : red) + scores + 8 +  // 8: alignment
         static_cast<size_t>(per_split) * sizeof(int64_t);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC consecutive elements as floats, in 16-byte (f32) or 8-byte (bf16)
// shared-memory loads.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[i] = a.x; out[i + 1] = a.y; out[i + 2] = b.x; out[i + 3] = b.y;
  }
}

// Copy the K/V rows of n_pg pages into one stage buffer; pg holds each
// page's first element offset in the pools (from shared memory).
template <typename T, int D>
__device__ void issue_stage(T* sK, T* sV, const T* __restrict__ kp,
                            const T* __restrict__ vp, const int64_t* pg,
                            int n_pg, int page) {
  constexpr int E16 = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int per_row = D / E16;
  const int rows = n_pg * page;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * E16;
    const int64_t off = pg[r / page] + static_cast<int64_t>(r % page) * D + c;
    cp_async16(sK + r * D + c, kp + off);
    cp_async16(sV + r * D + c, vp + off);
  }
}

// Two blocks an SM fit the registers when q and the accumulator slices
// are small (HMAX x VEC <= 32 floats each); the larger head groups get one.
template <int VEC, int HMAX>
constexpr int min_blocks() {
  return HMAX * VEC <= 32 ? 2 : 1;
}

// grid (n_splits,): block b walks table entries [b * per_split, ...).
template <typename T, int VEC, int HMAX>
__global__ void __launch_bounds__(kThreads, (min_blocks<VEC, HMAX>()))
paged_split(const T* __restrict__ q, const T* __restrict__ kp,
            const T* __restrict__ vp, const int* __restrict__ pt,
            T* __restrict__ o, float* __restrict__ part, int64_t n_pages,
            int H, int page, int n_active, int per_split, float scale) {
  constexpr int D = VEC * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pps = pages_per_stage(D, page);
  const int R = pps * page;
  const int split = blockIdx.x;
  const int begin = split * per_split;
  const int n_mine = min(per_split, n_active - begin);
  const int n_stages = (n_mine + pps - 1) / pps;
  T* const stage0 = reinterpret_cast<T*>(smem_raw);  // K0, V0, K1, V1
  const size_t stage_bytes = 4 * static_cast<size_t>(R) * D * sizeof(T);
  const size_t red_bytes = static_cast<size_t>(kWarps) * H * D * sizeof(float);
  float* sS = reinterpret_cast<float*>(
      smem_raw + (stage_bytes > red_bytes ? stage_bytes : red_bytes));
  float* sM = sS + H * R;
  float* sL = sM + H;
  float* sA = sL + H;
  int64_t* sPg = reinterpret_cast<int64_t*>(
      (reinterpret_cast<uintptr_t>(sA + H) + 7) & ~uintptr_t{7});
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  float qf[HMAX][VEC], acc[HMAX][VEC];
#pragma unroll
  for (int h = 0; h < HMAX; ++h)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qf[h][j] = h < H ? to_f32(q[h * D + lane * VEC + j]) : 0.f;
      acc[h][j] = 0.f;
    }
  for (int h = tid; h < H; h += kThreads) {
    sM[h] = REPRO_NEG_INF;
    sL[h] = 0.f;
  }

  // The split's table entries, read once (a page outside [0, n_pages)
  // traps), as element offsets into the pools.
  for (int i = tid; i < n_mine; i += kThreads) {
    const int64_t pg = pt[begin + i];
    if (pg < 0 || pg >= n_pages) __trap();
    sPg[i] = pg * page * D;
  }
  __syncthreads();

  issue_stage<T, D>(stage0, stage0 + R * D, kp, vp, sPg, min(pps, n_mine),
                    page);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int first = s * pps;  // within the split
    const int rows = min(pps, n_mine - first) * page;
    const T* cK = stage0 + (s & 1) * 2 * R * D;
    const T* cV = cK + R * D;
    if (s + 1 < n_stages) {  // next stage's copies overlap this stage
      const int nxt = first + pps;
      T* nK = stage0 + ((s + 1) & 1) * 2 * R * D;
      issue_stage<T, D>(nK, nK + R * D, kp, vp, sPg + nxt,
                        min(pps, n_mine - nxt), page);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's rows, and m and l, visible

    // s = (q . k) * scale.  Every one of the HMAX heads at once (q is 0
    // past H), so that their shuffle reductions overlap.
    for (int r = warp; r < rows; r += kWarps) {
      float kf[VEC], p[HMAX];
      load_vec<VEC>(cK + r * D + lane * VEC, kf);
#pragma unroll
      for (int h = 0; h < HMAX; ++h) {
        p[h] = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) p[h] = fmaf(qf[h][j], kf[j], p[h]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int h = 0; h < HMAX; ++h)
          p[h] += __shfl_xor_sync(0xffffffffu, p[h], off);
#pragma unroll
      for (int h = 0; h < HMAX; ++h)
        if (lane == h && h < H) sS[h * R + r] = p[h] * scale;
    }
    __syncthreads();

    for (int h = warp; h < H; h += kWarps) {  // online softmax, one warp/head
      float* row = sS + h * R;
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(row[r] - m_new);
        row[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[h] = sL[h] * alpha + sum;
        sM[h] = m_new;
        sA[h] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < HMAX; ++h) {  // acc = acc * alpha + p @ v
      const float a = h < H ? sA[h] : 0.f;  // heads past H stay 0
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[h][j] *= a;
    }
    for (int r = warp; r < rows; r += kWarps) {
      float vf[VEC];
      load_vec<VEC>(cV + r * D + lane * VEC, vf);
#pragma unroll
      for (int h = 0; h < HMAX; ++h) {
        const float p = h < H ? sS[h * R + r] : 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[h][j] = fmaf(p, vf[j], acc[h][j]);
      }
    }
    __syncthreads();  // buffers, scores and alpha are rewritten next stage
  }

  // Sum the warps' accumulators (the stage buffers are free now).
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
    if (h >= H) break;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      red[(warp * H + h) * D + lane * VEC + j] = acc[h][j];
  }
  __syncthreads();
  const int n_splits = gridDim.x;
  float* part_m = part;
  float* part_l = part + n_splits * H;
  float* part_acc = part + 2 * n_splits * H;
  for (int e = tid; e < H * D; e += kThreads) {
    const int h = e / D, c = e % D;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += red[(w * H + h) * D + c];
    if (n_splits == 1)
      o[e] = from_f32<T>(a / fmaxf(sL[h], 1e-30f));
    else
      part_acc[static_cast<int64_t>(split) * H * D + e] = a;
  }
  if (n_splits > 1)
    for (int h = tid; h < H; h += kThreads) {
      part_m[split * H + h] = sM[h];
      part_l[split * H + h] = sL[h];
    }
}

constexpr int kCombineWarps = 8;

// grid (H, D / 32): block (h, c) combines columns 32c .. 32c+31 of head h;
// warp w takes splits [w * per, (w + 1) * per) in order, lane j column 32c+j.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
paged_combine(const float* __restrict__ part, T* __restrict__ o,
              int n_splits, int H, int D) {
  __shared__ float sMax[kCombineWarps];
  __shared__ float sSum[kCombineWarps][33];  // [w][32] is l, the rest acc
  const int h = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.y * 32 + lane;
  const float* part_m = part;
  const float* part_l = part + n_splits * H;
  const float* part_acc = part + 2 * n_splits * H;
  const int per = (n_splits + kCombineWarps - 1) / kCombineWarps;
  const int lo = min(n_splits, warp * per), hi = min(n_splits, lo + per);

  float mx = REPRO_NEG_INF;
  for (int s = lo + lane; s < hi; s += 32) mx = fmaxf(mx, part_m[s * H + h]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) sMax[warp] = mx;
  __syncthreads();
  float m_all = sMax[0];
#pragma unroll
  for (int w = 1; w < kCombineWarps; ++w) m_all = fmaxf(m_all, sMax[w]);

  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = lo; s < hi; ++s) {  // loads of 8 splits in flight at once
    const float wt = expf(part_m[s * H + h] - m_all);
    l = fmaf(part_l[s * H + h], wt, l);
    a = fmaf(part_acc[(static_cast<int64_t>(s) * H + h) * D + col], wt, a);
  }
  sSum[warp][lane] = a;
  if (lane == 0) sSum[warp][32] = l;
  __syncthreads();
  if (warp == 0) {
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kCombineWarps; ++w) {
      lt += sSum[w][32];
      at += sSum[w][lane];
    }
    o[h * D + col] = from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int VEC, int HMAX>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           void* o, void* part, int64_t n_pages, int H, int page,
           int n_active, int per_split, int n_splits, float scale,
           cudaStream_t stream) {
  constexpr int D = VEC * 32;
  const size_t smem = smem_bytes_for<T>(H, D, page, per_split);
  auto* kern = paged_split<T, VEC, HMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_splits, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt), static_cast<T*>(o),
      static_cast<float*>(part), n_pages, H, page, n_active, per_split, scale);
  if (n_splits > 1)
    paged_combine<T><<<dim3(H, D / 32), kCombineWarps * 32, 0, stream>>>(
        static_cast<const float*>(part), static_cast<T*>(o), n_splits, H, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* pt,
             void* o, void* part, int64_t n_pages, int H, int D, int page,
             int n_active, int per_split, int n_splits, float scale,
             cudaStream_t s) {
  if (D == 128) {
    if (H <= 4)
      return launch<T, 4, 4>(q, kp, vp, pt, o, part, n_pages, H, page,
                             n_active, per_split, n_splits, scale, s);
    if (H <= 8)
      return launch<T, 4, 8>(q, kp, vp, pt, o, part, n_pages, H, page,
                             n_active, per_split, n_splits, scale, s);
    if (H <= 16)
      return launch<T, 4, 16>(q, kp, vp, pt, o, part, n_pages, H, page,
                              n_active, per_split, n_splits, scale, s);
  }
  if (D == 256) {
    if (H <= 4)
      return launch<T, 8, 4>(q, kp, vp, pt, o, part, n_pages, H, page,
                             n_active, per_split, n_splits, scale, s);
    if (H <= 8)
      return launch<T, 8, 8>(q, kp, vp, pt, o, part, n_pages, H, page,
                             n_active, per_split, n_splits, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory paged_split needs for one (dtype, H, D, page, pages per
// split), in bytes.
REPRO_EXPORT int64_t paged_decode_smem_bytes(int dtype, int H, int D, int page,
                                             int per_split) {
  if (dtype == REPRO_BF16)
    return static_cast<int64_t>(
        smem_bytes_for<__nv_bfloat16>(H, D, page, per_split));
  return static_cast<int64_t>(smem_bytes_for<float>(H, D, page, per_split));
}

// Contract (checked by the Python wrapper): contiguous, 16-byte aligned
// inputs; D = 128 with H <= 16, or D = 256 with H <= 8; n_active >= 1;
// per_split >= 1 and n_splits = ceil(n_active / per_split); with
// n_splits > 1, f32 scratch part of n_splits * H * (D + 2) floats; shared
// memory within the card's per-block limit.  A page-table entry outside
// [0, n_pages) traps, so the launch fails.  One launch for one split, two
// (split, combine) otherwise.
REPRO_EXPORT int paged_decode_launch(int dtype, const void* q, const void* kp,
                                     const void* vp, const void* pt, void* o,
                                     void* part, int64_t n_pages, int H, int D,
                                     int page, int n_active, int per_split,
                                     int n_splits, float scale, void* stream) {
  if (n_active < 1 || H < 1 || page < 1 || per_split < 1 || n_splits < 1 ||
      n_splits != (n_active + per_split - 1) / per_split ||
      (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return dispatch<float>(q, kp, vp, pt, o, part, n_pages, H, D, page,
                           n_active, per_split, n_splits, scale, s);
  if (dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16>(q, kp, vp, pt, o, part, n_pages, H, D,
                                   page, n_active, per_split, n_splits, scale,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
