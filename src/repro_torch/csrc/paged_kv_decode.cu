// Paged-KV decode attention (one decode step of one GQA group) on Hopper.
//
// Replaces the Pallas kernel paged_decode_attention of
// src/repro/kernels/paged_kv_decode/kernel.py (pallas_call at :96), whose
// sequential grid walks the pages named by the scalar-prefetched page
// table in order, with q resident and (m, l, acc) in VMEM scratch.  Here a
// single block walks the page table in the same order, a stage of whole
// pages (kStageElems elements of K, e.g. 64 rows at D=128) at a time.
// The walked trace comes from the launch spec, not from the CUDA blocks,
// so splitting the pages over blocks (flash decoding, with a reduction)
// would leave the trace unchanged; it is the next version of this kernel.
//
// Bound on the card: HBM bytes (each active page's K and V read once, ~H
// flops per byte).  One block on one SM cannot draw the card's bandwidth;
// what limits it is the latency of its loads.  So each stage's K/V rows
// are copied with cp.async into one of two shared-memory buffers while the
// block computes on the other: every load of a stage is in flight at once
// and overlaps the previous stage's compute.  Each warp owns a slice of a
// stage's rows: q lives in registers (each lane holds D/32 columns of
// every head), a dot product is reduced with warp shuffles, and the warp
// keeps its own f32 accumulator slice, rescaled by the shared running max
// and summed across warps once at the end.
#include <math.h>  // INFINITY

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageElems = 8192;  // K elements per stage buffer

__host__ __device__ inline int pages_per_stage(int D, int page) {
  const int rows = kStageElems / D;
  return rows >= page ? rows / page : 1;
}

template <typename T>
__host__ __device__ inline size_t smem_bytes_for(int H, int D, int page) {
  const size_t R = static_cast<size_t>(pages_per_stage(D, page)) * page;
  const size_t stages = 4 * R * D * sizeof(T);  // K and V, two buffers each
  const size_t red = static_cast<size_t>(kWarps) * H * D * sizeof(float);
  const size_t scores = (static_cast<size_t>(H) * R + 3 * H) * sizeof(float);
  return (stages > red ? stages : red) + scores;
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

// Copy the K/V rows of pages [first, first + n_pg) of the table into one
// stage buffer; a page outside [0, n_pages) traps.
template <typename T>
__device__ void issue_stage(T* sK, T* sV, const T* __restrict__ kp,
                            const T* __restrict__ vp,
                            const int* __restrict__ pt, int64_t n_pages,
                            int first, int n_pg, int page, int D) {
  constexpr int E16 = 16 / sizeof(T);  // elements per 16-byte copy
  const int per_row = D / E16;
  const int rows = n_pg * page;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * E16;
    const int64_t pg = pt[first + r / page];
    if (pg < 0 || pg >= n_pages) __trap();
    const int64_t off = (pg * page + r % page) * static_cast<int64_t>(D) + c;
    cp_async16(sK + r * D + c, kp + off);
    cp_async16(sV + r * D + c, vp + off);
  }
}

template <typename T, int VEC, int HMAX>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ pt,
                    T* __restrict__ o, int64_t n_pages, int H, int page,
                    int n_active, float scale) {
  constexpr int D = VEC * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pps = pages_per_stage(D, page);
  const int R = pps * page;
  const int n_stages = (n_active + pps - 1) / pps;
  T* sK[2] = {reinterpret_cast<T*>(smem_raw),
              reinterpret_cast<T*>(smem_raw) + 2 * R * D};
  T* sV[2] = {sK[0] + R * D, sK[1] + R * D};
  const size_t stage_bytes = 4 * static_cast<size_t>(R) * D * sizeof(T);
  const size_t red_bytes = static_cast<size_t>(kWarps) * H * D * sizeof(float);
  float* sS = reinterpret_cast<float*>(
      smem_raw + (stage_bytes > red_bytes ? stage_bytes : red_bytes));
  float* sM = sS + H * R;
  float* sL = sM + H;
  float* sA = sL + H;
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

  issue_stage(sK[0], sV[0], kp, vp, pt, n_pages, 0, min(pps, n_active), page,
              D);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int first = s * pps;
    const int rows = min(pps, n_active - first) * page;
    const T* cK = sK[s & 1];
    const T* cV = sV[s & 1];
    if (s + 1 < n_stages) {  // next stage's copies overlap this stage
      const int nxt = first + pps;
      issue_stage(sK[(s + 1) & 1], sV[(s + 1) & 1], kp, vp, pt, n_pages, nxt,
                  min(pps, n_active - nxt), page, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's rows, and m and l, visible

    for (int r = warp; r < rows; r += kWarps) {  // s = (q . k) * scale
      float kf[VEC];
      load_vec<VEC>(cK + r * D + lane * VEC, kf);
#pragma unroll
      for (int h = 0; h < HMAX; ++h) {
        if (h >= H) break;
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) p = fmaf(qf[h][j], kf[j], p);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) sS[h * R + r] = p * scale;
      }
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
      if (h >= H) break;
      const float a = sA[h];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[h][j] *= a;
    }
    for (int r = warp; r < rows; r += kWarps) {
      float vf[VEC];
      load_vec<VEC>(cV + r * D + lane * VEC, vf);
#pragma unroll
      for (int h = 0; h < HMAX; ++h) {
        if (h >= H) break;
        const float p = sS[h * R + r];
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
  for (int e = tid; e < H * D; e += kThreads) {
    const int h = e / D, c = e % D;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += red[(w * H + h) * D + c];
    o[e] = from_f32<T>(a / fmaxf(sL[h], 1e-30f));
  }
}

template <typename T, int VEC, int HMAX>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           void* o, int64_t n_pages, int H, int page, int n_active,
           float scale, cudaStream_t stream) {
  if (H > HMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes_for<T>(H, VEC * 32, page);
  auto* kern = paged_decode_kernel<T, VEC, HMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt), static_cast<T*>(o),
      n_pages, H, page, n_active, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* pt,
             void* o, int64_t n_pages, int H, int D, int page, int n_active,
             float scale, cudaStream_t s) {
  if (D == 128)
    return launch<T, 4, 16>(q, kp, vp, pt, o, n_pages, H, page, n_active,
                            scale, s);
  if (D == 256)
    return launch<T, 8, 8>(q, kp, vp, pt, o, n_pages, H, page, n_active,
                           scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory the kernel needs for one (dtype, H, D, page), in bytes.
REPRO_EXPORT int64_t paged_decode_smem_bytes(int dtype, int H, int D,
                                             int page) {
  if (dtype == REPRO_BF16)
    return static_cast<int64_t>(smem_bytes_for<__nv_bfloat16>(H, D, page));
  return static_cast<int64_t>(smem_bytes_for<float>(H, D, page));
}

// Contract (checked by the Python wrapper): contiguous, 16-byte aligned
// inputs; D = 128 with H <= 16, or D = 256 with H <= 8; n_active >= 1;
// shared memory within the card's per-block limit.  A page-table entry
// outside [0, n_pages) traps, so the launch fails.
REPRO_EXPORT int paged_decode_launch(int dtype, const void* q, const void* kp,
                                     const void* vp, const void* pt, void* o,
                                     int64_t n_pages, int H, int D, int page,
                                     int n_active, float scale, void* stream) {
  if (n_active < 1 || H < 1 || page < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return dispatch<float>(q, kp, vp, pt, o, n_pages, H, D, page, n_active,
                           scale, s);
  if (dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16>(q, kp, vp, pt, o, n_pages, H, D, page,
                                   n_active, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
