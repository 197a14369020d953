// STREAM copy / scale / add / triad on Hopper.
//
// Replaces the Pallas kernels stream_copy / stream_scale / stream_add /
// stream_triad of src/repro/kernels/stream/kernel.py (one launcher,
// `_launch`, pallas_call at :59), so this is one kernel templated on the
// op.  Bound on the card: HBM bytes (2 or 3 passes over the arrays, at
// most 2 flops per element), so the design keeps as many bytes in flight
// as the memory system takes.  Each block covers one tile of kStreamVecs
// 16-byte vectors per thread, neighbouring threads on neighbouring
// addresses; a thread issues all its loads before its first store, and
// the grid is as many blocks as the array has tiles (no grid-stride loop,
// whose next loads would wait behind this iteration's stores).  Of the
// designs timed in turns with PyTorch's own calls on an H100 (PERF.md),
// this was the fastest; streaming cache hints (__ldcs / __stcs) and an
// unrolled grid-stride loop over the resident grid were slower.  The
// scalar q is passed by value instead of fetched as a (1,) block.
// Arithmetic rounds op by op (__fmul_rn / __fadd_rn, and through bf16
// between the multiply and the add for bf16 inputs), so the result is the
// plain PyTorch version's bit for bit.
#include "common.cuh"

enum StreamOp { STREAM_COPY = 0, STREAM_SCALE = 1, STREAM_ADD = 2, STREAM_TRIAD = 3 };

constexpr int kStreamThreads = 256;
constexpr int kStreamVecs = 4;  // 16-byte vectors per thread per operand

// One 16-byte vector of the op's output from the vectors of a and b.
template <int OP, typename T>
__device__ __forceinline__ uint4 stream_vec(uint4 va, uint4 vb, float q) {
  if constexpr (OP == STREAM_COPY) {
    return va;
  } else {
    constexpr int V = 16 / sizeof(T);
    uint4 vo;
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float x = to_f32(ea[j]);
      float r;
      if constexpr (OP == STREAM_SCALE) {
        r = __fmul_rn(q, x);
      } else if constexpr (OP == STREAM_ADD) {
        r = __fadd_rn(x, to_f32(eb[j]));
      } else {
        // q*b is rounded to the element type before the add, as the
        // op-by-op reference does.
        const float qb = to_f32(from_f32<T>(__fmul_rn(q, to_f32(eb[j]))));
        r = __fadd_rn(x, qb);
      }
      eo[j] = from_f32<T>(r);
    }
    return vo;
  }
}

template <int OP>
__host__ __device__ constexpr bool stream_reads_b() {
  return OP == STREAM_ADD || OP == STREAM_TRIAD;
}

template <int OP, typename T>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
              uint4* __restrict__ o, float q, int64_t n_vec) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kStreamThreads * kStreamVecs +
      threadIdx.x;
  uint4 va[kStreamVecs], vb[kStreamVecs];
#pragma unroll
  for (int k = 0; k < kStreamVecs; ++k) {
    const int64_t i = base + k * kStreamThreads;
    if (i < n_vec) {
      va[k] = a[i];
      if constexpr (stream_reads_b<OP>()) vb[k] = b[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kStreamVecs; ++k) {
    const int64_t i = base + k * kStreamThreads;
    if (i < n_vec) o[i] = stream_vec<OP, T>(va[k], vb[k], q);
  }
}

template <int OP, typename T>
static void launch(const void* a, const void* b, void* o, float q,
                   int64_t n_vec, cudaStream_t stream) {
  constexpr int64_t per_block = kStreamThreads * kStreamVecs;
  const int64_t blocks = (n_vec + per_block - 1) / per_block;
  stream_kernel<OP, T><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                         kStreamThreads, 0, stream>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<uint4*>(o), q, n_vec);
}

template <typename T>
static int dispatch(int op, const void* a, const void* b, void* o, float q,
                    int64_t n_vec, cudaStream_t s) {
  switch (op) {
    case STREAM_COPY: launch<STREAM_COPY, T>(a, b, o, q, n_vec, s); break;
    case STREAM_SCALE: launch<STREAM_SCALE, T>(a, b, o, q, n_vec, s); break;
    case STREAM_ADD: launch<STREAM_ADD, T>(a, b, o, q, n_vec, s); break;
    case STREAM_TRIAD: launch<STREAM_TRIAD, T>(a, b, o, q, n_vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// n_elems must be a multiple of 16 / sizeof(element); pointers 16-byte
// aligned (the Python wrapper checks both).
REPRO_EXPORT int stream_launch(int op, int dtype, const void* a, const void* b,
                               void* o, float q, int64_t n_elems,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32) return dispatch<float>(op, a, b, o, q, n_elems / 4, s);
  if (dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16>(op, a, b, o, q, n_elems / 8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
