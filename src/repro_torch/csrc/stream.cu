// STREAM copy / scale / add / triad on Hopper.
//
// Replaces the Pallas kernels stream_copy / stream_scale / stream_add /
// stream_triad of src/repro/kernels/stream/kernel.py (one launcher,
// `_launch`, pallas_call at :59), so this is one kernel templated on the
// op.  Bound on the card: HBM bytes (2 or 3 passes over the arrays, at
// most 2 flops per element).  Design: a grid-stride loop of 16-byte vector
// loads and stores, neighbouring threads on neighbouring addresses, a few
// blocks per SM; the scalar q is passed by value instead of fetched as a
// (1,) block.  Arithmetic rounds op by op (__fmul_rn / __fadd_rn, and
// through bf16 between the multiply and the add for bf16 inputs), so the
// result is the plain PyTorch version's bit for bit.
#include "common.cuh"

enum StreamOp { STREAM_COPY = 0, STREAM_SCALE = 1, STREAM_ADD = 2, STREAM_TRIAD = 3 };

template <int OP, typename T>
__global__ void __launch_bounds__(256)
stream_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
              uint4* __restrict__ o, float q, int64_t n_vec) {
  constexpr int V = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    uint4 va = a[i];
    if constexpr (OP == STREAM_COPY) {
      o[i] = va;
    } else {
      uint4 vb;
      if constexpr (OP == STREAM_ADD || OP == STREAM_TRIAD) vb = b[i];
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
      o[i] = vo;
    }
  }
}

template <int OP, typename T>
static void launch(const void* a, const void* b, void* o, float q,
                   int64_t n_vec, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n_vec + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 blocks/SM
  if (blocks < 1) blocks = 1;
  stream_kernel<OP, T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
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
