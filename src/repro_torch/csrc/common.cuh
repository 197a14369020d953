// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// Every kernel is built into its own shared library by
// repro_torch/kernels/_build.py and bound with ctypes: each exported entry
// takes raw device pointers and the CUDA stream as void*, launches on that
// stream without synchronising, and returns cudaGetLastError() so the
// Python wrapper raises on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Element types a wrapper may pass (kept in step with _build.DTYPE_CODES).
enum ReproDType { REPRO_F32 = 0, REPRO_BF16 = 1, REPRO_F16 = 2 };

// Bytes of one element of a ReproDType (0 for a code no kernel takes).
inline int repro_elem_bytes(int dtype) {
  return dtype == REPRO_F32                          ? 4
         : dtype == REPRO_BF16 || dtype == REPRO_F16 ? 2
                                                     : 0;
}

// Running-max initial value of the online softmax: the reference kernels
// use -1e30, not -inf, so exp(m_prev - m_new) stays finite.
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);  // round to nearest even
}

// Host-side error text for the code an entry returned.
REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
