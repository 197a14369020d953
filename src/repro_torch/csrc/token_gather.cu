// Row gather out[i] = table[idx[i]] on Hopper.
//
// Replaces the Pallas kernel gather_rows of
// src/repro/kernels/token_gather/kernel.py (pallas_call at :53), where the
// index vector is scalar-prefetched and steers each row's DMA.  Here each
// block copies one output row and reads idx[i] from global memory itself.
// Bound on the card: HBM bytes, 2*M*D*itemsize (each gathered row read
// once, each output row written once).  The copy is byte-wise in 16-byte
// vectors, so one kernel serves every element type; offsets are 64-bit
// (a full-width table is 1.56 GB in bf16).  An index outside [0, n_rows)
// traps, so the launch fails as PyTorch's own indexing kernels do on the
// card (and as the plain version raises on the CPU).
#include "common.cuh"

__global__ void __launch_bounds__(128)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                   uint4* __restrict__ out, int64_t n_rows, int64_t row_vecs) {
  const int64_t i = blockIdx.x;
  const int64_t r = idx[i];
  if (r < 0 || r >= n_rows) __trap();
  uint4* dst = out + i * row_vecs;
  const uint4* src = table + r * row_vecs;
  for (int64_t v = threadIdx.x; v < row_vecs; v += blockDim.x) dst[v] = src[v];
}

// row_bytes must be a multiple of 16 (the wrapper checks D % 128 == 0).
REPRO_EXPORT int gather_rows_launch(const void* table, const void* idx,
                                    void* out, int64_t n_rows, int64_t m,
                                    int64_t row_bytes, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (m > 0x7fffffffLL || row_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<<<static_cast<unsigned>(m), 128, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(idx),
      static_cast<uint4*>(out), n_rows, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
