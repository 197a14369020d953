// Row gather out[i] = table[idx[i]] on Hopper.
//
// Replaces the Pallas kernel gather_rows of
// src/repro/kernels/token_gather/kernel.py (pallas_call at :53), where the
// index vector is scalar-prefetched and steers each row's DMA.  Here each
// block copies one output row and reads idx[i] from global memory itself.
// Bound on the card: HBM bytes, 2*M*D*itemsize (each gathered row read
// once, each output row written once).  The copy is byte-wise in pieces
// of V, so one kernel serves every element type: 16-byte vectors where
// the row's bytes are a multiple of 16, else the widest of 8, 4, 2 and 1
// bytes that divides them (f32 D 3 moves 4-byte pieces, bf16 D 100
// 8-byte ones).  Offsets are 64-bit (a full-width table is 1.56 GB in
// bf16).  An index outside [0, n_rows) traps, so the launch fails as
// PyTorch's own indexing kernels do on the card (and as the plain version
// raises on the CPU).
#include "common.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(128)
gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                   V* __restrict__ out, int64_t n_rows, int64_t row_vecs) {
  const int64_t i = blockIdx.x;
  const int64_t r = idx[i];
  if (r < 0 || r >= n_rows) __trap();
  V* dst = out + i * row_vecs;
  const V* src = table + r * row_vecs;
  for (int64_t v = threadIdx.x; v < row_vecs; v += blockDim.x) dst[v] = src[v];
}

template <typename V>
int launch(const void* table, const void* idx, void* out, int64_t n_rows,
           int64_t m, int64_t row_bytes, cudaStream_t stream) {
  gather_rows_kernel<V><<<static_cast<unsigned>(m), 128, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(idx),
      static_cast<V*>(out), n_rows, row_bytes / static_cast<int64_t>(sizeof(V)));
  return static_cast<int>(cudaGetLastError());
}

// The piece a row of row_bytes is copied in (kernel.py's row_piece; the
// wrapper checks that the table is aligned to it).
int row_piece(int64_t row_bytes) {
  int p = 16;
  while (row_bytes % p) p /= 2;
  return p;
}

}  // namespace

// table and out aligned to row_piece(row_bytes).
REPRO_EXPORT int gather_rows_launch(const void* table, const void* idx,
                                    void* out, int64_t n_rows, int64_t m,
                                    int64_t row_bytes, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (m > 0x7fffffffLL || row_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_piece(row_bytes)) {
    case 16: return launch<uint4>(table, idx, out, n_rows, m, row_bytes, s);
    case 8: return launch<uint2>(table, idx, out, n_rows, m, row_bytes, s);
    case 4: return launch<uint32_t>(table, idx, out, n_rows, m, row_bytes, s);
    case 2: return launch<uint16_t>(table, idx, out, n_rows, m, row_bytes, s);
    default: return launch<uint8_t>(table, idx, out, n_rows, m, row_bytes, s);
  }
}
