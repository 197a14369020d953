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
// 8-byte ones).  The table's rows may lie any number of bytes apart (a
// column slice of a wider table, a view that starts off 16 bytes): the
// piece also divides the row stride and the table's address, so a view is
// gathered where it lies and the table is never copied (a full-width one
// is 3.1 GB in f32 for 168 MB of gathered rows).  Offsets are 64-bit (a
// full-width table is 1.56 GB in bf16).  An index outside [0, n_rows) traps, so the launch fails as
// PyTorch's own indexing kernels do on the card (and as the plain version
// raises on the CPU).
#include "common.cuh"

namespace {

// Output row i = table row idx[i]; table rows stride_vecs pieces apart,
// output rows row_vecs apart.
template <typename V>
__global__ void __launch_bounds__(128)
gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                   V* __restrict__ out, int64_t n_rows, int64_t row_vecs,
                   int64_t stride_vecs) {
  const int64_t i = blockIdx.x;
  const int64_t r = idx[i];
  if (r < 0 || r >= n_rows) __trap();
  V* dst = out + i * row_vecs;
  const V* src = table + r * stride_vecs;
  for (int64_t v = threadIdx.x; v < row_vecs; v += blockDim.x) dst[v] = src[v];
}

template <typename V>
int launch(const void* table, const void* idx, void* out, int64_t n_rows,
           int64_t m, int64_t row_bytes, int64_t stride_bytes,
           cudaStream_t stream) {
  constexpr int64_t v = sizeof(V);
  gather_rows_kernel<V><<<static_cast<unsigned>(m), 128, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(idx),
      static_cast<V*>(out), n_rows, row_bytes / v, stride_bytes / v);
  return static_cast<int>(cudaGetLastError());
}

// The piece rows are copied in (kernel.py's row_piece): the widest of 16,
// 8, 4, 2 and 1 bytes that divides a row's bytes, the row stride and the
// table's address (out, new and 16-byte aligned, takes any of them).
int row_piece(int64_t row_bytes, int64_t stride_bytes, uintptr_t address) {
  const uint64_t step = static_cast<uint64_t>(row_bytes) |
                        static_cast<uint64_t>(stride_bytes) | address;
  int p = 16;
  while (step % p) p /= 2;
  return p;
}

}  // namespace

// Rows of row_bytes, stride_bytes apart in the table (>= 0); out dense and
// 16-byte aligned.
REPRO_EXPORT int gather_rows_launch(const void* table, const void* idx,
                                    void* out, int64_t n_rows, int64_t m,
                                    int64_t row_bytes, int64_t stride_bytes,
                                    void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (m > 0x7fffffffLL || row_bytes < 1 || stride_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rb = row_bytes, sb = stride_bytes;
  switch (row_piece(rb, sb, reinterpret_cast<uintptr_t>(table))) {
    case 16: return launch<uint4>(table, idx, out, n_rows, m, rb, sb, s);
    case 8: return launch<uint2>(table, idx, out, n_rows, m, rb, sb, s);
    case 4: return launch<uint32_t>(table, idx, out, n_rows, m, rb, sb, s);
    case 2: return launch<uint16_t>(table, idx, out, n_rows, m, rb, sb, s);
    default: return launch<uint8_t>(table, idx, out, n_rows, m, rb, sb, s);
  }
}
