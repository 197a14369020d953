// Gated EMA scan h_t = dt_t * h_{t-1} + x_t, y_t = g_t * h_t on Hopper.
//
// Replaces the Pallas kernel ssm_ema_scan (_ema_kernel) of
// src/repro/kernels/ssm_scan/kernel.py (pallas_call at :59).  Its grid
// walks the time chunks in order, carrying a [1, D] f32 state in VMEM
// scratch, and evaluates each chunk in closed form (cumprod of dt, cumsum
// of x over it).  Hopper blocks run in no order, so here the time axis is
// a loop inside the block and the channels are the parallel axis.
//
// The recurrence is evaluated directly, in time order, not in closed form
// and not split into time chunks joined by a carry: f32, rounded op by op
// (__fmul_rn, __fadd_rn, which nvcc never contracts into an FMA) in the
// order of the plain version, so in f32 the result is bit-identical to it.
// A chunk split with a carry rounds in another order, and wherever |h| is
// small that exceeds the f32 limit (tests/test_torch_ema_plan.py).
//
// Bound on the card: bytes (x, dt and g read once, y written once).  A
// channel's chain is serial, so the design puts its parallelism into the
// loads, which run ahead of the chain.  A block holds CH channels
// (plan.py): CH consumer threads, one a channel, and one producer warp.
// One elected producer thread keeps a ring of `ring` stages in flight,
// each an [S, CH] tile of x, dt and g brought by three TMA loads (rank-2
// tensor maps over the [T, D] arrays, boxes of {CH, S}) that complete on
// the stage's full mbarrier; a consumer warp releases a stage on its empty
// mbarrier once its lanes have read it.  The consumers walk the stage's
// rows in time order; each step a warp reads 32 consecutive channels of
// one row (no bank conflict) and stores its row of y straight from
// registers, coalesced.  On the H100 one warp's walk costs ~16 ns a step
// (the main paths' times, PERF.md), several times the chain's two
// dependent operations; copies of the kernel with the loads, the
// shared-memory reads, the stores or the dependence between steps cut out
// were no faster, and reading register batches ahead or walking 2-4
// channels a thread did not help.  At full width (Zamba2-7B, T 4096,
// D 7168) the walk hides behind the loads; the main paths' short
// sequences (T <= 1024, D 128-256) take about T steps of it.  At full
// width 224 blocks of 32 channels, 2 an SM, keep 2 stages of 12 KB each in
// flight (plan.py's EMA_FLIGHT_BYTES across the card): deeper rings timed
// slower.
#include "common.cuh"
#include "sm90.cuh"  // mbarriers, the tensor-map encoder, TMA loads

namespace {

using namespace sm90;

constexpr int kMaxThreads = 160;  // 4 consumer warps and the producer

// Shared memory of one block: the ring of [S, CH] tiles of x, dt and g, a
// full and an empty mbarrier a stage, and 128 bytes to align the ring
// (plan.py's ema_smem_bytes).
__host__ inline size_t smem_bytes(int CH, int S, int ring, int elem_bytes) {
  return static_cast<size_t>(ring) *
             (3 * static_cast<size_t>(S) * CH * elem_bytes +
              2 * sizeof(uint64_t)) +
         128;
}

// grid (D / CH); 32 * (ceil(CH / 32) + 1) threads: thread tid < CH walks
// channel blockIdx.x * CH + tid, the last warp is the producer.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ssm_ema_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_dt,
               const __grid_constant__ CUtensorMap tm_g, T* __restrict__ y,
               int n_steps, int D, int CH, int S, int ring) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int tile = S * CH;  // elements of one [S, CH] tile
  T* sring = reinterpret_cast<T*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + static_cast<size_t>(ring) * 3 * tile * sizeof(T));
  uint64_t* empty = full + ring;
  const int n_warps = (CH + 31) / 32;  // consumer warps
  const int n_stages = (n_steps + S - 1) / S;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_warps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 32 * n_warps) {  // producer warp
    if (tid == 32 * n_warps) {
      const uint32_t bytes = 3u * tile * sizeof(T);  // whole boxes, tail too
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % ring;
        mbar_wait(&empty[s], ((i / ring) & 1) ^ 1);
        T* dst = sring + static_cast<size_t>(s) * 3 * tile;
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(dst, &tm_x, &full[s], d0, i * S);
        tma_load_2d(dst + tile, &tm_dt, &full[s], d0, i * S);
        tma_load_2d(dst + 2 * tile, &tm_g, &full[s], d0, i * S);
      }
    }
    return;
  }

  const bool active = tid < CH;  // lanes past CH (CH < 32) only keep step
  float h = 0.f;
  T* yp = y + d0 + tid;
  for (int i = 0; i < n_stages; ++i) {
    const int s = i % ring;
    mbar_wait(&full[s], (i / ring) & 1);
    if (active) {
      const T* sx = sring + static_cast<size_t>(s) * 3 * tile + tid;
      const T* sd = sx + tile;
      const T* sg = sd + tile;
      const int steps = min(S, n_steps - i * S);
#pragma unroll 8
      for (int k = 0; k < steps; ++k) {
        h = __fadd_rn(__fmul_rn(to_f32(sd[k * CH]), h), to_f32(sx[k * CH]));
        *yp = from_f32<T>(__fmul_rn(to_f32(sg[k * CH]), h));
        yp += D;
      }
    }
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(&empty[s]);
  }
}

// Tensor map over a contiguous [T, D] array, boxes of {CH channels, S
// steps}, no swizzle; rows past T read as zeros (the kernel walks only the
// sequence's own steps).
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
              int elem_bytes, int n_steps, int D, int CH, int S) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(n_steps)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(CH),
                             static_cast<cuuint32_t>(S)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(CUtensorMapDataType type, const void* x, const void* dt,
           const void* g, void* y, int n_steps, int D, int CH, int S,
           int ring, cudaStream_t stream) {
  CUtensorMap tx, tdt, tg;
  const int elem = static_cast<int>(sizeof(T));
  if (!make_map(&tx, x, type, elem, n_steps, D, CH, S) ||
      !make_map(&tdt, dt, type, elem, n_steps, D, CH, S) ||
      !make_map(&tg, g, type, elem, n_steps, D, CH, S))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(CH, S, ring, elem);
  auto* kern = ssm_ema_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<D / CH, 32 * ((CH + 31) / 32 + 1), smem, stream>>>(
      tx, tdt, tg, static_cast<T*>(y), n_steps, D, CH, S, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Contract (checked by the Python wrapper): contiguous, 16-byte aligned
// x, dt, g and contiguous y [T, D]; the plan from plan.py: CH channels a
// block (a power of two, at most 128, dividing D, rows of at least 16
// bytes), S steps a stage (at most 256, the TMA box's limit; a tile a
// multiple of 128 bytes), a ring of `ring` stages within the shared memory
// a block may use.
REPRO_EXPORT int ssm_ema_launch(int dtype, const void* x, const void* dt,
                                const void* g, void* y, int n_steps, int D,
                                int CH, int S, int ring, void* stream) {
  const int elem = dtype == REPRO_BF16 ? 2 : 4;
  if (n_steps < 0 || D < 0 || CH < 1 || (CH & (CH - 1)) ||
      CH > kMaxThreads - 32 || CH * elem < 16 || (D > 0 && D % CH) ||
      S < 1 || S > 256 || (S * CH * elem) % 128 || ring < 1 ||
      smem_bytes(CH, S, ring, elem) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps == 0 || D == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, dt, g, y,
                         n_steps, D, CH, S, ring, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, dt, g,
                                 y, n_steps, D, CH, S, ring, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
