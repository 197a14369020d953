// MoE dispatch (row gather, per-expert GEMM, row scatter) on Hopper.
//
// Replaces the Pallas kernel moe_dispatch_sorted of
// src/repro/kernels/moe_dispatch/kernel.py (pallas_call at :60).  Its grid
// walks the expert-sorted token stream one token a step, with the token
// order and the expert ids scalar-prefetched: x[tok[i]] is gathered,
// w[eid[i]] stays resident in VMEM across each run of one expert
// (revisiting), and y[tok[i]] = x[tok[i]] @ w[eid[i]] is scattered back.
//
// Here it is a grouped GEMM over a tile list that the card builds, in two
// launches:
//
// 1. moe_tile_list, one block: checks that tok is a permutation of [0, T)
//    (a bitmap of T bits in shared memory, atomicOr, a trap on a repeat;
//    above what a block's shared memory holds, 1 859 584 tokens, the
//    bitmap lies in global memory and moe_check_tokens, a grid of blocks,
//    checks the tokens first) and that every token and expert id is in
//    range; marks the start of
//    each run of one expert (i == 0 or eid[i] != eid[i-1]); and, with two
//    block-wide scans, cuts every run into M-tiles of at most bm rows,
//    written as (first sorted row, rows, expert) records after a count.
//    Runs are cut wherever eid changes, so an unsorted eid is still
//    dispatched right (as the reference, which only fetches w again).  A
//    tile holds at least one row, so there are at most T tiles.
// 2. A persistent grid (as many blocks as the wrapper asks: plan.py sizes it
//    to the blocks each kernel fits on the card at once) walks the
//    work items (M-tile, N-tile of BN columns), item = m * n_ntiles + n.
//    At any time the resident blocks hold a window of consecutive M-tiles
//    with all their N-tiles, so an M-tile's gathered x rows are read from
//    HBM about once and served from L2 to its other N-tiles, and the few
//    M-tiles of one expert read its [D, BN] weight panels at about the
//    same time (one HBM read, L2 for the rest).  A tile never spans two
//    experts; its missing rows are zero-filled and not stored.  Each
//    sorted row lies in one M-tile, so every y row is written once, with
//    no atomics, and the result is deterministic.
//
// bf16 and f16, moe_gemm_sm90 (tensor cores; one template on the element
// type, whose wgmma forms and tensor map alone differ): bound on the card
// at a routed layer's
// width (DeepSeek-MoE-16B, T = 24576, D = 2048, F = 1408, E = 64) by bytes,
// just: 263 flops a byte against the H100's ~295, so the weights must stream
// at HBM rate while wgmma stays fed.  A block is a producer warpgroup and
// two consumer warpgroups over a ring of stages of a 128-row x 64-column A
// tile and a 64-row x 256-column B tile.  BN, the N-tile, is 256 for every
// F (F = 1408 is five such N-tiles and a last of 128; F = 128 is one, half
// used): every gathered A tile is re-read from L2 once per N-tile, so
// N-tiles of 256 halve that traffic against 128 (~2.5 GB at BN = 128 at
// the width above).  B, the expert's weight panel, comes by TMA (a rank-3
// tensor map over [E, D, F], box {64 F, 64 D, 1}, four boxes a stage,
// 128-byte swizzle; boxes past F are not loaded, and the columns they
// would feed are computed from stale data and never stored).  A, the x
// rows gathered by tok, comes by 16-byte cp.async (TMA has no row gather)
// into the same swizzled K-major layout: chunk c of row r lands at chunk
// c ^ (r % 8).  Each producer thread keeps kLag (kStages - 2) stages of its
// copies in flight, then waits for the oldest, fences the async proxy and
// arrives on that stage's barrier.  Each consumer owns 64 rows: wgmma
// m64n256k16 with A K-major and B MN-major (the transpose bit), f32
// accumulators (128 a thread; setmaxnreg moves registers from the producer
// to the consumers), one stage's products in flight while the next is
// issued.  The epilogue rounds once to the element type, stages the tile
// through shared memory (swizzled) and writes 16-byte row segments
// scattered by tok.
//
// f32, moe_gemm_f32 (CUDA cores, since TF32 would miss the f32 tolerance and
// needs a K-major B): bound by operations, 2*T*D*F at 67 TFLOP/s.  A 128 x
// 128 block tile, 256 threads with an 8 x 8 register tile each (a small
// dispatch, whose 128-row items would leave most SMs idle, takes 32-row
// tiles and 2 x 8 a thread instead), and a ring of kStages cp.async stages
// (x rows gathered, w rows copied contiguously, 16 bytes a copy), so the
// next stages' loads are in flight during the FMAs; A is read from shared
// memory as float4 along K (chunks XOR-swizzled by row so a warp's four row
// groups hit distinct banks), B as float4 along N.  The sum stays in f32 and
// is rounded once.
//
// Every D >= 1 and F >= 1.  The last K stage and the last N-tile may be
// partial: copies past D or F are zero-filled (a cp.async source size of
// 0), so they add nothing, and columns past F are never stored.  Each
// GEMM has a second instance, kNarrow, for rows that are not a multiple of
// 16 bytes (f32 D or F % 4 != 0; bf16 and f16 D or F % 8 != 0): its copies
// move 4 bytes (2 for a 2-byte row of odd length, by plain loads and
// stores), bf16 and f16 bring the weight panels by cp.async in place of
// TMA (whose row stride must be a multiple of 16 bytes) into the same
// swizzled layout, and the epilogue stores element by element.  Shapes of
// whole K stages and N-tiles (f32 D % 32 == 0 and F % 128 == 0; bf16 and
// f16 D and F % 64 == 0), the reference's kernel route among them, keep a
// third instance with no tail tests (kExact).
#include <algorithm>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBN = 128;  // f32's N-tile

// Instances of each GEMM by the rows it copies: whole tiles of 16-byte rows
// (kExact), 16-byte rows with a K or N tail (kTail), other rows (kNarrow).
// kNarrow computes every shape, but at 16-byte rows kTail's wide copies
// (and bf16's TMA) are faster: at D 2040, F 1400 kNarrow took 1.11x its
// time in f32 and 4.7x in bf16 (PERF.md).
constexpr int kExact = 0, kTail = 1, kNarrow = 2;

// One M-tile of the list; the buffer holds an int32 header of four (the
// tile count first), then the records.
struct Tile {
  int row0, rows, expert, pad;
};

__device__ __forceinline__ const Tile* tile_records(const int* buf) {
  return reinterpret_cast<const Tile*>(buf + 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes 0 zero-fills the 16 bytes without reading.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  // src_bytes 0 zero-fills the 4 bytes without reading.
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Pre-pass: permutation check and tile list, one block
// ---------------------------------------------------------------------------

constexpr int kPreThreads = 1024;

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Exclusive scan of one int a thread across the block, in thread order;
// *total gets the reduction over all threads.
template <typename Op>
__device__ int block_exclusive_scan(int v, int identity, Op op, int* warp_tot,
                                    int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = op(inc, n);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_tot[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, n);
    }
    warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = identity;
  const int res = op(warp ? warp_tot[warp - 1] : identity, excl);
  *total = warp_tot[n_warps - 1];
  __syncthreads();  // warp_tot is reused by the next scan
  return res;
}

// Tokens and expert ids in range, no token twice: `seen` is a bitmap of
// n_tokens bits, zero to begin with (shared or global memory).
__device__ __forceinline__ void check_token(const int* __restrict__ tok,
                                            const int* __restrict__ eid,
                                            int i, int n_tokens,
                                            int n_experts, uint32_t* seen) {
  const int t = tok[i], e = eid[i];
  if (t < 0 || t >= n_tokens || e < 0 || e >= n_experts) __trap();
  const uint32_t bit = 1u << (t % 32);
  if (atomicOr(&seen[t / 32], bit) & bit) __trap();  // a repeated token
}

// The check over a grid of blocks, with the bitmap in global memory (a
// stream too long for one block's shared memory).
__global__ void __launch_bounds__(256)
moe_check_tokens(const int* __restrict__ tok, const int* __restrict__ eid,
                 int n_tokens, int n_experts, uint32_t* __restrict__ seen) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n_tokens;
       i += gridDim.x * 256)
    check_token(tok, eid, i, n_tokens, n_experts, seen);
}

// check: the tokens are checked here, with the bitmap in shared memory;
// else moe_check_tokens has checked them.
__global__ void __launch_bounds__(kPreThreads)
moe_tile_list(const int* __restrict__ tok, const int* __restrict__ eid,
              int n_tokens, int n_experts, int bm, int* __restrict__ out,
              bool check) {
  extern __shared__ uint32_t seen[];  // one bit a token
  __shared__ int warp_tot[32];
  if (check) {
    const int words = (n_tokens + 31) / 32;
    for (int i = threadIdx.x; i < words; i += blockDim.x) seen[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n_tokens; i += blockDim.x)
      check_token(tok, eid, i, n_tokens, n_experts, seen);
  }

  // Each thread takes a chunk of consecutive sorted positions.  A tile
  // starts where a run starts and every bm rows into it, so a chunk needs
  // the start of the run that is open at its first position: the latest
  // run start of the chunks before it.
  const int per = (n_tokens + blockDim.x - 1) / blockDim.x;
  const int lo = min(n_tokens, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n_tokens, lo + per);
  int last = -1;
  for (int i = lo; i < hi; ++i)
    if (i == 0 || eid[i] != eid[i - 1]) last = i;
  int unused;
  const int open = block_exclusive_scan(last, -1, MaxOp(), warp_tot, &unused);
  int n = 0;
  for (int i = lo, rs = open; i < hi; ++i) {
    if (i == 0 || eid[i] != eid[i - 1]) rs = i;
    if ((i - rs) % bm == 0) ++n;
  }
  int count;
  int k = block_exclusive_scan(n, 0, SumOp(), warp_tot, &count);
  Tile* tiles = reinterpret_cast<Tile*>(out + 4);
  for (int i = lo, rs = open; i < hi; ++i) {
    if (i == 0 || eid[i] != eid[i - 1]) rs = i;
    if ((i - rs) % bm == 0) {
      tiles[k].row0 = i;
      tiles[k].expert = eid[i];
      tiles[k].pad = 0;
      ++k;
    }
  }
  if (threadIdx.x == 0) {
    out[0] = count;
    out[1] = out[2] = out[3] = 0;
  }
  __syncthreads();  // every tile's first row is visible to the block
  for (int j = threadIdx.x; j < count; j += blockDim.x)
    tiles[j].rows = (j + 1 < count ? tiles[j + 1].row0 : n_tokens) -
                    tiles[j].row0;
}

size_t prepass_smem(int n_tokens) {
  return static_cast<size_t>((n_tokens + 31) / 32) * 4;
}

// Dynamic shared memory the pre-pass's block may use beside its scan
// scratch (a Hopper block's 232 448 bytes less 128).
constexpr size_t kPrepassSmem = 232448 - 128;

// `tiles` holds 4 + 4 n_tokens ints of header and records, then a bitmap of
// ceil(n_tokens / 32) words, used where the bitmap overflows shared memory.
int launch_tile_list(const int* tok, const int* eid, int* tiles, int n_tokens,
                     int n_experts, int bm, cudaStream_t stream) {
  const size_t bitmap_bytes = prepass_smem(n_tokens);
  const bool in_smem = bitmap_bytes <= kPrepassSmem;
  if (!in_smem) {
    uint32_t* seen = reinterpret_cast<uint32_t*>(
        tiles + 4 + 4 * static_cast<int64_t>(n_tokens));
    cudaError_t err = cudaMemsetAsync(seen, 0, bitmap_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = static_cast<int>(
        std::min<int64_t>((n_tokens + 255) / 256, 8192));
    moe_check_tokens<<<blocks, 256, 0, stream>>>(tok, eid, n_tokens,
                                                 n_experts, seen);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = in_smem ? bitmap_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_tile_list, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moe_tile_list<<<1, kPreThreads, smem, stream>>>(tok, eid, n_tokens,
                                                  n_experts, bm, tiles,
                                                  in_smem);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA-core grouped GEMM
// ---------------------------------------------------------------------------

namespace f32k {

constexpr int kBK = 32;      // K per stage (8 chunks of 16 bytes a row)
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kThreads = 256;

// A block tile of BM = 16 RT rows x kBN columns: 16 x 16 threads, each RT
// rows x 8 columns.  128-row tiles for large dispatches; 32-row tiles
// spread a small dispatch's few items over more SMs, with 4x less work
// each (plan.block_rows chooses).
template <int RT>
struct Tiling {
  static constexpr int kBM = 16 * RT;
  static constexpr int kStageFloats = kBM * kBK + kBK * kBN;  // A then B
  static constexpr int kSmem = kStages * kStageFloats * 4 + kBM * 4;
};

// Issue stage kt's copies into buffer `buf`: A rows tid/8 + 32j (chunk
// tid % 8, stored at chunk ^ (row/RT % 8), so the rows a warp reads at
// once hit distinct banks); B rows tid/32 + 8j (chunk tid % 32) of the
// expert's [D, F] slab from column n0 on (`we` points there).  A chunk is
// four floats: one 16-byte copy, or four 4-byte ones (kNarrow), each
// zero-filled where it lies past D, F or the tile's rows (kExact: past the
// tile's rows alone).
template <int RT, int kMode>
__device__ __forceinline__ void issue(float* buf, const float* __restrict__ x,
                                      const float* __restrict__ we,
                                      const int* sTok, int rows, int D, int F,
                                      int n0, int k0) {
  constexpr int kBM = Tiling<RT>::kBM;
  const int tid = threadIdx.x;
  const uint32_t a = sm90::smem_u32(buf);
  const uint32_t b = sm90::smem_u32(buf + kBM * kBK);
#pragma unroll
  for (int j = 0; j < kBM / 32; ++j) {
    const int r = tid / 8 + 32 * j, ch = tid % 8;
    const int k = k0 + ch * 4;
    const bool ok = r < rows;
    const float* src = x + (ok ? static_cast<int64_t>(sTok[r]) * D : 0) + k;
    const uint32_t dst = a + (r * kBK + ((ch ^ ((r / RT) % 8)) * 4)) * 4;
    if constexpr (kMode == kExact) {
      cp_async16(dst, src, ok ? 16 : 0);
    } else if constexpr (kMode == kNarrow) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst + 4 * e, ok && k + e < D ? src + e : x,
                  ok && k + e < D ? 4 : 0);
    } else {
      cp_async16(dst, ok && k < D ? src : x, ok && k < D ? 16 : 0);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = tid / 32 + 8 * j, ch = tid % 32;
    const uint32_t dst = b + (k * kBN + ch * 4) * 4;
    if constexpr (kMode == kExact) {
      cp_async16(dst, we + static_cast<int64_t>(k0 + k) * F + ch * 4, 16);
    } else {
      const int col = n0 + ch * 4;
      const bool ok = k0 + k < D;
      const float* src =
          we + static_cast<int64_t>(ok ? k0 + k : 0) * F + ch * 4;
      if constexpr (kMode == kNarrow) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + 4 * e, ok && col + e < F ? src + e : x,
                    ok && col + e < F ? 4 : 0);
      } else {
        cp_async16(dst, ok && col < F ? src : x, ok && col < F ? 16 : 0);
      }
    }
  }
}

// Two blocks an SM (plan.BLOCKS_PER_SM sizes the grid for that).
template <int RT, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
moe_gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
             const int* __restrict__ tok, const int* __restrict__ tiles_buf,
             float* __restrict__ y, int D, int F) {
  using Geo = Tiling<RT>;
  extern __shared__ __align__(16) float smem[];
  int* sTok = reinterpret_cast<int*>(smem + kStages * Geo::kStageFloats);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = lane % 8 + 8 * (warp % 2);  // columns 4tx.., 64 + 4tx..
  const int ty = lane / 8 + 4 * (warp / 2);  // rows RT ty .. RT ty + RT - 1
  const int n_ntiles = (F + kBN - 1) / kBN, nk = (D + kBK - 1) / kBK;
  const int n_items = tiles_buf[0] * n_ntiles;
  const Tile* tiles = tile_records(tiles_buf);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Tile tl = tiles[item / n_ntiles];
    const int n0 = (item % n_ntiles) * kBN;
    if (tid < Geo::kBM) sTok[tid] = tid < tl.rows ? tok[tl.row0 + tid] : 0;
    __syncthreads();
    const float* we = w + static_cast<int64_t>(tl.expert) * D * F + n0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk)
        issue<RT, kMode>(smem + s * Geo::kStageFloats, x, we, sTok, tl.rows,
                         D, F, n0, s * kBK);
      cp_async_commit();
    }
    float acc[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage kt landed; buffer kt-1 is free
      const int nxt = kt + kStages - 1;
      if (nxt < nk)
        issue<RT, kMode>(smem + (nxt % kStages) * Geo::kStageFloats, x, we,
                         sTok, tl.rows, D, F, n0, nxt * kBK);
      cp_async_commit();
      const float* sA = smem + (kt % kStages) * Geo::kStageFloats;
      const float* sB = sA + Geo::kBM * kBK;
#pragma unroll
      for (int kc = 0; kc < kBK / 4; ++kc) {
        float4 a4[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          a4[i] = *reinterpret_cast<const float4*>(
              sA + (RT * ty + i) * kBK + ((kc ^ (ty % 8)) * 4));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* brow = sB + (4 * kc + kk) * kBN;
          const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * tx);
          const float4 b1 =
              *reinterpret_cast<const float4*>(brow + 64 + 4 * tx);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float av = kk == 0   ? a4[i].x
                             : kk == 1 ? a4[i].y
                             : kk == 2 ? a4[i].z
                                       : a4[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = RT * ty + i;
      if (r < tl.rows) {
        float* dst = y + static_cast<int64_t>(sTok[r]) * F + n0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 64 * h + 4 * tx;  // of the N-tile
          if constexpr (kMode == kNarrow) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n0 + col + e < F) dst[col + e] = acc[i][4 * h + e];
          } else if (kMode == kExact || n0 + col < F) {
            *reinterpret_cast<float4*>(dst + col) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
          }
        }
      }
    }
    __syncthreads();  // sTok and the ring are refilled by the next item
  }
}

template <int RT, int kMode>
int launch(const float* x, const float* w, const int* tok, const int* tiles,
           float* y, int D, int F, int grid, cudaStream_t stream) {
  constexpr int smem = Tiling<RT>::kSmem;
  auto* kern = moe_gemm_f32<RT, kMode>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, stream>>>(x, w, tok, tiles, y, D, F);
  return static_cast<int>(cudaGetLastError());
}

// Rows of 16-byte multiples (D, F % 4 == 0) take the wide copies, whole
// K stages and N-tiles (D % kBK == 0, F % kBN == 0) no tail tests.
template <int RT>
int launch_rows(const float* x, const float* w, const int* tok,
                const int* tiles, float* y, int D, int F, int grid,
                cudaStream_t stream) {
  if (D % kBK == 0 && F % kBN == 0)
    return launch<RT, kExact>(x, w, tok, tiles, y, D, F, grid, stream);
  return D % 4 == 0 && F % 4 == 0
             ? launch<RT, kTail>(x, w, tok, tiles, y, D, F, grid, stream)
             : launch<RT, kNarrow>(x, w, tok, tiles, y, D, F, grid, stream);
}

}  // namespace f32k

// ---------------------------------------------------------------------------
// bf16 and f16: tensor-core grouped GEMM (sm_90a)
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int kBM = 128;         // rows per M-tile: two consumers x 64
constexpr int kBN = 256;         // columns per N-tile
constexpr int kBK = 64;          // K per stage: one 128-byte row of 2-byte
                                 // elements
constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr int kStages = 3;       // ring depth
// Stages of copies a producer thread keeps in flight before it hands the
// oldest over.  A consumer frees a stage only once the next one is full,
// and the producer fills a slot only once it is free, so the hand-over of
// stage j must come before the producer waits for slot j + kStages - 1:
// kLag <= kStages - 2, or the block deadlocks.
constexpr int kLag = kStages - 2;
constexpr int kPanel = 64 * 128;         // 64 rows x 64 columns
constexpr int kPanels = kBN / 64;        // B and output panels
constexpr int kATile = kBM * 128;        // 128 rows x 64 columns
constexpr int kBTile = kPanels * kPanel;  // 64 D rows x kBN columns
constexpr int kOut = kPanels * kPanel;    // a consumer's 64 x kBN
constexpr int kSmem =
    1024 + kStages * (kATile + kBTile) + 2 * kOut + 8 * 3 * kStages;

// Bytes a narrow copy moves: 4 (two elements) where a row's length is
// even, else 2 (one, by a plain load and store).  Each lands at its place in
// the 128-byte-swizzled layout: row r's 16-byte chunk c at chunk c ^ (r %
// 8) of its 128-byte row.  `valid` elements are read from src (0 or the
// copy's own count), the rest are zeros; `base`, an address inside the
// array, stands in for src when none is read.
template <typename T>
__device__ __forceinline__ void copy_narrow(uint8_t* row_base, int r, int col,
                                            const T* src, const T* base,
                                            int valid, bool pairs) {
  uint8_t* dst = row_base + (((col / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
  if (pairs) {
    cp_async4(smem_u32(dst), valid > 0 ? src : base, valid > 0 ? 4 : 0);
  } else {
    *reinterpret_cast<T*>(dst) = valid > 0 ? *src : from_f32<T>(0.f);
  }
}

// kNarrow: x or w has rows that are not a multiple of 16 bytes; the
// producers bring A and B in 4- or 2-byte copies, and B without TMA.
// kTail: a K tail or a panel F ends inside (D or F % 64 != 0): A's copies
// past D are zero-filled, B's by TMA's fill; kExact: neither.  T is the
// element type, __nv_bfloat16 or __half.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_sm90(const __grid_constant__ CUtensorMap tm_w,
              const T* __restrict__ x, const T* __restrict__ w,
              const int* __restrict__ tok, const int* __restrict__ tiles_buf,
              T* __restrict__ y, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sB = sA + kStages * kATile;
  uint8_t* sOut = sB + kStages * kBTile;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(sOut + 2 * kOut);
  uint64_t* full_b = full_a + kStages;
  uint64_t* empty = full_b + kStages;

  const int tid = threadIdx.x;
  const int n_ntiles = (F + kBN - 1) / kBN, nk = (D + kBK - 1) / kBK;
  const int n_items = tiles_buf[0] * n_ntiles;
  const Tile* tiles = tile_records(tiles_buf);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_a[s], 128);  // every producer thread's copies
      mbar_init(&full_b[s], 1);    // the TMA bytes
      mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;" ::: "memory");
    // Thread tid copies chunk tid % 8 of rows tid / 8 + 16 j of each A tile.
    const int ch = tid % 8;
    const bool x_pairs = D % 2 == 0, w_pairs = F % 2 == 0;
    int it = 0;  // stages issued, over all items
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Tile tl = tiles[item / n_ntiles];
      const int n0 = (item % n_ntiles) * kBN;
      // Panels past F (the last N-tile of an F that is not a multiple of
      // kBN) are not loaded; their columns are computed from stale data and
      // never stored.  A panel F ends inside is loaded whole, its columns
      // past F zeros (TMA's fill, or the narrow copies').
      const int panels = min(kPanels, (F - n0 + 63) / 64);
      const T* src[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tid / 8 + 16 * j;
        src[j] = x + (r < tl.rows ? static_cast<int64_t>(tok[tl.row0 + r]) * D
                                  : 0);
      }
      const T* we = w + static_cast<int64_t>(tl.expert) * D * F;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int k0 = kt * kBK;
        if constexpr (kMode != kNarrow) {
          if (tid == 0) {
            uint8_t* b = sB + s * kBTile;
            mbar_expect_tx(&full_b[s], panels * kPanel);
            for (int p = 0; p < panels; ++p)
              tma_load(b + p * kPanel, &tm_w, &full_b[s], n0 + 64 * p, k0,
                       tl.expert);
          }
          const uint32_t a = smem_u32(sA + s * kATile);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = tid / 8 + 16 * j;
            const uint32_t dst = a + r * 128 + ((ch ^ (r % 8)) * 16);
            if constexpr (kMode == kExact) {
              cp_async16(dst, src[j] + k0 + ch * 8, r < tl.rows ? 16 : 0);
            } else {
              const bool ok = r < tl.rows && k0 + ch * 8 < D;
              cp_async16(dst, ok ? src[j] + k0 + ch * 8 : x, ok ? 16 : 0);
            }
          }
        } else {
          if (tid == 0) mbar_arrive(&full_b[s]);  // B comes with A's copies
          const int step = x_pairs ? 2 : 1;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = tid / 8 + 16 * j;
            uint8_t* row = sA + s * kATile + r * 128;
            for (int e = 0; e < 8; e += step) {
              const int k = k0 + ch * 8 + e;
              const int valid = r < tl.rows ? min(step, D - k) : 0;
              copy_narrow(row, r, ch * 8 + e, src[j] + k, x, valid, x_pairs);
            }
          }
          // B: panels x 64 rows x 8 chunks of 8 columns, chunk q of the
          // stage's list to thread q % 128.
          const int wstep = w_pairs ? 2 : 1;
          for (int q = tid; q < panels * 64 * 8; q += 128) {
            const int p = q / 512, k = (q / 8) % 64, c = q % 8;
            uint8_t* row = sB + s * kBTile + p * kPanel + k * 128;
            const int col = n0 + 64 * p + 8 * c;
            const T* wsrc =
                we + static_cast<int64_t>(min(k0 + k, D - 1)) * F;
            for (int e = 0; e < 8; e += wstep) {
              const int valid = k0 + k < D ? min(wstep, F - col - e) : 0;
              copy_narrow(row, k, 8 * c + e, wsrc + col + e, w, valid,
                          w_pairs);
            }
          }
        }
        cp_async_commit();
        if (it >= kLag) {  // stage it - kLag has landed: hand it over
          cp_async_wait<kLag>();
          fence_proxy_async();
          mbar_arrive(&full_a[(it - kLag) % kStages]);
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int j = it > kLag ? it - kLag : 0; j < it; ++j)
      mbar_arrive(&full_a[j % kStages]);
    return;
  }

  // Consumer warpgroups: c owns rows 64c .. 64c+63 of each M-tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;" ::: "memory");
  const int c = tid / 128 - 1;
  const int t = tid % 128;
  const int lane = t % 32;
  const int row_lo = 16 * (t / 32) + lane / 4;  // and row_lo + 8
  const int col_in = 2 * (lane % 4);            // first of two columns
  uint8_t* out = sOut + c * kOut;
  float acc[kBN / 2];
  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Tile tl = tiles[item / n_ntiles];
    const int n0 = (item % n_ntiles) * kBN;
    const bool idle = 64 * c >= tl.rows;  // no row of this M-tile is ours
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      const int parity = (it / kStages) & 1;
      mbar_wait(&full_a[s], parity);
      mbar_wait(&full_b[s], parity);
      if (idle) {
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t a_addr = smem_u32(sA + s * kATile) + 64 * c * 128;
      const uint32_t b_addr = smem_u32(sB + s * kBTile);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_n256_tb<T>(acc, sw128_desc(a_addr + kk * 32, 16),
                         sw128_desc(b_addr + kk * 16 * 128, kPanel),
                         (kt | kk) != 0);
      wgmma_commit();
      reg_fence(acc);
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    if (idle) continue;
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // Round once to T, stage in this consumer's swizzled tile (acc[4n +
    // 2r + e] is row row_lo + 8r, column 8n + col_in + e) and write the
    // valid rows and columns as 16-byte segments scattered by tok.
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        *reinterpret_cast<uint32_t*>(out + (n / 8) * kPanel + row * 128 +
                                     (((n % 8) ^ (row % 8)) * 16) +
                                     col_in * 2) =
            pack2<T>(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
    const int cols = min(kBN, F - n0);
    if (kMode != kNarrow || F % 8 == 0) {
      const int chunks = cols / 8;  // 16-byte segments in a row
      for (int i = t; i < 64 * chunks; i += 128) {
        const int row = i / chunks, chk = i % chunks;
        if (64 * c + row < tl.rows) {
          const uint4 val = *reinterpret_cast<const uint4*>(
              out + (chk / 8) * kPanel + row * 128 +
              (((chk % 8) ^ (row % 8)) * 16));
          const int64_t dst =
              static_cast<int64_t>(tok[tl.row0 + 64 * c + row]);
          *reinterpret_cast<uint4*>(y + dst * F + n0 + chk * 8) = val;
        }
      }
    } else {  // rows that are not 16-byte multiples: element by element
      for (int i = t; i < 64 * cols; i += 128) {
        const int row = i / cols, col = i % cols;
        if (64 * c + row < tl.rows) {
          const T val = *reinterpret_cast<const T*>(
              out + (col / 64) * kPanel + row * 128 +
              ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2);
          const int64_t dst =
              static_cast<int64_t>(tok[tl.row0 + 64 * c + row]);
          y[dst * F + n0 + col] = val;
        }
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
  }
}

// Tensor map over the contiguous [E, D, F] 2-byte weights of tensor-map
// type `type`, boxes of {64 F columns, 64 D rows, 1 expert}, 128-byte
// swizzle.
bool make_w_map(CUtensorMap* map, CUtensorMapDataType type, const void* w,
                int D, int F, int E) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(F) * 2,
                                 static_cast<cuuint64_t>(D) * F * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kBK), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(w), dims, strides, box,
                elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rows of x and w that are 16-byte multiples (D, F % 8 == 0) take TMA and
// 16-byte copies (whole K stages and panels, D and F % 64 == 0, without
// tail tests), other rows the narrow instance.
template <typename T>
int launch(const void* x, const void* w, const int* tok, const int* tiles,
           void* y, int D, int F, int E, int grid, cudaStream_t stream) {
  const bool narrow = D % 8 != 0 || F % 8 != 0;
  CUtensorMap tm{};  // unused by the narrow instance
  if (!narrow && !make_w_map(&tm, tma_type<T>(), w, D, F, E))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = narrow                           ? moe_gemm_sm90<T, kNarrow>
               : D % kBK == 0 && F % 64 == 0 ? moe_gemm_sm90<T, kExact>
                                               : moe_gemm_sm90<T, kTail>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, kSmem, stream>>>(
      tm, static_cast<const T*>(x), static_cast<const T*>(w), tok, tiles,
      static_cast<T*>(y), D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

}  // namespace

// The pre-pass alone: checks tok and eid (traps on a token or expert id out
// of range, or a repeated token) and writes the list of tiles of at most bm
// rows into `tiles` (int32: count, 3 zeros, then T records of (row0, rows,
// expert, 0), then the bitmap's ceil(T / 32) words).
REPRO_EXPORT int moe_tile_list_launch(const void* tok, const void* eid,
                                      void* tiles, int n_tokens,
                                      int n_experts, int bm, void* stream) {
  if (n_tokens < 1 || n_experts < 1 || bm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile_list(static_cast<const int*>(tok),
                          static_cast<const int*>(eid),
                          static_cast<int*>(tiles), n_tokens, n_experts, bm,
                          static_cast<cudaStream_t>(stream));
}

// Contract (checked by the Python wrapper): contiguous x [T, D], w [E, D,
// F], int32 tok and eid [T], int32 scratch tiles [4 + 4 T + ceil(T / 32)],
// y [T, F], of one dtype (a ReproDType: f32, bf16 or f16); D >= 1, F >= 1,
// 16-byte aligned x, w and y; bm, the rows of an M-tile, 128 for bf16 and
// f16 and 128 or 32 for f32; grid, the blocks of the
// persistent GEMM (plan.launch_shape: no more than fit on the card at
// once).  Two launches (three above 1 859 584 tokens): the pre-pass (which
// checks tok and eid on the card), then the grouped GEMM.
REPRO_EXPORT int moe_dispatch_launch(int dtype, const void* x, const void* w,
                                     const void* tok, const void* eid,
                                     void* tiles, void* y, int n_tokens, int D,
                                     int F, int n_experts, int bm, int grid,
                                     void* stream) {
  if (n_tokens == 0) return static_cast<int>(cudaSuccess);
  const bool f32 = dtype == REPRO_F32;
  if (n_tokens < 0 || D < 1 || F < 1 || n_experts < 1 || grid < 1 ||
      !(f32 || dtype == REPRO_BF16 || dtype == REPRO_F16) ||
      !(bm == 128 || (f32 && bm == f32k::Tiling<2>::kBM)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tk = static_cast<const int*>(tok);
  const int* tl = static_cast<const int*>(tiles);
  const int err = launch_tile_list(tk, static_cast<const int*>(eid),
                                   static_cast<int*>(tiles), n_tokens,
                                   n_experts, bm, s);
  if (err != 0) return err;
  if (dtype == REPRO_BF16)
    return sm90::launch<__nv_bfloat16>(x, w, tk, tl, y, D, F, n_experts,
                                       grid, s);
  if (dtype == REPRO_F16)
    return sm90::launch<__half>(x, w, tk, tl, y, D, F, n_experts, grid, s);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  return bm == 128
             ? f32k::launch_rows<8>(xf, wf, tk, tl, yf, D, F, grid, s)
             : f32k::launch_rows<2>(xf, wf, tk, tl, yf, D, F, grid, s);
}
