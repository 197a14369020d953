// Flash attention forward (GQA, optional causal mask) on Hopper.
//
// Replaces the Pallas kernel flash_attention of
// src/repro/kernels/flash_attention/kernel.py (pallas_call at :108), whose
// grid (b*h, n_q, n_kv) carries the online-softmax state (m, l, acc) in
// VMEM scratch across the sequential kv axis.  On Hopper blocks run in no
// order, so one block owns one (b*h, q tile) and loops the kv axis itself.
// Four kernels sit behind flash_attention_launch, chosen by dtype and head
// width.  Up to D = 256 the two tiled kernels below take every head width
// D % 8 == 0; above it the two wide kernels (after the tiled ones) deal
// the head's columns of O to blocks of at most 256: flash_fwd_wide (f32,
// up to 1024) as a thread-block cluster whose blocks each compute their
// part of S, summed through distributed shared memory, so S is computed
// once a step; flash_fwd_wide_sm90 (bf16, up to 512) as two blocks that
// each compute S over the whole head.  Each tiled kernel is built
// for four padded widths DP in {64, 128, 192, 256} and a launch at D runs
// the one for DP = D rounded up to a whole 64-column panel: the head is
// padded in shared memory alone, with zero columns D .. DP - 1, while
// every read and write of global memory stays at the real D.  The products
// skip what they can of the padding (S = Q K^T walks only the columns that
// hold D) and multiply zeros elsewhere (O += P V runs at DP); the output's
// padded columns are never written.  Each DP has two instances, chosen at launch:
// one for D = DP, compiled as a kernel of that fixed width, and one that
// takes D < DP at run time.
//
// bf16: flash_fwd_sm90, on the tensor cores.  Bound on the card:
// operations, 4*D flops per unmasked (query, key) pair at 989 TFLOP/s
// bf16 dense, against ~4*D bytes per query row: far above the H100's ~295
// bf16 flops per byte of HBM.  So the design feeds wgmma and keeps
// everything else off its path.  A block is three warpgroups for one
// 128-row q tile: a producer (registers cut to 24 by setmaxnreg) whose one
// thread issues TMA loads of the Q tile once and of 128-row K and V tiles
// through a ring of two stages (mbarrier full/empty pairs), and two
// consumers (registers raised to 240), each owning 64 q rows, the M of one
// wgmma.  Tiles land in 128-byte-swizzled shared memory straight from the
// [B*S, heads, D] layout (rank-3 tensor maps over the real D, box {64, 1,
// rows}; DP = 128 is two 64-column panels), so nothing is transposed; the
// box's columns past D lie outside the map, and TMA writes them as zeros.
// At DP 192 and 256 the K and V tiles hold 64 rows (plan.sm90_kv_rows).
// S = Q K^T is wgmma m64n128k16 (m64n64k16 on 64-row tiles), ceil(D/16)
// k-steps with both operands in shared memory and f32 accumulators; the
// online softmax runs in registers (a row lies across one quad, so its max
// and sum take two xor-shuffles), with scale * log2(e) folded into exp2f;
// O += P V is wgmma m64n{DP}k16 with P from registers and V read MN-major
// (transposed) from shared memory.  P goes in as two bf16 halves,
// hi = bf16(p) and lo = bf16(p - hi), two products into the same f32
// accumulator: one bf16 rounding of p puts an error of ~2^-9 of the
// output's rms on every element, up to 12.6x the tolerance against the f32
// plain version (tests/test_torch_flash_tiles.py), while the split leaves
// ~2^-17.  Causal q tiles are numbered heaviest first, and only the tile on
// the diagonal is masked.  The output is normalized, rounded to bf16,
// staged through the swizzled Q rows the consumer owns and written with
// 16-byte stores of its D real columns.
//
// f32: flash_fwd_kernel + flash_combine, on the CUDA cores, since one TF32
// pass would not hold the f32 tolerance.  Bound: operations, 4*D f32
// flops per unmasked pair at 67 TFLOP/s, so the design keeps the FMA pipe
// fed.  A block (8 warps) holds a 128-row q tile of one head (64 above
// DP = 128) and walks one range of the kv axis in 64-row chunks (32 above
// DP = 128; plan.f32_tiles) through a ring of 16-byte cp.async
// copies (2 stages at DP = 128, where shared memory holds no third; 3 at
// DP = 64), so the next chunk loads while one is computed, with one block
// barrier per chunk.  The copies move a row's D/4 real chunks; the places
// of the padded ones are zeroed once, before the first chunk.  Both
// products are outer-product register tiles fed by 128-bit shared-memory
// reads: S = Q K^T is 8 x 4 a thread (12 float4 reads per 128 FMAs) over
// the 32-column groups that hold D, O += P V is 8 x DP/16 (a float4 of V
// per 32 FMAs).
// Q, K and P rows are swizzled (16-byte chunk ^ a 3-bit row group), so the
// reads are conflict-free without padding, and a thread's rows share one
// swizzle, so its reads walk each row's chunks in a per-thread order with
// no index arithmetic in the loop.  The online softmax runs in registers
// in the log2 domain (scale * log2(e) folded into one multiply); a row lies
// on 16 lanes, so its max takes four xor-shuffles and its sum is reduced
// once at the end.  P passes to P V through rows of shared memory that only
// its warp reads (__syncwarp, no block barrier).  When the (b*h, q tile)
// grid would leave SMs idle, the kv axis is cut into ranges (plan.py: the
// main paths' one head and 1-2 q tiles become up to 264 blocks): each range
// writes f32 partials (m, l, unnormalized acc, at the real D) and
// flash_combine folds them in split order, with no atomics.  At full width
// (1280 blocks) one range writes the output itself.  Causal q tiles are
// numbered heaviest first.
//
// Semantics kept from the reference in both: scale D^-0.5 (the real D)
// applied to the dot; causal mask qpos >= kpos on absolute positions, with
// masked scores set to -1e30 (not -inf) and whole kv tiles above the
// diagonal skipped (ki*bk > qi*bq + bq - 1; the f32 kernel skips its chunks
// above the diagonal, which changes nothing: a masked score's p is exactly
// 0 once a row has seen key 0, and a range whose rows see only masked keys
// has m = -1e30 and weight 2^(-1e30 - M) = 0 in the combine); out = acc /
// max(l, 1e-30).  q is [B, Sq, H, D], k and v [B, Sk, G, D]; head h reads
// kv head h / (H/G).
//
// Every kernel takes any Sq, Sk >= 1 (the reference's mha computes every
// length; whisper-large-v3's encoder runs 1500 positions): the grid counts
// ceil(Sq / q tile) tiles and each block ceil(.. / kv tile) kv steps.  The
// rows of a partial tile past Sq or Sk load as zeros (f32: cp.async with a
// source size of 0, or zero stores; bf16: rank-4 tensor maps {D, heads, S,
// B}, whose rows past S are TMA's zero fill, counted in the mbarrier's
// bytes, never the next sequence's), the scores of kv rows past Sk are
// masked to -1e30 like those above the diagonal, and no output or partial
// row past Sq is stored.  The tail's tests are uniform branches taken on
// the last tiles alone, so whole tiles run as before.
#include "common.cuh"
#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and forms, clusters

namespace {

// The widest head the wide kernels take: a cluster of four blocks of 256
// columns (plan.MAX_HEAD_DIM, plan.WIDE_MAX_CLUSTER).
constexpr int kWideMaxD = 1024;

// The run of 64-column panels of O block `rank` of `n` owns out of the
// head's `n_dp`: contiguous, dealt evenly, the first ranks one more
// (plan.wide_panels).
__host__ __device__ inline void wide_run(int n_dp, int n, int rank, int& p0,
                                         int& np) {
  const int base = n_dp / n, extra = n_dp % n;
  p0 = rank * base + (rank < extra ? rank : extra);
  np = base + (rank < extra ? 1 : 0);
}

// The run of Q and K panels (its part of S) block `rank` of an f32 cluster
// owns: dealt the other way round, the last ranks one more
// (plan.wide_s_panels), so a block's S and O columns add up evenly.
__host__ __device__ inline void wide_s_run(int n_dp, int n, int rank,
                                           int& p0, int& np) {
  const int base = n_dp / n, extra = n_dp % n;
  const int first = n - extra;  // the first rank with one more
  p0 = rank * base + (rank > first ? rank - first : 0);
  np = base + (rank >= first ? 1 : 0);
}

// Launch `kern` on `grid` as thread-block clusters of (1, 1, n) blocks
// (grid.z == n).  A cluster the card cannot hold at once
// (cudaOccupancyMaxActiveClusters 0: n SMs of one GPC with `smem` bytes
// free) is refused with cudaErrorInvalidConfiguration, never run.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kern)(KArgs...), dim3 grid, int threads,
                           int smem, int n, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel, split-KV
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTY = 16;        // row groups: kThreads / kTX
constexpr int kTX = 16;        // lanes that share a score row
constexpr float kLog2e = 1.4426950408889634f;

// Score and output rows a thread holds, and score columns, at padded width
// DP: 8 x 4 up to DP = 128 (a 128-row q tile, 64-row kv chunks); 4 x 2
// above, where a 128-row Q tile alone would take 96 KB or more and 8 rows
// of DP/16 output float4s would not fit in registers (a 64-row q tile,
// 32-row kv chunks).  plan.f32_tiles mirrors these.
template <int DP>
__host__ __device__ constexpr int rows_a_thread() {
  return DP > 128 ? 4 : 8;
}
template <int DP>
__host__ __device__ constexpr int cols_a_thread() {
  return DP > 128 ? 2 : 4;
}
template <int DP>
__host__ __device__ constexpr int block_q() {  // q rows a block holds
  return kTY * rows_a_thread<DP>();
}
template <int DP>
__host__ __device__ constexpr int block_k() {  // kv rows a ring stage holds
  return kTX * cols_a_thread<DP>();
}

// A ring of 3 stages where shared memory holds one (DP = 64), else 2.
template <int DP>
__host__ __device__ constexpr int stages() {
  return DP == 64 ? 3 : 2;
}

template <int DP>
__host__ __device__ constexpr int smem_floats() {
  return block_q<DP>() * DP                       // Q tile
         + 2 * stages<DP>() * block_k<DP>() * DP  // K and V rings
         + block_q<DP>() * block_k<DP>();         // P, each warp's rows its own
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
// The same copy of a row that may lie past the sequence's end: with
// `valid` false no byte is read and the 16 bytes land as zeros (src-size
// 0), so `gmem` need only be some valid address.  A row's validity is one
// compare and a select beside each copy.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The place of 16-byte chunk c in shared row r: with G > 0 the chunks of
// row r are stored in the order c ^ ((r / G) % 8), so the rows a warp reads
// at one d (or k) fall in distinct bank groups, with no padding.  A
// thread's own rows share one swizzle, so its reads walk the 8 chunks of
// each 32 floats in the order u ^ f for a per-thread f, without index
// arithmetic in the loop.  The swizzle permutes chunks within groups of 8.
template <int G>
__device__ __forceinline__ int swizzled(int r, int c) {
  return G ? c ^ ((r / (G ? G : 1)) & 7) : c;
}

// kRows rows of D floats lying `stride` floats apart in global memory, into
// shared rows of DP floats: only the d4 = D / 4 real chunks of a row are
// copied; the places of the others hold zeros (zero_pad).  Rows `valid`
// .. kRows - 1 (past the sequence's end, in its last tile) land as zeros:
// one code path for every tile, the copy's source size 0 for those rows.
template <int DP, int G, int kRows>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int d4, int tid,
                                          int valid) {
  constexpr int kChunks = DP / 4;
  static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
    const int e = n * kThreads + tid;
    const int r = e / kChunks, c = e % kChunks;
    if (c < d4)
      cp_async16_zfill(dst + r * DP + 4 * swizzled<G>(r, c),
                       src + (r < valid ? r : 0) * stride + 4 * c,
                       r < valid);
  }
}

// Zero the places of chunks d4 .. DP/4 - 1 of kRows shared rows of DP
// floats, once before the first load: no copy writes them.  Where D % 32
// != 0 the swizzle puts a row's padded chunks at places that depend on the
// row, so the place p of a row is zeroed where the chunk stored there,
// p ^ its swizzle, lies past the real ones.
template <int DP, int G, int kRows>
__device__ __forceinline__ void zero_pad(float* dst, int d4, int tid) {
  constexpr int kChunks = DP / 4;
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, p = e % kChunks;
    if (swizzled<G>(r, p) >= d4)
      *reinterpret_cast<float4*>(dst + r * DP + 4 * p) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One block: a kBQ-row q tile of one (b, h) against kv rows
// [kv0, kv0 + per_split) of split `split`, in kBK-row chunks (128 and 64
// up to DP = 128), at head width D <= DP.  Thread (ty, tx) = (tid / 16,
// tid % 16) holds score rows kRQ ty..kRQ ty + kRQ - 1 against chunk columns
// kCols tx..kCols tx + kCols - 1, and output rows kRQ ty.. at columns
// 4tx + 64j (+0..3), of which those below D are written.
// A row's scores lie on the 16 lanes of one ty, so its max
// takes four xor-shuffles; its sum is kept as a lane's share and reduced
// once at the end.  Scores are taken in the log2 domain (scale * log2(e)
// folded into one multiply), p = exp2(x - m).  Each DP has two instances:
// without kPadded, D is DP and the code is that of a kernel built for D
// alone (the run-time D cost 2.9% at D 256, PERF.md); with it, D < DP comes
// at run time.
template <int DP, bool kPadded>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ part, int Sq, int Sk, int H, int G,
                 int d_arg, int causal, float scale_log2, int per_split,
                 int n_splits) {
  const int D = kPadded ? d_arg : DP;
  constexpr int kStages = stages<DP>();
  constexpr int kRQ = rows_a_thread<DP>();
  constexpr int kCols = cols_a_thread<DP>();
  constexpr int kBQ = block_q<DP>();
  constexpr int kBK = block_k<DP>();
  constexpr int OC = DP / (4 * kTX);  // float4 output columns a thread holds
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kStages * kBK * DP;
  float* sP = sV + kStages * kBK * DP;

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int r0 = kRQ * ty;   // first row this thread holds
  const int fq = ty & 7;     // swizzle of its Q and P rows
  const int fk = tx & 7;     // swizzle of its K rows (4tx..4tx+3)
  const int n_q = (Sq + kBQ - 1) / kBQ;  // the last tile may be partial
  const int split = blockIdx.x % n_splits;
  const int tile = blockIdx.x / n_splits;
  const int qi = causal ? n_q - 1 - tile : tile;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int q0 = qi * kBQ;
  const int kv0 = split * per_split;
  int kv1 = min(Sk, kv0 + per_split);
  if (causal) kv1 = min(kv1, q0 + kBQ);  // chunks wholly above the diagonal
  const int n_chunks = kv1 > kv0 ? (kv1 - kv0 + kBK - 1) / kBK : 0;
  const int d4 = D / 4;      // real 16-byte chunks of a row

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(G) * D;
  const float* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * Sk * G + g) * D;
  const float* vb = v + (static_cast<int64_t>(b) * Sk * G + g) * D;

  if (kPadded) {
    zero_pad<DP, kRQ, kBQ>(sQ, d4, tid);
    for (int st = 0; st < kStages; ++st) {
      zero_pad<DP, kCols, kBK>(sK + st * kBK * DP, d4, tid);
      zero_pad<DP, 0, kBK>(sV + st * kBK * DP, d4, tid);
    }
  }
  // A chunk or q tile past the sequence's end loads its missing rows as
  // zeros; their scores are masked below and their outputs never stored.
  auto load_chunk = [&](int c) {
    const int st = c % kStages;
    const int k0 = kv0 + c * kBK;
    const int64_t off = static_cast<int64_t>(k0) * kv_stride;
    load_rows<DP, kCols, kBK>(sK + st * kBK * DP, kb + off, kv_stride, d4,
                              tid, Sk - k0);
    load_rows<DP, 0, kBK>(sV + st * kBK * DP, vb + off, kv_stride, d4, tid,
                          Sk - k0);
  };
  if (n_chunks > 0) {
    load_rows<DP, kRQ, kBQ>(sQ, qb + q0 * q_stride, q_stride, d4, tid,
                            Sq - q0);
    load_chunk(0);
  }
  cp_async_commit();
#pragma unroll
  for (int c = 1; c < kStages - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    cp_async_commit();
  }

  float m[kRQ], l[kRQ], acc[kRQ][4 * OC];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * OC; ++j) acc[i][j] = 0.f;
  }
  const float* qrow = sQ + r0 * DP;
  float* prow = sP + r0 * kBK;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();               // ... everyone's; chunk c-1 consumed
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1);
    cp_async_commit();

    const float* krow = sK + (c % kStages) * kBK * DP + kCols * tx * DP;
    const float* vrow = sV + (c % kStages) * kBK * DP + 4 * tx;
    const int k0 = kv0 + c * kBK;

    // S = Q K^T: kRQ x kCols a thread (8 x 4: 12 float4 reads per 128
    // FMAs), over the 32-column groups that hold real columns (the padded
    // chunks of the last one are zeros in Q and K).
    float s[kRQ][kCols];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int d8 = 0; d8 < D; d8 += 32) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float4 qv[kRQ], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qrow + i * DP + d8 +
                                                   4 * (u ^ fq));
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          kv[j] = *reinterpret_cast<const float4*>(krow + j * DP + d8 +
                                                   4 * (u ^ fk));
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
    }

    // Online softmax in registers; P to the warp's rows of sP.  Scores
    // above the diagonal, or of kv rows past Sk (the last chunk's), are
    // masked.
    const bool mask = causal && k0 + kBK - 1 > q0;
    const bool tail = k0 + kBK > Sk;
    float alpha[kRQ];
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * scale_log2;
        if (mask && q0 + r0 + i < k0 + kCols * tx + j) x = REPRO_NEG_INF;
        if (tail && k0 + kCols * tx + j >= Sk) x = REPRO_NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTX; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = exp2f(m[i] - m_new);
      // columns kCols tx.. of P row r0 + i, their 16-byte chunk swizzled
      // like the Q rows
      float* pdst = prow + i * kBK + 4 * (((kCols * tx) / 4) ^ fq) +
                    (kCols * tx) % 4;
      if constexpr (kCols == 4) {
        float4 p;
        p.x = exp2f(s[i][0] - m_new);
        p.y = exp2f(s[i][1] - m_new);
        p.z = exp2f(s[i][2] - m_new);
        p.w = exp2f(s[i][3] - m_new);
        l[i] = l[i] * alpha[i] + ((p.x + p.y) + (p.z + p.w));
        *reinterpret_cast<float4*>(pdst) = p;
      } else {
        float2 p;
        p.x = exp2f(s[i][0] - m_new);
        p.y = exp2f(s[i][1] - m_new);
        l[i] = l[i] * alpha[i] + (p.x + p.y);
        *reinterpret_cast<float2*>(pdst) = p;
      }
      m[i] = m_new;
    }
    __syncwarp();

    // O = O * alpha + P V: kRQ x 4*OC a thread; per k, OC float4 reads of
    // V for 4 kRQ OC FMAs, and per 4 k, kRQ float4 reads of P.  Columns
    // past D multiply the zeros of V's padding and are never written.
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < 4 * OC; ++j) acc[i][j] *= alpha[i];
#pragma unroll 1
    for (int k8 = 0; k8 < kBK; k8 += 32) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float4 pv[kRQ];
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
          pv[i] = *reinterpret_cast<const float4*>(prow + i * kBK + k8 +
                                                   4 * (u ^ fq));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vk = vrow + (k8 + 4 * u + kk) * DP;
#pragma unroll
          for (int jj = 0; jj < OC; ++jj) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vk + 4 * kTX * jj);
#pragma unroll
            for (int i = 0; i < kRQ; ++i) {
              const float p = kk == 0 ? pv[i].x
                              : kk == 1 ? pv[i].y
                              : kk == 2 ? pv[i].z
                                        : pv[i].w;
              acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
              acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
              acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
              acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
            }
          }
        }
      }
    }
    __syncwarp();  // P read before the next chunk rewrites it
  }
  cp_async_wait<0>();

  // A row's sum: the 16 lanes' shares.
#pragma unroll
  for (int i = 0; i < kRQ; ++i)
#pragma unroll
    for (int off = 1; off < kTX; off *= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  // Output row index (b*Sq + q)*H + h, as in o's [B, Sq, H, D] layout;
  // rows past Sq (the last q tile's) are not stored.
  const int64_t row0 = (static_cast<int64_t>(b) * Sq + q0 + r0) * H + h;
  if (n_splits == 1) {
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      float* orow = o + (row0 + static_cast<int64_t>(i) * H) * D + 4 * tx;
#pragma unroll
      for (int jj = 0; jj < OC; ++jj)
        if (4 * tx + 4 * kTX * jj < D && q0 + r0 + i < Sq)
          *reinterpret_cast<float4*>(orow + 4 * kTX * jj) =
              make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                          acc[i][4 * jj + 2] * inv, acc[i][4 * jj + 3] * inv);
    }
    return;
  }
  // Partials of this split at the real D: acc [n_splits][rows][D], then
  // (m, l) pairs [n_splits][rows][2].  A split with no chunk leaves
  // m = -1e30, l = 0, acc = 0, which the combine weighs by
  // exp2(-1e30 - M) = 0.
  const int64_t rows = static_cast<int64_t>(gridDim.y / H) * Sq * H;
  float* pacc = part + split * rows * D;
  float* pml = part + n_splits * rows * D + split * rows * 2;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    if (q0 + r0 + i >= Sq) continue;
    const int64_t r = row0 + static_cast<int64_t>(i) * H;
    float* arow = pacc + r * D + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < OC; ++jj)
      if (4 * tx + 4 * kTX * jj < D)
        *reinterpret_cast<float4*>(arow + 4 * kTX * jj) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1],
                        acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
    if (tx == 0)
      *reinterpret_cast<float2*>(pml + 2 * r) = make_float2(m[i], l[i]);
  }
}

// Fold the splits' partials of every output row (rows < Sq alone: B*Sq*H)
// in split order:
// M = max m_s, L = sum l_s 2^(m_s - M),
// out = sum acc_s 2^(m_s - M) / max(L, 1e-30).  One thread a float4 of one
// row; no atomics, so the result is the same from run to run.
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ part, float* __restrict__ o,
              int64_t rows, int D, int n_splits) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * (D / 4)) return;
  const int64_t r = e / (D / 4);
  const int c = static_cast<int>(e % (D / 4)) * 4;
  const float* pml = part + n_splits * rows * D;
  float big_m = REPRO_NEG_INF;
  for (int s = 0; s < n_splits; ++s)
    big_m = fmaxf(big_m, pml[(s * rows + r) * 2]);
  float big_l = 0.f;
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_splits; ++s) {
    const float2 ml =
        *reinterpret_cast<const float2*>(pml + (s * rows + r) * 2);
    const float w = exp2f(ml.x - big_m);
    big_l += ml.y * w;
    const float4 a =
        *reinterpret_cast<const float4*>(part + (s * rows + r) * D + c);
    out.x += a.x * w;
    out.y += a.y * w;
    out.z += a.z * w;
    out.w += a.w * w;
  }
  const float inv = 1.f / fmaxf(big_l, 1e-30f);
  *reinterpret_cast<float4*>(o + r * D + c) =
      make_float4(out.x * inv, out.y * inv, out.z * inv, out.w * inv);
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o,
           float* part, int B, int Sq, int Sk, int H, int G, int D, int causal,
           float scale, int per_split, int n_splits, cudaStream_t stream) {
  constexpr int kBQ = block_q<DP>();
  constexpr int kBK = block_k<DP>();
  if (D > DP || DP - D >= 64 || Sq < 1 || Sk < 1 || per_split <= 0 ||
      per_split % kBK ||
      n_splits != (Sk + per_split - 1) / per_split ||
      (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_floats<DP>() * static_cast<int>(sizeof(float));
  auto* kern = D == DP ? flash_fwd_kernel<DP, false>
                       : flash_fwd_kernel<DP, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((Sq + kBQ - 1) / kBQ) * n_splits, B * H);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, part, Sq, Sk, H, G, D,
                                         causal, scale * kLog2e, per_split,
                                         n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  const int64_t threads = rows * (D / 4);
  flash_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                  stream>>>(part, o, rows, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32, D above 256: flash_fwd_wide
// ---------------------------------------------------------------------------
//
// A thread of flash_fwd_kernel<256> holds 4 rows x 64 output columns; at
// D = 512 that would be 128 accumulators beside the scores, past the
// register file, and the block's 64-row Q tile alone takes 128 KB.  So the
// head is split across a thread-block cluster of ceil(DP / 256) blocks
// along the grid's z (launch_cluster), each owning two contiguous runs of
// at most four 64-column panels: one of O and V (wide_run,
// plan.wide_panels: 3 + 2 at D 320) and one of Q and K dealt the other way
// round (wide_s_run, plan.wide_s_panels: 2 + 3), so that no block's share
// of a step's products exceeds another's by more than a panel's.  Block r
// loads its own columns of Q (64 rows, swizzled as flash_fwd_kernel's), K
// and V and no others.  Each 32-row kv step it computes its partial S_r
// over its Q and K columns (4 x 2 a thread), writes it to its exchange
// slot (double-buffered), and after one cluster barrier reads every
// block's partial through distributed shared memory, its own from
// registers, summing S_0 + S_1 + ... in rank order: every block holds the
// same S, m and l, and S is computed once a step.  The barrier costs ~1 us
// a step at two blocks (scripts/cluster_exchange.py); computing S_r a step
// ahead, so that it runs under the softmax and P V, ran 1-2% slower
// (PERF.md).  K and V pass through one ring of 16 KB units, each 32 kv rows
// of two 64-column panels of the block's K or V, one block barrier a unit;
// the ring keeps kWideSlots - 1 units in flight.  Each copy moves the real
// 16-byte chunks of a unit's rows (those below D and in the block's run)
// and zeroes the places of the others.  The split plan, the partials (at
// the real D, (m, l) written by rank 0) and flash_combine are
// flash_fwd_kernel's; every block of a cluster shares (b*h, q tile, kv
// range), so all walk the same steps (none, in a causal range above the
// diagonal), and a last cluster barrier keeps each block's slots alive
// until its peers have read them.
constexpr int kWideRQ = 4;     // score and output rows a thread holds
constexpr int kWideCols = 2;   // score columns a thread holds
constexpr int kWideBQ = kTY * kWideRQ;    // 64 q rows a block
constexpr int kWideBK = kTX * kWideCols;  // 32 kv rows a step
constexpr int kWideSlots = 4;  // ring slots (plan.WIDE_F32_SLOTS)
constexpr int kWideVPanels = 4;   // most 64-column panels a block holds
constexpr int kUnitCols = 128;    // columns of a unit: two panels
constexpr int kUnit = kWideBK * kUnitCols;  // floats of a unit: 32 x 128
constexpr int kXSlot = kWideBQ * kWideBK;   // floats of one partial S

// Shared memory at `cols` columns a block (the widest block's: every block
// of a cluster lays its buffers out alike, so a peer's slot lies at the
// same offset): the exchange slots, P, the ring, the Q columns.
__host__ __device__ constexpr int wide_smem_floats(int cols) {
  return 2 * kXSlot + kWideBQ * kWideBK + kWideSlots * kUnit + kWideBQ * cols;
}

// P V for one ring unit: its kHalves panels (two, or one at the end of an
// odd run; a run holds two at least) add into accumulators 4jj .. 4jj + 3
// of each row, jj = 2uu + half.
template <int kHalves, int uu>
__device__ __forceinline__ void wide_pv_unit(
    float (&acc)[kWideRQ][4 * kWideVPanels], const float* prow,
    const float* vrow, int fq) {
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    float4 pv[kWideRQ];
#pragma unroll
    for (int i = 0; i < kWideRQ; ++i)
      pv[i] = *reinterpret_cast<const float4*>(prow + i * kWideBK +
                                               4 * (w ^ fq));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < kHalves; ++half) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vrow + (4 * w + kk) * kUnitCols + 64 * half);
        const int jj = 2 * uu + half;
#pragma unroll
        for (int i = 0; i < kWideRQ; ++i) {
          const float p = kk == 0 ? pv[i].x
                          : kk == 1 ? pv[i].y
                          : kk == 2 ? pv[i].z
                                    : pv[i].w;
          acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// grid ((Sq/64) * n_splits, B*H, cluster) in clusters of (1, 1, cluster);
// one instance, D at run time.
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ part, int Sq, int Sk, int H, int G, int D,
               int causal, float scale_log2, int per_split, int n_splits) {
  const int n_dp = (D + 63) / 64;      // 64-column panels of the head
  const int n_cl = gridDim.z;          // blocks of the cluster
  const int rank = static_cast<int>(sm90::cluster_rank());
  int p0, np, p0k, npk;  // this block's runs of O (V) and of S (Q, K) panels
  wide_run(n_dp, n_cl, rank, p0, np);
  wide_s_run(n_dp, n_cl, rank, p0k, npk);
  const int c0 = 64 * p0;                // its first column of O and V
  const int v_end = min(D, c0 + 64 * np);  // ... its last real one + 1
  const int c0k = 64 * p0k;              // its first column of Q and K
  const int cols = 64 * npk;             // ... how many (a Q row's floats)
  const int k_end = min(D, c0k + cols);  // ... its last real one + 1
  const int n_kp = (npk + 1) / 2;        // ring units of K a step
  const int n_vp = (np + 1) / 2;         // ... and of V
  const int per_step = n_kp + n_vp;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                    // [2 stages][2][256 threads] float4
  float* sP = sX + 2 * kXSlot;
  float* sRing = sP + kWideBQ * kWideBK;
  float* sQ = sRing + kWideSlots * kUnit;

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int r0 = kWideRQ * ty;  // first row this thread holds
  const int fq = ty & 7;        // swizzle of its Q and P rows
  const int fk = tx & 7;        // swizzle of its K rows (2tx, 2tx + 1)
  const int n_q = (Sq + kWideBQ - 1) / kWideBQ;  // the last may be partial
  const int split = blockIdx.x % n_splits;
  const int tile = blockIdx.x / n_splits;
  const int qi = causal ? n_q - 1 - tile : tile;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int q0 = qi * kWideBQ;
  const int kv0 = split * per_split;
  int kv1 = min(Sk, kv0 + per_split);
  if (causal) kv1 = min(kv1, q0 + kWideBQ);  // steps wholly above the diagonal
  // Every rank of the cluster shares (q tile, kv range), so all take the
  // same steps and cluster barriers, the ragged last one included.
  const int n_steps = kv1 > kv0 ? (kv1 - kv0 + kWideBK - 1) / kWideBK : 0;
  const int n_units = n_steps * per_step;

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(G) * D;
  const float* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * Sk * G + g) * D;
  const float* vb = v + (static_cast<int64_t>(b) * Sk * G + g) * D;

  // Unit u: step u / per_step; K pair r < n_kp of it, else V pair
  // r - n_kp, into ring slot u % kWideSlots.  K rows are swizzled as
  // flash_fwd_kernel's (kWideCols rows share one), V rows are not.  Rows
  // past Sk (the last step's) are zeros, as the columns past D are.
  auto load_unit = [&](int u) {
    const int st = u / per_step, r = u % per_step;
    const bool is_k = r < n_kp;
    const int col0 = is_k ? c0k + kUnitCols * r : c0 + kUnitCols * (r - n_kp);
    const int end = is_k ? k_end : v_end;
    const int real = (end - col0) / 4;  // real chunks of a row (>= 2)
    const int rows = Sk - (kv0 + st * kWideBK);  // real rows (>= 1)
    const float* src = (is_k ? kb : vb) +
                       (kv0 + static_cast<int64_t>(st) * kWideBK) * kv_stride +
                       col0;
    float* dst = sRing + (u % kWideSlots) * kUnit;
#pragma unroll
    for (int n = 0; n < kUnit / 4 / kThreads; ++n) {
      const int e = n * kThreads + tid;
      const int rr = e / 32, c = e % 32;
      float* d = dst + rr * kUnitCols +
                 4 * (is_k ? swizzled<kWideCols>(rr, c) : c);
      if (c < real && rr < rows)
        cp_async16(d, src + rr * kv_stride + 4 * c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (n_units > 0) {
    // The block's Q columns: real chunks a row, zeros past D.
    for (int e = tid; e < kWideBQ * (cols / 4); e += kThreads) {
      const int r = e / (cols / 4), c = e % (cols / 4);
      float* d = sQ + r * cols + 4 * swizzled<kWideRQ>(r, c);
      if (c0k + 4 * c < D && q0 + r < Sq)
        cp_async16(d, qb + (q0 + r) * q_stride + c0k + 4 * c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    load_unit(0);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 1; u < kWideSlots - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }
  // Unit u has landed for every thread, unit u - 1 is consumed: its slot
  // takes unit u + kWideSlots - 1.
  auto ring_next = [&](int u) {
    cp_async_wait<kWideSlots - 2>();
    __syncthreads();
    if (u + kWideSlots - 1 < n_units) load_unit(u + kWideSlots - 1);
    cp_async_commit();
  };

  float m[kWideRQ], l[kWideRQ], acc[kWideRQ][4 * kWideVPanels];
#pragma unroll
  for (int i = 0; i < kWideRQ; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kWideVPanels; ++j) acc[i][j] = 0.f;
  }
  const float* qrow = sQ + r0 * cols;
  float* prow = sP + r0 * kWideBK;

  int u = 0;
  for (int st = 0; st < n_steps; ++st) {
    const int k0 = kv0 + st * kWideBK;
    // S_r = Q K^T over this block's columns, 4 x 2 a thread, over the
    // 32-column groups of each unit that hold real columns.
    float s[kWideRQ][kWideCols];
#pragma unroll
    for (int i = 0; i < kWideRQ; ++i)
#pragma unroll
      for (int j = 0; j < kWideCols; ++j) s[i][j] = 0.f;
    for (int pr = 0; pr < n_kp; ++pr, ++u) {
      ring_next(u);
      const float* krow =
          sRing + (u % kWideSlots) * kUnit + kWideCols * tx * kUnitCols;
      const float* qp = qrow + kUnitCols * pr;
      const int real = min(kUnitCols, k_end - c0k - kUnitCols * pr);
#pragma unroll 1
      for (int d8 = 0; d8 < real; d8 += 32) {
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          float4 qv[kWideRQ], kv[kWideCols];
#pragma unroll
          for (int i = 0; i < kWideRQ; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qp + i * cols + d8 +
                                                     4 * (w ^ fq));
#pragma unroll
          for (int j = 0; j < kWideCols; ++j)
            kv[j] = *reinterpret_cast<const float4*>(krow + j * kUnitCols +
                                                     d8 + 4 * (w ^ fk));
#pragma unroll
          for (int i = 0; i < kWideRQ; ++i)
#pragma unroll
            for (int j = 0; j < kWideCols; ++j) {
              s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
              s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
              s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
              s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
            }
        }
      }
    }

    // The exchange: publish S_r in slot st % 2 (thread tid's 8 floats at
    // float4s tid and 256 + tid), one cluster barrier, then S = S_0 + S_1
    // + ... in rank order, the peers' partials read through distributed
    // shared memory.  A slot is written again two steps later, after every
    // block has passed the next step's barrier, so after its reads.
    {
      float4* mine = reinterpret_cast<float4*>(sX) + (st & 1) * 512 + tid;
      const float own[8] = {s[0][0], s[0][1], s[1][0], s[1][1],
                            s[2][0], s[2][1], s[3][0], s[3][1]};
      mine[0] = make_float4(own[0], own[1], own[2], own[3]);
      mine[256] = make_float4(own[4], own[5], own[6], own[7]);
      sm90::cluster_arrive();
      sm90::cluster_wait();
      const uint32_t addr = sm90::smem_u32(mine);
      float sum[8];
      for (int p = 0; p < n_cl; ++p) {
        float vals[8];
        if (p == rank) {
#pragma unroll
          for (int i = 0; i < 8; ++i) vals[i] = own[i];
        } else {
          const uint32_t peer = sm90::cluster_addr(addr, p);
          const float4 a = sm90::ld_cluster_f4(peer);
          const float4 c = sm90::ld_cluster_f4(peer + 256 * 16);
          vals[0] = a.x, vals[1] = a.y, vals[2] = a.z, vals[3] = a.w;
          vals[4] = c.x, vals[5] = c.y, vals[6] = c.z, vals[7] = c.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sum[i] = p == 0 ? vals[i] : sum[i] + vals[i];
      }
#pragma unroll
      for (int i = 0; i < kWideRQ; ++i)
#pragma unroll
        for (int j = 0; j < kWideCols; ++j) s[i][j] = sum[2 * i + j];
    }

    // Online softmax in registers; P to the warp's rows of sP (read after
    // the next unit's block barrier).  Scores above the diagonal, or of kv
    // rows past Sk, are masked.
    const bool mask = causal && k0 + kWideBK - 1 > q0;
    const bool tail = k0 + kWideBK > Sk;
    float alpha[kWideRQ];
#pragma unroll
    for (int i = 0; i < kWideRQ; ++i) {
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < kWideCols; ++j) {
        float x = s[i][j] * scale_log2;
        if (mask && q0 + r0 + i < k0 + kWideCols * tx + j) x = REPRO_NEG_INF;
        if (tail && k0 + kWideCols * tx + j >= Sk) x = REPRO_NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTX; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = exp2f(m[i] - m_new);
      float2 pp;
      pp.x = exp2f(s[i][0] - m_new);
      pp.y = exp2f(s[i][1] - m_new);
      l[i] = l[i] * alpha[i] + (pp.x + pp.y);
      *reinterpret_cast<float2*>(prow + i * kWideBK +
                                 4 * (((kWideCols * tx) / 4) ^ fq) +
                                 (kWideCols * tx) % 4) = pp;
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kWideRQ; ++i)
#pragma unroll
      for (int j = 0; j < 4 * kWideVPanels; ++j) acc[i][j] *= alpha[i];

    // O += P V, one unit of two V panels at a time: panel jj of the block
    // adds into accumulators 4jj .. 4jj + 3 of each row (columns
    // c0 + 64 jj + 4tx ..).
    ring_next(u);
    {
      const float* vrow = sRing + (u % kWideSlots) * kUnit + 4 * tx;
      wide_pv_unit<2, 0>(acc, prow, vrow, fq);  // np >= 2 (wide_run)
      ++u;
    }
    if (n_vp > 1) {
      ring_next(u);
      const float* vrow = sRing + (u % kWideSlots) * kUnit + 4 * tx;
      if (np >= 4)
        wide_pv_unit<2, 1>(acc, prow, vrow, fq);
      else
        wide_pv_unit<1, 1>(acc, prow, vrow, fq);
      ++u;
    }
  }
  cp_async_wait<0>();
  sm90::cluster_arrive();  // this block's reads of its peers' slots are done

#pragma unroll
  for (int i = 0; i < kWideRQ; ++i)
#pragma unroll
    for (int off = 1; off < kTX; off *= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  const int64_t row0 = (static_cast<int64_t>(b) * Sq + q0 + r0) * H + h;
  const int64_t rows = static_cast<int64_t>(gridDim.y / H) * Sq * H;
  float* pacc = part + split * rows * D;  // unused with one split
#pragma unroll
  for (int i = 0; i < kWideRQ; ++i) {
    if (q0 + r0 + i >= Sq) continue;  // a row past Sq: not stored
    const int64_t r = row0 + static_cast<int64_t>(i) * H;
    const float inv = n_splits == 1 ? 1.f / fmaxf(l[i], 1e-30f) : 1.f;
    float* orow = (n_splits == 1 ? o : pacc) + r * D;
#pragma unroll
    for (int jj = 0; jj < kWideVPanels; ++jj) {
      const int col = c0 + 64 * jj + 4 * tx;
      if (jj < np && col < D)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                        acc[i][4 * jj + 2] * inv, acc[i][4 * jj + 3] * inv);
    }
    if (n_splits > 1 && rank == 0 && tx == 0)
      *reinterpret_cast<float2*>(part + n_splits * rows * D +
                                 (split * rows + r) * 2) =
          make_float2(m[i], l[i]);
  }
  sm90::cluster_wait();  // ... and every peer's of this block's slots
}

int launch_wide(const float* q, const float* k, const float* v, float* o,
                float* part, int B, int Sq, int Sk, int H, int G, int D,
                int causal, float scale, int per_split, int n_splits,
                cudaStream_t stream) {
  if (D <= 256 || D > kWideMaxD || Sq < 1 || Sk < 1 ||
      per_split <= 0 || per_split % kWideBK ||
      n_splits != (Sk + per_split - 1) / per_split ||
      (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_dp = (D + 63) / 64;
  const int n_cl = (n_dp + kWideVPanels - 1) / kWideVPanels;
  const int cols_max = 64 * ((n_dp + n_cl - 1) / n_cl);
  const int smem = wide_smem_floats(cols_max) * static_cast<int>(sizeof(float));
  const dim3 grid(((Sq + kWideBQ - 1) / kWideBQ) * n_splits, B * H, n_cl);
  cudaError_t err = launch_cluster(
      flash_fwd_wide, grid, kThreads, smem, n_cl, stream, q, k, v, o, part,
      Sq, Sk, H, G, D, causal, scale * kLog2e, per_split, n_splits);
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  const int64_t threads = rows * (D / 4);
  flash_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                  stream>>>(part, o, rows, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32


// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (sm_90a)
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int kBQ = 128;           // q rows a block owns (two consumers x 64)
constexpr int kStages = 2;         // K/V ring depth
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kQPanel = kBQ * 128; // one 64-column panel of the Q tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block at padded width DP with BK-row K and V
// tiles: BK = 128 up to DP = 128; at DP = 192 and 256 two stages of 128-row
// K and V tiles and the Q tile would not fit the 227 KB a block may use, so
// BK = 64 (plan.sm90_kv_rows picks it from the same sum).
template <int DP, int BK>
__host__ __device__ constexpr int smem_bytes() {
  return 1024                           // alignment slack
         + kBQ * DP * 2                 // Q
         + 2 * kStages * BK * DP * 2    // K ring, V ring
         + 8 * (1 + 3 * kStages);       // mbarriers
}

// S (+)= Q K^T for one 16-column k-step: m64n{BK}k16, both from shared
// memory; k-step 0 overwrites S.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&sc)[BK / 2], uint64_t da,
                                         uint64_t db, int kk) {
  if constexpr (BK == 128) {
    if (kk == 0)
      wgmma_ss_n128_init(sc, da, db);
    else
      wgmma_ss_n128(sc, da, db);
  } else {
    wgmma_ss_n64(sc, da, db, kk != 0);
  }
}

// O += P V for one 16-row k-step: m64n{DP}k16, P from registers.
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&acc)[DP / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (DP == 256)
    wgmma_rs_n256(acc, a, db, 1);
  else if constexpr (DP == 192)
    wgmma_rs_n192(acc, a, db, 1);
  else if constexpr (DP == 128)
    wgmma_rs_n128(acc, a, db, 1);
  else
    wgmma_rs_n64(acc, a, db, 1);
}

// grid (B*H, Sq/128): blockIdx.x is the head, blockIdx.y the q tile.  The
// head width D (D % 8 == 0) ends in the last of the DP / 64 panels; TMA
// fills its columns D .. DP - 1 with zeros.  Each DP has two instances:
// without kPadded, D is DP and the code is that of a kernel built for D
// alone (one kernel holding both paths ran 1.4-5% slower at D 64 and 128,
// PERF.md); with it, D < DP comes at run time.
template <int DP, int BK, bool kPadded>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int G,
               int d_arg, int causal, float scale_log2) {
  const int D = kPadded ? d_arg : DP;
  constexpr int kPanels = DP / 64;
  constexpr int kQTile = kBQ * DP * 2;  // whole boxes, zero fill included
  constexpr int kKVTile = BK * DP * 2;
  constexpr int kKVPanel = BK * 128;  // one 64-column panel of a K/V tile
  constexpr int kAcc = DP / 2;  // f32 accumulators a thread holds for 64 x DP
  constexpr int kSc = BK / 2;  // ... for the 64 x BK scores
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + kQTile;
  uint8_t* sV = sK + kStages * kKVTile;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + kStages * kKVTile);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int n_q = (Sq + kBQ - 1) / kBQ;  // the last tile may be partial
  const int bh = blockIdx.x;
  const int tile = static_cast<int>(blockIdx.y);
  const int qi = causal ? n_q - 1 - tile : tile;  // heaviest first
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const int q0 = qi * kBQ;
  // Tiles ki with ki*BK <= q0 + kBQ - 1 are computed under the causal mask;
  // the last may cross Sk.
  const int n_kv_all = (Sk + BK - 1) / BK;
  const int n_kv = causal ? min(n_kv_all, (q0 + kBQ) / BK) : n_kv_all;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(full_q, kQTile);
      for (int p = 0; p < kPanels; ++p)
        tma_load_4d(sQ + p * kQPanel, &tm_q, full_q, 64 * p, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* k_dst = sK + s * kKVTile;
        uint8_t* v_dst = sV + s * kKVTile;
        mbar_expect_tx(&full_k[s], kKVTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load_4d(k_dst + p * kKVPanel, &tm_k, &full_k[s], 64 * p, g,
                      j * BK, b);
        mbar_expect_tx(&full_v[s], kKVTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load_4d(v_dst + p * kKVPanel, &tm_v, &full_v[s], 64 * p, g,
                      j * BK, b);
      }
    }
    return;
  }

  // Consumer warpgroups: c owns q rows 64c .. 64c+63 of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int c = tid / 128 - 1;
  const int t = tid % 128;
  const int lane = t % 32;
  const int row_lo = 16 * (t / 32) + lane / 4;  // and row_lo + 8
  const int col_in = 2 * (lane % 4);            // first of two columns
  const int q_first = q0 + 64 * c;              // position of row 0

  float acc[kAcc];
  float sc[kSc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kSc; ++i) sc[i] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's columns only until the end
  const uint32_t q_addr = smem_u32(sQ) + 64 * c * 128;

  const int n_k = (D + 15) / 16;  // k-steps of S that hold real columns
  mbar_wait(full_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const int parity = (j / kStages) & 1;
    const uint32_t k_addr = smem_u32(sK + s * kKVTile);
    const uint32_t v_addr = smem_u32(sV + s * kKVTile);

    // S = Q K^T over D in steps of 16 (32 bytes of one 128-byte row): the
    // k-steps past D would multiply the zero fill, so they are not issued
    // (a chain cut at run time, which ptxas fences at each product: its
    // C7519 note; at D = DP the chain is whole).
    mbar_wait(&full_k[s], parity);
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk >= n_k) break;
      const uint32_t col = (kk % 4) * 32;
      const uint64_t da = sw128_desc(q_addr + (kk / 4) * kQPanel + col, 16);
      const uint64_t db = sw128_desc(k_addr + (kk / 4) * kKVPanel + col, 16);
      wgmma_qk<BK>(sc, da, db, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // Online softmax in the log2 domain.  sc[4n + e] is row row_lo + 8*(e/2),
    // column 8n + col_in + e%2 of the tile.  Scores above the diagonal, or
    // of kv rows past Sk (the last tile's, TMA's zero fill), are masked:
    // column k of row r is kept while k <= lim[r], on the tiles the
    // diagonal or Sk crosses alone (a uniform branch).
    const int k0 = j * BK;
    const bool diag = causal && k0 + BK - 1 > q_first;
    float mx[2] = {m[0], m[1]};
    if (diag || k0 + BK > Sk) {
      int lim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lim[r] = min(diag ? q_first + row_lo + 8 * r : Sk - 1, Sk - 1);
#pragma unroll
      for (int i = 0; i < kSc; ++i) {
        float x = sc[i] * scale_log2;
        if (k0 + 8 * (i / 4) + col_in + i % 2 > lim[(i % 4) / 2])
          x = REPRO_NEG_INF;
        sc[i] = x;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSc; ++i) {
        sc[i] *= scale_log2;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kSc; ++i) {
      const float p = exp2f(sc[i] - m[(i % 4) / 2]);
      sc[i] = p;
      rsum[(i % 4) / 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i % 4) / 2];

    // P as wgmma A fragments: k-step kk (kv columns 16kk..16kk+15) is
    // sc[8kk .. 8kk+7] in the order the fragment wants; hi = bf16(p),
    // lo = bf16(p - hi).
    uint32_t p_hi[kSc / 2], p_lo[kSc / 2];
#pragma unroll
    for (int i = 0; i < kSc / 2; ++i) {
      const float x0 = sc[2 * i], x1 = sc[2 * i + 1];
      __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i] = *reinterpret_cast<uint32_t*>(&hi);
      p_lo[i] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }

    // O += P V over the BK kv rows in steps of 16 (2048 bytes of V).
    mbar_wait(&full_v[s], parity);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, kKVPanel);
      wgmma_pv<DP>(acc, p_hi + 4 * kk, dv);
      wgmma_pv<DP>(acc, p_lo + 4 * kk, dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // out = acc / max(l, 1e-30), rounded to bf16, staged in this consumer's
  // Q rows (same swizzle) and written as 16-byte row segments, the D / 8
  // of a row that hold real columns.
  float lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lim[r] = fmaxf(l[r], 1e-30f);
  }
  uint8_t* sO = sQ + 64 * c * 128;
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");  // Q rows read
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      uint8_t* dst = sO + (n / 8) * kQPanel + row * 128 +
                     (((n % 8) ^ (row % 8)) * 16) + col_in * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(acc[4 * n + 2 * r] / lim[r], acc[4 * n + 2 * r + 1] / lim[r]);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
  constexpr int kChunks = DP / 8;  // 16-byte segments in one staged row
  for (int i = t; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks;
    const int ch = i % kChunks;
    if (ch >= D / 8) continue;     // a padded column
    if (q_first + row >= Sq) continue;  // a row past Sq
    const uint4 val = *reinterpret_cast<const uint4*>(
        sO + (ch / 8) * kQPanel + row * 128 + (((ch % 8) ^ (row % 8)) * 16));
    const int64_t pos = static_cast<int64_t>(b) * Sq + q_first + row;
    *reinterpret_cast<uint4*>(o + (pos * H + h) * D + ch * 8) = val;
  }
}

// Tensor map over a contiguous [B, S, heads, D] bf16 array, boxes of
// {64 columns, 1 head, box_rows rows, 1 sequence}, 128-byte swizzle.  A
// box's columns past D and rows past S lie outside the map and land as
// zeros (FLOAT_OOB_FILL_NONE), never the next sequence's rows; they still
// count in the bytes the load completes on its mbarrier.
bool make_map(CUtensorMap* map, const void* base, int D, int heads, int S,
              int B, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int G, int D, int causal, float scale,
           cudaStream_t stream) {
  static_assert(smem_bytes<DP, BK>() <= 232448, "over a block's shared memory");
  if (D > DP || DP - D >= 64 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, Sq, B, kBQ) ||
      !make_map(&tk, k, D, G, Sk, B, BK) ||
      !make_map(&tv, v, D, G, Sk, B, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<DP, BK>();
  auto* kern = D == DP ? flash_fwd_sm90<DP, BK, false>
                       : flash_fwd_sm90<DP, BK, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                         static_cast<__nv_bfloat16*>(o), Sq,
                                         Sk, H, G, D, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, D above 256: flash_fwd_wide_sm90
// ---------------------------------------------------------------------------
//
// flash_fwd_sm90 keeps O as one 64 x DP wgmma accumulator a consumer (DP / 2
// registers a thread) and the whole K and V tiles in a stage; wgmma's N
// stops at 256, a thread at 255 registers, and at DP 512 the Q tile and two
// stages of K and V would take 384 KB.  So O is split between two blocks
// along the grid's z, block r owning a contiguous run of NP <= 4 of the
// head's 64-column panels (wide_run, plan.wide_panels: 3 + 2 at D 320, so
// no block runs P V over a whole panel of V's zeros), and each block
// computes S and the softmax over the whole head (the same operations in
// the same order, so the blocks' m and l agree bit for bit).  Not a
// cluster that splits S between the blocks, as flash_fwd_wide does in f32:
// the partial S a block would exchange each tile (128 x 64 f32, 32 KB)
// crosses the SM-to-SM network at about 24 GB/s an SM, 1.36-1.87 us a
// tile (scripts/cluster_exchange.py), more than the 0.56 us the bf16
// tensor cores take to recompute the other block's half of S at D 512;
// such a kernel ran 3-7% slower than the recompute design it was held
// against (PERF.md).  The producer streams K as 64 x 64 panels through a
// ring of kWideKStages and the block's 64 x 64 NP V tile through a ring of
// two; S = Q K^T is one chain of m64n64k16 over the head's NDP panels (NDP
// and NP are template arguments, so no k-step is cut at run time, which
// made ptxas fence the chain at every k-step; it still fences it where it
// waits for a K panel, C7519; k-steps past D multiply the zero fill), each
// panel released to the producer once the next one's products are issued
// (wgmma.wait_group 1);
// O += P V runs at N = 64 NP.  The 128-row Q tile stays whole in shared
// memory (NDP swizzled panels), which caps D at 512 in bf16
// (plan.SM90_MAX_HEAD_DIM).  As in flash_fwd_sm90: tensor maps at the real
// D, whose zero fill past D counts in the mbarriers' bytes; P goes from
// registers as two bf16 halves; the output is staged through the
// consumer's Q rows and written at the real D.
constexpr int kWideBK = 64;     // kv rows of a K panel and of a V tile
constexpr int kWideKStages = 4;   // plan.WIDE_SM90_K_STAGES
constexpr int kWideVStages = 2;   // plan.WIDE_SM90_V_STAGES
constexpr int kWidePanel = kWideBK * 128;  // bytes of one 64 x 64 panel
constexpr int kWideBlocks = 2;  // blocks along z (plan.WIDE_SM90_BLOCKS)

// Shared memory at padded width dp whose widest block holds np_max panels:
// alignment slack, the Q tile, the K ring, the V ring, the mbarriers.
__host__ __device__ constexpr int wide_smem_bytes(int dp, int np_max) {
  return 1024 + kBQ * dp * 2 + kWideKStages * kWidePanel +
         kWideVStages * np_max * kWidePanel +
         8 * (1 + 2 * kWideKStages + 2 * kWideVStages);
}

// O += P V for one 16-row k-step at N = 64 NP.
template <int NP>
__device__ __forceinline__ void wgmma_pv_wide(float (&acc)[32 * NP],
                                              const uint32_t* a,
                                              uint64_t db) {
  if constexpr (NP == 4)
    wgmma_rs_n256(acc, a, db, 1);
  else if constexpr (NP == 3)
    wgmma_rs_n192(acc, a, db, 1);
  else
    wgmma_rs_n128(acc, a, db, 1);
}

struct WideBars {
  uint64_t* full_q;
  uint64_t* full_k;   // [kWideKStages]
  uint64_t* empty_k;  // [kWideKStages]
  uint64_t* full_v;   // [kWideVStages]
  uint64_t* empty_v;  // [kWideVStages]
};

// One consumer warpgroup's walk: q rows 64c .. 64c + 63 of the tile, S over
// the head's NDP panels, O over the block's NP panels from column c0.
template <int NDP, int NP>
__device__ __forceinline__ void wide_consume(
    const WideBars& bar, uint8_t* sQ, uint8_t* sK, uint8_t* sV,
    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int D, int b,
    int h, int q0, int n_kv, int causal, float scale_log2, int c0) {
  constexpr int kAcc = 32 * NP;     // f32 accumulators a thread: 64 x 64 NP
  constexpr int kSc = kWideBK / 2;  // ... for the 64 x 64 scores
  constexpr int kVTile = NP * kWidePanel;
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_lo = 16 * (t / 32) + lane / 4;  // and row_lo + 8
  const int col_in = 2 * (lane % 4);            // first of two columns
  const int q_first = q0 + 64 * c;              // position of row 0

  float acc[kAcc];
  float sc[kSc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kSc; ++i) sc[i] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's columns only until the end
  const uint32_t q_addr = smem_u32(sQ) + 64 * c * 128;

  mbar_wait(bar.full_q, 0);
  int kc = 0;  // K panels consumed
  for (int j = 0; j < n_kv; ++j) {
    // S = Q K^T over the head's NDP panels, 4 k-steps of 16 a panel.
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NDP; ++p) {
      const int s = kc % kWideKStages;
      mbar_wait(&bar.full_k[s], (kc / kWideKStages) & 1);
      const uint32_t k_addr = smem_u32(sK + s * kWidePanel);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sw128_desc(q_addr + p * kQPanel + kk * 32, 16);
        const uint64_t db = sw128_desc(k_addr + kk * 32, 16);
        wgmma_ss_n64(sc, da, db, p != 0 || kk != 0);
      }
      wgmma_commit();
      if (p > 0) {  // the previous panel's products are done: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&bar.empty_k[(kc - 1) % kWideKStages]);
      }
      ++kc;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&bar.empty_k[(kc - 1) % kWideKStages]);
    reg_fence(sc);

    // Online softmax in the log2 domain.  sc[4n + e] is row row_lo + 8*(e/2),
    // column 8n + col_in + e%2 of the tile.  Scores above the diagonal, or
    // of kv rows past Sk (the last tile's, TMA's zero fill), are masked:
    // column k of row r is kept while k <= lim[r], on the tiles the
    // diagonal or Sk crosses alone (a uniform branch).
    const int k0 = j * kWideBK;
    const bool diag = causal && k0 + kWideBK - 1 > q_first;
    float mx[2] = {m[0], m[1]};
    if (diag || k0 + kWideBK > Sk) {
      int lim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lim[r] = min(diag ? q_first + row_lo + 8 * r : Sk - 1, Sk - 1);
#pragma unroll
      for (int i = 0; i < kSc; ++i) {
        float x = sc[i] * scale_log2;
        if (k0 + 8 * (i / 4) + col_in + i % 2 > lim[(i % 4) / 2])
          x = REPRO_NEG_INF;
        sc[i] = x;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSc; ++i) {
        sc[i] *= scale_log2;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kSc; ++i) {
      const float p = exp2f(sc[i] - m[(i % 4) / 2]);
      sc[i] = p;
      rsum[(i % 4) / 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i % 4) / 2];

    // P as wgmma A fragments, hi = bf16(p), lo = bf16(p - hi).
    uint32_t p_hi[kSc / 2], p_lo[kSc / 2];
#pragma unroll
    for (int i = 0; i < kSc / 2; ++i) {
      const float x0 = sc[2 * i], x1 = sc[2 * i + 1];
      __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i] = *reinterpret_cast<uint32_t*>(&hi);
      p_lo[i] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }

    // O += P V for this block's 64 NP columns, over the 64 kv rows in steps
    // of 16.
    const int s = j % kWideVStages;
    const uint32_t v_addr = smem_u32(sV + s * kVTile);
    mbar_wait(&bar.full_v[s], (j / kWideVStages) & 1);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWideBK / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, kWidePanel);
      wgmma_pv_wide<NP>(acc, p_hi + 4 * kk, dv);
      wgmma_pv_wide<NP>(acc, p_lo + 4 * kk, dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(&bar.empty_v[s]);
  }

  // out = acc / max(l, 1e-30), rounded to bf16, staged in this consumer's
  // rows of the first NP Q panels and written as 16-byte row segments of
  // the real columns.
  float lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lim[r] = fmaxf(l[r], 1e-30f);
  }
  uint8_t* sO = sQ + 64 * c * 128;
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");  // Q rows read
#pragma unroll
  for (int n = 0; n < 8 * NP; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      uint8_t* dst = sO + (n / 8) * kQPanel + row * 128 +
                     (((n % 8) ^ (row % 8)) * 16) + col_in * 2;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(
          acc[4 * n + 2 * r] / lim[r], acc[4 * n + 2 * r + 1] / lim[r]);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
  constexpr int kChunks = 8 * NP;  // 16-byte segments in one staged row
  for (int i = t; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks;
    const int ch = i % kChunks;
    if (c0 + 8 * ch >= D || q_first + row >= Sq) continue;  // past D or Sq
    const uint4 val = *reinterpret_cast<const uint4*>(
        sO + (ch / 8) * kQPanel + row * 128 + (((ch % 8) ^ (row % 8)) * 16));
    const int64_t pos = static_cast<int64_t>(b) * Sq + q_first + row;
    *reinterpret_cast<uint4*>(o + (pos * H + h) * D + c0 + ch * 8) = val;
  }
}

// grid (B*H, Sq/128, 2); one instance, D at run time (the head's and the
// block's panel counts pick the consumer body).
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                    int G, int D, int causal, float scale_log2) {
  const int n_dp = (D + 63) / 64;  // 64-column panels of the head
  int p0, np;                      // this block's run of panels
  wide_run(n_dp, kWideBlocks, static_cast<int>(blockIdx.z), p0, np);
  const int c0 = 64 * p0;          // its first column of the head
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + n_dp * kQPanel;
  uint8_t* sV = sK + kWideKStages * kWidePanel;
  WideBars bar;
  bar.full_q = reinterpret_cast<uint64_t*>(
      sV + kWideVStages * ((n_dp + 1) / 2) * kWidePanel);
  bar.full_k = bar.full_q + 1;
  bar.empty_k = bar.full_k + kWideKStages;
  bar.full_v = bar.empty_k + kWideKStages;
  bar.empty_v = bar.full_v + kWideVStages;

  const int n_q = (Sq + kBQ - 1) / kBQ;  // the last tile may be partial
  const int bh = blockIdx.x;
  const int tile = static_cast<int>(blockIdx.y);
  const int qi = causal ? n_q - 1 - tile : tile;  // heaviest first
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const int q0 = qi * kBQ;
  const int n_kv_all = (Sk + kWideBK - 1) / kWideBK;  // the last may cross Sk
  const int n_kv = causal ? min(n_kv_all, (q0 + kBQ) / kWideBK) : n_kv_all;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar.full_q, 1);
    for (int s = 0; s < kWideKStages; ++s) {
      mbar_init(&bar.full_k[s], 1);
      mbar_init(&bar.empty_k[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kWideVStages; ++s) {
      mbar_init(&bar.full_v[s], 1);
      mbar_init(&bar.empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(bar.full_q, n_dp * kQPanel);
      for (int p = 0; p < n_dp; ++p)
        tma_load_4d(sQ + p * kQPanel, &tm_q, bar.full_q, 64 * p, h, q0, b);
      int kc = 0;  // K panels issued
      for (int j = 0; j < n_kv; ++j) {
        for (int p = 0; p < n_dp; ++p, ++kc) {
          const int s = kc % kWideKStages;
          mbar_wait(&bar.empty_k[s], ((kc / kWideKStages) & 1) ^ 1);
          mbar_expect_tx(&bar.full_k[s], kWidePanel);
          tma_load_4d(sK + s * kWidePanel, &tm_k, &bar.full_k[s], 64 * p, g,
                      j * kWideBK, b);
        }
        const int s = j % kWideVStages;
        mbar_wait(&bar.empty_v[s], ((j / kWideVStages) & 1) ^ 1);
        mbar_expect_tx(&bar.full_v[s], np * kWidePanel);
        for (int p = 0; p < np; ++p)
          tma_load_4d(sV + (s * np + p) * kWidePanel, &tm_v, &bar.full_v[s],
                      c0 + 64 * p, g, j * kWideBK, b);
      }
    }
    return;
  }

  // Consumer warpgroups: c owns q rows 64c .. 64c+63 of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
#define REPRO_WIDE_CONSUME(NDP, NP)                                         \
  wide_consume<NDP, NP>(bar, sQ, sK, sV, o, Sq, Sk, H, D, b, h, q0, n_kv,   \
                        causal, scale_log2, c0)
  switch (8 * n_dp + np) {  // the (head, block) panel runs of wide_run
    case 8 * 5 + 3: REPRO_WIDE_CONSUME(5, 3); break;
    case 8 * 5 + 2: REPRO_WIDE_CONSUME(5, 2); break;
    case 8 * 6 + 3: REPRO_WIDE_CONSUME(6, 3); break;
    case 8 * 7 + 4: REPRO_WIDE_CONSUME(7, 4); break;
    case 8 * 7 + 3: REPRO_WIDE_CONSUME(7, 3); break;
    default: REPRO_WIDE_CONSUME(8, 4); break;
  }
#undef REPRO_WIDE_CONSUME
}

int launch_wide(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int G, int D, int causal, float scale,
                cudaStream_t stream) {
  static_assert(wide_smem_bytes(512, 4) <= 232448,
                "over a block's shared memory");
  if (D <= 256 || D > 4 * 64 * kWideBlocks || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, Sq, B, kBQ) ||
      !make_map(&tk, k, D, G, Sk, B, kWideBK) ||
      !make_map(&tv, v, D, G, Sk, B, kWideBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_dp = (D + 63) / 64;
  const int smem = wide_smem_bytes(64 * n_dp, (n_dp + 1) / 2);
  auto* kern = flash_fwd_wide_sm90;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ, kWideBlocks);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                         static_cast<__nv_bfloat16*>(o), Sq,
                                         Sk, H, G, D, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90


}  // namespace

// Contract (checked by the Python wrapper, kernel.py): contiguous, 16-byte
// aligned inputs, D % 8 == 0 and 8 <= D <= 1024 (512 in bf16), any Sq, Sk
// >= 1 (every kernel's last q tile and last kv tile may be partial: rows
// past the end load as zeros, their scores are masked and their outputs
// never stored), H % G == 0.  Above D = 256 each dtype runs its wide kernel
// (plan.wide_f32_plan: clusters of ceil(D / 256) blocks; plan.wide_sm90_plan:
// two blocks; one instance each, D at run time), tile_k its kv rows (32
// f32, with the split as below; 64 bf16).  Up to 256 each dtype runs its
// kernel built for the padded width DP = D rounded up to a multiple of 64
// (plan.padded_head_dim), whose shared-memory rows hold D real columns and
// zeros up to DP (the instance for D = DP where D is a multiple of 64).
// tile_k is the kv rows a stage of that instance holds, as plan.py gives
// it (checked here against the instantiation):
// - f32: flash_fwd_kernel, 128 x 64 tiles (64 x 32 at DP 192 and 256), the
//   kv axis cut into n_splits ranges of per_split rows (a multiple of
//   tile_k; the last range may end inside a tile); part holds n_splits * B*Sq*H * (D + 2) floats when
//   n_splits > 1;
// - bf16: flash_fwd_sm90, 128-row q tiles and tile_k (128, or 64 at DP 192
//   and 256) kv rows, one split.
REPRO_EXPORT int flash_attention_launch(int dtype, const void* q, const void* k,
                                        const void* v, void* o, void* part,
                                        int B, int Sq, int Sk, int H, int G,
                                        int D, int causal, float scale,
                                        int per_split, int n_splits,
                                        int tile_k, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || G <= 0 || H % G || D < 8 || D % 8 ||
      D > kWideMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 256) {
    if (dtype == REPRO_F32 && tile_k == f32::kWideBK)
      return f32::launch_wide(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<float*>(part), B, Sq, Sk, H, G, D, causal, scale,
          per_split, n_splits, s);
    if (dtype == REPRO_BF16 && n_splits == 1 && tile_k == sm90::kWideBK)
      return sm90::launch_wide(q, k, v, o, B, Sq, Sk, H, G, D, causal,
                               scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int DP = (D + 63) / 64 * 64;
  if (dtype == REPRO_F32) {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    auto* pf = static_cast<float*>(part);
    if (DP == 64 && tile_k == f32::block_k<64>())
      return f32::launch<64>(qf, kf, vf, of, pf, B, Sq, Sk, H, G, D, causal,
                             scale, per_split, n_splits, s);
    if (DP == 128 && tile_k == f32::block_k<128>())
      return f32::launch<128>(qf, kf, vf, of, pf, B, Sq, Sk, H, G, D, causal,
                              scale, per_split, n_splits, s);
    if (DP == 192 && tile_k == f32::block_k<192>())
      return f32::launch<192>(qf, kf, vf, of, pf, B, Sq, Sk, H, G, D, causal,
                              scale, per_split, n_splits, s);
    if (DP == 256 && tile_k == f32::block_k<256>())
      return f32::launch<256>(qf, kf, vf, of, pf, B, Sq, Sk, H, G, D, causal,
                              scale, per_split, n_splits, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == REPRO_BF16) {
    if (n_splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (DP == 64 && tile_k == 128)
      return sm90::launch<64, 128>(q, k, v, o, B, Sq, Sk, H, G, D, causal,
                                   scale, s);
    if (DP == 128 && tile_k == 128)
      return sm90::launch<128, 128>(q, k, v, o, B, Sq, Sk, H, G, D, causal,
                                    scale, s);
    if (DP == 192 && tile_k == 64)
      return sm90::launch<192, 64>(q, k, v, o, B, Sq, Sk, H, G, D, causal,
                                   scale, s);
    if (DP == 256 && tile_k == 64)
      return sm90::launch<256, 64>(q, k, v, o, B, Sq, Sk, H, G, D, causal,
                                   scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
