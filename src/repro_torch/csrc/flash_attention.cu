// Flash attention forward (GQA, optional causal mask) on Hopper.
//
// Replaces the Pallas kernel flash_attention of
// src/repro/kernels/flash_attention/kernel.py (pallas_call at :108), whose
// grid (b*h, n_q, n_kv) carries the online-softmax state (m, l, acc) in
// VMEM scratch across the sequential kv axis.  On Hopper blocks run in no
// order, so one block owns one (b*h, q tile) and loops the kv axis itself.
// Two kernels sit behind flash_attention_launch, chosen by dtype:
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
// [B*S, heads, D] layout (rank-3 tensor maps, box {64, 1, 128}; D = 128 is
// two 64-column panels), so nothing is transposed.  S = Q K^T is
// wgmma m64n128k16 with both operands in shared memory and f32
// accumulators; the online softmax runs in registers (a row lies across
// one quad, so its max and sum take two xor-shuffles), with
// scale * log2(e) folded into exp2f; O += P V is wgmma m64nDk16 with P
// from registers and V read MN-major (transposed) from shared memory.  P
// goes in as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), two
// products into the same f32 accumulator: one bf16 rounding of p puts an
// error of ~2^-9 of the output's rms on every element, up to 12.6x the
// tolerance against the f32 plain version (tests/test_torch_flash_tiles.py),
// while the split leaves ~2^-17.
// Causal q tiles are numbered heaviest first, and only the tile on the
// diagonal is masked.  The output is normalized, rounded to bf16, staged
// through the swizzled Q rows the consumer owns and written with 16-byte
// stores.
//
// f32: flash_fwd_kernel + flash_combine, on the CUDA cores, since one TF32
// pass would not hold the f32 tolerance.  Bound: operations, 4*D f32
// flops per unmasked pair at 67 TFLOP/s, so the design keeps the FMA pipe
// fed.  A block (8 warps) holds a 128-row q tile of one head and walks one
// range of the kv axis in 64-row chunks through a ring of 16-byte cp.async
// copies (2 stages at D = 128, where shared memory holds no third; 3 at
// D = 64), so the next chunk loads while one is computed, with one block
// barrier per chunk.  Both products are outer-product register tiles fed
// by 128-bit shared-memory reads: S = Q K^T is 8 x 4 a thread (12 float4
// reads per 128 FMAs), O += P V is 8 x D/16 (a float4 of V per 32 FMAs).
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
// writes f32 partials (m, l, unnormalized acc) and flash_combine folds them
// in split order, with no atomics.  At full width (1280 blocks) one range
// writes the output itself.  Causal q tiles are numbered heaviest first.
//
// Semantics kept from the reference in both: scale D^-0.5 applied to the
// dot; causal mask qpos >= kpos on absolute positions, with masked scores
// set to -1e30 (not -inf) and whole kv tiles above the diagonal skipped
// (ki*bk > qi*bq + bq - 1; the f32 kernel skips its 64-row chunks above
// the diagonal, which changes nothing: a masked score's p is exactly 0
// once a row has seen key 0, and a range whose rows see only masked keys
// has m = -1e30 and weight 2^(-1e30 - M) = 0 in the combine); out = acc /
// max(l, 1e-30).  q is [B, Sq, H, D], k and v [B, Sk, G, D]; head h reads
// kv head h / (H/G).
#include "common.cuh"
#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and forms

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel, split-KV
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBQ = 128;       // q rows a block holds
constexpr int kBK = 64;        // kv rows a ring stage holds
constexpr int kTX = 16;        // lanes that share a score row
constexpr int kRQ = 8;         // score and output rows a thread holds
constexpr float kLog2e = 1.4426950408889634f;

// A ring of 3 stages where shared memory holds one (D = 64), else 2.
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 64 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return kBQ * D                        // Q tile
         + 2 * stages<D>() * kBK * D    // K and V rings
         + kBQ * kBK;                   // P, each warp's 16 rows its own
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kRows rows of D floats lying `stride` floats apart in global memory, into
// shared rows of D floats.  With G > 0 the 16-byte chunks of row r are
// stored in the order chunk ^ ((r / G) % 8): then the rows a warp reads at
// one d (or k) fall in distinct bank groups, with no padding.  A thread's
// own rows share one swizzle, so its reads walk the 8 chunks of each 32
// floats in the order u ^ f for a per-thread f, without index arithmetic
// in the loop.
template <int D, int G, int kRows>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int tid) {
  constexpr int kChunks = D / 4;
  static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
    const int e = n * kThreads + tid;
    const int r = e / kChunks, c = e % kChunks;
    const int pc = G ? c ^ ((r / (G ? G : 1)) & 7) : c;
    cp_async16(dst + r * D + 4 * pc, src + r * stride + 4 * c);
  }
}

// One block: a 128-row q tile of one (b, h) against kv rows
// [kv0, kv0 + per_split) of split `split`, in 64-row chunks.  Thread
// (ty, tx) = (tid / 16, tid % 16) holds score rows 8ty..8ty+7 against
// chunk columns 4tx..4tx+3, and output rows 8ty.. at columns 4tx + 64j
// (+0..3).  A row's scores lie on the 16 lanes of one ty, so its max
// takes four xor-shuffles; its sum is kept as a lane's share and reduced
// once at the end.  Scores are taken in the log2 domain (scale * log2(e)
// folded into one multiply), p = exp2(x - m).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ part, int Sq, int Sk, int H, int G,
                 int causal, float scale_log2, int per_split, int n_splits) {
  constexpr int kStages = stages<D>();
  constexpr int OC = D / (4 * kTX);  // float4 output columns a thread holds
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * D;
  float* sV = sK + kStages * kBK * D;
  float* sP = sV + kStages * kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int r0 = kRQ * ty;   // first row this thread holds
  const int fq = ty & 7;     // swizzle of its Q and P rows
  const int fk = tx & 7;     // swizzle of its K rows (4tx..4tx+3)
  const int n_q = Sq / kBQ;
  const int split = blockIdx.x % n_splits;
  const int tile = blockIdx.x / n_splits;
  const int qi = causal ? n_q - 1 - tile : tile;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int q0 = qi * kBQ;
  const int kv0 = split * per_split;
  int kv1 = min(Sk, kv0 + per_split);
  if (causal) kv1 = min(kv1, q0 + kBQ);  // chunks wholly above the diagonal
  const int n_chunks = kv1 > kv0 ? (kv1 - kv0) / kBK : 0;

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(G) * D;
  const float* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * Sk * G + g) * D;
  const float* vb = v + (static_cast<int64_t>(b) * Sk * G + g) * D;

  auto load_chunk = [&](int c) {
    const int st = c % kStages;
    const int64_t off = (kv0 + static_cast<int64_t>(c) * kBK) * kv_stride;
    load_rows<D, 4, kBK>(sK + st * kBK * D, kb + off, kv_stride, tid);
    load_rows<D, 0, kBK>(sV + st * kBK * D, vb + off, kv_stride, tid);
  };
  if (n_chunks > 0) {
    load_rows<D, kRQ, kBQ>(sQ, qb + q0 * q_stride, q_stride, tid);
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
  const float* qrow = sQ + r0 * D;
  float* prow = sP + r0 * kBK;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();               // ... everyone's; chunk c-1 consumed
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1);
    cp_async_commit();

    const float* krow = sK + (c % kStages) * kBK * D + 4 * tx * D;
    const float* vrow = sV + (c % kStages) * kBK * D + 4 * tx;
    const int k0 = kv0 + c * kBK;

    // S = Q K^T: 8 x 4 a thread, 12 float4 reads per 128 FMAs.
    float s[kRQ][4];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int d8 = 0; d8 < D; d8 += 32) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float4 qv[kRQ], kv[4];
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qrow + i * D + d8 +
                                                   4 * (u ^ fq));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(krow + j * D + d8 +
                                                   4 * (u ^ fk));
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
    }

    // Online softmax in registers; P to the warp's rows of sP.
    const bool mask = causal && k0 + kBK - 1 > q0;
    float alpha[kRQ];
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale_log2;
        if (mask && q0 + r0 + i < k0 + 4 * tx + j) x = REPRO_NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTX; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = exp2f(m[i] - m_new);
      float4 p;
      p.x = exp2f(s[i][0] - m_new);
      p.y = exp2f(s[i][1] - m_new);
      p.z = exp2f(s[i][2] - m_new);
      p.w = exp2f(s[i][3] - m_new);
      l[i] = l[i] * alpha[i] + ((p.x + p.y) + (p.z + p.w));
      m[i] = m_new;
      // chunk tx of P row r0 + i, swizzled like the Q rows
      *reinterpret_cast<float4*>(prow + i * kBK +
                                 4 * (tx ^ fq)) = p;
    }
    __syncwarp();

    // O = O * alpha + P V: 8 x 4*OC a thread; per k, OC float4 reads of V
    // for 32 OC FMAs, and per 4 k, 8 float4 reads of P.
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
          const float* vk = vrow + (k8 + 4 * u + kk) * D;
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
  // Output row index (b*Sq + q)*H + h, as in o's [B, Sq, H, D] layout.
  const int64_t row0 = (static_cast<int64_t>(b) * Sq + q0 + r0) * H + h;
  if (n_splits == 1) {
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      float* orow = o + (row0 + static_cast<int64_t>(i) * H) * D + 4 * tx;
#pragma unroll
      for (int jj = 0; jj < OC; ++jj)
        *reinterpret_cast<float4*>(orow + 4 * kTX * jj) =
            make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                        acc[i][4 * jj + 2] * inv, acc[i][4 * jj + 3] * inv);
    }
    return;
  }
  // Partials of this split: acc [n_splits][rows][D], then (m, l) pairs
  // [n_splits][rows][2].  A split with no chunk leaves m = -1e30, l = 0,
  // acc = 0, which the combine weighs by exp2(-1e30 - M) = 0.
  const int64_t rows = static_cast<int64_t>(gridDim.y / H) * Sq * H;
  float* pacc = part + split * rows * D;
  float* pml = part + n_splits * rows * D + split * rows * 2;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int64_t r = row0 + static_cast<int64_t>(i) * H;
    float* arow = pacc + r * D + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < OC; ++jj)
      *reinterpret_cast<float4*>(arow + 4 * kTX * jj) =
          make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2],
                      acc[i][4 * jj + 3]);
    if (tx == 0)
      *reinterpret_cast<float2*>(pml + 2 * r) = make_float2(m[i], l[i]);
  }
}

// Fold the splits' partials of every output row in split order:
// M = max m_s, L = sum l_s 2^(m_s - M),
// out = sum acc_s 2^(m_s - M) / max(L, 1e-30).  One thread a float4 of one
// row; no atomics, so the result is the same from run to run.
template <int D>
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ part, float* __restrict__ o,
              int64_t rows, int n_splits) {
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

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* part, int B, int Sq, int Sk, int H, int G, int causal,
           float scale, int per_split, int n_splits, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto* kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq / kBQ) * n_splits, B * H);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, part, Sq, Sk, H, G,
                                         causal, scale * kLog2e, per_split,
                                         n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  const int64_t threads = rows * (D / 4);
  flash_combine<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                     stream>>>(part, o, rows, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32


// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (sm_90a)
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int kBQ = 128;           // q rows a block owns (two consumers x 64)
constexpr int kBK = 128;           // kv rows a stage holds
constexpr int kStages = 2;         // K/V ring depth
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kPanelBytes = 128 * 128;   // 128 rows x 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(acc, a, db, 1);
  else
    wgmma_rs_n64(acc, a, db, 1);
}

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kBK * D * 2;  // one 128-row bf16 tile, D/64 panels
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 1024                                   // alignment slack
         + (1 + 2 * kStages) * tile_bytes<D>()  // Q, K ring, V ring
         + 8 * (1 + 3 * kStages);               // mbarriers
}

// grid (B*H, Sq/128): blockIdx.x is the head, blockIdx.y the q tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int G,
               int causal, float scale_log2) {
  constexpr int kPanels = D / 64;
  constexpr int kTile = tile_bytes<D>();
  constexpr int kAcc = D / 2;  // f32 accumulators a thread holds for 64 x D
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + kTile;
  uint8_t* sV = sK + kStages * kTile;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + kStages * kTile);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int n_q = Sq / kBQ;
  const int bh = blockIdx.x;
  const int tile = static_cast<int>(blockIdx.y);
  const int qi = causal ? n_q - 1 - tile : tile;  // heaviest first
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const int q0 = qi * kBQ;
  // Tiles ki with ki*bk <= q0 + bq - 1 are computed under the causal mask.
  const int n_kv = causal ? min(Sk / kBK, qi + 1) : Sk / kBK;
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
      const int q_row = b * Sq + q0;
      const int kv_row = b * Sk;
      mbar_expect_tx(full_q, kTile);
      for (int p = 0; p < kPanels; ++p)
        tma_load(sQ + p * kPanelBytes, &tm_q, full_q, 64 * p, h, q_row);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* k_dst = sK + s * kTile;
        uint8_t* v_dst = sV + s * kTile;
        mbar_expect_tx(&full_k[s], kTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load(k_dst + p * kPanelBytes, &tm_k, &full_k[s], 64 * p, g,
                   kv_row + j * kBK);
        mbar_expect_tx(&full_v[s], kTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load(v_dst + p * kPanelBytes, &tm_v, &full_v[s], 64 * p, g,
                   kv_row + j * kBK);
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
  float sc[64];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's columns only until the end
  const uint32_t q_addr = smem_u32(sQ) + 64 * c * 128;

  mbar_wait(full_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const int parity = (j / kStages) & 1;
    const uint32_t k_addr = smem_u32(sK + s * kTile);
    const uint32_t v_addr = smem_u32(sV + s * kTile);

    // S = Q K^T over D in steps of 16 (32 bytes of one 128-byte row).
    mbar_wait(&full_k[s], parity);
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      const uint64_t da = sw128_desc(q_addr + off, 16);
      const uint64_t db = sw128_desc(k_addr + off, 16);
      if (kk == 0)
        wgmma_ss_n128_init(sc, da, db);
      else
        wgmma_ss_n128(sc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // Online softmax in the log2 domain.  sc[4n + e] is row row_lo + 8*(e/2),
    // column 8n + col_in + e%2 of the tile.
    const int k0 = j * kBK;
    const bool diag = causal && k0 + kBK - 1 > q_first;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i] * scale_log2;
      if (diag) {
        const int qpos = q_first + row_lo + 8 * ((i % 4) / 2);
        const int kpos = k0 + 8 * (i / 4) + col_in + i % 2;
        if (qpos < kpos) x = REPRO_NEG_INF;
      }
      sc[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
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
    for (int i = 0; i < 64; ++i) {
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
    uint32_t p_hi[32], p_lo[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x0 = sc[2 * i], x1 = sc[2 * i + 1];
      __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i] = *reinterpret_cast<uint32_t*>(&hi);
      p_lo[i] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }

    // O += P V over the 128 kv rows in steps of 16 (2048 bytes of V).
    mbar_wait(&full_v[s], parity);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, kPanelBytes);
      wgmma_pv<D>(acc, p_hi + 4 * kk, dv);
      wgmma_pv<D>(acc, p_lo + 4 * kk, dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // out = acc / max(l, 1e-30), rounded to bf16, staged in this consumer's
  // Q rows (same swizzle) and written as 16-byte row segments.
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
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      uint8_t* dst = sO + (n / 8) * kPanelBytes + row * 128 +
                     (((n % 8) ^ (row % 8)) * 16) + col_in * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(acc[4 * n + 2 * r] / lim[r], acc[4 * n + 2 * r + 1] / lim[r]);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
  constexpr int kChunks = D / 8;  // 16-byte segments in one output row
  for (int i = t; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks;
    const int ch = i % kChunks;
    const uint4 val = *reinterpret_cast<const uint4*>(
        sO + (ch / 8) * kPanelBytes + row * 128 + (((ch % 8) ^ (row % 8)) * 16));
    const int64_t pos = static_cast<int64_t>(b) * Sq + q_first + row;
    *reinterpret_cast<uint4*>(o + (pos * H + h) * D + ch * 8) = val;
  }
}

// Tensor map over a contiguous [rows, heads, D] bf16 array, boxes of
// {64 columns, 1 head, 128 rows}, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int D, int heads,
              int64_t rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(kBK)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int G, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, static_cast<int64_t>(B) * Sq) ||
      !make_map(&tk, k, D, G, static_cast<int64_t>(B) * Sk) ||
      !make_map(&tv, v, D, G, static_cast<int64_t>(B) * Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<D>();
  auto* kern = flash_fwd_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, Sq / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                         static_cast<__nv_bfloat16*>(o), Sq,
                                         Sk, H, G, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

}  // namespace

// Contract (checked by the Python wrapper): contiguous, 16-byte aligned
// inputs, D in {64, 128}, Sq % bq == 0, Sk % bk == 0, H % G == 0, where bq
// and bk are the reference's tiles, which neither kernel reads (the f32
// kernel walks 128-row q tiles and 64-row kv chunks, flash_fwd_sm90 128-row
// tiles of both).  f32 takes Sq % 128 == 0 and Sk % 64 == 0, with the kv
// axis cut into n_splits ranges of per_split rows (a multiple of 64;
// plan.py), and part holding n_splits * B*Sq*H * (D + 2) floats when
// n_splits > 1; bf16 takes Sq and Sk multiples of 128 and one split.
REPRO_EXPORT int flash_attention_launch(int dtype, const void* q, const void* k,
                                        const void* v, void* o, void* part,
                                        int B, int Sq, int Sk, int H, int G,
                                        int D, int bq, int bk, int causal,
                                        float scale, int per_split,
                                        int n_splits, void* stream) {
  if (bq <= 0 || Sq % bq || bk <= 0 || Sk % bk || H % G || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32) {
    if (Sq % f32::kBQ || Sk % f32::kBK || per_split <= 0 ||
        per_split % f32::kBK || n_splits != (Sk + per_split - 1) / per_split ||
        (n_splits > 1 && part == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    auto* pf = static_cast<float*>(part);
    return D == 64 ? f32::launch<64>(qf, kf, vf, of, pf, B, Sq, Sk, H, G,
                                     causal, scale, per_split, n_splits, s)
                   : f32::launch<128>(qf, kf, vf, of, pf, B, Sq, Sk, H, G,
                                      causal, scale, per_split, n_splits, s);
  }
  if (dtype == REPRO_BF16) {
    if (Sq % sm90::kBQ || Sk % sm90::kBK || n_splits != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return D == 64 ? sm90::launch<64>(q, k, v, o, B, Sq, Sk, H, G, causal,
                                      scale, s)
                   : sm90::launch<128>(q, k, v, o, B, Sq, Sk, H, G, causal,
                                       scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
