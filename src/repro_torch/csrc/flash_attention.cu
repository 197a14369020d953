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
// f32: flash_fwd_kernel, on the CUDA cores (f32 FMAs; register tiles of
// 4x4 scores and 4xD/8 outputs a thread; K/V in 32-row chunks through
// shared memory), since TF32 would not hold the f32 tolerance.
//
// Semantics kept from the reference in both: scale D^-0.5 applied to the
// dot; causal mask qpos >= kpos on absolute positions, with masked scores
// set to -1e30 (not -inf) and whole kv tiles above the diagonal skipped
// (ki*bk > qi*bq + bq - 1); out = acc / max(l, 1e-30).  q is [B, Sq, H, D],
// k and v [B, Sk, G, D]; head h reads kv head h / (H/G).
#include "common.cuh"
#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and forms

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kMaxBQ = 128;  // rows of the reference q tile a block holds
constexpr int kKC = 32;      // kv rows per shared-memory chunk

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kMaxBQ) * (D + 1)  // Q tile (padded rows)
         + kKC * (D + 1)                        // K chunk (padded rows)
         + kKC * D                              // V chunk
         + kMaxBQ * (kKC + 1)                   // scores / probabilities
         + 3 * kMaxBQ;                          // m, l, alpha
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int G, int bq, int bk, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = kKC + 1;
  constexpr int CPT = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kMaxBQ * DP;
  float* sV = sK + kKC * DP;
  float* sS = sV + kKC * D;
  float* sM = sS + kMaxBQ * SP;
  float* sL = sM + kMaxBQ;
  float* sA = sL + kMaxBQ;

  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const int q0 = qi * bq;
  const int64_t q_stride = static_cast<int64_t>(H) * D;   // between positions
  const int64_t kv_stride = static_cast<int64_t>(G) * D;
  const T* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * Sk * G + g) * D;
  const T* vb = v + (static_cast<int64_t>(b) * Sk * G + g) * D;
  T* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * D;

  for (int e = tid; e < kMaxBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    sQ[r * DP + c] = r < bq ? to_f32(qb[(q0 + r) * q_stride + c]) : 0.f;
  }
  for (int r = tid; r < kMaxBQ; r += kThreads) {
    sM[r] = REPRO_NEG_INF;
    sL[r] = 0.f;
  }

  // Thread tiles: rows r0..r0+3 of the q tile; score columns c0..c0+3 of
  // the chunk; output columns cg + 8*j.
  const int r0 = (tid / 8) * 4;
  const int c0 = (tid % 8) * 4;
  const int cg = tid % 8;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int kv_end = Sk;
  if (causal) {  // tiles ki with ki*bk <= q0 + bq - 1 are computed
    const int last = (q0 + bq - 1) / bk;
    kv_end = min(Sk, (last + 1) * bk);
  }

  for (int k0 = 0; k0 < kv_end; k0 += kKC) {
    __syncthreads();  // previous chunk consumed; Q, m, l visible
    for (int e = tid; e < kKC * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int64_t off = (k0 + r) * kv_stride + c;
      sK[r * DP + c] = to_f32(kb[off]);
      sV[r * D + c] = to_f32(vb[off]);
    }
    __syncthreads();

    {  // scores s = (q . k) * scale, masked
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(r0 + i) * DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sK[(c0 + j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j] * scale;
          if (causal && q0 + r0 + i < k0 + c0 + j) x = REPRO_NEG_INF;
          sS[(r0 + i) * SP + c0 + j] = x;
        }
    }
    __syncthreads();

    if (tid < kMaxBQ) {  // online-softmax update of one row
      float* row = sS + tid * SP;
      float mx = row[0];
      for (int j = 1; j < kKC; ++j) mx = fmaxf(mx, row[j]);
      const float m_prev = sM[tid];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < kKC; ++j) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sL[tid] = sL[tid] * alpha + sum;
      sM[tid] = m_new;
      sA[tid] = alpha;
    }
    __syncthreads();

    {  // acc = acc * alpha + p @ v
      float alpha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) alpha[i] = sA[r0 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha[i];
      for (int t = 0; t < kKC; ++t) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = sS[(r0 + i) * SP + t];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float vv = sV[t * D + cg + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    if (r >= bq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      ob[(q0 + r) * q_stride + cg + 8 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int G, int bq, int bk, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto* kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / bq, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, G, bq, bk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}


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
// inputs, D in {64, 128}, Sq % bq == 0, Sk % bk == 0, H % G == 0; f32
// takes 0 < bq <= 128 and bk % 32 == 0, bf16 takes bq = bk = 128.
REPRO_EXPORT int flash_attention_launch(int dtype, const void* q, const void* k,
                                        const void* v, void* o, int B, int Sq,
                                        int Sk, int H, int G, int D, int bq,
                                        int bk, int causal, float scale,
                                        void* stream) {
  if (bq <= 0 || Sq % bq || bk <= 0 || Sk % bk || H % G || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32) {
    if (bq > kMaxBQ || bk % kKC) return static_cast<int>(cudaErrorInvalidValue);
    return D == 64 ? launch<float, 64>(q, k, v, o, B, Sq, Sk, H, G, bq, bk,
                                       causal, scale, s)
                   : launch<float, 128>(q, k, v, o, B, Sq, Sk, H, G, bq, bk,
                                        causal, scale, s);
  }
  if (dtype == REPRO_BF16) {
    if (bq != sm90::kBQ || bk != sm90::kBK)
      return static_cast<int>(cudaErrorInvalidValue);
    return D == 64 ? sm90::launch<64>(q, k, v, o, B, Sq, Sk, H, G, causal,
                                      scale, s)
                   : sm90::launch<128>(q, k, v, o, B, Sq, Sk, H, G, causal,
                                       scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
