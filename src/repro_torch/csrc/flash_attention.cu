// Flash attention forward (GQA, optional causal mask) on Hopper.
//
// Replaces the Pallas kernel flash_attention of
// src/repro/kernels/flash_attention/kernel.py (pallas_call at :108), whose
// grid (b*h, n_q, n_kv) carries the online-softmax state (m, l, acc) in
// VMEM scratch across the sequential kv axis.  On Hopper blocks run in no
// order, so one block owns one (b*h, q tile) and loops the kv axis itself:
// the Q tile stays in shared memory, K/V stream through shared memory in
// 32-row chunks, and m, l, acc stay in f32 (acc in registers).
//
// Bound on the card: operations.  Attention at these shapes does ~4*D
// flops per (query, key) pair against ~4*D bytes per query row, far above
// the H100's ~20 f32 flops per byte of HBM, so it is limited by the FMA
// rate; this first version runs on the CUDA cores (f32 FMAs, register
// tiles of 4x4 scores and 4xD/8 outputs per thread) and leaves the tensor
// cores to a later kernel.
//
// Semantics kept from the reference: scale D^-0.5 applied after the dot;
// causal mask qpos >= kpos on absolute positions, with masked scores set
// to -1e30 (not -inf) and whole kv tiles above the diagonal skipped
// (ki*bk > qi*bq + bq - 1); out = acc / max(l, 1e-30).  q is
// [B, Sq, H, D], k and v [B, Sk, G, D]; head h reads kv head h / (H/G).
#include "common.cuh"

namespace {

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

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int G, int D, int bq, int bk, int causal,
               float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, G, bq, bk, causal, scale, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, G, bq, bk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Contract (checked by the Python wrapper): contiguous inputs, D in {64,
// 128}, 0 < bq <= 128, Sq % bq == 0, bk % 32 == 0, Sk % bk == 0, H % G == 0.
REPRO_EXPORT int flash_attention_launch(int dtype, const void* q, const void* k,
                                        const void* v, void* o, int B, int Sq,
                                        int Sk, int H, int G, int D, int bq,
                                        int bk, int causal, float scale,
                                        void* stream) {
  if (bq <= 0 || bq > kMaxBQ || Sq % bq || bk % kKC || Sk % bk || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, G, D, bq, bk, causal,
                             scale, s);
  if (dtype == REPRO_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, G, D, bq, bk,
                                     causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
