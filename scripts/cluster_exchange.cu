// The cluster exchange of the wide flash kernels, alone: each block of a
// thread-block cluster publishes a partial score tile, and every block
// sums the cluster's partials in rank order, its own from registers, the
// peers' through distributed shared memory.  Built and timed by
// scripts/cluster_exchange.py; no kernel of the port calls it.
//
// - f32 (probe_f32, the protocol of flash_fwd_wide in
//   csrc/flash_attention.cu): 256 threads, a 64 x 32 partial (8 floats a
//   thread) a step, double-buffered, one cluster barrier a step.
// - bf16 (probe_bf16): the protocols a cluster version of
//   flash_fwd_wide_sm90 would need, which its design rejects on these
//   times: 384 threads, the first warpgroup idle (the producer's place),
//   two consumer warpgroups each exchanging a 64 x 64 f32 partial (32
//   floats a thread) through double-buffered slots, five ways (kProto).
// Partial value of element i of thread t, tile j, rank r: r * 1024 + j + i,
// so every sum is an integer a float holds exactly; `work` dependent
// multiply-adds a tile before the exchange stand in for the tile's
// products.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kStageF4 = 2 * 8 * 128;  // float4s of one bf16 stage: 2 x 64 x 64

// Arrive on an mbarrier of any block of the cluster (a shared::cluster
// address), releasing this thread's earlier writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the writes the arrivals from
// other blocks released are visible once it returns.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Push 16 bytes into shared::cluster address `addr` of a peer block,
// completing them on that block's mbarrier at shared::cluster address `bar`
// (the peer arms it with the bytes it expects).
__device__ __forceinline__ void st_async_f4(uint32_t addr, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}


// `work` dependent multiply-adds that leave x as it was (x * 1 + 0), the
// stand-in for a tile's products.
__device__ __forceinline__ void busy(float& x, int work) {
  float one = 1.f + 0.f * x, zero = 0.f * x;
  for (int i = 0; i < work; ++i) x = fmaf(x, one, zero);
}

// Spin on an mbarrier's phase with the default (CTA-scope) acquire, then
// one cluster-scope fence, instead of an acquire at cluster scope on every
// try.
__device__ __forceinline__ void wait_then_fence(uint64_t* bar, int parity) {
  mbar_wait(bar, parity);
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

// One bulk copy (the TMA engine) of `bytes` from this block's shared memory
// to shared::cluster address `dst` of a peer, completing on the peer's
// mbarrier at shared::cluster address `bar`.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// kProto: 0 none; 1 pull, mbarriers waited with acquire at cluster scope;
// 2 pull, waited at CTA scope then one cluster fence; 3 pull after one
// cluster barrier of all threads a tile; 4 push (st.async into each peer's
// slot for this rank, completing on the peer's full barrier, which its own
// thread arms with the bytes expected); 5 push as one bulk copy a consumer
// and tile from a send slot of this block's (n = 2).
template <int kProto>
__global__ void __launch_bounds__(384, 1)
probe_bf16(float* __restrict__ out, int tiles, int n, int work) {
  extern __shared__ __align__(16) uint8_t smem[];
  // pull: [2 stages][2 consumers][8][128] float4; push (n = 2): [2][2][2
  // ranks][8][128]
  float4* X = reinterpret_cast<float4*>(smem);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(X + 2 * 2 * kStageF4);
  uint64_t* xempty = xfull + 4;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) {
      mbar_init(&xfull[i], kProto >= 4 ? 1 : 4 * n);
      mbar_init(&xempty[i], 4 * (kProto >= 4 ? n - 1 : n));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive();
  cluster_wait();
  if (tid < 128) {
    if (kProto == 3)
      for (int j = 0; j < tiles; ++j) {
        cluster_arrive();
        cluster_wait();
      }
  } else {
    const int c = tid / 128 - 1, t = tid % 128, lane = t % 32;
    float total = 0.f;
    for (int j = 0; j < tiles; ++j) {
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = rank * 1024.f + j + i;
      busy(sc[0], work);
      if (kProto != 0) {
        const int s = j & 1, ph = (j >> 1) & 1;
        uint64_t* full = &xfull[2 * s + c];
        uint64_t* empty = &xempty[2 * s + c];
        float own[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) own[i] = sc[i];
        if (kProto == 5) {
          // send: X[s][c][8][128]; receive: the same past both stages
          float4* send = X + (2 * s + c) * 8 * 128;
          float4* recv = X + 2 * kStageF4 + (2 * s + c) * 8 * 128;
          const uint32_t peer = rank ^ 1;
          if (t == 0) mbar_expect_tx(full, 8 * 128 * 16);
          mbar_wait_cluster(empty, ph ^ 1);
#pragma unroll
          for (int i4 = 0; i4 < 8; ++i4)
            send[i4 * 128 + t] = make_float4(sc[4 * i4], sc[4 * i4 + 1],
                                             sc[4 * i4 + 2], sc[4 * i4 + 3]);
          fence_proxy_async();
          asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
          if (t == 0)
            bulk_to_peer(cluster_addr(smem_u32(recv), peer), send,
                         8 * 128 * 16, cluster_addr(smem_u32(full), peer));
          mbar_wait(full, ph);
#pragma unroll
          for (int i4 = 0; i4 < 8; ++i4) {
            const float4 v = recv[i4 * 128 + t];
            const float4 o = make_float4(own[4 * i4], own[4 * i4 + 1],
                                         own[4 * i4 + 2], own[4 * i4 + 3]);
            const float4 a = rank == 0 ? o : v, b = rank == 0 ? v : o;
            sc[4 * i4] = a.x + b.x, sc[4 * i4 + 1] = a.y + b.y;
            sc[4 * i4 + 2] = a.z + b.z, sc[4 * i4 + 3] = a.w + b.w;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive_cluster(cluster_addr(smem_u32(empty), peer));
        } else if (kProto == 4) {
          // slot of rank p in any block: X[s][c][p][i4][t]
          float4* slot = X + ((2 * s + c) * 2) * 8 * 128 + t;
          if (t == 0) mbar_expect_tx(full, (n - 1) * 8 * 128 * 16);
          mbar_wait(empty, ph ^ 1);
          for (int p = 0; p < n; ++p) {
            if (p == static_cast<int>(rank)) continue;
            const uint32_t dst =
                cluster_addr(smem_u32(slot + rank * 8 * 128), p);
            const uint32_t bar = cluster_addr(smem_u32(full), p);
#pragma unroll
            for (int i4 = 0; i4 < 8; ++i4)
              st_async_f4(dst + i4 * 128 * 16,
                          make_float4(sc[4 * i4], sc[4 * i4 + 1],
                                      sc[4 * i4 + 2], sc[4 * i4 + 3]),
                          bar);
          }
          mbar_wait(full, ph);
          for (int p = 0; p < n; ++p) {
#pragma unroll
            for (int i4 = 0; i4 < 8; ++i4) {
              const float4 v =
                  p == static_cast<int>(rank)
                      ? make_float4(own[4 * i4], own[4 * i4 + 1],
                                    own[4 * i4 + 2], own[4 * i4 + 3])
                      : slot[(p * 8 + i4) * 128];
              if (p == 0) {
                sc[4 * i4] = v.x, sc[4 * i4 + 1] = v.y;
                sc[4 * i4 + 2] = v.z, sc[4 * i4 + 3] = v.w;
              } else {
                sc[4 * i4] += v.x, sc[4 * i4 + 1] += v.y;
                sc[4 * i4 + 2] += v.z, sc[4 * i4 + 3] += v.w;
              }
            }
          }
          __syncwarp();
          if (lane == 0)
            for (int p = 0; p < n; ++p)
              if (p != static_cast<int>(rank))
                mbar_arrive_cluster(cluster_addr(smem_u32(empty), p));
        } else {
          float4* mine = X + (2 * s + c) * 8 * 128 + t;
          if (kProto == 1) mbar_wait_cluster(empty, ph ^ 1);
          if (kProto == 2) wait_then_fence(empty, ph ^ 1);
#pragma unroll
          for (int i4 = 0; i4 < 8; ++i4)
            mine[i4 * 128] = make_float4(sc[4 * i4], sc[4 * i4 + 1],
                                         sc[4 * i4 + 2], sc[4 * i4 + 3]);
          if (kProto == 3) {
            cluster_arrive();
            cluster_wait();
          } else {
            __syncwarp();
            if (lane == 0)
              for (int p = 0; p < n; ++p)
                mbar_arrive_cluster(cluster_addr(smem_u32(full), p));
            if (kProto == 1) mbar_wait_cluster(full, ph);
            if (kProto == 2) wait_then_fence(full, ph);
          }
          for (int p = 0; p < n; ++p) {
            const uint32_t base = cluster_addr(smem_u32(mine), p);
#pragma unroll
            for (int i4 = 0; i4 < 8; ++i4) {
              const float4 v =
                  p == static_cast<int>(rank)
                      ? make_float4(own[4 * i4], own[4 * i4 + 1],
                                    own[4 * i4 + 2], own[4 * i4 + 3])
                      : ld_cluster_f4(base + i4 * 128 * 16);
              if (p == 0) {
                sc[4 * i4] = v.x, sc[4 * i4 + 1] = v.y;
                sc[4 * i4 + 2] = v.z, sc[4 * i4 + 3] = v.w;
              } else {
                sc[4 * i4] += v.x, sc[4 * i4 + 1] += v.y;
                sc[4 * i4 + 2] += v.z, sc[4 * i4 + 3] += v.w;
              }
            }
          }
          if (kProto != 3) {
            __syncwarp();
            if (lane == 0)
              for (int p = 0; p < n; ++p)
                mbar_arrive_cluster(cluster_addr(smem_u32(empty), p));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) total += sc[i];
    }
    const int64_t blk = static_cast<int64_t>(blockIdx.x) * gridDim.z +
                        blockIdx.z;
    out[blk * 256 + c * 128 + t] = total;
  }
  cluster_arrive();
  cluster_wait();
}

template <bool kExchange>
__global__ void __launch_bounds__(256, 1)
probe_f32(float* __restrict__ out, int tiles, int n, int work) {
  extern __shared__ __align__(16) uint8_t smem[];
  float4* X = reinterpret_cast<float4*>(smem);  // [2 stages][2][256]
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  float total = 0.f;
  for (int j = 0; j < tiles; ++j) {
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = rank * 1024.f + j + i;
    busy(s[0], work);
    if (kExchange) {
      float4* mine = X + (j & 1) * 512 + tid;
      mine[0] = make_float4(s[0], s[1], s[2], s[3]);
      mine[256] = make_float4(s[4], s[5], s[6], s[7]);
      cluster_arrive();
      cluster_wait();
      const float own[8] = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
      for (int p = 0; p < n; ++p) {
        const uint32_t base = cluster_addr(smem_u32(mine), p);
        const bool me = p == static_cast<int>(rank);
        const float4 a = me ? make_float4(own[0], own[1], own[2], own[3])
                            : ld_cluster_f4(base);
        const float4 b = me ? make_float4(own[4], own[5], own[6], own[7])
                            : ld_cluster_f4(base + 4096);
        const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = p == 0 ? v[i] : s[i] + v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) total += s[i];
  }
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * gridDim.z +
                      blockIdx.z;
  out[blk * 256 + tid] = total;
  cluster_arrive();
  cluster_wait();
}

template <typename K>
int launch(K kern, int threads, float* out, int clusters, int n, int tiles,
           int smem, cudaStream_t stream, int* active, int work) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, 1, n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active) {
    err = cudaOccupancyMaxActiveClusters(active, kern, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaLaunchKernelEx(&cfg, kern, out, tiles, n, work);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// mode 0: the bf16 protocols (`proto` 0-4, probe_bf16), 1: the f32 one
// (`proto` 0 without the exchange, else with it).  `active` (may be null)
// receives cudaOccupancyMaxActiveClusters.
REPRO_EXPORT int cluster_exchange_launch(int mode, int proto, float* out,
                                         int clusters, int n, int tiles,
                                         int smem, void* stream, int* active,
                                         int work) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return proto ? launch(probe_f32<true>, 256, out, clusters, n, tiles, smem,
                          s, active, work)
                 : launch(probe_f32<false>, 256, out, clusters, n, tiles,
                          smem, s, active, work);
  switch (proto) {
    case 0: return launch(probe_bf16<0>, 384, out, clusters, n, tiles, smem, s, active, work);
    case 1: return launch(probe_bf16<1>, 384, out, clusters, n, tiles, smem, s, active, work);
    case 2: return launch(probe_bf16<2>, 384, out, clusters, n, tiles, smem, s, active, work);
    case 3: return launch(probe_bf16<3>, 384, out, clusters, n, tiles, smem, s, active, work);
    case 4: return launch(probe_bf16<4>, 384, out, clusters, n, tiles, smem, s, active, work);
    default: return launch(probe_bf16<5>, 384, out, clusters, n, tiles, smem, s, active, work);
  }
}
