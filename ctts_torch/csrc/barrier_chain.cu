// Measuring sticks, not kernels of the model. chip_smoke.py times them
// beside the chain kernels.
//
// barrier_chain_kernel: a chain of dependent frames in which each frame is
// one shared-memory write, one __syncthreads() and one read of the
// neighbour's value. That is the skeleton of forward_sum.cu (and of mas.cu
// before its chain moved into one warp) with the arithmetic and the
// device-memory traffic taken out, so its time is the floor that one
// barrier a frame sets at a given (blocks, threads, frames).
//
// warp_chain_kernel<K>: the skeleton of mas.cu's chain warp. One warp a
// block; lane L owns K columns and runs kSkew steps behind lane L-1; a step
// is one __shfl_up_sync of the previous step's highest column, used kSkew
// steps later, and compare -> select -> add on the K columns, with no
// device-memory traffic and no move bits. It runs frames + kSkew*31 steps,
// so its time is the floor of that chain at a given (blocks, frames, K).
//
// cluster_chain_kernel<P2P>: the skeleton of forward_sum.cu's cluster
// lattice. A chain is a cluster of C CTAs. With P2P false a frame is one
// DSMEM store of one float into the next CTA's shared memory and one
// cluster barrier. With P2P, as the lattice hands its ghost states over,
// every `span` frames thread 0 stores one float into the next CTA by
// st.async, counted on that CTA's mbarrier, which that CTA's thread 0 waits
// on before its next frame (a ring of kHalo slots, handed back by st.async
// on "empty" barriers), and every frame is one __syncthreads() in each CTA.
// No arithmetic and no device-memory traffic: its time is the floor of
// that handoff at a given (chains, CTAs, threads, frames, span).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSkew = 2;             // as in mas.cu
constexpr int kHalo = 8;             // as in forward_sum.cu

__global__ void barrier_chain_kernel(float* __restrict__ out, int frames) {
  extern __shared__ float rows[];
  float* buf0 = rows;
  float* buf1 = rows + blockDim.x;
  const int s = threadIdx.x;
  float mine = static_cast<float>(s);
  buf0[s] = mine;
  __syncthreads();
  for (int t = 1; t < frames; ++t) {
    const float* prev = (t & 1) ? buf0 : buf1;
    float* next = (t & 1) ? buf1 : buf0;
    mine = fmaxf(mine, s > 0 ? prev[s - 1] : mine) + 1.f;
    next[s] = mine;
    __syncthreads();
  }
  out[static_cast<size_t>(blockIdx.x) * blockDim.x + s] = mine;
}

template <int K>
__global__ void warp_chain_kernel(float* __restrict__ out, int steps) {
  const int lane = threadIdx.x;
  float lp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lp[k] = static_cast<float>(lane * K + k);
  float lefts[kSkew];
#pragma unroll
  for (int j = 0; j < kSkew; ++j) lefts[j] = -1e30f;
  for (int s = 0; s < steps; s += 32) {
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      // a value that changes every step and is not known ahead
      const float la = __int_as_float(0xbf800000 | ((s + u) & 7));
      const float nxt = __shfl_up_sync(0xffffffffu, lp[K - 1], 1);
      float sh = lefts[0];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float here = lp[k];
        lp[k] = la + (sh >= here ? sh : here);
        sh = here;
      }
#pragma unroll
      for (int j = 0; j + 1 < kSkew; ++j) lefts[j] = lefts[j + 1];
      lefts[kSkew - 1] = lane == 0 ? -1e30f : nxt;
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) sum += lp[k];
  out[static_cast<size_t>(blockIdx.x) * 32 + lane] = sum;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void store_tx(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void arm(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <bool P2P>
__global__ void cluster_chain_kernel(float* __restrict__ out, int frames,
                                     int span) {
  __shared__ uint64_t full[kHalo], empty[kHalo];
  __shared__ float halo[kHalo], ack[kHalo];
  unsigned rank, n_cta;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n_cta));
  const int r = static_cast<int>(rank), n = static_cast<int>(n_cta);
  const int tid = threadIdx.x;
  // handoffs after frames span, 2*span, .. below frames - 1
  const int n_hand = frames > 1 ? (frames - 2) / span : 0;
  float mine = static_cast<float>(tid);
  if (tid == 0) {
    for (int j = 0; j < kHalo; ++j) {
      halo[j] = 0.f;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&full[j])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&empty[j])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kHalo; ++j) {
      arm(&full[j], 4);
      arm(&empty[j], 4);
    }
  }
  cluster_sync();
  for (int t = 0; t < frames; ++t) {
    if (!P2P && t > 0 && tid == 0 && r > 0) mine += halo[(t - 1) & 1];
    if (P2P && t > span && (t - 1) % span == 0 && tid == 0 && r > 0) {
      const int u = (t - 1) / span - 1, slot = u % kHalo;
      bar_wait(&full[slot], (u / kHalo) & 1);
      const float h = halo[slot];
      mine += h;
      arm(&full[slot], 4);
      if (u + kHalo < n_hand)                   // where the slot is reused
        store_tx(peer(&ack[slot], r - 1), h, peer(&empty[slot], r - 1));
    }
    mine += 1.f;
    if (tid == 0 && r + 1 < n) {
      if (!P2P && t + 1 < frames)
        asm volatile("st.shared::cluster.f32 [%0], %1;\n"
                     :: "r"(peer(&halo[t & 1], r + 1)), "f"(mine) : "memory");
      if (P2P && t > 0 && t % span == 0 && t + 1 < frames) {
        const int u = t / span - 1, slot = u % kHalo;
        if (u >= kHalo) {
          bar_wait(&empty[slot], ((u / kHalo) - 1) & 1);
          arm(&empty[slot], 4);
        }
        store_tx(peer(&halo[slot], r + 1), mine, peer(&full[slot], r + 1));
      }
    }
    if (P2P) __syncthreads(); else cluster_sync();
  }
  cluster_sync();
  out[static_cast<size_t>(blockIdx.x) * blockDim.x + tid] = mine;
}

template <int K>
cudaError_t warp_chain(float* out, int blocks, int steps, cudaStream_t stream) {
  warp_chain_kernel<K><<<blocks, 32, 0, stream>>>(out, steps);
  return cudaGetLastError();
}

}  // namespace

// out [blocks, threads] float32; threads a multiple of 32, at most 1024.
extern "C" int ctts_barrier_chain(float* out, int blocks, int threads,
                                  int frames, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024 || threads % 32 || frames < 1)
    return cudaErrorInvalidValue;
  barrier_chain_kernel<<<blocks, threads, 2 * threads * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(out, frames);
  return cudaGetLastError();
}

// out [blocks, 32] float32; k in {1, 2, 4, 8, 16, 24, 32} columns a lane;
// frames + kSkew*31 steps, rounded up to whole blocks of 32 as mas.cu runs
// them.
extern "C" int ctts_warp_chain(float* out, int blocks, int frames, int k,
                               void* stream) {
  if (blocks <= 0 || frames < 1) return cudaErrorInvalidValue;
  const int steps = (frames + kSkew * 31 + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return warp_chain<1>(out, blocks, steps, s);
    case 2: return warp_chain<2>(out, blocks, steps, s);
    case 4: return warp_chain<4>(out, blocks, steps, s);
    case 8: return warp_chain<8>(out, blocks, steps, s);
    case 16: return warp_chain<16>(out, blocks, steps, s);
    case 24: return warp_chain<24>(out, blocks, steps, s);
    case 32: return warp_chain<32>(out, blocks, steps, s);
    default: return cudaErrorInvalidValue;
  }
}

// out [chains * ctas, threads] float32; a cluster of `ctas` (1..8) CTAs a
// chain, threads a multiple of 32 up to 1024, `frames` frames; span > 0:
// the mbarrier handoff every `span` frames, span 0: one cluster barrier a
// frame.
extern "C" int ctts_cluster_chain(float* out, int chains, int ctas,
                                  int threads, int frames, int span,
                                  void* stream) {
  if (chains <= 0 || ctas < 1 || ctas > 8 || threads <= 0 || threads > 1024 ||
      threads % 32 || frames < 1 || span < 0)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(chains * ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return span ? cudaLaunchKernelEx(&cfg, cluster_chain_kernel<true>, out,
                                   frames, span)
              : cudaLaunchKernelEx(&cfg, cluster_chain_kernel<false>, out,
                                   frames, 1);
}
