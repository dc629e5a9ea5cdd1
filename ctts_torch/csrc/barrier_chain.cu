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

#include <cuda_runtime.h>

namespace {

constexpr int kSkew = 2;             // as in mas.cu

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

// out [blocks, 32] float32; k in {1, 2, 4, 8, 16, 32} columns a lane;
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
    case 32: return warp_chain<32>(out, blocks, steps, s);
    default: return cudaErrorInvalidValue;
  }
}
