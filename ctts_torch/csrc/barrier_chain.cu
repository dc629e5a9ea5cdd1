// A measuring stick, not a kernel of the model: the time of a chain of
// dependent frames in which each frame is one shared-memory write, one
// __syncthreads() and one read of the neighbour's value. That is the
// skeleton of mas.cu and forward_sum.cu with the arithmetic and the
// device-memory traffic taken out, so its time is the floor the
// sequential chain sets for them at a given (blocks, threads, frames).
// chip_smoke.py times it beside those kernels.

#include <cuda_runtime.h>

namespace {

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
