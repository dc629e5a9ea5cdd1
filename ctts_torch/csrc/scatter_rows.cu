// Batched row scatter-add, out[g, idx[g, m], :] += values[g, m, :], for
// Hopper.
//
// Replaces the Pallas kernel ctts_tpu/ops/sort_gather.py:92 (_scatter_kernel,
// launched by _scatter_tpu at :123-137 under scatter_rows :164). On the TPU
// the scatter is the transposed one-hot [n_out, BM] x [BM, F] matmul,
// accumulated over source tiles in f32. Here it is the backward of the
// length-regulator upsample (ctts_torch/ops/length_regulator.py), where idx
// is the non-decreasing mel2ph map, and later the un-sort of the reformer,
// where idx is a permutation.
//
// What bounds it on the H100: bytes. G*M*F values and G*M indices are read
// once and G*n_out*F sums written once; there is one add per value. At the
// train step's shape (G=16, M=896, n_out=129, F=256, f32) that is ~17 MB,
// about 5 us at 3.35 TB/s.
//
// Design, output-stationary: one warp owns one output row (g, n). It scans
// idx[g, :] (coalesced loads, one ballot per 32 entries), and for every
// match, in ascending m, its lanes add values[g, m, :] into f32 registers.
// The row is written once, in the values' dtype. There are no atomics and
// no zero-fill pass, the order of the adds is fixed (so two runs give the
// same bits), and any idx is right: sorted, a permutation or repeated. An index outside [0, n_out) matches no row and adds nothing, as
// the one-hot has no row for it. Every warp of a group reads the whole index
// row again (n_out * M * 4 bytes per group, from L2); a binary search for a
// sorted idx would save that and is left for later. The longest row sets the
// time: with the length regulator's map every padded frame lands in row 0,
// so one warp per utterance adds hundreds of rows one after the other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // output rows per block
constexpr int kCols = 8;      // feature columns per lane and pass (32*8 = 256)
constexpr int kScan = 8;      // index words per lane loaded ahead of the ballots
constexpr int kAhead = 4;     // matching rows loaded ahead of their adds

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
scatter_rows_kernel(const T* __restrict__ values, const int* __restrict__ idx,
                    T* __restrict__ out, long long rows, int m, int n_out,
                    int f) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;                     // whole warps leave together
  const int lane = threadIdx.x % 32;
  const long long g = row / n_out;
  const int n = static_cast<int>(row % n_out);
  const int* gi = idx + g * m;
  const T* gv = values + g * static_cast<long long>(m) * f;
  T* dst = out + row * f;

  for (int f0 = 0; f0 < f; f0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int m0 = 0; m0 < m; m0 += 32 * kScan) {
      int mine[kScan];                          // kScan independent loads
#pragma unroll
      for (int k = 0; k < kScan; ++k) {
        const int mm = m0 + 32 * k + lane;
        mine[k] = mm < m ? gi[mm] : -1;         // -1 is no row
      }
#pragma unroll
      for (int k = 0; k < kScan; ++k) {
        unsigned mask = __ballot_sync(0xffffffffu, mine[k] == n);
        while (mask) {                          // ascending m
          // the rows of up to kAhead matches are loaded together and then
          // added one after the other, so a long run of matches (the
          // padded frames that all land in row 0) pays the memory latency
          // once per kAhead rows
          T rows[kAhead][kCols];
          int taken = 0;
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            if (mask == 0) continue;
            const int src = m0 + 32 * k + __ffs(mask) - 1;
            mask &= mask - 1;
            ++taken;
            const T* from = gv + static_cast<long long>(src) * f + f0;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              const int col = lane + 32 * c;
              rows[u][c] = f0 + col < f ? from[col] : from_f32<T>(0.f);
            }
          }
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            if (u >= taken) continue;
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[c] += to_f32<T>(rows[u][c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = f0 + lane + 32 * c;
      if (col < f) dst[col] = from_f32<T>(acc[c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* values, const int* idx, void* out, long long g,
                   int m, int n_out, int f, cudaStream_t stream) {
  const long long rows = g * n_out;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  scatter_rows_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(values), idx, static_cast<T*>(out), rows, m,
      n_out, f);
  return cudaGetLastError();
}

}  // namespace

// values [G, M, F], idx [G, M] int32, out [G, n_out, F] (every element is
// written). dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
extern "C" int ctts_scatter_rows(const void* values, const int* idx, void* out,
                                 long long g, long long m, long long n_out,
                                 long long f, int dtype, void* stream) {
  if (g < 0 || m < 0 || n_out < 0 || f < 0 || m > 0x7fffffffLL ||
      n_out > 0x7fffffffLL || f > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (g * n_out == 0 || f == 0) return cudaSuccess;
  if ((g * n_out + kWarps - 1) / kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(values, idx, out, g, static_cast<int>(m),
                         static_cast<int>(n_out), static_cast<int>(f), s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(values, idx, out, g, static_cast<int>(m),
                                 static_cast<int>(n_out), static_cast<int>(f), s);
  return cudaErrorInvalidValue;
}
