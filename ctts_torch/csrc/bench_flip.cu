// The relative-position backward's absolute-to-relative scatter, in the four
// forms that tools/bench_flip.py times on the TPU, for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/bench_flip.py:67 (_kernel, built by
// _build at :115-122). That tool measures how the TPU can express the
// relpos backward's per-row roll whose amount descends with the row: each
// variant loads a [BQ, T] tile of dS (bf16), widens it to WPAD lanes with
// zeros (WPAD = 2T+1 rounded up to 128), rolls row r of the tile by
// shift_r (pltpu.roll with stride 1 along the rows: out[m] = in[m - shift_r]
// modulo WPAD) and writes out[c] = bf16(dW[c] + dW[c + T + 1]) for c < T
// (_scatter_tail). The variants differ in the row and lane order fed to the
// roll and in the shift (q0 = the tile's first row):
//   0 baseline  rows as they are,          shift q0 + 1 + r
//   1 row_flip  row BQ-1-r of the tile,     shift T - BQ - q0 + r
//   2 lane_rev  row r, lanes reversed,      shift q0 + 1 + r
//   3 ladder    rows as they are,          shift (T-1-q0) - r (+WPAD if < 0)
// The TPU forms the flips as permutation matmuls and the ladder as eleven
// conditional rolls; on the card each variant is the same indexed copy with
// its own index arithmetic, one kernel with the variant as an argument.
// The sum of two bf16 values is taken in f32 and rounded once, as the TPU
// kernel does, so the result is bit-exact against the plain version.
//
// What bounds it on the H100: bytes. Each output element reads two input
// elements of its own row, so the function moves the input once and the
// output once, 2 * 2 * N*T*T bytes: 0.12 ms at [128, 896, 896].
//
// Design: one block per (row, n); its threads walk the row's T outputs,
// consecutive threads on consecutive outputs, so the two reads of a warp
// cover a contiguous (or reversed contiguous) run of the source row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int m, int w) {
  m %= w;
  return m < 0 ? m + w : m;
}

__global__ void __launch_bounds__(kThreads)
flip_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
            int t, int bq, int wpad, int variant) {
  const int q = blockIdx.x;
  const size_t plane = static_cast<size_t>(blockIdx.y) * t * t;
  const int q0 = q - q % bq, r = q % bq;
  const int src_row = variant == 1 ? q0 + bq - 1 - r : q;
  int shift;
  switch (variant) {
    case 1: shift = t - bq - q0 + r; break;
    case 3: shift = (t - 1 - q0) - r; if (shift < 0) shift += wpad; break;
    default: shift = q0 + 1 + r;
  }
  const __nv_bfloat16* row = x + plane + static_cast<size_t>(src_row) * t;
  __nv_bfloat16* dst = out + plane + static_cast<size_t>(q) * t;
  for (int c = threadIdx.x; c < t; c += kThreads) {
    const int m1 = wrap(c - shift, wpad), m2 = wrap(c + t + 1 - shift, wpad);
    float s = 0.f;
    if (m1 < t) s += __bfloat162float(row[variant == 2 ? t - 1 - m1 : m1]);
    if (m2 < t) s += __bfloat162float(row[variant == 2 ? t - 1 - m2 : m2]);
    dst[c] = __float2bfloat16(s);
  }
}

}  // namespace

// x, out [n, t, t] bfloat16; bq divides t; wpad >= 2t+1. Returns a
// cudaError_t (0 = launched).
extern "C" int ctts_bench_flip(const void* x, void* out, int n, int t, int bq,
                               int wpad, int variant, void* stream) {
  if (n == 0 || t == 0) return cudaSuccess;
  if (n < 0 || n > 65535 || t < 0 || bq <= 0 || t % bq != 0 ||
      wpad < 2 * t + 1 || variant < 0 || variant > 3)
    return cudaErrorInvalidValue;
  flip_kernel<<<dim3(t, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      t, bq, wpad, variant);
  return cudaGetLastError();
}
