// Batched row scatter-add, out[g, idx[g, m], :] += values[g, m, :], for
// Hopper.
//
// Replaces the Pallas kernel ctts_tpu/ops/sort_gather.py:92 (_scatter_kernel,
// launched by _scatter_tpu at :123-137 under scatter_rows :164). On the TPU
// the scatter is the transposed one-hot [n_out, BM] x [BM, F] matmul,
// accumulated over source tiles in f32. Here it is the backward of the
// length-regulator upsample (ctts_torch/ops/length_regulator.py), where idx
// is the non-decreasing mel2ph map and every padded frame lands in row 0;
// the reformer's un-sort, where idx is a permutation; and the LSH chunk
// backward's sum, where each output row has n_hashes sources.
//
// What bounds it on the H100: bytes. G*M*F values and G*M indices are read
// once and G*n_out*F sums written once; there is one add per value. At the
// train step's shape (G=16, M=896, n_out=129, F=256, f32) that is ~17 MB,
// about 5 us at 3.35 TB/s; at the un-sort (G=64, M=n_out=3584, F=129) about
// 0.07 ms.
//
// Design: a plan, then a walk, two launches; no float atomics, so two runs
// give the same bits.
//  1. The plan, one block per group: the count of sources of every output
//     row (shared-memory atomics, whose result does not depend on their
//     order), an exclusive scan of the counts into row starts
//     starts[g, 0..n_out], and the source list src[g, :], the m of every
//     in-range index grouped by row in ascending m. Equal indices are
//     ranked within a warp by __match_any_sync; the warps of the block then
//     take their row cursors in turn, warp 0 first, so the list's order is
//     fixed. An index outside [0, n_out) is dropped, as the one-hot has no
//     row for it. Rows are counted kKeyWindow at a time (one window for any
//     n_out the model gives).
//  2. The walk: a block of kWalkWarps warps takes a run of consecutive
//     output rows of one group (rows_per_block, set by the wrapper so that a
//     block holds a few sources a warp on average) and the columns
//     [f0, f0 + 32*kCols). The block's sources, contiguous in src, are cut
//     into kWalkWarps equal parts, one a warp, so a long row (the length
//     regulator's row 0, hundreds of sources) is spread over the warps. A
//     warp adds its sources in list order into float32 registers, lanes
//     along F (4-byte loads, so any F, coalesced; kAhead rows loaded ahead
//     of their adds); a row wholly inside its part is written at once, the
//     partial sums of a row cut by a part's edge go to shared memory and
//     are added in warp order by the warp where the row starts. Each row is
//     written once, in the values' dtype; a row with no source is zero.
// A permutation gives every row one source, 0 + v: bit-exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanWarps = 16;
constexpr int kPlanThreads = kPlanWarps * 32;
constexpr int kKeyWindow = 8192;  // output rows counted per pass over idx
constexpr int kWalkWarps = 16;
constexpr int kCols = 8;          // columns a lane holds: 32*8 = 256 a block
constexpr int kAhead = 4;         // source rows loaded ahead of their adds
constexpr unsigned kFull = 0xffffffffu;

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

// Exclusive scan of a[0, n) in place by the whole block; returns the total.
__device__ int block_scan(int* a, int n, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (n + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int inc = sum;                                   // inclusive, in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kPlanWarps ? warp_sums[lane] : 0;
    int w_inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w_inc, o);
      if (lane >= o) w_inc += u;
    }
    if (lane < kPlanWarps) warp_sums[lane] = w_inc - v;
    if (lane == kPlanWarps - 1) warp_sums[kPlanWarps] = w_inc;
  }
  __syncthreads();
  int run = warp_sums[warp] + inc - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  const int total = warp_sums[kPlanWarps];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ idx, int* __restrict__ starts,
            int* __restrict__ src, int m, int n_out) {
  __shared__ int cursor[kKeyWindow];
  __shared__ int warp_sums[kPlanWarps + 1];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long g = blockIdx.x;
  const int* gi = idx + g * m;
  int* gs = starts + g * (n_out + 1);
  int* gsrc = src + g * m;
  int placed = 0;                         // sources of the earlier windows
  for (int k0 = 0; k0 < n_out; k0 += kKeyWindow) {
    const int nk = min(kKeyWindow, n_out - k0);
    for (int i = tid; i < nk; i += kPlanThreads) cursor[i] = 0;
    __syncthreads();
    for (int mm = tid; mm < m; mm += kPlanThreads) {
      const int key = gi[mm] - k0;
      if (key >= 0 && key < nk) atomicAdd(&cursor[key], 1);
    }
    __syncthreads();
    const int total = block_scan(cursor, nk, warp_sums);
    for (int i = tid; i < nk; i += kPlanThreads) gs[k0 + i] = placed + cursor[i];
    __syncthreads();                      // every start read before a cursor moves
    // place the sources in ascending m, kPlanThreads at a time
    for (int m0 = 0; m0 < m; m0 += kPlanThreads) {
      const int mm = m0 + tid;
      const int key = mm < m ? gi[mm] - k0 : -1;
      const bool in = key >= 0 && key < nk;
      const unsigned peers = __match_any_sync(kFull, in ? key : -1);
      const int leader = __ffs(peers) - 1;
      const int rank = __popc(peers & ((1u << lane) - 1));
      int base = 0;
      for (int w = 0; w < kPlanWarps; ++w) {       // the warps in turn
        if (warp == w && in && lane == leader) {
          base = cursor[key];
          cursor[key] = base + __popc(peers);
        }
        __syncthreads();
      }
      base = __shfl_sync(kFull, base, leader);
      if (in) gsrc[placed + base + rank] = mm;
    }
    placed += total;
    __syncthreads();
  }
  if (tid == 0) gs[n_out] = placed;
}

// the row of rows [n0, n1) whose sources hold list position p (gs[n0] <= p <
// gs[n1]): the last row r with gs[r] <= p
__device__ __forceinline__ int row_of(const int* gs, int n0, int n1, int p) {
  int lo = n0, hi = n1 - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (gs[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kWalkWarps * 32)
walk_kernel(const T* __restrict__ values, const int* __restrict__ starts,
            const int* __restrict__ src, T* __restrict__ out, int m,
            int n_out, int f, int rows_per_block, int blocks_per_group) {
  __shared__ float part[kWalkWarps][2][32 * kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g = blockIdx.x / blocks_per_group;
  const int n0 = (blockIdx.x % blocks_per_group) * rows_per_block;
  const int n1 = min(n0 + rows_per_block, n_out);
  const int f0 = blockIdx.y * 32 * kCols;
  const int* gs = starts + g * (n_out + 1);
  const int* gsrc = src + g * m;
  const T* gv = values + g * m * static_cast<long long>(f);
  T* go = out + g * n_out * static_cast<long long>(f);
  const int a = gs[n0], len = gs[n1] - a;
  // this warp's part of the block's sources, and where part w begins
  auto begin = [&](int w) {
    return a + static_cast<int>(static_cast<long long>(len) * w / kWalkWarps);
  };
  const int pb = begin(warp), pe = begin(warp + 1);
  int col[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) col[c] = f0 + lane + 32 * c;

  auto write = [&](int r, const float (&acc)[kCols]) {
    T* dst = go + static_cast<long long>(r) * f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (col[c] < f) dst[col[c]] = from_f32<T>(acc[c]);
  };

  for (int r = n0 + warp; r < n1; r += kWalkWarps) {  // rows with no source
    if (gs[r + 1] != gs[r]) continue;
    float zero[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) zero[c] = 0.f;
    write(r, zero);
  }

  const int first_row = pb < pe ? row_of(gs, n0, n1, pb) : n0;
  int r = first_row, slot = 0;
  for (int p = pb; p < pe;) {
    while (gs[r + 1] <= p) ++r;                   // the row holding source p
    const int rs = gs[r], re = gs[r + 1], q = min(re, pe);
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (; p < q; p += kAhead) {
      float v[kAhead][kCols];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const T* row = gv + static_cast<long long>(p + u < q ? gsrc[p + u] : 0) * f;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          v[u][c] = (p + u < q && col[c] < f) ? to_f32<T>(row[col[c]]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (p + u < q) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] += v[u][c];
        }
    }
    p = q;
    if (rs >= pb && re <= pe) {
      write(r, acc);                              // the whole row is here
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[warp][slot][lane + 32 * c] = acc[c];
    }
    slot = 1;
  }
  __syncthreads();

  // a row cut by this part's end and starting in it: add the parts in order
  if (pb < pe) {
    const int r_last = row_of(gs, n0, n1, pe - 1);
    const int rs = gs[r_last], re = gs[r_last + 1];
    if (re > pe && rs >= pb) {
      float acc[kCols];
      const int s0 = r_last == first_row ? 0 : 1;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = part[warp][s0][lane + 32 * c];
      for (int w = warp + 1; w < kWalkWarps && begin(w) < re; ++w) {
        if (begin(w) == begin(w + 1)) continue;   // an empty part
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += part[w][0][lane + 32 * c];
      }
      write(r_last, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* values, const int* idx, void* out, int* starts,
                   int* src, int g, int m, int n_out, int f, int rows_per_block,
                   cudaStream_t stream) {
  plan_kernel<<<g, kPlanThreads, 0, stream>>>(idx, starts, src, m, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_group = (n_out + rows_per_block - 1) / rows_per_block;
  const long long blocks = static_cast<long long>(g) * per_group;
  const int fchunks = (f + 32 * kCols - 1) / (32 * kCols);
  if (blocks > 0x7fffffffLL || fchunks > 65535) return cudaErrorInvalidValue;
  walk_kernel<T><<<dim3(static_cast<unsigned>(blocks), fchunks),
                   kWalkWarps * 32, 0, stream>>>(
      static_cast<const T*>(values), starts, src, static_cast<T*>(out), m,
      n_out, f, rows_per_block, per_group);
  return cudaGetLastError();
}

}  // namespace

// values [G, M, F], idx [G, M] int32, out [G, n_out, F] (every element is
// written); starts [G, n_out + 1] and src [G, M] int32 are scratch the
// plan fills; rows_per_block: output rows of one walk block. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int ctts_scatter_rows(const void* values, const int* idx, void* out,
                                 int* starts, int* src, long long g,
                                 long long m, long long n_out, long long f,
                                 long long rows_per_block, int dtype,
                                 void* stream) {
  if (g < 0 || m < 0 || n_out < 0 || f < 0 || g > 0x7fffffffLL ||
      m > 0x7fffffffLL || n_out >= 0x7fffffffLL || f > 0x7fffffffLL ||
      rows_per_block <= 0 || rows_per_block > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (g * n_out == 0 || f == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gi = static_cast<int>(g), mi = static_cast<int>(m),
            ni = static_cast<int>(n_out), fi = static_cast<int>(f),
            ri = static_cast<int>(rows_per_block);
  if (dtype == 0)
    return launch<float>(values, idx, out, starts, src, gi, mi, ni, fi, ri, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(values, idx, out, starts, src, gi, mi, ni,
                                 fi, ri, s);
  return cudaErrorInvalidValue;
}
