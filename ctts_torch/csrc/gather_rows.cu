// Batched row gather, out[g, m, :] = values[g, idx[g, m], :], for Hopper.
//
// Replaces the Pallas kernel ctts_tpu/ops/sort_gather.py:84 (_gather_kernel,
// launched by _gather_tpu at :110 under gather_rows :145). On the TPU the
// gather is a one-hot [N, BM] x [N, F] matmul on the MXU, because XLA
// lowers take_along_axis there to a serial per-index loop. On Hopper it is
// what it is: a copy of rows by index.
//
// What bounds it on the H100: data movement, G*M*F elements written and at
// most G*N*F read (plus G*M indices), at 3.35 TB/s. At the served shape
// (G=4, N=97, M=1152, F=256, f32) that is 5.1 MB, 1.5 us, so two dependent
// memory latencies (the index, then the row) and the launch are most of a
// call.
//
// Design: the output is a flat run of words (16 bytes; 8, 4, 2 or 1 when
// the row size or the pointers are not 16-byte aligned), word e of row
// e / row_words. A thread takes kUnroll words a round, a grid stride apart:
// it issues the kUnroll index loads at once, then the kUnroll row loads,
// then the kUnroll stores, so a round costs one index latency and one row
// latency for kUnroll words, and a warp's neighbouring lanes read
// neighbouring words (one index address serves the lanes of a row by
// broadcast). The grid gives each thread kUnroll words, at most the blocks
// the card holds resident, so every thread starts at once and the large
// gathers loop instead of queueing blocks. The divisions by the row size
// and by M are a 32-bit multiply-high and a shift, so a launch takes fewer
// than 2^31 words; a larger gather is cut into launches of whole groups (of
// rows of one group where a group alone is too large). 64-bit indices and a
// 64-bit multiply-high cost the gain at the probe and train shapes. The
// copy moves bits: the result is exact for every dtype. An index outside
// [0, N) yields a zero row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;     // words a thread has in flight in a round

constexpr long long kMaxWords = 0x7fffffffLL;   // words a launch takes

// n / d for n < 2^31 by one multiply-high and a shift (PyTorch's IntDivider).
struct FastDiv {
  uint32_t magic, shift, d;
  explicit FastDiv(uint32_t divisor) : shift(0), d(divisor) {
    while (shift < 32 && (1ULL << shift) < divisor) ++shift;
    magic = static_cast<uint32_t>(
        ((1ULL << 32) * ((1ULL << shift) - divisor)) / divisor + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

template <typename W>
__device__ __forceinline__ W load_nc(const W* p) { return __ldg(p); }
template <>
__device__ __forceinline__ uint8_t load_nc(const uint8_t* p) { return *p; }
template <>
__device__ __forceinline__ uint16_t load_nc(const uint16_t* p) { return *p; }

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const W* __restrict__ values, const int* __restrict__ idx,
                   W* __restrict__ out, uint32_t words, FastDiv row_words,
                   FastDiv m, uint32_t n_src) {
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t base = blockIdx.x * kThreads + threadIdx.x; base < words;
       base += stride * kUnroll) {
    uint32_t row[kUnroll];
    int src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t e = base + u * stride;
      row[u] = row_words.div(e < words ? e : 0);
      src[u] = e < words ? __ldg(idx + row[u]) : -1;
    }
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t word = base + u * stride - row[u] * row_words.d;
      v[u] = static_cast<uint32_t>(src[u]) < n_src
                 ? load_nc(values + (static_cast<size_t>(m.div(row[u])) * n_src +
                                     src[u]) * row_words.d + word)
                 : W{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t e = base + u * stride;
      if (e < words) out[e] = v[u];
    }
  }
}

// One launch over `rows` rows of `row_words` words (fewer than 2^31 words
// in all), groups of m rows each reading its own n_src source rows.
template <typename W>
cudaError_t launch(const W* values, const int* idx, W* out, long long rows,
                   long long n_src, long long m, long long row_words,
                   cudaStream_t stream) {
  // blocks the card holds resident at once, per device and word size
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_rows_kernel<W>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long words = rows * row_words;
  // kUnroll words a thread, or the resident blocks looping over more
  long long blocks = (words + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > resident[dev]) blocks = resident[dev];
  gather_rows_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      values, idx, out, static_cast<uint32_t>(words),
      FastDiv(static_cast<uint32_t>(row_words)),
      FastDiv(static_cast<uint32_t>(m)),
      static_cast<uint32_t>(n_src < kMaxWords ? n_src : kMaxWords));
  return cudaGetLastError();
}

// The whole gather in launches of fewer than 2^31 words: whole groups where
// a group fits one, else rows of one group.
template <typename W>
cudaError_t gather(const void* values, const int* idx, void* out, long long g,
                   long long n, long long m, long long row_bytes,
                   cudaStream_t stream) {
  const long long row_words = row_bytes / static_cast<long long>(sizeof(W));
  if (row_words > kMaxWords) return cudaErrorInvalidValue;
  const long long most = kMaxWords / row_words;   // rows a launch takes
  const W* v = static_cast<const W*>(values);
  W* o = static_cast<W*>(out);
  const long long groups = most / m;              // whole groups a launch takes
  cudaError_t err = cudaSuccess;
  for (long long g0 = 0; g0 < g && err == cudaSuccess;) {
    if (groups > 0) {
      const long long gs = g - g0 < groups ? g - g0 : groups;
      err = launch<W>(v + g0 * n * row_words, idx + g0 * m,
                      o + g0 * m * row_words, gs * m, n, m, row_words, stream);
      g0 += gs;
      continue;
    }
    for (long long r = 0; r < m && err == cudaSuccess; r += most) {
      const long long rs = m - r < most ? m - r : most;
      err = launch<W>(v + g0 * n * row_words, idx + g0 * m + r,
                      o + (g0 * m + r) * row_words, rs, n, rs, row_words,
                      stream);
    }
    ++g0;
  }
  return err;
}

}  // namespace

// values [G, N, row_bytes] bytes, idx [G, M] int32, out [G, M, row_bytes].
// Returns a cudaError_t (0 = launched).
extern "C" int ctts_gather_rows(const void* values, const int* idx, void* out,
                                long long g, long long n, long long m,
                                long long row_bytes, void* stream) {
  if (g < 0 || n <= 0 || m < 0 || row_bytes < 0) return cudaErrorInvalidValue;
  const long long rows = g * m;
  if (rows == 0 || row_bytes == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(values) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return gather<uint4>(values, idx, out, g, n, m, row_bytes, s);
  if (align % 8 == 0) return gather<uint2>(values, idx, out, g, n, m, row_bytes, s);
  if (align % 4 == 0) return gather<uint32_t>(values, idx, out, g, n, m, row_bytes, s);
  if (align % 2 == 0) return gather<uint16_t>(values, idx, out, g, n, m, row_bytes, s);
  return gather<uint8_t>(values, idx, out, g, n, m, row_bytes, s);
}
