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
// Design. An output row reads one source row and nothing else, so a warp
// owns a row at a time: blocks of 8 warps, as many as the card holds at
// once, each warp walking the rows gw, gw + (all warps), ... The source row
// (2T bytes) is staged in the warp's shared memory: by a 1-D TMA bulk copy
// (cp.async.bulk onto an mbarrier) where rows are 16-byte aligned and 16
// bytes long multiples (T % 8 == 0), the next row's copy in flight while
// the warp folds the current one; else by 16-byte loads of the row's whole
// 16-byte pieces and 2-byte loads of its ends. A row's shift is fixed, so
// each of its two source indices m = (c + base) mod WPAD, base = -shift and
// T + 1 - shift taken mod WPAD once per row, is c + base less WPAD past one
// wrap point: no division in the loop, a compare and a select. Each lane
// folds 8 consecutive outputs from shared memory and writes them as one
// 16-byte store; a row whose start is not 16-byte aligned (T % 8 != 0)
// takes 2-byte stores up to its first aligned output and after its last
// whole piece. lane_rev reads the staged row backwards.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
// arm the barrier for `bytes` of transactions and copy them there
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

struct Geo {
  int t, bq, wpad, variant;
};

// The source row of output row q and the two bases of its indices
__device__ __forceinline__ void row_of(const Geo& g, int q, int& src, int& b1, int& b2) {
  const int q0 = q - q % g.bq, r = q % g.bq;
  src = g.variant == 1 ? q0 + g.bq - 1 - r : q;
  int shift;
  switch (g.variant) {
    case 1: shift = g.t - g.bq - q0 + r; break;
    case 3: shift = (g.t - 1 - q0) - r; if (shift < 0) shift += g.wpad; break;
    default: shift = q0 + 1 + r;
  }
  // shift in [0, wpad): (c - shift) mod wpad = c + b1 less wpad past the wrap
  b1 = shift == 0 ? 0 : g.wpad - shift;
  b2 = g.t + 1 - shift;
  if (b2 < 0) b2 += g.wpad;
}

// out[c] from the staged row s: its two indices' values, in f32, rounded once
template <bool kRev>
__device__ __forceinline__ float fold(const bf16* s, int c, int b1, int b2,
                                      const Geo& g) {
  int m1 = c + b1, m2 = c + b2;
  if (m1 >= g.wpad) m1 -= g.wpad;
  if (m2 >= g.wpad) m2 -= g.wpad;
  float acc = 0.f;
  if (m1 < g.t) acc += __bfloat162float(s[kRev ? g.t - 1 - m1 : m1]);
  if (m2 < g.t) acc += __bfloat162float(s[kRev ? g.t - 1 - m2 : m2]);
  return acc;
}

// the row's t outputs from the staged row s (its element 0 at s[0]); out
// row starts at element e0 of a 16-byte aligned tensor (vec), lane by lane
template <bool kRev>
__device__ __forceinline__ void fold_row(const bf16* s, bf16* out, size_t e0,
                                         bool vec, int b1, int b2, const Geo& g,
                                         int lane) {
  int head = vec ? static_cast<int>((8 - (e0 & 7)) & 7) : g.t;
  if (head > g.t) head = g.t;
  for (int c = lane; c < head; c += 32)
    out[c] = __float2bfloat16(fold<kRev>(s, c, b1, b2, g));
  const int pieces = (g.t - head) / 8;
  for (int p = lane; p < pieces; p += 32) {
    const int c = head + 8 * p;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(fold<kRev>(s, c + e, b1, b2, g));
    *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<const uint4*>(v);
  }
  for (int c = head + 8 * pieces + lane; c < g.t; c += 32)
    out[c] = __float2bfloat16(fold<kRev>(s, c, b1, b2, g));
}

// Elements of a warp's row buffer: the row and up to 7 before it (the row's
// offset in its first 16-byte piece), in whole pieces
__host__ __device__ constexpr int row_elems(int t) { return (t + 7 + 7) / 8 * 8; }
__host__ __device__ constexpr int warp_bytes(int t) { return 2 * row_elems(t) * 2; }

__global__ void __launch_bounds__(kWarps * 32)
flip_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int n, Geo g,
            bool tma, bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kWarps][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  bf16* buf = reinterpret_cast<bf16*>(smem + warp * warp_bytes(g.t));
  const int stride = row_elems(g.t);
  const long long rows = static_cast<long long>(n) * g.t;
  const long long step = static_cast<long long>(gridDim.x) * warps;
  long long row = static_cast<long long>(blockIdx.x) * warps + warp;
  const size_t tt = static_cast<size_t>(g.t) * g.t;

  // the source row of output row `r`, at element 0 of the returned pointer
  auto source = [&](long long r, int& b1, int& b2) {
    int src;
    row_of(g, static_cast<int>(r % g.t), src, b1, b2);
    return static_cast<size_t>(r / g.t) * tt + static_cast<size_t>(src) * g.t;
  };

  if (tma) {
    if (lane == 0) {
      mbar_init(&bars[warp][0]);
      mbar_init(&bars[warp][1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0 && row < rows) {
      int b1, b2;
      bulk_copy(buf, x + source(row, b1, b2), 2 * g.t, &bars[warp][0]);
    }
  }
  for (int i = 0; row < rows; row += step, ++i) {
    const int b = i & 1;
    bf16* s = buf + b * stride;
    int b1, b2;
    const size_t s0 = source(row, b1, b2);
    if (tma) {
      const long long next = row + step;
      if (lane == 0 && next < rows) {
        int n1, n2;
        // the other buffer was last read by the generic proxy (the row
        // before): order those reads before the bulk copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_copy(buf + (b ^ 1) * stride, x + source(next, n1, n2), 2 * g.t,
                  &bars[warp][b ^ 1]);
      }
      mbar_wait(&bars[warp][b], (i >> 1) & 1);
    } else {
      // the row's whole 16-byte pieces by 16-byte loads, its ends by 2-byte
      // ones, into d at the row's offset in its first piece
      const int off = vec_in ? static_cast<int>(s0 & 7) : 0;
      const bf16* src = x + s0 - off;
      const int end = off + g.t;
      const int first = vec_in ? (off == 0 ? 0 : 8) : end;   // first whole piece
      const int last = vec_in ? end / 8 * 8 : end;          // and past the last
      bf16* d = s;                                          // 16-byte aligned
      for (int e = off + lane; e < min(first, end); e += 32) d[e] = src[e];
      for (int p = first / 8 + lane; p < last / 8; p += 32)
        reinterpret_cast<uint4*>(d)[p] = reinterpret_cast<const uint4*>(src)[p];
      for (int e = max(last, first) + lane; e < end; e += 32) d[e] = src[e];
      s = d + off;
      __syncwarp();
    }
    bf16* o = out + static_cast<size_t>(row) * g.t;
    const size_t e0 = static_cast<size_t>(row) * g.t;
    if (g.variant == 2) fold_row<true>(s, o, e0, vec_out, b1, b2, g, lane);
    else fold_row<false>(s, o, e0, vec_out, b1, b2, g, lane);
    __syncwarp();                       // the buffer read before it is refilled
  }
}

}  // namespace

// x, out [n, t, t] bfloat16; bq divides t; wpad >= 2t+1. Returns a
// cudaError_t (0 = launched).
extern "C" int ctts_bench_flip(const void* x, void* out, int n, int t, int bq,
                               int wpad, int variant, void* stream) {
  if (n == 0 || t == 0) return cudaSuccess;
  if (n < 0 || t < 0 || bq <= 0 || t % bq != 0 ||
      wpad < 2 * t + 1 || variant < 0 || variant > 3)
    return cudaErrorInvalidValue;
  const bool vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool tma = vec_in && t % 8 == 0;
  const int per_warp = warp_bytes(t);
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > kMaxSmem - 1024) warps /= 2;
  const int smem = warps * per_warp;
  if (smem > kMaxSmem - 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flip_kernel,
                                                          warps * 32, smem)) != cudaSuccess)
    return e;
  const long long rows = static_cast<long long>(n) * t;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (rows + warps - 1) / warps;
  if (blocks > need) blocks = need;
  flip_kernel<<<static_cast<int>(blocks), warps * 32, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), n,
      Geo{t, bq, wpad, variant}, tma, vec_in, vec_out);
  return cudaGetLastError();
}
