// Padding-masked softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ctts_tpu/ops/attention.py:41 (_attn_kernel,
// launched by _fused at :60-78 under fused_attention :97). Same contract:
// q, k, v, o are [N, T, D] (N = batch * heads), lengths [N] int32; the
// logits q*scale . k at key index >= lengths[n] are replaced by -1e9 (not
// -inf), the softmax runs in f32, and the result is written in the input
// dtype (bf16 or f32). A row with lengths[n] == 0 therefore averages V
// uniformly over all T keys, exactly as _reference_attention does.
//
// What bounds it on the H100: at the served shapes (T <= ~1.2k, D = 128,
// N = 8) the work is 4*N*T*T_kv*D flop over 4*N*T*D elements of I/O, about
// T/2 flop per byte in bf16 -- above the card's ~295 flop/byte ridge once T
// passes ~600, so a tensor-core kernel would be compute bound and a CUDA-
// core kernel is bound by its own f32 issue rate.
//
// Design: flash-style. One block per (query tile of BQ rows, n); the key
// axis is walked in tiles of 32 with an online softmax, so the [T, T]
// matrix never reaches device memory (the TPU kernel held K/V whole in
// VMEM; a block here has at most 227 KB of shared memory, so it streams
// them). Each warp owns RPW query rows. In the score phase each lane owns
// one key of the tile (K is stored transposed with a padded stride, so the
// lane's reads are conflict-free and the query values are shared-memory
// broadcasts); in the P.V phase each lane owns D/32 output columns and the
// probabilities are passed by warp shuffles. Arithmetic is f32 on the CUDA
// cores. Keys at or beyond lengths[n] (for lengths[n] > 0) add exactly 0
// after the -1e9 fill, so the key loop stops at lengths[n]; a zero-length
// row walks all T keys with every logit at -1e9. Any T is taken: the
// ragged last tiles are masked here. A tensor-core (wgmma) version is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // warps per block
constexpr int kRpw = 4;       // query rows per warp
constexpr int kBq = kWarps * kRpw;
constexpr int kBk = 32;       // keys per tile: one per lane
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const int* __restrict__ lengths,
         T* __restrict__ o, int seq, float scale) {
  constexpr int kCols = D / 32;                 // output columns per lane
  // dynamic: at D = 256 the tiles take 81 KB, past the 48 KB of static
  // shared memory
  extern __shared__ __align__(16) float smem[];
  float (*sQ)[D] = reinterpret_cast<float (*)[D]>(smem);                 // [kBq][D] scaled queries
  float (*sKt)[kBk + 1] = reinterpret_cast<float (*)[kBk + 1]>(smem + kBq * D);  // [D][kBk+1] keys, transposed
  float (*sV)[D] = reinterpret_cast<float (*)[D]>(smem + kBq * D + D * (kBk + 1));  // [kBk][D]

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(n) * seq * D;
  const int len = lengths[n];
  const int kv_end = len > 0 ? min(len, seq) : seq;

  for (int i = threadIdx.x; i < kBq * D; i += blockDim.x) {
    const int r = i / D, c = i % D, t = q0 + r;
    sQ[r][c] = t < seq ? to_f32(q[base + static_cast<size_t>(t) * D + c]) * scale
                       : 0.f;
  }

  float m[kRpw], l[kRpw], acc[kRpw][kCols];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBk) {
    __syncthreads();                 // previous tile fully consumed
    for (int i = threadIdx.x; i < kBk * D; i += blockDim.x) {
      const int r = i / D, c = i % D, j = k0 + r;
      const bool ok = j < seq;
      const size_t off = base + static_cast<size_t>(j) * D + c;
      sKt[c][r] = ok ? to_f32(k[off]) : 0.f;
      sV[r][c] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; c += 4) {
      const float k0v = sKt[c][lane], k1v = sKt[c + 1][lane];
      const float k2v = sKt[c + 2][lane], k3v = sKt[c + 3][lane];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&sQ[warp * kRpw + r][c]);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    const int j = k0 + lane;
    float p[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      // j >= kv_end: outside this row's keys (ragged edge, or past a
      // nonzero length, where the -1e9 fill would add exactly 0)
      const float sr = j >= kv_end ? -INFINITY : (j >= len ? kNeg : s[r]);
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);   // 0 on the first tile
      p[r] = expf(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }

#pragma unroll 4
    for (int jj = 0; jj < kBk; ++jj) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = sV[jj][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int t = q0 + warp * kRpw + r;
    if (t >= seq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[base + static_cast<size_t>(t) * D + lane + 32 * c] = from_f32<T>(acc[r][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int n, int seq, float scale,
                   cudaStream_t stream) {
  constexpr int smem = (kBq * D + D * (kBk + 1) + kBk * D) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {  // past the default limit (D = 256): opt in
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((seq + kBq - 1) / kBq, n);
  attn_fwd<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), seq, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d = 64, 128 or 256. Returns a cudaError_t (0 = launched),
// or cudaErrorInvalidValue for a shape or dtype this kernel does not take.
extern "C" int ctts_fused_attention(const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* o, int n, int seq, int d,
                                    float scale, int dtype, void* stream) {
  if (n <= 0 || seq <= 0 || n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 0 && d == 256) return launch<float, 256>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 256) return launch<__nv_bfloat16, 256>(q, k, v, lengths, o, n, seq, scale, s);
  return cudaErrorInvalidValue;
}

// The error text of a code returned by any entry of the kernel library
// (every csrc/*.cu links into one library; this is its one copy).
extern "C" const char* ctts_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
