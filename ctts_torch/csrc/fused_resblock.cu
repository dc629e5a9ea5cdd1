// HiFi-GAN ResBlock1 chain, fused, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ctts_tpu/ops/fused_resblock.py:59
// (_resblock_kernel, launched by fused_resblock1 at :99-141). Same function:
// for each dilation d of the block (1, 3, 5 in HiFi-GAN V1),
//   x = x + conv_k1(lrelu(conv_kd(lrelu(x))))
// with every conv zero-padded at the sequence edges, on one time tile plus
// the halo of the whole chain, sum_d (d*p + p) samples a side (p = (k-1)/2:
// 12, 36, 60 for k = 3, 7, 11). One read of x and one write of the output
// reach device memory; the intermediates stay in shared memory. The
// generator is never trained, so there is no backward, as in the JAX package.
//
// Layout: x and out are [N, C, T] (the port's channels-first layout, so no
// transpose around the call); the weights come as w[n_dil, k, C_in, C_out]
// float32 holding values of the compute dtype, the biases as b[n_dil, C]
// float32.
//
// Rounding, that of the plain version (reference_resblock1 in
// ctts_torch/ops/fused_resblock.py, which follows the JAX reference at
// ctts_tpu/ops/fused_resblock.py:144-160): the compute dtype T is that of x
// (bf16 or f32). Each leaky ReLU (slope 0.1) is taken in f32 and rounded to
// T; each conv sums its products in f32, adds the f32 bias and rounds to T;
// the residual x + y2 adds two T values in f32 and rounds once to T. (The
// Pallas kernel adds the un-rounded f32 conv output to x and rounds once; the
// port follows its plain version, so the two paths differ only in the order
// of the f32 sums.) Intermediates outside [0, T) are zeroed after every
// activation, as the reference's zero padding of every conv demands.
//
// What bounds it on the H100: 12*k*C^2 flop per sample and batch row
// against 4*C bytes (bf16 x in, out) per sample: at C=128, k=11 that is
// ~5000 flop per byte, far above the card's ~295 flop/byte ridge, so the
// bound is the tensor cores' 989 TFLOP/s (about 0.65 ms for k=11 at the
// probe's level 1, [4, 128, 73728]).
//
// Design of this first version (made fast in a later change): the TPU
// kernel keeps all six weight tensors resident in VMEM (k=11, C=128: 2.2 MB
// in bf16), ten times a Hopper SM's shared memory. Here only the activation
// tile lives in shared memory, two buffers of C x (block_t + 2*halo) values
// of T: X (the running x, updated in place by each residual) and Y (the
// first conv's activated output). The weights stream from L2, where every
// block shares them, as warp-uniform float4 loads. One block of 512 threads
// per (time tile, batch row); each warp computes register tiles of 16
// output channels x 4 time steps (32 apart, so a warp's shared-memory reads
// are consecutive) and walks the input channels and taps, f32 FMAs on the
// CUDA cores. The buffers shrink by d*p and then by p as each pair of convs
// consumes its halo; the residual's x lies at the same absolute positions as
// the second conv's output, so it is updated in place. The channel padding
// to 128 lanes of the TPU kernel is not carried over: any C that is a
// multiple of 16 is taken. A tensor-core (mma) version is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRc = 16;        // output channels per thread
constexpr int kRt = 4;         // time steps per thread, 32 apart
constexpr int kMaxDil = 4;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kSlope = 0.1f;

struct Dilations {
  int n;
  int d[kMaxDil];
};

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

// round to the compute dtype, as an f32 value
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T> __device__ __forceinline__ float lrelu(float x) {
  return x > 0.f ? x : rnd<T>(x * kSlope);
}

// One conv of the chain over the block's tile. Output v in [0, lout) reads
// the input row at v + j*dil for the taps j in [0, K); in and dst are
// shared-memory buffers of rows of `stride` values, dst_base the absolute
// sequence index of dst's element 0.
//   FIRST: in = X, the leaky ReLU taken on each value read; dst = Y gets
//          lrelu(round(conv + b)), zero outside [0, t_len).
//   else:  in = Y; dst points into X: x = round(x + round(conv + b)), zero
//          outside [0, t_len).
template <typename T, int K, bool FIRST>
__device__ __forceinline__ void conv_pass(
    const T* in, T* dst, int stride, int lout, int dil,
    const float* __restrict__ w, const float* __restrict__ b, int c_ch,
    int dst_base, int t_len) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ncg = c_ch / kRc;
  const int ntg = (lout + 32 * kRt - 1) / (32 * kRt);
  for (int item = warp; item < ncg * ntg; item += kWarps) {
    const int co0 = (item % ncg) * kRc;
    const int t0 = (item / ncg) * 32 * kRt + lane;
    int tr[kRt];
#pragma unroll
    for (int r = 0; r < kRt; ++r) tr[r] = min(t0 + 32 * r, lout - 1);
    float acc[kRc][kRt];
#pragma unroll
    for (int c = 0; c < kRc; ++c)
#pragma unroll
      for (int r = 0; r < kRt; ++r) acc[c][r] = 0.f;
    for (int ci = 0; ci < c_ch; ++ci) {
      const T* row = in + ci * stride;
      const float* wci = w + static_cast<size_t>(ci) * c_ch + co0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float a[kRt];
#pragma unroll
        for (int r = 0; r < kRt; ++r) {
          const float v = to_f32(row[tr[r] + j * dil]);
          a[r] = FIRST ? lrelu<T>(v) : v;
        }
        const float4* wp = reinterpret_cast<const float4*>(
            wci + static_cast<size_t>(j) * c_ch * c_ch);
#pragma unroll
        for (int q = 0; q < kRc / 4; ++q) {
          const float4 wq = __ldg(wp + q);
#pragma unroll
          for (int r = 0; r < kRt; ++r) {
            acc[4 * q + 0][r] = fmaf(wq.x, a[r], acc[4 * q + 0][r]);
            acc[4 * q + 1][r] = fmaf(wq.y, a[r], acc[4 * q + 1][r]);
            acc[4 * q + 2][r] = fmaf(wq.z, a[r], acc[4 * q + 2][r]);
            acc[4 * q + 3][r] = fmaf(wq.w, a[r], acc[4 * q + 3][r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      const int v = t0 + 32 * r;
      if (v >= lout) continue;
      const int pos = dst_base + v;
      const bool inside = pos >= 0 && pos < t_len;
#pragma unroll
      for (int c = 0; c < kRc; ++c) {
        T* out = dst + (co0 + c) * stride + v;
        const float y = rnd<T>(acc[c][r] + __ldg(b + co0 + c));
        float val;
        if (FIRST)
          val = lrelu<T>(y);
        else
          val = rnd<T>(to_f32(*out) + y);
        *out = from_f32<T>(inside ? val : 0.f);
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
resblock1_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 int c_ch, int t_len, int bt, int halo, Dilations dil) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int p = (K - 1) / 2;
  const int l0 = bt + 2 * halo;
  T* xs = reinterpret_cast<T*>(smem);
  T* ys = xs + c_ch * l0;
  const int tile0 = blockIdx.x * bt;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * c_ch * t_len;

  // the haloed tile of x, zero outside [0, t_len)
  for (int e = threadIdx.x; e < c_ch * l0; e += kThreads) {
    const int c = e / l0, a = tile0 - halo + e % l0;
    xs[e] = (a >= 0 && a < t_len) ? x[row0 + static_cast<size_t>(c) * t_len + a]
                                  : from_f32<T>(0.f);
  }
  __syncthreads();

  int xoff = 0, len = l0, base = tile0 - halo;   // live part of X
  for (int di = 0; di < dil.n; ++di) {
    const int d = dil.d[di], h1 = d * p;
    const int l1 = len - 2 * h1;                  // conv_kd output
    conv_pass<T, K, true>(xs + xoff, ys, l0, l1, d,
                          w1 + static_cast<size_t>(di) * K * c_ch * c_ch,
                          b1 + di * c_ch, c_ch, base + h1, t_len);
    __syncthreads();
    const int l2 = l1 - 2 * p;                    // conv_k1 output
    conv_pass<T, K, false>(ys, xs + xoff + h1 + p, l0, l2, 1,
                           w2 + static_cast<size_t>(di) * K * c_ch * c_ch,
                           b2 + di * c_ch, c_ch, base + h1 + p, t_len);
    __syncthreads();
    xoff += h1 + p;
    base += h1 + p;
    len = l2;
  }

  // len == bt and base == tile0 here
  for (int e = threadIdx.x; e < c_ch * bt; e += kThreads) {
    const int c = e / bt, v = e % bt;
    if (tile0 + v < t_len)
      out[row0 + static_cast<size_t>(c) * t_len + tile0 + v] = xs[c * l0 + xoff + v];
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, void* out, const float* w1, const float* b1,
                   const float* w2, const float* b2, int n, int c, int t,
                   int bt, int halo, const Dilations& dil, cudaStream_t stream) {
  const size_t smem = 2ull * c * (bt + 2 * halo) * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = resblock1_kernel<T, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t + bt - 1) / bt, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), w1, b1, w2, b2, c, t,
      bt, halo, dil);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int k, const void* x, void* out, const float* w1,
                     const float* b1, const float* w2, const float* b2, int n,
                     int c, int t, int bt, int halo, const Dilations& dil,
                     cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3>(x, out, w1, b1, w2, b2, n, c, t, bt, halo, dil, s);
    case 7: return launch<T, 7>(x, out, w1, b1, w2, b2, n, c, t, bt, halo, dil, s);
    case 11: return launch<T, 11>(x, out, w1, b1, w2, b2, n, c, t, bt, halo, dil, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out [n, c, t] of dtype (0 float32, 1 bfloat16); w1, w2 [n_dil, k, c, c]
// and b1, b2 [n_dil, c] float32; dilations: n_dil host ints; bt: the output
// samples per block. Returns a cudaError_t (0 = launched).
extern "C" int ctts_fused_resblock1(const void* x, void* out, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, int n, int c, int t,
                                    int k, const int* dilations, int n_dil,
                                    int bt, int dtype, void* stream) {
  if (n <= 0 || t <= 0) return cudaSuccess;
  if (c <= 0 || c % kRc != 0 || n_dil <= 0 || n_dil > kMaxDil || bt <= 0 ||
      n > 65535 || k % 2 == 0)
    return cudaErrorInvalidValue;
  Dilations dil;
  dil.n = n_dil;
  int halo = 0;
  const int p = (k - 1) / 2;
  for (int i = 0; i < n_dil; ++i) {
    if (dilations[i] <= 0) return cudaErrorInvalidValue;
    dil.d[i] = dilations[i];
    halo += dilations[i] * p + p;
  }
  for (int i = n_dil; i < kMaxDil; ++i) dil.d[i] = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(k, x, out, w1, b1, w2, b2, n, c, t, bt, halo, dil, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(k, x, out, w1, b1, w2, b2, n, c, t, bt, halo, dil, s);
  return cudaErrorInvalidValue;
}
