// HiFi-GAN ResBlock1 chain, fused, forward only, on Hopper's tensor cores
// (sm_90a).
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
// transpose around the call). The weights come packed by the wrapper
// (ctts_torch/ops/fused_resblock.py:pack_weights) as bf16
// [n_dil, 2, k, C/kc, planes, C_out, kc]: conv (2*di for conv_kd, 2*di+1
// for conv_k1), tap, a chunk of kc input channels, then the rows of output
// channels with their kc inputs contiguous. planes is 1 for bf16 (the
// weights are bf16 values) and 2 for float32 (hi = bf16(w), lo =
// bf16(w - hi)). One (conv, tap, chunk) is one weight stage, contiguous. The
// biases come as float32 [n_dil, 2, C].
//
// Rounding, that of the plain version (reference_resblock1 in
// ctts_torch/ops/fused_resblock.py, which follows the JAX reference at
// ctts_tpu/ops/fused_resblock.py:144-160): the compute dtype T is that of x
// (bf16 or f32). Each leaky ReLU (slope 0.1) is taken in f32 and rounded to
// T; each conv sums its products in f32, adds the f32 bias and rounds to T;
// the residual x + y2 adds two T values in f32 and rounds once to T.
// Intermediates outside [0, T) are zeroed after every activation, as the
// reference's zero padding of every conv demands.
//
// What bounds it on the H100: 12*k*C^2 flop per sample and batch row
// against 4*C bytes (bf16 x in, out) per sample: at C=128, k=11 that is
// ~5000 flop per byte, far above the card's ~295 flop/byte ridge, so the
// bound is the tensor cores' 989 TFLOP/s (about 0.65 ms for k=11 at the
// probe's level 1, [4, 128, 73728]).
//
// Design. Each conv is an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32
// accumulate): out[t][co] = sum_j sum_ci act[t + j*d][ci] * W_j[co][ci],
// with M = time, N = output channels, K = taps x input channels. The
// activations live in shared memory time-major, [t][ci] with ci contiguous,
// so the A fragment of tap j is an ldmatrix of rows t + j*d, 16-byte
// aligned at any shift; the row stride is padded by 16 bytes (bf16; 32 for
// f32) so that the 8 rows of an ldmatrix, or the 4 rows a quarter-warp of
// 8-byte loads reads, fall in distinct banks. Two buffers, as before: X (the
// running x, its tile loaded once, transposed from [C, T]) and Y. Before
// each first conv Y takes lrelu(X) over X's live rows, once, not once per
// tap and output-channel group, so X stays un-activated for the residual;
// the first conv reads Y and, after a barrier, writes its activated output
// over Y in place (a round writes only rows below those a later round
// reads). The second conv reads Y and its epilogue updates X in place,
// round(x + round(acc + b)). The buffers shrink by d*p and then p rows a
// side as each conv consumes its halo.
//
// A warp owns a tile of up to kMt m-tiles (16 time rows each) x NT n-tiles
// (8 output channels each; NT = 8 where C is a multiple of 64, else 4 or
// 2, one kernel instance each), so each A fragment feeds NT mma's and each
// pair of B fragments 2*kMt. Twelve warps: the output channels in groups of
// 8*NT, the rest of the warps in row groups; a conv's m-tiles are dealt to
// the row groups in contiguous runs, and a conv with more m-tiles than the
// warps hold takes more rounds. A round's m-tile count is dispatched to a
// loop compiled for it, so the inner loops carry no guards: each k-step
// loads the warp's A fragments first and then streams the B fragments a
// pair of n-tiles at a time. The weights (2.2 MB at k=11, C=128 in bf16) do
// not fit a block's 227 KB: they stream through a ring of kStages
// shared-memory stages of kc input channels x C outputs with cp.async, one
// barrier a stage; the stream runs ahead across conv, tap and round boundaries.
// float32 runs on the tensor cores too: each operand splits into bf16 hi +
// lo and each product is three mma's (lo.hi + hi.lo + hi.hi; the lo.lo term
// is below 2^-16 of the product). The wrapper picks the tile length from
// the card's shared memory and a model of the rounds (block_t_for).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "window_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;      // weight stages in flight (a ring)
constexpr int kMaxDil = 4;
constexpr int kSlack = 15;       // rows past a buffer's last live row that the
                                 // taps of a conv's last m-tile read
constexpr int kMaxSmem = 232448; // dynamic shared memory a block may take
constexpr float kSlope = 0.1f;

// per compute dtype: m-tiles of a warp tile, weight planes, row padding
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int kMt = 4, kPlanes = 1, kPad = 16;
};
template <> struct Cfg<float> {
  static constexpr int kMt = 2, kPlanes = 2, kPad = 32;
};

// input channels of a weight stage: in bf16 64 where C allows (one barrier
// per 64 inputs of a tap), else 32 or 16; float32's two planes take 32
template <typename T> constexpr int ci_chunk(int c) {
  return Cfg<T>::kPlanes == 1 && c % 64 == 0 ? 64 : c % 32 == 0 ? 32 : 16;
}

struct Geo {
  int c, t_len, bt, halo;
  int kc, nck;            // input channels of a stage; stages of a tap
  int xs;                 // activation row stride, bytes
  int ws;                 // weight row stride, bytes
  int x_rows, y_rows;     // rows of X and Y
  int cg, rg;             // output-channel groups of 8*NT; row groups
  int stage_elems;        // bf16 values of a stage in device memory
  int stage_bytes;        // bytes of a stage in shared memory
};

struct Plan {
  int n_dil;
  int d[kMaxDil];
  int lout[2 * kMaxDil];    // output rows of each conv of the chain
  int rounds[2 * kMaxDil];  // rounds of the warps over each conv's m-tiles
};

// ---- PTX wrappers -------------------------------------------------------- //

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
using ctts_window::cp_async_commit;
// every group but the newest kStages - 2 has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  ctts_window::cp_async_wait_group<kStages - 2>();
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- values ------------------------------------------------------------- //

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 pair(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// round to the compute dtype, as an f32 value
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}
// the leaky ReLU, rounded to T: for x > 0, x >= round(0.1 x); else
// round(0.1 x) >= x, so the larger of the two is x > 0 ? x : round(0.1 x)
template <typename T> __device__ __forceinline__ float lrelu(float x) {
  return fmaxf(x, rnd<T>(x * kSlope));
}
// the same on a bf16 pair: one conversion and one max
__device__ __forceinline__ uint32_t lrelu2(uint32_t u) {
  const float2 f = __bfloat1622float2(pair(u));
  return bits(__hmax2(pair(u), __floats2bfloat162_rn(f.x * kSlope, f.y * kSlope)));
}
// ... and on the 16 bytes of a row chunk
template <typename T> __device__ __forceinline__ void lrelu16(uint4& v);
template <> __device__ __forceinline__ void lrelu16<float>(uint4& v) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = lrelu<float>(f[i]);
}
template <> __device__ __forceinline__ void lrelu16<bf16>(uint4& v) {
  v.x = lrelu2(v.x);
  v.y = lrelu2(v.y);
  v.z = lrelu2(v.z);
  v.w = lrelu2(v.w);
}

// (x, y) as a bf16 pair: hi, and for float32 lo = the remainder
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  const float2 f = __bfloat1622float2(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// two consecutive values of a row of T, as f32, and back
__device__ __forceinline__ float2 get2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 get2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---- the weight stream --------------------------------------------------- //

// The sequence of weight stages the block consumes: for each conv of the
// chain, for each of its rounds, every (tap, input chunk). issue() starts
// the copy of the next stage into its buffer (stage s into buffer s %
// kStages) as one cp.async group, empty past the end of the chain.
template <int K>
struct Stream {
  const bf16* w;
  int conv, round, tc, s;

  __device__ __forceinline__ void issue(const Geo& g, const Plan& plan,
                                        unsigned char* wbuf) {
    if (conv >= 2 * plan.n_dil) {                  // the chain is done
      cp_async_commit();
      return;
    }
    const bf16* src = w + (static_cast<size_t>(conv) * K * g.nck + tc) *
                              g.stage_elems;
    unsigned char* dst = wbuf + (s % kStages) * g.stage_bytes;
    const int per_row = g.kc / 8;                  // 16-byte chunks a row
    for (int i = threadIdx.x; i < g.stage_elems / 8; i += kThreads)
      cp_async16(dst + (i / per_row) * g.ws + (i % per_row) * 16, src + i * 8);
    cp_async_commit();
    ++s;
    if (++tc == K * g.nck) {
      tc = 0;
      if (++round == plan.rounds[conv]) {
        round = 0;
        ++conv;
      }
    }
  }
};

// ---- one conv of the chain ---------------------------------------------- //

// The stages of one round of a conv for a warp that owns M m-tiles from m0
// (M known at compile time, so the loop carries no guards) and the NT
// n-tiles from co0: every stage waits for its weights at the block's
// barrier and starts the next copy; then, per 16 inputs of the stage, the
// warp loads its M A fragments (rows shifted by the tap) and walks the
// n-tiles two at a time, each pair of B fragments feeding 2*M mma's.
template <typename T, int K, int NT, int M>
__device__ __forceinline__ void conv_round(
    const Geo& g, const Plan& plan, float (&acc)[Cfg<T>::kMt][NT][4], int m0,
    const unsigned char* in, int dil, int co0, Stream<K>& st,
    unsigned char* wbuf, int& s) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kE = sizeof(T);
  const int lane = threadIdx.x % 32;
  // this lane's row and column of an ldmatrix, as byte offsets
  const int a_lane = (lane & 15) * g.xs + (lane >> 4) * 8 * kE;
  const int b_lane = ((lane & 7) + (lane >> 4) * 8) * g.ws + ((lane >> 3) & 1) * 16;
  const int gr = lane >> 2, q2 = (lane & 3) * 2;   // an mma fragment's row, cols
  const uint32_t in_s = smem_addr(in) + m0 * 16 * g.xs;
  for (int tc = 0; tc < K * g.nck; ++tc, ++s) {
    cp_async_wait_ring();
    __syncthreads();                   // stage s is in; stage s-1 is free
    st.issue(g, plan, wbuf);           // stage s+kStages-1 into s-1's buffer
    if constexpr (M > 0) {
      const uint32_t wst = smem_addr(wbuf + (s % kStages) * g.stage_bytes) +
                           co0 * g.ws + b_lane;
      const int j = tc / g.nck, c0 = (tc % g.nck) * g.kc;
      const uint32_t rows = in_s + (j * dil) * g.xs + c0 * kE;
      // not unrolled: unrolled, the compiler hoists the next k-step's
      // loads and spills accumulators at the 168-register cap
#pragma unroll 1
      for (int kk = 0; kk < g.kc; kk += 16) {
        uint32_t ah[M][4], al[M][4];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if constexpr (!kSplit) {
            ldsm(ah[m], rows + m * 16 * g.xs + kk * kE + a_lane);
          } else {
            // a0: (row gr, cols q2, q2+1), a1: row gr+8, a2: cols +8, a3: both
            const unsigned char* base =
                in + (m0 + m) * 16 * g.xs + (j * dil + gr) * g.xs;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = get2(reinterpret_cast<const T*>(
                  base + (e & 1) * 8 * g.xs) + c0 + kk + q2 + (e >> 1) * 8);
              split2(f.x, f.y, ah[m][e], al[m][e]);
            }
          }
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bh[4], bl[4];
          const uint32_t bp = wst + np * 16 * g.ws + kk * 2;
          ldsm(bh, bp);
          if (kSplit) ldsm(bl, bp + g.c * g.ws);
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float (&c)[4] = acc[m][2 * np + h];
              if (kSplit) {
                mma16816(c, al[m], bh[2 * h], bh[2 * h + 1]);
                mma16816(c, ah[m], bl[2 * h], bl[2 * h + 1]);
              }
              mma16816(c, ah[m], bh[2 * h], bh[2 * h + 1]);
            }
        }
      }
    }
  }

}

// conv_round for the warp's m-tile count, cnt in [0, M]
template <typename T, int K, int NT, int M>
__device__ __forceinline__ void conv_rounds(
    int cnt, const Geo& g, const Plan& plan, float (&acc)[Cfg<T>::kMt][NT][4],
    int m0, const unsigned char* in, int dil, int co0, Stream<K>& st,
    unsigned char* wbuf, int& s) {
  if constexpr (M == 0) {
    conv_round<T, K, NT, 0>(g, plan, acc, m0, in, dil, co0, st, wbuf, s);
  } else {
    if (cnt == M)
      conv_round<T, K, NT, M>(g, plan, acc, m0, in, dil, co0, st, wbuf, s);
    else
      conv_rounds<T, K, NT, M - 1>(cnt, g, plan, acc, m0, in, dil, co0, st,
                                   wbuf, s);
  }
}

// One conv of the chain. in: the input buffer from the row that output row
// 0's first tap reads; dst: the row of output row 0 (for the first conv Y,
// which holds its input lrelu(x) and takes its output in place; X, in
// place, for the second, whose residual is read at the same place);
// dst_base: the absolute sequence index of output row 0.
template <typename T, int K, int NT, bool FIRST>
__device__ __forceinline__ void conv(const Geo& g, const Plan& plan, int ci,
                                     const unsigned char* in, unsigned char* dst,
                                     int dil, const float* __restrict__ bias,
                                     int dst_base, Stream<K>& st,
                                     unsigned char* wbuf, int& s) {
  constexpr int kMt = Cfg<T>::kMt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cgi = warp % g.cg, rgi = warp / g.cg;
  const int co0 = cgi * NT * 8;
  const int lout = plan.lout[ci];
  const int mtiles = (lout + 15) / 16;
  const int cap = g.rg * kMt;                        // m-tiles a round holds
  const float* b = bias + ci * g.c;

  for (int r = 0; r < plan.rounds[ci]; ++r) {
    const int first = r * cap, n_r = min(mtiles - first, cap);
    const int mt = (n_r + g.rg - 1) / g.rg;           // m-tiles a row group
    const int m0 = first + rgi * mt;
    const int cnt = rgi < g.rg ? max(0, min(mt, first + n_r - m0)) : 0;

    float acc[kMt][NT][4];
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    conv_rounds<T, K, NT, kMt>(cnt, g, plan, acc, m0, in, dil, co0, st, wbuf,
                               s);
    // the first conv writes over its own input: every read of the round
    // first (a later round reads only rows past this round's outputs)
    if (FIRST) __syncthreads();

    // epilogue: c0, c1 at (row g, cols 2q, 2q+1); c2, c3 at row g+8
#pragma unroll
    for (int m = 0; m < kMt; ++m) {
      if (m >= cnt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int v = (m0 + m) * 16 + (lane >> 2) + 8 * half;
        if (v >= lout) continue;
        const int pos = dst_base + v;
        const bool inside = pos >= 0 && pos < g.t_len;
        T* row = reinterpret_cast<T*>(dst + v * g.xs);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int co = co0 + 8 * n + (lane & 3) * 2;
          const float y0 = rnd<T>(acc[m][n][2 * half] + __ldg(b + co));
          const float y1 = rnd<T>(acc[m][n][2 * half + 1] + __ldg(b + co + 1));
          float v0, v1;
          if (FIRST) {
            v0 = lrelu<T>(y0);
            v1 = lrelu<T>(y1);
          } else {
            const float2 x = get2(row + co);
            v0 = rnd<T>(x.x + y0);
            v1 = rnd<T>(x.y + y1);
          }
          put2(row + co, inside ? v0 : 0.f, inside ? v1 : 0.f);
        }
      }
    }
  }
}

template <typename T, int K, int NT>
__global__ void __launch_bounds__(kThreads, 1)
resblock1_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const bf16* __restrict__ w, const float* __restrict__ bias,
                 Geo g, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int p = (K - 1) / 2;
  constexpr int kV = 16 / sizeof(T);          // values of a 16-byte chunk
  unsigned char* xs = smem;
  unsigned char* ys = xs + g.x_rows * g.xs;
  unsigned char* wbuf = ys + g.y_rows * g.xs;
  const int tile0 = blockIdx.x * g.bt;
  const int l0 = g.bt + 2 * g.halo;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * g.c * g.t_len;

  Stream<K> st{w, 0, 0, 0, 0};
  for (int i = 0; i < kStages - 1; ++i) st.issue(g, plan, wbuf);

  // the haloed tile of x, transposed to [t][c], zero outside [0, t_len)
  for (int e = threadIdx.x; e < (g.c / kV) * l0; e += kThreads) {
    const int a = e % l0, c0 = (e / l0) * kV, pos = tile0 - g.halo + a;
    alignas(16) T v[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i)
      v[i] = (pos >= 0 && pos < g.t_len)
                 ? x[row0 + static_cast<size_t>(c0 + i) * g.t_len + pos]
                 : zero<T>();
    *reinterpret_cast<uint4*>(xs + a * g.xs + c0 * sizeof(T)) =
        *reinterpret_cast<const uint4*>(v);
  }

  int s = 0, xoff = 0, base = tile0 - g.halo;   // X's live rows from xoff
  for (int di = 0; di < plan.n_dil; ++di) {
    const int d = plan.d[di], h1 = d * p;
    const int len = plan.lout[2 * di] + 2 * h1;   // X's live rows
    // Y = lrelu(X) over the live rows, once for all taps and output
    // channels; the first conv's barrier orders it before the reads
    __syncthreads();
    for (int e = threadIdx.x; e < (g.c / kV) * len; e += kThreads) {
      const int r = e % len, c0 = (e / len) * kV;
      uint4 v = *reinterpret_cast<const uint4*>(xs + (xoff + r) * g.xs + c0 * sizeof(T));
      lrelu16<T>(v);
      *reinterpret_cast<uint4*>(ys + r * g.xs + c0 * sizeof(T)) = v;
    }
    conv<T, K, NT, true>(g, plan, 2 * di, ys, ys, d, bias, base + h1, st,
                         wbuf, s);
    conv<T, K, NT, false>(g, plan, 2 * di + 1, ys, xs + (xoff + h1 + p) * g.xs,
                          1, bias, base + h1 + p, st, wbuf, s);
    xoff += h1 + p;
    base += h1 + p;
  }
  __syncthreads();

  // the live rows (bt of them, base == tile0) back to [C, T]
  for (int e = threadIdx.x; e < (g.c / kV) * g.bt; e += kThreads) {
    const int v = e % g.bt, c0 = (e / g.bt) * kV;
    if (tile0 + v >= g.t_len) continue;
    alignas(16) T vals[kV];
    *reinterpret_cast<uint4*>(vals) =
        *reinterpret_cast<const uint4*>(xs + (xoff + v) * g.xs + c0 * sizeof(T));
#pragma unroll
    for (int i = 0; i < kV; ++i)
      out[row0 + static_cast<size_t>(c0 + i) * g.t_len + tile0 + v] = vals[i];
  }
}

// n-tiles of a warp tile: 8 (64 output channels) where C allows, else 4 or 2
__host__ __device__ constexpr int n_tiles(int c) {
  return c % 64 == 0 ? 8 : c % 32 == 0 ? 4 : 2;
}

template <typename T, int K, int NT>
cudaError_t launch(const void* x, void* out, const bf16* w, const float* b,
                   int n, int c, int t, int bt, const int* dil, int n_dil,
                   cudaStream_t stream) {
  constexpr int p = (K - 1) / 2;
  Geo g;
  Plan plan;
  g.c = c;
  g.t_len = t;
  g.bt = bt;
  g.halo = 0;
  plan.n_dil = n_dil;
  for (int i = 0; i < kMaxDil; ++i) plan.d[i] = i < n_dil ? dil[i] : 0;
  for (int i = 0; i < n_dil; ++i) g.halo += dil[i] * p + p;
  g.kc = ci_chunk<T>(c);
  g.nck = c / g.kc;
  g.xs = c * static_cast<int>(sizeof(T)) + Cfg<T>::kPad;
  g.ws = g.kc * 2 + 16;
  g.cg = c / (8 * NT);
  g.rg = kWarps / g.cg;
  if (g.rg == 0) return cudaErrorInvalidValue;
  g.stage_elems = Cfg<T>::kPlanes * c * g.kc;
  g.stage_bytes = Cfg<T>::kPlanes * c * g.ws;
  const int cap = g.rg * Cfg<T>::kMt;
  int len = bt + 2 * g.halo;
  for (int i = 0; i < 2 * kMaxDil; ++i) plan.lout[i] = plan.rounds[i] = 0;
  for (int i = 0; i < n_dil; ++i) {
    const int l1 = len - 2 * dil[i] * p, l2 = l1 - 2 * p;
    plan.lout[2 * i] = l1;
    plan.lout[2 * i + 1] = l2;
    plan.rounds[2 * i] = ((l1 + 15) / 16 + cap - 1) / cap;
    plan.rounds[2 * i + 1] = ((l2 + 15) / 16 + cap - 1) / cap;
    len = l2;
  }
  g.x_rows = g.y_rows = bt + 2 * g.halo + kSlack;
  const size_t smem = static_cast<size_t>(g.x_rows + g.y_rows) * g.xs +
                      static_cast<size_t>(kStages) * g.stage_bytes;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = resblock1_kernel<T, K, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t + bt - 1) / bt, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), w, b, g, plan);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_k(const void* x, void* out, const bf16* w, const float* b,
                     int n, int c, int t, int bt, const int* dil, int n_dil,
                     cudaStream_t s) {
  switch (n_tiles(c)) {
    case 8: return launch<T, K, 8>(x, out, w, b, n, c, t, bt, dil, n_dil, s);
    case 4: return launch<T, K, 4>(x, out, w, b, n, c, t, bt, dil, n_dil, s);
    default: return launch<T, K, 2>(x, out, w, b, n, c, t, bt, dil, n_dil, s);
  }
}

template <typename T>
cudaError_t dispatch(int k, const void* x, void* out, const bf16* w,
                     const float* b, int n, int c, int t, int bt,
                     const int* dil, int n_dil, cudaStream_t s) {
  switch (k) {
    case 3: return launch_k<T, 3>(x, out, w, b, n, c, t, bt, dil, n_dil, s);
    case 7: return launch_k<T, 7>(x, out, w, b, n, c, t, bt, dil, n_dil, s);
    case 11: return launch_k<T, 11>(x, out, w, b, n, c, t, bt, dil, n_dil, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out [n, c, t] of dtype (0 float32, 1 bfloat16); w the packed weights
// (see the header) and b [n_dil, 2, c] float32; dilations: n_dil host ints;
// bt: the output samples per block, a multiple of 16. Returns a cudaError_t
// (0 = launched).
extern "C" int ctts_fused_resblock1(const void* x, void* out, const void* w,
                                    const float* b, int n, int c, int t, int k,
                                    const int* dilations, int n_dil, int bt,
                                    int dtype, void* stream) {
  if (n <= 0 || t <= 0) return cudaSuccess;
  if (c <= 0 || c % 16 != 0 || n_dil <= 0 || n_dil > kMaxDil || bt <= 0 ||
      bt % 16 != 0 || n > 65535)
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_dil; ++i)
    if (dilations[i] <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wp = static_cast<const bf16*>(w);
  if (dtype == 0)
    return dispatch<float>(k, x, out, wp, b, n, c, t, bt, dilations, n_dil, s);
  if (dtype == 1)
    return dispatch<bf16>(k, x, out, wp, b, n, c, t, bt, dilations, n_dil, s);
  return cudaErrorInvalidValue;
}
