// Padding-masked softmax attention, forward, on Hopper's tensor cores
// (sm_90a).
//
// Replaces the Pallas kernel ctts_tpu/ops/attention.py:41 (_attn_kernel,
// launched by _fused at :60-78 under fused_attention :97). Same contract:
// q, k, v, o are [N, T, D] (N = batch * heads), lengths [N] int32; the
// logits (q . k) * scale at key index >= lengths[n] are replaced by -1e9
// (not -inf), the softmax runs in f32, and the result is written in the
// input dtype (bf16 or f32). A row with lengths[n] == 0 therefore averages
// V uniformly over all T keys, exactly as _reference_attention does.
//
// What bounds it on the H100: at the served shapes (T <= ~1.2k, D = 128)
// the work is 4 * T * sum_n(kv_n) * D flops over about 4 * N * T * D
// elements of I/O, some T/2 flops per byte in bf16: above the card's ~295
// flops-per-byte ridge once T passes ~600, so at the tensor cores' rate the
// operations bound it (chip_smoke.py counts both).
//
// Design: flash-style, the function of the Pallas kernel rather than its
// blocks (which held K and V whole in VMEM; a block here streams them). A
// block takes kBq = 64 query rows of one n, 16 rows a warp (the m of
// mma.m16n8k16), and walks the keys in tiles of kBk = 64 with an online
// softmax, so the [T, T] matrix never reaches device memory. Keys at or
// past kv_end = lengths[n] > 0 ? lengths[n] : T add exactly 0 after the
// -1e9 fill, so whole tiles past kv_end are never loaded, and in the last
// tile the keys past kv_end are zero rows masked to -inf; a zero-length row
// walks all T keys with every logit at -1e9 (the running max is -1e9 from
// the first tile on, so each key weighs exp(0) = 1). Query rows past T
// are zero rows whose output is not written.
//   Products: S = Q K^T and O += P V on mma.sync.m16n8k16 (bf16 in, f32
// sum) fed by ldmatrix (ldmatrix.trans for V), with the fragment helpers of
// window_attention.cuh. The scale multiplies the f32 logit, as the Pallas
// kernel's q * scale in f32 does, so bf16 logits are exact products. The
// masks and the online softmax run in the accumulator's fragment layout
// (a row spans the 4 lanes of a quad); the exponentials are __expf (the
// SFU's ex2.approx, within a few ulp of expf).
//   bf16: Q, K and V land in their padded shared tiles by cp.async, K and V
// double-buffered, so the next tile's copy runs while the warps compute;
// P is rounded to bf16 for P V, as _reference_attention rounds its
// probabilities to the input dtype.
//   f32: every operand is split into bf16 hi + lo (three products, within
// ~1e-5 of f32): each tile is read into registers and stored split, one
// buffer (at D = 256 two split buffers would not fit).
//   D = 256: 16 rows x 256 columns of O would be 128 accumulator registers
// a thread, so two warps share each 16 query rows: both compute the rows'
// S over all 256 dims (the same arithmetic, so the same softmax), and each
// keeps and writes 128 of the output columns. Eight warps a block.
//   D = 16 and 32 (heads of 8 and 16 in 256): the same kernel with one or
// two k-steps in S and two or four output n-tiles a warp; the wrapper
// zero-pads any other width up to 256 to the next instance.
// Every output is a sum in a fixed order: two runs give the same bits.

#include <atomic>

#include "window_attention.cuh"

namespace {

namespace cw = ctts_window;
using cw::bf16;

constexpr int kBq = 64;       // query rows of a block, 16 a warp
constexpr int kBk = 64;       // keys of a tile (cw::kTile rows)
constexpr int kColsMax = 128; // output columns of a warp
constexpr float kNeg = -1e9f;

static_assert(kBq == 4 * cw::kRows && kBk == cw::kTile,
              "a block's query rows and a key tile are the engine's tiles");

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kCols = D < kColsMax ? D : kColsMax;
  static constexpr int kShare = D / kCols;       // warps sharing 16 rows
  static constexpr int kThreads = 4 * kShare * 32;
  static constexpr int kBufs = kF32 ? 1 : 2;     // K/V buffers
  static constexpr int kTb = cw::tile_bytes<D>(kF32);
  static constexpr int kSmem = (1 + 2 * kBufs) * kTb;
};

// cp.async rows [0, rows) of src [.., D] into a bf16 tile; rows [rows, 64)
// become zeros
template <int D>
__device__ void copy_rows(const cw::Tile<D>& dst, const bf16* src, int rows) {
  constexpr int kCh = D / 8;
  for (int i = threadIdx.x; i < kBk * kCh; i += blockDim.x) {
    const int r = i / kCh, c = (i % kCh) * 8;
    const bool ok = r < rows;
    cw::cp_async16(dst.at(r, c), src + static_cast<size_t>(ok ? r : 0) * D + c, ok);
  }
}

// rows [0, rows) of src [.., D] f32 into a tile split into bf16 hi + lo;
// rows [rows, 64) become zeros
template <int D>
__device__ void split_rows_to(const cw::Tile<D>& dst, const float* src, int rows) {
  constexpr int kCh = D / 8;
  for (int i = threadIdx.x; i < kBk * kCh; i += blockDim.x) {
    const int r = i / kCh, c = (i % kCh) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows) cw::load8(src + static_cast<size_t>(r) * D + c, x);
    cw::store8<true>(dst.at(r, c), dst.plane, x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const int* __restrict__ lengths,
         T* __restrict__ o, int seq, float scale) {
  using C = Cfg<T, D>;
  constexpr bool kS = C::kF32;                  // split every operand
  constexpr int kCt = C::kCols / 8;             // n-tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem[];
  const cw::Tile<D> sQ = cw::tile_at<D>(smem, 0);

  const int n = blockIdx.y, q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % 4) * cw::kRows;        // the warp's query rows
  const int c0 = (warp / 4) * C::kCols;         // and its output columns
  const int g4 = lane >> 2, t4 = lane & 3;
  const size_t base = static_cast<size_t>(n) * seq * D;
  const int len = lengths[n];
  const int kv_end = len > 0 ? min(len, seq) : seq;
  const int n_tiles = (kv_end + kBk - 1) / kBk;
  const int q_rows = min(kBq, seq - q0);

  if constexpr (!kS) {
    copy_rows<D>(sQ, reinterpret_cast<const bf16*>(q) + base + static_cast<size_t>(q0) * D, q_rows);
    copy_rows<D>(cw::tile_at<D>(smem, C::kTb), reinterpret_cast<const bf16*>(k) + base,
                  min(kBk, kv_end));
    copy_rows<D>(cw::tile_at<D>(smem, 2 * C::kTb), reinterpret_cast<const bf16*>(v) + base,
                  min(kBk, kv_end));
    cw::cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[kCt][4];
#pragma unroll
  for (int nt = 0; nt < kCt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int j0 = i * kBk;
    const int buf = C::kBufs == 2 ? (i & 1) : 0;
    const cw::Tile<D> sK = cw::tile_at<D>(smem, (1 + 2 * buf) * C::kTb);
    const cw::Tile<D> sV = cw::tile_at<D>(smem, (2 + 2 * buf) * C::kTb);
    if constexpr (kS) {
      __syncthreads();                          // tile i-1 consumed
      if (i == 0)
        split_rows_to<D>(sQ, reinterpret_cast<const float*>(q) + base + static_cast<size_t>(q0) * D,
                      q_rows);
      const size_t at = base + static_cast<size_t>(j0) * D;
      split_rows_to<D>(sK, reinterpret_cast<const float*>(k) + at, min(kBk, kv_end - j0));
      split_rows_to<D>(sV, reinterpret_cast<const float*>(v) + at, min(kBk, kv_end - j0));
      __syncthreads();
    } else {
      if (i + 1 < n_tiles) {                    // tile i+1 in flight meanwhile
        const size_t at = base + static_cast<size_t>(j0 + kBk) * D;
        const int rows = min(kBk, kv_end - j0 - kBk);
        copy_rows<D>(cw::tile_at<D>(smem, (3 - 2 * buf) * C::kTb),
                      reinterpret_cast<const bf16*>(k) + at, rows);
        copy_rows<D>(cw::tile_at<D>(smem, (4 - 2 * buf) * C::kTb),
                      reinterpret_cast<const bf16*>(v) + at, rows);
        cw::cp_async_commit();
        cw::cp_async_wait_group<1>();               // tile i (and Q) landed
      } else {
        cw::cp_async_wait_group<0>();
      }
      __syncthreads();
    }

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      cw::FragA<kS> fa;
      cw::load_a(fa, sQ, r0, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        cw::FragB<kS> fb;
        cw::load_b(fb, sK, np * 16, ks * 16, lane);
        cw::mma(s[2 * np], fa, fb, 0);
        cw::mma(s[2 * np + 1], fa, fb, 1);
      }
    }

    // the masks and the online softmax, rows g4 and g4 + 8 of the warp
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
        const float x = j < kv_end ? (len > 0 ? s[nt][e] * scale : kNeg) : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = cw::quad_max(mx[r]);              // finite: key j0 < kv_end
      alpha[r] = __expf(m[r] - mx[r]);          // 0 on the first tile
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + cw::quad_sum(sum[r]);
#pragma unroll
    for (int nt = 0; nt < kCt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];

    // O += P V over the warp's output columns
#pragma unroll
    for (int ks = 0; ks < kBk / 16; ++ks) {
      cw::FragA<kS> fp;
      cw::frag_of<kS>(fp, s, ks);
#pragma unroll
      for (int np = 0; np < kCt / 2; ++np) {
        cw::FragB<kS> fb;
        cw::load_bt(fb, sV, ks * 16, c0 + np * 16, lane);
        cw::mma(acc[2 * np], fp, fb, 0);
        cw::mma(acc[2 * np + 1], fp, fb, 1);
      }
    }
    if constexpr (!kS) __syncthreads();        // tile i consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + r0 + g4 + 8 * r;
    if (t >= seq) continue;
    const float inv = 1.f / l[r];
    T* out = o + base + static_cast<size_t>(t) * D + c0 + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < kCt; ++nt)
      cw::st2(out + nt * 8, acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int n, int seq, float scale,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  // the opt-in past 48 KB of shared memory, once per instance and device
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(attn_fwd<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((seq + kBq - 1) / kBq, n);
  attn_fwd<T, D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), seq, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d = 16, 32, 64, 128 or 256; q, k, v and o
// 16-byte aligned. Returns a cudaError_t (0 = launched), or
// cudaErrorInvalidValue for a shape or dtype this kernel does not take.
extern "C" int ctts_fused_attention(const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* o, int n, int seq, int d,
                                    float scale, int dtype, void* stream) {
  if (n <= 0 || seq <= 0 || n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 16) return launch<float, 16>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 0 && d == 32) return launch<float, 32>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 0 && d == 256) return launch<float, 256>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 16) return launch<bf16, 16>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 32) return launch<bf16, 32>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 64) return launch<bf16, 64>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 128) return launch<bf16, 128>(q, k, v, lengths, o, n, seq, scale, s);
  if (dtype == 1 && d == 256) return launch<bf16, 256>(q, k, v, lengths, o, n, seq, scale, s);
  return cudaErrorInvalidValue;
}

// The error text of a code returned by any entry of the kernel library
// (every csrc/*.cu links into one library; this is its one copy).
extern "C" const char* ctts_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
