// Windowed shared-QK attention, forward and backward, on Hopper's tensor
// cores (sm_90a): the engine that local_window_attention.cu (the reformer's
// local heads) and lsh_chunk_attention.cu (its hashed heads, in the sorted
// domain) instantiate. Included by those two sources only.
//
// The problem. The rows of a row space [G, R] fall into units of Q rows: a
// window of the sequence (local, R = N) or a chunk of the hash-sorted
// sequence (LSH, R = n_hashes * N). The Q queries of unit u attend to 2Q
// key slots: the unit's own Q rows, then the Q rows of the unit before it.
// Row r of the row space reads row src(r) of qk and v [G, N, D], which is
// also its position in the sequence (r itself for the local window,
// st[g, r] in the sorted domain), and has a validity ok[g, r]. Queries are
// the raw shared qk, keys are qk L2-normalised, kn = k * rsqrt(|k|^2 +
// 1e-12), values are v, and the logit (q . kn) * scale takes its masks in
// the order of the reference's jnp code:
//   local (kLsh = false): self pinned to -5e4, then causal (-1e9), then
//     validity (-1e9), so an invalid query row goes uniform over all 2Q
//     slots. Unit 0's look-back is synthetic: zero keys and values, never
//     valid.
//   LSH (kLsh = true): validity, then causal, then self pinned to -5e4
//     last, so every row keeps its own key. Unit 0 looks back at the last
//     unit (crossing hash rounds); a position may sit in two slots.
//
// What bounds it on the H100: per query at most 2Q keys of D = 128, so
// about 4 * 2Q * D flops forward (10 * 2Q * D backward) for the ~4 * D
// bytes of its bf16 qk, v and output row: ~256 flops per byte at Q = 128,
// just under the card's bf16 ridge (~295), so at the tensor cores' full
// rate the bytes would bound it (chip_smoke.py counts both). What bounds
// it in practice is the latency of each warp's per-tile work, the
// mma.sync stream and the per-logit work of the CUDA cores (masks, exp,
// the online softmax), at the few warps an SM holds (16 in the bf16
// forward, 8 in the backward, whose registers allow two blocks); the row
// loads, their conversion and the slots' metadata take a tenth of the
// time or less (PERF.md, rows 7 and 8, and §7). The design keeps every
// product on the tensor cores and no logit or probability in device
// memory.
//
// Design. The TPU kernels kept a whole batch row in VMEM (local) or built
// a one-hot gather tile on the MXU (LSH); here a block loads its rows by
// index. A block takes BS = 64 stationary rows of one unit (32 where Q is
// an odd multiple of 32), one warp per 16 rows (the m of mma.m16n8k16), and
// streams the 2Q slots it pairs with in tiles of 64 rows loaded with
// cp.async. The bf16 forward copies each tile's rows straight into their
// shared tiles and waits for them: at 51 KB of shared memory and 128
// registers four blocks share an SM and hide each other's loads, which
// beat a stage of the next tile at two blocks an SM. The backward (about
// 250 registers: two blocks an SM whatever its shared memory) and every
// f32 kernel copy the next tile's raw rows into a stage while the warps
// compute on the current one, which a convert step made from the stage,
// each operand rounded to bf16 or, where it needs more, split into bf16 hi
// + lo. For keys each row's r = rsqrt(|k|^2 + eps) is computed once a tile
// (|k|^2 in f32, summed by 8-element lanes and a butterfly in a fixed
// order, so every block computes the same r). Keys stay raw: q . kn =
// (q . k) * r, so r is folded into the logit (and into dS for dq), and a
// bf16 k enters the products exactly. Shared rows are padded by 16 bytes,
// which puts the 8 rows of an ldmatrix in distinct banks. Products are
// mma.sync.m16n8k16 (bf16 in, f32 sum) fed by ldmatrix; a split operand
// takes three (hi.hi + hi.lo + lo.hi) or two products. The masks and the
// softmax run in the mma's fragment layout (a row spans the 4 lanes of a
// quad); the exponentials are __expf (the SFU's ex2.approx, within a few
// ulp of expf), the same in the forward and the backward.
//   Forward: S = Q k^T, the logits S * r * scale and their masks, an online
//     softmax, then P V with P as the A fragment and V read by
//     ldmatrix.trans. The local forward writes o and each row's max and
//     sum (-1e9 + log(2Q) would round back to -1e9 in f32); the LSH forward
//     writes out || lse in f32 with the output scaled by exp(m - lse),
//     which is exp(logit - lse) summed as the reference does. bf16 rounds P
//     for P V as the TPU kernel does, but the LSH forward keeps P in f32
//     precision (split), because its f32 output is held to the plain f32
//     version at 1e-4.
//   Backward, one launch, each block in two phases over the same rows:
//     query phase: its 64 queries over the 2Q key slots: S, dP = dO V^T,
//       P from the forward's statistics, dS = P * (dP - rowsum(dO * O))
//       (+ dlse * P for LSH), 0 where a logit is a masked or pinned
//       constant, and dq += (dS * scale * r) k; dq is written to the
//       output.
//     key phase: its 64 rows as keys over the 2Q queries that see them
//       (unit u's, then unit u+1's through their look-back), in steps of
//       32 queries: S^T = k Q^T and dP^T = V dO^T, dv += P^T dO and
//       dkn += (dS * scale)^T Q, then dk = r * dkn - k * r^3 * <k, dkn>
//       and the row's dq read back, so each row gets dq + dk and dv in
//       one fixed order. No float atomics: the same bits from run to run.
//     bf16 rounds P, dS * scale (* r) and dO for the products, as the TPU
//     kernel rounds P, dS * scale, dO and kn.
//
// float32 inputs split every operand into bf16 hi + lo (three products),
// which keeps the results within ~1e-5 of float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace ctts_window {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;            // stationary rows of a warp (mma M)
constexpr int kTile = 64;            // slots (or partner queries) of a tile
constexpr int kHalf = 32;            // partner queries of a key-phase step
constexpr int kPadE = 8;             // bf16 padding of a shared row (16 B)
constexpr int kMaxThreads = 128;     // 4 warps: 64 stationary rows
constexpr float kNeg = -1e9f;
constexpr float kSelf = -5e4f;
constexpr float kEps = 1e-12f;

// stationary rows of a block: 64, or 32 where the unit is an odd multiple
// of 32
__host__ __device__ constexpr int block_rows(int unit) {
  return unit % 64 == 0 ? 64 : 32;
}

// ---- PTX wrappers -------------------------------------------------------- //

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// 16 bytes from global to shared memory, asynchronously; zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 operands, split into hi + lo where they need more ------------- //

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// hi (and lo) of the pair (x, y), x in the low half
template <bool kSplit>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  if (kSplit) {
    const float2 f = __bfloat1622float2(h);
    lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
  }
}

// A shared tile of kTile bf16 rows of D, padded: the hi plane, then (split)
// the lo plane `plane` elements later.
template <int D>
struct Tile {
  static constexpr int kStride = D + kPadE;
  bf16* p;
  int plane;
  __device__ __forceinline__ bf16* at(int r, int c) const { return p + r * kStride + c; }
};

template <int D>
__host__ __device__ constexpr int tile_bytes(bool split) {
  return (split ? 2 : 1) * kTile * (D + kPadE) * 2;
}
template <typename T, int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kTile * D * static_cast<int>(sizeof(T));    // two raw tensors
}

template <int D>
__device__ __forceinline__ Tile<D> tile_at(unsigned char* smem, int offset) {
  return {reinterpret_cast<bf16*>(smem + offset), kTile * Tile<D>::kStride};
}

template <bool kSplit> struct FragA { uint32_t h[4], l[4]; };
template <bool kSplit> struct FragB { uint32_t h[4], l[4]; };   // two n-tiles

// A (16 x 16) from rows [r0, r0+16) x cols [c0, c0+16) of a row-major tile
template <bool kSplit, int D>
__device__ __forceinline__ void load_a(FragA<kSplit>& f, const Tile<D>& t,
                                       int r0, int c0, int lane) {
  const bf16* p = t.at(r0 + (lane & 15), c0 + (lane >> 4) * 8);
  ldsm(f.h, p);
  if (kSplit) ldsm(f.l, p + t.plane);
}
// B (16 x 16: two n-tiles) stored as B[k][n] = tile[n0 + n][k0 + k]
template <bool kSplit, int D>
__device__ __forceinline__ void load_b(FragB<kSplit>& f, const Tile<D>& t,
                                       int n0, int k0, int lane) {
  const bf16* p = t.at(n0 + (lane & 7) + (lane >> 4) * 8, k0 + ((lane >> 3) & 1) * 8);
  ldsm(f.h, p);
  if (kSplit) ldsm(f.l, p + t.plane);
}
// B (16 x 16: two n-tiles) stored as B[k][n] = tile[k0 + k][n0 + n]
template <bool kSplit, int D>
__device__ __forceinline__ void load_bt(FragB<kSplit>& f, const Tile<D>& t,
                                        int k0, int n0, int lane) {
  const bf16* p = t.at(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8);
  ldsm_t(f.h, p);
  if (kSplit) ldsm_t(f.l, p + t.plane);
}

// c += a . b[n-tile nt], the split's cross terms first: a.lo . b.hi, then
// a.hi . b.lo (kSwap: the other way round, so that a product computed with
// its operands' roles exchanged adds its terms in the same order)
template <bool kSa, bool kSb, bool kSwap = false>
__device__ __forceinline__ void mma(float (&c)[4], const FragA<kSa>& a,
                                    const FragB<kSb>& b, int nt) {
  if (kSa && !kSwap) mma16816(c, a.l, b.h[2 * nt], b.h[2 * nt + 1]);
  if (kSb) mma16816(c, a.h, b.l[2 * nt], b.l[2 * nt + 1]);
  if (kSa && kSwap) mma16816(c, a.l, b.h[2 * nt], b.h[2 * nt + 1]);
  mma16816(c, a.h, b.h[2 * nt], b.h[2 * nt + 1]);
}

// the A operand of columns [16 ks, 16 ks + 16) from an accumulator tile
template <bool kSplit, int N>
__device__ __forceinline__ void frag_of(FragA<kSplit>& f, const float (&x)[N][4],
                                        int ks) {
  split2<kSplit>(x[2 * ks][0], x[2 * ks][1], f.h[0], f.l[0]);
  split2<kSplit>(x[2 * ks][2], x[2 * ks][3], f.h[1], f.l[1]);
  split2<kSplit>(x[2 * ks + 1][0], x[2 * ks + 1][1], f.h[2], f.l[2]);
  split2<kSplit>(x[2 * ks + 1][2], x[2 * ks + 1][3], f.h[3], f.l[3]);
}

// ---- element loads and stores -------------------------------------------- //

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <bool kSplit>
__device__ __forceinline__ void store8(bf16* p, int plane, const float (&x)[8]) {
  uint4 hi, lo;
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
  for (int e = 0; e < 4; ++e) split2<kSplit>(x[2 * e], x[2 * e + 1], h[e], l[e]);
  *reinterpret_cast<uint4*>(p) = hi;
  if (kSplit) *reinterpret_cast<uint4*>(p + plane) = lo;
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the problem ---------------------------------------------------------- //

template <typename T>
struct Args {
  const T* qk;            // [G, n_src, D]
  const T* v;             // [G, n_src, D]
  const int* st;          // LSH: [G, rows] source row of each row
  const int* ok;          // [G, rows], nonzero at valid rows
  int n_src, rows, unit, causal;
  float scale;
  T* o;                   // local forward: [G, rows, D]
  float *m, *l;           // local forward: row max and sum [G, rows]
  float* ol;              // LSH forward: [G, rows, D + 1], out || lse
  const T* dout;          // backward: dO [G, rows, D], the input dtype
  const float* stat_m;    // backward: local row max; LSH lse (stride sstride)
  const float* stat_l;    // backward: local row sum; LSH null
  const float* dlse;      // LSH backward: lse's cotangent (stride sstride)
  int sstride;            // row stride of stat_m and dlse
  const float* delta;     // backward: rowsum(dO * O) [G, rows]
  float* dq;              // backward: dq + dk of each row, f32
  float* dv;              // backward: dv of each row, f32
  int gstride;            // row stride of dq and dv
};

template <bool kLsh>
__device__ __forceinline__ int pos_of(const int* st, size_t gr, int r) {
  return kLsh ? st[gr + r] : r;
}

template <bool kLsh>
__device__ __forceinline__ float masked(float x, int qt, int kt, bool ok,
                                        bool causal) {
  if (kLsh) {
    if (!ok) x = kNeg;
    if (causal && qt < kt) x = kNeg;
    if (qt == kt) x = kSelf;
  } else {
    if (qt == kt) x = kSelf;
    if (causal && qt < kt) x = kNeg;
    if (!ok) x = kNeg;
  }
  return x;
}

// whether the logit is still (q . kn) * scale after the masks; elsewhere it
// is a constant and passes no gradient to q or k
__device__ __forceinline__ bool live(int qt, int kt, bool ok, bool causal) {
  return ok && qt != kt && !(causal && qt < kt);
}

// The block's unit and rows: blockIdx = (row block, unit, g).
struct Unit {
  int u, n, Q, bs, row0;        // row0: the first of the bs stationary rows
  size_t gr, gs;                // g's offsets in the row space and the source
};

template <typename T, int D>
__device__ __forceinline__ Unit unit_of(const Args<T>& a) {
  Unit t;
  t.u = blockIdx.y;
  t.Q = a.unit;
  t.n = a.rows / a.unit;
  t.bs = static_cast<int>(blockDim.x) / 32 * kRows;
  t.row0 = t.u * t.Q + static_cast<int>(blockIdx.x) * t.bs;
  t.gr = static_cast<size_t>(blockIdx.z) * a.rows;
  t.gs = static_cast<size_t>(blockIdx.z) * a.n_src * D;
  return t;
}

// The row of key slot j of the unit: its own rows, then the look-back's
// (LSH: the unit before, unit 0 the last; local: unit 0's are synthetic, -1)
template <bool kLsh>
__device__ __forceinline__ int key_row(const Unit& t, int j) {
  if (j < t.Q) return t.u * t.Q + j;
  if (kLsh) return ((t.u + t.n - 1) % t.n) * t.Q + j - t.Q;
  return t.u == 0 ? -1 : (t.u - 1) * t.Q + j - t.Q;
}
// The row of partner query slot j: the queries that see the unit's rows as
// keys, its own, then those of the unit after it (-1: none, local)
template <bool kLsh>
__device__ __forceinline__ int query_row(const Unit& t, int j) {
  if (j < t.Q) return t.u * t.Q + j;
  if (kLsh) return ((t.u + 1) % t.n) * t.Q + j - t.Q;
  return t.u + 1 < t.n ? (t.u + 1) * t.Q + j - t.Q : -1;
}

// What a tile's slots are, for the two tiles in flight ([tile & 1]).
struct Meta {
  __align__(16) int row[2][kTile];    // row-space row, -1: none
  __align__(16) int pos[2][kTile];    // position (source row), -1: none
  __align__(16) int ok[2][kTile];
  __align__(16) float r[2][kTile];    // key slots: rsqrt(|k|^2 + eps)
  // key phase: each partner query's statistics (sm = +inf where none, so
  // its P is 0)
  __align__(16) float sm[2][kTile];
  __align__(16) float sl[2][kTile];
  __align__(16) float delta[2][kTile];
  __align__(16) float dlse[2][kTile];
};

// the rows of the stationary rows into meta[buf] (read after a barrier)
template <typename T, bool kLsh>
__device__ void stationary_meta(const Args<T>& a, const Unit& t, Meta& m,
                                int buf) {
  if (threadIdx.x < kTile) {
    const int j = threadIdx.x, row = j < t.bs ? t.row0 + j : -1;
    m.row[buf][j] = row;
    m.pos[buf][j] = row < 0 ? -1 : pos_of<kLsh>(a.st, t.gr, row);
  }
}

// the slots [j0, j0 + kTile) into meta[buf]: key slots, or (kPartner)
// partner query slots with their statistics
template <typename T, bool kLsh, bool kPartner>
__device__ void set_meta(const Args<T>& a, const Unit& t, Meta& m, int buf,
                         int j0) {
  if (threadIdx.x >= kTile) return;
  const int j = threadIdx.x;
  const int row = kPartner ? query_row<kLsh>(t, j0 + j) : key_row<kLsh>(t, j0 + j);
  const size_t gr = t.gr + row;
  m.row[buf][j] = row;
  m.pos[buf][j] = row < 0 ? -1 : pos_of<kLsh>(a.st, t.gr, row);
  m.ok[buf][j] = row >= 0 && a.ok[gr] != 0;
  if (kPartner) {
    m.sm[buf][j] = row < 0 ? INFINITY : a.stat_m[gr * a.sstride];
    m.sl[buf][j] = row < 0 || kLsh ? 1.f : a.stat_l[gr];
    m.delta[buf][j] = row < 0 ? 0.f : a.delta[gr];
    m.dlse[buf][j] = row < 0 || !kLsh ? 0.f : a.dlse[gr * a.sstride];
  }
}

// cp.async the kTile rows idx[r] of base [.., D] into dst [kTile][D]; rows
// with idx < 0 are zero. The caller's cp_async_wait() completes them.
template <typename T, int D>
__device__ void issue_rows(T* dst, const T* base, const int* idx) {
  constexpr int kCh = D * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < kTile * kCh; i += blockDim.x) {
    const int r = i / kCh, c = i % kCh, s = idx[r];
    const char* src = reinterpret_cast<const char*>(
        base + static_cast<size_t>(s < 0 ? 0 : s) * D) + c * 16;
    cp_async16(reinterpret_cast<char*>(dst + r * D) + c * 16, src, s >= 0);
  }
}

// cp.async the kTile bf16 rows idx[r] of base [.., D] straight into the
// rows of a compute tile; rows with idx < 0 are zero.
template <int D>
__device__ void issue_tile(const Tile<D>& dst, const bf16* base, const int* idx) {
  constexpr int kCh = D / 8;
  for (int i = threadIdx.x; i < kTile * kCh; i += blockDim.x) {
    const int r = i / kCh, c = (i % kCh) * 8, s = idx[r];
    cp_async16(dst.at(r, c), base + static_cast<size_t>(s < 0 ? 0 : s) * D + c,
               s >= 0);
  }
}

// r = rsqrt(|k|^2 + eps) of a row, from the 8 elements of each of its D / 8
// lanes: summed by each lane in order and then by a butterfly, the same r
// in every block, whatever its size
template <int D>
__device__ __forceinline__ float row_r(const float (&x)[8]) {
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss = fmaf(x[e], x[e], ss);
#pragma unroll
  for (int o = D / 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  return rsqrtf(ss + kEps);
}

// r of each row of a bf16 key tile into r_out
template <int D>
__device__ void key_r(const Tile<D>& k, float* r_out) {
  constexpr int kLpr = D / 8;
  const int per_pass = static_cast<int>(blockDim.x) / kLpr;
  const int c = (threadIdx.x % kLpr) * 8;
  for (int r = threadIdx.x / kLpr; r < kTile; r += per_pass) {
    float x[8];
    load8(k.at(r, c), x);
    const float rr = row_r<D>(x);
    if (c == 0) r_out[r] = rr;
  }
}

// The raw rows of the stage [kTile][D] into a compute tile, rounded or
// split; kKeys: each key row's r (row_r) into r_out. The keys stay raw:
// kn = k * r enters every product as r folded into the logit or into dS.
template <typename T, int D, bool kSplit, bool kKeys>
__device__ void convert(const T* src, const Tile<D>& dst, float* r_out) {
  constexpr int kLpr = D / 8;
  const int per_pass = static_cast<int>(blockDim.x) / kLpr;
  const int c = (threadIdx.x % kLpr) * 8;
  for (int r = threadIdx.x / kLpr; r < kTile; r += per_pass) {
    float x[8];
    load8(src + r * D + c, x);
    if (kKeys) {
      const float rr = row_r<D>(x);
      if (c == 0) r_out[r] = rr;
    }
    store8<kSplit>(dst.at(r, c), dst.plane, x);
  }
}

// ---- forward -------------------------------------------------------------- //

// The forward splits every operand in f32. In bf16 it rounds P for P V,
// but the LSH forward keeps P in f32 precision (split): its f32 output is
// held to the plain f32 version at 1e-4.
// In bf16 the rows land in their tiles as they are (no stage), so four
// blocks fit an SM, registers capped at 128.
template <typename T, bool kLsh>
struct FwdSplit {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kP = kF32 || kLsh;
  static constexpr int kBlocks = kF32 ? 1 : 4;      // a launch bound
};

template <typename T, int D, bool kLsh>
__host__ __device__ constexpr int fwd_smem() {
  using S = FwdSplit<T, kLsh>;
  return 3 * tile_bytes<D>(S::kF32) + (S::kF32 ? stage_bytes<T, D>() : 0);
}

template <typename T, int D, bool kLsh>
__global__ void __launch_bounds__(kMaxThreads, FwdSplit<T, kLsh>::kBlocks)
    window_fwd(Args<T> a) {
  using S = FwdSplit<T, kLsh>;
  constexpr int kDt = D / 8;                    // n-tiles of a row of D
  constexpr int kTb = tile_bytes<D>(S::kF32);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Meta meta;
  const Tile<D> sQ = tile_at<D>(smem, 0), sK = tile_at<D>(smem, kTb);
  const Tile<D> sV = tile_at<D>(smem, 2 * kTb);
  T* stage = reinterpret_cast<T*>(smem + 3 * kTb);      // f32 only

  const Unit t = unit_of<T, D>(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const bool causal = a.causal != 0;

  // the stationary queries (meta[1]) and the rows of tile 0 (meta[0])
  stationary_meta<T, kLsh>(a, t, meta, 1);
  set_meta<T, kLsh, false>(a, t, meta, 0, 0);
  __syncthreads();
  if constexpr (S::kF32) {
    issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[1]);
    cp_async_wait();
    __syncthreads();
    convert<T, D, true, false>(stage, sQ, nullptr);
    __syncthreads();                    // the stage converted
    issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[0]);
    issue_rows<T, D>(stage + kTile * D, a.v + t.gs, meta.pos[0]);
  } else {
    issue_tile<D>(sQ, a.qk + t.gs, meta.pos[1]);
    issue_tile<D>(sK, a.qk + t.gs, meta.pos[0]);
    issue_tile<D>(sV, a.v + t.gs, meta.pos[0]);
  }

  int qt[2];
  bool qok[2];
  float m[2], l[2], acc[kDt][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t.row0 + warp * kRows + g4 + 8 * r;
    qt[r] = pos_of<kLsh>(a.st, t.gr, row);
    qok[r] = a.ok[t.gr + row] != 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kDt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // f32: tile i+1 is staged while tile i computes; bf16: other blocks on
  // the SM compute while a block waits for its tile
  const int n_tiles = 2 * t.Q / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    cp_async_wait();
    __syncthreads();                    // tile i landed
    if constexpr (S::kF32) {
      convert<T, D, true, true>(stage, sK, meta.r[buf]);
      convert<T, D, true, false>(stage + kTile * D, sV, nullptr);
    } else {
      key_r<D>(sK, meta.r[buf]);
    }
    if (i + 1 < n_tiles) set_meta<T, kLsh, false>(a, t, meta, buf ^ 1, (i + 1) * kTile);
    __syncthreads();
    if constexpr (S::kF32) {
      if (i + 1 < n_tiles) {            // in flight while tile i computes
        issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[buf ^ 1]);
        issue_rows<T, D>(stage + kTile * D, a.v + t.gs, meta.pos[buf ^ 1]);
      }
    }

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      FragA<S::kF32> fa;
      load_a(fa, sQ, warp * kRows, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        FragB<S::kF32> fb;
        load_b(fb, sK, np * 16, ks * 16, lane);
        mma(s[2 * np], fa, fb, 0);
        mma(s[2 * np + 1], fa, fb, 1);
      }
    }

    // masks and the online softmax, rows g4 and g4 + 8 of the warp
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t4;
      const int2 kt = *reinterpret_cast<const int2*>(&meta.pos[buf][c]);
      const int2 ko = *reinterpret_cast<const int2*>(&meta.ok[buf][c]);
      const float2 kr = *reinterpret_cast<const float2*>(&meta.r[buf][c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int k_t = (e & 1) ? kt.y : kt.x;
        const bool k_ok = ((e & 1) ? ko.y : ko.x) != 0;
        const float x = masked<kLsh>(
            s[nt][e] * (((e & 1) ? kr.y : kr.x) * a.scale), qt[r], k_t,
            qok[r] && k_ok, causal);
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = __expf(m[r] - mx[r]);    // 0 on the first tile
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
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int nt = 0; nt < kDt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];

#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      FragA<S::kP> fp;
      frag_of<S::kP>(fp, s, ks);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        FragB<S::kF32> fb;
        load_bt(fb, sV, ks * 16, np * 16, lane);
        mma(acc[2 * np], fp, fb, 0);
        mma(acc[2 * np + 1], fp, fb, 1);
      }
    }
    if constexpr (!S::kF32) {
      if (i + 1 < n_tiles) {
        __syncthreads();                // tile i consumed
        issue_tile<D>(sK, a.qk + t.gs, meta.pos[buf ^ 1]);
        issue_tile<D>(sV, a.v + t.gs, meta.pos[buf ^ 1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = t.gr + t.row0 + warp * kRows + g4 + 8 * r;
    if (kLsh) {
      const float lse = m[r] + logf(l[r]);
      const float sc = __expf(m[r] - lse);
      float* out = a.ol + row * (D + 1);
#pragma unroll
      for (int nt = 0; nt < kDt; ++nt) {
        const int col = nt * 8 + 2 * t4;
        out[col] = acc[nt][2 * r] * sc;
        out[col + 1] = acc[nt][2 * r + 1] * sc;
      }
      if (t4 == 0) out[D] = lse;
    } else {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int nt = 0; nt < kDt; ++nt)
        st2(a.o + row * D + nt * 8 + 2 * t4, acc[nt][2 * r] * inv,
            acc[nt][2 * r + 1] * inv);
      if (t4 == 0) {
        a.m[row] = m[r];
        a.l[row] = l[r];
      }
    }
  }
}

// ---- backward ------------------------------------------------------------- //

// Shared memory of the backward: two stationary tiles, the stage, two
// compute tiles; every operand split in f32, none in bf16.
template <typename T, int D>
__host__ __device__ constexpr int bwd_smem() {
  return 4 * tile_bytes<D>(std::is_same<T, float>::value) + stage_bytes<T, D>();
}

// P and dS * scale of one logit, its raw product s = q . k and its key's
// rs = r * scale, from its query row's statistics
template <bool kLsh>
__device__ __forceinline__ void grad_of(float s, float rs, float dp, int qt,
                                        int kt, bool ok, bool causal,
                                        float scale, float sm, float sl,
                                        float delta, float dlse, float& p,
                                        float& ds) {
  const float x = masked<kLsh>(s * rs, qt, kt, ok, causal);
  p = kLsh ? __expf(x - sm) : __expf(x - sm) / sl;
  float d = p * (dp - delta);
  if (kLsh) d += dlse * p;
  ds = live(qt, kt, ok, causal) ? d * scale : 0.f;
}

template <typename T, int D, bool kLsh>
__global__ void __launch_bounds__(kMaxThreads) window_bwd(Args<T> a) {
  constexpr bool kS = std::is_same<T, float>::value;   // split every operand
  constexpr int kDt = D / 8;
  constexpr int kTb = tile_bytes<D>(kS);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Meta meta;
  __shared__ float sR[kTile];
  const Tile<D> stA = tile_at<D>(smem, 0), stB = tile_at<D>(smem, kTb);
  T* stage = reinterpret_cast<T*>(smem + 2 * kTb);
  const int off_c = 2 * kTb + stage_bytes<T, D>();
  const Tile<D> cA = tile_at<D>(smem, off_c), cB = tile_at<D>(smem, off_c + kTb);

  const Unit t = unit_of<T, D>(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const bool causal = a.causal != 0;
  const int n_tiles = 2 * t.Q / kTile;
  const T* dout = a.dout + t.gr * D;           // g's rows of dO

  // ---- query phase: dq of the stationary rows --------------------------- //
  stationary_meta<T, kLsh>(a, t, meta, 0);
  __syncthreads();
  issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[0]);
  issue_rows<T, D>(stage + kTile * D, dout, meta.row[0]);
  cp_async_wait();
  __syncthreads();
  convert<T, D, kS, false>(stage, stA, nullptr);               // Q
  convert<T, D, kS, false>(stage + kTile * D, stB, nullptr);   // dO

  int qt[2];
  bool qok[2];
  float sm[2], sl[2], dl[2], dls[2], dq[kDt][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t.row0 + warp * kRows + g4 + 8 * r;
    const size_t gr = t.gr + row;
    qt[r] = pos_of<kLsh>(a.st, t.gr, row);
    qok[r] = a.ok[gr] != 0;
    sm[r] = a.stat_m[gr * a.sstride];
    sl[r] = kLsh ? 1.f : a.stat_l[gr];
    dl[r] = a.delta[gr];
    dls[r] = kLsh ? a.dlse[gr * a.sstride] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kDt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  set_meta<T, kLsh, false>(a, t, meta, 0, 0);
  __syncthreads();
  issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[0]);
  issue_rows<T, D>(stage + kTile * D, a.v + t.gs, meta.pos[0]);
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    cp_async_wait();
    __syncthreads();
    convert<T, D, kS, true>(stage, cA, meta.r[buf]);           // k, r
    convert<T, D, kS, false>(stage + kTile * D, cB, nullptr);  // V
    if (i + 1 < n_tiles) set_meta<T, kLsh, false>(a, t, meta, buf ^ 1, (i + 1) * kTile);
    __syncthreads();
    if (i + 1 < n_tiles) {
      issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[buf ^ 1]);
      issue_rows<T, D>(stage + kTile * D, a.v + t.gs, meta.pos[buf ^ 1]);
    }

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      FragA<kS> fq, fo;
      load_a(fq, stA, warp * kRows, ks * 16, lane);
      load_a(fo, stB, warp * kRows, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        FragB<kS> fk, fv;
        load_b(fk, cA, np * 16, ks * 16, lane);
        load_b(fv, cB, np * 16, ks * 16, lane);
        mma(s[2 * np], fq, fk, 0);
        mma(s[2 * np + 1], fq, fk, 1);
        mma(dp[2 * np], fo, fv, 0);
        mma(dp[2 * np + 1], fo, fv, 1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t4;
      const int2 kt = *reinterpret_cast<const int2*>(&meta.pos[buf][c]);
      const int2 ko = *reinterpret_cast<const int2*>(&meta.ok[buf][c]);
      const float2 kr = *reinterpret_cast<const float2*>(&meta.r[buf][c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float k_r = (e & 1) ? kr.y : kr.x;
        float p, ds;
        grad_of<kLsh>(s[nt][e], k_r * a.scale, dp[nt][e], qt[r],
                      (e & 1) ? kt.y : kt.x,
                      qok[r] && ((e & 1) ? ko.y : ko.x) != 0, causal, a.scale,
                      sm[r], sl[r], dl[r], dls[r], p, ds);
        s[nt][e] = ds * k_r;             // dq = sum (dS * scale * r) k
      }
    }
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      FragA<kS> fs;
      frag_of<kS>(fs, s, ks);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        FragB<kS> fk;
        load_bt(fk, cA, ks * 16, np * 16, lane);
        mma(dq[2 * np], fs, fk, 0);
        mma(dq[2 * np + 1], fs, fk, 1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* out = a.dq + (t.gr + t.row0 + warp * kRows + g4 + 8 * r) * a.gstride;
#pragma unroll
    for (int nt = 0; nt < kDt; ++nt)
      st2(out + nt * 8 + 2 * t4, dq[nt][2 * r], dq[nt][2 * r + 1]);
  }
  __syncthreads();                       // the tiles are taken over below

  // ---- key phase: dk and dv of the stationary rows ---------------------- //
  stationary_meta<T, kLsh>(a, t, meta, 0);
  __syncthreads();
  issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[0]);
  issue_rows<T, D>(stage + kTile * D, a.v + t.gs, meta.pos[0]);
  cp_async_wait();
  __syncthreads();
  convert<T, D, kS, true>(stage, stA, sR);                     // k, r
  convert<T, D, kS, false>(stage + kTile * D, stB, nullptr);   // V

  int kt[2];
  bool kok[2];
  float dkn[kDt][4], dvv[kDt][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t.row0 + warp * kRows + g4 + 8 * r;
    kt[r] = pos_of<kLsh>(a.st, t.gr, row);
    kok[r] = a.ok[t.gr + row] != 0;
  }
  __syncthreads();                       // sR written
  float krs[2];                          // the rows' r * scale
#pragma unroll
  for (int r = 0; r < 2; ++r) krs[r] = sR[warp * kRows + g4 + 8 * r] * a.scale;
#pragma unroll
  for (int nt = 0; nt < kDt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkn[nt][e] = dvv[nt][e] = 0.f;

  set_meta<T, kLsh, true>(a, t, meta, 0, 0);
  __syncthreads();
  issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[0]);
  issue_rows<T, D>(stage + kTile * D, dout, meta.row[0]);
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    cp_async_wait();
    __syncthreads();
    convert<T, D, kS, false>(stage, cA, nullptr);              // Q
    convert<T, D, kS, false>(stage + kTile * D, cB, nullptr);  // dO
    if (i + 1 < n_tiles) set_meta<T, kLsh, true>(a, t, meta, buf ^ 1, (i + 1) * kTile);
    __syncthreads();
    if (i + 1 < n_tiles) {
      issue_rows<T, D>(stage, a.qk + t.gs, meta.pos[buf ^ 1]);
      issue_rows<T, D>(stage + kTile * D, dout, meta.row[buf ^ 1]);
    }

#pragma unroll
    for (int h = 0; h < kTile / kHalf; ++h) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        FragA<kS> fk, fv;
        load_a(fk, stA, warp * kRows, ks * 16, lane);
        load_a(fv, stB, warp * kRows, ks * 16, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          FragB<kS> fq, fo;
          load_b(fq, cA, h * kHalf + np * 16, ks * 16, lane);
          load_b(fo, cB, h * kHalf + np * 16, ks * 16, lane);
          mma<kS, kS, true>(s[2 * np], fk, fq, 0);
          mma<kS, kS, true>(s[2 * np + 1], fk, fq, 1);
          mma<kS, kS, true>(dp[2 * np], fv, fo, 0);
          mma<kS, kS, true>(dp[2 * np + 1], fv, fo, 1);
        }
      }
      // element (key row g4 + 8r, partner query c): P into dp, dS into s
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = h * kHalf + nt * 8 + 2 * t4;
        const int2 q_t = *reinterpret_cast<const int2*>(&meta.pos[buf][c]);
        const int2 q_o = *reinterpret_cast<const int2*>(&meta.ok[buf][c]);
        const float2 q_m = *reinterpret_cast<const float2*>(&meta.sm[buf][c]);
        const float2 q_l = *reinterpret_cast<const float2*>(&meta.sl[buf][c]);
        const float2 q_d = *reinterpret_cast<const float2*>(&meta.delta[buf][c]);
        const float2 q_s = *reinterpret_cast<const float2*>(&meta.dlse[buf][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool y = e & 1;
          grad_of<kLsh>(s[nt][e], krs[r], dp[nt][e], y ? q_t.y : q_t.x, kt[r],
                        (y ? q_o.y : q_o.x) != 0 && kok[r], causal, a.scale,
                        y ? q_m.y : q_m.x, y ? q_l.y : q_l.x,
                        y ? q_d.y : q_d.x, y ? q_s.y : q_s.x, dp[nt][e],
                        s[nt][e]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < kHalf / 16; ++ks) {
        FragA<kS> fp, fs;
        frag_of<kS>(fp, dp, ks);
        frag_of<kS>(fs, s, ks);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          FragB<kS> fo, fq;
          load_bt(fo, cB, h * kHalf + ks * 16, np * 16, lane);
          load_bt(fq, cA, h * kHalf + ks * 16, np * 16, lane);
          mma(dvv[2 * np], fp, fo, 0);
          mma(dvv[2 * np + 1], fp, fo, 1);
          mma(dkn[2 * np], fs, fq, 0);
          mma(dkn[2 * np + 1], fs, fq, 1);
        }
      }
    }
  }

  // dk = r * dkn - k * r^3 * <k, dkn>; the row's dq + dk, and dv
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * kRows + g4 + 8 * r;
    const size_t row = t.gr + t.row0 + lr;
    const T* k = a.qk + t.gs + static_cast<size_t>(kt[r]) * D + 2 * t4;
    float inner = 0.f;
#pragma unroll
    for (int nt = 0; nt < kDt; ++nt) {
      const float2 kk = ld2(k + nt * 8);
      inner = fmaf(kk.x, dkn[nt][2 * r], inner);
      inner = fmaf(kk.y, dkn[nt][2 * r + 1], inner);
    }
    inner = quad_sum(inner);
    const float rr = sR[lr], r3 = rr * rr * rr;
    float* dqk = a.dq + row * a.gstride + 2 * t4;
    float* dv = a.dv + row * a.gstride + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < kDt; ++nt) {
      const float2 kk = ld2(k + nt * 8);
      const float2 q = ld2(dqk + nt * 8);      // this thread's query phase
      st2(dqk + nt * 8, q.x + (rr * dkn[nt][2 * r] - kk.x * r3 * inner),
          q.y + (rr * dkn[nt][2 * r + 1] - kk.y * r3 * inner));
      st2(dv + nt * 8, dvv[nt][2 * r], dvv[nt][2 * r + 1]);
    }
  }
}

// ---- launches ------------------------------------------------------------- //

// The shapes the kernels take: the unit a multiple of 32, whole units, and
// a grid within its limits.
inline bool bad_shape(int g, int rows, int unit, int n_src) {
  return g <= 0 || g > 65535 || n_src <= 0 || unit <= 0 || unit % 32 ||
         rows <= 0 || rows % unit || rows / unit > 65535;
}

template <typename T, int D, bool kLsh>
cudaError_t launch_fwd(const Args<T>& a, int g, cudaStream_t stream) {
  constexpr int smem = fwd_smem<T, D, kLsh>();
  cudaError_t e = cudaFuncSetAttribute(
      window_fwd<T, D, kLsh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int bs = block_rows(a.unit);
  const dim3 grid(a.unit / bs, a.rows / a.unit, g);
  window_fwd<T, D, kLsh><<<grid, 2 * bs, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kLsh>
cudaError_t launch_bwd(const Args<T>& a, int g, cudaStream_t stream) {
  constexpr int smem = bwd_smem<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      window_bwd<T, D, kLsh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int bs = block_rows(a.unit);
  const dim3 grid(a.unit / bs, a.rows / a.unit, g);
  window_bwd<T, D, kLsh><<<grid, 2 * bs, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ctts_window
