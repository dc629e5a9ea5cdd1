// Transformer-XL relative-position attention, forward and backward, on
// Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas kernels ctts_tpu/ops/relpos_attention.py:161
// (_fwd_kernel, launched by _fused at :371) and :217 (_bwd_kernel, launched
// by _fused_bwd at :397). For q, k, v [N = B*H, T, D], pos [H, T, D], the
// biases u, v [H, D] (float32) and scale = 1/sqrt(d_model):
//
//   S = ((Q+u).K^T + shift((Q+v).Pos^T)) * scale,   O = dropout(softmax(S)).V
//
// with the reference's legacy shift (relpos_attention.py:19-25):
//   rel[q,k] = (Q[q]+v).pos[T-1-q+k] for k <= q;  rel[q,q+1] = 0;
//   rel[q,k] = (Q[q+1]+v).pos[k-q-2] for k > q+1.
// An optional int32 key mask [B, T] (0 at padding) sets masked logits to
// exactly -1e9; keys past T are -inf. Dropout keeps (q,k) when
// hash(seed, n, q, k) >= thresh; the hash is the one
// ctts_torch/ops/relpos_attention.py:dropout_keep computes, and the
// backward regenerates the same bits from the same seed words. D is 16, 32,
// 64, 128 or 256 (the wrapper zero-pads any other width up to 256 to the
// next of these).
//
// What bounds it on the H100: 6*N*T^2*D flop forward and 16*N*T^2*D
// backward over O(N*T*D) bytes. At the conformer's D = 32 that is far
// above the ridge point, yet the products are not where the time goes:
// each score also costs an exp, a dropout hash, its masks and the shift's
// trip through shared memory, work of the CUDA cores that no tensor-core
// rate removes, and the backward computes every score once more. The
// kernels keep those per-score costs few and every product on the tensor
// cores; what is left is bound by the issue rate of that per-score work at
// the occupancy the registers allow, and in the backward also by the
// traffic of its two [N, T, T] stores (PERF.md, row 6 and §7).
//
// Design. The TPU kernel held K, V and pos whole in VMEM and undid the
// shift with flips and strided rolls. Here every product is a warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from shared
// memory; a warp owns a tile of 16 query rows x 64 keys, a block four such
// warps (64 queries). The shift is a band product and a skew: for the
// warp's rows [qw, qw+16) and keys [kw, kw+64), the left-of-diagonal
// scores read pos rows T-1-qw-15+kw + (j+15-i) (i the row, j the key of
// the tile), so one product (Q+v)[16, D] x Pos_band[80, D]^T gives every
// one of them at band column c = j+15-i; the right-of-diagonal scores are
// the same product with the rows Q[q+1]+v and the band starting at
// kw-qw-17. The band (f32) goes through a per-warp shared buffer and each
// score reads its column back. A warp wholly on one side of the diagonal
// computes one band. The softmax runs in the mma's fragment layout: a row
// spans the 4 lanes of a quad, so its max and sum take 2 shuffles, and P
// feeds P.V from registers. P is rounded to bf16 for P.V, as the plain
// version's probs.to(q.dtype). Dropout takes one hash mix per score: the
// row's key once per row, each key column's mix once per tile.
//
// float32 inputs go through the same products with every operand split
// into bf16 hi + lo, summed as hi.hi + hi.lo + lo.hi (the lo.lo term is
// below 2^-16 of the product), which keeps them within ~1e-5 of float32.
//
// The backward is two launches. The first, in blocks of 64 queries walking
// the keys, recomputes the scores, P and dS = P*(dP*keep - rowsum(dO*O)),
// writes dq through Q+u (dS.K), and stores dS and the dropped P, [N, T,
// ceil8(T)] each in the input dtype (205 MB each at the train shape in
// bf16). The second takes every other gradient as plain products over the
// stores, in three roles of 64-row blocks: keys, dk = dS^T.(Q+u) and dv =
// P^T.dO; query rows and pos rows, the shift's backward, from dS read by
// diagonal (see the second launch's note): dq through Q+v and through
// Q[q+1]+v (what row q sends to row q+1, which the caller adds), and dpos
// per n (which the caller sums over the batch). So the backward computes
// every score once.
// Every sum is taken in a fixed order inside one block: no float atomics,
// so the result is the same from run to run.
//
// Wide heads (D = 128 and 256). At 64 columns the tiles already fill most
// of shared memory and the accumulators most of the registers (the
// backward's first launch sits at its register cap at D = 32), so a wider
// head is not a wider tile. Its row of W = 128 or 256 columns is W / 64
// chunks of 64, and each kernel is the D = 64 kernel over chunks: the
// scores are sums over the chunks, each chunk's operands (Q+u, Q+v, K, the
// pos bands; dO and V for dP) loaded into the same 64-column tiles in turn
// and its products added into the same score tile, so registers and shared
// memory stay those of D = 64. The output columns are split the same way:
// a block computes the scores of its tile over all W columns and keeps the
// products of one 64-column slice of the outputs (blockIdx.z in the
// forward, blockIdx.y in the backward). So each of the W / 64 slices
// recomputes the scores, in the same chunk order and so to the same bits
// (slice 0 alone writes the row statistics and the dS and P scratch); the
// second launch's three roles need no scores and read only their slice's
// columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                 // query rows of a warp (mma M)
constexpr int kBq = kWarps * kRows;       // 64 queries of a block or q-tile
constexpr int kBk = 64;                   // keys of a tile
constexpr int kNt = kBk / 8;              // 8 score n-tiles of a warp
constexpr int kBandW = kBk + kRows;       // 80 band columns of a warp
constexpr int kBandNt = kBandW / 8;       // 10
constexpr int kBand = kBk + kBq;          // 128 pos rows of a block's band
constexpr int kSkew = kBandW + 4;         // f32 row stride of the band buffer
constexpr int kTileS = kBk + 8;           // bf16 row stride of dS / P tiles
constexpr int kScratch = kRows * kSkew * 4;      // bytes of a warp's buffer
static_assert(kRows * (kBk + 4) * 4 <= kScratch, "a staged float32 tile fits");
constexpr float kNeg = -1e9f;
constexpr uint32_t kSalt = 0x5bd1e995u;

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

// ---- bf16 operands, split into hi + lo for float32 ---------------------- //

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

// A shared-memory tile of bf16 rows: the hi plane, then (float32 inputs)
// the lo plane `plane` elements later.
struct Tile {
  bf16* p;
  int plane;
  int stride;
  __device__ __forceinline__ bf16* at(int r, int c) const { return p + r * stride + c; }
};

template <bool kSplit> struct FragA { uint32_t h[4], l[4]; };
template <bool kSplit> struct FragB { uint32_t h[4], l[4]; };   // two n-tiles

// A (16 x 16) from rows [r0, r0+16) x cols [c0, c0+16) of a row-major tile
template <bool kSplit>
__device__ __forceinline__ void load_a(FragA<kSplit>& f, const Tile& t, int r0,
                                       int c0, int lane) {
  const bf16* p = t.at(r0 + (lane & 15), c0 + (lane >> 4) * 8);
  ldsm(f.h, p);
  if (kSplit) ldsm(f.l, p + t.plane);
}
// A (16 x 16) whose transpose is stored: A[m][k] = tile[k0 + k][m0 + m]
template <bool kSplit>
__device__ __forceinline__ void load_at(FragA<kSplit>& f, const Tile& t, int m0,
                                        int k0, int lane) {
  const bf16* p = t.at(k0 + (lane & 7) + (lane >> 4) * 8, m0 + ((lane >> 3) & 1) * 8);
  ldsm_t(f.h, p);
  if (kSplit) ldsm_t(f.l, p + t.plane);
}
// B (16 x 16: two n-tiles) stored as B[k][n] = tile[n0 + n][k0 + k]
template <bool kSplit>
__device__ __forceinline__ void load_b(FragB<kSplit>& f, const Tile& t, int n0,
                                       int k0, int lane) {
  const bf16* p = t.at(n0 + (lane & 7) + (lane >> 4) * 8, k0 + ((lane >> 3) & 1) * 8);
  ldsm(f.h, p);
  if (kSplit) ldsm(f.l, p + t.plane);
}
// B (16 x 16: two n-tiles) stored as B[k][n] = tile[k0 + k][n0 + n]
template <bool kSplit>
__device__ __forceinline__ void load_bt(FragB<kSplit>& f, const Tile& t, int k0,
                                        int n0, int lane) {
  const bf16* p = t.at(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8);
  ldsm_t(f.h, p);
  if (kSplit) ldsm_t(f.l, p + t.plane);
}

// c += a . b[n-tile nt], with the split's cross terms first
template <bool kSplit>
__device__ __forceinline__ void mma(float (&c)[4], const FragA<kSplit>& a,
                                    const FragB<kSplit>& b, int nt) {
  if (kSplit) {
    mma16816(c, a.l, b.h[2 * nt], b.h[2 * nt + 1]);
    mma16816(c, a.h, b.l[2 * nt], b.l[2 * nt + 1]);
  }
  mma16816(c, a.h, b.h[2 * nt], b.h[2 * nt + 1]);
}

// the A operand of keys [16 ks, 16 ks + 16) from an accumulator tile
template <bool kSplit>
__device__ __forceinline__ void frag_of(FragA<kSplit>& f, const float (&x)[kNt][4],
                                        int ks) {
  split2<kSplit>(x[2 * ks][0], x[2 * ks][1], f.h[0], f.l[0]);
  split2<kSplit>(x[2 * ks][2], x[2 * ks][3], f.h[1], f.l[1]);
  split2<kSplit>(x[2 * ks + 1][0], x[2 * ks + 1][1], f.h[2], f.l[2]);
  split2<kSplit>(x[2 * ks + 1][2], x[2 * ks + 1][3], f.h[3], f.l[3]);
}

// ---- loads ---------------------------------------------------------------- //

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

// Loads into shared memory issue every load of a call before they wait for
// any (a load that waited on the store before it would cost a round trip
// to device memory per row chunk). bf16 rows are copied with cp.async,
// which the caller's sync_loads() completes; float32 rows, split into hi
// and lo, go through registers, four chunks a thread at a time.
__device__ __forceinline__ void sync_loads() {
  cp_async_wait();
  __syncthreads();
}

// rows [r0, r0 + rows) of a [T, D] matrix (rows ld elements apart) into
// tile rows [0, rows); rows outside [0, T) are zero
template <typename E, int D>
__device__ void copy_rows(const Tile& t, const E* src, int T, int r0, int rows,
                          int ld = D) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  constexpr int kCh = D / 8;
  const int total = rows * kCh;
  if constexpr (!kSplit) {
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / kCh, c = (i % kCh) * 8, row = r0 + r;
      const bool ok = row >= 0 && row < T;
      cp_async16(t.at(r, c), src + (ok ? static_cast<size_t>(row) * ld + c : 0), ok);
    }
  } else {
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
      float x[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads, row = r0 + i / kCh;
        if (i < total && row >= 0 && row < T) {
          load8(src + static_cast<size_t>(row) * ld + (i % kCh) * 8, x[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < total) store8<true>(t.at(i / kCh, (i % kCh) * 8), t.plane, x[u]);
      }
    }
  }
}

// rows [r0, r0 + 64) x columns [c0, c0 + 64) of a [T, W] matrix (W a
// multiple of 8) into a [64, 64] tile; rows past T and columns past W are
// zero
template <typename E>
__device__ void copy_block(const Tile& t, const E* src, int T, int W, int r0, int c0) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  constexpr int kCh = kBk / 8;
  for (int i0 = threadIdx.x; i0 < kBq * kCh; i0 += 4 * kThreads) {
    float x[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, r = i / kCh, c = c0 + (i % kCh) * 8;
      const bool ok = i < kBq * kCh && r0 + r < T && c < W;
      if (!kSplit && ok) {
        cp_async16(t.at(r, (i % kCh) * 8), src + static_cast<size_t>(r0 + r) * W + c, true);
      } else if (ok) {
        load8(src + static_cast<size_t>(r0 + r) * W + c, x[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, r = i / kCh;
      const bool ok = i < kBq * kCh && r0 + r < T && c0 + (i % kCh) * 8 < W;
      if (i < kBq * kCh && (kSplit || !ok)) store8<kSplit>(t.at(r, (i % kCh) * 8), t.plane, x[u]);
    }
  }
}

// the query rows [q0, q0 + 64) plus the u bias into qu, and [q0, q0 + 65)
// plus the v bias into qv (the bias added in float32, then rounded or
// split); rows at or past T are zero; rows ld elements apart
template <typename E, int D>
__device__ void load_q(const Tile& qu, const Tile& qv, const E* src, int T, int q0,
                       const float* ub, const float* vb, int ld = D) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  constexpr int kCh = D / 8, kTotal = (kBq + 1) * kCh;
  for (int i0 = threadIdx.x; i0 < kTotal; i0 += 4 * kThreads) {
    float x[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, row = q0 + i / kCh;
      if (i < kTotal && row < T) {
        load8(src + static_cast<size_t>(row) * ld + (i % kCh) * 8, x[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, r = i / kCh, c = (i % kCh) * 8;
      if (i >= kTotal) continue;
      const bool ok = q0 + r < T;
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = ok ? x[u][e] + vb[c + e] : 0.f;
      store8<kSplit>(qv.at(r, c), qv.plane, y);
      if (r < kBq) {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = ok ? x[u][e] + ub[c + e] : 0.f;
        store8<kSplit>(qu.at(r, c), qu.plane, y);
      }
    }
  }
}

// ---- dropout hash ---------------------------------------------------------- //

__device__ __forceinline__ uint32_t hmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x4a6ca68bu;
  x ^= x >> 16;
  return x;
}
// n is the row's global batch*head index: a tensor-parallel rank holding
// heads [head_off, head_off + heads) of head_total passes its own rows'
// (b, h) as b*head_total + head_off + h, so its masks are one process's.
__device__ __forceinline__ uint32_t row_key(const long long* seed, int n, int q) {
  const uint32_t s0 = static_cast<uint32_t>(seed[0] & 0xffffffffLL);
  const uint32_t s1 = static_cast<uint32_t>(seed[1] & 0xffffffffLL);
  return hmix(hmix(hmix(static_cast<uint32_t>(q) ^ hmix(static_cast<uint32_t>(n))) ^ s1) ^ s0);
}

template <typename E>
struct Args {
  const E *q, *k, *v, *pos;
  const float *ub, *vb;
  const long long* seed;
  const int* kmask;            // [B, T], 0 at padding; null: no mask
  const E* g;                  // dO (backward)
  const float *m, *l, *delta;  // row max, row sum, rowsum(dO*O) (backward)
  E* o;                        // forward outputs
  float *m_out, *l_out;
  float *dqu, *dqv, *dqvn, *dk, *dv, *dpos;  // backward outputs, f32
  E *ds, *pd;                  // backward: dS*scale and the dropped P, [N, T, ds_width(T)]
  int n, heads, seq;
  int head_off, head_total;    // this launch's heads within all heads (dropout)
  float scale;
  uint32_t thresh;             // 0: no dropout
  float inv_keep;              // 1/(1-p)
};

// The key columns a lane holds in a tile whose first key is kw: column
// j = 8*nt + 2*(lane%4) + e is bit 2*nt + e.
struct Keys {
  uint32_t live, ok;           // in [0, T); and not masked
  uint32_t mix[2 * kNt];       // hmix(k ^ salt) (dropout)
};

template <typename E>
__device__ __forceinline__ Keys key_info(const Args<E>& a, int b, int kw, int lane) {
  Keys kk;
  kk.live = kk.ok = 0;
  const int T = a.seq;
#pragma unroll
  for (int i = 0; i < 2 * kNt; ++i) {
    const int k = kw + 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
    const bool live = k >= 0 && k < T;
    const bool ok = live && (a.kmask == nullptr || a.kmask[static_cast<size_t>(b) * T + k] != 0);
    kk.live |= static_cast<uint32_t>(live) << i;
    kk.ok |= static_cast<uint32_t>(ok) << i;
    kk.mix[i] = a.thresh > 0 ? hmix(static_cast<uint32_t>(k) ^ kSalt) : 0u;
  }
  return kk;
}

// The forward's statistics of the lane's rows qw + lane/4 and +8.
struct Rows {
  float m[2], il[2], dl[2];
  uint32_t rk[2];
  bool ok[2];
};

template <typename E>
__device__ __forceinline__ Rows row_info(const Args<E>& a, int n, int qw, int lane,
                                         bool stats) {
  Rows rw;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = qw + (lane >> 2) + 8 * r;
    const size_t i = static_cast<size_t>(n) * a.seq + q;
    rw.ok[r] = q < a.seq;
    const int n_all = n / a.heads * a.head_total + a.head_off + n % a.heads;
    rw.rk[r] = a.thresh > 0 ? row_key(a.seed, n_all, q) : 0u;
    rw.m[r] = stats && rw.ok[r] ? a.m[i] : 0.f;
    rw.il[r] = stats && rw.ok[r] ? 1.f / a.l[i] : 0.f;
    rw.dl[r] = stats && rw.ok[r] ? a.delta[i] : 0.f;
  }
  return rw;
}

// ---- the warp's 16 x 64 score tile ----------------------------------------- //

// What one warp's tile reads: the rows of its queries in qu and qv (qv one
// row more, for Q[q+1]), its keys in kt, its left and right pos bands (80
// rows each), and where the tile sits.
struct Warp {
  Tile qu, qv, kt, pl, pr;
  int q_r, k_r, pl_r, pr_r;    // first tile row of each window
  int qw, kw;                  // first query and key
  bool left, right;            // whether any score of the tile is on that side
};

__device__ __forceinline__ void zero_tile(float (&o)[kNt][4]) {
#pragma unroll
  for (int t = 0; t < kNt; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
}

// o += A[rows a_r.., D] . B[rows b_r.., D]^T over 64 columns
template <int D, bool kSplit>
__device__ __forceinline__ void dot_tile(float (&o)[kNt][4], const Tile& at, int a_r,
                                         const Tile& bt, int b_r, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    FragA<kSplit> fa;
    load_a(fa, at, a_r, 16 * ks, lane);
#pragma unroll
    for (int np = 0; np < kNt / 2; ++np) {
      FragB<kSplit> fb;
      load_b(fb, bt, b_r + 16 * np, 16 * ks, lane);
      mma(o[2 * np], fa, fb, 0);
      mma(o[2 * np + 1], fa, fb, 1);
    }
  }
}

// s += the positional scores of one side: the band product of the rows
// qv[row..] with the 80 band rows, skewed through the warp's buffer
template <int D, bool kSplit>
__device__ __forceinline__ void add_band(float (&s)[kNt][4], const Warp& w, bool left,
                                         float* buf, int lane) {
  float bnd[kBandNt][4];
#pragma unroll
  for (int t = 0; t < kBandNt; ++t) bnd[t][0] = bnd[t][1] = bnd[t][2] = bnd[t][3] = 0.f;
  const Tile& band = left ? w.pl : w.pr;
  const int b_r = left ? w.pl_r : w.pr_r;
  const int a_r = w.q_r + (left ? 0 : 1);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    FragA<kSplit> fa;
    load_a(fa, w.qv, a_r, 16 * ks, lane);
#pragma unroll
    for (int np = 0; np < kBandNt / 2; ++np) {
      FragB<kSplit> fb;
      load_b(fb, band, b_r + 16 * np, 16 * ks, lane);
      mma(bnd[2 * np], fa, fb, 0);
      mma(bnd[2 * np + 1], fa, fb, 1);
    }
  }
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < kBandNt; ++t) {
    *reinterpret_cast<float2*>(buf + g * kSkew + 8 * t + c) = make_float2(bnd[t][0], bnd[t][1]);
    *reinterpret_cast<float2*>(buf + (g + 8) * kSkew + 8 * t + c) = make_float2(bnd[t][2], bnd[t][3]);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kNt; ++t) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = g + 8 * (x >> 1), j = 8 * t + c + (x & 1);
      const int q = w.qw + row, k = w.kw + j;
      if (left ? k <= q : k >= q + 2) s[t][x] += buf[row * kSkew + j + kRows - 1 - row];
    }
  }
  __syncwarp();
}

// adds the unscaled scores (Q+u).K^T + shift((Q+v).Pos^T) of the warp's
// tile over the D columns in the tiles to s
template <int D, bool kSplit>
__device__ __forceinline__ void raw_scores(float (&s)[kNt][4], const Warp& w,
                                           float* buf, int lane) {
  dot_tile<D, kSplit>(s, w.qu, w.q_r, w.kt, w.k_r, lane);
  if (w.left) add_band<D, kSplit>(s, w, true, buf, lane);
  if (w.right) add_band<D, kSplit>(s, w, false, buf, lane);
}

// From the raw scores (s) and dP = dO.V^T (dp) of a tile: dS * scale into
// s, and the dropped probabilities P*keep/(1-p) into dp. dS is 0 at a
// masked key (the -1e9 fill is a constant) and wherever the query or the
// key is out of range.
template <typename E>
__device__ __forceinline__ void grads(float (&s)[kNt][4], float (&dp)[kNt][4],
                                      const Keys& kk, const Rows& rw, const Args<E>& a) {
  const bool drop = a.thresh > 0;
#pragma unroll
  for (int t = 0; t < kNt; ++t) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = x >> 1, i = 2 * t + (x & 1);
      const bool live = rw.ok[r] && ((kk.live >> i) & 1u);
      const bool ok = (kk.ok >> i) & 1u;
      const float sc = ok ? s[t][x] * a.scale : kNeg;
      const float p = live ? __expf(sc - rw.m[r]) * rw.il[r] : 0.f;
      const float kf = drop ? (hmix(rw.rk[r] ^ kk.mix[i]) >= a.thresh ? a.inv_keep : 0.f) : 1.f;
      s[t][x] = live && ok ? p * (dp[t][x] * kf - rw.dl[r]) * a.scale : 0.f;
      dp[t][x] = p * kf;
    }
  }
}

// The backward keeps dS (times scale) and P between its launches as
// [N, T, W], rows padded to 16 bytes
__host__ __device__ constexpr int ds_width(int T) { return (T + 7) / 8 * 8; }

// the tile geometry of the forward and the backward's first launch: block
// rows [q0, q0+64), keys [k0, k0+64); the bands of the block start at
// T-1-q0-63+k0 (left) and k0-q0-65 (right), 128 rows each
__device__ __forceinline__ int band_left(int T, int q0, int k0) { return T - 1 - q0 - (kBq - 1) + k0; }
__device__ __forceinline__ int band_right(int q0, int k0) { return k0 - q0 - (kBq + 1); }

__device__ __forceinline__ Warp block_warp(const Tile& qu, const Tile& qv, const Tile& kt,
                                           const Tile& pl, const Tile& pr, int q0, int k0,
                                           int warp) {
  Warp w{qu, qv, kt, pl, pr};
  w.q_r = kRows * warp;
  w.k_r = 0;
  w.pl_r = w.pr_r = kBq - kRows - kRows * warp;     // 48 - 16 warp
  w.qw = q0 + kRows * warp;
  w.kw = k0;
  w.left = k0 <= w.qw + kRows - 1;
  w.right = k0 + kBk - 1 >= w.qw + 2;
  return w;
}

template <int D, bool kSplit>
__device__ __forceinline__ Tile carve(unsigned char*& at, int rows) {
  Tile t{reinterpret_cast<bf16*>(at), rows * (D + 8), D + 8};
  at += static_cast<size_t>(rows) * (D + 8) * 2 * (kSplit ? 2 : 1);
  return t;
}
template <bool kSplit>
__device__ __forceinline__ Tile carve_wide(unsigned char*& at, int rows, int stride) {
  Tile t{reinterpret_cast<bf16*>(at), rows * stride, stride};
  at += static_cast<size_t>(rows) * stride * 2 * (kSplit ? 2 : 1);
  return t;
}
template <int D, bool kSplit>
__host__ __device__ constexpr size_t tile_bytes(int rows) {
  return static_cast<size_t>(rows) * (D + 8) * 2 * (kSplit ? 2 : 1);
}

// ---- forward ---------------------------------------------------------------- //

template <int D, bool kSplit>
__host__ __device__ constexpr size_t fwd_smem() {
  return tile_bytes<D, kSplit>(3 * kBq + 1 + kBk) + 2 * tile_bytes<D, kSplit>(kBand) +
         kWarps * kScratch;
}

// W: the head's width, D: the tile's (W / D column chunks and output
// slices, see the note at the top)
template <typename E, int D, int W>
__global__ void __launch_bounds__(kThreads) relpos_fwd(Args<E> a) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  constexpr int kC = W / D;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* at = smem;
  const Tile sQU = carve<D, kSplit>(at, kBq), sQV = carve<D, kSplit>(at, kBq + 1);
  const Tile sK = carve<D, kSplit>(at, kBk), sV = carve<D, kSplit>(at, kBk);
  const Tile sPL = carve<D, kSplit>(at, kBand), sPR = carve<D, kSplit>(at, kBand);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* buf = reinterpret_cast<float*>(at + warp * kScratch);

  const int T = a.seq, n = blockIdx.y, h = n % a.heads, b = n / a.heads;
  const int q0 = blockIdx.x * kBq, qw = q0 + kRows * warp;
  const int c0 = blockIdx.z * D;      // the output slice
  const size_t base = static_cast<size_t>(n) * T * W;
  const E* pos = a.pos + static_cast<size_t>(h) * T * W;
  const float *ub = a.ub + h * W, *vb = a.vb + h * W;
  const bool drop = a.thresh > 0;

  if constexpr (kC == 1) load_q<E, D>(sQU, sQV, a.q + base, T, q0, ub, vb);
  const Rows rw = row_info(a, n, qw, lane, false);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kBk) {
    float s[kNt][4];
    for (int c = 0; c < kC; ++c) {    // the scores, a chunk of columns at a time
      const int cc = c * D;
      __syncthreads();                // the previous tile or chunk is consumed
      if constexpr (kC > 1) load_q<E, D>(sQU, sQV, a.q + base + cc, T, q0, ub + cc, vb + cc, W);
      copy_rows<E, D>(sK, a.k + base + cc, T, k0, kBk, W);
      if (c == 0) copy_rows<E, D>(sV, a.v + base + c0, T, k0, kBk, W);
      if (k0 <= q0 + kBq - 1) copy_rows<E, D>(sPL, pos + cc, T, band_left(T, q0, k0), kBand, W);
      if (k0 + kBk - 1 >= q0 + 2) copy_rows<E, D>(sPR, pos + cc, T, band_right(q0, k0), kBand, W);
      sync_loads();
      if (qw >= T) continue;          // a warp of padding rows
      if (c == 0) zero_tile(s);
      raw_scores<D, kSplit>(s, block_warp(sQU, sQV, sK, sPL, sPR, q0, k0, warp), buf, lane);
    }
    if (qw >= T) continue;
    const Keys kk = key_info(a, b, k0, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kNt; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * t + e;
          float x = ((kk.ok >> i) & 1u) ? s[t][2 * r + e] * a.scale : kNeg;
          if (!((kk.live >> i) & 1u)) x = -INFINITY;
          s[t][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float alpha = __expf(m[r] - mn);     // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kNt; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * t + e;
          float p = __expf(s[t][2 * r + e] - mn);
          sum += p;
          if (drop) p = hmix(rw.rk[r] ^ kk.mix[i]) >= a.thresh ? p * a.inv_keep : 0.f;
          s[t][2 * r + e] = p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        acc[t][2 * r] *= alpha;
        acc[t][2 * r + 1] *= alpha;
      }
    }
    // O += P . V
#pragma unroll
    for (int ks = 0; ks < kBk / 16; ++ks) {
      FragA<kSplit> fp;
      frag_of(fp, s, ks);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        FragB<kSplit> fv;
        load_bt(fv, sV, 16 * ks, 16 * np, lane);
        mma(acc[2 * np], fp, fv, 0);
        mma(acc[2 * np + 1], fp, fv, 1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = qw + (lane >> 2) + 8 * r;
    if (q >= T) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      E* o = a.o + base + static_cast<size_t>(q) * W + c0 + 8 * t + 2 * (lane & 3);
      if (kSplit) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[t][2 * r] * inv, acc[t][2 * r + 1] * inv);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[t][2 * r] * inv, acc[t][2 * r + 1] * inv);
      }
    }
    if ((lane & 3) == 0 && c0 == 0) {
      a.m_out[static_cast<size_t>(n) * T + q] = m[r];
      a.l_out[static_cast<size_t>(n) * T + q] = l[r];
    }
  }
}

// ---- backward ---------------------------------------------------------------- //

template <int D, bool kSplit>
__host__ __device__ constexpr size_t q_smem() {
  return tile_bytes<D, kSplit>(3 * kBq + 1 + 2 * kBk) + 2 * tile_bytes<D, kSplit>(kBand) +
         kWarps * kScratch;
}
// and at W > D the keys of the block's output slice, for dq
template <int D, int W, bool kSplit>
__host__ __device__ constexpr size_t bwd_smem() {
  return q_smem<D, kSplit>() + (W > D ? tile_bytes<D, kSplit>(kBk) : 0);
}

// rows ld elements apart
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 8][4], int T,
                                           int r0, int lane, int limit, int ld = D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= limit || row >= T) continue;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * ld + 8 * t + 2 * (lane & 3)) =
          make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
  }
}

// a [16, 64] tile of the warp (dS*scale, or P) into rows [qw, qw+16), keys
// [kw, kw+64) of dst [T, ds_width(T)], through the warp's buffer, so that
// every lane writes whole 16-byte pieces of a row (the keys past T are
// padding: 0, as every score there)
template <typename E>
__device__ __forceinline__ void store_tile(E* dst, int T, const float (&ds)[kNt][4],
                                           const Warp& w, float* buf, int lane) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kS = kBk + (kF32 ? 4 : 8);     // row stride of the staged tile
  constexpr int kPieces = kBk * sizeof(E) / 16;   // 16-byte pieces of a row
  E* tile = reinterpret_cast<E*>(buf);
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < kNt; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      E* p = tile + (g + 8 * r) * kS + 8 * t + c;
      if (kF32) *reinterpret_cast<float2*>(p) = make_float2(ds[t][2 * r], ds[t][2 * r + 1]);
      else *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(ds[t][2 * r], ds[t][2 * r + 1]);
    }
  }
  __syncwarp();
  const int W = ds_width(T);
  constexpr int kElems = 16 / sizeof(E);
#pragma unroll
  for (int u = lane; u < kRows * kPieces; u += 32) {
    const int i = u / kPieces, k = w.kw + (u % kPieces) * kElems;
    if (w.qw + i < T && k < W)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(w.qw + i) * W + k) =
          *reinterpret_cast<const uint4*>(tile + i * kS + (u % kPieces) * kElems);
  }
  __syncwarp();
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
}

// the backward's first launch: 64 queries, walking the key tiles
template <typename E, int D>
__device__ void bwd_q(const Args<E>& a, int blk, unsigned char* smem) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  unsigned char* at = smem;
  const Tile sQU = carve<D, kSplit>(at, kBq), sQV = carve<D, kSplit>(at, kBq + 1);
  const Tile sG = carve<D, kSplit>(at, kBq);
  const Tile sK = carve<D, kSplit>(at, kBk), sV = carve<D, kSplit>(at, kBk);
  const Tile sPL = carve<D, kSplit>(at, kBand), sPR = carve<D, kSplit>(at, kBand);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* buf = reinterpret_cast<float*>(at + warp * kScratch);

  const int T = a.seq, n_t = (T + kBq - 1) / kBq;
  const int n = blk / n_t, q0 = (blk % n_t) * kBq, h = n % a.heads, b = n / a.heads;
  const int qw = q0 + kRows * warp;
  const size_t base = static_cast<size_t>(n) * T * D;
  const E* pos = a.pos + static_cast<size_t>(h) * T * D;

  copy_rows<E, D>(sG, a.g + base, T, q0, kBq);
  load_q<E, D>(sQU, sQV, a.q + base, T, q0, a.ub + h * D, a.vb + h * D);
  const Rows rw = row_info(a, n, qw, lane, true);
  float dqu[D / 8][4];
  zero<D>(dqu);

  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();
    copy_rows<E, D>(sK, a.k + base, T, k0, kBk);
    copy_rows<E, D>(sV, a.v + base, T, k0, kBk);
    if (k0 <= q0 + kBq - 1) copy_rows<E, D>(sPL, pos, T, band_left(T, q0, k0), kBand);
    if (k0 + kBk - 1 >= q0 + 2) copy_rows<E, D>(sPR, pos, T, band_right(q0, k0), kBand);
    sync_loads();
    if (qw >= T) continue;

    const Warp w = block_warp(sQU, sQV, sK, sPL, sPR, q0, k0, warp);
    float s[kNt][4], dp[kNt][4];
    zero_tile(s);
    raw_scores<D, kSplit>(s, w, buf, lane);
    zero_tile(dp);
    dot_tile<D, kSplit>(dp, sG, w.q_r, sV, 0, lane);
    grads(s, dp, key_info(a, b, k0, lane), rw, a);
    const size_t at_n = static_cast<size_t>(n) * T * ds_width(T);
    store_tile(a.ds + at_n, T, s, w, buf, lane);
    store_tile(a.pd + at_n, T, dp, w, buf, lane);
    // dq through Q+u: dS . K
#pragma unroll
    for (int ks = 0; ks < kBk / 16; ++ks) {
      FragA<kSplit> fs;
      frag_of(fs, s, ks);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        FragB<kSplit> fk;
        load_bt(fk, sK, 16 * ks, 16 * np, lane);
        mma(dqu[2 * np], fs, fk, 0);
        mma(dqu[2 * np + 1], fs, fk, 1);
      }
    }
  }
  store_rows<D>(a.dqu + base, dqu, T, qw, lane, T);
}

// the same for a head W wider than the tile D (W, D as in the forward; the
// output slice is blockIdx.y): S and dP a chunk of columns at a time, and
// dq through the slice's keys
template <typename E, int D, int W>
__device__ void bwd_q_wide(const Args<E>& a, int blk, unsigned char* smem) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  constexpr int kC = W / D;
  unsigned char* at = smem;
  const Tile sQU = carve<D, kSplit>(at, kBq), sQV = carve<D, kSplit>(at, kBq + 1);
  const Tile sG = carve<D, kSplit>(at, kBq);
  const Tile sK = carve<D, kSplit>(at, kBk), sV = carve<D, kSplit>(at, kBk);
  const Tile sPL = carve<D, kSplit>(at, kBand), sPR = carve<D, kSplit>(at, kBand);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* buf = reinterpret_cast<float*>(at + warp * kScratch);
  at += kWarps * kScratch;
  const Tile sKS = carve<D, kSplit>(at, kBk);       // the slice's keys

  const int T = a.seq, n_t = (T + kBq - 1) / kBq;
  const int n = blk / n_t, q0 = (blk % n_t) * kBq, h = n % a.heads, b = n / a.heads;
  const int qw = q0 + kRows * warp;
  const int c0 = blockIdx.y * D;
  const size_t base = static_cast<size_t>(n) * T * W;
  const E* pos = a.pos + static_cast<size_t>(h) * T * W;
  const float *ub = a.ub + h * W, *vb = a.vb + h * W;

  const Rows rw = row_info(a, n, qw, lane, true);
  float dqu[D / 8][4];
  zero<D>(dqu);

  for (int k0 = 0; k0 < T; k0 += kBk) {
    float s[kNt][4], dp[kNt][4];
    for (int c = 0; c < kC; ++c) {    // S and dP, a chunk of columns at a time
      const int cc = c * D;
      __syncthreads();
      copy_rows<E, D>(sG, a.g + base + cc, T, q0, kBq, W);
      load_q<E, D>(sQU, sQV, a.q + base + cc, T, q0, ub + cc, vb + cc, W);
      if (c == 0) copy_rows<E, D>(sKS, a.k + base + c0, T, k0, kBk, W);
      copy_rows<E, D>(sK, a.k + base + cc, T, k0, kBk, W);
      copy_rows<E, D>(sV, a.v + base + cc, T, k0, kBk, W);
      if (k0 <= q0 + kBq - 1) copy_rows<E, D>(sPL, pos + cc, T, band_left(T, q0, k0), kBand, W);
      if (k0 + kBk - 1 >= q0 + 2) copy_rows<E, D>(sPR, pos + cc, T, band_right(q0, k0), kBand, W);
      sync_loads();
      if (qw >= T) continue;
      if (c == 0) {
        zero_tile(s);
        zero_tile(dp);
      }
      const Warp w = block_warp(sQU, sQV, sK, sPL, sPR, q0, k0, warp);
      raw_scores<D, kSplit>(s, w, buf, lane);
      dot_tile<D, kSplit>(dp, sG, w.q_r, sV, 0, lane);
    }
    if (qw >= T) continue;

    const Warp w = block_warp(sQU, sQV, sK, sPL, sPR, q0, k0, warp);
    grads(s, dp, key_info(a, b, k0, lane), rw, a);
    if (c0 == 0) {
      const size_t at_n = static_cast<size_t>(n) * T * ds_width(T);
      store_tile(a.ds + at_n, T, s, w, buf, lane);
      store_tile(a.pd + at_n, T, dp, w, buf, lane);
    }
    // dq through Q+u: dS . K
#pragma unroll
    for (int ks = 0; ks < kBk / 16; ++ks) {
      FragA<kSplit> fs;
      frag_of(fs, s, ks);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        FragB<kSplit> fk;
        load_bt(fk, sKS, 16 * ks, 16 * np, lane);
        mma(dqu[2 * np], fs, fk, 0);
        mma(dqu[2 * np + 1], fs, fk, 1);
      }
    }
  }
  store_rows<D>(a.dqu + base + c0, dqu, T, qw, lane, T, W);
}

// ---- the shift's backward: products over the stored dS -------------------- //
//
// A pos row p gathers the left entries dS[q, q+p-(T-1)] and the right ones
// dS[q, q+p+2]: read by diagonal, the shift's backward is two plain
// products. With L[q][p] and R[q][p] those entries (0 where the key is
// outside [0, T)): dqv = L.pos, dqvn = R.pos (what row q sends to row q+1),
// dpos = L^T.(Q+v) + R^T.(Q[q+1]+v). They are two of the second launch's
// three roles of 64 rows each: query rows (dqv, dqvn) and pos rows (dpos of
// each n); the third is the keys' (dk, dv).

// L (or R) of rows [q0, q0+64) and pos rows [p0, p0+64) into a [64, 64]
// tile: row q's 64 keys start at kb = q+p0-(T-1) (or q+p0+2), so its
// window goes by cp.async in 16-byte pieces from kb rounded down to 8 into
// the raw tile, and a pass through shared memory shifts each row by its
// 0-7 elements, zeroing keys outside [0, T), pos rows past T and rows past
// T. Starts with every thread past a barrier; ends the same.
__device__ __forceinline__ int floor8(int x) { return x >= 0 ? x / 8 * 8 : -((7 - x) / 8) * 8; }

template <typename E, int D>
__device__ void load_side(const Tile& t, E* raw, const E* ds, int T, int q0, int p0,
                          bool right) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  constexpr int kElems = 16 / sizeof(E), kPieces = (kBk + 8) / kElems;
  constexpr int kRaw = kBk + 8;                 // raw row: 72 keys
  const int W = ds_width(T);
  for (int u = threadIdx.x; u < kBq * kPieces; u += kThreads) {
    const int r = u / kPieces, q = q0 + r;
    const int k = floor8(q + p0 + (right ? 2 : 1 - T)) + (u % kPieces) * kElems;
    const bool ok = q < T && k >= 0 && k < W;
    cp_async16(raw + r * kRaw + (u % kPieces) * kElems,
               ds + (ok ? static_cast<size_t>(q) * W + k : 0), ok);
  }
  cp_async_wait();
  __syncthreads();
  for (int u = threadIdx.x; u < kBq * kBk / 8; u += kThreads) {
    const int r = u / (kBk / 8), c0 = (u % (kBk / 8)) * 8, q = q0 + r;
    const int kb = q + p0 + (right ? 2 : 1 - T), off = kb - floor8(kb);
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e, k = kb + c;
      const bool ok = q < T && k >= 0 && k < T && p0 + c < T;
      const E v = raw[r * kRaw + off + c];
      x[e] = ok ? to_f32(v) : 0.f;
    }
    store8<kSplit>(t.at(r, c0), t.plane, x);
  }
  __syncthreads();
}

template <int D, bool kSplit>
__host__ __device__ constexpr size_t gs_smem() {
  return tile_bytes<D, kSplit>(3 * kBq + 1) +
         2 * static_cast<size_t>(kBq) * kTileS * 2 * (kSplit ? 2 : 1) +
         static_cast<size_t>(kBq) * (kBk + 8) * (kSplit ? 4 : 2);
}

// query role: dqv and dqvn of 64 query rows, walking the pos tiles (the
// columns [c0, c0 + D) of rows W wide)
template <typename E, int D, int W>
__device__ void gs_q(const Args<E>& a, int blk, unsigned char* smem) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  unsigned char* at = smem;
  const Tile sP = carve<D, kSplit>(at, kBk);
  const Tile sL = carve_wide<kSplit>(at, kBq, kTileS), sR = carve_wide<kSplit>(at, kBq, kTileS);
  E* raw = reinterpret_cast<E*>(at);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = a.seq, n_t = (T + kBq - 1) / kBq;
  const int n = blk / n_t, q0 = (blk % n_t) * kBq, h = n % a.heads;
  const int c0 = W == D ? 0 : blockIdx.y * D;       // the output slice
  const E* ds = a.ds + static_cast<size_t>(n) * T * ds_width(T);
  float dqv[D / 8][4], dqn[D / 8][4];
  zero<D>(dqv);
  zero<D>(dqn);
  for (int p0 = 0; p0 < T; p0 += kBk) {
    // any key in [0, T): left q+p-(T-1) >= 0, right q+p+2 <= T-1
    const bool on[2] = {p0 + kBk - 1 >= T - 1 - (q0 + kBq - 1), p0 <= T - 3 - q0};
    if (!on[0] && !on[1]) continue;
    __syncthreads();
    copy_rows<E, D>(sP, a.pos + static_cast<size_t>(h) * T * W + c0, T, p0, kBk, W);
    if (on[0]) load_side<E, D>(sL, raw, ds, T, q0, p0, false);
    if (on[1]) load_side<E, D>(sR, raw, ds, T, q0, p0, true);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (!on[side]) continue;
      float (&acc)[D / 8][4] = side == 0 ? dqv : dqn;
#pragma unroll
      for (int ks = 0; ks < kBk / 16; ++ks) {
        FragA<kSplit> fs;
        load_a(fs, side == 0 ? sL : sR, kRows * warp, 16 * ks, lane);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          FragB<kSplit> fp;
          load_bt(fp, sP, 16 * ks, 16 * np, lane);
          mma(acc[2 * np], fs, fp, 0);
          mma(acc[2 * np + 1], fs, fp, 1);
        }
      }
    }
  }
  const size_t base = static_cast<size_t>(n) * T * W + c0;
  store_rows<D>(a.dqv + base, dqv, T, q0 + kRows * warp, lane, T, W);
  store_rows<D>(a.dqvn + base, dqn, T, q0 + kRows * warp, lane, T, W);
}

// pos role: dpos of 64 pos rows (of one n), walking the query tiles
template <typename E, int D, int W>
__device__ void gs_pos(const Args<E>& a, int blk, unsigned char* smem) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  unsigned char* at = smem;
  const Tile sQU = carve<D, kSplit>(at, kBq), sQV = carve<D, kSplit>(at, kBq + 1);
  const Tile sL = carve_wide<kSplit>(at, kBq, kTileS), sR = carve_wide<kSplit>(at, kBq, kTileS);
  E* raw = reinterpret_cast<E*>(at);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = a.seq, n_t = (T + kBq - 1) / kBq;
  const int n = blk / n_t, p0 = (blk % n_t) * kBq, h = n % a.heads;
  const int c0 = W == D ? 0 : blockIdx.y * D;       // the output slice
  const size_t base = static_cast<size_t>(n) * T * W + c0;
  const E* ds = a.ds + static_cast<size_t>(n) * T * ds_width(T);
  float dpos[D / 8][4];
  zero<D>(dpos);
  for (int q0 = 0; q0 < T; q0 += kBq) {
    const bool on[2] = {p0 + kBk - 1 >= T - 1 - (q0 + kBq - 1), p0 <= T - 3 - q0};
    if (!on[0] && !on[1]) continue;
    __syncthreads();
    load_q<E, D>(sQU, sQV, a.q + base, T, q0, a.ub + h * W + c0, a.vb + h * W + c0, W);
    if (on[0]) load_side<E, D>(sL, raw, ds, T, q0, p0, false);
    if (on[1]) load_side<E, D>(sR, raw, ds, T, q0, p0, true);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (!on[side]) continue;
      // dS^T . (Q+v), the rows shifted by one on the right
#pragma unroll
      for (int ks = 0; ks < kBq / 16; ++ks) {
        FragA<kSplit> fs;
        load_at(fs, side == 0 ? sL : sR, kRows * warp, 16 * ks, lane);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          FragB<kSplit> fq;
          load_bt(fq, sQV, 16 * ks + side, 16 * np, lane);
          mma(dpos[2 * np], fs, fq, 0);
          mma(dpos[2 * np + 1], fs, fq, 1);
        }
      }
    }
  }
  store_rows<D>(a.dpos + base, dpos, T, p0 + kRows * warp, lane, T, W);
}

// kv role: dk and dv of 64 keys, walking the query tiles: dk = dS^T.(Q+u)
// and dv = P^T.dO over the stored tiles, each warp 16 keys
template <typename E, int D, int W>
__device__ void gs_kv(const Args<E>& a, int blk, unsigned char* smem) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  unsigned char* at = smem;
  const Tile sQU = carve<D, kSplit>(at, kBq), sQV = carve<D, kSplit>(at, kBq + 1);
  const Tile sG = carve<D, kSplit>(at, kBq);
  const Tile sDS = carve_wide<kSplit>(at, kBq, kTileS), sP = carve_wide<kSplit>(at, kBq, kTileS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = a.seq, Wd = ds_width(T), n_t = (T + kBk - 1) / kBk;
  const int n = blk / n_t, k0 = (blk % n_t) * kBk, h = n % a.heads;
  const int c0 = W == D ? 0 : blockIdx.y * D;       // the output slice
  const size_t base = static_cast<size_t>(n) * T * W + c0, at_n = static_cast<size_t>(n) * T * Wd;
  float dk[D / 8][4], dv[D / 8][4];
  zero<D>(dk);
  zero<D>(dv);
  for (int q0 = 0; q0 < T; q0 += kBq) {
    __syncthreads();
    copy_rows<E, D>(sG, a.g + base, T, q0, kBq, W);
    copy_block<E>(sDS, a.ds + at_n, T, Wd, q0, k0);
    copy_block<E>(sP, a.pd + at_n, T, Wd, q0, k0);
    load_q<E, D>(sQU, sQV, a.q + base, T, q0, a.ub + h * W + c0, a.vb + h * W + c0, W);
    sync_loads();
#pragma unroll
    for (int ks = 0; ks < kBq / 16; ++ks) {
      FragA<kSplit> fs, fp;
      load_at(fs, sDS, kRows * warp, 16 * ks, lane);
      load_at(fp, sP, kRows * warp, 16 * ks, lane);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        FragB<kSplit> fq, fg;
        load_bt(fq, sQU, 16 * ks, 16 * np, lane);
        load_bt(fg, sG, 16 * ks, 16 * np, lane);
        mma(dk[2 * np], fs, fq, 0);
        mma(dk[2 * np + 1], fs, fq, 1);
        mma(dv[2 * np], fp, fg, 0);
        mma(dv[2 * np + 1], fp, fg, 1);
      }
    }
  }
  store_rows<D>(a.dk + base, dk, T, k0 + kRows * warp, lane, T, W);
  store_rows<D>(a.dv + base, dv, T, k0 + kRows * warp, lane, T, W);
}

template <typename E, int D, int W>
__global__ void __launch_bounds__(kThreads) relpos_bwd_shift(Args<E> a, int n_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = blockIdx.x;
  if (blk < n_q) gs_kv<E, D, W>(a, blk, smem);
  else if (blk < 2 * n_q) gs_q<E, D, W>(a, blk - n_q, smem);
  else gs_pos<E, D, W>(a, blk - 2 * n_q, smem);
}

// bf16 at D <= 32 fits three blocks an SM in shared memory, and the
// registers are capped at the 168 that allows (a few spills): an earlier
// form of this backward ran faster so on the H100 than with the 207
// registers ptxas took unbounded, at two blocks an SM
template <typename E, int D>
struct BwdBlocks {
  static constexpr int value = !std::is_same<E, float>::value && D <= 32 ? 3 : 1;
};

template <typename E, int D, int W>
__global__ void __launch_bounds__(kThreads, BwdBlocks<E, D>::value) relpos_bwd(Args<E> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (W == D) bwd_q<E, D>(a, blockIdx.x, smem);
  else bwd_q_wide<E, D, W>(a, blockIdx.x, smem);
}

// the kernels of a head W wide on tiles D wide: W itself up to 64, else
// W / 64 chunks and output slices of 64
template <typename E, int W, int D = (W < 64 ? W : 64)>
cudaError_t launch_bwd(const Args<E>& a, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  const int smem = static_cast<int>(bwd_smem<D, W, kSplit>());
  const int smem_shift = static_cast<int>(gs_smem<D, kSplit>());
  cudaError_t e = cudaFuncSetAttribute(
      relpos_bwd<E, D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(relpos_bwd_shift<E, D, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_shift);
  if (e != cudaSuccess) return e;
  const int n_q = a.n * ((a.seq + kBq - 1) / kBq);
  relpos_bwd<E, D, W><<<dim3(n_q, W / D), kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  relpos_bwd_shift<E, D, W><<<dim3(3 * n_q, W / D), kThreads, smem_shift, stream>>>(a, n_q);
  return cudaGetLastError();
}

template <typename E, int W, int D = (W < 64 ? W : 64)>
cudaError_t launch_fwd(const Args<E>& a, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<E, float>::value;
  const int smem = static_cast<int>(fwd_smem<D, kSplit>());
  cudaError_t e = cudaFuncSetAttribute(
      relpos_fwd<E, D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + kBq - 1) / kBq, a.n, W / D);
  relpos_fwd<E, D, W><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
Args<E> make_args(const void* q, const void* k, const void* v,
                  const void* pos, const float* ub, const float* vb,
                  const long long* seed, const int* kmask, int n, int heads,
                  int head_off, int head_total, int seq, float scale,
                  unsigned thresh, float inv_keep) {
  Args<E> a{};
  a.q = static_cast<const E*>(q);
  a.k = static_cast<const E*>(k);
  a.v = static_cast<const E*>(v);
  a.pos = static_cast<const E*>(pos);
  a.ub = ub;
  a.vb = vb;
  a.seed = seed;
  a.kmask = kmask;
  a.n = n;
  a.heads = heads;
  a.head_off = head_off;
  a.head_total = head_total;
  a.seq = seq;
  a.scale = scale;
  a.thresh = thresh;
  a.inv_keep = inv_keep;
  return a;
}

bool bad_shape(int n, int heads, int head_off, int head_total, int seq) {
  return n <= 0 || heads <= 0 || seq <= 0 || n % heads != 0 ||
         head_off < 0 || head_off + heads > head_total ||
         static_cast<long long>(n) * seq >= (1LL << 31);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d = 16, 32, 64, 128 or 256. Returns a
// cudaError_t (0 = launched), cudaErrorInvalidValue for what the kernel
// does not take.
extern "C" int ctts_relpos_fwd(const void* q, const void* k, const void* v,
                               const void* pos, const float* ub,
                               const float* vb, const long long* seed,
                               const int* kmask, void* o, float* m, float* l,
                               int n, int heads, int head_off,
                               int head_total, int seq, int d, float scale,
                               unsigned thresh, float inv_keep, int dtype,
                               void* stream) {
  if (bad_shape(n, heads, head_off, head_total, seq) || n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTTS_RELPOS_FWD(E, D)                                                \
  {                                                                          \
    Args<E> a = make_args<E>(q, k, v, pos, ub, vb, seed, kmask, n, heads,    \
                             head_off, head_total, seq, scale, thresh,       \
                             inv_keep);                                      \
    a.o = static_cast<E*>(o);                                                \
    a.m_out = m;                                                             \
    a.l_out = l;                                                             \
    return launch_fwd<E, D>(a, s);                                           \
  }
  if (dtype == 0 && d == 16) CTTS_RELPOS_FWD(float, 16)
  if (dtype == 0 && d == 32) CTTS_RELPOS_FWD(float, 32)
  if (dtype == 0 && d == 64) CTTS_RELPOS_FWD(float, 64)
  if (dtype == 0 && d == 128) CTTS_RELPOS_FWD(float, 128)
  if (dtype == 0 && d == 256) CTTS_RELPOS_FWD(float, 256)
  if (dtype == 1 && d == 16) CTTS_RELPOS_FWD(__nv_bfloat16, 16)
  if (dtype == 1 && d == 32) CTTS_RELPOS_FWD(__nv_bfloat16, 32)
  if (dtype == 1 && d == 64) CTTS_RELPOS_FWD(__nv_bfloat16, 64)
  if (dtype == 1 && d == 128) CTTS_RELPOS_FWD(__nv_bfloat16, 128)
  if (dtype == 1 && d == 256) CTTS_RELPOS_FWD(__nv_bfloat16, 256)
#undef CTTS_RELPOS_FWD
  return cudaErrorInvalidValue;
}

// The backward: g = dO; m, l the forward's row max and sum; delta =
// rowsum(dO*O) (float32 [N, T]). Writes float32 [N, T, D] partials: dqu
// (through Q+u), dqv (through Q+v, the row's own scores), dqvn (through
// Q[q+1]+v, what row q sends to row q+1), dk, dv, and dpos per n (the
// caller sums it over the batch). ds and pd are scratch of N*T*ceil8(T)
// elements of the input dtype each (dS and the dropped P between the
// launches). Two launches, in stream order.
extern "C" int ctts_relpos_bwd(const void* q, const void* k, const void* v,
                               const void* pos, const float* ub,
                               const float* vb, const long long* seed,
                               const int* kmask, const void* g,
                               const float* m, const float* l,
                               const float* delta, float* dqu, float* dqv,
                               float* dqvn, float* dk, float* dv, float* dpos,
                               void* ds, void* pd, int n, int heads,
                               int head_off, int head_total, int seq, int d,
                               float scale,
                               unsigned thresh, float inv_keep, int dtype,
                               void* stream) {
  if (bad_shape(n, heads, head_off, head_total, seq)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTTS_RELPOS_BWD(E, D)                                                \
  {                                                                          \
    Args<E> a = make_args<E>(q, k, v, pos, ub, vb, seed, kmask, n, heads,    \
                             head_off, head_total, seq, scale, thresh,       \
                             inv_keep);                                      \
    a.g = static_cast<const E*>(g);                                          \
    a.m = m;                                                                 \
    a.l = l;                                                                 \
    a.delta = delta;                                                         \
    a.dqu = dqu;                                                             \
    a.dqv = dqv;                                                             \
    a.dqvn = dqvn;                                                           \
    a.ds = static_cast<E*>(ds);                                              \
    a.pd = static_cast<E*>(pd);                                              \
    a.dk = dk;                                                               \
    a.dv = dv;                                                               \
    a.dpos = dpos;                                                           \
    return launch_bwd<E, D>(a, s);                                           \
  }
  if (dtype == 0 && d == 16) CTTS_RELPOS_BWD(float, 16)
  if (dtype == 0 && d == 32) CTTS_RELPOS_BWD(float, 32)
  if (dtype == 0 && d == 64) CTTS_RELPOS_BWD(float, 64)
  if (dtype == 0 && d == 128) CTTS_RELPOS_BWD(float, 128)
  if (dtype == 0 && d == 256) CTTS_RELPOS_BWD(float, 256)
  if (dtype == 1 && d == 16) CTTS_RELPOS_BWD(__nv_bfloat16, 16)
  if (dtype == 1 && d == 32) CTTS_RELPOS_BWD(__nv_bfloat16, 32)
  if (dtype == 1 && d == 64) CTTS_RELPOS_BWD(__nv_bfloat16, 64)
  if (dtype == 1 && d == 128) CTTS_RELPOS_BWD(__nv_bfloat16, 128)
  if (dtype == 1 && d == 256) CTTS_RELPOS_BWD(__nv_bfloat16, 256)
#undef CTTS_RELPOS_BWD
  return cudaErrorInvalidValue;
}
