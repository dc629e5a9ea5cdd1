// Transformer-XL relative-position attention, forward and backward, for
// Hopper (sm_90a).
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
// exactly -1e9. Dropout keeps (q,k) when hash(seed, n, q, k) >= thresh; the
// hash is the one ctts_torch/ops/relpos_attention.py:dropout_keep computes,
// and the backward regenerates the same bits from the same seed words.
//
// What bounds it on the H100: about 6*N*T^2*D flop forward and 16*N*T^2*D
// backward over O(N*T*D) bytes, so far above the ridge point: the work is
// bound by operations. This first version computes in f32 on the CUDA
// cores (a tensor-core version is later work), so its own f32 issue rate
// bounds it.
//
// Design. The TPU kernel held K, V and pos whole in VMEM and undid the
// shift with row flips and strided rolls; here the shift is index
// arithmetic. Forward: one block per (16 query rows, n); key tiles of 32
// (one key per lane) stream through shared memory with an online softmax,
// so no [T, T] matrix reaches device memory. For a 16x32 tile the pos rows
// the shift needs form a band of 47 rows left of the diagonal and 47 right
// of it; both bands sit in shared memory with an odd row stride, so the
// lanes (one pos row each) read without bank conflicts. The forward also
// writes each row's softmax max and sum. Backward: one launch whose blocks
// take one of three roles, each recomputing the scores, P = exp(S-m)/l and
// dS = P*(dP - rowsum(dO*O)) element by element:
//   Q role   (query-stationary): dq through (Q+u) and through (Q+v), the
//            second split into the row's own part and the part it sends to
//            row q+1 (the legacy wrap); the caller adds the two;
//   KV role  (key-stationary): dk and dv;
//   pos role (diagonal-stationary, one pos row per lane): dpos of each n,
//            which the caller sums over the batch.
// Every sum is taken in one thread in a fixed order, or across warps in a
// fixed order: no float atomics, so the result is the same from run to run.
// The backward's shared memory (~50 KB at D=32, set by the pos role) allows
// 4 blocks per SM; it is capped at the 128 registers that occupancy needs
// (a few spills). Left to itself ptxas took 214 and ran 2 blocks per SM,
// which was slower on the H100 (PERF.md gives both times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRpw = 4;                 // query rows (or keys) per warp
constexpr int kBq = kWarps * kRpw;      // 16 rows (or keys) per block
constexpr int kTile = 32;               // one key (or query) per lane
constexpr int kBand = kBq + kTile - 1;  // pos rows a 16x32 tile reads
constexpr int kBand2 = 2 * kTile - 1;   // K/V rows a 32x32 diagonal tile reads
constexpr float kNeg = -1e9f;
constexpr uint32_t kSalt = 0x5bd1e995u;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);
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

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x4a6ca68bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t row_key(const long long* seed, int n,
                                            int q) {
  const uint32_t s0 = static_cast<uint32_t>(seed[0] & 0xffffffffLL);
  const uint32_t s1 = static_cast<uint32_t>(seed[1] & 0xffffffffLL);
  return mix(mix(mix(static_cast<uint32_t>(q) ^ mix(static_cast<uint32_t>(n))) ^ s1) ^ s0);
}
__device__ __forceinline__ bool keep_bit(uint32_t rk, int k, uint32_t thresh) {
  return mix(rk ^ mix(static_cast<uint32_t>(k) ^ kSalt)) >= thresh;
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
  int n, heads, seq;
  float scale;
  uint32_t thresh;             // 0: no dropout
  float inv_keep;              // 1/(1-p)
};

__device__ __forceinline__ bool key_ok(const int* kmask, int b, int seq, int j) {
  return kmask == nullptr || kmask[static_cast<size_t>(b) * seq + j] != 0;
}

// ---- forward ------------------------------------------------------------ //

template <int D>
constexpr int fwd_smem_floats() {
  return kBq * D + (kBq + 1) * (D + 1) + D * (kTile + 1) + kTile * D +
         2 * kBand * (D + 1);
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads) relpos_fwd(Args<E> a) {
  extern __shared__ __align__(16) float smem[];
  float* sQU = smem;                          // [kBq][D]      q + u
  float* sQV = sQU + kBq * D;                 // [kBq+1][D+1]  q + v, one row more
  float* sKt = sQV + (kBq + 1) * (D + 1);     // [D][kTile+1]  K tile, transposed
  float* sV = sKt + D * (kTile + 1);          // [kTile][D]
  float* sPl = sV + kTile * D;                // [kBand][D+1]  pos rows, k <= q
  float* sPr = sPl + kBand * (D + 1);         // [kBand][D+1]  pos rows, k > q+1
  constexpr int kCols = D >= 32 ? D / 32 : 1;

  const int S = a.seq;
  const int n = blockIdx.y, h = n % a.heads, b = n / a.heads;
  const int q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = D >= 32 ? lane : lane % D;
  const size_t base = static_cast<size_t>(n) * S * D;
  const size_t pbase = static_cast<size_t>(h) * S * D;
  const bool drop = a.thresh > 0;

  for (int i = threadIdx.x; i < (kBq + 1) * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    const float x = t < S ? ld(a.q, base + static_cast<size_t>(t) * D + c) : 0.f;
    if (r < kBq) sQU[r * D + c] = t < S ? x + a.ub[h * D + c] : 0.f;
    sQV[r * (D + 1) + c] = t < S ? x + a.vb[h * D + c] : 0.f;
  }

  float m[kRpw], l[kRpw], acc[kRpw][kCols];
  uint32_t rk[kRpw];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    rk[r] = drop ? row_key(a.seed, n, q0 + warp * kRpw + r) : 0u;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();                  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i % D, j = k0 + r;
      const size_t off = base + static_cast<size_t>(j) * D + c;
      sKt[c * (kTile + 1) + r] = j < S ? ld(a.k, off) : 0.f;
      sV[r * D + c] = j < S ? ld(a.v, off) : 0.f;
    }
    // band row i holds pos row lo + i; for row rr of the block and lane j
    // both branches of the shift read band row lane + kBq-1-rr
    const int lo_l = S - 1 - (q0 + kBq - 1) + k0;
    const int lo_r = k0 - (q0 + kBq - 1) - 2;
    for (int i = threadIdx.x; i < kBand * D; i += kThreads) {
      const int r = i / D, c = i % D, pl = lo_l + r, pr = lo_r + r;
      sPl[r * (D + 1) + c] = pl >= 0 && pl < S ? ld(a.pos, pbase + static_cast<size_t>(pl) * D + c) : 0.f;
      sPr[r * (D + 1) + c] = pr >= 0 && pr < S ? ld(a.pos, pbase + static_cast<size_t>(pr) * D + c) : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;
    const bool valid = j < S;
    const bool kval = valid && key_ok(a.kmask, b, S, j);
    float p[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      const int rr = warp * kRpw + r, qg = q0 + rr;
      float cs = 0.f, rs = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) cs = fmaf(sQU[rr * D + c], sKt[c * (kTile + 1) + lane], cs);
      const bool left = j <= qg;
      const float* qs = sQV + (left ? rr : rr + 1) * (D + 1);
      const float* ps = (left ? sPl : sPr) + (lane + kBq - 1 - rr) * (D + 1);
#pragma unroll
      for (int c = 0; c < D; ++c) rs = fmaf(qs[c], ps[c], rs);
      if (j == qg + 1) rs = 0.f;
      float s = kval ? (cs + rs) * a.scale : kNeg;
      if (!valid) s = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);   // 0 on the first tile
      const float pe = expf(s - m_new);
      l[r] = l[r] * alpha + warp_sum(pe);
      m[r] = m_new;
      p[r] = drop ? (keep_bit(rk[r], j, a.thresh) ? pe * a.inv_keep : 0.f) : pe;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }

#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = sV[jj * D + col0 + 32 * c];
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
    if (t >= S) continue;
    const float inv = 1.f / l[r];
    if (lane < D) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        a.o[base + static_cast<size_t>(t) * D + col0 + 32 * c] = from_f32<E>(acc[r][c] * inv);
    }
    if (lane == 0) {
      a.m_out[static_cast<size_t>(n) * S + t] = m[r];
      a.l_out[static_cast<size_t>(n) * S + t] = l[r];
    }
  }
}

// ---- backward ------------------------------------------------------------ //

template <int D>
constexpr int q_smem_floats() {
  return 2 * kBq * D + (kBq + 1) * (D + 1) + 2 * D * (kTile + 1) +
         2 * kBand * (D + 1);
}
template <int D>
constexpr int kv_smem_floats() {
  return 2 * kBq * D + 2 * D * (kTile + 1) + (kTile + 1) * (D + 1) +
         2 * kBand * (D + 1) + 4 * kTile;
}
template <int D>
constexpr int pos_smem_floats() {
  return kTile * (D + 1) + 2 * kTile * D + (kTile + 1) * D +
         4 * kBand2 * (D + 1) + 4 * kTile;
}
template <int D>
constexpr int bwd_smem_floats() {
  return q_smem_floats<D>() > kv_smem_floats<D>()
             ? (q_smem_floats<D>() > pos_smem_floats<D>() ? q_smem_floats<D>() : pos_smem_floats<D>())
             : (kv_smem_floats<D>() > pos_smem_floats<D>() ? kv_smem_floats<D>() : pos_smem_floats<D>());
}

// dS*scale of one score, from its recomputed logit: 0 at a masked key (the
// -1e9 fill is a constant) and wherever the row or key is out of range.
// pd is the dropped probability that multiplies dO into dV.
__device__ __forceinline__ float dscore(float s_raw, bool live, bool kval,
                                        float m, float l, float delta,
                                        float dpt, bool keep, bool drop,
                                        const float scale, float inv_keep,
                                        float* pd) {
  const float s = kval ? s_raw * scale : kNeg;
  const float p = live ? expf(s - m) / l : 0.f;
  const float kf = drop ? (keep ? inv_keep : 0.f) : 1.f;
  *pd = p * kf;
  return live && kval ? p * (dpt * kf - delta) * scale : 0.f;
}

// Q role: one block per (16 query rows, n); lanes walk the keys.
template <typename E, int D>
__device__ void bwd_q(const Args<E>& a, int blk, float* smem) {
  float* sQU = smem;                          // [kBq][D]
  float* sG = sQU + kBq * D;                  // [kBq][D]      dO
  float* sQV = sG + kBq * D;                  // [kBq+1][D+1]
  float* sKt = sQV + (kBq + 1) * (D + 1);     // [D][kTile+1]
  float* sVt = sKt + D * (kTile + 1);         // [D][kTile+1]
  float* sPl = sVt + D * (kTile + 1);         // [kBand][D+1]
  float* sPr = sPl + kBand * (D + 1);         // [kBand][D+1]
  constexpr int kCols = D >= 32 ? D / 32 : 1;
  const int S = a.seq, n_tiles = (S + kBq - 1) / kBq;
  const int n = blk / n_tiles, q0 = (blk % n_tiles) * kBq;
  const int h = n % a.heads, b = n / a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = D >= 32 ? lane : lane % D;
  const size_t base = static_cast<size_t>(n) * S * D;
  const size_t pbase = static_cast<size_t>(h) * S * D;
  const bool drop = a.thresh > 0;

  for (int i = threadIdx.x; i < (kBq + 1) * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    const size_t off = base + static_cast<size_t>(t) * D + c;
    const float x = t < S ? ld(a.q, off) : 0.f;
    if (r < kBq) {
      sQU[r * D + c] = t < S ? x + a.ub[h * D + c] : 0.f;
      sG[r * D + c] = t < S ? ld(a.g, off) : 0.f;
    }
    sQV[r * (D + 1) + c] = t < S ? x + a.vb[h * D + c] : 0.f;
  }
  float rm[kRpw], rl[kRpw], rd[kRpw];
  uint32_t rk[kRpw];
  float accU[kRpw][kCols], accV[kRpw][kCols], accN[kRpw][kCols];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int t = q0 + warp * kRpw + r;
    const size_t row = static_cast<size_t>(n) * S + t;
    rm[r] = t < S ? a.m[row] : 0.f;
    rl[r] = t < S ? a.l[row] : 1.f;
    rd[r] = t < S ? a.delta[row] : 0.f;
    rk[r] = drop ? row_key(a.seed, n, t) : 0u;
#pragma unroll
    for (int c = 0; c < kCols; ++c) accU[r][c] = accV[r][c] = accN[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i % D, j = k0 + r;
      const size_t off = base + static_cast<size_t>(j) * D + c;
      sKt[c * (kTile + 1) + r] = j < S ? ld(a.k, off) : 0.f;
      sVt[c * (kTile + 1) + r] = j < S ? ld(a.v, off) : 0.f;
    }
    const int lo_l = S - 1 - (q0 + kBq - 1) + k0;
    const int lo_r = k0 - (q0 + kBq - 1) - 2;
    for (int i = threadIdx.x; i < kBand * D; i += kThreads) {
      const int r = i / D, c = i % D, pl = lo_l + r, pr = lo_r + r;
      sPl[r * (D + 1) + c] = pl >= 0 && pl < S ? ld(a.pos, pbase + static_cast<size_t>(pl) * D + c) : 0.f;
      sPr[r * (D + 1) + c] = pr >= 0 && pr < S ? ld(a.pos, pbase + static_cast<size_t>(pr) * D + c) : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;
    const bool kval = j < S && key_ok(a.kmask, b, S, j);
    float dsc[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      const int rr = warp * kRpw + r, qg = q0 + rr;
      float cs = 0.f, rs = 0.f, dpt = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        cs = fmaf(sQU[rr * D + c], sKt[c * (kTile + 1) + lane], cs);
        dpt = fmaf(sG[rr * D + c], sVt[c * (kTile + 1) + lane], dpt);
      }
      const bool left = j <= qg;
      const float* qs = sQV + (left ? rr : rr + 1) * (D + 1);
      const float* ps = (left ? sPl : sPr) + (lane + kBq - 1 - rr) * (D + 1);
#pragma unroll
      for (int c = 0; c < D; ++c) rs = fmaf(qs[c], ps[c], rs);
      if (j == qg + 1) rs = 0.f;
      const bool keep = drop && keep_bit(rk[r], j, a.thresh);
      float pd;
      dsc[r] = dscore(cs + rs, j < S && qg < S, kval, rm[r], rl[r], rd[r],
                      dpt, keep, drop, a.scale, a.inv_keep, &pd);
    }
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      const int jg = k0 + jj;
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const int rr = warp * kRpw + r, qg = q0 + rr;
        const float d = __shfl_sync(0xffffffffu, dsc[r], jj);
        const int band = (jj + kBq - 1 - rr) * (D + 1);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int cc = col0 + 32 * c;
          accU[r][c] = fmaf(d, sKt[cc * (kTile + 1) + jj], accU[r][c]);
          if (jg <= qg) accV[r][c] = fmaf(d, sPl[band + cc], accV[r][c]);
          else if (jg > qg + 1) accN[r][c] = fmaf(d, sPr[band + cc], accN[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int t = q0 + warp * kRpw + r;
    if (t >= S || lane >= D) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const size_t off = base + static_cast<size_t>(t) * D + col0 + 32 * c;
      a.dqu[off] = accU[r][c];
      a.dqv[off] = accV[r][c];
      a.dqvn[off] = accN[r][c];
    }
  }
}

// KV role: one block per (16 keys, n); lanes walk the queries.
template <typename E, int D>
__device__ void bwd_kv(const Args<E>& a, int blk, float* smem) {
  float* sK = smem;                           // [kBq][D]
  float* sVk = sK + kBq * D;                  // [kBq][D]
  float* sQUt = sVk + kBq * D;                // [D][kTile+1]
  float* sGt = sQUt + D * (kTile + 1);        // [D][kTile+1]
  float* sQV = sGt + D * (kTile + 1);         // [kTile+1][D+1]
  float* sPl = sQV + (kTile + 1) * (D + 1);   // [kBand][D+1]
  float* sPr = sPl + kBand * (D + 1);         // [kBand][D+1]
  float* sM = sPr + kBand * (D + 1);          // [kTile] x 3
  float* sL = sM + kTile;
  float* sD = sL + kTile;
  uint32_t* sRk = reinterpret_cast<uint32_t*>(sD + kTile);
  constexpr int kCols = D >= 32 ? D / 32 : 1;
  const int S = a.seq, n_tiles = (S + kBq - 1) / kBq;
  const int n = blk / n_tiles, k0 = (blk % n_tiles) * kBq;
  const int h = n % a.heads, b = n / a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = D >= 32 ? lane : lane % D;
  const size_t base = static_cast<size_t>(n) * S * D;
  const size_t pbase = static_cast<size_t>(h) * S * D;
  const bool drop = a.thresh > 0;

  for (int i = threadIdx.x; i < kBq * D; i += kThreads) {
    const int r = i / D, c = i % D, j = k0 + r;
    const size_t off = base + static_cast<size_t>(j) * D + c;
    sK[i] = j < S ? ld(a.k, off) : 0.f;
    sVk[i] = j < S ? ld(a.v, off) : 0.f;
  }
  bool kval[kRpw];
  float accK[kRpw][kCols], accV[kRpw][kCols];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int kg = k0 + warp * kRpw + r;
    kval[r] = kg < S && key_ok(a.kmask, b, S, kg);
#pragma unroll
    for (int c = 0; c < kCols; ++c) accK[r][c] = accV[r][c] = 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < (kTile + 1) * D; i += kThreads) {
      const int r = i / D, c = i % D, t = q0 + r;
      const size_t off = base + static_cast<size_t>(t) * D + c;
      const float x = t < S ? ld(a.q, off) : 0.f;
      if (r < kTile) {
        sQUt[c * (kTile + 1) + r] = t < S ? x + a.ub[h * D + c] : 0.f;
        sGt[c * (kTile + 1) + r] = t < S ? ld(a.g, off) : 0.f;
      }
      sQV[r * (D + 1) + c] = t < S ? x + a.vb[h * D + c] : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int t = q0 + threadIdx.x;
      const size_t row = static_cast<size_t>(n) * S + t;
      sM[threadIdx.x] = t < S ? a.m[row] : 0.f;
      sL[threadIdx.x] = t < S ? a.l[row] : 1.f;
      sD[threadIdx.x] = t < S ? a.delta[row] : 0.f;
      sRk[threadIdx.x] = drop ? row_key(a.seed, n, t) : 0u;
    }
    // for key row kr and lane (query q0+lane) both branches read band row
    // kr + kTile-1-lane
    const int lo_l = S - 1 - (q0 + kTile - 1) + k0;
    const int lo_r = k0 - (q0 + kTile - 1) - 2;
    for (int i = threadIdx.x; i < kBand * D; i += kThreads) {
      const int r = i / D, c = i % D, pl = lo_l + r, pr = lo_r + r;
      sPl[r * (D + 1) + c] = pl >= 0 && pl < S ? ld(a.pos, pbase + static_cast<size_t>(pl) * D + c) : 0.f;
      sPr[r * (D + 1) + c] = pr >= 0 && pr < S ? ld(a.pos, pbase + static_cast<size_t>(pr) * D + c) : 0.f;
    }
    __syncthreads();

    const int qg = q0 + lane;
    float dsc[kRpw], pd[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      const int kr = warp * kRpw + r, kg = k0 + kr;
      float cs = 0.f, rs = 0.f, dpt = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        cs = fmaf(sQUt[c * (kTile + 1) + lane], sK[kr * D + c], cs);
        dpt = fmaf(sGt[c * (kTile + 1) + lane], sVk[kr * D + c], dpt);
      }
      const bool left = kg <= qg;
      const float* qs = sQV + (left ? lane : lane + 1) * (D + 1);
      const float* ps = (left ? sPl : sPr) + (kr + kTile - 1 - lane) * (D + 1);
#pragma unroll
      for (int c = 0; c < D; ++c) rs = fmaf(qs[c], ps[c], rs);
      if (kg == qg + 1) rs = 0.f;
      const bool keep = drop && keep_bit(sRk[lane], kg, a.thresh);
      dsc[r] = dscore(cs + rs, kg < S && qg < S, kval[r], sM[lane], sL[lane],
                      sD[lane], dpt, keep, drop, a.scale, a.inv_keep, &pd[r]);
    }
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float qu[kCols], gg[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        qu[c] = sQUt[(col0 + 32 * c) * (kTile + 1) + qq];
        gg[c] = sGt[(col0 + 32 * c) * (kTile + 1) + qq];
      }
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const float d = __shfl_sync(0xffffffffu, dsc[r], qq);
        const float p = __shfl_sync(0xffffffffu, pd[r], qq);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          accK[r][c] = fmaf(d, qu[c], accK[r][c]);
          accV[r][c] = fmaf(p, gg[c], accV[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int kg = k0 + warp * kRpw + r;
    if (kg >= S || lane >= D) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const size_t off = base + static_cast<size_t>(kg) * D + col0 + 32 * c;
      a.dk[off] = accK[r][c];
      a.dv[off] = accV[r][c];
    }
  }
}

// pos role: one block per (32 pos rows, n), one row per lane; the warps
// split each chunk of 32 queries and their sums meet at the end in a
// fixed order. Row r gets, for every query q, the score at k = q-(T-1-r)
// (left of the diagonal, through Q[q]+v) and at k = q+r+2 (right of it,
// through Q[q+1]+v).
template <typename E, int D>
__device__ void bwd_pos(const Args<E>& a, int blk, float* smem) {
  float* sPos = smem;                         // [kTile][D+1]
  float* sQU = sPos + kTile * (D + 1);        // [kTile][D]
  float* sG = sQU + kTile * D;                // [kTile][D]
  float* sQV = sG + kTile * D;                // [kTile+1][D]
  float* sKl = sQV + (kTile + 1) * D;         // [kBand2][D+1] x 4
  float* sVl = sKl + kBand2 * (D + 1);
  float* sKr = sVl + kBand2 * (D + 1);
  float* sVr = sKr + kBand2 * (D + 1);
  float* sM = sVr + kBand2 * (D + 1);         // [kTile] x 3
  float* sL = sM + kTile;
  float* sD = sL + kTile;
  uint32_t* sRk = reinterpret_cast<uint32_t*>(sD + kTile);
  const int S = a.seq, n_tiles = (S + kTile - 1) / kTile;
  const int n = blk / n_tiles, r0 = (blk % n_tiles) * kTile;
  const int h = n % a.heads, b = n / a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = r0 + lane;
  const size_t base = static_cast<size_t>(n) * S * D;
  const size_t pbase = static_cast<size_t>(h) * S * D;
  const bool drop = a.thresh > 0;

  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int rr = i / D, c = i % D, t = r0 + rr;
    sPos[rr * (D + 1) + c] = t < S ? ld(a.pos, pbase + static_cast<size_t>(t) * D + c) : 0.f;
  }
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < (kTile + 1) * D; i += kThreads) {
      const int rr = i / D, c = i % D, t = q0 + rr;
      const size_t off = base + static_cast<size_t>(t) * D + c;
      const float x = t < S ? ld(a.q, off) : 0.f;
      if (rr < kTile) {
        sQU[rr * D + c] = t < S ? x + a.ub[h * D + c] : 0.f;
        sG[rr * D + c] = t < S ? ld(a.g, off) : 0.f;
      }
      sQV[rr * D + c] = t < S ? x + a.vb[h * D + c] : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int t = q0 + threadIdx.x;
      const size_t row = static_cast<size_t>(n) * S + t;
      sM[threadIdx.x] = t < S ? a.m[row] : 0.f;
      sL[threadIdx.x] = t < S ? a.l[row] : 1.f;
      sD[threadIdx.x] = t < S ? a.delta[row] : 0.f;
      sRk[threadIdx.x] = drop ? row_key(a.seed, n, t) : 0u;
    }
    // key of (query q0+qq, row r0+lane) at band row qq + lane
    const int lo_l = q0 - (S - 1) + r0, lo_r = q0 + r0 + 2;
    for (int i = threadIdx.x; i < kBand2 * D; i += kThreads) {
      const int rr = i / D, c = i % D, kl = lo_l + rr, kr = lo_r + rr;
      const size_t offl = base + static_cast<size_t>(kl) * D + c;
      const size_t offr = base + static_cast<size_t>(kr) * D + c;
      const bool okl = kl >= 0 && kl < S, okr = kr < S;
      sKl[rr * (D + 1) + c] = okl ? ld(a.k, offl) : 0.f;
      sVl[rr * (D + 1) + c] = okl ? ld(a.v, offl) : 0.f;
      sKr[rr * (D + 1) + c] = okr ? ld(a.k, offr) : 0.f;
      sVr[rr * (D + 1) + c] = okr ? ld(a.v, offr) : 0.f;
    }
    __syncthreads();

    for (int qq = warp; qq < kTile; qq += kWarps) {
      const int qg = q0 + qq;
      if (qg >= S) break;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int kg = side == 0 ? qg - (S - 1) + r : qg + r + 2;
        const bool live = r < S && kg >= 0 && kg < S;
        // for most queries only one side has keys in range for the whole
        // warp: skip the other (the branch is warp-uniform)
        if (!__any_sync(0xffffffffu, live)) continue;
        const float* kb = (side == 0 ? sKl : sKr) + (qq + lane) * (D + 1);
        const float* vb = (side == 0 ? sVl : sVr) + (qq + lane) * (D + 1);
        const float* qs = sQV + (qq + side) * D;
        float cs = 0.f, rs = 0.f, dpt = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          cs = fmaf(sQU[qq * D + c], kb[c], cs);
          rs = fmaf(qs[c], sPos[lane * (D + 1) + c], rs);
          dpt = fmaf(sG[qq * D + c], vb[c], dpt);
        }
        const bool kval = live && key_ok(a.kmask, b, S, kg);
        const bool keep = drop && live && keep_bit(sRk[qq], kg, a.thresh);
        float pd;
        const float d = dscore(cs + rs, live, kval, sM[qq], sL[qq], sD[qq],
                               dpt, keep, drop, a.scale, a.inv_keep, &pd);
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(d, qs[c], acc[c]);
      }
    }
  }

  __syncthreads();                    // the bands are free: reuse them
  float* sRed = sKl;                  // [kWarps][kTile][D+1]
#pragma unroll
  for (int c = 0; c < D; ++c) sRed[(warp * kTile + lane) * (D + 1) + c] = acc[c];
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int rr = i / D, c = i % D, t = r0 + rr;
    if (t >= S) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sRed[(w * kTile + rr) * (D + 1) + c];
    a.dpos[base + static_cast<size_t>(t) * D + c] = s;
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 4) relpos_bwd(Args<E> a, int n_q,
                                                       int n_kv) {
  extern __shared__ __align__(16) float smem[];
  const int blk = blockIdx.x;
  if (blk < n_q) bwd_q<E, D>(a, blk, smem);
  else if (blk < n_q + n_kv) bwd_kv<E, D>(a, blk - n_q, smem);
  else bwd_pos<E, D>(a, blk - n_q - n_kv, smem);
}

template <typename E, int D>
cudaError_t launch_bwd(const Args<E>& a, cudaStream_t stream) {
  const int smem = bwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      relpos_bwd<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_q = a.n * ((a.seq + kBq - 1) / kBq);
  const int n_pos = a.n * ((a.seq + kTile - 1) / kTile);
  relpos_bwd<E, D><<<2 * n_q + n_pos, kThreads, smem, stream>>>(a, n_q, n_q);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_fwd(const Args<E>& a, cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      relpos_fwd<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + kBq - 1) / kBq, a.n);
  relpos_fwd<E, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
Args<E> make_args(const void* q, const void* k, const void* v,
                  const void* pos, const float* ub, const float* vb,
                  const long long* seed, const int* kmask, int n, int heads,
                  int seq, float scale, unsigned thresh, float inv_keep) {
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
  a.seq = seq;
  a.scale = scale;
  a.thresh = thresh;
  a.inv_keep = inv_keep;
  return a;
}

bool bad_shape(int n, int heads, int seq) {
  return n <= 0 || heads <= 0 || seq <= 0 || n % heads != 0 ||
         static_cast<long long>(n) * seq >= (1LL << 31);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d = 32, the conformer's head width
// (the only one built). Returns a
// cudaError_t (0 = launched), cudaErrorInvalidValue for what the kernel
// does not take.
extern "C" int ctts_relpos_fwd(const void* q, const void* k, const void* v,
                               const void* pos, const float* ub,
                               const float* vb, const long long* seed,
                               const int* kmask, void* o, float* m, float* l,
                               int n, int heads, int seq, int d, float scale,
                               unsigned thresh, float inv_keep, int dtype,
                               void* stream) {
  if (bad_shape(n, heads, seq) || n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTTS_RELPOS_FWD(E, D)                                                \
  {                                                                          \
    Args<E> a = make_args<E>(q, k, v, pos, ub, vb, seed, kmask, n, heads,    \
                             seq, scale, thresh, inv_keep);                  \
    a.o = static_cast<E*>(o);                                                \
    a.m_out = m;                                                             \
    a.l_out = l;                                                             \
    return launch_fwd<E, D>(a, s);                                           \
  }
  if (dtype == 0 && d == 32) CTTS_RELPOS_FWD(float, 32)
  if (dtype == 1 && d == 32) CTTS_RELPOS_FWD(__nv_bfloat16, 32)
#undef CTTS_RELPOS_FWD
  return cudaErrorInvalidValue;
}

// The backward: g = dO; m, l the forward's row max and sum; delta =
// rowsum(dO*O) (float32 [N, T]). Writes float32 [N, T, D] partials: dqu
// (through Q+u), dqv (through Q+v, the row's own scores), dqvn (through
// Q[q+1]+v, what row q sends to row q+1), dk, dv, and dpos per n (the
// caller sums it over the batch).
extern "C" int ctts_relpos_bwd(const void* q, const void* k, const void* v,
                               const void* pos, const float* ub,
                               const float* vb, const long long* seed,
                               const int* kmask, const void* g,
                               const float* m, const float* l,
                               const float* delta, float* dqu, float* dqv,
                               float* dqvn, float* dk, float* dv, float* dpos,
                               int n, int heads, int seq, int d, float scale,
                               unsigned thresh, float inv_keep, int dtype,
                               void* stream) {
  if (bad_shape(n, heads, seq)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTTS_RELPOS_BWD(E, D)                                                \
  {                                                                          \
    Args<E> a = make_args<E>(q, k, v, pos, ub, vb, seed, kmask, n, heads,    \
                             seq, scale, thresh, inv_keep);                  \
    a.g = static_cast<const E*>(g);                                          \
    a.m = m;                                                                 \
    a.l = l;                                                                 \
    a.delta = delta;                                                         \
    a.dqu = dqu;                                                             \
    a.dqv = dqv;                                                             \
    a.dqvn = dqvn;                                                           \
    a.dk = dk;                                                               \
    a.dv = dv;                                                               \
    a.dpos = dpos;                                                           \
    return launch_bwd<E, D>(a, s);                                           \
  }
  if (dtype == 0 && d == 32) CTTS_RELPOS_BWD(float, 32)
  if (dtype == 1 && d == 32) CTTS_RELPOS_BWD(__nv_bfloat16, 32)
#undef CTTS_RELPOS_BWD
  return cudaErrorInvalidValue;
}
