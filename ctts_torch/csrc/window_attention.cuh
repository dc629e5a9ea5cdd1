// Windowed shared-QK attention, forward and backward, for Hopper (sm_90a):
// the engine that local_window_attention.cu (the reformer's local heads)
// and lsh_chunk_attention.cu (its hashed heads, in the sorted domain)
// instantiate. Included by those two sources only.
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
// just under the card's bf16 ridge (~295), so at the tensor cores' rate the
// bytes bound it (chip_smoke.py counts both). This first version computes
// in f32 on the CUDA cores (a tensor-core version is later work), whose
// much lower f32 rate bounds it in practice.
//
// Design. The TPU kernels kept a whole batch row (local) or built a one-hot
// gather tile on the MXU (LSH); here every block loads its rows straight by
// index. Forward: one block per (16 queries, unit, g); the 2Q key slots
// stream through shared memory in tiles of 32 (one key per lane), each
// tile's keys normalised in place, with an online softmax; the local
// forward writes each row's max and sum (-1e9 + log(2Q) would round back
// to -1e9 in f32), the LSH forward writes out || lse with the output
// scaled by exp(m - lse), which is exp(logit - lse) summed as the
// reference does. Backward, one launch with two block roles, each
// recomputing the logits, P and dS = P * (dP - rowsum(dO * O)) (+ dlse * P
// for LSH), with dS = 0 where a logit is a masked or pinned constant:
//   query role (16 queries): dq over the 2Q slots;
//   key role (16 keys of unit u): dk and dv, walking first the queries of
//     unit u (the keys as current slots), then those of the next unit (the
//     keys as its look-back), then the normalisation chain
//     dk = r * dkn - k * r^3 * <k, dkn>.
// Each row's parts are written apart in f32 and summed by the caller in a
// fixed order: no float atomics, the same bits from run to run. Both roles
// and the forward compute every logit with the same operands in the same
// order, so they agree bit for bit on P.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace ctts_window {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRpw = 4;              // query rows (or keys) per warp
constexpr int kBq = kWarps * kRpw;   // 16 query rows (or keys) per block
constexpr int kTile = 32;            // key slots (or queries) per tile
constexpr int kPad = kTile + 1;      // row stride of a transposed tile
constexpr float kNeg = -1e9f;
constexpr float kSelf = -5e4f;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
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
  const float* dout;      // backward: dO [G, rows, D]
  const float* dlse;      // LSH backward: [G, rows]
  const float* stat_m;    // backward: local row max; LSH lse
  const float* stat_l;    // backward: local row sum; LSH null
  const float* delta;     // backward: rowsum(dO * O) [G, rows]
  float *dq, *dk, *dv;    // backward: [G, rows, D] per row, f32
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

// Loads key slots [k0, k0 + kTile) of unit u: the normalised keys,
// transposed, into sKt [D][kPad]; the values into sV, transposed [D][kPad]
// when kVt, else [kTile][D]; each slot's position (-1: synthetic) and
// validity. Starts and ends with every thread past a barrier.
template <typename T, int D, bool kLsh, bool kVt>
__device__ void load_keys(const Args<T>& a, int g, int u, int k0, float* sKt,
                          float* sV, int* sPos, int* sOk, float* sR) {
  const int Q = a.unit, n_units = a.rows / Q;
  const size_t gr = static_cast<size_t>(g) * a.rows;
  const bool back = k0 >= Q;
  const int pu = back ? (kLsh ? (u + n_units - 1) % n_units : u - 1) : u;
  const int row0 = pu * Q + (back ? k0 - Q : k0);
  if (threadIdx.x < kTile) {
    const int j = threadIdx.x;
    sPos[j] = pu < 0 ? -1 : pos_of<kLsh>(a.st, gr, row0 + j);
    sOk[j] = pu < 0 ? 0 : (a.ok[gr + row0 + j] != 0);
  }
  __syncthreads();
  const size_t gs = static_cast<size_t>(g) * a.n_src * D;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int j = i / D, c = i % D, src = sPos[j];
    const size_t at = gs + static_cast<size_t>(src) * D + c;
    const float kv = src >= 0 ? ld(a.qk, at) : 0.f;
    const float vv = src >= 0 ? ld(a.v, at) : 0.f;
    sKt[c * kPad + j] = kv;
    if (kVt) sV[c * kPad + j] = vv;
    else sV[j * D + c] = vv;
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    float ss = 0.f;
    for (int c = 0; c < D; ++c) {
      const float x = sKt[c * kPad + threadIdx.x];
      ss = fmaf(x, x, ss);
    }
    sR[threadIdx.x] = rsqrtf(ss + 1e-12f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int c = i / kTile, j = i % kTile;
    sKt[c * kPad + j] *= sR[j];
  }
  __syncthreads();
}

// ---- forward -------------------------------------------------------------- //

template <typename T, int D, bool kLsh>
__global__ void __launch_bounds__(kThreads) window_fwd(Args<T> a) {
  constexpr int kCols = D / 32;
  __shared__ __align__(16) float sQ[kBq * D];
  __shared__ float sKt[D * kPad];
  __shared__ float sV[kTile * D];
  __shared__ int sPos[kTile], sOk[kTile];
  __shared__ float sR[kTile];

  const int g = blockIdx.z, u = blockIdx.y;
  const int row0 = u * a.unit + blockIdx.x * kBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t gr = static_cast<size_t>(g) * a.rows;
  const size_t gs = static_cast<size_t>(g) * a.n_src * D;

  for (int i = threadIdx.x; i < kBq * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int src = pos_of<kLsh>(a.st, gr, row0 + r);
    sQ[i] = ld(a.qk, gs + static_cast<size_t>(src) * D + c);
  }
  int qpos[kRpw];
  bool qok[kRpw];
  float m[kRpw], l[kRpw], acc[kRpw][kCols];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int row = row0 + warp * kRpw + r;
    qpos[r] = pos_of<kLsh>(a.st, gr, row);
    qok[r] = a.ok[gr + row] != 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < 2 * a.unit; k0 += kTile) {
    __syncthreads();                 // the previous tile fully consumed
    load_keys<T, D, kLsh, false>(a, g, u, k0, sKt, sV, sPos, sOk, sR);

    float s[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float k0v = sKt[c * kPad + lane], k1v = sKt[(c + 1) * kPad + lane];
      const float k2v = sKt[(c + 2) * kPad + lane], k3v = sKt[(c + 3) * kPad + lane];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&sQ[(warp * kRpw + r) * D + c]);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    const int kt = sPos[lane];
    const bool kok = sOk[lane] != 0;
    float p[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      const float x = masked<kLsh>(s[r] * a.scale, qpos[r], kt, qok[r] && kok,
                                   a.causal != 0);
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);   // 0 on the first tile
      p[r] = expf(x - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }

#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = sV[jj * D + lane + 32 * c];
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
    const size_t row = gr + row0 + warp * kRpw + r;
    if (kLsh) {
      const float lse = m[r] + logf(l[r]);
      const float sc = expf(m[r] - lse);
      float* out = a.ol + row * (D + 1);
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[lane + 32 * c] = acc[r][c] * sc;
      if (lane == 0) out[D] = lse;
    } else {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        a.o[row * D + lane + 32 * c] = from_f32<T>(acc[r][c] * inv);
      if (lane == 0) {
        a.m[row] = m[r];
        a.l[row] = l[r];
      }
    }
  }
}

// ---- backward ------------------------------------------------------------- //

template <int D>
constexpr int bwd_smem_floats() {
  return 2 * kBq * D + 2 * D * kPad;
}

// P and dS of one logit, from the forward's statistics of its query row
template <bool kLsh>
__device__ __forceinline__ void grad_of(float s, float dp, int qt, int kt,
                                        bool ok, bool causal, float scale,
                                        float sm, float sl, float delta,
                                        float dlse, float* p, float* ds) {
  const float x = masked<kLsh>(s * scale, qt, kt, ok, causal);
  const float pr = kLsh ? expf(x - sm) : expf(x - sm) / sl;
  float d = pr * (dp - delta);
  if (kLsh) d += dlse * pr;
  *p = pr;
  *ds = live(qt, kt, ok, causal) ? d : 0.f;
}

template <typename T, int D, bool kLsh>
__device__ void query_role(const Args<T>& a, float* smem, int* sPos, int* sOk,
                           float* sR, int qb) {
  constexpr int kCols = D / 32;
  float* sQ = smem;                 // [kBq][D]
  float* sDO = sQ + kBq * D;        // [kBq][D]
  float* sKt = sDO + kBq * D;       // [D][kPad] normalised keys
  float* sVt = sKt + D * kPad;      // [D][kPad] values

  const int g = blockIdx.z, u = blockIdx.y;
  const int row0 = u * a.unit + qb * kBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t gr = static_cast<size_t>(g) * a.rows;
  const size_t gs = static_cast<size_t>(g) * a.n_src * D;
  const bool causal = a.causal != 0;

  for (int i = threadIdx.x; i < kBq * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int src = pos_of<kLsh>(a.st, gr, row0 + r);
    sQ[i] = ld(a.qk, gs + static_cast<size_t>(src) * D + c);
    sDO[i] = a.dout[(gr + row0 + r) * D + c];
  }
  int qpos[kRpw];
  bool qok[kRpw];
  float sm[kRpw], sl[kRpw], dl[kRpw], dls[kRpw], dq[kRpw][kCols];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const size_t row = gr + row0 + warp * kRpw + r;
    qpos[r] = pos_of<kLsh>(a.st, gr, row0 + warp * kRpw + r);
    qok[r] = a.ok[row] != 0;
    sm[r] = a.stat_m[row];
    sl[r] = kLsh ? 1.f : a.stat_l[row];
    dl[r] = a.delta[row];
    dls[r] = kLsh ? a.dlse[row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < 2 * a.unit; k0 += kTile) {
    __syncthreads();
    load_keys<T, D, kLsh, true>(a, g, u, k0, sKt, sVt, sPos, sOk, sR);

    float s[kRpw], dp[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float kv = sKt[c * kPad + lane], vv = sVt[c * kPad + lane];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        s[r] = fmaf(sQ[(warp * kRpw + r) * D + c], kv, s[r]);
        dp[r] = fmaf(sDO[(warp * kRpw + r) * D + c], vv, dp[r]);
      }
    }
    const int kt = sPos[lane];
    const bool kok = sOk[lane] != 0;
    float ds[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      float p;
      grad_of<kLsh>(s[r], dp[r], qpos[r], kt, qok[r] && kok, causal, a.scale,
                    sm[r], sl[r], dl[r], dls[r], &p, &ds[r]);
    }
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float kn[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kn[c] = sKt[(lane + 32 * c) * kPad + jj];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq[r][c] = fmaf(dsj, kn[c], dq[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    float* out = a.dq + (gr + row0 + warp * kRpw + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[lane + 32 * c] = dq[r][c] * a.scale;
  }
}

template <typename T, int D, bool kLsh>
__device__ void key_role(const Args<T>& a, float* smem, int* sPos, int* sOk,
                         float* sR, int kb) {
  constexpr int kCols = D / 32;
  float* sK = smem;                 // [kBq][D] raw keys
  float* sV = sK + kBq * D;         // [kBq][D]
  float* sQt = sV + kBq * D;        // [D][kPad] queries, transposed
  float* sDOt = sQt + D * kPad;     // [D][kPad] dO, transposed

  const int g = blockIdx.z, u = blockIdx.y;
  const int Q = a.unit, n_units = a.rows / Q;
  const int krow0 = u * Q + kb * kBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t gr = static_cast<size_t>(g) * a.rows;
  const size_t gs = static_cast<size_t>(g) * a.n_src * D;
  const bool causal = a.causal != 0;

  if (threadIdx.x < kBq) {
    sPos[threadIdx.x] = pos_of<kLsh>(a.st, gr, krow0 + threadIdx.x);
    sOk[threadIdx.x] = a.ok[gr + krow0 + threadIdx.x] != 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBq * D; i += kThreads) {
    const int j = i / D, c = i % D;
    const size_t at = gs + static_cast<size_t>(sPos[j]) * D + c;
    sK[i] = ld(a.qk, at);
    sV[i] = ld(a.v, at);
  }
  __syncthreads();
  if (threadIdx.x < kBq) {           // the same sum, in the same order, as
    float ss = 0.f;                  // load_keys
    for (int c = 0; c < D; ++c) {
      const float x = sK[threadIdx.x * D + c];
      ss = fmaf(x, x, ss);
    }
    sR[threadIdx.x] = rsqrtf(ss + 1e-12f);
  }
  __syncthreads();

  const int my = warp * kRpw;        // this warp's keys: my .. my + kRpw - 1
  float kr[kRpw], dkn[kRpw][kCols], dvv[kRpw][kCols];
  int kt[kRpw];
  bool kok[kRpw];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    kr[r] = sR[my + r];
    kt[r] = sPos[my + r];
    kok[r] = sOk[my + r] != 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dkn[r][c] = dvv[r][c] = 0.f;
  }

  // the queries of unit u (the keys as its current slots), then those of
  // the unit after it (the keys as its look-back slots)
  for (int pass = 0; pass < 2; ++pass) {
    const int qu = pass == 0 ? u : (kLsh ? (u + 1) % n_units : u + 1);
    if (qu >= n_units) break;
    for (int q0 = 0; q0 < Q; q0 += kTile) {
      const int qrow0 = qu * Q + q0;
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
        const int ii = i / D, c = i % D;
        const int src = pos_of<kLsh>(a.st, gr, qrow0 + ii);
        sQt[c * kPad + ii] = ld(a.qk, gs + static_cast<size_t>(src) * D + c);
        sDOt[c * kPad + ii] = a.dout[(gr + qrow0 + ii) * D + c];
      }
      const size_t row = gr + qrow0 + lane;
      const int qpos = pos_of<kLsh>(a.st, gr, qrow0 + lane);
      const bool qok = a.ok[row] != 0;
      const float sm = a.stat_m[row];
      const float sl = kLsh ? 1.f : a.stat_l[row];
      const float dl = a.delta[row];
      const float dls = kLsh ? a.dlse[row] : 0.f;
      __syncthreads();

      float s[kRpw], dp[kRpw];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float qv = sQt[c * kPad + lane], gv = sDOt[c * kPad + lane];
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          s[r] = fmaf(qv, sK[(my + r) * D + c] * kr[r], s[r]);
          dp[r] = fmaf(gv, sV[(my + r) * D + c], dp[r]);
        }
      }
      float pr[kRpw], ds[kRpw];
#pragma unroll
      for (int r = 0; r < kRpw; ++r)
        grad_of<kLsh>(s[r], dp[r], qpos, kt[r], qok && kok[r], causal,
                      a.scale, sm, sl, dl, dls, &pr[r], &ds[r]);
#pragma unroll 4
      for (int ii = 0; ii < kTile; ++ii) {
        float qv[kCols], gv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          qv[c] = sQt[(lane + 32 * c) * kPad + ii];
          gv[c] = sDOt[(lane + 32 * c) * kPad + ii];
        }
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          const float dsi = __shfl_sync(0xffffffffu, ds[r], ii);
          const float pi = __shfl_sync(0xffffffffu, pr[r], ii);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dkn[r][c] = fmaf(dsi, qv[c], dkn[r][c]);
            dvv[r][c] = fmaf(pi, gv[c], dvv[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const float* k = sK + (my + r) * D;
    float inner = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dkn[r][c] *= a.scale;
      inner = fmaf(k[lane + 32 * c], dkn[r][c], inner);
    }
    inner = warp_sum(inner);
    const float rr = kr[r], r3 = rr * rr * rr;
    const size_t row = (gr + krow0 + my + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      a.dk[row + col] = rr * dkn[r][c] - k[col] * r3 * inner;
      a.dv[row + col] = dvv[r][c];
    }
  }
}

template <typename T, int D, bool kLsh>
__global__ void __launch_bounds__(kThreads) window_bwd(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sPos[kTile], sOk[kTile];
  __shared__ float sR[kTile];
  const int n_qb = a.unit / kBq;
  if (static_cast<int>(blockIdx.x) < n_qb)
    query_role<T, D, kLsh>(a, smem, sPos, sOk, sR, blockIdx.x);
  else
    key_role<T, D, kLsh>(a, smem, sPos, sOk, sR, blockIdx.x - n_qb);
}

// ---- launches ------------------------------------------------------------- //

// The shapes the kernels take: the unit a multiple of the key tile, whole
// units, and a grid within its limits.
inline bool bad_shape(int g, int rows, int unit, int n_src) {
  return g <= 0 || g > 65535 || n_src <= 0 || unit <= 0 || unit % kTile ||
         rows <= 0 || rows % unit || rows / unit > 65535;
}

template <typename T, int D, bool kLsh>
cudaError_t launch_fwd(const Args<T>& a, int g, cudaStream_t stream) {
  const dim3 grid(a.unit / kBq, a.rows / a.unit, g);
  window_fwd<T, D, kLsh><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kLsh>
cudaError_t launch_bwd(const Args<T>& a, int g, cudaStream_t stream) {
  const int smem = bwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      window_bwd<T, D, kLsh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(2 * (a.unit / kBq), a.rows / a.unit, g);
  window_bwd<T, D, kLsh><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ctts_window
