// The CTC lattice of the ForwardSum alignment loss, for Hopper: the alpha
// and beta recursions in one launch (forward), and the gradient as one
// elementwise pass (backward).
//
// Replaces the Pallas pair ctts_tpu/ops/forward_sum.py:157 (_ctc_fwd_kernel)
// and :196 (_ctc_bwd_kernel) behind the custom VJP _ctc_state_nll_padded
// (:261). There the batch rides one sequential grid in frame chunks, the
// states are padded to 128 lanes and the transitions are lane rotates, and
// the backward runs the beta recursion before it can emit the gradient.
// Here beta needs only em and the lengths, not the cotangent, so the
// forward runs both chains side by side and the backward is elementwise.
//
// The lattice: state s is the blank for even s and label (s+1)/2 for odd s.
// alpha[t, s] = logsumexp(alpha[t-1, s], alpha[t-1, s-1], alpha[t-1, s-2] if
// s is odd and >= 3) + em[t, s]; frame 0 holds em[0, s] at s in {0, 1} and
// the sentinel elsewhere; frames at or past out_len copy the frozen row.
// beta[t, s] = logsumexp over q = em[t+1] + beta[t+1] at s, s+1 and s+2 if
// s is odd; frames at or past out_len - 1 hold the final row, 0 at
// {2*in_len, 2*in_len - 1} and the sentinel elsewhere. The gradient is
// d(-logL)/d em[t, s] = -exp(alpha[t, s] + beta[t, s] - logL), times the
// cotangent, zero at or past out_len. The sentinel is -1e9 and the
// log-sum-exp is written max-first, as in the reference.
//
// What bounds them on the H100: by bytes the Pallas pair's function reads
// em below out_len and writes alpha (2 * B*T_m*S*4 at most, 29 MB at B=16,
// T_m=896, S=257: 9 us at 3.35 TB/s; beta, written here, is the Pallas
// backward's on-chip state, so it is not counted), and the gradient reads
// two lattices below out_len and writes every row (44 MB, 13 us). What
// binds the lattice is its chain of T_m dependent frames; the gradient is
// bound by bytes.
//
// Design of the lattice: 2*B blocks, alpha in blocks [0, B) and beta in
// blocks [B, 2B) (B blocks, alpha alone, where no gradient is wanted), one
// utterance each, one thread per state up to S = 1024. A frame's row
// (alpha; beta's q = em + beta) goes into a shared double buffer, so a
// frame needs one __syncthreads(); em is read kChunk frames ahead, off the
// chain. Each log-sum-exp is the plain version's, m + log(exp(a - m) +
// exp(b - m) + exp(c - m)) with an absent input at the sentinel, in its
// order and with the full-precision expf and logf (the file is built
// without fast-math), so the lattices and the gradient are the plain
// version's bits on the card. Of the layouts measured at the train shape
// (PERF.md §6) this one was the fastest: two states a thread with
// the neighbours' values by warp shuffles and edge slots took 1.19x its
// time, one state a thread by shuffles 1.12x; a log2-domain lattice with
// ex2.approx and lg2.approx was slower still and moved the gradient by
// 6.0e-3 of its largest entry, past CTC_GRAD_TOL against the plain
// version.
//
// Past 1024 states (a text axis past 511 tokens) the wide instance keeps one
// block a chain and one barrier a frame, and a thread owns K = ceil(S/1024)
// states, s = tid + k*blockDim, so that a warp's reads and writes of a row
// stay contiguous. It reads a state's own value and its neighbours' from
// the rows of the two parities (8*S bytes of shared memory; past the
// 232448 bytes a block may hold, a global scratch of the same layout, whose
// order within the block __syncthreads() gives too), and em one frame
// ahead, for up to kWideAhead states a thread in registers (the rest on the
// chain). The log-sum-exps are the same expressions on the same values, so
// its lattices are the plain version's bits too.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kChunk = 8;                // frames of em read ahead
constexpr int kMaxThreads = 1024;        // a block's threads
constexpr int kWideAhead = 8;            // wide instance: states read ahead
constexpr long long kMaxShared = 232448; // bytes one block may use on sm_90

// the plain version's log-sum-exp (_lse3), term for term
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// em[t, s], or the sentinel where s is no state
__device__ __forceinline__ float em_at(const float* eb, int t, int s, int n_s) {
  return s < n_s ? eb[static_cast<size_t>(t) * n_s + s] : kNeg;
}

// alpha of utterance b, thread s owning state s: frame t reads frame t-1's
// row from the shared buffer of its parity; frames 0 .. olen-1 by the
// recursion, the rest frozen
__device__ void alpha_chain(const float* __restrict__ eb, float* __restrict__ ab,
                            int olen, int t_m, int n_s, float* rows) {
  const int s = threadIdx.x, n = blockDim.x;
  const bool active = s < n_s, skip = (s & 1) && s >= 3;
  float a = (s < 2 && active) ? eb[s] : kNeg;
  rows[s] = a;
  if (active) ab[s] = a;
  __syncthreads();
  float ahead[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = 1 + c;
    ahead[c] = t < olen ? em_at(eb, t, s, n_s) : 0.f;
  }
  for (int t0 = 1; t0 < olen; t0 += kChunk) {
    float cur[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cur[c] = ahead[c];
      const int t = t0 + kChunk + c;
      ahead[c] = t < olen ? em_at(eb, t, s, n_s) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      if (t >= olen) break;
      const float* prev = rows + ((t - 1) & 1) * n;
      const float p1 = s >= 1 ? prev[s - 1] : kNeg;
      const float p2 = skip ? prev[s - 2] : kNeg;
      a = lse3(a, p1, p2) + cur[c];
      rows[(t & 1) * n + s] = a;
      if (active) ab[static_cast<size_t>(t) * n_s + s] = a;
      __syncthreads();
    }
  }
  if (active)
    for (int t = max(olen, 1); t < t_m; ++t) ab[static_cast<size_t>(t) * n_s + s] = a;
}

// beta of utterance b, thread s owning state s: frame t reads q = em[t+1]
// + beta[t+1] of states s+1 and s+2 from the shared buffer of its parity;
// the recursion below frame olen-1, the final row from there on (written
// after the chain, so that the chain starts at once)
__device__ void beta_chain(const float* __restrict__ eb, float* __restrict__ bb,
                           int ilen, int olen, int t_m, int n_s, float* rows) {
  const int s = threadIdx.x, n = blockDim.x;
  const bool active = s < n_s, can2 = (s & 1) && s + 2 < n_s, can1 = s + 1 < n_s;
  const int last = 2 * ilen;
  float bt = (active && (s == last || s == last - 1)) ? 0.f : kNeg;
  if (olen < 2) {
    if (active)
      for (int t = 0; t < t_m; ++t) bb[static_cast<size_t>(t) * n_s + s] = bt;
    return;
  }
  float q = em_at(eb, olen - 1, s, n_s) + bt;
  rows[((olen - 2) & 1) * n + s] = q;
  __syncthreads();
  const float fin = bt;
  float ahead[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = olen - 2 - c;
    ahead[c] = t >= 0 ? em_at(eb, t, s, n_s) : 0.f;
  }
  for (int t0 = olen - 2; t0 >= 0; t0 -= kChunk) {
    float cur[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cur[c] = ahead[c];
      const int t = t0 - kChunk - c;
      ahead[c] = t >= 0 ? em_at(eb, t, s, n_s) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 - c;
      if (t < 0) break;
      const float* next = rows + (t & 1) * n;
      bt = lse3(q, can1 ? next[s + 1] : kNeg, can2 ? next[s + 2] : kNeg);
      if (active) bb[static_cast<size_t>(t) * n_s + s] = bt;
      q = cur[c] + bt;                  // at t = 0 unused: one branch less
      rows[((t - 1) & 1) * n + s] = q;
      __syncthreads();
    }
  }
  if (active)
    for (int t = olen - 1; t < t_m; ++t) bb[static_cast<size_t>(t) * n_s + s] = fin;
}

// The wide instance's em[t, s] for state k of this thread: from the
// read-ahead registers for k < kWideAhead, else from memory.
__device__ __forceinline__ float em_wide(const float (&cur)[kWideAhead], int k,
                                         const float* eb, int t, int s, int n_s) {
  float e = 0.f;
#pragma unroll
  for (int j = 0; j < kWideAhead; ++j)
    if (j == k) e = cur[j];
  return k < kWideAhead ? e : eb[static_cast<size_t>(t) * n_s + s];
}

// The wide instance's alpha: thread tid owns states tid + k*n, k < kn; a
// frame reads frame t-1's row (the state's own value, s-1 and s-2) from the
// row of its parity, one barrier a frame, and em one frame ahead.
__device__ void alpha_wide(const float* __restrict__ eb, float* __restrict__ ab,
                           int olen, int t_m, int n_s, float* rows) {
  const int tid = threadIdx.x, n = blockDim.x, kn = (n_s + n - 1) / n;
  for (int k = 0; k < kn; ++k) {
    const int s = tid + k * n;
    if (s < n_s) {
      const float a = s < 2 ? eb[s] : kNeg;
      rows[s] = a;
      ab[s] = a;
    }
  }
  __syncthreads();
  float cur[kWideAhead], nxt[kWideAhead];
#pragma unroll
  for (int k = 0; k < kWideAhead; ++k) {
    const int s = tid + k * n;
    cur[k] = (k < kn && s < n_s && 1 < olen) ? eb[n_s + s] : 0.f;
  }
  for (int t = 1; t < olen; ++t) {
    const float* prev = rows + ((t - 1) & 1) * n_s;
    float* row = rows + (t & 1) * n_s;
    float* out = ab + static_cast<size_t>(t) * n_s;
#pragma unroll
    for (int k = 0; k < kWideAhead; ++k) {
      const int s = tid + k * n;
      nxt[k] = (k < kn && s < n_s && t + 1 < olen)
                   ? eb[static_cast<size_t>(t + 1) * n_s + s] : 0.f;
    }
    for (int k = 0; k < kn; ++k) {
      const int s = tid + k * n;
      if (s >= n_s) break;
      const float p1 = s >= 1 ? prev[s - 1] : kNeg;
      const float p2 = ((s & 1) && s >= 3) ? prev[s - 2] : kNeg;
      const float a = lse3(prev[s], p1, p2) + em_wide(cur, k, eb, t, s, n_s);
      row[s] = a;
      out[s] = a;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWideAhead; ++k) cur[k] = nxt[k];
  }
  const float* fin = rows + ((max(olen, 1) - 1) & 1) * n_s;
  for (int k = 0; k < kn; ++k) {
    const int s = tid + k * n;
    if (s >= n_s) break;
    const float a = fin[s];
    for (int t = max(olen, 1); t < t_m; ++t) ab[static_cast<size_t>(t) * n_s + s] = a;
  }
}

// The wide instance's beta: frame t reads q = em[t+1] + beta[t+1] of the
// state and of s+1 and s+2 from the row of its parity and writes the
// state's q of frame t into the other.
__device__ void beta_wide(const float* __restrict__ eb, float* __restrict__ bb,
                          int ilen, int olen, int t_m, int n_s, float* rows) {
  const int tid = threadIdx.x, n = blockDim.x, kn = (n_s + n - 1) / n;
  const int last = 2 * ilen;
  if (olen < 2) {
    for (int k = 0; k < kn; ++k) {
      const int s = tid + k * n;
      if (s >= n_s) break;
      const float fin = (s == last || s == last - 1) ? 0.f : kNeg;
      for (int t = 0; t < t_m; ++t) bb[static_cast<size_t>(t) * n_s + s] = fin;
    }
    return;
  }
  for (int k = 0; k < kn; ++k) {
    const int s = tid + k * n;
    if (s >= n_s) break;
    const float fin = (s == last || s == last - 1) ? 0.f : kNeg;
    rows[((olen - 2) & 1) * n_s + s] =
        eb[static_cast<size_t>(olen - 1) * n_s + s] + fin;
  }
  __syncthreads();
  float cur[kWideAhead], nxt[kWideAhead];
#pragma unroll
  for (int k = 0; k < kWideAhead; ++k) {
    const int s = tid + k * n;
    cur[k] = (k < kn && s < n_s)
                 ? eb[static_cast<size_t>(olen - 2) * n_s + s] : 0.f;
  }
  for (int t = olen - 2; t >= 0; --t) {
    const float* next = rows + (t & 1) * n_s;
    float* row = rows + ((t - 1) & 1) * n_s;     // at t = 0 unused
    float* out = bb + static_cast<size_t>(t) * n_s;
#pragma unroll
    for (int k = 0; k < kWideAhead; ++k) {
      const int s = tid + k * n;
      nxt[k] = (k < kn && s < n_s && t >= 1)
                   ? eb[static_cast<size_t>(t - 1) * n_s + s] : 0.f;
    }
    for (int k = 0; k < kn; ++k) {
      const int s = tid + k * n;
      if (s >= n_s) break;
      const float bt = lse3(next[s], s + 1 < n_s ? next[s + 1] : kNeg,
                            ((s & 1) && s + 2 < n_s) ? next[s + 2] : kNeg);
      out[s] = bt;
      row[s] = em_wide(cur, k, eb, t, s, n_s) + bt;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWideAhead; ++k) cur[k] = nxt[k];
  }
  for (int k = 0; k < kn; ++k) {
    const int s = tid + k * n;
    if (s >= n_s) break;
    const float fin = (s == last || s == last - 1) ? 0.f : kNeg;
    for (int t = olen - 1; t < t_m; ++t) bb[static_cast<size_t>(t) * n_s + s] = fin;
  }
}

__device__ __forceinline__ void lattice_block(
    const float* __restrict__ em, const int* __restrict__ in_lens,
    const int* __restrict__ out_lens, float* __restrict__ alpha,
    float* __restrict__ beta, int n_b, int t_m, int n_s) {
  extern __shared__ float rows[];        // two rows of the chain
  const bool is_beta = static_cast<int>(blockIdx.x) >= n_b;
  const int b = is_beta ? blockIdx.x - n_b : blockIdx.x;
  const int olen = min(max(out_lens[b], 0), t_m);
  const size_t at = static_cast<size_t>(b) * t_m * n_s;
  if (is_beta)
    beta_chain(em + at, beta + at, in_lens[b], olen, t_m, n_s, rows);
  else
    alpha_chain(em + at, alpha + at, olen, t_m, n_s, rows);
}

// Blocks of up to 512 threads (the train shape's S = 257 takes 288) run
// without a launch bound: the chain takes 71 registers, and a bound
// (even one that 71 fits) made nvcc cut them to 40 and the chain 8 %
// slower. Past 512 threads a block must fit the SM's 65536 registers at up
// to 1024 threads (S <= 1024), 64 a thread: that instance has the bound.
__global__ void ctc_lattice_kernel(const float* __restrict__ em,
                                   const int* __restrict__ in_lens,
                                   const int* __restrict__ out_lens,
                                   float* __restrict__ alpha,
                                   float* __restrict__ beta, int n_b, int t_m,
                                   int n_s) {
  lattice_block(em, in_lens, out_lens, alpha, beta, n_b, t_m, n_s);
}

__global__ void __launch_bounds__(1024)
ctc_lattice_kernel_1024(const float* __restrict__ em,
                        const int* __restrict__ in_lens,
                        const int* __restrict__ out_lens,
                        float* __restrict__ alpha, float* __restrict__ beta,
                        int n_b, int t_m, int n_s) {
  lattice_block(em, in_lens, out_lens, alpha, beta, n_b, t_m, n_s);
}

// Past 1024 states: one block a chain, K states a thread, the rows in
// shared memory (a null scratch) or in a global scratch of 2*S floats a
// block.
__global__ void __launch_bounds__(kMaxThreads)
ctc_lattice_kernel_wide(const float* __restrict__ em,
                        const int* __restrict__ in_lens,
                        const int* __restrict__ out_lens,
                        float* __restrict__ alpha, float* __restrict__ beta,
                        int n_b, int t_m, int n_s, float* scratch) {
  extern __shared__ float shared_rows[];
  const bool is_beta = static_cast<int>(blockIdx.x) >= n_b;
  const int b = is_beta ? blockIdx.x - n_b : blockIdx.x;
  float* rows = scratch ? scratch + 2 * static_cast<size_t>(blockIdx.x) * n_s
                        : shared_rows;
  const int olen = min(max(out_lens[b], 0), t_m);
  const size_t at = static_cast<size_t>(b) * t_m * n_s;
  if (is_beta)
    beta_wide(em + at, beta + at, in_lens[b], olen, t_m, n_s, rows);
  else
    alpha_wide(em + at, alpha + at, olen, t_m, n_s, rows);
}

// The elementwise gradient; I is unsigned below 2^31 elements (the train
// shape's instance), size_t past it.
template <typename I>
__global__ void ctc_grad_kernel(const float* __restrict__ alpha,
                                const float* __restrict__ beta,
                                const float* __restrict__ log_l,
                                const float* __restrict__ g_out,
                                const int* __restrict__ out_lens,
                                float* __restrict__ dem, I t_m,
                                I n_s, I total) {
  const I idx = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const I row = idx / n_s, b = row / t_m;
  const int t = static_cast<int>(row - b * t_m);
  dem[idx] = t < out_lens[b]
                 ? -expf(alpha[idx] + beta[idx] - log_l[b]) * g_out[b]
                 : 0.f;
}

// The wide instance's shape: states a thread and threads a block, and
// whether its two rows fit shared memory.
int wide_states(int n_s) { return (n_s + kMaxThreads - 1) / kMaxThreads; }
int wide_threads(int n_s) {
  const int k = wide_states(n_s);
  return ((n_s + k - 1) / k + 31) / 32 * 32;
}
bool wide_rows_shared(int n_s) { return 8LL * n_s <= kMaxShared; }

}  // namespace

// Bytes of global scratch a lattice of S states needs for n_blocks blocks
// (2B, or B for alpha alone): 0 where its rows fit shared memory.
extern "C" long long ctts_ctc_scratch_bytes(long long n_blocks, int n_s) {
  if (n_s <= kMaxThreads || wide_rows_shared(n_s)) return 0;
  return n_blocks * 2 * n_s * static_cast<long long>(sizeof(float));
}

// em [B, T_m, S] float32 state log-emissions, in_lens and out_lens [B]
// int32, alpha and beta [B, T_m, S] float32 (every element is written).
// A null beta launches the B alpha blocks alone (no gradient to come).
// scratch: ctts_ctc_scratch_bytes of device memory (null where that is
// 0). Any S. Returns a cudaError_t (0 = launched).
extern "C" int ctts_ctc_lattice(const float* em, const int* in_lens,
                                const int* out_lens, float* alpha,
                                float* beta, int b, int t_m, int n_s,
                                float* scratch, void* stream) {
  if (b < 0 || t_m < 0 || n_s < 0) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || n_s == 0) return cudaSuccess;
  if (n_s <= kMaxThreads) {
    const int threads = (n_s + 31) / 32 * 32;
    const auto kernel =
        threads <= 512 ? ctc_lattice_kernel : ctc_lattice_kernel_1024;
    kernel<<<beta ? 2 * b : b, threads, (2 * threads + 2) * sizeof(float),
             static_cast<cudaStream_t>(stream)>>>(
        em, in_lens, out_lens, alpha, beta, b, t_m, n_s);
    return cudaGetLastError();
  }
  size_t bytes = 0;
  if (wide_rows_shared(n_s)) {
    bytes = 2 * static_cast<size_t>(n_s) * sizeof(float);
    scratch = nullptr;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ctc_lattice_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
  } else if (scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  ctc_lattice_kernel_wide<<<beta ? 2 * b : b, wide_threads(n_s), bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      em, in_lens, out_lens, alpha, beta, b, t_m, n_s, scratch);
  return cudaGetLastError();
}

// dem[b, t, s] = -exp(alpha + beta - log_l[b]) * g_out[b] below out_lens[b],
// 0 at or past it (every element is written). Same shapes as
// ctts_ctc_lattice; log_l, g_out [B] float32.
extern "C" int ctts_ctc_grad(const float* alpha, const float* beta,
                             const float* log_l, const float* g_out,
                             const int* out_lens, float* dem, int b, int t_m,
                             int n_s, void* stream) {
  if (b < 0 || t_m < 0 || n_s < 0) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || n_s == 0) return cudaSuccess;
  const size_t total = static_cast<size_t>(b) * t_m * n_s;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  const auto st = static_cast<cudaStream_t>(stream);
  if (total < (1u << 31))
    ctc_grad_kernel<unsigned><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        alpha, beta, log_l, g_out, out_lens, dem, t_m, n_s,
        static_cast<unsigned>(total));
  else
    ctc_grad_kernel<size_t><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        alpha, beta, log_l, g_out, out_lens, dem, t_m, n_s, total);
  return cudaGetLastError();
}
