// The CTC lattice of the ForwardSum alignment loss, for Hopper: the alpha
// recursion (forward) and the beta recursion that emits the gradient
// (backward).
//
// Replaces the Pallas pair ctts_tpu/ops/forward_sum.py:157 (_ctc_fwd_kernel)
// and :196 (_ctc_bwd_kernel) behind the custom VJP _ctc_state_nll_padded
// (:261). There the batch rides one sequential grid in frame chunks, the
// states are padded to 128 lanes and the transitions are lane rotates. Here
// the state axis is what it is (S = 2*T_s + 1) and a neighbour state is a
// shared-memory read.
//
// The lattice: state s is the blank for even s and label (s+1)/2 for odd s.
// alpha[t, s] = logsumexp(alpha[t-1, s], alpha[t-1, s-1], alpha[t-1, s-2] if
// s is odd and >= 3) + em[t, s]; frame 0 holds em[0, s] at s in {0, 1} and
// the sentinel elsewhere; frames at or past out_len copy the frozen row.
// beta runs the same transitions backwards from {2*in_len, 2*in_len - 1},
// and d(-logL)/d em[t, s] = -exp(alpha[t, s] + beta[t, s] - logL), times the
// cotangent, zero at or past out_len. The sentinel is -1e9 and the
// log-sum-exp is written max-first, as in the reference.
//
// What bounds them on the H100: by bytes the forward reads em and writes
// alpha (2 * B*T_m*S*4 = 29.5 MB at B=16, T_m=896, S=257, about 8.8 us at
// 3.35 TB/s) and the backward reads em and alpha and writes the gradient
// (44 MB, 13 us); what binds is the chain of T_m dependent frames, each one
// block-wide barrier plus three expf and a logf.
//
// Design: one block per utterance, one thread per state, the previous row
// double-buffered in shared memory so a frame needs one __syncthreads().
// The rows a frame needs from device memory (em; em and alpha in the
// backward) are loaded into registers kChunk frames ahead, so the
// global-memory latency is paid once per chunk. expf and logf are the
// full-precision ones (the file is built without fast-math); they differ
// from PyTorch's by ulps, so these kernels are held to a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kChunk = 8;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ em,
                                 const int* __restrict__ out_lens,
                                 float* __restrict__ alpha, int t_m, int n_s) {
  extern __shared__ float rows[];
  float* buf0 = rows;
  float* buf1 = rows + blockDim.x;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool active = s < n_s;
  const int olen = min(max(out_lens[b], 0), t_m);
  const float* eb = em + static_cast<size_t>(b) * t_m * n_s;
  float* ab = alpha + static_cast<size_t>(b) * t_m * n_s;
  const bool skip = (s & 1) && s >= 3;

  float mine = (active && s < 2) ? eb[s] : kNeg;
  buf0[s] = mine;
  if (active) ab[s] = mine;
  __syncthreads();

  float ahead[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = 1 + c;
    ahead[c] = (active && t < olen) ? eb[static_cast<size_t>(t) * n_s + s] : 0.f;
  }
  for (int t0 = 1; t0 < olen; t0 += kChunk) {
    float cur[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cur[c] = ahead[c];
      const int t = t0 + kChunk + c;
      ahead[c] = (active && t < olen) ? eb[static_cast<size_t>(t) * n_s + s] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      if (t >= olen) break;                          // uniform over the block
      const float* prev = (t & 1) ? buf0 : buf1;     // row t-1
      float* next = (t & 1) ? buf1 : buf0;           // row t
      const float p1 = s >= 1 ? prev[s - 1] : kNeg;
      const float p2 = skip ? prev[s - 2] : kNeg;
      mine = lse3(mine, p1, p2) + cur[c];
      next[s] = mine;
      if (active) ab[static_cast<size_t>(t) * n_s + s] = mine;
      __syncthreads();
    }
  }
  if (active)
    for (int t = max(olen, 1); t < t_m; ++t)
      ab[static_cast<size_t>(t) * n_s + s] = mine;
}

__global__ void ctc_grad_kernel(const float* __restrict__ em,
                                const float* __restrict__ alpha,
                                const float* __restrict__ log_l,
                                const float* __restrict__ g_out,
                                const int* __restrict__ in_lens,
                                const int* __restrict__ out_lens,
                                float* __restrict__ dem, int t_m, int n_s) {
  extern __shared__ float rows[];
  float* buf0 = rows;
  float* buf1 = rows + blockDim.x;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool active = s < n_s;
  const int olen = min(max(out_lens[b], 0), t_m);
  const int last_label = 2 * in_lens[b];
  const float z = log_l[b];
  const float gc = g_out[b];
  const size_t base = static_cast<size_t>(b) * t_m * n_s;
  const float* eb = em + base;
  const float* ab = alpha + base;
  float* db = dem + base;
  const bool can1 = s + 1 < n_s;
  const bool can2 = (s & 1) && s + 2 < n_s;

  if (active)
    for (int t = olen; t < t_m; ++t) db[static_cast<size_t>(t) * n_s + s] = 0.f;
  if (olen == 0) return;                              // uniform over the block

  // frame olen-1: beta is 0 at the two final states
  float beta = (active && (s == last_label || s == last_label - 1)) ? 0.f : kNeg;
  float em_next = kNeg;
  {
    const size_t at = static_cast<size_t>(olen - 1) * n_s + s;
    if (active) {
      db[at] = -expf(ab[at] + beta - z) * gc;
      em_next = eb[at];
    }
  }

  float e_ahead[kChunk], a_ahead[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = olen - 2 - c;
    const bool ok = active && t >= 0;
    e_ahead[c] = ok ? eb[static_cast<size_t>(t) * n_s + s] : kNeg;
    a_ahead[c] = ok ? ab[static_cast<size_t>(t) * n_s + s] : kNeg;
  }
  for (int t0 = olen - 2; t0 >= 0; t0 -= kChunk) {
    float e_cur[kChunk], a_cur[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      e_cur[c] = e_ahead[c];
      a_cur[c] = a_ahead[c];
      const int t = t0 - kChunk - c;
      const bool ok = active && t >= 0;
      e_ahead[c] = ok ? eb[static_cast<size_t>(t) * n_s + s] : kNeg;
      a_ahead[c] = ok ? ab[static_cast<size_t>(t) * n_s + s] : kNeg;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 - c;
      if (t < 0) break;                               // uniform over the block
      float* q = (t & 1) ? buf1 : buf0;
      const float mine = em_next + beta;              // em[t+1] + beta[t+1]
      q[s] = mine;
      __syncthreads();
      const float s1 = can1 ? q[s + 1] : kNeg;
      const float s2 = can2 ? q[s + 2] : kNeg;
      beta = lse3(mine, s1, s2);
      if (active) db[static_cast<size_t>(t) * n_s + s] = -expf(a_cur[c] + beta - z) * gc;
      em_next = e_cur[c];
    }
  }
}

int threads_for(int n_s) { return (n_s + 31) / 32 * 32; }

}  // namespace

// em [B, T_m, S] float32 state log-emissions, out_lens [B] int32, alpha
// [B, T_m, S] float32 (every element is written). S <= 1024. Returns a
// cudaError_t (0 = launched).
extern "C" int ctts_ctc_alpha(const float* em, const int* out_lens,
                              float* alpha, int b, int t_m, int n_s,
                              void* stream) {
  if (b < 0 || t_m < 0 || n_s < 0 || n_s > 1024) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || n_s == 0) return cudaSuccess;
  const int threads = threads_for(n_s);
  ctc_alpha_kernel<<<b, threads, 2 * threads * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(em, out_lens, alpha,
                                                          t_m, n_s);
  return cudaGetLastError();
}

// dem[b, t, s] = -exp(alpha + beta - log_l[b]) * g_out[b] below out_lens[b],
// 0 at or past it (every element is written). Same shapes as ctts_ctc_alpha;
// log_l, g_out [B] float32.
extern "C" int ctts_ctc_grad(const float* em, const float* alpha,
                             const float* log_l, const float* g_out,
                             const int* in_lens, const int* out_lens,
                             float* dem, int b, int t_m, int n_s,
                             void* stream) {
  if (b < 0 || t_m < 0 || n_s < 0 || n_s > 1024) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || n_s == 0) return cudaSuccess;
  const int threads = threads_for(n_s);
  ctc_grad_kernel<<<b, threads, 2 * threads * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(
      em, alpha, log_l, g_out, in_lens, out_lens, dem, t_m, n_s);
  return cudaGetLastError();
}
