// Monotonic alignment search (width-1 Viterbi over mel frames, then a
// backtrack to a {0, 1} alignment), for Hopper.
//
// Replaces the Pallas pair ctts_tpu/ops/mas.py:131 (_fwd_kernel) and :174
// (_bwd_kernel), launched by b_mas_pallas at :217. There the whole batch
// rides one sequential grid in frame chunks, the step to the left is a lane
// rotate and the backtrack carries a one-hot column vector, because the TPU
// has no dynamic lane index. None of that is needed here.
//
// What bounds it on the H100: not bytes (B*T_m*T_s log-probabilities read
// once and as many {0, 1} floats written once: 14.7 MB at B=16, T_m=896,
// T_s=128, about 4.4 us at 3.35 TB/s) but the chain of T_m dependent frames,
// each of which costs one block-wide barrier plus a shared-memory round
// trip.
//
// Design: one block per utterance and one thread per text column. Row i of
// the running log-probabilities lives in shared memory, double-buffered, so
// a frame needs one __syncthreads(). The log-probabilities of the next
// kChunk frames are loaded into registers ahead of the frames that use them,
// so the global-memory latency is paid once per chunk and not once per
// frame. The move bits ("came from the left column") never reach device
// memory: each warp packs its 32 columns with one ballot into a shared
// [T_m, T_s/32] bitmap. The forward pass stops at out_len. One thread then
// walks the bitmap down from (out_len-1, max(in_len-1, 0)) in shared memory,
// and the block writes every row of the output once: a one at the path's
// column below out_len, zeros elsewhere.
//
// Arithmetic: float32 adds and compares only (no multiply, so nothing to
// contract, and the file is built without fast-math). With the caller's
// log-probabilities this makes the result bit-identical to b_mas_plain:
// sentinel -1e30 (not -inf) for masked columns and unreachable cells, row 0
// reachable only at column 0, and `left >= here` with the tie going to the
// diagonal.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kChunk = 8;               // frames loaded ahead
constexpr int kMaxShared = 232448;      // bytes one block may use on sm_90

__global__ void mas_kernel(const float* __restrict__ log_attn,
                           const int* __restrict__ in_lens,
                           const int* __restrict__ out_lens,
                           float* __restrict__ out, int t_m, int t_s) {
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j % 32;
  const int warp = j / 32;
  const int n_warps = blockDim.x / 32;
  float* buf0 = reinterpret_cast<float*>(smem_raw);
  float* buf1 = buf0 + blockDim.x;
  unsigned* moves = reinterpret_cast<unsigned*>(buf1 + blockDim.x);  // [t_m][n_warps]
  int* path = reinterpret_cast<int*>(moves + static_cast<size_t>(t_m) * n_warps);

  const int text_len = min(max(in_lens[b], 0), t_s);
  const int mel_len = min(max(out_lens[b], 0), t_m);
  const float* la = log_attn + static_cast<size_t>(b) * t_m * t_s;
  float* ob = out + static_cast<size_t>(b) * t_m * t_s;
  const bool valid = j < text_len;     // columns past in_len hold the sentinel

  if (mel_len > 0) {
    // row 0: only column 0 is reachable
    float mine = (j == 0 && valid) ? la[j] : kNeg;
    buf0[j] = mine;
    __syncthreads();

    float ahead[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int i = 1 + c;
      ahead[c] = (valid && i < mel_len) ? la[static_cast<size_t>(i) * t_s + j] : kNeg;
    }
    for (int i0 = 1; i0 < mel_len; i0 += kChunk) {
      float cur[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        cur[c] = ahead[c];
        const int i = i0 + kChunk + c;
        ahead[c] = (valid && i < mel_len) ? la[static_cast<size_t>(i) * t_s + j] : kNeg;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = i0 + c;
        if (i >= mel_len) break;                      // uniform over the block
        const float* prev = (i & 1) ? buf0 : buf1;    // row i-1
        float* next = (i & 1) ? buf1 : buf0;          // row i
        const float left = j > 0 ? prev[j - 1] : kNeg;
        const bool move = left >= mine;               // tie -> diagonal
        mine = cur[c] + (move ? left : mine);
        next[j] = mine;
        const unsigned bits = __ballot_sync(0xffffffffu, move);
        if (lane == 0) moves[static_cast<size_t>(i) * n_warps + warp] = bits;
        __syncthreads();
      }
    }

    if (j == 0) {
      int col = max(text_len - 1, 0);
      for (int i = mel_len - 1; i >= 0; --i) {
        path[i] = col;
        if (i > 0 && col > 0 &&
            ((moves[static_cast<size_t>(i) * n_warps + (col >> 5)] >> (col & 31)) & 1u))
          --col;
      }
    }
    __syncthreads();
  }

  if (j < t_s) {
    for (int i = 0; i < t_m; ++i)
      ob[static_cast<size_t>(i) * t_s + j] = (i < mel_len && path[i] == j) ? 1.f : 0.f;
  }
}

}  // namespace

// Bytes of shared memory a block needs for [t_m, t_s]; the wrapper checks it
// against the card's limit before launching.
extern "C" long long ctts_mas_shared_bytes(long long t_m, long long t_s) {
  const long long threads = (t_s + 31) / 32 * 32;
  return 2 * threads * 4 + t_m * (threads / 32) * 4 + t_m * 4;
}

// log_attn [B, T_m, T_s] float32 log-probabilities, in_lens/out_lens [B]
// int32, out [B, T_m, T_s] float32 (every element is written). Returns a
// cudaError_t (0 = launched); cudaErrorInvalidValue for T_s > 1024 or a
// lattice whose move bitmap does not fit one block's shared memory.
extern "C" int ctts_mas(const float* log_attn, const int* in_lens,
                        const int* out_lens, float* out, int b, int t_m,
                        int t_s, void* stream) {
  if (b < 0 || t_m < 0 || t_s < 0) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || t_s == 0) return cudaSuccess;
  const int threads = (t_s + 31) / 32 * 32;
  const long long bytes = ctts_mas_shared_bytes(t_m, t_s);
  if (threads > 1024 || bytes > kMaxShared) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  mas_kernel<<<b, threads, static_cast<size_t>(bytes),
               static_cast<cudaStream_t>(stream)>>>(log_attn, in_lens,
                                                    out_lens, out, t_m, t_s);
  return cudaGetLastError();
}
