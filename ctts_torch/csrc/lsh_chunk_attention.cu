// LSH chunk attention in the hash-sorted domain, forward and backward, on
// Hopper's tensor cores (sm_90a): the reformer's hashed heads under
// CTTS_FUSED_LSH=1.
//
// Replaces the Pallas kernels ctts_tpu/ops/lsh_chunk_attention.py:144
// (_fwd_kernel, launched by _fused at :232) and :158 (_bwd_kernel, launched
// by _fused_bwd at :254). For qk, v [G = B * heads, N, D], the sorted
// source positions st [G, M = n_hashes * N] and their validity svalid
// [G, M]: chunk i of `cs` sorted rows attends to chunks i and i - 1 (chunk
// 0 to the last chunk, across hash rounds), keys are the L2-normalised qk,
// and the mask order is validity, then causal, then self pinned to -5e4
// last. The forward writes [G, M, D + 1] f32, the output and its logsumexp
// per sorted row; the backward takes the cotangents of both and writes one
// [G, M, 2D] f32 buffer, dq + dk || dv per sorted row, which the caller
// sums into the N source rows with the scatter kernel (scatter_rows.cu) by
// st. The TPU kernel gathered each chunk with a one-hot matrix product on
// the MXU (re-paying O(N * 2cs * 2D) per chunk); here the engine in
// window_attention.cuh loads the sorted rows straight by index with
// cp.async, a block for 64 queries of one chunk (32 where cs is an odd
// multiple of 32), every product on mma.sync (its header says what bounds
// it on the H100 and what the design does about that).

#include "window_attention.cuh"

namespace {

using ctts_window::Args;

template <typename T>
Args<T> make_args(const void* qk, const void* v, const int* st,
                  const int* svalid, int n, int m, int cs, int causal,
                  float scale) {
  Args<T> a = {};
  a.qk = static_cast<const T*>(qk);
  a.v = static_cast<const T*>(v);
  a.st = st;
  a.ok = svalid;
  a.n_src = n;
  a.rows = m;
  a.unit = cs;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d = 64 or 128 and every st in [0, n).
// Returns a cudaError_t (0 = launched), or cudaErrorInvalidValue for a shape
// or dtype the kernels do not take.
extern "C" int ctts_lsh_chunk_fwd(const void* qk, const void* v,
                                  const int* st, const int* svalid,
                                  float* out, int g, int n, int m, int d,
                                  int cs, int causal, float scale, int dtype,
                                  void* stream) {
  if ((d != 64 && d != 128) || ctts_window::bad_shape(g, m, cs, n))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a = make_args<float>(qk, v, st, svalid, n, m, cs, causal, scale);
    a.ol = out;
    return d == 64 ? ctts_window::launch_fwd<float, 64, true>(a, g, s)
                   : ctts_window::launch_fwd<float, 128, true>(a, g, s);
  }
  if (dtype == 1) {
    Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(qk, v, st, svalid, n, m,
                                                     cs, causal, scale);
    a.ol = out;
    return d == 64 ? ctts_window::launch_fwd<__nv_bfloat16, 64, true>(a, g, s)
                   : ctts_window::launch_fwd<__nv_bfloat16, 128, true>(a, g, s);
  }
  return cudaErrorInvalidValue;
}

// dout [G, M, d] is in the input dtype; dlse and lse are the last column
// of [G, M, d + 1] f32 arrays (row stride d + 1); grads [G, M, 2d] f32
// takes dq + dk || dv.
extern "C" int ctts_lsh_chunk_bwd(const void* qk, const void* v,
                                  const int* st, const int* svalid,
                                  const void* dout, const float* dlse,
                                  const float* lse, const float* delta,
                                  float* grads, int g, int n, int m, int d,
                                  int cs, int causal, float scale, int dtype,
                                  void* stream) {
  if ((d != 64 && d != 128) || ctts_window::bad_shape(g, m, cs, n))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTTS_LSH_BWD(T)                                                     \
  {                                                                         \
    Args<T> a = make_args<T>(qk, v, st, svalid, n, m, cs, causal, scale);   \
    a.dout = static_cast<const T*>(dout);                                   \
    a.dlse = dlse;                                                          \
    a.stat_m = lse;                                                         \
    a.stat_l = nullptr;                                                     \
    a.sstride = d + 1;                                                      \
    a.delta = delta;                                                        \
    a.dq = grads;                                                           \
    a.dv = grads + d;                                                       \
    a.gstride = 2 * d;                                                      \
    return d == 64 ? ctts_window::launch_bwd<T, 64, true>(a, g, s)     \
                   : ctts_window::launch_bwd<T, 128, true>(a, g, s); \
  }
  if (dtype == 0) CTTS_LSH_BWD(float)
  if (dtype == 1) CTTS_LSH_BWD(__nv_bfloat16)
#undef CTTS_LSH_BWD
  return cudaErrorInvalidValue;
}
