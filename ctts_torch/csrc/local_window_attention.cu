// Windowed shared-QK local attention, forward and backward, on Hopper's
// tensor cores (sm_90a): the reformer's local heads.
//
// Replaces the Pallas kernels ctts_tpu/ops/local_window_attention.py:85
// (_fwd_kernel, launched by _fused at :149) and :97 (_bwd_kernel, launched
// by _fused_bwd at :166). For qk, v [G = B * heads, N, D] and valid [G, N]:
// window w of `win` queries attends to windows w and w - 1 (window 0's
// look-back is synthetic: zero keys and values, masked), keys are the
// L2-normalised qk, and the mask order is self pinned to -5e4, then causal
// (-1e9), then validity (-1e9), so an invalid query row goes uniform over
// all 2 * win slots. The TPU kernel unrolled the window loop over a whole
// batch row in VMEM; here a block takes 64 queries of one window (32 where
// win is an odd multiple of 32) and the engine in window_attention.cuh
// streams the window's 2 * win key slots through shared memory in tiles of
// 64, every product on mma.sync (its header says what bounds it on the
// H100 and what the design does about that). The forward writes o in the
// input dtype and each row's softmax max and sum (f32); the backward reads
// dO in the input dtype and writes dq + dk and dv per row in f32.

#include "window_attention.cuh"

namespace {

using ctts_window::Args;

template <typename T>
Args<T> make_args(const void* qk, const void* v, const int* valid, int n,
                  int win, float scale) {
  Args<T> a = {};
  a.qk = static_cast<const T*>(qk);
  a.v = static_cast<const T*>(v);
  a.st = nullptr;
  a.ok = valid;
  a.n_src = n;
  a.rows = n;
  a.unit = win;
  a.causal = 1;
  a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d = 64 or 128. Returns a cudaError_t
// (0 = launched), or cudaErrorInvalidValue for a shape or dtype the kernels
// do not take.
extern "C" int ctts_local_window_fwd(const void* qk, const void* v,
                                     const int* valid, void* o, float* m,
                                     float* l, int g, int n, int d, int win,
                                     float scale, int dtype, void* stream) {
  if ((d != 64 && d != 128) || ctts_window::bad_shape(g, n, win, n))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a = make_args<float>(qk, v, valid, n, win, scale);
    a.o = static_cast<float*>(o);
    a.m = m;
    a.l = l;
    return d == 64 ? ctts_window::launch_fwd<float, 64, false>(a, g, s)
                   : ctts_window::launch_fwd<float, 128, false>(a, g, s);
  }
  if (dtype == 1) {
    Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(qk, v, valid, n, win, scale);
    a.o = static_cast<__nv_bfloat16*>(o);
    a.m = m;
    a.l = l;
    return d == 64 ? ctts_window::launch_fwd<__nv_bfloat16, 64, false>(a, g, s)
                   : ctts_window::launch_fwd<__nv_bfloat16, 128, false>(a, g, s);
  }
  return cudaErrorInvalidValue;
}

// dout is in the input dtype; dqk and dv [G, N, d] f32 take dq + dk and dv.
extern "C" int ctts_local_window_bwd(const void* qk, const void* v,
                                     const int* valid, const void* dout,
                                     const float* m, const float* l,
                                     const float* delta, float* dqk,
                                     float* dv, int g, int n, int d, int win,
                                     float scale, int dtype, void* stream) {
  if ((d != 64 && d != 128) || ctts_window::bad_shape(g, n, win, n))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTTS_LOCAL_BWD(T)                                        \
  {                                                              \
    Args<T> a = make_args<T>(qk, v, valid, n, win, scale);       \
    a.dout = static_cast<const T*>(dout);                        \
    a.stat_m = m;                                                \
    a.stat_l = l;                                                \
    a.sstride = 1;                                               \
    a.delta = delta;                                             \
    a.dq = dqk;                                                  \
    a.dv = dv;                                                   \
    a.gstride = d;                                               \
    return d == 64 ? ctts_window::launch_bwd<T, 64, false>(a, g, s)    \
                   : ctts_window::launch_bwd<T, 128, false>(a, g, s);\
  }
  if (dtype == 0) CTTS_LOCAL_BWD(float)
  if (dtype == 1) CTTS_LOCAL_BWD(__nv_bfloat16)
#undef CTTS_LOCAL_BWD
  return cudaErrorInvalidValue;
}
