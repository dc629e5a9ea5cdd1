"""Windowed shared-QK local attention, the reformer's local heads
(ctts_tpu/ops/local_window_attention.py; its jnp oracle is
``local_attention`` in ctts_tpu/models/reformer.py:175-226).

Window w of ``window`` queries attends to the keys of windows w and w-1;
window 0's look-back is synthetic (zero keys and values, always masked).
Queries are the raw shared qk, keys are qk L2-normalised, and the logits
``(q · kn) · scale`` take their masks in this order: the self position is
pinned to -5e4, then the causal mask (-1e9), then validity (-1e9). So a
padded query row goes uniform over all 2·window slots, and its output (the
mean of the values there) feeds the next layer's LSH sort. Always causal,
as the reformer uses it.

``local_window_attention`` launches the two kernels of
``csrc/local_window_attention.cu`` for tensors on the card (a forward that
also writes each row's softmax max and sum, and a backward that recomputes
the probabilities) and runs :func:`local_window_attention_plain` for tensors
on the CPU. A CUDA tensor the kernels do not take raises.

The plain version computes in float32; the kernels multiply bf16
operands on the tensor cores with float32 sums (float32 inputs split into
bf16 hi + lo, within ~1e-5 of float32), rounding P and dS as the TPU
kernels do. Both return the input's dtype. The gradient is the plain
version's autograd gradient: the masked and pinned
logits are constants, so no gradient reaches q or k through them. (The
Pallas backward leaks a small dq, dk through the uniform probabilities of
a padded query row; the port does not.)
"""

import ctypes

import torch

from ctts_torch.ops import kernels

NEG = -1e9
SELF_ATTN_VAL = -5e4

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)          # the reformer's heads: 128 at full width


def _look_back_padded(x, pad_value):
    """[B, W, n, ...] → concat [current window, previous window] along
    axis 2, window 0's previous window filled with ``pad_value``."""
    pad = torch.full_like(x[:, :1], pad_value)
    return torch.cat([x, torch.cat([pad, x[:, :-1]], dim=1)], dim=2)


def local_window_attention_plain(qk, v, valid, window, scale):
    """Plain PyTorch version. qk, v [B, N, d]; valid [B, N] bool; N a
    multiple of ``window``. Returns [B, N, d] in qk's dtype."""
    B, N, d = qk.shape
    W = N // window
    q = qk.float()
    k = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    pos = torch.arange(N, device=qk.device).expand(B, N)

    def windows(x):
        return x.reshape(B, W, window, *x.shape[2:])

    bk = _look_back_padded(windows(k), 0.0)
    bv = _look_back_padded(windows(v.float()), 0.0)
    kv_t = _look_back_padded(windows(pos), -1)               # -1: synthetic
    mkv = _look_back_padded(windows(valid), False) & (kv_t >= 0)
    bq_t, bkv_t = windows(pos)[..., :, None], kv_t[..., None, :]
    dots = torch.einsum("bwie,bwje->bwij", windows(q), bk) * scale
    dots = torch.where(bq_t == bkv_t, SELF_ATTN_VAL, dots)
    dots = torch.where(bq_t < bkv_t, NEG, dots)
    dots = torch.where(windows(valid)[..., :, None] & mkv[..., None, :],
                       dots, NEG)
    probs = torch.softmax(dots, dim=-1)
    out = torch.einsum("bwij,bwje->bwie", probs, bv)
    return out.reshape(B, N, d).to(qk.dtype)


def _lib():
    lib = kernels.LIBRARY.get()
    fwd, bwd = lib.ctts_local_window_fwd, lib.ctts_local_window_bwd
    if fwd.argtypes is None:
        # qk v valid | o m l | G N d win scale dtype stream
        fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        # qk v valid dout m l delta | dqk dv | G N d win scale dtype stream
        bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def _check(qk, v, valid, window):
    G, N, d = qk.shape
    if v.shape != qk.shape or valid.shape != (G, N):
        raise ValueError(f"local_window_attention takes qk, v [G, N, d] and "
                         f"valid [G, N]; got {tuple(qk.shape)}, "
                         f"{tuple(v.shape)}, {tuple(valid.shape)}")
    if qk.dtype not in _DTYPES or v.dtype != qk.dtype:
        raise TypeError(f"local_window_attention takes float32 or bfloat16 "
                        f"qk and v of one dtype, got {qk.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"local_window_attention kernels take d in "
                         f"{_HEAD_DIMS}, got {d} (see ROADMAP.md §3 F1)")
    if window % 32 or N % window or N // window > 65535 or G > 65535:
        raise ValueError(f"local_window_attention kernels take a window "
                         f"that is a multiple of 32 and divides N; got "
                         f"window {window}, N {N}")
    for t in (v, valid):
        if t.device != qk.device:
            raise ValueError("local_window_attention: every input on one "
                             "device")
    for t in (qk, v, valid):
        if not t.is_contiguous():
            raise ValueError("local_window_attention takes contiguous "
                             "tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(qk, v, valid, window, scale):
    """o (qk's dtype) and each row's softmax max and sum (float32)."""
    global launches
    G, N, d = qk.shape
    lib = _lib()
    o = torch.empty_like(qk)
    m = torch.empty(G, N, device=qk.device, dtype=torch.float32)
    l = torch.empty_like(m)
    err = lib.ctts_local_window_fwd(
        qk.data_ptr(), v.data_ptr(), valid.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), G, N, d, window, float(scale),
        _DTYPES[qk.dtype], _stream(qk))
    kernels.check(err, lib, "local_window_attention forward")
    launches += 1
    return o, m, l


def _launch_bwd(qk, v, valid, g, o, m, l, window, scale):
    """dqk and dv [G, N, d] in float32. The kernel reads dO in its own
    dtype and writes, for every row, dq + dk (its query part, then its key
    part: the current-window and the look-back uses, in that order) and
    dv, so there are no float atomics and no sums left to the caller."""
    global bwd_launches
    G, N, d = qk.shape
    lib = _lib()
    g = g.to(qk.dtype).contiguous()
    delta = (g.float() * o.float()).sum(-1)                  # rowsum(dO∘O)
    dqk, dv = (torch.empty(G, N, d, device=qk.device, dtype=torch.float32)
               for _ in range(2))
    err = lib.ctts_local_window_bwd(
        qk.data_ptr(), v.data_ptr(), valid.data_ptr(), g.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dqk.data_ptr(),
        dv.data_ptr(), G, N, d, window, float(scale), _DTYPES[qk.dtype],
        _stream(qk))
    kernels.check(err, lib, "local_window_attention backward")
    bwd_launches += 1
    return dqk, dv


class _LocalWindowAttention(torch.autograd.Function):
    """Kernel forward; kernel backward recomputing the probabilities from
    the saved row max and sum."""

    @staticmethod
    def forward(ctx, qk, v, valid, window, scale):
        o, m, l = _launch_fwd(qk, v, valid, window, scale)
        ctx.save_for_backward(qk, v, valid, o, m, l)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, g):
        qk, v, valid, o, m, l = ctx.saved_tensors
        dqk, dv = _launch_bwd(qk, v, valid, g, o, m, l, ctx.window,
                              ctx.scale)
        return dqk.to(qk.dtype), dv.to(v.dtype), None, None, None


def local_window_attention(qk, v, valid, window, scale):
    """Causal windowed shared-QK attention. qk, v: [G, N, d]; valid: [G, N]
    bool (True at real positions); N a multiple of ``window``. Returns
    [G, N, d] in qk's dtype."""
    if qk.device.type == "cpu":
        return local_window_attention_plain(qk, v, valid, window, scale)
    if qk.device.type != "cuda":
        raise ValueError(f"local_window_attention runs on cpu or cuda, not "
                         f"{qk.device}")
    valid = valid.to(torch.int32).contiguous()
    _check(qk, v, valid, window)
    return _LocalWindowAttention.apply(qk, v, valid, int(window),
                                       float(scale))
