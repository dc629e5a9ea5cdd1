"""Fused padding-masked attention (ctts_tpu/ops/attention.py).

``fused_attention`` launches the CUDA kernel ``csrc/attention.cu`` for
tensors on the card and runs :func:`attention_plain` (the math of
``_reference_attention``) for tensors on the CPU. There is no other path:
a CUDA tensor the kernel does not take raises. The kernel has instances at
d = 16, 32, 64, 128 and 256 (the JAX package runs any d, its other widths
through the reference); any other d up to 256 runs zero-padded to the next
instance (``ops/head_width.py``), and a wider one raises.

The JAX package has no backward kernel for it (``_fused_bwd``,
ctts_tpu/ops/attention.py:85-91, recomputes through the reference with
``jax.vjp``), and the port does the same: on the card the forward is the
kernel and the backward recomputes :func:`attention_plain` from the saved
q, k, v and lengths and back-propagates the cotangent through it. The
recompute holds one [N, T, T] float32 matrix per call while it runs.
"""

import ctypes
import math

import torch

from ctts_torch.ops import head_width, kernels

NEG = -1e9

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)


def kernel_width(d):
    """The width of the instance that runs heads of width d."""
    return head_width.instance_width(d, _HEAD_DIMS, "fused_attention")


def attention_plain(q, k, v, lengths, scale):
    """[N, T, d] q/k/v with per-row valid key lengths → [N, T, d]."""
    logits = torch.einsum("nqd,nkd->nqk", q * scale, k)
    mask = (torch.arange(k.shape[1], device=k.device)[None, None, :]
            < lengths[:, None, None])
    logits = torch.where(mask, logits, torch.full_like(logits, NEG))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("nqk,nkd->nqd", probs.to(q.dtype), v)


def _lib():
    lib = kernels.LIBRARY.get()
    fn = lib.ctts_fused_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, lengths):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [N, T, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N, T, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"fused_attention kernel takes d in {_HEAD_DIMS}, "
                         f"got {d} (see ROADMAP.md §3 F1)")
    if lengths.shape != (N,) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32 [{N}], got {lengths.dtype} "
                        f"{tuple(lengths.shape)}")
    for t in (k, v, lengths):
        if t.device != q.device:
            raise ValueError("q, k, v and lengths must be on one device")
    for t in (q, k, v, lengths):
        if not t.is_contiguous():
            raise ValueError("fused_attention takes contiguous tensors")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("fused_attention takes q, k and v 16-byte "
                             "aligned (its rows are copied in 16-byte chunks)")


class _FusedAttention(torch.autograd.Function):
    """Kernel forward, recomputing backward (``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        ctx.save_for_backward(q, k, v, lengths)
        ctx.scale = scale
        return _launch(q, k, v, lengths, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = attention_plain(q, k, v, lengths, ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None


def _launch(q, k, v, lengths, scale):
    global launches
    N, T, d = q.shape
    lib = _lib()
    out = torch.empty_like(q)
    err = lib.ctts_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), N, T, d, float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, lib, "fused_attention")
    launches += 1
    return out


def fused_attention(q, k, v, lengths, scale=None):
    """Padding-masked softmax attention.

    q/k/v: [N, T, d] (N = batch·heads); lengths: [N] int32 valid key
    counts. Logits at key index >= lengths[n] are -1e9; the softmax is in
    float32 and the output has q's dtype.
    """
    N, T, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    return _on_card(q, k, v, lengths, scale)


def _on_card(q, k, v, lengths, scale):
    """The kernel at the instance width of d: q, k and v zero-padded to it
    and the output trimmed back where d has no instance of its own."""
    d = q.shape[-1]
    w = kernel_width(d)
    q, k, v = (head_width.pad_heads(t, w) for t in (q, k, v))
    _check(q, k, v, lengths)
    out = _FusedAttention.apply(q, k, v, lengths, scale)
    return out if w == d else out[..., :d]
