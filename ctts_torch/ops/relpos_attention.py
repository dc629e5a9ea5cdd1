"""Transformer-XL relative-position attention (ctts_tpu/ops/relpos_attention.py).

The conformer's attention (``models/conformer.py``) scores

    S = ((Q+u)·Kᵀ + shift((Q+v)·Posᵀ)) · scale
    O = dropout(softmax(S)) · V

with the reference's pad-reshape-slice shift, whose legacy wrap makes row q
read the next query row right of the diagonal:

    rel[q, k]   = (Q[q]+v)·pos[T-1-q+k]      for k <= q
    rel[q, q+1] = 0
    rel[q, k]   = (Q[q+1]+v)·pos[k-q-2]      for k >  q+1

``relpos_attention`` launches the CUDA kernels of
``csrc/relpos_attention.cu`` for tensors on the card (a forward kernel, and
two backward kernels: one recomputes the scores once and writes dq
through Q+u, dS and the dropped P, the other takes dk, dv and the shift's
gradients as products over those two) and runs :func:`relpos_attention_plain` for tensors on the CPU. There is no
other path: a CUDA tensor the kernels do not take raises. The kernels have
instances at Dh = 16, 32, 64, 128 and 256 (the last two as chunks of 64
columns, see the kernel's note); any other Dh up to 256 runs zero-padded to
the next instance (``ops/head_width.py``), and a wider one raises.

Dropout cannot reproduce JAX's masks (the TPU's in-kernel PRNG). Its mask
is a counter-based hash of (seed, n, q, k), ``n`` the batch·head row
b·H_all + h among all the attention's heads (a tensor-parallel rank that
holds heads [off, off + H) of H_all passes ``head_range=(off, H_all)``,
and its masks are one process's): the kernels and the plain version
compute the same hash, so the two can be compared with dropout on, and the
backward regenerates the forward's mask from the same two seed words. The seed is a 2-element int64 tensor on the
tensors' device, drawn from the caller's generator, and the kernels read it
from device memory (no host sync).
"""

import ctypes

import torch

from ctts_torch.ops import head_width, kernels

NEG = -1e9
_M32 = 0xFFFFFFFF
_KEY_SALT = 0x5BD1E995

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)     # the conformer's: 8 heads of 32 in 256


def kernel_width(d):
    """The width of the instance that runs heads of width d."""
    return head_width.instance_width(d, _HEAD_DIMS, "relpos_attention")


def relative_shift(pos_score):
    """The reference's pad-reshape-slice shift on [..., T, T] scores."""
    *lead, T1, T2 = pos_score.shape
    padded = torch.cat([pos_score.new_zeros(*lead, T1, 1), pos_score], -1)
    padded = padded.reshape(*lead, T2 + 1, T1)
    return padded[..., 1:, :].reshape(*lead, T1, T2)


def _mix(x):
    """A 32-bit integer hash on int64 tensors holding values in [0, 2^32):
    both multipliers are below 2^31, so every product fits in int64 and its
    low 32 bits are the uint32 product of the CUDA side."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x4A6CA68B) & _M32
    return x ^ (x >> 16)


def dropout_keep(seed, N, T, p, device=None, heads=None, head_range=None):
    """The keep mask [N, T, T] (bool) of dropout rate ``p`` for ``seed``
    (2 int64 words): keep where hash(seed, n, q, k) >= p·2^32, with
    row_key = mix(mix(mix(q ^ mix(n)) ^ s1) ^ s0) and
    hash = mix(row_key ^ mix(k ^ 0x5bd1e995)). With ``head_range`` (off,
    H_all), the N rows are ``heads`` heads of each batch row and n is the
    row's index b·H_all + off + h among all heads."""
    device = seed.device if device is None else device
    s = seed.to(device=device, dtype=torch.int64) & _M32
    ar = torch.arange(max(N, T), device=device, dtype=torch.int64)
    n, q, k = ar[:N, None, None], ar[None, :T, None], ar[None, None, :T]
    if head_range is not None:
        off, total = head_range
        n = n // heads * total + off + n % heads
    row = _mix(_mix(_mix(q ^ _mix(n)) ^ s[1]) ^ s[0])
    h = _mix(row ^ _mix(k ^ _KEY_SALT))
    return h >= _threshold(p)


def _threshold(p):
    return min(int(p * 4294967296.0), _M32)


def relpos_attention_plain(q, k, v, pos, u_bias, v_bias, scale,
                           dropout_p=0.0, seed=None, key_padding_mask=None,
                           head_range=None):
    """Plain PyTorch version. q/k/v [B, T, H, Dh]; pos [H, T, Dh]; biases
    [H, Dh]; key_padding_mask [B, T] bool, True AT PADDING (masked logits
    are -1e9). The bias is added in q's dtype, the softmax runs in float32
    and the result has q's dtype. Returns [B, T, H, Dh]."""
    B, T, H, d = q.shape
    content = torch.einsum("bqhd,bkhd->bhqk", q + u_bias.to(q.dtype), k)
    pos_score = torch.einsum("bqhd,hkd->bhqk", q + v_bias.to(q.dtype),
                             pos.to(q.dtype))
    score = (content + relative_shift(pos_score)) * scale
    if key_padding_mask is not None:
        score = torch.where(key_padding_mask[:, None, None, :],
                            score.new_full((), NEG), score)
    probs = torch.softmax(score.float(), dim=-1)
    if dropout_p > 0.0:
        keep = dropout_keep(seed, B * H, T, dropout_p, q.device, H,
                            head_range)
        probs = torch.where(keep.reshape(B, H, T, T),
                            probs / (1.0 - dropout_p), probs.new_zeros(()))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _lib():
    lib = kernels.LIBRARY.get()
    fwd, bwd = lib.ctts_relpos_fwd, lib.ctts_relpos_bwd
    if fwd.argtypes is None:
        # q k v pos ub vb seed kmask | o m l | N H head_off head_total T d
        # scale p_thresh inv_keep dtype stream
        fwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        # q k v pos ub vb seed kmask g m l delta | dqu dqv dqv_next dk dv
        # dpos ds pd | N H head_off head_total T d scale p_thresh inv_keep
        # dtype stream
        bwd.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, pos, ub, vb, seed, kmask):
    N, T, d = q.shape
    H = pos.shape[0]
    if k.shape != q.shape or v.shape != q.shape or pos.shape != (H, T, d) \
            or ub.shape != (H, d) or vb.shape != (H, d) or N % H:
        raise ValueError(
            f"relpos_attention takes q/k/v [N, T, d], pos [H, T, d] and "
            f"biases [H, d] with N a multiple of H; got {tuple(q.shape)}, "
            f"{tuple(pos.shape)}, {tuple(ub.shape)}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, pos)):
        raise TypeError(f"relpos_attention takes float32 or bfloat16 q/k/v/"
                        f"pos of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {pos.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"relpos_attention kernels take d in {_HEAD_DIMS}, "
                         f"got {d} (see ROADMAP.md §3 F1)")
    if N * T >= 2 ** 31:
        raise ValueError("relpos_attention: N·T must stay below 2^31")
    if seed.shape != (2,) or seed.dtype != torch.int64:
        raise TypeError("the dropout seed is an int64 tensor of 2 words")
    if kmask is not None and (kmask.shape != (N // H, T)
                              or kmask.dtype != torch.int32):
        raise TypeError("the key mask is int32 [B, T], 1 at valid keys")
    for t in (q, k, v, pos, ub, vb, seed) + ((kmask,) if kmask is not None
                                             else ()):
        if t.device != q.device:
            raise ValueError("relpos_attention: every input on one device")
        if not t.is_contiguous():
            raise ValueError("relpos_attention takes contiguous tensors")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_fwd(q, k, v, pos, ub, vb, seed, kmask, scale, p, hr=None):
    """hr: (off, H_all) of the dropout hash's head index, (0, H) when
    None."""
    global launches
    N, T, d = q.shape
    H = pos.shape[0]
    hr = (0, H) if hr is None else hr
    lib = _lib()
    o = torch.empty_like(q)
    m = torch.empty(N, T, device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    err = lib.ctts_relpos_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        ub.data_ptr(), vb.data_ptr(), seed.data_ptr(), _ptr(kmask),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), N, H, hr[0], hr[1], T, d,
        float(scale),
        _threshold(p), 1.0 / (1.0 - p), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, lib, "relpos_attention forward")
    launches += 1
    return o, m, l


def _launch_bwd(q, k, v, pos, ub, vb, seed, kmask, g, o, m, l, scale, p,
                hr=None):
    """dq, dk, dv, dpos, du, dv_bias. The kernels (two launches) write
    float32 per-row partials; the sums over the batch and over rows are
    torch reductions in a fixed order (no float atomics). Between the
    launches dS and the dropped P live in scratch, [N, T, ceil8(T)] each in
    q's dtype: each call allocates about 2·N·T²·itemsize bytes, which grows
    with T² (410 MB at bf16 B=16 H=8 T=896, 820 MB in float32), where the
    forward and the wrapper's other buffers take O(N·T·d)."""
    global bwd_launches
    N, T, d = q.shape
    H = pos.shape[0]
    B = N // H
    hr = (0, H) if hr is None else hr
    lib = _lib()
    delta = (g.float() * o.float()).sum(-1).contiguous()    # rowsum(dO∘O)
    f32 = dict(device=q.device, dtype=torch.float32)
    dqu, dqv, dqv_next, dk, dv, dpos = (torch.empty(N, T, d, **f32)
                                        for _ in range(6))
    ds, pd = (torch.empty(N, T, (T + 7) // 8 * 8, device=q.device,
                          dtype=q.dtype) for _ in range(2))
    err = lib.ctts_relpos_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        ub.data_ptr(), vb.data_ptr(), seed.data_ptr(), _ptr(kmask),
        g.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dqu.data_ptr(), dqv.data_ptr(), dqv_next.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dpos.data_ptr(), ds.data_ptr(), pd.data_ptr(), N, H,
        hr[0], hr[1], T, d, float(scale),
        _threshold(p), 1.0 / (1.0 - p), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, lib, "relpos_attention backward")
    bwd_launches += 2
    # row q+1 takes what row q's right-of-diagonal scores sent it
    dqv_all = dqv.clone()
    dqv_all[:, 1:] += dqv_next[:, :-1]
    dq = dqu + dqv_all
    du = dqu.reshape(B, H, T, d).sum((0, 2))
    dvb = dqv_all.reshape(B, H, T, d).sum((0, 2))
    dpos = dpos.reshape(B, H, T, d).sum(0)
    return dq, dk, dv, dpos, du, dvb


class _RelposAttention(torch.autograd.Function):
    """Kernel forward; kernel backward that recomputes the scores and
    regenerates the dropout mask from the saved seed."""

    @staticmethod
    def forward(ctx, q, k, v, pos, ub, vb, seed, kmask, scale, p, hr):
        o, m, l = _launch_fwd(q, k, v, pos, ub, vb, seed, kmask, scale, p,
                              hr)
        ctx.save_for_backward(q, k, v, pos, ub, vb, seed, kmask, o, m, l)
        ctx.scale, ctx.p, ctx.hr = scale, p, hr
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, pos, ub, vb, seed, kmask, o, m, l = ctx.saved_tensors
        dq, dk, dv, dpos, du, dvb = _launch_bwd(
            q, k, v, pos, ub, vb, seed, kmask, g.contiguous(), o, m, l,
            ctx.scale, ctx.p, ctx.hr)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dpos.to(pos.dtype), du.to(ub.dtype), dvb.to(vb.dtype),
                None, None, None, None, None)


def draw_seed(generator, device):
    """The dropout seed ``relpos_attention`` draws: two 32-bit words from
    ``generator`` (the device's default generator when None)."""
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         device=device, dtype=torch.int64)


def relpos_attention(q, k, v, pos, u_bias, v_bias, scale, dropout_p=0.0,
                     generator=None, key_padding_mask=None, head_range=None):
    """Relative-position attention.

    q/k/v: [B, T, H, Dh]; pos: [H, T, Dh] (the batch-independent sinusoid
    projection); u_bias/v_bias: [H, Dh]; key_padding_mask: optional [B, T]
    bool, True AT PADDING. With ``dropout_p > 0`` the seed comes from
    ``draw_seed(generator, q.device)``; ``head_range`` (off, H_all): these
    H heads are heads off..off+H-1 of H_all, which keys the dropout hash
    (module docstring). Returns [B, T, H, Dh] in q's dtype.
    On the card the bias is added in float32, every product runs on the
    tensor cores in bf16 (float32 operands split into bf16 hi + lo) and
    accumulates in float32; d is any width up to 256 (module docstring).
    The backward on the card
    takes two [N, T, T] scratch tensors in q's dtype (see ``_launch_bwd``)."""
    B, T, H, d = q.shape
    seed = draw_seed(generator, q.device) if dropout_p > 0.0 else None
    hr = (0, H) if head_range is None else tuple(int(x) for x in head_range)
    if hr[0] < 0 or hr[0] + H > hr[1]:
        raise ValueError(f"head_range {hr} does not hold {H} heads")
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, pos, u_bias, v_bias, scale,
                                      dropout_p, seed, key_padding_mask, hr)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if seed is None:
        seed = torch.zeros(2, dtype=torch.int64, device=q.device)
    return _on_card(q, k, v, pos, u_bias, v_bias, scale, dropout_p, seed,
                    key_padding_mask, hr)


def _on_card(q, k, v, pos, u_bias, v_bias, scale, dropout_p, seed,
             key_padding_mask, hr):
    """The kernels at the instance width of Dh: q, k, v, pos and the biases
    zero-padded to it and the output trimmed back where Dh has no instance
    of its own."""
    B, T, H, d = q.shape
    w = kernel_width(d)

    def fold(t):
        t = head_width.pad_heads(t.permute(0, 2, 1, 3), w)
        return t.reshape(B * H, T, w).contiguous()

    kmask = None
    if key_padding_mask is not None:
        kmask = (~key_padding_mask).to(torch.int32).contiguous()
    ub = head_width.pad_heads(u_bias.float(), w).contiguous()
    vb = head_width.pad_heads(v_bias.float(), w).contiguous()
    pos = head_width.pad_heads(pos.to(q.dtype), w).contiguous()
    qf, kf, vf = fold(q), fold(k), fold(v)
    _check(qf, kf, vf, pos, ub, vb, seed, kmask)
    out = _RelposAttention.apply(qf, kf, vf, pos, ub, vb, seed, kmask,
                                 float(scale), float(dropout_p), hr)
    return out.reshape(B, H, T, w)[..., :d].permute(0, 2, 1, 3)
