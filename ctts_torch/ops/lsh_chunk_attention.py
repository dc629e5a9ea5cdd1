"""LSH chunk attention in the hash-sorted domain, the reformer's hashed
heads (ctts_tpu/ops/lsh_chunk_attention.py; its jnp oracle is the chunked
core of ``lsh_attention`` in ctts_tpu/models/reformer.py:122-157).

The sorted domain has M = n_hashes·N rows; sorted row m reads source row
``st[m]`` of qk and v (its position in the sequence) and has validity
``svalid[m]``. Chunks of ``cs`` rows attend to themselves and to the chunk
before them; chunk 0 looks back at the LAST chunk, across the hash rounds.
Queries are the raw shared qk, keys are qk L2-normalised, and the logits
``(q · kn) · scale`` take their masks in this order: validity (-1e9), then
causal (-1e9), then the self position pinned to -5e4 LAST, so every row
keeps at least its own key. A position may appear twice among a chunk's
keys where a round boundary meets the look-back; both are kept. The result
is [G, M, d+1] float32: the attention output and its logsumexp
(probabilities are exp(logit - lse)), which the un-sort scatter and the
round combine of ``models/reformer.py`` take next.

``chunk_attention`` launches the two kernels of
``csrc/lsh_chunk_attention.cu`` for tensors on the card (they load the
sorted rows straight by index and multiply on the tensor cores with
float32 sums; the forward keeps its output and logsumexp within ~1e-5 of
float32) and runs :func:`chunk_attention_plain` (a
row gather, then :func:`chunk_core`) for tensors on the CPU. Its backward
takes the logsumexp's own cotangent, which the round combine sends. The
reformer takes this route under ``CTTS_FUSED_LSH=1`` (:func:`supported`,
read at every call, as the JAX package reads it); by default it gathers the
sorted rows with ``sort_gather.gather_rows`` and runs :func:`chunk_core`.
"""

import ctypes
import os

import torch

from ctts_torch.ops import kernels, sort_gather

NEG = -1e9
SELF_ATTN_VAL = -5e4

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)          # the reformer's heads: 128 at full width


def supported():
    """Whether the reformer takes the fused route: ``CTTS_FUSED_LSH=1``."""
    return os.environ.get("CTTS_FUSED_LSH", "0") == "1"


def look_one_back(x):
    """[G, C, n, ...] → concat [chunk c, chunk c-1] along axis 2, chunk 0
    taking the last chunk."""
    return torch.cat([x, torch.roll(x, 1, dims=1)], dim=2)


def chunk_core(sqk, sv, st, svalid, cs, causal, scale):
    """The chunked attention on rows already in sorted order: sqk, sv
    [G, M, d] (any float dtype), st, svalid [G, M] int. Computes in float32
    and returns [G, M, d+1] float32 (output ‖ logsumexp)."""
    G, M, d = sqk.shape
    C = M // cs
    bq = sqk.float().reshape(G, C, cs, d)
    bk = look_one_back(
        bq * torch.rsqrt((bq * bq).sum(-1, keepdim=True) + 1e-12))
    bv = look_one_back(sv.float().reshape(G, C, cs, d))
    bq_t = st.reshape(G, C, cs)[..., :, None]
    bkv_t = look_one_back(st.reshape(G, C, cs))[..., None, :]
    mq = (svalid > 0).reshape(G, C, cs)
    mkv = look_one_back(mq)
    dots = torch.einsum("gcie,gcje->gcij", bq, bk) * scale
    dots = torch.where(mq[..., :, None] & mkv[..., None, :], dots, NEG)
    if causal:
        dots = torch.where(bq_t < bkv_t, NEG, dots)
    dots = torch.where(bq_t == bkv_t, SELF_ATTN_VAL, dots)
    lse = torch.logsumexp(dots, dim=-1, keepdim=True)
    out = torch.einsum("gcij,gcje->gcie", torch.exp(dots - lse), bv)
    return torch.cat([out.reshape(G, M, d), lse.reshape(G, M, 1)], dim=-1)


def chunk_attention_plain(qk, v, st, svalid, cs, causal, scale):
    """Plain PyTorch version of the fused op: qk, v [G, N, d]; st, svalid
    [G, M] int32. Returns [G, M, d+1] float32."""
    d = qk.shape[-1]
    rows = sort_gather.gather_rows_plain(torch.cat([qk, v], dim=-1), st)
    return chunk_core(rows[..., :d], rows[..., d:], st, svalid, cs, causal,
                      scale)


def _lib():
    lib = kernels.LIBRARY.get()
    fwd, bwd = lib.ctts_lsh_chunk_fwd, lib.ctts_lsh_chunk_bwd
    if fwd.argtypes is None:
        # qk v st svalid | out | G N M d cs causal scale dtype stream
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        # qk v st svalid dout dlse lse delta | grads | G N M d cs causal
        # scale dtype stream
        bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def _check(qk, v, st, svalid, cs):
    G, N, d = qk.shape
    if v.shape != qk.shape or st.dim() != 2 or st.shape[0] != G \
            or svalid.shape != st.shape:
        raise ValueError(f"chunk_attention takes qk, v [G, N, d] and st, "
                         f"svalid [G, M]; got {tuple(qk.shape)}, "
                         f"{tuple(v.shape)}, {tuple(st.shape)}, "
                         f"{tuple(svalid.shape)}")
    if qk.dtype not in _DTYPES or v.dtype != qk.dtype:
        raise TypeError(f"chunk_attention takes float32 or bfloat16 qk and "
                        f"v of one dtype, got {qk.dtype}, {v.dtype}")
    if st.dtype != torch.int32 or svalid.dtype != torch.int32:
        raise TypeError("chunk_attention takes int32 st and svalid")
    if d not in _HEAD_DIMS:
        raise ValueError(f"chunk_attention kernels take d in {_HEAD_DIMS}, "
                         f"got {d} (see ROADMAP.md §3 F1)")
    M = st.shape[1]
    if cs % 32 or M % cs or M // cs > 65535 or G > 65535:
        raise ValueError(f"chunk_attention kernels take a chunk that is a "
                         f"multiple of 32 and divides M; got cs {cs}, M {M}")
    for t in (v, st, svalid):
        if t.device != qk.device:
            raise ValueError("chunk_attention: every input on one device")
    for t in (qk, v, st, svalid):
        if not t.is_contiguous():
            raise ValueError("chunk_attention takes contiguous tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(qk, v, st, svalid, cs, causal, scale):
    global launches
    G, N, d = qk.shape
    M = st.shape[1]
    lib = _lib()
    out = torch.empty(G, M, d + 1, device=qk.device, dtype=torch.float32)
    err = lib.ctts_lsh_chunk_fwd(
        qk.data_ptr(), v.data_ptr(), st.data_ptr(), svalid.data_ptr(),
        out.data_ptr(), G, N, M, d, cs, int(causal), float(scale),
        _DTYPES[qk.dtype], _stream(qk))
    kernels.check(err, lib, "chunk_attention forward")
    launches += 1
    return out


def _launch_bwd(qk, v, st, svalid, g, out, cs, causal, scale):
    """dqk and dv [G, N, d] float32. The kernel writes one [G, M, 2d]
    float32 buffer, each sorted row's dq + dk (its query part, then its key
    part: its own chunk's and the next chunk's look-back uses, in that
    order) and dv; ``sort_gather.scatter_rows`` sums the rows into their
    source positions by ``st`` (float32, ascending sorted order), so there
    are no float atomics. The output cotangent goes to the kernel in qk's
    dtype (bf16 rounds it for the products, as the TPU kernel does); lse
    and its cotangent are read in place, the last column of ``out`` and
    ``g``."""
    global bwd_launches
    G, N, d = qk.shape
    M = st.shape[1]
    lib = _lib()
    g = g.float().contiguous()
    dout = g[..., :d].to(qk.dtype).contiguous()
    delta = (g[..., :d] * out[..., :d]).sum(-1)             # rowsum(dO∘O)
    grads = torch.empty(G, M, 2 * d, device=qk.device, dtype=torch.float32)
    err = lib.ctts_lsh_chunk_bwd(
        qk.data_ptr(), v.data_ptr(), st.data_ptr(), svalid.data_ptr(),
        dout.data_ptr(), g[..., d:].data_ptr(), out[..., d:].data_ptr(),
        delta.data_ptr(), grads.data_ptr(), G, N, M, d, cs, int(causal),
        float(scale), _DTYPES[qk.dtype], _stream(qk))
    kernels.check(err, lib, "chunk_attention backward")
    bwd_launches += 1
    grads = sort_gather.scatter_rows(grads, st, N)
    return grads[..., :d], grads[..., d:]


class _ChunkAttention(torch.autograd.Function):
    """Kernel forward; kernel backward recomputing the probabilities from
    the saved logsumexp, with its cotangent."""

    @staticmethod
    def forward(ctx, qk, v, st, svalid, cs, causal, scale):
        out = _launch_fwd(qk, v, st, svalid, cs, causal, scale)
        ctx.save_for_backward(qk, v, st, svalid, out)
        ctx.args = (cs, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        qk, v, st, svalid, out = ctx.saved_tensors
        dqk, dv = _launch_bwd(qk, v, st, svalid, g, out, *ctx.args)
        return (dqk.to(qk.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def chunk_attention(qk, v, st, svalid, cs, causal, scale):
    """Sorted-domain LSH chunk attention. qk, v: [G, N, d]; st: [G, M]
    int32 source positions of the sorted rows; svalid: [G, M] int32 their
    validity; M a multiple of ``cs``. Returns [G, M, d+1] float32, the
    output and its logsumexp per sorted row."""
    if qk.device.type == "cpu":
        return chunk_attention_plain(qk, v, st, svalid, cs, causal, scale)
    if qk.device.type != "cuda":
        raise ValueError(f"chunk_attention runs on cpu or cuda, not "
                         f"{qk.device}")
    _check(qk, v, st, svalid, cs)
    return _ChunkAttention.apply(qk, v, st, svalid, int(cs), bool(causal),
                                 float(scale))
