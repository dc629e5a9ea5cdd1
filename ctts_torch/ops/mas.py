"""Monotonic alignment search, width 1 (ctts_tpu/ops/mas.py).

``b_mas`` binarizes the aligner's soft attention: a Viterbi pass over mel
frames (a path starts at (0, 0), moves down or diagonally, and ends at
(mel_len-1, text_len-1)) and a backtrack to a {0, 1} alignment. On the card
it launches ``csrc/mas.cu`` on the probabilities, which computes their
logarithm itself, as the Pallas forward does: the warp kernel where its
ring and move bits fit one block's shared memory (T_s <= 1024, T_m up to
1442-10306 frames by T_s), else the long route, one barrier a frame with the
move bits in device memory (:func:`route` names the kernel a shape takes);
on the CPU it runs
:func:`b_mas_plain`, the semantics of ``_mas_single`` / ``b_mas_scan``, on
the logarithm of one torch expression. The kernel's logarithm is that
expression's bits (``logf`` at full precision, the clamp keeping a NaN), and
both do float32 adds and compares only after it, so they agree bit for bit.
No gradient flows through either.
"""

import ctypes

import numpy as np
import torch

from ctts_torch.ops import kernels

NEG = -1e30

# kernel launches since the last reset (read by chip_smoke.py): the warp
# kernel's and the long route's
launches = 0
rows_launches = 0


def _log_attn(attn_soft, eps):
    return torch.log(torch.clamp(attn_soft.detach().float(), min=eps))


def _mas_from_log(log_attn, in_lens, out_lens):
    """The DP on log-probabilities [B, T_m, T_s]: one batched row update
    per frame, then one batched backtrack step per frame."""
    B, T_m, T_s = log_attn.shape
    dev = log_attn.device
    j_idx = torch.arange(T_s, device=dev)
    text_len = in_lens.long().clamp(0, T_s)
    mel_len = out_lens.long()
    neg = log_attn.new_full((), NEG)
    log_attn = torch.where(j_idx[None, None, :] < text_len[:, None, None],
                           log_attn, neg)
    # row 0: only column 0 is reachable
    log_p = torch.where(j_idx[None, :] == 0, log_attn[:, 0], neg)
    moves = torch.zeros(B, T_m, T_s, dtype=torch.bool, device=dev)
    first = log_attn.new_full((B, 1), NEG)
    for i in range(1, T_m):
        shifted = torch.cat([first, log_p[:, :-1]], dim=1)
        move = shifted >= log_p                        # tie → diagonal move
        log_p = log_attn[:, i] + torch.where(move, shifted, log_p)
        moves[:, i] = move

    hard = torch.zeros(B, T_m, T_s, dtype=torch.float32, device=dev)
    curr = (text_len - 1).clamp(min=0)                 # [B]
    rows = torch.arange(B, device=dev)
    for i in range(T_m - 1, -1, -1):
        active = i < mel_len
        hard[rows, i, curr] = active.float()
        if i > 0:
            back = moves[rows, i, curr] & active & (curr > 0)
            curr = curr - back.long()
    return hard


def b_mas_plain(attn_soft, in_lens, out_lens, eps=1e-12):
    """Plain PyTorch MAS with the contract of :func:`b_mas`."""
    return _mas_from_log(_log_attn(attn_soft, eps), in_lens, out_lens)


def _lib():
    lib = kernels.LIBRARY.get()
    fn = lib.ctts_mas
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ctts_mas_shared_bytes.argtypes = [ctypes.c_longlong] * 2
        lib.ctts_mas_shared_bytes.restype = ctypes.c_longlong
        lib.ctts_mas_route.argtypes = [ctypes.c_longlong] * 2
        lib.ctts_mas_route.restype = ctypes.c_int
        lib.ctts_mas_scratch_bytes.argtypes = [ctypes.c_longlong] * 3
        lib.ctts_mas_scratch_bytes.restype = ctypes.c_longlong
        lib.ctts_mas_log.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        lib.ctts_mas_log.restype = ctypes.c_int
    return lib


def shared_bytes(T_m, T_s):
    """Bytes of shared memory one block of the warp kernel needs at
    [T_m, T_s] (its ring of step rows and its move bits), as
    ``csrc/mas.cu`` computes them."""
    return _lib().ctts_mas_shared_bytes(T_m, T_s)


def route(T_m, T_s):
    """The kernel of ``csrc/mas.cu`` that [T_m, T_s] takes, as its
    ``ctts_mas_route`` picks it: "warp" (``mas_kernel<K>``) where
    T_s <= 1024 and its shared memory fits one block, else "rows"
    (``mas_rows_kernel``). Needs the built library."""
    return "rows" if _lib().ctts_mas_route(T_m, T_s) else "warp"


def b_mas(attn_soft, in_lens, out_lens, eps=1e-12):
    """attn_soft [B, T_m, T_s] probabilities; in_lens [B] text lengths and
    out_lens [B] mel lengths, int32. Returns the hard alignment
    [B, T_m, T_s] float32 in {0, 1}; rows at or past mel_len and columns at
    or past text_len are zero. No gradient flows."""
    global launches, rows_launches
    if attn_soft.device.type == "cpu":
        return b_mas_plain(attn_soft, in_lens, out_lens, eps)
    if attn_soft.device.type != "cuda":
        raise ValueError(f"b_mas runs on cpu or cuda, not {attn_soft.device}")
    if attn_soft.dim() != 3:
        raise ValueError(f"b_mas takes attn_soft [B, T_m, T_s], got "
                         f"{tuple(attn_soft.shape)}")
    B, T_m, T_s = attn_soft.shape
    for name, lens in (("in_lens", in_lens), ("out_lens", out_lens)):
        if lens.shape != (B,) or lens.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 [{B}], got {lens.dtype} "
                            f"{tuple(lens.shape)}")
        if lens.device != attn_soft.device or not lens.is_contiguous():
            raise ValueError(f"{name} must be contiguous on "
                             f"{attn_soft.device}")
    lib = _lib()
    probs = attn_soft.detach().float().contiguous()
    out = torch.empty_like(probs)
    # the warp kernel's log blocks write the logarithms here and flag each
    # chunk; the long route keeps its move bits (and rows) here
    scratch = torch.empty(lib.ctts_mas_scratch_bytes(B, T_m, T_s),
                          dtype=torch.uint8, device=attn_soft.device)
    err = lib.ctts_mas(
        probs.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, T_m, T_s, eps,
        torch.cuda.current_stream(attn_soft.device).cuda_stream)
    kernels.check(err, lib, "b_mas")
    if lib.ctts_mas_route(T_m, T_s):
        rows_launches += 1
    else:
        launches += 1
    return out


def kernel_log(probs, eps=1e-12):
    """The MAS kernel's logarithm, ``logf(max(p, eps))``, applied to a
    float32 tensor on the card by the kernel's own device function; for
    holding it against :func:`_log_attn`'s torch expression. Not a launch
    of the main path, so not counted."""
    if probs.device.type != "cuda" or probs.dtype != torch.float32 \
            or not probs.is_contiguous():
        raise ValueError("kernel_log takes a contiguous float32 cuda tensor")
    lib = _lib()
    out = torch.empty_like(probs)
    kernels.check(lib.ctts_mas_log(
        probs.data_ptr(), out.data_ptr(), probs.numel(), eps,
        torch.cuda.current_stream(probs.device).cuda_stream), lib, "mas_log")
    return out


def mas_width1_np(attn_map):
    """Numpy oracle for one utterance, [T_m, T_s] probabilities with the
    whole map valid (the upstream model's ``mas_width1``)."""
    opt = np.zeros_like(attn_map)
    attn_map = np.log(np.maximum(attn_map, 1e-300))
    attn_map[0, 1:] = -np.inf
    log_p = np.zeros_like(attn_map)
    log_p[0, :] = attn_map[0, :]
    prev_ind = np.zeros_like(attn_map, dtype=np.int64)
    for i in range(1, attn_map.shape[0]):
        for j in range(attn_map.shape[1]):
            prev_log = log_p[i - 1, j]
            prev_j = j
            if j - 1 >= 0 and log_p[i - 1, j - 1] >= log_p[i - 1, j]:
                prev_log = log_p[i - 1, j - 1]
                prev_j = j - 1
            log_p[i, j] = attn_map[i, j] + prev_log
            prev_ind[i, j] = prev_j
    curr_text_idx = attn_map.shape[1] - 1
    for i in range(attn_map.shape[0] - 1, -1, -1):
        opt[i, curr_text_idx] = 1
        curr_text_idx = prev_ind[i, curr_text_idx]
    opt[0, curr_text_idx] = 1
    return opt
