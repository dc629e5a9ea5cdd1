"""Monotonic alignment search, width 1 (ctts_tpu/ops/mas.py).

``b_mas`` binarizes the aligner's soft attention: a Viterbi pass over mel
frames (a path starts at (0, 0), moves down or diagonally, and ends at
(mel_len-1, text_len-1)) and a backtrack to a {0, 1} alignment. On the card
it launches ``csrc/mas.cu``; on the CPU it runs :func:`b_mas_plain`, the
semantics of ``_mas_single`` / ``b_mas_scan``. Both take the
log-probabilities that the wrapper computes with one torch expression and
do float32 adds and compares only, so they agree bit for bit. No gradient
flows through either.
"""

import ctypes

import numpy as np
import torch

from ctts_torch.ops import kernels

NEG = -1e30
_MAX_SHARED = 232448        # bytes of shared memory one block may use (sm_90)

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ctts_mas_shared_bytes.argtypes = [ctypes.c_longlong] * 2
        lib.ctts_mas_shared_bytes.restype = ctypes.c_longlong
    return lib


def b_mas(attn_soft, in_lens, out_lens, eps=1e-12):
    """attn_soft [B, T_m, T_s] probabilities; in_lens [B] text lengths and
    out_lens [B] mel lengths, int32. Returns the hard alignment
    [B, T_m, T_s] float32 in {0, 1}; rows at or past mel_len and columns at
    or past text_len are zero. No gradient flows."""
    global launches
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
    need = lib.ctts_mas_shared_bytes(T_m, T_s)
    if T_s > 1024 or need > _MAX_SHARED:
        raise ValueError(
            f"the MAS kernel takes T_s <= 1024 and a [T_m, T_s/32] move "
            f"bitmap within {_MAX_SHARED} bytes of shared memory; "
            f"[{T_m}, {T_s}] needs {need}")
    log_attn = _log_attn(attn_soft, eps).contiguous()
    out = torch.empty_like(log_attn)
    err = lib.ctts_mas(
        log_attn.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(),
        out.data_ptr(), B, T_m, T_s,
        torch.cuda.current_stream(attn_soft.device).cuda_stream)
    kernels.check(err, lib, "b_mas")
    launches += 1
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
