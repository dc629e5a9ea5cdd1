"""ForwardSum (alignment CTC) and binarization losses
(ctts_tpu/ops/forward_sum.py).

``forward_sum_loss`` prepends a blank class with constant log-probability
-1 to the aligner's log-attention, takes 1..text_len as the target
sequence, and averages each utterance's CTC negative log-likelihood divided
by its target length (torch ``CTCLoss(reduction="mean")`` semantics). The
log-softmax, the interleave into S = 2*T_s + 1 lattice states, the finals'
logsumexp and the normalisation are torch ops; the lattice itself is
:func:`ctc_state_nll`, a ``torch.autograd.Function`` over two kernels of
``csrc/forward_sum.cu`` on the card (forward: the alpha and beta recursions
in one launch, both saved, or alpha alone where no gradient is wanted, by
one state a thread up to 1024 states and several past them; backward: the
gradient,
elementwise from them)
and over their plain versions, :func:`ctc_alpha_plain`,
:func:`ctc_beta_plain` and :func:`ctc_grad_plain`, on the CPU.
"""

import ctypes

import torch

from ctts_torch.ops import kernels
from ctts_torch.parallel.tensor_parallel import global_mean, global_sum

BLANK_LOGPROB = -1.0
NEG = -1e9

# kernel launches since the last reset (read by chip_smoke.py): the
# lattice's one-state-a-thread instances (S <= 1024), its wide instance
# (S > 1024), and the gradient
lattice_launches = 0
wide_lattice_launches = 0
grad_launches = 0

# csrc/forward_sum.cu's kMaxThreads: the most states its one-state-a-thread
# instances take; past them the wide instance
MAX_THREADS = 1024


def _log_softmax(x):
    m = torch.max(x, dim=-1, keepdim=True).values
    s = x - m
    return s - torch.log(torch.sum(torch.exp(s), dim=-1, keepdim=True))


def _interleave(logits):
    """[B, T_m, T_s+1] class log-probs → [B, T_m, S] state log-emissions:
    even s is the blank, odd s = 2i-1 is label i."""
    B, T_m, _ = logits.shape
    T_s = logits.shape[-1] - 1
    blank = logits[:, :, :1]
    lab = logits[:, :, 1:]
    inter = torch.stack([blank.expand_as(lab), lab], dim=-1)
    return torch.cat([inter.reshape(B, T_m, 2 * T_s), blank], dim=-1)


def _lse3(a, b, c):
    m = torch.maximum(a, torch.maximum(b, c))
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def ctc_alpha_plain(em, out_lens):
    """The alpha lattice [B, T_m, S] of state log-emissions ``em``; frames
    at or past out_len copy the frozen row."""
    B, T_m, S = em.shape
    state = torch.arange(S, device=em.device)
    can_skip = ((state % 2 == 1) & (state >= 3))[None, :]
    neg = em.new_full((), NEG)
    alpha = em.new_full((B, S), NEG)
    alpha[:, :2] = em[:, 0, :2]
    rows = [alpha]
    pad1 = em.new_full((B, 1), NEG)
    pad2 = em.new_full((B, 2), NEG)
    for t in range(1, T_m):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip,
                            torch.cat([pad2, alpha[:, :-2]], dim=1), neg)
        new = _lse3(alpha, prev1, prev2) + em[:, t]
        alpha = torch.where((t < out_lens)[:, None], new, alpha)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


def ctc_beta_plain(em, in_lens, out_lens):
    """The beta lattice [B, T_m, S]: the final row (0 at states 2·in_len
    and 2·in_len - 1, the sentinel elsewhere) at frames at or past
    out_len - 1, the recursion over em[t + 1] + beta[t + 1] below."""
    B, T_m, S = em.shape
    state = torch.arange(S, device=em.device)[None, :]
    i2 = (2 * in_lens.long())[:, None]
    neg = em.new_full((), NEG)
    beta = torch.where((state == i2) | (state == i2 - 1),
                       em.new_zeros(()), neg)
    can1 = state + 1 < S
    can2 = (state % 2 == 1) & (state + 2 < S)
    pad1 = em.new_full((B, 1), NEG)
    pad2 = em.new_full((B, 2), NEG)
    em_next = em.new_full((B, S), NEG)
    rows = []
    for t in range(T_m - 1, -1, -1):
        q = em_next + beta
        s1 = torch.where(can1, torch.cat([q[:, 1:], pad1], dim=1), neg)
        s2 = torch.where(can2, torch.cat([q[:, 2:], pad2], dim=1), neg)
        beta = torch.where((t + 1 < out_lens)[:, None], _lse3(q, s1, s2),
                           beta)
        rows.append(beta)
        em_next = em[:, t]
    return torch.stack(rows[::-1], dim=1)


def ctc_grad_plain(alpha, beta, log_l, g, out_lens):
    """d(-logL)/d em · g: -exp(alpha + beta - logL)·g below out_len, zero
    at or past it."""
    live = (torch.arange(alpha.shape[1], device=alpha.device)[None, :]
            < out_lens[:, None])[:, :, None]
    return torch.where(live, -torch.exp(alpha + beta - log_l[:, None, None])
                       * g[:, None, None], torch.zeros_like(alpha))


def _lib():
    lib = kernels.LIBRARY.get()
    fn = lib.ctts_ctc_lattice
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        lib.ctts_ctc_scratch_bytes.argtypes = [ctypes.c_longlong,
                                               ctypes.c_int]
        lib.ctts_ctc_scratch_bytes.restype = ctypes.c_longlong
        fn = lib.ctts_ctc_grad
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(em, floats, lens):
    if em.device.type != "cuda":
        raise ValueError(f"the CTC lattice runs on cpu or cuda, not "
                         f"{em.device}")
    if em.dim() != 3:
        raise ValueError(f"the CTC kernels take [B, T_m, S], got "
                         f"{tuple(em.shape)}")
    B = em.shape[0]
    for t in (em, *floats):
        if t.dtype != torch.float32:
            raise TypeError(f"the CTC kernels take float32, got {t.dtype}")
    for t in lens:
        if t.dtype != torch.int32 or t.shape != (B,):
            raise TypeError(f"lengths must be int32 [{B}], got {t.dtype} "
                            f"{tuple(t.shape)}")
    for t in (em, *floats, *lens):
        if t.device != em.device or not t.is_contiguous():
            raise ValueError("the CTC kernels take contiguous tensors on "
                             "one device")


def ctc_lattice(em, in_lens, out_lens, with_beta=True):
    """em [B, T_m, S] float32 state log-emissions, in_lens and out_lens [B]
    int32 → the alpha and beta lattices, each [B, T_m, S], in one launch;
    beta is None when ``with_beta`` is false."""
    global lattice_launches, wide_lattice_launches
    if em.device.type == "cpu":
        return (ctc_alpha_plain(em, out_lens),
                ctc_beta_plain(em, in_lens, out_lens) if with_beta else None)
    _check(em, (), (in_lens, out_lens))
    B, T_m, S = em.shape
    lib = _lib()
    alpha = torch.empty_like(em)
    beta = torch.empty_like(em) if with_beta else None
    # the wide instance's rows, where they do not fit shared memory
    n = lib.ctts_ctc_scratch_bytes(2 * B if with_beta else B, S)
    scratch = torch.empty(n // 4, dtype=torch.float32,
                          device=em.device) if n else None
    err = lib.ctts_ctc_lattice(
        em.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(),
        alpha.data_ptr(), beta.data_ptr() if with_beta else None, B, T_m, S,
        scratch.data_ptr() if n else None,
        torch.cuda.current_stream(em.device).cuda_stream)
    kernels.check(err, lib, "ctc_lattice")
    if S <= MAX_THREADS:
        lattice_launches += 1
    else:
        wide_lattice_launches += 1
    return alpha, beta


def ctc_grad(alpha, beta, log_l, g, out_lens):
    """The gradient of ``-logL · g`` with respect to the state emissions
    [B, T_m, S], elementwise from the two lattices."""
    global grad_launches
    if alpha.device.type == "cpu":
        return ctc_grad_plain(alpha, beta, log_l, g, out_lens)
    _check(alpha, (beta, log_l, g), (out_lens,))
    if beta.shape != alpha.shape or log_l.shape != alpha.shape[:1] \
            or g.shape != alpha.shape[:1]:
        raise ValueError("ctc_grad takes beta like alpha and logL, g [B]")
    B, T_m, S = alpha.shape
    lib = _lib()
    dem = torch.empty_like(alpha)
    err = lib.ctts_ctc_grad(
        alpha.data_ptr(), beta.data_ptr(), log_l.data_ptr(), g.data_ptr(),
        out_lens.data_ptr(), dem.data_ptr(), B, T_m, S,
        torch.cuda.current_stream(alpha.device).cuda_stream)
    kernels.check(err, lib, "ctc_grad")
    grad_launches += 1
    return dem


class _CtcStateNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, in_lens, out_lens, with_beta):
        alpha, beta = ctc_lattice(em.contiguous(), in_lens, out_lens,
                                  with_beta)
        # frames past out_len freeze alpha, so the last row holds the finals
        i2 = 2 * in_lens.long()
        idx = torch.stack([i2, (i2 - 1).clamp(min=0)], dim=1)
        log_l = torch.logsumexp(alpha[:, -1].gather(1, idx), dim=-1)
        ctx.save_for_backward(alpha, beta, log_l, out_lens)
        return -log_l

    @staticmethod
    def backward(ctx, g):
        alpha, beta, log_l, out_lens = ctx.saved_tensors
        return ctc_grad(alpha, beta, log_l, g.contiguous(), out_lens), \
            None, None, None


def ctc_state_nll(em, in_lens, out_lens):
    """Per-utterance CTC negative log-likelihood [B] of labels 1..in_len
    over state log-emissions em [B, T_m, S] (float32; lengths int32).
    Beta, which only the gradient reads, is computed only where one can be
    asked for (validation runs alpha alone)."""
    return _CtcStateNll.apply(em, in_lens, out_lens,
                              torch.is_grad_enabled() and em.requires_grad)


def forward_sum_loss(attn_logprob, in_lens, out_lens):
    """attn_logprob [B, T_m, T_s] un-normalized log-attention; in_lens [B]
    text lengths, out_lens [B] mel lengths. Returns a scalar."""
    B, T_m, T_s = attn_logprob.shape
    logits = torch.cat(
        [attn_logprob.new_full((B, T_m, 1), BLANK_LOGPROB), attn_logprob],
        dim=-1)
    # keys past an utterance's text length are invalid (the blank never is)
    key_idx = torch.arange(T_s + 1, device=attn_logprob.device)[None, None, :]
    valid = key_idx <= in_lens[:, None, None]
    logits = _log_softmax(torch.where(valid, logits,
                                      logits.new_full((), NEG)))
    per_seq = ctc_state_nll(_interleave(logits.float()),
                            in_lens.to(torch.int32),
                            out_lens.to(torch.int32))
    # CTCLoss(reduction="mean"): divide by the target length, then average
    # (over the global batch in a data-parallel grid)
    return global_mean(per_seq / in_lens.float().clamp(min=1.0))


def bin_loss(hard_attention, soft_attention, eps=1e-12):
    """-mean log soft-probability at the hard alignment's positions."""
    log_soft = torch.log(torch.clamp(soft_attention, min=eps))
    num = torch.sum(hard_attention * log_soft)
    return -num / global_sum(torch.sum(hard_attention)).clamp(min=1.0)
