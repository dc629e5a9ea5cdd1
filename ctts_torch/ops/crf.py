"""Linear-chain CRF for the ``crf`` duration head (ctts_tpu/ops/crf.py).

torchcrf's semantics: score(y) = start[y_0] + sum_t(trans[y_{t-1}, y_t] +
emit[t, y_t]) + end[y_last], log p(y|x) = score - logZ. Masks are True AT
VALID here (the torchcrf convention; the callers invert the repo's padding
masks), and position 0 must be valid. Both recursions take one step per
text position on the device, as the JAX package's ``lax.scan`` does; a
masked step carries the previous step forward.
"""

import torch


def crf_log_likelihood(emissions, tags, mask, start, end, trans):
    """emissions [B, T, K] f32, tags [B, T] int in [0, K), mask [B, T]
    bool. Returns [B] log p(tags | emissions)."""
    B, T, K = emissions.shape
    tags = tags.long()
    m = mask.float()
    e = emissions.gather(2, tags[..., None])[..., 0]             # [B, T]
    tr = trans[tags[:, :-1], tags[:, 1:]]                        # [B, T-1]
    score = (start[tags[:, 0]] + e[:, 0]
             + torch.sum((tr + e[:, 1:]) * m[:, 1:], dim=1))
    last = mask.sum(dim=1).long() - 1
    score = score + end[tags.gather(1, last[:, None])[:, 0]]

    alpha = start[None] + emissions[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None]
                              + emissions[:, t, None, :], dim=1)
        alpha = torch.where(mask[:, t, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + end[None], dim=-1)
    return score - log_z


def viterbi_decode(emissions, mask, start, end, trans):
    """The most likely tag sequence, [B, T] int32. emissions [B, T, K],
    mask [B, T] bool (True at valid). Ties go to the first index
    (``torch.argmax``, as ``jnp.argmax``); a masked position holds the best
    tag of the last valid step carried forward (callers zero it with their
    own mask)."""
    B, T, K = emissions.shape
    alpha = start[None] + emissions[:, 0]
    ident = torch.arange(K, device=emissions.device).expand(B, K)
    backptrs = []
    for t in range(1, T):
        cand = alpha[:, :, None] + trans[None]                   # [B, K, K]
        best = cand.amax(dim=1)
        best_prev = cand.argmax(dim=1)       # the first index on ties
        keep = mask[:, t, None]
        alpha = torch.where(keep, best + emissions[:, t], alpha)
        backptrs.append(torch.where(keep, best_prev, ident))
    y = torch.argmax(alpha + end[None], dim=-1)                  # [B]
    ys = [y]
    for bp in reversed(backptrs):
        y = bp.gather(1, y[:, None])[:, 0]
        ys.append(y)
    return torch.stack(ys[::-1], dim=1).to(torch.int32)
