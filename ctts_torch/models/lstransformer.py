"""`lstransformer` block: Long-Short Transformer attention
(ctts_tpu/models/lstransformer.py).

Each of the pre-norm layers runs causal long-short attention and an
exact-GELU conv FFN (conv k0 → GELU → conv k1, no LayerNorm of its own),
each added to the residual, with padded positions zeroed after each.
The attention (``LongShortAttention``), per head of the folded [B·h, N, d]
q and kv (shared keys and values): rotary positions on interleaved pairs,
the frequencies cast to the compute dtype before cos and sin (in bf16 a
position near 1000 rounds to a multiple of 8 first, as in the JAX
package); local keys from the query's window of 128 and the one before it
(``look_around``, padded with the value given), normalized by
``local_norm``; one global key a segment of 16, the segment's kv weighted
by a softmax over its positions of a rank-1 projection, normalized by
``global_norm``; the causal masks (a global key only once its segment has
ended, a local key at or before the query); one float32 softmax over
[global | local] with dropout on the weights. Masked logits are -1e9. The
sequence pads to lcm(128, 16) = 128 and is cut back. Only the causal
attention is built: the JAX stack never sets ``causal=False``.

``lstransformer.replicate_mask_bug: true`` feeds the padding mask in as the
validity mask, as upstream does by mistake; the default masks the padding.
Hyperparameters come from the ``transformer`` section. Every LayerNorm
has flax's eps 1e-6. Parameter paths are the upstream ones that
``ctts_tpu/utils/torch_import.py:_lstransformer_stack`` reads:
``layer_stack.layers.{i}.{0,1}.{norm,fn}``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import (Conv1d, Dropout, LayerNorm, Linear,
                                      dtype_of)
from ctts_torch.models.transformer import add_positions
from ctts_torch.text.symbols import symbols

NEG = -1e9
EPS = 1e-6


def rotary_freqs(positions, dim_head):
    """[T] float32 positions → [T, dim_head] frequencies, each repeated for
    its interleaved pair."""
    inv = 1.0 / (10000 ** (torch.arange(0, dim_head, 2, dtype=torch.float32,
                                        device=positions.device) / dim_head))
    return (positions[:, None] * inv[None, :]).repeat_interleave(2, dim=-1)


def apply_rotary(freqs, t):
    """t: [..., T, d]; freqs: [T, d] in t's dtype. Interleaved rotate-half:
    (x0, x1, x2, x3) → (-x1, x0, -x3, x2)."""
    x = t.reshape(*t.shape[:-1], -1, 2)
    rot = torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(t.shape)
    return t * torch.cos(freqs) + rot * torch.sin(freqs)


def look_around(x, pad_value, backward=1):
    """[B, W, n, ...] → [B, W, (backward + 1)·n, ...]: each window after the
    ``backward`` windows before it, the missing ones filled with
    ``pad_value``."""
    W = x.shape[1]
    pad = x.new_full((x.shape[0], backward) + tuple(x.shape[2:]), pad_value)
    padded = torch.cat([pad, x], dim=1)
    return torch.cat([padded[:, i:i + W] for i in range(backward + 1)], dim=2)


class LongShortAttention(nn.Module):
    def __init__(self, dim, dim_head, heads, dropout, dtype, window_size=128,
                 segment_size=16, r=1, mask_parity=False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.window, self.segment, self.r = window_size, segment_size, r
        self.mask_parity = mask_parity
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_kv = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_dynamic_proj = Linear(dim_head, r, bias=False, dtype=dtype)
        self.local_norm = LayerNorm(dim_head, eps=EPS, dtype=dtype)
        self.global_norm = LayerNorm(dim_head, eps=EPS, dtype=dtype)
        self.to_out = Linear(inner, dim, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x, padding_mask):
        B, n, _ = x.shape
        h, d, w, s, r = (self.heads, self.dim_head, self.window,
                         self.segment, self.r)
        mult = w * s // math.gcd(w, s)
        pad_len = (-n) % mult
        N = n + pad_len
        valid = padding_mask if self.mask_parity else ~padding_mask
        x = F.pad(x, (0, 0, 0, pad_len))
        valid = F.pad(valid, (0, pad_len))

        def split_heads(t):                          # [B, N, h·d] → [B·h, N, d]
            return t.reshape(B, N, h, d).transpose(1, 2).reshape(B * h, N, d)

        q, kv = split_heads(self.to_q(x)), split_heads(self.to_kv(x))
        seq = torch.arange(N, dtype=torch.float32, device=x.device)
        freqs = rotary_freqs(seq, d).to(q.dtype)
        q = apply_rotary(freqs, q) * d ** -0.5
        kv = apply_rotary(freqs, kv)
        W = N // w
        hvalid = valid.repeat_interleave(h, dim=0)            # [B·h, N]
        neg = torch.tensor(NEG, dtype=q.dtype, device=x.device)

        # local: the window and the one before it
        lq = q.reshape(B * h, W, w, d)
        lkv = self.local_norm(look_around(kv.reshape(B * h, W, w, d), 0.0))
        lsim = torch.einsum("bwid,bwjd->bwij", lq, lkv)      # [B·h, W, w, 2w]
        lmask = look_around(hvalid.reshape(B * h, W, w), False)
        lsim = torch.where(lmask[:, :, None, :], lsim, neg)
        pos = look_around(torch.arange(N, device=x.device).reshape(1, W, w),
                          -1)
        lsim = torch.where((pos == -1)[:, :, None, :], neg, lsim)

        # global: one key a segment, the segment's kv under a softmax of its
        # rank-r projection over the segment's positions
        n_seg = N // s
        gkv = kv.reshape(B * h, n_seg, s, d)
        pkv = self.to_dynamic_proj(gkv)                     # [B·h, n_seg, s, r]
        segmask = hvalid.reshape(B * h, n_seg, s)
        pkv = torch.where(segmask[..., None], pkv, neg)
        pkv = torch.softmax(pkv.float(), dim=-2).to(q.dtype)
        gkv = torch.einsum("bnsd,bnsr->bnrd", gkv, pkv).reshape(
            B * h, n_seg * r, d)
        gkv = self.global_norm(gkv)
        gsim = torch.einsum("bnd,brd->bnr", q, gkv)          # [B·h, N, G]

        # causal: a segment's key once the segment has ended; a local key
        # at or before the query
        g_max = seq.reshape(-1, s).amax(dim=-1).repeat_interleave(r)
        gsim = torch.where((seq[:, None] >= g_max[None, :])[None], gsim, neg)
        i, j = lsim.shape[-2], lsim.shape[-1]
        causal = torch.ones(i, j, dtype=torch.bool,
                            device=x.device).triu(j - i + 1)
        lsim = torch.where(causal[None, None], neg, lsim)

        G = gkv.shape[1]
        sim = torch.cat([gsim.reshape(B * h, W, w, G), lsim], dim=-1)
        attn = self.dropout(torch.softmax(sim.float(), dim=-1).to(q.dtype))
        v = torch.cat([gkv[:, None].expand(B * h, W, G, d), lkv], dim=2)
        out = torch.einsum("bwij,bwjd->bwid", attn, v)
        out = out.reshape(B, h, N, d).transpose(1, 2).reshape(B, N, h * d)
        return self.to_out(out[:, :n])


class GeluFF(nn.Module):
    """Conv(k0) → exact GELU → Conv(k1) → dropout (the residual and the
    norm are the caller's)."""

    def __init__(self, d_model, d_inner, kernel, dropout, dtype):
        super().__init__()
        self.w_1 = Conv1d(d_model, d_inner, kernel[0], dtype=dtype)
        self.w_2 = Conv1d(d_inner, d_model, kernel[1], dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.w_2(F.gelu(self.w_1(x))))


class PreNorm(nn.Module):
    """Upstream's PreNorm: the LayerNorm at ``.norm``, the branch at
    ``.fn``."""

    def __init__(self, dim, fn, dtype):
        super().__init__()
        self.norm = LayerNorm(dim, eps=EPS, dtype=dtype)
        self.fn = fn


class PreNormStack(nn.Module):
    """``layers.{i}`` = [PreNorm(attention), PreNorm(FFN)]; each branch
    added to the residual, padded positions zeroed after each."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList(pair) for pair in layers)

    def forward(self, x, padding_mask):
        pad = padding_mask[..., None]
        for attn, ff in self.layers:
            x = (attn.fn(attn.norm(x), padding_mask) + x).masked_fill(pad, 0.0)
            x = (ff.fn(ff.norm(x)) + x).masked_fill(pad, 0.0)
        return x


class PreNormBlocks(nn.Module):
    """The sinusoid table added unscaled, then the layers; computes in the
    config's dtype and returns float32. Subclasses build ``layer_stack``."""

    def __init__(self, model_config, side):
        super().__init__()
        self.cfg = cfg = model_config["transformer"]
        self.side = side
        self.dtype = dtype_of(model_config)
        self.d_model = cfg[f"{side}_hidden"]
        self.max_seq_len = model_config["max_seq_len"]

    def ff(self):
        cfg = self.cfg
        return PreNorm(self.d_model, GeluFF(
            self.d_model, cfg["conv_filter_size"],
            tuple(cfg["conv_kernel_size"]), cfg[f"{self.side}_dropout"],
            self.dtype), self.dtype)

    def run_stack(self, x, padding_mask):
        x = add_positions(x, self.max_seq_len, self.d_model).to(self.dtype)
        return self.layer_stack(x, padding_mask).float()


class LSStack(PreNormBlocks):
    def __init__(self, model_config, side):
        super().__init__(model_config, side)
        cfg, heads = self.cfg, self.cfg[f"{side}_head"]
        parity = model_config.get("lstransformer", {}).get(
            "replicate_mask_bug", False)
        self.layer_stack = PreNormStack(
            [PreNorm(self.d_model, LongShortAttention(
                self.d_model, self.d_model // heads, heads,
                cfg[f"{side}_dropout"], self.dtype, mask_parity=parity),
                self.dtype), self.ff()]
            for _ in range(cfg[f"{side}_layer"]))


def make_blocks(stack):
    """(TextEncoder, Decoder) classes around a stack class ``stack(config,
    side)``: the token embedding (no padding index, its padding row trained
    as in JAX) in the encoder, which returns (hidden, token embeddings),
    both float32."""

    class TextEncoder(stack):
        def __init__(self, model_config):
            super().__init__(model_config, "encoder")
            self.src_word_emb = nn.Embedding(len(symbols) + 1, self.d_model)

        def forward(self, txt_tokens, padding_mask):
            emb = F.embedding(txt_tokens, self.src_word_emb.weight)
            return self.run_stack(emb, padding_mask), emb

    class Decoder(stack):
        def __init__(self, model_config):
            super().__init__(model_config, "decoder")

        def forward(self, x, padding_mask):
            return self.run_stack(x, padding_mask), padding_mask

    return TextEncoder, Decoder


TextEncoder, Decoder = make_blocks(LSStack)
