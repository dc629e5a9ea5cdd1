"""`fastformer` block: additive attention, O(T) (ctts_tpu/models/fastformer.py).

Pre-norm layers of additive attention and the exact-GELU conv FFN that the
lstransformer module holds, each added to the residual, padded positions
zeroed after each. The attention (``FastAttention``) keeps the reference's
inverted heads: dim // n_head heads of size n_head (hidden 256 and 2 config
heads give 128 heads of 2). It pools the query by a softmax of its
per-head logits over time, multiplies the keys by the pooled query, pools
those the same way, multiplies the query by the pooled key, and returns
``transform`` of that plus the query, then dropout. The logits are scaled by
n_head^-0.5 and padded positions get -10000 added in the compute dtype;
the softmax runs in float32 and is cast back.

The logit projections ``to_q_attn_logits`` and ``to_k_attn_logits`` are
tied across the layers: one module each, held by every layer's attention,
so their gradient is the sum over the layers, as in JAX. A state_dict
carries them under every layer, as upstream's does, and
``ctts_tpu/utils/torch_import.py:_fastformer_stack`` reads them from layer
0. Hyperparameters come from the ``transformer`` section.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import Dropout, Linear
from ctts_torch.models.lstransformer import (PreNorm, PreNormBlocks,
                                             PreNormStack, make_blocks)
from ctts_torch.parallel.tensor_parallel import (copy_to_model, embed_slice,
                                                 reduce_from_model)

MASK = -10000.0


class FastAttention(nn.Module):
    """Tensor parallel (the mesh's rules): a rank keeps its heads' channels of
    ``query`` and ``key`` (output rows) and of ``transform`` and the tied
    logit projections (input columns). The logits are partial sums over
    the rank's channels, summed over the model group before the softmax;
    the rank's slice of ``mixed_q`` joins ``transform``'s partial output
    before that sum, so ``transform(weighted) + mixed_q`` takes one
    reduction."""

    tp = None

    def __init__(self, dim, n_head, dropout, dtype, q_logits, k_logits):
        super().__init__()
        self.dim, self.head_size = dim, n_head
        self.query = Linear(dim, dim, dtype=dtype)
        self.key = Linear(dim, dim, dtype=dtype)
        self.transform = Linear(dim, dim, dtype=dtype)
        self.to_q_attn_logits = q_logits
        self.to_k_attn_logits = k_logits
        self.dropout = Dropout(dropout)

    def tp_units(self):
        return self.dim // self.head_size

    def forward(self, x, padding_mask):
        B, T, _ = x.shape
        tp = self.tp
        hs = self.head_size
        nh = self.dim // hs
        dim = self.dim
        lo, hi = (0, nh) if tp is None else tp.bounds(nh)
        if tp is not None:
            nh, dim = hi - lo, (hi - lo) * hs
        scale = hs ** -0.5
        neg = torch.where(padding_mask, MASK, 0.0).to(x.dtype)[:, None, :]

        def heads(v):                                # [B, T, H] → [B, nh, T, hs]
            return v.reshape(B, T, nh, hs).transpose(1, 2)

        def pool(logits, v):                        # → [B, nh, hs]
            if tp is not None:   # the summed logits, this rank's heads
                logits = copy_to_model(logits, tp)[..., lo:hi]
            score = logits.transpose(1, 2) * scale + neg
            weight = torch.softmax(score.float(), dim=-1).to(v.dtype)
            return torch.einsum("bht,bhts->bhs", weight, heads(v))

        mixed_q, mixed_k = self.query(x), self.key(x)
        pooled_q = pool(self.to_q_attn_logits(mixed_q), mixed_q)
        mixed_qk = mixed_k * pooled_q.reshape(B, 1, dim)
        pooled_k = pool(self.to_k_attn_logits(mixed_qk), mixed_qk)
        weighted = (pooled_k[:, :, None, :] * heads(mixed_q)).transpose(
            1, 2).reshape(B, T, dim)
        if tp is None:
            return self.dropout(self.transform(weighted) + mixed_q)
        t = self.transform
        dt = t.compute_dtype
        out = F.linear(weighted.to(dt), t.weight.to(dt)) \
            + embed_slice(mixed_q, tp, self.dim)
        return self.dropout(reduce_from_model(out, tp) + t.bias.to(dt))


class FastStack(PreNormBlocks):
    def __init__(self, model_config, side):
        super().__init__(model_config, side)
        n_head = self.cfg[f"{side}_head"]
        nh = self.d_model // n_head
        q_logits = Linear(self.d_model, nh, dtype=self.dtype)
        k_logits = Linear(self.d_model, nh, dtype=self.dtype)
        self.layer_stack = PreNormStack(
            [PreNorm(self.d_model, FastAttention(
                self.d_model, n_head, self.cfg[f"{side}_dropout"], self.dtype,
                q_logits, k_logits), self.dtype), self.ff()]
            for _ in range(self.cfg[f"{side}_layer"]))


TextEncoder, Decoder = make_blocks(FastStack)
