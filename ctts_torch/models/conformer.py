"""`conformer` block (ctts_tpu/models/conformer.py).

Each block is FF(½) → relative-position self-attention → conv module
(pointwise → GLU → depthwise k31 → BatchNorm → swish → pointwise) → FF(½) →
LayerNorm, with padded positions zeroed at the block output only. By default
(``attend_to_padding: true``, the reference's behaviour) the attention sees
the padded keys; ``false`` masks them with -1e9 inside the attention. The
attention is :func:`ctts_torch.ops.relpos_attention.relpos_attention`, the
CUDA kernels on the card.

Every LayerNorm has flax's default eps 1e-6; the conv module's BatchNorm has
flax's arithmetic (``postnet.BatchNorm``) and batch statistics whenever the
module is in training mode, as the JAX stack's ``training=not
deterministic``. Parameter paths are the upstream ones that
``ctts_tpu/utils/torch_import.py:_conformer_layer`` reads:
``layer_stack.{i}.sequential.{0..4}``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import (ConvNorm, Dropout, LayerNorm, Linear,
                                      dtype_of, interleaved_sinusoid_table)
from ctts_torch.models.postnet import BatchNorm
from ctts_torch.ops.relpos_attention import relpos_attention
from ctts_torch.text.symbols import symbols

EPS = 1e-6


class LinearNorm(nn.Module):
    """Upstream ``Linear`` wrapper: the weight lives at ``.linear``."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.linear = Linear(in_features, out_features, bias=bias, dtype=dtype)

    def forward(self, x):
        return self.linear(x)


class PointwiseConv1d(ConvNorm):
    """A k=1 conv (upstream ``.conv`` path), applied as a matmul over the
    channels of [B, T, C], as the JAX package's Dense."""

    def forward(self, x):
        conv = self.conv
        dt = conv.compute_dtype
        return F.linear(x.to(dt), conv.weight[:, :, 0].to(dt),
                        conv.bias.to(dt))


class BatchNormC(BatchNorm):
    """flax BatchNorm with statistics in float32, output in ``dtype``."""

    def __init__(self, features, dtype=torch.float32):
        super().__init__(features)
        self.compute_dtype = dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.compute_dtype)


class FeedForwardModule(nn.Module):
    """LN → Linear(×f) → swish → dropout → Linear → dropout. Tensor
    parallel (the mesh's rules): the expansion's output and the contraction's
    input channels."""

    def __init__(self, dim, expansion, dropout, dtype):
        super().__init__()
        self.sequential = nn.ModuleList([
            LayerNorm(dim, eps=EPS, dtype=dtype),
            LinearNorm(dim, dim * expansion, dtype=dtype), nn.SiLU(),
            Dropout(dropout), LinearNorm(dim * expansion, dim, dtype=dtype),
            Dropout(dropout)])

    def tp_units(self):
        return self.sequential[1].linear.out_features

    def shard_(self, tp):
        self.sequential[3].shard = (-1, tp)

    def forward(self, x):
        for m in self.sequential:
            x = m(x)
        return x


class ConformerConvModule(nn.Module):
    """LN → pointwise(×2) → GLU → depthwise k → BN → swish → pointwise →
    dropout. The depthwise conv has SAME padding and no bias."""

    def __init__(self, dim, kernel_size, expansion, dropout, dtype):
        super().__init__()
        self.sequential = nn.ModuleList([
            # slot 1 is upstream's Transpose: the layout is [B, T, C] here;
            # GLU is a·sigmoid(b) over the channel halves
            LayerNorm(dim, eps=EPS, dtype=dtype), nn.Identity(),
            PointwiseConv1d(dim, dim * expansion, 1, dtype=dtype),
            nn.GLU(dim=-1),
            ConvNorm(dim, dim, kernel_size, bias=False, dtype=dtype,
                     groups=dim),
            BatchNormC(dim, dtype), nn.SiLU(),
            PointwiseConv1d(dim, dim, 1, dtype=dtype), Dropout(dropout)])

    def forward(self, x):
        for m in self.sequential:
            x = m(x)
        return x


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL attention with u/v biases and the relative shift; all
    five projections have no bias. The scale is 1/sqrt(d_model). Its
    ``dropout`` carries the rate and the generator the seed is drawn from
    (``set_dropout_generator`` sets it).

    Tensor parallel (the mesh's rules): a rank's heads of the four input
    projections (output rows), of ``u_bias`` and ``v_bias``, and of
    ``out_proj`` (input columns). Model-group peers draw one seed, and the
    dropout hash is keyed by each head's global index (``head_range``), so
    every head keeps the mask one process gives it."""

    tp = None

    def __init__(self, d_model, num_heads, dropout, dtype):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        dh = d_model // num_heads
        self.compute_dtype = dtype
        for name in ("query_proj", "key_proj", "value_proj", "pos_proj",
                     "out_proj"):
            setattr(self, name, LinearNorm(d_model, d_model, bias=False,
                                           dtype=dtype))
        self.u_bias = nn.Parameter(torch.empty(num_heads, dh))
        self.v_bias = nn.Parameter(torch.empty(num_heads, dh))
        nn.init.xavier_uniform_(self.u_bias)
        nn.init.xavier_uniform_(self.v_bias)
        self.dropout = Dropout(dropout)

    def tp_units(self):
        return self.num_heads

    def forward(self, x, pos_embedding, key_padding_mask=None):
        B, T, _ = x.shape
        H, dh = self.num_heads, self.d_model // self.num_heads
        head_range = None
        if self.tp is not None:
            head_range = (self.tp.bounds(H)[0], H)
            H //= self.tp.size
        if pos_embedding.shape[0] != 1:
            raise ValueError("pos_embedding must be the unbroadcast [1, T, D] "
                             "table")
        q, k, v = (getattr(self, n)(x).reshape(B, T, H, dh)
                   for n in ("query_proj", "key_proj", "value_proj"))
        pos = self.pos_proj(pos_embedding).reshape(T, H, dh).transpose(0, 1)
        p = self.dropout.p if self.training else 0.0
        ctx = relpos_attention(q, k, v, pos, self.u_bias, self.v_bias,
                               1.0 / math.sqrt(self.d_model), dropout_p=p,
                               generator=self.dropout.generator,
                               key_padding_mask=key_padding_mask,
                               head_range=head_range)
        return self.out_proj(ctx.to(self.compute_dtype).reshape(B, T, H * dh))


class MultiHeadedSelfAttentionModule(nn.Module):
    """LN → relative attention → dropout."""

    def __init__(self, d_model, num_heads, dropout, dtype):
        super().__init__()
        self.layer_norm = LayerNorm(d_model, eps=EPS, dtype=dtype)
        self.attention = RelativeMultiHeadAttention(d_model, num_heads,
                                                    dropout, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x, pos_embedding, key_padding_mask=None):
        return self.dropout(self.attention(self.layer_norm(x), pos_embedding,
                                           key_padding_mask))


class Residual(nn.Module):
    """Upstream ResidualConnectionModule: holds its branch at ``.module``."""

    def __init__(self, module):
        super().__init__()
        self.module = module


class ConformerBlock(nn.Module):
    def __init__(self, dim, num_heads, ff_expansion, conv_expansion,
                 conv_kernel_size, dropout, half_step_residual=True,
                 attend_to_padding=True, dtype=torch.float32):
        super().__init__()
        self.f = 0.5 if half_step_residual else 1.0
        self.attend_to_padding = attend_to_padding
        self.sequential = nn.ModuleList([
            Residual(FeedForwardModule(dim, ff_expansion, dropout, dtype)),
            Residual(MultiHeadedSelfAttentionModule(dim, num_heads, dropout,
                                                    dtype)),
            Residual(ConformerConvModule(dim, conv_kernel_size,
                                         conv_expansion, dropout, dtype)),
            Residual(FeedForwardModule(dim, ff_expansion, dropout, dtype)),
            LayerNorm(dim, eps=EPS, dtype=dtype)])

    def forward(self, x, padding_mask, pos_embedding):
        ff1, attn, conv, ff2, norm = self.sequential
        x = x + self.f * ff1.module(x)
        x = x + attn.module(x, pos_embedding, None if self.attend_to_padding
                            else padding_mask)
        x = x + conv.module(x)
        x = x + self.f * ff2.module(x)
        x = norm(x)
        return torch.where(padding_mask[..., None], x.new_zeros(()), x)


class _Stack(nn.Module):
    """The sinusoid table added unscaled, then the blocks; computes in the
    config's dtype and returns float32. The unbroadcast [1, T, D] table
    also feeds every block's ``pos_proj``."""

    def __init__(self, model_config, side):
        super().__init__()
        cfg = model_config["conformer"]
        self.dtype = dtype_of(model_config)
        self.d_model = cfg[f"{side}_hidden"]
        self.max_seq_len = model_config["max_seq_len"]
        self.layer_stack = nn.ModuleList(
            ConformerBlock(self.d_model, cfg[f"{side}_head"],
                           cfg["feed_forward_expansion_factor"],
                           cfg["conv_expansion_factor"],
                           cfg["conv_kernel_size"], cfg[f"{side}_dropout"],
                           cfg["half_step_residual"],
                           cfg.get("attend_to_padding", True), self.dtype)
            for _ in range(cfg[f"{side}_layer"]))

    def run_stack(self, x, padding_mask):
        T = x.shape[1]
        n_pos = max(self.max_seq_len + 1, T)
        table = interleaved_sinusoid_table(n_pos, self.d_model)[None, :T].to(
            x.device)
        x = (x + table).to(self.dtype)
        pos_embedding = table.to(self.dtype)
        for layer in self.layer_stack:
            x = layer(x, padding_mask, pos_embedding)
        return x.float()


class TextEncoder(_Stack):
    """Token embedding (unscaled, the padding row trained as in JAX) →
    conformer stack. Returns (hidden, token embeddings), both float32."""

    def __init__(self, model_config):
        super().__init__(model_config, "encoder")
        self.src_word_emb = nn.Embedding(len(symbols) + 1, self.d_model)

    def forward(self, txt_tokens, padding_mask):
        emb = F.embedding(txt_tokens, self.src_word_emb.weight)
        return self.run_stack(emb, padding_mask), emb


class Decoder(_Stack):
    def __init__(self, model_config):
        super().__init__(model_config, "decoder")

    def forward(self, x, padding_mask):
        return self.run_stack(x, padding_mask), padding_mask
