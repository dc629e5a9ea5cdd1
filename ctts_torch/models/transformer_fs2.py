"""`transformer_fs2` block (ctts_tpu/models/transformer_fs2.py).

Pre-LN self-attention + conv FFN layers (no qkv bias, 9-wide conv with
4×H channels padded as ``ffn_padding`` says, SAME or LEFT (causal), exact
gelu, the k^-0.5 FFN scale), a final LayerNorm and
non-padding re-masking after every layer. The stacks compute in the
config's ``compute_dtype`` (bf16 on the default path) and return float32.
Parameter paths match upstream: ``layers.{i}.op.{layer_norm1, self_attn,
layer_norm2, ffn}``, ``layer_norm``, ``embed_tokens``, ``pos_embed_alpha``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import (Conv1d, Dropout, LayerNorm, Linear,
                                      MultiHeadAttention,
                                      SinusoidalPositionalEmbedding, dtype_of)
from ctts_torch.text.symbols import symbols


class FFNLayer(nn.Module):
    """Conv(k) → ×k^-0.5 → gelu → dropout → Linear. Tensor parallel
    (the mesh's rules): ``ffn_1``'s output channels and ``ffn_2``'s input
    channels."""

    def __init__(self, hidden, filter_size, kernel_size, dropout, act="gelu",
                 dtype=torch.float32, padding="SAME"):
        super().__init__()
        if act not in ("gelu", "relu", "swish"):
            raise ValueError(f"unknown ffn_act {act!r}")
        self.kernel_size = kernel_size
        self.act = act
        self.ffn_1 = Conv1d(hidden, filter_size, kernel_size, dtype=dtype,
                            padding=padding)
        self.dropout = Dropout(dropout)
        self.ffn_2 = Linear(filter_size, hidden, dtype=dtype)

    def tp_units(self):
        return self.ffn_1.out_channels

    def shard_(self, tp):
        self.dropout.shard = (-1, tp)

    def forward(self, x):
        x = self.ffn_1(x) * self.kernel_size ** -0.5
        if self.act == "gelu":
            x = F.gelu(x)
        elif self.act == "relu":
            x = F.relu(x)
        else:
            x = F.silu(x)
        return self.ffn_2(self.dropout(x))


class EncSALayer(nn.Module):
    """Pre-LN self-attention + FFN with residuals, dropout on both
    branches and non-pad masking."""

    def __init__(self, hidden, num_heads, dropout, kernel_size, act="gelu",
                 dtype=torch.float32, padding="SAME"):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, dtype=dtype)
        self.self_attn = MultiHeadAttention(hidden, num_heads, dtype=dtype)
        self.layer_norm2 = LayerNorm(hidden, dtype=dtype)
        self.ffn = FFNLayer(hidden, 4 * hidden, kernel_size, dropout, act=act,
                            dtype=dtype, padding=padding)
        self.dropout = Dropout(dropout)

    def forward(self, x, padding_mask):
        nonpad = (~padding_mask)[..., None].to(x.dtype)
        residual = x
        x = self.dropout(self.self_attn(self.layer_norm1(x), padding_mask))
        x = (residual + x) * nonpad
        residual = x
        x = self.dropout(self.ffn(self.layer_norm2(x)))
        return (residual + x) * nonpad


class _Layer(nn.Module):
    """Upstream TransformerEncoderLayer: holds the layer as ``.op``."""

    def __init__(self, op):
        super().__init__()
        self.op = op

    def forward(self, x, padding_mask):
        return self.op(x, padding_mask)


class FFTBlocks(nn.Module):
    """Stack of EncSALayers with optional learned-alpha positions and a
    final LayerNorm."""

    def __init__(self, hidden, num_layers, num_heads=2, ffn_kernel_size=9,
                 dropout=0.1, use_pos_embed=True, max_seq_len=2000,
                 act="gelu", dtype=torch.float32, padding="SAME"):
        super().__init__()
        self.use_pos_embed = use_pos_embed
        self.dropout = Dropout(dropout)
        if use_pos_embed:
            self.pos_embed_alpha = nn.Parameter(torch.ones(1))
            self.embed_positions = SinusoidalPositionalEmbedding(
                hidden, max_seq_len, dtype)
        self.layers = nn.ModuleList(
            _Layer(EncSALayer(hidden, num_heads, dropout, ffn_kernel_size,
                              act=act, dtype=dtype, padding=padding))
            for _ in range(num_layers))
        self.layer_norm = LayerNorm(hidden, dtype=dtype)

    def run_layers(self, x, padding_mask):
        nonpad = (~padding_mask)[..., None].to(x.dtype)
        if self.use_pos_embed:
            # float32 alpha × compute-dtype table promotes to float32, as
            # in the JAX package
            x = x + self.pos_embed_alpha * self.embed_positions(padding_mask)
            x = self.dropout(x)
        x = x * nonpad
        for layer in self.layers:
            x = layer(x, padding_mask) * nonpad
        return self.layer_norm(x) * nonpad


class TextEncoder(FFTBlocks):
    """Token embedding (×√H) + positions + FFT stack. Returns (hidden,
    token_embeddings), both float32."""

    def __init__(self, model_config):
        cfg = model_config["transformer_fs2"]
        hidden = cfg["encoder_hidden"]
        dtype = dtype_of(model_config)
        super().__init__(hidden, cfg["encoder_layer"],
                         num_heads=cfg["encoder_head"],
                         ffn_kernel_size=cfg["ffn_kernel_size"],
                         dropout=cfg["encoder_dropout"], use_pos_embed=False,
                         act=model_config["variance_predictor"]["ffn_act"],
                         dtype=dtype, padding=model_config[
                             "variance_predictor"]["ffn_padding"])
        self.hidden = hidden
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(len(symbols) + 1, hidden,
                                         padding_idx=0)
        self.embed_positions = SinusoidalPositionalEmbedding(
            hidden, model_config["max_seq_len"], dtype)

    def forward(self, txt_tokens, padding_mask):
        # a plain lookup: the padding row starts at zero (padding_idx) but
        # takes its gradient, as the JAX package's embedding does
        txt_embs = F.embedding(txt_tokens, self.embed_tokens.weight) \
            * (self.hidden ** 0.5)
        x = self.dropout(txt_embs + self.embed_positions(padding_mask))
        x = self.run_layers(x.to(self.dtype), padding_mask)
        return x.float(), txt_embs

    @property
    def d_model(self):
        return self.hidden


class Decoder(FFTBlocks):
    """Frame-level FFT stack with its own learned-alpha positions."""

    def __init__(self, model_config):
        cfg = model_config["transformer_fs2"]
        dtype = dtype_of(model_config)
        super().__init__(cfg["decoder_hidden"], cfg["decoder_layer"],
                         num_heads=cfg["decoder_head"],
                         ffn_kernel_size=cfg["ffn_kernel_size"],
                         dropout=cfg["decoder_dropout"], use_pos_embed=True,
                         max_seq_len=model_config["max_seq_len"] * 2,
                         act=model_config["variance_predictor"]["ffn_act"],
                         dtype=dtype, padding=model_config[
                             "variance_predictor"]["ffn_padding"])
        self.hidden = cfg["decoder_hidden"]
        self.dtype = dtype

    def forward(self, x, padding_mask):
        x = self.run_layers(x.to(self.dtype), padding_mask)
        return x.float(), padding_mask

    @property
    def d_model(self):
        return self.hidden
