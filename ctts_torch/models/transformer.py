"""`transformer` block: the classic FastSpeech2 FFT stack
(ctts_tpu/models/transformer.py).

Each layer is post-LN multi-head self-attention (q/k/v and the output
projection without bias, the attention
:func:`ctts_torch.ops.attention.fused_attention` on the folded [B·H, T, dh]
heads, the CUDA kernel on the card) and a post-LN position-wise FFN (conv
k0 → ReLU → conv k1), with padded positions zeroed after each. The
interleaved sinusoid table is added to the input unscaled; its length is
max(max_seq_len + 1, T), so the decoder does not truncate. Every LayerNorm
has flax's eps 1e-6. The stacks compute in the config's ``compute_dtype``
and return float32.

Parameter paths are the upstream ones that
``ctts_tpu/utils/torch_import.py:_classic_layer`` reads:
``layer_stack.{i}.slf_attn.{w_qs,w_ks,w_vs,fc}.linear``,
``slf_attn.layer_norm``, ``pos_ffn.{w_1,w_2,layer_norm}``, and
``src_word_emb`` in the encoder.
"""

import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import (Conv1d, Dropout, LayerNorm, dtype_of,
                                      interleaved_sinusoid_table)
from ctts_torch.models.conformer import LinearNorm
from ctts_torch.ops.attention import fused_attention
from ctts_torch.ops.masks import lengths_from_mask
from ctts_torch.text.symbols import symbols

EPS = 1e-6


class MultiHeadAttention(nn.Module):
    """Post-LN self-attention: LayerNorm(dropout(fc(attention)) + x).
    Tensor parallel (the mesh's rules): a rank's heads of ``w_qs``, ``w_ks``
    and ``w_vs`` (output rows) and of ``fc`` (input columns)."""

    tp = None

    def __init__(self, n_head, d_model, dropout, dtype):
        super().__init__()
        self.n_head = n_head
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            setattr(self, name, LinearNorm(d_model, d_model, bias=False,
                                           dtype=dtype))
        self.layer_norm = LayerNorm(d_model, eps=EPS, dtype=dtype)
        self.dropout = Dropout(dropout)

    def tp_units(self):
        return self.n_head

    def forward(self, x, padding_mask):
        B, T, C = x.shape
        dh = C // self.n_head
        H = self.n_head // (1 if self.tp is None else self.tp.size)

        def fold(t):                                # [B, T, C] → [B·H, T, dh]
            return t.reshape(B, T, H, dh).transpose(1, 2).reshape(
                B * H, T, dh).contiguous()

        q, k, v = (fold(getattr(self, n)(x)) for n in ("w_qs", "w_ks",
                                                        "w_vs"))
        lengths = lengths_from_mask(padding_mask).repeat_interleave(H)
        out = fused_attention(q, k, v, lengths, scale=dh ** -0.5)
        out = out.reshape(B, H, T, dh).transpose(1, 2).reshape(B, T, H * dh)
        return self.layer_norm(self.dropout(self.fc(out)) + x)


class PositionwiseFeedForward(nn.Module):
    """Conv(k0) → ReLU → Conv(k1) → dropout → LayerNorm(+ x). Tensor
    parallel (the mesh's rules): ``w_1``'s output and ``w_2``'s input
    channels."""

    def __init__(self, d_model, d_inner, kernel, dropout, dtype):
        super().__init__()
        self.w_1 = Conv1d(d_model, d_inner, kernel[0], dtype=dtype)
        self.w_2 = Conv1d(d_inner, d_model, kernel[1], dtype=dtype)
        self.layer_norm = LayerNorm(d_model, eps=EPS, dtype=dtype)
        self.dropout = Dropout(dropout)

    def tp_units(self):
        return self.w_1.out_channels

    def forward(self, x):
        y = self.dropout(self.w_2(F.relu(self.w_1(x))))
        return self.layer_norm(y + x)


class FFTBlock(nn.Module):
    def __init__(self, n_head, d_model, d_inner, kernel, dropout, dtype):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, dropout, dtype)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel,
                                               dropout, dtype)

    def forward(self, x, padding_mask):
        pad = padding_mask[..., None]
        x = self.slf_attn(x, padding_mask).masked_fill(pad, 0.0)
        return self.pos_ffn(x).masked_fill(pad, 0.0)


def add_positions(x, max_seq_len, d_model):
    """x + the interleaved sinusoid table's first T rows (float32)."""
    T = x.shape[1]
    table = interleaved_sinusoid_table(max(max_seq_len + 1, T), d_model)
    return x + table[None, :T].to(x.device)


class _Stack(nn.Module):
    def __init__(self, model_config, side):
        super().__init__()
        cfg = model_config["transformer"]
        self.dtype = dtype_of(model_config)
        self.d_model = cfg[f"{side}_hidden"]
        self.max_seq_len = model_config["max_seq_len"]
        self.layer_stack = nn.ModuleList(
            FFTBlock(cfg[f"{side}_head"], self.d_model,
                     cfg["conv_filter_size"], tuple(cfg["conv_kernel_size"]),
                     cfg[f"{side}_dropout"], self.dtype)
            for _ in range(cfg[f"{side}_layer"]))

    def run_stack(self, x, padding_mask):
        x = add_positions(x, self.max_seq_len, self.d_model).to(self.dtype)
        for layer in self.layer_stack:
            x = layer(x, padding_mask)
        return x.float()


class TextEncoder(_Stack):
    """Token embedding (no padding index: its padding row takes a gradient,
    as in JAX) → FFT stack. Returns (hidden, token embeddings), both
    float32."""

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

