"""Shared building blocks ([B, T, C] layout), ctts_tpu/models/blocks.py.

Parameters are float32, as in the JAX package; a module built with
``dtype=torch.bfloat16`` casts its input and weights to bf16 where it
computes (the flax ``dtype`` knob), and LayerNorm normalizes in float32
before casting back. Parameter names follow the upstream PyTorch model so
its state_dicts load as they are.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoid_table(num_positions, dim, dtype=torch.float32):
    """tensor2tensor-style [sin | cos] table (denominator half - 1); row 0
    (the padding position) is zero."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32)
                     * -(math.log(10000.0) / (half - 1)))
    pos = (torch.arange(num_positions, dtype=torch.float32)[:, None]
           * freq[None, :])
    emb = torch.cat([torch.sin(pos), torch.cos(pos)], dim=1)
    if dim % 2 == 1:
        emb = torch.cat([emb, torch.zeros(num_positions, 1)], dim=1)
    emb[0] = 0.0
    return emb.to(dtype)


def interleaved_sinusoid_table(num_positions, dim):
    """The classic per-dimension table (ctts_tpu/models/transformer.py
    ``_sinusoid_encoding``): angle pos / 10000^(2·(i//2)/dim), sin on even
    dims and cos on odd ones, row 0 included. float32, computed in float64
    as numpy does there."""
    pos = torch.arange(num_positions, dtype=torch.float64)[:, None]
    i = torch.arange(dim, dtype=torch.float64)[None, :]
    angle = pos / torch.pow(10000.0, 2 * torch.div(i, 2, rounding_mode="floor")
                            / dim)
    table = torch.zeros(num_positions, dim, dtype=torch.float32)
    table[:, 0::2] = torch.sin(angle[:, 0::2]).float()
    table[:, 1::2] = torch.cos(angle[:, 1::2]).float()
    return table


def dtype_of(model_config):
    """The stacks' compute dtype: bfloat16 when ``compute_dtype`` says so,
    else float32 (parameters stay float32 either way)."""
    return (torch.bfloat16 if model_config.get("compute_dtype") == "bfloat16"
            else torch.float32)


def positions_from_mask(padding_mask):
    """Non-pad tokens numbered 1..len, pads 0."""
    nonpad = (~padding_mask).long()
    return torch.cumsum(nonpad, dim=1) * nonpad


class SinusoidalPositionalEmbedding(nn.Module):
    """Padding-aware sinusoidal positions from a fixed table; positions past
    ``max_positions`` reuse its last row."""

    def __init__(self, dim, max_positions=4096, dtype=torch.float32):
        super().__init__()
        self.max_positions = max_positions
        self.register_buffer(
            "table", sinusoid_table(max_positions + 1, dim, dtype),
            persistent=False)

    def forward(self, padding_mask):
        pos = torch.clamp(positions_from_mask(padding_mask),
                          max=self.max_positions)
        return self.table[pos]


class Dropout(nn.Module):
    """Inverted dropout whose mask is drawn from an explicit
    ``torch.Generator`` on the tensor's device (``nn.Dropout`` takes none).
    The identity in eval mode. ``set_dropout_generator`` hands every Dropout
    (and every other module with a ``generator``) the train state's one;
    with none set, the device's default generator is used."""

    def __init__(self, p):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


def set_dropout_generator(module, generator):
    """Hand ``generator`` to every submodule that draws random numbers in
    training: each Dropout, and the reformer stacks' hash rotations (each
    keeps it at ``.generator``)."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def grad_scale(x, scale):
    """x in the forward pass, scale·dx in the backward pass."""
    sg = x.detach()
    return sg + scale * (x - sg)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with eps 1e-12, normalizing in float32 and returning
    ``dtype``."""

    def __init__(self, dim, eps=1e-12, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype``."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv1d(nn.Conv1d):
    """1-D conv over [B, T, C] with SAME padding ((k-1)//2 left, k//2
    right) or LEFT (causal: k-1 left, none right), dilation and groups,
    computing in ``dtype``."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1,
                 bias=True, dtype=torch.float32, groups=1, padding="SAME"):
        super().__init__(in_channels, out_channels, kernel_size,
                         dilation=dilation, bias=bias, groups=groups)
        self.compute_dtype = dtype
        total = dilation * (kernel_size - 1)
        if padding == "SAME":
            self.pad = (total // 2, total - total // 2)
        elif padding == "LEFT":
            self.pad = (total, 0)
        else:
            raise ValueError(f"unknown padding {padding!r}")

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt).transpose(1, 2)
        b = None if self.bias is None else self.bias.to(dt)
        left, right = self.pad
        if left == right:
            y = F.conv1d(x, self.weight.to(dt), b, padding=left,
                         dilation=self.dilation, groups=self.groups)
        else:
            y = F.conv1d(F.pad(x, (left, right)), self.weight.to(dt), b,
                         dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class ConvNorm(nn.Module):
    """Conv1d wrapper with the upstream ``.conv`` parameter path
    (reference ConvNorm)."""

    def __init__(self, in_channels, out_channels, kernel_size=1, dilation=1,
                 bias=True, dtype=torch.float32, groups=1):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           dilation=dilation, bias=bias, dtype=dtype,
                           groups=groups)

    def forward(self, x):
        return self.conv(x)


class MultiHeadAttention(nn.Module):
    """Self-attention over [B, T, C] with a joint QKV projection, no biases
    and scale 1/sqrt(head_dim) (upstream fs2 MultiheadAttention). Padded
    keys get logit -1e9; the attention itself is
    :func:`ctts_torch.ops.attention.fused_attention` with a per-row key
    length, the CUDA kernel on the card."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = Linear(dim, dim, bias=False, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, key_padding_mask):
        from ctts_torch.ops.attention import fused_attention
        from ctts_torch.ops.masks import lengths_from_mask
        B, T, C = x.shape
        H = self.num_heads
        Dh = C // H
        dt = self.compute_dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt))

        def fold(t):                                   # [B, T, C] → [B·H, T, Dh]
            return t.reshape(B, T, H, Dh).transpose(1, 2).reshape(
                B * H, T, Dh).contiguous()

        q, k, v = (fold(t) for t in qkv.split(C, dim=-1))
        lengths = lengths_from_mask(key_padding_mask).repeat_interleave(H)
        out = fused_attention(q, k, v, lengths, scale=1.0 / math.sqrt(Dh))
        out = out.reshape(B, H, T, Dh).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(out)
