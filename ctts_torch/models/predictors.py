"""Variance predictors (ctts_tpu/models/predictors.py).

Conv → ReLU → LayerNorm → dropout stacks with a final linear head; the
pitch/energy predictors add learned-alpha sinusoidal positions. Each conv
layer is an ``nn.Sequential`` laid out like upstream's
``(pad, conv, relu, layer_norm, dropout)``, so its parameters sit at
``conv.{i}.1`` and ``conv.{i}.3``. The caller scales the gradient into a
predictor with :func:`ctts_torch.models.blocks.grad_scale`.
"""

import torch
from torch import nn

from ctts_torch.models.blocks import (Conv1d, Dropout, LayerNorm, Linear,
                                      SinusoidalPositionalEmbedding)


class ConvStack(nn.ModuleList):
    def __init__(self, n_layers, in_chans, n_chans, kernel_size, dropout):
        super().__init__(
            nn.Sequential(nn.Identity(),
                          Conv1d(in_chans if i == 0 else n_chans, n_chans,
                                 kernel_size),
                          nn.ReLU(), LayerNorm(n_chans), Dropout(dropout))
            for i in range(n_layers))

    def forward(self, x, padding_mask=None):
        for layer in self:
            x = layer(x)
            if padding_mask is not None:
                x = x.masked_fill(padding_mask[..., None], 0.0)
        return x


def _check_padding(padding):
    if padding != "SAME":
        raise NotImplementedError("predictor padding other than SAME is not "
                                  "ported yet")


class DurationPredictor(nn.Module):
    """Log-domain duration head with the mse/huber head (width 1)."""

    def __init__(self, in_chans, n_layers=2, n_chans=256, kernel_size=3,
                 dropout=0.5, padding="SAME", dur_loss="mse"):
        super().__init__()
        _check_padding(padding)
        if dur_loss not in ("mse", "huber"):
            raise NotImplementedError(
                f"dur_loss {dur_loss!r} (mog/crf duration heads) is not "
                "ported yet (ROADMAP.md §1 item 10)")
        self.conv = ConvStack(n_layers, in_chans, n_chans, kernel_size,
                              dropout)
        self.linear = Linear(n_chans, 1)

    def forward(self, x, padding_mask):
        x = self.linear(self.conv(x, padding_mask))
        x = x.masked_fill(padding_mask[..., None], 0.0)
        return x[..., 0].float()                       # [B, T] log-durations


class PitchPredictor(nn.Module):
    """Pitch/CWT/energy head with learned-alpha positions → [B, T, odim]."""

    def __init__(self, in_chans, odim=2, n_layers=2, n_chans=256,
                 kernel_size=5, dropout=0.5, padding="SAME",
                 max_positions=4096):
        super().__init__()
        _check_padding(padding)
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.embed_positions = SinusoidalPositionalEmbedding(
            in_chans, max_positions)
        self.conv = ConvStack(n_layers, in_chans, n_chans, kernel_size,
                              dropout)
        self.linear = Linear(n_chans, odim)

    def forward(self, x, padding_mask):
        x = x + self.pos_embed_alpha * self.embed_positions(padding_mask)
        return self.linear(self.conv(x)).float()


EnergyPredictor = PitchPredictor


class CwtStatsLayers(nn.Sequential):
    """MLP predicting per-utterance (f0_mean, f0_std) from the first encoder
    frame; upstream's ``Sequential(Linear, ReLU, Linear, ReLU, Linear)``."""

    def __init__(self, in_features, hidden=128):
        super().__init__(Linear(in_features, hidden), nn.ReLU(),
                         Linear(hidden, hidden), nn.ReLU(),
                         Linear(hidden, 2))
