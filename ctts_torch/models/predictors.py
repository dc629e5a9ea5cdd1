"""Variance predictors (ctts_tpu/models/predictors.py).

Conv → ReLU → LayerNorm → dropout stacks with a final linear head; the
pitch/energy predictors add learned-alpha sinusoidal positions. Each conv
layer is an ``nn.Sequential`` laid out like upstream's
``(pad, conv, relu, layer_norm, dropout)``, so its parameters sit at
``conv.{i}.1`` and ``conv.{i}.3``; its conv pads SAME or LEFT (causal) as
``ffn_padding`` says. The caller scales the gradient into a predictor with
:func:`ctts_torch.models.blocks.grad_scale`.

The duration head's width follows ``dur_loss``: 1 (log-duration) for mse
and huber, 15 for mog (a 5-component mixture over log(d+1): weight logits,
means, log-sigmas), 32 for crf (emission scores of the duration classes
0..31, whose CRF parameters the predictor holds at ``crf``, torchcrf's
names). ``PitchPredictorAR`` is the autoregressive frame-pitch head: the
conv trunk, then a GRU over [conv feature ‖ previous f0] and a linear head.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import (Conv1d, Dropout, LayerNorm, Linear,
                                      SinusoidalPositionalEmbedding)
from ctts_torch.ops.crf import crf_log_likelihood, viterbi_decode


class ConvStack(nn.ModuleList):
    def __init__(self, n_layers, in_chans, n_chans, kernel_size, dropout,
                 padding="SAME"):
        super().__init__(
            nn.Sequential(nn.Identity(),
                          Conv1d(in_chans if i == 0 else n_chans, n_chans,
                                 kernel_size, padding=padding),
                          nn.ReLU(), LayerNorm(n_chans), Dropout(dropout))
            for i in range(n_layers))

    def forward(self, x, padding_mask=None):
        for layer in self:
            x = layer(x)
            if padding_mask is not None:
                x = x.masked_fill(padding_mask[..., None], 0.0)
        return x


DUR_HEAD_WIDTH = {"mse": 1, "huber": 1, "mog": 15, "crf": 32}


class DurationCRF(nn.Module):
    """The 32-class duration CRF's parameters (torchcrf.CRF's names; drawn
    from U(-0.1, 0.1) as torchcrf does); the algorithms live in
    :mod:`ctts_torch.ops.crf`. ``valid`` masks are True at valid."""

    def __init__(self, num_tags=32):
        super().__init__()
        self.start_transitions = nn.Parameter(
            torch.empty(num_tags).uniform_(-0.1, 0.1))
        self.end_transitions = nn.Parameter(
            torch.empty(num_tags).uniform_(-0.1, 0.1))
        self.transitions = nn.Parameter(
            torch.empty(num_tags, num_tags).uniform_(-0.1, 0.1))

    def log_likelihood(self, emissions, tags, valid):
        return crf_log_likelihood(emissions, tags, valid,
                                  self.start_transitions,
                                  self.end_transitions, self.transitions)

    def decode(self, emissions, valid):
        return viterbi_decode(emissions, valid, self.start_transitions,
                              self.end_transitions, self.transitions)


class DurationPredictor(nn.Module):
    """Log-domain duration head: [B, T] for mse/huber, [B, T, 15 | 32] for
    mog/crf (float32, zero at padding)."""

    def __init__(self, in_chans, n_layers=2, n_chans=256, kernel_size=3,
                 dropout=0.5, padding="SAME", dur_loss="mse"):
        super().__init__()
        if dur_loss not in DUR_HEAD_WIDTH:
            raise ValueError(f"unknown dur_loss {dur_loss!r}")
        self.dur_loss = dur_loss
        self.conv = ConvStack(n_layers, in_chans, n_chans, kernel_size,
                              dropout, padding)
        self.linear = Linear(n_chans, DUR_HEAD_WIDTH[dur_loss])
        if dur_loss == "crf":
            self.crf = DurationCRF(DUR_HEAD_WIDTH["crf"])

    def forward(self, x, padding_mask):
        x = self.linear(self.conv(x, padding_mask))
        x = x.masked_fill(padding_mask[..., None], 0.0).float()
        return x[..., 0] if self.dur_loss in ("mse", "huber") else x


def mog_split(params):
    """[..., 15] → (weight logits, means, log-sigmas), each [..., 5]."""
    return params.chunk(3, dim=-1)


def mog_nll(params, y):
    """Negative log-likelihood of y [B, T] (= log(d+1)) under the mixture
    params [B, T, 15], [B, T]; the JAX function's order of operations."""
    w, mu, ls = mog_split(params)
    logw = F.log_softmax(w, dim=-1)
    z = (y[..., None] - mu) * torch.exp(-ls)
    comp = -0.5 * z * z - ls - 0.5 * math.log(2.0 * math.pi)
    return -torch.logsumexp(logw + comp, dim=-1)


def mog_mean(params):
    """The posterior-mean log-duration E[y], [B, T]."""
    w, mu, _ = mog_split(params)
    return torch.sum(F.softmax(w, dim=-1) * mu, dim=-1)


class PitchPredictor(nn.Module):
    """Pitch/CWT/energy head with learned-alpha positions → [B, T, odim]
    (odim 2 for frame f0 + uv, 1 for ph and energy, 10/11 for cwt)."""

    def __init__(self, in_chans, odim=2, n_layers=2, n_chans=256,
                 kernel_size=5, dropout=0.5, padding="SAME",
                 max_positions=4096):
        super().__init__()
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.embed_positions = SinusoidalPositionalEmbedding(
            in_chans, max_positions)
        self.conv = ConvStack(n_layers, in_chans, n_chans, kernel_size,
                              dropout, padding)
        self.linear = Linear(n_chans, odim)

    def forward(self, x, padding_mask):
        x = x + self.pos_embed_alpha * self.embed_positions(padding_mask)
        return self.linear(self.conv(x)).float()


EnergyPredictor = PitchPredictor


class PitchPredictorAR(nn.Module):
    """Autoregressive frame pitch (ctts_tpu's ``PitchPredictorAR``): the
    PitchPredictor conv trunk, then frame t from a GRU over [trunk feature
    ‖ f0 of frame t-1] and a linear head.

    With ``f0`` given (training with dropout on, teacher forcing) the
    inputs are known up front, so the whole sequence is one ``nn.GRU``
    call; without it each frame's predicted f0 feeds the next, a host loop
    of one GRU cell step a frame. The upstream model has no such module,
    so the names are chosen here: ``gru`` (an ``nn.GRU``,
    ``weight_ih_l0`` ...) and ``head``. flax's GRU cell puts no bias on
    the hidden projections of r and z, so the cell runs with the hidden
    bias [0 | 0 | b_hn]: ``bias_hh_l0[:2H]`` never enters the function,
    takes no gradient and stays at its zero init, and torch's cell
    computes flax's."""

    def __init__(self, in_chans, odim=2, n_layers=2, n_chans=256,
                 kernel_size=5, dropout=0.5, padding="SAME",
                 max_positions=4096):
        super().__init__()
        self.n_chans = n_chans
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.embed_positions = SinusoidalPositionalEmbedding(
            in_chans, max_positions)
        self.conv = ConvStack(n_layers, in_chans, n_chans, kernel_size,
                              dropout, padding)
        self.gru = nn.GRU(n_chans + 1, n_chans, batch_first=True)
        self.head = Linear(n_chans, odim)
        with torch.no_grad():
            self.gru.bias_hh_l0[:2 * n_chans].zero_()

    def _hidden_bias(self):
        """[0 | 0 | b_hn]: flax's cell has no hidden bias on r and z."""
        b = self.gru.bias_hh_l0
        return torch.cat([b.new_zeros(2 * self.n_chans),
                          b[2 * self.n_chans:]])

    def forward(self, x, padding_mask, f0=None):
        x = x + self.pos_embed_alpha * self.embed_positions(padding_mask)
        h = self.conv(x).float()
        b_hh = self._hidden_bias()
        if f0 is not None:                 # shift right: frame t sees t-1
            forced = F.pad(f0[:, :-1], (1, 0))
            y, _ = torch.func.functional_call(
                self.gru, {"bias_hh_l0": b_hh},
                (torch.cat([h, forced[..., None].float()], -1),))
            return self.head(y).float()
        # the free run steps the same weights through torch.gru_cell, which
        # (unlike cuDNN's RNN in eval mode) also back-propagates
        g = self.gru
        B, T = h.shape[:2]
        state = h.new_zeros(B, self.n_chans)
        prev = h.new_zeros(B, 1)
        out = []
        for t in range(T):
            state = torch.gru_cell(torch.cat([h[:, t], prev], -1), state,
                                   g.weight_ih_l0, g.weight_hh_l0,
                                   g.bias_ih_l0, b_hh)
            o = self.head(state).float()
            prev = o[:, :1]
            out.append(o)
        return torch.stack(out, dim=1)                 # [B, T, odim]


class CwtStatsLayers(nn.Sequential):
    """MLP predicting per-utterance (f0_mean, f0_std) from the first encoder
    frame; upstream's ``Sequential(Linear, ReLU, Linear, ReLU, Linear)``."""

    def __init__(self, in_features, hidden=128):
        super().__init__(Linear(in_features, hidden), nn.ReLU(),
                         Linear(hidden, hidden), nn.ReLU(),
                         Linear(hidden, 2))
