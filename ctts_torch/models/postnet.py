"""PostNet: 5 × (conv k5, 512 channels, BatchNorm, tanh but the last,
dropout 0.5), ctts_tpu/models/postnet.py; the caller adds the residual.

BatchNorm follows flax: in eval mode it normalizes with the running
statistics (``batch_stats`` in the JAX tree); in training mode it normalizes
with the batch's mean and *biased* variance over every frame, padded ones
included, and moves the running statistics by ``0.99·old + 0.01·batch`` with
that same biased variance (``nn.BatchNorm1d`` would use momentum 0.1 and the
unbiased one). Inside ``tensor_parallel.data_parallel`` the batch statistics
are those of the global batch, pooled over the data group, so the running
statistics move alike on every rank."""

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import ConvNorm, Dropout
from ctts_torch.parallel.tensor_parallel import batch_moments


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the channels of [B, T, C] with flax's arithmetic."""

    def __init__(self, features, momentum=0.99, eps=1e-5):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(
                x.transpose(1, 2), self.running_mean, self.running_var,
                self.weight, self.bias, False, 0.0, self.eps).transpose(1, 2)
        mean, square = batch_moments(x, (0, 1))
        var = square - mean * mean
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class _ConvBN(nn.Sequential):
    """Upstream ``Sequential(ConvNorm, BatchNorm1d)`` on [B, T, C]."""

    def __init__(self, cin, cout, kernel_size):
        super().__init__(ConvNorm(cin, cout, kernel_size), BatchNorm(cout))

    def forward(self, x):
        conv, bn = self
        return bn(conv(x))


class PostNet(nn.Module):
    def __init__(self, n_mel_channels=80, embedding_dim=512, kernel_size=5,
                 n_convolutions=5):
        super().__init__()
        dims = ([n_mel_channels] + [embedding_dim] * (n_convolutions - 1)
                + [n_mel_channels])
        self.convolutions = nn.ModuleList(
            _ConvBN(dims[i], dims[i + 1], kernel_size)
            for i in range(n_convolutions))
        self.dropout = Dropout(0.5)

    def forward(self, x):
        """x: [B, T, n_mel] → [B, T, n_mel] float32."""
        last = len(self.convolutions) - 1
        for i, layer in enumerate(self.convolutions):
            x = layer(x)
            if i < last:
                x = torch.tanh(x)
            x = self.dropout(x)
        return x.float()
