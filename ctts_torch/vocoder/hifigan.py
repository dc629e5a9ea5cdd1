"""HiFi-GAN V1 generator (ctts_tpu/vocoder/hifigan.py), upstream names.

conv_pre(k7) → 4 × [leaky_relu(0.1), transposed-conv upsample (k 16/16/4/4,
stride 8/8/2/2), mean of 3 ResBlock1 (k 3/7/11, dilations 1/3/5)] →
leaky_relu(0.01) → conv_post(k7) → tanh. Plain ``conv1d`` /
``conv_transpose1d`` with weight norm folded, so an upstream
``generator_*.pth.tar`` loads through :func:`load_generator`. Computes in
``dtype`` (bf16 by default in :func:`ctts_torch.utils.model.get_vocoder`)
and returns float32.

``CTTS_FUSE_RESBLOCK=1`` (read at every call, as in the JAX package) runs
each ResBlock1 with C ≤ 128 and T % 128 == 0 as one fused chain
(:func:`ctts_torch.ops.fused_resblock.fused_resblock1`): the CUDA kernel on
the card, its plain version on the CPU. HiFi-GAN V1 at the probe's
[4, 1152] mels takes it at levels 1-3 (C = 128, 64, 32), 9 launches a
forward; level 0 (C = 256) stays on cuDNN.
"""

import os

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.ops.fused_resblock import (fused_resblock1, pack_weights,
                                           stack_convs)

LRELU_SLOPE = 0.1

V1_CONFIG = {
    "upsample_rates": (8, 8, 2, 2),
    "upsample_kernel_sizes": (16, 16, 4, 4),
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": (3, 7, 11),
    "resblock_dilation_sizes": ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    "num_mels": 80,
}


def _conv(cin, cout, k, d=1):
    return nn.Conv1d(cin, cout, k, dilation=d, padding=d * (k - 1) // 2)


class ResBlock1(nn.Module):
    def __init__(self, channels, kernel_size, dilations):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(_conv(channels, channels, kernel_size, d)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(_conv(channels, channels, kernel_size)
                                    for _ in dilations)
        self._stacked = {}

    def _cached(self, dtype):
        params = [p for c in (*self.convs1, *self.convs2)
                  for p in (c.weight, c.bias)]
        key = tuple((p.data_ptr(), p._version) for p in params)
        hit = self._stacked.get(dtype)
        if hit is None or hit[0] != key:
            hit = [key, (stack_convs(self.convs1, dtype),
                         stack_convs(self.convs2, dtype)), None]
            self._stacked[dtype] = hit
        return hit

    def stacked(self, dtype):
        """``convs1`` and ``convs2`` as the fused chain takes them, weights
        rounded to ``dtype``: built once per dtype and kept until a
        parameter is replaced or changed in place."""
        return self._cached(dtype)[1]

    def packed(self, dtype):
        """:func:`~ctts_torch.ops.fused_resblock.pack_weights` of
        :meth:`stacked`, the kernel's layout, kept beside it."""
        hit = self._cached(dtype)
        if hit[2] is None:
            hit[2] = pack_weights(*hit[1], dtype)
        return hit[2]

    def forward(self, x):
        if (os.environ.get("CTTS_FUSE_RESBLOCK", "") == "1"
                and x.shape[1] <= 128 and x.shape[2] % 128 == 0):
            dev = x.device.type
            if torch.is_autocast_enabled(dev):
                x = x.to(torch.get_autocast_dtype(dev))
            return fused_resblock1(x.contiguous(), *self.stacked(x.dtype),
                                   self.kernel_size, self.dilations,
                                   packed=self.packed(x.dtype)
                                   if x.is_cuda else None)
        for c1, c2 in zip(self.convs1, self.convs2):
            y = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = x + y
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, config=None, dtype=torch.float32):
        super().__init__()
        cfg = config or V1_CONFIG
        self.compute_dtype = dtype
        ch = cfg["upsample_initial_channel"]
        self.num_kernels = len(cfg["resblock_kernel_sizes"])
        self.conv_pre = _conv(cfg["num_mels"], ch, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u,
                                               padding=(k - u) // 2))
            ch //= 2
            for rk, rd in zip(cfg["resblock_kernel_sizes"],
                              cfg["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = _conv(ch, 1, 7)

    def forward(self, mel):
        """mel: [B, T, n_mel] log-mel → wav [B, T·256] float32."""
        with torch.autocast(mel.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            x = self.conv_pre(mel.transpose(1, 2))
            for i, up in enumerate(self.ups):
                x = up(F.leaky_relu(x, LRELU_SLOPE))
                blocks = self.resblocks[i * self.num_kernels:
                                        (i + 1) * self.num_kernels]
                acc = None
                for block in blocks:
                    y = block(x)
                    acc = y if acc is None else acc + y
                x = acc / self.num_kernels
            # the final activation uses torch's default slope 0.01
            x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x.float())[:, 0, :]


def load_generator(path, map_location="cpu"):
    """Upstream HiFi-GAN checkpoint (a dict with key "generator", weight
    norm folded or not) → a state_dict for :class:`HiFiGANGenerator`."""
    ckpt = torch.load(path, map_location=map_location, weights_only=True)
    sd = ckpt["generator"] if "generator" in ckpt else ckpt
    out = {}
    for name, value in sd.items():
        if name.endswith(".weight_v"):
            prefix = name[:-len(".weight_v")]
            g = sd[prefix + ".weight_g"]
            norm = value.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
            out[prefix + ".weight"] = g * value / norm
        elif not name.endswith(".weight_g"):
            out[name] = value
    return out
