"""SSIM on mel-like feature maps (ctts_tpu/ops/ssim.py), for the ``ssim``
CWT loss: the 11×11 Gaussian window with σ = 1.5, SAME padding, and C1/C2
for a unit dynamic range."""

import torch
import torch.nn.functional as F


def gaussian_window(size=11, sigma=1.5):
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]                       # [size, size]


def ssim_map(img1, img2, window_size=11):
    """img: [B, H, W] → per-pixel SSIM [B, H, W]."""
    w = gaussian_window(window_size).to(img1.device)[None, None]

    def filt(x):
        return F.conv2d(x[:, None], w, padding=window_size // 2)[:, 0]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))


def ssim(img1, img2, window_size=11, size_average=True):
    m = ssim_map(img1, img2, window_size)
    return m.mean() if size_average else m.mean(dim=(1, 2))


def ssim_loss(pred, target, bias=6.0, window_size=11):
    """1 − SSIM of the maps shifted by ``bias``, per utterance, averaged
    with each utterance weighted by its share of nonzero target rows."""
    weights = (target.abs().sum(dim=-1, keepdim=True) != 0).float()
    per = 1.0 - ssim(pred + bias, target + bias, window_size,
                     size_average=False)                 # [B]
    w = weights.mean(dim=(1, 2))
    return torch.sum(per * w) / torch.sum(w).clamp(min=1e-8)
