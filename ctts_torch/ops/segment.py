"""Per-phoneme means of frame-level features (ctts_tpu/ops/segment.py)."""

import torch


def phoneme_mean_by_mel2ph(frame_values, mel2ph, t_txt):
    """frame_values [B, T_mel]; mel2ph [B, T_mel], 1-based (0 = pad).
    Returns [B, t_txt]; a phoneme with no frame gets 0 (sum / max(count, 1))."""
    B = frame_values.shape[0]
    idx = mel2ph.long()
    sums = frame_values.new_zeros(B, t_txt + 1).scatter_add_(
        1, idx, frame_values)
    counts = frame_values.new_zeros(B, t_txt + 1).scatter_add_(
        1, idx, torch.ones_like(frame_values))
    return sums[:, 1:] / counts[:, 1:].clamp(min=1.0)
