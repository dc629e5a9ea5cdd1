"""Pitch for the preprocessor (ctts_tpu/preprocessing/pitch.py).

* the autocorrelation (YIN-flavoured) f0 tracker that stands in for
  parselmouth's ``to_pitch_ac`` (utils/pitch_tools.py:85-132), as one
  batched pass over every frame of an utterance on the device, in float64;
* continuous-f0 interpolation (utils/pitch_tools.py:152-190) and the coarse
  f0 bins, in numpy on the host;
* the CWT of log-f0 comes from :mod:`ctts_torch.ops.cwt`.
"""

import numpy as np
import torch
import torch.nn.functional as F
from scipy.interpolate import interp1d

from ctts_torch import resolve_device

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
_F0_MEL_MIN = 1127 * np.log(1 + F0_MIN / 700)
_F0_MEL_MAX = 1127 * np.log(1 + F0_MAX / 700)

# bytes of float64 lag windows the tracker holds at once
_CHUNK_BYTES = 1 << 28


def f0_to_coarse_np(f0):
    f0_mel = 1127 * np.log(1 + f0 / 700)
    f0_mel[f0_mel > 0] = (f0_mel[f0_mel > 0] - _F0_MEL_MIN) * (F0_BIN - 2) \
        / (_F0_MEL_MAX - _F0_MEL_MIN) + 1
    f0_mel[f0_mel <= 1] = 1
    f0_mel[f0_mel > F0_BIN - 1] = F0_BIN - 1
    f0_coarse = np.rint(f0_mel).astype(np.int64)
    if f0_coarse.size and (f0_coarse.max() > 255 or f0_coarse.min() < 1):
        raise ValueError("coarse f0 bins outside [1, 255]")
    return f0_coarse


def convert_continuous_f0(f0):
    """(utils/pitch_tools.py:152-183)"""
    f0 = np.copy(f0)
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        return uv, f0
    start_f0 = f0[f0 != 0][0]
    end_f0 = f0[f0 != 0][-1]
    start_idx = np.where(f0 == start_f0)[0][0]
    end_idx = np.where(f0 == end_f0)[0][-1]
    f0[:start_idx] = start_f0
    f0[end_idx:] = end_f0
    nz = np.where(f0 != 0)[0]
    cont_f0 = interp1d(nz, f0[nz])(np.arange(0, f0.shape[0]))
    return uv, cont_f0


def get_cont_lf0(f0):
    uv, cont_f0 = convert_continuous_f0(f0)
    return uv, np.log(cont_f0)


def extract_f0_autocorr(wav, sampling_rate, hop_length, f0_min=80.0,
                        f0_max=750.0, voicing_threshold=0.45, device=None):
    """Frame-wise f0 by the cumulative mean normalized difference (YIN),
    one value per hop, 0 for unvoiced frames; float32 numpy.

    Every frame at once in float64 on ``device`` (cuda unless the caller
    asks for another; a tensor's own device when ``wav`` is one), with the
    JAX package's per-frame rules: the frame is the padded signal's
    ``frame_len + lag_max`` samples from ``i·hop``, mean removed; a frame
    whose first ``frame_len`` samples hold energy below 1e-8 is unvoiced;
    c(τ) is a direct sum over the window (no FFT, so it rounds as
    ``np.correlate`` does); the first lag below the threshold is walked to
    its local minimum, else the global minimum is taken; a voiced minimum
    is refined by a parabola clipped to ±1 lag."""
    dev = wav.device if torch.is_tensor(wav) and device is None \
        else resolve_device(device)
    wav = torch.as_tensor(wav).to(dev, torch.float64)
    frame_len = int(sampling_rate * 0.04)              # 40 ms window
    lag_min = int(sampling_rate / f0_max)
    lag_max = min(int(sampling_rate / f0_min), frame_len - 1)
    n_frames = len(wav) // hop_length
    if n_frames == 0 or lag_min >= lag_max:
        return np.zeros(n_frames, np.float32)
    span = frame_len + lag_max
    pad = F.pad(wav, (frame_len // 2, span))
    seg = pad.unfold(0, span, hop_length)[:n_frames]
    seg = seg - seg.mean(dim=1, keepdim=True)          # [N, span]
    win = seg[:, :frame_len]
    e0 = (win * win).sum(dim=1)
    # c(τ) = Σ_{t<W} x[t+τ]·x[t], τ = 0..lag_max, in chunks of frames
    per_frame = (lag_max + 1) * frame_len * 8
    step = max(1, _CHUNK_BYTES // per_frame)
    corr = torch.cat([
        torch.matmul(seg[i:i + step].unfold(1, frame_len, 1),
                     win[i:i + step, :, None])[..., 0]
        for i in range(0, n_frames, step)])            # [N, lag_max + 1]
    sq = F.pad(torch.cumsum(seg * seg, dim=1), (1, 0))
    e_tau = sq[:, frame_len:frame_len + lag_max + 1] - sq[:, :lag_max + 1]
    d = e0[:, None] + e_tau - 2.0 * corr
    lags = torch.arange(1, lag_max + 1, device=dev, dtype=torch.float64)
    cum = torch.cumsum(d[:, 1:], dim=1) / lags
    cmnd = torch.cat([torch.ones_like(d[:, :1]),
                      d[:, 1:] / torch.clamp(cum, min=1e-12)], dim=1)
    window = cmnd[:, lag_min:lag_max]
    below = window < voicing_threshold
    has_below = below.any(dim=1)
    first = torch.argmax(below.to(torch.uint8), dim=1) + lag_min
    # the walk stops at the first j ≥ first with cmnd[j+1] not below
    # cmnd[j], or at lag_max - 1
    j = torch.arange(lag_max, device=dev)
    stop = ~(cmnd[:, 1:] < cmnd[:, :-1])
    stop[:, -1] = True
    walked = torch.argmax((stop & (j >= first[:, None])).to(torch.uint8),
                          dim=1)
    best = torch.where(has_below, walked,
                       torch.argmin(window, dim=1) + lag_min)
    at = cmnd.gather(1, torch.stack([best - 1, best, best + 1], dim=1)
                     .clamp(0, lag_max))
    a, b, c = at.unbind(1)
    voiced = (e0 >= 1e-8) & (b < voicing_threshold)
    denom = a - 2 * b + c
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (a - c) / denom,
                        torch.zeros_like(denom)).clamp(-1, 1)
    refine = (best > 0) & (best < lag_max)
    period = best.to(torch.float64) + torch.where(refine, shift,
                                                  torch.zeros_like(shift))
    f0 = torch.where(voiced, sampling_rate / period, torch.zeros_like(period))
    return f0.to(torch.float32).cpu().numpy()


def constant_window_frames(wav, sampling_rate, hop_length):
    """The frames of :func:`extract_f0_autocorr` whose mean-removed 40 ms
    window is one constant value with energy ≥ 1e-8: digital silence under
    a frame whose lag span reaches sound. Their difference function is
    rounding noise, so the lag they yield hangs on the order of the float
    sums: numpy's per-frame loop, this batched pass on the CPU and on the
    card may each give such a frame another f0 (all voice it). A comparison
    of two trackers leaves out these frames' f0. Boolean [len(wav) // hop],
    on the host."""
    from numpy.lib.stride_tricks import sliding_window_view
    wav = np.asarray(wav, np.float64)
    frame_len = int(sampling_rate * 0.04)
    lag_max = min(int(sampling_rate / 80.0), frame_len - 1)
    n_frames = len(wav) // hop_length
    span = frame_len + lag_max
    pad = np.pad(wav, (frame_len // 2, span))
    seg = sliding_window_view(pad, span)[::hop_length][:n_frames]
    win = (seg - seg.mean(axis=1, keepdims=True))[:, :frame_len]
    return (np.ptp(win, axis=1) == 0) & ((win * win).sum(axis=1) >= 1e-8)


def get_pitch(wav, mel_len, preprocess_config, device=None):
    """The reference get_pitch contract (utils/pitch_tools.py:85-132): f0
    edge-padded or cut to the mel length, and its coarse bins."""
    cfg = preprocess_config["preprocessing"]
    sr = cfg["audio"]["sampling_rate"]
    hop = cfg["stft"]["hop_length"]
    f0 = extract_f0_autocorr(wav, sr, hop, device=device)
    if len(f0) < mel_len:
        f0 = np.pad(f0, (0, mel_len - len(f0)), mode="edge")
    f0 = f0[:mel_len]
    return f0, f0_to_coarse_np(f0)
