"""Mel-spectrogram featurization on the device (ctts_tpu/audio/stft.py).

The reference TacotronSTFT (audio/stft.py:22-185): a hann-windowed STFT
with reflect padding of n_fft/2 (so 1 + T // hop frames), the slaney mel
filterbank (librosa.filters.mel semantics, computed once in float64 numpy),
log dynamic-range compression log(clamp(x, 1e-5)), and the frame energy as
the L2 norm of the linear magnitudes.

:class:`TacotronSTFT` holds the window and the filterbank as buffers and
featurizes a ``[B, T]`` batch on the device it lives on. The frames are
windowed in float32 and transformed in float64, as numpy's ``rfft`` of the
JAX package's float32 frames is, so that bins far below a frame's loudest
keep their digits through the log.
"""

import numpy as np
import torch
import torch.nn.functional as F

# ---- slaney mel scale + filterbank (librosa.filters.mel semantics) ------ #

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mel = f / _F_SP
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ)
                    / _LOGSTEP, mel)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = _F_SP * m
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


def mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax=None):
    """[n_mels, 1 + n_fft//2] slaney-normalized triangular filterbank."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    fftfreqs = np.linspace(0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                    n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def hann_window(win_length, n_fft):
    """Periodic hann, zero-padded to n_fft about the center (scipy
    get_window + librosa pad_center semantics)."""
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win_length) / win_length)
    pad = (n_fft - win_length) // 2
    return np.pad(w, (pad, n_fft - win_length - pad)).astype(np.float32)


def dynamic_range_compression(x, C=1, clip_val=1e-5):
    """log(clamp(x, clip_val) · C), for a tensor or an array."""
    if torch.is_tensor(x):
        return torch.log(torch.clamp(x, min=clip_val) * C)
    return np.log(np.clip(x, clip_val, None) * C)


def dynamic_range_decompression(x, C=1):
    if torch.is_tensor(x):
        return torch.exp(x) / C
    return np.exp(x) / C


def stft_magnitudes(y, window, hop, dtype=torch.float32):
    """|STFT| of float32 ``y`` [B, T]: reflect padding of n_fft/2, frames
    windowed in float32, the transform in float64; returns ``dtype``
    [B, 1 + T // hop, 1 + n_fft//2]."""
    n_fft = window.shape[0]
    pad = n_fft // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames.double(), dim=-1).abs().to(dtype)


class TacotronSTFT(torch.nn.Module):
    def __init__(self, filter_length, hop_length, win_length, n_mel_channels,
                 sampling_rate, mel_fmin, mel_fmax):
        super().__init__()
        self.n_fft = filter_length
        self.hop = hop_length
        self.register_buffer("window", torch.from_numpy(
            hann_window(win_length, filter_length)))
        self.register_buffer("mel_basis", torch.from_numpy(mel_filterbank(
            sampling_rate, filter_length, n_mel_channels, mel_fmin,
            mel_fmax)))

    def mel_spectrogram(self, y):
        """y: [B, T] float in [-1, 1] → (log-mel [B, n_mel, F], energy
        [B, F]) with F = 1 + T // hop (audio/stft.py:166-185)."""
        y = y.to(self.window.device, torch.float32)
        if y.min().item() < -1 or y.max().item() > 1:
            raise ValueError("mel_spectrogram takes audio in [-1, 1]")
        # float32 magnitudes, as numpy's; the filterbank product and the
        # norm sum in float64 and round once, so their float32 results do
        # not hang on the order a library or a thread count sums in
        mag = stft_magnitudes(y, self.window, self.hop).double()
        mel = torch.matmul(self.mel_basis.double(), mag.transpose(1, 2))
        return (dynamic_range_compression(mel.float()),
                torch.linalg.vector_norm(mag, dim=-1).float())
