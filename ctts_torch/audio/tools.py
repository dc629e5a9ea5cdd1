"""Audio helpers (ctts_tpu/audio/tools.py): a wav's mel through
:class:`ctts_torch.audio.stft.TacotronSTFT`, and mel → wav without a
vocoder (pseudo-inverse mel filterbank + Griffin-Lim in numpy), the vocoder
the synthesize CLI falls back to when no HiFi-GAN weight file exists, as in
the JAX package (ctts_tpu/utils/model.py:101-124)."""

import numpy as np
import torch

from ctts_torch.audio.stft import (dynamic_range_decompression,
                                   hann_window, mel_filterbank)


def get_mel_from_wav(audio, stft):
    """wav [T] (an array or a tensor) → (log-mel [n_mel, F], energy [F]) as
    float32 numpy, featurized on the device ``stft`` lives on
    (ctts_tpu/audio/tools.py:7-11)."""
    y = torch.as_tensor(audio, dtype=torch.float32).clamp(-1, 1)
    mel, energy = stft.mel_spectrogram(y[None])
    return mel[0].cpu().numpy(), energy[0].cpu().numpy()


def griffin_lim_np(mags, n_fft, hop, win, n_iters=30, seed=0):
    """Griffin-Lim phase reconstruction. mags: [B, F, bins]."""
    rng = np.random.RandomState(seed)
    B, F, bins = mags.shape
    window = hann_window(win, n_fft)
    angles = rng.uniform(0, 2 * np.pi, (B, F, bins))
    idx = np.arange(n_fft)[None, :] + hop * np.arange(F)[:, None]
    T = (F - 1) * hop + n_fft
    wsum = np.zeros(T)
    np.add.at(wsum, idx, window ** 2)
    wsum = np.maximum(wsum, 1e-8)

    def istft(spec):
        frames = np.fft.irfft(spec, n=n_fft, axis=-1) * window
        out = np.zeros((B, T), np.float32)
        for b in range(B):
            np.add.at(out[b], idx, frames[b])
        out = out / wsum[None]
        return out[:, n_fft // 2: T - n_fft // 2]

    def stft(y):
        pad = n_fft // 2
        yp = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")
        return np.fft.rfft(yp[:, idx] * window[None, None], axis=-1)

    for _ in range(n_iters):
        signal = istft(mags * np.exp(1j * angles))
        angles = np.angle(stft(signal))
    return istft(mags * np.exp(1j * angles))


def inv_mel_spec_batch(mels, preprocess_config, n_iters=30):
    """mels: [B, T, n_mel] log-compressed → [B, T·hop] float32, peak 0.95."""
    p = preprocess_config["preprocessing"]
    n_fft = p["stft"]["filter_length"]
    hop = p["stft"]["hop_length"]
    win = p["stft"]["win_length"]
    fb = mel_filterbank(p["audio"]["sampling_rate"], n_fft,
                        p["mel"]["n_mel_channels"], p["mel"]["mel_fmin"],
                        p["mel"]["mel_fmax"])
    inv_fb = np.linalg.pinv(fb)
    mel_lin = dynamic_range_decompression(np.asarray(mels))
    mags = np.maximum(np.einsum("km,btm->btk", inv_fb, mel_lin), 1e-8)
    wav = griffin_lim_np(mags, n_fft, hop, win, n_iters=n_iters)
    out = np.asarray(wav, np.float32)
    peak = np.abs(out).max(axis=1, keepdims=True)
    return out / np.maximum(peak, 1e-5) * 0.95
