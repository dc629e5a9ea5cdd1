"""Wav IO, resampling and silence trimming on the host, without librosa
(ctts_tpu/preprocessing/audio_io.py)."""

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly
from math import gcd


def load_wav(path, target_sr=None):
    """Read a wav file → (float32 mono in [-1,1], sr), resampled if asked."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        g = gcd(int(target_sr), int(sr))
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return wav, sr


def save_wav(path, wav, sr, max_wav_value=32768.0):
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * (max_wav_value - 1)).astype(np.int16))


def trim_silence(wav, top_db=23, frame_length=2048, hop_length=512):
    """librosa.effects.trim semantics: strip leading/trailing frames more
    than top_db below the signal peak. Returns (trimmed, (start, end))."""
    if len(wav) < frame_length:
        return wav, (0, len(wav))
    n_frames = 1 + (len(wav) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1))
    ref = rms.max()
    db = 20 * np.log10(np.maximum(rms, 1e-10) / max(ref, 1e-10))
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return wav, (0, len(wav))
    start = keep[0] * hop_length
    end = min(len(wav), keep[-1] * hop_length + frame_length)
    return wav[start:end], (start, end)
