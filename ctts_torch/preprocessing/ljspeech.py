"""LJSpeech corpus → raw_data normalization on the host
(ctts_tpu/preprocessing/ljspeech.py; reference preprocessor/ljspeech.py:11-39):
resample to target rate, scale to max_wav_value, write per-speaker .wav +
cleaned .lab."""

import os

import numpy as np

from ctts_torch.preprocessing.audio_io import load_wav, save_wav
from ctts_torch.text import _clean_text


def prepare_align(config):
    in_dir = config["path"]["corpus_path"]
    out_dir = config["path"]["raw_path"]
    sampling_rate = config["preprocessing"]["audio"]["sampling_rate"]
    max_wav_value = config["preprocessing"]["audio"]["max_wav_value"]
    cleaners = config["preprocessing"]["text"]["text_cleaners"]
    speaker = "LJSpeech"
    os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            base_name, text = parts[0], parts[2]
            text = _clean_text(text, cleaners)
            wav_path = os.path.join(in_dir, "wavs", f"{base_name}.wav")
            if not os.path.exists(wav_path):
                continue
            wav, _ = load_wav(wav_path, sampling_rate)
            peak = max(np.abs(wav).max(), 1e-5)
            wav = wav / peak * (max_wav_value - 1) / max_wav_value
            save_wav(os.path.join(out_dir, speaker, f"{base_name}.wav"),
                     wav, sampling_rate, max_wav_value)
            with open(os.path.join(out_dir, speaker, f"{base_name}.lab"),
                      "w") as lab:
                lab.write(text)
