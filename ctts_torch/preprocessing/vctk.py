"""VCTK corpus → raw_data normalization on the host
(ctts_tpu/preprocessing/vctk.py; reference preprocessor/vctk.py:11-45):
per-speaker flac/wav + txt → resampled .wav + cleaned .lab."""

import os

import numpy as np

from ctts_torch.preprocessing.audio_io import load_wav, save_wav
from ctts_torch.text import _clean_text


def prepare_align(config):
    in_dir = config["path"]["corpus_path"]
    out_dir = config["path"]["raw_path"]
    wav_tag = config["path"].get("wav_tag", "mic1")
    wav_dir = config["path"].get("wav_dir", "wav48_silence_trimmed")
    txt_dir = config["path"].get("txt_dir", "txt")
    sampling_rate = config["preprocessing"]["audio"]["sampling_rate"]
    max_wav_value = config["preprocessing"]["audio"]["max_wav_value"]
    cleaners = config["preprocessing"]["text"]["text_cleaners"]

    for speaker in sorted(os.listdir(os.path.join(in_dir, txt_dir))):
        spk_txt = os.path.join(in_dir, txt_dir, speaker)
        if not os.path.isdir(spk_txt):
            continue
        os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
        for txt_name in sorted(os.listdir(spk_txt)):
            if not txt_name.endswith(".txt"):
                continue
            base_name = txt_name[:-4]
            with open(os.path.join(spk_txt, txt_name)) as f:
                text = _clean_text(f.readline().strip("\n"), cleaners)
            wav_path = os.path.join(in_dir, wav_dir, speaker,
                                    f"{base_name}_{wav_tag}.wav")
            if not os.path.exists(wav_path):
                # flac requires soundfile; skip silently like missing files
                continue
            wav, _ = load_wav(wav_path, sampling_rate)
            peak = max(np.abs(wav).max(), 1e-5)
            wav = wav / peak * (max_wav_value - 1) / max_wav_value
            save_wav(os.path.join(out_dir, speaker, f"{base_name}.wav"),
                     wav, sampling_rate, max_wav_value)
            with open(os.path.join(out_dir, speaker, f"{base_name}.lab"),
                      "w") as lab:
                lab.write(text)
