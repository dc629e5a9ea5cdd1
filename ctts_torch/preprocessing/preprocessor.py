"""Offline featurization: raw_data/ → preprocessed_data/ (the .npy store),
on the device (ctts_tpu/preprocessing/preprocessor.py).

The JAX package's Preprocessor (the reference's preprocessor.py:24-662
without librosa, parselmouth, pycwt, tgt, g2p_en or sklearn's scaler), with
the same files, names and values:

* a dual pipeline per wav: ``unsup`` features from the silence-trimmed
  audio, ``sup`` features from the TextGrid-cut audio
  (process_utterance, preprocessor.py:370-549);
* on the device (``device``, cuda unless the caller asks for another):
  each utterance's mel and energy (:class:`ctts_torch.audio.stft.
  TacotronSTFT`), its f0 (:func:`ctts_torch.preprocessing.pitch.
  extract_f0_autocorr`, float64) and its speaker embedding
  (:class:`ctts_torch.models.speaker.PreDefinedEmbedder`);
* on the host: file IO, trimming, g2p (the lexicon, else the graphemes),
  the CWT of normalized log-f0, scipy's float64 beta-binomial attention
  priors, phone-level energy means, energy outlier removal and in-place
  normalization, stats.json with the same keys, speakers.json, the seeded
  train/val split with pre-defined val lists (preprocessor.py:66-67,
  315-339).
"""

import contextlib
import json
import os
import random
import re

import numpy as np
import torch

from ctts_torch import resolve_device
from ctts_torch.audio.stft import TacotronSTFT
from ctts_torch.audio.tools import get_mel_from_wav
from ctts_torch.ops.cwt import get_lf0_cwt
from ctts_torch.preprocessing.audio_io import load_wav, trim_silence
from ctts_torch.preprocessing.pitch import (constant_window_frames,
                                            get_cont_lf0, get_pitch)
from ctts_torch.preprocessing.textgrid import read_textgrid
from ctts_torch.text import grapheme_to_phoneme, text_to_sequence
from ctts_torch.text.symbols import symbols as _symbols

try:
    from scipy.stats import betabinom
except Exception:                                        # pragma: no cover
    betabinom = None

_SIL_PHONES = ["sil", "sp", "spn"]

# per-worker Preprocessor for the parallel build_from_path pool
_WORKER = None


def _init_worker(preprocess_config, model_config, train_config, device):
    """A spawned worker's Preprocessor, on the device its parent was
    given."""
    global _WORKER
    _WORKER = Preprocessor(preprocess_config, model_config, train_config,
                           device=device)


def _worker_utterance(task):
    tg_path, speaker, basename = task
    return _WORKER.process_utterance(tg_path, speaker, basename)

_DIRS = ["mel_unsup", "mel_sup", "f0_unsup", "f0_sup", "pitch_unsup",
         "pitch_sup", "cwt_spec_unsup", "cwt_spec_sup", "cwt_scales_unsup",
         "cwt_scales_sup", "f0cwt_mean_std_unsup", "f0cwt_mean_std_sup",
         "energy_unsup_frame", "energy_sup_frame", "energy_sup_phone",
         "duration", "mel2ph", "attn_prior", "spker_embed"]


@contextlib.contextmanager
def _one_cpu_thread(device):
    """The device work of one utterance on a single CPU thread where the
    device is the CPU: the multi-threaded FFT and matrix products of the
    CPU libraries gave a spawned worker another result now and then (an
    eighth of the mel bins off by up to 4e-5 once in tens of runs under
    load), and the store must be the same bytes for any worker count."""
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class _RunningStats:
    """StandardScaler.partial_fit equivalent (mean/std accumulation)."""

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sumsq = 0.0

    def update(self, values):
        v = np.asarray(values, np.float64).ravel()
        if v.size:
            self.n += v.size
            self.sum += v.sum()
            self.sumsq += (v ** 2).sum()

    @property
    def mean(self):
        return self.sum / max(self.n, 1)

    @property
    def std(self):
        m = self.mean
        var = self.sumsq / max(self.n, 1) - m * m
        return float(np.sqrt(max(var, 1e-12)))


class Preprocessor:
    def __init__(self, preprocess_config, model_config, train_config,
                 device=None):
        random.seed(train_config["seed"])
        self.device = resolve_device(device)
        p = preprocess_config["preprocessing"]
        self.config = preprocess_config
        # kept for worker re-init (build_from_path parallel path)
        self.model_config = model_config
        self.train_config = train_config
        self.multi_speaker = model_config["multi_speaker"]
        self.in_dir = preprocess_config["path"]["raw_path"]
        self.out_dir = preprocess_config["path"]["preprocessed_path"]
        self.val_size = p["val_size"]
        self.sampling_rate = p["audio"]["sampling_rate"]
        self.hop_length = p["stft"]["hop_length"]
        self.filter_length = p["stft"]["filter_length"]
        self.trim_top_db = p["audio"]["trim_top_db"]
        self.beta_binomial_scaling_factor = \
            p["duration"]["beta_binomial_scaling_factor"]
        self.with_f0 = p["pitch"]["with_f0"]
        self.with_f0cwt = p["pitch"]["with_f0cwt"]
        self.energy_normalization = p["energy"]["normalization"]
        self.stft = TacotronSTFT(
            p["stft"]["filter_length"], p["stft"]["hop_length"],
            p["stft"]["win_length"], p["mel"]["n_mel_channels"],
            p["audio"]["sampling_rate"], p["mel"]["mel_fmin"],
            p["mel"]["mel_fmax"]).to(self.device)
        self.val_unsup_prior = self._val_prior(
            os.path.join(self.out_dir, "val_unsup.txt"))
        self.val_sup_prior = self._val_prior(
            os.path.join(self.out_dir, "val_sup.txt"))
        self.speaker_emb = None
        if self.multi_speaker and p.get("speaker_embedder", "none") != "none":
            from ctts_torch.models.speaker import PreDefinedEmbedder
            self.speaker_emb = PreDefinedEmbedder(preprocess_config,
                                                  device=self.device)
        self.g2p = self._build_g2p(preprocess_config)

    @staticmethod
    def _build_g2p(preprocess_config):
        try:
            from g2p_en import G2p
            return G2p()
        except Exception:
            lex = {}
            lex_path = preprocess_config["path"].get("lexicon_path")
            if lex_path and os.path.exists(lex_path):
                with open(lex_path) as f:
                    for line in f:
                        parts = re.split(r"\s+", line.strip())
                        if parts and parts[0].lower() not in lex:
                            lex[parts[0].lower()] = parts[1:]

            def g2p(word):
                return lex.get(word.lower(), list(word))
            return g2p

    @staticmethod
    def _val_prior(path):
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                return {line.split("|")[0] for line in f}
        return None

    # -------------------------------------------------------------- #

    def build_from_path(self):
        for d in _DIRS:
            os.makedirs(os.path.join(self.out_dir, d), exist_ok=True)

        speakers = {}
        out_unsup, out_sup = [], []
        train_unsup, val_unsup, train_sup, val_sup = [], [], [], []
        filtered_unsup, filtered_sup = set(), set()
        f0s_unsup, f0s_sup = [], []
        e_unsup_frame = _RunningStats()
        e_sup_frame = _RunningStats()
        e_sup_phone = _RunningStats()
        n_frames = 0
        max_seq_len = 0
        mel_min = {"unsup": np.full(80, np.inf), "sup": np.full(80, np.inf)}
        mel_max = {"unsup": np.full(80, -np.inf), "sup": np.full(80, -np.inf)}
        spker_embeds = {}

        sub_dirs = sorted(d for d in os.listdir(self.in_dir)
                          if os.path.isdir(os.path.join(self.in_dir, d)))
        tasks = []
        for i, speaker in enumerate(sub_dirs):
            speakers[speaker] = i
            spk_dir = os.path.join(self.in_dir, speaker)
            for wav_name in sorted(os.listdir(spk_dir)):
                if not wav_name.endswith(".wav"):
                    continue
                basename = wav_name[:-4]
                tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                                       f"{basename}.TextGrid")
                tasks.append((tg_path, speaker, basename))

        # The per-utterance pipeline (trim, STFT, f0, CWT, priors, .npy
        # writes) is embarrassingly parallel; the reference runs it serial
        # (preprocessor.py:92-361). CTTS_PREPROCESS_WORKERS > 1 fans it out
        # over an order-preserving process pool — results reduce in the
        # SAME deterministic order as the serial loop, so stats, splits and
        # every .npy are bit-for-bit identical for any worker count.
        for _, speaker, basename, r in self._run_utterances(tasks):
            if r is None:
                filtered_unsup.add(basename)
                filtered_sup.add(basename)
                continue
            if r["info_unsup"] is not None:
                (val_unsup if (self.val_unsup_prior is not None
                               and basename in self.val_unsup_prior)
                 else (train_unsup if self.val_unsup_prior is not None
                       else out_unsup)).append(r["info_unsup"])
                f0s_unsup.append(r["f0_unsup"])
                e_unsup_frame.update(r["energy_unsup_frame"])
                mel_min["unsup"] = np.minimum(mel_min["unsup"],
                                              r["mel_unsup_min"])
                mel_max["unsup"] = np.maximum(mel_max["unsup"],
                                              r["mel_unsup_max"])
            else:
                filtered_unsup.add(basename)
            if r["info_sup"] is not None:
                (val_sup if (self.val_sup_prior is not None
                             and basename in self.val_sup_prior)
                 else (train_sup if self.val_sup_prior is not None
                       else out_sup)).append(r["info_sup"])
                f0s_sup.append(r["f0_sup"])
                e_sup_frame.update(r["energy_sup_frame"])
                e_sup_phone.update(r["energy_sup_phone"])
                mel_min["sup"] = np.minimum(mel_min["sup"],
                                            r["mel_sup_min"])
                mel_max["sup"] = np.maximum(mel_max["sup"],
                                            r["mel_sup_max"])
            else:
                filtered_sup.add(basename)
            if r["spker_embed"] is not None:
                spker_embeds.setdefault(speaker, []).append(
                    r["spker_embed"])
            n_frames += r["n"]
            max_seq_len = max(max_seq_len, r["n"])

        # per-speaker mean embedding (preprocessor.py:259-263)
        for speaker, embeds in spker_embeds.items():
            np.save(os.path.join(self.out_dir, "spker_embed",
                                 f"{speaker}-spker_embed.npy"),
                    np.mean(embeds, axis=0))
        if len(spker_embeds) > 2:
            self._plot_speaker_tsne(spker_embeds)

        stats = {}
        for tag, f0s in (("unsup", f0s_unsup), ("sup", f0s_sup)):
            if f0s:
                allf0 = np.concatenate(f0s)
                allf0 = allf0[allf0 != 0]
                stats[f"f0_{tag}"] = [float(np.mean(allf0)),
                                      float(np.std(allf0))]
        for name, scaler in (("energy_unsup_frame", e_unsup_frame),
                             ("energy_sup_frame", e_sup_frame),
                             ("energy_sup_phone", e_sup_phone)):
            if scaler.n == 0:
                continue
            mean, std = ((scaler.mean, scaler.std)
                         if self.energy_normalization else (0.0, 1.0))
            vmin, vmax = self._normalize_dir(
                os.path.join(self.out_dir, name), mean, std)
            key = name.replace("_frame", "_frame").replace("_phone", "_phone")
            stats[key] = [float(vmin), float(vmax), float(mean), float(std)]
        for tag in ("unsup", "sup"):
            if np.isfinite(mel_min[tag]).all():
                stats[f"spec_{tag}_min"] = mel_min[tag].tolist()
                stats[f"spec_{tag}_max"] = mel_max[tag].tolist()
        stats["max_seq_len"] = int(max_seq_len)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump(stats, f)

        hours = n_frames * self.hop_length / self.sampling_rate / 3600
        print(f"Total time: {hours:.2f} hours")

        random.shuffle(out_unsup)
        random.shuffle(out_sup)
        if self.val_unsup_prior is None:
            train_unsup = out_unsup[self.val_size:]
            val_unsup = out_unsup[: self.val_size]
        if self.val_sup_prior is None:
            train_sup = out_sup[self.val_size:]
            val_sup = out_sup[: self.val_size]

        for name, lines in (("train_unsup", train_unsup),
                            ("val_unsup", val_unsup),
                            ("train_sup", train_sup),
                            ("val_sup", val_sup)):
            with open(os.path.join(self.out_dir, f"{name}.txt"), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        for name, s in (("filtered_out_unsup", filtered_unsup),
                        ("filtered_out_sup", filtered_sup)):
            with open(os.path.join(self.out_dir, f"{name}.txt"), "w") as f:
                f.write("\n".join(sorted(s)) + ("\n" if s else ""))
        return train_unsup, val_unsup, train_sup, val_sup

    # -------------------------------------------------------------- #

    def _run_utterances(self, tasks):
        """Yield (tg_path, speaker, basename, result) for every task, in
        task order. CTTS_PREPROCESS_WORKERS > 1 runs process_utterance in a
        spawn-based process pool (CUDA cannot be forked; each worker
        rebuilds the Preprocessor from the configs on this one's device,
        sidestepping the unpicklable g2p closure / embedder); imap
        preserves submission order, so the caller's reduction is identical
        to the serial loop's.

        Standard spawn semantics apply: the driving script must be
        import-safe (``if __name__ == "__main__"`` guard, as
        ``ctts_torch/preprocess.py`` has), or workers re-execute it on
        import."""
        n_workers = int(os.environ.get("CTTS_PREPROCESS_WORKERS", "1"))
        if n_workers <= 1 or len(tasks) < 2:
            for tg_path, speaker, basename in tasks:
                yield (tg_path, speaker, basename,
                       self.process_utterance(tg_path, speaker, basename))
            return
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        n_workers = min(n_workers, len(tasks))
        args = (self.config, self.model_config, self.train_config,
                str(self.device))
        with ctx.Pool(n_workers, initializer=_init_worker,
                      initargs=args) as pool:
            for task, r in zip(tasks, pool.imap(_worker_utterance, tasks,
                                                chunksize=4)):
                yield (*task, r)

    def load_audio(self, wav_path):
        """(preprocessor.py:363-368)"""
        wav_raw, _ = load_wav(wav_path, self.sampling_rate)
        wav, (s, e) = trim_silence(wav_raw, top_db=self.trim_top_db,
                                   frame_length=self.filter_length,
                                   hop_length=self.hop_length)
        duration = int((e - s) / self.hop_length)
        return wav_raw, wav, duration

    def process_utterance(self, tg_path, speaker, basename):
        with _one_cpu_thread(self.device):
            return self._process_utterance(tg_path, speaker, basename)

    def _process_utterance(self, tg_path, speaker, basename):
        wav_path = os.path.join(self.in_dir, speaker, f"{basename}.wav")
        text_path = os.path.join(self.in_dir, speaker, f"{basename}.lab")
        unsup_ok = sup_ok = True

        wav_raw, wav, duration = self.load_audio(wav_path)
        spker_embed = (self.speaker_emb(wav)
                       if self.speaker_emb is not None else None)

        with open(text_path) as f:
            raw_text = f.readline().strip("\n")
        phone = grapheme_to_phoneme(raw_text, self.g2p)
        phones = "{" + "}{".join(phone) + "}"
        phones = re.sub(r"\{[^\w\s]?\}", "{sp}", phones)
        text_unsup = phones.replace("}{", " ")
        # the attention prior must agree with the TOKEN count the loader
        # will produce (invalid g2p outputs are dropped by
        # text_to_sequence), so count tokens, not raw phones
        cleaners = self.config["preprocessing"]["text"]["text_cleaners"]
        n_tokens = len(text_to_sequence(text_unsup, cleaners))

        mel, energy = get_mel_from_wav(wav, self.stft)     # [80, F], [F]
        mel = mel[:, :duration]
        energy = energy[:duration]

        out = {"spker_embed": spker_embed, "n": 0}
        f0_unsup = cwt_spec_unsup = cwt_scales_unsup = f0cwt_ms_unsup = None
        if self.with_f0:
            f0_unsup, pitch_unsup = get_pitch(wav, mel.shape[1], self.config,
                                              device=self.device)
            if f0_unsup is None or np.sum(f0_unsup) == 0:
                unsup_ok = False
            else:
                f0_unsup = f0_unsup[:duration]
                pitch_unsup = pitch_unsup[:duration]
                if self.with_f0cwt:
                    cwt_spec_unsup, cwt_scales_unsup, f0cwt_ms_unsup = \
                        self.get_f0cwt(f0_unsup)
                    if np.any(np.isnan(cwt_spec_unsup)):
                        unsup_ok = False

        if unsup_ok:
            attn_prior = self.beta_binomial_prior_distribution(
                mel.shape[1], n_tokens, self.beta_binomial_scaling_factor)
            self._save(speaker, basename, "attn_prior", attn_prior)
            self._save(speaker, basename, "f0_unsup", f0_unsup, "f0")
            self._save(speaker, basename, "pitch_unsup", pitch_unsup,
                       "pitch")
            if self.with_f0cwt:
                self._save(speaker, basename, "cwt_spec_unsup",
                           cwt_spec_unsup, "cwt_spec")
                self._save(speaker, basename, "cwt_scales_unsup",
                           cwt_scales_unsup, "cwt_scales")
                self._save(speaker, basename, "f0cwt_mean_std_unsup",
                           f0cwt_ms_unsup, "f0cwt_mean_std")
            self._save(speaker, basename, "energy_unsup_frame", energy,
                       "energy")
            self._save(speaker, basename, "mel_unsup", mel.T, "mel")
            out.update(
                info_unsup="|".join([basename, speaker, text_unsup,
                                     raw_text]),
                f0_unsup=f0_unsup,
                energy_unsup_frame=self.remove_outlier(energy),
                mel_unsup_min=mel.min(axis=1), mel_unsup_max=mel.max(axis=1),
                n=mel.shape[1])
        else:
            out.update(info_unsup=None, f0_unsup=None,
                       energy_unsup_frame=None,
                       mel_unsup_min=np.full(80, np.inf),
                       mel_unsup_max=np.full(80, -np.inf))

        # ---- supervised (TextGrid) pipeline ----
        if os.path.exists(tg_path):
            tg = read_textgrid(tg_path)
            phone_s, durations, mel2ph, start, end = self.get_alignment(
                tg.get_tier_by_name("phones"))
            text_sup = "{" + " ".join(phone_s) + "}"
            if start >= end:
                sup_ok = False
            else:
                wav_s = wav_raw[int(self.sampling_rate * start):
                                int(self.sampling_rate * end)]
                mel_s, energy_s = get_mel_from_wav(wav_s, self.stft)
                total = sum(durations)
                mel_s = mel_s[:, :total]
                energy_s = energy_s[:total]
                f0_sup = cwt_spec_sup = cwt_scales_sup = f0cwt_ms_sup = None
                if self.with_f0:
                    f0_sup, pitch_sup = get_pitch(wav_s, mel_s.shape[1],
                                                  self.config,
                                                  device=self.device)
                    if f0_sup is None or np.sum(f0_sup) == 0:
                        sup_ok = False
                    else:
                        f0_sup = f0_sup[:total]
                        pitch_sup = pitch_sup[:total]
                        if self.with_f0cwt:
                            cwt_spec_sup, cwt_scales_sup, f0cwt_ms_sup = \
                                self.get_f0cwt(f0_sup)
                            if np.any(np.isnan(cwt_spec_sup)):
                                sup_ok = False
                if sup_ok:
                    energy_phone = self._phone_energy(durations,
                                                      energy_s.copy())
                    self._save(speaker, basename, "duration",
                               np.array(durations))
                    self._save(speaker, basename, "mel2ph", np.array(mel2ph))
                    self._save(speaker, basename, "f0_sup", f0_sup, "f0")
                    self._save(speaker, basename, "pitch_sup", pitch_sup,
                               "pitch")
                    if self.with_f0cwt:
                        self._save(speaker, basename, "cwt_spec_sup",
                                   cwt_spec_sup, "cwt_spec")
                        self._save(speaker, basename, "cwt_scales_sup",
                                   cwt_scales_sup, "cwt_scales")
                        self._save(speaker, basename, "f0cwt_mean_std_sup",
                                   f0cwt_ms_sup, "f0cwt_mean_std")
                    self._save(speaker, basename, "energy_sup_frame",
                               energy_s, "energy")
                    self._save(speaker, basename, "energy_sup_phone",
                               energy_phone, "energy")
                    self._save(speaker, basename, "mel_sup", mel_s.T, "mel")
                    out.update(
                        info_sup="|".join([basename, speaker, text_sup,
                                           raw_text]),
                        f0_sup=f0_sup,
                        energy_sup_frame=self.remove_outlier(energy_s),
                        energy_sup_phone=self.remove_outlier(energy_phone),
                        mel_sup_min=mel_s.min(axis=1),
                        mel_sup_max=mel_s.max(axis=1),
                        n=max(out["n"], mel_s.shape[1]))
        else:
            sup_ok = False
        if not sup_ok:
            out.update(info_sup=None, f0_sup=None, energy_sup_frame=None,
                       energy_sup_phone=None,
                       mel_sup_min=np.full(80, np.inf),
                       mel_sup_max=np.full(80, -np.inf))
        if out["info_unsup"] is None and out["info_sup"] is None:
            return None
        return out

    def constant_window_frames(self, speaker, basename):
        """{"unsup": mask, "sup": mask or None}: the frames of the
        utterance's two f0 files whose lag is rounding noise
        (:func:`ctts_torch.preprocessing.pitch.constant_window_frames`),
        padded and cut as the f0 is; for comparing two stores."""
        wav_raw, wav, duration = self.load_audio(
            os.path.join(self.in_dir, speaker, f"{basename}.wav"))

        def frames(w, n):
            m = constant_window_frames(w, self.sampling_rate,
                                       self.hop_length)
            n_mel = 1 + len(w) // self.hop_length
            return np.pad(m, (0, max(0, n_mel - len(m))), mode="edge")[:n]

        out = {"unsup": frames(wav, duration), "sup": None}
        tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                               f"{basename}.TextGrid")
        if os.path.exists(tg_path):
            _, durations, _, start, end = self.get_alignment(
                read_textgrid(tg_path).get_tier_by_name("phones"))
            out["sup"] = frames(wav_raw[int(self.sampling_rate * start):
                                        int(self.sampling_rate * end)],
                                sum(durations))
        return out

    def _save(self, speaker, basename, dirname, arr, kind=None):
        kind = kind or dirname
        np.save(os.path.join(self.out_dir, dirname,
                             f"{speaker}-{kind}-{basename}.npy"), arr)

    @staticmethod
    def _phone_energy(durations, energy):
        """(utils/tools.py:56-66)"""
        pos = 0
        for i, d in enumerate(durations):
            energy[i] = np.mean(energy[pos: pos + d]) if d > 0 else 0.0
            pos += d
        return energy[: len(durations)]

    def get_alignment(self, tier):
        """TextGrid phones tier → (phones, durations, mel2ph, start, end)
        (preprocessor.py:562-606)."""
        phones, durations, mel2ph = [], [], []
        start_time = end_time = 0
        end_idx = 0
        known = {s[1:] for s in _symbols if s.startswith("@")}
        for t in tier:
            s, e, p = t.start_time, t.end_time, t.text
            if p not in _SIL_PHONES and p not in known:
                p = "spn"           # sanitize unknown aligner phones
            if not phones:
                if p in _SIL_PHONES:
                    continue
                start_time = s
            if p not in _SIL_PHONES:
                phones.append(p)
                end_time = e
                end_idx = len(phones)
            else:
                phones.append(p)
            durations.append(int(
                np.round(e * self.sampling_rate / self.hop_length)
                - np.round(s * self.sampling_rate / self.hop_length)))
        phones = phones[:end_idx]
        durations = durations[:end_idx]
        for ph_idx in range(len(phones)):
            mel2ph += [ph_idx + 1] * durations[ph_idx]
        assert sum(durations) == len(mel2ph)
        return phones, durations, mel2ph, start_time, end_time

    def beta_binomial_prior_distribution(self, mel_count, phoneme_count,
                                         scaling_factor=1.0):
        """[M, P] prior (preprocessor.py:551-560), a row at a time through
        ``betabinom.pmf`` itself: the same arithmetic as the JAX package's
        frozen ``betabinom(P, a, b).pmf``, without building a frozen
        distribution a row (which took five sixths of the time)."""
        P, M = phoneme_count, mel_count
        x = np.arange(0, P)
        probs = []
        for i in range(1, M + 1):
            a, b = scaling_factor * i, scaling_factor * (M + 1 - i)
            probs.append(betabinom.pmf(x, P, a, b))
        return np.array(probs)

    def get_f0cwt(self, f0):
        """(preprocessor.py:612-618)"""
        _, cont_lf0 = get_cont_lf0(f0)
        mean, std = np.mean(cont_lf0), np.std(cont_lf0)
        W, scales = get_lf0_cwt((cont_lf0 - mean) / std)
        return W, scales, np.array([mean, std])

    @staticmethod
    def remove_outlier(values):
        """IQR filter (preprocessor.py:620-628)."""
        values = np.array(values)
        p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
        lower = p25 - 1.5 * (p75 - p25)
        upper = p75 + 1.5 * (p75 - p25)
        return values[np.logical_and(values > lower, values < upper)]

    def _plot_speaker_tsne(self, spker_embeds):
        """t-SNE of speaker embeddings → spker_embed_tsne.png
        (reference utils/tools.py:507-526, preprocessor.py:308-313)."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            from matplotlib import pyplot as plt
            from sklearn.manifold import TSNE
            names, vecs = [], []
            for spk, embeds in spker_embeds.items():
                for e in embeds:
                    names.append(spk)
                    vecs.append(np.asarray(e).ravel())
            X = np.stack(vecs)
            emb2d = TSNE(n_components=2,
                         perplexity=min(30, max(2, len(X) // 3)),
                         init="random").fit_transform(X)
            fig, ax = plt.subplots(figsize=(7, 7))
            uniq = sorted(set(names))
            for i, spk in enumerate(uniq):
                idx = [j for j, n in enumerate(names) if n == spk]
                ax.scatter(emb2d[idx, 0], emb2d[idx, 1], s=8, label=spk)
            if len(uniq) <= 20:
                ax.legend(fontsize="x-small")
            fig.savefig(os.path.join(self.out_dir, "spker_embed_tsne.png"))
            plt.close(fig)
        except Exception as e:       # plotting must not break featurization
            print(f"(t-SNE plot skipped: {e})")

    @staticmethod
    def _normalize_dir(in_dir, mean, std):
        """In-place renorm, returns (min, max) (preprocessor.py:630-641)."""
        vmin, vmax = np.inf, -np.inf
        for filename in os.listdir(in_dir):
            path = os.path.join(in_dir, filename)
            values = (np.load(path) - mean) / std
            np.save(path, values)
            if values.size:
                vmin = min(vmin, values.min())
                vmax = max(vmax, values.max())
        return vmin, vmax
