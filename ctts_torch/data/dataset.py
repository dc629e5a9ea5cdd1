"""Datasets over the preprocessed .npy store (ctts_tpu/data/dataset.py),
with numpy alone: :class:`Dataset` for training and :class:`TextDataset`
for batch synthesis.

Same on-disk layout (per-utterance mel/pitch/f0/energy/duration/mel2ph or
attn_prior/cwt .npy + metadata txt + speakers.json), and the same batches:
the shuffle by ``RandomState(seed + epoch)``, the per-host shard, the sort
by text length inside groups of ``group_size·batch_size`` and the padding to
shape buckets (next multiple of ``bucket_src``/``bucket_mel``), so that a
run sees the utterances in the JAX package's order. A :class:`Dataset`
reads its files through the threaded C++ reader of
:mod:`ctts_torch.data.native_loader` (built at first use), as the JAX
``Dataset`` does, and a file that reader rejects with ``np.load``; without
a host compiler every file goes through ``np.load``.
"""

import json
import os
import queue
import threading

import numpy as np

from ctts_torch.data import native_loader
from ctts_torch.text import text_to_sequence


def _round_up(x, m):
    return int(-(-x // m) * m)


def norm_interp_f0(f0, pitch_config):
    """Normalize f0 and interpolate linearly through unvoiced frames
    (ctts_tpu/preprocessing/pitch.py:norm_interp_f0). Returns (f0, uv)."""
    f0 = np.asarray(f0, np.float32).copy()
    uv = f0 == 0
    if pitch_config["pitch_norm"] == "standard":
        f0 = (f0 - pitch_config["f0_mean"]) / pitch_config["f0_std"]
    elif pitch_config["pitch_norm"] == "log":
        f0 = np.log2(f0 + pitch_config["pitch_norm_eps"])
    if pitch_config["use_uv"]:
        f0[uv] = 0
    if uv.sum() == len(f0):
        f0[uv] = 0
    elif uv.sum() > 0:
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0, uv.astype(np.float32)


def prefetch_iter(iterator, depth=2):
    """Run an iterator on a background thread with a bounded queue, so host
    batch assembly and .npy reads overlap device execution."""
    q = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(_END)
        except BaseException as e:                  # propagate to consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def get_variance_level(preprocess_config, model_config, data_loading=True):
    """(reference utils/tools.py:30-44)"""
    learn_alignment = (model_config["duration_modeling"]["learn_alignment"]
                       if data_loading else False)
    feature = preprocess_config["preprocessing"]["energy"]["feature"]
    if feature not in ("frame_level", "phoneme_level"):
        raise ValueError(f"unknown energy feature {feature!r}")
    tag = ("phone" if (not learn_alignment and feature == "phoneme_level")
           else "frame")
    return tag, feature


class Dataset:
    def __init__(self, filename, preprocess_config, model_config,
                 train_config, sort=False, drop_last=False,
                 bucket_src=32, bucket_mel=128):
        self.preprocess_config = preprocess_config
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.cleaners = preprocess_config["preprocessing"]["text"]["text_cleaners"]
        self.batch_size = train_config["optimizer"]["batch_size"]
        self.learn_alignment = model_config["duration_modeling"]["learn_alignment"]
        self.dataset_tag = "unsup" if self.learn_alignment else "sup"
        self.load_spker_embed = (
            model_config["multi_speaker"]
            and preprocess_config["preprocessing"].get(
                "speaker_embedder", "none") != "none")
        self.energy_level_tag, _ = get_variance_level(preprocess_config,
                                                      model_config)
        self.pitch_type = preprocess_config["preprocessing"]["pitch"]["pitch_type"]
        # train.on_device_prior: the train step computes the beta-binomial
        # prior from (mel_lens, src_lens) on the device (ops/attn_prior.py),
        # so the attn_prior .npy is neither read nor shipped
        self.on_device_prior = bool(train_config.get("on_device_prior",
                                                     False))
        self.sort = sort
        self.drop_last = drop_last
        self.bucket_src = bucket_src
        self.bucket_mel = bucket_mel

        self.basename, self.speaker, self.text, self.raw_text = \
            self._process_meta(filename)
        self._text_lens = None            # token counts, computed on demand
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)
        # the threaded C++ .npy reader (native/npy_loader.cc), None where
        # it cannot be built; files read through it and through numpy
        self._native = (native_loader.NativePrefetcher(8)
                        if native_loader.build() else None)
        self.native_reads = self.numpy_reads = 0

    def __len__(self):
        return len(self.text)

    def _load_many(self, paths):
        arrays = [None] * len(paths)
        if self._native is not None:
            arrays = self._native.fetch(self._native.submit(paths))
        for i, a in enumerate(arrays):        # rejected or not read: numpy
            if a is None:
                arrays[i] = np.load(paths[i])
                self.numpy_reads += 1
            else:
                self.native_reads += 1
        return arrays

    def __getitem__(self, idx):
        basename = self.basename[idx]
        speaker = self.speaker[idx]
        tag = self.dataset_tag
        pp = self.preprocessed_path

        keys = ["mel", "pitch", "f0", "energy"]
        paths = [
            os.path.join(pp, f"mel_{tag}", f"{speaker}-mel-{basename}.npy"),
            os.path.join(pp, f"pitch_{tag}",
                         f"{speaker}-pitch-{basename}.npy"),
            os.path.join(pp, f"f0_{tag}", f"{speaker}-f0-{basename}.npy"),
            os.path.join(pp, f"energy_{tag}_{self.energy_level_tag}",
                         f"{speaker}-energy-{basename}.npy"),
        ]
        if self.learn_alignment:
            if not self.on_device_prior:
                keys.append("attn_prior")
                paths.append(os.path.join(
                    pp, "attn_prior",
                    f"{speaker}-attn_prior-{basename}.npy"))
        else:
            keys += ["duration", "mel2ph"]
            paths += [os.path.join(pp, "duration",
                                   f"{speaker}-duration-{basename}.npy"),
                      os.path.join(pp, "mel2ph",
                                   f"{speaker}-mel2ph-{basename}.npy")]
        if self.pitch_type == "cwt":
            keys += ["cwt_spec", "_f0cwt_ms"]
            paths += [os.path.join(pp, f"cwt_spec_{tag}",
                                   f"{speaker}-cwt_spec-{basename}.npy"),
                      os.path.join(
                          pp, f"f0cwt_mean_std_{tag}",
                          f"{speaker}-f0cwt_mean_std-{basename}.npy")]
        if self.load_spker_embed:
            keys.append("spker_embed")
            paths.append(os.path.join(pp, "spker_embed",
                                      f"{speaker}-spker_embed.npy"))

        arrays = dict(zip(keys, self._load_many(paths)))
        sample = {
            "id": basename,
            "speaker": self.speaker_map[speaker],
            "text": np.array(text_to_sequence(self.text[idx], self.cleaners)),
            "raw_text": self.raw_text[idx],
            **{k: v for k, v in arrays.items() if not k.startswith("_")},
        }
        sample["f0"], sample["uv"] = norm_interp_f0(
            arrays["f0"], self.preprocess_config["preprocessing"]["pitch"])
        if self.pitch_type == "cwt":
            ms = arrays["_f0cwt_ms"]
            sample["f0_mean"], sample["f0_std"] = float(ms[0]), float(ms[1])
        return sample

    def _process_meta(self, filename):
        names, speakers, texts, raws = [], [], [], []
        with open(os.path.join(self.preprocessed_path, filename),
                  encoding="utf-8") as f:
            for line in f:
                n, s, t, r = line.strip("\n").split("|")
                names.append(n)
                speakers.append(s)
                texts.append(t)
                raws.append(r)
        return names, speakers, texts, raws

    # ---- batching -------------------------------------------------- #

    def collate(self, samples, pad_to=None):
        """Pack a list of samples into one padded, bucketed batch dict.
        ``pad_to`` maps the buckets (T_s, T_m) to the lengths to pad to
        (at least the buckets): a data-parallel step's largest."""
        B = len(samples)
        T_s = _round_up(max(s["text"].shape[0] for s in samples),
                        self.bucket_src)
        T_m = _round_up(max(s["mel"].shape[0] for s in samples),
                        self.bucket_mel)
        if pad_to is not None:
            T_s, T_m = pad_to((T_s, T_m))
        n_mel = samples[0]["mel"].shape[1]

        def pad1(key, dtype=np.float32, T=None):
            T = T or T_m
            out = np.zeros((B, T), dtype)
            for b, s in enumerate(samples):
                v = s[key]
                out[b, :len(v)] = v
            return out

        texts = np.zeros((B, T_s), np.int32)
        mels = np.zeros((B, T_m, n_mel), np.float32)
        src_lens = np.zeros(B, np.int32)
        mel_lens = np.zeros(B, np.int32)
        for b, s in enumerate(samples):
            texts[b, :len(s["text"])] = s["text"]
            mels[b, :len(s["mel"])] = s["mel"]
            src_lens[b] = len(s["text"])
            mel_lens[b] = len(s["mel"])

        pitch_data = {
            "pitch": pad1("pitch", np.int32),
            "f0": pad1("f0"),
            "uv": pad1("uv"),
        }
        if self.pitch_type == "cwt":
            cwt = np.zeros((B, T_m, 10), np.float32)
            for b, s in enumerate(samples):
                cwt[b, :len(s["cwt_spec"])] = s["cwt_spec"]
            pitch_data["cwt_spec"] = cwt
            pitch_data["f0_mean"] = np.array(
                [s["f0_mean"] for s in samples], np.float32)
            pitch_data["f0_std"] = np.array(
                [s["f0_std"] for s in samples], np.float32)

        batch = {
            "ids": [s["id"] for s in samples],
            "raw_texts": [s["raw_text"] for s in samples],
            "speakers": np.array([s["speaker"] for s in samples], np.int32),
            "texts": texts,
            "src_lens": src_lens,
            "mels": mels,
            "mel_lens": mel_lens,
            "pitch_data": pitch_data,
            "energies": pad1(
                "energy",
                T=T_s if self.energy_level_tag == "phone" else T_m),
            "durations": None,
            "attn_priors": None,
            "spker_embeds": None,
        }
        if self.learn_alignment:
            # on_device_prior leaves attn_priors None: the jitted step
            # computes it from (mel_lens, src_lens) (ops/attn_prior.py)
            if not self.on_device_prior:
                priors = np.zeros((B, T_m, T_s), np.float32)
                for b, s in enumerate(samples):
                    p = s["attn_prior"]      # stored [T_s,T_m] or [T_m,T_s]
                    if p.shape[0] == len(s["text"]):
                        p = p.T
                    m, t = min(p.shape[0], T_m), min(p.shape[1], T_s)
                    priors[b, :m, :t] = p[:m, :t]
                batch["attn_priors"] = priors
        else:
            batch["durations"] = pad1("duration", np.int32, T=T_s)
            pitch_data["mel2ph"] = pad1("mel2ph", np.int32)
        if self.load_spker_embed:
            batch["spker_embeds"] = np.concatenate(
                [s["spker_embed"] for s in samples], axis=0).astype(np.float32)
        return batch

    def _order(self, group_size, shuffle, seed, epoch, num_shards, shard):
        """The epoch's batches as lists of utterance indices: the shuffle,
        the shard, the sort by text length inside each group, and
        ``drop_last``. Sorting reads the metadata's texts only."""
        if self._text_lens is None:
            self._text_lens = [len(text_to_sequence(t, self.cleaners))
                               for t in self.text]
        idx = np.arange(len(self))
        if shuffle:
            rng = np.random.RandomState(seed + epoch)
            rng.shuffle(idx)
        idx = idx[shard::num_shards]
        group = group_size * self.batch_size
        out = []
        for g0 in range(0, len(idx), group):
            chunk = idx[g0: g0 + group]
            chunk = chunk[np.argsort([-self._text_lens[i] for i in chunk])]
            for b0 in range(0, len(chunk), self.batch_size):
                sub = chunk[b0: b0 + self.batch_size]
                if len(sub) < self.batch_size and (self.drop_last
                                                   or len(sub) == 0):
                    continue
                out.append(sub)
        return out

    def batches(self, group_size=4, shuffle=True, seed=0, epoch=0,
                num_shards=1, shard=0, start=0, pad_to=None):
        """Yield padded batch dicts; sort-by-length inside groups of
        group_size·batch_size (reference train.py:45-49, dataset.py:229-248).
        num_shards/shard give per-host sharding (DistributedSampler
        equivalent); ``start`` skips the epoch's first batches without
        reading them (a resumed run); ``pad_to`` as in :meth:`collate`."""
        for sub in self._order(group_size, shuffle, seed, epoch, num_shards,
                               shard)[start:]:
            yield self.collate([self[i] for i in sub], pad_to)

    def n_batches(self, group_size=4, num_shards=1, shard=0):
        """Batches per epoch (the same for every shuffle)."""
        return len(self._order(group_size, False, 0, 0, num_shards, shard))


class TextDataset:
    """Inference dataset (ctts_tpu/data/dataset.py:TextDataset): a metadata
    txt of ``basename|speaker|{phones}|raw text`` lines → batches of phone
    IDs, with ``speakers.json`` from the preprocessed store."""

    def __init__(self, filepath, preprocess_config, model_config):
        self.cleaners = preprocess_config["preprocessing"]["text"]["text_cleaners"]
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.load_spker_embed = (
            model_config["multi_speaker"]
            and preprocess_config["preprocessing"].get(
                "speaker_embedder", "none") != "none")
        self.basename, self.speaker, self.text, self.raw_text = \
            self._process_meta(filepath)
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.text)

    def __getitem__(self, idx):
        speaker = self.speaker[idx]
        spker_embed = np.load(os.path.join(
            self.preprocessed_path, "spker_embed",
            f"{speaker}-spker_embed.npy")) if self.load_spker_embed else None
        return (self.basename[idx], self.speaker_map[speaker],
                np.array(text_to_sequence(self.text[idx], self.cleaners)),
                self.raw_text[idx], spker_embed)

    @staticmethod
    def _process_meta(filename):
        names, speakers, texts, raws = [], [], [], []
        with open(filename, encoding="utf-8") as f:
            for line in f:
                n, s, t, r = line.strip("\n").split("|")
                names.append(n)
                speakers.append(s)
                texts.append(t)
                raws.append(r)
        return names, speakers, texts, raws

    def batches(self, batch_size=8, bucket_src=32):
        """Batches in file order: ``ids``, ``raw_texts``, ``speakers`` [B],
        ``texts`` [B, T_s] (T_s rounded up to ``bucket_src``),
        ``src_lens`` [B] and ``spker_embeds`` (or None)."""
        for b0 in range(0, len(self), batch_size):
            items = [self[i] for i in range(b0, min(b0 + batch_size,
                                                    len(self)))]
            B = len(items)
            T_s = _round_up(max(len(it[2]) for it in items), bucket_src)
            texts = np.zeros((B, T_s), np.int32)
            src_lens = np.zeros(B, np.int32)
            for b, it in enumerate(items):
                texts[b, :len(it[2])] = it[2]
                src_lens[b] = len(it[2])
            spker = (np.concatenate([it[4] for it in items], axis=0)
                     if self.load_spker_embed else None)
            yield {
                "ids": [it[0] for it in items],
                "raw_texts": [it[3] for it in items],
                "speakers": np.array([it[1] for it in items], np.int32),
                "texts": texts,
                "src_lens": src_lens,
                "spker_embeds": spker,
            }
