"""Device-resident corpus cache (ctts_tpu/data/device_cache.py): upload the
store once, gather batches on the device by index.

When the preprocessed corpus fits the ``train.device_cache_mb`` budget, the
whole store goes to the card once, and a step ships only a [B] int32 index
vector: :func:`gather_batch` takes the batch rows from the cache and slices
them to the batch's bucket shape on the device.

Batch composition is exactly ``Dataset.batches()``: :meth:`index_batches`
replays the same shuffle, shard, sort-group, bucketing and ``drop_last``
from length tables recorded at build time, and :func:`gather_batch`
reproduces ``collate()``'s padded arrays (rows are zero past each
utterance's own length, so a prefix slice of the globally padded row is the
per-batch padding).
"""

import numpy as np
import torch


def _round_up(n, k):
    return ((n + k - 1) // k) * k


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class DeviceCache:
    """Build from a Dataset, :meth:`put` on a device, then iterate
    ``(idx, T_s, T_m)`` with :meth:`index_batches` and materialize each
    batch with :func:`gather_batch`."""

    def __init__(self, dataset, transfer_dtype="float16"):
        self.ds = dataset
        self.float_t = (np.float16 if transfer_dtype == "float16"
                        else np.float32)
        if dataset.learn_alignment and not dataset.on_device_prior:
            raise ValueError(
                "device_cache requires train.on_device_prior: the step "
                "computes the priors from the lengths (ops/attn_prior.py)")
        n = len(dataset)
        samples = [dataset[i] for i in range(n)]
        self.src_lens = np.array([len(s["text"]) for s in samples], np.int32)
        self.mel_lens = np.array([len(s["mel"]) for s in samples], np.int32)
        # bucket-rounded global padding: every batch's bucket shape is a
        # prefix slice of the cached rows
        S = _round_up(int(self.src_lens.max()), dataset.bucket_src)
        M = _round_up(int(self.mel_lens.max()), dataset.bucket_mel)
        n_mel = samples[0]["mel"].shape[1]
        ft = self.float_t

        def pad_to(key, T, dtype):
            out = np.zeros((n, T), dtype)
            for i, s in enumerate(samples):
                v = s[key]
                out[i, :len(v)] = v
            return out

        host = {
            "speakers": np.array([s["speaker"] for s in samples], np.int32),
            "texts": pad_to("text", S, np.int32),
            "src_lens": self.src_lens,
            "mel_lens": self.mel_lens,
        }
        mels = np.zeros((n, M, n_mel), ft)
        for i, s in enumerate(samples):
            mels[i, :len(s["mel"])] = s["mel"]
        host["mels"] = mels
        host["energies"] = pad_to(
            "energy", S if dataset.energy_level_tag == "phone" else M, ft)
        pitch = {
            "pitch": pad_to("pitch", M, np.int32),
            "f0": pad_to("f0", M, ft),
            "uv": pad_to("uv", M, ft),
        }
        if dataset.pitch_type == "cwt":
            cwt = np.zeros((n, M, 10), ft)
            for i, s in enumerate(samples):
                cwt[i, :len(s["cwt_spec"])] = s["cwt_spec"]
            pitch["cwt_spec"] = cwt
            pitch["f0_mean"] = np.array([s["f0_mean"] for s in samples], ft)
            pitch["f0_std"] = np.array([s["f0_std"] for s in samples], ft)
        if not dataset.learn_alignment:
            host["durations"] = pad_to("duration", S, np.int32)
            pitch["mel2ph"] = pad_to("mel2ph", M, np.int32)
        if dataset.load_spker_embed:
            host["spker_embeds"] = np.concatenate(
                [s["spker_embed"] for s in samples], axis=0).astype(ft)
        host["pitch_data"] = pitch
        self.ids = [s["id"] for s in samples]
        self.raw_texts = [s["raw_text"] for s in samples]
        self.nbytes = sum(a.nbytes for a in _leaves(host))
        self._host = host
        self.arrays = None                    # set by put()

    def put(self, device):
        """Upload the cache to ``device`` once; returns the tensor tree."""
        def move(v):
            if isinstance(v, dict):
                return {k: move(x) for k, x in v.items()}
            return torch.from_numpy(np.ascontiguousarray(v)).to(device)
        self.arrays = move(self._host)
        return self.arrays

    def index_batches(self, group_size=4, shuffle=True, seed=0, epoch=0,
                      num_shards=1, shard=0, start=0):
        """``(idx[B] int32, T_s, T_m)`` replaying ``Dataset.batches()``'s
        composition (the same shuffle, shard, sort-group and ``drop_last``);
        ``start`` skips the epoch's first batches."""
        ds = self.ds
        for sub in ds._order(group_size, shuffle, seed, epoch, num_shards,
                             shard)[start:]:
            T_s = _round_up(int(self.src_lens[sub].max()), ds.bucket_src)
            T_m = _round_up(int(self.mel_lens[sub].max()), ds.bucket_mel)
            yield sub.astype(np.int32), T_s, T_m


def gather_batch(cache, idx, T_s, T_m, energy_on_src):
    """Rows ``idx`` (an int tensor on the cache's device) of the cache,
    sliced to the (T_s, T_m) bucket: ``collate()``'s batch, on the device.
    ``energy_on_src``: the store's energies are phone-level
    (``Dataset.energy_level_tag == "phone"``)."""
    idx = idx.long()

    def take(a):
        return a.index_select(0, idx)

    pitch = {}
    for k, v in cache["pitch_data"].items():
        g = take(v)
        if k in ("pitch", "f0", "uv", "mel2ph", "cwt_spec"):
            g = g[:, :T_m]
        pitch[k] = g
    return {
        "speakers": take(cache["speakers"]),
        "texts": take(cache["texts"])[:, :T_s],
        "src_lens": take(cache["src_lens"]),
        "mels": take(cache["mels"])[:, :T_m],
        "mel_lens": take(cache["mel_lens"]),
        "pitch_data": pitch,
        "energies": take(cache["energies"])[:, :T_s if energy_on_src
                                            else T_m],
        "durations": (take(cache["durations"])[:, :T_s]
                      if "durations" in cache else None),
        "attn_priors": None,
        "spker_embeds": (take(cache["spker_embeds"])
                         if "spker_embeds" in cache else None),
    }
