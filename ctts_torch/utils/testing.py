"""Tiny configurations and synthetic batches for tests and smoke runs
(numpy-only counterparts of ctts_tpu/utils/testing.py), and a synthetic raw
corpus with the comparison of two ``.npy`` stores preprocessed from it."""

import copy
import json
import os

import numpy as np

from ctts_torch.config import get_configs_of


def tiny_configs():
    """The LJSpeech configs cut to one layer of width 32, float32 (the
    prosody models, when switched on, at the JAX package's test sizes)."""
    preprocess, model, train = (copy.deepcopy(c)
                                for c in get_configs_of("LJSpeech"))
    model["block_type"] = "transformer_fs2"
    model["compute_dtype"] = "float32"
    train["on_device_prior"] = False
    train["transfer_dtype"] = "float32"
    model["duration_modeling"]["learn_alignment"] = True
    model["prosody_modeling"]["model_type"] = "none"
    model["multi_speaker"] = False
    model["max_seq_len"] = 64
    for key in ("transformer_fs2", "transformer"):
        model[key]["encoder_hidden"] = 32
        model[key]["decoder_hidden"] = 32
        model[key]["encoder_layer"] = 1
        model[key]["decoder_layer"] = 1
    model["transformer"]["conv_filter_size"] = 48
    model["variance_predictor"]["filter_size"] = 32
    model["variance_predictor"]["cwt_hidden_size"] = 16
    liu = model["prosody_modeling"]["liu2021"]
    liu.update(ref_enc_filters=[4, 4, 8], ref_enc_gru_size=8, token_num=4,
               bottleneck_size_u=16)
    model["prosody_modeling"]["du2021"]["predictor_num_gaussians"] = 3
    model["_energy_stats"] = (-1.5, 8.5)
    preprocess["preprocessing"]["pitch"]["pitch_type"] = "cwt"
    preprocess["preprocessing"]["energy"]["feature"] = "phoneme_level"
    return preprocess, model, train


def synth_batch(B=2, T_s=11, T_m=40, seed=0, src_lens=None, mel_lens=None,
                prior=True, sup=False, phone_energy=False):
    """A seeded ``train_unsup`` batch of numpy arrays at [B, T_s] tokens and
    [B, T_m] frames with CWT pitch data. The first utterance is full
    length and the others shorter, unless the lengths are given.
    ``prior=False`` leaves ``attn_priors`` to the step (computed on the
    device). ``sup=True`` adds a ``train_sup`` batch's ``durations``
    (at least 1 a token, summing to each mel length) and
    ``pitch_data["mel2ph"]``, drawn after everything else, so the other
    arrays are those of the same seed without it. ``phone_energy=True``
    gives the energies a token, as a supervised store holds them at
    ``phoneme_level``."""
    rng = np.random.RandomState(seed)
    if src_lens is None:
        src_lens = np.array([T_s] + [T_s - 3] * (B - 1))
    if mel_lens is None:
        mel_lens = np.array([T_m] + [T_m - 7] * (B - 1))
    src_lens = np.asarray(src_lens, np.int32)
    mel_lens = np.asarray(mel_lens, np.int32)
    texts = np.zeros((B, T_s), np.int32)
    for b, n in enumerate(src_lens):
        texts[b, :n] = rng.randint(1, 300, size=n)
    frame_mask = np.arange(T_m)[None, :] < mel_lens[:, None]
    mels = rng.randn(B, T_m, 80).astype(np.float32) * 0.1 - 4.0
    mels *= frame_mask[..., None]
    f0 = (np.abs(rng.randn(B, T_m).astype(np.float32)) * 0.3 + 7.0) \
        * frame_mask
    uv = (rng.rand(B, T_m) < 0.2).astype(np.float32) * frame_mask
    pitch_data = {
        "f0": f0.astype(np.float32), "uv": uv.astype(np.float32),
        "cwt_spec": rng.randn(B, T_m, 10).astype(np.float32),
        "f0_mean": rng.rand(B).astype(np.float32) * 2 + 5,
        "f0_std": rng.rand(B).astype(np.float32) * 0.5 + 0.1}
    energies = ((rng.randn(B, T_m).astype(np.float32) + 3.0)
                * frame_mask).astype(np.float32)
    attn_priors = rng.rand(B, T_m, T_s).astype(np.float32) + 1e-3
    durations = None
    if sup:
        durations = np.zeros((B, T_s), np.int32)
        mel2ph = np.zeros((B, T_m), np.int32)
        for b in range(B):
            n, m = int(src_lens[b]), int(mel_lens[b])
            d = rng.multinomial(m - n, np.ones(n) / n) + 1
            durations[b, :n] = d
            mel2ph[b, :m] = np.repeat(np.arange(1, n + 1), d)
        pitch_data["mel2ph"] = mel2ph
    if phone_energy:
        token_mask = np.arange(T_s)[None, :] < src_lens[:, None]
        energies = ((rng.randn(B, T_s).astype(np.float32) + 3.0)
                    * token_mask).astype(np.float32)
    return {
        "speakers": np.zeros(B, np.int32),
        "texts": texts,
        "src_lens": src_lens,
        "mels": mels,
        "mel_lens": mel_lens,
        "pitch_data": pitch_data,
        "energies": energies,
        "durations": durations,
        "attn_priors": attn_priors if prior else None,
        "spker_embeds": None,
    }


# ---- a raw corpus and the comparison of two stores -------------------- #

# the corpus's lexicon (ARPAbet of common words of the LJSpeech texts)
CORPUS_LEXICON = {
    "the": "DH AH0", "of": "AH1 V", "and": "AH0 N D", "to": "T UW1",
    "in": "IH0 N", "was": "W AA1 Z", "that": "DH AE1 T",
    "he": "HH IY1", "his": "HH IH1 Z", "it": "IH1 T",
    "with": "W IH1 DH", "for": "F AO1 R", "as": "AE1 Z",
    "had": "HH AE1 D", "prisoners": "P R IH1 Z AH0 N ER0 Z",
    "printing": "P R IH1 N T IH0 NG", "court": "K AO1 R T",
    "president": "P R EH1 Z AH0 D EH2 N T",
    "commission": "K AH0 M IH1 SH AH0 N", "report": "R IH0 P AO1 R T",
    "newgate": "N UW1 G EY2 T", "evidence": "EH1 V AH0 D AH0 N S",
    "letters": "L EH1 T ER0 Z", "city": "S IH1 T IY0",
    "house": "HH AW1 S", "time": "T AY1 M", "years": "Y IH1 R Z",
    "made": "M EY1 D", "under": "AH1 N D ER0", "into": "IH0 N T UW1"}
CORPUS_SR = 22050
# TextGrid phones of a word left out of lexicon.txt
SPELLED_PHONES = "HH AH0 L"


def corpus_wav(rng, seconds, k=0, sr=CORPUS_SR):
    """One utterance of ``write_corpus``: an f0-modulated harmonic stack
    (speaker ``k`` 40 Hz higher than speaker ``k - 1``) with noise,
    amplitude-modulated like syllables, between 0.2 s of digital silence
    before and 0.3 s after; ``seconds`` long in all, float in [-0.7, 0.7].
    Returns (wav, samples of speech)."""
    n = int((seconds - 0.5) * sr)
    t = np.arange(n) / sr
    f0 = (120.0 + 40.0 * k + 30.0 * np.sin(2 * np.pi * 0.7 * t)
          + 15.0 * np.sin(2 * np.pi * 2.3 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum(np.sin(h * phase) / h for h in range(1, 7))
    sig *= 0.3 + 0.35 * np.sin(2 * np.pi * 1.1 * t) ** 2
    sig += rng.randn(n) * 0.003
    wav = np.concatenate([np.zeros(int(0.2 * sr)),
                          0.7 * sig / np.abs(sig).max(),
                          np.zeros(int(0.3 * sr))])
    return wav, n


def write_corpus(root, speakers, seconds, seed, spelled=()):
    """A corpus under ``root`` as ``python -m ctts_torch.prepare_align``
    leaves one: ``raw/<speaker>/<id>.wav`` (22.05 kHz int16,
    ``corpus_wav``), ``<id>.lab`` (about 2.5 words a second of speech,
    drawn from ``CORPUS_LEXICON``, then one of the words ``spelled`` in
    turn), ``TextGrid/<speaker>/<id>.TextGrid`` (the words' phones spread
    evenly over the speech; ``SPELLED_PHONES`` for a spelled word) and
    ``lexicon.txt`` (``CORPUS_LEXICON`` alone, so g2p spells the words
    ``spelled`` as graphemes). ``seconds``: the lengths of each speaker's
    utterances. Returns the seconds of audio written."""
    from ctts_torch.preprocessing.audio_io import save_wav
    sr, rng = CORPUS_SR, np.random.RandomState(seed)
    with open(os.path.join(root, "lexicon.txt"), "w") as f:
        for w in sorted(CORPUS_LEXICON):
            f.write(f"{w.upper()} {CORPUS_LEXICON[w]}\n")
    words = sorted(CORPUS_LEXICON)
    total = 0.0
    for k, speaker in enumerate(speakers):
        for d in ("raw", "TextGrid"):
            os.makedirs(os.path.join(root, d, speaker))
        for i, sec in enumerate(seconds):
            base = f"{speaker[:2].upper()}{k + 1:03d}-{i + 1:04d}"
            wav, n = corpus_wav(rng, sec, k, sr)
            save_wav(os.path.join(root, "raw", speaker, f"{base}.wav"),
                     wav.astype(np.float32), sr)
            total += len(wav) / sr
            text = [words[j] for j in rng.randint(
                0, len(words), max(2, int(round(2.5 * (sec - 0.5)))))]
            if spelled:
                text.append(spelled[i % len(spelled)])
            with open(os.path.join(root, "raw", speaker, f"{base}.lab"),
                      "w") as f:
                f.write(" ".join(text))
            phones = [p for w in text for p in CORPUS_LEXICON.get(
                w, SPELLED_PHONES).split()]
            step = (n / sr) / len(phones)
            ivs = "".join(
                f"intervals [{j + 1}]:\n  xmin = {0.2 + j * step:.4f}\n"
                f"  xmax = {0.2 + (j + 1) * step:.4f}\n"
                f"  text = \"{p}\"\n" for j, p in enumerate(phones))
            end = 0.2 + len(phones) * step
            with open(os.path.join(root, "TextGrid", speaker,
                                   f"{base}.TextGrid"), "w") as f:
                f.write('File type = "ooTextFile"\nObject class = '
                        f'"TextGrid"\n\nxmin = 0\nxmax = {end:.4f}\n'
                        "tiers? <exists>\nsize = 1\nitem []:\n  item [1]:"
                        '\n    class = "IntervalTier"\n    name = '
                        f'"phones"\n    xmin = 0\n    xmax = {end:.4f}\n'
                        f"    intervals: size = {len(phones)}\n" + ivs)
    return total


# the limits of a store against a reference store of the same corpus
STORE_MEL_TOL = 1e-4        # log-mel, energy, CWT: absolute
STORE_F0_RTOL = 1e-6        # voiced f0, off the rounding-noise frames
STORE_STATS_RTOL = 1e-5     # stats.json
STORE_EMBED_TOL = 1e-5      # speaker embeddings: absolute
STORE_NOISE_FRAMES = 2      # rounding-noise frames an f0 file may have


def store_files(root):
    """Every file under ``root``, relative to it, sorted."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def compare_stores(got, want, constant_window_frames, get_f0cwt):
    """Hold the store ``got`` to ``want`` (written from the same corpus and
    config): the same files; texts, TextGrids, ``speakers.json``,
    durations, mel2ph and priors equal; mel, energy and CWT within
    STORE_MEL_TOL; f0 voicing equal and voiced f0 within STORE_F0_RTOL,
    coarse pitch equal, but on the frames whose lag is rounding noise in
    both trackers (``constant_window_frames(speaker, basename)`` → {tag:
    mask}, at most STORE_NOISE_FRAMES a file); where an utterance's f0
    moved on those frames, its CWT is held to ``get_f0cwt`` of ``got``'s
    f0 (the reference's function) and the f0 statistics to ``got``'s f0
    files; the rest of ``stats.json`` within STORE_STATS_RTOL; speaker
    embeddings within STORE_EMBED_TOL. Raises AssertionError at the first
    difference; returns the largest differences by kind."""
    files = store_files(want)
    got_files = store_files(got)
    if got_files != files:
        raise AssertionError(f"file sets differ: "
                             f"{sorted(set(got_files) ^ set(files))}")
    if not any(f.startswith("mel_sup") for f in files):
        raise AssertionError("the store holds no sup mels")
    worst = {}

    def note(kind, v):
        worst[kind] = max(worst.get(kind, 0.0), float(v))

    def load(root, rel):
        return np.load(os.path.join(root, rel))

    def same_layout(rel, x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{rel}: {x.dtype} {x.shape} against "
                                 f"{y.dtype} {y.shape}")

    masks, moved = {}, {}
    for rel in files:
        kind, name = os.path.split(rel)
        if kind not in ("f0_unsup", "f0_sup"):
            continue
        speaker, _, base = name[:-4].split("-", 2)
        if (speaker, base) not in masks:
            masks[(speaker, base)] = constant_window_frames(speaker, base)
        skip = masks[(speaker, base)][kind[3:]]
        x, y = load(got, rel), load(want, rel)
        same_layout(rel, x, y)
        if x.dtype != np.float32 or not np.array_equal(x > 0, y > 0):
            raise AssertionError(f"{rel}: voicing differs")
        note("rounding-noise frames", skip.sum())
        if skip.sum() > STORE_NOISE_FRAMES:
            raise AssertionError(f"{rel}: rounding-noise frames "
                                 f"{np.nonzero(skip)[0]}")
        keep = (y > 0) & ~skip
        rel_err = (np.abs(x[keep].astype(np.float64) / y[keep] - 1).max()
                   if keep.any() else 0.0)
        note("f0 (relative)", rel_err)
        if rel_err > STORE_F0_RTOL:
            raise AssertionError(f"{rel}: f0 {rel_err}")
        if not np.array_equal(x, y):
            moved[(kind[3:], speaker, base)] = x
    for rel in files:
        kind, name = os.path.split(rel)
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith((".txt", ".TextGrid")) or rel == "speakers.json":
            if open(a, "rb").read() != open(b, "rb").read():
                raise AssertionError(f"{rel} differs")
            continue
        if rel == "stats.json":
            sa, sb = json.load(open(a)), json.load(open(b))
            if sorted(sa) != sorted(sb):
                raise AssertionError(f"stats.json keys {sorted(sa)} against "
                                     f"{sorted(sb)}")
            for k in sb:
                ref = np.asarray(sb[k], np.float64)
                if k in ("f0_unsup", "f0_sup") and any(
                        t == k[3:] for t, _, _ in moved):
                    f0s = np.concatenate([load(got, os.path.join(k, n))
                                          for n in sorted(os.listdir(
                                              os.path.join(got, k)))])
                    f0s = f0s[f0s != 0]
                    ref = np.array([np.mean(f0s), np.std(f0s)])
                err = np.max(np.abs(np.asarray(sa[k]) - ref)
                             / np.maximum(np.abs(ref), 1e-30))
                note("stats.json (relative)", err)
                if err > STORE_STATS_RTOL:
                    raise AssertionError(f"stats.json {k}: {err}")
            continue
        if not rel.endswith(".npy"):
            raise AssertionError(f"unexpected file {rel}")
        if kind.startswith("f0_"):
            continue
        x, y = load(got, rel), load(want, rel)
        if kind == "spker_embed":
            same_layout(rel, x, y)
            err = np.abs(x - y).max()
            note("spker_embed", err)
            if err > STORE_EMBED_TOL:
                raise AssertionError(f"{rel}: {err}")
            continue
        speaker, _, base = name[:-4].split("-", 2)
        tag = kind.rsplit("_", 1)[-1]
        if kind.startswith("pitch_"):
            same_layout(rel, x, y)
            keep = ~masks[(speaker, base)][tag]
            if not np.array_equal(x[keep], y[keep]):
                raise AssertionError(f"{rel}: coarse pitch differs")
        elif kind in ("duration", "mel2ph", "attn_prior"):
            same_layout(rel, x, y)
            if not np.array_equal(x, y):
                raise AssertionError(f"{rel} differs")
        else:                          # mel, energy, cwt_*, f0cwt_*
            if (tag, speaker, base) in moved and kind.startswith(
                    ("cwt_", "f0cwt_")):
                spec, scales, mean_std = get_f0cwt(
                    moved[(tag, speaker, base)])
                y = np.asarray({"cwt_spec": spec, "cwt_scales": scales,
                                "f0cwt_mean_std": mean_std}[
                                    kind.rsplit("_", 1)[0]])
            else:
                same_layout(rel, x, y)
            err = np.abs(np.asarray(x, np.float64) - y).max() \
                if x.size else 0.0
            note(kind.split("_")[0], err)
            if err > STORE_MEL_TOL:
                raise AssertionError(f"{rel}: {err}")
    return worst
