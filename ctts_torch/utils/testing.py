"""Tiny configurations and synthetic batches for tests and smoke runs
(numpy-only counterparts of ctts_tpu/utils/testing.py)."""

import copy

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
