"""Synthesis CLI of the port (reference surface: synthesize.py).

    python -m ctts_torch.synthesize --mode single --text "..." \\
        --dataset LJSpeech --packed_ckpt assets/ljdemo_ckpt.npz
    python -m ctts_torch.synthesize --mode batch --source metadata.txt \\
        --dataset LJSpeech --packed_ckpt assets/ljdemo_ckpt.npz

Phone IDs go through CompTransTTS (mode "infer") to a mel, and the vocoder
turns the mel into a wav. The frame budget follows the JAX CLI's two
passes: a probe at one bucket (128 frames), then the predicted length
rounded up to a whole bucket, capped at 2·max_seq_len. Writes
``<id>.wav``, ``<id>.npy`` (the mel) and ``<id>.png`` (its plot; without
matplotlib the CLI says so once on stderr and writes the other two) per
utterance. A multi-speaker
model (``configs/VCTK.yaml``) voices ``--speaker_id``, a key of the store's
``speakers.json``; with an external speaker embedder its embedding is read
from ``spker_embed/<speaker>-spker_embed.npy`` there. ``--restore_step N``
reads the port's checkpoint of step N (written by ``ctts_torch.train``)
from the config's ``ckpt_path``. Batch mode reads a metadata txt
(``basename|speaker|{phones}|raw text``) in batches of 8 through
:class:`ctts_torch.data.dataset.TextDataset`. ``--stream_chunk N`` vocodes
through the chunked vocoder in chunks of N frames (the same audio, up to
the order of float sums) and prints the time to the first chunk.
"""

import argparse
import json
import os
import re
import string
import sys
import time

import numpy as np
import torch
from scipy.io import wavfile

from ctts_torch import resolve_device
from ctts_torch.config import get_configs_of
from ctts_torch.text import text_to_sequence
from ctts_torch.utils.model import (get_model, get_vocoder, vocoder_infer,
                                    vocoder_stream)


def read_lexicon(lex_path):
    lexicon = {}
    if not os.path.exists(lex_path):
        return lexicon
    with open(lex_path) as f:
        for line in f:
            temp = re.split(r"\s+", line.strip("\n"))
            word, phones = temp[0], temp[1:]
            if word.lower() not in lexicon:
                lexicon[word.lower()] = phones
    return lexicon


def _g2p_fallback():
    try:
        from g2p_en import G2p
    except ImportError:
        return None
    return G2p()


def preprocess_english(text, preprocess_config):
    """Text → symbol IDs: lexicon lookup, g2p_en when installed, else the
    letters themselves (synthesize.py:58-92)."""
    text = text.rstrip(string.punctuation)
    cleaners = preprocess_config["preprocessing"]["text"]["text_cleaners"]
    lexicon = read_lexicon(preprocess_config["path"]["lexicon_path"])
    g2p = _g2p_fallback()
    phones = []
    for w in (w for w in re.split(r"([,;.\-\?\!\s+])", text) if w):
        if w.lower() in lexicon:
            phones += lexicon[w.lower()]
        elif g2p is not None:
            phones += [p for p in g2p(w) if p != " "]
        else:
            phones += ["__raw__" + w]
    print(f"Raw Text Sequence: {text}")
    if any(p.startswith("__raw__") for p in phones):
        seq = []
        for p in phones:
            if p.startswith("__raw__"):
                seq += text_to_sequence(p[len("__raw__"):], cleaners)
            else:
                seq += text_to_sequence("{" + p + "}", cleaners)
        return np.array(seq)
    phones = "{" + " ".join(phones) + "}"
    phones = re.sub(r"\{[^\w\s]?\}", "{sp}", phones)
    print(f"Phoneme Sequence: {phones}")
    return np.array(text_to_sequence(phones, cleaners))


def infer_mels(model, batch, configs, controls=(1.0, 1.0, 1.0),
               max_mel_len=None, bucket=128):
    """Run the acoustic model on a batch of phone IDs.

    batch: dict with "speakers", "texts" [B, T_s] and "src_lens" [B]
    (arrays or tensors), and "spker_embeds" [B, external_speaker_dim]
    where the model takes external speaker embeddings. Without
    ``max_mel_len`` the budget comes from a probe pass at ``bucket`` frames
    (synthesize.py:146-154). Returns the
    model's output dict for the final pass."""
    _, model_config, _ = configs
    p, e, d = controls
    device = next(model.parameters()).device
    spker = batch.get("spker_embeds")
    if spker is not None:
        spker = torch.as_tensor(spker).float().to(device)

    def run(mel_budget):
        with torch.no_grad():
            return model(
                torch.as_tensor(batch["speakers"]).to(device),
                torch.as_tensor(batch["texts"]).long().to(device),
                torch.as_tensor(batch["src_lens"]).to(device),
                mode="infer", max_mel_len=mel_budget, spker_embeds=spker,
                p_control=p, e_control=e, d_control=d)

    if max_mel_len is None:
        probe = run(bucket)
        total = int(probe["duration_rounded"].sum(dim=1).max().item())
        cap = 2 * model_config["max_seq_len"]    # position tables reach 2×
        max_mel_len = min(cap, -(-max(total, 1) // bucket) * bucket)
    return run(max_mel_len)


def synthesize(model, batch, configs, vocoder, controls, result_dir,
               max_mel_len=None, bucket=128, stream_chunk=0, png=False):
    """Text IDs → mel → wav; writes ``<id>.wav`` and ``<id>.npy`` (the mel,
    [T, n_mel]) per utterance into result_dir, and with ``png`` the mel's
    plot ``<id>.png`` (synthesize.py:186-188). With ``stream_chunk`` the
    vocoder streams chunks of that many frames and the time to the first
    chunk is printed. Returns the wavs."""
    preprocess_config, _, _ = configs
    out = infer_mels(model, batch, configs, controls, max_mel_len, bucket)
    mels = out["postnet_mel_predictions"]
    mel_lens = out["mel_lens"].cpu().numpy()
    if stream_chunk and vocoder[0] != "griffin_lim":
        hop = preprocess_config["preprocessing"]["stft"]["hop_length"]
        t0 = time.perf_counter()
        chunks = []
        for c in vocoder_stream(mels, vocoder, preprocess_config,
                                chunk=stream_chunk):
            if not chunks:
                print(f"time-to-first-audio: "
                      f"{(time.perf_counter() - t0) * 1e3:.0f} ms "
                      f"({stream_chunk * hop} samples/chunk)")
            chunks.append(c)
        full = np.concatenate(chunks, axis=1)
        wavs = [full[i, :int(n) * hop] for i, n in enumerate(mel_lens)]
    else:
        wavs = vocoder_infer(mels, vocoder, preprocess_config,
                             lengths=mel_lens)
    mels = mels.cpu().numpy()
    os.makedirs(result_dir, exist_ok=True)
    sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
    for i, basename in enumerate(batch["ids"]):
        wavfile.write(os.path.join(result_dir, f"{basename}.wav"), sr, wavs[i])
        np.save(os.path.join(result_dir, f"{basename}.npy"),
                mels[i, :mel_lens[i]])
        if png:
            from ctts_torch.utils.logging import pyplot, plot_mel
            plt = pyplot()
            fig = plot_mel([mels[i, :mel_lens[i]].T],
                           [f"Synthesized Spectrogram ({basename})"])
            fig.savefig(os.path.join(result_dir, f"{basename}.png"))
            plt.close(fig)
    print(f"wrote {len(batch['ids'])} wav/npy{'/png' if png else ''} sets "
          f"to {result_dir}")
    return wavs


def can_plot():
    """Whether matplotlib imports; says once on stderr when it does not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: no <id>.png plots are written",
              file=sys.stderr)
        return False
    return True


def speaker_inputs(speaker_id, configs):
    """(speaker index, external embedding [1, dim] or None) for the name
    ``speaker_id`` (synthesize.py:248-260): its ``speakers.json`` index and,
    with an external embedder, ``spker_embed/<name>-spker_embed.npy``. A
    single-speaker model takes speaker 0 and no embedding."""
    preprocess_config, model_config, _ = configs
    if not model_config["multi_speaker"]:
        return 0, None
    pp = preprocess_config["path"]["preprocessed_path"]
    with open(os.path.join(pp, "speakers.json")) as f:
        speaker_map = json.load(f)
    if speaker_id not in speaker_map:
        raise ValueError(f"--speaker_id {speaker_id!r} is not a key of "
                         f"{os.path.join(pp, 'speakers.json')}")
    embed = None
    if preprocess_config["preprocessing"].get("speaker_embedder",
                                              "none") != "none":
        embed = np.load(os.path.join(
            pp, "spker_embed", f"{speaker_id}-spker_embed.npy")).astype(
                np.float32).reshape(1, -1)
    return speaker_map[speaker_id], embed


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--packed_ckpt", type=str, default=None,
                        help="bf16 npz weights packed by the JAX package "
                             "(e.g. assets/ljdemo_ckpt.npz)")
    parser.add_argument("--mode", type=str, choices=["batch", "single"],
                        required=True)
    parser.add_argument("--source", type=str, default=None)
    parser.add_argument("--text", type=str, default=None)
    parser.add_argument("--speaker_id", type=str, default="0",
                        help="speaker name (a speakers.json key) for "
                             "multi-speaker models")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_dir", type=str, default=None)
    parser.add_argument("--vocoder_ckpt", type=str, default="ckpt")
    parser.add_argument("--result_dir", type=str, default=None,
                        help="output directory (default: the config's "
                             "result_path)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--stream_chunk", type=int, default=0)
    args = parser.parse_args(argv)

    if args.mode == "batch" and (args.source is None
                                 or args.text is not None):
        parser.error("--mode batch takes --source and no --text")
    if args.mode == "single" and (args.text is None
                                  or args.source is not None):
        parser.error("--mode single takes --text and no --source")

    configs = get_configs_of(args.dataset, args.config_dir)
    preprocess_config, model_config, train_config = configs
    language = preprocess_config["preprocessing"]["text"]["language"]
    if language != "en":
        raise NotImplementedError(f"language {language!r}: only English is "
                                  "ported yet")
    device = resolve_device(args.device)
    model = get_model(args.restore_step, configs,
                      packed_ckpt=args.packed_ckpt, device=device)
    vocoder = get_vocoder(model_config, args.vocoder_ckpt, device=device)
    if vocoder[0] == "griffin_lim":
        print("NOTE: no vocoder weights found; using griffin-lim fallback")
    controls = (args.pitch_control, args.energy_control,
                args.duration_control)
    result_dir = args.result_dir or train_config["path"]["result_path"]
    if args.mode == "batch":
        from ctts_torch.data.dataset import TextDataset
        dataset = TextDataset(args.source, preprocess_config, model_config)
        batches = dataset.batches(batch_size=8)
    else:
        seq = preprocess_english(args.text, preprocess_config)
        speaker, spker_embed = speaker_inputs(args.speaker_id, configs)
        batches = [{"ids": [args.text[:100]],
                    "speakers": np.array([speaker], np.int64),
                    "texts": seq[None].astype(np.int64),
                    "src_lens": np.array([len(seq)], np.int64),
                    "spker_embeds": spker_embed}]
    png = can_plot()
    for batch in batches:
        synthesize(model, batch, configs, vocoder, controls, result_dir,
                   stream_chunk=args.stream_chunk, png=png)


if __name__ == "__main__":
    main()
