"""CompTransTTS: encoder → (speaker) → variance adaptor → decoder → mel +
postnet (ctts_tpu/models/comp_trans_tts.py), in the ``infer``,
``train_unsup`` and ``train_sup`` modes. Dropout and the postnet's batch
statistics follow the module's ``training`` flag (``model.train()`` is the
JAX ``deterministic=False``).

A multi-speaker model adds one vector a batch row to the encoder output
(and hands it to the aligner): the row of a speaker table indexed by
``speakers`` when ``preprocessing.speaker_embedder`` is ``none``, else a
Linear projection of the batch's external embeddings ``spker_embeds``
([B, external_speaker_dim], e.g. DeepSpeaker's 512). The prosody model of
``prosody_modeling.model_type`` lives in the variance adaptor."""

import json
import os

from torch import nn

from ctts_torch.models.blocks import Linear
from ctts_torch.models.postnet import PostNet
from ctts_torch.models.registry import block_hidden, get_block
from ctts_torch.models.variance_adaptor import VarianceAdaptor
from ctts_torch.ops.masks import get_mask_from_lengths


def prepare_model_config(preprocess_config, model_config):
    """Inject the dataset-derived energy range and, for a multi-speaker
    model with a speaker table, the speaker count (from ``speakers.json``,
    4 without one). Returns an updated copy of model_config."""
    mc = dict(model_config)
    if mc["variance_embedding"]["use_energy_embed"]:
        learn_alignment = mc["duration_modeling"]["learn_alignment"]
        feature = preprocess_config["preprocessing"]["energy"]["feature"]
        tag = ("phone" if (not learn_alignment and feature == "phoneme_level")
               else "frame")
        dataset_tag = "unsup" if learn_alignment else "sup"
        stats_path = os.path.join(
            preprocess_config["path"]["preprocessed_path"], "stats.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                stats = json.load(f)
            e_min, e_max = stats[f"energy_{dataset_tag}_{tag}"][:2]
        else:  # no preprocessed data yet (tests, dry runs)
            e_min, e_max = -1.0, 9.0
        mc["_energy_stats"] = (float(e_min), float(e_max))
    if mc["multi_speaker"] and _embedder(preprocess_config) == "none":
        spk_path = os.path.join(
            preprocess_config["path"]["preprocessed_path"], "speakers.json")
        if os.path.exists(spk_path):
            with open(spk_path) as f:
                mc["_n_speaker"] = len(json.load(f))
        else:                    # no preprocessed data yet (tests, dry runs)
            mc["_n_speaker"] = 4
    return mc


def _embedder(preprocess_config):
    return preprocess_config["preprocessing"].get("speaker_embedder", "none")


class CompTransTTS(nn.Module):
    def __init__(self, preprocess_config, model_config, train_config):
        super().__init__()
        mc = model_config
        TextEncoder, Decoder = get_block(mc["block_type"])
        enc_h, dec_h = block_hidden(mc)
        self.encoder = TextEncoder(mc)
        self.variance_adaptor = VarianceAdaptor(preprocess_config, mc,
                                                train_config, enc_h)
        self.decoder = Decoder(mc)
        self.mel_linear = Linear(
            dec_h, preprocess_config["preprocessing"]["mel"]["n_mel_channels"])
        self.postnet = PostNet()
        self.embedder = None
        if mc["multi_speaker"]:
            self.embedder = _embedder(preprocess_config)
            if self.embedder == "none":
                self.speaker_emb = nn.Embedding(mc["_n_speaker"], enc_h)
            else:
                self.speaker_emb = Linear(mc["external_speaker_dim"], enc_h)

    def forward(self, speakers, texts, src_lens, mode, mels=None,
                mel_lens=None, pitch_targets=None, energy_targets=None,
                duration_targets=None, attn_priors=None, spker_embeds=None,
                p_control=1.0, e_control=1.0, d_control=1.0, step=None,
                max_mel_len=None):
        """mode: "infer" | "train_unsup" | "train_sup".

        texts [B, T_s] int, src_lens [B]; in training mels [B, T_m, n_mel],
        mel_lens [B], the targets, the prior (``train_unsup``) or the
        durations (``train_sup``), and the host int ``step``; at inference
        max_mel_len is the frame budget. ``speakers`` [B] indexes the
        speaker table and ``spker_embeds`` [B, external_speaker_dim] feeds
        the external embedding's projection; a single-speaker model reads
        neither. Returns the JAX model's output dict.
        """
        src_masks = get_mask_from_lengths(src_lens, texts.shape[1])
        mel_masks = None
        if mels is not None:
            max_mel_len = mels.shape[1]
            mel_masks = get_mask_from_lengths(mel_lens, max_mel_len)
        elif max_mel_len is None:
            raise ValueError("max_mel_len (the frame budget) must be given")
        output, text_embeds = self.encoder(texts, src_masks)
        speaker_embeds = None
        if self.embedder == "none":
            speaker_embeds = self.speaker_emb(speakers.long())
        elif self.embedder is not None:
            if spker_embeds is None:
                raise ValueError(f"a {self.embedder} model needs the batch's "
                                 "spker_embeds")
            speaker_embeds = self.speaker_emb(spker_embeds.float())
        va = self.variance_adaptor(
            output, src_masks, mode, max_mel_len, p_control=p_control,
            e_control=e_control, d_control=d_control,
            text_embedding=text_embeds, src_len=src_lens, mel=mels,
            mel_len=mel_lens, mel_mask=mel_masks, pitch_target=pitch_targets,
            energy_target=energy_targets, duration_target=duration_targets,
            attn_prior=attn_priors, speaker_embedding=speaker_embeds,
            step=step)
        dec_out, mel_masks = self.decoder(va["x"], va["mel_mask"])
        mel_pred = self.mel_linear(dec_out)
        postnet_out = self.postnet(mel_pred) + mel_pred
        return {
            "mel_predictions": mel_pred,
            "postnet_mel_predictions": postnet_out,
            "pitch_predictions": va["pitch_predictions"],
            "energy_predictions": va["energy_prediction"],
            "log_duration_predictions": va["log_duration_prediction"],
            "dur_crf_ll": va["dur_crf_ll"],
            "duration_rounded": va["duration_rounded"],
            "src_masks": src_masks,
            "mel_masks": mel_masks,
            "src_lens": src_lens,
            "mel_lens": va["mel_len"],
            "attn_outs": va["attn_out"],
            "prosody_info": va.get("prosody_info"),
            "pitch_targets": va["pitch_target"],
            "energy_targets": va["energy_target"],
            "mel2ph": va["mel2ph"],
        }
