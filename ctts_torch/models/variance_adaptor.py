"""Variance adaptor (ctts_tpu/models/variance_adaptor.py), the ``infer`` and
``train_unsup`` branches.

At inference: duration prediction → rounded durations → ``mel2ph`` → hidden
upsample by the row gather; CWT pitch (predicted spectrogram +
per-utterance stats → f0 → coarse bins → embedding); phoneme-level energy
(predicted per token, bucketed, embedded, upsampled by the row gather).

In ``train_unsup``: the aligner's soft attention is binarized by MAS, its
column sums are the durations, and the hidden is upsampled softly (attention
einsum) before ``binarization_start_steps`` and by the row gather from it
on; the f0 target comes from the target CWT spectrogram, the energy target
is averaged per phoneme over the MAS durations, and the pitch and energy
embeddings take their buckets from the targets. Each predictor's input
passes :func:`grad_scale`.

Supervised training, frame or phoneme pitch, frame-level energy, mog/crf
durations and prosody models are not ported yet and raise.
"""

import numpy as np
import torch
from torch import nn

from ctts_torch.models.aligner import AlignmentEncoder
from ctts_torch.models.blocks import Linear, grad_scale
from ctts_torch.models.predictors import (CwtStatsLayers, DurationPredictor,
                                          EnergyPredictor, PitchPredictor)
from ctts_torch.ops.cwt import cwt2f0_norm
from ctts_torch.ops.length_regulator import dur_to_mel2ph, gather_by_mel2ph
from ctts_torch.ops.mas import b_mas
from ctts_torch.ops.masks import get_mask_from_lengths
from ctts_torch.ops.pitch import denorm_f0, f0_to_coarse
from ctts_torch.ops.segment import phoneme_mean_by_mel2ph


def _linspace_f32(start, stop, num):
    """jnp.linspace's float32 formula: start·(1-s) + stop·s, s = i/(num-1),
    with the endpoint exact."""
    f = np.float32
    step = np.arange(num - 1, dtype=f) / f(num - 1)
    out = f(start) * (f(1) - step) + f(stop) * step
    return torch.from_numpy(np.append(out, f(stop)).astype(f))


class VarianceAdaptor(nn.Module):
    def __init__(self, preprocess_config, model_config, train_config,
                 d_model):
        super().__init__()
        mc, pc, tc = model_config, preprocess_config, train_config
        vp = mc["variance_predictor"]
        self.pitch_cfg = pc["preprocessing"]["pitch"]
        self.pitch_type = self.pitch_cfg["pitch_type"]
        self.use_uv = self.pitch_cfg["use_uv"]
        self.use_pitch_embed = mc["variance_embedding"]["use_pitch_embed"]
        self.use_energy_embed = mc["variance_embedding"]["use_energy_embed"]
        self.energy_feature_level = pc["preprocessing"]["energy"]["feature"]
        self.learn_alignment = mc["duration_modeling"]["learn_alignment"]
        self.binarization_start_steps = \
            tc["duration"]["binarization_start_steps"]
        self.predictor_grad = vp["predictor_grad"]

        if mc["prosody_modeling"]["model_type"] != "none":
            raise NotImplementedError(
                "prosody models are not ported yet (ROADMAP.md §1 item 13)")
        if self.use_pitch_embed and (self.pitch_type != "cwt"
                                     or self.pitch_cfg.get("pitch_ar")):
            raise NotImplementedError(
                f"pitch_type {self.pitch_type!r} (and pitch_ar) is not ported "
                "yet (ROADMAP.md §1 item 10); only cwt is")
        if self.use_energy_embed and \
                self.energy_feature_level != "phoneme_level":
            raise NotImplementedError(
                "frame-level energy is not ported yet (ROADMAP.md §1 item 10)")

        self.duration_predictor = DurationPredictor(
            d_model, n_layers=vp["dur_predictor_layers"],
            n_chans=vp["filter_size"], kernel_size=vp["dur_predictor_kernel"],
            dropout=vp["dropout"], padding=vp["ffn_padding"],
            dur_loss=tc["loss"]["dur_loss"])

        if self.use_pitch_embed:
            h = vp["cwt_hidden_size"]
            self.cwt_std_scale = vp["cwt_std_scale"]
            # upstream: cwt_predictor = Sequential(Linear, PitchPredictor)
            self.cwt_predictor = nn.ModuleList([
                Linear(d_model, h),
                PitchPredictor(h, odim=11 if self.use_uv else 10,
                               n_layers=vp["predictor_layers"],
                               n_chans=vp["filter_size"],
                               kernel_size=vp["predictor_kernel"],
                               dropout=vp["dropout"],
                               padding=vp["ffn_padding"])])
            self.cwt_stats_layers = CwtStatsLayers(d_model, hidden=h)
            self.pitch_embed = nn.Embedding(
                mc["variance_embedding"]["pitch_n_bins"], d_model)

        if self.use_energy_embed:
            n_bins = mc["variance_embedding"]["energy_n_bins"]
            e_min, e_max = mc["_energy_stats"]
            if mc["variance_embedding"]["energy_quantization"] == "log":
                bins = torch.exp(_linspace_f32(np.log(e_min), np.log(e_max),
                                               n_bins - 1))
            else:
                bins = _linspace_f32(e_min, e_max, n_bins - 1)
            self.register_buffer("energy_bins", bins, persistent=False)
            self.energy_predictor = EnergyPredictor(
                d_model, odim=1, n_layers=vp["predictor_layers"],
                n_chans=vp["filter_size"], kernel_size=vp["predictor_kernel"],
                dropout=vp["dropout"], padding=vp["ffn_padding"])
            self.energy_embedding = nn.Embedding(n_bins, d_model)

        if self.learn_alignment:
            n_mel = pc["preprocessing"]["mel"]["n_mel_channels"]
            self.aligner = AlignmentEncoder(
                n_mel_channels=n_mel, n_att_channels=n_mel,
                n_text_channels=d_model,
                temperature=mc["duration_modeling"]["aligner_temperature"],
                multi_speaker=mc["multi_speaker"])

    def forward(self, x, src_mask, mode, max_mel_len, p_control=1.0,
                e_control=1.0, d_control=1.0, text_embedding=None,
                src_len=None, mel=None, mel_len=None, mel_mask=None,
                pitch_target=None, energy_target=None, attn_prior=None,
                step=None):
        """x: [B, T_s, H] encoder output; src_mask True at padding;
        max_mel_len: the frame budget (the padded mel length in training).
        mode: "infer" | "train_unsup". ``step`` is a host int. Returns a
        dict."""
        if mode == "train_sup":
            raise NotImplementedError(
                "mode 'train_sup' is not ported yet (ROADMAP.md §1 item 10)")
        if mode not in ("infer", "train_unsup"):
            raise ValueError(f"unknown mode {mode!r}")
        training = mode == "train_unsup"
        pitch_target = dict(pitch_target) if pitch_target else {}
        log_duration_prediction = self.duration_predictor(
            grad_scale(x, self.predictor_grad), src_mask)

        max_len = max_mel_len
        attn_out = (None, None, None, None)
        if training:
            if not self.learn_alignment:
                raise ValueError("train_unsup needs learn_alignment")
            attn_soft, attn_logprob = self.aligner(mel, text_embedding,
                                                   src_mask, attn_prior)
            attn_hard = b_mas(attn_soft, src_len.to(torch.int32),
                              mel_len.to(torch.int32))
            attn_hard_dur = attn_hard.sum(dim=1)               # [B, T_s]
            attn_out = (attn_soft, attn_hard, attn_hard_dur, attn_logprob)
            mel2ph = dur_to_mel2ph(attn_hard_dur, src_mask, max_len=max_len)
            if step < self.binarization_start_steps:
                x_up = torch.einsum("bms,bsc->bmc", attn_soft.to(x.dtype), x)
            else:
                x_up = gather_by_mel2ph(x, mel2ph)
            duration_rounded = attn_hard_dur
            pitch_target["mel2ph"] = mel2ph
        else:
            duration_rounded = torch.clamp(
                torch.round(torch.exp(log_duration_prediction) - 1.0)
                * d_control, min=0.0)
            duration_rounded = duration_rounded.masked_fill(src_mask, 0.0)
            mel2ph = dur_to_mel2ph(duration_rounded, src_mask,
                                   max_len=max_len)
            x_up = gather_by_mel2ph(x, mel2ph)
            mel_len = torch.clamp(duration_rounded.int().sum(dim=1),
                                  max=max_len).int()
            mel_mask = get_mask_from_lengths(mel_len, max_len)

        pitch_predictions = None
        pitch_embedding = 0.0
        if self.use_pitch_embed:
            f0 = uv = None
            if training:
                pitch_target["f0"] = cwt2f0_norm(
                    pitch_target["cwt_spec"], pitch_target["f0_mean"],
                    pitch_target["f0_std"], max_len, self.pitch_cfg)
                pitch_target["f0_cwt"] = pitch_target["f0"]
                f0, uv = pitch_target["f0"], pitch_target.get("uv")
            pitch_predictions, pitch_embedding = self._pitch(
                x_up, x, f0, uv, p_control, mel_mask)

        energy_prediction = None
        energy_embedding = 0.0
        if self.use_energy_embed:
            if training:
                # no pre-extracted phone-level energy: average the frame
                # energy over the MAS durations
                energy_target = phoneme_mean_by_mel2ph(
                    energy_target, mel2ph, x.shape[1])
            energy_prediction, ph_embedding = self._energy(
                x, energy_target if training else None, e_control, src_mask)
            energy_embedding = gather_by_mel2ph(ph_embedding, mel2ph)

        return {
            "x": x_up + pitch_embedding + energy_embedding,
            "pitch_target": pitch_target if pitch_target else None,
            "pitch_predictions": pitch_predictions,
            "energy_target": energy_target,
            "energy_prediction": energy_prediction,
            "log_duration_prediction": log_duration_prediction,
            "duration_rounded": duration_rounded,
            "mel_len": mel_len,
            "mel_mask": mel_mask,
            "mel2ph": mel2ph,
            "attn_out": attn_out,
        }

    def _pitch(self, decoder_inp, encoder_out, f0, uv, control, frame_mask):
        """CWT pitch (variance_adaptor.py:349-364, :384-390): the embedding
        comes from the target f0 in training, from the predicted spectrogram
        and statistics at inference."""
        proj, predictor = self.cwt_predictor
        inp = grad_scale(decoder_inp, self.predictor_grad)
        cwt = predictor(proj(inp), frame_mask) * control
        stats = self.cwt_stats_layers(encoder_out[:, 0, :]).float()
        f0_mean = stats[:, 0]
        f0_std = stats[:, 1]
        if f0 is None:
            f0 = cwt2f0_norm(cwt[:, :, :10], f0_mean,
                             f0_std * self.cwt_std_scale,
                             decoder_inp.shape[1], self.pitch_cfg)
            if self.use_uv:
                uv = (cwt[:, :, -1] > 0).float()
        f0_denorm = denorm_f0(f0, uv, self.pitch_cfg)
        pitch_embed = self.pitch_embed(f0_to_coarse(f0_denorm))
        predictions = {"pitch_pred": None, "f0_denorm": f0_denorm,
                       "cwt": cwt, "f0_mean": f0_mean, "f0_std": f0_std}
        return predictions, pitch_embed

    def _energy(self, x, target, control, mask):
        prediction = self.energy_predictor(
            grad_scale(x, self.predictor_grad), mask)[..., 0]
        # jnp.searchsorted(side="left") == bucketize(right=False)
        if target is not None:
            buckets = torch.bucketize(target, self.energy_bins, right=False)
        else:
            prediction = prediction * control
            buckets = torch.bucketize(prediction, self.energy_bins,
                                      right=False)
        return prediction, self.energy_embedding(buckets)
