"""Variance adaptor (ctts_tpu/models/variance_adaptor.py) in its three
modes, ``infer``, ``train_unsup`` and ``train_sup``.

Durations: in ``train_unsup`` the aligner's soft attention is binarized by
MAS and its column sums are the durations; the hidden is upsampled softly
(attention einsum) before ``binarization_start_steps`` and by the row
gather from it on. In ``train_sup`` the durations come from the batch and
``mel2ph`` from the batch's ``pitch_data["mel2ph"]`` when it holds one
(else from the durations); the hidden goes through the row gather. At
inference the duration head's prediction (the log-duration for mse/huber,
the mixture mean for mog, log(1 + the Viterbi classes) for crf) is rounded
to durations → ``mel2ph`` → the row gather. With the crf head, training
also returns the CRF log-likelihood of the durations clipped to [0, 31].

Pitch, by ``pitch_type``: ``cwt`` (a predicted spectrogram and
per-utterance statistics → f0; the target f0 comes from the target
spectrogram), ``frame`` (f0 and uv a frame, or with ``pitch_ar`` the
autoregressive head, teacher-forced only while dropout is on; padded
frames take f0 = 0, so bin 1, not the zero row), or ``ph`` (one f0 a
token on the encoder output, the target the per-token mean of the frame
f0; the coarse bins go to frames through the row gather on an integer
tensor). Energy at ``phoneme_level`` (predicted per token, bucketed,
embedded, upsampled by the row gather; in ``train_unsup`` the target is
the frame energy averaged over the MAS durations, in ``train_sup`` the
store's phone-level values) or ``frame_level`` (predicted on the frame
hidden under the frame mask). The embeddings take their buckets from the
targets in training. Each predictor's input passes :func:`grad_scale`.

Prosody (``prosody_modeling.model_type``), before the duration head:
``du2021`` predicts a Gaussian mixture a phone from the text hidden before
the speaker vector is added, and adds (bias-free ``prosody_linear``) the
extractor's embeddings of the target mel in training (it needs the
batch's durations), a draw from the mixture at inference; ``liu2021`` adds
the utterance and phone prosody of its reference encoders in training and
of its predictors at inference. ``prosody_info`` (in the output dict of
a prosody model only) carries what the loss reads.
"""

import numpy as np
import torch
from torch import nn

from ctts_torch.models.aligner import AlignmentEncoder
from ctts_torch.models.blocks import Linear, grad_scale
from ctts_torch.models.conformer import LinearNorm
from ctts_torch.models.predictors import (CwtStatsLayers, DurationPredictor,
                                          EnergyPredictor, PitchPredictor,
                                          PitchPredictorAR, mog_mean)
from ctts_torch.models.prosody import (DuProsodyExtractor, DuProsodyPredictor,
                                       liu_prosody, liu_prosody_modules)
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
        self.pitch_ar = bool(self.pitch_cfg.get("pitch_ar", False))
        self.use_uv = self.pitch_cfg["use_uv"]
        self.use_pitch_embed = mc["variance_embedding"]["use_pitch_embed"]
        self.use_energy_embed = mc["variance_embedding"]["use_energy_embed"]
        self.energy_feature_level = pc["preprocessing"]["energy"]["feature"]
        self.learn_alignment = mc["duration_modeling"]["learn_alignment"]
        self.binarization_start_steps = \
            tc["duration"]["binarization_start_steps"]
        self.predictor_grad = vp["predictor_grad"]
        self.dur_loss = tc["loss"]["dur_loss"]

        self.model_type = mc["prosody_modeling"]["model_type"]
        if self.model_type not in ("none", "du2021", "liu2021"):
            raise ValueError(f"unknown prosody model {self.model_type!r}")
        if self.pitch_type not in ("cwt", "frame", "ph"):
            raise ValueError(f"unknown pitch_type {self.pitch_type!r}")
        if self.energy_feature_level not in ("phoneme_level", "frame_level"):
            raise ValueError(
                f"unknown energy feature {self.energy_feature_level!r}")
        pred = dict(n_layers=vp["predictor_layers"],
                    n_chans=vp["filter_size"],
                    kernel_size=vp["predictor_kernel"],
                    dropout=vp["dropout"], padding=vp["ffn_padding"])

        self.duration_predictor = DurationPredictor(
            d_model, n_layers=vp["dur_predictor_layers"],
            n_chans=vp["filter_size"], kernel_size=vp["dur_predictor_kernel"],
            dropout=vp["dropout"], padding=vp["ffn_padding"],
            dur_loss=self.dur_loss)

        if self.use_pitch_embed:
            if self.pitch_type == "cwt":
                h = vp["cwt_hidden_size"]
                self.cwt_std_scale = vp["cwt_std_scale"]
                # upstream: cwt_predictor = Sequential(Linear, PitchPredictor)
                self.cwt_predictor = nn.ModuleList([
                    Linear(d_model, h),
                    PitchPredictor(h, odim=11 if self.use_uv else 10,
                                   **pred)])
                self.cwt_stats_layers = CwtStatsLayers(d_model, hidden=h)
            elif self.pitch_ar:
                if self.pitch_type != "frame":
                    raise ValueError(
                        "pitch_ar requires pitch_type 'frame' (got "
                        f"{self.pitch_type!r})")
                self.pitch_predictor = PitchPredictorAR(d_model, odim=2,
                                                        **pred)
            else:
                self.pitch_predictor = PitchPredictor(
                    d_model, odim=2 if self.pitch_type == "frame" else 1,
                    **pred)
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
            self.energy_predictor = EnergyPredictor(d_model, odim=1, **pred)
            self.energy_embedding = nn.Embedding(n_bins, d_model)

        if self.learn_alignment:
            n_mel = pc["preprocessing"]["mel"]["n_mel_channels"]
            self.aligner = AlignmentEncoder(
                n_mel_channels=n_mel, n_att_channels=n_mel,
                n_text_channels=d_model,
                temperature=mc["duration_modeling"]["aligner_temperature"],
                multi_speaker=mc["multi_speaker"])

        if self.model_type == "du2021":
            du = mc["prosody_modeling"]["du2021"]
            self.prosody_extractor = DuProsodyExtractor(
                pc["preprocessing"]["mel"]["n_mel_channels"], d_model,
                du["extractor_kernel_size"])
            self.prosody_predictor = DuProsodyPredictor(
                d_model, tuple(du["predictor_kernel_size"]),
                du["predictor_num_gaussians"], du["predictor_dropout"])
            self.prosody_linear = LinearNorm(2 * d_model, d_model, bias=False)
        elif self.model_type == "liu2021":
            for name, m in liu_prosody_modules(pc, mc).items():
                self.add_module(name, m)

    def forward(self, x, src_mask, mode, max_mel_len, p_control=1.0,
                e_control=1.0, d_control=1.0, text_embedding=None,
                src_len=None, mel=None, mel_len=None, mel_mask=None,
                pitch_target=None, energy_target=None, duration_target=None,
                attn_prior=None, speaker_embedding=None, step=None):
        """x: [B, T_s, H] encoder output; src_mask True at padding;
        ``speaker_embedding`` [B, H] (multi-speaker models) is added to
        every token of x and handed to the aligner;
        max_mel_len: the frame budget (the padded mel length in training).
        mode: "infer" | "train_unsup" | "train_sup". ``step`` is a host
        int; ``duration_target`` [B, T_s] the supervised durations.
        Returns a dict."""
        if mode not in ("infer", "train_unsup", "train_sup"):
            raise ValueError(f"unknown mode {mode!r}")
        training = mode != "infer"
        pitch_target = dict(pitch_target) if pitch_target else {}
        x_text = x
        if speaker_embedding is not None:
            x = x + speaker_embedding[:, None, :]
        prosody_info = None
        if self.model_type == "du2021":
            w, sigma, mu = self.prosody_predictor(x_text, src_mask, training)
            if training:
                if duration_target is None:
                    raise ValueError("du2021 extracts prosody over the "
                                     "batch's durations (learn_alignment: "
                                     "False)")
                emb = self.prosody_extractor(mel, duration_target, src_mask)
            else:
                # drawn from seed 0 at each call, as the JAX model's
                # default key
                emb = DuProsodyPredictor.sample(w, sigma, mu,
                                                src_mask=src_mask)
            x = x + self.prosody_linear(emb)
            prosody_info = (w, sigma, mu, emb)
        elif self.model_type == "liu2021":
            x, prosody_info = liu_prosody(self, x, src_mask, mel, mel_mask,
                                          training)
        log_duration_prediction = self.duration_predictor(
            grad_scale(x, self.predictor_grad), src_mask)

        max_len = max_mel_len
        attn_out = (None, None, None, None)
        if mode == "train_unsup":
            if not self.learn_alignment:
                raise ValueError("train_unsup needs learn_alignment")
            attn_soft, attn_logprob = self.aligner(
                mel, text_embedding, src_mask, attn_prior, speaker_embedding)
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
        elif mode == "train_sup":
            mel2ph = pitch_target.get("mel2ph")
            if mel2ph is None:
                mel2ph = dur_to_mel2ph(duration_target, src_mask,
                                       max_len=max_len)
            x_up = gather_by_mel2ph(x, mel2ph)
            duration_rounded = duration_target
            pitch_target["mel2ph"] = mel2ph
        else:
            if self.dur_loss == "mog":
                log_dur = mog_mean(log_duration_prediction)
            elif self.dur_loss == "crf":
                log_dur = torch.log(1.0 + self.duration_predictor.crf.decode(
                    log_duration_prediction, ~src_mask).float())
            else:
                log_dur = log_duration_prediction
            duration_rounded = torch.clamp(
                torch.round(torch.exp(log_dur) - 1.0) * d_control, min=0.0)
            duration_rounded = duration_rounded.masked_fill(src_mask, 0.0)
            mel2ph = dur_to_mel2ph(duration_rounded, src_mask,
                                   max_len=max_len)
            x_up = gather_by_mel2ph(x, mel2ph)
            mel_len = torch.clamp(duration_rounded.int().sum(dim=1),
                                  max=max_len).int()
            mel_mask = get_mask_from_lengths(mel_len, max_len)

        dur_crf_ll = None
        if self.dur_loss == "crf" and training:
            tags = torch.clamp(duration_rounded.int(), 0, 31)
            dur_crf_ll = self.duration_predictor.crf.log_likelihood(
                log_duration_prediction, tags, ~src_mask)

        pitch_predictions = None
        pitch_embedding = 0.0
        if self.use_pitch_embed:
            f0 = uv = None
            if training:
                if self.pitch_type == "cwt":
                    pitch_target["f0"] = cwt2f0_norm(
                        pitch_target["cwt_spec"], pitch_target["f0_mean"],
                        pitch_target["f0_std"], max_len, self.pitch_cfg)
                    pitch_target["f0_cwt"] = pitch_target["f0"]
                elif self.pitch_type == "ph":
                    pitch_target["f0"] = phoneme_mean_by_mel2ph(
                        pitch_target["f0"], mel2ph, x.shape[1])
                f0, uv = pitch_target["f0"], pitch_target.get("uv")
            pitch_predictions, pitch_embedding = self._pitch(
                x_up, x, f0, uv, mel2ph, p_control, mel_mask, src_mask)

        energy_prediction = None
        energy_embedding = 0.0
        if self.use_energy_embed:
            target = energy_target if training else None
            if self.energy_feature_level == "frame_level":
                energy_prediction, energy_embedding = self._energy(
                    x_up, target, e_control, mel_mask)
            else:
                if mode == "train_unsup":
                    # no pre-extracted phone-level energy: average the frame
                    # energy over the MAS durations
                    energy_target = target = phoneme_mean_by_mel2ph(
                        energy_target, mel2ph, x.shape[1])
                energy_prediction, ph_embedding = self._energy(
                    x, target, e_control, src_mask)
                energy_embedding = gather_by_mel2ph(ph_embedding, mel2ph)

        out = {
            "x": x_up + pitch_embedding + energy_embedding,
            "pitch_target": pitch_target if pitch_target else None,
            "pitch_predictions": pitch_predictions,
            "energy_target": energy_target,
            "energy_prediction": energy_prediction,
            "log_duration_prediction": log_duration_prediction,
            "dur_crf_ll": dur_crf_ll,
            "duration_rounded": duration_rounded,
            "mel_len": mel_len,
            "mel_mask": mel_mask,
            "mel2ph": mel2ph,
            "attn_out": attn_out,
        }
        if self.model_type != "none":
            out["prosody_info"] = prosody_info
        return out

    def _pitch(self, decoder_inp, encoder_out, f0, uv, mel2ph, control,
               frame_mask, src_mask):
        """get_pitch_embedding (variance_adaptor.py:333-399): the embedding
        comes from the target f0 in training, from the prediction at
        inference."""
        pitch_pred = f0_denorm = cwt = f0_mean = f0_std = None
        if self.pitch_type == "ph":
            pitch_pred = self.pitch_predictor(
                grad_scale(encoder_out, self.predictor_grad),
                src_mask) * control
            if f0 is None:
                f0 = pitch_pred[:, :, 0]
            f0_denorm = denorm_f0(f0, None, self.pitch_cfg)
            pitch = f0_to_coarse(f0_denorm).masked_fill(src_mask, 0)
            pitch_embed = self.pitch_embed(gather_by_mel2ph(pitch, mel2ph))
        else:
            inp = grad_scale(decoder_inp, self.predictor_grad)
            pitch_padding = mel2ph == 0
            if self.pitch_type == "cwt":
                pitch_padding = None
                proj, predictor = self.cwt_predictor
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
            else:
                if self.pitch_ar:
                    # teacher-forced on the target only while dropout is on
                    pitch_pred = self.pitch_predictor(
                        inp, frame_mask, f0=f0 if self.training else None)
                else:
                    pitch_pred = self.pitch_predictor(inp, frame_mask)
                pitch_pred = pitch_pred * control
                if f0 is None:
                    f0 = pitch_pred[:, :, 0]
                if self.use_uv and uv is None:
                    uv = (pitch_pred[:, :, 1] > 0).float()
            # padded frames land in bin 1 (f0 = 0 through pitch_padding),
            # not the zero row, as in the JAX package and upstream
            f0_denorm = denorm_f0(f0, uv, self.pitch_cfg,
                                  pitch_padding=pitch_padding)
            pitch_embed = self.pitch_embed(f0_to_coarse(f0_denorm))
        predictions = {"pitch_pred": pitch_pred, "f0_denorm": f0_denorm,
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
