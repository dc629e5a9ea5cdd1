"""CompTransTTS loss (ctts_tpu/models/loss.py):

* weighted-L1 mel loss over frames with a nonzero target;
* duration loss at phone, word (segmented at silence phonemes) and
  sentence level; the phone term by ``dur_loss``: log-MSE (``mse``),
  SmoothL1 with δ = 1 on the log-duration (``huber``), the mixture's
  negative log-likelihood (``mog``) or the CRF's (``crf``); the word and
  sentence terms use the mixture mean or the softmax-expected class;
* pitch loss by ``pitch_type``: ``cwt`` (spectrogram l1/l2 or ``ssim``, uv
  BCE, f0 mean and std), ``frame`` (uv BCE, f0 on voiced frames) or ``ph``
  (f0 a token);
* energy L1 at the configured level;
* with ``learn_alignment``, ForwardSum CTC and the binarization loss with
  its warm-up weight; without it the durations come from the batch and
  both are zero;
* in training, the prosody term past ``prosody_loss_enable_steps``: the
  GMM-MDN's negative log-likelihood of the extractor's embeddings (their
  gradient stopped) times ``gmm_mdn_beta`` (du2021), or the L1 of the
  predicted utterance and phone prosody against the encoders' (liu2021);
* the ``var_start_steps`` gate on the variance terms.

``step`` is a host int, so each schedule gate is plain arithmetic.

Inside ``parallel.tensor_parallel.data_parallel`` every mean is this data
rank's numerator over the global batch's denominator (summed over the data
group), so the ranks' terms add up to the global batch's loss.
"""

import math

import torch

from ctts_torch.models.predictors import mog_mean, mog_nll
from ctts_torch.ops.forward_sum import bin_loss as _bin_loss
from ctts_torch.ops.forward_sum import forward_sum_loss
from ctts_torch.ops.ssim import ssim_loss
from ctts_torch.parallel.tensor_parallel import global_mean, global_sum
from ctts_torch.text import sil_phonemes_ids


def _masked_mean(x, mask_weight):
    return torch.sum(x * mask_weight) / global_sum(
        torch.sum(mask_weight)).clamp(min=1.0)


def weighted_mel_l1(pred, target, mel_pad_mask):
    """L1 weighted by nonzero-target frames."""
    pred = pred.masked_fill(mel_pad_mask[..., None], 0.0)
    target = target.masked_fill(mel_pad_mask[..., None], 0.0)
    weights = (target.abs().sum(dim=-1, keepdim=True) != 0).float()
    l1 = (pred - target).abs()
    return torch.sum(l1 * weights) / global_sum(
        torch.sum(weights) * target.shape[-1]).clamp(min=1.0)


def duration_loss(log_dur_pred, dur_gt, txt_tokens, src_pad_mask, loss_cfg,
                  crf_ll=None):
    """Phone, word and sentence duration losses. log_dur_pred is the head's
    output ([B, T], or [B, T, 15 | 32] for mog/crf); crf_ll [B] the CRF's
    log-likelihood of the durations (crf only)."""
    kind = loss_cfg["dur_loss"]
    nonpad = (~src_pad_mask).float()
    dur_gt = dur_gt.float() * nonpad
    is_sil = torch.zeros_like(txt_tokens, dtype=torch.bool)
    for p_id in sil_phonemes_ids():
        is_sil = is_sil | (txt_tokens == p_id)
    is_sil = is_sil.float()

    losses = {}
    if kind in ("mse", "huber"):
        err = log_dur_pred - torch.log(dur_gt + 1.0)
        if kind == "mse":
            pdur = err ** 2
        else:
            a = err.abs()
            pdur = torch.where(a < 1.0, 0.5 * err * err, a - 0.5)
        pdur = _masked_mean(pdur, nonpad)
        dur_pred = torch.clamp(torch.exp(log_dur_pred) - 1.0, min=0.0)
    elif kind == "mog":
        pdur = _masked_mean(mog_nll(log_dur_pred, torch.log(dur_gt + 1.0)),
                            nonpad)
        dur_pred = torch.clamp(torch.exp(mog_mean(log_dur_pred)) - 1.0,
                               min=0.0)
    elif kind == "crf":
        pdur = -global_mean(crf_ll)
        classes = torch.arange(log_dur_pred.shape[-1], dtype=torch.float32,
                               device=log_dur_pred.device)
        dur_pred = torch.sum(torch.softmax(log_dur_pred, dim=-1) * classes,
                             dim=-1)
    else:
        raise ValueError(f"unknown dur_loss {kind!r}")
    losses["pdur"] = pdur * loss_cfg["lambda_ph_dur"]
    dur_pred = dur_pred * nonpad

    if loss_cfg["lambda_word_dur"] > 0:
        B, T = txt_tokens.shape
        word_id = (torch.cumsum(is_sil, -1) * (1 - is_sil)).long()

        def wsum(vals):
            return vals.new_zeros(B, T + 1).scatter_add(1, word_id,
                                                        vals)[:, 1:]

        word_dur_p = wsum(dur_pred)
        word_dur_g = wsum(dur_gt)
        wdur = (torch.log(word_dur_p + 1.0) - torch.log(word_dur_g + 1.0)) ** 2
        word_nonpad = (word_dur_g > 0).float()
        losses["wdur"] = _masked_mean(wdur, word_nonpad) \
            * loss_cfg["lambda_word_dur"]
    if loss_cfg["lambda_sent_dur"] > 0:
        sdur = (torch.log(dur_pred.sum(-1) + 1.0)
                - torch.log(dur_gt.sum(-1) + 1.0)) ** 2
        losses["sdur"] = global_mean(sdur) * loss_cfg["lambda_sent_dur"]
    return losses


def _bce_logits(logits, labels):
    return torch.clamp(logits, min=0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


def _pitch_fn(kind):
    if kind not in ("l1", "l2"):
        raise ValueError(f"unknown pitch or cwt loss {kind!r}")
    return torch.abs if kind == "l1" else torch.square


def pitch_loss(pitch_predictions, pitch_targets, pitch_cfg, loss_cfg,
               mel_pad_mask, src_pad_mask=None):
    """The pitch terms of ``pitch_cfg["pitch_type"]``; ``ph`` needs
    ``src_pad_mask``."""
    pitch_type = pitch_cfg["pitch_type"]
    lam_f0 = loss_cfg["lambda_f0"]
    losses = {}
    if pitch_type == "ph":
        p_fn = _pitch_fn(loss_cfg["pitch_loss"])
        diff = p_fn(pitch_predictions["pitch_pred"][:, :, 0]
                    - pitch_targets["f0"])
        losses["f0"] = _masked_mean(diff, (~src_pad_mask).float()) * lam_f0
        return losses
    nonpad = (~mel_pad_mask).float()
    uv = pitch_targets["uv"]
    if pitch_type == "cwt":
        cwt_pred = pitch_predictions["cwt"][:, :, :10]
        cwt_tgt = pitch_targets["cwt_spec"]
        if loss_cfg["cwt_loss"] == "ssim":
            losses["C"] = ssim_loss(cwt_pred, cwt_tgt, bias=20.0) * lam_f0
        else:
            c_fn = _pitch_fn(loss_cfg["cwt_loss"])
            losses["C"] = global_mean(c_fn(cwt_pred - cwt_tgt)) * lam_f0
        if pitch_cfg["use_uv"]:
            uv_pred = pitch_predictions["cwt"][:, :, -1]
            losses["uv"] = _masked_mean(_bce_logits(uv_pred, uv), nonpad) \
                * loss_cfg["lambda_uv"]
        losses["f0_mean"] = global_mean(torch.abs(
            pitch_predictions["f0_mean"] - pitch_targets["f0_mean"])) * lam_f0
        losses["f0_std"] = global_mean(torch.abs(
            pitch_predictions["f0_std"] - pitch_targets["f0_std"])) * lam_f0
    elif pitch_type == "frame":
        p_fn = _pitch_fn(loss_cfg["pitch_loss"])
        p_pred = pitch_predictions["pitch_pred"]
        if pitch_cfg["use_uv"]:
            losses["uv"] = _masked_mean(_bce_logits(p_pred[:, :, 1], uv),
                                        nonpad) * loss_cfg["lambda_uv"]
            nonpad = nonpad * (uv == 0).float()        # f0 on voiced frames
        diff = p_fn(p_pred[:, :, 0] - pitch_targets["f0"])
        losses["f0"] = _masked_mean(diff, nonpad) * lam_f0
    else:
        raise ValueError(f"unknown pitch_type {pitch_type!r}")
    return losses


def energy_loss(pred, target, feature_level, src_pad_mask, mel_pad_mask):
    """Masked L1."""
    mask = src_pad_mask if feature_level == "phoneme_level" else mel_pad_mask
    return _masked_mean((pred - target).abs(), (~mask).float())


def mdn_loss(w, sigma, mu, target, src_pad_mask):
    """The mixture's mean negative log-likelihood of ``target`` [B, T, D]
    (its gradient stopped) over [B, T], padded phones counted as 0."""
    target = target.detach()[:, :, None, :]
    sigma = torch.clamp(sigma, min=1e-6)
    logp = (-torch.log(sigma) - 0.5 * math.log(2 * math.pi)
            - 0.5 * ((target - mu) / sigma) ** 2)
    logp = logp.masked_fill(src_pad_mask[:, :, None, None], 0.0).sum(dim=3)
    prob = torch.log(torch.clamp(w, min=1e-12)) + logp     # [B, T, G]
    nll = -torch.logsumexp(prob, dim=2)
    return global_mean(nll.masked_fill(src_pad_mask, 0.0))


def prosody_loss(info, model_type, src_pad_mask, prosody_cfg):
    """The prosody term before its schedule gate."""
    if model_type == "du2021":
        w, sigma, mu, emb = info
        return prosody_cfg["gmm_mdn_beta"] * mdn_loss(w, sigma, mu, emb,
                                                      src_pad_mask)
    up_tgt, pp_tgt, up_vec, pp_vec, _ = info
    nonpad = (~src_pad_mask)[..., None].float().expand(pp_tgt.shape)
    return global_mean(torch.abs(up_tgt - up_vec)) \
        + _masked_mean(torch.abs(pp_tgt - pp_vec), nonpad)


def compute_loss(inputs, predictions, step, preprocess_config, model_config,
                 train_config, training=True):
    """Returns (total, dict of component losses), all 0-d tensors.

    inputs: dict with texts, mels, src_lens, mel_lens (and durations
    without ``learn_alignment``). predictions: the
    model's output dict. step: host int. The prosody term is added only
    when ``training`` (validation reads it as 0).
    """
    loss_cfg = train_config["loss"]
    pitch_cfg = preprocess_config["preprocessing"]["pitch"]
    model_type = model_config["prosody_modeling"]["model_type"]
    use_pitch = model_config["variance_embedding"]["use_pitch_embed"]
    use_energy = model_config["variance_embedding"]["use_energy_embed"]
    energy_level = preprocess_config["preprocessing"]["energy"]["feature"]
    step = int(step)

    src_masks = predictions["src_masks"]                # True at padding
    mel_masks = predictions["mel_masks"]
    mel_targets = inputs["mels"][:, : mel_masks.shape[1], :]
    zero = mel_targets.new_zeros(())

    L = {}
    L["mel"] = weighted_mel_l1(predictions["mel_predictions"], mel_targets,
                               mel_masks)
    L["postnet_mel"] = weighted_mel_l1(
        predictions["postnet_mel_predictions"], mel_targets, mel_masks)

    if model_config["duration_modeling"]["learn_alignment"]:
        attn_soft, attn_hard, duration_targets, attn_logprob = \
            predictions["attn_outs"]
        L["ctc"] = forward_sum_loss(attn_logprob, inputs["src_lens"],
                                    inputs["mel_lens"])
        tc = train_config["duration"]
        w = min(max((step - tc["binarization_loss_enable_steps"])
                    / tc["binarization_loss_warmup_steps"], 0.0), 1.0)
        L["bin"] = _bin_loss(attn_hard, attn_soft) * w
    else:
        duration_targets = inputs["durations"]
        L["ctc"] = L["bin"] = zero
    L["prosody"] = zero
    if training and model_type != "none":
        gate = float(step > train_config["prosody"][
            "prosody_loss_enable_steps"])
        L["prosody"] = gate * prosody_loss(predictions["prosody_info"],
                                           model_type, src_masks,
                                           train_config["prosody"])
    total = L["mel"] + L["postnet_mel"] + L["ctc"] + L["bin"] + L["prosody"]

    # variance losses, gated by var_start_steps
    var_gate = float(step > train_config["step"]["var_start_steps"])
    d_losses = duration_loss(predictions["log_duration_predictions"],
                             duration_targets, inputs["texts"], src_masks,
                             loss_cfg, crf_ll=predictions.get("dur_crf_ll"))
    for k, v in d_losses.items():
        L[k] = v * var_gate
        total = total + L[k]
    if use_pitch:
        p_losses = pitch_loss(predictions["pitch_predictions"],
                              predictions["pitch_targets"], pitch_cfg,
                              loss_cfg, mel_masks, src_masks)
        for k, v in p_losses.items():
            L["pitch_" + k] = v * var_gate
            total = total + L["pitch_" + k]
    if use_energy:
        e = energy_loss(predictions["energy_predictions"],
                        predictions["energy_targets"], energy_level,
                        src_masks, mel_masks)
        L["energy"] = e * var_gate
        total = total + L["energy"]

    L["total"] = total
    return total, L
