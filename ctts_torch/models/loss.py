"""CompTransTTS loss (ctts_tpu/models/loss.py), the terms the shipped
default reaches:

* weighted-L1 mel loss over frames with a nonzero target;
* duration loss at phone (log-MSE), word (segmented at silence phonemes)
  and sentence level;
* CWT pitch loss: spectrogram (l1/l2), uv (BCE), f0 mean and std;
* energy L1 at the configured level;
* ForwardSum CTC and the binarization loss with its warm-up weight;
* the ``var_start_steps`` gate on the variance terms.

``step`` is a host int, so each schedule gate is plain arithmetic. The
``huber``/``mog``/``crf`` duration losses, the ``ssim`` CWT loss, the
``frame``/``ph`` pitch terms and the prosody terms are not ported yet and
raise ``NotImplementedError`` naming the ROADMAP item that will lift them.
"""

import torch

from ctts_torch.ops.forward_sum import bin_loss as _bin_loss
from ctts_torch.ops.forward_sum import forward_sum_loss
from ctts_torch.text import sil_phonemes_ids


def _masked_mean(x, mask_weight):
    return torch.sum(x * mask_weight) / torch.sum(mask_weight).clamp(min=1.0)


def weighted_mel_l1(pred, target, mel_pad_mask):
    """L1 weighted by nonzero-target frames."""
    pred = pred.masked_fill(mel_pad_mask[..., None], 0.0)
    target = target.masked_fill(mel_pad_mask[..., None], 0.0)
    weights = (target.abs().sum(dim=-1, keepdim=True) != 0).float()
    l1 = (pred - target).abs()
    return torch.sum(l1 * weights) / (
        torch.sum(weights) * target.shape[-1]).clamp(min=1.0)


def duration_loss(log_dur_pred, dur_gt, txt_tokens, src_pad_mask, loss_cfg):
    """Phone, word and sentence duration losses for the ``mse`` head."""
    kind = loss_cfg["dur_loss"]
    if kind in ("huber", "mog", "crf"):
        raise NotImplementedError(
            f"dur_loss {kind!r} is not ported yet (ROADMAP.md §1 item 10)")
    if kind != "mse":
        raise ValueError(f"unknown dur_loss {kind!r}")
    nonpad = (~src_pad_mask).float()
    dur_gt = dur_gt.float() * nonpad
    is_sil = torch.zeros_like(txt_tokens, dtype=torch.bool)
    for p_id in sil_phonemes_ids():
        is_sil = is_sil | (txt_tokens == p_id)
    is_sil = is_sil.float()

    losses = {}
    pdur = (log_dur_pred - torch.log(dur_gt + 1.0)) ** 2
    losses["pdur"] = _masked_mean(pdur, nonpad) * loss_cfg["lambda_ph_dur"]
    dur_pred = torch.clamp(torch.exp(log_dur_pred) - 1.0, min=0.0) * nonpad

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
        losses["sdur"] = torch.mean(sdur) * loss_cfg["lambda_sent_dur"]
    return losses


def _bce_logits(logits, labels):
    return torch.clamp(logits, min=0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


def pitch_loss(pitch_predictions, pitch_targets, pitch_cfg, loss_cfg,
               mel_pad_mask):
    """The ``cwt`` pitch terms."""
    pitch_type = pitch_cfg["pitch_type"]
    if pitch_type != "cwt":
        raise NotImplementedError(
            f"the {pitch_type!r} pitch loss is not ported yet (ROADMAP.md §1 "
            "item 10)")
    if loss_cfg["cwt_loss"] == "ssim":
        raise NotImplementedError(
            "the ssim CWT loss is not ported yet (ROADMAP.md §1 item 10)")
    if loss_cfg["cwt_loss"] not in ("l1", "l2"):
        raise ValueError(f"unknown cwt_loss {loss_cfg['cwt_loss']!r}")
    lam_f0 = loss_cfg["lambda_f0"]
    losses = {}
    diff = pitch_predictions["cwt"][:, :, :10] - pitch_targets["cwt_spec"]
    c = diff.abs() if loss_cfg["cwt_loss"] == "l1" else diff ** 2
    losses["C"] = torch.mean(c) * lam_f0
    if pitch_cfg["use_uv"]:
        nonpad = (~mel_pad_mask).float()
        uv_pred = pitch_predictions["cwt"][:, :, -1]
        losses["uv"] = _masked_mean(
            _bce_logits(uv_pred, pitch_targets["uv"]), nonpad) \
            * loss_cfg["lambda_uv"]
    losses["f0_mean"] = torch.mean(torch.abs(
        pitch_predictions["f0_mean"] - pitch_targets["f0_mean"])) * lam_f0
    losses["f0_std"] = torch.mean(torch.abs(
        pitch_predictions["f0_std"] - pitch_targets["f0_std"])) * lam_f0
    return losses


def energy_loss(pred, target, feature_level, src_pad_mask, mel_pad_mask):
    """Masked L1."""
    mask = src_pad_mask if feature_level == "phoneme_level" else mel_pad_mask
    return _masked_mean((pred - target).abs(), (~mask).float())


def compute_loss(inputs, predictions, step, preprocess_config, model_config,
                 train_config):
    """Returns (total, dict of component losses), all 0-d tensors.

    inputs: dict with texts, mels, src_lens, mel_lens. predictions: the
    model's output dict. step: host int.
    """
    loss_cfg = train_config["loss"]
    pitch_cfg = preprocess_config["preprocessing"]["pitch"]
    if not model_config["duration_modeling"]["learn_alignment"]:
        raise NotImplementedError(
            "the supervised-duration loss is not ported yet (ROADMAP.md §1 "
            "item 10)")
    if model_config["prosody_modeling"]["model_type"] != "none":
        raise NotImplementedError(
            "the prosody losses are not ported yet (ROADMAP.md §1 item 13)")
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

    attn_soft, attn_hard, attn_hard_dur, attn_logprob = \
        predictions["attn_outs"]
    L["ctc"] = forward_sum_loss(attn_logprob, inputs["src_lens"],
                                inputs["mel_lens"])
    tc = train_config["duration"]
    w = min(max((step - tc["binarization_loss_enable_steps"])
                / tc["binarization_loss_warmup_steps"], 0.0), 1.0)
    L["bin"] = _bin_loss(attn_hard, attn_soft) * w
    L["prosody"] = zero
    total = L["mel"] + L["postnet_mel"] + L["ctc"] + L["bin"] + L["prosody"]

    # variance losses, gated by var_start_steps
    var_gate = float(step > train_config["step"]["var_start_steps"])
    d_losses = duration_loss(predictions["log_duration_predictions"],
                             attn_hard_dur, inputs["texts"], src_masks,
                             loss_cfg)
    for k, v in d_losses.items():
        L[k] = v * var_gate
        total = total + L[k]
    if use_pitch:
        p_losses = pitch_loss(predictions["pitch_predictions"],
                              predictions["pitch_targets"], pitch_cfg,
                              loss_cfg, mel_masks)
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
