"""Reference-grade synthesis/validation figures (ctts_tpu/utils/figures.py).

Replicates the debugging surface of the reference's ``synth_one_sample``
(ref utils/tools.py:206-313) and its plot helpers (f0_to_figure:432-446,
energy_to_figure:449-459, spec_to_figure:406-413): f0 contour overlays
(ground truth, cwt-reconstructed, predicted), energy contours, the
pred-vs-target CWT spectrogram, mel pairs with the liu2021 phoneme-prosody
alignment appended, and the soft/hard/PRIOR attention trio.

Everything here is host-side numpy over the already-computed model outputs
(the dict CompTransTTS returns, as tensors or numpy arrays): the drawing
part of a preview; ``ctts_torch.train.preview_arrays`` is its device part.
"""

import numpy as np
import torch


# ---------------------------------------------------------------- plotting

from ctts_torch.utils.logging import pyplot


def f0_to_figure(f0_gt, f0_cwt=None, f0_pred=None):
    """Overlaid f0 contours in Hz (ref utils/tools.py:432-446)."""
    plt = pyplot()
    fig = plt.figure()
    plt.plot(np.asarray(f0_gt), color="r", label="gt")
    if f0_cwt is not None:
        plt.plot(np.asarray(f0_cwt), color="b", label="cwt")
    if f0_pred is not None:
        plt.plot(np.asarray(f0_pred), color="green", label="pred")
    plt.legend()
    return fig


def energy_to_figure(energy_gt, energy_pred=None):
    """Overlaid frame-level energy contours (ref utils/tools.py:449-459)."""
    plt = pyplot()
    fig = plt.figure()
    plt.plot(np.asarray(energy_gt), color="r", label="gt")
    if energy_pred is not None:
        plt.plot(np.asarray(energy_pred), color="green", label="pred")
    plt.legend()
    return fig


def spec_to_figure(spec, vmin=None, vmax=None):
    """[T, C] spectrogram-like panel (ref utils/tools.py:406-413)."""
    plt = pyplot()
    fig = plt.figure(figsize=(12, 6))
    plt.pcolor(np.asarray(spec).T, vmin=vmin, vmax=vmax)
    return fig


# ------------------------------------------------------- figure assembly

def host_arrays(x):
    """Tensors in nested dicts, tuples and lists → numpy (bf16 as
    float32); anything else as it is."""
    if isinstance(x, dict):
        return {k: host_arrays(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(host_arrays(v) for v in x)
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return x


def _np(x):
    return None if x is None else np.asarray(host_arrays(x))


def _denorm_f0(f0, uv, pitch_cfg):
    """``ops.pitch.denorm_f0`` on host arrays."""
    from ctts_torch.ops.pitch import denorm_f0
    return denorm_f0(torch.as_tensor(f0),
                     None if uv is None else torch.as_tensor(uv),
                     pitch_cfg).numpy()


def _expand_ph(values, mel2ph):
    """Phone-level [T_s] values → frame level via the 1-indexed mel2ph map
    (0 = padding → 0.0). Numpy twin of ops.length_regulator.gather_by_mel2ph
    for plotting only."""
    padded = np.concatenate([[0.0], np.asarray(values, np.float64)])
    return padded[np.asarray(mel2ph)]


def _expand_dur(values, durations):
    """Phone-level values repeated by integer durations (ref expand())."""
    return np.repeat(np.asarray(values), np.asarray(durations, np.int64))


def synth_sample_figures(batch, out, preprocess_config, model_config,
                         idx=0):
    """Build the full reference figure set for sample ``idx`` of a batch.

    batch: the (host or device) batch dict the model consumed; out: the
    output dict CompTransTTS returned. Returns ``(figs, fig_attn)`` where
    figs maps {"mel", "f0", "cwt", "energy"} (present when the config
    enables them) to matplotlib figures, and fig_attn is the
    soft/hard/prior alignment trio (None when durations are supervised) —
    the same contract as the reference's synth_one_sample.
    """
    from ctts_torch.ops.cwt import cwt2f0
    from ctts_torch.utils.logging import plot_alignment, plot_mel

    pitch_cfg = preprocess_config["preprocessing"]["pitch"]
    pitch_type = pitch_cfg["pitch_type"]
    use_pitch = model_config["variance_embedding"]["use_pitch_embed"]
    use_energy = model_config["variance_embedding"]["use_energy_embed"]
    learn_alignment = model_config["duration_modeling"]["learn_alignment"]
    energy_level = preprocess_config["preprocessing"]["energy"]["feature"]

    i = idx
    src_len = int(_np(out["src_lens"])[i])
    mel_len = int(_np(out["mel_lens"])[i])
    figs = {}

    # ---- mel pair (+ liu2021 phoneme-prosody alignment panel) ----
    mel_pred = _np(out["postnet_mel_predictions"])[i, :mel_len]
    mel_gt = _np(batch["mels"])[i, :mel_len]
    pp_attn = None
    if model_config["prosody_modeling"]["model_type"] == "liu2021":
        info = out.get("prosody_info")
        if info is not None and info[-1] is not None:
            pp_attn = _np(info[-1])[i, :src_len, :mel_len]
    panels = [mel_pred.T, mel_gt.T]
    titles = ["Synthetized Spectrogram", "Ground-Truth Spectrogram"]
    if pp_attn is not None:
        panels.append(pp_attn)
        titles.append("Prosody Alignment")
    figs["mel"] = plot_mel(panels, titles)

    # ---- soft / hard / prior attention trio (ref tools.py:222-235) ----
    fig_attn = None
    if learn_alignment and out.get("attn_outs") is not None \
            and out["attn_outs"][0] is not None:
        soft = _np(out["attn_outs"][0])[i, :mel_len, :src_len].T
        hard = _np(out["attn_outs"][1])[i, :mel_len, :src_len].T
        prior = None
        if batch.get("attn_priors") is not None:
            # stored [B, T_m, T_s]; displayed text x mel like the reference
            prior = _np(batch["attn_priors"])[i, :mel_len, :src_len].T
        maps = [soft, hard] + ([prior] if prior is not None else [])
        names = ["Soft Attention", "Hard Attention"] + (
            ["Prior"] if prior is not None else [])
        fig_attn = plot_alignment(maps, names)

    # ---- f0 contours (ref tools.py:242-271) ----
    preds = out.get("pitch_predictions") or {}
    # processed targets from the variance adaptor (phone-level f0 for "ph",
    # f0_cwt for "cwt") — the same dict the reference's figure code reads
    # as targets[9]; raw batch pitch_data keeps the tracked frame f0
    ptgt = out.get("pitch_targets") or {}
    pdata = batch.get("pitch_data") or {}
    if use_pitch and ("f0" in ptgt or "f0" in pdata):
        uv = _np(ptgt.get("uv", pdata.get("uv")))
        if pitch_type == "ph":
            mel2ph = _np(ptgt.get("mel2ph", pdata.get("mel2ph")))[
                i, :mel_len]
            f0_ph = _np(ptgt.get("f0", pdata.get("f0")))
            f0_gt = _expand_ph(
                _denorm_f0(f0_ph, None, pitch_cfg)[i], mel2ph)
            pp = _np(preds.get("pitch_pred"))
            f0_pr = None
            if pp is not None:
                f0_pr = _expand_ph(
                    _denorm_f0(pp[..., 0], None, pitch_cfg)[i], mel2ph)
            figs["f0"] = f0_to_figure(f0_gt, None, f0_pr)
        elif pitch_type == "cwt":
            f0_gt = _denorm_f0(_np(pdata["f0"]), uv, pitch_cfg)[i, :mel_len]
            cwt_pred = _np(preds.get("cwt"))
            f0_cwt = f0_pr = None
            if ptgt.get("f0_cwt") is not None:
                # target contour reconstructed from the target CWT
                # (ref tools.py:264-265)
                f0_cwt = _denorm_f0(_np(ptgt["f0_cwt"]), uv,
                                    pitch_cfg)[i, :mel_len]
            if cwt_pred is not None:
                # pred-vs-target CWT panel: [T, 10+10] (ref tools.py:254-257)
                cwt_tgt = _np(pdata.get("cwt_spec"))
                if cwt_tgt is not None:
                    both = np.concatenate(
                        [cwt_pred[i, :mel_len, :10],
                         cwt_tgt[i, :mel_len]], axis=-1)
                    figs["cwt"] = spec_to_figure(both)
                # predicted contour from predicted CWT + predicted stats
                f0_hz = cwt2f0(torch.as_tensor(cwt_pred[:, :, :10]),
                               torch.as_tensor(_np(preds["f0_mean"])),
                               torch.as_tensor(_np(preds["f0_std"]))).numpy()
                if pitch_cfg["use_uv"] and cwt_pred.shape[-1] > 10:
                    f0_hz = np.where(cwt_pred[:, :, -1] > 0, 0.0, f0_hz)
                f0_pr = f0_hz[i, :mel_len]
            figs["f0"] = f0_to_figure(f0_gt, f0_cwt, f0_pr)
        else:  # frame
            f0_gt = _denorm_f0(_np(pdata["f0"]), uv, pitch_cfg)[i, :mel_len]
            pp = _np(preds.get("pitch_pred"))
            f0_pr = None
            if pp is not None:
                uv_pr = (pp[..., 1] > 0).astype(np.float32) \
                    if pp.shape[-1] > 1 else None
                f0_pr = _denorm_f0(pp[..., 0], uv_pr,
                                   pitch_cfg)[i, :mel_len]
            figs["f0"] = f0_to_figure(f0_gt, None, f0_pr)

    # ---- energy contours (ref tools.py:272-282) ----
    if use_energy and batch.get("energies") is not None:
        e_tgt = _np(batch["energies"])
        e_pred = _np(out.get("energy_predictions"))
        if energy_level == "phoneme_level":
            dur = _np(out["duration_rounded"])[i, :src_len]
            e_gt = _expand_dur(e_tgt[i, :src_len], dur)
            e_pr = (_expand_dur(e_pred[i, :src_len], dur)
                    if e_pred is not None else None)
        else:
            e_gt = e_tgt[i, :mel_len]
            e_pr = e_pred[i, :mel_len] if e_pred is not None else None
        figs["energy"] = energy_to_figure(e_gt, e_pr)

    return figs, fig_attn
