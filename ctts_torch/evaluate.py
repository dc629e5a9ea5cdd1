"""Validation CLI of the port (evaluate.py:15-109).

    python -m ctts_torch.evaluate --dataset LJSpeech --restore_step N \\
        [--config_dir DIR] [--device cpu]

Restores the train state of step N from the config's ``ckpt_path``
(``ctts_torch.train`` writes it), runs the validation set (``val_unsup`` or
``val_sup``, as the config's ``learn_alignment`` says) through
``parallel.train_step.make_eval_step`` and prints the loss components'
means weighted by batch size, the numbers the train loop's validation lines
hold: the JAX CLI's message (4 decimals), then a JSON line
``{"step": N, "means": {...}}`` with every digit. Runs on ``cuda`` unless
``--device`` names another device.
"""

import argparse
import json

import numpy as np


def val_means(dataset, state, eval_step, device, keep_first=False):
    """Means of the loss components over ``dataset`` (batches in order,
    weighted by their size), and with ``keep_first`` the first batch and
    its model output."""
    from ctts_torch.parallel.train_step import batch_to_device
    sums, count, first = {}, 0, None
    for batch in dataset.batches(shuffle=False, group_size=1):
        n = len(batch["ids"])
        db = batch_to_device({k: v for k, v in batch.items()
                              if k not in ("ids", "raw_texts")}, device)
        comps, out = eval_step(state, db)
        if keep_first and first is None:
            first = (dict(db, ids=batch["ids"]), out)
        for k, v in comps.items():
            sums[k] = sums.get(k, 0.0) + float(v) * n
        count += n
    means = {k: v / count for k, v in sums.items()} if count else {}
    return means, first


def evaluate(model, state, configs, logger=None, vocoder=None, step=None):
    """Validation means of ``state`` (whose ``model`` is ``model``) over the
    config's validation set; with a logger, also one sample's figures
    (mel pair, f0 and energy contours, the attention trio) and, with a
    vocoder that is not griffin-lim, its synthesized and reconstructed
    audio (evaluate.py:71-107). Returns (message, means)."""
    from ctts_torch.data.dataset import Dataset
    from ctts_torch.models.comp_trans_tts import prepare_model_config
    from ctts_torch.parallel.train_step import make_eval_step

    if state.model is not model:
        raise ValueError("evaluate: state.model is not the given model")
    preprocess_config, model_config, train_config = configs
    model_config = prepare_model_config(preprocess_config, model_config)
    learn_alignment = model_config["duration_modeling"]["learn_alignment"]
    mode = "train_unsup" if learn_alignment else "train_sup"
    tag = "unsup" if learn_alignment else "sup"
    dataset = Dataset(f"val_{tag}.txt", preprocess_config, model_config,
                      train_config, sort=False, drop_last=False)
    eval_step = make_eval_step(preprocess_config, model_config, train_config,
                               mode)
    device = next(model.parameters()).device
    means, sample = val_means(dataset, state, eval_step, device,
                              keep_first=logger is not None)
    if logger is not None and sample is not None:
        from ctts_torch.utils.figures import synth_sample_figures
        from ctts_torch.utils.logging import pyplot
        from ctts_torch.utils.model import vocoder_infer
        plt = pyplot()
        batch, out = sample
        mel_len = int(out["mel_lens"][0])
        pred = out["postnet_mel_predictions"][0, :mel_len].float()
        gt = batch["mels"][0, :mel_len].float()
        figs, fig_attn = synth_sample_figures(
            batch, out, preprocess_config, model_config, idx=0)
        if fig_attn is not None:
            figs["attn"] = fig_attn
        for name, fig in figs.items():
            logger.figure(f"Validation/step_{step}_{batch['ids'][0]}_{name}",
                          fig, step)
            plt.close(fig)
        if vocoder is not None and vocoder[0] != "griffin_lim":
            wavs = vocoder_infer(np.stack([pred.cpu().numpy(),
                                           gt.cpu().numpy()]), vocoder,
                                 preprocess_config,
                                 lengths=[mel_len, mel_len])
            sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
            logger.audio(f"Validation/step_{step}_synth",
                         wavs[0].astype(np.float32) / 32768.0, step, sr)
            logger.audio(f"Validation/step_{step}_reconstructed",
                         wavs[1].astype(np.float32) / 32768.0, step, sr)
    message = "Validation Step {}, ".format(step) + ", ".join(
        f"{k}: {v:.4f}" for k, v in means.items())
    if logger is not None:
        logger.scalars(step, means)
    return message, means


def restore_state(configs, restore_step, device=None):
    """The train state of ``restore_step`` from the config's ``ckpt_path``
    (model, optimizer, step and dropout generator), on ``device`` (cuda
    unless the caller asks for another)."""
    from ctts_torch import resolve_device
    from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                  prepare_model_config)
    from ctts_torch.models.registry import block_hidden
    from ctts_torch.parallel.train_step import create_train_state
    from ctts_torch.utils.checkpoint import restore_checkpoint
    from ctts_torch.utils.optimizer import build_optimizer

    dev = resolve_device(device)
    preprocess_config, model_config, train_config = configs
    model_config = prepare_model_config(preprocess_config, model_config)
    model = CompTransTTS(preprocess_config, model_config,
                         train_config).to(dev)
    enc_h, _ = block_hidden(model_config)
    opt, _ = build_optimizer(model, model_config, train_config,
                             d_model=enc_h)
    state = create_train_state(model, opt, seed=train_config["seed"])
    state, _ = restore_checkpoint(train_config["path"]["ckpt_path"], state,
                                  restore_step)
    return (preprocess_config, model_config, train_config), state


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_step", type=int, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    from ctts_torch.config import get_configs_of
    configs, state = restore_state(
        get_configs_of(args.dataset, args.config_dir), args.restore_step,
        args.device)
    message, means = evaluate(state.model, state, configs,
                              step=args.restore_step)
    print(message)
    print(json.dumps({"step": args.restore_step, "means": means}))


if __name__ == "__main__":
    main()
