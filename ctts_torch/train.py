"""Training CLI of the port (train.py), on one device.

    python -m ctts_torch.train --dataset LJSpeech [--config_dir DIR] \\
        [--restore_step N] [--max_steps N] [--device cpu]

Reads the preprocessed ``.npy`` store named by the config
(``preprocess.path.preprocessed_path``), builds ``CompTransTTS`` for the
config's ``block_type`` (``transformer_fs2``, ``conformer`` or
``reformer``) with seeded weights, and takes ``train_unsup`` steps
(``parallel.train_step``) until ``--max_steps`` or
``train.step.total_step``. As in the JAX loop:

* when the store fits ``train.device_cache_mb`` (and the prior is computed
  on the device), it goes to the device once and each step ships a [B]
  index vector (``data.device_cache``); otherwise batches stream from a
  prefetch thread, cast to float16 there when ``transfer_dtype`` says so;
* the step counter lives on the host, and nothing waits for the device
  except at ``log_step`` (the loss line), ``val_step`` (the validation
  means) and ``save_step`` (a checkpoint, ``utils.checkpoint``);
* ``--restore_step N`` resumes model, optimizer, step and dropout
  generator from the checkpoint of step N, at the batch where step N left
  the epoch, so a resumed run takes the uninterrupted run's steps.

Logs go to ``train.path.log_path`` (``train/`` and ``val/``, JSON lines and
text; each train line also counts the kernel launches per step). The synth
previews and multi-host arguments of the JAX CLI are not part of the port.
"""

import argparse
import time

import numpy as np
import torch

from ctts_torch import resolve_device


def _device_batch(batch):
    return {k: v for k, v in batch.items() if k not in ("ids", "raw_texts")}


def _compress_f16(batch):
    """The float16 transfer cast (``train.transfer_dtype: float16``); the
    step upcasts on the device (``prep_batch``)."""
    out = dict(batch)
    for k, v in out.items():
        if k == "pitch_data" and isinstance(v, dict):
            out[k] = {pk: (pv.astype(np.float16)
                           if getattr(pv, "dtype", None) == np.float32
                           else pv) for pk, pv in v.items()}
        elif getattr(v, "dtype", None) == np.float32:
            out[k] = v.astype(np.float16)
    return out


def _validate(val_set, state, eval_step, device, logger, step):
    """Means of the loss components over the validation set, weighted by
    batch size."""
    from ctts_torch.parallel.train_step import batch_to_device
    sums, count = {}, 0
    for batch in val_set.batches(shuffle=False, group_size=1):
        n = len(batch["ids"])
        comps, _ = eval_step(state, batch_to_device(_device_batch(batch),
                                                    device))
        for k, v in comps.items():
            sums[k] = sums.get(k, 0.0) + float(v) * n
        count += n
    if count:
        means = {k: v / count for k, v in sums.items()}
        logger.scalars(step, means)
        print(f"  val @ {step}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in list(means.items())[:4]), flush=True)


def train(configs, restore_step=0, max_steps=None, device=None):
    """Run the loop; returns the train state after the last step."""
    from ctts_torch.data.dataset import Dataset, prefetch_iter
    from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                  prepare_model_config)
    from ctts_torch.models.registry import block_hidden
    from ctts_torch.ops.kernels import launch_counts
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_eval_step,
                                                make_train_step)
    from ctts_torch.utils.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from ctts_torch.utils.logging import Logger
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.optimizer import build_optimizer

    dev = resolve_device(device)
    preprocess_config, model_config, train_config = configs
    model_config = prepare_model_config(preprocess_config, model_config)
    learn_alignment = model_config["duration_modeling"]["learn_alignment"]
    mode = "train_unsup" if learn_alignment else "train_sup"
    tag = "unsup" if learn_alignment else "sup"
    train_step = make_train_step(preprocess_config, model_config,
                                 train_config, mode)
    eval_step = make_eval_step(preprocess_config, model_config, train_config,
                               mode)

    train_set = Dataset(f"train_{tag}.txt", preprocess_config, model_config,
                        train_config, sort=True, drop_last=True)
    val_set = Dataset(f"val_{tag}.txt", preprocess_config, model_config,
                      train_config, sort=False, drop_last=False)
    seed = train_config["seed"]
    model = init_weights(CompTransTTS(preprocess_config, model_config,
                                      train_config), seed).to(dev)
    enc_h, _ = block_hidden(model_config)
    opt, schedule = build_optimizer(model, model_config, train_config,
                                    d_model=enc_h)
    state = create_train_state(model, opt, step=0, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"CompTransTTS: {n_params / 1e6:.2f}M params | device {dev} | "
          f"block={model_config['block_type']} mode={mode} "
          f"compute_dtype={model_config.get('compute_dtype', 'float32')}",
          flush=True)
    ckpt_dir = train_config["path"]["ckpt_path"]
    if restore_step:
        state, restored = restore_checkpoint(ckpt_dir, state, restore_step)
        print(f"restored checkpoint at step {restored}", flush=True)

    cache = None
    budget = int(train_config.get("device_cache_mb", 0) or 0)
    transfer_dtype = train_config.get("transfer_dtype", "float32")
    if budget > 0 and (not learn_alignment
                       or train_config.get("on_device_prior", False)):
        from ctts_torch.data.device_cache import DeviceCache, gather_batch
        dc = DeviceCache(train_set, transfer_dtype)
        if dc.nbytes <= budget * 2 ** 20:
            dc.put(dev)
            cache = dc
            energy_on_src = train_set.energy_level_tag == "phone"
            print(f"device cache: {len(train_set)} utterances, "
                  f"{dc.nbytes / 2 ** 20:.1f} MiB resident on {dev}",
                  flush=True)
        else:
            print(f"device cache skipped: store {dc.nbytes / 2 ** 20:.0f} "
                  f"MiB > budget {budget} MiB; streaming loader", flush=True)
    compress = _compress_f16 if transfer_dtype == "float16" else (lambda b: b)

    def stage(batch):                      # runs on the prefetch thread
        return batch_to_device(_device_batch(compress(batch)), dev)

    log_path = train_config["path"]["log_path"]
    train_logger = Logger(log_path, "train")
    val_logger = Logger(log_path, "val")
    total_step = max_steps or train_config["step"]["total_step"]
    log_step = train_config["step"]["log_step"]
    val_step = train_config["step"]["val_step"]
    save_step = train_config["step"]["save_step"]
    per_epoch = train_set.n_batches()
    if per_epoch == 0:
        raise ValueError(f"the train set ({len(train_set)} utterances) holds "
                         f"no full batch of {train_set.batch_size}")

    step = state.step                      # host-side counter
    epoch, start = divmod(step, per_epoch)
    t_last = time.perf_counter()
    launches_last = launch_counts()
    try:
        while step < total_step:
            if cache is not None:
                batch_iter = cache.index_batches(epoch=epoch, seed=seed,
                                                 start=start)
            else:
                batch_iter = prefetch_iter(map(stage, train_set.batches(
                    epoch=epoch, seed=seed, start=start)))
            for batch in batch_iter:
                if cache is not None:
                    idx, T_s, T_m = batch
                    batch = gather_batch(cache.arrays,
                                         torch.from_numpy(idx).to(dev), T_s,
                                         T_m, energy_on_src)
                metrics = train_step(state, batch)
                step += 1
                if step % log_step == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    lr = schedule(step)
                    dt = (time.perf_counter() - t_last) / log_step
                    t_last = time.perf_counter()
                    now = launch_counts()
                    per_step = {k: (now[k] - launches_last[k]) / log_step
                                for k in now if now[k] != launches_last[k]}
                    launches_last = now
                    train_logger.scalars(step, metrics, lr=lr,
                                         s_per_step=dt,
                                         launches_per_step=per_step)
                    print(f"step {step}: total={metrics['total']:.4f} "
                          f"mel={metrics['mel']:.4f} lr={lr:.2e} "
                          f"{dt * 1000:.0f}ms/step launches/step {per_step}",
                          flush=True)
                if step % val_step == 0:
                    _validate(val_set, state, eval_step, dev, val_logger,
                              step)
                if step % save_step == 0:
                    save_checkpoint(ckpt_dir, state, step)
                    print(f"saved checkpoint @ {step}", flush=True)
                if step >= total_step:
                    break
            epoch, start = epoch + 1, 0
        if step % save_step:
            save_checkpoint(ckpt_dir, state, step)
            print(f"saved checkpoint @ {step}", flush=True)
    finally:
        train_logger.close()
        val_logger.close()
    return state


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True,
                        help="name of dataset (configs/<dataset>.yaml)")
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override total_step (smoke runs)")
    parser.add_argument("--config_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    from ctts_torch.config import get_configs_of
    configs = get_configs_of(args.dataset, args.config_dir)
    train(configs, args.restore_step, args.max_steps, args.device)


if __name__ == "__main__":
    main()
