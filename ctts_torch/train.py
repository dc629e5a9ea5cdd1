"""Training CLI of the port (train.py), on one device.

    python -m ctts_torch.train --dataset LJSpeech [--config_dir DIR] \\
        [--restore_step N] [--max_steps N] [--device cpu] \\
        [--vocoder_ckpt DIR] [--profile_steps START:END] \\
        [--coordinator HOST:PORT --num_processes N --process_id I]

Reads the preprocessed ``.npy`` store named by the config
(``preprocess.path.preprocessed_path``; ``python -m ctts_torch.preprocess``
writes it), builds ``CompTransTTS`` for the config's ``block_type`` (any of
``transformer_fs2``, ``transformer``, ``fastformer``, ``lstransformer``,
``conformer`` and ``reformer``) with seeded weights, and takes
``train_unsup`` steps (with ``learn_alignment``: the ``unsup`` store, MAS
durations) or ``train_sup`` steps (without: the ``sup`` store's durations
and ``mel2ph``) (``parallel.train_step``) until ``--max_steps`` or
``train.step.total_step``. As in the JAX loop:

* when the store fits ``train.device_cache_mb`` (and the prior is computed
  on the device), it goes to the device once and each step ships a [B]
  index vector (``data.device_cache``); otherwise batches stream from a
  prefetch thread, cast to float16 there when ``transfer_dtype`` says so;
* the step counter lives on the host, and nothing waits for the device
  except at ``log_step`` (the loss line), ``synth_step`` (a preview),
  ``val_step`` (the validation means) and ``save_step`` (a checkpoint,
  ``utils.checkpoint``);
* every ``synth_step`` a synth preview of the step's first utterance
  (train.py:306-342): its device part (:func:`preview_arrays`: the eval
  forward and the vocoder of ``--vocoder_ckpt``) and its drawing part
  (:func:`draw_preview`: ``utils.figures`` to the logger's TensorBoard). A
  preview never stops training; ``train/preview.jsonl`` records whether each
  ran or why it was skipped;
* ``--profile_steps START:END`` traces steps START to END with
  ``torch.profiler`` into ``log_path/profile``;
* ``--restore_step N`` resumes model, optimizer, step and dropout
  generator from the checkpoint of step N, at the batch where step N left
  the epoch, so a resumed run takes the uninterrupted run's steps.

Logs go to ``train.path.log_path`` (``train/`` and ``val/``, JSON lines and
text; each train line also counts the kernel launches per step).

Several processes, one per card: start N of them with ``--coordinator
host:port`` (process 0's address), ``--num_processes N`` and
``--process_id i`` (or ``CTTS_COORDINATOR``, ``CTTS_NUM_PROCESSES`` and
``CTTS_PROCESS_ID``). They join one process group (NCCL on cards, gloo with
``--device cpu``; a failed init fails the run) and lay out the
``train.mesh`` grid, ``data × model`` = N (``parallel.mesh``). Process i
takes ``cuda:(i % device_count)`` unless ``--device`` names one. Each data
rank reads its shard of the store (``shard=data_rank``; model-group peers
read the same batches) and takes ``optimizer.batch_size`` utterances a
step, so the global batch is ``batch_size × data``, as under the JAX
package's multi-host runs and upstream DDP. The device cache stays on:
every rank holds the store and draws its shard's indices, padded to the
longest of the step's shards. The streaming loader pads each rank's batch
to the step's largest bucket, taken with one all-reduce of two integers
on the prefetch thread. The step is the single-device step on the
global batch (``parallel.train_step``). Logs, previews, the profile and the
checkpoint files come from rank 0; a checkpoint holds whole tensors,
gathered from every rank, and restores under any grid. Validation runs the
whole validation set on every rank: its means are one process's.
"""

import argparse
import functools
import itertools
import os
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


class _NoLogger:
    """The logger of a rank other than 0: it writes nothing."""
    tb = None

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _validate(val_set, state, eval_step, device, logger, step, rank0=True):
    """Means of the loss components over the validation set, weighted by
    batch size."""
    from ctts_torch.evaluate import val_means
    means, _ = val_means(val_set, state, eval_step, device)
    if means and rank0:
        logger.scalars(step, means)
        print(f"  val @ {step}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in list(means.items())[:4]), flush=True)


def preview_arrays(eval_step, state, batch, vocoder, preprocess_config, mode,
                   idx=0):
    """The device part of a synth preview: the eval forward on the device
    ``batch`` (the prior computed on the device where the loader shipped
    none, so the attention trio keeps its prior panel) and the vocoder on
    sample ``idx``'s predicted mel. Returns (batch, model output) as host
    arrays and the wav, float32 [mel_len·hop] in [-1, 1], or None where the
    vocoder is griffin-lim."""
    from ctts_torch.parallel.train_step import prep_batch
    from ctts_torch.utils.figures import host_arrays
    from ctts_torch.utils.model import vocoder_infer
    batch = prep_batch(batch, preprocess_config, mode)
    _, out = eval_step(state, batch)
    mel_len = int(out["mel_lens"][idx])
    wav = None
    if vocoder[0] != "griffin_lim":
        mel = out["postnet_mel_predictions"][idx:idx + 1, :mel_len].float()
        wav = vocoder_infer(mel, vocoder, preprocess_config,
                            lengths=[mel_len])[0].astype(np.float32) / 32768.0
    return host_arrays(batch), host_arrays(out), wav


def draw_preview(batch, out, preprocess_config, model_config, logger, step,
                 base):
    """The drawing part of a synth preview: the reference's figure set of
    sample 0 (``utils.figures.synth_sample_figures``) to the logger.
    Returns the figures' names. Needs matplotlib."""
    from ctts_torch.utils.figures import synth_sample_figures
    from ctts_torch.utils.logging import pyplot
    plt = pyplot()
    figs, fig_attn = synth_sample_figures(batch, out, preprocess_config,
                                          model_config, idx=0)
    for name, fig in figs.items():
        logger.figure(f"Training/step_{step}_{base}_{name}", fig, step)
        plt.close(fig)
    if fig_attn is not None:
        logger.figure(f"Training/attn_{step}", fig_attn, step)
        plt.close(fig_attn)
        figs["attn"] = fig_attn
    return sorted(figs)


def _synth_preview(eval_step, state, batch, base, vocoder, configs, mode,
                   logger, step):
    """One preview (train.py:306-342); it never raises, and records in the
    train log whether it ran or why it was skipped."""
    preprocess_config, model_config, _ = configs
    try:
        host_batch, out, wav = preview_arrays(eval_step, state, batch,
                                              vocoder, preprocess_config,
                                              mode)
        rec = {"preview": "ran", "id": base,
               "mel_len": int(out["mel_lens"][0]),
               "wav_samples": None if wav is None else len(wav),
               "wav_finite": None if wav is None
               else bool(np.isfinite(wav).all()),
               "tensorboard": logger.tb is not None}
        if wav is not None:
            logger.audio(f"Training/step_{step}_synthesized", wav, step,
                         preprocess_config["preprocessing"]["audio"][
                             "sampling_rate"])
        try:
            rec["figures"] = draw_preview(host_batch, out, preprocess_config,
                                          model_config, logger, step, base)
        except ImportError as e:           # matplotlib is not installed
            rec.update(figures=None, figures_skipped=str(e))
    except Exception as e:                 # previews must never kill training
        rec = {"preview": "skipped", "reason": f"{type(e).__name__}: {e}"}
    logger.preview(step, **rec)
    print(f"  preview @ {step}: {rec}", flush=True)


def _rank_device(device, coordinator, process_id):
    """``device``, else ``cuda:(process_id % device_count)`` in a
    multi-process run and ``cuda`` in one process."""
    if device is not None:
        return device
    coordinator = coordinator or os.environ.get("CTTS_COORDINATOR")
    if process_id is None:
        process_id = os.environ.get("CTTS_PROCESS_ID")
    if coordinator and process_id is not None and torch.cuda.is_available():
        return f"cuda:{int(process_id) % torch.cuda.device_count()}"
    return "cuda"


def _shard_steps(make, n_shards, start):
    """Every data shard's index batches of an epoch side by side, from the
    epoch's batch ``start`` on; stops with the shortest shard, so every
    rank takes the same number of steps."""
    return zip(*[make(s, start) for s in range(n_shards)])


def train(configs, restore_step=0, max_steps=None, device=None,
          vocoder_ckpt="ckpt", profile_steps=None, coordinator=None,
          num_processes=None, process_id=None):
    """Run the loop; returns the train state after the last step.
    ``vocoder_ckpt``: the directory of the previews' vocoder weights
    (``utils.model.get_vocoder``; griffin-lim, so no audio, without them);
    ``profile_steps``: (START, END) to trace; ``coordinator``,
    ``num_processes``, ``process_id``: a multi-process run (module
    docstring)."""
    from ctts_torch.parallel.mesh import init_distributed
    dev = resolve_device(_rank_device(device, coordinator, process_id))
    joined = init_distributed(coordinator, num_processes, process_id,
                              device=dev)
    if joined and torch.distributed.get_rank() == 0:
        print(f"process group {torch.distributed.get_backend()}, world "
              f"{torch.distributed.get_world_size()}", flush=True)
    try:
        return _train(configs, restore_step, max_steps, dev, vocoder_ckpt,
                      profile_steps)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(configs, restore_step, max_steps, dev, vocoder_ckpt,
           profile_steps):
    from ctts_torch.data.dataset import Dataset, prefetch_iter
    from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                  prepare_model_config)
    from ctts_torch.models.registry import block_hidden
    from ctts_torch.ops.kernels import launch_counts
    from ctts_torch.parallel.mesh import (check_tp_coverage,
                                          host_data_group, make_mesh,
                                          shard_model_, step_lengths)
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_eval_step,
                                                make_train_step)
    from ctts_torch.utils.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from ctts_torch.utils.logging import Logger
    from ctts_torch.utils.model import get_vocoder, init_weights
    from ctts_torch.utils.optimizer import build_optimizer

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
    mesh_cfg = train_config.get("mesh") or {}
    grid = make_mesh(mesh_cfg.get("data", -1), mesh_cfg.get("model", 1))
    rank0 = grid.rank == 0
    say = print if rank0 else (lambda *args, **kwargs: None)
    model = init_weights(CompTransTTS(preprocess_config, model_config,
                                      train_config), seed).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    check_tp_coverage(model, grid.model, model_config["block_type"])
    if grid.data * grid.model == 1:
        grid = None
    else:
        shard_model_(model, grid)
    enc_h, _ = block_hidden(model_config)
    opt, schedule = build_optimizer(model, model_config, train_config,
                                    d_model=enc_h, grid=grid)
    state = create_train_state(model, opt, step=0, seed=seed, grid=grid)
    n_data = 1 if grid is None else grid.data
    data_rank = 0 if grid is None else grid.data_rank
    say(f"CompTransTTS: {n_params / 1e6:.2f}M params | device {dev} | "
        f"block={model_config['block_type']} mode={mode} "
        f"compute_dtype={model_config.get('compute_dtype', 'float32')}"
        + ("" if grid is None else
           f" | grid data {grid.data} × model {grid.model}, global batch "
           f"{train_set.batch_size * grid.data}"), flush=True)
    ckpt_dir = train_config["path"]["ckpt_path"]
    if restore_step:
        state, restored = restore_checkpoint(ckpt_dir, state, restore_step)
        say(f"restored checkpoint at step {restored}", flush=True)

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
            say(f"device cache: {len(train_set)} utterances, "
                  f"{dc.nbytes / 2 ** 20:.1f} MiB resident on {dev}",
                  flush=True)
        else:
            say(f"device cache skipped: store {dc.nbytes / 2 ** 20:.0f} "
                  f"MiB > budget {budget} MiB; streaming loader", flush=True)
    compress = _compress_f16 if transfer_dtype == "float16" else (lambda b: b)
    if cache is None:
        say(f"streaming loader: .npy files read by "
            + ("the native prefetcher (native/npy_loader.cc)"
               if train_set._native is not None else "numpy (no native "
               "prefetcher)"), flush=True)
    pad_to = None
    if cache is None and n_data > 1:
        # every data rank pads its streamed batch to the step's largest
        # lengths, as the cache pads to the longest of the step's shards:
        # one all-reduce of two integers on the prefetch thread, over a
        # gloo group of its own
        loader_group = host_data_group(grid)
        pad_to = functools.partial(step_lengths, group=loader_group)

    def stage(batch):                      # runs on the prefetch thread
        return batch["ids"], batch_to_device(_device_batch(compress(batch)),
                                             dev)

    log_path = train_config["path"]["log_path"]
    train_logger = Logger(log_path, "train") if rank0 else _NoLogger()
    val_logger = Logger(log_path, "val") if rank0 else _NoLogger()
    total_step = max_steps or train_config["step"]["total_step"]
    log_step = train_config["step"]["log_step"]
    val_step = train_config["step"]["val_step"]
    synth_step = train_config["step"]["synth_step"]
    save_step = train_config["step"]["save_step"]
    vocoder = get_vocoder(model_config, vocoder_ckpt, device=dev) \
        if rank0 else None
    prof = None
    per_epoch = min(train_set.n_batches(num_shards=n_data, shard=s)
                    for s in range(n_data))
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
                # every shard's batch of the step: each rank pads its own
                # to the longest of them
                batch_iter = _shard_steps(
                    lambda s, b0: cache.index_batches(
                        epoch=epoch, seed=seed, start=b0, num_shards=n_data,
                        shard=s), n_data, start)
            else:
                # no read-ahead past the run's last step: the prefetch
                # thread's last collective is made before that step
                batch_iter = prefetch_iter(map(stage, itertools.islice(
                    train_set.batches(epoch=epoch, seed=seed, start=start,
                                      num_shards=n_data, shard=data_rank,
                                      pad_to=pad_to),
                    min(per_epoch - start, total_step - step))))
            for batch in batch_iter:
                if cache is not None:
                    idx = batch[data_rank][0]
                    T_s = max(b[1] for b in batch)
                    T_m = max(b[2] for b in batch)
                    batch = gather_batch(cache.arrays,
                                         torch.from_numpy(idx).to(dev), T_s,
                                         T_m, energy_on_src)
                else:
                    ids, batch = batch
                if rank0 and profile_steps and step + 1 == profile_steps[0]:
                    prof = _start_profile(dev)
                metrics = train_step(state, batch)
                step += 1
                if prof is not None and step == profile_steps[1]:
                    _save_profile(prof, dev, log_path, profile_steps)
                    prof = None
                if step % log_step == 0 and rank0:
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
                # previews, validation and saving stay out of the next loss
                # line's time and launches per step
                t_aside, before = time.perf_counter(), launch_counts()
                if step % synth_step == 0 and data_rank == 0:
                    if cache is not None:
                        # the index batch through the host collate
                        # (train.py:230-236)
                        raw = train_set.collate([train_set[int(i)]
                                                 for i in idx])
                        ids = raw["ids"]
                        batch = batch_to_device(_device_batch(raw), dev)
                    if rank0:
                        _synth_preview(eval_step, state, batch, ids[0],
                                       vocoder, (preprocess_config,
                                                 model_config, train_config),
                                       mode, train_logger, step)
                    else:                  # the forward's model-group peer
                        eval_step(state, batch)
                if step % val_step == 0:
                    _validate(val_set, state, eval_step, dev, val_logger,
                              step, rank0)
                if step % save_step == 0:
                    save_checkpoint(ckpt_dir, state, step)
                    say(f"saved checkpoint @ {step}", flush=True)
                t_last += time.perf_counter() - t_aside
                after = launch_counts()
                launches_last = {k: launches_last[k] + after[k] - before[k]
                                 for k in after}
                if step >= total_step:
                    break
            epoch, start = epoch + 1, 0
        if prof is not None:               # the run ended inside the range
            _save_profile(prof, dev, log_path, (profile_steps[0], step))
        if step % save_step:
            save_checkpoint(ckpt_dir, state, step)
            say(f"saved checkpoint @ {step}", flush=True)
        if cache is None:
            say(f"streaming loader read {train_set.native_reads} train "
                f"files through the native prefetcher and "
                f"{train_set.numpy_reads} through numpy", flush=True)
    finally:
        train_logger.close()
        val_logger.close()
    return state


def _start_profile(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _save_profile(prof, dev, log_path, steps):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.stop()
    out = os.path.join(log_path, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"steps_{steps[0]}_{steps[1]}.json")
    prof.export_chrome_trace(path)
    print(f"profile of steps {steps[0]}-{steps[1]}: {path}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True,
                        help="name of dataset (configs/<dataset>.yaml)")
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override total_step (smoke runs)")
    parser.add_argument("--config_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default; cuda:(process_id %% "
                             "device_count) in a multi-process run) or cpu")
    parser.add_argument("--vocoder_ckpt", type=str, default="ckpt",
                        help="directory of the previews' vocoder weights")
    parser.add_argument("--profile_steps", type=str, default=None,
                        help="START:END steps to trace with torch.profiler "
                             "into log_path/profile")
    # one process per card (the JAX CLI's multi-host flags); also
    # CTTS_COORDINATOR, CTTS_NUM_PROCESSES and CTTS_PROCESS_ID
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0 for a multi-process run")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)
    from ctts_torch.config import get_configs_of
    configs = get_configs_of(args.dataset, args.config_dir)
    profile_steps = (tuple(int(x) for x in args.profile_steps.split(":"))
                     if args.profile_steps else None)
    train(configs, args.restore_step, args.max_steps, args.device,
          args.vocoder_ckpt, profile_steps, args.coordinator,
          args.num_processes, args.process_id)


if __name__ == "__main__":
    main()
