"""Checkpoints of the port, and the packed bf16 weights npz of the JAX
package (ctts_tpu/utils/checkpoint.py:132-153), read with numpy alone: no
ml_dtypes, no orbax.

A checkpoint is keyed by step, as the JAX package's (``<ckpt_path>/<step>``
there, ``<ckpt_path>/<step>.pth.tar`` here, the upstream name). Its format
is the port's own, one ``torch.save`` file: the model's state_dict (the
BatchNorm running statistics included), the optimizer's moments, counts and
gradient accumulator, the schedule step and the dropout generator's state.
It is read with ``weights_only=True``.

A checkpoint holds whole tensors whatever the process grid that wrote it
(the JAX CLI's gathered save, train.py:255-262): on a grid every rank
calls :func:`save_checkpoint`, the tensor-parallel slices of the
parameters, of the optimizer's moments and of its accumulator (the data
group's mean micro-gradient, which every data rank holds) are gathered
over the model group, and rank 0 alone writes. :func:`restore_checkpoint` cuts each rank's slices from the whole
tensors, so a checkpoint of any grid restores under any other, or in one
process. Every data rank's dropout stream is saved (gathered over the data
group; model-group peers share theirs), so a run resumed on the same data
axis draws the masks the straight run draws; under another data axis,
data rank d > 0 starts a stream of its own from data rank 0's. The shared
stream (the reformer's rotations) is saved beside them where it differs.
"""

import json
import os
import re

import numpy as np
import torch

_CKPT_RE = re.compile(r"^(\d+)\.pth\.tar$")


def checkpoint_path(ckpt_dir, step):
    return os.path.join(ckpt_dir, f"{int(step)}.pth.tar")


def latest_step(ckpt_dir):
    """The largest step with a checkpoint under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_CKPT_RE.match,
                                          os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def _param_names(state):
    """The state_dict name of each of the optimizer's parameters."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


def _per_param(state, optimizer, fn):
    """``optimizer`` (a state_dict) with ``fn`` applied to each of its
    per-parameter lists as a state_dict by parameter name."""
    names = _param_names(state)
    out = dict(optimizer)
    for k in ("mu", "nu", "acc"):
        if out[k] is not None:
            out[k] = list(fn(dict(zip(names, out[k]))).values())
    return out


def _whole_optimizer(state):
    """The optimizer's state with whole tensors (every rank takes part).
    Every data rank holds the whole accumulator (the optimizer accumulates
    reduced micro-gradients), so it is gathered on the model group only."""
    from ctts_torch.parallel.mesh import gather_params
    opt = dict(state.optimizer.state_dict())
    grid = state.grid
    if grid is None:
        return opt
    return _per_param(state, opt, lambda sd: gather_params(
        sd, state.model.tp_specs, grid))


def _data_generators(state):
    """Each data rank's dropout stream state in data-rank order (every rank
    takes part), None without a data group."""
    grid = state.grid
    if grid is None or grid.data_group is None:
        return None
    import torch.distributed as dist
    mine = state.generator.get_state()
    if dist.get_backend(grid.data_group) == "nccl":
        mine = mine.to(state.generator.device)
    parts = [torch.empty_like(mine) for _ in range(grid.data)]
    dist.all_gather(parts, mine, group=grid.data_group)
    return [p.cpu() for p in parts]


def save_checkpoint(ckpt_dir, state, step):
    """Write ``state`` (a ``parallel.train_step.TrainState``) at ``step``;
    the file appears whole or not at all. On a grid every rank calls it
    and rank 0 writes; the others return None."""
    from ctts_torch.parallel.mesh import gather_params
    model_sd = state.model.state_dict()
    if state.grid is not None:
        model_sd = gather_params(model_sd, state.model.tp_specs, state.grid)
    optimizer = _whole_optimizer(state)
    generators = _data_generators(state)
    if state.grid is not None and state.grid.rank != 0:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    payload = {"model": model_sd,
               "optimizer": optimizer,
               "step": int(state.step),
               "generator": state.generator.get_state()}
    if generators is not None:
        payload["generators"] = generators
    shared = state.shared_generator
    if shared is not None and shared is not state.generator:
        payload["shared_generator"] = shared.get_state()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_dir, step):
    """The saved dict at ``step`` (tensors on the CPU). Raises
    FileNotFoundError when there is none."""
    path = checkpoint_path(ckpt_dir, step)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint for step {step}: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir, state, step=None):
    """Restore model, optimizer, step and generator into ``state`` in place;
    ``step=None`` takes the latest. Returns (state, restored step), with
    step 0 when the directory holds no checkpoint."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return state, 0
    saved = load_checkpoint(ckpt_dir, step)
    model_sd, optimizer = saved["model"], dict(saved["optimizer"])
    grid = state.grid
    if grid is not None:
        from ctts_torch.parallel.mesh import shard_params
        model_sd = shard_params(model_sd, state.model.tp_specs, grid)
        optimizer = _per_param(state, optimizer, lambda sd: shard_params(
            sd, state.model.tp_specs, grid))
    state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(optimizer)
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"])
    shared = state.shared_generator
    if shared is not None and shared is not state.generator:
        shared.set_state(
            saved.get("shared_generator", saved["generator"]))
    gens = saved.get("generators")
    if grid is not None and gens is not None and len(gens) == grid.data:
        state.generator.set_state(gens[grid.data_rank])
    elif grid is not None and grid.data_rank > 0:
        fork = torch.Generator(state.generator.device).set_state(
            saved["generator"])
        base = int(torch.randint(0, 2 ** 62, (1,), generator=fork,
                                 device=fork.device))
        state.generator.manual_seed(base + grid.data_rank)
    return state, step


def bf16_bits_to_f32(bits):
    """uint16 bfloat16 bit patterns → float32 (exact widening)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def load_params_npz(path):
    """Packed npz → (nested-dict tree of numpy arrays, step).

    bfloat16-packed leaves come back as float32 holding the bf16 values;
    integer and bool leaves come back bit-exact."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        tree = {}
        for key, spec in manifest["leaves"].items():
            arr = z[spec["n"]]
            if spec["dtype"] == "bfloat16":
                arr = bf16_bits_to_f32(arr)
            node, parts = tree, key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree, manifest["step"]
