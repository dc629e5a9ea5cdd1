"""Checkpoints of the port, and the packed bf16 weights npz of the JAX
package (ctts_tpu/utils/checkpoint.py:132-153), read with numpy alone: no
ml_dtypes, no orbax.

A checkpoint is keyed by step, as the JAX package's (``<ckpt_path>/<step>``
there, ``<ckpt_path>/<step>.pth.tar`` here, the upstream name). Its format
is the port's own, one ``torch.save`` file: the model's state_dict (the
BatchNorm running statistics included), the optimizer's moments, counts and
gradient accumulator, the schedule step and the dropout generator's state.
It is read with ``weights_only=True``.
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


def save_checkpoint(ckpt_dir, state, step):
    """Write ``state`` (a ``parallel.train_step.TrainState``) at ``step``;
    the file appears whole or not at all."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step),
               "generator": state.generator.get_state()}
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
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"])
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
