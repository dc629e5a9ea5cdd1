"""The train and eval steps (ctts_tpu/parallel/train_step.py) on one device.

``make_train_step`` returns ``step(state, batch) -> metrics``: forward in
``mode``, loss, backward, global-norm clip and one Adam update with the Noam
rate. The schedule step is a host int in the train state, so the schedule
gates are plain ``if``s. The model and the loss see ``state.step + 1``, as in
the JAX step.
"""

import dataclasses

import numpy as np
import torch

from ctts_torch.models.blocks import set_dropout_generator
from ctts_torch.models.loss import compute_loss
from ctts_torch.ops.attn_prior import beta_binomial_prior


def batch_to_device(batch, device):
    """A batch of numpy arrays (nested one level, ``None`` kept) → tensors
    on ``device``."""
    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        if v is None or torch.is_tensor(v):
            return v if v is None else v.to(device)
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: move(v) for k, v in batch.items()}


def prep_batch(batch, preprocess_config, mode):
    """The tail of the input pipeline, on the device: float16 transfer
    arrays are upcast to float32, and the beta-binomial prior is computed
    from (mel_lens, src_lens) when the loader shipped none."""
    def upcast(v):
        return v.float() if torch.is_tensor(v) and v.dtype == torch.float16 \
            else v
    batch = {k: ({pk: upcast(pv) for pk, pv in v.items()}
                 if isinstance(v, dict) else upcast(v))
             for k, v in batch.items()}
    if mode == "train_unsup" and batch.get("attn_priors") is None:
        scaling = (preprocess_config["preprocessing"].get("duration", {})
                   .get("beta_binomial_scaling_factor", 1.0))
        batch["attn_priors"] = beta_binomial_prior(
            batch["mel_lens"], batch["src_lens"], batch["mels"].shape[1],
            batch["texts"].shape[1], scaling=scaling)
    return batch


@dataclasses.dataclass
class TrainState:
    """step: schedule steps taken so far (host int); generator: the source
    of the dropout masks, on the model's device."""
    step: int
    model: torch.nn.Module
    optimizer: object
    generator: torch.Generator


def create_train_state(model, optimizer, step=0, seed=1234):
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(model, generator)
    return TrainState(step=step, model=model, optimizer=optimizer,
                      generator=generator)


def _apply(model, batch, mode, step):
    return model(batch["speakers"], batch["texts"], batch["src_lens"], mode,
                 mels=batch["mels"], mel_lens=batch["mel_lens"],
                 pitch_targets=batch["pitch_data"],
                 energy_targets=batch["energies"],
                 duration_targets=batch.get("durations"),
                 attn_priors=batch.get("attn_priors"),
                 spker_embeds=batch.get("spker_embeds"), step=step)


def _check_mode(mode):
    if mode not in ("train_unsup", "train_sup"):
        raise ValueError(f"unknown training mode {mode!r}")


def make_train_step(preprocess_config, model_config, train_config, mode,
                    deterministic=False):
    """Returns ``step(state, batch) -> metrics``; it advances ``state`` in
    place. metrics holds the components of ``compute_loss`` plus
    ``grad_norm`` (the norm before the clip), as 0-d tensors on the device.
    ``deterministic=True`` runs the forward in eval mode (no dropout,
    running BatchNorm statistics), which is how the step is compared with
    the JAX one. ``mode`` is "train_unsup" (MAS durations) or "train_sup"
    (the batch's durations)."""
    _check_mode(mode)

    def train_step(state, batch):
        model = state.model
        model.train(not deterministic)
        batch = prep_batch(batch, preprocess_config, mode)
        step = state.step + 1
        out = _apply(model, batch, mode, step)
        total, comps = compute_loss(batch, out, step, preprocess_config,
                                    model_config, train_config)
        params = state.optimizer.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        comps = {k: v.detach() for k, v in comps.items()}
        comps["grad_norm"] = state.optimizer.update(grads)
        state.step = step
        return comps

    return train_step


def make_eval_step(preprocess_config, model_config, train_config, mode):
    """Returns ``eval_step(state, batch) -> (components, model output)``."""
    _check_mode(mode)

    def eval_step(state, batch):
        state.model.eval()
        batch = prep_batch(batch, preprocess_config, mode)
        with torch.no_grad():
            out = _apply(state.model, batch, mode, state.step)
            _, comps = compute_loss(batch, out, state.step, preprocess_config,
                                    model_config, train_config,
                                    training=False)
        return comps, out

    return eval_step
