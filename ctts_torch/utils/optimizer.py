"""Adam with the Noam warm-up schedule, anneal milestones and a global-norm
gradient clip (ctts_tpu/utils/optimizer.py), with optax's arithmetic:

* the clip leaves gradients alone below the threshold and scales them by
  ``clip / norm`` above it (``clip_grad_norm_`` would use
  ``clip / (norm + 1e-6)``);
* the schedule is read at the optimizer's own update count, which is 0 at
  the first update and clamped to 1, so updates 1 and 2 share a rate;
* ``eps`` sits outside the root: ``m_hat / (sqrt(v_hat) + eps)``.

lr = H^-0.5 · min(count^-0.5, count · warmup^-1.5) · anneal_rate^(number of
milestones passed).
"""

import torch


def noam_schedule(init_scale, warmup_steps, anneal_steps, anneal_rate):
    anneal = sorted(anneal_steps)

    def schedule(count):
        step = max(float(count), 1.0)
        lr = init_scale * min(step ** -0.5, step * warmup_steps ** -1.5)
        return lr * anneal_rate ** sum(step > a for a in anneal)

    return schedule


def global_norm(grads):
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


class NoamAdam:
    """The optimizer state of one parameter list: first and second moments
    and the update count. ``update(grads)`` clips, advances the moments and
    moves the parameters in place; it returns the gradients' global norm
    from before the clip (a 0-d tensor)."""

    def __init__(self, params, schedule, betas=(0.9, 0.98), eps=1e-9,
                 clip=1.0, count=0):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.clip = clip
        self.count = count
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads):
        norm = global_norm(grads)
        # optax.clip_by_global_norm: g if norm < clip else g / norm * clip
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, 1 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(self.mu, 1 - self.b1 ** self.count)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(self.params, updates, alpha=-lr)
        return norm


def build_optimizer(model, model_config, train_config, d_model=None, count=0):
    """The shipped optimizer over ``model``'s parameters; ``count`` restores
    the update count of a resumed run. Returns (optimizer, schedule)."""
    opt_cfg = train_config["optimizer"]
    if (opt_cfg.get("grad_acc_step") or 1) > 1:
        raise NotImplementedError(
            "grad_acc_step > 1 is not ported yet (ROADMAP.md §1 item 9b)")
    if opt_cfg.get("weight_decay", 0.0) > 0:
        raise NotImplementedError(
            "weight_decay > 0 (adamw) is not ported yet (ROADMAP.md §1 item "
            "9b)")
    if d_model is None:
        d_model = model_config["transformer"]["encoder_hidden"]
    schedule = noam_schedule(d_model ** -0.5, opt_cfg["warm_up_step"],
                             opt_cfg["anneal_steps"], opt_cfg["anneal_rate"])
    opt = NoamAdam(model.parameters(), schedule, betas=tuple(opt_cfg["betas"]),
                   eps=opt_cfg["eps"], clip=opt_cfg["grad_clip_thresh"],
                   count=count)
    return opt, schedule
