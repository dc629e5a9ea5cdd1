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

``weight_decay > 0`` is ``optax.adamw``: ``wd·param`` is added to the Adam
direction before the rate scales it. ``grad_acc_step = k > 1`` is
``optax.MultiSteps``: the running mean ``acc + (g - acc)/(i+1)`` of k
micro-gradients, one clipped update every k calls (none in between), and the
schedule counting updates.

On a (data, model) grid (``grid``, a ``parallel.mesh.Grid``) each call
first sums the gradients over the data group, in one all-reduce of the
flat gradients (with k > 1 each micro-gradient is reduced so, and the
reduced ones are accumulated: the norm of every call is then the global
micro-gradient's, as ``optax.global_norm`` logs it in the JAX step),
sums over the model group the gradients of the replicated parameters that
each model rank applies to its own heads only (``tp_partial``: the
lstransformer's per-head norms and projection), gives every other
replicated parameter model rank 0's gradient (the peers compute the same
one, but on the card cuDNN's convolution algorithms and an embedding's
backward are not deterministic, so its last bits can differ, and peers
that update apart drift apart), and clips by the global norm: the squares
of the tensor-parallel slices summed over the model group, each
replicated parameter counted once. Every rank then applies the same clip
factor and the single-device update.
"""

import torch
import torch.distributed as dist


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
                 clip=1.0, count=0, weight_decay=0.0, acc_steps=1,
                 grid=None):
        self.params = list(params)
        self.grid = grid
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.clip = clip
        self.count = count
        self.weight_decay = weight_decay
        self.acc_steps = acc_steps
        self.mini_step = 0                 # micro-gradients accumulated
        self.acc = None
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self):
        """Moments, counts and the gradient accumulator (None when empty)."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state):
        with torch.no_grad():
            for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"])):
                for d, x in zip(dst, src, strict=True):
                    d.copy_(x)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.acc = (None if state["acc"] is None else
                    [x.to(p.device) for x, p in zip(state["acc"],
                                                    self.params)])

    def _reduce(self, grads):
        """The gradients summed over the data group, the partial ones
        summed over the model group and the other replicated ones taken
        from model rank 0 (one flat collective each)."""
        grid = self.grid
        if grid is None:
            return grads
        grads = list(grads)
        partial, replicated = [], []
        for i, p in enumerate(self.params):
            if getattr(p, "tp_partial", False):
                partial.append(i)
            elif not getattr(p, "tp_sharded", False):
                replicated.append(i)
        src = grid.data_rank * grid.model            # model rank 0's rank
        for group, idx, op in ((grid.data_group, range(len(grads)), "sum"),
                               (grid.model_group, partial, "sum"),
                               (grid.model_group, replicated, "bcast")):
            if group is None or not idx:
                continue
            sub = [grads[i] for i in idx]
            flat = torch.cat([g.float().reshape(-1) for g in sub])
            if op == "sum":
                dist.all_reduce(flat, group=group)
            else:
                dist.broadcast(flat, src=src, group=group)
            for i, f, g in zip(idx, flat.split([g.numel() for g in sub]),
                               sub):
                grads[i] = f.view_as(g).to(g.dtype)
        return grads

    def _norm(self, grads):
        grid = self.grid
        if grid is None or grid.model_group is None:
            return global_norm(grads)
        sq = torch.zeros(2, device=grads[0].device)
        for p, g in zip(self.params, grads):
            sq[int(getattr(p, "tp_sharded", False))] += torch.sum(
                g.float() ** 2)
        sharded = sq[1:].clone()
        dist.all_reduce(sharded, group=grid.model_group)
        return torch.sqrt(sq[0] + sharded[0])

    @torch.no_grad()
    def update(self, grads):
        grads = self._reduce(grads)
        norm = self._norm(grads)
        if self.acc_steps > 1:
            i = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(i + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (i + 1) % self.acc_steps
            if self.mini_step:
                return norm
            grads, self.acc = self.acc, None
            clip_norm = self._norm(grads)
        else:
            clip_norm = norm
        # optax.clip_by_global_norm: g if norm < clip else g / norm * clip
        scale = torch.where(clip_norm < self.clip, torch.ones_like(clip_norm),
                            self.clip / clip_norm)
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
        if self.weight_decay > 0:
            torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, updates, alpha=-lr)
        return norm


def build_optimizer(model, model_config, train_config, d_model=None, count=0,
                    grid=None):
    """The shipped optimizer over ``model``'s parameters; ``count`` restores
    the update count of a resumed run; ``grid`` the process grid of a
    multi-process run (``model`` already sharded). Returns (optimizer,
    schedule)."""
    opt_cfg = train_config["optimizer"]
    if d_model is None:
        d_model = model_config["transformer"]["encoder_hidden"]
    schedule = noam_schedule(d_model ** -0.5, opt_cfg["warm_up_step"],
                             opt_cfg["anneal_steps"], opt_cfg["anneal_rate"])
    opt = NoamAdam(model.parameters(), schedule, betas=tuple(opt_cfg["betas"]),
                   eps=opt_cfg["eps"], clip=opt_cfg["grad_clip_thresh"],
                   count=count,
                   weight_decay=opt_cfg.get("weight_decay", 0.0) or 0.0,
                   acc_steps=opt_cfg.get("grad_acc_step") or 1, grid=grid)
    return opt, schedule
