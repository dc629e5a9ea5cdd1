"""The collectives of the (data, model) process grid, as autograd functions.

Under GSPMD the JAX package gets the single-device math of a sharded step
for free; here each collective is written where the math needs it.

Tensor parallelism (Megatron's two conjugate functions, over the model
group, whose ranks share a data index and hold one slice each of a sharded
layer):

* :func:`copy_to_model` where a replicated activation enters a
  column-parallel layer: identity forward, all-reduce of the gradient
  backward (each rank's slice contributes its part of the input's
  gradient);
* :func:`reduce_from_model` at a row-parallel layer's output: all-reduce
  forward (each rank holds a partial sum), identity backward.

A :class:`ModelShard` names this rank's slice and the model group; a
``blocks.Linear`` or ``blocks.Conv1d`` holding one (``.tp``, set by
``mesh.shard_model_``) inserts the collective itself, and adds a
row-parallel layer's bias once, after the reduction.

Data parallelism: :func:`data_parallel` sets the data group for the code
run under it (the forward, the loss, the BatchNorms). The loss divides each
rank's numerator by the denominator summed over the data group
(:func:`global_sum`), so the ranks' losses add up to the loss of the global
batch and their gradients are summed, not averaged. A BatchNorm in training
pools its batch statistics with :func:`pooled_sum`, a differentiable
all-reduce. Outside a grid every function is the identity.

All-reduces run in float32 whatever the activations' dtype.
"""

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in its model group: ``rank`` of ``size``; ``group``
    the process group (None in a single process that only slices)."""
    rank: int
    size: int
    group: object = None

    def bounds(self, n):
        """[lo, hi) of this rank's equal share of n."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} ranks")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def shard_tensor(t, axis, rank, size, groups=1):
    """Rank ``rank``'s slice of ``t`` along ``axis`` split over ``size``
    ranks; with ``groups`` the axis is that many equal blocks (the fused
    q, k and v rows) and the rank keeps its slice of each."""
    n = t.shape[axis] // groups
    if t.shape[axis] % groups or n % size:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split "
                         f"into {groups} block(s) over {size} ranks")
    k = n // size
    parts = [t.narrow(axis, g * n + rank * k, k) for g in range(groups)]
    return torch.cat(parts, axis) if groups > 1 else parts[0]


def unshard_tensor(parts, axis, groups=1):
    """The full tensor from the ranks' slices (in rank order):
    :func:`shard_tensor`'s inverse."""
    blocks = [p.chunk(groups, axis) for p in parts]
    return torch.cat([b[g] for g in range(groups) for b in blocks], axis)


def shard_param_(param, tp, axis, groups=1):
    """Keep this rank's slice of ``param`` in place (the object stays,
    marked ``tp_sharded`` for the clip norm)."""
    with torch.no_grad():
        param.data = shard_tensor(param.data, axis, tp.rank, tp.size,
                                  groups).clone()
    param.tp_sharded = True


def all_reduce(x, group):
    """Sum of ``x`` over ``group``, computed in float32, in ``x``'s dtype
    and memory layout (a transposed conv output stays transposed, so what
    follows it, a dropout mask's draw among them, sees one process's
    layout)."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    y = x.detach().permute(order).to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.permute([order.index(d) for d in range(x.dim())]).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """All-reduce forward and backward: y = Σ_r x_r on every rank, so
    dL/dx_r = Σ_s dL_s/dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def copy_to_model(x, tp):
    """Identity forward, gradient summed over the model group backward."""
    if tp is None or tp.size == 1:
        return x
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x, tp):
    """Partial sums summed over the model group forward, identity
    backward."""
    if tp is None or tp.size == 1:
        return x
    return _ReduceFromModel.apply(x, tp.group)


def embed_slice(x, tp, full, dim=-1):
    """``x``, this rank's slice of a ``full``-wide axis ``dim``, placed in a
    zero tensor of the full width: summed over the model group it gives the
    gathered tensor (a column-sharded term folded into a reduction)."""
    lo, hi = tp.bounds(full)
    dim = dim % x.dim()
    return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [lo, full - hi])


# ---- the data group ------------------------------------------------------- #

_DATA_GROUP = contextvars.ContextVar("ctts_data_group", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Run the enclosed forward and loss as one data rank of ``group``
    (None: a single process)."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def global_sum(x):
    """``x`` (detached) summed over the data group: a loss denominator."""
    group = _DATA_GROUP.get()
    x = x.detach() if torch.is_tensor(x) else torch.tensor(float(x))
    return x if group is None else all_reduce(x, group)


def global_mean(x):
    """The mean of ``x``'s entries over the global batch: this rank's sum
    over the entries counted on every rank."""
    if _DATA_GROUP.get() is None:
        return torch.mean(x)
    return torch.sum(x) / global_sum(x.new_tensor(float(x.numel())))


def pooled_sum(x):
    """``x`` summed over the data group, differentiably (batch statistics)."""
    group = _DATA_GROUP.get()
    return x if group is None else _SumOverGroup.apply(x, group)


def batch_moments(x, dims):
    """(mean, mean of squares) of ``x`` over ``dims``, over the global batch
    inside :func:`data_parallel`."""
    if _DATA_GROUP.get() is None:
        return x.mean(dim=dims), (x * x).mean(dim=dims)
    n = 1
    for d in dims:
        n *= x.shape[d]
    count = global_sum(x.new_tensor(float(n)))
    sums = pooled_sum(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]))
    return sums[0] / count, sums[1] / count
