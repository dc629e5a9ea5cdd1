"""The (data, model) process grid: data parallelism × tensor parallelism
(ctts_tpu/parallel/mesh.py), one process per card.

The JAX package runs one program over a ``('data', 'model')`` device mesh
and lets GSPMD insert the collectives. Here each process drives one card
and holds one cell of the grid: ``make_mesh`` lays the world's ranks out
row-major as ``np.arange(world).reshape(data, model)`` and returns this
rank's :class:`Grid` with two process groups, the model group (the ranks of
its row: one data index, every model index) and the data group (the ranks
of its column). The batch is split over the data axis
(:func:`shard_batch`, or each data rank reading its own shard of the
store); the blocks' attention heads and FFN channels over the model axis
(:func:`shard_model_`, the rules of :data:`_TP_RULES`).

``_TP_RULES`` is the JAX table rewritten on the port's upstream state_dict
names and torch layouts: a Linear weight is ``[out, in]`` (flax ``[in,
out]``), a Conv1d weight ``[out, in, k]`` (flax ``[k, in, out]``), and the
fs2 attention's fused ``in_proj_weight [3C, C]`` holds the q, k and v that
JAX keeps as three ``[C, H, Dh]`` kernels, so its spec shards each third.
JAX replicates every bias and lets GSPMD reshard them; here a
column-parallel layer's bias is sliced with its weight (its rule names
it), and a row-parallel layer's bias stays whole and is added once, after
the reduction (``blocks.ParallelLayer``).

The rules are the one place that says what shards: ``shard_model_`` cuts
every parameter they name, and a Linear's or Conv1d's role (column or row)
is its rule's axis. The unit of sharding is the module that holds the
heads or channels (it has ``tp_units()``; its forward reads its share of
them from ``tp``): a module whose unit count the model axis does not
divide stays replicated as a whole, with the JAX package's warning
(``check_tp_coverage``).
"""

import dataclasses
import os
import re
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ctts_torch.models.blocks import ParallelLayer
from ctts_torch.parallel.tensor_parallel import (ModelShard, shard_param_,
                                                 unshard_tensor)


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device=None, backend=None):
    """Join the process group of a multi-process run: ``coordinator`` is
    ``host:port`` of process 0 (flags fall back to ``CTTS_COORDINATOR``,
    ``CTTS_NUM_PROCESSES`` and ``CTTS_PROCESS_ID``). ``backend`` defaults to
    ``nccl`` for a CUDA ``device`` and ``gloo`` otherwise; pass
    ``backend="gloo"`` to put two ranks on one card (NCCL refuses that). A
    failed init raises: nothing swaps the backend on its own. Returns True
    when the group was initialised, False without a coordinator."""
    coordinator = coordinator or os.environ.get("CTTS_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("CTTS_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("CTTS_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs --num_processes and "
                         "--process_id (or CTTS_NUM_PROCESSES and "
                         "CTTS_PROCESS_ID)")
    device = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    return True


@dataclasses.dataclass
class Grid:
    """This rank's cell of a ``data × model`` grid of processes."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object = None          # None where the axis has one rank
    model_group: object = None

    @property
    def rank(self):
        return self.data_rank * self.model + self.model_rank

    def model_shard(self):
        """The model group as a ``ModelShard``, None without one."""
        if self.model == 1:
            return None
        return ModelShard(self.model_rank, self.model, self.model_group)


def make_mesh(data=-1, model=1):
    """The grid of the initialised world (one process when there is none):
    ``data=-1`` takes every rank the model axis leaves. Every rank calls it,
    in the same order, since it creates the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    model = max(int(model), 1)
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"train.mesh data {data} × model {model} must equal "
                         f"the world size {world}")
    cells = np.arange(world).reshape(data, model)
    grid = Grid(data, model, rank // model, rank % model)
    if world == 1:
        return grid
    for d in range(data):                       # the rows: model groups
        g = dist.new_group(cells[d].tolist()) if model > 1 else None
        if d == grid.data_rank:
            grid.model_group = g
    for m in range(model):                      # the columns: data groups
        g = dist.new_group(cells[:, m].tolist()) if data > 1 else None
        if m == grid.model_rank:
            grid.data_group = g
    return grid


def shard_batch(batch, grid):
    """This data rank's rows of a global batch (a dict of arrays or tensors,
    nested one level, ``None`` kept); every leading axis splits into
    ``grid.data`` equal parts. Model-group peers take the same rows."""
    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        if v is None or not hasattr(v, "shape") or len(v.shape) == 0:
            return v
        n = v.shape[0]
        if n % grid.data:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{grid.data} data ranks")
        k = n // grid.data
        return v[grid.data_rank * k:(grid.data_rank + 1) * k]
    return {k: take(v) for k, v in batch.items()}


def host_data_group(grid):
    """A gloo twin of ``grid``'s data group, for host integers that a
    thread other than the step's exchanges (the streaming loader's step
    lengths): two threads must not issue collectives on one group. None
    where the data axis has one rank. Every rank calls it, in the same
    order, since it creates the groups."""
    if grid is None or grid.data == 1:
        return None
    cells = np.arange(grid.data * grid.model).reshape(grid.data, grid.model)
    mine = None
    for m in range(grid.model):
        g = dist.new_group(cells[:, m].tolist(), backend="gloo")
        if m == grid.model_rank:
            mine = g
    return mine


def step_lengths(lengths, group):
    """The step's padded lengths: the largest of each entry of
    ``lengths`` (this rank's [T_s, T_m]) over ``group``'s ranks, in one
    all-reduce of two integers; ``lengths`` as they are without a group."""
    if group is None:
        return tuple(int(x) for x in lengths)
    t = torch.tensor([int(x) for x in lengths], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return tuple(int(x) for x in t.tolist())


# ---- the tensor-parallel rules -------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Spec:
    """Shard ``axis`` over the model ranks; with ``groups`` the axis is
    that many equal blocks, each sharded (the fused q, k and v)."""
    axis: int
    groups: int = 1


_S = r"^(encoder|decoder)\."
# Matched against state_dict names; the first hit wins, the default is
# replication. Each line names the JAX rule (ctts_tpu/parallel/mesh.py)
# it stands for.
_TP_RULES = [
    # transformer_fs2 (ffn.*ffn_1 / ffn_2, self_attn q|k|v / out)
    (_S + r"layers\.\d+\.op\.ffn\.ffn_1\.(weight|bias)$", Spec(0)),
    (_S + r"layers\.\d+\.op\.ffn\.ffn_2\.weight$", Spec(1)),
    (_S + r"layers\.\d+\.op\.self_attn\.in_proj_weight$", Spec(0, 3)),
    (_S + r"layers\.\d+\.op\.self_attn\.out_proj\.weight$", Spec(1)),
    # transformer (pos_ffn/w_1, w_2; slf_attn w_qs|w_ks|w_vs / fc)
    (_S + r"layer_stack\.\d+\.pos_ffn\.w_1\.(weight|bias)$", Spec(0)),
    (_S + r"layer_stack\.\d+\.pos_ffn\.w_2\.weight$", Spec(1)),
    (_S + r"layer_stack\.\d+\.slf_attn\.(w_qs|w_ks|w_vs)\.linear\.weight$",
     Spec(0)),
    (_S + r"layer_stack\.\d+\.slf_attn\.fc\.linear\.weight$", Spec(1)),
    # fastformer and lstransformer conv-gelu FFN (ff_*/w_1, w_2)
    (_S + r"layer_stack\.layers\.\d+\.1\.fn\.w_1\.(weight|bias)$", Spec(0)),
    (_S + r"layer_stack\.layers\.\d+\.1\.fn\.w_2\.weight$", Spec(1)),
    # fastformer (attn_*/query|key, transform, to_{q,k}_attn_logits)
    (_S + r"layer_stack\.layers\.\d+\.0\.fn\.(query|key)\.(weight|bias)$",
     Spec(0)),
    (_S + r"layer_stack\.layers\.\d+\.0\.fn\.transform\.weight$", Spec(1)),
    (_S + r"layer_stack\.layers\.\d+\.0\.fn\.to_(q|k)_attn_logits\.weight$",
     Spec(1)),
    # lstransformer (attn_*/to_q|to_kv, to_out)
    (_S + r"layer_stack\.layers\.\d+\.0\.fn\.(to_q|to_kv)\.weight$", Spec(0)),
    (_S + r"layer_stack\.layers\.\d+\.0\.fn\.to_out\.weight$", Spec(1)),
    # conformer (ff1|ff2 Dense_0 / Dense_1; attn projections, out_proj,
    # u_bias|v_bias)
    (_S + r"layer_stack\.\d+\.sequential\.[03]\.module\.sequential\.1\."
     r"linear\.(weight|bias)$", Spec(0)),
    (_S + r"layer_stack\.\d+\.sequential\.[03]\.module\.sequential\.4\."
     r"linear\.weight$", Spec(1)),
    (_S + r"layer_stack\.\d+\.sequential\.1\.module\.attention\."
     r"(query_proj|key_proj|value_proj|pos_proj)\.linear\.weight$", Spec(0)),
    (_S + r"layer_stack\.\d+\.sequential\.1\.module\.attention\.out_proj\."
     r"linear\.weight$", Spec(1)),
    (_S + r"layer_stack\.\d+\.sequential\.1\.module\.attention\."
     r"(u_bias|v_bias)$", Spec(0)),
    # reformer (attn/toqk|tov, to_out; ff/w1, w2), tied across depth
    (_S + r"layer_stack\.net\.layers\.irrev_blocks\.\d+\.f\.fn\.(toqk|tov)\."
     r"weight$", Spec(0)),
    (_S + r"layer_stack\.net\.layers\.irrev_blocks\.\d+\.f\.fn\.to_out\."
     r"weight$", Spec(1)),
    (_S + r"layer_stack\.net\.layers\.irrev_blocks\.\d+\.g\.fn\.fn\.w1\."
     r"(weight|bias)$", Spec(0)),
    (_S + r"layer_stack\.net\.layers\.irrev_blocks\.\d+\.g\.fn\.fn\.w2\."
     r"weight$", Spec(1)),
]
_TP_RULES = [(re.compile(r), spec) for r, spec in _TP_RULES]


def param_spec(name, tensor):
    """The rule's ``Spec`` for the state_dict entry ``name``, None where it
    stays replicated (no rule matches, or the axis is not there)."""
    for rule, spec in _TP_RULES:
        if rule.match(name) and spec.axis < tensor.dim():
            return spec
    return None


def _units(model):
    """{module name: its unit count}, every name a shared module has."""
    return {name: m.tp_units() for name, m in
            model.named_modules(remove_duplicate=False)
            if hasattr(m, "tp_units")}


def param_specs(model, size, dropped=None):
    """{state_dict name: Spec} of ``model`` (whole, before sharding) on a
    model axis of ``size``. A module whose unit count ``size`` does not
    divide keeps every parameter whole; with ``dropped`` a list, its
    parameters are appended to it as (name, shape, spec)."""
    units = _units(model)
    specs = {}
    for name, t in model.state_dict().items():
        spec = param_spec(name, t)
        if spec is None:
            continue
        owner = max((u for u in units if name.startswith(u + ".")),
                    key=len, default=None)
        if owner is None:
            raise ValueError(f"{name} matches a tensor-parallel rule outside "
                             "a module that shards")
        if units[owner] % size:
            if dropped is not None:
                dropped.append((name, tuple(t.shape), spec))
            continue
        specs[name] = spec
    return specs


def check_tp_coverage(model, size, block_type=None):
    """Fail fast when the model axis is > 1 and no parameter shards: every
    rank would hold a full replica. Warn for modules replicated because the
    axis does not divide their heads or channels. Returns the count of
    sharded parameters."""
    if size <= 1:
        return 0
    dropped = []
    hits = len(param_specs(model, size, dropped))
    if hits == 0:
        raise ValueError(
            f"mesh model axis = {size} but no parameter of "
            f"block_type={block_type!r} matches a tensor-parallel rule "
            "(ctts_torch/parallel/mesh.py _TP_RULES) — the model axis would "
            "silently replicate. Use model=1 or add TP rules for this block.")
    if dropped:
        ex = "; ".join(f"{p} {s}" for p, s, _ in dropped[:4])
        warnings.warn(
            f"{len(dropped)} parameter(s) matched a TP rule but were "
            f"replicated because a sharded dim is not divisible by the "
            f"model axis ({size}): {ex}"
            + (" ..." if len(dropped) > 4 else "")
            + f" — {hits} parameter(s) remain sharded. Pick head/channel "
            "counts divisible by the model axis to keep full tensor "
            "parallelism.", stacklevel=2)
    return hits


def shard_model_(model, grid):
    """Slice ``model`` (whole, on any device) to this rank's share of the
    model axis in place: every parameter ``param_specs`` names is cut on
    its rule's axis (a tied one once); a Linear or Conv1d whose weight is
    named runs column-parallel where the rule cuts axis 0 and row-parallel
    where it cuts axis 1; each module that shards gets ``tp`` and, where it
    has one, its ``shard_(tp)`` hook (a Dropout over the sharded axis,
    parameters whose gradients are partial). Records the specs at
    ``model.tp_specs`` and returns them."""
    tp = grid.model_shard()
    if tp is None:
        model.tp_specs = {}
        return model.tp_specs
    specs = param_specs(model, tp.size)
    cut = set()
    for name, p in model.named_parameters(remove_duplicate=False):
        if name in specs and id(p) not in cut:
            shard_param_(p, tp, specs[name].axis, specs[name].groups)
            cut.add(id(p))
    for name, m in model.named_modules():
        spec = specs.get(f"{name}.weight")
        if isinstance(m, ParallelLayer) and spec is not None:
            m.tp = (tp, ("col", "row")[spec.axis])
        if hasattr(m, "tp_units") and m.tp_units() % tp.size == 0:
            m.tp = tp
            if hasattr(m, "shard_"):
                m.shard_(tp)
    model.tp_specs = specs
    return specs


def shard_params(state_dict, specs, grid):
    """A whole state_dict → this rank's (``utils.weights.shard_state_dict``
    on the grid's model axis)."""
    from ctts_torch.utils.weights import shard_state_dict
    return shard_state_dict(state_dict, specs, grid.model_rank, grid.model)


def gather_tensor(t, spec, grid):
    """The whole tensor of this rank's slice ``t``: an all-gather over the
    model group."""
    # gloo gathers host tensors (two ranks may share a card over gloo)
    host = t.is_cuda and dist.get_backend(grid.model_group) == "gloo"
    x = t.detach().cpu() if host else t.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(grid.model)]
    dist.all_gather(parts, x.contiguous(), group=grid.model_group)
    return unshard_tensor(parts, spec.axis, spec.groups).to(t.device)


def gather_params(state_dict, specs, grid):
    """This rank's state_dict → the whole one (every model-group rank
    takes part; all get the result)."""
    if grid.model == 1:
        return dict(state_dict)
    return {k: (gather_tensor(v, specs[k], grid) if k in specs else v)
            for k, v in state_dict.items()}
