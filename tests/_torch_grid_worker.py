"""One rank of a process grid of ctts_torch on the CPU, for
``tests/test_torch_multigpu.py`` (which also imports the cases from here,
so both sides build the same models and batches).

    python tests/_torch_grid_worker.py SPEC.json RANK

SPEC holds ``phases``: each names the ranks taking part, a free port and
the jobs those ranks run, one after another, in a gloo process group of
their own. Each job writes ``<out>/<job>.r<rank>.pt``. The worker imports
no JAX.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

STEP0 = 59999            # every schedule gate open from the first step
B = 8
SRC_LENS = [12, 9, 11, 7, 12, 10, 8, 12]
MEL_LENS = [32, 25, 30, 20, 31, 27, 22, 29]
BLOCKS = ("transformer_fs2", "transformer", "conformer", "reformer",
          "fastformer", "lstransformer")


def configs(case, heads=2, acc=1):
    """The tiny configs of a case: a block name, or ``du2021`` /
    ``liu2021`` (the fs2 model with that prosody model, ``train_sup``).
    ``heads``: the transformer-section and reformer blocks' head count;
    ``acc``: the optimizer's ``grad_acc_step``."""
    from ctts_torch.models.comp_trans_tts import prepare_model_config
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    block = case if case in BLOCKS else "transformer_fs2"
    mc["block_type"] = block
    mc["transformer"].update(encoder_layer=2, decoder_layer=2,
                             encoder_head=heads, decoder_head=heads)
    mc["conformer"].update(encoder_layer=1, decoder_layer=1,
                           encoder_hidden=32, decoder_hidden=32,
                           encoder_head=4, decoder_head=4)
    mc["reformer"].update(depth=2, encoder_head=heads, decoder_head=heads,
                          bucket_size=8)
    if case in ("du2021", "liu2021"):
        mc["duration_modeling"]["learn_alignment"] = False
        mc["prosody_modeling"]["model_type"] = case
        pre["preprocessing"]["pitch"]["pitch_type"] = "frame"
        pre["preprocessing"]["energy"]["feature"] = "frame_level"
        tr["prosody"]["prosody_loss_enable_steps"] = 0
    tr["optimizer"]["grad_acc_step"] = acc
    return pre, prepare_model_config(pre, mc), tr


def mode_of(case):
    return "train_sup" if case in ("du2021", "liu2021") else "train_unsup"


def global_batch(case, seed=0):
    from ctts_torch.utils.testing import synth_batch
    return synth_batch(B=B, T_s=12, T_m=32, seed=seed, src_lens=SRC_LENS,
                       mel_lens=MEL_LENS, sup=mode_of(case) == "train_sup")


def loader_batch(batch, T_s=None, T_m=None):
    """``batch`` as the streaming loader collates it (``Dataset.collate``):
    every per-token and per-frame array at T_s tokens and T_m frames (by
    default the rows' own longest) and zero past each row's lengths."""
    src, mel = batch["src_lens"], batch["mel_lens"]
    T_s = T_s or int(src.max())
    T_m = T_m or int(mel.max())
    n0, m0 = batch["texts"].shape[1], batch["mels"].shape[1]
    masks = {"s": (np.arange(T_s)[None] < src[:, None], T_s, n0),
             "m": (np.arange(T_m)[None] < mel[:, None], T_m, m0)}

    def fit(a, axes):
        if a is None:
            return None
        out = np.zeros((a.shape[0], *[masks[x][1] for x in axes],
                        *a.shape[1 + len(axes):]), a.dtype)
        keep = tuple(slice(0, min(masks[x][1], masks[x][2])) for x in axes)
        out[(slice(None), *keep)] = a[(slice(None), *keep)]
        for i, x in enumerate(axes):
            shape = [a.shape[0]] + [1] * (out.ndim - 1)
            shape[1 + i] = masks[x][1]
            out = out * masks[x][0].reshape(shape).astype(a.dtype)
        return out

    out = dict(batch)
    out["texts"] = fit(batch["texts"], "s")
    out["mels"] = fit(batch["mels"], "m")
    out["energies"] = fit(batch["energies"],
                          "s" if batch["energies"].shape[1] == n0 else "m")
    out["durations"] = fit(batch["durations"], "s")
    out["attn_priors"] = fit(batch["attn_priors"], "ms")
    out["pitch_data"] = {k: fit(v, "m") if v.ndim > 1 else v
                         for k, v in batch["pitch_data"].items()}
    return out


def streamed(batch, grid, pad=True):
    """This rank's rows as the train CLI's streaming loader hands them to
    the step: collated at the rows' own lengths, then (``pad``) at the
    step's largest over the data group (``parallel.mesh.step_lengths`` on
    the loader's gloo group, as ``ctts_torch.train`` takes them)."""
    from ctts_torch.parallel.mesh import host_data_group, step_lengths
    own = (int(batch["src_lens"].max()), int(batch["mel_lens"].max()))
    group = host_data_group(grid) if pad else None
    return loader_batch(batch, *step_lengths(own, group))


def build_model(case, dropout=False, seed=3, heads=2):
    """The case's model with seeded, perturbed weights (biases, norm
    scales and running statistics away from their inits, so a bias added
    twice or a statistic taken per rank shows); every Dropout's rate 0
    unless ``dropout``."""
    from ctts_torch.models.blocks import Dropout
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.utils.model import init_weights
    pre, mc, tr = configs(case, heads)
    model = init_weights(CompTransTTS(pre, mc, tr), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            noise = 0.05 * torch.randn(t.shape, generator=gen)
            if name.endswith("running_var"):
                t.copy_(t.abs() + 0.5 + noise.abs())
            else:
                t.add_(noise)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


def train_state(case, grid=None, dropout=False, step=STEP0, acc=1):
    from ctts_torch.models.registry import block_hidden
    from ctts_torch.parallel.mesh import shard_model_
    from ctts_torch.parallel.train_step import create_train_state
    from ctts_torch.utils.optimizer import build_optimizer
    pre, mc, tr = configs(case, acc=acc)
    model = build_model(case, dropout)
    if grid is not None:
        shard_model_(model, grid)
    opt, _ = build_optimizer(model, mc, tr, d_model=block_hidden(mc)[0],
                             grid=grid)
    return create_train_state(model, opt, step=step, seed=11, grid=grid)


def run_steps(case, state, batch, n):
    """n steps in train mode; the components of each as floats."""
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                make_train_step)
    pre, mc, tr = configs(case)
    step = make_train_step(pre, mc, tr, mode_of(case))
    tb = batch_to_device(batch, "cpu")
    return [{k: float(v) for k, v in step(state, tb).items()}
            for _ in range(n)]


def run_varied(case, state, grid, n):
    """n steps as :func:`run_steps`, each on the global batch of seed
    ``step % 2`` (this rank's rows of it on a grid), so accumulated
    micro-gradients differ in direction and not in scale alone."""
    from ctts_torch.parallel.mesh import shard_batch
    losses = []
    for _ in range(n):
        batch = global_batch(case, seed=state.step % 2)
        losses += run_steps(case, state, batch if grid is None
                            else shard_batch(batch, grid), 1)
    return losses


def param_names(state):
    """The state_dict name of each of the optimizer's parameters."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


def whole_mu(state, grid=None):
    """The optimizer's first moments by parameter name, whole (every rank
    of the model group takes part). After the first update of a fresh
    optimizer they are (1 - b1) times the clipped gradients."""
    from ctts_torch.parallel.mesh import gather_params
    sd = {n: m.clone() for n, m in zip(param_names(state),
                                        state.optimizer.mu)}
    return sd if grid is None else gather_params(sd, state.model.tp_specs,
                                                 grid)


def keep_raw_grads(state):
    """A list that receives, at each update, the gradients the optimizer
    was given, before any collective."""
    raw, opt = [], state.optimizer
    reduce = opt._reduce

    def spy(grads):
        raw.append([g.detach().clone() for g in grads])
        return reduce(grads)
    opt._reduce = spy
    return raw


def infer(model, batch):
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(batch["speakers"]),
                    torch.from_numpy(batch["texts"]),
                    torch.from_numpy(batch["src_lens"]), "infer",
                    max_mel_len=32)
    return {"mel": out["postnet_mel_predictions"],
            "mel_lens": out["mel_lens"]}


# ---- the jobs ------------------------------------------------------------ #

def job_train(job, grid):
    """``steps`` steps of ``case`` on the grid; rank 0 keeps the whole
    first moments after the first update and the whole parameters after
    the last, every rank its own slices (``keep_local``) and the gradients
    its updates were given before any collective (``raw``). ``acc``
    sets ``grad_acc_step``; ``stream`` hands the step this rank's rows as
    the streaming loader does (``pad: false``: at their own lengths)."""
    from ctts_torch.parallel.mesh import gather_params, shard_batch
    case = job["case"]
    state = train_state(case, grid, dropout=job.get("dropout", False),
                        acc=job.get("acc", 1))
    batch = shard_batch(global_batch(case), grid)
    if job.get("stream"):
        batch = streamed(batch, grid, job.get("pad", True))
    raw = keep_raw_grads(state) if job.get("raw") else None
    losses = run_steps(case, state, batch, 1)
    mu = whole_mu(state, grid)
    losses += run_steps(case, state, batch, job["steps"] - 1)
    local = state.model.state_dict()
    whole = gather_params(local, state.model.tp_specs, grid)
    res = {"losses": losses, "specs": sorted(state.model.tp_specs)}
    if grid.rank == 0:
        res["params"], res["mu"] = whole, mu
    if job.get("keep_local"):
        res["local"] = local
    if raw is not None:
        res["raw"], res["names"] = raw, param_names(state)
        res["partial"] = [n for n, p in zip(res["names"],
                                            state.optimizer.params)
                          if getattr(p, "tp_partial", False)]
    return res


def job_infer(job, grid):
    from ctts_torch.parallel.mesh import shard_batch, shard_model_
    model = build_model(job["case"])
    shard_model_(model, grid)
    return infer(model, shard_batch(global_batch(job["case"]), grid))


def job_save(job, grid):
    """``calls`` steps on the grid (2 by default), then a checkpoint (rank 0
    writes), then ``after`` more steps; ``acc`` sets ``grad_acc_step``
    (and the steps then alternate two batches, :func:`run_varied`).
    Rank 0 keeps the whole first moments after the last step."""
    from ctts_torch.parallel.mesh import shard_batch
    from ctts_torch.utils.checkpoint import save_checkpoint
    case, acc = job["case"], job.get("acc", 1)
    state = train_state(case, grid, dropout=job.get("dropout", False),
                        acc=acc)
    batch = shard_batch(global_batch(case), grid)

    def run(n):
        return (run_varied(case, state, grid, n) if acc > 1 else
                run_steps(case, state, batch, n))
    losses = run(job.get("calls", 2))
    save_checkpoint(job["ckpt_dir"], state, state.step)
    losses += run(job.get("after", 0))
    return keep_mu({"losses": losses}, state, grid)


def job_resume(job, grid):
    """Restore ``ckpt_dir``'s step ``ckpt_step`` (the latest without one)
    on the grid and take two more steps; ``acc`` sets ``grad_acc_step``
    (the steps then as in :func:`job_save`).
    Rank 0 keeps the whole first moments after them."""
    from ctts_torch.parallel.mesh import shard_batch
    from ctts_torch.utils.checkpoint import restore_checkpoint
    case = job["case"]
    state = train_state(case, grid, dropout=job.get("dropout", False),
                        acc=job.get("acc", 1))
    restore_checkpoint(job["ckpt_dir"], state, job.get("ckpt_step"))
    losses = (run_varied(case, state, grid, 2) if job.get("acc", 1) > 1 else
              run_steps(case, state, shard_batch(global_batch(case), grid),
                        2))
    return keep_mu({"losses": losses}, state, grid)


def keep_mu(res, state, grid):
    mu = whole_mu(state, grid)
    if grid.rank == 0:
        res["mu"] = mu
    return res


JOBS = {"train": job_train, "infer": job_infer, "save": job_save,
        "resume": job_resume}


def main(spec_path, rank):
    import torch.distributed as dist
    from ctts_torch.parallel.mesh import init_distributed, make_mesh
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    for phase in spec["phases"]:
        if rank not in phase["ranks"]:
            continue
        init_distributed(f"127.0.0.1:{phase['port']}", len(phase["ranks"]),
                         phase["ranks"].index(rank), device="cpu")
        try:
            for job in phase["jobs"]:
                grid = make_mesh(*job["grid"])
                path = os.path.join(spec["out"],
                                    f"{job['name']}.r{grid.rank}.pt")
                try:
                    res = JOBS[job["kind"]](job, grid)
                except Exception:
                    res = {"error": traceback.format_exc()}
                torch.save(res, path + ".tmp")
                os.replace(path + ".tmp", path)
                print(f"rank {rank}: {job['name']} done", flush=True)
                dist.barrier()
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
