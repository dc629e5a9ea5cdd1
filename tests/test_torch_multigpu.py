"""The port's (data, model) process grid on the CPU (ctts_torch/parallel/
mesh.py, tensor_parallel.py): gloo process groups of up to 4 ranks hold
the single-device math, as tests/test_mesh.py holds the JAX package's mesh.

One spawn of 4 ranks (``_torch_grid_worker.py``) runs every grid case of
the module in three phases: a (2, 2) grid on all four ranks, then a (2, 1)
grid on ranks 0-1 beside a (1, 2) grid on ranks 2-3. Meanwhile this
process computes the references: the port's one-process steps on the same
global batch of 8 and weights, and the JAX package's single-device step.
Every wait has a timeout, so a hung collective fails a test instead of
stalling the suite. The CLI case starts its own two ranks.

Models: the tiny configs (width 32, fs2 with 2 heads, so 1 head a rank at
``model: 2``; conformer with 4 heads; reformer with 1 local and 1 LSH head,
one a rank), float32, every dropout rate 0 unless a case says otherwise,
in train mode (the BatchNorms take batch statistics, pooled over the data
group on a grid). Tolerances: losses rtol 5e-4 (the JAX package's
test_mesh.py), parameters after two updates atol 1e-5, the first
update's gradients leaf by leaf (the optimizer's first moments) within
``GRAD_RTOL`` of each leaf's scale of one process's (and, for fs2, of the
JAX package's), sharded inference mels atol 5e-4 with lengths exact,
resumed losses rtol 1e-5.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_grid_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
OTHER_BLOCKS = ("transformer", "conformer", "reformer", "fastformer",
                "lstransformer")
CKPT_STEP = W.STEP0 + 2
ACC_CALLS = 4            # two updates at grad_acc_step 2
ACC_SAVE_CALLS = 3       # a save halfway through the second update
STREAM_BLOCKS = ("transformer_fs2", "reformer")
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("CTTS_COORDINATOR", "CTTS_NUM_PROCESSES",
                        "CTTS_PROCESS_ID")}
    env["OMP_NUM_THREADS"] = "1"
    return env


class _Grid:
    """The spawned ranks and their results."""

    def __init__(self, out, phases, n):
        self.out = out
        with open(os.path.join(out, "spec.json"), "w") as f:
            json.dump({"out": out, "phases": phases}, f)
        worker = os.path.join(REPO, "tests", "_torch_grid_worker.py")
        self.logs = [open(os.path.join(out, f"rank{r}.log"), "w")
                     for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, worker, os.path.join(out, "spec.json"), str(r)],
            stdout=log, stderr=subprocess.STDOUT, env=_env(), cwd=REPO)
            for r, log in enumerate(self.logs)]
        self.deadline = time.time() + TIMEOUT
        self.codes = None

    def wait(self):
        if self.codes is None:
            codes = []
            for p in self.procs:
                try:
                    codes.append(p.wait(max(self.deadline - time.time(), 1)))
                except subprocess.TimeoutExpired:
                    codes.append("timeout")
            self.kill()
            self.codes = codes
        return self.codes

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def result(self, name, rank=0):
        codes = self.wait()
        path = os.path.join(self.out, f"{name}.r{rank}.pt")
        if not os.path.exists(path):
            tails = [open(os.path.join(self.out, f"rank{r}.log")).read()[-2000:]
                     for r in range(len(self.procs))]
            pytest.fail(f"no result {name} from rank {rank}; exit codes "
                        f"{codes}; logs:\n" + "\n----\n".join(tails))
        res = torch.load(path, weights_only=False)
        assert "error" not in res, res.get("error")
        return res


def _train_job(name, case, grid, steps=2, **extra):
    return dict(name=name, kind="train", case=case, grid=grid, steps=steps,
                **extra)


@functools.lru_cache(maxsize=None)
def _one_process(case, steps=2, dropout=False, acc=1, stream=False):
    """The port's one-process steps on the global batch (``stream``: as the
    streaming loader collates it): (losses, whole state_dict, first
    moments after the first update)."""
    state = W.train_state(case, dropout=dropout, acc=acc)
    batch = W.global_batch(case)
    if stream:
        batch = W.loader_batch(batch)
    losses = W.run_steps(case, state, batch, 1)
    mu = W.whole_mu(state)
    losses += W.run_steps(case, state, batch, steps - 1)
    return losses, state.model.state_dict(), mu


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    from ctts_torch.utils.checkpoint import save_checkpoint
    out = str(tmp_path_factory.mktemp("grid"))
    ckpt_1p, ckpt_tp, ckpt_dp, ckpt_acc = (
        os.path.join(out, d) for d in ("ckpt_1p", "ckpt_tp", "ckpt_dp",
                                       "ckpt_acc"))
    # the straight one-process run writes its step-2 checkpoint first
    state = W.train_state("transformer_fs2")
    batch = W.global_batch("transformer_fs2")
    straight = W.run_steps("transformer_fs2", state, batch, 2)
    save_checkpoint(ckpt_1p, state, state.step)
    straight += W.run_steps("transformer_fs2", state, batch, 2)
    phases = [
        {"ranks": [0, 1, 2, 3], "port": _free_port(), "jobs": [
            _train_job("fs2_2x2", "transformer_fs2", [2, 2]),
            _train_job("dropout_2x2", "transformer_fs2", [2, 2], steps=3,
                       dropout=True, keep_local=True, raw=True),
            dict(name="acc_save_2x2", kind="save", case="transformer_fs2",
                 grid=[2, 2], ckpt_dir=ckpt_acc, acc=2, calls=ACC_SAVE_CALLS,
                 after=2)]},
        {"ranks": [0, 1], "port": _free_port(), "jobs": [
            _train_job("fs2_2x1", "transformer_fs2", [2, 1]),
            _train_job("du2021_2x1", "du2021", [2, 1]),
            _train_job("liu2021_2x1", "liu2021", [2, 1]),
            dict(name="infer_2x1", kind="infer", case="transformer_fs2",
                 grid=[2, 1]),
            dict(name="resume_2x1", kind="resume", case="transformer_fs2",
                 grid=[2, 1], ckpt_dir=ckpt_1p, ckpt_step=CKPT_STEP),
            dict(name="dropout_save_2x1", kind="save", case="transformer_fs2",
                 grid=[2, 1], ckpt_dir=ckpt_dp, dropout=True, after=2),
            dict(name="dropout_resume_2x1", kind="resume",
                 case="transformer_fs2", grid=[2, 1], ckpt_dir=ckpt_dp,
                 ckpt_step=CKPT_STEP, dropout=True),
            _train_job("fs2_acc_2x1", "transformer_fs2", [2, 1],
                       steps=ACC_CALLS, acc=2),
            *[_train_job(f"{b}_stream_2x1", b, [2, 1], stream=True)
              for b in STREAM_BLOCKS],
            dict(name="acc_resume_2x1", kind="resume", case="transformer_fs2",
                 grid=[2, 1], ckpt_dir=ckpt_acc, acc=2)]},
        {"ranks": [2, 3], "port": _free_port(), "jobs": [
            _train_job("fs2_1x2", "transformer_fs2", [1, 2]),
            *[_train_job(f"{b}_1x2", b, [1, 2]) for b in OTHER_BLOCKS],
            *[_train_job(f"{b}_dropout_1x2", b, [1, 2], dropout=True,
                         raw=True) for b in W.BLOCKS],
            dict(name="infer_1x2", kind="infer", case="transformer_fs2",
                 grid=[1, 2]),
            dict(name="save_1x2", kind="save", case="transformer_fs2",
                 grid=[1, 2], ckpt_dir=ckpt_tp),
            _train_job("fs2_acc_1x2", "transformer_fs2", [1, 2],
                       steps=ACC_CALLS, acc=2),
            dict(name="acc_resume_1x2", kind="resume", case="transformer_fs2",
                 grid=[1, 2], ckpt_dir=ckpt_acc, acc=2)]}]
    grid = _Grid(out, phases, 4)
    grid.straight = straight
    grid.ckpt_tp, grid.ckpt_acc = ckpt_tp, ckpt_acc
    try:
        yield grid
    finally:
        grid.kill()


def _assert_losses(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6,
                                       err_msg=k)


def _assert_grads(got, want, rtol):
    """The first moments after the first update, (1 - b1) times the
    clipped gradients, leaf by leaf: each leaf's largest difference within
    ``rtol`` of that leaf's largest entry, or of ``GRAD_FLOOR`` times the
    largest entry of any leaf where that is more. The floor is for the
    leaves whose gradient is zero but for rounding (a conv bias before a
    BatchNorm in training, a logit bias before a softmax over the axis it
    is added along): they hold 1e-9 of the largest leaf or less here, the
    smallest others 1e-5 or more. Returns the worst leaf's ratio."""
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    worst, name = 0.0, None
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        ratio = err / max(w.abs().max().item(), floor)
        if ratio > worst:
            worst, name = ratio, k
    assert worst <= rtol, f"{name}: {worst:.3e} of its scale"
    return worst


def _assert_params(got, want, atol=1e-5):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol,
                                       rtol=0, err_msg=k)
        else:
            assert torch.equal(got[k], w), k


# ---- the JAX package's single-device step ---------------------------------- #

@functools.lru_cache(maxsize=None)
def _jax_steps(case, steps=2, acc=1):
    """The JAX package's train-mode step (dropout patched out, as the port's
    rates are 0) from the port's initial weights, ``steps`` times, with
    ``grad_acc_step`` ``acc``: (the losses, the first call's (1 - b1) times
    clipped gradients carried to the port's names and layouts, which is
    the port's ``mu`` after the first update at ``acc`` 1)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax
    from ctts_tpu.models.comp_trans_tts import CompTransTTS
    from ctts_tpu.models.loss import compute_loss
    from ctts_tpu.utils.optimizer import build_optimizer
    from ctts_torch.utils.weights import (jax_tree_from_state_dict,
                                          state_dict_from_jax)
    pre, mc, tr = W.configs(case, acc=acc)
    jm = CompTransTTS(pre, mc, tr)
    tree = jax_tree_from_state_dict(W.build_model(case).state_dict(), mc)
    tx, _ = build_optimizer(mc, tr)
    b = W.global_batch(case)
    batch = {k: ({pk: jnp.asarray(pv) for pk, pv in v.items()}
                 if isinstance(v, dict) else
                 (None if v is None else jnp.asarray(v)))
             for k, v in b.items()}
    mode = W.mode_of(case)

    def run(params, stats, opt_state, step):
        def loss_fn(p):
            out, mutated = jm.apply(
                {"params": p, "batch_stats": stats}, step=step,
                deterministic=False, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)},
                speakers=batch["speakers"], texts=batch["texts"],
                src_lens=batch["src_lens"], mode=mode, mels=batch["mels"],
                mel_lens=batch["mel_lens"], pitch_targets=batch["pitch_data"],
                energy_targets=batch["energies"],
                duration_targets=batch["durations"],
                attn_priors=batch["attn_priors"])
            total, comps = compute_loss(batch, out, step, pre, mc, tr)
            return total, (comps, mutated["batch_stats"])
        (_, (comps, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        norm = optax.global_norm(grads)
        comps["grad_norm"] = norm
        clip = tr["optimizer"]["grad_clip_thresh"]
        b1 = tr["optimizer"]["betas"][0]
        scale = (1 - b1) * jnp.where(norm < clip, 1.0, clip / norm)
        mu = jax.tree_util.tree_map(lambda g: g * scale, grads)
        return (comps, optax.apply_updates(params, updates), stats,
                opt_state, mu)

    orig = nn.Dropout.__call__
    nn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
    try:
        run = jax.jit(run)
        params, stats = tree["params"], tree["batch_stats"]
        opt_state = tx.init(params)
        losses, mus = [], []
        for i in range(steps):
            comps, params, stats, opt_state, mu = run(
                params, stats, opt_state,
                jnp.asarray(W.STEP0 + 1 + i, jnp.int32))
            losses.append({k: float(v) for k, v in comps.items()})
            mus.append(mu)
    finally:
        nn.Dropout.__call__ = orig
    mu = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": mus[0], "batch_stats": tree["batch_stats"]}))
    return losses, mu


# ---- training on the grid ------------------------------------------------- #

@pytest.mark.parametrize("grid", ["2x1", "1x2", "2x2"])
def test_fs2_train_unsup_on_grid_matches_jax_and_one_process(grid_runs,
                                                              grid):
    """transformer_fs2 ``train_unsup``, two steps on the global batch of 8:
    every loss component within rtol 5e-4 of the JAX package's
    single-device step, the whole parameters (the postnet's running
    statistics included) within 1e-5 of the port's one-process step, and
    the first update's gradients leaf by leaf (``_assert_grads``) within
    ``GRAD_RTOL`` of one process's and of the JAX package's."""
    res = grid_runs.result(f"fs2_{grid}")
    want_jax, mu_jax = _jax_steps("transformer_fs2")
    got = [{k: v for k, v in r.items() if k in want_jax[0]}
           for r in res["losses"]]
    _assert_losses(got, want_jax, rtol=5e-4)
    losses, params, mu = _one_process("transformer_fs2")
    _assert_losses(res["losses"], losses, rtol=5e-4)
    _assert_params(res["params"], params)
    _assert_grads(res["mu"], mu, GRAD_RTOL)
    _assert_grads(res["mu"], {k: mu_jax[k] for k in mu}, GRAD_RTOL)
    assert bool(res["specs"]) == grid.endswith("x2")


@pytest.mark.parametrize("block", OTHER_BLOCKS)
def test_block_tensor_parallel_matches_one_process(grid_runs, block):
    """Each other block at (1, 2): the heads and FFN channels split over two
    ranks, the losses within rtol 5e-4 of one process over two steps and
    the parameters within 1e-5."""
    res = grid_runs.result(f"{block}_1x2")
    losses, params, mu = _one_process(block)
    _assert_losses(res["losses"], losses, rtol=5e-4)
    _assert_params(res["params"], params)
    _assert_grads(res["mu"], mu, GRAD_RTOL)
    assert res["specs"]


@pytest.mark.parametrize("case", ["du2021", "liu2021"])
def test_prosody_data_parallel_pools_batch_statistics(grid_runs, case):
    """du2021 and liu2021 ``train_sup`` at (2, 1), the prosody gate open:
    each rank holds 4 of the 8 utterances, and the BatchNorms' batch
    statistics (the postnet's and the prosody models') are the global
    batch's, so the losses and the running statistics after two steps are
    one process's."""
    res = grid_runs.result(f"{case}_2x1")
    losses, params, mu = _one_process(case)
    _assert_losses(res["losses"], losses, rtol=5e-4)
    assert res["losses"][0]["prosody"] != 0.0
    _assert_params(res["params"], params)
    _assert_grads(res["mu"], mu, GRAD_RTOL)
    stats = [k for k in params if k.endswith("running_var")]
    assert any("prosody" in k for k in stats)


@pytest.mark.parametrize("block", W.BLOCKS)
def test_tensor_parallel_with_dropout_matches_one_process(grid_runs, block):
    """Every block at (1, 2) with dropout on: model-group peers draw one
    stream, a dropout on sharded channels or heads draws the whole axis's
    mask and keeps the rank's slice, and the relpos hash is keyed by the
    global head, so two steps give one process's losses, parameters and
    first-update gradients with the same seed, and the two ranks' own
    gradients of every replicated parameter are bit-identical before the
    optimizer's collectives (a peer's mask drawn apart would change
    them)."""
    res = grid_runs.result(f"{block}_dropout_1x2")
    losses, params, mu = _one_process(block, dropout=True)
    _assert_losses(res["losses"], losses, rtol=5e-4)
    _assert_params(res["params"], params)
    _assert_grads(res["mu"], mu, GRAD_RTOL)
    _assert_peer_grads_identical(
        [res, grid_runs.result(f"{block}_dropout_1x2", 1)])


def _assert_peer_grads_identical(peers):
    """The gradients that model-group peers gave their optimizers at each
    update, before any collective: every replicated parameter's (the
    partial ones aside) bit-identical."""
    specs = set(peers[0]["specs"])
    names, partial = peers[0]["names"], set(peers[0]["partial"])
    for step, grads in enumerate(peers[0]["raw"]):
        for i, k in enumerate(names):
            if k in specs or k in partial:
                continue
            for peer in peers[1:]:
                assert torch.equal(peer["raw"][step][i], grads[i]), (k, step)


def test_dropout_keeps_replicated_parameters_identical(grid_runs):
    """With dropout on, three steps at (2, 2): every parameter that is not
    sharded is bit-identical on all four ranks (model-group peers draw the
    same masks on replicated activations, and the data group sums the same
    gradients), as are the peers' own gradients of them at each update
    before the optimizer's collectives; the sharded ones are identical
    across the data axis, and the losses are finite."""
    res = [grid_runs.result("dropout_2x2", r) for r in range(4)]
    _assert_peer_grads_identical(res[:2])
    _assert_peer_grads_identical(res[2:])
    specs = set(res[0]["specs"])
    assert specs
    for r in range(4):
        assert all(np.isfinite(v) for step in res[r]["losses"]
                   for v in step.values())
    for k, v in res[0]["local"].items():
        if k in specs:
            assert torch.equal(res[2]["local"][k], v), k
            assert torch.equal(res[3]["local"][k], res[1]["local"][k]), k
        else:
            for r in (1, 2, 3):
                assert torch.equal(res[r]["local"][k], v), (k, r)


@pytest.mark.parametrize("grid", ["2x1", "1x2"])
def test_accumulating_calls_return_the_global_gradient_norm(grid_runs, grid):
    """``grad_acc_step: 2`` over four calls (two updates): every call's
    ``grad_norm`` is one process's on the global batch within 1e-5
    relative, and the JAX step's ``optax.global_norm`` of its
    micro-gradient (under ``optax.MultiSteps``) within 1e-5 too; the
    losses and the parameters after the updates are one process's as in
    the other grid cases."""
    res = grid_runs.result(f"fs2_acc_{grid}")
    losses, params, _ = _one_process("transformer_fs2", steps=ACC_CALLS,
                                     acc=2)
    want_jax, _ = _jax_steps("transformer_fs2", steps=ACC_CALLS, acc=2)
    got = [r["grad_norm"] for r in res["losses"]]
    np.testing.assert_allclose(got, [r["grad_norm"] for r in losses],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, [r["grad_norm"] for r in want_jax],
                               rtol=1e-5, atol=0)
    _assert_losses(res["losses"], losses, rtol=5e-4)
    _assert_params(res["params"], params)


@pytest.mark.parametrize("case", STREAM_BLOCKS)
def test_streaming_loader_on_the_data_axis_matches_one_process(grid_runs,
                                                               case):
    """The device cache off at (2, 1): each rank's rows come as the
    streaming loader collates them, at their own lengths, and are padded
    to the step's largest over the data group (one all-reduce of two
    integers on the loader's gloo group). So the means over padded entries
    (the CWT spectrogram loss, the masked mel means) and the reformer's
    rotations, drawn at the padded length, are one process's: its losses
    within 1e-5 and its first update's gradients within 1e-3 of each
    leaf's scale."""
    res = grid_runs.result(f"{case}_stream_2x1")
    losses, params, mu = _one_process(case, stream=True)
    _assert_losses(res["losses"], losses, rtol=1e-5)
    _assert_grads(res["mu"], mu, 1e-3)
    _assert_params(res["params"], params)


def test_step_lengths_without_a_group_are_the_rows_own():
    """One data rank: no gloo twin is made and the lengths stay as the
    loader bucketed them."""
    from ctts_torch.parallel.mesh import Grid, host_data_group, step_lengths
    assert host_data_group(None) is None
    assert host_data_group(Grid(1, 2, 0, 1)) is None
    assert step_lengths((32, 384), None) == (32, 384)


# ---- inference and checkpoints ------------------------------------------- #

@pytest.mark.parametrize("grid", ["2x1", "1x2"])
def test_sharded_inference_matches_one_process(grid_runs, grid):
    """The infer forward on the grid: each data rank's rows give one
    process's ``mel_lens`` exactly and its mels within 5e-4."""
    d = int(grid[0])
    model = W.build_model("transformer_fs2")
    want = W.infer(model, W.global_batch("transformer_fs2"))
    rows = W.B // d
    for r in range(d * int(grid[2])):
        got = grid_runs.result(f"infer_{grid}", r)
        dr = r // int(grid[2])
        sl = slice(dr * rows, (dr + 1) * rows)
        assert torch.equal(got["mel_lens"], want["mel_lens"][sl])
        T = got["mel"].shape[1]
        np.testing.assert_allclose(got["mel"].numpy(),
                                   want["mel"][sl, :T].numpy(), atol=5e-4)


def test_checkpoints_restore_across_grids(grid_runs):
    """A checkpoint written at (1, 2) holds whole tensors and restores in
    one process; one written in one process restores at (2, 1). Each
    resumed run's steps 3-4 give the straight run's losses within 1e-5."""
    from ctts_torch.utils.checkpoint import load_checkpoint, restore_checkpoint
    straight = grid_runs.straight
    grid_runs.result("save_1x2")
    saved = load_checkpoint(grid_runs.ckpt_tp, CKPT_STEP)
    whole = W.build_model("transformer_fs2").state_dict()
    assert {k: v.shape for k, v in saved["model"].items()} == \
        {k: v.shape for k, v in whole.items()}
    state = W.train_state("transformer_fs2")
    restore_checkpoint(grid_runs.ckpt_tp, state, CKPT_STEP)
    assert state.step == CKPT_STEP
    resumed = W.run_steps("transformer_fs2", state,
                          W.global_batch("transformer_fs2"), 2)
    _assert_losses(resumed, straight[2:], rtol=1e-5)
    _assert_losses(grid_runs.result("resume_2x1")["losses"], straight[2:],
                   rtol=1e-5)


def test_resume_on_the_data_axis_keeps_each_ranks_dropout_stream(grid_runs):
    """With dropout on at (2, 1), a run resumed from the step-2 checkpoint
    takes the straight run's steps 3-4 (each data rank's stream is saved
    and restored, so data rank 1 draws the masks it drew straight)."""
    straight = grid_runs.result("dropout_save_2x1")["losses"]
    resumed = grid_runs.result("dropout_resume_2x1")["losses"]
    _assert_losses(resumed, straight[2:], rtol=1e-5)


def test_checkpoint_halfway_through_an_update_restores_across_grids(
        grid_runs):
    """``grad_acc_step: 2`` at (2, 2), saved after the third call, with one
    micro-gradient of the second update accumulated: the checkpoint holds
    the whole accumulator (the data group's mean micro-gradient, which
    every data rank holds). Resumed in one process, at (2, 1) and at
    (1, 2), the fourth call completes the update the straight run makes
    and the fifth takes its loss: the losses within 1e-5, and the first
    moments after the update within ``GRAD_RTOL`` of each leaf's scale (a
    wrong accumulator moves them by a share of a micro-gradient, where the
    losses at the schedule's first rates move by less than their
    tolerance)."""
    from ctts_torch.utils.checkpoint import load_checkpoint, restore_checkpoint
    straight = grid_runs.result("acc_save_2x2")
    want = straight["losses"][ACC_SAVE_CALLS:]
    saved = load_checkpoint(grid_runs.ckpt_acc, W.STEP0 + ACC_SAVE_CALLS)
    assert saved["optimizer"]["mini_step"] == 1
    state = W.train_state("transformer_fs2", acc=2)
    restore_checkpoint(grid_runs.ckpt_acc, state)
    resumed = W.run_varied("transformer_fs2", state, None, 2)
    _assert_losses(resumed, want, rtol=1e-5)
    _assert_grads(W.whole_mu(state), straight["mu"], GRAD_RTOL)
    for grid in ("2x1", "1x2"):
        res = grid_runs.result(f"acc_resume_{grid}")
        _assert_losses(res["losses"], want, rtol=1e-5)
        _assert_grads(res["mu"], straight["mu"], GRAD_RTOL)


# ---- the grid's rules ------------------------------------------------------ #

def test_coverage_guard_and_divisibility_warning():
    """``model > 1`` with no parameter under a rule raises, ``model: 1``
    never does; fs2's 2 heads over 4 ranks replicate the attention with the
    JAX package's warning while its 128 FFN channels still shard."""
    from ctts_torch.parallel.mesh import check_tp_coverage, param_specs
    plain = torch.nn.Sequential(torch.nn.Linear(8, 8))
    with pytest.raises(ValueError, match="tensor-parallel"):
        check_tp_coverage(plain, 2, "nothing_matches")
    assert check_tp_coverage(plain, 1) == 0
    model = W.build_model("transformer_fs2")
    with pytest.warns(UserWarning, match="not divisible"):
        hits = check_tp_coverage(model, 4, "transformer_fs2")
    specs = param_specs(model, 4)
    assert hits == len(specs) > 0
    assert all(".ffn." in k for k in specs)


def test_mesh_must_cover_the_world():
    """``train.mesh`` whose product is not the world size raises."""
    from ctts_torch.parallel.mesh import make_mesh
    assert (make_mesh().data, make_mesh().model) == (1, 1)
    with pytest.raises(ValueError, match="world size"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="world size"):
        make_mesh(1, 2)


@pytest.mark.parametrize("case", W.BLOCKS)
def test_shard_model_slices_what_the_rules_name(case):
    """On one process (no group: slicing only), ``shard_model_`` at
    ``model: 2`` cuts exactly the entries ``param_specs`` names, each on its
    axis to half, rank 0 and rank 1 together giving back every entry."""
    from ctts_torch.parallel.mesh import Grid, shard_model_
    from ctts_torch.utils.weights import unshard_state_dict
    whole = W.build_model(case).state_dict()
    parts = []
    for r in range(2):
        model = W.build_model(case)
        specs = shard_model_(model, Grid(1, 2, 0, r))
        parts.append(model.state_dict())
        for k, v in whole.items():
            got = parts[-1][k].shape
            if k in specs:
                want = list(v.shape)
                want[specs[k].axis] //= 2
                assert list(got) == want, k
            else:
                assert got == v.shape, k
    back = unshard_state_dict(parts, specs)
    for k, v in whole.items():
        assert torch.equal(back[k], v), k


def _labelled_jax_tree(case, model_axis, heads):
    """The JAX variables of ``case`` with every leaf filled with labels:
    1 + the rank that holds each entry under ``ctts_tpu``'s ``param_spec``
    on a (8 / model_axis, model_axis) mesh, -1 for replicated leaves."""
    import jax
    from ctts_tpu.parallel.mesh import make_mesh, param_spec
    shapes = _jax_shapes(case, heads)
    mesh = make_mesh(data=8 // model_axis, model=model_axis)

    def label(path, leaf):
        spec = param_spec(path, leaf, mesh)
        out = np.full(leaf.shape, -1.0, np.float32)
        for axis, name in enumerate(spec):
            if name == "model":
                n = leaf.shape[axis]
                idx = np.arange(n) // (n // model_axis) + 1
                shape = [1] * leaf.ndim
                shape[axis] = n
                out = np.broadcast_to(idx.reshape(shape).astype(np.float32),
                                      leaf.shape).copy()
        return out
    return jax.tree_util.tree_map_with_path(label, shapes)


@functools.lru_cache(maxsize=None)
def _jax_shapes(case, heads):
    import jax
    import jax.numpy as jnp
    from ctts_tpu.models.comp_trans_tts import CompTransTTS
    pre, mc, tr = W.configs(case, heads)
    jm = CompTransTTS(pre, mc, tr)
    b = W.global_batch(case)
    j = {k: ({pk: jnp.asarray(pv[:2]) for pk, pv in v.items()}
             if isinstance(v, dict) else
             (None if v is None else jnp.asarray(v[:2])))
         for k, v in b.items()}
    return jax.eval_shape(lambda rng: jm.init(
        {"params": rng}, speakers=j["speakers"], texts=j["texts"],
        src_lens=j["src_lens"], mode=W.mode_of(case), mels=j["mels"],
        mel_lens=j["mel_lens"], pitch_targets=j["pitch_data"],
        energy_targets=j["energies"], duration_targets=j["durations"],
        attn_priors=j["attn_priors"], step=jnp.zeros((), jnp.int32),
        deterministic=True), jax.random.PRNGKey(0))


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("case", W.BLOCKS + ("du2021", "liu2021"))
def test_rules_shard_what_the_jax_rules_shard(case, model_axis):
    """The port's ``param_spec`` rules against ``ctts_tpu``'s, through the
    weight bridge: each JAX leaf is filled with the (1-based) rank that
    holds each entry, carried to the port's names and layouts, and cut by
    the port's specs. Every slice the port gives rank r holds r's entries
    alone, and every entry JAX replicates is replicated here; only the
    biases of column-parallel layers, which JAX replicates and GSPMD
    reshards, are sliced by the port alone. At ``model: 4`` fs2's and the
    classic transformer's 2 heads replicate on both sides (the JAX head
    axis does not split); the reformer and the lstransformer run 4 heads
    there, since the port keeps whole heads on a rank where JAX would cut a
    head's flat channels. The prosody models' parameters shard on
    neither."""
    from ctts_torch.parallel.mesh import param_specs
    from ctts_torch.parallel.tensor_parallel import shard_tensor
    from ctts_torch.utils.weights import state_dict_from_jax
    heads = 4 if model_axis == 4 and case in ("reformer",
                                              "lstransformer") else 2
    labels = state_dict_from_jax(_labelled_jax_tree(case, model_axis, heads))
    specs = param_specs(W.build_model(case, heads=heads), model_axis)
    sharded_by_jax = {k for k, v in labels.items() if (v > 0).any()}
    assert sharded_by_jax, "the JAX rules shard nothing"
    for k, v in labels.items():
        spec = specs.get(k)
        if spec is None:
            assert not (v > 0).any(), f"{k}: JAX shards it, the port not"
            continue
        if not (v > 0).any():
            assert k.endswith(".bias"), f"{k}: the port shards it, JAX not"
            continue
        for r in range(model_axis):
            part = shard_tensor(v, spec.axis, r, model_axis, spec.groups)
            assert (part == r + 1).all(), (k, r)
    prosody = [k for k in specs if "prosody" in k]
    assert not prosody


# ---- the train CLI ----------------------------------------------------------- #

def _cli_config(tmp_path, store, name, cache_mb):
    """A merged config directory for the train CLI on ``store`` at
    ``train.mesh`` data 2 (batch 2 a rank, 3 steps, a checkpoint at step 2
    and at the end); returns (its directory, the train config)."""
    from ctts_torch.config import dump_yaml, load_yaml
    from ctts_torch.utils.testing import tiny_configs
    out = str(tmp_path / name)
    pre, mc, tr = tiny_configs()
    pre["path"]["preprocessed_path"] = store
    tr["path"] = {k: os.path.join(out, k) for k in
                  ("ckpt_path", "log_path", "result_path")}
    tr["optimizer"]["batch_size"] = 2
    tr["on_device_prior"] = True
    tr["device_cache_mb"] = cache_mb
    tr["mesh"] = {"data": 2, "model": 1}
    tr["step"].update(total_step=3, log_step=1, val_step=1000, save_step=2,
                      synth_step=1000)
    mc.pop("_energy_stats")
    raw = load_yaml(open(os.path.join(REPO, "configs", "LJSpeech.yaml")))
    pre.pop("dataset", None)
    for section, cfg in (("preprocess", pre), ("model", mc), ("train", tr)):
        raw[section] = cfg
    raw["preprocess"]["preprocessing"]["pitch"].pop("cwt_scales", None)
    cfg_dir = str(tmp_path / f"{name}_cfg")
    os.makedirs(cfg_dir)
    with open(os.path.join(cfg_dir, "LJSpeech.yaml"), "w") as f:
        f.write(dump_yaml(raw))
    return cfg_dir, tr


def _start_cli_ranks(cfg_dir):
    port = _free_port()
    no_tb = "import sys; sys.modules['torch.utils.tensorboard'] = None; "
    procs = []
    for pid in range(2):
        argv = ["ctts_torch.train", "--dataset", "LJSpeech", "--config_dir",
                cfg_dir, "--device", "cpu", "--coordinator",
                f"127.0.0.1:{port}", "--num_processes", "2",
                "--process_id", str(pid)]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", no_tb + f"sys.argv = {argv!r}; "
             "import runpy; runpy.run_module('ctts_torch.train', "
             "run_name='__main__', alter_sys=True)"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=_env()))
    return procs


def _finish(procs):
    """Each rank's output; fails unless every rank exits 0 in time."""
    deadline = time.time() + TIMEOUT
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(deadline - time.time(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the ranks did not finish")
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return outs


def _logged(tr):
    return [json.loads(ln) for ln in open(os.path.join(
        tr["path"]["log_path"], "train", "log.jsonl"))]


def test_train_cli_two_gloo_ranks(tmp_path):
    """``python -m ctts_torch.train --coordinator ... --device cpu`` on two
    processes with ``train.mesh`` data 2, the device cache on: both ranks
    take 3 steps; rank 0 alone writes the log lines (one a step, the
    global batch's losses) and the checkpoints, which hold whole tensors."""
    from test_train_e2e import make_fake_store
    store = str(tmp_path / "store")
    make_fake_store(store, n_utts=10)
    cfg_dir, tr = _cli_config(tmp_path, store, "run", 64)
    outs = _finish(_start_cli_ranks(cfg_dir))
    assert "grid data 2 × model 1, global batch 4" in outs[0]
    assert "device cache:" in outs[0]
    assert "step 1:" in outs[0] and "step" not in outs[1]
    lines = _logged(tr)
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(r["total"]) for r in lines)
    assert sorted(os.listdir(tr["path"]["ckpt_path"])) == ["2.pth.tar",
                                                          "3.pth.tar"]


def _lengthen(store, every=2, reps=4):
    """Every ``every``-th utterance of a ``make_fake_store`` store made
    ``reps`` times as long (each per-frame array tiled along its frames),
    so its 30-59 frames cross the loader's 128-frame bucket."""
    import glob
    names = [ln.split("|")[0] for ln in
             open(os.path.join(store, "train_unsup.txt")).read().split()][
        ::every]
    for name in names:
        for path in glob.glob(os.path.join(store, "*", f"*-{name}.npy")):
            a = np.load(path)
            if "f0cwt_mean_std" in path:
                continue
            axis = 1 if "attn_prior" in path else 0
            np.save(path, np.concatenate([a] * reps, axis=axis))


def test_train_cli_two_gloo_ranks_streaming(tmp_path):
    """The train CLI on two gloo ranks at ``train.mesh`` (2, 1) with the
    device cache off, on a store whose utterances fall in two frame
    buckets: each rank streams its shard and pads it to the step's largest
    lengths (an all-reduce of two integers on the prefetch thread). The
    run crosses an epoch and ends inside the next, where a prefetch thread
    that read ahead would wait on a collective its peer never makes: both
    ranks exit within the timeout, and the logged losses of every step are
    those of the same run with the device cache on (which gives every rank
    the step's longest shard, the padding one process has) within 1e-5."""
    from test_train_e2e import make_fake_store
    store = str(tmp_path / "store")
    make_fake_store(store, n_utts=10)
    _lengthen(store)
    runs = [_cli_config(tmp_path, store, name, mb)
            for name, mb in (("cached", 64), ("streamed", 0))]
    procs = [_start_cli_ranks(cfg_dir) for cfg_dir, _ in runs]
    outs = [_finish(p) for p in procs]
    assert "device cache:" in outs[0][0]
    assert "streaming loader read" in outs[1][0]
    assert "device cache" not in outs[1][0]
    want, got = (_logged(tr) for _, tr in runs)
    assert [r["step"] for r in got] == [1, 2, 3]
    timing = ("step", "lr", "s_per_step", "launches_per_step")
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w.keys() - set(timing):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
