"""The training loop of ctts_torch on the CPU: the dataset and the device
cache against the JAX package's (bit for bit), the optimizer's gradient
accumulation and weight decay against optax, save/restore/resume, the
``--restore_step`` path of ``get_model`` and ``python -m ctts_torch.train``
as a subprocess. The store is synthetic, written with numpy
(``tests/test_train_e2e.py:make_fake_store``); the model is the tiny
conformer (1 layer, width 32, 2 heads, dropout on)."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from test_train_e2e import make_fake_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_UTTS = 10


# Where TensorFlow is installed, ``torch.utils.tensorboard`` imports it,
# which takes tens of seconds: these tests block the module, so the loop's
# logger writes no event files (its JSON lines are what they read). The
# subprocess blocks it the same way before it runs the module as ``-m``
# does.
_NO_TB = "import sys; sys.modules['torch.utils.tensorboard'] = None; "


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads_no_tensorboard():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    had = "torch.utils.tensorboard" in sys.modules
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None
    yield
    if had:
        sys.modules["torch.utils.tensorboard"] = saved
    else:
        del sys.modules["torch.utils.tensorboard"]
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    make_fake_store(root, n_utts=N_UTTS)
    return root


def _configs(store, out, on_device_prior=True, cache_mb=64):
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["block_type"] = "conformer"
    mc["conformer"].update(encoder_layer=1, decoder_layer=1, encoder_hidden=32,
                           decoder_hidden=32, encoder_head=2, decoder_head=2)
    pre["path"]["preprocessed_path"] = store
    tr["path"] = {k: os.path.join(out, k) for k in
                  ("ckpt_path", "log_path", "result_path")}
    tr["optimizer"]["batch_size"] = 3
    tr["on_device_prior"] = on_device_prior
    tr["device_cache_mb"] = cache_mb
    tr["step"].update(total_step=4, log_step=1, val_step=1000, save_step=2)
    mc.pop("_energy_stats")           # read from the store's stats.json
    return pre, mc, tr


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_batches_equal(got[k], w)
        elif w is None or isinstance(w, list):
            assert got[k] == w, k
        else:
            g = got[k].cpu().numpy() if torch.is_tensor(got[k]) else got[k]
            assert g.dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, np.asarray(w), k)


@pytest.mark.parametrize("on_device_prior", [False, True])
def test_dataset_batches_equal_jax(store, tmp_path, on_device_prior):
    """Two epochs, shuffled, sharded 2 ways, and the unshuffled validation
    order: ids and every array bit for bit, priors included when the store
    ships them."""
    from ctts_tpu.data.dataset import Dataset as JDataset
    from ctts_torch.data.dataset import Dataset
    pre, mc, tr = _configs(store, str(tmp_path), on_device_prior)
    for kw in (dict(epoch=0, seed=3), dict(epoch=1, seed=3),
               dict(epoch=0, seed=3, num_shards=2, shard=1),
               dict(shuffle=False, group_size=1)):
        ours = Dataset("train_unsup.txt", pre, mc, tr, sort=True,
                       drop_last="group_size" not in kw)
        theirs = JDataset("train_unsup.txt", pre, mc, tr, sort=True,
                          drop_last="group_size" not in kw)
        got, want = list(ours.batches(**kw)), list(theirs.batches(**kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        assert ours.n_batches(**{k: v for k, v in kw.items()
                                 if k in ("group_size", "num_shards",
                                          "shard")}) == len(want)
    later = list(ours.batches(shuffle=False, group_size=1, start=2))
    for g, w in zip(later, want[2:]):
        _assert_batches_equal(g, w)


def test_device_cache_equals_jax_and_collate(store, tmp_path):
    """``index_batches`` gives the JAX cache's (idx, T_s, T_m) stream, and
    ``gather_batch`` on the cached tensors gives ``collate()``'s batch bit
    for bit (float32 transfer)."""
    from ctts_tpu.data.dataset import Dataset as JDataset
    from ctts_tpu.data.device_cache import DeviceCache as JCache
    from ctts_torch.data.dataset import Dataset
    from ctts_torch.data.device_cache import DeviceCache, gather_batch
    pre, mc, tr = _configs(store, str(tmp_path))
    ds = Dataset("train_unsup.txt", pre, mc, tr, sort=True, drop_last=True)
    cache = DeviceCache(ds, "float32")
    cache.put("cpu")
    jcache = JCache(JDataset("train_unsup.txt", pre, mc, tr, sort=True,
                             drop_last=True), "float32")
    assert cache.nbytes == jcache.nbytes
    for epoch in (0, 1):
        got = list(cache.index_batches(epoch=epoch, seed=5))
        want = list(jcache.index_batches(epoch=epoch, seed=5))
        assert len(got) == len(want) == 3
        for (gi, gs, gm), (wi, ws, wm) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert (gs, gm) == (ws, wm)
            batch = gather_batch(cache.arrays, torch.from_numpy(gi), gs, gm,
                                 False)
            want_b = ds.collate([ds[int(i)] for i in gi])
            del want_b["ids"], want_b["raw_texts"]
            _assert_batches_equal(batch, want_b)
    assert [b[0].tolist() for b in cache.index_batches(epoch=1, seed=5,
                                                       start=1)] == \
        [b[0].tolist() for b in got[1:]]


@pytest.mark.parametrize("key,value", [("grad_acc_step", 2),
                                       ("weight_decay", 0.01)])
def test_optimizer_options_match_optax(key, value):
    """Six updates on random gradients (norms on both sides of the clip)
    against the JAX package's optax chain: ``grad_acc_step`` 2 is
    ``optax.MultiSteps`` (mean of two micro-gradients, no move in between),
    ``weight_decay`` is ``optax.adamw``. Parameters ≤ 1e-6 absolute."""
    from ctts_tpu.utils.optimizer import build_optimizer as j_build
    from ctts_torch.config import get_configs_of
    from ctts_torch.utils.optimizer import build_optimizer
    _, mc, tr = copy.deepcopy(get_configs_of("LJSpeech"))
    tr["optimizer"][key] = value
    tr["optimizer"]["warm_up_step"] = 10
    tx, _ = j_build(mc, tr)
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    opt, _ = build_optimizer(module, mc, tr)
    moved = []
    @jax.jit
    def j_step(grads, opt_state, jparams):
        updates, opt_state = tx.update(grads, opt_state, jparams)
        return optax.apply_updates(jparams, updates), opt_state

    for scale in (0.05, 3.0, 0.2, 10.0, 0.5, 0.01):
        grads = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        jparams, opt_state = j_step([jnp.asarray(g) for g in grads],
                                    opt_state, jparams)
        before = [p.detach().clone() for p in module]
        opt.update([torch.from_numpy(g) for g in grads])
        moved.append(any(not torch.equal(a, b) for a, b in zip(before,
                                                               module)))
        for got, want in zip(module, jparams):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-6, rtol=0)
    assert moved == ([False, True] * 3 if key == "grad_acc_step"
                     else [True] * 6)


@pytest.fixture(scope="module")
def resumed(store, tmp_path_factory):
    """4 uninterrupted steps (saving at step 2), and a second run that
    restores that step-2 checkpoint and takes steps 3-4, both through
    ``ctts_torch.train.train`` on the CPU with the device cache and dropout
    on."""
    from ctts_torch.train import train
    straight = _configs(store, str(tmp_path_factory.mktemp("straight")))
    state_a = train(copy.deepcopy(straight), max_steps=4, device="cpu")
    resumed = _configs(store, str(tmp_path_factory.mktemp("resumed")))
    resumed[2]["path"]["ckpt_path"] = straight[2]["path"]["ckpt_path"]
    state_b = train(copy.deepcopy(resumed), restore_step=2, max_steps=4,
                    device="cpu")
    return {"straight": (state_a, straight), "resumed": (state_b, resumed)}


def test_resume_is_bit_exact(resumed):
    """Model (parameters and BatchNorm statistics), Adam moments and count,
    step and generator state after 2+2 steps equal the 4-step run's bit
    for bit; the loss lines of steps 3-4 agree."""
    a, ca = resumed["straight"]
    b, cb = resumed["resumed"]
    assert a.step == b.step == 4 and a.optimizer.count == b.optimizer.count
    for (k, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                    b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())

    def losses(configs):
        path = os.path.join(configs[2]["path"]["log_path"], "train",
                            "log.jsonl")
        return {r["step"]: r["total"] for r in map(json.loads, open(path))}

    la, lb = losses(ca), losses(cb)
    assert sorted(la) == [1, 2, 3, 4] and sorted(lb) == [3, 4]
    assert lb == {s: la[s] for s in (3, 4)}
    assert all(np.isfinite(v) for v in la.values())


def test_get_model_reads_the_port_checkpoint(resumed):
    """``get_model(restore_step=2)`` (the ``--restore_step`` path of the
    synthesize CLI) loads the step-2 checkpoint: its parameters equal the
    saved ones and ``latest_step`` finds step 4."""
    from ctts_torch.utils.checkpoint import latest_step, load_checkpoint
    from ctts_torch.utils.model import get_model
    _, configs = resumed["resumed"]
    ckpt = configs[2]["path"]["ckpt_path"]
    assert latest_step(ckpt) == 4
    model = get_model(2, configs, device="cpu")
    saved = load_checkpoint(ckpt, 2)["model"]
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_train_cli_subprocess(store, tmp_path):
    """``python -m ctts_torch.train --device cpu --max_steps 3`` (run as ``-m``
    runs it, through ``runpy``) with a merged YAML in ``--config_dir`` (the streaming loader, priors read from the
    store): three log lines with finite losses and launch counts, and the
    step-2 and step-3 checkpoints."""
    from ctts_torch.config import dump_yaml, load_yaml
    out = str(tmp_path)
    raw = load_yaml(open(os.path.join(REPO, "configs", "LJSpeech.yaml")))
    pre, mc, tr = _configs(store, out, on_device_prior=False, cache_mb=0)
    pre.pop("dataset", None)
    for section, cfg in (("preprocess", pre), ("model", mc), ("train", tr)):
        raw[section] = cfg
    raw["preprocess"]["preprocessing"]["pitch"].pop("cwt_scales", None)
    cfg_dir = os.path.join(out, "cfg")
    os.makedirs(cfg_dir)
    with open(os.path.join(cfg_dir, "LJSpeech.yaml"), "w") as f:
        f.write(dump_yaml(raw))
    argv = ["ctts_torch.train", "--dataset", "LJSpeech", "--config_dir",
            cfg_dir, "--device", "cpu", "--max_steps", "3"]
    res = subprocess.run(
        [sys.executable, "-c", _NO_TB + f"sys.argv = {argv!r}; import runpy; "
         "runpy.run_module('ctts_torch.train', run_name='__main__', "
         "alter_sys=True)"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "block=conformer" in res.stdout
    lines = [json.loads(ln) for ln in open(os.path.join(
        tr["path"]["log_path"], "train", "log.jsonl"))]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(r["total"]) for r in lines)
    assert lines[0]["launches_per_step"] == {}          # plain versions only
    assert sorted(os.listdir(tr["path"]["ckpt_path"])) == ["2.pth.tar",
                                                           "3.pth.tar"]
