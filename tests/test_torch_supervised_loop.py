"""The supervised (``train_sup``) training loop of ctts_torch on the CPU: the
``sup`` store's batches and device cache against the JAX package's (bit for
bit), ``ctts_torch.train.train`` with the device cache, validation through
``make_eval_step``, save and a bit-exact resume, and
``python -m ctts_torch.synthesize`` on the checkpoint it wrote. The store is
synthetic (``tests/test_train_e2e.py:make_fake_store(sup=True)``: durations
summing to each mel length, ``mel2ph``, phone-level energy); the model is
``tiny_configs()`` (fs2, one layer, width 32) with ``learn_alignment:
False`` and dropout on."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_train_e2e import make_fake_store

N_UTTS = 10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads_no_tensorboard():
    # torch.utils.tensorboard imports TensorFlow where it is installed (tens
    # of seconds); the loop's logger then writes JSON lines only
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
    root = str(tmp_path_factory.mktemp("sup_store"))
    make_fake_store(root, n_utts=N_UTTS, sup=True)
    return root


def _configs(store, out):
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["duration_modeling"]["learn_alignment"] = False
    pre["path"]["preprocessed_path"] = store
    pre["path"]["lexicon_path"] = os.path.join(store, "no_lexicon.txt")
    tr["path"] = {k: os.path.join(out, k) for k in
                  ("ckpt_path", "log_path", "result_path")}
    tr["optimizer"]["batch_size"] = 3
    tr["device_cache_mb"] = 64
    tr["step"].update(total_step=4, log_step=1, val_step=2, save_step=2,
                      var_start_steps=0)
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


def test_sup_batches_and_cache_equal_jax(store, tmp_path):
    """The ``sup`` store: the shuffled batches (durations, mel2ph,
    phone-level energies) equal the JAX Dataset's bit for bit, and the
    device cache's gathered batches equal ``collate()``'s."""
    from ctts_tpu.data.dataset import Dataset as JDataset
    from ctts_torch.data.dataset import Dataset
    from ctts_torch.data.device_cache import DeviceCache, gather_batch
    pre, mc, tr = _configs(store, str(tmp_path))
    ds = Dataset("train_sup.txt", pre, mc, tr, sort=True, drop_last=True)
    jds = JDataset("train_sup.txt", pre, mc, tr, sort=True, drop_last=True)
    got, want = list(ds.batches(seed=3)), list(jds.batches(seed=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        assert g["energies"].shape == g["texts"].shape
        assert (g["durations"].sum(1) == g["mel_lens"]).all()
    cache = DeviceCache(ds, "float32")
    cache.put("cpu")
    for idx, t_s, t_m in cache.index_batches(seed=3):
        batch = gather_batch(cache.arrays, torch.from_numpy(idx), t_s, t_m,
                             True)
        want_b = ds.collate([ds[int(i)] for i in idx])
        del want_b["ids"], want_b["raw_texts"]
        _assert_batches_equal(batch, want_b)


@pytest.fixture(scope="module")
def runs(store, tmp_path_factory):
    """4 uninterrupted ``train_sup`` steps (validating and saving at 2 and
    4) and a run restored from the step-2 checkpoint for steps 3-4."""
    from ctts_torch.train import train
    straight = _configs(store, str(tmp_path_factory.mktemp("straight")))
    state_a = train(copy.deepcopy(straight), max_steps=4, device="cpu")
    resumed = _configs(store, str(tmp_path_factory.mktemp("resumed")))
    resumed[2]["path"]["ckpt_path"] = straight[2]["path"]["ckpt_path"]
    state_b = train(copy.deepcopy(resumed), restore_step=2, max_steps=4,
                    device="cpu")
    return {"straight": (state_a, straight), "resumed": (state_b, resumed)}


def _log(configs, split):
    path = os.path.join(configs[2]["path"]["log_path"], split, "log.jsonl")
    return {r["step"]: r for r in map(json.loads, open(path))}


def test_train_sup_resume_is_bit_exact_and_validates(runs):
    """Parameters, Adam moments and the step after 2+2 steps equal the
    4-step run's bit for bit; the loss lines of steps 3-4 agree; every log
    line is finite with ``ctc`` and ``bin`` zero and the variance terms
    on; validation wrote its means at steps 2 and 4."""
    a, ca = runs["straight"]
    b, cb = runs["resumed"]
    assert a.step == b.step == 4
    for (k, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                    b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    la, lb = _log(ca, "train"), _log(cb, "train")
    assert sorted(la) == [1, 2, 3, 4] and sorted(lb) == [3, 4]
    assert {s: lb[s]["total"] for s in (3, 4)} == \
        {s: la[s]["total"] for s in (3, 4)}
    for r in la.values():
        assert all(np.isfinite(r[k]) for k in ("total", "mel", "pdur",
                                               "pitch_C", "energy"))
        assert r["ctc"] == 0 and r["bin"] == 0 and r["pdur"] > 0
    val = _log(ca, "val")
    assert sorted(val) == [2, 4]
    assert all(np.isfinite(r["total"]) and r["ctc"] == 0
               for r in val.values())


def test_synthesize_cli_runs_the_sup_checkpoint(runs, tmp_path):
    """``python -m ctts_torch.synthesize --restore_step 4`` with a merged
    config of the supervised run: a wav and a finite mel."""
    from ctts_torch.config import dump_yaml, load_yaml
    from ctts_torch.synthesize import main
    _, configs = runs["straight"]
    raw = load_yaml(open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "LJSpeech.yaml")))
    pre, mc, tr = copy.deepcopy(configs)
    pre.pop("dataset", None)
    pre["preprocessing"]["pitch"].pop("cwt_scales", None)
    raw.update(preprocess=pre, model=mc, train=tr)
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "LJSpeech.yaml").write_text(dump_yaml(raw))
    out = tmp_path / "out"
    main(["--mode", "single", "--text", "hello", "--dataset", "LJSpeech",
          "--config_dir", str(cfg_dir), "--restore_step", "4",
          "--vocoder_ckpt", str(tmp_path / "none"), "--device", "cpu",
          "--result_dir", str(out)])
    files = sorted(os.listdir(out))
    assert [f for f in files if f.endswith(".wav")], files
    mel = np.load(out / next(f for f in files if f.endswith(".npy")))
    assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()
