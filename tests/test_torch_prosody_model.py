"""The prosody models through the whole of ctts_torch against the JAX
package, on the CPU: inference, one train step of du2021 ``train_sup``,
liu2021 ``train_sup`` and liu2021 ``train_unsup`` with the prosody term on,
its schedule gate, and the train and synthesize CLIs.

Each configuration is ``tiny_configs()`` (fs2, one encoder and one decoder
layer, width 32, float32; the prosody models at the JAX package's test
sizes) with ``model_type`` set; the JAX model's parameters are drawn with
numpy at ``jax.eval_shape`` shapes and perturbed, and go to the port
through the weight bridge; both sides see one numpy batch. Dropout is off
(``deterministic=True`` / ``eval()``). du2021 samples its prosody at
inference: the port is handed the components and noise JAX drew from its
default key. Tolerances: outputs 1e-4 absolute; loss terms 1e-5 absolute,
or 1e-4 relative above 1; each gradient leaf 1e-4 of its largest entry
(a leaf whose largest entry is under 1e-5: every entry under 2e-5).
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

B, T_S, T_M, BUDGET = 2, 11, 40, 64
ATOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP = 200001                     # past every gate (prosody at 100000)
CASES = {"du2021-train_sup": ("du2021", "train_sup"),
         "liu2021-train_sup": ("liu2021", "train_sup"),
         "liu2021-train_unsup": ("liu2021", "train_unsup")}
PROSODY_KEYS = ("prosody_extractor", "prosody_predictor", "prosody_linear",
                "liu_prosody")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads_no_tensorboard():
    # torch.utils.tensorboard imports TensorFlow where it is installed; the
    # loop's logger then writes JSON lines only
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


def _to_jax(v):
    if isinstance(v, dict):
        return {k: _to_jax(x) for k, x in v.items()}
    return None if v is None else jnp.asarray(v)


def _to_torch(v):
    if isinstance(v, dict):
        return {k: _to_torch(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_to_torch(x) for x in v)
    return None if v is None else torch.from_numpy(np.array(v))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, what):
    if want is None:
        assert got is None, what
        return
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def _loss_close(got, want, what):
    tol = max(LOSS_TOL, 1e-4 * abs(want))
    assert abs(got - want) <= tol, (what, got, want)


class _Case:
    """One prosody model in one mode: the JAX model, the shared tree, the
    port's model from it, and the batch."""

    def __init__(self, model_type, mode):
        from ctts_tpu.models.comp_trans_tts import CompTransTTS as JModel
        from ctts_tpu.utils.testing import tiny_configs
        from ctts_torch.models.comp_trans_tts import CompTransTTS
        from ctts_torch.utils.testing import synth_batch
        from ctts_torch.utils.weights import state_dict_from_jax
        self.mode = mode
        sup = mode == "train_sup"
        self.configs = pre, mc, tr = tiny_configs(
            learn_alignment=not sup, prosody=model_type)
        self.jmodel = JModel(pre, mc, tr)
        self.batch = synth_batch(B=B, T_s=T_S, T_m=T_M, seed=0, sup=sup,
                                 phone_energy=sup)
        jb = _to_jax(self.batch)
        shapes = jax.eval_shape(lambda key: self.jmodel.init(
            {"params": key}, step=jnp.zeros((), jnp.int32),
            deterministic=True, **self.kwargs(jb)), jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.tree = jax.tree_util.tree_map(
            lambda a: self._draw(a, rng), dict(shapes))
        self._fix(self.tree)
        # predicted durations of a few frames, so inference fills part of
        # the budget
        self.tree["params"]["variance_adaptor"]["duration_predictor"][
            "linear"]["bias"] = np.full((1,), 1.4, np.float32)
        self.tmodel = CompTransTTS(pre, mc, tr)
        self.tmodel.load_state_dict(state_dict_from_jax(self.tree),
                                    strict=True)
        self.tmodel.eval()

    @staticmethod
    def _draw(shape, rng):
        fan_in = np.prod(shape.shape[:-1]) if len(shape.shape) > 1 else 1
        return (rng.randn(*shape.shape) / np.sqrt(max(fan_in, 1))
                ).astype(np.float32)

    @staticmethod
    def _fix(tree):
        """Norm scales near 1, variances positive."""
        for k, v in tree.items():
            if isinstance(v, dict):
                _Case._fix(v)
            elif k in ("scale", "pos_embed_alpha"):
                tree[k] = 1.0 + 0.05 * v
            elif k == "var":
                tree[k] = np.abs(v) + 0.5

    def kwargs(self, batch, mode=None):
        mode = mode or self.mode
        kw = dict(speakers=batch["speakers"], texts=batch["texts"],
                  src_lens=batch["src_lens"], mode=mode)
        if mode == "infer":
            return dict(kw, max_mel_len=BUDGET)
        return dict(kw, mels=batch["mels"], mel_lens=batch["mel_lens"],
                    pitch_targets=batch["pitch_data"],
                    energy_targets=batch["energies"],
                    duration_targets=batch["durations"],
                    attn_priors=(batch["attn_priors"]
                                 if mode == "train_unsup" else None))


@pytest.fixture(scope="module")
def cases():
    built = {}

    def get(name):
        if name not in built:
            built[name] = _Case(*CASES[name])
        return built[name]
    return get


@pytest.mark.parametrize("name", ["liu2021-train_sup", "du2021-train_sup"])
def test_infer_matches_jax(cases, name, monkeypatch):
    """``infer`` at a 64-frame budget: mels, durations, mel lengths and the
    prosody info within 1e-4 (integers equal). liu2021 adds its
    predictors' vectors; du2021 draws from its mixture, here the draws JAX
    made from its default key, handed to the port's ``sample``."""
    from ctts_torch.models.prosody import DuProsodyPredictor
    case = cases(name)
    jout = case.jmodel.apply(case.tree, deterministic=True,
                             **case.kwargs(_to_jax(case.batch), "infer"))
    if name.startswith("du2021"):
        w = jout["prosody_info"][0]
        k_rng, n_rng = jax.random.split(jax.random.PRNGKey(0))
        comp = jax.random.categorical(k_rng, jnp.log(jnp.clip(w, 1e-9, None)))
        noise = jax.random.normal(n_rng, jout["prosody_info"][3].shape)
        original = DuProsodyPredictor.sample

        def sample(w, sigma, mu, generator=None, src_mask=None):
            return original(w, sigma, mu, src_mask=src_mask,
                            component=torch.from_numpy(np.array(comp)),
                            noise=torch.from_numpy(np.array(noise)))
        monkeypatch.setattr(DuProsodyPredictor, "sample",
                            staticmethod(sample))
    with torch.no_grad():
        tout = case.tmodel(**case.kwargs(_to_torch(case.batch), "infer"))
    for k in ("mel_predictions", "postnet_mel_predictions",
              "duration_rounded", "mel_lens", "mel2ph"):
        _close(tout[k], jout[k], k)
    for i, (g, w) in enumerate(zip(tout["prosody_info"],
                                   jout["prosody_info"])):
        _close(g, w, f"prosody_info[{i}]")
    lens = tout["mel_lens"].numpy()
    assert (lens > 0).all() and (lens <= BUDGET).all(), lens


def _grad_tree(model, grads, mc):
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    sd = dict(model.state_dict())
    sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
    return jax_tree_from_state_dict(sd, mc)["params"]


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax(cases, name):
    """One train step past the prosody enable step with
    ``deterministic=True`` on both sides: the forward's prosody info within
    1e-4, every loss term within 1e-5 (1e-4 relative above 1), every
    gradient leaf within 1e-4 of its largest entry, the prosody term and the
    prosody modules' gradients non-zero; then the port's whole
    ``make_train_step`` gives the same loss terms."""
    from ctts_tpu.models.loss import compute_loss as j_compute
    from ctts_torch.models.loss import compute_loss
    from ctts_torch.parallel.train_step import (_apply, batch_to_device,
                                                create_train_state,
                                                make_train_step, prep_batch)
    from ctts_torch.utils.optimizer import build_optimizer
    case = cases(name)
    pre, mc, tr = case.configs
    jb = _to_jax(case.batch)

    def loss_fn(params):
        out, _ = case.jmodel.apply(
            {"params": params, "batch_stats": case.tree["batch_stats"]},
            step=jnp.asarray(STEP, jnp.int32), deterministic=True,
            mutable=["batch_stats"], **case.kwargs(jb))
        total, comps = j_compute(jb, out, STEP, pre, mc, tr)
        return total, (comps, out["prosody_info"])

    (_, (want, want_info)), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(case.tree["params"])

    model = copy.deepcopy(case.tmodel)
    tb = batch_to_device(case.batch, "cpu")
    out = _apply(model, prep_batch(tb, pre, case.mode), case.mode, STEP)
    for i, (g, w) in enumerate(zip(out["prosody_info"], want_info)):
        _close(g, w, f"prosody_info[{i}]")
    total, got = compute_loss(tb, out, STEP, pre, mc, tr)
    assert set(got) == set(want)
    for k in want:
        _loss_close(got[k].item(), float(want[k]), k)
    assert got["prosody"].item() > 0
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    assert all(g is not None for g in grads)
    got_g, want_g = _flat(_grad_tree(model, grads, mc)), _flat(want_grads)
    assert got_g.keys() == want_g.keys()
    prosody = 0
    for k, w in want_g.items():
        top = np.abs(w).max()
        if top > 1e-5:
            assert np.abs(got_g[k] - w).max() <= GRAD_TOL * top, k
        else:
            assert np.abs(got_g[k]).max() <= 2e-5, k
        if any(p in k for p in PROSODY_KEYS):
            prosody += 1
            assert np.abs(got_g[k]).max() > 0, k
    assert prosody > 20

    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=STEP - 1)
    metrics = make_train_step(pre, mc, tr, case.mode,
                              deterministic=True)(state, tb)
    for k in want:
        _loss_close(metrics[k].item(), float(want[k]), k)


@pytest.mark.parametrize("name", ["du2021-train_sup", "liu2021-train_sup"])
def test_prosody_term_gated_by_step(cases, name):
    """At step 10 (below ``prosody_loss_enable_steps``) the prosody term is
    exactly 0 on both sides."""
    from ctts_tpu.models.loss import compute_loss as j_compute
    from ctts_torch.models.loss import compute_loss
    from ctts_torch.parallel.train_step import _apply, batch_to_device
    case = cases(name)
    pre, mc, tr = case.configs
    jb = _to_jax(case.batch)
    jout = case.jmodel.apply(case.tree, step=jnp.asarray(10, jnp.int32),
                             deterministic=True, **case.kwargs(jb))
    _, want = j_compute(jb, jout, 10, pre, mc, tr)
    tb = batch_to_device(case.batch, "cpu")
    with torch.no_grad():
        out = _apply(case.tmodel, tb, case.mode, 10)
        _, got = compute_loss(tb, out, 10, pre, mc, tr)
    assert float(want["prosody"]) == 0.0 and got["prosody"].item() == 0.0
    _loss_close(got["total"].item(), float(want["total"]), "total")


@pytest.mark.parametrize("name", ["du2021-train_sup", "liu2021-train_sup"])
def test_eval_step_matches_jax(cases, name):
    """Validation past the enable step: the port's ``make_eval_step`` and
    the JAX package's give the same loss terms, the prosody term exactly 0
    on both sides (it is a training term only)."""
    from ctts_tpu.parallel.train_step import TrainState as JState
    from ctts_tpu.parallel.train_step import make_eval_step as j_make_eval
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_eval_step)
    from ctts_torch.utils.optimizer import build_optimizer
    case = cases(name)
    pre, mc, tr = case.configs
    jstate = JState(step=jnp.asarray(STEP, jnp.int32),
                    params=case.tree["params"],
                    batch_stats=case.tree["batch_stats"], opt_state=None)
    want, _ = j_make_eval(case.jmodel, pre, mc, tr, case.mode)(
        jstate, _to_jax(case.batch))
    model = copy.deepcopy(case.tmodel)
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=STEP)
    got, _ = make_eval_step(pre, mc, tr, case.mode)(
        state, batch_to_device(case.batch, "cpu"))
    assert set(got) == set(want)
    assert float(want["prosody"]) == 0.0 and got["prosody"].item() == 0.0
    for k in want:
        _loss_close(got[k].item(), float(want[k]), k)


def test_du2021_needs_durations(cases):
    """du2021 extracts its targets over the batch's durations: a training
    forward without them raises."""
    from ctts_torch.parallel.train_step import _apply, batch_to_device
    case = cases("du2021-train_sup")
    b = dict(batch_to_device(case.batch, "cpu"), durations=None)
    b["pitch_data"] = {k: v for k, v in b["pitch_data"].items()
                       if k != "mel2ph"}
    with pytest.raises(ValueError, match="durations"):
        _apply(case.tmodel, b, "train_sup", 1)


# ---- the CLIs ------------------------------------------------------------- #

def _write_config(configs, cfg_dir):
    from ctts_torch.config import dump_yaml, load_yaml
    raw = load_yaml(open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "LJSpeech.yaml")))
    pre, mc, tr = copy.deepcopy(configs)
    pre.pop("dataset", None)
    pre["preprocessing"]["pitch"].pop("cwt_scales", None)
    raw.update(preprocess=pre, model=mc, train=tr)
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "LJSpeech.yaml"), "w") as f:
        f.write(dump_yaml(raw))
    return str(cfg_dir)


@pytest.mark.parametrize("model_type", ["du2021", "liu2021"])
def test_train_and_synthesize_cli(model_type, tmp_path):
    """``python -m ctts_torch.train`` on a tiny supervised store for 4
    steps with the prosody term on from step 0, validating and saving at 2
    and 4, and a run resumed at step 2 whose losses of steps 3-4 equal the
    straight run's; the train log's prosody term non-zero, the validation
    log's 0; then
    ``python -m ctts_torch.synthesize`` from the step-4 checkpoint twice:
    finite mels, the same in both runs (du2021 draws from seed 0 at each
    forward)."""
    from test_train_e2e import make_fake_store
    from ctts_torch.synthesize import main as synthesize
    from ctts_torch.train import main as train
    from ctts_torch.utils.testing import tiny_configs
    store = str(tmp_path / "store")
    make_fake_store(store, n_utts=8, sup=True)
    pre, mc, tr = tiny_configs()
    mc["duration_modeling"]["learn_alignment"] = False
    mc["prosody_modeling"]["model_type"] = model_type
    mc.pop("_energy_stats")                 # read from the store's stats
    pre["path"]["preprocessed_path"] = store
    pre["path"]["lexicon_path"] = os.path.join(store, "no_lexicon.txt")
    tr["optimizer"]["batch_size"] = 3
    tr["step"].update(total_step=4, log_step=1, val_step=2, save_step=2,
                      var_start_steps=0)
    tr["prosody"]["prosody_loss_enable_steps"] = 0
    logs = {}
    for run, argv in (("straight", []), ("resumed", ["--restore_step", "2"])):
        cfg = copy.deepcopy((pre, mc, tr))
        cfg[2]["path"] = {k: str(tmp_path / ("straight" if k == "ckpt_path"
                                             else run) / k)
                          for k in ("ckpt_path", "log_path", "result_path")}
        cfg_dir = _write_config(cfg, tmp_path / f"cfg_{run}")
        train(["--dataset", "LJSpeech", "--config_dir", cfg_dir,
               "--device", "cpu"] + argv)
        path = os.path.join(cfg[2]["path"]["log_path"], "train", "log.jsonl")
        logs[run] = {r["step"]: r for r in map(json.loads, open(path))}
    a, b = logs["straight"], logs["resumed"]
    assert sorted(a) == [1, 2, 3, 4] and sorted(b) == [3, 4]
    for s in (3, 4):
        assert b[s]["total"] == a[s]["total"] and \
            b[s]["prosody"] == a[s]["prosody"]
    assert all(np.isfinite(r["total"]) and r["prosody"] > 0
               for r in a.values())
    val = [json.loads(ln) for ln in open(tmp_path / "straight" / "log_path"
                                         / "val" / "log.jsonl")]
    assert val and all(r["prosody"] == 0 for r in val), val

    mels = []
    for i in range(2):
        out = tmp_path / f"out{i}"
        synthesize(["--mode", "single", "--text", "hello", "--dataset",
                    "LJSpeech", "--config_dir", str(tmp_path / "cfg_straight"),
                    "--restore_step", "4", "--vocoder_ckpt",
                    str(tmp_path / "none"), "--device", "cpu",
                    "--result_dir", str(out)])
        files = sorted(os.listdir(out))
        assert [f for f in files if f.endswith(".wav")], files
        mels.append(np.load(out / next(f for f in files
                                       if f.endswith(".npy"))))
    assert mels[0].ndim == 2 and mels[0].shape[1] == 80
    assert np.isfinite(mels[0]).all()
    np.testing.assert_array_equal(mels[0], mels[1])
