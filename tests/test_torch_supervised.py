"""Supervised training (``train_sup``) and the variance options of ctts_torch
against the JAX package, on the CPU.

Options: ``pitch_type`` cwt, ph and frame (with and without ``pitch_ar``);
phone- and frame-level energy; ``dur_loss`` mse, huber, mog and crf; the
``ssim`` CWT loss; ``ffn_padding`` SAME and LEFT. Each configuration is
``tiny_configs()`` (one encoder and one decoder layer, width 32, float32,
``learn_alignment: False``) with those options; the JAX model's parameters
are drawn with numpy at ``jax.eval_shape`` shapes and perturbed, and go to
the port through the weight bridge; both sides see one numpy batch with
durations that sum to each mel length and the store's ``mel2ph``.
Dropout is off (``deterministic=True`` / ``eval()``) except where a test
says otherwise. Tolerances: the adaptor's outputs 1e-4 absolute (float32
reassociation through two conv stacks; f0 in Hz 1e-4 relative and 1e-3
absolute, as in tests/test_torch_model.py), integer outputs equal; loss
components 1e-5; the CRF's log-likelihood 1e-5 and its tags equal; the
whole step's losses 1e-4 and gradients 1e-3 of each leaf's largest entry.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

B, T_S, T_M, BUDGET = 2, 11, 40, 64
ATOL = 1e-4
LOSS_TOL = 1e-5

# name: (pitch_type, pitch_ar, energy feature, dur_loss, ffn_padding,
# cwt_loss, pitch_loss)
OPTIONS = {
    "cwt-mse": ("cwt", False, "phoneme_level", "mse", "SAME", "l1", "l1"),
    "cwt-ssim": ("cwt", False, "phoneme_level", "mse", "SAME", "ssim", "l1"),
    "ph-mog-left": ("ph", False, "phoneme_level", "mog", "LEFT", "l1", "l1"),
    "frame-crf": ("frame", False, "frame_level", "crf", "SAME", "l1", "l1"),
    "frame-huber": ("frame", False, "frame_level", "huber", "SAME", "l2",
                    "l2"),
    "ar-crf-left": ("frame", True, "frame_level", "crf", "LEFT", "l1", "l1"),
}
# the adaptor does not see cwt_loss
ADAPTOR_OPTIONS = [k for k in OPTIONS if k != "cwt-ssim"]
STEP_OPTIONS = ["cwt-mse", "frame-crf", "ph-mog-left"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs several workers on a few cores: keep torch's intra-op
    # pool small so these tests do not starve the others
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init_like(shapes, rng, path=()):
    """Parameters of the shapes of a JAX init, drawn with numpy: norm
    scales, variances and alphas 1, biases and means 0, embeddings
    N(0, 1/width), kernels N(0, 1/fan_in)."""
    if isinstance(shapes, dict):
        return {k: _init_like(v, rng, path + (k,)) for k, v in shapes.items()}
    shape, name = tuple(shapes.shape), path[-1]
    if name in ("scale", "var", "pos_embed_alpha"):
        return np.ones(shape, np.float32)
    if name in ("bias", "mean"):
        return np.zeros(shape, np.float32)
    fan_in = shape[-1] if name == "embedding" else np.prod(shape[:-1])
    return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)


def _perturb(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if path[-1] == "var":
        return np.abs(a) + 0.5 + 0.1 * rng.rand(*a.shape).astype(np.float32)
    return a + 0.05 * rng.randn(*a.shape).astype(np.float32)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_jax(v):
    if isinstance(v, dict):
        return {k: _to_jax(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_to_jax(x) for x in v)
    return None if v is None else jnp.asarray(v)


def _to_torch(v):
    if isinstance(v, dict):
        return {k: _to_torch(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_to_torch(x) for x in v)
    return None if v is None else torch.from_numpy(np.array(v))


def _to_numpy(v):
    if isinstance(v, dict):
        return {k: _to_numpy(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_to_numpy(x) for x in v)
    return None if v is None else v.numpy()


def _compare(got, want, path="", atol=ATOL):
    """Every entry of ``want`` (a JAX output, nested) against ``got``."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _compare(got[k], want[k], f"{path}.{k}", atol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{path}[{i}]", atol)
    else:
        w = np.asarray(want)
        g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if path.endswith("f0_denorm"):       # Hz, up to ~1500
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4,
                                       err_msg=path)
        elif np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.astype(np.float32), w, atol=atol,
                                       rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _configs(name, dropout=None):
    from ctts_tpu.utils.testing import tiny_configs
    pitch_type, ar, energy, dur_loss, padding, cwt_loss, p_loss = \
        OPTIONS[name]
    pre, mc, tr = tiny_configs(learn_alignment=False, pitch_type=pitch_type,
                               energy_feature=energy)
    pre["preprocessing"]["pitch"]["pitch_ar"] = ar
    mc["variance_predictor"]["ffn_padding"] = padding
    tr["loss"].update(dur_loss=dur_loss, cwt_loss=cwt_loss,
                      pitch_loss=p_loss)
    if dropout is not None:
        mc["variance_predictor"]["dropout"] = dropout
    return pre, mc, tr


class _Case:
    """One option set: the JAX model, the shared perturbed tree, the port's
    model from it, and the batch."""

    def __init__(self, name, dropout=None):
        from ctts_tpu.models.comp_trans_tts import CompTransTTS
        from ctts_torch.models.comp_trans_tts import CompTransTTS as TModel
        from ctts_torch.utils.testing import synth_batch
        from ctts_torch.utils.weights import state_dict_from_jax
        self.name = name
        self.configs = pre, mc, tr = _configs(name, dropout)
        self.jmodel = CompTransTTS(pre, mc, tr)
        self.batch = synth_batch(
            B=B, T_s=T_S, T_m=T_M, seed=0, sup=True,
            phone_energy=OPTIONS[name][2] == "phoneme_level")
        jb = _to_jax(self.batch)
        shapes = jax.eval_shape(lambda rng: self.jmodel.init(
            {"params": rng}, step=jnp.zeros((), jnp.int32),
            deterministic=True, **self.kwargs(jb)), jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.tree = _perturb(_init_like(dict(shapes), rng), rng)
        # predicted durations of a few frames, so inference fills part of
        # the budget
        lin = self.tree["params"]["variance_adaptor"]["duration_predictor"][
            "linear"]
        width = lin["bias"].shape[0]
        if width == 1:
            lin["bias"] = np.full((1,), 1.4, np.float32)
        elif width == 15:
            lin["bias"][5:10] += 1.4                       # the means
        else:
            lin["bias"][3] += 3.0                          # class 3
        self.tmodel = TModel(pre, mc, tr)
        self.tmodel.load_state_dict(state_dict_from_jax(self.tree),
                                    strict=True)
        self.tmodel.eval()

    @staticmethod
    def kwargs(batch, mode="train_sup"):
        return dict(speakers=batch["speakers"], texts=batch["texts"],
                    src_lens=batch["src_lens"], mode=mode,
                    mels=batch["mels"], mel_lens=batch["mel_lens"],
                    pitch_targets=batch["pitch_data"],
                    energy_targets=batch["energies"],
                    duration_targets=batch["durations"])

    def adaptor_inputs(self, seed=1, mel2ph=True):
        rng = np.random.RandomState(seed)
        x = rng.randn(B, T_S, 32).astype(np.float32)
        b = copy.deepcopy(self.batch)
        if not mel2ph:
            del b["pitch_data"]["mel2ph"]
        src_mask = np.arange(T_S)[None] >= b["src_lens"][:, None]
        mel_mask = np.arange(T_M)[None] >= b["mel_lens"][:, None]
        return x, src_mask, mel_mask, b

    def jax_adaptor(self, mode, seed=1, mel2ph=True, deterministic=True):
        x, src_mask, mel_mask, b = self.adaptor_inputs(seed, mel2ph)
        va = self.jmodel.bind(
            self.tree, rngs={"dropout": jax.random.PRNGKey(0)}
        ).variance_adaptor
        train = mode != "infer"
        out = va(jnp.asarray(x), None, jnp.asarray(b["src_lens"]),
                 jnp.asarray(src_mask), mode,
                 mel_len=jnp.asarray(b["mel_lens"]) if train else None,
                 mel_mask=jnp.asarray(mel_mask) if train else None,
                 max_mel_len=T_M if train else BUDGET,
                 pitch_target=_to_jax(b["pitch_data"]) if train else None,
                 energy_target=jnp.asarray(b["energies"]) if train else None,
                 duration_target=(jnp.asarray(b["durations"]) if train
                                  else None),
                 step=jnp.asarray(1, jnp.int32), deterministic=deterministic)
        out = dict(out)
        assert out.pop("prosody_info") is None
        return out

    def torch_adaptor(self, mode, seed=1, mel2ph=True):
        x, src_mask, mel_mask, b = self.adaptor_inputs(seed, mel2ph)
        t = torch.from_numpy
        train = mode != "infer"
        with torch.no_grad():
            return self.tmodel.variance_adaptor(
                t(x), t(src_mask), mode, T_M if train else BUDGET,
                src_len=t(b["src_lens"]),
                mel_len=t(b["mel_lens"]) if train else None,
                mel_mask=t(mel_mask) if train else None,
                pitch_target=_to_torch(b["pitch_data"]) if train else None,
                energy_target=t(b["energies"]) if train else None,
                duration_target=t(b["durations"]) if train else None,
                step=1)


@pytest.fixture(scope="module")
def cases():
    """The option sets' ``_Case``s, each built once for the module."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _Case(name)
        return built[name]
    return get


# ---- ops ---------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["random", "tied"])
def test_crf_matches_jax(kind):
    """Log-likelihood within 1e-5 and Viterbi tags equal at B=3, T=9, K=32
    with ragged masks; "tied" makes every path score the same, so each
    argmax ties and both sides must take the first index."""
    from ctts_tpu.ops import crf as j_crf
    from ctts_torch.ops import crf as t_crf
    Bc, T, K = 3, 9, 32
    rng = np.random.RandomState(3)
    mask = np.arange(T)[None] < np.asarray([9, 5, 1])[:, None]
    if kind == "random":
        em = rng.randn(Bc, T, K).astype(np.float32) * 2
        start, end = (rng.randn(K).astype(np.float32) for _ in range(2))
        trans = rng.randn(K, K).astype(np.float32)
    else:
        em = np.zeros((Bc, T, K), np.float32)
        start = end = np.zeros(K, np.float32)
        trans = np.zeros((K, K), np.float32)
    tags = rng.randint(0, K, (Bc, T)).astype(np.int32)
    args = (start, end, trans)
    want_ll = j_crf.crf_log_likelihood(
        jnp.asarray(em), jnp.asarray(tags), jnp.asarray(mask),
        *map(jnp.asarray, args))
    got_ll = t_crf.crf_log_likelihood(
        torch.from_numpy(em), torch.from_numpy(tags), torch.from_numpy(mask),
        *map(torch.from_numpy, args))
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll),
                               atol=LOSS_TOL, rtol=0)
    want = j_crf.viterbi_decode(jnp.asarray(em), jnp.asarray(mask),
                                *map(jnp.asarray, args))
    got = t_crf.viterbi_decode(torch.from_numpy(em), torch.from_numpy(mask),
                               *map(torch.from_numpy, args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "tied":
        assert not got.any()


@pytest.mark.parametrize("bias", [6.0, 20.0])
def test_ssim_loss_matches_jax(bias):
    """The loss on CWT-shaped maps ([B, T, 10], the window wider than W)
    with a zero target row, within 1e-5."""
    from ctts_tpu.ops.ssim import ssim_loss as j_ssim
    from ctts_torch.ops.ssim import ssim_loss as t_ssim
    rng = np.random.RandomState(4)
    pred = rng.randn(3, T_M, 10).astype(np.float32)
    tgt = rng.randn(3, T_M, 10).astype(np.float32)
    tgt[1, 30:] = 0.0
    want = float(j_ssim(jnp.asarray(pred), jnp.asarray(tgt), bias=bias))
    got = t_ssim(torch.from_numpy(pred), torch.from_numpy(tgt),
                 bias=bias).item()
    assert abs(got - want) <= LOSS_TOL, (got, want)


@pytest.mark.parametrize("kind", ["huber", "mog", "crf"])
def test_duration_loss_kinds_match_jax(kind):
    """Phone, word and sentence terms of each duration head on random
    predictions and durations, within 1e-5."""
    from ctts_tpu.models import loss as j_loss
    from ctts_tpu.text import sil_phonemes_ids
    from ctts_torch.config import get_configs_of
    from ctts_torch.models import loss as t_loss
    _, _, tr = copy.deepcopy(get_configs_of("LJSpeech"))
    tr["loss"]["dur_loss"] = kind
    rng = np.random.RandomState(5)
    width = {"huber": None, "mog": 15, "crf": 32}[kind]
    shape = (B, T_S) if width is None else (B, T_S, width)
    log_dur = (rng.randn(*shape) * 1.5).astype(np.float32)
    dur = rng.randint(0, 9, (B, T_S)).astype(np.float32)
    tokens = rng.randint(1, 300, (B, T_S)).astype(np.int32)
    tokens[:, [3, 7]] = sil_phonemes_ids()[0]
    mask = np.arange(T_S)[None] >= np.asarray([T_S, 8])[:, None]
    crf_ll = rng.randn(B).astype(np.float32) - 20
    want = j_loss.duration_loss(jnp.asarray(log_dur), jnp.asarray(dur),
                                jnp.asarray(tokens), jnp.asarray(mask),
                                tr["loss"], crf_ll=jnp.asarray(crf_ll))
    t = torch.from_numpy
    got = t_loss.duration_loss(t(log_dur), t(dur), t(tokens), t(mask),
                               tr["loss"], crf_ll=t(crf_ll))
    assert set(got) == set(want) == {"pdur", "wdur", "sdur"}
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= LOSS_TOL, k


@pytest.mark.parametrize("pitch_type", ["frame", "ph"])
def test_pitch_loss_kinds_match_jax(pitch_type):
    """The frame (uv BCE, f0 on voiced frames) and ph terms on random
    predictions, l1 and l2, within 1e-5."""
    from ctts_tpu.models import loss as j_loss
    from ctts_torch.config import get_configs_of
    from ctts_torch.models import loss as t_loss
    pre, _, tr = copy.deepcopy(get_configs_of("LJSpeech"))
    pitch_cfg = dict(pre["preprocessing"]["pitch"], pitch_type=pitch_type)
    rng = np.random.RandomState(6)
    src_mask = np.arange(T_S)[None] >= np.asarray([T_S, 8])[:, None]
    mel_mask = np.arange(T_M)[None] >= np.asarray([T_M, 31])[:, None]
    T = T_M if pitch_type == "frame" else T_S
    pred = {"pitch_pred": rng.randn(B, T, 2 if pitch_type == "frame" else 1)
            .astype(np.float32)}
    tgt = {"f0": rng.randn(B, T).astype(np.float32),
           "uv": (rng.rand(B, T_M) < 0.3).astype(np.float32)}
    for kind in ("l1", "l2"):
        tr["loss"]["pitch_loss"] = kind
        want = j_loss.pitch_loss(_to_jax(pred), _to_jax(tgt), pitch_cfg,
                                 tr["loss"], jnp.asarray(src_mask),
                                 jnp.asarray(mel_mask))
        got = t_loss.pitch_loss(_to_torch(pred), _to_torch(tgt), pitch_cfg,
                                tr["loss"], torch.from_numpy(mel_mask),
                                torch.from_numpy(src_mask))
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k].item() - float(want[k])) <= LOSS_TOL, (kind, k)


# ---- the adaptor ---------------------------------------------------------- #

@pytest.mark.parametrize("mode", ["train_sup", "infer"])
@pytest.mark.parametrize("name", ADAPTOR_OPTIONS)
def test_adaptor_matches_jax(cases, name, mode):
    """Every output of the adaptor's dict within 1e-4, the durations,
    mel2ph, the mel lengths and masks equal."""
    case = cases(name)
    want = case.jax_adaptor(mode)
    got = case.torch_adaptor(mode)
    _compare(got, want)
    if mode == "infer":
        lens = got["mel_len"].numpy()
        assert (lens > 0).all() and (lens <= BUDGET).all(), lens


def test_adaptor_mel2ph_from_store_or_from_durations(cases):
    """``train_sup`` takes the batch's mel2ph when it holds one and else
    derives it from the durations: where the two agree, both give the same
    outputs, and without the store's both sides derive the same one."""
    case = cases("ph-mog-left")
    with_store = case.torch_adaptor("train_sup")
    derived = case.torch_adaptor("train_sup", mel2ph=False)
    _compare(derived, _to_numpy(with_store), atol=0)
    _compare(derived, case.jax_adaptor("train_sup", mel2ph=False))


def test_pitch_ar_teacher_forced_matches_jax():
    """With dropout on (its rate 0, so both sides compute alike), the AR
    head runs one GRU over the right-shifted target f0 in place of its
    free-running loop: outputs within 1e-4 of the JAX module's
    ``deterministic=False``, and different from the free run."""
    case = _Case("ar-crf-left", dropout=0.0)
    want = case.jax_adaptor("train_sup", deterministic=False)
    case.tmodel.train()
    got = case.torch_adaptor("train_sup")
    _compare(got, want)
    free = case.jax_adaptor("train_sup")
    assert np.abs(np.asarray(free["pitch_predictions"]["pitch_pred"])
                  - got["pitch_predictions"]["pitch_pred"].numpy()).max() \
        > 1e-3


def test_pitch_ar_hidden_biases_of_r_and_z_stay_zero():
    """flax's GRU cell has no hidden bias on r and z: after Adam steps with
    weight decay, on a deep copy of the model as the card's copy is made,
    the port's ``bias_hh_l0[:2H]`` is still exactly zero while the rest of
    the cell moved."""
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.optimizer import build_optimizer
    case = _Case("ar-crf-left")
    pre, mc, tr = copy.deepcopy(case.configs)
    tr["optimizer"]["weight_decay"] = 0.01
    model = copy.deepcopy(case.tmodel)
    gru = model.variance_adaptor.pitch_predictor.gru
    before = gru.bias_hh_l0.detach().clone()
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt,
                               step=tr["step"]["var_start_steps"])
    step = make_train_step(pre, mc, tr, "train_sup")
    batch = batch_to_device(case.batch, "cpu")
    for _ in range(2):
        step(state, batch)
    H = gru.hidden_size
    assert not gru.bias_hh_l0[:2 * H].any()
    assert (gru.bias_hh_l0[2 * H:] != before[2 * H:]).any()


# ---- the loss -------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(OPTIONS))
def test_model_and_compute_loss_match_jax(cases, name):
    """The whole model's ``train_sup`` forward (mel and postnet outputs
    within 1e-4), then ``compute_loss`` on the JAX model's own outputs:
    every component within 1e-5, with ``ctc`` and ``bin`` zero."""
    from ctts_tpu.models.loss import compute_loss as j_compute
    from ctts_torch.models.loss import compute_loss as t_compute
    from ctts_torch.parallel.train_step import _apply, batch_to_device
    case = cases(name)
    pre, mc, tr = case.configs
    step = tr["step"]["var_start_steps"] + 1
    jb = _to_jax(case.batch)
    jout = case.jmodel.apply(case.tree, step=jnp.asarray(step, jnp.int32),
                             deterministic=True, **case.kwargs(jb))
    with torch.no_grad():
        tout = _apply(case.tmodel, batch_to_device(case.batch, "cpu"),
                      "train_sup", step)
    for k in ("mel_predictions", "postnet_mel_predictions",
              "log_duration_predictions", "mel2ph", "dur_crf_ll"):
        _compare(tout[k], jout[k], k)
    _, want = j_compute(jb, jout, jnp.asarray(step, jnp.int32), pre, mc, tr)
    _, got = t_compute(_to_torch(case.batch), _to_torch(jout), step, pre, mc,
                       tr)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= LOSS_TOL, \
            (k, got[k].item(), float(want[k]))
    assert got["ctc"].item() == 0 and got["bin"].item() == 0
    assert got["pdur"].item() > 0


# ---- the whole step ----------------------------------------------------------- #

def _grad_tree(model, grads, mc):
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    sd = dict(model.state_dict())
    sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
    return jax_tree_from_state_dict(sd, mc)["params"]


@pytest.mark.parametrize("name", STEP_OPTIONS)
def test_train_sup_step_matches_jax(cases, name):
    """One ``train_sup`` step with the variance gate open and
    ``deterministic=True`` on both sides: every loss component and the
    gradient norm within 1e-4 (the norm 1e-3 relative), every gradient
    leaf within 1e-3 of its largest entry."""
    from ctts_tpu.models.loss import compute_loss as j_compute
    from ctts_torch.models.loss import compute_loss
    from ctts_torch.parallel.train_step import (_apply, batch_to_device,
                                                create_train_state,
                                                make_train_step, prep_batch)
    from ctts_torch.utils.optimizer import build_optimizer
    case = cases(name)
    pre, mc, tr = case.configs
    step0 = tr["step"]["var_start_steps"]
    jb = _to_jax(case.batch)

    def loss_fn(params):
        out, _ = case.jmodel.apply(
            {"params": params, "batch_stats": case.tree["batch_stats"]},
            step=jnp.asarray(step0 + 1, jnp.int32), deterministic=True,
            mutable=["batch_stats"], **case.kwargs(jb))
        return j_compute(jb, out, step0 + 1, pre, mc, tr)

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(case.tree["params"])
    want["grad_norm"] = optax.global_norm(want_grads)

    model = copy.deepcopy(case.tmodel)
    tb = batch_to_device(case.batch, "cpu")
    model.eval()
    out = _apply(model, prep_batch(tb, pre, "train_sup"), "train_sup",
                 step0 + 1)
    total, _ = compute_loss(tb, out, step0 + 1, pre, mc, tr)
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    assert all(g is not None for g in grads)
    got_g, want_g = _flat(_grad_tree(model, grads, mc)), _flat(want_grads)
    assert got_g.keys() == want_g.keys()
    checked = 0
    for k, w in want_g.items():
        top = np.abs(w).max()
        if top > 1e-5:
            checked += 1
            assert np.abs(got_g[k] - w).max() <= 1e-3 * top, k
        else:
            assert np.abs(got_g[k]).max() <= 2e-5, k
    assert checked > 60

    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=step0)
    metrics = make_train_step(pre, mc, tr, "train_sup",
                              deterministic=True)(state, tb)
    assert set(metrics) == set(want)
    for k, w in want.items():
        tol = 1e-4 if k != "grad_norm" else 1e-3 * float(w)
        assert abs(metrics[k].item() - float(w)) <= tol, (k, metrics[k], w)


# ---- weights ------------------------------------------------------------------ #

@pytest.mark.parametrize("name", ["ar-crf-left", "ph-mog-left", "frame-huber"])
def test_weights_round_trip(cases, name):
    """JAX tree → the port's state_dict → JAX tree gives the tree back, leaf
    for leaf: the AR head's GRU and head, the CRF, the pitch predictor at
    odim 1 and 2, the mixture's wider duration head."""
    from ctts_torch.utils.weights import (jax_tree_from_state_dict,
                                          state_dict_from_jax)
    case = cases(name)
    sd = state_dict_from_jax(case.tree)
    back = jax_tree_from_state_dict(sd, case.configs[1])
    want, got = _flat(case.tree), _flat(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    va = case.tree["params"]["variance_adaptor"]
    if name == "ar-crf-left":
        assert "ar" in va["pitch_predictor"] and "dur_crf" in va
        H = va["pitch_predictor"]["ar"]["gru"]["hn"]["bias"].shape[0]
        assert not sd["variance_adaptor.pitch_predictor.gru.bias_hh_l0"][
            :2 * H].any()
