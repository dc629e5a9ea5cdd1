"""The ``train_unsup`` slice of ctts_torch against the JAX package, on the
CPU: the aligner, each loss term, the optimizer, and the whole step.

A tiny model (``tiny_configs()``: one encoder and one decoder layer, width
32, float32, ``learn_alignment``) gets numpy-drawn, perturbed weights on
both sides through the weight bridge, and both sides see the same numpy
batch. The JAX step is compiled once per mode for the whole module; its
schedule step is a traced scalar, so one compilation serves every gate.
Tolerances: loss components 1e-4 absolute; gradients 1e-3 relative per leaf,
measured against the leaf's largest entry, for leaves whose largest entry is
above 1e-5; parameters after updates 2e-3 of the summed learning rates.
"""

import copy
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T_S, T_M = 2, 11, 40
# (state.step, what step+1 opens): soft upsample; hard upsample; bin-loss
# ramp at 0.5; variance losses
GATES = {"soft": 99, "hard": 6999, "bin": 22999, "var": 59999}


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


def _jbatch(batch):
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return None if v is None else jnp.asarray(v)
    return {k: conv(v) for k, v in batch.items()}


def _tbatch(batch):
    from ctts_torch.parallel.train_step import batch_to_device
    return batch_to_device(batch, "cpu")


class _Pair:
    """The JAX model with its compiled steps, and the maker of the port's
    model from the same tree; ``max_seq_len`` overrides the config's."""

    def __init__(self, max_seq_len=None):
        from ctts_tpu.models.comp_trans_tts import (CompTransTTS,
                                                    prepare_model_config)
        from ctts_tpu.models.loss import compute_loss
        from ctts_tpu.utils.optimizer import build_optimizer
        from ctts_tpu.utils.testing import tiny_configs
        from ctts_torch.utils.testing import synth_batch
        pre, mc, tr = tiny_configs()
        if max_seq_len is not None:
            mc["max_seq_len"] = max_seq_len
        mc = prepare_model_config(pre, mc)
        self.configs = (pre, mc, tr)
        self.jmodel = CompTransTTS(pre, mc, tr)
        self.batch = synth_batch(B=B, T_s=T_S, T_m=T_M, seed=0)
        jb = _jbatch(self.batch)
        kwargs = self._kwargs(jb)
        shapes = jax.eval_shape(lambda rng: self.jmodel.init(
            {"params": rng}, step=jnp.zeros((), jnp.int32),
            deterministic=True, **kwargs), jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.tree = _perturb(_init_like(dict(shapes), rng), rng)
        self.tx, _ = build_optimizer(mc, tr)

        def run(params, stats, opt_state, batch, step, train_mode):
            """Loss components, gradients and the state after one update;
            ``train_mode`` is the JAX step's ``deterministic=False`` (batch
            statistics; dropout is patched out by the caller)."""
            def loss_fn(p):
                out, mutated = self.jmodel.apply(
                    {"params": p, "batch_stats": stats}, step=step,
                    deterministic=not train_mode, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(0)},
                    **self._kwargs(batch))
                total, comps = compute_loss(batch, out, step, pre, mc, tr)
                return total, (comps, mutated["batch_stats"], out)
            (_, (comps, new_stats, out)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            comps["grad_norm"] = optax.global_norm(grads)
            return (comps, grads, optax.apply_updates(params, updates),
                    new_stats, opt_state, out)

        self.run = jax.jit(run, static_argnames=("train_mode",))

    @staticmethod
    def _kwargs(batch):
        return dict(speakers=batch["speakers"], texts=batch["texts"],
                    src_lens=batch["src_lens"], mode="train_unsup",
                    mels=batch["mels"], mel_lens=batch["mel_lens"],
                    pitch_targets=batch["pitch_data"],
                    energy_targets=batch["energies"],
                    attn_priors=batch["attn_priors"])

    def jax_step(self, step, train_mode=False, opt_state=None, tree=None):
        tree = tree or self.tree
        if opt_state is None:
            opt_state = self.tx.init(tree["params"])
        return self.run(tree["params"], tree["batch_stats"], opt_state,
                        _jbatch(self.batch), jnp.asarray(step, jnp.int32),
                        train_mode=train_mode)

    def torch_state(self, step):
        from ctts_torch.models.comp_trans_tts import CompTransTTS
        from ctts_torch.parallel.train_step import create_train_state
        from ctts_torch.utils.optimizer import build_optimizer
        from ctts_torch.utils.weights import state_dict_from_jax
        pre, mc, tr = self.configs
        model = CompTransTTS(pre, mc, tr)
        model.load_state_dict(state_dict_from_jax(self.tree), strict=True)
        opt, _ = build_optimizer(model, mc, tr)
        return create_train_state(model, opt, step=step)


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---- modules ----------------------------------------------------------------- #

def test_aligner_parity(pair):
    """Soft attention and log-probabilities ≤ 1e-4 (the log-probabilities
    reach -20 where the zero-padded prior is log(1e-8))."""
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.utils.weights import state_dict_from_jax
    pre, mc, tr = pair.configs
    tmodel = CompTransTTS(pre, mc, tr)
    tmodel.load_state_dict(state_dict_from_jax(pair.tree), strict=True)
    rng = np.random.RandomState(1)
    mels = rng.randn(B, T_M, 80).astype(np.float32)
    emb = rng.randn(B, T_S, 32).astype(np.float32)
    mask = np.arange(T_S)[None, :] >= np.asarray([T_S, 7])[:, None]
    prior = rng.rand(B, T_M, T_S).astype(np.float32)
    prior[1, :, 7:] = 0.0                                 # zero-padded
    jva = pair.jmodel.bind(pair.tree).variance_adaptor
    want_soft, want_lp = jva.aligner(jnp.asarray(mels), jnp.asarray(emb),
                                     jnp.asarray(mask), jnp.asarray(prior))
    with torch.no_grad():
        soft, lp = tmodel.variance_adaptor.aligner(
            torch.from_numpy(mels), torch.from_numpy(emb),
            torch.from_numpy(mask), torch.from_numpy(prior))
    _close(soft, want_soft, atol=1e-5)
    _close(lp, want_lp)
    assert not soft[1, :, 7:].any()


def test_grad_scale_scales_only_the_gradient():
    from ctts_torch.models.blocks import grad_scale
    x = torch.tensor([1.5, -2.0], requires_grad=True)
    y = grad_scale(x, 0.1)
    assert torch.equal(y, x)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.1, 0.1], rtol=1e-6)


def _loss_inputs(rng):
    src_mask = np.arange(T_S)[None, :] >= np.asarray([T_S, 8])[:, None]
    mel_mask = np.arange(T_M)[None, :] >= np.asarray([T_M, 31])[:, None]
    return src_mask, mel_mask


@pytest.mark.parametrize("term", ["mel", "duration", "pitch", "energy"])
def test_loss_terms_match_jax(term):
    """Each loss term on random predictions and targets, ≤ 1e-5."""
    from ctts_tpu.models import loss as j_loss
    from ctts_torch.models import loss as t_loss
    from ctts_tpu.text import sil_phonemes_ids
    from ctts_torch.config import get_configs_of
    pre, _, tr = get_configs_of("LJSpeech")
    loss_cfg = tr["loss"]
    pitch_cfg = pre["preprocessing"]["pitch"]
    rng = np.random.RandomState(2)
    src_mask, mel_mask = _loss_inputs(rng)
    t = torch.from_numpy
    if term == "mel":
        pred = rng.randn(B, T_M, 80).astype(np.float32)
        tgt = rng.randn(B, T_M, 80).astype(np.float32)
        tgt[0, 3] = 0.0                       # a zero target frame: weight 0
        want = {"mel": j_loss.weighted_mel_l1(jnp.asarray(pred),
                                              jnp.asarray(tgt),
                                              jnp.asarray(mel_mask))}
        got = {"mel": t_loss.weighted_mel_l1(t(pred), t(tgt), t(mel_mask))}
    elif term == "duration":
        log_dur = rng.randn(B, T_S).astype(np.float32)
        dur = rng.randint(0, 6, (B, T_S)).astype(np.float32)
        tokens = rng.randint(1, 300, (B, T_S)).astype(np.int32)
        tokens[:, [3, 7]] = sil_phonemes_ids()[0]          # three words
        want = j_loss.duration_loss(jnp.asarray(log_dur), jnp.asarray(dur),
                                    jnp.asarray(tokens),
                                    jnp.asarray(src_mask), loss_cfg)
        got = t_loss.duration_loss(t(log_dur), t(dur), t(tokens),
                                   t(src_mask), loss_cfg)
        assert set(got) == {"pdur", "wdur", "sdur"}
    elif term == "pitch":
        pred = {"cwt": rng.randn(B, T_M, 11).astype(np.float32),
                "f0_mean": rng.randn(B).astype(np.float32),
                "f0_std": rng.randn(B).astype(np.float32)}
        tgt = {"cwt_spec": rng.randn(B, T_M, 10).astype(np.float32),
               "uv": (rng.rand(B, T_M) < 0.3).astype(np.float32),
               "f0": rng.randn(B, T_M).astype(np.float32),
               "f0_mean": rng.randn(B).astype(np.float32),
               "f0_std": rng.randn(B).astype(np.float32)}
        want = j_loss.pitch_loss(
            {k: jnp.asarray(v) for k, v in pred.items()},
            {k: jnp.asarray(v) for k, v in tgt.items()}, pitch_cfg, loss_cfg,
            jnp.asarray(src_mask), jnp.asarray(mel_mask))
        got = t_loss.pitch_loss({k: t(v) for k, v in pred.items()},
                                {k: t(v) for k, v in tgt.items()}, pitch_cfg,
                                loss_cfg, t(mel_mask))
        assert set(got) == {"C", "uv", "f0_mean", "f0_std"}
    else:
        pred = rng.randn(B, T_S).astype(np.float32)
        tgt = rng.randn(B, T_S).astype(np.float32)
        want = {"energy": j_loss.energy_loss(
            jnp.asarray(pred), jnp.asarray(tgt), "phoneme_level",
            jnp.asarray(src_mask), jnp.asarray(mel_mask))}
        got = {"energy": t_loss.energy_loss(t(pred), t(tgt), "phoneme_level",
                                            t(src_mask), t(mel_mask))}
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5, k


# ---- optimizer ------------------------------------------------------------------ #

@pytest.mark.parametrize("start", [0, 13301, 350000])
def test_noam_adam_matches_optax(start):
    """Four updates on random gradients, with norms on both sides of the
    clip threshold, from update count ``start``: rates equal to 1e-6
    relative, parameters to 1e-6 absolute (their steps are ~1e-3 at the
    largest rate)."""
    from ctts_tpu.utils.optimizer import build_optimizer as j_build
    from ctts_torch.utils.optimizer import NoamAdam, noam_schedule
    from ctts_torch.config import get_configs_of
    _, mc, tr = get_configs_of("LJSpeech")
    tx, j_sched = j_build(mc, tr)
    oc = tr["optimizer"]
    sched = noam_schedule(256 ** -0.5, oc["warm_up_step"], oc["anneal_steps"],
                          oc["anneal_rate"])
    for count in (0, 1, 2, 3999, 4000, 4001, 300000, 300001, 450000, 600000):
        assert abs(sched(count) - float(j_sched(jnp.asarray(count)))) \
            <= 1e-6 * sched(count)
    assert sched(0) == sched(1)

    rng = np.random.RandomState(start % 97)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    # optax keeps its own count, from 0: a resumed count is set by hand
    opt_state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(start, x.dtype)
        if x.shape == () and jnp.issubdtype(x.dtype, jnp.integer) else x,
        opt_state)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    opt = NoamAdam(tparams, sched, betas=tuple(oc["betas"]), eps=oc["eps"],
                   clip=oc["grad_clip_thresh"], count=start)
    for scale in (0.05, 3.0, 0.2, 10.0):
        grads = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        jg = [jnp.asarray(g) for g in grads]
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = opt.update([torch.from_numpy(g) for g in grads])
        assert abs(norm.item() - float(optax.global_norm(jg))) <= 1e-5 * scale
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("key,value", [("grad_acc_step", 2),
                                       ("weight_decay", 0.01)])
def test_unported_optimizer_options_name_their_item(key, value):
    """The two options ROADMAP item 9b once left out now build (their
    arithmetic against optax is in tests/test_torch_train_loop.py)."""
    from ctts_torch.utils.optimizer import build_optimizer
    from ctts_torch.config import get_configs_of
    _, mc, tr = copy.deepcopy(get_configs_of("LJSpeech"))
    tr["optimizer"][key] = value
    opt, _ = build_optimizer(torch.nn.Linear(2, 2), mc, tr)
    attr = {"grad_acc_step": "acc_steps", "weight_decay": "weight_decay"}[key]
    assert getattr(opt, attr) == value


# ---- the whole step ----------------------------------------------------------------- #

def _grad_tree(model, grads, mc):
    """Gradients by parameter name → the JAX tree's layout (buffers ride
    along as they are)."""
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    sd = dict(model.state_dict())
    sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
    return jax_tree_from_state_dict(sd, mc)["params"]


@pytest.mark.parametrize("gate", list(GATES))
def test_train_step_matches_jax_across_gates(pair, gate):
    """One step on each side of the soft/hard upsample switch, the bin-loss
    ramp and the variance gate, with ``deterministic=True`` on both sides:
    every loss component and the gradient norm, every gradient leaf, and the
    MAS durations."""
    from ctts_torch.models.loss import compute_loss
    from ctts_torch.parallel.train_step import (_apply, make_train_step,
                                                prep_batch)
    pre, mc, tr = pair.configs
    step0 = GATES[gate]
    want, want_grads, _, _, _, jout = pair.jax_step(step0 + 1)
    state = pair.torch_state(step0)
    tb = _tbatch(pair.batch)

    # gradients, through the same calls the step makes
    state.model.eval()
    out = _apply(state.model, prep_batch(tb, pre, "train_unsup"),
                 "train_unsup", step0 + 1)
    total, _ = compute_loss(tb, out, step0 + 1, pre, mc, tr)
    params = list(state.model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    assert all(g is not None for g in grads)
    np.testing.assert_array_equal(out["attn_outs"][2].numpy(),
                                  np.asarray(jout["attn_outs"][2]))
    np.testing.assert_array_equal(out["mel2ph"].numpy(),
                                  np.asarray(jout["mel2ph"]))
    got_g, want_g = _flat(_grad_tree(state.model, grads, mc)), \
        _flat(want_grads)
    assert got_g.keys() == want_g.keys()
    checked = 0
    for k, w in want_g.items():
        top = np.abs(w).max()
        if top > 1e-5:
            checked += 1
            assert np.abs(got_g[k] - w).max() <= 1e-3 * top, k
        else:
            assert np.abs(got_g[k]).max() <= 2e-5, k
    assert checked > (60 if gate == "var" else 30)

    metrics = make_train_step(pre, mc, tr, "train_unsup",
                              deterministic=True)(state, tb)
    assert state.step == step0 + 1 and set(metrics) == set(want)
    for k, w in want.items():
        tol = 1e-4 if k != "grad_norm" else 1e-3 * float(w)
        assert abs(metrics[k].item() - float(w)) <= tol, (k, metrics[k], w)
    variance = ("pdur", "sdur", "pitch_C", "pitch_uv", "pitch_f0_mean",
                "pitch_f0_std", "energy")
    closed = {"soft": ("bin",) + variance, "hard": ("bin",) + variance,
              "bin": variance, "var": ()}[gate]
    for k in ("bin",) + variance:
        assert (metrics[k].item() == 0) == (k in closed), k


def test_train_step_past_max_seq_len_matches_jax():
    """``max_seq_len`` 8 under the batch's 11 tokens and 40 frames (the
    decoder's table holds 2·8): both sides clamp the positions past the
    sinusoid tables to their last row and truncate nothing, so one step
    with every gate open gives the JAX step's loss components, gradient
    norm, gradient leaves and MAS durations, as at the shipped limits."""
    from ctts_torch.parallel.train_step import make_train_step
    long = _Pair(max_seq_len=8)
    pre, mc, tr = long.configs
    assert T_S > mc["max_seq_len"] and T_M > 2 * mc["max_seq_len"]
    step0 = GATES["var"]
    want, want_grads, _, _, _, jout = long.jax_step(step0 + 1)
    state = long.torch_state(step0)
    state.model.eval()
    grads = []
    opt = state.optimizer
    update = opt.update

    def keep(g):
        grads.append([x.clone() for x in g])
        return update(g)
    opt.update = keep
    metrics = make_train_step(pre, mc, tr, "train_unsup",
                              deterministic=True)(state, _tbatch(long.batch))
    for k, w in want.items():
        tol = 1e-4 if k != "grad_norm" else 1e-3 * float(w)
        assert abs(metrics[k].item() - float(w)) <= tol, (k, metrics[k], w)
    got_g, want_g = _flat(_grad_tree(state.model, grads[0], mc)), \
        _flat(want_grads)
    for k, w in want_g.items():
        top = np.abs(w).max()
        assert np.abs(got_g[k] - w).max() <= max(1e-3 * top, 2e-5), k
    assert int(np.asarray(jout["mel2ph"]).max()) > 0


def test_parameters_after_two_updates_match_through_the_inverse_bridge(pair):
    """Two steps on each side from the same weights (the variance gate open,
    so every parameter has a gradient). The first Adam update is ±rate for
    every entry; the second mixes two gradients. Parameters agree to 2e-3 of
    the two rates' sum plus two float32 ulps of the leaf's largest entry,
    and the inverse bridge gives back the JAX tree's keys and shapes."""
    from ctts_torch.parallel.train_step import make_train_step
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    pre, mc, tr = pair.configs
    step0 = GATES["var"]
    _, _, p1, s1, opt1, _ = pair.jax_step(step0 + 1)
    _, _, p2, _, _, _ = pair.jax_step(
        step0 + 2, opt_state=opt1, tree={"params": p1, "batch_stats": s1})
    state = pair.torch_state(step0)
    step = make_train_step(pre, mc, tr, "train_unsup", deterministic=True)
    tb = _tbatch(pair.batch)
    step(state, tb)
    step(state, tb)
    assert state.step == step0 + 2 and state.optimizer.count == 2
    back = jax_tree_from_state_dict(state.model.state_dict(), mc)
    got, want, old = _flat(back["params"]), _flat(p2), \
        _flat(pair.tree["params"])
    assert got.keys() == want.keys()
    rate = 2 * state.optimizer.schedule(1)
    moved = 0
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= 2e-3 * rate + 2.5e-7 * np.abs(w).max(), k
        moved += int(np.abs(w - old[k]).max() > 0.5 * rate)
    assert moved > 60
    # eval-mode steps leave the running statistics alone
    for k, v in _flat(back["batch_stats"]).items():
        np.testing.assert_array_equal(v, _flat(pair.tree["batch_stats"])[k])


def test_train_mode_step_uses_batch_statistics(pair, monkeypatch):
    """``deterministic=False`` on both sides, with every dropout made the
    identity by the same means (the Dropout class's call is patched): the
    postnet normalizes with batch statistics, and the running statistics
    move by flax's rule (0.99·old + 0.01·batch, biased variance). Loss
    components ≤ 1e-4, running statistics ≤ 1e-5."""
    import flax.linen as nn
    from ctts_torch.models.blocks import Dropout
    from ctts_torch.parallel.train_step import make_train_step
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    pre, mc, tr = pair.configs
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)
    step0 = GATES["hard"]
    want, _, _, want_stats, _, _ = pair.jax_step(step0 + 1, train_mode=True)
    eval_want = pair.jax_step(step0 + 1)[0]
    assert abs(float(want["postnet_mel"]) - float(eval_want["postnet_mel"])) \
        > 1e-3                               # the two BatchNorm modes differ
    state = pair.torch_state(step0)
    metrics = make_train_step(pre, mc, tr, "train_unsup")(
        state, _tbatch(pair.batch))
    assert state.model.training
    for k, w in want.items():
        tol = 1e-4 if k != "grad_norm" else 1e-3 * float(w)
        assert abs(metrics[k].item() - float(w)) <= tol, (k, metrics[k], w)
    got_stats = _flat(jax_tree_from_state_dict(state.model.state_dict(),
                                               mc)["batch_stats"])
    want_stats = _flat(want_stats)
    assert got_stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, atol=1e-5, rtol=0)
        assert np.abs(w - _flat(pair.tree["batch_stats"])[k]).max() > 1e-4


def test_dropout_draws_from_the_state_generator(pair):
    """In train mode two states with one seed take identical steps, another
    seed differs, and the masks keep 1-p of the entries, scaled by 1/(1-p)."""
    from ctts_torch.models.blocks import Dropout
    from ctts_torch.parallel.train_step import make_train_step
    pre, mc, tr = pair.configs
    step = make_train_step(pre, mc, tr, "train_unsup")
    tb = _tbatch(pair.batch)
    totals = []
    for seed in (7, 7, 8):
        state = pair.torch_state(0)
        state.generator.manual_seed(seed)
        totals.append(step(state, tb)["total"].item())
    assert totals[0] == totals[1] != totals[2]
    drop = Dropout(0.25)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(200, 200))
    assert torch.equal(y.unique(), torch.tensor([0.0, 1.0 / 0.75]))
    assert abs((y > 0).float().mean().item() - 0.75) < 0.01
    assert torch.equal(drop.eval()(torch.ones(3)), torch.ones(3))


def test_eval_step_and_on_device_prior(pair):
    """``make_eval_step`` equals the JAX eval step's components (≤ 1e-4)
    when the batch ships no prior and float16 arrays: ``prep_batch`` computes
    the prior on the device and upcasts."""
    from ctts_tpu.parallel.train_step import make_eval_step as j_make
    from ctts_tpu.parallel.train_step import TrainState
    from ctts_torch.parallel.train_step import make_eval_step
    pre, mc, tr = pair.configs
    batch = dict(pair.batch, attn_priors=None,
                 mels=pair.batch["mels"].astype(np.float16))
    jstate = TrainState(step=jnp.asarray(30000, jnp.int32),
                        params=pair.tree["params"],
                        batch_stats=pair.tree["batch_stats"], opt_state=None)
    want, _ = j_make(pair.jmodel, pre, mc, tr, "train_unsup")(
        jstate, _jbatch(batch))
    state = pair.torch_state(30000)
    got, out = make_eval_step(pre, mc, tr, "train_unsup")(state,
                                                          _tbatch(batch))
    assert not state.model.training and state.step == 30000
    assert out["mel_predictions"].dtype == torch.float32
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k].item() - float(w)) <= 1e-4, (k, got[k], w)


def test_testing_utils_match_jax_package():
    """The numpy-only ``tiny_configs`` and ``synth_batch`` equal the JAX
    package's for the options the port has."""
    from ctts_tpu.utils import testing as j_testing
    from ctts_torch.utils import testing
    for got, want in zip(testing.tiny_configs(), j_testing.tiny_configs()):
        for section in ("transformer_fs2", "variance_predictor",
                        "duration_modeling", "preprocessing", "optimizer",
                        "loss", "step", "duration"):
            if section in want:
                assert str(got[section]) == str(want[section]), section
    got = testing.synth_batch(B=3, T_s=9, T_m=30, seed=4)
    want = j_testing.synth_batch(B=3, T_s=9, T_m=30, seed=4)
    for k, w in want.items():
        if isinstance(w, dict):
            for pk, pw in w.items():
                np.testing.assert_array_equal(got[k][pk], np.asarray(pw), pk)
        elif w is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(got[k], np.asarray(w), k)
