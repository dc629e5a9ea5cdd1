"""The conformer slice of ctts_torch against the JAX package, on the CPU: the
relative-position attention op (forward and all six gradients, against the
jnp reference and the interpret-mode Pallas kernel), its dropout, the
conformer stacks and the whole ``CompTransTTS`` with ``block_type:
conformer`` in infer mode and through one ``train_unsup`` step.

The model is tiny (2 layers, width 32, 4 heads of 8, float32, the conformer
dropouts at 0) and takes numpy-drawn, perturbed weights on both sides
through the weight bridge. Every JAX result the model tests read comes from
one compiled function, run once for the module. Tolerances are stated in
each test.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from test_torch_train_step import _flat, _init_like, _jbatch, _perturb

B, T_S, T_M = 2, 11, 40
STEP = 59999            # every gate open: every parameter has a gradient


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs():
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["block_type"] = "conformer"
    mc["conformer"].update(encoder_layer=2, decoder_layer=2, encoder_hidden=32,
                           decoder_hidden=32, encoder_head=4, decoder_head=4,
                           encoder_dropout=0.0, decoder_dropout=0.0)
    return pre, mc, tr


# ---- the op -------------------------------------------------------------------- #

def _op_inputs(B_, T, H, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B_, T, H, d).astype(np.float32) for _ in range(3))
    pos = rng.randn(H, T, d).astype(np.float32)
    ub, vb = (rng.randn(H, d).astype(np.float32) for _ in range(2))
    cot = rng.randn(B_, T, H, d).astype(np.float32)
    mask = np.zeros((B_, T), bool)
    mask[-1, T - 7:] = True                               # padding
    return (q, k, v, pos, ub, vb), cot, mask


def _torch_op(args, cot, mask, scale, **kw):
    from ctts_torch.ops.relpos_attention import relpos_attention
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = relpos_attention(*ts, scale, key_padding_mask=(
        None if mask is None else torch.from_numpy(mask)), **kw)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_vjp(fn, args, cot):
    """fn's output and its six gradients at ``cot``, as one jitted function
    (one compile in place of one per primitive)."""
    def both(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)
    return jax.jit(both)(tuple(map(jnp.asarray, args)), jnp.asarray(cot))


def _assert_grads(got, want, rel):
    for name, g, w in zip(("q", "k", "v", "pos", "u", "v_bias"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), name


@pytest.mark.parametrize("masked", [False, True])
def test_relpos_op_matches_jax_reference(masked):
    """T=37 (not a multiple of 128), B=2, H=4, Dh=8, f32: output ≤ 1e-5,
    each gradient ≤ 1e-5 of its largest entry. Masked logits are -1e9."""
    from ctts_tpu.ops.relpos_attention import relpos_attention_reference
    args, cot, mask = _op_inputs(2, 37, 4, 8, 0)
    mask = mask if masked else None
    scale = 1.0 / np.sqrt(32.0)

    def ref(q, k, v, pos, ub, vb):
        return relpos_attention_reference(
            q, k, v, pos[None].transpose(0, 2, 1, 3), ub, vb, scale,
            key_padding_mask=None if mask is None else jnp.asarray(mask))

    want, want_g = _jax_vjp(ref, args, cot)
    got, got_g = _torch_op(args, cot, mask, scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    _assert_grads(got_g, want_g, 1e-5)


def test_relpos_op_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    """The Pallas kernel (T=128, B=1, H=2, Dh=16, interpret mode) with its
    row flips and strided rolls, forward and its backward kernel: the port
    agrees to 1e-5 (output) and 1e-4 of each gradient's largest entry (the
    kernel's f32 flips are exact only to ~2^-18)."""
    from ctts_tpu.ops import relpos_attention as jra
    monkeypatch.setattr(jra, "_INTERPRET", True)
    args, cot, _ = _op_inputs(1, 128, 2, 16, 1)
    scale = 0.25

    def fused(*a):
        return jra.relpos_attention(*a, scale)

    assert jra.supported(128)
    want, want_g = _jax_vjp(fused, args, cot)
    got, got_g = _torch_op(args, cot, None, scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    _assert_grads(got_g, want_g, 1e-4)


def test_relpos_dropout_on_the_plain_version():
    """With p=0.1 the output is exactly (softmax ∘ keep/(1-p)) · V with the
    mask of ``dropout_keep`` for the seed drawn from the generator, and dV is exactly its transpose
    applied to the cotangent: the forward and the backward use one mask.
    The keep rate is within 3σ of 0.9 and another seed gives another
    mask."""
    from ctts_torch.ops import relpos_attention as ra
    args, cot, _ = _op_inputs(2, 37, 4, 8, 2)
    scale, p = 0.2, 0.1
    out, grads = _torch_op(args, cot, None, scale, dropout_p=p,
                           generator=torch.Generator().manual_seed(11))
    seed = ra.draw_seed(torch.Generator().manual_seed(11), "cpu")
    q, k, v, pos, ub, vb = map(torch.from_numpy, args)
    keep = ra.dropout_keep(seed, 8, 37, p).reshape(2, 4, 37, 37)
    probs = torch.softmax(
        (torch.einsum("bqhd,bkhd->bhqk", q + ub, k) + ra.relative_shift(
            torch.einsum("bqhd,hkd->bhqk", q + vb, pos))) * scale, -1)
    dropped = torch.where(keep, probs / (1 - p), torch.zeros(()))
    want = torch.einsum("bhqk,bkhd->bqhd", dropped, v)
    np.testing.assert_allclose(out, want.numpy(), atol=1e-6, rtol=0)
    want_dv = torch.einsum("bhqk,bqhd->bkhd", dropped, torch.from_numpy(cot))
    np.testing.assert_allclose(grads[2], want_dv.numpy(), atol=1e-5, rtol=0)
    big = ra.dropout_keep(seed, 64, 128, p)
    n = big.numel()
    rate = big.float().mean().item()
    assert abs(rate - 0.9) <= 3 * np.sqrt(0.9 * 0.1 / n), rate
    other = ra.dropout_keep(seed + 1, 64, 128, p)
    assert (other != big).float().mean().item() > 0.1


def test_relative_shift_and_helpers_match_jax():
    """relative_shift equals the JAX shift exactly; the interleaved sinusoid
    table equals ``_sinusoid_encoding`` to 1e-6."""
    from ctts_tpu.models.transformer import _sinusoid_encoding
    from ctts_tpu.ops.relpos_attention import relative_shift as j_shift
    from ctts_torch.models.blocks import dtype_of, interleaved_sinusoid_table
    from ctts_torch.ops.relpos_attention import relative_shift
    x = np.random.RandomState(3).randn(2, 3, 9, 9).astype(np.float32)
    np.testing.assert_array_equal(relative_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_shift(jnp.asarray(x))))
    np.testing.assert_allclose(interleaved_sinusoid_table(1001, 256).numpy(),
                               np.asarray(_sinusoid_encoding(1001, 256)),
                               atol=1e-6, rtol=0)
    assert dtype_of({"compute_dtype": "bfloat16"}) == torch.bfloat16
    assert dtype_of({}) == torch.float32


# ---- the model ------------------------------------------------------------------ #

def _stack_inputs():
    rng = np.random.RandomState(5)
    tokens = rng.randint(1, 300, (B, T_S)).astype(np.int32)
    smask = np.arange(T_S)[None] >= np.array([T_S, 7])[:, None]
    tokens[smask] = 0
    frames = rng.randn(B, T_M, 32).astype(np.float32)
    mmask = np.arange(T_M)[None] >= np.array([T_M, 29])[:, None]
    cot = rng.randn(B, T_S, 32).astype(np.float32)
    return dict(tokens=tokens, smask=smask, frames=frames, mmask=mmask,
                cot=cot)


class _Conf:
    """The JAX conformer model with its weights, the results of one compiled
    function (the stacks and the model in infer mode; one ``train_unsup``
    step in train mode with every dropout the identity, so BatchNorm uses
    batch statistics and moves its running ones), and the maker of the
    port's model from the same tree."""

    def __init__(self):
        import flax.linen as nn
        from ctts_tpu.models.comp_trans_tts import (CompTransTTS,
                                                    prepare_model_config)
        from ctts_tpu.models.loss import compute_loss
        from ctts_tpu.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        pre, mc, tr = _configs()
        mc = prepare_model_config(pre, mc)
        self.configs = (pre, mc, tr)
        jm = self.jmodel = CompTransTTS(pre, mc, tr)
        self.batch = synth_batch(B=B, T_s=T_S, T_m=T_M, seed=0)
        self.inputs = _stack_inputs()
        shapes = jax.eval_shape(lambda rng: jm.init(
            {"params": rng}, step=jnp.zeros((), jnp.int32),
            deterministic=True, **self.kwargs(_jbatch(self.batch))),
            jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.tree = _perturb(_init_like(dict(shapes), rng), rng)
        tx, _ = build_optimizer(mc, tr)

        def everything(tree, batch, step, x):
            params, stats = tree["params"], tree["batch_stats"]
            res = {}
            bound = jm.bind(tree)
            res["enc"], res["emb"] = bound.encoder(x["tokens"], x["smask"])
            res["dec"], _ = bound.decoder(x["frames"], x["mmask"])
            infer = jm.apply(tree, batch["speakers"], batch["texts"],
                             batch["src_lens"], "infer", max_mel_len=48)
            res["infer"] = {k: infer[k] for k in (
                "mel_lens", "mel_predictions", "postnet_mel_predictions")}

            def loss_fn(p):
                out, mutated = jm.apply(
                    {"params": p, "batch_stats": stats}, step=step,
                    deterministic=False, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(0)},
                    **self.kwargs(batch))
                total, comps = compute_loss(batch, out, step, pre, mc, tr)
                return total, (comps, mutated["batch_stats"])
            (_, (comps, res["stats_after"])), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, _ = tx.update(grads, tx.init(params), params)
            comps["grad_norm"] = optax.global_norm(grads)
            res["comps"], res["grads"] = comps, grads
            res["params_after"] = optax.apply_updates(params, updates)
            return res

        args = (self.tree, _jbatch(self.batch),
                jnp.asarray(STEP + 1, jnp.int32),
                {k: jnp.asarray(v) for k, v in self.inputs.items()})
        orig = nn.Dropout.__call__
        nn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
        try:
            # the CPU backend's cheaper optimization levels: the same
            # float32 arithmetic, about a third less compile time
            self.res = jax.jit(everything).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0,
                                  "xla_llvm_disable_expensive_passes": True})(
                *args)
        finally:
            nn.Dropout.__call__ = orig

    @staticmethod
    def kwargs(batch):
        return dict(speakers=batch["speakers"], texts=batch["texts"],
                    src_lens=batch["src_lens"], mode="train_unsup",
                    mels=batch["mels"], mel_lens=batch["mel_lens"],
                    pitch_targets=batch["pitch_data"],
                    energy_targets=batch["energies"],
                    attn_priors=batch["attn_priors"])

    def torch_model(self):
        from ctts_torch.models.comp_trans_tts import CompTransTTS
        from ctts_torch.utils.weights import state_dict_from_jax
        pre, mc, tr = self.configs
        model = CompTransTTS(pre, mc, tr)
        model.load_state_dict(state_dict_from_jax(self.tree), strict=True)
        return model

    def torch_step(self):
        """The port's train-mode step with every dropout at p=0 (the same
        identity as the JAX side): (metrics, gradients, model, rate)."""
        from ctts_torch.models.blocks import Dropout
        from ctts_torch.parallel.train_step import (batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.utils.optimizer import build_optimizer
        if hasattr(self, "_step"):
            return self._step
        pre, mc, tr = self.configs
        model = self.torch_model()
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        opt, sched = build_optimizer(model, mc, tr)
        state = create_train_state(model, opt, step=STEP)
        seen = {}
        update = opt.update

        def spy(grads):
            seen["g"] = [g.clone() for g in grads]
            return update(grads)

        opt.update = spy
        metrics = make_train_step(pre, mc, tr, "train_unsup")(
            state, batch_to_device(self.batch, "cpu"))
        assert model.training
        self._step = (metrics, seen["g"], model, sched(0))
        return self._step


@pytest.fixture(scope="module")
def conf():
    return _Conf()


def _check_grads(got, want, rel=1e-3):
    """Per leaf: ≤ rel of the leaf's largest entry (or ≤ 2e-5 for leaves
    whose largest entry is below 1e-5). Returns the number of leaves with
    a real gradient."""
    assert got.keys() == want.keys()
    checked = 0
    for k, w in want.items():
        top = np.abs(w).max()
        if top > 1e-5:
            checked += 1
            assert np.abs(got[k] - w).max() <= rel * top, k
        else:
            assert np.abs(got[k]).max() <= 2e-5, k
    return checked


def test_conformer_stacks_in_infer_mode(conf):
    """Encoder (tokens, a padded row) and decoder (random frames) in eval
    mode on both sides: ≤ 1e-4 absolute; padded positions are exactly 0."""
    model = conf.torch_model().eval()
    x = {k: torch.from_numpy(v) for k, v in conf.inputs.items()}
    with torch.no_grad():
        got_e, got_emb = model.encoder(x["tokens"], x["smask"])
        got_d, _ = model.decoder(x["frames"], x["mmask"])
    res = conf.res
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(res["emb"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(res["enc"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(res["dec"]),
                               atol=1e-4, rtol=0)
    assert not got_d[1, 29:].any() and not got_e[1, 7:].any()


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_conformer_stacks_in_train_mode(conf, side):
    """The stacks inside the train-mode step (dropout p=0): the conv
    modules' BatchNorm normalizes with batch statistics (padded frames
    included) and moves its running statistics by flax's rule (≤ 1e-5), and
    every gradient leaf of the stack agrees to 1e-3 of its largest entry."""
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    from test_torch_train_step import _grad_tree
    _, mc, _ = conf.configs
    _, grads, model, _ = conf.torch_step()
    stats = _flat(jax_tree_from_state_dict(model.state_dict(),
                                           mc)["batch_stats"][side])
    want = _flat(conf.res["stats_after"][side])
    old = _flat(conf.tree["batch_stats"][side])
    assert stats.keys() == want.keys() and len(stats) == 4
    for k, w in want.items():
        np.testing.assert_allclose(stats[k], w, atol=1e-5, rtol=0)
        assert np.abs(w - old[k]).max() > 1e-4               # they moved
    got_g = _flat(_grad_tree(model, grads, mc)[side])
    assert _check_grads(got_g, _flat(conf.res["grads"][side])) > 40


def test_conformer_model_infer_parity(conf):
    """The whole model in infer mode (durations predicted, budget 48):
    mel and postnet ≤ 1e-3 absolute, lengths equal."""
    model = conf.torch_model().eval()
    b = conf.batch
    want = conf.res["infer"]
    with torch.no_grad():
        got = model(torch.from_numpy(b["speakers"]).long(),
                    torch.from_numpy(b["texts"]).long(),
                    torch.from_numpy(b["src_lens"]).long(), "infer",
                    max_mel_len=48)
    np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                  np.asarray(want["mel_lens"]))
    for k in ("mel_predictions", "postnet_mel_predictions"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=0)


def test_conformer_train_step_matches_jax(conf):
    """One ``train_unsup`` step in train mode (dropout p=0) with every gate
    open: each loss component ≤ 1e-4 (the gradient norm 1e-3 relative),
    each gradient leaf ≤ 1e-3 of its largest entry, and every parameter
    after the Adam update within 2e-3 of the rate (the first update is
    ±rate per entry)."""
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    from test_torch_train_step import _grad_tree
    _, mc, _ = conf.configs
    res = conf.res
    metrics, grads, model, rate = conf.torch_step()
    want = res["comps"]
    assert set(metrics) == set(want)
    for k, w in want.items():
        tol = 1e-4 if k != "grad_norm" else 1e-3 * float(w)
        assert abs(metrics[k].item() - float(w)) <= tol, (k, metrics[k], w)
    got_g = _flat(_grad_tree(model, grads, mc))
    assert _check_grads(got_g, _flat(res["grads"])) > 100
    got_p = _flat(jax_tree_from_state_dict(model.state_dict(), mc)["params"])
    for k, w in _flat(res["params_after"]).items():
        assert np.abs(got_p[k] - w).max() <= 2e-3 * rate \
            + 2.5e-7 * np.abs(w).max(), k


def test_conformer_state_dict_round_trip(conf):
    """The port's state_dict goes through ``import_reference_checkpoint``
    (the upstream layout) to the JAX tree bit for bit, and
    ``jax_tree_from_state_dict`` gives the same tree, batch_stats
    included."""
    from ctts_tpu.utils.torch_import import import_reference_checkpoint
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    pre, mc, _ = conf.configs
    sd = conf.torch_model().state_dict()
    via_ref = import_reference_checkpoint(sd, pre, mc)
    back = jax_tree_from_state_dict(sd, mc)
    want = _flat(conf.tree)
    for tree in (via_ref, back):
        got = _flat(tree)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, k)
    assert any("layer_stack_1" in k and "bn" in k and "var" in k
               for k in want)


def test_relpos_module_draws_its_seed_from_the_generator(conf):
    """In train mode the attention's dropout (p=0.1 here) draws its seed
    from the train state's generator: one seed, one result; another seed,
    another. In eval mode there is no dropout."""
    from ctts_torch.models.blocks import set_dropout_generator
    model = conf.torch_model().train()
    attn = model.encoder.layer_stack[0].sequential[1].module.attention
    attn.dropout.p = 0.1
    x = torch.from_numpy(np.random.RandomState(7).randn(
        B, T_S, 32).astype(np.float32))
    pos = torch.zeros(1, T_S, 32)
    outs = []
    for seed in (3, 3, 4):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(attn(x, pos))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    attn.eval()
    with torch.no_grad():
        assert torch.equal(attn(x, pos), attn(x, pos))
