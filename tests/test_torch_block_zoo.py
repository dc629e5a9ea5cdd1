"""The classic ``transformer``, ``fastformer`` and ``lstransformer`` blocks of
ctts_torch against the JAX package, on the CPU: each block's encoder and
decoder stacks (outputs, and the gradients of every stack parameter and of
the input), the whole ``CompTransTTS`` in infer mode and through one
``train_unsup`` step (every loss term and every gradient leaf), the weight
bridge both ways, the fastformer's tied logit projections, and the position
helpers.

The models are tiny (2 layers, width 32, 2 heads, conv_filter_size 48,
float32, dropout 0) and take numpy-drawn, perturbed weights on both sides
through the weight bridge. The lstransformer runs under both
``replicate_mask_bug`` settings. The stacks see 150 tokens and 200 frames
and the lstransformer's model 160 frames (the others' 40), so its
128-frame windows, its look-back and its causal segment masks all take
part. Every JAX result of
one block comes from one compiled function, run once for the module.
Tolerances: outputs 1e-5 (the model's mels 1e-5 of their largest entry,
which reaches ~10), gradients 1e-4 of each leaf's largest entry.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from test_torch_train_step import (_flat, _grad_tree, _init_like, _jbatch,
                                   _perturb)

B, T_S = 2, 11
# the lstransformer's model runs at 160 frames: two windows of 128
T_M = {"transformer": 40, "fastformer": 40, "lstransformer": 160}
STEP = 59999            # every gate open: every parameter has a gradient
STACK_T = {"encoder": (150, 97), "decoder": (200, 143)}
CASES = ["transformer", "fastformer", "lstransformer", "lstransformer-bug"]
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(case):
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    block, _, bug = case.partition("-")
    mc["block_type"] = block
    mc["transformer"].update(encoder_layer=2, decoder_layer=2,
                             encoder_head=2, decoder_head=2,
                             encoder_dropout=0.0, decoder_dropout=0.0)
    mc["lstransformer"] = {"replicate_mask_bug": bool(bug)}
    return pre, mc, tr


def _stack_inputs():
    rng = np.random.RandomState(5)
    out = {}
    for side, (T, short) in STACK_T.items():
        mask = np.arange(T)[None] >= np.array([T, short])[:, None]
        if side == "encoder":
            x = rng.randint(1, 300, (B, T)).astype(np.int32)
            x[mask] = 0
        else:
            x = rng.randn(B, T, 32).astype(np.float32)
        out[side] = (x, mask, rng.randn(B, T, 32).astype(np.float32))
    return out


class _Zoo:
    """One block's JAX model, its weights, and the results of one compiled
    function: each stack's output and its vjp at a seeded cotangent, the
    model in infer mode, and one ``train_unsup`` step with every dropout the
    identity."""

    def __init__(self, case):
        import flax.linen as nn
        from ctts_tpu.models.comp_trans_tts import (CompTransTTS,
                                                    prepare_model_config)
        from ctts_tpu.models.loss import compute_loss
        from ctts_torch.utils.testing import synth_batch
        pre, mc, tr = _configs(case)
        mc = prepare_model_config(pre, mc)
        self.configs = (pre, mc, tr)
        jm = CompTransTTS(pre, mc, tr)
        self.batch = synth_batch(B=B, T_s=T_S, T_m=T_M[mc["block_type"]],
                                 seed=0)
        self.inputs = _stack_inputs()
        shapes = jax.eval_shape(lambda rng: jm.init(
            {"params": rng}, step=jnp.zeros((), jnp.int32),
            deterministic=True, **self.kwargs(_jbatch(self.batch))),
            jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.tree = _perturb(_init_like(dict(shapes), rng), rng)

        def everything(tree, batch, step, xs):
            params = tree["params"]
            res = {}
            for side in ("encoder", "decoder"):
                x, mask, cot = xs[side]

                def stack(p, x, side=side, mask=mask):
                    mod = getattr(jm.bind({"params": dict(params, **{
                        side: p})}), side)
                    return mod(x, mask)[0]
                if side == "encoder":
                    out, vjp = jax.vjp(lambda p: stack(p, x), params[side])
                    res[side] = (out,) + vjp(cot)
                else:
                    out, vjp = jax.vjp(stack, params[side], x)
                    res[side] = (out,) + vjp(cot)
            infer = jm.apply(tree, batch["speakers"], batch["texts"],
                             batch["src_lens"], "infer", max_mel_len=48)
            res["infer"] = {k: infer[k] for k in (
                "mel_lens", "mel_predictions", "postnet_mel_predictions")}

            def loss_fn(p):
                out = jm.apply(
                    {"params": p, "batch_stats": tree["batch_stats"]},
                    step=step, deterministic=False, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(0)},
                    **self.kwargs(batch))[0]
                return compute_loss(batch, out, step, pre, mc, tr)
            (_, comps), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params)
            comps["grad_norm"] = optax.global_norm(grads)
            res["comps"], res["grads"] = comps, grads
            return res

        xs = {side: tuple(jnp.asarray(a) for a in v)
              for side, v in self.inputs.items()}
        args = (self.tree, _jbatch(self.batch),
                jnp.asarray(STEP + 1, jnp.int32), xs)
        orig = nn.Dropout.__call__
        nn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
        try:
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
        """The port's train-mode step (dropout p=0): (metrics, gradients by
        parameter, model)."""
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
        opt, _ = build_optimizer(model, mc, tr)
        state = create_train_state(model, opt, step=STEP)
        seen = {}
        update = opt.update

        def spy(grads):
            seen["g"] = [g.clone() for g in grads]
            return update(grads)

        opt.update = spy
        metrics = make_train_step(pre, mc, tr, "train_unsup")(
            state, batch_to_device(self.batch, "cpu"))
        self._step = (metrics, seen["g"], model)
        return self._step


_ZOO = {}


@pytest.fixture(scope="module", params=CASES)
def zoo(request):
    if request.param not in _ZOO:
        _ZOO.clear()                         # one block's results at a time
        _ZOO[request.param] = _Zoo(request.param)
    return _ZOO[request.param]


def _check_grads(got, want):
    """Per leaf ≤ GRAD_TOL of the leaf's largest entry; a leaf whose
    gradient is zero but for rounding (below 1e-5: the logit biases, which
    the softmax cancels) ≤ 2e-5 absolute, as in the conformer tests.
    Returns the number of leaves with a real gradient."""
    assert got.keys() == want.keys()
    checked = 0
    for k, w in want.items():
        w = np.asarray(w)
        top = np.abs(w).max()
        if top > 1e-5:
            checked += 1
            assert np.abs(got[k] - w).max() <= GRAD_TOL * top, k
        else:
            assert np.abs(got[k]).max() <= 2e-5, k
    return checked


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_stacks_match_jax(zoo, side):
    """Each stack at 150 tokens / 200 frames with a padded row: the output
    in eval mode ≤ 1e-5, padded rows exactly 0; in train mode (dropout 0)
    the gradient of every stack parameter at a seeded cotangent (and of the
    decoder's input) ≤ 1e-4 of its largest entry."""
    _, mc, _ = zoo.configs
    model = zoo.torch_model()
    mod = getattr(model, side)
    x, mask, cot = zoo.inputs[side]
    want = zoo.res[side]
    mod.eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x).long() if side == "encoder"
                  else torch.from_numpy(x), torch.from_numpy(mask))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]),
                               atol=OUT_TOL, rtol=0)
    assert not got[1, STACK_T[side][1]:].any()

    mod.train()
    xt = (torch.from_numpy(x).long() if side == "encoder"
          else torch.from_numpy(x).requires_grad_(True))
    out = mod(xt, torch.from_numpy(mask))[0]
    names = [n for n, _ in mod.named_parameters()]
    params = [p for _, p in mod.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                params + ([xt] if side == "decoder" else []))
    full = {f"{side}.{n}": g for n, g in zip(names, grads)}
    sd = dict(model.state_dict())
    sd.update(full)
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    got_g = _flat(jax_tree_from_state_dict(sd, mc)["params"][side])
    assert _check_grads(got_g, _flat(want[1])) >= 15
    if side == "decoder":
        top = np.abs(np.asarray(want[2])).max()
        assert np.abs(grads[-1].numpy() - np.asarray(want[2])).max() \
            <= GRAD_TOL * top


def test_model_infer_parity(zoo):
    """The whole model in infer mode (durations predicted, budget 48):
    lengths equal, mel and postnet ≤ 1e-5 of their largest entry."""
    model = zoo.torch_model().eval()
    b = zoo.batch
    want = zoo.res["infer"]
    with torch.no_grad():
        got = model(torch.from_numpy(b["speakers"]).long(),
                    torch.from_numpy(b["texts"]).long(),
                    torch.from_numpy(b["src_lens"]).long(), "infer",
                    max_mel_len=48)
    np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                  np.asarray(want["mel_lens"]))
    for k in ("mel_predictions", "postnet_mel_predictions"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=OUT_TOL * np.abs(w).max())


def test_train_step_matches_jax(zoo):
    """One ``train_unsup`` step in train mode (dropout 0) with every gate
    open: each loss term ≤ 1e-4 relative (absolute below 1),
    the gradient norm ≤ 1e-4 relative, each gradient leaf ≤ 1e-4 of its
    largest entry."""
    _, mc, _ = zoo.configs
    metrics, grads, model = zoo.torch_step()
    want = zoo.res["comps"]
    assert set(metrics) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(metrics[k].item() - w) <= 1e-4 * max(1.0, abs(w)), \
            (k, metrics[k], w)
    got_g = _flat(_grad_tree(model, grads, mc))
    assert _check_grads(got_g, _flat(zoo.res["grads"])) > 60


def test_state_dict_round_trip(zoo):
    """The port's state_dict goes through ``import_reference_checkpoint``
    (the upstream layout) to the JAX tree bit for bit, and
    ``jax_tree_from_state_dict`` gives the same tree."""
    from ctts_tpu.utils.torch_import import import_reference_checkpoint
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    pre, mc, _ = zoo.configs
    sd = zoo.torch_model().state_dict()
    want = _flat(zoo.tree)
    for tree in (import_reference_checkpoint(sd, pre, mc),
                 jax_tree_from_state_dict(sd, mc)):
        got = _flat(tree)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, k)


@pytest.mark.parametrize("zoo", ["fastformer"], indirect=True)
def test_fastformer_tied_logits_are_one_parameter(zoo):
    """The fastformer's ``to_q_attn_logits`` / ``to_k_attn_logits`` are one
    module per stack, held by every layer: one parameter each in
    ``parameters()``, every layer's alias in the state_dict, and one
    gradient, equal to the JAX one (the sum over the layers) to 1e-4."""
    _, grads, model = zoo.torch_step()
    layers = model.encoder.layer_stack.layers
    for name in ("to_q_attn_logits", "to_k_attn_logits"):
        assert getattr(layers[0][0].fn, name) is getattr(layers[1][0].fn,
                                                         name)
        sd = model.state_dict()
        assert all(f"encoder.layer_stack.layers.{i}.0.fn.{name}.weight" in sd
                   for i in range(2))
        named = [n for n, _ in model.named_parameters() if name in n]
        assert named == [f"{side}.layer_stack.layers.0.0.fn.{name}.{leaf}"
                         for side in ("encoder", "decoder")
                         for leaf in ("weight", "bias")]
        by_name = dict(zip((n for n, _ in model.named_parameters()), grads))
        for side in ("encoder", "decoder"):
            g = by_name[f"{side}.layer_stack.layers.0.0.fn.{name}.weight"]
            w = np.asarray(zoo.res["grads"][side]["layer_stack"][name][
                "kernel"]).T
            assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max()


def test_position_helpers_match_jax():
    """The interleaved sinusoid table equals ``_sinusoid_encoding`` at the
    shipped size and past max_seq_len (the decoder does not truncate);
    ``add_positions`` takes max(max_seq_len + 1, T) rows; the rotary
    rotation equals the JAX one in float32 (1e-6) and in bfloat16, where
    the frequencies are rounded before cos and sin, within one bf16 step."""
    from ctts_tpu.models import lstransformer as jls
    from ctts_tpu.models.transformer import _sinusoid_encoding
    from ctts_torch.models.blocks import interleaved_sinusoid_table
    from ctts_torch.models.lstransformer import apply_rotary, rotary_freqs
    from ctts_torch.models.transformer import add_positions
    for n, d in ((1001, 256), (80, 32)):
        np.testing.assert_allclose(interleaved_sinusoid_table(n, d).numpy(),
                                   np.asarray(_sinusoid_encoding(n, d)),
                                   atol=1e-6, rtol=0)
    x = torch.zeros(1, 80, 32)
    np.testing.assert_allclose(add_positions(x, 64, 32)[0].numpy(),
                               np.asarray(_sinusoid_encoding(80, 32)),
                               atol=1e-6, rtol=0)
    t = np.random.RandomState(1).randn(2, 1100, 16).astype(np.float32)
    seq = np.arange(1100, dtype=np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2 ** -6)):
        f = rotary_freqs(torch.from_numpy(seq), 16).to(dt)
        got = apply_rotary(f, torch.from_numpy(t).to(dt)).float().numpy()
        jf = jls.rotary_freqs(jnp.asarray(seq), 16).astype(jdt)
        want = np.asarray(jls.apply_rotary(
            jf, jnp.asarray(t).astype(jdt)).astype(jnp.float32))
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), dt
