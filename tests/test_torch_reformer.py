"""The reformer slice of ctts_torch against the JAX package, on the CPU: the
registry's hidden sizes, the local-window op and the LSH chunk op (against
the jnp reference and the interpret-mode Pallas kernels, values and
gradients), ``lsh_attention`` on both LSH routes, the reformer stacks and
the whole ``CompTransTTS`` with ``block_type: reformer`` in infer mode and
through one ``train_unsup`` step, and the weight bridge both ways.

The model is small (depth 2, width 32, 4 heads of 16: 3 local and 1 LSH,
float32, dropout 0) with buckets of 4, so the 11 tokens pad to 2 windows
and the 40 frames make 5, and the LSH heads see several chunks and the
wrap. Both sides take numpy-drawn, perturbed weights through the weight
bridge; the JAX side's hash rotations are recorded (``jax.random.normal``
patched while its one compiled function is traced) and handed to the port
in the same order. Tolerances are stated in each test.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from test_torch_conformer import _check_grads
from test_torch_train_step import _flat, _init_like, _jbatch, _perturb

B, T_S, T_M = 2, 11, 40
STEP = 59999            # every gate open: every parameter has a gradient


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jnp_paths(monkeypatch):
    """The JAX package's jnp paths unless a test opts into a kernel: no
    interpret mode left over from another module, the fused LSH off."""
    from ctts_tpu.ops import local_window_attention, lsh_chunk_attention, \
        sort_gather
    for m in (sort_gather, local_window_attention, lsh_chunk_attention):
        monkeypatch.setattr(m, "_INTERPRET", False)
    monkeypatch.delenv("CTTS_FUSED_LSH", raising=False)


def _configs():
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["block_type"] = "reformer"
    mc["transformer"].update(encoder_dropout=0.0, decoder_dropout=0.0)
    mc["reformer"].update(depth=2, encoder_head=4, decoder_head=4,
                          bucket_size=4)
    return pre, mc, tr


@pytest.mark.parametrize("block", ["transformer_fs2", "transformer",
                                   "fastformer", "lstransformer",
                                   "conformer", "reformer"])
def test_block_hidden_matches_jax(block):
    """The port's ``block_hidden`` equals the JAX registry's for every
    block type of configs/LJSpeech.yaml (the reformer's section has no
    hidden size and falls back to the transformer's)."""
    from ctts_tpu.models.registry import block_hidden as jax_hidden
    from ctts_torch.config import get_configs_of
    from ctts_torch.models.registry import block_hidden
    mc = dict(get_configs_of("LJSpeech")[1], block_type=block)
    assert block_hidden(mc) == jax_hidden(mc) == (256, 256)


# ---- the ops ------------------------------------------------------------------- #

def _op_inputs(G, N, d, seed):
    """qk, v, a cotangent and validity with holes, and a short row whose
    last 128 positions (all of them at N <= 128) are padding: a fully
    padded window at every window size used here."""
    rng = np.random.RandomState(seed)
    qk, v, cot = (rng.randn(G, N, d).astype(np.float32) for _ in range(3))
    valid = rng.rand(G, N) > 0.15
    valid[0] = True
    valid[-1, max(min(N // 2 + 3, N - 128), 0):] = False
    return qk, v, cot, valid


def _jax_vjp(fn, args, cot):
    """fn's output and its gradients at ``cot``, as one jitted function."""
    def both(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)
    return jax.jit(both)(tuple(map(jnp.asarray, args)), jnp.asarray(cot))


def _torch_vjp(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_grads(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("N,window", [(256, 128), (128, 128), (64, 16)])
def test_local_window_matches_jax_reference(N, window):
    """The plain version against the jnp ``local_attention`` (d=16, f32):
    output ≤ 1e-5, dqk and dv ≤ 1e-4 of their largest entries. N=64 with
    windows of 16 has four windows; the padded rows go uniform."""
    from ctts_tpu.models.reformer import local_attention
    from ctts_torch.ops.local_window_attention import local_window_attention
    qk, v, cot, valid = _op_inputs(3, N, 16, N + window)

    def ref(qk, v):
        return local_attention(qk, v, jnp.asarray(valid), window)

    want, want_g = _jax_vjp(ref, (qk, v), cot)
    got, got_g = _torch_vjp(lambda a, b: local_window_attention(
        a, b, torch.from_numpy(valid), window, 16 ** -0.5), (qk, v), cot)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    _assert_grads(got_g, want_g, 1e-4)


@pytest.mark.parametrize("N", [256, 128])
def test_local_window_matches_pallas_kernel_in_interpret_mode(N, monkeypatch):
    """The Pallas kernel (window 128, interpret mode), forward and its
    backward kernel: the output to 1e-5, the gradients to the JAX test's
    own tolerance against its jnp path (rtol 1e-4, atol 5e-4). The Pallas
    backward also sends dq and dk through the uniform probabilities of a
    padded query row, whose logits are constants in the jnp function (and
    in the port, which follows its autograd gradient, as the test above
    holds); so here the cotangent is zero at padded query rows."""
    from ctts_tpu.ops import local_window_attention as jlw
    from ctts_torch.ops.local_window_attention import local_window_attention
    monkeypatch.setattr(jlw, "_INTERPRET", True)
    assert jlw.supported(N, 128, 16)
    qk, v, cot, valid = _op_inputs(2, N, 16, N)
    cot = cot * valid[..., None]

    def fused(qk, v):
        return jlw.local_window_attention(qk, v, jnp.asarray(valid), 128,
                                          16 ** -0.5)

    want, want_g = _jax_vjp(fused, (qk, v), cot)
    got, got_g = _torch_vjp(lambda a, b: local_window_attention(
        a, b, torch.from_numpy(valid), 128, 16 ** -0.5), (qk, v), cot)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=5e-4)


def _sorted_case(N, d, seed, bucket=64, n_hashes=4):
    """Op inputs with a real hash sort of qk: st, svalid (and sticker)."""
    from ctts_torch.models.reformer import lsh_sort
    qk, v, _, valid = _op_inputs(2, N, d, seed)
    rot = np.random.RandomState(seed + 1).randn(
        1, d, n_hashes, N // bucket // 2).astype(np.float32)
    sticker, st, svalid = lsh_sort(torch.from_numpy(qk),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(rot), bucket, n_hashes)
    return qk, v, valid, rot, st.numpy(), svalid.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("N", [128, 256])
def test_chunk_attention_matches_pallas_kernel_in_interpret_mode(
        N, causal, monkeypatch):
    """The fused chunk kernel (chunks of 64 over 4 rounds, interpret mode)
    against the plain version on one sort: output ‖ logsumexp to 2e-5, and
    dqk, dv under a random cotangent on the output and on the logsumexp to
    3e-5 of their largest entries (the JAX fused-vs-jnp test's
    tolerances). At N=128 there are 8 chunks and chunk 0 wraps to the
    last. A failure names the output entries over the limit with their
    sorted row's position, validity and logsumexp."""
    from ctts_tpu.ops import lsh_chunk_attention as jlc
    from ctts_torch.ops.lsh_chunk_attention import chunk_attention_plain
    monkeypatch.setattr(jlc, "_INTERPRET", True)
    monkeypatch.setenv("CTTS_FUSED_LSH", "1")
    assert jlc.supported(N, 64, 16, 4)
    qk, v, valid, _, st, svalid = _sorted_case(N, 16, N + int(causal))
    cot = np.random.RandomState(9).randn(2, 4 * N, 17).astype(np.float32)

    def fused(qk, v):
        return jlc.chunk_attention(qk, v, jnp.asarray(st), jnp.asarray(svalid),
                                   jnp.asarray(valid), 64, causal, 0.25)

    want, want_g = _jax_vjp(fused, (qk, v), cot)
    got, got_g = _torch_vjp(lambda a, b: chunk_attention_plain(
        a, b, torch.from_numpy(st), torch.from_numpy(svalid), 64, causal,
        0.25), (qk, v), cot)
    want = np.asarray(want)
    over = np.argwhere(np.abs(got - want) > 2e-5 + 2e-5 * np.abs(want))
    where = "; ".join(f"[{g}, {m}, {c}] st {st[g, m]} svalid {svalid[g, m]} "
                      f"lse {want[g, m, -1]}" for g, m, c in over[:20])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5,
                               err_msg=where)
    _assert_grads(got_g, want_g, 3e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_lsh_attention_matches_jax_on_both_routes(fused, monkeypatch):
    """The whole ``lsh_attention`` (sort, chunks, un-sort, round combine)
    with one rotation on both sides, N=256, d=32, 4 rounds: on the default
    route against the JAX jnp path, on the fused route
    (``CTTS_FUSED_LSH=1``) against the JAX interpret-mode sort-gather and
    chunk kernels. Output ≤ 2e-5, dqk and dv ≤ 1e-4 of their largest
    entries."""
    from ctts_tpu.models import reformer as jr
    from ctts_tpu.ops import lsh_chunk_attention as jlc
    from ctts_tpu.ops import sort_gather as jsg
    from ctts_torch.models.reformer import lsh_attention
    if fused:
        monkeypatch.setattr(jlc, "_INTERPRET", True)
        monkeypatch.setattr(jsg, "_INTERPRET", True)
        monkeypatch.setenv("CTTS_FUSED_LSH", "1")
    qk, v, valid, rot, _, _ = _sorted_case(256, 32, 5)
    cot = np.random.RandomState(6).randn(*qk.shape).astype(np.float32)

    def ref(qk, v):
        return jr.lsh_attention(qk, v, jnp.asarray(valid), None, rot=rot)

    want, want_g = _jax_vjp(ref, (qk, v), cot)
    got, got_g = _torch_vjp(lambda a, b: lsh_attention(
        a, b, torch.from_numpy(valid), torch.from_numpy(rot)), (qk, v), cot)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)
    _assert_grads(got_g, want_g, 1e-4)


# ---- the model ------------------------------------------------------------------ #

def _stack_inputs():
    rng = np.random.RandomState(5)
    tokens = rng.randint(1, 300, (B, T_S)).astype(np.int32)
    smask = np.arange(T_S)[None] >= np.array([T_S, 7])[:, None]
    tokens[smask] = 0
    frames = rng.randn(B, T_M, 32).astype(np.float32)
    mmask = np.arange(T_M)[None] >= np.array([T_M, 29])[:, None]
    return dict(tokens=tokens, smask=smask, frames=frames, mmask=mmask)


class _Ref:
    """The JAX reformer model with its weights, the results of one compiled
    function (the stacks and the model in infer mode; one ``train_unsup``
    step with every dropout the identity), the hash rotations it drew (in
    the order drawn: stacks encoder, decoder; infer encoder, decoder; train
    encoder, decoder), and the maker of the port's model from the same
    tree."""

    def __init__(self):
        import flax.linen as nn
        from ctts_tpu.models import reformer as jr
        from ctts_tpu.models.comp_trans_tts import (CompTransTTS,
                                                    prepare_model_config)
        from ctts_tpu.models.loss import compute_loss
        from ctts_tpu.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        pre, mc, tr = _configs()
        mc = prepare_model_config(pre, mc)
        self.configs = (pre, mc, tr)
        jm = CompTransTTS(pre, mc, tr)
        self.batch = synth_batch(B=B, T_s=T_S, T_m=T_M, seed=0)
        self.inputs = _stack_inputs()
        shapes = jax.eval_shape(lambda rng: jm.init(
            {"params": rng}, step=jnp.zeros((), jnp.int32),
            deterministic=True, **self.kwargs(_jbatch(self.batch))),
            jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.tree = _perturb(_init_like(dict(shapes), rng), rng)
        tx, _ = build_optimizer(mc, tr)
        drawn = []
        normal = jr.jax.random.normal

        def record(key, shape, dtype=jnp.float32):
            out = normal(key, shape, dtype)
            if len(shape) == 5:         # a stack's rotations, not an init
                drawn.append(out)
            return out

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
                start = len(drawn)
                out, _ = jm.apply(
                    {"params": p, "batch_stats": stats}, step=step,
                    deterministic=False, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(0)},
                    **self.kwargs(batch))
                total, comps = compute_loss(batch, out, step, pre, mc, tr)
                # the draws of this trace leave it as aux outputs
                return total, (comps, drawn[start:])
            rots = list(drawn)
            (_, (comps, train_rots)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, _ = tx.update(grads, tx.init(params), params)
            comps["grad_norm"] = optax.global_norm(grads)
            res["comps"], res["grads"] = comps, grads
            res["params_after"] = optax.apply_updates(params, updates)
            res["rots"] = rots + list(train_rots)
            return res

        args = (self.tree, _jbatch(self.batch),
                jnp.asarray(STEP + 1, jnp.int32),
                {k: jnp.asarray(v) for k, v in self.inputs.items()})
        orig = nn.Dropout.__call__
        nn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
        try:
            with mock.patch.object(jr.jax.random, "normal", record):
                # the CPU backend's cheaper optimization levels: the same
                # float32 arithmetic, less compile time
                self.res = jax.jit(everything).lower(*args).compile(
                    compiler_options={"xla_backend_optimization_level": 0,
                                      "xla_llvm_disable_expensive_passes":
                                          True})(*args)
        finally:
            nn.Dropout.__call__ = orig
        self.rots = [np.asarray(r) for r in self.res["rots"]]
        assert len(self.rots) == 6

    @staticmethod
    def kwargs(batch):
        return dict(speakers=batch["speakers"], texts=batch["texts"],
                    src_lens=batch["src_lens"], mode="train_unsup",
                    mels=batch["mels"], mel_lens=batch["mel_lens"],
                    pitch_targets=batch["pitch_data"],
                    energy_targets=batch["energies"],
                    attn_priors=batch["attn_priors"])

    def drawing(self, first):
        """Patch the port's rotation draw to hand out the JAX draws from
        index ``first`` on, in order."""
        it = iter(self.rots[first:])
        return mock.patch("ctts_torch.models.reformer._normal",
                          lambda shape, generator, device: torch.tensor(
                              next(it), device=device))

    def torch_model(self):
        from ctts_torch.models.comp_trans_tts import CompTransTTS
        from ctts_torch.utils.weights import state_dict_from_jax
        pre, mc, tr = self.configs
        model = CompTransTTS(pre, mc, tr)
        model.load_state_dict(state_dict_from_jax(self.tree), strict=True)
        return model

    def torch_step(self):
        """The port's train-mode step with every dropout at p=0:
        (metrics, gradients, model, rate)."""
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
        with self.drawing(4):
            metrics = make_train_step(pre, mc, tr, "train_unsup")(
                state, batch_to_device(self.batch, "cpu"))
        assert model.training
        self._step = (metrics, seen["g"], model, sched(0))
        return self._step


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def test_reformer_stacks_in_infer_mode(ref):
    """Encoder (tokens, a padded row; 2 windows) and decoder (random frames;
    5 windows) in eval mode with the JAX rotations: ≤ 1e-4 absolute."""
    model = ref.torch_model().eval()
    x = {k: torch.from_numpy(v) for k, v in ref.inputs.items()}
    with torch.no_grad(), ref.drawing(0):
        got_e, got_emb = model.encoder(x["tokens"], x["smask"])
        got_d, _ = model.decoder(x["frames"], x["mmask"])
    res = ref.res
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(res["emb"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(res["enc"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(res["dec"]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_reformer_stacks_in_train_mode(ref, side):
    """The stacks inside the train-mode step (dropout p=0): every gradient
    leaf of the stack, the tied attention and FF (summed over the depth) and
    each layer's norms, within 1e-3 of its largest entry."""
    from test_torch_train_step import _grad_tree
    _, mc, _ = ref.configs
    _, grads, model, _ = ref.torch_step()
    got = _flat(_grad_tree(model, grads, mc)[side])
    want = _flat(ref.res["grads"][side])
    assert _check_grads(got, want) == len(want) >= 12
    assert any("attn" in k and "toqk" in k for k in want)


def test_reformer_model_infer_parity(ref):
    """The whole model in infer mode (durations predicted, budget 48), the
    JAX rotations: mel and postnet ≤ 1e-3 absolute, lengths equal."""
    model = ref.torch_model().eval()
    b = ref.batch
    want = ref.res["infer"]
    with torch.no_grad(), ref.drawing(2):
        got = model(torch.from_numpy(b["speakers"]).long(),
                    torch.from_numpy(b["texts"]).long(),
                    torch.from_numpy(b["src_lens"]).long(), "infer",
                    max_mel_len=48)
    np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                  np.asarray(want["mel_lens"]))
    for k in ("mel_predictions", "postnet_mel_predictions"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=0)


def test_reformer_train_step_matches_jax(ref):
    """One ``train_unsup`` step in train mode (dropout p=0) with every gate
    open: each loss component ≤ 1e-4 (the gradient norm 1e-3 relative),
    each gradient leaf ≤ 1e-3 of its largest entry (the tied ones
    included), and every parameter after the Adam update within 2e-3 of
    the rate."""
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    from test_torch_train_step import _grad_tree
    _, mc, _ = ref.configs
    res = ref.res
    metrics, grads, model, rate = ref.torch_step()
    want = res["comps"]
    assert set(metrics) == set(want)
    for k, w in want.items():
        tol = 1e-4 if k != "grad_norm" else 1e-3 * float(w)
        assert abs(metrics[k].item() - float(w)) <= tol, (k, metrics[k], w)
    got_g = _flat(_grad_tree(model, grads, mc))
    assert _check_grads(got_g, _flat(res["grads"])) > 60
    got_p = _flat(jax_tree_from_state_dict(model.state_dict(), mc)["params"])
    for k, w in _flat(res["params_after"]).items():
        assert np.abs(got_p[k] - w).max() <= 2e-3 * rate \
            + 2.5e-7 * np.abs(w).max(), k


def test_tied_layers_share_one_parameter(ref):
    """The attention and the FF are one module across depth: the state_dict
    holds them under every layer (as upstream), the parameters once; each
    layer's norms are its own."""
    model = ref.torch_model()
    blocks = model.encoder.layer_stack.net.layers.irrev_blocks
    assert blocks[0].f.fn is blocks[1].f.fn and blocks[0].g.fn is blocks[1].g.fn
    assert blocks[0].f.norm is not blocks[1].f.norm
    sd = model.state_dict()
    assert "encoder.layer_stack.net.layers.irrev_blocks.1.f.fn.toqk.weight" \
        in sd
    names = [n for n, _ in model.named_parameters()]
    assert not any("irrev_blocks.1.f.fn" in n or "irrev_blocks.1.g.fn" in n
                   for n in names)


def test_reformer_state_dict_round_trip(ref):
    """The port's state_dict goes through ``import_reference_checkpoint``
    (the upstream layout) to the JAX tree bit for bit, and
    ``jax_tree_from_state_dict`` gives the same tree."""
    from ctts_tpu.utils.torch_import import import_reference_checkpoint
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    pre, mc, _ = ref.configs
    sd = ref.torch_model().state_dict()
    via_ref = import_reference_checkpoint(sd, pre, mc)
    back = jax_tree_from_state_dict(sd, mc)
    want = _flat(ref.tree)
    for tree in (via_ref, back):
        got = _flat(tree)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, k)


def test_rotations_come_from_the_train_generator(ref):
    """In train mode the rotations are drawn from the module's generator
    (the train state's): one seed, one result; another seed, another. In
    eval mode every forward draws from seed 0, so it repeats."""
    from ctts_torch.models.blocks import set_dropout_generator
    model = ref.torch_model()
    enc = model.encoder
    x = {k: torch.from_numpy(v) for k, v in ref.inputs.items()}
    outs = []
    enc.train()
    for seed in (3, 3, 4):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(enc(x["tokens"], x["smask"])[0])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert enc.layer_stack.net.generator is not None
    enc.eval()
    with torch.no_grad():
        a = enc(x["tokens"], x["smask"])[0]
        b = enc(x["tokens"], x["smask"])[0]
    assert torch.equal(a, b)


def test_init_weights_draws_xavier_attention_projections():
    """``init_weights`` draws the reformer attention's projections
    Xavier-uniform (within ±sqrt(6/(fan_in + fan_out))), the rest from its
    normal rule, and a tied module once."""
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.utils.model import init_weights
    pre, mc, tr = _configs()
    model = init_weights(CompTransTTS(pre, mc, tr), 0)
    attn = model.decoder.layer_stack.net.layers.irrev_blocks[0].f.fn
    for lin in (attn.toqk, attn.tov, attn.to_out):
        fan_out, fan_in = lin.weight.shape
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        w = lin.weight.detach()
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert not attn.to_out.bias.any()
