"""ctts_torch modules and the whole inference model against the JAX package.

One tiny JAX CompTransTTS (``tiny_configs()``, 2 encoder and 2 decoder
layers, float32) is initialized, its weights are perturbed with numpy noise
(so no scale is 1 and no bias or running statistic 0) and moved into the
port through ``state_dict_from_jax``. Every module is then fed the same
numpy inputs on both sides. Tolerances: float32 everywhere, so 1e-4 absolute
covers reassociation; durations, mel lengths and mel2ph must be equal.
Also: the trained-weights probe on ``assets/ljdemo_ckpt.npz`` on the CPU,
held to the manifest's tolerances.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T_S, T_M, BUDGET = 2, 11, 40, 64
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs several workers on a few cores: keep torch's intra-op
    # pool small so these tests do not starve the others
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init_like(shapes, rng, path=()):
    """Parameters of the shapes of a JAX init, drawn with numpy (compiling
    the JAX init took most of this file's time): norm scales, variances and
    alphas 1, biases and means 0, embeddings N(0, 1/width), kernels
    N(0, 1/fan_in)."""
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


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, torch model, configs)."""
    from ctts_tpu.models.comp_trans_tts import (CompTransTTS,
                                                prepare_model_config)
    from ctts_tpu.utils.testing import synth_batch, tiny_configs
    from ctts_torch.models.comp_trans_tts import CompTransTTS as TorchModel
    from ctts_torch.utils.weights import state_dict_from_jax

    pre, mc, tr = tiny_configs()
    mc["transformer_fs2"]["encoder_layer"] = 2
    mc["transformer_fs2"]["decoder_layer"] = 2
    mc = prepare_model_config(pre, mc)
    jmodel = CompTransTTS(pre, mc, tr)
    b = synth_batch(B=B, T_s=T_S, T_m=T_M)
    # a train_unsup init holds every parameter of the model, the aligner
    # included (an infer-mode init does not create it)
    shapes = jax.eval_shape(lambda rng: jmodel.init(
        {"params": rng}, speakers=b["speakers"], texts=b["texts"],
        src_lens=b["src_lens"], mode="train_unsup", mels=b["mels"],
        mel_lens=b["mel_lens"], pitch_targets=b["pitch_data"],
        energy_targets=b["energies"], attn_priors=b["attn_priors"],
        step=jnp.zeros((), jnp.int32), deterministic=True),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tree = _perturb(_init_like(dict(shapes), rng), rng)
    # durations around 3-4 frames, so the budget holds whole utterances
    tree["params"]["variance_adaptor"]["duration_predictor"]["linear"][
        "bias"] = np.full((1,), 1.4, np.float32)
    tmodel = TorchModel(pre, mc, tr)
    tmodel.load_state_dict(state_dict_from_jax(tree), strict=True)
    tmodel.eval()
    return jmodel, tree, tmodel, (pre, mc, tr)


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    src_lens = np.asarray([T_S, T_S - 4], np.int32)
    texts = np.zeros((B, T_S), np.int32)
    for i, n in enumerate(src_lens):
        texts[i, :n] = rng.randint(1, 300, n)
    return texts, src_lens, rng


def _mask(lens, T):
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_encoder_parity(pair):
    jmodel, tree, tmodel, _ = pair
    texts, src_lens, _ = _inputs()
    mask = _mask(src_lens, T_S)
    jx, jemb = jmodel.bind(tree).encoder(jnp.asarray(texts),
                                         jnp.asarray(mask))
    with torch.no_grad():
        tx, temb = tmodel.encoder(torch.from_numpy(texts).long(),
                                  torch.from_numpy(mask))
    _close(tx, jx)
    _close(temb, jemb)


def test_decoder_parity(pair):
    jmodel, tree, tmodel, _ = pair
    rng = np.random.RandomState(2)
    x = rng.randn(B, BUDGET, 32).astype(np.float32)
    mask = _mask([BUDGET - 3, 29], BUDGET)
    jy, _ = jmodel.bind(tree).decoder(jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        ty, _ = tmodel.decoder(torch.from_numpy(x), torch.from_numpy(mask))
    _close(ty, jy)


def test_postnet_parity(pair):
    jmodel, tree, tmodel, _ = pair
    x = np.random.RandomState(3).randn(B, 24, 80).astype(np.float32)
    jy = jmodel.bind(tree).postnet(jnp.asarray(x), training=False)
    with torch.no_grad():
        ty = tmodel.postnet(torch.from_numpy(x))
    _close(ty, jy)


@pytest.mark.parametrize("name", ["duration_predictor", "energy_predictor",
                                  "cwt_predictor", "cwt_stats_layers"])
def test_predictor_parity(pair, name):
    jmodel, tree, tmodel, _ = pair
    rng = np.random.RandomState(4)
    x = rng.randn(B, T_S, 32).astype(np.float32)
    mask = _mask([T_S, 6], T_S)
    jva = jmodel.bind(tree).variance_adaptor
    tva = tmodel.variance_adaptor
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        if name == "cwt_predictor":
            want = jva.cwt_predictor(jva.cwt_in_proj(jnp.asarray(x)),
                                     jnp.asarray(mask))
            proj, pred = tva.cwt_predictor
            got = pred(proj(xt), mt)
        elif name == "cwt_stats_layers":
            want = jva.cwt_stats_layers(jnp.asarray(x[:, 0]))
            got = tva.cwt_stats_layers(xt[:, 0])
        else:
            want = getattr(jva, name)(jnp.asarray(x), jnp.asarray(mask))
            got = getattr(tva, name)(xt, mt)
    _close(got, want)


@pytest.mark.parametrize("controls", [(1.0, 1.0, 1.0), (1.2, 0.8, 1.5)])
def test_variance_adaptor_infer_parity(pair, controls):
    jmodel, tree, tmodel, _ = pair
    p, e, d = controls
    rng = np.random.RandomState(5)
    x = rng.randn(B, T_S, 32).astype(np.float32)
    src_lens = np.asarray([T_S, 7], np.int32)
    mask = _mask(src_lens, T_S)
    want = jmodel.bind(tree).variance_adaptor(
        jnp.asarray(x), None, jnp.asarray(src_lens), jnp.asarray(mask),
        "infer", max_mel_len=BUDGET, p_control=p, e_control=e, d_control=d)
    with torch.no_grad():
        got = tmodel.variance_adaptor(torch.from_numpy(x),
                                      torch.from_numpy(mask), "infer",
                                      BUDGET, p_control=p, e_control=e,
                                      d_control=d)
    for key in ("duration_rounded", "mel_len", "mel2ph"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert int(got["mel_len"].min()) > 0
    _close(got["log_duration_prediction"], want["log_duration_prediction"])
    _close(got["energy_prediction"], want["energy_prediction"])
    _close(got["pitch_predictions"]["cwt"], want["pitch_predictions"]["cwt"])
    np.testing.assert_allclose(got["pitch_predictions"]["f0_denorm"].numpy(),
                               np.asarray(want["pitch_predictions"]["f0_denorm"]),
                               rtol=1e-4, atol=1e-3)
    _close(got["x"], want["x"])


@pytest.mark.parametrize("controls", [(1.0, 1.0, 1.0), (0.9, 1.1, 0.7)])
def test_whole_model_infer_parity(pair, controls):
    jmodel, tree, tmodel, _ = pair
    p, e, d = controls
    texts, src_lens, _ = _inputs(seed=6)
    want = jmodel.apply(tree, speakers=jnp.zeros(B, jnp.int32),
                        texts=jnp.asarray(texts),
                        src_lens=jnp.asarray(src_lens), mode="infer",
                        max_mel_len=BUDGET, p_control=p, e_control=e,
                        d_control=d, deterministic=True)
    with torch.no_grad():
        got = tmodel(torch.zeros(B, dtype=torch.long),
                     torch.from_numpy(texts).long(),
                     torch.from_numpy(src_lens), "infer", max_mel_len=BUDGET,
                     p_control=p, e_control=e, d_control=d)
    np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                  np.asarray(want["mel_lens"]))
    np.testing.assert_array_equal(got["mel2ph"].numpy(),
                                  np.asarray(want["mel2ph"]))
    assert int(got["mel_lens"].min()) > 0
    _close(got["mel_predictions"], want["mel_predictions"])
    _close(got["postnet_mel_predictions"], want["postnet_mel_predictions"])


def test_state_dict_round_trip_through_import_reference_checkpoint(pair):
    """The port's parameter names are upstream's: the JAX package's importer
    of upstream checkpoints maps a port state_dict back to the same tree,
    the aligner included, and so does the port's own inverse bridge."""
    from ctts_tpu.utils.torch_import import import_reference_checkpoint
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    _, tree, tmodel, (pre, mc, _) = pair
    assert "aligner" in tree["params"]["variance_adaptor"]
    back = import_reference_checkpoint(tmodel.state_dict(), pre, mc)
    own = dict(jax.tree_util.tree_flatten_with_path(
        jax_tree_from_state_dict(tmodel.state_dict(), mc))[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_w.keys() == flat_b.keys()
    assert flat_w.keys() == own.keys()
    for k, v in flat_w.items():
        np.testing.assert_array_equal(flat_b[k], v, err_msg=str(k))
        np.testing.assert_array_equal(own[k], v, err_msg=str(k))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_trained_checkpoint_probe_on_cpu(compute_dtype):
    """assets/ljdemo_ckpt.npz through the port on the CPU reproduces the
    manifest (tolerances of tests/test_checkpoint_pack.py:155-159)."""
    from ctts_torch.config import get_configs_of
    from ctts_torch.synthesize import infer_mels
    from ctts_torch.utils.model import get_model
    with open(os.path.join(REPO, "assets", "ljdemo_ckpt_manifest.json")) as f:
        probe = json.load(f)["probe"]
    configs = get_configs_of("LJSpeech")
    configs[1]["compute_dtype"] = compute_dtype
    model = get_model(0, configs, device="cpu",
                      packed_ckpt=os.path.join(REPO, "assets",
                                               "ljdemo_ckpt.npz"))
    batch = {"speakers": np.zeros(4, np.int64),
             "texts": np.asarray(probe["texts"]),
             "src_lens": np.asarray(probe["src_lens"])}
    out = infer_mels(model, batch, configs, max_mel_len=probe["budget"])
    mel = out["postnet_mel_predictions"].numpy()
    mel_lens = out["mel_lens"].numpy()
    want = np.asarray(probe["expect_mel_lens"])
    assert np.all(np.abs(mel_lens - want) <= np.maximum(0.05 * want, 3)), \
        (mel_lens, want)
    for i, want_mean in enumerate(probe["expect_mel_mean"]):
        got = float(mel[i, :mel_lens[i]].mean())
        assert abs(got - want_mean) < 0.1, (i, got, want_mean)
    if compute_dtype == "bfloat16":
        # the two-pass budget of the CLI lands on the same lengths (checked
        # at the shipped dtype only: two more full-size CPU forwards)
        out2 = infer_mels(model, batch, configs)
        np.testing.assert_array_equal(out2["mel_lens"].numpy(), mel_lens)
