"""The multi-speaker acoustic model of ctts_torch (the VCTK recipe's) against
the JAX package, on the CPU, in both embedder modes: a speaker table
(``speaker_embedder: none``, indexed by ``speakers``) and the projection of
external 512-d embeddings (``DeepSpeaker``, from ``spker_embeds``). For each,
the whole ``CompTransTTS`` in infer mode and through one ``train_unsup``
step: every loss term and every gradient leaf, those of ``speaker_emb`` and
the aligner's ``key_spk_proj`` / ``query_spk_proj`` among them. Then the
loop and the CLIs on a tiny multi-speaker store the test writes itself:
``ctts_torch.train`` for two steps with the device cache, and
``python -m ctts_torch.synthesize --speaker_id`` on its checkpoint for two
speakers.

The model is ``tiny_configs()`` (fs2, one layer, width 32, float32, dropout
0 on both sides) with ``multi_speaker: True``, numpy-drawn perturbed
weights through the weight bridge; each mode's JAX results come from one
compiled function. Tolerances: outputs 1e-5 of their largest entry,
gradients 1e-4 of each leaf's largest entry.
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
import optax

from test_torch_block_zoo import _check_grads
from test_torch_train_step import (_flat, _grad_tree, _init_like, _jbatch,
                                   _perturb)

B, T_S, T_M = 3, 11, 40
STEP = 59999
EXT_DIM = 512
SPEAKERS = ("p225", "p226", "p227")


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


def _configs(embedder, store=None):
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["multi_speaker"] = True
    mc["external_speaker_dim"] = EXT_DIM
    mc["transformer_fs2"].update(encoder_dropout=0.0, decoder_dropout=0.0)
    pre["preprocessing"]["speaker_embedder"] = embedder
    pre["path"]["preprocessed_path"] = store or "/nonexistent/store"
    return pre, mc, tr


def _batch():
    from ctts_torch.utils.testing import synth_batch
    batch = synth_batch(B=B, T_s=T_S, T_m=T_M, seed=0)
    rng = np.random.RandomState(3)
    batch["speakers"] = np.array([1, 3, 0], np.int32)
    batch["spker_embeds"] = rng.randn(B, EXT_DIM).astype(np.float32)
    return batch


class _Spk:
    """One embedder mode: the JAX model, its weights, and the results of one
    compiled function (infer, and one ``train_unsup`` step with every
    dropout the identity)."""

    def __init__(self, embedder):
        import flax.linen as nn
        from ctts_tpu.models.comp_trans_tts import (CompTransTTS,
                                                    prepare_model_config)
        from ctts_tpu.models.loss import compute_loss
        pre, mc, tr = _configs(embedder)
        mc = prepare_model_config(pre, mc)
        self.configs = (pre, mc, tr)
        jm = CompTransTTS(pre, mc, tr)
        self.batch = _batch()
        shapes = jax.eval_shape(lambda rng: jm.init(
            {"params": rng}, step=jnp.zeros((), jnp.int32),
            deterministic=True, **self.kwargs(_jbatch(self.batch))),
            jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.tree = _perturb(_init_like(dict(shapes), rng), rng)

        def everything(tree, batch, step):
            params = tree["params"]
            infer = jm.apply(tree, batch["speakers"], batch["texts"],
                             batch["src_lens"], "infer", max_mel_len=48,
                             spker_embeds=batch["spker_embeds"])
            res = {"infer": {k: infer[k] for k in (
                "mel_lens", "mel_predictions", "postnet_mel_predictions")}}

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

        args = (self.tree, _jbatch(self.batch),
                jnp.asarray(STEP + 1, jnp.int32))
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
                    attn_priors=batch["attn_priors"],
                    spker_embeds=batch["spker_embeds"])

    def torch_model(self):
        from ctts_torch.models.comp_trans_tts import CompTransTTS
        from ctts_torch.utils.weights import state_dict_from_jax
        pre, mc, tr = self.configs
        model = CompTransTTS(pre, mc, tr)
        model.load_state_dict(state_dict_from_jax(self.tree), strict=True)
        return model


@pytest.fixture(scope="module", params=["none", "DeepSpeaker"])
def spk(request):
    return _Spk(request.param)


def test_speaker_modules_and_bridge(spk):
    """The speaker module is a table of 4 (no speakers.json) or a Linear of
    the 512-d embeddings; the aligner holds both projections; the state_dict
    maps to the JAX tree bit for bit through ``import_reference_checkpoint``
    and ``jax_tree_from_state_dict``."""
    from ctts_tpu.utils.torch_import import import_reference_checkpoint
    from ctts_torch.utils.weights import jax_tree_from_state_dict
    pre, mc, _ = spk.configs
    model = spk.torch_model()
    if pre["preprocessing"]["speaker_embedder"] == "none":
        assert isinstance(model.speaker_emb, torch.nn.Embedding)
        assert tuple(model.speaker_emb.weight.shape) == (4, 32)
    else:
        assert tuple(model.speaker_emb.weight.shape) == (32, EXT_DIM)
    al = model.variance_adaptor.aligner
    assert al.key_spk_proj.linear.bias is None
    assert tuple(al.query_spk_proj.linear.weight.shape) == (80, 32)
    sd = model.state_dict()
    want = _flat(spk.tree)
    for tree in (import_reference_checkpoint(sd, pre, mc),
                 jax_tree_from_state_dict(sd, mc)):
        got = _flat(tree)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, k)


def test_infer_parity(spk):
    """Infer at budget 48 with three speakers: lengths equal, mel and
    postnet ≤ 1e-5 of their largest entry; another speaker gives another
    mel."""
    model = spk.torch_model().eval()
    b = spk.batch
    want = spk.res["infer"]

    def run(speakers, embeds):
        with torch.no_grad():
            return model(torch.from_numpy(speakers).long(),
                         torch.from_numpy(b["texts"]).long(),
                         torch.from_numpy(b["src_lens"]).long(), "infer",
                         max_mel_len=48, spker_embeds=torch.from_numpy(embeds))
    got = run(b["speakers"], b["spker_embeds"])
    np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                  np.asarray(want["mel_lens"]))
    for k in ("mel_predictions", "postnet_mel_predictions"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    other = run(b["speakers"][::-1].copy(), b["spker_embeds"][::-1].copy())
    assert not torch.allclose(other["mel_predictions"][0],
                              got["mel_predictions"][0])


def test_train_step_matches_jax(spk):
    """One ``train_unsup`` step in train mode (dropout 0), every gate open:
    each loss term ≤ 1e-4 relative (absolute below 1), every gradient leaf
    ≤ 1e-4 of its largest entry, those of the speaker module and of the
    aligner's two speaker projections non-zero among them."""
    from ctts_torch.models.blocks import Dropout
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.optimizer import build_optimizer
    pre, mc, tr = spk.configs
    model = spk.torch_model()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=STEP)
    seen = {}
    update = opt.update

    def keep(grads):
        seen["g"] = [g.clone() for g in grads]
        return update(grads)

    opt.update = keep
    metrics = make_train_step(pre, mc, tr, "train_unsup")(
        state, batch_to_device(spk.batch, "cpu"))
    want = spk.res["comps"]
    assert set(metrics) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(metrics[k].item() - w) <= 1e-4 * max(1.0, abs(w)), k
    got = _flat(_grad_tree(model, seen["g"], mc))
    want_g = _flat(spk.res["grads"])
    assert _check_grads(got, want_g) > 40
    spk_keys = [k for k in want_g if "speaker_emb" in k or "spk_proj" in k]
    table = pre["preprocessing"]["speaker_embedder"] == "none"
    assert len(spk_keys) == (3 if table else 4)      # a Dense has a bias
    for k in spk_keys:
        assert np.abs(want_g[k]).max() > 1e-5, k


# ---- the loop and the CLIs on a tiny multi-speaker store ------------------- #

def write_store(root, n_utts=6):
    """A tiny ``unsup`` store of three speakers: speakers.json, each
    speaker's 512-d ``spker_embed`` file, 8-13 phones and 30-59 frames an
    utterance, CWT pitch and frame energy, the same lines for train and
    val."""
    rng = np.random.RandomState(0)
    dirs = ("mel_unsup", "pitch_unsup", "f0_unsup", "energy_unsup_frame",
            "cwt_spec_unsup", "f0cwt_mean_std_unsup", "spker_embed")
    for d in dirs:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for spk in SPEAKERS:
        np.save(os.path.join(root, "spker_embed", f"{spk}-spker_embed.npy"),
                rng.randn(1, EXT_DIM).astype(np.float32))
    lines = []
    for i in range(n_utts):
        spk, base = SPEAKERS[i % len(SPEAKERS)], f"utt{i:03d}"
        T_s, T_m = int(rng.randint(8, 14)), int(rng.randint(30, 60))
        f0 = np.abs(rng.randn(T_m)).astype(np.float32) * 40 + 150
        f0[rng.rand(T_m) < 0.2] = 0.0
        arrays = {
            "mel_unsup/{s}-mel-{b}": rng.randn(T_m, 80).astype(
                np.float32) * 0.5 - 4,
            "pitch_unsup/{s}-pitch-{b}": np.clip(f0 / 4, 1, 255).astype(
                np.int64),
            "f0_unsup/{s}-f0-{b}": f0,
            "energy_unsup_frame/{s}-energy-{b}": rng.rand(T_m).astype(
                np.float32) * 8 - 1,
            "cwt_spec_unsup/{s}-cwt_spec-{b}": rng.randn(T_m, 10).astype(
                np.float32),
            "f0cwt_mean_std_unsup/{s}-f0cwt_mean_std-{b}": np.array(
                [5.3, 0.2], np.float32)}
        for name, a in arrays.items():
            np.save(os.path.join(root, name.format(s=spk, b=base) + ".npy"),
                    a)
        text = "{" + " ".join(rng.choice(["HH", "AH0", "L", "OW1"], T_s)) + "}"
        lines.append(f"{base}|{spk}|{text}|hello")
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}_unsup.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "speakers.json"), "w") as f:
        json.dump({s: i for i, s in enumerate(SPEAKERS)}, f)
    with open(os.path.join(root, "stats.json"), "w") as f:
        json.dump({"f0_unsup": [214.2, 63.4],
                   "energy_unsup_frame": [-1.17, 9.09, 37.2, 31.7]}, f)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two ``train_unsup`` steps of the DeepSpeaker model on the store
    through ``ctts_torch.train.train`` with the device cache, validating
    and saving at step 2."""
    from ctts_torch.train import train
    store = str(tmp_path_factory.mktemp("vctk_store"))
    write_store(store)
    out = str(tmp_path_factory.mktemp("vctk_run"))
    pre, mc, tr = _configs("DeepSpeaker", store)
    pre["path"]["lexicon_path"] = os.path.join(store, "no_lexicon.txt")
    tr["path"] = {k: os.path.join(out, k) for k in
                  ("ckpt_path", "log_path", "result_path")}
    tr["optimizer"]["batch_size"] = 3
    tr["device_cache_mb"] = 64
    tr["on_device_prior"] = True                # the store has no priors
    tr["step"].update(total_step=2, log_step=1, val_step=2, save_step=2)
    mc.pop("_energy_stats")
    configs = (pre, mc, tr)
    state = train(copy.deepcopy(configs), max_steps=2, device="cpu")
    return state, configs


def test_train_loop_carries_speaker_embeddings(trained):
    """The loop ran two finite steps and validated; the external
    embeddings reached the model: its ``speaker_emb`` and aligner
    projections moved from their seeded start."""
    from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                  prepare_model_config)
    from ctts_torch.utils.model import init_weights
    state, (pre, mc, tr) = trained
    assert state.step == 2
    log = [json.loads(ln) for ln in open(os.path.join(
        tr["path"]["log_path"], "train", "log.jsonl"))]
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["total"]) for r in log)
    assert os.path.exists(os.path.join(tr["path"]["log_path"], "val",
                                       "log.jsonl"))
    start = init_weights(CompTransTTS(pre, prepare_model_config(pre, mc), tr),
                         tr["seed"]).state_dict()
    now = state.model.state_dict()
    for k in ("speaker_emb.weight",
              "variance_adaptor.aligner.key_spk_proj.linear.weight",
              "variance_adaptor.aligner.query_spk_proj.linear.weight"):
        assert not torch.equal(now[k], start[k]), k


def test_synthesize_cli_takes_speaker_id(trained, tmp_path):
    """``python -m ctts_torch.synthesize --speaker_id`` on the step-2
    checkpoint with a merged VCTK config: a wav and a finite mel per run;
    two speakers give different mels, one speaker's run repeats bit for
    bit; an unknown speaker raises."""
    from ctts_torch.config import dump_yaml, load_yaml
    from ctts_torch.synthesize import main
    _, configs = trained
    raw = load_yaml(open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "VCTK.yaml")))
    pre, mc, tr = copy.deepcopy(configs)
    pre.pop("dataset", None)
    raw.update(preprocess=pre, model=mc, train=tr)
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "VCTK.yaml").write_text(dump_yaml(raw))

    def run(speaker, name):
        out = tmp_path / name
        main(["--mode", "single", "--text", "hello", "--dataset", "VCTK",
              "--config_dir", str(cfg_dir), "--restore_step", "2",
              "--speaker_id", speaker, "--vocoder_ckpt",
              str(tmp_path / "none"), "--device", "cpu",
              "--result_dir", str(out)])
        files = sorted(os.listdir(out))
        assert [f for f in files if f.endswith(".wav")], files
        mel = np.load(out / next(f for f in files if f.endswith(".npy")))
        assert mel.ndim == 2 and mel.shape[1] == 80
        assert np.isfinite(mel).all()
        return mel

    a, b, a2 = run("p225", "a"), run("p227", "b"), run("p225", "a2")
    np.testing.assert_array_equal(a, a2)
    assert a.shape != b.shape or not np.array_equal(a, b)
    with pytest.raises(ValueError, match="speakers.json"):
        run("nobody", "c")
