"""From a raw corpus to a validated checkpoint with ctts_torch on the CPU:
``python -m ctts_torch.preprocess`` writes the store of a corpus the test
writes itself, ``ctts_torch.train`` trains on it with synth previews
(``train/preview.jsonl``), a seeded HiFi-GAN and a ``--profile_steps``
trace, ``ctts_torch.evaluate`` reads its checkpoint back, and the
synthesize CLI writes a PNG beside each wav. Held against the JAX package:
``evaluate``'s means on the port's store, and ``synth_sample_figures``'s
figure names and plotted arrays for ``unsup`` cwt pitch, ``sup`` frame
pitch and liu2021 (``tests/test_figures.py``), one seeded tree carried to
both sides (tiny configs, f32, dropout off)."""

import copy
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from ctts_torch.utils.testing import write_corpus  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides, the same tree: sums in another order
MEANS_RTOL = 1e-5
FIG_TOL = 1e-4
# the vocoders' clips, int16 / 32768: HiFi-GAN within 1e-4 on its tanh
# output (tests/test_torch_vocoder.py) and a step of rounding to int16
AUDIO_TOL = 1e-4 + 1 / 32768


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads_no_tensorboard():
    # torch.utils.tensorboard imports TensorFlow where it is installed (tens
    # of seconds); the loggers then write JSON lines only
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


def _tiny(**kw):
    from ctts_tpu.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs(**kw)
    mc["max_seq_len"] = 256          # the corpus runs to 180 frames
    return pre, mc, tr


def _write_config(cfg_dir, configs):
    """``configs`` as a merged ``LJSpeech.yaml`` under ``cfg_dir``."""
    from ctts_torch.config import dump_yaml, load_yaml
    raw = load_yaml(open(os.path.join(REPO, "configs", "LJSpeech.yaml")))
    pre, mc, tr = copy.deepcopy(configs)
    pre.pop("dataset", None)
    pre["preprocessing"]["pitch"].pop("cwt_scales", None)
    mc.pop("_energy_stats", None)
    raw.update(preprocess=pre, model=mc, train=tr)
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "LJSpeech.yaml"), "w") as f:
        f.write(dump_yaml(raw))
    return cfg_dir


def _save_seed_hifigan(ckpt_dir, mc):
    """HiFi-GAN V1 at seed 0 as the upstream checkpoint ``get_vocoder``
    reads."""
    from ctts_torch.utils.model import get_vocoder
    _, gen = get_vocoder(mc, ckpt_dir=os.path.join(ckpt_dir, "none"),
                         device="cpu", seed=0)
    os.makedirs(os.path.join(ckpt_dir, "hifigan"))
    torch.save({"generator": gen.state_dict()}, os.path.join(
        ckpt_dir, "hifigan", f"generator_{mc['vocoder']['speaker']}.pth.tar"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A corpus of 4 utterances → ``python -m ctts_torch.preprocess
    --device cpu`` (2 for validation) → ``ctts_torch.train.main`` for 2
    steps with a preview every step, validation and a checkpoint at step
    2, steps 1-2 traced, HiFi-GAN V1 at seed 0."""
    from ctts_torch.preprocess import main as preprocess
    from ctts_torch.train import main as train
    root = str(tmp_path_factory.mktemp("corpus_to_ckpt"))
    write_corpus(root, ["LJSpeech"], [1.2, 1.5, 1.8, 2.1], seed=0,
                 spelled=("hello", "world"))
    store = os.path.join(root, "store")
    shutil.copytree(os.path.join(root, "TextGrid"),
                    os.path.join(store, "TextGrid"))
    configs = pre, mc, tr = _tiny()
    mc.pop("_energy_stats")               # read from the store's stats.json
    pre["path"].update(raw_path=os.path.join(root, "raw"),
                       preprocessed_path=store,
                       lexicon_path=os.path.join(root, "lexicon.txt"))
    pre["preprocessing"]["val_size"] = 2
    tr["path"] = {k: os.path.join(root, k) for k in
                  ("ckpt_path", "log_path", "result_path")}
    tr["optimizer"]["batch_size"] = 2
    tr["step"].update(total_step=2, log_step=1, synth_step=1, val_step=2,
                      save_step=2)
    cfg = _write_config(os.path.join(root, "cfg"), configs)
    preprocess(["--dataset", "LJSpeech", "--config_dir", cfg,
                "--device", "cpu"])
    vocoder_dir = os.path.join(root, "vocoder")
    _save_seed_hifigan(vocoder_dir, mc)
    train(["--dataset", "LJSpeech", "--config_dir", cfg, "--device", "cpu",
           "--vocoder_ckpt", vocoder_dir, "--profile_steps", "1:2"])
    return {"root": root, "cfg": cfg, "configs": configs,
            "vocoder": vocoder_dir}


def _jsonl(path):
    return [json.loads(ln) for ln in open(path)]


def test_train_cli_logs_previews_that_ran(run):
    """Both steps log a preview that ran: its figures drawn, and a finite
    wav of mel_len·hop samples from the seeded HiFi-GAN."""
    log = os.path.join(run["configs"][2]["path"]["log_path"], "train")
    recs = _jsonl(os.path.join(log, "preview.jsonl"))
    assert [r["step"] for r in recs] == [1, 2]
    hop = run["configs"][0]["preprocessing"]["stft"]["hop_length"]
    for r in recs:
        assert r["preview"] == "ran", r
        assert set(r["figures"]) == {"mel", "f0", "cwt", "energy", "attn"}
        assert r["wav_finite"] and r["wav_samples"] == r["mel_len"] * hop
        assert r["tensorboard"] is False
    assert "preview: preview: ran" in open(os.path.join(log,
                                                        "log.txt")).read()


def test_profile_steps_write_a_trace(run):
    path = os.path.join(run["configs"][2]["path"]["log_path"], "profile",
                        "steps_1_2.json")
    trace = json.load(open(path))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_evaluate_cli_reads_the_validation_line(run, capsys):
    """``python -m ctts_torch.evaluate --restore_step 2 --device cpu``
    prints the step-2 validation line's means: 4 decimals in its message,
    every digit (within MEANS_RTOL) in its JSON line."""
    from ctts_torch.evaluate import main
    val = _jsonl(os.path.join(run["configs"][2]["path"]["log_path"], "val",
                              "log.jsonl"))
    assert [r["step"] for r in val] == [2]
    capsys.readouterr()
    main(["--dataset", "LJSpeech", "--config_dir", run["cfg"],
          "--restore_step", "2", "--device", "cpu"])
    message, line = capsys.readouterr().out.strip().splitlines()[-2:]
    assert message.startswith("Validation Step 2, mel: ")
    got = json.loads(line)
    assert got["step"] == 2 and got["means"]
    for k, v in got["means"].items():
        assert abs(v - val[0][k]) <= MEANS_RTOL * max(abs(val[0][k]), 1e-3), k


def test_synthesize_cli_writes_a_png(run, tmp_path, monkeypatch, capsys):
    """The synthesize CLI from the step-2 checkpoint writes wav, npy and
    png; without matplotlib it says so once on stderr and writes the
    other two."""
    from ctts_torch.synthesize import main
    argv = ["--mode", "single", "--text", "printing in the only sense",
            "--dataset", "LJSpeech", "--config_dir", run["cfg"],
            "--restore_step", "2", "--vocoder_ckpt",
            str(tmp_path / "none"), "--device", "cpu"]
    main(argv + ["--result_dir", str(tmp_path / "a")])
    assert sorted(f.rsplit(".", 1)[1] for f in os.listdir(tmp_path / "a")) \
        == ["npy", "png", "wav"]
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    main(argv + ["--result_dir", str(tmp_path / "b")])
    assert capsys.readouterr().err.count("matplotlib is not installed") == 1
    assert sorted(f.rsplit(".", 1)[1] for f in os.listdir(tmp_path / "b")) \
        == ["npy", "wav"]


# ---- against the JAX package ------------------------------------------- #

def _jax_tree(jmodel, kwargs):
    """A seeded tree of the JAX model's shapes (``jax.eval_shape``, so no
    init runs): N(0, 1/fan_in) leaves, norm scales near 1, variances
    positive."""
    shapes = jax.eval_shape(lambda key: jmodel.init(
        {"params": key}, **kwargs, step=jnp.asarray(10), deterministic=True),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def draw(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = draw(v)
                continue
            fan_in = max(int(np.prod(v.shape[:-1])), 1) if len(
                v.shape) > 1 else 1
            x = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
            if k in ("scale", "pos_embed_alpha"):
                x = 1.0 + 0.05 * x
            elif k == "var":
                x = np.abs(x) + 0.5
            out[k] = x
        return out
    return draw(dict(shapes))


def _port_model(configs, tree):
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.utils.weights import state_dict_from_jax
    model = CompTransTTS(*configs)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.eval()


def _jax_kwargs(batch, mode):
    return dict(
        speakers=jnp.asarray(batch["speakers"]),
        texts=jnp.asarray(batch["texts"]),
        src_lens=jnp.asarray(batch["src_lens"]), mode=mode,
        mels=jnp.asarray(batch["mels"]),
        mel_lens=jnp.asarray(batch["mel_lens"]),
        pitch_targets={k: jnp.asarray(v)
                       for k, v in batch["pitch_data"].items()},
        energy_targets=jnp.asarray(batch["energies"]),
        duration_targets=(None if batch["durations"] is None
                          else jnp.asarray(batch["durations"])),
        attn_priors=(jnp.asarray(batch["attn_priors"])
                     if mode == "train_unsup" else None))


class _Recorder:
    """A logger that keeps what ``evaluate`` logs: each figure's plotted
    arrays (``_plotted``, read before ``evaluate`` closes the figure), each
    audio clip and the scalars."""

    def __init__(self):
        self.figures, self.clips, self.means = {}, {}, None

    def figure(self, tag, fig, step):
        self.figures[tag] = _plotted(fig)

    def audio(self, tag, wav, step, sampling_rate=None):
        self.clips[tag] = np.asarray(wav)

    def scalars(self, step, losses, lr=None):
        self.means = dict(losses)


def _hifigan_pair(mc):
    """HiFi-GAN V1 at ``upsample_initial_channel`` 32 (float32), one seeded
    tree for both sides: the JAX package's ``(name, module, variables)``
    and the port's ``(name, module)``, as ``get_vocoder`` returns them."""
    from ctts_tpu.vocoder.hifigan import HiFiGANGenerator as JaxGen
    from ctts_tpu.vocoder.hifigan import V1_CONFIG
    from ctts_torch.utils.weights import hifigan_state_dict_from_jax
    from ctts_torch.vocoder.hifigan import HiFiGANGenerator
    cfg = dict(V1_CONFIG, upsample_initial_channel=32)
    jgen = JaxGen(cfg)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(1),
                            jnp.zeros((1, 8, 80), jnp.float32))
    rng = np.random.RandomState(2)
    params = jax.tree.map(
        lambda s: 0.05 * rng.randn(*s.shape).astype(np.float32),
        dict(shapes))
    gen = HiFiGANGenerator(cfg).eval()
    gen.load_state_dict(hifigan_state_dict_from_jax(params), strict=True)
    return ("HiFi-GAN", jgen, params), ("HiFi-GAN", gen)


@pytest.fixture(scope="module")
def evaluated(run):
    """``ctts_torch.evaluate.evaluate`` and the JAX package's ``evaluate``
    on the store ``ctts_torch.preprocess`` wrote, with one seeded tree, a
    recording logger and one seeded HiFi-GAN on each side: {side: (means,
    logger)}."""
    sys.path.insert(0, REPO)
    from evaluate import evaluate as j_evaluate
    from ctts_tpu.data.dataset import Dataset as JDataset
    from ctts_tpu.models.comp_trans_tts import CompTransTTS as JModel
    from ctts_tpu.models.comp_trans_tts import \
        prepare_model_config as j_prepare
    from ctts_tpu.parallel.train_step import TrainState as JState
    from ctts_torch.evaluate import evaluate
    from ctts_torch.parallel.train_step import create_train_state
    from ctts_torch.utils.optimizer import build_optimizer
    pre, mc, tr = run["configs"]
    mc = j_prepare(pre, mc)
    jmodel = JModel(pre, mc, tr)
    batch = next(JDataset("val_unsup.txt", pre, mc, tr, sort=False,
                          drop_last=False).batches(shuffle=False))
    tree = _jax_tree(jmodel, _jax_kwargs(batch, "train_unsup"))
    jstate = JState(step=jnp.asarray(2, jnp.int32), params=tree["params"],
                    batch_stats=tree["batch_stats"], opt_state=None)
    j_vocoder, vocoder = _hifigan_pair(mc)
    out = {"jax": _Recorder(), "port": _Recorder()}
    _, want = j_evaluate(jmodel, jstate, (pre, mc, tr), logger=out["jax"],
                         vocoder=j_vocoder, step=2)
    model = _port_model((pre, mc, tr), tree)
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=2)
    _, got = evaluate(model, state, (pre, mc, tr), logger=out["port"],
                      vocoder=vocoder, step=2)
    import matplotlib.pyplot as plt
    plt.close("all")
    return {"jax": (want, out["jax"]), "port": (got, out["port"])}


def test_evaluate_matches_jax_on_the_ports_store(evaluated):
    """Every component's mean within MEANS_RTOL, returned and logged."""
    (want, jlog), (got, log) = evaluated["jax"], evaluated["port"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= MEANS_RTOL * max(abs(w), 1e-3), (k, got[k],
                                                                   w)
    assert log.means == got and jlog.means == want


def test_evaluate_logs_the_figures_and_audio_of_jax(evaluated):
    """With a logger and a vocoder: the same figure tags as the JAX
    package's ``evaluate``, each with the same plotted arrays within
    FIG_TOL of their scale, and the same audio tags, each clip of the
    same length within AUDIO_TOL."""
    jlog, log = evaluated["jax"][1], evaluated["port"][1]
    assert sorted(log.figures) == sorted(jlog.figures)
    assert any(t.endswith("_attn") for t in log.figures)
    for tag, w in jlog.figures.items():
        g = log.figures[tag]
        assert [a.shape for a in g] == [a.shape for a in w], tag
        for a, b in zip(g, w):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=FIG_TOL * max(1.0, np.abs(b).max()),
                err_msg=tag)
    assert sorted(log.clips) == sorted(jlog.clips) == [
        "Validation/step_2_reconstructed", "Validation/step_2_synth"]
    for tag, w in jlog.clips.items():
        g = log.clips[tag]
        assert g.shape == w.shape and g.size > 0, tag
        np.testing.assert_allclose(g, w, rtol=0, atol=AUDIO_TOL, err_msg=tag)


def _plotted(fig):
    """Every array a figure plots, axis by axis: line y data, images and
    pcolor meshes."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(ln.get_ydata(), np.float64) for ln in ax.lines]
        out += [np.asarray(im.get_array(), np.float64) for im in ax.images]
        out += [np.asarray(c.get_array(), np.float64)
                for c in ax.collections]
    return out


CASES = {
    "unsup_cwt": (dict(energy_feature="frame_level"), "train_unsup",
                  dict()),
    "sup_frame": (dict(learn_alignment=False, pitch_type="frame",
                       energy_feature="frame_level"), "train_sup",
                  dict(sup=True)),
    "liu2021": (dict(prosody="liu2021", energy_feature="frame_level"),
                "train_unsup", dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synth_sample_figures_match_jax(case):
    """The port's ``synth_sample_figures`` on the port's forward and the
    JAX package's on JAX's, one seeded tree: the same figure names, and
    each figure the same plotted arrays within FIG_TOL of their scale."""
    import matplotlib.pyplot as plt
    from ctts_tpu.models.comp_trans_tts import CompTransTTS as JModel
    from ctts_tpu.utils.figures import synth_sample_figures as j_figures
    from ctts_torch.parallel.train_step import _apply, batch_to_device
    from ctts_torch.utils.figures import synth_sample_figures
    from ctts_torch.utils.testing import synth_batch
    cfg_kw, mode, batch_kw = CASES[case]
    configs = pre, mc, tr = _tiny(**cfg_kw)
    batch = synth_batch(**batch_kw)
    jmodel = JModel(pre, mc, tr)
    kwargs = _jax_kwargs(batch, mode)
    tree = _jax_tree(jmodel, kwargs)
    jout, _ = jax.jit(lambda v: jmodel.apply(
        v, mutable=["batch_stats"], **kwargs, step=jnp.asarray(10),
        deterministic=True))(tree)
    model = _port_model(configs, tree)
    tb = batch_to_device(batch, "cpu")
    if mode == "train_sup":
        tb["attn_priors"] = None
    with torch.no_grad():
        out = _apply(model, tb, mode, 10)
    want, want_attn = j_figures(batch, jout, pre, mc)
    got, got_attn = synth_sample_figures(tb, out, pre, mc)
    assert sorted(got) == sorted(want)
    assert (got_attn is None) == (want_attn is None)
    if want_attn is not None:
        got["attn"], want["attn"] = got_attn, want_attn
    if case == "liu2021":
        assert len(got["mel"].axes) == 3          # the prosody alignment
    for name in want:
        g, w = _plotted(got[name]), _plotted(want[name])
        assert [a.shape for a in g] == [a.shape for a in w], name
        for a, b in zip(g, w):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=FIG_TOL * max(1.0, np.abs(b).max()),
                err_msg=name)
    plt.close("all")
