"""ctts_torch's loaders and boundaries: the numpy-only npz loader against
the JAX package's, the YAML-subset reader against ``yaml.safe_load``, the
text frontend's symbol table, import isolation (no jax, ctts_tpu, yaml,
ml_dtypes or matplotlib), the device policy, and the CLI on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "assets", "ljdemo_ckpt.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs several workers on a few cores: keep torch's intra-op
    # pool small so these tests do not starve the others
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def test_npz_loader_bit_equal_to_jax_package():
    from ctts_tpu.utils.checkpoint import load_params_npz as j_load
    from ctts_torch.utils.checkpoint import load_params_npz
    got, step = load_params_npz(NPZ)
    want, want_step = j_load(NPZ)
    assert step == want_step == 13301
    g, w = dict(_flatten(got)), dict(_flatten(want))
    assert g.keys() == w.keys()
    for k, v in w.items():
        assert g[k].dtype == v.dtype, k
        np.testing.assert_array_equal(g[k].view(np.uint32)
                                      if g[k].dtype == np.float32 else g[k],
                                      v.view(np.uint32)
                                      if v.dtype == np.float32 else v)


@pytest.mark.parametrize("name", ["LJSpeech", "VCTK"])
def test_yaml_subset_reader_equals_safe_load(name):
    from ctts_torch.config import load_yaml
    with open(os.path.join(REPO, "configs", name + ".yaml")) as f:
        text = f.read()
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("snippet", [
    "a: 1\nb:\n  c: [1, [2, 3], 'x, y']   # trailing\n  d: ~\n",
    "x: -1.5e+3\ny: .5\nz: 1_000\nw: Yes\nv: OFF\nu: \"q#r\"\nt: 1e-9\n",
    "k: null\nlist: []\ns: plain text here\nn: -0\n"])
def test_yaml_subset_reader_scalars(snippet):
    from ctts_torch.config import load_yaml
    assert load_yaml(snippet) == yaml.safe_load(snippet)


def test_configs_match_jax_package():
    from ctts_tpu.config import get_configs_of as j_get
    from ctts_torch.config import get_configs_of
    for got, want in zip(get_configs_of("LJSpeech"), j_get("LJSpeech")):
        gs = {k: v for k, v in _flatten(got)}
        ws = {k: v for k, v in _flatten(want)}
        assert gs.keys() == ws.keys()
        for k in ws:
            np.testing.assert_array_equal(gs[k], ws[k])


def test_text_frontend_matches_jax_package():
    from ctts_tpu.text import text_to_sequence as j_seq
    from ctts_tpu.text.symbols import symbols as j_symbols
    from ctts_torch.text import text_to_sequence
    from ctts_torch.text.symbols import symbols
    assert symbols == j_symbols
    for text in ("Dr. Smith paid $3.50 on the 2nd of May, 1984!",
                 "{HH AH0 L OW1} world", "naïve café"):
        assert text_to_sequence(text, ["english_cleaners"]) == \
            j_seq(text, ["english_cleaners"])


def test_imports_need_no_jax_yaml_or_ml_dtypes():
    """Every ctts_torch module (the conformer, the reformer and its two ops,
    the data pipeline, the train CLI, the server, the streaming vocoder,
    MelGAN, the flip tool and the CRF and SSIM ops included) and
    chip_smoke.py import
    with jax, ctts_tpu, yaml, ml_dtypes, matplotlib, flax and orbax
    blocked."""
    code = r"""
import importlib, os, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "ctts_tpu", "yaml", "ml_dtypes",
             "matplotlib", "orbax"):
    sys.modules[name] = None
import ctts_torch
mods = ["ctts_torch"] + [m.name for m in pkgutil.walk_packages(
    ctts_torch.__path__, "ctts_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "ctts_tpu",
       "yaml", "ml_dtypes", "matplotlib") and sys.modules[m] is not None]
assert not bad, bad
print(" ".join(mods), len(mods))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert int(names[-1]) >= 35
    for new in ("ops.mas", "ops.forward_sum", "ops.segment", "ops.attn_prior",
                "models.aligner", "models.loss", "utils.optimizer",
                "utils.testing", "parallel.train_step",
                "ops.relpos_attention", "models.conformer", "data.dataset",
                "data.device_cache", "utils.checkpoint", "utils.logging",
                "train", "models.reformer", "ops.local_window_attention",
                "ops.lsh_chunk_attention", "ops.fused_resblock", "serve",
                "vocoder.streaming", "vocoder.melgan", "ops.flip",
                "tools.bench_flip", "ops.crf", "ops.ssim"):
        assert f"ctts_torch.{new}" in names, new


def test_packed_checkpoint_carries_the_aligner():
    """npz → state_dict brings the aligner's ten tensors under the upstream
    names, and the whole dict loads strictly into the model."""
    from ctts_torch.config import get_configs_of
    from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                  prepare_model_config)
    from ctts_torch.utils.checkpoint import load_params_npz
    from ctts_torch.utils.weights import state_dict_from_jax
    tree, _ = load_params_npz(NPZ)
    sd = state_dict_from_jax(tree)
    aligner = {k: v for k, v in sd.items() if ".aligner." in k}
    assert sorted(aligner) == sorted(
        f"variance_adaptor.aligner.{name}.{slot}.conv.{leaf}"
        for name, slots in (("key_proj", (0, 2)), ("query_proj", (0, 2, 4)))
        for slot in slots for leaf in ("weight", "bias"))
    assert aligner["variance_adaptor.aligner.key_proj.0.conv.weight"].shape \
        == (512, 256, 3)
    assert aligner["variance_adaptor.aligner.query_proj.4.conv.weight"].shape \
        == (80, 80, 1)
    assert all(float(v.abs().sum()) > 0 for v in aligner.values())
    pre, mc, tr = get_configs_of("LJSpeech")
    model = CompTransTTS(pre, prepare_model_config(pre, mc), tr)
    model.load_state_dict(sd, strict=True)


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    from ctts_torch import resolve_device
    from ctts_torch.config import get_configs_of
    from ctts_torch.utils.model import get_model, get_vocoder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    configs = get_configs_of("LJSpeech")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(0, configs)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_vocoder(configs[1], seed=0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_options_raise(tmp_path):
    from ctts_torch.models.registry import get_block
    from ctts_torch.config import get_configs_of
    from ctts_torch.utils.model import get_model
    with pytest.raises(NotImplementedError, match="unknown block_type"):
        get_block("performer")
    configs = get_configs_of("LJSpeech")
    configs[2]["path"]["ckpt_path"] = str(tmp_path)
    with pytest.raises(FileNotFoundError):     # no checkpoint at step 5
        get_model(5, configs, device="cpu")
    # a JAX parameter tree with a subtree the port has no module for
    from ctts_torch.utils.weights import state_dict_from_jax
    with pytest.raises(NotImplementedError, match="no module in ctts_torch"):
        state_dict_from_jax({"params": {"encoder": {}, "performer": {}}})


@pytest.mark.parametrize("B", [1, 3])
def test_attention_gets_contiguous_heads(B, monkeypatch):
    """The kernel takes contiguous [B·H, T, d] tensors; the fold must give
    them for every batch size (a batch of 1 made a strided view once)."""
    from ctts_torch.models.blocks import MultiHeadAttention
    from ctts_torch.ops import attention
    seen = []
    real = attention.fused_attention

    def spy(q, k, v, lengths, scale=None):
        seen.append(all(t.is_contiguous() for t in (q, k, v, lengths)))
        assert lengths.dtype == torch.int32
        return real(q, k, v, lengths, scale)

    monkeypatch.setattr(attention, "fused_attention", spy)
    mha = MultiHeadAttention(32, 2)
    mask = torch.zeros(B, 7, dtype=torch.bool)
    mask[0, 5:] = True
    out = mha(torch.randn(B, 7, 32), mask)
    assert out.shape == (B, 7, 32) and seen == [True]


def test_synthesize_cli_on_cpu(tmp_path, capsys):
    from ctts_torch import synthesize
    synthesize.main(["--mode", "single", "--text", "Hello world.",
                     "--dataset", "LJSpeech", "--packed_ckpt", NPZ,
                     "--vocoder_ckpt", str(tmp_path / "none"),
                     "--result_dir", str(tmp_path), "--device", "cpu"])
    assert "griffin-lim" in capsys.readouterr().out
    wav = tmp_path / "Hello world..wav"
    mel = np.load(tmp_path / "Hello world..npy")
    assert wav.stat().st_size > 44 + 2 * 256 * 20
    assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()
    with pytest.raises(SystemExit):            # batch mode needs --source
        synthesize.main(["--mode", "batch", "--text", "x",
                         "--dataset", "LJSpeech", "--device", "cpu"])
