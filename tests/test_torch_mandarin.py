"""The port's Mandarin frontend (ctts_torch/text/pinyin_lexicon.py and
``ctts_torch.synthesize.preprocess_mandarin``) against the JAX package's
(ctts_tpu/text/pinyin_lexicon.py and the JAX CLI's ``preprocess_mandarin``,
synthesize.py:95-116), and the CLI's language dispatch
(synthesize.py:241-247). ``pypinyin`` is not installed: a stub that this
file places in ``sys.modules`` stands in for it, the same for both sides,
and without it both raise the same ImportError."""

import os
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# hanzi → the toned syllables ``pinyin(..., Style.TONE3,
# neutral_tone_with_five=True)`` gives them; punctuation passes through
# (strict=False), and one syllable is in no lexicon
_READINGS = {"中": "zhong1", "文": "wen2", "语": "yu3", "音": "yin1",
             "的": "de5", "儿": "er2", "花": "huar1", "女": "nv3",
             "绿": "lv4", "略": "lve4", "日": "ri4", "字": "zi4",
             "用": "yong4", "我": "wo3", "嗯": "ng4", "，": "，"}
TEXT = "中文语音的儿花，女绿略日字用我嗯"


def _stub():
    mod = types.ModuleType("pypinyin")

    class Style:
        TONE3 = 8

    def pinyin(text, style=None, strict=True, neutral_tone_with_five=False):
        assert style == Style.TONE3 and strict is False
        assert neutral_tone_with_five is True
        return [[_READINGS[ch]] for ch in text]

    mod.Style, mod.pinyin = Style, pinyin
    return mod


def _configs(lexicon_path, language="zh"):
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    pre["preprocessing"]["text"]["language"] = language
    pre["preprocessing"]["text"]["text_cleaners"] = []
    pre["path"]["lexicon_path"] = lexicon_path
    return pre, mc, tr


def test_build_lexicon_equals_the_jax_function():
    from ctts_tpu.text.pinyin_lexicon import build_lexicon as j_build
    from ctts_torch.text.pinyin_lexicon import build_lexicon
    got, want = build_lexicon(), j_build()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert len(got) > 1000 and got["zhong1"] == ["zh", "ong1"]


@pytest.mark.parametrize("with_file", [False, True])
def test_preprocess_mandarin_equals_the_jax_cli(with_file, tmp_path,
                                                monkeypatch):
    """The phone IDs of the port and of the JAX CLI under one stub
    ``pypinyin``: through the rule-built lexicon where the config's
    lexicon file is absent, and through the file where it exists."""
    import synthesize as j_cli
    from ctts_torch import synthesize
    monkeypatch.setitem(sys.modules, "pypinyin", _stub())
    lex = tmp_path / "pinyin-lexicon-r.txt"
    if with_file:
        lex.write_text("zhong1 zh ong1\nwen2 uu uen2\n")
    pre = _configs(str(lex))[0]
    got = synthesize.preprocess_mandarin(TEXT, pre)
    want = j_cli.preprocess_mandarin(TEXT, pre)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(got) >= len(TEXT)


def test_dispatch_and_import_error_as_the_jax_cli(tmp_path, monkeypatch):
    """``en`` and ``zh`` reach their frontends, any other language raises
    ValueError; without pypinyin ``zh`` raises the ImportError the JAX
    CLI raises."""
    import synthesize as j_cli
    from ctts_torch import synthesize
    monkeypatch.setitem(sys.modules, "pypinyin", None)
    pre = _configs(str(tmp_path / "none.txt"))[0]
    with pytest.raises(ImportError) as mine:
        synthesize.preprocess_text(TEXT, pre)
    with pytest.raises(ImportError) as theirs:
        j_cli.preprocess_mandarin(TEXT, pre)
    assert type(mine.value) is type(theirs.value)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="fr"):
        synthesize.preprocess_text("bonjour", _configs("x", "fr")[0])
    en = _configs(str(tmp_path / "none.txt"), "en")[0]
    assert np.array_equal(synthesize.preprocess_text("hello", en),
                          synthesize.preprocess_english("hello", en))


def test_synthesize_cli_in_mandarin(tmp_path, monkeypatch, capsys):
    """``python -m ctts_torch.synthesize`` on a ``zh`` config (tiny, seeded
    weights, CPU): with the stub it writes the wav and the mel and prints
    the phones; without pypinyin it raises ImportError."""
    from ctts_torch import synthesize
    from ctts_torch.config import dump_yaml, load_yaml
    pre, mc, tr = _configs(str(tmp_path / "none.txt"))
    mc.pop("_energy_stats")
    raw = load_yaml(open(os.path.join(REPO, "configs", "LJSpeech.yaml")))
    pre.pop("dataset", None)
    for section, cfg in (("preprocess", pre), ("model", mc), ("train", tr)):
        raw[section] = cfg
    raw["preprocess"]["preprocessing"]["pitch"].pop("cwt_scales", None)
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "LJSpeech.yaml").write_text(dump_yaml(raw))
    argv = ["--mode", "single", "--text", TEXT, "--dataset", "LJSpeech",
            "--config_dir", str(cfg), "--vocoder_ckpt", str(tmp_path / "no"),
            "--result_dir", str(tmp_path / "out"), "--device", "cpu"]
    monkeypatch.setitem(sys.modules, "pypinyin", _stub())
    synthesize.main(argv)
    out = capsys.readouterr().out
    assert "Phoneme Sequence: {zh ong1" in out
    mel = np.load(tmp_path / "out" / f"{TEXT}.npy")
    assert mel.ndim == 2 and np.isfinite(mel).all()
    assert (tmp_path / "out" / f"{TEXT}.wav").stat().st_size > 44
    monkeypatch.setitem(sys.modules, "pypinyin", None)
    with pytest.raises(ImportError):
        synthesize.main(argv)
