"""Preprocessing of ctts_torch on the CPU against the JAX package: the mel
featurizer (``audio/stft.py``), the float64 f0 tracker
(``preprocessing/pitch.py``), the DeepSpeaker ResCNN and its fbank, weight
loader and embedder (``models/speaker.py``), the whole ``.npy`` store of an
LJSpeech-layout and a two-speaker VCTK-layout corpus
(``preprocessing/preprocessor.py``), its worker pool, and ``prepare_align``
for both datasets. Every corpus is written by the test: speech-like wavs of
1.2-2.1 s, ``.lab`` texts and TextGrids (``ctts_torch.utils.testing.
write_corpus``, the corpus writer of ``chip_smoke.py`` too), and two stores
are held to each other by ``compare_stores``, the smoke's comparison."""

import copy
import filecmp
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_torch.utils.testing import (compare_stores, corpus_wav,
                                      store_files, write_corpus)
from test_preprocessor import _speechlike_wav

SR, HOP = 22050, 256
# log-mel, absolute: the port transforms float32 frames in float64 as
# numpy does (~1e-6 apart), the jnp twin in float32 (~4e-5 apart)
MEL_TOL = 1e-4
ENERGY_RTOL = 1e-5
F0_RTOL = 1e-6
EMBED_TOL = 1e-5
FBANK_TOL = 1e-4

TEXTS = ["printing in the only sense",
         "with which we are at present",
         "concerned differs from most",
         "arts and crafts hello world"]
# the corpora: utterances of 1.2-2.1 s (``write_corpus``), each lab
# ending in a word the lexicon lacks, which g2p spells as graphemes
CORPUS_SECONDS = [1.2, 1.5, 1.8, 2.1]
SPELLED = ("hello", "world")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wavs(n, seed):
    rng = np.random.RandomState(seed)
    return [_speechlike_wav(rng, 1.2 + 0.3 * i, SR) for i in range(n)]


def _configs(dataset, corpus, out):
    from ctts_torch.config import get_configs_of
    pre, mc, tr = (copy.deepcopy(c) for c in get_configs_of(dataset))
    pre["path"].update(raw_path=os.path.join(corpus, "raw"),
                       preprocessed_path=out,
                       lexicon_path=os.path.join(corpus, "lexicon.txt"))
    pre["preprocessing"]["val_size"] = 1
    os.makedirs(out, exist_ok=True)
    shutil.copytree(os.path.join(corpus, "TextGrid"),
                    os.path.join(out, "TextGrid"))
    return pre, mc, tr


@pytest.fixture(scope="module")
def lj_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lj_corpus"))
    write_corpus(root, ["LJSpeech"], CORPUS_SECONDS, seed=0,
                 spelled=SPELLED)
    return root


@pytest.fixture(scope="module")
def vctk_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vctk_corpus"))
    write_corpus(root, ["p225", "p226"], CORPUS_SECONDS[:2], seed=5,
                 spelled=SPELLED)
    return root


# ---- the mel featurizer ------------------------------------------------ #

def test_filterbank_and_window_equal_jax():
    from ctts_tpu.audio import stft as jstft
    from ctts_torch.audio import stft
    for args in ((22050, 1024, 80, 0, 8000), (16000, 512, 64, 0, 8000),
                 (22050, 1024, 80, 0, None)):
        np.testing.assert_array_equal(stft.mel_filterbank(*args),
                                      jstft.mel_filterbank(*args))
    for win, n_fft in ((1024, 1024), (400, 512)):
        np.testing.assert_array_equal(stft.hann_window(win, n_fft),
                                      jstft.hann_window(win, n_fft))


def test_tacotron_stft_matches_jax():
    """A batch of equal-length speech-like wavs through the port's
    TacotronSTFT (device cpu) against the JAX package's numpy featurizer
    and its jnp twin: the log-mel within MEL_TOL, the energy within
    ENERGY_RTOL relative, F = 1 + T // hop."""
    from ctts_tpu.audio.stft import TacotronSTFT as JSTFT
    from ctts_tpu.audio.stft import mel_spectrogram_jnp
    from ctts_torch.audio.stft import TacotronSTFT
    from ctts_torch.audio.tools import get_mel_from_wav
    args = (1024, 256, 1024, 80, SR, 0, 8000)
    jst, st = JSTFT(*args), TacotronSTFT(*args)
    wavs = _wavs(3, 1)
    n = min(len(w) for w in wavs)
    batch = np.stack([w[:n] for w in wavs])
    mel, energy = st.mel_spectrogram(torch.from_numpy(batch))
    frames = 1 + n // HOP
    assert mel.shape == (3, 80, frames) and energy.shape == (3, frames)
    jm, je = mel_spectrogram_jnp(jnp.asarray(batch), 1024, 256, 1024,
                                 jst.mel_basis)
    np.testing.assert_allclose(mel.numpy(), np.swapaxes(np.asarray(jm), 1, 2),
                               atol=MEL_TOL, rtol=0)
    np.testing.assert_allclose(energy.numpy(), np.asarray(je),
                               rtol=ENERGY_RTOL, atol=0)
    for w in wavs:
        want_m, want_e = jst.mel_spectrogram(w)
        got_m, got_e = get_mel_from_wav(w, st)
        assert got_m.dtype == np.float32 and got_m.shape == want_m.shape
        np.testing.assert_allclose(got_m, want_m, atol=MEL_TOL, rtol=0)
        np.testing.assert_allclose(got_e, want_e, rtol=ENERGY_RTOL, atol=0)
    with pytest.raises(ValueError):
        st.mel_spectrogram(torch.full((1, 4096), 1.5))


# ---- the pitch tracker ------------------------------------------------- #

def _tone(hz):
    t = np.arange(SR) / SR
    return 0.5 * np.sin(2 * np.pi * hz * t)


def _chirp():
    t = np.arange(int(SR * 1.5)) / SR
    inst = 120.0 + 120.0 * t / 1.5
    return 0.4 * np.sin(2 * np.pi * np.cumsum(inst) / SR)


def _glottal():
    from numpy.fft import irfft, rfft, rfftfreq
    t = np.arange(SR) / SR
    wav = sum((1.0 / k) * np.sin(2 * np.pi * 150.0 * k * t + 0.1 * k)
              for k in range(1, 25))
    spec = rfft(wav)
    freqs = rfftfreq(SR, 1 / SR)
    spec *= 1.0 + 2.0 * np.exp(-((freqs - 700.0) ** 2) / (2 * 150.0 ** 2))
    wav = irfft(spec, SR)
    return wav / np.abs(wav).max()


def _vibrato():
    t = np.arange(int(SR * 1.2)) / SR
    inst = 200.0 + 8.0 * np.sin(2 * np.pi * 5.0 * t)
    return 0.4 * np.sin(2 * np.pi * np.cumsum(inst) / SR)


def _mixed():
    rng = np.random.RandomState(1)
    t = np.arange(int(SR * 0.4)) / SR
    return np.concatenate([0.5 * np.sin(2 * np.pi * 180.0 * t),
                           np.zeros(len(t)), rng.randn(len(t)) * 0.1,
                           0.5 * np.sin(2 * np.pi * 260.0 * t)])


SIGNALS = {
    **{f"tone{hz:g}": (lambda hz=hz: _tone(hz))
       for hz in (80.0, 100.0, 220.0, 330.0, 440.0, 600.0)},
    "chirp": _chirp, "glottal": _glottal, "vibrato": _vibrato,
    "noise": lambda: np.random.RandomState(0).randn(SR) * 0.3,
    "silence": lambda: np.zeros(SR), "mixed": _mixed,
    "corpus_wav": lambda: corpus_wav(np.random.RandomState(0), 1.8)[0],
}


def _f0_agree(got, want, what, skip=None):
    """Voicing equal frame for frame; voiced f0 within F0_RTOL but on the
    ``skip`` frames, whose lag is rounding noise in both trackers
    (``constant_window_frames``)."""
    assert got.dtype == np.float32 and got.shape == want.shape, what
    np.testing.assert_array_equal(got > 0, want > 0, err_msg=what)
    v = want > 0
    if skip is not None:
        assert skip.sum() <= 2, (what, np.nonzero(skip))
        v &= ~skip
    np.testing.assert_allclose(got[v], want[v], rtol=F0_RTOL, atol=0,
                               err_msg=what)


def _skip(wav, n):
    """``constant_window_frames`` of ``wav`` edge-padded or cut to ``n``
    frames, as ``get_pitch`` pads the f0."""
    from ctts_torch.preprocessing.pitch import constant_window_frames
    m = constant_window_frames(wav, SR, HOP)
    return np.pad(m, (0, max(0, n - len(m))), mode="edge")[:n]


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_pitch_tracker_matches_jax(name):
    """The batched float64 tracker against the JAX package's per-frame
    loop; ``get_pitch`` (padded past the frames, so the edge rule runs) with
    equal coarse bins. A frame whose window is digital silence under sound
    (``mixed``'s frame 67) takes its lag from rounding noise in both: its
    voicing is held, its f0 is not."""
    from ctts_tpu.preprocessing import pitch as jpitch
    from ctts_torch.preprocessing import pitch
    wav = SIGNALS[name]()
    _f0_agree(pitch.extract_f0_autocorr(wav, SR, HOP, device="cpu"),
              jpitch.extract_f0_autocorr(wav, SR, HOP), name,
              _skip(wav, len(wav) // HOP))
    pre = {"preprocessing": {"audio": {"sampling_rate": SR},
                             "stft": {"hop_length": HOP}}}
    mel_len = len(wav) // HOP + 3
    f0, coarse = pitch.get_pitch(wav, mel_len, pre, device="cpu")
    jf0, jcoarse = jpitch.get_pitch(wav, mel_len, pre)
    skip = _skip(wav, mel_len)
    _f0_agree(f0, jf0, name, skip)
    assert coarse.dtype == jcoarse.dtype
    np.testing.assert_array_equal(coarse[~skip], jcoarse[~skip])


def test_continuous_f0_helpers_equal_jax():
    from ctts_tpu.preprocessing import pitch as jpitch
    from ctts_torch.preprocessing import pitch
    f0 = jpitch.extract_f0_autocorr(_mixed(), SR, HOP)
    for got, want in zip(pitch.get_cont_lf0(f0), jpitch.get_cont_lf0(f0)):
        np.testing.assert_array_equal(got, want)
    zero = np.zeros(7, np.float32)
    for got, want in zip(pitch.convert_continuous_f0(zero),
                         jpitch.convert_continuous_f0(zero)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pitch.f0_to_coarse_np(f0.copy()),
                                  jpitch.f0_to_coarse_np(f0.copy()))


# ---- the DeepSpeaker ResCNN -------------------------------------------- #

def _seeded_rescnn_tree():
    """The JAX ResCNN's init, every bias, scale and statistic moved off its
    default so the bridge's placement of each shows."""
    from ctts_tpu.models.speaker import ResCNN as JResCNN
    jm = JResCNN()
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 160, 64, 1))))
    rng = np.random.RandomState(0)

    def move(node):
        for k, v in node.items():
            if isinstance(v, dict):
                move(v)
            elif k == "var":
                node[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif v.ndim == 1:
                node[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    move(tree)
    return jm, tree


def test_rescnn_matches_jax():
    """A seeded JAX ResCNN and its bridged port on one [2, 160, 64] fbank
    (SAME padding (1, 2) at stride 2, BN eps 1e-3 with running statistics,
    the NHWC flatten)."""
    from ctts_torch.models.speaker import ResCNN
    from ctts_torch.utils.weights import rescnn_state_dict_from_jax
    jm, tree = _seeded_rescnn_tree()
    model = ResCNN()
    model.load_state_dict(rescnn_state_dict_from_jax(tree), strict=True)
    x = np.random.RandomState(1).randn(2, 160, 64).astype(np.float32)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)[..., None]))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=EMBED_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_compute_fbank_matches_jax():
    from ctts_tpu.models.speaker import compute_fbank as jfbank
    from ctts_torch.models.speaker import compute_fbank
    for wav, sr in ((_wavs(1, 2)[0], SR), (_wavs(1, 3)[0][:16000], 16000)):
        want = jfbank(wav, sr)
        got = compute_fbank(wav, sr, device="cpu")
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=FBANK_TOL, rtol=0)


def test_predefined_embedder_fails_loudly_and_matches_jax(monkeypatch):
    """Without weights both embedders raise unless
    CTTS_ALLOW_RANDOM_SPEAKER=1; with it, the port on the JAX embedder's
    bridged weights gives its embedding of a short (wrapped) and a long
    (centre-cropped) utterance."""
    from ctts_tpu.models.speaker import PreDefinedEmbedder as JEmbedder
    from ctts_torch.models.speaker import PreDefinedEmbedder
    from ctts_torch.utils.weights import rescnn_state_dict_from_jax
    pre = {"preprocessing": {"audio": {"sampling_rate": SR}}, "path": {}}
    monkeypatch.delenv("CTTS_ALLOW_RANDOM_SPEAKER", raising=False)
    monkeypatch.delenv("CTTS_DEEPSPEAKER_H5", raising=False)
    for cls, kw in ((JEmbedder, {}), (PreDefinedEmbedder, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="DeepSpeaker pretrained"):
            cls(pre, **kw)
    monkeypatch.setenv("CTTS_ALLOW_RANDOM_SPEAKER", "1")
    jemb, emb = JEmbedder(pre), PreDefinedEmbedder(pre, device="cpu")
    wavs = [_wavs(1, 4)[0][:SR], _wavs(3, 4)[2]]     # 1.0 s and 1.8 s
    want = [jemb(w) for w in wavs]
    emb.model.load_state_dict(rescnn_state_dict_from_jax(
        jax.tree.map(np.asarray, jemb.variables)))
    for w, wv in zip(wavs, want):
        got = emb(w)
        assert got.shape == (1, 512)
        np.testing.assert_allclose(got, wv, atol=EMBED_TOL, rtol=0)


def _write_keras_h5(path):
    """A small Keras-layout checkpoint: every layer the loader reads, in the
    full-model layout with TF1 ``:0`` names, arrays of a few entries."""
    import h5py
    from ctts_torch.models.speaker import _FILTERS
    rng = np.random.RandomState(2)
    layers = {}
    for i, f in enumerate(_FILTERS):
        layers[f"conv{f}-s"] = ("kernel", "bias")
        layers[f"conv{f}-s_bn"] = ("gamma", "beta", "moving_mean",
                                   "moving_variance")
        for j in range(3):
            for part in ("2a", "2b"):
                base = f"res{i + 1}_{j}_branch_{part}"
                layers[base] = ("kernel", "bias")
                layers[f"{base}_bn"] = ("gamma", "beta", "moving_mean",
                                        "moving_variance")
    layers["affine"] = ("kernel", "bias")
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        for layer, names in layers.items():
            g = root.create_group(layer).create_group(layer)
            for n in names:
                g.create_dataset(f"{n}:0",
                                 data=rng.randn(3, 2).astype(np.float32))


def test_load_keras_weights_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    from ctts_tpu.models.speaker import ResCNN as JResCNN
    from ctts_tpu.models.speaker import load_keras_weights as j_load
    from ctts_torch.models.speaker import load_keras_weights
    path = str(tmp_path / "rescnn.h5")
    _write_keras_h5(path)
    variables = JResCNN().init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 160, 64, 1)))
    want = jax.tree_util.tree_flatten_with_path(j_load(path, variables))[0]
    got = jax.tree_util.tree_flatten_with_path(load_keras_weights(path))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert isinstance(g, np.ndarray), k
        np.testing.assert_array_equal(g, np.asarray(w), str(k))


# ---- the store --------------------------------------------------------- #

def _bridge_embedder(port, jax_pre):
    from ctts_torch.utils.weights import rescnn_state_dict_from_jax
    jax_pre.speaker_emb._ensure_init()
    port.speaker_emb.model.load_state_dict(rescnn_state_dict_from_jax(
        jax.tree.map(np.asarray, jax_pre.speaker_emb.variables)))


@pytest.mark.parametrize("dataset", ["LJSpeech", "VCTK"])
def test_store_matches_jax(dataset, lj_corpus, vctk_corpus, tmp_path,
                           monkeypatch):
    """JAX's Preprocessor and the port's (device cpu) write the same store;
    the VCTK one with seeded speaker embeddings, the port's embedder on the
    JAX embedder's bridged weights."""
    from ctts_tpu.preprocessing.preprocessor import Preprocessor as JPre
    from ctts_torch.preprocessing.preprocessor import Preprocessor
    corpus = lj_corpus if dataset == "LJSpeech" else vctk_corpus
    monkeypatch.setenv("CTTS_ALLOW_RANDOM_SPEAKER", "1")
    monkeypatch.setenv("CTTS_PREPROCESS_WORKERS", "1")
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpre = JPre(*_configs(dataset, corpus, want_dir))
    jpre.build_from_path()
    port = Preprocessor(*_configs(dataset, corpus, got_dir), device="cpu")
    if dataset == "VCTK":
        _bridge_embedder(port, jpre)
    port.build_from_path()
    compare_stores(got_dir, want_dir, port.constant_window_frames,
                   jpre.get_f0cwt)
    if dataset == "VCTK":
        assert sorted(os.listdir(os.path.join(got_dir, "spker_embed"))) == \
            ["p225-spker_embed.npy", "p226-spker_embed.npy"]


def test_worker_pool_bit_identical(lj_corpus, tmp_path, monkeypatch):
    """``python -m ctts_torch.preprocess --device cpu`` with one worker and
    with CTTS_PREPROCESS_WORKERS=2 (spawned, each on the parent's device)
    write the same bytes in every file."""
    from ctts_torch.config import dump_yaml, load_yaml
    from ctts_torch.preprocess import main
    outs = []
    for workers in ("1", "2"):
        out = str(tmp_path / f"w{workers}")
        pre, mc, tr = _configs("LJSpeech", lj_corpus, out)
        raw = load_yaml(open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "LJSpeech.yaml")))
        pre.pop("dataset", None)
        pre["preprocessing"]["pitch"].pop("cwt_scales", None)
        raw["preprocess"] = pre
        cfg = tmp_path / f"cfg{workers}"
        cfg.mkdir()
        (cfg / "LJSpeech.yaml").write_text(dump_yaml(raw))
        monkeypatch.setenv("CTTS_PREPROCESS_WORKERS", workers)
        main(["--dataset", "LJSpeech", "--config_dir", str(cfg),
              "--device", "cpu"])
        outs.append(out)
    a, b = outs
    files = store_files(a)
    assert files == store_files(b) and "stats.json" in files
    for rel in files:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


# ---- prepare_align ----------------------------------------------------- #

def _raw_corpus(root, dataset):
    """An upstream corpus layout: LJSpeech's metadata.csv and wavs/, or
    VCTK's txt/<speaker>/ and wav48_silence_trimmed/<speaker>/ at 48 kHz."""
    from ctts_torch.preprocessing.audio_io import save_wav
    if dataset == "LJSpeech":
        os.makedirs(os.path.join(root, "wavs"))
        with open(os.path.join(root, "metadata.csv"), "w") as f:
            for i, (w, t) in enumerate(zip(_wavs(2, 6), TEXTS)):
                save_wav(os.path.join(root, "wavs", f"LJ{i:03d}.wav"),
                         w * 0.5, SR)
                f.write(f"LJ{i:03d}|{t}|Mr. {t.title()}, 1884!\n")
        return
    rng = np.random.RandomState(7)
    for speaker in ("p225", "p226"):
        os.makedirs(os.path.join(root, "txt", speaker))
        os.makedirs(os.path.join(root, "wav48_silence_trimmed", speaker))
        for i in range(2):
            base = f"{speaker}_{i:03d}"
            with open(os.path.join(root, "txt", speaker, f"{base}.txt"),
                      "w") as f:
                f.write(f"Please call Stella, {i + 2} times.\n")
            save_wav(os.path.join(root, "wav48_silence_trimmed", speaker,
                                  f"{base}_mic1.wav"),
                     _speechlike_wav(rng, 0.5, 48000), 48000)


@pytest.mark.parametrize("dataset", ["LJSpeech", "VCTK"])
def test_prepare_align_matches_jax(dataset, tmp_path):
    from ctts_torch.config import get_configs_of
    from ctts_torch.prepare_align import main
    corpus = str(tmp_path / "corpus")
    _raw_corpus(corpus, dataset)
    outs = {}
    for side in ("jax", "port"):
        pre = copy.deepcopy(get_configs_of(dataset)[0])
        pre["path"].update(corpus_path=corpus,
                           raw_path=str(tmp_path / side))
        if side == "jax":
            import importlib
            importlib.import_module(
                f"ctts_tpu.preprocessing.{dataset.lower()}").prepare_align(
                    pre)
        else:
            from ctts_torch.config import dump_yaml, load_yaml
            raw = load_yaml(open(os.path.join(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))), "configs",
                f"{dataset}.yaml")))
            raw["preprocess"]["path"].update(corpus_path=corpus,
                                             raw_path=str(tmp_path / side))
            cfg = tmp_path / "cfg"
            cfg.mkdir()
            (cfg / f"{dataset}.yaml").write_text(dump_yaml(raw))
            main(["--dataset", dataset, "--config_dir", str(cfg)])
        outs[side] = str(tmp_path / side)
    files = store_files(outs["jax"])
    assert files == store_files(outs["port"]) and len(files) == 8 - 4 * (
        dataset == "LJSpeech")
    for rel in files:
        assert filecmp.cmp(os.path.join(outs["jax"], rel),
                           os.path.join(outs["port"], rel), shallow=False), rel
