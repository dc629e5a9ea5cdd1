"""The port's native .npy reader (ctts_torch/data/native_loader.py, built
from native/npy_loader.cc into build/ctts_torch/) and the port's Dataset
reading through it: the dtype, header and rejection matrix of
tests/test_native_loader.py, the build's place and flags, the numpy path
without a host compiler, and batches byte-for-byte equal with and without
the reader (and padded to a data-parallel step's lengths)."""

import os
import re

import numpy as np
import pytest

from ctts_torch.data import native_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    if not native_loader.build():
        pytest.skip("no host C++ compiler")
    return native_loader


def _roundtrip(tmp_path, arrays):
    paths = []
    for i, a in enumerate(arrays):
        p = os.path.join(tmp_path, f"a{i}.npy")
        np.save(p, a)
        paths.append(p)
    return native_loader.read_batch(paths)


def test_built_from_the_source_into_the_ports_build_directory(built):
    """The library sits in build/ctts_torch/ under a hash of the source and
    the flags, which are native/Makefile's; the JAX package's own build
    output (native/libctts_io.so) is never the one loaded."""
    path = native_loader.target()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "ctts_torch")
    assert os.path.isfile(path) and native_loader.available()
    assert native_loader._lib._name == path
    make = open(os.path.join(REPO, "native", "Makefile")).read()
    flags = re.search(r"CXXFLAGS \?= (.*)", make).group(1).split()
    assert list(native_loader.CXX_FLAGS) == flags + ["-shared"]
    assert "-shared" in make
    assert native_loader.SOURCE == os.path.join(REPO, "native",
                                                "npy_loader.cc")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.uint8])
def test_dtype_matrix(built, tmp_path, dtype):
    a = (np.arange(60).reshape(3, 4, 5) % 7).astype(dtype)
    out = _roundtrip(str(tmp_path), [a])
    assert out[0].dtype == a.dtype and out[0].shape == a.shape
    np.testing.assert_array_equal(out[0], a)


def test_shapes_and_headers(built, tmp_path):
    """0-d, 1-d and 2-d arrays, and a format 2.0 header."""
    arrays = [np.float32(3.5) * np.ones(()), np.arange(7, dtype=np.int64),
              np.random.RandomState(0).randn(80, 123).astype(np.float32)]
    for got, want in zip(_roundtrip(str(tmp_path), arrays), arrays):
        np.testing.assert_array_equal(got, want)
    p = os.path.join(str(tmp_path), "v2.npy")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    with open(p, "wb") as f:
        np.lib.format.write_array(f, a, version=(2, 0))
    np.testing.assert_array_equal(native_loader.read_batch([p])[0], a)


@pytest.mark.parametrize("kind", ["fortran", "big_endian", "complex",
                                  "truncated", "not_npy", "missing"])
def test_rejected_files_come_back_as_none(built, tmp_path, kind):
    """Each rejected file yields None, not garbage, beside a good one."""
    p = os.path.join(str(tmp_path), f"{kind}.npy")
    if kind == "fortran":
        np.save(p, np.asfortranarray(np.random.rand(4, 5).astype(np.float32)))
    elif kind == "big_endian":
        np.save(p, np.arange(4, dtype=">f4"))
    elif kind == "complex":
        np.save(p, np.ones(3, np.complex64))
    elif kind == "truncated":
        np.save(p, np.zeros((100, 100), np.float32))
        with open(p, "r+b") as f:
            f.truncate(512)
    elif kind == "not_npy":
        with open(p, "wb") as f:
            f.write(b"hello world, definitely not numpy")
    ok = os.path.join(str(tmp_path), "ok.npy")
    np.save(ok, np.full((2, 2), 7.0, np.float32))
    out = native_loader.read_batch([p, ok])
    assert out[0] is None
    np.testing.assert_array_equal(out[1], np.full((2, 2), 7.0, np.float32))


def test_submit_ahead_on_one_pool(built, tmp_path):
    """Several jobs in flight, fetched out of submit order."""
    rng = np.random.RandomState(1)
    groups = []
    for g in range(3):
        arrays = [rng.randn(16, 8).astype(np.float32) for _ in range(6)]
        paths = [os.path.join(str(tmp_path), f"g{g}_{i}.npy")
                 for i in range(6)]
        for p, a in zip(paths, arrays):
            np.save(p, a)
        groups.append((paths, arrays))
    pf = native_loader.NativePrefetcher(n_threads=4)
    jobs = [pf.submit(paths) for paths, _ in groups]
    for job, (_, arrays) in reversed(list(zip(jobs, groups))):
        assert pf.ready(job) in (True, False)
        for g, w in zip(pf.fetch(job), arrays):
            np.testing.assert_array_equal(g, w)


def test_without_a_host_compiler_numpy_reads(tmp_path, monkeypatch, capsys):
    """No library and no compiler: ``build`` says so once and returns
    False, and ``read_batch`` reads with numpy."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_said", False)
    monkeypatch.setattr(native_loader, "_compiler", lambda: None)
    monkeypatch.setattr(native_loader, "target",
                        lambda: str(tmp_path / "absent.so"))
    assert not native_loader.build() and not native_loader.build()
    assert capsys.readouterr().err.count("no host C++ compiler") == 1
    a = np.random.RandomState(2).randn(5, 9).astype(np.float32)
    np.save(tmp_path / "x.npy", a)
    np.testing.assert_array_equal(
        native_loader.read_batch([str(tmp_path / "x.npy")])[0], a)


def _dataset(store):
    from ctts_torch.data.dataset import Dataset
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    pre["path"]["preprocessed_path"] = store
    tr["optimizer"]["batch_size"] = 3
    return Dataset("train_unsup.txt", pre, mc, tr, sort=True,
                   drop_last=True)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and \
            a.tobytes() == b.tobytes()
    return a == b


def test_dataset_batches_equal_with_and_without_the_reader(built, tmp_path):
    """The port's Dataset reads every file of a batch through the reader,
    a file it rejects (a Fortran-order mel) through numpy, and gives the
    batches numpy alone gives, byte for byte."""
    from test_train_e2e import make_fake_store
    store = str(tmp_path / "store")
    make_fake_store(store, n_utts=9)
    mel = os.path.join(store, "mel_unsup", "LJSpeech-mel-utt004.npy")
    np.save(mel, np.asfortranarray(np.load(mel)))
    native = _dataset(store)
    plain = _dataset(store)
    plain._native = None
    assert native._native is not None
    got = list(native.batches(seed=3))
    want = list(plain.batches(seed=3))
    assert len(got) == len(want) == 3
    assert all(_equal(g, w) for g, w in zip(got, want))
    assert native.numpy_reads == 1 and native.native_reads > 0
    assert plain.native_reads == 0


def test_collate_pads_to_the_steps_lengths(tmp_path):
    """``pad_to`` (the streaming loader's step lengths on a data group)
    pads each batch past its buckets with zeros, and changes nothing
    else."""
    from test_train_e2e import make_fake_store
    store = str(tmp_path / "store")
    make_fake_store(store, n_utts=6)
    ds = _dataset(store)
    seen = []

    def pad_to(lengths):
        seen.append(lengths)
        return lengths[0] + 32, lengths[1] + 128

    for b, p in zip(ds.batches(seed=1), ds.batches(seed=1, pad_to=pad_to)):
        T_s, T_m = b["texts"].shape[1], b["mels"].shape[1]
        assert seen[-1] == (T_s, T_m)
        assert p["texts"].shape[1] == T_s + 32
        assert p["mels"].shape[1] == T_m + 128
        assert p["attn_priors"].shape[1:] == (T_m + 128, T_s + 32)
        assert not p["mels"][:, T_m:].any() and not p["texts"][:, T_s:].any()
        np.testing.assert_array_equal(p["mels"][:, :T_m], b["mels"])
        np.testing.assert_array_equal(p["attn_priors"][:, :T_m, :T_s],
                                      b["attn_priors"])
        np.testing.assert_array_equal(p["pitch_data"]["cwt_spec"][:, :T_m],
                                      b["pitch_data"]["cwt_spec"])
        np.testing.assert_array_equal(p["src_lens"], b["src_lens"])
