"""The port's fused ResBlock1, the generator's fused route, the chunked
vocoder, MelGAN and the relpos flip tool against the JAX package on the CPU.

Inputs and weights are drawn with numpy and handed to both sides; float32
throughout. The JAX Pallas kernels run in interpret mode, as their own
tests run them; generators are narrow (``upsample_initial_channel`` 32,
MelGAN ``ngf`` 8), never full width."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs several workers on a few cores: keep torch's intra-op
    # pool small so these tests do not starve the others
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _resblock_case(k, C=32, N=2, T=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, T, C).astype(np.float32) * 0.3
    w1, w2 = (rng.randn(3, k, C, C).astype(np.float32) * 0.05
              for _ in range(2))
    b1, b2 = (rng.randn(3, C).astype(np.float32) * 0.05 for _ in range(2))
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("k", [3, 11])
def test_reference_resblock1_matches_jax_and_pallas(k, monkeypatch):
    """The plain chain on [N, C, T] against JAX's reference and the Pallas
    kernel in interpret mode at block_t=128: two tiles, so both sequence
    edges and a tile seam, at C=32."""
    from ctts_tpu.ops import fused_resblock as jfr
    from ctts_torch.ops.fused_resblock import (chain_halo, fused_resblock1,
                                               reference_resblock1)
    assert chain_halo(k, (1, 3, 5)) == jfr._chain_halo(k, (1, 3, 5)) == \
        {3: 12, 11: 60}[k]
    x, w1, b1, w2, b2 = _resblock_case(k)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    ref = np.asarray(jfr.reference_resblock1(*jargs, k))
    monkeypatch.setattr(jfr, "_INTERPRET", True)
    pallas = np.asarray(jfr.fused_resblock1(*jargs, k, block_t=128))
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    convs = [(torch.from_numpy(w), torch.from_numpy(b))
             for w, b in ((w1, b1), (w2, b2))]
    got = reference_resblock1(xt, *convs, k).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=0)
    # on a CPU tensor the wrapper is the plain version
    wrapped = fused_resblock1(xt, *convs, k, block_t=128)
    assert torch.equal(wrapped.transpose(1, 2), torch.from_numpy(got))


def _hifigan(channels=32, seed=2, T=8):
    """A narrow JAX HiFi-GAN V1 with N(0, 0.05²) weights from numpy, and
    the port's generator with the same weights."""
    from ctts_tpu.vocoder.hifigan import HiFiGANGenerator as JaxGen, V1_CONFIG
    from ctts_torch.utils.weights import hifigan_state_dict_from_jax
    from ctts_torch.vocoder.hifigan import HiFiGANGenerator
    cfg = dict(V1_CONFIG, upsample_initial_channel=channels)
    jgen = JaxGen(cfg)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(1),
                            jnp.zeros((1, T, 80), jnp.float32))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda s: 0.05 * rng.randn(*s.shape).astype(np.float32),
        dict(shapes))
    gen = HiFiGANGenerator(cfg).eval()
    gen.load_state_dict(hifigan_state_dict_from_jax(params), strict=True)
    return jgen, params, gen


@pytest.fixture(scope="module")
def hifigan():
    return _hifigan()


@pytest.mark.parametrize("T,fused", [(8, 9), (9, 6)])
def test_generator_fused_route_matches_jax(T, fused, hifigan, monkeypatch):
    """With CTTS_FUSE_RESBLOCK=1 every ResBlock1 with C ≤ 128 and
    T % 128 == 0 takes the fused chain (its plain version on the CPU):
    all 9 of levels 1-3 at an even mel length, 6 at an odd one (level 1
    fails T % 128); the output matches JAX's generator."""
    from ctts_torch.ops import fused_resblock
    jgen, params, gen = hifigan
    mel = np.random.RandomState(T).randn(2, T, 80).astype(np.float32) - 3
    want = np.asarray(jax.jit(jgen.apply)(params, jnp.asarray(mel)))
    calls = []
    real = fused_resblock.reference_resblock1

    def spy(x, *args, **kw):
        calls.append(x.shape)
        return real(x, *args, **kw)

    monkeypatch.setattr(fused_resblock, "reference_resblock1", spy)
    monkeypatch.setenv("CTTS_FUSE_RESBLOCK", "1")
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert len(calls) == fused, calls
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    monkeypatch.delenv("CTTS_FUSE_RESBLOCK")
    with torch.no_grad():
        unfused = gen(torch.from_numpy(mel)).numpy()
    assert len(calls) == fused
    np.testing.assert_allclose(got, unfused, atol=2e-6, rtol=0)


def test_stacked_weights_are_cached_and_follow_the_parameters():
    from ctts_torch.vocoder.hifigan import ResBlock1
    block = ResBlock1(16, 3, (1, 3, 5))
    a = block.stacked(torch.float32)
    assert block.stacked(torch.float32) is a
    assert a[0][0].shape == (3, 3, 16, 16)
    bf = block.stacked(torch.bfloat16)
    assert bf is not a and torch.equal(
        bf[0][0][1], block.convs1[1].weight.detach().to(torch.bfloat16)
        .float().permute(2, 1, 0))
    with torch.no_grad():
        block.convs2[2].bias.add_(1.0)
    b = block.stacked(torch.float32)
    assert b is not a and torch.equal(b[1][1][2],
                                      block.convs2[2].bias.detach())


def test_chunked_vocoder_matches_jax(hifigan):
    """The job plan and the chunks against make_chunked_vocoder: T below
    the window (one full pass), T a chunk multiple, and T with a tail; the
    streamed audio equals the port's full pass to float32 rounding."""
    from ctts_tpu.vocoder.streaming import make_chunked_vocoder as jax_chunked
    from ctts_torch.vocoder.streaming import RF_MEL, make_chunked_vocoder
    jgen, params, gen = hifigan
    chunk = 16
    jstream = jax_chunked(jgen.apply, params, chunk=chunk, halo=RF_MEL)
    stream = make_chunked_vocoder(gen, chunk=chunk, halo=RF_MEL)
    for T, n_chunks in ((40, 1), (64, 4), (70, 5)):
        mel = np.random.RandomState(T).randn(1, T, 80).astype(np.float32) - 4
        want = [np.asarray(c) for c in jstream(mel)]
        got = list(stream(mel))
        assert [c.shape for c in got] == [c.shape for c in want]
        assert len(got) == n_chunks
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        with torch.no_grad():
            full = gen(torch.from_numpy(mel)).numpy()
        np.testing.assert_allclose(np.concatenate(got, axis=1), full,
                                   atol=2e-6, rtol=0)


def test_vocoder_stream_equals_vocoder_infer(hifigan):
    from ctts_torch.config import get_configs_of
    from ctts_torch.utils.model import vocoder_infer, vocoder_stream
    _, _, gen = hifigan
    pre, _, _ = get_configs_of("LJSpeech")
    mels = np.random.RandomState(5).randn(2, 70, 80).astype(np.float32) - 4
    full = vocoder_infer(mels, ("HiFi-GAN", gen), pre, lengths=[70, 61])
    chunks = list(vocoder_stream(mels, ("HiFi-GAN", gen), pre, chunk=16))
    assert all(c.dtype == np.int16 for c in chunks)
    streamed = np.concatenate(chunks, axis=1)
    for i, n in enumerate((70, 61)):
        diff = np.abs(streamed[i, :n * 256].astype(np.int32)
                      - full[i].astype(np.int32))
        assert diff.max() <= 1
    with pytest.raises(ValueError, match="streaming"):
        next(vocoder_stream(mels, ("griffin_lim", None), pre))


def _melgan(ngf=8, seed=3):
    from ctts_tpu.vocoder.melgan import MelGANGenerator as JaxMelGAN
    jgen = JaxMelGAN(ngf=ngf)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 6, 80), jnp.float32))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda s: 0.1 * rng.randn(*s.shape).astype(np.float32),
        dict(shapes))
    return jgen, params


def test_melgan_matches_jax():
    from ctts_torch.utils.weights import melgan_state_dict_from_jax
    from ctts_torch.vocoder.melgan import MelGANGenerator
    jgen, params = _melgan()
    mel = ((np.random.RandomState(4).randn(2, 6, 80) - 4) / np.log(10)
           ).astype(np.float32)
    want = np.asarray(jax.jit(jgen.apply)(params, jnp.asarray(mel)))
    gen = MelGANGenerator(ngf=8).eval()
    gen.load_state_dict(melgan_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 6 * 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_load_melgan_reads_an_upstream_checkpoint(tmp_path):
    """A weight-normed upstream Sequential (descript melgan-neurips layout)
    loads through load_melgan and gives the upstream module's output."""
    from torch import nn
    from torch.nn.utils import weight_norm
    from ctts_torch.vocoder.melgan import MelGANGenerator, load_melgan

    class Res(nn.Module):
        def __init__(self, dim, dilation):
            super().__init__()
            self.block = nn.Sequential(
                nn.LeakyReLU(0.2), nn.ReflectionPad1d(dilation),
                weight_norm(nn.Conv1d(dim, dim, 3, dilation=dilation)),
                nn.LeakyReLU(0.2), weight_norm(nn.Conv1d(dim, dim, 1)))
            self.shortcut = weight_norm(nn.Conv1d(dim, dim, 1))

        def forward(self, x):
            return self.shortcut(x) + self.block(x)

    torch.manual_seed(0)
    ngf, mult = 8, 16
    layers = [nn.ReflectionPad1d(3), weight_norm(nn.Conv1d(80, mult * ngf, 7))]
    for r in (8, 8, 2, 2):
        layers += [nn.LeakyReLU(0.2), weight_norm(nn.ConvTranspose1d(
            mult * ngf, mult * ngf // 2, 2 * r, stride=r,
            padding=r // 2 + r % 2, output_padding=r % 2))]
        layers += [Res(mult * ngf // 2, 3 ** j) for j in range(3)]
        mult //= 2
    layers += [nn.LeakyReLU(0.2), nn.ReflectionPad1d(3),
               weight_norm(nn.Conv1d(ngf, 1, 7)), nn.Tanh()]
    upstream = nn.Sequential(*layers).eval()
    torch.save({"model." + k: v for k, v in upstream.state_dict().items()},
               tmp_path / "melgan_LJSpeech.pt")
    gen = MelGANGenerator(ngf=ngf).eval()
    gen.load_state_dict(load_melgan(tmp_path / "melgan_LJSpeech.pt"),
                        strict=True)
    mel = torch.randn(1, 5, 80)
    with torch.no_grad():
        want = upstream(mel.transpose(1, 2))[:, 0]
        got = gen(mel)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.save({"model.0.weight": torch.zeros(1)}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="melgan import"):
        load_melgan(tmp_path / "bad.pt")


def test_get_vocoder_melgan_and_log10_input(monkeypatch):
    """MelGAN from a seed, and vocoder_infer hands it log10 mels."""
    from ctts_torch.config import get_configs_of
    from ctts_torch.utils.model import get_vocoder, vocoder_infer
    pre, mc, _ = get_configs_of("LJSpeech")
    mc = dict(mc, vocoder=dict(mc["vocoder"], model="MelGAN"))
    assert get_vocoder(mc, ckpt_dir="/nonexistent", device="cpu") == \
        ("griffin_lim", None)
    name, gen = get_vocoder(mc, ckpt_dir="/nonexistent", device="cpu",
                            dtype=torch.float32, seed=0)
    assert name == "MelGAN"
    seen = []
    monkeypatch.setattr(gen, "forward", lambda m: seen.append(m) or
                        torch.zeros(m.shape[0], m.shape[1] * 256))
    mels = torch.full((1, 3, 80), -4.0)
    wavs = vocoder_infer(mels, (name, gen), pre, lengths=[2])
    assert [len(w) for w in wavs] == [512]
    torch.testing.assert_close(seen[0], mels / np.log(10))


def _tpu_bench_flip():
    """tools/bench_flip.py, imported without keeping the compilation-cache
    settings it makes at import."""
    keep = {name: getattr(jax.config, name)
            for name in ("jax_compilation_cache_dir",
                         "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "_tpu_bench_flip", os.path.join(REPO, "tools", "bench_flip.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for name, value in keep.items():
            jax.config.update(name, value)
    return module


@pytest.mark.parametrize("variant", ["baseline", "row_flip", "lane_rev",
                                     "ladder"])
def test_flip_plain_matches_the_tpu_tool(variant, monkeypatch):
    """Each variant of the port's flip, by index arithmetic, bit-exact
    against the TPU tool's Pallas kernel in interpret mode at T=32 in
    tiles of 8 rows (the tool's constants patched for the trace)."""
    from jax.experimental import pallas as pl
    from ctts_torch.ops.flip import flip, flip_plain, wpad_for
    bf = _tpu_bench_flip()
    T, BQ = 32, 8
    assert wpad_for(bf.T) == bf.WPAD
    for name, value in (("T", T), ("BQ", BQ), ("WPAD", wpad_for(T))):
        monkeypatch.setattr(bf, name, value)
    N = 2
    x = np.random.RandomState(T).randn(N, T, T).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    call = pl.pallas_call(
        functools.partial(bf._kernel, variant=variant),
        grid=(N, T // BQ),
        in_specs=[pl.BlockSpec((1, BQ, T), lambda n, i: (n, i, 0))],
        out_specs=pl.BlockSpec((1, BQ, T), lambda n, i: (n, i, 0)),
        out_shape=jax.ShapeDtypeStruct((N, T, T), jnp.bfloat16),
        interpret=True)
    want = np.asarray(call(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = flip_plain(xt, variant, BQ)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(flip(xt, variant, BQ), got)
