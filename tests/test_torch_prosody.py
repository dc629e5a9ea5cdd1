"""The prosody modules of ctts_torch (ctts_torch/models/prosody.py) against
the JAX package's (ctts_tpu/models/prosody.py), one module at a time, on the
CPU.

Each flax module is initialised, its variables perturbed with numpy (so
biases, norm scales and BatchNorm statistics are not their defaults), and
carried into the port's module through the weight bridge
(``ctts_torch.utils.weights``); both see the same numpy inputs. float32,
dropout off, eval mode unless a test says otherwise; modules with
BatchNorm also in train mode, where the outputs and the moved running
statistics are compared. Sizes: ``ctts_torch.utils.testing.tiny_configs``
(encoder width 32; the liu2021 reference encoder at filters [4, 4, 8], GRU
8, 4 tokens, utterance bottleneck 16; du2021 with 3 Gaussians). Tolerance:
1e-4 absolute on every output.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

ATOL = 1e-4
B, T_S, T_M, N_MEL = 2, 7, 24, 80


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(model_type="liu2021"):
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["prosody_modeling"]["model_type"] = model_type
    return pre, mc, tr


def _perturb(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if path[-1] == "var":
        return np.abs(a) + 0.5 + 0.1 * rng.rand(*a.shape).astype(np.float32)
    return a + 0.05 * rng.randn(*a.shape).astype(np.float32)


def _variables(module, *args, seed=0, **kwargs):
    """Flax variables of ``module`` initialised on ``args``, perturbed."""
    v = module.init({"params": jax.random.PRNGKey(seed)}, *args, **kwargs)
    return _perturb(jax.tree_util.tree_map(np.asarray, dict(v)),
                    np.random.RandomState(seed))


def _module_state_dict(fn, variables):
    """A module's state_dict (floats as float32) from the flax variables of
    its JAX twin through ``fn``, one of the bridge's ``*_sd`` functions."""
    sd = {}
    params = variables["params"]
    if "batch_stats" in variables:
        fn(sd, "m", params, variables["batch_stats"])
    else:
        fn(sd, "m", params)
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float32)
        out[k[2:]] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _port(module, fn, variables, train=False):
    module.load_state_dict(_module_state_dict(fn, variables), strict=True)
    return module.train(train)


def _close(got, want, what=""):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)


def _stats_close(module, new_stats, fn_prefix_pairs):
    """Each port BatchNorm's running statistics against the JAX module's
    updated ``batch_stats``."""
    for bn, node in fn_prefix_pairs(module, new_stats):
        _close(bn.running_mean, node["mean"], "running_mean")
        _close(bn.running_var, node["var"], "running_var")


def _masks(src_lens=(T_S, 5), mel_lens=(T_M, 17)):
    src_lens, mel_lens = np.asarray(src_lens), np.asarray(mel_lens)
    return (np.arange(T_S)[None] >= src_lens[:, None],
            np.arange(T_M)[None] >= mel_lens[:, None], mel_lens)


def _mels(seed=0):
    rng = np.random.RandomState(seed)
    _, mel_mask, _ = _masks()
    mels = (rng.randn(B, T_M, N_MEL) * 0.5 - 4.0).astype(np.float32)
    return mels * ~mel_mask[..., None]


def t(a):
    return torch.from_numpy(np.array(a))


# ---- 1. the GRU helpers --------------------------------------------------- #

@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_matches_jax(bidirectional):
    """Unidirectional with lengths (the ReferenceEncoder's use: memory over
    the padded input, the final state at length - 1), and bidirectional
    without (the ParallelProsodyPredictor's: the backward pass from the
    padded end)."""
    from ctts_tpu.models.prosody import GRU as JGRU
    from ctts_torch.models.prosody import GRU
    from ctts_torch.utils.weights import gru_sd
    x = np.random.RandomState(1).randn(B, T_M, 12).astype(np.float32)
    lengths = None if bidirectional else np.asarray([T_M, 9], np.int32)
    jm = JGRU(8, bidirectional=bidirectional)
    args = (jnp.asarray(x),) + (() if lengths is None
                                else (jnp.asarray(lengths),))
    v = _variables(jm, *args)
    want = jm.apply(v, *args)
    m = _port(GRU(12, 8, bidirectional=bidirectional), gru_sd, v)
    with torch.no_grad():
        got = m(t(x), None if lengths is None else t(lengths))
    _close(got[0], want[0], "memory")
    _close(got[1], want[1], "final")


# ---- 2-4. the segment GRU and the du2021 extractor ------------------------ #

# durations [B, T_S] (the second row has 5 tokens): zeros inside; a first
# phone of duration 0; sums past T_M
DURATIONS = {
    "zeros": ([3, 0, 4, 2, 0, 5, 3], [0, 2, 0, 6, 4, 0, 0]),
    "first_zero": ([0, 3, 4, 2, 1, 5, 3], [0, 0, 5, 6, 2, 0, 0]),
    "overrun": ([6, 5, 0, 7, 4, 6, 9], [9, 8, 3, 7, 2, 0, 0]),
}


def _durations(case):
    return np.asarray(DURATIONS[case], np.float32)


def _reset_pair(mel2ph):
    prev = np.pad(mel2ph[:, :-1], ((0, 0), (1, 0)))
    nxt = np.pad(mel2ph[:, 1:], ((0, 0), (0, 1)))
    return mel2ph != prev, mel2ph != nxt


@pytest.mark.parametrize("case", sorted(DURATIONS))
def test_segment_gru_matches_jax(case):
    """The packed bidirectional GRU (one run of equal mel2ph a sequence)
    and its frame-by-frame oracle against JAX's two SegmentResetGRU scans
    on the mel2ph of durations with zeros, a first phone of duration 0, or
    a sum past T_m; every frame of [B, T_m, 2H]."""
    from ctts_tpu.models.prosody import SegmentResetGRU
    from ctts_torch.models.prosody import segment_gru, segment_gru_loop
    from ctts_torch.ops.length_regulator import dur_to_mel2ph
    from ctts_torch.utils.weights import gru_sd
    src_mask, _, _ = _masks()
    x = np.random.RandomState(2).randn(B, T_M, 10).astype(np.float32)
    mel2ph = dur_to_mel2ph(t(_durations(case)), t(src_mask),
                           max_len=T_M).numpy()
    reset_f, reset_b = _reset_pair(mel2ph)
    fwd, bwd = SegmentResetGRU(6), SegmentResetGRU(6, reverse=True)
    vf = _variables(fwd, jnp.asarray(x), jnp.asarray(reset_f), seed=1)
    vb = _variables(bwd, jnp.asarray(x), jnp.asarray(reset_b), seed=2)
    want = np.concatenate(
        [fwd.apply(vf, jnp.asarray(x), jnp.asarray(reset_f)),
         bwd.apply(vb, jnp.asarray(x), jnp.asarray(reset_b))], axis=-1)
    gru = torch.nn.GRU(10, 6, batch_first=True, bidirectional=True)
    _port(gru, gru_sd, {"params": {"fwd": vf["params"],
                                   "bwd": vb["params"]}})
    with torch.no_grad():
        packed = segment_gru(gru, t(x), t(mel2ph))
        loop = segment_gru_loop(gru, t(x), t(mel2ph))
    _close(packed, want, "packed")
    _close(loop, want, "loop")


@pytest.mark.parametrize("train", [False, True])
def test_conv_block_2d_matches_jax(train):
    """(1, k) conv + BatchNorm + ReLU over (time, mel); in train mode the
    batch statistics pool the padded batch and the running statistics
    move by flax's momentum."""
    from ctts_tpu.models.prosody import _ConvBlock2DMel
    from ctts_torch.models.prosody import ConvBlock2D
    from ctts_torch.utils.weights import conv_block_2d_sd
    x = np.random.RandomState(3).randn(B, T_M, N_MEL, 3).astype(np.float32)
    jm = _ConvBlock2DMel(5, 9)
    v = _variables(jm, jnp.asarray(x))
    want, new = jm.apply(v, jnp.asarray(x), training=train,
                         mutable=["batch_stats"])
    m = _port(ConvBlock2D(3, 5, 9), conv_block_2d_sd, v, train=train)
    with torch.no_grad():
        got = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)
    bn = m.conv_layer[1]
    stats = new["batch_stats"]["BatchNorm_0"]
    _close(bn.running_mean, stats["mean"], "running_mean")
    _close(bn.running_var, stats["var"], "running_var")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(DURATIONS))
def test_du_extractor_matches_jax(case, train, monkeypatch):
    """The extractor's phone embeddings [B, T_s, 2·d] (eval mode: running
    statistics; train mode: batch statistics, and the moved running ones),
    with the packed GRU and with its loop oracle in its place."""
    from ctts_tpu.models.prosody import DuProsodyExtractor as JExtractor
    from ctts_torch.models import prosody
    from ctts_torch.models.prosody import DuProsodyExtractor
    from ctts_torch.utils.weights import du_extractor_sd
    src_mask, mel_mask, mel_lens = _masks()
    mels, dur = _mels(), _durations(case)
    args = (jnp.asarray(mels), jnp.asarray(mel_lens), jnp.asarray(dur),
            jnp.asarray(src_mask), T_M)
    jm = JExtractor(N_MEL, 16, 9)
    v = _variables(jm, *args)
    want, new = jm.apply(v, *args, training=train, mutable=["batch_stats"])
    for loop in (False, True):
        if loop:
            monkeypatch.setattr(prosody, "segment_gru",
                                prosody.segment_gru_loop)
        m = _port(DuProsodyExtractor(N_MEL, 16, 9), du_extractor_sd, v,
                  train=train)
        with torch.no_grad():
            got = m(t(mels), t(dur), t(src_mask))
        _close(got, want, f"loop={loop}")
        for i in (0, 1):
            bn = m.conv_stack[i].conv_layer[1]
            stats = new["batch_stats"][f"conv_{i}"]["BatchNorm_0"]
            _close(bn.running_mean, stats["mean"], f"conv_{i} mean")
            _close(bn.running_var, stats["var"], f"conv_{i} var")


def test_du_extractor_gradients_match_jax():
    """The extractor's input gradient through the packed GRU (train mode)
    against jax.grad of the same sum of squares."""
    from ctts_tpu.models.prosody import DuProsodyExtractor as JExtractor
    from ctts_torch.models.prosody import DuProsodyExtractor
    from ctts_torch.utils.weights import du_extractor_sd
    src_mask, _, mel_lens = _masks()
    mels, dur = _mels(1), _durations("zeros")
    jm = JExtractor(N_MEL, 16, 9)
    rest = (jnp.asarray(mel_lens), jnp.asarray(dur), jnp.asarray(src_mask),
            T_M)
    v = _variables(jm, jnp.asarray(mels), *rest)

    def f(mel):
        e, _ = jm.apply(v, mel, *rest, training=True, mutable=["batch_stats"])
        return jnp.sum(e ** 2)

    want = jax.grad(f)(jnp.asarray(mels))
    m = _port(DuProsodyExtractor(N_MEL, 16, 9), du_extractor_sd, v,
              train=True)
    mel = t(mels).requires_grad_(True)
    (m(mel, t(dur), t(src_mask)) ** 2).sum().backward()
    top = np.abs(np.asarray(want)).max()
    assert top > 0
    np.testing.assert_allclose(mel.grad.numpy() / top, np.asarray(want) / top,
                               atol=ATOL, rtol=0)


# ---- 5-7. the du2021 predictor -------------------------------------------- #

def test_masked_conv_block_matches_jax():
    from ctts_tpu.models.prosody import _MaskedConvBlock
    from ctts_torch.models.prosody import ConvBlock
    from ctts_torch.utils.weights import masked_conv_block_sd
    src_mask, _, _ = _masks()
    x = np.random.RandomState(4).randn(B, T_S, 32).astype(np.float32)
    jm = _MaskedConvBlock(32, 5, 0.2)
    v = _variables(jm, jnp.asarray(x), jnp.asarray(src_mask))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(src_mask))
    m = _port(ConvBlock(32, 32, 5, 0.2), masked_conv_block_sd, v)
    with torch.no_grad():
        _close(m(t(x), t(src_mask)), want)


def test_mdn_matches_jax():
    """Weights, sigma = exp(clip(·, ±12)) (inputs large enough to clip) and
    mu."""
    from ctts_tpu.models.prosody import MDN as JMDN
    from ctts_torch.models.prosody import MDN
    from ctts_torch.utils.weights import mdn_sd
    x = np.random.RandomState(5).randn(B, T_S, 16).astype(np.float32)
    x[0, 0] *= 60.0
    jm = JMDN(8, 3)
    v = _variables(jm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = _port(MDN(16, 8, 3), mdn_sd, v)
    with torch.no_grad():
        got = m(t(x))
    assert float(jnp.max(want[1])) == pytest.approx(np.exp(12.0), rel=1e-6)
    for g, w, what in zip(got, want, ("w", "sigma", "mu")):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g / scale, np.asarray(w) / scale, what)


@pytest.mark.parametrize("training", [True, False])
def test_du_predictor_matches_jax(training):
    """The autoregressive GRU over phones and the mixture, padded phones'
    weights filled with 0 in training and 1e-9 at inference."""
    from ctts_tpu.models.prosody import DuProsodyPredictor as JPredictor
    from ctts_torch.models.prosody import DuProsodyPredictor
    from ctts_torch.utils.weights import du_predictor_sd
    src_mask, _, _ = _masks()
    h = np.random.RandomState(6).randn(B, T_S, 16).astype(np.float32)
    jm = JPredictor(16, (9, 5), 3, 0.2)
    v = _variables(jm, jnp.asarray(h), jnp.asarray(src_mask))
    want = jm.apply(v, jnp.asarray(h), jnp.asarray(src_mask),
                    training=training)
    m = _port(DuProsodyPredictor(16, (9, 5), 3, 0.2), du_predictor_sd, v)
    with torch.no_grad():
        got = m(t(h), t(src_mask), training=training)
    for g, w, what in zip(got, want, ("w", "sigma", "mu")):
        _close(g, w, what)
    assert (got[0][1, 5:] == (0.0 if training else 1e-9)).all()


def test_sample_with_jax_draws():
    """``sample`` given the components and noise JAX drew from its key
    gives JAX's samples; its own draws come from the generator (equal for
    equal seeds, seed 0 when none is given), pick the only component with
    weight, and give 0 at padding."""
    from ctts_tpu.models.prosody import DuProsodyPredictor as JPredictor
    from ctts_torch.models.prosody import DuProsodyPredictor
    src_mask, _, _ = _masks()
    rng = np.random.RandomState(7)
    w = rng.dirichlet(np.ones(3), size=(B, T_S)).astype(np.float32)
    sigma = (rng.rand(B, T_S, 3, 8) + 0.1).astype(np.float32)
    mu = rng.randn(B, T_S, 3, 8).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = JPredictor.sample(jnp.asarray(w), jnp.asarray(sigma),
                             jnp.asarray(mu), key, jnp.asarray(src_mask))
    k_rng, n_rng = jax.random.split(key)
    comp = np.asarray(jax.random.categorical(
        k_rng, jnp.log(jnp.clip(jnp.asarray(w), 1e-9, None))))
    noise = np.asarray(jax.random.normal(n_rng, (B, T_S, 8)))
    got = DuProsodyPredictor.sample(t(w), t(sigma), t(mu),
                                    src_mask=t(src_mask),
                                    component=t(comp), noise=t(noise))
    _close(got, want)

    def draw(gen):
        return DuProsodyPredictor.sample(t(w), t(sigma), t(mu), gen,
                                         t(src_mask))

    seeded = draw(torch.Generator().manual_seed(0))
    assert torch.equal(draw(None), seeded)
    assert not torch.equal(draw(torch.Generator().manual_seed(1)), seeded)
    assert not seeded[1, 5:].any()
    one_hot = np.zeros_like(w)
    one_hot[..., 2] = 1.0
    got = DuProsodyPredictor.sample(t(one_hot), t(sigma), t(mu),
                                    noise=torch.zeros(B, T_S, 8))
    _close(got, mu[:, :, 2])


# ---- 8-11. the liu2021 encoders ------------------------------------------- #

def test_coord_conv_matches_jax():
    """The coordinate channels (h, w, rr after normalisation, the −0.5
    offset kept) and the strided conv."""
    from ctts_tpu.models.prosody import CoordConv2d as JCoord
    from ctts_torch.models.prosody import CoordConv2d
    from ctts_torch.utils.weights import coord_conv_sd
    x = np.random.RandomState(8).randn(B, T_M, N_MEL, 1).astype(np.float32)
    jm = JCoord(4, (3, 3), (1, 2), (1, 1))
    v = _variables(jm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = _port(CoordConv2d(1, 4, (3, 3), (1, 2), (1, 1)), coord_conv_sd, v)
    with torch.no_grad():
        got = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)


def _bns(module, stats):
    return [(bn, stats[f"bn_{i}"]) for i, bn in enumerate(module.bns)]


@pytest.mark.parametrize("train", [False, True])
def test_reference_encoder_matches_jax(train):
    """Memory [B, T, H] and the final state at each mel length; the conv
    outputs flattened in (C, W) order; BatchNorm in eval and train mode,
    with the moved running statistics."""
    from ctts_tpu.models.prosody import ReferenceEncoder as JRef
    from ctts_torch.models.prosody import ReferenceEncoder
    from ctts_torch.utils.weights import reference_encoder_sd
    pre, mc, _ = _configs()
    _, mel_mask, _ = _masks()
    mels = _mels(2)
    jm = JRef(pre, mc)
    v = _variables(jm, jnp.asarray(mels), jnp.asarray(mel_mask))
    want, new = jm.apply(v, jnp.asarray(mels), jnp.asarray(mel_mask),
                         training=train, mutable=["batch_stats"])
    m = _port(ReferenceEncoder(pre, mc), reference_encoder_sd, v,
              train=train)
    with torch.no_grad():
        got = m(t(mels), t(mel_mask))
    _close(got[0], want[0], "memory")
    _close(got[1], want[1], "final")
    _stats_close(m, new["batch_stats"], _bns)


def test_style_tokens_match_jax():
    """The style-token layer: tanh tokens, one-head attention of the query
    over them."""
    from ctts_tpu.models.prosody import STL as JSTL
    from ctts_torch.models.prosody import STL
    from ctts_torch.utils.weights import stl_sd
    _, mc, _ = _configs()
    q = np.random.RandomState(9).randn(B, 16).astype(np.float32)
    jm = JSTL(mc)
    v = _variables(jm, jnp.asarray(q))
    want = jm.apply(v, jnp.asarray(q))
    m = _port(STL(mc), stl_sd, v)
    with torch.no_grad():
        _close(m(t(q)), want)


def _encoder_bns(module, stats):
    return _bns(module.encoder, stats["encoder"])


@pytest.mark.parametrize("train", [False, True])
def test_utterance_encoder_matches_jax(train):
    from ctts_tpu.models.prosody import UtteranceLevelProsodyEncoder as JUtt
    from ctts_torch.models.prosody import UtteranceLevelProsodyEncoder
    from ctts_torch.utils.weights import prosody_encoder_sd
    pre, mc, _ = _configs()
    _, mel_mask, _ = _masks()
    mels = _mels(3)
    jm = JUtt(pre, mc)
    v = _variables(jm, jnp.asarray(mels), jnp.asarray(mel_mask))
    want, new = jm.apply(v, jnp.asarray(mels), jnp.asarray(mel_mask),
                         deterministic=not train, mutable=["batch_stats"])
    m = _port(UtteranceLevelProsodyEncoder(pre, mc), prosody_encoder_sd, v,
              train=train)
    with torch.no_grad():
        got = m(t(mels), t(mel_mask))
    _close(got, want)
    _stats_close(m, new["batch_stats"], _encoder_bns)


def test_phoneme_encoder_matches_jax():
    """Phone embeddings and the [B, T_s, T_m] attention: −inf at mel
    padding before the softmax, 0 at text padding after it."""
    from ctts_tpu.models.prosody import PhonemeLevelProsodyEncoder as JPh
    from ctts_torch.models.prosody import PhonemeLevelProsodyEncoder
    from ctts_torch.utils.weights import prosody_encoder_sd
    pre, mc, _ = _configs()
    src_mask, mel_mask, _ = _masks()
    mels = _mels(4)
    x = np.random.RandomState(10).randn(B, T_S, 32).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, src_mask, mels, mel_mask)]
    jm = JPh(pre, mc)
    v = _variables(jm, *args)
    want = jm.apply(v, *args)
    m = _port(PhonemeLevelProsodyEncoder(pre, mc), prosody_encoder_sd, v)
    with torch.no_grad():
        got = m(t(x), t(src_mask), t(mels), t(mel_mask))
    _close(got[0], want[0], "embeddings")
    _close(got[1], want[1], "attention")
    assert not got[1][1, :, 17:].any() and not got[1][1, 5:].any()


# ---- 13-14. the liu2021 predictors and the whole -------------------------- #

@pytest.mark.parametrize("phoneme_level", [True, False])
def test_parallel_predictor_matches_jax(phoneme_level):
    from ctts_tpu.models.prosody import ParallelProsodyPredictor as JPar
    from ctts_torch.models.prosody import ParallelProsodyPredictor
    from ctts_torch.utils.weights import parallel_predictor_sd
    _, mc, _ = _configs()
    x = np.random.RandomState(11).randn(B, T_S, 32).astype(np.float32)
    jm = JPar(mc, phoneme_level=phoneme_level)
    v = _variables(jm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = _port(ParallelProsodyPredictor(mc, phoneme_level),
              parallel_predictor_sd, v)
    with torch.no_grad():
        _close(m(t(x)), want)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("phoneme_level", [True, False])
def test_nonparallel_predictor_matches_jax(phoneme_level, masked):
    from ctts_tpu.models.prosody import NonParallelProsodyPredictor as JNon
    from ctts_torch.models.prosody import NonParallelProsodyPredictor
    from ctts_torch.utils.weights import nonparallel_predictor_sd
    _, mc, _ = _configs()
    src_mask, _, _ = _masks()
    x = np.random.RandomState(12).randn(B, T_S, 32).astype(np.float32)
    mask = src_mask if masked else None
    jargs = (jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    jm = JNon(mc, phoneme_level=phoneme_level)
    v = _variables(jm, *jargs)
    want = jm.apply(v, *jargs)
    m = _port(NonParallelProsodyPredictor(mc, phoneme_level),
              nonparallel_predictor_sd, v)
    with torch.no_grad():
        _close(m(t(x), None if mask is None else t(mask)), want)


@pytest.mark.parametrize("training", [True, False])
def test_liu_prosody_matches_jax(training):
    """The hidden plus the utterance and phone prosody (the encoders'
    targets in training, the predictors' vectors at inference), and every
    entry of its prosody info."""
    from ctts_tpu.models.prosody import LiuProsody as JLiu
    from ctts_torch.models.prosody import liu_prosody, liu_prosody_modules
    from ctts_torch.utils.weights import liu_prosody_sd
    pre, mc, _ = _configs()
    src_mask, mel_mask, _ = _masks()
    mels = _mels(5)
    x = np.random.RandomState(13).randn(B, T_S, 32).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, src_mask, mels, mel_mask)]
    jm = JLiu(pre, mc)
    v = _variables(jm, *args)
    want = jm.apply(v, *args, training=training)
    m = _port(torch.nn.ModuleDict(liu_prosody_modules(pre, mc)),
              liu_prosody_sd, v)
    with torch.no_grad():
        got = liu_prosody(m, t(x), t(src_mask), t(mels), t(mel_mask),
                          training)
    _close(got[0], want[0], "x")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if w is None:
            assert g is None, i
        else:
            _close(g, w, f"info[{i}]")


# ---- the bridge ----------------------------------------------------------- #

@pytest.mark.parametrize("model_type", ["du2021", "liu2021"])
def test_bridge_round_trip(model_type):
    """A JAX CompTransTTS tree with the prosody model → the port's
    state_dict → ``ctts_tpu.utils.torch_import.import_reference_checkpoint``
    → the same tree, leaf for leaf (the BatchNorm statistics included);
    and back through ``jax_tree_from_state_dict``. The JAX importer reads
    six reference-encoder convs (``import_liu_prosody``'s ``n_filters``),
    so liu2021 runs here at six narrow filters."""
    from ctts_tpu.models.comp_trans_tts import CompTransTTS as JModel
    from ctts_tpu.utils.torch_import import import_reference_checkpoint
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.utils.testing import synth_batch
    from ctts_torch.utils.weights import (jax_tree_from_state_dict,
                                          state_dict_from_jax)
    pre, mc, tr = _configs(model_type)
    mc["duration_modeling"]["learn_alignment"] = False
    mc["prosody_modeling"]["liu2021"]["ref_enc_filters"] = [2, 2, 4, 4, 4, 8]
    b = synth_batch(B=B, T_s=T_S, T_m=T_M, sup=True, phone_energy=True)
    jm = JModel(pre, mc, tr)
    shapes = jax.eval_shape(lambda key: jm.init(
        {"params": key}, jnp.asarray(b["speakers"]), jnp.asarray(b["texts"]),
        jnp.asarray(b["src_lens"]), "train_sup", mels=jnp.asarray(b["mels"]),
        mel_lens=jnp.asarray(b["mel_lens"]),
        pitch_targets={k: jnp.asarray(v) for k, v in b["pitch_data"].items()},
        energy_targets=jnp.asarray(b["energies"]),
        duration_targets=jnp.asarray(b["durations"]),
        step=jnp.zeros((), jnp.int32)), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tree = _perturb(jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), dict(shapes)), rng)
    model = CompTransTTS(pre, mc, tr)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    sd = model.state_dict()
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for back in (import_reference_checkpoint(sd, pre, mc),
                 jax_tree_from_state_dict(sd, mc)):
        got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert {jax.tree_util.keystr(k) for k in got} == \
            {jax.tree_util.keystr(k) for k in want}
        got = {jax.tree_util.keystr(k): v for k, v in got.items()}
        for k, w in want.items():
            np.testing.assert_array_equal(
                np.asarray(got[jax.tree_util.keystr(k)]), np.asarray(w),
                err_msg=jax.tree_util.keystr(k))
    va = tree["params"]["variance_adaptor"]
    assert ("prosody_extractor" in va) == (model_type == "du2021")
    assert ("liu_prosody" in va) == (model_type == "liu2021")
