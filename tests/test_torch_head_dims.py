"""Every head width the JAX package computes, in the port, on the CPU.

The four attention kernels of ``ctts_torch/csrc/`` are built for a few
head widths each; their wrappers run any other width up to the widest
instance zero-padded to the next one (``ctts_torch/ops/head_width.py``),
and raise past it. Here, without the card:

- each wrapper's route picks an instance for every width 1..256 the JAX
  package computes, and raises past it; the reformer's fused LSH route is
  taken at the widths, and only those, at which the JAX package takes it;
- each wrapper's card path (``_on_card``: the padding, the instance, the
  trim), with its kernel replaced by the plain version, equals the plain
  version at the true width, forward and gradient, at widths with no
  instance;
- a tiny fs2, conformer and reformer encoder at a newly taken width against
  the JAX package;
- a numpy model of the redesigned flip kernel's per-row index runs, bit for
  bit against ``flip_plain``.
"""

import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ctts_torch.ops import attention, head_width
from ctts_torch.ops import local_window_attention as lw
from ctts_torch.ops import lsh_chunk_attention as lc
from ctts_torch.ops import relpos_attention as ra

from test_torch_train_step import _init_like, _jbatch, _perturb

FLIP_CU = (Path(__file__).resolve().parent.parent / "ctts_torch" / "csrc"
           / "bench_flip.cu")
# the widest instance of each family
FAMILIES = {"attention": (attention, 256), "relpos": (ra, 256),
            "local_window": (lw, 256), "lsh_chunk": (lc, 128)}
# padded against plain, float32, relative to the largest entry: the zero
# columns add exact zeros, so only the order of the sums may differ
PAD_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the routes ------------------------------------------------------------- #

@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_width_takes_the_narrowest_instance(family):
    """d in 1..top runs at the narrowest instance that holds it (itself
    where it has one); past the widest instance the wrapper raises, naming
    F1."""
    mod, top = FAMILIES[family]
    widths = mod._HEAD_DIMS
    assert list(widths) == sorted(widths) and widths[-1] == top
    for d in range(1, top + 1):
        w = mod.kernel_width(d)
        assert w == min(x for x in widths if x >= d), d
    for d in (top + 1, top + 8, 512):
        with pytest.raises(ValueError, match="F1"):
            mod.kernel_width(d)


def test_lsh_route_follows_the_jax_package(monkeypatch):
    """Under CTTS_FUSED_LSH=1 the reformer takes the fused chunk kernels
    exactly where the JAX package's reformer does
    (ctts_tpu/models/reformer.py: its sort gather and
    ``lsh_chunk_attention.supported``), over a grid of (N, cs, n_hashes)
    at which it takes them for some width, and every d in 1..256; the
    heads wider than 128 take the default route. Off by default."""
    from ctts_tpu.ops import lsh_chunk_attention as jlc
    from ctts_tpu.ops import sort_gather as jsg
    monkeypatch.setenv("CTTS_FUSED_LSH", "1")
    grid = 0
    for N in (128, 256, 896, 1024, 4096):
        for cs in (32, 64, 128):
            for nh in (1, 2, 4, 8):
                def jax_fused(d):
                    return (jsg.supported(N, nh * N, 2 * d, backend="tpu")
                            and jlc.supported(N, cs, d, nh, backend="tpu"))
                if N % (2 * cs) or not jax_fused(64):
                    continue
                grid += 1
                for d in range(1, 257):
                    assert lc.supported(d) == jax_fused(d), (N, cs, nh, d)
    assert grid >= 40
    assert lc.supported(128) and not lc.supported(129)
    monkeypatch.setenv("CTTS_FUSED_LSH", "0")
    assert not any(lc.supported(d) for d in range(1, 257))


# ---- the padding, around the plain versions ----------------------------------- #

def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _agree(padded, plain, inputs, cot):
    """Forward and the gradient of every input within PAD_TOL of the
    largest entry."""
    a = [x.clone().requires_grad_(True) for x in inputs]
    b = [x.clone().requires_grad_(True) for x in inputs]
    got, want = padded(*a), plain(*b)
    assert got.shape == want.shape
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    for g, w in [(got, want)] + [(x.grad, y.grad) for x, y in zip(a, b)]:
        err = (g - w).abs().max().item()
        assert err <= PAD_TOL * w.abs().max().item(), err


class _Seen:
    """Stands in for a kernel's autograd Function: runs ``plain`` on what
    the wrapper hands the kernel, and keeps the widths it was handed."""

    def __init__(self, plain):
        self.plain, self.widths = plain, []

    def __call__(self, *args):
        self.widths.append(args[0].shape[-1])
        return self.plain(*args)


@pytest.mark.parametrize("d", [24, 48, 96])
def test_attention_pads_to_its_instance(d, monkeypatch):
    rng = np.random.RandomState(d)
    q, k, v, cot = (_rand(rng, 3, 20, d) for _ in range(4))
    lens = torch.tensor([20, 7, 0], dtype=torch.int32)
    scale = d ** -0.5
    seen = _Seen(attention.attention_plain)
    monkeypatch.setattr(attention._FusedAttention, "apply", seen)
    _agree(lambda *t: attention._on_card(*t, lens, scale),
           lambda *t: attention.attention_plain(*t, lens, scale),
           (q, k, v), cot)
    assert seen.widths == [attention.kernel_width(d)] != [d]


@pytest.mark.parametrize("d", [24, 48, 96])
def test_relpos_pads_to_its_instance(d, monkeypatch):
    """q, k, v, pos and both biases padded; the scale 1/sqrt(d_model) as
    given; with the key mask and dropout (the same hash on both sides)."""
    rng = np.random.RandomState(d)
    B, T, H = 2, 17, 2
    q, k, v, cot = (_rand(rng, B, T, H, d) for _ in range(4))
    pos = _rand(rng, H, T, d)
    ub, vb = _rand(rng, H, d), _rand(rng, H, d)
    mask = torch.zeros(B, T, dtype=torch.bool)
    mask[-1, 12:] = True
    seed = torch.tensor([3, 4], dtype=torch.int64)
    hr = (0, H)

    def kernel(qf, kf, vf, pos_w, ub_w, vb_w, seed_, kmask, scale, p, hr_):
        w = qf.shape[-1]

        def unfold(t):
            return t.reshape(B, H, T, w).permute(0, 2, 1, 3)
        out = ra.relpos_attention_plain(
            unfold(qf), unfold(kf), unfold(vf), pos_w, ub_w, vb_w, scale, p,
            seed_, kmask == 0, hr_)
        return out.permute(0, 2, 1, 3).reshape(B * H, T, w)

    seen = _Seen(kernel)
    monkeypatch.setattr(ra._RelposAttention, "apply", seen)
    _agree(lambda *t: ra._on_card(*t, 0.1, 0.2, seed, mask, hr),
           lambda *t: ra.relpos_attention_plain(*t, 0.1, 0.2, seed, mask,
                                                hr),
           (q, k, v, pos, ub, vb), cot)
    assert seen.widths == [ra.kernel_width(d)] != [d]


@pytest.mark.parametrize("d", [24, 48, 96])
def test_local_window_pads_to_its_instance(d, monkeypatch):
    rng = np.random.RandomState(d)
    G, N, window = 2, 64, 32
    qk, v, cot = (_rand(rng, G, N, d) for _ in range(3))
    valid = torch.from_numpy(rng.rand(G, N) > 0.2)
    scale = d ** -0.5
    seen = _Seen(lambda qk_, v_, valid_, win, sc:
                 lw.local_window_attention_plain(qk_, v_, valid_ != 0, win,
                                                 sc))
    monkeypatch.setattr(lw._LocalWindowAttention, "apply", seen)
    _agree(lambda *t: lw._on_card(*t, valid, window, scale),
           lambda *t: lw.local_window_attention_plain(*t, valid, window,
                                                      scale),
           (qk, v), cot)
    assert seen.widths == [lw.kernel_width(d)] != [d]


@pytest.mark.parametrize("d", [24, 48, 96])
def test_lsh_chunk_pads_to_its_instance(d, monkeypatch):
    """The output and its logsumexp column (d + 1 wide after the trim),
    with a cotangent on both."""
    rng = np.random.RandomState(d)
    G, N, nh, cs = 2, 64, 2, 32
    qk, v = _rand(rng, G, N, d), _rand(rng, G, N, d)
    st = torch.from_numpy(np.stack([rng.permutation(nh * N) % N
                                    for _ in range(G)]).astype(np.int32))
    svalid = torch.from_numpy((rng.rand(G, nh * N) > 0.2).astype(np.int32))
    cot = _rand(rng, G, nh * N, d + 1)
    scale = d ** -0.5
    seen = _Seen(lc.chunk_attention_plain)
    monkeypatch.setattr(lc._ChunkAttention, "apply", seen)
    _agree(lambda *t: lc._on_card(*t, st, svalid, cs, True, scale),
           lambda *t: lc.chunk_attention_plain(*t, st, svalid, cs, True,
                                               scale),
           (qk, v), cot)
    assert seen.widths == [lc.kernel_width(d)] != [d]


def test_pad_heads_appends_zero_columns():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert head_width.pad_heads(x, 3) is x
    assert torch.equal(head_width.pad_heads(x, 5),
                       torch.tensor([[0., 1., 2., 0., 0.],
                                     [3., 4., 5., 0., 0.]]))


# ---- a tiny encoder of each family at a new width, against the JAX package ---- #

T_S = 24


def _encoder_case(block, update):
    """The tiny configs with ``block_type`` and ``update``; the JAX model
    on seeded, perturbed weights and the port's model loaded from them."""
    from ctts_tpu.models.comp_trans_tts import CompTransTTS as JaxModel
    from ctts_tpu.models.comp_trans_tts import prepare_model_config
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.utils.testing import synth_batch, tiny_configs
    from ctts_torch.utils.weights import state_dict_from_jax
    pre, mc, tr = tiny_configs()
    mc["block_type"] = block
    update(mc)
    mc = prepare_model_config(pre, mc)
    jm = JaxModel(pre, mc, tr)
    b = _jbatch(synth_batch(B=2, T_s=T_S, T_m=48, seed=0))
    shapes = jax.eval_shape(lambda rng: jm.init(
        {"params": rng}, step=jnp.zeros((), jnp.int32), deterministic=True,
        speakers=b["speakers"], texts=b["texts"], src_lens=b["src_lens"],
        mode="train_unsup", mels=b["mels"], mel_lens=b["mel_lens"],
        pitch_targets=b["pitch_data"], energy_targets=b["energies"],
        attn_priors=b["attn_priors"]), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tree = _perturb(_init_like(dict(shapes), rng), rng)
    model = CompTransTTS(pre, mc, tr)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    rng = np.random.RandomState(5)
    tokens = rng.randint(1, 300, (2, T_S)).astype(np.int32)
    smask = np.arange(T_S)[None] >= np.array([T_S, 9])[:, None]
    tokens[smask] = 0
    return jm, tree, model.eval(), tokens, smask


def _jax_encoder(jm, tree, tokens, smask, run=None):
    """The JAX encoder's output (``run``'s outputs when given), compiled
    at the CPU backend's cheaper optimization levels: the same float32
    arithmetic, less compile time."""
    run = run or (lambda t, x, m: jm.bind(t).encoder(x, m)[0])
    out = jax.jit(run).lower(tree, tokens, smask).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})(
        tree, tokens, smask)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_encoder(model, tokens, smask):
    with torch.no_grad():
        return model.encoder(torch.from_numpy(tokens).long(),
                             torch.from_numpy(smask))[0].numpy()


def test_fs2_encoder_at_heads_of_16_matches_jax():
    """transformer_fs2 at width 32 in 2 heads: d = 16, an instance the
    fused attention kernel has now."""
    def upd(mc):
        mc["transformer_fs2"].update(encoder_layer=2, encoder_head=2)
    jm, tree, model, tokens, smask = _encoder_case("transformer_fs2", upd)
    want = _jax_encoder(jm, tree, tokens, smask)
    got = _port_encoder(model, tokens, smask)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_conformer_encoder_at_one_head_of_128_matches_jax():
    """The conformer at width 128 in one head: Dh = 128, which the relpos
    kernels take as two chunks of 64."""
    def upd(mc):
        mc["conformer"].update(encoder_layer=1, decoder_layer=1,
                               encoder_hidden=128, decoder_hidden=128,
                               encoder_head=1, decoder_head=1,
                               encoder_dropout=0.0, decoder_dropout=0.0)
    jm, tree, model, tokens, smask = _encoder_case("conformer", upd)
    want = _jax_encoder(jm, tree, tokens, smask)
    got = _port_encoder(model, tokens, smask)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_reformer_encoder_at_heads_of_32_matches_jax():
    """The reformer with the ``transformer`` section at width 32 in one
    head: dim_head 32, for the local-window and LSH kernels; the JAX
    package's hash rotations handed to the port."""
    from ctts_tpu.models import reformer as jr

    def upd(mc):
        mc["transformer"].update(encoder_head=1, decoder_head=1,
                                 encoder_dropout=0.0, decoder_dropout=0.0)
        mc["reformer"].update(depth=2, encoder_head=4, decoder_head=4,
                              bucket_size=4)
    jm, tree, model, tokens, smask = _encoder_case("reformer", upd)
    drawn = []
    normal = jax.random.normal

    def record(key, shape, dtype=jnp.float32):
        out = normal(key, shape, dtype)
        if len(shape) == 5:             # a stack's rotations
            drawn.append(out)
        return out

    def run(t, x, m):
        return jm.bind(t).encoder(x, m)[0], list(drawn)

    with mock.patch.object(jr.jax.random, "normal", record):
        want, rots = _jax_encoder(jm, tree, tokens, smask, run)
    assert len(rots) == 1 and rots[0].shape[2] == 32
    rot = rots[0]
    with mock.patch("ctts_torch.models.reformer._normal",
                    lambda shape, generator, device: torch.tensor(
                        rot, device=device)):
        got = _port_encoder(model, tokens, smask)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---- the flip kernel's index runs ----------------------------------------------- #

def flip_rows_model(x, variant, bq):
    """The redesigned kernel (csrc/bench_flip.cu) in numpy, row by row: a
    row's source row and its two bases, taken once; each output c reads
    c + base, less WPAD past the wrap, where that is inside the row (the
    lane-reversed variant from the row's other end); the two values summed
    in float32 from 0 and rounded once to bf16."""
    from ctts_torch.ops.flip import VARIANTS, wpad_for
    v = VARIANTS.index(variant)
    n, t, _ = x.shape
    wpad = wpad_for(t)
    xs = x.float().numpy()
    out = np.zeros((n, t, t), np.float32)
    c = np.arange(t)
    for q in range(t):
        q0, r = q - q % bq, q % bq
        src = q0 + bq - 1 - r if v == 1 else q
        shift = {1: t - bq - q0 + r, 3: (t - 1 - q0) - r}.get(v, q0 + 1 + r)
        if v == 3 and shift < 0:
            shift += wpad
        assert 0 <= shift < wpad
        b1 = 0 if shift == 0 else wpad - shift
        b2 = t + 1 - shift
        if b2 < 0:
            b2 += wpad
        acc = np.zeros((n, t), np.float32)
        for b in (b1, b2):
            m = c + b
            assert m.max() < 2 * wpad                # one wrap at most
            m = np.where(m >= wpad, m - wpad, m)
            inside = m < t
            idx = np.where(inside, (t - 1 - m) if v == 2 else m, 0)
            acc = acc + np.where(inside, xs[:, src, idx], np.float32(0))
        out[:, q] = acc
    return torch.from_numpy(out).to(torch.bfloat16)


def flip_stores_model(row, t, vec=True):
    """Which lane writes each output of row ``row`` and how: 2-byte stores
    up to the first output at a 16-byte boundary, 16-byte pieces of 8, and
    2-byte stores after the last whole piece; every output exactly once."""
    e0 = row * t
    head = min((8 - e0 % 8) % 8 if vec else t, t)
    pieces = (t - head) // 8
    cols = list(range(head)) + [head + 8 * p + e for p in range(pieces)
                                for e in range(8)]
    cols += list(range(head + 8 * pieces, t))
    assert sorted(cols) == list(range(t))
    assert all((e0 + head + 8 * p) % 8 == 0 for p in range(pieces))
    return head, pieces


def flip_stage_model(s0, t):
    """The elements of a source row that the staging without the bulk copy
    reads: 2-byte loads up to the first 16-byte boundary, whole 16-byte
    pieces, 2-byte loads after the last; each element of the row once."""
    off = s0 % 8
    end = off + t
    first = 0 if off == 0 else 8
    last = end // 8 * 8
    got = list(range(off, min(first, end)))
    got += [8 * p + e for p in range(first // 8, last // 8) for e in range(8)]
    got += list(range(max(last, first), end))
    assert sorted(got) == list(range(off, end)), (s0, t)


@pytest.mark.parametrize("variant", ["baseline", "row_flip", "lane_rev",
                                     "ladder"])
@pytest.mark.parametrize("N,T,BQ", [(3, 30, 3), (1, 1152, 128),
                                    (1, 896, 128), (2, 40, 8)])
def test_flip_row_model_bit_exact(N, T, BQ, variant):
    """The per-row model against ``flip_plain`` bit for bit at the shapes
    of the card test (the tool's [128, 896, 896] as one plane: the
    geometry is the same in every plane), and its stores and staged reads
    cover each row once; the kernel source computes what the model does."""
    from ctts_torch.ops.flip import flip_plain
    rng = np.random.RandomState(T + BQ)
    x = torch.from_numpy(rng.randn(N, T, T).astype(np.float32)).to(
        torch.bfloat16)
    assert torch.equal(flip_rows_model(x, variant, BQ),
                       flip_plain(x, variant, BQ))
    for row in range(0, N * T, max(1, N * T // 97)):
        flip_stores_model(row, T)
        flip_stage_model(row * T, T)
    src = FLIP_CU.read_text()
    for line in ("b1 = shift == 0 ? 0 : g.wpad - shift;",
                 "b2 = g.t + 1 - shift;",
                 "if (m1 >= g.wpad) m1 -= g.wpad;",
                 "if (m1 < g.t) acc += __bfloat162float(s[kRev ? g.t - 1 - m1 : m1]);",
                 "int head = vec ? static_cast<int>((8 - (e0 & 7)) & 7) : g.t;",
                 "const bool tma = vec_in && t % 8 == 0;"):
        assert line in src, line
    assert not re.search(r"%\s*g\.wpad|%\s*wpad", src)     # no modulo by WPAD
