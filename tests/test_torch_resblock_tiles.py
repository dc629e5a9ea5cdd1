"""The tile geometry of the fused HiFi-GAN ResBlock1 kernel
(ctts_torch/csrc/fused_resblock.cu), modelled in numpy and held to the JAX
package on the CPU.

The kernel runs each conv of the chain as an implicit GEMM on the tensor
cores over one time tile plus the chain's halo: the activations live in
shared memory time-major ([t][c]), tap j of a conv with dilation d reads
the rows t + j·d. Before each first conv Y takes lrelu(X) once; the first
conv reads Y and writes its output over it in place, round after round,
and the second conv updates X in place. The buffers shrink
by d·p and then p rows a side per dilation, a conv's m-tiles (16 rows) are
dealt to the warps' row groups in rounds, and the last m-tile of a conv
reads up to 15 rows past its input's live rows (the buffers' slack). The
weights stream in stages of (conv, tap, chunk of kc inputs), laid out by
``pack_weights``; float32 splits every operand into bf16 hi + lo and sums
three products. The model repeats that geometry with every row the kernel
may read but must not use (the slack, stale rows of earlier passes, halo
already consumed) set to NaN, so a read that reaches a stored output
fails; it reads the constants it models from the CUDA source and the
wrapper, so a change there fails here until the model follows. The card
tests (tests/test_torch_gpu.py) hold the kernel itself.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.ops import fused_resblock as jfr
from ctts_torch.ops import fused_resblock as fr

CU = (pathlib.Path(__file__).resolve().parents[1] / "ctts_torch" / "csrc"
      / "fused_resblock.cu")
# float32 (three products of the hi/lo split, summed here in float64):
# relative to the largest entry of the JAX reference; each product is
# within ~3·2^-16 of the float32 one and the sums run in another order
TOL_F32 = 1e-5
# bf16 against the port's plain version: the same roundings, the float32
# sums in another order, so a value within float32 rounding of a bf16
# boundary may land on its neighbour and carry through the chain
TOL_BF16 = 2e-2

WARPS, SLACK, STAGES = 12, 15, 2      # kWarps, kSlack, kStages
MT = {torch.bfloat16: 4, torch.float32: 2}
PLANES = {torch.bfloat16: 1, torch.float32: 2}
PAD = {torch.bfloat16: 16, torch.float32: 32}


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def rnd(a, dtype):
    """Round float32 values to the compute dtype (as float32)."""
    a = np.asarray(a, np.float32)
    return _bf16(a) if dtype == torch.bfloat16 else a


def lrelu(a, dtype):
    a = np.asarray(a, np.float32)
    return np.where(a > 0, a, rnd(a * np.float32(0.1), dtype))


def split(a):
    """bf16 hi and lo of float32 values: hi + lo is a to ~2^-16."""
    hi = _bf16(a)
    return hi, _bf16(np.asarray(a, np.float32) - hi)


def deal(mtiles, row_groups, mt_max):
    """The kernel's rounds: [(round, row group, first m-tile, count)]."""
    cap = row_groups * mt_max
    out = []
    for r in range(-(-mtiles // cap)):
        first = r * cap
        n_r = min(mtiles - first, cap)
        mt = -(-n_r // row_groups)
        for rg in range(row_groups):
            m0 = first + rg * mt
            out.append((r, rg, m0, max(0, min(mt, first + n_r - m0))))
    return out


def stage_order(n_dil, k, nck, rounds):
    """(conv, round, tap·nck + chunk) of every weight stage, in the order
    the kernel's stream issues them (the order its convs consume them)."""
    return [(c, r, tc) for c in range(2 * n_dil) for r in range(rounds[c])
            for tc in range(k * nck)]


def kernel_model(x, packed, k, dilations, bt, dtype):
    """The kernel on x [N, C, T] (float32 holding compute-dtype values) with
    the packed weights: tile by tile, conv by conv, the rows it reads and
    writes. Returns [N, C, T] float32."""
    w, b = (t.float().numpy() for t in packed)
    N, C, T = x.shape
    p = (k - 1) // 2
    halo = fr.chain_halo(k, dilations)
    geo = fr.geometry(C, dtype, k, dilations, bt)
    kc = fr.ci_chunk(C, dtype)
    nck = C // kc
    groups = C // (8 * fr.n_tiles(C))
    rg = WARPS // groups
    for c, lout in enumerate(geo["lout"]):
        mtiles = -(-lout // 16)
        got = sorted(m for _, _, m0, n in deal(mtiles, rg, MT[dtype])
                     for m in range(m0, m0 + n))
        assert got == list(range(mtiles))           # each m-tile once
        assert max(r for r, *_ in deal(mtiles, rg, MT[dtype])) + 1 == \
            geo["rounds"][c]
    # the stage s of the stream is packed stage (conv, tap, chunk) at
    # offset (conv·k·nck + tc) · stage_elems
    flat = w.reshape(-1, PLANES[dtype] * C * kc)
    n_dil = len(dilations)
    for s, (c, r, tc) in enumerate(stage_order(n_dil, k, nck, geo["rounds"])):
        if r == 0:
            np.testing.assert_array_equal(
                flat[c * k * nck + tc],
                w[c // 2, c % 2, tc // nck, tc % nck].reshape(-1))
    # W[conv][j] [C_out, C_in] from the stages, per plane
    wj = w.transpose(0, 1, 2, 4, 5, 3, 6).reshape(
        n_dil, 2, k, PLANES[dtype], C, C)

    def gemm(a, conv, j):
        di, which = divmod(conv, 2)
        planes = wj[di, which, j]
        if dtype == torch.bfloat16:
            return a.astype(np.float64) @ planes[0].T.astype(np.float64)
        ah, al = split(a)
        wh, wl = (planes[i].T.astype(np.float64) for i in range(2))
        ah, al = ah.astype(np.float64), al.astype(np.float64)
        return al @ wh + ah @ wl + ah @ wh

    out = np.full_like(x, np.nan)
    l0 = bt + 2 * halo
    for n in range(N):
        for tile0 in range(0, T, bt):
            X = np.full((l0 + SLACK, C), np.nan, np.float32)
            pos = tile0 - halo + np.arange(l0)
            inside = (pos >= 0) & (pos < T)
            X[:l0] = 0
            X[:l0][inside] = x[n][:, pos[inside]].T
            Y = np.full((l0 + SLACK, C), np.nan, np.float32)
            xoff, base = 0, tile0 - halo
            for di, d in enumerate(dilations):
                h1 = d * p
                length = geo["lout"][2 * di] + 2 * h1    # X's live rows
                Y[:] = np.nan
                Y[:length] = lrelu(X[xoff:xoff + length], dtype)
                for which in (0, 1):
                    conv = 2 * di + which
                    lout = geo["lout"][conv]
                    src, dil = (Y, d) if which == 0 else (Y, 1)
                    dst_base = base + h1 + (p if which else 0)
                    # round by round: a round reads what earlier rounds of
                    # the first conv left in Y (it writes in place)
                    rounds = {}
                    for r, _, m0, cnt in deal(-(-lout // 16), rg, MT[dtype]):
                        rounds.setdefault(r, []).extend(range(m0, m0 + cnt))
                    for r in sorted(rounds):
                        lo, hi = min(rounds[r]) * 16, (max(rounds[r]) + 1) * 16
                        acc = np.zeros((hi - lo, C))
                        for j in range(k):
                            a = src[lo + j * dil:hi + j * dil]
                            assert len(a) == hi - lo, "a tap reads past Y"
                            acc += gemm(a, conv, j)
                        hi = min(hi, lout)                # rows stored
                        y = rnd(acc[:hi - lo].astype(np.float32)
                                + b[di, which], dtype)
                        v = dst_base + np.arange(lo, hi)
                        keep = ((v >= 0) & (v < T))[:, None]
                        if which == 0:
                            Y[lo:hi] = np.where(keep, lrelu(y, dtype), 0)
                        else:
                            at = xoff + h1 + p
                            X[at + lo:at + hi] = np.where(
                                keep, rnd(X[at + lo:at + hi] + y, dtype), 0)
                    if which == 0:
                        Y[lout:] = np.nan                 # not the output
                    else:
                        at = xoff + h1 + p
                        X[:at] = np.nan                   # consumed halo
                        X[at + lout:] = np.nan
                xoff += h1 + p
                base += h1 + p
            assert base == tile0
            v = min(bt, T - tile0)
            out[n][:, tile0:tile0 + v] = X[xoff:xoff + v].T
    assert not np.isnan(out).any(), "a stored value read a row it must not"
    return out


def _case(C, T, k, seed, N=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, C, T) * 0.5).astype(np.float32)
    convs = []
    for _ in range(2):
        w = (rng.randn(3, k, C, C) * (C * k) ** -0.5).astype(np.float32)
        b = (rng.randn(3, C) * 0.1).astype(np.float32)
        convs.append((torch.from_numpy(w), torch.from_numpy(b)))
    return x, convs


def _cu_const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert m, name
    return int(m.group(1))


def test_model_mirrors_the_kernel_source():
    text = CU.read_text()
    assert _cu_const("kWarps") == WARPS == fr.WARPS
    assert _cu_const("kSlack") == SLACK == fr.SLACK
    assert _cu_const("kStages") == STAGES == fr.STAGES
    assert _cu_const("kMaxSmem") == fr.SMEM_LIMIT == 227 * 1024
    assert _cu_const("kMaxDil") == fr.MAX_DILATIONS
    for name, dt in (("bf16", torch.bfloat16), ("float", torch.float32)):
        m = re.search(rf"struct Cfg<{name}> {{\s*static constexpr int kMt = "
                      rf"(\d+), kPlanes = (\d+), kPad = (\d+);", text)
        assert m, name
        assert tuple(map(int, m.groups())) == (MT[dt], PLANES[dt], PAD[dt])
        assert (fr.MT[dt], fr.PLANES[dt], fr.ROW_PAD[dt]) == tuple(
            map(int, m.groups()))
    assert ("return Cfg<T>::kPlanes == 1 && c % 64 == 0 ? 64 : c % 32 == 0 ? "
            "32 : 16;") in text
    assert "return c % 64 == 0 ? 8 : c % 32 == 0 ? 4 : 2;" in text
    assert [fr.n_tiles(c) for c in (16, 32, 48, 64, 96, 128)] == [2, 4, 2,
                                                                 8, 4, 8]
    assert "g.cg = c / (8 * NT);" in text
    assert [fr.ci_chunk(c, torch.bfloat16) for c in (16, 32, 48, 64, 128)
            ] == [16, 32, 16, 64, 64]
    assert [fr.ci_chunk(c, torch.float32) for c in (16, 32, 48, 64, 128)
            ] == [16, 32, 16, 32, 32]
    # the launcher's shared memory, as geometry() counts it
    assert ("(g.x_rows + g.y_rows) * g.xs +\n"
            "                      static_cast<size_t>(kStages) * g.stage_bytes"
            ) in text
    assert "g.xs = c * static_cast<int>(sizeof(T)) + Cfg<T>::kPad;" in text
    assert "g.ws = g.kc * 2 + 16;" in text
    assert "g.x_rows = g.y_rows = bt + 2 * g.halo + kSlack;" in text


def test_rows_of_an_ldmatrix_fall_in_distinct_banks():
    """The padded row strides: the 8 rows of an ldmatrix (activations at
    any tap shift, and the weight rows) in 8 distinct 16-byte bank groups;
    float32's 4 rows of 8-byte loads a quarter-warp in 4 distinct 32-byte
    groups."""
    for C in range(16, 513, 16):
        xs = C * 2 + PAD[torch.bfloat16]
        assert len({(r * xs) % 128 // 16 for r in range(8)}) == 8
        xs = C * 4 + PAD[torch.float32]
        assert len({(r * xs) % 128 // 32 for r in range(4)}) == 4
        ws = fr.ci_chunk(C, torch.bfloat16) * 2 + 16
        assert len({(r * ws) % 128 // 16 for r in range(8)}) == 8


@pytest.mark.parametrize("C,dtype,k,bt", [
    (128, torch.bfloat16, 11, 224), (128, torch.bfloat16, 7, 272),
    (128, torch.bfloat16, 3, 256), (64, torch.bfloat16, 11, 608),
    (32, torch.bfloat16, 11, 1024), (128, torch.float32, 11, 32)])
def test_block_t_from_shared_memory_and_rounds(C, dtype, k, bt):
    """The tile the wrapper picks at the probe's levels: the cheapest by
    block_cost of those that fit the card's shared memory. At C=128, k=11,
    bf16, X and Y take 344 + 334 rows (+ slack) of 272 bytes and the two
    weight stages of 64 inputs 36 KB, and 1.26x the output rows are
    computed (bt = 128 would compute 1.46x)."""
    assert fr.block_t_for(C, dtype, k, (1, 3, 5)) == bt
    geo = fr.geometry(C, dtype, k, (1, 3, 5), bt)
    assert geo["smem"] <= fr.SMEM_LIMIT
    if bt < 1024:                              # the default cap
        assert fr.geometry(C, dtype, k, (1, 3, 5), bt + 16)["smem"] > \
            fr.SMEM_LIMIT or fr.block_cost(C, dtype, k, (1, 3, 5),
                                           bt + 16) > \
            fr.block_cost(C, dtype, k, (1, 3, 5), bt)


def test_pack_weights_layout():
    """Stage (conv, tap, chunk) holds W[co, c0:c0+kc] of that tap, rows
    co; float32 as hi and lo planes that sum to the weight within 2^-16."""
    _, (c1, c2) = _case(48, 8, 3, 0)
    for dtype in (torch.bfloat16, torch.float32):
        w, b = fr.pack_weights(c1, c2, dtype)
        kc = fr.ci_chunk(48, dtype)
        assert w.shape == (3, 2, 3, 48 // kc, PLANES[dtype], 48, kc)
        assert w.dtype == torch.bfloat16 and b.shape == (3, 2, 48)
        src = c2[0][1, 2]                      # dilation 1, conv 2, tap 2
        got = w[1, 1, 2, :, 0].permute(1, 0, 2).reshape(48, 48).float()
        if dtype == torch.float32:
            got = got + w[1, 1, 2, :, 1].permute(1, 0, 2).reshape(48, 48).float()
            assert (got - src.T).abs().max() <= 2 ** -16 * src.abs().max()
        else:
            assert torch.equal(got, src.T.to(torch.bfloat16).float())
        assert torch.equal(b[2, 0], c1[1][2])


def test_split_products():
    """hi·hi + hi·lo + lo·hi of the bf16 split against the float64 product:
    within 3·2^-16 of |a·b| (the lo·lo term and each lo's own rounding)."""
    rng = np.random.RandomState(1)
    a, bb = (rng.randn(10000).astype(np.float32) for _ in range(2))
    (ah, al), (bh, bl) = split(a), split(bb)
    got = (ah.astype(np.float64) * bh + ah.astype(np.float64) * bl
           + al.astype(np.float64) * bh)
    want = a.astype(np.float64) * bb
    assert (np.abs(got - want) <= 3 * 2.0 ** -16 * np.abs(want)).all()


@pytest.mark.parametrize("C,T,k,bt", [(32, 256, 11, 128), (16, 250, 7, 64),
                                      (48, 100, 3, 32), (64, 300, 11, 224),
                                      (16, 1100, 11, 1024)])
def test_model_matches_jax_reference_f32(C, T, k, bt):
    """float32 through the model's tiles (two or more tiles, both sequence
    edges, a ragged last tile, three rounds a conv at C=16, bt=1024)
    against ctts_tpu's reference_resblock1, within TOL_F32 of its largest
    entry."""
    x, (c1, c2) = _case(C, T, k, C + T + k)
    geo = fr.geometry(C, torch.float32, k, (1, 3, 5), bt)
    assert geo["smem"] <= fr.SMEM_LIMIT
    assert max(geo["rounds"]) == (3 if bt == 1024 else 1)
    got = kernel_model(x, fr.pack_weights(c1, c2, torch.float32), k,
                       (1, 3, 5), bt, torch.float32)
    jargs = [jnp.asarray(a) for a in (x.transpose(0, 2, 1), c1[0].numpy(),
                                      c1[1].numpy(), c2[0].numpy(),
                                      c2[1].numpy())]
    want = np.asarray(jfr.reference_resblock1(*jargs, k)).transpose(0, 2, 1)
    err = np.abs(got - want).max()
    assert err <= TOL_F32 * np.abs(want).max(), err


@pytest.mark.parametrize("C,T,k,bt", [(32, 256, 11, 128), (64, 250, 3, 96),
                                      (16, 260, 7, 32), (32, 1100, 11, 1024)])
def test_model_matches_plain_bf16(C, T, k, bt):
    """bf16 through the model's tiles (the leaky ReLU into Y, the
    epilogue's roundings, both convs in place, two rounds a conv at C=32,
    bt=1024) against the port's plain version, which
    tests/test_torch_vocoder_fused.py holds to JAX."""
    x, convs = _case(C, T, k, 7 + C + T)
    convs = [(w.to(torch.bfloat16).float(), b) for w, b in convs]
    x = _bf16(x)
    got = kernel_model(x, fr.pack_weights(*convs, torch.bfloat16), k,
                       (1, 3, 5), bt, torch.bfloat16)
    want = fr.reference_resblock1(torch.from_numpy(x).to(torch.bfloat16),
                                  *convs, k).float().numpy()
    err = np.abs(got - want).max()
    assert err <= TOL_BF16 * np.abs(want).max(), err
