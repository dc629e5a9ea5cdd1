"""The tile schedule of the fused attention kernel
(ctts_torch/csrc/attention.cu), modelled in numpy and held to the JAX
package on the CPU.

A block takes 64 query rows of one n (16 a warp) and streams the keys in
tiles of 64. Keys at or past kv_end = lengths[n] > 0 ? min(lengths[n], T)
: T add exactly 0 after the reference's -1e9 fill, so the tiles past
kv_end are skipped and the keys past kv_end in the last tile are -inf; a
zero-length row walks all T keys with every logit at -1e9 (uniform over
V). The softmax runs online in float32: the running max, the rescale
exp(m_old - m_new) of the sum and of the accumulator, and exp(s - m) of
each logit. The scale multiplies the float32 logit. bf16 rounds P to bf16
for P·V; float32 splits every operand into bf16 hi + lo and sums three
products (hi·hi + hi·lo + lo·hi). At d = 256 two warps share each 16 query
rows and keep 128 output columns each. The model repeats that schedule and
those rounding points; it reads the constants it models from the CUDA
source, so a change there fails here until the model follows. The card
tests (tests/test_torch_gpu.py) hold the kernel itself.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.ops import attention as j_attn
from ctts_torch.ops import attention as t_attn

CSRC = pathlib.Path(__file__).resolve().parents[1] / "ctts_torch" / "csrc"

# the schedule the model shares with the kernel, all of it here;
# test_model_mirrors_the_kernel_source holds each piece against CSRC
BQ = 64              # query rows of a block (kBq)
BK = 64              # keys of a tile (kBk)
ROWS = 16            # query rows of a warp (kRows)
COLS_MAX = 128       # output columns of a warp (kColsMax)
PAD_E = 8            # bf16 elements of padding on a shared row (kPadE)
NEG = -1e9           # kNeg
SMEM_MAX = 227 * 1024    # the H100's dynamic shared memory a block may opt in
# of the largest |reference| entry: float32 on both sides (the split loses
# lo·lo, ~2^-16 of a product, and the sums run in another order); bf16
# against the float32 reference (the card's ATTN_TOL) and against JAX's own
# bf16 reference (which also rounds q·scale and the probabilities)
TOL_F32 = 2e-5
TOL_BF16 = 2e-2
# bf16 against the float32 reference, row by row: max|error| of a query row
# over that row's largest |reference| (the card's ATTN_ROW_TOL_BF16)
TOL_BF16_ROW = 1e-2


def rnd(a):
    """float32 values rounded to bf16 (as float32)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def ftz(x):
    """float32 exp results as __expf gives them: subnormals flushed to 0
    (ex2.approx.ftz)."""
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0), x)


def split(a):
    """(hi, lo): a = hi + lo + O(2^-16 a), both bf16 values."""
    hi = rnd(a)
    return hi, rnd(a - hi)


def product(a, b, f32):
    """a @ b as the tensor cores sum it: bf16 operands, float32 sums;
    float32 operands as lo·hi + hi·lo + hi·hi."""
    if not f32:
        return rnd(a) @ rnd(b)
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def cfg(d, f32):
    """(warps sharing 16 rows, threads, K/V buffers, shared bytes) of the
    kernel instance (Cfg<T, D>)."""
    cols = min(d, COLS_MAX)
    share = d // cols
    bufs = 1 if f32 else 2
    tile = (2 if f32 else 1) * BK * (d + PAD_E) * 2
    return share, 4 * share * 32, bufs, (1 + 2 * bufs) * tile


def model(q, k, v, lengths, scale, f32, visits=None):
    """[N, T, d] float32 arrays (bf16 values where not f32) → the
    kernel's output [N, T, d] in float32 (bf16 values where not f32).
    ``visits`` collects (n, query block, key tile) as they are walked."""
    N, T, d = q.shape
    out = np.zeros((N, T, d), np.float32)
    share = cfg(d, f32)[0]
    cols = d // share
    for n in range(N):
        ln = int(lengths[n])
        kv_end = min(ln, T) if ln > 0 else T
        n_tiles = -(-kv_end // BK)
        for q0 in range(0, T, BQ):
            rows = min(BQ, T - q0)
            Q = np.zeros((BQ, d), np.float32)       # rows past T are zeros
            Q[:rows] = q[n, q0:q0 + rows]
            m = np.full(BQ, -np.inf, np.float32)
            l = np.zeros(BQ, np.float32)
            acc = np.zeros((BQ, d), np.float32)
            for i in range(n_tiles):
                j0 = i * BK
                if visits is not None:
                    visits.append((n, q0 // BQ, i))
                K = np.zeros((BK, d), np.float32)   # keys past kv_end: zeros
                V = np.zeros((BK, d), np.float32)
                live = min(BK, kv_end - j0)
                K[:live] = k[n, j0:j0 + live]
                V[:live] = v[n, j0:j0 + live]
                s = product(Q, K.T, f32)
                j = j0 + np.arange(BK)
                s = np.where(j[None, :] < kv_end,
                             s * np.float32(scale) if ln > 0
                             else np.float32(NEG), -np.inf).astype(np.float32)
                mx = np.maximum(m, s.max(1))
                alpha = ftz(np.exp(m - mx))
                m = mx
                p = ftz(np.exp(s - m[:, None]))
                l = l * alpha + p.sum(1, dtype=np.float32)
                # each warp group keeps its own columns; the same P
                for c0 in range(0, d, cols):
                    acc[:, c0:c0 + cols] = (
                        acc[:, c0:c0 + cols] * alpha[:, None]
                        + product(p, V[:, c0:c0 + cols], f32))
            o = acc / l[:, None]
            out[n, q0:q0 + rows] = (o if f32 else rnd(o))[:rows]
    return out


def case(rng, N, T, d, lengths, bf16):
    q, k, v = (rng.randn(N, T, d).astype(np.float32) for _ in range(3))
    if bf16:
        q, k, v = rnd(q), rnd(k), rnd(v)
    return q, k, v, np.asarray(lengths, np.int32)


def reference(q, k, v, lens, scale, dtype=jnp.float32):
    return np.asarray(j_attn._reference_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(lens), scale).astype(jnp.float32))


def lengths_for(T):
    """zero- and one-length rows, a full row, a row ending inside a tile,
    one on a tile edge, and one past T"""
    return [0, 1, T, T - 3, min(64, T), T + 5]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("T", [96, 200])
def test_f32_model_matches_the_jax_reference(T, d):
    rng = np.random.RandomState(T + d)
    q, k, v, lens = case(rng, 6, T, d, lengths_for(T), False)
    scale = d ** -0.5
    want = reference(q, k, v, lens, scale)
    got = model(q, k, v, lens, scale, True)
    assert np.abs(got - want).max() <= TOL_F32 * np.abs(want).max()


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("T", [96, 200])
def test_bf16_model_within_the_card_tolerance(T, d):
    """bf16 q, k, v: against the float32 reference on the same values (the
    card's comparison) and against JAX's bf16 reference."""
    rng = np.random.RandomState(3 * T + d)
    q, k, v, lens = case(rng, 6, T, d, lengths_for(T), True)
    scale = d ** -0.5
    got = model(q, k, v, lens, scale, False)
    assert np.abs(got - reference(q, k, v, lens, scale)).max() <= TOL_BF16
    assert np.abs(got - reference(q, k, v, lens, scale,
                                  jnp.bfloat16)).max() <= TOL_BF16


def row_err(got, want):
    """max over query rows of max|got - want| / max|want| of the row"""
    return (np.abs(got - want).max(-1) / np.abs(want).max(-1)).max()


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("T", [96, 200])
def test_bf16_model_within_the_row_tolerance(T, d):
    """bf16 rounds P and the output (2^-9 each): every row within
    TOL_BF16_ROW of its own largest entry, short rows and long ones."""
    rng = np.random.RandomState(5 * T + d)
    q, k, v, lens = case(rng, 6, T, d, lengths_for(T), True)
    scale = d ** -0.5
    got = model(q, k, v, lens, scale, False)
    assert row_err(got, reference(q, k, v, lens, scale)) <= TOL_BF16_ROW


@pytest.mark.parametrize("tile", [1, 2])
@pytest.mark.parametrize("which", ["k", "v"])
def test_row_tolerance_catches_a_stale_tile(which, tile):
    """A K or V tile of the double buffer read stale (the tile before it
    again): the row tolerance fails it on the rows that reach the tile."""
    T, d = 200, 128
    rng = np.random.RandomState(17 + tile)
    q, k, v, lens = case(rng, 4, T, d, [T, T - 3, 150, 0], True)
    bad = {"k": k.copy(), "v": v.copy()}
    at = slice(tile * BK, (tile + 1) * BK)
    bad[which][:, at] = bad[which][:, (tile - 1) * BK:tile * BK]
    scale = d ** -0.5
    got = model(q, bad["k"], bad["v"], lens, scale, False)
    want = reference(q, k, v, lens, scale)
    assert row_err(got, want) > 10 * TOL_BF16_ROW


@pytest.mark.parametrize("T,d", [(128, 64), (256, 128)])
def test_model_matches_the_pallas_kernel_in_interpret_mode(T, d,
                                                           monkeypatch):
    """The Pallas route takes T a multiple of 128 only; float32."""
    monkeypatch.setattr(j_attn, "_INTERPRET", True)
    rng = np.random.RandomState(T * d)
    q, k, v, lens = case(rng, 3, T, d, [T - 37, 0, 1], False)
    want = np.asarray(j_attn.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = model(q, k, v, lens, d ** -0.5, True)
    assert np.abs(got - want).max() <= TOL_F32 * np.abs(want).max()


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("T", [96, 200])
def test_zero_and_one_length_rows(T, f32):
    """A zero-length row averages V over all T keys (its running max is
    -1e9 from the first tile on, so every key weighs exp(0) = 1); a
    one-length row copies key 0's value into every query row."""
    rng = np.random.RandomState(T)
    q, k, v, lens = case(rng, 2, T, 64, [0, 1], not f32)
    got = model(q, k, v, lens, 0.125, f32)
    mean = v[0].mean(0)
    # float32: the split of V drops ~2^-17 of it; bf16: the output rounding
    tol = TOL_F32 * np.abs(v).max() if f32 else TOL_BF16
    assert np.abs(got[0] - mean[None]).max() <= tol
    assert np.abs(got[1] - v[1, 0][None]).max() <= tol


@pytest.mark.parametrize("T", [96, 200, 1152])
def test_tiles_walked_stop_at_kv_end(T):
    """Every (n, query block) walks ceil(kv_end / 64) key tiles, no more:
    all T keys for a zero-length row, one tile for a one-length row; query
    blocks cover T with the last one ragged."""
    lens = lengths_for(T)
    visits = []
    rng = np.random.RandomState(1)
    q, k, v, lens = case(rng, len(lens), T, 64, lens, False)
    model(q, k, v, lens, 0.125, True, visits)
    n_blocks = -(-T // BQ)
    for n, ln in enumerate(lens):
        kv_end = min(ln, T) if ln > 0 else T
        tiles = [(b, i) for m, b, i in visits if m == n]
        assert tiles == [(b, i) for b in range(n_blocks)
                         for i in range(-(-kv_end // BK))]


def test_skipped_tiles_would_add_nothing():
    """Walking every tile with the -1e9 fill (the Pallas kernel's own
    schedule, which holds K and V whole) gives the same output as skipping
    them: past kv_end exp(-1e9 - m) is 0 in float32."""
    rng = np.random.RandomState(2)
    T, d = 200, 64
    q, k, v, lens = case(rng, 3, T, d, [5, 70, 130], False)
    got = model(q, k, v, lens, 0.125, True)
    logits = np.einsum("nqd,nkd->nqk", q * np.float32(0.125), k)
    logits = np.where(np.arange(T)[None, None] < lens[:, None, None],
                      logits, np.float32(NEG))
    assert np.exp(np.float32(NEG) - logits.max(-1)).max() == 0.0
    want = reference(q, k, v, lens, 0.125)
    assert np.abs(got - want).max() <= TOL_F32 * np.abs(want).max()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_warps_cover_every_row_and_column_once(d):
    """Four warp rows of 16 make a block's 64 query rows; at d = 256 two
    warps share 16 rows, one for each 128 output columns."""
    share, threads, _, _ = cfg(d, False)
    cols = d // share
    cover = np.zeros((BQ, d), int)
    for warp in range(threads // 32):
        r0, c0 = (warp % 4) * ROWS, (warp // 4) * cols
        cover[r0:r0 + ROWS, c0:c0 + cols] += 1
    assert (cover == 1).all()
    # the warp's output accumulators: 16 rows x cols / 32 lanes
    assert ROWS * cols // 32 <= 64


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_shared_memory_fits_the_card(d, f32):
    """Q, then K and V (twice in bf16, double-buffered; once, split, in
    float32): within the 227 KB a block may opt in to; past 48 KB the
    launch opts in."""
    smem = cfg(d, f32)[3]
    assert smem <= SMEM_MAX
    assert smem > 48 * 1024 or d == 64


@pytest.mark.parametrize("d", [64, 128, 256])
def test_rows_of_an_ldmatrix_fall_in_distinct_banks(d):
    """Shared rows are d + kPadE bf16 elements apart: the 8 rows of any
    ldmatrix 8x8 piece cover all 32 banks once."""
    stride = (d + PAD_E) * 2
    assert stride % 16 == 0
    for r0 in range(8):
        for c0 in range(0, d, 8):
            banks = [((r0 + i) * stride + c0 * 2) // 4 % 32 + w
                     for i in range(8) for w in range(4)]
            assert sorted(b % 32 for b in banks) == list(range(32))


def test_plain_version_is_the_model_at_full_precision():
    """The wrapper's plain version (the CPU route) and the model agree on
    the function they compute."""
    rng = np.random.RandomState(5)
    q, k, v, lens = case(rng, 4, 96, 128, [0, 1, 96, 50], False)
    got = t_attn.attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(lens), 128 ** -0.5).numpy()
    want = model(q, k, v, lens, 128 ** -0.5, True)
    assert np.abs(got - want).max() <= TOL_F32 * np.abs(want).max()


def test_model_mirrors_the_kernel_source():
    src = (CSRC / "attention.cu").read_text()
    cuh = (CSRC / "window_attention.cuh").read_text()

    def const(text, name):
        m = re.search(rf"constexpr (?:int|float) {name} = ([-0-9.e]+)f?;",
                      text)
        assert m, name
        return float(m.group(1))

    assert (const(src, "kBq"), const(src, "kBk"), const(src, "kColsMax"),
            const(src, "kNeg")) == (BQ, BK, COLS_MAX, NEG)
    assert (const(cuh, "kRows"), const(cuh, "kTile"),
            const(cuh, "kPadE")) == (ROWS, BK, PAD_E)
    for line in (
            "const int kv_end = len > 0 ? min(len, seq) : seq;",
            "const int n_tiles = (kv_end + kBk - 1) / kBk;",
            "const float x = j < kv_end ? (len > 0 ? s[nt][e] * scale : kNeg)"
            " : -INFINITY;",
            "alpha[r] = __expf(m[r] - mx[r]);",
            "const float p = __expf(s[nt][e] - m[e >> 1]);",
            "l[r] = l[r] * alpha[r] + cw::quad_sum(sum[r]);",
            "const float inv = 1.f / l[r];",
            # Cfg: the warps sharing rows, the buffers and shared memory
            "static constexpr int kCols = D < kColsMax ? D : kColsMax;",
            "static constexpr int kShare = D / kCols;",
            "static constexpr int kThreads = 4 * kShare * 32;",
            "static constexpr int kBufs = kF32 ? 1 : 2;",
            "static constexpr int kTb = cw::tile_bytes<D>(kF32);",
            "static constexpr int kSmem = (1 + 2 * kBufs) * kTb;",
            "const int r0 = (warp % 4) * cw::kRows;",
            "const int c0 = (warp / 4) * C::kCols;",
            # P is rounded (bf16) or split (float32) with the operands
            "constexpr bool kS = C::kF32;",
            "cw::frag_of<kS>(fp, s, ks);",
            "cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem"):
        assert line in src, line
    assert "return (split ? 2 : 1) * kTile * (D + kPadE) * 2;" in cuh
    # the split's three products: lo.hi, hi.lo, then hi.hi
    body = cuh[cuh.index("__device__ __forceinline__ void mma(float"):]
    body = body[:body.index("}")]
    assert body.index("a.l, b.h") < body.index("a.h, b.l") \
        < body.index("a.h, b.h")
    # no CUDA-core dot loop is left: every product is an mma
    assert "cw::mma(s[2 * np]" in src and "cw::mma(acc[2 * np]" in src
    assert "fmaf" not in src
