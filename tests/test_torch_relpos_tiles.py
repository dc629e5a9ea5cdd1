"""The tile algebra of the relative-position attention kernels
(ctts_torch/csrc/relpos_attention.cu), modelled tile by tile in numpy and
held to the JAX package on the CPU.

The kernels never form the shifted [T, T] positional score. A warp owns
16 query rows [qw, qw+16) against a tile of 64 keys [kw, kw+64) and takes
its positional scores from two band products: (Q+v)[qw+i] against the 80
pos rows from T-1-qw-15+kw (left of the diagonal) and (Q+v)[qw+1+i] against
the 80 from kw-qw-17 (right of it, the legacy wrap), entry (i, j) reading
band column j+15-i. The backward's first launch stores dS tile by tile,
and its second takes the shift's gradients as two products over dS read
by diagonal: for 64 query rows and 64 pos rows [p0, p0+64), row q's
entries from key q+p0-(T-1) (left of the diagonal, pos row p = k-q+T-1)
or from key q+p0+2 (right, p = k-q-2). The model here repeats that
geometry, with the kernels' masks and the tiles they skip, and reads the
kernels' tile sizes, band starts and bounds from the CUDA source to hold
its own copy to them, so a change there fails here until the model, and
its algebra, follow; the card tests (tests/test_torch_gpu.py) hold the
kernels themselves.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ctts_tpu.ops import relpos_attention as jref

CU = (pathlib.Path(__file__).resolve().parents[1] / "ctts_torch" / "csrc"
      / "relpos_attention.cu")
TOL = 1e-5           # of the largest entry; float32 sums in another order

# The geometry the model shares with the kernels, all of it here;
# test_model_mirrors_the_kernel_source holds each piece against CU.
BQ = BK = 64         # queries of a block (kBq), keys of a tile (kBk)
ROWS = 16            # query rows of a warp (kRows)
BAND = BK + ROWS     # band columns a warp computes, 79 used (kBandW)


def left_start(T, qw, kw):
    """The first pos row of the left band of warp rows qw, keys kw."""
    return T - 1 - qw - (ROWS - 1) + kw


def right_start(qw, kw):
    """The first pos row of the right band (rows Q[qw+1+i])."""
    return kw - qw - (ROWS + 1)


def diag_key(T, q, p0, right):
    """The key of row q that the second launch pairs with pos row p0."""
    return q + p0 + (2 if right else 1 - T)


def _sides_on(T, q0, p0):
    """The tiles a block of the second launch visits: whether any key of
    the left and of the right side lies in [0, T)."""
    return p0 + BK - 1 >= T - 1 - (q0 + BQ - 1), p0 <= T - 3 - q0


def _rows(x, r0, n):
    """Rows [r0, r0+n) of x, zero outside [0, len(x))."""
    out = np.zeros((n,) + x.shape[1:], x.dtype)
    lo, hi = max(r0, 0), min(r0 + n, len(x))
    if lo < hi:
        out[lo - r0:hi - r0] = x[lo:hi]
    return out


def _warp_tiles(T):
    """(qw, kw) of every warp tile of the forward and the query role."""
    for q0 in range(0, T, BQ):
        for k0 in range(0, T, BK):
            for w in range(BQ // ROWS):
                qw = q0 + ROWS * w
                if qw < T:
                    yield qw, k0


def _bands(qv, pos, qw, kw):
    """The warp's left and right band products, [16, 80] each."""
    left = _rows(qv, qw, ROWS) @ _rows(pos, left_start(pos.shape[0], qw, kw),
                                      BAND).T
    right = _rows(qv, qw + 1, ROWS) @ _rows(pos, right_start(qw, kw), BAND).T
    return left, right


def _sides(T, qw, kw):
    """Per entry (i, j) of a tile: left (k <= q) and right (k >= q+2), and
    whether the query and the key are in range."""
    i = np.arange(ROWS)[:, None]
    j = np.arange(BK)[None, :]
    q, k = qw + i, kw + j
    live = (q < T) & (k >= 0) & (k < T)
    return (k <= q) & live, (k >= q + 2) & live, live


def shift_by_tiles(qv, pos):
    """rel[q, k] of one (batch, head), assembled from the warps' bands."""
    T = qv.shape[0]
    rel = np.zeros((T, T), np.float32)
    i = np.arange(ROWS)[:, None]
    col = np.arange(BK)[None, :] + (ROWS - 1) - i          # band column j+15-i
    for qw, kw in _warp_tiles(T):
        left, right = _bands(qv, pos, qw, kw)
        is_l, is_r, live = _sides(T, qw, kw)
        tile = np.where(is_l, np.take_along_axis(left, col, 1),
                        np.where(is_r, np.take_along_axis(right, col, 1), 0.0))
        rows, keys = slice(qw, min(qw + ROWS, T)), slice(kw, min(kw + BK, T))
        rel[rows, keys] = tile[:rows.stop - rows.start, :keys.stop - keys.start]
    return rel


def store_by_tiles(ds):
    """dS as the first launch stores it, warp tile by warp tile: [T,
    ceil8(T)], the keys past T 0 (as dS there) and NaN where no tile
    writes."""
    T = ds.shape[0]
    out = np.full((T, (T + 7) // 8 * 8), np.nan, np.float32)
    for qw, kw in _warp_tiles(T):
        rows, keys = slice(qw, min(qw + ROWS, T)), slice(kw, min(kw + BK, out.shape[1]))
        out[rows, keys] = _rows(_rows(ds.T, kw, BK).T, qw, ROWS)[
            :rows.stop - rows.start, :keys.stop - keys.start]
    return out


def _side_tile(store, q0, p0, right):
    """Rows [q0, q0+64) x pos rows [p0, p0+64) of L (or R) as the second
    launch loads them: row q's entry c is dS[q, kb+c] with kb = q+p0-(T-1)
    (or q+p0+2), zero where the key is outside [0, T), the pos row past T
    or the row past T."""
    T = store.shape[0]
    q = q0 + np.arange(BQ)[:, None]
    c = np.arange(BK)[None, :]
    k = diag_key(T, q, p0, right) + c
    ok = (q < T) & (k >= 0) & (k < T) & (p0 + c < T)
    tile = store[np.minimum(q, T - 1), np.clip(k, 0, T - 1)]
    assert not np.isnan(tile[ok]).any(), "a read of an entry no tile wrote"
    return np.where(ok, tile, 0.0)



def shift_grads(store, qv, pos):
    """dq through Q+v (dqv), through Q[q+1]+v (dqv_next: what row q sends
    to row q+1) and dpos, as the second launch's query-row and pos-row
    roles compute them: L.pos, R.pos and L^T.(Q+v) + R^T.(Q[q+1]+v)."""
    T, D = qv.shape
    dqv, dqvn, dpos = (np.zeros((T, D), np.float32) for _ in range(3))
    for q0 in range(0, T, BQ):
        for p0 in range(0, T, BK):
            on = _sides_on(T, q0, p0)
            for right, acc in ((False, dqv), (True, dqvn)):
                if on[right]:
                    tile = _side_tile(store, q0, p0, right)
                    got = tile @ _rows(pos, p0, BK)
                    n = min(BQ, T - q0)
                    acc[q0:q0 + n] += got[:n]
                    got = tile.T @ _rows(qv, q0 + right, BQ)
                    n = min(BK, T - p0)
                    dpos[p0:p0 + n] += got[:n]
    return dqv, dqvn, dpos


def _case(T, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, D).astype(np.float32),
            rng.randn(T, D).astype(np.float32),
            rng.randn(T, T).astype(np.float32))


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("T", [37, 87, 200])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_band_product_and_skew_equal_the_shift(D, T):
    """The bands of every warp tile, skewed, give the JAX package's
    pad-reshape-slice shift of (Q+v).Pos^T: the left band, the right band
    through Q[q+1] and the injected zero at k = q+1, over whole and
    partial tiles."""
    qv, pos, _ = _case(T, D, T + D)
    want = jref.relative_shift(jnp.asarray(qv @ pos.T)[None, None])[0, 0]
    got = shift_by_tiles(qv, pos)
    _close(got, want)
    assert not got[np.arange(T - 1), np.arange(1, T)].any()


@pytest.mark.parametrize("T", [37, 87, 200])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_diagonal_reads_give_the_shift_vjp(D, T):
    """dS stored tile by tile, then the two products over it read by
    diagonal: dqv and dqv_next, which the wrapper adds as dq[q] = dqv[q] +
    dqv_next[q-1], and dpos. They equal jax.vjp of the shift of
    (Q+v).Pos^T, and no product reads an entry no tile wrote."""
    qv, pos, ds = _case(T, D, 2 * T + D)

    @jax.jit
    def shift_vjp(a, b, cot):
        _, vjp = jax.vjp(
            lambda a, b: jref.relative_shift((a @ b.T)[None, None])[0, 0], a, b)
        return vjp(cot)

    want_qv, want_pos = shift_vjp(jnp.asarray(qv), jnp.asarray(pos),
                                  jnp.asarray(ds))
    dqv, dqvn, dpos = shift_grads(store_by_tiles(ds), qv, pos)
    dqv[1:] += dqvn[:-1]
    _close(dqv, want_qv)
    _close(dpos, want_pos)


def _attention_by_tiles(q, k, v, pos, ub, vb, scale, cot):
    """One (batch, head) of the attention and its gradients with the
    positional algebra taken tile by tile: the forward's shift from the
    bands, the backward's dq and dpos from dS read by diagonal."""
    qu, qv = q + ub, q + vb
    s = (qu @ k.T + shift_by_tiles(qv, pos)) * scale
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    out = p @ v
    dp = cot @ v.T
    ds = p * (dp - (cot * out).sum(1, keepdims=True)) * scale
    dqv, dqvn, dpos = shift_grads(store_by_tiles(ds), qv, pos)
    dqv[1:] += dqvn[:-1]
    dqu = ds @ k
    return out, (dqu + dqv, ds.T @ qu, p.T @ cot, dpos, dqu.sum(0),
                 dqv.sum(0))


@pytest.mark.parametrize("T", [37, 87, 200])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_tile_model_matches_reference_vjp(D, T):
    """The whole attention with the tile model's shift and gradients against
    jax.vjp of relpos_attention_reference (one batch, one head, no mask or
    dropout): the output and the gradients of q, k, v, pos, u and v."""
    rng = np.random.RandomState(3 * T + D)
    q, k, v, pos, cot = (rng.randn(T, D).astype(np.float32) for _ in range(5))
    ub, vb = (0.5 * rng.randn(D).astype(np.float32) for _ in range(2))
    scale = 1.0 / 16.0

    def ref(q, k, v, pos, ub, vb):
        return jref.relpos_attention_reference(
            q[None, :, None], k[None, :, None], v[None, :, None],
            pos[None, :, None], ub[None], vb[None], scale)[0, :, 0]

    @jax.jit                          # one compile, not one per operation
    def ref_vjp(args, cot):
        out, vjp = jax.vjp(ref, *args)
        return out, vjp(cot)

    want, want_grads = ref_vjp(tuple(map(jnp.asarray, (q, k, v, pos, ub, vb))),
                               jnp.asarray(cot))
    got, grads = _attention_by_tiles(q, k, v, pos, ub, vb, scale, cot)
    _close(got, want)
    for g, w in zip(grads, want_grads):
        _close(g, w)


def _c_expr(src, pattern):
    """Each C expression that ``pattern``'s group catches in the kernel
    source, as Python: integer division, ``(c ? a : b)`` as a conditional."""
    found = re.findall(pattern, src, re.M)
    assert found, pattern
    return [compile(re.sub(r"\((\w+) \? ([^:()]+) : ([^()]+)\)",
                           r"(\2 if \1 else \3)", e.replace("/", "//")),
                    pattern, "eval") for e in found]


def test_model_mirrors_the_kernel_source():
    """The model's tile sizes, band starts, diagonal keys and visited tiles
    are the ones relpos_attention.cu computes: its constexpr constants,
    band_left/band_right plus a warp's offset in the block's band, the
    second launch's kb and its on[] tests, evaluated over a grid."""
    src = CU.read_text()
    const = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        const[name] = eval(expr.replace("/", "//"), {}, dict(const))
    assert (const["kBq"], const["kBk"], const["kRows"], const["kBandW"]) == (
        BQ, BK, ROWS, BAND)
    [band_l] = _c_expr(
        src, r"int band_left\(int T, int q0, int k0\) \{ return ([^;]+);")
    [band_r] = _c_expr(
        src, r"int band_right\(int q0, int k0\) \{ return ([^;]+);")
    [warp_off] = _c_expr(src, r"w\.pl_r = w\.pr_r = ([^;]+);")
    kbs = _c_expr(src, r"const int kb = ([^,;]+)[,;]")
    ons = _c_expr(src, r"const bool on\[2\] = \{([^,]+), [^}]+\};") + _c_expr(
        src, r"const bool on\[2\] = \{[^,]+, ([^}]+)\};")
    assert len(ons) == 4, ons          # the dq role and the dpos role
    for T in range(1, 200):            # every boundary of a tile of 64
        for q0 in range(0, T, BQ):
            for k0 in range(0, T, BK):
                for warp in range(BQ // ROWS):
                    env = dict(const, T=T, q0=q0, k0=k0, warp=warp)
                    qw = q0 + ROWS * warp
                    off = eval(warp_off, {}, env)
                    assert eval(band_l, {}, env) + off == left_start(T, qw, k0)
                    assert eval(band_r, {}, env) + off == right_start(qw, k0)
            for p0 in range(0, T, BK):
                env = dict(const, T=T, q0=q0, p0=p0)
                left, right = _sides_on(T, q0, p0)
                assert [eval(e, {}, env) for e in ons] == [left] * 2 + [right] * 2
                for q in range(q0, min(q0 + BQ, T)):
                    for right in (False, True):
                        env.update(q=q, right=right)
                        assert {eval(e, {}, env) for e in kbs} == {
                            diag_key(T, q, p0, right)}
