"""The tile geometry of the window-attention engine
(ctts_torch/csrc/window_attention.cuh: the local-window and LSH-chunk
kernels), modelled tile by tile in numpy and held to the JAX package on the
CPU.

The rows of a row space fall into units of Q rows (a window, or a chunk of
the hash-sorted rows); the queries of unit u see 2Q key slots, the unit's
own rows and then those of the unit before it (the local window's unit 0
looks back at synthetic zero rows, the LSH chunk 0 at the last chunk,
across the hash rounds, so a position may sit in two slots). A block takes
BS = 64 stationary rows of a unit (32 where Q is an odd multiple of 32),
16 a warp. The forward streams the 2Q slots in tiles of 64 with an online
softmax. The backward runs two phases over the same rows: a query phase
(dq over the 2Q key slots, in tiles of 64) and a key phase (dk and dv over
the 2Q queries that see the rows as keys, unit u's and then unit u+1's, in
tiles of 64 taken 32 at a time); each row's result is dq + dk, the query
phase's part first, then the key phase's, with dk = r·dkn − k·r³·⟨k, dkn⟩.
Keys stay raw: q·kn = (q·k)·r with r = rsqrt(|k|² + 1e-12) per key row, so
r scales the logit (and dS for dq) and a bf16 k enters the products
exactly. Masked and pinned logits are constants: their dS is 0. In bf16
the kernels round P, dS·scale(·r) and dO for their products (the LSH
forward keeps P in float32 precision by splitting it). The model repeats that
geometry and those rounding points; it reads the engine's tile sizes, mask
constants, block rule and split flags from the CUDA source, so a change
there fails here until the model follows. The card tests
(tests/test_torch_gpu.py) hold the kernels themselves.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.models import reformer as jr
from ctts_torch.ops import local_window_attention as lw
from ctts_torch.ops import lsh_chunk_attention as lc

CUH = (pathlib.Path(__file__).resolve().parents[1] / "ctts_torch" / "csrc"
       / "window_attention.cuh")

# The geometry the model shares with the engine, all of it here;
# test_model_mirrors_the_kernel_source holds each piece against CUH.
ROWS = 16            # stationary rows of a warp (kRows)
TILE = 64            # slots, or partner queries, of a tile (kTile)
HALF = 32            # partner queries of a key-phase step (kHalf)
PAD_E = 8            # bf16 elements of padding on a shared row (kPadE)
MAX_THREADS = 128    # threads of a 64-row block (kMaxThreads)
NEG, SELF, EPS = -1e9, -5e4, 1e-12     # kNeg, kSelf, kEps
# the forward's split of P (FwdSplit::kP), for (f32, bf16 local, bf16 LSH):
# in bf16 the LSH forward keeps P in float32 precision; every other operand
# is split in float32 only, as is every operand of the backward
SPLIT_P = (True, False, True)
TOL_F32 = 2e-5       # of the largest entry: float32 sums in another order
TOL_BF16 = 1e-2      # the card's WINDOW_TOL in bf16


@pytest.fixture(autouse=True)
def _jnp_paths(monkeypatch):
    """The JAX package's jnp oracles: no interpret mode left over from
    another module (it would route them through the Pallas kernels), the
    fused LSH off."""
    from ctts_tpu.ops import local_window_attention, lsh_chunk_attention, \
        sort_gather
    for m in (sort_gather, local_window_attention, lsh_chunk_attention):
        monkeypatch.setattr(m, "_INTERPRET", False)
    monkeypatch.delenv("CTTS_FUSED_LSH", raising=False)


def block_rows(unit):
    return 64 if unit % 64 == 0 else 32


def rnd(a):
    """float32 values rounded to bf16 (as float32)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def rsqrt_norm(k):
    """r = rsqrt(|k|² + eps) of each row as the convert step computes it:
    |k|² summed by D/8 lanes of 8 elements in order, then by a butterfly
    over the lanes."""
    R, D = k.shape
    lanes = D // 8
    x = k.reshape(R, lanes, 8).astype(np.float32)
    ss = np.zeros((R, lanes), np.float32)
    for e in range(8):
        ss = ss + x[:, :, e] * x[:, :, e]
    o = lanes // 2
    while o:
        ss = ss + ss[:, np.arange(lanes) ^ o]
        o //= 2
    return (1.0 / np.sqrt(ss[:, 0] + np.float32(EPS))).astype(np.float32)


def key_row(u, n, Q, j, lsh):
    """Row of key slot j of unit u: its own rows, then the look-back's."""
    if j < Q:
        return u * Q + j
    if lsh:
        return ((u + n - 1) % n) * Q + j - Q
    return -1 if u == 0 else (u - 1) * Q + j - Q


def query_row(u, n, Q, j, lsh):
    """Row of partner query slot j of unit u: the queries that see the
    unit's rows as keys, its own, then those of the unit after it."""
    if j < Q:
        return u * Q + j
    if lsh:
        return ((u + 1) % n) * Q + j - Q
    return (u + 1) * Q + j - Q if u + 1 < n else -1


class Engine:
    """One g of the engine: qk, v [n_src, D], pos [R] (each row's source
    position; the row itself for the local window), ok [R], unit Q."""

    def __init__(self, qk, v, pos, ok, Q, causal, lsh, scale, bf16=False,
                 track=False):
        self.qk, self.v = np.asarray(qk, np.float32), np.asarray(v, np.float32)
        self.pos, self.ok = np.asarray(pos), np.asarray(ok, bool)
        self.Q, self.causal, self.lsh = Q, causal, lsh
        self.scale, self.bf16 = np.float32(scale), bf16
        self.R, self.n = len(pos), len(pos) // Q
        self.bs = block_rows(Q)
        self.r = rsqrt_norm(self.qk[self.pos])
        self.track, self.visits = track, []   # (phase, query row, slot)

    def blocks(self):
        for u in range(self.n):
            for b in range(self.Q // self.bs):
                yield u, u * self.Q + b * self.bs + np.arange(self.bs)

    def rows_of(self, slots, u, partner):
        f = query_row if partner else key_row
        return np.array([f(u, self.n, self.Q, j, self.lsh) for j in slots])

    def take(self, a, rows):
        """Rows of a row-space array; zero where rows < 0 (no row)."""
        out = np.zeros((len(rows),) + a.shape[1:], a.dtype)
        out[rows >= 0] = a[rows[rows >= 0]]
        return out

    def logits(self, qrows, krows):
        """(q · k)·r of query rows against key rows (0 where no row)."""
        qk = self.qk[self.pos]
        return ((self.take(qk, qrows) @ self.take(qk, krows).T)
                * self.take(self.r, krows)[None]).astype(np.float32)

    def masked(self, s, qrows, krows):
        """Masked logits [q, k] in the engine's two orders, and whether each
        is still (q · kn)·scale (live)."""
        qt = self.pos[qrows][:, None]
        kt = np.where(krows >= 0, self.pos[np.maximum(krows, 0)], -1)[None]
        ok = self.ok[qrows][:, None] & np.where(
            krows >= 0, self.ok[np.maximum(krows, 0)], False)[None]
        x = s * self.scale
        causal = self.causal & (qt < kt)
        if self.lsh:
            x = np.where(ok, x, NEG)
            x = np.where(causal, NEG, x)
            x = np.where(qt == kt, SELF, x)
        else:
            x = np.where(qt == kt, SELF, x)
            x = np.where(causal, NEG, x)
            x = np.where(ok, x, NEG)
        return x.astype(np.float32), ok & (qt != kt) & ~causal

    def forward(self):
        """Local: o [R, D], row max m and sum l. LSH: out ‖ lse [R, D+1]."""
        D = self.qk.shape[1]
        v = self.v[self.pos]
        split_p = SPLIT_P[2 if self.lsh else 1] if self.bf16 else True
        o = np.zeros((self.R, D + 1), np.float32)
        self.m, self.l = (np.zeros(self.R, np.float32) for _ in range(2))
        for u, rows in self.blocks():
            m = np.full(len(rows), -np.inf, np.float32)
            l = np.zeros(len(rows), np.float32)
            acc = np.zeros((len(rows), D), np.float32)
            for t0 in range(0, 2 * self.Q, TILE):
                slots = np.arange(t0, t0 + TILE)
                krows = self.rows_of(slots, u, False)
                if self.track:
                    self.visits += [("fwd", r, j) for r in rows for j in slots]
                x, _ = self.masked(self.logits(rows, krows), rows, krows)
                mx = np.maximum(m, x.max(1))
                alpha = np.exp(m - mx)
                p = np.exp(x - mx[:, None])
                l = l * alpha + p.sum(1)
                m = mx
                pp = p if split_p else rnd(p)
                acc = acc * alpha[:, None] + pp @ self.take(v, krows)
            self.m[rows], self.l[rows] = m, l
            if self.lsh:
                lse = m + np.log(l)
                o[rows, :D] = acc * np.exp(m - lse)[:, None]
                o[rows, D] = lse
            else:
                o[rows, :D] = acc / l[:, None]
        return o if self.lsh else o[:, :D]

    def p_ds(self, x, live, dp, sm, sl, delta, dlse):
        p = np.exp(x - sm) / sl
        d = p * (dp - delta) + dlse * p
        return p, np.where(live, d, 0.0) * self.scale

    def backward(self, out, dout, dlse=None):
        """dq + dk and dv per row [R, D] (float32), from the forward's
        statistics and the cotangents dO [R, D] (and LSH: dlse [R])."""
        D = self.qk.shape[1]
        R = self.R
        q, v = self.qk[self.pos], self.v[self.pos]
        delta = (dout * out[:, :D]).sum(1).astype(np.float32)
        do = rnd(dout) if self.bf16 else dout.astype(np.float32)
        rb = rnd if self.bf16 else (lambda a: a)
        if self.lsh:
            sm, sl, dls = out[:, D], np.ones(R, np.float32), dlse
        else:
            sm, sl, dls = self.m, self.l, np.zeros(R, np.float32)
        dqk = np.zeros((R, D), np.float32)
        dv = np.zeros((R, D), np.float32)
        for u, rows in self.blocks():
            # query phase: dq of the rows over their 2Q key slots
            dq = np.zeros((len(rows), D), np.float32)
            for t0 in range(0, 2 * self.Q, TILE):
                slots = np.arange(t0, t0 + TILE)
                krows = self.rows_of(slots, u, False)
                if self.track:
                    self.visits += [("q", r, j) for r in rows for j in slots]
                x, live = self.masked(self.logits(rows, krows), rows, krows)
                dp = do[rows] @ self.take(v, krows).T
                _, ds = self.p_ds(x, live, dp, sm[rows][:, None],
                                  sl[rows][:, None], delta[rows][:, None],
                                  dls[rows][:, None])
                dq += rb(ds * self.take(self.r, krows)[None]) @ self.take(
                    q, krows)
            # key phase: dk and dv of the rows over the queries that see them
            dkn = np.zeros((len(rows), D), np.float32)
            dvv = np.zeros((len(rows), D), np.float32)
            for t0 in range(0, 2 * self.Q, TILE):
                for h0 in range(t0, t0 + TILE, HALF):
                    slots = np.arange(h0, h0 + HALF)
                    qrows = self.rows_of(slots, u, True)
                    has = qrows >= 0
                    qr = np.maximum(qrows, 0)
                    if self.track:       # row k as key slot of each query
                        self.visits += [
                            ("k", qr_, k_ - u * self.Q + (j >= self.Q) * self.Q)
                            for k_ in rows for j, qr_ in zip(slots, qrows)
                            if qr_ >= 0]
                    xt, live = self.masked(self.logits(qr, rows), qr, rows)
                    dpt = self.take(do, qrows) @ v[rows].T
                    p, ds = self.p_ds(xt, live, dpt, sm[qr][:, None],
                                      sl[qr][:, None], delta[qr][:, None],
                                      dls[qr][:, None])
                    p, ds = p * has[:, None], ds * has[:, None]
                    dvv += rb(p).T @ self.take(do, qrows)
                    dkn += rb(ds).T @ self.take(q, qrows)
            k = q[rows]
            inner = (k * dkn).sum(1, keepdims=True)
            r = self.r[rows][:, None]
            dqk[rows] = dq + (r * dkn - k * r ** 3 * inner)
            dv[rows] = dvv
        return dqk, dv


def scatter(rows_grad, pos, n_src):
    out = np.zeros((n_src,) + rows_grad.shape[1:], np.float32)
    np.add.at(out, pos, rows_grad)
    return out


# ---- the local window ---------------------------------------------------- #

def local_model(qk, v, valid, window, bf16=False):
    """Forward [B, N, d] and a VJP function, per g through Engine."""
    B, N, d = qk.shape
    engines = [Engine(qk[b], v[b], np.arange(N), valid[b], window, True,
                      False, d ** -0.5, bf16) for b in range(B)]
    outs = [e.forward() for e in engines]

    def vjp(g):
        grads = [e.backward(o, g[b]) for b, (e, o) in
                 enumerate(zip(engines, outs))]
        return np.stack([x for x, _ in grads]), np.stack([y for _, y in grads])

    return np.stack(outs), vjp, engines


def _local_case(B, N, d, window, seed):
    rng = np.random.RandomState(seed)
    qk, v, g = (rng.randn(B, N, d).astype(np.float32) for _ in range(3))
    valid = rng.rand(B, N) > 0.2
    valid[0] = True
    valid[-1, N - window:] = False                     # a wholly padded window
    if B > 2:
        valid[1, N - 5:] = False                       # a ragged tail
    return qk, v, g, valid


def _jax_vjp(f, qk, v, g):
    """f(qk, v) and its VJP at g, compiled once."""
    def both(a, b, c):
        out, back = jax.vjp(f, a, b)
        return (out,) + back(c)

    return [np.asarray(x) for x in jax.jit(both)(jnp.asarray(qk),
                                                jnp.asarray(v),
                                                jnp.asarray(g))]


@pytest.mark.parametrize("N,window", [(256, 128), (192, 96), (128, 32)])
def test_local_model_matches_jax_reference(N, window):
    """The model in float32 against the jnp ``local_attention``
    (ctts_tpu/models/reformer.py:185-226): output and VJP within 2e-5 of
    their largest entries. Window 0's look-back is synthetic; the last row
    has a wholly padded window, the second a ragged tail."""
    qk, v, g, valid = _local_case(3, N, 64, window, N + window)
    got, vjp, _ = local_model(qk, v, valid, window)
    want = _jax_vjp(lambda a, b: jr.local_attention(
        a, b, jnp.asarray(valid), window), qk, v, g)
    for x, y in zip([got, *vjp(g)], want):
        assert np.abs(x - y).max() <= TOL_F32 * np.abs(y).max()


def test_local_padded_row_is_uniform_and_passes_no_score_gradient():
    """The local mask order (validity last): a padded query row averages
    all 2Q slots (window 0: its own values and Q synthetic zeros), and its
    dS is 0 everywhere, so its dq is 0."""
    qk, v, g, valid = _local_case(1, 128, 64, 64, 3)
    valid[0, 5] = False
    got, vjp, engines = local_model(qk, v, valid, 64)
    assert np.allclose(got[0, 5], v[0, :64].sum(0) / 128, atol=1e-6)
    assert not vjp(g)[0][0, 5].any()
    e = engines[0]
    x, live = e.masked(np.ones((1, 128), np.float32), np.array([5]),
                       np.array([key_row(0, 2, 64, j, False)
                                 for j in range(128)]))
    assert (x == NEG).all() and not live.any()


@pytest.mark.parametrize("N,window", [(256, 128), (192, 96)])
def test_local_model_bf16_within_card_tolerance(N, window):
    """The model with the kernels' bf16 rounding (kn, P, dS·scale; dO
    arrives in bf16) against the port's plain version in float32 on the
    same rounded inputs: within the card's 1e-2 of the largest entry."""
    qk, v, g, valid = _local_case(2, N, 128, window, N)
    qk, v, g = rnd(qk), rnd(v), rnd(g)
    got, vjp, _ = local_model(qk, v, valid, window, bf16=True)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (qk, v)]
    ref = lw.local_window_attention_plain(*a, torch.from_numpy(valid),
                                          window, 128 ** -0.5)
    ref.backward(torch.from_numpy(g))
    dqk, dv = vjp(g)
    for x, y in [(rnd(got), ref.detach()), (dqk, a[0].grad), (dv, a[1].grad)]:
        y = y.numpy()
        assert np.abs(x - y).max() <= TOL_BF16 * np.abs(y).max()


# ---- the LSH chunks -------------------------------------------------------- #

def _lsh_case(B, N, d, seed, n_hashes=4, bucket=64):
    rng = np.random.RandomState(seed)
    qk, v, g = (rng.randn(B, N, d).astype(np.float32) for _ in range(3))
    valid = rng.rand(B, N) > 0.2
    valid[0] = True
    valid[-1, N // 2 + 3:] = False
    rot = rng.randn(1, d, n_hashes, N // bucket // 2).astype(np.float32)
    return qk, v, g, valid, rot


def jax_sort(qk, valid, rot, n_hashes=4, bucket=64):
    """The hash sort of ``lsh_attention``: sticker, st, svalid [B, M]."""
    B, N, d = qk.shape
    n_buckets = N // bucket
    rotated = jnp.einsum("btf,bfhi->bhti", jnp.asarray(qk), jnp.broadcast_to(
        jnp.asarray(rot), (B, d, n_hashes, n_buckets // 2)))
    rotated = jnp.concatenate([rotated, -rotated], axis=-1)
    buckets = np.asarray(jnp.argmax(rotated, axis=-1)) + (
        np.arange(n_hashes) * n_buckets)[None, :, None]
    ticker = np.arange(n_hashes * N)[None]
    keys = N * buckets.reshape(B, -1) + ticker % N
    sticker = np.argsort(keys, axis=-1, kind="stable")
    st = sticker % N
    return sticker, st, np.take_along_axis(np.tile(valid, (1, n_hashes)),
                                           sticker, axis=1)


def lsh_model(qk, v, valid, rot, causal=True, n_hashes=4, bucket=64,
              bf16=False):
    """``lsh_attention`` through the model's chunk engine: the sort, the
    engine in the sorted domain, the un-sort and the round combine, with
    its VJP (the combine's and un-sort's backward in numpy, the engine's
    own backward, the sum of each sorted row into its source row)."""
    B, N, d = qk.shape
    sticker, st, svalid = jax_sort(qk, valid, rot, n_hashes, bucket)
    engines = [Engine(qk[b], v[b], st[b], svalid[b], bucket, causal, True,
                      d ** -0.5, bf16) for b in range(B)]
    outs = [e.forward() for e in engines]
    undo = np.argsort(sticker, axis=-1)
    uns = np.stack([o[undo[b]] for b, o in enumerate(outs)])
    o = uns[..., :d].reshape(B, n_hashes, N, d)
    lg = uns[..., d].reshape(B, n_hashes, N, 1)
    mx = lg.max(1, keepdims=True)
    w = np.exp(lg - (mx + np.log(np.exp(lg - mx).sum(1, keepdims=True))))
    out = (o * w).sum(1)

    def vjp(g):
        do = g[:, None] * w                                  # [B, h, N, d]
        gw = (g[:, None] * o).sum(-1, keepdims=True)
        dlg = w * (gw - (w * gw).sum(1, keepdims=True))
        dqk, dv = np.zeros_like(qk), np.zeros_like(v)
        for b, (e, so) in enumerate(zip(engines, outs)):
            cot = np.concatenate([do[b].reshape(-1, d),
                                  dlg[b].reshape(-1, 1)], -1)[sticker[b]]
            rq, rv = e.backward(so, cot[:, :d], cot[:, d])
            dqk[b] = scatter(rq, st[b], N)
            dv[b] = scatter(rv, st[b], N)
        return dqk, dv

    return out, vjp, engines, st


@pytest.mark.parametrize("causal", [True, False])
def test_lsh_model_matches_jax_reference(causal):
    """The model's chunk engine inside ``lsh_attention``'s sort, un-sort
    and round combine, in float32, against the jnp ``lsh_attention``
    (ctts_tpu/models/reformer.py; its chunked core :122-157), chunks of 64
    over 4 rounds: output and VJP within 2e-5 of their largest entries.
    At N=128 there are 8 chunks and chunk 0 wraps to the last."""
    qk, v, g, valid, rot = _lsh_case(2, 128, 64, 7 + causal)
    got, vjp, engines, st = lsh_model(qk, v, valid, rot, causal)
    want = _jax_vjp(lambda a, b: jr.lsh_attention(
        a, b, jnp.asarray(valid), None, causal=causal, rot=rot), qk, v, g)
    for x, y in zip([got, *vjp(g)], want):
        assert np.abs(x - y).max() <= TOL_F32 * np.abs(y).max()


def test_lsh_duplicate_positions_and_the_wrap_are_kept():
    """Where a chunk's look-back crosses a hash-round boundary the same
    position may sit in both of its slot halves (the sort of this case has
    such pairs), and chunk 0 looks back at the last chunk. Both slots are
    kept: an invalid query keeps its own position's logit pinned at -5e4
    in every slot that holds it (the LSH order puts the pin last), and no
    slot passes a score gradient."""
    qk, v, g, valid, rot = _lsh_case(1, 128, 64, 5)
    _, st, _ = jax_sort(qk, valid, rot)
    n, Q = st.shape[1] // 64, 64
    dup = 0
    for u in range(n):
        rows = [key_row(u, n, Q, j, True) for j in range(2 * Q)]
        assert rows[Q:] == list(range(((u - 1) % n) * Q, ((u - 1) % n) * Q
                                      + Q))
        pos = st[0, rows]
        dup += len(pos) - len(set(pos.tolist()))
    assert dup > 0
    # a valid query whose other keys are all masked: weight 1/2 on each of
    # its two slots of the same position
    e = Engine(qk[0], v[0], st[0], np.zeros(st.shape[1], bool), Q, True, True,
               0.125)
    krows = np.array([key_row(0, n, Q, j, True) for j in range(2 * Q)])
    x, live = e.masked(np.zeros((1, 2 * Q), np.float32), np.array([0]), krows)
    assert (x[0] == SELF).sum() == (st[0, krows] == st[0, 0]).sum()
    assert not live.any()


def test_lsh_model_bf16_within_card_tolerance():
    """The model with the kernels' bf16 rounding (LSH forward: kn and P in
    float32 precision; backward: kn, P, dS·scale and dO rounded) against
    the port's plain chunk version in float32 on the same rounded inputs
    and sort: output within 1e-4 and lse within 1e-5 (as the card's
    checks), gradients within 1e-2 of their largest entries."""
    qk, v, g, valid, rot = _lsh_case(2, 128, 128, 9)
    qk, v = rnd(qk), rnd(v)
    _, st, svalid = jax_sort(qk, valid, rot)
    M, d = st.shape[1], 128
    cot = np.random.RandomState(1).randn(2, M, d + 1).astype(np.float32)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (qk, v)]
    ref = lc.chunk_attention_plain(*a, torch.from_numpy(st.astype(np.int32)),
                                   torch.from_numpy(svalid.astype(np.int32)),
                                   64, True, d ** -0.5)
    ref.backward(torch.from_numpy(cot))
    ref = ref.detach().numpy()
    for b in range(2):
        e = Engine(qk[b], v[b], st[b], svalid[b], 64, True, True, d ** -0.5,
                   bf16=True)
        out = e.forward()
        assert np.abs(out[:, :d] - ref[b, :, :d]).max() <= 1e-4 * np.abs(
            ref[b, :, :d]).max()
        assert (np.abs(out[:, d] - ref[b, :, d]) / np.maximum(
            np.abs(ref[b, :, d]), 1)).max() <= 1e-5
        rq, rv = e.backward(out, cot[b, :, :d], cot[b, :, d])
        for x, y in [(scatter(rq, st[b], 128), a[0].grad[b]),
                     (scatter(rv, st[b], 128), a[1].grad[b])]:
            y = y.numpy()
            assert np.abs(x - y).max() <= TOL_BF16 * np.abs(y).max()


# ---- the engine's geometry ------------------------------------------------ #

@pytest.mark.parametrize("lsh", [False, True])
@pytest.mark.parametrize("Q,n", [(64, 3), (128, 2), (32, 3), (96, 2), (64, 1)])
def test_every_logit_once_in_each_phase(Q, n, lsh):
    """Each (query row, key slot) pair with a real key row is visited once
    by the forward, once by the backward's query phase and once by its key
    phase (which reaches the look-back slots of unit u+1's queries, and for
    LSH unit 0's look-back at the last unit, also with one unit), whatever
    the unit and the block size it gives."""
    R, D = n * Q, 64
    rng = np.random.RandomState(Q + n)
    pos = rng.randint(0, R, R) if lsh else np.arange(R)
    e = Engine(rng.randn(R, D), rng.randn(R, D), pos, np.ones(R, bool), Q,
               True, lsh, 0.125, track=True)
    out = e.forward()
    e.backward(out, rng.randn(R, D).astype(np.float32),
               np.zeros(R, np.float32))
    real = {(r, j) for r in range(R) for j in range(2 * Q)
            if key_row(r // Q, n, Q, j, lsh) >= 0}
    for phase in ("fwd", "q", "k"):
        seen = [(r, j) for p, r, j in e.visits if p == phase
                and key_row(r // Q, n, Q, j, lsh) >= 0]
        assert len(seen) == len(set(seen)) == len(real) and set(seen) == real


@pytest.mark.parametrize("D", [64, 128])
def test_rows_of_an_ldmatrix_fall_in_distinct_banks(D):
    """Shared rows are D + kPadE bf16 elements apart: the 8 rows of any
    ldmatrix 8x8 piece (16 bytes a row, at any row and 8-element column)
    cover all 32 banks once."""
    stride = (D + PAD_E) * 2
    assert stride % 16 == 0
    for r0 in range(8):
        for c0 in range(0, D, 8):
            banks = [((r0 + i) * stride + c0 * 2) // 4 % 32 + w
                     for i in range(8) for w in range(4)]
            assert sorted(b % 32 for b in banks) == list(range(32))


def test_model_mirrors_the_kernel_source():
    src = CUH.read_text()

    def const(name):
        m = re.search(rf"constexpr (?:int|float) {name} = ([-0-9.e]+)f?;", src)
        assert m, name
        return float(m.group(1))

    assert (const("kRows"), const("kTile"), const("kHalf"), const("kPadE"),
            const("kMaxThreads")) == (ROWS, TILE, HALF, PAD_E, MAX_THREADS)
    assert (const("kNeg"), const("kSelf"), const("kEps")) == (NEG, SELF, EPS)
    assert "return unit % 64 == 0 ? 64 : 32;" in src
    assert MAX_THREADS == 64 // ROWS * 32
    m = re.search(r"static constexpr bool kP = ([^;]*);", src)
    for (f32, lsh), want in zip([(True, False), (False, False),
                                 (False, True)], SPLIT_P):
        expr = m.group(1).replace("||", " or ")
        assert eval(expr, {"kF32": f32, "kLsh": lsh}) == want
    assert "3 * tile_bytes<D>(S::kF32)" in src        # Q, k, V split in f32
    # the backward splits every operand in float32 and none in bf16
    assert "constexpr bool kS = std::is_same<T, float>::value;" in src
    # the two mask orders, as the model applies them
    lsh_order = src.index("if (!ok) x = kNeg;\n    if (causal && qt < kt)")
    assert src.index("if (qt == kt) x = kSelf;", lsh_order) > lsh_order
    local = src.index("if (qt == kt) x = kSelf;\n    if (causal && qt < kt) "
                      "x = kNeg;\n    if (!ok) x = kNeg;")
    assert local > lsh_order
    # the slot geometry
    for line in ("if (kLsh) return ((t.u + t.n - 1) % t.n) * t.Q + j - t.Q;",
                 "return t.u == 0 ? -1 : (t.u - 1) * t.Q + j - t.Q;",
                 "if (kLsh) return ((t.u + 1) % t.n) * t.Q + j - t.Q;",
                 "return t.u + 1 < t.n ? (t.u + 1) * t.Q + j - t.Q : -1;"):
        assert line in src, line
