"""The CTC lattice kernels (ctts_torch/csrc/forward_sum.cu), modelled in
numpy and held to the JAX package on the CPU.

The lattice launch runs 2·B blocks: blocks [0, B) walk alpha forward and
blocks [B, 2B) walk beta backward, one utterance each, so the two chains
run side by side (B blocks, alpha alone, where no gradient is wanted, as in
validation) and the backward is one elementwise pass,
d(-logL)/d em = -exp(alpha + beta - logL)·g below out_len and 0 at or past
it. A thread owns one state. Each frame's row (alpha, or beta's q = em +
beta) goes into a shared buffer of the frame's parity, which the next frame
reads after one barrier: states s-1 and s-2 for alpha, s+1 and s+2 for
beta. em is read kChunk frames ahead. Each log-sum-exp is the plain
version's, term for term, with an absent input at the -1e9 sentinel. The
model repeats that geometry and arithmetic; it reads the constants and
expressions it models from the CUDA source, so a change there fails here
until the model follows. The card tests (tests/test_torch_gpu.py) hold the
kernels themselves.

Past 1024 states the wide instance keeps one block a chain and one barrier
a frame, with K = ceil(S/1024) states a thread (s = tid + k·blockDim), the
two rows S floats each (shared memory, or a global scratch past what a
block may hold), the state's own value read from its row, and em read one
frame ahead for the first kWideAhead states of a thread (the others on the
chain). :class:`WideBlock` models it.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.ops import forward_sum as j_fs
from ctts_torch.ops import forward_sum as t_fs

CU = (pathlib.Path(__file__).resolve().parents[1] / "ctts_torch" / "csrc"
      / "forward_sum.cu")

# what the model shares with the kernel; test_model_mirrors_the_kernel_source
# holds each piece against CU
NEG = np.float32(-1e9)   # kNeg
CHUNK = 8                # frames of em read ahead (kChunk)
WARP = 32
MAX_S = 1024             # one state a thread up to S = 1024 (kMaxThreads)
WIDE_AHEAD = 8           # the wide instance's states read ahead (kWideAhead)
MAX_SHARED = 232448      # bytes of shared memory a block may use (kMaxShared)
# the model against the plain version (float32 on both sides; numpy's exp
# and log against PyTorch's differ by ulps): relative to max(1, |plain|)
TOL_LATTICE = 2e-6
# NLL against the JAX scan: relative to max(1, |NLL|); the gradient against
# jax.grad: 1e-5 absolute plus 2e-5 relative, as the CPU route is held
TOL_NLL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-5


def threads(S):
    """Threads of a lattice block: one a state, whole warps."""
    return (S + WARP - 1) // WARP * WARP


def lse3(a, b, c):
    """The plain version's log-sum-exp, term for term, in float32."""
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    m = np.maximum(a, np.maximum(b, c))
    with np.errstate(over="ignore", under="ignore"):
        return (m + np.log(np.exp(a - m) + np.exp(b - m)
                           + np.exp(c - m))).astype(np.float32)


class Block:
    """One lattice block: a state a thread and the shared rows of the two
    parities (2·threads + 2 floats, poisoned with NaN until written)."""

    def __init__(self, em):
        self.em = np.asarray(em, np.float32)         # [T_m, S]
        self.T_m, self.S = self.em.shape
        self.n = threads(self.S)
        self.s = np.arange(self.n)
        self.active = self.s < self.S
        self.rows = np.full(2 * self.n + 2, np.nan, np.float32)
        self.reads = []                               # frames of em read

    def em_at(self, t, s):
        self.reads.append(t)
        return np.where(s < self.S, self.em[t, np.minimum(s, self.S - 1)],
                        NEG).astype(np.float32)

    def row(self, parity):
        """The shared row of a parity, and the two floats past it."""
        return self.rows[parity * self.n:parity * self.n + self.n + 2]

    def put(self, parity, x):
        self.rows[parity * self.n:parity * self.n + self.n] = x

    def schedule(self, first, step, stop):
        """The frames of the chain in the kernel's order, with em read
        kChunk frames ahead: yields (t, em[t] of every thread's state) from
        the read-ahead registers."""
        def live(t):
            return (t < stop) if step > 0 else (t >= stop)
        ahead = [self.em_at(first + step * c, self.s)
                 if live(first + step * c) else None for c in range(CHUNK)]
        t0 = first
        while live(t0):
            cur = ahead
            ahead = [self.em_at(t0 + step * (CHUNK + c), self.s)
                     if live(t0 + step * (CHUNK + c)) else None
                     for c in range(CHUNK)]
            for c in range(CHUNK):
                t = t0 + step * c
                if not live(t):
                    return
                yield t, cur[c]
            t0 += step * CHUNK

    def alpha(self, olen):
        T_m, S, s = self.T_m, self.S, self.s
        olen = min(max(int(olen), 0), T_m)
        out = np.zeros((T_m, S), np.float32)
        a = np.where((s < 2) & self.active,
                     self.em_at(0, np.minimum(s, 1)), NEG).astype(np.float32)
        self.put(0, a)
        out[0] = a[:S]
        skip = (s % 2 == 1) & (s >= 3)
        for t, e in self.schedule(1, 1, olen):
            prev = self.row((t - 1) & 1)
            p1 = np.where(s >= 1, prev[np.maximum(s - 1, 0)], NEG)
            p2 = np.where(skip, prev[np.maximum(s - 2, 0)], NEG)
            a = lse3(a, p1, p2) + e
            self.put(t & 1, a)
            out[t] = a[:S]
        out[max(olen, 1):] = a[:S]
        return out

    def beta(self, ilen, olen):
        T_m, S, s = self.T_m, self.S, self.s
        olen = min(max(int(olen), 0), T_m)
        last = 2 * int(ilen)
        bt = np.where(self.active & ((s == last) | (s == last - 1)),
                      np.float32(0), NEG).astype(np.float32)
        out = np.zeros((T_m, S), np.float32)
        if olen < 2:
            out[:] = bt[:S]
            return out
        fin = bt
        can1, can2 = s + 1 < S, (s % 2 == 1) & (s + 2 < S)
        q = self.em_at(olen - 1, s) + bt
        self.put((olen - 2) & 1, q)
        for t, e in self.schedule(olen - 2, -1, 0):
            nxt = self.row(t & 1)
            bt = lse3(q, np.where(can1, nxt[s + 1], NEG),
                      np.where(can2, nxt[s + 2], NEG))
            out[t] = bt[:S]
            q = e + bt
            self.put((t - 1) & 1, q)
        out[olen - 1:] = fin[:S]
        return out


def lattices(em, in_lens, out_lens):
    """The lattice launch: alpha and beta [B, T_m, S]."""
    alpha = np.stack([Block(e).alpha(o) for e, o in zip(em, out_lens)])
    beta = np.stack([Block(e).beta(i, o)
                     for e, i, o in zip(em, in_lens, out_lens)])
    return alpha, beta


def log_l(alpha, in_lens):
    i2 = 2 * np.asarray(in_lens, np.int64)
    fin = np.stack([alpha[b, -1, [i2[b], max(i2[b] - 1, 0)]]
                    for b in range(len(i2))])
    return torch.logsumexp(torch.from_numpy(fin), -1).numpy()


def gradient(alpha, beta, ll, g, out_lens):
    """The elementwise kernel: every element of [B, T_m, S]."""
    B, T_m, S = alpha.shape
    idx = np.arange(B * T_m * S)
    row = idx // S
    b, t = row // T_m, row % T_m
    a, be = alpha.reshape(-1), beta.reshape(-1)
    with np.errstate(under="ignore"):
        val = -np.exp(a + be - ll[b]) * g[b]
    return np.where(t < np.asarray(out_lens)[b], val,
                    np.float32(0)).astype(np.float32).reshape(B, T_m, S)


def case(seed, T_m, T_s, in_lens, out_lens):
    """State log-emissions [B, T_m, S] built as forward_sum_loss builds
    them (the JAX package's log-softmax and interleave)."""
    rng = np.random.RandomState(seed)
    B = len(in_lens)
    logits = np.concatenate([np.full((B, T_m, 1), j_fs.BLANK_LOGPROB,
                                     np.float32),
                             rng.randn(B, T_m, T_s).astype(np.float32) * 2],
                            -1)
    valid = np.arange(T_s + 1)[None, None] <= np.asarray(in_lens)[:, None,
                                                                  None]
    ls = j_fs._log_softmax(jnp.where(valid, logits, j_fs._NEG))
    return (np.asarray(j_fs._interleave(ls)), np.asarray(in_lens, np.int32),
            np.asarray(out_lens, np.int32))


def lattice_err(got, ref):
    """max |got - ref| / max(1, |ref|) over reachable entries; the
    sentinels agree in place."""
    live = ref > -1e8
    assert np.array_equal(live, got > -1e8)
    return (np.abs(got - ref) / np.maximum(1.0, np.abs(ref)))[live].max()


CASES = {
    # reachable ends, ragged lengths, out_len = T_m
    "ragged": (0, 40, 9, [9, 6, 3, 1], [40, 33, 17, 12]),
    # S = 513: 544 threads, 17 warps (the last one partly idle); every end
    # reachable
    "nine_warps": (1, 260, 256, [256, 130, 7, 60, 2],
                   [260, 257, 31, 100, 2]),
    # out_len 0, 1 and 2, out_len < in_len (the end unreachable); the
    # shapes of nine_warps, so the JAX scan is compiled once
    "edges": (2, 260, 256, [1, 3, 256, 12, 5], [0, 1, 2, 7, 260]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_the_plain_versions(name):
    """alpha and beta as the plain versions (the CPU route) compute them,
    and the gradient as the plain one computes it from the same lattices
    (numpy's exp and log against PyTorch's: ulps)."""
    em, il, ol = case(*CASES[name])
    alpha, beta = lattices(em, il, ol)
    t_em = torch.from_numpy(em.copy())
    ref_a = t_fs.ctc_alpha_plain(t_em, torch.from_numpy(ol)).numpy()
    ref_b = t_fs.ctc_beta_plain(t_em, torch.from_numpy(il),
                                torch.from_numpy(ol)).numpy()
    assert lattice_err(alpha, ref_a) <= TOL_LATTICE
    assert lattice_err(beta, ref_b) <= TOL_LATTICE
    ll = log_l(alpha, il)
    g = np.linspace(0.5, 1.5, len(il)).astype(np.float32)
    want = t_fs.ctc_grad_plain(*(torch.from_numpy(x) for x in (
        alpha, beta, ll, g, ol))).numpy()
    np.testing.assert_allclose(gradient(alpha, beta, ll, g, ol), want,
                               rtol=1e-6, atol=1e-30)   # subnormals


def test_nll_and_gradient_match_the_jax_scan():
    """-logL against ``_ctc_nll_scan`` and the elementwise gradient
    against its ``jax.grad`` under a per-utterance cotangent (every end
    reachable, out_len >= 1)."""
    em, il, ol = case(*CASES["ragged"])
    g = np.linspace(0.5, 1.5, len(il)).astype(np.float32)
    (_, nll), want_g = jax.value_and_grad(lambda e: (lambda n: (
        jnp.sum(n * g), n))(j_fs._ctc_nll_scan(e, jnp.asarray(il),
                                               jnp.asarray(ol))),
        has_aux=True)(jnp.asarray(em))
    alpha, beta = lattices(em, il, ol)
    ll = log_l(alpha, il)
    nll = np.asarray(nll)
    assert np.all(np.abs(-ll - nll) <= TOL_NLL * np.maximum(1, np.abs(nll)))
    np.testing.assert_allclose(gradient(alpha, beta, ll, g, ol),
                               np.asarray(want_g), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


def test_nll_of_nine_warps_matches_the_jax_scan():
    """S = 513 over 260 frames: -logL against ``_ctc_nll_scan``."""
    em, il, ol = case(*CASES["nine_warps"])
    nll = np.asarray(j_fs._ctc_nll_scan(jnp.asarray(em), jnp.asarray(il),
                                        jnp.asarray(ol)))
    alpha, _ = lattices(em, il, ol)
    assert np.all(np.abs(-log_l(alpha, il) - nll)
                  <= TOL_NLL * np.maximum(1, np.abs(nll)))


def test_gradient_matches_the_pallas_pair_in_interpret_mode(monkeypatch):
    """The TPU kernels' own gradient, out_len 0 included: zero at or past
    out_len, whatever frame 0 holds."""
    monkeypatch.setattr(j_fs, "_INTERPRET", True)
    em, il, ol = case(3, 20, 6, [6, 1, 4], [20, 0, 9])
    g = np.asarray([1.0, 0.7, 1.3], np.float32)
    want = np.asarray(jax.grad(lambda e: jnp.sum(j_fs._ctc_state_nll(
        e, jnp.asarray(il), jnp.asarray(ol)) * g))(jnp.asarray(em)))
    alpha, beta = lattices(em, il, ol)
    got = gradient(alpha, beta, log_l(alpha, il), g, ol)
    assert not got[1].any()
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("grad", [False, True])
def test_beta_only_where_a_gradient_can_be_asked_for(grad, monkeypatch):
    """Under no_grad (validation) the lattice runs alpha alone and the NLL
    is the same bits; with a gradient beta is computed once."""
    em, il, ol = (np.array(x) for x in case(*CASES["ragged"]))
    calls = []
    beta_plain = t_fs.ctc_beta_plain

    def counted(*args):
        calls.append(1)
        return beta_plain(*args)

    want = t_fs.ctc_state_nll(torch.from_numpy(em), torch.from_numpy(il),
                              torch.from_numpy(ol)).detach()
    monkeypatch.setattr(t_fs, "ctc_beta_plain", counted)
    e = torch.from_numpy(em).requires_grad_(True)
    with torch.set_grad_enabled(grad):
        nll = t_fs.ctc_state_nll(e, torch.from_numpy(il),
                                 torch.from_numpy(ol))
    assert len(calls) == int(grad)
    assert torch.equal(nll.detach(), want)
    if grad:
        nll.sum().backward()
        assert torch.isfinite(e.grad).all()


def test_unreachable_end_and_frozen_rows():
    """out_len < in_len: -logL at the sentinel's scale on both sides, the
    gradient finite; alpha frozen at or past out_len, beta's final row at
    or past out_len - 1, the gradient zero at or past out_len."""
    em, il, ol = case(*CASES["edges"])
    alpha, beta = lattices(em, il, ol)
    ll = log_l(alpha, il)
    nll = np.asarray(j_fs._ctc_nll_scan(jnp.asarray(em), jnp.asarray(il),
                                        jnp.asarray(ol)))
    assert np.all(np.abs(-ll - nll) <= TOL_NLL * np.maximum(1, np.abs(nll)))
    assert ll[3] < -1e8 and nll[3] > 1e8              # out_len 7 < in_len 12
    g = np.ones(len(il), np.float32)
    dem = gradient(alpha, beta, ll, g, ol)
    assert np.isfinite(dem).all()
    for b, (i, n) in enumerate(zip(il, ol)):
        row = alpha[b, max(n - 1, 0)]
        assert (alpha[b, max(n, 1):] == row).all()
        last = 2 * i
        fin = np.where((np.arange(em.shape[2]) == last)
                       | (np.arange(em.shape[2]) == last - 1), 0, NEG)
        assert (beta[b, max(n - 1, 0):] == fin).all()
        assert not dem[b, n:].any()


@pytest.mark.parametrize("S", [3, 63, 65, 257, 513, 1023])
def test_every_state_owned_once_and_the_rows_fit(S):
    """One thread a state, whole warps; beta's reads of states s+1 and s+2
    stay inside the two shared rows and their two floats of slack."""
    n = threads(S)
    assert n % WARP == 0 and n - WARP < S <= n <= MAX_S
    s = np.arange(n)
    for parity in (0, 1):
        reads = parity * n + s[(s + 1 < S)] + 1
        assert reads.max(initial=0) < 2 * n + 2
        reads = parity * n + s[(s % 2 == 1) & (s + 2 < S)] + 2
        assert reads.max(initial=0) < 2 * n + 2


@pytest.mark.parametrize("olen", [0, 1, 2, 8, 9, 17, 40])
def test_read_ahead_reads_each_frame_once(olen):
    """alpha reads em[0] and then frames 1 .. out_len-1 once each, in
    order; beta reads em[out_len-1] and then frames out_len-2 .. 0."""
    em, il, ol = case(4, 40, 3, [3], [olen])
    blk = Block(em[0])
    blk.alpha(olen)
    assert blk.reads == list(range(max(olen, 1)))
    blk = Block(em[0])
    blk.beta(3, olen)
    assert blk.reads == (list(range(olen - 1, -1, -1)) if olen >= 2 else [])


def test_gradient_grid_covers_every_element():
    """The flat index of the elementwise kernel: row = idx / S, b = row /
    T_m, in 32-bit arithmetic below 2^31 elements."""
    B, T_m, S = 3, 7, 11
    idx = np.arange(B * T_m * S)
    row = idx // S
    b, t, s = row // T_m, row - (row // T_m) * T_m, idx - row * S
    want = np.unravel_index(idx, (B, T_m, S))
    assert all(np.array_equal(x, y) for x, y in zip((b, t, s), want))
    assert 16 * 896 * 257 < 2 ** 31


def test_model_mirrors_the_kernel_source():
    src = CU.read_text()
    m = re.search(r"constexpr float kNeg = ([-0-9.e]+)f;", src)
    assert m and float(m.group(1)) == NEG
    m = re.search(r"constexpr int kChunk = (\d+);", src)
    assert m and int(m.group(1)) == CHUNK
    for line in (
            # the plain version's log-sum-exp
            "const float m = fmaxf(a, fmaxf(b, c));",
            "return m + logf(expf(a - m) + expf(b - m) + expf(c - m));",
            # alpha: the previous row of the parity, states s-1 and s-2
            "const bool active = s < n_s, skip = (s & 1) && s >= 3;",
            "const float* prev = rows + ((t - 1) & 1) * n;",
            "const float p1 = s >= 1 ? prev[s - 1] : kNeg;",
            "const float p2 = skip ? prev[s - 2] : kNeg;",
            "a = lse3(a, p1, p2) + cur[c];",
            "rows[(t & 1) * n + s] = a;",
            "for (int t = max(olen, 1); t < t_m; ++t)",
            # beta: q of states s+1 and s+2, the final row after the chain
            "can2 = (s & 1) && s + 2 < n_s, can1 = s + 1 < n_s;",
            "float q = em_at(eb, olen - 1, s, n_s) + bt;",
            "rows[((olen - 2) & 1) * n + s] = q;",
            "const float* next = rows + (t & 1) * n;",
            "bt = lse3(q, can1 ? next[s + 1] : kNeg, can2 ? next[s + 2] : "
            "kNeg);",
            "q = cur[c] + bt;",
            "rows[((t - 1) & 1) * n + s] = q;",
            "for (int t = olen - 1; t < t_m; ++t)",
            # the launch: 2B blocks (B, alpha alone, with a null beta), one
            # thread a state, two rows + 2
            "const int threads = (n_s + 31) / 32 * 32;",
            "kernel<<<beta ? 2 * b : b, threads, "
            "(2 * threads + 2) * sizeof(float),",
            # blocks past 512 threads take the instance whose launch bound
            # fits 1024 threads' registers
            "__global__ void __launch_bounds__(1024)",
            "threads <= 512 ? ctc_lattice_kernel : ctc_lattice_kernel_1024;",
            "const bool is_beta = static_cast<int>(blockIdx.x) >= n_b;",
            # the gradient
            "const I row = idx / n_s, b = row / t_m;",
            "? -expf(alpha[idx] + beta[idx] - log_l[b]) * g_out[b]",
            "if (total < (1u << 31))",
            "if (n_s <= kMaxThreads) {"):
        assert line in src, line
    assert MAX_S == 1024
    assert "n_s > 1024" not in src


# ---- the wide instance (S > 1024) ----------------------------------------- #

def wide_shape(S):
    """(threads, states a thread) of the wide instance: K = ceil(S/1024),
    threads ceil(S/K) in whole warps."""
    k = -(-S // MAX_S)
    return -(-(-(-S // k)) // WARP) * WARP, k


class WideBlock:
    """One block of the wide instance: thread tid owns states tid + k·n,
    k < K; the two rows hold S floats each (poisoned with NaN until
    written); each frame reads the row of the other parity and writes its
    own after one barrier. ``reads`` counts the reads of each em cell."""

    def __init__(self, em):
        self.em = np.asarray(em, np.float32)
        self.T_m, self.S = self.em.shape
        self.n, self.K = wide_shape(self.S)
        owner = np.arange(self.n)[:, None] + np.arange(self.K)[None] * self.n
        self.owned = owner[owner < self.S]           # every live (tid, k)
        self.k_of = (np.arange(self.S) // self.n)    # k of state s
        self.rows = np.full(2 * self.S, np.nan, np.float32)
        self.reads = np.zeros((self.T_m, self.S), np.int64)

    def row(self, parity):
        return self.rows[parity * self.S:(parity + 1) * self.S]

    def read(self, t, states):
        np.add.at(self.reads, (t, states), 1)
        return self.em[t, states]

    def ahead(self, t):
        """em[t] of the states read ahead (k < kWideAhead), read the frame
        before; the others are read on the chain, in frame t itself."""
        near = np.arange(self.S)[self.k_of < WIDE_AHEAD]
        far = np.arange(self.S)[self.k_of >= WIDE_AHEAD]
        e = np.empty(self.S, np.float32)
        e[near] = self.read(t, near)
        return e, far

    def alpha(self, olen):
        T_m, S = self.T_m, self.S
        olen = min(max(int(olen), 0), T_m)
        s = np.arange(S)
        out = np.zeros((T_m, S), np.float32)
        a = np.full(S, NEG, np.float32)
        a[:2] = self.read(0, s[:2])
        self.row(0)[:] = a
        out[0] = a
        for t in range(1, olen):
            e, far = self.ahead(t)
            e[far] = self.read(t, far)
            prev = self.row((t - 1) & 1)
            p1 = np.where(s >= 1, prev[np.maximum(s - 1, 0)], NEG)
            p2 = np.where((s % 2 == 1) & (s >= 3), prev[np.maximum(s - 2, 0)],
                          NEG)
            a = lse3(prev, p1, p2) + e
            self.row(t & 1)[:] = a
            out[t] = a
        out[max(olen, 1):] = self.row((max(olen, 1) - 1) & 1)
        return out

    def beta(self, ilen, olen):
        T_m, S = self.T_m, self.S
        olen = min(max(int(olen), 0), T_m)
        s = np.arange(S)
        last = 2 * int(ilen)
        fin = np.where((s == last) | (s == last - 1), np.float32(0),
                       NEG).astype(np.float32)
        out = np.zeros((T_m, S), np.float32)
        if olen < 2:
            out[:] = fin
            return out
        self.row((olen - 2) & 1)[:] = self.read(olen - 1, s) + fin
        for t in range(olen - 2, -1, -1):
            e, far = self.ahead(t)
            e[far] = self.read(t, far)
            nxt = self.row(t & 1)
            bt = lse3(nxt, np.where(s + 1 < S, nxt[np.minimum(s + 1, S - 1)],
                                    NEG),
                      np.where((s % 2 == 1) & (s + 2 < S),
                               nxt[np.minimum(s + 2, S - 1)], NEG))
            out[t] = bt
            self.row((t - 1) & 1)[:] = e + bt
        out[olen - 1:] = fin
        return out


def wide_lattices(em, in_lens, out_lens):
    alpha = np.stack([WideBlock(e).alpha(o) for e, o in zip(em, out_lens)])
    beta = np.stack([WideBlock(e).beta(i, o)
                     for e, i, o in zip(em, in_lens, out_lens)])
    return alpha, beta


WIDE_CASES = {
    # S = 1025, 1281 (the long step's 640 tokens) and 2049: two and three
    # states a thread over every state of the axis (the dead ones past
    # 2·in_len + 1 included), ragged lengths with reachable ends, and
    # out_len < in_len, 0, 1 and 2
    "1025": (5, 40, 512, [512, 20, 7, 30], [40, 37, 10, 2]),
    "1281": (6, 60, 640, [640, 1, 25, 50], [60, 0, 1, 60]),
    "2049": (7, 50, 1024, [1024, 30, 15], [50, 49, 50]),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_wide_model_matches_the_plain_versions_and_the_jax_scan(name):
    """The wide instance's alpha and beta as the plain versions compute
    them, its -logL as ``_ctc_nll_scan`` (the sentinel's scale where the
    end is unreachable), and every em cell the chains use read once."""
    seed, T_m, T_s, il, ol = WIDE_CASES[name]
    em, il, ol = case(seed, T_m, T_s, il, ol)
    alpha, beta = wide_lattices(em, il, ol)
    t_em = torch.from_numpy(em.copy())
    ref_a = t_fs.ctc_alpha_plain(t_em, torch.from_numpy(ol)).numpy()
    ref_b = t_fs.ctc_beta_plain(t_em, torch.from_numpy(il),
                                torch.from_numpy(ol)).numpy()
    assert lattice_err(alpha, ref_a) <= TOL_LATTICE
    assert lattice_err(beta, ref_b) <= TOL_LATTICE
    nll = np.asarray(j_fs._ctc_nll_scan(jnp.asarray(em), jnp.asarray(il),
                                        jnp.asarray(ol)))
    ll = log_l(alpha, il)
    assert np.all(np.abs(-ll - nll) <= TOL_NLL * np.maximum(1, np.abs(nll)))
    for b, o in enumerate(ol):
        blk = WideBlock(em[b])
        blk.alpha(o)
        want = np.zeros_like(blk.reads)
        want[0, :2] = 1
        want[1:max(int(o), 1)] = 1
        assert np.array_equal(blk.reads, want)


def test_wide_model_past_the_read_ahead_matches_the_plain_versions():
    """S = 8193: nine states a thread, the ninth read on the chain, not
    ahead; every em cell the chains use read once."""
    em, il, ol = case(8, 6, 4096, [4096, 2], [6, 5])
    alpha, beta = wide_lattices(em, il, ol)
    t_em = torch.from_numpy(em.copy())
    assert lattice_err(alpha, t_fs.ctc_alpha_plain(
        t_em, torch.from_numpy(ol)).numpy()) <= TOL_LATTICE
    assert lattice_err(beta, t_fs.ctc_beta_plain(
        t_em, torch.from_numpy(il), torch.from_numpy(ol)).numpy()) \
        <= TOL_LATTICE
    blk = WideBlock(em[0])
    assert blk.K == 9 and blk.k_of.max() == 8 >= WIDE_AHEAD
    blk.beta(il[0], ol[0])
    assert np.array_equal(blk.reads, np.ones_like(blk.reads))


def test_wide_gradient_matches_jax_grad():
    """The elementwise gradient from the wide lattices at S = 1025 against
    ``jax.grad`` of ``_ctc_nll_scan`` where both ends are reachable, as
    the CPU route is held."""
    seed, T_m, T_s, il, ol = WIDE_CASES["1025"]
    em, il, ol = case(seed, T_m, T_s, il[1:3], ol[1:3])
    g = np.asarray([0.7, 1.3], np.float32)
    want = np.asarray(jax.grad(lambda e: jnp.sum(j_fs._ctc_nll_scan(
        e, jnp.asarray(il), jnp.asarray(ol)) * g))(jnp.asarray(em)))
    alpha, beta = wide_lattices(em, il, ol)
    np.testing.assert_allclose(gradient(alpha, beta, log_l(alpha, il), g, ol),
                               want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def route(S):
    """The instance of forward_sum.cu that a lattice of S states launches:
    (name, threads a block, states a thread, where the two rows of a chain
    live)."""
    if S <= MAX_S:
        return ("lattice" if threads(S) <= 512 else "lattice_1024",
                threads(S), 1, "shared")
    return ("lattice_wide", *wide_shape(S),
            "shared" if 8 * S <= MAX_SHARED else "global")


@pytest.mark.parametrize("S", [1, 257, 513, 1024, 1025, 1281, 2049, 4097,
                               8191, 8193, 29056, 29057, 65537])
def test_the_wrapper_routes_each_width_to_its_instance(S):
    """:func:`route`, the launch's choice as a plain function, against the
    launch in the source: one state a thread up to 1024 (the 512-thread
    instance first), the wide instance past it, every state owned once by
    a thread of at most 1024, its two rows in shared memory while 8·S
    bytes fit one block, else in the global scratch. The wrapper counts a
    launch as wide past ``MAX_THREADS``, the source's kMaxThreads."""
    name, threads, k, where = route(S)
    if S <= MAX_S:
        assert (k, where) == (1, "shared") and threads == -(-S // WARP) * WARP
        assert name == ("lattice" if threads <= 512 else "lattice_1024")
        return
    assert name == "lattice_wide" and (threads, k) == wide_shape(S)
    assert threads % WARP == 0 and threads <= MAX_S
    owner = np.arange(threads)[:, None] + np.arange(k)[None] * threads
    assert np.array_equal(np.sort(owner[owner < S]), np.arange(S))
    assert (owner < S).sum(1).min() >= k - 1          # no idle thread rows
    assert where == ("shared" if 8 * S <= MAX_SHARED else "global")


def test_wide_model_mirrors_the_kernel_source():
    src = CU.read_text()
    for name, want in (("kMaxThreads", MAX_S), ("kWideAhead", WIDE_AHEAD),
                       ("kMaxShared", MAX_SHARED)):
        m = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    assert t_fs.MAX_THREADS == MAX_S
    for line in (
            # K states a thread, whole warps, rows in shared memory while
            # they fit
            "int wide_states(int n_s) { return (n_s + kMaxThreads - 1) / "
            "kMaxThreads; }",
            "return ((n_s + k - 1) / k + 31) / 32 * 32;",
            "bool wide_rows_shared(int n_s) { return 8LL * n_s <= kMaxShared; }",
            "const int tid = threadIdx.x, n = blockDim.x, kn = (n_s + n - 1) / n;",
            "const int s = tid + k * n;",
            # alpha: the own value and s-1, s-2 from the previous row
            "const float* prev = rows + ((t - 1) & 1) * n_s;",
            "const float p2 = ((s & 1) && s >= 3) ? prev[s - 2] : kNeg;",
            "const float a = lse3(prev[s], p1, p2) + em_wide(cur, k, eb, t, s, n_s);",
            "const float* fin = rows + ((max(olen, 1) - 1) & 1) * n_s;",
            # beta: s, s+1, s+2 of the next row, the own q into the other
            "const float* next = rows + (t & 1) * n_s;",
            "const float bt = lse3(next[s], s + 1 < n_s ? next[s + 1] : kNeg,",
            "((s & 1) && s + 2 < n_s) ? next[s + 2] : kNeg);",
            "row[s] = em_wide(cur, k, eb, t, s, n_s) + bt;",
            "rows[((olen - 2) & 1) * n_s + s] =",
            # em: the first kWideAhead states a frame ahead, the rest on the
            # chain
            "return k < kWideAhead ? e : eb[static_cast<size_t>(t) * n_s + s];",
            "nxt[k] = (k < kn && s < n_s && t + 1 < olen)",
            # the global scratch: 2*S floats a block
            "float* rows = scratch ? scratch + 2 * static_cast<size_t>"
            "(blockIdx.x) * n_s",
            "return n_blocks * 2 * n_s * static_cast<long long>(sizeof(float));"):
        assert line in src, line
