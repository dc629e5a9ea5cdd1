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

Past kClusterFrom = 640 states (where it measured faster than one block)
a chain runs on a thread block cluster of kClusterMax
CTAs, each owning a tile of states, which hand their two edge states to
the next CTA over distributed shared memory (a halo ring of kHalo slots
with full and empty mbarriers, or one cluster barrier a frame) and stage em
kEmRing - 1 frames ahead in a shared ring. :class:`ClusterChain` models it.
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
MAX_S = 1024             # a block's threads (kMaxThreads)
CLUSTER_FROM = 640       # one block a chain up to S = 640 (kClusterFrom)
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
            "if (n_s <= kClusterFrom) {"):
        assert line in src, line
    assert MAX_S == 1024
    assert "n_s > 1024" not in src


# ---- the cluster lattice (S > 640) ---------------------------------------- #

CLUSTER_MAX = 8    # CTAs a cluster chain (kClusterMax)
EM_RING = 8        # frames of em in a CTA's ring (kEmRing)
SPAN = 8           # frames a handoff covers (kSpan)
GHOST = 2 * SPAN   # ghost states a CTA computes upstream of its tile (kGhost)
HALO = 8           # handoffs in flight (kHalo)
# the halo ring's mbarriers, its slots and the floats its hand-backs land in
LAYOUT_HEAD = 2 * HALO * 8 + (GHOST + 1) * HALO * 4
CONST = -2         # a cell that holds the sentinel for good


def cluster_shape(S, ctas=CLUSTER_MAX):
    """(states a CTA, threads a CTA, cells a thread) of the cluster kernel:
    tile = ceil(S/ctas), kGhost + tile cells, K = ceil(cells/1024), threads
    ceil(cells/K) in whole warps."""
    tile = -(-S // ctas)
    cells = GHOST + tile
    k = -(-cells // MAX_S)
    return tile, -(-(-(-cells // k)) // WARP) * WARP, k


def cluster_bytes(tile, rows_shared, ring):
    """cluster_layout(): the halo ring, two rows and kEmRing ring rows of
    kGhost + tile floats."""
    return (LAYOUT_HEAD + (2 * (GHOST + tile) * 4 if rows_shared else 0)
            + (EM_RING * (GHOST + tile) * 4 if ring else 0))


class ClusterChain:
    """One chain (alpha, or beta of one utterance) on a cluster of ``ctas``
    CTAs, run as the kernel runs it. CTA r owns states [r·tile, r·tile +
    nt) and computes the kGhost states upstream of them too: cell q holds
    position p = q - kGhost along the chain's direction (alpha s = lo + p,
    beta s = hi - 1 - p) and reads the previous row at q (own), q - 1 and,
    for a skip, q - 2. Each cell remembers the step that wrote it, and a
    read of a cell not written at the step before fails: k steps after a
    handoff only cells q >= 2k are computed, and kSpan steps on the upstream
    CTA's kGhost edge cells of that step refill the ghosts (a CTA with none
    upstream holds the sentinel there for good). Rows are poisoned with NaN
    until written. The CTAs run in a seeded random order that each CTA's
    waits allow: a step after a handoff waits for its slot (written for this
    handoff, not yet overwritten), and a handoff waits for the downstream
    CTA to have handed back the slot kHalo handoffs before, which it does
    only where the slot is reused (u + kHalo < handoffs), so none is left in
    flight at the end. ``ring``: em staged kEmRing - 1 steps ahead into a
    ring slot a step, each slot written after its last read and read once
    after its write."""

    def __init__(self, em, ctas, beta, ilen, olen, ring=True, seed=0):
        self.em = np.asarray(em, np.float32)
        self.T_m, self.S = self.em.shape
        self.ctas, self.beta, self.ring = ctas, beta, ring
        self.ilen = int(ilen)
        self.olen = min(max(int(olen), 0), self.T_m)
        self.tile = cluster_shape(self.S, ctas)[0]
        self.rng = np.random.RandomState(seed)
        self.reads = np.zeros((self.T_m, self.S), np.int64)
        if beta:
            self.steps = self.olen - 1 if self.olen >= 2 else 0
        else:
            self.steps = max(self.olen, 1) - 1
        self.n_hand = (self.steps - 1) // SPAN if self.steps > 0 else 0
        self.handoffs = 0

    def frame(self, j):
        return self.olen - 1 - j if self.beta else j

    def read_em(self, t, s):
        np.add.at(self.reads, (t, s), 1)
        return self.em[t, s]

    def cta(self, r):
        lo = r * self.tile
        nt = min(self.tile, self.S - lo)
        assert nt >= GHOST
        q = np.arange(GHOST + nt)
        p = q - GHOST
        s = lo + nt - 1 - p if self.beta else lo + p
        up = r + 1 if self.beta else r - 1          # where the ghosts come from
        down = r - 1 if self.beta else r + 1        # where the edges go
        w = GHOST + self.tile
        rows = np.full((2, w), np.nan, np.float32)
        written = np.full((2, w), -1)
        receives = 0 <= up < self.ctas
        if not receives:
            rows[:, :GHOST] = NEG
            written[:, :GHOST] = CONST
        return dict(r=r, nt=nt, q=q, s=s, rows=rows, written=written,
                    receives=receives, q0=0 if receives else GHOST,
                    down=down if 0 <= down < self.ctas else None,
                    ring=np.full((EM_RING, GHOST + nt), np.nan, np.float32),
                    ring_tag=np.full(EM_RING, -1),
                    ring_read=np.ones(EM_RING, bool),
                    halo=np.full((HALO, GHOST), np.nan, np.float32),
                    halo_tag=np.full(HALO, -1), acked=-1, j=0)

    def stage(self, c, j):
        """em of step j into ring slot j % kEmRing (cp.async, one group)."""
        if j > self.steps:
            return
        slot, q0 = j % EM_RING, c["q0"]
        assert c["ring_read"][slot] and c["ring_tag"][slot] in (-1,
                                                                j - EM_RING)
        c["ring"][slot, q0:] = self.read_em(self.frame(j), c["s"][q0:])
        c["ring_tag"][slot], c["ring_read"][slot] = j, False

    def em_of(self, c, j, live):
        if not self.ring:
            return self.read_em(self.frame(j), c["s"][live])
        slot = j % EM_RING
        assert c["ring_tag"][slot] == j and not c["ring_read"][slot]
        c["ring_read"][slot] = True
        return c["ring"][slot, live]

    def can_step(self, c, ctas):
        j = c["j"]
        if j > self.steps:
            return False
        j0 = (j - 1) // SPAN * SPAN
        if c["receives"] and j0 > 0 and j == j0 + 1:
            u = j0 // SPAN - 1
            if c["halo_tag"][u % HALO] != u:
                return False
        if c["down"] is not None and j % SPAN == 0 and 0 < j < self.steps:
            u = j // SPAN - 1
            if u >= HALO and ctas[c["down"]]["acked"] < u - HALO:
                return False
        return True

    def step(self, c, ctas, out):
        j, q, s, rows, wr = c["j"], c["q"], c["s"], c["rows"], c["written"]
        last = 2 * self.ilen
        q0 = c["q0"]
        if j == 0:
            if self.beta:
                if self.olen >= 2:
                    v = self.read_em(self.olen - 1, s[q0:]) + np.where(
                        (s[q0:] == last) | (s[q0:] == last - 1),
                        np.float32(0), NEG)
                    rows[0, q[q0:]] = v
                    wr[0, q[q0:]] = 0
            else:
                live = q >= q0
                v = np.full(live.sum(), NEG, np.float32)
                first = s[live] < 2
                v[first] = self.read_em(0, s[live][first])
                rows[0, q[q0:]] = v
                wr[0, q[q0:]] = 0
                own = q >= GHOST
                out[0, s[own]] = rows[0, q[own]]
            if self.ring:
                for k in range(1, EM_RING):
                    self.stage(c, k)
        else:
            prev, cur = rows[(j - 1) & 1], rows[j & 1]
            pw, cw = wr[(j - 1) & 1], wr[j & 1]
            j0 = (j - 1) // SPAN * SPAN
            if c["receives"] and j0 > 0 and j == j0 + 1:
                u = j0 // SPAN - 1
                slot = u % HALO
                assert c["halo_tag"][slot] == u
                prev[:GHOST] = c["halo"][slot]
                pw[:GHOST] = j0
                if u + HALO < self.n_hand:            # the hand-back
                    assert c["acked"] == u - 1
                    c["acked"] = u
            q_lo = 2 * (j - j0) if c["receives"] else GHOST
            live = q >= max(q_lo, q0)
            ql, sl = q[live], s[live]
            two = (sl % 2 == 1) if self.beta else ((sl % 2 == 1) & (sl >= 3))
            need = np.concatenate([ql, ql - 1, ql[two] - 2])
            assert np.isin(pw[need], (j - 1, CONST)).all(), "a stale cell"
            e = self.em_of(c, j, live)
            x = lse3(prev[ql], prev[ql - 1],
                     np.where(two, prev[np.maximum(ql - 2, 0)], NEG))
            t = self.frame(j)
            v = (e + x if self.beta else x + e).astype(np.float32)
            own = ql >= GHOST
            out[t, sl[own]] = (x if self.beta else v)[own]
            cur[ql] = v
            cw[ql] = j
            d = c["down"]
            if d is not None and j % SPAN == 0 and j < self.steps:
                u = j // SPAN - 1
                dc = ctas[d]
                assert u < HALO or dc["acked"] >= u - HALO    # the empty wait
                edge = ql >= c["nt"]
                assert edge.sum() == GHOST
                dc["halo"][u % HALO] = v[edge]
                dc["halo_tag"][u % HALO] = u
                self.handoffs += 1
            if self.ring:
                self.stage(c, j + EM_RING - 1)
        c["j"] += 1

    def run(self):
        out = np.full((self.T_m, self.S), np.nan, np.float32)
        ctas = [self.cta(r) for r in range(self.ctas)]
        while any(c["j"] <= self.steps for c in ctas):
            ready = [c for c in ctas if self.can_step(c, ctas)]
            assert ready, "the cluster deadlocks"
            self.step(ready[self.rng.randint(len(ready))], ctas, out)
        assert self.handoffs == self.n_hand * (self.ctas - 1)
        last = 2 * self.ilen
        for c in ctas:                   # frozen and final rows, off the chain
            own = c["q"] >= GHOST
            s = c["s"][own]
            if self.beta:
                out[(self.olen - 1 if self.olen >= 2 else 0):, s] = np.where(
                    (s == last) | (s == last - 1), np.float32(0), NEG)
            else:
                out[self.steps + 1:, s] = c["rows"][self.steps & 1,
                                                    c["q"][own]]
        assert not np.isnan(out).any()
        return out


def cluster_lattices(em, in_lens, out_lens, ctas=CLUSTER_MAX, ring=True,
                     seed=0):
    alpha = np.stack([ClusterChain(e, ctas, False, i, o, ring, seed + b).run()
                      for b, (e, i, o) in enumerate(zip(em, in_lens,
                                                        out_lens))])
    beta = np.stack([ClusterChain(e, ctas, True, i, o, ring,
                                  seed + 100 + b).run()
                     for b, (e, i, o) in enumerate(zip(em, in_lens,
                                                       out_lens))])
    return alpha, beta


CLUSTER_CASES = {
    # S = 1025, 1281 (the long step's 640 tokens) and 2049 on 8 CTAs (tiles
    # of 129, 161 and 257 states: every tile edge and its neighbours),
    # every state of the axis (the dead ones past 2·in_len + 1 included),
    # ragged lengths with reachable ends, out_len < in_len, 0, 1 and 2,
    # and more handoffs than the halo ring's kHalo slots
    "1025": (5, 90, 512, [512, 20, 7, 30], [90, 37, 10, 2]),
    "1281": (6, 100, 640, [640, 1, 25, 50], [100, 0, 1, 73]),
    "2049": (7, 81, 1024, [1024, 30, 15], [81, 80, 9]),
}


@pytest.mark.parametrize("name", sorted(CLUSTER_CASES))
def test_wide_model_matches_the_plain_versions_and_the_jax_scan(name):
    """The cluster kernel's alpha and beta as the plain versions compute
    them (through the ghost states' handoffs in a random pipelined order and
    the em ring), its -logL as ``_ctc_nll_scan`` (the sentinel's scale
    where the end is unreachable), and every em cell of a CTA's own states
    that the chains use read once (a ghost reads its upstream state's em
    again)."""
    seed, T_m, T_s, il, ol = CLUSTER_CASES[name]
    em, il, ol = case(seed, T_m, T_s, il, ol)
    alpha, beta = cluster_lattices(em, il, ol)
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
        chain = ClusterChain(em[b], CLUSTER_MAX, False, il[b], o)
        chain.run()
        tile = chain.tile
        want = np.zeros_like(chain.reads)
        want[0, :2] = 1
        want[1:max(int(o), 1)] = 1
        # ghosts: the kGhost states left of each tile but the first, again
        ghosts = np.concatenate([np.arange(r * tile - GHOST, r * tile)
                                 for r in range(1, CLUSTER_MAX)])
        want[1:max(int(o), 1), ghosts] += 1
        assert np.array_equal(chain.reads, want)


@pytest.mark.parametrize("ctas,seed", [(2, 0), (3, 1), (5, 2), (7, 3),
                                       (8, 4), (8, 5)])
def test_cluster_model_at_each_size_and_handoff(ctas, seed):
    """S = 1025 and 1281 over 2 to 8 CTAs (tiles of 513 down to 129
    states; the last tile shorter), the CTAs in random orders: the plain
    versions' alpha and beta."""
    for case_seed, T_m, T_s, il, ol in (CLUSTER_CASES["1025"],
                                        CLUSTER_CASES["1281"]):
        em, il, ol = case(case_seed, T_m, T_s, il, ol)
        alpha, beta = cluster_lattices(em, il, ol, ctas, seed=seed)
        t_em = torch.from_numpy(em.copy())
        assert lattice_err(alpha, t_fs.ctc_alpha_plain(
            t_em, torch.from_numpy(ol)).numpy()) <= TOL_LATTICE
        assert lattice_err(beta, t_fs.ctc_beta_plain(
            t_em, torch.from_numpy(il), torch.from_numpy(ol)).numpy()) \
            <= TOL_LATTICE


def test_wide_model_past_the_read_ahead_matches_the_plain_versions():
    """S = 8193 over 8 CTAs: tiles of 1025 states and 16 ghosts, two cells
    a thread, with the em ring and with em read on the chain (the instance
    past the ring's shared memory), over 20 frames (two handoffs): the
    plain versions' alpha and beta, every em cell of the beta chain read
    once, the ghosts' once more."""
    em, il, ol = case(8, 20, 4096, [4096, 2], [20, 19])
    assert cluster_shape(8193) == (1025, 544, 2)
    t_em = torch.from_numpy(em.copy())
    for ring in (True, False):
        alpha, beta = cluster_lattices(em, il, ol, ring=ring)
        assert lattice_err(alpha, t_fs.ctc_alpha_plain(
            t_em, torch.from_numpy(ol)).numpy()) <= TOL_LATTICE
        assert lattice_err(beta, t_fs.ctc_beta_plain(
            t_em, torch.from_numpy(il), torch.from_numpy(ol)).numpy()) \
            <= TOL_LATTICE
    chain = ClusterChain(em[0], CLUSTER_MAX, True, il[0], ol[0])
    chain.run()
    want = np.ones_like(chain.reads)
    for r in range(CLUSTER_MAX - 1):       # beta's ghosts: right of a tile
        want[:, (r + 1) * 1025:(r + 1) * 1025 + GHOST] += 1
    assert np.array_equal(chain.reads, want)


def test_wide_gradient_matches_jax_grad():
    """The elementwise gradient from the cluster lattices at S = 1025
    against ``jax.grad`` of ``_ctc_nll_scan`` where both ends are
    reachable, as the CPU route is held."""
    seed, T_m, T_s, il, ol = CLUSTER_CASES["1025"]
    em, il, ol = case(seed, T_m, T_s, il[1:3], ol[1:3])
    g = np.asarray([0.7, 1.3], np.float32)
    want = np.asarray(jax.grad(lambda e: jnp.sum(j_fs._ctc_nll_scan(
        e, jnp.asarray(il), jnp.asarray(ol)) * g))(jnp.asarray(em)))
    alpha, beta = cluster_lattices(em, il, ol)
    np.testing.assert_allclose(gradient(alpha, beta, log_l(alpha, il), g, ol),
                               want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def route(S):
    """The kernel of forward_sum.cu that a lattice of S states launches,
    as ``ctts_ctc_route`` picks it: (name, CTAs a chain, threads a CTA,
    states a thread, where the two rows of a CTA live)."""
    if S <= CLUSTER_FROM:
        return ("lattice" if threads(S) <= 512 else "lattice_1024", 1,
                threads(S), 1, "shared")
    tile, n, k = cluster_shape(S)
    if cluster_bytes(tile, True, True) <= MAX_SHARED:
        return "lattice_cluster", CLUSTER_MAX, n, k, "shared"
    return ("lattice_cluster_no_ring", CLUSTER_MAX, n, k,
            "shared" if cluster_bytes(tile, True, False) <= MAX_SHARED
            else "global")


@pytest.mark.parametrize("S", [1, 257, 513, 639, 641, 1023, 1024, 1025, 1281,
                               2049, 4097, 8191, 8193, 29056, 29057, 29201,
                               46223, 46225, 65537, 231647, 231649])
def test_the_wrapper_routes_each_width_to_its_instance(S):
    """:func:`route`, the launch's choice as a plain function, against the
    launch in the source: one state a thread up to 640 (the 512-thread
    instance first), the cluster kernel past it on kClusterMax CTAs, each
    cell (a state or a ghost) owned once by a thread of at most 1024, the
    em ring while it and the rows fit a CTA, then em on the chain with the
    rows in shared memory while they fit, else in the scratch; the last
    tile holds the kGhost edge states a handoff needs. The wrapper counts a
    launch by the source's own route (ctts_ctc_route)."""
    name, ctas, n, k, where = route(S)
    if S <= CLUSTER_FROM:
        assert (ctas, k, where) == (1, 1, "shared")
        assert n == -(-S // WARP) * WARP
        assert name == ("lattice" if n <= 512 else "lattice_1024")
        return
    tile = -(-S // ctas)
    assert ctas == CLUSTER_MAX and (tile, n, k) == cluster_shape(S)
    assert n % WARP == 0 and n <= MAX_S and S - (ctas - 1) * tile >= GHOST
    cells = GHOST + tile
    owner = (np.arange(n)[:, None] + np.arange(k)[None] * n)
    assert np.array_equal(np.sort(owner[owner < cells]), np.arange(cells))
    assert (owner < cells).sum(1).min() >= k - 1       # no idle thread rows
    # the cells that read a ghost (q < kGhost + 2) are warp 0's, k = 0
    assert n >= WARP >= GHOST + 2
    ring = cluster_bytes(tile, True, True) <= MAX_SHARED
    assert name == ("lattice_cluster" if ring else "lattice_cluster_no_ring")
    assert where == ("shared" if cluster_bytes(tile, True, False)
                     <= MAX_SHARED else "global")
    assert (S <= 46223) == ring and (S <= 231647) == (where == "shared")


def test_wide_model_mirrors_the_kernel_source():
    src = CU.read_text()
    for name, want in (("kMaxThreads", MAX_S), ("kMaxShared", MAX_SHARED),
                       ("kClusterFrom", CLUSTER_FROM),
                       ("kClusterMax", CLUSTER_MAX), ("kEmRing", EM_RING),
                       ("kSpan", SPAN), ("kHalo", HALO)):
        m = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    assert "constexpr int kGhost = 2 * kSpan;" in src
    assert "ctc_lattice_kernel_wide" not in src
    for line in (
            # tiles, threads, layout
            "int cluster_tile(int n_s, int c) { return (n_s + c - 1) / c; }",
            "const int cells = kGhost + tile;",
            "const int k = (cells + kMaxThreads - 1) / kMaxThreads;",
            "return ((cells + k - 1) / k + 31) / 32 * 32;",
            "l.rows_off = 2 * kHalo * 8 + (kGhost + 1) * kHalo * 4;",
            "l.ring_off = l.rows_off + (rows_shared ? 2 * (kGhost + tile) * 4 "
            ": 0);",
            "l.bytes = l.ring_off + (ring ? kEmRing * (kGhost + tile) * 4 : 0);",
            "return cluster_ring(cluster_tile(n_s, kClusterMax)) ? 2 : 3;",
            "if (n_s <= kClusterFrom) return (n_s + 31) / 32 * 32 <= 512 ? 0 : 1;",
            "return n_s <= kClusterFrom ? 0 : kClusterMax;",
            "if (n_s - (ctas - 1) * tile < kGhost) return cudaErrorInvalidValue;",
            # cells along the chain, the ghosts, the handoffs
            "const int steps = BETA ? (olen >= 2 ? olen - 1 : 0) : "
            "max(olen, 1) - 1;",
            "const int n_hand = steps > 0 ? (steps - 1) / kSpan : 0;",
            "const int q0 = receives ? 0 : kGhost;",
            "return BETA ? lo + nt - 1 - (q - kGhost) : lo + q - kGhost;",
            "for (int q = tid; q < kGhost; q += n) rows[q] = rows[w + q] = kNeg;",
            "const int j0 = (j - 1) / kSpan * kSpan;",
            "if (receives && j0 > 0 && j == j0 + 1 && tid < 32) {",
            "const int u = j0 / kSpan - 1, slot = u % kHalo;",
            "bar_wait(&full[slot], (u / kHalo) & 1);",
            "prev[tid] = halo[slot * kGhost + tid];",
            "bar_arm(&full[slot], kGhost * 4);",
            "if (u + kHalo < n_hand)",
            "peer_store_tx(peer(&ack[slot], from), prev[0],",
            "const int q_lo = receives ? 2 * (j - j0) : kGhost;",
            "const bool hand = sends && j % kSpan == 0 && j < steps;",
            "if (q < q_lo) continue;",
            "bar_wait(&empty[slot], ((u / kHalo) - 1) & 1);",
            "if (q == nq - 1) bar_arm(&empty[slot], 4);",
            "peer_store_tx(peer(&halo[slot * kGhost + q - nt], to), v,",
            # the recursion
            "const bool two = BETA ? (s & 1) : ((s & 1) && s >= 3);",
            "const float x = lse3(prev[q], prev[q - 1], two ? prev[q - 2] "
            ": kNeg);",
            "v = e + x;",
            "v = x + e;",
            "if (q >= kGhost) ot[s] = v;",
            "cur[q] = v;",
            # the em ring
            "cp_async4(ring + (j % kEmRing) * w + q,",
            "for (int j = 1; j < kEmRing; ++j) stage(j);",
            "if (RING) cp_wait<kEmRing - 2>();",
            "const float e = RING ? ring[(j % kEmRing) * w + q] : et[s];",
            "if (RING) stage(j + kEmRing - 1);",
            # frozen and final rows
            "for (int t = olen >= 2 ? olen - 1 : 0; t < t_m; ++t)",
            "const float a = rows[(steps & 1) * w + q];",
            "for (int t = steps + 1; t < t_m; ++t)",
            # residency is checked, never a smaller cluster
            "cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);",
            "if (resident < 1) return cudaErrorInvalidConfiguration;"):
        assert line in src, line
