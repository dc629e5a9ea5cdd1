"""The plan and the walk of the row scatter (ctts_torch/csrc/scatter_rows.cu),
modelled in numpy and held to the JAX package on the CPU.

The kernel is two launches. The plan, one block per group, counts the
sources of every output row, scans the counts into row starts and lists the
sources row by row in ascending m: kPlanWarps*32 indices at a time, equal
indices ranked inside a warp, the warps taking their row cursors in turn.
The walk gives a block a run of output rows, cuts the block's sources (one
contiguous run of the list) into kWalkWarps equal parts, and lets each warp
add its part in list order in float32: a row wholly inside a part is
written by its warp, and the parts of a row cut by a part's edge are added
in warp order. The model repeats those loops, including the segment split
of a long row, and reads the constants it models from the CUDA source, so
a change there fails here until the model follows; the card tests
(tests/test_torch_gpu.py) hold the kernel itself. The model adds in the
kernel's order in float32, so it gives the kernel's bits.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.ops import sort_gather as jsg
from ctts_torch.ops import sort_gather

CU = (pathlib.Path(__file__).resolve().parents[1] / "ctts_torch" / "csrc"
      / "scatter_rows.cu")
TOL = 1e-5       # of the largest sum: float32 adds in another order than XLA's

# the geometry the model shares with the kernel;
# test_model_mirrors_the_kernel_source holds each to CU
PLAN_WARPS = 16      # kPlanWarps
KEY_WINDOW = 8192    # kKeyWindow
WALK_WARPS = 16      # kWalkWarps
COLS = 8             # kCols: a walk block's columns are 32 * COLS
AHEAD = 4            # kAhead


def plan(idx, n_out, window=KEY_WINDOW):
    """The plan of one group: (starts [n_out + 1], src [starts[-1]]).
    Rows are counted ``window`` at a time; in each window the indices go
    PLAN_WARPS*32 at a time, warp after warp, and the lanes of a warp with
    one row take consecutive places from that row's cursor, lowest lane
    first. Out-of-range indices are in no window."""
    M = len(idx)
    starts = np.zeros(n_out + 1, np.int64)
    src = np.full(M, -1, np.int64)
    placed = 0
    for k0 in range(0, n_out, window):
        nk = min(window, n_out - k0)
        key = idx.astype(np.int64) - k0
        inwin = (key >= 0) & (key < nk)
        counts = np.bincount(key[inwin], minlength=nk)
        cursor = np.concatenate([[0], np.cumsum(counts)[:-1]])
        starts[k0:k0 + nk] = placed + cursor
        for w0 in range(0, M, 32):          # the warps of every chunk, in turn
            lanes = [m for m in range(w0, min(w0 + 32, M)) if inwin[m]]
            taken = {}
            for m in lanes:                 # rank among the warp's equal keys
                rank = taken.get(key[m], 0)
                taken[key[m]] = rank + 1
                src[placed + cursor[key[m]] + rank] = m
            for k, n in taken.items():      # the leaders move the cursors
                cursor[k] += n
        placed += int(counts.sum())
    starts[n_out] = placed
    assert (src[:placed] >= 0).all() and (src[placed:] == -1).all()
    return starts, src[:placed]


def _row_of(starts, n0, n1, p):
    """The last row r in [n0, n1) with starts[r] <= p."""
    return n0 + int(np.searchsorted(starts[n0:n1], p, side="right")) - 1


def walk(values, starts, src, n_out, rows_per_block, trace=None):
    """The walk of one group: values [M, F] float32 → [n_out, F] float32,
    with the kernel's parts, orders and float32 adds. Every row is written
    exactly once (asserted). ``trace``, a dict, gets for every row cut by a
    part's edge the warps that added to it, in order."""
    F = values.shape[1]
    out = np.full((n_out, F), np.nan, np.float32)
    writes = np.zeros(n_out, np.int64)

    def write(r, acc):
        out[r] = acc
        writes[r] += 1

    for n0 in range(0, n_out, rows_per_block):
        n1 = min(n0 + rows_per_block, n_out)
        a, length = starts[n0], starts[n1] - starts[n0]
        begin = [a + length * w // WALK_WARPS for w in range(WALK_WARPS + 1)]
        for r in range(n0, n1):
            if starts[r + 1] == starts[r]:
                write(r, np.zeros(F, np.float32))
        part, first = {}, {}
        for w in range(WALK_WARPS):
            pb, pe = begin[w], begin[w + 1]
            if pb == pe:
                continue
            r = first[w] = _row_of(starts, n0, n1, pb)
            slot, p = 0, pb
            while p < pe:
                while starts[r + 1] <= p:
                    r += 1
                rs, re = starts[r], starts[r + 1]
                q = min(re, pe)
                acc = np.zeros(F, np.float32)
                for s in src[p:q]:          # kAhead loads ahead, adds in order
                    acc = acc + values[s]
                p = q
                if rs >= pb and re <= pe:
                    write(r, acc)
                else:
                    part[w, slot] = acc
                slot = 1
        for w in range(WALK_WARPS):         # after the block's barrier
            pb, pe = begin[w], begin[w + 1]
            if pb == pe:
                continue
            r = _row_of(starts, n0, n1, pe - 1)
            rs, re = starts[r], starts[r + 1]
            if re > pe and rs >= pb:
                acc = part[w, 0 if r == first[w] else 1].copy()
                used = [w]
                w2 = w + 1
                while w2 < WALK_WARPS and begin[w2] < re:
                    if begin[w2] != begin[w2 + 1]:
                        acc = acc + part[w2, 0]
                        used.append(w2)
                    w2 += 1
                write(r, acc)
                if trace is not None:
                    trace[r] = used
    assert (writes == 1).all(), np.nonzero(writes != 1)
    return out


def scatter_model(values, idx, n_out):
    """The kernel on [G, M, F] float32 values: plan and walk per group,
    with the wrapper's rows per block."""
    G, M, F = values.shape
    rpb = sort_gather.walk_rows_per_block(M, n_out)
    out = np.zeros((G, n_out, F), np.float32)
    for g in range(G):
        starts, src = plan(idx[g], n_out)
        out[g] = walk(values[g], starts, src, n_out, rpb)
    return out


def _cu_int(name):
    m = re.search(rf"constexpr (?:int|unsigned) {name} = (\w+);",
                  CU.read_text())
    assert m, name
    return int(m.group(1), 0)


def test_model_mirrors_the_kernel_source():
    assert _cu_int("kPlanWarps") == PLAN_WARPS
    assert _cu_int("kKeyWindow") == KEY_WINDOW
    assert _cu_int("kWalkWarps") == WALK_WARPS == sort_gather.WALK_WARPS
    assert _cu_int("kCols") == COLS
    assert _cu_int("kAhead") == AHEAD
    text = CU.read_text()
    # one barrier per warp's turn at the cursors, the ranks by match_any
    assert "for (int w = 0; w < kPlanWarps; ++w) {" in text
    assert "__match_any_sync" in text
    # parts of a block's sources by integer division, as begin() here
    assert "static_cast<long long>(len) * w / kWalkWarps" in text


def mel2ph(rng, G, M, n_src, pad):
    """Length-regulator maps: a non-decreasing 1-based token per frame over
    M − pad frames, 0 (row 0) at the padded frames."""
    idx = np.zeros((G, M), np.int32)
    for g in range(G):
        frames = M - pad[g]
        cuts = np.sort(rng.choice(np.arange(1, frames), n_src - 2,
                                  replace=False))
        idx[g, :frames] = np.searchsorted(cuts, np.arange(frames),
                                          side="right") + 1
    return idx


def _case(kind, rng):
    """(idx [G, M], n_out) of each kind of index the callers give."""
    if kind == "sorted":                 # the length regulator, row 0 heavy
        G, M, n_out = 2, 896, 129
        return mel2ph(rng, G, M, n_out, [720, 101]), n_out
    if kind == "permutation":            # the reformer's un-sort
        G, M = 2, 1152
        return np.stack([rng.permutation(M) for _ in range(G)]).astype(
            np.int32), M
    if kind == "repeat":                 # the LSH chunk backward: 4 a row
        G, N = 2, 288
        return np.stack([rng.permutation(4 * N) % N for _ in range(G)]
                        ).astype(np.int32), N
    if kind == "out_of_range":
        G, M, n_out = 2, 300, 37
        idx = rng.randint(0, n_out, (G, M)).astype(np.int32)
        idx[:, ::7] = rng.choice([-5, -1, n_out, n_out + 9], idx[:, ::7].shape)
        return idx, n_out
    G, M, n_out = 2, 500, 61             # random
    return rng.randint(0, n_out, (G, M)).astype(np.int32), n_out


KINDS = ["sorted", "permutation", "repeat", "out_of_range", "random"]


@pytest.mark.parametrize("kind", KINDS)
def test_plan_is_a_stable_counting_sort(kind):
    """The starts are the exclusive scan of the row counts, the list holds
    every in-range source once, by row, in ascending m; counting the rows
    in small windows gives the same plan."""
    idx, n_out = _case(kind, np.random.RandomState(len(kind)))
    for row in idx:
        starts, src = plan(row, n_out)
        inside = (row >= 0) & (row < n_out)
        counts = np.bincount(row[inside], minlength=n_out)
        np.testing.assert_array_equal(starts, np.concatenate(
            [[0], np.cumsum(counts)]))
        want = np.nonzero(inside)[0][np.argsort(row[inside], kind="stable")]
        np.testing.assert_array_equal(src, want)
        s7, src7 = plan(row, n_out, window=7)
        np.testing.assert_array_equal(s7, starts)
        np.testing.assert_array_equal(src7, src)


@pytest.mark.parametrize("kind", KINDS)
def test_walk_matches_jax_scatter(kind):
    """The model's sums against ctts_tpu's scatter_rows (its .at[].add
    path on the CPU) and the port's plain version: a permutation exactly,
    the others within TOL of the largest sum. An index outside [0, n_out)
    adds nothing (JAX wraps a negative index, so it gets n_out there)."""
    rng = np.random.RandomState(10 + len(kind))
    idx, n_out = _case(kind, rng)
    G, M = idx.shape
    F = 5
    vals = rng.randn(G, M, F).astype(np.float32)
    got = scatter_model(vals, idx, n_out)
    jidx = np.where(idx < 0, n_out, idx).astype(np.int32)
    want = np.asarray(jsg.scatter_rows(jnp.asarray(vals), jnp.asarray(jidx),
                                       n_out))
    plain = sort_gather.scatter_rows_plain(
        torch.from_numpy(vals), torch.from_numpy(idx), n_out).numpy()
    if kind == "permutation":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)
        np.testing.assert_allclose(got, plain, atol=TOL * scale, rtol=0)


def test_long_row_is_spread_over_the_warps():
    """Row 0 of a length-regulator map with 720 padded frames: its block's
    sources are cut into WALK_WARPS parts and every warp adds to it, the
    parts combined in warp order; the sum equals the straight float32 sum
    within TOL, and bfloat16 values are summed in float32 (one rounding at
    the write)."""
    rng = np.random.RandomState(3)
    idx = mel2ph(rng, 1, 896, 129, [720])[0]
    starts, src = plan(idx, 129)
    assert starts[1] - starts[0] >= 720
    vals = rng.randn(896, 8).astype(np.float32)
    rpb = sort_gather.walk_rows_per_block(896, 129)
    trace = {}
    got = walk(vals, starts, src, 129, rpb, trace)
    assert trace[0] == list(range(WALK_WARPS))
    straight = vals[src[starts[0]:starts[1]]].sum(0, dtype=np.float64)
    np.testing.assert_allclose(got[0], straight,
                               atol=TOL * np.abs(straight).max(), rtol=0)
    ones = np.ones((896, 1), np.float32)      # a bf16 running sum stalls at 256
    assert walk(ones, starts, src, 129, rpb)[0, 0] == starts[1] - starts[0]


@pytest.mark.parametrize("M,n_out,rows", [(896, 129, 5), (3584, 3584, 32),
                                          (3584, 896, 8), (4608, 4608, 32),
                                          (50, 7, 4), (0, 9, 9)])
def test_rows_per_block(M, n_out, rows):
    """A walk block takes about WALK_WARPS * 2 sources at the mean
    M / n_out a row: the train step's length regulator (5 rows), the
    un-sort (32), the chunk backward's sum (8)."""
    assert sort_gather.walk_rows_per_block(M, n_out) == rows
