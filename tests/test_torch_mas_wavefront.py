"""The MAS kernel's schedule (ctts_torch/csrc/mas.cu), modelled in numpy
and held to the plain version and to the JAX package on the CPU.

One warp carries an utterance's chain: lane L owns K adjacent columns and
runs kSkew steps behind lane L-1, so at step s it works on frame
s - kSkew*L, and its lowest column's left neighbour comes by shuffle from
lane L-1, kSkew steps after lane L-1 computed it. The warp reads one step
row of a ring a step; the rows are written by the chain block's filler
warps (the first kFillChunks chunks) and by the log blocks (the others),
each cell once, from the probabilities' logarithm. Lane L keeps its move
bits as one word a column for each 32 steps (bit s % 32 of word s / 32)
and clears the bits at or below its frame 0. The backtrack walks by column:
a run is one masked word, and one more word for each 32 frames it spans
below that. The output is zeroed once and gets one 1.0 a frame below
mel_len. The model repeats that geometry and arithmetic, with
cells nobody writes poisoned with NaN; it reads the constants it models
from the CUDA source, so a change there fails here until the model follows.
The card tests (tests/test_torch_gpu.py) hold the kernel itself.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.ops import mas as j_mas
from ctts_torch.ops import mas as t_mas

CU = (pathlib.Path(__file__).resolve().parents[1] / "ctts_torch" / "csrc"
      / "mas.cu")

# what the model shares with the kernel; test_model_mirrors_the_kernel_source
# holds each piece against CU
NEG = np.float32(-1e30)    # kNeg
WARP = 32                  # lanes of the chain warp, bits a word (kWarp)
SKEW = 2                   # kSkew
FILL_CHUNKS = 4            # kFillChunks
EPS = 1e-12
MAX_SHARED = 232448        # kMaxShared, bytes a block may use on sm_90
# cols_per_lane: (largest T_s, K); past the last, K = 32
K_RULE = ((32, 1), (64, 2), (96, 3), (128, 4), (192, 6), (256, 8), (384, 12),
          (512, 16), (768, 24))


def cols_per_lane(T_s):
    return next((k for top, k in K_RULE if T_s <= top), 32)


def chunk_steps(K):
    return 32 if K <= 2 else 16 if K <= 4 else 8 if K <= 8 else 4 if K <= 16 else 2


def ring_chunks(K):
    return 8 if K <= 8 else 4


def shared_bytes(T_m, K):
    """mas.cu's layout(): mbarriers, run starts, the ring, the move words."""
    cols = WARP * K
    chain_rows = -(-(T_m + SKEW * (WARP - 1)) // WARP) * WARP
    return (2 * 8 * 8 + (cols + 4) * 4 + ring_chunks(K) * chunk_steps(K)
            * cols * 4 + chain_rows // WARP * cols * 4)


def n_chunks_of(K, text_len, mel_len):
    if mel_len <= 0 or text_len <= 1:
        return 0
    steps = mel_len + SKEW * (-(-text_len // K) - 1)
    return -(-steps // WARP) * (WARP // chunk_steps(K))


def first_blocks():
    return SKEW * (WARP - 1) // WARP + 1


def ring_rows(la, K, text_len, mel_len, writes=None):
    """The step rows the chain reads, [n_chunks * C, 32K] float32: cell
    (row r of chunk q, column c) holds la[q*C + r - kSkew*(c//K), c] where
    that frame is in [0, mel_len) and c < text_len; every other cell is
    never written and holds NaN. `writes` counts each cell's writers."""
    C, cols = chunk_steps(K), WARP * K
    n_chunks = n_chunks_of(K, text_len, mel_len)
    rows = np.full((n_chunks * C, cols), np.nan, np.float32)
    r, c = np.meshgrid(np.arange(C), np.arange(cols), indexing="ij")
    for q in range(n_chunks):          # fillers (q < kFillChunks), log blocks
        f = q * C + r - SKEW * (c // K)
        live = (c < text_len) & (f >= 0) & (f < mel_len)
        rows[q * C + r[live], c[live]] = la[f[live], c[live]]
        if writes is not None:
            np.add.at(writes, (q * C + r[live], c[live]), 1)
    return rows


def chain(rows, K):
    """The chain warp over the ring: returns the move words [n_blk, 32K]
    (uint32)."""
    lanes = np.arange(WARP)
    n_blk = rows.shape[0] // WARP
    lp = np.full((WARP, K), NEG, np.float32)
    lefts = [np.full(WARP, NEG, np.float32) for _ in range(SKEW)]
    bits = np.zeros((n_blk, WARP * K), np.uint32)
    col = lanes[:, None] * K + np.arange(K)[None, :]
    with np.errstate(invalid="ignore", over="ignore"):
        for blk in range(n_blk):
            acc = np.zeros((WARP, K), np.uint32)
            for u in range(WARP):
                s = blk * WARP + u
                la = rows[s].reshape(WARP, K)
                # shfl_up of the previous step's highest column
                nxt = np.concatenate([lp[:1, K - 1], lp[:-1, K - 1]])
                sh = lefts[0]
                new = np.empty_like(lp)
                for k in range(K):
                    here = lp[:, k]
                    move = sh >= here                      # tie -> diagonal
                    acc[:, k] |= move.astype(np.uint32) << np.uint32(u)
                    new[:, k] = la[:, k] + np.where(move, sh, here)
                    sh = here
                lp = new
                first = SKEW * lanes == s                  # frame 0
                lp[first] = np.where(col == 0, la, NEG)[first]
                lefts = lefts[1:] + [np.where(lanes == 0, NEG, nxt)]
            if blk < first_blocks():
                g = SKEW * lanes - blk * WARP
                keep = np.where(g < 0, 0xffffffff, np.where(
                    g >= 31, 0, ~((2 << np.clip(g, 0, 30)) - 1) & 0xffffffff))
                acc &= keep.astype(np.uint32)[:, None]
            bits[blk] = acc.reshape(-1)
    return bits


def backtrack(bits, K, text_len, mel_len):
    """The kernel's walk by column: {column: first frame of its run} and
    the column the path holds at frame 0."""
    start = {}
    c = max(text_len - 1, 0)
    if c > 0 and mel_len > 1:
        L = SKEW * (c // K)
        bit = mel_len - 1 + L
        while True:
            w = bit >> 5
            m = int(bits[w, c]) & (0xffffffff >> (31 - (bit & 31)))
            while m == 0 and w > 0:        # one word for each 32 frames
                w -= 1
                m = int(bits[w, c])
            fb = w * 32 + m.bit_length() - 1 if m else -1
            f = fb - L
            if fb < 0 or c == 1 or f <= 1:
                if fb >= 0:
                    start[c] = f
                    c -= 1
                break
            start[c] = f
            c -= 1
            Ln = SKEW * (c // K)
            bit = fb - 1 - (L - Ln)
            L = Ln
    start[c] = 0
    return start, c


def model(attn, in_lens, out_lens, counts=None):
    """The kernel's result, [B, T_m, T_s] float32, built as the kernel
    builds it; `counts` collects each output element's zero writes and one
    writes."""
    B, T_m, T_s = attn.shape
    K = cols_per_lane(T_s)
    la = torch.log(torch.clamp(torch.from_numpy(attn), min=EPS)).numpy()
    out = np.full((B, T_m, T_s), np.nan, np.float32)
    for b in range(B):
        text_len = min(max(int(in_lens[b]), 0), T_s)
        mel_len = min(max(int(out_lens[b]), 0), T_m)
        # the log blocks' zeroing: thread tid writes float4 words (floats
        # where the slab is not a multiple of 4) tid, tid + threads, ...
        width = 4 if (T_m * T_s) % 4 == 0 else 1
        n = T_m * T_s // width
        threads = 512 if K < 24 else 256
        zeros = np.zeros(n, np.int64)
        for tid in range(min(threads, n)):
            zeros[tid::threads] += 1
        zeros = np.repeat(zeros, width)
        out[b].reshape(-1)[zeros > 0] = 0.0
        if n_chunks_of(K, text_len, mel_len):
            rows = ring_rows(la[b], K, text_len, mel_len)
            bits = chain(rows, K)
            start, c0 = backtrack(bits, K, text_len, mel_len)
        else:
            start, c0 = {0: 0}, 0
        c1 = max(text_len - 1, 0)
        ones = np.zeros((T_m, T_s), np.int64)
        for f in range(mel_len):                 # the last run starting <= f
            lo, hi = c0, c1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if start[mid] <= f else (lo, mid - 1)
            out[b, f, lo] = 1.0
            ones[f, lo] += 1
        if counts is not None:
            counts.append((zeros.reshape(T_m, T_s), ones, mel_len))
    return out


def case(seed, B, T_m, T_s, in_lens, out_lens, ties=False):
    rng = np.random.RandomState(seed)
    attn = rng.rand(B, T_m, T_s).astype(np.float32) ** 4 + 1e-9
    attn /= attn.sum(-1, keepdims=True)
    if ties:
        attn[:] = np.float32(1.0 / T_s)
    return (attn, np.asarray(in_lens, np.int32),
            np.asarray(out_lens, np.int32))


def plain(attn, in_lens, out_lens):
    return t_mas.b_mas_plain(torch.from_numpy(attn), torch.from_numpy(in_lens),
                             torch.from_numpy(out_lens)).numpy()


@pytest.mark.parametrize("T_s", [1, 5, 31, 32, 33, 128, 129, 300])
def test_model_equals_plain_bit_for_bit(T_s):
    """Every T_m of {1, 2, 33, 200}, with full, ragged, short and empty
    lengths: the schedule's result is the plain version's, and no cell the
    chain reads was left unwritten (an unwritten cell holds NaN)."""
    for T_m in (1, 2, 33, 200):
        in_lens = [T_s, max(T_s // 2, 1), max(T_s - 3, 0), 1]
        out_lens = [T_m, max(T_m // 2, 1), T_m, min(3, T_m)]
        attn, il, ol = case(T_s * 7 + T_m, 4, T_m, T_s, in_lens, out_lens)
        got = model(attn, il, ol)
        assert np.array_equal(got, plain(attn, il, ol)), (T_s, T_m)


@pytest.mark.parametrize("kind", ["lengths", "ties"])
def test_model_edge_cases(kind):
    """mel_len 0 and 1, text_len 0 and 1, out_len < in_len (the end is not
    reachable), lengths past the axes (clamped), and an all-ties input."""
    T_m, T_s = 40, 70
    in_lens = [0, 1, 70, 69, 60, 200, 35, 70]
    out_lens = [40, 40, 0, 1, 12, 40, 90, -3]
    attn, il, ol = case(11, 8, T_m, T_s, in_lens, out_lens,
                        ties=kind == "ties")
    assert np.array_equal(model(attn, il, ol), plain(attn, il, ol))


def test_model_equals_the_jax_scan():
    """At the train step's lane count (K = 4) and past it (K = 6)."""
    for B, T_m, T_s, seed in ((3, 90, 128, 1), (2, 60, 150, 2)):
        in_lens = [T_s, T_s - 17, 20][:B]
        out_lens = [T_m, T_m - 30, 25][:B]
        attn, il, ol = case(seed, B, T_m, T_s, in_lens, out_lens)
        want = np.asarray(j_mas.b_mas_scan(jnp.asarray(attn), jnp.asarray(il),
                                           jnp.asarray(ol)))
        assert np.array_equal(model(attn, il, ol), want)


def test_model_equals_the_pallas_pair_in_interpret_mode(monkeypatch):
    monkeypatch.setattr(j_mas, "_INTERPRET", True)
    attn, il, ol = case(5, 2, 20, 6, [6, 4], [20, 9])
    want = np.asarray(j_mas.b_mas_pallas(jnp.asarray(attn), jnp.asarray(il),
                                         jnp.asarray(ol)))
    assert np.array_equal(model(attn, il, ol), want)


def test_every_ring_cell_is_written_at_most_once_and_read_ones_exist():
    """Each cell the fillers and log blocks write has one writer, and the
    chain's valid reads (a lane's frame in [0, mel_len), a column below
    text_len) are exactly the written cells."""
    T_m, T_s, K = 50, 100, cols_per_lane(100)
    attn, il, ol = case(3, 1, T_m, T_s, [90], [50])
    la = np.log(np.maximum(attn[0], EPS))
    n_rows = n_chunks_of(K, 90, 50) * chunk_steps(K)
    writes = np.zeros((n_rows, WARP * K), np.int64)
    ring_rows(la, K, 90, 50, writes)
    assert writes.max() == 1
    s, c = np.meshgrid(np.arange(n_rows), np.arange(WARP * K), indexing="ij")
    f = s - SKEW * (c // K)
    assert np.array_equal(writes == 1, (c < 90) & (f >= 0) & (f < 50))


def test_every_output_element_is_written_exactly_once():
    """The zeroing covers each element once; each frame below mel_len gets
    exactly one 1.0 and no frame at or past it gets one."""
    counts = []
    attn, il, ol = case(9, 3, 33, 45, [45, 20, 0], [33, 10, 0])
    model(attn, il, ol, counts)
    for zeros, ones, mel_len in counts:
        assert (zeros == 1).all()
        assert (ones.sum(1)[:mel_len] == 1).all()
        assert not ones[mel_len:].any()
        assert ones.max() <= 1


def test_model_mirrors_the_kernel_source():
    """The sentinel, the warp and word size, the skew, the filled chunks,
    the K rule, the chunk and ring rules and the backtrack's word scan the
    model uses are the ones mas.cu compiles."""
    src = CU.read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert np.float32(const("kNeg").rstrip("f")) == NEG
    assert int(const("kWarp")) == WARP
    assert int(const("kSkew")) == SKEW
    assert int(const("kFillChunks")) == FILL_CHUNKS
    body = re.search(r"cols_per_lane\(int t_s\) \{(.*?)\}", src, re.S).group(1)
    pairs = [(int(a), int(b)) for a, b in re.findall(r"t_s <= (\d+) \? (\d+)",
                                                     body)]
    assert tuple(pairs) == K_RULE and body.strip().endswith(": 32;")
    body = re.search(r"chunk_steps\(int k\) \{(.*?)\}", src, re.S).group(1)
    assert [(int(a), int(b)) for a, b in re.findall(r"k <= (\d+) \? (\d+)",
                                                    body)] == [
        (2, 32), (4, 16), (8, 8), (16, 4)] and body.strip().endswith(": 2;")
    assert "return k <= 8 ? 8 : 4;" in src            # ring_chunks
    assert [chunk_steps(k) * ring_chunks(k) for k in (1, 4, 8, 16, 32)] == [
        256, 128, 64, 16, 8]
    # the chain's frame and the producers' source agree
    assert "*f = q * G::C + r - kSkew * (*c / K);" in src
    assert "blk * kWarp + u == kSkew * lane" in src
    assert "lp[k] = la[k] + (move ? sh : here);" in src
    # the wrapper reads the shapes' limits from the same source
    assert "return t_s <= 32 ? 1" in src
    assert "while (m == 0u && w > 0) m = bits[--w * cols + c];" in src


@pytest.mark.parametrize("T_s", [128, 512, 1024])
def test_a_path_as_long_as_the_text_fits_shared_memory(T_s):
    """The longest T_m a block holds is past T_s and past 1024 up to
    T_s = 1024, so any batch whose mel axis is at least its text axis
    (every monotonic path needs that) fits up to T_m = 1024; the layout is
    the one mas.cu computes."""
    K = cols_per_lane(T_s)
    T_m = 1
    while shared_bytes(T_m + 1, K) <= MAX_SHARED:
        T_m += 1
    assert T_m >= max(T_s, 1024), (T_s, T_m)
    src = CU.read_text()
    assert "l.ring_off = 2 * 8 * 8 + (cols + 4) * 4;" in src
    assert ("l.bits_off = l.ring_off + ring_chunks(k) * chunk_steps(k) * "
            "cols * 4;") in src
    assert "l.bytes = l.bits_off + words * cols * 4;" in src
    assert "const long long words = chain_rows(t_m) / kWarp;" in src
    assert f"kMaxShared = {MAX_SHARED};" in src
