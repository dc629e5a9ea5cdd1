"""CUDA kernels of ctts_torch against their plain PyTorch versions, on the
card. Marked ``gpu``; each test decides inside its body whether a card is
present and skips otherwise. This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

# bf16 attention, row by row: max|kernel - plain f32 on the same bf16
# inputs| of a query row over the row's largest |plain| (the kernel rounds P
# and the output to bf16; its numpy model in
# tests/test_torch_attention_tiles.py reaches 5.9e-3 on these cases, a wrong
# or stale K/V tile 0.28 and more)
ATTN_ROW_TOL_BF16 = 1e-2


def _row_err(got, ref):
    return ((got.float() - ref).abs().amax(-1)
            / ref.abs().amax(-1).clamp(min=1e-30)).max().item()


def _check_attention(got, ref, args, lens, scale, tol):
    """The absolute tolerance on every entry against ``ref``; in bf16 also
    the row tolerance against the plain version on the kernel's own inputs
    ``args``, which a fault confined to the long rows' small outputs cannot
    pass."""
    from ctts_torch.ops import attention
    assert (got.float() - ref).abs().max().item() <= tol
    if got.dtype == torch.bfloat16:
        same = attention.attention_plain(*(a.float() for a in args), lens,
                                         scale)
        assert _row_err(got, same) <= ATTN_ROW_TOL_BF16


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU run covers the plain "
                    "versions in tests/test_torch_kernels.py and "
                    "tests/test_torch_train_ops.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,d", [(96, 128), (1152, 128), (200, 64), (200, 256)])
def test_attention_kernel_matches_plain(T, d, dtype, tol):
    dev = _need_card()
    from ctts_torch.ops import attention
    rng = np.random.RandomState(T + d)
    N = 8
    q, k, v = (torch.from_numpy(rng.randn(N, T, d).astype(np.float32))
               for _ in range(3))
    lens = torch.tensor([T, T, T - 5, T // 2, 7, 1, 0, T // 3],
                        dtype=torch.int32)
    scale = d ** -0.5
    ref = attention.attention_plain(q.to(dev), k.to(dev), v.to(dev),
                                    lens.to(dev), scale)
    before = attention.launches
    args = [t.to(dev, dtype) for t in (q, k, v)]
    got = attention.fused_attention(*args, lens.to(dev), scale)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (N, T, d)
    _check_attention(got, ref, args, lens.to(dev), scale, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,M,F", [(4, 97, 1152, 256), (16, 129, 896, 256),
                                     (64, 896, 3584, 256), (2, 13, 50, 1),
                                     (3, 9, 17, 3), (2, 7, 33, 129)])
def test_gather_kernel_bit_exact(G, N, M, F, dtype):
    """The timed shapes (the probe's, the fs2 train step's upsample, the
    reformer default route's sorted gather) and rows of 1, 3 and 129
    elements, whose bytes are not a multiple of 16."""
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    rng = np.random.RandomState(G * N + F)
    vals = torch.from_numpy(rng.randn(G, N, F).astype(np.float32)).to(
        dev, dtype)
    idx = torch.from_numpy(rng.randint(0, N, (G, M)).astype(np.int32)).to(dev)
    before = sort_gather.launches
    got = sort_gather.gather_rows(vals, idx)
    torch.cuda.synchronize()
    assert sort_gather.launches == before + 1
    ref = sort_gather.gather_rows_plain(vals, idx)
    assert torch.equal(got, ref)


def test_gather_kernel_int64_rows_bit_exact():
    """The ph pitch path's gather: coarse bins (int64, one element a row,
    the 8-byte word path) from [B, T_s + 1] to the frames of mel2ph, at the
    train step's shape; bit-exact against the plain version, one launch,
    and no gradient asked for."""
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    from ctts_torch.ops.length_regulator import gather_by_mel2ph
    rng = np.random.RandomState(21)
    B, T_s, T_m = 16, 128, 896
    bins = torch.from_numpy(rng.randint(1, 256, (B, T_s))).to(dev)
    mel2ph = torch.from_numpy(np.sort(rng.randint(0, T_s + 1, (B, T_m)),
                                      axis=1).astype(np.int32)).to(dev)
    before = sort_gather.launches
    got = gather_by_mel2ph(bins, mel2ph)
    torch.cuda.synchronize()
    assert sort_gather.launches == before + 1
    assert got.dtype == torch.int64 and not got.requires_grad
    pad = torch.cat([bins.new_zeros(B, 1), bins], 1)[..., None]
    assert torch.equal(got, sort_gather.gather_rows_plain(pad, mel2ph)[..., 0])
    assert torch.equal(got.cpu(), gather_by_mel2ph(bins.cpu(), mel2ph.cpu()))


def test_gather_kernel_unaligned_pointers():
    """Views that start 4 and 2 bytes into their storage take the narrower
    words and are still exact."""
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    rng = np.random.RandomState(6)
    idx = torch.from_numpy(rng.randint(-1, 12, (2, 30)).astype(np.int32)).to(dev)
    for dtype, shift in ((torch.float32, 1), (torch.bfloat16, 1)):
        flat = torch.from_numpy(rng.randn(2 * 11 * 64 + shift).astype(
            np.float32)).to(dev, dtype)
        vals = flat[shift:].view(2, 11, 64)
        got = sort_gather.gather_rows(vals, idx)
        assert torch.equal(got, sort_gather.gather_rows_plain(vals, idx))


@pytest.mark.parametrize("G,M", [(2, 300_000), (1, 600_000)])
def test_gather_kernel_past_two_to_the_31_words(G, M):
    """Rows of 4001 bytes (one-byte words) and an output of 2.4 GB, past
    the 2^31 words one launch takes: cut into launches of whole groups, or
    of rows of the one group; exact, with zero rows for indices outside."""
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    N, F = 8, 4001
    gen = torch.Generator(device=dev).manual_seed(G)
    vals = torch.randint(0, 256, (G, N, F), dtype=torch.uint8, device=dev,
                         generator=gen)
    idx = torch.randint(-1, N + 1, (G, M), dtype=torch.int32, device=dev,
                        generator=gen)
    got = sort_gather.gather_rows(vals, idx)
    assert torch.equal(got, sort_gather.gather_rows_plain(vals, idx))


def test_gather_kernel_out_of_range_rows_are_zero():
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    rng = np.random.RandomState(5)
    G, N, M, F = 2, 16, 64, 8
    vals = torch.from_numpy(rng.randn(G, N, F).astype(np.float32)).to(dev)
    idx = rng.randint(0, N, (G, M)).astype(np.int32)
    idx[0, :4] = [-1, N, N + 3, -7]
    idx = torch.from_numpy(idx).to(dev)
    got = sort_gather.gather_rows(vals, idx)
    assert torch.equal(got, sort_gather.gather_rows_plain(vals, idx))
    assert not got[0, :4].any()


def test_wrappers_raise_on_untaken_cuda_input():
    dev = _need_card()
    from ctts_torch.ops import attention, sort_gather
    q = torch.zeros(2, 16, 264, device=dev)            # d=264: past 256
    with pytest.raises(ValueError, match="F1"):
        attention.fused_attention(q, q, q, torch.full((2,), 16, dtype=torch.int32,
                                                      device=dev))
    with pytest.raises(TypeError):
        sort_gather.gather_rows(q, torch.zeros(2, 4, dtype=torch.int64,
                                               device=dev))


# ---- the training kernels ---------------------------------------------------- #

def _ragged(rng, B, lo, hi):
    lens = rng.randint(lo, hi + 1, B).astype(np.int32)
    lens[0] = hi
    return lens


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("kind", ["sorted", "permutation", "random"])
@pytest.mark.parametrize("G,M,n_out,F", [(16, 896, 129, 256), (16, 896, 129, 1),
                                         (3, 50, 7, 300)])
def test_scatter_kernel_matches_plain(G, M, n_out, F, kind, dtype, rel):
    """float32: ≤ 1e-5 of the largest sum (another order of float32 adds);
    bfloat16: one rounding of the float32 sum on each side; a permutation
    is exact; two launches give the same bits."""
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    rng = np.random.RandomState(G + F)
    if kind == "permutation":
        n_out = M
        idx = np.stack([rng.permutation(M) for _ in range(G)])
    else:
        idx = rng.randint(0, n_out, (G, M))
        if kind == "sorted":
            idx = np.sort(idx, axis=1)
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.randn(G, M, F).astype(np.float32)).to(
        dev, dtype)
    before = sort_gather.scatter_launches
    got = sort_gather.scatter_rows(vals, idx, n_out)
    torch.cuda.synchronize()
    assert sort_gather.scatter_launches == before + 1
    ref = sort_gather.scatter_rows_plain(vals, idx, n_out)
    assert got.dtype == dtype and got.shape == (G, n_out, F)
    if kind == "permutation":
        assert torch.equal(got, ref)
    else:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= rel * ref.float().abs().max().item(), err
    assert torch.equal(got, sort_gather.scatter_rows(vals, idx, n_out))


def _scatter_caller_case(rng, where):
    """(idx [G, M], n_out, F) of the scatter's callers at their shapes."""
    if where == "unsort":              # the reformer's un-sort: a permutation
        G, M = 64, 3584
        return np.stack([rng.permutation(M) for _ in range(G)]), M, 129
    if where == "chunk_sum":           # the LSH chunk backward: 4 a row
        G, N = 64, 896
        return np.stack([rng.permutation(4 * N) % N for _ in range(G)]), N, 256
    G, M, n_src = 16, 896, 129         # the length regulator, row 0 heavy
    idx = np.zeros((G, M), np.int64)
    for g in range(G):
        frames = M - (700 if g == 0 else rng.randint(0, 397))
        cuts = np.sort(rng.choice(np.arange(1, frames), n_src - 2,
                                  replace=False))
        idx[g, :frames] = np.searchsorted(cuts, np.arange(frames),
                                          side="right") + 1
    return idx, n_src, 256


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("where", ["unsort", "chunk_sum", "length_regulator"])
def test_scatter_kernel_at_the_callers_shapes(where, dtype, rel):
    """The reformer's un-sort (a permutation, F=129: exact), the LSH chunk
    backward's sum (each row 4 times) and a length-regulator map with 700
    padded frames in row 0 (one row spread over a block's warps): within
    SCATTER_TOL of the plain version, and two runs give the same bits."""
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    rng = np.random.RandomState(len(where))
    idx, n_out, F = _scatter_caller_case(rng, where)
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.randn(*idx.shape, F).astype(np.float32)).to(
        dev, dtype)
    got = sort_gather.scatter_rows(vals, idx, n_out)
    again = sort_gather.scatter_rows(vals, idx, n_out)
    ref = sort_gather.scatter_rows_plain(vals, idx, n_out)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if where == "unsort":
        assert torch.equal(got, ref)
    else:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= rel * ref.float().abs().max().item(), err


def test_scatter_kernel_out_of_range_index_adds_nothing():
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    vals = torch.ones(2, 6, 5, device=dev)
    idx = torch.tensor([[0, -1, 4, 2, 2, 9]] * 2, dtype=torch.int32,
                       device=dev)
    got = sort_gather.scatter_rows(vals, idx, 4)
    assert torch.equal(got, sort_gather.scatter_rows_plain(vals, idx, 4))
    assert got[0, :, 0].tolist() == [1, 0, 2, 0]


def test_gather_and_scatter_kernels_are_each_others_backward():
    dev = _need_card()
    from ctts_torch.ops import sort_gather
    rng = np.random.RandomState(8)
    G, N, M, F = 4, 33, 200, 64
    idx = torch.from_numpy(np.sort(rng.randint(0, N, (G, M)), 1).astype(
        np.int32)).to(dev)
    vals = torch.from_numpy(rng.randn(G, N, F).astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.randn(G, M, F).astype(np.float32)).to(dev)
    v = vals.clone().requires_grad_(True)
    before = sort_gather.scatter_launches
    (sort_gather.gather_rows(v, idx) * cot).sum().backward()
    assert sort_gather.scatter_launches == before + 1
    w = vals.clone().requires_grad_(True)
    (sort_gather.gather_rows_plain(w, idx) * cot).sum().backward()
    assert (v.grad - w.grad).abs().max().item() <= 1e-5 * w.grad.abs().max().item()


def _mas_case(rng, B, T_m, T_s, kind):
    attn = rng.rand(B, T_m, T_s).astype(np.float32) ** 4 + 1e-9
    attn /= attn.sum(-1, keepdims=True)
    if kind == "ties":
        attn[:] = 1.0 / T_s
    in_lens = _ragged(rng, B, max(T_s // 2, 1), T_s)
    out_lens = _ragged(rng, B, max(T_m // 2, 1), T_m)
    if kind == "short":
        out_lens[1:] = np.maximum(in_lens[1:] // 3, 1)
    return attn, in_lens, out_lens


@pytest.mark.parametrize("kind", ["seeded", "ties", "short"])
@pytest.mark.parametrize("B,T_m,T_s", [(16, 896, 128), (3, 70, 45), (2, 33, 1),
                                       (3, 120, 33), (3, 120, 129),
                                       (2, 90, 257), (2, 70, 1024),
                                       (2, 1100, 1024)])
def test_mas_kernel_bit_exact(B, T_m, T_s, kind):
    """Equal bit for bit to ``b_mas_plain``: seeded inputs, an all-ties
    input (uniform attention) and utterances with out_len < in_len, at the
    train shape and at T_s = 1, 33, 129, 257 and 1024 (K = 1 to 32
    columns a lane; at 1024 also with paths of over 1024 frames), with one
    launch a call."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(B + T_s)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                               _mas_case(rng, B, T_m, T_s, kind))
    before = mas.launches
    got = mas.b_mas(attn, in_lens, out_lens)
    torch.cuda.synchronize()
    assert mas.launches == before + 1
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))
    assert not got.requires_grad


def test_mas_kernel_edge_lengths():
    """mel_len 0 and 1, text_len 0 and 1, lengths past the axes (clamped)
    and negative ones."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(8)
    attn, _, _ = _mas_case(rng, 8, 60, 40, "seeded")
    in_lens = np.array([0, 1, 40, 39, 25, 99, 40, -2], np.int32)
    out_lens = np.array([60, 60, 0, 1, 9, 60, 200, 60], np.int32)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev)
                               for a in (attn, in_lens, out_lens))
    got = mas.b_mas(attn, in_lens, out_lens)
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))


@pytest.mark.parametrize("T_s", [128, 1024])
def test_mas_kernel_near_its_shared_memory_limit(T_s):
    """The longest T_m whose ring and move bits fit a block (232448 B,
    mas.cu's kMaxShared) runs the warp kernel bit-exact; one frame past the
    fit runs the same kernel with its move words in device memory,
    bit-exact too (``mas.route``, the card's own ``ctts_mas_route``, and
    the launch counters agree on both). At T_s = 1024 that T_m is past
    T_s."""
    dev = _need_card()
    from ctts_torch.ops import mas
    T_m = 1024
    while mas.shared_bytes(T_m + 32, T_s) <= 232448:
        T_m += 32
    while mas.shared_bytes(T_m + 1, T_s) <= 232448:
        T_m += 1
    assert T_m > T_s
    for frames, route in ((T_m, "warp"), (T_m + 1, "warp_dev")):
        rng = np.random.RandomState(9)
        attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                                   _mas_case(rng, 2, frames, T_s, "seeded"))
        assert mas.route(frames, T_s) == route
        before = mas.launches, mas.dev_launches, mas.rows_launches
        got = mas.b_mas(attn, in_lens, out_lens)
        torch.cuda.synchronize()
        assert (mas.launches - before[0], mas.dev_launches - before[1],
                mas.rows_launches - before[2]) == (
            (1, 0, 0) if route == "warp" else (0, 1, 0))
        assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))


@pytest.mark.parametrize("kind", ["seeded", "ties", "short"])
@pytest.mark.parametrize("B,T_m,T_s", [(2, 1443, 1024), (1, 10307, 128),
                                       (2, 2560, 640), (3, 1200, 1100),
                                       (3, 70, 2049), (2, 60, 6144),
                                       (2, 40, 6145)])
def test_mas_long_route_bit_exact(B, T_m, T_s, kind):
    """The shapes past the warp kernel's shared memory (T_m one frame past
    it at T_s = 1024 and 128, 2560 frames at 640 tokens) take the warp
    kernel with its move words in device memory, T_s past 1024 the wide
    kernel (2, 3 and 6 chain warps), past 6144 the long route; one launch a
    call, counted by the route, bit-exact against ``b_mas_plain`` on seeded
    inputs, all ties and out_len < in_len."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(B + T_s + T_m)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                               _mas_case(rng, B, T_m, T_s, kind))
    route = mas.route(T_m, T_s)
    want = "rows" if T_s > 6144 else "warps" if T_s > 1024 else "warp_dev"
    assert route == want
    counter = {"rows": "rows_launches", "warps": "wide_launches",
               "warp_dev": "dev_launches"}[want]
    before = getattr(mas, counter), mas.launches
    got = mas.b_mas(attn, in_lens, out_lens)
    torch.cuda.synchronize()
    assert (getattr(mas, counter), mas.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))


def test_mas_long_route_rows_in_device_memory():
    """Past 29056 columns the long route's two rows leave shared memory for
    its scratch: bit-exact, edge lengths included."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(15)
    attn, _, _ = _mas_case(rng, 3, 24, 29100, "seeded")
    in_lens = np.array([29100, 1, 15000], np.int32)
    out_lens = np.array([24, 24, 3], np.int32)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev)
                               for a in (attn, in_lens, out_lens))
    got = mas.b_mas(attn, in_lens, out_lens)
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))


def test_mas_kernel_beside_a_busy_stream():
    """While another stream holds most SMs with long-running blocks, the
    kernel (whose blocks wait on no other block) still ends and is exact."""
    dev = _need_card()
    from ctts_torch.ops import kernels, mas
    rng = np.random.RandomState(12)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                               _mas_case(rng, 16, 896, 128, "seeded"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    busy = torch.empty(4 * sms, 1024, device=dev)
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        kernels.barrier_chain(busy, 4 * sms, 1024, 20000)
    got = mas.b_mas(attn, in_lens, out_lens)
    torch.cuda.synchronize()
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))


def test_mas_kernel_log_is_the_wrappers_torch_expression():
    """The kernel's logf(max(p, eps)) is torch.log(torch.clamp(p, eps)) bit
    for bit on the card: softmax-like values, 0, eps, below eps, 1, above
    1, a denormal, a NaN and -0."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(10)
    p = torch.from_numpy((rng.rand(1 << 20) ** 6).astype(np.float32)).to(dev)
    p[:10] = torch.tensor([0.0, 1e-13, 1e-12, 1.0, float("nan"), 1e-40, 0.5,
                           2.0, -0.0, 3e-12])
    want = torch.log(torch.clamp(p, min=1e-12))
    got = mas.kernel_log(p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _ctc_em(rng, dev, B, T_m, T_s, in_lens, out_lens):
    from ctts_torch.ops import forward_sum as fs
    logits = torch.from_numpy(rng.randn(B, T_m, T_s + 1).astype(
        np.float32)).to(dev)
    key = torch.arange(T_s + 1, device=dev)[None, None, :]
    return fs._interleave(fs._log_softmax(torch.where(
        key <= in_lens[:, None, None], logits,
        logits.new_full((), fs.NEG)))).contiguous()


def _lattice_err(got, ref):
    """max |got - ref| / max(1, |ref|) over reachable entries; the
    sentinels must agree in place."""
    live = ref > -1e8
    assert torch.equal(live, got > -1e8)
    return ((got - ref).abs() / ref.abs().clamp(min=1.0))[live].max().item()


def _check_ctc(em, in_lens, out_lens, cot):
    """alpha and beta ≤ 2e-5 of max(1, |ref|) on reachable entries, and
    bit-exact; the NLL to 2e-5 of max |logL|; the gradient ≤ 5e-3 of
    its largest entry where the end is reachable (out_len >= in_len; elsewhere the
    gradient is ill-conditioned, ROADMAP.md §3, and only finite), and zero
    at or past out_len; one lattice and one gradient launch through the
    autograd.Function; each kernel against its plain version run on the
    card."""
    from ctts_torch.ops import forward_sum as fs

    def counts():
        return (fs.lattice_launches + fs.cluster_lattice_launches,
                fs.grad_launches)

    before = counts()
    e = em.clone().requires_grad_(True)
    nll = fs.ctc_state_nll(e, in_lens, out_lens)
    (nll * cot).sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)
    alpha, beta = fs.ctc_lattice(em, in_lens, out_lens)
    ref_a = fs.ctc_alpha_plain(em, out_lens)
    ref_b = fs.ctc_beta_plain(em, in_lens, out_lens)
    assert _lattice_err(alpha, ref_a) <= 2e-5
    assert _lattice_err(beta, ref_b) <= 2e-5
    # the kernels' log-sum-exps are the plain version's, term for term
    assert torch.equal(alpha, ref_a) and torch.equal(beta, ref_b)
    i2 = 2 * in_lens.long()
    log_l = torch.logsumexp(ref_a[:, -1].gather(
        1, torch.stack([i2, (i2 - 1).clamp(min=0)], 1)), -1)
    assert (nll + log_l).abs().max().item() <= \
        2e-5 * log_l.abs().max().item()
    want = fs.ctc_grad_plain(ref_a, ref_b, log_l, cot, out_lens)
    reach = out_lens >= in_lens
    scale = want[reach].abs().max().item()
    assert (e.grad - want)[reach].abs().max().item() <= 5e-3 * scale
    assert bool(torch.isfinite(e.grad).all())
    got = fs.ctc_grad(ref_a, ref_b, log_l, cot, out_lens)
    assert (got - want)[reach].abs().max().item() <= 1e-6 * scale
    assert torch.equal(got, want)
    for b, n in enumerate(out_lens.tolist()):
        assert not e.grad[b, max(n, 0):].any()


@pytest.mark.parametrize("B,T_m,T_s", [(16, 896, 128), (3, 70, 45), (2, 20, 1)])
def test_ctc_kernels_match_plain(B, T_m, T_s):
    """The lattice (alpha and beta) and the gradient at the train shape and
    small ones, ragged lengths."""
    dev = _need_card()
    rng = np.random.RandomState(B + T_m)
    in_lens = torch.from_numpy(_ragged(rng, B, max(T_s // 2, 1), T_s)).to(dev)
    out_lens = torch.from_numpy(_ragged(rng, B, T_m - T_m // 3, T_m)).to(dev)
    em = _ctc_em(rng, dev, B, T_m, T_s, in_lens, out_lens)
    cot = torch.from_numpy(rng.rand(B).astype(np.float32) + 0.5).to(dev)
    _check_ctc(em, in_lens, out_lens, cot)


def test_ctc_kernels_edge_lengths():
    """out_len 0, 1 and 2, out_len < in_len (the end unreachable), out_len
    = in_len, in_len 1, and S = 513 (a block of 544 threads, one a state:
    17 warps, the last one partly idle)."""
    dev = _need_card()
    rng = np.random.RandomState(11)
    B, T_m, T_s = 8, 300, 256
    in_lens = torch.tensor([256, 1, 200, 40, 3, 256, 128, 1],
                           dtype=torch.int32, device=dev)
    out_lens = torch.tensor([300, 0, 1, 2, 299, 100, 128, 5],
                            dtype=torch.int32, device=dev)
    em = _ctc_em(rng, dev, B, T_m, T_s, in_lens, out_lens)
    cot = torch.from_numpy(rng.rand(B).astype(np.float32) + 0.5).to(dev)
    _check_ctc(em, in_lens, out_lens, cot)


def test_ctc_lattice_runs_are_bit_identical():
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(12)
    B, T_m, T_s = 4, 300, 100
    in_lens = torch.from_numpy(_ragged(rng, B, 50, T_s)).to(dev)
    out_lens = torch.from_numpy(_ragged(rng, B, 200, T_m)).to(dev)
    em = _ctc_em(rng, dev, B, T_m, T_s, in_lens, out_lens)
    one = fs.ctc_lattice(em, in_lens, out_lens)
    two = fs.ctc_lattice(em, in_lens, out_lens)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_ctc_lattice_alpha_alone_without_a_gradient():
    """With no gradient to come (validation) the lattice launches the
    alpha blocks alone: one launch, the same alpha bits, no beta, and the
    NLL under no_grad equals the NLL with a gradient."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(13)
    B, T_m, T_s = 16, 896, 128
    in_lens = torch.from_numpy(_ragged(rng, B, 64, T_s)).to(dev)
    out_lens = torch.from_numpy(_ragged(rng, B, 600, T_m)).to(dev)
    em = _ctc_em(rng, dev, B, T_m, T_s, in_lens, out_lens)
    both, _ = fs.ctc_lattice(em, in_lens, out_lens)
    before = fs.lattice_launches
    alone, beta = fs.ctc_lattice(em, in_lens, out_lens, False)
    assert fs.lattice_launches == before + 1 and beta is None
    assert torch.equal(alone, both)
    e = em.clone().requires_grad_(True)
    with_grad = fs.ctc_state_nll(e, in_lens, out_lens)
    with torch.no_grad():
        without = fs.ctc_state_nll(e, in_lens, out_lens)
    assert torch.equal(with_grad.detach(), without)


def test_ctc_lattice_at_its_state_limit():
    """Across the limit of one block a chain: a text axis of 319 (S = 639,
    the 1024-thread instance) and of 320 (S = 641, the cluster kernel, 8
    CTAs of 81 states), and of 511 and 512 (S = 1023 and 1025, the
    cluster kernel; 1024 states was once the one-block limit) all run
    bit-exact against the plain versions, each on its instance (the launch
    counters and ``forward_sum.route`` say which)."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(14)
    B, T_m = 2, 1100
    cot = torch.from_numpy(rng.rand(B).astype(np.float32) + 0.5).to(dev)
    for T_s, S in ((319, 639), (320, 641), (511, 1023), (512, 1025)):
        in_lens = torch.tensor([T_s, 300], dtype=torch.int32, device=dev)
        out_lens = torch.tensor([1100, 700], dtype=torch.int32, device=dev)
        em = _ctc_em(rng, dev, B, T_m, T_s, in_lens, out_lens)
        assert em.shape[2] == S
        before = fs.lattice_launches, fs.cluster_lattice_launches
        _check_ctc(em, in_lens, out_lens, cot)
        assert (fs.lattice_launches > before[0],
                fs.cluster_lattice_launches > before[1]) == (S <= 640,
                                                             S > 640)
        assert fs.route(S) == (("lattice_1024", 0) if S <= 640
                               else ("lattice_cluster", 8))


@pytest.mark.parametrize("T_s", [1024, 2048, 4100, 14600, 23204, 116024])
def test_ctc_wide_lattice_bit_exact(T_s):
    """The cluster kernel at S = 2049, 4097 and 8201 (tiles of 257 to 1026
    states and 16 ghosts, the last two cells a thread), 29201 (four a
    thread), 46409 (past
    the em ring's shared memory: em read on the chain) and 232049 (the rows
    in the device scratch), with lengths ragged down to out_len < in_len,
    0 and 1: alpha, beta and the NLL bit-exact, the gradient within 5e-3
    where the end is reachable."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(T_s)
    T_m = T_s + 40 if T_s <= 4100 else 30 if T_s <= 14600 else 6
    lens = ([T_s, T_s // 2, T_s // 3, 7] if T_s <= 4100
            else [T_s, 5, T_s // 2, 2])
    mels = ([T_m, T_m - 9, 1, 0] if T_s <= 4100 else [T_m, T_m, 1, 0])
    in_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    out_lens = torch.tensor(mels, dtype=torch.int32, device=dev)
    em = _ctc_em(rng, dev, len(lens), T_m, T_s, in_lens, out_lens)
    S = em.shape[2]
    assert fs.route(S) == ("lattice_cluster" if S <= 46223
                           else "lattice_cluster_no_ring", 8)
    # the rows leave shared memory for the scratch past 231647 states
    assert (fs._lib().ctts_ctc_scratch_bytes(2 * len(lens), S, 0) > 0) == (
        S > 231647)
    cot = torch.from_numpy(rng.rand(len(lens)).astype(np.float32) + 0.5).to(dev)
    _check_ctc(em, in_lens, out_lens, cot)


@pytest.mark.parametrize("ctas", [1, 2, 3, 5, 7, 8])
@pytest.mark.parametrize("T_m", [530, 700])
def test_ctc_cluster_lattice_at_each_size_and_handoff(ctas, T_m):
    """The cluster kernel on 1 to 8 CTAs a chain (the ghost states handed
    over every 8 frames), at S = 1281 and at S = 1025 (tiles whose edges
    fall on odd and even states), with a path through every tile edge and
    lengths ending on and off a handoff: alpha and beta bit for bit the
    plain versions'; the launches are not counted."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(20 + ctas)
    for T_s in (640, 512):
        in_lens = torch.tensor([T_s, T_s - 1, T_s // 2, 3], dtype=torch.int32,
                               device=dev)
        out_lens = torch.tensor([T_m, min(T_s + 1, T_m - 1), T_m - 3, 17],
                                dtype=torch.int32, device=dev)
        em = _ctc_em(rng, dev, 4, T_m, T_s, in_lens, out_lens)
        before = fs.lattice_launches, fs.cluster_lattice_launches
        alpha, beta = fs.ctc_lattice_cluster(em, in_lens, out_lens, ctas)
        torch.cuda.synchronize()
        assert (fs.lattice_launches, fs.cluster_lattice_launches) == before
        assert torch.equal(alpha, fs.ctc_alpha_plain(em, out_lens))
        assert torch.equal(beta, fs.ctc_beta_plain(em, in_lens, out_lens))


def test_ctc_cluster_lattice_runs_are_bit_identical():
    """Two runs of the cluster kernel (its CTAs pipelined in whatever order
    the card runs them) give the same bits, alpha alone too."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(22)
    in_lens = torch.tensor([640, 517, 402, 290], dtype=torch.int32,
                           device=dev)
    out_lens = torch.tensor([900, 800, 700, 600], dtype=torch.int32,
                            device=dev)
    em = _ctc_em(rng, dev, 4, 900, 640, in_lens, out_lens)
    one = fs.ctc_lattice(em, in_lens, out_lens)
    two = fs.ctc_lattice(em, in_lens, out_lens)
    alone, _ = fs.ctc_lattice(em, in_lens, out_lens, False)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(alone, one[0])


def test_ctc_cluster_launch_raises():
    """A cluster the card cannot take is an error through kernels.check,
    never a smaller cluster: 9 CTAs a chain (past the portable 8), and
    tiles too small for the 16 ghost states a handoff carries."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(23)
    il = torch.tensor([600, 10], dtype=torch.int32, device=dev)
    ol = torch.tensor([700, 700], dtype=torch.int32, device=dev)
    em = _ctc_em(rng, dev, 2, 700, 600, il, ol)
    with pytest.raises(RuntimeError, match="ctc_lattice: CUDA error"):
        fs.ctc_lattice_cluster(em, il, ol, 9)
    small = em[..., :121].contiguous()
    with pytest.raises(RuntimeError, match="ctc_lattice: CUDA error"):
        fs.ctc_lattice_cluster(small, il.clamp(max=4), ol, 8)


def test_long_kernels_beside_a_busy_stream():
    """While another stream holds most SMs with long-running blocks, the
    cluster lattice (whose CTAs wait on their neighbours) and MAS's warp
    kernel with its move words in device memory and wide kernel (whose
    chain blocks wait on their log blocks, and whose chain warps wait on
    each other) still end and are exact."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    from ctts_torch.ops import kernels, mas
    rng = np.random.RandomState(24)
    il = torch.tensor([640, 300], dtype=torch.int32, device=dev)
    ol = torch.tensor([1200, 1000], dtype=torch.int32, device=dev)
    em = _ctc_em(rng, dev, 2, 1200, 640, il, ol)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                               _mas_case(rng, 2, 2560, 640, "seeded"))
    wide = [torch.from_numpy(a).to(dev) for a in
            _mas_case(rng, 2, 600, 3000, "seeded")]
    assert mas.route(2560, 640) == "warp_dev"
    assert mas.route(600, 3000) == "warps"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    busy = torch.empty(4 * sms, 1024, device=dev)
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        kernels.barrier_chain(busy, 4 * sms, 1024, 20000)
    alpha, beta = fs.ctc_lattice(em, il, ol)
    got = mas.b_mas(attn, in_lens, out_lens)
    got_wide = mas.b_mas(*wide)
    torch.cuda.synchronize()
    assert torch.equal(alpha, fs.ctc_alpha_plain(em, ol))
    assert torch.equal(beta, fs.ctc_beta_plain(em, il, ol))
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))
    assert torch.equal(got_wide, mas.b_mas_plain(*wide))


@pytest.mark.parametrize("T_m,T_s", [(2560, 640), (1200, 2100)])
def test_mas_device_move_words_runs_are_bit_identical(T_m, T_s):
    """Two runs of the warp kernel with its move words in device memory at
    the long step's shape, and of the wide kernel, give the same bits."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(25)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                               _mas_case(rng, 4, T_m, T_s, "seeded"))
    one = mas.b_mas(attn, in_lens, out_lens)
    two = mas.b_mas(attn, in_lens, out_lens)
    assert torch.equal(one, two)


def test_train_and_vctk_shapes_keep_their_instances():
    """The train shape [16, 896, 128] and the VCTK shape [16, 1298, 128]
    launch MAS's warp kernel with its move bits in shared memory, and the
    train shape's 257 states the one-state-a-thread lattice: the launch
    counters and the routes say so."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    from ctts_torch.ops import mas
    rng = np.random.RandomState(26)
    for T_m in (896, 1298):
        assert mas.route(T_m, 128) == "warp"
        attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                                   _mas_case(rng, 16, T_m, 128, "seeded"))
        before = mas.launches, mas.dev_launches, mas.rows_launches
        mas.b_mas(attn, in_lens, out_lens)
        assert (mas.launches - before[0], mas.dev_launches - before[1],
                mas.rows_launches - before[2]) == (1, 0, 0)
    assert fs.route(257) == ("lattice", 0)
    in_lens = torch.from_numpy(_ragged(rng, 16, 64, 128)).to(dev)
    out_lens = torch.from_numpy(_ragged(rng, 16, 600, 896)).to(dev)
    em = _ctc_em(rng, dev, 16, 896, 128, in_lens, out_lens)
    before = fs.lattice_launches, fs.cluster_lattice_launches
    fs.ctc_lattice(em, in_lens, out_lens)
    assert (fs.lattice_launches - before[0],
            fs.cluster_lattice_launches - before[1]) == (1, 0)


def _attention_case(rng, dev, N, T, d, lens):
    q, k, v = (torch.from_numpy(rng.randn(N, T, d).astype(np.float32)).to(dev)
               for _ in range(3))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,d", [(97, 64), (97, 256), (1152, 64),
                                 (1152, 256), (97, 16), (1152, 16), (97, 32),
                                 (1152, 32), (97, 48), (200, 24)])
def test_attention_kernel_other_widths_bit_identical(T, d, dtype, tol):
    """Lengths of 0 and 1, a ragged last query block and key tile; one
    launch a call; two runs give the same bits. d = 48 and 24 run
    zero-padded to the 64 and 32 instances."""
    dev = _need_card()
    from ctts_torch.ops import attention
    rng = np.random.RandomState(T * d)
    q, k, v, lens = _attention_case(rng, dev, 6, T, d,
                                    [0, 1, T, T - 1, 65, T // 2])
    scale = d ** -0.5
    ref = attention.attention_plain(q, k, v, lens, scale)
    args = [t.to(dtype) for t in (q, k, v)]
    before = attention.launches
    one = attention.fused_attention(*args, lens, scale)
    two = attention.fused_attention(*args, lens, scale)
    torch.cuda.synchronize()
    assert attention.launches == before + 2
    assert torch.equal(one, two)
    _check_attention(one, ref, args, lens, scale, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernel_at_the_decoder_train_shape(dtype, tol):
    """N = 32 (16 utterances, 2 heads), T = 896, d = 128, the train step's
    ragged mel lengths."""
    dev = _need_card()
    from ctts_torch.ops import attention
    rng = np.random.RandomState(896)
    mel = _ragged(rng, 16, 500, 896)
    q, k, v, lens = _attention_case(rng, dev, 32, 896, 128,
                                    np.repeat(mel, 2).tolist())
    ref = attention.attention_plain(q, k, v, lens, 128 ** -0.5)
    before = attention.launches
    args = [t.to(dtype) for t in (q, k, v)]
    got = attention.fused_attention(*args, lens)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    _check_attention(got, ref, args, lens, 128 ** -0.5, tol)


def test_attention_function_backward_on_the_card():
    """Kernel forward, recomputing backward: gradients equal plain
    autograd's to bf16 rounding (1e-2)."""
    dev = _need_card()
    from ctts_torch.ops import attention
    rng = np.random.RandomState(9)
    N, T, d = 4, 300, 128
    q, k, v, cot = (torch.from_numpy(rng.randn(N, T, d).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(4))
    lens = torch.tensor([300, 211, 5, 0], dtype=torch.int32, device=dev)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = attention.launches
    attention.fused_attention(*a, lens).backward(cot)
    assert attention.launches == before + 1
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention.attention_plain(*b, lens, d ** -0.5).backward(cot)
    for x, y in zip(a, b):
        assert (x.grad.float() - y.grad.float()).abs().max().item() <= 1e-2


def test_training_wrappers_raise_on_untaken_cuda_input():
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    from ctts_torch.ops import mas, sort_gather
    lens = torch.tensor([3, 2], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        mas.b_mas(torch.rand(2, 6, 3, device=dev), lens.long(), lens)
    with pytest.raises(ValueError):
        mas.b_mas(torch.rand(2, 6, device=dev), lens, lens)
    with pytest.raises(ValueError):
        fs.ctc_lattice(torch.zeros(2, 6, device=dev), lens, lens)
    # past the old limits (T_s 1024, S 1024) the long routes take them
    attn = torch.rand(2, 6, 1030, device=dev)
    assert torch.equal(mas.b_mas(attn, lens, lens),
                       mas.b_mas_plain(attn, lens, lens))
    em = torch.zeros(2, 6, 1025, device=dev)
    assert torch.equal(fs.ctc_lattice(em, lens, lens)[0],
                       fs.ctc_alpha_plain(em, lens))
    with pytest.raises(TypeError):
        fs.ctc_lattice(torch.zeros(2, 6, 7, device=dev, dtype=torch.float64),
                       lens, lens)
    with pytest.raises(ValueError):
        z = torch.zeros(2, device=dev)
        fs.ctc_grad(torch.zeros(2, 6, 7, device=dev),
                    torch.zeros(2, 6, 8, device=dev), z, z, lens)
    with pytest.raises(TypeError):
        sort_gather.scatter_rows(torch.zeros(2, 3, 4, device=dev,
                                             dtype=torch.float16),
                                 torch.zeros(2, 3, dtype=torch.int32,
                                             device=dev), 5)


def test_train_step_on_the_card_tiny():
    """Three steps of the tiny configuration on the card: finite losses and
    every training kernel launched."""
    dev = _need_card()
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.ops import forward_sum as fs
    from ctts_torch.ops import mas, sort_gather
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.optimizer import build_optimizer
    from ctts_torch.utils.testing import synth_batch, tiny_configs
    pre, mc, tr = tiny_configs()
    mc["transformer_fs2"]["encoder_hidden"] = 128     # head width 64
    mc["transformer_fs2"]["decoder_hidden"] = 128
    model = init_weights(CompTransTTS(pre, mc, tr), 0).to(dev)
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=7000)
    step = make_train_step(pre, mc, tr, "train_unsup")
    batch = batch_to_device(synth_batch(prior=False), dev)
    before = (sort_gather.scatter_launches, mas.launches, fs.lattice_launches,
              fs.grad_launches)
    for _ in range(3):
        metrics = step(state, batch)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    after = (sort_gather.scatter_launches, mas.launches, fs.lattice_launches,
             fs.grad_launches)
    assert [a - b for a, b in zip(after, before)] == [6, 3, 3, 3]


def test_crf_on_the_card_matches_the_cpu():
    """The duration CRF at the train shape (B=16, T_s=128, 32 classes,
    ragged lengths): the log-likelihood within 1e-5 of max(1, |CPU|) (the
    log-sum-exps may round differently), the Viterbi tags equal."""
    dev = _need_card()
    from ctts_torch.ops.crf import crf_log_likelihood, viterbi_decode
    rng = np.random.RandomState(22)
    B, T, K = 16, 128, 32
    lens = _ragged(rng, B, 60, T)
    mask = torch.from_numpy(np.arange(T)[None] < lens[:, None])
    em = torch.from_numpy(rng.randn(B, T, K).astype(np.float32) * 2)
    tags = torch.from_numpy(rng.randint(0, K, (B, T)).astype(np.int32))
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((K,), (K,), (K, K))]
    cpu_ll = crf_log_likelihood(em, tags, mask, *params)
    cpu_tags = viterbi_decode(em, mask, *params)
    on = [t.to(dev) for t in (em, tags, mask, *params)]
    card_ll = crf_log_likelihood(*on).cpu()
    assert ((card_ll - cpu_ll).abs() / cpu_ll.abs().clamp(min=1.0)).max() \
        <= 1e-5
    card_tags = viterbi_decode(on[0], on[2], *on[3:]).cpu()
    assert torch.equal(card_tags, cpu_tags)


@pytest.mark.parametrize("option", ["cwt-mse", "ph-mog", "frame-crf-ar"])
def test_train_sup_step_on_the_card_tiny(option):
    """Three ``train_sup`` steps of the tiny configuration on the card with
    the option set: finite losses, the gather and its scatter launched
    (the ph path's integer gather has no scatter), no MAS and no CTC."""
    dev = _need_card()
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.ops import forward_sum as fs
    from ctts_torch.ops import mas, sort_gather
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.optimizer import build_optimizer
    from ctts_torch.utils.testing import synth_batch, tiny_configs
    pre, mc, tr = tiny_configs()
    mc["transformer_fs2"]["encoder_hidden"] = 128     # head width 64
    mc["transformer_fs2"]["decoder_hidden"] = 128
    mc["duration_modeling"]["learn_alignment"] = False
    pitch, energy, dur = {"cwt-mse": ("cwt", "phoneme_level", "mse"),
                          "ph-mog": ("ph", "phoneme_level", "mog"),
                          "frame-crf-ar": ("frame", "frame_level",
                                           "crf")}[option]
    pre["preprocessing"]["pitch"]["pitch_type"] = pitch
    pre["preprocessing"]["pitch"]["pitch_ar"] = option == "frame-crf-ar"
    pre["preprocessing"]["energy"]["feature"] = energy
    tr["loss"]["dur_loss"] = dur
    model = init_weights(CompTransTTS(pre, mc, tr), 0).to(dev)
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt,
                               step=tr["step"]["var_start_steps"])
    step = make_train_step(pre, mc, tr, "train_sup")
    batch = batch_to_device(synth_batch(
        sup=True, phone_energy=energy == "phoneme_level"), dev)
    before = (sort_gather.launches, sort_gather.scatter_launches,
              mas.launches, fs.lattice_launches)
    for _ in range(3):
        metrics = step(state, batch)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert metrics["ctc"].item() == 0 and metrics["pdur"].item() > 0
    after = (sort_gather.launches, sort_gather.scatter_launches,
             mas.launches, fs.lattice_launches)
    gathers = {"cwt-mse": 2, "ph-mog": 3, "frame-crf-ar": 1}[option]
    scatters = 1 if option == "frame-crf-ar" else 2
    assert [a - b for a, b in zip(after, before)] == \
        [3 * gathers, 3 * scatters, 0, 0]


# ---- relative-position attention (the conformer) ------------------------------ #

def _relpos_case(dev, B, H, T, d, seed):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    args = (t(B, T, H, d), t(B, T, H, d), t(B, T, H, d), t(H, T, d),
            t(H, d), t(H, d))
    cot = t(B, T, H, d)
    mask = torch.zeros(B, T, dtype=torch.bool, device=dev)
    mask[-1, T - T // 5:] = True
    return args, cot, mask


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,H,T,d", [(2, 8, 96, 32), (1, 2, 200, 32),
                                     (4, 8, 87, 32), (2, 4, 87, 16),
                                     (1, 4, 200, 16), (2, 2, 87, 64),
                                     (1, 4, 200, 64), (2, 2, 200, 128),
                                     (1, 2, 87, 128), (1, 1, 200, 256),
                                     (2, 1, 87, 256), (1, 2, 96, 96)])
def test_relpos_kernels_match_plain(B, H, T, d, dtype, tol, masked, dropout):
    """Forward and backward kernels against the plain version in float32 on
    the same (rounded) inputs and the same dropout seed: the output and each
    of the six gradients within ``tol`` of its largest entry; one forward
    launch and two backward launches."""
    dev = _need_card()
    from ctts_torch.ops import relpos_attention as ra
    args, cot, mask = _relpos_case(dev, B, H, T, d, T + d)
    args = [a.to(dtype).float() for a in args[:4]] + list(args[4:])
    mask = mask if masked else None
    a = [(x.to(dtype) if i < 4 else x).detach().clone().requires_grad_(True)
         for i, x in enumerate(args)]
    before = (ra.launches, ra.bwd_launches)
    out = ra.relpos_attention(*a, 0.0625, dropout, torch.Generator(
        dev).manual_seed(5), mask)
    out.backward(cot.to(dtype))
    torch.cuda.synchronize()
    assert (ra.launches, ra.bwd_launches) == (before[0] + 1, before[1] + 2)
    b = [x.detach().clone().requires_grad_(True) for x in args]
    seed = ra.draw_seed(torch.Generator(dev).manual_seed(5), dev)
    ref = ra.relpos_attention_plain(*b, 0.0625, dropout, seed, mask)
    ref.backward(cot.to(dtype).float())
    assert out.dtype == dtype and out.shape == ref.shape
    for got, want in [(out, ref)] + [(x.grad, y.grad) for x, y in zip(a, b)]:
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), err


def test_relpos_backward_is_deterministic():
    """Two backward launches on the same inputs (bf16, masked, dropout 0.1)
    give the same bits: every sum is taken in a fixed order, no float
    atomics."""
    dev = _need_card()
    from ctts_torch.ops import relpos_attention as ra
    (q, k, v, pos, ub, vb), cot, mask = _relpos_case(dev, 2, 8, 200, 32, 3)
    fold = [x.permute(0, 2, 1, 3).reshape(16, 200, 32).to(torch.bfloat16)
            .contiguous() for x in (q, k, v, cot)]
    pos = pos.to(torch.bfloat16).contiguous()
    kmask = (~mask).to(torch.int32).contiguous()
    seed = torch.tensor([11, 12], dtype=torch.int64, device=dev)
    args = (*fold[:3], pos, ub, vb, seed, kmask)
    o, m, l = ra._launch_fwd(*args, 0.0625, 0.1)
    first = ra._launch_bwd(*args, fold[3], o, m, l, 0.0625, 0.1)
    second = ra._launch_bwd(*args, fold[3], o, m, l, 0.0625, 0.1)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_relpos_wrapper_raises_on_untaken_cuda_input():
    dev = _need_card()
    from ctts_torch.ops import relpos_attention as ra
    args, _, _ = _relpos_case(dev, 1, 2, 40, 264, 0)    # d=264: past 256
    with pytest.raises(ValueError, match="F1"):
        ra.relpos_attention(*args, 0.1)
    args, _, _ = _relpos_case(dev, 1, 2, 40, 32, 0)
    with pytest.raises(TypeError):
        ra.relpos_attention(*(a.half() for a in args), 0.1)


def _conformer_configs(hidden=64, heads=2):
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["block_type"] = "conformer"
    mc["conformer"].update(encoder_layer=2, decoder_layer=2,
                           encoder_hidden=hidden, decoder_hidden=hidden,
                           encoder_head=heads, decoder_head=heads)
    return pre, mc, tr


def test_conformer_forward_on_the_card():
    """The conformer model in infer mode on the card (heads of 32) against
    the same weights on the CPU: mel within 1e-3; one forward launches the
    relpos kernel once per layer."""
    _conformer_forward_matches_cpu(64, 2)


@pytest.mark.parametrize("hidden,heads", [(64, 4), (128, 2), (256, 2)])
def test_conformer_forward_other_head_dims_on_the_card(hidden, heads):
    """The same with heads of 16 (64 in 4), of 64 (128 in 2) and of 128
    (256 in 2), the relpos kernels' other widths."""
    _conformer_forward_matches_cpu(hidden, heads)


def _conformer_forward_matches_cpu(hidden, heads):
    dev = _need_card()
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.ops import relpos_attention as ra
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.testing import synth_batch
    pre, mc, tr = _conformer_configs(hidden, heads)
    model = init_weights(CompTransTTS(pre, mc, tr), 1).eval()
    b = synth_batch()
    inputs = [torch.from_numpy(b[k]).long() for k in ("speakers", "texts",
                                                       "src_lens")]
    with torch.no_grad():
        want = model(*inputs, "infer", max_mel_len=48)
        model.to(dev)
        before = ra.launches
        got = model(*(x.to(dev) for x in inputs), "infer", max_mel_len=48)
    torch.cuda.synchronize()
    assert ra.launches == before + 4
    np.testing.assert_array_equal(got["mel_lens"].cpu().numpy(),
                                  want["mel_lens"].numpy())
    err = (got["postnet_mel_predictions"].cpu()
           - want["postnet_mel_predictions"]).abs().max().item()
    assert err <= 1e-3, err


def test_conformer_train_step_on_the_card():
    """Two train steps of the tiny conformer on the card, dropout on:
    finite losses, 4 relpos forward launches and 8 backward ones (two a
    layer) per step."""
    dev = _need_card()
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.ops import relpos_attention as ra
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.optimizer import build_optimizer
    from ctts_torch.utils.testing import synth_batch
    pre, mc, tr = _conformer_configs()
    model = init_weights(CompTransTTS(pre, mc, tr), 0).to(dev)
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=7000)
    step = make_train_step(pre, mc, tr, "train_unsup")
    batch = batch_to_device(synth_batch(prior=False), dev)
    for _ in range(2):
        before = (ra.launches, ra.bwd_launches)
        metrics = step(state, batch)
        assert (ra.launches - before[0], ra.bwd_launches - before[1]) == (4, 8)
    assert all(np.isfinite(v.item()) for v in metrics.values())


# ---- the reformer's kernels: local window and LSH chunk ------------------------ #

def _window_case(dev, G, N, d, seed):
    """qk, v [G, N, d] and validity with holes, and a short row whose last
    window of 128 is all padding (at N=128 the whole row)."""
    rng = np.random.RandomState(seed)
    qk, v, cot = (torch.from_numpy(rng.randn(G, N, d).astype(np.float32)).to(dev)
                  for _ in range(3))
    valid = rng.rand(G, N) > 0.15
    valid[0] = True
    valid[-1, min(N // 2 + 3, N - 128):] = False
    return qk, v, cot, torch.from_numpy(valid).to(dev)


def _assert_close(pairs, tol):
    for got, want in pairs:
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("G,N,d", [(3, 128, 128), (3, 256, 128), (3, 256, 64),
                                   (3, 256, 16), (3, 256, 32), (3, 384, 256),
                                   (2, 128, 256), (3, 256, 96)])
def test_local_window_kernels_match_plain(G, N, d, dtype, tol):
    """Forward and backward against the plain version in float32 on the same
    (rounded) inputs, window 128: output, dqk and dv within ``tol`` of their
    largest entries (bf16: one rounding of each result); one launch of
    each kernel."""
    dev = _need_card()
    from ctts_torch.ops import local_window_attention as lw
    qk, v, cot, valid = _window_case(dev, G, N, d, N)
    qk, v = qk.to(dtype).float(), v.to(dtype).float()
    a = [x.to(dtype).requires_grad_(True) for x in (qk, v)]
    before = (lw.launches, lw.bwd_launches)
    out = lw.local_window_attention(*a, valid, 128, d ** -0.5)
    out.backward(cot.to(dtype))
    torch.cuda.synchronize()
    assert (lw.launches, lw.bwd_launches) == (before[0] + 1, before[1] + 1)
    b = [x.detach().clone().requires_grad_(True) for x in (qk, v)]
    ref = lw.local_window_attention_plain(*b, valid, 128, d ** -0.5)
    ref.backward(cot.to(dtype).float())
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close([(out, ref)] + [(x.grad, y.grad) for x, y in zip(a, b)], tol)


def _lsh_sort_case(dev, G, N, d, seed, n_hashes=4, bucket=64):
    """qk, v, validity and a real hash sort of qk (st, svalid, sticker)."""
    from ctts_torch.models.reformer import lsh_sort
    qk, v, cot, valid = _window_case(dev, G, N, d, seed)
    rot = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        1, d, n_hashes, N // bucket // 2).astype(np.float32)).to(dev)
    sticker, st, svalid = lsh_sort(qk, valid, rot, bucket, n_hashes)
    return qk, v, st, svalid


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("G,N,d", [(2, 128, 128), (2, 256, 128), (2, 256, 64),
                                   (2, 256, 16), (2, 256, 32), (2, 128, 48)])
def test_lsh_chunk_kernels_match_plain(G, N, d, dtype, tol, causal):
    """Forward (output ‖ logsumexp, float32) and backward with a random
    cotangent on both against the plain version in float32 on the same
    (rounded) inputs and the same sort, chunks of 64 over 4 hash rounds (at
    N=128, 8 chunks: chunk 0 wraps to the last); dqk and dv within ``tol``
    of their largest entries. One launch of each kernel, and one scatter
    launch in the backward."""
    dev = _need_card()
    from ctts_torch.ops import lsh_chunk_attention as lc
    from ctts_torch.ops import sort_gather
    qk, v, st, svalid = _lsh_sort_case(dev, G, N, d, N)
    qk, v = qk.to(dtype).float(), v.to(dtype).float()
    cot = torch.from_numpy(np.random.RandomState(3).randn(
        G, 4 * N, d + 1).astype(np.float32)).to(dev)
    a = [x.to(dtype).requires_grad_(True) for x in (qk, v)]
    before = (lc.launches, lc.bwd_launches, sort_gather.scatter_launches)
    out = lc.chunk_attention(*a, st, svalid, 64, causal, d ** -0.5)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (lc.launches, lc.bwd_launches, sort_gather.scatter_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    b = [x.detach().clone().requires_grad_(True) for x in (qk, v)]
    ref = lc.chunk_attention_plain(*b, st, svalid, 64, causal, d ** -0.5)
    ref.backward(cot)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _assert_close([(out[..., :d], ref[..., :d])], 1e-4)
    assert (out[..., d] - ref[..., d]).abs().max().item() <= 1e-3
    _assert_close([(x.grad, y.grad) for x, y in zip(a, b)], tol)


def _check_local(qk, v, cot, valid, window, dtype, tol):
    """The local-window kernels on qk, v (rounded to dtype) against the
    plain version in float32: output and gradients within ``tol`` of their
    largest entries, one launch of each kernel."""
    from ctts_torch.ops import local_window_attention as lw
    d = qk.shape[-1]
    qk, v = qk.to(dtype).float(), v.to(dtype).float()
    a = [x.to(dtype).requires_grad_(True) for x in (qk, v)]
    before = (lw.launches, lw.bwd_launches)
    out = lw.local_window_attention(*a, valid, window, d ** -0.5)
    out.backward(cot.to(dtype))
    torch.cuda.synchronize()
    assert (lw.launches, lw.bwd_launches) == (before[0] + 1, before[1] + 1)
    b = [x.detach().clone().requires_grad_(True) for x in (qk, v)]
    ref = lw.local_window_attention_plain(*b, valid, window, d ** -0.5)
    ref.backward(cot.to(dtype).float())
    _assert_close([(out, ref)] + [(x.grad, y.grad) for x, y in zip(a, b)], tol)


@pytest.mark.parametrize("dtype,tol,d", [(torch.float32, 1e-4, 128),
                                         (torch.bfloat16, 1e-2, 128),
                                         (torch.float32, 1e-4, 64)])
@pytest.mark.parametrize("case", ["padded windows", "ragged tail"])
def test_local_window_kernels_edge_cases(case, dtype, tol, d):
    """Windows of 128 over N=384: wholly padded windows (the middle window
    of one row, the first of another, a whole row: uniform over all 256
    slots, window 0's synthetic ones included), or ragged tails (lengths
    300, 257 and 1); against the plain version as above."""
    dev = _need_card()
    G, N = 4, 384
    rng = np.random.RandomState(len(case) + d)
    qk, v, cot = (torch.from_numpy(rng.randn(G, N, d).astype(np.float32)).to(
        dev) for _ in range(3))
    if case == "padded windows":
        valid = np.ones((G, N), bool)
        valid[0, 128:256] = False
        valid[1] = False
        valid[2, :128] = False
    else:
        valid = np.arange(N)[None] < np.array([N, 300, 257, 1])[:, None]
    _check_local(qk, v, cot, torch.from_numpy(valid).to(dev), 128, dtype, tol)


def _check_lsh(qk, v, st, svalid, cs, causal, dtype, tol):
    """The LSH chunk kernels against the plain version in float32 on the
    same (rounded) inputs and rows, as test_lsh_chunk_kernels_match_plain."""
    from ctts_torch.ops import lsh_chunk_attention as lc
    G, N, d = qk.shape
    qk, v = qk.to(dtype).float(), v.to(dtype).float()
    cot = torch.from_numpy(np.random.RandomState(3).randn(
        G, st.shape[1], d + 1).astype(np.float32)).to(qk.device)
    a = [x.to(dtype).requires_grad_(True) for x in (qk, v)]
    before = (lc.launches, lc.bwd_launches)
    out = lc.chunk_attention(*a, st, svalid, cs, causal, d ** -0.5)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (lc.launches, lc.bwd_launches) == (before[0] + 1, before[1] + 1)
    b = [x.detach().clone().requires_grad_(True) for x in (qk, v)]
    ref = lc.chunk_attention_plain(*b, st, svalid, cs, causal, d ** -0.5)
    ref.backward(cot)
    _assert_close([(out[..., :d], ref[..., :d])], 1e-4)
    assert (out[..., d] - ref[..., d]).abs().max().item() <= 1e-3
    _assert_close([(x.grad, y.grad) for x, y in zip(a, b)], tol)


@pytest.mark.parametrize("dtype,tol,d", [(torch.float32, 1e-4, 128),
                                         (torch.bfloat16, 1e-2, 128),
                                         (torch.float32, 1e-4, 64)])
@pytest.mark.parametrize("case", ["duplicate across rounds", "chunk 0 wraps",
                                  "one chunk"])
def test_lsh_chunk_kernels_edge_cases(case, dtype, tol, d):
    """Sorted rows built by hand, chunks of 64: two hash rounds over N=128
    whose boundary puts position 127 at the end of chunk 1 and the start of
    chunk 2, so chunk 2's look-back holds it twice (and chunk 0 wraps to
    chunk 3); one round of N=128 (chunk 0 looks back at chunk 1, the last);
    one chunk (chunk 0 looks back at itself: every position twice). Some
    positions invalid; against the plain version as above."""
    dev = _need_card()
    rng = np.random.RandomState(len(case) + d)
    N = 64 if case == "one chunk" else 128
    G = 2
    qk, v = (torch.from_numpy(rng.randn(G, N, d).astype(np.float32)).to(dev)
             for _ in range(2))
    st = np.arange(N)
    if case == "duplicate across rounds":
        st = np.concatenate([st, np.roll(st, 1)])
    st = np.tile(st, (G, 1)).astype(np.int32)
    valid = rng.rand(G, N) > 0.2
    svalid = np.take_along_axis(valid, st, 1).astype(np.int32)
    _check_lsh(qk, v, torch.from_numpy(st).to(dev),
               torch.from_numpy(svalid).to(dev), 64, True, dtype, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_backward_runs_are_bit_identical(dtype):
    """No float atomics: two backward runs of each kernel, on the same
    inputs and forward results, give the same bits."""
    dev = _need_card()
    from ctts_torch.ops import local_window_attention as lw
    from ctts_torch.ops import lsh_chunk_attention as lc
    qk, v, cot, valid = _window_case(dev, 3, 384, 128, 5)
    qk, v = qk.to(dtype), v.to(dtype)
    vi = valid.to(torch.int32)
    o, m, l = lw._launch_fwd(qk, v, vi, 128, 0.1)
    runs = [lw._launch_bwd(qk, v, vi, cot.to(dtype), o, m, l, 128, 0.1)
            for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    qk, v, st, svalid = _lsh_sort_case(dev, 2, 256, 128, 6)
    qk, v = qk.to(dtype), v.to(dtype)
    out = lc._launch_fwd(qk, v, st, svalid, 64, True, 0.1)
    g = torch.from_numpy(np.random.RandomState(7).randn(
        2, st.shape[1], 129).astype(np.float32)).to(dev)
    runs = [lc._launch_bwd(qk, v, st, svalid, g, out, 64, True, 0.1)
            for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_reformer_wrappers_raise_on_untaken_cuda_input():
    dev = _need_card()
    from ctts_torch.ops import local_window_attention as lw
    from ctts_torch.ops import lsh_chunk_attention as lc
    qk, v, _, valid = _window_case(dev, 2, 128, 264, 0)    # d=264: past 256
    with pytest.raises(ValueError, match="F1"):
        lw.local_window_attention(qk, v, valid, 128, 0.1)
    st = torch.zeros(2, 512, dtype=torch.int32, device=dev)
    qk, v, _, valid = _window_case(dev, 2, 128, 136, 0)    # d=136: past 128
    with pytest.raises(ValueError, match="F1"):
        lc.chunk_attention(qk, v, st, st, 64, True, 0.1)
    qk, v, _, valid = _window_case(dev, 2, 128, 128, 0)
    with pytest.raises(TypeError):
        lc.chunk_attention(qk, v, st.long(), st, 64, True, 0.1)
    with pytest.raises(TypeError):
        lw.local_window_attention(qk.half(), v.half(), valid, 128, 0.1)


def _reformer_configs():
    """The reformer at heads of 128 (the kernels' width): d_model 128,
    depth 2, 2 heads (one local, one LSH), dropout off."""
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    mc["block_type"] = "reformer"
    mc["transformer"].update(encoder_hidden=128, decoder_hidden=128,
                             encoder_head=1, decoder_head=1,
                             encoder_dropout=0.0, decoder_dropout=0.0)
    mc["reformer"].update(depth=2, encoder_head=2, decoder_head=2)
    return pre, mc, tr


@pytest.mark.parametrize("fused", ["0", "1"])
def test_reformer_forward_on_the_card(fused, monkeypatch):
    """The reformer model in infer mode on the card, float32, on both LSH
    routes, against the same weights on the CPU: mel within 1e-3, equal
    lengths; one forward launches the local-window kernel once per layer and
    either the gather (default) or the chunk kernel (fused) once per layer,
    and the un-sort scatter once per layer."""
    dev = _need_card()
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.testing import synth_batch
    monkeypatch.setenv("CTTS_FUSED_LSH", fused)
    pre, mc, tr = _reformer_configs()
    model = init_weights(CompTransTTS(pre, mc, tr), 1).eval()
    b = synth_batch()
    inputs = [torch.from_numpy(b[k]).long() for k in ("speakers", "texts",
                                                       "src_lens")]
    with torch.no_grad():
        want = model(*inputs, "infer", max_mel_len=48)
        model.to(dev)
        reset_launch_counts()
        got = model(*(x.to(dev) for x in inputs), "infer", max_mel_len=48)
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts().items() if n}
    # the length regulator gathers twice (frames and the energy embedding)
    lsh = {"lsh_chunk_fwd": 4} if fused == "1" else {"gather_rows": 6}
    assert counts == {"local_window_fwd": 4, "scatter_rows": 4,
                      "gather_rows": 2, **lsh}, counts
    np.testing.assert_array_equal(got["mel_lens"].cpu().numpy(),
                                  want["mel_lens"].numpy())
    err = (got["postnet_mel_predictions"].cpu()
           - want["postnet_mel_predictions"]).abs().max().item()
    assert err <= 1e-3, err


@pytest.mark.parametrize("fused", ["0", "1"])
def test_reformer_train_step_on_the_card(fused, monkeypatch):
    """Two train steps of the small reformer on the card, dropout on, on
    both LSH routes: finite losses; per step the local-window kernels 4 + 4
    and the chunk kernels 4 + 4 (fused) or none (default)."""
    dev = _need_card()
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.optimizer import build_optimizer
    from ctts_torch.utils.testing import synth_batch
    monkeypatch.setenv("CTTS_FUSED_LSH", fused)
    pre, mc, tr = _reformer_configs()
    mc["transformer"].update(encoder_dropout=0.2, decoder_dropout=0.2)
    model = init_weights(CompTransTTS(pre, mc, tr), 0).to(dev)
    opt, _ = build_optimizer(model, mc, tr)
    state = create_train_state(model, opt, step=7000)
    step = make_train_step(pre, mc, tr, "train_unsup")
    batch = batch_to_device(synth_batch(prior=False), dev)
    for _ in range(2):
        reset_launch_counts()
        metrics = step(state, batch)
        counts = launch_counts()
        assert (counts["local_window_fwd"], counts["local_window_bwd"]) == (4, 4)
        want = (4, 4) if fused == "1" else (0, 0)
        assert (counts["lsh_chunk_fwd"], counts["lsh_chunk_bwd"]) == want
    assert all(np.isfinite(v.item()) for v in metrics.values())


def _resblock_case(C, T, k, dtype, dev, seed=0):
    rng = np.random.RandomState(seed + C + T + k)
    x = torch.from_numpy(rng.randn(1, C, T).astype(np.float32) * 0.5)
    x = x.repeat(2, 1, 1).to(dev, dtype)
    x[1] *= -1.5                            # a second row, other values
    convs = []
    for _ in range(2):
        w = rng.randn(3, k, C, C).astype(np.float32) * (C * k) ** -0.5
        w = torch.from_numpy(w).to(dtype).float().to(dev).contiguous()
        b = torch.from_numpy(rng.randn(3, C).astype(np.float32) * 0.1)
        convs.append((w, b.to(dev)))
    return x, convs


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C,T,block_t", [(32, 256, 128), (64, 250, 128),
                                         (128, 1024, 1024), (16, 700, 1024)])
def test_fused_resblock_kernel_matches_plain(C, T, block_t, k, dtype, tol):
    """The fused chain against its plain version on the card, relative to
    the largest plain entry: two tiles at T=256 (both sequence edges and a
    seam), a ragged last tile at T=250, the tile the wrapper picks at
    C=128, and C=16 (two n-tiles a warp; float32 there in rounds). bf16:
    the same roundings in another summation order, so a value within
    float32 rounding of a bf16 boundary may land on its neighbour and carry
    through the rest of the chain (a few ulps at most)."""
    dev = _need_card()
    from ctts_torch.ops import fused_resblock
    x, (c1, c2) = _resblock_case(C, T, k, dtype, dev)
    ref = fused_resblock.reference_resblock1(x, c1, c2, k)
    before = fused_resblock.launches
    got = fused_resblock.fused_resblock1(x, c1, c2, k, block_t=block_t)
    torch.cuda.synchronize()
    assert fused_resblock.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_fused_resblock_wrapper_raises_on_untaken_cuda_input():
    dev = _need_card()
    from ctts_torch.ops import fused_resblock
    x, (c1, c2) = _resblock_case(32, 128, 3, torch.float32, dev)
    with pytest.raises(TypeError):
        fused_resblock.fused_resblock1(x.half(), c1, c2, 3)
    with pytest.raises(ValueError):
        fused_resblock.fused_resblock1(x[:, :24].contiguous(), c1, c2, 3)
    with pytest.raises(ValueError):
        fused_resblock.fused_resblock1(x, c1, c2, 5)
    with pytest.raises(ValueError):
        fused_resblock.fused_resblock1(x.transpose(1, 2), c1, c2, 3)
    with pytest.raises(ValueError):
        fused_resblock.fused_resblock1(x, (c1[0].cpu(), c1[1]), c2, 3)


def _card_hifigan(dev, dtype, channels=512, seed=0):
    from ctts_torch.utils.model import init_weights
    from ctts_torch.vocoder.hifigan import HiFiGANGenerator, V1_CONFIG
    gen = HiFiGANGenerator(dict(V1_CONFIG, upsample_initial_channel=channels),
                           dtype=dtype)
    return init_weights(gen, seed).to(dev).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generator_fused_matches_unfused_on_the_card(dtype, monkeypatch):
    """HiFi-GAN V1 at full width with CTTS_FUSE_RESBLOCK=1 against the same
    generator on cuDNN: 9 launches at an even mel length (levels 1-3), 6 at
    an odd one. float32 within 1e-4 on the tanh output; bf16 (where cuDNN
    adds the bias after rounding the conv) within 5 % in RMS."""
    dev = _need_card()
    from ctts_torch.ops import fused_resblock
    gen = _card_hifigan(dev, dtype)
    rng = np.random.RandomState(3)
    for T, launches in ((32, 9), (33, 6)):
        mel = torch.from_numpy(rng.randn(2, T, 80).astype(np.float32) - 4)
        mel = mel.to(dev)
        with torch.no_grad():
            monkeypatch.delenv("CTTS_FUSE_RESBLOCK", raising=False)
            want = gen(mel)
            monkeypatch.setenv("CTTS_FUSE_RESBLOCK", "1")
            before = fused_resblock.launches
            got = gen(mel)
        torch.cuda.synchronize()
        assert fused_resblock.launches - before == launches
        diff = got - want
        if dtype == torch.float32:
            assert diff.abs().max().item() <= 1e-4
        else:
            assert diff.pow(2).mean().sqrt() <= 0.05 * want.pow(2).mean().sqrt()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_vocode_equals_full_on_the_card(dtype):
    """The chunked vocoder on the card against the full pass, full-width
    HiFi-GAN: float32 within 1e-5 (the order of sums only: cuDNN may choose
    other algorithms for the window's shape); bf16 within 5 % in RMS."""
    dev = _need_card()
    from ctts_torch.vocoder.streaming import RF_MEL, make_chunked_vocoder
    gen = _card_hifigan(dev, dtype)
    mel = np.random.RandomState(4).randn(1, 150, 80).astype(np.float32) - 4
    with torch.no_grad():
        want = gen(torch.from_numpy(mel).to(dev)).cpu().numpy()
    chunks = list(make_chunked_vocoder(gen, chunk=64, halo=RF_MEL)(mel))
    assert [c.shape[1] for c in chunks] == [64 * 256, 64 * 256, 22 * 256]
    got = np.concatenate(chunks, axis=1)
    if dtype == torch.float32:
        assert np.abs(got - want).max() <= 1e-5
    else:
        assert np.sqrt(np.mean((got - want) ** 2)) <= \
            0.05 * np.sqrt(np.mean(want ** 2))


@pytest.mark.parametrize("variant", ["baseline", "row_flip", "lane_rev",
                                     "ladder"])
@pytest.mark.parametrize("N,T,BQ", [(3, 256, 128), (2, 896, 128), (2, 40, 8),
                                    (3, 30, 3), (1, 1152, 128),
                                    (128, 896, 128)])
def test_flip_kernel_bit_exact(N, T, BQ, variant):
    """Every variant bit for bit against the plain version: rows whose
    bytes are whole 16-byte pieces (the bulk-copy staging), rows of T = 30
    that start off those pieces, and the flip tool's own shape."""
    dev = _need_card()
    from ctts_torch.ops import flip
    rng = np.random.RandomState(T + BQ)
    x = torch.from_numpy(rng.randn(N, T, T).astype(np.float32)).to(
        dev, torch.bfloat16)
    before = flip.launches
    got = flip.flip(x, variant, BQ)
    torch.cuda.synchronize()
    assert flip.launches == before + 1
    assert torch.equal(got, flip.flip_plain(x, variant, BQ))


# ---- the rest of the block zoo, and the kernels at the VCTK shape -------------- #

# the VCTK recipe's longest utterance (configs/VCTK.yaml, max_seq_len's
# comment) and its train step's batch and tokens
T_VCTK, B_VCTK, S_VCTK = 1298, 16, 128
# a bf16 stack against its float32 CPU twin: relative to the largest output
# entry, after 2 layers
ZOO_BF16_TOL = 5e-2


@pytest.mark.parametrize("block", ["transformer", "fastformer",
                                   "lstransformer"])
def test_block_stacks_bf16_on_the_card(block):
    """Each new block's encoder (96 tokens, a padded row) and decoder (300
    frames, past two of the lstransformer's windows) at width 256 with 2
    heads of 128, 2 layers each, seeded weights, in bf16 on the card
    against the same weights in float32 on the CPU: each output within
    5e-2 of its largest entry, padded rows zero; the transformer launches
    the attention kernel once a layer."""
    dev = _need_card()
    from ctts_torch.models.registry import get_block
    from ctts_torch.ops import attention
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.testing import tiny_configs
    _, mc, _ = tiny_configs()
    mc["block_type"] = block
    mc["transformer"].update(encoder_layer=2, decoder_layer=2,
                             encoder_hidden=256, decoder_hidden=256)
    rng = np.random.RandomState(7)
    lens = {"encoder": (96, 61), "decoder": (300, 211)}
    inputs = {"encoder": torch.from_numpy(rng.randint(1, 300, (2, 96))),
              "decoder": torch.from_numpy(rng.randn(2, 300, 256).astype(
                  np.float32))}
    for cls, side in zip(get_block(block), ("encoder", "decoder")):
        cpu = init_weights(cls(dict(mc, compute_dtype="float32")), 3).eval()
        card = cls(dict(mc, compute_dtype="bfloat16")).eval()
        card.load_state_dict(cpu.state_dict())
        card.to(dev)
        T, short = lens[side]
        mask = torch.arange(T)[None] >= torch.tensor([T, short])[:, None]
        before = attention.launches
        with torch.no_grad():
            want = cpu(inputs[side], mask)[0]
            got = card(inputs[side].to(dev), mask.to(dev))[0]
        torch.cuda.synchronize()
        assert attention.launches - before == (2 if block == "transformer"
                                               else 0)
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        assert err <= ZOO_BF16_TOL, (side, err)
        assert not got[1, short:].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernel_at_the_vctk_decoder_shape(dtype, tol):
    """N = 32 (16 utterances, 2 heads), T = 1298, d = 128, ragged mel
    lengths 500-1298: the VCTK train step's decoder."""
    dev = _need_card()
    from ctts_torch.ops import attention
    rng = np.random.RandomState(T_VCTK)
    mel = _ragged(rng, B_VCTK, 500, T_VCTK)
    q, k, v, lens = _attention_case(rng, dev, 2 * B_VCTK, T_VCTK, 128,
                                    np.repeat(mel, 2).tolist())
    ref = attention.attention_plain(q, k, v, lens, 128 ** -0.5)
    before = attention.launches
    args = [t.to(dtype) for t in (q, k, v)]
    got = attention.fused_attention(*args, lens)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    _check_attention(got, ref, args, lens, 128 ** -0.5, tol)


@pytest.mark.parametrize("kind", ["seeded", "ties"])
def test_mas_kernel_bit_exact_at_the_vctk_shape(kind):
    """B = 16, T_m = 1298, T_s = 128: bit for bit ``b_mas_plain``."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(T_VCTK)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev) for a in
                               _mas_case(rng, B_VCTK, T_VCTK, S_VCTK, kind))
    before = mas.launches
    got = mas.b_mas(attn, in_lens, out_lens)
    torch.cuda.synchronize()
    assert mas.launches == before + 1
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))


def test_ctc_kernels_match_plain_at_the_vctk_shape():
    """The CTC lattice and gradient at B = 16, T_m = 1298, 257 states,
    ragged lengths: the tolerances of ``_check_ctc``."""
    dev = _need_card()
    rng = np.random.RandomState(T_VCTK + 1)
    in_lens = torch.from_numpy(_ragged(rng, B_VCTK, 75, S_VCTK)).to(dev)
    out_lens = torch.from_numpy(_ragged(rng, B_VCTK, 500, T_VCTK)).to(dev)
    em = _ctc_em(rng, dev, B_VCTK, T_VCTK, S_VCTK, in_lens, out_lens)
    cot = torch.from_numpy(rng.rand(B_VCTK).astype(np.float32) + 0.5).to(dev)
    _check_ctc(em, in_lens, out_lens, cot)


@pytest.mark.parametrize("case", ["zeros", "first_zero", "overrun"])
def test_segment_gru_packed_matches_loop_on_the_card(case):
    """The du2021 extractor's packed bidirectional GRU (cuDNN) against its
    frame-by-frame oracle (``torch.gru_cell``) on the card, float32: the
    outputs and the input's gradient within 1e-5 of their largest entry,
    in eval mode (the train step with dropout off) and in train mode."""
    dev = _need_card()
    from ctts_torch.models.prosody import segment_gru, segment_gru_loop
    from ctts_torch.ops.length_regulator import dur_to_mel2ph
    rng = np.random.RandomState(len(case))
    B, T_s, T_m = 4, 40, 300
    dur = rng.randint(0, 14, (B, T_s)).astype(np.float32)
    if case == "first_zero":
        dur[:, 0] = 0
    if case == "overrun":
        dur[:, :] += 4
    src_mask = np.arange(T_s)[None] >= np.asarray([40, 33, 20, 5])[:, None]
    mel2ph = dur_to_mel2ph(torch.from_numpy(dur).to(dev),
                           torch.from_numpy(src_mask).to(dev), max_len=T_m)
    gru = torch.nn.GRU(80, 64, batch_first=True, bidirectional=True).to(dev)
    x = torch.from_numpy(rng.randn(B, T_m, 80).astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.randn(B, T_m, 128).astype(np.float32)).to(dev)
    for train in (False, True):
        gru.train(train)
        outs = []
        for fn in (segment_gru, segment_gru_loop):
            xi = x.clone().requires_grad_(True)
            y = fn(gru, xi, mel2ph)
            (g,) = torch.autograd.grad((y * cot).sum(), xi)
            outs.append((y.detach(), g))
        for got, ref in zip(outs[0], outs[1]):
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            assert err <= 1e-5, (train, err)


def _speechlike(rng, seconds, sr=22050):
    """An f0-modulated harmonic source with noise and amplitude movement,
    and digital silence before and after it."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    phase = 2 * np.pi * np.cumsum(150 + 40 * np.sin(2 * np.pi * 1.7 * t)) / sr
    sig = np.sin(phase) + 0.4 * np.sin(2 * phase) + 0.2 * np.sin(3 * phase)
    sig = sig * (0.35 + 0.3 * np.sin(2 * np.pi * 0.9 * t) ** 2)
    sig += rng.randn(n) * 0.005
    pad = np.zeros(int(0.05 * sr))
    return (np.concatenate([pad, sig, pad]) * 0.6).astype(np.float32)


def test_mel_featurizer_on_the_card_matches_cpu():
    """TacotronSTFT at LJSpeech's sizes on a batch of 4 wavs on the card
    against the same module on the CPU: the log-mel within 1e-4, the
    energy within 1e-5 relative (float64 transforms and sums on both)."""
    dev = _need_card()
    from ctts_torch.audio.stft import TacotronSTFT
    rng = np.random.RandomState(0)
    y = torch.from_numpy(np.stack([_speechlike(rng, 3.0) for _ in range(4)]))
    st = TacotronSTFT(1024, 256, 1024, 80, 22050, 0, 8000)
    mel, energy = st.mel_spectrogram(y)
    mel_c, energy_c = st.to(dev).mel_spectrogram(y.to(dev))
    assert mel_c.shape == (4, 80, 1 + y.shape[1] // 256)
    assert (mel_c.cpu() - mel).abs().max().item() <= 1e-4
    torch.testing.assert_close(energy_c.cpu(), energy, rtol=1e-5, atol=0)


def test_pitch_tracker_on_the_card_matches_cpu():
    """The float64 tracker on the card against the CPU on tones, a chirp,
    noise and a speech-like wav: voicing equal frame for frame, f0 within
    1e-6 relative but on the frames whose window is digital silence under
    sound (``constant_window_frames``: rounding decides their lag)."""
    _need_card()
    from ctts_torch.preprocessing.pitch import (constant_window_frames,
                                                extract_f0_autocorr)
    rng = np.random.RandomState(1)
    t = np.arange(22050) / 22050
    wavs = [0.5 * np.sin(2 * np.pi * hz * t) for hz in (80.0, 220.0, 600.0)]
    wavs += [0.4 * np.sin(2 * np.pi * np.cumsum(120 + 80 * t) / 22050),
             rng.randn(22050) * 0.3, _speechlike(rng, 4.0)]
    for wav in wavs:
        cpu = extract_f0_autocorr(wav, 22050, 256, device="cpu")
        card = extract_f0_autocorr(wav, 22050, 256, device="cuda")
        np.testing.assert_array_equal(card > 0, cpu > 0)
        keep = (cpu > 0) & ~constant_window_frames(wav, 22050, 256)
        np.testing.assert_allclose(card[keep], cpu[keep], rtol=1e-6, atol=0)


def test_rescnn_on_the_card_matches_cpu():
    """The DeepSpeaker ResCNN (seeded weights) and its fbank on the card
    against the CPU in float32 with TF32 off: embeddings within 1e-5,
    the fbank within 1e-4."""
    dev = _need_card()
    from ctts_torch.models.speaker import ResCNN, compute_fbank
    from ctts_torch.utils.model import init_weights
    rng = np.random.RandomState(2)
    model = init_weights(ResCNN(), 0).eval()
    x = torch.from_numpy(rng.randn(8, 160, 64).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    assert (got - ref).abs().max().item() <= 1e-5
    wav = _speechlike(rng, 2.0)
    fb = compute_fbank(wav, 22050, device="cpu")
    fb_card = compute_fbank(wav, 22050, device=dev).cpu()
    assert (fb_card - fb).abs().max().item() <= 1e-4
