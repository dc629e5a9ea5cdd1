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
    got = attention.fused_attention(q.to(dev, dtype), k.to(dev, dtype),
                                    v.to(dev, dtype), lens.to(dev), scale)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (N, T, d)
    err = (got.float() - ref).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,M,F", [(4, 97, 1152, 256), (2, 13, 50, 1),
                                     (3, 9, 17, 3)])
def test_gather_kernel_bit_exact(G, N, M, F, dtype):
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
    q = torch.zeros(2, 16, 32, device=dev)                 # d=32: no kernel
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


@pytest.mark.parametrize("kind", ["seeded", "ties", "short"])
@pytest.mark.parametrize("B,T_m,T_s", [(16, 896, 128), (3, 70, 45), (2, 33, 1)])
def test_mas_kernel_bit_exact(B, T_m, T_s, kind):
    """Equal bit for bit to ``b_mas_plain``: seeded inputs, an all-ties
    input (uniform attention) and utterances with out_len < in_len."""
    dev = _need_card()
    from ctts_torch.ops import mas
    rng = np.random.RandomState(B + T_s)
    attn = rng.rand(B, T_m, T_s).astype(np.float32) ** 4 + 1e-9
    attn /= attn.sum(-1, keepdims=True)
    if kind == "ties":
        attn[:] = 1.0 / T_s
    in_lens = _ragged(rng, B, max(T_s // 2, 1), T_s)
    out_lens = _ragged(rng, B, T_m // 2, T_m)
    if kind == "short":
        out_lens[1:] = np.maximum(in_lens[1:] // 3, 1)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(dev)
                               for a in (attn, in_lens, out_lens))
    before = mas.launches
    got = mas.b_mas(attn, in_lens, out_lens)
    torch.cuda.synchronize()
    assert mas.launches == before + 1
    assert torch.equal(got, mas.b_mas_plain(attn, in_lens, out_lens))
    assert not got.requires_grad


@pytest.mark.parametrize("B,T_m,T_s", [(16, 896, 128), (3, 70, 45), (2, 20, 1)])
def test_ctc_kernels_match_plain(B, T_m, T_s):
    """alpha ≤ 2e-5 of max(1, |alpha|) on reachable entries (the sentinels
    agree in place); gradient ≤ 5e-3 of its largest entry; both through the
    autograd.Function, against plain run on the card."""
    dev = _need_card()
    from ctts_torch.ops import forward_sum as fs
    rng = np.random.RandomState(B + T_m)
    in_lens = torch.from_numpy(_ragged(rng, B, max(T_s // 2, 1), T_s)).to(dev)
    out_lens = torch.from_numpy(_ragged(rng, B, T_m - T_m // 3, T_m)).to(dev)
    logits = torch.from_numpy(rng.randn(B, T_m, T_s + 1).astype(
        np.float32)).to(dev)
    key = torch.arange(T_s + 1, device=dev)[None, None, :]
    em = fs._interleave(fs._log_softmax(torch.where(
        key <= in_lens[:, None, None], logits,
        logits.new_full((), fs.NEG)))).contiguous()
    before = fs.alpha_launches, fs.grad_launches
    e = em.clone().requires_grad_(True)
    nll = fs.ctc_state_nll(e, in_lens, out_lens)
    cot = torch.from_numpy(rng.rand(B).astype(np.float32) + 0.5).to(dev)
    (nll * cot).sum().backward()
    torch.cuda.synchronize()
    assert (fs.alpha_launches, fs.grad_launches) == (before[0] + 1,
                                                     before[1] + 1)
    alpha = fs.ctc_alpha(em, out_lens)
    ref = fs.ctc_alpha_plain(em, out_lens)
    live = ref > -1e8
    assert torch.equal(live, alpha > -1e8)
    err = ((alpha - ref).abs() / ref.abs().clamp(min=1.0))[live].max().item()
    assert err <= 2e-5, err
    i2 = 2 * in_lens.long()
    log_l = torch.logsumexp(ref[:, -1].gather(
        1, torch.stack([i2, i2 - 1], 1)), -1)
    assert (nll + log_l).abs().max().item() <= 2e-5 * log_l.abs().max().item()
    want = fs.ctc_grad_plain(em, ref, log_l, cot, in_lens, out_lens)
    gerr = (e.grad - want).abs().max().item() / want.abs().max().item()
    assert gerr <= 5e-3, gerr


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
        mas.b_mas(torch.rand(2, 6, 1030, device=dev), lens, lens)
    with pytest.raises(ValueError):
        fs.ctc_alpha(torch.zeros(2, 6, 1025, device=dev), lens)
    with pytest.raises(TypeError):
        fs.ctc_alpha(torch.zeros(2, 6, 7, device=dev, dtype=torch.float64),
                     lens)
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
    before = (sort_gather.scatter_launches, mas.launches, fs.alpha_launches,
              fs.grad_launches)
    for _ in range(3):
        metrics = step(state, batch)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    after = (sort_gather.scatter_launches, mas.launches, fs.alpha_launches,
             fs.grad_launches)
    assert [a - b for a, b in zip(after, before)] == [6, 3, 3, 3]


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
                                     (1, 4, 200, 64)])
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
    args, _, _ = _relpos_case(dev, 1, 2, 40, 8, 0)       # d=8: no kernel
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


@pytest.mark.parametrize("hidden,heads", [(64, 4), (128, 2)])
def test_conformer_forward_other_head_dims_on_the_card(hidden, heads):
    """The same with heads of 16 (64 in 4) and of 64 (128 in 2), the relpos
    kernels' other widths."""
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
@pytest.mark.parametrize("G,N,d", [(3, 128, 128), (3, 256, 128), (3, 256, 64)])
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
@pytest.mark.parametrize("G,N,d", [(2, 128, 128), (2, 256, 128), (2, 256, 64)])
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
    qk, v, _, valid = _window_case(dev, 2, 128, 32, 0)       # d=32: no kernel
    with pytest.raises(ValueError, match="F1"):
        lw.local_window_attention(qk, v, valid, 128, 0.1)
    st = torch.zeros(2, 512, dtype=torch.int32, device=dev)
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
@pytest.mark.parametrize("N,T,BQ", [(3, 256, 128), (2, 896, 128), (2, 40, 8)])
def test_flip_kernel_bit_exact(N, T, BQ, variant):
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
