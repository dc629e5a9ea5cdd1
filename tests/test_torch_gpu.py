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
@pytest.mark.parametrize("T,d", [(96, 128), (1152, 128), (200, 64)])
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
    q = torch.zeros(2, 16, 32, device=dev)
    with pytest.raises(ValueError):
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
