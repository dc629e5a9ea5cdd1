"""The training ops of ctts_torch against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through the JAX function and
its counterpart in the port, in float32. JAX runs as its own tests run it
here: ``b_mas_scan``, ``_ctc_nll_scan`` under ``jax.grad`` and ``.at[].add``;
three tests run the Pallas bodies themselves in interpret mode. On the CPU the port's wrappers run their
plain versions, which are what ``chip_smoke.py`` holds the CUDA kernels to
on the card. Each test states its tolerance.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs several workers on a few cores: keep torch's intra-op
    # pool small so these tests do not starve the others
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- beta-binomial prior -------------------------------------------------- #

@pytest.mark.parametrize("M,n", [(40, 11), (700, 77)])
def test_prior_matches_jax_and_scipy(M, n):
    """≤ 2e-3 relative against JAX and against scipy's float64 pmf, where
    the pmf is above 1e-8; both sides carry float32 lgamma error in the
    pmf(0) anchor, which grows with the row length."""
    from scipy.stats import betabinom
    from ctts_tpu.ops.attn_prior import beta_binomial_prior as j_prior
    from ctts_torch.ops.attn_prior import beta_binomial_prior
    ml = np.asarray([M, M - 13], np.int32)
    sl = np.asarray([n, n - 4], np.int32)
    got = beta_binomial_prior(_t(ml), _t(sl), M, n).numpy()
    want = np.asarray(j_prior(jnp.asarray(ml), jnp.asarray(sl), M, n))
    assert got.shape == (2, M, n)
    for b in range(2):
        ref = np.zeros((M, n))
        for i in range(1, ml[b] + 1):
            ref[i - 1, :sl[b]] = betabinom(sl[b], i, ml[b] + 1 - i).pmf(
                np.arange(sl[b]))
        big = ref > 1e-8
        assert np.max(np.abs(got[b] - ref)[big] / ref[big]) <= 2e-3
        assert np.max(np.abs(got[b] - want[b])[big] / ref[big]) <= 2e-3
        # zero outside (mel_len, src_len), like the zero-padded collate
        assert not got[b, ml[b]:].any() and not got[b, :, sl[b]:].any()


def test_prior_at_ljspeech_rows_against_scipy():
    """One LJSpeech-scale row set (M=900, n=120): ≤ 2e-3 against scipy."""
    from scipy.stats import betabinom
    from ctts_torch.ops.attn_prior import beta_binomial_prior
    M, n = 900, 120
    got = beta_binomial_prior(_t(np.asarray([M], np.int32)),
                              _t(np.asarray([n], np.int32)), M, n).numpy()[0]
    rows = [1, 2, 450, 899, 900]
    for i in rows:
        ref = betabinom(n, i, M + 1 - i).pmf(np.arange(n))
        big = ref > 1e-8
        assert np.max(np.abs(got[i - 1] - ref)[big] / ref[big]) <= 2e-3


# ---- segment mean ---------------------------------------------------------- #

def test_phoneme_mean_matches_jax():
    """Equal to 1e-6: the same sums in another order."""
    from ctts_tpu.ops.segment import phoneme_mean_by_mel2ph as j_mean
    from ctts_torch.ops.segment import phoneme_mean_by_mel2ph
    rng = np.random.RandomState(0)
    B, T_m, T_s = 3, 50, 9
    vals = rng.randn(B, T_m).astype(np.float32)
    mel2ph = np.sort(rng.randint(0, T_s + 1, (B, T_m)), axis=1).astype(np.int32)
    mel2ph[1, mel2ph[1] == 4] = 5                       # a phoneme with no frame
    got = phoneme_mean_by_mel2ph(_t(vals), _t(mel2ph), T_s).numpy()
    want = np.asarray(j_mean(jnp.asarray(vals), jnp.asarray(mel2ph), T_s))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got[1, 3] == 0.0


# ---- scatter and the gather/scatter gradient pair --------------------------- #

@pytest.mark.parametrize("kind", ["sorted", "permutation", "random"])
@pytest.mark.parametrize("F", [1, 7])
def test_scatter_matches_jax_at_add(kind, F):
    """≤ 1e-6 absolute for repeated indices (float32 sums in another order);
    exact for a permutation."""
    from ctts_tpu.ops.sort_gather import scatter_rows as j_scatter
    from ctts_torch.ops.sort_gather import scatter_rows, scatter_rows_plain
    rng = np.random.RandomState(len(kind) + F)
    G, M = 3, 24
    n_out = M if kind == "permutation" else 9
    if kind == "permutation":
        idx = np.stack([rng.permutation(M) for _ in range(G)])
    else:
        idx = rng.randint(0, n_out, (G, M))
        if kind == "sorted":
            idx = np.sort(idx, axis=1)
    idx = idx.astype(np.int32)
    vals = rng.randn(G, M, F).astype(np.float32)
    want = np.asarray(j_scatter(jnp.asarray(vals), jnp.asarray(idx), n_out))
    got = scatter_rows(_t(vals), _t(idx), n_out)
    assert torch.equal(got, scatter_rows_plain(_t(vals), _t(idx), n_out))
    if kind == "permutation":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_scatter_out_of_range_index_adds_nothing():
    from ctts_torch.ops.sort_gather import scatter_rows
    vals = torch.ones(1, 4, 2)
    idx = torch.tensor([[0, -1, 5, 2]], dtype=torch.int32)
    got = scatter_rows(vals, idx, 3)
    assert got.tolist() == [[[1, 1], [0, 0], [1, 1]]]


def test_scatter_accumulates_bfloat16_in_float32():
    from ctts_torch.ops.sort_gather import scatter_rows
    vals = torch.full((1, 300, 1), 1.0, dtype=torch.bfloat16)
    idx = torch.zeros(1, 300, dtype=torch.int32)
    # a bfloat16 running sum would stall at 256
    assert scatter_rows(vals, idx, 1).item() == 300.0


def test_gather_and_scatter_are_each_others_backward():
    """Gradients through gather_rows and scatter_rows equal JAX's custom
    VJPs (≤ 1e-6), and the length regulator's upsample propagates one."""
    from ctts_tpu.ops import sort_gather as j_sg
    from ctts_torch.ops import sort_gather
    from ctts_torch.ops.length_regulator import gather_by_mel2ph
    rng = np.random.RandomState(3)
    G, N, M, F = 2, 6, 15, 4
    vals = rng.randn(G, N, F).astype(np.float32)
    idx = np.sort(rng.randint(0, N, (G, M)), axis=1).astype(np.int32)
    cot = rng.randn(G, M, F).astype(np.float32)

    want = jax.grad(lambda v: jnp.sum(j_sg.gather_rows(v, jnp.asarray(idx))
                                      * cot))(jnp.asarray(vals))
    v = _t(vals).requires_grad_(True)
    (sort_gather.gather_rows(v, _t(idx)) * _t(cot)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), atol=1e-6)

    cot_s = rng.randn(G, N, F).astype(np.float32)
    src = rng.randn(G, M, F).astype(np.float32)
    want = jax.grad(lambda s: jnp.sum(
        j_sg.scatter_rows(s, jnp.asarray(idx), N) * cot_s))(jnp.asarray(src))
    s = _t(src).requires_grad_(True)
    (sort_gather.scatter_rows(s, _t(idx), N) * _t(cot_s)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), atol=1e-6)

    x = _t(rng.randn(G, N, F).astype(np.float32)).requires_grad_(True)
    mel2ph = _t(np.sort(rng.randint(0, N + 1, (G, M)), axis=1).astype(np.int32))
    gather_by_mel2ph(x, mel2ph).sum().backward()
    counts = torch.stack([torch.bincount(m.long(), minlength=N + 1)[1:]
                          for m in mel2ph]).float()
    assert torch.equal(x.grad, counts[..., None].expand(G, N, F))


# ---- attention backward ---------------------------------------------------- #

def test_attention_function_backward_recomputes_plain(monkeypatch):
    """The autograd.Function the card uses (kernel forward, recomputing
    backward), with the launch replaced by the plain version so it runs
    here: its gradients equal plain autograd's and JAX's ``_fused_bwd``
    (≤ 1e-5)."""
    from ctts_tpu.ops.attention import _reference_attention
    from ctts_torch.ops import attention
    monkeypatch.setattr(attention, "_launch", attention.attention_plain)
    rng = np.random.RandomState(4)
    N, T, d = 3, 9, 8
    q, k, v, cot = (rng.randn(N, T, d).astype(np.float32) for _ in range(4))
    lens = np.asarray([9, 5, 0], np.int32)
    scale = d ** -0.5
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = attention._FusedAttention.apply(tq, tk, tv, _t(lens), scale)
    assert out.grad_fn is not None
    out.backward(_t(cot))
    want = jax.grad(lambda *qkv: jnp.sum(_reference_attention(
        *qkv, jnp.asarray(lens), scale) * cot), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=1e-5)


# ---- MAS -------------------------------------------------------------------- #

def _mas_case(kind, rng):
    B, T_m, T_s = 4, 37, 9
    if kind == "ties":
        attn = np.full((B, T_m, T_s), 1.0 / T_s, np.float32)
    else:
        attn = rng.rand(B, T_m, T_s).astype(np.float32) ** 3
        attn /= attn.sum(-1, keepdims=True)
    in_lens = np.asarray([T_s, 6, T_s, 1], np.int32)
    out_lens = np.asarray([T_m, 30, 23, 11], np.int32)
    if kind == "short":                     # out_len < in_len: end unreachable
        out_lens = np.asarray([T_m, 4, 7, 11], np.int32)
    return attn, in_lens, out_lens


@pytest.mark.parametrize("kind", ["seeded", "ties", "short"])
def test_mas_equals_b_mas_scan(kind):
    """Exactly equal, near-ties and unreachable end states included."""
    from ctts_tpu.ops.mas import b_mas_scan
    from ctts_torch.ops.mas import b_mas, b_mas_plain
    attn, in_lens, out_lens = _mas_case(kind, np.random.RandomState(5))
    want = np.asarray(b_mas_scan(jnp.asarray(attn), jnp.asarray(in_lens),
                                 jnp.asarray(out_lens)))
    got = b_mas(_t(attn), _t(in_lens), _t(out_lens))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, b_mas_plain(_t(attn), _t(in_lens), _t(out_lens)))
    for b in range(len(in_lens)):
        assert not got[b, out_lens[b]:].any() and not got[b, :, in_lens[b]:].any()
        if kind != "short":
            assert got[b].sum() == out_lens[b]        # one column per frame


@pytest.mark.parametrize("kind", ["seeded", "ties"])
def test_mas_equals_numpy_oracle(kind):
    """Per utterance, on its valid [mel_len, text_len] corner, equal to
    ``mas_width1_np`` (the upstream model's numba routine in numpy); the
    port's copy of the oracle equals the JAX package's."""
    from ctts_tpu.ops.mas import mas_width1_np as j_oracle
    from ctts_torch.ops.mas import b_mas, mas_width1_np
    attn, in_lens, out_lens = _mas_case(kind, np.random.RandomState(6))
    got = b_mas(_t(attn), _t(in_lens), _t(out_lens)).numpy()
    for b in range(len(in_lens)):
        corner = attn[b, :out_lens[b], :in_lens[b]].astype(np.float32)
        want = mas_width1_np(corner.copy())
        np.testing.assert_array_equal(want, j_oracle(corner.copy()))
        np.testing.assert_array_equal(got[b, :out_lens[b], :in_lens[b]], want)


def test_mas_takes_no_gradient():
    from ctts_torch.ops.mas import b_mas
    attn = torch.rand(1, 6, 3, requires_grad=True)
    lens = torch.tensor([3], dtype=torch.int32)
    assert not b_mas(attn, lens, torch.tensor([6], dtype=torch.int32)
                     ).requires_grad


# ---- ForwardSum -------------------------------------------------------------- #

def _ctc_case(rng):
    B, T_m, T_s = 3, 31, 8
    logprob = rng.randn(B, T_m, T_s).astype(np.float32)
    in_lens = np.asarray([T_s, 5, 3], np.int32)
    out_lens = np.asarray([T_m, 26, 9], np.int32)
    return logprob, in_lens, out_lens


def test_forward_sum_loss_value_and_gradient():
    """Value ≤ 1e-5 and gradient ≤ 1e-5 absolute (≈ 2e-4 of its largest
    entry) against ``jax.value_and_grad`` through ``_ctc_nll_scan``: the
    port's gradient is the explicit beta recursion, JAX's the scan's
    autodiff."""
    from ctts_tpu.ops.forward_sum import forward_sum_loss as j_loss
    from ctts_torch.ops.forward_sum import forward_sum_loss
    logprob, in_lens, out_lens = _ctc_case(np.random.RandomState(7))
    want, want_g = jax.value_and_grad(
        lambda x: j_loss(x, jnp.asarray(in_lens), jnp.asarray(out_lens)))(
        jnp.asarray(logprob))
    x = _t(logprob).requires_grad_(True)
    got = forward_sum_loss(x, _t(in_lens), _t(out_lens))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5
    assert float(np.abs(np.asarray(want_g)).max()) > 1e-2
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-5,
                               rtol=0)


def test_ctc_lattice_pieces_match_jax():
    """``_interleave`` and ``_log_softmax`` equal JAX's (1e-6); the NLL of
    ``ctc_state_nll`` equals ``_ctc_nll_scan`` (1e-5); the alpha lattice
    freezes at out_len; the beta-recursion gradient equals the scan's
    autodiff under a per-utterance cotangent (1e-5 absolute plus 2e-5
    relative)."""
    from ctts_tpu.ops import forward_sum as j_fs
    from ctts_torch.ops import forward_sum as fs
    logprob, in_lens, out_lens = _ctc_case(np.random.RandomState(8))
    logits = np.concatenate([np.full(logprob.shape[:2] + (1,), -1.0,
                                     np.float32), logprob], axis=-1)
    want_ls = j_fs._log_softmax(jnp.asarray(logits))
    got_ls = fs._log_softmax(_t(logits))
    np.testing.assert_allclose(got_ls.numpy(), np.asarray(want_ls), atol=1e-6)
    want_em = np.array(j_fs._interleave(want_ls))
    em = fs._interleave(got_ls)
    np.testing.assert_allclose(em.numpy(), want_em, atol=1e-6)
    assert em.shape[-1] == 2 * logprob.shape[-1] + 1

    cot = np.asarray([1.0, -0.5, 2.0], np.float32)
    want, want_g = jax.value_and_grad(
        lambda e: jnp.sum(j_fs._ctc_nll_scan(e, jnp.asarray(in_lens),
                                             jnp.asarray(out_lens)) * cot),
        has_aux=False)(jnp.asarray(want_em))
    e = _t(want_em).requires_grad_(True)
    nll = fs.ctc_state_nll(e, _t(in_lens), _t(out_lens))
    (nll * _t(cot)).sum().backward()
    assert abs((nll * _t(cot)).sum().item() - float(want)) <= 1e-4
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), atol=1e-5,
                               rtol=2e-5)
    alpha, _ = fs.ctc_lattice(_t(want_em), _t(in_lens), _t(out_lens))
    for b, n in enumerate(out_lens):
        assert torch.equal(alpha[b, n - 1:], alpha[b, n - 1:n].expand(
            alpha.shape[1] - n + 1, -1))
        assert not e.grad[b, n:].any()


def test_bin_loss_matches_jax():
    from ctts_tpu.ops.forward_sum import bin_loss as j_bin
    from ctts_torch.ops.forward_sum import bin_loss
    rng = np.random.RandomState(9)
    soft = rng.rand(2, 12, 5).astype(np.float32)
    soft[0, 0, 0] = 0.0                                  # clipped at eps
    hard = (rng.rand(2, 12, 5) < 0.2).astype(np.float32)
    hard[0, 0, 0] = 1.0
    want = float(j_bin(jnp.asarray(hard), jnp.asarray(soft)))
    assert abs(bin_loss(_t(hard), _t(soft)).item() - want) <= 1e-5
    assert bin_loss(torch.zeros(1, 2, 2), torch.ones(1, 2, 2)).item() == 0.0


# ---- the Pallas bodies themselves, in interpret mode -------------------------- #

def test_mas_equals_pallas_body_in_interpret_mode(monkeypatch):
    """Exactly equal to ``b_mas_pallas`` run in interpret mode."""
    from ctts_tpu.ops import mas as j_mas
    from ctts_torch.ops.mas import b_mas
    monkeypatch.setattr(j_mas, "_INTERPRET", True)
    attn, in_lens, out_lens = _mas_case("seeded", np.random.RandomState(10))
    want = np.asarray(j_mas.b_mas_pallas(
        jnp.asarray(attn), jnp.asarray(in_lens), jnp.asarray(out_lens)))
    np.testing.assert_array_equal(
        b_mas(_t(attn), _t(in_lens), _t(out_lens)).numpy(), want)


def test_forward_sum_equals_pallas_bodies_in_interpret_mode(monkeypatch):
    """Value and gradient ≤ 1e-5 against the Pallas alpha and beta kernels
    behind the custom VJP, run in interpret mode."""
    from ctts_tpu.ops import forward_sum as j_fs
    from ctts_torch.ops.forward_sum import forward_sum_loss
    monkeypatch.setattr(j_fs, "_INTERPRET", True)
    logprob, in_lens, out_lens = _ctc_case(np.random.RandomState(11))
    want, want_g = jax.value_and_grad(lambda x: j_fs.forward_sum_loss(
        x, jnp.asarray(in_lens), jnp.asarray(out_lens)))(jnp.asarray(logprob))
    x = _t(logprob).requires_grad_(True)
    got = forward_sum_loss(x, _t(in_lens), _t(out_lens))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-5,
                               rtol=0)


def test_scatter_equals_pallas_body_in_interpret_mode(monkeypatch):
    """≤ 1e-6 against the one-hot scatter kernel run in interpret mode."""
    from ctts_tpu.ops import sort_gather as j_sg
    from ctts_torch.ops.sort_gather import scatter_rows
    monkeypatch.setattr(j_sg, "_INTERPRET", True)
    rng = np.random.RandomState(12)
    G, M, F, n_out = 2, 16, 8, 8
    vals = rng.randn(G, M, F).astype(np.float32)
    idx = np.sort(rng.randint(0, n_out, (G, M)), axis=1).astype(np.int32)
    assert j_sg.supported(n_out, M, F)
    want = np.asarray(j_sg._scatter_tpu(jnp.asarray(vals), jnp.asarray(idx),
                                        n_out))
    np.testing.assert_allclose(scatter_rows(_t(vals), _t(idx), n_out).numpy(),
                               want, atol=1e-6, rtol=0)
