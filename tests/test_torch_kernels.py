"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package: attention against ``_reference_attention`` and the Pallas
kernel in interpret mode, the row gather against ``gather_rows`` in
interpret mode. Inputs are made with numpy from a seed and handed to both.
Also: a CUDA-device input goes to the kernel library and never to the
plain version."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ctts_torch.ops import attention as t_attn
from ctts_torch.ops import kernels
from ctts_torch.ops import sort_gather as t_sg


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs several workers on a few cores: keep torch's intra-op
    # pool small so these tests do not starve the others
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(rng, N, T, d):
    return [rng.randn(N, T, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("N,T,d,lens", [
    (4, 96, 128, [96, 87, 1, 0]),          # encoder width, ragged T
    (2, 40, 16, [40, 0]),                  # tiny-config head width
    (3, 130, 64, [130, 77, 3]),
])
def test_attention_plain_matches_jax_reference(N, T, d, lens):
    from ctts_tpu.ops.attention import _reference_attention
    rng = np.random.RandomState(T)
    q, k, v = _qkv(rng, N, T, d)
    lens = np.asarray(lens, np.int32)
    scale = d ** -0.5
    want = np.asarray(_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens),
                                           scale))
    got = t_attn.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens),
                                 scale).numpy()
    # float32 einsum and softmax on both sides: reassociation only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a zero-length row averages V over all T keys
    zero = np.flatnonzero(lens == 0)
    for n in zero:
        np.testing.assert_allclose(got[n], np.broadcast_to(
            v[n].mean(0), (T, d)), atol=1e-5)


def test_attention_plain_matches_pallas_interpret(monkeypatch):
    from ctts_tpu.ops import attention as j_attn
    monkeypatch.setattr(j_attn, "_INTERPRET", True)
    rng = np.random.RandomState(7)
    N, T, d = 2, 128, 64
    q, k, v = _qkv(rng, N, T, d)
    lens = np.asarray([93, 0], np.int32)
    want = np.asarray(j_attn.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = t_attn.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,N,M,F", [(4, 104, 256, 64), (2, 16, 64, 8)])
def test_gather_plain_matches_pallas_interpret(G, N, M, F, dtype,
                                               monkeypatch):
    from ctts_tpu.ops import sort_gather as j_sg
    monkeypatch.setattr(j_sg, "_INTERPRET", True)
    rng = np.random.RandomState(G + N)
    vals = rng.randn(G, N, F).astype(np.float32)
    idx = rng.randint(0, N, (G, M)).astype(np.int32)
    assert j_sg.supported(N, M, F)
    jv = jnp.asarray(vals, getattr(jnp, dtype))
    want = np.asarray(j_sg.gather_rows(jv, jnp.asarray(idx)).astype(
        jnp.float32))
    got = t_sg.gather_rows(torch.from_numpy(vals).to(getattr(torch, dtype)),
                           torch.from_numpy(idx)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_out_of_range_rows_are_zero(monkeypatch):
    # the Pallas one-hot gather (and the CUDA kernel) give a zero row for
    # an index outside [0, N); the plain version keeps that contract
    from ctts_tpu.ops import sort_gather as j_sg
    monkeypatch.setattr(j_sg, "_INTERPRET", True)
    rng = np.random.RandomState(3)
    G, N, M, F = 2, 16, 64, 8
    vals = rng.randn(G, N, F).astype(np.float32)
    idx = rng.randint(0, N, (G, M)).astype(np.int32)
    idx[0, :4] = [-1, N, N + 3, -7]
    idx[1, -2:] = [N, -1]
    want = np.asarray(j_sg.gather_rows(jnp.asarray(vals), jnp.asarray(idx)))
    got = t_sg.gather_rows(torch.from_numpy(vals),
                           torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, :4].any() and not got[1, -2:].any()


class _OnCuda:
    """A CPU tensor that reports a CUDA device: enough for the wrappers'
    dispatch and checks, which run before any device work."""

    device = torch.device("cuda")

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


class _KernelReached(Exception):
    pass


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA input reached the plain version")


def _to_kernel():
    raise _KernelReached


def test_cuda_inputs_never_reach_plain_versions(monkeypatch):
    monkeypatch.setattr(t_attn, "attention_plain", _no_plain)
    monkeypatch.setattr(t_attn, "_lib", _to_kernel)
    monkeypatch.setattr(t_sg, "gather_rows_plain", _no_plain)
    monkeypatch.setattr(t_sg, "_lib", _to_kernel)
    q = _OnCuda(torch.zeros(2, 16, 64))
    lens = _OnCuda(torch.full((2,), 16, dtype=torch.int32))
    with pytest.raises(_KernelReached):
        t_attn.fused_attention(q, q, q, lens)
    vals = _OnCuda(torch.zeros(2, 5, 8))
    idx = _OnCuda(torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(_KernelReached):
        t_sg.gather_rows(vals, idx)
    # shapes and dtypes the kernels do not take raise before any launch (a
    # width past the widest instance; narrower ones are zero-padded)
    bad_d = _OnCuda(torch.zeros(2, 16, 264))
    with pytest.raises(ValueError):
        t_attn.fused_attention(bad_d, bad_d, bad_d, lens)
    half = _OnCuda(torch.zeros(2, 16, 64, dtype=torch.float16))
    with pytest.raises(TypeError):
        t_attn.fused_attention(half, half, half, lens)
    with pytest.raises(TypeError):
        t_sg.gather_rows(vals, _OnCuda(torch.zeros(2, 3, dtype=torch.int64)))


def test_cuda_inputs_of_the_training_kernels_never_reach_plain(monkeypatch):
    from ctts_torch.ops import forward_sum as t_fs
    from ctts_torch.ops import mas as t_mas
    for mod, plains in ((t_sg, ("scatter_rows_plain",)),
                        (t_mas, ("b_mas_plain", "_mas_from_log")),
                        (t_fs, ("ctc_alpha_plain", "ctc_beta_plain",
                                "ctc_grad_plain"))):
        for name in plains:
            monkeypatch.setattr(mod, name, _no_plain)
        monkeypatch.setattr(mod, "_lib", _to_kernel)
    vals = _OnCuda(torch.zeros(2, 3, 8))
    idx = _OnCuda(torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(_KernelReached):
        t_sg.scatter_rows(vals, idx, 5)
    attn = _OnCuda(torch.full((2, 6, 3), 1 / 3))
    lens = _OnCuda(torch.tensor([3, 2], dtype=torch.int32))
    with pytest.raises(_KernelReached):
        t_mas.b_mas(attn, lens, lens)
    em = _OnCuda(torch.zeros(2, 6, 7))
    with pytest.raises(_KernelReached):
        t_fs.ctc_lattice(em, lens, lens)
    z = _OnCuda(torch.zeros(2))
    with pytest.raises(_KernelReached):
        t_fs.ctc_grad(em, em, z, z, lens)
    # dtypes and shapes the kernels do not take raise before any launch
    long_lens = _OnCuda(torch.tensor([3, 2]))
    with pytest.raises(TypeError):
        t_mas.b_mas(attn, long_lens, lens)
    with pytest.raises(TypeError):
        t_fs.ctc_lattice(em, lens, long_lens)
    with pytest.raises(TypeError):
        t_fs.ctc_lattice(_OnCuda(torch.zeros(2, 6, 7, dtype=torch.bfloat16)),
                         lens, lens)
    with pytest.raises(ValueError):
        t_fs.ctc_lattice(_OnCuda(torch.zeros(2, 6)), lens, lens)
    # past 1024 states the wide instance takes the lattice
    with pytest.raises(_KernelReached):
        t_fs.ctc_lattice(_OnCuda(torch.zeros(2, 6, 1025)), lens, lens)
    with pytest.raises(_KernelReached):
        t_mas.b_mas(_OnCuda(torch.full((2, 6, 1100), 1 / 1100)), lens, lens)
    with pytest.raises(TypeError):
        t_sg.scatter_rows(_OnCuda(torch.zeros(2, 3, 8, dtype=torch.float16)),
                          idx, 5)


def test_kernel_build_is_lazy_and_named_by_content():
    # importing the ops built nothing; the one library's name hashes every
    # source, and it lands in the gitignored build directory of the checkout
    import os
    assert kernels.LIBRARY._lib is None
    target = kernels.LIBRARY.target()
    assert target.endswith(".so") and "libctts_kernels_" in target
    assert os.path.dirname(target) == kernels.BUILD_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert kernels.BUILD_DIR == os.path.join(repo, "build", "ctts_torch")
    assert kernels.SOURCES == ("attention.cu", "gather_rows.cu",
                               "scatter_rows.cu", "mas.cu", "forward_sum.cu",
                               "relpos_attention.cu",
                               "local_window_attention.cu",
                               "lsh_chunk_attention.cu", "fused_resblock.cu",
                               "bench_flip.cu", "barrier_chain.cu")
    assert kernels.HEADERS == ("window_attention.cuh",)
    for src in kernels.SOURCES + kernels.HEADERS:
        assert os.path.isfile(os.path.join(repo, "ctts_torch", "csrc", src))
