"""HiFi-GAN ResBlock1 chain, fused (ctts_tpu/ops/fused_resblock.py).

A ResBlock1 is, per dilation d (1, 3, 5 in HiFi-GAN V1):
``x = x + conv_k1(lrelu(conv_kd(lrelu(x))))``, every conv zero-padded at the
sequence edges. :func:`fused_resblock1` runs the whole six-conv chain on the
card in one launch of ``csrc/fused_resblock.cu`` (one read of x, one write
of the output; the intermediates stay in shared memory); on the CPU it runs
:func:`reference_resblock1`, the plain version. Forward only: the vocoder
is never trained, and the JAX package has no VJP for its kernel either.

Layout: x is ``[N, C, T]`` (the port's channels-first layout). Each conv
stack comes as ``(w, b)``: ``w [n_dil, k, C_in, C_out]`` float32 holding
values of the compute dtype (the JAX package's ``WIO`` layout, which the
kernel reads), ``b [n_dil, C]`` float32; :func:`stack_convs` builds it from
a ``ModuleList`` of ``Conv1d``.

Rounding (kernel and plain alike): the compute dtype is x's; each leaky
ReLU is rounded to it, each conv sums in float32, adds the float32 bias and
rounds, and the residual adds two compute-dtype values and rounds once.
The JAX reference rounds the same places, but multiplies by the slope
rounded to the compute dtype (``bf16(0.1)``) where torch's ``leaky_relu``
multiplies by 0.1 in float32; the two agree exactly in float32.
"""

import ctypes

import torch
import torch.nn.functional as F

from ctts_torch.ops import kernels

LRELU = 0.1
# shared memory a block may take for its two activation buffers (the card
# has 227 KB a block; the rest is left to the compiler)
SMEM_BUDGET = 200 * 1024
KERNEL_SIZES = (3, 7, 11)
MAX_DILATIONS = 4
CHANNEL_MULTIPLE = 16

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chain_halo(kernel_size, dilations):
    """Samples a side that the whole chain reads beyond its output:
    sum_d (d·p + p) with p = (k−1)/2 (12, 36, 60 for k = 3, 7, 11)."""
    p = (kernel_size - 1) // 2
    return sum(d * p + p for d in dilations)


def stack_convs(convs, dtype):
    """A ``ModuleList`` of ``Conv1d(C, C, k)`` → ``(w, b)``:
    ``w [n, k, C_in, C_out]`` float32 with the weights rounded to ``dtype``,
    ``b [n, C]`` float32, both contiguous."""
    w = torch.stack([c.weight.detach().to(dtype).float().permute(2, 1, 0)
                     for c in convs]).contiguous()
    b = torch.stack([c.bias.detach().float() for c in convs]).contiguous()
    return w, b


def reference_resblock1(x, convs1, convs2, kernel_size, dilations=(1, 3, 5)):
    """The plain version of the chain: x ``[N, C, T]`` in its compute dtype,
    ``convs1``/``convs2`` as ``(w, b)`` (see the module docstring). Returns
    ``[N, C, T]`` in x's dtype."""
    cdt = x.dtype
    (w1, b1), (w2, b2) = convs1, convs2
    with torch.autocast(x.device.type, enabled=False):
        def conv(h, w, b, d):
            y = F.conv1d(h.float(), w.permute(2, 1, 0).to(cdt).float(),
                         b.float(), padding=d * (kernel_size - 1) // 2,
                         dilation=d)
            return y.to(cdt)

        for di, d in enumerate(dilations):
            h = F.leaky_relu(x, LRELU)
            y = F.leaky_relu(conv(h, w1[di], b1[di], d), LRELU)
            x = x + conv(y, w2[di], b2[di], 1)
    return x


def block_t_for(channels, dtype, kernel_size, dilations, block_t=1024):
    """The output samples per block: the largest power of two at most
    ``block_t`` whose two activation buffers fit :data:`SMEM_BUDGET`
    (at least 32)."""
    esize = torch.finfo(dtype).bits // 8
    halo = chain_halo(kernel_size, dilations)
    bt = 1 << (max(int(block_t), 1).bit_length() - 1)
    while bt > 32 and 2 * channels * (bt + 2 * halo) * esize > SMEM_BUDGET:
        bt //= 2
    return bt


def _lib():
    lib = kernels.LIBRARY.get()
    fn = lib.ctts_fused_resblock1
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, convs1, convs2, kernel_size, dilations):
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock1 runs on cpu or cuda, not "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_resblock1 takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_resblock1 takes a contiguous x [N, C, T], "
                         f"got {tuple(x.shape)}")
    if kernel_size not in KERNEL_SIZES:
        raise ValueError(f"fused_resblock1 is built for kernel sizes "
                         f"{KERNEL_SIZES}, got {kernel_size}")
    if not 0 < len(dilations) <= MAX_DILATIONS:
        raise ValueError(f"fused_resblock1 takes 1 to {MAX_DILATIONS} "
                         f"dilations, got {dilations}")
    C = x.shape[1]
    if C % CHANNEL_MULTIPLE:
        raise ValueError(f"fused_resblock1 takes channels in multiples of "
                         f"{CHANNEL_MULTIPLE}, got {C}")
    n = len(dilations)
    for w, b in (convs1, convs2):
        if (tuple(w.shape) != (n, kernel_size, C, C)
                or tuple(b.shape) != (n, C)):
            raise ValueError(f"fused_resblock1 takes w [{n}, {kernel_size}, "
                             f"{C}, {C}] and b [{n}, {C}], got "
                             f"{tuple(w.shape)}, {tuple(b.shape)}")
        for t in (w, b):
            if (t.dtype != torch.float32 or t.device != x.device
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError("fused_resblock1 takes float32 weights and "
                                 "biases, contiguous, 16-byte aligned, on "
                                 "x's device")


def fused_resblock1(x, convs1, convs2, kernel_size, dilations=(1, 3, 5),
                    block_t=1024):
    """The ResBlock1 chain on x ``[N, C, T]``: the CUDA kernel for a CUDA
    tensor (it raises on what the kernel does not take), the plain version
    for a CPU tensor. ``block_t`` caps the output samples per block; the
    kernel takes any T."""
    global launches
    dilations = tuple(int(d) for d in dilations)
    if x.device.type == "cpu":
        return reference_resblock1(x, convs1, convs2, kernel_size, dilations)
    _check(x, convs1, convs2, kernel_size, dilations)
    N, C, T = x.shape
    bt = block_t_for(C, x.dtype, kernel_size, dilations, block_t)
    (w1, b1), (w2, b2) = convs1, convs2
    lib = _lib()
    out = torch.empty_like(x)
    dil = (ctypes.c_int * len(dilations))(*dilations)
    err = lib.ctts_fused_resblock1(
        x.data_ptr(), out.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), N, C, T, kernel_size, dil,
        len(dilations), bt, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, lib, "fused_resblock1")
    launches += 1
    return out
