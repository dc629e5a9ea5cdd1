"""HiFi-GAN ResBlock1 chain, fused (ctts_tpu/ops/fused_resblock.py).

A ResBlock1 is, per dilation d (1, 3, 5 in HiFi-GAN V1):
``x = x + conv_k1(lrelu(conv_kd(lrelu(x))))``, every conv zero-padded at the
sequence edges. :func:`fused_resblock1` runs the whole six-conv chain on the
card in one launch of ``csrc/fused_resblock.cu`` (one read of x, one write
of the output; the intermediates stay in shared memory; every conv an
implicit GEMM on the tensor cores); on the CPU it runs
:func:`reference_resblock1`, the plain version. Forward only: the vocoder
is never trained, and the JAX package has no VJP for its kernel either.

Layout: x is ``[N, C, T]`` (the port's channels-first layout). Each conv
stack comes as ``(w, b)``: ``w [n_dil, k, C_in, C_out]`` float32 holding
values of the compute dtype (the JAX package's ``WIO`` layout), ``b [n_dil,
C]`` float32; :func:`stack_convs` builds it from a ``ModuleList`` of
``Conv1d``. The kernel reads the two stacks as :func:`pack_weights` lays
them out, which a caller may do once and pass as ``packed``.

Rounding (kernel and plain alike): the compute dtype is x's; each leaky
ReLU is rounded to it, each conv sums in float32, adds the float32 bias and
rounds, and the residual adds two compute-dtype values and rounds once.
In float32 the kernel's products are the three bf16 terms hi·hi + hi·lo +
lo·hi of each operand's split, within ~2^-16 of the float32 product.
The JAX reference rounds the same places, but multiplies by the slope
rounded to the compute dtype (``bf16(0.1)``) where torch's ``leaky_relu``
multiplies by 0.1 in float32; the two agree exactly in float32.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ctts_torch.ops import kernels

LRELU = 0.1
KERNEL_SIZES = (3, 7, 11)
MAX_DILATIONS = 4
CHANNEL_MULTIPLE = 16
# The kernel's geometry (csrc/fused_resblock.cu; tests/
# test_torch_resblock_tiles.py holds these to the source): dynamic shared
# memory a block may take, warps of a block, slack rows past each buffer,
# weight stages in the ring, and per compute dtype the m-tiles of 16 rows a
# warp tile holds, the weight planes (float32: hi and lo) and the padding
# of an activation row in bytes
SMEM_LIMIT = 232448
WARPS = 12
SLACK = 15
STAGES = 2
MT = {torch.bfloat16: 4, torch.float32: 2}
PLANES = {torch.bfloat16: 1, torch.float32: 2}
ROW_PAD = {torch.bfloat16: 16, torch.float32: 32}
# cost of a round beyond its m-tiles, in m-tiles (its B loads, barriers and
# epilogue), for the choice of the tile length
ROUND_COST = 0.5

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


def n_tiles(channels):
    """n-tiles (8 output channels each) of a warp tile: 8 where C is a
    multiple of 64, else 4 or 2."""
    return 8 if channels % 64 == 0 else 4 if channels % 32 == 0 else 2


def ci_chunk(channels, dtype):
    """Input channels of one weight stage (kc): in bf16 64 where C is a
    multiple of 64, else 32 or 16; float32 (two weight planes) 32 or 16."""
    if PLANES[dtype] == 1 and channels % 64 == 0:
        return 64
    return 32 if channels % 32 == 0 else 16


def pack_weights(convs1, convs2, dtype):
    """The two stacks as the kernel reads them: ``(w, b)`` with ``w``
    bf16 ``[n_dil, 2, k, C/kc, planes, C_out, kc]`` (per conv of the chain,
    tap and chunk of kc input channels, one contiguous weight stage; for
    float32 the planes are hi = bf16(w) and lo = bf16(w − hi)) and ``b``
    float32 ``[n_dil, 2, C]``."""
    (w1, b1), (w2, b2) = convs1, convs2
    w = torch.stack([w1, w2], 1).float()              # [n, 2, k, Cin, Cout]
    n, _, k, C, _ = w.shape
    kc = ci_chunk(C, dtype)
    w = w.transpose(3, 4).reshape(n, 2, k, C, C // kc, kc).transpose(3, 4)
    hi = w.to(torch.bfloat16)
    planes = [hi] if dtype == torch.bfloat16 else [
        hi, (w - hi.float()).to(torch.bfloat16)]
    return (torch.stack(planes, 4).contiguous(),
            torch.stack([b1, b2], 1).float().contiguous())


def geometry(channels, dtype, kernel_size, dilations, block_t):
    """What the kernel lays out for one block of ``block_t`` output samples,
    as its launcher computes it: the output rows and rounds of each conv of
    the chain, and the dynamic shared memory in bytes (X and Y, each with
    its slack rows, and the ring of weight stages)."""
    p = (kernel_size - 1) // 2
    esize = torch.finfo(dtype).bits // 8
    row = channels * esize + ROW_PAD[dtype]
    stage = PLANES[dtype] * channels * (ci_chunk(channels, dtype) * 2 + 16)
    groups = channels // (8 * n_tiles(channels))
    if groups > WARPS:                  # more channel groups than warps
        return {"smem": float("inf")}
    cap = WARPS // groups * MT[dtype]
    length = block_t + 2 * chain_halo(kernel_size, dilations)
    rows, lout = length + SLACK, []             # of X and of Y
    for d in dilations:
        lout += [length - 2 * d * p, length - 2 * d * p - 2 * p]
        length = lout[-1]
    rounds = [-(-((n + 15) // 16) // cap) for n in lout]
    smem = 2 * rows * row + STAGES * stage
    return {"lout": lout, "rounds": rounds, "smem": smem,
            "row_groups": WARPS // groups, "cap": cap}


def block_cost(channels, dtype, kernel_size, dilations, block_t):
    """The kernel's time per output sample, in m-tile steps of a row group:
    each round of a conv deals its m-tiles to the row groups in runs of
    ceil(m-tiles / row groups), and costs its longest run plus
    :data:`ROUND_COST`."""
    geo = geometry(channels, dtype, kernel_size, dilations, block_t)
    steps = 0.0
    for n, rounds in zip(geo["lout"], geo["rounds"]):
        left = -(-n // 16)
        for _ in range(rounds):
            now = min(left, geo["cap"])
            steps += -(-now // geo["row_groups"]) + ROUND_COST
            left -= now
    return steps / block_t


@functools.lru_cache(maxsize=None)
def block_t_for(channels, dtype, kernel_size, dilations, block_t=1024):
    """The output samples per block: of the multiples of 16 up to
    ``block_t`` whose buffers fit :data:`SMEM_LIMIT`, the one of least
    :func:`block_cost` (a longer tile recomputes less halo but may leave
    warps idle in a conv's last round). Raises if none fits. Kept per
    shape: the search takes about a millisecond of host time."""
    best = None
    for bt in range(16, max(int(block_t), 16) + 1, 16):
        if geometry(channels, dtype, kernel_size, dilations,
                    bt)["smem"] > SMEM_LIMIT:
            break
        cost = block_cost(channels, dtype, kernel_size, dilations, bt)
        if best is None or cost <= best[0]:
            best = (cost, bt)
    if best is None:
        raise ValueError(f"fused_resblock1: C={channels} {dtype} k="
                         f"{kernel_size} dilations {tuple(dilations)} do not "
                         f"fit a block's shared memory")
    return best[1]


def _lib():
    lib = kernels.LIBRARY.get()
    fn = lib.ctts_fused_resblock1
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, convs1, convs2, kernel_size, dilations, packed):
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
            if t.dtype != torch.float32 or t.device != x.device:
                raise ValueError("fused_resblock1 takes float32 weights and "
                                 "biases on x's device")
    if packed is not None:
        w, b = packed
        kc = ci_chunk(C, x.dtype)
        want = ((n, 2, kernel_size, C // kc, PLANES[x.dtype], C, kc),
                (n, 2, C))
        if ((tuple(w.shape), tuple(b.shape)) != want
                or (w.dtype, b.dtype) != (torch.bfloat16, torch.float32)
                or w.device != x.device or b.device != x.device
                or not (w.is_contiguous() and b.is_contiguous())):
            raise ValueError(f"fused_resblock1 takes packed weights as "
                             f"pack_weights lays them out for {x.dtype}: "
                             f"{want}")


def fused_resblock1(x, convs1, convs2, kernel_size, dilations=(1, 3, 5),
                    block_t=1024, packed=None):
    """The ResBlock1 chain on x ``[N, C, T]``: the CUDA kernel for a CUDA
    tensor (it raises on what the kernel does not take), the plain version
    for a CPU tensor. ``block_t`` caps the output samples per block; the
    kernel takes any T. ``packed`` is :func:`pack_weights` of the two stacks
    in x's dtype, made here when not given."""
    global launches
    dilations = tuple(int(d) for d in dilations)
    if x.device.type == "cpu":
        return reference_resblock1(x, convs1, convs2, kernel_size, dilations)
    _check(x, convs1, convs2, kernel_size, dilations, packed)
    N, C, T = x.shape
    bt = block_t_for(C, x.dtype, kernel_size, dilations, int(block_t))
    w, b = packed if packed is not None else pack_weights(convs1, convs2,
                                                          x.dtype)
    lib = _lib()
    out = torch.empty_like(x)
    dil = (ctypes.c_int * len(dilations))(*dilations)
    err = lib.ctts_fused_resblock1(
        x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), N, C, T,
        kernel_size, dil, len(dilations), bt, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, lib, "fused_resblock1")
    launches += 1
    return out
