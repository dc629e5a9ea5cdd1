"""The relpos backward's absolute-to-relative scatter in the four forms of
tools/bench_flip.py, as one CUDA kernel and its plain version.

The TPU tool times how a Pallas kernel can express a per-row roll whose
amount descends with the row (``pltpu.roll`` takes only ascending strides):
a no-scatter baseline, a row flip, a lane reversal and a roll ladder, each
followed by the fold ``out[c] = dW[c] + dW[c + T + 1]``. On the card every
variant is the same indexed copy with its own index arithmetic:
:func:`flip` launches ``csrc/bench_flip.cu`` with the variant as an argument
(:func:`flip_plain` on the CPU), and :func:`flip_plain` is the plain
version by index arithmetic. ``python -m ctts_torch.tools.bench_flip``
times it.
"""

import ctypes

import torch

from ctts_torch.ops import kernels

BQ = 128
VARIANTS = ("baseline", "row_flip", "lane_rev", "ladder")

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def wpad_for(t):
    """The padded lane width of the TPU tool: 2T+1 rounded up to 128."""
    return (2 * t + 1 + 127) // 128 * 128


def flip_indices(t, bq, variant, device=None):
    """For output [q, c]: the source row [t], the two source columns
    [t, t] and whether each lies inside the row (a position at or past t of
    the padded row holds 0)."""
    wpad = wpad_for(t)
    q = torch.arange(t, device=device)
    q0, r = q - q % bq, q % bq
    if variant == "row_flip":
        src, shift = q0 + bq - 1 - r, t - bq - q0 + r
    elif variant == "ladder":
        src, shift = q, (t - 1 - q0) - r
        shift = torch.where(shift < 0, shift + wpad, shift)
    elif variant in ("baseline", "lane_rev"):
        src, shift = q, q0 + 1 + r
    else:
        raise ValueError(f"unknown variant {variant!r}")
    c = torch.arange(t, device=device)[None, :]
    cols, inside = [], []
    for m in ((c - shift[:, None]) % wpad,
              (c + t + 1 - shift[:, None]) % wpad):
        ok = m < t
        if variant == "lane_rev":
            m = t - 1 - m
        cols.append(torch.where(ok, m, 0))
        inside.append(ok)
    return src, cols, inside


def flip_plain(x, variant, bq=BQ):
    """The variant's output on x [N, t, t] bf16, by index arithmetic:
    out[n, q, c] = bf16(W[m1] + W[m2]) summed in float32."""
    n, t, _ = x.shape
    src, cols, inside = flip_indices(t, bq, variant, x.device)
    rows = x[:, src]
    out = torch.zeros(n, t, t, dtype=torch.float32, device=x.device)
    for m, ok in zip(cols, inside):
        vals = torch.gather(rows, 2, m.expand(n, t, t)).float()
        out += torch.where(ok, vals, vals.new_zeros(()))
    return out.to(torch.bfloat16)


def _lib():
    lib = kernels.LIBRARY.get()
    fn = lib.ctts_bench_flip
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flip(x, variant, bq=BQ):
    """The variant on x [N, t, t] bf16: ``csrc/bench_flip.cu`` for a CUDA
    tensor (it raises on what the kernel does not take), the plain version
    for a CPU tensor."""
    global launches
    if x.device.type == "cpu":
        return flip_plain(x, variant, bq)
    if x.device.type != "cuda":
        raise ValueError(f"flip runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 3 or \
            x.shape[1] != x.shape[2] or not x.is_contiguous():
        raise ValueError(f"flip takes a contiguous bf16 x [N, T, T], got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, t, _ = x.shape
    if t % bq:
        raise ValueError(f"flip takes T a multiple of BQ, got {t}, {bq}")
    lib = _lib()
    out = torch.empty_like(x)
    err = lib.ctts_bench_flip(x.data_ptr(), out.data_ptr(), n, t, bq,
                              wpad_for(t), VARIANTS.index(variant),
                              torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, lib, "bench_flip")
    launches += 1
    return out
