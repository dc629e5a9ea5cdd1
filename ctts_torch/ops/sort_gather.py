"""Batched row gather and scatter-add (ctts_tpu/ops/sort_gather.py:145-185,
``gather_rows`` and ``scatter_rows``).

On the card ``gather_rows`` launches ``csrc/gather_rows.cu`` and
``scatter_rows`` launches ``csrc/scatter_rows.cu`` (a plan of each row's
sources, then a walk of the rows); on the CPU they run
:func:`gather_rows_plain` and :func:`scatter_rows_plain`. The gather is
exact; the scatter accumulates in float32 in a fixed order (a row's sources
in ascending source order; a long row is cut into parts, one per warp of
a block, added in warp order), so it is exact for a permutation and
deterministic for any index. Each is the other's backward (two
``torch.autograd.Function``s), so the length regulator's upsample
back-propagates through the scatter kernel.
"""

import ctypes

import torch

from ctts_torch.ops import kernels

# kernel launches since the last reset (read by chip_smoke.py): the gather
# and the scatter
launches = 0
scatter_launches = 0

_SCATTER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the walk's warps a block (csrc/scatter_rows.cu kWalkWarps), and the
# sources a warp of it should hold on average: a block takes that many
# output rows' worth of sources
WALK_WARPS = 16
SOURCES_PER_WARP = 2


def walk_rows_per_block(m, n_out):
    """Output rows of one walk block: about ``WALK_WARPS ·
    SOURCES_PER_WARP`` sources at the mean ``m / n_out`` a row."""
    return max(1, min(n_out, round(WALK_WARPS * SOURCES_PER_WARP * n_out
                                   / max(m, 1))))


def gather_rows_plain(values, idx):
    """values [G, N, F], idx [G, M] → [G, M, F]; an index outside [0, N)
    gives a zero row."""
    idx = idx.long()
    inside = (idx >= 0) & (idx < values.shape[1])
    rows = torch.take_along_dim(
        values, torch.where(inside, idx, 0)[..., None], dim=1)
    return torch.where(inside[..., None], rows, rows.new_zeros(()))


def scatter_rows_plain(values, idx, n_out):
    """values [G, M, F], idx [G, M] → [G, n_out, F] with
    out[g, idx[g, m]] += values[g, m], summed in float32 and returned in
    ``values``' dtype; an index outside [0, n_out) adds nothing."""
    G, M, F = values.shape
    idx = idx.long()
    inside = (idx >= 0) & (idx < n_out)
    # out-of-range rows land in a spare row that is cut off
    idx = torch.where(inside, idx, n_out)[..., None].expand(G, M, F)
    out = torch.zeros(G, n_out + 1, F, dtype=torch.float32,
                      device=values.device)
    out.scatter_add_(1, idx, values.float())
    return out[:, :n_out].to(values.dtype)


def _lib():
    lib = kernels.LIBRARY.get()
    fn = lib.ctts_gather_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.ctts_scatter_rows
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 5 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, values, idx):
    if values.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {values.device}")
    if values.dim() != 3 or idx.dim() != 2 or idx.shape[0] != values.shape[0]:
        raise ValueError(f"{name} takes values [G, ., F] and idx [G, M], got "
                         f"{tuple(values.shape)}, {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 idx, got {idx.dtype}")
    if idx.device != values.device:
        raise ValueError("values and idx must be on one device")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def _gather(values, idx):
    global launches
    if values.device.type == "cpu":
        return gather_rows_plain(values, idx)
    _check("gather_rows", values, idx)
    G, N, F = values.shape
    M = idx.shape[1]
    lib = _lib()
    out = values.new_empty((G, M, F))
    err = lib.ctts_gather_rows(
        values.data_ptr(), idx.data_ptr(), out.data_ptr(), G, N, M,
        F * values.element_size(),
        torch.cuda.current_stream(values.device).cuda_stream)
    kernels.check(err, lib, "gather_rows")
    launches += 1
    return out


def _scatter(values, idx, n_out):
    global scatter_launches
    if values.device.type == "cpu":
        return scatter_rows_plain(values, idx, n_out)
    _check("scatter_rows", values, idx)
    if values.dtype not in _SCATTER_DTYPES:
        raise TypeError(f"scatter_rows takes float32 or bfloat16 values, got "
                        f"{values.dtype}")
    if idx.shape[1] != values.shape[1]:
        raise ValueError(f"scatter_rows takes one index per row of values, "
                         f"got {tuple(values.shape)}, {tuple(idx.shape)}")
    G, M, F = values.shape
    lib = _lib()
    out = values.new_empty((G, n_out, F))
    # the plan's scratch: each row's first source, and the sources by row
    starts = idx.new_empty((G, n_out + 1))
    src = idx.new_empty((G, M))
    err = lib.ctts_scatter_rows(
        values.data_ptr(), idx.data_ptr(), out.data_ptr(), starts.data_ptr(),
        src.data_ptr(), G, M, n_out, F, walk_rows_per_block(M, n_out),
        _SCATTER_DTYPES[values.dtype],
        torch.cuda.current_stream(values.device).cuda_stream)
    kernels.check(err, lib, "scatter_rows")
    scatter_launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.n_src = values.shape[1]
        return _gather(values, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return _ScatterRows.apply(grad.contiguous(), idx, ctx.n_src), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, n_out):
        ctx.save_for_backward(idx)
        return _scatter(values, idx, n_out)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return _GatherRows.apply(grad.contiguous(), idx), None, None


def gather_rows(values, idx):
    """values [G, N, F], idx [G, M] int32 → [G, M, F]
    (out[g, m] = values[g, idx[g, m]]). An index outside [0, N) gives a
    zero row on either device, as the one-hot gather of the JAX package
    does. Its backward is :func:`scatter_rows`."""
    return _GatherRows.apply(values, idx)


def scatter_rows(values, idx, n_out):
    """values [G, M, F], idx [G, M] int32 → [G, n_out, F]
    (out[g, idx[g, m]] += values[g, m]), accumulated in float32; an index
    outside [0, n_out) adds nothing. Its backward is :func:`gather_rows`."""
    return _ScatterRows.apply(values, idx, n_out)
