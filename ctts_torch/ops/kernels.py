"""Build and load the hand-written CUDA kernels of ``ctts_torch/csrc/``.

The sources have a plain C interface and make up one shared library for
``sm_90a``, loaded with ``ctypes``. The build happens at first use, never
at import, into ``build/ctts_torch/`` at the root of the checkout (listed
in ``.gitignore``): one ``nvcc -c`` per source, all started together, then
one link. The library's file name carries a hash of the sources, headers
and flags, so an edited source is rebuilt and an unchanged tree reuses its
library.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ctts_torch")
SOURCES = ("attention.cu", "gather_rows.cu", "scatter_rows.cu", "mas.cu",
           "forward_sum.cu", "relpos_attention.cu",
           "local_window_attention.cu", "lsh_chunk_attention.cu",
           "fused_resblock.cu", "bench_flip.cu", "barrier_chain.cu")
HEADERS = ("window_attention.cuh",)       # included by sources; hashed too
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


class KernelLibrary:
    """The kernel library of one process, built and loaded on first use."""

    def __init__(self):
        self._lib = None
        self.build_seconds = None     # wall time of build(); ~0 if reused
        self.ptxas_log = ""           # nvcc's resource report per source

    @staticmethod
    def target():
        digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES + HEADERS:
            with open(os.path.join(_CSRC, src), "rb") as f:
                digest.update(f.read())
        return os.path.join(BUILD_DIR,
                            f"libctts_kernels_{digest.hexdigest()[:12]}.so")

    def build(self):
        """Compile the library unless it exists; return its path. Raises
        with nvcc's output on a failure."""
        t0 = time.perf_counter()
        target = self.target()
        if not os.path.isfile(target):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
                objs = [os.path.join(work, src + ".o") for src in SOURCES]
                procs = [subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                     os.path.join(_CSRC, src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True) for src, obj in zip(SOURCES, objs)]
                logs = [(src, p.communicate()[0], p.returncode)
                        for src, p in zip(SOURCES, procs)]
                self.ptxas_log = "".join(f"--- {src}\n{out}"
                                         for src, out, _ in logs)
                if any(rc != 0 for _, _, rc in logs):
                    raise RuntimeError("CUDA kernel build failed:\n"
                                       + self.ptxas_log)
                tmp = os.path.join(work, "lib.so")
                res = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", tmp,
                                      *objs], capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError("CUDA kernel link failed:\n"
                                       + res.stdout + res.stderr)
                os.replace(tmp, target)
        self.build_seconds = time.perf_counter() - t0
        return target

    def get(self):
        """The loaded ctypes library, building it if needed."""
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            lib.ctts_strerror.argtypes = [ctypes.c_int]
            lib.ctts_strerror.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


LIBRARY = KernelLibrary()


def barrier_chain(out, blocks, threads, frames):
    """One launch of ``csrc/barrier_chain.cu``'s barrier chain into ``out``
    [blocks, threads] float32 on the card: ``frames`` dependent frames of
    one block-wide barrier and a shared-memory round trip. The floor that
    one barrier a frame sets for a chain kernel at that shape."""
    import torch
    lib = LIBRARY.get()
    fn = lib.ctts_barrier_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    check(fn(out.data_ptr(), blocks, threads, frames,
             torch.cuda.current_stream().cuda_stream), lib, "barrier_chain")


def warp_chain(out, blocks, frames, k):
    """One launch of ``csrc/barrier_chain.cu``'s warp chain into ``out``
    [blocks, 32] float32 on the card: one warp a block, ``k`` columns a
    lane, ``frames`` + 31 skewed steps of one shuffle and compare, select
    and add on each column. The floor that the chain warp of
    ``csrc/mas.cu`` sets at that shape."""
    import torch
    lib = LIBRARY.get()
    fn = lib.ctts_warp_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    check(fn(out.data_ptr(), blocks, frames, k,
             torch.cuda.current_stream().cuda_stream), lib, "warp_chain")


def cluster_chain(out, chains, ctas, threads, frames, span):
    """One launch of ``csrc/barrier_chain.cu``'s cluster chain into ``out``
    [chains * ctas, threads] float32 on the card: ``chains`` clusters of
    ``ctas`` CTAs, ``frames`` dependent frames, each a ``__syncthreads()``
    with one st.async handoff to the next CTA every ``span`` frames
    (``span`` 0: one DSMEM store and one cluster barrier a frame). The
    floor that the handoff sets for the cluster lattice of
    ``csrc/forward_sum.cu`` at that shape."""
    import torch
    lib = LIBRARY.get()
    fn = lib.ctts_cluster_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    check(fn(out.data_ptr(), chains, ctas, threads, frames, span,
             torch.cuda.current_stream().cuda_stream), lib, "cluster_chain")


def _event_ms(launch, iters):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(iters + 3):
        if i == 3:
            start.record()
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def barrier_chain_ms(blocks, threads, frames, iters=20):
    """CUDA-event milliseconds of one :func:`barrier_chain` launch."""
    import torch
    out = torch.empty(blocks, threads, device="cuda")
    return _event_ms(lambda: barrier_chain(out, blocks, threads, frames),
                     iters)


def check(err, lib, what):
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        msg = lib.ctts_strerror(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch_counts():
    """Kernel launches since the counters were last reset, by kernel name
    (each wrapper counts its own; the counters are plain module ints)."""
    from ctts_torch.ops import (attention, flip, forward_sum, fused_resblock,
                                local_window_attention, lsh_chunk_attention,
                                mas, relpos_attention, sort_gather)
    return {"fused_attention": attention.launches,
            "gather_rows": sort_gather.launches,
            "scatter_rows": sort_gather.scatter_launches,
            "b_mas": mas.launches,
            "b_mas_rows": mas.rows_launches,
            "b_mas_dev": mas.dev_launches,
            "b_mas_wide": mas.wide_launches,
            "ctc_lattice": forward_sum.lattice_launches,
            "ctc_lattice_cluster": forward_sum.cluster_lattice_launches,
            "ctc_grad": forward_sum.grad_launches,
            "relpos_fwd": relpos_attention.launches,
            "relpos_bwd": relpos_attention.bwd_launches,
            "local_window_fwd": local_window_attention.launches,
            "local_window_bwd": local_window_attention.bwd_launches,
            "lsh_chunk_fwd": lsh_chunk_attention.launches,
            "lsh_chunk_bwd": lsh_chunk_attention.bwd_launches,
            "fused_resblock": fused_resblock.launches,
            "bench_flip": flip.launches}


def reset_launch_counts():
    from ctts_torch.ops import (attention, flip, forward_sum, fused_resblock,
                                local_window_attention, lsh_chunk_attention,
                                mas, relpos_attention, sort_gather)
    attention.launches = sort_gather.launches = 0
    sort_gather.scatter_launches = mas.launches = mas.rows_launches = 0
    mas.dev_launches = mas.wide_launches = 0
    forward_sum.lattice_launches = forward_sum.grad_launches = 0
    forward_sum.cluster_lattice_launches = 0
    relpos_attention.launches = relpos_attention.bwd_launches = 0
    local_window_attention.launches = local_window_attention.bwd_launches = 0
    lsh_chunk_attention.launches = lsh_chunk_attention.bwd_launches = 0
    fused_resblock.launches = flip.launches = 0
