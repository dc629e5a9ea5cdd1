"""ctypes binding of the threaded C++ ``.npy`` reader (native/npy_loader.cc),
with the API of ctts_tpu/data/native_loader.py.

:class:`NativePrefetcher` reads a batch of feature files on a C++ worker
pool and supports submit-ahead: ``submit`` returns at once and ``fetch``
waits for the files. A file the reader rejects (Fortran order, big-endian,
a dtype it does not take, corrupt or missing) comes back as ``None``.

The shared library is built at first use (:func:`build`, which the
port's ``Dataset`` calls), never at import, from ``native/npy_loader.cc``
with the host compiler and the flags of ``native/Makefile``, into
``build/ctts_torch/`` at the root of the checkout (listed in
``.gitignore``). Its file name carries a hash of the source and the flags,
so an edited source is rebuilt. Where no host compiler exists the port
says so once and the callers read with numpy.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "npy_loader.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "ctts_torch")
# native/Makefile's CXXFLAGS, then its link flag
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64,
           4: np.uint8}
_ITEM = {0: 4, 1: 8, 2: 4, 3: 8, 4: 1}

_lib = None
_said = False                      # the missing compiler reported once
_lock = threading.Lock()


def target():
    """The library's path: a hash of the source and the flags."""
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libctts_io_{digest.hexdigest()[:12]}.so")


def _load(path):
    lib = ctypes.CDLL(path)
    lib.ctts_pool_create.restype = ctypes.c_void_p
    lib.ctts_pool_create.argtypes = [ctypes.c_int]
    lib.ctts_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.ctts_submit.restype = ctypes.c_long
    lib.ctts_submit.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int]
    lib.ctts_job_ready.restype = ctypes.c_int
    lib.ctts_job_ready.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.ctts_array_info.restype = ctypes.c_int
    lib.ctts_array_info.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_long),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.ctts_array_copy.restype = ctypes.c_long
    lib.ctts_array_copy.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_long]
    lib.ctts_job_free.argtypes = [ctypes.c_void_p, ctypes.c_long]
    return lib


def available():
    """True once the library is loaded; loads an existing build, builds
    nothing."""
    global _lib
    with _lock:
        if _lib is None and os.path.isfile(target()):
            _lib = _load(target())
    return _lib is not None


def _compiler():
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def build(verbose=False):
    """Compile the library unless it exists, and load it; returns
    :func:`available`. Without a host compiler, or when the compiler fails,
    says so once on stderr and returns False."""
    global _lib, _said
    if available():
        return True
    cxx = _compiler()
    with _lock:
        if _lib is not None:
            return True
        path = target()
        if cxx is not None and not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                               capture_output=not verbose, text=True)
            if r.returncode == 0:
                os.replace(tmp, path)       # atomic: concurrent builders
            else:
                os.unlink(tmp)
                if not _said:
                    print(f"native .npy loader: {cxx} failed, reading with "
                          f"numpy:\n{r.stderr or ''}", file=sys.stderr)
                    _said = True
        if os.path.isfile(path):
            _lib = _load(path)
        elif cxx is None and not _said:
            print("native .npy loader: no host C++ compiler (g++), reading "
                  "with numpy", file=sys.stderr)
            _said = True
    return _lib is not None


class NativePrefetcher:
    """Submit-ahead batch reader. Usage:

        pf = NativePrefetcher(n_threads=8)
        job = pf.submit(paths)         # returns immediately
        arrays = pf.fetch(job)         # blocks until all files are read
    """

    def __init__(self, n_threads=8):
        if not available():
            raise RuntimeError("native loader not built; call "
                               "native_loader.build() or read with numpy")
        self._lib = _lib
        self._pool = _lib.ctts_pool_create(n_threads)
        self._sizes = {}

    def __del__(self):
        if getattr(self, "_pool", None):
            self._lib.ctts_pool_destroy(self._pool)
            self._pool = None

    def submit(self, paths):
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        job = self._lib.ctts_submit(self._pool, arr, len(paths))
        if job < 0:
            raise RuntimeError("submit failed")
        self._sizes[job] = len(paths)
        return job

    def ready(self, job):
        return self._lib.ctts_job_ready(self._pool, job) == 1

    def fetch(self, job):
        """The job's arrays in submit order; None for a file the reader
        rejected."""
        n = self._sizes.pop(job)
        out = []
        shape = (ctypes.c_long * 8)()
        ndim = ctypes.c_int()
        dtype = ctypes.c_int()
        for i in range(n):
            rc = self._lib.ctts_array_info(self._pool, job, i, shape,
                                           ctypes.byref(ndim),
                                           ctypes.byref(dtype))
            if rc != 0:
                out.append(None)
                continue
            shp = tuple(shape[j] for j in range(ndim.value))
            a = np.empty(shp, _DTYPES[dtype.value])
            nbytes = int(np.prod(shp, dtype=np.int64)) * _ITEM[dtype.value]
            got = self._lib.ctts_array_copy(
                self._pool, job, i, a.ctypes.data_as(ctypes.c_void_p),
                nbytes)
            out.append(a if got == nbytes else None)
        self._lib.ctts_job_free(self._pool, job)
        return out


def read_batch(paths, n_threads=8):
    """One-shot convenience: read many .npy files concurrently (with numpy
    where the library is not built)."""
    if not available():
        return [np.load(p) for p in paths]
    pf = NativePrefetcher(n_threads)
    return pf.fetch(pf.submit(paths))
