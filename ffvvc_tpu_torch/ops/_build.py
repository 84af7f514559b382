"""Build and load the port's CUDA kernels (csrc/filters.cu, csrc/mc.cu).

nvcc compiles the sources into one shared library with a plain C interface
(no PyTorch headers: seconds, not minutes), by the scheme the host half's C
libraries use (`native/_build.py`: named by a hash of source and flags,
written to a temporary name and moved into place):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o ffvvc_tpu_torch/build/libffvvc_filters-<hash>.so
         csrc/filters.cu csrc/mc.cu

The library is loaded with ctypes, every argtype declared.  A missing nvcc
or a failed build raises RuntimeError; nothing falls back to the plain
PyTorch versions.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

from ..native import _build as _shared

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "filters.cu")
MC_SOURCE = os.path.join(_PKG, "csrc", "mc.cu")
SOURCES = [SOURCE, MC_SOURCE]
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher -> argtypes (pointers and the stream as c_void_p, ints as c_int)
_SIGNATURES = {
    # n, ptrs [3n], dims [5n], rows [5n], shift, pix_max, stream
    "ffvvc_sao": [_I, _P, _P, _P, _I, _I, _P],
    # src, out, rows [5], W, ci, ti, ctb_set, cw, cf, cl, edges, log2_cs,
    # pix_max, stream
    "ffvvc_alf_luma": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                       _P],
    # n, ptrs [5n], edges, rows [5], W, cw, log2_cs_v, log2_cs_h, pix_max,
    # stream
    "ffvvc_alf_chroma": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # n, ptrs [4n], luma, edges, rows [5], luma rows [5], W, Wc, cw,
    # log2_cs_v, log2_cs_h, hs, vs, half, pix_max, stream
    "ffvvc_cc": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                 _P],
    # planes, classes, n_classes, jobs, lf, cf, out, n_blocks, smem, bd,
    # stream
    "ffvvc_mc_put": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
# seconds the last build took (0.0 when an existing library was loaded)
build_seconds = 0.0


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def library_path():
    return _shared.library_path("ffvvc_filters", SOURCES, [], NVCC_FLAGS,
                                BUILD_DIR)


def _build():
    """Path of the kernel library, compiled first when it does not exist."""
    if os.path.exists(library_path()):
        return library_path()
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found (looked in "
            "$CUDA_HOME/bin, PATH and /usr/local/cuda/bin)")
    return _shared.build_shared(nvcc, NVCC_FLAGS, SOURCES, [],
                                "ffvvc_filters", BUILD_DIR)


def lib():
    """The loaded kernel library, built first if its source changed."""
    global _lib, build_seconds
    if _lib is not None:        # per-launch path: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(_build())
            build_seconds = _shared.build_seconds.get("ffvvc_filters", 0.0)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = so
        return _lib


def check(err, name):
    """Raise when a launcher returned a non-zero cudaError_t."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
