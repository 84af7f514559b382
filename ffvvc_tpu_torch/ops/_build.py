"""Build and load the port's CUDA kernels (csrc/filters.cu).

nvcc compiles the source into a shared library with a plain C interface
(no PyTorch headers: seconds, not minutes), keyed by a hash of the source
so an edited kernel rebuilds and an unchanged one loads the existing
library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o ffvvc_tpu_torch/build/libffvvc_filters-<hash>.so

The library is loaded with ctypes, every argtype declared, in the same way
`ffvvc_tpu/native/*.py` load their gcc-built C libraries.  A missing nvcc or
a failed build raises RuntimeError; nothing falls back to the plain
PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "filters.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher -> argtypes (pointers and the stream as c_void_p, ints as c_int)
_SIGNATURES = {
    "ffvvc_sao": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P],
    "ffvvc_alf": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  _I, _P, _P],
    "ffvvc_cc": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 _P, _P],
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
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libffvvc_filters-{digest.hexdigest()[:16]}.so")


def _build(out):
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found (looked in "
            "$CUDA_HOME/bin, PATH and /usr/local/cuda/bin)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}) building "
                           f"{SOURCE}:\n{r.stderr}{r.stdout}")
    os.replace(tmp, out)


def lib():
    """The loaded kernel library, built first if its source changed."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                t0 = time.monotonic()
                _build(path)
                build_seconds = time.monotonic() - t0
            so = ctypes.CDLL(path)
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
