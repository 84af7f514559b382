"""Build the port's shared libraries from its own sources.

One scheme for the host half's C libraries (gcc, this module's
`load_native`) and the CUDA kernels (nvcc, `ops/_build.py`): a library is
compiled from sources of this package into the git-ignored
`ffvvc_tpu_torch/build/`, named by a hash of its sources, headers and
compiler flags, so an edited source rebuilds and an unchanged one loads the
existing file.  The compiler writes to a temporary name, which is then
linked to the library's name unless that exists by now: concurrent
processes (test workers) may race to build the same library, the first
whole file stays, and a file that a process has loaded is never replaced.

A missing compiler or a failed build raises RuntimeError with the
compiler's output; nothing falls back to another implementation.
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
BUILD_DIR = os.path.join(_PKG, "build")
GCC_FLAGS = ["-O3", "-march=x86-64-v3", "-shared", "-Wl,-Bsymbolic", "-fPIC"]

# library stem -> seconds its build took in this process (absent when an
# existing library was loaded)
build_seconds = {}


def library_path(stem, sources, headers, flags, build_dir):
    """`build_dir`/lib<stem>-<hash>.so for these sources, headers and
    flags (file names and contents both enter the hash)."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in list(sources) + list(headers):
        digest.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_shared(compiler, flags, sources, headers, stem, build_dir):
    """Path of the library, compiling it first when it does not exist."""
    out = library_path(stem, sources, headers, flags, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.monotonic()
    r = subprocess.run([compiler, *flags, "-o", tmp, *sources],
                       capture_output=True, text=True)
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed ({r.returncode}) building "
            f"lib{stem} from {' '.join(sources)}:\n{r.stderr}{r.stdout}")
    try:
        os.link(tmp, out)
    except FileExistsError:     # another process was first: load its file
        pass
    os.unlink(tmp)
    build_seconds[stem] = time.monotonic() - t0
    return out


def load_native(stem, sources, headers=()):
    """The host half's C library lib<stem>, built with gcc from `sources`
    (rebuilt when a source or one of `headers` changes) and loaded with
    ctypes."""
    gcc = shutil.which("gcc")
    if gcc is None:
        raise RuntimeError(f"cannot build lib{stem}: gcc not found on PATH")
    return ctypes.CDLL(build_shared(gcc, GCC_FLAGS, list(sources),
                                    list(headers), stem, BUILD_DIR))
