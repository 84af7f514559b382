"""ctypes binding for the native intra predictors (vvc_intra.c).

The NumPy kernels in ffvvc_tpu/recon.py remain the golden model and the
automatic fallback when the library is missing or the plane layout does
not match (int32, C-contiguous).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ._build import load_native

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "vvc_intra.c")

_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache()
def load_lib():
    lib = load_native("vvc_intra", [_SRC])
    lib.vvc_intra_pred.argtypes = [
        _I32P, ctypes.c_long,                       # plane, stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # x y w h
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # c mode ref pdpc
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # smooth, lsize, tsize
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # unf_l/t refw refh
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ang inv ff nscale
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # lavail tavail cul
        ctypes.c_int, _I32P, _I32P]                 # bd, fc, fg
    lib.vvc_intra_pred.restype = None
    lib.vvc_dequant_flat.argtypes = [
        _I32P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.vvc_dequant_flat.restype = None
    return lib


def as_i32p(arr: np.ndarray):
    return arr.ctypes.data_as(_I32P)
