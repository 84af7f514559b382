"""ctypes binding for the native inter MC kernels (native/vvc_mc.c)."""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ._build import load_native

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_DIR, "native", "vvc_mc.c")

_I = ctypes.c_int
_P = ctypes.c_void_p
_L = ctypes.c_long


@functools.lru_cache()
def load_lib():
    lib = load_native("vvc_mc", [_SRC])
    lib.mc_put.argtypes = [_P, _P, _L] + [_I] * 9 + [_P, _P, _I] + [_I] * 6
    lib.mc_put.restype = None
    lib.mc_uni_out.argtypes = [_P, _L] + [_I] * 2 + [_P] + [_I] * 7
    lib.mc_uni_out.restype = None
    lib.mc_avg.argtypes = [_P, _L] + [_I] * 2 + [_P, _P] + [_I] * 3
    lib.mc_avg.restype = None
    lib.mc_w_avg.argtypes = [_P, _L] + [_I] * 2 + [_P, _P] + [_I] * 8
    lib.mc_w_avg.restype = None
    lib.dmvr_bilinear.argtypes = [_P, _P, _L] + [_I] * 9 + [_P, _I]
    lib.dmvr_bilinear.restype = None
    lib.dmvr_search.argtypes = [_P, _P, _I, _I, _P]
    lib.dmvr_search.restype = _I
    lib.apply_bdof.argtypes = [_P, _P, _P, _I, _I, _I]
    lib.apply_bdof.restype = None
    return lib


@functools.lru_cache()
def dmvr_filter():
    from ..ops import data as D
    f = np.ascontiguousarray(D.tables()["luma_dmvr_filters"].astype(np.int8))
    return f, ctypes.c_void_p(f.ctypes.data)


@functools.lru_cache()
def filter_rows():
    """(luma, chroma) filter banks as contiguous int32 + per-row c_void_p."""
    from ..ops import data as D
    t = D.tables()
    lf = np.ascontiguousarray(t["luma_filters"].astype(np.int32))
    cf = np.ascontiguousarray(t["chroma_filters"].astype(np.int32))
    lptr = [[ctypes.c_void_p(lf[i, j].ctypes.data)
             for j in range(lf.shape[1])] for i in range(lf.shape[0])]
    cptr = [[ctypes.c_void_p(cf[i, j].ctypes.data)
             for j in range(cf.shape[1])] for i in range(cf.shape[0])]
    return lf, cf, lptr, cptr
