"""ctypes binding for the native deblock edge filters (vvc_deblock.c).

The Python kernels in ffvvc_tpu/deblock.py remain the golden model and the
automatic fallback when the library is missing or the plane layout does not
match (int32, C-contiguous).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ._build import load_native

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "vvc_deblock.c")

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)


class BsCtx(ctypes.Structure):
    """Mirror of BsCtx in vvc_deblock.c (field order must match)."""
    _fields_ = (
        [(n, _I32P) for n in
         ("tb_pos_x0", "tb_pos_y0", "tb_w0", "tb_h0",
          "tb_pos_x1", "tb_pos_y1", "tb_w1", "tb_h1")] +
        [("mvf_pf", _U8P), ("mvf_ciip", _I8P), ("mvf_mv", _I32P),
         ("mvf_ref", _I8P)] +
        [(n, _I32P) for n in
         ("tu_coded0", "tu_coded1", "tu_coded2", "tu_joint",
          "pcmf0", "pcmf1", "cb_pos_x", "cb_pos_y", "cb_w", "cb_h",
          "msf", "iaf", "slice_idx", "rpl_poc",
          "vbs0", "vbs1", "vbs2", "hbs0", "hbs1", "hbs2",
          "vp", "vq", "hp", "hq")] +
        [(n, ctypes.c_int32) for n in
         ("w4", "h4", "max_refs", "ctb_size", "ctb_log2", "ctb_width",
          "pic_w", "pic_h", "lf_slices", "lf_tiles", "hs1", "vs1",
          "chroma")])


class DeblockFrame(ctypes.Structure):
    """Mirror of DeblockFrame in vvc_deblock.c (field order must match)."""
    _fields_ = (
        [(n, _I32P) for n in
         ("plane0", "plane1", "plane2", "qp0", "qp1", "qp2",
          "dis", "beta", "tc", "col_bd", "row_bd")] +
        [(n, ctypes.c_int32) for n in
         ("ctb_w", "ctb_h", "qp_bd_offset", "bd", "pixel_max",
          "n_ladf", "ladf_lowest")] +
        [("ladf_off", _I32P), ("ladf_bnd", _I32P)])


@functools.lru_cache()
def load_lib():
    lib = load_native("vvc_deblock", [_SRC])
    lib.deblock_filter_luma.argtypes = [
        _I32P, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _I32P, _I32P, _I32P, _I32P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.deblock_filter_luma.restype = None
    lib.deblock_filter_chroma.argtypes = [
        _I32P, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _I32P, _I32P, _I32P, _I32P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.deblock_filter_chroma.restype = None
    lib.deblock_ctb_edges.argtypes = [
        _I32P, ctypes.c_long, ctypes.c_int, ctypes.c_int,        # plane c v
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # x0 y0 ends
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                # grid step n
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                # hs vs ctb
        _I32P, _I32P, _I32P, _I32P, _I32P, ctypes.c_int,         # tabs, w4
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # offs qbd bd
        ctypes.c_int,                                            # pixel max
        ctypes.c_int, ctypes.c_int, _I32P, _I32P]                # ladf
    lib.deblock_ctb_edges.restype = None
    lib.deblock_compute_bs.argtypes = [
        ctypes.POINTER(BsCtx), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.deblock_compute_bs.restype = None
    lib.deblock_frame_c.argtypes = [ctypes.POINTER(BsCtx),
                                    ctypes.POINTER(DeblockFrame)]
    lib.deblock_frame_c.restype = None
    lib.deblock_frame_part.argtypes = [ctypes.POINTER(BsCtx),
                                       ctypes.POINTER(DeblockFrame),
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
    lib.deblock_frame_part.restype = None
    lib.deblock_frame_range.argtypes = [ctypes.POINTER(BsCtx),
                                        ctypes.POINTER(DeblockFrame),
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
    lib.deblock_frame_range.restype = None
    lib.deblock_frame_segments.argtypes = [
        ctypes.POINTER(BsCtx), ctypes.POINTER(DeblockFrame), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)), ctypes.c_long, _I32P]
    lib.deblock_frame_segments.restype = ctypes.c_int
    return lib


def as_ptr(arr: np.ndarray, ptr_type):
    return arr.ctypes.data_as(ptr_type)


def as_i32p(arr: np.ndarray):
    return arr.ctypes.data_as(_I32P)
