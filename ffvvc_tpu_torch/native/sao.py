"""ctypes binding for the native SAO pass (native/vvc_sao.c).

Whole-frame band/edge offsets over a pre-SAO snapshot — the host fast path
of ffvvc_tpu/sao.py (which stays the golden model and the fallback)."""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ._build import load_native

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_DIR, "native", "vvc_sao.c")

_I = ctypes.c_int
_P = ctypes.c_void_p


class _SaoParams(ctypes.Structure):
    """Mirror of SaoParams (native/vvc_sao.c) — update together."""
    _fields_ = (
        [("pre", _P * 3), ("dst", _P * 3),
         ("plane_w", _I * 3), ("plane_h", _I * 3)] +
        [(n, _P) for n in ("sao_type", "sao_band_pos", "sao_eo_class",
                           "sao_offset", "slice_idx", "col_bd", "row_bd")] +
        [(n, _I) for n in ("ctb_w", "ctb_h", "ctb_log2", "n_comp",
                           "bit_depth", "lfase", "no_tile",
                           "hshift1", "vshift1")])


@functools.lru_cache()
def load_lib():
    lib = load_native("vvc_sao", [_SRC])
    lib.sao_frame_c.argtypes = [ctypes.POINTER(_SaoParams)]
    lib.sao_frame_c.restype = None
    lib.sao_rows_c.argtypes = [ctypes.POINTER(_SaoParams), _I, _I]
    lib.sao_rows_c.restype = None
    assert lib.sao_sizeof_params() == ctypes.sizeof(_SaoParams), \
        (lib.sao_sizeof_params(), ctypes.sizeof(_SaoParams))
    return lib


def _i32(a):
    a = np.asarray(a)
    if a.dtype != np.int32 or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a, np.int32)
    return a


class SaoRowPass:
    """Row-range SAO driving for the pixel-row pipeline: the pre-SAO
    snapshot fills progressively (fill_pre) as deblock finalizes rows,
    then run_rows() filters CTB-row ranges.  eligible is False when the
    C library / plane layout rules it out."""

    def __init__(self, sps, pps, tabs, fb):
        self.eligible = False
        lib = load_lib()
        if lib is None:
            return
        planes = fb.planes
        for pl in planes:
            if pl.dtype != np.int32 or not pl.flags.c_contiguous:
                return
        self.lib = lib
        self.planes = planes
        self.pre = [np.empty_like(pl) for pl in planes]
        self.vshift = [0] + [sps.vshift[1]] * 2
        p = _SaoParams()
        self._keep = keep = []
        for c, pl in enumerate(planes):
            p.pre[c] = self.pre[c].ctypes.data
            p.dst[c] = pl.ctypes.data
            p.plane_h[c], p.plane_w[c] = pl.shape
        _fill_sao_params(p, sps, pps, tabs, keep)
        self.p = p
        self.ref = ctypes.byref(p)
        self.eligible = True

    def fill_pre(self, y0, y1):
        """Snapshot deblocked luma rows [y0, y1) (+ the co-sited chroma
        rows) into the pre-SAO buffers."""
        for c, pl in enumerate(self.planes):
            vs = self.vshift[c]
            a, b = y0 >> vs, -(-y1 // (1 << vs))
            self.pre[c][a:b] = pl[a:b]

    def run_rows(self, lo, hi):
        self.lib.sao_rows_c(self.ref, lo, hi)


def _fill_sao_params(p, sps, pps, tabs, keep):
    st = _i32(tabs.sao_type)
    bp = _i32(tabs.sao_band_pos)
    ec = _i32(tabs.sao_eo_class)
    so = _i32(tabs.sao_offset)
    si = _i32(tabs.slice_idx)
    cb = _i32(pps.ctb_to_col_bd)
    rb = _i32(pps.ctb_to_row_bd)
    keep += [st, bp, ec, so, si, cb, rb]
    p.sao_type = st.ctypes.data
    p.sao_band_pos = bp.ctypes.data
    p.sao_eo_class = ec.ctypes.data
    p.sao_offset = so.ctypes.data
    p.slice_idx = si.ctypes.data
    p.col_bd = cb.ctypes.data
    p.row_bd = rb.ctypes.data
    p.ctb_w, p.ctb_h = pps.ctb_width, pps.ctb_height
    p.ctb_log2 = sps.ctb_log2_size_y
    p.n_comp = 3 if sps.chroma_format_idc else 1
    p.bit_depth = sps.bit_depth
    p.lfase = int(pps.r.pps_loop_filter_across_slices_enabled_flag)
    p.no_tile = int(pps.r.num_tiles_in_pic > 1 and
                    not pps.r.pps_loop_filter_across_tiles_enabled_flag)
    p.hshift1 = sps.hshift[1]
    p.vshift1 = sps.vshift[1]


def sao_frame_native(sps, pps, tabs, fb, n_threads=1) -> bool:
    """Run the C SAO pass; returns False if the library is unavailable or a
    plane isn't int32-contiguous (caller falls back to the golden pass)."""
    lib = load_lib()
    if lib is None:
        return False
    planes = fb.planes
    for pl in planes:
        if pl.dtype != np.int32 or not pl.flags.c_contiguous:
            return False
    pre = [pl.copy() for pl in planes]
    p = _SaoParams()
    keep = [pre]
    for c, pl in enumerate(planes):
        p.pre[c] = pre[c].ctypes.data
        p.dst[c] = pl.ctypes.data
        p.plane_h[c], p.plane_w[c] = pl.shape
    _fill_sao_params(p, sps, pps, tabs, keep)
    ref = ctypes.byref(p)
    if n_threads > 1 and pps.ctb_height > 1:
        from ..threads import run_parallel, split_ranges
        run_parallel(n_threads, [
            (lambda lo=lo, hi=hi: lib.sao_rows_c(ref, lo, hi))
            for lo, hi in split_ranges(pps.ctb_height, n_threads)])
    else:
        lib.sao_frame_c(ref)
    del keep
    return True
