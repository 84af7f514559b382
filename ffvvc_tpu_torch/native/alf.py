"""ctypes binding for the native whole-frame ALF pass (native/vvc_alf.c).

`alf_frame_native(...)` mirrors ffvvc_tpu/alf.py AlfFilter.alf_frame
bit-exactly; returns False (state untouched) when the C library is
unavailable or a referenced APS is missing, so the caller can fall back to
the golden pass.  The _AlfParams struct MUST mirror AlfParams in
vvc_alf.c field-for-field — update both together.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ._build import load_native

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_DIR, "native", "vvc_alf.c")

_I = ctypes.c_int
_P = ctypes.c_void_p


class _AlfParams(ctypes.Structure):
    _fields_ = (
        [(n, _I) for n in (
            "width", "height", "ctb_log2", "ctb_width", "ctb_height",
            "chroma_format_idc", "hs1", "vs1", "bit_depth",
            "lf_across_tiles", "lf_across_slices")] +
        [(n, _P) for n in (
            "plane0", "plane1", "plane2", "pre0", "pre1", "pre2",
            "slice_idx", "col_bd", "row_bd",
            "ctb_flag", "cc_idc", "fixed", "filt_idx", "aps_slot",
            "alt_idx")] +
        [("n_slices", _I)] +
        [(n, _P) for n in ("sl_chroma_slot", "sl_cc_slot")] +
        [("n_slots", _I)] +
        [(n, _P) for n in (
            "luma_coeff", "luma_clip_idx", "chroma_coeff",
            "chroma_clip_idx", "cc_coeff",
            "fix_coeff", "class_to_filt", "aps_class_to_filt")])


@functools.lru_cache()
def load_lib():
    lib = load_native("vvc_alf", [_SRC])
    lib.alf_frame_c.argtypes = [ctypes.POINTER(_AlfParams)]
    lib.alf_frame_c.restype = _I
    lib.alf_frame_rows.argtypes = [ctypes.POINTER(_AlfParams), _I, _I]
    lib.alf_frame_rows.restype = _I
    assert lib.alf_sizeof_params() == ctypes.sizeof(_AlfParams), \
        (lib.alf_sizeof_params(), ctypes.sizeof(_AlfParams))
    return lib


@functools.lru_cache()
def _const_tables():
    from ..ops import data as D
    t = D.tables()
    return (np.ascontiguousarray(t["alf_fix_filt_coeff"].astype(np.int32)),
            np.ascontiguousarray(
                t["alf_class_to_filt_map"].astype(np.int32)),
            np.ascontiguousarray(
                t["alf_aps_class_to_filt_map"].astype(np.int32)))


def _build_alf_params(sps, pps, tabs, fb, sh_list, alf_list, pre):
    """Shared param-struct builder: returns (lib, ap, keep) or None when
    the C pass is ineligible (missing lib/APS, layout).  `pre` is the
    pre-ALF (post-SAO) snapshot buffer list the C pass reads."""
    lib = load_lib()
    if lib is None or sps.ctb_size_y > 128:
        return None

    # slot-map the APS ids actually referenced; missing luma/chroma APS =>
    # ineligible (the golden would raise there too, but fall back anyway)
    slots = {aid: i for i, aid in enumerate(sorted(alf_list))}
    nctb = pps.ctb_count
    flags = tabs.alf_ctb_flag
    ccidc = tabs.alf_cc_idc
    aps_slot = np.full(nctb, -1, np.int32)
    for rs in np.nonzero(flags[:, 0] & (tabs.alf_fixed == 0))[0]:
        aid = int(tabs.alf_aps_id[rs, 0])
        if aid not in slots:
            return None
        aps_slot[rs] = slots[aid]
    n_slices = len(sh_list)
    sl_chroma = np.full(n_slices, -1, np.int32)
    sl_cc = np.full((n_slices, 2), -1, np.int32)
    si_of_ctb = tabs.slice_idx.reshape(-1)
    for s, sh in enumerate(sh_list):
        r = sh.r
        aid = getattr(r, "sh_alf_aps_id_chroma", 0)
        if aid in slots:
            sl_chroma[s] = slots[aid]
        elif np.any(flags[si_of_ctb == s][:, 1:3]):
            return None
        for i, name in enumerate(("sh_alf_cc_cb_aps_id",
                                  "sh_alf_cc_cr_aps_id")):
            aid = getattr(r, name, 0)
            if aid in slots:
                sl_cc[s, i] = slots[aid]
            elif np.any(ccidc[si_of_ctb == s][:, i]):
                # CC-ALF signalled but its APS is missing: the C pass
                # would silently skip filtering (slot < 0 guard) where the
                # golden raises — fall back so behavior stays identical
                return None

    n_slots = max(1, len(slots))
    luma_coeff = np.zeros((n_slots, 25, 12), np.int32)
    luma_clip = np.zeros((n_slots, 25, 12), np.int32)
    chroma_coeff = np.zeros((n_slots, 8, 6), np.int32)
    chroma_clip = np.zeros((n_slots, 8, 6), np.int32)
    cc_coeff = np.zeros((n_slots, 2, 4, 7), np.int32)
    for aid, slot in slots.items():
        a = alf_list[aid]
        luma_coeff[slot] = a.luma_coeff
        luma_clip[slot] = a.luma_clip_idx
        na = a.num_chroma_filters
        chroma_coeff[slot, :na] = a.chroma_coeff
        chroma_clip[slot, :na] = a.chroma_clip_idx
        for i in range(2):
            nf = a.num_cc_filters[i]
            cc_coeff[slot, i, :nf] = a.cc_coeff[i]

    fixc, c2f, aps_c2f = _const_tables()
    keep = []

    def cp(a, dtype=np.int32):
        a = np.ascontiguousarray(np.asarray(a, dtype))
        keep.append(a)
        return a.ctypes.data

    ap = _AlfParams()
    ap.width, ap.height = pps.width, pps.height
    ap.ctb_log2 = sps.ctb_log2_size_y
    ap.ctb_width, ap.ctb_height = pps.ctb_width, pps.ctb_height
    ap.chroma_format_idc = sps.chroma_format_idc
    ap.hs1, ap.vs1 = sps.hshift[1], sps.vshift[1]
    ap.bit_depth = sps.bit_depth
    ap.lf_across_tiles = \
        int(pps.r.pps_loop_filter_across_tiles_enabled_flag)
    ap.lf_across_slices = \
        int(pps.r.pps_loop_filter_across_slices_enabled_flag)
    for p in fb.planes:
        if p.dtype != np.int32 or not p.flags.c_contiguous:
            return None
    ap.plane0 = fb.planes[0].ctypes.data
    ap.pre0 = cp(pre[0])
    if sps.chroma_format_idc:
        ap.plane1 = fb.planes[1].ctypes.data
        ap.plane2 = fb.planes[2].ctypes.data
        ap.pre1 = cp(pre[1])
        ap.pre2 = cp(pre[2])
    ap.slice_idx = cp(tabs.slice_idx)
    ap.col_bd = cp(pps.ctb_to_col_bd)
    ap.row_bd = cp(pps.ctb_to_row_bd)
    ap.ctb_flag = cp(flags)
    ap.cc_idc = cp(ccidc)
    ap.fixed = cp(tabs.alf_fixed)
    ap.filt_idx = cp(tabs.alf_filt_idx)
    ap.aps_slot = cp(aps_slot)
    ap.alt_idx = cp(tabs.alf_alt_idx)
    ap.n_slices = n_slices
    ap.sl_chroma_slot = cp(sl_chroma)
    ap.sl_cc_slot = cp(sl_cc)
    ap.n_slots = n_slots
    ap.luma_coeff = cp(luma_coeff)
    ap.luma_clip_idx = cp(luma_clip)
    ap.chroma_coeff = cp(chroma_coeff)
    ap.chroma_clip_idx = cp(chroma_clip)
    ap.cc_coeff = cp(cc_coeff)
    ap.fix_coeff = cp(fixc)
    ap.class_to_filt = cp(c2f)
    ap.aps_class_to_filt = cp(aps_c2f)
    return lib, ap, keep


class AlfRowPass:
    """Row-range ALF/CC-ALF driving for the pixel-row pipeline: the
    pre-ALF (post-SAO) snapshot fills progressively (fill_pre), then
    run_rows() filters CTB-row ranges.  `needed` is False when the frame
    has no ALF work at all; `eligible` when the C pass can run it."""

    def __init__(self, sps, pps, tabs, fb, sh_list, alf_list):
        self.needed = bool(
            sps.r.sps_alf_enabled_flag and sh_list is not None and
            (tabs.alf_ctb_flag.any() or tabs.alf_cc_idc.any()))
        self.eligible = not self.needed
        if not self.needed:
            return
        self.planes = fb.planes
        self.pre = [np.empty_like(p) for p in fb.planes]
        self.vshift = [0] + [sps.vshift[1]] * 2
        built = _build_alf_params(sps, pps, tabs, fb, sh_list, alf_list,
                                  self.pre)
        if built is None:
            return
        self.lib, self.ap, self._keep = built
        self.ref = ctypes.byref(self.ap)
        self.eligible = True

    def fill_pre(self, y0, y1):
        """Snapshot post-SAO luma rows [y0, y1) (+ co-sited chroma)."""
        for c, pl in enumerate(self.planes):
            vs = self.vshift[c]
            a, b = y0 >> vs, -(-y1 // (1 << vs))
            self.pre[c][a:b] = pl[a:b]

    def run_rows(self, lo, hi):
        err = self.lib.alf_frame_rows(self.ref, lo, hi)
        if err:
            raise ValueError(f"native alf_frame_rows failed (err={err})")


def alf_frame_native(sps, pps, tabs, fb, sh_list, alf_list,
                     stage_threads=1) -> bool:
    """Run the whole-frame ALF/CC-ALF pass in C, sharding CTB rows across
    stage_threads (rows are independent given the pre-ALF snapshot).
    Returns True on success, False (planes untouched) when ineligible."""
    if not sps.r.sps_alf_enabled_flag:
        return True
    if not tabs.alf_ctb_flag.any() and not tabs.alf_cc_idc.any():
        return True
    pre = [np.ascontiguousarray(p.copy()) for p in fb.planes]
    built = _build_alf_params(sps, pps, tabs, fb, sh_list, alf_list, pre)
    if built is None:
        return False
    lib, ap, keep = built
    nt = min(int(stage_threads) or 1, pps.ctb_height)
    if nt <= 1:
        err = lib.alf_frame_c(ctypes.byref(ap))
        if err:
            raise ValueError(f"native alf_frame_c failed (err={err})")
        return True
    from ..threads import run_parallel, split_ranges
    errs = [0] * nt

    def shard(i, lo, hi):
        errs[i] = lib.alf_frame_rows(ctypes.byref(ap), lo, hi)

    run_parallel(nt, [
        (lambda i=i, lo=lo, hi=hi: shard(i, lo, hi))
        for i, (lo, hi) in enumerate(split_ranges(pps.ctb_height, nt))])
    if any(errs):
        raise ValueError(f"native alf_frame_rows failed (errs={errs})")
    return True
