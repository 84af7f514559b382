"""ctypes binding for the native intra recon core (native/vvc_recon.c).

Reconstructs whole CTUs from the flat records retained by the native parse
(native/parse.py `keep_records`), writing the frame planes in place —
prediction (incl. MIP/CCLM), dequant, LFNST, inverse transforms, residual
add.  ffvvc_tpu/recon.py remains the golden model; `make_native_recon`
returns None whenever the frame uses a tool the C core doesn't cover
(LMCS, explicit scaling lists, transform-skip — same gates as the parse).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .. import trace
from ._build import load_native


def _addr(p):
    """Raw address of a record pointer (stored as ctypes.c_void_p)."""
    v = p.value if isinstance(p, ctypes.c_void_p) else p
    return 0 if v is None else int(v)

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_DIR, "native", "vvc_recon.c"),
         os.path.join(_DIR, "native", "vvc_intra.c"),
         os.path.join(_DIR, "native", "vvc_inter.c"),
         os.path.join(_DIR, "native", "vvc_mc.c")]
_HDRS = [os.path.join(_DIR, "native", "vvc_cabac.h"),
         os.path.join(_DIR, "native", "vvc_parse.h"),
         os.path.join(_DIR, "native", "vvc_intra.h"),
         os.path.join(_DIR, "native", "vvc_recon.h")]

_I = ctypes.c_int
_P = ctypes.c_void_p


class _ReconParams(ctypes.Structure):
    _fields_ = (
        [(n, _I) for n in (
            "width", "height", "ctb_log2", "w4", "chroma_format_idc",
            "hshift1", "vshift1", "bit_depth", "qp_bd_offset", "log2_range",
            "dep_quant", "sps_mts", "sps_explicit_mts_intra", "wpp",
            "chroma_vert_coll", "jcbcr_sign", "slice_type_i",
            "min_qp_prime_ts")] +
        [(n, _P) for n in (
            "plane0", "plane1", "plane2", "imf", "cpm0", "ipm",
            "slice_idx", "ctb_to_col_bd", "ctb_to_row_bd")] +
        [("ctb_width", _I)] +
        [(n, _P) for n in (
            "fc_filt", "fg_filt",
            "dct2_2", "dct2_4", "dct2_8", "dct2_16", "dct2_32", "dct2_64",
            "dst7_4", "dst7_8", "dst7_16", "dst7_32",
            "dct8_4", "dct8_8", "dct8_16", "dct8_32",
            "lfnst_4x4", "lfnst_8x8", "lfnst_set_idx",
            "mip_4x4", "mip_8x8", "mip_16x16", "level_scale")])


class _InterParams(ctypes.Structure):
    """Mirror of InterParams (native/vvc_recon.h) — update together."""
    _fields_ = (
        [(n, _I) for n in ("is_b", "weighted_pred", "lmcs_used", "wrap",
                           "w4", "h4")] +
        [("pw_denom", _I * 2),
         ("pw_weight", _I * (2 * 3 * 16)),
         ("pw_offset", _I * (2 * 3 * 16)),
         ("lmcs_fwd", _P),
         ("ref_planes", _P * (2 * 16 * 3))] +
        [(n, _P) for n in (
            "mvf_pf", "mvf_mv", "mvf_ref", "mvf_bcw", "mvf_hpel",
            "mvf_ciip", "col_pf", "col_mv", "col_ref", "cp_mv",
            "luma_filters", "chroma_filters", "dmvr_filters",
            "gpm_angle_idx", "gpm_angle_to_weights", "gpm_angle_to_mirror",
            "gpm_off_x", "gpm_off_y", "gpm_weights")])


@functools.lru_cache()
def load_lib():
    lib = load_native("vvc_recon", _SRCS, _HDRS)
    lib.recon_ctu.argtypes = [ctypes.POINTER(_ReconParams),
                              ctypes.POINTER(_InterParams), _I, _I, _I,
                              _P, _I, _P, _P, _P]
    lib.recon_ctu.restype = _I
    lib.inter_ctu.argtypes = [ctypes.POINTER(_ReconParams),
                              ctypes.POINTER(_InterParams), _I, _I, _I,
                              _P, _I]
    lib.inter_ctu.restype = _I
    lib.recon_ctus.argtypes = [ctypes.POINTER(_ReconParams),
                               ctypes.POINTER(_InterParams), _I,
                               _P, _P, _P, _P, _P, _P, _P, _P]
    lib.recon_ctus.restype = _I
    lib.recon_residual_ctus.argtypes = [ctypes.POINTER(_ReconParams), _I,
                                        _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P]
    lib.recon_residual_ctus.restype = _I
    lib.plan_intra_ctus.argtypes = [ctypes.POINTER(_ReconParams), _I,
                                    _P, _P, _P, _P, _P, _P, _P,
                                    _P, ctypes.c_long, _P, _P]
    lib.plan_intra_ctus.restype = ctypes.c_long
    lib.inter_ctus.argtypes = [ctypes.POINTER(_ReconParams),
                               ctypes.POINTER(_InterParams), _I,
                               _P, _P, _P, _P, _P]
    lib.inter_ctus.restype = _I
    lib.inter_ctus_dev.argtypes = [ctypes.POINTER(_ReconParams),
                                   ctypes.POINTER(_InterParams), _I,
                                   _P, _P, _P, _P, _P, _I, _P, _I, _P]
    lib.inter_ctus_dev.restype = _I
    # device MC's walk of the descriptors and its writeback (vvc_inter.c)
    lib.mc_walk.argtypes = [_I] + [_P] * 4 + [_I, _P] + [_I] * 6 + \
        [_P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P]
    lib.mc_walk.restype = _I
    lib.mc_writeback.argtypes = [_P, _P, _I, _P, _P, _P]
    lib.mc_writeback.restype = _I
    # guard the ctypes struct mirrors against C layout drift
    assert lib.vvcr_sizeof_recon_params() == ctypes.sizeof(_ReconParams), \
        (lib.vvcr_sizeof_recon_params(), ctypes.sizeof(_ReconParams))
    assert lib.vvcr_sizeof_inter_params() == ctypes.sizeof(_InterParams), \
        (lib.vvcr_sizeof_inter_params(), ctypes.sizeof(_InterParams))
    return lib


@functools.lru_cache()
def _tables():
    """Contiguous int32/int8/uint8 copies of the constant tables, kept
    alive for the process."""
    from ..ops import data as D
    t = D.tables()
    out = {"fc": np.ascontiguousarray(D.intra_filter(0).astype(np.int32)),
           "fg": np.ascontiguousarray(D.intra_filter(1).astype(np.int32)),
           "lfnst_4x4": np.ascontiguousarray(t["lfnst_4x4"]),
           "lfnst_8x8": np.ascontiguousarray(t["lfnst_8x8"]),
           "lfnst_set_idx": np.ascontiguousarray(t["lfnst_tr_set_index"]),
           "mip_4x4": np.ascontiguousarray(t["mip_4x4"]),
           "mip_8x8": np.ascontiguousarray(t["mip_8x8"]),
           "mip_16x16": np.ascontiguousarray(t["mip_16x16"]),
           "level_scale": np.ascontiguousarray(
               np.asarray(D.LEVEL_SCALE, np.int32))}
    for n in (2, 4, 8, 16, 32, 64):
        out[f"dct2_{n}"] = np.ascontiguousarray(
            D.dct2_matrix(n).astype(np.int32))
    for n in (4, 8, 16, 32):
        out[f"dst7_{n}"] = np.ascontiguousarray(
            D.dst7_matrix(n).astype(np.int32))
        out[f"dct8_{n}"] = np.ascontiguousarray(
            D.dct8_matrix(n).astype(np.int32))
    return out


@functools.lru_cache()
def _inter_tables():
    """Contiguous copies of the MC filter banks and GPM blend tables."""
    from ..ops import data as D
    t = D.tables()
    return {
        "luma_filters": np.ascontiguousarray(
            t["luma_filters"].astype(np.int32)),
        "chroma_filters": np.ascontiguousarray(
            t["chroma_filters"].astype(np.int32)),
        "dmvr_filters": np.ascontiguousarray(
            t["luma_dmvr_filters"].astype(np.int8)),
        "gpm_angle_idx": np.ascontiguousarray(t["gpm_angle_idx"]),
        "gpm_angle_to_weights": np.ascontiguousarray(
            t["gpm_angle_to_weights_idx"]),
        "gpm_angle_to_mirror": np.ascontiguousarray(
            t["gpm_angle_to_mirror"]),
        "gpm_off_x": np.ascontiguousarray(t["gpm_weights_offset_x"]),
        "gpm_off_y": np.ascontiguousarray(t["gpm_weights_offset_y"]),
        "gpm_weights": np.ascontiguousarray(t["gpm_weights"]),
    }


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _ref_planes_ok(coder, fb):
    """True when every RPL reference frame's planes can be consumed by the
    native inter core: int32, C-contiguous, same geometry as the current
    frame (no RPR resampling)."""
    rpl = coder.rpl
    if rpl is None:
        return False
    n_planes = 3 if coder.sps.chroma_format_idc else 1
    for lx in range(2):
        if rpl[lx].nb_refs > 16:
            return False
        for f in rpl[lx].frames:
            buf = getattr(f, "buffer", None)
            if buf is None:
                return False
            for c in range(n_planes):
                p = buf.planes[c]
                if p.dtype != np.int32 or not p.flags.c_contiguous or \
                        p.shape != fb.planes[c].shape:
                    return False
    return True


def native_inter_ok(coder, fb):
    """Whether the native inter MC + recon walk can run this P/B slice."""
    if load_lib() is None:
        return False
    return _ref_planes_ok(coder, fb)


class NativeRecon:
    """Per-slice native recon; reconstruct_ctu-compatible walk over the
    records retained by the slice's NativeTreeParser."""

    def __init__(self, coder, tree_parser, fb, lib, ph_r):
        self.fb = fb
        self.rpl = coder.rpl
        self.lib = lib
        self.tabs = coder.tabs    # device-MC dispatch reads the mv grids
        self.records = tree_parser.records
        self._tree = tree_parser
        sps, pps = coder.sps, coder.pps
        tabs = coder.tabs
        t = _tables()
        rp = _ReconParams()
        self._keep = keep = [t]
        rp.width, rp.height = pps.width, pps.height
        rp.ctb_log2 = sps.ctb_log2_size_y
        rp.w4 = tabs.w4
        rp.chroma_format_idc = sps.chroma_format_idc
        rp.hshift1, rp.vshift1 = sps.hshift[1], sps.vshift[1]
        rp.bit_depth = sps.bit_depth
        rp.qp_bd_offset = sps.qp_bd_offset
        rp.log2_range = coder.log2_transform_range
        rp.dep_quant = coder.sh.r.sh_dep_quant_used_flag
        rp.sps_mts = sps.r.sps_mts_enabled_flag
        rp.sps_explicit_mts_intra = sps.r.sps_explicit_mts_intra_enabled_flag
        rp.wpp = sps.r.sps_entropy_coding_sync_enabled_flag
        rp.chroma_vert_coll = sps.r.sps_chroma_vertical_collocated_flag
        rp.jcbcr_sign = 1 - 2 * int(getattr(
            ph_r, "ph_joint_cbcr_sign_flag", 0))
        rp.slice_type_i = int(coder.sh.slice_type == 2)
        rp.min_qp_prime_ts = sps.r.sps_min_qp_prime_ts

        def cp(a, dtype=np.int32):
            assert a.dtype == dtype and a.flags["C_CONTIGUOUS"], (
                a.dtype, dtype)
            keep.append(a)
            return ctypes.c_void_p(a.ctypes.data)

        rp.plane0 = cp(fb.planes[0])
        if sps.chroma_format_idc:
            rp.plane1 = cp(fb.planes[1])
            rp.plane2 = cp(fb.planes[2])
        rp.imf, rp.cpm0, rp.ipm = cp(tabs.imf), cp(tabs.cpm[0]), cp(tabs.ipm)
        rp.slice_idx = cp(tabs.slice_idx)
        col_bd = np.ascontiguousarray(np.asarray(pps.ctb_to_col_bd, np.int32))
        row_bd = np.ascontiguousarray(np.asarray(pps.ctb_to_row_bd, np.int32))
        rp.ctb_to_col_bd, rp.ctb_to_row_bd = cp(col_bd), cp(row_bd)
        rp.ctb_width = pps.ctb_width
        rp.fc_filt, rp.fg_filt = _ptr(t["fc"]), _ptr(t["fg"])
        for n in (2, 4, 8, 16, 32, 64):
            setattr(rp, f"dct2_{n}", _ptr(t[f"dct2_{n}"]))
        for n in (4, 8, 16, 32):
            setattr(rp, f"dst7_{n}", _ptr(t[f"dst7_{n}"]))
            setattr(rp, f"dct8_{n}", _ptr(t[f"dct8_{n}"]))
        rp.lfnst_4x4 = _ptr(t["lfnst_4x4"])
        rp.lfnst_8x8 = _ptr(t["lfnst_8x8"])
        rp.lfnst_set_idx = _ptr(t["lfnst_set_idx"])
        rp.mip_4x4, rp.mip_8x8 = _ptr(t["mip_4x4"]), _ptr(t["mip_8x8"])
        rp.mip_16x16 = _ptr(t["mip_16x16"])
        rp.level_scale = _ptr(t["level_scale"])
        self.rp = rp
        self._rp_ref = ctypes.byref(rp)
        self._ip_ref = None
        from ..bitstream.h266 import SLICE_I
        if coder.sh.slice_type != SLICE_I and coder.rpl is not None:
            self._build_inter_params(coder, fb)

    def _build_inter_params(self, coder, fb):
        """InterParams for the native MC walk (inter.py InterPredictor)."""
        sh, tabs = coder.sh, coder.tabs
        keep = self._keep
        it = _inter_tables()
        keep.append(it)
        ip = _InterParams()
        ip.is_b = int(sh.is_b)
        ip.weighted_pred = int(sh.weighted_pred)
        ip.lmcs_used = 0
        # wraparound MC offset in luma samples (spec 8.5.6.3.2;
        # pps_ref_wraparound derive at ps.py PPS)
        ip.wrap = coder.pps.ref_wraparound_offset * coder.sps.min_cb_size_y
        ip.w4, ip.h4 = tabs.w4, tabs.h4
        pwt = coder.pwt
        rpl = coder.rpl
        n_planes = 3 if coder.sps.chroma_format_idc else 1
        for lx in range(2):
            ip.pw_denom[lx] = pwt.log2_denom[lx] if pwt else 0
            for i, f in enumerate(rpl[lx].frames[:16]):
                for c in range(n_planes):
                    p = f.buffer.planes[c]
                    keep.append(p)
                    ip.ref_planes[(lx * 16 + i) * 3 + c] = p.ctypes.data
                if pwt is not None:
                    for c in range(3):
                        ip.pw_weight[(lx * 3 + c) * 16 + i] = \
                            pwt.weight(lx, c, i)
                        ip.pw_offset[(lx * 3 + c) * 16 + i] = \
                            pwt.offset(lx, c, i)
        keep += [tabs.mvf_pf, tabs.mvf_mv, tabs.mvf_ref, tabs.mvf_bcw,
                 tabs.mvf_hpel, tabs.mvf_ciip, tabs.col_pf, tabs.col_mv,
                 tabs.col_ref, tabs.cp_mv]
        for name, a in (("mvf_pf", tabs.mvf_pf), ("mvf_mv", tabs.mvf_mv),
                        ("mvf_ref", tabs.mvf_ref), ("mvf_bcw", tabs.mvf_bcw),
                        ("mvf_hpel", tabs.mvf_hpel),
                        ("mvf_ciip", tabs.mvf_ciip),
                        ("col_pf", tabs.col_pf), ("col_mv", tabs.col_mv),
                        ("col_ref", tabs.col_ref), ("cp_mv", tabs.cp_mv)):
            setattr(ip, name, a.ctypes.data)
        for name in ("luma_filters", "chroma_filters", "dmvr_filters",
                     "gpm_angle_idx", "gpm_angle_to_weights",
                     "gpm_angle_to_mirror", "gpm_off_x", "gpm_off_y",
                     "gpm_weights"):
            setattr(ip, name, it[name].ctypes.data)
        self.ip = ip
        self._ip_ref = ctypes.byref(ip)

    def set_lmcs_fwd(self, fwd_lut):
        """Attach the LMCS forward-mapping LUT (sh_lmcs_used_flag) before
        the inter MC / recon walks run."""
        if self._ip_ref is None:
            return
        if fwd_lut is None:
            self.ip.lmcs_fwd = None
            self.ip.lmcs_used = 0
            self.lmcs_fwd_np = None
            return
        lut = np.ascontiguousarray(np.asarray(fwd_lut, dtype=np.int32))
        self._keep.append(lut)
        self.lmcs_fwd_np = lut         # device-MC dispatch applies it too
        self.ip.lmcs_fwd = lut.ctypes.data
        self.ip.lmcs_used = 1

    def predict_inter_ctu(self, rs, rx, ry):
        rec = self.records.get(rs)
        if rec is None or not rec[0]:
            return
        n_cu, cu_p, _tu, _tb, _coeff, _keep = rec
        err = self.lib.inter_ctu(self._rp_ref, self._ip_ref, rx, ry, rs,
                                 cu_p, n_cu)
        if err:
            raise ValueError(f"native inter_ctu failed (err={err})")

    def reconstruct_ctu(self, rs, rx, ry):
        rec = self.records.get(rs)
        if rec is None or not rec[0]:
            return
        n_cu, cu_p, tu_p, tb_p, coeff_p, _keep = rec
        err = self.lib.recon_ctu(self._rp_ref, self._ip_ref, rx, ry, rs,
                                 cu_p, n_cu, tu_p, tb_p, coeff_p)
        if err:
            raise ValueError(f"native recon_ctu failed (err={err})")

    @staticmethod
    def _noop():
        pass

    def _batch_arrays(self, ctus, with_records):
        """Flat per-CTU argument arrays for the batched C walks (one
        ctypes call per job instead of per CTU).  Cached per ctus list —
        the inter and recon walks share the same job lists, and records
        are final once the slice parse completed."""
        # fast path: the parse emitted these arrays vectorized for exactly
        # this job list (parse_entrypoint job_ctus)
        tree = getattr(self, "_tree", None)
        if tree is not None and tree.flat is not None and \
                tree.flat_ctus is ctus:
            return tree.flat
        key = (id(ctus), with_records)
        cache = getattr(self, "_ba_cache", None)
        if cache is None:
            cache = self._ba_cache = {}
        hit = cache.get(key)
        if hit is not None:
            return hit[0]
        n = len(ctus)
        rxs = np.empty(n, np.int32)
        rys = np.empty(n, np.int32)
        rss = np.empty(n, np.int32)
        n_cus = np.zeros(n, np.int32)
        cu_ps = np.zeros(n, np.int64)
        tu_ps = np.zeros(n, np.int64)
        tb_ps = np.zeros(n, np.int64)
        co_ps = np.zeros(n, np.int64)
        for i, (rs, rx, ry) in enumerate(ctus):
            rxs[i], rys[i], rss[i] = rx, ry, rs
            rec = self.records.get(rs)
            if rec is None or not rec[0]:
                continue
            n_cu, cu_p, tu_p, tb_p, coeff_p, _keep = rec
            n_cus[i] = n_cu
            cu_ps[i] = _addr(cu_p)
            if with_records:
                tu_ps[i] = _addr(tu_p)
                tb_ps[i] = _addr(tb_p)
                co_ps[i] = _addr(coeff_p)
        out = (rxs, rys, rss, n_cus, cu_ps, tu_ps, tb_ps, co_ps)
        cache[key] = (out, ctus)   # keep ctus alive so id() stays unique
        return out

    def predict_inter_ctus(self, ctus):
        rxs, rys, rss, n_cus, cu_ps, _t, _b, _c = \
            self._batch_arrays(ctus, False)
        err = self.lib.inter_ctus(
            self._rp_ref, self._ip_ref, len(ctus),
            rxs.ctypes.data, rys.ctypes.data, rss.ctypes.data,
            cu_ps.ctypes.data, n_cus.ctypes.data)
        if err:
            raise ValueError(f"native inter_ctus failed (err={err})")

    def predict_inter_ctus_dev(self, ctus, tag):
        """Host MC for complex blocks + descriptor emission for simple
        regular blocks (device-MC dispatch, ops/mc_device.py).  Returns
        the [nd, 31] descriptor array (layout in vvc_inter.c
        inter_ctus_dev; may be empty)."""
        rxs, rys, rss, n_cus, cu_ps, _t, _b, _c = \
            self._batch_arrays(ctus, False)
        cap = max(int(n_cus.sum()), 1)
        desc = np.zeros((cap, 31), np.int32)
        nd = np.zeros(1, np.int32)
        err = self.lib.inter_ctus_dev(
            self._rp_ref, self._ip_ref, len(ctus),
            rxs.ctypes.data, rys.ctypes.data, rss.ctypes.data,
            cu_ps.ctypes.data, n_cus.ctypes.data, int(tag),
            desc.ctypes.data, cap, nd.ctypes.data)
        if err:
            raise ValueError(f"native inter_ctus_dev failed (err={err})")
        return desc[:int(nd[0])]

    @trace.traced("recon")
    def reconstruct_ctus(self, ctus):
        rxs, rys, rss, n_cus, cu_ps, tu_ps, tb_ps, co_ps = \
            self._batch_arrays(ctus, True)
        err = self.lib.recon_ctus(
            self._rp_ref, self._ip_ref, len(ctus),
            rxs.ctypes.data, rys.ctypes.data, rss.ctypes.data,
            cu_ps.ctypes.data, n_cus.ctypes.data,
            tu_ps.ctypes.data, tb_ps.ctypes.data, co_ps.ctypes.data)
        if err:
            raise ValueError(f"native recon_ctus failed (err={err})")

    PLAN_STRIDE = 26

    def plan_ctus(self, ctus, plan_buf, wl, wc):
        """Device-intra planner: walk the records in plan mode, emitting
        PLAN_STRIDE-int32 descriptor rows per predict unit (geometry +
        availability + wave) into plan_buf.  wl/wc are caller-zeroed
        int32 wave maps (luma plane shape / chroma plane shape).  Consumes
        NO record state (safe to run before residual_ctus).  Returns the
        number of units, or raises on an unsupported CU."""
        rxs, rys, rss, n_cus, cu_ps, tu_ps, tb_ps, _co = \
            self._batch_arrays(ctus, True)
        n = self.lib.plan_intra_ctus(
            self._rp_ref, len(ctus),
            rxs.ctypes.data, rys.ctypes.data, rss.ctypes.data,
            cu_ps.ctypes.data, n_cus.ctypes.data,
            tu_ps.ctypes.data, tb_ps.ctypes.data,
            plan_buf.ctypes.data, plan_buf.shape[0],
            wl.ctypes.data, wc.ctypes.data if wc is not None else 0)
        if n < 0:
            raise ValueError(f"native plan_intra_ctus failed (err={-n})")
        return int(n)

    @trace.traced("recon")
    def residual_ctus(self, ctus, res_planes):
        """Device-intra support: run the record walk in residual-only mode,
        writing raw per-TB residuals into res_planes (list of int32 arrays,
        one per plane, same shapes as fb.planes).  Consumes the records'
        coefficient state (BDPCM/dequant run in place) — the normal
        reconstruct_ctus must NOT run afterwards for these CTUs."""
        rxs, rys, rss, n_cus, cu_ps, tu_ps, tb_ps, co_ps = \
            self._batch_arrays(ctus, True)
        ps = [p.ctypes.data for p in res_planes] + \
            [0] * (3 - len(res_planes))
        err = self.lib.recon_residual_ctus(
            self._rp_ref, len(ctus),
            rxs.ctypes.data, rys.ctypes.data, rss.ctypes.data,
            cu_ps.ctypes.data, n_cus.ctypes.data,
            tu_ps.ctypes.data, tb_ps.ctypes.data, co_ps.ctypes.data,
            ps[0], ps[1], ps[2])
        if err:
            raise ValueError(f"native recon_residual_ctus failed "
                             f"(err={err})")


def make_native_recon(coder, fb, ph_r):
    """NativeRecon for this slice, or None if ineligible (requires the
    slice's native tree parser to have retained records)."""
    tp = getattr(coder, "native_tree", None)
    if tp is None or not tp.keep_records:
        return None
    lib = load_lib()
    if lib is None:
        return None
    return NativeRecon(coder, tp, fb, lib, ph_r)
