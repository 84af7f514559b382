"""ctypes bindings for the native CABAC engine + residual fast path.

The C library (native/vvc_cabac.c) is a transliteration of engine.py /
residual.py decode semantics; the Python implementations remain the golden
model and the automatic fallback when the library is missing.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..native._build import load_native

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_DIR, "native", "vvc_cabac.c")


class _Cabac(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("nbits", ctypes.c_long),
        ("pos", ctypes.c_long),
        ("range", ctypes.c_uint32),
        ("offset", ctypes.c_uint32),
        ("s0", ctypes.c_void_p),
        ("s1", ctypes.c_void_p),
        ("sh0", ctypes.c_void_p),
        ("sh1", ctypes.c_void_p),
        ("cache", ctypes.c_uint64),
        ("cache_n", ctypes.c_int32),
    ]


class _ResParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "w", "h", "log2_w", "log2_h", "c_idx", "log2_zo_w", "log2_zo_h",
        "ts", "bdpcm",
        "dep_quant", "sdh", "reverse_last",
        "persistent_rice", "rrc_rice_ext", "bd_gt12", "is_i_slice",
        "log2_transform_range", "max_ts_cu_size_bins",
        "ctx_sig", "ctx_last_x", "ctx_last_y", "ctx_sb_coded", "ctx_gtx",
        "ctx_par", "ctx_ts_sig", "ctx_ts_sign", "ctx_ts_gtx", "ctx_ts_par",
        "ctx_ts_lrg1",
        "stat_coeff",
        "max_scan_x", "max_scan_y", "min_scan_x", "min_scan_y",
        "lfnst_dc_only", "lfnst_zero_out", "mts_dc_only", "mts_zero_out",
        "ts_rice")]


@functools.lru_cache()
def load_lib():
    """Load (building if needed) the native library; raises when it
    cannot be built."""
    lib = load_native("vvc_cabac", [_SRC])
    lib.cabac_init.argtypes = [ctypes.POINTER(_Cabac), ctypes.c_char_p,
                               ctypes.c_long, ctypes.c_long] + \
        [ctypes.c_void_p] * 4
    for name, args, res in (
            ("cabac_decode_bin", [ctypes.POINTER(_Cabac), ctypes.c_int],
             ctypes.c_int),
            ("cabac_decode_bypass", [ctypes.POINTER(_Cabac)], ctypes.c_int),
            ("cabac_decode_bypass_bits",
             [ctypes.POINTER(_Cabac), ctypes.c_int], ctypes.c_int),
            ("cabac_decode_terminate", [ctypes.POINTER(_Cabac)],
             ctypes.c_int),
            ("cabac_truncated_binary", [ctypes.POINTER(_Cabac),
                                        ctypes.c_int], ctypes.c_int),
            ("cabac_limited_egk", [ctypes.POINTER(_Cabac), ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int],
             ctypes.c_int),
            ("decode_residual_regular",
             [ctypes.POINTER(_Cabac), ctypes.POINTER(_ResParams),
              ctypes.c_void_p] + [ctypes.c_void_p] * 4, ctypes.c_int)):
        f = getattr(lib, name)
        f.argtypes = args
        f.restype = res
    return lib


class NativeCabacDecoder:
    """Drop-in replacement for engine.CabacDecoder backed by C."""

    __slots__ = ("lib", "c", "_data", "_arrays", "states")

    def __init__(self, data: bytes, bit_pos: int, states=None):
        self.lib = load_lib()
        self._data = data          # keep alive
        self.c = _Cabac()
        self._arrays = None
        self.states = None
        if states is not None:
            self.set_states(states)
        self.lib.cabac_init(ctypes.byref(self.c), data, 8 * len(data),
                            bit_pos, *self._state_ptrs())

    def _state_ptrs(self):
        if self._arrays is None:
            return (None, None, None, None)
        return tuple(a.ctypes.data_as(ctypes.c_void_p)
                     for a in self._arrays)

    def set_states(self, states):
        if states is None:
            self._arrays = None
            self.states = None
            return
        self._arrays = [np.ascontiguousarray(np.asarray(a, dtype=np.int32))
                        for a in states]
        self.states = self._arrays
        self.c.s0, self.c.s1, self.c.sh0, self.c.sh1 = \
            (a.ctypes.data_as(ctypes.c_void_p).value for a in self._arrays)

    # --- engine ops ---------------------------------------------------------

    def decode_bin(self, idx):
        return self.lib.cabac_decode_bin(ctypes.byref(self.c), idx)

    def decode_bypass(self):
        return self.lib.cabac_decode_bypass(ctypes.byref(self.c))

    def decode_bypass_bits(self, n):
        return self.lib.cabac_decode_bypass_bits(ctypes.byref(self.c), n)

    def decode_terminate(self):
        return self.lib.cabac_decode_terminate(ctypes.byref(self.c))

    def truncated_binary(self, c_max):
        return self.lib.cabac_truncated_binary(ctypes.byref(self.c), c_max)

    def limited_egk(self, k, max_pre, trunc):
        return self.lib.cabac_limited_egk(ctypes.byref(self.c), k, max_pre,
                                          trunc)

    def byte_pos_after_terminate(self):
        return (self.c.pos + 7) >> 3

    @property
    def pos(self):
        return self.c.pos


_SCAN_KEEP = {}


@functools.lru_cache(maxsize=256)
def _scan_u8(w, h):
    """(x, y) diagonal-scan component pointers as c_void_p; the backing
    arrays are pinned in _SCAN_KEEP."""
    from ..ops.data import diag_scan
    s = diag_scan(w, h)
    sx = np.ascontiguousarray(s[:, 0].astype(np.uint8))
    sy = np.ascontiguousarray(s[:, 1].astype(np.uint8))
    _SCAN_KEEP[(w, h)] = (sx, sy)
    return (ctypes.c_void_p(sx.ctypes.data), ctypes.c_void_p(sy.ctypes.data))


def decode_residual_regular_native(coder, tb, log2_zo_w, log2_zo_h):
    """C fast path for _code_residual_regular's decode branch.  Returns True
    when handled."""
    e = coder.e
    if not isinstance(e, NativeCabacDecoder):
        return False
    pp = getattr(coder, "_res_pp_native", None)
    if pp is None:
        # slice-constant fields filled once; per-TB fields set below
        from .engine import CTX
        sps = coder.sps
        rsh = coder.sh.r
        pp = _ResParams()
        pp.dep_quant = rsh.sh_dep_quant_used_flag
        pp.sdh = rsh.sh_sign_data_hiding_used_flag
        pp.reverse_last = rsh.sh_reverse_last_sig_coeff_flag
        pp.persistent_rice = sps.r.sps_persistent_rice_adaptation_enabled_flag
        pp.rrc_rice_ext = sps.r.sps_rrc_rice_extension_flag
        pp.bd_gt12 = int(sps.bit_depth > 12)
        pp.is_i_slice = int(rsh.sh_slice_type == 2)
        pp.log2_transform_range = coder.log2_transform_range
        pp.ctx_sig = CTX.SIG_COEFF_FLAG
        pp.ctx_last_x = CTX.LAST_SIG_COEFF_X_PREFIX
        pp.ctx_last_y = CTX.LAST_SIG_COEFF_Y_PREFIX
        pp.ctx_sb_coded = CTX.SB_CODED_FLAG
        pp.ctx_gtx = CTX.ABS_LEVEL_GTX_FLAG
        pp.ctx_par = CTX.PAR_LEVEL_FLAG
        coder._res_pp_native = pp
    pp.w, pp.h = tb.w, tb.h
    pp.log2_w, pp.log2_h = tb.log2_w, tb.log2_h
    pp.c_idx = tb.c_idx
    pp.log2_zo_w, pp.log2_zo_h = log2_zo_w, log2_zo_h
    pp.ts = tb.ts
    pp.stat_coeff = coder.stat_coeff[tb.c_idx]
    pp.max_scan_x = pp.max_scan_y = 0
    pp.lfnst_dc_only = 1
    pp.lfnst_zero_out = 1
    pp.mts_dc_only = 1
    pp.mts_zero_out = 1

    log2_sb_w = 1 if min(log2_zo_w, log2_zo_h) < 2 else 2
    log2_sb_h = log2_sb_w
    if log2_zo_w + log2_zo_h > 3:
        if log2_zo_w < 2:
            log2_sb_w = log2_zo_w
            log2_sb_h = 4 - log2_sb_w
        elif log2_zo_h < 2:
            log2_sb_h = log2_zo_h
            log2_sb_w = 4 - log2_sb_h
    sb_sx, sb_sy = _scan_u8(1 << (log2_zo_w - log2_sb_w),
                            1 << (log2_zo_h - log2_sb_h))
    sx, sy = _scan_u8(1 << log2_sb_w, 1 << log2_sb_h)

    coeffs = np.zeros((tb.h, tb.w), dtype=np.int32)
    e.lib.decode_residual_regular(
        ctypes.byref(e.c), ctypes.byref(pp),
        ctypes.c_void_p(coeffs.ctypes.data), sb_sx, sb_sy, sx, sy)
    tb.coeffs = coeffs
    tb.max_scan_x = pp.max_scan_x
    tb.max_scan_y = pp.max_scan_y
    coder.stat_coeff[tb.c_idx] = pp.stat_coeff
    p = coder.parse
    if not pp.lfnst_dc_only:
        p.lfnst_dc_only = 0
    if not pp.lfnst_zero_out:
        p.lfnst_zero_out_sig_coeff_flag = 0
    if not pp.mts_dc_only:
        p.mts_dc_only = 0
    if not pp.mts_zero_out:
        p.mts_zero_out_sig_coeff_flag = 0
    return True
