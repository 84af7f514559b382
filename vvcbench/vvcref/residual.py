# Frozen copy of ffvvc_tpu_torch/residual.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: imports data from the package root; the native C residual
#   decode (`cabac/native.py`) branch of `_code_residual_regular` is removed.
"""Residual coding (H.266 7.3.11.11 regular path, 7.3.11.12 transform-skip
path), bidirectional.

The same traversal runs in decode mode (CabacDecoder) and encode mode
(CabacEncoder + target coefficient array), so every context-index derivation
is shared between the decoder and the stream forge.

Reference analogue: libavcodec/vvc/vvc_cabac.c:1760-2430
(init_residual_coding :1992, residual_coding_subblock :2168,
residual_ts_coding_subblock :2036, last_sig_coeff :1676-1744).
"""
from __future__ import annotations

import numpy as np

from .cabac.engine import CTX
from .data import diag_scan

QSTATE_TRANSLATE = ((0, 2), (2, 0), (1, 3), (3, 1))


def ilog2(v) -> int:
    return int(v).bit_length() - 1


class TransformBlock:
    __slots__ = ("x0", "y0", "w", "h", "log2_w", "log2_h", "c_idx", "ts",
                 "coeffs", "max_scan_x", "max_scan_y", "min_scan_x",
                 "min_scan_y", "has_coeffs", "residual_ready", "itx_queued")

    def __init__(self, x0, y0, w, h, c_idx):
        self.x0 = x0
        self.y0 = y0
        self.w = w
        self.h = h
        self.log2_w = ilog2(w)
        self.log2_h = ilog2(h)
        self.c_idx = c_idx
        self.ts = 0
        self.has_coeffs = 0
        self.coeffs = None  # np.int32 [h, w], filled by residual coding
        self.max_scan_x = self.max_scan_y = 0
        self.min_scan_x = self.min_scan_y = 0
        self.residual_ready = False
        self.itx_queued = False


class ResidualCtx:
    """Per-TB residual coding state (reference ResidualCoding struct)."""

    def __init__(self, coder, tb: TransformBlock, log2_zo_w, log2_zo_h):
        sps = coder.sps
        log2_sb_w = 1 if min(log2_zo_w, log2_zo_h) < 2 else 2
        log2_sb_h = log2_sb_w
        if log2_zo_w + log2_zo_h > 3:
            if log2_zo_w < 2:
                log2_sb_w = log2_zo_w
                log2_sb_h = 4 - log2_sb_w
            elif log2_zo_h < 2:
                log2_sb_h = log2_zo_h
                log2_sb_w = 4 - log2_sb_h
        self.log2_sb_w = log2_sb_w
        self.log2_sb_h = log2_sb_h
        self.num_sb_coeff = 1 << (log2_sb_w + log2_sb_h)
        self.last_sub_block = (1 << (log2_zo_w + log2_zo_h -
                                     (log2_sb_w + log2_sb_h))) - 1
        pra = sps.r.sps_persistent_rice_adaptation_enabled_flag
        self.hist_value = (1 << coder.stat_coeff[tb.c_idx]) if pra else 0
        self.update_hist = 1 if pra else 0
        self.rem_bins_pass1 = ((1 << (log2_zo_w + log2_zo_h)) * 7) >> 2
        sb_scan = diag_scan(1 << (log2_zo_w - log2_sb_w), 1 << (log2_zo_h - log2_sb_h))
        self.sb_scan_x = sb_scan[:, 0]
        self.sb_scan_y = sb_scan[:, 1]
        scan = diag_scan(1 << log2_sb_w, 1 << log2_sb_h)
        self.scan_x = scan[:, 0]
        self.scan_y = scan[:, 1]
        self.infer_sb_cbf = 1
        self.width_in_sbs = 1 << (log2_zo_w - log2_sb_w)
        self.height_in_sbs = 1 << (log2_zo_h - log2_sb_h)
        self.nb_sbs = self.width_in_sbs * self.height_in_sbs
        self.last_scan_pos = self.num_sb_coeff
        self.qstate = 0
        self.tb = tb
        w, h = tb.w, tb.h
        self.sig_coeff_flag = np.zeros((h, w), dtype=np.int32)
        self.abs_level_pass1 = np.zeros((h, w), dtype=np.int32)
        self.abs_level = np.zeros((h, w), dtype=np.int32)
        self.coeff_sign_level = np.zeros((h, w), dtype=np.int32)
        self.sb_coded_flag = np.zeros((self.height_in_sbs, self.width_in_sbs),
                                      dtype=np.int32)
        self.last_significant_coeff_x = 0
        self.last_significant_coeff_y = 0


def _local_sum(level, w, h, xc, yc, hist):
    """9.3.4.2.7 locSumAbs over the right/below template."""
    s = 3 * hist
    if xc < w - 1:
        s += level[yc, xc + 1]
        if xc < w - 2:
            s += level[yc, xc + 2] - hist
        if yc < h - 1:
            s += level[yc + 1, xc + 1] - hist
    if yc < h - 1:
        s += level[yc + 1, xc]
        if yc < h - 2:
            s += level[yc + 2, xc] - hist
    return s


_RICE_PARAMS = (0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2,
                2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3)


def _rice_param(coder, rc, xc, yc, base_level):
    tb = rc.tb
    s = _local_sum(rc.abs_level, tb.w, tb.h, xc, yc, rc.hist_value)
    if not coder.sps.r.sps_rrc_rice_extension_flag:
        shift = 0
    else:
        shift = (ilog2(max(min(s, 2048), 8)) - 3) & ~1
    s = max(0, min(31, (s >> shift) - base_level * 5))
    return _RICE_PARAMS[s] + shift


def _sig_ctx(coder, rc, xc, yc):
    tb = rc.tb
    if tb.ts and not coder.sh.r.sh_ts_residual_coding_disabled_flag:
        n = (rc.sig_coeff_flag[yc, xc - 1] if xc > 0 else 0) + \
            (rc.sig_coeff_flag[yc - 1, xc] if yc > 0 else 0)
        return CTX.SIG_COEFF_FLAG + 60 + n
    d = xc + yc
    s = _local_sum(rc.abs_level_pass1, tb.w, tb.h, xc, yc, 0)
    if tb.c_idx == 0:
        inc = 12 * max(0, rc.qstate - 1) + min((s + 1) >> 1, 3) + \
            (8 if d < 2 else (4 if d < 5 else 0))
    else:
        inc = 36 + 8 * max(0, rc.qstate - 1) + min((s + 1) >> 1, 3) + \
            (4 if d < 2 else 0)
    return CTX.SIG_COEFF_FLAG + inc


def _gtx_ctx(rc, xc, yc, last):
    tb = rc.tb
    if last:
        return (0, 21, 21)[tb.c_idx]
    d = xc + yc
    lns = _local_sum(rc.sig_coeff_flag, tb.w, tb.h, xc, yc, rc.hist_value)
    lsap1 = _local_sum(rc.abs_level_pass1, tb.w, tb.h, xc, yc, rc.hist_value)
    offset = min(lsap1 - lns, 4)
    if tb.c_idx == 0:
        return 1 + offset + (15 if not d else (10 if d < 3 else (5 if d < 10 else 0)))
    return 22 + offset + (5 if not d else 0)


def _sb_coded_ctx(coder, rc, xs, ys):
    tb = rc.tb
    if tb.ts and not coder.sh.r.sh_ts_residual_coding_disabled_flag:
        left = rc.sb_coded_flag[ys, xs - 1] if xs > 0 else 0
        above = rc.sb_coded_flag[ys - 1, xs] if ys > 0 else 0
        inc = left + above + 4
    else:
        right = rc.sb_coded_flag[ys, xs + 1] if xs < rc.width_in_sbs - 1 else 0
        bottom = rc.sb_coded_flag[ys + 1, xs] if ys < rc.height_in_sbs - 1 else 0
        inc = (right | bottom) + (2 if tb.c_idx else 0)
    return CTX.SB_CODED_FLAG + int(inc)


def _abs_coding(coder, c_rice, value=None):
    """prefix (TRu 6) + rice/EGk suffix; returns value (decode) or codes it."""
    sps = coder.sps
    MAX_BIN = 6
    if coder.decode:
        e = coder.e
        prefix = 0
        while prefix < MAX_BIN and e.decode_bypass():
            prefix += 1
        if prefix < MAX_BIN:
            suffix = e.decode_bypass_bits(c_rice) if c_rice else 0
        else:
            suffix = e.limited_egk(c_rice + 1, 26 - coder.log2_transform_range,
                                   coder.log2_transform_range)
        return suffix + (prefix << c_rice)
    e = coder.e
    prefix = min(value >> c_rice, MAX_BIN)
    for _ in range(prefix):
        e.encode_bypass(1)
    if prefix < MAX_BIN:
        e.encode_bypass(0)
        if c_rice:
            e.encode_bypass_bits(value & ((1 << c_rice) - 1), c_rice)
    else:
        e.limited_egk(value - (MAX_BIN << c_rice), c_rice + 1,
                      26 - coder.log2_transform_range,
                      coder.log2_transform_range)
    return value


def _update_hist(coder, rc, remainder, addin):
    if rc.update_hist and remainder > 0:
        c = rc.tb.c_idx
        coder.stat_coeff[c] = (coder.stat_coeff[c] + ilog2(remainder) + addin) >> 1
        rc.update_hist = 0


def _last_sig_prefix(coder, log2_tb_size, log2_zo_size, c_idx, base, value=None):
    """last_sig_coeff_{x,y}_prefix: truncated unary with derived ctx."""
    if not log2_tb_size:
        return 0
    cmax = (log2_zo_size << 1) - 1
    if c_idx == 0:
        offset = (0, 0, 3, 6, 10, 15)[log2_tb_size - 1]
        shift = (log2_tb_size + 1) >> 2
    else:
        offset = 20
        shift = (0, 0, 0, 1, 2, 2, 2)[log2_tb_size]
    if coder.decode:
        i = 0
        while i < cmax and coder.e.decode_bin(base + (i >> shift) + offset):
            i += 1
        return i
    for i in range(value):
        coder.e.encode_bin(base + (i >> shift) + offset, 1)
    if value < cmax:
        coder.e.encode_bin(base + (value >> shift) + offset, 0)
    return value


def _prefix_to_pos(prefix, suffix):
    return (1 << ((prefix >> 1) - 1)) * (2 + (prefix & 1)) + suffix


def _pos_to_prefix_suffix(pos):
    """Inverse of last_sig binarization: pos -> (prefix, suffix, suffix_len)."""
    if pos <= 3:
        return pos, 0, 0
    import math
    g = ilog2(pos)
    # prefix encodes group: for prefix p>3: base = (1<<((p>>1)-1)) * (2+(p&1))
    for p in range(4, 2 * 6):
        base = (1 << ((p >> 1) - 1)) * (2 + (p & 1))
        nxt = (1 << (((p + 1) >> 1) - 1)) * (2 + ((p + 1) & 1))
        if base <= pos < nxt:
            return p, pos - base, (p >> 1) - 1
    raise ValueError(pos)


def code_residual(coder, tb: TransformBlock, sbt_flag=False, bdpcm=0):
    """Entry: ff_vvc_residual_coding analogue. In encode mode tb.coeffs holds
    the target TransCoeffLevel values."""
    ts = tb.ts and not coder.sh.r.sh_ts_residual_coding_disabled_flag
    if ts:
        return _code_residual_ts(coder, tb, bdpcm)
    return _code_residual_regular(coder, tb, sbt_flag)


def _code_residual_regular(coder, tb: TransformBlock, sbt_flag):
    sps = coder.sps
    rsh = coder.sh.r
    if sps.r.sps_mts_enabled_flag and sbt_flag and not tb.c_idx and \
            tb.log2_w == 5 and tb.log2_h < 6:
        log2_zo_w = 4
    else:
        log2_zo_w = min(tb.log2_w, 5)
    if sps.r.sps_mts_enabled_flag and sbt_flag and not tb.c_idx and \
            tb.log2_w < 6 and tb.log2_h == 5:
        log2_zo_h = 4
    else:
        log2_zo_h = min(tb.log2_h, 5)
    rc = ResidualCtx(coder, tb, log2_zo_w, log2_zo_h)
    dec = coder.decode
    if dec:
        tb.coeffs = np.zeros((tb.h, tb.w), dtype=np.int32)
    else:
        # derive AbsLevel & signs from target coeffs (inverse of final pass)
        _prepare_encode_levels(coder, rc, tb)

    # last significant coeff x/y
    if dec:
        px = _last_sig_prefix(coder, tb.log2_w, log2_zo_w, tb.c_idx,
                              CTX.LAST_SIG_COEFF_X_PREFIX)
        py = _last_sig_prefix(coder, tb.log2_h, log2_zo_h, tb.c_idx,
                              CTX.LAST_SIG_COEFF_Y_PREFIX)
        last_x, last_y = px, py
        if px > 3:
            n = (px >> 1) - 1
            last_x = _prefix_to_pos(px, coder.e.decode_bypass_bits(n))
        if py > 3:
            n = (py >> 1) - 1
            last_y = _prefix_to_pos(py, coder.e.decode_bypass_bits(n))
    else:
        last_x, last_y = rc.enc_last_x, rc.enc_last_y
        px, sx, nx = _pos_to_prefix_suffix(last_x)
        py, sy, ny = _pos_to_prefix_suffix(last_y)
        _last_sig_prefix(coder, tb.log2_w, log2_zo_w, tb.c_idx,
                         CTX.LAST_SIG_COEFF_X_PREFIX, px)
        _last_sig_prefix(coder, tb.log2_h, log2_zo_h, tb.c_idx,
                         CTX.LAST_SIG_COEFF_Y_PREFIX, py)
        if px > 3:
            coder.e.encode_bypass_bits(sx, nx)
        if py > 3:
            coder.e.encode_bypass_bits(sy, ny)
    if rsh.sh_reverse_last_sig_coeff_flag:
        last_x = (1 << log2_zo_w) - 1 - last_x
        last_y = (1 << log2_zo_h) - 1 - last_y
    rc.last_significant_coeff_x = last_x
    rc.last_significant_coeff_y = last_y

    # derive last_scan_pos / last_sub_block
    while True:
        if not rc.last_scan_pos:
            rc.last_scan_pos = rc.num_sb_coeff
            rc.last_sub_block -= 1
        rc.last_scan_pos -= 1
        xs = rc.sb_scan_x[rc.last_sub_block]
        ys = rc.sb_scan_y[rc.last_sub_block]
        xc = (xs << rc.log2_sb_w) + rc.scan_x[rc.last_scan_pos]
        yc = (ys << rc.log2_sb_h) + rc.scan_y[rc.last_scan_pos]
        if xc == last_x and yc == last_y:
            break

    # parse-state side effects for LFNST/MTS signalling
    if rc.last_sub_block == 0 and tb.log2_w >= 2 and tb.log2_h >= 2 and \
            not tb.ts and rc.last_scan_pos > 0:
        coder.parse.lfnst_dc_only = 0
    if (rc.last_sub_block > 0 and tb.log2_w >= 2 and tb.log2_h >= 2) or \
            (rc.last_scan_pos > 7 and tb.log2_w in (2, 3) and
             tb.log2_w == tb.log2_h):
        coder.parse.lfnst_zero_out_sig_coeff_flag = 0
    if (rc.last_sub_block > 0 or rc.last_scan_pos > 0) and not tb.c_idx:
        coder.parse.mts_dc_only = 0

    for i in range(rc.last_sub_block, -1, -1):
        _regular_subblock(coder, rc, i)
    return 0


def _prepare_encode_levels(coder, rc, tb):
    """Encode mode: fill rc.abs_level/sign arrays and last-coeff position from
    tb.coeffs (interpreted as TransCoeffLevel)."""
    rsh = coder.sh.r
    coeffs = tb.coeffs
    assert coeffs is not None
    # walk full scan order to find last significant position
    last = None
    dep = rsh.sh_dep_quant_used_flag
    # replay the decode-side final pass to derive AbsLevel per position.
    # with dep-quant: trans = (2*abs - (qstate>1))*sign; we must pick abs such
    # that the state machine (driven by abs) reproduces trans.  The forge
    # instead supplies *abs levels directly* via tb.coeffs when dep-quant is
    # on (values then are AbsLevel * sign); this keeps encoding closed-form.
    for sb in range(rc.nb_sbs):
        xs, ys = rc.sb_scan_x[sb], rc.sb_scan_y[sb]
        for n in range(rc.num_sb_coeff):
            xc = (xs << rc.log2_sb_w) + rc.scan_x[n]
            yc = (ys << rc.log2_sb_h) + rc.scan_y[n]
            v = int(coeffs[yc, xc])
            if v:
                last = (sb, n, xc, yc)
                rc.abs_level[yc, xc] = abs(v)
                rc.coeff_sign_level[yc, xc] = 1 if v > 0 else -1
    assert last is not None, "encode of all-zero TB should be skipped via cbf"
    rc.enc_last_x, rc.enc_last_y = last[2], last[3]
    # sb_coded flags
    for sb in range(rc.nb_sbs):
        xs, ys = rc.sb_scan_x[sb], rc.sb_scan_y[sb]
        blk = rc.abs_level[ys << rc.log2_sb_h:(ys + 1) << rc.log2_sb_h,
                           xs << rc.log2_sb_w:(xs + 1) << rc.log2_sb_w]
        rc.enc_sb_any = None
    # per-subblock coded flags are derived on the fly in _regular_subblock


def _regular_subblock(coder, rc, i):
    rsh = coder.sh.r
    tb = rc.tb
    dec = coder.decode
    e = coder.e
    infer_sb_dc_sig = 0
    xs = int(rc.sb_scan_x[i])
    ys = int(rc.sb_scan_y[i])
    start_qstate_sb = rc.qstate

    def sb_abs_any():
        y0, x0 = ys << rc.log2_sb_h, xs << rc.log2_sb_w
        return int(rc.abs_level[y0:y0 + (1 << rc.log2_sb_h),
                                x0:x0 + (1 << rc.log2_sb_w)].any())

    if i < rc.last_sub_block and i > 0:
        if dec:
            v = e.decode_bin(_sb_coded_ctx(coder, rc, xs, ys))
        else:
            v = sb_abs_any()
            e.encode_bin(_sb_coded_ctx(coder, rc, xs, ys), v)
        rc.sb_coded_flag[ys, xs] = v
        infer_sb_dc_sig = 1
    else:
        rc.sb_coded_flag[ys, xs] = 1
    if rc.sb_coded_flag[ys, xs] and (xs > 3 or ys > 3) and not tb.c_idx:
        coder.parse.mts_zero_out_sig_coeff_flag = 0
    if not rc.sb_coded_flag[ys, xs]:
        return

    first_sig = rc.num_sb_coeff
    last_sig = -1
    first_pos_mode0 = rc.last_scan_pos if i == rc.last_sub_block else rc.num_sb_coeff - 1
    first_pos_mode1 = first_pos_mode0
    gt2 = [0] * rc.num_sb_coeff

    n = first_pos_mode0
    while n >= 0 and rc.rem_bins_pass1 >= 4:
        xc = (xs << rc.log2_sb_w) + int(rc.scan_x[n])
        yc = (ys << rc.log2_sb_h) + int(rc.scan_y[n])
        last = (xc == rc.last_significant_coeff_x and
                yc == rc.last_significant_coeff_y)
        if (n > 0 or not infer_sb_dc_sig) and not last:
            ctx = _sig_ctx(coder, rc, xc, yc)
            if dec:
                sig = e.decode_bin(ctx)
            else:
                sig = int(rc.abs_level[yc, xc] != 0)
                e.encode_bin(ctx, sig)
            rc.sig_coeff_flag[yc, xc] = sig
            rc.rem_bins_pass1 -= 1
            if sig:
                infer_sb_dc_sig = 0
        else:
            sig = int(last or (not rc.scan_x[n] and not rc.scan_y[n] and
                               infer_sb_dc_sig))
            rc.sig_coeff_flag[yc, xc] = sig
        pass1 = 0
        if rc.sig_coeff_flag[yc, xc]:
            inc = _gtx_ctx(rc, xc, yc, last)
            if dec:
                gt1 = e.decode_bin(CTX.ABS_LEVEL_GTX_FLAG + inc)
            else:
                target = int(rc.abs_level[yc, xc])
                gt1 = int(target > 1)
                e.encode_bin(CTX.ABS_LEVEL_GTX_FLAG + inc, gt1)
            rc.rem_bins_pass1 -= 1
            par = 0
            if gt1:
                if dec:
                    par = e.decode_bin(CTX.PAR_LEVEL_FLAG + inc)
                    gt2[n] = e.decode_bin(CTX.ABS_LEVEL_GTX_FLAG + inc + 32)
                else:
                    target = int(rc.abs_level[yc, xc])
                    par = (target - 2) & 1
                    gt2[n] = int(target > 3)
                    e.encode_bin(CTX.PAR_LEVEL_FLAG + inc, par)
                    e.encode_bin(CTX.ABS_LEVEL_GTX_FLAG + inc + 32, gt2[n])
                rc.rem_bins_pass1 -= 2
            else:
                gt2[n] = 0
            if last_sig == -1:
                last_sig = n
            first_sig = n
            pass1 = 1 + par + gt1 + (gt2[n] << 1)
        else:
            gt2[n] = 0
        rc.abs_level_pass1[yc, xc] = pass1
        if rsh.sh_dep_quant_used_flag:
            rc.qstate = QSTATE_TRANSLATE[rc.qstate][pass1 & 1]
        first_pos_mode1 = n - 1
        n -= 1

    # pass 2: remainders for gt2 positions
    for n in range(first_pos_mode0, first_pos_mode1, -1):
        xc = (xs << rc.log2_sb_w) + int(rc.scan_x[n])
        yc = (ys << rc.log2_sb_h) + int(rc.scan_y[n])
        pass1 = int(rc.abs_level_pass1[yc, xc])
        if dec:
            rc.abs_level[yc, xc] = pass1
        if gt2[n]:
            c_rice = _rice_param(coder, rc, xc, yc,
                                 _base_level(coder))
            if dec:
                rem = _abs_coding(coder, c_rice)
                rc.abs_level[yc, xc] = pass1 + 2 * rem
            else:
                rem = (int(rc.abs_level[yc, xc]) - pass1) >> 1
                _abs_coding(coder, c_rice, rem)
            _update_hist(coder, rc, rem, 2)

    # pass 3: dec_abs_level positions
    for n in range(first_pos_mode1, -1, -1):
        xc = (xs << rc.log2_sb_w) + int(rc.scan_x[n])
        yc = (ys << rc.log2_sb_h) + int(rc.scan_y[n])
        c_rice = _rice_param(coder, rc, xc, yc, 0)
        zero_pos = (1 if rc.qstate < 2 else 2) << c_rice
        if dec:
            dec_abs = _abs_coding(coder, c_rice)
            if dec_abs == zero_pos:
                lvl = 0
            else:
                lvl = dec_abs + (1 if dec_abs < zero_pos else 0)
            rc.abs_level[yc, xc] = lvl
            _update_hist(coder, rc, dec_abs, 0)
        else:
            lvl = int(rc.abs_level[yc, xc])
            if lvl == 0:
                dec_abs = zero_pos
            elif lvl <= zero_pos:
                dec_abs = lvl - 1
            else:
                dec_abs = lvl
            _abs_coding(coder, c_rice, dec_abs)
            _update_hist(coder, rc, dec_abs, 0)
        if rc.abs_level[yc, xc] > 0:
            if last_sig == -1:
                last_sig = n
            first_sig = n
        if rsh.sh_dep_quant_used_flag:
            rc.qstate = QSTATE_TRANSLATE[rc.qstate][int(rc.abs_level[yc, xc]) & 1]

    sig_hidden = rsh.sh_sign_data_hiding_used_flag and \
        (last_sig - first_sig > 3)

    if rsh.sh_dep_quant_used_flag:
        rc.qstate = start_qstate_sb
    n = rc.last_scan_pos if i == rc.last_sub_block else rc.num_sb_coeff - 1
    ssum = 0
    while n >= 0:
        xc = (xs << rc.log2_sb_w) + int(rc.scan_x[n])
        yc = (ys << rc.log2_sb_h) + int(rc.scan_y[n])
        lvl = int(rc.abs_level[yc, xc])
        if lvl > 0:
            sign = 1
            if not sig_hidden or n != first_sig:
                if dec:
                    sign = 1 - 2 * e.decode_bypass()
                else:
                    sign = int(rc.coeff_sign_level[yc, xc])
                    e.encode_bypass(1 if sign < 0 else 0)
            if rsh.sh_dep_quant_used_flag:
                trans = (2 * lvl - (1 if rc.qstate > 1 else 0)) * sign
            else:
                trans = lvl * sign
                if sig_hidden:
                    ssum += lvl
                    if n == first_sig and (ssum % 2):
                        trans = -trans
            if dec:
                tb.coeffs[yc, xc] = trans
            tb.max_scan_x = max(xc, tb.max_scan_x)
            tb.max_scan_y = max(yc, tb.max_scan_y)
        if rsh.sh_dep_quant_used_flag:
            rc.qstate = QSTATE_TRANSLATE[rc.qstate][lvl & 1]
        n -= 1


def _base_level(coder):
    sps = coder.sps
    rsh = coder.sh.r
    base = ((4, 4), (4, 4)), ((3, 2), (2, 1))
    is_i = rsh.sh_slice_type == 2
    return base[sps.r.sps_rrc_rice_extension_flag][int(sps.bit_depth > 12)][int(is_i)]


# ---------------------------------------------------------------------------
# transform-skip residual path
# ---------------------------------------------------------------------------

def _code_residual_ts(coder, tb: TransformBlock, bdpcm):
    rc = ResidualCtx(coder, tb, tb.log2_w, tb.log2_h)
    dec = coder.decode
    if dec:
        tb.coeffs = np.zeros((tb.h, tb.w), dtype=np.int32)
    else:
        for yc in range(tb.h):
            for xc in range(tb.w):
                v = int(tb.coeffs[yc, xc])
                rc.abs_level[yc, xc] = abs(v)
                rc.coeff_sign_level[yc, xc] = 1 if v > 0 else (-1 if v < 0 else 0)
    tb.min_scan_x = tb.min_scan_y = 1 << 30
    for i in range(rc.last_sub_block + 1):
        _ts_subblock(coder, rc, i, bdpcm)
    return 0


def _ts_subblock(coder, rc, i, bdpcm):
    e = coder.e
    dec = coder.decode
    tb = rc.tb
    xs = int(rc.sb_scan_x[i])
    ys = int(rc.sb_scan_y[i])
    infer_sb_sig = 1
    last_pass1 = -1
    last_pass2 = -1
    gtx = [0] * rc.num_sb_coeff
    pass2 = [0] * rc.num_sb_coeff

    def sb_abs_any():
        y0, x0 = ys << rc.log2_sb_h, xs << rc.log2_sb_w
        return int(rc.abs_level[y0:y0 + (1 << rc.log2_sb_h),
                                x0:x0 + (1 << rc.log2_sb_w)].any())

    if i != rc.last_sub_block or not rc.infer_sb_cbf:
        ctx = _sb_coded_ctx(coder, rc, xs, ys)
        if dec:
            v = e.decode_bin(ctx)
        else:
            v = sb_abs_any()
            e.encode_bin(ctx, v)
        rc.sb_coded_flag[ys, xs] = v
    else:
        rc.sb_coded_flag[ys, xs] = 1
    sb_coded = int(rc.sb_coded_flag[ys, xs])
    if sb_coded and i < rc.last_sub_block:
        rc.infer_sb_cbf = 0

    # NOTE: in encode mode the TS path requires target abs levels whose
    # pass1/pass2 decomposition is derived below, mirroring decode exactly.
    # pass 1
    n = 0
    sign_after_pass1 = {}
    while n < rc.num_sb_coeff and rc.rem_bins_pass1 >= 4:
        xc = (xs << rc.log2_sb_w) + int(rc.scan_x[n])
        yc = (ys << rc.log2_sb_h) + int(rc.scan_y[n])
        par = 0
        gtx[n] = 0
        last_pass1 = n
        if sb_coded and (n != rc.num_sb_coeff - 1 or not infer_sb_sig):
            ctx = _sig_ctx(coder, rc, xc, yc)
            if dec:
                sig = e.decode_bin(ctx)
            else:
                sig = int(rc.abs_level[yc, xc] != 0)
                e.encode_bin(ctx, sig)
            rc.sig_coeff_flag[yc, xc] = sig
            rc.rem_bins_pass1 -= 1
            if sig:
                infer_sb_sig = 0
        else:
            rc.sig_coeff_flag[yc, xc] = int(
                n == rc.num_sb_coeff - 1 and infer_sb_sig and sb_coded)
        if not dec:
            # preserve encoder sign for final pass
            pass
        csl = 0
        if rc.sig_coeff_flag[yc, xc]:
            # coeff sign (ctx-coded in TS)
            left_s = int(rc.coeff_sign_level[yc, xc - 1]) if xc else 0
            above_s = int(rc.coeff_sign_level[yc - 1, xc]) if yc else 0
            if left_s == -above_s:
                inc = 3 if bdpcm else 0
            elif left_s >= 0 and above_s >= 0:
                inc = 4 if bdpcm else 1
            else:
                inc = 5 if bdpcm else 2
            if dec:
                s = e.decode_bin(CTX.COEFF_SIGN_FLAG + inc)
                csl = 1 - 2 * s
            else:
                csl = int(rc.coeff_sign_level[yc, xc]) or 1
                e.encode_bin(CTX.COEFF_SIGN_FLAG + inc, 1 if csl < 0 else 0)
            # gt1
            if bdpcm:
                inc1 = 67
            else:
                l = int(rc.sig_coeff_flag[yc, xc - 1]) if xc > 0 else 0
                a = int(rc.sig_coeff_flag[yc - 1, xc]) if yc > 0 else 0
                inc1 = 64 + a + l
            if dec:
                gtx[n] = e.decode_bin(CTX.ABS_LEVEL_GTX_FLAG + inc1)
            else:
                target = _ts_target_pass_level(rc, coder, xc, yc, bdpcm)
                gtx[n] = int(target > 1)
                e.encode_bin(CTX.ABS_LEVEL_GTX_FLAG + inc1, gtx[n])
            rc.rem_bins_pass1 -= 2
            if gtx[n]:
                if dec:
                    par = e.decode_bin(CTX.PAR_LEVEL_FLAG + 32)
                else:
                    target = _ts_target_pass_level(rc, coder, xc, yc, bdpcm)
                    par = (target - 2) & 1 if target >= 2 else 0
                    e.encode_bin(CTX.PAR_LEVEL_FLAG + 32, par)
                rc.rem_bins_pass1 -= 1
        if dec:
            rc.coeff_sign_level[yc, xc] = csl
        rc.abs_level_pass1[yc, xc] = rc.sig_coeff_flag[yc, xc] + par + gtx[n]
        n += 1

    # pass 2: gt3..gt9
    n2 = 0
    while n2 < rc.num_sb_coeff and rc.rem_bins_pass1 >= 4 and n2 < n:
        xc = (xs << rc.log2_sb_w) + int(rc.scan_x[n2])
        yc = (ys << rc.log2_sb_h) + int(rc.scan_y[n2])
        pass2[n2] = int(rc.abs_level_pass1[yc, xc])
        j = 1
        g = gtx[n2]
        while j < 5 and g:
            if dec:
                g = e.decode_bin(CTX.ABS_LEVEL_GTX_FLAG + 67 + j)
            else:
                target = _ts_target_pass_level(rc, coder, xc, yc, bdpcm)
                g = int(target > 2 * j + 1)
                e.encode_bin(CTX.ABS_LEVEL_GTX_FLAG + 67 + j, g)
            pass2[n2] += g << 1
            rc.rem_bins_pass1 -= 1
            j += 1
        gtx[n2] = 0  # consumed
        last_pass2 = n2
        n2 += 1

    # remainder pass
    for m in range(rc.num_sb_coeff):
        xc = (xs << rc.log2_sb_w) + int(rc.scan_x[m])
        yc = (ys << rc.log2_sb_h) + int(rc.scan_y[m])
        pass1v = int(rc.abs_level_pass1[yc, xc])
        abs_rem = 0
        c_rice = coder.sh.r.sh_ts_residual_coding_rice_idx_minus1 + 1
        need_rem = (m <= last_pass2 and pass2[m] >= 10) or \
            (m > last_pass2 and m <= last_pass1 and pass1v >= 2) or \
            (m > last_pass1 and sb_coded)
        if need_rem:
            if dec:
                abs_rem = _abs_coding(coder, c_rice)
            else:
                target = _ts_target_pass_level(rc, coder, xc, yc, bdpcm)
                if m <= last_pass2:
                    abs_rem = (target - pass2[m]) >> 1
                elif m <= last_pass1:
                    abs_rem = (target - pass1v) >> 1
                else:
                    abs_rem = target
                _abs_coding(coder, c_rice, abs_rem)
        if m <= last_pass2:
            lvl = pass2[m] + 2 * abs_rem
        elif m <= last_pass1:
            lvl = pass1v + 2 * abs_rem
        else:
            lvl = abs_rem
            if abs_rem:
                if dec:
                    rc.coeff_sign_level[yc, xc] = 1 - 2 * e.decode_bypass()
                else:
                    s = int(rc.coeff_sign_level[yc, xc]) or 1
                    e.encode_bypass(1 if s < 0 else 0)
        if dec:
            rc.abs_level[yc, xc] = lvl
        if not bdpcm and m <= last_pass1:
            left = int(rc.abs_level[yc, xc - 1]) if xc > 0 else 0
            above = int(rc.abs_level[yc - 1, xc]) if yc > 0 else 0
            pred = max(left, above)
            if dec:
                if lvl == 1 and pred > 0:
                    lvl = pred
                elif lvl > 0 and lvl <= pred:
                    lvl -= 1
                rc.abs_level[yc, xc] = lvl
            else:
                lvl = int(rc.abs_level[yc, xc])
        else:
            lvl = int(rc.abs_level[yc, xc]) if not dec else lvl
        if dec:
            if lvl:
                tb.coeffs[yc, xc] = int(rc.coeff_sign_level[yc, xc]) * lvl
                tb.max_scan_x = max(xc, tb.max_scan_x)
                tb.max_scan_y = max(yc, tb.max_scan_y)
                tb.min_scan_x = min(xc, tb.min_scan_x)
                tb.min_scan_y = min(yc, tb.min_scan_y)
            else:
                tb.coeffs[yc, xc] = 0


def _ts_target_pass_level(rc, coder, xc, yc, bdpcm):
    """Encode-side: the 'coded level' the TS passes binarize for (xc,yc).

    Without bdpcm, the final level prediction (max(left, above)) is inverted:
    coded = lvl+1 if 0 < lvl <= pred... — the forge restricts itself to
    bdpcm/TS content where coded == abs_level (guaranteed by choosing
    monotone content), so we use abs_level directly. (Full inverse mapping
    lands with the TS forge level.)
    """
    return int(rc.abs_level[yc, xc])
