# Frozen copy of ffvvc_tpu_torch/inter.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: imports data from the package root; the C MC library
#   (`native/mc.py`) is removed: the fast paths of `_mc_put`, BDOF,
#   `_dmvr_bilinear` and the DMVR search go, the NumPy paths always run.
"""Inter prediction — golden scalar model (H.266 8.5.6).

Reference analogue: libavcodec/vvc/vvc_inter.c (control:
luma/chroma_mc_uni/bi :222-368, pred_regular :545-640, GPM :466, DMVR
:685-748, walk :899-913) and the interpolation kernels of
libavcodec/h26x/h2656_inter_template.c (8/4-tap h/v/hv,
put/put_uni/put_uni_w) + vvc_inter_template.c (avg/w_avg/ciip/gpm blends).

All math in numpy int32/int64 with explicit shifts — bit-exact vs the
reference C templates.  Edge emulation (replicate padding) is index-clamped
gather, the same semantics as ff_emulated_edge_mc.
"""
from __future__ import annotations

import numpy as np

from . import data as D
from .mvs import PF_INTRA, PF_L0, PF_L1, PF_BI, MvField, clip_mv

LUMA, CB, CR = 0, 1, 2


def _filters():
    t = D.tables()
    return t["luma_filters"], t["chroma_filters"], t["luma_dmvr_filters"]


def _gather_block(plane, x0, y0, w, h, box=None, wrap=0):
    """Replicate-padded block fetch (emulated_edge_mc semantics).  `box`
    (x_lo, x_hi, y_lo, y_hi, inclusive) restricts reads to a prefetch
    window (emulated_edge_dmvr, vvc_inter.c:60-89).  `wrap` is the
    horizontal wraparound MC offset in plane samples (spec 8.5.6.3.2
    ClipH; 0 = off)."""
    H, W = plane.shape
    ys = np.arange(y0, y0 + h)
    xs = np.arange(x0, x0 + w)
    if wrap:
        xs = np.where(xs < 0, xs + wrap, np.where(xs > W - 1, xs - wrap, xs))
    if box is not None:
        xs = np.clip(xs, box[0], box[1])
        ys = np.clip(ys, box[2], box[3])
    ys = np.clip(ys, 0, H - 1)
    xs = np.clip(xs, 0, W - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


def _filter_h(src, f, taps, out_w):
    """Horizontal FIR: src [h, out_w + taps - 1] -> [h, out_w]."""
    acc = np.zeros((src.shape[0], out_w), dtype=np.int64)
    for k in range(taps):
        acc += int(f[k]) * src[:, k:k + out_w]
    return acc


def _filter_v(src, f, taps, out_h):
    acc = np.zeros((out_h, src.shape[1]), dtype=np.int64)
    for k in range(taps):
        acc += int(f[k]) * src[k:k + out_h, :]
    return acc


class InterPredictor:
    """Per-slice inter prediction walk over parsed CUs."""

    def __init__(self, sps, pps, tabs, fb, sh, rpl, coder):
        self.sps = sps
        self.pps = pps
        self.tabs = tabs
        self.fb = fb
        self.sh = sh
        self.rpl = rpl
        self.c = coder      # CtuCoder (na flags for CIIP weight)
        self.bd = sps.bit_depth
        self.lmcs_fwd = None  # forward-mapping LUT when sh_lmcs_used_flag
        # wraparound MC offset in luma samples (0 = off)
        self.wrap = pps.ref_wraparound_offset * sps.min_cb_size_y

    # --- core interpolation (h2656_inter_template.c) -----------------------

    def _mc_put(self, ref_plane, x_int, y_int, frac_x, frac_y, w, h,
                is_luma, hf_idx=0, vf_idx=0, box=None):
        """put[LUMA/CHROMA][..][!!my][!!mx] -> int intermediate [h, w]
        (14-bit domain)."""
        wrap = getattr(self, "wrap", 0)
        if wrap and not is_luma:
            wrap >>= self.sps.hshift[1]
        lf, cf, _ = _filters()
        bd = self.bd
        if is_luma:
            taps, extra_before = 8, 3
            hf = lf[hf_idx][frac_x]
            vf = lf[vf_idx][frac_y]
        else:
            taps, extra_before = 4, 1
            hf = cf[hf_idx][frac_x]
            vf = cf[vf_idx][frac_y]
        if not frac_x and not frac_y:
            blk = _gather_block(ref_plane, x_int, y_int, w, h, box, wrap)
            return blk << (14 - bd)
        if frac_y == 0:
            src = _gather_block(ref_plane, x_int - extra_before, y_int,
                                w + taps - 1, h, box, wrap)
            return _filter_h(src, hf, taps, w) >> (bd - 8)
        if frac_x == 0:
            src = _gather_block(ref_plane, x_int, y_int - extra_before,
                                w, h + taps - 1, box, wrap)
            return _filter_v(src, vf, taps, h) >> (bd - 8)
        src = _gather_block(ref_plane, x_int - extra_before,
                            y_int - extra_before, w + taps - 1,
                            h + taps - 1, box, wrap)
        tmp = _filter_h(src, hf, taps, w) >> (bd - 8)
        return _filter_v(tmp, vf, taps, h) >> 6

    def _dmvr_box(self, x_sb, y_sb, w, h, is_luma):
        """Prefetch-window bounds for DMVR-refined MC
        (emulated_edge_dmvr, vvc_inter.c:60-89)."""
        sps = self.sps
        if is_luma:
            eb, ea = 3, 4
            pw, ph = self.pps.width, self.pps.height
        else:
            eb, ea = 1, 2
            pw = self.pps.width >> sps.hshift[1]
            ph = self.pps.height >> sps.vshift[1]
        sx = min(max(x_sb - eb, 0), pw - 1)
        sy = min(max(y_sb - eb, 0), ph - 1)
        wdt = max(min(pw, x_sb + w + ea) - sx, 1)
        hgt = max(min(ph, y_sb + h + ea) - sy, 1)
        return (sx, sx + wdt - 1, sy, sy + hgt - 1)

    def _uni_out(self, val14, weighted, denom=0, wx=0, ox=0):
        """put_uni / put_uni_w final stage: 14-bit -> pixel."""
        bd = self.bd
        if not weighted:
            shift = 14 - bd
            off = 1 << (shift - 1)
            out = (val14 + off) >> shift
        else:
            shift = denom + 14 - bd
            off = 1 << (shift - 1) if shift > 0 else 0
            out = ((val14 * wx + off) >> shift) + (ox << (bd - 8))
        return np.clip(out, 0, (1 << bd) - 1)

    def _avg(self, s0, s1):
        bd = self.bd
        shift = max(3, 15 - bd)
        off = 1 << (shift - 1)
        return np.clip((s0 + s1 + off) >> shift, 0, (1 << bd) - 1)

    def _w_avg(self, s0, s1, denom, w0, w1, o0, o1):
        bd = self.bd
        shift = denom + max(3, 15 - bd)
        off = (((o0 + o1) << (bd - 8)) + 1) << (shift - 1)
        return np.clip((s0 * w0 + s1 * w1 + off) >> shift, 0, (1 << bd) - 1)

    # --- weight derivation (vvc_inter.c:129-178) ---------------------------

    def _derive_weight_uni(self, mvf, c_idx):
        sh = self.sh
        if not sh.weighted_pred:
            return None
        lx = mvf.pred_flag - PF_L0
        w = sh.pwt
        return (w.log2_denom[c_idx > 0], w.weight(lx, c_idx, mvf.ref_idx[lx]),
                w.offset(lx, c_idx, mvf.ref_idx[lx]))

    _BCW_W_LUT = (4, 5, 3, 10, -2)

    def _derive_weight(self, mvf, c_idx, dmvr_flag, ciip_flag):
        sh = self.sh
        # reference: weight_flag = (IS_P && wp) || (IS_B && wbp && !dmvr)
        weight_flag = sh.weighted_pred and not (dmvr_flag and sh.is_b)
        bcw_idx = mvf.bcw_idx
        if (not weight_flag and not bcw_idx) or (bcw_idx and ciip_flag):
            return None
        if bcw_idx:
            w1 = self._BCW_W_LUT[bcw_idx]
            return (2, 8 - w1, w1, 0, 0)
        w = sh.pwt
        return (w.log2_denom[c_idx > 0],
                w.weight(0, c_idx, mvf.ref_idx[0]),
                w.weight(1, c_idx, mvf.ref_idx[1]),
                w.offset(0, c_idx, mvf.ref_idx[0]),
                w.offset(1, c_idx, mvf.ref_idx[1]))

    # --- per-block prediction ----------------------------------------------

    def _ref_frame(self, lx, ref_idx):
        return self.rpl[lx].frames[ref_idx]

    def _luma_uni(self, dst_view, ref_fb, mvf, x0, y0, w, h, hf_idx, vf_idx):
        lx = mvf.pred_flag - PF_L0
        mv = mvf.mv[lx]
        mx, my = mv[0] & 0xF, mv[1] & 0xF
        xi = x0 + (mv[0] >> 4)
        yi = y0 + (mv[1] >> 4)
        val = self._mc_put(ref_fb.planes[0], xi, yi, mx, my, w, h, True,
                           hf_idx, vf_idx)
        wgt = self._derive_weight_uni(mvf, LUMA)
        if wgt is None:
            dst_view[:] = self._uni_out(val, False)
        else:
            dst_view[:] = self._uni_out(val, True, *wgt)

    def _luma_bi(self, dst_view, refs, mvf, x0, y0, w, h, hf_idx, vf_idx,
                 dmvr_flag=0, ciip_flag=0, orig_mv=None, sb_bdof_flag=0):
        tmp = []
        fetched = []
        for i in range(2):
            mv = mvf.mv[i]
            mx, my = mv[0] & 0xF, mv[1] & 0xF
            xi = x0 + (mv[0] >> 4)
            yi = y0 + (mv[1] >> 4)
            box = None
            if dmvr_flag:
                box = self._dmvr_box(x0 + (orig_mv.mv[i][0] >> 4),
                                     y0 + (orig_mv.mv[i][1] >> 4), w, h, True)
            tmp.append(self._mc_put(refs[i].planes[0], xi, yi, mx, my, w, h,
                                    True, hf_idx, vf_idx, box))
            if sb_bdof_flag:
                # bdof_fetch_samples: (h+2, w+2) integer-sample ring
                intg = _gather_block(refs[i].planes[0],
                                     xi + (mx >> 3) - 1, yi + (my >> 3) - 1,
                                     w + 2, h + 2, box,
                                     self.wrap) << (14 - self.bd)
                intg[1:1 + h, 1:1 + w] = tmp[i]
                fetched.append(intg)
        if sb_bdof_flag:
            dst_view[:] = self._apply_bdof(fetched[0], fetched[1], w, h)
            return
        wgt = self._derive_weight(mvf, LUMA, dmvr_flag, ciip_flag)
        if wgt is None:
            dst_view[:] = self._avg(tmp[0], tmp[1])
        else:
            dst_view[:] = self._w_avg(tmp[0], tmp[1], *wgt)

    def _apply_bdof(self, s0p, s1p, w, h):
        """apply_bdof (vvc_inter_template.c:289): s0p/s1p are (h+2, w+2)
        with the integer-sample border ring."""
        bd = self.bd
        grads = []
        for sp in (s0p, s1p):
            gh = (sp[1:1 + h, 2:2 + w] >> 6) - (sp[1:1 + h, 0:w] >> 6)
            gv = (sp[2:2 + h, 1:1 + w] >> 6) - (sp[0:h, 1:1 + w] >> 6)
            # pad gradients with a replicated ring (pad=1)
            ghp = np.pad(gh, 1, mode="edge")
            gvp = np.pad(gv, 1, mode="edge")
            grads.append((ghp, gvp))
        # pad src: replicate the CENTER block ring (pad_int16 overwrites the
        # fetched border after gradients are computed, vvcdsp.c:29)
        sp0 = np.pad(s0p[1:1 + h, 1:1 + w], 1, mode="edge")
        sp1 = np.pad(s1p[1:1 + h, 1:1 + w], 1, mode="edge")
        shift4 = 15 - bd
        off4 = 1 << (shift4 - 1)
        out = np.zeros((h, w), dtype=np.int64)
        sign = lambda v: np.sign(v)
        for by in range(0, h, 4):
            for bx in range(0, w, 4):
                w0 = sp0[by:by + 6, bx:bx + 6]
                w1 = sp1[by:by + 6, bx:bx + 6]
                diff = (w0 >> 4) - (w1 >> 4)
                th = (grads[0][0][by:by + 6, bx:bx + 6] +
                      grads[1][0][by:by + 6, bx:bx + 6]) >> 1
                tv = (grads[0][1][by:by + 6, bx:bx + 6] +
                      grads[1][1][by:by + 6, bx:bx + 6]) >> 1
                sgx2 = int(np.abs(th).sum())
                sgy2 = int(np.abs(tv).sum())
                sgxgy = int((sign(tv) * th).sum())
                sgxdi = int((-sign(th) * diff).sum())
                sgydi = int((-sign(tv) * diff).sum())
                thres = 16
                vx = 0
                if sgx2 > 0:
                    vx = min(max((sgxdi << 2) >> (sgx2.bit_length() - 1),
                                 -thres + 1), thres - 1)
                vy = 0
                if sgy2 > 0:
                    vy = min(max(((sgydi << 2) - ((vx * sgxgy) >> 1)) >>
                                 (sgy2.bit_length() - 1),
                                 -thres + 1), thres - 1)
                # apply on the 4x4 center (unpadded gradients)
                gh0 = grads[0][0][by + 1:by + 5, bx + 1:bx + 5]
                gh1 = grads[1][0][by + 1:by + 5, bx + 1:bx + 5]
                gv0 = grads[0][1][by + 1:by + 5, bx + 1:bx + 5]
                gv1 = grads[1][1][by + 1:by + 5, bx + 1:bx + 5]
                boff = vx * (gh0 - gh1) + vy * (gv0 - gv1)
                c0 = s0p[1 + by:5 + by, 1 + bx:5 + bx]
                c1 = s1p[1 + by:5 + by, 1 + bx:5 + bx]
                out[by:by + 4, bx:bx + 4] = \
                    (c0 + off4 + c1 + boff) >> shift4
        return np.clip(out, 0, (1 << bd) - 1)

    def _chroma_uni(self, dst_view, plane, mvf, x0c, y0c, wc, hc, c_idx):
        sps = self.sps
        hs, vs = sps.hshift[1], sps.vshift[1]
        lx = mvf.pred_flag - PF_L0
        mv = mvf.mv[lx]
        mx = (mv[0] & ((1 << (4 + hs)) - 1)) << (1 - hs)
        my = (mv[1] & ((1 << (4 + vs)) - 1)) << (1 - vs)
        xi = x0c + (mv[0] >> (4 + hs))
        yi = y0c + (mv[1] >> (4 + vs))
        val = self._mc_put(plane, xi, yi, mx, my, wc, hc, False)
        wgt = self._derive_weight_uni(mvf, c_idx)
        if wgt is None:
            dst_view[:] = self._uni_out(val, False)
        else:
            dst_view[:] = self._uni_out(val, True, *wgt)

    def _chroma_bi(self, dst_view, refs, mvf, x0c, y0c, wc, hc, c_idx,
                   dmvr_flag=0, ciip_flag=0, orig_mv=None):
        sps = self.sps
        hs, vs = sps.hshift[1], sps.vshift[1]
        tmp = []
        for i in range(2):
            mv = mvf.mv[i]
            mx = (mv[0] & ((1 << (4 + hs)) - 1)) << (1 - hs)
            my = (mv[1] & ((1 << (4 + vs)) - 1)) << (1 - vs)
            xi = x0c + (mv[0] >> (4 + hs))
            yi = y0c + (mv[1] >> (4 + vs))
            box = None
            if dmvr_flag and orig_mv is not None:
                box = self._dmvr_box(x0c + (orig_mv.mv[i][0] >> (4 + hs)),
                                     y0c + (orig_mv.mv[i][1] >> (4 + vs)),
                                     wc, hc, False)
            tmp.append(self._mc_put(refs[i].planes[c_idx], xi, yi, mx, my,
                                    wc, hc, False, box=box))
        wgt = self._derive_weight(mvf, c_idx, dmvr_flag, ciip_flag)
        if wgt is None:
            dst_view[:] = self._avg(tmp[0], tmp[1])
        else:
            dst_view[:] = self._w_avg(tmp[0], tmp[1], *wgt)

    def _get_mvf(self, x, y):
        from .mvs import MotionContext
        t = self.tabs
        xi, yi = x >> 2, y >> 2
        f = MvField()
        f.pred_flag = int(t.mvf_pf[yi, xi])
        f.mv = [[int(t.mvf_mv[0, yi, xi, 0]), int(t.mvf_mv[0, yi, xi, 1])],
                [int(t.mvf_mv[1, yi, xi, 0]), int(t.mvf_mv[1, yi, xi, 1])]]
        f.ref_idx = [int(t.mvf_ref[0, yi, xi]), int(t.mvf_ref[1, yi, xi])]
        f.bcw_idx = int(t.mvf_bcw[yi, xi])
        f.hpel_if_idx = int(t.mvf_hpel[yi, xi])
        f.ciip_flag = int(t.mvf_ciip[yi, xi])
        return f

    # --- DMVR (vvc_inter.c:642-760) ----------------------------------------

    def _dmvr_bilinear(self, ref_plane, mv, x0, y0, pred_w, pred_h):
        """dmvr[!!my][!!mx]: 2-tap bilinear to the 10-bit domain."""
        _, _, df = _filters()
        bd = self.bd
        mx, my = mv[0] & 0xF, mv[1] & 0xF
        sr = 2
        ox = x0 + (mv[0] >> 4) - sr
        oy = y0 + (mv[1] >> 4) - sr
        if not mx and not my:
            src = _gather_block(ref_plane, ox, oy, pred_w, pred_h,
                                wrap=self.wrap)
            if bd > 10:
                off = 1 << (bd - 11)
                return (src + off) >> (bd - 10)
            return src << (10 - bd)
        shift1 = bd - 6
        off1 = 1 << (shift1 - 1)
        if my == 0:
            src = _gather_block(ref_plane, ox, oy, pred_w + 1, pred_h,
                                wrap=self.wrap)
            f = df[mx]
            return (_filter_h(src, f, 2, pred_w) + off1) >> shift1
        if mx == 0:
            src = _gather_block(ref_plane, ox, oy, pred_w, pred_h + 1,
                                wrap=self.wrap)
            f = df[my]
            return (_filter_v(src, f, 2, pred_h) + off1) >> shift1
        src = _gather_block(ref_plane, ox, oy, pred_w + 1, pred_h + 1,
                            wrap=self.wrap)
        tmp = (_filter_h(src, df[mx], 2, pred_w) + off1) >> shift1
        return (_filter_v(tmp, df[my], 2, pred_h) + 8) >> 4

    @staticmethod
    def _sad(t0, t1, dx, dy, w, h):
        """vvc_sad (vvcdsp.c:49): every other row."""
        dx -= 2
        dy -= 2
        a = t0[2 + dy:2 + dy + h:2, 2 + dx:2 + dx + w]
        b = t1[2 - dy:2 - dy + h:2, 2 - dx:2 - dx + w]
        return int(np.abs(a - b).sum())

    @staticmethod
    def _parametric_refine(sad_m, sad_c, sad_p):
        """parametric_mv_refine (vvc_inter.c:642)."""
        denom = ((sad_m + sad_p) - (sad_c << 1)) << 3
        if not denom:
            return 0
        if sad_m == sad_c:
            return -8
        if sad_p == sad_c:
            return 8
        num = (sad_m - sad_p) << 4
        sign = num < 0
        num = abs(num)
        quotient = 0
        for _ in range(3):
            quotient <<= 1
            if num >= denom:
                num -= denom
                quotient += 1
            denom >>= 1
        return -quotient if sign else quotient

    def _dmvr_refine(self, mv, refs, x0, y0, bw, bh):
        """dmvr_mv_refine (vvc_inter.c:685): mutates mv; returns True if
        BDOF should be skipped for this subblock."""
        from .mvs import clip_mv
        sr = 2
        pw, ph = bw + 2 * sr, bh + 2 * sr
        tmp = [self._dmvr_bilinear(refs[i].planes[0], mv.mv[i], x0, y0,
                                   pw, ph) for i in range(2)]
        min_dx = min_dy = 2
        min_sad = self._sad(tmp[0], tmp[1], 2, 2, bw, bh)
        min_sad -= min_sad >> 2
        sad = {(2, 2): min_sad}
        if min_sad >= bw * bh:
            for dy in range(5):
                for dx in range(5):
                    if dx != sr or dy != sr:
                        s = self._sad(tmp[0], tmp[1], dx, dy, bw, bh)
                        sad[(dy, dx)] = s
                        if s < min_sad:
                            min_sad = s
                            min_dx, min_dy = dx, dy
            dmv = [(min_dx - sr) << 4, (min_dy - sr) << 4]
            if min_dx not in (0, 4) and min_dy not in (0, 4):
                dmv[0] += self._parametric_refine(
                    sad[(min_dy, min_dx - 1)], sad[(min_dy, min_dx)],
                    sad[(min_dy, min_dx + 1)])
                dmv[1] += self._parametric_refine(
                    sad[(min_dy - 1, min_dx)], sad[(min_dy, min_dx)],
                    sad[(min_dy + 1, min_dx)])
            for i in range(2):
                mv.mv[i][0] += (1 - 2 * i) * dmv[0]
                mv.mv[i][1] += (1 - 2 * i) * dmv[1]
                clip_mv(mv.mv[i])
        return min_sad < 2 * bw * bh

    def _set_dmvr_info(self, x0, y0, w, h, mv):
        """set_dmvr_info (vvc_inter.c:750): refined MVs -> collocated grid."""
        t = self.tabs
        x1, y1 = (x0 + w) >> 2, (y0 + h) >> 2
        x0, y0 = x0 >> 2, y0 >> 2
        t.col_pf[y0:y1, x0:x1] = mv.pred_flag
        for i in range(2):
            t.col_mv[i, y0:y1, x0:x1, 0] = mv.mv[i][0]
            t.col_mv[i, y0:y1, x0:x1, 1] = mv.mv[i][1]
            t.col_ref[i, y0:y1, x0:x1] = mv.ref_idx[i]

    def pred_regular_blk(self, cu, skip_ciip, recon=None):
        """pred_regular_blk (vvc_inter.c:782)."""
        pu = cu.pu
        mi = pu.mi
        if cu.ciip_flag and skip_ciip:
            return
        sbw = cu.cb_width // mi.num_sb_x
        sbh = cu.cb_height // mi.num_sb_y
        for sby in range(mi.num_sb_y):
            for sbx in range(mi.num_sb_x):
                x0 = cu.x0 + sbx * sbw
                y0 = cu.y0 + sby * sbh
                if cu.ciip_flag:
                    self.c.set_neighbour_available(x0, y0, sbw, sbh)
                mv = self._get_mvf(x0, y0)
                orig_mv = mv
                sb_bdof_flag = bool(pu.bdof_flag)
                if pu.dmvr_flag:
                    orig_mv = mv.copy()
                    refs = [self._ref_frame(0, mv.ref_idx[0]).buffer,
                            self._ref_frame(1, mv.ref_idx[1]).buffer]
                    if self._dmvr_refine(mv, refs, x0, y0, sbw, sbh):
                        sb_bdof_flag = False
                    self._set_dmvr_info(x0, y0, sbw, sbh, mv)
                self._pred_regular_luma(cu, mv, x0, y0, sbw, sbh, orig_mv,
                                        sb_bdof_flag, recon,
                                        dmvr_flag=pu.dmvr_flag)
                if self.sps.chroma_format_idc:
                    self._pred_regular_chroma(cu, mv, x0, y0, sbw, sbh,
                                              orig_mv, pu.dmvr_flag, recon)

    def _pred_regular_luma(self, cu, mv, x0, y0, sbw, sbh, orig_mv,
                           sb_bdof_flag, recon, dmvr_flag=0):
        ciip = cu.ciip_flag
        hf_idx = vf_idx = mv.hpel_if_idx
        plane = self.fb.planes[0]
        if ciip:
            inter = np.zeros((sbh, sbw), dtype=np.int64)
            dst = inter
        else:
            dst = plane[y0:y0 + sbh, x0:x0 + sbw]
        if mv.pred_flag != PF_BI:
            lx = mv.pred_flag - PF_L0
            ref = self._ref_frame(lx, mv.ref_idx[lx])
            self._luma_uni(dst, ref.buffer, mv, x0, y0, sbw, sbh,
                           hf_idx, vf_idx)
        else:
            refs = [self._ref_frame(0, mv.ref_idx[0]).buffer,
                    self._ref_frame(1, mv.ref_idx[1]).buffer]
            self._luma_bi(dst, refs, mv, x0, y0, sbw, sbh, hf_idx, vf_idx,
                          dmvr_flag=dmvr_flag, ciip_flag=ciip,
                          orig_mv=orig_mv, sb_bdof_flag=sb_bdof_flag)
        if ciip:
            w = self._ciip_intra_weight(cu, x0, y0, sbw, sbh)
            recon.intra_pred(cu, x0, y0, sbw, sbh, 0)
            if self.lmcs_fwd is not None:
                dst[:] = self.lmcs_fwd[dst]
            d = plane[y0:y0 + sbh, x0:x0 + sbw]
            d[:] = (d * w + dst * (4 - w) + 2) >> 2

    def _pred_regular_chroma(self, cu, mv, x0, y0, sbw, sbh, orig_mv,
                             dmvr_flag, recon):
        sps = self.sps
        hs, vs = sps.hshift[1], sps.vshift[1]
        x0c, y0c = x0 >> hs, y0 >> vs
        wc, hc = sbw >> hs, sbh >> vs
        do_ciip = cu.ciip_flag and wc > 2
        outs = []
        for c_idx in (CB, CR):
            plane = self.fb.planes[c_idx]
            if do_ciip:
                dst = np.zeros((hc, wc), dtype=np.int64)
            else:
                dst = plane[y0c:y0c + hc, x0c:x0c + wc]
            if mv.pred_flag != PF_BI:
                lx = mv.pred_flag - PF_L0
                ref = self._ref_frame(lx, mv.ref_idx[lx])
                self._chroma_uni(dst, ref.buffer.planes[c_idx], mv, x0c, y0c,
                                 wc, hc, c_idx)
            else:
                refs = [self._ref_frame(0, mv.ref_idx[0]).buffer,
                        self._ref_frame(1, mv.ref_idx[1]).buffer]
                self._chroma_bi(dst, refs, mv, x0c, y0c, wc, hc, c_idx,
                                dmvr_flag, cu.ciip_flag, orig_mv)
            outs.append(dst)
        if do_ciip:
            w = self._ciip_intra_weight(cu, x0, y0, sbw, sbh)
            for c_idx, inter in zip((CB, CR), outs):
                recon.intra_pred(cu, x0, y0, sbw, sbh, c_idx)
                plane = self.fb.planes[c_idx]
                d = plane[y0c:y0c + hc, x0c:x0c + wc]
                d[:] = (d * w + inter * (4 - w) + 2) >> 2

    def _ciip_intra_weight(self, cu, x0, y0, w, h):
        """ciip_derive_intra_weight (vvc_inter.c:523)."""
        sps = self.sps
        t = self.tabs
        x0b = x0 & ((1 << sps.ctb_log2_size_y) - 1)
        y0b = y0 & ((1 << sps.ctb_log2_size_y) - 1)
        avail_l = self.c.ctb_left_flag or x0b
        avail_u = self.c.ctb_up_flag or y0b
        wgt = 1
        if avail_u and int(t.mvf_pf[(y0 - 1) >> 2,
                                    (x0 - 1 + w) >> 2]) == PF_INTRA:
            wgt += 1
        if avail_l and int(t.mvf_pf[(y0 - 1 + h) >> 2,
                                    (x0 - 1) >> 2]) == PF_INTRA:
            wgt += 1
        return wgt

    # --- affine + PROF (vvc_inter.c:369-446, 828-873) ----------------------

    def _prof_block(self, ref_plane, mv, x, y, dmx, dmy):
        """4x4 affine subblock with PROF refinement -> 14-bit-domain values
        (put + fetch_samples + prof_grad + apply_prof)."""
        bd = self.bd
        mx, my = mv[0] & 0xF, mv[1] & 0xF
        xi = x + (mv[0] >> 4)
        yi = y + (mv[1] >> 4)
        val = self._mc_put(ref_plane, xi, yi, mx, my, 4, 4, True, 2, 2)
        # integer-sample 6x6 ring (fetch_samples, vvc_inter_template.c:130)
        intg = _gather_block(ref_plane, xi + (mx >> 3) - 1,
                             yi + (my >> 3) - 1, 6, 6,
                             wrap=self.wrap) << (14 - bd)
        padded = intg
        padded[1:5, 1:5] = val
        gh = (padded[1:5, 2:6] >> 6) - (padded[1:5, 0:4] >> 6)
        gv = (padded[2:6, 1:5] >> 6) - (padded[0:4, 1:5] >> 6)
        di = gh * dmx + gv * dmy
        limit = 1 << max(13, bd + 1)
        return val + np.clip(di, -limit, limit - 1)

    def pred_affine_blk(self, cu):
        """pred_affine_blk (vvc_inter.c:828)."""
        sps = self.sps
        pu = cu.pu
        mi = pu.mi
        hs, vs = sps.hshift[1], sps.vshift[1]
        sbw = cu.cb_width // mi.num_sb_x
        sbh = cu.cb_height // mi.num_sb_y
        plane = self.fb.planes[0]
        for sby in range(mi.num_sb_y):
            for sbx in range(mi.num_sb_x):
                x = cu.x0 + sbx * sbw
                y = cu.y0 + sby * sbh
                mv = self._get_mvf(x, y)
                dst = plane[y:y + sbh, x:x + sbw]
                if mi.pred_flag != PF_BI:
                    lx = mi.pred_flag - PF_L0
                    ref = self._ref_frame(lx, mv.ref_idx[lx])
                    self._luma_prof_uni(dst, ref.buffer.planes[0], mv, lx,
                                        x, y, sbw, sbh, pu)
                else:
                    refs = [self._ref_frame(0, mv.ref_idx[0]).buffer,
                            self._ref_frame(1, mv.ref_idx[1]).buffer]
                    self._luma_prof_bi(dst, refs, mv, x, y, sbw, sbh, pu)
                if sps.chroma_format_idc and not (sby & vs) and \
                        not (sbx & hs):
                    # derive_affine_mvc (vvc_inter.c:814)
                    mv2 = self._get_mvf(x + hs * sbw, y + vs * sbh)
                    mvc = mv.copy()
                    for i in range(2):
                        m = [mv.mv[i][0] + mv2.mv[i][0],
                             mv.mv[i][1] + mv2.mv[i][1]]
                        from .mvs import round_mv
                        round_mv(m, 0, 1)
                        mvc.mv[i] = m
                    self._pred_regular_chroma(cu, mvc, x, y, sbw << hs,
                                              sbh << vs, None, 0, None)

    def _luma_prof_uni(self, dst, ref_plane, mvf, lx, x, y, sbw, sbh, pu):
        """luma_prof_uni (vvc_inter.c:369): affine filter bank (type 2)."""
        mv = mvf.mv[lx]
        wgt = self._derive_weight_uni(mvf, LUMA)
        if pu.cb_prof_flag[lx]:
            dmx = np.asarray(pu.diff_mv_x[lx]).reshape(4, 4)
            dmy = np.asarray(pu.diff_mv_y[lx]).reshape(4, 4)
            val = self._prof_block(ref_plane, mv, x, y, dmx, dmy)
            bd = self.bd
            if wgt is None:
                shift = 14 - bd
                off = 1 << (shift - 1)
                dst[:] = np.clip((val + off) >> shift, 0, (1 << bd) - 1)
            else:
                denom, wx, ox = wgt
                shift = denom + max(2, 14 - bd)
                off = 1 << (shift - 1)
                dst[:] = np.clip(((val * wx + off) >> shift) +
                                 (ox << (bd - 8)), 0, (1 << bd) - 1)
        else:
            mx, my = mv[0] & 0xF, mv[1] & 0xF
            xi = x + (mv[0] >> 4)
            yi = y + (mv[1] >> 4)
            val = self._mc_put(ref_plane, xi, yi, mx, my, sbw, sbh, True,
                               2, 2)
            if wgt is None:
                dst[:] = self._uni_out(val, False)
            else:
                dst[:] = self._uni_out(val, True, *wgt)

    def _luma_prof_bi(self, dst, refs, mvf, x, y, sbw, sbh, pu):
        """luma_prof_bi (vvc_inter.c:410)."""
        tmp = []
        for i in range(2):
            mv = mvf.mv[i]
            if pu.cb_prof_flag[i]:
                dmx = np.asarray(pu.diff_mv_x[i]).reshape(4, 4)
                dmy = np.asarray(pu.diff_mv_y[i]).reshape(4, 4)
                tmp.append(self._prof_block(refs[i].planes[0], mv, x, y,
                                            dmx, dmy))
            else:
                mx, my = mv[0] & 0xF, mv[1] & 0xF
                xi = x + (mv[0] >> 4)
                yi = y + (mv[1] >> 4)
                tmp.append(self._mc_put(refs[i].planes[0], xi, yi, mx, my,
                                        sbw, sbh, True, 2, 2))
        wgt = self._derive_weight(mvf, LUMA, 0, 0)
        if wgt is None:
            dst[:] = self._avg(tmp[0], tmp[1])
        else:
            dst[:] = self._w_avg(tmp[0], tmp[1], *wgt)

    # --- GPM (vvc_inter.c:466-521) -----------------------------------------

    def pred_gpm_blk(self, cu):
        t = D.tables()
        pu = cu.pu
        sps = self.sps
        angle_idx = int(t["gpm_angle_idx"][pu.gpm_partition_idx])
        weights_idx = int(t["gpm_angle_to_weights_idx"][angle_idx])
        wi = (cu.cb_width.bit_length() - 1) - 3
        hi = (cu.cb_height.bit_length() - 1) - 3
        off_x = int(t["gpm_weights_offset_x"][pu.gpm_partition_idx][hi][wi])
        off_y = int(t["gpm_weights_offset_y"][pu.gpm_partition_idx][hi][wi])
        mirror = int(t["gpm_angle_to_mirror"][angle_idx])
        WS = 112
        wmat = t["gpm_weights"][weights_idx].reshape(WS, WS)
        c_end = 3 if sps.chroma_format_idc else 1
        for c_idx in range(c_end):
            hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
            x = cu.x0 >> hs
            y = cu.y0 >> vs
            width = cu.cb_width >> hs
            height = cu.cb_height >> vs
            tmp = []
            for i in range(2):
                mvf = pu.gpm_mv[i]
                lx = mvf.pred_flag - PF_L0
                ref = self.rpl[lx].frames[mvf.ref_idx[lx]]
                if ref is None:
                    return
                mv = mvf.mv[lx]
                if c_idx:
                    mx = (mv[0] & ((1 << (4 + hs)) - 1)) << (1 - hs)
                    my = (mv[1] & ((1 << (4 + vs)) - 1)) << (1 - vs)
                    xi = x + (mv[0] >> (4 + hs))
                    yi = y + (mv[1] >> (4 + vs))
                    tmp.append(self._mc_put(ref.buffer.planes[c_idx], xi, yi,
                                            mx, my, width, height, False))
                else:
                    mx, my = mv[0] & 0xF, mv[1] & 0xF
                    xi = x + (mv[0] >> 4)
                    yi = y + (mv[1] >> 4)
                    tmp.append(self._mc_put(ref.buffer.planes[0], xi, yi,
                                            mx, my, width, height, True))
            # weight sampling with mirroring (put_gpm,
            # vvc_inter_template.c:78)
            ys = np.arange(height) << vs
            xs = np.arange(width) << hs
            if mirror == 0:
                wgt = wmat[np.ix_(off_y + ys, off_x + xs)]
            elif mirror == 1:
                wgt = wmat[np.ix_(off_y + ys, WS - 1 - off_x - xs)]
            else:
                wgt = wmat[np.ix_(WS - 1 - off_y - ys, off_x + xs)]
            wgt = wgt.astype(np.int64)
            bd = self.bd
            shift = max(5, 17 - bd)
            off = 1 << (shift - 1)
            out = np.clip((tmp[0] * wgt + tmp[1] * (8 - wgt) + off) >> shift,
                          0, (1 << bd) - 1)
            self.fb.planes[c_idx][y:y + height, x:x + width] = out

    # --- CTU walk (vvc_inter.c:899) ----------------------------------------

    def predict_inter_ctu(self, rs):
        from .ctu import MODE_INTRA, MODE_PLT, DUAL_TREE_CHROMA
        for cu in self.tabs.cus[rs]:
            if cu.pred_mode not in (MODE_INTRA, MODE_PLT) and \
                    cu.tree_type != DUAL_TREE_CHROMA:
                self.predict_cu(cu)

    def predict_cu(self, cu):
        pu = cu.pu
        if pu.merge_gpm_flag:
            self.pred_gpm_blk(cu)
        elif pu.inter_affine_flag:
            self.pred_affine_blk(cu)
        else:
            self.pred_regular_blk(cu, skip_ciip=True)
        # LMCS forward mapping of inter luma (predict_inter, vvc_inter.c:888)
        if self.lmcs_fwd is not None and not cu.ciip_flag:
            plane = self.fb.planes[0]
            blk = plane[cu.y0:cu.y0 + cu.cb_height, cu.x0:cu.x0 + cu.cb_width]
            blk[:] = self.lmcs_fwd[blk]

    def predict_ciip(self, cu, recon):
        """ff_vvc_predict_ciip (vvc_inter.c:915) — called at recon stage."""
        self.pred_regular_blk(cu, skip_ciip=False, recon=recon)
