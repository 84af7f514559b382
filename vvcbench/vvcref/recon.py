# Frozen copy of ffvvc_tpu_torch/recon.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: imports data and bufpool from the package root; the C intra
#   library (`native/intra.py`) is removed: its intra-prediction and flat
#   dequantisation fast paths go, the NumPy paths beside them always run.
"""Golden scalar reconstruction (bit-exact NumPy model) — intra path.

This plays the role the scalar C templates play in the reference: the
bit-exact model every TPU kernel is validated against.  It is itself
validated against the reference decoder on forged streams.

Reference analogue: libavcodec/vvc/vvc_intra.c (recon walk
:498, dequant :277-417, LFNST :65-127, transform type :130-164, itransform
:432), vvc_intra_template.c (edge prep :467, planar/DC/angular/MIP
:686-1001), vvcdsp.c itx_2d :94-117.
"""
from __future__ import annotations

import numpy as np

from .ctu import (MODE_INTRA, MODE_IBC, MODE_PLT, INTRA_PLANAR, INTRA_DC,
                  INTRA_HORZ, INTRA_VERT, INTRA_DIAG, INTRA_VDIAG,
                  INTRA_LT_CCLM, INTRA_L_CCLM, INTRA_T_CCLM,
                  ISP_NO_SPLIT, ISP_HOR_SPLIT,
                  ISP_VER_SPLIT, DUAL_TREE_CHROMA, DUAL_TREE_LUMA, SINGLE_TREE,
                  LUMA, CB, CR, JCBCR, MTS_DCT2_DCT2)
from . import data as D
from .residual import ilog2

DCT2, DST7, DCT8 = 0, 1, 2

_ANGLES = (0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29,
           32, 35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512)


def intra_pred_angle(mode: int) -> int:
    if mode > INTRA_DIAG:
        idx = mode - INTRA_VERT
    elif mode > 0:
        idx = INTRA_HORZ - mode
    else:
        idx = INTRA_HORZ - 2 - mode
    sign = 1
    if idx < 0:
        idx, sign = -idx, -1
    return sign * _ANGLES[idx]


def intra_inv_angle(angle: int) -> int:
    f = 32 * 512.0 / angle
    return int(-(-f + 0.5)) if f < 0 else int(f + 0.5)


def ref_filter_flag(mode: int) -> bool:
    return mode in (-14, -12, -10, -6, INTRA_PLANAR, 2, 34, 66, 72, 76, 78, 80)


def wide_angle_map(cu, tb_w, tb_h, c_idx, mode):
    if cu.isp_split_type == ISP_NO_SPLIT or c_idx:
        nw, nh = tb_w, tb_h
    else:
        nw, nh = cu.cb_width, cu.cb_height
    ratio = abs(ilog2(nw) - ilog2(nh))
    mx = 8 + 2 * ratio if ratio > 1 else 8
    mn = 60 - 2 * ratio if ratio > 1 else 60
    if nw > nh and 2 <= mode < mx:
        mode += 65
    elif nh > nw and mode <= 66 and mode > mn:
        mode -= 67
    return mode


def nscale_derive(w, h, mode):
    if mode in (INTRA_PLANAR, INTRA_DC, INTRA_HORZ, INTRA_VERT):
        return (ilog2(w) + ilog2(h) - 2) >> 2
    angle = intra_pred_angle(mode)
    inv = intra_inv_angle(angle)
    side = h if mode >= INTRA_VERT else w
    return min(2, ilog2(side) - ilog2(3 * inv - 2) + 8)


def need_pdpc(w, h, bdpcm, mode, ref_idx):
    if w >= 4 and h >= 4 and not ref_idx and not bdpcm:
        if mode in (INTRA_PLANAR, INTRA_DC, INTRA_HORZ, INTRA_VERT):
            return 1
        if INTRA_HORZ < mode < INTRA_VERT:
            return 0
        return int(nscale_derive(w, h, mode) >= 0)
    return 0


def is_cclm(mode):
    return INTRA_LT_CCLM <= mode <= INTRA_T_CCLM


class FrameBuffer:
    """Decoded picture planes (int32 working precision)."""

    def __init__(self, sps, pps):
        self.sps = sps
        self.pps = pps
        self.planes = []
        for c in range(3 if sps.chroma_format_idc else 1):
            w = pps.width >> sps.hshift[c]
            h = pps.height >> sps.vshift[c]
            self.planes.append(np.full((h, w), 1 << (sps.bit_depth - 1),
                                       dtype=np.int32))

    # --- per-process pool (utils/bufpool): avoids per-frame first-touch
    # page faults on the ~12MB of fresh plane memory -----------------------

    @staticmethod
    def _pool_key(sps, pps):
        return ("fb", pps.width, pps.height, sps.chroma_format_idc,
                sps.bit_depth)

    @classmethod
    def acquire(cls, sps, pps):
        from . import bufpool
        key = cls._pool_key(sps, pps)
        fb = bufpool.acquire(key)
        if fb is None:
            return cls(sps, pps)
        fb.sps, fb.pps = sps, pps
        mid = 1 << (sps.bit_depth - 1)
        for p in fb.planes:
            p.fill(mid)
        return fb

    def recycle(self):
        from . import bufpool
        bufpool.release(self, self._pool_key(self.sps, self.pps))

    def to_yuv_bytes(self) -> bytes:
        bd = self.sps.bit_depth
        left, right, top, bottom = getattr(self.pps, "crop", (0, 0, 0, 0))
        out = b""
        for c, p in enumerate(self.planes):
            if left or right or top or bottom:
                # conformance window crop (spec 7.4.3.4), output-only: the
                # DPB keeps full planes for MC reference
                hs, vs = self.sps.hshift[c], self.sps.vshift[c]
                h, w = p.shape
                p = p[top >> vs:h - (bottom >> vs),
                      left >> hs:w - (right >> hs)]
            if bd == 8:
                out += p.astype(np.uint8).tobytes()
            else:
                out += p.astype("<u2").tobytes()
        return out


class Reconstructor:
    """Sequential golden intra reconstruction over parsed frame data."""

    def __init__(self, sps, pps, tabs, fb: FrameBuffer, nbr):
        self.sps = sps
        self.pps = pps
        self.tabs = tabs
        self.fb = fb
        self.nbr = nbr  # CtuCoder-like neighbour context (flags per CTU)
        self.ras = [[], []]  # reconstructed areas per ch_type, per CTU
        self.cu = None

    # --- CTU walk ----------------------------------------------------------

    def reconstruct_ctu(self, rs, rx, ry):
        self.nbr.decode_neighbour(rx << self.sps.ctb_log2_size_y,
                                  ry << self.sps.ctb_log2_size_y, rx, ry, rs)
        self._lmcs_vpdu = None  # (x, y, scale) cache (vvc_intra.c:509)
        self.ras = [[], []]
        for cu in self.tabs.cus[rs]:
            self.reconstruct_cu(cu)

    inter_pred = None  # InterPredictor, attached by the decoder (inter slices)
    lmcs = None        # VVCLMCS, attached when ph_lmcs_enabled_flag
    lmcs_used = False  # sh_lmcs_used_flag
    chroma_scale_on = False  # ph_chroma_residual_scale_flag
    _lmcs_vpdu = None

    def _lmcs_chroma_scale(self, x0_cu, y0_cu):
        """lmcs_derive_chroma_scale (vvc_intra_template.c:396)."""
        sps = self.sps
        size_y = min(sps.ctb_size_y, 64)
        x = x0_cu & ~(size_y - 1)
        y = y0_cu & ~(size_y - 1)
        if self._lmcs_vpdu is not None and self._lmcs_vpdu[0] == (x, y):
            return self._lmcs_vpdu[1]
        plane = self.fb.planes[0]
        cnt = 0
        luma = 0
        avail_t = self.get_top_available(x, y, 1, 0)
        avail_l = self.get_left_available(x, y, 1, 0)

        def sum_samples(vals, avail, target):
            size = min(avail, target)
            s = int(vals[:size].sum())
            s += int(vals[size - 1]) * (target - size)
            return s

        if avail_l:
            luma += sum_samples(plane[y:, x - 1], self.pps.height - y, size_y)
            cnt = size_y
        if avail_t:
            luma += sum_samples(plane[y - 1, x:], self.pps.width - x, size_y)
            cnt += size_y
        if cnt:
            luma = (luma + (cnt >> 1)) >> (cnt.bit_length() - 1)
        else:
            luma = 1 << (sps.bit_depth - 1)
        lm = self.lmcs
        i = lm.min_bin_idx
        while i <= lm.max_bin_idx:
            if luma < lm.pivot[i + 1]:
                break
            i += 1
        i = min(i, lm.BIN_SIZE - 1)
        scale = lm.chroma_scale_coeff[i]
        self._lmcs_vpdu = ((x, y), scale)
        return scale

    def _lmcs_scale_residual(self, res, x0_cu, y0_cu):
        """lmcs_scale_chroma (vvc_intra_template.c:431)."""
        scale = self._lmcs_chroma_scale(x0_cu, y0_cu)
        bd = self.sps.bit_depth
        c = np.clip(res, -(1 << bd), (1 << bd) - 1)
        pos = (c * scale + (1 << 10)) >> 11
        neg = -((-c * scale + (1 << 10)) >> 11)
        return np.where(c > 0, pos, neg)

    def reconstruct_cu(self, cu):
        self.cu = cu
        start = 1 if cu.tree_type == DUAL_TREE_CHROMA else 0
        end = 1 if (self.sps.chroma_format_idc and
                    cu.tree_type != DUAL_TREE_LUMA) else 0
        if cu.pred_mode != MODE_INTRA:
            # inter CU: MC already ran in the inter pass (CIIP blends here,
            # reference vvc_intra.c:498-527); recon adds residuals and marks
            # the reconstructed areas (vvc_intra.c:251-253, :520-522)
            if cu.ciip_flag:
                self.inter_pred.predict_ciip(cu, self)
            if not cu.coded_flag:
                self.add_ra(0, cu.x0, cu.y0, cu.cb_width, cu.cb_height)
                self.add_ra(1, cu.x0, cu.y0, cu.cb_width, cu.cb_height)
                return
            for ch_type in range(start, end + 1):
                for i, tu in enumerate(cu.tus):
                    self.add_ra(ch_type, tu.x0, tu.y0, tu.width, tu.height)
                    self.itransform(cu, tu, i, ch_type)
            return
        for ch_type in range(start, end + 1):
            for i, tu in enumerate(cu.tus):
                self.predict_intra(cu, tu, i, ch_type)
                self.itransform(cu, tu, i, ch_type)

    def add_ra(self, ch_type, x0, y0, w, h):
        hs = self.sps.hshift[ch_type]
        vs = self.sps.vshift[ch_type]
        self.ras[ch_type].append((x0 >> hs, y0 >> vs, w >> hs, h >> vs))

    def _get_ra(self, x, y, c_idx):
        ch = int(c_idx > 0)
        for a in reversed(self.ras[ch]):
            ax, ay, aw, ah = a
            if ax <= x < ax + aw and ay <= y < ay + ah:
                return a
            if x >= ax + aw and y >= ay + ah:
                break
        return None

    def get_top_available(self, x, y, target, c_idx):
        sps, pps = self.sps, self.pps
        nbr = self.nbr
        hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
        log2_ctb_v = sps.ctb_log2_size_y - vs
        end_of_ctb_x = ((self.cu.x0 >> sps.ctb_log2_size_y) + 1) << sps.ctb_log2_size_y
        y0b = y & ((1 << log2_ctb_v) - 1)
        max_x = min(pps.width, end_of_ctb_x) >> hs
        if not y0b:
            if not nbr.ctb_up_flag:
                return 0
            target = min(target, (nbr.end_of_tiles_x >> hs) - x)
            if sps.r.sps_entropy_coding_sync_enabled_flag:
                target = min(target, (end_of_ctb_x >> hs) - x)
            return target
        target = max(0, min(target, max_x - x))
        px = x
        while target > 0:
            a = self._get_ra(px, y - 1, c_idx)
            if a is None:
                break
            sz = min(target, a[0] + a[2] - px)
            px += sz
            target -= sz
        return px - x

    def get_left_available(self, x, y, target, c_idx):
        sps, pps = self.sps, self.pps
        nbr = self.nbr
        hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
        log2_ctb_h = sps.ctb_log2_size_y - hs
        x0b = x & ((1 << log2_ctb_h) - 1)
        end_of_ctb_y = ((self.cu.y0 >> sps.ctb_log2_size_y) + 1) << sps.ctb_log2_size_y
        max_y = min(pps.height, end_of_ctb_y) >> vs
        if not x0b and not nbr.ctb_left_flag:
            return 0
        target = max(0, min(target, max_y - y))
        if not x0b:
            return target
        py = y
        while target > 0:
            a = self._get_ra(x - 1, py, c_idx)
            if a is None:
                break
            sz = min(target, a[1] + a[3] - py)
            py += sz
            target -= sz
        return py - y

    # --- intra prediction ---------------------------------------------------

    def predict_intra(self, cu, tu, idx, target_ch_type):
        if cu.pred_mode != MODE_INTRA:
            self.add_ra(target_ch_type, tu.x0, tu.y0, tu.width, tu.height)
            return
        if not target_ch_type and cu.tree_type != DUAL_TREE_CHROMA:
            unit = self._luma_predict_unit(cu, tu, idx)
            if unit:
                x0, y0, w, h = unit
                self.nbr.set_neighbour_available(x0, y0, w, h)
                self.intra_pred(cu, x0, y0, w, h, 0)
                self.add_ra(0, x0, y0, w, h)
        if target_ch_type and cu.tree_type != DUAL_TREE_LUMA:
            unit = self._chroma_predict_unit(cu, tu, idx)
            if unit:
                x0, y0, w, h = unit
                self.nbr.set_neighbour_available(x0, y0, w, h)
                if is_cclm(cu.intra_pred_mode_c):
                    self.cclm_pred(cu, x0, y0, w, h)
                else:
                    self.intra_pred(cu, x0, y0, w, h, 1)
                    self.intra_pred(cu, x0, y0, w, h, 2)
                self.add_ra(1, x0, y0, w, h)

    def _luma_predict_unit(self, cu, tu, idx):
        # reference get_luma_predict_unit (vvc_intra.c:216-227): ISP predicts
        # per sub-TU, but vertical subpartitions narrower than
        # MIN_ISP_PRED_WIDTH=4 predict 4-wide, once per group of 4/width.
        if cu.isp_split_type == ISP_VER_SPLIT and tu.width < 4:
            if idx % (4 // tu.width):
                return None
            return (tu.x0, tu.y0, 4, tu.height)
        return (tu.x0, tu.y0, tu.width, tu.height)

    def _chroma_predict_unit(self, cu, tu, idx):
        has_chroma = any(tb.c_idx for tb in tu.tbs)
        if cu.isp_split_type == ISP_NO_SPLIT:
            if not has_chroma and cu.tree_type == SINGLE_TREE:
                return None
            return (tu.x0, tu.y0, tu.width, tu.height)
        if idx == cu.num_intra_subpartitions - 1:
            return (cu.x0, cu.y0, cu.cb_width, cu.cb_height)
        return None

    def intra_pred(self, cu, x0, y0, width, height, c_idx):
        sps = self.sps
        fb = self.fb
        hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
        x, y = x0 >> hs, y0 >> vs
        w, h = width >> hs, height >> vs
        plane = fb.planes[c_idx]
        pred_mode = cu.intra_pred_mode_c if c_idx else cu.intra_pred_mode_y
        mode = wide_angle_map(cu, w, h, c_idx, pred_mode)
        xc4, yc4 = x0 >> 2, y0 >> 2
        intra_mip = int(self.tabs.imf[yc4, xc4])
        is_mip = intra_mip and (not c_idx or cu.mip_chroma_direct_flag)
        ref_idx = 0 if c_idx else cu.intra_luma_ref_idx
        pdpc = need_pdpc(w, h, cu.bdpcm_flag[c_idx], mode, ref_idx) \
            if not is_mip else 0
        geom = self._edge_geometry(cu, w, h, c_idx, is_mip, mode, ref_idx,
                                   pdpc)
        (rff, filter_smoothing, ref_line, refw, refh,
         left_size, top_size, unf_left, unf_top, angle, inv_angle) = geom
        left_avail = self.get_left_available(x, y, unf_left, c_idx)
        top_avail = self.get_top_available(x, y, unf_top, c_idx)
        cand_up_left = self.nbr.na.cand_up_left
        filter_flag = self._filter_flag(cu, w, h, is_mip, mode, rff, ref_idx)
        left, top = self._edge_params(
            cu, plane, x, y, w, h, c_idx, is_mip, mode, ref_idx, geom,
            left_avail, top_avail, cand_up_left)
        if is_mip:
            out = self._pred_mip(plane, left, top, x, y, w, h,
                                 int(self.tabs.imm[yc4, xc4]),
                                 int(self.tabs.imtf[yc4, xc4]))
        elif mode == INTRA_PLANAR:
            out = self._pred_planar(left, top, w, h)
        elif mode == INTRA_DC:
            out = self._pred_dc(left, top, w, h)
        elif mode == INTRA_VERT:
            out = np.broadcast_to(top.arr(0, w)[None, :], (h, w)).copy()
        elif mode == INTRA_HORZ:
            out = np.broadcast_to(left.arr(0, h)[:, None], (h, w)).copy()
        elif mode >= INTRA_DIAG:
            out = self._pred_angular_v(left, top, w, h, c_idx, mode, ref_idx,
                                       filter_flag, pdpc)
        else:
            out = self._pred_angular_h(left, top, w, h, c_idx, mode, ref_idx,
                                       filter_flag, pdpc)
        if pdpc and not is_mip and mode in (INTRA_PLANAR, INTRA_DC,
                                            INTRA_VERT, INTRA_HORZ):
            out = self._pdpc_hv(out, left, top, w, h, mode)
        plane[y:y + h, x:x + w] = out

    # --- CCLM (8.4.5.2.14; reference vvc_intra_template.c:29-377) ----------

    def cclm_pred(self, cu, x0, y0, width, height):
        """Cross-component linear-model chroma prediction: derive (a, b, k)
        per chroma component from up to 4 neighbour (downsampled-luma,
        chroma) pairs, then Cb/Cr = clip(((dsY * a) >> k) + b)."""
        sps = self.sps
        fb = self.fb
        hs, vs = sps.hshift[1], sps.vshift[1]
        x, y = x0 >> hs, y0 >> vs
        w, h = width >> hs, height >> vs
        avail_t = self.get_top_available(x0, y0, 1, 0)
        avail_l = self.get_left_available(x0, y0, 1, 0)
        maxv = (1 << sps.bit_depth) - 1
        if not avail_t and not avail_l:
            for c in (1, 2):
                fb.planes[c][y:y + h, x:x + w] = 1 << (sps.bit_depth - 1)
            return
        dsy = self._cclm_luma_ds(x0, y0, w, h, avail_t, avail_l)
        params = self._cclm_params(cu, x0, y0, w, h, avail_t, avail_l)
        for i, c in enumerate((1, 2)):
            a, b, k = params[i]
            pred = ((dsy.astype(np.int64) * a) >> k) + b
            fb.planes[c][y:y + h, x:x + w] = np.clip(pred, 0, maxv)

    def _cclm_luma_ds(self, x0, y0, w, h, avail_t, avail_l):
        """Downsample the colocated reconstructed luma to the chroma grid
        (cclm_get_luma_rec_pixels, vvc_intra_template.c:285-341)."""
        sps = self.sps
        L = self.fb.planes[0].astype(np.int64)
        hs, vs = sps.hshift[1], sps.vshift[1]
        if not hs and not vs:
            return L[y0:y0 + h, x0:x0 + w]
        # column indices of the left 3-tap neighbour (2j-1; j=0 clamps to
        # x0 - avail_l so an unavailable left edge replicates the block edge)
        xm1 = x0 + 2 * np.arange(w) - 1
        xm1[0] = x0 - avail_l
        xc = x0 + 2 * np.arange(w)
        if not vs:  # 4:2:2 horizontal-only
            rows = y0 + np.arange(h)
            return (L[np.ix_(rows, xm1)] + 2 * L[np.ix_(rows, xc)]
                    + L[np.ix_(rows, xc + 1)] + 2) >> 2
        r0 = y0 + 2 * np.arange(h)
        if sps.r.sps_chroma_vertical_collocated_flag:
            # 5-tap cross; the row above clamps to y0 - avail_t at i == 0
            rt = r0 - 1
            rt[0] = y0 - avail_t
            return (L[np.ix_(r0, xm1)] + L[np.ix_(rt, xc)]
                    + 4 * L[np.ix_(r0, xc)] + L[np.ix_(r0, xc + 1)]
                    + L[np.ix_(r0 + 1, xc)] + 4) >> 3
        return (L[np.ix_(r0, xm1)] + L[np.ix_(r0 + 1, xm1)]
                + 2 * L[np.ix_(r0, xc)] + 2 * L[np.ix_(r0 + 1, xc)]
                + L[np.ix_(r0, xc + 1)] + L[np.ix_(r0 + 1, xc + 1)] + 4) >> 3

    def _cclm_select_pos(self, cu, x, y, w, h, avail_t, avail_l):
        """(cnt, pos) of neighbour sample picks per side
        (cclm_get_select_pos, vvc_intra_template.c:60-86)."""
        mode = cu.intra_pred_mode_c
        num_is4 = int(not avail_t or not avail_l or mode != INTRA_LT_CCLM)
        if mode == INTRA_LT_CCLM:
            ns_top = w if avail_t else 0
            ns_left = h if avail_l else 0
        else:
            ns_top = self.get_top_available(x, y, w + min(w, h), 1) \
                if (avail_t and mode == INTRA_T_CCLM) else 0
            ns_left = self.get_left_available(x, y, h + min(w, h), 1) \
                if (avail_l and mode == INTRA_L_CCLM) else 0
        if not ns_top and not ns_left:
            return None
        cnt, pos = [0, 0], [[], []]
        for side, ns in enumerate((ns_top, ns_left)):
            start = ns >> (2 + num_is4)
            step = max(1, ns >> (1 + num_is4))
            cnt[side] = min(ns, (1 + num_is4) << 1)
            pos[side] = [start + c * step for c in range(cnt[side])]
        return cnt, pos

    def _cclm_select_luma(self, x0, y0, avail_t, avail_l, cnt, pos):
        """Downsampled luma at the picked neighbour positions
        (cclm_select_luma, vvc_intra_template.c:96-165)."""
        sps = self.sps
        L = self.fb.planes[0].astype(np.int64)
        hs, vs = sps.hshift[1], sps.vshift[1]
        sel = []
        if not hs and not vs:
            for p in pos[0]:
                sel.append(int(L[y0 - avail_t, x0 + p]))
            for p in pos[1]:
                sel.append(int(L[y0 + p, x0 - avail_l]))
            return sel
        b_ctu_boundary = not (y0 & ((1 << sps.ctb_log2_size_y) - 1))
        coll = sps.r.sps_chroma_vertical_collocated_flag
        for p in pos[0]:  # top row(s)
            xx = p << hs
            xl = x0 + xx - 1 if (xx or avail_l) else x0 + xx
            if vs and not b_ctu_boundary:
                yb = y0 - 2
                if coll:
                    v = (L[yb - 1, x0 + xx] + L[yb, xl] + 4 * L[yb, x0 + xx]
                         + L[yb, x0 + xx + 1] + L[yb + 1, x0 + xx] + 4) >> 3
                else:
                    v = (L[yb, xl] + L[yb + 1, xl]
                         + 2 * (L[yb, x0 + xx] + L[yb + 1, x0 + xx])
                         + L[yb, x0 + xx + 1] + L[yb + 1, x0 + xx + 1] + 4) >> 3
                sel.append(int(v))
            else:
                yb = y0 - 1
                sel.append(int((L[yb, xl] + 2 * L[yb, x0 + xx]
                                + L[yb, x0 + xx + 1] + 2) >> 2))
        x_src = x0 - (1 + hs) * avail_l   # left column pair origin
        x_l = x_src - avail_l
        for p in pos[1]:  # left column
            yy = y0 + (p << vs)
            if not vs:
                v = (L[yy, x_l] + 2 * L[yy, x_src] + L[yy, x_src + 1] + 2) >> 2
            elif coll:
                t = L[yy - 1, x_src] if ((p << vs) or avail_t) else L[yy, x_src]
                v = (L[yy, x_l] + t + 4 * L[yy, x_src]
                     + L[yy, x_src + 1] + L[yy + 1, x_src] + 4) >> 3
            else:
                v = (L[yy, x_l] + L[yy + 1, x_l] + 2 * L[yy, x_src]
                     + 2 * L[yy + 1, x_src] + L[yy, x_src + 1]
                     + L[yy + 1, x_src + 1] + 4) >> 3
            sel.append(int(v))
        return sel

    def _cclm_params(self, cu, x0, y0, w, h, avail_t, avail_l):
        """Per-component (a, b, k) from the 4-sample min/max groups
        (cclm_get_params, vvc_intra_template.c:239-282)."""
        sps = self.sps
        bd = sps.bit_depth
        hs, vs = sps.hshift[1], sps.vshift[1]
        x, y = x0 >> hs, y0 >> vs
        sp = self._cclm_select_pos(cu, x, y, w, h, avail_t, avail_l)
        if sp is None:
            return [(0, 1 << (bd - 1), 0), (0, 1 << (bd - 1), 0)]
        cnt, pos = sp
        sel_y = self._cclm_select_luma(x0, y0, avail_t, avail_l, cnt, pos)
        sel_c = [[], []]
        for i, c in enumerate((1, 2)):
            C = self.fb.planes[c]
            for p in pos[0]:
                sel_c[i].append(int(C[y - 1, x + p]))
            for p in pos[1]:
                sel_c[i].append(int(C[y + p, x - 1]))
        if cnt[0] + cnt[1] == 2:
            # duplicate the 2 pairs into 4 slots, swapped
            sel_y = [sel_y[1], sel_y[0], sel_y[1], sel_y[0]]
            sel_c = [[s[1], s[0], s[1], s[0]] for s in sel_c]
        # two-min / two-max grouping sort network (cclm_get_min_max)
        mn, mx = [0, 2], [1, 3]
        if sel_y[mn[0]] > sel_y[mn[1]]:
            mn = [mn[1], mn[0]]
        if sel_y[mx[0]] > sel_y[mx[1]]:
            mx = [mx[1], mx[0]]
        if sel_y[mn[0]] > sel_y[mx[1]]:
            mn, mx = mx, mn
        if sel_y[mn[1]] > sel_y[mx[0]]:
            mn[1], mx[0] = mx[0], mn[1]
        min_y = (sel_y[mn[0]] + sel_y[mn[1]] + 1) >> 1
        max_y = (sel_y[mx[0]] + sel_y[mx[1]] + 1) >> 1
        out = []
        diff = max_y - min_y
        div_sig = (0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0)
        for s in sel_c:
            min_c = (s[mn[0]] + s[mn[1]] + 1) >> 1
            max_c = (s[mx[0]] + s[mx[1]] + 1) >> 1
            if diff == 0:
                out.append((0, min_c, 0))
                continue
            diffc = max_c - min_c
            xsh = diff.bit_length() - 1
            norm_diff = ((diff << 4) >> xsh) & 15
            xsh += 1 if norm_diff else 0
            ysh = (abs(diffc).bit_length()) if diffc else 0
            v = div_sig[norm_diff] | 8
            add = (1 << ysh) >> 1
            a = (diffc * v + add) >> ysh
            k = max(1, 3 + xsh - ysh)
            if 3 + xsh - ysh < 1:
                a = 15 if a > 0 else (-15 if a < 0 else 0)
            b = min_c - ((a * min_y) >> k)
            out.append((a, b, k))
        return out

    def _edge_geometry(self, cu, w, h, c_idx, is_mip, mode, ref_idx, pdpc):
        """Scalar prologue of prepare_intra_edge_params: reference-array
        sizes and angle parameters (vvc_intra_template.c:467-520)."""
        sps = self.sps
        rff = 0 if is_mip else int(ref_filter_flag(mode))
        filter_smoothing = (not ref_idx and w * h > 32 and not c_idx and
                            cu.isp_split_type == ISP_NO_SPLIT and rff)
        ref_line = -4 if ref_idx == 3 else -1 - ref_idx
        refw = refh = 0
        angle = inv_angle = 0
        if is_mip or mode == INTRA_PLANAR:
            left_size, top_size = h + 1, w + 1
            unf_left = left_size + filter_smoothing
            unf_top = top_size + filter_smoothing
        elif mode == INTRA_DC:
            unf_left = left_size = h
            unf_top = top_size = w
        elif mode == INTRA_VERT:
            unf_left = left_size = h if pdpc else 1
            unf_top = top_size = w
        elif mode == INTRA_HORZ:
            unf_left = left_size = h
            unf_top = top_size = w if pdpc else 1
        else:
            if cu.isp_split_type == ISP_NO_SPLIT or c_idx:
                refw, refh = w * 2, h * 2
            else:
                hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
                refw = (cu.cb_width >> hs) + w
                refh = (cu.cb_height >> vs) + h
            angle = intra_pred_angle(mode)
            inv_angle = intra_inv_angle(angle)
            unf_top = top_size = refw
            unf_left = left_size = refh
        return (rff, filter_smoothing, ref_line, refw, refh,
                left_size, top_size, unf_left, unf_top, angle, inv_angle)

    def _filter_flag(self, cu, w, h, is_mip, mode, rff, ref_idx):
        """Interpolation-filter selection flag for angular modes."""
        if is_mip or mode in (INTRA_PLANAR, INTRA_DC):
            return 0
        if rff or ref_idx or cu.isp_split_type != ISP_NO_SPLIT:
            return 0
        min_dist = min(abs(mode - 50), abs(mode - 18))
        thres = (24, 14, 2, 0, 0)
        ntbs = (ilog2(w) + ilog2(h)) >> 1
        return int(min_dist > thres[ntbs - 2])

    def _edge_params(self, cu, plane, x, y, w, h, c_idx, is_mip, mode,
                     ref_idx, geom, left_avail, top_avail, cand_up_left):
        """prepare_intra_edge_params (vvc_intra_template.c:467)."""
        sps = self.sps
        (rff, filter_smoothing, ref_line, refw, refh,
         left_size, top_size, unf_left, unf_top, angle, inv_angle) = geom
        # gather with offset arrays: index 0 == position 0; negative via dict
        PAD = 68
        left = np.zeros(PAD + 2 * 64 + 16, dtype=np.int64)
        top = np.zeros(PAD + 2 * 64 + 16, dtype=np.int64)
        L = lambda i: PAD + i

        for i in range(left_avail):
            left[L(i)] = plane[y + i, x + ref_line]
        if top_avail:
            top[L(0):L(top_avail)] = plane[y + ref_line, x:x + top_avail]
        for i in range(-1, ref_line - 1, -1):
            if cand_up_left:
                left[L(i)] = plane[y + i, x + ref_line]
                top[L(i)] = plane[y + ref_line, x + i]
            elif left_avail:
                left[L(i)] = top[L(i)] = left[L(0)]
            elif top_avail:
                left[L(i)] = top[L(i)] = top[L(0)]
            else:
                left[L(i)] = top[L(i)] = 1 << (sps.bit_depth - 1)
        if top_avail < unf_top:
            top[L(top_avail):L(unf_top)] = top[L(max(top_avail - 1, -1))] \
                if top_avail else top[L(-1)]
            fillv = top[L(top_avail - 1)] if top_avail else top[L(-1)]
            top[L(top_avail):L(unf_top)] = fillv
        if left_avail < unf_left:
            fillv = left[L(left_avail - 1)] if left_avail else left[L(-1)]
            left[L(left_avail):L(unf_left)] = fillv
        if rff and filter_smoothing:
            unfilter_last = int(left_size == unf_left)
            fl = left.copy()
            ft = top.copy()
            fl[L(-1)] = ft[L(-1)] = (left[L(0)] + 2 * left[L(-1)] + top[L(0)] + 2) >> 2
            for i in range(unf_left - unfilter_last):
                fl[L(i)] = (left[L(i - 1)] + 2 * left[L(i)] + left[L(i + 1)] + 2) >> 2
            for i in range(unf_top - unfilter_last):
                ft[L(i)] = (top[L(i - 1)] + 2 * top[L(i)] + top[L(i + 1)] + 2) >> 2
            if unfilter_last:
                ft[L(top_size - 1)] = top[L(top_size - 1)]
                fl[L(left_size - 1)] = left[L(left_size - 1)]
            left, top = fl, ft
        if not is_mip and mode not in (INTRA_PLANAR, INTRA_DC,
                                       INTRA_VERT, INTRA_HORZ):
            if mode >= INTRA_DIAG:
                if angle < 0:
                    for xx in range(-h, 0):
                        idx = -1 - ref_idx + min((xx * inv_angle + 256) >> 9, h)
                        top[L(xx - (ref_idx + 1))] = left[L(idx)]
                else:
                    for i in range(refw, refw + max(1, w // h) * ref_idx + 2):
                        top[L(i)] = top[L(refw - 1)]
            else:
                if angle < 0:
                    for xx in range(-w, 0):
                        idx = -1 - ref_idx + min((xx * inv_angle + 256) >> 9, w)
                        left[L(xx - (ref_idx + 1))] = top[L(idx)]
                else:
                    for i in range(refh, refh + max(1, h // w) * ref_idx + 2):
                        left[L(i)] = left[L(refh - 1)]
        # return views offset so that index [PAD] == 0
        return _OffsetArray(left, PAD), _OffsetArray(top, PAD)

    def _pred_planar(self, left, top, w, h):
        logw, logh = ilog2(w), ilog2(h)
        shift = logw + logh + 1
        xs = np.arange(w, dtype=np.int64)
        ys = np.arange(h, dtype=np.int64)
        t = top.arr(0, w)
        l = left.arr(0, h)
        pred_v = ((h - 1 - ys)[:, None] * t[None, :] +
                  (ys + 1)[:, None] * left[h]) << logw
        pred_h = ((w - 1 - xs)[None, :] * l[:, None] +
                  (xs + 1)[None, :] * top[w]) << logh
        return (pred_v + pred_h + w * h) >> shift

    def _pred_dc(self, left, top, w, h):
        offset = (w << 1) if w == h else max(w, h)
        shift = ilog2(offset)
        offset >>= 1
        s = 0
        if w >= h:
            s += int(top.arr(0, w).sum())
        if w <= h:
            s += int(left.arr(0, h).sum())
        dc = (s + offset) >> shift
        return np.full((h, w), dc, dtype=np.int64)

    def _pdpc_hv(self, out, left, top, w, h, mode):
        scale = (ilog2(w) + ilog2(h) - 2) >> 2
        mx = (1 << self.sps.bit_depth) - 1
        res = out.astype(np.int64)
        xs = np.arange(w, dtype=np.int64)
        ys = np.arange(h, dtype=np.int64)
        la = left.arr(0, h).astype(np.int64)[:, None]     # [h, 1]
        ta = top.arr(0, w).astype(np.int64)[None, :]      # [1, w]
        wl_row = 32 >> np.minimum((xs << 1) >> scale, 31)
        wt_col = 32 >> np.minimum((ys << 1) >> scale, 31)
        if mode in (INTRA_PLANAR, INTRA_DC):
            l = la
            t = ta
            wl = wl_row[None, :]
            wt = wt_col[:, None]
        else:
            l = la - left[-1] + res
            t = ta - top[-1] + res
            wl = wl_row[None, :] if mode == INTRA_VERT else 0
            wt = wt_col[:, None] if mode == INTRA_HORZ else 0
        pred = res + ((wl * (l - res) + wt * (t - res) + 32) >> 6)
        return np.clip(pred, 0, mx)

    def _angular_core(self, ref, n_main, n_cross, c_idx, angle, ref_idx,
                      filter_flag):
        """Shared directional interpolation: for each cross-line j
        (rows for V, cols for H) produce n_main predicted samples from the
        1-D reference `ref` (an _OffsetArray).  Returns [n_cross, n_main]."""
        mx = (1 << self.sps.bit_depth) - 1
        is_luma = not c_idx
        js = np.arange(1, n_cross + 1, dtype=np.int64)
        pos = (js + ref_idx) * angle
        idx = (pos >> 5) + ref_idx
        fact = pos & 31                                  # [n_cross]
        base = idx - (1 + ref_idx)
        ks = np.arange(n_main, dtype=np.int64)
        p = base[:, None] + ks[None, :]                  # ref-space index

        ra = ref.a.astype(np.int64)
        off = ref.off

        def R(d):
            return ra[off + p + d]
        if is_luma:
            f = (D.intra_filter(1) if filter_flag else
                 D.intra_filter(0))[fact].astype(np.int64)   # [n_cross, 4]
            v = (R(0) * f[:, 0:1] + R(1) * f[:, 1:2] +
                 R(2) * f[:, 2:3] + R(3) * f[:, 3:4] + 32) >> 6
            v = np.clip(v, 0, mx)
            if not filter_flag:
                copy_rows = fact == 0
                if copy_rows.any():
                    v = np.where(copy_rows[:, None], R(1), v)
        else:
            v = ((32 - fact)[:, None] * R(1) + fact[:, None] * R(2) + 16) >> 5
        return v

    def _pred_angular_v(self, left, top, w, h, c_idx, mode, ref_idx,
                        filter_flag, pdpc):
        mx = (1 << self.sps.bit_depth) - 1
        angle = intra_pred_angle(mode)
        out = self._angular_core(top, w, h, c_idx, angle, ref_idx,
                                 filter_flag)
        if pdpc:
            inv_angle = intra_inv_angle(angle)
            nscale = nscale_derive(w, h, mode)
            wp = min(w, 3 << nscale)
            if wp > 0:
                xs = np.arange(wp, dtype=np.int64)
                s = 256 + inv_angle * (xs + 1)
                la = left.a.astype(np.int64)
                lidx = left.off + np.arange(h, dtype=np.int64)[:, None] + \
                    (s >> 9)[None, :]
                L = la[lidx]
                wl = (32 >> ((xs << 1) >> nscale))[None, :]
                val = out[:, :wp]
                out[:, :wp] = np.clip(
                    val + (((L - val) * wl + 32) >> 6), 0, mx)
        return out

    def _pred_angular_h(self, left, top, w, h, c_idx, mode, ref_idx,
                        filter_flag, pdpc):
        mx = (1 << self.sps.bit_depth) - 1
        angle = intra_pred_angle(mode)
        out = self._angular_core(left, h, w, c_idx, angle, ref_idx,
                                 filter_flag).T                # [h, w]
        if pdpc:
            inv_angle = intra_inv_angle(angle)
            nscale = nscale_derive(w, h, mode)
            hp = min(h, 3 << nscale)
            if hp > 0:
                ys = np.arange(hp, dtype=np.int64)
                s = 256 + inv_angle * (ys + 1)
                ta = top.a.astype(np.int64)
                tidx = top.off + np.arange(w, dtype=np.int64)[None, :] + \
                    (s >> 9)[:, None]
                T = ta[tidx]
                wt = (32 >> np.minimum((ys << 1) >> nscale, 31))[:, None]
                val = out[:hp, :]
                out[:hp, :] = np.clip(
                    val + (((T - val) * wt + 32) >> 6), 0, mx)
        return out

    def _pred_mip(self, plane, left, top, x, y, w, h, mode_id, transposed):
        sps = self.sps
        mx = (1 << sps.bit_depth) - 1
        if w == 4 and h == 4:
            size_id = 0
        elif w == 4 or h == 4 or (w == 8 and h == 8):
            size_id = 1
        else:
            size_id = 2
        boundary_size = (2, 4, 4)[size_id]
        pred_size = (4, 4, 8)[size_id]
        in_size = 2 * boundary_size - (1 if size_id == 2 else 0)
        matrix = D.tables()[("mip_4x4", "mip_8x8", "mip_16x16")[size_id]][mode_id]
        matrix = matrix.reshape(pred_size * pred_size, -1).astype(np.int64)

        def downsample(ref, n):
            b_dwn = n // boundary_size
            if b_dwn == 1:
                return [int(ref[i]) for i in range(n)]
            log2 = ilog2(b_dwn)
            out = []
            k = 0
            for i in range(boundary_size):
                r = 0
                for j in range(b_dwn):
                    r += int(ref[k])
                    k += 1
                out.append((r + (1 << (log2 - 1))) >> log2)
            return out

        red_t = downsample(top, w)
        red_l = downsample(left, h)
        reduced = (red_l + red_t) if transposed else (red_t + red_l)
        temp0 = reduced[0]
        if size_id != 2:
            off = 0
            ow = (1 << (sps.bit_depth - 1)) - temp0
        else:
            off = 1
            ow = reduced[1] - temp0
        red = [0] * in_size
        red[0] = ow
        acc = ow
        for i in range(1, in_size):
            red[i] = reduced[i + off] - temp0
            acc += red[i]
        ow = 32 - 32 * acc
        up_hor = w // pred_size
        up_ver = h // pred_size
        # reduced prediction
        out = plane[y:y + h, x:x + w]
        predbuf = np.zeros((h, w), dtype=np.int64)
        predbuf[:] = out  # keep untouched positions
        m = 0
        for yy in range(pred_size):
            for xx in range(pred_size):
                pred = 0
                for i in range(in_size):
                    pred += red[i] * int(matrix[m, i])
                m += 1
                pred = ((pred + ow) >> 6) + temp0
                pred = max(0, min(mx, pred))
                if transposed:
                    predbuf[xx * up_ver + up_ver - 1, yy * up_hor + up_hor - 1] = pred
                else:
                    predbuf[yy * up_ver + up_ver - 1, xx * up_hor + up_hor - 1] = pred
        if up_hor > 1:
            # horizontal upsampling along rows at sampled vertical positions
            for yy in range(up_ver - 1, h, up_ver):
                before = int(left[yy])
                for j in range(pred_size):
                    after = int(predbuf[yy, j * up_hor + up_hor - 1])
                    for k in range(1, up_hor):
                        mid = (up_hor - k) * before + k * after
                        predbuf[yy, j * up_hor + k - 1] = (mid + up_hor // 2) // up_hor
                    before = after
        if up_ver > 1:
            for xx in range(w):
                before = int(top[xx])
                for j in range(pred_size):
                    after = int(predbuf[j * up_ver + up_ver - 1, xx])
                    for k in range(1, up_ver):
                        mid = (up_ver - k) * before + k * after
                        predbuf[j * up_ver + k - 1, xx] = (mid + up_ver // 2) // up_ver
                    before = after
        return predbuf

    # --- dequant / inverse transform ----------------------------------------

    def itransform(self, cu, tu, tu_idx, target_ch_type):
        sps = self.sps
        for tb in tu.tbs:
            c_idx = tb.c_idx
            ch_type = int(c_idx > 0)
            if ch_type != target_ch_type or not tb.has_coeffs:
                continue
            if not getattr(tb, "residual_ready", False):
                self.compute_residual(cu, tu, tb)
            res = tb.coeffs
            # luma-dependent chroma residual scaling (vvc_intra.c:449)
            chroma_scale = ch_type and self.lmcs_used and \
                self.chroma_scale_on and tb.w * tb.h > 4
            if chroma_scale:
                res = self._lmcs_scale_residual(res, cu.x0, cu.y0)
            plane = self.fb.planes[c_idx]
            hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
            x, y = tb.x0 >> hs, tb.y0 >> vs
            mxv = (1 << sps.bit_depth) - 1
            blk = plane[y:y + tb.h, x:x + tb.w] + res
            plane[y:y + tb.h, x:x + tb.w] = np.clip(blk, 0, mxv)
            if tu.joint_cbcr_residual_flag and c_idx:
                self._jcbcr(cu, tu, tb, chroma_scale)

    def _jcbcr(self, cu, tu, tb, chroma_scale=False):
        """add_residual_for_joint_coding_chroma (vvc_intra.c:166).

        The co-coded chroma plane gets (res * c_sign) >> shift added, where
        shift = coded_flag[CB] ^ coded_flag[CR], target c_idx = 1 + coded[CB].
        """
        sps = self.sps
        c_sign = 1 - 2 * self.ph_r.ph_joint_cbcr_sign_flag
        shift = tu.coded_flag[CB] ^ tu.coded_flag[CR]
        c_idx = 1 + tu.coded_flag[CB]
        out = np.right_shift(tb.coeffs * c_sign, shift)
        if chroma_scale:
            out = self._lmcs_scale_residual(out, cu.x0, cu.y0)
        plane = self.fb.planes[c_idx]
        hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
        x, y = tb.x0 >> hs, tb.y0 >> vs
        mxv = (1 << sps.bit_depth) - 1
        blk = plane[y:y + tb.h, x:x + tb.w] + out
        plane[y:y + tb.h, x:x + tb.w] = np.clip(blk, 0, mxv)

    ph_r = None  # set by decoder per frame
    dep_quant = 0

    def compute_residual(self, cu, tu, tb):
        """Full host residual chain for one TB (golden path)."""
        if cu.bdpcm_flag[tb.c_idx]:
            self._transform_bdpcm(cu, tb)
        self._dequant(cu, tu, tb)
        if not tb.ts:
            if cu.apply_lfnst_flag[tb.c_idx]:
                self._ilfnst(cu, tb)
            trh, trv = self._transform_type(cu, tb)
            self._itx_2d(tb, trh, trv)
        tb.residual_ready = True

    def prepare_tb_for_itx(self, cu, tu, tb):
        """Host prep only (BDPCM + dequant + LFNST + transform-type decision);
        leaves tb.coeffs ready for the batched device inverse transform.

        Returns (trh, trv, log2_range) or None when no device itx is needed
        (transform-skip: tb.coeffs is already the final residual)."""
        if cu.bdpcm_flag[tb.c_idx]:
            self._transform_bdpcm(cu, tb)
        self._dequant(cu, tu, tb)
        if tb.ts:
            tb.residual_ready = True
            return None
        if cu.apply_lfnst_flag[tb.c_idx]:
            self._ilfnst(cu, tb)
        trh, trv = self._transform_type(cu, tb)
        if self._log2_range > 15:
            # extended-precision coeffs can overflow the device int32 dot;
            # rare (sps_extended_precision_flag) -> host int64 path
            self._itx_2d(tb, trh, trv)
            tb.residual_ready = True
            return None
        return trh, trv, self._log2_range

    def _dequant(self, cu, tu, tb):
        """derive_qp + derive_scale + scale_coeff (vvc_intra.c:277-417)."""
        sps = self.sps
        log2_range = max(15, min(20, sps.bit_depth + 6)) \
            if sps.r.sps_extended_precision_flag else 15
        if tb.c_idx == 0:
            qp = cu.qp[LUMA] + sps.qp_bd_offset
        else:
            is_jcbcr = tu.joint_cbcr_residual_flag and tu.coded_flag[CB] and \
                tu.coded_flag[CR]
            idx = JCBCR if is_jcbcr else tb.c_idx
            qp = cu.qp[idx]
        if tb.ts:
            qp_prime_ts_min = 4 + 6 * sps.r.sps_min_qp_prime_ts
            qp = max(qp_prime_ts_min, min(63 + sps.qp_bd_offset, qp))
            rect_non_ts = 0
            bd_shift = 10
        else:
            log_sum = tb.log2_w + tb.log2_h
            rect_non_ts = log_sum & 1
            qp = max(0, min(63 + sps.qp_bd_offset, qp))
            bd_shift = sps.bit_depth + rect_non_ts + (log_sum // 2) + 10 - \
                log2_range + self.dep_quant
        bd_offset = (1 << bd_shift) >> 1
        addin = self.dep_quant and not tb.ts
        q = qp + addin
        scale = int(D.LEVEL_SCALE[rect_non_ts][q % 6]) << (q // 6)
        scale_m = self._derive_scale_m(cu, tb)
        lo, hi = -(1 << log2_range), (1 << log2_range) - 1
        self._log2_range = log2_range
        c = tb.coeffs
        c = c.astype(np.int64)
        c = (c * scale * scale_m + bd_offset) >> bd_shift
        tb.coeffs = np.clip(c, lo, hi)

    scaling_list = None       # VVCScalingList, attached by the decoder
    explicit_sl_used = False  # sh_explicit_scaling_list_used_flag

    # Table 38 scaling matrix id per (inter, c_idx, max_log2-1)
    _SL_IDS = (((0, 2, 8, 14, 20, 26), (0, 3, 9, 15, 21, 21),
                (0, 4, 10, 16, 22, 22)),
               ((0, 5, 11, 17, 23, 27), (0, 6, 12, 18, 24, 24),
                (1, 7, 13, 19, 25, 25)))

    def _derive_scale_m(self, cu, tb):
        """derive_scale_m (vvc_intra.c:340-386): per-coeff quant matrix, or
        the flat default 16."""
        sps = self.sps
        if self.scaling_list is None or not self.explicit_sl_used or tb.ts \
                or (sps.r.sps_scaling_matrix_for_lfnst_disabled_flag and
                    cu.apply_lfnst_flag[tb.c_idx]):
            return 16
        sl = self.scaling_list
        sid = self._SL_IDS[cu.pred_mode != MODE_INTRA][tb.c_idx][
            max(tb.log2_h, tb.log2_w) - 1]
        lm = 1 if sid < 2 else (2 if sid < 8 else 3)
        msize = 1 << lm
        mat = sl.rec[sid][:msize * msize].reshape(msize, msize)
        ys = (np.arange(tb.h) << lm) >> tb.log2_h
        xs = (np.arange(tb.w) << lm) >> tb.log2_w
        m = mat[np.ix_(ys, xs)].copy()
        if sid >= sl.SL_START_16x16:
            m[0, 0] = sl.dc[sid - 14]
        return m

    def _transform_bdpcm(self, cu, tb):
        mode = cu.intra_pred_mode_c if tb.c_idx else cu.intra_pred_mode_y
        vertical = mode == INTRA_VERT
        c = tb.coeffs.astype(np.int64)
        log2_range = max(15, min(20, self.sps.bit_depth + 6)) \
            if self.sps.r.sps_extended_precision_flag else 15
        lo, hi = -(1 << log2_range), (1 << log2_range) - 1
        if vertical:
            c = np.clip(np.cumsum(c, axis=0), lo, hi)
            tb.max_scan_y = tb.h - 1
        else:
            c = np.clip(np.cumsum(c, axis=1), lo, hi)
            tb.max_scan_x = tb.w - 1
        tb.coeffs = c

    def _ilfnst(self, cu, tb):
        """LFNST inverse secondary transform (vvc_intra.c:65-127)."""
        sps = self.sps
        w, h = tb.w, tb.h
        n_out = 48 if (w >= 8 and h >= 8) else 16
        log2_size = 3 if (w >= 8 and h >= 8) else 2
        n_size = 1 << log2_size
        non_zero = 8 if ((w == 8 and h == 8) or (w == 4 and h == 4)) else 16
        pred_mode = self._ilfnst_pred_mode(cu, tb)
        transpose = pred_mode > 34
        scan = D.diag_scan(4, 4)
        u = np.zeros(16, dtype=np.int64)
        for i in range(non_zero):
            u[i] = tb.coeffs[scan[i][1], scan[i][0]]
        t = D.tables()
        set_idx = 1 if pred_mode < 0 else int(t["lfnst_tr_set_index"][pred_mode])
        mat = (t["lfnst_8x8"] if n_out > 16 else t["lfnst_4x4"])[
            set_idx][cu.lfnst_idx - 1].astype(np.int64)
        v = (u[:non_zero] @ mat[:non_zero]).astype(np.int64)
        log2_range = self._log2_range
        lo, hi = -(1 << log2_range), (1 << log2_range) - 1
        v = np.clip((v + 64) >> 7, lo, hi)
        out = np.zeros((h, w), dtype=np.int64)
        if transpose:
            if n_size == 4:
                out[:4, :4] = v[:16].reshape(4, 4).T
            else:
                for yy in range(8):
                    out[yy, 0] = v[yy]
                    out[yy, 1] = v[8 + yy]
                    out[yy, 2] = v[16 + yy]
                    out[yy, 3] = v[24 + yy]
                    if yy < 4:
                        out[yy, 4] = v[32 + yy]
                        out[yy, 5] = v[36 + yy]
                        out[yy, 6] = v[40 + yy]
                        out[yy, 7] = v[44 + yy]
        else:
            k = 0
            for yy in range(n_size):
                size = n_size if yy < 4 else 4
                out[yy, :size] = v[k:k + size]
                k += size
        tb.coeffs = out
        tb.max_scan_x = n_size - 1
        tb.max_scan_y = n_size - 1

    def _ilfnst_pred_mode(self, cu, tb):
        sps = self.sps
        tabs = self.tabs
        x_tb, y_tb = tb.x0 >> 2, tb.y0 >> 2
        x_c = (tb.x0 + (tb.w << sps.hshift[1] >> 1)) >> 2
        y_c = (tb.y0 + (tb.h << sps.vshift[1] >> 1)) >> 2
        mip = int(tabs.imf[y_tb, x_tb])
        mode = cu.intra_pred_mode_y if tb.c_idx == 0 else cu.intra_pred_mode_c
        if mip and not tb.c_idx:
            mode = INTRA_PLANAR
        elif is_cclm(mode):
            if int(tabs.imf[y_c, x_c]):
                mode = INTRA_PLANAR
            elif int(tabs.cpm[0][y_c, x_c]) in (MODE_IBC, MODE_PLT):
                mode = INTRA_DC
            else:
                mode = int(tabs.ipm[y_c, x_c])
        return wide_angle_map(cu, tb.w, tb.h, tb.c_idx, mode)

    def _transform_type(self, cu, tb):
        sps = self.sps
        if tb.c_idx or (cu.isp_split_type != ISP_NO_SPLIT and cu.lfnst_idx):
            return DCT2, DCT2
        implicit = False
        if sps.r.sps_mts_enabled_flag:
            if cu.isp_split_type != ISP_NO_SPLIT or \
                    (cu.sbt_flag and max(tb.w, tb.h) <= 32) or \
                    (not sps.r.sps_explicit_mts_intra_enabled_flag and
                     cu.pred_mode == MODE_INTRA and not cu.lfnst_idx and
                     not cu.intra_mip_flag):
                implicit = True
        if implicit:
            if cu.sbt_flag:
                trh = DST7 if (cu.sbt_horizontal_flag or cu.sbt_pos_flag) else DCT8
                trv = DST7 if (not cu.sbt_horizontal_flag or cu.sbt_pos_flag) else DCT8
            else:
                trh = DST7 if 4 <= tb.w <= 16 else DCT2
                trv = DST7 if 4 <= tb.h <= 16 else DCT2
            return trh, trv
        to_trh = (DCT2, DST7, DCT8, DST7, DCT8)
        to_trv = (DCT2, DST7, DST7, DCT8, DCT8)
        return to_trh[cu.mts_idx], to_trv[cu.mts_idx]

    def _itx_2d(self, tb, trh, trv):
        """itx_2d / itx_1d (vvcdsp.c:94-140) on int64 matrices."""
        sps = self.sps
        log2_range = self._log2_range
        bd = sps.bit_depth
        w, h = tb.w, tb.h
        nzw, nzh = tb.max_scan_x + 1, tb.max_scan_y + 1
        c = tb.coeffs.astype(np.int64)
        mats = {DCT2: D.dct2_matrix, DST7: D.dst7_matrix, DCT8: D.dct8_matrix}
        lo, hi = -(1 << log2_range), (1 << log2_range) - 1
        if w == 1 or h == 1:
            shift = 6 + log2_range - bd
            add = 1 << (shift - 1)
            if nzw == 1 and nzh == 1 and trh == DCT2 and trv == DCT2:
                dc = (int(c[0, 0]) * 64 + add) >> shift
                tb.coeffs = np.full((h, w), dc, dtype=np.int64)
                return
            if w > 1:
                m = mats[trh](w).astype(np.int64)
                row = c[0, :nzw] @ m[:nzw]
                c = ((row + add) >> shift)[None, :]
            else:
                m = mats[trv](h).astype(np.int64)
                col = c[:nzh, 0] @ m[:nzh]
                c = ((col + add) >> shift)[:, None]
            tb.coeffs = c
            return
        shift0 = 7
        shift1 = 5 + log2_range - bd
        if w == h and nzw == 1 and nzh == 1 and trh == DCT2 and trv == DCT2:
            t = (int(c[0, 0]) * 64 + (1 << (shift0 - 1))) >> shift0
            dc = (t * 64 + (1 << (shift1 - 1))) >> shift1
            tb.coeffs = np.full((h, w), dc, dtype=np.int64)
            return
        mv = mats[trv](h).astype(np.int64)
        mh = mats[trh](w).astype(np.int64)
        # column pass over the first nzw columns, nzh input rows
        tmp = np.zeros((h, w), dtype=np.int64)
        tmp[:, :nzw] = mv[:nzh].T @ c[:nzh, :nzw]
        tmp = np.clip((tmp + (1 << (shift0 - 1))) >> shift0, lo, hi)
        tmp[:, nzw:] = 0
        out = tmp[:, :nzw] @ mh[:nzw]
        out = (out + (1 << (shift1 - 1))) >> shift1
        tb.coeffs = out


class _OffsetArray:
    """1-D array with negative indexing around an origin."""

    __slots__ = ("a", "off")

    def __init__(self, a, off):
        self.a = a
        self.off = off

    def __getitem__(self, i):
        return int(self.a[self.off + i])

    def __setitem__(self, i, v):
        self.a[self.off + i] = v

    def arr(self, start, n):
        return self.a[self.off + start:self.off + start + n]
