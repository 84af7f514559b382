# Frozen copy of ffvvc_tpu_torch/mvs.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none.
"""Motion vector derivation (H.266 clause 8.5.2).

Reference analogue: libavcodec/vvc/vvc_mvs.c — spatial merge
candidates :638, temporal :678, HMVP :694, pairwise :713, zero :752, AMVP
:1405-1570, TMVP scaling :71-110, MV storage :251-537, HMVP update :1762.

MV fields are stored in dense per-4x4 grids on FrameTabs (the reference's
fc->tab.mvf plane-of-arrays) — the tensor layout the TPU inter stage
consumes directly.
"""
from __future__ import annotations

import numpy as np

# PredFlag (reference vvc_ctu.h)
PF_INTRA, PF_L0, PF_L1, PF_BI = 0, 1, 2, 3
L0, L1 = 0, 1
MAX_NUM_HMVP_CANDS = 5


def clip(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


class MvField:
    """One 4x4 motion field entry (reference MvField, vvc_ctu.h)."""
    __slots__ = ("pred_flag", "mv", "ref_idx", "bcw_idx", "hpel_if_idx",
                 "ciip_flag")

    def __init__(self):
        self.pred_flag = PF_INTRA
        self.mv = [[0, 0], [0, 0]]
        self.ref_idx = [0, 0]
        self.bcw_idx = 0
        self.hpel_if_idx = 0
        self.ciip_flag = 0

    def copy(self):
        o = MvField()
        o.pred_flag = self.pred_flag
        o.mv = [list(self.mv[0]), list(self.mv[1])]
        o.ref_idx = list(self.ref_idx)
        o.bcw_idx = self.bcw_idx
        o.hpel_if_idx = self.hpel_if_idx
        o.ciip_flag = self.ciip_flag
        return o


def same_mv_ref(n: MvField, o) -> bool:
    """compare_mv_ref_idx (vvc_mvs.c:40)."""
    if o is None or n.pred_flag != o.pred_flag:
        return False
    for i in range(2):
        if n.pred_flag & (i + 1):
            if n.ref_idx[i] != o.ref_idx[i] or n.mv[i] != o.mv[i]:
                return False
    return True


def round_mv(mv, lshift, rshift):
    """ff_vvc_round_mv (vvc_mvs.c:1745)."""
    if rshift:
        off = 1 << (rshift - 1)
        mv[0] = ((mv[0] + off - (mv[0] >= 0)) >> rshift) * (1 << lshift)
        mv[1] = ((mv[1] + off - (mv[1] >= 0)) >> rshift) * (1 << lshift)
    else:
        mv[0] *= 1 << lshift
        mv[1] *= 1 << lshift


def clip_mv(mv):
    mv[0] = clip(mv[0], -(1 << 17), (1 << 17) - 1)
    mv[1] = clip(mv[1], -(1 << 17), (1 << 17) - 1)


def mv_scale(src, td, tb):
    """ff_vvc_mv_scale (vvc_mvs.c:71)."""
    td = clip(td, -128, 127)
    tb = clip(tb, -128, 127)
    tx = (0x4000 + (abs(td) >> 1)) // td if td > 0 else \
        -((0x4000 + (abs(td) >> 1)) // -td)  # C truncating division
    scale = clip((tb * tx + 32) >> 6, -(1 << 11), (1 << 11) - 1)
    out = [0, 0]
    for i in range(2):
        p = scale * src[i]
        out[i] = clip((p + 127 + (p < 0)) >> 8, -(1 << 17), (1 << 17) - 1)
    return out


def mv_compression(mv):
    """8.5.2.15 temporal motion buffer compression (vvc_mvs.c:58)."""
    for i in range(2):
        v = mv[i]
        s = v >> 17
        f = max(((v ^ s) | 31).bit_length() - 1, 0) - 4
        mask = (-1 * (1 << f)) >> 1
        rnd = (1 << f) >> 2
        mv[i] = (v + rnd) & mask


class MotionContext:
    """Per-slice motion derivation state: RPL + neighbour availability come
    from the CtuCoder; HMVP lives on the entry point (coder)."""

    def __init__(self, coder):
        self.c = coder          # CtuCoder: sps/pps/sh/tabs/na flags
        self.ph = coder.sh.ph   # raw picture header
        self.tabs = coder.tabs
        self.sps = coder.sps
        self.pps = coder.pps

    # --- mvf grid access ---------------------------------------------------

    def get_mvf(self, x, y) -> MvField:
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

    def set_mvf(self, x0, y0, w, h, f: MvField):
        t = self.tabs
        x1, y1 = (x0 + w) >> 2, (y0 + h) >> 2
        x0, y0 = x0 >> 2, y0 >> 2
        t.mvf_pf[y0:y1, x0:x1] = f.pred_flag
        for i in range(2):
            t.mvf_mv[i, y0:y1, x0:x1, 0] = f.mv[i][0]
            t.mvf_mv[i, y0:y1, x0:x1, 1] = f.mv[i][1]
            t.mvf_ref[i, y0:y1, x0:x1] = f.ref_idx[i]
        t.mvf_bcw[y0:y1, x0:x1] = f.bcw_idx
        t.mvf_hpel[y0:y1, x0:x1] = f.hpel_if_idx
        t.mvf_ciip[y0:y1, x0:x1] = f.ciip_flag

    def set_intra_mvf(self, x0, y0, w, h):
        t = self.tabs
        x1, y1 = (x0 + w) >> 2, (y0 + h) >> 2
        t.mvf_pf[y0 >> 2:y1, x0 >> 2:x1] = PF_INTRA

    # --- neighbour machinery (vvc_mvs.c:519-615) ---------------------------

    A0, A1, A2, B0, B1, B2, B3 = range(7)

    def _neighbours(self, cu):
        x0, y0, w, h = cu.x0, cu.y0, cu.cb_width, cu.cb_height
        na = self.c.na
        a0_avail = self._is_a0_available(cu)
        return [
            (x0 - 1, y0 + h, not a0_avail),          # A0
            (x0 - 1, y0 + h - 1, not na.cand_left),  # A1
            (x0 - 1, y0, not na.cand_left),          # A2
            (x0 + w, y0 - 1, not na.cand_up_right),  # B0
            (x0 + w - 1, y0 - 1, not na.cand_up),    # B1
            (x0 - 1, y0 - 1, not na.cand_up_left),   # B2
            (x0, y0 - 1, not na.cand_up),            # B3
        ]

    def _is_available(self, x, y):
        # reference samples fc->tab.cb_width[0] on the min-CB grid
        # (vvc_mvs.c:544); our grid is 4x4 with values replicated per CU
        return int(self.tabs.cb_width[0][y >> 2, x >> 2]) != 0

    def _is_a0_available(self, cu):
        sps = self.sps
        x0b = cu.x0 & ((1 << sps.ctb_log2_size_y) - 1)
        if not x0b and not self.c.ctb_left_flag:
            return False
        max_y = min(self.pps.height,
                    ((cu.y0 >> sps.ctb_log2_size_y) + 1) << sps.ctb_log2_size_y)
        if cu.y0 + cu.cb_height >= max_y:
            return False
        return self._is_available(cu.x0 - 1, cu.y0 + cu.cb_height)

    def _check_available(self, cu, nb, is_mvp):
        x, y, excluded = nb
        if excluded:
            return False
        sps = self.sps
        if sps.r.sps_entropy_coding_sync_enabled_flag and \
                (x >> sps.ctb_log2_size_y) > (cu.x0 >> sps.ctb_log2_size_y):
            return False
        if not self._is_available(x, y):
            return False
        if int(self.tabs.mvf_pf[y >> 2, x >> 2]) == PF_INTRA:
            return False
        if not is_mvp and self._is_same_mer(x, y, cu.x0, cu.y0):
            return False
        return True

    def _is_same_mer(self, xn, yn, xp, yp):
        pl = self.sps.log2_parallel_merge_level
        return (xn >> pl) == (xp >> pl) and (yn >> pl) == (yp >> pl)

    # --- temporal (TMVP) ---------------------------------------------------

    def no_backward_pred_flag(self):
        rpl = self.c.rpl
        poc = self.c.poc
        for lst in rpl:
            for p in lst.poc_list:
                if p > poc:
                    return 0
        return 1

    def _check_mvset(self, mv_col_in, col_poc, lx_col, ref_idx_col,
                     rpl_col, x_lx, ref_idx_lx):
        """check_mvset (vvc_mvs.c:88): returns scaled MV or None."""
        rpl = self.c.rpl
        cur_lt = rpl[x_lx].is_lt[ref_idx_lx]
        col_lt = rpl_col[lx_col].is_lt[ref_idx_col]
        if cur_lt != col_lt:
            return None
        col_poc_diff = col_poc - rpl_col[lx_col].poc_list[ref_idx_col]
        cur_poc_diff = self.c.poc - rpl[x_lx].poc_list[ref_idx_lx]
        mv_col = list(mv_col_in)
        mv_compression(mv_col)
        if cur_lt or col_poc_diff == cur_poc_diff:
            return [clip(mv_col[0], -(1 << 17), (1 << 17) - 1),
                    clip(mv_col[1], -(1 << 17), (1 << 17) - 1)]
        return mv_scale(mv_col, col_poc_diff, cur_poc_diff)

    def _derive_temporal_col(self, temp_col, ref_idx_lx, x_lx, rpl_col,
                             sb_flag):
        """derive_temporal_colocated_mvs (vvc_mvs.c:140)."""
        pf = temp_col.pred_flag
        if pf == PF_INTRA:
            return None

        def check(l):
            return self._check_mvset(temp_col.mv[l], self.col_poc, l,
                                     temp_col.ref_idx[l], rpl_col,
                                     x_lx, ref_idx_lx)
        if sb_flag:
            if x_lx == 0:
                if pf & PF_L0:
                    return check(0)
                if self.no_backward_pred_flag() and (pf & PF_L1):
                    return check(1)
            else:
                if pf & PF_L1:
                    return check(1)
                if self.no_backward_pred_flag() and (pf & PF_L0):
                    return check(0)
            return None
        if not (pf & PF_L0):
            return check(1)
        if pf == PF_L0:
            return check(0)
        # PF_BI
        if self.no_backward_pred_flag():
            return check(0) if x_lx == 0 else check(1)
        return check(0) if not self.c.sh.r.sh_collocated_from_l0_flag \
            else check(1)

    def temporal_luma_mv(self, cu, ref_idx_lx, x_lx, check_center, sb_flag):
        """temporal_luma_motion_vector (vvc_mvs.c:200) -> mv or None."""
        col = self.c.collocated_ref
        if col is None:
            return None
        if not self.ph.ph_temporal_mvp_enabled_flag or \
                (cu.cb_width * cu.cb_height <= 32):
            return None
        self.col_poc = col.poc
        ctb_log2 = self.sps.ctb_log2_size_y
        x = cu.x0 + cu.cb_width
        y = cu.y0 + cu.cb_height
        mv = None
        if (cu.y0 >> ctb_log2) == (y >> ctb_log2) and \
                y < self.sps.r.sps_pic_height_max_in_luma_samples and \
                x < self.sps.r.sps_pic_width_max_in_luma_samples:
            xa, ya = x & ~7, y & ~7
            temp_col = col.get_mvf(xa, ya)
            rpl_col = col.rpl_at(xa, ya)
            mv = self._derive_temporal_col(temp_col, ref_idx_lx, x_lx,
                                           rpl_col, sb_flag)
        if check_center and mv is None:
            xa = (cu.x0 + (cu.cb_width >> 1)) & ~7
            ya = (cu.y0 + (cu.cb_height >> 1)) & ~7
            temp_col = col.get_mvf(xa, ya)
            rpl_col = col.rpl_at(xa, ya)
            mv = self._derive_temporal_col(temp_col, ref_idx_lx, x_lx,
                                           rpl_col, sb_flag)
        return mv

    # --- merge mode (vvc_mvs.c:638-817) ------------------------------------

    def _merge_spatial(self, cu, merge_idx, nb_list, cand_list):
        nbs = self._neighbours(cu)
        seq = [(self.B1, None), (self.A1, self.B1), (self.B0, self.B1),
               (self.A0, self.A1)]
        for nb, old in seq:
            cand = None
            if self._check_available(cu, nbs[nb], is_mvp=False):
                cand = self.get_mvf(nbs[nb][0], nbs[nb][1])
            nb_list[nb] = cand
            if cand is not None and not same_mv_ref(cand, nb_list.get(old)):
                cand_list.append(cand)
                if merge_idx == len(cand_list) - 1:
                    return True
        if len(cand_list) != 4:
            if self._check_available(cu, nbs[self.B2], is_mvp=False):
                cand = self.get_mvf(nbs[self.B2][0], nbs[self.B2][1])
                if not same_mv_ref(cand, nb_list.get(self.A1)) and \
                        not same_mv_ref(cand, nb_list.get(self.B1)):
                    cand_list.append(cand)
                    if merge_idx == len(cand_list) - 1:
                        return True
        return False

    def _merge_temporal(self, cu):
        cand = MvField()
        if self.ph.ph_temporal_mvp_enabled_flag and \
                cu.cb_width * cu.cb_height > 32:
            mv0 = self.temporal_luma_mv(cu, 0, 0, 1, 0)
            mv1 = self.temporal_luma_mv(cu, 0, 1, 1, 0) \
                if self.c.sh.is_b else None
            pf = (mv0 is not None) + ((mv1 is not None) << 1)
            cand.pred_flag = pf
            if mv0 is not None:
                cand.mv[0] = mv0
            if mv1 is not None:
                cand.mv[1] = mv1
        return cand if cand.pred_flag else None

    def _merge_history(self, merge_idx, nb_list, cand_list):
        hmvp = self.c.hmvp
        max_cand = self.sps.max_num_merge_cand
        i = 1
        while i <= len(hmvp) and len(cand_list) < max_cand - 1:
            h = hmvp[len(hmvp) - i]
            same = i <= 2 and (same_mv_ref(h, nb_list.get(self.A1)) or
                               same_mv_ref(h, nb_list.get(self.B1)))
            if not same:
                cand_list.append(h.copy())
                if merge_idx == len(cand_list) - 1:
                    return True
            i += 1
        return False

    def _merge_pairwise(self, cand_list, is_b):
        if len(cand_list) <= 1:
            return False
        p0, p1 = cand_list[0], cand_list[1]
        cand = MvField()
        for i in range(2 if is_b else 1):
            mask = i + 1
            if p0.pred_flag & mask:
                cand.pred_flag |= mask
                cand.ref_idx[i] = p0.ref_idx[i]
                if p1.pred_flag & mask:
                    mv = [p0.mv[i][0] + p1.mv[i][0],
                          p0.mv[i][1] + p1.mv[i][1]]
                    round_mv(mv, 0, 1)
                    cand.mv[i] = mv
                else:
                    cand.mv[i] = list(p0.mv[i])
            elif p1.pred_flag & mask:
                cand.pred_flag |= mask
                cand.mv[i] = list(p1.mv[i])
                cand.ref_idx[i] = p1.ref_idx[i]
        if cand.pred_flag:
            cand.hpel_if_idx = p0.hpel_if_idx \
                if p0.hpel_if_idx == p1.hpel_if_idx else 0
            cand_list.append(cand)
            return True
        return False

    def _merge_zero(self, merge_idx, cand_list):
        rsh = self.c.sh.r
        is_b = self.c.sh.is_b
        if self.c.sh.is_p:
            num_ref = rsh.num_ref_idx_active[L0]
        else:
            num_ref = min(rsh.num_ref_idx_active[L0],
                          rsh.num_ref_idx_active[L1])
        zero_idx = 0
        while len(cand_list) < self.sps.max_num_merge_cand:
            cand = MvField()
            cand.pred_flag = PF_L0 + (is_b << 1)
            ri = zero_idx if zero_idx < num_ref else 0
            cand.ref_idx = [ri, ri]
            cand_list.append(cand)
            if merge_idx == len(cand_list) - 1:
                return
            zero_idx += 1

    def mv_merge_mode(self, cu, merge_idx):
        """mv_merge_mode (vvc_mvs.c:785): candidate list valid through
        merge_idx; returns the list."""
        cand_list = []
        nb_list = {}
        if self._merge_spatial(cu, merge_idx, nb_list, cand_list):
            return cand_list
        tc = self._merge_temporal(cu)
        if tc is not None:
            cand_list.append(tc)
            if merge_idx == len(cand_list) - 1:
                return cand_list
        if self._merge_history(merge_idx, nb_list, cand_list):
            return cand_list
        if self._merge_pairwise(cand_list, self.c.sh.is_b):
            if merge_idx == len(cand_list) - 1:
                return cand_list
        self._merge_zero(merge_idx, cand_list)
        return cand_list

    def luma_mv_merge_mode(self, cu, merge_idx, ciip_flag) -> MvField:
        """ff_vvc_luma_mv_merge_mode (vvc_mvs.c:806)."""
        self.c.set_neighbour_available(cu.x0, cu.y0, cu.cb_width,
                                       cu.cb_height)
        mv = self.mv_merge_mode(cu, merge_idx)[merge_idx].copy()
        mv.ciip_flag = ciip_flag
        return mv

    def luma_mv_merge_gpm(self, cu, merge_gpm_idx):
        """ff_vvc_luma_mv_merge_gpm (vvc_mvs.c:818)."""
        self.c.set_neighbour_available(cu.x0, cu.y0, cu.cb_width,
                                       cu.cb_height)
        idx = [merge_gpm_idx[0],
               merge_gpm_idx[1] + (merge_gpm_idx[1] >= merge_gpm_idx[0])]
        cand_list = self.mv_merge_mode(cu, max(idx[0], idx[1]))
        out = []
        for i in range(2):
            lx = idx[i] & 1
            mask = lx + PF_L0
            cand = cand_list[idx[i]]
            if not (cand.pred_flag & mask):
                lx = 1 - lx
                mask = lx + PF_L0
            f = MvField()
            f.pred_flag = mask
            f.ref_idx[lx] = cand.ref_idx[lx]
            f.mv[lx] = list(cand.mv[lx])
            out.append(f)
        return out

    # --- AMVP (vvc_mvs.c:1405-1598) ----------------------------------------

    def _mvp_candidate(self, x, y, lx, ref_idx):
        rpl = self.c.rpl
        f = self.get_mvf(x, y)
        poc = rpl[lx].poc_list[ref_idx[lx]]
        if (f.pred_flag & (lx + 1)) and \
                rpl[lx].poc_list[f.ref_idx[lx]] == poc:
            return list(f.mv[lx])
        ly = 1 - lx
        if (f.pred_flag & (ly + 1)) and \
                rpl[ly].poc_list[f.ref_idx[ly]] == poc:
            return list(f.mv[ly])
        return None

    def _mvp_from_nbs(self, cu, nbs, idxs, lx, ref_idx, amvr_shift):
        for nb in idxs:
            if self._check_available(cu, nbs[nb], is_mvp=True):
                mv = self._mvp_candidate(nbs[nb][0], nbs[nb][1], lx, ref_idx)
                if mv is not None:
                    round_mv(mv, amvr_shift, amvr_shift)
                    return mv
        return None

    def _mvp_history(self, mvp_lx_flag, lx, ref_idx_val, amvr_shift,
                     num_cands):
        hmvp = self.c.hmvp
        rpl = self.c.rpl
        poc = rpl[lx].poc_list[ref_idx_val]
        if not hmvp:
            return None
        for i in range(1, min(4, len(hmvp)) + 1):
            h = hmvp[i - 1]
            for j in range(2):
                ly = (1 - lx) if j else lx
                if (h.pred_flag & (PF_L0 + ly)) and \
                        poc == rpl[ly].poc_list[h.ref_idx[ly]]:
                    if mvp_lx_flag == num_cands:
                        mv = list(h.mv[ly])
                        round_mv(mv, amvr_shift, amvr_shift)
                        return mv
                    num_cands += 1
        return None

    def mvp(self, cu, mvp_lx_flag, lx, ref_idx, amvr_shift):
        """mvp (vvc_mvs.c:1569) -> [x, y]."""
        nbs = self._neighbours(cu)
        num_cands = 0
        mv_a = None
        mv = self._mvp_from_nbs(cu, nbs, (self.A0, self.A1), lx, ref_idx,
                                amvr_shift)
        if mv is not None:
            if mvp_lx_flag == num_cands:
                return mv
            num_cands += 1
            mv_a = mv
        mv = self._mvp_from_nbs(cu, nbs, (self.B0, self.B1, self.B2), lx,
                                ref_idx, amvr_shift)
        if mv is not None and (mv_a is None or mv_a != mv):
            if mvp_lx_flag == num_cands:
                return mv
            num_cands += 1
        tmv = self.temporal_luma_mv(cu, ref_idx[lx], lx, 1, 0)
        if tmv is not None:
            if mvp_lx_flag == num_cands:
                round_mv(tmv, amvr_shift, amvr_shift)
                return tmv
            num_cands += 1
        hmv = self._mvp_history(mvp_lx_flag, lx, ref_idx[lx], amvr_shift,
                                num_cands)
        if hmv is not None:
            return hmv
        return [0, 0]

    def ff_mvp(self, cu, mvp_lx_flag, amvr_shift, mi):
        """ff_vvc_mvp (vvc_mvs.c:1588)."""
        mi.num_sb_x = mi.num_sb_y = 1
        self.c.set_neighbour_available(cu.x0, cu.y0, cu.cb_width,
                                       cu.cb_height)
        if mi.pred_flag != PF_L1:
            mi.mv[L0][0] = self.mvp(cu, mvp_lx_flag[L0], L0, mi.ref_idx,
                                    amvr_shift)
        if mi.pred_flag != PF_L0:
            mi.mv[L1][0] = self.mvp(cu, mvp_lx_flag[L1], L1, mi.ref_idx,
                                    amvr_shift)

    # --- affine (vvc_mvs.c:842-1404) ---------------------------------------

    def _get_cp_mv(self, lx, x, y, cp_idx):
        v = self.tabs.cp_mv[lx, y >> 2, x >> 2, cp_idx]
        return [int(v[0]), int(v[1])]

    def affine_cps_from_nb(self, cu, x_nb, y_nb, nbw, nbh, lx, num_cps):
        """8.5.5.5 (vvc_mvs.c:844): CPs inherited from an affine neighbour."""
        sps = self.sps
        x0, y0 = cu.x0, cu.y0
        cbw, cbh = cu.cb_width, cu.cb_height
        log2_nbw = nbw.bit_length() - 1
        log2_nbh = nbh.bit_length() - 1
        is_ctb_boundary = ((y_nb + nbh) % sps.ctb_size_y) == 0 and \
            (y_nb + nbh == y0)
        motion_model_idc_nb = 0
        if is_ctb_boundary:
            l = self.get_mvf(x_nb, y_nb + nbh - 1).mv[lx]
            r = self.get_mvf(x_nb + nbw - 1, y_nb + nbh - 1).mv[lx]
        else:
            motion_model_idc_nb = int(self.tabs.mmi[y_nb >> 2, x_nb >> 2])
            l = self._get_cp_mv(lx, x_nb, y_nb, 0)
            r = self._get_cp_mv(lx, x_nb + nbw - 1, y_nb, 1)
        mv_scale_hor = l[0] << 7
        mv_scale_ver = l[1] << 7
        d_hor_x = (r[0] - l[0]) << (7 - log2_nbw)
        d_ver_x = (r[1] - l[1]) << (7 - log2_nbw)
        if not is_ctb_boundary and motion_model_idc_nb == 2:
            lb = self._get_cp_mv(lx, x_nb, y_nb + nbh - 1, 2)
            d_hor_y = (lb[0] - l[0]) << (7 - log2_nbh)
            d_ver_y = (lb[1] - l[1]) << (7 - log2_nbh)
        else:
            d_hor_y = -d_ver_x
            d_ver_y = d_hor_x
        if is_ctb_boundary:
            y_nb = y0
        cps = []
        pts = [(x0, y0), (x0 + cbw, y0)]
        if num_cps == 3:
            pts.append((x0, y0 + cbh))
        for px, py in pts:
            cp = [mv_scale_hor + d_hor_x * (px - x_nb) + d_hor_y * (py - y_nb),
                  mv_scale_ver + d_ver_x * (px - x_nb) + d_ver_y * (py - y_nb)]
            round_mv(cp, 0, 7)
            clip_mv(cp)
            cps.append(cp)
        return cps

    def _affine_neighbour_cb(self, x_nb, y_nb):
        """affine_neighbour_cb (vvc_mvs.c:906)."""
        t = self.tabs
        i = (y_nb >> 2, x_nb >> 2)
        mmi = int(t.mmi[i])
        if mmi:
            return (mmi, int(t.cb_pos_x[0][i]), int(t.cb_pos_y[0][i]),
                    int(t.cb_width[0][i]), int(t.cb_height[0][i]))
        return (0, 0, 0, 0, 0)

    def _affine_merge_candidate(self, cu, x_cand, y_cand, mi):
        mmi, x, y, w, h = self._affine_neighbour_cb(x_cand, y_cand)
        if mmi:
            mvf = self.get_mvf(x, y)
            mi.bcw_idx = mvf.bcw_idx
            mi.pred_flag = mvf.pred_flag
            for i in range(2):
                if mi.pred_flag & (i + 1):
                    cps = self.affine_cps_from_nb(cu, x, y, w, h, i, mmi + 1)
                    for j, cp in enumerate(cps):
                        mi.mv[i][j] = cp
                mi.ref_idx[i] = mvf.ref_idx[i]
            mi.motion_model_idc = mmi
        return mmi

    def _affine_merge_from_nbs(self, cu, nbs, idxs, mi):
        for nb in idxs:
            if self._check_available(cu, nbs[nb], is_mvp=False) and \
                    self._affine_merge_candidate(cu, nbs[nb][0], nbs[nb][1],
                                                 mi):
                return 1
        return 0

    def _derive_corner_mvf(self, cu, nbs, idxs):
        for nb in idxs:
            if self._check_available(cu, nbs[nb], is_mvp=False):
                return self.get_mvf(nbs[nb][0], nbs[nb][1])
        return None

    @staticmethod
    def _compare_pf_ref_idx(a, b, c, lx):
        mask = (lx + 1) & a.pred_flag
        if not (b.pred_flag & mask):
            return 0
        if a.ref_idx[lx] != b.ref_idx[lx]:
            return 0
        if c is not None:
            if not (c.pred_flag & mask):
                return 0
            if a.ref_idx[lx] != c.ref_idx[lx]:
                return 0
        return 1

    def _affine_merge_const(self, which, c, mi, cb_width=0, cb_height=0):
        """affine_merge_const1..6 (vvc_mvs.c:1112-1266).  c is the corner
        MvField tuple appropriate for the variant (None allowed)."""
        if any(x is None for x in c):
            return 0
        mi.pred_flag = 0
        for i in range(2):
            mask = i + 1
            cmp3 = c[2] if len(c) == 3 else None
            if self._compare_pf_ref_idx(c[0], c[1], cmp3, i):
                mi.pred_flag |= mask
                mi.ref_idx[i] = c[0].ref_idx[i]
                if which == 1:      # c0, c1, c2 -> direct 6-param
                    mi.mv[i][0] = list(c[0].mv[i])
                    mi.mv[i][1] = list(c[1].mv[i])
                    mi.mv[i][2] = list(c[2].mv[i])
                elif which == 2:    # c0, c1, c3
                    mi.mv[i][0] = list(c[0].mv[i])
                    mi.mv[i][1] = list(c[1].mv[i])
                    mv = [c[2].mv[i][0] + c[0].mv[i][0] - c[1].mv[i][0],
                          c[2].mv[i][1] + c[0].mv[i][1] - c[1].mv[i][1]]
                    clip_mv(mv)
                    mi.mv[i][2] = mv
                elif which == 3:    # c0, c2, c3
                    mi.mv[i][0] = list(c[0].mv[i])
                    mv = [c[2].mv[i][0] + c[0].mv[i][0] - c[1].mv[i][0],
                          c[2].mv[i][1] + c[0].mv[i][1] - c[1].mv[i][1]]
                    clip_mv(mv)
                    mi.mv[i][1] = mv
                    mi.mv[i][2] = list(c[1].mv[i])
                elif which == 4:    # c1, c2, c3
                    mv = [c[0].mv[i][0] + c[1].mv[i][0] - c[2].mv[i][0],
                          c[0].mv[i][1] + c[1].mv[i][1] - c[2].mv[i][1]]
                    clip_mv(mv)
                    mi.mv[i][0] = mv
                    mi.mv[i][1] = list(c[0].mv[i])
                    mi.mv[i][2] = list(c[1].mv[i])
                elif which == 5:    # c0, c1 -> 4-param
                    mi.mv[i][0] = list(c[0].mv[i])
                    mi.mv[i][1] = list(c[1].mv[i])
                elif which == 6:    # c0, c2 -> 4-param rotated
                    shift = 7 + (cb_width.bit_length() - 1) - \
                        (cb_height.bit_length() - 1)
                    mi.mv[i][0] = list(c[0].mv[i])
                    mv = [(c[0].mv[i][0] << 7) +
                          ((c[1].mv[i][1] - c[0].mv[i][1]) << shift),
                          (c[0].mv[i][1] << 7) -
                          ((c[1].mv[i][0] - c[0].mv[i][0]) << shift)]
                    round_mv(mv, 0, 7)
                    clip_mv(mv)
                    mi.mv[i][1] = mv
        if mi.pred_flag:
            # const1/5/6: bcw set only when BI (left untouched otherwise);
            # const2/3/4: bcw = BI ? c[0].bcw : 0  (vvc_mvs.c:1131-1263)
            if which in (1, 5, 6):
                if mi.pred_flag == PF_BI:
                    mi.bcw_idx = c[0].bcw_idx
            else:
                mi.bcw_idx = c[0].bcw_idx if mi.pred_flag == PF_BI else 0
            mi.motion_model_idc = 2 if which <= 4 else 1
            return 1
        return 0

    def _affine_merge_const_candidates(self, cu, mi, nbs, merge_subblock_idx,
                                       num_cands):
        """8.5.5.6 (vvc_mvs.c:1275)."""
        c0 = self._derive_corner_mvf(cu, nbs, (self.B2, self.B3, self.A2))
        c1 = self._derive_corner_mvf(cu, nbs, (self.B1, self.B0))
        c2 = self._derive_corner_mvf(cu, nbs, (self.A1, self.A0))
        if self.sps.r.sps_6param_affine_enabled_flag:
            if self._affine_merge_const(1, (c0, c1, c2), mi):
                if merge_subblock_idx == num_cands:
                    return 1
                num_cands += 1
            c3 = None
            if self.ph.ph_temporal_mvp_enabled_flag:
                corner3 = MvField()
                mv0 = self.temporal_luma_mv(cu, 0, 0, 0, 0)
                mv1 = self.temporal_luma_mv(cu, 0, 1, 0, 0) \
                    if self.c.sh.is_b else None
                corner3.pred_flag = (mv0 is not None) + \
                    ((mv1 is not None) << 1)
                if mv0 is not None:
                    corner3.mv[0] = mv0
                if mv1 is not None:
                    corner3.mv[1] = mv1
                if corner3.pred_flag:
                    c3 = corner3
            if self._affine_merge_const(2, (c0, c1, c3), mi):
                if merge_subblock_idx == num_cands:
                    return 1
                num_cands += 1
            if self._affine_merge_const(3, (c0, c2, c3), mi):
                if merge_subblock_idx == num_cands:
                    return 1
                num_cands += 1
            if self._affine_merge_const(4, (c1, c2, c3), mi):
                if merge_subblock_idx == num_cands:
                    return 1
                num_cands += 1
        if self._affine_merge_const(5, (c0, c1), mi):
            if merge_subblock_idx == num_cands:
                return 1
            num_cands += 1
        if self._affine_merge_const(6, (c0, c2), mi, cu.cb_width,
                                    cu.cb_height):
            if merge_subblock_idx == num_cands:
                return 1
        return 0

    # --- SbTMVP (vvc_mvs.c:994-1110) ---------------------------------------

    def _sb_clip_location(self, x_ctb, y_ctb, temp_mv, x, y):
        sps, pps = self.sps, self.pps
        ctb = 1 << sps.ctb_log2_size_y
        y = clip(y + temp_mv[1], y_ctb, min(pps.height - 1,
                                            y_ctb + ctb - 1)) & ~7
        x = clip(x + temp_mv[0], x_ctb, min(pps.width - 1,
                                            x_ctb + ctb + 3)) & ~7
        return x, y

    def _sb_temporal_luma_motion(self, x_ctb, y_ctb, temp_mv, x, y):
        """sb_temproal_luma_motion (vvc_mvs.c:1008) -> (pred_flag, mv2)."""
        col = self.c.collocated_ref
        self.col_poc = col.poc
        x, y = self._sb_clip_location(x_ctb, y_ctb, temp_mv, x, y)
        temp_col = col.get_mvf(x, y)
        rpl_col = col.rpl_at(x, y)
        mv0 = self._derive_temporal_col(temp_col, 0, 0, rpl_col, 1)
        pf = int(mv0 is not None)
        mv = [mv0 or [0, 0], [0, 0]]
        if self.c.sh.is_b:
            mv1 = self._derive_temporal_col(temp_col, 0, 1, rpl_col, 1)
            pf |= int(mv1 is not None) << 1
            if mv1 is not None:
                mv[1] = mv1
        return pf, mv

    def sb_temporal_merge_candidate(self, cu, nbs, pu):
        """8.5.5.3 (vvc_mvs.c:1068)."""
        sps, ph = self.sps, self.ph
        mi = pu.mi
        ctb_log2 = sps.ctb_log2_size_y
        x0, y0 = cu.x0, cu.y0
        x_ctb = (x0 >> ctb_log2) << ctb_log2
        y_ctb = (y0 >> ctb_log2) << ctb_log2
        if not ph.ph_temporal_mvp_enabled_flag or \
                not sps.r.sps_sbtmvp_enabled_flag or \
                (cu.cb_width < 8 and cu.cb_height < 8) or \
                self.c.collocated_ref is None:
            return 0
        mi.num_sb_x = cu.cb_width >> 3
        mi.num_sb_y = cu.cb_height >> 3
        a1 = self._derive_corner_mvf(cu, nbs, (self.A1,))
        # sb_temporal_luma_motion_data (vvc_mvs.c:1030)
        col = self.c.collocated_ref
        rpl = self.c.rpl
        temp_mv = [0, 0]
        if a1 is not None:
            if (a1.pred_flag & PF_L0) and \
                    col.poc == rpl[0].poc_list[a1.ref_idx[0]]:
                temp_mv = list(a1.mv[0])
            elif (a1.pred_flag & PF_L1) and \
                    col.poc == rpl[1].poc_list[a1.ref_idx[1]]:
                temp_mv = list(a1.mv[1])
            round_mv(temp_mv, 0, 4)
        ctr_pf, ctr_mv = self._sb_temporal_luma_motion(
            x_ctb, y_ctb, temp_mv, x0 + cu.cb_width // 2,
            y0 + cu.cb_height // 2)
        if not ctr_pf:
            return 0
        sbw = cu.cb_width // mi.num_sb_x
        sbh = cu.cb_height // mi.num_sb_y
        for sby in range(mi.num_sb_y):
            for sbx in range(mi.num_sb_x):
                x = x0 + sbx * sbw
                y = y0 + sby * sbh
                pf, mv = self._sb_temporal_luma_motion(
                    x_ctb, y_ctb, temp_mv, x + sbw // 2, y + sbh // 2)
                f = MvField()
                if not pf:
                    pf, mv = ctr_pf, ctr_mv
                f.pred_flag = pf
                f.mv = [list(mv[0]), list(mv[1])]
                self.set_mvf(x, y, sbw, sbh, f)
        return 1

    def sb_mv_merge_mode(self, cu, merge_subblock_idx, pu):
        """8.5.5.2 (vvc_mvs.c:1346); returns 1 if SbCol was selected (MV
        grid already written)."""
        sps = self.sps
        mi = pu.mi
        self.c.set_neighbour_available(cu.x0, cu.y0, cu.cb_width,
                                       cu.cb_height)
        nbs = self._neighbours(cu)
        num_cands = 0
        if self.sb_temporal_merge_candidate(cu, nbs, pu):
            if merge_subblock_idx == num_cands:
                return 1
            num_cands += 1
        pu.inter_affine_flag = 1
        mi.num_sb_x = cu.cb_width >> 2
        mi.num_sb_y = cu.cb_height >> 2
        if sps.r.sps_affine_enabled_flag:
            if self._affine_merge_from_nbs(cu, nbs, (self.A0, self.A1), mi):
                if merge_subblock_idx == num_cands:
                    return 0
                num_cands += 1
            if self._affine_merge_from_nbs(cu, nbs,
                                           (self.B0, self.B1, self.B2), mi):
                if merge_subblock_idx == num_cands:
                    return 0
                num_cands += 1
            if self._affine_merge_const_candidates(cu, mi, nbs,
                                                   merge_subblock_idx,
                                                   num_cands):
                return 0
        # zero affine (vvc_mvs.c:1268)
        mi.pred_flag = PF_L0 + (self.c.sh.is_b << 1)
        mi.bcw_idx = 0
        mi.hpel_if_idx = 0
        mi.ref_idx = [0, 0]
        mi.mv = [[[0, 0], [0, 0], [0, 0]], [[0, 0], [0, 0], [0, 0]]]
        mi.motion_model_idc = 1
        mi.num_sb_x = cu.cb_width >> 2
        mi.num_sb_y = cu.cb_height >> 2
        return 0

    # --- subblock MV array storage + PROF (vvc_mvs.c:283-448) --------------

    @staticmethod
    def _is_fallback(sp, pred_flag):
        a = 4 * (2048 + sp["d_hor_x"])
        b = 4 * sp["d_hor_y"]
        c = 4 * (2048 + sp["d_ver_y"])
        d = 4 * sp["d_ver_x"]
        if pred_flag == PF_BI:
            max_w4 = max(0, a, b, a + b)
            min_w4 = min(0, a, b, a + b)
            max_h4 = max(0, c, d, c + d)
            min_h4 = min(0, c, d, c + d)
            bx_w = ((max_w4 - min_w4) >> 11) + 9
            bx_h = ((max_h4 - min_h4) >> 11) + 9
            return bx_w * bx_h > 225
        bx_wxh = (abs(a) >> 11) + 9
        bx_hxh = (abs(d) >> 11) + 9
        bx_wxv = (abs(b) >> 11) + 9
        bx_hxv = (abs(c) >> 11) + 9
        return not (bx_wxh * bx_hxh <= 165 and bx_wxv * bx_hxv <= 165)

    MAX_CU_DEPTH = 7

    def _init_subblock_params(self, mi, cb_width, cb_height, lx):
        log2_cbw = cb_width.bit_length() - 1
        log2_cbh = cb_height.bit_length() - 1
        cp = mi.mv[lx]
        num_cp = mi.motion_model_idc + 1
        D = self.MAX_CU_DEPTH
        sp = {
            "d_hor_x": (cp[1][0] - cp[0][0]) << (D - log2_cbw),
            "d_ver_x": (cp[1][1] - cp[0][1]) << (D - log2_cbw),
            "mv_scale_hor": cp[0][0] << D,
            "mv_scale_ver": cp[0][1] << D,
        }
        if num_cp == 3:
            sp["d_hor_y"] = (cp[2][0] - cp[0][0]) << (D - log2_cbh)
            sp["d_ver_y"] = (cp[2][1] - cp[0][1]) << (D - log2_cbh)
        else:
            sp["d_hor_y"] = -sp["d_ver_x"]
            sp["d_ver_y"] = sp["d_hor_x"]
        sp["is_fallback"] = self._is_fallback(sp, mi.pred_flag)
        return sp

    def _derive_subblock_diff_mvs(self, pu, sp, lx):
        """derive_subblock_diff_mvs + cb_prof_flag (vvc_mvs.c:283/361)."""
        mi = pu.mi
        prof = not self.ph.ph_prof_disabled_flag and not sp["is_fallback"]
        if prof and mi.motion_model_idc == 1 and \
                mi.mv[lx][0] == mi.mv[lx][1]:
            prof = False
        if prof and mi.motion_model_idc == 2 and \
                mi.mv[lx][0] == mi.mv[lx][1] and mi.mv[lx][0] == mi.mv[lx][2]:
            prof = False
        pu.cb_prof_flag[lx] = int(prof)
        if prof:
            dmv_limit = 1 << 5
            pos_off_x = 6 * (sp["d_hor_x"] + sp["d_hor_y"])
            pos_off_y = 6 * (sp["d_ver_x"] + sp["d_ver_y"])
            dx = np.zeros(16, dtype=np.int32)
            dy = np.zeros(16, dtype=np.int32)
            for x in range(4):
                for y in range(4):
                    d = [x * (sp["d_hor_x"] << 2) + y * (sp["d_hor_y"] << 2) -
                         pos_off_x,
                         x * (sp["d_ver_x"] << 2) + y * (sp["d_ver_y"] << 2) -
                         pos_off_y]
                    round_mv(d, 0, 8)
                    dx[4 * y + x] = clip(d[0], -dmv_limit + 1, dmv_limit - 1)
                    dy[4 * y + x] = clip(d[1], -dmv_limit + 1, dmv_limit - 1)
            pu.diff_mv_x[lx] = dx
            pu.diff_mv_y[lx] = dy

    def _store_cp_mv(self, cu, mi, lx):
        num_cp = mi.motion_model_idc + 1
        t = self.tabs
        x0, y0 = cu.x0 >> 2, cu.y0 >> 2
        x1 = (cu.x0 + cu.cb_width) >> 2
        y1 = (cu.y0 + cu.cb_height) >> 2
        for j in range(num_cp):
            t.cp_mv[lx, y0:y1, x0:x1, j, 0] = mi.mv[lx][j][0]
            t.cp_mv[lx, y0:y1, x0:x1, j, 1] = mi.mv[lx][j][1]

    def store_sb_mvs(self, cu, pu):
        """ff_vvc_store_sb_mvs (vvc_mvs.c:402)."""
        mi = pu.mi
        sbw = cu.cb_width // mi.num_sb_x
        sbh = cu.cb_height // mi.num_sb_y
        params = [None, None]
        mvf = MvField()
        mvf.pred_flag = mi.pred_flag
        mvf.bcw_idx = mi.bcw_idx
        mvf.hpel_if_idx = mi.hpel_if_idx
        for i in range(2):
            if mi.pred_flag & (i + 1):
                self._store_cp_mv(cu, mi, i)
                params[i] = self._init_subblock_params(
                    mi, cu.cb_width, cu.cb_height, i)
                self._derive_subblock_diff_mvs(pu, params[i], i)
                mvf.ref_idx[i] = mi.ref_idx[i]
        D = self.MAX_CU_DEPTH
        for sby in range(mi.num_sb_y):
            for sbx in range(mi.num_sb_x):
                x0 = cu.x0 + sbx * sbw
                y0 = cu.y0 + sby * sbh
                for i in range(2):
                    if mi.pred_flag & (i + 1):
                        sp = params[i]
                        x_pos = (cu.cb_width >> 1) if sp["is_fallback"] \
                            else (2 + (sbx << 2))
                        y_pos = (cu.cb_height >> 1) if sp["is_fallback"] \
                            else (2 + (sby << 2))
                        mv = [sp["mv_scale_hor"] + sp["d_hor_x"] * x_pos +
                              sp["d_hor_y"] * y_pos,
                              sp["mv_scale_ver"] + sp["d_ver_x"] * x_pos +
                              sp["d_ver_y"] * y_pos]
                        round_mv(mv, 0, D)
                        clip_mv(mv)
                        mvf.mv[i] = mv
                self.set_mvf(x0, y0, sbw, sbh, mvf)

    # --- affine AMVP (vvc_mvs.c:1598-1737) ---------------------------------

    def _affine_mvp_candidate(self, x_cand, y_cand, lx, ref_idx, num_cp, cu):
        mmi, x_nb, y_nb, nbw, nbh = self._affine_neighbour_cb(x_cand, y_cand)
        if not mmi:
            return None
        mvf = self.get_mvf(x_nb, y_nb)
        rpl = self.c.rpl
        poc = rpl[lx].poc_list[ref_idx[lx]]
        if (mvf.pred_flag & (lx + 1)) and \
                rpl[lx].poc_list[mvf.ref_idx[lx]] == poc:
            return self.affine_cps_from_nb(cu, x_nb, y_nb, nbw, nbh, lx,
                                           num_cp)
        ly = 1 - lx
        if (mvf.pred_flag & (ly + 1)) and \
                rpl[ly].poc_list[mvf.ref_idx[ly]] == poc:
            return self.affine_cps_from_nb(cu, x_nb, y_nb, nbw, nbh, ly,
                                           num_cp)
        return None

    def _affine_mvp_from_nbs(self, cu, nbs, idxs, lx, ref_idx, amvr_shift,
                             num_cp):
        for nb in idxs:
            if self._check_available(cu, nbs[nb], is_mvp=True):
                cps = self._affine_mvp_candidate(nbs[nb][0], nbs[nb][1], lx,
                                                 ref_idx, num_cp, cu)
                if cps is not None:
                    for cp in cps:
                        round_mv(cp, amvr_shift, amvr_shift)
                    return cps
        return None

    def _affine_mvp_constructed_cp(self, cu, nbs, idxs, lx, ref_idx_val,
                                   amvr_shift):
        rpl = self.c.rpl
        poc = rpl[lx].poc_list[ref_idx_val]
        for nb in idxs:
            if self._check_available(cu, nbs[nb], is_mvp=True):
                mvf = self.get_mvf(nbs[nb][0], nbs[nb][1])
                cp = None
                if (mvf.pred_flag & (lx + 1)) and \
                        rpl[lx].poc_list[mvf.ref_idx[lx]] == poc:
                    cp = list(mvf.mv[lx])
                else:
                    ly = 1 - lx
                    if (mvf.pred_flag & (ly + 1)) and \
                            rpl[ly].poc_list[mvf.ref_idx[ly]] == poc:
                        cp = list(mvf.mv[ly])
                if cp is not None:
                    round_mv(cp, amvr_shift, amvr_shift)
                    return cp
        return None

    def affine_mvp(self, cu, mvp_lx_flag, lx, ref_idx, amvr_shift,
                   motion_model_idc):
        """8.5.5.7 (vvc_mvs.c:1662) -> list of num_cp CPs."""
        num_cp = motion_model_idc + 1
        nbs = self._neighbours(cu)
        num_cands = 0
        cps = self._affine_mvp_from_nbs(cu, nbs, (self.A0, self.A1), lx,
                                        ref_idx, amvr_shift, num_cp)
        if cps is not None:
            if mvp_lx_flag == num_cands:
                return cps
            num_cands += 1
        cps = self._affine_mvp_from_nbs(cu, nbs, (self.B0, self.B1, self.B2),
                                        lx, ref_idx, amvr_shift, num_cp)
        if cps is not None:
            if mvp_lx_flag == num_cands:
                return cps
            num_cands += 1
        # Const1 (vvc_mvs.c:1641)
        cp0 = self._affine_mvp_constructed_cp(
            cu, nbs, (self.B2, self.B3, self.A2), lx, ref_idx[lx], amvr_shift)
        cp1 = self._affine_mvp_constructed_cp(
            cu, nbs, (self.B1, self.B0), lx, ref_idx[lx], amvr_shift)
        cp2 = self._affine_mvp_constructed_cp(
            cu, nbs, (self.A1, self.A0), lx, ref_idx[lx], amvr_shift)
        available = [cp0 is not None, cp1 is not None, cp2 is not None]
        cps3 = [cp0 or [0, 0], cp1 or [0, 0], cp2 or [0, 0]]
        if available[0] and available[1]:
            if available[2] or motion_model_idc == 1:
                if mvp_lx_flag == num_cands:
                    return [list(c) for c in cps3[:num_cp]]
                num_cands += 1
        # Const2: single available corner replicated
        for i in (2, 1, 0):
            if available[i]:
                if mvp_lx_flag == num_cands:
                    return [list(cps3[i]) for _ in range(num_cp)]
                num_cands += 1
        tmv = self.temporal_luma_mv(cu, ref_idx[lx], lx, 1, 0)
        if tmv is not None:
            if mvp_lx_flag == num_cands:
                round_mv(tmv, amvr_shift, amvr_shift)
                return [list(tmv) for _ in range(num_cp)]
            num_cands += 1
        return [[0, 0] for _ in range(num_cp)]

    def ff_affine_mvp(self, cu, mvp_lx_flag, amvr_shift, mi):
        """ff_vvc_affine_mvp (vvc_mvs.c:1725)."""
        mi.num_sb_x = cu.cb_width >> 2
        mi.num_sb_y = cu.cb_height >> 2
        self.c.set_neighbour_available(cu.x0, cu.y0, cu.cb_width,
                                       cu.cb_height)
        if mi.pred_flag != PF_L1:
            cps = self.affine_mvp(cu, mvp_lx_flag[L0], L0, mi.ref_idx,
                                  amvr_shift, mi.motion_model_idc)
            for j, cp in enumerate(cps):
                mi.mv[L0][j] = cp
        if mi.pred_flag != PF_L0:
            cps = self.affine_mvp(cu, mvp_lx_flag[L1], L1, mi.ref_idx,
                                  amvr_shift, mi.motion_model_idc)
            for j, cp in enumerate(cps):
                mi.mv[L1][j] = cp

    # --- HMVP update (vvc_mvs.c:1762) --------------------------------------

    def update_hmvp(self, cu):
        pl = self.sps.log2_parallel_merge_level
        x_br, y_br = cu.x0 + cu.cb_width, cu.y0 + cu.cb_height
        if not ((x_br >> pl) > (cu.x0 >> pl) and
                (y_br >> pl) > (cu.y0 >> pl)):
            return
        mvf = self.get_mvf(cu.x0, cu.y0)
        hmvp = self.c.hmvp
        for i, h in enumerate(hmvp):
            if same_mv_ref(mvf, h):
                del hmvp[i]
                break
        else:
            if len(hmvp) == MAX_NUM_HMVP_CANDS:
                del hmvp[0]
        hmvp.append(mvf)


def mv_merge_refine_pred_flag(mvf: MvField, width, height):
    """mv_merge_refine_pred_flag (vvc_ctu.c:1308)."""
    if mvf.pred_flag == PF_BI and width + height == 12:
        mvf.pred_flag = PF_L0
        mvf.bcw_idx = 0
