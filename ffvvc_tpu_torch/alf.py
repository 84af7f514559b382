"""ALF / CC-ALF — golden whole-frame pass (H.266 8.8.5).

Reference analogue: libavcodec/vvc/vvc_filter.c
(ff_vvc_alf_filter :1254-1320, alf_prepare_buffer :1105) and the
classification/filter kernels of vvc_filter_template.c:38-410; coefficient
derivation per vvc_ps.c:803-889 (alf_luma/chroma/cc).

The reference filters per CTU from a padded buffer whose borders come from
pre-ALF line buffers; functionally that is a whole-frame pass over a
snapshot of the post-SAO planes with clamp-replication at unfilterable
(picture/slice/tile) boundaries — also the natural TPU formulation.
"""
from __future__ import annotations

import numpy as np

from .ops import data as D

ALF_NUM_FILTERS_LUMA = 25
ALF_NUM_COEFF_LUMA = 12
ALF_NUM_COEFF_CHROMA = 6
ALF_NUM_COEFF_CC = 7
ALF_BORDER_LUMA = 3
ALF_BORDER_CHROMA = 2
ALF_VB_POS_ABOVE_LUMA = 4
ALF_VB_POS_ABOVE_CHROMA = 2

# transpose index -> coefficient permutation (vvc_filter_template.c:386)
_TRANSPOSE_IDX = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11),
    (9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6),
    (0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11),
    (9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6),
)
_ARG_VAR = (0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4)


class VVCALF:
    """Derived ALF coefficient sets (reference VVCALF, alf_derive
    vvc_ps.c:871)."""

    def __init__(self, aps):
        self.luma_coeff = np.zeros((ALF_NUM_FILTERS_LUMA,
                                    ALF_NUM_COEFF_LUMA), dtype=np.int64)
        self.luma_clip_idx = np.zeros((ALF_NUM_FILTERS_LUMA,
                                       ALF_NUM_COEFF_LUMA), dtype=np.int64)
        if aps.alf_luma_filter_signal_flag:
            for i in range(ALF_NUM_FILTERS_LUMA):
                ref = aps.alf_luma_coeff_delta_idx[i]
                for j in range(ALF_NUM_COEFF_LUMA):
                    a = aps.alf_luma_coeff_abs[ref][j]
                    s = aps.alf_luma_coeff_sign[ref][j]
                    self.luma_coeff[i, j] = (1 - 2 * s) * a
                    self.luma_clip_idx[i, j] = aps.alf_luma_clip_idx[ref][j]
        self.num_chroma_filters = aps.alf_chroma_num_alt_filters_minus1 + 1
        na = self.num_chroma_filters
        self.chroma_coeff = np.zeros((na, ALF_NUM_COEFF_CHROMA),
                                     dtype=np.int64)
        self.chroma_clip_idx = np.zeros((na, ALF_NUM_COEFF_CHROMA),
                                        dtype=np.int64)
        if aps.alf_chroma_filter_signal_flag:
            for i in range(na):
                for j in range(ALF_NUM_COEFF_CHROMA):
                    a = aps.alf_chroma_coeff_abs[i][j]
                    s = aps.alf_chroma_coeff_sign[i][j]
                    self.chroma_coeff[i, j] = (1 - 2 * s) * a
                    self.chroma_clip_idx[i, j] = aps.alf_chroma_clip_idx[i][j]
        self.num_cc_filters = [aps.alf_cc_cb_filters_signalled_minus1 + 1,
                               aps.alf_cc_cr_filters_signalled_minus1 + 1]
        self.cc_coeff = [np.zeros((self.num_cc_filters[i], ALF_NUM_COEFF_CC),
                                  dtype=np.int64) for i in range(2)]
        for idx, (sig, ab, sg) in enumerate((
                (aps.alf_cc_cb_filter_signal_flag,
                 aps.alf_cc_cb_mapped_coeff_abs, aps.alf_cc_cb_coeff_sign),
                (aps.alf_cc_cr_filter_signal_flag,
                 aps.alf_cc_cr_mapped_coeff_abs, aps.alf_cc_cr_coeff_sign))):
            if sig:
                for i in range(self.num_cc_filters[idx]):
                    for j in range(ALF_NUM_COEFF_CC):
                        c = ab[i][j]
                        if c:
                            c = (1 - 2 * sg[i][j]) * (1 << (c - 1))
                        self.cc_coeff[idx][i, j] = c


class AlfFilter:
    def __init__(self, sps, pps, tabs, fb, sh_list, alf_list):
        self.sps = sps
        self.pps = pps
        self.tabs = tabs
        self.fb = fb
        self.sh_list = sh_list    # derived SH per slice_idx
        self.alf_list = alf_list  # aps_id -> VVCALF

    def alf_frame(self):
        sps, pps, tabs = self.sps, self.pps, self.tabs
        if not sps.r.sps_alf_enabled_flag:
            return
        if not tabs.alf_ctb_flag.any() and not tabs.alf_cc_idc.any():
            return
        pre = [p.copy() for p in self.fb.planes]
        for ry in range(pps.ctb_height):
            for rx in range(pps.ctb_width):
                self._alf_ctb(rx, ry, pre)

    # --- padded window ------------------------------------------------------

    def _edges(self, rx, ry):
        pps, tabs = self.pps, self.tabs
        edges = [rx == 0, ry == 0, rx == pps.ctb_width - 1,
                 ry == pps.ctb_height - 1]
        if not pps.r.pps_loop_filter_across_tiles_enabled_flag:
            edges[0] = edges[0] or pps.ctb_to_col_bd[rx] == rx
            edges[1] = edges[1] or pps.ctb_to_row_bd[ry] == ry
            edges[2] = edges[2] or \
                pps.ctb_to_col_bd[rx] != pps.ctb_to_col_bd[rx + 1]
            edges[3] = edges[3] or \
                pps.ctb_to_row_bd[ry] != pps.ctb_to_row_bd[ry + 1]
        if not pps.r.pps_loop_filter_across_slices_enabled_flag:
            si = tabs.slice_idx
            edges[0] = edges[0] or (rx > 0 and
                                    si[ry, rx] != si[ry, rx - 1])
            edges[1] = edges[1] or (ry > 0 and
                                    si[ry, rx] != si[ry - 1, rx])
            edges[2] = edges[2] or (rx + 1 < pps.ctb_width and
                                    si[ry, rx] != si[ry, rx + 1])
            edges[3] = edges[3] or (ry + 1 < pps.ctb_height and
                                    si[ry + 1, rx] != si[ry, rx])
        return edges

    @staticmethod
    def _window(plane, x0, y0, w, h, b, edges):
        """(h+2b, w+2b) window; clamp-replication at unfilterable edges
        (alf_prepare_buffer, vvc_filter.c:1105)."""
        H, W = plane.shape
        ys = np.arange(y0 - b, y0 + h + b)
        xs = np.arange(x0 - b, x0 + w + b)
        ys = np.clip(ys, y0 if edges[1] else 0,
                     (y0 + h - 1) if edges[3] else H - 1)
        xs = np.clip(xs, x0 if edges[0] else 0,
                     (x0 + w - 1) if edges[2] else W - 1)
        return plane[np.ix_(ys, xs)].astype(np.int64)

    # --- classification (vvc_filter_template.c:295-382) ---------------------

    def _classify(self, win, w, h, vb_pos):
        bd = self.sps.bit_depth
        gh = (h + 4) // 2
        gw = (w + 4) // 2
        grad = np.zeros((gh, gw, 4), dtype=np.int64)
        for iy, y in enumerate(range(0, h + 4, 2)):
            r0, r1, r2, r3 = y, y + 1, y + 2, y + 3
            if y == vb_pos:
                r3 = r2
            elif y == vb_pos + 2:
                r0 = r1
            row0, row1, row2, row3 = win[r0], win[r1], win[r2], win[r3]
            for ix, x in enumerate(range(0, w + 4, 2)):
                c = x + 1
                v0 = int(row1[c]) << 1
                v1 = int(row2[c + 1]) << 1
                grad[iy, ix, 0] = abs(v0 - row0[c] - row2[c]) + \
                    abs(v1 - row1[c + 1] - row3[c + 1])
                grad[iy, ix, 1] = abs(v0 - row1[c - 1] - row1[c + 1]) + \
                    abs(v1 - row2[c] - row2[c + 2])
                grad[iy, ix, 2] = abs(v0 - row0[c - 1] - row2[c + 1]) + \
                    abs(v1 - row1[c] - row3[c + 2])
                grad[iy, ix, 3] = abs(v0 - row0[c + 1] - row2[c - 1]) + \
                    abs(v1 - row1[c + 2] - row3[c])
        nby, nbx = h // 4, w // 4
        class_idx = np.zeros((nby, nbx), dtype=np.int64)
        transpose_idx = np.zeros((nby, nbx), dtype=np.int64)
        for by in range(nby):
            y = by * 4
            start, end, ac = 0, 4, 2
            if y + 4 == vb_pos:
                end, ac = 3, 3
            elif y == vb_pos:
                start, ac = 1, 3
            for bx in range(nbx):
                s = grad[by * 2 + start:by * 2 + end,
                         bx * 2:bx * 2 + 4].sum(axis=(0, 1))
                sv, sh_, d0, d1 = int(s[0]), int(s[1]), int(s[2]), int(s[3])
                dir_hv = int(sv <= sh_)
                hv1, hv0 = max(sv, sh_), min(sv, sh_)
                dir_d = int(d0 <= d1)
                dd1, dd0 = max(d0, d1), min(d0, d1)
                dir1 = int(dd1 * hv0 <= hv1 * dd0)
                hvd1 = hv1 if dir1 else dd1
                hvd0 = hv0 if dir1 else dd0
                sum_hv = sh_ + sv
                ci = _ARG_VAR[min(max((sum_hv * ac) >> (bd - 1), 0), 15)]
                if hvd1 * 2 > 9 * hvd0:
                    ci += ((dir1 << 1) + 2) * 5
                elif hvd1 > 2 * hvd0:
                    ci += ((dir1 << 1) + 1) * 5
                class_idx[by, bx] = ci
                transpose_idx[by, bx] = dir_d * 2 + dir_hv
        return class_idx, transpose_idx

    # --- filters ------------------------------------------------------------

    @staticmethod
    def _clip_pair(curr, v0, v1, clip):
        return np.clip(v0 - curr, -clip, clip) + np.clip(v1 - curr, -clip,
                                                         clip)

    def _filter_luma(self, dst, win, w, h, vb_pos, coeff, clip):
        """alf_filter_luma (vvc_filter_template.c:43); coeff/clip are
        per-4x4-block [nby, nbx, 12]."""
        b = ALF_BORDER_LUMA
        pix_max = (1 << self.sps.bit_depth) - 1
        for y in range(h):
            # row offsets with virtual-boundary substitution
            o = {0: 0, 1: 1, 2: -1, 3: 2, 4: -2, 5: 3, 6: -3}
            if vb_pos - 4 <= y < vb_pos:
                if y == vb_pos - 1:
                    o[1] = 0
                    o[2] = 0
                if y >= vb_pos - 2:
                    o[3] = o[1]
                    o[4] = o[2]
                if y >= vb_pos - 3:
                    o[5] = o[3]
                    o[6] = o[4]
            elif vb_pos <= y <= vb_pos + 3:
                if y == vb_pos:
                    o[2] = 0
                    o[1] = 0
                if y <= vb_pos + 1:
                    o[4] = o[2]
                    o[3] = o[1]
                if y <= vb_pos + 2:
                    o[6] = o[4]
                    o[5] = o[3]
            near_vb = vb_pos - 1 <= y <= vb_pos
            rows = {k: win[b + y + v] for k, v in o.items()}
            cur = rows[0][b:b + w]
            cf = coeff[y // 4]     # [nbx, 12]
            cl = clip[y // 4]
            # expand per-pixel coeffs from per-block
            cfp = np.repeat(cf, 4, axis=0)[:w].T   # [12, w]
            clp = np.repeat(cl, 4, axis=0)[:w].T
            taps = (
                (rows[5], 0, rows[6], 0), (rows[3], 1, rows[4], -1),
                (rows[3], 0, rows[4], 0), (rows[3], -1, rows[4], 1),
                (rows[1], 2, rows[2], -2), (rows[1], 1, rows[2], -1),
                (rows[1], 0, rows[2], 0), (rows[1], -1, rows[2], 1),
                (rows[1], -2, rows[2], 2), (rows[0], 3, rows[0], -3),
                (rows[0], 2, rows[0], -2), (rows[0], 1, rows[0], -1))
            acc = np.zeros(w, dtype=np.int64)
            for k, (ra, da, rb, db) in enumerate(taps):
                acc += cfp[k] * self._clip_pair(
                    cur, ra[b + da:b + da + w], rb[b + db:b + db + w],
                    clp[k])
            if not near_vb:
                acc = (acc + 64) >> 7
            else:
                acc = (acc + (1 << 9)) >> 10
            dst[y] = np.clip(acc + cur, 0, pix_max)

    def _filter_chroma(self, dst, win, w, h, vb_pos, coeff, clip):
        b = ALF_BORDER_CHROMA
        pix_max = (1 << self.sps.bit_depth) - 1
        for y in range(h):
            o = {0: 0, 1: 1, 2: -1, 3: 2, 4: -2, 5: 3, 6: -3}
            if vb_pos - 2 <= y < vb_pos:
                if y == vb_pos - 1:
                    o[1] = 0
                    o[2] = 0
                if y >= vb_pos - 2:
                    o[3] = o[1]
                    o[4] = o[2]
                if y >= vb_pos - 3:
                    o[5] = o[3]
                    o[6] = o[4]
            elif vb_pos <= y <= vb_pos + 1:
                if y == vb_pos:
                    o[2] = 0
                    o[1] = 0
                if y <= vb_pos + 1:
                    o[4] = o[2]
                    o[3] = o[1]
                if y <= vb_pos + 2:
                    o[6] = o[4]
                    o[5] = o[3]
            near_vb = vb_pos - 1 <= y <= vb_pos
            # chroma's 5x5 diamond only reads row offsets 0..4 (max |dy| 2);
            # keys 5/6 (dy +-3) would overflow the border-2 window on a
            # short last CTB row, where no VB substitution clamps them
            rows = {k: win[b + y + o[k]] for k in range(5)}
            cur = rows[0][b:b + w]
            taps = ((rows[3], 0, rows[4], 0), (rows[1], 1, rows[2], -1),
                    (rows[1], 0, rows[2], 0), (rows[1], -1, rows[2], 1),
                    (rows[0], 2, rows[0], -2), (rows[0], 1, rows[0], -1))
            acc = np.zeros(w, dtype=np.int64)
            for k, (ra, da, rb, db) in enumerate(taps):
                acc += int(coeff[k]) * self._clip_pair(
                    cur, ra[b + da:b + da + w], rb[b + db:b + db + w],
                    int(clip[k]))
            if not near_vb:
                acc = (acc + 64) >> 7
            else:
                acc = (acc + (1 << 9)) >> 10
            dst[y] = np.clip(acc + cur, 0, pix_max)

    def _filter_cc(self, dst, luma_win, w, h, hs, vs, coeff, vb_pos):
        """alf_filter_cc (vvc_filter_template.c:225); luma_win has the luma
        ALF border (3)."""
        b = ALF_BORDER_LUMA
        bd = self.sps.bit_depth
        pix_max = (1 << bd) - 1
        half = 1 << (bd - 1)
        out = dst.astype(np.int64)
        for y in range(h):
            pos = y << vs
            if not vs and (pos == vb_pos or pos == vb_pos + 1):
                continue
            r0, r1, r2, r3 = pos - 1, pos, pos + 1, pos + 2
            if pos == vb_pos - 2 or pos == vb_pos + 1:
                r3 = r2
            elif pos == vb_pos - 1 or pos == vb_pos:
                r3 = r2 = r0 = r1
            xs = (np.arange(w) << hs) + b
            s0 = luma_win[b + r0]
            s1 = luma_win[b + r1]
            s2 = luma_win[b + r2]
            s3 = luma_win[b + r3]
            cur = s1[xs]
            acc = (int(coeff[0]) * (s0[xs] - cur) +
                   int(coeff[1]) * (s1[xs - 1] - cur) +
                   int(coeff[2]) * (s1[xs + 1] - cur) +
                   int(coeff[3]) * (s2[xs - 1] - cur) +
                   int(coeff[4]) * (s2[xs] - cur) +
                   int(coeff[5]) * (s2[xs + 1] - cur) +
                   int(coeff[6]) * (s3[xs] - cur))
            acc = np.clip((acc + 64) >> 7, -half, half - 1)
            out[y] = np.clip(out[y] + acc, 0, pix_max)
        dst[:] = out

    # --- per-CTU driver (ff_vvc_alf_filter, vvc_filter.c:1254) -------------

    def _alf_ctb(self, rx, ry, pre):
        sps, pps, tabs = self.sps, self.pps, self.tabs
        rs = ry * pps.ctb_width + rx
        rsh = self.sh_list[int(tabs.slice_idx[ry, rx])].r
        edges = self._edges(rx, ry)
        nc = 3 if sps.chroma_format_idc else 1
        t = D.tables()
        luma_win = None
        for c in range(nc):
            hs, vs = sps.hshift[c], sps.vshift[c]
            x0 = (rx << sps.ctb_log2_size_y) >> hs
            y0 = (ry << sps.ctb_log2_size_y) >> vs
            w = min((pps.width >> hs) - x0, sps.ctb_size_y >> hs)
            h = min((pps.height >> vs) - y0, sps.ctb_size_y >> vs)
            ctb_size_v = sps.ctb_size_y >> vs
            flag = int(tabs.alf_ctb_flag[rs, c])
            cc_idc = int(tabs.alf_cc_idc[rs, c - 1]) if c else 0
            if c == 0 and (flag or tabs.alf_cc_idc[rs].any()):
                luma_win = self._window(pre[0], x0, y0, w, h,
                                        ALF_BORDER_LUMA, edges)
            if not flag and not cc_idc:
                continue
            dst = self.fb.planes[c][y0:y0 + h, x0:x0 + w]
            if flag and c == 0:
                vb_pos = ctb_size_v - ALF_VB_POS_ABOVE_LUMA
                ci, ti = self._classify(luma_win, w, h, vb_pos)
                if tabs.alf_fixed[rs]:
                    coeff_set = t["alf_fix_filt_coeff"].astype(np.int64)
                    clip_idx_set = np.zeros((ALF_NUM_FILTERS_LUMA,
                                             ALF_NUM_COEFF_LUMA), np.int64)
                    class_to_filt = t["alf_class_to_filt_map"][
                        int(tabs.alf_filt_idx[rs])]
                else:
                    aps_alf = self.alf_list[int(tabs.alf_aps_id[rs, 0])]
                    coeff_set = aps_alf.luma_coeff
                    clip_idx_set = aps_alf.luma_clip_idx
                    class_to_filt = t["alf_aps_class_to_filt_map"]
                clip_set = [1 << sps.bit_depth, 1 << (sps.bit_depth - 3),
                            1 << (sps.bit_depth - 5),
                            1 << (sps.bit_depth - 7)]
                nby, nbx = ci.shape
                coeff = np.zeros((nby, nbx, 12), dtype=np.int64)
                clip = np.zeros((nby, nbx, 12), dtype=np.int64)
                for by in range(nby):
                    for bx in range(nbx):
                        perm = _TRANSPOSE_IDX[int(ti[by, bx])]
                        src_c = coeff_set[int(class_to_filt[ci[by, bx]])]
                        src_cl = clip_idx_set[int(ci[by, bx])] \
                            if not tabs.alf_fixed[rs] else \
                            clip_idx_set[0]
                        for j in range(12):
                            coeff[by, bx, j] = src_c[perm[j]]
                            clip[by, bx, j] = clip_set[int(src_cl[perm[j]])]
                self._filter_luma(dst, luma_win, w, h, vb_pos, coeff, clip)
            elif flag:
                aps_alf = self.alf_list[rsh.sh_alf_aps_id_chroma]
                alt = int(tabs.alf_alt_idx[rs, c - 1])
                win = self._window(pre[c], x0, y0, w, h, ALF_BORDER_CHROMA,
                                   edges)
                off = (0, 3, 5, 7)
                clip = [1 << (sps.bit_depth -
                              off[int(aps_alf.chroma_clip_idx[alt][i])])
                        for i in range(ALF_NUM_COEFF_CHROMA)]
                vb_pos = ctb_size_v - ALF_VB_POS_ABOVE_CHROMA
                self._filter_chroma(dst, win, w, h, vb_pos,
                                    aps_alf.chroma_coeff[alt], clip)
            if c and cc_idc:
                cc_aps_id = rsh.sh_alf_cc_cb_aps_id if c == 1 else \
                    rsh.sh_alf_cc_cr_aps_id
                aps_alf = self.alf_list.get(cc_aps_id)
                if aps_alf is not None:
                    vb = (ctb_size_v << vs) - ALF_VB_POS_ABOVE_LUMA
                    self._filter_cc(dst, luma_win, w, h, hs, vs,
                                    aps_alf.cc_coeff[c - 1][cc_idc - 1], vb)
