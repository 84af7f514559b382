# Frozen copy of ffvvc_tpu_torch/ps.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: imports data from the package root.
"""Derived parameter sets.

Turns raw header syntax (bitstream.h266 SyntaxObj) into the derived values
the decoder consumes: sizes in CTBs/min-CBs, chroma-QP mapping tables, tile
boundary maps, slice→CTU address lists, slice QP, partition constraints.

Reference analogue: libavcodec/vvc/vvc_ps.c (sps_derive :86,
pps tile/slice maps :414-560, ph_compute_poc :568, sh derivation :1034-1166).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .bitstream.h266 import (SyntaxObj, SUB_WIDTH_C, SUB_HEIGHT_C, ceil_log2,
                             SLICE_I, SLICE_P, SLICE_B, rect_slice_geometry)


@dataclasses.dataclass
class SPS:
    r: SyntaxObj                    # raw syntax

    def __post_init__(self):
        r = self.r
        # sanity limits (level 6.3 caps; also shields the error latch from
        # absurd allocations on corrupted headers)
        if not (1 <= r.sps_pic_width_max_in_luma_samples <= 16888) or \
                not (1 <= r.sps_pic_height_max_in_luma_samples <= 16888):
            raise ValueError("SPS picture size out of range")
        if r.sps_bitdepth_minus8 > 8:
            raise ValueError("SPS bit depth out of range")
        self.sps_id = r.sps_seq_parameter_set_id
        self.chroma_format_idc = r.sps_chroma_format_idc
        self.hshift = [0] + [ceil_log2(SUB_WIDTH_C[self.chroma_format_idc])] * 2
        self.vshift = [0] + [ceil_log2(SUB_HEIGHT_C[self.chroma_format_idc])] * 2
        self.bit_depth = r.sps_bitdepth_minus8 + 8
        self.qp_bd_offset = 6 * r.sps_bitdepth_minus8
        self.pixel_max = (1 << self.bit_depth) - 1
        self.ctb_log2_size_y = r.sps_log2_ctu_size_minus5 + 5
        self.ctb_size_y = 1 << self.ctb_log2_size_y
        self.min_cb_log2_size_y = r.sps_log2_min_luma_coding_block_size_minus2 + 2
        self.min_cb_size_y = 1 << self.min_cb_log2_size_y
        self.max_tb_size_y = 64 if r.sps_max_luma_transform_size_64_flag else 32
        self.max_ts_size = 1 << (r.sps_log2_transform_skip_max_size_minus2 + 2)
        self.num_cpoms = 2 if not r.sps_poc_msb_cycle_flag else 0
        self.max_pic_order_cnt_lsb = 1 << (r.sps_log2_max_pic_order_cnt_lsb_minus4 + 4)
        self.log2_parallel_merge_level = r.sps_log2_parallel_merge_level_minus2 + 2
        self.max_num_merge_cand = 6 - r.sps_six_minus_max_num_merge_cand
        self.max_num_ibc_merge_cand = 6 - r.sps_six_minus_max_num_ibc_merge_cand \
            if r.sps_ibc_enabled_flag else 0
        self.max_num_gpm_merge_cand = 0
        if r.sps_gpm_enabled_flag:
            if self.max_num_merge_cand >= 3:
                self.max_num_gpm_merge_cand = self.max_num_merge_cand - \
                    r.sps_max_num_merge_cand_minus_max_num_gpm_cand
            else:
                self.max_num_gpm_merge_cand = 2
        self.max_num_subblock_merge_cand = 0
        if r.sps_affine_enabled_flag:
            self.max_num_subblock_merge_cand = \
                5 - r.sps_five_minus_max_num_subblock_merge_cand
        elif r.sps_sbtmvp_enabled_flag:  # and ph_temporal_mvp (checked per pic)
            self.max_num_subblock_merge_cand = 1
        self._derive_chroma_qp_tables()
        # LADF intervals (sps_ladf, vvc_ps.c:161-172)
        self.num_ladf_intervals = 0
        if r.sps_ladf_enabled_flag:
            self.num_ladf_intervals = r.sps_num_ladf_intervals_minus2 + 2
            b = [0] * self.num_ladf_intervals
            for i in range(self.num_ladf_intervals - 1):
                b[i + 1] = b[i] + r.sps_ladf_delta_threshold_minus1[i] + 1
            self.ladf_interval_lower_bound = b

    def _derive_chroma_qp_tables(self):
        """ChromaQpTable (H.266 7.4.3.4 eq. 58-64; reference vvc_ps.c:86)."""
        r = self.r
        off = self.qp_bd_offset
        size = 63 + off + 1
        self.chroma_qp_table = np.zeros((3, size), dtype=np.int32)
        if self.chroma_format_idc == 0:
            return
        num_qp_tables = 1 if r.sps_same_qp_table_for_chroma_flag else \
            (3 if r.sps_joint_cbcr_enabled_flag else 2)
        for i in range(num_qp_tables):
            npts = r.sps_num_points_in_qp_table_minus1[i] + 1
            qp_in = [0] * (npts + 1)
            qp_out = [0] * (npts + 1)
            qp_in[0] = qp_out[0] = r.sps_qp_table_start_minus26[i] + 26
            for j in range(npts):
                din = r.sps_delta_qp_in_val_minus1[i][j]
                qp_in[j + 1] = qp_in[j] + din + 1
                qp_out[j + 1] = qp_out[j] + (din ^ r.sps_delta_qp_diff_val[i][j])
            t = self.chroma_qp_table[i]
            idx0 = qp_in[0] + off
            t[idx0] = qp_out[0]
            for k in range(idx0 - 1, -1, -1):
                t[k] = max(-off, min(63, t[k + 1] - 1))
            for j in range(npts):
                sh = (r.sps_delta_qp_in_val_minus1[i][j] + 1) >> 1
                m = r.sps_delta_qp_in_val_minus1[i][j] + 1
                for k in range(1, m + 1):
                    t[qp_in[j] + off + k] = t[qp_in[j] + off] + \
                        ((qp_out[j + 1] - qp_out[j]) * k + sh) // m
            for k in range(qp_in[npts] + off + 1, size):
                t[k] = max(-off, min(63, t[k - 1] + 1))
        if r.sps_same_qp_table_for_chroma_flag:
            self.chroma_qp_table[1] = self.chroma_qp_table[0]
            self.chroma_qp_table[2] = self.chroma_qp_table[0]
        elif not r.sps_joint_cbcr_enabled_flag:
            pass  # table[2] unused


@dataclasses.dataclass
class PPS:
    r: SyntaxObj
    sps: SPS

    def __post_init__(self):
        r, sps = self.r, self.sps
        self.pps_id = r.pps_pic_parameter_set_id
        self.width = r.pps_pic_width_in_luma_samples
        self.height = r.pps_pic_height_in_luma_samples
        ctb = sps.ctb_size_y
        log2 = sps.ctb_log2_size_y
        self.ctb_width = -(-self.width // ctb)
        self.ctb_height = -(-self.height // ctb)
        self.ctb_count = self.ctb_width * self.ctb_height
        self.min_cb_width = self.width >> sps.min_cb_log2_size_y
        self.min_cb_height = self.height >> sps.min_cb_log2_size_y
        # conformance cropping window in luma samples (spec 7.4.3.4: offsets
        # scale by SubWidthC/SubHeightC).  NOTE the reference applies the
        # offsets UNSCALED (vvc_refs.c:188-191, vvcdec.c:675-676), cropping
        # too little on 4:2:0/4:2:2 — a reference bug we do not replicate;
        # pinned by tests/test_conformance.py::test_l14_conf_window_ref_bug.
        sw, sh = 1 << sps.hshift[1], 1 << sps.vshift[1]
        self.crop = (sw * r.pps_conf_win_left_offset,
                     sw * r.pps_conf_win_right_offset,
                     sh * r.pps_conf_win_top_offset,
                     sh * r.pps_conf_win_bottom_offset)
        self.min_pu_width = self.width >> 3   # 8x8 granularity (MinPU = 8? no:)
        # 4x4 granularity maps (mvf / intra modes are stored per 4x4)
        self.min_tu_width = self.width >> 2
        self.min_tu_height = self.height >> 2
        # tile boundary maps: ctb_to_col_bd[rx] = first CTB column of rx's tile
        col_bd = np.zeros(self.ctb_width + 1, dtype=np.int32)
        row_bd = np.zeros(self.ctb_height + 1, dtype=np.int32)
        x = 0
        for w in r.col_width_val:
            col_bd[x:x + w] = x
            x += w
        col_bd[x:] = x
        y = 0
        for h in r.row_height_val:
            row_bd[y:y + h] = y
            y += h
        row_bd[y:] = y
        self.ctb_to_col_bd = col_bd
        self.ctb_to_row_bd = row_bd
        # tile right/bottom boundary maps (exclusive), for availability checks
        col_end = np.zeros(self.ctb_width + 1, dtype=np.int32)
        x = 0
        for w in r.col_width_val:
            col_end[x:x + w] = x + w
            x += w
        row_end = np.zeros(self.ctb_height + 1, dtype=np.int32)
        y = 0
        for h in r.row_height_val:
            row_end[y:y + h] = y + h
            y += h
        self.ctb_to_col_end = col_end
        self.ctb_to_row_end = row_end
        self.num_tile_columns = max(r.num_tile_columns, 1)
        self.num_tile_rows = max(r.num_tile_rows, 1)
        self.num_tiles_in_pic = max(r.num_tiles_in_pic, 1)
        # wraparound
        if r.pps_ref_wraparound_enabled_flag:
            self.ref_wraparound_offset = (self.width // sps.min_cb_size_y) - \
                r.pps_pic_width_minus_wraparound_offset
        else:
            self.ref_wraparound_offset = 0
        # chroma QP offsets
        self.chroma_qp_offset = [r.pps_cb_qp_offset, r.pps_cr_qp_offset,
                                 r.pps_joint_cbcr_qp_offset_value]

    def ctu_xy(self, ctb_addr: int):
        return ctb_addr % self.ctb_width, ctb_addr // self.ctb_width

    def slice_ctu_addrs(self, slice_idx: int, sh: SyntaxObj):
        """Ordered CTB raster addresses of a slice (reference pps_slice_map,
        vvc_ps.c:414-520)."""
        r = self.r
        addrs = []
        if r.pps_rect_slice_flag:
            x0, y0, wt, ht, h_ctu, w_ctu = rect_slice_geometry(self.sps.r, r, slice_idx)
            # iterate tiles covered; within a tile, raster order.
            # slices-within-a-tile case: wt==ht==1 and h_ctu < tile height
            if wt == 1 and ht == 1:
                for yy in range(y0, y0 + h_ctu):
                    for xx in range(x0, min(x0 + w_ctu,
                                            int(self.ctb_to_col_end[x0]))):
                        addrs.append(yy * self.ctb_width + xx)
                return addrs
            # full-tile spans
            tx0 = int(np.searchsorted(np.cumsum(r.col_width_val), x0, side="right"))
            ty0 = int(np.searchsorted(np.cumsum(r.row_height_val), y0, side="right"))
            for ti in range(ty0, ty0 + ht):
                for tj in range(tx0, tx0 + wt):
                    cx = sum(r.col_width_val[:tj])
                    cy = sum(r.row_height_val[:ti])
                    for yy in range(cy, cy + r.row_height_val[ti]):
                        for xx in range(cx, cx + r.col_width_val[tj]):
                            addrs.append(yy * self.ctb_width + xx)
            return addrs
        # raster-scan slices: consecutive tiles
        first_tile = sh.sh_slice_address
        for tile_idx in range(first_tile, first_tile + sh.sh_num_tiles_in_slice_minus1 + 1):
            tx = tile_idx % self.num_tile_columns
            ty = tile_idx // self.num_tile_columns
            cx = sum(r.col_width_val[:tx])
            cy = sum(r.row_height_val[:ty])
            for yy in range(cy, cy + r.row_height_val[ty]):
                for xx in range(cx, cx + r.col_width_val[tx]):
                    addrs.append(yy * self.ctb_width + xx)
        return addrs


@dataclasses.dataclass
class PH:
    r: SyntaxObj            # picture header syntax
    pps: PPS

    def __post_init__(self):
        self.poc = 0  # computed by refs.compute_poc per frame


class PredWeightTable:
    """Derived explicit weighted prediction params (reference PredWeightTable,
    pred_weight_table vvc_ps.c:530-560)."""

    def __init__(self, raw=None, sps=None):
        # weights indexed [lx][c_idx>0][ref_idx]
        self.log2_denom = [0, 0]
        self._flag = [[[0] * 16, [0] * 16], [[0] * 16, [0] * 16]]
        self._weight = [[[0] * 16, [0] * 16], [[0] * 16, [0] * 16]]
        self._offset = [[[0] * 16, [0] * 16], [[0] * 16, [0] * 16]]
        if raw is None:
            return
        r = raw
        self.log2_denom[0] = r.luma_log2_weight_denom
        self.log2_denom[1] = r.luma_log2_weight_denom + \
            r.delta_chroma_log2_weight_denom
        for lx, pre in ((0, "l0"), (1, "l1")):
            n = r.num_weights_l0 if lx == 0 else r.num_weights_l1
            for i in range(n):
                lw = getattr(r, f"luma_weight_{pre}_flag")
                if i < len(lw) and lw[i]:
                    self._flag[lx][0][i] = 1
                    self._weight[lx][0][i] = (1 << self.log2_denom[0]) + \
                        getattr(r, f"delta_luma_weight_{pre}")[i]
                    self._offset[lx][0][i] = getattr(r, f"luma_offset_{pre}")[i]
                else:
                    self._weight[lx][0][i] = 1 << self.log2_denom[0]
                cw = getattr(r, f"chroma_weight_{pre}_flag")
                if i < len(cw) and cw[i]:
                    self._flag[lx][1][i] = 1
                # chroma weight/offset derived per component at use site
        self.r = raw

    def weight_flag(self, lx, is_chroma, ref_idx):
        return self._flag[lx][is_chroma][ref_idx]

    def weight(self, lx, c_idx, ref_idx):
        if c_idx == 0:
            if self._flag[lx][0][ref_idx]:
                return self._weight[lx][0][ref_idx]
            return 1 << self.log2_denom[0]
        pre = "l0" if lx == 0 else "l1"
        if self._flag[lx][1][ref_idx]:
            return (1 << self.log2_denom[1]) + \
                getattr(self.r, f"delta_chroma_weight_{pre}")[ref_idx][c_idx - 1]
        return 1 << self.log2_denom[1]

    def offset(self, lx, c_idx, ref_idx, bit_depth=8):
        if c_idx == 0:
            return self._offset[lx][0][ref_idx]
        pre = "l0" if lx == 0 else "l1"
        if self._flag[lx][1][ref_idx]:
            d = getattr(self.r, f"delta_chroma_offset_{pre}")[ref_idx][c_idx - 1]
            w = self.weight(lx, c_idx, ref_idx)
            # reference vvc_ps.c:552: offset = clip(128 + delta - ((128*w)>>denom))
            return max(-128, min(127, 128 + d -
                                 ((128 * w) >> self.log2_denom[1])))
        return 0


DEFAULT_PWT = PredWeightTable()


class VVCScalingList:
    """Derived scaling matrices (reference VVCScalingList, scaling_derive
    vvc_ps.c:901-960)."""

    SL_START_16x16 = 14
    SL_START_64x64 = 26

    def __init__(self, aps):
        from . import data as D
        t = D.tables()
        pred8 = t["scaling_pred_8"].astype(np.int64)
        pred16 = t["scaling_pred_16"].astype(np.int64)
        list0 = t["scaling_list0"].astype(np.int64)
        self.rec = np.zeros((28, 64), dtype=np.int64)
        self.dc = np.zeros(14, dtype=np.int64)
        scan8 = D.diag_scan(8, 8)
        for sid in range(28):
            msize = 2 if sid < 2 else (4 if sid < 8 else 8)
            log2 = msize.bit_length() - 1
            lsz = msize * msize
            coeff = [0] * 64
            dc = 0
            if aps.aps_chroma_present_flag or sid % 3 == 2 or sid == 27:
                if not aps.scaling_list_copy_mode_flag[sid]:
                    next_coef = 0
                    if sid >= self.SL_START_16x16:
                        dc = next_coef = aps.scaling_list_dc_coef[
                            sid - self.SL_START_16x16]
                    for i in range(lsz):
                        x, y = scan8[i]
                        if not (sid >= self.SL_START_64x64 and
                                x >= 4 and y >= 4):
                            next_coef += aps.scaling_list_delta_coef[sid][i]
                        coeff[i] = next_coef
            if sid >= self.SL_START_16x16:
                if not aps.scaling_list_copy_mode_flag[sid] and \
                        not aps.scaling_list_pred_mode_flag[sid]:
                    self.dc[sid - 14] = 8
                elif not aps.scaling_list_pred_id_delta[sid]:
                    self.dc[sid - 14] = 16
                else:
                    ref = sid - aps.scaling_list_pred_id_delta[sid]
                    if ref >= self.SL_START_16x16:
                        dc += self.dc[ref - 14]
                    else:
                        dc += self.rec[ref][0]
                    self.dc[sid - 14] = dc & 255
            sl = list0 if aps.scaling_list_copy_mode_flag[sid] else coeff
            if not aps.scaling_list_copy_mode_flag[sid] and \
                    not aps.scaling_list_pred_mode_flag[sid]:
                pred = pred8
            elif not aps.scaling_list_pred_id_delta[sid]:
                pred = pred16
            else:
                pred = self.rec[sid - aps.scaling_list_pred_id_delta[sid]]
            scan = D.diag_scan(msize, msize)
            for i in range(lsz):
                x, y = scan[i]
                off = y * msize + x
                self.rec[sid][off] = (int(pred[off]) + int(sl[i])) & 255


class VVCLMCS:
    """Derived LMCS LUTs (reference VVCLMCS, lmcs_derive_lut
    vvc_ps.c:601-672)."""

    BIN_SIZE = 16

    def __init__(self, aps, sps_r):
        bd = sps_r.sps_bitdepth_minus8 + 8
        mx = 1 << bd
        org_cw = mx // self.BIN_SIZE
        shift = org_cw.bit_length() - 1
        off = 1 << (shift - 1)
        self.min_bin_idx = aps.lmcs_min_bin_idx
        self.max_bin_idx = self.BIN_SIZE - 1 - aps.lmcs_min_bin_idx
        cw = [0] * self.BIN_SIZE
        for i in range(self.min_bin_idx, self.max_bin_idx + 1):
            cw[i] = org_cw + (1 - 2 * aps.lmcs_delta_sign_cw_flag[i]) * \
                aps.lmcs_delta_abs_cw[i]
        delta_crs = (1 - 2 * aps.lmcs_delta_sign_crs_flag) * \
            aps.lmcs_delta_abs_crs
        self.pivot = [0] * (self.BIN_SIZE + 1)
        input_pivot = [0] * self.BIN_SIZE
        scale_coeff = [0] * self.BIN_SIZE
        inv_scale_coeff = [0] * self.BIN_SIZE
        self.chroma_scale_coeff = [0] * self.BIN_SIZE
        for i in range(self.BIN_SIZE):
            input_pivot[i] = i * org_cw
            self.pivot[i + 1] = self.pivot[i] + cw[i]
            scale_coeff[i] = (cw[i] * (1 << 11) + off) >> shift
            if cw[i] == 0:
                inv_scale_coeff[i] = 0
                self.chroma_scale_coeff[i] = 1 << 11
            else:
                inv_scale_coeff[i] = org_cw * (1 << 11) // cw[i]
                self.chroma_scale_coeff[i] = \
                    org_cw * (1 << 11) // (cw[i] + delta_crs)

        def lut_sample(sample, pivot1, pivot2, sc, idx):
            v = pivot1[idx] + ((sc[idx] * (sample - pivot2[idx]) +
                                (1 << 10)) >> 11)
            return max(0, min(mx - 1, v))

        fwd = np.zeros(mx, dtype=np.int32)
        for s in range(mx):
            fwd[s] = lut_sample(s, self.pivot, input_pivot, scale_coeff,
                                s // org_cw)
        inv = np.zeros(mx, dtype=np.int32)
        i = self.min_bin_idx
        for s in range(mx):
            while i <= self.max_bin_idx and s >= self.pivot[i + 1]:
                i += 1
            # samples >= pivot[max_bin_idx+1] land on bin max_bin_idx+1
            # (mirrors the reference, vvc_ps.c:658-662) — except when
            # max_bin_idx == 15, where the reference reads
            # input_pivot[16] OUT OF BOUNDS (stack overread, UB).  The
            # spec's piecewise-index identification (8.8.2.3) clamps to
            # LmcsMaxBinIdx; do that for the UB case.
            inv[s] = lut_sample(s, input_pivot, self.pivot,
                                inv_scale_coeff,
                                min(i, self.BIN_SIZE - 1))
        self.fwd_lut = fwd
        self.inv_lut = inv


def smvd_ref_idx(sh, rpl, poc):
    """SMVD symmetric ref indices (reference smvd_ref_idx, vvcdec.c:344-374).
    Mutates sh.ref_idx_sym; call once the slice RPL exists."""
    if not sh.is_b:
        return

    def find(lx, want_positive):
        idx, old_diff = -1, -1
        for i in range(sh.r.num_ref_idx_active[lx]):
            if not rpl[lx].is_lt[i]:
                diff = poc - rpl[lx].poc_list[i]
                if want_positive:
                    hit = diff > 0 and (idx < 0 or diff < old_diff)
                else:
                    hit = diff < 0 and (idx < 0 or diff > old_diff)
                if hit:
                    idx, old_diff = i, diff
        return idx

    sh.ref_idx_sym = [find(0, True), find(1, False)]
    if sh.ref_idx_sym[0] == -1 or sh.ref_idx_sym[1] == -1:
        sh.ref_idx_sym = [find(0, False), find(1, True)]


class RefPicList:
    """One derived reference picture list (reference RefPicList,
    ff_vvc_slice_rpl vvc_refs.c:415-466)."""

    def __init__(self):
        self.poc_list = []      # POC per entry
        self.is_lt = []         # long-term flag per entry
        self.frames = []        # DecodedFrame (or None for missing refs)
        self.nb_refs = 0

    def add(self, poc, is_lt, frame):
        self.poc_list.append(poc)
        self.is_lt.append(is_lt)
        self.frames.append(frame)
        self.nb_refs += 1


class SH:
    """Derived slice header (reference sh_derive, vvc_ps.c:1140-1166)."""

    def __init__(self, r: SyntaxObj, ph: SyntaxObj, sps: SPS, pps: PPS):
        self.r = r
        self.ph = ph
        if pps.r.pps_qp_delta_info_in_ph_flag:
            self.slice_qp_y = 26 + pps.r.pps_init_qp_minus26 + ph.ph_qp_delta
        else:
            self.slice_qp_y = 26 + pps.r.pps_init_qp_minus26 + r.sh_qp_delta
        self.cabac_init_type = 2 - r.sh_slice_type
        if r.sh_cabac_init_flag and r.sh_slice_type != SLICE_I:
            self.cabac_init_type ^= 3
        self.slice_type = r.sh_slice_type
        # slice index within picture (for rect slices, across subpics)
        self.slice_idx = r.sh_slice_address
        if pps.r.pps_rect_slice_flag:
            for i in range(r.curr_subpic_idx):
                self.slice_idx += pps.r.num_slices_in_subpic[i]
        self.ctu_addrs = pps.slice_ctu_addrs(self.slice_idx, r)
        # deblock params
        self.lf_disabled = bool(r.sh_deblocking_filter_disabled_flag)
        self.beta_offset = [r.sh_luma_beta_offset_div2 * 2,
                            r.sh_cb_beta_offset_div2 * 2,
                            r.sh_cr_beta_offset_div2 * 2]
        self.tc_offset = [r.sh_luma_tc_offset_div2 * 2,
                          r.sh_cb_tc_offset_div2 * 2,
                          r.sh_cr_tc_offset_div2 * 2]
        self.is_b = r.sh_slice_type == SLICE_B
        self.is_p = r.sh_slice_type == SLICE_P
        # SMVD symmetric ref indices; derived by the decoder once the RPL is
        # built (smvd_find, vvcdec.c:360-375); -1 = unavailable
        self.ref_idx_sym = [-1, -1]
        # explicit weighted prediction table (vvc_ps.c:687/1077)
        self.pwt = DEFAULT_PWT
        wp = (pps.r.pps_weighted_pred_flag and self.is_p) or \
             (pps.r.pps_weighted_bipred_flag and self.is_b)
        if wp:
            raw_pwt = ph.ph_pred_weight_table \
                if pps.r.pps_wp_info_in_ph_flag else r.sh_pred_weight_table
            if raw_pwt:
                self.pwt = PredWeightTable(raw_pwt, sps)
        self.weighted_pred = bool(wp)


def compute_poc(sps: SPS, ph: SyntaxObj, prev_poc: int, is_clvss: bool) -> int:
    """PicOrderCntVal (H.266 8.3.1; reference ph_compute_poc vvc_ps.c:568)."""
    max_lsb = sps.max_pic_order_cnt_lsb
    lsb = ph.ph_pic_order_cnt_lsb
    if ph.ph_poc_msb_cycle_present_flag:
        msb = ph.ph_poc_msb_cycle_val * max_lsb
    elif is_clvss:
        msb = 0
    else:
        prev_lsb = prev_poc & (max_lsb - 1)
        prev_msb = prev_poc - prev_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
    return msb + lsb
