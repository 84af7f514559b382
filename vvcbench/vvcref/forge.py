# Frozen copy of ffvvc_tpu_torch/tools/forge.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: imports are relative to this package; kept are the
#   builders of parameter sets and APSs, FuzzPolicy, forge_frame,
#   build_tiled_pps and forge_inter_stream; FlatPolicy, ToolsPolicy,
#   insert_picture_hashes, the other stream builders and the command
#   line are removed; forge_frame takes `collocated_from` (the list and
#   index of the collocated picture, which it signalled as L0[0] always).
"""Stream forge: synthesizes legal VVC bitstreams for differential testing.

Since no conformance bitstreams ship with this environment, the forge plays
the role of the JVET suite: each "level" exercises a growing toolset.  Every
forged stream is decoded by the reference decoder (bit-exact oracle) and by
ffvvc_tpu_torch; outputs must match byte-for-byte.

The forge drives the SAME bidirectional CTU syntax coder as the decoder
(ffvvc_tpu_torch.ctu.CtuCoder in encode mode), so encoder/decoder context
derivations agree by construction; the reference decoder then arbitrates
spec correctness.
"""
from __future__ import annotations

import random

import numpy as np

from .bitstream import write_nal, NalType, BitReader, BitWriter
from .bitstream.h266 import SyntaxObj, H266ParamSets, read_sps, read_pps
from .bitstream.h266_write import (write_sps, write_pps,
                                            write_slice_header, write_aps,
                                            write_picture_header)
from . import ps as derived
from .cabac.engine import CabacEncoder, make_states
from .ctu import CtuCoder, FrameTabs, SPLIT_NONE, SINGLE_TREE, \
    MODE_TYPE_ALL, SAO_NOT_APPLIED
from .bitstream.h266 import SLICE_I, SLICE_P, SLICE_B


def build_sps(width, height, bit_depth=8, ctu_log2=5, min_qt_log2=5,
              max_mtt_depth=0, chroma=1, **kw):
    sps = SyntaxObj()
    sps.sps_seq_parameter_set_id = 0
    sps.sps_video_parameter_set_id = 0
    sps.sps_max_sublayers_minus1 = 0
    sps.sps_chroma_format_idc = chroma
    sps.sps_log2_ctu_size_minus5 = ctu_log2 - 5
    sps.sps_ptl_dpb_hrd_params_present_flag = 1
    ptl = SyntaxObj()
    ptl.general_profile_idc = 1
    ptl.general_tier_flag = 0
    ptl.general_level_idc = 35
    ptl.ptl_frame_only_constraint_flag = 1
    ptl.ptl_multilayer_enabled_flag = 0
    ptl.general_constraints_info = None
    ptl.ptl_sublayer_level_present_flag = []
    ptl.ptl_num_sub_profiles = 0
    sps.profile_tier_level = ptl
    sps.sps_pic_width_max_in_luma_samples = width
    sps.sps_pic_height_max_in_luma_samples = height
    dpb = SyntaxObj()
    dpb.dpb_max_dec_pic_buffering_minus1 = [7]
    dpb.dpb_max_num_reorder_pics = [0]
    dpb.dpb_max_latency_increase_plus1 = [0]
    sps.sps_dpb_params = dpb
    sps.sps_bitdepth_minus8 = bit_depth - 8
    sps.sps_log2_max_pic_order_cnt_lsb_minus4 = 4
    sps.sps_log2_min_luma_coding_block_size_minus2 = 0
    # partition config
    sps.sps_log2_diff_min_qt_min_cb_intra_slice_luma = min_qt_log2 - 2
    sps.sps_max_mtt_hierarchy_depth_intra_slice_luma = max_mtt_depth
    if max_mtt_depth:
        sps.sps_log2_diff_max_bt_min_qt_intra_slice_luma = \
            min(6, ctu_log2) - min_qt_log2
        sps.sps_log2_diff_max_tt_min_qt_intra_slice_luma = \
            min(6, ctu_log2) - min_qt_log2
    sps.sps_log2_diff_min_qt_min_cb_inter_slice = min_qt_log2 - 2
    sps.sps_max_mtt_hierarchy_depth_inter_slice = max_mtt_depth
    if max_mtt_depth:
        sps.sps_log2_diff_max_bt_min_qt_inter_slice = \
            min(6, ctu_log2) - min_qt_log2
        sps.sps_log2_diff_max_tt_min_qt_inter_slice = \
            min(6, ctu_log2) - min_qt_log2
    if chroma:
        sps.sps_same_qp_table_for_chroma_flag = 1
        sps.sps_qp_table_start_minus26 = [0]
        sps.sps_num_points_in_qp_table_minus1 = [0]
        sps.sps_delta_qp_in_val_minus1 = [[0]]
        sps.sps_delta_qp_diff_val = [[0]]
        sps.sps_chroma_horizontal_collocated_flag = 1
        sps.sps_chroma_vertical_collocated_flag = 1
    sps.sps_num_ref_pic_lists = [0, 0]
    sps.sps_ref_pic_list_struct = [[], []]
    sps.sps_rpl1_same_as_rpl0_flag = 1
    for k, v in kw.items():
        setattr(sps, k, v)
    return sps


def build_pps(sps, **kw):
    pps = SyntaxObj()
    pps.pps_pic_parameter_set_id = 0
    pps.pps_seq_parameter_set_id = 0
    pps.pps_pic_width_in_luma_samples = sps.sps_pic_width_max_in_luma_samples
    pps.pps_pic_height_in_luma_samples = sps.sps_pic_height_max_in_luma_samples
    pps.pps_no_pic_partition_flag = 1
    pps.pps_num_ref_idx_default_active_minus1 = [0, 0]
    pps.pps_init_qp_minus26 = 0
    for k, v in kw.items():
        setattr(pps, k, v)
    return pps


class FuzzPolicy:
    """Random-legal syntax choices + sparse random residuals."""

    def __init__(self, seed, max_level=40, density=0.15, split_p=0.5,
                 residual_p=0.7, mvd_max=64):
        self.rng = random.Random(seed)
        self.nrng = np.random.default_rng(seed)
        self.max_level = max_level
        self.density = density
        self.split_p = split_p
        self.residual_p = residual_p
        self.mvd_max = mvd_max     # abs_mvd_minus2 range (1/16 pel)
        self._coeff_cache = {}

    def __call__(self, tag, **ctx):
        r = self.rng
        if tag == "split_cu_flag":
            return int(r.random() < self.split_p)
        if tag in ("split_qt_flag", "mtt_vertical", "mtt_binary", "isp_split",
                   "bdpcm_luma_dir", "bdpcm_chroma_dir", "mip_transposed"):
            return r.randrange(2)
        if tag == "transform_skip":
            return int(r.random() < 0.5)
        if tag in ("bdpcm_luma_flag", "bdpcm_chroma_flag"):
            return int(r.random() < 0.3)
        if tag == "intra_luma_mode":
            return r.randrange(0, 67)
        if tag == "intra_chroma_mode":
            return r.randrange(0, 5)
        if tag == "cclm_mode_flag":
            return int(r.random() < 0.6)
        if tag == "cclm_mode_idx":
            return r.randrange(3)
        if tag == "tu_y_coded":
            return self._gen_coeffs(ctx, 0)
        if tag == "tu_cb_coded":
            return self._gen_coeffs(ctx, 1)
        if tag == "tu_cr_coded":
            return self._gen_coeffs(ctx, 2)
        if tag in ("sao_merge_left", "sao_merge_up"):
            return int(r.random() < 0.2)
        if tag == "sao_type":
            return r.randrange(3)  # none / band / edge
        if tag == "sao_offset_abs":
            return r.randrange(0, ctx["c_max"] + 1)
        if tag == "sao_offset_sign":
            return r.randrange(2)
        if tag == "sao_band_position":
            return r.randrange(32)
        if tag == "sao_eo_class":
            return r.randrange(4)
        if tag == "alf_ctb_flag":
            return int(r.random() < 0.7)
        if tag == "alf_use_aps":
            return int(r.random() < 0.7)
        if tag in ("alf_prev_filt_idx", "alf_fixed_filt_idx"):
            return r.randrange(0, ctx.get("c_max", 15) + 1)
        if tag in ("alf_alt_idx", "alf_cc_idc", "alf_cc_idc_tail"):
            return r.randrange(2)
        # --- inter syntax ---------------------------------------------------
        if tag == "cu_skip_flag":
            return int(r.random() < 0.2)
        if tag == "pred_mode_flag":
            return int(r.random() < 0.3)   # 1 = intra
        if tag == "general_merge_flag":
            return int(r.random() < 0.5)
        if tag in ("merge_idx_b0", "merge_idx_ext", "mvp_lx_flag",
                   "ref_idx_lx", "ref_idx_lx_ext", "mvd_sign_flag",
                   "inter_pred_idc_b5", "mmvd_cand_flag", "mmvd_dir0",
                   "mmvd_dir1", "gpm_partition_idx", "bcw_idx_ext"):
            return r.randrange(2)
        if tag == "inter_pred_idc":
            return int(r.random() < 0.5)   # 1 = BI
        if tag == "abs_mvd_greater0_flag":
            return int(r.random() < 0.8)
        if tag == "abs_mvd_greater1_flag":
            return int(r.random() < 0.5)
        if tag == "abs_mvd_minus2":
            return r.randrange(0, self.mvd_max)
        if tag == "cu_coded_flag":
            return int(r.random() < 0.8)
        if tag in ("sbt_flag", "sbt_quad_flag", "sbt_horizontal", "sbt_pos"):
            return r.randrange(2)
        if tag in ("regular_merge_flag",):
            return int(r.random() < 0.6)
        if tag in ("merge_subblock_idx_b0", "merge_subblock_ext",
                   "cu_affine_type_flag"):
            return r.randrange(2)
        if tag in ("ciip_flag", "mmvd_merge_flag", "merge_subblock_flag",
                   "mmvd_distance_idx_b0", "mmvd_distance_ext",
                   "sym_mvd_flag", "inter_affine_flag", "amvr_flag",
                   "bcw_idx"):
            return int(r.random() < 0.5)
        return 0

    def _gen_coeffs(self, ctx, c_idx):
        key = (ctx["x0"], ctx["y0"], c_idx)
        if self.rng.random() > self.residual_p:
            return 0
        w, h = ctx["w"], ctx["h"]
        if c_idx:
            w >>= 1  # 4:2:0 assumed for the fuzz levels
            h >>= 1
        n = max(1, int(w * h * self.density * self.rng.random()))
        c = np.zeros((h, w), dtype=np.int32)
        # confine to the coded region: 64-pt transforms zero out
        # coefficients beyond 32 (they are never coded), and an all-zero
        # trimmed TB cannot be signalled with cbf=1
        xs = self.nrng.integers(0, min(w, 32), n)
        ys = self.nrng.integers(0, min(h, 32), n)
        vals = self.nrng.integers(-self.max_level, self.max_level + 1, n)
        c[ys, xs] = vals
        if not c.any():
            c[0, 0] = 1
        self._coeff_cache[key] = c
        return 1

    def coeffs(self, tb):
        key = (tb.x0, tb.y0, tb.c_idx)
        if key in self._coeff_cache:
            c = self._coeff_cache[key]
            if c.shape != (tb.h, tb.w):
                # cached guess didn't match the actual TB geometry (e.g.
                # chroma TB of a split TU); crop/pad, keep cbf=1 legal
                out = np.zeros((tb.h, tb.w), dtype=np.int32)
                hh, ww = min(tb.h, c.shape[0]), min(tb.w, c.shape[1])
                out[:hh, :ww] = c[:hh, :ww]
                if not out.any():
                    out[0, 0] = 1
                c = out
            return c.astype(np.int32)
        # joint-cbcr / inferred cbf paths: generate on demand
        c = np.zeros((tb.h, tb.w), dtype=np.int32)
        c[0, 0] = self.rng.randrange(1, 8)
        return c


def make_alf_aps(rng, aps_id=0, chroma=True, ccalf=False, clip=True):
    """Random legal ALF APS."""
    a = SyntaxObj()
    a.aps_params_type = 0
    a.aps_adaptation_parameter_set_id = aps_id
    a.aps_chroma_present_flag = int(chroma)
    a.alf_luma_filter_signal_flag = 1
    a.alf_luma_clip_flag = int(clip and rng.random() < 0.7)
    nf = rng.randrange(1, 6)
    a.alf_luma_num_filters_signalled_minus1 = nf - 1
    a.alf_luma_coeff_delta_idx = [rng.randrange(nf) for _ in range(25)]
    a.alf_luma_coeff_abs = [[rng.randrange(0, 12) for _ in range(12)]
                            for _ in range(nf)]
    a.alf_luma_coeff_sign = [[rng.randrange(2) for _ in range(12)]
                             for _ in range(nf)]
    a.alf_luma_clip_idx = [[rng.randrange(4) if a.alf_luma_clip_flag else 0
                            for _ in range(12)] for _ in range(nf)]
    if chroma:
        a.alf_chroma_filter_signal_flag = 1
        a.alf_chroma_clip_flag = int(clip and rng.random() < 0.7)
        na = rng.randrange(1, 3)
        a.alf_chroma_num_alt_filters_minus1 = na - 1
        a.alf_chroma_coeff_abs = [[rng.randrange(0, 12) for _ in range(6)]
                                  for _ in range(na)]
        a.alf_chroma_coeff_sign = [[rng.randrange(2) for _ in range(6)]
                                   for _ in range(na)]
        a.alf_chroma_clip_idx = [[rng.randrange(4)
                                  if a.alf_chroma_clip_flag else 0
                                  for _ in range(6)] for _ in range(na)]
        if ccalf:
            for pre in ("cb", "cr"):
                setattr(a, f"alf_cc_{pre}_filter_signal_flag", 1)
                n = rng.randrange(1, 3)
                setattr(a, f"alf_cc_{pre}_filters_signalled_minus1", n - 1)
                setattr(a, f"alf_cc_{pre}_mapped_coeff_abs",
                        [[rng.randrange(0, 8) for _ in range(7)]
                         for _ in range(n)])
                setattr(a, f"alf_cc_{pre}_coeff_sign",
                        [[rng.randrange(2) for _ in range(7)]
                         for _ in range(n)])
    return a


def make_scaling_aps(rng, aps_id=0, chroma=True):
    """Random legal scaling-list APS."""
    a = SyntaxObj()
    a.aps_params_type = 2
    a.aps_adaptation_parameter_set_id = aps_id
    a.aps_chroma_present_flag = int(chroma)
    a.scaling_list_copy_mode_flag = [1] * 28
    a.scaling_list_pred_mode_flag = [0] * 28
    a.scaling_list_pred_id_delta = [0] * 28
    a.scaling_list_dc_coef = [0] * 14
    a.scaling_list_delta_coef = [[0] * 64 for _ in range(28)]
    for sid in range(28):
        if not (chroma or sid % 3 == 2 or sid == 27):
            continue
        mode = rng.randrange(3)   # 0=explicit, 1=pred, 2=copy
        if mode == 0:
            a.scaling_list_copy_mode_flag[sid] = 0
            a.scaling_list_pred_mode_flag[sid] = 0
        elif mode == 1:
            a.scaling_list_copy_mode_flag[sid] = 0
            a.scaling_list_pred_mode_flag[sid] = 1
            if sid not in (0, 2, 8):
                a.scaling_list_pred_id_delta[sid] = rng.randrange(0, 2)
        else:
            a.scaling_list_copy_mode_flag[sid] = 1
            if sid not in (0, 2, 8):
                a.scaling_list_pred_id_delta[sid] = rng.randrange(0, 2)
        if not a.scaling_list_copy_mode_flag[sid]:
            if sid > 13:
                a.scaling_list_dc_coef[sid - 14] = rng.randrange(-8, 9)
            for i in range(64):
                a.scaling_list_delta_coef[sid][i] = rng.randrange(-4, 5)
    return a


def make_lmcs_aps(rng, aps_id=0, chroma=True, bit_depth=8):
    """Random legal LMCS APS."""
    a = SyntaxObj()
    a.aps_params_type = 1
    a.aps_adaptation_parameter_set_id = aps_id
    a.aps_chroma_present_flag = int(chroma)
    a.lmcs_min_bin_idx = rng.randrange(0, 4)
    # never 0: max_bin_idx == 15 with sum(cw) < max makes the reference's
    # inverse-LUT derivation read input_pivot[16] out of bounds
    # (vvc_ps.c:658-662, stack overread UB) — differential tests against
    # the oracle would compare against garbage
    a.lmcs_delta_max_bin_idx = rng.randrange(1, 4)
    a.lmcs_delta_cw_prec_minus1 = 2
    org_cw = (1 << bit_depth) // 16
    a.lmcs_delta_abs_cw = [0] * 16
    a.lmcs_delta_sign_cw_flag = [0] * 16
    for i in range(a.lmcs_min_bin_idx, 15 - a.lmcs_delta_max_bin_idx + 1):
        a.lmcs_delta_abs_cw[i] = rng.randrange(0, min(8, org_cw // 4 + 1))
        if a.lmcs_delta_abs_cw[i]:
            a.lmcs_delta_sign_cw_flag[i] = rng.randrange(2)
    if chroma:
        a.lmcs_delta_abs_crs = rng.randrange(0, 4)
        if a.lmcs_delta_abs_crs:
            a.lmcs_delta_sign_crs_flag = rng.randrange(2)
    return a


def make_pwt(rng, sps_raw, n0, n1, bipred):
    """Random explicit weighted-prediction table."""
    pwt = SyntaxObj()
    pwt.luma_log2_weight_denom = rng.randrange(0, 5)
    cd = rng.randrange(0, 5) - pwt.luma_log2_weight_denom
    pwt.delta_chroma_log2_weight_denom = cd if sps_raw.sps_chroma_format_idc else 0
    pwt.num_weights_l0 = n0
    pwt.num_weights_l1 = n1 if bipred else 0
    for pre, n in (("l0", n0), ("l1", pwt.num_weights_l1)):
        setattr(pwt, f"luma_weight_{pre}_flag",
                [rng.randrange(2) for _ in range(n)])
        setattr(pwt, f"chroma_weight_{pre}_flag",
                [rng.randrange(2) if sps_raw.sps_chroma_format_idc else 0
                 for _ in range(n)])
        setattr(pwt, f"delta_luma_weight_{pre}",
                [rng.randrange(-20, 21) for _ in range(n)])
        setattr(pwt, f"luma_offset_{pre}",
                [rng.randrange(-30, 31) for _ in range(n)])
        setattr(pwt, f"delta_chroma_weight_{pre}",
                [[rng.randrange(-20, 21), rng.randrange(-20, 21)]
                 for _ in range(n)])
        setattr(pwt, f"delta_chroma_offset_{pre}",
                [[rng.randrange(-60, 61), rng.randrange(-60, 61)]
                 for _ in range(n)])
    return pwt


def make_explicit_rpl(deltas0, deltas1, weighted=False, max_poc_lsb=256):
    """Slice-header-explicit ref pic lists.  deltasN entries: a signed int
    is a short-term POC delta (relative to the previous ST entry's POC;
    negative = past); a tuple ("lt", poc) / ("ltmsb", poc) is a long-term
    reference to absolute POC `poc`, signalled by LSB only or with an
    explicit delta_poc_msb_cycle (which must then be 0, i.e. poc within
    the current LSB window).  With SH-explicit RPLs the decoder infers
    ltrp_in_header_flag=1, so LT POC LSBs land in ref_pic_lists()
    (h266.py:241-245 / decoder.py _build_slice_rpl)."""
    rls = SyntaxObj()
    rls.poc_lsb_lt = [[], []]
    rls.delta_poc_msb_cycle_present_flag = [[], []]
    rls.delta_poc_msb_cycle_lt = [[], []]

    def mk(lx, deltas):
        st = SyntaxObj()
        n = len(deltas)
        st.num_ref_entries = n
        st.ltrp_in_header_flag = 1 if any(
            isinstance(d, tuple) for d in deltas) else 0
        st.inter_layer_ref_pic_flag = [0] * n
        st.st_ref_pic_flag = [1] * n
        st.abs_delta_poc_st = [0] * n
        st.strp_entry_sign_flag = [0] * n
        st.rpls_poc_lsb_lt = [0] * n
        st.ilrp_idx = []
        for i, d in enumerate(deltas):
            if isinstance(d, tuple):
                kind, p = d
                st.st_ref_pic_flag[i] = 0
                rls.poc_lsb_lt[lx].append(p & (max_poc_lsb - 1))
                rls.delta_poc_msb_cycle_present_flag[lx].append(
                    1 if kind == "ltmsb" else 0)
                rls.delta_poc_msb_cycle_lt[lx].append(0)
                continue
            ad = abs(d)
            # derived |delta| = raw + 1 unless (weighted && i != 0)
            st.abs_delta_poc_st[i] = ad if (weighted and i != 0) else ad - 1
            st.strp_entry_sign_flag[i] = 1 if d < 0 else 0
        return st
    rls.rpl_sps_flag = [0, 0]
    rls.rpl_idx = [0, 0]
    rls.rpl_ref_list = [mk(0, deltas0), mk(1, deltas1)]
    return rls


class ColFrameShim:
    """Collocated-frame view for encode-side TMVP: exposes the same
    get_mvf/rpl_at/poc interface as decoder.DecodedFrame."""

    def __init__(self, poc, tabs, rpl, ctb_log2):
        from .mvs import MvField
        self.poc = poc
        self.tabs = tabs
        self.rpl = rpl
        self._ctb_log2 = ctb_log2
        self._MvField = MvField

    def get_mvf(self, x, y):
        t = self.tabs
        xi, yi = x >> 2, y >> 2
        f = self._MvField()
        f.pred_flag = int(t.col_pf[yi, xi])
        f.mv = [[int(t.col_mv[0, yi, xi, 0]), int(t.col_mv[0, yi, xi, 1])],
                [int(t.col_mv[1, yi, xi, 0]), int(t.col_mv[1, yi, xi, 1])]]
        f.ref_idx = [int(t.col_ref[0, yi, xi]), int(t.col_ref[1, yi, xi])]
        return f

    def rpl_at(self, x, y):
        return self.rpl


def _epb_chunk_lens(chunks):
    """Coded (post-EPB-insertion) byte length of each chunk, tracking the
    zero-run carry across chunk boundaries (mirror of nal.insert_epb).  The
    slice header always ends with a nonzero alignment byte, so the carry
    into chunk 0 is zero."""
    zeros = 0
    lens = []
    for ch in chunks:
        n = 0
        for b in ch:
            if zeros >= 2 and b <= 3:
                n += 1
                zeros = 0
            n += 1
            zeros = zeros + 1 if b == 0 else 0
        lens.append(n)
    return lens


def forge_frame(sps_r, pps_r, policy, qp=32, poc=0, idr=True,
                slice_type=SLICE_I, n_refs=(1, 0), collocated=None,
                collocated_from=(1, 0),
                ref_deltas=None, alf_aps=None, ccalf=False, lmcs_aps=None,
                scaling_aps=None, slices=None, gdr_recovery=None,
                sh_kw=None, info_in_ph=False, ph_kw=None):
    """Encode one frame; returns (NAL bytes, ColFrameShim).

    slices: None for a single slice covering the picture (PH in SH);
    otherwise a list of (sh_slice_address, num_tiles_in_slice) raster-scan
    slice definitions — a standalone PH NAL is emitted first."""
    ps0 = H266ParamSets()
    sps_rb = write_sps(sps_r)
    pps_rb = write_pps(pps_r, sps_r)
    sps_raw = read_sps(BitReader(sps_rb))
    ps0.store_sps(sps_raw)
    pps_raw = read_pps(BitReader(pps_rb), ps0)
    sps = derived.SPS(sps_raw)
    pps = derived.PPS(pps_raw, sps)

    inter = slice_type != SLICE_I
    ph = SyntaxObj()
    ph.ph_gdr_or_irap_pic_flag = 1 if (idr or gdr_recovery is not None) else 0
    if gdr_recovery is not None:
        ph.ph_gdr_pic_flag = 1
        ph.ph_recovery_poc_cnt = gdr_recovery
    ph.ph_inter_slice_allowed_flag = int(inter)
    ph.ph_intra_slice_allowed_flag = 1
    ph.ph_pic_parameter_set_id = 0
    ph.ph_pic_order_cnt_lsb = poc & 0xFF
    ph.ph_pic_output_flag = 1
    if lmcs_aps is not None:
        ph.ph_lmcs_enabled_flag = 1
        ph.ph_lmcs_aps_id = lmcs_aps.aps_adaptation_parameter_set_id
        if sps_r.sps_chroma_format_idc:
            ph.ph_chroma_residual_scale_flag = 1
    if scaling_aps is not None:
        ph.ph_explicit_scaling_list_enabled_flag = 1
        ph.ph_scaling_list_aps_id = \
            scaling_aps.aps_adaptation_parameter_set_id
    if inter:
        ph.ph_log2_diff_min_qt_min_cb_inter_slice = \
            sps_raw.sps_log2_diff_min_qt_min_cb_inter_slice
        ph.ph_max_mtt_hierarchy_depth_inter_slice = \
            sps_raw.sps_max_mtt_hierarchy_depth_inter_slice
        ph.ph_log2_diff_max_bt_min_qt_inter_slice = \
            sps_raw.sps_log2_diff_max_bt_min_qt_inter_slice
        ph.ph_log2_diff_max_tt_min_qt_inter_slice = \
            sps_raw.sps_log2_diff_max_tt_min_qt_inter_slice
        ph.ph_temporal_mvp_enabled_flag = \
            int(bool(sps_raw.sps_temporal_mvp_enabled_flag) and
                collocated is not None)
        # tool-disable inferences the decoder's PH reader applies
        # (h266.py:1602-1628) — must match here for the symmetric coder
        ph.ph_bdof_disabled_flag = 1 - sps_raw.sps_bdof_enabled_flag
        ph.ph_dmvr_disabled_flag = 1 - sps_raw.sps_dmvr_enabled_flag
        ph.ph_prof_disabled_flag = \
            0 if sps_raw.sps_affine_prof_enabled_flag else 1
        ph.ph_mvd_l1_zero_flag = 0
    if info_in_ph:
        # PH-level signalling (pps_{rpl,wp,qp_delta,sao,dbf}_info_in_ph):
        # the PPS flags come set on pps_r by the caller; the SH reader
        # copies these PH values into the slice (h266.py:1767-1880,
        # reference pps_rpl_info_in_ph consumers vvc_ps.c:1140-1166)
        if pps_raw.pps_qp_delta_info_in_ph_flag:
            ph.ph_qp_delta = qp - 26 - pps_raw.pps_init_qp_minus26
        if pps_raw.pps_sao_info_in_ph_flag and sps_raw.sps_sao_enabled_flag:
            ph.ph_sao_luma_enabled_flag = 1
            ph.ph_sao_chroma_enabled_flag = \
                int(bool(sps_raw.sps_chroma_format_idc))
        if pps_raw.pps_alf_info_in_ph_flag and alf_aps is not None:
            aid = alf_aps.aps_adaptation_parameter_set_id
            ph.ph_alf_enabled_flag = 1
            ph.ph_num_alf_aps_ids_luma = 1
            ph.ph_alf_aps_id_luma = [aid]
            if sps_raw.sps_chroma_format_idc:
                ph.ph_alf_cb_enabled_flag = 1
                ph.ph_alf_cr_enabled_flag = 1
                ph.ph_alf_aps_id_chroma = aid
                if ccalf and sps_raw.sps_ccalf_enabled_flag:
                    ph.ph_alf_cc_cb_enabled_flag = 1
                    ph.ph_alf_cc_cb_aps_id = aid
                    ph.ph_alf_cc_cr_enabled_flag = 1
                    ph.ph_alf_cc_cr_aps_id = aid
        if pps_raw.pps_dbf_info_in_ph_flag:
            ph.ph_deblocking_params_present_flag = 1
            ph.ph_luma_beta_offset_div2 = 1
            ph.ph_luma_tc_offset_div2 = -1
            cb = pps_raw.pps_chroma_tool_offsets_present_flag
            ph.ph_cb_beta_offset_div2 = 2 if cb else 1
            ph.ph_cb_tc_offset_div2 = -2 if cb else -1
            ph.ph_cr_beta_offset_div2 = 2 if cb else 1
            ph.ph_cr_tc_offset_div2 = -2 if cb else -1
        if pps_raw.pps_rpl_info_in_ph_flag and not inter:
            # the PH always carries RPLs when rpl_info_in_ph (even IDR)
            ph.ph_ref_pic_lists = make_explicit_rpl([], [])
        elif pps_raw.pps_rpl_info_in_ph_flag:
            weighted = bool(sps_raw.sps_weighted_pred_flag or
                            sps_raw.sps_weighted_bipred_flag)
            if ref_deltas is None:
                ref_deltas = ([-1] * n_refs[0], [-1] * n_refs[1])
            n_refs = (len(ref_deltas[0]), len(ref_deltas[1]))
            ph.ph_ref_pic_lists = make_explicit_rpl(*ref_deltas,
                                                    weighted=weighted)
            if ph.ph_temporal_mvp_enabled_flag:
                ph.ph_collocated_from_l0_flag, ph.ph_collocated_ref_idx = \
                    collocated_from
            if pps_raw.pps_wp_info_in_ph_flag and \
                    (pps_raw.pps_weighted_pred_flag or
                     pps_raw.pps_weighted_bipred_flag):
                bipred = bool(pps_raw.pps_weighted_bipred_flag and
                              n_refs[1])
                pwt = make_pwt(policy.rng, sps_raw, n_refs[0], n_refs[1],
                               bipred)
                pwt.num_l0_weights = n_refs[0]
                pwt.num_l1_weights = pwt.num_weights_l1
                ph.ph_pred_weight_table = pwt
    # partition params inferred from SPS
    ph.ph_log2_diff_min_qt_min_cb_intra_slice_luma = \
        sps_raw.sps_log2_diff_min_qt_min_cb_intra_slice_luma
    ph.ph_max_mtt_hierarchy_depth_intra_slice_luma = \
        sps_raw.sps_max_mtt_hierarchy_depth_intra_slice_luma
    ph.ph_log2_diff_max_bt_min_qt_intra_slice_luma = \
        sps_raw.sps_log2_diff_max_bt_min_qt_intra_slice_luma
    ph.ph_log2_diff_max_tt_min_qt_intra_slice_luma = \
        sps_raw.sps_log2_diff_max_tt_min_qt_intra_slice_luma
    ph.ph_log2_diff_min_qt_min_cb_intra_slice_chroma = \
        sps_raw.sps_log2_diff_min_qt_min_cb_intra_slice_chroma
    ph.ph_max_mtt_hierarchy_depth_intra_slice_chroma = \
        sps_raw.sps_max_mtt_hierarchy_depth_intra_slice_chroma
    ph.ph_log2_diff_max_bt_min_qt_intra_slice_chroma = \
        sps_raw.sps_log2_diff_max_bt_min_qt_intra_slice_chroma
    ph.ph_log2_diff_max_tt_min_qt_intra_slice_chroma = \
        sps_raw.sps_log2_diff_max_tt_min_qt_intra_slice_chroma

    for k, v in (ph_kw or {}).items():
        setattr(ph, k, v)
    nal_type = NalType.IDR_N_LP if idr else (
        NalType.GDR if gdr_recovery is not None else NalType.TRAIL)
    wpp = bool(sps_raw.sps_entropy_coding_sync_enabled_flag)
    multi_slice = slices is not None
    # info-in-PH requires a standalone PH NAL (H.266 7.4.3.7 forbids
    # PH-in-SH when any pps_*_info_in_ph_flag is set)
    standalone_ph = multi_slice or info_in_ph
    out = b""
    if standalone_ph:
        wph = BitWriter()
        write_picture_header(wph, ph, sps_raw, pps_raw)
        wph.rbsp_trailing_bits()
        out += write_nal(NalType.PH, wph.bytes())
    slice_defs = slices if multi_slice else [None]

    tabs = FrameTabs(sps, pps)
    shared_rpl = None
    for slice_no, sdef in enumerate(slice_defs):
        sh_r = SyntaxObj()
        sh_r.nal_unit_type = int(nal_type)
        for k, v in (sh_kw or {}).items():
            setattr(sh_r, k, v)
        if sps_raw.sps_sao_enabled_flag:
            sh_r.sh_sao_luma_used_flag = 1
            sh_r.sh_sao_chroma_used_flag = \
                int(bool(sps_raw.sps_chroma_format_idc))
        if alf_aps is not None:
            sh_r.sh_alf_enabled_flag = 1
            sh_r.sh_num_alf_aps_ids_luma = 1
            sh_r.sh_alf_aps_id_luma = \
                [alf_aps.aps_adaptation_parameter_set_id]
            if sps_raw.sps_chroma_format_idc:
                sh_r.sh_alf_cb_enabled_flag = 1
                sh_r.sh_alf_cr_enabled_flag = 1
                sh_r.sh_alf_aps_id_chroma = \
                    alf_aps.aps_adaptation_parameter_set_id
                if ccalf and sps_raw.sps_ccalf_enabled_flag:
                    sh_r.sh_alf_cc_cb_enabled_flag = 1
                    sh_r.sh_alf_cc_cb_aps_id = \
                        alf_aps.aps_adaptation_parameter_set_id
                    sh_r.sh_alf_cc_cr_enabled_flag = 1
                    sh_r.sh_alf_cc_cr_aps_id = \
                        alf_aps.aps_adaptation_parameter_set_id
        if sps_raw.sps_dep_quant_enabled_flag:
            sh_r.sh_dep_quant_used_flag = 1
        elif sps_raw.sps_sign_data_hiding_enabled_flag:
            sh_r.sh_sign_data_hiding_used_flag = 1
        sh_r.sh_picture_header_in_slice_header_flag = \
            0 if standalone_ph else 1
        if standalone_ph:
            # flags present in the SH only with a standalone PH
            if lmcs_aps is not None:
                sh_r.sh_lmcs_used_flag = 1
            if scaling_aps is not None:
                sh_r.sh_explicit_scaling_list_used_flag = 1
        if multi_slice:
            if pps_raw.pps_rect_slice_flag:
                # rect slices: sdef[0] is the picture-level slice index;
                # map to (subpic, address-in-subpic)
                sidx = sdef[0]
                sub = 0
                addr = sidx
                while addr >= pps_raw.num_slices_in_subpic[sub]:
                    addr -= pps_raw.num_slices_in_subpic[sub]
                    sub += 1
                sh_r.curr_subpic_idx = sub
                if sps_raw.sps_subpic_info_present_flag:
                    sh_r.sh_subpic_id = pps_raw.sub_pic_id_val[sub]
                sh_r.sh_slice_address = addr
            else:
                sh_r.sh_slice_address = sdef[0]
                sh_r.sh_num_tiles_in_slice_minus1 = sdef[1] - 1
        elif not pps_raw.pps_rect_slice_flag and \
                pps_raw.num_tiles_in_pic > 1:
            # single slice covering every tile
            sh_r.sh_num_tiles_in_slice_minus1 = \
                pps_raw.num_tiles_in_pic - 1
        sh_r.sh_slice_type = slice_type
        sh_r.sh_qp_delta = qp - 26 - pps_raw.pps_init_qp_minus26
        sh_r.ph = ph
        if info_in_ph and pps_raw.pps_dbf_info_in_ph_flag:
            # SH inference from PH deblock params (h266.py:1885-1895)
            sh_r.sh_luma_beta_offset_div2 = ph.ph_luma_beta_offset_div2
            sh_r.sh_luma_tc_offset_div2 = ph.ph_luma_tc_offset_div2
            sh_r.sh_cb_beta_offset_div2 = ph.ph_cb_beta_offset_div2
            sh_r.sh_cb_tc_offset_div2 = ph.ph_cb_tc_offset_div2
            sh_r.sh_cr_beta_offset_div2 = ph.ph_cr_beta_offset_div2
            sh_r.sh_cr_tc_offset_div2 = ph.ph_cr_tc_offset_div2
        rpl = None
        if inter:
            weighted = bool(sps_raw.sps_weighted_pred_flag or
                            sps_raw.sps_weighted_bipred_flag)
            if ref_deltas is None:
                ref_deltas = ([-1] * n_refs[0], [-1] * n_refs[1])
            n_refs = (len(ref_deltas[0]), len(ref_deltas[1]))
            if info_in_ph and pps_raw.pps_rpl_info_in_ph_flag:
                sh_r.ref_pic_lists = ph.ph_ref_pic_lists
                if ph.ph_temporal_mvp_enabled_flag:
                    sh_r.sh_collocated_from_l0_flag = \
                        ph.ph_collocated_from_l0_flag
                    sh_r.sh_collocated_ref_idx = ph.ph_collocated_ref_idx
            else:
                if ph.ph_temporal_mvp_enabled_flag:
                    sh_r.sh_collocated_from_l0_flag, \
                        sh_r.sh_collocated_ref_idx = collocated_from
                sh_r.sh_ref_pic_lists = make_explicit_rpl(
                    *ref_deltas, weighted=weighted)
                sh_r.ref_pic_lists = sh_r.sh_ref_pic_lists
            sh_r.num_ref_idx_active = [min(1, n_refs[0]), 0]
            if slice_type == SLICE_B:
                sh_r.num_ref_idx_active[1] = min(1, n_refs[1])
            if n_refs[0] > 1 or (slice_type == SLICE_B and n_refs[1] > 1):
                sh_r.sh_num_ref_idx_active_override_flag = 1
                sh_r.sh_num_ref_idx_active_minus1 = [max(0, n_refs[0] - 1),
                                                     max(0, n_refs[1] - 1)]
                sh_r.num_ref_idx_active = [n_refs[0], 0]
                if slice_type == SLICE_B:
                    sh_r.num_ref_idx_active[1] = n_refs[1]
            rpl = []
            for lx in range(2):
                rp = derived.RefPicList()
                base = poc
                for d in ref_deltas[lx]:
                    if isinstance(d, tuple):   # ("lt"/"ltmsb", abs poc)
                        rp.add(d[1], True, None)
                        continue
                    base += d
                    rp.add(base, False, None)
                rpl.append(rp)
            shared_rpl = rpl
        if not inter and not idr:
            # non-IDR intra (GDR / TRAIL-I): empty ref pic lists
            sh_r.sh_ref_pic_lists = make_explicit_rpl([], [])
            sh_r.ref_pic_lists = sh_r.sh_ref_pic_lists
            sh_r.num_ref_idx_active = [0, 0]
        if inter and not pps_raw.pps_wp_info_in_ph_flag and \
                ((pps_raw.pps_weighted_pred_flag and
                  slice_type == SLICE_P) or
                 (pps_raw.pps_weighted_bipred_flag and
                  slice_type == SLICE_B)):
            sh_r.sh_pred_weight_table = make_pwt(
                policy.rng, sps_raw, sh_r.num_ref_idx_active[0],
                sh_r.num_ref_idx_active[1],
                bool(pps_raw.pps_weighted_bipred_flag and n_refs[1]))

        sh = derived.SH(sh_r, ph, sps, pps)
        if rpl is not None and sps_raw.sps_smvd_enabled_flag:
            derived.smvd_ref_idx(sh, rpl, poc)
        engine = CabacEncoder()
        coder = CtuCoder(engine, sps, pps, sh, tabs, policy=policy)
        coder.coeff_enc_cb = policy.coeffs
        if alf_aps is not None:
            coder.num_chroma_alt_filters = \
                alf_aps.alf_chroma_num_alt_filters_minus1 + 1
            if ccalf:
                coder.num_cc_filters = (
                    alf_aps.alf_cc_cb_filters_signalled_minus1 + 1,
                    alf_aps.alf_cc_cr_filters_signalled_minus1 + 1)
        if rpl is not None:
            coder.rpl = rpl
            coder.poc = poc
            if ph.ph_temporal_mvp_enabled_flag:
                coder.collocated_ref = collocated
        chunks = []
        started = False
        wpp_states = None
        ctu_addrs = sh.ctu_addrs
        qpc = max(0, min(63, sh.slice_qp_y))
        for ctu_idx, rs in enumerate(ctu_addrs):
            rx = rs % pps.ctb_width
            ry = rs // pps.ctb_width
            first_in_tile = rx == pps.ctb_to_col_bd[rx] and \
                ry == pps.ctb_to_row_bd[ry]
            first_in_wpp_row = wpp and ctu_idx and \
                rx == pps.ctb_to_col_bd[rx] and not first_in_tile
            if ctu_idx == 0 or first_in_tile or first_in_wpp_row:
                if started:
                    chunks.append(engine.bytes_aligned())
                    engine = CabacEncoder()
                    coder.e = engine
                if first_in_wpp_row:
                    engine.states = tuple(list(x) for x in wpp_states)
                else:
                    engine.states = make_states(qpc, sh.cabac_init_type)
                coder.init_stat_coeff()
                started = True
            coder.coding_tree_unit(ctu_idx, rs, rx, ry, len(ctu_addrs),
                                   sh.slice_idx)
            if wpp and rx == pps.ctb_to_col_bd[rx]:
                wpp_states = tuple(list(x) for x in engine.states)
        chunks.append(engine.bytes_aligned())
        if sps_raw.sps_entry_point_offsets_present_flag and len(chunks) > 1:
            lens = _epb_chunk_lens(chunks)
            offs = [l - 1 for l in lens[:-1]]
            sh_r.num_entry_points = len(chunks) - 1
            sh_r.sh_entry_point_offset_minus1 = offs
            sh_r.sh_entry_offset_len_minus1 = \
                max(max(offs).bit_length(), 1) - 1 if offs else 0
        w = write_slice_header(sh_r, sps_raw, pps_raw, ph)
        sh_bytes = w.bytes()
        out += write_nal(nal_type, sh_bytes + b"".join(chunks))

    shim = ColFrameShim(poc, tabs, shared_rpl or
                        [derived.RefPicList(), derived.RefPicList()],
                        sps.ctb_log2_size_y)
    return out, shim


def build_tiled_pps(sps, col_widths, row_heights, lf_across_tiles=1,
                    lf_across_slices=1, **kw):
    """PPS with an explicit tile grid (raster-scan slices).  col_widths /
    row_heights in CTUs, must cover the picture exactly."""
    pps = build_pps(sps, **kw)
    pps.pps_no_pic_partition_flag = 0
    pps.pps_log2_ctu_size_minus5 = sps.sps_log2_ctu_size_minus5
    pps.pps_num_exp_tile_columns_minus1 = len(col_widths) - 1
    pps.pps_num_exp_tile_rows_minus1 = len(row_heights) - 1
    pps.pps_tile_column_width_minus1 = [w - 1 for w in col_widths]
    pps.pps_tile_row_height_minus1 = [h - 1 for h in row_heights]
    pps.pps_loop_filter_across_tiles_enabled_flag = lf_across_tiles
    pps.pps_rect_slice_flag = 0
    pps.pps_loop_filter_across_slices_enabled_flag = lf_across_slices
    # derived fields the PPS writer consults
    pps.num_tile_columns = len(col_widths)
    pps.num_tile_rows = len(row_heights)
    pps.num_tiles_in_pic = len(col_widths) * len(row_heights)
    pps.col_width_val = list(col_widths)
    pps.row_height_val = list(row_heights)
    return pps


def forge_inter_stream(seed=0, width=64, height=64, qp=32, bit_depth=8,
                       nframes=3, slice_type=SLICE_P, n_refs=None,
                       deblock=True, pps_kw=None, info_in_ph=False,
                       ph_kw=None, **sps_kw):
    """IDR + (P|B)-frame stream exercising the inter path.  Each inter frame
    references the previous decoded frame(s) via explicit slice RPLs.
    info_in_ph: move RPL/WP/QP-delta/SAO/ALF/deblock signalling into a
    standalone picture header (pps_*_info_in_ph_flag; reference read-side
    cbs_h266_syntax_template.c picture_header_structure)."""
    sps_r = build_sps(width, height, bit_depth=bit_depth, min_qt_log2=2,
                      max_mtt_depth=2, **sps_kw)
    pps_kw = dict(pps_kw or {})
    if not deblock:
        pps_kw.update(pps_deblocking_filter_control_present_flag=1,
                      pps_deblocking_filter_disabled_flag=1)
    if info_in_ph:
        pps_kw.update(pps_rpl_info_in_ph_flag=1, pps_sao_info_in_ph_flag=1,
                      pps_alf_info_in_ph_flag=1,
                      pps_qp_delta_info_in_ph_flag=1)
        if sps_r.sps_weighted_pred_flag or sps_r.sps_weighted_bipred_flag:
            pps_kw.update(pps_wp_info_in_ph_flag=1)
        if deblock:
            pps_kw.update(pps_deblocking_filter_control_present_flag=1,
                          pps_deblocking_filter_override_enabled_flag=1,
                          pps_dbf_info_in_ph_flag=1)
        # the in-PH flag group is only coded with a picture partition
        # (h266.py:1159); use a 2-column tile grid + one raster slice
        # (a 1x1 grid would infer pps_rect_slice_flag=1 + single-slice-
        # per-subpic, which crashes the oracle's CBS — see
        # forge_subpic_stream)
        sps_r.sps_entry_point_offsets_present_flag = 1
        ctu = 1 << (sps_r.sps_log2_ctu_size_minus5 + 5)
        w_ctu = -(-width // ctu)
        h_ctu = -(-height // ctu)
        assert w_ctu >= 2, "info_in_ph forge needs >= 2 CTU columns"
        pps_r = build_tiled_pps(sps_r, (w_ctu - w_ctu // 2, w_ctu // 2),
                                (h_ctu,), **pps_kw)
    else:
        pps_r = build_pps(sps_r, **pps_kw)
    if n_refs is None:
        n_refs = (1, 1) if slice_type == SLICE_B else (1, 0)
    stream = write_nal(NalType.SPS, write_sps(sps_r))
    stream += write_nal(NalType.PPS, write_pps(pps_r, sps_r))
    policy = FuzzPolicy(seed)
    alf_aps = None
    ccalf = bool(sps_r.sps_ccalf_enabled_flag)
    if sps_r.sps_alf_enabled_flag:
        alf_aps = make_alf_aps(policy.rng,
                               chroma=bool(sps_r.sps_chroma_format_idc),
                               ccalf=ccalf)
        stream += write_nal(NalType.PREFIX_APS, write_aps(alf_aps))
    lmcs_aps = None
    if sps_r.sps_lmcs_enabled_flag:
        lmcs_aps = make_lmcs_aps(policy.rng,
                                 chroma=bool(sps_r.sps_chroma_format_idc),
                                 bit_depth=bit_depth)
        stream += write_nal(NalType.PREFIX_APS, write_aps(lmcs_aps))
    scaling_aps = None
    if sps_r.sps_explicit_scaling_list_enabled_flag:
        scaling_aps = make_scaling_aps(
            policy.rng, chroma=bool(sps_r.sps_chroma_format_idc))
        stream += write_nal(NalType.PREFIX_APS, write_aps(scaling_aps))
    prev = None
    for i in range(nframes):
        if i == 0:
            nal, prev = forge_frame(sps_r, pps_r, policy, qp=qp, poc=0,
                                    idr=True, alf_aps=alf_aps, ccalf=ccalf,
                                    lmcs_aps=lmcs_aps,
                                    scaling_aps=scaling_aps,
                                    info_in_ph=info_in_ph, ph_kw=ph_kw)
        else:
            nr = (min(i, n_refs[0]), min(i, n_refs[1])
                  if slice_type == SLICE_B else 0)
            nal, prev = forge_frame(sps_r, pps_r, policy, qp=qp, poc=i,
                                    idr=False, slice_type=slice_type,
                                    n_refs=nr, collocated=prev,
                                    alf_aps=alf_aps, ccalf=ccalf,
                                    lmcs_aps=lmcs_aps,
                                    scaling_aps=scaling_aps,
                                    info_in_ph=info_in_ph, ph_kw=ph_kw)
        stream += nal
    return stream
