# Frozen copy of ffvvc_tpu_torch/ctu.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: imports data and bufpool from the package root; the native
#   C tree parser (`native_tree`, its attribute and both branches in
#   `coding_tree_unit`) is removed: the Python coding-tree walk always runs.
"""CTU-level syntax: coding tree, coding units, transform tree, per-CTU
SAO/ALF parameters — bidirectional (decode + forge encode).

The parse emits dense per-frame tensors (FrameTabs) — the TPU-first
"plane-of-arrays" layout that the device reconstruction consumes — plus an
ordered CU list per CTU for the reconstruction walk.

Reference analogue: libavcodec/vvc/vvc_ctu.c
(hls_coding_tree :2030, hls_coding_unit :1732, can_split :521,
hls_transform_unit :314, QP derivation :77-212, neighbour :2468-2509,
hls_sao :2147, alf_params :2216) and the syntax-element decoders of
vvc_cabac.c.
"""
from __future__ import annotations

import numpy as np

from .cabac.engine import CTX, CabacDecoder, CabacEncoder, make_states
from .residual import TransformBlock, code_residual, ilog2
from .bitstream.h266 import SLICE_I

# tree / mode enums
SINGLE_TREE, DUAL_TREE_LUMA, DUAL_TREE_CHROMA = 0, 1, 2
MODE_TYPE_ALL, MODE_TYPE_INTER, MODE_TYPE_INTRA = 0, 1, 2
SPLIT_NONE, SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER, SPLIT_BT_VER, SPLIT_QT = \
    0, 1, 2, 3, 4, 5
MODE_INTER, MODE_INTRA, MODE_SKIP, MODE_PLT, MODE_IBC = 0, 1, 2, 3, 4
ISP_NO_SPLIT, ISP_HOR_SPLIT, ISP_VER_SPLIT = 0, 1, 2
MTS_DCT2_DCT2, MTS_DST7_DST7, MTS_DST7_DCT8, MTS_DCT8_DST7, MTS_DCT8_DCT8 = range(5)
LUMA, CB, CR, JCBCR = 0, 1, 2, 3

INTRA_PLANAR, INTRA_DC = 0, 1
INTRA_HORZ, INTRA_DIAG, INTRA_VERT, INTRA_VDIAG = 18, 34, 50, 66
INTRA_LT_CCLM, INTRA_L_CCLM, INTRA_T_CCLM = 81, 82, 83
INTRA_INVALID = -1

MIN_TU_LOG2 = 2
SAO_NOT_APPLIED, SAO_BAND, SAO_EDGE = 0, 1, 2


class CodingUnit:
    __slots__ = (
        "x0", "y0", "cb_width", "cb_height", "cqt_depth", "tree_type",
        "ch_type", "pred_mode", "skip_flag", "coded_flag",
        "intra_pred_mode_y", "intra_pred_mode_c", "intra_luma_ref_idx",
        "intra_mip_flag", "mip_transposed", "mip_mode",
        "isp_split_type", "num_intra_subpartitions", "bdpcm_flag",
        "mip_chroma_direct_flag", "lfnst_idx", "mts_idx", "apply_lfnst_flag",
        "sbt_flag", "sbt_horizontal_flag", "sbt_pos_flag",
        "qp", "tus", "pu", "act_enabled_flag", "ciip_flag")

    def __init__(self, x0, y0, w, h, cqt_depth, tree_type):
        self.x0 = x0
        self.y0 = y0
        self.cb_width = w
        self.cb_height = h
        self.cqt_depth = cqt_depth
        self.tree_type = tree_type
        self.ch_type = 1 if tree_type == DUAL_TREE_CHROMA else 0
        self.pred_mode = MODE_INTRA
        self.skip_flag = 0
        self.coded_flag = 1
        self.intra_pred_mode_y = INTRA_PLANAR
        self.intra_pred_mode_c = INTRA_PLANAR
        self.intra_luma_ref_idx = 0
        self.intra_mip_flag = 0
        self.mip_transposed = 0
        self.mip_mode = 0
        self.isp_split_type = ISP_NO_SPLIT
        self.num_intra_subpartitions = 1
        self.bdpcm_flag = [0, 0, 0]
        self.mip_chroma_direct_flag = 0
        self.lfnst_idx = 0
        self.mts_idx = MTS_DCT2_DCT2
        self.apply_lfnst_flag = [0, 0, 0]
        self.sbt_flag = 0
        self.sbt_horizontal_flag = 0
        self.sbt_pos_flag = 0
        self.act_enabled_flag = 0
        self.ciip_flag = 0
        self.qp = [0, 0, 0, 0]
        self.tus = []
        self.pu = None


class MotionInfo:
    """Reference MotionInfo (vvc_ctu.h): up to 3 control-point MVs per list."""
    __slots__ = ("pred_flag", "mv", "ref_idx", "bcw_idx", "hpel_if_idx",
                 "motion_model_idc", "num_sb_x", "num_sb_y")

    def __init__(self):
        self.pred_flag = 0
        self.mv = [[[0, 0], [0, 0], [0, 0]], [[0, 0], [0, 0], [0, 0]]]
        self.ref_idx = [0, 0]
        self.bcw_idx = 0
        self.hpel_if_idx = 0
        self.motion_model_idc = 0
        self.num_sb_x = self.num_sb_y = 1


class PredictionUnit:
    """Reference PredictionUnit (vvc_ctu.h)."""
    __slots__ = ("general_merge_flag", "mmvd_merge_flag", "merge_gpm_flag",
                 "gpm_partition_idx", "gpm_mv", "inter_affine_flag",
                 "merge_subblock_flag", "sym_mvd_flag", "dmvr_flag",
                 "bdof_flag", "cb_prof_flag", "diff_mv_x", "diff_mv_y", "mi")

    def __init__(self):
        self.general_merge_flag = 0
        self.mmvd_merge_flag = 0
        self.merge_gpm_flag = 0
        self.gpm_partition_idx = 0
        self.gpm_mv = None
        self.inter_affine_flag = 0
        self.merge_subblock_flag = 0
        self.sym_mvd_flag = 0
        self.dmvr_flag = 0
        self.bdof_flag = 0
        self.cb_prof_flag = [0, 0]
        self.diff_mv_x = [None, None]
        self.diff_mv_y = [None, None]
        self.mi = MotionInfo()


class TransformUnit:
    __slots__ = ("x0", "y0", "width", "height", "coded_flag",
                 "joint_cbcr_residual_flag", "tbs")

    def __init__(self, x0, y0, w, h):
        self.x0 = x0
        self.y0 = y0
        self.width = w
        self.height = h
        self.coded_flag = [0, 0, 0]
        self.joint_cbcr_residual_flag = 0
        self.tbs = []


class FrameTabs:
    """Dense per-frame metadata planes (reference fc->tab, vvcdec.h:122-187).

    All per-4x4-sample grids (int32), plus per-CTU parameter arrays — the
    tensorization blueprint for the TPU recon path.
    """

    def __init__(self, sps, pps):
        w4 = -(-pps.width // 4)
        h4 = -(-pps.height // 4)
        self.w4, self.h4 = w4, h4
        g = lambda: np.zeros((h4, w4), dtype=np.int32)
        self.qp = [g(), g(), g(), g()]       # per plane + jcbcr
        self.cpm = [g(), g()]                # pred mode per ch_type
        self.ipm = g()                       # luma intra mode
        self.imf = g()                       # mip flag
        self.imtf = g()                      # mip transposed
        self.imm = g()                       # mip mode
        self.skip = g()
        self.cb_width = [g(), g()]
        self.cb_height = [g(), g()]
        self.cb_pos_x = [g(), g()]
        self.cb_pos_y = [g(), g()]
        self.cqt_depth = [g(), g()]
        self.tu_coded_flag = [g(), g(), g()]
        self.tu_joint_cbcr = g()
        self.tb_pos_x = [g(), g()]           # [is_chroma]
        self.tb_pos_y = [g(), g()]
        self.tb_width = [g(), g()]
        self.tb_height = [g(), g()]
        self.pcmf = [g(), g()]               # bdpcm per ch_type
        self.msf = g()                       # merge subblock flag (inter ctx)
        self.iaf = g()                       # inter affine flag (inter ctx)
        self.mmi = g()                       # motion model idc (affine nb)
        # affine control-point MVs, replicated per 4x4 within each CU
        # (reference fc->tab.cp_mv on the min-CB grid, vvc_mvs.c:384)
        self.cp_mv = np.zeros((2, h4, w4, 3, 2), dtype=np.int32)
        # MV field grids, per 4x4 (reference fc->tab.mvf, vvcdec.h:140):
        self.mvf_pf = np.zeros((h4, w4), dtype=np.uint8)   # PF_INTRA=0
        self.mvf_mv = np.zeros((2, h4, w4, 2), dtype=np.int32)
        self.mvf_ref = np.zeros((2, h4, w4), dtype=np.int8)
        self.mvf_bcw = np.zeros((h4, w4), dtype=np.int8)
        self.mvf_hpel = np.zeros((h4, w4), dtype=np.int8)
        self.mvf_ciip = np.zeros((h4, w4), dtype=np.int8)
        # post-DMVR MV grid used by later frames' TMVP (ref->tab_dmvr_mvf,
        # vvc_ctu.c:1697 fill_dmvr_info / vvc_inter.c:750 set_dmvr_info)
        self.col_pf = np.zeros((h4, w4), dtype=np.uint8)
        self.col_mv = np.zeros((2, h4, w4, 2), dtype=np.int32)
        self.col_ref = np.zeros((2, h4, w4), dtype=np.int8)
        self.slice_idx = np.full((pps.ctb_height, pps.ctb_width), -1,
                                 dtype=np.int32)
        # 32x32 multi-split map + 64x64 isp flag map (cclm derivation)
        self.msm = np.zeros((2, -(-pps.height // 32), -(-pps.width // 32)),
                            dtype=np.int32)
        self.ispmf = np.zeros((-(-pps.height // 64), -(-pps.width // 64)),
                              dtype=np.int32)
        # per-CTU params
        nctb = pps.ctb_count
        self.sao_type = np.zeros((nctb, 3), dtype=np.int32)
        self.sao_band_pos = np.zeros((nctb, 3), dtype=np.int32)
        self.sao_eo_class = np.zeros((nctb, 3), dtype=np.int32)
        self.sao_offset = np.zeros((nctb, 3, 5), dtype=np.int32)
        self.alf_ctb_flag = np.zeros((nctb, 3), dtype=np.int32)
        self.alf_aps_id = np.zeros((nctb, 3), dtype=np.int32)
        self.alf_fixed = np.zeros((nctb,), dtype=np.int32)  # luma: use fixed set
        self.alf_filt_idx = np.zeros((nctb,), dtype=np.int32)
        self.alf_alt_idx = np.zeros((nctb, 2), dtype=np.int32)
        self.alf_cc_idc = np.zeros((nctb, 2), dtype=np.int32)
        self.deblock_disabled = np.zeros((nctb,), dtype=np.int32)
        self.deblock_beta = np.zeros((nctb, 3), dtype=np.int32)
        self.deblock_tc = np.zeros((nctb, 3), dtype=np.int32)
        # CU lists per CTU (recon walk order)
        self.cus = [[] for _ in range(nctb)]

    # --- per-process pool (utils/bufpool): page-fault cost of ~40MB of
    # fresh per-frame planes dominates otherwise -------------------------

    @staticmethod
    def _pool_key(sps, pps):
        return ("tabs", pps.width, pps.height, pps.ctb_width,
                pps.ctb_height, sps.ctb_log2_size_y)

    @classmethod
    def acquire(cls, sps, pps):
        from . import bufpool
        key = cls._pool_key(sps, pps)
        t = bufpool.acquire(key)
        if t is None:
            return cls(sps, pps)
        t._reset()
        return t

    def recycle(self, sps, pps):
        from . import bufpool
        bufpool.release(self, self._pool_key(sps, pps))

    def _reset(self):
        """Zero every plane in place (matches a fresh __init__).  Walks
        vars() so fields added to __init__ are reset automatically; any
        non-zero-initialized field must be special-cased here."""
        for name, v in vars(self).items():
            if isinstance(v, np.ndarray):
                v.fill(0)
            elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
                for a in v:
                    a.fill(0)
        self.slice_idx.fill(-1)
        self.cus = [[] for _ in range(len(self.cus))]


def set_grid(tab, x0, y0, w, h, v):
    tab[y0 >> 2:(y0 + h) >> 2, x0 >> 2:(x0 + w) >> 2] = v


class AllowedSplit:
    __slots__ = ("qt", "btv", "bth", "ttv", "tth")


class CtuCoder:
    """Bidirectional CTU syntax coder over one entry point.

    decode mode: engine is a CabacDecoder; encode mode: a CabacEncoder plus a
    `policy(tag, **ctx)` callable making the forge's syntax choices.
    """

    def __init__(self, engine, sps, pps, sh, tabs: FrameTabs, policy=None):
        self.e = engine
        # decode mode = any engine exposing decode_bin (Python or native)
        self.decode = hasattr(engine, "decode_bin")
        self.policy = policy
        self.sps = sps
        self.pps = pps
        self.sh = sh
        self.tabs = tabs
        self.log2_transform_range = \
            max(15, min(20, sps.bit_depth + 6)) if sps.r.sps_extended_precision_flag \
            else 15
        # entry-point state
        self.qp_y = sh.slice_qp_y
        self.is_first_qg = True
        self.hmvp = []
        self.stat_coeff = [0, 0, 0]
        self.init_stat_coeff()
        # parse state
        self.parse = type("ParseState", (), {})()
        p = self.parse
        p.lfnst_dc_only = 1
        p.lfnst_zero_out_sig_coeff_flag = 1
        p.mts_dc_only = 1
        p.mts_zero_out_sig_coeff_flag = 1
        p.is_cu_qp_delta_coded = 0
        p.is_cu_chroma_qp_offset_coded = 0
        p.cu_qg_top_left_x = 0
        p.cu_qg_top_left_y = 0
        p.chroma_qp_offset = [0, 0, 0]
        p.prev_tu_cbf_y = 0
        p.infer_tu_cbf_luma = 1
        # neighbour state (per CTU)
        self.ctb_left_flag = False
        self.ctb_up_flag = False
        self.ctb_up_right_flag = False
        self.ctb_up_left_flag = False
        self.end_of_tiles_x = pps.width
        self.end_of_tiles_y = pps.height
        self.na = type("NA", (), {})()
        # derived slice partition params (reference VVCSH derive)
        r, ph = sh.r, sh.ph
        sr = sps.r
        min_cb = sps.min_cb_log2_size_y
        if sh.slice_type == SLICE_I:
            self.min_qt_size = [
                1 << (min_cb + ph.ph_log2_diff_min_qt_min_cb_intra_slice_luma),
                1 << (min_cb + ph.ph_log2_diff_min_qt_min_cb_intra_slice_chroma)]
            self.max_mtt_depth = [
                ph.ph_max_mtt_hierarchy_depth_intra_slice_luma,
                ph.ph_max_mtt_hierarchy_depth_intra_slice_chroma]
            self.max_bt_size = [
                self.min_qt_size[0] << ph.ph_log2_diff_max_bt_min_qt_intra_slice_luma,
                self.min_qt_size[1] << ph.ph_log2_diff_max_bt_min_qt_intra_slice_chroma]
            self.max_tt_size = [
                self.min_qt_size[0] << ph.ph_log2_diff_max_tt_min_qt_intra_slice_luma,
                self.min_qt_size[1] << ph.ph_log2_diff_max_tt_min_qt_intra_slice_chroma]
            self.cu_qp_delta_subdiv = ph.ph_cu_qp_delta_subdiv_intra_slice
            self.cu_chroma_qp_offset_subdiv = ph.ph_cu_chroma_qp_offset_subdiv_intra_slice
        else:
            mq = 1 << (min_cb + ph.ph_log2_diff_min_qt_min_cb_inter_slice)
            self.min_qt_size = [mq, mq]
            d = ph.ph_max_mtt_hierarchy_depth_inter_slice
            self.max_mtt_depth = [d, d]
            b = mq << ph.ph_log2_diff_max_bt_min_qt_inter_slice
            self.max_bt_size = [b, b]
            t = mq << ph.ph_log2_diff_max_tt_min_qt_inter_slice
            self.max_tt_size = [t, t]
            self.cu_qp_delta_subdiv = ph.ph_cu_qp_delta_subdiv_inter_slice
            self.cu_chroma_qp_offset_subdiv = ph.ph_cu_chroma_qp_offset_subdiv_inter_slice
        self.cu = None
        self.coeff_enc_cb = None  # forge: callback returning TB coeffs
        # per-slice inter state, attached by the decoder (reference
        # SliceContext: rpl, ff_vvc_slice_rpl vvc_refs.c:415)
        self.rpl = None             # [RefPicList, RefPicList]
        self.poc = 0
        self.collocated_ref = None  # DecodedFrame view for TMVP
        self.pwt = getattr(sh, "pwt", None)

    def init_stat_coeff(self):
        sps = self.sps
        v = 2 * ilog2(sps.bit_depth - 10) \
            if sps.r.sps_persistent_rice_adaptation_enabled_flag and \
            sps.bit_depth > 10 else 0
        if sps.r.sps_persistent_rice_adaptation_enabled_flag and sps.bit_depth <= 10:
            v = 0
        self.stat_coeff = [v, v, v]

    # --- engine helpers ---------------------------------------------------

    def bin(self, idx, tag=None, **ctx):
        if self.decode:
            return self.e.decode_bin(idx)
        v = int(self.policy(tag, **ctx))
        self.e.encode_bin(idx, v)
        return v

    def bin_val(self, idx, value):
        """Encode-mode: code a known value; decode-mode: read it."""
        if self.decode:
            return self.e.decode_bin(idx)
        self.e.encode_bin(idx, value)
        return value

    def bypass(self, tag=None, **ctx):
        if self.decode:
            return self.e.decode_bypass()
        v = int(self.policy(tag, **ctx))
        self.e.encode_bypass(v)
        return v

    def terminate(self, value=1):
        if self.decode:
            return self.e.decode_terminate()
        self.e.encode_terminate(value)
        return value

    # --- neighbour handling (vvc_ctu.c:2468-2509) -------------------------

    def decode_neighbour(self, x_ctb, y_ctb, rx, ry, rs):
        pps = self.pps
        ctb_size = self.sps.ctb_size_y
        self.end_of_tiles_x = pps.width
        self.end_of_tiles_y = pps.height
        if pps.ctb_to_col_bd[rx] != pps.ctb_to_col_bd[rx + 1]:
            self.end_of_tiles_x = min(x_ctb + ctb_size, self.end_of_tiles_x)
        if pps.ctb_to_row_bd[ry] != pps.ctb_to_row_bd[ry + 1]:
            self.end_of_tiles_y = min(y_ctb + ctb_size, self.end_of_tiles_y)
        bl_tile = rx > 0 and pps.ctb_to_col_bd[rx] != pps.ctb_to_col_bd[rx - 1]
        bl_slice = rx > 0 and self.tabs.slice_idx.flat[rs] != self.tabs.slice_idx.flat[rs - 1]
        bu_tile = ry > 0 and pps.ctb_to_row_bd[ry] != pps.ctb_to_row_bd[ry - 1]
        bu_slice = ry > 0 and \
            self.tabs.slice_idx.flat[rs] != self.tabs.slice_idx.flat[rs - pps.ctb_width]
        self.ctb_left_flag = rx > 0 and not bl_tile
        self.ctb_up_flag = ry > 0 and not bu_tile and not bu_slice
        self.ctb_up_right_flag = self.ctb_up_flag and \
            (pps.ctb_to_col_bd[rx] == pps.ctb_to_col_bd[rx + 1]) and \
            (pps.ctb_to_row_bd[ry] == pps.ctb_to_row_bd[ry - 1])
        self.ctb_up_left_flag = self.ctb_left_flag and self.ctb_up_flag

    def set_neighbour_available(self, x0, y0, w, h):
        log2_ctb = self.sps.ctb_log2_size_y
        x0b = x0 & ((1 << log2_ctb) - 1)
        y0b = y0 & ((1 << log2_ctb) - 1)
        na = self.na
        na.cand_up = bool(self.ctb_up_flag or y0b)
        na.cand_left = bool(self.ctb_left_flag or x0b)
        na.cand_up_left = (na.cand_left and na.cand_up) if (x0b or y0b) \
            else self.ctb_up_left_flag
        na.cand_up_right_sap = (self.ctb_up_right_flag and not y0b) \
            if (x0b + w == (1 << log2_ctb)) else na.cand_up
        na.cand_up_right = na.cand_up_right_sap and (x0 + w) < self.end_of_tiles_x

    def _left_top(self, tab, x0, y0, default=0):
        """get_left_top over a 4x4 grid table."""
        log2_ctb = self.sps.ctb_log2_size_y
        x0b = x0 & ((1 << log2_ctb) - 1)
        y0b = y0 & ((1 << log2_ctb) - 1)
        xc, yc = x0 >> 2, y0 >> 2
        left = top = default
        if self.ctb_left_flag or x0b:
            left = int(tab[yc, xc - 1])
        if self.ctb_up_flag or y0b:
            top = int(tab[yc - 1, xc])
        return left, top

    # --- coding tree (vvc_ctu.c:2030 + can_split :521) --------------------

    def can_split(self, x0, y0, w, h, mtt_depth, depth_offset, part_idx,
                  last_split, tree_type, mode_type):
        sps, pps = self.sps, self.pps
        chroma = 1 if tree_type == DUAL_TREE_CHROMA else 0
        a = AllowedSplit()
        a.qt = a.btv = a.bth = a.ttv = a.tth = 1
        min_cb = sps.min_cb_size_y
        if mtt_depth:
            a.qt = 0
        if w <= self.min_qt_size[chroma]:
            a.qt = 0
        if chroma:
            ca = (w >> sps.hshift[1]) * (h >> sps.vshift[1])
            cw = w >> sps.hshift[1]
            if cw == 8:
                a.ttv = 0
            elif cw <= 4:
                if cw == 4:
                    a.btv = 0
                a.qt = 0
            if mode_type == MODE_TYPE_INTRA:
                a.qt = a.btv = a.bth = a.ttv = a.tth = 0
            if ca <= 32:
                a.ttv = a.tth = 0
                if ca <= 16:
                    a.btv = a.bth = 0
        max_bt = self.max_bt_size[chroma]
        max_tt = min(64, self.max_tt_size[chroma])
        max_mtt = self.max_mtt_depth[chroma] + depth_offset
        if mode_type == MODE_TYPE_INTER:
            area = w * h
            if area == 32:
                a.btv = a.bth = 0
            elif area == 64:
                a.ttv = a.tth = 0
        if w <= 2 * min_cb:
            a.ttv = 0
            if w <= min_cb:
                a.btv = 0
        if h <= 2 * min_cb:
            a.tth = 0
            if h <= min_cb:
                a.bth = 0
        if w > max_bt or h > max_bt:
            a.btv = a.bth = 0
        if w > max_tt or h > max_tt:
            a.ttv = a.tth = 0
        if mtt_depth >= max_mtt:
            a.btv = a.bth = a.ttv = a.tth = 0
        if x0 + w > pps.width:
            a.ttv = a.tth = 0
            if h > 64:
                a.btv = 0
            if y0 + h <= pps.height:
                a.bth = 0
            elif w > self.min_qt_size[chroma]:
                a.btv = a.bth = 0
        if y0 + h > pps.height:
            a.btv = a.ttv = a.tth = 0
            if w > 64:
                a.bth = 0
        if mtt_depth > 0 and part_idx == 1:
            if last_split == SPLIT_TT_VER:
                a.btv = 0
            elif last_split == SPLIT_TT_HOR:
                a.bth = 0
        if w <= 64 and h > 64:
            a.btv = 0
        if w > 64 and h <= 64:
            a.bth = 0
        return a

    def split_cu_flag(self, x0, y0, w, h, chroma, a):
        pps = self.pps
        is_inside = (x0 + w <= pps.width) and (y0 + h <= pps.height)
        if (a.btv or a.bth or a.ttv or a.tth or a.qt) and is_inside:
            ch = chroma
            lh, tw = h, w
            left, top = self._left_top_pair(self.tabs.cb_height[ch],
                                            self.tabs.cb_width[ch], x0, y0, h, w)
            inc = int(left < h) + int(top < w)
            inc += (a.btv + a.bth + a.ttv + a.tth + 2 * a.qt - 1) // 2 * 3
            return self.bin(CTX.SPLIT_CU_FLAG + inc, "split_cu_flag",
                            x0=x0, y0=y0, w=w, h=h, allowed=a)
        return int(not is_inside)

    def _left_top_pair(self, left_tab, top_tab, x0, y0, ldef, tdef):
        log2_ctb = self.sps.ctb_log2_size_y
        x0b = x0 & ((1 << log2_ctb) - 1)
        y0b = y0 & ((1 << log2_ctb) - 1)
        xc, yc = x0 >> 2, y0 >> 2
        left, top = ldef, tdef
        if self.ctb_left_flag or x0b:
            left = int(left_tab[yc, xc - 1])
        if self.ctb_up_flag or y0b:
            top = int(top_tab[yc - 1, xc])
        return left, top

    def split_mode(self, x0, y0, w, h, cqt_depth, mtt_depth, ch_type, a):
        allow_no_qt = a.btv or a.bth or a.ttv or a.tth
        if allow_no_qt and a.qt:
            # split_qt_flag with depth context
            dl, dt = self._left_top_pair(self.tabs.cqt_depth[ch_type],
                                         self.tabs.cqt_depth[ch_type], x0, y0, 0, 0)
            inc = int(dl > cqt_depth) + int(dt > cqt_depth) + (cqt_depth >= 2) * 3
            split_qt = self.bin(CTX.SPLIT_QT_FLAG + inc, "split_qt_flag",
                                x0=x0, y0=y0, allowed=a)
        else:
            split_qt = int(not allow_no_qt or a.qt)
        if split_qt:
            return SPLIT_QT
        # mtt vertical flag
        if (a.bth or a.tth) and (a.btv or a.ttv):
            v = a.btv + a.ttv
            hh = a.bth + a.tth
            if v > hh:
                inc = 4
            elif v < hh:
                inc = 3
            else:
                sps = self.sps
                log2_ctb = sps.ctb_log2_size_y
                x0b = x0 & ((1 << log2_ctb) - 1)
                y0b = y0 & ((1 << log2_ctb) - 1)
                avail_a = bool(self.ctb_up_flag or y0b)
                avail_l = bool(self.ctb_left_flag or x0b)
                xc, yc = x0 >> 2, y0 >> 2
                da = w // (int(self.tabs.cb_width[ch_type][yc - 1, xc]) if avail_a else 1)
                dl = h // (int(self.tabs.cb_height[ch_type][yc, xc - 1]) if avail_l else 1)
                if da == dl or not avail_a or not avail_l:
                    inc = 0
                elif da < dl:
                    inc = 1
                else:
                    inc = 2
            vertical = self.bin(CTX.MTT_SPLIT_CU_VERTICAL_FLAG + inc,
                                "mtt_vertical", x0=x0, y0=y0, allowed=a)
        else:
            vertical = int(not (a.bth or a.tth))
        if (a.btv and a.ttv and vertical) or (a.bth and a.tth and not vertical):
            inc = 2 * vertical + (1 if mtt_depth <= 1 else 0)
            binary = self.bin(CTX.MTT_SPLIT_CU_BINARY_FLAG + inc,
                              "mtt_binary", x0=x0, y0=y0, allowed=a,
                              vertical=vertical)
        else:
            if not a.btv and not a.bth:
                binary = 0
            elif not a.ttv and not a.tth:
                binary = 1
            elif a.bth and a.ttv:
                binary = 1 - vertical
            else:
                binary = vertical
        return (SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER, SPLIT_BT_VER)[
            (vertical << 1) + binary]

    def mode_type(self, x0, y0, w, h, split, ch_type, mode_type_curr):
        rsh = self.sh.r
        sps = self.sps
        area = w * h
        cond = 0
        if not ((rsh.sh_slice_type == SLICE_I and sps.r.sps_qtbtt_dual_tree_intra_flag)
                or mode_type_curr != MODE_TYPE_ALL or not sps.chroma_format_idc
                or sps.chroma_format_idc == 3):
            if (area == 64 and split in (SPLIT_QT, SPLIT_TT_HOR, SPLIT_TT_VER)) or \
                    (area == 32 and split in (SPLIT_BT_HOR, SPLIT_BT_VER)):
                cond = 1
            elif (area == 64 and split in (SPLIT_BT_HOR, SPLIT_BT_VER) and
                  sps.chroma_format_idc == 1) or \
                    (area == 128 and split in (SPLIT_TT_HOR, SPLIT_TT_VER) and
                     sps.chroma_format_idc == 1) or \
                    (w == 8 and split == SPLIT_BT_VER) or \
                    (w == 16 and split == SPLIT_TT_VER):
                cond = 1 + (rsh.sh_slice_type != SLICE_I)
        if cond == 1:
            return MODE_TYPE_INTRA
        if cond == 2:
            left, top = self._left_top_pair(self.tabs.cpm[ch_type],
                                            self.tabs.cpm[ch_type], x0, y0, 0, 0)
            inc = int(bool(left) or bool(top))
            v = self.bin(CTX.NON_INTER_FLAG + inc, "non_inter_flag", x0=x0, y0=y0)
            return MODE_TYPE_INTRA if v else MODE_TYPE_INTER
        return mode_type_curr

    def coding_tree(self, x0, y0, w, h, qg_on_y, qg_on_c, cb_sub_div,
                    cqt_depth, mtt_depth, depth_offset, part_idx,
                    last_split, tree_type_curr, mode_type_curr):
        pps = self.pps
        rsh = self.sh.r
        p = self.parse
        ch_type = 1 if tree_type_curr == DUAL_TREE_CHROMA else 0
        if pps.r.pps_cu_qp_delta_enabled_flag and qg_on_y and \
                cb_sub_div <= self.cu_qp_delta_subdiv:
            p.is_cu_qp_delta_coded = 0
            p.cu_qg_top_left_x = x0
            p.cu_qg_top_left_y = y0
        if rsh.sh_cu_chroma_qp_offset_enabled_flag and qg_on_c and \
                cb_sub_div <= self.cu_chroma_qp_offset_subdiv:
            p.is_cu_chroma_qp_offset_coded = 0
            p.chroma_qp_offset = [0, 0, 0]
        a = self.can_split(x0, y0, w, h, mtt_depth, depth_offset, part_idx,
                           last_split, tree_type_curr, mode_type_curr)
        if self.split_cu_flag(x0, y0, w, h, ch_type, a):
            split = self.split_mode(x0, y0, w, h, cqt_depth, mtt_depth, ch_type, a)
            mode_type = self.mode_type(x0, y0, w, h, split, ch_type, mode_type_curr)
            tree_type = DUAL_TREE_LUMA if mode_type == MODE_TYPE_INTRA \
                else tree_type_curr
            if split != SPLIT_QT:
                if not (x0 & 31) and not (y0 & 31) and mtt_depth <= 1:
                    self.tabs.msm[mtt_depth][y0 >> 5, x0 >> 5] = split
            self._do_split(split, x0, y0, w, h, qg_on_y, qg_on_c, cb_sub_div,
                           cqt_depth, mtt_depth, depth_offset, tree_type, mode_type)
            if mode_type_curr == MODE_TYPE_ALL and mode_type == MODE_TYPE_INTRA:
                self.coding_tree(x0, y0, w, h, 0, qg_on_c, cb_sub_div,
                                 cqt_depth, mtt_depth, 0, 0, split,
                                 DUAL_TREE_CHROMA, mode_type)
        else:
            self.coding_unit(x0, y0, w, h, cqt_depth, tree_type_curr,
                             mode_type_curr)

    def _do_split(self, split, x0, y0, w, h, qg_on_y, qg_on_c, cb_sub_div,
                  cqt_depth, mtt_depth, depth_offset, tree_type, mode_type):
        pps = self.pps
        ct = self.coding_tree
        if split == SPLIT_BT_VER:
            depth_offset += 1 if x0 + w > pps.width else 0
            x1 = x0 + w // 2
            ct(x0, y0, w // 2, h, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
               mtt_depth + 1, depth_offset, 0, SPLIT_BT_VER, tree_type, mode_type)
            if x1 < pps.width:
                ct(x1, y0, w // 2, h, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
                   mtt_depth + 1, depth_offset, 1, SPLIT_BT_VER, tree_type, mode_type)
        elif split == SPLIT_BT_HOR:
            depth_offset += 1 if y0 + h > pps.height else 0
            y1 = y0 + h // 2
            ct(x0, y0, w, h // 2, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
               mtt_depth + 1, depth_offset, 0, SPLIT_BT_HOR, tree_type, mode_type)
            if y1 < pps.height:
                ct(x0, y1, w, h // 2, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
                   mtt_depth + 1, depth_offset, 1, SPLIT_BT_HOR, tree_type, mode_type)
        elif split == SPLIT_TT_VER:
            qg_on_y = qg_on_y and (cb_sub_div + 2 <= self.cu_qp_delta_subdiv)
            qg_on_c = qg_on_c and (cb_sub_div + 2 <= self.cu_chroma_qp_offset_subdiv)
            x1, x2 = x0 + w // 4, x0 + 3 * w // 4
            ct(x0, y0, w // 4, h, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
               mtt_depth + 1, depth_offset, 0, SPLIT_TT_VER, tree_type, mode_type)
            ct(x1, y0, w // 2, h, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
               mtt_depth + 1, depth_offset, 1, SPLIT_TT_VER, tree_type, mode_type)
            ct(x2, y0, w // 4, h, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
               mtt_depth + 1, depth_offset, 2, SPLIT_TT_VER, tree_type, mode_type)
        elif split == SPLIT_TT_HOR:
            qg_on_y = qg_on_y and (cb_sub_div + 2 <= self.cu_qp_delta_subdiv)
            qg_on_c = qg_on_c and (cb_sub_div + 2 <= self.cu_chroma_qp_offset_subdiv)
            y1, y2 = y0 + h // 4, y0 + 3 * h // 4
            ct(x0, y0, w, h // 4, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
               mtt_depth + 1, depth_offset, 0, SPLIT_TT_HOR, tree_type, mode_type)
            ct(x0, y1, w, h // 2, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
               mtt_depth + 1, depth_offset, 1, SPLIT_TT_HOR, tree_type, mode_type)
            ct(x0, y2, w, h // 4, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
               mtt_depth + 1, depth_offset, 2, SPLIT_TT_HOR, tree_type, mode_type)
        else:  # SPLIT_QT
            x1, y1 = x0 + w // 2, y0 + h // 2
            ct(x0, y0, w // 2, h // 2, qg_on_y, qg_on_c, cb_sub_div + 2,
               cqt_depth + 1, 0, 0, 0, SPLIT_QT, tree_type, mode_type)
            if x1 < pps.width:
                ct(x1, y0, w // 2, h // 2, qg_on_y, qg_on_c, cb_sub_div + 2,
                   cqt_depth + 1, 0, 0, 1, SPLIT_QT, tree_type, mode_type)
            if y1 < pps.height:
                ct(x0, y1, w // 2, h // 2, qg_on_y, qg_on_c, cb_sub_div + 2,
                   cqt_depth + 1, 0, 0, 2, SPLIT_QT, tree_type, mode_type)
            if x1 < pps.width and y1 < pps.height:
                ct(x1, y1, w // 2, h // 2, qg_on_y, qg_on_c, cb_sub_div + 2,
                   cqt_depth + 1, 0, 0, 3, SPLIT_QT, tree_type, mode_type)

    # --- coding unit (vvc_ctu.c:1732) --------------------------------------

    def coding_unit(self, x0, y0, w, h, cqt_depth, tree_type, mode_type):
        sps = self.sps
        rsh = self.sh.r
        is_128 = w > 64 or h > 64
        cu = CodingUnit(x0, y0, w, h, cqt_depth, tree_type)
        self.cu = cu
        self.cur_cus.append(cu)
        # per-CU parse state (reference add_cu, vvc_ctu.c:1205)
        self.parse.prev_tu_cbf_y = 0
        # cb geometry grids are written at CU *alloc* time (reference
        # set_cb_pos, vvc_ctu.c:1226) — the ISP-last-TU chroma lookup in
        # transform_unit reads them mid-CU (vvc_ctu.c:336-342).
        tabs = self.tabs
        ch = cu.ch_type
        set_grid(tabs.cb_pos_x[ch], x0, y0, w, h, x0)
        set_grid(tabs.cb_pos_y[ch], x0, y0, w, h, y0)
        set_grid(tabs.cb_width[ch], x0, y0, w, h, w)
        set_grid(tabs.cb_height[ch], x0, y0, w, h, h)
        set_grid(tabs.cqt_depth[ch], x0, y0, w, h, cqt_depth)
        self.set_neighbour_available(x0, y0, w, h)
        if rsh.sh_slice_type == SLICE_I and is_128:
            mode_type = MODE_TYPE_INTRA
        cu.pred_mode = self.pred_mode_decode(tree_type, mode_type)
        if cu.pred_mode == MODE_INTRA and sps.r.sps_palette_enabled_flag:
            raise NotImplementedError("palette")
        if cu.pred_mode == MODE_INTRA and sps.r.sps_act_enabled_flag and \
                tree_type == SINGLE_TREE:
            raise NotImplementedError("ACT")
        if cu.pred_mode in (MODE_INTRA, MODE_PLT):
            if tree_type in (SINGLE_TREE, DUAL_TREE_LUMA):
                self.intra_luma_pred_modes(cu)
                self.set_intra_mvf(cu)
            if tree_type in (SINGLE_TREE, DUAL_TREE_CHROMA) and sps.chroma_format_idc:
                self.intra_chroma_pred_modes(cu)
        elif tree_type != DUAL_TREE_CHROMA:
            self.inter_data(cu)
        general_merge = cu.pu.general_merge_flag if cu.pu else 0
        if cu.pred_mode != MODE_INTRA and not general_merge:
            cu.coded_flag = self.bin(CTX.CU_CODED_FLAG, "cu_coded_flag",
                                     x0=x0, y0=y0)
        else:
            cu.coded_flag = int(not cu.skip_flag)
        if cu.coded_flag:
            self.sbt_info(cu)
            p = self.parse
            p.lfnst_dc_only = 1
            p.lfnst_zero_out_sig_coeff_flag = 1
            p.mts_dc_only = 1
            p.mts_zero_out_sig_coeff_flag = 1
            self.transform_tree(cu, x0, y0, w, h, cu.ch_type)
            cu.lfnst_idx = self.lfnst_idx_decode(cu)
            cu.mts_idx = self.mts_idx_decode(cu)
            self.set_qp_c(cu)
        else:
            assert tree_type == SINGLE_TREE
            self.skipped_transform_tree_unit(cu)
        self.set_cu_tabs(cu)

    def pred_mode_decode(self, tree_type, mode_type):
        cu = self.cu
        sps = self.sps
        rsh = self.sh.r
        tabs = self.tabs
        ch_type = 1 if tree_type == DUAL_TREE_CHROMA else 0
        is_4x4 = cu.cb_width == 4 and cu.cb_height == 4
        is_i = rsh.sh_slice_type == SLICE_I
        cu.skip_flag = 0
        if not is_i or sps.r.sps_ibc_enabled_flag:
            is_128 = cu.cb_width == 128 or cu.cb_height == 128
            if tree_type != DUAL_TREE_CHROMA and \
                    ((not is_4x4 and mode_type != MODE_TYPE_INTRA) or
                     (sps.r.sps_ibc_enabled_flag and not is_128)):
                left, top = self._left_top_pair(tabs.skip, tabs.skip,
                                                cu.x0, cu.y0, 0, 0)
                inc = left + top
                cu.skip_flag = self.bin(CTX.CU_SKIP_FLAG + inc, "cu_skip_flag",
                                        x0=cu.x0, y0=cu.y0)
            if is_4x4 or mode_type == MODE_TYPE_INTRA or is_i:
                pred_mode_flag = 1
            elif mode_type == MODE_TYPE_INTER or cu.skip_flag:
                pred_mode_flag = 0
            else:
                left, top = self._left_top_pair(tabs.cpm[ch_type], tabs.cpm[ch_type],
                                                cu.x0, cu.y0, 0, 0)
                inc = int(bool(left) or bool(top))
                pred_mode_flag = self.bin(CTX.PRED_MODE_FLAG + inc,
                                          "pred_mode_flag", x0=cu.x0, y0=cu.y0)
            pred_mode = MODE_INTRA if pred_mode_flag else MODE_INTER
            if sps.r.sps_ibc_enabled_flag:
                raise NotImplementedError("IBC")
        else:
            pred_mode_flag = int(is_4x4 or mode_type == MODE_TYPE_INTRA or
                                 mode_type != MODE_TYPE_INTER or is_i)
            pred_mode = MODE_INTRA if pred_mode_flag else MODE_INTER
        set_grid(tabs.cpm[cu.ch_type], cu.x0, cu.y0, cu.cb_width, cu.cb_height,
                 pred_mode)
        if tree_type == SINGLE_TREE:
            set_grid(tabs.cpm[1], cu.x0, cu.y0, cu.cb_width, cu.cb_height,
                     pred_mode)
        return pred_mode

    # --- intra modes (vvc_ctu.c:947-1040, luma_intra_pred_mode :680) -------

    def intra_luma_pred_modes(self, cu):
        sps = self.sps
        tabs = self.tabs
        x0, y0, w, h = cu.x0, cu.y0, cu.cb_width, cu.cb_height
        cu.intra_luma_ref_idx = 0
        if sps.r.sps_bdpcm_enabled_flag and w <= sps.max_ts_size and \
                h <= sps.max_ts_size:
            cu.bdpcm_flag[LUMA] = self.bin(CTX.INTRA_BDPCM_LUMA_FLAG,
                                           "bdpcm_luma_flag", x0=x0, y0=y0)
        if cu.bdpcm_flag[LUMA]:
            d = self.bin(CTX.INTRA_BDPCM_LUMA_DIR_FLAG, "bdpcm_luma_dir",
                         x0=x0, y0=y0)
            cu.intra_pred_mode_y = INTRA_VERT if d else INTRA_HORZ
        else:
            if sps.r.sps_mip_enabled_flag:
                if w > h * 2 or h > w * 2:
                    inc = 3
                else:
                    left, top = self._left_top_pair(tabs.imf, tabs.imf, x0, y0, 0, 0)
                    inc = left + top
                cu.intra_mip_flag = self.bin(CTX.INTRA_MIP_FLAG + inc,
                                             "mip_flag", x0=x0, y0=y0, w=w, h=h)
            if cu.intra_mip_flag:
                cu.mip_transposed = self.bypass("mip_transposed", x0=x0, y0=y0)
                c_max = 15 if (w == 4 and h == 4) else \
                    (7 if (w == 4 or h == 4 or (w == 8 and h == 8)) else 5)
                cu.mip_mode = self.tb_code("mip_mode", c_max, x0=x0, y0=y0)
                set_grid(tabs.imf, x0, y0, w, h, 1)
                set_grid(tabs.imtf, x0, y0, w, h, cu.mip_transposed)
                set_grid(tabs.imm, x0, y0, w, h, cu.mip_mode)
                cu.intra_pred_mode_y = cu.mip_mode
            else:
                isp_mode_flag = 0
                if sps.r.sps_mrl_enabled_flag and (y0 % sps.ctb_size_y) > 0:
                    cu.intra_luma_ref_idx = self.tu_code(
                        CTX.INTRA_LUMA_REF_IDX, 2, "mrl_idx", x0=x0, y0=y0)
                if sps.r.sps_isp_enabled_flag and not cu.intra_luma_ref_idx and \
                        w <= sps.max_tb_size_y and h <= sps.max_tb_size_y and \
                        w * h > 16 and not cu.act_enabled_flag:
                    isp_mode_flag = self.bin(CTX.INTRA_SUBPARTITIONS_MODE_FLAG,
                                             "isp_mode_flag", x0=x0, y0=y0)
                if not (x0 & 63) and not (y0 & 63):
                    tabs.ispmf[y0 >> 6, x0 >> 6] = isp_mode_flag
                if isp_mode_flag:
                    cu.isp_split_type = 1 + self.bin(
                        CTX.INTRA_SUBPARTITIONS_SPLIT_FLAG, "isp_split",
                        x0=x0, y0=y0)
                else:
                    cu.isp_split_type = ISP_NO_SPLIT
                if cu.isp_split_type == ISP_NO_SPLIT:
                    cu.num_intra_subpartitions = 1
                elif (w == 4 and h == 8) or (w == 8 and h == 4):
                    cu.num_intra_subpartitions = 2
                else:
                    cu.num_intra_subpartitions = 4
                cu.intra_pred_mode_y = self.luma_intra_pred_mode(cu, isp_mode_flag)
        set_grid(tabs.ipm, x0, y0, w, h, cu.intra_pred_mode_y)

    def _mpm_cands(self, cu):
        sps = self.sps
        tabs = self.tabs
        x0, y0 = cu.x0, cu.y0
        x_a = (x0 - 1) >> 2
        y_a = (y0 + cu.cb_height - 1) >> 2
        x_b = (x0 + cu.cb_width - 1) >> 2
        y_b = (y0 - 1) >> 2
        log2_ctb = sps.ctb_log2_size_y
        x0b = x0 & ((1 << log2_ctb) - 1)
        y0b = y0 & ((1 << log2_ctb) - 1)
        avail_l = self.ctb_left_flag or x0b
        avail_u = self.ctb_up_flag or y0b
        if not avail_l or tabs.cpm[0][y_a, x_a] != MODE_INTRA or \
                tabs.imf[y_a, x_a]:
            a = INTRA_PLANAR
        else:
            a = int(tabs.ipm[y_a, x_a])
        if not avail_u or tabs.cpm[0][y_b, x_b] != MODE_INTRA or \
                tabs.imf[y_b, x_b] or not y0b:
            b = INTRA_PLANAR
        else:
            b = int(tabs.ipm[y_b, x_b])
        if a == b and a > INTRA_DC:
            cand = [a, 2 + ((a + 61) % 64), 2 + ((a - 1) % 64),
                    2 + ((a + 60) % 64), 2 + (a % 64)]
        else:
            minab, maxab = min(a, b), max(a, b)
            if a > INTRA_DC and b > INTRA_DC:
                diff = maxab - minab
                cand = [a, b, 0, 0, 0]
                if diff == 1:
                    cand[2:] = [2 + ((minab + 61) % 64), 2 + ((maxab - 1) % 64),
                                2 + ((minab + 60) % 64)]
                elif diff >= 62:
                    cand[2:] = [2 + ((minab - 1) % 64), 2 + ((maxab + 61) % 64),
                                2 + (minab % 64)]
                elif diff == 2:
                    cand[2:] = [2 + ((minab - 1) % 64), 2 + ((minab + 61) % 64),
                                2 + ((maxab - 1) % 64)]
                else:
                    cand[2:] = [2 + ((minab + 61) % 64), 2 + ((minab - 1) % 64),
                                2 + ((maxab + 61) % 64)]
            elif a > INTRA_DC or b > INTRA_DC:
                cand = [maxab, 2 + ((maxab + 61) % 64), 2 + ((maxab - 1) % 64),
                        2 + ((maxab + 60) % 64), 2 + (maxab % 64)]
            else:
                cand = [INTRA_DC, INTRA_VERT, INTRA_HORZ,
                        INTRA_VERT - 4, INTRA_VERT + 4]
        return cand

    def luma_intra_pred_mode(self, cu, isp_mode_flag):
        """8.4.2: MPM-based luma mode coding, bidirectional."""
        dec = self.decode
        if dec:
            mpm_flag = 1
            if not cu.intra_luma_ref_idx:
                mpm_flag = self.e.decode_bin(CTX.INTRA_LUMA_MPM_FLAG)
            not_planar = 1
            mpm_idx = 0
            remainder = 0
            if mpm_flag:
                if not cu.intra_luma_ref_idx:
                    not_planar = self.e.decode_bin(
                        CTX.INTRA_LUMA_NOT_PLANAR_FLAG + (not isp_mode_flag))
                if not_planar:
                    while mpm_idx < 4 and self.e.decode_bypass():
                        mpm_idx += 1
            else:
                remainder = self.e.truncated_binary(60)
            if not not_planar:
                return INTRA_PLANAR
            cand = self._mpm_cands(cu)
            if mpm_flag:
                return cand[mpm_idx]
            cand_s = sorted(cand)
            pred = remainder + 1
            for c in cand_s:
                if pred >= c:
                    pred += 1
            return pred
        # encode: policy chooses target mode; binarize via MPM list
        target = int(self.policy("intra_luma_mode", x0=cu.x0, y0=cu.y0,
                                 w=cu.cb_width, h=cu.cb_height,
                                 mrl=cu.intra_luma_ref_idx))
        cand = self._mpm_cands(cu)
        if cu.intra_luma_ref_idx:
            # MRL: mpm_flag inferred 1, planar not allowed — only MPM modes
            # are codeable; remap an out-of-list target onto the list.
            if target not in cand:
                target = cand[target % len(cand)]
            mpm_idx = cand.index(target)
            i = 0
            while i < min(mpm_idx, 4):
                self.e.encode_bypass(1)
                i += 1
            if mpm_idx < 4:
                self.e.encode_bypass(0)
            return target
        if target == INTRA_PLANAR:
            self.e.encode_bin(CTX.INTRA_LUMA_MPM_FLAG, 1)
            self.e.encode_bin(CTX.INTRA_LUMA_NOT_PLANAR_FLAG +
                              (not isp_mode_flag), 0)
            return target
        if target in cand:
            self.e.encode_bin(CTX.INTRA_LUMA_MPM_FLAG, 1)
            self.e.encode_bin(CTX.INTRA_LUMA_NOT_PLANAR_FLAG +
                              (not isp_mode_flag), 1)
            mpm_idx = cand.index(target)
            for i in range(mpm_idx):
                self.e.encode_bypass(1)
            if mpm_idx < 4:
                self.e.encode_bypass(0)
            return target
        self.e.encode_bin(CTX.INTRA_LUMA_MPM_FLAG, 0)
        cand_s = sorted(cand)
        rem = target
        # inverse of: pred = rem + 1; for c in sorted: if pred >= c: pred += 1
        rem -= 1
        for c in reversed(cand_s):
            if target > c:
                rem -= 1
        self.e.truncated_binary(rem, 60)
        return target

    def intra_chroma_pred_modes(self, cu):
        sps = self.sps
        hs, vs = sps.hshift[1], sps.vshift[1]
        cu.mip_chroma_direct_flag = 0
        if sps.r.sps_bdpcm_enabled_flag and \
                (cu.cb_width >> hs) <= sps.max_ts_size and \
                (cu.cb_height >> vs) <= sps.max_ts_size:
            f = self.bin(CTX.INTRA_BDPCM_CHROMA_FLAG, "bdpcm_chroma_flag",
                         x0=cu.x0, y0=cu.y0)
            cu.bdpcm_flag[CB] = cu.bdpcm_flag[CR] = f
        if cu.bdpcm_flag[CB]:
            d = self.bin(CTX.INTRA_BDPCM_CHROMA_DIR_FLAG, "bdpcm_chroma_dir",
                         x0=cu.x0, y0=cu.y0)
            cu.intra_pred_mode_c = INTRA_VERT if d else INTRA_HORZ
            return
        cclm_enabled = self.get_cclm_enabled(cu)
        cclm_mode_flag = 0
        cclm_mode_idx = 0
        chroma_mode = 0
        if cclm_enabled:
            cclm_mode_flag = self.bin(CTX.CCLM_MODE_FLAG, "cclm_mode_flag",
                                      x0=cu.x0, y0=cu.y0)
        if cclm_mode_flag:
            if self.decode:
                if not self.e.decode_bin(CTX.CCLM_MODE_IDX):
                    cclm_mode_idx = 0
                else:
                    cclm_mode_idx = self.e.decode_bypass() + 1
            else:
                cclm_mode_idx = int(self.policy("cclm_mode_idx", x0=cu.x0, y0=cu.y0))
                self.e.encode_bin(CTX.CCLM_MODE_IDX, int(cclm_mode_idx > 0))
                if cclm_mode_idx > 0:
                    self.e.encode_bypass(cclm_mode_idx - 1)
        else:
            if self.decode:
                if not self.e.decode_bin(CTX.INTRA_CHROMA_PRED_MODE):
                    chroma_mode = 4
                else:
                    chroma_mode = (self.e.decode_bypass() << 1) | self.e.decode_bypass()
            else:
                chroma_mode = int(self.policy("intra_chroma_mode", x0=cu.x0, y0=cu.y0))
                self.e.encode_bin(CTX.INTRA_CHROMA_PRED_MODE, int(chroma_mode != 4))
                if chroma_mode != 4:
                    self.e.encode_bypass((chroma_mode >> 1) & 1)
                    self.e.encode_bypass(chroma_mode & 1)
        self.derive_chroma_intra_pred_mode(cu, cclm_mode_flag, cclm_mode_idx,
                                           chroma_mode)

    def get_cclm_enabled(self, cu):
        sps = self.sps
        if not sps.r.sps_cclm_enabled_flag:
            return 0
        if not sps.r.sps_qtbtt_dual_tree_intra_flag or \
                self.sh.slice_type != SLICE_I or sps.ctb_log2_size_y < 6:
            return 1
        # 64x64-based gating for large-CTU dual tree (vvc_ctu.c:638-672)
        tabs = self.tabs
        x0, y0 = cu.x0, cu.y0
        x64, y64 = (x0 >> 6) << 6, (y0 >> 6) << 6
        y32 = (y0 >> 5) << 5
        xc, yc = x64 >> 2, y64 >> 2
        yc32 = y32 >> 2
        depth = int(tabs.cqt_depth[1][yc, xc])
        min_depth = sps.ctb_log2_size_y - 6
        msm64 = int(tabs.msm[0][y64 >> 5, x64 >> 5])
        msm32 = int(tabs.msm[1][y32 >> 5, x64 >> 5])
        enabled = int(tabs.cb_width[1][yc, xc]) == 64 and \
            int(tabs.cb_height[1][yc, xc]) == 64
        enabled |= depth == min_depth and msm64 == SPLIT_BT_HOR and \
            int(tabs.cb_width[1][yc32, xc]) == 64 and \
            int(tabs.cb_height[1][yc32, xc]) == 32
        enabled |= depth > min_depth
        enabled |= depth == min_depth and msm64 == SPLIT_BT_HOR and \
            msm32 == SPLIT_BT_VER
        if enabled:
            w = int(tabs.cb_width[0][yc, xc])
            h = int(tabs.cb_height[0][yc, xc])
            depth0 = int(tabs.cqt_depth[0][yc, xc])
            if (w == 64 and h == 64 and tabs.ispmf[y64 >> 6, x64 >> 6]) or \
                    ((w < 64 or h < 64) and depth0 == min_depth):
                return 0
        return int(bool(enabled))

    def derive_chroma_intra_pred_mode(self, cu, cclm_mode_flag, cclm_mode_idx,
                                      chroma_mode):
        sps = self.sps
        tabs = self.tabs
        xc, yc = cu.x0 >> 2, cu.y0 >> 2
        intra_mip_flag = int(tabs.imf[yc, xc])
        luma_mode = int(tabs.ipm[yc, xc])
        if cu.tree_type == SINGLE_TREE and sps.chroma_format_idc == 3 and \
                chroma_mode == 4 and intra_mip_flag:
            cu.mip_chroma_direct_flag = 1
            cu.intra_pred_mode_c = luma_mode
            return
        # center-derived luma mode
        x_center = (cu.x0 + cu.cb_width // 2) >> 2
        y_center = (cu.y0 + cu.cb_height // 2) >> 2
        c_mip = int(tabs.imf[y_center, x_center])
        c_cpm = int(tabs.cpm[0][y_center, x_center])
        c_ipm = int(tabs.ipm[y_center, x_center])
        if c_mip:
            if cu.tree_type == SINGLE_TREE and sps.chroma_format_idc == 3:
                luma_mode = INTRA_INVALID
            else:
                luma_mode = INTRA_PLANAR
        elif c_cpm in (MODE_IBC, MODE_PLT):
            luma_mode = INTRA_DC
        else:
            luma_mode = c_ipm
        if cu.act_enabled_flag:
            cu.intra_pred_mode_c = luma_mode
            return
        if cclm_mode_flag:
            cu.intra_pred_mode_c = INTRA_LT_CCLM + cclm_mode_idx
        elif chroma_mode == 4:
            cu.intra_pred_mode_c = luma_mode
        else:
            pred_mode_c = (
                (INTRA_VDIAG, INTRA_PLANAR, INTRA_PLANAR, INTRA_PLANAR, INTRA_PLANAR),
                (INTRA_VERT, INTRA_VDIAG, INTRA_VERT, INTRA_VERT, INTRA_VERT),
                (INTRA_HORZ, INTRA_HORZ, INTRA_VDIAG, INTRA_HORZ, INTRA_HORZ),
                (INTRA_DC, INTRA_DC, INTRA_DC, INTRA_VDIAG, INTRA_DC))
            modes = (INTRA_PLANAR, INTRA_VERT, INTRA_HORZ, INTRA_DC)
            if cu.tree_type == SINGLE_TREE and sps.chroma_format_idc == 3 and \
                    intra_mip_flag:
                idx = 4
            else:
                idx = 4
                for i, m in enumerate(modes):
                    if m == luma_mode:
                        idx = i
                        break
            cu.intra_pred_mode_c = pred_mode_c[chroma_mode][idx]
        if sps.chroma_format_idc == 2 and cu.intra_pred_mode_c <= INTRA_VDIAG:
            mode_map_422 = (
                0, 1, 61, 62, 63, 64, 65, 66, 2, 3, 5, 6, 8, 10, 12, 13,
                14, 16, 18, 20, 22, 23, 24, 26, 28, 30, 31, 33, 34, 35, 36, 37,
                38, 39, 40, 41, 41, 42, 43, 43, 44, 44, 45, 45, 46, 47, 48, 48,
                49, 49, 50, 51, 51, 52, 52, 53, 54, 55, 55, 56, 56, 57, 57, 58,
                59, 59, 60)
            cu.intra_pred_mode_c = mode_map_422[cu.intra_pred_mode_c]

    def set_intra_mvf(self, cu):
        """ff_vvc_set_intra_mvf (vvc_mvs.c:265) + DMVR-grid copy."""
        t = self.tabs
        x0, y0 = cu.x0 >> 2, cu.y0 >> 2
        x1 = (cu.x0 + cu.cb_width) >> 2
        y1 = (cu.y0 + cu.cb_height) >> 2
        t.mvf_pf[y0:y1, x0:x1] = 0  # PF_INTRA
        t.col_pf[y0:y1, x0:x1] = 0

    # --- inter prediction syntax (vvc_ctu.c:1318-1729) ---------------------

    def inter_data(self, cu):
        from .mvs import MotionContext
        mc = MotionContext(self)
        pu = PredictionUnit()
        cu.pu = pu
        pu.general_merge_flag = 1
        if not cu.skip_flag:
            pu.general_merge_flag = self.bin(CTX.GENERAL_MERGE_FLAG,
                                             "general_merge_flag",
                                             x0=cu.x0, y0=cu.y0)
        if pu.general_merge_flag:
            self.hls_merge_data(cu, pu, mc)
        elif cu.pred_mode == MODE_IBC:
            raise NotImplementedError("IBC")
        else:
            self.mvp_data(cu, pu, mc)
        if not pu.merge_gpm_flag and not pu.inter_affine_flag and \
                not pu.merge_subblock_flag:
            self.derive_dmvr_bdof_flag(cu, pu)
            if pu.dmvr_flag or pu.bdof_flag:
                pu.mi.num_sb_x = (cu.cb_width >> 4) if cu.cb_width > 16 else 1
                pu.mi.num_sb_y = (cu.cb_height >> 4) if cu.cb_height > 16 else 1
            mc.update_hmvp(cu)
        if not pu.dmvr_flag:
            self.fill_dmvr_info(cu)

    def fill_dmvr_info(self, cu):
        """fill_dmvr_info (vvc_ctu.c:1697): copy mvf grid -> per-frame
        collocated grid (post-DMVR values land here for DMVR blocks)."""
        t = self.tabs
        x0, y0 = cu.x0 >> 2, cu.y0 >> 2
        x1 = (cu.x0 + cu.cb_width) >> 2
        y1 = (cu.y0 + cu.cb_height) >> 2
        t.col_pf[y0:y1, x0:x1] = t.mvf_pf[y0:y1, x0:x1]
        t.col_mv[:, y0:y1, x0:x1] = t.mvf_mv[:, y0:y1, x0:x1]
        t.col_ref[:, y0:y1, x0:x1] = t.mvf_ref[:, y0:y1, x0:x1]

    def hls_merge_data(self, cu, pu, mc):
        from .mvs import mv_merge_refine_pred_flag
        sps, ph = self.sps, self.sh.ph
        pu.merge_gpm_flag = 0
        pu.mi.num_sb_x = pu.mi.num_sb_y = 1
        max_sb_cand = self.max_num_subblock_merge_cand()
        if max_sb_cand > 0 and cu.cb_width >= 8 and cu.cb_height >= 8:
            left, top = self._left_top_pair(self.tabs.msf, self.tabs.msf,
                                            cu.x0, cu.y0, 0, 0)
            la, ta = self._left_top_pair(self.tabs.iaf, self.tabs.iaf,
                                         cu.x0, cu.y0, 0, 0)
            inc = (left or la) + (top or ta)
            pu.merge_subblock_flag = self.bin(
                CTX.MERGE_SUBBLOCK_FLAG + inc, "merge_subblock_flag",
                x0=cu.x0, y0=cu.y0)
        if pu.merge_subblock_flag:
            self.merge_data_subblock(cu, pu, mc)
        else:
            self.merge_data_block(cu, pu, mc)

    def max_num_subblock_merge_cand(self):
        """ph->max_num_subblock_merge_cand (vvc_ps.c:703)."""
        sps, ph = self.sps, self.sh.ph
        if sps.r.sps_affine_enabled_flag:
            return 5 - sps.r.sps_five_minus_max_num_subblock_merge_cand
        return int(sps.r.sps_sbtmvp_enabled_flag and
                   ph.ph_temporal_mvp_enabled_flag)

    def merge_data_subblock(self, cu, pu, mc):
        """merge_data_subblock (vvc_ctu.c:1318) + ff_vvc_sb_mv_merge_mode."""
        merge_subblock_idx = 0
        max_cand = self.max_num_subblock_merge_cand()
        if max_cand > 1:
            if self.bin(CTX.MERGE_SUBBLOCK_IDX, "merge_subblock_idx_b0"):
                i = 1
                while i < max_cand - 1 and self.bypass("merge_subblock_ext"):
                    i += 1
                merge_subblock_idx = i
        if not mc.sb_mv_merge_mode(cu, merge_subblock_idx, pu):
            mc.store_sb_mvs(cu, pu)

    def merge_data_block(self, cu, pu, mc):
        """merge_data_block (vvc_ctu.c:1413)."""
        sps, rsh = self.sps, self.sh.r
        w, h = cu.cb_width, cu.cb_height
        is_128 = w == 128 or h == 128
        ciip_avail = sps.r.sps_ciip_enabled_flag and not cu.skip_flag and \
            w * h >= 64
        gpm_avail = sps.r.sps_gpm_enabled_flag and rsh.sh_slice_type == 0 and \
            w >= 8 and h >= 8 and w < 8 * h and h < 8 * w
        regular_merge_flag = 1
        if not is_128 and (ciip_avail or gpm_avail):
            inc = int(not cu.skip_flag)
            regular_merge_flag = self.bin(CTX.REGULAR_MERGE_FLAG + inc,
                                          "regular_merge_flag",
                                          x0=cu.x0, y0=cu.y0)
        if regular_merge_flag:
            self.merge_data_regular(cu, pu, mc)
        else:
            if ciip_avail and gpm_avail:
                cu.ciip_flag = self.bin(CTX.CIIP_FLAG, "ciip_flag",
                                        x0=cu.x0, y0=cu.y0)
            else:
                cu.ciip_flag = int(sps.r.sps_ciip_enabled_flag and
                                   not cu.skip_flag and not is_128 and
                                   w * h >= 64)
            if cu.ciip_flag:
                self.merge_data_ciip(cu, pu, mc)
            else:
                self.merge_data_gpm(cu, pu, mc)

    def merge_idx_decode(self, c_max):
        if not self.bin(CTX.MERGE_IDX, "merge_idx_b0"):
            return 0
        i = 1
        while i < c_max and self.bypass("merge_idx_ext"):
            i += 1
        return i

    def merge_data_regular(self, cu, pu, mc):
        """merge_data_regular (vvc_ctu.c:1333)."""
        from .mvs import mv_merge_refine_pred_flag, round_mv, clip_mv
        sps, ph = self.sps, self.sh.ph
        merge_idx = 0
        mmvd_offset = None
        if sps.r.sps_mmvd_enabled_flag:
            pu.mmvd_merge_flag = self.bin(CTX.MMVD_MERGE_FLAG,
                                          "mmvd_merge_flag",
                                          x0=cu.x0, y0=cu.y0)
        if pu.mmvd_merge_flag:
            mmvd_cand_flag = 0
            if sps.max_num_merge_cand > 1:
                mmvd_cand_flag = self.bin(CTX.MMVD_CAND_FLAG,
                                          "mmvd_cand_flag")
            mmvd_offset = self.mmvd_offset_coding(
                ph.ph_mmvd_fullpel_only_flag)
            merge_idx = mmvd_cand_flag
        elif sps.max_num_merge_cand > 1:
            merge_idx = self.merge_idx_decode(sps.max_num_merge_cand - 1)
        mvf = mc.luma_mv_merge_mode(cu, merge_idx, 0)
        if pu.mmvd_merge_flag:
            self.derive_mmvd(mvf, mmvd_offset, mc)
        mv_merge_refine_pred_flag(mvf, cu.cb_width, cu.cb_height)
        mc.set_mvf(cu.x0, cu.y0, cu.cb_width, cu.cb_height, mvf)
        self.mvf_to_mi(mvf, pu.mi)

    def mvf_to_mi(self, mvf, mi):
        mi.pred_flag = mvf.pred_flag
        mi.bcw_idx = mvf.bcw_idx
        mi.hpel_if_idx = mvf.hpel_if_idx
        for i in range(2):
            if mvf.pred_flag & (i + 1):
                mi.mv[i][0] = list(mvf.mv[i])
                mi.ref_idx[i] = mvf.ref_idx[i]

    def mmvd_offset_coding(self, fullpel_only):
        """ff_vvc_mmvd_offset_coding (vvc_cabac.c)."""
        if not self.bin(CTX.MMVD_DISTANCE_IDX, "mmvd_distance_idx_b0"):
            dist_idx = 0
        else:
            i = 1
            while i < 7 and self.bypass("mmvd_distance_ext"):
                i += 1
            dist_idx = i
        shift = 4 if fullpel_only else 2
        distance = 1 << (dist_idx + shift)
        dir_idx = (self.bypass("mmvd_dir0") << 1) | self.bypass("mmvd_dir1")
        signs = ((1, 0), (-1, 0), (0, 1), (0, -1))
        return [distance * signs[dir_idx][0], distance * signs[dir_idx][1]]

    def derive_mmvd(self, mvf, mmvd_offset, mc):
        """derive_mmvd (vvc_ctu.c:1244)."""
        from .mvs import mv_scale, PF_L0, PF_BI
        rpl = self.rpl
        poc = self.poc
        mmvd = [list(mmvd_offset), list(mmvd_offset)]
        if mvf.pred_flag == PF_BI:
            rp = (poc - rpl[0].poc_list[mvf.ref_idx[0]],
                  poc - rpl[1].poc_list[mvf.ref_idx[1]])
            if rp[0] == rp[1]:
                pass
            elif abs(rp[0]) >= abs(rp[1]):
                i, o = 0, 1
                if rpl[0].is_lt[mvf.ref_idx[0]] or \
                        rpl[1].is_lt[mvf.ref_idx[1]]:
                    mmvd[o][0] = mmvd[i][0] if rp[0] * rp[1] > 0 \
                        else -mmvd[i][0]
                    mmvd[o][1] = mmvd[i][1] if rp[0] * rp[1] > 0 \
                        else -mmvd[i][1]
                else:
                    mmvd[o] = mv_scale(mmvd[i], rp[i], rp[o])
            else:
                i, o = 1, 0
                if rpl[0].is_lt[mvf.ref_idx[0]] or \
                        rpl[1].is_lt[mvf.ref_idx[1]]:
                    mmvd[o][0] = mmvd[i][0] if rp[0] * rp[1] > 0 \
                        else -mmvd[i][0]
                    mmvd[o][1] = mmvd[i][1] if rp[0] * rp[1] > 0 \
                        else -mmvd[i][1]
                else:
                    mmvd[o] = mv_scale(mmvd[i], rp[i], rp[o])
            mvf.mv[0][0] += mmvd[0][0]
            mvf.mv[0][1] += mmvd[0][1]
            mvf.mv[1][0] += mmvd[1][0]
            mvf.mv[1][1] += mmvd[1][1]
        else:
            idx = mvf.pred_flag - PF_L0
            mvf.mv[idx][0] += mmvd_offset[0]
            mvf.mv[idx][1] += mmvd_offset[1]

    def merge_data_ciip(self, cu, pu, mc):
        """merge_data_ciip (vvc_ctu.c:1393)."""
        from .mvs import mv_merge_refine_pred_flag
        sps = self.sps
        merge_idx = 0
        if sps.max_num_merge_cand > 1:
            merge_idx = self.merge_idx_decode(sps.max_num_merge_cand - 1)
        mvf = mc.luma_mv_merge_mode(cu, merge_idx, 1)
        mv_merge_refine_pred_flag(mvf, cu.cb_width, cu.cb_height)
        mc.set_mvf(cu.x0, cu.y0, cu.cb_width, cu.cb_height, mvf)
        self.mvf_to_mi(mvf, pu.mi)
        cu.intra_pred_mode_y = cu.intra_pred_mode_c = INTRA_PLANAR
        cu.intra_luma_ref_idx = 0
        cu.intra_mip_flag = 0

    def merge_data_gpm(self, cu, pu, mc):
        """merge_data_gpm (vvc_ctu.c:1376) + ff_vvc_store_gpm_mvf."""
        sps = self.sps
        pu.merge_gpm_flag = 1
        idx0 = 0
        for _ in range(6):
            idx0 = (idx0 << 1) | self.bypass("gpm_partition_idx")
        pu.gpm_partition_idx = idx0
        merge_gpm_idx = [self.merge_idx_decode(
            sps.max_num_gpm_merge_cand - 0 - 1), 0]
        if sps.max_num_gpm_merge_cand > 2:
            merge_gpm_idx[1] = self.merge_idx_decode(
                sps.max_num_gpm_merge_cand - 1 - 1)
        pu.gpm_mv = mc.luma_mv_merge_gpm(cu, merge_gpm_idx)
        self.store_gpm_mvf(cu, pu, mc)

    def store_gpm_mvf(self, cu, pu, mc):
        """ff_vvc_store_gpm_mvf (vvc_mvs.c:449)."""
        from . import data as D
        from .mvs import MvField, PF_L0, PF_BI
        t = D.tables()
        angle_idx = int(t["gpm_angle_idx"][pu.gpm_partition_idx])
        distance_idx = int(t["gpm_distance_idx"][pu.gpm_partition_idx])
        displacement_x = int(t["gpm_distance_lut"][angle_idx])
        displacement_y = int(t["gpm_distance_lut"][(angle_idx + 8) % 32])
        is_flip = 13 <= angle_idx <= 27
        shift_hor = 0 if (angle_idx % 16 == 8 or
                          (angle_idx % 16 and
                           cu.cb_height >= cu.cb_width)) else 1
        sign = 1 if angle_idx < 16 else -1
        off_x = (-cu.cb_width) >> 1
        off_y = (-cu.cb_height) >> 1
        if not shift_hor:
            off_y += sign * ((distance_idx * cu.cb_height) >> 3)
        else:
            off_x += sign * ((distance_idx * cu.cb_width) >> 3)
        for y in range(0, cu.cb_height, 4):
            for x in range(0, cu.cb_width, 4):
                motion_idx = (((x + off_x) << 1) + 5) * displacement_x + \
                    (((y + off_y) << 1) + 5) * displacement_y
                s_type = 2 if abs(motion_idx) < 32 else \
                    ((1 - is_flip) if motion_idx <= 0 else int(is_flip))
                pred_flag = pu.gpm_mv[0].pred_flag | pu.gpm_mv[1].pred_flag
                x0, y0 = cu.x0 + x, cu.y0 + y
                if not s_type:
                    mc.set_mvf(x0, y0, 4, 4, pu.gpm_mv[0])
                elif s_type == 1 or (s_type == 2 and pred_flag != PF_BI):
                    mc.set_mvf(x0, y0, 4, 4, pu.gpm_mv[1])
                else:
                    mvf = pu.gpm_mv[0].copy()
                    mv1 = pu.gpm_mv[1]
                    lx = mv1.pred_flag - PF_L0
                    mvf.pred_flag = PF_BI
                    mvf.ref_idx[lx] = mv1.ref_idx[lx]
                    mvf.mv[lx] = list(mv1.mv[lx])
                    mc.set_mvf(x0, y0, 4, 4, mvf)

    # --- AMVP / mvp_data (vvc_ctu.c:1466-1630) ----------------------------

    def mvd_coding(self):
        """hls_mvd_coding (vvc_ctu.c:1466)."""
        mv = [0, 0]
        for i in range(2):
            mv[i] = self.bin(CTX.ABS_MVD_GREATER0_FLAG,
                             "abs_mvd_greater0_flag")
        for i in range(2):
            if mv[i]:
                mv[i] += self.bin(CTX.ABS_MVD_GREATER1_FLAG,
                                  "abs_mvd_greater1_flag")
        for i in range(2):
            if mv[i] > 0:
                if mv[i] == 2:
                    mv[i] += self.egk_code("abs_mvd_minus2", 1, 15, 17)
                sign = self.bypass("mvd_sign_flag")
                mv[i] = (1 - 2 * sign) * mv[i]
        return mv

    def pred_flag_decode(self, cu, is_b):
        """ff_vvc_pred_flag (vvc_cabac.c:1481)."""
        from .mvs import PF_L0, PF_BI
        w, h = cu.cb_width, cu.cb_height
        if not is_b:
            return PF_L0
        if w + h > 12:
            log2 = ilog2(w) + ilog2(h)
            inc = 7 - ((1 + log2) >> 1)
            if self.bin(CTX.INTER_PRED_IDC + inc, "inter_pred_idc",
                        x0=cu.x0, y0=cu.y0):
                return PF_BI
        return PF_L0 + self.bin(CTX.INTER_PRED_IDC + 5, "inter_pred_idc_b5")

    def ref_idx_decode(self, lx, sym_mvd_flag):
        rsh = self.sh.r
        if rsh.num_ref_idx_active[lx] > 1 and not sym_mvd_flag:
            c_max = rsh.num_ref_idx_active[lx] - 1
            max_ctx = min(c_max, 2)
            i = 0
            while i < max_ctx and self.bin(CTX.REF_IDX_LX + i, "ref_idx_lx"):
                i += 1
            if i == 2:
                while i < c_max and self.bypass("ref_idx_lx_ext"):
                    i += 1
            return i
        if sym_mvd_flag:
            return self.sh.ref_idx_sym[lx]
        return 0

    def amvr_shift_decode(self, inter_affine_flag, pred_mode, enabled):
        """ff_vvc_amvr_shift (vvc_cabac.c:1560)."""
        amvr_shift = 2
        if enabled:
            if self.bin(CTX.AMVR_FLAG + inter_affine_flag, "amvr_flag"):
                if inter_affine_flag:
                    idx = self._amvr_precision_idx(2, 1)
                    amvr_shift = idx * 4
                elif pred_mode == MODE_IBC:
                    idx = self._amvr_precision_idx(1, 1)
                    amvr_shift = 4 + idx * 2
                else:
                    idx = self._amvr_precision_idx(0, 2)
                    amvr_shift = (3, 4, 6)[idx]
        return amvr_shift

    def _amvr_precision_idx(self, inc, c_max):
        if not self.bin(CTX.AMVR_PRECISION_IDX + inc, "amvr_precision_idx"):
            return 0
        i = 1
        if i < c_max and self.bin(CTX.AMVR_PRECISION_IDX + 1,
                                  "amvr_precision_idx1"):
            i += 1
        return i

    def bcw_idx_decode(self, cu, mi):
        """bcw_idx_decode (vvc_ctu.c:1490)."""
        from .mvs import PF_BI
        sps = self.sps
        pwt = self.pwt
        if sps.r.sps_bcw_enabled_flag and mi.pred_flag == PF_BI and \
                not pwt.weight_flag(0, 0, mi.ref_idx[0]) and \
                not pwt.weight_flag(1, 0, mi.ref_idx[1]) and \
                not pwt.weight_flag(0, 1, mi.ref_idx[0]) and \
                not pwt.weight_flag(1, 1, mi.ref_idx[1]) and \
                cu.cb_width * cu.cb_height >= 256:
            from .mvs import MotionContext
            no_backward = MotionContext(self).no_backward_pred_flag()
            c_max = 4 if no_backward else 2
            if not self.bin(CTX.BCW_IDX, "bcw_idx"):
                return 0
            i = 1
            while i < c_max and self.bypass("bcw_idx_ext"):
                i += 1
            return i
        return 0

    def mvp_data(self, cu, pu, mc):
        """mvp_data (vvc_ctu.c:1570)."""
        from .mvs import PF_L0, PF_L1, PF_BI, MvField
        sps, ph, sh = self.sps, self.sh.ph, self.sh
        rsh = sh.r
        mi = pu.mi
        is_b = rsh.sh_slice_type == 0
        mvds = [[[0, 0], [0, 0], [0, 0]], [[0, 0], [0, 0], [0, 0]]]
        mvp_lx_flag = [0, 0]
        cu_affine_type_flag = 0
        has_no_zero_mvd = 0

        mi.pred_flag = self.pred_flag_decode(cu, is_b)
        if sps.r.sps_affine_enabled_flag and cu.cb_width >= 16 and \
                cu.cb_height >= 16:
            la, ta = self._left_top_pair(self.tabs.msf, self.tabs.msf,
                                         cu.x0, cu.y0, 0, 0)
            lb, tb = self._left_top_pair(self.tabs.iaf, self.tabs.iaf,
                                         cu.x0, cu.y0, 0, 0)
            inc = (la or lb) + (ta or tb)
            pu.inter_affine_flag = self.bin(CTX.INTER_AFFINE_FLAG + inc,
                                            "inter_affine_flag")
            set_grid(self.tabs.iaf, cu.x0, cu.y0, cu.cb_width, cu.cb_height,
                     pu.inter_affine_flag)
            if sps.r.sps_6param_affine_enabled_flag and pu.inter_affine_flag:
                cu_affine_type_flag = self.bin(CTX.CU_AFFINE_TYPE_FLAG,
                                               "cu_affine_type_flag")
        mi.motion_model_idc = pu.inter_affine_flag + cu_affine_type_flag
        num_cp_mv = mi.motion_model_idc + 1

        if sps.r.sps_smvd_enabled_flag and not ph.ph_mvd_l1_zero_flag and \
                mi.pred_flag == PF_BI and not pu.inter_affine_flag and \
                sh.ref_idx_sym[0] > -1 and sh.ref_idx_sym[1] > -1:
            pu.sym_mvd_flag = self.bin(CTX.SYM_MVD_FLAG, "sym_mvd_flag")

        for i in range(2):
            pf = PF_L0 + (1 - i)
            if mi.pred_flag != pf:
                mi.ref_idx[i] = self.ref_idx_decode(i, pu.sym_mvd_flag)
                # mvds_decode (vvc_ctu.c:1524)
                if i == 1 and ph.ph_mvd_l1_zero_flag and \
                        mi.pred_flag == PF_BI:
                    for j in range(num_cp_mv):
                        mvds[1][j] = [0, 0]
                else:
                    if i == 1 and pu.sym_mvd_flag:
                        mvds[1][0] = [-mvds[0][0][0], -mvds[0][0][1]]
                    else:
                        mvds[i][0] = self.mvd_coding()
                    if mvds[i][0][0] or mvds[i][0][1]:
                        has_no_zero_mvd = 1
                    for j in range(1, num_cp_mv):
                        d = self.mvd_coding()
                        d[0] += mvds[i][0][0]
                        d[1] += mvds[i][0][1]
                        mvds[i][j] = d
                        if d[0] or d[1]:
                            has_no_zero_mvd = 1
                mvp_lx_flag[i] = self.bin(CTX.MVP_LX_FLAG, "mvp_lx_flag")

        amvr_enabled = sps.r.sps_amvr_enabled_flag \
            if mi.motion_model_idc == 0 else \
            sps.r.sps_affine_amvr_enabled_flag
        amvr_enabled &= has_no_zero_mvd
        amvr_shift = self.amvr_shift_decode(pu.inter_affine_flag,
                                            cu.pred_mode, amvr_enabled)
        mi.hpel_if_idx = int(amvr_shift == 3)
        mi.bcw_idx = self.bcw_idx_decode(cu, mi)

        if mi.motion_model_idc:
            mc.ff_affine_mvp(cu, mvp_lx_flag, amvr_shift, mi)
        else:
            mc.ff_mvp(cu, mvp_lx_flag, amvr_shift, mi)

        # mvp_add_difference (vvc_ctu.c:1556)
        for i in range(2):
            if mi.pred_flag & (i + 1):
                for j in range(num_cp_mv):
                    mi.mv[i][j][0] += mvds[i][j][0] * (1 << amvr_shift)
                    mi.mv[i][j][1] += mvds[i][j][1] * (1 << amvr_shift)

        if mi.motion_model_idc:
            mc.store_sb_mvs(cu, pu)
        else:
            # ff_vvc_store_mv (vvc_mvs.c:499)
            mvf = MvField()
            mvf.hpel_if_idx = mi.hpel_if_idx
            mvf.bcw_idx = mi.bcw_idx
            mvf.pred_flag = mi.pred_flag
            for i in range(2):
                if mi.pred_flag & (i + 1):
                    mvf.mv[i] = list(mi.mv[i][0])
                    mvf.ref_idx[i] = mi.ref_idx[i]
            mc.set_mvf(cu.x0, cu.y0, cu.cb_width, cu.cb_height, mvf)

    def derive_dmvr_bdof_flag(self, cu, pu):
        """derive_dmvr_bdof_flag (vvc_ctu.c:1639)."""
        from .mvs import PF_BI
        ph, sh = self.sh.ph, self.sh
        mi = pu.mi
        rpl = self.rpl
        pu.bdof_flag = 0
        pu.dmvr_flag = 0
        pwt = self.pwt
        if mi.pred_flag == PF_BI and \
                (self.poc - rpl[0].poc_list[mi.ref_idx[0]] ==
                 rpl[1].poc_list[mi.ref_idx[1]] - self.poc) and \
                not rpl[0].is_lt[mi.ref_idx[0]] and \
                not rpl[1].is_lt[mi.ref_idx[1]] and \
                not cu.ciip_flag and not mi.bcw_idx and \
                not pwt.weight_flag(0, 0, mi.ref_idx[0]) and \
                not pwt.weight_flag(1, 0, mi.ref_idx[1]) and \
                not pwt.weight_flag(0, 1, mi.ref_idx[0]) and \
                not pwt.weight_flag(1, 1, mi.ref_idx[1]) and \
                cu.cb_width >= 8 and cu.cb_height >= 8 and \
                cu.cb_width * cu.cb_height >= 128:
            if not ph.ph_bdof_disabled_flag and \
                    mi.motion_model_idc == 0 and \
                    not pu.merge_subblock_flag and not pu.sym_mvd_flag:
                pu.bdof_flag = 1
            if not ph.ph_dmvr_disabled_flag and pu.general_merge_flag and \
                    not pu.mmvd_merge_flag:
                pu.dmvr_flag = 1

    def sbt_info(self, cu):
        """sbt_info (vvc_ctu.c:1092)."""
        sps = self.sps
        if not (cu.pred_mode == MODE_INTER and sps.r.sps_sbt_enabled_flag and
                not cu.ciip_flag and cu.cb_width <= sps.max_tb_size_y and
                cu.cb_height <= sps.max_tb_size_y):
            return
        w, h = cu.cb_width, cu.cb_height
        sbt_ver_h = w >= 8
        sbt_hor_h = h >= 8
        cu.sbt_flag = 0
        if sbt_ver_h or sbt_hor_h:
            inc = int(w * h <= 256)
            cu.sbt_flag = self.bin(CTX.CU_SBT_FLAG + inc, "sbt_flag",
                                   x0=cu.x0, y0=cu.y0)
        if cu.sbt_flag:
            sbt_ver_q = w >= 16
            sbt_hor_q = h >= 16
            quad = 0
            if (sbt_ver_h or sbt_hor_h) and (sbt_ver_q or sbt_hor_q):
                quad = self.bin(CTX.CU_SBT_QUAD_FLAG, "sbt_quad_flag")
            if quad:
                cu.sbt_horizontal_flag = sbt_hor_q
                if sbt_ver_q and sbt_hor_q:
                    inc = 0 if w == h else (1 if w < h else 2)
                    cu.sbt_horizontal_flag = self.bin(
                        CTX.CU_SBT_HORIZONTAL_FLAG + inc, "sbt_horizontal")
            else:
                cu.sbt_horizontal_flag = sbt_hor_h
                if sbt_ver_h and sbt_hor_h:
                    inc = 0 if w == h else (1 if w < h else 2)
                    cu.sbt_horizontal_flag = self.bin(
                        CTX.CU_SBT_HORIZONTAL_FLAG + inc, "sbt_horizontal")
            cu.sbt_pos_flag = self.bin(CTX.CU_SBT_POS_FLAG, "sbt_pos")
            sbt_min = 1 if quad else 2
            self.parse.sbt_num_fourths_tb0 = \
                (4 - sbt_min) if cu.sbt_pos_flag else sbt_min

    # --- binarization helpers ----------------------------------------------

    def tb_code(self, tag, c_max, **ctx):
        """truncated binary (bypass)."""
        if self.decode:
            return self.e.truncated_binary(c_max)
        v = int(self.policy(tag, c_max=c_max, **ctx))
        self.e.truncated_binary(v, c_max)
        return v

    def egk_code(self, tag, k, max_pre, trunc, **ctx):
        """limited k-th order EGk (bypass)."""
        if self.decode:
            return self.e.limited_egk(k, max_pre, trunc)
        v = int(self.policy(tag, **ctx))
        self.e.limited_egk(v, k, max_pre, trunc)
        return v

    def tu_code(self, base_ctx, c_max, tag, ctx_step=1, **ctx):
        """truncated unary with per-position contexts."""
        if self.decode:
            i = 0
            while i < c_max and self.e.decode_bin(base_ctx + i * ctx_step):
                i += 1
            return i
        v = int(self.policy(tag, c_max=c_max, **ctx))
        for i in range(v):
            self.e.encode_bin(base_ctx + i * ctx_step, 1)
        if v < c_max:
            self.e.encode_bin(base_ctx + v * ctx_step, 0)
        return v

    # --- QP derivation (vvc_ctu.c:77-212) ----------------------------------

    def get_qp_y_pred(self, cu):
        sps, pps = self.sps, self.pps
        p = self.parse
        tabs = self.tabs
        ctb_log2 = sps.ctb_log2_size_y
        mask = (1 << ctb_log2) - 1
        x_qg, y_qg = p.cu_qg_top_left_x, p.cu_qg_top_left_y
        xc, yc = cu.x0 >> 2, cu.y0 >> 2
        x_ctb, y_ctb = cu.x0 >> ctb_log2, cu.y0 >> ctb_log2
        in_same_ctb_a = ((x_qg - 1) >> ctb_log2) == x_ctb and \
            (y_qg >> ctb_log2) == y_ctb
        in_same_ctb_b = (x_qg >> ctb_log2) == x_ctb and \
            ((y_qg - 1) >> ctb_log2) == y_ctb
        if self.na.cand_up:
            first_qg_in_ctu = not (x_qg & mask) and not (y_qg & mask)
            qp_up = int(tabs.qp[LUMA][yc - 1, xc])
            if first_qg_in_ctu and pps.ctb_to_col_bd[x_qg >> ctb_log2] == x_qg >> ctb_log2 << ctb_log2:
                pass
            if first_qg_in_ctu and \
                    pps.ctb_to_col_bd[x_qg >> ctb_log2] == (x_qg >> ctb_log2):
                return qp_up
        qp_pred = self.sh.slice_qp_y if self.is_first_qg else self.qp_y
        if not self.na.cand_up or not in_same_ctb_b:
            qp_b = qp_pred
        else:
            qp_b = int(tabs.qp[LUMA][yc - 1, xc])
        if not self.na.cand_left or not in_same_ctb_a:
            qp_a = qp_pred
        else:
            qp_a = int(tabs.qp[LUMA][yc, xc - 1])
        return (qp_a + qp_b + 1) >> 1

    def set_qp_y(self, cu, x0, y0, has_qp_delta):
        sps = self.sps
        p = self.parse
        if not self.pps.r.pps_cu_qp_delta_enabled_flag:
            self.qp_y = self.sh.slice_qp_y
        elif self.is_first_qg or (p.cu_qg_top_left_x == x0 and
                                  p.cu_qg_top_left_y == y0):
            self.qp_y = self.get_qp_y_pred(cu)
            self.is_first_qg = False
        if has_qp_delta:
            if self.decode:
                delta_abs = self._cu_qp_delta_abs()
                delta = 0
                if delta_abs:
                    delta = -delta_abs if self.e.decode_bypass() else delta_abs
            else:
                delta = int(self.policy("cu_qp_delta", x0=x0, y0=y0))
                self._cu_qp_delta_abs(abs(delta))
                if delta:
                    self.e.encode_bypass(1 if delta < 0 else 0)
            p.is_cu_qp_delta_coded = 1
            if delta:
                off = sps.qp_bd_offset
                self.qp_y = (self.qp_y + delta + 64 + 2 * off) % (64 + off) - off
        set_grid(self.tabs.qp[LUMA], cu.x0, cu.y0, cu.cb_width, cu.cb_height,
                 self.qp_y)
        cu.qp[LUMA] = self.qp_y

    def _cu_qp_delta_abs(self, value=None):
        e = self.e
        if self.decode:
            if not e.decode_bin(CTX.CU_QP_DELTA_ABS):
                return 0
            v = 1
            while v < 5 and e.decode_bin(CTX.CU_QP_DELTA_ABS + 1):
                v += 1
            if v < 5:
                return v
            k = 0
            while k < 6 and e.decode_bypass():
                k += 1
            i = (1 << k) - 1
            v = 0
            for _ in range(k):
                v = (v << 1) + e.decode_bypass()
            return v + i + 5
        v = value
        e.encode_bin(CTX.CU_QP_DELTA_ABS, int(v > 0))
        if v == 0:
            return 0
        for i in range(1, min(v, 5)):
            e.encode_bin(CTX.CU_QP_DELTA_ABS + 1, 1)
        if v < 5:
            e.encode_bin(CTX.CU_QP_DELTA_ABS + 1, 0)
            return v
        # EG0 suffix for v-5
        s = v - 5
        k = 0
        while s >= ((1 << (k + 1)) - 1) and k < 6:
            if s < (1 << (k + 1)) - 1:
                break
            k += 1
        # find k such that s - ((1<<k)-1) < (1<<k)
        k = 0
        while k < 6 and s >= (1 << (k + 1)) - 1:
            k += 1
        for _ in range(k):
            e.encode_bypass(1)
        if k < 6:
            e.encode_bypass(0)
        rem = s - ((1 << k) - 1)
        for i in range(k - 1, -1, -1):
            e.encode_bypass((rem >> i) & 1)
        return v

    def set_qp_c(self, cu):
        sps, pps = self.sps, self.pps
        rsh = self.sh.r
        if not sps.chroma_format_idc:
            return
        x_center = cu.x0 + cu.cb_width // 2
        y_center = cu.y0 + cu.cb_height // 2
        single_tree = cu.tree_type == SINGLE_TREE
        if single_tree:
            qp_luma = self.qp_y + sps.qp_bd_offset
        else:
            qp_luma = int(self.tabs.qp[LUMA][y_center >> 2, x_center >> 2]) + \
                sps.qp_bd_offset
        qp_chroma = max(0, min(63 + sps.qp_bd_offset, qp_luma))
        sh_off = [rsh.sh_cb_qp_offset, rsh.sh_cr_qp_offset,
                  rsh.sh_joint_cbcr_qp_offset]
        for i in range(2 + sps.r.sps_joint_cbcr_enabled_flag):
            qp = int(sps.chroma_qp_table[i][qp_chroma])
            qp = qp + pps.chroma_qp_offset[i] + sh_off[i] + \
                self.parse.chroma_qp_offset[i]
            qp = max(-sps.qp_bd_offset, min(63, qp)) + sps.qp_bd_offset
            cu.qp[i + 1] = qp

    # --- transform tree / unit (vvc_ctu.c:314-520) --------------------------

    def transform_tree(self, cu, x0, y0, tu_w, tu_h, ch_type):
        sps = self.sps
        self.parse.infer_tu_cbf_luma = 1
        if cu.isp_split_type == ISP_NO_SPLIT and not cu.sbt_flag:
            if tu_w > sps.max_tb_size_y or tu_h > sps.max_tb_size_y:
                ver_first = tu_w > sps.max_tb_size_y and tu_w > tu_h
                tw = tu_w // 2 if ver_first else tu_w
                th = tu_h if ver_first else tu_h // 2
                self.transform_tree(cu, x0, y0, tw, th, ch_type)
                if ver_first:
                    self.transform_tree(cu, x0 + tw, y0, tw, th, ch_type)
                else:
                    self.transform_tree(cu, x0, y0 + th, tw, th, ch_type)
            else:
                self.transform_unit(cu, x0, y0, tu_w, tu_h, 0, ch_type)
        elif cu.sbt_flag:
            # SBT split (vvc_ctu.c:437-461)
            if not cu.sbt_horizontal_flag:
                tw = tu_w * self.parse.sbt_num_fourths_tb0 // 4
                self.transform_unit(cu, x0, y0, tw, tu_h, 0, ch_type)
                self.transform_unit(cu, x0 + tw, y0, tu_w - tw, tu_h, 1,
                                    ch_type)
            else:
                th = tu_h * self.parse.sbt_num_fourths_tb0 // 4
                self.transform_unit(cu, x0, y0, tu_w, th, 0, ch_type)
                self.transform_unit(cu, x0, y0 + th, tu_w, tu_h - th, 1,
                                    ch_type)
        elif cu.isp_split_type == ISP_HOR_SPLIT:
            th = tu_h // cu.num_intra_subpartitions
            for i in range(cu.num_intra_subpartitions):
                self.transform_unit(cu, x0, y0 + th * i, tu_w, th, i, 0)
        elif cu.isp_split_type == ISP_VER_SPLIT:
            tw = tu_w // cu.num_intra_subpartitions
            for i in range(cu.num_intra_subpartitions):
                self.transform_unit(cu, x0 + tw * i, y0, tw, tu_h, i, 0)

    def transform_unit(self, cu, x0, y0, tu_w, tu_h, sub_tu_index, ch_type):
        sps, pps = self.sps, self.pps
        tabs = self.tabs
        p = self.parse
        tu = TransformUnit(x0, y0, tu_w, tu_h)
        cu.tus.append(tu)
        tree_type = cu.tree_type
        is_128 = cu.cb_width > 64 or cu.cb_height > 64
        is_isp = cu.isp_split_type != ISP_NO_SPLIT
        is_isp_last = is_isp and sub_tu_index == cu.num_intra_subpartitions - 1
        is_sbt_not_coded = cu.sbt_flag and (
            (sub_tu_index == 0 and cu.sbt_pos_flag) or
            (sub_tu_index == 1 and not cu.sbt_pos_flag))
        chroma_available = tree_type != DUAL_TREE_LUMA and \
            sps.chroma_format_idc and (not is_isp or is_isp_last)
        if tree_type == SINGLE_TREE and is_isp_last:
            xc4, yc4 = x0 >> 2, y0 >> 2
            xc = int(tabs.cb_pos_x[ch_type][yc4, xc4])
            yc = int(tabs.cb_pos_y[ch_type][yc4, xc4])
            wc = int(tabs.cb_width[ch_type][yc4, xc4])
            hc = int(tabs.cb_height[ch_type][yc4, xc4])
        else:
            xc, yc, wc, hc = x0, y0, tu_w, tu_h
        if chroma_available and not is_sbt_not_coded:
            tu.coded_flag[CB] = self.bin(
                CTX.TU_CB_CODED_FLAG + cu.bdpcm_flag[1], "tu_cb_coded",
                x0=xc, y0=yc, w=wc, h=hc)
            inc = 2 if cu.bdpcm_flag[1] else tu.coded_flag[CB]
            tu.coded_flag[CR] = self.bin(
                CTX.TU_CR_CODED_FLAG + inc, "tu_cr_coded",
                x0=xc, y0=yc, w=wc, h=hc)
        is_chroma_coded = chroma_available and \
            (tu.coded_flag[CB] or tu.coded_flag[CR])
        if tree_type != DUAL_TREE_CHROMA:
            tu.coded_flag[LUMA] = self._tu_y_coded_flag(
                cu, is_sbt_not_coded, sub_tu_index, is_isp, is_chroma_coded,
                x0, y0, tu_w, tu_h)
            has_qp_delta = (is_128 or tu.coded_flag[LUMA] or is_chroma_coded) \
                and pps.r.pps_cu_qp_delta_enabled_flag and \
                not p.is_cu_qp_delta_coded
            self.set_qp_y(cu, x0, y0, has_qp_delta)
            tu.tbs.append(TransformBlock(x0, y0, tu_w, tu_h, LUMA))
        if tree_type != DUAL_TREE_LUMA:
            self._chroma_qp_offset(cu, is_128, is_chroma_coded)
            if chroma_available:
                hs, vs = sps.hshift[1], sps.vshift[1]
                tu.tbs.append(TransformBlock(xc, yc, wc >> hs, hc >> vs, CB))
                tu.tbs.append(TransformBlock(xc, yc, wc >> hs, hc >> vs, CR))
        if sps.r.sps_joint_cbcr_enabled_flag and \
                ((cu.pred_mode == MODE_INTRA and
                  (tu.coded_flag[CB] or tu.coded_flag[CR])) or
                 (tu.coded_flag[CB] and tu.coded_flag[CR])) and chroma_available:
            inc = 2 * tu.coded_flag[CB] + tu.coded_flag[CR] - 1
            tu.joint_cbcr_residual_flag = self.bin(
                CTX.TU_JOINT_CBCR_RESIDUAL_FLAG + inc, "joint_cbcr",
                x0=xc, y0=yc)
        for tb in tu.tbs:
            is_chroma = tb.c_idx != LUMA
            tb.has_coeffs = tu.coded_flag[tb.c_idx]
            if tb.has_coeffs and is_chroma:
                tb.has_coeffs = 1 if tb.c_idx == CB else \
                    int(not (tu.coded_flag[CB] and tu.joint_cbcr_residual_flag))
            if tb.has_coeffs:
                tb.ts = cu.bdpcm_flag[tb.c_idx]
                if sps.r.sps_transform_skip_enabled_flag and \
                        not cu.bdpcm_flag[tb.c_idx] and \
                        tb.w <= sps.max_ts_size and tb.h <= sps.max_ts_size \
                        and not cu.sbt_flag and (is_chroma or not is_isp):
                    tb.ts = self.bin(CTX.TRANSFORM_SKIP_FLAG + is_chroma,
                                     "transform_skip", x0=tb.x0, y0=tb.y0,
                                     c_idx=tb.c_idx)
                if not self.decode:
                    tb.coeffs = self.coeff_enc_cb(tb)
                code_residual(self, tb, cu.sbt_flag, cu.bdpcm_flag[tb.c_idx])
                self._set_tb_grid(tabs.tu_coded_flag[tb.c_idx], tb,
                                  tu.coded_flag[tb.c_idx])
            if tb.c_idx != CR:
                self._set_tb_pos(tb)
            if tb.c_idx == CB:
                self._set_tb_grid(tabs.tu_joint_cbcr, tb,
                                  tu.joint_cbcr_residual_flag)

    def _tu_y_coded_flag(self, cu, is_sbt_not_coded, sub_tu_index, is_isp,
                         is_chroma_coded, x0, y0, w, h):
        sps = self.sps
        p = self.parse
        v = 0
        if not is_sbt_not_coded:
            has_flag = sub_tu_index < cu.num_intra_subpartitions - 1 or \
                not p.infer_tu_cbf_luma
            if not is_isp:
                is_large = cu.cb_width > sps.max_tb_size_y or \
                    cu.cb_height > sps.max_tb_size_y
                has_flag = (cu.pred_mode == MODE_INTRA and
                            not cu.act_enabled_flag) or is_chroma_coded or is_large
            if has_flag:
                if cu.bdpcm_flag[LUMA]:
                    inc = 1
                elif cu.isp_split_type == ISP_NO_SPLIT:
                    inc = 0
                else:
                    inc = 2 + p.prev_tu_cbf_y
                v = self.bin(CTX.TU_Y_CODED_FLAG + inc, "tu_y_coded",
                             x0=x0, y0=y0, w=w, h=h)
                p.prev_tu_cbf_y = v
            else:
                v = 1
        if is_isp:
            p.infer_tu_cbf_luma = p.infer_tu_cbf_luma and not v
        return v

    def _chroma_qp_offset(self, cu, is_128, is_chroma_coded):
        pps = self.pps
        rsh = self.sh.r
        p = self.parse
        if (is_128 or is_chroma_coded) and \
                rsh.sh_cu_chroma_qp_offset_enabled_flag and \
                not p.is_cu_chroma_qp_offset_coded:
            f = self.bin(CTX.CU_CHROMA_QP_OFFSET_FLAG, "chroma_qp_offset_flag",
                         x0=cu.x0, y0=cu.y0)
            if f:
                idx = 0
                if pps.r.pps_chroma_qp_offset_list_len_minus1 > 0:
                    idx = self.tu_code(CTX.CU_CHROMA_QP_OFFSET_IDX,
                                       pps.r.pps_chroma_qp_offset_list_len_minus1,
                                       "chroma_qp_offset_idx", ctx_step=0,
                                       x0=cu.x0, y0=cu.y0)
                p.chroma_qp_offset = [
                    pps.r.pps_cb_qp_offset_list[idx],
                    pps.r.pps_cr_qp_offset_list[idx],
                    pps.r.pps_joint_cbcr_qp_offset_list[idx]]
            else:
                p.chroma_qp_offset = [0, 0, 0]
            p.is_cu_chroma_qp_offset_coded = 1

    def skipped_transform_tree_unit(self, cu):
        self.set_qp_y(cu, cu.x0, cu.y0, 0)
        self.set_qp_c(cu)
        self._skipped_transform_tree(cu, cu.x0, cu.y0, cu.cb_width, cu.cb_height)

    def _skipped_transform_tree(self, cu, x0, y0, tu_w, tu_h):
        sps = self.sps
        if tu_w > sps.max_tb_size_y or tu_h > sps.max_tb_size_y:
            ver_first = tu_w > sps.max_tb_size_y and tu_w > tu_h
            tw = tu_w // 2 if ver_first else tu_w
            th = tu_h if ver_first else tu_h // 2
            self._skipped_transform_tree(cu, x0, y0, tw, th)
            if ver_first:
                self._skipped_transform_tree(cu, x0 + tw, y0, tw, th)
            else:
                self._skipped_transform_tree(cu, x0, y0 + th, tw, th)
        else:
            tu = TransformUnit(x0, y0, tu_w, tu_h)
            cu.tus.append(tu)
            c_end = 3 if sps.chroma_format_idc else 1
            for i in range(c_end):
                tb = TransformBlock(x0, y0, tu_w >> sps.hshift[i],
                                    tu_h >> sps.vshift[i], i)
                tu.tbs.append(tb)
                if i != CR:
                    self._set_tb_pos(tb)

    def _set_tb_pos(self, tb):
        tabs = self.tabs
        sps = self.sps
        is_chroma = int(tb.c_idx != 0)
        hs = sps.hshift[tb.c_idx]
        vs = sps.vshift[tb.c_idx]
        x_tb = tb.x0 >> 2
        y_tb = tb.y0 >> 2
        w = max(1, tb.w >> (2 - hs))
        h = max(1, tb.h >> (2 - vs))
        tabs.tb_pos_x[is_chroma][y_tb:y_tb + h, x_tb:x_tb + w] = tb.x0
        tabs.tb_pos_y[is_chroma][y_tb:y_tb + h, x_tb:x_tb + w] = tb.y0
        tabs.tb_width[is_chroma][y_tb:y_tb + h, x_tb:x_tb + w] = tb.w
        tabs.tb_height[is_chroma][y_tb:y_tb + h, x_tb:x_tb + w] = tb.h

    def _set_tb_grid(self, tab, tb, v):
        sps = self.sps
        w = tb.w << sps.hshift[tb.c_idx]
        h = tb.h << sps.vshift[tb.c_idx]
        tab[tb.y0 >> 2:(tb.y0 + h) >> 2, tb.x0 >> 2:(tb.x0 + max(w, 4)) >> 2] = v

    # --- LFNST / MTS (vvc_ctu.c:791-861) ------------------------------------

    def lfnst_idx_decode(self, cu):
        sps = self.sps
        tree_type = cu.tree_type
        cu.apply_lfnst_flag = [0, 0, 0]
        if not sps.r.sps_lfnst_enabled_flag or cu.pred_mode != MODE_INTRA or \
                max(cu.cb_width, cu.cb_height) > sps.max_tb_size_y:
            return 0
        for tu in cu.tus:
            for tb in tu.tbs:
                if tu.coded_flag[tb.c_idx] and tb.ts:
                    return 0
        if tree_type == DUAL_TREE_CHROMA:
            lw = cu.cb_width >> sps.hshift[1]
            lh = cu.cb_height >> sps.vshift[1]
        else:
            vs = cu.isp_split_type == ISP_VER_SPLIT
            hs = cu.isp_split_type == ISP_HOR_SPLIT
            lw = cu.cb_width // cu.num_intra_subpartitions if vs else cu.cb_width
            lh = cu.cb_height // cu.num_intra_subpartitions if hs else cu.cb_height
        min_lfnst = min(lw, lh)
        if tree_type != DUAL_TREE_CHROMA and cu.intra_mip_flag and min_lfnst < 16:
            return 0
        lfnst_idx = 0
        p = self.parse
        if min_lfnst >= 4:
            if (cu.isp_split_type != ISP_NO_SPLIT or not p.lfnst_dc_only) and \
                    p.lfnst_zero_out_sig_coeff_flag:
                inc = int(tree_type != SINGLE_TREE)
                if self.decode:
                    if self.e.decode_bin(CTX.LFNST_IDX + inc):
                        lfnst_idx = 2 if self.e.decode_bin(CTX.LFNST_IDX + 2) else 1
                else:
                    lfnst_idx = int(self.policy("lfnst_idx", x0=cu.x0, y0=cu.y0))
                    self.e.encode_bin(CTX.LFNST_IDX + inc, int(lfnst_idx > 0))
                    if lfnst_idx:
                        self.e.encode_bin(CTX.LFNST_IDX + 2, int(lfnst_idx == 2))
        if lfnst_idx:
            cu.apply_lfnst_flag[LUMA] = int(tree_type != DUAL_TREE_CHROMA)
            cu.apply_lfnst_flag[CB] = cu.apply_lfnst_flag[CR] = \
                int(tree_type == DUAL_TREE_CHROMA)
        return lfnst_idx

    def mts_idx_decode(self, cu):
        sps = self.sps
        p = self.parse
        ts = cu.tus[0].tbs[0].ts if cu.tus and cu.tus[0].tbs else 0
        if cu.tree_type != DUAL_TREE_CHROMA and not cu.lfnst_idx and \
                not ts and max(cu.cb_width, cu.cb_height) <= 32 and \
                cu.isp_split_type == ISP_NO_SPLIT and not cu.sbt_flag and \
                p.mts_zero_out_sig_coeff_flag and not p.mts_dc_only:
            if (cu.pred_mode == MODE_INTER and
                    sps.r.sps_explicit_mts_inter_enabled_flag) or \
                    (cu.pred_mode == MODE_INTRA and
                     sps.r.sps_explicit_mts_intra_enabled_flag):
                if self.decode:
                    i = 0
                    while i < 4 and self.e.decode_bin(CTX.MTS_IDX + i):
                        i += 1
                    return i
                v = int(self.policy("mts_idx", x0=cu.x0, y0=cu.y0))
                for i in range(v):
                    self.e.encode_bin(CTX.MTS_IDX + i, 1)
                if v < 4:
                    self.e.encode_bin(CTX.MTS_IDX + v, 0)
                return v
        return MTS_DCT2_DCT2

    def set_cu_tabs(self, cu):
        """set_cu_tabs (vvc_ctu.c:1229): per-CU maps + per-TB chroma QP/pcmf."""
        tabs = self.tabs
        sps = self.sps
        x0, y0, w, h = cu.x0, cu.y0, cu.cb_width, cu.cb_height
        ch = cu.ch_type
        set_grid(tabs.cb_pos_x[ch], x0, y0, w, h, x0)
        set_grid(tabs.cb_pos_y[ch], x0, y0, w, h, y0)
        set_grid(tabs.cb_width[ch], x0, y0, w, h, w)
        set_grid(tabs.cb_height[ch], x0, y0, w, h, h)
        set_grid(tabs.cqt_depth[ch], x0, y0, w, h, cu.cqt_depth)
        pu = cu.pu
        set_grid(tabs.mmi, x0, y0, w, h,
                 pu.mi.motion_model_idc if pu else 0)
        set_grid(tabs.msf, x0, y0, w, h,
                 pu.merge_subblock_flag if pu else 0)
        if cu.tree_type != DUAL_TREE_CHROMA:
            set_grid(tabs.skip, x0, y0, w, h, cu.skip_flag)
        for tu in cu.tus:
            for tb in tu.tbs:
                if tb.c_idx != LUMA:
                    is_jcbcr = tu.joint_cbcr_residual_flag and \
                        tu.coded_flag[CB] and tu.coded_flag[CR]
                    idx = JCBCR if is_jcbcr else tb.c_idx
                    self._set_tb_grid(tabs.qp[tb.c_idx], tb, cu.qp[idx])
                if tb.c_idx != CR and cu.bdpcm_flag[tb.c_idx]:
                    self._set_tb_grid(tabs.pcmf[tb.c_idx], tb, 1)

    # --- SAO / ALF / deblock per-CTU params (vvc_ctu.c:2147-2266) -----------

    def sao_params(self, rx, ry, rs):
        """hls_sao (vvc_ctu.c:2147): merge flags, type, offsets, band/eo.

        tabs.sao_offset[rs, c] holds the derived offset_val[5] (scaled to
        bit depth); band position / eo class stored separately.
        """
        sps = self.sps
        rsh = self.sh.r
        tabs = self.tabs
        merge_left = merge_up = 0
        if rsh.sh_sao_luma_used_flag or rsh.sh_sao_chroma_used_flag:
            if rx > 0 and self.ctb_left_flag:
                merge_left = self.bin(CTX.SAO_MERGE_FLAG, "sao_merge_left",
                                      rx=rx, ry=ry)
            if ry > 0 and not merge_left and self.ctb_up_flag:
                merge_up = self.bin(CTX.SAO_MERGE_FLAG, "sao_merge_up",
                                    rx=rx, ry=ry)
        merged_src = rs - 1 if merge_left else (
            rs - self.pps.ctb_width if merge_up else None)
        nc = 3 if sps.chroma_format_idc else 1
        scale = 1 << (sps.bit_depth - min(10, sps.bit_depth))
        for c in range(nc):
            used = rsh.sh_sao_luma_used_flag if c == 0 else \
                rsh.sh_sao_chroma_used_flag
            if not used:
                tabs.sao_type[rs, c] = SAO_NOT_APPLIED
                continue
            if merged_src is not None:
                tabs.sao_type[rs, c] = tabs.sao_type[merged_src, c]
                tabs.sao_band_pos[rs, c] = tabs.sao_band_pos[merged_src, c]
                tabs.sao_eo_class[rs, c] = tabs.sao_eo_class[merged_src, c]
                tabs.sao_offset[rs, c] = tabs.sao_offset[merged_src, c]
                continue
            if c == 2:
                tabs.sao_type[rs, 2] = tabs.sao_type[rs, 1]
                tabs.sao_eo_class[rs, 2] = tabs.sao_eo_class[rs, 1]
            else:
                if self.decode:
                    if not self.e.decode_bin(CTX.SAO_TYPE_IDX):
                        t = SAO_NOT_APPLIED
                    else:
                        t = SAO_EDGE if self.e.decode_bypass() else SAO_BAND
                else:
                    t = int(self.policy("sao_type", rx=rx, ry=ry, c_idx=c))
                    self.e.encode_bin(CTX.SAO_TYPE_IDX, int(t != SAO_NOT_APPLIED))
                    if t != SAO_NOT_APPLIED:
                        self.e.encode_bypass(int(t == SAO_EDGE))
                tabs.sao_type[rs, c] = t
            if tabs.sao_type[rs, c] == SAO_NOT_APPLIED:
                continue
            length = (1 << (min(sps.bit_depth, 10) - 5)) - 1
            offset_abs = []
            for i in range(4):
                if self.decode:
                    v = 0
                    while v < length and self.e.decode_bypass():
                        v += 1
                else:
                    v = int(self.policy("sao_offset_abs", rx=rx, ry=ry,
                                        c_idx=c, i=i, c_max=length))
                    for _ in range(v):
                        self.e.encode_bypass(1)
                    if v < length:
                        self.e.encode_bypass(0)
                offset_abs.append(v)
            offset_sign = [0, 0, 0, 0]
            if tabs.sao_type[rs, c] == SAO_BAND:
                for i in range(4):
                    if offset_abs[i]:
                        if self.decode:
                            offset_sign[i] = self.e.decode_bypass()
                        else:
                            offset_sign[i] = int(self.policy(
                                "sao_offset_sign", rx=rx, ry=ry, c_idx=c, i=i))
                            self.e.encode_bypass(offset_sign[i])
                if self.decode:
                    bp = self.e.decode_bypass_bits(5)
                else:
                    bp = int(self.policy("sao_band_position", rx=rx, ry=ry,
                                         c_idx=c))
                    self.e.encode_bypass_bits(bp, 5)
                tabs.sao_band_pos[rs, c] = bp
            elif c != 2:
                if self.decode:
                    eo = (self.e.decode_bypass() << 1) | self.e.decode_bypass()
                else:
                    eo = int(self.policy("sao_eo_class", rx=rx, ry=ry, c_idx=c))
                    self.e.encode_bypass((eo >> 1) & 1)
                    self.e.encode_bypass(eo & 1)
                tabs.sao_eo_class[rs, c] = eo
            vals = [0] * 5
            for i in range(4):
                v = offset_abs[i]
                if tabs.sao_type[rs, c] == SAO_EDGE:
                    if i > 1:
                        v = -v
                elif offset_sign[i]:
                    v = -v
                vals[i + 1] = v * scale
            tabs.sao_offset[rs, c] = vals

    def alf_params(self, rx, ry, rs):
        sps = self.sps
        sh = self.sh.r
        tabs = self.tabs
        if not sps.r.sps_alf_enabled_flag:
            return
        alf_enabled = sh.sh_alf_enabled_flag
        if alf_enabled:
            for c in range(3 if sps.chroma_format_idc else 1):
                enabled = [sh.sh_alf_enabled_flag, sh.sh_alf_cb_enabled_flag,
                           sh.sh_alf_cr_enabled_flag][c]
                if not enabled:
                    tabs.alf_ctb_flag[rs, c] = 0
                    continue
                inc = c * 3
                if self.ctb_left_flag:
                    inc += int(tabs.alf_ctb_flag[rs - 1, c])
                if self.ctb_up_flag:
                    inc += int(tabs.alf_ctb_flag[rs - self.pps.ctb_width, c])
                flag = self.bin(CTX.ALF_CTB_FLAG + inc, "alf_ctb_flag",
                                rx=rx, ry=ry, c_idx=c)
                tabs.alf_ctb_flag[rs, c] = flag
                if c == 0 and flag:
                    use_aps = 0
                    if sh.sh_num_alf_aps_ids_luma > 0:
                        use_aps = self.bin(CTX.ALF_USE_APS_FLAG, "alf_use_aps",
                                           rx=rx, ry=ry)
                    tabs.alf_fixed[rs] = int(not use_aps)
                    if use_aps:
                        idx = 0
                        if sh.sh_num_alf_aps_ids_luma > 1:
                            idx = self.tb_code("alf_prev_filt_idx",
                                               sh.sh_num_alf_aps_ids_luma - 1,
                                               rx=rx, ry=ry)
                        tabs.alf_filt_idx[rs] = idx
                        tabs.alf_aps_id[rs, 0] = sh.sh_alf_aps_id_luma[idx]
                    else:
                        tabs.alf_filt_idx[rs] = self.tb_code(
                            "alf_fixed_filt_idx", 15, rx=rx, ry=ry)
                elif c and flag:
                    tabs.alf_aps_id[rs, c] = sh.sh_alf_aps_id_chroma
                    num_alts = self.num_chroma_alt_filters
                    alt = 0
                    if num_alts > 1:
                        while alt < num_alts - 1 and \
                                self.bin(CTX.ALF_CTB_FILTER_ALT_IDX + c - 1,
                                         "alf_alt_idx", rx=rx, ry=ry, c_idx=c,
                                         i=alt):
                            alt += 1
                    tabs.alf_alt_idx[rs, c - 1] = alt
        if sps.r.sps_ccalf_enabled_flag:
            cc_enabled = [sh.sh_alf_cc_cb_enabled_flag,
                          sh.sh_alf_cc_cr_enabled_flag]
            for i in range(2):
                tabs.alf_cc_idc[rs, i] = 0
                if cc_enabled[i]:
                    base = CTX.ALF_CTB_CC_CB_IDC if i == 0 else CTX.ALF_CTB_CC_CR_IDC
                    inc = 0
                    if self.ctb_left_flag:
                        inc += int(tabs.alf_cc_idc[rs - 1, i] != 0)
                    if self.ctb_up_flag:
                        inc += int(tabs.alf_cc_idc[rs - self.pps.ctb_width, i] != 0)
                    v = self.bin(base + inc, "alf_cc_idc", rx=rx, ry=ry, i=i)
                    if v:
                        idc = 1
                        nf = self.num_cc_filters[i]
                        while idc < nf and self.bypass("alf_cc_idc_tail",
                                                       rx=rx, ry=ry, i=i, j=idc):
                            idc += 1
                        v = idc
                    tabs.alf_cc_idc[rs, i] = v

    num_chroma_alt_filters = 1
    num_cc_filters = (0, 0)

    # --- CTU entry (vvc_ctu.c:2435) -----------------------------------------

    def coding_tree_unit(self, ctu_idx, rs, rx, ry, num_ctus_in_slice,
                         slice_idx):
        sps, pps = self.sps, self.pps
        rsh = self.sh.r
        x_ctb = rx << sps.ctb_log2_size_y
        y_ctb = ry << sps.ctb_log2_size_y
        if rx == pps.ctb_to_col_bd[rx]:
            self.hmvp = []
            self.is_first_qg = ry == pps.ctb_to_row_bd[ry] or not ctu_idx
        self.tabs.slice_idx[ry, rx] = slice_idx
        self.cur_cus = self.tabs.cus[rs]
        self.parse.chroma_qp_offset = [0, 0, 0]
        self.decode_neighbour(x_ctb, y_ctb, rx, ry, rs)
        self.sao_params(rx, ry, rs)
        self.alf_params(rx, ry, rs)
        self.tabs.deblock_disabled[rs] = int(self.sh.lf_disabled)
        self.tabs.deblock_beta[rs] = self.sh.beta_offset
        self.tabs.deblock_tc[rs] = self.sh.tc_offset
        ctb_size = sps.ctb_size_y
        if rsh.sh_slice_type == SLICE_I and \
                sps.r.sps_qtbtt_dual_tree_intra_flag:
            self.dual_tree_implicit_qt_split(x_ctb, y_ctb, ctb_size, 0)
        else:
            self.coding_tree(x_ctb, y_ctb, ctb_size, ctb_size, 1, 1, 0, 0, 0,
                             0, 0, SPLIT_NONE, SINGLE_TREE, MODE_TYPE_ALL)
        # terminate bits
        if rx == pps.ctb_to_col_bd[rx + 1] - 1:  # last CTU column of tile
            if ctu_idx == num_ctus_in_slice - 1:
                one = self.terminate(1)
                if self.decode and not one:
                    raise ValueError("end_of_slice_one_bit != 1")
                return "end_of_slice"
            if ry == pps.ctb_to_row_bd[ry + 1] - 1:
                one = self.terminate(1)
                if self.decode and not one:
                    raise ValueError("end_of_tile_one_bit != 1")
                return "end_of_tile"
            if sps.r.sps_entropy_coding_sync_enabled_flag:
                one = self.terminate(1)
                if self.decode and not one:
                    raise ValueError("end_of_subset_one_bit != 1")
                return "end_of_subset"
        return None

    def dual_tree_implicit_qt_split(self, x0, y0, cb_size, cqt_depth):
        sps, pps = self.sps, self.pps
        rsh = self.sh.r
        p = self.parse
        cb_subdiv = 2 * cqt_depth
        if cb_size > 64:
            x1 = x0 + cb_size // 2
            y1 = y0 + cb_size // 2
            if pps.r.pps_cu_qp_delta_enabled_flag and \
                    cb_subdiv <= self.cu_qp_delta_subdiv:
                p.is_cu_qp_delta_coded = 0
                p.cu_qg_top_left_x = x0
                p.cu_qg_top_left_y = y0
            if rsh.sh_cu_chroma_qp_offset_enabled_flag and \
                    cb_subdiv <= self.cu_chroma_qp_offset_subdiv:
                p.is_cu_chroma_qp_offset_coded = 0
                p.chroma_qp_offset = [0, 0, 0]
            for (xx, yy) in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
                if xx < pps.width and yy < pps.height:
                    self.dual_tree_implicit_qt_split(xx, yy, cb_size // 2,
                                                     cqt_depth + 1)
        else:
            for tree_type in (DUAL_TREE_LUMA, DUAL_TREE_CHROMA):
                qg_on_y = tree_type == DUAL_TREE_LUMA
                self.coding_tree(x0, y0, cb_size, cb_size, int(qg_on_y),
                                 int(not qg_on_y), cb_subdiv, cqt_depth, 0, 0,
                                 0, SPLIT_NONE, tree_type, MODE_TYPE_ALL)
