"""ctypes binding for the native CTU parse core (native/vvc_parse.c).

The C library parses the coding-tree portion of a CTU (intra slices) in one
call, filling the FrameTabs planes in place and emitting flat CU/TU/TB
records that are converted back into the CodingUnit objects the recon walk
consumes.  ffvvc_tpu/ctu.py remains the golden model (and the encode path);
`make_native_tree` returns None whenever the stream uses a tool the C core
doesn't cover yet, falling back to Python per slice.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ._build import load_native

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_DIR, "native", "vvc_parse.c"),
         os.path.join(_DIR, "native", "vvc_mvs.c"),
         os.path.join(_DIR, "native", "vvc_cabac.c")]
_HDRS = [os.path.join(_DIR, "native", "vvc_cabac.h"),
         os.path.join(_DIR, "native", "vvc_parse.h")]

CU_STRIDE, TU_STRIDE, TB_STRIDE = 52, 12, 12

_I = ctypes.c_int
_P = ctypes.c_void_p


class _SliceParams(ctypes.Structure):
    _fields_ = (
        [(n, _I) for n in (
            "width", "height", "ctb_log2", "min_cb_log2", "w4", "h4",
            "w32", "w64", "ctb_width", "ctb_height", "chroma_format_idc",
            "hshift1", "vshift1", "bit_depth", "qp_bd_offset",
            "max_tb_size_y", "max_ts_size", "log2_transform_range",
            "sps_mip", "sps_mrl", "sps_isp", "sps_cclm", "sps_dual_tree",
            "sps_bdpcm", "sps_transform_skip", "sps_lfnst", "sps_mts",
            "sps_explicit_mts_intra", "sps_explicit_mts_inter",
            "sps_joint_cbcr", "sps_sbt", "sps_persistent_rice",
            "sps_rrc_rice_ext", "sps_ibc", "sps_act", "sps_palette",
            "pps_cu_qp_delta_enabled",
            "pps_chroma_qp_offset_list_len_minus1")] +
        [("pps_cb_qp_offset_list", _I * 6),
         ("pps_cr_qp_offset_list", _I * 6),
         ("pps_jcbcr_qp_offset_list", _I * 6),
         ("pps_chroma_qp_offset", _I * 3),
         ("sh_cu_chroma_qp_offset_enabled", _I),
         ("sh_chroma_qp_offset", _I * 3)] +
        [(n, _I) for n in (
            "slice_type", "slice_qp_y", "dep_quant", "sdh", "reverse_last",
            "ts_res_disabled", "cu_qp_delta_subdiv",
            "cu_chroma_qp_offset_subdiv")] +
        [("min_qt_size", _I * 2), ("max_mtt_depth", _I * 2),
         ("max_bt_size", _I * 2), ("max_tt_size", _I * 2),
         ("init_stat_coeff", _I)] +
        [(n, _I) for n in (
            "ctx_split_cu", "ctx_split_qt", "ctx_mtt_vertical",
            "ctx_mtt_binary", "ctx_non_inter", "ctx_cu_skip",
            "ctx_pred_mode", "ctx_bdpcm_luma", "ctx_bdpcm_luma_dir",
            "ctx_mip", "ctx_mrl", "ctx_isp_mode", "ctx_isp_split",
            "ctx_mpm", "ctx_not_planar", "ctx_bdpcm_chroma",
            "ctx_bdpcm_chroma_dir", "ctx_cclm_mode_flag",
            "ctx_cclm_mode_idx", "ctx_chroma_pred_mode", "ctx_cu_coded",
            "ctx_sbt_flag", "ctx_sbt_quad", "ctx_sbt_horizontal",
            "ctx_sbt_pos", "ctx_tu_cb", "ctx_tu_cr", "ctx_tu_y",
            "ctx_jcbcr", "ctx_qp_delta_abs", "ctx_chroma_qp_offset_flag",
            "ctx_chroma_qp_offset_idx", "ctx_ts_flag", "ctx_lfnst",
            "ctx_mts", "ctx_sig", "ctx_last_x", "ctx_last_y",
            "ctx_sb_coded", "ctx_gtx", "ctx_par")] +
        [(n, _P) for n in (
            "qp0", "qp1", "qp2", "qp3", "cpm0", "cpm1", "ipm", "imf",
            "imtf", "imm", "skip", "cb_width0", "cb_width1", "cb_height0",
            "cb_height1", "cb_pos_x0", "cb_pos_x1", "cb_pos_y0",
            "cb_pos_y1", "cqt_depth0", "cqt_depth1", "tu_coded0",
            "tu_coded1", "tu_coded2", "tu_joint_cbcr", "tb_pos_x0",
            "tb_pos_x1", "tb_pos_y0", "tb_pos_y1", "tb_width0",
            "tb_width1", "tb_height0", "tb_height1", "pcmf0", "pcmf1",
            "msf", "mmi", "mvf_pf", "col_pf", "msm0", "msm1", "ispmf",
            "slice_idx", "ctb_to_col_bd", "ctb_to_row_bd",
            "chroma_qp_table")] +
        [("qp_table_len", _I)] +
        [(n, _I) for n in (
            "sps_alf", "sps_ccalf", "sao_luma_used", "sao_chroma_used",
            "alf_enabled", "alf_cb_enabled", "alf_cr_enabled",
            "alf_cc_cb_enabled", "alf_cc_cr_enabled",
            "num_alf_aps_ids_luma")] +
        [("alf_aps_id_luma", _I * 8),
         ("alf_aps_id_chroma", _I),
         ("num_chroma_alt_filters", _I),
         ("num_cc_filters", _I * 2)] +
        [(n, _I) for n in (
            "ctx_sao_merge", "ctx_sao_type", "ctx_alf_ctb_flag",
            "ctx_alf_use_aps", "ctx_alf_alt_idx", "ctx_alf_cc_cb",
            "ctx_alf_cc_cr")] +
        [(n, _P) for n in (
            "sao_type_tab", "sao_band_pos", "sao_eo_class", "sao_offset",
            "alf_ctb_flag", "alf_aps_id", "alf_fixed", "alf_filt_idx",
            "alf_alt_idx", "alf_cc_idc")] +
        [("ts_rice", _I), ("ctx_coeff_sign", _I)] +
        # --- inter (P/B) parse + MV derivation (vvc_parse.h) ------------
        [(n, _I) for n in ("is_b", "is_p", "poc", "sps_width_max",
                           "sps_height_max")] +
        [("num_ref_idx_active", _I * 2), ("rpl_nrefs", _I * 2),
         ("rpl_poc", _I * 32), ("rpl_is_lt", _I * 32)] +
        [(n, _I) for n in ("max_num_merge_cand", "max_num_gpm_cand",
                           "max_num_sb_merge_cand",
                           "log2_parallel_merge_level")] +
        [("ref_idx_sym", _I * 2), ("wp_flag", _I * 64)] +
        [(n, _I) for n in (
            "sps_mmvd", "sps_gpm", "sps_ciip", "sps_affine",
            "sps_6param_affine", "sps_sbtmvp", "sps_amvr",
            "sps_affine_amvr", "sps_smvd", "sps_bcw", "sps_wpp",
            "ph_temporal_mvp", "ph_mmvd_fullpel", "ph_mvd_l1_zero",
            "ph_bdof_disabled", "ph_dmvr_disabled", "ph_prof_disabled",
            "sh_collocated_from_l0",
            "col_poc", "col_ctb_log2", "col_ctb_width")] +
        [("col_slice_idx", _P), ("col_nslices", _I),
         ("col_rpl_nrefs", _P), ("col_rpl_poc", _P),
         ("col_rpl_is_lt", _P)] +
        [(n, _P) for n in (
            "colf_pf", "colf_mv", "colf_ref",
            "mvf_mv", "mvf_ref", "mvf_bcw", "mvf_hpel", "mvf_ciip",
            "col_mv", "col_ref", "cp_mv", "iaf",
            "gpm_angle_idx", "gpm_distance_idx", "gpm_distance_lut")] +
        [(n, _I) for n in (
            "ctx_general_merge", "ctx_merge_subblock",
            "ctx_merge_subblock_idx", "ctx_regular_merge", "ctx_mmvd_merge",
            "ctx_mmvd_cand", "ctx_mmvd_distance", "ctx_ciip",
            "ctx_merge_idx", "ctx_inter_pred_idc", "ctx_ref_idx",
            "ctx_mvd_gt0", "ctx_mvd_gt1", "ctx_mvp_lx", "ctx_sym_mvd",
            "ctx_inter_affine", "ctx_affine_type", "ctx_amvr_flag",
            "ctx_amvr_precision", "ctx_bcw")])


class _SliceState(ctypes.Structure):
    _fields_ = [("qp_y", _I), ("is_first_qg", _I), ("stat_coeff", _I * 3),
                ("is_cu_qp_delta_coded", _I),
                ("is_cu_chroma_qp_offset_coded", _I),
                ("cu_qg_top_left_x", _I), ("cu_qg_top_left_y", _I),
                ("chroma_qp_offset", _I * 3), ("prev_tu_cbf_y", _I),
                ("infer_tu_cbf_luma", _I),
                ("hmvp_len", _I), ("hmvp", _I * 50)]


class _ParseOut(ctypes.Structure):
    _fields_ = [("cu", _P), ("tu", _P), ("tb", _P), ("coeff", _P),
                ("cu_cap", _I), ("tu_cap", _I), ("tb_cap", _I),
                ("coeff_cap", _I), ("n_cu", _I), ("n_tu", _I), ("n_tb", _I),
                ("coeff_len", _I), ("err", _I)]


@functools.lru_cache()
def load_lib():
    lib = load_native("vvc_parse", _SRCS, _HDRS)
    lib.parse_ctu.argtypes = [_P, ctypes.POINTER(_SliceParams),
                              ctypes.POINTER(_SliceState),
                              ctypes.POINTER(_ParseOut),
                              _I, _I, _I, _I]
    lib.parse_ctu.restype = _I
    lib.parse_ctus.argtypes = [_P, ctypes.POINTER(_SliceParams),
                               ctypes.POINTER(_SliceState),
                               ctypes.POINTER(_ParseOut),
                               _P, _I, _P, _P, _P, _I]
    lib.parse_ctus.restype = _I
    # guard the ctypes struct mirrors against C layout drift
    assert lib.vvcp_sizeof_params() == ctypes.sizeof(_SliceParams), \
        (lib.vvcp_sizeof_params(), ctypes.sizeof(_SliceParams))
    assert lib.vvcp_sizeof_state() == ctypes.sizeof(_SliceState), \
        (lib.vvcp_sizeof_state(), ctypes.sizeof(_SliceState))
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


class NativeTreeParser:
    """Per-slice native parse context; call per CTU from coding_tree_unit."""

    def __init__(self, coder, lib):
        from ..cabac.engine import CTX

        self.lib = lib
        self.coder = coder
        sps, pps, sh = coder.sps, coder.pps, coder.sh
        tabs = coder.tabs
        sp = _SliceParams()
        self._keep = keep = []

        sp.width, sp.height = pps.width, pps.height
        sp.ctb_log2 = sps.ctb_log2_size_y
        sp.min_cb_log2 = sps.min_cb_log2_size_y
        sp.w4, sp.h4 = tabs.w4, tabs.h4
        sp.w32 = tabs.msm.shape[2]
        sp.w64 = tabs.ispmf.shape[1]
        sp.ctb_width, sp.ctb_height = pps.ctb_width, pps.ctb_height
        sp.chroma_format_idc = sps.chroma_format_idc
        sp.hshift1 = sps.hshift[1]
        sp.vshift1 = sps.vshift[1]
        sp.bit_depth = sps.bit_depth
        sp.qp_bd_offset = sps.qp_bd_offset
        sp.max_tb_size_y = sps.max_tb_size_y
        sp.max_ts_size = sps.max_ts_size
        sp.log2_transform_range = coder.log2_transform_range
        r = sps.r
        sp.sps_mip = r.sps_mip_enabled_flag
        sp.sps_mrl = r.sps_mrl_enabled_flag
        sp.sps_isp = r.sps_isp_enabled_flag
        sp.sps_cclm = r.sps_cclm_enabled_flag
        sp.sps_dual_tree = r.sps_qtbtt_dual_tree_intra_flag
        sp.sps_bdpcm = r.sps_bdpcm_enabled_flag
        sp.sps_transform_skip = r.sps_transform_skip_enabled_flag
        sp.sps_lfnst = r.sps_lfnst_enabled_flag
        sp.sps_mts = r.sps_mts_enabled_flag
        sp.sps_explicit_mts_intra = r.sps_explicit_mts_intra_enabled_flag
        sp.sps_explicit_mts_inter = r.sps_explicit_mts_inter_enabled_flag
        sp.sps_joint_cbcr = r.sps_joint_cbcr_enabled_flag
        sp.sps_sbt = r.sps_sbt_enabled_flag
        sp.sps_persistent_rice = r.sps_persistent_rice_adaptation_enabled_flag
        sp.sps_rrc_rice_ext = r.sps_rrc_rice_extension_flag
        sp.sps_ibc = r.sps_ibc_enabled_flag
        sp.sps_act = r.sps_act_enabled_flag
        sp.sps_palette = r.sps_palette_enabled_flag
        rp, rsh = pps.r, sh.r
        sp.pps_cu_qp_delta_enabled = rp.pps_cu_qp_delta_enabled_flag
        sp.pps_chroma_qp_offset_list_len_minus1 = \
            rp.pps_chroma_qp_offset_list_len_minus1
        for i in range(rp.pps_chroma_qp_offset_list_len_minus1 + 1
                       if rp.pps_cu_chroma_qp_offset_list_enabled_flag else 0):
            sp.pps_cb_qp_offset_list[i] = rp.pps_cb_qp_offset_list[i]
            sp.pps_cr_qp_offset_list[i] = rp.pps_cr_qp_offset_list[i]
            sp.pps_jcbcr_qp_offset_list[i] = \
                rp.pps_joint_cbcr_qp_offset_list[i]
        for i in range(3):
            sp.pps_chroma_qp_offset[i] = pps.chroma_qp_offset[i]
        sp.sh_cu_chroma_qp_offset_enabled = \
            rsh.sh_cu_chroma_qp_offset_enabled_flag
        sp.sh_chroma_qp_offset[0] = rsh.sh_cb_qp_offset
        sp.sh_chroma_qp_offset[1] = rsh.sh_cr_qp_offset
        sp.sh_chroma_qp_offset[2] = rsh.sh_joint_cbcr_qp_offset
        sp.slice_type = sh.slice_type
        sp.slice_qp_y = sh.slice_qp_y
        sp.dep_quant = rsh.sh_dep_quant_used_flag
        sp.sdh = rsh.sh_sign_data_hiding_used_flag
        sp.reverse_last = rsh.sh_reverse_last_sig_coeff_flag
        sp.ts_res_disabled = rsh.sh_ts_residual_coding_disabled_flag
        sp.cu_qp_delta_subdiv = coder.cu_qp_delta_subdiv
        sp.cu_chroma_qp_offset_subdiv = coder.cu_chroma_qp_offset_subdiv
        for i in range(2):
            sp.min_qt_size[i] = coder.min_qt_size[i]
            sp.max_mtt_depth[i] = coder.max_mtt_depth[i]
            sp.max_bt_size[i] = coder.max_bt_size[i]
            sp.max_tt_size[i] = coder.max_tt_size[i]
        sp.init_stat_coeff = coder.stat_coeff[0]

        for cname, ctxname in (
                ("ctx_split_cu", "SPLIT_CU_FLAG"),
                ("ctx_split_qt", "SPLIT_QT_FLAG"),
                ("ctx_mtt_vertical", "MTT_SPLIT_CU_VERTICAL_FLAG"),
                ("ctx_mtt_binary", "MTT_SPLIT_CU_BINARY_FLAG"),
                ("ctx_non_inter", "NON_INTER_FLAG"),
                ("ctx_cu_skip", "CU_SKIP_FLAG"),
                ("ctx_pred_mode", "PRED_MODE_FLAG"),
                ("ctx_bdpcm_luma", "INTRA_BDPCM_LUMA_FLAG"),
                ("ctx_bdpcm_luma_dir", "INTRA_BDPCM_LUMA_DIR_FLAG"),
                ("ctx_mip", "INTRA_MIP_FLAG"),
                ("ctx_mrl", "INTRA_LUMA_REF_IDX"),
                ("ctx_isp_mode", "INTRA_SUBPARTITIONS_MODE_FLAG"),
                ("ctx_isp_split", "INTRA_SUBPARTITIONS_SPLIT_FLAG"),
                ("ctx_mpm", "INTRA_LUMA_MPM_FLAG"),
                ("ctx_not_planar", "INTRA_LUMA_NOT_PLANAR_FLAG"),
                ("ctx_bdpcm_chroma", "INTRA_BDPCM_CHROMA_FLAG"),
                ("ctx_bdpcm_chroma_dir", "INTRA_BDPCM_CHROMA_DIR_FLAG"),
                ("ctx_cclm_mode_flag", "CCLM_MODE_FLAG"),
                ("ctx_cclm_mode_idx", "CCLM_MODE_IDX"),
                ("ctx_chroma_pred_mode", "INTRA_CHROMA_PRED_MODE"),
                ("ctx_cu_coded", "CU_CODED_FLAG"),
                ("ctx_sbt_flag", "CU_SBT_FLAG"),
                ("ctx_sbt_quad", "CU_SBT_QUAD_FLAG"),
                ("ctx_sbt_horizontal", "CU_SBT_HORIZONTAL_FLAG"),
                ("ctx_sbt_pos", "CU_SBT_POS_FLAG"),
                ("ctx_tu_cb", "TU_CB_CODED_FLAG"),
                ("ctx_tu_cr", "TU_CR_CODED_FLAG"),
                ("ctx_tu_y", "TU_Y_CODED_FLAG"),
                ("ctx_jcbcr", "TU_JOINT_CBCR_RESIDUAL_FLAG"),
                ("ctx_qp_delta_abs", "CU_QP_DELTA_ABS"),
                ("ctx_chroma_qp_offset_flag", "CU_CHROMA_QP_OFFSET_FLAG"),
                ("ctx_chroma_qp_offset_idx", "CU_CHROMA_QP_OFFSET_IDX"),
                ("ctx_ts_flag", "TRANSFORM_SKIP_FLAG"),
                ("ctx_lfnst", "LFNST_IDX"),
                ("ctx_mts", "MTS_IDX"),
                ("ctx_sig", "SIG_COEFF_FLAG"),
                ("ctx_last_x", "LAST_SIG_COEFF_X_PREFIX"),
                ("ctx_last_y", "LAST_SIG_COEFF_Y_PREFIX"),
                ("ctx_sb_coded", "SB_CODED_FLAG"),
                ("ctx_gtx", "ABS_LEVEL_GTX_FLAG"),
                ("ctx_par", "PAR_LEVEL_FLAG")):
            setattr(sp, cname, getattr(CTX, ctxname))

        def c32(a):
            assert a.dtype == np.int32 and a.flags["C_CONTIGUOUS"]
            keep.append(a)
            return ctypes.c_void_p(a.ctypes.data)

        sp.qp0, sp.qp1, sp.qp2, sp.qp3 = (c32(t) for t in tabs.qp)
        sp.cpm0, sp.cpm1 = c32(tabs.cpm[0]), c32(tabs.cpm[1])
        sp.ipm, sp.imf = c32(tabs.ipm), c32(tabs.imf)
        sp.imtf, sp.imm = c32(tabs.imtf), c32(tabs.imm)
        sp.skip = c32(tabs.skip)
        sp.cb_width0, sp.cb_width1 = (c32(t) for t in tabs.cb_width)
        sp.cb_height0, sp.cb_height1 = (c32(t) for t in tabs.cb_height)
        sp.cb_pos_x0, sp.cb_pos_x1 = (c32(t) for t in tabs.cb_pos_x)
        sp.cb_pos_y0, sp.cb_pos_y1 = (c32(t) for t in tabs.cb_pos_y)
        sp.cqt_depth0, sp.cqt_depth1 = (c32(t) for t in tabs.cqt_depth)
        sp.tu_coded0, sp.tu_coded1, sp.tu_coded2 = \
            (c32(t) for t in tabs.tu_coded_flag)
        sp.tu_joint_cbcr = c32(tabs.tu_joint_cbcr)
        sp.tb_pos_x0, sp.tb_pos_x1 = (c32(t) for t in tabs.tb_pos_x)
        sp.tb_pos_y0, sp.tb_pos_y1 = (c32(t) for t in tabs.tb_pos_y)
        sp.tb_width0, sp.tb_width1 = (c32(t) for t in tabs.tb_width)
        sp.tb_height0, sp.tb_height1 = (c32(t) for t in tabs.tb_height)
        sp.pcmf0, sp.pcmf1 = (c32(t) for t in tabs.pcmf)
        sp.msf, sp.mmi = c32(tabs.msf), c32(tabs.mmi)
        assert tabs.mvf_pf.dtype == np.uint8 and tabs.col_pf.dtype == np.uint8
        keep += [tabs.mvf_pf, tabs.col_pf]
        sp.mvf_pf = ctypes.c_void_p(tabs.mvf_pf.ctypes.data)
        sp.col_pf = ctypes.c_void_p(tabs.col_pf.ctypes.data)
        sp.msm0, sp.msm1 = c32(tabs.msm[0]), c32(tabs.msm[1])
        sp.ispmf = c32(tabs.ispmf)
        sp.slice_idx = c32(tabs.slice_idx)
        col_bd = np.ascontiguousarray(np.asarray(pps.ctb_to_col_bd, np.int32))
        row_bd = np.ascontiguousarray(np.asarray(pps.ctb_to_row_bd, np.int32))
        sp.ctb_to_col_bd = c32(col_bd)
        sp.ctb_to_row_bd = c32(row_bd)
        qpt = np.ascontiguousarray(sps.chroma_qp_table.astype(np.int32))
        sp.chroma_qp_table = c32(qpt)
        sp.qp_table_len = qpt.shape[1]
        # per-CTU SAO / ALF param parse (ctu.py sao_params/alf_params)
        sp.sps_alf = r.sps_alf_enabled_flag
        sp.sps_ccalf = r.sps_ccalf_enabled_flag
        sp.sao_luma_used = rsh.sh_sao_luma_used_flag
        sp.sao_chroma_used = rsh.sh_sao_chroma_used_flag
        sp.alf_enabled = rsh.sh_alf_enabled_flag
        sp.alf_cb_enabled = rsh.sh_alf_cb_enabled_flag
        sp.alf_cr_enabled = rsh.sh_alf_cr_enabled_flag
        sp.alf_cc_cb_enabled = rsh.sh_alf_cc_cb_enabled_flag
        sp.alf_cc_cr_enabled = rsh.sh_alf_cc_cr_enabled_flag
        # clamp to the fixed array (corrupt headers could claim more)
        sp.num_alf_aps_ids_luma = min(rsh.sh_num_alf_aps_ids_luma, 8)
        ids = rsh.sh_alf_aps_id_luma or []
        for i, v in enumerate(list(ids)[:8]):
            sp.alf_aps_id_luma[i] = v
        sp.alf_aps_id_chroma = rsh.sh_alf_aps_id_chroma
        sp.num_chroma_alt_filters = coder.num_chroma_alt_filters
        sp.num_cc_filters[0] = coder.num_cc_filters[0]
        sp.num_cc_filters[1] = coder.num_cc_filters[1]
        sp.ctx_sao_merge = CTX.SAO_MERGE_FLAG
        sp.ctx_sao_type = CTX.SAO_TYPE_IDX
        sp.ctx_alf_ctb_flag = CTX.ALF_CTB_FLAG
        sp.ctx_alf_use_aps = CTX.ALF_USE_APS_FLAG
        sp.ctx_alf_alt_idx = CTX.ALF_CTB_FILTER_ALT_IDX
        sp.ctx_alf_cc_cb = CTX.ALF_CTB_CC_CB_IDC
        sp.ctx_alf_cc_cr = CTX.ALF_CTB_CC_CR_IDC
        sp.sao_type_tab = c32(tabs.sao_type)
        sp.sao_band_pos = c32(tabs.sao_band_pos)
        sp.sao_eo_class = c32(tabs.sao_eo_class)
        sp.sao_offset = c32(tabs.sao_offset)
        sp.alf_ctb_flag = c32(tabs.alf_ctb_flag)
        sp.alf_aps_id = c32(tabs.alf_aps_id)
        sp.alf_fixed = c32(tabs.alf_fixed)
        sp.alf_filt_idx = c32(tabs.alf_filt_idx)
        sp.alf_alt_idx = c32(tabs.alf_alt_idx)
        sp.alf_cc_idc = c32(tabs.alf_cc_idc)
        sp.ts_rice = rsh.sh_ts_residual_coding_rice_idx_minus1 + 1
        sp.ctx_coeff_sign = CTX.COEFF_SIGN_FLAG

        # --- inter (P/B) parse + MV derivation ---------------------------
        from ..bitstream.h266 import SLICE_I
        ph = sh.ph
        sp.is_b = int(sh.is_b)
        sp.is_p = int(sh.is_p)
        sp.poc = coder.poc
        sp.sps_width_max = r.sps_pic_width_max_in_luma_samples
        sp.sps_height_max = r.sps_pic_height_max_in_luma_samples
        for lx in range(2):
            sp.num_ref_idx_active[lx] = rsh.num_ref_idx_active[lx] \
                if sh.slice_type != SLICE_I else 0
        rpl = coder.rpl or []
        for lx in range(min(2, len(rpl))):
            n = min(rpl[lx].nb_refs, 16)
            sp.rpl_nrefs[lx] = n
            for i in range(n):
                sp.rpl_poc[lx * 16 + i] = rpl[lx].poc_list[i]
                sp.rpl_is_lt[lx * 16 + i] = int(rpl[lx].is_lt[i])
        sp.max_num_merge_cand = sps.max_num_merge_cand
        sp.max_num_gpm_cand = sps.max_num_gpm_merge_cand
        sp.max_num_sb_merge_cand = coder.max_num_subblock_merge_cand() \
            if sh.slice_type != SLICE_I else 0
        sp.log2_parallel_merge_level = sps.log2_parallel_merge_level
        sp.ref_idx_sym[0] = sh.ref_idx_sym[0]
        sp.ref_idx_sym[1] = sh.ref_idx_sym[1]
        pwt = coder.pwt
        if pwt is not None:
            for lx in range(2):
                for ch in range(2):
                    for i in range(16):
                        sp.wp_flag[(lx * 2 + ch) * 16 + i] = \
                            pwt.weight_flag(lx, ch, i)
        sp.sps_mmvd = r.sps_mmvd_enabled_flag
        sp.sps_gpm = r.sps_gpm_enabled_flag
        sp.sps_ciip = r.sps_ciip_enabled_flag
        sp.sps_affine = r.sps_affine_enabled_flag
        sp.sps_6param_affine = r.sps_6param_affine_enabled_flag
        sp.sps_sbtmvp = r.sps_sbtmvp_enabled_flag
        sp.sps_amvr = r.sps_amvr_enabled_flag
        sp.sps_affine_amvr = r.sps_affine_amvr_enabled_flag
        sp.sps_smvd = r.sps_smvd_enabled_flag
        sp.sps_bcw = r.sps_bcw_enabled_flag
        sp.sps_wpp = r.sps_entropy_coding_sync_enabled_flag
        sp.ph_temporal_mvp = ph.ph_temporal_mvp_enabled_flag
        sp.ph_mmvd_fullpel = ph.ph_mmvd_fullpel_only_flag
        sp.ph_mvd_l1_zero = ph.ph_mvd_l1_zero_flag
        sp.ph_bdof_disabled = getattr(ph, "ph_bdof_disabled_flag", 1)
        sp.ph_dmvr_disabled = getattr(ph, "ph_dmvr_disabled_flag", 1)
        sp.ph_prof_disabled = getattr(ph, "ph_prof_disabled_flag", 1)
        sp.sh_collocated_from_l0 = rsh.sh_collocated_from_l0_flag
        col = coder.collocated_ref
        if col is not None:
            ct = col.tabs
            sp.col_poc = col.poc
            sp.col_ctb_log2 = col._ctb_log2
            sp.col_ctb_width = ct.slice_idx.shape[1]
            sp.col_slice_idx = c32(np.ascontiguousarray(ct.slice_idx))
            nsl = len(col.slice_rpls)
            sp.col_nslices = nsl
            cr_n = np.zeros((nsl, 2), np.int32)
            cr_poc = np.zeros((nsl, 2, 16), np.int32)
            cr_lt = np.zeros((nsl, 2, 16), np.int32)
            for si, pair in enumerate(col.slice_rpls):
                for lx in range(2):
                    n = min(pair[lx].nb_refs, 16)
                    cr_n[si, lx] = n
                    for i in range(n):
                        cr_poc[si, lx, i] = pair[lx].poc_list[i]
                        cr_lt[si, lx, i] = int(pair[lx].is_lt[i])
            sp.col_rpl_nrefs = c32(cr_n)
            sp.col_rpl_poc = c32(cr_poc)
            sp.col_rpl_is_lt = c32(cr_lt)
            keep += [ct.col_pf, ct.col_mv, ct.col_ref]
            sp.colf_pf = ctypes.c_void_p(ct.col_pf.ctypes.data)
            sp.colf_mv = ctypes.c_void_p(ct.col_mv.ctypes.data)
            sp.colf_ref = ctypes.c_void_p(ct.col_ref.ctypes.data)
        keep += [tabs.mvf_mv, tabs.mvf_ref, tabs.mvf_bcw, tabs.mvf_hpel,
                 tabs.mvf_ciip, tabs.col_mv, tabs.col_ref, tabs.cp_mv]
        sp.mvf_mv = ctypes.c_void_p(tabs.mvf_mv.ctypes.data)
        sp.mvf_ref = ctypes.c_void_p(tabs.mvf_ref.ctypes.data)
        sp.mvf_bcw = ctypes.c_void_p(tabs.mvf_bcw.ctypes.data)
        sp.mvf_hpel = ctypes.c_void_p(tabs.mvf_hpel.ctypes.data)
        sp.mvf_ciip = ctypes.c_void_p(tabs.mvf_ciip.ctypes.data)
        sp.col_mv = ctypes.c_void_p(tabs.col_mv.ctypes.data)
        sp.col_ref = ctypes.c_void_p(tabs.col_ref.ctypes.data)
        sp.cp_mv = ctypes.c_void_p(tabs.cp_mv.ctypes.data)
        sp.iaf = c32(tabs.iaf)
        from ..ops import data as D
        t = D.tables()
        gpm_ai = np.ascontiguousarray(t["gpm_angle_idx"])
        gpm_di = np.ascontiguousarray(t["gpm_distance_idx"])
        gpm_dl = np.ascontiguousarray(t["gpm_distance_lut"])
        keep += [gpm_ai, gpm_di, gpm_dl]
        sp.gpm_angle_idx = ctypes.c_void_p(gpm_ai.ctypes.data)
        sp.gpm_distance_idx = ctypes.c_void_p(gpm_di.ctypes.data)
        sp.gpm_distance_lut = ctypes.c_void_p(gpm_dl.ctypes.data)
        sp.ctx_general_merge = CTX.GENERAL_MERGE_FLAG
        sp.ctx_merge_subblock = CTX.MERGE_SUBBLOCK_FLAG
        sp.ctx_merge_subblock_idx = CTX.MERGE_SUBBLOCK_IDX
        sp.ctx_regular_merge = CTX.REGULAR_MERGE_FLAG
        sp.ctx_mmvd_merge = CTX.MMVD_MERGE_FLAG
        sp.ctx_mmvd_cand = CTX.MMVD_CAND_FLAG
        sp.ctx_mmvd_distance = CTX.MMVD_DISTANCE_IDX
        sp.ctx_ciip = CTX.CIIP_FLAG
        sp.ctx_merge_idx = CTX.MERGE_IDX
        sp.ctx_inter_pred_idc = CTX.INTER_PRED_IDC
        sp.ctx_ref_idx = CTX.REF_IDX_LX
        sp.ctx_mvd_gt0 = CTX.ABS_MVD_GREATER0_FLAG
        sp.ctx_mvd_gt1 = CTX.ABS_MVD_GREATER1_FLAG
        sp.ctx_mvp_lx = CTX.MVP_LX_FLAG
        sp.ctx_sym_mvd = CTX.SYM_MVD_FLAG
        sp.ctx_inter_affine = CTX.INTER_AFFINE_FLAG
        sp.ctx_affine_type = CTX.CU_AFFINE_TYPE_FLAG
        sp.ctx_amvr_flag = CTX.AMVR_FLAG
        sp.ctx_amvr_precision = CTX.AMVR_PRECISION_IDX
        sp.ctx_bcw = CTX.BCW_IDX
        self.sp = sp

        st = _SliceState()
        st.qp_y = coder.qp_y
        st.is_first_qg = 1
        for i in range(3):
            st.stat_coeff[i] = coder.stat_coeff[i]
        st.infer_tu_cbf_luma = 1
        self.st = st

        ctb = sps.ctb_size_y
        cu_cap = 2 * (ctb // 4) ** 2 + 64
        tu_cap = 4 * cu_cap
        tb_cap = 3 * tu_cap
        coeff_cap = 4 * ctb * ctb
        self._cu = np.zeros((cu_cap, CU_STRIDE), np.int32)
        self._tu = np.zeros((tu_cap, TU_STRIDE), np.int32)
        self._tb = np.zeros((tb_cap, TB_STRIDE), np.int32)
        self._coeff = np.zeros(coeff_cap, np.int32)
        out = _ParseOut()
        out.cu, out.tu = _ptr(self._cu), _ptr(self._tu)
        out.tb, out.coeff = _ptr(self._tb), _ptr(self._coeff)
        out.cu_cap, out.tu_cap = cu_cap, tu_cap
        out.tb_cap, out.coeff_cap = tb_cap, coeff_cap
        self.out = out
        # when the native recon core consumes the records directly, keep a
        # per-CTU copy and skip building Python CU objects entirely
        self.keep_records = False
        self.records = {}   # rs -> (n_cu, ptrs..., arrays) per CTU
        self.flat = None    # per-job flat record arrays (parse_entrypoint)
        self.flat_ctus = None
        self._sp_ref = ctypes.byref(self.sp)
        self._st_ref = ctypes.byref(self.st)
        self._out_ref = ctypes.byref(self.out)
        self._synced_stat = None
        self._synced_engine = None
        self._cabac_ref = None

    def release_records(self):
        """Recycle record arenas into the pool (call once the frame's MC +
        recon walks have consumed them — decoder end-of-frame)."""
        seen = set()
        for v in self.records.values():
            a = v[5]
            if isinstance(a, _Arena) and id(a) not in seen:
                seen.add(id(a))
                _release_arena(a)
        self.records.clear()
        self.flat = None        # raw arena pointers die with the records
        self.flat_ctus = None

    def __call__(self, coder, ctu_idx, rs, rx, ry):
        """Parse one CTU's coding tree; appends CUs to coder.cur_cus.

        qp_y / is_first_qg live in the C SliceState for the whole slice (no
        Python consumer between CTUs); stat_coeff is re-pushed only when
        init_stat_coeff rebinds it (tile/WPP entry reinit)."""
        st, out = self.st, self.out
        sc = coder.stat_coeff
        if sc is not self._synced_stat:
            for i in range(3):
                st.stat_coeff[i] = sc[i]
            self._synced_stat = sc
        e = coder.e
        if e is not self._synced_engine:
            self._cabac_ref = ctypes.byref(e.c)
            self._synced_engine = e
        rc = self.lib.parse_ctu(self._cabac_ref, self._sp_ref, self._st_ref,
                                self._out_ref, ctu_idx, rs, rx, ry)
        if rc:
            raise ValueError(f"native parse_ctu failed (err={rc})")
        if self.keep_records:
            cu = self._cu[:out.n_cu].copy()
            tu = self._tu[:out.n_tu].copy()
            tb = self._tb[:out.n_tb].copy()
            coeff = self._coeff[:out.coeff_len].copy()
            # pointers cached once; consumed by native/recon.py per CTU
            self.records[rs] = (
                len(cu), ctypes.c_void_p(cu.ctypes.data),
                ctypes.c_void_p(tu.ctypes.data),
                ctypes.c_void_p(tb.ctypes.data),
                ctypes.c_void_p(coeff.ctypes.data if len(coeff) else
                                tu.ctypes.data),
                (cu, tu, tb, coeff))
        else:
            self._convert(coder, out)

    def _convert(self, coder, out):
        from ..ctu import (CodingUnit, TransformUnit, PredictionUnit,
                           MODE_INTRA, MODE_PLT, DUAL_TREE_CHROMA)
        from ..residual import TransformBlock

        cus = self._cu[:out.n_cu].tolist()
        tus = self._tu[:out.n_tu].tolist()
        tbs = self._tb[:out.n_tb].tolist()
        coeff = self._coeff
        append = coder.cur_cus.append
        for c in cus:
            cu = CodingUnit(c[0], c[1], c[2], c[3], c[4], c[5])
            cu.pred_mode = c[6]
            cu.skip_flag = c[7]
            cu.coded_flag = c[8]
            cu.intra_pred_mode_y = c[9]
            cu.intra_pred_mode_c = c[10]
            cu.intra_luma_ref_idx = c[11]
            cu.intra_mip_flag = c[12]
            cu.mip_transposed = c[13]
            cu.mip_mode = c[14]
            cu.isp_split_type = c[15]
            cu.num_intra_subpartitions = c[16]
            cu.bdpcm_flag = [c[17], c[18], c[19]]
            cu.mip_chroma_direct_flag = c[20]
            cu.lfnst_idx = c[21]
            cu.mts_idx = c[22]
            cu.qp = [c[23], c[24], c[25], c[26]]
            cu.apply_lfnst_flag = [c[29], c[30], c[31]]
            if cu.pred_mode not in (MODE_INTRA, MODE_PLT) and \
                    c[5] != DUAL_TREE_CHROMA:
                self._convert_pu(coder, cu, c)
            for t in tus[c[27]:c[27] + c[28]]:
                tu = TransformUnit(t[0], t[1], t[2], t[3])
                tu.coded_flag = [t[4], t[5], t[6]]
                tu.joint_cbcr_residual_flag = t[7]
                cu.tus.append(tu)
                for b in tbs[t[8]:t[8] + t[9]]:
                    tb = TransformBlock(b[0], b[1], b[2], b[3], b[4])
                    tb.ts = b[5]
                    tb.has_coeffs = b[6]
                    tb.max_scan_x = b[7]
                    tb.max_scan_y = b[8]
                    if b[9] >= 0:
                        tb.coeffs = coeff[b[9]:b[9] + b[2] * b[3]] \
                            .reshape(b[3], b[2]).copy()
                    tu.tbs.append(tb)
            append(cu)

    def _convert_pu(self, coder, cu, c):
        """Rebuild the PredictionUnit of an inter CU from record fields
        (+ the cp_mv plane for affine PROF diff-MVs)."""
        from ..ctu import PredictionUnit
        from ..mvs import MvField, MotionContext, PF_L0

        pu = PredictionUnit()
        cu.pu = pu
        flags = c[40]
        pu.merge_gpm_flag = flags & 1
        pu.inter_affine_flag = (flags >> 1) & 1
        cu.ciip_flag = (flags >> 2) & 1
        pu.dmvr_flag = (flags >> 3) & 1
        pu.bdof_flag = (flags >> 4) & 1
        pu.general_merge_flag = (flags >> 7) & 1
        pu.merge_subblock_flag = (flags >> 8) & 1
        mi = pu.mi
        mi.pred_flag = c[32]
        mi.ref_idx = [c[33], c[34]]
        mi.bcw_idx = c[35]
        mi.hpel_if_idx = c[36]
        mi.motion_model_idc = c[37]
        mi.num_sb_x, mi.num_sb_y = c[38], c[39]
        sbt = c[50]
        cu.sbt_flag = sbt & 1
        cu.sbt_horizontal_flag = (sbt >> 1) & 1
        cu.sbt_pos_flag = (sbt >> 2) & 1
        if pu.merge_gpm_flag:
            pu.gpm_partition_idx = c[41]
            pu.gpm_mv = []
            for i in range(2):
                f = MvField()
                lx = c[42 + i * 4]
                f.pred_flag = PF_L0 + lx
                f.ref_idx[lx] = c[43 + i * 4]
                f.mv[lx] = [c[44 + i * 4], c[45 + i * 4]]
                pu.gpm_mv.append(f)
        if pu.inter_affine_flag and (flags & (32 | 64)):
            # PROF diff-MVs: recompute from the stored CP MVs (cp_mv plane)
            t = coder.tabs
            xi, yi = cu.x0 >> 2, cu.y0 >> 2
            for lx in range(2):
                if mi.pred_flag & (lx + 1):
                    for j in range(mi.motion_model_idc + 1):
                        mi.mv[lx][j] = [int(t.cp_mv[lx, yi, xi, j, 0]),
                                        int(t.cp_mv[lx, yi, xi, j, 1])]
            mc = MotionContext(coder)
            for lx in range(2):
                if mi.pred_flag & (lx + 1):
                    sp = mc._init_subblock_params(mi, cu.cb_width,
                                                  cu.cb_height, lx)
                    mc._derive_subblock_diff_mvs(pu, sp, lx)


def make_native_tree(coder, config=None):
    """Return a NativeTreeParser for this slice, or None if ineligible."""
    from ..cabac.native import NativeCabacDecoder
    from ..bitstream.h266 import SLICE_I

    if not isinstance(coder.e, NativeCabacDecoder):
        return None
    r = coder.sps.r
    if r.sps_ibc_enabled_flag or r.sps_act_enabled_flag or \
            r.sps_palette_enabled_flag:
        return None
    if coder.sh.slice_type != SLICE_I:
        # C rpl arrays are fixed at 16 entries per list
        rpl = coder.rpl
        if rpl is None or any(l.nb_refs > 16 for l in rpl):
            return None
        # collocated ref must expose the dense col grids (decode-side
        # DecodedFrame; the forge's encode-side shim does not)
        col = coder.collocated_ref
        if col is not None and not hasattr(col, "tabs"):
            return None
    lib = load_lib()
    if lib is None:
        return None
    return NativeTreeParser(coder, lib)


class _CtuDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in
                ("ctu_idx", "rs", "rx", "ry", "reinit", "realign",
                 "wpp_inherit", "wpp_save", "term", "slice_idx")]


class _Arena:
    """Record arena shared by many CTUs (consumed zero-copy by the native
    recon); chained when a dense slice exhausts it.  Pooled across frames
    (acquire_arena / release below): the ~MB-scale np.empty allocations go
    through mmap and their first-touch page faults otherwise dominate the
    batched parse."""

    def __init__(self, ctb_log2, n_ctus):
        self.ctb_log2 = ctb_log2
        self.n_ctus = n_ctus
        ctb4 = (1 << ctb_log2) >> 2
        cu_need = 2 * ctb4 * ctb4 + 64
        # np.empty is safe: every record/coeff block is fully written by
        # the C side before Python or the C recon reads it
        self.cu = np.empty((cu_need + 128 * n_ctus, CU_STRIDE), np.int32)
        self.tu = np.empty((4 * cu_need + 512 * n_ctus, TU_STRIDE), np.int32)
        self.tb = np.empty((12 * cu_need + 1536 * n_ctus, TB_STRIDE),
                           np.int32)
        self.coeff = np.empty((4 << (2 * ctb_log2)) + 2048 * n_ctus,
                              np.int32)
        out = _ParseOut()
        out.cu, out.tu = _ptr(self.cu), _ptr(self.tu)
        out.tb, out.coeff = _ptr(self.tb), _ptr(self.coeff)
        out.cu_cap, out.tu_cap = len(self.cu), len(self.tu)
        out.tb_cap, out.coeff_cap = len(self.tb), len(self.coeff)
        self.out = out
        self.cu_base = self.cu.ctypes.data
        self.tu_ptr = ctypes.c_void_p(self.tu.ctypes.data)
        self.tb_ptr = ctypes.c_void_p(self.tb.ctypes.data)
        self.coeff_ptr = ctypes.c_void_p(self.coeff.ctypes.data)

    def reset(self):
        o = self.out
        o.n_cu = o.n_tu = o.n_tb = o.coeff_len = o.err = 0


_ARENA_POOL = []        # per-process free list (decode_parallel forks)
_ARENA_POOL_MAX = 48
# the frame pipeline acquires (parse of frame N+1) and releases (pixel
# stages of frame N, worker thread) concurrently — decoder.py
_ARENA_LOCK = __import__("threading").Lock()


def acquire_arena(ctb_log2, n_ctus):
    with _ARENA_LOCK:
        for i, a in enumerate(_ARENA_POOL):
            if a.ctb_log2 == ctb_log2 and a.n_ctus >= n_ctus:
                a = _ARENA_POOL.pop(i)
                a.reset()
                return a
    return _Arena(ctb_log2, max(n_ctus, 16))


def _release_arena(a):
    with _ARENA_LOCK:
        if len(_ARENA_POOL) < _ARENA_POOL_MAX:
            _ARENA_POOL.append(a)


def parse_entrypoint(tree, coder, items, state_tmpl, wpp_buf,
                     job_ctus=None):
    """Batched whole-entry-point parse (native/vvc_parse.c parse_ctus).

    items: [(ctu_idx, rs, rx, ry, reinit, realign, wpp_save, term,
    slice_idx)].  Fills tree.records with zero-copy views into per-call
    arenas.  With job_ctus (the recon-job [(rs, rx, ry)] list, same order
    as items) the per-job flat record arrays for the batched C walks are
    emitted vectorized here (NativeRecon._batch_arrays shortcut).
    Returns nothing; raises on parse error."""
    from ..cabac.engine import CTX
    lib = tree.lib
    st = tree.st
    sc = coder.stat_coeff
    for i in range(3):
        st.stat_coeff[i] = sc[i]
    n = len(items)
    descs = (_CtuDesc * n)()
    for i, (ctu_idx, rs, rx, ry, reinit, realign, wpp_save, term,
            sidx, wpp_inherit) in enumerate(items):
        d = descs[i]
        d.ctu_idx, d.rs, d.rx, d.ry = ctu_idx, rs, rx, ry
        d.reinit, d.realign = reinit, realign
        d.wpp_inherit = wpp_inherit
        d.wpp_save, d.term, d.slice_idx = wpp_save, term, sidx
    num_ctx = CTX.NUM
    tmpl_ptr = ctypes.c_void_p(state_tmpl.ctypes.data) \
        if state_tmpl is not None else None
    wpp_ptr = ctypes.c_void_p(wpp_buf.ctypes.data)
    done = 0
    parts = []          # (idx[:k] copy, arena) per arena chunk, in order
    while done < n:
        arena = acquire_arena(coder.sps.ctb_log2_size_y, n - done)
        idx = np.empty((n - done, 8), np.int32)
        k = lib.parse_ctus(
            ctypes.byref(coder.e.c), tree._sp_ref, ctypes.byref(st),
            ctypes.byref(arena.out),
            ctypes.byref(descs, done * ctypes.sizeof(_CtuDesc)),
            n - done, ctypes.c_void_p(idx.ctypes.data), tmpl_ptr, wpp_ptr,
            num_ctx)
        if k < 0:
            raise ValueError(
                f"native parse_ctus failed (err={arena.out.err})")
        if k == 0:
            raise ValueError("native parse_ctus: arena too small for a CTU")
        for row in idx[:k]:
            rs, cu_start, n_cu = int(row[0]), int(row[1]), int(row[2])
            tree.records[rs] = (
                n_cu,
                ctypes.c_void_p(arena.cu_base +
                                cu_start * CU_STRIDE * 4),
                arena.tu_ptr, arena.tb_ptr, arena.coeff_ptr, arena)
        parts.append((idx[:k].copy(), arena))
        done += k
    coder.stat_coeff = [st.stat_coeff[i] for i in range(3)]
    if job_ctus is not None:
        it = np.asarray(items, np.int32)

        def pv(p):
            return p.value if hasattr(p, "value") else p

        n_cus = np.concatenate([p[:, 2] for p, _ in parts])
        cu_ps = np.concatenate(
            [a.cu_base + p[:, 1].astype(np.int64) * (CU_STRIDE * 4)
             for p, a in parts])
        tu_ps = np.concatenate(
            [np.full(len(p), pv(a.tu_ptr), np.int64) for p, a in parts])
        tb_ps = np.concatenate(
            [np.full(len(p), pv(a.tb_ptr), np.int64) for p, a in parts])
        co_ps = np.concatenate(
            [np.full(len(p), pv(a.coeff_ptr), np.int64)
             for p, a in parts])
        tree.flat = (np.ascontiguousarray(it[:, 2]),          # rx
                     np.ascontiguousarray(it[:, 3]),          # ry
                     np.ascontiguousarray(it[:, 1]),          # rs
                     np.ascontiguousarray(n_cus), cu_ps, tu_ps, tb_ps,
                     co_ps)
        tree.flat_ctus = job_ctus
