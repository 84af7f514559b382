# Frozen copy of ffvvc_tpu_torch/bitstream/h266.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none.
"""H.266/VVC header syntax readers.

Reads VPS/SPS/PPS/APS/PH/SH/AUD/OPI/DCI/SEI raw syntax structures from RBSP
payloads, following the normative syntax of ITU-T H.266 clause 7.3 field by
field.  Reference analogue: libavcodec/cbs_h266_syntax_template.c
(sps at :1054, pps at :1645, aps at :2456, picture_header at :2593,
slice_header at :3011); the field ORDER is dictated by the spec, the
implementation here is original.

All syntax objects are `SyntaxObj` attribute bags using the spec field names;
unset fields read as 0 (mirroring the spec's "inferred to be equal to 0"
default).  Non-zero inferences are set explicitly.
"""
from __future__ import annotations

import math

from .reader import BitReader, BitReaderError
from .nal import NalType

MAX_DPB_SIZE = 16 + 1
MAX_REF_ENTRIES = 29
MAX_REF_PIC_LISTS = 64
MAX_SLICES = 600
MAX_TILE_COLUMNS = 30
MAX_TILE_ROWS = 33
MAX_ENTRY_POINTS = 512
NUM_ALF_FILTERS = 25

APS_ALF = 0
APS_LMCS = 1
APS_SCALING = 2

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


def ceil_log2(x: int) -> int:
    return 0 if x <= 1 else (x - 1).bit_length()


class SyntaxObj:
    """Attribute bag; unset attributes read as 0 (spec default inference)."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return 0

    def __repr__(self):
        keys = sorted(self.__dict__)
        return "SyntaxObj(" + ", ".join(f"{k}={self.__dict__[k]!r}" for k in keys) + ")"


class H266SyntaxError(Exception):
    pass


# ---------------------------------------------------------------------------
# profile / tier / level
# ---------------------------------------------------------------------------

def _read_gci_full(r: BitReader) -> SyntaxObj:
    """general_constraints_info(): H.266 7.3.3.2. All fields are consumed in
    normative order; only the format-constraint idcs are retained."""
    gci = SyntaxObj()
    gci.gci_present_flag = r.flag()
    if gci.gci_present_flag:
        gci.gci_intra_only_constraint_flag = r.flag()
        gci.gci_all_layers_independent_constraint_flag = r.flag()
        gci.gci_one_au_only_constraint_flag = r.flag()
        gci.gci_sixteen_minus_max_bitdepth_constraint_idc = r.u(4)
        gci.gci_three_minus_max_chroma_format_constraint_idc = r.u(2)
        for _ in range(10):   # NAL unit type related flags
            r.u(1)
        for _ in range(6):    # tile/slice/subpic partitioning flags
            r.u(1)
        r.u(2)                # gci_three_minus_max_log2_ctu_size_constraint_idc
        for _ in range(3):    # partition constraint flags
            r.u(1)
        for _ in range(6):    # intra-tool flags
            r.u(1)
        for _ in range(16):   # inter-tool flags
            r.u(1)
        for _ in range(13):   # transform/quant/residual flags
            r.u(1)
        for _ in range(6):    # loop-filter flags
            r.u(1)
        num_additional = r.u(8)
        used = 0
        if num_additional > 5:
            for _ in range(6):
                r.u(1)
            used = 6
        for _ in range(num_additional - used):
            r.u(1)
    while not r.byte_aligned():
        if r.u(1) != 0:
            raise H266SyntaxError("gci_alignment_zero_bit != 0")
    return gci


def read_profile_tier_level(r: BitReader, profile_tier_present: bool,
                            max_num_sub_layers_minus1: int) -> SyntaxObj:
    ptl = SyntaxObj()
    if profile_tier_present:
        ptl.general_profile_idc = r.u(7)
        ptl.general_tier_flag = r.u(1)
    ptl.general_level_idc = r.u(8)
    ptl.ptl_frame_only_constraint_flag = r.flag()
    ptl.ptl_multilayer_enabled_flag = r.flag()
    if profile_tier_present:
        ptl.general_constraints_info = _read_gci_full(r)
    ptl.ptl_sublayer_level_present_flag = [0] * max(0, max_num_sub_layers_minus1)
    for i in range(max_num_sub_layers_minus1 - 1, -1, -1):
        ptl.ptl_sublayer_level_present_flag[i] = r.u(1)
    while not r.byte_aligned():
        r.u(1)  # ptl_reserved_zero_bit
    ptl.sublayer_level_idc = [0] * max(0, max_num_sub_layers_minus1)
    for i in range(max_num_sub_layers_minus1 - 1, -1, -1):
        if ptl.ptl_sublayer_level_present_flag[i]:
            ptl.sublayer_level_idc[i] = r.u(8)
    if profile_tier_present:
        ptl.ptl_num_sub_profiles = r.u(8)
        ptl.general_sub_profile_idc = [r.u(32) for _ in range(ptl.ptl_num_sub_profiles)]
    return ptl


# ---------------------------------------------------------------------------
# DPB / RPL
# ---------------------------------------------------------------------------

def read_dpb_parameters(r: BitReader, max_sublayers_minus1: int,
                        sublayer_info_flag: bool) -> SyntaxObj:
    dpb = SyntaxObj()
    n = max_sublayers_minus1 + 1
    dpb.dpb_max_dec_pic_buffering_minus1 = [0] * n
    dpb.dpb_max_num_reorder_pics = [0] * n
    dpb.dpb_max_latency_increase_plus1 = [0] * n
    start = 0 if sublayer_info_flag else max_sublayers_minus1
    for i in range(start, n):
        dpb.dpb_max_dec_pic_buffering_minus1[i] = r.ue()
        dpb.dpb_max_num_reorder_pics[i] = r.ue()
        dpb.dpb_max_latency_increase_plus1[i] = r.ue()
    return dpb


def read_ref_pic_list_struct(r: BitReader, sps: SyntaxObj, list_idx: int,
                             rpls_idx: int, num_direct_ref_layers: int = 0) -> SyntaxObj:
    """H.266 7.3.10 ref_pic_list_struct(listIdx, rplsIdx).

    Reference: cbs_h266_syntax_template.c:410-489.
    """
    rpl = SyntaxObj()
    rpl.num_ref_entries = r.ue()
    if rpl.num_ref_entries > MAX_REF_ENTRIES:
        raise H266SyntaxError("num_ref_entries too large")
    rpl.ltrp_in_header_flag = 0
    if sps.sps_long_term_ref_pics_flag and \
            rpls_idx < sps.sps_num_ref_pic_lists[list_idx] and rpl.num_ref_entries > 0:
        rpl.ltrp_in_header_flag = r.u(1)
    if sps.sps_long_term_ref_pics_flag and rpls_idx == sps.sps_num_ref_pic_lists[list_idx]:
        rpl.ltrp_in_header_flag = 1
    n = rpl.num_ref_entries
    rpl.inter_layer_ref_pic_flag = [0] * n
    rpl.st_ref_pic_flag = [1] * n
    rpl.abs_delta_poc_st = [0] * n
    rpl.strp_entry_sign_flag = [0] * n
    rpl.rpls_poc_lsb_lt = [0] * n
    rpl.ilrp_idx = [0] * n
    j = 0
    for i in range(n):
        if sps.sps_inter_layer_prediction_enabled_flag:
            rpl.inter_layer_ref_pic_flag[i] = r.u(1)
        if not rpl.inter_layer_ref_pic_flag[i]:
            if sps.sps_long_term_ref_pics_flag:
                rpl.st_ref_pic_flag[i] = r.u(1)
            if rpl.st_ref_pic_flag[i]:
                rpl.abs_delta_poc_st[i] = r.ue()
                if (sps.sps_weighted_pred_flag or sps.sps_weighted_bipred_flag) and i != 0:
                    abs_delta = rpl.abs_delta_poc_st[i]
                else:
                    abs_delta = rpl.abs_delta_poc_st[i] + 1
                if abs_delta > 0:
                    rpl.strp_entry_sign_flag[i] = r.u(1)
            else:
                if not rpl.ltrp_in_header_flag:
                    bits = sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4
                    rpl.rpls_poc_lsb_lt[j] = r.u(bits)
                    j += 1
        else:
            if num_direct_ref_layers == 0:
                raise H266SyntaxError("inter-layer ref without direct ref layers")
            rpl.ilrp_idx[i] = r.ue()
    return rpl


def num_ltrp_entries(rpl: SyntaxObj) -> int:
    return sum(1 for k in range(rpl.num_ref_entries)
               if not rpl.inter_layer_ref_pic_flag[k] and not rpl.st_ref_pic_flag[k])


def read_ref_pic_lists(r: BitReader, sps: SyntaxObj, pps: SyntaxObj) -> SyntaxObj:
    """H.266 7.3.9 ref_pic_lists(). Reference: cbs template :491-556."""
    rpls = SyntaxObj()
    rpls.rpl_sps_flag = [0, 0]
    rpls.rpl_idx = [0, 0]
    rpls.rpl_ref_list = [None, None]
    rpls.poc_lsb_lt = [[], []]
    rpls.delta_poc_msb_cycle_present_flag = [[], []]
    rpls.delta_poc_msb_cycle_lt = [[], []]
    for i in range(2):
        if sps.sps_num_ref_pic_lists[i] > 0 and \
                (i == 0 or (i == 1 and pps.pps_rpl1_idx_present_flag)):
            rpls.rpl_sps_flag[i] = r.u(1)
        else:
            if sps.sps_num_ref_pic_lists[i] == 0:
                rpls.rpl_sps_flag[i] = 0
            elif i == 1 and not pps.pps_rpl1_idx_present_flag:
                rpls.rpl_sps_flag[1] = rpls.rpl_sps_flag[0]
        if rpls.rpl_sps_flag[i]:
            if sps.sps_num_ref_pic_lists[i] > 1 and \
                    (i == 0 or (i == 1 and pps.pps_rpl1_idx_present_flag)):
                bits = ceil_log2(sps.sps_num_ref_pic_lists[i])
                rpls.rpl_idx[i] = r.u(bits)
            elif sps.sps_num_ref_pic_lists[i] == 1:
                rpls.rpl_idx[i] = 0
            elif i == 1 and not pps.pps_rpl1_idx_present_flag:
                rpls.rpl_idx[1] = rpls.rpl_idx[0]
            else:
                raise H266SyntaxError("cannot infer rpl_idx")
            rpls.rpl_ref_list[i] = sps.sps_ref_pic_list_struct[i][rpls.rpl_idx[i]]
        else:
            rpls.rpl_ref_list[i] = read_ref_pic_list_struct(
                r, sps, i, sps.sps_num_ref_pic_lists[i])
        ref_list = rpls.rpl_ref_list[i]
        n_lt = num_ltrp_entries(ref_list)
        rpls.poc_lsb_lt[i] = [0] * n_lt
        rpls.delta_poc_msb_cycle_present_flag[i] = [0] * n_lt
        rpls.delta_poc_msb_cycle_lt[i] = [0] * n_lt
        for j in range(n_lt):
            if ref_list.ltrp_in_header_flag:
                rpls.poc_lsb_lt[i][j] = r.u(sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4)
            rpls.delta_poc_msb_cycle_present_flag[i][j] = r.u(1)
            if rpls.delta_poc_msb_cycle_present_flag[i][j]:
                rpls.delta_poc_msb_cycle_lt[i][j] = r.ue()
    return rpls


# ---------------------------------------------------------------------------
# timing / HRD / VUI
# ---------------------------------------------------------------------------

def read_general_timing_hrd(r: BitReader) -> SyntaxObj:
    g = SyntaxObj()
    g.num_units_in_tick = r.u(32)
    g.time_scale = r.u(32)
    g.general_nal_hrd_params_present_flag = r.flag()
    g.general_vcl_hrd_params_present_flag = r.flag()
    if g.general_nal_hrd_params_present_flag or g.general_vcl_hrd_params_present_flag:
        g.general_same_pic_timing_in_all_ols_flag = r.flag()
        g.general_du_hrd_params_present_flag = r.flag()
        if g.general_du_hrd_params_present_flag:
            g.tick_divisor_minus2 = r.u(8)
        g.bit_rate_scale = r.u(4)
        g.cpb_size_scale = r.u(4)
        if g.general_du_hrd_params_present_flag:
            g.cpb_size_du_scale = r.u(4)
        g.hrd_cpb_cnt_minus1 = r.ue()
    return g


def _read_sublayer_hrd(r: BitReader, general: SyntaxObj):
    for _ in range(general.hrd_cpb_cnt_minus1 + 1):
        r.ue()  # bit_rate_value_minus1
        r.ue()  # cpb_size_value_minus1
        if general.general_du_hrd_params_present_flag:
            r.ue()  # cpb_size_du_value_minus1
            r.ue()  # bit_rate_du_value_minus1
        r.u(1)  # cbr_flag


def read_ols_timing_hrd(r: BitReader, first_sublayer: int,
                        max_sublayers_minus1: int, general: SyntaxObj):
    for _i in range(first_sublayer, max_sublayers_minus1 + 1):
        fixed_general = r.flag()
        fixed_within_cvs = True if fixed_general else r.flag()
        if fixed_within_cvs:
            r.ue()  # elemental_duration_in_tc_minus1
        elif (general.general_nal_hrd_params_present_flag or
              general.general_vcl_hrd_params_present_flag) and \
                general.hrd_cpb_cnt_minus1 == 0:
            r.flag()  # low_delay_hrd_flag
        if general.general_nal_hrd_params_present_flag:
            _read_sublayer_hrd(r, general)
        if general.general_vcl_hrd_params_present_flag:
            _read_sublayer_hrd(r, general)


def read_vui_parameters(r: BitReader, chroma_format_idc: int) -> SyntaxObj:
    vui = SyntaxObj()
    vui.vui_progressive_source_flag = r.flag()
    vui.vui_interlaced_source_flag = r.flag()
    vui.vui_non_packed_constraint_flag = r.flag()
    vui.vui_non_projected_constraint_flag = r.flag()
    vui.vui_aspect_ratio_info_present_flag = r.flag()
    if vui.vui_aspect_ratio_info_present_flag:
        vui.vui_aspect_ratio_constant_flag = r.flag()
        vui.vui_aspect_ratio_idc = r.u(8)
        if vui.vui_aspect_ratio_idc == 255:
            vui.vui_sar_width = r.u(16)
            vui.vui_sar_height = r.u(16)
    vui.vui_overscan_info_present_flag = r.flag()
    if vui.vui_overscan_info_present_flag:
        vui.vui_overscan_appropriate_flag = r.flag()
    vui.vui_colour_description_present_flag = r.flag()
    if vui.vui_colour_description_present_flag:
        vui.vui_colour_primaries = r.u(8)
        vui.vui_transfer_characteristics = r.u(8)
        vui.vui_matrix_coeffs = r.u(8)
        vui.vui_full_range_flag = r.flag()
    else:
        vui.vui_colour_primaries = 2
        vui.vui_transfer_characteristics = 2
        vui.vui_matrix_coeffs = 2
    vui.vui_chroma_loc_info_present_flag = r.flag()
    if vui.vui_chroma_loc_info_present_flag:
        if vui.vui_progressive_source_flag and not vui.vui_interlaced_source_flag:
            vui.vui_chroma_sample_loc_type_frame = r.ue()
        else:
            vui.vui_chroma_sample_loc_type_top_field = r.ue()
            vui.vui_chroma_sample_loc_type_bottom_field = r.ue()
    return vui


# ---------------------------------------------------------------------------
# VPS
# ---------------------------------------------------------------------------

def make_default_vps(layer_id: int = 0) -> SyntaxObj:
    """Inferred VPS when sps_video_parameter_set_id == 0 (H.266 7.4.3.4)."""
    vps = SyntaxObj()
    vps.vps_video_parameter_set_id = 0
    vps.vps_max_layers_minus1 = 0
    vps.vps_max_sublayers_minus1 = 6
    vps.vps_independent_layer_flag = [1]
    vps.vps_layer_id = [layer_id]
    vps.vps_direct_ref_layer_flag = [[0] * 64]
    return vps


def read_vps(r: BitReader) -> SyntaxObj:
    """H.266 7.3.2.3; reference cbs template :694-1035.

    OLS bookkeeping is carried out only to the extent needed to consume the
    bitstream correctly (num_multi_layer_olss / total_num_olss).
    """
    vps = SyntaxObj()
    vps.vps_video_parameter_set_id = r.u(4)
    vps.vps_max_layers_minus1 = r.u(6)
    vps.vps_max_sublayers_minus1 = r.u(3)
    ml = vps.vps_max_layers_minus1
    if ml > 0 and vps.vps_max_sublayers_minus1 > 0:
        vps.vps_default_ptl_dpb_hrd_max_tid_flag = r.u(1)
    else:
        vps.vps_default_ptl_dpb_hrd_max_tid_flag = 1
    if ml > 0:
        vps.vps_all_independent_layers_flag = r.u(1)
    else:
        vps.vps_all_independent_layers_flag = 1
    L = ml + 1
    vps.vps_layer_id = [0] * L
    vps.vps_independent_layer_flag = [1] * L
    vps.vps_max_tid_ref_present_flag = [0] * L
    vps.vps_direct_ref_layer_flag = [[0] * L for _ in range(L)]
    vps.vps_max_tid_il_ref_pics_plus1 = [
        [vps.vps_max_sublayers_minus1 + 1] * L for _ in range(L)]
    for i in range(L):
        vps.vps_layer_id[i] = r.u(6)
        if i > 0 and not vps.vps_all_independent_layers_flag:
            vps.vps_independent_layer_flag[i] = r.u(1)
            if not vps.vps_independent_layer_flag[i]:
                vps.vps_max_tid_ref_present_flag[i] = r.u(1)
                for j in range(i):
                    vps.vps_direct_ref_layer_flag[i][j] = r.u(1)
                    if vps.vps_max_tid_ref_present_flag[i] and \
                            vps.vps_direct_ref_layer_flag[i][j]:
                        vps.vps_max_tid_il_ref_pics_plus1[i][j] = r.u(3)
    total_num_olss = 0
    ols_mode_idc = 4
    if ml > 0:
        if vps.vps_all_independent_layers_flag:
            vps.vps_each_layer_is_an_ols_flag = r.u(1)
        else:
            vps.vps_each_layer_is_an_ols_flag = 0
        if not vps.vps_each_layer_is_an_ols_flag:
            if not vps.vps_all_independent_layers_flag:
                vps.vps_ols_mode_idc = r.u(2)
            else:
                vps.vps_ols_mode_idc = 2
            if vps.vps_ols_mode_idc == 2:
                vps.vps_num_output_layer_sets_minus2 = r.u(8)
                vps.vps_ols_output_layer_flag = [
                    [0] * L for _ in range(vps.vps_num_output_layer_sets_minus2 + 2)]
                for i in range(1, vps.vps_num_output_layer_sets_minus2 + 2):
                    for j in range(L):
                        vps.vps_ols_output_layer_flag[i][j] = r.u(1)
            ols_mode_idc = vps.vps_ols_mode_idc
        else:
            ols_mode_idc = 4
        if ols_mode_idc in (0, 1, 4):
            total_num_olss = L
        elif ols_mode_idc == 2:
            total_num_olss = vps.vps_num_output_layer_sets_minus2 + 2
        else:
            raise H266SyntaxError("ols_mode_idc == 3 not supported")
        vps.vps_num_ptls_minus1 = r.u(8)
    else:
        vps.vps_each_layer_is_an_ols_flag = 1
        vps.vps_num_ptls_minus1 = 0
        total_num_olss = 1

    # num_multi_layer_olss (needed for the DPB/HRD loops below)
    num_multi_layer_olss = 0
    # dependency closure
    dep = [[vps.vps_direct_ref_layer_flag[i][j] for j in range(L)] for i in range(L)]
    for i in range(L):
        for j in range(L):
            for k in range(i):
                if vps.vps_direct_ref_layer_flag[i][k] and dep[k][j]:
                    dep[i][j] = 1
    ref_layer_idx = [[j for j in range(L) if dep[i][j]] for i in range(L)]
    layer_included = [[0] * L for _ in range(max(total_num_olss, 1))]
    for i in range(1, total_num_olss):
        if vps.vps_each_layer_is_an_ols_flag:
            n_layers = 1
        elif ols_mode_idc in (0, 1):
            n_layers = i + 1
        elif ols_mode_idc == 2:
            out_idx = [k for k in range(L) if vps.vps_ols_output_layer_flag[i][k]]
            for k in out_idx:
                layer_included[i][k] = 1
            for k in out_idx:
                for rl in ref_layer_idx[k]:
                    layer_included[i][rl] = 1
            n_layers = sum(layer_included[i])
        else:
            n_layers = 1
        if n_layers > 1:
            num_multi_layer_olss += 1

    vps.vps_pt_present_flag = [0] * (vps.vps_num_ptls_minus1 + 1)
    vps.vps_ptl_max_tid = [vps.vps_max_sublayers_minus1] * (vps.vps_num_ptls_minus1 + 1)
    for i in range(vps.vps_num_ptls_minus1 + 1):
        if i > 0:
            vps.vps_pt_present_flag[i] = r.u(1)
        else:
            vps.vps_pt_present_flag[i] = 1
        if not vps.vps_default_ptl_dpb_hrd_max_tid_flag:
            vps.vps_ptl_max_tid[i] = r.u(3)
    while not r.byte_aligned():
        r.u(1)
    vps.vps_profile_tier_level = []
    for i in range(vps.vps_num_ptls_minus1 + 1):
        vps.vps_profile_tier_level.append(
            read_profile_tier_level(r, bool(vps.vps_pt_present_flag[i]),
                                    vps.vps_ptl_max_tid[i]))
    vps.vps_ols_ptl_idx = [0] * total_num_olss
    for i in range(total_num_olss):
        if vps.vps_num_ptls_minus1 > 0 and vps.vps_num_ptls_minus1 + 1 != total_num_olss:
            vps.vps_ols_ptl_idx[i] = r.u(8)
        elif vps.vps_num_ptls_minus1 == 0:
            vps.vps_ols_ptl_idx[i] = 0
        else:
            vps.vps_ols_ptl_idx[i] = i

    if not vps.vps_each_layer_is_an_ols_flag:
        vps.vps_num_dpb_params_minus1 = r.ue()
        n_dpb = vps.vps_num_dpb_params_minus1 + 1
        if vps.vps_max_sublayers_minus1 > 0:
            vps.vps_sublayer_dpb_params_present_flag = r.u(1)
        vps.vps_dpb_max_tid = [vps.vps_max_sublayers_minus1] * n_dpb
        vps.vps_dpb_params = []
        for i in range(n_dpb):
            if not vps.vps_default_ptl_dpb_hrd_max_tid_flag:
                vps.vps_dpb_max_tid[i] = r.u(3)
            vps.vps_dpb_params.append(
                read_dpb_parameters(r, vps.vps_dpb_max_tid[i],
                                    bool(vps.vps_sublayer_dpb_params_present_flag)))
        for _i in range(num_multi_layer_olss):
            r.ue()  # vps_ols_dpb_pic_width
            r.ue()  # vps_ols_dpb_pic_height
            r.u(2)  # vps_ols_dpb_chroma_format
            r.ue()  # vps_ols_dpb_bitdepth_minus8
            if n_dpb > 1 and n_dpb != num_multi_layer_olss:
                r.ue()  # vps_ols_dpb_params_idx
        vps.vps_timing_hrd_params_present_flag = r.flag()
        if vps.vps_timing_hrd_params_present_flag:
            general = read_general_timing_hrd(r)
            if vps.vps_max_sublayers_minus1 > 0:
                vps.vps_sublayer_cpb_params_present_flag = r.u(1)
            n_hrd = r.ue() + 1
            for _i in range(n_hrd):
                max_tid = vps.vps_max_sublayers_minus1
                if not vps.vps_default_ptl_dpb_hrd_max_tid_flag:
                    max_tid = r.u(3)
                first = 0 if vps.vps_sublayer_cpb_params_present_flag else max_tid
                read_ols_timing_hrd(r, first, vps.vps_max_sublayers_minus1, general)
            if n_hrd - 1 > 0 and n_hrd != num_multi_layer_olss:
                for _i in range(num_multi_layer_olss):
                    r.ue()  # vps_ols_timing_hrd_idx
    vps.vps_extension_flag = r.flag()
    # extension data: ignore to end
    return vps


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

SUB_WIDTH_C = (1, 2, 2, 1)
SUB_HEIGHT_C = (1, 2, 1, 1)


def read_sps(r: BitReader, layer_id: int = 0) -> SyntaxObj:
    """H.266 7.3.2.4 seq_parameter_set_rbsp; reference cbs template :1054-1643."""
    sps = SyntaxObj()
    sps.nuh_layer_id = layer_id
    sps.sps_seq_parameter_set_id = r.u(4)
    sps.sps_video_parameter_set_id = r.u(4)
    sps.sps_max_sublayers_minus1 = r.u(3)
    sps.sps_chroma_format_idc = r.u(2)
    sps.sps_log2_ctu_size_minus5 = r.u(2)
    ctb_log2_size_y = sps.sps_log2_ctu_size_minus5 + 5
    ctb_size_y = 1 << ctb_log2_size_y
    sps.sps_ptl_dpb_hrd_params_present_flag = r.flag()
    if sps.sps_ptl_dpb_hrd_params_present_flag:
        sps.profile_tier_level = read_profile_tier_level(
            r, True, sps.sps_max_sublayers_minus1)
    sps.sps_gdr_enabled_flag = r.flag()
    sps.sps_ref_pic_resampling_enabled_flag = r.flag()
    if sps.sps_ref_pic_resampling_enabled_flag:
        sps.sps_res_change_in_clvs_allowed_flag = r.flag()
    sps.sps_pic_width_max_in_luma_samples = r.ue()
    sps.sps_pic_height_max_in_luma_samples = r.ue()
    sps.sps_conformance_window_flag = r.flag()
    if sps.sps_conformance_window_flag:
        sps.sps_conf_win_left_offset = r.ue()
        sps.sps_conf_win_right_offset = r.ue()
        sps.sps_conf_win_top_offset = r.ue()
        sps.sps_conf_win_bottom_offset = r.ue()
    tmp_width_val = -(-sps.sps_pic_width_max_in_luma_samples // ctb_size_y)
    tmp_height_val = -(-sps.sps_pic_height_max_in_luma_samples // ctb_size_y)

    sps.sps_subpic_info_present_flag = r.flag()
    sps.sps_num_subpics_minus1 = 0
    sps.sps_independent_subpics_flag = 1
    sps.sps_subpic_same_size_flag = 0
    sps.sps_subpic_ctu_top_left_x = [0] * MAX_SLICES
    sps.sps_subpic_ctu_top_left_y = [0] * MAX_SLICES
    sps.sps_subpic_width_minus1 = [tmp_width_val - 1] * MAX_SLICES
    sps.sps_subpic_height_minus1 = [tmp_height_val - 1] * MAX_SLICES
    sps.sps_subpic_treated_as_pic_flag = [1] * MAX_SLICES
    sps.sps_loop_filter_across_subpic_enabled_flag = [0] * MAX_SLICES
    sps.sps_subpic_id = list(range(MAX_SLICES))
    if sps.sps_subpic_info_present_flag:
        sps.sps_num_subpics_minus1 = r.ue()
        ns = sps.sps_num_subpics_minus1
        if ns > 0:
            sps.sps_independent_subpics_flag = r.flag()
            sps.sps_subpic_same_size_flag = r.flag()
            wlen = ceil_log2(tmp_width_val)
            hlen = ceil_log2(tmp_height_val)
            # subpic 0
            if sps.sps_pic_width_max_in_luma_samples > ctb_size_y:
                sps.sps_subpic_width_minus1[0] = r.u(wlen)
            else:
                sps.sps_subpic_width_minus1[0] = tmp_width_val - 1
            if sps.sps_pic_height_max_in_luma_samples > ctb_size_y:
                sps.sps_subpic_height_minus1[0] = r.u(hlen)
            else:
                sps.sps_subpic_height_minus1[0] = tmp_height_val - 1
            if not sps.sps_independent_subpics_flag:
                sps.sps_subpic_treated_as_pic_flag[0] = r.u(1)
                sps.sps_loop_filter_across_subpic_enabled_flag[0] = r.u(1)
            else:
                sps.sps_subpic_treated_as_pic_flag[0] = 1
                sps.sps_loop_filter_across_subpic_enabled_flag[0] = 1
            for i in range(1, ns + 1):
                if not sps.sps_subpic_same_size_flag:
                    if sps.sps_pic_width_max_in_luma_samples > ctb_size_y:
                        sps.sps_subpic_ctu_top_left_x[i] = r.u(wlen)
                    if sps.sps_pic_height_max_in_luma_samples > ctb_size_y:
                        sps.sps_subpic_ctu_top_left_y[i] = r.u(hlen)
                    if i < ns and sps.sps_pic_width_max_in_luma_samples > ctb_size_y:
                        sps.sps_subpic_width_minus1[i] = r.u(wlen)
                    else:
                        sps.sps_subpic_width_minus1[i] = \
                            tmp_width_val - sps.sps_subpic_ctu_top_left_x[i] - 1
                    if i < ns and sps.sps_pic_height_max_in_luma_samples > ctb_size_y:
                        sps.sps_subpic_height_minus1[i] = r.u(hlen)
                    else:
                        sps.sps_subpic_height_minus1[i] = \
                            tmp_height_val - sps.sps_subpic_ctu_top_left_y[i] - 1
                else:
                    w0 = sps.sps_subpic_width_minus1[0] + 1
                    h0 = sps.sps_subpic_height_minus1[0] + 1
                    cols = tmp_width_val // w0
                    if tmp_width_val % w0 or tmp_height_val % w0 or \
                            ns != cols * tmp_height_val // h0 - 1:
                        raise H266SyntaxError("invalid same-size subpic layout")
                    sps.sps_subpic_ctu_top_left_x[i] = (i % cols) * w0
                    sps.sps_subpic_ctu_top_left_y[i] = (i // cols) * h0
                    sps.sps_subpic_width_minus1[i] = w0 - 1
                    sps.sps_subpic_height_minus1[i] = h0 - 1
                if not sps.sps_independent_subpics_flag:
                    sps.sps_subpic_treated_as_pic_flag[i] = r.u(1)
                    sps.sps_loop_filter_across_subpic_enabled_flag[i] = r.u(1)
                else:
                    sps.sps_subpic_treated_as_pic_flag[i] = 1
                    sps.sps_loop_filter_across_subpic_enabled_flag[i] = 0
            sps.sps_subpic_id_len_minus1 = r.ue()
            if (1 << (sps.sps_subpic_id_len_minus1 + 1)) < ns + 1:
                raise H266SyntaxError("sps_subpic_id_len too small")
            sps.sps_subpic_id_mapping_explicitly_signalled_flag = r.flag()
            if sps.sps_subpic_id_mapping_explicitly_signalled_flag:
                sps.sps_subpic_id_mapping_present_flag = r.flag()
                if sps.sps_subpic_id_mapping_present_flag:
                    for i in range(ns + 1):
                        sps.sps_subpic_id[i] = r.u(sps.sps_subpic_id_len_minus1 + 1)

    sps.sps_bitdepth_minus8 = r.ue()
    qp_bd_offset = 6 * sps.sps_bitdepth_minus8
    sps.sps_entropy_coding_sync_enabled_flag = r.flag()
    sps.sps_entry_point_offsets_present_flag = r.flag()
    sps.sps_log2_max_pic_order_cnt_lsb_minus4 = r.u(4)
    sps.sps_poc_msb_cycle_flag = r.flag()
    if sps.sps_poc_msb_cycle_flag:
        sps.sps_poc_msb_cycle_len_minus1 = r.ue()
    sps.sps_num_extra_ph_bytes = r.u(2)
    sps.sps_extra_ph_bit_present_flag = [0] * (sps.sps_num_extra_ph_bytes * 8)
    for i in range(sps.sps_num_extra_ph_bytes * 8):
        sps.sps_extra_ph_bit_present_flag[i] = r.u(1)
    sps.sps_num_extra_sh_bytes = r.u(2)
    sps.sps_extra_sh_bit_present_flag = [0] * (sps.sps_num_extra_sh_bytes * 8)
    for i in range(sps.sps_num_extra_sh_bytes * 8):
        sps.sps_extra_sh_bit_present_flag[i] = r.u(1)
    if sps.sps_ptl_dpb_hrd_params_present_flag:
        if sps.sps_max_sublayers_minus1 > 0:
            sps.sps_sublayer_dpb_params_flag = r.flag()
        sps.sps_dpb_params = read_dpb_parameters(
            r, sps.sps_max_sublayers_minus1, bool(sps.sps_sublayer_dpb_params_flag))
    sps.sps_log2_min_luma_coding_block_size_minus2 = r.ue()
    min_cb_log2_size_y = sps.sps_log2_min_luma_coding_block_size_minus2 + 2
    sps.sps_partition_constraints_override_enabled_flag = r.flag()
    sps.sps_log2_diff_min_qt_min_cb_intra_slice_luma = r.ue()
    min_qt_log2_size_intra_y = \
        sps.sps_log2_diff_min_qt_min_cb_intra_slice_luma + min_cb_log2_size_y
    sps.sps_max_mtt_hierarchy_depth_intra_slice_luma = r.ue()
    if sps.sps_max_mtt_hierarchy_depth_intra_slice_luma != 0:
        sps.sps_log2_diff_max_bt_min_qt_intra_slice_luma = r.ue()
        sps.sps_log2_diff_max_tt_min_qt_intra_slice_luma = r.ue()
    if sps.sps_chroma_format_idc != 0:
        sps.sps_qtbtt_dual_tree_intra_flag = r.flag()
    if sps.sps_qtbtt_dual_tree_intra_flag:
        sps.sps_log2_diff_min_qt_min_cb_intra_slice_chroma = r.ue()
        sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma = r.ue()
        if sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma != 0:
            sps.sps_log2_diff_max_bt_min_qt_intra_slice_chroma = r.ue()
            sps.sps_log2_diff_max_tt_min_qt_intra_slice_chroma = r.ue()
    sps.sps_log2_diff_min_qt_min_cb_inter_slice = r.ue()
    min_qt_log2_size_inter_y = \
        sps.sps_log2_diff_min_qt_min_cb_inter_slice + min_cb_log2_size_y
    sps.sps_max_mtt_hierarchy_depth_inter_slice = r.ue()
    if sps.sps_max_mtt_hierarchy_depth_inter_slice != 0:
        sps.sps_log2_diff_max_bt_min_qt_inter_slice = r.ue()
        sps.sps_log2_diff_max_tt_min_qt_inter_slice = r.ue()
    if ctb_size_y > 32:
        sps.sps_max_luma_transform_size_64_flag = r.flag()
    sps.sps_transform_skip_enabled_flag = r.flag()
    if sps.sps_transform_skip_enabled_flag:
        sps.sps_log2_transform_skip_max_size_minus2 = r.ue()
        sps.sps_bdpcm_enabled_flag = r.flag()
    sps.sps_mts_enabled_flag = r.flag()
    if sps.sps_mts_enabled_flag:
        sps.sps_explicit_mts_intra_enabled_flag = r.flag()
        sps.sps_explicit_mts_inter_enabled_flag = r.flag()
    sps.sps_lfnst_enabled_flag = r.flag()
    sps.sps_qp_table_start_minus26 = [0, 0, 0]
    sps.sps_num_points_in_qp_table_minus1 = [0, 0, 0]
    sps.sps_delta_qp_in_val_minus1 = [[], [], []]
    sps.sps_delta_qp_diff_val = [[], [], []]
    if sps.sps_chroma_format_idc != 0:
        sps.sps_joint_cbcr_enabled_flag = r.flag()
        sps.sps_same_qp_table_for_chroma_flag = r.flag()
        num_qp_tables = 1 if sps.sps_same_qp_table_for_chroma_flag else \
            (3 if sps.sps_joint_cbcr_enabled_flag else 2)
        sps.num_qp_tables = num_qp_tables
        for i in range(num_qp_tables):
            sps.sps_qp_table_start_minus26[i] = r.se()
            sps.sps_num_points_in_qp_table_minus1[i] = r.ue()
            npts = sps.sps_num_points_in_qp_table_minus1[i] + 1
            sps.sps_delta_qp_in_val_minus1[i] = [0] * npts
            sps.sps_delta_qp_diff_val[i] = [0] * npts
            for j in range(npts):
                sps.sps_delta_qp_in_val_minus1[i][j] = r.ue()
                sps.sps_delta_qp_diff_val[i][j] = r.ue()
    sps.sps_sao_enabled_flag = r.flag()
    sps.sps_alf_enabled_flag = r.flag()
    if sps.sps_alf_enabled_flag and sps.sps_chroma_format_idc:
        sps.sps_ccalf_enabled_flag = r.flag()
    sps.sps_lmcs_enabled_flag = r.flag()
    sps.sps_weighted_pred_flag = r.flag()
    sps.sps_weighted_bipred_flag = r.flag()
    sps.sps_long_term_ref_pics_flag = r.flag()
    if sps.sps_video_parameter_set_id > 0:
        sps.sps_inter_layer_prediction_enabled_flag = r.flag()
    sps.sps_idr_rpl_present_flag = r.flag()
    sps.sps_rpl1_same_as_rpl0_flag = r.flag()
    sps.sps_num_ref_pic_lists = [0, 0]
    sps.sps_ref_pic_list_struct = [[], []]
    for i in range(1 if sps.sps_rpl1_same_as_rpl0_flag else 2):
        sps.sps_num_ref_pic_lists[i] = r.ue()
        for j in range(sps.sps_num_ref_pic_lists[i]):
            sps.sps_ref_pic_list_struct[i].append(
                read_ref_pic_list_struct(r, sps, i, j))
    if sps.sps_rpl1_same_as_rpl0_flag:
        sps.sps_num_ref_pic_lists[1] = sps.sps_num_ref_pic_lists[0]
        sps.sps_ref_pic_list_struct[1] = list(sps.sps_ref_pic_list_struct[0])
    sps.sps_ref_wraparound_enabled_flag = r.flag()
    sps.sps_temporal_mvp_enabled_flag = r.flag()
    if sps.sps_temporal_mvp_enabled_flag:
        sps.sps_sbtmvp_enabled_flag = r.flag()
    sps.sps_amvr_enabled_flag = r.flag()
    sps.sps_bdof_enabled_flag = r.flag()
    if sps.sps_bdof_enabled_flag:
        sps.sps_bdof_control_present_in_ph_flag = r.flag()
    sps.sps_smvd_enabled_flag = r.flag()
    sps.sps_dmvr_enabled_flag = r.flag()
    if sps.sps_dmvr_enabled_flag:
        sps.sps_dmvr_control_present_in_ph_flag = r.flag()
    sps.sps_mmvd_enabled_flag = r.flag()
    if sps.sps_mmvd_enabled_flag:
        sps.sps_mmvd_fullpel_only_enabled_flag = r.flag()
    sps.sps_six_minus_max_num_merge_cand = r.ue()
    max_num_merge_cand = 6 - sps.sps_six_minus_max_num_merge_cand
    sps.sps_sbt_enabled_flag = r.flag()
    sps.sps_affine_enabled_flag = r.flag()
    if sps.sps_affine_enabled_flag:
        sps.sps_five_minus_max_num_subblock_merge_cand = r.ue()
        sps.sps_6param_affine_enabled_flag = r.flag()
        if sps.sps_amvr_enabled_flag:
            sps.sps_affine_amvr_enabled_flag = r.flag()
        sps.sps_affine_prof_enabled_flag = r.flag()
        if sps.sps_affine_prof_enabled_flag:
            sps.sps_prof_control_present_in_ph_flag = r.flag()
    sps.sps_bcw_enabled_flag = r.flag()
    sps.sps_ciip_enabled_flag = r.flag()
    if max_num_merge_cand >= 2:
        sps.sps_gpm_enabled_flag = r.flag()
        if sps.sps_gpm_enabled_flag and max_num_merge_cand >= 3:
            sps.sps_max_num_merge_cand_minus_max_num_gpm_cand = r.ue()
    sps.sps_log2_parallel_merge_level_minus2 = r.ue()
    sps.sps_isp_enabled_flag = r.flag()
    sps.sps_mrl_enabled_flag = r.flag()
    sps.sps_mip_enabled_flag = r.flag()
    if sps.sps_chroma_format_idc != 0:
        sps.sps_cclm_enabled_flag = r.flag()
    if sps.sps_chroma_format_idc == 1:
        sps.sps_chroma_horizontal_collocated_flag = r.flag()
        sps.sps_chroma_vertical_collocated_flag = r.flag()
    else:
        sps.sps_chroma_horizontal_collocated_flag = 1
        sps.sps_chroma_vertical_collocated_flag = 1
    sps.sps_palette_enabled_flag = r.flag()
    if sps.sps_chroma_format_idc == 3 and not sps.sps_max_luma_transform_size_64_flag:
        sps.sps_act_enabled_flag = r.flag()
    if sps.sps_transform_skip_enabled_flag or sps.sps_palette_enabled_flag:
        sps.sps_min_qp_prime_ts = r.ue()
    sps.sps_ibc_enabled_flag = r.flag()
    if sps.sps_ibc_enabled_flag:
        sps.sps_six_minus_max_num_ibc_merge_cand = r.ue()
    sps.sps_ladf_enabled_flag = r.flag()
    if sps.sps_ladf_enabled_flag:
        sps.sps_num_ladf_intervals_minus2 = r.u(2)
        sps.sps_ladf_lowest_interval_qp_offset = r.se()
        n = sps.sps_num_ladf_intervals_minus2 + 1
        sps.sps_ladf_qp_offset = [0] * n
        sps.sps_ladf_delta_threshold_minus1 = [0] * n
        for i in range(n):
            sps.sps_ladf_qp_offset[i] = r.se()
            sps.sps_ladf_delta_threshold_minus1[i] = r.ue()
    sps.sps_explicit_scaling_list_enabled_flag = r.flag()
    if sps.sps_lfnst_enabled_flag and sps.sps_explicit_scaling_list_enabled_flag:
        sps.sps_scaling_matrix_for_lfnst_disabled_flag = r.flag()
    if sps.sps_act_enabled_flag and sps.sps_explicit_scaling_list_enabled_flag:
        sps.sps_scaling_matrix_for_alternative_colour_space_disabled_flag = r.flag()
    if sps.sps_scaling_matrix_for_alternative_colour_space_disabled_flag:
        sps.sps_scaling_matrix_designated_colour_space_flag = r.flag()
    sps.sps_dep_quant_enabled_flag = r.flag()
    sps.sps_sign_data_hiding_enabled_flag = r.flag()
    sps.sps_virtual_boundaries_enabled_flag = r.flag()
    if sps.sps_virtual_boundaries_enabled_flag:
        sps.sps_virtual_boundaries_present_flag = r.flag()
        if sps.sps_virtual_boundaries_present_flag:
            sps.sps_num_ver_virtual_boundaries = r.ue()
            sps.sps_virtual_boundary_pos_x_minus1 = [
                r.ue() for _ in range(sps.sps_num_ver_virtual_boundaries)]
            sps.sps_num_hor_virtual_boundaries = r.ue()
            sps.sps_virtual_boundary_pos_y_minus1 = [
                r.ue() for _ in range(sps.sps_num_hor_virtual_boundaries)]
    if sps.sps_ptl_dpb_hrd_params_present_flag:
        sps.sps_timing_hrd_params_present_flag = r.flag()
        if sps.sps_timing_hrd_params_present_flag:
            general = read_general_timing_hrd(r)
            sps.sps_general_timing_hrd_parameters = general
            if sps.sps_max_sublayers_minus1 > 0:
                sps.sps_sublayer_cpb_params_present_flag = r.flag()
            first = 0 if sps.sps_sublayer_cpb_params_present_flag \
                else sps.sps_max_sublayers_minus1
            read_ols_timing_hrd(r, first, sps.sps_max_sublayers_minus1, general)
    sps.sps_field_seq_flag = r.flag()
    sps.sps_vui_parameters_present_flag = r.flag()
    if sps.sps_vui_parameters_present_flag:
        payload_size = r.ue() + 1
        while not r.byte_aligned():
            r.u(1)
        vui_start = r.pos
        sps.vui = read_vui_parameters(r, sps.sps_chroma_format_idc)
        # skip any vui payload extension up to the declared size
        consumed = r.pos - vui_start
        if consumed < 8 * payload_size:
            r.skip(8 * payload_size - consumed)
    else:
        vui = SyntaxObj()
        vui.vui_colour_primaries = 2
        vui.vui_transfer_characteristics = 2
        vui.vui_matrix_coeffs = 2
        sps.vui = vui
    sps.sps_extension_flag = r.flag()
    if sps.sps_extension_flag:
        sps.sps_range_extension_flag = r.flag()
        sps.sps_extension_7bits = r.u(7)
        if sps.sps_range_extension_flag:
            sps.sps_extended_precision_flag = r.flag()
            if sps.sps_transform_skip_enabled_flag:
                sps.sps_ts_residual_coding_rice_present_in_sh_flag = r.flag()
            sps.sps_rrc_rice_extension_flag = r.flag()
            sps.sps_persistent_rice_adaptation_enabled_flag = r.flag()
            sps.sps_reverse_last_sig_coeff_enabled_flag = r.flag()
    # any sps_extension_7bits data is ignored to end of rbsp
    return sps


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

def read_pps(r: BitReader, ps: "H266ParamSets") -> SyntaxObj:
    """H.266 7.3.2.5 pic_parameter_set_rbsp; reference cbs template :1645-2253.

    Besides the raw fields, derives the tile grid (col_width_val /
    row_height_val, NumTileColumns/Rows) and the rectangular-slice layout
    (slice_top_left_ctu_x/y, slice_height_in_ctus, per-slice tile spans),
    which downstream slice-address mapping needs.
    """
    pps = SyntaxObj()
    pps.pps_pic_parameter_set_id = r.u(6)
    pps.pps_seq_parameter_set_id = r.u(4)
    sps = ps.sps.get(pps.pps_seq_parameter_set_id)
    if sps is None:
        raise H266SyntaxError(f"SPS id {pps.pps_seq_parameter_set_id} not available")
    pps.pps_mixed_nalu_types_in_pic_flag = r.flag()
    pps.pps_pic_width_in_luma_samples = r.ue()
    pps.pps_pic_height_in_luma_samples = r.ue()
    min_cb_size_y = 1 << (sps.sps_log2_min_luma_coding_block_size_minus2 + 2)
    divisor = max(min_cb_size_y, 8)
    if pps.pps_pic_width_in_luma_samples % divisor or \
            pps.pps_pic_height_in_luma_samples % divisor:
        raise H266SyntaxError("picture size not divisible by max(MinCbSizeY,8)")
    ctb_log2_size_y = sps.sps_log2_ctu_size_minus5 + 5
    ctb_size_y = 1 << ctb_log2_size_y
    pps.pps_conformance_window_flag = r.flag()
    if pps.pps_conformance_window_flag:
        pps.pps_conf_win_left_offset = r.ue()
        pps.pps_conf_win_right_offset = r.ue()
        pps.pps_conf_win_top_offset = r.ue()
        pps.pps_conf_win_bottom_offset = r.ue()
    else:
        if pps.pps_pic_width_in_luma_samples == sps.sps_pic_width_max_in_luma_samples \
                and pps.pps_pic_height_in_luma_samples == sps.sps_pic_height_max_in_luma_samples:
            pps.pps_conf_win_left_offset = sps.sps_conf_win_left_offset
            pps.pps_conf_win_right_offset = sps.sps_conf_win_right_offset
            pps.pps_conf_win_top_offset = sps.sps_conf_win_top_offset
            pps.pps_conf_win_bottom_offset = sps.sps_conf_win_bottom_offset
    pps.pps_scaling_window_explicit_signalling_flag = r.flag()
    if pps.pps_scaling_window_explicit_signalling_flag:
        pps.pps_scaling_win_left_offset = r.se()
        pps.pps_scaling_win_right_offset = r.se()
        pps.pps_scaling_win_top_offset = r.se()
        pps.pps_scaling_win_bottom_offset = r.se()
    else:
        pps.pps_scaling_win_left_offset = pps.pps_conf_win_left_offset
        pps.pps_scaling_win_right_offset = pps.pps_conf_win_right_offset
        pps.pps_scaling_win_top_offset = pps.pps_conf_win_top_offset
        pps.pps_scaling_win_bottom_offset = pps.pps_conf_win_bottom_offset
    pps.pps_output_flag_present_flag = r.flag()
    pps.pps_no_pic_partition_flag = r.flag()
    pps.pps_subpic_id_mapping_present_flag = r.flag()
    if pps.pps_subpic_id_mapping_present_flag:
        if not pps.pps_no_pic_partition_flag:
            pps.pps_num_subpics_minus1 = r.ue()
        else:
            pps.pps_num_subpics_minus1 = 0
        pps.pps_subpic_id_len_minus1 = r.ue()
        pps.pps_subpic_id = [0] * (pps.pps_num_subpics_minus1 + 1)
        for i in range(pps.pps_num_subpics_minus1 + 1):
            pps.pps_subpic_id[i] = r.u(sps.sps_subpic_id_len_minus1 + 1)
    pps.sub_pic_id_val = [0] * (sps.sps_num_subpics_minus1 + 1)
    for i in range(sps.sps_num_subpics_minus1 + 1):
        if sps.sps_subpic_id_mapping_explicitly_signalled_flag:
            pps.sub_pic_id_val[i] = pps.pps_subpic_id[i] \
                if pps.pps_subpic_id_mapping_present_flag else sps.sps_subpic_id[i]
        else:
            pps.sub_pic_id_val[i] = i
    pic_width_in_ctbs_y = -(-pps.pps_pic_width_in_luma_samples // ctb_size_y)
    pic_height_in_ctbs_y = -(-pps.pps_pic_height_in_luma_samples // ctb_size_y)
    pps.slice_top_left_ctu_x = [0] * MAX_SLICES
    pps.slice_top_left_ctu_y = [0] * MAX_SLICES
    pps.slice_height_in_ctus = [0] * MAX_SLICES
    pps.pps_slice_width_in_tiles_minus1 = [0] * MAX_SLICES
    pps.pps_slice_height_in_tiles_minus1 = [0] * MAX_SLICES
    pps.pps_num_exp_slices_in_tile = [0] * MAX_SLICES
    pps.num_slices_in_subpic = [0] * (sps.sps_num_subpics_minus1 + 1)
    if not pps.pps_no_pic_partition_flag:
        pps.pps_log2_ctu_size_minus5 = r.u(2)
        pps.pps_num_exp_tile_columns_minus1 = r.ue()
        pps.pps_num_exp_tile_rows_minus1 = r.ue()
        pps.pps_tile_column_width_minus1 = [
            r.ue() for _ in range(pps.pps_num_exp_tile_columns_minus1 + 1)]
        pps.pps_tile_row_height_minus1 = [
            r.ue() for _ in range(pps.pps_num_exp_tile_rows_minus1 + 1)]
        # derive the full tile grid: explicit sizes then repeat the last one
        col_width = []
        remaining = pic_width_in_ctbs_y
        for w in pps.pps_tile_column_width_minus1:
            if w + 1 > remaining:
                raise H266SyntaxError("tile column width exceeds picture width")
            col_width.append(w + 1)
            remaining -= w + 1
        unified = col_width[-1]
        while remaining > 0:
            unified = min(remaining, unified)
            col_width.append(unified)
            remaining -= unified
        row_height = []
        remaining = pic_height_in_ctbs_y
        for h in pps.pps_tile_row_height_minus1:
            if h + 1 > remaining:
                raise H266SyntaxError("tile row height exceeds picture height")
            row_height.append(h + 1)
            remaining -= h + 1
        unified = row_height[-1]
        while remaining > 0:
            unified = min(remaining, unified)
            row_height.append(unified)
            remaining -= unified
        pps.col_width_val = col_width
        pps.row_height_val = row_height
        pps.num_tile_columns = len(col_width)
        pps.num_tile_rows = len(row_height)
        pps.num_tiles_in_pic = pps.num_tile_columns * pps.num_tile_rows
        if pps.num_tiles_in_pic > 1:
            pps.pps_loop_filter_across_tiles_enabled_flag = r.flag()
            pps.pps_rect_slice_flag = r.flag()
        else:
            pps.pps_loop_filter_across_tiles_enabled_flag = 0
            pps.pps_rect_slice_flag = 1
        if pps.pps_rect_slice_flag:
            pps.pps_single_slice_per_subpic_flag = r.flag()
        else:
            pps.pps_single_slice_per_subpic_flag = 1
        if pps.pps_rect_slice_flag and not pps.pps_single_slice_per_subpic_flag:
            tile_idx = 0
            pps.pps_num_slices_in_pic_minus1 = r.ue()
            if pps.pps_num_slices_in_pic_minus1 > 1:
                pps.pps_tile_idx_delta_present_flag = r.flag()
            i = 0
            while i < pps.pps_num_slices_in_pic_minus1:
                tile_x = tile_idx % pps.num_tile_columns
                tile_y = tile_idx // pps.num_tile_columns
                if tile_x != pps.num_tile_columns - 1:
                    pps.pps_slice_width_in_tiles_minus1[i] = r.ue()
                if tile_y != pps.num_tile_rows - 1 and \
                        (pps.pps_tile_idx_delta_present_flag or tile_x == 0):
                    pps.pps_slice_height_in_tiles_minus1[i] = r.ue()
                elif tile_y == pps.num_tile_rows - 1:
                    pps.pps_slice_height_in_tiles_minus1[i] = 0
                else:
                    pps.pps_slice_height_in_tiles_minus1[i] = \
                        pps.pps_slice_height_in_tiles_minus1[i - 1]
                ctu_x = sum(col_width[:tile_x])
                ctu_y = sum(row_height[:tile_y])
                if pps.pps_slice_width_in_tiles_minus1[i] == 0 and \
                        pps.pps_slice_height_in_tiles_minus1[i] == 0 and \
                        row_height[tile_y] > 1:
                    # one or more slices inside a single tile
                    remaining_h = row_height[tile_y]
                    pps.pps_num_exp_slices_in_tile[i] = r.ue()
                    if pps.pps_num_exp_slices_in_tile[i] == 0:
                        num_slices_in_tile = 1
                        pps.slice_height_in_ctus[i] = row_height[tile_y]
                        pps.slice_top_left_ctu_x[i] = ctu_x
                        pps.slice_top_left_ctu_y[i] = ctu_y
                    else:
                        exp = []
                        j = 0
                        for j in range(pps.pps_num_exp_slices_in_tile[i]):
                            h = r.ue() + 1
                            exp.append(h)
                            pps.slice_height_in_ctus[i + j] = h
                            pps.slice_top_left_ctu_x[i + j] = ctu_x
                            pps.slice_top_left_ctu_y[i + j] = ctu_y
                            ctu_y += h
                            remaining_h -= h
                        j = pps.pps_num_exp_slices_in_tile[i]
                        uniform = exp[-1] if exp else row_height[tile_y]
                        while remaining_h > uniform:
                            pps.slice_height_in_ctus[i + j] = uniform
                            pps.slice_top_left_ctu_x[i + j] = ctu_x
                            pps.slice_top_left_ctu_y[i + j] = ctu_y
                            ctu_y += uniform
                            remaining_h -= uniform
                            j += 1
                        if remaining_h > 0:
                            pps.slice_height_in_ctus[i + j] = remaining_h
                            pps.slice_top_left_ctu_x[i + j] = ctu_x
                            pps.slice_top_left_ctu_y[i + j] = ctu_y
                            j += 1
                        num_slices_in_tile = j
                    i += num_slices_in_tile - 1
                else:
                    height = 0
                    for j in range(pps.pps_slice_height_in_tiles_minus1[i] + 1):
                        height += row_height[tile_y + j]
                    pps.slice_height_in_ctus[i] = height
                    pps.slice_top_left_ctu_x[i] = ctu_x
                    pps.slice_top_left_ctu_y[i] = ctu_y
                if i < pps.pps_num_slices_in_pic_minus1:
                    if pps.pps_tile_idx_delta_present_flag:
                        delta = r.se()
                        if delta == 0:
                            raise H266SyntaxError("pps_tile_idx_delta_val == 0")
                        tile_idx += delta
                    else:
                        tile_idx += pps.pps_slice_width_in_tiles_minus1[i] + 1
                        if tile_idx % pps.num_tile_columns == 0:
                            tile_idx += pps.pps_slice_height_in_tiles_minus1[i] * \
                                pps.num_tile_columns
                i += 1
            # the last slice covers everything right/below of its tile corner
            if i == pps.pps_num_slices_in_pic_minus1:
                tile_x = tile_idx % pps.num_tile_columns
                tile_y = tile_idx // pps.num_tile_columns
                ctu_x = sum(col_width[:tile_x])
                ctu_y = sum(row_height[:tile_y])
                pps.slice_top_left_ctu_x[i] = ctu_x
                pps.slice_top_left_ctu_y[i] = ctu_y
                pps.pps_slice_width_in_tiles_minus1[i] = \
                    pps.num_tile_columns - tile_x - 1
                pps.pps_slice_height_in_tiles_minus1[i] = \
                    pps.num_tile_rows - tile_y - 1
                height = 0
                for j in range(pps.pps_slice_height_in_tiles_minus1[i] + 1):
                    height += row_height[tile_y + j]
                pps.slice_height_in_ctus[i] = height
            # NumSlicesInSubpic
            for i in range(sps.sps_num_subpics_minus1 + 1):
                cnt = 0
                for j in range(pps.pps_num_slices_in_pic_minus1 + 1):
                    px = pps.slice_top_left_ctu_x[j]
                    py = pps.slice_top_left_ctu_y[j]
                    if sps.sps_subpic_ctu_top_left_x[i] <= px < \
                            sps.sps_subpic_ctu_top_left_x[i] + sps.sps_subpic_width_minus1[i] + 1 \
                            and sps.sps_subpic_ctu_top_left_y[i] <= py < \
                            sps.sps_subpic_ctu_top_left_y[i] + sps.sps_subpic_height_minus1[i] + 1:
                        cnt += 1
                pps.num_slices_in_subpic[i] = cnt
        else:
            if pps.pps_no_pic_partition_flag:
                pps.pps_num_slices_in_pic_minus1 = 0
            elif pps.pps_single_slice_per_subpic_flag:
                pps.pps_num_slices_in_pic_minus1 = sps.sps_num_subpics_minus1
            for i in range(sps.sps_num_subpics_minus1 + 1):
                pps.num_slices_in_subpic[i] = 1
        if not pps.pps_rect_slice_flag or pps.pps_single_slice_per_subpic_flag or \
                pps.pps_num_slices_in_pic_minus1 > 0:
            pps.pps_loop_filter_across_slices_enabled_flag = r.flag()
    else:
        pps.col_width_val = [pic_width_in_ctbs_y]
        pps.row_height_val = [pic_height_in_ctbs_y]
        pps.num_tile_columns = 1
        pps.num_tile_rows = 1
        pps.num_tiles_in_pic = 1
        pps.pps_rect_slice_flag = 1
        pps.pps_single_slice_per_subpic_flag = 1
        pps.pps_num_slices_in_pic_minus1 = 0
        for i in range(sps.sps_num_subpics_minus1 + 1):
            pps.num_slices_in_subpic[i] = 1
    pps.pps_cabac_init_present_flag = r.flag()
    pps.pps_num_ref_idx_default_active_minus1 = [r.ue(), r.ue()]
    pps.pps_rpl1_idx_present_flag = r.flag()
    pps.pps_weighted_pred_flag = r.flag()
    pps.pps_weighted_bipred_flag = r.flag()
    pps.pps_ref_wraparound_enabled_flag = r.flag()
    if pps.pps_ref_wraparound_enabled_flag:
        pps.pps_pic_width_minus_wraparound_offset = r.ue()
    pps.pps_init_qp_minus26 = r.se()
    pps.pps_cu_qp_delta_enabled_flag = r.flag()
    pps.pps_chroma_tool_offsets_present_flag = r.flag()
    if pps.pps_chroma_tool_offsets_present_flag:
        pps.pps_cb_qp_offset = r.se()
        pps.pps_cr_qp_offset = r.se()
        pps.pps_joint_cbcr_qp_offset_present_flag = r.flag()
        if pps.pps_joint_cbcr_qp_offset_present_flag:
            pps.pps_joint_cbcr_qp_offset_value = r.se()
        pps.pps_slice_chroma_qp_offsets_present_flag = r.flag()
        pps.pps_cu_chroma_qp_offset_list_enabled_flag = r.flag()
        if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
            pps.pps_chroma_qp_offset_list_len_minus1 = r.ue()
            n = pps.pps_chroma_qp_offset_list_len_minus1 + 1
            pps.pps_cb_qp_offset_list = [0] * n
            pps.pps_cr_qp_offset_list = [0] * n
            pps.pps_joint_cbcr_qp_offset_list = [0] * n
            for i in range(n):
                pps.pps_cb_qp_offset_list[i] = r.se()
                pps.pps_cr_qp_offset_list[i] = r.se()
                if pps.pps_joint_cbcr_qp_offset_present_flag:
                    pps.pps_joint_cbcr_qp_offset_list[i] = r.se()
    pps.pps_deblocking_filter_control_present_flag = r.flag()
    if pps.pps_deblocking_filter_control_present_flag:
        pps.pps_deblocking_filter_override_enabled_flag = r.flag()
        pps.pps_deblocking_filter_disabled_flag = r.flag()
        if not pps.pps_no_pic_partition_flag and \
                pps.pps_deblocking_filter_override_enabled_flag:
            pps.pps_dbf_info_in_ph_flag = r.flag()
        if not pps.pps_deblocking_filter_disabled_flag:
            pps.pps_luma_beta_offset_div2 = r.se()
            pps.pps_luma_tc_offset_div2 = r.se()
            if pps.pps_chroma_tool_offsets_present_flag:
                pps.pps_cb_beta_offset_div2 = r.se()
                pps.pps_cb_tc_offset_div2 = r.se()
                pps.pps_cr_beta_offset_div2 = r.se()
                pps.pps_cr_tc_offset_div2 = r.se()
            else:
                pps.pps_cb_beta_offset_div2 = pps.pps_luma_beta_offset_div2
                pps.pps_cb_tc_offset_div2 = pps.pps_luma_tc_offset_div2
                pps.pps_cr_beta_offset_div2 = pps.pps_luma_beta_offset_div2
                pps.pps_cr_tc_offset_div2 = pps.pps_luma_tc_offset_div2
    if not pps.pps_no_pic_partition_flag:
        pps.pps_rpl_info_in_ph_flag = r.flag()
        pps.pps_sao_info_in_ph_flag = r.flag()
        pps.pps_alf_info_in_ph_flag = r.flag()
        if (pps.pps_weighted_pred_flag or pps.pps_weighted_bipred_flag) and \
                pps.pps_rpl_info_in_ph_flag:
            pps.pps_wp_info_in_ph_flag = r.flag()
        pps.pps_qp_delta_info_in_ph_flag = r.flag()
    pps.pps_picture_header_extension_present_flag = r.flag()
    pps.pps_slice_header_extension_present_flag = r.flag()
    pps.pps_extension_flag = r.flag()
    return pps


# ---------------------------------------------------------------------------
# APS (ALF / LMCS / scaling lists)
# ---------------------------------------------------------------------------

def read_alf_data(r: BitReader, aps: SyntaxObj):
    """alf_data(): H.266 7.3.2.19; reference cbs template :2256-2365."""
    aps.alf_luma_filter_signal_flag = r.flag()
    if aps.aps_chroma_present_flag:
        aps.alf_chroma_filter_signal_flag = r.flag()
        aps.alf_cc_cb_filter_signal_flag = r.flag()
        aps.alf_cc_cr_filter_signal_flag = r.flag()
    aps.alf_luma_coeff_delta_idx = [0] * NUM_ALF_FILTERS
    if aps.alf_luma_filter_signal_flag:
        aps.alf_luma_clip_flag = r.flag()
        aps.alf_luma_num_filters_signalled_minus1 = r.ue()
        if aps.alf_luma_num_filters_signalled_minus1 > 0:
            bits = ceil_log2(aps.alf_luma_num_filters_signalled_minus1 + 1)
            for k in range(NUM_ALF_FILTERS):
                aps.alf_luma_coeff_delta_idx[k] = r.u(bits)
        nf = aps.alf_luma_num_filters_signalled_minus1 + 1
        aps.alf_luma_coeff_abs = [[0] * 12 for _ in range(nf)]
        aps.alf_luma_coeff_sign = [[0] * 12 for _ in range(nf)]
        for sf in range(nf):
            for j in range(12):
                aps.alf_luma_coeff_abs[sf][j] = r.ue()
                if aps.alf_luma_coeff_abs[sf][j]:
                    aps.alf_luma_coeff_sign[sf][j] = r.u(1)
    nf = aps.alf_luma_num_filters_signalled_minus1 + 1
    aps.alf_luma_clip_idx = [[0] * 12 for _ in range(nf)]
    for sf in range(nf):
        for j in range(12):
            if aps.alf_luma_clip_flag:
                aps.alf_luma_clip_idx[sf][j] = r.u(2)
    if aps.alf_chroma_filter_signal_flag:
        aps.alf_chroma_clip_flag = r.flag()
        aps.alf_chroma_num_alt_filters_minus1 = r.ue()
    na = aps.alf_chroma_num_alt_filters_minus1 + 1
    aps.alf_chroma_coeff_abs = [[0] * 6 for _ in range(na)]
    aps.alf_chroma_coeff_sign = [[0] * 6 for _ in range(na)]
    aps.alf_chroma_clip_idx = [[0] * 6 for _ in range(na)]
    for alt in range(na):
        for j in range(6):
            if aps.alf_chroma_filter_signal_flag:
                aps.alf_chroma_coeff_abs[alt][j] = r.ue()
            if aps.alf_chroma_coeff_abs[alt][j] > 0:
                aps.alf_chroma_coeff_sign[alt][j] = r.u(1)
        for j in range(6):
            if aps.alf_chroma_clip_flag:
                aps.alf_chroma_clip_idx[alt][j] = r.u(2)
    if aps.alf_cc_cb_filter_signal_flag:
        aps.alf_cc_cb_filters_signalled_minus1 = r.ue()
    ncb = aps.alf_cc_cb_filters_signalled_minus1 + 1
    aps.alf_cc_cb_mapped_coeff_abs = [[0] * 7 for _ in range(ncb)]
    aps.alf_cc_cb_coeff_sign = [[0] * 7 for _ in range(ncb)]
    for k in range(ncb):
        for j in range(7):
            if aps.alf_cc_cb_filter_signal_flag:
                aps.alf_cc_cb_mapped_coeff_abs[k][j] = r.u(3)
            if aps.alf_cc_cb_mapped_coeff_abs[k][j]:
                aps.alf_cc_cb_coeff_sign[k][j] = r.u(1)
    if aps.alf_cc_cr_filter_signal_flag:
        aps.alf_cc_cr_filters_signalled_minus1 = r.ue()
    ncr = aps.alf_cc_cr_filters_signalled_minus1 + 1
    aps.alf_cc_cr_mapped_coeff_abs = [[0] * 7 for _ in range(ncr)]
    aps.alf_cc_cr_coeff_sign = [[0] * 7 for _ in range(ncr)]
    for k in range(ncr):
        for j in range(7):
            if aps.alf_cc_cr_filter_signal_flag:
                aps.alf_cc_cr_mapped_coeff_abs[k][j] = r.u(3)
            if aps.alf_cc_cr_mapped_coeff_abs[k][j]:
                aps.alf_cc_cr_coeff_sign[k][j] = r.u(1)


def read_lmcs_data(r: BitReader, aps: SyntaxObj):
    """lmcs_data(): H.266 7.3.2.20; reference cbs template :2367-2401."""
    aps.lmcs_min_bin_idx = r.ue()
    aps.lmcs_delta_max_bin_idx = r.ue()
    aps.lmcs_delta_cw_prec_minus1 = r.ue()
    lmcs_max_bin_idx = 15 - aps.lmcs_delta_max_bin_idx
    if lmcs_max_bin_idx < aps.lmcs_min_bin_idx:
        raise H266SyntaxError("invalid lmcs bin range")
    aps.lmcs_delta_abs_cw = [0] * 16
    aps.lmcs_delta_sign_cw_flag = [0] * 16
    for i in range(aps.lmcs_min_bin_idx, lmcs_max_bin_idx + 1):
        aps.lmcs_delta_abs_cw[i] = r.u(aps.lmcs_delta_cw_prec_minus1 + 1)
        if aps.lmcs_delta_abs_cw[i] > 0:
            aps.lmcs_delta_sign_cw_flag[i] = r.u(1)
    if aps.aps_chroma_present_flag:
        aps.lmcs_delta_abs_crs = r.u(3)
        if aps.lmcs_delta_abs_crs > 0:
            aps.lmcs_delta_sign_crs_flag = r.u(1)


# diagonal scan order for an 8x8 block, as (x, y) pairs — derivable from the
# H.266 6.5.2 up-right diagonal scan; used for scaling-list coefficient order.
def diag_scan_order(size: int):
    order = []
    for s in range(2 * size - 1):
        for y in range(size - 1, -1, -1):
            x = s - y
            if 0 <= x < size:
                order.append((x, y))
    return order


_DIAG8 = None


def read_scaling_list_data(r: BitReader, aps: SyntaxObj):
    """scaling_list_data(): H.266 7.3.2.21; reference cbs template :2403-2454."""
    global _DIAG8
    if _DIAG8 is None:
        _DIAG8 = diag_scan_order(8)
    aps.scaling_list_copy_mode_flag = [1] * 28
    aps.scaling_list_pred_mode_flag = [0] * 28
    aps.scaling_list_pred_id_delta = [0] * 28
    aps.scaling_list_dc_coef = [0] * 14
    aps.scaling_list_delta_coef = [[0] * 64 for _ in range(28)]
    for sid in range(28):
        if aps.aps_chroma_present_flag or sid % 3 == 2 or sid == 27:
            aps.scaling_list_copy_mode_flag[sid] = r.u(1)
            if not aps.scaling_list_copy_mode_flag[sid]:
                aps.scaling_list_pred_mode_flag[sid] = r.u(1)
            if (aps.scaling_list_copy_mode_flag[sid] or
                    aps.scaling_list_pred_mode_flag[sid]) and sid not in (0, 2, 8):
                aps.scaling_list_pred_id_delta[sid] = r.ue()
            if not aps.scaling_list_copy_mode_flag[sid]:
                matrix_size = 2 if sid < 2 else (4 if sid < 8 else 8)
                if sid > 13:
                    aps.scaling_list_dc_coef[sid - 14] = r.se()
                for i in range(matrix_size * matrix_size):
                    x, y = _DIAG8[i] if matrix_size == 8 else \
                        diag_scan_order(matrix_size)[i]
                    if not (sid > 25 and x >= 4 and y >= 4):
                        aps.scaling_list_delta_coef[sid][i] = r.se()


def read_aps(r: BitReader) -> SyntaxObj:
    """adaptation_parameter_set_rbsp; reference cbs template :2456-2491."""
    aps = SyntaxObj()
    aps.aps_params_type = r.u(3)
    aps.aps_adaptation_parameter_set_id = r.u(5)
    aps.aps_chroma_present_flag = r.flag()
    if aps.aps_params_type == APS_ALF:
        read_alf_data(r, aps)
    elif aps.aps_params_type == APS_LMCS:
        read_lmcs_data(r, aps)
    elif aps.aps_params_type == APS_SCALING:
        read_scaling_list_data(r, aps)
    aps.aps_extension_flag = r.flag()
    return aps


# ---------------------------------------------------------------------------
# rectangular-slice geometry helper
# ---------------------------------------------------------------------------

def rect_slice_geometry(sps: SyntaxObj, pps: SyntaxObj, slice_idx: int):
    """For a rectangular slice, return (top_left_ctu_x, top_left_ctu_y,
    width_in_tiles, height_in_tiles, height_in_ctus, width_in_ctus).

    Handles both the explicitly-signalled layout and
    pps_single_slice_per_subpic_flag (slice == subpicture).
    """
    ctb = 1 << (sps.sps_log2_ctu_size_minus5 + 5)
    if pps.pps_single_slice_per_subpic_flag:
        x0 = sps.sps_subpic_ctu_top_left_x[slice_idx]
        y0 = sps.sps_subpic_ctu_top_left_y[slice_idx]
        w_ctu = sps.sps_subpic_width_minus1[slice_idx] + 1
        h_ctu = sps.sps_subpic_height_minus1[slice_idx] + 1
        # count tiles overlapped (subpic boundaries coincide with tile
        # boundaries per A.4; clip to be safe)
        wt = ht = 0
        cx = 0
        for w in pps.col_width_val:
            if cx < x0 + w_ctu and cx + w > x0:
                wt += 1
            cx += w
        cy = 0
        for h in pps.row_height_val:
            if cy < y0 + h_ctu and cy + h > y0:
                ht += 1
            cy += h
        return x0, y0, max(wt, 1), max(ht, 1), h_ctu, w_ctu
    x0 = pps.slice_top_left_ctu_x[slice_idx]
    y0 = pps.slice_top_left_ctu_y[slice_idx]
    wt = pps.pps_slice_width_in_tiles_minus1[slice_idx] + 1
    ht = pps.pps_slice_height_in_tiles_minus1[slice_idx] + 1
    h_ctu = pps.slice_height_in_ctus[slice_idx]
    # width in CTUs: sum of spanned tile columns
    tile_x = 0
    cx = 0
    for i, w in enumerate(pps.col_width_val):
        if cx == x0:
            tile_x = i
            break
        cx += w
    w_ctu = sum(pps.col_width_val[tile_x:tile_x + wt])
    return x0, y0, wt, ht, h_ctu, w_ctu


# ---------------------------------------------------------------------------
# pred_weight_table
# ---------------------------------------------------------------------------

def read_pred_weight_table(r: BitReader, sps: SyntaxObj, pps: SyntaxObj,
                           ref_lists: SyntaxObj, num_ref_idx_active) -> SyntaxObj:
    """H.266 7.3.8 pred_weight_table; reference cbs template :2510-2591."""
    w = SyntaxObj()
    w.luma_log2_weight_denom = r.ue()
    if sps.sps_chroma_format_idc != 0:
        w.delta_chroma_log2_weight_denom = r.se()
    if pps.pps_wp_info_in_ph_flag:
        w.num_l0_weights = r.ue()
        w.num_weights_l0 = w.num_l0_weights
    else:
        w.num_weights_l0 = num_ref_idx_active[0]
    n0 = w.num_weights_l0
    w.luma_weight_l0_flag = [0] * n0
    w.chroma_weight_l0_flag = [0] * n0
    w.delta_luma_weight_l0 = [0] * n0
    w.luma_offset_l0 = [0] * n0
    w.delta_chroma_weight_l0 = [[0, 0] for _ in range(n0)]
    w.delta_chroma_offset_l0 = [[0, 0] for _ in range(n0)]
    for i in range(n0):
        w.luma_weight_l0_flag[i] = r.u(1)
    if sps.sps_chroma_format_idc != 0:
        for i in range(n0):
            w.chroma_weight_l0_flag[i] = r.u(1)
    for i in range(n0):
        if w.luma_weight_l0_flag[i]:
            w.delta_luma_weight_l0[i] = r.se()
            w.luma_offset_l0[i] = r.se()
        if w.chroma_weight_l0_flag[i]:
            for j in range(2):
                w.delta_chroma_weight_l0[i][j] = r.se()
                w.delta_chroma_offset_l0[i][j] = r.se()
    if pps.pps_weighted_bipred_flag and ref_lists.rpl_ref_list[1].num_ref_entries > 0:
        if pps.pps_wp_info_in_ph_flag:
            w.num_l1_weights = r.ue()
            w.num_weights_l1 = w.num_l1_weights
        else:
            w.num_weights_l1 = num_ref_idx_active[1]
    else:
        w.num_weights_l1 = 0
    n1 = w.num_weights_l1
    w.luma_weight_l1_flag = [0] * n1
    w.chroma_weight_l1_flag = [0] * n1
    w.delta_luma_weight_l1 = [0] * n1
    w.luma_offset_l1 = [0] * n1
    w.delta_chroma_weight_l1 = [[0, 0] for _ in range(n1)]
    w.delta_chroma_offset_l1 = [[0, 0] for _ in range(n1)]
    for i in range(n1):
        w.luma_weight_l1_flag[i] = r.u(1)
    if sps.sps_chroma_format_idc != 0:
        for i in range(n1):
            w.chroma_weight_l1_flag[i] = r.u(1)
    for i in range(n1):
        if w.luma_weight_l1_flag[i]:
            w.delta_luma_weight_l1[i] = r.se()
            w.luma_offset_l1[i] = r.se()
        if w.chroma_weight_l1_flag[i]:
            for j in range(2):
                w.delta_chroma_weight_l1[i][j] = r.se()
                w.delta_chroma_offset_l1[i][j] = r.se()
    return w


# ---------------------------------------------------------------------------
# Picture header
# ---------------------------------------------------------------------------

def read_picture_header(r: BitReader, ps: "H266ParamSets") -> SyntaxObj:
    """H.266 7.3.2.8 picture_header_structure; reference cbs template :2593-2996."""
    ph = SyntaxObj()
    ph.ph_gdr_or_irap_pic_flag = r.flag()
    ph.ph_non_ref_pic_flag = r.flag()
    if ph.ph_gdr_or_irap_pic_flag:
        ph.ph_gdr_pic_flag = r.flag()
    ph.ph_inter_slice_allowed_flag = r.flag()
    if ph.ph_inter_slice_allowed_flag:
        ph.ph_intra_slice_allowed_flag = r.flag()
    else:
        ph.ph_intra_slice_allowed_flag = 1
    ph.ph_pic_parameter_set_id = r.ue()
    pps = ps.pps.get(ph.ph_pic_parameter_set_id)
    if pps is None:
        raise H266SyntaxError(f"PPS id {ph.ph_pic_parameter_set_id} not available")
    sps = ps.sps[pps.pps_seq_parameter_set_id]
    ph.ph_pic_order_cnt_lsb = r.u(sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4)
    if ph.ph_gdr_pic_flag:
        ph.ph_recovery_poc_cnt = r.ue()
    for i in range(sps.sps_num_extra_ph_bytes * 8):
        if sps.sps_extra_ph_bit_present_flag[i]:
            r.u(1)
    if sps.sps_poc_msb_cycle_flag:
        ph.ph_poc_msb_cycle_present_flag = r.flag()
        if ph.ph_poc_msb_cycle_present_flag:
            ph.ph_poc_msb_cycle_val = r.u(sps.sps_poc_msb_cycle_len_minus1 + 1)
    ph.ph_alf_aps_id_luma = []
    if sps.sps_alf_enabled_flag and pps.pps_alf_info_in_ph_flag:
        ph.ph_alf_enabled_flag = r.flag()
        if ph.ph_alf_enabled_flag:
            ph.ph_num_alf_aps_ids_luma = r.u(3)
            ph.ph_alf_aps_id_luma = [r.u(3) for _ in range(ph.ph_num_alf_aps_ids_luma)]
            if sps.sps_chroma_format_idc != 0:
                ph.ph_alf_cb_enabled_flag = r.flag()
                ph.ph_alf_cr_enabled_flag = r.flag()
            if ph.ph_alf_cb_enabled_flag or ph.ph_alf_cr_enabled_flag:
                ph.ph_alf_aps_id_chroma = r.u(3)
            if sps.sps_ccalf_enabled_flag:
                ph.ph_alf_cc_cb_enabled_flag = r.flag()
                if ph.ph_alf_cc_cb_enabled_flag:
                    ph.ph_alf_cc_cb_aps_id = r.u(3)
                ph.ph_alf_cc_cr_enabled_flag = r.flag()
                if ph.ph_alf_cc_cr_enabled_flag:
                    ph.ph_alf_cc_cr_aps_id = r.u(3)
    if sps.sps_lmcs_enabled_flag:
        ph.ph_lmcs_enabled_flag = r.flag()
        if ph.ph_lmcs_enabled_flag:
            ph.ph_lmcs_aps_id = r.u(2)
            if sps.sps_chroma_format_idc != 0:
                ph.ph_chroma_residual_scale_flag = r.flag()
    if sps.sps_explicit_scaling_list_enabled_flag:
        ph.ph_explicit_scaling_list_enabled_flag = r.flag()
        if ph.ph_explicit_scaling_list_enabled_flag:
            ph.ph_scaling_list_aps_id = r.u(3)
    if sps.sps_virtual_boundaries_enabled_flag and \
            not sps.sps_virtual_boundaries_present_flag:
        ph.ph_virtual_boundaries_present_flag = r.flag()
        if ph.ph_virtual_boundaries_present_flag:
            ph.ph_num_ver_virtual_boundaries = r.ue()
            ph.ph_virtual_boundary_pos_x_minus1 = [
                r.ue() for _ in range(ph.ph_num_ver_virtual_boundaries)]
            ph.ph_num_hor_virtual_boundaries = r.ue()
            ph.ph_virtual_boundary_pos_y_minus1 = [
                r.ue() for _ in range(ph.ph_num_hor_virtual_boundaries)]
    if pps.pps_output_flag_present_flag and not ph.ph_non_ref_pic_flag:
        ph.ph_pic_output_flag = r.flag()
    else:
        ph.ph_pic_output_flag = 1
    if pps.pps_rpl_info_in_ph_flag:
        ph.ph_ref_pic_lists = read_ref_pic_lists(r, sps, pps)
    if sps.sps_partition_constraints_override_enabled_flag:
        ph.ph_partition_constraints_override_flag = r.flag()
    ctb_log2_size_y = sps.sps_log2_ctu_size_minus5 + 5
    min_cb_log2 = sps.sps_log2_min_luma_coding_block_size_minus2 + 2
    if ph.ph_intra_slice_allowed_flag:
        if ph.ph_partition_constraints_override_flag:
            ph.ph_log2_diff_min_qt_min_cb_intra_slice_luma = r.ue()
            ph.ph_max_mtt_hierarchy_depth_intra_slice_luma = r.ue()
            if ph.ph_max_mtt_hierarchy_depth_intra_slice_luma != 0:
                ph.ph_log2_diff_max_bt_min_qt_intra_slice_luma = r.ue()
                ph.ph_log2_diff_max_tt_min_qt_intra_slice_luma = r.ue()
            else:
                ph.ph_log2_diff_max_bt_min_qt_intra_slice_luma = \
                    sps.sps_log2_diff_max_bt_min_qt_intra_slice_luma
                ph.ph_log2_diff_max_tt_min_qt_intra_slice_luma = \
                    sps.sps_log2_diff_max_tt_min_qt_intra_slice_luma
            if sps.sps_qtbtt_dual_tree_intra_flag:
                ph.ph_log2_diff_min_qt_min_cb_intra_slice_chroma = r.ue()
                ph.ph_max_mtt_hierarchy_depth_intra_slice_chroma = r.ue()
                if sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma != 0:
                    ph.ph_log2_diff_max_bt_min_qt_intra_slice_chroma = r.ue()
                    ph.ph_log2_diff_max_tt_min_qt_intra_slice_chroma = r.ue()
                else:
                    ph.ph_log2_diff_max_bt_min_qt_intra_slice_chroma = \
                        sps.sps_log2_diff_max_bt_min_qt_intra_slice_chroma
                    ph.ph_log2_diff_max_tt_min_qt_intra_slice_chroma = \
                        sps.sps_log2_diff_max_tt_min_qt_intra_slice_chroma
        else:
            ph.ph_log2_diff_min_qt_min_cb_intra_slice_luma = \
                sps.sps_log2_diff_min_qt_min_cb_intra_slice_luma
            ph.ph_max_mtt_hierarchy_depth_intra_slice_luma = \
                sps.sps_max_mtt_hierarchy_depth_intra_slice_luma
            ph.ph_log2_diff_max_bt_min_qt_intra_slice_luma = \
                sps.sps_log2_diff_max_bt_min_qt_intra_slice_luma
            ph.ph_log2_diff_max_tt_min_qt_intra_slice_luma = \
                sps.sps_log2_diff_max_tt_min_qt_intra_slice_luma
            ph.ph_log2_diff_min_qt_min_cb_intra_slice_chroma = \
                sps.sps_log2_diff_min_qt_min_cb_intra_slice_chroma
            ph.ph_max_mtt_hierarchy_depth_intra_slice_chroma = \
                sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma
            ph.ph_log2_diff_max_bt_min_qt_intra_slice_chroma = \
                sps.sps_log2_diff_max_bt_min_qt_intra_slice_chroma
            ph.ph_log2_diff_max_tt_min_qt_intra_slice_chroma = \
                sps.sps_log2_diff_max_tt_min_qt_intra_slice_chroma
        min_qt_log2_intra = ph.ph_log2_diff_min_qt_min_cb_intra_slice_luma + min_cb_log2
        if pps.pps_cu_qp_delta_enabled_flag:
            ph.ph_cu_qp_delta_subdiv_intra_slice = r.ue()
        if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
            ph.ph_cu_chroma_qp_offset_subdiv_intra_slice = r.ue()
    if ph.ph_inter_slice_allowed_flag:
        if ph.ph_partition_constraints_override_flag:
            ph.ph_log2_diff_min_qt_min_cb_inter_slice = r.ue()
            ph.ph_max_mtt_hierarchy_depth_inter_slice = r.ue()
            if ph.ph_max_mtt_hierarchy_depth_inter_slice != 0:
                ph.ph_log2_diff_max_bt_min_qt_inter_slice = r.ue()
                ph.ph_log2_diff_max_tt_min_qt_inter_slice = r.ue()
        else:
            ph.ph_log2_diff_min_qt_min_cb_inter_slice = \
                sps.sps_log2_diff_min_qt_min_cb_inter_slice
            ph.ph_max_mtt_hierarchy_depth_inter_slice = \
                sps.sps_max_mtt_hierarchy_depth_inter_slice
            ph.ph_log2_diff_max_bt_min_qt_inter_slice = \
                sps.sps_log2_diff_max_bt_min_qt_inter_slice
            ph.ph_log2_diff_max_tt_min_qt_inter_slice = \
                sps.sps_log2_diff_max_tt_min_qt_inter_slice
        if pps.pps_cu_qp_delta_enabled_flag:
            ph.ph_cu_qp_delta_subdiv_inter_slice = r.ue()
        if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
            ph.ph_cu_chroma_qp_offset_subdiv_inter_slice = r.ue()
        if sps.sps_temporal_mvp_enabled_flag:
            ph.ph_temporal_mvp_enabled_flag = r.flag()
            if ph.ph_temporal_mvp_enabled_flag and pps.pps_rpl_info_in_ph_flag:
                if ph.ph_ref_pic_lists.rpl_ref_list[1].num_ref_entries > 0:
                    ph.ph_collocated_from_l0_flag = r.flag()
                else:
                    ph.ph_collocated_from_l0_flag = 1
                idx = 0 if ph.ph_collocated_from_l0_flag else 1
                if ph.ph_ref_pic_lists.rpl_ref_list[idx].num_ref_entries > 1:
                    ph.ph_collocated_ref_idx = r.ue()
        if sps.sps_mmvd_fullpel_only_enabled_flag:
            ph.ph_mmvd_fullpel_only_flag = r.flag()
        presence = (not pps.pps_rpl_info_in_ph_flag) or \
            ph.ph_ref_pic_lists.rpl_ref_list[1].num_ref_entries > 0
        if presence:
            ph.ph_mvd_l1_zero_flag = r.flag()
            if sps.sps_bdof_control_present_in_ph_flag:
                ph.ph_bdof_disabled_flag = r.flag()
            else:
                ph.ph_bdof_disabled_flag = 1 - sps.sps_bdof_enabled_flag
            if sps.sps_dmvr_control_present_in_ph_flag:
                ph.ph_dmvr_disabled_flag = r.flag()
            else:
                ph.ph_dmvr_disabled_flag = 1 - sps.sps_dmvr_enabled_flag
        else:
            ph.ph_mvd_l1_zero_flag = 1
            ph.ph_bdof_disabled_flag = 1 if sps.sps_bdof_control_present_in_ph_flag \
                else 1 - sps.sps_bdof_enabled_flag
            ph.ph_dmvr_disabled_flag = 1 if sps.sps_dmvr_control_present_in_ph_flag \
                else 1 - sps.sps_dmvr_enabled_flag
        if sps.sps_prof_control_present_in_ph_flag:
            ph.ph_prof_disabled_flag = r.flag()
        else:
            ph.ph_prof_disabled_flag = 0 if sps.sps_affine_prof_enabled_flag else 1
        if (pps.pps_weighted_pred_flag or pps.pps_weighted_bipred_flag) and \
                pps.pps_wp_info_in_ph_flag:
            ph.ph_pred_weight_table = read_pred_weight_table(
                r, sps, pps, ph.ph_ref_pic_lists, [0, 0])
    else:
        ph.ph_bdof_disabled_flag = 1 if sps.sps_bdof_control_present_in_ph_flag \
            else 1 - sps.sps_bdof_enabled_flag
        ph.ph_dmvr_disabled_flag = 1 if sps.sps_dmvr_control_present_in_ph_flag \
            else 1 - sps.sps_dmvr_enabled_flag
        ph.ph_prof_disabled_flag = 0 if sps.sps_affine_prof_enabled_flag else 1
    if pps.pps_qp_delta_info_in_ph_flag:
        ph.ph_qp_delta = r.se()
    if sps.sps_joint_cbcr_enabled_flag:
        ph.ph_joint_cbcr_sign_flag = r.flag()
    if sps.sps_sao_enabled_flag and pps.pps_sao_info_in_ph_flag:
        ph.ph_sao_luma_enabled_flag = r.flag()
        if sps.sps_chroma_format_idc != 0:
            ph.ph_sao_chroma_enabled_flag = r.flag()
    if pps.pps_dbf_info_in_ph_flag:
        ph.ph_deblocking_params_present_flag = r.flag()
    if ph.ph_deblocking_params_present_flag:
        if not pps.pps_deblocking_filter_disabled_flag:
            ph.ph_deblocking_filter_disabled_flag = r.flag()
            if not ph.ph_deblocking_filter_disabled_flag:
                ph.ph_luma_beta_offset_div2 = r.se()
                ph.ph_luma_tc_offset_div2 = r.se()
                if pps.pps_chroma_tool_offsets_present_flag:
                    ph.ph_cb_beta_offset_div2 = r.se()
                    ph.ph_cb_tc_offset_div2 = r.se()
                    ph.ph_cr_beta_offset_div2 = r.se()
                    ph.ph_cr_tc_offset_div2 = r.se()
                else:
                    ph.ph_cb_beta_offset_div2 = ph.ph_luma_beta_offset_div2
                    ph.ph_cb_tc_offset_div2 = ph.ph_luma_tc_offset_div2
                    ph.ph_cr_beta_offset_div2 = ph.ph_luma_beta_offset_div2
                    ph.ph_cr_tc_offset_div2 = ph.ph_luma_tc_offset_div2
    else:
        ph.ph_deblocking_filter_disabled_flag = pps.pps_deblocking_filter_disabled_flag
        if not ph.ph_deblocking_filter_disabled_flag:
            ph.ph_luma_beta_offset_div2 = pps.pps_luma_beta_offset_div2
            ph.ph_luma_tc_offset_div2 = pps.pps_luma_tc_offset_div2
            ph.ph_cb_beta_offset_div2 = pps.pps_cb_beta_offset_div2
            ph.ph_cb_tc_offset_div2 = pps.pps_cb_tc_offset_div2
            ph.ph_cr_beta_offset_div2 = pps.pps_cr_beta_offset_div2
            ph.ph_cr_tc_offset_div2 = pps.pps_cr_tc_offset_div2
    if pps.pps_picture_header_extension_present_flag:
        ext_len = r.ue()
        for _ in range(ext_len):
            r.u(8)
    return ph


# ---------------------------------------------------------------------------
# Slice header
# ---------------------------------------------------------------------------

def read_slice_header(r: BitReader, ps: "H266ParamSets", nal_unit_type: int) -> SyntaxObj:
    """H.266 7.3.7 slice_header; reference cbs template :3011-3428.

    After this returns, r.pos is at the first bit of slice_data().
    """
    sh = SyntaxObj()
    sh.nal_unit_type = nal_unit_type
    sh.sh_picture_header_in_slice_header_flag = r.flag()
    if sh.sh_picture_header_in_slice_header_flag:
        sh.sh_picture_header = read_picture_header(r, ps)
        ph = sh.sh_picture_header
    else:
        ph = ps.ph
        if ph is None:
            raise H266SyntaxError("Picture header not available")
    sh.ph = ph
    pps = ps.pps[ph.ph_pic_parameter_set_id]
    sps = ps.sps[pps.pps_seq_parameter_set_id]
    sh.curr_subpic_idx = 0
    if sps.sps_subpic_info_present_flag:
        sh.sh_subpic_id = r.u(sps.sps_subpic_id_len_minus1 + 1)
        found = False
        for i in range(sps.sps_num_subpics_minus1 + 1):
            if pps.sub_pic_id_val[i] == sh.sh_subpic_id:
                sh.curr_subpic_idx = i
                found = True
                break
        if not found:
            raise H266SyntaxError("invalid subpic id")
    num_slices_in_subpic = pps.num_slices_in_subpic[sh.curr_subpic_idx]
    if (pps.pps_rect_slice_flag and num_slices_in_subpic > 1) or \
            (not pps.pps_rect_slice_flag and pps.num_tiles_in_pic > 1):
        if not pps.pps_rect_slice_flag:
            bits = ceil_log2(pps.num_tiles_in_pic)
        else:
            bits = ceil_log2(num_slices_in_subpic)
        sh.sh_slice_address = r.u(bits)
    for i in range(sps.sps_num_extra_sh_bytes * 8):
        if sps.sps_extra_sh_bit_present_flag[i]:
            r.u(1)
    if not pps.pps_rect_slice_flag and \
            pps.num_tiles_in_pic - sh.sh_slice_address > 1:
        sh.sh_num_tiles_in_slice_minus1 = r.ue()
    if ph.ph_inter_slice_allowed_flag:
        sh.sh_slice_type = r.ue()
    else:
        sh.sh_slice_type = SLICE_I
    if nal_unit_type in (NalType.IDR_W_RADL, NalType.IDR_N_LP, NalType.CRA, NalType.GDR):
        sh.sh_no_output_of_prior_pics_flag = r.flag()
    sh.sh_alf_aps_id_luma = []
    if sps.sps_alf_enabled_flag:
        if not pps.pps_alf_info_in_ph_flag:
            sh.sh_alf_enabled_flag = r.flag()
            if sh.sh_alf_enabled_flag:
                sh.sh_num_alf_aps_ids_luma = r.u(3)
                sh.sh_alf_aps_id_luma = [r.u(3) for _ in range(sh.sh_num_alf_aps_ids_luma)]
                if sps.sps_chroma_format_idc != 0:
                    sh.sh_alf_cb_enabled_flag = r.flag()
                    sh.sh_alf_cr_enabled_flag = r.flag()
                if sh.sh_alf_cb_enabled_flag or sh.sh_alf_cr_enabled_flag:
                    sh.sh_alf_aps_id_chroma = r.u(3)
                if sps.sps_ccalf_enabled_flag:
                    sh.sh_alf_cc_cb_enabled_flag = r.flag()
                    if sh.sh_alf_cc_cb_enabled_flag:
                        sh.sh_alf_cc_cb_aps_id = r.u(3)
                    sh.sh_alf_cc_cr_enabled_flag = r.flag()
                    if sh.sh_alf_cc_cr_enabled_flag:
                        sh.sh_alf_cc_cr_aps_id = r.u(3)
        else:
            sh.sh_alf_enabled_flag = ph.ph_alf_enabled_flag
            if sh.sh_alf_enabled_flag:
                sh.sh_num_alf_aps_ids_luma = ph.ph_num_alf_aps_ids_luma
                sh.sh_alf_aps_id_luma = list(ph.ph_alf_aps_id_luma)
                sh.sh_alf_cb_enabled_flag = ph.ph_alf_cb_enabled_flag
                sh.sh_alf_cr_enabled_flag = ph.ph_alf_cr_enabled_flag
                if sh.sh_alf_cb_enabled_flag or sh.sh_alf_cr_enabled_flag:
                    sh.sh_alf_aps_id_chroma = ph.ph_alf_aps_id_chroma
                if sps.sps_ccalf_enabled_flag:
                    sh.sh_alf_cc_cb_enabled_flag = ph.ph_alf_cc_cb_enabled_flag
                    if sh.sh_alf_cc_cb_enabled_flag:
                        sh.sh_alf_cc_cb_aps_id = ph.ph_alf_cc_cb_aps_id
                    sh.sh_alf_cc_cr_enabled_flag = ph.ph_alf_cc_cr_enabled_flag
                    if sh.sh_alf_cc_cr_enabled_flag:
                        sh.sh_alf_cc_cr_aps_id = ph.ph_alf_cc_cr_aps_id
    if sh.sh_picture_header_in_slice_header_flag:
        sh.sh_lmcs_used_flag = ph.ph_lmcs_enabled_flag
        sh.sh_explicit_scaling_list_used_flag = ph.ph_explicit_scaling_list_enabled_flag
    else:
        if ph.ph_lmcs_enabled_flag:
            sh.sh_lmcs_used_flag = r.flag()
        if ph.ph_explicit_scaling_list_enabled_flag:
            sh.sh_explicit_scaling_list_used_flag = r.flag()
    if not pps.pps_rpl_info_in_ph_flag and \
            (nal_unit_type not in (NalType.IDR_W_RADL, NalType.IDR_N_LP)
             or sps.sps_idr_rpl_present_flag):
        sh.sh_ref_pic_lists = read_ref_pic_lists(r, sps, pps)
        ref_pic_lists = sh.sh_ref_pic_lists
    else:
        ref_pic_lists = ph.ph_ref_pic_lists
        if ref_pic_lists == 0:
            # IDR with no RPL anywhere: empty lists
            ref_pic_lists = SyntaxObj()
            empty = SyntaxObj()
            empty.num_ref_entries = 0
            empty.inter_layer_ref_pic_flag = []
            empty.st_ref_pic_flag = []
            empty.abs_delta_poc_st = []
            empty.strp_entry_sign_flag = []
            empty.rpls_poc_lsb_lt = []
            empty.ilrp_idx = []
            ref_pic_lists.rpl_ref_list = [empty, empty]
            ref_pic_lists.poc_lsb_lt = [[], []]
            ref_pic_lists.delta_poc_msb_cycle_present_flag = [[], []]
            ref_pic_lists.delta_poc_msb_cycle_lt = [[], []]
    sh.ref_pic_lists = ref_pic_lists
    sh.sh_num_ref_idx_active_minus1 = [0, 0]
    if (sh.sh_slice_type != SLICE_I and
            ref_pic_lists.rpl_ref_list[0].num_ref_entries > 1) or \
            (sh.sh_slice_type == SLICE_B and
             ref_pic_lists.rpl_ref_list[1].num_ref_entries > 1):
        sh.sh_num_ref_idx_active_override_flag = r.flag()
        if sh.sh_num_ref_idx_active_override_flag:
            for i in range(2 if sh.sh_slice_type == SLICE_B else 1):
                if ref_pic_lists.rpl_ref_list[i].num_ref_entries > 1:
                    sh.sh_num_ref_idx_active_minus1[i] = r.ue()
    else:
        sh.sh_num_ref_idx_active_override_flag = 1
    sh.num_ref_idx_active = [0, 0]
    for i in range(2):
        if sh.sh_slice_type == SLICE_B or (sh.sh_slice_type == SLICE_P and i == 0):
            if sh.sh_num_ref_idx_active_override_flag:
                sh.num_ref_idx_active[i] = sh.sh_num_ref_idx_active_minus1[i] + 1
            else:
                sh.num_ref_idx_active[i] = min(
                    ref_pic_lists.rpl_ref_list[i].num_ref_entries,
                    pps.pps_num_ref_idx_default_active_minus1[i] + 1)
    if sh.sh_slice_type != SLICE_I:
        if pps.pps_cabac_init_present_flag:
            sh.sh_cabac_init_flag = r.flag()
        if ph.ph_temporal_mvp_enabled_flag and not pps.pps_rpl_info_in_ph_flag:
            if sh.sh_slice_type == SLICE_B:
                sh.sh_collocated_from_l0_flag = r.flag()
            else:
                sh.sh_collocated_from_l0_flag = 1
            idx = 0 if sh.sh_collocated_from_l0_flag else 1
            if sh.num_ref_idx_active[idx] > 1:
                sh.sh_collocated_ref_idx = r.ue()
        elif ph.ph_temporal_mvp_enabled_flag:
            sh.sh_collocated_from_l0_flag = ph.ph_collocated_from_l0_flag
            sh.sh_collocated_ref_idx = ph.ph_collocated_ref_idx
        if not pps.pps_wp_info_in_ph_flag and \
                ((pps.pps_weighted_pred_flag and sh.sh_slice_type == SLICE_P) or
                 (pps.pps_weighted_bipred_flag and sh.sh_slice_type == SLICE_B)):
            sh.sh_pred_weight_table = read_pred_weight_table(
                r, sps, pps, ref_pic_lists, sh.num_ref_idx_active)
    if not pps.pps_qp_delta_info_in_ph_flag:
        sh.sh_qp_delta = r.se()
    if pps.pps_slice_chroma_qp_offsets_present_flag:
        sh.sh_cb_qp_offset = r.se()
        sh.sh_cr_qp_offset = r.se()
        if sps.sps_joint_cbcr_enabled_flag:
            sh.sh_joint_cbcr_qp_offset = r.se()
    if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
        sh.sh_cu_chroma_qp_offset_enabled_flag = r.flag()
    if sps.sps_sao_enabled_flag and not pps.pps_sao_info_in_ph_flag:
        sh.sh_sao_luma_used_flag = r.flag()
        if sps.sps_chroma_format_idc != 0:
            sh.sh_sao_chroma_used_flag = r.flag()
        else:
            sh.sh_sao_chroma_used_flag = ph.ph_sao_chroma_enabled_flag
    else:
        sh.sh_sao_luma_used_flag = ph.ph_sao_luma_enabled_flag
        sh.sh_sao_chroma_used_flag = ph.ph_sao_chroma_enabled_flag
    if pps.pps_deblocking_filter_override_enabled_flag and \
            not pps.pps_dbf_info_in_ph_flag:
        sh.sh_deblocking_params_present_flag = r.flag()
    if sh.sh_deblocking_params_present_flag:
        if not pps.pps_deblocking_filter_disabled_flag:
            sh.sh_deblocking_filter_disabled_flag = r.flag()
        if not sh.sh_deblocking_filter_disabled_flag:
            sh.sh_luma_beta_offset_div2 = r.se()
            sh.sh_luma_tc_offset_div2 = r.se()
            if pps.pps_chroma_tool_offsets_present_flag:
                sh.sh_cb_beta_offset_div2 = r.se()
                sh.sh_cb_tc_offset_div2 = r.se()
                sh.sh_cr_beta_offset_div2 = r.se()
                sh.sh_cr_tc_offset_div2 = r.se()
            else:
                sh.sh_cb_beta_offset_div2 = sh.sh_luma_beta_offset_div2
                sh.sh_cb_tc_offset_div2 = sh.sh_luma_tc_offset_div2
                sh.sh_cr_beta_offset_div2 = sh.sh_luma_beta_offset_div2
                sh.sh_cr_tc_offset_div2 = sh.sh_luma_tc_offset_div2
    else:
        sh.sh_deblocking_filter_disabled_flag = ph.ph_deblocking_filter_disabled_flag
        if not sh.sh_deblocking_filter_disabled_flag:
            sh.sh_luma_beta_offset_div2 = ph.ph_luma_beta_offset_div2
            sh.sh_luma_tc_offset_div2 = ph.ph_luma_tc_offset_div2
            sh.sh_cb_beta_offset_div2 = ph.ph_cb_beta_offset_div2
            sh.sh_cb_tc_offset_div2 = ph.ph_cb_tc_offset_div2
            sh.sh_cr_beta_offset_div2 = ph.ph_cr_beta_offset_div2
            sh.sh_cr_tc_offset_div2 = ph.ph_cr_tc_offset_div2
    if sps.sps_dep_quant_enabled_flag:
        sh.sh_dep_quant_used_flag = r.flag()
    if sps.sps_sign_data_hiding_enabled_flag and not sh.sh_dep_quant_used_flag:
        sh.sh_sign_data_hiding_used_flag = r.flag()
    if sps.sps_transform_skip_enabled_flag and not sh.sh_dep_quant_used_flag \
            and not sh.sh_sign_data_hiding_used_flag:
        sh.sh_ts_residual_coding_disabled_flag = r.flag()
    if not sh.sh_ts_residual_coding_disabled_flag and \
            sps.sps_ts_residual_coding_rice_present_in_sh_flag:
        sh.sh_ts_residual_coding_rice_idx_minus1 = r.u(3)
    if sps.sps_reverse_last_sig_coeff_enabled_flag:
        sh.sh_reverse_last_sig_coeff_flag = r.flag()
    if pps.pps_slice_header_extension_present_flag:
        ext_len = r.ue()
        for _ in range(ext_len):
            r.u(8)
    # entry points (H.266 7.4.8.1 NumEntryPoints)
    sh.num_entry_points = 0
    sh.sh_entry_point_offset_minus1 = []
    if sps.sps_entry_point_offsets_present_flag:
        wpp = sps.sps_entropy_coding_sync_enabled_flag
        if pps.pps_rect_slice_flag:
            slice_idx = sh.sh_slice_address
            for i in range(sh.curr_subpic_idx):
                slice_idx += pps.num_slices_in_subpic[i]
            _, _, wt, ht, h_ctu, _ = rect_slice_geometry(sps, pps, slice_idx)
            height = h_ctu if wpp else ht
            sh.num_entry_points = wt * height
        else:
            for tile_idx in range(sh.sh_slice_address,
                                  sh.sh_slice_address + sh.sh_num_tiles_in_slice_minus1 + 1):
                tile_y = tile_idx // pps.num_tile_columns
                sh.num_entry_points += pps.row_height_val[tile_y] if wpp else 1
        sh.num_entry_points -= 1
        if sh.num_entry_points > 0:
            sh.sh_entry_offset_len_minus1 = r.ue()
            sh.sh_entry_point_offset_minus1 = [
                r.u(sh.sh_entry_offset_len_minus1 + 1)
                for _ in range(sh.num_entry_points)]
    r.byte_alignment()
    return sh


# ---------------------------------------------------------------------------
# SEI (minimal: enumerate messages; decode picture hash)
# ---------------------------------------------------------------------------

def read_sei(r: BitReader, prefix: bool):
    """sei_rbsp: returns list of (payload_type, payload bytes)."""
    messages = []
    while True:
        ptype = 0
        b = r.u(8)
        while b == 0xFF:
            ptype += 255
            b = r.u(8)
        ptype += b
        psize = 0
        b = r.u(8)
        while b == 0xFF:
            psize += 255
            b = r.u(8)
        psize += b
        payload = bytes(r.u(8) for _ in range(psize))
        messages.append((ptype, payload))
        if not r.more_rbsp_data():
            break
    return messages


def parse_dph(payload: bytes):
    """Decoded picture hash SEI (payload type 132): returns (hash_type,
    single_component_flag, [hashes per component])."""
    r = BitReader(payload)
    hash_type = r.u(8)
    single = r.flag()
    r.u(7)  # dph_sei_reserved_zero_7bits
    ncomp = 1 if single else 3
    hashes = []
    for _ in range(ncomp):
        if hash_type == 0:  # MD5
            hashes.append(bytes(r.u(8) for _ in range(16)))
        elif hash_type == 1:  # CRC
            hashes.append(r.u(16))
        elif hash_type == 2:  # checksum
            hashes.append(r.u(32))
    return hash_type, single, hashes


# ---------------------------------------------------------------------------
# Parameter-set context
# ---------------------------------------------------------------------------

class H266ParamSets:
    """Holds active raw parameter sets, mirroring CodedBitstreamH266Context."""

    def __init__(self):
        self.vps = {}
        self.sps = {}
        self.pps = {}
        self.aps_alf = {}
        self.aps_lmcs = {}
        self.aps_scaling = {}
        self.ph = None  # active picture header

    def store_sps(self, sps: SyntaxObj):
        if sps.sps_video_parameter_set_id == 0 and 0 not in self.vps:
            self.vps[0] = make_default_vps(sps.nuh_layer_id)
        self.sps[sps.sps_seq_parameter_set_id] = sps

    def store_pps(self, pps: SyntaxObj):
        self.pps[pps.pps_pic_parameter_set_id] = pps

    def store_aps(self, aps: SyntaxObj):
        d = {APS_ALF: self.aps_alf, APS_LMCS: self.aps_lmcs,
             APS_SCALING: self.aps_scaling}.get(aps.aps_params_type)
        if d is not None:
            d[aps.aps_adaptation_parameter_set_id] = aps
