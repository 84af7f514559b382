# Frozen copy of ffvvc_tpu_torch/bitstream/h266_write.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none.
"""H.266 header syntax writers (mirror of h266.py readers).

Used by the stream forge (tools/forge.py) to synthesize conformance-style
test bitstreams, and by CBS-round-trip tests (write(read(x)) == x), mirroring
the reference's cbs-vvc FATE coverage.

The writers consume the same SyntaxObj attribute bags the readers produce.
Features not exercised by the forge raise NotImplementedError loudly rather
than silently emitting a corrupt stream; coverage grows with the forge.

Remaining NotImplementedError sites are all non-decode-relevant: GCI
constraint flags, timing/HRD and VUI (informative metadata the decoder
ignores), and inter-layer refs (a behavior-parity refusal — the decoder
raises NotImplementedError on inter-layer streams just like the reference's
avpriv_report_missing_feature, see PARITY.md).  Every decode-relevant
writer is implemented and oracle-differentially tested
(tests/test_conformance.py test_ph_level_syntax / test_l11_*).
"""
from __future__ import annotations

from .writer import BitWriter
from .h266 import (SyntaxObj, ceil_log2, APS_ALF, APS_LMCS, APS_SCALING,
                   SLICE_I, SLICE_B, SLICE_P, diag_scan_order, rect_slice_geometry)
from .nal import NalType


def write_ptl(w: BitWriter, ptl: SyntaxObj, profile_tier_present: bool,
              max_num_sub_layers_minus1: int):
    if profile_tier_present:
        w.u(ptl.general_profile_idc, 7)
        w.u(ptl.general_tier_flag, 1)
    w.u(ptl.general_level_idc, 8)
    w.flag(ptl.ptl_frame_only_constraint_flag)
    w.flag(ptl.ptl_multilayer_enabled_flag)
    if profile_tier_present:
        gci = ptl.general_constraints_info
        w.flag(gci.gci_present_flag if gci else 0)
        if gci and gci.gci_present_flag:
            raise NotImplementedError("GCI write")
        w.byte_alignment_pad()
    for i in range(max_num_sub_layers_minus1 - 1, -1, -1):
        w.flag(ptl.ptl_sublayer_level_present_flag[i])
    w.byte_alignment_pad()
    for i in range(max_num_sub_layers_minus1 - 1, -1, -1):
        if ptl.ptl_sublayer_level_present_flag[i]:
            w.u(ptl.sublayer_level_idc[i], 8)
    if profile_tier_present:
        w.u(ptl.ptl_num_sub_profiles, 8)
        for v in (ptl.general_sub_profile_idc or []):
            w.u(v, 32)


def _pad(self: BitWriter):
    while not self.byte_aligned():
        self.u(0, 1)


BitWriter.byte_alignment_pad = _pad


def write_dpb_parameters(w: BitWriter, dpb: SyntaxObj, max_sublayers_minus1: int,
                         sublayer_info_flag: bool):
    start = 0 if sublayer_info_flag else max_sublayers_minus1
    for i in range(start, max_sublayers_minus1 + 1):
        w.ue(dpb.dpb_max_dec_pic_buffering_minus1[i])
        w.ue(dpb.dpb_max_num_reorder_pics[i])
        w.ue(dpb.dpb_max_latency_increase_plus1[i])


def write_ref_pic_list_struct(w: BitWriter, sps: SyntaxObj, rpl: SyntaxObj,
                              list_idx: int, rpls_idx: int):
    w.ue(rpl.num_ref_entries)
    if sps.sps_long_term_ref_pics_flag and \
            rpls_idx < sps.sps_num_ref_pic_lists[list_idx] and rpl.num_ref_entries > 0:
        w.u(rpl.ltrp_in_header_flag, 1)
    j = 0
    for i in range(rpl.num_ref_entries):
        if sps.sps_inter_layer_prediction_enabled_flag:
            w.u(rpl.inter_layer_ref_pic_flag[i], 1)
        if not rpl.inter_layer_ref_pic_flag[i]:
            if sps.sps_long_term_ref_pics_flag:
                w.u(rpl.st_ref_pic_flag[i], 1)
            if rpl.st_ref_pic_flag[i]:
                w.ue(rpl.abs_delta_poc_st[i])
                if (sps.sps_weighted_pred_flag or sps.sps_weighted_bipred_flag) and i != 0:
                    abs_delta = rpl.abs_delta_poc_st[i]
                else:
                    abs_delta = rpl.abs_delta_poc_st[i] + 1
                if abs_delta > 0:
                    w.u(rpl.strp_entry_sign_flag[i], 1)
            else:
                if not rpl.ltrp_in_header_flag:
                    bits = sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4
                    w.u(rpl.rpls_poc_lsb_lt[j], bits)
                    j += 1
        else:
            raise NotImplementedError("inter-layer ref write")



def write_pred_weight_table(w: BitWriter, sps: SyntaxObj, pps: SyntaxObj,
                            ref_lists: SyntaxObj, pwt: SyntaxObj):
    """Mirror of read_pred_weight_table (h266.py; H.266 7.3.8)."""
    w.ue(pwt.luma_log2_weight_denom)
    if sps.sps_chroma_format_idc != 0:
        w.se(pwt.delta_chroma_log2_weight_denom)
    if pps.pps_wp_info_in_ph_flag:
        w.ue(pwt.num_l0_weights)
    n0 = pwt.num_weights_l0
    for i in range(n0):
        w.u(pwt.luma_weight_l0_flag[i], 1)
    if sps.sps_chroma_format_idc != 0:
        for i in range(n0):
            w.u(pwt.chroma_weight_l0_flag[i], 1)
    for i in range(n0):
        if pwt.luma_weight_l0_flag[i]:
            w.se(pwt.delta_luma_weight_l0[i])
            w.se(pwt.luma_offset_l0[i])
        if pwt.chroma_weight_l0_flag[i]:
            for j in range(2):
                w.se(pwt.delta_chroma_weight_l0[i][j])
                w.se(pwt.delta_chroma_offset_l0[i][j])
    if pps.pps_weighted_bipred_flag and \
            ref_lists.rpl_ref_list[1].num_ref_entries > 0:
        if pps.pps_wp_info_in_ph_flag:
            w.ue(pwt.num_l1_weights)
    n1 = pwt.num_weights_l1
    for i in range(n1):
        w.u(pwt.luma_weight_l1_flag[i], 1)
    if sps.sps_chroma_format_idc != 0:
        for i in range(n1):
            w.u(pwt.chroma_weight_l1_flag[i], 1)
    for i in range(n1):
        if pwt.luma_weight_l1_flag[i]:
            w.se(pwt.delta_luma_weight_l1[i])
            w.se(pwt.luma_offset_l1[i])
        if pwt.chroma_weight_l1_flag[i]:
            for j in range(2):
                w.se(pwt.delta_chroma_weight_l1[i][j])
                w.se(pwt.delta_chroma_offset_l1[i][j])


def write_ref_pic_lists(w: BitWriter, sps: SyntaxObj, pps: SyntaxObj, rpls: SyntaxObj):
    for i in range(2):
        if sps.sps_num_ref_pic_lists[i] > 0 and \
                (i == 0 or (i == 1 and pps.pps_rpl1_idx_present_flag)):
            w.u(rpls.rpl_sps_flag[i], 1)
        if rpls.rpl_sps_flag[i]:
            if sps.sps_num_ref_pic_lists[i] > 1 and \
                    (i == 0 or (i == 1 and pps.pps_rpl1_idx_present_flag)):
                w.u(rpls.rpl_idx[i], ceil_log2(sps.sps_num_ref_pic_lists[i]))
        else:
            write_ref_pic_list_struct(w, sps, rpls.rpl_ref_list[i], i,
                                      sps.sps_num_ref_pic_lists[i])
        from .h266 import num_ltrp_entries
        ref_list = rpls.rpl_ref_list[i]
        n_lt = num_ltrp_entries(ref_list)
        for j in range(n_lt):
            if ref_list.ltrp_in_header_flag:
                w.u(rpls.poc_lsb_lt[i][j],
                    sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4)
            w.u(rpls.delta_poc_msb_cycle_present_flag[i][j], 1)
            if rpls.delta_poc_msb_cycle_present_flag[i][j]:
                w.ue(rpls.delta_poc_msb_cycle_lt[i][j])



def write_alf_data(w: BitWriter, aps: SyntaxObj):
    """Mirror of read_alf_data (H.266 7.3.2.19)."""
    w.flag(aps.alf_luma_filter_signal_flag)
    if aps.aps_chroma_present_flag:
        w.flag(aps.alf_chroma_filter_signal_flag)
        w.flag(aps.alf_cc_cb_filter_signal_flag)
        w.flag(aps.alf_cc_cr_filter_signal_flag)
    if aps.alf_luma_filter_signal_flag:
        w.flag(aps.alf_luma_clip_flag)
        w.ue(aps.alf_luma_num_filters_signalled_minus1)
        if aps.alf_luma_num_filters_signalled_minus1 > 0:
            bits = ceil_log2(aps.alf_luma_num_filters_signalled_minus1 + 1)
            for k in range(25):
                w.u(aps.alf_luma_coeff_delta_idx[k], bits)
        nf = aps.alf_luma_num_filters_signalled_minus1 + 1
        for sf in range(nf):
            for j in range(12):
                w.ue(aps.alf_luma_coeff_abs[sf][j])
                if aps.alf_luma_coeff_abs[sf][j]:
                    w.u(aps.alf_luma_coeff_sign[sf][j], 1)
        for sf in range(nf):
            for j in range(12):
                if aps.alf_luma_clip_flag:
                    w.u(aps.alf_luma_clip_idx[sf][j], 2)
    if aps.alf_chroma_filter_signal_flag:
        w.flag(aps.alf_chroma_clip_flag)
        w.ue(aps.alf_chroma_num_alt_filters_minus1)
        na = aps.alf_chroma_num_alt_filters_minus1 + 1
        for alt in range(na):
            for j in range(6):
                w.ue(aps.alf_chroma_coeff_abs[alt][j])
                if aps.alf_chroma_coeff_abs[alt][j] > 0:
                    w.u(aps.alf_chroma_coeff_sign[alt][j], 1)
            for j in range(6):
                if aps.alf_chroma_clip_flag:
                    w.u(aps.alf_chroma_clip_idx[alt][j], 2)
    if aps.alf_cc_cb_filter_signal_flag:
        w.ue(aps.alf_cc_cb_filters_signalled_minus1)
        for k in range(aps.alf_cc_cb_filters_signalled_minus1 + 1):
            for j in range(7):
                w.u(aps.alf_cc_cb_mapped_coeff_abs[k][j], 3)
                if aps.alf_cc_cb_mapped_coeff_abs[k][j]:
                    w.u(aps.alf_cc_cb_coeff_sign[k][j], 1)
    if aps.alf_cc_cr_filter_signal_flag:
        w.ue(aps.alf_cc_cr_filters_signalled_minus1)
        for k in range(aps.alf_cc_cr_filters_signalled_minus1 + 1):
            for j in range(7):
                w.u(aps.alf_cc_cr_mapped_coeff_abs[k][j], 3)
                if aps.alf_cc_cr_mapped_coeff_abs[k][j]:
                    w.u(aps.alf_cc_cr_coeff_sign[k][j], 1)



def write_scaling_list_data(w: BitWriter, aps: SyntaxObj):
    """Mirror of read_scaling_list_data (H.266 7.3.2.21)."""
    from .h266 import diag_scan_order
    d8 = diag_scan_order(8)
    for sid in range(28):
        if aps.aps_chroma_present_flag or sid % 3 == 2 or sid == 27:
            w.u(aps.scaling_list_copy_mode_flag[sid], 1)
            if not aps.scaling_list_copy_mode_flag[sid]:
                w.u(aps.scaling_list_pred_mode_flag[sid], 1)
            if (aps.scaling_list_copy_mode_flag[sid] or
                    aps.scaling_list_pred_mode_flag[sid]) and \
                    sid not in (0, 2, 8):
                w.ue(aps.scaling_list_pred_id_delta[sid])
            if not aps.scaling_list_copy_mode_flag[sid]:
                matrix_size = 2 if sid < 2 else (4 if sid < 8 else 8)
                if sid > 13:
                    w.se(aps.scaling_list_dc_coef[sid - 14])
                for i in range(matrix_size * matrix_size):
                    x, y = d8[i] if matrix_size == 8 else \
                        diag_scan_order(matrix_size)[i]
                    if not (sid > 25 and x >= 4 and y >= 4):
                        w.se(aps.scaling_list_delta_coef[sid][i])


def write_aps(aps: SyntaxObj) -> bytes:
    """adaptation_parameter_set_rbsp (subset: ALF + LMCS)."""
    w = BitWriter()
    w.u(aps.aps_params_type, 3)
    w.u(aps.aps_adaptation_parameter_set_id, 5)
    w.flag(aps.aps_chroma_present_flag)
    if aps.aps_params_type == 0:
        write_alf_data(w, aps)
    elif aps.aps_params_type == 1:
        write_lmcs_data(w, aps)
    elif aps.aps_params_type == 2:
        write_scaling_list_data(w, aps)
    else:
        raise ValueError("unknown aps type")
    w.flag(aps.aps_extension_flag)
    w.rbsp_trailing_bits()
    return w.bytes()


def write_lmcs_data(w: BitWriter, aps: SyntaxObj):
    """Mirror of read_lmcs_data (H.266 7.3.2.20)."""
    w.ue(aps.lmcs_min_bin_idx)
    w.ue(aps.lmcs_delta_max_bin_idx)
    w.ue(aps.lmcs_delta_cw_prec_minus1)
    for i in range(aps.lmcs_min_bin_idx, 15 - aps.lmcs_delta_max_bin_idx + 1):
        w.u(aps.lmcs_delta_abs_cw[i], aps.lmcs_delta_cw_prec_minus1 + 1)
        if aps.lmcs_delta_abs_cw[i] > 0:
            w.u(aps.lmcs_delta_sign_cw_flag[i], 1)
    if aps.aps_chroma_present_flag:
        w.u(aps.lmcs_delta_abs_crs, 3)
        if aps.lmcs_delta_abs_crs > 0:
            w.u(aps.lmcs_delta_sign_crs_flag, 1)


def write_sps(sps: SyntaxObj) -> bytes:
    """Serialize an SPS RBSP (subset; see module docstring)."""
    w = BitWriter()
    w.u(sps.sps_seq_parameter_set_id, 4)
    w.u(sps.sps_video_parameter_set_id, 4)
    w.u(sps.sps_max_sublayers_minus1, 3)
    w.u(sps.sps_chroma_format_idc, 2)
    w.u(sps.sps_log2_ctu_size_minus5, 2)
    ctb_size_y = 1 << (sps.sps_log2_ctu_size_minus5 + 5)
    w.flag(sps.sps_ptl_dpb_hrd_params_present_flag)
    if sps.sps_ptl_dpb_hrd_params_present_flag:
        write_ptl(w, sps.profile_tier_level, True, sps.sps_max_sublayers_minus1)
    w.flag(sps.sps_gdr_enabled_flag)
    w.flag(sps.sps_ref_pic_resampling_enabled_flag)
    if sps.sps_ref_pic_resampling_enabled_flag:
        w.flag(sps.sps_res_change_in_clvs_allowed_flag)
    w.ue(sps.sps_pic_width_max_in_luma_samples)
    w.ue(sps.sps_pic_height_max_in_luma_samples)
    w.flag(sps.sps_conformance_window_flag)
    if sps.sps_conformance_window_flag:
        w.ue(sps.sps_conf_win_left_offset)
        w.ue(sps.sps_conf_win_right_offset)
        w.ue(sps.sps_conf_win_top_offset)
        w.ue(sps.sps_conf_win_bottom_offset)
    w.flag(sps.sps_subpic_info_present_flag)
    if sps.sps_subpic_info_present_flag:
        tmp_w = -(-sps.sps_pic_width_max_in_luma_samples // ctb_size_y)
        tmp_h = -(-sps.sps_pic_height_max_in_luma_samples // ctb_size_y)
        ns = sps.sps_num_subpics_minus1
        w.ue(ns)
        if ns > 0:
            w.flag(sps.sps_independent_subpics_flag)
            w.flag(sps.sps_subpic_same_size_flag)
            wlen = ceil_log2(tmp_w)
            hlen = ceil_log2(tmp_h)
            if sps.sps_pic_width_max_in_luma_samples > ctb_size_y:
                w.u(sps.sps_subpic_width_minus1[0], wlen)
            if sps.sps_pic_height_max_in_luma_samples > ctb_size_y:
                w.u(sps.sps_subpic_height_minus1[0], hlen)
            if not sps.sps_independent_subpics_flag:
                w.u(sps.sps_subpic_treated_as_pic_flag[0], 1)
                w.u(sps.sps_loop_filter_across_subpic_enabled_flag[0], 1)
            for i in range(1, ns + 1):
                if not sps.sps_subpic_same_size_flag:
                    if sps.sps_pic_width_max_in_luma_samples > ctb_size_y:
                        w.u(sps.sps_subpic_ctu_top_left_x[i], wlen)
                    if sps.sps_pic_height_max_in_luma_samples > ctb_size_y:
                        w.u(sps.sps_subpic_ctu_top_left_y[i], hlen)
                    if i < ns and sps.sps_pic_width_max_in_luma_samples > ctb_size_y:
                        w.u(sps.sps_subpic_width_minus1[i], wlen)
                    if i < ns and sps.sps_pic_height_max_in_luma_samples > ctb_size_y:
                        w.u(sps.sps_subpic_height_minus1[i], hlen)
                if not sps.sps_independent_subpics_flag:
                    w.u(sps.sps_subpic_treated_as_pic_flag[i], 1)
                    w.u(sps.sps_loop_filter_across_subpic_enabled_flag[i], 1)
            w.ue(sps.sps_subpic_id_len_minus1)
            w.flag(sps.sps_subpic_id_mapping_explicitly_signalled_flag)
            if sps.sps_subpic_id_mapping_explicitly_signalled_flag:
                w.flag(sps.sps_subpic_id_mapping_present_flag)
                if sps.sps_subpic_id_mapping_present_flag:
                    for i in range(ns + 1):
                        w.u(sps.sps_subpic_id[i],
                            sps.sps_subpic_id_len_minus1 + 1)
    w.ue(sps.sps_bitdepth_minus8)
    w.flag(sps.sps_entropy_coding_sync_enabled_flag)
    w.flag(sps.sps_entry_point_offsets_present_flag)
    w.u(sps.sps_log2_max_pic_order_cnt_lsb_minus4, 4)
    w.flag(sps.sps_poc_msb_cycle_flag)
    if sps.sps_poc_msb_cycle_flag:
        w.ue(sps.sps_poc_msb_cycle_len_minus1)
    w.u(sps.sps_num_extra_ph_bytes, 2)
    for i in range(sps.sps_num_extra_ph_bytes * 8):
        w.u(sps.sps_extra_ph_bit_present_flag[i], 1)
    w.u(sps.sps_num_extra_sh_bytes, 2)
    for i in range(sps.sps_num_extra_sh_bytes * 8):
        w.u(sps.sps_extra_sh_bit_present_flag[i], 1)
    if sps.sps_ptl_dpb_hrd_params_present_flag:
        if sps.sps_max_sublayers_minus1 > 0:
            w.flag(sps.sps_sublayer_dpb_params_flag)
        write_dpb_parameters(w, sps.sps_dpb_params, sps.sps_max_sublayers_minus1,
                             bool(sps.sps_sublayer_dpb_params_flag))
    w.ue(sps.sps_log2_min_luma_coding_block_size_minus2)
    w.flag(sps.sps_partition_constraints_override_enabled_flag)
    w.ue(sps.sps_log2_diff_min_qt_min_cb_intra_slice_luma)
    w.ue(sps.sps_max_mtt_hierarchy_depth_intra_slice_luma)
    if sps.sps_max_mtt_hierarchy_depth_intra_slice_luma != 0:
        w.ue(sps.sps_log2_diff_max_bt_min_qt_intra_slice_luma)
        w.ue(sps.sps_log2_diff_max_tt_min_qt_intra_slice_luma)
    if sps.sps_chroma_format_idc != 0:
        w.flag(sps.sps_qtbtt_dual_tree_intra_flag)
    if sps.sps_qtbtt_dual_tree_intra_flag:
        w.ue(sps.sps_log2_diff_min_qt_min_cb_intra_slice_chroma)
        w.ue(sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma)
        if sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma != 0:
            w.ue(sps.sps_log2_diff_max_bt_min_qt_intra_slice_chroma)
            w.ue(sps.sps_log2_diff_max_tt_min_qt_intra_slice_chroma)
    w.ue(sps.sps_log2_diff_min_qt_min_cb_inter_slice)
    w.ue(sps.sps_max_mtt_hierarchy_depth_inter_slice)
    if sps.sps_max_mtt_hierarchy_depth_inter_slice != 0:
        w.ue(sps.sps_log2_diff_max_bt_min_qt_inter_slice)
        w.ue(sps.sps_log2_diff_max_tt_min_qt_inter_slice)
    if ctb_size_y > 32:
        w.flag(sps.sps_max_luma_transform_size_64_flag)
    w.flag(sps.sps_transform_skip_enabled_flag)
    if sps.sps_transform_skip_enabled_flag:
        w.ue(sps.sps_log2_transform_skip_max_size_minus2)
        w.flag(sps.sps_bdpcm_enabled_flag)
    w.flag(sps.sps_mts_enabled_flag)
    if sps.sps_mts_enabled_flag:
        w.flag(sps.sps_explicit_mts_intra_enabled_flag)
        w.flag(sps.sps_explicit_mts_inter_enabled_flag)
    w.flag(sps.sps_lfnst_enabled_flag)
    if sps.sps_chroma_format_idc != 0:
        w.flag(sps.sps_joint_cbcr_enabled_flag)
        w.flag(sps.sps_same_qp_table_for_chroma_flag)
        num_qp_tables = 1 if sps.sps_same_qp_table_for_chroma_flag else \
            (3 if sps.sps_joint_cbcr_enabled_flag else 2)
        for i in range(num_qp_tables):
            w.se(sps.sps_qp_table_start_minus26[i])
            w.ue(sps.sps_num_points_in_qp_table_minus1[i])
            for j in range(sps.sps_num_points_in_qp_table_minus1[i] + 1):
                w.ue(sps.sps_delta_qp_in_val_minus1[i][j])
                w.ue(sps.sps_delta_qp_diff_val[i][j])
    w.flag(sps.sps_sao_enabled_flag)
    w.flag(sps.sps_alf_enabled_flag)
    if sps.sps_alf_enabled_flag and sps.sps_chroma_format_idc:
        w.flag(sps.sps_ccalf_enabled_flag)
    w.flag(sps.sps_lmcs_enabled_flag)
    w.flag(sps.sps_weighted_pred_flag)
    w.flag(sps.sps_weighted_bipred_flag)
    w.flag(sps.sps_long_term_ref_pics_flag)
    if sps.sps_video_parameter_set_id > 0:
        w.flag(sps.sps_inter_layer_prediction_enabled_flag)
    w.flag(sps.sps_idr_rpl_present_flag)
    w.flag(sps.sps_rpl1_same_as_rpl0_flag)
    for i in range(1 if sps.sps_rpl1_same_as_rpl0_flag else 2):
        w.ue(sps.sps_num_ref_pic_lists[i])
        for j in range(sps.sps_num_ref_pic_lists[i]):
            write_ref_pic_list_struct(w, sps, sps.sps_ref_pic_list_struct[i][j], i, j)
    w.flag(sps.sps_ref_wraparound_enabled_flag)
    w.flag(sps.sps_temporal_mvp_enabled_flag)
    if sps.sps_temporal_mvp_enabled_flag:
        w.flag(sps.sps_sbtmvp_enabled_flag)
    w.flag(sps.sps_amvr_enabled_flag)
    w.flag(sps.sps_bdof_enabled_flag)
    if sps.sps_bdof_enabled_flag:
        w.flag(sps.sps_bdof_control_present_in_ph_flag)
    w.flag(sps.sps_smvd_enabled_flag)
    w.flag(sps.sps_dmvr_enabled_flag)
    if sps.sps_dmvr_enabled_flag:
        w.flag(sps.sps_dmvr_control_present_in_ph_flag)
    w.flag(sps.sps_mmvd_enabled_flag)
    if sps.sps_mmvd_enabled_flag:
        w.flag(sps.sps_mmvd_fullpel_only_enabled_flag)
    w.ue(sps.sps_six_minus_max_num_merge_cand)
    max_num_merge_cand = 6 - sps.sps_six_minus_max_num_merge_cand
    w.flag(sps.sps_sbt_enabled_flag)
    w.flag(sps.sps_affine_enabled_flag)
    if sps.sps_affine_enabled_flag:
        w.ue(sps.sps_five_minus_max_num_subblock_merge_cand)
        w.flag(sps.sps_6param_affine_enabled_flag)
        if sps.sps_amvr_enabled_flag:
            w.flag(sps.sps_affine_amvr_enabled_flag)
        w.flag(sps.sps_affine_prof_enabled_flag)
        if sps.sps_affine_prof_enabled_flag:
            w.flag(sps.sps_prof_control_present_in_ph_flag)
    w.flag(sps.sps_bcw_enabled_flag)
    w.flag(sps.sps_ciip_enabled_flag)
    if max_num_merge_cand >= 2:
        w.flag(sps.sps_gpm_enabled_flag)
        if sps.sps_gpm_enabled_flag and max_num_merge_cand >= 3:
            w.ue(sps.sps_max_num_merge_cand_minus_max_num_gpm_cand)
    w.ue(sps.sps_log2_parallel_merge_level_minus2)
    w.flag(sps.sps_isp_enabled_flag)
    w.flag(sps.sps_mrl_enabled_flag)
    w.flag(sps.sps_mip_enabled_flag)
    if sps.sps_chroma_format_idc != 0:
        w.flag(sps.sps_cclm_enabled_flag)
    if sps.sps_chroma_format_idc == 1:
        w.flag(sps.sps_chroma_horizontal_collocated_flag)
        w.flag(sps.sps_chroma_vertical_collocated_flag)
    w.flag(sps.sps_palette_enabled_flag)
    if sps.sps_chroma_format_idc == 3 and not sps.sps_max_luma_transform_size_64_flag:
        w.flag(sps.sps_act_enabled_flag)
    if sps.sps_transform_skip_enabled_flag or sps.sps_palette_enabled_flag:
        w.ue(sps.sps_min_qp_prime_ts)
    w.flag(sps.sps_ibc_enabled_flag)
    if sps.sps_ibc_enabled_flag:
        w.ue(sps.sps_six_minus_max_num_ibc_merge_cand)
    w.flag(sps.sps_ladf_enabled_flag)
    if sps.sps_ladf_enabled_flag:
        w.u(sps.sps_num_ladf_intervals_minus2, 2)
        w.se(sps.sps_ladf_lowest_interval_qp_offset)
        for i in range(sps.sps_num_ladf_intervals_minus2 + 1):
            w.se(sps.sps_ladf_qp_offset[i])
            w.ue(sps.sps_ladf_delta_threshold_minus1[i])
    w.flag(sps.sps_explicit_scaling_list_enabled_flag)
    if sps.sps_lfnst_enabled_flag and sps.sps_explicit_scaling_list_enabled_flag:
        w.flag(sps.sps_scaling_matrix_for_lfnst_disabled_flag)
    if sps.sps_act_enabled_flag and sps.sps_explicit_scaling_list_enabled_flag:
        w.flag(sps.sps_scaling_matrix_for_alternative_colour_space_disabled_flag)
    if sps.sps_scaling_matrix_for_alternative_colour_space_disabled_flag:
        w.flag(sps.sps_scaling_matrix_designated_colour_space_flag)
    w.flag(sps.sps_dep_quant_enabled_flag)
    w.flag(sps.sps_sign_data_hiding_enabled_flag)
    w.flag(sps.sps_virtual_boundaries_enabled_flag)
    if sps.sps_virtual_boundaries_enabled_flag:
        w.flag(sps.sps_virtual_boundaries_present_flag)
        if sps.sps_virtual_boundaries_present_flag:
            w.ue(sps.sps_num_ver_virtual_boundaries)
            for v in sps.sps_virtual_boundary_pos_x_minus1:
                w.ue(v)
            w.ue(sps.sps_num_hor_virtual_boundaries)
            for v in sps.sps_virtual_boundary_pos_y_minus1:
                w.ue(v)
    if sps.sps_ptl_dpb_hrd_params_present_flag:
        w.flag(sps.sps_timing_hrd_params_present_flag)
        if sps.sps_timing_hrd_params_present_flag:
            raise NotImplementedError("timing/HRD write")
    w.flag(sps.sps_field_seq_flag)
    w.flag(sps.sps_vui_parameters_present_flag)
    if sps.sps_vui_parameters_present_flag:
        raise NotImplementedError("VUI write")
    w.flag(sps.sps_extension_flag)
    if sps.sps_extension_flag:
        w.flag(sps.sps_range_extension_flag)
        w.u(sps.sps_extension_7bits, 7)
        if sps.sps_range_extension_flag:
            w.flag(sps.sps_extended_precision_flag)
            if sps.sps_transform_skip_enabled_flag:
                w.flag(sps.sps_ts_residual_coding_rice_present_in_sh_flag)
            w.flag(sps.sps_rrc_rice_extension_flag)
            w.flag(sps.sps_persistent_rice_adaptation_enabled_flag)
            w.flag(sps.sps_reverse_last_sig_coeff_enabled_flag)
    w.rbsp_trailing_bits()
    return w.bytes()


def write_pps(pps: SyntaxObj, sps: SyntaxObj) -> bytes:
    w = BitWriter()
    w.u(pps.pps_pic_parameter_set_id, 6)
    w.u(pps.pps_seq_parameter_set_id, 4)
    w.flag(pps.pps_mixed_nalu_types_in_pic_flag)
    w.ue(pps.pps_pic_width_in_luma_samples)
    w.ue(pps.pps_pic_height_in_luma_samples)
    w.flag(pps.pps_conformance_window_flag)
    if pps.pps_conformance_window_flag:
        w.ue(pps.pps_conf_win_left_offset)
        w.ue(pps.pps_conf_win_right_offset)
        w.ue(pps.pps_conf_win_top_offset)
        w.ue(pps.pps_conf_win_bottom_offset)
    w.flag(pps.pps_scaling_window_explicit_signalling_flag)
    if pps.pps_scaling_window_explicit_signalling_flag:
        w.se(pps.pps_scaling_win_left_offset)
        w.se(pps.pps_scaling_win_right_offset)
        w.se(pps.pps_scaling_win_top_offset)
        w.se(pps.pps_scaling_win_bottom_offset)
    w.flag(pps.pps_output_flag_present_flag)
    w.flag(pps.pps_no_pic_partition_flag)
    w.flag(pps.pps_subpic_id_mapping_present_flag)
    if pps.pps_subpic_id_mapping_present_flag:
        # conformance requires pps_subpic_id_len == sps_subpic_id_len (7.4.3.4)
        if not pps.pps_no_pic_partition_flag:
            w.ue(pps.pps_num_subpics_minus1)
        w.ue(pps.pps_subpic_id_len_minus1)
        for i in range(pps.pps_num_subpics_minus1 + 1):
            w.u(pps.pps_subpic_id[i], pps.pps_subpic_id_len_minus1 + 1)
    if not pps.pps_no_pic_partition_flag:
        w.u(pps.pps_log2_ctu_size_minus5, 2)
        w.ue(pps.pps_num_exp_tile_columns_minus1)
        w.ue(pps.pps_num_exp_tile_rows_minus1)
        for v in pps.pps_tile_column_width_minus1:
            w.ue(v)
        for v in pps.pps_tile_row_height_minus1:
            w.ue(v)
        if pps.num_tiles_in_pic > 1:
            w.flag(pps.pps_loop_filter_across_tiles_enabled_flag)
            w.flag(pps.pps_rect_slice_flag)
        if pps.pps_rect_slice_flag:
            w.flag(pps.pps_single_slice_per_subpic_flag)
        if pps.pps_rect_slice_flag and not pps.pps_single_slice_per_subpic_flag:
            w.ue(pps.pps_num_slices_in_pic_minus1)
            if pps.pps_num_slices_in_pic_minus1 > 1:
                w.flag(pps.pps_tile_idx_delta_present_flag)
            if pps.pps_num_slices_in_pic_minus1 > 0:
                # mirrors the reader's slice-map walk (h266.py:984-1060)
                tile_idx = 0
                i = 0
                while i < pps.pps_num_slices_in_pic_minus1:
                    tile_x = tile_idx % pps.num_tile_columns
                    tile_y = tile_idx // pps.num_tile_columns
                    if tile_x != pps.num_tile_columns - 1:
                        w.ue(pps.pps_slice_width_in_tiles_minus1[i])
                    if tile_y != pps.num_tile_rows - 1 and \
                            (pps.pps_tile_idx_delta_present_flag or tile_x == 0):
                        w.ue(pps.pps_slice_height_in_tiles_minus1[i])
                    if pps.pps_slice_width_in_tiles_minus1[i] == 0 and \
                            pps.pps_slice_height_in_tiles_minus1[i] == 0 and \
                            pps.row_height_val[tile_y] > 1:
                        # tile split into slices: explicit CTU-row heights
                        # then uniform fill (pps_exp_slice_height_in_ctus_
                        # minus1[i] = list of exp heights-1 for slice i's
                        # tile; reader h266.py:1008-1040)
                        exp = pps.pps_exp_slice_height_in_ctus_minus1[i] \
                            if pps.pps_exp_slice_height_in_ctus_minus1 \
                            else []
                        w.ue(len(exp))
                        remaining_h = pps.row_height_val[tile_y]
                        nslices = 1
                        if exp:
                            for h in exp:
                                w.ue(h)
                                remaining_h -= h + 1
                            nslices = len(exp)
                            uniform = exp[-1] + 1
                            while remaining_h > uniform:
                                remaining_h -= uniform
                                nslices += 1
                            if remaining_h > 0:
                                nslices += 1
                        i += nslices - 1
                    if i < pps.pps_num_slices_in_pic_minus1:
                        if pps.pps_tile_idx_delta_present_flag:
                            w.se(pps.pps_tile_idx_delta_val[i])
                            tile_idx += pps.pps_tile_idx_delta_val[i]
                        else:
                            tile_idx += pps.pps_slice_width_in_tiles_minus1[i] + 1
                            if tile_idx % pps.num_tile_columns == 0:
                                tile_idx += pps.pps_slice_height_in_tiles_minus1[i] * \
                                    pps.num_tile_columns
                    i += 1
        if not pps.pps_rect_slice_flag or pps.pps_single_slice_per_subpic_flag or \
                pps.pps_num_slices_in_pic_minus1 > 0:
            w.flag(pps.pps_loop_filter_across_slices_enabled_flag)
    w.flag(pps.pps_cabac_init_present_flag)
    w.ue(pps.pps_num_ref_idx_default_active_minus1[0])
    w.ue(pps.pps_num_ref_idx_default_active_minus1[1])
    w.flag(pps.pps_rpl1_idx_present_flag)
    w.flag(pps.pps_weighted_pred_flag)
    w.flag(pps.pps_weighted_bipred_flag)
    w.flag(pps.pps_ref_wraparound_enabled_flag)
    if pps.pps_ref_wraparound_enabled_flag:
        w.ue(pps.pps_pic_width_minus_wraparound_offset)
    w.se(pps.pps_init_qp_minus26)
    w.flag(pps.pps_cu_qp_delta_enabled_flag)
    w.flag(pps.pps_chroma_tool_offsets_present_flag)
    if pps.pps_chroma_tool_offsets_present_flag:
        w.se(pps.pps_cb_qp_offset)
        w.se(pps.pps_cr_qp_offset)
        w.flag(pps.pps_joint_cbcr_qp_offset_present_flag)
        if pps.pps_joint_cbcr_qp_offset_present_flag:
            w.se(pps.pps_joint_cbcr_qp_offset_value)
        w.flag(pps.pps_slice_chroma_qp_offsets_present_flag)
        w.flag(pps.pps_cu_chroma_qp_offset_list_enabled_flag)
        if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
            w.ue(pps.pps_chroma_qp_offset_list_len_minus1)
            for i in range(pps.pps_chroma_qp_offset_list_len_minus1 + 1):
                w.se(pps.pps_cb_qp_offset_list[i])
                w.se(pps.pps_cr_qp_offset_list[i])
                if pps.pps_joint_cbcr_qp_offset_present_flag:
                    w.se(pps.pps_joint_cbcr_qp_offset_list[i])
    w.flag(pps.pps_deblocking_filter_control_present_flag)
    if pps.pps_deblocking_filter_control_present_flag:
        w.flag(pps.pps_deblocking_filter_override_enabled_flag)
        w.flag(pps.pps_deblocking_filter_disabled_flag)
        if not pps.pps_no_pic_partition_flag and \
                pps.pps_deblocking_filter_override_enabled_flag:
            w.flag(pps.pps_dbf_info_in_ph_flag)
        if not pps.pps_deblocking_filter_disabled_flag:
            w.se(pps.pps_luma_beta_offset_div2)
            w.se(pps.pps_luma_tc_offset_div2)
            if pps.pps_chroma_tool_offsets_present_flag:
                w.se(pps.pps_cb_beta_offset_div2)
                w.se(pps.pps_cb_tc_offset_div2)
                w.se(pps.pps_cr_beta_offset_div2)
                w.se(pps.pps_cr_tc_offset_div2)
    if not pps.pps_no_pic_partition_flag:
        w.flag(pps.pps_rpl_info_in_ph_flag)
        w.flag(pps.pps_sao_info_in_ph_flag)
        w.flag(pps.pps_alf_info_in_ph_flag)
        if (pps.pps_weighted_pred_flag or pps.pps_weighted_bipred_flag) and \
                pps.pps_rpl_info_in_ph_flag:
            w.flag(pps.pps_wp_info_in_ph_flag)
        w.flag(pps.pps_qp_delta_info_in_ph_flag)
    w.flag(pps.pps_picture_header_extension_present_flag)
    w.flag(pps.pps_slice_header_extension_present_flag)
    w.flag(pps.pps_extension_flag)
    w.rbsp_trailing_bits()
    return w.bytes()


def write_picture_header(w: BitWriter, ph: SyntaxObj, sps: SyntaxObj, pps: SyntaxObj):
    """picture_header_structure() into an existing writer (no trailing bits)."""
    w.flag(ph.ph_gdr_or_irap_pic_flag)
    w.flag(ph.ph_non_ref_pic_flag)
    if ph.ph_gdr_or_irap_pic_flag:
        w.flag(ph.ph_gdr_pic_flag)
    w.flag(ph.ph_inter_slice_allowed_flag)
    if ph.ph_inter_slice_allowed_flag:
        w.flag(ph.ph_intra_slice_allowed_flag)
    w.ue(ph.ph_pic_parameter_set_id)
    w.u(ph.ph_pic_order_cnt_lsb, sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4)
    if ph.ph_gdr_pic_flag:
        w.ue(ph.ph_recovery_poc_cnt)
    for i in range(sps.sps_num_extra_ph_bytes * 8):
        # reserved extension bits: readers skip them (h266.py:1465-1467)
        if sps.sps_extra_ph_bit_present_flag[i]:
            w.u(0, 1)
    if sps.sps_poc_msb_cycle_flag:
        w.flag(ph.ph_poc_msb_cycle_present_flag)
        if ph.ph_poc_msb_cycle_present_flag:
            w.u(ph.ph_poc_msb_cycle_val, sps.sps_poc_msb_cycle_len_minus1 + 1)
    if sps.sps_alf_enabled_flag and pps.pps_alf_info_in_ph_flag:
        w.flag(ph.ph_alf_enabled_flag)
        if ph.ph_alf_enabled_flag:
            w.u(ph.ph_num_alf_aps_ids_luma, 3)
            for v in ph.ph_alf_aps_id_luma:
                w.u(v, 3)
            if sps.sps_chroma_format_idc != 0:
                w.flag(ph.ph_alf_cb_enabled_flag)
                w.flag(ph.ph_alf_cr_enabled_flag)
            if ph.ph_alf_cb_enabled_flag or ph.ph_alf_cr_enabled_flag:
                w.u(ph.ph_alf_aps_id_chroma, 3)
            if sps.sps_ccalf_enabled_flag:
                w.flag(ph.ph_alf_cc_cb_enabled_flag)
                if ph.ph_alf_cc_cb_enabled_flag:
                    w.u(ph.ph_alf_cc_cb_aps_id, 3)
                w.flag(ph.ph_alf_cc_cr_enabled_flag)
                if ph.ph_alf_cc_cr_enabled_flag:
                    w.u(ph.ph_alf_cc_cr_aps_id, 3)
    if sps.sps_lmcs_enabled_flag:
        w.flag(ph.ph_lmcs_enabled_flag)
        if ph.ph_lmcs_enabled_flag:
            w.u(ph.ph_lmcs_aps_id, 2)
            if sps.sps_chroma_format_idc != 0:
                w.flag(ph.ph_chroma_residual_scale_flag)
    if sps.sps_explicit_scaling_list_enabled_flag:
        w.flag(ph.ph_explicit_scaling_list_enabled_flag)
        if ph.ph_explicit_scaling_list_enabled_flag:
            w.u(ph.ph_scaling_list_aps_id, 3)
    if sps.sps_virtual_boundaries_enabled_flag and \
            not sps.sps_virtual_boundaries_present_flag:
        w.flag(ph.ph_virtual_boundaries_present_flag)
        if ph.ph_virtual_boundaries_present_flag:
            w.ue(ph.ph_num_ver_virtual_boundaries)
            for v in ph.ph_virtual_boundary_pos_x_minus1:
                w.ue(v)
            w.ue(ph.ph_num_hor_virtual_boundaries)
            for v in ph.ph_virtual_boundary_pos_y_minus1:
                w.ue(v)
    if pps.pps_output_flag_present_flag and not ph.ph_non_ref_pic_flag:
        w.flag(ph.ph_pic_output_flag)
    if pps.pps_rpl_info_in_ph_flag:
        write_ref_pic_lists(w, sps, pps, ph.ph_ref_pic_lists)
    if sps.sps_partition_constraints_override_enabled_flag:
        w.flag(ph.ph_partition_constraints_override_flag)
    if ph.ph_intra_slice_allowed_flag:
        if ph.ph_partition_constraints_override_flag:
            w.ue(ph.ph_log2_diff_min_qt_min_cb_intra_slice_luma)
            w.ue(ph.ph_max_mtt_hierarchy_depth_intra_slice_luma)
            if ph.ph_max_mtt_hierarchy_depth_intra_slice_luma != 0:
                w.ue(ph.ph_log2_diff_max_bt_min_qt_intra_slice_luma)
                w.ue(ph.ph_log2_diff_max_tt_min_qt_intra_slice_luma)
            if sps.sps_qtbtt_dual_tree_intra_flag:
                w.ue(ph.ph_log2_diff_min_qt_min_cb_intra_slice_chroma)
                w.ue(ph.ph_max_mtt_hierarchy_depth_intra_slice_chroma)
                if sps.sps_max_mtt_hierarchy_depth_intra_slice_chroma != 0:
                    w.ue(ph.ph_log2_diff_max_bt_min_qt_intra_slice_chroma)
                    w.ue(ph.ph_log2_diff_max_tt_min_qt_intra_slice_chroma)
        if pps.pps_cu_qp_delta_enabled_flag:
            w.ue(ph.ph_cu_qp_delta_subdiv_intra_slice)
        if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
            w.ue(ph.ph_cu_chroma_qp_offset_subdiv_intra_slice)
    if ph.ph_inter_slice_allowed_flag:
        if ph.ph_partition_constraints_override_flag:
            w.ue(ph.ph_log2_diff_min_qt_min_cb_inter_slice)
            w.ue(ph.ph_max_mtt_hierarchy_depth_inter_slice)
            if ph.ph_max_mtt_hierarchy_depth_inter_slice != 0:
                w.ue(ph.ph_log2_diff_max_bt_min_qt_inter_slice)
                w.ue(ph.ph_log2_diff_max_tt_min_qt_inter_slice)
        if pps.pps_cu_qp_delta_enabled_flag:
            w.ue(ph.ph_cu_qp_delta_subdiv_inter_slice)
        if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
            w.ue(ph.ph_cu_chroma_qp_offset_subdiv_inter_slice)
        if sps.sps_temporal_mvp_enabled_flag:
            w.flag(ph.ph_temporal_mvp_enabled_flag)
            if ph.ph_temporal_mvp_enabled_flag and pps.pps_rpl_info_in_ph_flag:
                if ph.ph_ref_pic_lists.rpl_ref_list[1].num_ref_entries > 0:
                    w.flag(ph.ph_collocated_from_l0_flag)
                idx = 0 if ph.ph_collocated_from_l0_flag else 1
                if ph.ph_ref_pic_lists.rpl_ref_list[idx].num_ref_entries > 1:
                    w.ue(ph.ph_collocated_ref_idx)
        if sps.sps_mmvd_fullpel_only_enabled_flag:
            w.flag(ph.ph_mmvd_fullpel_only_flag)
        presence = (not pps.pps_rpl_info_in_ph_flag) or \
            ph.ph_ref_pic_lists.rpl_ref_list[1].num_ref_entries > 0
        if presence:
            w.flag(ph.ph_mvd_l1_zero_flag)
            if sps.sps_bdof_control_present_in_ph_flag:
                w.flag(ph.ph_bdof_disabled_flag)
            if sps.sps_dmvr_control_present_in_ph_flag:
                w.flag(ph.ph_dmvr_disabled_flag)
        if sps.sps_prof_control_present_in_ph_flag:
            w.flag(ph.ph_prof_disabled_flag)
        if (pps.pps_weighted_pred_flag or pps.pps_weighted_bipred_flag) and \
                pps.pps_wp_info_in_ph_flag:
            write_pred_weight_table(w, sps, pps, ph.ph_ref_pic_lists,
                                    ph.ph_pred_weight_table)
    if pps.pps_qp_delta_info_in_ph_flag:
        w.se(ph.ph_qp_delta)
    if sps.sps_joint_cbcr_enabled_flag:
        w.flag(ph.ph_joint_cbcr_sign_flag)
    if sps.sps_sao_enabled_flag and pps.pps_sao_info_in_ph_flag:
        w.flag(ph.ph_sao_luma_enabled_flag)
        if sps.sps_chroma_format_idc != 0:
            w.flag(ph.ph_sao_chroma_enabled_flag)
    if pps.pps_dbf_info_in_ph_flag:
        w.flag(ph.ph_deblocking_params_present_flag)
    if ph.ph_deblocking_params_present_flag:
        if not pps.pps_deblocking_filter_disabled_flag:
            w.flag(ph.ph_deblocking_filter_disabled_flag)
            if not ph.ph_deblocking_filter_disabled_flag:
                w.se(ph.ph_luma_beta_offset_div2)
                w.se(ph.ph_luma_tc_offset_div2)
                if pps.pps_chroma_tool_offsets_present_flag:
                    w.se(ph.ph_cb_beta_offset_div2)
                    w.se(ph.ph_cb_tc_offset_div2)
                    w.se(ph.ph_cr_beta_offset_div2)
                    w.se(ph.ph_cr_tc_offset_div2)
    if pps.pps_picture_header_extension_present_flag:
        w.ue(0)


def write_slice_header(sh: SyntaxObj, sps: SyntaxObj, pps: SyntaxObj,
                       ph: SyntaxObj) -> BitWriter:
    """Serialize a slice header; returns the open BitWriter (byte-aligned)
    so slice_data bytes can be appended by the caller."""
    w = BitWriter()
    w.flag(sh.sh_picture_header_in_slice_header_flag)
    if sh.sh_picture_header_in_slice_header_flag:
        write_picture_header(w, ph, sps, pps)
    if sps.sps_subpic_info_present_flag:
        w.u(sh.sh_subpic_id, sps.sps_subpic_id_len_minus1 + 1)
    num_slices_in_subpic = pps.num_slices_in_subpic[sh.curr_subpic_idx]
    if (pps.pps_rect_slice_flag and num_slices_in_subpic > 1) or \
            (not pps.pps_rect_slice_flag and pps.num_tiles_in_pic > 1):
        bits = ceil_log2(pps.num_tiles_in_pic) if not pps.pps_rect_slice_flag \
            else ceil_log2(num_slices_in_subpic)
        w.u(sh.sh_slice_address, bits)
    for i in range(sps.sps_num_extra_sh_bytes * 8):
        # reserved extension bits: readers skip them (h266.py:1713)
        if sps.sps_extra_sh_bit_present_flag[i]:
            w.u(0, 1)
    if not pps.pps_rect_slice_flag and \
            pps.num_tiles_in_pic - sh.sh_slice_address > 1:
        w.ue(sh.sh_num_tiles_in_slice_minus1)
    if ph.ph_inter_slice_allowed_flag:
        w.ue(sh.sh_slice_type)
    if sh.nal_unit_type in (NalType.IDR_W_RADL, NalType.IDR_N_LP,
                            NalType.CRA, NalType.GDR):
        w.flag(sh.sh_no_output_of_prior_pics_flag)
    if sps.sps_alf_enabled_flag and not pps.pps_alf_info_in_ph_flag:
        w.flag(sh.sh_alf_enabled_flag)
        if sh.sh_alf_enabled_flag:
            w.u(sh.sh_num_alf_aps_ids_luma, 3)
            for v in sh.sh_alf_aps_id_luma:
                w.u(v, 3)
            if sps.sps_chroma_format_idc != 0:
                w.flag(sh.sh_alf_cb_enabled_flag)
                w.flag(sh.sh_alf_cr_enabled_flag)
            if sh.sh_alf_cb_enabled_flag or sh.sh_alf_cr_enabled_flag:
                w.u(sh.sh_alf_aps_id_chroma, 3)
            if sps.sps_ccalf_enabled_flag:
                w.flag(sh.sh_alf_cc_cb_enabled_flag)
                if sh.sh_alf_cc_cb_enabled_flag:
                    w.u(sh.sh_alf_cc_cb_aps_id, 3)
                w.flag(sh.sh_alf_cc_cr_enabled_flag)
                if sh.sh_alf_cc_cr_enabled_flag:
                    w.u(sh.sh_alf_cc_cr_aps_id, 3)
    if not sh.sh_picture_header_in_slice_header_flag:
        if ph.ph_lmcs_enabled_flag:
            w.flag(sh.sh_lmcs_used_flag)
        if ph.ph_explicit_scaling_list_enabled_flag:
            w.flag(sh.sh_explicit_scaling_list_used_flag)
    if not pps.pps_rpl_info_in_ph_flag and \
            (sh.nal_unit_type not in (NalType.IDR_W_RADL, NalType.IDR_N_LP)
             or sps.sps_idr_rpl_present_flag):
        write_ref_pic_lists(w, sps, pps, sh.sh_ref_pic_lists)
        ref_pic_lists = sh.sh_ref_pic_lists
    else:
        ref_pic_lists = ph.ph_ref_pic_lists
    if ref_pic_lists and ref_pic_lists != 0:
        if (sh.sh_slice_type != SLICE_I and
                ref_pic_lists.rpl_ref_list[0].num_ref_entries > 1) or \
                (sh.sh_slice_type == SLICE_B and
                 ref_pic_lists.rpl_ref_list[1].num_ref_entries > 1):
            w.flag(sh.sh_num_ref_idx_active_override_flag)
            if sh.sh_num_ref_idx_active_override_flag:
                for i in range(2 if sh.sh_slice_type == SLICE_B else 1):
                    if ref_pic_lists.rpl_ref_list[i].num_ref_entries > 1:
                        w.ue(sh.sh_num_ref_idx_active_minus1[i])
    if sh.sh_slice_type != SLICE_I:
        if pps.pps_cabac_init_present_flag:
            w.flag(sh.sh_cabac_init_flag)
        if ph.ph_temporal_mvp_enabled_flag and not pps.pps_rpl_info_in_ph_flag:
            if sh.sh_slice_type == SLICE_B:
                w.flag(sh.sh_collocated_from_l0_flag)
            idx = 0 if sh.sh_collocated_from_l0_flag else 1
            if sh.num_ref_idx_active[idx] > 1:
                w.ue(sh.sh_collocated_ref_idx)
        if not pps.pps_wp_info_in_ph_flag and \
                ((pps.pps_weighted_pred_flag and sh.sh_slice_type == SLICE_P) or
                 (pps.pps_weighted_bipred_flag and sh.sh_slice_type == SLICE_B)):
            write_pred_weight_table(w, sps, pps, ref_pic_lists,
                                    sh.sh_pred_weight_table)
    if not pps.pps_qp_delta_info_in_ph_flag:
        w.se(sh.sh_qp_delta)
    if pps.pps_slice_chroma_qp_offsets_present_flag:
        w.se(sh.sh_cb_qp_offset)
        w.se(sh.sh_cr_qp_offset)
        if sps.sps_joint_cbcr_enabled_flag:
            w.se(sh.sh_joint_cbcr_qp_offset)
    if pps.pps_cu_chroma_qp_offset_list_enabled_flag:
        w.flag(sh.sh_cu_chroma_qp_offset_enabled_flag)
    if sps.sps_sao_enabled_flag and not pps.pps_sao_info_in_ph_flag:
        w.flag(sh.sh_sao_luma_used_flag)
        if sps.sps_chroma_format_idc != 0:
            w.flag(sh.sh_sao_chroma_used_flag)
    if pps.pps_deblocking_filter_override_enabled_flag and \
            not pps.pps_dbf_info_in_ph_flag:
        w.flag(sh.sh_deblocking_params_present_flag)
    if sh.sh_deblocking_params_present_flag:
        if not pps.pps_deblocking_filter_disabled_flag:
            w.flag(sh.sh_deblocking_filter_disabled_flag)
        if not sh.sh_deblocking_filter_disabled_flag:
            w.se(sh.sh_luma_beta_offset_div2)
            w.se(sh.sh_luma_tc_offset_div2)
            if pps.pps_chroma_tool_offsets_present_flag:
                w.se(sh.sh_cb_beta_offset_div2)
                w.se(sh.sh_cb_tc_offset_div2)
                w.se(sh.sh_cr_beta_offset_div2)
                w.se(sh.sh_cr_tc_offset_div2)
    if sps.sps_dep_quant_enabled_flag:
        w.flag(sh.sh_dep_quant_used_flag)
    if sps.sps_sign_data_hiding_enabled_flag and not sh.sh_dep_quant_used_flag:
        w.flag(sh.sh_sign_data_hiding_used_flag)
    if sps.sps_transform_skip_enabled_flag and not sh.sh_dep_quant_used_flag \
            and not sh.sh_sign_data_hiding_used_flag:
        w.flag(sh.sh_ts_residual_coding_disabled_flag)
    if not sh.sh_ts_residual_coding_disabled_flag and \
            sps.sps_ts_residual_coding_rice_present_in_sh_flag:
        w.u(sh.sh_ts_residual_coding_rice_idx_minus1, 3)
    if sps.sps_reverse_last_sig_coeff_enabled_flag:
        w.flag(sh.sh_reverse_last_sig_coeff_flag)
    if pps.pps_slice_header_extension_present_flag:
        w.ue(0)
    if sps.sps_entry_point_offsets_present_flag and sh.num_entry_points > 0:
        w.ue(sh.sh_entry_offset_len_minus1)
        for v in sh.sh_entry_point_offset_minus1:
            w.u(v, sh.sh_entry_offset_len_minus1 + 1)
    w.byte_alignment()
    return w
