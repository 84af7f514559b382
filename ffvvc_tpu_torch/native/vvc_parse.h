/* Shared structs for the native CTU parse core: vvc_parse.c (coding tree,
 * CU/TU syntax, residual dispatch) and vvc_mvs.c (inter MV derivation).
 *
 * The SliceParams / SliceState layouts are mirrored field-for-field by
 * ffvvc_tpu/native/parse.py (_SliceParams / _SliceState) — update both
 * sides together.
 *
 * Reference analogue: libavcodec/vvc/vvc_ctu.h (CodingUnit,
 * VVCLocalContext), re-expressed for our flat-record / dense-plane design.
 */
#ifndef VVC_PARSE_H
#define VVC_PARSE_H

#include <stdint.h>
#include <string.h>

#include "vvc_cabac.h"

/* enums mirroring ffvvc_tpu/ctu.py:23-35 */
enum { SINGLE_TREE = 0, DUAL_TREE_LUMA = 1, DUAL_TREE_CHROMA = 2 };
enum { MODE_TYPE_ALL = 0, MODE_TYPE_INTER = 1, MODE_TYPE_INTRA = 2 };
enum { SPLIT_NONE = 0, SPLIT_TT_HOR = 1, SPLIT_BT_HOR = 2,
       SPLIT_TT_VER = 3, SPLIT_BT_VER = 4, SPLIT_QT = 5 };
enum { MODE_INTER = 0, MODE_INTRA = 1, MODE_SKIP = 2, MODE_PLT = 3,
       MODE_IBC = 4 };
enum { ISP_NO_SPLIT = 0, ISP_HOR_SPLIT = 1, ISP_VER_SPLIT = 2 };
enum { LUMA = 0, CB = 1, CR = 2, JCBCR = 3 };
enum { SLICE_B = 0, SLICE_P = 1, SLICE_I = 2 };

/* PredFlag (ffvvc_tpu/mvs.py:16) */
enum { PF_INTRA = 0, PF_L0 = 1, PF_L1 = 2, PF_BI = 3 };

#define MAX_NUM_HMVP_CANDS 5

#define INTRA_PLANAR 0
#define INTRA_DC     1
#define INTRA_HORZ   18
#define INTRA_VERT   50
#define INTRA_VDIAG  66
#define INTRA_LT_CCLM 81
#define INTRA_INVALID (-1)

/* record strides (must match ffvvc_tpu/native/parse.py) */
#define CU_STRIDE 52
#define TU_STRIDE 12
#define TB_STRIDE 12

/* CU record fields */
enum {
    CU_X0 = 0, CU_Y0, CU_W, CU_H, CU_CQT_DEPTH, CU_TREE_TYPE, CU_PRED_MODE,
    CU_SKIP, CU_CODED, CU_IPM_Y, CU_IPM_C, CU_MRL, CU_MIP_FLAG, CU_MIP_T,
    CU_MIP_MODE, CU_ISP, CU_NSP, CU_BDPCM0, CU_BDPCM1, CU_BDPCM2,
    CU_MIP_CHROMA_DIRECT, CU_LFNST, CU_MTS, CU_QP0, CU_QP1, CU_QP2, CU_QP3,
    CU_TU_START, CU_TU_COUNT, CU_ALF0, CU_ALF1, CU_ALF2,
    /* inter PU fields (0 for intra CUs) */
    CU_MI_PF,       /* MotionInfo.pred_flag */
    CU_REF0, CU_REF1,
    CU_BCW, CU_HPEL, CU_MMI,      /* bcw_idx, hpel_if_idx, motion_model_idc */
    CU_NSBX, CU_NSBY,             /* num_sb_x / num_sb_y */
    CU_IFLAGS,                    /* IF_* bitmask below */
    CU_GPM_PART,
    CU_GPM0_LX, CU_GPM0_REF, CU_GPM0_MVX, CU_GPM0_MVY,
    CU_GPM1_LX, CU_GPM1_REF, CU_GPM1_MVX, CU_GPM1_MVY,
    CU_SBT                        /* sbt_flag | horizontal<<1 | pos<<2 */
};

/* CU_IFLAGS bits */
enum {
    IF_MERGE_GPM   = 1,
    IF_AFFINE      = 2,
    IF_CIIP        = 4,
    IF_DMVR        = 8,
    IF_BDOF        = 16,
    IF_PROF_L0     = 32,
    IF_PROF_L1     = 64,
    IF_GENERAL_MERGE = 128,
    IF_MERGE_SUBBLOCK = 256
};

/* TU record fields */
enum {
    TU_X0 = 0, TU_Y0, TU_W, TU_H, TU_CODED0, TU_CODED1, TU_CODED2,
    TU_JCBCR, TU_TB_START, TU_TB_COUNT
};
/* TB record fields */
enum {
    TB_X0 = 0, TB_Y0, TB_W, TB_H, TB_C_IDX, TB_TS, TB_HAS_COEFFS,
    TB_MAX_SCAN_X, TB_MAX_SCAN_Y, TB_COEFF_OFF
};

typedef struct {
    /* geometry */
    int width, height, ctb_log2, min_cb_log2;
    int w4, h4;            /* strides of the 4x4-grid planes */
    int w32, w64;          /* strides of msm / ispmf */
    int ctb_width, ctb_height;
    int chroma_format_idc, hshift1, vshift1;
    int bit_depth, qp_bd_offset, max_tb_size_y, max_ts_size;
    int log2_transform_range;
    /* sps flags */
    int sps_mip, sps_mrl, sps_isp, sps_cclm, sps_dual_tree;
    int sps_bdpcm, sps_transform_skip, sps_lfnst, sps_mts;
    int sps_explicit_mts_intra, sps_explicit_mts_inter;
    int sps_joint_cbcr, sps_sbt, sps_persistent_rice, sps_rrc_rice_ext;
    int sps_ibc, sps_act, sps_palette;
    /* pps / sh */
    int pps_cu_qp_delta_enabled, pps_chroma_qp_offset_list_len_minus1;
    int pps_cb_qp_offset_list[6], pps_cr_qp_offset_list[6],
        pps_jcbcr_qp_offset_list[6];
    int pps_chroma_qp_offset[3];
    int sh_cu_chroma_qp_offset_enabled;
    int sh_chroma_qp_offset[3];  /* sh_cb/cr/joint_cbcr qp offsets */
    int slice_type, slice_qp_y;
    int dep_quant, sdh, reverse_last, ts_res_disabled;
    int cu_qp_delta_subdiv, cu_chroma_qp_offset_subdiv;
    int min_qt_size[2], max_mtt_depth[2], max_bt_size[2], max_tt_size[2];
    int init_stat_coeff;
    /* ctx bases (from cabac/engine.py CTX) */
    int ctx_split_cu, ctx_split_qt, ctx_mtt_vertical, ctx_mtt_binary;
    int ctx_non_inter, ctx_cu_skip, ctx_pred_mode;
    int ctx_bdpcm_luma, ctx_bdpcm_luma_dir, ctx_mip, ctx_mrl;
    int ctx_isp_mode, ctx_isp_split, ctx_mpm, ctx_not_planar;
    int ctx_bdpcm_chroma, ctx_bdpcm_chroma_dir;
    int ctx_cclm_mode_flag, ctx_cclm_mode_idx, ctx_chroma_pred_mode;
    int ctx_cu_coded, ctx_sbt_flag, ctx_sbt_quad, ctx_sbt_horizontal,
        ctx_sbt_pos;
    int ctx_tu_cb, ctx_tu_cr, ctx_tu_y, ctx_jcbcr;
    int ctx_qp_delta_abs, ctx_chroma_qp_offset_flag,
        ctx_chroma_qp_offset_idx;
    int ctx_ts_flag, ctx_lfnst, ctx_mts;
    int ctx_sig, ctx_last_x, ctx_last_y, ctx_sb_coded, ctx_gtx, ctx_par;
    /* tab plane pointers (int32 [h4, w4] unless noted) */
    int32_t *qp0, *qp1, *qp2, *qp3;
    int32_t *cpm0, *cpm1, *ipm, *imf, *imtf, *imm, *skip;
    int32_t *cb_width0, *cb_width1, *cb_height0, *cb_height1;
    int32_t *cb_pos_x0, *cb_pos_x1, *cb_pos_y0, *cb_pos_y1;
    int32_t *cqt_depth0, *cqt_depth1;
    int32_t *tu_coded0, *tu_coded1, *tu_coded2, *tu_joint_cbcr;
    int32_t *tb_pos_x0, *tb_pos_x1, *tb_pos_y0, *tb_pos_y1;
    int32_t *tb_width0, *tb_width1, *tb_height0, *tb_height1;
    int32_t *pcmf0, *pcmf1;
    int32_t *msf, *mmi;
    uint8_t *mvf_pf, *col_pf;          /* uint8 [h4, w4] */
    int32_t *msm0, *msm1;              /* [h32, w32] */
    int32_t *ispmf;                    /* [h64, w64] */
    int32_t *slice_idx;                /* [ctb_height, ctb_width] */
    /* note: written per CTU by parse_ctus */
    int32_t *ctb_to_col_bd;            /* len ctb_width + 1 */
    int32_t *ctb_to_row_bd;            /* len ctb_height + 1 */
    int32_t *chroma_qp_table;          /* [3, qp_table_len] flattened */
    int qp_table_len;
    /* --- per-CTU SAO / ALF parameter parse (hls_sao / alf_params) ------- */
    int sps_alf, sps_ccalf;
    int sao_luma_used, sao_chroma_used;
    int alf_enabled, alf_cb_enabled, alf_cr_enabled;
    int alf_cc_cb_enabled, alf_cc_cr_enabled;
    int num_alf_aps_ids_luma;
    int alf_aps_id_luma[8];
    int alf_aps_id_chroma;
    int num_chroma_alt_filters;
    int num_cc_filters[2];
    int ctx_sao_merge, ctx_sao_type, ctx_alf_ctb_flag, ctx_alf_use_aps;
    int ctx_alf_alt_idx, ctx_alf_cc_cb, ctx_alf_cc_cr;
    int32_t *sao_type_tab;      /* [nctb][3] */
    int32_t *sao_band_pos;      /* [nctb][3] */
    int32_t *sao_eo_class;      /* [nctb][3] */
    int32_t *sao_offset;        /* [nctb][3][5] */
    int32_t *alf_ctb_flag;      /* [nctb][3] */
    int32_t *alf_aps_id;        /* [nctb][3] */
    int32_t *alf_fixed;         /* [nctb] */
    int32_t *alf_filt_idx;      /* [nctb] */
    int32_t *alf_alt_idx;       /* [nctb][2] */
    int32_t *alf_cc_idc;        /* [nctb][2] */
    /* transform-skip residual */
    int ts_rice;                /* sh_ts_residual_coding_rice_idx_minus1+1 */
    int ctx_coeff_sign;         /* CTX.COEFF_SIGN_FLAG */
    /* --- inter (P/B) parse + MV derivation (ffvvc_tpu/mvs.py) ----------- */
    int is_b, is_p, poc;
    int sps_width_max, sps_height_max;  /* sps_pic_*_max_in_luma_samples */
    int num_ref_idx_active[2];
    int rpl_nrefs[2];
    int rpl_poc[2][16];
    int rpl_is_lt[2][16];
    int max_num_merge_cand, max_num_gpm_cand, max_num_sb_merge_cand;
    int log2_parallel_merge_level;
    int ref_idx_sym[2];
    int wp_flag[2][2][16];      /* weight_flag[lx][is_chroma][ref_idx] */
    int sps_mmvd, sps_gpm, sps_ciip, sps_affine, sps_6param_affine;
    int sps_sbtmvp, sps_amvr, sps_affine_amvr, sps_smvd, sps_bcw, sps_wpp;
    int ph_temporal_mvp, ph_mmvd_fullpel, ph_mvd_l1_zero;
    int ph_bdof_disabled, ph_dmvr_disabled, ph_prof_disabled;
    int sh_collocated_from_l0;
    /* collocated frame (TMVP); colf_pf == NULL disables TMVP access */
    int col_poc, col_ctb_log2, col_ctb_width;
    int32_t *col_slice_idx;     /* collocated frame's slice_idx plane */
    int col_nslices;
    int32_t *col_rpl_nrefs;     /* [nslices][2] */
    int32_t *col_rpl_poc;      /* [nslices][2][16] */
    int32_t *col_rpl_is_lt;    /* [nslices][2][16] */
    uint8_t *colf_pf;          /* collocated frame's col grids */
    int32_t *colf_mv;          /* [2, h4, w4, 2] */
    int8_t  *colf_ref;         /* [2, h4, w4] */
    /* current-frame MV field planes */
    int32_t *mvf_mv;           /* [2, h4, w4, 2] */
    int8_t  *mvf_ref;          /* [2, h4, w4] */
    int8_t  *mvf_bcw, *mvf_hpel, *mvf_ciip;   /* [h4, w4] */
    int32_t *col_mv;           /* current frame's col (DMVR) grid */
    int8_t  *col_ref;
    int32_t *cp_mv;            /* [2, h4, w4, 3, 2] affine CP MVs */
    int32_t *iaf;              /* inter-affine-flag grid */
    /* GPM derivation tables (ops/data.py) */
    uint8_t *gpm_angle_idx;    /* [64] */
    uint8_t *gpm_distance_idx; /* [64] */
    int8_t  *gpm_distance_lut; /* [32] */
    /* inter ctx bases */
    int ctx_general_merge, ctx_merge_subblock, ctx_merge_subblock_idx;
    int ctx_regular_merge, ctx_mmvd_merge, ctx_mmvd_cand, ctx_mmvd_distance;
    int ctx_ciip, ctx_merge_idx, ctx_inter_pred_idc, ctx_ref_idx;
    int ctx_mvd_gt0, ctx_mvd_gt1, ctx_mvp_lx, ctx_sym_mvd, ctx_inter_affine;
    int ctx_affine_type, ctx_amvr_flag, ctx_amvr_precision, ctx_bcw;
} SliceParams;

/* one 4x4 motion field entry (ffvvc_tpu/mvs.py MvField) */
typedef struct {
    int pf;
    int mv[2][2];
    int ref[2];
    int bcw, hpel, ciip;
} MvF;

/* per-entry-point persistent state (mirrors CtuCoder entry-point state) */
typedef struct {
    int qp_y, is_first_qg;
    int stat_coeff[3];
    int is_cu_qp_delta_coded, is_cu_chroma_qp_offset_coded;
    int cu_qg_top_left_x, cu_qg_top_left_y;
    int chroma_qp_offset[3];
    int prev_tu_cbf_y, infer_tu_cbf_luma;
    /* HMVP table (vvc_mvs.c:1762; reset at tile-column starts) */
    int hmvp_len;
    int hmvp[MAX_NUM_HMVP_CANDS][10];  /* pf, mv00,01,10,11, ref0,1, bcw,
                                          hpel, ciip */
} SliceState;

typedef struct {
    int32_t *cu, *tu, *tb, *coeff;
    int cu_cap, tu_cap, tb_cap, coeff_cap;
    int n_cu, n_tu, n_tb, coeff_len;
    int err;
} ParseOut;

/* per-CU inter parse scratch (PredictionUnit + MotionInfo) */
typedef struct {
    int general_merge, merge_subblock, merge_gpm, mmvd, sym_mvd;
    int inter_affine, ciip, dmvr, bdof;
    int prof[2];
    MvF gpm_mv[2];
    int gpm_part;
    /* MotionInfo */
    int mi_pf, mi_ref[2], mi_bcw, mi_hpel, mi_mmi, nsbx, nsby;
    int mi_mv[2][3][2];
} InterPU;

typedef struct {
    Cabac *c;
    const SliceParams *sp;
    SliceState *st;
    ParseOut *out;
    /* per-CTU neighbour state (decode_neighbour, ctu.py:348) */
    int ctb_left_flag, ctb_up_flag, ctb_up_right_flag, ctb_up_left_flag;
    int end_of_tiles_x, end_of_tiles_y;
    /* per-CU availability (set_neighbour_available, ctu.py:369) */
    int na_cand_up, na_cand_left, na_cand_up_left, na_cand_up_right,
        na_cand_up_right_sap;
    /* per-CU parse flags (coder.parse lfnst/mts state) */
    int lfnst_dc_only, lfnst_zero_out, mts_dc_only, mts_zero_out;
    int sbt_num_fourths_tb0;
    /* current CU record pointer */
    int32_t *cu;
    int cu_idx;
    /* current CU inter scratch */
    InterPU pu;
} Parser;

typedef struct { int qt, btv, bth, ttv, tth; } AllowedSplit;

/* vvc_parse.c helpers used by vvc_mvs.c */
void vvcp_set_neighbour_available(Parser *p, int x0, int y0, int w, int h);

/* vvc_mvs.c API (mirrors ffvvc_tpu/mvs.py MotionContext) */
void mvs_get_mvf(const SliceParams *sp, int x, int y, MvF *f);
void mvs_set_mvf(const SliceParams *sp, int x0, int y0, int w, int h,
                 const MvF *f);
void mvs_set_intra_mvf(const SliceParams *sp, int x0, int y0, int w, int h);
void mvs_fill_dmvr_info(const SliceParams *sp, int x0, int y0, int w, int h);
void mvs_luma_mv_merge_mode(Parser *p, const int32_t *cu, int merge_idx,
                            int ciip_flag, MvF *out);
void mvs_luma_mv_merge_gpm(Parser *p, const int32_t *cu,
                           const int merge_gpm_idx[2], MvF out[2]);
void mvs_store_gpm_mvf(Parser *p, const int32_t *cu, InterPU *pu);
void mvs_derive_mmvd(Parser *p, MvF *mvf, const int mmvd_offset[2]);
void mvs_ff_mvp(Parser *p, const int32_t *cu, const int mvp_lx_flag[2],
                int amvr_shift, InterPU *pu);
void mvs_ff_affine_mvp(Parser *p, const int32_t *cu, const int mvp_lx_flag[2],
                       int amvr_shift, InterPU *pu);
int mvs_sb_mv_merge_mode(Parser *p, const int32_t *cu, int merge_subblock_idx,
                         InterPU *pu);
void mvs_store_sb_mvs(Parser *p, const int32_t *cu, InterPU *pu);
void mvs_update_hmvp(Parser *p, const int32_t *cu);
int mvs_no_backward_pred_flag(const SliceParams *sp);
void mvs_round_mv(int mv[2], int lshift, int rshift);
void mvs_mv_merge_refine_pred_flag(MvF *mvf, int width, int height);

#endif /* VVC_PARSE_H */
