/* Shared structs for the native reconstruction core: vvc_recon.c (intra
 * pred + dequant + inverse transforms + residual add), vvc_inter.c (inter
 * MC walk: regular/affine/GPM prediction, DMVR, BDOF, PROF, CIIP) and
 * vvc_mc.c (interpolation kernels).
 *
 * ReconParams / InterParams are mirrored field-for-field by
 * ffvvc_tpu/native/recon.py (_ReconParams / _InterParams) — update both
 * sides together.
 */
#ifndef VVC_RECON_H
#define VVC_RECON_H

#include <stdint.h>

typedef struct {
    int width, height, ctb_log2, w4;
    int chroma_format_idc, hshift1, vshift1, bit_depth, qp_bd_offset;
    int log2_range;           /* log2_transform_range (ext precision) */
    int dep_quant;            /* sh_dep_quant_used_flag */
    int sps_mts, sps_explicit_mts_intra;
    int wpp;                  /* sps_entropy_coding_sync_enabled_flag */
    int chroma_vert_coll;     /* sps_chroma_vertical_collocated_flag */
    int jcbcr_sign;           /* 1 - 2 * ph_joint_cbcr_sign_flag */
    int slice_type_i;
    int min_qp_prime_ts;      /* sps_min_qp_prime_ts */
    /* frame planes (int32) */
    int32_t *plane0, *plane1, *plane2;
    /* tab planes for LFNST pred-mode derivation */
    int32_t *imf, *cpm0, *ipm;
    /* tile / slice maps for decode_neighbour */
    int32_t *slice_idx, *ctb_to_col_bd, *ctb_to_row_bd;
    int ctb_width;
    /* constant tables */
    int32_t *fc_filt, *fg_filt;                /* intra filters */
    int32_t *dct2_2, *dct2_4, *dct2_8, *dct2_16, *dct2_32, *dct2_64;
    int32_t *dst7_4, *dst7_8, *dst7_16, *dst7_32;
    int32_t *dct8_4, *dct8_8, *dct8_16, *dct8_32;
    int8_t *lfnst_4x4;        /* [4][2][16][16] */
    int8_t *lfnst_8x8;        /* [4][2][16][48] */
    uint8_t *lfnst_set_idx;   /* [95] */
    uint8_t *mip_4x4;         /* [16][16][4] */
    uint8_t *mip_8x8;         /* [8][16][8] */
    uint8_t *mip_16x16;       /* [6][64][7] */
    int32_t *level_scale;     /* [2][6] */
} ReconParams;

/* Per-slice inter-prediction parameters (ffvvc_tpu/inter.py
 * InterPredictor state).  ref_planes[lx][ref_idx][c]: reference frame
 * planes, all the same geometry as the current frame (no RPR — the
 * Python binding gates). */
typedef struct {
    int is_b;                 /* sh.is_b */
    int weighted_pred;        /* sh.weighted_pred (wp/wbp per slice type) */
    int lmcs_used;            /* sh_lmcs_used_flag && ph lmcs */
    int wrap;                 /* wraparound MC offset in luma samples
                                 (PpsRefWraparoundOffset*MinCbSizeY; 0=off) */
    int w4, h4;               /* 4x4-grid plane strides */
    int pw_denom[2];          /* pwt.log2_denom[luma, chroma] */
    int pw_weight[2][3][16];  /* pwt.weight(lx, c_idx, ref_idx) */
    int pw_offset[2][3][16];  /* pwt.offset(lx, c_idx, ref_idx) */
    int32_t *lmcs_fwd;        /* forward-mapping LUT [1 << bd] or NULL */
    int32_t *ref_planes[2][16][3];
    /* current-frame MV field planes (same layout as parse SliceParams) */
    uint8_t *mvf_pf;          /* [h4, w4] */
    int32_t *mvf_mv;          /* [2, h4, w4, 2] */
    int8_t *mvf_ref;          /* [2, h4, w4] */
    int8_t *mvf_bcw, *mvf_hpel, *mvf_ciip;   /* [h4, w4] */
    /* collocated (post-DMVR) grids, written by set_dmvr_info */
    uint8_t *col_pf;          /* [h4, w4] */
    int32_t *col_mv;          /* [2, h4, w4, 2] */
    int8_t *col_ref;          /* [2, h4, w4] */
    int32_t *cp_mv;           /* [2, h4, w4, 3, 2] affine CP MVs */
    /* interpolation filter banks (contiguous int32 copies) */
    int32_t *luma_filters;    /* [3][16][8] */
    int32_t *chroma_filters;  /* [3][32][4] */
    int8_t *dmvr_filters;     /* [16][2] */
    /* GPM blend tables (ops/data.py) */
    uint8_t *gpm_angle_idx;          /* [64] */
    uint8_t *gpm_angle_to_weights;   /* [32] */
    uint8_t *gpm_angle_to_mirror;    /* [32] */
    uint8_t *gpm_off_x, *gpm_off_y;  /* [64][4][4] */
    uint8_t *gpm_weights;            /* [6][112*112] */
} InterParams;

#define MAX_RA 4096

typedef struct {
    const ReconParams *rp;
    const InterParams *ip;    /* NULL on intra-only slices */
    /* per-CTU neighbour flags (decode_neighbour, ctu.py:348) */
    int ctb_left_flag, ctb_up_flag, ctb_up_right_flag, ctb_up_left_flag;
    int end_of_tiles_x, end_of_tiles_y;
    int na_cand_up_left;
    /* reconstructed areas per ch_type: (x, y, w, h) in plane coords */
    int32_t ras[2][MAX_RA][4];
    int n_ras[2];
    /* current CU */
    const int32_t *cu;
    int err;
    /* residual-only mode (device intra path, ops/intra_device.py): skip
     * prediction, write raw per-TB residuals into res_planes instead of
     * adding them to the pixel planes */
    int residual_only;
    int32_t *res_planes[3];
    /* plan mode (device intra planner, ops/intra_device.py): walk the
     * records exactly like recon but emit one descriptor row per predict
     * unit (geometry + availability + a wavefront index) instead of
     * predicting.  plan_wl / plan_wc are pixel-granular wave maps (luma /
     * shared-chroma); a unit's wave = 1 + max wave over the positions its
     * reference gather reads (conservative strip maxes — anti-diagonal
     * levels batch far better than any decode-order greedy). */
    int plan_mode;
    int32_t *plan_buf;
    long plan_n, plan_cap;
    int32_t *plan_wl, *plan_wc;
} Recon;

/* plan descriptor layout (int32 x PLAN_STRIDE per unit) */
#define PLAN_STRIDE 26
enum {
    PK_SIMPLE = 0, PK_ANG_V = 1, PK_ANG_H = 2, PK_MIP = 3, PK_CCLM = 4,
};
enum {
    PL_KIND, PL_C_IDX, PL_X, PL_Y, PL_W, PL_H, PL_MODE, PL_ANGLE,
    PL_INV_ANGLE, PL_REF_IDX, PL_FF, PL_PDPC, PL_NSCALE, PL_LA, PL_TA,
    PL_CUL, PL_UNF_LEFT, PL_UNF_TOP, PL_REFW, PL_REFH, PL_LEFT_SIZE,
    PL_RFFFSM, PL_AUX0, PL_AUX1, PL_WAVE, PL_RSVD,
};

/* vvc_recon.c helpers shared with vvc_inter.c */
int32_t *vvcr_plane_of(const ReconParams *rp, int c);
long vvcr_stride_of(const ReconParams *rp, int c);
void vvcr_set_na(Recon *r, int x0, int y0, int w, int h);
void vvcr_intra_pred(Recon *r, const int32_t *cu, int x0, int y0,
                     int width, int height, int c_idx);

int recon_ctus(const ReconParams *rp, const InterParams *ip, int n,
               const int32_t *rxs, const int32_t *rys, const int32_t *rss,
               const int64_t *cu_ps, const int32_t *n_cus,
               const int64_t *tu_ps, const int64_t *tb_ps,
               const int64_t *coeff_ps);
int recon_residual_ctus(const ReconParams *rp, int n,
                        const int32_t *rxs, const int32_t *rys,
                        const int32_t *rss, const int64_t *cu_ps,
                        const int32_t *n_cus, const int64_t *tu_ps,
                        const int64_t *tb_ps, const int64_t *coeff_ps,
                        int32_t *res0, int32_t *res1, int32_t *res2);
int inter_ctus(const ReconParams *rp, const InterParams *ip, int n,
               const int32_t *rxs, const int32_t *rys, const int32_t *rss,
               const int64_t *cu_ps, const int32_t *n_cus);
int inter_ctus_dev(const ReconParams *rp, const InterParams *ip, int n,
                   const int32_t *rxs, const int32_t *rys,
                   const int32_t *rss, const int64_t *cu_ps,
                   const int32_t *n_cus, int job_tag,
                   int32_t *desc, int desc_cap, int32_t *n_desc);

/* vvc_inter.c: CIIP blend at recon stage (ff_vvc_predict_ciip) */
void vvci_predict_ciip(Recon *r, const int32_t *cu);

/* vvc_mc.c kernels (shared between libvvc_mc.so and libvvc_recon.so) */
void mc_put(int32_t *dst, const int32_t *ref, long stride, int W, int H,
            int x_int, int y_int, int frac_x, int frac_y, int w, int h,
            int is_luma, const int32_t *hf, const int32_t *vf, int bd,
            int has_box, int bx0, int bx1, int by0, int by1, int wrap);
void mc_uni_out(int32_t *plane, long stride, int x, int y,
                const int32_t *val, int w, int h, int bd, int weighted,
                int denom, int wx, int ox);
void mc_avg(int32_t *plane, long stride, int x, int y, const int32_t *s0,
            const int32_t *s1, int w, int h, int bd);
void mc_w_avg(int32_t *plane, long stride, int x, int y, const int32_t *s0,
              const int32_t *s1, int w, int h, int bd, int denom, int w0,
              int w1, int o0, int o1);
void dmvr_bilinear(int32_t *dst, const int32_t *ref, long stride, int W,
                   int H, int mvx, int mvy, int x0, int y0, int pw, int ph,
                   int bd, const int8_t *dfilt, int wrap);
int dmvr_search(const int32_t *t0, const int32_t *t1, int bw, int bh,
                int32_t *dmv);
void apply_bdof(int32_t *out, const int32_t *s0p, const int32_t *s1p,
                int w, int h, int bd);

#endif /* VVC_RECON_H */
