/* Inter motion-vector derivation (H.266 clause 8.5.2) for the native parse
 * core: merge (spatial/temporal/HMVP/pairwise/zero), MMVD, GPM, AMVP,
 * affine inherited/constructed merge + AMVP, SbTMVP, subblock MV storage,
 * HMVP update.
 *
 * A C transliteration of ffvvc_tpu/mvs.py (the golden model), which itself
 * mirrors libavcodec/vvc/vvc_mvs.c (spatial merge :638,
 * temporal :678, HMVP :694, pairwise :713, AMVP :1405-1570, affine
 * :842-1404, SbTMVP :994-1110, storage :251-537).  Must match the Python
 * model bit-exactly (arbitrated by the oracle-differential tests).
 *
 * All intermediate MV math uses 64-bit accumulators where the Python model
 * relies on unbounded ints (affine CP derivation), then rounds/clips back
 * to the 18-bit MV range.
 */
#include "vvc_parse.h"

enum { L0 = 0, L1 = 1 };
enum { NB_A0 = 0, NB_A1, NB_A2, NB_B0, NB_B1, NB_B2, NB_B3 };

static inline int mvs_imin(int a, int b) { return a < b ? a : b; }
static inline int mvs_imax(int a, int b) { return a > b ? a : b; }
static inline int mvs_clip(int v, int lo, int hi)
{ return v < lo ? lo : (v > hi ? hi : v); }
static inline long long mvs_llclip(long long v, long long lo, long long hi)
{ return v < lo ? lo : (v > hi ? hi : v); }

/* ---- MvF helpers (mvs.py:25-98) ---------------------------------------- */

static void mvf_clear(MvF *f)
{
    memset(f, 0, sizeof(*f));
}

static int same_mv_ref(const MvF *n, const MvF *o)
{
    if (!o || n->pf != o->pf)
        return 0;
    for (int i = 0; i < 2; i++) {
        if (n->pf & (i + 1)) {
            if (n->ref[i] != o->ref[i] || n->mv[i][0] != o->mv[i][0] ||
                n->mv[i][1] != o->mv[i][1])
                return 0;
        }
    }
    return 1;
}

void mvs_round_mv(int mv[2], int lshift, int rshift)
{
    if (rshift) {
        int off = 1 << (rshift - 1);
        mv[0] = ((mv[0] + off - (mv[0] >= 0)) >> rshift) * (1 << lshift);
        mv[1] = ((mv[1] + off - (mv[1] >= 0)) >> rshift) * (1 << lshift);
    } else {
        mv[0] *= 1 << lshift;
        mv[1] *= 1 << lshift;
    }
}

static void clip_mv(int mv[2])
{
    mv[0] = mvs_clip(mv[0], -(1 << 17), (1 << 17) - 1);
    mv[1] = mvs_clip(mv[1], -(1 << 17), (1 << 17) - 1);
}

/* ff_vvc_mv_scale (vvc_mvs.c:71) */
static void mv_scale(int out[2], const int src[2], int td, int tb)
{
    td = mvs_clip(td, -128, 127);
    tb = mvs_clip(tb, -128, 127);
    int abs_td_h = (td < 0 ? -td : td) >> 1;
    int tx = (0x4000 + abs_td_h) / td;  /* C truncating division */
    int scale = mvs_clip((tb * tx + 32) >> 6, -(1 << 11), (1 << 11) - 1);
    for (int i = 0; i < 2; i++) {
        long long pr = (long long)scale * src[i];
        out[i] = (int)mvs_llclip((pr + 127 + (pr < 0)) >> 8,
                                 -(1 << 17), (1 << 17) - 1);
    }
}

/* 8.5.2.15 temporal motion buffer compression (vvc_mvs.c:58) */
static void mv_compression(int mv[2])
{
    for (int i = 0; i < 2; i++) {
        int v = mv[i];
        int s = v >> 17;
        unsigned u = (unsigned)((v ^ s) | 31);
        int bl = 32 - __builtin_clz(u);          /* bit_length, u > 0 */
        int f = mvs_imax(bl - 1, 0) - 4;
        int mask = (-(1 << f)) >> 1;
        int rnd = (1 << f) >> 2;
        mv[i] = (v + rnd) & mask;
    }
}

void mvs_mv_merge_refine_pred_flag(MvF *mvf, int width, int height)
{
    if (mvf->pf == PF_BI && width + height == 12) {
        mvf->pf = PF_L0;
        mvf->bcw = 0;
    }
}

/* ---- mvf grid access (mvs.py:114-147) ---------------------------------- */

void mvs_get_mvf(const SliceParams *sp, int x, int y, MvF *f)
{
    int w4 = sp->w4, h4w4 = sp->h4 * sp->w4;
    long i = (long)(y >> 2) * w4 + (x >> 2);
    f->pf = sp->mvf_pf[i];
    for (int l = 0; l < 2; l++) {
        f->mv[l][0] = sp->mvf_mv[(l * h4w4 + i) * 2];
        f->mv[l][1] = sp->mvf_mv[(l * h4w4 + i) * 2 + 1];
        f->ref[l] = sp->mvf_ref[l * h4w4 + i];
    }
    f->bcw = sp->mvf_bcw[i];
    f->hpel = sp->mvf_hpel[i];
    f->ciip = sp->mvf_ciip[i];
}

void mvs_set_mvf(const SliceParams *sp, int x0, int y0, int w, int h,
                 const MvF *f)
{
    int w4 = sp->w4, h4w4 = sp->h4 * sp->w4;
    int xa = x0 >> 2, xb = (x0 + w) >> 2;
    int ya = y0 >> 2, yb = (y0 + h) >> 2;
    for (int y = ya; y < yb; y++) {
        long row = (long)y * w4;
        for (int x = xa; x < xb; x++) {
            long i = row + x;
            sp->mvf_pf[i] = (uint8_t)f->pf;
            for (int l = 0; l < 2; l++) {
                sp->mvf_mv[(l * h4w4 + i) * 2] = f->mv[l][0];
                sp->mvf_mv[(l * h4w4 + i) * 2 + 1] = f->mv[l][1];
                sp->mvf_ref[l * h4w4 + i] = (int8_t)f->ref[l];
            }
            sp->mvf_bcw[i] = (int8_t)f->bcw;
            sp->mvf_hpel[i] = (int8_t)f->hpel;
            sp->mvf_ciip[i] = (int8_t)f->ciip;
        }
    }
}

void mvs_set_intra_mvf(const SliceParams *sp, int x0, int y0, int w, int h)
{
    int w4 = sp->w4;
    int xa = x0 >> 2, xb = (x0 + w) >> 2;
    int ya = y0 >> 2, yb = (y0 + h) >> 2;
    for (int y = ya; y < yb; y++)
        memset(sp->mvf_pf + (long)y * w4 + xa, PF_INTRA, xb - xa);
}

/* fill_dmvr_info (vvc_ctu.c:1697): mvf grid -> per-frame collocated grid */
void mvs_fill_dmvr_info(const SliceParams *sp, int x0, int y0, int w, int h)
{
    int w4 = sp->w4, h4w4 = sp->h4 * sp->w4;
    int xa = x0 >> 2, xb = (x0 + w) >> 2;
    int ya = y0 >> 2, yb = (y0 + h) >> 2;
    for (int y = ya; y < yb; y++) {
        long row = (long)y * w4;
        memcpy(sp->col_pf + row + xa, sp->mvf_pf + row + xa, xb - xa);
        for (int l = 0; l < 2; l++) {
            memcpy(sp->col_mv + (l * h4w4 + row + xa) * 2,
                   sp->mvf_mv + (l * h4w4 + row + xa) * 2,
                   (xb - xa) * 2 * sizeof(int32_t));
            memcpy(sp->col_ref + l * h4w4 + row + xa,
                   sp->mvf_ref + l * h4w4 + row + xa, xb - xa);
        }
    }
}

/* ---- neighbour machinery (mvs.py:149-197) ------------------------------ */

typedef struct { int x[7], y[7], excl[7]; } Nbs;

static int is_available(const SliceParams *sp, int x, int y)
{
    return sp->cb_width0[(long)(y >> 2) * sp->w4 + (x >> 2)] != 0;
}

static int is_a0_available(Parser *p, const int32_t *cu)
{
    const SliceParams *sp = p->sp;
    int x0b = cu[CU_X0] & ((1 << sp->ctb_log2) - 1);
    if (!x0b && !p->ctb_left_flag)
        return 0;
    int max_y = mvs_imin(sp->height,
                         ((cu[CU_Y0] >> sp->ctb_log2) + 1) << sp->ctb_log2);
    if (cu[CU_Y0] + cu[CU_H] >= max_y)
        return 0;
    return is_available(sp, cu[CU_X0] - 1, cu[CU_Y0] + cu[CU_H]);
}

static void neighbours(Parser *p, const int32_t *cu, Nbs *n)
{
    int x0 = cu[CU_X0], y0 = cu[CU_Y0], w = cu[CU_W], h = cu[CU_H];
    int a0 = is_a0_available(p, cu);
    n->x[NB_A0] = x0 - 1;     n->y[NB_A0] = y0 + h;     n->excl[NB_A0] = !a0;
    n->x[NB_A1] = x0 - 1;     n->y[NB_A1] = y0 + h - 1;
    n->excl[NB_A1] = !p->na_cand_left;
    n->x[NB_A2] = x0 - 1;     n->y[NB_A2] = y0;
    n->excl[NB_A2] = !p->na_cand_left;
    n->x[NB_B0] = x0 + w;     n->y[NB_B0] = y0 - 1;
    n->excl[NB_B0] = !p->na_cand_up_right;
    n->x[NB_B1] = x0 + w - 1; n->y[NB_B1] = y0 - 1;
    n->excl[NB_B1] = !p->na_cand_up;
    n->x[NB_B2] = x0 - 1;     n->y[NB_B2] = y0 - 1;
    n->excl[NB_B2] = !p->na_cand_up_left;
    n->x[NB_B3] = x0;         n->y[NB_B3] = y0 - 1;
    n->excl[NB_B3] = !p->na_cand_up;
}

static int is_same_mer(const SliceParams *sp, int xn, int yn, int xp, int yp)
{
    int pl = sp->log2_parallel_merge_level;
    return (xn >> pl) == (xp >> pl) && (yn >> pl) == (yp >> pl);
}

static int check_available(Parser *p, const int32_t *cu, const Nbs *n,
                           int nb, int is_mvp)
{
    const SliceParams *sp = p->sp;
    int x = n->x[nb], y = n->y[nb];
    if (n->excl[nb])
        return 0;
    if (sp->sps_wpp && (x >> sp->ctb_log2) > (cu[CU_X0] >> sp->ctb_log2))
        return 0;
    if (!is_available(sp, x, y))
        return 0;
    if (sp->mvf_pf[(long)(y >> 2) * sp->w4 + (x >> 2)] == PF_INTRA)
        return 0;
    if (!is_mvp && is_same_mer(sp, x, y, cu[CU_X0], cu[CU_Y0]))
        return 0;
    return 1;
}

/* ---- temporal (TMVP) (mvs.py:201-288) ---------------------------------- */

int mvs_no_backward_pred_flag(const SliceParams *sp)
{
    for (int lx = 0; lx < 2; lx++)
        for (int i = 0; i < sp->rpl_nrefs[lx]; i++)
            if (sp->rpl_poc[lx][i] > sp->poc)
                return 0;
    return 1;
}

/* collocated-frame access (DecodedFrame.get_mvf / rpl_at) */
static void col_get_mvf(const SliceParams *sp, int x, int y, MvF *f)
{
    int w4 = sp->w4, h4w4 = sp->h4 * sp->w4;
    long i = (long)(y >> 2) * w4 + (x >> 2);
    mvf_clear(f);
    f->pf = sp->colf_pf[i];
    for (int l = 0; l < 2; l++) {
        f->mv[l][0] = sp->colf_mv[(l * h4w4 + i) * 2];
        f->mv[l][1] = sp->colf_mv[(l * h4w4 + i) * 2 + 1];
        f->ref[l] = sp->colf_ref[l * h4w4 + i];
    }
}

/* returns si-rpl base indices for (x, y) of the collocated frame */
static int col_rpl_at(const SliceParams *sp, int x, int y)
{
    long i = (long)(y >> sp->col_ctb_log2) * sp->col_ctb_width +
             (x >> sp->col_ctb_log2);
    int si = sp->col_slice_idx[i];
    if (si < 0 || si >= sp->col_nslices)
        si = 0;
    return si;
}

/* check_mvset (vvc_mvs.c:88): 1 + *out when usable */
static int check_mvset(const SliceParams *sp, const int mv_col_in[2],
                       int lx_col, int ref_idx_col, int col_si,
                       int x_lx, int ref_idx_lx, int out[2])
{
    int cur_lt = sp->rpl_is_lt[x_lx][ref_idx_lx];
    const int32_t *col_is_lt = sp->col_rpl_is_lt + ((long)col_si * 2 + lx_col) * 16;
    const int32_t *col_poc_l = sp->col_rpl_poc + ((long)col_si * 2 + lx_col) * 16;
    int nrefs = sp->col_rpl_nrefs[col_si * 2 + lx_col];
    if (ref_idx_col < 0 || ref_idx_col >= nrefs)
        return 0;
    int col_lt = col_is_lt[ref_idx_col];
    if (cur_lt != col_lt)
        return 0;
    int col_poc_diff = sp->col_poc - col_poc_l[ref_idx_col];
    int cur_poc_diff = sp->poc - sp->rpl_poc[x_lx][ref_idx_lx];
    int mv_col[2] = { mv_col_in[0], mv_col_in[1] };
    mv_compression(mv_col);
    if (cur_lt || col_poc_diff == cur_poc_diff) {
        out[0] = mvs_clip(mv_col[0], -(1 << 17), (1 << 17) - 1);
        out[1] = mvs_clip(mv_col[1], -(1 << 17), (1 << 17) - 1);
    } else {
        mv_scale(out, mv_col, col_poc_diff, cur_poc_diff);
    }
    return 1;
}

/* derive_temporal_colocated_mvs (vvc_mvs.c:140) */
static int derive_temporal_col(const SliceParams *sp, const MvF *temp_col,
                               int col_si, int ref_idx_lx, int x_lx,
                               int sb_flag, int out[2])
{
    int pf = temp_col->pf;
    if (pf == PF_INTRA)
        return 0;
#define CHECK(l) check_mvset(sp, temp_col->mv[l], l, temp_col->ref[l], \
                             col_si, x_lx, ref_idx_lx, out)
    if (sb_flag) {
        if (x_lx == 0) {
            if (pf & PF_L0)
                return CHECK(0);
            if (mvs_no_backward_pred_flag(sp) && (pf & PF_L1))
                return CHECK(1);
        } else {
            if (pf & PF_L1)
                return CHECK(1);
            if (mvs_no_backward_pred_flag(sp) && (pf & PF_L0))
                return CHECK(0);
        }
        return 0;
    }
    if (!(pf & PF_L0))
        return CHECK(1);
    if (pf == PF_L0)
        return CHECK(0);
    /* PF_BI */
    if (mvs_no_backward_pred_flag(sp))
        return x_lx == 0 ? CHECK(0) : CHECK(1);
    return !sp->sh_collocated_from_l0 ? CHECK(0) : CHECK(1);
#undef CHECK
}

/* temporal_luma_motion_vector (vvc_mvs.c:200): 1 + *out when available */
static int temporal_luma_mv(Parser *p, const int32_t *cu, int ref_idx_lx,
                            int x_lx, int check_center, int sb_flag,
                            int out[2])
{
    const SliceParams *sp = p->sp;
    if (!sp->colf_pf)
        return 0;
    if (!sp->ph_temporal_mvp || cu[CU_W] * cu[CU_H] <= 32)
        return 0;
    int ctb_log2 = sp->ctb_log2;
    int x = cu[CU_X0] + cu[CU_W];
    int y = cu[CU_Y0] + cu[CU_H];
    int got = 0;
    MvF temp_col;
    if ((cu[CU_Y0] >> ctb_log2) == (y >> ctb_log2) &&
        y < sp->sps_height_max && x < sp->sps_width_max) {
        int xa = x & ~7, ya = y & ~7;
        col_get_mvf(sp, xa, ya, &temp_col);
        got = derive_temporal_col(sp, &temp_col, col_rpl_at(sp, xa, ya),
                                  ref_idx_lx, x_lx, sb_flag, out);
    }
    if (check_center && !got) {
        int xa = (cu[CU_X0] + (cu[CU_W] >> 1)) & ~7;
        int ya = (cu[CU_Y0] + (cu[CU_H] >> 1)) & ~7;
        col_get_mvf(sp, xa, ya, &temp_col);
        got = derive_temporal_col(sp, &temp_col, col_rpl_at(sp, xa, ya),
                                  ref_idx_lx, x_lx, sb_flag, out);
    }
    return got;
}

/* ---- merge mode (mvs.py:292-440) ---------------------------------------- */

typedef struct {
    MvF nb[7];
    int nb_valid[7];
} NbList;

static const MvF *nbget(const NbList *nl, int idx)
{
    if (idx < 0 || !nl->nb_valid[idx])
        return 0;
    return &nl->nb[idx];
}

static int merge_spatial(Parser *p, const int32_t *cu, int merge_idx,
                         NbList *nl, MvF *cand, int *n_cand)
{
    Nbs nbs;
    neighbours(p, cu, &nbs);
    static const int seq[4][2] = { {NB_B1, -1}, {NB_A1, NB_B1},
                                   {NB_B0, NB_B1}, {NB_A0, NB_A1} };
    for (int s = 0; s < 4; s++) {
        int nb = seq[s][0], old = seq[s][1];
        if (check_available(p, cu, &nbs, nb, 0)) {
            mvs_get_mvf(p->sp, nbs.x[nb], nbs.y[nb], &nl->nb[nb]);
            nl->nb_valid[nb] = 1;
            if (!same_mv_ref(&nl->nb[nb], nbget(nl, old))) {
                cand[(*n_cand)++] = nl->nb[nb];
                if (merge_idx == *n_cand - 1)
                    return 1;
            }
        }
    }
    if (*n_cand != 4) {
        if (check_available(p, cu, &nbs, NB_B2, 0)) {
            MvF c;
            mvs_get_mvf(p->sp, nbs.x[NB_B2], nbs.y[NB_B2], &c);
            if (!same_mv_ref(&c, nbget(nl, NB_A1)) &&
                !same_mv_ref(&c, nbget(nl, NB_B1))) {
                cand[(*n_cand)++] = c;
                if (merge_idx == *n_cand - 1)
                    return 1;
            }
        }
    }
    return 0;
}

static int merge_temporal(Parser *p, const int32_t *cu, MvF *out)
{
    const SliceParams *sp = p->sp;
    mvf_clear(out);
    if (sp->ph_temporal_mvp && cu[CU_W] * cu[CU_H] > 32) {
        int mv0[2], mv1[2];
        int got0 = temporal_luma_mv(p, cu, 0, 0, 1, 0, mv0);
        int got1 = sp->is_b ? temporal_luma_mv(p, cu, 0, 1, 1, 0, mv1) : 0;
        out->pf = got0 + (got1 << 1);
        if (got0) { out->mv[0][0] = mv0[0]; out->mv[0][1] = mv0[1]; }
        if (got1) { out->mv[1][0] = mv1[0]; out->mv[1][1] = mv1[1]; }
    }
    return out->pf != 0;
}

static void hmvp_load(const SliceState *st, int i, MvF *f)
{
    const int *h = st->hmvp[i];
    f->pf = h[0];
    f->mv[0][0] = h[1]; f->mv[0][1] = h[2];
    f->mv[1][0] = h[3]; f->mv[1][1] = h[4];
    f->ref[0] = h[5]; f->ref[1] = h[6];
    f->bcw = h[7]; f->hpel = h[8]; f->ciip = h[9];
}

static void hmvp_store(SliceState *st, int i, const MvF *f)
{
    int *h = st->hmvp[i];
    h[0] = f->pf;
    h[1] = f->mv[0][0]; h[2] = f->mv[0][1];
    h[3] = f->mv[1][0]; h[4] = f->mv[1][1];
    h[5] = f->ref[0]; h[6] = f->ref[1];
    h[7] = f->bcw; h[8] = f->hpel; h[9] = f->ciip;
}

static int merge_history(Parser *p, int merge_idx, const NbList *nl,
                         MvF *cand, int *n_cand)
{
    const SliceState *st = p->st;
    int max_cand = p->sp->max_num_merge_cand;
    for (int i = 1; i <= st->hmvp_len && *n_cand < max_cand - 1; i++) {
        MvF h;
        hmvp_load(st, st->hmvp_len - i, &h);
        int same = i <= 2 && (same_mv_ref(&h, nbget(nl, NB_A1)) ||
                              same_mv_ref(&h, nbget(nl, NB_B1)));
        if (!same) {
            cand[(*n_cand)++] = h;
            if (merge_idx == *n_cand - 1)
                return 1;
        }
    }
    return 0;
}

static int merge_pairwise(MvF *cand, int *n_cand, int is_b)
{
    if (*n_cand <= 1)
        return 0;
    const MvF *p0 = &cand[0], *p1 = &cand[1];
    MvF c;
    mvf_clear(&c);
    for (int i = 0; i < (is_b ? 2 : 1); i++) {
        int mask = i + 1;
        if (p0->pf & mask) {
            c.pf |= mask;
            c.ref[i] = p0->ref[i];
            if (p1->pf & mask) {
                int mv[2] = { p0->mv[i][0] + p1->mv[i][0],
                              p0->mv[i][1] + p1->mv[i][1] };
                mvs_round_mv(mv, 0, 1);
                c.mv[i][0] = mv[0]; c.mv[i][1] = mv[1];
            } else {
                c.mv[i][0] = p0->mv[i][0]; c.mv[i][1] = p0->mv[i][1];
            }
        } else if (p1->pf & mask) {
            c.pf |= mask;
            c.mv[i][0] = p1->mv[i][0]; c.mv[i][1] = p1->mv[i][1];
            c.ref[i] = p1->ref[i];
        }
    }
    if (c.pf) {
        c.hpel = p0->hpel == p1->hpel ? p0->hpel : 0;
        cand[(*n_cand)++] = c;
        return 1;
    }
    return 0;
}

static void merge_zero(Parser *p, int merge_idx, MvF *cand, int *n_cand)
{
    const SliceParams *sp = p->sp;
    int is_b = sp->is_b;
    int num_ref = sp->is_p ? sp->num_ref_idx_active[L0]
                           : mvs_imin(sp->num_ref_idx_active[L0],
                                      sp->num_ref_idx_active[L1]);
    int zero_idx = 0;
    while (*n_cand < sp->max_num_merge_cand) {
        MvF c;
        mvf_clear(&c);
        c.pf = PF_L0 + (is_b << 1);
        int ri = zero_idx < num_ref ? zero_idx : 0;
        c.ref[0] = ri; c.ref[1] = ri;
        cand[(*n_cand)++] = c;
        if (merge_idx == *n_cand - 1)
            return;
        zero_idx++;
    }
}

/* mv_merge_mode (vvc_mvs.c:785): list valid through merge_idx */
static int mv_merge_mode(Parser *p, const int32_t *cu, int merge_idx,
                         MvF *cand)
{
    int n_cand = 0;
    NbList nl;
    memset(&nl, 0, sizeof(nl));
    if (merge_spatial(p, cu, merge_idx, &nl, cand, &n_cand))
        return n_cand;
    MvF tc;
    if (merge_temporal(p, cu, &tc)) {
        cand[n_cand++] = tc;
        if (merge_idx == n_cand - 1)
            return n_cand;
    }
    if (merge_history(p, merge_idx, &nl, cand, &n_cand))
        return n_cand;
    if (merge_pairwise(cand, &n_cand, p->sp->is_b)) {
        if (merge_idx == n_cand - 1)
            return n_cand;
    }
    merge_zero(p, merge_idx, cand, &n_cand);
    return n_cand;
}

void mvs_luma_mv_merge_mode(Parser *p, const int32_t *cu, int merge_idx,
                            int ciip_flag, MvF *out)
{
    MvF cand[8];
    vvcp_set_neighbour_available(p, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
    mv_merge_mode(p, cu, merge_idx, cand);
    *out = cand[merge_idx];
    out->ciip = ciip_flag;
}

void mvs_luma_mv_merge_gpm(Parser *p, const int32_t *cu,
                           const int merge_gpm_idx[2], MvF out[2])
{
    MvF cand[8];
    vvcp_set_neighbour_available(p, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
    int idx[2] = { merge_gpm_idx[0],
                   merge_gpm_idx[1] + (merge_gpm_idx[1] >= merge_gpm_idx[0]) };
    mv_merge_mode(p, cu, mvs_imax(idx[0], idx[1]), cand);
    for (int i = 0; i < 2; i++) {
        int lx = idx[i] & 1;
        int mask = lx + PF_L0;
        const MvF *c = &cand[idx[i]];
        if (!(c->pf & mask)) {
            lx = 1 - lx;
            mask = lx + PF_L0;
        }
        mvf_clear(&out[i]);
        out[i].pf = mask;
        out[i].ref[lx] = c->ref[lx];
        out[i].mv[lx][0] = c->mv[lx][0];
        out[i].mv[lx][1] = c->mv[lx][1];
    }
}

/* ff_vvc_store_gpm_mvf (vvc_mvs.c:449) */
void mvs_store_gpm_mvf(Parser *p, const int32_t *cu, InterPU *pu)
{
    const SliceParams *sp = p->sp;
    int w = cu[CU_W], h = cu[CU_H];
    int angle_idx = sp->gpm_angle_idx[pu->gpm_part];
    int distance_idx = sp->gpm_distance_idx[pu->gpm_part];
    int displacement_x = sp->gpm_distance_lut[angle_idx];
    int displacement_y = sp->gpm_distance_lut[(angle_idx + 8) % 32];
    int is_flip = angle_idx >= 13 && angle_idx <= 27;
    int shift_hor = (angle_idx % 16 == 8 ||
                     (angle_idx % 16 && h >= w)) ? 0 : 1;
    int sign = angle_idx < 16 ? 1 : -1;
    int off_x = (-w) >> 1;
    int off_y = (-h) >> 1;
    if (!shift_hor)
        off_y += sign * ((distance_idx * h) >> 3);
    else
        off_x += sign * ((distance_idx * w) >> 3);
    int pred_flag = pu->gpm_mv[0].pf | pu->gpm_mv[1].pf;
    for (int y = 0; y < h; y += 4) {
        for (int x = 0; x < w; x += 4) {
            int motion_idx = (((x + off_x) << 1) + 5) * displacement_x +
                             (((y + off_y) << 1) + 5) * displacement_y;
            int abs_mi = motion_idx < 0 ? -motion_idx : motion_idx;
            int s_type = abs_mi < 32 ? 2
                       : (motion_idx <= 0 ? (1 - is_flip) : is_flip);
            int x0 = cu[CU_X0] + x, y0 = cu[CU_Y0] + y;
            if (!s_type) {
                mvs_set_mvf(sp, x0, y0, 4, 4, &pu->gpm_mv[0]);
            } else if (s_type == 1 || (s_type == 2 && pred_flag != PF_BI)) {
                mvs_set_mvf(sp, x0, y0, 4, 4, &pu->gpm_mv[1]);
            } else {
                MvF mvf = pu->gpm_mv[0];
                const MvF *mv1 = &pu->gpm_mv[1];
                int lx = mv1->pf - PF_L0;
                mvf.pf = PF_BI;
                mvf.ref[lx] = mv1->ref[lx];
                mvf.mv[lx][0] = mv1->mv[lx][0];
                mvf.mv[lx][1] = mv1->mv[lx][1];
                mvs_set_mvf(sp, x0, y0, 4, 4, &mvf);
            }
        }
    }
}

/* derive_mmvd (vvc_ctu.c:1244) */
void mvs_derive_mmvd(Parser *p, MvF *mvf, const int mmvd_offset[2])
{
    const SliceParams *sp = p->sp;
    int mmvd[2][2] = { { mmvd_offset[0], mmvd_offset[1] },
                       { mmvd_offset[0], mmvd_offset[1] } };
    if (mvf->pf == PF_BI) {
        int rp[2] = { sp->poc - sp->rpl_poc[0][mvf->ref[0]],
                      sp->poc - sp->rpl_poc[1][mvf->ref[1]] };
        if (rp[0] == rp[1]) {
            /* nothing */
        } else {
            int i = (rp[0] < 0 ? -rp[0] : rp[0]) >=
                    (rp[1] < 0 ? -rp[1] : rp[1]) ? 0 : 1;
            int o = 1 - i;
            if (sp->rpl_is_lt[0][mvf->ref[0]] ||
                sp->rpl_is_lt[1][mvf->ref[1]]) {
                int same = rp[0] * rp[1] > 0;
                mmvd[o][0] = same ? mmvd[i][0] : -mmvd[i][0];
                mmvd[o][1] = same ? mmvd[i][1] : -mmvd[i][1];
            } else {
                mv_scale(mmvd[o], mmvd[i], rp[i], rp[o]);
            }
        }
        mvf->mv[0][0] += mmvd[0][0];
        mvf->mv[0][1] += mmvd[0][1];
        mvf->mv[1][0] += mmvd[1][0];
        mvf->mv[1][1] += mmvd[1][1];
    } else {
        int idx = mvf->pf - PF_L0;
        mvf->mv[idx][0] += mmvd_offset[0];
        mvf->mv[idx][1] += mmvd_offset[1];
    }
}

/* ---- AMVP (mvs.py:444-526) ---------------------------------------------- */

static int mvp_candidate(Parser *p, int x, int y, int lx, const int ref_idx[2],
                         int out[2])
{
    const SliceParams *sp = p->sp;
    MvF f;
    mvs_get_mvf(sp, x, y, &f);
    int poc = sp->rpl_poc[lx][ref_idx[lx]];
    if ((f.pf & (lx + 1)) && sp->rpl_poc[lx][f.ref[lx]] == poc) {
        out[0] = f.mv[lx][0]; out[1] = f.mv[lx][1];
        return 1;
    }
    int ly = 1 - lx;
    if ((f.pf & (ly + 1)) && sp->rpl_poc[ly][f.ref[ly]] == poc) {
        out[0] = f.mv[ly][0]; out[1] = f.mv[ly][1];
        return 1;
    }
    return 0;
}

static int mvp_from_nbs(Parser *p, const int32_t *cu, const Nbs *nbs,
                        const int *idxs, int n_idx, int lx,
                        const int ref_idx[2], int amvr_shift, int out[2])
{
    for (int k = 0; k < n_idx; k++) {
        int nb = idxs[k];
        if (check_available(p, cu, nbs, nb, 1)) {
            if (mvp_candidate(p, nbs->x[nb], nbs->y[nb], lx, ref_idx, out)) {
                mvs_round_mv(out, amvr_shift, amvr_shift);
                return 1;
            }
        }
    }
    return 0;
}

static int mvp_history(Parser *p, int mvp_lx_flag, int lx, int ref_idx_val,
                       int amvr_shift, int num_cands, int out[2])
{
    const SliceParams *sp = p->sp;
    const SliceState *st = p->st;
    int poc = sp->rpl_poc[lx][ref_idx_val];
    if (!st->hmvp_len)
        return 0;
    int n = mvs_imin(4, st->hmvp_len);
    for (int i = 1; i <= n; i++) {
        MvF h;
        hmvp_load(st, i - 1, &h);
        for (int j = 0; j < 2; j++) {
            int ly = j ? (1 - lx) : lx;
            if ((h.pf & (PF_L0 + ly)) && poc == sp->rpl_poc[ly][h.ref[ly]]) {
                if (mvp_lx_flag == num_cands) {
                    out[0] = h.mv[ly][0]; out[1] = h.mv[ly][1];
                    mvs_round_mv(out, amvr_shift, amvr_shift);
                    return 1;
                }
                num_cands++;
            }
        }
    }
    return 0;
}

/* mvp (vvc_mvs.c:1569) */
static void mvp(Parser *p, const int32_t *cu, int mvp_lx_flag, int lx,
                const int ref_idx[2], int amvr_shift, int out[2])
{
    Nbs nbs;
    neighbours(p, cu, &nbs);
    int num_cands = 0;
    int mv_a[2];
    int have_a = 0;
    static const int seq_a[2] = { NB_A0, NB_A1 };
    static const int seq_b[3] = { NB_B0, NB_B1, NB_B2 };
    int mv[2];
    if (mvp_from_nbs(p, cu, &nbs, seq_a, 2, lx, ref_idx, amvr_shift, mv)) {
        if (mvp_lx_flag == num_cands) {
            out[0] = mv[0]; out[1] = mv[1];
            return;
        }
        num_cands++;
        mv_a[0] = mv[0]; mv_a[1] = mv[1];
        have_a = 1;
    }
    if (mvp_from_nbs(p, cu, &nbs, seq_b, 3, lx, ref_idx, amvr_shift, mv)) {
        if (!have_a || mv_a[0] != mv[0] || mv_a[1] != mv[1]) {
            if (mvp_lx_flag == num_cands) {
                out[0] = mv[0]; out[1] = mv[1];
                return;
            }
            num_cands++;
        }
    }
    int tmv[2];
    if (temporal_luma_mv(p, cu, ref_idx[lx], lx, 1, 0, tmv)) {
        if (mvp_lx_flag == num_cands) {
            mvs_round_mv(tmv, amvr_shift, amvr_shift);
            out[0] = tmv[0]; out[1] = tmv[1];
            return;
        }
        num_cands++;
    }
    if (mvp_history(p, mvp_lx_flag, lx, ref_idx[lx], amvr_shift, num_cands,
                    mv)) {
        out[0] = mv[0]; out[1] = mv[1];
        return;
    }
    out[0] = 0; out[1] = 0;
}

void mvs_ff_mvp(Parser *p, const int32_t *cu, const int mvp_lx_flag[2],
                int amvr_shift, InterPU *pu)
{
    pu->nsbx = pu->nsby = 1;
    vvcp_set_neighbour_available(p, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
    if (pu->mi_pf != PF_L1)
        mvp(p, cu, mvp_lx_flag[L0], L0, pu->mi_ref, amvr_shift,
            pu->mi_mv[L0][0]);
    if (pu->mi_pf != PF_L0)
        mvp(p, cu, mvp_lx_flag[L1], L1, pu->mi_ref, amvr_shift,
            pu->mi_mv[L1][0]);
}

/* ---- affine (mvs.py:530-1076) ------------------------------------------- */

static void get_cp_mv(const SliceParams *sp, int lx, int x, int y, int cp_idx,
                      int out[2])
{
    long i = ((((long)lx * sp->h4 + (y >> 2)) * sp->w4 + (x >> 2)) * 3 +
              cp_idx) * 2;
    out[0] = sp->cp_mv[i];
    out[1] = sp->cp_mv[i + 1];
}

/* 8.5.5.5 (vvc_mvs.c:844): CPs inherited from an affine neighbour */
static void affine_cps_from_nb(Parser *p, const int32_t *cu, int x_nb,
                               int y_nb, int nbw, int nbh, int lx,
                               int num_cps, int cps[3][2])
{
    const SliceParams *sp = p->sp;
    int x0 = cu[CU_X0], y0 = cu[CU_Y0];
    int cbw = cu[CU_W], cbh = cu[CU_H];
    int log2_nbw = 31 - __builtin_clz((unsigned)nbw);
    int log2_nbh = 31 - __builtin_clz((unsigned)nbh);
    int ctb_size = 1 << sp->ctb_log2;
    int is_ctb_boundary = ((y_nb + nbh) % ctb_size) == 0 &&
                          (y_nb + nbh == y0);
    int motion_model_idc_nb = 0;
    int l[2], r[2];
    if (is_ctb_boundary) {
        MvF fl, fr;
        mvs_get_mvf(sp, x_nb, y_nb + nbh - 1, &fl);
        mvs_get_mvf(sp, x_nb + nbw - 1, y_nb + nbh - 1, &fr);
        l[0] = fl.mv[lx][0]; l[1] = fl.mv[lx][1];
        r[0] = fr.mv[lx][0]; r[1] = fr.mv[lx][1];
    } else {
        motion_model_idc_nb =
            sp->mmi[(long)(y_nb >> 2) * sp->w4 + (x_nb >> 2)];
        get_cp_mv(sp, lx, x_nb, y_nb, 0, l);
        get_cp_mv(sp, lx, x_nb + nbw - 1, y_nb, 1, r);
    }
    long long mv_scale_hor = (long long)l[0] << 7;
    long long mv_scale_ver = (long long)l[1] << 7;
    long long d_hor_x = (long long)(r[0] - l[0]) << (7 - log2_nbw);
    long long d_ver_x = (long long)(r[1] - l[1]) << (7 - log2_nbw);
    long long d_hor_y, d_ver_y;
    if (!is_ctb_boundary && motion_model_idc_nb == 2) {
        int lb[2];
        get_cp_mv(sp, lx, x_nb, y_nb + nbh - 1, 2, lb);
        d_hor_y = (long long)(lb[0] - l[0]) << (7 - log2_nbh);
        d_ver_y = (long long)(lb[1] - l[1]) << (7 - log2_nbh);
    } else {
        d_hor_y = -d_ver_x;
        d_ver_y = d_hor_x;
    }
    if (is_ctb_boundary)
        y_nb = y0;
    int pts[3][2] = { { x0, y0 }, { x0 + cbw, y0 }, { x0, y0 + cbh } };
    for (int k = 0; k < num_cps; k++) {
        int px = pts[k][0], py = pts[k][1];
        long long cx = mv_scale_hor + d_hor_x * (px - x_nb) +
                       d_hor_y * (py - y_nb);
        long long cy = mv_scale_ver + d_ver_x * (px - x_nb) +
                       d_ver_y * (py - y_nb);
        /* round_mv(cp, 0, 7) on 64-bit then clip to MV range */
        long long offs = 1 << 6;
        cx = (cx + offs - (cx >= 0)) >> 7;
        cy = (cy + offs - (cy >= 0)) >> 7;
        cps[k][0] = (int)mvs_llclip(cx, -(1 << 17), (1 << 17) - 1);
        cps[k][1] = (int)mvs_llclip(cy, -(1 << 17), (1 << 17) - 1);
    }
}

/* affine_neighbour_cb (vvc_mvs.c:906) */
static int affine_neighbour_cb(const SliceParams *sp, int x_nb, int y_nb,
                               int *x, int *y, int *w, int *h)
{
    long i = (long)(y_nb >> 2) * sp->w4 + (x_nb >> 2);
    int mmi = sp->mmi[i];
    if (mmi) {
        *x = sp->cb_pos_x0[i];
        *y = sp->cb_pos_y0[i];
        *w = sp->cb_width0[i];
        *h = sp->cb_height0[i];
    }
    return mmi;
}

static int affine_merge_candidate(Parser *p, const int32_t *cu, int x_cand,
                                  int y_cand, InterPU *pu)
{
    const SliceParams *sp = p->sp;
    int x, y, w, h;
    int mmi = affine_neighbour_cb(sp, x_cand, y_cand, &x, &y, &w, &h);
    if (mmi) {
        MvF mvf;
        mvs_get_mvf(sp, x, y, &mvf);
        pu->mi_bcw = mvf.bcw;
        pu->mi_pf = mvf.pf;
        for (int i = 0; i < 2; i++) {
            if (pu->mi_pf & (i + 1)) {
                int cps[3][2];
                affine_cps_from_nb(p, cu, x, y, w, h, i, mmi + 1, cps);
                for (int j = 0; j < mmi + 1; j++) {
                    pu->mi_mv[i][j][0] = cps[j][0];
                    pu->mi_mv[i][j][1] = cps[j][1];
                }
            }
            pu->mi_ref[i] = mvf.ref[i];
        }
        pu->mi_mmi = mmi;
    }
    return mmi;
}

static int affine_merge_from_nbs(Parser *p, const int32_t *cu, const Nbs *nbs,
                                 const int *idxs, int n_idx, InterPU *pu)
{
    for (int k = 0; k < n_idx; k++) {
        int nb = idxs[k];
        if (check_available(p, cu, nbs, nb, 0) &&
            affine_merge_candidate(p, cu, nbs->x[nb], nbs->y[nb], pu))
            return 1;
    }
    return 0;
}

static int derive_corner_mvf(Parser *p, const int32_t *cu, const Nbs *nbs,
                             const int *idxs, int n_idx, MvF *out)
{
    for (int k = 0; k < n_idx; k++) {
        int nb = idxs[k];
        if (check_available(p, cu, nbs, nb, 0)) {
            mvs_get_mvf(p->sp, nbs->x[nb], nbs->y[nb], out);
            return 1;
        }
    }
    return 0;
}

static int compare_pf_ref_idx(const MvF *a, const MvF *b, const MvF *c,
                              int lx)
{
    int mask = (lx + 1) & a->pf;
    if (!(b->pf & mask))
        return 0;
    if (a->ref[lx] != b->ref[lx])
        return 0;
    if (c) {
        if (!(c->pf & mask))
            return 0;
        if (a->ref[lx] != c->ref[lx])
            return 0;
    }
    return 1;
}

/* affine_merge_const1..6 (vvc_mvs.c:1112-1266); c[] entries may be NULL */
static int affine_merge_const(int which, const MvF *const *c, int n_c,
                              InterPU *pu, int cb_width, int cb_height)
{
    for (int i = 0; i < n_c; i++)
        if (!c[i])
            return 0;
    pu->mi_pf = 0;
    for (int i = 0; i < 2; i++) {
        int mask = i + 1;
        const MvF *cmp3 = n_c == 3 ? c[2] : 0;
        if (compare_pf_ref_idx(c[0], c[1], cmp3, i)) {
            pu->mi_pf |= mask;
            pu->mi_ref[i] = c[0]->ref[i];
            int (*mv)[2] = pu->mi_mv[i];
            if (which == 1) {
                mv[0][0] = c[0]->mv[i][0]; mv[0][1] = c[0]->mv[i][1];
                mv[1][0] = c[1]->mv[i][0]; mv[1][1] = c[1]->mv[i][1];
                mv[2][0] = c[2]->mv[i][0]; mv[2][1] = c[2]->mv[i][1];
            } else if (which == 2) {
                mv[0][0] = c[0]->mv[i][0]; mv[0][1] = c[0]->mv[i][1];
                mv[1][0] = c[1]->mv[i][0]; mv[1][1] = c[1]->mv[i][1];
                int m[2] = { c[2]->mv[i][0] + c[0]->mv[i][0] - c[1]->mv[i][0],
                             c[2]->mv[i][1] + c[0]->mv[i][1] - c[1]->mv[i][1] };
                clip_mv(m);
                mv[2][0] = m[0]; mv[2][1] = m[1];
            } else if (which == 3) {
                mv[0][0] = c[0]->mv[i][0]; mv[0][1] = c[0]->mv[i][1];
                int m[2] = { c[2]->mv[i][0] + c[0]->mv[i][0] - c[1]->mv[i][0],
                             c[2]->mv[i][1] + c[0]->mv[i][1] - c[1]->mv[i][1] };
                clip_mv(m);
                mv[1][0] = m[0]; mv[1][1] = m[1];
                mv[2][0] = c[1]->mv[i][0]; mv[2][1] = c[1]->mv[i][1];
            } else if (which == 4) {
                int m[2] = { c[0]->mv[i][0] + c[1]->mv[i][0] - c[2]->mv[i][0],
                             c[0]->mv[i][1] + c[1]->mv[i][1] - c[2]->mv[i][1] };
                clip_mv(m);
                mv[0][0] = m[0]; mv[0][1] = m[1];
                mv[1][0] = c[0]->mv[i][0]; mv[1][1] = c[0]->mv[i][1];
                mv[2][0] = c[1]->mv[i][0]; mv[2][1] = c[1]->mv[i][1];
            } else if (which == 5) {
                mv[0][0] = c[0]->mv[i][0]; mv[0][1] = c[0]->mv[i][1];
                mv[1][0] = c[1]->mv[i][0]; mv[1][1] = c[1]->mv[i][1];
            } else {  /* 6 */
                int log2w = 31 - __builtin_clz((unsigned)cb_width);
                int log2h = 31 - __builtin_clz((unsigned)cb_height);
                int shift = 7 + log2w - log2h;
                mv[0][0] = c[0]->mv[i][0]; mv[0][1] = c[0]->mv[i][1];
                long long mx = ((long long)c[0]->mv[i][0] << 7) +
                    ((long long)(c[1]->mv[i][1] - c[0]->mv[i][1]) << shift);
                long long my = ((long long)c[0]->mv[i][1] << 7) -
                    ((long long)(c[1]->mv[i][0] - c[0]->mv[i][0]) << shift);
                long long offs = 1 << 6;
                mx = (mx + offs - (mx >= 0)) >> 7;
                my = (my + offs - (my >= 0)) >> 7;
                mv[1][0] = (int)mvs_llclip(mx, -(1 << 17), (1 << 17) - 1);
                mv[1][1] = (int)mvs_llclip(my, -(1 << 17), (1 << 17) - 1);
            }
        }
    }
    if (pu->mi_pf) {
        if (which == 1 || which == 5 || which == 6) {
            if (pu->mi_pf == PF_BI)
                pu->mi_bcw = c[0]->bcw;
        } else {
            pu->mi_bcw = pu->mi_pf == PF_BI ? c[0]->bcw : 0;
        }
        pu->mi_mmi = which <= 4 ? 2 : 1;
        return 1;
    }
    return 0;
}

/* 8.5.5.6 (vvc_mvs.c:1275) */
static int affine_merge_const_candidates(Parser *p, const int32_t *cu,
                                         InterPU *pu, const Nbs *nbs,
                                         int merge_subblock_idx,
                                         int num_cands)
{
    const SliceParams *sp = p->sp;
    MvF c0s, c1s, c2s, c3s;
    static const int i0[3] = { NB_B2, NB_B3, NB_A2 };
    static const int i1[2] = { NB_B1, NB_B0 };
    static const int i2[2] = { NB_A1, NB_A0 };
    const MvF *c0 = derive_corner_mvf(p, cu, nbs, i0, 3, &c0s) ? &c0s : 0;
    const MvF *c1 = derive_corner_mvf(p, cu, nbs, i1, 2, &c1s) ? &c1s : 0;
    const MvF *c2 = derive_corner_mvf(p, cu, nbs, i2, 2, &c2s) ? &c2s : 0;
    if (sp->sps_6param_affine) {
        const MvF *cc1[3] = { c0, c1, c2 };
        if (affine_merge_const(1, cc1, 3, pu, 0, 0)) {
            if (merge_subblock_idx == num_cands)
                return 1;
            num_cands++;
        }
        const MvF *c3 = 0;
        if (sp->ph_temporal_mvp) {
            int mv0[2], mv1[2];
            int got0 = temporal_luma_mv(p, cu, 0, 0, 0, 0, mv0);
            int got1 = sp->is_b ? temporal_luma_mv(p, cu, 0, 1, 0, 0, mv1)
                                : 0;
            mvf_clear(&c3s);
            c3s.pf = got0 + (got1 << 1);
            if (got0) { c3s.mv[0][0] = mv0[0]; c3s.mv[0][1] = mv0[1]; }
            if (got1) { c3s.mv[1][0] = mv1[0]; c3s.mv[1][1] = mv1[1]; }
            if (c3s.pf)
                c3 = &c3s;
        }
        const MvF *cc2[3] = { c0, c1, c3 };
        if (affine_merge_const(2, cc2, 3, pu, 0, 0)) {
            if (merge_subblock_idx == num_cands)
                return 1;
            num_cands++;
        }
        const MvF *cc3[3] = { c0, c2, c3 };
        if (affine_merge_const(3, cc3, 3, pu, 0, 0)) {
            if (merge_subblock_idx == num_cands)
                return 1;
            num_cands++;
        }
        const MvF *cc4[3] = { c1, c2, c3 };
        if (affine_merge_const(4, cc4, 3, pu, 0, 0)) {
            if (merge_subblock_idx == num_cands)
                return 1;
            num_cands++;
        }
    }
    const MvF *cc5[2] = { c0, c1 };
    if (affine_merge_const(5, cc5, 2, pu, 0, 0)) {
        if (merge_subblock_idx == num_cands)
            return 1;
        num_cands++;
    }
    const MvF *cc6[2] = { c0, c2 };
    if (affine_merge_const(6, cc6, 2, pu, cu[CU_W], cu[CU_H])) {
        if (merge_subblock_idx == num_cands)
            return 1;
    }
    return 0;
}

/* ---- SbTMVP (mvs.py:741-814) -------------------------------------------- */

static void sb_clip_location(const SliceParams *sp, int x_ctb, int y_ctb,
                             const int temp_mv[2], int x, int y,
                             int *ox, int *oy)
{
    int ctb = 1 << sp->ctb_log2;
    *oy = mvs_clip(y + temp_mv[1], y_ctb,
                   mvs_imin(sp->height - 1, y_ctb + ctb - 1)) & ~7;
    *ox = mvs_clip(x + temp_mv[0], x_ctb,
                   mvs_imin(sp->width - 1, x_ctb + ctb + 3)) & ~7;
}

/* sb_temproal_luma_motion (vvc_mvs.c:1008) */
static int sb_temporal_luma_motion(Parser *p, int x_ctb, int y_ctb,
                                   const int temp_mv[2], int x, int y,
                                   int mv_out[2][2])
{
    const SliceParams *sp = p->sp;
    int cx, cy;
    sb_clip_location(sp, x_ctb, y_ctb, temp_mv, x, y, &cx, &cy);
    MvF temp_col;
    col_get_mvf(sp, cx, cy, &temp_col);
    int si = col_rpl_at(sp, cx, cy);
    int mv0[2], mv1[2];
    int got0 = derive_temporal_col(sp, &temp_col, si, 0, 0, 1, mv0);
    int pf = got0;
    mv_out[0][0] = got0 ? mv0[0] : 0;
    mv_out[0][1] = got0 ? mv0[1] : 0;
    mv_out[1][0] = 0; mv_out[1][1] = 0;
    if (sp->is_b) {
        int got1 = derive_temporal_col(sp, &temp_col, si, 0, 1, 1, mv1);
        pf |= got1 << 1;
        if (got1) { mv_out[1][0] = mv1[0]; mv_out[1][1] = mv1[1]; }
    }
    return pf;
}

/* 8.5.5.3 (vvc_mvs.c:1068) */
static int sb_temporal_merge_candidate(Parser *p, const int32_t *cu,
                                       const Nbs *nbs, InterPU *pu)
{
    const SliceParams *sp = p->sp;
    int ctb_log2 = sp->ctb_log2;
    int x0 = cu[CU_X0], y0 = cu[CU_Y0];
    int x_ctb = (x0 >> ctb_log2) << ctb_log2;
    int y_ctb = (y0 >> ctb_log2) << ctb_log2;
    if (!sp->ph_temporal_mvp || !sp->sps_sbtmvp ||
        (cu[CU_W] < 8 && cu[CU_H] < 8) || !sp->colf_pf)
        return 0;
    pu->nsbx = cu[CU_W] >> 3;
    pu->nsby = cu[CU_H] >> 3;
    MvF a1s;
    static const int ia1[1] = { NB_A1 };
    const MvF *a1 = derive_corner_mvf(p, cu, nbs, ia1, 1, &a1s) ? &a1s : 0;
    int temp_mv[2] = { 0, 0 };
    if (a1) {
        if ((a1->pf & PF_L0) && sp->col_poc == sp->rpl_poc[0][a1->ref[0]]) {
            temp_mv[0] = a1->mv[0][0]; temp_mv[1] = a1->mv[0][1];
        } else if ((a1->pf & PF_L1) &&
                   sp->col_poc == sp->rpl_poc[1][a1->ref[1]]) {
            temp_mv[0] = a1->mv[1][0]; temp_mv[1] = a1->mv[1][1];
        }
        mvs_round_mv(temp_mv, 0, 4);
    }
    int ctr_mv[2][2];
    int ctr_pf = sb_temporal_luma_motion(p, x_ctb, y_ctb, temp_mv,
                                         x0 + cu[CU_W] / 2,
                                         y0 + cu[CU_H] / 2, ctr_mv);
    if (!ctr_pf)
        return 0;
    int sbw = cu[CU_W] / pu->nsbx;
    int sbh = cu[CU_H] / pu->nsby;
    for (int sby = 0; sby < pu->nsby; sby++) {
        for (int sbx = 0; sbx < pu->nsbx; sbx++) {
            int x = x0 + sbx * sbw;
            int y = y0 + sby * sbh;
            int mv[2][2];
            int pf = sb_temporal_luma_motion(p, x_ctb, y_ctb, temp_mv,
                                             x + sbw / 2, y + sbh / 2, mv);
            MvF f;
            mvf_clear(&f);
            if (!pf) {
                pf = ctr_pf;
                memcpy(mv, ctr_mv, sizeof(mv));
            }
            f.pf = pf;
            f.mv[0][0] = mv[0][0]; f.mv[0][1] = mv[0][1];
            f.mv[1][0] = mv[1][0]; f.mv[1][1] = mv[1][1];
            mvs_set_mvf(sp, x, y, sbw, sbh, &f);
        }
    }
    return 1;
}

/* 8.5.5.2 (vvc_mvs.c:1346); returns 1 if SbCol selected (grid written) */
int mvs_sb_mv_merge_mode(Parser *p, const int32_t *cu, int merge_subblock_idx,
                         InterPU *pu)
{
    const SliceParams *sp = p->sp;
    vvcp_set_neighbour_available(p, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
    Nbs nbs;
    neighbours(p, cu, &nbs);
    int num_cands = 0;
    if (sb_temporal_merge_candidate(p, cu, &nbs, pu)) {
        if (merge_subblock_idx == num_cands)
            return 1;
        num_cands++;
    }
    pu->inter_affine = 1;
    pu->nsbx = cu[CU_W] >> 2;
    pu->nsby = cu[CU_H] >> 2;
    if (sp->sps_affine) {
        static const int ia[2] = { NB_A0, NB_A1 };
        static const int ib[3] = { NB_B0, NB_B1, NB_B2 };
        if (affine_merge_from_nbs(p, cu, &nbs, ia, 2, pu)) {
            if (merge_subblock_idx == num_cands)
                return 0;
            num_cands++;
        }
        if (affine_merge_from_nbs(p, cu, &nbs, ib, 3, pu)) {
            if (merge_subblock_idx == num_cands)
                return 0;
            num_cands++;
        }
        if (affine_merge_const_candidates(p, cu, pu, &nbs,
                                          merge_subblock_idx, num_cands))
            return 0;
    }
    /* zero affine (vvc_mvs.c:1268) */
    pu->mi_pf = PF_L0 + (sp->is_b << 1);
    pu->mi_bcw = 0;
    pu->mi_hpel = 0;
    pu->mi_ref[0] = pu->mi_ref[1] = 0;
    memset(pu->mi_mv, 0, sizeof(pu->mi_mv));
    pu->mi_mmi = 1;
    pu->nsbx = cu[CU_W] >> 2;
    pu->nsby = cu[CU_H] >> 2;
    return 0;
}

/* ---- subblock MV storage + PROF flags (mvs.py:859-977) ------------------ */

#define MAX_CU_DEPTH 7

typedef struct {
    long long d_hor_x, d_ver_x, d_hor_y, d_ver_y;
    long long mv_scale_hor, mv_scale_ver;
    int is_fallback;
} SbParams;

static int sb_is_fallback(const SbParams *sp, int pred_flag)
{
    long long a = 4 * (2048 + sp->d_hor_x);
    long long b = 4 * sp->d_hor_y;
    long long c = 4 * (2048 + sp->d_ver_y);
    long long d = 4 * sp->d_ver_x;
    if (pred_flag == PF_BI) {
        long long max_w4 = 0, min_w4 = 0, max_h4 = 0, min_h4 = 0;
        long long w_vals[3] = { a, b, a + b };
        long long h_vals[3] = { c, d, c + d };
        for (int i = 0; i < 3; i++) {
            if (w_vals[i] > max_w4) max_w4 = w_vals[i];
            if (w_vals[i] < min_w4) min_w4 = w_vals[i];
            if (h_vals[i] > max_h4) max_h4 = h_vals[i];
            if (h_vals[i] < min_h4) min_h4 = h_vals[i];
        }
        long long bx_w = ((max_w4 - min_w4) >> 11) + 9;
        long long bx_h = ((max_h4 - min_h4) >> 11) + 9;
        return bx_w * bx_h > 225;
    }
    long long aa = a < 0 ? -a : a, bb = b < 0 ? -b : b;
    long long cc = c < 0 ? -c : c, dd = d < 0 ? -d : d;
    long long bx_wxh = (aa >> 11) + 9;
    long long bx_hxh = (dd >> 11) + 9;
    long long bx_wxv = (bb >> 11) + 9;
    long long bx_hxv = (cc >> 11) + 9;
    return !(bx_wxh * bx_hxh <= 165 && bx_wxv * bx_hxv <= 165);
}

static void init_subblock_params(const InterPU *pu, int cb_width,
                                 int cb_height, int lx, SbParams *out)
{
    int log2_cbw = 31 - __builtin_clz((unsigned)cb_width);
    int log2_cbh = 31 - __builtin_clz((unsigned)cb_height);
    const int (*cp)[2] = pu->mi_mv[lx];
    int num_cp = pu->mi_mmi + 1;
    int D = MAX_CU_DEPTH;
    out->d_hor_x = (long long)(cp[1][0] - cp[0][0]) << (D - log2_cbw);
    out->d_ver_x = (long long)(cp[1][1] - cp[0][1]) << (D - log2_cbw);
    out->mv_scale_hor = (long long)cp[0][0] << D;
    out->mv_scale_ver = (long long)cp[0][1] << D;
    if (num_cp == 3) {
        out->d_hor_y = (long long)(cp[2][0] - cp[0][0]) << (D - log2_cbh);
        out->d_ver_y = (long long)(cp[2][1] - cp[0][1]) << (D - log2_cbh);
    } else {
        out->d_hor_y = -out->d_ver_x;
        out->d_ver_y = out->d_hor_x;
    }
    int pf = pu->mi_pf;
    out->is_fallback = sb_is_fallback(out, pf);
}

/* cb_prof_flag (vvc_mvs.c:361) — flag only; diff MVs recomputed at MC */
static int derive_prof_flag(const SliceParams *sp, const InterPU *pu,
                            const SbParams *sbp, int lx)
{
    int prof = !sp->ph_prof_disabled && !sbp->is_fallback;
    if (prof && pu->mi_mmi == 1 &&
        pu->mi_mv[lx][0][0] == pu->mi_mv[lx][1][0] &&
        pu->mi_mv[lx][0][1] == pu->mi_mv[lx][1][1])
        prof = 0;
    if (prof && pu->mi_mmi == 2 &&
        pu->mi_mv[lx][0][0] == pu->mi_mv[lx][1][0] &&
        pu->mi_mv[lx][0][1] == pu->mi_mv[lx][1][1] &&
        pu->mi_mv[lx][0][0] == pu->mi_mv[lx][2][0] &&
        pu->mi_mv[lx][0][1] == pu->mi_mv[lx][2][1])
        prof = 0;
    return prof;
}

static void store_cp_mv(const SliceParams *sp, const int32_t *cu,
                        const InterPU *pu, int lx)
{
    int num_cp = pu->mi_mmi + 1;
    int xa = cu[CU_X0] >> 2, xb = (cu[CU_X0] + cu[CU_W]) >> 2;
    int ya = cu[CU_Y0] >> 2, yb = (cu[CU_Y0] + cu[CU_H]) >> 2;
    for (int y = ya; y < yb; y++) {
        for (int x = xa; x < xb; x++) {
            long base = ((((long)lx * sp->h4 + y) * sp->w4 + x) * 3) * 2;
            for (int j = 0; j < num_cp; j++) {
                sp->cp_mv[base + j * 2] = pu->mi_mv[lx][j][0];
                sp->cp_mv[base + j * 2 + 1] = pu->mi_mv[lx][j][1];
            }
        }
    }
}

/* ff_vvc_store_sb_mvs (vvc_mvs.c:402) */
void mvs_store_sb_mvs(Parser *p, const int32_t *cu, InterPU *pu)
{
    const SliceParams *sp = p->sp;
    int sbw = cu[CU_W] / pu->nsbx;
    int sbh = cu[CU_H] / pu->nsby;
    SbParams params[2];
    MvF mvf;
    mvf_clear(&mvf);
    mvf.pf = pu->mi_pf;
    mvf.bcw = pu->mi_bcw;
    mvf.hpel = pu->mi_hpel;
    pu->prof[0] = pu->prof[1] = 0;
    for (int i = 0; i < 2; i++) {
        if (pu->mi_pf & (i + 1)) {
            store_cp_mv(sp, cu, pu, i);
            init_subblock_params(pu, cu[CU_W], cu[CU_H], i, &params[i]);
            pu->prof[i] = derive_prof_flag(sp, pu, &params[i], i);
            mvf.ref[i] = pu->mi_ref[i];
        }
    }
    int D = MAX_CU_DEPTH;
    for (int sby = 0; sby < pu->nsby; sby++) {
        for (int sbx = 0; sbx < pu->nsbx; sbx++) {
            int x0 = cu[CU_X0] + sbx * sbw;
            int y0 = cu[CU_Y0] + sby * sbh;
            for (int i = 0; i < 2; i++) {
                if (pu->mi_pf & (i + 1)) {
                    const SbParams *sbp = &params[i];
                    int x_pos = sbp->is_fallback ? (cu[CU_W] >> 1)
                                                 : (2 + (sbx << 2));
                    int y_pos = sbp->is_fallback ? (cu[CU_H] >> 1)
                                                 : (2 + (sby << 2));
                    long long mx = sbp->mv_scale_hor +
                        sbp->d_hor_x * x_pos + sbp->d_hor_y * y_pos;
                    long long my = sbp->mv_scale_ver +
                        sbp->d_ver_x * x_pos + sbp->d_ver_y * y_pos;
                    long long offs = 1 << (D - 1);
                    mx = (mx + offs - (mx >= 0)) >> D;
                    my = (my + offs - (my >= 0)) >> D;
                    mvf.mv[i][0] = (int)mvs_llclip(mx, -(1 << 17),
                                                   (1 << 17) - 1);
                    mvf.mv[i][1] = (int)mvs_llclip(my, -(1 << 17),
                                                   (1 << 17) - 1);
                }
            }
            mvs_set_mvf(sp, x0, y0, sbw, sbh, &mvf);
        }
    }
}

/* ---- affine AMVP (mvs.py:981-1093) -------------------------------------- */

static int affine_mvp_candidate(Parser *p, const int32_t *cu, int x_cand,
                                int y_cand, int lx, const int ref_idx[2],
                                int num_cp, int cps[3][2])
{
    const SliceParams *sp = p->sp;
    int x_nb, y_nb, nbw, nbh;
    int mmi = affine_neighbour_cb(sp, x_cand, y_cand, &x_nb, &y_nb, &nbw,
                                  &nbh);
    if (!mmi)
        return 0;
    MvF mvf;
    mvs_get_mvf(sp, x_nb, y_nb, &mvf);
    int poc = sp->rpl_poc[lx][ref_idx[lx]];
    if ((mvf.pf & (lx + 1)) && sp->rpl_poc[lx][mvf.ref[lx]] == poc) {
        affine_cps_from_nb(p, cu, x_nb, y_nb, nbw, nbh, lx, num_cp, cps);
        return 1;
    }
    int ly = 1 - lx;
    if ((mvf.pf & (ly + 1)) && sp->rpl_poc[ly][mvf.ref[ly]] == poc) {
        affine_cps_from_nb(p, cu, x_nb, y_nb, nbw, nbh, ly, num_cp, cps);
        return 1;
    }
    return 0;
}

static int affine_mvp_from_nbs(Parser *p, const int32_t *cu, const Nbs *nbs,
                               const int *idxs, int n_idx, int lx,
                               const int ref_idx[2], int amvr_shift,
                               int num_cp, int cps[3][2])
{
    for (int k = 0; k < n_idx; k++) {
        int nb = idxs[k];
        if (check_available(p, cu, nbs, nb, 1)) {
            if (affine_mvp_candidate(p, cu, nbs->x[nb], nbs->y[nb], lx,
                                     ref_idx, num_cp, cps)) {
                for (int j = 0; j < num_cp; j++)
                    mvs_round_mv(cps[j], amvr_shift, amvr_shift);
                return 1;
            }
        }
    }
    return 0;
}

static int affine_mvp_constructed_cp(Parser *p, const int32_t *cu,
                                     const Nbs *nbs, const int *idxs,
                                     int n_idx, int lx, int ref_idx_val,
                                     int amvr_shift, int cp[2])
{
    const SliceParams *sp = p->sp;
    int poc = sp->rpl_poc[lx][ref_idx_val];
    for (int k = 0; k < n_idx; k++) {
        int nb = idxs[k];
        if (check_available(p, cu, nbs, nb, 1)) {
            MvF mvf;
            mvs_get_mvf(sp, nbs->x[nb], nbs->y[nb], &mvf);
            int got = 0;
            if ((mvf.pf & (lx + 1)) && sp->rpl_poc[lx][mvf.ref[lx]] == poc) {
                cp[0] = mvf.mv[lx][0]; cp[1] = mvf.mv[lx][1];
                got = 1;
            } else {
                int ly = 1 - lx;
                if ((mvf.pf & (ly + 1)) &&
                    sp->rpl_poc[ly][mvf.ref[ly]] == poc) {
                    cp[0] = mvf.mv[ly][0]; cp[1] = mvf.mv[ly][1];
                    got = 1;
                }
            }
            if (got) {
                mvs_round_mv(cp, amvr_shift, amvr_shift);
                return 1;
            }
        }
    }
    return 0;
}

/* 8.5.5.7 (vvc_mvs.c:1662) */
static void affine_mvp(Parser *p, const int32_t *cu, int mvp_lx_flag, int lx,
                       const int ref_idx[2], int amvr_shift,
                       int motion_model_idc, int cps[3][2])
{
    int num_cp = motion_model_idc + 1;
    Nbs nbs;
    neighbours(p, cu, &nbs);
    int num_cands = 0;
    static const int ia[2] = { NB_A0, NB_A1 };
    static const int ib[3] = { NB_B0, NB_B1, NB_B2 };
    if (affine_mvp_from_nbs(p, cu, &nbs, ia, 2, lx, ref_idx, amvr_shift,
                            num_cp, cps)) {
        if (mvp_lx_flag == num_cands)
            return;
        num_cands++;
    }
    if (affine_mvp_from_nbs(p, cu, &nbs, ib, 3, lx, ref_idx, amvr_shift,
                            num_cp, cps)) {
        if (mvp_lx_flag == num_cands)
            return;
        num_cands++;
    }
    /* Const1 (vvc_mvs.c:1641) */
    static const int ic0[3] = { NB_B2, NB_B3, NB_A2 };
    static const int ic1[2] = { NB_B1, NB_B0 };
    static const int ic2[2] = { NB_A1, NB_A0 };
    int cp0[2] = { 0, 0 }, cp1[2] = { 0, 0 }, cp2[2] = { 0, 0 };
    int av0 = affine_mvp_constructed_cp(p, cu, &nbs, ic0, 3, lx, ref_idx[lx],
                                        amvr_shift, cp0);
    int av1 = affine_mvp_constructed_cp(p, cu, &nbs, ic1, 2, lx, ref_idx[lx],
                                        amvr_shift, cp1);
    int av2 = affine_mvp_constructed_cp(p, cu, &nbs, ic2, 2, lx, ref_idx[lx],
                                        amvr_shift, cp2);
    int av[3] = { av0, av1, av2 };
    int cps3[3][2] = { { cp0[0], cp0[1] }, { cp1[0], cp1[1] },
                       { cp2[0], cp2[1] } };
    if (av[0] && av[1] && (av[2] || motion_model_idc == 1)) {
        if (mvp_lx_flag == num_cands) {
            for (int j = 0; j < num_cp; j++) {
                cps[j][0] = cps3[j][0];
                cps[j][1] = cps3[j][1];
            }
            return;
        }
        num_cands++;
    }
    /* Const2: single available corner replicated */
    for (int i = 2; i >= 0; i--) {
        if (av[i]) {
            if (mvp_lx_flag == num_cands) {
                for (int j = 0; j < num_cp; j++) {
                    cps[j][0] = cps3[i][0];
                    cps[j][1] = cps3[i][1];
                }
                return;
            }
            num_cands++;
        }
    }
    int tmv[2];
    if (temporal_luma_mv(p, cu, ref_idx[lx], lx, 1, 0, tmv)) {
        if (mvp_lx_flag == num_cands) {
            mvs_round_mv(tmv, amvr_shift, amvr_shift);
            for (int j = 0; j < num_cp; j++) {
                cps[j][0] = tmv[0];
                cps[j][1] = tmv[1];
            }
            return;
        }
        num_cands++;
    }
    for (int j = 0; j < num_cp; j++) {
        cps[j][0] = 0;
        cps[j][1] = 0;
    }
}

void mvs_ff_affine_mvp(Parser *p, const int32_t *cu, const int mvp_lx_flag[2],
                       int amvr_shift, InterPU *pu)
{
    pu->nsbx = cu[CU_W] >> 2;
    pu->nsby = cu[CU_H] >> 2;
    vvcp_set_neighbour_available(p, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
    int cps[3][2];
    if (pu->mi_pf != PF_L1) {
        affine_mvp(p, cu, mvp_lx_flag[L0], L0, pu->mi_ref, amvr_shift,
                   pu->mi_mmi, cps);
        for (int j = 0; j < pu->mi_mmi + 1; j++) {
            pu->mi_mv[L0][j][0] = cps[j][0];
            pu->mi_mv[L0][j][1] = cps[j][1];
        }
    }
    if (pu->mi_pf != PF_L0) {
        affine_mvp(p, cu, mvp_lx_flag[L1], L1, pu->mi_ref, amvr_shift,
                   pu->mi_mmi, cps);
        for (int j = 0; j < pu->mi_mmi + 1; j++) {
            pu->mi_mv[L1][j][0] = cps[j][0];
            pu->mi_mv[L1][j][1] = cps[j][1];
        }
    }
}

/* ---- HMVP update (mvs.py:1097-1112) ------------------------------------- */

void mvs_update_hmvp(Parser *p, const int32_t *cu)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    int pl = sp->log2_parallel_merge_level;
    int x_br = cu[CU_X0] + cu[CU_W], y_br = cu[CU_Y0] + cu[CU_H];
    if (!((x_br >> pl) > (cu[CU_X0] >> pl) &&
          (y_br >> pl) > (cu[CU_Y0] >> pl)))
        return;
    MvF mvf;
    mvs_get_mvf(sp, cu[CU_X0], cu[CU_Y0], &mvf);
    int found = -1;
    for (int i = 0; i < st->hmvp_len; i++) {
        MvF h;
        hmvp_load(st, i, &h);
        if (same_mv_ref(&mvf, &h)) {
            found = i;
            break;
        }
    }
    if (found >= 0) {
        for (int i = found; i < st->hmvp_len - 1; i++)
            memcpy(st->hmvp[i], st->hmvp[i + 1], sizeof(st->hmvp[i]));
        st->hmvp_len--;
    } else if (st->hmvp_len == MAX_NUM_HMVP_CANDS) {
        for (int i = 0; i < st->hmvp_len - 1; i++)
            memcpy(st->hmvp[i], st->hmvp[i + 1], sizeof(st->hmvp[i]));
        st->hmvp_len--;
    }
    hmvp_store(st, st->hmvp_len, &mvf);
    st->hmvp_len++;
}
