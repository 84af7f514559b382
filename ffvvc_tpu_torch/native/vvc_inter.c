/* Native inter-prediction walk: per-CU motion compensation over the flat
 * CU records emitted by vvc_parse.c — regular / affine (+PROF) / GPM
 * prediction, DMVR refinement, BDOF, CIIP blending and weighted
 * prediction, writing the frame planes in place.
 *
 * A C transliteration of ffvvc_tpu/inter.py (InterPredictor), which
 * remains the golden model; must match it bit-exactly (arbitrated by the
 * oracle-differential suite).
 *
 * Reference analogue: libavcodec/vvc/vvc_inter.c:222-918 —
 * re-expressed from our own Python model, not copied.
 */
#include <stdint.h>
#include <string.h>

#include "vvc_cabac.h"
#include "vvc_parse.h"   /* record layout, MvF, PF_* */
#include "vvc_recon.h"   /* ReconParams / InterParams / Recon + mc kernels */

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int iclip(int v, int lo, int hi)
{ return v < lo ? lo : (v > hi ? hi : v); }
static inline long long llclip(long long v, long long lo, long long hi)
{ return v < lo ? lo : (v > hi ? hi : v); }
/* horizontal wraparound MC (spec 8.5.6.3.2 ClipH) */
static inline int wrapx(int x, int W, int wrap)
{
    if (wrap) {
        if (x < 0)
            x += wrap;
        else if (x > W - 1)
            x -= wrap;
    }
    return x;
}

enum { L = 0, CB_ = 1, CR_ = 2 };

/* scratch buffers (max CU 128x128 luma) */
static _Thread_local int32_t s_buf0[128 * 128];
static _Thread_local int32_t s_buf1[128 * 128];
static _Thread_local int32_t s_out[128 * 128];
static _Thread_local int32_t s_ciip[128 * 128];

/* ---- MV field access (inter.py _get_mvf / mvs planes) ------------------- */

static void ip_get_mvf(const InterParams *ip, int x, int y, MvF *f)
{
    long i4 = (long)(y >> 2) * ip->w4 + (x >> 2);
    long p4 = (long)ip->h4 * ip->w4;
    f->pf = ip->mvf_pf[i4];
    for (int l = 0; l < 2; l++) {
        f->mv[l][0] = ip->mvf_mv[(l * p4 + i4) * 2];
        f->mv[l][1] = ip->mvf_mv[(l * p4 + i4) * 2 + 1];
        f->ref[l] = ip->mvf_ref[l * p4 + i4];
    }
    f->bcw = ip->mvf_bcw[i4];
    f->hpel = ip->mvf_hpel[i4];
    f->ciip = ip->mvf_ciip[i4];
}

/* set_dmvr_info (vvc_inter.c:750): refined MVs -> collocated grid */
static void set_dmvr_info(const InterParams *ip, int x0, int y0, int w,
                          int h, const MvF *f)
{
    int x1 = (x0 + w) >> 2, y1 = (y0 + h) >> 2;
    int xa = x0 >> 2, ya = y0 >> 2;
    long p4 = (long)ip->h4 * ip->w4;
    for (int y = ya; y < y1; y++)
        for (int x = xa; x < x1; x++) {
            long i4 = (long)y * ip->w4 + x;
            ip->col_pf[i4] = (uint8_t)f->pf;
            for (int l = 0; l < 2; l++) {
                ip->col_mv[(l * p4 + i4) * 2] = f->mv[l][0];
                ip->col_mv[(l * p4 + i4) * 2 + 1] = f->mv[l][1];
                ip->col_ref[l * p4 + i4] = (int8_t)f->ref[l];
            }
        }
}

static inline const int32_t *luma_row(const InterParams *ip, int idx,
                                      int frac)
{ return ip->luma_filters + ((long)idx * 16 + frac) * 8; }

static inline const int32_t *chroma_row(const InterParams *ip, int idx,
                                        int frac)
{ return ip->chroma_filters + ((long)idx * 32 + frac) * 4; }

/* ---- weight derivation (inter.py:166-194; vvc_inter.c:129-178) --------- */

static const int BCW_W_LUT[5] = {4, 5, 3, 10, -2};

/* uni: out[3] = {denom, w, o}; returns 0 if unweighted */
static int derive_weight_uni(const InterParams *ip, const MvF *f, int c_idx,
                             int out[3])
{
    if (!ip->weighted_pred)
        return 0;
    int lx = f->pf - PF_L0;
    out[0] = ip->pw_denom[c_idx > 0];
    out[1] = ip->pw_weight[lx][c_idx][f->ref[lx]];
    out[2] = ip->pw_offset[lx][c_idx][f->ref[lx]];
    return 1;
}

/* bi: out[5] = {denom, w0, w1, o0, o1}; returns 0 if plain average */
static int derive_weight(const InterParams *ip, const MvF *f, int c_idx,
                         int dmvr_flag, int ciip_flag, int out[5])
{
    int weight_flag = ip->weighted_pred && !(dmvr_flag && ip->is_b);
    int bcw = f->bcw;
    if ((!weight_flag && !bcw) || (bcw && ciip_flag))
        return 0;
    if (bcw) {
        int w1 = BCW_W_LUT[bcw];
        out[0] = 2; out[1] = 8 - w1; out[2] = w1; out[3] = 0; out[4] = 0;
        return 1;
    }
    out[0] = ip->pw_denom[c_idx > 0];
    out[1] = ip->pw_weight[0][c_idx][f->ref[0]];
    out[2] = ip->pw_weight[1][c_idx][f->ref[1]];
    out[3] = ip->pw_offset[0][c_idx][f->ref[0]];
    out[4] = ip->pw_offset[1][c_idx][f->ref[1]];
    return 1;
}

/* ---- DMVR (inter.py:367-484; vvc_inter.c:642-760) ---------------------- */

/* prefetch-window bounds (emulated_edge_dmvr); inclusive box */
static void dmvr_box(const ReconParams *rp, int x_sb, int y_sb, int w,
                     int h, int is_luma, int box[4])
{
    int eb, ea, pw, ph;
    if (is_luma) {
        eb = 3; ea = 4; pw = rp->width; ph = rp->height;
    } else {
        eb = 1; ea = 2;
        pw = rp->width >> rp->hshift1;
        ph = rp->height >> rp->vshift1;
    }
    int sx = iclip(x_sb - eb, 0, pw - 1);
    int sy = iclip(y_sb - eb, 0, ph - 1);
    int wdt = imax(imin(pw, x_sb + w + ea) - sx, 1);
    int hgt = imax(imin(ph, y_sb + h + ea) - sy, 1);
    box[0] = sx; box[1] = sx + wdt - 1;
    box[2] = sy; box[3] = sy + hgt - 1;
}

static void clip_mv2(int mv[2])
{
    mv[0] = iclip(mv[0], -(1 << 17), (1 << 17) - 1);
    mv[1] = iclip(mv[1], -(1 << 17), (1 << 17) - 1);
}

/* dmvr_mv_refine: mutates f; returns 1 if BDOF should be skipped */
static int dmvr_refine(const ReconParams *rp, const InterParams *ip,
                       MvF *f, int x0, int y0, int bw, int bh)
{
    int sr = 2, pw = bw + 2 * sr, ph = bh + 2 * sr;
    int32_t t0[20 * 20], t1[20 * 20];   /* bw, bh <= 16 */
    int32_t *tp[2] = {t0, t1};
    for (int i = 0; i < 2; i++) {
        const int32_t *ref = ip->ref_planes[i][f->ref[i]][0];
        dmvr_bilinear(tp[i], ref, rp->width, rp->width, rp->height,
                      f->mv[i][0], f->mv[i][1], x0, y0, pw, ph,
                      rp->bit_depth, ip->dmvr_filters, ip->wrap);
    }
    int32_t dmv[2];
    int skip = dmvr_search(t0, t1, bw, bh, dmv);
    if (dmv[0] || dmv[1]) {
        for (int i = 0; i < 2; i++) {
            f->mv[i][0] += (1 - 2 * i) * dmv[0];
            f->mv[i][1] += (1 - 2 * i) * dmv[1];
            clip_mv2(f->mv[i]);
        }
    }
    return skip;
}

/* ---- BDOF source fetch (bdof_fetch_samples) ----------------------------- */

static void bdof_fetch(const ReconParams *rp, const int32_t *ref,
                       const int32_t *center, int xi, int yi, int w, int h,
                       int has_box, const int box[4], int wrap, int32_t *out)
{
    int W = rp->width, H = rp->height, sh = 14 - rp->bit_depth;
    int pw = w + 2;
    for (int y = 0; y < h + 2; y++)
        for (int x = 0; x < w + 2; x++) {
            int sx = wrapx(xi + x, W, wrap), sy = yi + y;
            if (has_box) {
                sx = iclip(sx, box[0], box[1]);
                sy = iclip(sy, box[2], box[3]);
            }
            sx = iclip(sx, 0, W - 1);
            sy = iclip(sy, 0, H - 1);
            out[y * pw + x] = ref[(long)sy * W + sx] << sh;
        }
    for (int y = 0; y < h; y++)
        memcpy(out + (y + 1) * pw + 1, center + y * w,
               (size_t)w * sizeof(int32_t));
}

/* copy a contiguous [h][w] block into (plane, stride) at (x, y) */
static void blit(int32_t *plane, long stride, int x, int y,
                 const int32_t *src, int w, int h)
{
    for (int yy = 0; yy < h; yy++)
        memcpy(plane + (long)(y + yy) * stride + x, src + yy * w,
               (size_t)w * sizeof(int32_t));
}

/* ---- luma prediction (inter.py _luma_uni / _luma_bi) -------------------- */

static void luma_uni(const ReconParams *rp, const InterParams *ip,
                     int32_t *dst, long dstride, int dx, int dy,
                     const MvF *f, int x0, int y0, int w, int h,
                     int hf_idx, int vf_idx)
{
    int lx = f->pf - PF_L0;
    const int32_t *ref = ip->ref_planes[lx][f->ref[lx]][0];
    const int *mv = f->mv[lx];
    int mx = mv[0] & 0xF, my = mv[1] & 0xF;
    int xi = x0 + (mv[0] >> 4), yi = y0 + (mv[1] >> 4);
    mc_put(s_buf0, ref, rp->width, rp->width, rp->height, xi, yi, mx, my,
           w, h, 1, luma_row(ip, hf_idx, mx), luma_row(ip, vf_idx, my),
           rp->bit_depth, 0, 0, 0, 0, 0, ip->wrap);
    int wg[3];
    if (derive_weight_uni(ip, f, L, wg))
        mc_uni_out(dst, dstride, dx, dy, s_buf0, w, h, rp->bit_depth, 1,
                   wg[0], wg[1], wg[2]);
    else
        mc_uni_out(dst, dstride, dx, dy, s_buf0, w, h, rp->bit_depth, 0,
                   0, 0, 0);
}

static void luma_bi(const ReconParams *rp, const InterParams *ip,
                    int32_t *dst, long dstride, int dx, int dy,
                    const MvF *f, int x0, int y0, int w, int h,
                    int hf_idx, int vf_idx, int dmvr_flag, int ciip_flag,
                    const MvF *orig, int sb_bdof_flag)
{
    int32_t *tmp[2] = {s_buf0, s_buf1};
    static _Thread_local int32_t fetched[2][(16 + 2) * (16 + 2)];
    for (int i = 0; i < 2; i++) {
        const int32_t *ref = ip->ref_planes[i][f->ref[i]][0];
        const int *mv = f->mv[i];
        int mx = mv[0] & 0xF, my = mv[1] & 0xF;
        int xi = x0 + (mv[0] >> 4), yi = y0 + (mv[1] >> 4);
        int box[4] = {0, 0, 0, 0};
        int has_box = dmvr_flag;
        if (dmvr_flag)
            dmvr_box(rp, x0 + (orig->mv[i][0] >> 4),
                     y0 + (orig->mv[i][1] >> 4), w, h, 1, box);
        mc_put(tmp[i], ref, rp->width, rp->width, rp->height, xi, yi,
               mx, my, w, h, 1, luma_row(ip, hf_idx, mx),
               luma_row(ip, vf_idx, my), rp->bit_depth, has_box,
               box[0], box[1], box[2], box[3], ip->wrap);
        if (sb_bdof_flag)
            bdof_fetch(rp, ref, tmp[i], xi + (mx >> 3) - 1,
                       yi + (my >> 3) - 1, w, h, has_box, box, ip->wrap,
                       fetched[i]);
    }
    if (sb_bdof_flag) {
        apply_bdof(s_out, fetched[0], fetched[1], w, h, rp->bit_depth);
        blit(dst, dstride, dx, dy, s_out, w, h);
        return;
    }
    int wg[5];
    if (derive_weight(ip, f, L, dmvr_flag, ciip_flag, wg))
        mc_w_avg(dst, dstride, dx, dy, tmp[0], tmp[1], w, h, rp->bit_depth,
                 wg[0], wg[1], wg[2], wg[3], wg[4]);
    else
        mc_avg(dst, dstride, dx, dy, tmp[0], tmp[1], w, h, rp->bit_depth);
}

/* ---- chroma prediction (inter.py _chroma_uni / _chroma_bi) -------------- */

static void chroma_uni(const ReconParams *rp, const InterParams *ip,
                       int32_t *dst, long dstride, int dx, int dy,
                       const int32_t *ref_plane, const MvF *f, int x0c,
                       int y0c, int wc, int hc, int c_idx)
{
    int hs = rp->hshift1, vs = rp->vshift1;
    int lx = f->pf - PF_L0;
    const int *mv = f->mv[lx];
    int mx = (mv[0] & ((1 << (4 + hs)) - 1)) << (1 - hs);
    int my = (mv[1] & ((1 << (4 + vs)) - 1)) << (1 - vs);
    int xi = x0c + (mv[0] >> (4 + hs)), yi = y0c + (mv[1] >> (4 + vs));
    long cs = rp->width >> hs;
    mc_put(s_buf0, ref_plane, cs, (int)cs, rp->height >> vs, xi, yi, mx, my,
           wc, hc, 0, chroma_row(ip, 0, mx), chroma_row(ip, 0, my),
           rp->bit_depth, 0, 0, 0, 0, 0, ip->wrap >> hs);
    int wg[3];
    if (derive_weight_uni(ip, f, c_idx, wg))
        mc_uni_out(dst, dstride, dx, dy, s_buf0, wc, hc, rp->bit_depth, 1,
                   wg[0], wg[1], wg[2]);
    else
        mc_uni_out(dst, dstride, dx, dy, s_buf0, wc, hc, rp->bit_depth, 0,
                   0, 0, 0);
}

static void chroma_bi(const ReconParams *rp, const InterParams *ip,
                      int32_t *dst, long dstride, int dx, int dy,
                      const MvF *f, int x0c, int y0c, int wc, int hc,
                      int c_idx, int dmvr_flag, int ciip_flag,
                      const MvF *orig)
{
    int hs = rp->hshift1, vs = rp->vshift1;
    long cs = rp->width >> hs;
    int32_t *tmp[2] = {s_buf0, s_buf1};
    for (int i = 0; i < 2; i++) {
        const int32_t *ref = ip->ref_planes[i][f->ref[i]][c_idx];
        const int *mv = f->mv[i];
        int mx = (mv[0] & ((1 << (4 + hs)) - 1)) << (1 - hs);
        int my = (mv[1] & ((1 << (4 + vs)) - 1)) << (1 - vs);
        int xi = x0c + (mv[0] >> (4 + hs)), yi = y0c + (mv[1] >> (4 + vs));
        int box[4] = {0, 0, 0, 0};
        int has_box = dmvr_flag && orig;
        if (has_box)
            dmvr_box(rp, x0c + (orig->mv[i][0] >> (4 + hs)),
                     y0c + (orig->mv[i][1] >> (4 + vs)), wc, hc, 0, box);
        mc_put(tmp[i], ref, cs, (int)cs, rp->height >> vs, xi, yi, mx, my,
               wc, hc, 0, chroma_row(ip, 0, mx), chroma_row(ip, 0, my),
               rp->bit_depth, has_box, box[0], box[1], box[2], box[3],
               ip->wrap >> hs);
    }
    int wg[5];
    if (derive_weight(ip, f, c_idx, dmvr_flag, ciip_flag, wg))
        mc_w_avg(dst, dstride, dx, dy, tmp[0], tmp[1], wc, hc,
                 rp->bit_depth, wg[0], wg[1], wg[2], wg[3], wg[4]);
    else
        mc_avg(dst, dstride, dx, dy, tmp[0], tmp[1], wc, hc, rp->bit_depth);
}

/* ---- CIIP intra weight (vvc_inter.c:523) -------------------------------- */

static int ciip_intra_weight(Recon *r, const InterParams *ip, int x0,
                             int y0, int w, int h)
{
    const ReconParams *rp = r->rp;
    int mask = (1 << rp->ctb_log2) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    int avail_l = r->ctb_left_flag || x0b;
    int avail_u = r->ctb_up_flag || y0b;
    int wgt = 1;
    if (avail_u && ip->mvf_pf[(long)((y0 - 1) >> 2) * ip->w4 +
                              ((x0 - 1 + w) >> 2)] == PF_INTRA)
        wgt++;
    if (avail_l && ip->mvf_pf[(long)((y0 - 1 + h) >> 2) * ip->w4 +
                              ((x0 - 1) >> 2)] == PF_INTRA)
        wgt++;
    return wgt;
}

/* ---- regular blocks (inter.py pred_regular_blk + per-plane stages) ------ */

static void pred_regular_luma(Recon *r, const InterParams *ip,
                              const int32_t *cu, const MvF *f, int x0,
                              int y0, int sbw, int sbh, const MvF *orig,
                              int sb_bdof_flag, int dmvr_flag)
{
    const ReconParams *rp = r->rp;
    int ciip = (cu[CU_IFLAGS] & IF_CIIP) != 0;
    int hf_idx = f->hpel, vf_idx = f->hpel;
    int32_t *plane = rp->plane0;
    int32_t *dst;
    long dstride;
    int dx, dy;
    if (ciip) {
        dst = s_ciip; dstride = sbw; dx = dy = 0;
    } else {
        dst = plane; dstride = rp->width; dx = x0; dy = y0;
    }
    if (f->pf != PF_BI)
        luma_uni(rp, ip, dst, dstride, dx, dy, f, x0, y0, sbw, sbh,
                 hf_idx, vf_idx);
    else
        luma_bi(rp, ip, dst, dstride, dx, dy, f, x0, y0, sbw, sbh,
                hf_idx, vf_idx, dmvr_flag, ciip, orig, sb_bdof_flag);
    if (ciip) {
        int w = ciip_intra_weight(r, ip, x0, y0, sbw, sbh);
        vvcr_intra_pred(r, cu, x0, y0, sbw, sbh, 0);
        if (ip->lmcs_fwd)
            for (int i = 0; i < sbh * sbw; i++)
                s_ciip[i] = ip->lmcs_fwd[s_ciip[i]];
        for (int yy = 0; yy < sbh; yy++)
            for (int xx = 0; xx < sbw; xx++) {
                int32_t *d = plane + (long)(y0 + yy) * rp->width + x0 + xx;
                *d = (*d * w + s_ciip[yy * sbw + xx] * (4 - w) + 2) >> 2;
            }
    }
}

static void pred_regular_chroma(Recon *r, const InterParams *ip,
                                const int32_t *cu, const MvF *f, int x0,
                                int y0, int sbw, int sbh, const MvF *orig,
                                int dmvr_flag, int ciip)
{
    const ReconParams *rp = r->rp;
    int hs = rp->hshift1, vs = rp->vshift1;
    int x0c = x0 >> hs, y0c = y0 >> vs;
    int wc = sbw >> hs, hc = sbh >> vs;
    int do_ciip = ciip && wc > 2;
    static _Thread_local int32_t ciip_c[2][64 * 64];
    for (int c = CB_; c <= CR_; c++) {
        int32_t *plane = vvcr_plane_of(rp, c);
        long cs = vvcr_stride_of(rp, c);
        int32_t *dst;
        long dstride;
        int dx, dy;
        if (do_ciip) {
            dst = ciip_c[c - 1]; dstride = wc; dx = dy = 0;
        } else {
            dst = plane; dstride = cs; dx = x0c; dy = y0c;
        }
        if (f->pf != PF_BI) {
            int lx = f->pf - PF_L0;
            chroma_uni(rp, ip, dst, dstride, dx, dy,
                       ip->ref_planes[lx][f->ref[lx]][c], f, x0c, y0c,
                       wc, hc, c);
        } else {
            chroma_bi(rp, ip, dst, dstride, dx, dy, f, x0c, y0c, wc, hc,
                      c, dmvr_flag, ciip, orig);
        }
    }
    if (do_ciip) {
        int w = ciip_intra_weight(r, ip, x0, y0, sbw, sbh);
        for (int c = CB_; c <= CR_; c++) {
            vvcr_intra_pred(r, cu, x0, y0, sbw, sbh, c);
            int32_t *plane = vvcr_plane_of(rp, c);
            long cs = vvcr_stride_of(rp, c);
            const int32_t *inter = ciip_c[c - 1];
            for (int yy = 0; yy < hc; yy++)
                for (int xx = 0; xx < wc; xx++) {
                    int32_t *d = plane + (long)(y0c + yy) * cs + x0c + xx;
                    *d = (*d * w + inter[yy * wc + xx] * (4 - w) + 2) >> 2;
                }
        }
    }
}

static void pred_regular_blk(Recon *r, const InterParams *ip,
                             const int32_t *cu, int skip_ciip)
{
    const ReconParams *rp = r->rp;
    int ciip = (cu[CU_IFLAGS] & IF_CIIP) != 0;
    if (ciip && skip_ciip)
        return;
    int dmvr_flag = (cu[CU_IFLAGS] & IF_DMVR) != 0;
    int bdof_flag = (cu[CU_IFLAGS] & IF_BDOF) != 0;
    int nsbx = cu[CU_NSBX], nsby = cu[CU_NSBY];
    int sbw = cu[CU_W] / nsbx, sbh = cu[CU_H] / nsby;
    for (int sby = 0; sby < nsby; sby++)
        for (int sbx = 0; sbx < nsbx; sbx++) {
            int x0 = cu[CU_X0] + sbx * sbw;
            int y0 = cu[CU_Y0] + sby * sbh;
            if (ciip)
                vvcr_set_na(r, x0, y0, sbw, sbh);
            MvF mv, orig;
            ip_get_mvf(ip, x0, y0, &mv);
            orig = mv;
            int sb_bdof = bdof_flag;
            if (dmvr_flag) {
                if (dmvr_refine(rp, ip, &mv, x0, y0, sbw, sbh))
                    sb_bdof = 0;
                set_dmvr_info(ip, x0, y0, sbw, sbh, &mv);
            }
            pred_regular_luma(r, ip, cu, &mv, x0, y0, sbw, sbh, &orig,
                              sb_bdof, dmvr_flag);
            if (rp->chroma_format_idc)
                pred_regular_chroma(r, ip, cu, &mv, x0, y0, sbw, sbh,
                                    &orig, dmvr_flag, ciip);
        }
}

/* ---- affine + PROF (inter.py:607-716) ----------------------------------- */

#define MAX_CU_DEPTH 7

typedef struct {
    long long d_hor_x, d_ver_x, d_hor_y, d_ver_y;
} SbDeriv;

/* _init_subblock_params from the stored CP MVs (cp_mv plane) */
static void affine_sb_params(const InterParams *ip, const int32_t *cu,
                             int lx, SbDeriv *out)
{
    int log2_cbw = 31 - __builtin_clz((unsigned)cu[CU_W]);
    int log2_cbh = 31 - __builtin_clz((unsigned)cu[CU_H]);
    long i4 = (long)(cu[CU_Y0] >> 2) * ip->w4 + (cu[CU_X0] >> 2);
    long p4 = (long)ip->h4 * ip->w4;
    long base = ((long)lx * p4 + i4) * 3 * 2;
    int cp[3][2];
    for (int j = 0; j < 3; j++) {
        cp[j][0] = ip->cp_mv[base + j * 2];
        cp[j][1] = ip->cp_mv[base + j * 2 + 1];
    }
    int num_cp = cu[CU_MMI] + 1;
    int D = MAX_CU_DEPTH;
    out->d_hor_x = (long long)(cp[1][0] - cp[0][0]) << (D - log2_cbw);
    out->d_ver_x = (long long)(cp[1][1] - cp[0][1]) << (D - log2_cbw);
    if (num_cp == 3) {
        out->d_hor_y = (long long)(cp[2][0] - cp[0][0]) << (D - log2_cbh);
        out->d_ver_y = (long long)(cp[2][1] - cp[0][1]) << (D - log2_cbh);
    } else {
        out->d_hor_y = -out->d_ver_x;
        out->d_ver_y = out->d_hor_x;
    }
}

/* derive_subblock_diff_mvs (mvs.py:902): the 4x4 PROF diff-MV grid */
static void affine_diff_mvs(const SbDeriv *sb, int32_t dx[16],
                            int32_t dy[16])
{
    int dmv_limit = 1 << 5;
    long long pos_off_x = 6 * (sb->d_hor_x + sb->d_hor_y);
    long long pos_off_y = 6 * (sb->d_ver_x + sb->d_ver_y);
    for (int x = 0; x < 4; x++)
        for (int y = 0; y < 4; y++) {
            long long d0 = x * (sb->d_hor_x << 2) + y * (sb->d_hor_y << 2) -
                           pos_off_x;
            long long d1 = x * (sb->d_ver_x << 2) + y * (sb->d_ver_y << 2) -
                           pos_off_y;
            /* round_mv(d, 0, 8) */
            d0 = (d0 + 128 - (d0 >= 0)) >> 8;
            d1 = (d1 + 128 - (d1 >= 0)) >> 8;
            dx[4 * y + x] = (int32_t)llclip(d0, -dmv_limit + 1,
                                            dmv_limit - 1);
            dy[4 * y + x] = (int32_t)llclip(d1, -dmv_limit + 1,
                                            dmv_limit - 1);
        }
}

/* _prof_block: 4x4 affine subblock with PROF -> 14-bit domain (int64) */
static void prof_block(const ReconParams *rp, const InterParams *ip,
                       const int32_t *ref, const int *mv, int x, int y,
                       const int32_t *dmx, const int32_t *dmy,
                       long long out[16])
{
    int bd = rp->bit_depth;
    int mx = mv[0] & 0xF, my = mv[1] & 0xF;
    int xi = x + (mv[0] >> 4), yi = y + (mv[1] >> 4);
    int32_t val[16];
    mc_put(val, ref, rp->width, rp->width, rp->height, xi, yi, mx, my,
           4, 4, 1, luma_row(ip, 2, mx), luma_row(ip, 2, my), bd,
           0, 0, 0, 0, 0, ip->wrap);
    /* integer-sample 6x6 ring (fetch_samples) */
    long long padded[36];
    int W = rp->width, H = rp->height;
    int bx = xi + (mx >> 3) - 1, by = yi + (my >> 3) - 1;
    for (int yy = 0; yy < 6; yy++)
        for (int xx = 0; xx < 6; xx++) {
            int sx = iclip(wrapx(bx + xx, W, ip->wrap), 0, W - 1);
            int sy = iclip(by + yy, 0, H - 1);
            padded[yy * 6 + xx] = (long long)ref[(long)sy * W + sx]
                                  << (14 - bd);
        }
    for (int yy = 0; yy < 4; yy++)
        for (int xx = 0; xx < 4; xx++)
            padded[(yy + 1) * 6 + xx + 1] = val[yy * 4 + xx];
    long long limit = 1LL << imax(13, bd + 1);
    for (int yy = 0; yy < 4; yy++)
        for (int xx = 0; xx < 4; xx++) {
            long long gh = (padded[(yy + 1) * 6 + xx + 2] >> 6) -
                           (padded[(yy + 1) * 6 + xx] >> 6);
            long long gv = (padded[(yy + 2) * 6 + xx + 1] >> 6) -
                           (padded[yy * 6 + xx + 1] >> 6);
            long long di = gh * dmx[yy * 4 + xx] + gv * dmy[yy * 4 + xx];
            out[yy * 4 + xx] = padded[(yy + 1) * 6 + xx + 1] +
                               llclip(di, -limit, limit - 1);
        }
}

/* luma_prof_uni (inter.py:666) */
static void luma_prof_uni(const ReconParams *rp, const InterParams *ip,
                          const int32_t *cu, const MvF *f, int lx, int x,
                          int y, int sbw, int sbh, const int32_t *dmx,
                          const int32_t *dmy, int prof)
{
    int bd = rp->bit_depth;
    int32_t *plane = rp->plane0;
    const int32_t *ref = ip->ref_planes[lx][f->ref[lx]][0];
    int wg[3];
    int weighted = derive_weight_uni(ip, f, L, wg);
    if (prof) {
        long long val[16];
        prof_block(rp, ip, ref, f->mv[lx], x, y, dmx, dmy, val);
        long long mx = (1 << bd) - 1;
        if (!weighted) {
            int shift = 14 - bd;
            long long off = 1LL << (shift - 1);
            for (int yy = 0; yy < 4; yy++)
                for (int xx = 0; xx < 4; xx++)
                    plane[(long)(y + yy) * rp->width + x + xx] = (int32_t)
                        llclip((val[yy * 4 + xx] + off) >> shift, 0, mx);
        } else {
            int shift = wg[0] + imax(2, 14 - bd);
            long long off = 1LL << (shift - 1);
            long long oxs = (long long)wg[2] << (bd - 8);
            for (int yy = 0; yy < 4; yy++)
                for (int xx = 0; xx < 4; xx++)
                    plane[(long)(y + yy) * rp->width + x + xx] = (int32_t)
                        llclip(((val[yy * 4 + xx] * wg[1] + off) >> shift) +
                               oxs, 0, mx);
        }
        return;
    }
    const int *mv = f->mv[lx];
    int mx = mv[0] & 0xF, my = mv[1] & 0xF;
    int xi = x + (mv[0] >> 4), yi = y + (mv[1] >> 4);
    mc_put(s_buf0, ref, rp->width, rp->width, rp->height, xi, yi, mx, my,
           sbw, sbh, 1, luma_row(ip, 2, mx), luma_row(ip, 2, my), bd,
           0, 0, 0, 0, 0, ip->wrap);
    mc_uni_out(plane, rp->width, x, y, s_buf0, sbw, sbh, bd, weighted,
               wg[0], wg[1], wg[2]);
}

/* luma_prof_bi (inter.py:696) */
static void luma_prof_bi(const ReconParams *rp, const InterParams *ip,
                         const int32_t *cu, const MvF *f, int x, int y,
                         int sbw, int sbh, const int32_t dmx[2][16],
                         const int32_t dmy[2][16], const int prof[2])
{
    int bd = rp->bit_depth;
    int32_t *tmp[2] = {s_buf0, s_buf1};
    for (int i = 0; i < 2; i++) {
        const int32_t *ref = ip->ref_planes[i][f->ref[i]][0];
        const int *mv = f->mv[i];
        if (prof[i]) {
            long long val[16];
            prof_block(rp, ip, ref, mv, x, y, dmx[i], dmy[i], val);
            for (int k = 0; k < 16; k++)
                tmp[i][k] = (int32_t)val[k];
        } else {
            int mx = mv[0] & 0xF, my = mv[1] & 0xF;
            int xi = x + (mv[0] >> 4), yi = y + (mv[1] >> 4);
            mc_put(tmp[i], ref, rp->width, rp->width, rp->height, xi, yi,
                   mx, my, sbw, sbh, 1, luma_row(ip, 2, mx),
                   luma_row(ip, 2, my), bd, 0, 0, 0, 0, 0, ip->wrap);
        }
    }
    int wg[5];
    if (derive_weight(ip, f, L, 0, 0, wg))
        mc_w_avg(rp->plane0, rp->width, x, y, tmp[0], tmp[1], sbw, sbh, bd,
                 wg[0], wg[1], wg[2], wg[3], wg[4]);
    else
        mc_avg(rp->plane0, rp->width, x, y, tmp[0], tmp[1], sbw, sbh, bd);
}

static void pred_affine_blk(Recon *r, const InterParams *ip,
                            const int32_t *cu)
{
    const ReconParams *rp = r->rp;
    int hs = rp->hshift1, vs = rp->vshift1;
    int nsbx = cu[CU_NSBX], nsby = cu[CU_NSBY];
    int sbw = cu[CU_W] / nsbx, sbh = cu[CU_H] / nsby;
    int pf = cu[CU_MI_PF];
    int prof[2] = {(cu[CU_IFLAGS] & IF_PROF_L0) != 0,
                   (cu[CU_IFLAGS] & IF_PROF_L1) != 0};
    int32_t dmx[2][16], dmy[2][16];
    for (int lx = 0; lx < 2; lx++)
        if (prof[lx] && (pf & (lx + 1))) {
            SbDeriv sb;
            affine_sb_params(ip, cu, lx, &sb);
            affine_diff_mvs(&sb, dmx[lx], dmy[lx]);
        }
    for (int sby = 0; sby < nsby; sby++)
        for (int sbx = 0; sbx < nsbx; sbx++) {
            int x = cu[CU_X0] + sbx * sbw;
            int y = cu[CU_Y0] + sby * sbh;
            MvF mv;
            ip_get_mvf(ip, x, y, &mv);
            if (pf != PF_BI) {
                int lx = pf - PF_L0;
                luma_prof_uni(rp, ip, cu, &mv, lx, x, y, sbw, sbh,
                              dmx[lx], dmy[lx], prof[lx]);
            } else {
                luma_prof_bi(rp, ip, cu, &mv, x, y, sbw, sbh,
                             (const int32_t (*)[16])dmx,
                             (const int32_t (*)[16])dmy, prof);
            }
            if (rp->chroma_format_idc && !(sby & vs) && !(sbx & hs)) {
                /* derive_affine_mvc (vvc_inter.c:814) */
                MvF mv2, mvc;
                ip_get_mvf(ip, x + hs * sbw, y + vs * sbh, &mv2);
                mvc = mv;
                for (int i = 0; i < 2; i++) {
                    int m0 = mv.mv[i][0] + mv2.mv[i][0];
                    int m1 = mv.mv[i][1] + mv2.mv[i][1];
                    /* round_mv(m, 0, 1) */
                    mvc.mv[i][0] = (m0 + 1 - (m0 >= 0)) >> 1;
                    mvc.mv[i][1] = (m1 + 1 - (m1 >= 0)) >> 1;
                }
                pred_regular_chroma(r, ip, cu, &mvc, x, y, sbw << hs,
                                    sbh << vs, 0, 0, 0);
            }
        }
}

/* ---- GPM (inter.py:720-777; put_gpm, vvc_inter_template.c:78) ----------- */

#define GPM_WS 112

static void pred_gpm_blk(Recon *r, const InterParams *ip, const int32_t *cu)
{
    const ReconParams *rp = r->rp;
    int bd = rp->bit_depth;
    int part = cu[CU_GPM_PART];
    int angle_idx = ip->gpm_angle_idx[part];
    int weights_idx = ip->gpm_angle_to_weights[angle_idx];
    int wi = (31 - __builtin_clz((unsigned)cu[CU_W])) - 3;
    int hi = (31 - __builtin_clz((unsigned)cu[CU_H])) - 3;
    int off_x = ip->gpm_off_x[(part * 4 + hi) * 4 + wi];
    int off_y = ip->gpm_off_y[(part * 4 + hi) * 4 + wi];
    int mirror = ip->gpm_angle_to_mirror[angle_idx];
    const uint8_t *wmat = ip->gpm_weights + (long)weights_idx *
                          GPM_WS * GPM_WS;
    int c_end = rp->chroma_format_idc ? 3 : 1;
    int lxs[2] = {cu[CU_GPM0_LX], cu[CU_GPM1_LX]};
    int refs[2] = {cu[CU_GPM0_REF], cu[CU_GPM1_REF]};
    int mvs[2][2] = {{cu[CU_GPM0_MVX], cu[CU_GPM0_MVY]},
                     {cu[CU_GPM1_MVX], cu[CU_GPM1_MVY]}};
    for (int c_idx = 0; c_idx < c_end; c_idx++) {
        int hs = c_idx ? rp->hshift1 : 0;
        int vs = c_idx ? rp->vshift1 : 0;
        int x = cu[CU_X0] >> hs, y = cu[CU_Y0] >> vs;
        int w = cu[CU_W] >> hs, h = cu[CU_H] >> vs;
        int32_t *tmp[2] = {s_buf0, s_buf1};
        for (int i = 0; i < 2; i++) {
            const int32_t *ref = ip->ref_planes[lxs[i]][refs[i]][c_idx];
            if (!ref)
                return;
            long cs = rp->width >> hs;
            int H = rp->height >> vs;
            if (c_idx) {
                int mx = (mvs[i][0] & ((1 << (4 + hs)) - 1)) << (1 - hs);
                int my = (mvs[i][1] & ((1 << (4 + vs)) - 1)) << (1 - vs);
                int xi = x + (mvs[i][0] >> (4 + hs));
                int yi = y + (mvs[i][1] >> (4 + vs));
                mc_put(tmp[i], ref, cs, (int)cs, H, xi, yi, mx, my, w, h,
                       0, chroma_row(ip, 0, mx), chroma_row(ip, 0, my),
                       bd, 0, 0, 0, 0, 0, ip->wrap >> hs);
            } else {
                int mx = mvs[i][0] & 0xF, my = mvs[i][1] & 0xF;
                int xi = x + (mvs[i][0] >> 4), yi = y + (mvs[i][1] >> 4);
                mc_put(tmp[i], ref, cs, (int)cs, H, xi, yi, mx, my, w, h,
                       1, luma_row(ip, 0, mx), luma_row(ip, 0, my), bd,
                       0, 0, 0, 0, 0, ip->wrap);
            }
        }
        int32_t *plane = vvcr_plane_of(rp, c_idx);
        long cs = vvcr_stride_of(rp, c_idx);
        int shift = imax(5, 17 - bd);
        long long off = 1LL << (shift - 1);
        long long mxv = (1 << bd) - 1;
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++) {
                int wy = yy << vs, wx = xx << hs;
                int wgt;
                if (mirror == 0)
                    wgt = wmat[(off_y + wy) * GPM_WS + off_x + wx];
                else if (mirror == 1)
                    wgt = wmat[(off_y + wy) * GPM_WS +
                               GPM_WS - 1 - off_x - wx];
                else
                    wgt = wmat[(GPM_WS - 1 - off_y - wy) * GPM_WS +
                               off_x + wx];
                long long v = ((long long)tmp[0][yy * w + xx] * wgt +
                               (long long)tmp[1][yy * w + xx] * (8 - wgt) +
                               off) >> shift;
                plane[(long)(y + yy) * cs + x + xx] =
                    (int32_t)llclip(v, 0, mxv);
            }
    }
}

/* ---- CTU walk (inter.py predict_inter_ctu :781) -------------------------- */

static void lmcs_map_cu_luma(const ReconParams *rp, const InterParams *ip,
                             const int32_t *cu)
{
    for (int yy = 0; yy < cu[CU_H]; yy++) {
        int32_t *row = rp->plane0 + (long)(cu[CU_Y0] + yy) * rp->width +
                       cu[CU_X0];
        for (int xx = 0; xx < cu[CU_W]; xx++)
            row[xx] = ip->lmcs_fwd[row[xx]];
    }
}

/* ff_vvc_predict_ciip (vvc_inter.c:915) — called at the recon stage from
 * recon_cu with the live Recon context (neighbour flags + RAs) */
void vvci_predict_ciip(Recon *r, const int32_t *cu)
{
    pred_regular_blk(r, r->ip, cu, 0);
}

/* exported: run inter prediction for one CTU's records (skip_ciip; CIIP
 * CUs blend at the recon stage).  Returns 0 ok. */
int inter_ctu(const ReconParams *rp, const InterParams *ip, int rx, int ry,
              int rs, const int32_t *cu_recs, int n_cu)
{
    static _Thread_local Recon r;
    r.rp = rp;
    r.ip = ip;
    r.n_ras[0] = r.n_ras[1] = 0;
    r.err = 0;
    (void)rx; (void)ry; (void)rs;
    for (int i = 0; i < n_cu; i++) {
        const int32_t *cu = cu_recs + i * CU_STRIDE;
        if (cu[CU_PRED_MODE] == MODE_INTRA || cu[CU_PRED_MODE] == MODE_PLT ||
            cu[CU_TREE_TYPE] == DUAL_TREE_CHROMA)
            continue;
        int flags = cu[CU_IFLAGS];
        if (flags & IF_MERGE_GPM)
            pred_gpm_blk(&r, ip, cu);
        else if (flags & IF_AFFINE)
            pred_affine_blk(&r, ip, cu);
        else
            pred_regular_blk(&r, ip, cu, 1);
        /* LMCS forward mapping of inter luma (predict_inter) */
        if (ip->lmcs_fwd && !(flags & IF_CIIP))
            lmcs_map_cu_luma(rp, ip, cu);
        if (r.err)
            return r.err;
    }
    return 0;
}

/* batched inter MC walk (see recon_ctus) */
int inter_ctus(const ReconParams *rp, const InterParams *ip, int n,
               const int32_t *rxs, const int32_t *rys, const int32_t *rss,
               const int64_t *cu_ps, const int32_t *n_cus)
{
    for (int i = 0; i < n; i++) {
        if (!n_cus[i])
            continue;
        int err = inter_ctu(rp, ip, rxs[i], rys[i], rss[i],
                            (const int32_t *)(intptr_t)cu_ps[i], n_cus[i]);
        if (err)
            return err;
    }
    return 0;
}

/* device-MC dispatch: walk CUs, run the host path for everything except
 * "simple regular" blocks (uni/bi, no affine/GPM/CIIP/DMVR/BDOF, no
 * weighted pred / BCW, no LMCS fwd, single subblock) and emit those as
 * descriptors for the batched device MC (ops/mc_device.py) — the
 * decoder-side analogue of the reference's hottest h2656 MC kernels
 * moving to the chip.  desc layout (13 x int32 per entry):
 * {x0, y0, w, h, pf, ref0, ref1, mvx0, mvy0, mvx1, mvy1, hpel, job}. */
int inter_ctus_dev(const ReconParams *rp, const InterParams *ip, int n,
                   const int32_t *rxs, const int32_t *rys,
                   const int32_t *rss, const int64_t *cu_ps,
                   const int32_t *n_cus, int job_tag,
                   int32_t *desc, int desc_cap, int32_t *n_desc)
{
    static _Thread_local Recon r;
    r.rp = rp;
    r.ip = ip;
    r.n_ras[0] = r.n_ras[1] = 0;
    r.err = 0;
    int nd = *n_desc;
    for (int c = 0; c < n; c++) {
        if (!n_cus[c])
            continue;
        const int32_t *cu_recs = (const int32_t *)(intptr_t)cu_ps[c];
        (void)rxs; (void)rys; (void)rss;
        for (int i = 0; i < n_cus[c]; i++) {
            const int32_t *cu = cu_recs + i * CU_STRIDE;
            if (cu[CU_PRED_MODE] == MODE_INTRA ||
                cu[CU_PRED_MODE] == MODE_PLT ||
                cu[CU_TREE_TYPE] == DUAL_TREE_CHROMA)
                continue;
            int flags = cu[CU_IFLAGS];
            int gpm = (flags & IF_MERGE_GPM) != 0;
            int affine = (flags & IF_AFFINE) != 0;
            int subblk = !affine && !gpm &&
                !(flags & (IF_CIIP | IF_DMVR | IF_BDOF)) &&
                (cu[CU_NSBX] > 1 || cu[CU_NSBY] > 1);
            int dmvr_bdof = !affine && !gpm && !(flags & IF_CIIP) &&
                (flags & (IF_DMVR | IF_BDOF)) != 0;
            if (dmvr_bdof && nd < desc_cap) {
                /* DMVR/BDOF descriptor (flags2 bits 6/7): the dispatch
                 * runs the bilinear prefetch + 25-point SAD refine and
                 * the per-subblock BDOF as batched device kernels, with
                 * the refined MVs written back to the TMVP col grids.
                 * DMVR/BDOF imply no WP/BCW weights. */
                MvF f;
                ip_get_mvf(ip, cu[CU_X0], cu[CU_Y0], &f);
                int32_t *d = desc + (long)nd * 31;
                d[0] = cu[CU_X0]; d[1] = cu[CU_Y0];
                d[2] = cu[CU_W]; d[3] = cu[CU_H];
                d[4] = f.pf | (cu[CU_NSBX] << 4) | (cu[CU_NSBY] << 10);
                d[5] = f.ref[0]; d[6] = f.ref[1];
                d[7] = f.mv[0][0]; d[8] = f.mv[0][1];
                d[9] = f.mv[1][0]; d[10] = f.mv[1][1];
                d[11] = f.hpel; d[12] = job_tag;
                d[13] = (ip->lmcs_fwd ? 1 : 0) |
                        ((flags & IF_DMVR) ? 64 : 0) |
                        ((flags & IF_BDOF) ? 128 : 0);
                d[14] = ip->wrap;
                d[15] = 0;
                for (int cc = 0; cc < 15; cc++)
                    d[16 + cc] = 0;
                nd++;
                continue;
            }
            int simple = !(flags & (IF_MERGE_GPM | IF_AFFINE | IF_CIIP |
                                    IF_DMVR | IF_BDOF)) &&
                cu[CU_NSBX] == 1 && cu[CU_NSBY] == 1;
            if ((affine || subblk) && nd < desc_cap) {
                /* affine (flags2 bit2) / SbTMVP-style subblock grid
                 * (bit3) descriptor: the dispatch expands per-subblock
                 * MVs from the mvf/cp_mv tab grids; d[4] packs
                 * pf | nsbx<<4 | nsby<<10, bits 4/5 of flags2 carry the
                 * per-list PROF decisions.  Weights are CU-level. */
                MvF f;
                ip_get_mvf(ip, cu[CU_X0], cu[CU_Y0], &f);
                int32_t *d = desc + (long)nd * 31;
                d[0] = cu[CU_X0]; d[1] = cu[CU_Y0];
                d[2] = cu[CU_W]; d[3] = cu[CU_H];
                d[4] = cu[CU_MI_PF] | (cu[CU_NSBX] << 4) |
                       (cu[CU_NSBY] << 10);
                d[5] = f.ref[0]; d[6] = f.ref[1];
                d[7] = d[8] = d[9] = d[10] = 0;
                d[11] = f.hpel; d[12] = job_tag;
                d[13] = (ip->lmcs_fwd ? 1 : 0) | (affine ? 4 : 8) |
                        ((flags & IF_PROF_L0) ? 16 : 0) |
                        ((flags & IF_PROF_L1) ? 32 : 0);
                d[14] = ip->wrap;
                d[15] = 0;
                for (int cc = 0; cc < 15; cc++)
                    d[16 + cc] = 0;
                for (int c_idx = 0; c_idx < 3; c_idx++) {
                    int32_t *wd = d + 16 + 5 * c_idx;
                    if (cu[CU_MI_PF] == PF_BI) {
                        int wg[5];
                        if (derive_weight(ip, &f, c_idx, 0, 0, wg)) {
                            d[15] |= 1 << c_idx;
                            wd[0] = wg[0]; wd[1] = wg[1]; wd[2] = wg[2];
                            wd[3] = wg[3]; wd[4] = wg[4];
                        }
                    } else {
                        int wg[3];
                        if (derive_weight_uni(ip, &f, c_idx, wg)) {
                            d[15] |= 1 << c_idx;
                            wd[0] = wg[0]; wd[1] = wg[1]; wd[3] = wg[2];
                        }
                    }
                }
                nd++;
                continue;
            }
            if (gpm && nd < desc_cap) {
                /* GPM descriptor: two uni hypotheses + partition idx;
                 * flags2 bit1 marks it, [16]=lx0 [17]=lx1 [18]=part */
                int32_t *d = desc + (long)nd * 31;
                d[0] = cu[CU_X0]; d[1] = cu[CU_Y0];
                d[2] = cu[CU_W]; d[3] = cu[CU_H];
                d[4] = 0;
                d[5] = cu[CU_GPM0_REF]; d[6] = cu[CU_GPM1_REF];
                d[7] = cu[CU_GPM0_MVX]; d[8] = cu[CU_GPM0_MVY];
                d[9] = cu[CU_GPM1_MVX]; d[10] = cu[CU_GPM1_MVY];
                d[11] = 0; d[12] = job_tag;
                d[13] = (ip->lmcs_fwd ? 1 : 0) | 2;
                d[14] = ip->wrap;
                d[15] = 0;
                for (int cc = 0; cc < 15; cc++)
                    d[16 + cc] = 0;
                d[16] = cu[CU_GPM0_LX];
                d[17] = cu[CU_GPM1_LX];
                d[18] = cu[CU_GPM_PART];
                nd++;
                continue;
            }
            MvF f;
            if (simple)
                ip_get_mvf(ip, cu[CU_X0], cu[CU_Y0], &f);
            if (simple && nd < desc_cap) {
                /* DESC_N = 31 int32 per block:
                 * [0..12] geometry/mv as before; [13] flags2 (bit0 lmcs
                 * fwd on luma); [14] luma wrap offset; [15] weight kind
                 * (0 none / 1 weighted); [16..20] luma (denom,w0,w1,
                 * o0,o1), [21..25] cb, [26..30] cr — uni blocks carry
                 * the active list's weight in the w0/o0 slots. */
                int32_t *d = desc + (long)nd * 31;
                d[0] = cu[CU_X0]; d[1] = cu[CU_Y0];
                d[2] = cu[CU_W]; d[3] = cu[CU_H];
                d[4] = f.pf; d[5] = f.ref[0]; d[6] = f.ref[1];
                d[7] = f.mv[0][0]; d[8] = f.mv[0][1];
                d[9] = f.mv[1][0]; d[10] = f.mv[1][1];
                d[11] = f.hpel; d[12] = job_tag;
                d[13] = ip->lmcs_fwd ? 1 : 0;
                d[14] = ip->wrap;
                d[15] = 0;          /* bit c: component c weighted */
                for (int cc = 0; cc < 15; cc++)
                    d[16 + cc] = 0;
                for (int c_idx = 0; c_idx < 3; c_idx++) {
                    int32_t *wd = d + 16 + 5 * c_idx;
                    if (f.pf == PF_BI) {
                        int wg[5];
                        if (derive_weight(ip, &f, c_idx, 0, 0, wg)) {
                            d[15] |= 1 << c_idx;
                            wd[0] = wg[0]; wd[1] = wg[1]; wd[2] = wg[2];
                            wd[3] = wg[3]; wd[4] = wg[4];
                        }
                    } else {
                        int wg[3];
                        if (derive_weight_uni(ip, &f, c_idx, wg)) {
                            d[15] |= 1 << c_idx;
                            wd[0] = wg[0]; wd[1] = wg[1]; wd[3] = wg[2];
                        }
                    }
                }
                nd++;
                continue;
            }
            if (flags & IF_MERGE_GPM)
                pred_gpm_blk(&r, ip, cu);
            else if (flags & IF_AFFINE)
                pred_affine_blk(&r, ip, cu);
            else
                pred_regular_blk(&r, ip, cu, 1);
            if (ip->lmcs_fwd && !(flags & IF_CIIP))
                lmcs_map_cu_luma(rp, ip, cu);
            if (r.err)
                return r.err;
        }
    }
    *n_desc = nd;
    return 0;
}
