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
#include <stdlib.h>
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

/* ---- device-MC walk (ops/mc_device.py frame_device_mc) ------------------ */

/* mc_walk expands the descriptors of one frame_device_mc call (several
 * jobs' inter_ctus_dev arrays, each row tagged with its job) with the
 * arithmetic of pred_regular_blk, pred_affine_blk and pred_gpm_blk, each
 * prediction becoming a put row instead of a filtered block:
 *
 *   jobs [rows][WJ_COLS] (ops/mc_device.py PutTable): x, y, frac_x |
 *     frac_y << 8, plane | luma << 16 | fclass << 17 | hf << 19 | vf << 21
 *     | boxed << 23, wrap, box x0 | x1 << 16, box y0 | y1 << 16 (clipped
 *     into the plane), the offset of the block's outputs.  Rows sharing
 *     (w, h, flags, wrap) form a group; groups are ordered by (w, h), then
 *     by first sight, so each size's rows and outputs lie together.
 *   groups [G][5]: w, h, flags, wrap, rows, in that order; runs [R][4]: w,
 *     h, first row, rows of each size.
 *   entries [E][WE_COLS], one a finals block: tag, component, x, y, w, h,
 *     kind (WK_*), LMCS flag, the put row of each hypothesis (-1: none),
 *     then five parameters: the weights (denom, w0, w1, o0, o1), BDOF's two
 *     ring rows, or GPM's weight matrix, offsets x and y, and mirror.
 *   prof [P][WP_COLS]: PROF's put row, ring row, dmx[16], dmy[16].
 *
 * DMVR's refined MVs (mv0 x, y, mv1 x, y) and BDOF skips come in the
 * order of the DMVR descriptors' subblocks; they go to the collocated
 * grids (set_dmvr_info).  lut[tag][list][ref][c] is the put table's plane
 * index of a reference plane, dims[plane] its (W, H).  Returns 0, or a
 * WALK_* error. */

enum { WK_UNI, WK_UNI_W, WK_BI, WK_BI_W, WK_GPM, WK_BDOF };
enum { WJ_COLS = 8, WE_COLS = 15, WP_COLS = 34, WR_COLS = 6 };
enum { WALK_CAP = 1, WALK_PLANE, WALK_RANGE, WALK_MEM, WALK_REFINED };

typedef struct {
    const int32_t *lut, *dims;
    int n_planes;
    int32_t *rows;           /* walk order: x, y, frac, box x, box y, group */
    int n, cap;
    int32_t *grp;            /* first-sight order: w, h, flags, wrap, rows */
    int ng;
    uint64_t *hkey;          /* group key -> id, open addressing (0: free) */
    int32_t *hval;
    int hbits;
    int32_t *ents;
    int ne, cap_e;
    int32_t *prof;
    int np, cap_p;
    int err;
} Walk;

static uint32_t walk_hash(uint64_t key, int bits)
{
    return (uint32_t)((key * 0x9E3779B97F4A7C15ULL) >> (64 - bits));
}

static int walk_rehash(Walk *W, int bits)
{
    size_t m = (size_t)1 << bits, old = W->hkey ? (size_t)1 << W->hbits : 0;
    uint64_t *key = calloc(m, sizeof *key);
    int32_t *val = malloc(m * sizeof *val);
    if (!key || !val) {
        free(key);
        free(val);
        return WALK_MEM;
    }
    for (size_t i = 0; i < old; i++)
        if (W->hkey[i]) {
            uint32_t j = walk_hash(W->hkey[i], bits);
            while (key[j])
                j = (j + 1) & (m - 1);
            key[j] = W->hkey[i];
            val[j] = W->hval[i];
        }
    free(W->hkey);
    free(W->hval);
    W->hkey = key;
    W->hval = val;
    W->hbits = bits;
    return 0;
}

static int walk_plane(Walk *W, int tag, int lx, int ref, int c)
{
    if (ref < 0 || ref >= 16) {
        W->err = W->err ? W->err : WALK_PLANE;
        return -1;
    }
    return W->lut[((tag * 2 + lx) * 16 + ref) * 3 + c];
}

/* one put block: its row in walk order, or -1 with W->err set */
static int walk_put(Walk *W, int plane, int x, int y, int fx, int fy, int w,
                    int h, int luma, int hf, int wrap, const int *box)
{
    if (W->err)
        return -1;
    if (plane < 0 || plane >= W->n_planes) {
        W->err = WALK_PLANE;
        return -1;
    }
    if (w > 255 || h > 255 || wrap < 0 || wrap >= 1 << 24) {
        W->err = WALK_RANGE;
        return -1;
    }
    if (W->n >= W->cap) {
        W->err = WALK_CAP;
        return -1;
    }
    uint32_t flags = (uint32_t)plane | (uint32_t)luma << 16 |
                     (uint32_t)((fx != 0) | (fy != 0) << 1) << 17 |
                     (uint32_t)hf << 19 | (uint32_t)hf << 21 |
                     (uint32_t)(box != NULL) << 23;
    uint64_t key = flags | (uint64_t)w << 24 | (uint64_t)h << 32 |
                   (uint64_t)wrap << 40;
    size_t m = (size_t)1 << W->hbits;
    uint32_t j = walk_hash(key, W->hbits);
    while (W->hkey[j] && W->hkey[j] != key)
        j = (j + 1) & (m - 1);
    int g;
    if (W->hkey[j]) {
        g = W->hval[j];
    } else {
        g = W->ng++;
        W->hkey[j] = key;
        W->hval[j] = g;
        int32_t *q = W->grp + (long)g * 5;
        q[0] = w; q[1] = h; q[2] = (int32_t)flags; q[3] = wrap; q[4] = 0;
        if (2 * (size_t)W->ng >= m &&
            (W->err = walk_rehash(W, W->hbits + 1)))
            return -1;
    }
    W->grp[(long)g * 5 + 4]++;
    int32_t *r = W->rows + (long)W->n * WR_COLS;
    r[0] = x;
    r[1] = y;
    r[2] = fx | fy << 8;
    r[3] = r[4] = 0;
    if (box) {
        int pw = W->dims[plane * 2] - 1, ph = W->dims[plane * 2 + 1] - 1;
        r[3] = iclip(box[0], 0, pw) | iclip(box[1], 0, pw) << 16;
        r[4] = iclip(box[2], 0, ph) | iclip(box[3], 0, ph) << 16;
    }
    r[5] = g;
    return W->n++;
}

static int walk_luma(Walk *W, int plane, int x, int y, int mvx, int mvy,
                     int w, int h, int hf, int wrap, const int *box)
{
    return walk_put(W, plane, x + (mvx >> 4), y + (mvy >> 4), mvx & 15,
                    mvy & 15, w, h, 1, hf, wrap, box);
}

static int walk_chroma(Walk *W, int plane, int xc, int yc, int mvx, int mvy,
                       int wc, int hc, int hs, int vs, int wrap,
                       const int *box)
{
    int fx = (mvx & ((1 << (4 + hs)) - 1)) << (1 - hs);
    int fy = (mvy & ((1 << (4 + vs)) - 1)) << (1 - vs);
    return walk_put(W, plane, xc + (mvx >> (4 + hs)), yc + (mvy >> (4 + vs)),
                    fx, fy, wc, hc, 0, 0, wrap >> hs, box);
}

/* one finals block over n put rows; prm: its five parameters or NULL */
static void walk_entry(Walk *W, int tag, int c, int x, int y, int w, int h,
                       int kind, int lm, const int *slots, int n,
                       const int32_t *prm)
{
    if (W->err)
        return;
    if (W->ne >= W->cap_e) {
        W->err = WALK_CAP;
        return;
    }
    int32_t *e = W->ents + (long)W->ne++ * WE_COLS;
    e[0] = tag; e[1] = c; e[2] = x; e[3] = y; e[4] = w; e[5] = h;
    e[6] = kind; e[7] = lm;
    e[8] = slots[0];
    e[9] = n > 1 ? slots[1] : -1;
    for (int k = 0; k < 5; k++)
        e[10 + k] = prm ? prm[k] : 0;
}

static int walk_kind(int n, int weighted)
{
    return n == 1 ? (weighted ? WK_UNI_W : WK_UNI)
                  : (weighted ? WK_BI_W : WK_BI);
}

static void walk_regular(Walk *W, const int32_t *d, int nc, int hs, int vs)
{
    int x0 = d[0], y0 = d[1], w = d[2], h = d[3], pf = d[4], tag = d[12];
    int refs[2] = {d[5], d[6]};
    int mvs[2][2] = {{d[7], d[8]}, {d[9], d[10]}};
    for (int c = 0; c < nc; c++) {
        int chs = c ? hs : 0, cvs = c ? vs : 0;
        int slots[2], n = 0;
        for (int lx = 0; lx < 2; lx++) {
            if ((pf == PF_L0 && lx == 1) || (pf == PF_L1 && lx == 0))
                continue;
            int k = walk_plane(W, tag, lx, refs[lx], c);
            slots[n++] = c ?
                walk_chroma(W, k, x0 >> chs, y0 >> cvs, mvs[lx][0],
                            mvs[lx][1], w >> chs, h >> cvs, chs, cvs,
                            d[14], NULL) :
                walk_luma(W, k, x0, y0, mvs[lx][0], mvs[lx][1], w, h,
                          d[11], d[14], NULL);
        }
        int weighted = d[15] >> c & 1;
        walk_entry(W, tag, c, x0 >> chs, y0 >> cvs, w >> chs, h >> cvs,
                   walk_kind(n, weighted), (d[13] & 1) && !c, slots, n,
                   weighted ? d + 16 + 5 * c : NULL);
    }
}

static void walk_gpm(Walk *W, const InterParams *ip, const int32_t *d,
                     int nc, int hs, int vs)
{
    int x0 = d[0], y0 = d[1], w = d[2], h = d[3], tag = d[12];
    int refs[2] = {d[5], d[6]}, lxs[2] = {d[16], d[17]}, part = d[18];
    int mvs[2][2] = {{d[7], d[8]}, {d[9], d[10]}};
    if (part < 0 || part >= 64 || (lxs[0] | lxs[1]) & ~1) {
        W->err = WALK_RANGE;
        return;
    }
    int angle = ip->gpm_angle_idx[part];
    int wi = (31 - __builtin_clz((unsigned)w)) - 3;
    int hi = (31 - __builtin_clz((unsigned)h)) - 3;
    int32_t prm[5] = {ip->gpm_angle_to_weights[angle],
                      ip->gpm_off_x[(part * 4 + hi) * 4 + wi],
                      ip->gpm_off_y[(part * 4 + hi) * 4 + wi],
                      ip->gpm_angle_to_mirror[angle], 0};
    for (int c = 0; c < nc; c++) {
        int chs = c ? hs : 0, cvs = c ? vs : 0;
        int slots[2];
        for (int i = 0; i < 2; i++) {
            int k = walk_plane(W, tag, lxs[i], refs[i], c);
            slots[i] = c ?
                walk_chroma(W, k, x0 >> chs, y0 >> cvs, mvs[i][0],
                            mvs[i][1], w >> chs, h >> cvs, chs, cvs, d[14],
                            NULL) :
                walk_luma(W, k, x0, y0, mvs[i][0], mvs[i][1], w, h, 0,
                          d[14], NULL);
        }
        walk_entry(W, tag, c, x0 >> chs, y0 >> cvs, w >> chs, h >> cvs,
                   WK_GPM, (d[13] & 1) && !c, slots, 2, prm);
    }
}

/* affine_sb_params for a block given by position, size and CP count */
static void walk_sb_params(const InterParams *ip, int x0, int y0, int w,
                           int h, int num_cp, int lx, SbDeriv *out)
{
    int log2_cbw = 31 - __builtin_clz((unsigned)w);
    int log2_cbh = 31 - __builtin_clz((unsigned)h);
    long i4 = (long)(y0 >> 2) * ip->w4 + (x0 >> 2);
    long p4 = (long)ip->h4 * ip->w4;
    const int32_t *cp = ip->cp_mv + ((long)lx * p4 + i4) * 3 * 2;
    int D = MAX_CU_DEPTH;
    out->d_hor_x = (long long)(cp[2] - cp[0]) << (D - log2_cbw);
    out->d_ver_x = (long long)(cp[3] - cp[1]) << (D - log2_cbw);
    if (num_cp == 3) {
        out->d_hor_y = (long long)(cp[4] - cp[0]) << (D - log2_cbh);
        out->d_ver_y = (long long)(cp[5] - cp[1]) << (D - log2_cbh);
    } else {
        out->d_hor_y = -out->d_ver_x;
        out->d_ver_y = out->d_hor_x;
    }
}

static void walk_subblocks(Walk *W, const InterParams *ip,
                           const int32_t *mmi, const int32_t *d, int nc,
                           int hs, int vs)
{
    int x0 = d[0], y0 = d[1], w = d[2], h = d[3], tag = d[12];
    int flags2 = d[13], wrap = d[14], wmask = d[15];
    int affine = (flags2 & 4) != 0, lm = flags2 & 1;
    int nsbx = d[4] >> 4 & 63, nsby = d[4] >> 10 & 63;
    int sbw = w / nsbx, sbh = h / nsby;
    int prof[2] = {flags2 >> 4 & 1, flags2 >> 5 & 1};
    long p4 = (long)ip->h4 * ip->w4;
    int32_t dmx[2][16], dmy[2][16];
    if (affine) {
        int num_cp = mmi[(long)(y0 >> 2) * ip->w4 + (x0 >> 2)] + 1;
        for (int lx = 0; lx < 2; lx++)
            if (prof[lx]) {
                SbDeriv sb;
                walk_sb_params(ip, x0, y0, w, h, num_cp, lx, &sb);
                affine_diff_mvs(&sb, dmx[lx], dmy[lx]);
            }
    }
    for (int sby = 0; sby < nsby; sby++)
        for (int sbx = 0; sbx < nsbx; sbx++) {
            int x = x0 + sbx * sbw, y = y0 + sby * sbh;
            long i4 = (long)(y >> 2) * ip->w4 + (x >> 2);
            int spf = ip->mvf_pf[i4];
            int hf = affine ? 2 : ip->mvf_hpel[i4];
            int lxs[2], slots[2], n = 0;
            for (int lx = 0; lx < 2; lx++) {
                if (!(spf & (lx + 1)))
                    continue;
                const int32_t *mv = ip->mvf_mv + (lx * p4 + i4) * 2;
                int k = walk_plane(W, tag, lx, ip->mvf_ref[lx * p4 + i4], 0);
                int slot = walk_luma(W, k, x, y, mv[0], mv[1], sbw, sbh, hf,
                                     wrap, NULL);
                if (affine && prof[lx]) {
                    /* 6x6 integer-sample ring: an fclass-0 put */
                    int ring = walk_put(
                        W, k, x + (mv[0] >> 4) + ((mv[0] & 15) >> 3) - 1,
                        y + (mv[1] >> 4) + ((mv[1] & 15) >> 3) - 1, 0, 0, 6,
                        6, 1, 0, wrap, NULL);
                    if (!W->err && W->np >= W->cap_p)
                        W->err = WALK_CAP;
                    if (W->err)
                        return;
                    int32_t *p = W->prof + (long)W->np++ * WP_COLS;
                    p[0] = slot;
                    p[1] = ring;
                    memcpy(p + 2, dmx[lx], sizeof dmx[lx]);
                    memcpy(p + 18, dmy[lx], sizeof dmy[lx]);
                }
                lxs[n] = lx;
                slots[n++] = slot;
            }
            if (!n)
                continue;
            walk_entry(W, tag, 0, x, y, sbw, sbh, walk_kind(n, wmask & 1),
                       lm, slots, n, wmask & 1 ? d + 16 : NULL);
            if (nc == 1 || (affine && ((sby & vs) || (sbx & hs))))
                continue;
            /* affine: one chroma block a 2x2 group (4:2:0), its MV the
             * average of the group's first and last (derive_affine_mvc) */
            long i4b = affine ? (long)((y + vs * sbh) >> 2) * ip->w4 +
                                ((x + hs * sbw) >> 2) : i4;
            int wc = affine ? (sbw << hs) >> hs : sbw >> hs;
            int hc = affine ? (sbh << vs) >> vs : sbh >> vs;
            for (int c = 1; c <= 2; c++) {
                int cs[2];
                for (int j = 0; j < n; j++) {
                    int lx = lxs[j];
                    const int32_t *a = ip->mvf_mv + (lx * p4 + i4) * 2;
                    const int32_t *b = ip->mvf_mv + (lx * p4 + i4b) * 2;
                    int mvc[2] = {a[0], a[1]};
                    if (affine)
                        for (int k = 0; k < 2; k++) {
                            long long m = (long long)a[k] + b[k];
                            mvc[k] = (int)((m + 1 - (m >= 0)) >> 1);
                        }
                    int k = walk_plane(W, tag, lx, ip->mvf_ref[lx * p4 + i4],
                                       c);
                    cs[j] = walk_chroma(W, k, x >> hs, y >> vs, mvc[0],
                                        mvc[1], wc, hc, hs, vs, wrap, NULL);
                }
                int weighted = wmask >> c & 1;
                walk_entry(W, tag, c, x >> hs, y >> vs, wc, hc,
                           walk_kind(n, weighted), 0, cs, n,
                           weighted ? d + 16 + 5 * c : NULL);
            }
        }
}

static void walk_dmvr_bdof(Walk *W, const InterParams *ip,
                           const ReconParams *pic, const int32_t *d, int nc,
                           int hs, int vs, const int32_t *ref_mv,
                           const int32_t *ref_skip, int n_sub, int *at)
{
    int x0 = d[0], y0 = d[1], w = d[2], h = d[3], tag = d[12];
    int flags2 = d[13], wrap = d[14], hpel = d[11];
    int dmvr = (flags2 & 64) != 0, bdof = (flags2 & 128) != 0;
    int nsbx = d[4] >> 4 & 63, nsby = d[4] >> 10 & 63;
    int sbw = w / nsbx, sbh = h / nsby;
    int refs[2] = {d[5], d[6]};
    int orig[2][2] = {{d[7], d[8]}, {d[9], d[10]}};
    for (int sby = 0; sby < nsby; sby++)
        for (int sbx = 0; sbx < nsbx; sbx++) {
            int x = x0 + sbx * sbw, y = y0 + sby * sbh;
            int mv[2][2], sb_bdof = bdof, box[4];
            memcpy(mv, orig, sizeof mv);
            if (dmvr) {
                if (*at >= n_sub) {
                    W->err = WALK_REFINED;
                    return;
                }
                MvF f;
                memset(&f, 0, sizeof f);
                f.pf = PF_BI;
                for (int i = 0; i < 2; i++) {
                    mv[i][0] = f.mv[i][0] = ref_mv[*at * 4 + 2 * i];
                    mv[i][1] = f.mv[i][1] = ref_mv[*at * 4 + 2 * i + 1];
                    f.ref[i] = refs[i];
                }
                sb_bdof = bdof && !ref_skip[(*at)++];
                set_dmvr_info(ip, x, y, sbw, sbh, &f);
            }
            int slots[2], rings[2];
            for (int i = 0; i < 2; i++) {
                int k = walk_plane(W, tag, i, refs[i], 0);
                int fx = mv[i][0] & 15, fy = mv[i][1] & 15;
                int xi = x + (mv[i][0] >> 4), yi = y + (mv[i][1] >> 4);
                if (dmvr)
                    dmvr_box(pic, x + (orig[i][0] >> 4),
                             y + (orig[i][1] >> 4), sbw, sbh, 1, box);
                slots[i] = walk_put(W, k, xi, yi, fx, fy, sbw, sbh, 1, hpel,
                                    wrap, dmvr ? box : NULL);
                if (sb_bdof)
                    rings[i] = walk_put(W, k, xi + (fx >> 3) - 1,
                                        yi + (fy >> 3) - 1, 0, 0, sbw + 2,
                                        sbh + 2, 1, 0, wrap,
                                        dmvr ? box : NULL);
            }
            int32_t prm[5] = {0, 0, 0, 0, 0};
            if (sb_bdof) {
                prm[0] = rings[0];
                prm[1] = rings[1];
            }
            walk_entry(W, tag, 0, x, y, sbw, sbh, sb_bdof ? WK_BDOF : WK_BI,
                       flags2 & 1, slots, 2, sb_bdof ? prm : NULL);
            if (nc == 1)
                continue;
            for (int c = 1; c <= 2; c++) {
                for (int i = 0; i < 2; i++) {
                    int k = walk_plane(W, tag, i, refs[i], c);
                    if (dmvr)
                        dmvr_box(pic, (x >> hs) + (orig[i][0] >> (4 + hs)),
                                 (y >> vs) + (orig[i][1] >> (4 + vs)),
                                 sbw >> hs, sbh >> vs, 0, box);
                    slots[i] = walk_chroma(W, k, x >> hs, y >> vs, mv[i][0],
                                           mv[i][1], sbw >> hs, sbh >> vs,
                                           hs, vs, wrap, dmvr ? box : NULL);
                }
                walk_entry(W, tag, c, x >> hs, y >> vs, sbw >> hs, sbh >> vs,
                           WK_BI, 0, slots, 2, NULL);
            }
        }
}

static int cmp_u64(const void *a, const void *b)
{
    uint64_t x = *(const uint64_t *)a, y = *(const uint64_t *)b;
    return x < y ? -1 : x > y;
}

/* order the groups, place the rows, and renumber what refers to them */
static int walk_finish(Walk *W, int32_t *jobs, int32_t *groups,
                       int32_t *runs, int32_t *counts)
{
    int ng = W->ng, nr = 0, row = 0;
    uint64_t *ord = malloc(((size_t)ng + 1) * sizeof *ord);
    int64_t *off = malloc(((size_t)ng + 1) * sizeof *off);
    int32_t *next = malloc(((size_t)ng + 1) * sizeof *next);
    int32_t *perm = malloc(((size_t)W->n + 1) * sizeof *perm);
    int err = 0;
    if (!ord || !off || !next || !perm) {
        err = WALK_MEM;
        goto out;
    }
    for (int g = 0; g < ng; g++)
        ord[g] = (uint64_t)W->grp[g * 5] << 48 |
                 (uint64_t)W->grp[g * 5 + 1] << 32 | (uint64_t)g;
    qsort(ord, (size_t)ng, sizeof *ord, cmp_u64);
    int64_t at = 0;
    for (int i = 0; i < ng; i++) {
        int g = (int)(ord[i] & 0xFFFFFFFFu);
        const int32_t *q = W->grp + (long)g * 5;
        memcpy(groups + (long)i * 5, q, 5 * sizeof *q);
        next[g] = row;
        off[g] = at;
        if (nr && runs[(nr - 1) * 4] == q[0] &&
            runs[(nr - 1) * 4 + 1] == q[1]) {
            runs[(nr - 1) * 4 + 3] += q[4];
        } else {
            int32_t *u = runs + (long)nr++ * 4;
            u[0] = q[0]; u[1] = q[1]; u[2] = row; u[3] = q[4];
        }
        row += q[4];
        at += (int64_t)q[4] * q[0] * q[1];
    }
    if (at > INT32_MAX) {
        err = WALK_RANGE;
        goto out;
    }
    for (int r = 0; r < W->n; r++) {
        const int32_t *s = W->rows + (long)r * WR_COLS;
        const int32_t *q = W->grp + (long)s[5] * 5;
        int f = next[s[5]]++;
        int32_t *j = jobs + (long)f * WJ_COLS;
        j[0] = s[0]; j[1] = s[1]; j[2] = s[2]; j[3] = q[2]; j[4] = q[3];
        j[5] = s[3]; j[6] = s[4];
        j[7] = (int32_t)off[s[5]];
        off[s[5]] += q[0] * q[1];
        perm[r] = f;
    }
    for (int i = 0; i < W->ne; i++) {
        int32_t *e = W->ents + (long)i * WE_COLS;
        e[8] = perm[e[8]];
        if (e[9] >= 0)
            e[9] = perm[e[9]];
        if (e[6] == WK_BDOF) {
            e[10] = perm[e[10]];
            e[11] = perm[e[11]];
        }
    }
    for (int i = 0; i < W->np; i++) {
        int32_t *p = W->prof + (long)i * WP_COLS;
        p[0] = perm[p[0]];
        p[1] = perm[p[1]];
    }
    counts[0] = W->n; counts[1] = ng; counts[2] = nr;
    counts[3] = W->ne; counts[4] = W->np;
out:
    free(ord);
    free(off);
    free(next);
    free(perm);
    return err;
}

int mc_walk(int n_desc, const int32_t *desc, const int64_t *ips,
            const int64_t *mmis, const int32_t *lut, int ntags,
            const int32_t *dims, int n_planes, int nc, int hs, int vs,
            int pic_w, int pic_h, const int32_t *ref_mv,
            const int32_t *ref_skip, int n_sub, int32_t *jobs,
            int32_t *groups, int32_t *runs, int cap, int32_t *ents,
            int cap_e, int32_t *prof, int cap_p, int32_t *counts)
{
    Walk W;
    memset(&W, 0, sizeof W);
    W.lut = lut; W.dims = dims; W.n_planes = n_planes;
    W.cap = cap; W.ents = ents; W.cap_e = cap_e;
    W.prof = prof; W.cap_p = cap_p;
    if (n_planes > 1 << 16)
        return WALK_RANGE;
    W.rows = malloc(((size_t)cap + 1) * WR_COLS * sizeof *W.rows);
    W.grp = malloc(((size_t)cap + 1) * 5 * sizeof *W.grp);
    int err = W.rows && W.grp ? walk_rehash(&W, 12) : WALK_MEM;
    ReconParams pic;
    memset(&pic, 0, sizeof pic);
    pic.width = pic_w; pic.height = pic_h;
    pic.hshift1 = hs; pic.vshift1 = vs;
    int at = 0;
    for (int i = 0; i < n_desc && !err; i++) {
        const int32_t *d = desc + (long)i * 31;
        int tag = d[12], flags2 = d[13];
        if (tag < 0 || tag >= ntags) {
            err = WALK_RANGE;
            break;
        }
        const InterParams *ip = (const InterParams *)(intptr_t)ips[tag];
        if (flags2 & 2)
            walk_gpm(&W, ip, d, nc, hs, vs);
        else if (flags2 & 12)
            walk_subblocks(&W, ip, (const int32_t *)(intptr_t)mmis[tag], d,
                           nc, hs, vs);
        else if (flags2 & 192)
            walk_dmvr_bdof(&W, ip, &pic, d, nc, hs, vs, ref_mv, ref_skip,
                           n_sub, &at);
        else
            walk_regular(&W, d, nc, hs, vs);
        err = W.err;
    }
    if (!err && at != n_sub)
        err = WALK_REFINED;
    if (!err)
        err = walk_finish(&W, jobs, groups, runs, counts);
    free(W.rows);
    free(W.grp);
    free(W.hkey);
    free(W.hval);
    return err;
}

/* Copies the finals' pixels (int16, the entries' blocks one after another
 * in the order given) into the destination planes: dst[tag][c] (int32,
 * row stride in samples strides[tag][c]); luma through luts[tag] where an
 * entry's LMCS flag is set and the tag has a forward-mapping LUT. */
int mc_writeback(const int16_t *pix, const int32_t *ents, int n,
                 const int64_t *dst, const int32_t *strides,
                 const int64_t *luts)
{
    long at = 0;
    for (int i = 0; i < n; i++) {
        const int32_t *e = ents + (long)i * WE_COLS;
        int tag = e[0], c = e[1], x = e[2], y = e[3], w = e[4], h = e[5];
        int32_t *plane = (int32_t *)(intptr_t)dst[tag * 3 + c];
        long stride = strides[tag * 3 + c];
        const int32_t *lut = e[7] ? (const int32_t *)(intptr_t)luts[tag]
                                  : NULL;
        if (!plane)
            return WALK_PLANE;
        for (int yy = 0; yy < h; yy++) {
            int32_t *row = plane + (long)(y + yy) * stride + x;
            const int16_t *src = pix + at + (long)yy * w;
            if (lut)
                for (int xx = 0; xx < w; xx++)
                    row[xx] = lut[src[xx]];
            else
                for (int xx = 0; xx < w; xx++)
                    row[xx] = src[xx];
        }
        at += (long)w * h;
    }
    return 0;
}
