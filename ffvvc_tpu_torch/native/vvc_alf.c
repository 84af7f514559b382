/* Native whole-frame ALF / CC-ALF pass (host fast path).
 *
 * C transliteration of ffvvc_tpu/alf.py (the golden model, itself the
 * re-expression of the reference's ff_vvc_alf_filter,
 * libavcodec/vvc/vvc_filter.c:1254-1320 + the
 * classification/filter kernels of vvc_filter_template.c:38-410).  Must
 * match the golden bit-exactly; arbitrated by tests/test_device_filters.py
 * and the oracle-differential suite.  The device path (ops/alf_device.py)
 * is the third implementation of the same semantics.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_CTB 128
#define B_LUMA 3
#define B_CHROMA 2
#define VB_ABOVE_LUMA 4
#define VB_ABOVE_CHROMA 2
#define WIN (MAX_CTB + 2 * B_LUMA)

typedef struct {
    int width, height, ctb_log2, ctb_width, ctb_height;
    int chroma_format_idc, hs1, vs1, bit_depth;
    int lf_across_tiles, lf_across_slices;
    int32_t *plane0, *plane1, *plane2;      /* filtered in place */
    const int32_t *pre0, *pre1, *pre2;      /* pre-ALF snapshot */
    const int32_t *slice_idx;               /* [ctb_h][ctb_w] */
    const int32_t *col_bd, *row_bd;         /* [ctb_w+1], [ctb_h+1] */
    /* per-CTU */
    const int32_t *ctb_flag;    /* [nctb][3] */
    const int32_t *cc_idc;      /* [nctb][2] */
    const int32_t *fixed;       /* [nctb] */
    const int32_t *filt_idx;    /* [nctb] */
    const int32_t *aps_slot;    /* [nctb] luma APS slot */
    const int32_t *alt_idx;     /* [nctb][2] */
    /* per-slice */
    int n_slices;
    const int32_t *sl_chroma_slot;   /* [n_slices] (-1 = none) */
    const int32_t *sl_cc_slot;       /* [n_slices][2] */
    /* coefficient banks, indexed by slot */
    int n_slots;
    const int32_t *luma_coeff;       /* [slot][25][12] */
    const int32_t *luma_clip_idx;    /* [slot][25][12] */
    const int32_t *chroma_coeff;     /* [slot][8][6] */
    const int32_t *chroma_clip_idx;  /* [slot][8][6] */
    const int32_t *cc_coeff;         /* [slot][2][4][7] */
    /* constant tables */
    const int32_t *fix_coeff;        /* [64][12] */
    const int32_t *class_to_filt;    /* [16][25] */
    const int32_t *aps_class_to_filt;/* [25] */
} AlfParams;

static const int transpose_idx_tab[4][12] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    {9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6},
    {0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11},
    {9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6},
};
static const int arg_var[16] = {0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
                                3, 4};

static void edges_of(const AlfParams *ap, int rx, int ry, int *e)
{
    e[0] = rx == 0;
    e[1] = ry == 0;
    e[2] = rx == ap->ctb_width - 1;
    e[3] = ry == ap->ctb_height - 1;
    if (!ap->lf_across_tiles) {
        e[0] |= ap->col_bd[rx] == rx;
        e[1] |= ap->row_bd[ry] == ry;
        e[2] |= ap->col_bd[rx] != ap->col_bd[rx + 1];
        e[3] |= ap->row_bd[ry] != ap->row_bd[ry + 1];
    }
    if (!ap->lf_across_slices) {
        const int32_t *si = ap->slice_idx;
        int cw = ap->ctb_width;
        int cur = si[ry * cw + rx];
        e[0] |= rx > 0 && cur != si[ry * cw + rx - 1];
        e[1] |= ry > 0 && cur != si[(ry - 1) * cw + rx];
        e[2] |= rx + 1 < ap->ctb_width && cur != si[ry * cw + rx + 1];
        e[3] |= ry + 1 < ap->ctb_height && cur != si[(ry + 1) * cw + rx];
    }
}

/* (h+2b, w+2b) window with clamp-replication at unfilterable edges */
static void window(const int32_t *plane, int W, int H, int x0, int y0,
                   int w, int h, int b, const int *e, int32_t *out,
                   int ostride)
{
    for (int yy = 0; yy < h + 2 * b; yy++) {
        int sy = y0 - b + yy;
        int lo = e[1] ? y0 : 0, hi = e[3] ? y0 + h - 1 : H - 1;
        sy = sy < lo ? lo : (sy > hi ? hi : sy);
        const int32_t *row = plane + (long)sy * W;
        int32_t *dst = out + (long)yy * ostride;
        int xlo = e[0] ? x0 : 0, xhi = e[2] ? x0 + w - 1 : W - 1;
        for (int xx = 0; xx < w + 2 * b; xx++) {
            int sx = x0 - b + xx;
            sx = sx < xlo ? xlo : (sx > xhi ? xhi : sx);
            dst[xx] = row[sx];
        }
    }
}

/* classification (alf.py _classify / vvc_filter_template.c:295-382) */
static void classify(const AlfParams *ap, const int32_t *win, int ws,
                     int w, int h, int vb_pos, int32_t *class_idx,
                     int32_t *transpose, int nbx)
{
    int bd = ap->bit_depth;
    int gh = (h + 4) / 2, gw = (w + 4) / 2;
    static _Thread_local int32_t grad[(MAX_CTB / 2 + 2) *
                                      (MAX_CTB / 2 + 2) * 4];
    for (int iy = 0; iy < gh; iy++) {
        int y = iy * 2;
        int r0 = y, r1 = y + 1, r2 = y + 2, r3 = y + 3;
        if (y == vb_pos)
            r3 = r2;
        else if (y == vb_pos + 2)
            r0 = r1;
        const int32_t *row0 = win + (long)r0 * ws;
        const int32_t *row1 = win + (long)r1 * ws;
        const int32_t *row2 = win + (long)r2 * ws;
        const int32_t *row3 = win + (long)r3 * ws;
        int32_t *g = grad + (long)iy * gw * 4;
        for (int ix = 0; ix < gw; ix++) {
            int c = ix * 2 + 1;
            int v0 = row1[c] << 1;
            int v1 = row2[c + 1] << 1;
            g[ix * 4 + 0] = abs(v0 - row0[c] - row2[c]) +
                            abs(v1 - row1[c + 1] - row3[c + 1]);
            g[ix * 4 + 1] = abs(v0 - row1[c - 1] - row1[c + 1]) +
                            abs(v1 - row2[c] - row2[c + 2]);
            g[ix * 4 + 2] = abs(v0 - row0[c - 1] - row2[c + 1]) +
                            abs(v1 - row1[c] - row3[c + 2]);
            g[ix * 4 + 3] = abs(v0 - row0[c + 1] - row2[c - 1]) +
                            abs(v1 - row1[c + 2] - row3[c]);
        }
    }
    int nby = h / 4;
    for (int by = 0; by < nby; by++) {
        int y = by * 4;
        int start = 0, end = 4, ac = 2;
        if (y + 4 == vb_pos) {
            end = 3;
            ac = 3;
        } else if (y == vb_pos) {
            start = 1;
            ac = 3;
        }
        for (int bx = 0; bx < w / 4; bx++) {
            long long s[4] = {0, 0, 0, 0};
            for (int gy = by * 2 + start; gy < by * 2 + end; gy++)
                for (int gx = bx * 2; gx < bx * 2 + 4; gx++)
                    for (int k = 0; k < 4; k++)
                        s[k] += grad[((long)gy * gw + gx) * 4 + k];
            long long sv = s[0], sh = s[1], d0 = s[2], d1 = s[3];
            int dir_hv = sv <= sh;
            long long hv1 = sv > sh ? sv : sh;
            long long hv0 = sv > sh ? sh : sv;
            int dir_d = d0 <= d1;
            long long dd1 = d0 > d1 ? d0 : d1;
            long long dd0 = d0 > d1 ? d1 : d0;
            int dir1 = dd1 * hv0 <= hv1 * dd0;
            long long hvd1 = dir1 ? hv1 : dd1;
            long long hvd0 = dir1 ? hv0 : dd0;
            long long sum_hv = sh + sv;
            long long t = (sum_hv * ac) >> (bd - 1);
            if (t < 0) t = 0;
            if (t > 15) t = 15;
            int ci = arg_var[t];
            if (hvd1 * 2 > 9 * hvd0)
                ci += ((dir1 << 1) + 2) * 5;
            else if (hvd1 > 2 * hvd0)
                ci += ((dir1 << 1) + 1) * 5;
            class_idx[by * nbx + bx] = ci;
            transpose[by * nbx + bx] = dir_d * 2 + dir_hv;
        }
    }
}

static inline long long clip_pair(int32_t cur, int32_t v0, int32_t v1,
                                  int32_t clip)
{
    int a = v0 - cur;
    int b = v1 - cur;
    if (a < -clip) a = -clip;
    if (a > clip) a = clip;
    if (b < -clip) b = -clip;
    if (b > clip) b = clip;
    return a + b;
}

static void filter_luma(const AlfParams *ap, int32_t *dst, long dstride,
                        const int32_t *win, int ws, int w, int h,
                        int vb_pos, const int32_t *coeff,
                        const int32_t *clip, int nbx)
{
    int pix_max = (1 << ap->bit_depth) - 1;
    for (int y = 0; y < h; y++) {
        int o[7] = {0, 1, -1, 2, -2, 3, -3};
        if (y >= vb_pos - 4 && y < vb_pos) {
            if (y == vb_pos - 1)
                o[1] = o[2] = 0;
            if (y >= vb_pos - 2) {
                o[3] = o[1];
                o[4] = o[2];
            }
            if (y >= vb_pos - 3) {
                o[5] = o[3];
                o[6] = o[4];
            }
        } else if (y >= vb_pos && y <= vb_pos + 3) {
            if (y == vb_pos)
                o[1] = o[2] = 0;
            if (y <= vb_pos + 1) {
                o[4] = o[2];
                o[3] = o[1];
            }
            if (y <= vb_pos + 2) {
                o[6] = o[4];
                o[5] = o[3];
            }
        }
        int near_vb = y >= vb_pos - 1 && y <= vb_pos;
        const int32_t *rows[7];
        for (int k = 0; k < 7; k++)
            rows[k] = win + (long)(B_LUMA + y + o[k]) * ws;
        const int32_t *cur = rows[0] + B_LUMA;
        const int32_t *cf_row = coeff + (long)(y / 4) * nbx * 12;
        const int32_t *cl_row = clip + (long)(y / 4) * nbx * 12;
        int32_t *d = dst + (long)y * dstride;
        for (int x = 0; x < w; x++) {
            const int32_t *cf = cf_row + (long)(x / 4) * 12;
            const int32_t *cl = cl_row + (long)(x / 4) * 12;
            int32_t c = cur[x];
            long long acc = 0;
            acc += cf[0] * clip_pair(c, rows[5][B_LUMA + x],
                                     rows[6][B_LUMA + x], cl[0]);
            acc += cf[1] * clip_pair(c, rows[3][B_LUMA + x + 1],
                                     rows[4][B_LUMA + x - 1], cl[1]);
            acc += cf[2] * clip_pair(c, rows[3][B_LUMA + x],
                                     rows[4][B_LUMA + x], cl[2]);
            acc += cf[3] * clip_pair(c, rows[3][B_LUMA + x - 1],
                                     rows[4][B_LUMA + x + 1], cl[3]);
            acc += cf[4] * clip_pair(c, rows[1][B_LUMA + x + 2],
                                     rows[2][B_LUMA + x - 2], cl[4]);
            acc += cf[5] * clip_pair(c, rows[1][B_LUMA + x + 1],
                                     rows[2][B_LUMA + x - 1], cl[5]);
            acc += cf[6] * clip_pair(c, rows[1][B_LUMA + x],
                                     rows[2][B_LUMA + x], cl[6]);
            acc += cf[7] * clip_pair(c, rows[1][B_LUMA + x - 1],
                                     rows[2][B_LUMA + x + 1], cl[7]);
            acc += cf[8] * clip_pair(c, rows[1][B_LUMA + x - 2],
                                     rows[2][B_LUMA + x + 2], cl[8]);
            acc += cf[9] * clip_pair(c, rows[0][B_LUMA + x + 3],
                                     rows[0][B_LUMA + x - 3], cl[9]);
            acc += cf[10] * clip_pair(c, rows[0][B_LUMA + x + 2],
                                      rows[0][B_LUMA + x - 2], cl[10]);
            acc += cf[11] * clip_pair(c, rows[0][B_LUMA + x + 1],
                                      rows[0][B_LUMA + x - 1], cl[11]);
            acc = near_vb ? (acc + (1 << 9)) >> 10 : (acc + 64) >> 7;
            long long v = acc + c;
            d[x] = v < 0 ? 0 : (v > pix_max ? pix_max : (int32_t)v);
        }
    }
}

static void filter_chroma(const AlfParams *ap, int32_t *dst, long dstride,
                          const int32_t *win, int ws, int w, int h,
                          int vb_pos, const int32_t *coeff,
                          const int32_t *clip)
{
    int pix_max = (1 << ap->bit_depth) - 1;
    for (int y = 0; y < h; y++) {
        int o[5] = {0, 1, -1, 2, -2};
        if (y >= vb_pos - 2 && y < vb_pos) {
            if (y == vb_pos - 1)
                o[1] = o[2] = 0;
            if (y >= vb_pos - 2) {
                o[3] = o[1];
                o[4] = o[2];
            }
        } else if (y >= vb_pos && y <= vb_pos + 1) {
            if (y == vb_pos)
                o[1] = o[2] = 0;
            if (y <= vb_pos + 1) {
                o[4] = o[2];
                o[3] = o[1];
            }
        }
        int near_vb = y >= vb_pos - 1 && y <= vb_pos;
        const int32_t *rows[5];
        for (int k = 0; k < 5; k++)
            rows[k] = win + (long)(B_CHROMA + y + o[k]) * ws;
        const int32_t *cur = rows[0] + B_CHROMA;
        int32_t *d = dst + (long)y * dstride;
        for (int x = 0; x < w; x++) {
            int32_t c = cur[x];
            long long acc = 0;
            acc += coeff[0] * clip_pair(c, rows[3][B_CHROMA + x],
                                        rows[4][B_CHROMA + x], clip[0]);
            acc += coeff[1] * clip_pair(c, rows[1][B_CHROMA + x + 1],
                                        rows[2][B_CHROMA + x - 1], clip[1]);
            acc += coeff[2] * clip_pair(c, rows[1][B_CHROMA + x],
                                        rows[2][B_CHROMA + x], clip[2]);
            acc += coeff[3] * clip_pair(c, rows[1][B_CHROMA + x - 1],
                                        rows[2][B_CHROMA + x + 1], clip[3]);
            acc += coeff[4] * clip_pair(c, rows[0][B_CHROMA + x + 2],
                                        rows[0][B_CHROMA + x - 2], clip[4]);
            acc += coeff[5] * clip_pair(c, rows[0][B_CHROMA + x + 1],
                                        rows[0][B_CHROMA + x - 1], clip[5]);
            acc = near_vb ? (acc + (1 << 9)) >> 10 : (acc + 64) >> 7;
            long long v = acc + c;
            d[x] = v < 0 ? 0 : (v > pix_max ? pix_max : (int32_t)v);
        }
    }
}

static void filter_cc(const AlfParams *ap, int32_t *dst, long dstride,
                      const int32_t *luma_win, int ws, int w, int h,
                      int hs, int vs, const int32_t *coeff, int vb_pos)
{
    int bd = ap->bit_depth;
    int pix_max = (1 << bd) - 1;
    int half = 1 << (bd - 1);
    for (int y = 0; y < h; y++) {
        int pos = y << vs;
        if (!vs && (pos == vb_pos || pos == vb_pos + 1))
            continue;
        int r0 = pos - 1, r1 = pos, r2 = pos + 1, r3 = pos + 2;
        if (pos == vb_pos - 2 || pos == vb_pos + 1)
            r3 = r2;
        else if (pos == vb_pos - 1 || pos == vb_pos)
            r3 = r2 = r0 = r1;
        const int32_t *s0 = luma_win + (long)(B_LUMA + r0) * ws;
        const int32_t *s1 = luma_win + (long)(B_LUMA + r1) * ws;
        const int32_t *s2 = luma_win + (long)(B_LUMA + r2) * ws;
        const int32_t *s3 = luma_win + (long)(B_LUMA + r3) * ws;
        int32_t *d = dst + (long)y * dstride;
        for (int x = 0; x < w; x++) {
            int xx = (x << hs) + B_LUMA;
            int32_t cur = s1[xx];
            long long acc = (long long)coeff[0] * (s0[xx] - cur) +
                            (long long)coeff[1] * (s1[xx - 1] - cur) +
                            (long long)coeff[2] * (s1[xx + 1] - cur) +
                            (long long)coeff[3] * (s2[xx - 1] - cur) +
                            (long long)coeff[4] * (s2[xx] - cur) +
                            (long long)coeff[5] * (s2[xx + 1] - cur) +
                            (long long)coeff[6] * (s3[xx] - cur);
            acc = (acc + 64) >> 7;
            if (acc < -half) acc = -half;
            if (acc > half - 1) acc = half - 1;
            long long v = d[x] + acc;
            d[x] = v < 0 ? 0 : (v > pix_max ? pix_max : (int32_t)v);
        }
    }
}

int alf_frame_rows(const AlfParams *ap, int ry0, int ry1);

/* whole frame */
int alf_frame_c(const AlfParams *ap)
{
    return alf_frame_rows(ap, 0, ap->ctb_height);
}

/* CTB rows [ry0, ry1): rows are mutually independent given the pre-ALF
 * snapshot (every CTB reads `pre` + writes only its own dst region), so
 * the binding shards rows across stage threads (the deblock row-shard
 * pattern, decoder.py) */
int alf_frame_rows(const AlfParams *ap, int ry0, int ry1)
{
    static _Thread_local int32_t luma_win[WIN * WIN];
    static _Thread_local int32_t cwin[WIN * WIN];
    static _Thread_local int32_t coeff[(MAX_CTB / 4) * (MAX_CTB / 4) * 12];
    static _Thread_local int32_t clip[(MAX_CTB / 4) * (MAX_CTB / 4) * 12];
    static _Thread_local int32_t class_idx[(MAX_CTB / 4) * (MAX_CTB / 4)];
    static _Thread_local int32_t transpose[(MAX_CTB / 4) * (MAX_CTB / 4)];
    if ((1 << ap->ctb_log2) > MAX_CTB)
        return 1;
    int nc = ap->chroma_format_idc ? 3 : 1;
    int32_t *planes[3] = {ap->plane0, ap->plane1, ap->plane2};
    const int32_t *pres[3] = {ap->pre0, ap->pre1, ap->pre2};
    int clip_set[4] = {1 << ap->bit_depth, 1 << (ap->bit_depth - 3),
                       1 << (ap->bit_depth - 5), 1 << (ap->bit_depth - 7)};
    for (int ry = ry0; ry < ry1; ry++)
        for (int rx = 0; rx < ap->ctb_width; rx++) {
            int rs = ry * ap->ctb_width + rx;
            int sidx = ap->slice_idx[rs];
            if (sidx < 0 || sidx >= ap->n_slices)
                continue;
            int e[4];
            edges_of(ap, rx, ry, e);
            int have_luma_win = 0;
            int ws = 0;
            for (int c = 0; c < nc; c++) {
                int hs = c ? ap->hs1 : 0, vs = c ? ap->vs1 : 0;
                int W = ap->width >> hs, H = ap->height >> vs;
                int x0 = (rx << ap->ctb_log2) >> hs;
                int y0 = (ry << ap->ctb_log2) >> vs;
                int ctb_h = (1 << ap->ctb_log2) >> hs;
                int ctb_v = (1 << ap->ctb_log2) >> vs;
                int w = W - x0 < ctb_h ? W - x0 : ctb_h;
                int h = H - y0 < ctb_v ? H - y0 : ctb_v;
                int flag = ap->ctb_flag[rs * 3 + c];
                int cc = c ? ap->cc_idc[rs * 2 + (c - 1)] : 0;
                if (c == 0 && (flag || ap->cc_idc[rs * 2] ||
                               ap->cc_idc[rs * 2 + 1])) {
                    ws = w + 2 * B_LUMA;
                    window(pres[0], ap->width, ap->height,
                           x0, y0, w, h, B_LUMA, e, luma_win, ws);
                    have_luma_win = 1;
                }
                if (!flag && !cc)
                    continue;
                int32_t *dst = planes[c] + (long)y0 * W + x0;
                if (flag && c == 0) {
                    int vb_pos = ctb_v - VB_ABOVE_LUMA;
                    int nbx = w / 4, nby = h / 4;
                    classify(ap, luma_win, ws, w, h, vb_pos, class_idx,
                             transpose, nbx);
                    const int32_t *cset, *clidx, *c2f;
                    int fixed = ap->fixed[rs];
                    if (fixed) {
                        cset = ap->fix_coeff;
                        clidx = 0;
                        c2f = ap->class_to_filt + ap->filt_idx[rs] * 25;
                    } else {
                        int slot = ap->aps_slot[rs];
                        if (slot < 0)
                            return 2;
                        cset = ap->luma_coeff + (long)slot * 25 * 12;
                        clidx = ap->luma_clip_idx + (long)slot * 25 * 12;
                        c2f = ap->aps_class_to_filt;
                    }
                    for (int by = 0; by < nby; by++)
                        for (int bx = 0; bx < nbx; bx++) {
                            int ci = class_idx[by * nbx + bx];
                            const int *perm =
                                transpose_idx_tab[transpose[by * nbx + bx]];
                            const int32_t *src_c = cset + c2f[ci] * 12;
                            int32_t *co = coeff + ((long)by * nbx + bx) * 12;
                            int32_t *cl = clip + ((long)by * nbx + bx) * 12;
                            for (int j = 0; j < 12; j++) {
                                co[j] = src_c[perm[j]];
                                cl[j] = clip_set[
                                    clidx ? clidx[ci * 12 + perm[j]] : 0];
                            }
                        }
                    filter_luma(ap, dst, W, luma_win, ws, w, h, vb_pos,
                                coeff, clip, nbx);
                } else if (flag) {
                    int slot = ap->sl_chroma_slot[sidx];
                    if (slot < 0)
                        return 3;
                    int alt = ap->alt_idx[rs * 2 + (c - 1)];
                    int cs = w + 2 * B_CHROMA;
                    window(pres[c], W, H, x0, y0, w, h, B_CHROMA, e,
                           cwin, cs);
                    const int32_t *ccf =
                        ap->chroma_coeff + ((long)slot * 8 + alt) * 6;
                    const int32_t *cclidx =
                        ap->chroma_clip_idx + ((long)slot * 8 + alt) * 6;
                    static const int off[4] = {0, 3, 5, 7};
                    int32_t ccl[6];
                    for (int i = 0; i < 6; i++)
                        ccl[i] = 1 << (ap->bit_depth - off[cclidx[i]]);
                    int vb_pos = ctb_v - VB_ABOVE_CHROMA;
                    filter_chroma(ap, dst, W, cwin, cs, w, h, vb_pos,
                                  ccf, ccl);
                }
                if (c && cc) {
                    int slot = ap->sl_cc_slot[sidx * 2 + (c - 1)];
                    if (slot >= 0 && have_luma_win) {
                        int vb = (ctb_v << vs) - VB_ABOVE_LUMA;
                        const int32_t *ccf = ap->cc_coeff +
                            (((long)slot * 2 + (c - 1)) * 4 + (cc - 1)) * 7;
                        filter_cc(ap, dst, W, luma_win, ws, w, h, hs, vs,
                                  ccf, vb);
                    }
                }
            }
            (void)have_luma_win;
        }
    return 0;
}

int alf_sizeof_params(void) { return (int)sizeof(AlfParams); }
