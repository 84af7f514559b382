/* Native intra reconstruction core: per-CTU walk over the flat CU/TU/TB
 * records emitted by vvc_parse.c — intra prediction (incl. MIP and CCLM),
 * dequant, LFNST, MTS/DCT2 inverse transforms and residual add, all on the
 * frame planes in place.
 *
 * A C transliteration of ffvvc_tpu/recon.py's decode paths (reconstruct_cu
 * :203, predict_intra :294, cclm_pred :398, _pred_mip :823, _dequant :996,
 * _ilfnst :1086, _itx_2d :1178), which remains the golden model; must match
 * it bit-exactly (arbitrated by the oracle-differential suite).
 *
 * Reference analogue: libavcodec/vvc/vvc_intra.c:65-527 and
 * vvc_intra_template.c — re-expressed from our own Python model, not copied.
 *
 * Scope mirrors the native-parse gates: intra slices, no transform-skip /
 * BDPCM / LMCS / explicit scaling lists (the Python binding falls back).
 */
#include <stdint.h>
#include <string.h>

#include "vvc_cabac.h"   /* record strides must match vvc_parse.c */
#include "vvc_intra.h"

#include "vvc_parse.h"   /* shared record layout + enums */
#include "vvc_recon.h"   /* ReconParams / InterParams / Recon */

enum { DCT2 = 0, DST7 = 1, DCT8 = 2 };

#define INTRA_DIAG   34
#define INTRA_T_CCLM  83

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int ilog2u(int v) { return 31 - __builtin_clz((unsigned)v); }
static inline long long ll_clip(long long v, long long lo, long long hi)
{ return v < lo ? lo : (v > hi ? hi : v); }

int32_t *vvcr_plane_of(const ReconParams *rp, int c)
{
    return c == 0 ? rp->plane0 : (c == 1 ? rp->plane1 : rp->plane2);
}

long vvcr_stride_of(const ReconParams *rp, int c)
{
    return c == 0 ? rp->width : (rp->width >> rp->hshift1);
}

#define plane_of vvcr_plane_of
#define stride_of vvcr_stride_of

/* plan mode (device intra planner) — definitions further down */
static int32_t *plan_row(Recon *r);
static int plan_strip_max(const int32_t *map, int H, int W, int y0, int y1,
                          int x0, int x1);
static void plan_fill(int32_t *map, int H, int W, int y0, int h, int x0,
                      int w, int v);

/* decode_neighbour (ctu.py:348), trimmed to what recon uses */
static void recon_neighbour(Recon *r, int rx, int ry, int rs)
{
    const ReconParams *rp = r->rp;
    int ctb_size = 1 << rp->ctb_log2;
    int x_ctb = rx << rp->ctb_log2, y_ctb = ry << rp->ctb_log2;
    r->end_of_tiles_x = rp->width;
    r->end_of_tiles_y = rp->height;
    if (rp->ctb_to_col_bd[rx] != rp->ctb_to_col_bd[rx + 1])
        r->end_of_tiles_x = imin(x_ctb + ctb_size, r->end_of_tiles_x);
    if (rp->ctb_to_row_bd[ry] != rp->ctb_to_row_bd[ry + 1])
        r->end_of_tiles_y = imin(y_ctb + ctb_size, r->end_of_tiles_y);
    int bl_tile = rx > 0 &&
        rp->ctb_to_col_bd[rx] != rp->ctb_to_col_bd[rx - 1];
    int bu_tile = ry > 0 &&
        rp->ctb_to_row_bd[ry] != rp->ctb_to_row_bd[ry - 1];
    int bu_slice = ry > 0 &&
        rp->slice_idx[rs] != rp->slice_idx[rs - rp->ctb_width];
    r->ctb_left_flag = rx > 0 && !bl_tile;
    r->ctb_up_flag = ry > 0 && !bu_tile && !bu_slice;
    r->ctb_up_right_flag = r->ctb_up_flag &&
        (rp->ctb_to_col_bd[rx] == rp->ctb_to_col_bd[rx + 1]) &&
        (rp->ctb_to_row_bd[ry] == rp->ctb_to_row_bd[ry - 1]);
    r->ctb_up_left_flag = r->ctb_left_flag && r->ctb_up_flag;
}

/* set_neighbour_available (ctu.py:369) — only cand_up_left is consumed */
void vvcr_set_na(Recon *r, int x0, int y0, int w, int h)
{
    int mask = (1 << r->rp->ctb_log2) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    int cand_up = r->ctb_up_flag || y0b;
    int cand_left = r->ctb_left_flag || x0b;
    (void)cand_up; (void)cand_left; (void)w; (void)h;
    r->na_cand_up_left = (x0b || y0b) ? (cand_left && cand_up)
                                      : r->ctb_up_left_flag;
}

static void add_ra(Recon *r, int ch_type, int x0, int y0, int w, int h)
{
    const ReconParams *rp = r->rp;
    int hs = ch_type ? rp->hshift1 : 0;
    int vs = ch_type ? rp->vshift1 : 0;
    if (r->n_ras[ch_type] >= MAX_RA) { r->err = 1; return; }
    int32_t *a = r->ras[ch_type][r->n_ras[ch_type]++];
    a[0] = x0 >> hs; a[1] = y0 >> vs; a[2] = w >> hs; a[3] = h >> vs;
}

/* _get_ra (recon.py:233) */
static const int32_t *get_ra(Recon *r, int x, int y, int c_idx)
{
    int ch = c_idx > 0;
    for (int i = r->n_ras[ch] - 1; i >= 0; i--) {
        const int32_t *a = r->ras[ch][i];
        if (a[0] <= x && x < a[0] + a[2] && a[1] <= y && y < a[1] + a[3])
            return a;
        if (x >= a[0] + a[2] && y >= a[1] + a[3])
            break;
    }
    return 0;
}

/* get_top_available (recon.py:243): x, y in plane coords of c_idx */
static int top_avail(Recon *r, int cu_x0, int x, int y, int target,
                     int c_idx)
{
    const ReconParams *rp = r->rp;
    int hs = c_idx ? rp->hshift1 : 0;
    int vs = c_idx ? rp->vshift1 : 0;
    int log2_ctb_v = rp->ctb_log2 - vs;
    int end_of_ctb_x = ((cu_x0 >> rp->ctb_log2) + 1) << rp->ctb_log2;
    int y0b = y & ((1 << log2_ctb_v) - 1);
    int max_x = imin(rp->width, end_of_ctb_x) >> hs;
    if (!y0b) {
        if (!r->ctb_up_flag)
            return 0;
        target = imin(target, (r->end_of_tiles_x >> hs) - x);
        if (rp->wpp)
            target = imin(target, (end_of_ctb_x >> hs) - x);
        return target;
    }
    target = imax(0, imin(target, max_x - x));
    int px = x;
    while (target > 0) {
        const int32_t *a = get_ra(r, px, y - 1, c_idx);
        if (!a)
            break;
        int sz = imin(target, a[0] + a[2] - px);
        px += sz;
        target -= sz;
    }
    return px - x;
}

/* get_left_available (recon.py:269) */
static int left_avail(Recon *r, int cu_y0, int x, int y, int target,
                      int c_idx)
{
    const ReconParams *rp = r->rp;
    int hs = c_idx ? rp->hshift1 : 0;
    int vs = c_idx ? rp->vshift1 : 0;
    int log2_ctb_h = rp->ctb_log2 - hs;
    int x0b = x & ((1 << log2_ctb_h) - 1);
    int end_of_ctb_y = ((cu_y0 >> rp->ctb_log2) + 1) << rp->ctb_log2;
    int max_y = imin(rp->height, end_of_ctb_y) >> vs;
    if (!x0b && !r->ctb_left_flag)
        return 0;
    target = imax(0, imin(target, max_y - y));
    if (!x0b)
        return target;
    int py = y;
    while (target > 0) {
        const int32_t *a = get_ra(r, x - 1, py, c_idx);
        if (!a)
            break;
        int sz = imin(target, a[1] + a[3] - py);
        py += sz;
        target -= sz;
    }
    return py - y;
}

/* ---- intra mode geometry (recon.py:30-99, 581-650) --------------------- */

static const int ANGLES_REF[] = {
    0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32, 35,
    39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512};

static int intra_pred_angle(int mode)
{
    int idx, sign = 1;
    if (mode > INTRA_DIAG)
        idx = mode - INTRA_VERT;
    else if (mode > 0)
        idx = INTRA_HORZ - mode;
    else
        idx = INTRA_HORZ - 2 - mode;
    if (idx < 0) { idx = -idx; sign = -1; }
    return sign * ANGLES_REF[idx];
}

static int intra_inv_angle(int angle)
{
    /* round-half-away-from-zero of 32*512/angle (recon.py:43) */
    double f = 32.0 * 512.0 / angle;
    if (f < 0)
        return -(int)(-f + 0.5);
    return (int)(f + 0.5);
}

static int ref_filter_flag(int mode)
{
    switch (mode) {
    case -14: case -12: case -10: case -6: case INTRA_PLANAR:
    case 2: case 34: case 66: case 72: case 76: case 78: case 80:
        return 1;
    }
    return 0;
}

static int wide_angle_map(const int32_t *cu, int tb_w, int tb_h, int c_idx,
                          int mode)
{
    int nw, nh;
    if (cu[CU_ISP] == ISP_NO_SPLIT || c_idx) {
        nw = tb_w; nh = tb_h;
    } else {
        nw = cu[CU_W]; nh = cu[CU_H];
    }
    int ratio = ilog2u(nw) - ilog2u(nh);
    if (ratio < 0) ratio = -ratio;
    int mx = ratio > 1 ? 8 + 2 * ratio : 8;
    int mn = ratio > 1 ? 60 - 2 * ratio : 60;
    if (nw > nh && mode >= 2 && mode < mx)
        mode += 65;
    else if (nh > nw && mode <= 66 && mode > mn)
        mode -= 67;
    return mode;
}

static int nscale_derive(int w, int h, int mode)
{
    if (mode == INTRA_PLANAR || mode == INTRA_DC || mode == INTRA_HORZ ||
        mode == INTRA_VERT)
        return (ilog2u(w) + ilog2u(h) - 2) >> 2;
    int angle = intra_pred_angle(mode);
    int inv = intra_inv_angle(angle);
    int side = mode >= INTRA_VERT ? h : w;
    return imin(2, ilog2u(side) - ilog2u(3 * inv - 2) + 8);
}

static int need_pdpc(int w, int h, int bdpcm, int mode, int ref_idx)
{
    if (w >= 4 && h >= 4 && !ref_idx && !bdpcm) {
        if (mode == INTRA_PLANAR || mode == INTRA_DC ||
            mode == INTRA_HORZ || mode == INTRA_VERT)
            return 1;
        if (mode > INTRA_HORZ && mode < INTRA_VERT)
            return 0;
        return nscale_derive(w, h, mode) >= 0;
    }
    return 0;
}

/* ---- MIP (recon.py:823-911) -------------------------------------------- */

static void pred_mip(Recon *r, const int32_t *cu, int32_t *plane,
                     long stride, int x, int y, int w, int h, int c_idx)
{
    const ReconParams *rp = r->rp;
    int mx = (1 << rp->bit_depth) - 1;
    int mode_id = cu[CU_MIP_MODE], transposed = cu[CU_MIP_T];
    int size_id, boundary_size, pred_size;
    if (w == 4 && h == 4)       size_id = 0;
    else if (w == 4 || h == 4 || (w == 8 && h == 8)) size_id = 1;
    else                        size_id = 2;
    boundary_size = size_id == 0 ? 2 : 4;
    pred_size = size_id == 2 ? 8 : 4;
    int in_size = 2 * boundary_size - (size_id == 2 ? 1 : 0);
    const uint8_t *matrix;
    if (size_id == 0)
        matrix = rp->mip_4x4 + (long)mode_id * 16 * 4;
    else if (size_id == 1)
        matrix = rp->mip_8x8 + (long)mode_id * 16 * 8;
    else
        matrix = rp->mip_16x16 + (long)mode_id * 64 * 7;

    /* edge buffers with planar-like geometry (is_mip branch of
     * _edge_geometry: left_size = h+1, top_size = w+1, no smoothing) */
    int la = left_avail(r, cu[CU_Y0], x, y, h + 1, c_idx);
    int ta = top_avail(r, cu[CU_X0], x, y, w + 1, c_idx);
    int64_t left[VVC_EDGE_BUF], top[VVC_EDGE_BUF];
    memset(left, 0, sizeof(left));
    memset(top, 0, sizeof(top));
    vvc_fill_edges(plane, stride, x, y, -1, la, ta, r->na_cand_up_left,
                   h + 1, w + 1, h + 1, w + 1, 0, rp->bit_depth, left, top);
    const int64_t *L = left + VVC_EDGE_PAD;
    const int64_t *T = top + VVC_EDGE_PAD;

    /* boundary downsampling */
    long long red_t[8], red_l[8], reduced[16];
    int b_dwn_t = w / boundary_size, b_dwn_l = h / boundary_size;
    for (int i = 0; i < boundary_size; i++) {
        if (b_dwn_t == 1) {
            red_t[i] = T[i];
        } else {
            int lg = ilog2u(b_dwn_t);
            long long s = 0;
            for (int j = 0; j < b_dwn_t; j++)
                s += T[i * b_dwn_t + j];
            red_t[i] = (s + (1 << (lg - 1))) >> lg;
        }
        if (b_dwn_l == 1) {
            red_l[i] = L[i];
        } else {
            int lg = ilog2u(b_dwn_l);
            long long s = 0;
            for (int j = 0; j < b_dwn_l; j++)
                s += L[i * b_dwn_l + j];
            red_l[i] = (s + (1 << (lg - 1))) >> lg;
        }
    }
    if (transposed) {
        for (int i = 0; i < boundary_size; i++) {
            reduced[i] = red_l[i];
            reduced[boundary_size + i] = red_t[i];
        }
    } else {
        for (int i = 0; i < boundary_size; i++) {
            reduced[i] = red_t[i];
            reduced[boundary_size + i] = red_l[i];
        }
    }
    long long temp0 = reduced[0];
    int off;
    long long ow;
    if (size_id != 2) {
        off = 0;
        ow = (1LL << (rp->bit_depth - 1)) - temp0;
    } else {
        off = 1;
        ow = reduced[1] - temp0;
    }
    long long red[16];
    red[0] = ow;
    long long acc = ow;
    for (int i = 1; i < in_size; i++) {
        red[i] = reduced[i + off] - temp0;
        acc += red[i];
    }
    ow = 32 - 32 * acc;
    int up_hor = w / pred_size, up_ver = h / pred_size;

    long long predbuf[64 * 64];
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++)
            predbuf[yy * w + xx] = plane[(long)(y + yy) * stride + x + xx];
    int m = 0;
    for (int yy = 0; yy < pred_size; yy++)
        for (int xx = 0; xx < pred_size; xx++) {
            long long pred = 0;
            for (int i = 0; i < in_size; i++)
                pred += red[i] * matrix[m * in_size + i];
            m++;
            pred = ((pred + ow) >> 6) + temp0;
            pred = ll_clip(pred, 0, mx);
            if (transposed)
                predbuf[(xx * up_ver + up_ver - 1) * w +
                        yy * up_hor + up_hor - 1] = pred;
            else
                predbuf[(yy * up_ver + up_ver - 1) * w +
                        xx * up_hor + up_hor - 1] = pred;
        }
    if (up_hor > 1) {
        for (int yy = up_ver - 1; yy < h; yy += up_ver) {
            long long before = L[yy];
            for (int j = 0; j < pred_size; j++) {
                long long after = predbuf[yy * w + j * up_hor + up_hor - 1];
                for (int k = 1; k < up_hor; k++) {
                    long long mid = (up_hor - k) * before + k * after;
                    predbuf[yy * w + j * up_hor + k - 1] =
                        (mid + up_hor / 2) / up_hor;
                }
                before = after;
            }
        }
    }
    if (up_ver > 1) {
        for (int xx = 0; xx < w; xx++) {
            long long before = T[xx];
            for (int j = 0; j < pred_size; j++) {
                long long after =
                    predbuf[(j * up_ver + up_ver - 1) * w + xx];
                for (int k = 1; k < up_ver; k++) {
                    long long mid = (up_ver - k) * before + k * after;
                    predbuf[(j * up_ver + k - 1) * w + xx] =
                        (mid + up_ver / 2) / up_ver;
                }
                before = after;
            }
        }
    }
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++)
            plane[(long)(y + yy) * stride + x + xx] =
                (int32_t)predbuf[yy * w + xx];
}

/* ---- CCLM (recon.py:398-580) ------------------------------------------- */

static long long luma_px(const ReconParams *rp, int yy, int xx)
{
    return rp->plane0[(long)yy * rp->width + xx];
}

/* downsampled-luma neighbour sample at top position p (in chroma units) */
static long long cclm_ds_top(Recon *r, int x0, int y0, int p, int avail_t,
                             int avail_l)
{
    const ReconParams *rp = r->rp;
    int hs = rp->hshift1, vs = rp->vshift1;
    if (!hs && !vs)
        return luma_px(rp, y0 - avail_t, x0 + p);
    int b_ctu_boundary = !(y0 & ((1 << rp->ctb_log2) - 1));
    int xx = p << hs;
    int xl = (xx || avail_l) ? x0 + xx - 1 : x0 + xx;
    if (vs && !b_ctu_boundary) {
        int yb = y0 - 2;
        if (rp->chroma_vert_coll)
            return (luma_px(rp, yb - 1, x0 + xx) + luma_px(rp, yb, xl) +
                    4 * luma_px(rp, yb, x0 + xx) +
                    luma_px(rp, yb, x0 + xx + 1) +
                    luma_px(rp, yb + 1, x0 + xx) + 4) >> 3;
        return (luma_px(rp, yb, xl) + luma_px(rp, yb + 1, xl) +
                2 * (luma_px(rp, yb, x0 + xx) +
                     luma_px(rp, yb + 1, x0 + xx)) +
                luma_px(rp, yb, x0 + xx + 1) +
                luma_px(rp, yb + 1, x0 + xx + 1) + 4) >> 3;
    }
    int yb = y0 - 1;
    return (luma_px(rp, yb, xl) + 2 * luma_px(rp, yb, x0 + xx) +
            luma_px(rp, yb, x0 + xx + 1) + 2) >> 2;
}

/* downsampled-luma neighbour sample at left position p */
static long long cclm_ds_left(Recon *r, int x0, int y0, int p, int avail_t,
                              int avail_l)
{
    const ReconParams *rp = r->rp;
    int hs = rp->hshift1, vs = rp->vshift1;
    if (!hs && !vs)
        return luma_px(rp, y0 + p, x0 - avail_l);
    int x_src = x0 - (1 + hs) * avail_l;
    int x_l = x_src - avail_l;
    int yy = y0 + (p << vs);
    if (!vs)
        return (luma_px(rp, yy, x_l) + 2 * luma_px(rp, yy, x_src) +
                luma_px(rp, yy, x_src + 1) + 2) >> 2;
    if (rp->chroma_vert_coll) {
        long long t = ((p << vs) || avail_t) ? luma_px(rp, yy - 1, x_src)
                                             : luma_px(rp, yy, x_src);
        return (luma_px(rp, yy, x_l) + t + 4 * luma_px(rp, yy, x_src) +
                luma_px(rp, yy, x_src + 1) + luma_px(rp, yy + 1, x_src) + 4)
               >> 3;
    }
    return (luma_px(rp, yy, x_l) + luma_px(rp, yy + 1, x_l) +
            2 * luma_px(rp, yy, x_src) + 2 * luma_px(rp, yy + 1, x_src) +
            luma_px(rp, yy, x_src + 1) + luma_px(rp, yy + 1, x_src + 1) + 4)
           >> 3;
}

static void cclm_pred(Recon *r, const int32_t *cu, int x0, int y0,
                      int width, int height)
{
    const ReconParams *rp = r->rp;
    int hs = rp->hshift1, vs = rp->vshift1;
    int x = x0 >> hs, y = y0 >> vs;
    int w = width >> hs, h = height >> vs;
    long cstride = stride_of(rp, 1);
    int mx = (1 << rp->bit_depth) - 1;
    int avail_t = top_avail(r, cu[CU_X0], x0, y0, 1, 0);
    int avail_l = left_avail(r, cu[CU_Y0], x0, y0, 1, 0);
    if (r->plan_mode) {
        int pmode = cu[CU_IPM_C];
        int ns_top = 0, ns_left = 0;
        if (avail_t || avail_l) {
            if (pmode == INTRA_LT_CCLM) {
                ns_top = avail_t ? w : 0;
                ns_left = avail_l ? h : 0;
            } else {
                if (avail_t && pmode == INTRA_T_CCLM)
                    ns_top = top_avail(r, cu[CU_X0], x, y,
                                       w + imin(w, h), 1);
                if (avail_l && pmode == INTRA_T_CCLM - 1)
                    ns_left = left_avail(r, cu[CU_Y0], x, y,
                                         h + imin(w, h), 1);
            }
        }
        /* wave: chroma neighbour strips + the collocated/neighbour luma
         * window (conservative rects) */
        int Hc = rp->height >> vs, Wc = rp->width >> hs;
        int ext = imin(w, h);
        int dep = plan_strip_max(r->plan_wc, Hc, Wc, y - 1, y,
                                 x - 1, x + w + ext);
        int wl2 = plan_strip_max(r->plan_wc, Hc, Wc, y - 1, y + h + ext,
                                 x - 1, x);
        if (wl2 > dep) dep = wl2;
        int lw = plan_strip_max(r->plan_wl, rp->height, rp->width,
                                y0 - 3, y0 + ((h + ext) << vs) + 2,
                                x0 - 3, x0 + ((w + ext) << hs) + 2);
        if (lw > dep) dep = lw;
        int wave = dep + 1;
        plan_fill(r->plan_wc, Hc, Wc, y, h, x, w, wave);
        int32_t *row = plan_row(r);
        if (!row) return;
        row[PL_KIND] = PK_CCLM;
        row[PL_C_IDX] = 1;
        row[PL_X] = x; row[PL_Y] = y; row[PL_W] = w; row[PL_H] = h;
        row[PL_MODE] = pmode;
        row[PL_LA] = avail_l; row[PL_TA] = avail_t;
        row[PL_AUX0] = ns_top; row[PL_AUX1] = ns_left;
        row[PL_WAVE] = wave;
        return;
    }
    if (!avail_t && !avail_l) {
        for (int c = 1; c <= 2; c++) {
            int32_t *pl = plane_of(rp, c);
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < w; xx++)
                    pl[(long)(y + yy) * cstride + x + xx] =
                        1 << (rp->bit_depth - 1);
        }
        return;
    }
    /* select neighbour positions (recon.py _cclm_select_pos) */
    int mode = cu[CU_IPM_C];
    int num_is4 = (!avail_t || !avail_l || mode != INTRA_LT_CCLM);
    int ns_top = 0, ns_left = 0;
    if (mode == INTRA_LT_CCLM) {
        ns_top = avail_t ? w : 0;
        ns_left = avail_l ? h : 0;
    } else {
        if (avail_t && mode == INTRA_T_CCLM)
            ns_top = top_avail(r, cu[CU_X0], x, y, w + imin(w, h), 1);
        if (avail_l && mode == INTRA_T_CCLM - 1)   /* INTRA_L_CCLM */
            ns_left = left_avail(r, cu[CU_Y0], x, y, h + imin(w, h), 1);
    }
    long long a1 = 0, b1 = 1 << (rp->bit_depth - 1), k1 = 0;
    long long a2 = 0, b2 = b1, k2 = 0;
    if (ns_top || ns_left) {
        int cnt[2], pos[2][4];
        int nss[2] = {ns_top, ns_left};
        for (int side = 0; side < 2; side++) {
            int ns = nss[side];
            int start = ns >> (2 + num_is4);
            int step = imax(1, ns >> (1 + num_is4));
            cnt[side] = imin(ns, (1 + num_is4) << 1);
            for (int c = 0; c < cnt[side]; c++)
                pos[side][c] = start + c * step;
        }
        long long sel_y[4], sel_c1[4], sel_c2[4];
        int n = 0;
        int32_t *p1 = plane_of(rp, 1), *p2 = plane_of(rp, 2);
        for (int i = 0; i < cnt[0]; i++, n++) {
            sel_y[n] = cclm_ds_top(r, x0, y0, pos[0][i], avail_t, avail_l);
            sel_c1[n] = p1[(long)(y - 1) * cstride + x + pos[0][i]];
            sel_c2[n] = p2[(long)(y - 1) * cstride + x + pos[0][i]];
        }
        for (int i = 0; i < cnt[1]; i++, n++) {
            sel_y[n] = cclm_ds_left(r, x0, y0, pos[1][i], avail_t, avail_l);
            sel_c1[n] = p1[(long)(y + pos[1][i]) * cstride + x - 1];
            sel_c2[n] = p2[(long)(y + pos[1][i]) * cstride + x - 1];
        }
        if (cnt[0] + cnt[1] == 2) {
            long long ty = sel_y[0], t1 = sel_c1[0], t2 = sel_c2[0];
            sel_y[0] = sel_y[1]; sel_y[2] = sel_y[1]; sel_y[3] = ty;
            sel_y[1] = ty;
            sel_c1[0] = sel_c1[1]; sel_c1[2] = sel_c1[1]; sel_c1[3] = t1;
            sel_c1[1] = t1;
            sel_c2[0] = sel_c2[1]; sel_c2[2] = sel_c2[1]; sel_c2[3] = t2;
            sel_c2[1] = t2;
        }
        int mn[2] = {0, 2}, mxi[2] = {1, 3};
        if (sel_y[mn[0]] > sel_y[mn[1]]) { int t = mn[0]; mn[0] = mn[1]; mn[1] = t; }
        if (sel_y[mxi[0]] > sel_y[mxi[1]]) { int t = mxi[0]; mxi[0] = mxi[1]; mxi[1] = t; }
        if (sel_y[mn[0]] > sel_y[mxi[1]]) {
            int t0 = mn[0], t1_ = mn[1];
            mn[0] = mxi[0]; mn[1] = mxi[1];
            mxi[0] = t0; mxi[1] = t1_;
        }
        if (sel_y[mn[1]] > sel_y[mxi[0]]) {
            int t = mn[1]; mn[1] = mxi[0]; mxi[0] = t;
        }
        long long min_y = (sel_y[mn[0]] + sel_y[mn[1]] + 1) >> 1;
        long long max_y = (sel_y[mxi[0]] + sel_y[mxi[1]] + 1) >> 1;
        long long diff = max_y - min_y;
        static const int div_sig[16] = {0, 7, 6, 5, 5, 4, 4, 3,
                                        3, 2, 2, 1, 1, 1, 1, 0};
        long long *sel_cs[2] = {sel_c1, sel_c2};
        long long *as[2] = {&a1, &a2}, *bs[2] = {&b1, &b2},
                  *ks[2] = {&k1, &k2};
        for (int ci = 0; ci < 2; ci++) {
            long long *s = sel_cs[ci];
            long long min_c = (s[mn[0]] + s[mn[1]] + 1) >> 1;
            long long max_c = (s[mxi[0]] + s[mxi[1]] + 1) >> 1;
            if (diff == 0) {
                *as[ci] = 0; *bs[ci] = min_c; *ks[ci] = 0;
                continue;
            }
            long long diffc = max_c - min_c;
            int xsh = 63 - __builtin_clzll((unsigned long long)diff);
            int norm_diff = (int)(((diff << 4) >> xsh) & 15);
            xsh += norm_diff ? 1 : 0;
            long long ad = diffc < 0 ? -diffc : diffc;
            int ysh = ad ? 64 - __builtin_clzll((unsigned long long)ad) : 0;
            int v = div_sig[norm_diff] | 8;
            long long add = (1LL << ysh) >> 1;
            long long a = (diffc * v + add) >> ysh;
            long long k = imax(1, 3 + xsh - ysh);
            if (3 + xsh - ysh < 1)
                a = a > 0 ? 15 : (a < 0 ? -15 : 0);
            long long b = min_c - ((a * min_y) >> k);
            *as[ci] = a; *bs[ci] = b; *ks[ci] = k;
        }
    }
    /* downsampled luma for the block + apply the linear model */
    for (int yy = 0; yy < h; yy++) {
        for (int xx = 0; xx < w; xx++) {
            long long dsy;
            if (!hs && !vs) {
                dsy = luma_px(rp, y0 + yy, x0 + xx);
            } else if (!vs) {
                int xc = x0 + 2 * xx;
                int xm1 = xx == 0 ? x0 - avail_l : xc - 1;
                dsy = (luma_px(rp, y0 + yy, xm1) +
                       2 * luma_px(rp, y0 + yy, xc) +
                       luma_px(rp, y0 + yy, xc + 1) + 2) >> 2;
            } else {
                int r0 = y0 + 2 * yy;
                int xc = x0 + 2 * xx;
                int xm1 = xx == 0 ? x0 - avail_l : xc - 1;
                if (rp->chroma_vert_coll) {
                    int rt = yy == 0 ? y0 - avail_t : r0 - 1;
                    dsy = (luma_px(rp, r0, xm1) + luma_px(rp, rt, xc) +
                           4 * luma_px(rp, r0, xc) +
                           luma_px(rp, r0, xc + 1) +
                           luma_px(rp, r0 + 1, xc) + 4) >> 3;
                } else {
                    dsy = (luma_px(rp, r0, xm1) +
                           luma_px(rp, r0 + 1, xm1) +
                           2 * luma_px(rp, r0, xc) +
                           2 * luma_px(rp, r0 + 1, xc) +
                           luma_px(rp, r0, xc + 1) +
                           luma_px(rp, r0 + 1, xc + 1) + 4) >> 3;
                }
            }
            long long v1 = ((dsy * a1) >> k1) + b1;
            long long v2 = ((dsy * a2) >> k2) + b2;
            plane_of(rp, 1)[(long)(y + yy) * cstride + x + xx] =
                (int32_t)ll_clip(v1, 0, mx);
            plane_of(rp, 2)[(long)(y + yy) * cstride + x + xx] =
                (int32_t)ll_clip(v2, 0, mx);
        }
    }
}

/* ---- dequant (recon.py:996-1037; flat scale_m == 16 only) -------------- */

static void dequant(Recon *r, const int32_t *cu, const int32_t *tu,
                    const int32_t *tb, int32_t *coeffs)
{
    const ReconParams *rp = r->rp;
    int log2_range = rp->log2_range;
    int qp;
    if (tb[TB_C_IDX] == 0) {
        qp = cu[CU_QP0] + rp->qp_bd_offset;
    } else {
        int is_jcbcr = tu[TU_JCBCR] && tu[TU_CODED1] && tu[TU_CODED2];
        int idx = is_jcbcr ? JCBCR : tb[TB_C_IDX];
        qp = cu[CU_QP0 + idx];
    }
    int log2_w = ilog2u(tb[TB_W]), log2_h = ilog2u(tb[TB_H]);
    int rect_non_ts, bd_shift;
    if (tb[TB_TS]) {
        int qp_prime_ts_min = 4 + 6 * rp->min_qp_prime_ts;
        qp = imax(qp_prime_ts_min, imin(63 + rp->qp_bd_offset, qp));
        rect_non_ts = 0;
        bd_shift = 10;
    } else {
        int log_sum = log2_w + log2_h;
        rect_non_ts = log_sum & 1;
        qp = imax(0, imin(63 + rp->qp_bd_offset, qp));
        bd_shift = rp->bit_depth + rect_non_ts + log_sum / 2 + 10 -
                   log2_range + rp->dep_quant;
    }
    long long bd_offset = (1LL << bd_shift) >> 1;
    int addin = rp->dep_quant && !tb[TB_TS];
    int q = qp + addin;
    long long scale = (long long)rp->level_scale[rect_non_ts * 6 + q % 6]
                      << (q / 6);
    long long lo = -(1LL << log2_range), hi = (1LL << log2_range) - 1;
    int n = tb[TB_W] * tb[TB_H];
    long long sxm = scale * 16;   /* flat scale_m == 16 */
    for (int i = 0; i < n; i++) {
        long long v = (coeffs[i] * sxm + bd_offset) >> bd_shift;
        coeffs[i] = (int32_t)ll_clip(v, lo, hi);
    }
}

/* ---- LFNST (recon.py:1086-1155) ----------------------------------------- */

static int lfnst_pred_mode(Recon *r, const int32_t *cu, const int32_t *tb)
{
    const ReconParams *rp = r->rp;
    int x_tb = tb[TB_X0] >> 2, y_tb = tb[TB_Y0] >> 2;
    int x_c = (tb[TB_X0] + ((tb[TB_W] << rp->hshift1) >> 1)) >> 2;
    int y_c = (tb[TB_Y0] + ((tb[TB_H] << rp->vshift1) >> 1)) >> 2;
    int mip = rp->imf[y_tb * rp->w4 + x_tb];
    int mode = tb[TB_C_IDX] == 0 ? cu[CU_IPM_Y] : cu[CU_IPM_C];
    if (mip && !tb[TB_C_IDX]) {
        mode = INTRA_PLANAR;
    } else if (mode >= INTRA_LT_CCLM && mode <= INTRA_T_CCLM) {
        if (rp->imf[y_c * rp->w4 + x_c])
            mode = INTRA_PLANAR;
        else if (rp->cpm0[y_c * rp->w4 + x_c] == MODE_IBC ||
                 rp->cpm0[y_c * rp->w4 + x_c] == MODE_PLT)
            mode = INTRA_DC;
        else
            mode = rp->ipm[y_c * rp->w4 + x_c];
    }
    return wide_angle_map(cu, tb[TB_W], tb[TB_H], tb[TB_C_IDX], mode);
}

/* 4x4 up-right diagonal scan (matches ops/data.py diag_scan(4, 4)) */
static const uint8_t scan44_x[16] = {0, 0, 1, 0, 1, 2, 0, 1,
                                     2, 3, 1, 2, 3, 2, 3, 3};
static const uint8_t scan44_y[16] = {0, 1, 0, 2, 1, 0, 3, 2,
                                     1, 0, 3, 2, 1, 3, 2, 3};

static void ilfnst(Recon *r, const int32_t *cu, int32_t *tbrec,
                   int32_t *coeffs, int64_t *out /* [h][w] */)
{
    const ReconParams *rp = r->rp;
    int w = tbrec[TB_W], h = tbrec[TB_H];
    int n_out = (w >= 8 && h >= 8) ? 48 : 16;
    int log2_size = (w >= 8 && h >= 8) ? 3 : 2;
    int n_size = 1 << log2_size;
    int non_zero = ((w == 8 && h == 8) || (w == 4 && h == 4)) ? 8 : 16;
    int pred_mode = lfnst_pred_mode(r, cu, tbrec);
    int transpose = pred_mode > 34;
    long long u[16];
    for (int i = 0; i < non_zero; i++)
        u[i] = coeffs[scan44_y[i] * w + scan44_x[i]];
    int set_idx = pred_mode < 0 ? 1 : rp->lfnst_set_idx[pred_mode];
    const int8_t *mat = n_out > 16
        ? rp->lfnst_8x8 + ((long)set_idx * 2 + cu[CU_LFNST] - 1) * 16 * 48
        : rp->lfnst_4x4 + ((long)set_idx * 2 + cu[CU_LFNST] - 1) * 16 * 16;
    long long v[48];
    long long lo = -(1LL << rp->log2_range), hi = (1LL << rp->log2_range) - 1;
    for (int j = 0; j < n_out; j++) {
        long long s = 0;
        for (int i = 0; i < non_zero; i++)
            s += u[i] * mat[i * n_out + j];
        v[j] = ll_clip((s + 64) >> 7, lo, hi);
    }
    for (int i = 0; i < h * w; i++)
        out[i] = 0;
    if (transpose) {
        if (n_size == 4) {
            for (int yy = 0; yy < 4; yy++)
                for (int xx = 0; xx < 4; xx++)
                    out[yy * w + xx] = v[xx * 4 + yy];
        } else {
            for (int yy = 0; yy < 8; yy++) {
                out[yy * w + 0] = v[yy];
                out[yy * w + 1] = v[8 + yy];
                out[yy * w + 2] = v[16 + yy];
                out[yy * w + 3] = v[24 + yy];
                if (yy < 4) {
                    out[yy * w + 4] = v[32 + yy];
                    out[yy * w + 5] = v[36 + yy];
                    out[yy * w + 6] = v[40 + yy];
                    out[yy * w + 7] = v[44 + yy];
                }
            }
        }
    } else {
        int k = 0;
        for (int yy = 0; yy < n_size; yy++) {
            int size = yy < 4 ? n_size : 4;
            for (int xx = 0; xx < size; xx++)
                out[yy * w + xx] = v[k++];
        }
    }
    tbrec[TB_MAX_SCAN_X] = n_size - 1;
    tbrec[TB_MAX_SCAN_Y] = n_size - 1;
}

/* ---- transform type + 2-D inverse transform (recon.py:1157-1226) ------- */

static const int32_t *tx_matrix(const ReconParams *rp, int type, int n)
{
    if (type == DCT2)
        switch (n) {
        case 2: return rp->dct2_2;
        case 4: return rp->dct2_4;
        case 8: return rp->dct2_8;
        case 16: return rp->dct2_16;
        case 32: return rp->dct2_32;
        default: return rp->dct2_64;
        }
    if (type == DST7)
        switch (n) {
        case 4: return rp->dst7_4;
        case 8: return rp->dst7_8;
        case 16: return rp->dst7_16;
        default: return rp->dst7_32;
        }
    switch (n) {
    case 4: return rp->dct8_4;
    case 8: return rp->dct8_8;
    case 16: return rp->dct8_16;
    default: return rp->dct8_32;
    }
}

static void transform_type(const ReconParams *rp, const int32_t *cu,
                           const int32_t *tb, int *trh, int *trv)
{
    if (tb[TB_C_IDX] || (cu[CU_ISP] != ISP_NO_SPLIT && cu[CU_LFNST])) {
        *trh = *trv = DCT2;
        return;
    }
    int sbt = cu[CU_SBT] & 1;
    int implicit = 0;
    if (rp->sps_mts) {
        int mx = tb[TB_W] > tb[TB_H] ? tb[TB_W] : tb[TB_H];
        if (cu[CU_ISP] != ISP_NO_SPLIT || (sbt && mx <= 32) ||
            (!rp->sps_explicit_mts_intra &&
             cu[CU_PRED_MODE] == MODE_INTRA && !cu[CU_LFNST] &&
             !cu[CU_MIP_FLAG]))
            implicit = 1;
    }
    if (implicit) {
        if (sbt) {
            int hor = (cu[CU_SBT] >> 1) & 1, pos = (cu[CU_SBT] >> 2) & 1;
            *trh = (hor || pos) ? DST7 : DCT8;
            *trv = (!hor || pos) ? DST7 : DCT8;
            return;
        }
        *trh = (tb[TB_W] >= 4 && tb[TB_W] <= 16) ? DST7 : DCT2;
        *trv = (tb[TB_H] >= 4 && tb[TB_H] <= 16) ? DST7 : DCT2;
        return;
    }
    static const int to_trh[5] = {DCT2, DST7, DCT8, DST7, DCT8};
    static const int to_trv[5] = {DCT2, DST7, DST7, DCT8, DCT8};
    *trh = to_trh[cu[CU_MTS]];
    *trv = to_trv[cu[CU_MTS]];
}

/* itx_2d on int64 (recon.py:1178-1226); in64 != NULL when LFNST already
 * produced int64 coeffs, else coeffs (int32) are the input.  Result in
 * res64 [h*w]. */
static void itx_2d(Recon *r, const int32_t *tb, const int32_t *coeffs,
                   const int64_t *in64, int trh, int trv, int64_t *res64)
{
    const ReconParams *rp = r->rp;
    int log2_range = rp->log2_range;
    int bd = rp->bit_depth;
    int w = tb[TB_W], h = tb[TB_H];
    int nzw = tb[TB_MAX_SCAN_X] + 1, nzh = tb[TB_MAX_SCAN_Y] + 1;
    long long lo = -(1LL << log2_range), hi = (1LL << log2_range) - 1;
#define IN(yy, xx) (in64 ? in64[(yy) * w + (xx)] : (long long)coeffs[(yy) * w + (xx)])
    if (w == 1 || h == 1) {
        int shift = 6 + log2_range - bd;
        long long add = 1LL << (shift - 1);
        if (nzw == 1 && nzh == 1 && trh == DCT2 && trv == DCT2) {
            long long dc = (IN(0, 0) * 64 + add) >> shift;
            for (int i = 0; i < w * h; i++)
                res64[i] = dc;
            return;
        }
        if (w > 1) {
            const int32_t *m = tx_matrix(rp, trh, w);
            for (int xx = 0; xx < w; xx++) {
                long long s = 0;
                for (int k = 0; k < nzw; k++)
                    s += IN(0, k) * m[k * w + xx];
                res64[xx] = (s + add) >> shift;
            }
        } else {
            const int32_t *m = tx_matrix(rp, trv, h);
            for (int yy = 0; yy < h; yy++) {
                long long s = 0;
                for (int k = 0; k < nzh; k++)
                    s += IN(k, 0) * m[k * h + yy];
                res64[yy] = (s + add) >> shift;
            }
        }
        return;
    }
    int shift0 = 7;
    int shift1 = 5 + log2_range - bd;
    if (w == h && nzw == 1 && nzh == 1 && trh == DCT2 && trv == DCT2) {
        long long t = (IN(0, 0) * 64 + (1LL << (shift0 - 1))) >> shift0;
        long long dc = (t * 64 + (1LL << (shift1 - 1))) >> shift1;
        for (int i = 0; i < w * h; i++)
            res64[i] = dc;
        return;
    }
    const int32_t *mv = tx_matrix(rp, trv, h);
    const int32_t *mh = tx_matrix(rp, trh, w);
    if (log2_range <= 15) {
        /* int32 fast path: |in| <= 2^15 (dequant/LFNST clip), matrix
         * coefficients <= 128, <= 64 taps => accumulators stay < 2^28.
         * Loops are ordered scalar-times-contiguous-row so gcc
         * autovectorizes both passes. */
        static _Thread_local int32_t tmp32[64 * 64];
        int32_t lo32 = (int32_t)lo, hi32 = (int32_t)hi;
        int32_t off0 = 1 << (shift0 - 1);
        for (int yy = 0; yy < h; yy++) {
            int32_t acc[64] = {0};
            for (int k = 0; k < nzh; k++) {
                int32_t m = mv[k * h + yy];
                if (!m)
                    continue;
                if (in64) {
                    const int64_t *row = in64 + (long)k * w;
                    for (int xx = 0; xx < nzw; xx++)
                        acc[xx] += m * (int32_t)row[xx];
                } else {
                    const int32_t *row = coeffs + (long)k * w;
                    for (int xx = 0; xx < nzw; xx++)
                        acc[xx] += m * row[xx];
                }
            }
            int32_t *t = tmp32 + yy * w;
            for (int xx = 0; xx < nzw; xx++) {
                int32_t v = (acc[xx] + off0) >> shift0;
                t[xx] = v < lo32 ? lo32 : (v > hi32 ? hi32 : v);
            }
        }
        int32_t off1 = 1 << (shift1 - 1);
        for (int yy = 0; yy < h; yy++) {
            int32_t acc[64] = {0};
            const int32_t *t = tmp32 + yy * w;
            for (int k = 0; k < nzw; k++) {
                int32_t tv = t[k];
                if (!tv)
                    continue;
                const int32_t *mr = mh + k * w;
                for (int xx = 0; xx < w; xx++)
                    acc[xx] += tv * mr[xx];
            }
            int64_t *res = res64 + yy * w;
            for (int xx = 0; xx < w; xx++)
                res[xx] = (acc[xx] + off1) >> shift1;
        }
        return;
    }
    /* extended-precision (log2_range > 15) int64 path */
    static _Thread_local long long tmp[64 * 64];
    for (int yy = 0; yy < h; yy++) {
        for (int xx = 0; xx < nzw; xx++) {
            long long s = 0;
            for (int k = 0; k < nzh; k++)
                s += (long long)mv[k * h + yy] * IN(k, xx);
            tmp[yy * w + xx] =
                ll_clip((s + (1LL << (shift0 - 1))) >> shift0, lo, hi);
        }
    }
    for (int yy = 0; yy < h; yy++) {
        for (int xx = 0; xx < w; xx++) {
            long long s = 0;
            for (int k = 0; k < nzw; k++)
                s += tmp[yy * w + k] * mh[k * w + xx];
            res64[yy * w + xx] = (s + (1LL << (shift1 - 1))) >> shift1;
        }
    }
#undef IN
}

/* ---- plan mode (device intra planner, ops/intra_device.py) -------------- */

static int32_t *plan_row(Recon *r)
{
    if (r->plan_n >= r->plan_cap) { r->err = 5; return 0; }
    int32_t *row = r->plan_buf + r->plan_n * PLAN_STRIDE;
    r->plan_n++;
    memset(row, 0, PLAN_STRIDE * sizeof(int32_t));
    return row;
}

static int plan_strip_max(const int32_t *map, int H, int W, int y0, int y1,
                          int x0, int x1)
{
    int m = 0;
    if (y0 < 0) y0 = 0;
    if (x0 < 0) x0 = 0;
    if (y1 > H) y1 = H;
    if (x1 > W) x1 = W;
    for (int y = y0; y < y1; y++) {
        const int32_t *rw = map + (long)y * W;
        for (int x = x0; x < x1; x++)
            if (rw[x] > m) m = rw[x];
    }
    return m;
}

static void plan_fill(int32_t *map, int H, int W, int y0, int h, int x0,
                      int w, int v)
{
    int y1 = imin(H, y0 + h), x1 = imin(W, x0 + w);
    for (int y = imax(0, y0); y < y1; y++) {
        int32_t *rw = map + (long)y * W;
        for (int x = imax(0, x0); x < x1; x++)
            rw[x] = v;
    }
}

/* ---- intra prediction driver (recon.py:334-392 intra_pred) -------------- */

void vvcr_intra_pred(Recon *r, const int32_t *cu, int x0, int y0,
                     int width, int height, int c_idx)
{
    const ReconParams *rp = r->rp;
    int hs = c_idx ? rp->hshift1 : 0;
    int vs = c_idx ? rp->vshift1 : 0;
    int x = x0 >> hs, y = y0 >> vs;
    int w = width >> hs, h = height >> vs;
    int32_t *plane = plane_of(rp, c_idx);
    long stride = stride_of(rp, c_idx);
    int pred_mode = c_idx ? cu[CU_IPM_C] : cu[CU_IPM_Y];
    int mode = wide_angle_map(cu, w, h, c_idx, pred_mode);
    int xc4 = x0 >> 2, yc4 = y0 >> 2;
    int intra_mip = rp->imf[yc4 * rp->w4 + xc4];
    int is_mip = intra_mip && (!c_idx || cu[CU_MIP_CHROMA_DIRECT]);
    int ref_idx = c_idx ? 0 : cu[CU_MRL];
    int bdpcm = (&cu[CU_BDPCM0])[c_idx];
    int pdpc = is_mip ? 0 : need_pdpc(w, h, bdpcm, mode, ref_idx);

    /* _edge_geometry (recon.py:581) */
    int rff = is_mip ? 0 : ref_filter_flag(mode);
    int filter_smoothing = (!ref_idx && w * h > 32 && !c_idx &&
                            cu[CU_ISP] == ISP_NO_SPLIT && rff);
    int refw = 0, refh = 0, angle = 0, inv_angle = 0;
    int left_size, top_size, unf_left, unf_top;
    if (is_mip || mode == INTRA_PLANAR) {
        left_size = h + 1; top_size = w + 1;
        unf_left = left_size + filter_smoothing;
        unf_top = top_size + filter_smoothing;
    } else if (mode == INTRA_DC) {
        unf_left = left_size = h;
        unf_top = top_size = w;
    } else if (mode == INTRA_VERT) {
        unf_left = left_size = pdpc ? h : 1;
        unf_top = top_size = w;
    } else if (mode == INTRA_HORZ) {
        unf_left = left_size = h;
        unf_top = top_size = pdpc ? w : 1;
    } else {
        if (cu[CU_ISP] == ISP_NO_SPLIT || c_idx) {
            refw = w * 2; refh = h * 2;
        } else {
            refw = (cu[CU_W] >> hs) + w;
            refh = (cu[CU_H] >> vs) + h;
        }
        angle = intra_pred_angle(mode);
        inv_angle = intra_inv_angle(angle);
        unf_top = top_size = refw;
        unf_left = left_size = refh;
    }
    int la = left_avail(r, cu[CU_Y0], x, y, unf_left, c_idx);
    int ta = top_avail(r, cu[CU_X0], x, y, unf_top, c_idx);

    /* _filter_flag (recon.py:618) */
    int filter_flag = 0;
    if (!is_mip && mode != INTRA_PLANAR && mode != INTRA_DC && !rff &&
        !ref_idx && cu[CU_ISP] == ISP_NO_SPLIT) {
        int d50 = mode - 50, d18 = mode - 18;
        if (d50 < 0) d50 = -d50;
        if (d18 < 0) d18 = -d18;
        int min_dist = imin(d50, d18);
        static const int thres[5] = {24, 14, 2, 0, 0};
        int ntbs = (ilog2u(w) + ilog2u(h)) >> 1;
        filter_flag = min_dist > thres[ntbs - 2];
    }
    int nscale = 0;
    if (!is_mip && pdpc && mode != INTRA_PLANAR && mode != INTRA_DC &&
        mode != INTRA_VERT && mode != INTRA_HORZ)
        nscale = nscale_derive(w, h, mode);

    if (r->plan_mode) {
        /* emit a descriptor instead of predicting; wave = 1 + max wave
         * over the reference strips the gather reads (left column
         * x+rl rows [y+rl, y+la); top row y+rl cols [x+rl, x+ta) —
         * substitution/extension entries COPY indices inside these) */
        int Hp = rp->height >> vs, Wp = rp->width >> hs;
        int32_t *map = c_idx ? r->plan_wc : r->plan_wl;
        int rl = -1 - ref_idx;
        int dep = plan_strip_max(map, Hp, Wp, y + rl, y + la,
                                 x + rl, x + rl + 1);
        int wt = plan_strip_max(map, Hp, Wp, y + rl, y + rl + 1,
                                x + rl, x + ta);
        if (wt > dep) dep = wt;
        /* wavefront depth scheduling: units of one wave are mutually
         * independent and batch per shape (the anti-diagonal grouping a
         * decode-order greedy cannot see) */
        int kind0 = is_mip ? PK_MIP :
            (mode == INTRA_PLANAR || mode == INTRA_DC ||
             mode == INTRA_VERT || mode == INTRA_HORZ) ? PK_SIMPLE :
            (mode >= INTRA_DIAG ? PK_ANG_V : PK_ANG_H);
        int wave = dep + 1;
        plan_fill(map, Hp, Wp, y, h, x, w, wave);
        int32_t *row = plan_row(r);
        if (!row) return;
        row[PL_KIND] = kind0;
        row[PL_C_IDX] = c_idx;
        row[PL_X] = x; row[PL_Y] = y; row[PL_W] = w; row[PL_H] = h;
        row[PL_MODE] = mode; row[PL_ANGLE] = angle;
        row[PL_INV_ANGLE] = inv_angle; row[PL_REF_IDX] = ref_idx;
        row[PL_FF] = filter_flag; row[PL_PDPC] = pdpc;
        row[PL_NSCALE] = nscale;
        row[PL_LA] = la; row[PL_TA] = ta;
        row[PL_CUL] = r->na_cand_up_left;
        row[PL_UNF_LEFT] = unf_left; row[PL_UNF_TOP] = unf_top;
        row[PL_REFW] = refw; row[PL_REFH] = refh;
        row[PL_LEFT_SIZE] = left_size;
        row[PL_RFFFSM] = rff && filter_smoothing;
        if (is_mip) {
            row[PL_AUX0] = cu[CU_MIP_MODE];
            row[PL_AUX1] = cu[CU_MIP_T];
        }
        row[PL_WAVE] = wave;
        return;
    }

    if (is_mip) {
        pred_mip(r, cu, plane, stride, x, y, w, h, c_idx);
        return;
    }
    vvc_intra_pred(plane, stride, x, y, w, h, c_idx, mode, ref_idx, pdpc,
                   rff && filter_smoothing, left_size, top_size, unf_left,
                   unf_top, refw, refh, angle, inv_angle, filter_flag,
                   nscale, la, ta, r->na_cand_up_left, rp->bit_depth,
                   rp->fc_filt, rp->fg_filt);
}

/* ---- TU residual add (recon.py itransform :914 + _jcbcr :940) ----------- */

static void add_residual(Recon *r, const int64_t *res, int x, int y, int w,
                         int h, int c_idx)
{
    const ReconParams *rp = r->rp;
    long stride = stride_of(rp, c_idx);
    if (r->residual_only) {
        /* device intra path: stash the raw residual; the device kernels
         * later compute clip(pred + res) per predict unit, which matches
         * the sequential add exactly (TB regions are disjoint per plane) */
        int32_t *rpn = r->res_planes[c_idx];
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++)
                rpn[(long)(y + yy) * stride + x + xx] =
                    (int32_t)res[yy * w + xx];
        return;
    }
    int32_t *plane = plane_of(rp, c_idx);
    long long mx = (1 << rp->bit_depth) - 1;
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++) {
            long long v = plane[(long)(y + yy) * stride + x + xx] +
                          res[yy * w + xx];
            plane[(long)(y + yy) * stride + x + xx] =
                (int32_t)ll_clip(v, 0, mx);
        }
}

static void itransform_tu(Recon *r, const int32_t *cu, const int32_t *tu,
                          const int32_t *tbs, int32_t *coeff_pool,
                          int target_ch_type)
{
    const ReconParams *rp = r->rp;
    static _Thread_local int64_t res[64 * 64], lf[64 * 64];
    for (int t = 0; t < tu[TU_TB_COUNT]; t++) {
        int32_t tb[TB_STRIDE];
        memcpy(tb, tbs + t * TB_STRIDE, sizeof(tb));
        int c_idx = tb[TB_C_IDX];
        int ch_type = c_idx > 0;
        if (ch_type != target_ch_type || !tb[TB_HAS_COEFFS])
            continue;
        int32_t *coeffs = coeff_pool + tb[TB_COEFF_OFF];
        /* BDPCM: directional cumsum of the raw levels BEFORE dequant
         * (recon.py compute_residual / _transform_bdpcm) */
        if ((&cu[CU_BDPCM0])[c_idx]) {
            int mode = c_idx ? cu[CU_IPM_C] : cu[CU_IPM_Y];
            int vert = mode == 50;   /* INTRA_VERT */
            long long lo = -(1LL << rp->log2_range);
            long long hi = (1LL << rp->log2_range) - 1;
            int tw = tb[TB_W], th = tb[TB_H];
            if (vert) {
                for (int xx = 0; xx < tw; xx++) {
                    long long acc = 0;
                    for (int yy = 0; yy < th; yy++) {
                        acc = ll_clip(acc + coeffs[yy * tw + xx], lo, hi);
                        coeffs[yy * tw + xx] = (int32_t)acc;
                    }
                }
                tb[TB_MAX_SCAN_Y] = th - 1;
            } else {
                for (int yy = 0; yy < th; yy++) {
                    long long acc = 0;
                    for (int xx = 0; xx < tw; xx++) {
                        acc = ll_clip(acc + coeffs[yy * tw + xx], lo, hi);
                        coeffs[yy * tw + xx] = (int32_t)acc;
                    }
                }
                tb[TB_MAX_SCAN_X] = tw - 1;
            }
        }
        dequant(r, cu, tu, tb, coeffs);
        if (tb[TB_TS]) {
            /* transform skip: the dequantized levels ARE the residual */
            int n = tb[TB_W] * tb[TB_H];
            for (int k = 0; k < n; k++)
                res[k] = coeffs[k];
        } else {
            const int64_t *in64 = 0;
            if ((&cu[CU_ALF0])[c_idx]) {         /* apply_lfnst_flag */
                ilfnst(r, cu, tb, coeffs, lf);
                in64 = lf;
            }
            int trh, trv;
            transform_type(rp, cu, tb, &trh, &trv);
            itx_2d(r, tb, coeffs, in64, trh, trv, res);
        }
        int hs = c_idx ? rp->hshift1 : 0;
        int vs = c_idx ? rp->vshift1 : 0;
        int x = tb[TB_X0] >> hs, y = tb[TB_Y0] >> vs;
        add_residual(r, res, x, y, tb[TB_W], tb[TB_H], c_idx);
        if (tu[TU_JCBCR] && c_idx) {
            /* _jcbcr (recon.py:940): res here is the post-itx residual */
            int shift = tu[TU_CODED1] ^ tu[TU_CODED2];
            int c2 = 1 + tu[TU_CODED1];
            int n = tb[TB_W] * tb[TB_H];
            for (int i = 0; i < n; i++) {
                long long v = res[i] * rp->jcbcr_sign;
                res[i] = v >> shift;
            }
            add_residual(r, res, x, y, tb[TB_W], tb[TB_H], c2);
        }
    }
}

/* ---- CU / CTU walk (recon.py:139-226) ----------------------------------- */

static void recon_cu(Recon *r, const int32_t *cu, const int32_t *tu_recs,
                     const int32_t *tb_recs, int32_t *coeff_pool)
{
    const ReconParams *rp = r->rp;
    int start = cu[CU_TREE_TYPE] == DUAL_TREE_CHROMA ? 1 : 0;
    int end = (rp->chroma_format_idc &&
               cu[CU_TREE_TYPE] != DUAL_TREE_LUMA) ? 1 : 0;
    if (cu[CU_PRED_MODE] != MODE_INTRA) {
        /* inter CU: MC already ran in the inter pass; CIIP blends here,
         * then recon adds residuals + marks reconstructed areas
         * (recon.py reconstruct_cu :213-227) */
        /* residual-only mode touches no prediction: inter CUs just emit
         * their TB residuals (the caller guarantees no CIIP there) */
        if (cu[CU_PRED_MODE] == MODE_PLT ||
            (!r->ip && !r->residual_only)) { r->err = 3; return; }
        if (cu[CU_IFLAGS] & IF_CIIP) {
            if (!r->ip) { r->err = 3; return; }
            vvci_predict_ciip(r, cu);
        }
        if (!cu[CU_CODED]) {
            add_ra(r, 0, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
            add_ra(r, 1, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
            return;
        }
        for (int ch_type = start; ch_type <= end; ch_type++) {
            for (int i = 0; i < cu[CU_TU_COUNT]; i++) {
                const int32_t *tu = tu_recs +
                    (cu[CU_TU_START] + i) * TU_STRIDE;
                const int32_t *tbs = tb_recs + tu[TU_TB_START] * TB_STRIDE;
                add_ra(r, ch_type, tu[TU_X0], tu[TU_Y0], tu[TU_W],
                       tu[TU_H]);
                itransform_tu(r, cu, tu, tbs, coeff_pool, ch_type);
                if (r->err)
                    return;
            }
        }
        return;
    }
    for (int ch_type = start; ch_type <= end; ch_type++) {
        for (int i = 0; i < cu[CU_TU_COUNT]; i++) {
            const int32_t *tu = tu_recs + (cu[CU_TU_START] + i) * TU_STRIDE;
            const int32_t *tbs = tb_recs + tu[TU_TB_START] * TB_STRIDE;
            /* predict_intra (recon.py:294); narrow ISP_VER subpartitions
             * predict MIN_ISP_PRED_WIDTH=4 wide, once per group
             * (reference get_luma_predict_unit, vvc_intra.c:216-227) */
            if (!ch_type && cu[CU_TREE_TYPE] != DUAL_TREE_CHROMA) {
                int pw = tu[TU_W], do_luma = 1;
                if (cu[CU_ISP] == ISP_VER_SPLIT && pw < 4) {
                    do_luma = !(i % (4 / pw));
                    pw = 4;
                }
                if (do_luma) {
                    if (!r->residual_only) {
                        vvcr_set_na(r, tu[TU_X0], tu[TU_Y0], pw, tu[TU_H]);
                        vvcr_intra_pred(r, cu, tu[TU_X0], tu[TU_Y0], pw,
                                        tu[TU_H], 0);
                    }
                    add_ra(r, 0, tu[TU_X0], tu[TU_Y0], pw, tu[TU_H]);
                }
            }
            if (ch_type && cu[CU_TREE_TYPE] != DUAL_TREE_LUMA) {
                /* _chroma_predict_unit (recon.py:324) */
                int has_chroma = 0;
                for (int t = 0; t < tu[TU_TB_COUNT]; t++)
                    if (tbs[t * TB_STRIDE + TB_C_IDX])
                        has_chroma = 1;
                int px = tu[TU_X0], py = tu[TU_Y0];
                int pw = tu[TU_W], ph = tu[TU_H], do_pred = 1;
                if (cu[CU_ISP] == ISP_NO_SPLIT) {
                    if (!has_chroma && cu[CU_TREE_TYPE] == SINGLE_TREE)
                        do_pred = 0;
                } else if (i == cu[CU_NSP] - 1) {
                    px = cu[CU_X0]; py = cu[CU_Y0];
                    pw = cu[CU_W]; ph = cu[CU_H];
                } else {
                    do_pred = 0;
                }
                if (do_pred) {
                    if (!r->residual_only) {
                        vvcr_set_na(r, px, py, pw, ph);
                        if (cu[CU_IPM_C] >= INTRA_LT_CCLM &&
                            cu[CU_IPM_C] <= INTRA_T_CCLM) {
                            cclm_pred(r, cu, px, py, pw, ph);
                        } else {
                            vvcr_intra_pred(r, cu, px, py, pw, ph, 1);
                            vvcr_intra_pred(r, cu, px, py, pw, ph, 2);
                        }
                    }
                    add_ra(r, 1, px, py, pw, ph);
                }
            }
            if (!r->plan_mode)
                itransform_tu(r, cu, tu, tbs, coeff_pool, ch_type);
            if (r->err)
                return;
        }
    }
}

/* exported: reconstruct one CTU from its flat records.  ip may be NULL on
 * intra-only slices.  Returns 0 ok. */
int recon_ctu(const ReconParams *rp, const InterParams *ip, int rx, int ry,
              int rs, const int32_t *cu_recs, int n_cu,
              const int32_t *tu_recs, const int32_t *tb_recs,
              int32_t *coeff_pool)
{
    static _Thread_local Recon r;   /* 128KB of RA slots; don't memset */
    r.rp = rp;
    r.ip = ip;
    r.n_ras[0] = r.n_ras[1] = 0;
    r.err = 0;
    r.na_cand_up_left = 0;
    r.residual_only = 0;
    r.plan_mode = 0;
    recon_neighbour(&r, rx, ry, rs);
    for (int i = 0; i < n_cu; i++) {
        recon_cu(&r, cu_recs + i * CU_STRIDE, tu_recs, tb_recs, coeff_pool);
        if (r.err)
            return r.err;
    }
    return 0;
}

/* batched CTU walk: one call per recon job (cuts the per-CTU Python
 * ctypes dispatch that profiling shows at ~30% of RA decode time) */
int recon_ctus(const ReconParams *rp, const InterParams *ip, int n,
               const int32_t *rxs, const int32_t *rys, const int32_t *rss,
               const int64_t *cu_ps, const int32_t *n_cus,
               const int64_t *tu_ps, const int64_t *tb_ps,
               const int64_t *coeff_ps)
{
    for (int i = 0; i < n; i++) {
        if (!n_cus[i])
            continue;
        int err = recon_ctu(rp, ip, rxs[i], rys[i], rss[i],
                            (const int32_t *)(intptr_t)cu_ps[i], n_cus[i],
                            (const int32_t *)(intptr_t)tu_ps[i],
                            (const int32_t *)(intptr_t)tb_ps[i],
                            (int32_t *)(intptr_t)coeff_ps[i]);
        if (err)
            return err;
    }
    return 0;
}

/* residual-only walk (device intra path): same record walk as recon_ctus
 * but skips prediction and writes every TB's raw residual into the given
 * per-plane residual buffers (same geometry/stride as the pixel planes).
 * The device wavefront kernels then compute clip(pred + res) per predict
 * unit (ops/intra_device.py).  I-slices only. */
int recon_residual_ctus(const ReconParams *rp, int n,
                        const int32_t *rxs, const int32_t *rys,
                        const int32_t *rss, const int64_t *cu_ps,
                        const int32_t *n_cus, const int64_t *tu_ps,
                        const int64_t *tb_ps, const int64_t *coeff_ps,
                        int32_t *res0, int32_t *res1, int32_t *res2)
{
    static _Thread_local Recon r;
    r.rp = rp;
    r.ip = 0;
    r.residual_only = 1;
    r.plan_mode = 0;
    r.res_planes[0] = res0;
    r.res_planes[1] = res1;
    r.res_planes[2] = res2;
    for (int i = 0; i < n; i++) {
        if (!n_cus[i])
            continue;
        const int32_t *cu_recs = (const int32_t *)(intptr_t)cu_ps[i];
        const int32_t *tu_recs = (const int32_t *)(intptr_t)tu_ps[i];
        const int32_t *tb_recs = (const int32_t *)(intptr_t)tb_ps[i];
        int32_t *coeff_pool = (int32_t *)(intptr_t)coeff_ps[i];
        r.n_ras[0] = r.n_ras[1] = 0;
        r.err = 0;
        r.na_cand_up_left = 0;
        recon_neighbour(&r, rxs[i], rys[i], rss[i]);
        for (int c = 0; c < n_cus[i]; c++) {
            recon_cu(&r, cu_recs + c * CU_STRIDE, tu_recs, tb_recs,
                     coeff_pool);
            if (r.err)
                return r.err;
        }
    }
    return 0;
}

/* plan-mode walk (device intra planner, ops/intra_device.py): same record
 * walk as recon_ctus but emits PLAN_STRIDE-int32 descriptors per predict
 * unit into plan_buf (geometry + availability + wave) instead of
 * predicting; wl/wc are caller-zeroed pixel wave maps (luma [H, W],
 * shared-chroma [Hc, Wc]).  Returns the unit count, or -err. */
long plan_intra_ctus(const ReconParams *rp, int n,
                     const int32_t *rxs, const int32_t *rys,
                     const int32_t *rss, const int64_t *cu_ps,
                     const int32_t *n_cus, const int64_t *tu_ps,
                     const int64_t *tb_ps,
                     int32_t *plan_buf, long cap,
                     int32_t *wl, int32_t *wc)
{
    static _Thread_local Recon r;
    r.rp = rp;
    r.ip = 0;
    r.residual_only = 0;
    r.plan_mode = 1;
    r.plan_buf = plan_buf;
    r.plan_cap = cap;
    r.plan_n = 0;
    r.plan_wl = wl;
    r.plan_wc = wc;
    for (int i = 0; i < n; i++) {
        if (!n_cus[i])
            continue;
        const int32_t *cu_recs = (const int32_t *)(intptr_t)cu_ps[i];
        const int32_t *tu_recs = (const int32_t *)(intptr_t)tu_ps[i];
        const int32_t *tb_recs = (const int32_t *)(intptr_t)tb_ps[i];
        r.n_ras[0] = r.n_ras[1] = 0;
        r.err = 0;
        r.na_cand_up_left = 0;
        recon_neighbour(&r, rxs[i], rys[i], rss[i]);
        for (int c = 0; c < n_cus[i]; c++) {
            recon_cu(&r, cu_recs + c * CU_STRIDE, tu_recs, tb_recs, 0);
            if (r.err) {
                r.plan_mode = 0;
                return -r.err;
            }
        }
    }
    r.plan_mode = 0;
    return r.plan_n;
}

int vvcr_sizeof_recon_params(void) { return (int)sizeof(ReconParams); }
int vvcr_sizeof_inter_params(void) { return (int)sizeof(InterParams); }
