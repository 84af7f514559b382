/* Native intra prediction (H.266 8.4.5.2): reference-sample prep +
 * planar / DC / vertical / horizontal / angular predictors with PDPC.
 *
 * Transliterated from ffvvc_tpu/recon.py (_edge_params, _pred_planar,
 * _pred_dc, _pdpc_hv, _angular_core, _pred_angular_v/_pred_angular_h),
 * which remains the golden model; bit-exactness is arbitrated by the
 * oracle-differential suite.  Reference analogue:
 * libavcodec/vvc/vvc_intra_template.c:467-1001.
 *
 * All mode-independent scalar derivation (availability counts, wide-angle
 * map, filter_flag, angle/inv_angle, buffer sizes) stays in Python; this
 * unit only runs the per-pixel loops.
 */
#include <stdint.h>
#include <string.h>

#define PADC 192
#define BUF  512

#define INTRA_PLANAR 0
#define INTRA_DC     1
#define INTRA_HORZ   18
#define INTRA_DIAG   34
#define INTRA_VERT   50

static inline int clip3(int v, int lo, int hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline int imin(int a, int b) { return a < b ? a : b; }

static int ilog2_c(int v)
{
    int r = 0;
    while (v > 1) { v >>= 1; r++; }
    return r;
}

/* ---- reference sample preparation (recon.py _edge_params) -------------- */

static void fill_edges(const int32_t *plane, long stride, int x, int y,
                       int ref_line, int left_avail, int top_avail,
                       int cand_up_left, int unf_left, int unf_top,
                       int left_size, int top_size,
                       int do_smoothing, int bit_depth,
                       int64_t *left, int64_t *top)
{
    int i;
    for (i = 0; i < left_avail; i++)
        left[PADC + i] = plane[(long)(y + i) * stride + x + ref_line];
    for (i = 0; i < top_avail; i++)
        top[PADC + i] = plane[(long)(y + ref_line) * stride + x + i];
    for (i = -1; i > ref_line - 1; i--) {
        if (cand_up_left) {
            left[PADC + i] = plane[(long)(y + i) * stride + x + ref_line];
            top[PADC + i]  = plane[(long)(y + ref_line) * stride + x + i];
        } else if (left_avail) {
            left[PADC + i] = top[PADC + i] = left[PADC + 0];
        } else if (top_avail) {
            left[PADC + i] = top[PADC + i] = top[PADC + 0];
        } else {
            left[PADC + i] = top[PADC + i] = 1 << (bit_depth - 1);
        }
    }
    if (top_avail < unf_top) {
        int64_t fill = top_avail ? top[PADC + top_avail - 1] : top[PADC - 1];
        for (i = top_avail; i < unf_top; i++)
            top[PADC + i] = fill;
    }
    if (left_avail < unf_left) {
        int64_t fill = left_avail ? left[PADC + left_avail - 1] : left[PADC - 1];
        for (i = left_avail; i < unf_left; i++)
            left[PADC + i] = fill;
    }
    if (do_smoothing) {
        int unfilter_last = left_size == unf_left;
        int64_t fl[BUF], ft[BUF];
        memcpy(fl, left, sizeof(fl));
        memcpy(ft, top, sizeof(ft));
        fl[PADC - 1] = ft[PADC - 1] =
            (left[PADC] + 2 * left[PADC - 1] + top[PADC] + 2) >> 2;
        for (i = 0; i < unf_left - unfilter_last; i++)
            fl[PADC + i] = (left[PADC + i - 1] + 2 * left[PADC + i] +
                            left[PADC + i + 1] + 2) >> 2;
        for (i = 0; i < unf_top - unfilter_last; i++)
            ft[PADC + i] = (top[PADC + i - 1] + 2 * top[PADC + i] +
                            top[PADC + i + 1] + 2) >> 2;
        if (unfilter_last) {
            ft[PADC + top_size - 1]  = top[PADC + top_size - 1];
            fl[PADC + left_size - 1] = left[PADC + left_size - 1];
        }
        memcpy(left, fl, sizeof(fl));
        memcpy(top, ft, sizeof(ft));
    }
}

/* angular reference extension (recon.py _edge_params tail) */
static void extend_refs(int mode, int angle, int inv_angle, int ref_idx,
                        int w, int h, int refw, int refh,
                        int64_t *left, int64_t *top)
{
    int i, xx;
    if (mode == INTRA_PLANAR || mode == INTRA_DC ||
        mode == INTRA_VERT || mode == INTRA_HORZ)
        return;
    if (mode >= INTRA_DIAG) {
        if (angle < 0) {
            for (xx = -h; xx < 0; xx++) {
                int idx = -1 - ref_idx +
                    imin((xx * inv_angle + 256) >> 9, h);
                top[PADC + xx - (ref_idx + 1)] = left[PADC + idx];
            }
        } else {
            int rep = w / h > 1 ? w / h : 1;
            for (i = refw; i < refw + rep * ref_idx + 2; i++)
                top[PADC + i] = top[PADC + refw - 1];
        }
    } else {
        if (angle < 0) {
            for (xx = -w; xx < 0; xx++) {
                int idx = -1 - ref_idx +
                    imin((xx * inv_angle + 256) >> 9, w);
                left[PADC + xx - (ref_idx + 1)] = top[PADC + idx];
            }
        } else {
            int rep = h / w > 1 ? h / w : 1;
            for (i = refh; i < refh + rep * ref_idx + 2; i++)
                left[PADC + i] = left[PADC + refh - 1];
        }
    }
}

/* ---- predictors --------------------------------------------------------- */

static void pred_planar(const int64_t *left, const int64_t *top,
                        int w, int h, int64_t *out)
{
    int logw = ilog2_c(w), logh = ilog2_c(h);
    int shift = logw + logh + 1;
    int64_t lh = left[PADC + h], tw = top[PADC + w];
    for (int yy = 0; yy < h; yy++) {
        int64_t l = left[PADC + yy];
        for (int xx = 0; xx < w; xx++) {
            int64_t pv = ((int64_t)(h - 1 - yy) * top[PADC + xx] +
                          (int64_t)(yy + 1) * lh) << logw;
            int64_t ph = ((int64_t)(w - 1 - xx) * l +
                          (int64_t)(xx + 1) * tw) << logh;
            out[yy * w + xx] = (pv + ph + (int64_t)w * h) >> shift;
        }
    }
}

static void pred_dc(const int64_t *left, const int64_t *top,
                    int w, int h, int64_t *out)
{
    int offset = w == h ? (w << 1) : (w > h ? w : h);
    int shift = ilog2_c(offset);
    int64_t s = 0;
    offset >>= 1;
    if (w >= h)
        for (int i = 0; i < w; i++) s += top[PADC + i];
    if (w <= h)
        for (int i = 0; i < h; i++) s += left[PADC + i];
    int64_t dc = (s + offset) >> shift;
    for (int i = 0; i < w * h; i++)
        out[i] = dc;
}

static void pdpc_hv(int64_t *out, const int64_t *left, const int64_t *top,
                    int w, int h, int mode, int pixel_max)
{
    int scale = (ilog2_c(w) + ilog2_c(h) - 2) >> 2;
    for (int yy = 0; yy < h; yy++) {
        int sh_y = (yy << 1) >> scale;
        int64_t wt_col = 32 >> (sh_y < 31 ? sh_y : 31);
        for (int xx = 0; xx < w; xx++) {
            int sh_x = (xx << 1) >> scale;
            int64_t wl_row = 32 >> (sh_x < 31 ? sh_x : 31);
            int64_t res = out[yy * w + xx];
            int64_t l, t, wl, wt;
            if (mode == INTRA_PLANAR || mode == INTRA_DC) {
                l = left[PADC + yy];
                t = top[PADC + xx];
                wl = wl_row;
                wt = wt_col;
            } else if (mode == INTRA_VERT) {
                l = left[PADC + yy] - left[PADC - 1] + res;
                t = 0;
                wl = wl_row;
                wt = 0;
            } else { /* INTRA_HORZ */
                l = 0;
                t = top[PADC + xx] - top[PADC - 1] + res;
                wl = 0;
                wt = wt_col;
            }
            int64_t pred = res + ((wl * (l - res) + wt * (t - res) + 32) >> 6);
            out[yy * w + xx] = clip3((int)pred, 0, pixel_max);
        }
    }
}

/* directional interpolation over 1-D reference `ref` (origin PADC);
 * v[j][k] for j in 1..n_cross, k in 0..n_main-1 */
static void angular_core(const int64_t *ref, int n_main, int n_cross,
                         int is_luma, int angle, int ref_idx,
                         const int32_t *filt /* 32x4 */, int filter_flag,
                         int pixel_max, int64_t *out /* n_cross*n_main */)
{
    for (int j = 1; j <= n_cross; j++) {
        long pos = (long)(j + ref_idx) * angle;
        long idx = (pos >> 5) + ref_idx;
        int fact = (int)(pos & 31);
        long base = idx - (1 + ref_idx);
        const int64_t *r = ref + PADC + base;
        int64_t *o = out + (long)(j - 1) * n_main;
        if (is_luma) {
            if (!filter_flag && fact == 0) {
                for (int k = 0; k < n_main; k++)
                    o[k] = r[k + 1];
            } else {
                const int32_t *f = filt + 4 * fact;
                for (int k = 0; k < n_main; k++) {
                    int64_t v = (r[k] * f[0] + r[k + 1] * f[1] +
                                 r[k + 2] * f[2] + r[k + 3] * f[3] + 32) >> 6;
                    o[k] = clip3((int)v, 0, pixel_max);
                }
            }
        } else {
            for (int k = 0; k < n_main; k++)
                o[k] = ((32 - fact) * r[k + 1] + fact * r[k + 2] + 16) >> 5;
        }
    }
}

/* nscale for angular PDPC is derived in Python and passed in. */

static void angular_v(const int64_t *left, const int64_t *top, int w, int h,
                      int is_luma, int mode, int angle, int inv_angle,
                      int ref_idx, int filter_flag, int pdpc, int nscale,
                      const int32_t *filt, int pixel_max, int64_t *out)
{
    angular_core(top, w, h, is_luma, angle, ref_idx, filt, filter_flag,
                 pixel_max, out);
    if (pdpc) {
        int wp = imin(w, 3 << nscale);
        for (int yy = 0; yy < h; yy++) {
            for (int xx = 0; xx < wp; xx++) {
                int s = 256 + inv_angle * (xx + 1);
                int64_t L = left[PADC + yy + (s >> 9)];
                int64_t wl = 32 >> ((xx << 1) >> nscale);
                int64_t val = out[yy * w + xx];
                out[yy * w + xx] =
                    clip3((int)(val + (((L - val) * wl + 32) >> 6)),
                          0, pixel_max);
            }
        }
    }
}

static void angular_h(const int64_t *left, const int64_t *top, int w, int h,
                      int is_luma, int mode, int angle, int inv_angle,
                      int ref_idx, int filter_flag, int pdpc, int nscale,
                      const int32_t *filt, int pixel_max, int64_t *out)
{
    int64_t tmp[64 * 64];
    angular_core(left, h, w, is_luma, angle, ref_idx, filt, filter_flag,
                 pixel_max, tmp);               /* tmp[w][h]: transpose */
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++)
            out[yy * w + xx] = tmp[xx * h + yy];
    if (pdpc) {
        int hp = imin(h, 3 << nscale);
        for (int yy = 0; yy < hp; yy++) {
            int s = 256 + inv_angle * (yy + 1);
            int sh = (yy << 1) >> nscale;
            int64_t wt = 32 >> (sh < 31 ? sh : 31);
            for (int xx = 0; xx < w; xx++) {
                int64_t T = top[PADC + xx + (s >> 9)];
                int64_t val = out[yy * w + xx];
                out[yy * w + xx] =
                    clip3((int)(val + (((T - val) * wt + 32) >> 6)),
                          0, pixel_max);
            }
        }
    }
}

/* ---- entry -------------------------------------------------------------- */

void vvc_intra_pred(int32_t *plane, long stride, int x, int y, int w, int h,
                    int c_idx, int mode, int ref_idx, int pdpc,
                    int do_smoothing, int left_size, int top_size,
                    int unf_left, int unf_top, int refw, int refh,
                    int angle, int inv_angle, int filter_flag, int nscale,
                    int left_avail, int top_avail, int cand_up_left,
                    int bit_depth, const int32_t *fc_filt,
                    const int32_t *fg_filt)
{
    int64_t left[BUF], top[BUF], out[64 * 64];
    int ref_line = ref_idx == 3 ? -4 : -1 - ref_idx;
    int pixel_max = (1 << bit_depth) - 1;
    int is_luma = c_idx == 0;
    const int32_t *filt = filter_flag ? fg_filt : fc_filt;

    memset(left, 0, sizeof(left));
    memset(top, 0, sizeof(top));
    fill_edges(plane, stride, x, y, ref_line, left_avail, top_avail,
               cand_up_left, unf_left, unf_top, left_size, top_size,
               do_smoothing, bit_depth, left, top);
    extend_refs(mode, angle, inv_angle, ref_idx, w, h, refw, refh, left, top);

    if (mode == INTRA_PLANAR) {
        pred_planar(left, top, w, h, out);
        if (pdpc)
            pdpc_hv(out, left, top, w, h, mode, pixel_max);
    } else if (mode == INTRA_DC) {
        pred_dc(left, top, w, h, out);
        if (pdpc)
            pdpc_hv(out, left, top, w, h, mode, pixel_max);
    } else if (mode == INTRA_VERT) {
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++)
                out[yy * w + xx] = top[PADC + xx];
        if (pdpc)
            pdpc_hv(out, left, top, w, h, mode, pixel_max);
    } else if (mode == INTRA_HORZ) {
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++)
                out[yy * w + xx] = left[PADC + yy];
        if (pdpc)
            pdpc_hv(out, left, top, w, h, mode, pixel_max);
    } else if (mode >= INTRA_DIAG) {
        angular_v(left, top, w, h, is_luma, mode, angle, inv_angle, ref_idx,
                  filter_flag, pdpc, nscale, filt, pixel_max, out);
    } else {
        angular_h(left, top, w, h, is_luma, mode, angle, inv_angle, ref_idx,
                  filter_flag, pdpc, nscale, filt, pixel_max, out);
    }

    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++)
            plane[(long)(y + yy) * stride + x + xx] =
                (int32_t)out[yy * w + xx];
}

/* ---- flat dequant fast path (recon.py _dequant, scale_m == 16) ---------- */

void vvc_dequant_flat(int32_t *c, int n, long long scale_x_m,
                      long long bd_offset, int bd_shift, int lo, int hi)
{
    for (int i = 0; i < n; i++) {
        long long v = ((long long)c[i] * scale_x_m + bd_offset) >> bd_shift;
        c[i] = v < lo ? lo : (v > hi ? hi : (int32_t)v);
    }
}

/* exported wrapper so vvc_recon.c can prepare edge buffers (e.g. for MIP) */
void vvc_fill_edges(const int32_t *plane, long stride, int x, int y,
                    int ref_line, int left_avail, int top_avail,
                    int cand_up_left, int unf_left, int unf_top,
                    int left_size, int top_size, int do_smoothing,
                    int bit_depth, int64_t *left, int64_t *top)
{
    fill_edges(plane, stride, x, y, ref_line, left_avail, top_avail,
               cand_up_left, unf_left, unf_top, left_size, top_size,
               do_smoothing, bit_depth, left, top);
}
