/* Native CABAC engine + residual-coding fast path (decode side).
 *
 * A C transliteration of ffvvc_tpu/cabac/engine.py (H.266 9.3.4.3
 * arithmetic decoder) and ffvvc_tpu/residual.py (7.3.11.11 regular /
 * 7.3.11.12 transform-skip residual coding).  The Python module remains
 * the readable golden model; this library must match it bit-exactly
 * (arbitrated by the oracle-differential test suite).
 *
 * Reference analogue: libavcodec/vvc/vvc_cabac.c
 * (engine :842-948, residual :1992-2430) — re-expressed from our own
 * Python model, not copied.
 */
#include <stdint.h>
#include <string.h>

#include "vvc_cabac.h"

#define MAX_TB 64

/* The engine core lives in vvc_cabac.h as static inline (cabac_bin_ and
 * friends) so vvc_parse.c and the residual loops below inline it; these
 * exported wrappers serve the ctypes engine (cabac/native.py). */

void cabac_init(Cabac *c, const uint8_t *data, long nbits, long bit_pos,
                int32_t *s0, int32_t *s1, int32_t *sh0, int32_t *sh1)
{
    c->data = data;
    c->nbits = nbits;
    c->pos = bit_pos;
    c->s0 = s0; c->s1 = s1; c->sh0 = sh0; c->sh1 = sh1;
    c->cache = 0;
    c->cache_n = 0;
    c->range = 510;
    c->offset = cabac_take_bits_(c, 9);
}

int cabac_decode_bin(Cabac *c, int idx) { return cabac_bin_(c, idx); }
int cabac_decode_bypass(Cabac *c) { return cabac_bypass_(c); }
int cabac_decode_bypass_bits(Cabac *c, int n)
{ return cabac_bypass_bits_(c, n); }
int cabac_decode_terminate(Cabac *c) { return cabac_terminate_(c); }
int cabac_truncated_binary(Cabac *c, int c_max)
{ return cabac_truncated_binary_(c, c_max); }
int cabac_limited_egk(Cabac *c, int k, int max_pre_ext_len,
                      int trunc_suffix_len)
{ return cabac_limited_egk_(c, k, max_pre_ext_len, trunc_suffix_len); }

long cabac_pos(Cabac *c) { return c->pos; }
void cabac_set_pos(Cabac *c, long pos) { c->pos = pos; c->cache_n = 0; }

/* ---------------------------------------------------------------- */
/* residual coding                                                  */
/* ---------------------------------------------------------------- */

static const int qstate_tab[4][2] = {{0,2},{2,0},{1,3},{3,1}};
static const int rice_params_tab[32] = {0,0,0,0,0,0,0,1,1,1,1,1,1,1,2,2,
                                        2,2,2,2,2,2,2,2,2,2,2,2,3,3,3,3};

typedef struct {
    int32_t sig[MAX_TB * MAX_TB];
    int32_t p1[MAX_TB * MAX_TB];
    int32_t lvl[MAX_TB * MAX_TB];
    int32_t sb_coded[16 * 16];
    int log2_sb_w, log2_sb_h, num_sb_coeff, last_sub_block;
    int width_in_sbs, height_in_sbs, nb_sbs;
    int last_scan_pos, qstate, rem_bins_pass1;
    int hist_value, update_hist;
    int last_x, last_y;
    const uint8_t *sb_sx, *sb_sy, *sx, *sy;
} RC;

static inline int ilog2i(int v) { return 31 - __builtin_clz(v); }

static inline int local_sum(const int32_t *level, int w, int h, int xc,
                            int yc, int hist)
{
    int s = 3 * hist;
    const int32_t *row = level + yc * w;
    if (xc < w - 1) {
        s += row[xc + 1];
        if (xc < w - 2)
            s += row[xc + 2] - hist;
        if (yc < h - 1)
            s += row[w + xc + 1] - hist;
    }
    if (yc < h - 1) {
        s += row[w + xc];
        if (yc < h - 2)
            s += row[2 * w + xc] - hist;
    }
    return s;
}

static int rice_param(const ResParams *pp, RC *rc, int xc, int yc,
                      int base_level)
{
    int s = local_sum(rc->lvl, pp->w, pp->h, xc, yc, rc->hist_value);
    int shift;
    if (!pp->rrc_rice_ext) {
        shift = 0;
    } else {
        int t = s < 8 ? 8 : (s > 2048 ? 2048 : s);
        shift = (ilog2i(t) - 3) & ~1;
    }
    s = (s >> shift) - base_level * 5;
    if (s < 0) s = 0;
    if (s > 31) s = 31;
    return rice_params_tab[s] + shift;
}

static int sig_ctx(const ResParams *pp, RC *rc, int xc, int yc)
{
    int d = xc + yc;
    int s = local_sum(rc->p1, pp->w, pp->h, xc, yc, 0);
    int inc;
    int q = rc->qstate - 1;
    if (q < 0) q = 0;
    int m = (s + 1) >> 1;
    if (m > 3) m = 3;
    if (pp->c_idx == 0)
        inc = 12 * q + m + (d < 2 ? 8 : (d < 5 ? 4 : 0));
    else
        inc = 36 + 8 * q + m + (d < 2 ? 4 : 0);
    return pp->ctx_sig + inc;
}

static int gtx_ctx(const ResParams *pp, RC *rc, int xc, int yc, int last)
{
    if (last)
        return pp->c_idx == 0 ? 0 : 21;
    int d = xc + yc;
    int lns = local_sum(rc->sig, pp->w, pp->h, xc, yc, rc->hist_value);
    int lsap1 = local_sum(rc->p1, pp->w, pp->h, xc, yc, rc->hist_value);
    int offset = lsap1 - lns;
    if (offset > 4) offset = 4;
    if (pp->c_idx == 0)
        return 1 + offset + (!d ? 15 : (d < 3 ? 10 : (d < 10 ? 5 : 0)));
    return 22 + offset + (!d ? 5 : 0);
}

static int sb_coded_ctx(const ResParams *pp, RC *rc, int xs, int ys)
{
    int right = xs < rc->width_in_sbs - 1 ?
        rc->sb_coded[ys * rc->width_in_sbs + xs + 1] : 0;
    int bottom = ys < rc->height_in_sbs - 1 ?
        rc->sb_coded[(ys + 1) * rc->width_in_sbs + xs] : 0;
    return pp->ctx_sb_coded + (right | bottom) + (pp->c_idx ? 2 : 0);
}

static int abs_coding(Cabac *c, const ResParams *pp, int c_rice)
{
    int prefix = 0;
    while (prefix < 6 && cabac_bypass_(c))
        prefix++;
    int suffix;
    if (prefix < 6)
        suffix = c_rice ? cabac_bypass_bits_(c, c_rice) : 0;
    else
        suffix = cabac_limited_egk_(c, c_rice + 1,
                                   26 - pp->log2_transform_range,
                                   pp->log2_transform_range);
    return suffix + (prefix << c_rice);
}

static void update_hist(const ResParams *pp, RC *rc, ResParams *out,
                        int remainder, int addin)
{
    if (rc->update_hist && remainder > 0) {
        out->stat_coeff = (out->stat_coeff + ilog2i(remainder) + addin) >> 1;
        rc->update_hist = 0;
    }
}

static int last_sig_prefix(Cabac *c, const ResParams *pp, int log2_tb_size,
                           int log2_zo_size, int base)
{
    static const int off_l[6] = {0, 0, 3, 6, 10, 15};
    static const int shf_c[7] = {0, 0, 0, 1, 2, 2, 2};
    if (!log2_tb_size)
        return 0;
    int cmax = (log2_zo_size << 1) - 1;
    int offset, shift;
    if (pp->c_idx == 0) {
        offset = off_l[log2_tb_size - 1];
        shift = (log2_tb_size + 1) >> 2;
    } else {
        offset = 20;
        shift = shf_c[log2_tb_size];
    }
    int i = 0;
    while (i < cmax && cabac_bin_(c, base + (i >> shift) + offset))
        i++;
    return i;
}

static int base_level(const ResParams *pp)
{
    if (!pp->rrc_rice_ext)
        return 4;
    if (!pp->bd_gt12)
        return pp->is_i_slice ? 2 : 3;
    return pp->is_i_slice ? 1 : 2;
}

static void regular_subblock(Cabac *c, ResParams *pp, RC *rc, int i,
                             int32_t *coeffs)
{
    const int w = pp->w;
    int infer_sb_dc_sig = 0;
    int xs = rc->sb_sx[i];
    int ys = rc->sb_sy[i];
    int start_qstate_sb = rc->qstate;
    int gt2[64];

    if (i < rc->last_sub_block && i > 0) {
        int v = cabac_bin_(c, sb_coded_ctx(pp, rc, xs, ys));
        rc->sb_coded[ys * rc->width_in_sbs + xs] = v;
        infer_sb_dc_sig = 1;
    } else {
        rc->sb_coded[ys * rc->width_in_sbs + xs] = 1;
    }
    if (rc->sb_coded[ys * rc->width_in_sbs + xs] && (xs > 3 || ys > 3) &&
        !pp->c_idx)
        pp->mts_zero_out = 0;
    if (!rc->sb_coded[ys * rc->width_in_sbs + xs])
        return;

    int first_sig = rc->num_sb_coeff;
    int last_sig = -1;
    int first_pos_mode0 = (i == rc->last_sub_block) ? rc->last_scan_pos
                                                    : rc->num_sb_coeff - 1;
    int first_pos_mode1 = first_pos_mode0;

    int n = first_pos_mode0;
    while (n >= 0 && rc->rem_bins_pass1 >= 4) {
        int xc = (xs << rc->log2_sb_w) + rc->sx[n];
        int yc = (ys << rc->log2_sb_h) + rc->sy[n];
        int last = (xc == rc->last_x && yc == rc->last_y);
        int sig;
        if ((n > 0 || !infer_sb_dc_sig) && !last) {
            sig = cabac_bin_(c, sig_ctx(pp, rc, xc, yc));
            rc->sig[yc * w + xc] = sig;
            rc->rem_bins_pass1--;
            if (sig)
                infer_sb_dc_sig = 0;
        } else {
            sig = (last || (!rc->sx[n] && !rc->sy[n] && infer_sb_dc_sig));
            rc->sig[yc * w + xc] = sig;
        }
        int pass1 = 0;
        if (sig) {
            int inc = gtx_ctx(pp, rc, xc, yc, last);
            int gt1 = cabac_bin_(c, pp->ctx_gtx + inc);
            rc->rem_bins_pass1--;
            int par = 0;
            if (gt1) {
                par = cabac_bin_(c, pp->ctx_par + inc);
                gt2[n] = cabac_bin_(c, pp->ctx_gtx + inc + 32);
                rc->rem_bins_pass1 -= 2;
            } else {
                gt2[n] = 0;
            }
            if (last_sig == -1)
                last_sig = n;
            first_sig = n;
            pass1 = 1 + par + gt1 + (gt2[n] << 1);
        } else {
            gt2[n] = 0;
        }
        rc->p1[yc * w + xc] = pass1;
        if (pp->dep_quant)
            rc->qstate = qstate_tab[rc->qstate][pass1 & 1];
        first_pos_mode1 = n - 1;
        n--;
    }

    for (n = first_pos_mode0; n > first_pos_mode1; n--) {
        int xc = (xs << rc->log2_sb_w) + rc->sx[n];
        int yc = (ys << rc->log2_sb_h) + rc->sy[n];
        int pass1 = rc->p1[yc * w + xc];
        rc->lvl[yc * w + xc] = pass1;
        if (gt2[n]) {
            int c_rice = rice_param(pp, rc, xc, yc, base_level(pp));
            int rem = abs_coding(c, pp, c_rice);
            rc->lvl[yc * w + xc] = pass1 + 2 * rem;
            update_hist(pp, rc, pp, rem, 2);
        }
    }

    for (n = first_pos_mode1; n >= 0; n--) {
        int xc = (xs << rc->log2_sb_w) + rc->sx[n];
        int yc = (ys << rc->log2_sb_h) + rc->sy[n];
        int c_rice = rice_param(pp, rc, xc, yc, 0);
        int zero_pos = (rc->qstate < 2 ? 1 : 2) << c_rice;
        int dec_abs = abs_coding(c, pp, c_rice);
        int lvl;
        if (dec_abs == zero_pos)
            lvl = 0;
        else
            lvl = dec_abs + (dec_abs < zero_pos ? 1 : 0);
        rc->lvl[yc * w + xc] = lvl;
        update_hist(pp, rc, pp, dec_abs, 0);
        if (lvl > 0) {
            if (last_sig == -1)
                last_sig = n;
            first_sig = n;
        }
        if (pp->dep_quant)
            rc->qstate = qstate_tab[rc->qstate][lvl & 1];
    }

    int sig_hidden = pp->sdh && (last_sig - first_sig > 3);

    if (pp->dep_quant)
        rc->qstate = start_qstate_sb;
    n = (i == rc->last_sub_block) ? rc->last_scan_pos : rc->num_sb_coeff - 1;
    int ssum = 0;
    for (; n >= 0; n--) {
        int xc = (xs << rc->log2_sb_w) + rc->sx[n];
        int yc = (ys << rc->log2_sb_h) + rc->sy[n];
        int lvl = rc->lvl[yc * w + xc];
        if (lvl > 0) {
            int sign = 1;
            if (!sig_hidden || n != first_sig)
                sign = 1 - 2 * cabac_bypass_(c);
            int trans;
            if (pp->dep_quant) {
                trans = (2 * lvl - (rc->qstate > 1 ? 1 : 0)) * sign;
            } else {
                trans = lvl * sign;
                if (sig_hidden) {
                    ssum += lvl;
                    if (n == first_sig && (ssum & 1))
                        trans = -trans;
                }
            }
            coeffs[yc * w + xc] = trans;
            if (xc > pp->max_scan_x) pp->max_scan_x = xc;
            if (yc > pp->max_scan_y) pp->max_scan_y = yc;
        }
        if (pp->dep_quant)
            rc->qstate = qstate_tab[rc->qstate][lvl & 1];
    }
}

/* returns 0 on success */
int decode_residual_regular(Cabac *c, ResParams *pp, int32_t *coeffs,
                            const uint8_t *sb_sx, const uint8_t *sb_sy,
                            const uint8_t *sx, const uint8_t *sy)
{
    RC rc;
    memset(rc.sig, 0, sizeof(int32_t) * pp->w * pp->h);
    memset(rc.p1, 0, sizeof(int32_t) * pp->w * pp->h);
    memset(rc.lvl, 0, sizeof(int32_t) * pp->w * pp->h);
    memset(coeffs, 0, sizeof(int32_t) * pp->w * pp->h);

    int log2_zo_w = pp->log2_zo_w, log2_zo_h = pp->log2_zo_h;
    int log2_sb_w = (log2_zo_w < 2 || log2_zo_h < 2) ? 1 : 2;
    int log2_sb_h = log2_sb_w;
    if (log2_zo_w + log2_zo_h > 3) {
        if (log2_zo_w < 2) {
            log2_sb_w = log2_zo_w;
            log2_sb_h = 4 - log2_sb_w;
        } else if (log2_zo_h < 2) {
            log2_sb_h = log2_zo_h;
            log2_sb_w = 4 - log2_sb_h;
        }
    }
    rc.log2_sb_w = log2_sb_w;
    rc.log2_sb_h = log2_sb_h;
    rc.num_sb_coeff = 1 << (log2_sb_w + log2_sb_h);
    rc.last_sub_block =
        (1 << (log2_zo_w + log2_zo_h - (log2_sb_w + log2_sb_h))) - 1;
    rc.hist_value = pp->persistent_rice ? (1 << pp->stat_coeff) : 0;
    rc.update_hist = pp->persistent_rice ? 1 : 0;
    rc.rem_bins_pass1 = ((1 << (log2_zo_w + log2_zo_h)) * 7) >> 2;
    rc.width_in_sbs = 1 << (log2_zo_w - log2_sb_w);
    rc.height_in_sbs = 1 << (log2_zo_h - log2_sb_h);
    rc.nb_sbs = rc.width_in_sbs * rc.height_in_sbs;
    memset(rc.sb_coded, 0, sizeof(int32_t) * rc.nb_sbs);
    rc.last_scan_pos = rc.num_sb_coeff;
    rc.qstate = 0;
    rc.sb_sx = sb_sx; rc.sb_sy = sb_sy; rc.sx = sx; rc.sy = sy;

    /* last significant coeff */
    int px = last_sig_prefix(c, pp, pp->log2_w, log2_zo_w, pp->ctx_last_x);
    int py = last_sig_prefix(c, pp, pp->log2_h, log2_zo_h, pp->ctx_last_y);
    int last_x = px, last_y = py;
    if (px > 3) {
        int nbits = (px >> 1) - 1;
        int suf = cabac_bypass_bits_(c, nbits);
        last_x = (1 << ((px >> 1) - 1)) * (2 + (px & 1)) + suf;
    }
    if (py > 3) {
        int nbits = (py >> 1) - 1;
        int suf = cabac_bypass_bits_(c, nbits);
        last_y = (1 << ((py >> 1) - 1)) * (2 + (py & 1)) + suf;
    }
    if (pp->reverse_last) {
        last_x = (1 << log2_zo_w) - 1 - last_x;
        last_y = (1 << log2_zo_h) - 1 - last_y;
    }
    rc.last_x = last_x;
    rc.last_y = last_y;

    for (;;) {
        if (!rc.last_scan_pos) {
            rc.last_scan_pos = rc.num_sb_coeff;
            rc.last_sub_block--;
        }
        rc.last_scan_pos--;
        int xs = rc.sb_sx[rc.last_sub_block];
        int ys = rc.sb_sy[rc.last_sub_block];
        int xc = (xs << rc.log2_sb_w) + rc.sx[rc.last_scan_pos];
        int yc = (ys << rc.log2_sb_h) + rc.sy[rc.last_scan_pos];
        if (xc == last_x && yc == last_y)
            break;
    }

    if (rc.last_sub_block == 0 && pp->log2_w >= 2 && pp->log2_h >= 2 &&
        !pp->ts && rc.last_scan_pos > 0)
        pp->lfnst_dc_only = 0;
    if ((rc.last_sub_block > 0 && pp->log2_w >= 2 && pp->log2_h >= 2) ||
        (rc.last_scan_pos > 7 && (pp->log2_w == 2 || pp->log2_w == 3) &&
         pp->log2_w == pp->log2_h))
        pp->lfnst_zero_out = 0;
    if ((rc.last_sub_block > 0 || rc.last_scan_pos > 0) && !pp->c_idx)
        pp->mts_dc_only = 0;

    for (int i = rc.last_sub_block; i >= 0; i--)
        regular_subblock(c, pp, &rc, i, coeffs);
    return 0;
}

/* ---------------------------------------------------------------- */
/* transform-skip residual coding (residual.py _code_residual_ts)   */
/* ---------------------------------------------------------------- */

typedef struct {
    int32_t sig[MAX_TB * MAX_TB];       /* sig_coeff_flag */
    int32_t p1[MAX_TB * MAX_TB];        /* abs_level_pass1 */
    int32_t lvl[MAX_TB * MAX_TB];       /* abs_level */
    int32_t sgn[MAX_TB * MAX_TB];       /* coeff_sign_level */
    int32_t sb_coded[16 * 16];
    int log2_sb_w, log2_sb_h, num_sb_coeff, last_sub_block;
    int width_in_sbs, height_in_sbs;
    int rem_bins_pass1, infer_sb_cbf;
    const uint8_t *sb_sx, *sb_sy, *sx, *sy;
} TsRC;

static void ts_subblock(Cabac *c, ResParams *pp, TsRC *rc, int i,
                        int32_t *coeffs)
{
    const int w = pp->w;
    int xs = rc->sb_sx[i];
    int ys = rc->sb_sy[i];
    int infer_sb_sig = 1;
    int last_pass1 = -1, last_pass2 = -1;
    int gtx[64], pass2[64];
    int bdpcm = pp->bdpcm;

    if (i != rc->last_sub_block || !rc->infer_sb_cbf) {
        /* _sb_coded_ctx transform-skip branch */
        int left = xs > 0 ? rc->sb_coded[ys * rc->width_in_sbs + xs - 1] : 0;
        int above = ys > 0 ? rc->sb_coded[(ys - 1) * rc->width_in_sbs + xs]
                           : 0;
        rc->sb_coded[ys * rc->width_in_sbs + xs] =
            cabac_bin_(c, pp->ctx_sb_coded + left + above + 4);
    } else {
        rc->sb_coded[ys * rc->width_in_sbs + xs] = 1;
    }
    int sb_coded = rc->sb_coded[ys * rc->width_in_sbs + xs];
    if (sb_coded && i < rc->last_sub_block)
        rc->infer_sb_cbf = 0;

    /* pass 1: sig + sign + gt1 + parity */
    int n = 0;
    while (n < rc->num_sb_coeff && rc->rem_bins_pass1 >= 4) {
        int xc = (xs << rc->log2_sb_w) + rc->sx[n];
        int yc = (ys << rc->log2_sb_h) + rc->sy[n];
        int par = 0;
        gtx[n] = 0;
        last_pass1 = n;
        int sig;
        if (sb_coded && (n != rc->num_sb_coeff - 1 || !infer_sb_sig)) {
            /* _sig_ctx transform-skip branch */
            int nb = (xc > 0 ? rc->sig[yc * w + xc - 1] : 0) +
                     (yc > 0 ? rc->sig[(yc - 1) * w + xc] : 0);
            sig = cabac_bin_(c, pp->ctx_sig + 60 + nb);
            rc->sig[yc * w + xc] = sig;
            rc->rem_bins_pass1--;
            if (sig)
                infer_sb_sig = 0;
        } else {
            sig = (n == rc->num_sb_coeff - 1) && infer_sb_sig && sb_coded;
            rc->sig[yc * w + xc] = sig;
        }
        int csl = 0;
        if (rc->sig[yc * w + xc]) {
            int left_s = xc ? rc->sgn[yc * w + xc - 1] : 0;
            int above_s = yc ? rc->sgn[(yc - 1) * w + xc] : 0;
            int inc;
            if (left_s == -above_s)
                inc = bdpcm ? 3 : 0;
            else if (left_s >= 0 && above_s >= 0)
                inc = bdpcm ? 4 : 1;
            else
                inc = bdpcm ? 5 : 2;
            int s = cabac_bin_(c, pp->ctx_ts_sign + inc);
            csl = 1 - 2 * s;
            int inc1;
            if (bdpcm) {
                inc1 = 67;
            } else {
                int l = xc > 0 ? rc->sig[yc * w + xc - 1] : 0;
                int a = yc > 0 ? rc->sig[(yc - 1) * w + xc] : 0;
                inc1 = 64 + a + l;
            }
            gtx[n] = cabac_bin_(c, pp->ctx_gtx + inc1);
            rc->rem_bins_pass1 -= 2;
            if (gtx[n]) {
                par = cabac_bin_(c, pp->ctx_par + 32);
                rc->rem_bins_pass1--;
            }
        }
        rc->sgn[yc * w + xc] = csl;
        rc->p1[yc * w + xc] = rc->sig[yc * w + xc] + par + gtx[n];
        n++;
    }

    /* pass 2: gt3..gt9 */
    int n2 = 0;
    while (n2 < rc->num_sb_coeff && rc->rem_bins_pass1 >= 4 && n2 < n) {
        int xc = (xs << rc->log2_sb_w) + rc->sx[n2];
        int yc = (ys << rc->log2_sb_h) + rc->sy[n2];
        pass2[n2] = rc->p1[yc * w + xc];
        int j = 1, g = gtx[n2];
        while (j < 5 && g) {
            g = cabac_bin_(c, pp->ctx_gtx + 67 + j);
            pass2[n2] += g << 1;
            rc->rem_bins_pass1--;
            j++;
        }
        gtx[n2] = 0;
        last_pass2 = n2;
        n2++;
    }

    /* remainder pass */
    for (int m = 0; m < rc->num_sb_coeff; m++) {
        int xc = (xs << rc->log2_sb_w) + rc->sx[m];
        int yc = (ys << rc->log2_sb_h) + rc->sy[m];
        int pass1v = rc->p1[yc * w + xc];
        int abs_rem = 0;
        int c_rice = pp->ts_rice;
        int need_rem = (m <= last_pass2 && pass2[m] >= 10) ||
                       (m > last_pass2 && m <= last_pass1 && pass1v >= 2) ||
                       (m > last_pass1 && sb_coded);
        if (need_rem)
            abs_rem = abs_coding(c, pp, c_rice);
        int lvl;
        if (m <= last_pass2) {
            lvl = pass2[m] + 2 * abs_rem;
        } else if (m <= last_pass1) {
            lvl = pass1v + 2 * abs_rem;
        } else {
            lvl = abs_rem;
            if (abs_rem)
                rc->sgn[yc * w + xc] = 1 - 2 * cabac_bypass_(c);
        }
        rc->lvl[yc * w + xc] = lvl;
        if (!pp->bdpcm && m <= last_pass1) {
            int left = xc > 0 ? rc->lvl[yc * w + xc - 1] : 0;
            int above = yc > 0 ? rc->lvl[(yc - 1) * w + xc] : 0;
            int pred = left > above ? left : above;
            if (lvl == 1 && pred > 0)
                lvl = pred;
            else if (lvl > 0 && lvl <= pred)
                lvl -= 1;
            rc->lvl[yc * w + xc] = lvl;
        }
        if (lvl) {
            coeffs[yc * w + xc] = rc->sgn[yc * w + xc] * lvl;
            if (xc > pp->max_scan_x) pp->max_scan_x = xc;
            if (yc > pp->max_scan_y) pp->max_scan_y = yc;
        } else {
            coeffs[yc * w + xc] = 0;
        }
    }
}

int decode_residual_ts(Cabac *c, ResParams *pp, int32_t *coeffs,
                       const uint8_t *sb_sx, const uint8_t *sb_sy,
                       const uint8_t *sx, const uint8_t *sy)
{
    static _Thread_local TsRC rc;
    memset(rc.sig, 0, sizeof(int32_t) * pp->w * pp->h);
    memset(rc.p1, 0, sizeof(int32_t) * pp->w * pp->h);
    memset(rc.lvl, 0, sizeof(int32_t) * pp->w * pp->h);
    memset(rc.sgn, 0, sizeof(int32_t) * pp->w * pp->h);
    memset(coeffs, 0, sizeof(int32_t) * pp->w * pp->h);
    int log2_zo_w = pp->log2_w, log2_zo_h = pp->log2_h;
    int log2_sb_w = (log2_zo_w < 2 || log2_zo_h < 2) ? 1 : 2;
    int log2_sb_h = log2_sb_w;
    if (log2_zo_w + log2_zo_h > 3) {
        if (log2_zo_w < 2) {
            log2_sb_w = log2_zo_w;
            log2_sb_h = 4 - log2_sb_w;
        } else if (log2_zo_h < 2) {
            log2_sb_h = log2_zo_h;
            log2_sb_w = 4 - log2_sb_h;
        }
    }
    rc.log2_sb_w = log2_sb_w;
    rc.log2_sb_h = log2_sb_h;
    rc.num_sb_coeff = 1 << (log2_sb_w + log2_sb_h);
    rc.last_sub_block =
        (1 << (log2_zo_w + log2_zo_h - (log2_sb_w + log2_sb_h))) - 1;
    rc.width_in_sbs = 1 << (log2_zo_w - log2_sb_w);
    rc.height_in_sbs = 1 << (log2_zo_h - log2_sb_h);
    memset(rc.sb_coded, 0,
           sizeof(int32_t) * rc.width_in_sbs * rc.height_in_sbs);
    rc.rem_bins_pass1 = ((1 << (log2_zo_w + log2_zo_h)) * 7) >> 2;
    rc.infer_sb_cbf = 1;
    rc.sb_sx = sb_sx; rc.sb_sy = sb_sy; rc.sx = sx; rc.sy = sy;
    for (int i = 0; i <= rc.last_sub_block; i++)
        ts_subblock(c, pp, &rc, i, coeffs);
    return 0;
}
