/* Native CTU parse core (decode side): coding tree + intra CU syntax +
 * transform tree/units + residual dispatch, emitting flat CU/TU/TB records
 * and filling the dense per-frame tab planes.
 *
 * A C transliteration of ffvvc_tpu/ctu.py's decode paths (coding_tree
 * :581, coding_unit :673, transform_unit :1839, QP derivation :1671-1802,
 * intra modes :764-1087).  The Python module remains the readable golden
 * model and the encode (forge) path; this library must match it bit-exactly
 * (arbitrated by the oracle-differential test suite).
 *
 * Reference analogue: libavcodec/vvc/vvc_ctu.c
 * (hls_coding_tree :2030, hls_coding_unit :1732, can_split :521,
 * hls_transform_unit :314, QP :77-212) — re-expressed from our own Python
 * model, not copied.
 *
 * Stage 1 scope: intra CUs only (I-slices); transform-skip/BDPCM/IBC/ACT/
 * palette gated off by the Python binding (falls back to Python parse).
 */
#include <stdint.h>
#include <string.h>

#include "vvc_parse.h"

/* ---- diagonal scan tables (ops/data.py diag_scan) ------------------- */

/* scans for all (log2w, log2h) pairs up to 32x32, built on first use */
static uint8_t scan_x_tab[6][6][1024];
static uint8_t scan_y_tab[6][6][1024];
static int scan_built[6][6];

static void build_scan(int lw, int lh)
{
    int w = 1 << lw, h = 1 << lh, n = 0;
    for (int s = 0; s < w + h - 1; s++) {
        int y0 = s < h - 1 ? s : h - 1;
        for (int y = y0; y >= 0; y--) {
            int x = s - y;
            if (x < w) {
                scan_x_tab[lw][lh][n] = (uint8_t)x;
                scan_y_tab[lw][lh][n] = (uint8_t)y;
                n++;
            }
        }
    }
    scan_built[lw][lh] = 1;
}

static inline void get_scan(int lw, int lh, const uint8_t **sx,
                            const uint8_t **sy)
{
    if (!scan_built[lw][lh])
        build_scan(lw, lh);
    *sx = scan_x_tab[lw][lh];
    *sy = scan_y_tab[lw][lh];
}

/* ---- small helpers --------------------------------------------------- */

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int ilog2u(int v) { return 31 - __builtin_clz((unsigned)v); }

/* set_grid (ctu.py:214): fill a 4x4-grid plane over a pixel rect */
static void set_grid(const SliceParams *sp, int32_t *tab, int x0, int y0,
                     int w, int h, int v)
{
    int xs = x0 >> 2, xe = (x0 + w) >> 2;
    int ys = y0 >> 2, ye = (y0 + h) >> 2;
    for (int y = ys; y < ye; y++)
        for (int x = xs; x < xe; x++)
            tab[y * sp->w4 + x] = v;
}

static void set_grid_u8(const SliceParams *sp, uint8_t *tab, int x0, int y0,
                        int w, int h, uint8_t v)
{
    int xs = x0 >> 2, xe = (x0 + w) >> 2;
    int ys = y0 >> 2, ye = (y0 + h) >> 2;
    for (int y = ys; y < ye; y++)
        for (int x = xs; x < xe; x++)
            tab[y * sp->w4 + x] = v;
}

/* _left_top_pair (ctu.py:483) */
static void left_top_pair(Parser *p, const int32_t *left_tab,
                          const int32_t *top_tab, int x0, int y0,
                          int ldef, int tdef, int *left, int *top)
{
    const SliceParams *sp = p->sp;
    int mask = (1 << sp->ctb_log2) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    int xc = x0 >> 2, yc = y0 >> 2;
    *left = ldef;
    *top = tdef;
    if (p->ctb_left_flag || x0b)
        *left = left_tab[yc * sp->w4 + xc - 1];
    if (p->ctb_up_flag || y0b)
        *top = top_tab[(yc - 1) * sp->w4 + xc];
}

/* decode_neighbour (ctu.py:348) */
static void decode_neighbour(Parser *p, int x_ctb, int y_ctb, int rx, int ry,
                             int rs)
{
    const SliceParams *sp = p->sp;
    int ctb_size = 1 << sp->ctb_log2;
    p->end_of_tiles_x = sp->width;
    p->end_of_tiles_y = sp->height;
    if (sp->ctb_to_col_bd[rx] != sp->ctb_to_col_bd[rx + 1])
        p->end_of_tiles_x = imin(x_ctb + ctb_size, p->end_of_tiles_x);
    if (sp->ctb_to_row_bd[ry] != sp->ctb_to_row_bd[ry + 1])
        p->end_of_tiles_y = imin(y_ctb + ctb_size, p->end_of_tiles_y);
    int bl_tile = rx > 0 && sp->ctb_to_col_bd[rx] != sp->ctb_to_col_bd[rx - 1];
    int bl_slice = rx > 0 && sp->slice_idx[rs] != sp->slice_idx[rs - 1];
    int bu_tile = ry > 0 && sp->ctb_to_row_bd[ry] != sp->ctb_to_row_bd[ry - 1];
    int bu_slice = ry > 0 &&
        sp->slice_idx[rs] != sp->slice_idx[rs - sp->ctb_width];
    (void)bl_slice;
    p->ctb_left_flag = rx > 0 && !bl_tile;
    p->ctb_up_flag = ry > 0 && !bu_tile && !bu_slice;
    p->ctb_up_right_flag = p->ctb_up_flag &&
        (sp->ctb_to_col_bd[rx] == sp->ctb_to_col_bd[rx + 1]) &&
        (sp->ctb_to_row_bd[ry] == sp->ctb_to_row_bd[ry - 1]);
    p->ctb_up_left_flag = p->ctb_left_flag && p->ctb_up_flag;
}

/* set_neighbour_available (ctu.py:369) */
static void set_neighbour_available(Parser *p, int x0, int y0, int w, int h)
{
    int log2_ctb = p->sp->ctb_log2;
    int mask = (1 << log2_ctb) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    p->na_cand_up = p->ctb_up_flag || y0b;
    p->na_cand_left = p->ctb_left_flag || x0b;
    p->na_cand_up_left = (x0b || y0b) ? (p->na_cand_left && p->na_cand_up)
                                      : p->ctb_up_left_flag;
    p->na_cand_up_right_sap = (x0b + w == (1 << log2_ctb))
        ? (p->ctb_up_right_flag && !y0b) : p->na_cand_up;
    p->na_cand_up_right = p->na_cand_up_right_sap &&
        (x0 + w) < p->end_of_tiles_x;
}

/* forward decls */
static int coding_tree(Parser *p, int x0, int y0, int w, int h, int qg_on_y,
                       int qg_on_c, int cb_sub_div, int cqt_depth,
                       int mtt_depth, int depth_offset, int part_idx,
                       int last_split, int tree_type_curr,
                       int mode_type_curr);

/* ---- split decisions (ctu.py:397-579) -------------------------------- */

static AllowedSplit can_split(Parser *p, int x0, int y0, int w, int h,
                              int mtt_depth, int depth_offset, int part_idx,
                              int last_split, int tree_type, int mode_type)
{
    const SliceParams *sp = p->sp;
    int chroma = tree_type == DUAL_TREE_CHROMA;
    AllowedSplit a = {1, 1, 1, 1, 1};
    int min_cb = 1 << sp->min_cb_log2;
    if (mtt_depth)
        a.qt = 0;
    if (w <= sp->min_qt_size[chroma])
        a.qt = 0;
    if (chroma) {
        int ca = (w >> sp->hshift1) * (h >> sp->vshift1);
        int cw = w >> sp->hshift1;
        if (cw == 8) {
            a.ttv = 0;
        } else if (cw <= 4) {
            if (cw == 4)
                a.btv = 0;
            a.qt = 0;
        }
        if (mode_type == MODE_TYPE_INTRA)
            a.qt = a.btv = a.bth = a.ttv = a.tth = 0;
        if (ca <= 32) {
            a.ttv = a.tth = 0;
            if (ca <= 16)
                a.btv = a.bth = 0;
        }
    }
    int max_bt = sp->max_bt_size[chroma];
    int max_tt = imin(64, sp->max_tt_size[chroma]);
    int max_mtt = sp->max_mtt_depth[chroma] + depth_offset;
    if (mode_type == MODE_TYPE_INTER) {
        int area = w * h;
        if (area == 32)
            a.btv = a.bth = 0;
        else if (area == 64)
            a.ttv = a.tth = 0;
    }
    if (w <= 2 * min_cb) {
        a.ttv = 0;
        if (w <= min_cb)
            a.btv = 0;
    }
    if (h <= 2 * min_cb) {
        a.tth = 0;
        if (h <= min_cb)
            a.bth = 0;
    }
    if (w > max_bt || h > max_bt)
        a.btv = a.bth = 0;
    if (w > max_tt || h > max_tt)
        a.ttv = a.tth = 0;
    if (mtt_depth >= max_mtt)
        a.btv = a.bth = a.ttv = a.tth = 0;
    if (x0 + w > sp->width) {
        a.ttv = a.tth = 0;
        if (h > 64)
            a.btv = 0;
        if (y0 + h <= sp->height)
            a.bth = 0;
        else if (w > sp->min_qt_size[chroma])
            a.btv = a.bth = 0;
    }
    if (y0 + h > sp->height) {
        a.btv = a.ttv = a.tth = 0;
        if (w > 64)
            a.bth = 0;
    }
    if (mtt_depth > 0 && part_idx == 1) {
        if (last_split == SPLIT_TT_VER)
            a.btv = 0;
        else if (last_split == SPLIT_TT_HOR)
            a.bth = 0;
    }
    if (w <= 64 && h > 64)
        a.btv = 0;
    if (w > 64 && h <= 64)
        a.bth = 0;
    return a;
}

static int split_cu_flag(Parser *p, int x0, int y0, int w, int h, int chroma,
                         const AllowedSplit *a)
{
    const SliceParams *sp = p->sp;
    int is_inside = (x0 + w <= sp->width) && (y0 + h <= sp->height);
    if ((a->btv || a->bth || a->ttv || a->tth || a->qt) && is_inside) {
        const int32_t *hts = chroma ? sp->cb_height1 : sp->cb_height0;
        const int32_t *wts = chroma ? sp->cb_width1 : sp->cb_width0;
        int left, top;
        left_top_pair(p, hts, wts, x0, y0, h, w, &left, &top);
        int inc = (left < h) + (top < w);
        inc += (a->btv + a->bth + a->ttv + a->tth + 2 * a->qt - 1) / 2 * 3;
        return cabac_bin_(p->c, sp->ctx_split_cu + inc);
    }
    return !is_inside;
}

static int split_mode(Parser *p, int x0, int y0, int w, int h, int cqt_depth,
                      int mtt_depth, int ch_type, const AllowedSplit *a)
{
    const SliceParams *sp = p->sp;
    const int32_t *cqt = ch_type ? sp->cqt_depth1 : sp->cqt_depth0;
    int allow_no_qt = a->btv || a->bth || a->ttv || a->tth;
    int split_qt;
    if (allow_no_qt && a->qt) {
        int dl, dt;
        left_top_pair(p, cqt, cqt, x0, y0, 0, 0, &dl, &dt);
        int inc = (dl > cqt_depth) + (dt > cqt_depth) + (cqt_depth >= 2) * 3;
        split_qt = cabac_bin_(p->c, sp->ctx_split_qt + inc);
    } else {
        split_qt = !allow_no_qt || a->qt;
    }
    if (split_qt)
        return SPLIT_QT;
    int vertical;
    if ((a->bth || a->tth) && (a->btv || a->ttv)) {
        int v = a->btv + a->ttv;
        int hh = a->bth + a->tth;
        int inc;
        if (v > hh) {
            inc = 4;
        } else if (v < hh) {
            inc = 3;
        } else {
            int mask = (1 << sp->ctb_log2) - 1;
            int x0b = x0 & mask, y0b = y0 & mask;
            int avail_a = p->ctb_up_flag || y0b;
            int avail_l = p->ctb_left_flag || x0b;
            int xc = x0 >> 2, yc = y0 >> 2;
            const int32_t *cbw = ch_type ? sp->cb_width1 : sp->cb_width0;
            const int32_t *cbh = ch_type ? sp->cb_height1 : sp->cb_height0;
            int da = w / (avail_a ? cbw[(yc - 1) * sp->w4 + xc] : 1);
            int dl = h / (avail_l ? cbh[yc * sp->w4 + xc - 1] : 1);
            if (da == dl || !avail_a || !avail_l)
                inc = 0;
            else if (da < dl)
                inc = 1;
            else
                inc = 2;
        }
        vertical = cabac_bin_(p->c, sp->ctx_mtt_vertical + inc);
    } else {
        vertical = !(a->bth || a->tth);
    }
    int binary;
    if ((a->btv && a->ttv && vertical) || (a->bth && a->tth && !vertical)) {
        int inc = 2 * vertical + (mtt_depth <= 1 ? 1 : 0);
        binary = cabac_bin_(p->c, sp->ctx_mtt_binary + inc);
    } else {
        if (!a->btv && !a->bth)
            binary = 0;
        else if (!a->ttv && !a->tth)
            binary = 1;
        else if (a->bth && a->ttv)
            binary = 1 - vertical;
        else
            binary = vertical;
    }
    static const int tab[4] = {SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER,
                               SPLIT_BT_VER};
    return tab[(vertical << 1) + binary];
}

static int mode_type_decode(Parser *p, int x0, int y0, int w, int h,
                            int split, int ch_type, int mode_type_curr)
{
    const SliceParams *sp = p->sp;
    int area = w * h;
    int cond = 0;
    if (!((sp->slice_type == SLICE_I && sp->sps_dual_tree) ||
          mode_type_curr != MODE_TYPE_ALL || !sp->chroma_format_idc ||
          sp->chroma_format_idc == 3)) {
        if ((area == 64 && (split == SPLIT_QT || split == SPLIT_TT_HOR ||
                            split == SPLIT_TT_VER)) ||
            (area == 32 && (split == SPLIT_BT_HOR || split == SPLIT_BT_VER))) {
            cond = 1;
        } else if ((area == 64 && (split == SPLIT_BT_HOR ||
                                   split == SPLIT_BT_VER) &&
                    sp->chroma_format_idc == 1) ||
                   (area == 128 && (split == SPLIT_TT_HOR ||
                                    split == SPLIT_TT_VER) &&
                    sp->chroma_format_idc == 1) ||
                   (w == 8 && split == SPLIT_BT_VER) ||
                   (w == 16 && split == SPLIT_TT_VER)) {
            cond = 1 + (sp->slice_type != SLICE_I);
        }
    }
    if (cond == 1)
        return MODE_TYPE_INTRA;
    if (cond == 2) {
        const int32_t *cpm = ch_type ? sp->cpm1 : sp->cpm0;
        int left, top;
        left_top_pair(p, cpm, cpm, x0, y0, 0, 0, &left, &top);
        int inc = (left != 0) || (top != 0);
        int v = cabac_bin_(p->c, sp->ctx_non_inter + inc);
        return v ? MODE_TYPE_INTRA : MODE_TYPE_INTER;
    }
    return mode_type_curr;
}

/* ---- QP derivation (ctu.py:1671-1802) --------------------------------- */

static int get_qp_y_pred(Parser *p, int cu_x0, int cu_y0)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    int ctb_log2 = sp->ctb_log2;
    int mask = (1 << ctb_log2) - 1;
    int x_qg = st->cu_qg_top_left_x, y_qg = st->cu_qg_top_left_y;
    int xc = cu_x0 >> 2, yc = cu_y0 >> 2;
    int x_ctb = cu_x0 >> ctb_log2, y_ctb = cu_y0 >> ctb_log2;
    int in_same_ctb_a = ((x_qg - 1) >> ctb_log2) == x_ctb &&
                        (y_qg >> ctb_log2) == y_ctb;
    int in_same_ctb_b = (x_qg >> ctb_log2) == x_ctb &&
                        ((y_qg - 1) >> ctb_log2) == y_ctb;
    if (p->na_cand_up) {
        int first_qg_in_ctu = !(x_qg & mask) && !(y_qg & mask);
        int qp_up = sp->qp0[(yc - 1) * sp->w4 + xc];
        if (first_qg_in_ctu &&
            sp->ctb_to_col_bd[x_qg >> ctb_log2] == (x_qg >> ctb_log2))
            return qp_up;
    }
    int qp_pred = st->is_first_qg ? sp->slice_qp_y : st->qp_y;
    int qp_b = (!p->na_cand_up || !in_same_ctb_b)
        ? qp_pred : sp->qp0[(yc - 1) * sp->w4 + xc];
    int qp_a = (!p->na_cand_left || !in_same_ctb_a)
        ? qp_pred : sp->qp0[yc * sp->w4 + xc - 1];
    return (qp_a + qp_b + 1) >> 1;
}

static int cu_qp_delta_abs(Parser *p)
{
    Cabac *c = p->c;
    const SliceParams *sp = p->sp;
    if (!cabac_bin_(c, sp->ctx_qp_delta_abs))
        return 0;
    int v = 1;
    while (v < 5 && cabac_bin_(c, sp->ctx_qp_delta_abs + 1))
        v++;
    if (v < 5)
        return v;
    int k = 0;
    while (k < 6 && cabac_bypass_(c))
        k++;
    int i = (1 << k) - 1;
    v = 0;
    for (int j = 0; j < k; j++)
        v = (v << 1) + cabac_bypass_(c);
    return v + i + 5;
}

/* set_qp_y (ctu.py:1703); cu rect (cu_x0,cu_y0,cu_w,cu_h), qg anchor (x0,y0) */
static void set_qp_y(Parser *p, int32_t *cu, int x0, int y0, int has_qp_delta)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    if (!sp->pps_cu_qp_delta_enabled) {
        st->qp_y = sp->slice_qp_y;
    } else if (st->is_first_qg || (st->cu_qg_top_left_x == x0 &&
                                   st->cu_qg_top_left_y == y0)) {
        st->qp_y = get_qp_y_pred(p, cu[CU_X0], cu[CU_Y0]);
        st->is_first_qg = 0;
    }
    if (has_qp_delta) {
        int delta_abs = cu_qp_delta_abs(p);
        int delta = 0;
        if (delta_abs)
            delta = cabac_bypass_(p->c) ? -delta_abs : delta_abs;
        st->is_cu_qp_delta_coded = 1;
        if (delta) {
            int off = sp->qp_bd_offset;
            st->qp_y = (st->qp_y + delta + 64 + 2 * off) % (64 + off) - off;
        }
    }
    set_grid(sp, sp->qp0, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H], st->qp_y);
    cu[CU_QP0] = st->qp_y;
}

static void set_qp_c(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    if (!sp->chroma_format_idc)
        return;
    int x_center = cu[CU_X0] + cu[CU_W] / 2;
    int y_center = cu[CU_Y0] + cu[CU_H] / 2;
    int single_tree = cu[CU_TREE_TYPE] == SINGLE_TREE;
    int qp_luma;
    if (single_tree)
        qp_luma = st->qp_y + sp->qp_bd_offset;
    else
        qp_luma = sp->qp0[(y_center >> 2) * sp->w4 + (x_center >> 2)] +
                  sp->qp_bd_offset;
    int qp_chroma = imax(0, imin(63 + sp->qp_bd_offset, qp_luma));
    for (int i = 0; i < 2 + sp->sps_joint_cbcr; i++) {
        int qp = sp->chroma_qp_table[i * sp->qp_table_len + qp_chroma];
        qp = qp + sp->pps_chroma_qp_offset[i] + sp->sh_chroma_qp_offset[i] +
             st->chroma_qp_offset[i];
        qp = imax(-sp->qp_bd_offset, imin(63, qp)) + sp->qp_bd_offset;
        cu[CU_QP1 + i] = qp;
    }
}

/* ---- transform blocks / residual (ctu.py:1839-2023) ------------------- */

/* _set_tb_pos (ctu.py:2001) */
static void set_tb_pos(Parser *p, int x0, int y0, int w, int h, int c_idx)
{
    const SliceParams *sp = p->sp;
    int is_chroma = c_idx != 0;
    int hs = is_chroma ? sp->hshift1 : 0;
    int vs = is_chroma ? sp->vshift1 : 0;
    int x_tb = x0 >> 2, y_tb = y0 >> 2;
    int gw = imax(1, w >> (2 - hs));
    int gh = imax(1, h >> (2 - vs));
    int32_t *px = is_chroma ? sp->tb_pos_x1 : sp->tb_pos_x0;
    int32_t *py = is_chroma ? sp->tb_pos_y1 : sp->tb_pos_y0;
    int32_t *pw = is_chroma ? sp->tb_width1 : sp->tb_width0;
    int32_t *ph = is_chroma ? sp->tb_height1 : sp->tb_height0;
    for (int y = y_tb; y < y_tb + gh; y++)
        for (int x = x_tb; x < x_tb + gw; x++) {
            px[y * sp->w4 + x] = x0;
            py[y * sp->w4 + x] = y0;
            pw[y * sp->w4 + x] = w;
            ph[y * sp->w4 + x] = h;
        }
}

/* _set_tb_grid (ctu.py:2016): note max(w,4) applies to x extent only */
static void set_tb_grid(Parser *p, int32_t *tab, int x0, int y0, int w,
                        int h, int c_idx, int v)
{
    const SliceParams *sp = p->sp;
    int hs = c_idx ? sp->hshift1 : 0;
    int vs = c_idx ? sp->vshift1 : 0;
    int fw = w << hs, fh = h << vs;
    int xs = x0 >> 2, xe = (x0 + imax(fw, 4)) >> 2;
    int ys = y0 >> 2, ye = (y0 + fh) >> 2;
    for (int y = ys; y < ye; y++)
        for (int x = xs; x < xe; x++)
            tab[y * sp->w4 + x] = v;
}

/* append a TB record; returns its pointer or NULL on overflow */
static int32_t *push_tb(Parser *p, int x0, int y0, int w, int h, int c_idx)
{
    ParseOut *o = p->out;
    if (o->n_tb >= o->tb_cap) { o->err = 1; return 0; }
    int32_t *tb = o->tb + o->n_tb * TB_STRIDE;
    o->n_tb++;
    memset(tb, 0, TB_STRIDE * sizeof(int32_t));
    tb[TB_X0] = x0; tb[TB_Y0] = y0; tb[TB_W] = w; tb[TB_H] = h;
    tb[TB_C_IDX] = c_idx;
    tb[TB_COEFF_OFF] = -1;
    return tb;
}

/* decode one TB's residual via the shared C residual decoder
 * (mirrors cabac/native.py decode_residual_regular_native + residual.py
 * _code_residual_regular's zero-out derivation) */
static int decode_tb_residual(Parser *p, int32_t *tb, int sbt_flag,
                              int bdpcm_of)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    ParseOut *o = p->out;
    int w = tb[TB_W], h = tb[TB_H], c_idx = tb[TB_C_IDX];
    int log2_w = ilog2u(w), log2_h = ilog2u(h);
    int log2_zo_w, log2_zo_h;
    if (sp->sps_mts && sbt_flag && !c_idx && log2_w == 5 && log2_h < 6)
        log2_zo_w = 4;
    else
        log2_zo_w = imin(log2_w, 5);
    if (sp->sps_mts && sbt_flag && !c_idx && log2_w < 6 && log2_h == 5)
        log2_zo_h = 4;
    else
        log2_zo_h = imin(log2_h, 5);

    if (o->coeff_len + w * h > o->coeff_cap) { o->err = 1; return -1; }
    int32_t *coeffs = o->coeff + o->coeff_len;
    tb[TB_COEFF_OFF] = o->coeff_len;
    o->coeff_len += w * h;

    ResParams pp;
    memset(&pp, 0, sizeof(pp));
    pp.w = w; pp.h = h; pp.log2_w = log2_w; pp.log2_h = log2_h;
    pp.c_idx = c_idx;
    pp.log2_zo_w = log2_zo_w; pp.log2_zo_h = log2_zo_h;
    pp.ts = tb[TB_TS];
    pp.bdpcm = bdpcm_of;
    pp.dep_quant = sp->dep_quant;
    pp.sdh = sp->sdh;
    pp.reverse_last = sp->reverse_last;
    pp.persistent_rice = sp->sps_persistent_rice;
    pp.rrc_rice_ext = sp->sps_rrc_rice_ext;
    pp.bd_gt12 = sp->bit_depth > 12;
    pp.is_i_slice = sp->slice_type == SLICE_I;
    pp.log2_transform_range = sp->log2_transform_range;
    pp.ctx_sig = sp->ctx_sig;
    pp.ctx_last_x = sp->ctx_last_x;
    pp.ctx_last_y = sp->ctx_last_y;
    pp.ctx_sb_coded = sp->ctx_sb_coded;
    pp.ctx_gtx = sp->ctx_gtx;
    pp.ctx_par = sp->ctx_par;
    pp.stat_coeff = st->stat_coeff[c_idx];
    pp.max_scan_x = pp.max_scan_y = 0;
    pp.lfnst_dc_only = p->lfnst_dc_only;
    pp.lfnst_zero_out = p->lfnst_zero_out;
    pp.mts_dc_only = p->mts_dc_only;
    pp.mts_zero_out = p->mts_zero_out;

    /* sub-block scan + in-block scan (residual.py ResidualCtx geometry) */
    int log2_sb_w = (imin(log2_zo_w, log2_zo_h) < 2) ? 1 : 2;
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
    const uint8_t *sb_sx, *sb_sy, *sx, *sy;
    get_scan(log2_zo_w - log2_sb_w, log2_zo_h - log2_sb_h, &sb_sx, &sb_sy);
    get_scan(log2_sb_w, log2_sb_h, &sx, &sy);

    if (pp.ts && !sp->ts_res_disabled) {
        pp.ts_rice = sp->ts_rice;
        pp.ctx_ts_sign = sp->ctx_coeff_sign;
        decode_residual_ts(p->c, &pp, coeffs, sb_sx, sb_sy, sx, sy);
    } else {
        decode_residual_regular(p->c, &pp, coeffs, sb_sx, sb_sy, sx, sy);
    }

    tb[TB_MAX_SCAN_X] = pp.max_scan_x;
    tb[TB_MAX_SCAN_Y] = pp.max_scan_y;
    st->stat_coeff[c_idx] = pp.stat_coeff;
    p->lfnst_dc_only = pp.lfnst_dc_only;
    p->lfnst_zero_out = pp.lfnst_zero_out;
    p->mts_dc_only = pp.mts_dc_only;
    p->mts_zero_out = pp.mts_zero_out;
    return 0;
}

/* ---- transform unit / tree (ctu.py:1803-1999) -------------------------- */

static int tu_y_coded_flag(Parser *p, const int32_t *cu, int is_sbt_not_coded,
                           int sub_tu_index, int is_isp, int is_chroma_coded)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    int v = 0;
    if (!is_sbt_not_coded) {
        int has_flag = sub_tu_index < cu[CU_NSP] - 1 || !st->infer_tu_cbf_luma;
        if (!is_isp) {
            int is_large = cu[CU_W] > sp->max_tb_size_y ||
                           cu[CU_H] > sp->max_tb_size_y;
            has_flag = (cu[CU_PRED_MODE] == MODE_INTRA) || is_chroma_coded ||
                       is_large;
        }
        if (has_flag) {
            int inc;
            if (cu[CU_BDPCM0])
                inc = 1;
            else if (cu[CU_ISP] == ISP_NO_SPLIT)
                inc = 0;
            else
                inc = 2 + st->prev_tu_cbf_y;
            v = cabac_bin_(p->c, sp->ctx_tu_y + inc);
            st->prev_tu_cbf_y = v;
        } else {
            v = 1;
        }
    }
    if (is_isp)
        st->infer_tu_cbf_luma = st->infer_tu_cbf_luma && !v;
    return v;
}

static void chroma_qp_offset_decode(Parser *p, int is_128,
                                    int is_chroma_coded)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    if ((is_128 || is_chroma_coded) && sp->sh_cu_chroma_qp_offset_enabled &&
        !st->is_cu_chroma_qp_offset_coded) {
        int f = cabac_bin_(p->c, sp->ctx_chroma_qp_offset_flag);
        if (f) {
            int idx = 0;
            if (sp->pps_chroma_qp_offset_list_len_minus1 > 0) {
                /* truncated unary, ctx_step=0 */
                while (idx < sp->pps_chroma_qp_offset_list_len_minus1 &&
                       cabac_bin_(p->c, sp->ctx_chroma_qp_offset_idx))
                    idx++;
            }
            st->chroma_qp_offset[0] = sp->pps_cb_qp_offset_list[idx];
            st->chroma_qp_offset[1] = sp->pps_cr_qp_offset_list[idx];
            st->chroma_qp_offset[2] = sp->pps_jcbcr_qp_offset_list[idx];
        } else {
            st->chroma_qp_offset[0] = 0;
            st->chroma_qp_offset[1] = 0;
            st->chroma_qp_offset[2] = 0;
        }
        st->is_cu_chroma_qp_offset_coded = 1;
    }
}

static int transform_unit(Parser *p, int32_t *cu, int x0, int y0, int tu_w,
                          int tu_h, int sub_tu_index, int ch_type)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    ParseOut *o = p->out;
    Cabac *c = p->c;

    if (o->n_tu >= o->tu_cap) { o->err = 1; return -1; }
    int32_t *tu = o->tu + o->n_tu * TU_STRIDE;
    o->n_tu++;
    memset(tu, 0, TU_STRIDE * sizeof(int32_t));
    tu[TU_X0] = x0; tu[TU_Y0] = y0; tu[TU_W] = tu_w; tu[TU_H] = tu_h;
    tu[TU_TB_START] = o->n_tb;
    cu[CU_TU_COUNT]++;

    int tree_type = cu[CU_TREE_TYPE];
    int is_128 = cu[CU_W] > 64 || cu[CU_H] > 64;
    int is_isp = cu[CU_ISP] != ISP_NO_SPLIT;
    int is_isp_last = is_isp && sub_tu_index == cu[CU_NSP] - 1;
    int sbt_flag = cu[CU_SBT] & 1, sbt_pos = (cu[CU_SBT] >> 2) & 1;
    int is_sbt_not_coded = sbt_flag &&
        ((sub_tu_index == 0 && sbt_pos) || (sub_tu_index == 1 && !sbt_pos));
    int chroma_available = tree_type != DUAL_TREE_LUMA &&
        sp->chroma_format_idc && (!is_isp || is_isp_last);
    int xc, yc, wc, hc;
    if (tree_type == SINGLE_TREE && is_isp_last) {
        int xc4 = x0 >> 2, yc4 = y0 >> 2;
        const int32_t *px = ch_type ? sp->cb_pos_x1 : sp->cb_pos_x0;
        const int32_t *py = ch_type ? sp->cb_pos_y1 : sp->cb_pos_y0;
        const int32_t *pw = ch_type ? sp->cb_width1 : sp->cb_width0;
        const int32_t *ph = ch_type ? sp->cb_height1 : sp->cb_height0;
        xc = px[yc4 * sp->w4 + xc4];
        yc = py[yc4 * sp->w4 + xc4];
        wc = pw[yc4 * sp->w4 + xc4];
        hc = ph[yc4 * sp->w4 + xc4];
    } else {
        xc = x0; yc = y0; wc = tu_w; hc = tu_h;
    }
    if (chroma_available && !is_sbt_not_coded) {
        tu[TU_CODED1] = cabac_bin_(c, sp->ctx_tu_cb + cu[CU_BDPCM1]);
        int inc = cu[CU_BDPCM1] ? 2 : tu[TU_CODED1];
        tu[TU_CODED2] = cabac_bin_(c, sp->ctx_tu_cr + inc);
    }
    int is_chroma_coded = chroma_available &&
        (tu[TU_CODED1] || tu[TU_CODED2]);
    if (tree_type != DUAL_TREE_CHROMA) {
        tu[TU_CODED0] = tu_y_coded_flag(p, cu, is_sbt_not_coded,
                                        sub_tu_index, is_isp,
                                        is_chroma_coded);
        int has_qp_delta = (is_128 || tu[TU_CODED0] || is_chroma_coded) &&
            sp->pps_cu_qp_delta_enabled && !st->is_cu_qp_delta_coded;
        set_qp_y(p, cu, x0, y0, has_qp_delta);
        if (!push_tb(p, x0, y0, tu_w, tu_h, LUMA))
            return -1;
        tu[TU_TB_COUNT]++;
    }
    if (tree_type != DUAL_TREE_LUMA) {
        chroma_qp_offset_decode(p, is_128, is_chroma_coded);
        if (chroma_available) {
            if (!push_tb(p, xc, yc, wc >> sp->hshift1, hc >> sp->vshift1, CB))
                return -1;
            if (!push_tb(p, xc, yc, wc >> sp->hshift1, hc >> sp->vshift1, CR))
                return -1;
            tu[TU_TB_COUNT] += 2;
        }
    }
    if (sp->sps_joint_cbcr &&
        ((cu[CU_PRED_MODE] == MODE_INTRA &&
          (tu[TU_CODED1] || tu[TU_CODED2])) ||
         (tu[TU_CODED1] && tu[TU_CODED2])) && chroma_available) {
        int inc = 2 * tu[TU_CODED1] + tu[TU_CODED2] - 1;
        tu[TU_JCBCR] = cabac_bin_(c, sp->ctx_jcbcr + inc);
    }
    for (int t = 0; t < tu[TU_TB_COUNT]; t++) {
        int32_t *tb = o->tb + (tu[TU_TB_START] + t) * TB_STRIDE;
        int cidx = tb[TB_C_IDX];
        int is_chroma = cidx != LUMA;
        int coded = (&tu[TU_CODED0])[cidx];
        int has = coded;
        if (has && is_chroma)
            has = (cidx == CB) ? 1 : !(tu[TU_CODED1] && tu[TU_JCBCR]);
        tb[TB_HAS_COEFFS] = has;
        if (has) {
            int bdpcm = (&cu[CU_BDPCM0])[cidx];
            tb[TB_TS] = bdpcm;
            if (sp->sps_transform_skip && !bdpcm &&
                tb[TB_W] <= sp->max_ts_size && tb[TB_H] <= sp->max_ts_size &&
                !sbt_flag && (is_chroma || !is_isp))
                tb[TB_TS] = cabac_bin_(c, sp->ctx_ts_flag + is_chroma);
            if (decode_tb_residual(p, tb, sbt_flag, bdpcm))
                return -1;
            int32_t *ct = cidx == 0 ? sp->tu_coded0
                        : cidx == 1 ? sp->tu_coded1 : sp->tu_coded2;
            set_tb_grid(p, ct, tb[TB_X0], tb[TB_Y0], tb[TB_W], tb[TB_H],
                        cidx, coded);
        }
        if (cidx != CR)
            set_tb_pos(p, tb[TB_X0], tb[TB_Y0], tb[TB_W], tb[TB_H], cidx);
        if (cidx == CB)
            set_tb_grid(p, sp->tu_joint_cbcr, tb[TB_X0], tb[TB_Y0],
                        tb[TB_W], tb[TB_H], cidx, tu[TU_JCBCR]);
    }
    return 0;
}

static int transform_tree(Parser *p, int32_t *cu, int x0, int y0, int tu_w,
                          int tu_h, int ch_type)
{
    const SliceParams *sp = p->sp;
    p->st->infer_tu_cbf_luma = 1;
    if (cu[CU_SBT] & 1) {
        /* SBT split (vvc_ctu.c:437-461) */
        if (!((cu[CU_SBT] >> 1) & 1)) {
            int tw = tu_w * p->sbt_num_fourths_tb0 / 4;
            if (transform_unit(p, cu, x0, y0, tw, tu_h, 0, ch_type))
                return -1;
            return transform_unit(p, cu, x0 + tw, y0, tu_w - tw, tu_h, 1,
                                  ch_type);
        }
        int th = tu_h * p->sbt_num_fourths_tb0 / 4;
        if (transform_unit(p, cu, x0, y0, tu_w, th, 0, ch_type))
            return -1;
        return transform_unit(p, cu, x0, y0 + th, tu_w, tu_h - th, 1,
                              ch_type);
    }
    if (cu[CU_ISP] == ISP_NO_SPLIT) {
        if (tu_w > sp->max_tb_size_y || tu_h > sp->max_tb_size_y) {
            int ver_first = tu_w > sp->max_tb_size_y && tu_w > tu_h;
            int tw = ver_first ? tu_w / 2 : tu_w;
            int th = ver_first ? tu_h : tu_h / 2;
            if (transform_tree(p, cu, x0, y0, tw, th, ch_type))
                return -1;
            if (ver_first)
                return transform_tree(p, cu, x0 + tw, y0, tw, th,
                                            ch_type);
            return transform_tree(p, cu, x0, y0 + th, tw, th, ch_type);
        }
        return transform_unit(p, cu, x0, y0, tu_w, tu_h, 0, ch_type);
    } else if (cu[CU_ISP] == ISP_HOR_SPLIT) {
        int th = tu_h / cu[CU_NSP];
        for (int i = 0; i < cu[CU_NSP]; i++)
            if (transform_unit(p, cu, x0, y0 + th * i, tu_w, th, i, 0))
                return -1;
        return 0;
    } else {  /* ISP_VER_SPLIT */
        int tw = tu_w / cu[CU_NSP];
        for (int i = 0; i < cu[CU_NSP]; i++)
            if (transform_unit(p, cu, x0 + tw * i, y0, tw, tu_h, i, 0))
                return -1;
        return 0;
    }
}

/* ---- intra modes (ctu.py:764-1098) ------------------------------------ */

static void mpm_cands(Parser *p, const int32_t *cu, int *cand)
{
    const SliceParams *sp = p->sp;
    int x0 = cu[CU_X0], y0 = cu[CU_Y0];
    int x_a = (x0 - 1) >> 2;
    int y_a = (y0 + cu[CU_H] - 1) >> 2;
    int x_b = (x0 + cu[CU_W] - 1) >> 2;
    int y_b = (y0 - 1) >> 2;
    int mask = (1 << sp->ctb_log2) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    int avail_l = p->ctb_left_flag || x0b;
    int avail_u = p->ctb_up_flag || y0b;
    int a, b;
    if (!avail_l || sp->cpm0[y_a * sp->w4 + x_a] != MODE_INTRA ||
        sp->imf[y_a * sp->w4 + x_a])
        a = INTRA_PLANAR;
    else
        a = sp->ipm[y_a * sp->w4 + x_a];
    if (!avail_u || sp->cpm0[y_b * sp->w4 + x_b] != MODE_INTRA ||
        sp->imf[y_b * sp->w4 + x_b] || !y0b)
        b = INTRA_PLANAR;
    else
        b = sp->ipm[y_b * sp->w4 + x_b];
    if (a == b && a > INTRA_DC) {
        cand[0] = a;
        cand[1] = 2 + ((a + 61) % 64);
        cand[2] = 2 + ((a - 1) % 64);
        cand[3] = 2 + ((a + 60) % 64);
        cand[4] = 2 + (a % 64);
        return;
    }
    int minab = imin(a, b), maxab = imax(a, b);
    if (a > INTRA_DC && b > INTRA_DC) {
        int diff = maxab - minab;
        cand[0] = a; cand[1] = b;
        if (diff == 1) {
            cand[2] = 2 + ((minab + 61) % 64);
            cand[3] = 2 + ((maxab - 1) % 64);
            cand[4] = 2 + ((minab + 60) % 64);
        } else if (diff >= 62) {
            cand[2] = 2 + ((minab - 1) % 64);
            cand[3] = 2 + ((maxab + 61) % 64);
            cand[4] = 2 + (minab % 64);
        } else if (diff == 2) {
            cand[2] = 2 + ((minab - 1) % 64);
            cand[3] = 2 + ((minab + 61) % 64);
            cand[4] = 2 + ((maxab - 1) % 64);
        } else {
            cand[2] = 2 + ((minab + 61) % 64);
            cand[3] = 2 + ((minab - 1) % 64);
            cand[4] = 2 + ((maxab + 61) % 64);
        }
    } else if (a > INTRA_DC || b > INTRA_DC) {
        cand[0] = maxab;
        cand[1] = 2 + ((maxab + 61) % 64);
        cand[2] = 2 + ((maxab - 1) % 64);
        cand[3] = 2 + ((maxab + 60) % 64);
        cand[4] = 2 + (maxab % 64);
    } else {
        cand[0] = INTRA_DC;
        cand[1] = INTRA_VERT;
        cand[2] = INTRA_HORZ;
        cand[3] = INTRA_VERT - 4;
        cand[4] = INTRA_VERT + 4;
    }
}

static int luma_intra_pred_mode(Parser *p, const int32_t *cu,
                                int isp_mode_flag)
{
    const SliceParams *sp = p->sp;
    Cabac *c = p->c;
    int mpm_flag = 1;
    if (!cu[CU_MRL])
        mpm_flag = cabac_bin_(c, sp->ctx_mpm);
    int not_planar = 1, mpm_idx = 0, remainder = 0;
    if (mpm_flag) {
        if (!cu[CU_MRL])
            not_planar = cabac_bin_(c, sp->ctx_not_planar +
                                          (isp_mode_flag ? 0 : 1));
        if (not_planar)
            while (mpm_idx < 4 && cabac_bypass_(c))
                mpm_idx++;
    } else {
        remainder = cabac_truncated_binary_(c, 60);
    }
    if (!not_planar)
        return INTRA_PLANAR;
    int cand[5];
    mpm_cands(p, cu, cand);
    if (mpm_flag)
        return cand[mpm_idx];
    /* sort the 5 candidates ascending, then skip over them */
    int s[5];
    memcpy(s, cand, sizeof(s));
    for (int i = 1; i < 5; i++)
        for (int j = i; j > 0 && s[j - 1] > s[j]; j--) {
            int t = s[j]; s[j] = s[j - 1]; s[j - 1] = t;
        }
    int pred = remainder + 1;
    for (int i = 0; i < 5; i++)
        if (pred >= s[i])
            pred++;
    return pred;
}

static void intra_luma_pred_modes(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    Cabac *c = p->c;
    int x0 = cu[CU_X0], y0 = cu[CU_Y0], w = cu[CU_W], h = cu[CU_H];
    cu[CU_MRL] = 0;
    if (sp->sps_bdpcm && w <= sp->max_ts_size && h <= sp->max_ts_size)
        cu[CU_BDPCM0] = cabac_bin_(c, sp->ctx_bdpcm_luma);
    if (cu[CU_BDPCM0]) {
        int d = cabac_bin_(c, sp->ctx_bdpcm_luma_dir);
        cu[CU_IPM_Y] = d ? INTRA_VERT : INTRA_HORZ;
    } else {
        if (sp->sps_mip) {
            int inc;
            if (w > h * 2 || h > w * 2) {
                inc = 3;
            } else {
                int left, top;
                left_top_pair(p, sp->imf, sp->imf, x0, y0, 0, 0, &left, &top);
                inc = left + top;
            }
            cu[CU_MIP_FLAG] = cabac_bin_(c, sp->ctx_mip + inc);
        }
        if (cu[CU_MIP_FLAG]) {
            cu[CU_MIP_T] = cabac_bypass_(c);
            int c_max = (w == 4 && h == 4) ? 15
                : ((w == 4 || h == 4 || (w == 8 && h == 8)) ? 7 : 5);
            cu[CU_MIP_MODE] = cabac_truncated_binary_(c, c_max);
            set_grid(sp, sp->imf, x0, y0, w, h, 1);
            set_grid(sp, sp->imtf, x0, y0, w, h, cu[CU_MIP_T]);
            set_grid(sp, sp->imm, x0, y0, w, h, cu[CU_MIP_MODE]);
            cu[CU_IPM_Y] = cu[CU_MIP_MODE];
        } else {
            int isp_mode_flag = 0;
            if (sp->sps_mrl && (y0 % (1 << sp->ctb_log2)) > 0) {
                /* truncated unary c_max=2 over INTRA_LUMA_REF_IDX ctxs */
                int i = 0;
                while (i < 2 && cabac_bin_(c, sp->ctx_mrl + i))
                    i++;
                cu[CU_MRL] = i;
            }
            if (sp->sps_isp && !cu[CU_MRL] && w <= sp->max_tb_size_y &&
                h <= sp->max_tb_size_y && w * h > 16)
                isp_mode_flag = cabac_bin_(c, sp->ctx_isp_mode);
            if (!(x0 & 63) && !(y0 & 63))
                sp->ispmf[(y0 >> 6) * sp->w64 + (x0 >> 6)] = isp_mode_flag;
            if (isp_mode_flag)
                cu[CU_ISP] = 1 + cabac_bin_(c, sp->ctx_isp_split);
            else
                cu[CU_ISP] = ISP_NO_SPLIT;
            if (cu[CU_ISP] == ISP_NO_SPLIT)
                cu[CU_NSP] = 1;
            else if ((w == 4 && h == 8) || (w == 8 && h == 4))
                cu[CU_NSP] = 2;
            else
                cu[CU_NSP] = 4;
            cu[CU_IPM_Y] = luma_intra_pred_mode(p, cu, isp_mode_flag);
        }
    }
    set_grid(sp, sp->ipm, x0, y0, w, h, cu[CU_IPM_Y]);
}

static int get_cclm_enabled(Parser *p, const int32_t *cu)
{
    const SliceParams *sp = p->sp;
    if (!sp->sps_cclm)
        return 0;
    if (!sp->sps_dual_tree || sp->slice_type != SLICE_I || sp->ctb_log2 < 6)
        return 1;
    int x0 = cu[CU_X0], y0 = cu[CU_Y0];
    int x64 = (x0 >> 6) << 6, y64 = (y0 >> 6) << 6;
    int y32 = (y0 >> 5) << 5;
    int xc = x64 >> 2, yc = y64 >> 2, yc32 = y32 >> 2;
    int depth = sp->cqt_depth1[yc * sp->w4 + xc];
    int min_depth = sp->ctb_log2 - 6;
    int msm64 = sp->msm0[(y64 >> 5) * sp->w32 + (x64 >> 5)];
    int msm32 = sp->msm1[(y32 >> 5) * sp->w32 + (x64 >> 5)];
    int enabled = sp->cb_width1[yc * sp->w4 + xc] == 64 &&
                  sp->cb_height1[yc * sp->w4 + xc] == 64;
    enabled |= depth == min_depth && msm64 == SPLIT_BT_HOR &&
               sp->cb_width1[yc32 * sp->w4 + xc] == 64 &&
               sp->cb_height1[yc32 * sp->w4 + xc] == 32;
    enabled |= depth > min_depth;
    enabled |= depth == min_depth && msm64 == SPLIT_BT_HOR &&
               msm32 == SPLIT_BT_VER;
    if (enabled) {
        int w = sp->cb_width0[yc * sp->w4 + xc];
        int h = sp->cb_height0[yc * sp->w4 + xc];
        int depth0 = sp->cqt_depth0[yc * sp->w4 + xc];
        if ((w == 64 && h == 64 &&
             sp->ispmf[(y64 >> 6) * sp->w64 + (x64 >> 6)]) ||
            ((w < 64 || h < 64) && depth0 == min_depth))
            return 0;
    }
    return enabled != 0;
}

static void derive_chroma_intra_pred_mode(Parser *p, int32_t *cu,
                                          int cclm_mode_flag,
                                          int cclm_mode_idx, int chroma_mode)
{
    const SliceParams *sp = p->sp;
    int xc = cu[CU_X0] >> 2, yc = cu[CU_Y0] >> 2;
    int intra_mip_flag = sp->imf[yc * sp->w4 + xc];
    int luma_mode = sp->ipm[yc * sp->w4 + xc];
    if (cu[CU_TREE_TYPE] == SINGLE_TREE && sp->chroma_format_idc == 3 &&
        chroma_mode == 4 && intra_mip_flag) {
        cu[CU_MIP_CHROMA_DIRECT] = 1;
        cu[CU_IPM_C] = luma_mode;
        return;
    }
    int x_center = (cu[CU_X0] + cu[CU_W] / 2) >> 2;
    int y_center = (cu[CU_Y0] + cu[CU_H] / 2) >> 2;
    int c_mip = sp->imf[y_center * sp->w4 + x_center];
    int c_cpm = sp->cpm0[y_center * sp->w4 + x_center];
    int c_ipm = sp->ipm[y_center * sp->w4 + x_center];
    if (c_mip) {
        if (cu[CU_TREE_TYPE] == SINGLE_TREE && sp->chroma_format_idc == 3)
            luma_mode = INTRA_INVALID;
        else
            luma_mode = INTRA_PLANAR;
    } else if (c_cpm == MODE_IBC || c_cpm == MODE_PLT) {
        luma_mode = INTRA_DC;
    } else {
        luma_mode = c_ipm;
    }
    if (cclm_mode_flag) {
        cu[CU_IPM_C] = INTRA_LT_CCLM + cclm_mode_idx;
    } else if (chroma_mode == 4) {
        cu[CU_IPM_C] = luma_mode;
    } else {
        static const int pred_mode_c[4][5] = {
            {INTRA_VDIAG, INTRA_PLANAR, INTRA_PLANAR, INTRA_PLANAR,
             INTRA_PLANAR},
            {INTRA_VERT, INTRA_VDIAG, INTRA_VERT, INTRA_VERT, INTRA_VERT},
            {INTRA_HORZ, INTRA_HORZ, INTRA_VDIAG, INTRA_HORZ, INTRA_HORZ},
            {INTRA_DC, INTRA_DC, INTRA_DC, INTRA_VDIAG, INTRA_DC}};
        static const int modes[4] = {INTRA_PLANAR, INTRA_VERT, INTRA_HORZ,
                                     INTRA_DC};
        int idx = 4;
        if (!(cu[CU_TREE_TYPE] == SINGLE_TREE &&
              sp->chroma_format_idc == 3 && intra_mip_flag)) {
            for (int i = 0; i < 4; i++)
                if (modes[i] == luma_mode) { idx = i; break; }
        }
        cu[CU_IPM_C] = pred_mode_c[chroma_mode][idx];
    }
    if (sp->chroma_format_idc == 2 && cu[CU_IPM_C] <= INTRA_VDIAG) {
        static const int mode_map_422[67] = {
            0, 1, 61, 62, 63, 64, 65, 66, 2, 3, 5, 6, 8, 10, 12, 13,
            14, 16, 18, 20, 22, 23, 24, 26, 28, 30, 31, 33, 34, 35, 36, 37,
            38, 39, 40, 41, 41, 42, 43, 43, 44, 44, 45, 45, 46, 47, 48, 48,
            49, 49, 50, 51, 51, 52, 52, 53, 54, 55, 55, 56, 56, 57, 57, 58,
            59, 59, 60};
        cu[CU_IPM_C] = mode_map_422[cu[CU_IPM_C]];
    }
}

static void intra_chroma_pred_modes(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    Cabac *c = p->c;
    cu[CU_MIP_CHROMA_DIRECT] = 0;
    if (sp->sps_bdpcm && (cu[CU_W] >> sp->hshift1) <= sp->max_ts_size &&
        (cu[CU_H] >> sp->vshift1) <= sp->max_ts_size) {
        int f = cabac_bin_(c, sp->ctx_bdpcm_chroma);
        cu[CU_BDPCM1] = cu[CU_BDPCM2] = f;
    }
    if (cu[CU_BDPCM1]) {
        int d = cabac_bin_(c, sp->ctx_bdpcm_chroma_dir);
        cu[CU_IPM_C] = d ? INTRA_VERT : INTRA_HORZ;
        return;
    }
    int cclm_enabled = get_cclm_enabled(p, cu);
    int cclm_mode_flag = 0, cclm_mode_idx = 0, chroma_mode = 0;
    if (cclm_enabled)
        cclm_mode_flag = cabac_bin_(c, sp->ctx_cclm_mode_flag);
    if (cclm_mode_flag) {
        if (!cabac_bin_(c, sp->ctx_cclm_mode_idx))
            cclm_mode_idx = 0;
        else
            cclm_mode_idx = cabac_bypass_(c) + 1;
    } else {
        if (!cabac_bin_(c, sp->ctx_chroma_pred_mode))
            chroma_mode = 4;
        else
            chroma_mode = (cabac_bypass_(c) << 1) |
                          cabac_bypass_(c);
    }
    derive_chroma_intra_pred_mode(p, cu, cclm_mode_flag, cclm_mode_idx,
                                  chroma_mode);
}

/* set_intra_mvf (ctu.py:1088) */
static void set_intra_mvf(Parser *p, const int32_t *cu)
{
    set_grid_u8(p->sp, p->sp->mvf_pf, cu[CU_X0], cu[CU_Y0], cu[CU_W],
                cu[CU_H], 0);
    set_grid_u8(p->sp, p->sp->col_pf, cu[CU_X0], cu[CU_Y0], cu[CU_W],
                cu[CU_H], 0);
}

/* ---- LFNST / MTS (ctu.py:2024-2089) ------------------------------------ */

static int lfnst_idx_decode(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    ParseOut *o = p->out;
    int tree_type = cu[CU_TREE_TYPE];
    cu[CU_ALF0] = cu[CU_ALF1] = cu[CU_ALF2] = 0;  /* apply_lfnst_flag */
    if (!sp->sps_lfnst || cu[CU_PRED_MODE] != MODE_INTRA ||
        imax(cu[CU_W], cu[CU_H]) > sp->max_tb_size_y)
        return 0;
    for (int t = 0; t < cu[CU_TU_COUNT]; t++) {
        const int32_t *tu = o->tu + (cu[CU_TU_START] + t) * TU_STRIDE;
        for (int b = 0; b < tu[TU_TB_COUNT]; b++) {
            const int32_t *tb = o->tb + (tu[TU_TB_START] + b) * TB_STRIDE;
            if ((&tu[TU_CODED0])[tb[TB_C_IDX]] && tb[TB_TS])
                return 0;
        }
    }
    int lw, lh;
    if (tree_type == DUAL_TREE_CHROMA) {
        lw = cu[CU_W] >> sp->hshift1;
        lh = cu[CU_H] >> sp->vshift1;
    } else {
        int vs = cu[CU_ISP] == ISP_VER_SPLIT;
        int hs = cu[CU_ISP] == ISP_HOR_SPLIT;
        lw = vs ? cu[CU_W] / cu[CU_NSP] : cu[CU_W];
        lh = hs ? cu[CU_H] / cu[CU_NSP] : cu[CU_H];
    }
    int min_lfnst = imin(lw, lh);
    if (tree_type != DUAL_TREE_CHROMA && cu[CU_MIP_FLAG] && min_lfnst < 16)
        return 0;
    int lfnst_idx = 0;
    if (min_lfnst >= 4) {
        if ((cu[CU_ISP] != ISP_NO_SPLIT || !p->lfnst_dc_only) &&
            p->lfnst_zero_out) {
            int inc = tree_type != SINGLE_TREE;
            if (cabac_bin_(p->c, sp->ctx_lfnst + inc))
                lfnst_idx = cabac_bin_(p->c, sp->ctx_lfnst + 2) ? 2 : 1;
        }
    }
    if (lfnst_idx) {
        cu[CU_ALF0] = tree_type != DUAL_TREE_CHROMA;
        cu[CU_ALF1] = cu[CU_ALF2] = tree_type == DUAL_TREE_CHROMA;
    }
    return lfnst_idx;
}

static int mts_idx_decode(Parser *p, const int32_t *cu)
{
    const SliceParams *sp = p->sp;
    ParseOut *o = p->out;
    int ts = 0;
    if (cu[CU_TU_COUNT] > 0) {
        const int32_t *tu0 = o->tu + cu[CU_TU_START] * TU_STRIDE;
        if (tu0[TU_TB_COUNT] > 0)
            ts = o->tb[tu0[TU_TB_START] * TB_STRIDE + TB_TS];
    }
    if (cu[CU_TREE_TYPE] != DUAL_TREE_CHROMA && !cu[CU_LFNST] && !ts &&
        imax(cu[CU_W], cu[CU_H]) <= 32 && cu[CU_ISP] == ISP_NO_SPLIT &&
        !(cu[CU_SBT] & 1) && p->mts_zero_out && !p->mts_dc_only) {
        if ((cu[CU_PRED_MODE] == MODE_INTER && sp->sps_explicit_mts_inter) ||
            (cu[CU_PRED_MODE] == MODE_INTRA && sp->sps_explicit_mts_intra)) {
            int i = 0;
            while (i < 4 && cabac_bin_(p->c, sp->ctx_mts + i))
                i++;
            return i;
        }
    }
    return 0;  /* MTS_DCT2_DCT2 */
}

/* set_cu_tabs (ctu.py:2091) */
static void set_cu_tabs(Parser *p, const int32_t *cu)
{
    const SliceParams *sp = p->sp;
    ParseOut *o = p->out;
    int x0 = cu[CU_X0], y0 = cu[CU_Y0], w = cu[CU_W], h = cu[CU_H];
    int ch = cu[CU_TREE_TYPE] == DUAL_TREE_CHROMA;
    set_grid(sp, ch ? sp->cb_pos_x1 : sp->cb_pos_x0, x0, y0, w, h, x0);
    set_grid(sp, ch ? sp->cb_pos_y1 : sp->cb_pos_y0, x0, y0, w, h, y0);
    set_grid(sp, ch ? sp->cb_width1 : sp->cb_width0, x0, y0, w, h, w);
    set_grid(sp, ch ? sp->cb_height1 : sp->cb_height0, x0, y0, w, h, h);
    set_grid(sp, ch ? sp->cqt_depth1 : sp->cqt_depth0, x0, y0, w, h,
             cu[CU_CQT_DEPTH]);
    set_grid(sp, sp->mmi, x0, y0, w, h,
             cu[CU_PRED_MODE] == MODE_INTER ? p->pu.mi_mmi : 0);
    set_grid(sp, sp->msf, x0, y0, w, h,
             cu[CU_PRED_MODE] == MODE_INTER ? p->pu.merge_subblock : 0);
    if (cu[CU_TREE_TYPE] != DUAL_TREE_CHROMA)
        set_grid(sp, sp->skip, x0, y0, w, h, cu[CU_SKIP]);
    for (int t = 0; t < cu[CU_TU_COUNT]; t++) {
        const int32_t *tu = o->tu + (cu[CU_TU_START] + t) * TU_STRIDE;
        for (int b = 0; b < tu[TU_TB_COUNT]; b++) {
            const int32_t *tb = o->tb + (tu[TU_TB_START] + b) * TB_STRIDE;
            int cidx = tb[TB_C_IDX];
            if (cidx != LUMA) {
                int is_jcbcr = tu[TU_JCBCR] && tu[TU_CODED1] && tu[TU_CODED2];
                int idx = is_jcbcr ? JCBCR : cidx;
                int32_t *qtab = cidx == 1 ? sp->qp1 : sp->qp2;
                set_tb_grid(p, qtab, tb[TB_X0], tb[TB_Y0], tb[TB_W],
                            tb[TB_H], cidx, cu[CU_QP0 + idx]);
            }
            if (cidx != CR && (&cu[CU_BDPCM0])[cidx])
                set_tb_grid(p, cidx ? sp->pcmf1 : sp->pcmf0, tb[TB_X0],
                            tb[TB_Y0], tb[TB_W], tb[TB_H], cidx, 1);
        }
    }
}

/* ---- inter CU syntax + MV derivation glue (ctu.py:1102-1638) ----------- */

/* exported for vvc_mvs.c */
void vvcp_set_neighbour_available(Parser *p, int x0, int y0, int w, int h)
{
    set_neighbour_available(p, x0, y0, w, h);
}

/* merge_idx_decode (ctu.py:1210) */
static int merge_idx_decode(Parser *p, int c_max)
{
    if (!cabac_bin_(p->c, p->sp->ctx_merge_idx))
        return 0;
    int i = 1;
    while (i < c_max && cabac_bypass_(p->c))
        i++;
    return i;
}

/* ff_vvc_mmvd_offset_coding (ctu.py:1254) */
static void mmvd_offset_coding(Parser *p, int fullpel_only, int off[2])
{
    Cabac *c = p->c;
    int dist_idx = 0;
    if (cabac_bin_(c, p->sp->ctx_mmvd_distance)) {
        int i = 1;
        while (i < 7 && cabac_bypass_(c))
            i++;
        dist_idx = i;
    }
    int shift = fullpel_only ? 4 : 2;
    int distance = 1 << (dist_idx + shift);
    int dir_idx = (cabac_bypass_(c) << 1) | cabac_bypass_(c);
    static const int signs[4][2] = { {1, 0}, {-1, 0}, {0, 1}, {0, -1} };
    off[0] = distance * signs[dir_idx][0];
    off[1] = distance * signs[dir_idx][1];
}

static void mvf_to_mi(const MvF *mvf, InterPU *pu)
{
    pu->mi_pf = mvf->pf;
    pu->mi_bcw = mvf->bcw;
    pu->mi_hpel = mvf->hpel;
    for (int i = 0; i < 2; i++) {
        if (mvf->pf & (i + 1)) {
            pu->mi_mv[i][0][0] = mvf->mv[i][0];
            pu->mi_mv[i][0][1] = mvf->mv[i][1];
            pu->mi_ref[i] = mvf->ref[i];
        }
    }
}

/* merge_data_regular (ctu.py:1218) */
static void merge_data_regular(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    int merge_idx = 0;
    int mmvd_offset[2] = { 0, 0 };
    if (sp->sps_mmvd)
        pu->mmvd = cabac_bin_(p->c, sp->ctx_mmvd_merge);
    if (pu->mmvd) {
        int mmvd_cand_flag = 0;
        if (sp->max_num_merge_cand > 1)
            mmvd_cand_flag = cabac_bin_(p->c, sp->ctx_mmvd_cand);
        mmvd_offset_coding(p, sp->ph_mmvd_fullpel, mmvd_offset);
        merge_idx = mmvd_cand_flag;
    } else if (sp->max_num_merge_cand > 1) {
        merge_idx = merge_idx_decode(p, sp->max_num_merge_cand - 1);
    }
    MvF mvf;
    mvs_luma_mv_merge_mode(p, cu, merge_idx, 0, &mvf);
    if (pu->mmvd)
        mvs_derive_mmvd(p, &mvf, mmvd_offset);
    mvs_mv_merge_refine_pred_flag(&mvf, cu[CU_W], cu[CU_H]);
    mvs_set_mvf(sp, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H], &mvf);
    mvf_to_mi(&mvf, pu);
}

/* merge_data_ciip (ctu.py:1309) */
static void merge_data_ciip(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    int merge_idx = 0;
    if (sp->max_num_merge_cand > 1)
        merge_idx = merge_idx_decode(p, sp->max_num_merge_cand - 1);
    MvF mvf;
    mvs_luma_mv_merge_mode(p, cu, merge_idx, 1, &mvf);
    mvs_mv_merge_refine_pred_flag(&mvf, cu[CU_W], cu[CU_H]);
    mvs_set_mvf(sp, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H], &mvf);
    mvf_to_mi(&mvf, &p->pu);
    cu[CU_IPM_Y] = INTRA_PLANAR;
    cu[CU_IPM_C] = INTRA_PLANAR;
    cu[CU_MRL] = 0;
    cu[CU_MIP_FLAG] = 0;
}

/* merge_data_gpm (ctu.py:1324) */
static void merge_data_gpm(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    pu->merge_gpm = 1;
    int idx0 = 0;
    for (int k = 0; k < 6; k++)
        idx0 = (idx0 << 1) | cabac_bypass_(p->c);
    pu->gpm_part = idx0;
    int merge_gpm_idx[2] = { 0, 0 };
    merge_gpm_idx[0] = merge_idx_decode(p, sp->max_num_gpm_cand - 1);
    if (sp->max_num_gpm_cand > 2)
        merge_gpm_idx[1] = merge_idx_decode(p, sp->max_num_gpm_cand - 2);
    mvs_luma_mv_merge_gpm(p, cu, merge_gpm_idx, pu->gpm_mv);
    mvs_store_gpm_mvf(p, cu, pu);
}

/* merge_data_subblock (ctu.py:1167) */
static void merge_data_subblock(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    int merge_subblock_idx = 0;
    int max_cand = sp->max_num_sb_merge_cand;
    if (max_cand > 1) {
        if (cabac_bin_(p->c, sp->ctx_merge_subblock_idx)) {
            int i = 1;
            while (i < max_cand - 1 && cabac_bypass_(p->c))
                i++;
            merge_subblock_idx = i;
        }
    }
    if (!mvs_sb_mv_merge_mode(p, cu, merge_subblock_idx, pu))
        mvs_store_sb_mvs(p, cu, pu);
}

/* merge_data_block (ctu.py:1180) */
static void merge_data_block(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    int w = cu[CU_W], h = cu[CU_H];
    int is_128 = w == 128 || h == 128;
    int ciip_avail = sp->sps_ciip && !cu[CU_SKIP] && w * h >= 64;
    int gpm_avail = sp->sps_gpm && sp->slice_type == SLICE_B &&
                    w >= 8 && h >= 8 && w < 8 * h && h < 8 * w;
    int regular_merge_flag = 1;
    if (!is_128 && (ciip_avail || gpm_avail)) {
        int inc = !cu[CU_SKIP];
        regular_merge_flag = cabac_bin_(p->c,
                                              sp->ctx_regular_merge + inc);
    }
    if (regular_merge_flag) {
        merge_data_regular(p, cu);
    } else {
        if (ciip_avail && gpm_avail)
            pu->ciip = cabac_bin_(p->c, sp->ctx_ciip);
        else
            pu->ciip = sp->sps_ciip && !cu[CU_SKIP] && !is_128 &&
                       w * h >= 64;
        if (pu->ciip)
            merge_data_ciip(p, cu);
        else
            merge_data_gpm(p, cu);
    }
}

/* hls_merge_data (ctu.py:1139) */
static void hls_merge_data(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    pu->merge_gpm = 0;
    pu->nsbx = pu->nsby = 1;
    if (sp->max_num_sb_merge_cand > 0 && cu[CU_W] >= 8 && cu[CU_H] >= 8) {
        int left, top, la, ta;
        left_top_pair(p, sp->msf, sp->msf, cu[CU_X0], cu[CU_Y0], 0, 0,
                      &left, &top);
        left_top_pair(p, sp->iaf, sp->iaf, cu[CU_X0], cu[CU_Y0], 0, 0,
                      &la, &ta);
        int inc = ((left || la) ? 1 : 0) + ((top || ta) ? 1 : 0);
        pu->merge_subblock = cabac_bin_(p->c,
                                              sp->ctx_merge_subblock + inc);
    }
    if (pu->merge_subblock)
        merge_data_subblock(p, cu);
    else
        merge_data_block(p, cu);
}

/* hls_mvd_coding (ctu.py:1383) */
static void mvd_coding(Parser *p, int mv[2])
{
    Cabac *c = p->c;
    const SliceParams *sp = p->sp;
    for (int i = 0; i < 2; i++)
        mv[i] = cabac_bin_(c, sp->ctx_mvd_gt0);
    for (int i = 0; i < 2; i++)
        if (mv[i])
            mv[i] += cabac_bin_(c, sp->ctx_mvd_gt1);
    for (int i = 0; i < 2; i++) {
        if (mv[i] > 0) {
            if (mv[i] == 2)
                mv[i] += cabac_limited_egk_(c, 1, 15, 17);
            int sign = cabac_bypass_(c);
            mv[i] = (1 - 2 * sign) * mv[i];
        }
    }
}

/* ff_vvc_pred_flag (ctu.py:1401) */
static int pred_flag_decode(Parser *p, const int32_t *cu, int is_b)
{
    const SliceParams *sp = p->sp;
    int w = cu[CU_W], h = cu[CU_H];
    if (!is_b)
        return PF_L0;
    if (w + h > 12) {
        int log2 = ilog2u(w) + ilog2u(h);
        int inc = 7 - ((1 + log2) >> 1);
        if (cabac_bin_(p->c, sp->ctx_inter_pred_idc + inc))
            return PF_BI;
    }
    return PF_L0 + cabac_bin_(p->c, sp->ctx_inter_pred_idc + 5);
}

/* ref_idx_decode (ctu.py:1415) */
static int ref_idx_decode(Parser *p, int lx, int sym_mvd_flag)
{
    const SliceParams *sp = p->sp;
    if (sp->num_ref_idx_active[lx] > 1 && !sym_mvd_flag) {
        int c_max = sp->num_ref_idx_active[lx] - 1;
        int max_ctx = imin(c_max, 2);
        int i = 0;
        while (i < max_ctx && cabac_bin_(p->c, sp->ctx_ref_idx + i))
            i++;
        if (i == 2) {
            while (i < c_max && cabac_bypass_(p->c))
                i++;
        }
        return i;
    }
    if (sym_mvd_flag)
        return sp->ref_idx_sym[lx];
    return 0;
}

/* ff_vvc_amvr_shift (ctu.py:1431); IBC unsupported */
static int amvr_precision_idx(Parser *p, int inc, int c_max)
{
    const SliceParams *sp = p->sp;
    if (!cabac_bin_(p->c, sp->ctx_amvr_precision + inc))
        return 0;
    int i = 1;
    if (i < c_max && cabac_bin_(p->c, sp->ctx_amvr_precision + 1))
        i++;
    return i;
}

static int amvr_shift_decode(Parser *p, int inter_affine_flag, int enabled)
{
    const SliceParams *sp = p->sp;
    int amvr_shift = 2;
    if (enabled) {
        if (cabac_bin_(p->c, sp->ctx_amvr_flag + inter_affine_flag)) {
            if (inter_affine_flag) {
                amvr_shift = amvr_precision_idx(p, 2, 1) * 4;
            } else {
                static const int shifts[3] = { 3, 4, 6 };
                amvr_shift = shifts[amvr_precision_idx(p, 0, 2)];
            }
        }
    }
    return amvr_shift;
}

/* bcw_idx_decode (ctu.py:1456) */
static int bcw_idx_decode(Parser *p, const int32_t *cu)
{
    const SliceParams *sp = p->sp;
    const InterPU *pu = &p->pu;
    if (sp->sps_bcw && pu->mi_pf == PF_BI &&
        !sp->wp_flag[0][0][pu->mi_ref[0]] &&
        !sp->wp_flag[1][0][pu->mi_ref[1]] &&
        !sp->wp_flag[0][1][pu->mi_ref[0]] &&
        !sp->wp_flag[1][1][pu->mi_ref[1]] &&
        cu[CU_W] * cu[CU_H] >= 256) {
        int c_max = mvs_no_backward_pred_flag(sp) ? 4 : 2;
        if (!cabac_bin_(p->c, sp->ctx_bcw))
            return 0;
        int i = 1;
        while (i < c_max && cabac_bypass_(p->c))
            i++;
        return i;
    }
    return 0;
}

/* mvp_data (ctu.py:1478) */
static void mvp_data(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    int is_b = sp->slice_type == SLICE_B;
    int mvds[2][3][2];
    memset(mvds, 0, sizeof(mvds));
    int mvp_lx_flag[2] = { 0, 0 };
    int cu_affine_type_flag = 0;
    int has_no_zero_mvd = 0;

    pu->mi_pf = pred_flag_decode(p, cu, is_b);
    if (sp->sps_affine && cu[CU_W] >= 16 && cu[CU_H] >= 16) {
        int la, ta, lb, tb;
        left_top_pair(p, sp->msf, sp->msf, cu[CU_X0], cu[CU_Y0], 0, 0,
                      &la, &ta);
        left_top_pair(p, sp->iaf, sp->iaf, cu[CU_X0], cu[CU_Y0], 0, 0,
                      &lb, &tb);
        int inc = ((la || lb) ? 1 : 0) + ((ta || tb) ? 1 : 0);
        pu->inter_affine = cabac_bin_(p->c,
                                            sp->ctx_inter_affine + inc);
        set_grid(sp, sp->iaf, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H],
                 pu->inter_affine);
        if (sp->sps_6param_affine && pu->inter_affine)
            cu_affine_type_flag = cabac_bin_(p->c,
                                                   sp->ctx_affine_type);
    }
    pu->mi_mmi = pu->inter_affine + cu_affine_type_flag;
    int num_cp_mv = pu->mi_mmi + 1;

    if (sp->sps_smvd && !sp->ph_mvd_l1_zero && pu->mi_pf == PF_BI &&
        !pu->inter_affine && sp->ref_idx_sym[0] > -1 &&
        sp->ref_idx_sym[1] > -1)
        pu->sym_mvd = cabac_bin_(p->c, sp->ctx_sym_mvd);

    for (int i = 0; i < 2; i++) {
        int pf = PF_L0 + (1 - i);
        if (pu->mi_pf != pf) {
            pu->mi_ref[i] = ref_idx_decode(p, i, pu->sym_mvd);
            /* mvds_decode (vvc_ctu.c:1524) */
            if (i == 1 && sp->ph_mvd_l1_zero && pu->mi_pf == PF_BI) {
                for (int j = 0; j < num_cp_mv; j++) {
                    mvds[1][j][0] = 0;
                    mvds[1][j][1] = 0;
                }
            } else {
                if (i == 1 && pu->sym_mvd) {
                    mvds[1][0][0] = -mvds[0][0][0];
                    mvds[1][0][1] = -mvds[0][0][1];
                } else {
                    mvd_coding(p, mvds[i][0]);
                }
                if (mvds[i][0][0] || mvds[i][0][1])
                    has_no_zero_mvd = 1;
                for (int j = 1; j < num_cp_mv; j++) {
                    int d[2];
                    mvd_coding(p, d);
                    d[0] += mvds[i][0][0];
                    d[1] += mvds[i][0][1];
                    mvds[i][j][0] = d[0];
                    mvds[i][j][1] = d[1];
                    if (d[0] || d[1])
                        has_no_zero_mvd = 1;
                }
            }
            mvp_lx_flag[i] = cabac_bin_(p->c, sp->ctx_mvp_lx);
        }
    }

    int amvr_enabled = pu->mi_mmi == 0 ? sp->sps_amvr : sp->sps_affine_amvr;
    amvr_enabled &= has_no_zero_mvd;
    int amvr_shift = amvr_shift_decode(p, pu->inter_affine, amvr_enabled);
    pu->mi_hpel = amvr_shift == 3;
    pu->mi_bcw = bcw_idx_decode(p, cu);

    if (pu->mi_mmi)
        mvs_ff_affine_mvp(p, cu, mvp_lx_flag, amvr_shift, pu);
    else
        mvs_ff_mvp(p, cu, mvp_lx_flag, amvr_shift, pu);

    /* mvp_add_difference (vvc_ctu.c:1556) */
    for (int i = 0; i < 2; i++) {
        if (pu->mi_pf & (i + 1)) {
            for (int j = 0; j < num_cp_mv; j++) {
                pu->mi_mv[i][j][0] += mvds[i][j][0] * (1 << amvr_shift);
                pu->mi_mv[i][j][1] += mvds[i][j][1] * (1 << amvr_shift);
            }
        }
    }

    if (pu->mi_mmi) {
        mvs_store_sb_mvs(p, cu, pu);
    } else {
        /* ff_vvc_store_mv (vvc_mvs.c:499) */
        MvF mvf;
        memset(&mvf, 0, sizeof(mvf));
        mvf.hpel = pu->mi_hpel;
        mvf.bcw = pu->mi_bcw;
        mvf.pf = pu->mi_pf;
        for (int i = 0; i < 2; i++) {
            if (pu->mi_pf & (i + 1)) {
                mvf.mv[i][0] = pu->mi_mv[i][0][0];
                mvf.mv[i][1] = pu->mi_mv[i][0][1];
                mvf.ref[i] = pu->mi_ref[i];
            }
        }
        mvs_set_mvf(sp, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H], &mvf);
    }
}

/* derive_dmvr_bdof_flag (ctu.py:1573) */
static void derive_dmvr_bdof_flag(Parser *p, const int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    pu->bdof = 0;
    pu->dmvr = 0;
    if (pu->mi_pf == PF_BI &&
        (sp->poc - sp->rpl_poc[0][pu->mi_ref[0]] ==
         sp->rpl_poc[1][pu->mi_ref[1]] - sp->poc) &&
        !sp->rpl_is_lt[0][pu->mi_ref[0]] &&
        !sp->rpl_is_lt[1][pu->mi_ref[1]] &&
        !pu->ciip && !pu->mi_bcw &&
        !sp->wp_flag[0][0][pu->mi_ref[0]] &&
        !sp->wp_flag[1][0][pu->mi_ref[1]] &&
        !sp->wp_flag[0][1][pu->mi_ref[0]] &&
        !sp->wp_flag[1][1][pu->mi_ref[1]] &&
        cu[CU_W] >= 8 && cu[CU_H] >= 8 &&
        cu[CU_W] * cu[CU_H] >= 128) {
        if (!sp->ph_bdof_disabled && pu->mi_mmi == 0 &&
            !pu->merge_subblock && !pu->sym_mvd)
            pu->bdof = 1;
        if (!sp->ph_dmvr_disabled && pu->general_merge && !pu->mmvd)
            pu->dmvr = 1;
    }
}

/* inter_data (ctu.py:1102) */
static void inter_data(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    InterPU *pu = &p->pu;
    memset(pu, 0, sizeof(*pu));
    pu->nsbx = pu->nsby = 1;
    pu->general_merge = 1;
    if (!cu[CU_SKIP])
        pu->general_merge = cabac_bin_(p->c, sp->ctx_general_merge);
    if (pu->general_merge)
        hls_merge_data(p, cu);
    else
        mvp_data(p, cu);
    if (!pu->merge_gpm && !pu->inter_affine && !pu->merge_subblock) {
        derive_dmvr_bdof_flag(p, cu);
        if (pu->dmvr || pu->bdof) {
            pu->nsbx = cu[CU_W] > 16 ? cu[CU_W] >> 4 : 1;
            pu->nsby = cu[CU_H] > 16 ? cu[CU_H] >> 4 : 1;
        }
        mvs_update_hmvp(p, cu);
    }
    if (!pu->dmvr)
        mvs_fill_dmvr_info(sp, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H]);
    /* PU fields -> CU record */
    cu[CU_MI_PF] = pu->mi_pf;
    cu[CU_REF0] = pu->mi_ref[0];
    cu[CU_REF1] = pu->mi_ref[1];
    cu[CU_BCW] = pu->mi_bcw;
    cu[CU_HPEL] = pu->mi_hpel;
    cu[CU_MMI] = pu->mi_mmi;
    cu[CU_NSBX] = pu->nsbx;
    cu[CU_NSBY] = pu->nsby;
    cu[CU_IFLAGS] = (pu->merge_gpm ? IF_MERGE_GPM : 0) |
                    (pu->inter_affine ? IF_AFFINE : 0) |
                    (pu->ciip ? IF_CIIP : 0) |
                    (pu->dmvr ? IF_DMVR : 0) |
                    (pu->bdof ? IF_BDOF : 0) |
                    (pu->prof[0] ? IF_PROF_L0 : 0) |
                    (pu->prof[1] ? IF_PROF_L1 : 0) |
                    (pu->general_merge ? IF_GENERAL_MERGE : 0) |
                    (pu->merge_subblock ? IF_MERGE_SUBBLOCK : 0);
    if (pu->merge_gpm) {
        cu[CU_GPM_PART] = pu->gpm_part;
        for (int i = 0; i < 2; i++) {
            int lx = pu->gpm_mv[i].pf - PF_L0;
            (&cu[CU_GPM0_LX])[i * 4] = lx;
            (&cu[CU_GPM0_REF])[i * 4] = pu->gpm_mv[i].ref[lx];
            (&cu[CU_GPM0_MVX])[i * 4] = pu->gpm_mv[i].mv[lx][0];
            (&cu[CU_GPM0_MVY])[i * 4] = pu->gpm_mv[i].mv[lx][1];
        }
    }
}

/* sbt_info (ctu.py:1602) */
static void sbt_info(Parser *p, int32_t *cu)
{
    const SliceParams *sp = p->sp;
    if (!(cu[CU_PRED_MODE] == MODE_INTER && sp->sps_sbt && !p->pu.ciip &&
          cu[CU_W] <= sp->max_tb_size_y && cu[CU_H] <= sp->max_tb_size_y))
        return;
    int w = cu[CU_W], h = cu[CU_H];
    int sbt_ver_h = w >= 8;
    int sbt_hor_h = h >= 8;
    int sbt_flag = 0;
    if (sbt_ver_h || sbt_hor_h) {
        int inc = w * h <= 256;
        sbt_flag = cabac_bin_(p->c, sp->ctx_sbt_flag + inc);
    }
    if (sbt_flag) {
        int sbt_ver_q = w >= 16;
        int sbt_hor_q = h >= 16;
        int quad = 0;
        int horizontal;
        if ((sbt_ver_h || sbt_hor_h) && (sbt_ver_q || sbt_hor_q))
            quad = cabac_bin_(p->c, sp->ctx_sbt_quad);
        if (quad) {
            horizontal = sbt_hor_q;
            if (sbt_ver_q && sbt_hor_q) {
                int inc = w == h ? 0 : (w < h ? 1 : 2);
                horizontal = cabac_bin_(p->c,
                                              sp->ctx_sbt_horizontal + inc);
            }
        } else {
            horizontal = sbt_hor_h;
            if (sbt_ver_h && sbt_hor_h) {
                int inc = w == h ? 0 : (w < h ? 1 : 2);
                horizontal = cabac_bin_(p->c,
                                              sp->ctx_sbt_horizontal + inc);
            }
        }
        int pos = cabac_bin_(p->c, sp->ctx_sbt_pos);
        int sbt_min = quad ? 1 : 2;
        p->sbt_num_fourths_tb0 = pos ? (4 - sbt_min) : sbt_min;
        cu[CU_SBT] = 1 | (horizontal << 1) | (pos << 2);
    }
}

/* ---- coding unit (ctu.py:673-763) -------------------------------------- */

static int pred_mode_decode(Parser *p, int32_t *cu, int tree_type,
                            int mode_type)
{
    const SliceParams *sp = p->sp;
    int ch_type = tree_type == DUAL_TREE_CHROMA;
    int is_4x4 = cu[CU_W] == 4 && cu[CU_H] == 4;
    int is_i = sp->slice_type == SLICE_I;
    int pred_mode;
    cu[CU_SKIP] = 0;
    if (!is_i || sp->sps_ibc) {
        int is_128 = cu[CU_W] == 128 || cu[CU_H] == 128;
        if (tree_type != DUAL_TREE_CHROMA &&
            ((!is_4x4 && mode_type != MODE_TYPE_INTRA) ||
             (sp->sps_ibc && !is_128))) {
            int left, top;
            left_top_pair(p, sp->skip, sp->skip, cu[CU_X0], cu[CU_Y0], 0, 0,
                          &left, &top);
            cu[CU_SKIP] = cabac_bin_(p->c,
                                           sp->ctx_cu_skip + left + top);
        }
        int pred_mode_flag;
        if (is_4x4 || mode_type == MODE_TYPE_INTRA || is_i) {
            pred_mode_flag = 1;
        } else if (mode_type == MODE_TYPE_INTER || cu[CU_SKIP]) {
            pred_mode_flag = 0;
        } else {
            const int32_t *cpm = ch_type ? sp->cpm1 : sp->cpm0;
            int left, top;
            left_top_pair(p, cpm, cpm, cu[CU_X0], cu[CU_Y0], 0, 0,
                          &left, &top);
            int inc = (left != 0) || (top != 0);
            pred_mode_flag = cabac_bin_(p->c, sp->ctx_pred_mode + inc);
        }
        pred_mode = pred_mode_flag ? MODE_INTRA : MODE_INTER;
        if (sp->sps_ibc) { p->out->err = 3; return MODE_INTRA; }
    } else {
        pred_mode = MODE_INTRA;
    }
    set_grid(sp, ch_type ? sp->cpm1 : sp->cpm0, cu[CU_X0], cu[CU_Y0],
             cu[CU_W], cu[CU_H], pred_mode);
    if (tree_type == SINGLE_TREE)
        set_grid(sp, sp->cpm1, cu[CU_X0], cu[CU_Y0], cu[CU_W], cu[CU_H],
                 pred_mode);
    return pred_mode;
}

/* skipped_transform_tree_unit (ctu.py:1974): inter-skip CUs; records TBs
 * without residual */
static int skipped_transform_tree(Parser *p, int32_t *cu, int x0, int y0,
                                  int tu_w, int tu_h)
{
    const SliceParams *sp = p->sp;
    ParseOut *o = p->out;
    if (tu_w > sp->max_tb_size_y || tu_h > sp->max_tb_size_y) {
        int ver_first = tu_w > sp->max_tb_size_y && tu_w > tu_h;
        int tw = ver_first ? tu_w / 2 : tu_w;
        int th = ver_first ? tu_h : tu_h / 2;
        if (skipped_transform_tree(p, cu, x0, y0, tw, th))
            return -1;
        if (ver_first)
            return skipped_transform_tree(p, cu, x0 + tw, y0, tw, th);
        return skipped_transform_tree(p, cu, x0, y0 + th, tw, th);
    }
    if (o->n_tu >= o->tu_cap) { o->err = 1; return -1; }
    int32_t *tu = o->tu + o->n_tu * TU_STRIDE;
    o->n_tu++;
    memset(tu, 0, TU_STRIDE * sizeof(int32_t));
    tu[TU_X0] = x0; tu[TU_Y0] = y0; tu[TU_W] = tu_w; tu[TU_H] = tu_h;
    tu[TU_TB_START] = o->n_tb;
    cu[CU_TU_COUNT]++;
    int c_end = sp->chroma_format_idc ? 3 : 1;
    for (int i = 0; i < c_end; i++) {
        int hs = i ? sp->hshift1 : 0, vs = i ? sp->vshift1 : 0;
        if (!push_tb(p, x0, y0, tu_w >> hs, tu_h >> vs, i))
            return -1;
        tu[TU_TB_COUNT]++;
        if (i != CR)
            set_tb_pos(p, x0, y0, tu_w >> hs, tu_h >> vs, i);
    }
    return 0;
}

static int coding_unit(Parser *p, int x0, int y0, int w, int h,
                       int cqt_depth, int tree_type, int mode_type)
{
    const SliceParams *sp = p->sp;
    ParseOut *o = p->out;
    int is_128 = w > 64 || h > 64;

    if (o->n_cu >= o->cu_cap) { o->err = 1; return -1; }
    int32_t *cu = o->cu + o->n_cu * CU_STRIDE;
    o->n_cu++;
    memset(cu, 0, CU_STRIDE * sizeof(int32_t));
    cu[CU_X0] = x0; cu[CU_Y0] = y0; cu[CU_W] = w; cu[CU_H] = h;
    cu[CU_CQT_DEPTH] = cqt_depth;
    cu[CU_TREE_TYPE] = tree_type;
    cu[CU_PRED_MODE] = MODE_INTRA;
    cu[CU_CODED] = 1;
    cu[CU_NSP] = 1;
    cu[CU_TU_START] = o->n_tu;
    p->cu = cu;
    /* per-CU parse state (reference add_cu, vvc_ctu.c:1205) */
    p->st->prev_tu_cbf_y = 0;
    /* cb geometry grids are written at CU alloc time (reference set_cb_pos,
     * vvc_ctu.c:1226): the ISP-last-TU chroma lookup reads them mid-CU */
    {
        const SliceParams *spp = p->sp;
        int ch = tree_type == DUAL_TREE_CHROMA;
        set_grid(spp, ch ? spp->cb_pos_x1 : spp->cb_pos_x0, x0, y0, w, h, x0);
        set_grid(spp, ch ? spp->cb_pos_y1 : spp->cb_pos_y0, x0, y0, w, h, y0);
        set_grid(spp, ch ? spp->cb_width1 : spp->cb_width0, x0, y0, w, h, w);
        set_grid(spp, ch ? spp->cb_height1 : spp->cb_height0, x0, y0, w, h, h);
        set_grid(spp, ch ? spp->cqt_depth1 : spp->cqt_depth0, x0, y0, w, h,
                 cqt_depth);
    }

    set_neighbour_available(p, x0, y0, w, h);
    if (sp->slice_type == SLICE_I && is_128)
        mode_type = MODE_TYPE_INTRA;
    cu[CU_PRED_MODE] = pred_mode_decode(p, cu, tree_type, mode_type);
    if (o->err)
        return -1;
    if (cu[CU_PRED_MODE] == MODE_INTRA && (sp->sps_palette || sp->sps_act)) {
        o->err = 3;  /* palette / ACT unsupported (matches Python) */
        return -1;
    }
    memset(&p->pu, 0, sizeof(p->pu));
    if (cu[CU_PRED_MODE] == MODE_INTRA || cu[CU_PRED_MODE] == MODE_PLT) {
        if (tree_type == SINGLE_TREE || tree_type == DUAL_TREE_LUMA) {
            intra_luma_pred_modes(p, cu);
            set_intra_mvf(p, cu);
        }
        if ((tree_type == SINGLE_TREE || tree_type == DUAL_TREE_CHROMA) &&
            sp->chroma_format_idc)
            intra_chroma_pred_modes(p, cu);
    } else if (tree_type != DUAL_TREE_CHROMA) {
        inter_data(p, cu);
        if (o->err)
            return -1;
    }
    if (cu[CU_PRED_MODE] != MODE_INTRA && !p->pu.general_merge)
        cu[CU_CODED] = cabac_bin_(p->c, sp->ctx_cu_coded);
    else
        cu[CU_CODED] = !cu[CU_SKIP];
    if (cu[CU_CODED]) {
        sbt_info(p, cu);
        p->lfnst_dc_only = 1;
        p->lfnst_zero_out = 1;
        p->mts_dc_only = 1;
        p->mts_zero_out = 1;
        if (transform_tree(p, cu, x0, y0, w, h,
                           tree_type == DUAL_TREE_CHROMA))
            return -1;
        cu[CU_LFNST] = lfnst_idx_decode(p, cu);
        cu[CU_MTS] = mts_idx_decode(p, cu);
        set_qp_c(p, cu);
    } else {
        set_qp_y(p, cu, x0, y0, 0);
        set_qp_c(p, cu);
        if (skipped_transform_tree(p, cu, x0, y0, w, h))
            return -1;
    }
    set_cu_tabs(p, cu);
    return 0;
}

/* ---- coding tree (ctu.py:581-671) -------------------------------------- */

static int do_split(Parser *p, int split, int x0, int y0, int w, int h,
                    int qg_on_y, int qg_on_c, int cb_sub_div, int cqt_depth,
                    int mtt_depth, int depth_offset, int tree_type,
                    int mode_type)
{
    const SliceParams *sp = p->sp;
#define CT(...) do { if (coding_tree(p, __VA_ARGS__)) return -1; } while (0)
    if (split == SPLIT_BT_VER) {
        depth_offset += (x0 + w > sp->width) ? 1 : 0;
        int x1 = x0 + w / 2;
        CT(x0, y0, w / 2, h, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
           mtt_depth + 1, depth_offset, 0, SPLIT_BT_VER, tree_type,
           mode_type);
        if (x1 < sp->width)
            CT(x1, y0, w / 2, h, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
               mtt_depth + 1, depth_offset, 1, SPLIT_BT_VER, tree_type,
               mode_type);
    } else if (split == SPLIT_BT_HOR) {
        depth_offset += (y0 + h > sp->height) ? 1 : 0;
        int y1 = y0 + h / 2;
        CT(x0, y0, w, h / 2, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
           mtt_depth + 1, depth_offset, 0, SPLIT_BT_HOR, tree_type,
           mode_type);
        if (y1 < sp->height)
            CT(x0, y1, w, h / 2, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
               mtt_depth + 1, depth_offset, 1, SPLIT_BT_HOR, tree_type,
               mode_type);
    } else if (split == SPLIT_TT_VER) {
        qg_on_y = qg_on_y && (cb_sub_div + 2 <= sp->cu_qp_delta_subdiv);
        qg_on_c = qg_on_c &&
            (cb_sub_div + 2 <= sp->cu_chroma_qp_offset_subdiv);
        int x1 = x0 + w / 4, x2 = x0 + 3 * w / 4;
        CT(x0, y0, w / 4, h, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
           mtt_depth + 1, depth_offset, 0, SPLIT_TT_VER, tree_type,
           mode_type);
        CT(x1, y0, w / 2, h, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
           mtt_depth + 1, depth_offset, 1, SPLIT_TT_VER, tree_type,
           mode_type);
        CT(x2, y0, w / 4, h, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
           mtt_depth + 1, depth_offset, 2, SPLIT_TT_VER, tree_type,
           mode_type);
    } else if (split == SPLIT_TT_HOR) {
        qg_on_y = qg_on_y && (cb_sub_div + 2 <= sp->cu_qp_delta_subdiv);
        qg_on_c = qg_on_c &&
            (cb_sub_div + 2 <= sp->cu_chroma_qp_offset_subdiv);
        int y1 = y0 + h / 4, y2 = y0 + 3 * h / 4;
        CT(x0, y0, w, h / 4, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
           mtt_depth + 1, depth_offset, 0, SPLIT_TT_HOR, tree_type,
           mode_type);
        CT(x0, y1, w, h / 2, qg_on_y, qg_on_c, cb_sub_div + 1, cqt_depth,
           mtt_depth + 1, depth_offset, 1, SPLIT_TT_HOR, tree_type,
           mode_type);
        CT(x0, y2, w, h / 4, qg_on_y, qg_on_c, cb_sub_div + 2, cqt_depth,
           mtt_depth + 1, depth_offset, 2, SPLIT_TT_HOR, tree_type,
           mode_type);
    } else {  /* SPLIT_QT */
        int x1 = x0 + w / 2, y1 = y0 + h / 2;
        CT(x0, y0, w / 2, h / 2, qg_on_y, qg_on_c, cb_sub_div + 2,
           cqt_depth + 1, 0, 0, 0, SPLIT_QT, tree_type, mode_type);
        if (x1 < sp->width)
            CT(x1, y0, w / 2, h / 2, qg_on_y, qg_on_c, cb_sub_div + 2,
               cqt_depth + 1, 0, 0, 1, SPLIT_QT, tree_type, mode_type);
        if (y1 < sp->height)
            CT(x0, y1, w / 2, h / 2, qg_on_y, qg_on_c, cb_sub_div + 2,
               cqt_depth + 1, 0, 0, 2, SPLIT_QT, tree_type, mode_type);
        if (x1 < sp->width && y1 < sp->height)
            CT(x1, y1, w / 2, h / 2, qg_on_y, qg_on_c, cb_sub_div + 2,
               cqt_depth + 1, 0, 0, 3, SPLIT_QT, tree_type, mode_type);
    }
#undef CT
    return 0;
}

static int coding_tree(Parser *p, int x0, int y0, int w, int h, int qg_on_y,
                       int qg_on_c, int cb_sub_div, int cqt_depth,
                       int mtt_depth, int depth_offset, int part_idx,
                       int last_split, int tree_type_curr,
                       int mode_type_curr)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    int ch_type = tree_type_curr == DUAL_TREE_CHROMA;
    if (sp->pps_cu_qp_delta_enabled && qg_on_y &&
        cb_sub_div <= sp->cu_qp_delta_subdiv) {
        st->is_cu_qp_delta_coded = 0;
        st->cu_qg_top_left_x = x0;
        st->cu_qg_top_left_y = y0;
    }
    if (sp->sh_cu_chroma_qp_offset_enabled && qg_on_c &&
        cb_sub_div <= sp->cu_chroma_qp_offset_subdiv) {
        st->is_cu_chroma_qp_offset_coded = 0;
        st->chroma_qp_offset[0] = 0;
        st->chroma_qp_offset[1] = 0;
        st->chroma_qp_offset[2] = 0;
    }
    AllowedSplit a = can_split(p, x0, y0, w, h, mtt_depth, depth_offset,
                               part_idx, last_split, tree_type_curr,
                               mode_type_curr);
    if (split_cu_flag(p, x0, y0, w, h, ch_type, &a)) {
        int split = split_mode(p, x0, y0, w, h, cqt_depth, mtt_depth,
                               ch_type, &a);
        int mode_type = mode_type_decode(p, x0, y0, w, h, split, ch_type,
                                         mode_type_curr);
        int tree_type = mode_type == MODE_TYPE_INTRA ? DUAL_TREE_LUMA
                                                     : tree_type_curr;
        if (split != SPLIT_QT) {
            if (!(x0 & 31) && !(y0 & 31) && mtt_depth <= 1) {
                int32_t *msm = mtt_depth ? p->sp->msm1 : p->sp->msm0;
                msm[(y0 >> 5) * sp->w32 + (x0 >> 5)] = split;
            }
        }
        if (do_split(p, split, x0, y0, w, h, qg_on_y, qg_on_c, cb_sub_div,
                     cqt_depth, mtt_depth, depth_offset, tree_type,
                     mode_type))
            return -1;
        if (mode_type_curr == MODE_TYPE_ALL && mode_type == MODE_TYPE_INTRA)
            return coding_tree(p, x0, y0, w, h, 0, qg_on_c, cb_sub_div,
                               cqt_depth, mtt_depth, 0, 0, split,
                               DUAL_TREE_CHROMA, mode_type);
        return 0;
    }
    return coding_unit(p, x0, y0, w, h, cqt_depth, tree_type_curr,
                       mode_type_curr);
}

/* dual_tree_implicit_qt_split (ctu.py:2342) */
static int dual_tree_implicit_qt(Parser *p, int x0, int y0, int cb_size,
                                 int cqt_depth)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    int cb_subdiv = 2 * cqt_depth;
    if (cb_size > 64) {
        int x1 = x0 + cb_size / 2, y1 = y0 + cb_size / 2;
        if (sp->pps_cu_qp_delta_enabled &&
            cb_subdiv <= sp->cu_qp_delta_subdiv) {
            st->is_cu_qp_delta_coded = 0;
            st->cu_qg_top_left_x = x0;
            st->cu_qg_top_left_y = y0;
        }
        if (sp->sh_cu_chroma_qp_offset_enabled &&
            cb_subdiv <= sp->cu_chroma_qp_offset_subdiv) {
            st->is_cu_chroma_qp_offset_coded = 0;
            st->chroma_qp_offset[0] = 0;
            st->chroma_qp_offset[1] = 0;
            st->chroma_qp_offset[2] = 0;
        }
        const int xs[4] = {x0, x1, x0, x1};
        const int ys[4] = {y0, y0, y1, y1};
        for (int i = 0; i < 4; i++)
            if (xs[i] < sp->width && ys[i] < sp->height)
                if (dual_tree_implicit_qt(p, xs[i], ys[i], cb_size / 2,
                                          cqt_depth + 1))
                    return -1;
        return 0;
    }
    for (int tt = DUAL_TREE_LUMA; tt <= DUAL_TREE_CHROMA; tt++) {
        int qg_on_y = tt == DUAL_TREE_LUMA;
        if (coding_tree(p, x0, y0, cb_size, cb_size, qg_on_y, !qg_on_y,
                        cb_subdiv, cqt_depth, 0, 0, 0, SPLIT_NONE, tt,
                        MODE_TYPE_ALL))
            return -1;
    }
    return 0;
}

/* ---- per-CTU SAO / ALF params (ctu.py:2124-2297) ----------------------- */

enum { SAO_NOT_APPLIED = 0, SAO_BAND = 1, SAO_EDGE = 2 };

static void sao_params_c(Parser *p, int rx, int ry, int rs)
{
    const SliceParams *sp = p->sp;
    Cabac *c = p->c;
    int merge_left = 0, merge_up = 0;
    if (sp->sao_luma_used || sp->sao_chroma_used) {
        if (rx > 0 && p->ctb_left_flag)
            merge_left = cabac_bin_(c, sp->ctx_sao_merge);
        if (ry > 0 && !merge_left && p->ctb_up_flag)
            merge_up = cabac_bin_(c, sp->ctx_sao_merge);
    }
    int merged_src = merge_left ? rs - 1
                   : (merge_up ? rs - sp->ctb_width : -1);
    int nc = sp->chroma_format_idc ? 3 : 1;
    int bd10 = sp->bit_depth < 10 ? sp->bit_depth : 10;
    int scale = 1 << (sp->bit_depth - bd10);
    for (int ci = 0; ci < nc; ci++) {
        int used = ci == 0 ? sp->sao_luma_used : sp->sao_chroma_used;
        if (!used) {
            sp->sao_type_tab[rs * 3 + ci] = SAO_NOT_APPLIED;
            continue;
        }
        if (merged_src >= 0) {
            sp->sao_type_tab[rs * 3 + ci] =
                sp->sao_type_tab[merged_src * 3 + ci];
            sp->sao_band_pos[rs * 3 + ci] =
                sp->sao_band_pos[merged_src * 3 + ci];
            sp->sao_eo_class[rs * 3 + ci] =
                sp->sao_eo_class[merged_src * 3 + ci];
            for (int i = 0; i < 5; i++)
                sp->sao_offset[(rs * 3 + ci) * 5 + i] =
                    sp->sao_offset[(merged_src * 3 + ci) * 5 + i];
            continue;
        }
        if (ci == 2) {
            sp->sao_type_tab[rs * 3 + 2] = sp->sao_type_tab[rs * 3 + 1];
            sp->sao_eo_class[rs * 3 + 2] = sp->sao_eo_class[rs * 3 + 1];
        } else {
            int t;
            if (!cabac_bin_(c, sp->ctx_sao_type))
                t = SAO_NOT_APPLIED;
            else
                t = cabac_bypass_(c) ? SAO_EDGE : SAO_BAND;
            sp->sao_type_tab[rs * 3 + ci] = t;
        }
        int typ = sp->sao_type_tab[rs * 3 + ci];
        if (typ == SAO_NOT_APPLIED)
            continue;
        int length = (1 << (bd10 - 5)) - 1;
        int offset_abs[4], offset_sign[4] = {0, 0, 0, 0};
        for (int i = 0; i < 4; i++) {
            int v = 0;
            while (v < length && cabac_bypass_(c))
                v++;
            offset_abs[i] = v;
        }
        if (typ == SAO_BAND) {
            for (int i = 0; i < 4; i++)
                if (offset_abs[i])
                    offset_sign[i] = cabac_bypass_(c);
            sp->sao_band_pos[rs * 3 + ci] = cabac_bypass_bits_(c, 5);
        } else if (ci != 2) {
            int eo = (cabac_bypass_(c) << 1) | cabac_bypass_(c);
            sp->sao_eo_class[rs * 3 + ci] = eo;
        }
        sp->sao_offset[(rs * 3 + ci) * 5 + 0] = 0;
        for (int i = 0; i < 4; i++) {
            int v = offset_abs[i];
            if (typ == SAO_EDGE) {
                if (i > 1)
                    v = -v;
            } else if (offset_sign[i]) {
                v = -v;
            }
            sp->sao_offset[(rs * 3 + ci) * 5 + i + 1] = v * scale;
        }
    }
}

static void alf_params_c(Parser *p, int rx, int ry, int rs)
{
    const SliceParams *sp = p->sp;
    Cabac *c = p->c;
    (void)rx; (void)ry;
    if (!sp->sps_alf)
        return;
    if (sp->alf_enabled) {
        int nc = sp->chroma_format_idc ? 3 : 1;
        const int en[3] = {sp->alf_enabled, sp->alf_cb_enabled,
                           sp->alf_cr_enabled};
        for (int ci = 0; ci < nc; ci++) {
            if (!en[ci]) {
                sp->alf_ctb_flag[rs * 3 + ci] = 0;
                continue;
            }
            int inc = ci * 3;
            if (p->ctb_left_flag)
                inc += sp->alf_ctb_flag[(rs - 1) * 3 + ci] != 0;
            if (p->ctb_up_flag)
                inc += sp->alf_ctb_flag[(rs - sp->ctb_width) * 3 + ci] != 0;
            int flag = cabac_bin_(c, sp->ctx_alf_ctb_flag + inc);
            sp->alf_ctb_flag[rs * 3 + ci] = flag;
            if (ci == 0 && flag) {
                int use_aps = 0;
                if (sp->num_alf_aps_ids_luma > 0)
                    use_aps = cabac_bin_(c, sp->ctx_alf_use_aps);
                sp->alf_fixed[rs] = !use_aps;
                if (use_aps) {
                    int idx = 0;
                    if (sp->num_alf_aps_ids_luma > 1)
                        idx = cabac_truncated_binary_(
                            c, sp->num_alf_aps_ids_luma - 1);
                    sp->alf_filt_idx[rs] = idx;
                    sp->alf_aps_id[rs * 3 + 0] = sp->alf_aps_id_luma[idx];
                } else {
                    sp->alf_filt_idx[rs] = cabac_truncated_binary_(c, 15);
                }
            } else if (ci && flag) {
                sp->alf_aps_id[rs * 3 + ci] = sp->alf_aps_id_chroma;
                int num_alts = sp->num_chroma_alt_filters;
                int alt = 0;
                while (alt < num_alts - 1 &&
                       cabac_bin_(c, sp->ctx_alf_alt_idx + ci - 1))
                    alt++;
                sp->alf_alt_idx[rs * 2 + ci - 1] = alt;
            }
        }
    }
    if (sp->sps_ccalf) {
        const int cc_en[2] = {sp->alf_cc_cb_enabled, sp->alf_cc_cr_enabled};
        for (int i = 0; i < 2; i++) {
            sp->alf_cc_idc[rs * 2 + i] = 0;
            if (!cc_en[i])
                continue;
            int base = i == 0 ? sp->ctx_alf_cc_cb : sp->ctx_alf_cc_cr;
            int inc = 0;
            if (p->ctb_left_flag)
                inc += sp->alf_cc_idc[(rs - 1) * 2 + i] != 0;
            if (p->ctb_up_flag)
                inc += sp->alf_cc_idc[(rs - sp->ctb_width) * 2 + i] != 0;
            int v = cabac_bin_(c, base + inc);
            if (v) {
                int idc = 1;
                int nf = sp->num_cc_filters[i];
                while (idc < nf && cabac_bypass_(c))
                    idc++;
                v = idc;
            }
            sp->alf_cc_idc[rs * 2 + i] = v;
        }
    }
}

/* ---- exported entry ----------------------------------------------------
 * Parses the coding-tree portion of one CTU (after the Python side has
 * parsed SAO/ALF params).  Mirrors coding_tree_unit (ctu.py:2299) minus the
 * per-CTU bookkeeping that stays in Python (slice_idx write, sao/alf,
 * deblock tabs, terminate bits).  Returns 0 ok, else out->err. */
static int parse_ctu_one(Parser *p, int ctu_idx, int rs, int rx, int ry)
{
    const SliceParams *sp = p->sp;
    SliceState *st = p->st;
    int x_ctb = rx << sp->ctb_log2;
    int y_ctb = ry << sp->ctb_log2;
    if (rx == sp->ctb_to_col_bd[rx]) {
        st->hmvp_len = 0;
        st->is_first_qg = (ry == sp->ctb_to_row_bd[ry]) || !ctu_idx;
    }
    st->chroma_qp_offset[0] = 0;
    st->chroma_qp_offset[1] = 0;
    st->chroma_qp_offset[2] = 0;
    decode_neighbour(p, x_ctb, y_ctb, rx, ry, rs);
    sao_params_c(p, rx, ry, rs);
    alf_params_c(p, rx, ry, rs);
    int ctb_size = 1 << sp->ctb_log2;
    int r;
    if (sp->slice_type == SLICE_I && sp->sps_dual_tree)
        r = dual_tree_implicit_qt(p, x_ctb, y_ctb, ctb_size, 0);
    else
        r = coding_tree(p, x_ctb, y_ctb, ctb_size, ctb_size, 1, 1, 0, 0, 0,
                        0, 0, SPLIT_NONE, SINGLE_TREE, MODE_TYPE_ALL);
    (void)r;
    return p->out->err;
}

int parse_ctu(Cabac *c, const SliceParams *sp, SliceState *st, ParseOut *out,
              int ctu_idx, int rs, int rx, int ry)
{
    Parser p;
    memset(&p, 0, sizeof(p));
    p.c = c;
    p.sp = sp;
    p.st = st;
    p.out = out;
    out->n_cu = out->n_tu = out->n_tb = out->coeff_len = 0;
    out->err = 0;
    return parse_ctu_one(&p, ctu_idx, rs, rx, ry);
}

/* ---- whole-entry-point batch parse --------------------------------------
 * One call parses many CTUs into a shared record arena; Python only
 * re-enters on arena exhaustion (safe at CTU boundaries) or entry-point
 * boundaries.  Replaces the per-CTU Python loop of decoder._parse_slice
 * for native-recon slices. */

typedef struct {
    int32_t ctu_idx, rs, rx, ry;
    int32_t reinit;       /* CABAC context reinit (tile start) */
    int32_t realign;      /* byte-realign the engine first (same-ep tile) */
    int32_t wpp_inherit;  /* load contexts saved from the row above */
    int32_t wpp_save;     /* save contexts after this CTU (first of row) */
    int32_t term;         /* expect a terminate one-bit after this CTU */
    int32_t slice_idx;
} CtuDesc;

/* idx_table[i]: rs, cu_start, n_cu, tu_start, n_tu, tb_start, n_tb,
 * coeff_start */
int parse_ctus(Cabac *c, const SliceParams *sp, SliceState *st,
               ParseOut *out, const CtuDesc *descs, int n,
               int32_t *idx_table, const int32_t *state_tmpl,
               int32_t *wpp_buf, int num_ctx)
{
    Parser p;
    memset(&p, 0, sizeof(p));
    p.c = c;
    p.sp = sp;
    p.st = st;
    p.out = out;
    /* worst-case record budget for one CTU (must hold before parsing) */
    int ctb4 = (1 << sp->ctb_log2) >> 2;
    int cu_need = 2 * ctb4 * ctb4 + 64;
    int tu_need = 4 * cu_need;
    int tb_need = 3 * tu_need;
    int coeff_need = 4 << (2 * sp->ctb_log2);
    for (int i = 0; i < n; i++) {
        const CtuDesc *d = &descs[i];
        if (out->n_cu + cu_need > out->cu_cap ||
            out->n_tu + tu_need > out->tu_cap ||
            out->n_tb + tb_need > out->tb_cap ||
            out->coeff_len + coeff_need > out->coeff_cap)
            return i;   /* arena (nearly) full: caller re-enters */
        if (d->realign) {
            long pos = ((c->pos + 7) >> 3) << 3;
            cabac_init(c, c->data, c->nbits, pos, c->s0, c->s1, c->sh0,
                       c->sh1);
        }
        if (d->reinit) {
            for (int a = 0; a < 4; a++) {
                int32_t *dst = a == 0 ? c->s0 : a == 1 ? c->s1
                             : a == 2 ? c->sh0 : c->sh1;
                memcpy(dst, state_tmpl + a * num_ctx,
                       num_ctx * sizeof(int32_t));
            }
            st->stat_coeff[0] = st->stat_coeff[1] = st->stat_coeff[2] =
                sp->init_stat_coeff;
        }
        if (d->wpp_inherit) {
            for (int a = 0; a < 4; a++) {
                int32_t *dst = a == 0 ? c->s0 : a == 1 ? c->s1
                             : a == 2 ? c->sh0 : c->sh1;
                memcpy(dst, wpp_buf + a * num_ctx,
                       num_ctx * sizeof(int32_t));
            }
            st->stat_coeff[0] = st->stat_coeff[1] = st->stat_coeff[2] =
                sp->init_stat_coeff;
        }
        sp->slice_idx[d->ry * sp->ctb_width + d->rx] = d->slice_idx;
        int32_t *row = idx_table + i * 8;
        row[0] = d->rs;
        row[1] = out->n_cu;
        row[3] = out->n_tu;
        row[5] = out->n_tb;
        row[7] = out->coeff_len;
        if (parse_ctu_one(&p, d->ctu_idx, d->rs, d->rx, d->ry))
            return -1;
        row[2] = out->n_cu - row[1];
        row[4] = out->n_tu - row[3];
        row[6] = out->n_tb - row[5];
        if (d->wpp_save) {
            for (int a = 0; a < 4; a++) {
                const int32_t *src = a == 0 ? c->s0 : a == 1 ? c->s1
                                   : a == 2 ? c->sh0 : c->sh1;
                memcpy(wpp_buf + a * num_ctx, src,
                       num_ctx * sizeof(int32_t));
            }
        }
        if (d->term) {
            if (cabac_terminate_(c) != 1) {
                out->err = 5;
                return -1;
            }
        }
    }
    return n;
}

/* layout guards for the Python ctypes mirrors (CLAUDE.md golden rule) */
int vvcp_sizeof_params(void) { return (int)sizeof(SliceParams); }
int vvcp_sizeof_state(void) { return (int)sizeof(SliceState); }
