/* Native deblocking edge filters (H.266 8.8.3 luma/chroma kernels).
 *
 * Transliterated from ffvvc_tpu/deblock.py (_filter_luma/_filter_chroma and
 * the strong/weak/large kernels), which is the golden model; bit-exactness
 * arbitrated by the oracle-differential suite.
 * Reference analogue: libavcodec/vvc/vvc_filter_template.c
 * :466-787 (loop_filter_luma/chroma).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int32_t *plane;
    long stride;
    int x, y, vertical;
} Edge;

static inline int32_t eget(const Edge *e, int off, int line)
{
    if (e->vertical)
        return e->plane[(e->y + line) * e->stride + e->x + off];
    return e->plane[(e->y + off) * e->stride + e->x + line];
}

static inline void eset(Edge *e, int off, int line, int32_t v)
{
    if (e->vertical)
        e->plane[(e->y + line) * e->stride + e->x + off] = v;
    else
        e->plane[(e->y + off) * e->stride + e->x + line] = v;
}

static inline int iclip(int v, int lo, int hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline int iabs(int v) { return v < 0 ? -v : v; }

/* tC of the table (10-bit) scaled to the bit depth */
static inline int tc_bd(int tc0, int bd)
{
    return bd < 10 ? (tc0 + (1 << (9 - bd))) >> (10 - bd) : tc0 << (bd - 10);
}

#define P(k, line) eget(e, -(k) - 1, line)
#define Q(k, line) eget(e, (k), line)

static void luma_large(Edge *e, int tc, int ml_p, int ml_q)
{
    static const int coef3[3] = {53, 32, 11};
    static const int coef5[5] = {58, 45, 32, 19, 6};
    static const int coef7[7] = {59, 50, 41, 32, 23, 14, 5};
    static const int tcw3[3] = {6, 4, 2};
    static const int tcw5[5] = {6, 5, 4, 3, 2};
    static const int tcw7[7] = {6, 5, 4, 3, 2, 1, 1};
    const int *cp = ml_p == 3 ? coef3 : (ml_p == 5 ? coef5 : coef7);
    const int *cq = ml_q == 3 ? coef3 : (ml_q == 5 ? coef5 : coef7);
    const int *twp = ml_p == 3 ? tcw3 : (ml_p == 5 ? tcw5 : tcw7);
    const int *twq = ml_q == 3 ? tcw3 : (ml_q == 5 ? tcw5 : tcw7);
    for (int d = 0; d < 4; d++) {
        int p[8], q[8];
        for (int k = 0; k < 8; k++) {
            p[k] = P(k, d);
            q[k] = Q(k, d);
        }
        int m;
        if (ml_p == 5 && ml_q == 5)
            m = (p[4] + p[3] + 2 * (p[2] + p[1] + p[0] + q[0] + q[1] + q[2])
                 + q[3] + q[4] + 8) >> 4;
        else if (ml_p == ml_q)
            m = (p[6] + p[5] + p[4] + p[3] + p[2] + p[1] +
                 2 * (p[0] + q[0]) + q[1] + q[2] + q[3] + q[4] + q[5] +
                 q[6] + 8) >> 4;
        else if (ml_p + ml_q == 12)
            m = (p[5] + p[4] + p[3] + p[2] +
                 2 * (p[1] + p[0] + q[0] + q[1]) + q[2] + q[3] + q[4] +
                 q[5] + 8) >> 4;
        else if (ml_p + ml_q == 8)
            m = (p[3] + p[2] + p[1] + p[0] + q[0] + q[1] + q[2] + q[3]
                 + 4) >> 3;
        else if (ml_q == 7)
            m = (2 * (p[2] + p[1] + p[0] + q[0]) + p[0] + p[1] + q[1] +
                 q[2] + q[3] + q[4] + q[5] + q[6] + 8) >> 4;
        else
            m = (p[6] + p[5] + p[4] + p[3] + p[2] + p[1] +
                 2 * (q[2] + q[1] + q[0] + p[0]) + q[0] + q[1] + 8) >> 4;
        int refp = (p[ml_p] + p[ml_p - 1] + 1) >> 1;
        int refq = (q[ml_q] + q[ml_q - 1] + 1) >> 1;
        for (int k = 0; k < ml_p; k++) {
            int lim = tc * twp[k] >> 1;
            int v = p[k] + iclip(((m * cp[k] + refp * (64 - cp[k]) + 32)
                                  >> 6) - p[k], -lim, lim);
            eset(e, -k - 1, d, v);
        }
        for (int k = 0; k < ml_q; k++) {
            int lim = tc * twq[k] >> 1;
            int v = q[k] + iclip(((m * cq[k] + refq * (64 - cq[k]) + 32)
                                  >> 6) - q[k], -lim, lim);
            eset(e, k, d, v);
        }
    }
}

static void luma_strong(Edge *e, int tc)
{
    int tc2 = tc << 1, tc3 = tc * 3;
    for (int d = 0; d < 4; d++) {
        int p3 = P(3, d), p2 = P(2, d), p1 = P(1, d), p0 = P(0, d);
        int q0 = Q(0, d), q1 = Q(1, d), q2 = Q(2, d), q3 = Q(3, d);
        eset(e, -1, d, p0 + iclip(((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0, -tc3, tc3));
        eset(e, -2, d, p1 + iclip(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -tc2, tc2));
        eset(e, -3, d, p2 + iclip(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2, -tc, tc));
        eset(e, 0, d, q0 + iclip(((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0, -tc3, tc3));
        eset(e, 1, d, q1 + iclip(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, -tc2, tc2));
        eset(e, 2, d, q2 + iclip(((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2, -tc, tc));
    }
}

static void luma_weak(Edge *e, int tc, int nd_p, int nd_q, int mx)
{
    int tc_2 = tc >> 1;
    for (int d = 0; d < 4; d++) {
        int p2 = P(2, d), p1 = P(1, d), p0 = P(0, d);
        int q0 = Q(0, d), q1 = Q(1, d), q2 = Q(2, d);
        int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
        if (iabs(delta0) < 10 * tc) {
            delta0 = iclip(delta0, -tc, tc);
            eset(e, -1, d, iclip(p0 + delta0, 0, mx));
            eset(e, 0, d, iclip(q0 - delta0, 0, mx));
            if (nd_p > 1) {
                int dp1 = iclip((((p2 + p0 + 1) >> 1) - p1 + delta0) >> 1,
                                -tc_2, tc_2);
                eset(e, -2, d, iclip(p1 + dp1, 0, mx));
            }
            if (nd_q > 1) {
                int dq1 = iclip((((q2 + q0 + 1) >> 1) - q1 - delta0) >> 1,
                                -tc_2, tc_2);
                eset(e, 1, d, iclip(q1 + dq1, 0, mx));
            }
        }
    }
}

void deblock_filter_luma(int32_t *plane, long stride, int px, int py,
                         int vertical, const int32_t *beta_a,
                         const int32_t *tc_a, const int32_t *mlp_a,
                         const int32_t *mlq_a, int hor_ctu_edge, int bd,
                         int mx)
{
    for (int i = 0; i < 2; i++) {
        int tc = tc_bd(tc_a[i], bd);
        if (!tc)
            continue;
        Edge ee;
        ee.plane = plane;
        ee.stride = stride;
        ee.vertical = vertical;
        if (vertical) { ee.x = px; ee.y = py + i * 4; }
        else { ee.x = px + i * 4; ee.y = py; }
        Edge *e = &ee;
        int dp0 = iabs(P(2, 0) - 2 * P(1, 0) + P(0, 0));
        int dq0 = iabs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0));
        int dp3 = iabs(P(2, 3) - 2 * P(1, 3) + P(0, 3));
        int dq3 = iabs(Q(2, 3) - 2 * Q(1, 3) + Q(0, 3));
        int d0 = dp0 + dq0;
        int d3 = dp3 + dq3;
        int tc25 = (tc * 5 + 1) >> 1;
        int max_len_p = mlp_a[i];
        int max_len_q = mlq_a[i];
        int large_p = max_len_p > 3 && !hor_ctu_edge;
        int large_q = max_len_q > 3;
        int beta = beta_a[i] << (bd - 8);
        int beta_3 = beta >> 3;
        int beta_2 = beta >> 2;
        if (large_p || large_q) {
            int dp0l = large_p ? ((dp0 + iabs(P(5, 0) - 2 * P(4, 0) + P(3, 0)) + 1) >> 1) : dp0;
            int dq0l = large_q ? ((dq0 + iabs(Q(5, 0) - 2 * Q(4, 0) + Q(3, 0)) + 1) >> 1) : dq0;
            int dp3l = large_p ? ((dp3 + iabs(P(5, 3) - 2 * P(4, 3) + P(3, 3)) + 1) >> 1) : dp3;
            int dq3l = large_q ? ((dq3 + iabs(Q(5, 3) - 2 * Q(4, 3) + Q(3, 3)) + 1) >> 1) : dq3;
            int d0l = dp0l + dq0l;
            int d3l = dp3l + dq3l;
            int beta53 = beta * 3 >> 5;
            int beta_4 = beta >> 4;
            int ml_p = large_p ? max_len_p : 3;
            int ml_q = large_q ? max_len_q : 3;
            if (d0l + d3l < beta) {
                int sp0l = iabs(P(3, 0) - P(0, 0)) +
                    (ml_p == 7 ? iabs(P(7, 0) - P(6, 0) - P(5, 0) + P(4, 0)) : 0);
                int sq0l = iabs(Q(0, 0) - Q(3, 0)) +
                    (ml_q == 7 ? iabs(Q(4, 0) - Q(5, 0) - Q(6, 0) + Q(7, 0)) : 0);
                int sp3l = iabs(P(3, 3) - P(0, 3)) +
                    (ml_p == 7 ? iabs(P(7, 3) - P(6, 3) - P(5, 3) + P(4, 3)) : 0);
                int sq3l = iabs(Q(0, 3) - Q(3, 3)) +
                    (ml_q == 7 ? iabs(Q(4, 3) - Q(5, 3) - Q(6, 3) + Q(7, 3)) : 0);
                int sp0 = large_p ? ((sp0l + iabs(P(3, 0) - P(ml_p, 0)) + 1) >> 1) : sp0l;
                int sp3 = large_p ? ((sp3l + iabs(P(3, 3) - P(ml_p, 3)) + 1) >> 1) : sp3l;
                int sq0 = large_q ? ((sq0l + iabs(Q(3, 0) - Q(ml_q, 0)) + 1) >> 1) : sq0l;
                int sq3 = large_q ? ((sq3l + iabs(Q(3, 3) - Q(ml_q, 3)) + 1) >> 1) : sq3l;
                if (sp0 + sq0 < beta53 && iabs(P(0, 0) - Q(0, 0)) < tc25 &&
                    sp3 + sq3 < beta53 && iabs(P(0, 3) - Q(0, 3)) < tc25 &&
                    (d0l << 1) < beta_4 && (d3l << 1) < beta_4) {
                    luma_large(e, tc, ml_p, ml_q);
                    continue;
                }
            }
        }
        if (d0 + d3 < beta) {
            if (max_len_p > 2 && max_len_q > 2 &&
                iabs(P(3, 0) - P(0, 0)) + iabs(Q(3, 0) - Q(0, 0)) < beta_3 &&
                iabs(P(0, 0) - Q(0, 0)) < tc25 &&
                iabs(P(3, 3) - P(0, 3)) + iabs(Q(3, 3) - Q(0, 3)) < beta_3 &&
                iabs(P(0, 3) - Q(0, 3)) < tc25 &&
                (d0 << 1) < beta_2 && (d3 << 1) < beta_2) {
                luma_strong(e, tc);
            } else {
                int nd_p = 1, nd_q = 1;
                if (max_len_p > 1 && max_len_q > 1) {
                    if (dp0 + dp3 < ((beta + (beta >> 1)) >> 3))
                        nd_p = 2;
                    if (dq0 + dq3 < ((beta + (beta >> 1)) >> 3))
                        nd_q = 2;
                }
                luma_weak(e, tc, nd_p, nd_q, mx);
            }
        }
    }
}

static void chroma_strong(Edge *e, int size, int tc)
{
    for (int d = 0; d < size; d++) {
        int p3 = P(3, d), p2 = P(2, d), p1 = P(1, d), p0 = P(0, d);
        int q0 = Q(0, d), q1 = Q(1, d), q2 = Q(2, d), q3 = Q(3, d);
        eset(e, -1, d, iclip((p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0 - tc, p0 + tc));
        eset(e, -2, d, iclip((2 * p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3, p1 - tc, p1 + tc));
        eset(e, -3, d, iclip((3 * p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - tc, p2 + tc));
        eset(e, 0, d, iclip((p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0 - tc, q0 + tc));
        eset(e, 1, d, iclip((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3, q1 - tc, q1 + tc));
        eset(e, 2, d, iclip((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3, q2 - tc, q2 + tc));
    }
}

static void chroma_strong_one_side(Edge *e, int size, int tc)
{
    for (int d = 0; d < size; d++) {
        int p1 = P(1, d), p0 = P(0, d);
        int q0 = Q(0, d), q1 = Q(1, d), q2 = Q(2, d), q3 = Q(3, d);
        eset(e, -1, d, iclip((3 * p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3, p0 - tc, p0 + tc));
        eset(e, 0, d, iclip((2 * p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3, q0 - tc, q0 + tc));
        eset(e, 1, d, iclip((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3, q1 - tc, q1 + tc));
        eset(e, 2, d, iclip((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3, q2 - tc, q2 + tc));
    }
}

static void chroma_weak(Edge *e, int size, int tc, int mx)
{
    for (int d = 0; d < size; d++) {
        int p1 = P(1, d), p0 = P(0, d);
        int q0 = Q(0, d), q1 = Q(1, d);
        int delta0 = iclip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
        eset(e, -1, d, iclip(p0 + delta0, 0, mx));
        eset(e, 0, d, iclip(q0 - delta0, 0, mx));
    }
}

void deblock_filter_chroma(int32_t *plane, long stride, int px, int py,
                           int vertical, const int32_t *beta_a,
                           const int32_t *tc_a, const int32_t *mlp_a,
                           const int32_t *mlq_a, int shift, int bd, int mx)
{
    int size = shift ? 2 : 4;
    int end = 8 / size;
    for (int i = 0; i < end; i++) {
        int tc = tc_bd(tc_a[i], bd);
        if (!tc)
            continue;
        Edge ee;
        ee.plane = plane;
        ee.stride = stride;
        ee.vertical = vertical;
        if (vertical) { ee.x = px; ee.y = py + i * size; }
        else { ee.x = px + i * size; ee.y = py; }
        Edge *e = &ee;
        int max_len_p = mlp_a[i];
        int max_len_q = mlq_a[i];
        if (!max_len_p || !max_len_q)
            continue;
        int beta = beta_a[i] << (bd - 8);
        int beta_3 = beta >> 3;
        int beta_2 = beta >> 2;
        int tc25 = (tc * 5 + 1) >> 1;
        if (max_len_q == 3) {
            int nline = shift ? 1 : 3;
            int p1n = P(1, nline);
            int p2n = max_len_p == 1 ? P(1, nline) : P(2, nline);
            int p0n = P(0, nline);
            int q0n = Q(0, nline), q1n = Q(1, nline), q2n = Q(2, nline);
            int p3 = max_len_p == 1 ? P(1, 0) : P(3, 0);
            int p2 = max_len_p == 1 ? P(1, 0) : P(2, 0);
            int p1 = P(1, 0), p0 = P(0, 0);
            int dp0 = iabs(p2 - 2 * p1 + p0);
            int dq0 = iabs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0));
            int dp1 = iabs(p2n - 2 * p1n + p0n);
            int dq1 = iabs(q2n - 2 * q1n + q0n);
            int d0 = dp0 + dq0;
            int d1 = dp1 + dq1;
            if (d0 + d1 < beta) {
                int p3n = max_len_p == 1 ? p1n : P(3, nline);
                int q3n = Q(3, nline);
                int dsam0 = (d0 << 1) < beta_2 &&
                    (iabs(p3 - p0) + iabs(Q(0, 0) - Q(3, 0)) < beta_3) &&
                    iabs(p0 - Q(0, 0)) < tc25;
                int dsam1 = (d1 << 1) < beta_2 &&
                    (iabs(p3n - p0n) + iabs(q0n - q3n) < beta_3) &&
                    iabs(p0n - q0n) < tc25;
                if (!dsam0 || !dsam1)
                    max_len_p = max_len_q = 1;
            } else {
                max_len_p = max_len_q = 1;
            }
        }
        if (max_len_p == 3 && max_len_q == 3)
            chroma_strong(e, size, tc);
        else if (max_len_q == 3)
            chroma_strong_one_side(e, size, tc);
        else
            chroma_weak(e, size, tc, mx);
    }
}

/* ---- per-CTB edge driver (golden model: deblock.py deblock_ctb /
 * _filter_edge / _edge_qp / _ladf_qp_offset / _max_filter_length).
 * Reference analogue: libavcodec/vvc/vvc_filter.c:861-1000. */

static const int TC_TABLE_C[66] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 3, 4, 4, 4, 4, 5, 5, 5, 5, 7, 7, 8, 9, 10,
    10, 11, 13, 14, 15, 17, 19, 21, 24, 25, 29, 33, 36, 41, 45, 51,
    57, 64, 71, 80, 89, 100, 112, 125, 141, 157, 177, 198, 222, 250, 280, 314,
    352, 395};
static const int BETA_TABLE_C[64] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88};

static int ladf_qp_offset_c(const int32_t *luma, long lstride, int x, int y,
                            int vertical, int n_ladf, int ladf_lowest,
                            const int32_t *ladf_offsets,
                            const int32_t *ladf_bounds)
{
    int level;
    if (vertical)
        level = (luma[(long)y * lstride + x - 1] +
                 luma[(long)(y + 3) * lstride + x - 1] +
                 luma[(long)y * lstride + x] +
                 luma[(long)(y + 3) * lstride + x]) >> 2;
    else
        level = (luma[(long)(y - 1) * lstride + x] +
                 luma[(long)(y - 1) * lstride + x + 3] +
                 luma[(long)y * lstride + x] +
                 luma[(long)y * lstride + x + 3]) >> 2;
    int qp_offset = ladf_lowest;
    for (int i = 0; i < n_ladf - 1; i++) {
        if (level <= ladf_bounds[i + 1])
            break;
        qp_offset = ladf_offsets[i];
    }
    return qp_offset;
}

/* The tables one CTB's edges of one plane in one direction read. */
typedef struct {
    int c_idx, vertical, grid, step, n, hs, vs, ctb_size, w4, bd;
    const int32_t *bs_tab, *mlp_tab, *mlq_tab, *tb_size_tab, *qp_map;
    int beta_off, tc_off, qp_bd_offset;
    /* LADF: the luma samples its qp offset reads (luma edges only) */
    const int32_t *luma;
    long lstride;
    int n_ladf, ladf_lowest;
    const int32_t *ladf_offsets, *ladf_bounds;
} EdgeTabs;

/* bS-derived beta, tC (table values, before the bit-depth scaling) and
 * maximum filter lengths of the n edge units of the edge at (x, y), all
 * 0 where bS is 0; returns 0 when every bS is 0.  The one derivation of
 * the filters and the segment emitter (golden model: deblock.py
 * _filter_edge, _edge_qp, _max_filter_length). */
static int edge_params(const EdgeTabs *t, int x, int y, int x_end, int y_end,
                       int hor_ctu_edge, int32_t beta[4], int32_t tc[4],
                       int32_t mlp[4], int32_t mlq[4])
{
    int vertical = t->vertical, w4 = t->w4;
    int dx = vertical ? 1 : 0, dy = vertical ? 0 : 1;
    int any = 0;
    for (int i = 0; i < t->n; i++) {
        int d = i << 2;
        int pos_x = vertical ? x : x + d;
        int pos_y = vertical ? y + d : y;
        int in_range = vertical ? pos_y < y_end : pos_x < x_end;
        int bs = in_range ? t->bs_tab[(pos_y >> 2) * w4 + (pos_x >> 2)] : 0;
        beta[i] = tc[i] = mlp[i] = mlq[i] = 0;
        if (!bs)
            continue;
        int qp;
        int qp_p = t->qp_map[((pos_y - dy) >> 2) * w4 + ((pos_x - dx) >> 2)];
        int qp_q = t->qp_map[(pos_y >> 2) * w4 + (pos_x >> 2)];
        if (t->c_idx == 0) {
            qp = (qp_p + qp_q + 1) >> 1;
            if (t->n_ladf)
                qp += ladf_qp_offset_c(t->luma, t->lstride, pos_x, pos_y,
                                       vertical, t->n_ladf, t->ladf_lowest,
                                       t->ladf_offsets, t->ladf_bounds);
        } else {
            qp = (qp_p + qp_q - 2 * t->qp_bd_offset + 1) >> 1;
        }
        beta[i] = BETA_TABLE_C[iclip(qp + t->beta_off, 0, 63)];
        tc[i] = TC_TABLE_C[iclip(qp + 2 * (bs - 1) + (t->tc_off & -2),
                                 0, 65)];
        if (t->c_idx == 0) {
            mlp[i] = t->mlp_tab[(pos_y >> 2) * w4 + (pos_x >> 2)];
            mlq[i] = t->mlq_tab[(pos_y >> 2) * w4 + (pos_x >> 2)];
        } else {
            int ppx = vertical ? pos_x - 1 : pos_x;
            int ppy = vertical ? pos_y : pos_y - 1;
            int size_p = t->tb_size_tab[(ppy >> 2) * w4 + (ppx >> 2)];
            int size_q = t->tb_size_tab[(pos_y >> 2) * w4 + (pos_x >> 2)];
            if (size_p >= 8 && size_q >= 8) {
                mlp[i] = hor_ctu_edge ? 1 : 3;
                mlq[i] = 3;
            } else {
                mlp[i] = mlq[i] = bs == 2;
            }
        }
        any = 1;
    }
    return any;
}

/* What is done with an edge that has a nonzero bS: filtered, or emitted
 * as segments; (px, py) in the plane's samples. */
typedef void (*EdgeVisit)(void *arg, const EdgeTabs *t, int px, int py,
                          int hor_ctu_edge, const int32_t *beta,
                          const int32_t *tc, const int32_t *mlp,
                          const int32_t *mlq);

/* Every edge of one CTB [x0, x_end) x [y0, y_end) (luma samples) in the
 * golden model's order (deblock.py deblock_ctb). */
static void walk_ctb_edges(const EdgeTabs *t, int x0, int y0, int x_end,
                           int y_end, EdgeVisit visit, void *arg)
{
    int vertical = t->vertical;
    int ys = vertical ? t->step : t->grid;
    int xs = vertical ? t->grid : t->step;
    for (int y = y0; y < y_end; y += ys) {
        int hor_ctu_edge = !vertical && (y % t->ctb_size) == 0;
        if (!vertical && y == 0)
            continue;
        for (int x = vertical && !x0 ? t->grid : x0; x < x_end; x += xs) {
            int32_t beta[4], tc[4], mlp[4], mlq[4];
            if (edge_params(t, x, y, x_end, y_end, hor_ctu_edge, beta, tc,
                            mlp, mlq))
                visit(arg, t, x >> t->hs, y >> t->vs, hor_ctu_edge, beta,
                      tc, mlp, mlq);
        }
    }
}

typedef struct {
    int32_t *plane;
    long stride;
    int mx;
} FilterArg;

static void filter_visit(void *arg, const EdgeTabs *t, int px, int py,
                         int hor_ctu_edge, const int32_t *beta,
                         const int32_t *tc, const int32_t *mlp,
                         const int32_t *mlq)
{
    const FilterArg *a = arg;
    if (t->c_idx == 0)
        deblock_filter_luma(a->plane, a->stride, px, py, t->vertical,
                            beta, tc, mlp, mlq, hor_ctu_edge, t->bd, a->mx);
    else
        deblock_filter_chroma(a->plane, a->stride, px, py, t->vertical,
                              beta, tc, mlp, mlq,
                              t->vertical ? t->vs : t->hs, t->bd, a->mx);
}

void deblock_ctb_edges(
    int32_t *plane, long stride, int c_idx, int vertical,
    int x0, int y0, int x_end, int y_end,
    int grid, int step, int n, int hs, int vs, int ctb_size,
    const int32_t *bs_tab, const int32_t *mlp_tab, const int32_t *mlq_tab,
    const int32_t *tb_size_tab, const int32_t *qp_map, int w4,
    int beta_off, int tc_off, int qp_bd_offset, int bd, int mx,
    int n_ladf, int ladf_lowest, const int32_t *ladf_offsets,
    const int32_t *ladf_bounds)
{
    EdgeTabs t = {
        .c_idx = c_idx, .vertical = vertical, .grid = grid, .step = step,
        .n = n, .hs = hs, .vs = vs, .ctb_size = ctb_size, .w4 = w4,
        .bd = bd, .bs_tab = bs_tab, .mlp_tab = mlp_tab, .mlq_tab = mlq_tab,
        .tb_size_tab = tb_size_tab, .qp_map = qp_map, .beta_off = beta_off,
        .tc_off = tc_off, .qp_bd_offset = qp_bd_offset, .luma = plane,
        .lstride = stride, .n_ladf = n_ladf, .ladf_lowest = ladf_lowest,
        .ladf_offsets = ladf_offsets, .ladf_bounds = ladf_bounds};
    FilterArg a = {plane, stride, mx};
    walk_ctb_edges(&t, x0, y0, x_end, y_end, filter_visit, &a);
}

/* ---- boundary-strength computation (golden model: deblock.py _compute_bs
 * and helpers).  Reference: libavcodec/vvc/vvc_filter.c
 * :308-620 (boundary_strength, vvc_deblock_bs_luma/chroma, subblock bs,
 * derive_max_filter_length_luma). */

typedef struct {
    const int32_t *tb_pos_x0, *tb_pos_y0, *tb_w0, *tb_h0;
    const int32_t *tb_pos_x1, *tb_pos_y1, *tb_w1, *tb_h1;
    const uint8_t *mvf_pf;
    const int8_t  *mvf_ciip;
    const int32_t *mvf_mv;     /* [2][h4][w4][2] */
    const int8_t  *mvf_ref;    /* [2][h4][w4] */
    const int32_t *tu_coded0, *tu_coded1, *tu_coded2, *tu_joint;
    const int32_t *pcmf0, *pcmf1;
    const int32_t *cb_pos_x, *cb_pos_y, *cb_w, *cb_h;
    const int32_t *msf, *iaf;
    const int32_t *slice_idx;
    const int32_t *rpl_poc;    /* [n_slices][2][max_refs] */
    int32_t *vbs0, *vbs1, *vbs2, *hbs0, *hbs1, *hbs2;
    int32_t *vp, *vq, *hp, *hq;
    int32_t w4, h4, max_refs;
    int32_t ctb_size, ctb_log2, ctb_width;
    int32_t pic_w, pic_h;
    int32_t lf_slices, lf_tiles;
    int32_t hs1, vs1, chroma;
} BsCtx;

static inline long idx4(const BsCtx *c, int x, int y)
{
    return (long)(y >> 2) * c->w4 + (x >> 2);
}

static int is_intra_bs(const BsCtx *c, int x, int y)
{
    long i = idx4(c, x, y);
    return c->mvf_pf[i] == 0 || c->mvf_ciip[i];
}

static int rpl_poc_at(const BsCtx *c, int x, int y, int lst, int ref)
{
    int si = c->slice_idx[(y >> c->ctb_log2) * c->ctb_width +
                          (x >> c->ctb_log2)];
    return c->rpl_poc[((long)si * 2 + lst) * c->max_refs + ref];
}

static inline int mv_far(const int *a, const int *b)
{
    return iabs(a[0] - b[0]) >= 8 || iabs(a[1] - b[1]) >= 8;
}

static int boundary_strength_bs(const BsCtx *c, int qx, int qy,
                                int px, int py)
{
    long qi = idx4(c, qx, qy), pi = idx4(c, px, py);
    long plane2 = (long)c->h4 * c->w4;
    int cpf = c->mvf_pf[qi], npf = c->mvf_pf[pi];
    int cmv[2][2], nmv[2][2];
    for (int l = 0; l < 2; l++) {
        cmv[l][0] = c->mvf_mv[(l * plane2 + qi) * 2];
        cmv[l][1] = c->mvf_mv[(l * plane2 + qi) * 2 + 1];
        nmv[l][0] = c->mvf_mv[(l * plane2 + pi) * 2];
        nmv[l][1] = c->mvf_mv[(l * plane2 + pi) * 2 + 1];
    }
    if (cpf == 3 && npf == 3) {
        int c0 = rpl_poc_at(c, qx, qy, 0, c->mvf_ref[qi]);
        int c1 = rpl_poc_at(c, qx, qy, 1, c->mvf_ref[plane2 + qi]);
        int n0 = rpl_poc_at(c, px, py, 0, c->mvf_ref[pi]);
        int n1 = rpl_poc_at(c, px, py, 1, c->mvf_ref[plane2 + pi]);
        if (c0 == n0 && c0 == c1 && n0 == n1) {
            if ((mv_far(nmv[0], cmv[0]) || mv_far(nmv[1], cmv[1])) &&
                (mv_far(nmv[1], cmv[0]) || mv_far(nmv[0], cmv[1])))
                return 1;
            return 0;
        }
        if (n0 == c0 && n1 == c1)
            return (mv_far(nmv[0], cmv[0]) || mv_far(nmv[1], cmv[1])) ? 1 : 0;
        if (n1 == c0 && n0 == c1)
            return (mv_far(nmv[1], cmv[0]) || mv_far(nmv[0], cmv[1])) ? 1 : 0;
        return 1;
    }
    if (cpf != 3 && npf != 3) {
        const int *a, *b;
        int ref_a, ref_b;
        if (cpf & 1) { a = cmv[0]; ref_a = rpl_poc_at(c, qx, qy, 0, c->mvf_ref[qi]); }
        else         { a = cmv[1]; ref_a = rpl_poc_at(c, qx, qy, 1, c->mvf_ref[plane2 + qi]); }
        if (npf & 1) { b = nmv[0]; ref_b = rpl_poc_at(c, px, py, 0, c->mvf_ref[pi]); }
        else         { b = nmv[1]; ref_b = rpl_poc_at(c, px, py, 1, c->mvf_ref[plane2 + pi]); }
        if (ref_a == ref_b)
            return mv_far(a, b) ? 1 : 0;
        return 1;
    }
    return 1;
}

static int bs_inter_c(const BsCtx *c, int x, int y, int vertical)
{
    int dx = vertical ? 1 : 0, dy = vertical ? 0 : 1;
    long q = idx4(c, x, y);
    int cb_x = c->cb_pos_x[q], cb_y = c->cb_pos_y[q];
    int has_sb = 0;
    if (c->msf[q] || c->iaf[q]) {
        int size = vertical ? c->cb_w[q] : c->cb_h[q];
        has_sb = size > 8;
    }
    int off = vertical ? cb_x - x : cb_y - y;
    if (off && ((off % 8) || !has_sb))
        return 0;
    return boundary_strength_bs(c, x, y, x - dx, y - dy);
}

static void max_len_luma_c(const BsCtx *c, int qx, int qy, int vertical,
                           int has_sb, int *mlp, int *mlq)
{
    int px = vertical ? qx - 1 : qx;
    int py = vertical ? qy : qy - 1;
    const int32_t *tb_size = vertical ? c->tb_w0 : c->tb_h0;
    int size_p = tb_size[idx4(c, px, py)];
    int size_q = tb_size[idx4(c, qx, qy)];
    if (size_p <= 4 || size_q <= 4) {
        *mlp = *mlq = 1;
        return;
    }
    int p = size_p >= 32 ? 7 : 3;
    int q = size_q >= 32 ? 7 : 3;
    if (has_sb && q > 5)
        q = 5;
    long pi = idx4(c, px, py);
    if ((c->msf[pi] || c->iaf[pi]) && p > 5)
        p = 5;
    *mlp = p;
    *mlq = q;
}

static void subblock_bs_c(const BsCtx *c, int cb_x, int cb_y, int x0, int y0,
                          int width, int height, int vertical)
{
    if (vertical) {
        int start = 8 - ((x0 - cb_x) % 8);
        for (int j = 0; j < height; j += 4) {
            int y = y0 + j;
            for (int i = start; i < width; i += 8) {
                int x = x0 + i;
                int bs = boundary_strength_bs(c, x, y, x - 1, y);
                long q = idx4(c, x, y);
                c->vbs0[q] = bs;
                int ml = (i == 4 || i == width - 4) ? 1 :
                         ((i == 8 || i == width - 8) ? 2 : 3);
                c->vp[q] = ml;
                c->vq[q] = ml;
            }
        }
    } else {
        int start = 8 - ((y0 - cb_y) % 8);
        for (int j = start; j < height; j += 8) {
            int y = y0 + j;
            for (int i = 0; i < width; i += 4) {
                int x = x0 + i;
                int bs = boundary_strength_bs(c, x, y, x, y - 1);
                long q = idx4(c, x, y);
                c->hbs0[q] = bs;
                int ml = (j == 4 || j == height - 4) ? 1 :
                         ((j == 8 || j == height - 8) ? 2 : 3);
                c->hp[q] = ml;
                c->hq[q] = ml;
            }
        }
    }
}

static void bs_luma_c(const BsCtx *c, int x0, int y0, int width, int height,
                      int vertical, int left_tile, int left_slice,
                      int up_tile, int up_slice)
{
    int ctb_mask = c->ctb_size - 1;
    long q4 = idx4(c, x0, y0);
    int cb_x = c->cb_pos_x[q4], cb_y = c->cb_pos_y[q4];
    int has_sb = 0;
    if (c->mvf_pf[q4] != 0 && (c->msf[q4] || c->iaf[q4])) {
        int size = vertical ? c->cb_w[q4] : c->cb_h[q4];
        has_sb = size > 8;
    }
    if (vertical) {
        int boundary = x0 > 0 && !(x0 & 3);
        if (boundary &&
            ((!c->lf_slices && left_slice && (x0 & ctb_mask) == 0) ||
             (!c->lf_tiles && left_tile && (x0 & ctb_mask) == 0)))
            boundary = 0;
        if (!boundary) {
            if (has_sb)
                subblock_bs_c(c, cb_x, cb_y, x0, y0, width, height, 1);
            return;
        }
        for (int i = 0; i < height; i += 4) {
            int y = y0 + i;
            int p_intra = is_intra_bs(c, x0 - 1, y);
            int q_intra = is_intra_bs(c, x0, y);
            long pi = idx4(c, x0 - 1, y), qi = idx4(c, x0, y);
            int p_cbf = c->tu_coded0[pi], q_cbf = c->tu_coded0[qi];
            int pcmf = c->pcmf0[pi] && c->pcmf0[qi];
            int bs;
            if (pcmf) bs = 0;
            else if (p_intra || q_intra) bs = 2;
            else if (p_cbf || q_cbf) bs = 1;
            else bs = bs_inter_c(c, x0, y, 1);
            c->vbs0[qi] = bs;
            int mlp, mlq;
            max_len_luma_c(c, x0, y, 1, has_sb, &mlp, &mlq);
            c->vp[qi] = mlp;
            c->vq[qi] = mlq;
        }
        if (has_sb)
            subblock_bs_c(c, cb_x, cb_y, x0, y0, width, height, 1);
    } else {
        int boundary = y0 > 0 && !(y0 & 3);
        if (boundary &&
            ((!c->lf_slices && up_slice && (y0 & ctb_mask) == 0) ||
             (!c->lf_tiles && up_tile && (y0 & ctb_mask) == 0)))
            boundary = 0;
        if (!boundary) {
            if (has_sb)
                subblock_bs_c(c, cb_x, cb_y, x0, y0, width, height, 0);
            return;
        }
        for (int i = 0; i < width; i += 4) {
            int x = x0 + i;
            int p_intra = is_intra_bs(c, x, y0 - 1);
            int q_intra = is_intra_bs(c, x, y0);
            long pi = idx4(c, x, y0 - 1), qi = idx4(c, x, y0);
            int p_cbf = c->tu_coded0[pi], q_cbf = c->tu_coded0[qi];
            int pcmf = c->pcmf0[pi] && c->pcmf0[qi];
            int bs;
            if (pcmf) bs = 0;
            else if (p_intra || q_intra) bs = 2;
            else if (p_cbf || q_cbf) bs = 1;
            else bs = bs_inter_c(c, x, y0, 0);
            c->hbs0[qi] = bs;
            int mlp, mlq;
            max_len_luma_c(c, x, y0, 0, has_sb, &mlp, &mlq);
            c->hp[qi] = mlp;
            c->hq[qi] = mlq;
        }
        if (has_sb)
            subblock_bs_c(c, cb_x, cb_y, x0, y0, width, height, 0);
    }
}

static void bs_chroma_one_c(const BsCtx *c, int px, int py, int qx, int qy,
                            int ex, int ey, int vertical)
{
    long p4 = idx4(c, px, py), q4 = idx4(c, qx, qy);
    int pcmf = c->pcmf1[p4] && c->pcmf1[q4];
    int p_intra = is_intra_bs(c, px, py);
    int q_intra = is_intra_bs(c, qx, qy);
    long e4 = idx4(c, ex, ey);
    for (int ci = 1; ci <= 2; ci++) {
        const int32_t *coded = ci == 1 ? c->tu_coded1 : c->tu_coded2;
        int cbf = coded[p4] | coded[q4] | c->tu_joint[p4] | c->tu_joint[q4];
        int bs;
        if (pcmf) bs = 0;
        else if (p_intra || q_intra) bs = 2;
        else if (cbf) bs = 1;
        else bs = 0;
        if (vertical)
            (ci == 1 ? c->vbs1 : c->vbs2)[e4] = bs;
        else
            (ci == 1 ? c->hbs1 : c->hbs2)[e4] = bs;
    }
}

static void bs_chroma_c(const BsCtx *c, int x0, int y0, int width, int height,
                        int vertical, int left_tile, int left_slice,
                        int up_tile, int up_slice)
{
    int ctb_mask = c->ctb_size - 1;
    if (vertical) {
        int boundary = x0 > 0 && !(x0 & ((8 << c->hs1) - 1));
        if (boundary &&
            ((!c->lf_slices && left_slice && (x0 & ctb_mask) == 0) ||
             (!c->lf_tiles && left_tile && (x0 & ctb_mask) == 0)))
            boundary = 0;
        if (!boundary)
            return;
        for (int i = 0; i < height; i += 2)
            bs_chroma_one_c(c, x0 - 1, y0 + i, x0, y0 + i, x0, y0 + i, 1);
    } else {
        int boundary = y0 > 0 && !(y0 & ((8 << c->vs1) - 1));
        if (boundary &&
            ((!c->lf_slices && up_slice && (y0 & ctb_mask) == 0) ||
             (!c->lf_tiles && up_tile && (y0 & ctb_mask) == 0)))
            boundary = 0;
        if (!boundary)
            return;
        for (int i = 0; i < width; i += 2)
            bs_chroma_one_c(c, x0 + i, y0 - 1, x0 + i, y0, x0 + i, y0, 0);
    }
}

void deblock_compute_bs(const BsCtx *c, int x0, int y0, int vertical,
                        int left_tile, int left_slice,
                        int up_tile, int up_slice)
{
    int x_end4 = (x0 + c->ctb_size < c->pic_w ? x0 + c->ctb_size
                                              : c->pic_w) >> 2;
    int y_end4 = (y0 + c->ctb_size < c->pic_h ? y0 + c->ctb_size
                                              : c->pic_h) >> 2;
    int n_ch = c->chroma ? 2 : 1;
    for (int is_chroma = 0; is_chroma < n_ch; is_chroma++) {
        const int32_t *tpx = is_chroma ? c->tb_pos_x1 : c->tb_pos_x0;
        const int32_t *tpy = is_chroma ? c->tb_pos_y1 : c->tb_pos_y0;
        const int32_t *tw = is_chroma ? c->tb_w1 : c->tb_w0;
        const int32_t *th = is_chroma ? c->tb_h1 : c->tb_h0;
        int hs = is_chroma ? c->hs1 : 0;
        int vs = is_chroma ? c->vs1 : 0;
        for (int y4 = y0 >> 2; y4 < y_end4; y4++) {
            for (int x4 = x0 >> 2; x4 < x_end4; x4++) {
                long i = (long)y4 * c->w4 + x4;
                if ((tpx[i] >> 2) == x4 && (tpy[i] >> 2) == y4) {
                    int w = tw[i] << hs;
                    int h = th[i] << vs;
                    if (is_chroma)
                        bs_chroma_c(c, x4 << 2, y4 << 2, w, h, vertical,
                                    left_tile, left_slice, up_tile, up_slice);
                    else
                        bs_luma_c(c, x4 << 2, y4 << 2, w, h, vertical,
                                  left_tile, left_slice, up_tile, up_slice);
                }
            }
        }
    }
}

/* ---- whole-frame driver (deblock.py deblock_frame/deblock_ctb) ---------- */

typedef struct {
    int32_t *plane0, *plane1, *plane2;
    const int32_t *qp0, *qp1, *qp2;
    const int32_t *dis;        /* deblock_disabled per CTB [nctb] */
    const int32_t *beta;       /* [nctb][3] */
    const int32_t *tc;         /* [nctb][3] */
    const int32_t *col_bd;     /* [ctb_w + 1] */
    const int32_t *row_bd;     /* [ctb_h + 1] */
    int32_t ctb_w, ctb_h;
    int32_t qp_bd_offset, bd, pixel_max;
    int32_t n_ladf, ladf_lowest;
    const int32_t *ladf_off, *ladf_bnd;
} DeblockFrame;

#define DEBLOCK_STEP 8
#define LUMA_GRID    4
#define CHROMA_GRID  8

/* Every edge of one direction over the CTBs [rlo, rhi) x [clo, chi), in
 * raster order, each CTB's bS first (deblock.py deblock_frame/deblock_ctb);
 * CTBs with deblocking disabled are skipped.  args: visit's argument for
 * each plane. */
static void frame_walk(const BsCtx *c, const DeblockFrame *f, int vertical,
                       int rlo, int rhi, int clo, int chi, EdgeVisit visit,
                       void *const args[3])
{
    const int32_t *qps[3] = {f->qp0, f->qp1, f->qp2};
    int c_end = c->chroma ? 3 : 1;
    for (int ry = rlo; ry < rhi; ry++) {
        for (int rx = clo; rx < chi; rx++) {
            int rs = ry * f->ctb_w + rx;
            if (f->dis[rs])
                continue;
            int x0 = rx * c->ctb_size, y0 = ry * c->ctb_size;
            int lt = rx > 0 && f->col_bd[rx] != f->col_bd[rx - 1];
            int ls = rx > 0 &&
                c->slice_idx[rs] != c->slice_idx[rs - 1];
            int ut = ry > 0 && f->row_bd[ry] != f->row_bd[ry - 1];
            int us = ry > 0 &&
                c->slice_idx[rs] != c->slice_idx[rs - f->ctb_w];
            deblock_compute_bs(c, x0, y0, vertical, lt, ls, ut, us);
            int x_end = x0 + c->ctb_size;
            int y_end = y0 + c->ctb_size;
            if (x_end > c->pic_w) x_end = c->pic_w;
            if (y_end > c->pic_h) y_end = c->pic_h;
            for (int ci = 0; ci < c_end; ci++) {
                int hs = ci ? c->hs1 : 0, vs = ci ? c->vs1 : 0;
                /* across the edge: the grid; along it: the step */
                int across = vertical ? hs : vs, along = vertical ? vs : hs;
                EdgeTabs t = {
                    .c_idx = ci, .vertical = vertical,
                    .grid = ci ? (CHROMA_GRID << across) : LUMA_GRID,
                    .step = DEBLOCK_STEP << along,
                    .n = ci ? (DEBLOCK_STEP >> (2 - along))
                            : (DEBLOCK_STEP >> 2),
                    .hs = hs, .vs = vs, .ctb_size = c->ctb_size, .w4 = c->w4,
                    .bd = f->bd,
                    .bs_tab = vertical
                        ? (ci == 0 ? c->vbs0 : ci == 1 ? c->vbs1 : c->vbs2)
                        : (ci == 0 ? c->hbs0 : ci == 1 ? c->hbs1 : c->hbs2),
                    .mlp_tab = vertical ? c->vp : c->hp,
                    .mlq_tab = vertical ? c->vq : c->hq,
                    .tb_size_tab = vertical ? c->tb_w1 : c->tb_h1,
                    .qp_map = qps[ci],
                    .beta_off = f->beta[rs * 3 + ci],
                    .tc_off = f->tc[rs * 3 + ci],
                    .qp_bd_offset = f->qp_bd_offset,
                    .luma = f->plane0, .lstride = c->pic_w,
                    .n_ladf = f->n_ladf, .ladf_lowest = f->ladf_lowest,
                    .ladf_offsets = f->ladf_off, .ladf_bounds = f->ladf_bnd};
                walk_ctb_edges(&t, x0, y0, x_end, y_end, visit, args[ci]);
            }
        }
    }
}

/* One pass (vertical or horizontal) over a CTB range.  Parallel-safe
 * split axis: vertical-edge filtering only writes pixels of its own rows
 * -> shard by CTB row [lo, hi); horizontal-edge filtering only writes its
 * own columns -> shard by CTB column [lo, hi).  BS tables are written at
 * disjoint per-CTB offsets. */
void deblock_frame_range(const BsCtx *c, const DeblockFrame *f,
                         int vertical, int rlo, int rhi, int clo, int chi)
{
    FilterArg a[3] = {{f->plane0, c->pic_w, f->pixel_max},
                      {f->plane1, c->pic_w >> c->hs1, f->pixel_max},
                      {f->plane2, c->pic_w >> c->hs1, f->pixel_max}};
    void *const args[3] = {&a[0], &a[1], &a[2]};
    frame_walk(c, f, vertical, rlo, rhi, clo, chi, filter_visit, args);
}

/* ---- segment emitter: the device deblock's per-segment parameters ------
 * (golden model: ops/deblock_device.py _Rasterizer).  A segment is 7
 * int16 fields: luma (px, py, tc, beta, mlp, mlq, hor_ctu_edge) per 4
 * lines, chroma (px, py, tc, beta, mlp, mlq, size) per size lines; tc is
 * scaled to the bit depth and beta shifted to it. */

typedef struct {
    int16_t *buf;    /* [7][cap] */
    long cap, n;
    int overflow;
} SegOut;

static void seg_put(SegOut *o, int ex, int ey, int tc, int beta, int mlp,
                    int mlq, int last)
{
    if (o->n >= o->cap) {
        o->overflow = 1;
        return;
    }
    int16_t *b = o->buf + o->n++;
    long s = o->cap;
    b[0] = ex; b[s] = ey; b[2 * s] = tc; b[3 * s] = beta;
    b[4 * s] = mlp; b[5 * s] = mlq; b[6 * s] = last;
}

static void emit_visit(void *arg, const EdgeTabs *t, int px, int py,
                       int hor_ctu_edge, const int32_t *beta,
                       const int32_t *tc, const int32_t *mlp,
                       const int32_t *mlq)
{
    SegOut *o = arg;
    int bd = t->bd;
    /* luma: 2 segments of 4 lines; chroma: 4 of 2 or 2 of 4 by the shift */
    int size = t->c_idx == 0 ? 4 : ((t->vertical ? t->vs : t->hs) ? 2 : 4);
    for (int i = 0; i < 8 / size; i++) {
        int tcs = tc_bd(tc[i], bd);
        if (!tcs || (t->c_idx && (!mlp[i] || !mlq[i])))
            continue;
        int ex = t->vertical ? px : px + i * size;
        int ey = t->vertical ? py + i * size : py;
        seg_put(o, ex, ey, tcs, beta[i] << (bd - 8), mlp[i], mlq[i],
                t->c_idx ? size : hor_ctu_edge);
    }
}

/* The segments of one direction, every plane, into out[c]: int16 buffers
 * of 7 * cap entries, cap a power of two.  On return out[c] holds
 * counts[c] segments in the [7, B] layout the device reads (field-major,
 * B the least power of two >= max(counts[c], 8), columns past counts[c]
 * zero).  Reads no samples.  Returns 0; -1 under LADF (its qp offset
 * reads the samples mid-pass); -2 when a plane's segments pass cap. */
int deblock_frame_segments(const BsCtx *c, const DeblockFrame *f,
                           int vertical, int16_t *const out[3], long cap,
                           int32_t counts[3])
{
    if (f->n_ladf)
        return -1;
    SegOut o[3];
    int nc = c->chroma ? 3 : 1;
    for (int ci = 0; ci < 3; ci++) {
        o[ci].buf = ci < nc ? out[ci] : NULL;
        o[ci].cap = cap;
        o[ci].n = 0;
        o[ci].overflow = 0;
    }
    void *const args[3] = {&o[0], &o[1], &o[2]};
    frame_walk(c, f, vertical, 0, f->ctb_h, 0, f->ctb_w, emit_visit, args);
    for (int ci = 0; ci < nc; ci++) {
        if (o[ci].overflow)
            return -2;
        long n = o[ci].n, b = 8;
        while (b < n)
            b <<= 1;
        /* field k moves from k * cap down to k * b: never onto a field
         * still to move */
        for (int k = 0; k < 7; k++) {
            memmove(o[ci].buf + k * b, o[ci].buf + k * cap,
                    n * sizeof(int16_t));
            memset(o[ci].buf + k * b + n, 0, (b - n) * sizeof(int16_t));
        }
        counts[ci] = (int32_t)n;
    }
    return 0;
}

/* threading-shard entry: the vertical pass shards by CTB rows, the
 * horizontal one by CTB columns (parallel row-sharded H would race on
 * the cross-row writes of the top edges) */
void deblock_frame_part(const BsCtx *c, const DeblockFrame *f, int vertical,
                        int lo, int hi)
{
    if (vertical)
        deblock_frame_range(c, f, 1, lo, hi, 0, f->ctb_w);
    else
        deblock_frame_range(c, f, 0, 0, f->ctb_h, lo, hi);
}

void deblock_frame_c(const BsCtx *c, const DeblockFrame *f)
{
    deblock_frame_part(c, f, 1, 0, f->ctb_h);
    deblock_frame_part(c, f, 0, 0, f->ctb_w);
}
