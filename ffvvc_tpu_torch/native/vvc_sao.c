/* Native SAO: whole-frame band/edge offset pass over the deblocked-plane
 * snapshot.
 *
 * A C transliteration of ffvvc_tpu/sao.py (SaoFilter._sao_ctb + the
 * _restore_flags unfilterable-edge logic), which remains the golden model;
 * must match it bit-exactly (arbitrated by the oracle-differential suite).
 *
 * Reference analogue: libavcodec/vvc/vvc_filter.c:154-298
 * and h26x/h2656_sao_template.c — re-expressed from our own Python model,
 * not copied. */
#include <stdint.h>
#include <string.h>

enum { SAO_NOT_APPLIED = 0, SAO_BAND = 1, SAO_EDGE = 2 };
enum { EO_HORIZ = 0, EO_VERT = 1, EO_135D = 2, EO_45D = 3 };

static const int EO_A[4][2] = {{-1, 0}, {0, -1}, {-1, -1}, {1, -1}};
static const int EO_B[4][2] = {{1, 0}, {0, 1}, {1, 1}, {-1, 1}};
static const int EDGE_IDX[5] = {1, 2, 0, 3, 4};

static inline int iclip(int v, int lo, int hi)
{ return v < lo ? lo : (v > hi ? hi : v); }
static inline int sgn(int v) { return (v > 0) - (v < 0); }

typedef struct {
    const int32_t *pre[3];      /* pre-SAO plane snapshots */
    int32_t *dst[3];            /* frame planes, in place */
    int plane_w[3], plane_h[3];
    const int32_t *sao_type;    /* [n_ctb, 3] */
    const int32_t *sao_band_pos;
    const int32_t *sao_eo_class;
    const int32_t *sao_offset;  /* [n_ctb, 3, 5] */
    const int32_t *slice_idx;   /* [ctb_h, ctb_w] */
    const int32_t *col_bd;      /* [ctb_w + 1] */
    const int32_t *row_bd;      /* [ctb_h + 1] */
    int ctb_w, ctb_h, ctb_log2;
    int n_comp, bit_depth;
    int lfase;                  /* pps_loop_filter_across_slices */
    int no_tile;                /* tiles>1 && !loop_filter_across_tiles */
    int hshift1, vshift1;
} SaoParams;

static void sao_ctb(const SaoParams *p, int rx, int ry)
{
    int ctbw = p->ctb_w;
    int rs = ry * ctbw + rx;
    int restore = p->no_tile || !p->lfase;
    int edges[4] = {rx == 0, ry == 0, rx == p->ctb_w - 1,
                    ry == p->ctb_h - 1};
    int vert_edge[2] = {0, 0}, horiz_edge[2] = {0, 0};
    int diag_edge[4] = {0, 0, 0, 0};
    if (restore) {
        const int32_t *si = p->slice_idx;
        int lfase = p->lfase, no_tile = p->no_tile;
        int lt = 0, rt = 0, ut = 0, bt = 0;
        int cur = si[ry * ctbw + rx];
        if (!edges[0]) {
            lt = no_tile && p->col_bd[rx] == rx;
            vert_edge[0] = (!lfase && cur != si[ry * ctbw + rx - 1]) || lt;
        }
        if (!edges[2]) {
            rt = no_tile && p->col_bd[rx] != p->col_bd[rx + 1];
            vert_edge[1] = (!lfase && cur != si[ry * ctbw + rx + 1]) || rt;
        }
        if (!edges[1]) {
            ut = no_tile && p->row_bd[ry] == ry;
            horiz_edge[0] = (!lfase && cur != si[(ry - 1) * ctbw + rx]) || ut;
        }
        if (!edges[3]) {
            bt = no_tile && p->row_bd[ry] != p->row_bd[ry + 1];
            horiz_edge[1] = (!lfase && cur != si[(ry + 1) * ctbw + rx]) || bt;
        }
        if (!edges[0] && !edges[1])
            diag_edge[0] = (!lfase && cur != si[(ry - 1) * ctbw + rx - 1])
                           || lt || ut;
        if (!edges[1] && !edges[2])
            diag_edge[1] = (!lfase && cur != si[(ry - 1) * ctbw + rx + 1])
                           || rt || ut;
        if (!edges[2] && !edges[3])
            diag_edge[2] = (!lfase && cur != si[(ry + 1) * ctbw + rx + 1])
                           || rt || bt;
        if (!edges[0] && !edges[3])
            diag_edge[3] = (!lfase && cur != si[(ry + 1) * ctbw + rx - 1])
                           || lt || bt;
    }
    int pix_max = (1 << p->bit_depth) - 1;
    for (int c = 0; c < p->n_comp; c++) {
        int t = p->sao_type[rs * 3 + c];
        if (t == SAO_NOT_APPLIED)
            continue;
        int hs = c ? p->hshift1 : 0, vs = c ? p->vshift1 : 0;
        int pw = p->plane_w[c], ph = p->plane_h[c];
        int x0 = (rx << p->ctb_log2) >> hs;
        int y0 = (ry << p->ctb_log2) >> vs;
        int w = (p->ctb_log2 ? (1 << p->ctb_log2) >> hs : 0);
        int h = (1 << p->ctb_log2) >> vs;
        w = (1 << p->ctb_log2) >> hs;
        if (x0 + w > pw) w = pw - x0;
        if (y0 + h > ph) h = ph - y0;
        const int32_t *src = p->pre[c];
        int32_t *dst = p->dst[c];
        const int32_t *off = p->sao_offset + (rs * 3 + c) * 5;
        if (t == SAO_BAND) {
            int shift = p->bit_depth - 5;
            int32_t table[32];
            memset(table, 0, sizeof(table));
            int left = p->sao_band_pos[rs * 3 + c];
            for (int k = 0; k < 4; k++)
                table[(k + left) & 31] = off[k + 1];
            for (int y = 0; y < h; y++) {
                const int32_t *s = src + (long)(y0 + y) * pw + x0;
                int32_t *d = dst + (long)(y0 + y) * pw + x0;
                for (int x = 0; x < w; x++) {
                    int v = s[x] + table[(s[x] >> shift) & 31];
                    d[x] = iclip(v, 0, pix_max);
                }
            }
            continue;
        }
        /* SAO_EDGE */
        int eo = p->sao_eo_class[rs * 3 + c];
        int ax = EO_A[eo][0], ay = EO_A[eo][1];
        int bx = EO_B[eo][0], by = EO_B[eo][1];
        int32_t offv[5];
        for (int i = 0; i < 5; i++)
            offv[i] = off[EDGE_IDX[i]];
        int init_x = 0, init_y = 0, rw = w, rh = h;
        if (eo != EO_VERT) {
            if (edges[0]) init_x = 1;
            if (edges[2]) rw = w - 1;
        }
        for (int y = 0; y < h; y++) {
            const int32_t *s = src + (long)(y0 + y) * pw + x0;
            int32_t *d = dst + (long)(y0 + y) * pw + x0;
            for (int x = 0; x < w; x++) {
                int cx = x0 + x, cy = y0 + y;
                int axc = iclip(cx + ax, 0, pw - 1);
                int ayc = iclip(cy + ay, 0, ph - 1);
                int bxc = iclip(cx + bx, 0, pw - 1);
                int byc = iclip(cy + by, 0, ph - 1);
                int cen = s[x];
                int a = src[(long)ayc * pw + axc];
                int b = src[(long)byc * pw + bxc];
                int dcls = 2 + sgn(cen - a) + sgn(cen - b);
                d[x] = iclip(cen + offv[dcls], 0, pix_max);
            }
        }
        /* edge_restore: picture borders keep src */
        if (eo != EO_VERT) {
            if (edges[0])
                for (int y = 0; y < h; y++)
                    dst[(long)(y0 + y) * pw + x0] =
                        src[(long)(y0 + y) * pw + x0];
            if (edges[2])
                for (int y = 0; y < h; y++)
                    dst[(long)(y0 + y) * pw + x0 + w - 1] =
                        src[(long)(y0 + y) * pw + x0 + w - 1];
        }
        if (eo != EO_HORIZ) {
            if (edges[1])
                for (int x = init_x; x < rw; x++)
                    dst[(long)y0 * pw + x0 + x] = src[(long)y0 * pw + x0 + x];
            if (edges[3])
                for (int x = init_x; x < rw; x++)
                    dst[(long)(y0 + h - 1) * pw + x0 + x] =
                        src[(long)(y0 + h - 1) * pw + x0 + x];
        }
        if (restore) {
            if (eo != EO_HORIZ && edges[1])
                init_y = 1;
            if (eo != EO_HORIZ && edges[3])
                rh = h - 1;
            int sul = !diag_edge[0] && eo == EO_135D && !edges[0] && !edges[1];
            int sur = !diag_edge[1] && eo == EO_45D && !edges[1] && !edges[2];
            int slr = !diag_edge[2] && eo == EO_135D && !edges[2] && !edges[3];
            int sll = !diag_edge[3] && eo == EO_45D && !edges[0] && !edges[3];
            if (vert_edge[0] && eo != EO_VERT)
                for (int y = init_y + sul; y < rh - sll; y++)
                    dst[(long)(y0 + y) * pw + x0] =
                        src[(long)(y0 + y) * pw + x0];
            if (vert_edge[1] && eo != EO_VERT)
                for (int y = init_y + sur; y < rh - slr; y++)
                    dst[(long)(y0 + y) * pw + x0 + w - 1] =
                        src[(long)(y0 + y) * pw + x0 + w - 1];
            if (horiz_edge[0] && eo != EO_HORIZ)
                for (int x = init_x + sul; x < rw - sur; x++)
                    dst[(long)y0 * pw + x0 + x] = src[(long)y0 * pw + x0 + x];
            if (horiz_edge[1] && eo != EO_HORIZ)
                for (int x = init_x + sll; x < rw - slr; x++)
                    dst[(long)(y0 + h - 1) * pw + x0 + x] =
                        src[(long)(y0 + h - 1) * pw + x0 + x];
        }
    }
}

int sao_sizeof_params(void) { return (int)sizeof(SaoParams); }

void sao_frame_c(const SaoParams *p)
{
    for (int ry = 0; ry < p->ctb_h; ry++)
        for (int rx = 0; rx < p->ctb_w; rx++)
            sao_ctb(p, rx, ry);
}

/* row-range variant for stage threading */
void sao_rows_c(const SaoParams *p, int ry0, int ry1)
{
    for (int ry = ry0; ry < ry1; ry++)
        for (int rx = 0; rx < p->ctb_w; rx++)
            sao_ctb(p, rx, ry);
}
