/* Native inter MC kernels: replicate-padded fetch + 8-tap (luma) / 4-tap
 * (chroma) separable interpolation into the 14-bit intermediate domain,
 * and the uni / bi-average / weighted output stages.
 *
 * Transliterated from ffvvc_tpu/inter.py (_gather_block, _filter_h/_v,
 * _mc_put, _uni_out, _avg, _w_avg), which remains the golden model.
 * Reference analogue: libavcodec/h26x/
 * h2656_inter_template.c:1-577 + x86/h26x/h2656_inter.asm (the hottest
 * kernels per SURVEY §2.2) — re-expressed from our Python model.
 */
#include <stdint.h>
#include <string.h>

static inline int iclip(int v, int lo, int hi)
{ return v < lo ? lo : (v > hi ? hi : v); }

/* replicate-padded sample fetch (emulated_edge semantics; optional DMVR
 * prefetch box, inclusive bounds) */
static inline int32_t fetch(const int32_t *ref, long stride, int W, int H,
                            int x, int y, int has_box, int bx0, int bx1,
                            int by0, int by1, int wrap)
{
    if (wrap) {
        /* horizontal wraparound MC (spec 8.5.6.3.2 ClipH): wrap x by the
         * PpsRefWraparoundOffset*MinCbSizeY sample offset, then clamp */
        if (x < 0)
            x += wrap;
        else if (x > W - 1)
            x -= wrap;
    }
    if (has_box) {
        x = iclip(x, bx0, bx1);
        y = iclip(y, by0, by1);
    }
    x = iclip(x, 0, W - 1);
    y = iclip(y, 0, H - 1);
    return ref[(long)y * stride + x];
}

/* interior (no clamp, no box) variant: the common case */
static void mc_put_interior(int32_t *dst, const int32_t *ref, long stride,
                            int x_int, int y_int, int frac_x, int frac_y,
                            int w, int h, int taps, int eb,
                            const int32_t *hf, const int32_t *vf, int bd)
{
    if (!frac_x && !frac_y) {
        const int32_t *src = ref + (long)y_int * stride + x_int;
        for (int yy = 0; yy < h; yy++, src += stride)
            for (int xx = 0; xx < w; xx++)
                dst[yy * w + xx] = src[xx] << (14 - bd);
        return;
    }
    if (!frac_y) {
        const int32_t *src = ref + (long)y_int * stride + x_int - eb;
        for (int yy = 0; yy < h; yy++, src += stride)
            for (int xx = 0; xx < w; xx++) {
                int32_t acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += hf[k] * src[xx + k];
                dst[yy * w + xx] = acc >> (bd - 8);
            }
        return;
    }
    if (!frac_x) {
        const int32_t *src = ref + (long)(y_int - eb) * stride + x_int;
        for (int yy = 0; yy < h; yy++, src += stride)
            for (int xx = 0; xx < w; xx++) {
                int32_t acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += vf[k] * src[(long)k * stride + xx];
                dst[yy * w + xx] = acc >> (bd - 8);
            }
        return;
    }
    int32_t tmp[(128 + 7) * 128];
    int th = h + taps - 1;
    const int32_t *src = ref + (long)(y_int - eb) * stride + x_int - eb;
    for (int yy = 0; yy < th; yy++, src += stride)
        for (int xx = 0; xx < w; xx++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
                acc += hf[k] * src[xx + k];
            tmp[yy * w + xx] = acc >> (bd - 8);
        }
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
                acc += vf[k] * tmp[(yy + k) * w + xx];
            dst[yy * w + xx] = acc >> 6;
        }
}

/* put[is_luma][!!frac_y][!!frac_x]: dst [h][w] int32, 14-bit domain */
void mc_put(int32_t *dst, const int32_t *ref, long stride, int W, int H,
            int x_int, int y_int, int frac_x, int frac_y, int w, int h,
            int is_luma, const int32_t *hf, const int32_t *vf, int bd,
            int has_box, int bx0, int bx1, int by0, int by1, int wrap)
{
    int taps = is_luma ? 8 : 4;
    int eb = is_luma ? 3 : 1;
    if (!has_box && x_int - eb >= 0 && y_int - eb >= 0 &&
        x_int + w + taps - 1 - eb <= W && y_int + h + taps - 1 - eb <= H) {
        mc_put_interior(dst, ref, stride, x_int, y_int, frac_x, frac_y,
                        w, h, taps, eb, hf, vf, bd);
        return;
    }
    if (!frac_x && !frac_y) {
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++)
                dst[yy * w + xx] = fetch(ref, stride, W, H, x_int + xx,
                                         y_int + yy, has_box, bx0, bx1,
                                         by0, by1, wrap) << (14 - bd);
        return;
    }
    if (!frac_y) {
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++) {
                int32_t acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += hf[k] * fetch(ref, stride, W, H,
                                         x_int - eb + xx + k, y_int + yy,
                                         has_box, bx0, bx1, by0, by1, wrap);
                dst[yy * w + xx] = acc >> (bd - 8);
            }
        return;
    }
    if (!frac_x) {
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++) {
                int32_t acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += vf[k] * fetch(ref, stride, W, H, x_int + xx,
                                         y_int - eb + yy + k,
                                         has_box, bx0, bx1, by0, by1, wrap);
                dst[yy * w + xx] = acc >> (bd - 8);
            }
        return;
    }
    /* h then v, via a tmp of (h + taps - 1) rows */
    int32_t tmp[(128 + 7) * 128];
    int th = h + taps - 1;
    for (int yy = 0; yy < th; yy++)
        for (int xx = 0; xx < w; xx++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
                acc += hf[k] * fetch(ref, stride, W, H, x_int - eb + xx + k,
                                     y_int - eb + yy, has_box, bx0, bx1,
                                     by0, by1, wrap);
            tmp[yy * w + xx] = acc >> (bd - 8);
        }
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
                acc += vf[k] * tmp[(yy + k) * w + xx];
            dst[yy * w + xx] = acc >> 6;
        }
}

/* put_uni / put_uni_w: 14-bit val -> pixels into the plane */
void mc_uni_out(int32_t *plane, long stride, int x, int y,
                const int32_t *val, int w, int h, int bd, int weighted,
                int denom, int wx, int ox)
{
    int mx = (1 << bd) - 1;
    if (!weighted) {
        int shift = 14 - bd;
        int off = 1 << (shift - 1);
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++)
                plane[(long)(y + yy) * stride + x + xx] =
                    iclip((val[yy * w + xx] + off) >> shift, 0, mx);
        return;
    }
    int shift = denom + 14 - bd;
    long long off = shift > 0 ? 1LL << (shift - 1) : 0;
    long long oxs = (long long)ox << (bd - 8);
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++) {
            long long v = (((long long)val[yy * w + xx] * wx + off)
                           >> shift) + oxs;
            plane[(long)(y + yy) * stride + x + xx] =
                (int32_t)(v < 0 ? 0 : (v > mx ? mx : v));
        }
}

void mc_avg(int32_t *plane, long stride, int x, int y, const int32_t *s0,
            const int32_t *s1, int w, int h, int bd)
{
    int shift = 15 - bd;
    if (shift < 3) shift = 3;
    int off = 1 << (shift - 1);
    int mx = (1 << bd) - 1;
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++)
            plane[(long)(y + yy) * stride + x + xx] =
                iclip((s0[yy * w + xx] + s1[yy * w + xx] + off) >> shift,
                      0, mx);
}

void mc_w_avg(int32_t *plane, long stride, int x, int y, const int32_t *s0,
              const int32_t *s1, int w, int h, int bd, int denom, int w0,
              int w1, int o0, int o1)
{
    int shift = denom + (15 - bd > 3 ? 15 - bd : 3);
    long long off = (long long)((((o0 + o1) << (bd - 8)) + 1)) <<
                    (shift - 1);
    int mx = (1 << bd) - 1;
    for (int yy = 0; yy < h; yy++)
        for (int xx = 0; xx < w; xx++) {
            long long v = ((long long)s0[yy * w + xx] * w0 +
                           (long long)s1[yy * w + xx] * w1 + off) >> shift;
            plane[(long)(y + yy) * stride + x + xx] =
                (int32_t)(v < 0 ? 0 : (v > mx ? mx : v));
        }
}

/* ---- DMVR bilinear + SAD search (inter.py:358-470) ----------------------
 * Reference analogue: vvc_inter_template.c:324-437 (dmvr taps) and
 * vvc_inter.c:642-748 (SAD search + parametric refine). */

/* 2-tap bilinear to the 10-bit domain; dst [ph][pw] int32 */
void dmvr_bilinear(int32_t *dst, const int32_t *ref, long stride, int W,
                   int H, int mvx, int mvy, int x0, int y0, int pw, int ph,
                   int bd, const int8_t *dfilt /* [16][2] */, int wrap)
{
    int mx = mvx & 0xF, my = mvy & 0xF;
    int sr = 2;
    int ox = x0 + (mvx >> 4) - sr;
    int oy = y0 + (mvy >> 4) - sr;
#define F(xx, yy) \
    ref[(long)iclip((yy), 0, H - 1) * stride + \
        iclip(wrap && (xx) < 0 ? (xx) + wrap \
              : (wrap && (xx) > W - 1 ? (xx) - wrap : (xx)), 0, W - 1)]
    if (!mx && !my) {
        if (bd > 10) {
            int off = 1 << (bd - 11);
            for (int y = 0; y < ph; y++)
                for (int x = 0; x < pw; x++)
                    dst[y * pw + x] = (F(ox + x, oy + y) + off) >> (bd - 10);
        } else {
            for (int y = 0; y < ph; y++)
                for (int x = 0; x < pw; x++)
                    dst[y * pw + x] = F(ox + x, oy + y) << (10 - bd);
        }
        return;
    }
    int shift1 = bd - 6;
    int off1 = 1 << (shift1 - 1);
    const int8_t *fx = dfilt + 2 * mx;
    const int8_t *fy = dfilt + 2 * my;
    if (!my) {
        for (int y = 0; y < ph; y++)
            for (int x = 0; x < pw; x++)
                dst[y * pw + x] =
                    (fx[0] * F(ox + x, oy + y) +
                     fx[1] * F(ox + x + 1, oy + y) + off1) >> shift1;
        return;
    }
    if (!mx) {
        for (int y = 0; y < ph; y++)
            for (int x = 0; x < pw; x++)
                dst[y * pw + x] =
                    (fy[0] * F(ox + x, oy + y) +
                     fy[1] * F(ox + x, oy + y + 1) + off1) >> shift1;
        return;
    }
    int32_t tmp[(16 + 4) * (16 + 5)];
    for (int y = 0; y < ph + 1; y++)
        for (int x = 0; x < pw; x++)
            tmp[y * pw + x] = (fx[0] * F(ox + x, oy + y) +
                               fx[1] * F(ox + x + 1, oy + y) + off1)
                              >> shift1;
    for (int y = 0; y < ph; y++)
        for (int x = 0; x < pw; x++)
            dst[y * pw + x] = (fy[0] * tmp[y * pw + x] +
                               fy[1] * tmp[(y + 1) * pw + x] + 8) >> 4;
#undef F
}

static long long dmvr_sad(const int32_t *t0, const int32_t *t1, int pw,
                          int dx, int dy, int w, int h)
{
    dx -= 2;
    dy -= 2;
    long long s = 0;
    for (int y = 0; y < h; y += 2) {
        const int32_t *a = t0 + (long)(2 + dy + y) * pw + 2 + dx;
        const int32_t *b = t1 + (long)(2 - dy + y) * pw + 2 - dx;
        for (int x = 0; x < w; x++) {
            int d = a[x] - b[x];
            s += d < 0 ? -d : d;
        }
    }
    return s;
}

static int param_refine(long long sad_m, long long sad_c, long long sad_p)
{
    long long denom = ((sad_m + sad_p) - (sad_c << 1)) << 3;
    if (!denom)
        return 0;
    if (sad_m == sad_c)
        return -8;
    if (sad_p == sad_c)
        return 8;
    long long num = (sad_m - sad_p) << 4;
    int sign = num < 0;
    if (sign)
        num = -num;
    int quotient = 0;
    for (int i = 0; i < 3; i++) {
        quotient <<= 1;
        if (num >= denom) {
            num -= denom;
            quotient += 1;
        }
        denom >>= 1;
    }
    return sign ? -quotient : quotient;
}

/* full DMVR search over the two bilinear-prefiltered windows (already
 * (bw+4) x (bh+4)); writes dmv[2]; returns bdof_skip decision */
int dmvr_search(const int32_t *t0, const int32_t *t1, int bw, int bh,
                int32_t *dmv)
{
    int pw = bw + 4;
    long long sad[5][5];
    long long min_sad = dmvr_sad(t0, t1, pw, 2, 2, bw, bh);
    min_sad -= min_sad >> 2;
    sad[2][2] = min_sad;
    int min_dx = 2, min_dy = 2;
    dmv[0] = dmv[1] = 0;
    if (min_sad >= (long long)bw * bh) {
        for (int dy = 0; dy < 5; dy++)
            for (int dx = 0; dx < 5; dx++) {
                if (dx == 2 && dy == 2)
                    continue;
                long long s = dmvr_sad(t0, t1, pw, dx, dy, bw, bh);
                sad[dy][dx] = s;
                if (s < min_sad) {
                    min_sad = s;
                    min_dx = dx;
                    min_dy = dy;
                }
            }
        dmv[0] = (min_dx - 2) << 4;
        dmv[1] = (min_dy - 2) << 4;
        if (min_dx != 0 && min_dx != 4 && min_dy != 0 && min_dy != 4) {
            dmv[0] += param_refine(sad[min_dy][min_dx - 1],
                                   sad[min_dy][min_dx],
                                   sad[min_dy][min_dx + 1]);
            dmv[1] += param_refine(sad[min_dy - 1][min_dx],
                                   sad[min_dy][min_dx],
                                   sad[min_dy + 1][min_dx]);
        }
    }
    return min_sad < 2LL * bw * bh;
}

/* ---- BDOF (inter.py _apply_bdof; vvc_inter_template.c:237-323) --------- */

void apply_bdof(int32_t *out, const int32_t *s0p, const int32_t *s1p,
                int w, int h, int bd)
{
    /* s0p/s1p: (h+2) x (w+2) with integer-sample border ring */
    int pw = w + 2;
    long long gh[2][(16 + 4) * (16 + 4)], gv[2][(16 + 4) * (16 + 4)];
    int gw = w + 2;
    const int32_t *sp[2] = {s0p, s1p};
    /* gradients on the inner block, then replicate-pad by 1 */
    for (int i = 0; i < 2; i++) {
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) {
                const int32_t *s = sp[i];
                gh[i][(y + 1) * gw + x + 1] =
                    (s[(y + 1) * pw + x + 2] >> 6) -
                    (s[(y + 1) * pw + x] >> 6);
                gv[i][(y + 1) * gw + x + 1] =
                    (s[(y + 2) * pw + x + 1] >> 6) -
                    (s[y * pw + x + 1] >> 6);
            }
        for (int x = 0; x < w; x++) {
            gh[i][0 * gw + x + 1] = gh[i][1 * gw + x + 1];
            gh[i][(h + 1) * gw + x + 1] = gh[i][h * gw + x + 1];
            gv[i][0 * gw + x + 1] = gv[i][1 * gw + x + 1];
            gv[i][(h + 1) * gw + x + 1] = gv[i][h * gw + x + 1];
        }
        for (int y = 0; y < h + 2; y++) {
            gh[i][y * gw] = gh[i][y * gw + 1];
            gh[i][y * gw + w + 1] = gh[i][y * gw + w];
            gv[i][y * gw] = gv[i][y * gw + 1];
            gv[i][y * gw + w + 1] = gv[i][y * gw + w];
        }
    }
    /* source windows: replicate the CENTER block ring */
    long long sp0[(16 + 4) * (16 + 4)], sp1[(16 + 4) * (16 + 4)];
    for (int y = 0; y < h + 2; y++)
        for (int x = 0; x < w + 2; x++) {
            int cy = iclip(y - 1, 0, h - 1);
            int cx = iclip(x - 1, 0, w - 1);
            sp0[y * gw + x] = s0p[(cy + 1) * pw + cx + 1];
            sp1[y * gw + x] = s1p[(cy + 1) * pw + cx + 1];
        }
    int shift4 = 15 - bd;
    long long off4 = 1LL << (shift4 - 1);
    int mx = (1 << bd) - 1;
    for (int by = 0; by < h; by += 4)
        for (int bx = 0; bx < w; bx += 4) {
            long long sgx2 = 0, sgy2 = 0, sgxgy = 0, sgxdi = 0, sgydi = 0;
            for (int y = 0; y < 6; y++)
                for (int x = 0; x < 6; x++) {
                    long long w0 = sp0[(by + y) * gw + bx + x];
                    long long w1 = sp1[(by + y) * gw + bx + x];
                    long long diff = (w0 >> 4) - (w1 >> 4);
                    long long th = (gh[0][(by + y) * gw + bx + x] +
                                    gh[1][(by + y) * gw + bx + x]) >> 1;
                    long long tv = (gv[0][(by + y) * gw + bx + x] +
                                    gv[1][(by + y) * gw + bx + x]) >> 1;
                    sgx2 += th < 0 ? -th : th;
                    sgy2 += tv < 0 ? -tv : tv;
                    long long sv = tv > 0 ? 1 : (tv < 0 ? -1 : 0);
                    long long sh = th > 0 ? 1 : (th < 0 ? -1 : 0);
                    sgxgy += sv * th;
                    sgxdi += -sh * diff;
                    sgydi += -sv * diff;
                }
            int thres = 16;
            long long vx = 0, vy = 0;
            if (sgx2 > 0) {
                int bl = 64 - __builtin_clzll((unsigned long long)sgx2);
                vx = (sgxdi << 2) >> (bl - 1);
                if (vx < -thres + 1) vx = -thres + 1;
                if (vx > thres - 1) vx = thres - 1;
            }
            if (sgy2 > 0) {
                int bl = 64 - __builtin_clzll((unsigned long long)sgy2);
                vy = ((sgydi << 2) - ((vx * sgxgy) >> 1)) >> (bl - 1);
                if (vy < -thres + 1) vy = -thres + 1;
                if (vy > thres - 1) vy = thres - 1;
            }
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int gy_ = by + 1 + y, gx_ = bx + 1 + x;
                    long long boff =
                        vx * (gh[0][gy_ * gw + gx_] -
                              gh[1][gy_ * gw + gx_]) +
                        vy * (gv[0][gy_ * gw + gx_] -
                              gv[1][gy_ * gw + gx_]);
                    long long c0 = s0p[(by + 1 + y) * pw + bx + 1 + x];
                    long long c1 = s1p[(by + 1 + y) * pw + bx + 1 + x];
                    long long v = (c0 + off4 + c1 + boff) >> shift4;
                    out[(by + y) * w + bx + x] =
                        (int32_t)(v < 0 ? 0 : (v > mx ? mx : v));
                }
        }
}
