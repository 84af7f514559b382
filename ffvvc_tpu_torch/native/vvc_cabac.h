/* Shared declarations for the native CABAC engine + residual decoder
 * (vvc_cabac.c) so other native units (vvc_parse.c) can drive them
 * in-process.  Mirrors ffvvc_tpu/cabac/native.py's ctypes layout. */
#ifndef VVC_CABAC_H
#define VVC_CABAC_H

#include <stdint.h>

typedef struct {
    const uint8_t *data;
    long nbits;
    long pos;
    uint32_t range;
    uint32_t offset;
    int32_t *s0, *s1, *sh0, *sh1;   /* context state arrays (numpy int32) */
    /* buffered read-ahead: cache holds bits [pos, pos + cache_n) left-
     * aligned; reset by cabac_init / cabac_set_pos */
    uint64_t cache;
    int32_t cache_n;
} Cabac;

void cabac_init(Cabac *c, const uint8_t *data, long nbits, long bit_pos,
                int32_t *s0, int32_t *s1, int32_t *sh0, int32_t *sh1);
int cabac_decode_bin(Cabac *c, int idx);
int cabac_decode_bypass(Cabac *c);
int cabac_decode_bypass_bits(Cabac *c, int n);
int cabac_decode_terminate(Cabac *c);
int cabac_truncated_binary(Cabac *c, int c_max);
int cabac_limited_egk(Cabac *c, int k, int max_pre_ext_len,
                      int trunc_suffix_len);
long cabac_pos(Cabac *c);
void cabac_set_pos(Cabac *c, long pos);

/* ---- inline engine core (H.266 9.3.4.3) --------------------------------
 * The bin decoders run millions of times per frame from vvc_parse.c and
 * the residual loops; defining them static inline here lets every caller
 * inline them (no cross-TU PLT call).  The cabac_decode_* symbols above
 * stay exported as thin wrappers for the ctypes engine (cabac/native.py).
 */

static inline void cabac_refill_(Cabac *c)
{
    long p = c->pos;
    long byte = p >> 3;
    long nbytes = (c->nbits + 7) >> 3;
    uint64_t v;
    if (byte + 8 <= nbytes) {
        __builtin_memcpy(&v, c->data + byte, 8);
        v = __builtin_bswap64(v);
    } else {
        v = 0;
        for (int i = 0; i < 8; i++)
            v = (v << 8) | (byte + i < nbytes ? c->data[byte + i] : 0);
    }
    int skip = (int)(p & 7);
    c->cache = v << skip;       /* bits past nbits read as 0 */
    c->cache_n = 64 - skip;
}

/* read n (1..32) MSB-first bits from the cache in one step */
static inline uint32_t cabac_take_bits_(Cabac *c, int n)
{
    if (c->cache_n < n)
        cabac_refill_(c);       /* refill reloads from c->pos: lossless */
    uint32_t b = (uint32_t)(c->cache >> (64 - n));
    c->cache <<= n;
    c->cache_n -= n;
    c->pos += n;
    return b;
}

static inline int cabac_bin_(Cabac *c, int idx)
{
    int32_t st0 = c->s0[idx];
    int32_t st1 = c->s1[idx];
    int32_t p = st1 + (st0 << 4);
    int val_mps = p >> 14;
    uint32_t lps = (((c->range >> 5) *
                     (uint32_t)((val_mps ? 32767 - p : p) >> 9)) >> 1) + 4;
    uint32_t rng = c->range - lps;
    int bit;
    if (c->offset >= rng) {
        bit = 1 - val_mps;
        c->offset -= rng;
        rng = lps;
    } else {
        bit = val_mps;
    }
    if (rng < 256) {
        /* renormalize in one step (rng >= 4 always) */
        int s = 8 - (31 - __builtin_clz(rng));
        rng <<= s;
        c->offset = (c->offset << s) | cabac_take_bits_(c, s);
    }
    c->range = rng;
    int a = c->sh0[idx];
    c->s0[idx] = st0 - (st0 >> a) + ((1023 * bit) >> a);
    int b = c->sh1[idx];
    c->s1[idx] = st1 - (st1 >> b) + ((16383 * bit) >> b);
    return bit;
}

static inline int cabac_bypass_(Cabac *c)
{
    uint32_t offset = (c->offset << 1) | cabac_take_bits_(c, 1);
    if (offset >= c->range) {
        c->offset = offset - c->range;
        return 1;
    }
    c->offset = offset;
    return 0;
}

static inline int cabac_bypass_bits_(Cabac *c, int n)
{
    /* n sequential bypass bins == long division of (offset:bits) by
     * range; chunked at 16 bins to bound the dividend (vvc_cabac.c) */
    int v = 0;
    while (n > 0) {
        int k = n > 16 ? 16 : n;
        uint64_t d = ((uint64_t)c->offset << k) | cabac_take_bits_(c, k);
        v = (v << k) | (int)(d / c->range);
        c->offset = (uint32_t)(d % c->range);
        n -= k;
    }
    return v;
}

static inline int cabac_terminate_(Cabac *c)
{
    c->range -= 2;
    if (c->offset >= c->range)
        return 1;
    if (c->range < 256) {
        int s = 8 - (31 - __builtin_clz(c->range));
        c->range <<= s;
        c->offset = (c->offset << s) | cabac_take_bits_(c, s);
    }
    return 0;
}

static inline int cabac_truncated_binary_(Cabac *c, int c_max)
{
    int n = c_max + 1;
    if (n <= 1)
        return 0;
    int k = 31 - __builtin_clz(n);
    int u = (1 << (k + 1)) - n;
    int v = cabac_bypass_bits_(c, k);
    if (v >= u) {
        v = (v << 1) | cabac_bypass_(c);
        v -= u;
    }
    return v;
}

static inline int cabac_limited_egk_(Cabac *c, int k, int max_pre_ext_len,
                                     int trunc_suffix_len)
{
    int pre = 0;
    while (pre < max_pre_ext_len && cabac_bypass_(c))
        pre++;
    int esc = (pre == max_pre_ext_len) ? trunc_suffix_len : pre + k;
    int val = esc > 0 ? cabac_bypass_bits_(c, esc) : 0;
    val += ((1 << pre) - 1) << k;
    return val;
}

typedef struct {
    /* geometry */
    int w, h, log2_w, log2_h, c_idx;
    int log2_zo_w, log2_zo_h;
    int ts;                  /* transform-skip path */
    int bdpcm;
    /* flags */
    int dep_quant, sdh, reverse_last;
    int persistent_rice, rrc_rice_ext, bd_gt12, is_i_slice;
    int log2_transform_range;
    int max_ts_cu_size_bins;  /* ts path: remaining ctx bins budget (in/out) */
    /* ctx bases */
    int ctx_sig, ctx_last_x, ctx_last_y, ctx_sb_coded, ctx_gtx, ctx_par;
    int ctx_ts_sig, ctx_ts_sign, ctx_ts_gtx, ctx_ts_par, ctx_ts_lrg1;
    /* state in/out */
    int stat_coeff;          /* stat_coeff[c_idx] */
    /* outputs */
    int max_scan_x, max_scan_y, min_scan_x, min_scan_y;
    int lfnst_dc_only, lfnst_zero_out, mts_dc_only, mts_zero_out;
    /* transform-skip path */
    int ts_rice;             /* sh_ts_residual_coding_rice_idx_minus1 + 1 */
} ResParams;

int decode_residual_ts(Cabac *c, ResParams *pp, int32_t *coeffs,
                       const uint8_t *sb_sx, const uint8_t *sb_sy,
                       const uint8_t *sx, const uint8_t *sy);

int decode_residual_regular(Cabac *c, ResParams *pp, int32_t *coeffs,
                            const uint8_t *sb_sx, const uint8_t *sb_sy,
                            const uint8_t *sx, const uint8_t *sy);

#endif /* VVC_CABAC_H */
