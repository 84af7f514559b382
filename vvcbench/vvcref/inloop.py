"""The reference's in-loop filters: deblocking decisions, SAO, ALF and
CC-ALF, written for the benchmark from H.266 clause 8.8.

This file is not a copy of the port.  The port's fused chain builds its
filter parameters with the golden model's deblocking edge walk, its SAO
filter object and its ALF coefficient sets, which the rest of `vvcref`
holds frozen copies of; were the reference to use those copies, a fault in
them would read correct.  So every decision here is derived again, whole
frame at a time in NumPy, from the parse's per-4x4 tables and the raw
syntax of the parameter sets and headers:

- deblocking: which edges are filtered (transform edges, the 8x8 subblock
  edges of affine and SbTMVP coding units, tile and slice boundaries,
  slices with deblocking off), the boundary strength of every 4-sample
  segment, tC and beta from the QPs, the chroma QP mapping table and the
  offsets of the PPS, picture and slice headers, and the maximum filter
  lengths;
- SAO: band and edge offsets per CTB, and which samples the picture, tile
  and slice boundaries keep unmodified;
- ALF: the coefficient and clipping sets from the APS syntax, the
  classification and transposition of every 4x4 block, the choice of APS
  or fixed filter set per CTB, the luma, chroma and cross-component
  filters with the virtual boundary and the padding at unfilterable
  boundaries.

Two things are taken from the frozen copy.  The deblocking sample filters
(`deblock.Deblocker._filter_luma` and `_filter_chroma`, the golden model's
scalar filters) apply the decisions made here; the port's timed path does
not run them (it runs `ops/deblock_device.luma_math` on the card).  The
fixed ALF filter tables of the standard (`data.tables()`), numbers with no
other source on this machine.
"""
from __future__ import annotations

import numpy as np

from . import data as D
from .deblock import Deblocker

PF_INTRA, PF_L0, PF_L1, PF_BI = 0, 1, 2, 3

# H.266 Table 43: beta' and tC' by Q
BETA = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
                26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54,
                56, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84,
                86, 88], np.int64)
TC = np.array(
    [0] * 18 + [3, 4, 4, 4, 4, 5, 5, 5, 5, 7, 7, 8, 9, 10, 10, 11, 13, 14,
                15, 17, 19, 21, 24, 25, 29, 33, 36, 41, 45, 51, 57, 64, 71,
                80, 89, 100, 112, 125, 141, 157, 177, 198, 222, 250, 280,
                314, 352, 395], np.int64)
assert len(BETA) == 64 and len(TC) == 66

# ALF: activity classes by avgVar, coefficient orders by transposeIdx
VAR_TAB = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4])
TRANSPOSE_TABLE = np.array([0, 1, 0, 2, 2, 3, 1, 3])
COEF_ORDER = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
    [9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6],
    [0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11],
    [9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6]])
# (dy, dx) of the first sample of each symmetric pair; the second is the
# mirror (-dy, -dx)
LUMA_TAPS = ((3, 0), (2, 1), (2, 0), (2, -1), (1, 2), (1, 1), (1, 0),
             (1, -1), (1, -2), (0, 3), (0, 2), (0, 1))
CHROMA_TAPS = ((2, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1))
CC_TAPS = ((-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1), (2, 0))
# rows above the CTB's bottom where the ALF virtual boundary lies
VB_LUMA, VB_CHROMA = 4, 2


class Frame:
    """What every filter here reads of a decoded frame."""

    def __init__(self, sps, pps, ph, sh_list, tabs, planes, slice_rpls):
        self.sps, self.pps, self.ph = sps, pps, ph
        self.sh = sh_list              # derived slice headers by slice index
        self.tabs, self.planes = tabs, planes
        self.rpls = slice_rpls
        self.bd = sps.r.sps_bitdepth_minus8 + 8
        self.ctb_log2 = sps.r.sps_log2_ctu_size_minus5 + 5
        self.ctb = 1 << self.ctb_log2
        self.w, self.h = pps.r.pps_pic_width_in_luma_samples, \
            pps.r.pps_pic_height_in_luma_samples
        self.cw, self.ch = -(-self.w // self.ctb), -(-self.h // self.ctb)
        self.h4, self.w4 = tabs.h4, tabs.w4
        cf = sps.r.sps_chroma_format_idc
        if cf not in (0, 1):
            raise NotImplementedError("chroma formats other than 4:2:0")
        self.ncomp = 3 if cf else 1
        k = self.ctb_log2 - 2
        si = tabs.slice_idx
        self.slice4 = np.repeat(np.repeat(si, 1 << k, 0), 1 << k,
                                1)[:self.h4, :self.w4]
        col, row = pps.ctb_to_col_bd[:self.cw], pps.ctb_to_row_bd[:self.ch]
        tile = row[:, None] * (self.cw + 1) + col[None, :]
        self.tile_ctb = tile
        self.tile4 = np.repeat(np.repeat(tile, 1 << k, 0), 1 << k,
                               1)[:self.h4, :self.w4]
        self.across_tiles = bool(
            pps.r.pps_loop_filter_across_tiles_enabled_flag)
        self.across_slices = bool(
            pps.r.pps_loop_filter_across_slices_enabled_flag)

    def raw_sh(self, s):
        return self.sh[int(s)].r


# ---------------------------------------------------------------------------
# deblocking (8.8.3)


def chroma_qp_tables(sps_r, bd):
    """ChromaQpTable[i][qp + QpBdOffset] for qp = -QpBdOffset..63 (7.4.3.4),
    one table per signalled set (Cb, Cr, joint Cb-Cr)."""
    off = 6 * (bd - 8)
    n = 1 if sps_r.sps_same_qp_table_for_chroma_flag else \
        (3 if sps_r.sps_joint_cbcr_enabled_flag else 2)
    tables = []
    for i in range(n):
        q_in = [sps_r.sps_qp_table_start_minus26[i] + 26]
        q_out = [q_in[0]]
        for j in range(sps_r.sps_num_points_in_qp_table_minus1[i] + 1):
            d_in = sps_r.sps_delta_qp_in_val_minus1[i][j]
            q_in.append(q_in[j] + d_in + 1)
            q_out.append(q_out[j] + (d_in ^ sps_r.sps_delta_qp_diff_val[i][j]))
        t = {q_in[0]: q_out[0]}
        for k in range(q_in[0] - 1, -off - 1, -1):
            t[k] = min(max(t[k + 1] - 1, -off), 63)
        for j in range(len(q_in) - 1):
            span = q_in[j + 1] - q_in[j]
            rnd = span >> 1
            for k in range(q_in[j] + 1, q_in[j + 1] + 1):
                m = k - q_in[j]
                num = (q_out[j + 1] - q_out[j]) * m + rnd
                # integer division truncating towards zero (5.7)
                t[k] = t[q_in[j]] + int(num / span)
        for k in range(q_in[-1] + 1, 64):
            t[k] = min(max(t[k - 1] + 1, -off), 63)
        tables.append(np.array([t[k] for k in range(-off, 64)], np.int64))
    while len(tables) < 3:
        tables.append(tables[0])
    return tables


def deblocking_params(pps_r, ph, sh_r):
    """(disabled, [(beta_div2, tc_div2) for Y, Cb, Cr]) of one slice, with
    the inference of 7.4.3.5, 7.4.3.8 and 7.4.8.1."""
    chroma_sig = pps_r.pps_chroma_tool_offsets_present_flag

    def offsets(o, p):
        y = (getattr(o, p + "luma_beta_offset_div2"),
             getattr(o, p + "luma_tc_offset_div2"))
        if not chroma_sig:
            return [y, y, y]
        return [y] + [(getattr(o, f"{p}{c}_beta_offset_div2"),
                       getattr(o, f"{p}{c}_tc_offset_div2"))
                      for c in ("cb", "cr")]

    pps_off = pps_r.pps_deblocking_filter_disabled_flag
    if pps_off:
        level = (1, [(0, 0)] * 3)
    else:
        level = (0, offsets(pps_r, "pps_"))
    if ph.ph_deblocking_params_present_flag:
        dis = 0 if pps_off else ph.ph_deblocking_filter_disabled_flag
        level = (dis, offsets(ph, "ph_") if not dis else [(0, 0)] * 3)
    if sh_r.sh_deblocking_params_present_flag:
        dis = 0 if pps_off else sh_r.sh_deblocking_filter_disabled_flag
        level = (dis, offsets(sh_r, "sh_") if not dis else [(0, 0)] * 3)
    return level


class _Side:
    """The per-4x4 tables of the P and Q side of every candidate edge of one
    direction: Q is the unit, P its left (vertical) or upper neighbour."""

    def __init__(self, a, vertical):
        self.q = a[:, 1:] if vertical else a[1:, :]
        self.p = a[:, :-1] if vertical else a[:-1, :]


def _pad(e, vertical):
    """An array over the edge units (columns or rows 1..) back at full
    size, with nothing at the picture's left or top edge."""
    z = np.zeros((e.shape[0], 1) if vertical else (1, e.shape[1]), e.dtype)
    return np.concatenate([z, e], 1 if vertical else 0)


def deblock(fr: Frame):
    """Deblock the frame's planes in place: every vertical edge of the
    picture, then every horizontal one."""
    sps_r, pps_r = fr.sps.r, fr.pps.r
    if sps_r.sps_ladf_enabled_flag or sps_r.sps_ibc_enabled_flag or \
            sps_r.sps_palette_enabled_flag:
        raise NotImplementedError("LADF, IBC or palette in deblocking")
    nsl = len(fr.sh)
    params = [deblocking_params(pps_r, fr.ph, fr.raw_sh(s))
              if fr.sh[s] is not None else (1, [(0, 0)] * 3)
              for s in range(nsl)]
    disabled = np.array([p[0] for p in params], bool)
    offs = np.array([p[1] for p in params], np.int64)     # [slice, c, 2]
    qp_c = chroma_qp_tables(sps_r, fr.bd) if fr.ncomp == 3 else None
    cqp_off = (0, pps_r.pps_cb_qp_offset, pps_r.pps_cr_qp_offset)
    filt = Deblocker(fr.sps, fr.pps, fr.tabs, None)
    for vertical in (True, False):
        edges = _edges(fr, vertical, disabled)
        for c in range(fr.ncomp):
            segs = _segments(fr, vertical, c, edges, offs, qp_c, cqp_off)
            plane = fr.planes[c]
            for x4, y4, beta, tc, mlp, mlq, ctb_edge in segs:
                if c == 0:
                    x, y = x4 << 2, y4 << 2
                    filt._filter_luma(plane, x, y, vertical, [beta, 0],
                                      [tc, 0], [mlp, 0], [mlq, 0], ctb_edge)
                else:
                    # one 2-line chroma segment per 4 luma lines
                    x, y = x4 << 1, y4 << 1
                    filt._filter_chroma(plane, x, y, vertical,
                                        [beta, 0, 0, 0], [tc, 0, 0, 0],
                                        [mlp, 0, 0, 0], [mlq, 0, 0, 0], 1)


def _edges(fr, vertical, disabled):
    """Per 4x4 unit: 1 where its left (top) edge is a transform edge, 2
    where it is a subblock prediction edge inside a coding unit, 0 where no
    edge is filtered (8.8.3.2-8.8.3.4).  Also the transform edge of chroma
    and, for subblock edges, the distance to the nearest transform edge."""
    t = fr.tabs
    n4 = fr.w4 if vertical else fr.h4
    pos = np.arange(n4)[None, :] if vertical else np.arange(n4)[:, None]
    cb_pos = t.cb_pos_x[0] if vertical else t.cb_pos_y[0]
    cb_size = t.cb_width[0] if vertical else t.cb_height[0]
    tb_pos = [t.tb_pos_x[k] if vertical else t.tb_pos_y[k] for k in (0, 1)]
    tb_size = [t.tb_width[k] if vertical else t.tb_height[k] for k in (0, 1)]
    tb_edge = (tb_pos[0] >> 2) == pos
    # chroma transform edges on the 8x8 chroma grid (16 luma samples)
    tbc_edge = ((tb_pos[1] >> 2) == pos) & (pos % 4 == 0)
    sub_cu = (t.mvf_pf != PF_INTRA) & ((t.msf != 0) | (t.iaf != 0))
    rel = (pos << 2) - cb_pos
    sub_edge = sub_cu & (cb_size > 8) & (rel > 0) & (rel % 8 == 0) & \
        ~tb_edge
    # distance from a subblock edge to the transform edges around it
    start = (tb_pos[0] >> 2) << 2
    dist = np.minimum((pos << 2) - start,
                      start + tb_size[0] - (pos << 2))
    # filterEdgeFlag: no edge on the picture's border, none across a tile
    # or slice boundary that the PPS keeps unfiltered, none whose Q side
    # lies in a slice with deblocking off
    ok = np.ones((fr.h4, fr.w4), bool)
    if vertical:
        ok[:, 0] = False
    else:
        ok[0, :] = False
    sl, ti = _Side(fr.slice4, vertical), _Side(fr.tile4, vertical)
    cross = np.zeros(sl.q.shape, bool)
    if not fr.across_slices:
        cross |= sl.p != sl.q
    if not fr.across_tiles:
        cross |= ti.p != ti.q
    ok &= ~_pad(cross, vertical)
    ok &= ~disabled[fr.slice4]
    kind = np.where(tb_edge, 1, np.where(sub_edge, 2, 0)) * ok
    return {"kind": kind, "chroma": tbc_edge & ok,
            "dist": dist, "sub_cu": sub_cu, "tb_size": tb_size}


def _motion_bs(fr, vertical):
    """1 where the motion of P and Q differs enough for a boundary strength
    of 1 (8.8.3.5, the last conditions), per 4x4 unit of Q."""
    t = fr.tabs
    h4, w4 = fr.h4, fr.w4
    # reference POCs per list and unit, from the RPLs of each unit's slice
    refpoc = np.full((2, h4, w4), -(1 << 40), np.int64)
    for s in np.unique(fr.slice4):
        if s < 0 or s >= len(fr.rpls) or fr.rpls[s] is None:
            continue
        on = fr.slice4 == s
        for lx in (0, 1):
            pl = np.asarray(list(fr.rpls[s][lx].poc_list) or [0], np.int64)
            idx = np.clip(t.mvf_ref[lx].astype(np.int64), 0, len(pl) - 1)
            refpoc[lx][on] = pl[idx][on]
    pf = t.mvf_pf.astype(np.int64)
    mv = t.mvf_mv.astype(np.int64)
    S = lambda a: _Side(a, vertical)
    P = {k: S(v).p for k, v in (("pf", pf), ("r0", refpoc[0]),
                                 ("r1", refpoc[1]))}
    Q = {k: S(v).q for k, v in (("pf", pf), ("r0", refpoc[0]),
                                 ("r1", refpoc[1]))}
    mvp = [S(mv[lx, ..., 0]).p for lx in (0, 1)], \
        [S(mv[lx, ..., 1]).p for lx in (0, 1)]
    mvq = [S(mv[lx, ..., 0]).q for lx in (0, 1)], \
        [S(mv[lx, ..., 1]).q for lx in (0, 1)]

    def far(la, lb):
        """P's vector of list la and Q's of list lb differ by half a sample
        or more in either component (1/16-sample units)."""
        return (np.abs(mvp[0][la] - mvq[0][lb]) >= 8) | \
            (np.abs(mvp[1][la] - mvq[1][lb]) >= 8)

    bi_p, bi_q = P["pf"] == PF_BI, Q["pf"] == PF_BI
    out = bi_p != bi_q                          # number of vectors differs
    # one vector each: the list in use on each side
    lp = np.where(P["pf"] == PF_L1, 1, 0)
    lq = np.where(Q["pf"] == PF_L1, 1, 0)
    rp = np.where(lp == 1, P["r1"], P["r0"])
    rq = np.where(lq == 1, Q["r1"], Q["r0"])
    dx = np.abs(np.choose(lp, (mvp[0][0], mvp[0][1])) -
                np.choose(lq, (mvq[0][0], mvq[0][1])))
    dy = np.abs(np.choose(lp, (mvp[1][0], mvp[1][1])) -
                np.choose(lq, (mvq[1][0], mvq[1][1])))
    uni = ~bi_p & ~bi_q
    out |= uni & ((rp != rq) | (dx >= 8) | (dy >= 8))
    # two vectors each
    bi = bi_p & bi_q
    same_set = ((P["r0"] == Q["r0"]) & (P["r1"] == Q["r1"])) | \
        ((P["r0"] == Q["r1"]) & (P["r1"] == Q["r0"]))
    out |= bi & ~same_set
    straight = far(0, 0) | far(1, 1)
    crossed = far(0, 1) | far(1, 0)
    two_refs = P["r0"] != P["r1"]
    pair = np.where(P["r0"] == Q["r0"], straight, crossed)
    out |= bi & same_set & two_refs & pair
    out |= bi & same_set & ~two_refs & straight & crossed
    return _pad(out, vertical)


def _segments(fr, vertical, c, edges, offs, qp_c, cqp_off):
    """(x4, y4, beta', tC', maxFilterLengthP, maxFilterLengthQ, on a CTB's
    top edge) of every edge segment of component c to filter."""
    t = fr.tabs
    S = lambda a: _Side(a, vertical)
    pf = t.mvf_pf
    intra = _pad(S(pf == PF_INTRA).p | S(pf == PF_INTRA).q, vertical)
    kind = edges["kind"]
    # CIIP on either side of a coding block edge counts as intra (inside a
    # CIIP coding unit only a transform edge could lie, and none does while
    # the largest transform is 64 samples, the size CIIP is bounded by)
    ciip = S(t.mvf_ciip != 0)
    cu_edge = (S(t.cb_pos_x[0]).p != S(t.cb_pos_x[0]).q) | \
        (S(t.cb_pos_y[0]).p != S(t.cb_pos_y[0]).q)
    intra |= _pad((ciip.p | ciip.q) & cu_edge, vertical)
    if c == 0:
        on = kind > 0
        bdpcm = _pad(S(t.pcmf[0] != 0).p & S(t.pcmf[0] != 0).q, vertical)
        cbf = _pad(S(t.tu_coded_flag[0] != 0).p | S(t.tu_coded_flag[0] != 0).q,
                   vertical)
        bs = np.where(kind == 1, np.where(cbf, 1, 0), 0)
        bs = np.where(bs == 0, _motion_bs(fr, vertical).astype(np.int64), bs)
        bs = np.where(intra, 2, bs)
        bs = np.where(bdpcm, 0, bs) * on
    else:
        on = edges["chroma"]
        bdpcm = _pad(S(t.pcmf[1] != 0).p & S(t.pcmf[1] != 0).q, vertical)
        coded = (t.tu_coded_flag[c] != 0) | (t.tu_joint_cbcr != 0)
        cbf = _pad(S(coded).p | S(coded).q, vertical)
        bs = np.where(intra, 2, np.where(cbf, 1, 0))
        bs = np.where(bdpcm, 0, bs) * on
    ys, xs = np.nonzero(bs)
    if not len(ys):
        return []
    b = bs[ys, xs]
    py, px = (ys, xs - 1) if vertical else (ys - 1, xs)
    ctb_edge = np.zeros(len(ys), bool) if vertical else \
        ((ys << 2) % fr.ctb == 0)
    # maximum filter lengths (8.8.3.3, 8.8.3.4)
    size = edges["tb_size"][0 if c == 0 else 1]
    sp, sq = size[py, px].astype(np.int64), size[ys, xs].astype(np.int64)
    if c == 0:
        k = kind[ys, xs]
        small = (sp <= 4) | (sq <= 4)
        mlp = np.where(small, 1, np.where(sp >= 32, 7, 3))
        mlq = np.where(small, 1, np.where(sq >= 32, 7, 3))
        sub = edges["sub_cu"]
        mlp = np.where(sub[py, px], np.minimum(mlp, 5), mlp)
        mlq = np.where(sub[ys, xs], np.minimum(mlq, 5), mlq)
        d = edges["dist"][ys, xs]
        ml_sub = np.where(d == 4, 1, np.where(d == 8, 2, 3))
        mlp = np.where(k == 2, ml_sub, mlp)
        mlq = np.where(k == 2, ml_sub, mlq)
        mlp = np.where(ctb_edge, np.minimum(mlp, 3), mlp)
        qp = (t.qp[0][py, px].astype(np.int64) +
              t.qp[0][ys, xs].astype(np.int64) + 1) >> 1
    else:
        big = (sp >= 8) & (sq >= 8)
        mlq = np.where(big, 3, np.where(b == 2, 1, 0))
        mlp = np.where(big & ctb_edge, 1, mlq)
        keep = mlq > 0
        ys, xs, py, px, b, mlp, mlq, ctb_edge = (
            a[keep] for a in (ys, xs, py, px, b, mlp, mlq, ctb_edge))
        qpi = ((t.qp[0][py, px].astype(np.int64) +
                t.qp[0][ys, xs].astype(np.int64) + 1) >> 1) + cqp_off[c]
        off = 6 * (fr.bd - 8)
        qp = qp_c[c - 1][np.clip(qpi, -off, 63) + off]
    s = fr.slice4[ys, xs]
    beta = BETA[np.clip(qp + 2 * offs[s, c, 0], 0, 63)]
    tc = TC[np.clip(qp + 2 * (b - 1) + 2 * offs[s, c, 1], 0, 65)]
    keep = tc > 0
    return list(zip(*(a[keep].tolist() for a in
                      (xs, ys, beta, tc, mlp, mlq, ctb_edge))))


# ---------------------------------------------------------------------------
# SAO (8.8.4)

EO_DIRS = (((0, -1), (0, 1)), ((-1, 0), (1, 0)), ((-1, -1), (1, 1)),
           ((-1, 1), (1, -1)))      # (dy, dx) of the two neighbours a, b


def sao(fr: Frame):
    """SAO of the deblocked planes, in place."""
    t = fr.tabs
    if not t.sao_type.any():
        return
    pix_max = (1 << fr.bd) - 1
    for c in range(fr.ncomp):
        if not t.sao_type[:, c].any():
            continue
        s = 1 if c else 0
        src = fr.planes[c].astype(np.int64)
        H, W = src.shape
        out = src.copy()
        region = fr.ctb >> s
        # slice and tile of every sample, for the boundaries SAO keeps
        sl = np.repeat(np.repeat(fr.tabs.slice_idx, region, 0), region,
                       1)[:H, :W]
        ti = np.repeat(np.repeat(fr.tile_ctb, region, 0), region, 1)[:H, :W]
        pad = np.pad(src, 1, mode="edge")
        slp = np.pad(sl, 1, mode="edge")
        tip = np.pad(ti, 1, mode="edge")
        inside = np.pad(np.ones((H, W), bool), 1)
        for rs in range(fr.cw * fr.ch):
            typ = int(t.sao_type[rs, c])
            if typ == 0:
                continue
            ry, rx = divmod(rs, fr.cw)
            y0, x0 = ry * region, rx * region
            y1, x1 = min(y0 + region, H), min(x0 + region, W)
            blk = src[y0:y1, x0:x1]
            val = t.sao_offset[rs, c].astype(np.int64)   # SaoOffsetVal[0..4]
            if typ == 1:
                band = np.zeros(32, np.int64)
                pos = int(t.sao_band_pos[rs, c])
                for k in range(4):
                    band[(k + pos) & 31] = val[k + 1]
                res = blk + band[blk >> (fr.bd - 5)]
            else:
                cls = int(t.sao_eo_class[rs, c])
                sign_sum = np.zeros(blk.shape, np.int64)
                keep = np.zeros(blk.shape, bool)
                for dy, dx in EO_DIRS[cls]:
                    ys = slice(y0 + 1 + dy, y1 + 1 + dy)
                    xs = slice(x0 + 1 + dx, x1 + 1 + dx)
                    sign_sum += np.sign(blk - pad[ys, xs])
                    keep |= ~inside[ys, xs]
                    if not fr.across_slices:
                        keep |= slp[ys, xs] != sl[y0:y1, x0:x1]
                    if not fr.across_tiles:
                        keep |= tip[ys, xs] != ti[y0:y1, x0:x1]
                edge_idx = 2 + sign_sum
                # 8-236: 0, 1, 2 become 1, 2, 0
                edge_idx = np.where(edge_idx <= 2, (edge_idx + 1) % 3,
                                    edge_idx)
                res = np.where(keep, blk, blk + val[edge_idx])
            out[y0:y1, x0:x1] = np.clip(res, 0, pix_max)
        fr.planes[c][...] = out


# ---------------------------------------------------------------------------
# ALF and CC-ALF (8.8.5)


class AlfSets:
    """The filters of one ALF APS (7.4.3.18): luma coefficients and clip
    indices per class, the chroma alternatives, the CC-ALF filters."""

    def __init__(self, a):
        if a.alf_luma_filter_signal_flag:
            idx = [a.alf_luma_coeff_delta_idx[i] for i in range(25)]
            mag = np.array(a.alf_luma_coeff_abs, np.int64)
            sgn = np.array(a.alf_luma_coeff_sign, np.int64)
            coef = mag * (1 - 2 * sgn)
            self.luma = coef[idx]
            clip = np.array(a.alf_luma_clip_idx, np.int64) \
                if a.alf_luma_clip_flag else np.zeros_like(coef)
            self.luma_clip = clip[idx]
        if a.alf_chroma_filter_signal_flag:
            n = a.alf_chroma_num_alt_filters_minus1 + 1
            mag = np.array(a.alf_chroma_coeff_abs, np.int64)[:n]
            sgn = np.array(a.alf_chroma_coeff_sign, np.int64)[:n]
            self.chroma = mag * (1 - 2 * sgn)
            self.chroma_clip = np.array(a.alf_chroma_clip_idx, np.int64)[:n] \
                if a.alf_chroma_clip_flag else np.zeros_like(self.chroma)
        self.cc = [None, None]
        for k, p in enumerate(("cb", "cr")):
            if getattr(a, f"alf_cc_{p}_filter_signal_flag"):
                n = getattr(a, f"alf_cc_{p}_filters_signalled_minus1") + 1
                m = np.array(getattr(a, f"alf_cc_{p}_mapped_coeff_abs"),
                             np.int64)[:n]
                s = np.array(getattr(a, f"alf_cc_{p}_coeff_sign"),
                             np.int64)[:n]
                # 7-...: a mapped magnitude m > 0 stands for 2^(m-1)
                self.cc[k] = np.where(m > 0, (1 << np.maximum(m - 1, 0)) *
                                      (1 - 2 * s), 0)


def _clip_values(bd, idx):
    """AlfClip by clipping index (Table 8)."""
    return np.array([1 << bd, 1 << (bd - 3), 1 << (bd - 5),
                     1 << (bd - 7)], np.int64)[idx]


def _unfilterable(fr, rx, ry):
    """(left, top, right, bottom): the CTB's sides across which ALF pads
    (the picture's edges, tile and slice boundaries the PPS keeps
    unfiltered)."""
    si, ti = fr.tabs.slice_idx, fr.tile_ctb
    out = []
    for dx, dy, edge in ((-1, 0, rx == 0), (0, -1, ry == 0),
                         (1, 0, rx == fr.cw - 1), (0, 1, ry == fr.ch - 1)):
        if edge:
            out.append(True)
            continue
        nx, ny = rx + dx, ry + dy
        out.append((not fr.across_slices and si[ny, nx] != si[ry, rx]) or
                   (not fr.across_tiles and ti[ny, nx] != ti[ry, rx]))
    return out


def _window(plane, x0, y0, w, h, b, sides):
    """The CTB's samples with a border of b, padded by repetition across
    the sides that ALF does not filter across."""
    H, W = plane.shape
    ys = np.clip(np.arange(y0 - b, y0 + h + b), y0 if sides[1] else 0,
                 (y0 + h - 1) if sides[3] else H - 1)
    xs = np.clip(np.arange(x0 - b, x0 + w + b), x0 if sides[0] else 0,
                 (x0 + w - 1) if sides[2] else W - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


def _vb_reach(rows, vb, reach):
    """For CTB rows `rows`, how far (in rows) a filter may reach up and
    down without crossing the virtual boundary at row vb: rows next to it
    reach 0, the next 1, and so on, the same both ways."""
    d = np.where(rows < vb, vb - 1 - rows, rows - vb)
    return np.minimum(d, reach)


def _classify(win, w, h, vb, bd):
    """(filtIdx, transposeIdx) of every 4x4 block of a luma CTB (8.8.5.3);
    win has a border of 3."""
    b = 3
    # samples rows/cols -2 .. h+1 of the CTB, and their neighbours; rows
    # across the virtual boundary are replaced by the centre row
    r = np.arange(-2, h + 2)
    c = np.arange(-2, w + 2)
    up = np.where(r == vb, r, r - 1)
    dn = np.where(r == vb - 1, r, r + 1)
    g = lambda rr, cc: win[np.ix_(rr + b, cc + b)]
    cen = g(r, c) << 1
    lap_v = np.abs(cen - g(up, c) - g(dn, c))
    lap_h = np.abs(cen - g(r, c - 1) - g(r, c + 1))
    lap_d0 = np.abs(cen - g(up, c - 1) - g(dn, c + 1))
    lap_d1 = np.abs(cen - g(up, c + 1) - g(dn, c - 1))
    mask = ((r[:, None] + c[None, :]) & 1) == 0
    nby, nbx = h // 4, w // 4
    by = np.arange(nby)
    # rows of each block's window: -2..5, cut at the virtual boundary
    lo = np.where((by << 2) == vb, 0, -2)
    hi = np.where((by << 2) == vb - 4, 3, 5)
    ac = np.where(((by << 2) == vb) | ((by << 2) == vb - 4), 96, 64)
    sums = []
    for lap in (lap_v, lap_h, lap_d0, lap_d1):
        m = np.where(mask, lap, 0)
        # per 4x4 block: columns -2..5 of it, then rows lo..hi
        colsum = m.reshape(h + 4, (w + 4) // 4, 4).sum(2)
        colsum = colsum[:, :-1] + colsum[:, 1:]          # [h+4, nbx]
        cum = np.concatenate([np.zeros((1, nbx), np.int64),
                              np.cumsum(colsum, 0)])
        top = (by << 2) + lo + 2
        bot = (by << 2) + hi + 3
        sums.append(cum[bot] - cum[top])
    sv, sh, sd0, sd1 = sums
    hv1, hv0 = np.maximum(sv, sh), np.minimum(sv, sh)
    dir_hv = np.where(sv > sh, 1, 3)
    d1, d0 = np.maximum(sd0, sd1), np.minimum(sd0, sd1)
    dir_d = np.where(sd0 > sd1, 0, 2)
    d_wins = d1 * hv0 > hv1 * d0
    hvd1 = np.where(d_wins, d1, hv1)
    hvd0 = np.where(d_wins, d0, hv0)
    dir1 = np.where(d_wins, dir_d, dir_hv)
    dir2 = np.where(d_wins, dir_hv, dir_d)
    dir_s = np.where(hvd1 * 2 > 9 * hvd0, 2, np.where(hvd1 > 2 * hvd0, 1, 0))
    avg = np.clip(((sv + sh) * ac[:, None]) >> (bd + 4), 0, 15)
    filt = VAR_TAB[avg] + np.where(dir_s > 0,
                                   (((dir1 & 1) << 1) + dir_s) * 5, 0)
    transpose = TRANSPOSE_TABLE[dir1 * 2 + (dir2 >> 1)]
    return filt, transpose


def _diamond(win, b, w, h, taps, coef, clip, vb, near):
    """sum_k f_k * (clip(a_k - cur) + clip(b_k - cur)) for every sample of a
    CTB, each tap's reach in rows cut at the virtual boundary; coef and
    clip are [h, w, ntaps] or [ntaps]."""
    rows = np.arange(h)
    cols = np.arange(w)
    cur = win[b:b + h, b:b + w]
    acc = np.zeros((h, w), np.int64)
    for k, (dy, dx) in enumerate(taps):
        ry = np.sign(dy) * np.minimum(abs(dy), _vb_reach(rows, vb, abs(dy)))
        a = win[np.ix_(rows + b + ry, cols + b + dx)]
        bb = win[np.ix_(rows + b - ry, cols + b - dx)]
        ck = clip[..., k]
        acc += coef[..., k] * (np.clip(a - cur, -ck, ck) +
                               np.clip(bb - cur, -ck, ck))
    shift = np.where(near, 10, 7)[:, None]
    return cur + ((acc + (1 << (shift - 1))) >> shift)


def alf(fr: Frame, aps):
    """ALF and CC-ALF of the SAO output, in place; `aps` maps an ALF APS id
    to its raw syntax."""
    t = fr.tabs
    if not fr.sps.r.sps_alf_enabled_flag:
        return
    if not t.alf_ctb_flag.any() and not t.alf_cc_idc.any():
        return
    sets = {}

    def get(i):
        if i not in sets:
            sets[i] = AlfSets(aps[i])
        return sets[i]

    tables = D.tables()
    fixed = tables["alf_fix_filt_coeff"].astype(np.int64)
    class_map = tables["alf_class_to_filt_map"].astype(np.int64)
    pre = [p.copy() for p in fr.planes]
    bd, pix_max = fr.bd, (1 << fr.bd) - 1
    for rs in range(fr.cw * fr.ch):
        ry, rx = divmod(rs, fr.cw)
        sides = _unfilterable(fr, rx, ry)
        sh = fr.raw_sh(t.slice_idx[ry, rx])
        x0, y0 = rx * fr.ctb, ry * fr.ctb
        w, h = min(fr.ctb, fr.w - x0), min(fr.ctb, fr.h - y0)
        cc_on = fr.ncomp == 3 and t.alf_cc_idc[rs].any()
        if not t.alf_ctb_flag[rs].any() and not cc_on:
            continue
        lwin = _window(pre[0], x0, y0, w, h, 3, sides)
        vb = fr.ctb - VB_LUMA
        if t.alf_ctb_flag[rs, 0]:
            filt, tr = _classify(lwin, w, h, vb, bd)
            if t.alf_fixed[rs]:
                fset = int(t.alf_filt_idx[rs])
                cset = fixed[class_map[fset]]             # [25, 12]
                kset = np.zeros_like(cset)
            else:
                s = get(int(t.alf_aps_id[rs, 0]))
                cset, kset = s.luma, s.luma_clip
            order = COEF_ORDER[tr]                        # [nby, nbx, 12]
            coef = np.take_along_axis(cset[filt], order, 2)
            clip = _clip_values(bd, np.take_along_axis(kset[filt], order, 2))
            coef = np.repeat(np.repeat(coef, 4, 0), 4, 1)
            clip = np.repeat(np.repeat(clip, 4, 0), 4, 1)
            rows = np.arange(h)
            near = (rows == vb - 1) | (rows == vb)
            out = _diamond(lwin, 3, w, h, LUMA_TAPS, coef, clip, vb, near)
            fr.planes[0][y0:y0 + h, x0:x0 + w] = np.clip(out, 0, pix_max)
        for c in range(1, fr.ncomp):
            on = t.alf_ctb_flag[rs, c]
            idc = int(t.alf_cc_idc[rs, c - 1])
            if not on and not idc:
                continue
            xc, yc, wc, hc = x0 >> 1, y0 >> 1, w >> 1, h >> 1
            vbc = (fr.ctb >> 1) - VB_CHROMA
            if on:
                s = get(sh.sh_alf_aps_id_chroma)
                alt = int(t.alf_alt_idx[rs, c - 1])
                win = _window(pre[c], xc, yc, wc, hc, 2, sides)
                rows = np.arange(hc)
                near = (rows == vbc - 1) | (rows == vbc)
                res = np.clip(_diamond(win, 2, wc, hc, CHROMA_TAPS,
                                       s.chroma[alt],
                                       _clip_values(bd, s.chroma_clip[alt]),
                                       vbc, near), 0, pix_max)
            else:
                res = pre[c][yc:yc + hc, xc:xc + wc].astype(np.int64)
            if idc:
                cc_id = sh.sh_alf_cc_cb_aps_id if c == 1 else \
                    sh.sh_alf_cc_cr_aps_id
                f = get(cc_id).cc[c - 1][idc - 1]
                res = np.clip(res + _cross(lwin, wc, hc, vb, f, bd), 0,
                              pix_max)
            fr.planes[c][yc:yc + hc, xc:xc + wc] = res


def _cross(lwin, wc, hc, vb, f, bd):
    """The CC-ALF correction of a 4:2:0 chroma CTB from its luma window
    (border 3) (8.8.5.7)."""
    b = 3
    yl = np.arange(hc) << 1
    xl = np.arange(wc) << 1
    cur = lwin[np.ix_(yl + b, xl + b)]
    acc = np.zeros((hc, wc), np.int64)
    # rows reach over the virtual boundary: none next to it, one row down
    # from two rows above it
    reach_up = np.where((yl == vb) | (yl == vb - 1), 0, 1)
    reach_dn = np.where((yl == vb - 1) | (yl == vb), 0,
                        np.where((yl == vb - 2) | (yl == vb + 1), 1, 2))
    for k, (dy, dx) in enumerate(CC_TAPS):
        ry = np.where(dy < 0, -np.minimum(-dy, reach_up),
                      np.minimum(dy, reach_dn))
        s = lwin[np.ix_(yl + b + ry, xl + b + dx)]
        acc += int(f[k]) * (s - cur)
    half = 1 << (bd - 1)
    return np.clip((acc + 64) >> 7, -half, half - 1)
