"""Deblocking of the fused chain as batched segment math in plain PyTorch.

Port of `ffvvc_tpu/ops/deblock_device.py`: the host rasterizes one
parameter tuple per 4-line (luma) or 2/4-line (chroma) edge segment —
pixel-independent, from the golden Deblocker's boundary-strength walk —
and one pass per direction gathers every segment's tap window, takes the
long/strong/weak decisions and scatter-adds the masked deltas.  Per
direction the spec guarantees disjoint writes, which makes the whole frame
one data-parallel pass.

The scatter is `index_put_(..., accumulate=True)`: the segment batch is
padded with zero-delta segments that all land on index (0, 0), and only an
accumulating scatter is defined for duplicate indices.  A hand kernel for
this stage is ROADMAP.md queue 1 item 6.
"""
from __future__ import annotations

import numpy as np
import torch

from ffvvc_tpu.deblock import Deblocker

# padded (coef, tc_weight) rows indexed by (ml - 3) // 2  ->  ml in {3,5,7}
_COEF = np.array([[53, 32, 11, 0, 0, 0, 0],
                  [58, 45, 32, 19, 6, 0, 0],
                  [59, 50, 41, 32, 23, 14, 5]], np.int32)
_TCW = np.array([[6, 4, 2, 0, 0, 0, 0],
                 [6, 5, 4, 3, 2, 0, 0],
                 [6, 5, 4, 3, 2, 1, 1]], np.int32)


class _Rasterizer(Deblocker):
    """Collects per-segment filter parameters instead of filtering.
    Segments: luma (px, py, tc, beta, mlp, mlq, hor_ctu_edge) per 4 lines;
    chroma (px, py, tc, beta, mlp, mlq, size) per size lines."""

    def __init__(self, sps, pps, tabs, fb):
        super().__init__(sps, pps, tabs, fb)
        # force the Python per-edge walk (keep the C BS computation)
        self._ptr = dict(self._ptr)
        self._ptr["planes"] = [None, None, None]
        self.luma_segs = []
        self.chroma_segs = {1: [], 2: []}
        self._c_idx = 0

    def _filter_edge(self, c_idx, x, y, end, vertical, n, grid, beta_off,
                     tc_off, bs_tab, hor_ctu_edge):
        self._c_idx = c_idx
        # bypass the C per-edge fast path: temporarily drop the lib so the
        # base routine lands in our recording _filter_luma/_filter_chroma
        lib, self.lib = self.lib, None
        try:
            super()._filter_edge(c_idx, x, y, end, vertical, n, grid,
                                 beta_off, tc_off, bs_tab, hor_ctu_edge)
        finally:
            self.lib = lib

    def _filter_luma(self, plane, px, py, vertical, beta_a, tc_a, mlp_a,
                     mlq_a, hor_ctu_edge):
        bd = self.sps.bit_depth
        for i in range(2):
            tc0 = tc_a[i]
            tc = ((tc0 + (1 << (9 - bd))) >> (10 - bd)) if bd < 10 \
                else (tc0 << (bd - 10))
            if not tc:
                continue
            ex, ey = (px, py + i * 4) if vertical else (px + i * 4, py)
            self.luma_segs.append((ex, ey, tc, beta_a[i] << (bd - 8),
                                   mlp_a[i], mlq_a[i], int(hor_ctu_edge)))

    def _filter_chroma(self, plane, px, py, vertical, beta_a, tc_a, mlp_a,
                       mlq_a, shift):
        bd = self.sps.bit_depth
        size = 2 if shift else 4
        for i in range(8 // size):
            tc0 = tc_a[i]
            tc = ((tc0 + (1 << (9 - bd))) >> (10 - bd)) if bd < 10 \
                else (tc0 << (bd - 10))
            if not tc or not mlp_a[i] or not mlq_a[i]:
                continue
            ex, ey = (px, py + i * size) if vertical else \
                (px + i * size, py)
            self.chroma_segs[self._c_idx].append(
                (ex, ey, tc, beta_a[i] << (bd - 8), mlp_a[i], mlq_a[i],
                 size))


def _pad_pow2(n):
    p = 8
    while p < n:
        p <<= 1
    return p


def rasterize_deblock(sps, pps, tabs, fb, slice_rpls, vertical):
    """Host pass: per-segment deblock parameters for one direction
    (pixel-independent — BS/tc/beta/max-len come from the tab planes).
    Returns the populated _Rasterizer."""
    ras = _Rasterizer(sps, pps, tabs, fb)
    ras.slice_rpls = slice_rpls
    for ry in range(pps.ctb_height):
        for rx in range(pps.ctb_width):
            ras.deblock_ctb(rx, ry, vertical)
    return ras


def _take(a, idx):
    """a[b, idx[b], :] for a [B, K, L] and per-segment idx [B]."""
    B, _, L = a.shape
    return torch.gather(a, 1, idx.long()[:, None, None].expand(B, 1, L))[:, 0]


def _scatter_add(plane, srows, scols, delta):
    H, W = plane.shape
    srows = srows.expand(delta.shape).clamp(0, H - 1).reshape(-1)
    scols = scols.expand(delta.shape).clamp(0, W - 1).reshape(-1)
    return plane.index_put((srows, scols), delta.reshape(-1),
                           accumulate=True)


# ---- luma pass --------------------------------------------------------------

def luma_math(plane, px, py, tc, beta, mlp, mlq, hce, vertical: bool,
              pix_max: int):
    """One whole-frame luma deblock direction: [B] int32 segment params ->
    scatter-added deltas on int32 [H, W].  `deblock_device._luma_math`
    (single-device form)."""
    H, W = plane.shape
    dev = plane.device
    lines = torch.arange(4, device=dev)
    taps = torch.arange(16, device=dev)  # tap t: P(7-t) for t<8, Q(t-8) else
    if vertical:
        rows = py[:, None, None] + lines[None, :, None]
        cols = px[:, None, None] - 8 + taps[None, None, :]
    else:
        rows = py[:, None, None] - 8 + taps[None, None, :]
        cols = px[:, None, None] + lines[None, :, None]
    # win[b, line, tap]
    win = plane[rows.clamp(0, H - 1), cols.clamp(0, W - 1)]

    def P(k):                              # [B, 4]
        return win[:, :, 7 - k]

    def Q(k):
        return win[:, :, 8 + k]

    pa = torch.stack([P(k) for k in range(8)], dim=1)   # [B, 8, 4]
    qa = torch.stack([Q(k) for k in range(8)], dim=1)

    dp_l = torch.abs(P(2) - 2 * P(1) + P(0))            # [B, 4]
    dq_l = torch.abs(Q(2) - 2 * Q(1) + Q(0))
    dp0, dp3 = dp_l[:, 0], dp_l[:, 3]
    dq0, dq3 = dq_l[:, 0], dq_l[:, 3]
    d0 = dp0 + dq0
    d3 = dp3 + dq3
    tc25 = (tc * 5 + 1) >> 1
    large_p = (mlp > 3) & (hce == 0)
    large_q = mlq > 3
    beta_3 = beta >> 3
    beta_2 = beta >> 2

    # ---- long-filter decision (large branch) ----
    dpx_l = torch.abs(P(5) - 2 * P(4) + P(3))
    dqx_l = torch.abs(Q(5) - 2 * Q(4) + Q(3))
    dp0l = torch.where(large_p, (dp0 + dpx_l[:, 0] + 1) >> 1, dp0)
    dq0l = torch.where(large_q, (dq0 + dqx_l[:, 0] + 1) >> 1, dq0)
    dp3l = torch.where(large_p, (dp3 + dpx_l[:, 3] + 1) >> 1, dp3)
    dq3l = torch.where(large_q, (dq3 + dqx_l[:, 3] + 1) >> 1, dq3)
    d0l = dp0l + dq0l
    d3l = dp3l + dq3l
    beta53 = (beta * 3) >> 5
    beta_4 = beta >> 4
    ml_p = torch.where(large_p, mlp, 3)
    ml_q = torch.where(large_q, mlq, 3)
    p7term = torch.abs(P(7) - P(6) - P(5) + P(4))
    q7term = torch.abs(Q(4) - Q(5) - Q(6) + Q(7))
    sp_l = torch.abs(P(3) - P(0)) + \
        torch.where((ml_p == 7)[:, None], p7term, 0)
    sq_l = torch.abs(Q(0) - Q(3)) + \
        torch.where((ml_q == 7)[:, None], q7term, 0)
    p_mlp = _take(pa, ml_p)                             # [B, 4] = P(ml_p)
    q_mlq = _take(qa, ml_q)
    sp = torch.where(large_p[:, None],
                     (sp_l + torch.abs(P(3) - p_mlp) + 1) >> 1, sp_l)
    sq = torch.where(large_q[:, None],
                     (sq_l + torch.abs(Q(3) - q_mlq) + 1) >> 1, sq_l)
    abs_pq = torch.abs(P(0) - Q(0))
    use_large = ((large_p | large_q) & (d0l + d3l < beta) &
                 (sp[:, 0] + sq[:, 0] < beta53) & (abs_pq[:, 0] < tc25) &
                 (sp[:, 3] + sq[:, 3] < beta53) & (abs_pq[:, 3] < tc25) &
                 ((d0l << 1) < beta_4) & ((d3l << 1) < beta_4))

    # ---- strong / weak decisions ----
    pass_d = (d0 + d3 < beta) & ~use_large
    strong = (pass_d & (mlp > 2) & (mlq > 2) &
              (torch.abs(P(3) - P(0))[:, 0] + torch.abs(Q(3) - Q(0))[:, 0]
               < beta_3) & (abs_pq[:, 0] < tc25) &
              (torch.abs(P(3) - P(0))[:, 3] + torch.abs(Q(3) - Q(0))[:, 3]
               < beta_3) & (abs_pq[:, 3] < tc25) &
              ((d0 << 1) < beta_2) & ((d3 << 1) < beta_2))
    weak = pass_d & ~strong
    side_thr = (beta + (beta >> 1)) >> 3
    nd2 = (mlp > 1) & (mlq > 1)
    nd_p2 = nd2 & (dp0 + dp3 < side_thr)
    nd_q2 = nd2 & (dq0 + dq3 < side_thr)

    # ---- LARGE filter ----
    p, q = pa, qa                        # [B, 8, 4]
    m55 = (p[:, 4] + p[:, 3] + 2 * (p[:, 2] + p[:, 1] + p[:, 0] +
           q[:, 0] + q[:, 1] + q[:, 2]) + q[:, 3] + q[:, 4] + 8) >> 4
    m77 = (p[:, 6] + p[:, 5] + p[:, 4] + p[:, 3] + p[:, 2] + p[:, 1] +
           2 * (p[:, 0] + q[:, 0]) + q[:, 1] + q[:, 2] + q[:, 3] +
           q[:, 4] + q[:, 5] + q[:, 6] + 8) >> 4
    m12 = (p[:, 5] + p[:, 4] + p[:, 3] + p[:, 2] +
           2 * (p[:, 1] + p[:, 0] + q[:, 0] + q[:, 1]) + q[:, 2] +
           q[:, 3] + q[:, 4] + q[:, 5] + 8) >> 4
    m8 = (p[:, 3] + p[:, 2] + p[:, 1] + p[:, 0] + q[:, 0] + q[:, 1] +
          q[:, 2] + q[:, 3] + 4) >> 3
    m37 = (2 * (p[:, 2] + p[:, 1] + p[:, 0] + q[:, 0]) + p[:, 0] +
           p[:, 1] + q[:, 1] + q[:, 2] + q[:, 3] + q[:, 4] + q[:, 5] +
           q[:, 6] + 8) >> 4
    m73 = (p[:, 6] + p[:, 5] + p[:, 4] + p[:, 3] + p[:, 2] + p[:, 1] +
           2 * (q[:, 2] + q[:, 1] + q[:, 0] + p[:, 0]) + q[:, 0] +
           q[:, 1] + 8) >> 4
    mlp_e = ml_p[:, None]
    mlq_e = ml_q[:, None]
    m = torch.where((mlp_e == 5) & (mlq_e == 5), m55,
        torch.where(mlp_e == mlq_e, m77,
        torch.where(mlp_e + mlq_e == 12, m12,
        torch.where(mlp_e + mlq_e == 8, m8,
        torch.where(mlq_e == 7, m37, m73)))))
    p_ml1 = _take(pa, ml_p - 1)
    q_ml1 = _take(qa, ml_q - 1)
    refp = (p_mlp + p_ml1 + 1) >> 1
    refq = (q_mlq + q_ml1 + 1) >> 1
    coef = torch.from_numpy(_COEF).to(dev)
    tcw = torch.from_numpy(_TCW).to(dev)
    idx_p = ((ml_p - 3) >> 1).long()
    idx_q = ((ml_q - 3) >> 1).long()
    ks = torch.arange(7, device=dev)
    cp = coef[idx_p][:, :, None]                       # [B, 7, 1]
    cq = coef[idx_q][:, :, None]
    limp = ((tc[:, None] * tcw[idx_p]) >> 1)[:, :, None]
    limq = ((tc[:, None] * tcw[idx_q]) >> 1)[:, :, None]
    pk = pa[:, :7]                                     # [B, 7, 4]
    qk = qa[:, :7]
    dl_p = torch.clamp(((m[:, None, :] * cp + refp[:, None, :] * (64 - cp)
                         + 32) >> 6) - pk, -limp, limp)
    dl_q = torch.clamp(((m[:, None, :] * cq + refq[:, None, :] * (64 - cq)
                         + 32) >> 6) - qk, -limq, limq)
    kmask_p = (ks[None, :] < ml_p[:, None])[:, :, None]
    kmask_q = (ks[None, :] < ml_q[:, None])[:, :, None]
    dl_p = torch.where(kmask_p, dl_p, 0)
    dl_q = torch.where(kmask_q, dl_q, 0)

    # ---- STRONG filter ----
    tc_l = tc[:, None]
    tc2, tc3 = tc_l << 1, tc_l * 3
    p3, p2, p1, p0 = p[:, 3], p[:, 2], p[:, 1], p[:, 0]
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    ds_p0 = torch.clamp(((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0,
                        -tc3, tc3)
    ds_p1 = torch.clamp(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -tc2, tc2)
    ds_p2 = torch.clamp(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2,
                        -tc_l, tc_l)
    ds_q0 = torch.clamp(((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0,
                        -tc3, tc3)
    ds_q1 = torch.clamp(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, -tc2, tc2)
    ds_q2 = torch.clamp(((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2,
                        -tc_l, tc_l)

    # ---- WEAK filter ----
    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_apply = torch.abs(delta0) < 10 * tc_l            # per line
    dw = torch.clamp(delta0, -tc_l, tc_l)
    tc_2 = tc_l >> 1
    dw_p0 = torch.where(w_apply, torch.clamp(p0 + dw, 0, pix_max) - p0, 0)
    dw_q0 = torch.where(w_apply, torch.clamp(q0 - dw, 0, pix_max) - q0, 0)
    dwp1 = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + dw) >> 1, -tc_2, tc_2)
    dwq1 = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - dw) >> 1, -tc_2, tc_2)
    dw_p1 = torch.where(w_apply & nd_p2[:, None],
                        torch.clamp(p1 + dwp1, 0, pix_max) - p1, 0)
    dw_q1 = torch.where(w_apply & nd_q2[:, None],
                        torch.clamp(q1 + dwq1, 0, pix_max) - q1, 0)

    # ---- select per segment, build tap deltas [B, 14, 4] ----
    ul = use_large[:, None, None]
    st = strong[:, None, None]
    wk = weak[:, None, None]
    zero = torch.zeros_like(dl_p)
    strong_p = torch.cat(
        [torch.stack([ds_p0, ds_p1, ds_p2], dim=1), zero[:, 3:]], dim=1)
    strong_q = torch.cat(
        [torch.stack([ds_q0, ds_q1, ds_q2], dim=1), zero[:, 3:]], dim=1)
    weak_p = torch.cat(
        [torch.stack([dw_p0, dw_p1], dim=1), zero[:, 2:]], dim=1)
    weak_q = torch.cat(
        [torch.stack([dw_q0, dw_q1], dim=1), zero[:, 2:]], dim=1)
    dp = torch.where(ul, dl_p, torch.where(st, strong_p,
                     torch.where(wk, weak_p, 0)))
    dq = torch.where(ul, dl_q, torch.where(st, strong_q,
                     torch.where(wk, weak_q, 0)))
    # delta[t] for taps p6..q6: t 0..6 = P(6-t), t 7..13 = Q(t-7)
    delta = torch.cat([torch.flip(dp, dims=[1]), dq], dim=1)  # [B, 14, 4]

    # ---- scatter-add ----
    wtap = torch.arange(14, device=dev)
    if vertical:
        srows = py[:, None, None] + lines[None, None, :]          # [B,1,4]
        scols = px[:, None, None] - 7 + wtap[None, :, None]       # [B,14,1]
    else:
        srows = py[:, None, None] - 7 + wtap[None, :, None]
        scols = px[:, None, None] + lines[None, None, :]
    return _scatter_add(plane, srows, scols, delta)


# ---- chroma pass ------------------------------------------------------------

def chroma_math(plane, px, py, tc, beta, mlp, mlq, size, vertical: bool,
                pix_max: int):
    """One whole-frame chroma deblock direction.
    `deblock_device._chroma_math` (single-device form)."""
    H, W = plane.shape
    dev = plane.device
    lines = torch.arange(4, device=dev)    # padded; mask lines >= size
    taps = torch.arange(8, device=dev)     # P(3..0), Q(0..3)
    if vertical:
        rows = py[:, None, None] + lines[None, :, None]
        cols = px[:, None, None] - 4 + taps[None, None, :]
    else:
        rows = py[:, None, None] - 4 + taps[None, None, :]
        cols = px[:, None, None] + lines[None, :, None]
    win = plane[rows.clamp(0, H - 1), cols.clamp(0, W - 1)]

    ml1 = (mlp == 1)[:, None]

    def P(k):                              # raw taps: P(k) = win[..., 3-k]
        return win[:, :, 3 - k]

    def Q(k):
        return win[:, :, 4 + k]

    p0r, p1r, p2raw, p3raw = P(0), P(1), P(2), P(3)
    q0r, q1r, q2r, q3r = Q(0), Q(1), Q(2), Q(3)
    # the decision block substitutes P(2)/P(3) -> P(1) when max_len_p == 1
    # (deblock.py:908-921); the filters read the raw taps
    p2r = torch.where(ml1, p1r, p2raw)
    p3r = torch.where(ml1, p1r, p3raw)

    nline = torch.where(size == 2, 1, 3)   # decision line index
    line0 = torch.zeros_like(nline)

    def at(a, line):                       # [B] value at per-segment line
        return torch.gather(a, 1, line.long()[:, None])[:, 0]

    beta_3 = beta >> 3
    beta_2 = beta >> 2
    tc25 = (tc * 5 + 1) >> 1
    dp0 = torch.abs(at(p2r, line0) - 2 * at(p1r, line0) + at(p0r, line0))
    dq0 = torch.abs(at(q2r, line0) - 2 * at(q1r, line0) + at(q0r, line0))
    dp1 = torch.abs(at(p2r, nline) - 2 * at(p1r, nline) + at(p0r, nline))
    dq1 = torch.abs(at(q2r, nline) - 2 * at(q1r, nline) + at(q0r, nline))
    d0 = dp0 + dq0
    d1 = dp1 + dq1
    dsam0 = (((d0 << 1) < beta_2) &
             (torch.abs(at(p3r, line0) - at(p0r, line0)) +
              torch.abs(at(q0r, line0) - at(q3r, line0)) < beta_3) &
             (torch.abs(at(p0r, line0) - at(q0r, line0)) < tc25))
    dsam1 = (((d1 << 1) < beta_2) &
             (torch.abs(at(p3r, nline) - at(p0r, nline)) +
              torch.abs(at(q0r, nline) - at(q3r, nline)) < beta_3) &
             (torch.abs(at(p0r, nline) - at(q0r, nline)) < tc25))
    keep_3 = (mlq == 3) & (d0 + d1 < beta) & dsam0 & dsam1
    mlq_e = torch.where((mlq == 3) & ~keep_3, 1, mlq)
    mlp_e = torch.where((mlq == 3) & ~keep_3, 1, mlp)

    strong = (mlp_e == 3) & (mlq_e == 3)
    one_side = (mlq_e == 3) & ~strong
    tc_l = tc[:, None]

    # strong (both sides)
    s_p0 = torch.clamp((p3r + p2r + p1r + 2 * p0r + q0r + q1r + q2r + 4) >> 3,
                       p0r - tc_l, p0r + tc_l) - p0r
    s_p1 = torch.clamp((2 * p3r + p2r + 2 * p1r + p0r + q0r + q1r + 4) >> 3,
                       p1r - tc_l, p1r + tc_l) - p1r
    s_p2 = torch.clamp((3 * p3r + 2 * p2r + p1r + p0r + q0r + 4) >> 3,
                       p2r - tc_l, p2r + tc_l) - p2r
    s_q0 = torch.clamp((p2r + p1r + p0r + 2 * q0r + q1r + q2r + q3r + 4) >> 3,
                       q0r - tc_l, q0r + tc_l) - q0r
    s_q1 = torch.clamp((p1r + p0r + q0r + 2 * q1r + q2r + 2 * q3r + 4) >> 3,
                       q1r - tc_l, q1r + tc_l) - q1r
    s_q2 = torch.clamp((p0r + q0r + q1r + 2 * q2r + 3 * q3r + 4) >> 3,
                       q2r - tc_l, q2r + tc_l) - q2r

    # one-side strong (P taps unsubstituted: only p1/p0 used)
    o_p0 = torch.clamp((3 * p1r + 2 * p0r + q0r + q1r + q2r + 4) >> 3,
                       p0r - tc_l, p0r + tc_l) - p0r
    o_q0 = torch.clamp((2 * p1r + p0r + 2 * q0r + q1r + q2r + q3r + 4) >> 3,
                       q0r - tc_l, q0r + tc_l) - q0r
    o_q1 = torch.clamp((p1r + p0r + q0r + 2 * q1r + q2r + 2 * q3r + 4) >> 3,
                       q1r - tc_l, q1r + tc_l) - q1r
    o_q2 = torch.clamp((p0r + q0r + q1r + 2 * q2r + 3 * q3r + 4) >> 3,
                       q2r - tc_l, q2r + tc_l) - q2r

    # weak
    dlt = torch.clamp((((q0r - p0r) * 4) + p1r - q1r + 4) >> 3, -tc_l, tc_l)
    w_p0 = torch.clamp(p0r + dlt, 0, pix_max) - p0r
    w_q0 = torch.clamp(q0r - dlt, 0, pix_max) - q0r

    st = strong[:, None]
    os_ = one_side[:, None]
    d_p0 = torch.where(st, s_p0, torch.where(os_, o_p0, w_p0))
    d_p1 = torch.where(st, s_p1, 0)
    d_p2 = torch.where(st, s_p2, 0)
    d_q0 = torch.where(st, s_q0, torch.where(os_, o_q0, w_q0))
    d_q1 = torch.where(st, s_q1, torch.where(os_, o_q1, 0))
    d_q2 = torch.where(st, s_q2, torch.where(os_, o_q2, 0))

    lmask = lines[None, :] < size[:, None]
    zero = torch.zeros_like(d_p0)
    delta = torch.stack([zero, d_p2, d_p1, d_p0, d_q0, d_q1, d_q2, zero],
                        dim=1)             # [B, 8, 4] taps p3..q3
    delta = torch.where(lmask[:, None, :], delta, 0)

    wtap = torch.arange(8, device=dev)
    if vertical:
        srows = py[:, None, None] + lines[None, None, :]
        scols = px[:, None, None] - 4 + wtap[None, :, None]
    else:
        srows = py[:, None, None] - 4 + wtap[None, :, None]
        scols = px[:, None, None] + lines[None, None, :]
    return _scatter_add(plane, srows, scols, delta)
