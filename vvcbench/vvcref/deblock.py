# Frozen copy of ffvvc_tpu_torch/deblock.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: only the sample filters
#   are kept (`_Edge`, `_filter_luma` and `_filter_chroma` with the filters
#   they call); the edge walk, the boundary strength, tC, beta and the
#   filter lengths are the benchmark's own (`inloop.py`), and the C
#   deblocking library (`native/deblock.py`) is gone.
"""Golden deblocking sample filters (H.266 8.8.3.6), scalar NumPy model.

Reference analogue: vvc_filter_template.c / h2656_deblock_template.c of
libavcodec (luma strong/weak/large, chroma strong/one-side/weak filters).
"""
from __future__ import annotations

import numpy as np


class _Edge:
    """Sample accessor for one 8-line (or 4/2-line) edge segment.

    For vertical edges: x advances across the edge (xstride=1 in plane),
    lines advance down.  For horizontal edges the roles swap.
    """
    __slots__ = ("plane", "x", "y", "vertical")

    def __init__(self, plane, x, y, vertical):
        self.plane = plane
        self.x = x
        self.y = y
        self.vertical = vertical

    def get(self, off, line):
        if self.vertical:
            return int(self.plane[self.y + line, self.x + off])
        return int(self.plane[self.y + off, self.x + line])

    def set(self, off, line, v):
        if self.vertical:
            self.plane[self.y + line, self.x + off] = v
        else:
            self.plane[self.y + off, self.x + line] = v

    def vget(self, off, n):
        """All n lines at offset `off` as an int64 vector."""
        if self.vertical:
            return self.plane[self.y:self.y + n, self.x + off].astype(np.int64)
        return self.plane[self.y + off, self.x:self.x + n].astype(np.int64)

    def vset(self, off, v, n):
        if self.vertical:
            self.plane[self.y:self.y + n, self.x + off] = v
        else:
            self.plane[self.y + off, self.x:self.x + n] = v


class Deblocker:
    """The sample filters of one edge segment; which segments are filtered,
    and with what tC, beta and filter lengths, is decided in `inloop.py`."""

    def __init__(self, sps, pps, tabs, fb):
        self.sps = sps
        self.pixel_max = (1 << sps.bit_depth) - 1

    # --- pixel filters -------------------------------------------------------

    def _filter_luma(self, plane, px, py, vertical, beta_a, tc_a, mlp_a, mlq_a,
                     hor_ctu_edge):
        bd = self.sps.bit_depth
        for i in range(2):
            tc0 = tc_a[i]
            if bd < 10:
                tc = (tc0 + (1 << (9 - bd))) >> (10 - bd)
            else:
                tc = tc0 << (bd - 10)
            if not tc:
                continue
            e = _Edge(plane, px, py + i * 4, vertical) if vertical else \
                _Edge(plane, px + i * 4, py, vertical)
            P = lambda k, line: e.get(-k - 1, line)
            Q = lambda k, line: e.get(k, line)
            dp0 = abs(P(2, 0) - 2 * P(1, 0) + P(0, 0))
            dq0 = abs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0))
            dp3 = abs(P(2, 3) - 2 * P(1, 3) + P(0, 3))
            dq3 = abs(Q(2, 3) - 2 * Q(1, 3) + Q(0, 3))
            d0 = dp0 + dq0
            d3 = dp3 + dq3
            tc25 = (tc * 5 + 1) >> 1
            max_len_p = mlp_a[i]
            max_len_q = mlq_a[i]
            large_p = max_len_p > 3 and not hor_ctu_edge
            large_q = max_len_q > 3
            beta = beta_a[i] << (bd - 8)
            beta_3 = beta >> 3
            beta_2 = beta >> 2
            if large_p or large_q:
                dp0l = ((dp0 + abs(P(5, 0) - 2 * P(4, 0) + P(3, 0)) + 1) >> 1) \
                    if large_p else dp0
                dq0l = ((dq0 + abs(Q(5, 0) - 2 * Q(4, 0) + Q(3, 0)) + 1) >> 1) \
                    if large_q else dq0
                dp3l = ((dp3 + abs(P(5, 3) - 2 * P(4, 3) + P(3, 3)) + 1) >> 1) \
                    if large_p else dp3
                dq3l = ((dq3 + abs(Q(5, 3) - 2 * Q(4, 3) + Q(3, 3)) + 1) >> 1) \
                    if large_q else dq3
                d0l = dp0l + dq0l
                d3l = dp3l + dq3l
                beta53 = beta * 3 >> 5
                beta_4 = beta >> 4
                ml_p = max_len_p if large_p else 3
                ml_q = max_len_q if large_q else 3
                if d0l + d3l < beta:
                    sp0l = abs(P(3, 0) - P(0, 0)) + \
                        (abs(P(7, 0) - P(6, 0) - P(5, 0) + P(4, 0)) if ml_p == 7 else 0)
                    sq0l = abs(Q(0, 0) - Q(3, 0)) + \
                        (abs(Q(4, 0) - Q(5, 0) - Q(6, 0) + Q(7, 0)) if ml_q == 7 else 0)
                    sp3l = abs(P(3, 3) - P(0, 3)) + \
                        (abs(P(7, 3) - P(6, 3) - P(5, 3) + P(4, 3)) if ml_p == 7 else 0)
                    sq3l = abs(Q(0, 3) - Q(3, 3)) + \
                        (abs(Q(4, 3) - Q(5, 3) - Q(6, 3) + Q(7, 3)) if ml_q == 7 else 0)
                    sp0 = ((sp0l + abs(P(3, 0) - P(ml_p, 0)) + 1) >> 1) if large_p else sp0l
                    sp3 = ((sp3l + abs(P(3, 3) - P(ml_p, 3)) + 1) >> 1) if large_p else sp3l
                    sq0 = ((sq0l + abs(Q(3, 0) - Q(ml_q, 0)) + 1) >> 1) if large_q else sq0l
                    sq3 = ((sq3l + abs(Q(3, 3) - Q(ml_q, 3)) + 1) >> 1) if large_q else sq3l
                    if sp0 + sq0 < beta53 and abs(P(0, 0) - Q(0, 0)) < tc25 and \
                            sp3 + sq3 < beta53 and abs(P(0, 3) - Q(0, 3)) < tc25 and \
                            (d0l << 1) < beta_4 and (d3l << 1) < beta_4:
                        self._luma_large(e, tc, ml_p, ml_q)
                        continue
            if d0 + d3 < beta:
                if max_len_p > 2 and max_len_q > 2 and \
                        abs(P(3, 0) - P(0, 0)) + abs(Q(3, 0) - Q(0, 0)) < beta_3 and \
                        abs(P(0, 0) - Q(0, 0)) < tc25 and \
                        abs(P(3, 3) - P(0, 3)) + abs(Q(3, 3) - Q(0, 3)) < beta_3 and \
                        abs(P(0, 3) - Q(0, 3)) < tc25 and \
                        (d0 << 1) < beta_2 and (d3 << 1) < beta_2:
                    self._luma_strong(e, tc)
                else:
                    nd_p = nd_q = 1
                    if max_len_p > 1 and max_len_q > 1:
                        if dp0 + dp3 < ((beta + (beta >> 1)) >> 3):
                            nd_p = 2
                        if dq0 + dq3 < ((beta + (beta >> 1)) >> 3):
                            nd_q = 2
                    self._luma_weak(e, tc, nd_p, nd_q)

    def _luma_large(self, e, tc, ml_p, ml_q):
        if True:
            p = [e.vget(-k - 1, 4) for k in range(8)]
            q = [e.vget(k, 4) for k in range(8)]
            if ml_p == 5 and ml_q == 5:
                m = (p[4] + p[3] + 2 * (p[2] + p[1] + p[0] + q[0] + q[1] + q[2])
                     + q[3] + q[4] + 8) >> 4
            elif ml_p == ml_q:
                m = (p[6] + p[5] + p[4] + p[3] + p[2] + p[1] +
                     2 * (p[0] + q[0]) + q[1] + q[2] + q[3] + q[4] + q[5] +
                     q[6] + 8) >> 4
            elif ml_p + ml_q == 12:
                m = (p[5] + p[4] + p[3] + p[2] +
                     2 * (p[1] + p[0] + q[0] + q[1]) + q[2] + q[3] + q[4] +
                     q[5] + 8) >> 4
            elif ml_p + ml_q == 8:
                m = (p[3] + p[2] + p[1] + p[0] + q[0] + q[1] + q[2] + q[3] + 4) >> 3
            elif ml_q == 7:
                m = (2 * (p[2] + p[1] + p[0] + q[0]) + p[0] + p[1] + q[1] +
                     q[2] + q[3] + q[4] + q[5] + q[6] + 8) >> 4
            else:
                m = (p[6] + p[5] + p[4] + p[3] + p[2] + p[1] +
                     2 * (q[2] + q[1] + q[0] + p[0]) + q[0] + q[1] + 8) >> 4
            refp = (p[ml_p] + p[ml_p - 1] + 1) >> 1
            refq = (q[ml_q] + q[ml_q - 1] + 1) >> 1
            coef = {3: (53, 32, 11), 5: (58, 45, 32, 19, 6),
                    7: (59, 50, 41, 32, 23, 14, 5)}
            cp = coef[ml_p]
            tc_w_p = {3: (6, 4, 2), 5: (6, 5, 4, 3, 2),
                      7: (6, 5, 4, 3, 2, 1, 1)}[ml_p]
            for k in range(ml_p):
                lim = tc * tc_w_p[k] >> 1
                v = p[k] + np.clip(((m * cp[k] + refp * (64 - cp[k]) + 32)
                                    >> 6) - p[k], -lim, lim)
                e.vset(-k - 1, v, 4)
            cq = coef[ml_q]
            tc_w_q = {3: (6, 4, 2), 5: (6, 5, 4, 3, 2),
                      7: (6, 5, 4, 3, 2, 1, 1)}[ml_q]
            for k in range(ml_q):
                lim = tc * tc_w_q[k] >> 1
                v = q[k] + np.clip(((m * cq[k] + refq * (64 - cq[k]) + 32)
                                    >> 6) - q[k], -lim, lim)
                e.vset(k, v, 4)

    def _luma_strong(self, e, tc):
        tc2, tc3 = tc << 1, tc * 3
        p3, p2, p1, p0 = (e.vget(-4, 4), e.vget(-3, 4), e.vget(-2, 4),
                          e.vget(-1, 4))
        q0, q1, q2, q3 = (e.vget(0, 4), e.vget(1, 4), e.vget(2, 4),
                          e.vget(3, 4))
        e.vset(-1, p0 + np.clip(((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0, -tc3, tc3), 4)
        e.vset(-2, p1 + np.clip(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -tc2, tc2), 4)
        e.vset(-3, p2 + np.clip(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2, -tc, tc), 4)
        e.vset(0, q0 + np.clip(((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0, -tc3, tc3), 4)
        e.vset(1, q1 + np.clip(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, -tc2, tc2), 4)
        e.vset(2, q2 + np.clip(((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2, -tc, tc), 4)

    def _luma_weak(self, e, tc, nd_p, nd_q):
        mx = self.pixel_max
        tc_2 = tc >> 1
        p2, p1, p0 = e.vget(-3, 4), e.vget(-2, 4), e.vget(-1, 4)
        q0, q1, q2 = e.vget(0, 4), e.vget(1, 4), e.vget(2, 4)
        delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        apply = np.abs(delta0) < 10 * tc
        d0 = np.clip(delta0, -tc, tc)
        e.vset(-1, np.where(apply, np.clip(p0 + d0, 0, mx), p0), 4)
        e.vset(0, np.where(apply, np.clip(q0 - d0, 0, mx), q0), 4)
        if nd_p > 1:
            dp1 = np.clip((((p2 + p0 + 1) >> 1) - p1 + d0) >> 1, -tc_2, tc_2)
            e.vset(-2, np.where(apply, np.clip(p1 + dp1, 0, mx), p1), 4)
        if nd_q > 1:
            dq1 = np.clip((((q2 + q0 + 1) >> 1) - q1 - d0) >> 1, -tc_2, tc_2)
            e.vset(1, np.where(apply, np.clip(q1 + dq1, 0, mx), q1), 4)

    def _filter_chroma(self, plane, px, py, vertical, beta_a, tc_a, mlp_a,
                       mlq_a, shift):
        bd = self.sps.bit_depth
        size = 2 if shift else 4
        end = 8 // size
        for i in range(end):
            tc0 = tc_a[i]
            if bd < 10:
                tc = (tc0 + (1 << (9 - bd))) >> (10 - bd)
            else:
                tc = tc0 << (bd - 10)
            if not tc:
                continue
            e = _Edge(plane, px, py + i * size, vertical) if vertical else \
                _Edge(plane, px + i * size, py, vertical)
            max_len_p = mlp_a[i]
            max_len_q = mlq_a[i]
            if not max_len_p or not max_len_q:
                continue
            beta = beta_a[i] << (bd - 8)
            beta_3 = beta >> 3
            beta_2 = beta >> 2
            tc25 = (tc * 5 + 1) >> 1
            P = lambda k, line: e.get(-k - 1, line)
            Q = lambda k, line: e.get(k, line)
            if max_len_q == 3:
                nline = 1 if shift else 3
                p1n = P(1, nline)
                p2n = P(1, nline) if max_len_p == 1 else P(2, nline)
                p0n = P(0, nline)
                q0n, q1n, q2n = Q(0, nline), Q(1, nline), Q(2, nline)
                p3 = P(1, 0) if max_len_p == 1 else P(3, 0)
                p2 = P(1, 0) if max_len_p == 1 else P(2, 0)
                p1, p0 = P(1, 0), P(0, 0)
                dp0 = abs(p2 - 2 * p1 + p0)
                dq0 = abs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0))
                dp1 = abs(p2n - 2 * p1n + p0n)
                dq1 = abs(q2n - 2 * q1n + q0n)
                d0 = dp0 + dq0
                d1 = dp1 + dq1
                if d0 + d1 < beta:
                    p3n = p1n if max_len_p == 1 else P(3, nline)
                    q3n = Q(3, nline)
                    dsam0 = (d0 << 1) < beta_2 and \
                        (abs(p3 - p0) + abs(Q(0, 0) - Q(3, 0)) < beta_3) and \
                        abs(p0 - Q(0, 0)) < tc25
                    dsam1 = (d1 << 1) < beta_2 and \
                        (abs(p3n - p0n) + abs(q0n - q3n) < beta_3) and \
                        abs(p0n - q0n) < tc25
                    if not dsam0 or not dsam1:
                        max_len_p = max_len_q = 1
                else:
                    max_len_p = max_len_q = 1
            if max_len_p == 3 and max_len_q == 3:
                self._chroma_strong(e, size, tc)
            elif max_len_q == 3:
                self._chroma_strong_one_side(e, size, tc)
            else:
                self._chroma_weak(e, size, tc)

    def _chroma_strong(self, e, size, tc):
        n = size
        p3, p2, p1, p0 = (e.vget(-4, n), e.vget(-3, n), e.vget(-2, n),
                          e.vget(-1, n))
        q0, q1, q2, q3 = (e.vget(0, n), e.vget(1, n), e.vget(2, n),
                          e.vget(3, n))
        e.vset(-1, np.clip((p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
                           p0 - tc, p0 + tc), n)
        e.vset(-2, np.clip((2 * p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
                           p1 - tc, p1 + tc), n)
        e.vset(-3, np.clip((3 * p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
                           p2 - tc, p2 + tc), n)
        e.vset(0, np.clip((p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
                          q0 - tc, q0 + tc), n)
        e.vset(1, np.clip((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3,
                          q1 - tc, q1 + tc), n)
        e.vset(2, np.clip((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3,
                          q2 - tc, q2 + tc), n)

    def _chroma_strong_one_side(self, e, size, tc):
        n = size
        p1, p0 = e.vget(-2, n), e.vget(-1, n)
        q0, q1, q2, q3 = (e.vget(0, n), e.vget(1, n), e.vget(2, n),
                          e.vget(3, n))
        e.vset(-1, np.clip((3 * p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
                           p0 - tc, p0 + tc), n)
        e.vset(0, np.clip((2 * p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
                          q0 - tc, q0 + tc), n)
        e.vset(1, np.clip((p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3,
                          q1 - tc, q1 + tc), n)
        e.vset(2, np.clip((p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3,
                          q2 - tc, q2 + tc), n)

    def _chroma_weak(self, e, size, tc):
        mx = self.pixel_max
        n = size
        p1, p0 = e.vget(-2, n), e.vget(-1, n)
        q0, q1 = e.vget(0, n), e.vget(1, n)
        delta0 = np.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc)
        e.vset(-1, np.clip(p0 + delta0, 0, mx), n)
        e.vset(0, np.clip(q0 - delta0, 0, mx), n)
