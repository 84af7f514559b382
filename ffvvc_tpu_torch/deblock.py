"""Golden deblocking filter (H.266 8.8.3), scalar NumPy model.

Whole-picture two-pass structure per spec: all vertical edges first, then all
horizontal edges.  Reference analogue: libavcodec/vvc/
vvc_filter.c (boundary_strength :308, bs derivation :399-783, drivers
:861-1000) and vvc_filter_template.c / h2656_deblock_template.c (luma
strong/weak/large, chroma strong/one-side/weak filters).
"""
from __future__ import annotations

import ctypes

import numpy as np

from .ctu import MODE_INTRA, LUMA, CB, CR
from .native import deblock as _native

DEBLOCK_STEP = 8
LUMA_GRID = 4
CHROMA_GRID = 8
DEFAULT_INTRA_TC_OFFSET = 2

TC_TABLE = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 3, 4, 4, 4, 4, 5, 5, 5, 5, 7, 7, 8, 9, 10,
    10, 11, 13, 14, 15, 17, 19, 21, 24, 25, 29, 33, 36, 41, 45, 51,
    57, 64, 71, 80, 89, 100, 112, 125, 141, 157, 177, 198, 222, 250, 280, 314,
    352, 395)
BETA_TABLE = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88)


def clip(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


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
    def __init__(self, sps, pps, tabs, fb):
        self.sps = sps
        self.pps = pps
        self.tabs = tabs
        self.fb = fb
        h4 = tabs.h4
        w4 = tabs.w4
        g = lambda: np.zeros((h4, w4), dtype=np.int32)
        self.slice_rpls = []   # per-slice [RefPicList, RefPicList]
        self.vertical_bs = [g(), g(), g()]
        self.horizontal_bs = [g(), g(), g()]
        self.vertical_p = g()
        self.vertical_q = g()
        self.horizontal_p = g()
        self.horizontal_q = g()
        self.pixel_max = (1 << sps.bit_depth) - 1
        self.lib = _native.load_lib()
        if sps.num_ladf_intervals:
            self._ladf_offsets = np.ascontiguousarray(
                sps.r.sps_ladf_qp_offset, dtype=np.int32)
            self._ladf_bounds = np.ascontiguousarray(
                sps.ladf_interval_lower_bound, dtype=np.int32)
        else:
            self._ladf_offsets = self._ladf_bounds = \
                np.zeros(1, dtype=np.int32)
        p = _native.as_i32p
        self._ptr = {
            "planes": [p(pl) if pl.dtype == np.int32 and
                       pl.flags.c_contiguous else None for pl in fb.planes],
            "vbs": [p(t) for t in self.vertical_bs],
            "hbs": [p(t) for t in self.horizontal_bs],
            "vp": p(self.vertical_p), "vq": p(self.vertical_q),
            "hp": p(self.horizontal_p), "hq": p(self.horizontal_q),
            "qp": [p(t) for t in tabs.qp[:3]],
            "tbw": p(tabs.tb_width[1]), "tbh": p(tabs.tb_height[1]),
            "ladf_off": p(self._ladf_offsets),
            "ladf_bnd": p(self._ladf_bounds),
        }

    # --- frame entry --------------------------------------------------------

    def _build_bs_ctx(self):
        """Assemble the native BsCtx over the frame's tab planes + RPL POCs
        (valid for one frame; slice_rpls must be final)."""
        import ctypes as ct
        sps, pps, tabs = self.sps, self.pps, self.tabs
        needed = [tabs.tu_coded_flag[0], tabs.tu_joint_cbcr, tabs.msf]
        if any(a.dtype != np.int32 or not a.flags.c_contiguous
               for a in needed):
            return None
        n = max(1, len(self.slice_rpls))
        rp = np.zeros((n, 2, 17), dtype=np.int32)
        for si, rpl in enumerate(self.slice_rpls):
            for lx in (0, 1):
                pl = list(rpl[lx].poc_list)
                rp[si, lx, :len(pl)] = pl
        self._rpl_poc = rp  # keep alive
        p32 = lambda a: _native.as_ptr(a, _native._I32P)
        ctx = _native.BsCtx(
            tb_pos_x0=p32(tabs.tb_pos_x[0]), tb_pos_y0=p32(tabs.tb_pos_y[0]),
            tb_w0=p32(tabs.tb_width[0]), tb_h0=p32(tabs.tb_height[0]),
            tb_pos_x1=p32(tabs.tb_pos_x[1]), tb_pos_y1=p32(tabs.tb_pos_y[1]),
            tb_w1=p32(tabs.tb_width[1]), tb_h1=p32(tabs.tb_height[1]),
            mvf_pf=_native.as_ptr(tabs.mvf_pf, _native._U8P),
            mvf_ciip=_native.as_ptr(tabs.mvf_ciip, _native._I8P),
            mvf_mv=p32(tabs.mvf_mv),
            mvf_ref=_native.as_ptr(tabs.mvf_ref, _native._I8P),
            tu_coded0=p32(tabs.tu_coded_flag[0]),
            tu_coded1=p32(tabs.tu_coded_flag[1]),
            tu_coded2=p32(tabs.tu_coded_flag[2]),
            tu_joint=p32(tabs.tu_joint_cbcr),
            pcmf0=p32(tabs.pcmf[0]), pcmf1=p32(tabs.pcmf[1]),
            cb_pos_x=p32(tabs.cb_pos_x[0]), cb_pos_y=p32(tabs.cb_pos_y[0]),
            cb_w=p32(tabs.cb_width[0]), cb_h=p32(tabs.cb_height[0]),
            msf=p32(tabs.msf), iaf=p32(tabs.iaf),
            slice_idx=p32(tabs.slice_idx), rpl_poc=p32(rp),
            vbs0=p32(self.vertical_bs[0]), vbs1=p32(self.vertical_bs[1]),
            vbs2=p32(self.vertical_bs[2]),
            hbs0=p32(self.horizontal_bs[0]), hbs1=p32(self.horizontal_bs[1]),
            hbs2=p32(self.horizontal_bs[2]),
            vp=p32(self.vertical_p), vq=p32(self.vertical_q),
            hp=p32(self.horizontal_p), hq=p32(self.horizontal_q),
            w4=tabs.w4, h4=tabs.h4, max_refs=17,
            ctb_size=sps.ctb_size_y, ctb_log2=sps.ctb_log2_size_y,
            ctb_width=pps.ctb_width, pic_w=pps.width, pic_h=pps.height,
            lf_slices=int(pps.r.pps_loop_filter_across_slices_enabled_flag),
            lf_tiles=int(pps.r.pps_loop_filter_across_tiles_enabled_flag),
            hs1=sps.hshift[1], vs1=sps.vshift[1],
            chroma=int(bool(sps.chroma_format_idc)))
        return ctx

    def deblock_frame(self):
        pps = self.pps
        self._bs_ctx = self._build_bs_ctx() if self.lib is not None else None
        if self._bs_ctx is not None and self._frame_driver():
            return
        for vertical in (True, False):
            for ry in range(pps.ctb_height):
                for rx in range(pps.ctb_width):
                    rs = ry * pps.ctb_width + rx
                    if not self.tabs.deblock_disabled[rs]:
                        self.deblock_ctb(rx, ry, vertical)

    def frame_ctx(self):
        """Build the C frame contexts for row-range driving (deblock_rows);
        returns False when ineligible (non-contiguous planes / no lib)."""
        if self.lib is None:
            return False
        self._bs_ctx = self._build_bs_ctx()
        if self._bs_ctx is None:
            return False
        return self._build_frame_ctx()

    def deblock_rows(self, vertical, lo, hi):
        """One deblock direction over CTB rows [lo, hi) — the row-pipeline
        form of deblock_frame (the H pass of row r writes into row r-1's
        bottom taps, so callers sequence V(r) before H(r) and treat row
        r-1 as final only after H(r))."""
        self.lib.deblock_frame_range(
            ctypes.byref(self._bs_ctx), ctypes.byref(self._f),
            int(vertical), lo, hi, 0, self.pps.ctb_width)

    def _frame_driver(self):
        """Whole-frame C deblock (deblock_frame_c); False when a plane is
        not int32-contiguous (golden/odd layouts) so the per-CTB path runs."""
        if not self._build_frame_ctx():
            return False
        pps = self.pps
        cref, fref = ctypes.byref(self._bs_ctx), ctypes.byref(self._f)
        nt = getattr(self, "n_threads", 1)
        if nt > 1 and pps.ctb_width * pps.ctb_height >= 4:
            # vertical-edge pass shards by CTB rows, horizontal-edge pass by
            # CTB columns (each only writes pixels of its own rows/columns)
            from .threads import run_parallel, split_ranges
            part = self.lib.deblock_frame_part
            run_parallel(nt, [
                (lambda lo=lo, hi=hi: part(cref, fref, 1, lo, hi))
                for lo, hi in split_ranges(pps.ctb_height, nt)])
            run_parallel(nt, [
                (lambda lo=lo, hi=hi: part(cref, fref, 0, lo, hi))
                for lo, hi in split_ranges(pps.ctb_width, nt)])
        else:
            self.lib.deblock_frame_c(cref, fref)
        return True

    def _build_frame_ctx(self):
        sps, pps, tabs = self.sps, self.pps, self.tabs
        ptr = self._ptr
        if any(p is None for p in
               ptr["planes"][:3 if sps.chroma_format_idc else 1]):
            return False
        from .native import deblock as _nd
        f = _nd.DeblockFrame()
        f.plane0 = ptr["planes"][0]
        if sps.chroma_format_idc:
            f.plane1, f.plane2 = ptr["planes"][1], ptr["planes"][2]
        f.qp0, f.qp1, f.qp2 = ptr["qp"]
        keep = [np.ascontiguousarray(tabs.deblock_disabled),
                np.ascontiguousarray(tabs.deblock_beta),
                np.ascontiguousarray(tabs.deblock_tc),
                np.ascontiguousarray(np.asarray(pps.ctb_to_col_bd, np.int32)),
                np.ascontiguousarray(np.asarray(pps.ctb_to_row_bd, np.int32))]
        self._frame_keep = keep
        p = _native.as_i32p
        f.dis, f.beta, f.tc = p(keep[0]), p(keep[1]), p(keep[2])
        f.col_bd, f.row_bd = p(keep[3]), p(keep[4])
        f.ctb_w, f.ctb_h = pps.ctb_width, pps.ctb_height
        f.qp_bd_offset = sps.qp_bd_offset
        f.bd = sps.bit_depth
        f.pixel_max = self.pixel_max
        f.n_ladf = sps.num_ladf_intervals
        f.ladf_lowest = int(getattr(
            sps.r, "sps_ladf_lowest_interval_qp_offset", 0) or 0)
        f.ladf_off, f.ladf_bnd = ptr["ladf_off"], ptr["ladf_bnd"]
        self._f = f
        return True

    def _boundary_flags(self, rx, ry):
        pps = self.pps
        tabs = self.tabs
        rs = ry * pps.ctb_width + rx
        left_tile = rx > 0 and pps.ctb_to_col_bd[rx] != pps.ctb_to_col_bd[rx - 1]
        left_slice = rx > 0 and \
            tabs.slice_idx[ry, rx] != tabs.slice_idx[ry, rx - 1]
        up_tile = ry > 0 and pps.ctb_to_row_bd[ry] != pps.ctb_to_row_bd[ry - 1]
        up_slice = ry > 0 and \
            tabs.slice_idx[ry, rx] != tabs.slice_idx[ry - 1, rx]
        return left_tile, left_slice, up_tile, up_slice

    def deblock_ctb(self, rx, ry, vertical):
        import ctypes as ct
        sps, pps = self.sps, self.pps
        ctb = sps.ctb_size_y
        x0, y0 = rx * ctb, ry * ctb
        if getattr(self, "_bs_ctx", None) is not None:
            lt, ls, ut, us = self._boundary_flags(rx, ry)
            self.lib.deblock_compute_bs(ct.byref(self._bs_ctx), x0, y0,
                                        int(vertical), int(lt), int(ls),
                                        int(ut), int(us))
        else:
            self._compute_bs(rx, ry, x0, y0, vertical)
        x_end = min(x0 + ctb, pps.width)
        y_end = min(y0 + ctb, pps.height)
        rs = ry * pps.ctb_width + rx
        c_end = 3 if sps.chroma_format_idc else 1
        tabs = self.tabs
        for c_idx in range(c_end):
            hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
            beta_off = int(tabs.deblock_beta[rs, c_idx])
            tc_off = int(tabs.deblock_tc[rs, c_idx])
            if vertical:
                grid = (CHROMA_GRID << hs) if c_idx else LUMA_GRID
                step = DEBLOCK_STEP << vs
                n = DEBLOCK_STEP >> (2 - vs) if c_idx else DEBLOCK_STEP >> 2
                bs_tab = self.vertical_bs[c_idx]
            else:
                grid = (CHROMA_GRID << vs) if c_idx else LUMA_GRID
                step = DEBLOCK_STEP << hs
                n = DEBLOCK_STEP >> (2 - hs) if c_idx else DEBLOCK_STEP >> 2
                bs_tab = self.horizontal_bs[c_idx]
            plane = self.fb.planes[c_idx]
            lib = self.lib
            ptr = self._ptr
            if lib is not None and ptr["planes"][c_idx] is not None:
                bs_ptr = ptr["vbs" if vertical else "hbs"][c_idx]
                if c_idx == 0:
                    mlp_ptr = ptr["vp"] if vertical else ptr["hp"]
                    mlq_ptr = ptr["vq"] if vertical else ptr["hq"]
                    tb_ptr = mlp_ptr  # unused for luma
                else:
                    mlp_ptr = mlq_ptr = bs_ptr  # unused for chroma
                    tb_ptr = ptr["tbw"] if vertical else ptr["tbh"]
                lib.deblock_ctb_edges(
                    ptr["planes"][c_idx], plane.shape[1], c_idx,
                    int(vertical), x0, y0, x_end, y_end, grid, step, n,
                    hs, vs, sps.ctb_size_y,
                    bs_ptr, mlp_ptr, mlq_ptr, tb_ptr,
                    ptr["qp"][c_idx], tabs.w4,
                    beta_off, tc_off, sps.qp_bd_offset, sps.bit_depth,
                    self.pixel_max, sps.num_ladf_intervals,
                    int(getattr(sps.r, "sps_ladf_lowest_interval_qp_offset",
                                0) or 0),
                    ptr["ladf_off"], ptr["ladf_bnd"])
                continue
            if vertical:
                for y in range(y0, y_end, step):
                    x = x0 if x0 else grid
                    while x < x_end:
                        self._filter_edge(c_idx, x, y, y_end, True, n, grid,
                                          beta_off, tc_off, bs_tab, False)
                        x += grid
            else:
                for y in range(y0, y_end, grid):
                    if y == 0:
                        continue
                    hor_ctu_edge = (y % sps.ctb_size_y) == 0
                    for x in range(x0, x_end, step):
                        self._filter_edge(c_idx, x, y, x_end, False, n, grid,
                                          beta_off, tc_off, bs_tab,
                                          hor_ctu_edge)

    def _filter_edge(self, c_idx, x, y, end, vertical, n, grid, beta_off,
                     tc_off, bs_tab, hor_ctu_edge):
        sps = self.sps
        bd = sps.bit_depth
        bs = [0] * 4
        beta = [0] * 4
        tc = [0] * 4
        mlp = [0] * 4
        mlq = [0] * 4
        all_zero = True
        for i in range(n):
            d = i << 2
            if vertical:
                pos_x, pos_y = x, y + d
                in_range = pos_y < end
            else:
                pos_x, pos_y = x + d, y
                in_range = pos_x < end
            bs[i] = int(bs_tab[pos_y >> 2, pos_x >> 2]) if in_range else 0
            if bs[i]:
                qp = self._edge_qp(pos_x, pos_y, c_idx, vertical)
                beta[i] = BETA_TABLE[clip(qp + beta_off, 0, 63)]
                tc[i] = TC_TABLE[clip(qp + DEFAULT_INTRA_TC_OFFSET * (bs[i] - 1)
                                      + (tc_off & -2), 0, 65)]
                mlp[i], mlq[i] = self._max_filter_length(
                    pos_x, pos_y, c_idx, vertical, hor_ctu_edge, bs[i])
                all_zero = False
            else:
                tc[i] = 0
        if all_zero:
            return
        hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
        plane = self.fb.planes[c_idx]
        px, py = x >> hs, y >> vs
        lib = self.lib
        if lib is not None and plane.dtype == np.int32 and \
                plane.flags.c_contiguous:
            A4 = ctypes.c_int32 * 4
            if c_idx == 0:
                lib.deblock_filter_luma(
                    _native.as_i32p(plane), plane.shape[1], px, py,
                    int(vertical), A4(*beta), A4(*tc), A4(*mlp), A4(*mlq),
                    int(hor_ctu_edge), bd, self.pixel_max)
            else:
                shift = vs if vertical else hs
                lib.deblock_filter_chroma(
                    _native.as_i32p(plane), plane.shape[1], px, py,
                    int(vertical), A4(*beta), A4(*tc), A4(*mlp), A4(*mlq),
                    shift, bd, self.pixel_max)
            return
        if c_idx == 0:
            self._filter_luma(plane, px, py, vertical, beta, tc, mlp, mlq,
                              hor_ctu_edge)
        else:
            shift = vs if vertical else hs
            self._filter_chroma(plane, px, py, vertical, beta, tc, mlp, mlq,
                                shift)

    def _edge_qp(self, x, y, c_idx, vertical):
        tabs = self.tabs
        sps = self.sps
        dx = 1 if vertical else 0
        dy = 0 if vertical else 1
        if c_idx == 0:
            qp_p = int(tabs.qp[LUMA][(y - dy) >> 2, (x - dx) >> 2])
            qp_q = int(tabs.qp[LUMA][y >> 2, x >> 2])
            qp = (qp_p + qp_q + 1) >> 1
            if sps.num_ladf_intervals:
                qp += self._ladf_qp_offset(x, y, vertical)
            return qp
        qp_p = int(tabs.qp[c_idx][(y - dy) >> 2, (x - dx) >> 2])
        qp_q = int(tabs.qp[c_idx][y >> 2, x >> 2])
        return (qp_p + qp_q - 2 * sps.qp_bd_offset + 1) >> 1

    def _ladf_qp_offset(self, x, y, vertical):
        """Luma-adaptive deblocking qp offset (get_qp_y, vvc_filter.c:829-845;
        level kernel vvc_filter_template.c:788-803)."""
        sps = self.sps
        plane = self.fb.planes[0]
        if vertical:
            level = (int(plane[y, x - 1]) + int(plane[y + 3, x - 1]) +
                     int(plane[y, x]) + int(plane[y + 3, x])) >> 2
        else:
            level = (int(plane[y - 1, x]) + int(plane[y - 1, x + 3]) +
                     int(plane[y, x]) + int(plane[y, x + 3])) >> 2
        r = sps.r
        qp_offset = r.sps_ladf_lowest_interval_qp_offset
        for i in range(sps.num_ladf_intervals - 1):
            if level <= sps.ladf_interval_lower_bound[i + 1]:
                break
            qp_offset = r.sps_ladf_qp_offset[i]
        return qp_offset

    def _max_filter_length(self, qx, qy, c_idx, vertical, hor_ctu_edge, bs):
        tabs = self.tabs
        if c_idx == 0:
            t_p = self.vertical_p if vertical else self.horizontal_p
            t_q = self.vertical_q if vertical else self.horizontal_q
            return int(t_p[qy >> 2, qx >> 2]), int(t_q[qy >> 2, qx >> 2])
        px = qx - 1 if vertical else qx
        py = qy - 1 if not vertical else qy
        tb_size = tabs.tb_width[1] if vertical else tabs.tb_height[1]
        size_p = int(tb_size[py >> 2, px >> 2])
        size_q = int(tb_size[qy >> 2, qx >> 2])
        if size_p >= 8 and size_q >= 8:
            mlp = mlq = 3
            if hor_ctu_edge:
                mlp = 1
            return mlp, mlq
        v = int(bs == 2)
        return v, v

    # --- BS computation ------------------------------------------------------

    def _compute_bs(self, rx, ry, x0, y0, vertical):
        sps, pps = self.sps, self.pps
        tabs = self.tabs
        x_end4 = min(x0 + sps.ctb_size_y, pps.width) >> 2
        y_end4 = min(y0 + sps.ctb_size_y, pps.height) >> 2
        flags = self._boundary_flags(rx, ry)
        for is_chroma in (0, 1) if sps.chroma_format_idc else (0,):
            hs = sps.hshift[is_chroma]
            vs = sps.vshift[is_chroma]
            for y4 in range(y0 >> 2, y_end4):
                for x4 in range(x0 >> 2, x_end4):
                    if (int(tabs.tb_pos_x[is_chroma][y4, x4]) >> 2) == x4 and \
                            (int(tabs.tb_pos_y[is_chroma][y4, x4]) >> 2) == y4:
                        w = int(tabs.tb_width[is_chroma][y4, x4]) << hs
                        h = int(tabs.tb_height[is_chroma][y4, x4]) << vs
                        if is_chroma:
                            self._bs_chroma(x4 << 2, y4 << 2, w, h, vertical,
                                            flags)
                        else:
                            self._bs_luma(x4 << 2, y4 << 2, w, h, vertical,
                                          flags)

    def _is_intra(self, x, y):
        # reference checks tab_mvf pred_flag == PF_INTRA plus ciip_flag
        # (vvc_filter.c:537, 568)
        return int(self.tabs.mvf_pf[y >> 2, x >> 2]) == 0 or \
            int(self.tabs.mvf_ciip[y >> 2, x >> 2])

    def _bs_luma(self, x0, y0, width, height, vertical, flags):
        """vvc_deblock_bs_luma_{vertical,horizontal} (vvc_filter.c:477-620)."""
        sps, pps = self.sps, self.pps
        tabs = self.tabs
        left_tile, left_slice, up_tile, up_slice = flags
        ctb_mask = sps.ctb_size_y - 1
        q4 = (y0 >> 2, x0 >> 2)
        is_intra_cu = int(tabs.mvf_pf[q4]) == 0
        cb_x = int(tabs.cb_pos_x[0][q4])
        cb_y = int(tabs.cb_pos_y[0][q4])
        has_sb = 0
        if not is_intra_cu and (int(tabs.msf[q4]) or int(tabs.iaf[q4])):
            size = int(tabs.cb_width[0][q4]) if vertical else \
                int(tabs.cb_height[0][q4])
            has_sb = int(size > 8)
        if vertical:
            boundary = x0 > 0 and not (x0 & 3)
            if boundary and ((not pps.r.pps_loop_filter_across_slices_enabled_flag
                              and left_slice and (x0 & ctb_mask) == 0) or
                             (not pps.r.pps_loop_filter_across_tiles_enabled_flag
                              and left_tile and (x0 & ctb_mask) == 0)):
                boundary = False
            if not boundary:
                if has_sb:
                    self._subblock_bs(cb_x, cb_y, x0, y0, width, height,
                                      True)
                return
            for i in range(0, height, 4):
                y = y0 + i
                p_intra = self._is_intra(x0 - 1, y)
                q_intra = self._is_intra(x0, y)
                p_cbf = int(tabs.tu_coded_flag[LUMA][y >> 2, (x0 - 1) >> 2])
                q_cbf = int(tabs.tu_coded_flag[LUMA][y >> 2, x0 >> 2])
                pcmf = int(tabs.pcmf[LUMA][y >> 2, (x0 - 1) >> 2]) and \
                    int(tabs.pcmf[LUMA][y >> 2, x0 >> 2])
                if pcmf:
                    bs = 0
                elif p_intra or q_intra:
                    bs = 2
                elif p_cbf or q_cbf:
                    bs = 1
                else:
                    bs = self._bs_inter(x0, y, vertical)
                self.vertical_bs[LUMA][y >> 2, x0 >> 2] = bs
                mlp, mlq = self._max_len_luma(x0, y, vertical, has_sb)
                self.vertical_p[y >> 2, x0 >> 2] = mlp
                self.vertical_q[y >> 2, x0 >> 2] = mlq
            if has_sb:
                self._subblock_bs(cb_x, cb_y, x0, y0, width, height, True)
        else:
            boundary = y0 > 0 and not (y0 & 3)
            if boundary and ((not pps.r.pps_loop_filter_across_slices_enabled_flag
                              and up_slice and (y0 & ctb_mask) == 0) or
                             (not pps.r.pps_loop_filter_across_tiles_enabled_flag
                              and up_tile and (y0 & ctb_mask) == 0)):
                boundary = False
            if not boundary:
                if has_sb:
                    self._subblock_bs(cb_x, cb_y, x0, y0, width, height,
                                      False)
                return
            for i in range(0, width, 4):
                x = x0 + i
                p_intra = self._is_intra(x, y0 - 1)
                q_intra = self._is_intra(x, y0)
                p_cbf = int(tabs.tu_coded_flag[LUMA][(y0 - 1) >> 2, x >> 2])
                q_cbf = int(tabs.tu_coded_flag[LUMA][y0 >> 2, x >> 2])
                pcmf = int(tabs.pcmf[LUMA][(y0 - 1) >> 2, x >> 2]) and \
                    int(tabs.pcmf[LUMA][y0 >> 2, x >> 2])
                if pcmf:
                    bs = 0
                elif p_intra or q_intra:
                    bs = 2
                elif p_cbf or q_cbf:
                    bs = 1
                else:
                    bs = self._bs_inter(x, y0, vertical)
                self.horizontal_bs[LUMA][y0 >> 2, x >> 2] = bs
                mlp, mlq = self._max_len_luma(x, y0, vertical, has_sb)
                self.horizontal_p[y0 >> 2, x >> 2] = mlp
                self.horizontal_q[y0 >> 2, x >> 2] = mlq
            if has_sb:
                self._subblock_bs(cb_x, cb_y, x0, y0, width, height, False)

    def _subblock_bs(self, cb_x, cb_y, x0, y0, width, height, vertical):
        """vvc_deblock_subblock_bs_{vertical,horizontal} (vvc_filter.c:399):
        BS + max-len for 8-px-grid PU boundaries inside subblock CUs."""
        if vertical:
            start = 8 - ((x0 - cb_x) % 8)
            for j in range(0, height, 4):
                y = y0 + j
                i = start
                while i < width:
                    x = x0 + i
                    bs = self._boundary_strength(x, y, x - 1, y)
                    self.vertical_bs[LUMA][y >> 2, x >> 2] = bs
                    if i == 4 or i == width - 4:
                        ml = 1
                    elif i == 8 or i == width - 8:
                        ml = 2
                    else:
                        ml = 3
                    self.vertical_p[y >> 2, x >> 2] = ml
                    self.vertical_q[y >> 2, x >> 2] = ml
                    i += 8
        else:
            start = 8 - ((y0 - cb_y) % 8)
            j = start
            while j < height:
                y = y0 + j
                for i in range(0, width, 4):
                    x = x0 + i
                    bs = self._boundary_strength(x, y, x, y - 1)
                    self.horizontal_bs[LUMA][y >> 2, x >> 2] = bs
                    if j == 4 or j == height - 4:
                        ml = 1
                    elif j == 8 or j == height - 8:
                        ml = 2
                    else:
                        ml = 3
                    self.horizontal_p[y >> 2, x >> 2] = ml
                    self.horizontal_q[y >> 2, x >> 2] = ml
                j += 8

    def _bs_inter(self, x, y, vertical):
        """Inter edge: off_x/off_y rule + boundary_strength
        (vvc_filter.c:540-545, 308-371)."""
        tabs = self.tabs
        dx = 1 if vertical else 0
        dy = 0 if vertical else 1
        q4 = (y >> 2, x >> 2)
        cb_x = int(tabs.cb_pos_x[0][q4])
        cb_y = int(tabs.cb_pos_y[0][q4])
        has_sb = 0
        if int(tabs.msf[q4]) or int(tabs.iaf[q4]):
            size = int(tabs.cb_width[0][q4]) if vertical else \
                int(tabs.cb_height[0][q4])
            has_sb = int(size > 8)
        off = (cb_x - x) if vertical else (cb_y - y)
        if off and ((off % 8) or not has_sb):
            return 0
        return self._boundary_strength(x, y, x - dx, y - dy)

    def _mvf_at(self, x, y):
        t = self.tabs
        i = (y >> 2, x >> 2)
        return (int(t.mvf_pf[i]),
                (int(t.mvf_mv[0, i[0], i[1], 0]),
                 int(t.mvf_mv[0, i[0], i[1], 1])),
                (int(t.mvf_mv[1, i[0], i[1], 0]),
                 int(t.mvf_mv[1, i[0], i[1], 1])),
                int(t.mvf_ref[0, i[0], i[1]]),
                int(t.mvf_ref[1, i[0], i[1]]))

    def _rpl_at(self, x, y):
        si = int(self.tabs.slice_idx[y >> self.sps.ctb_log2_size_y,
                                     x >> self.sps.ctb_log2_size_y])
        return self.slice_rpls[si]

    def _boundary_strength(self, qx, qy, px, py):
        """boundary_strength (vvc_filter.c:308)."""
        PF_BI = 3
        cpf, cmv0, cmv1, cr0, cr1 = self._mvf_at(qx, qy)
        npf, nmv0, nmv1, nr0, nr1 = self._mvf_at(px, py)
        rpl = self._rpl_at(qx, qy)
        nrpl = self._rpl_at(px, py)

        def far(a, b):
            return abs(a[0] - b[0]) >= 8 or abs(a[1] - b[1]) >= 8
        if cpf == PF_BI and npf == PF_BI:
            c0 = rpl[0].poc_list[cr0]
            c1 = rpl[1].poc_list[cr1]
            n0 = nrpl[0].poc_list[nr0]
            n1 = nrpl[1].poc_list[nr1]
            if c0 == n0 and c0 == c1 and n0 == n1:
                if (far(nmv0, cmv0) or far(nmv1, cmv1)) and \
                        (far(nmv1, cmv0) or far(nmv0, cmv1)):
                    return 1
                return 0
            if n0 == c0 and n1 == c1:
                return 1 if (far(nmv0, cmv0) or far(nmv1, cmv1)) else 0
            if n1 == c0 and n0 == c1:
                return 1 if (far(nmv1, cmv0) or far(nmv0, cmv1)) else 0
            return 1
        if cpf != PF_BI and npf != PF_BI:
            if cpf & 1:
                a, ref_a = cmv0, rpl[0].poc_list[cr0]
            else:
                a, ref_a = cmv1, rpl[1].poc_list[cr1]
            if npf & 1:
                b, ref_b = nmv0, nrpl[0].poc_list[nr0]
            else:
                b, ref_b = nmv1, nrpl[1].poc_list[nr1]
            if ref_a == ref_b:
                return 1 if far(a, b) else 0
            return 1
        return 1

    def _max_len_luma(self, qx, qy, vertical, has_sb=0):
        """derive_max_filter_length_luma (vvc_filter.c:375)."""
        tabs = self.tabs
        px = qx - 1 if vertical else qx
        py = qy - 1 if not vertical else qy
        tb_size = tabs.tb_width[0] if vertical else tabs.tb_height[0]
        size_p = int(tb_size[py >> 2, px >> 2])
        size_q = int(tb_size[qy >> 2, qx >> 2])
        if size_p <= 4 or size_q <= 4:
            return 1, 1
        mlp = 7 if size_p >= 32 else 3
        mlq = 7 if size_q >= 32 else 3
        if has_sb:
            mlq = min(5, mlq)
        if int(tabs.msf[py >> 2, px >> 2]) or int(tabs.iaf[py >> 2, px >> 2]):
            mlp = min(5, mlp)
        return mlp, mlq

    def _bs_chroma(self, x0, y0, width, height, vertical, flags):
        sps, pps = self.sps, self.pps
        tabs = self.tabs
        left_tile, left_slice, up_tile, up_slice = flags
        ctb_mask = sps.ctb_size_y - 1
        if vertical:
            boundary = x0 > 0 and not (x0 & ((CHROMA_GRID << sps.hshift[1]) - 1))
            if boundary and ((not pps.r.pps_loop_filter_across_slices_enabled_flag
                              and left_slice and (x0 & ctb_mask) == 0) or
                             (not pps.r.pps_loop_filter_across_tiles_enabled_flag
                              and left_tile and (x0 & ctb_mask) == 0)):
                boundary = False
            if not boundary:
                return
            for i in range(0, height, 2):
                y = y0 + i
                self._bs_chroma_one(x0 - 1, y, x0, y, x0, y, True)
        else:
            boundary = y0 > 0 and not (y0 & ((CHROMA_GRID << sps.vshift[1]) - 1))
            if boundary and ((not pps.r.pps_loop_filter_across_slices_enabled_flag
                              and up_slice and (y0 & ctb_mask) == 0) or
                             (not pps.r.pps_loop_filter_across_tiles_enabled_flag
                              and up_tile and (y0 & ctb_mask) == 0)):
                boundary = False
            if not boundary:
                return
            for i in range(0, width, 2):
                x = x0 + i
                self._bs_chroma_one(x, y0 - 1, x, y0, x, y0, False)

    def _bs_chroma_one(self, px, py, qx, qy, ex, ey, vertical):
        tabs = self.tabs
        p4 = (py >> 2, px >> 2)
        q4 = (qy >> 2, qx >> 2)
        pcmf = int(tabs.pcmf[1][p4]) and int(tabs.pcmf[1][q4])
        p_intra = self._is_intra(px, py)
        q_intra = self._is_intra(qx, qy)
        for c in (CB, CR):
            cbf = int(tabs.tu_coded_flag[c][p4]) | int(tabs.tu_coded_flag[c][q4]) | \
                int(tabs.tu_joint_cbcr[p4]) | int(tabs.tu_joint_cbcr[q4])
            if pcmf:
                bs = 0
            elif p_intra or q_intra:
                bs = 2
            elif cbf:
                bs = 1
            else:
                bs = 0
            if vertical:
                self.vertical_bs[c][ey >> 2, ex >> 2] = bs
            else:
                self.horizontal_bs[c][ey >> 2, ex >> 2] = bs

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
