"""SAO filter — golden whole-frame pass (H.266 8.8.2).

Reference analogue: libavcodec/vvc/vvc_filter.c
(ff_vvc_sao_filter :154-298) and the band/edge/restore kernels of
libavcodec/h26x/h2656_sao_template.c.

The reference runs SAO in place per CTU, feeding edge classification from
pre-SAO line buffers (sao_pixel_buffer_h/v).  Functionally that equals a
whole-frame pass reading a snapshot of the deblocked planes — which is also
the natural TPU formulation (one vectorized pass per plane, no line-buffer
state).
"""
from __future__ import annotations

import numpy as np

SAO_NOT_APPLIED, SAO_BAND, SAO_EDGE = 0, 1, 2
SAO_EO_HORIZ, SAO_EO_VERT, SAO_EO_135D, SAO_EO_45D = 0, 1, 2, 3

# a/b neighbour offsets per EO class (h2656_sao_template.c:54)
_EO_POS = (((-1, 0), (1, 0)),
           ((0, -1), (0, 1)),
           ((-1, -1), (1, 1)),
           ((1, -1), (-1, 1)))
_EDGE_IDX = (1, 2, 0, 3, 4)


class SaoFilter:
    def __init__(self, sps, pps, tabs, fb):
        self.sps = sps
        self.pps = pps
        self.tabs = tabs
        self.fb = fb

    n_threads = 1   # set by the decoder (stage threads)

    def sao_frame(self):
        sps, pps, tabs = self.sps, self.pps, self.tabs
        if not tabs.sao_type.any():
            return
        from .native.sao import sao_frame_native
        if sao_frame_native(sps, pps, tabs, self.fb,
                            n_threads=self.n_threads):
            return
        pre = [p.copy() for p in self.fb.planes]
        for ry in range(pps.ctb_height):
            for rx in range(pps.ctb_width):
                self._sao_ctb(rx, ry, pre)

    def _restore_flags(self, rx, ry):
        """Unfilterable-edge flags (vvc_filter.c:168-215)."""
        pps, tabs = self.pps, self.tabs
        lfase = pps.r.pps_loop_filter_across_slices_enabled_flag
        no_tile = pps.r.num_tiles_in_pic > 1 and \
            not pps.r.pps_loop_filter_across_tiles_enabled_flag
        restore = no_tile or not lfase
        edges = [rx == 0, ry == 0, rx == pps.ctb_width - 1,
                 ry == pps.ctb_height - 1]
        vert_edge = [0, 0]
        horiz_edge = [0, 0]
        diag_edge = [0, 0, 0, 0]
        if restore:
            si = tabs.slice_idx
            lt = rt = ut = bt = 0
            if not edges[0]:
                lt = no_tile and pps.ctb_to_col_bd[rx] == rx
                vert_edge[0] = (not lfase and
                                si[ry, rx] != si[ry, rx - 1]) or lt
            if not edges[2]:
                rt = no_tile and \
                    pps.ctb_to_col_bd[rx] != pps.ctb_to_col_bd[rx + 1]
                vert_edge[1] = (not lfase and
                                si[ry, rx] != si[ry, rx + 1]) or rt
            if not edges[1]:
                ut = no_tile and pps.ctb_to_row_bd[ry] == ry
                horiz_edge[0] = (not lfase and
                                 si[ry, rx] != si[ry - 1, rx]) or ut
            if not edges[3]:
                bt = no_tile and \
                    pps.ctb_to_row_bd[ry] != pps.ctb_to_row_bd[ry + 1]
                horiz_edge[1] = (not lfase and
                                 si[ry, rx] != si[ry + 1, rx]) or bt
            if not edges[0] and not edges[1]:
                diag_edge[0] = (not lfase and
                                si[ry, rx] != si[ry - 1, rx - 1]) or lt or ut
            if not edges[1] and not edges[2]:
                diag_edge[1] = (not lfase and
                                si[ry, rx] != si[ry - 1, rx + 1]) or rt or ut
            if not edges[2] and not edges[3]:
                diag_edge[2] = (not lfase and
                                si[ry, rx] != si[ry + 1, rx + 1]) or rt or bt
            if not edges[0] and not edges[3]:
                diag_edge[3] = (not lfase and
                                si[ry, rx] != si[ry + 1, rx - 1]) or lt or bt
        return restore, edges, vert_edge, horiz_edge, diag_edge

    def _sao_ctb(self, rx, ry, pre):
        sps, pps, tabs = self.sps, self.pps, self.tabs
        rs = ry * pps.ctb_width + rx
        restore, edges, vert_edge, horiz_edge, diag_edge = \
            self._restore_flags(rx, ry)
        nc = 3 if sps.chroma_format_idc else 1
        pix_max = (1 << sps.bit_depth) - 1
        for c in range(nc):
            t = int(tabs.sao_type[rs, c])
            if t == SAO_NOT_APPLIED:
                continue
            hs, vs = sps.hshift[c], sps.vshift[c]
            ctb_w = sps.ctb_size_y >> hs
            ctb_h = sps.ctb_size_y >> vs
            plane_w = pps.width >> hs
            plane_h = pps.height >> vs
            x0 = (rx << sps.ctb_log2_size_y) >> hs
            y0 = (ry << sps.ctb_log2_size_y) >> vs
            w = min(ctb_w, plane_w - x0)
            h = min(ctb_h, plane_h - y0)
            src = pre[c]
            dst = self.fb.planes[c]
            off = tabs.sao_offset[rs, c]
            if t == SAO_BAND:
                shift = sps.bit_depth - 5
                table = np.zeros(32, dtype=np.int64)
                left_class = int(tabs.sao_band_pos[rs, c])
                for k in range(4):
                    table[(k + left_class) & 31] = off[k + 1]
                blk = src[y0:y0 + h, x0:x0 + w].astype(np.int64)
                out = blk + table[(blk >> shift) & 31]
                dst[y0:y0 + h, x0:x0 + w] = np.clip(out, 0, pix_max)
                continue
            # SAO_EDGE
            eo = int(tabs.sao_eo_class[rs, c])
            (ax, ay), (bx, by) = _EO_POS[eo]
            H, W = src.shape
            ys = np.arange(y0 - 1, y0 + h + 1)
            xs = np.arange(x0 - 1, x0 + w + 1)
            win = src[np.ix_(np.clip(ys, 0, H - 1),
                             np.clip(xs, 0, W - 1))].astype(np.int64)
            cen = win[1:1 + h, 1:1 + w]
            a = win[1 + ay:1 + ay + h, 1 + ax:1 + ax + w]
            b = win[1 + by:1 + by + h, 1 + bx:1 + bx + w]
            d = 2 + np.sign(cen - a) + np.sign(cen - b)
            offsets = np.asarray([off[i] for i in _EDGE_IDX],
                                 dtype=np.int64)
            out = np.clip(cen + offsets[d], 0, pix_max)
            # edge_restore (h2656_sao_template.c:83-230): picture borders
            # keep src + offset_val[0] (== src, offset_val[0] is 0)
            init_x = init_y = 0
            rw, rh = w, h
            if eo != SAO_EO_VERT:
                if edges[0]:
                    out[:, 0] = cen[:, 0]
                    init_x = 1
                if edges[2]:
                    out[:, w - 1] = cen[:, w - 1]
                    rw = w - 1
            if eo != SAO_EO_HORIZ:
                if edges[1]:
                    out[0, init_x:rw] = cen[0, init_x:rw]
                if edges[3]:
                    out[h - 1, init_x:rw] = cen[h - 1, init_x:rw]
                    rh = h - 1
            if restore:
                # restore pixels across unfilterable slice/tile edges
                if eo != SAO_EO_HORIZ and edges[1]:
                    init_y = 1
                sul = (not diag_edge[0] and eo == SAO_EO_135D and
                       not edges[0] and not edges[1])
                sur = (not diag_edge[1] and eo == SAO_EO_45D and
                       not edges[1] and not edges[2])
                slr = (not diag_edge[2] and eo == SAO_EO_135D and
                       not edges[2] and not edges[3])
                sll = (not diag_edge[3] and eo == SAO_EO_45D and
                       not edges[0] and not edges[3])
                if vert_edge[0] and eo != SAO_EO_VERT:
                    out[init_y + sul:rh - sll, 0] = cen[init_y + sul:rh - sll,
                                                        0]
                if vert_edge[1] and eo != SAO_EO_VERT:
                    out[init_y + sur:rh - slr, w - 1] = \
                        cen[init_y + sur:rh - slr, w - 1]
                if horiz_edge[0] and eo != SAO_EO_HORIZ:
                    out[0, init_x + sul:rw - sur] = \
                        cen[0, init_x + sul:rw - sur]
                if horiz_edge[1] and eo != SAO_EO_HORIZ:
                    out[h - 1, init_x + sll:rw - slr] = \
                        cen[h - 1, init_x + sll:rw - slr]
            dst[y0:y0 + h, x0:x0 + w] = out
