"""Device SAO: the CUDA kernel wrapper, its plain version, the entry point.

`sao_apply` replaces `ffvvc_tpu/ops/sao_device.py::_sao_pallas`: band offset
or edge offset per CTB, clipped, with the samples of the keep map left as
they are.  It takes all planes of a picture at once, as 16-bit samples, and
per plane one per-CTB table (`ctb_tables`): type, band position or edge
class, offsets, and the kept samples of the CTB's border as four ranges,
which cover the picture's border and the restore regions at slice and tile
boundaries that filtering must not cross.  On CUDA tensors it launches
`sao_kernel` (csrc/filters.cu) once for all planes, on their card and that
card's current stream; the kernel expands the per-CTB parameters itself.
Tensors of one call on different devices raise.  On CPU tensors it runs
`sao_apply_ref`, the same integer math in plain PyTorch.  Given a `Slab`,
it filters a band of the picture's rows (the mesh's cut,
`parallel/filters.py`) as a whole-picture launch filters them.

`sao_frame_device` is the per-stage entry point (`DecoderConfig.device_sao`,
`ffvvc_tpu/ops/sao_device.py::sao_frame_device`): planes up, one call of
`sao_apply`, planes down.  The fused chain (`fused_device.chain`) calls
`sao_apply` with the same tables.  `stats` counts the frames it filtered
and the bytes it moved each way (`device.upload`, `device.download`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import trace
from ..sao import SAO_BAND, SAO_EDGE, SaoFilter, _EDGE_IDX

from .device import (MIN_CTB, Counters, Slab, as_wire, counted, ctb_rows,
                     download, kernel_device, log2, run, upload)

# rows of the per-CTB int32 [11, ch, cw] table the kernel reads: typ, m1,
# offs[0..4], then the kept ranges lo | hi << 16 (CTB coordinates): rows of
# the first column, rows of the last column, columns of the first row,
# columns of the last row
TABLE_ROWS = 11

# frames `sao_frame_device` filtered and the bytes it moved each way;
# reset with reset_stats() (which `fused_device.reset_stats` calls)
stats = Counters("frames", "up_bytes", "down_bytes")
reset_stats = stats.reset


def _ranges(lo, hi):
    """[lo, hi) as lo | hi << 16; 0 where the range is empty."""
    lo, hi = np.asarray(lo, np.int32), np.asarray(hi, np.int32)
    return np.where(lo < hi, lo | (hi << 16), 0).astype(np.int32)


def _ctb_sizes(H, W, cs_v, cs_h):
    """(h [ch, 1], w [1, cw]): each CTB's size inside the picture."""
    y0 = np.arange(0, H, cs_v)
    x0 = np.arange(0, W, cs_h)
    return (np.minimum(cs_v, H - y0)[:, None],
            np.minimum(cs_h, W - x0)[None, :])


def pack_params(p, H, W, cs_v, cs_h):
    """The nine per-CTB arrays of the JAX fused chain (numpy, [ch, cw] and
    offs [5, ch, cw]; its keep map knows the picture's border only: column
    0 where kl, column W - 1 where kr, and of rows 0 and H - 1 the columns
    [ax, bx) of each CTB where kt / kb) as the int32 [11, ch, cw] table the
    wrapper takes."""
    ch, cw = p["typ"].shape
    h, w = _ctb_sizes(H, W, cs_v, cs_h)
    ry, rx = np.arange(ch)[:, None], np.arange(cw)[None, :]
    zero = np.zeros((ch, cw), np.int32)
    bx = np.minimum(p["bx"], w)
    rows = [p["typ"], p["m1"], *p["offs"],
            _ranges(zero, np.where((p["kl"] != 0) & (rx == 0), h, 0)),
            _ranges(zero, np.where((p["kr"] != 0) & (rx == cw - 1), h, 0)),
            _ranges(p["ax"], np.where((p["kt"] != 0) & (ry == 0), bx, 0)),
            _ranges(p["ax"], np.where((p["kb"] != 0) & (ry == ch - 1), bx, 0))]
    return np.stack([np.broadcast_to(np.asarray(r, np.int32), (ch, cw))
                     for r in rows])


def ctb_tables(sf, nc):
    """The per-CTB tables of planes 0..nc-1 for `SaoFilter` sf: int32
    [11, ch, cw] each, or None for a plane with SAO off everywhere.  The
    kept ranges follow the control flow of `SaoFilter._sao_ctb`
    (`ffvvc_tpu/ops/sao_device.py::_rasterize_plane`): an edge-offset CTB
    keeps its first or last column or row at the picture's border, and, on
    pictures that forbid filtering across slice or tile boundaries, where
    its neighbour lies in another slice or tile, less the corner samples
    whose diagonal neighbour may be read."""
    sps, pps, tabs = sf.sps, sf.pps, sf.tabs
    ch, cw = pps.ctb_height, pps.ctb_width
    out = [np.zeros((TABLE_ROWS, ch, cw), np.int32) for _ in range(nc)]
    for ry in range(ch):
        for rx in range(cw):
            rs = ry * cw + rx
            flags = None
            for c in range(nc):
                t = int(tabs.sao_type[rs, c])
                if t == 0:
                    continue
                tab = out[c][:, ry, rx]
                tab[0] = t
                off = tabs.sao_offset[rs, c]
                if t == SAO_BAND:
                    tab[1] = int(tabs.sao_band_pos[rs, c])
                    tab[2:6] = off[1:5]
                    continue
                eo = int(tabs.sao_eo_class[rs, c])
                tab[1] = eo
                tab[2:7] = [off[i] for i in _EDGE_IDX]
                hs, vs = sps.hshift[c], sps.vshift[c]
                x0 = (rx << sps.ctb_log2_size_y) >> hs
                y0 = (ry << sps.ctb_log2_size_y) >> vs
                w = min(sps.ctb_size_y >> hs, (pps.width >> hs) - x0)
                h = min(sps.ctb_size_y >> vs, (pps.height >> vs) - y0)
                if flags is None:
                    flags = sf._restore_flags(rx, ry)
                restore, edges, vert_edge, horiz_edge, diag_edge = flags
                col0 = col1 = row0 = row1 = (0, 0)
                init_x = init_y = 0
                rw, rh = w, h
                if eo != 1:       # SAO_EO_VERT
                    if edges[0]:
                        col0 = (0, h)
                        init_x = 1
                    if edges[2]:
                        col1 = (0, h)
                        rw = w - 1
                if eo != 0:       # SAO_EO_HORIZ
                    if edges[1]:
                        row0 = (init_x, rw)
                    if edges[3]:
                        row1 = (init_x, rw)
                        rh = h - 1
                if restore:
                    if eo != 0 and edges[1]:
                        init_y = 1
                    sul = (not diag_edge[0] and eo == 2 and
                           not edges[0] and not edges[1])
                    sur = (not diag_edge[1] and eo == 3 and
                           not edges[1] and not edges[2])
                    slr = (not diag_edge[2] and eo == 2 and
                           not edges[2] and not edges[3])
                    sll = (not diag_edge[3] and eo == 3 and
                           not edges[0] and not edges[3])
                    if vert_edge[0] and eo != 1:
                        col0 = (init_y + sul, rh - sll)
                    if vert_edge[1] and eo != 1:
                        col1 = (init_y + sur, rh - slr)
                    if horiz_edge[0] and eo != 0:
                        row0 = (init_x + sul, rw - sur)
                    if horiz_edge[1] and eo != 0:
                        row1 = (init_x + sll, rw - slr)
                tab[7:11] = [_ranges(*r) for r in (col0, col1, row0, row1)]
    return [t if t[0].any() else None for t in out]


def sao_math(src_pad, typ, m1, offs, keep, shift, pix_max):
    """`ffvvc_tpu/ops/sao_device.py::_sao_math` in torch: src_pad
    [H+2, W+2], typ/m1/keep [H, W], offs [5, H, W]; int32."""
    cen = src_pad[1:-1, 1:-1]
    a0, b0 = src_pad[1:-1, :-2], src_pad[1:-1, 2:]
    a1, b1 = src_pad[:-2, 1:-1], src_pad[2:, 1:-1]
    a2, b2 = src_pad[:-2, :-2], src_pad[2:, 2:]
    a3, b3 = src_pad[:-2, 2:], src_pad[2:, :-2]
    d0 = 2 + torch.sign(cen - a0) + torch.sign(cen - b0)
    d1 = 2 + torch.sign(cen - a1) + torch.sign(cen - b1)
    d2 = 2 + torch.sign(cen - a2) + torch.sign(cen - b2)
    d3 = 2 + torch.sign(cen - a3) + torch.sign(cen - b3)
    d = torch.where(m1 == 0, d0,
                    torch.where(m1 == 1, d1, torch.where(m1 == 2, d2, d3)))
    edge_delta = sum(torch.where(d == i, offs[i], 0) for i in range(5))
    rel = ((cen >> shift) - m1) & 31
    band_delta = sum(torch.where(rel == k, offs[k], 0) for k in range(4))
    delta = torch.where(typ == SAO_BAND, band_delta,
                        torch.where(typ == SAO_EDGE, edge_delta, 0))
    out = torch.clamp(cen + delta, 0, pix_max)
    return torch.where(keep, cen, out)


def _sao_plane_ref(plane, prm, cs_v, cs_h, shift, pix_max, slab):
    R, W = plane.shape
    s = slab or Slab.whole(R)
    dev = plane.device
    rows = torch.arange(s.row0, s.row0 + s.rows, device=dev)

    def px(a):
        return ctb_rows(a, rows, cs_v, cs_h, W)
    typ, m1 = px(prm[0]), px(prm[1])
    offs = torch.stack([px(prm[2 + k]) for k in range(5)])
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    ys = rows.to(torch.int32)[:, None]
    x_loc, y_loc = xs & (cs_h - 1), ys & (cs_v - 1)
    # the last column and row of each sample's CTB inside the picture
    x_end = torch.clamp(xs - x_loc + cs_h, max=W) - 1
    y_end = torch.clamp(ys - y_loc + cs_v, max=s.pic_h) - 1

    def within(v, r):
        r = px(r)
        return (v >= (r & 0xffff)) & (v < (r >> 16))
    keep = ((x_loc == 0) & within(y_loc, prm[7])) | \
        ((xs == x_end) & within(y_loc, prm[8])) | \
        ((y_loc == 0) & within(x_loc, prm[9])) | \
        ((ys == y_end) & within(x_loc, prm[10]))
    # the output's rows and one more each side, clamped as the kernel
    # clamps them; the columns edge-padded by one
    src = plane.to(torch.int32).index_select(0, s.local(
        torch.arange(s.row0 - 1, s.row0 + s.rows + 1, device=dev), R))
    cols = torch.arange(-1, W + 1, device=dev).clamp_(0, W - 1)
    out = sao_math(src.index_select(1, cols), typ, m1, offs, keep, shift,
                   pix_max)
    return out.to(torch.int16)


def sao_apply_ref(planes, prms, sizes, shift, pix_max, slabs=None):
    """Plain PyTorch SAO (`fused_device._sao_apply`) of a list of planes.
    planes: int16 [H, W] each; prms: the int32 [11, ch, cw] per-CTB table
    of each (`ctb_tables`, `pack_params`); sizes: (cs_v, cs_h) CTB size of
    each in its samples; slabs: a `Slab` of each plane (its rows of the
    picture), or None for whole pictures.  Returns new int16 planes, of
    each slab its output rows."""
    slabs = slabs or [None] * len(planes)
    return [_sao_plane_ref(x, p, cs_v, cs_h, shift, pix_max, sl)
            for x, p, (cs_v, cs_h), sl in zip(planes, prms, sizes, slabs)]


@counted
def sao_apply(planes, prms, sizes, shift, pix_max, slabs=None):
    """SAO of up to three planes: one launch of the CUDA kernel on CUDA
    tensors, `sao_apply_ref` on CPU tensors (`device.kernel_device`).  Same
    arguments as `sao_apply_ref`; returns new int16 [rows, W] tensors."""
    dev = kernel_device("sao_apply", planes, prms)
    if dev.type == "cpu":
        return sao_apply_ref(planes, prms, sizes, shift, pix_max, slabs)
    n = len(planes)
    if not 1 <= n <= 3 or len(prms) != n or len(sizes) != n:
        raise ValueError("sao_apply: one to three planes, each with its "
                         "parameters and CTB size")
    outs, ptrs, dims, rows = [], [], [], []
    for x, p, (cs_v, cs_h), sl in zip(planes, prms, sizes,
                                      slabs or [None] * n):
        R, W = x.shape
        sl = sl or Slab.whole(R)
        sl.check("sao_apply", R)
        ch, cw = p.shape[1:]
        if p.shape[0] != TABLE_ROWS or ch * cs_v < sl.pic_h or \
                cw * cs_h < W or W % 4 or min(cs_v, cs_h) < MIN_CTB:
            raise ValueError("sao_apply: parameters [11, ch, cw] must "
                             "cover the plane, its width a multiple of "
                             f"4 and its CTB at least {MIN_CTB}")
        out = x.new_empty((sl.rows, W))
        outs.append(out)
        ptrs += [sl.at_row0(x), out.data_ptr(), p.data_ptr()]
        dims += [W, ch, cw, log2(cs_v, "cs_v"), log2(cs_h, "cs_h")]
        rows += list(sl.args(R))
    run(sao_apply, "ffvvc_sao", dev, n, (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(dims))(*dims), (ctypes.c_int * len(rows))(*rows),
        shift, pix_max)
    return outs


@trace.traced("sao")
def sao_frame_device(sps, pps, tabs, fb, device="cuda"):
    """Device SAO over all planes of a frame, in place on fb.planes: every
    plane that has SAO goes up as 16-bit samples with its per-CTB table,
    through one `sao_apply`, and comes down."""
    if not any(int(t) for t in tabs.sao_type.flat):
        return
    nc = 3 if sps.chroma_format_idc else 1
    with trace.span("sao.build"):
        tables = ctb_tables(SaoFilter(sps, pps, tabs, fb), nc)
    on = [c for c in range(nc) if tables[c] is not None]
    if not on:
        return
    dev = torch.device(device)
    cs = sps.ctb_size_y
    with trace.span("sao.upload"):
        planes = [upload(as_wire(fb.planes[c]), dev, stats) for c in on]
        prms = [upload(tables[c], dev, stats) for c in on]
    done = sao_apply(planes, prms,
                     [(cs >> sps.vshift[c], cs >> sps.hshift[c]) for c in on],
                     sps.bit_depth - 5, (1 << sps.bit_depth) - 1)
    with trace.span("sao.download"):
        done = [download(out, stats) for out in done]
    for c, out in zip(on, done):
        fb.planes[c][:] = out
    stats["frames"] += 1
