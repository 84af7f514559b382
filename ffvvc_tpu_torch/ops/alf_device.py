"""Device ALF and CC-ALF: CUDA kernel wrappers, plain versions, entry point.

`alf_filter_luma` and `alf_filter_chroma` replace
`ffvvc_tpu/ops/alf_device.py::_alf_pallas`: the clipped 7x7 (luma) or 5x5
(chroma) diamond with virtual-boundary row substitution.  `cc_filter`
replaces `_cc_pallas`: the 7-tap luma-to-chroma correction, both chroma
planes in one call.

All take and return 16-bit samples, read the unpadded plane (coordinates
clamp at the picture edge) and take their coefficients by index: luma ALF
the per-4x4 class and transpose indices, the per-CTB filter set and the
[sets, 25, 12] tables; chroma ALF the per-CTB set and [sets, 12] tables, both
chroma planes in one call; CC-ALF the per-CTB set and [sets, 7] tables.  The
tap rows at a virtual boundary are computed from the row number (`vb_reach`,
`cc_row_offsets`).  With `edges`, an int32 [ch, cw] word per CTB (`EDGE_*`
bits, `ctb_edges`), every tap is taken from the CTB's own window: where a
bit is set the tap's coordinate is clamped to the CTB on that side
(`AlfFilter._window` of the golden model), after the virtual-boundary
substitution.  On CUDA tensors each wrapper launches its kernel in
csrc/filters.cu, on their card and that card's current stream (tensors of
one call on different devices raise); on CPU tensors it runs its `*_ref`
version, the same integer math in plain PyTorch (`device.kernel_device`).  Given
a `Slab` (`device.Slab`), each filters a band of the picture's rows as a
whole-picture call filters them (the mesh's slabs, `parallel/filters.py`):
the class and transpose indices of luma ALF then cover the 4x4 block rows
of the slab's rows, and CC-ALF takes the luma rows under its chroma rows
as a slab of their own.

`alf_frame_device` is the per-stage entry point (`DecoderConfig.device_alf`,
`ffvvc_tpu/ops/alf_device.py::alf_frame_device`), which also filters
pictures whose slices or tiles forbid filtering across their boundaries.
`stats` counts the frames it filtered and the bytes it moved each way.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..alf import (ALF_VB_POS_ABOVE_CHROMA, ALF_VB_POS_ABOVE_LUMA, AlfFilter,
                   _TRANSPOSE_IDX)

from .. import trace
from .device import (MIN_CTB, Counters, Slab, as_wire, counted, ctb_rows,
                     download, kernel_device, log2, run, upload)

# luma 7x7-diamond tap geometry: (row_key_a, dx_a, row_key_b, dx_b) per
# coefficient, row keys indexing the VB-resolved row planes 0..6
# (0:+0, 1:+1, 2:-1, 3:+2, 4:-2, 5:+3, 6:-3) — alf.py _filter_luma taps
_LUMA_TAPS = ((5, 0, 6, 0), (3, 1, 4, -1), (3, 0, 4, 0), (3, -1, 4, 1),
              (1, 2, 2, -2), (1, 1, 2, -1), (1, 0, 2, 0), (1, -1, 2, 1),
              (1, -2, 2, 2), (0, 3, 0, -3), (0, 2, 0, -2), (0, 1, 0, -1))
# nominal row offset of each row plane
_ROW_OFFSET = (0, 1, -1, 2, -2, 3, -3)
# chroma 5x5-diamond taps mapped onto the luma tap slots (alf.py
# _filter_chroma taps k -> luma slot)
_CHROMA_SLOT = (2, 5, 6, 7, 10, 11)
# CC-ALF taps: (row plane r0..r3, luma column offset)
_CC_TAPS = ((0, 0), (1, -1), (1, 1), (2, -1), (2, 0), (2, 1), (3, 0))


# bits of a CTB's edge word: no tap from beyond that side of the CTB
EDGE_LEFT, EDGE_TOP, EDGE_RIGHT, EDGE_BOTTOM = 1, 2, 4, 8

# frames `alf_frame_device` filtered and the bytes it moved each way;
# reset with reset_stats() (which `fused_device.reset_stats` calls)
stats = Counters("frames", "up_bytes", "down_bytes")
reset_stats = stats.reset


def vb_reach(ys, cs_v, vb_pos):
    """How far a tap row may lie from row y at the virtual boundary of its
    CTB row: every offset of the JAX package's `_vb_row_offsets` is its
    nominal one clamped to +-reach (a substituted row is always a nearer one).  With
    d = (y mod cs_v) - vb_pos: 0 for d in {-1, 0} (the rows that round
    with >>10), 1 for {-2, 1}, 2 for {-3, 2}, else 3.  ys: int tensor of
    picture rows."""
    d = (ys & (cs_v - 1)) - vb_pos
    reach = torch.full_like(d, 3)
    reach[(d == -3) | (d == 2)] = 2
    reach[(d == -2) | (d == 1)] = 1
    reach[(d == -1) | (d == 0)] = 0
    return reach


def _window_bounds(edges, cs_v, cs_h, H, W, ys, sv=0, sh=0):
    """Per-sample bounds (xlo, xhi, ylo, yhi) of the coordinates a tap may
    take: the picture, or the sample's own CTB on the sides its edge word
    names, for the picture rows ys (a tensor).  edges: int32 [ch, cw] over
    CTBs of cs_v x cs_h samples of an [H, W] plane, or None (then the
    bounds are the picture's, as ints).  With sv/sh the bounds are those of
    a plane subsampled by these shifts against the one the taps are read
    from ([H << sv, W << sh]): CC-ALF's luma under a chroma sample."""
    if edges is None:
        return 0, (W << sh) - 1, 0, (H << sv) - 1
    dev = edges.device
    e = ctb_rows(edges, ys, cs_v, cs_h, W)
    xs = torch.arange(W, device=dev)[None, :]
    ys = ys[:, None]
    x0, y0 = xs - (xs & (cs_h - 1)), ys - (ys & (cs_v - 1))
    x1 = torch.clamp(x0 + cs_h, max=W)
    y1 = torch.clamp(y0 + cs_v, max=H)
    return (torch.where(e & EDGE_LEFT != 0, x0 << sh, 0),
            torch.where(e & EDGE_RIGHT != 0, x1 << sh, W << sh) - 1,
            torch.where(e & EDGE_TOP != 0, y0 << sv, 0),
            torch.where(e & EDGE_BOTTOM != 0, y1 << sv, H << sv) - 1)


# ---- ALF --------------------------------------------------------------------

def alf_filter_plane_ref(src, cf_blk, cl_blk, blk_h, blk_w, slots, cs_v,
                         cs_h, vb_pos, pix_max, edges=None, slab=None,
                         blk_row0=0):
    """Plain PyTorch clipped-diamond ALF of one plane
    (`fused_device._alf_filter_plane` of the JAX package, and with `edges`
    `_alf_pallas` over `_AlfRasterizer`'s planes).  src: int16 [R, W];
    cf_blk/cl_blk: int32 [nby, nbx, 12] per block of blk_h x blk_w samples,
    from block row blk_row0 of the picture on; slots: the tap slots in use;
    cs_v x cs_h: CTB size in the plane's samples; vb_pos: the virtual
    boundary's row within a CTB row; slab: the `Slab` of src, or None for
    a whole picture."""
    R, W = src.shape
    sl = slab or Slab.whole(R)
    wide = src.to(torch.int32)
    ys = torch.arange(sl.row0, sl.row0 + sl.rows, device=src.device)
    xs = torch.arange(W, device=src.device)
    cur = wide[sl.local(ys, R)]
    reach = vb_reach(ys, cs_v, vb_pos)
    xlo, xhi, ylo, yhi = _window_bounds(edges, cs_v, cs_h, sl.pic_h, W, ys)

    def at(k, dx):
        o = torch.clamp(torch.full_like(reach, _ROW_OFFSET[k]), -reach, reach)
        return wide[sl.local(torch.clamp((ys + o)[:, None], ylo, yhi), R),
                    torch.clamp((xs + dx)[None, :], xlo, xhi)]

    def px(a):
        return a.index_select(0, ys // blk_h - blk_row0).repeat_interleave(
            blk_w, 1)[:, :W]
    acc = torch.zeros_like(cur)
    for s in slots:
        ka, da, kb, db = _LUMA_TAPS[s]
        cl = px(cl_blk[:, :, s])
        d = torch.clamp(at(ka, da) - cur, -cl, cl) + \
            torch.clamp(at(kb, db) - cur, -cl, cl)
        acc = acc + px(cf_blk[:, :, s]) * d
    acc = torch.where(reach[:, None] == 0, (acc + (1 << 9)) >> 10,
                      (acc + 64) >> 7)
    return torch.clamp(cur + acc, 0, pix_max).to(torch.int16)


def alf_filter_luma_ref(src, ci, ti, ctb_set, cf_tab, cl_tab, cs, pix_max,
                        edges=None, slab=None):
    """Plain PyTorch luma ALF.  src: int16 [R, W]; ci/ti: int32 class and
    transpose index of each 4x4 block (`fused_device.alf_classify`), of the
    block rows the output rows touch ([H / 4, W / 4] for a whole picture);
    ctb_set: int32 [ch, cw] filter set of each CTB of cs x cs samples;
    cf_tab/cl_tab: int32 [sets, 25, 12]; edges: int32 [ch, cw] edge words,
    or None; slab: the `Slab` of src, or None for a whole picture."""
    s = slab or Slab.whole(src.shape[0])
    nby, nbx = ci.shape
    brows = torch.arange(s.row0 >> 2, (s.row0 >> 2) + nby, device=src.device)
    setidx = ctb_rows(ctb_set, brows, cs // 4, cs // 4, nbx).long()
    perm = torch.tensor(_TRANSPOSE_IDX, device=src.device)[ti.long()]
    cfb = torch.gather(cf_tab[setidx, ci.long()], 2, perm)
    clb = torch.gather(cl_tab[setidx, ci.long()], 2, perm)
    return alf_filter_plane_ref(src, cfb, clb, 4, 4, range(12), cs, cs,
                                cs - ALF_VB_POS_ABOVE_LUMA, pix_max, edges,
                                s, s.row0 >> 2)


def alf_filter_chroma_ref(srcs, ctb_sets, cf_tabs, cl_tabs, cs_v, cs_h,
                          pix_max, edges=None, slab=None):
    """Plain PyTorch chroma ALF of one or two planes of equal shape.  Per
    plane: src int16 [R, W], ctb_set int32 [ch, cw] and the tables
    cf_tab/cl_tab int32 [sets, 12] (the slots chroma does not use hold
    cf 0); CTBs of cs_v x cs_h samples; edges: int32 [ch, cw] edge words
    for both planes, or None; slab: the `Slab` of both, or None for whole
    pictures."""
    return [alf_filter_plane_ref(
        x, cf[s.long()], cl[s.long()], cs_v, cs_h, _CHROMA_SLOT, cs_v, cs_h,
        cs_v - ALF_VB_POS_ABOVE_CHROMA, pix_max, edges, slab)
        for x, s, cf, cl in zip(srcs, ctb_sets, cf_tabs, cl_tabs)]


def _check(name, ok, what):
    if not ok:
        raise ValueError(f"{name}: {what}")


def _edge_ptr(name, edges, ch, cw):
    """The kernel's argument for `edges`: its address, or None (a null
    pointer: the variant without per-CTB clamps)."""
    if edges is None:
        return None
    _check(name, edges.shape == (ch, cw), "edges must be [ch, cw]")
    return edges.data_ptr()


def block_rows(slab):
    """The 4x4 block rows a slab's output rows touch."""
    return ((slab.row0 + slab.rows - 1) >> 2) - (slab.row0 >> 2) + 1


@counted
def alf_filter_luma(src, ci, ti, ctb_set, cf_tab, cl_tab, cs, pix_max,
                    edges=None, slab=None):
    """Luma ALF: the CUDA kernel on CUDA tensors, `alf_filter_luma_ref`
    (same arguments) on CPU tensors.  Returns a new int16 [rows, W]."""
    name = "alf_filter_luma"
    dev = kernel_device(name, (src,), (ci, ti, ctb_set, cf_tab, cl_tab),
                        edges)
    if dev.type == "cpu":
        return alf_filter_luma_ref(src, ci, ti, ctb_set, cf_tab, cl_tab, cs,
                                   pix_max, edges, slab)
    R, W = src.shape
    s = slab or Slab.whole(R)
    s.check(name, R)
    ch, cw = ctb_set.shape
    _check(name, s.pic_h % 4 == 0 and W % 4 == 0 and
           ci.shape == ti.shape == (block_rows(s), W // 4) and
           ch * cs >= s.pic_h and cw * cs >= W and cs >= 32 and
           cf_tab.shape == cl_tab.shape and
           cf_tab.shape[1:] == (25, 12), "inconsistent shapes")
    out = src.new_empty((s.rows, W))
    run(alf_filter_luma, "ffvvc_alf_luma", dev, s.at_row0(src),
        out.data_ptr(), s.args(R), W, ci.data_ptr(), ti.data_ptr(),
        ctb_set.data_ptr(), cw, cf_tab.data_ptr(), cl_tab.data_ptr(),
        _edge_ptr(name, edges, ch, cw), log2(cs, "cs"), pix_max,
        edges=edges is not None)
    return out


@counted
def alf_filter_chroma(srcs, ctb_sets, cf_tabs, cl_tabs, cs_v, cs_h, pix_max,
                      edges=None, slab=None):
    """Chroma ALF of one or two planes in one launch of the CUDA kernel on
    CUDA tensors, `alf_filter_chroma_ref` (same arguments) on CPU tensors.
    Returns new int16 [rows, W] tensors."""
    name = "alf_filter_chroma"
    dev = kernel_device(name, srcs, (*ctb_sets, *cf_tabs, *cl_tabs), edges)
    if dev.type == "cpu":
        return alf_filter_chroma_ref(srcs, ctb_sets, cf_tabs, cl_tabs, cs_v,
                                     cs_h, pix_max, edges, slab)
    n = len(srcs)
    _check(name, 1 <= n <= 2 and len(ctb_sets) == len(cf_tabs) ==
           len(cl_tabs) == n, "one or two planes, each with its parameters")
    R, W = srcs[0].shape
    s = slab or Slab.whole(R)
    s.check(name, R)
    ch, cw = ctb_sets[0].shape
    _check(name, W % 4 == 0 and ch * cs_v >= s.pic_h and
           cw * cs_h >= W and min(cs_v, cs_h) >= MIN_CTB and
           all(x.shape == (R, W) for x in srcs) and
           all(t.shape == (ch, cw) for t in ctb_sets) and
           all(t.ndim == 2 and t.shape[1] == 12
               for t in (*cf_tabs, *cl_tabs)), "inconsistent shapes")
    outs = [x.new_empty((s.rows, W)) for x in srcs]
    ptrs = [p for z in range(n) for p in (
        s.at_row0(srcs[z]), outs[z].data_ptr(), ctb_sets[z].data_ptr(),
        cf_tabs[z].data_ptr(), cl_tabs[z].data_ptr())]
    run(alf_filter_chroma, "ffvvc_alf_chroma", dev, n,
        (ctypes.c_void_p * len(ptrs))(*ptrs), _edge_ptr(name, edges, ch, cw),
        s.args(R), W, cw, log2(cs_v, "cs_v"), log2(cs_h, "cs_h"), pix_max,
        edges=edges is not None)
    return outs


# ---- CC-ALF -----------------------------------------------------------------

def cc_row_offsets(ys, cs_v, vs):
    """CC-ALF's luma tap rows from the chroma row number (alf.py
    `_filter_cc`; the JAX package builds them as a table, `_cc_arrays`).
    ys: int tensor of chroma rows; cs_v: CTB height in chroma rows.  With
    pos = (y mod cs_v) << vs and d = pos - ((cs_v << vs) - 4) the rows
    r0..r3 are pos - 1, pos, pos + 1, pos + 2; for d in {-2, 1} r3 = r2; for
    d in {-1, 0} all four are pos.  Returns (offsets [4, len(ys)] against
    the luma row ys << vs, skip [len(ys)]: with vs = 0 the rows d in {0, 1}
    get no correction)."""
    d = ((ys & (cs_v - 1)) << vs) - ((cs_v << vs) - ALF_VB_POS_ABOVE_LUMA)
    flat = (d == -1) | (d == 0)
    one = torch.where(flat, 0, 1)
    two = torch.where(flat, 0, torch.where((d == -2) | (d == 1), 1, 2))
    skip = ((d == 0) | (d == 1)) if vs == 0 else torch.zeros_like(flat)
    return torch.stack([-one, torch.zeros_like(one), one, two]), skip


def cc_filter_ref(dsts, luma, ctb_sets, cf_tabs, cs_v, cs_h, hs, vs, half,
                  pix_max, edges=None, slab=None, luma_slab=None):
    """Plain PyTorch CC-ALF of one or two chroma planes
    (`fused_device._cc_filter` of the JAX package, and with `edges`
    `_cc_pallas` over `_AlfRasterizer._raster_cc`'s planes).  dsts: int16
    [Rc, Wc] chroma planes; luma: int16 [R, Wc << hs] pre-ALF luma; per
    plane ctb_set int32 [ch, cw] and cf_tab int32 [sets, 7]; CTBs of
    cs_v x cs_h chroma samples; edges: int32 [ch, cw] edge words, or None;
    slab, luma_slab: the `Slab` of the chroma planes and of the luma rows
    under their output rows, or None for whole pictures."""
    Rc, Wc = dsts[0].shape
    s = slab or Slab.whole(Rc)
    ls = luma_slab or Slab.whole(luma.shape[0])
    wide = luma.to(torch.int32)
    ys = torch.arange(s.row0, s.row0 + s.rows, device=luma.device)
    xs = torch.arange(Wc, device=luma.device)
    offs, skip = cc_row_offsets(ys, cs_v, vs)
    xlo, xhi, ylo, yhi = _window_bounds(edges, cs_v, cs_h, s.pic_h, Wc, ys,
                                        vs, hs)

    def at(j, dx):
        rows = torch.clamp(((ys << vs) + offs[j])[:, None], ylo, yhi)
        return wide[ls.local(rows, luma.shape[0]),
                    torch.clamp(((xs << hs) + dx)[None, :], xlo, xhi)]
    cur = at(1, 0)
    diffs = [at(rk, dx) - cur for rk, dx in _CC_TAPS]
    outs = []
    for dst, ctb_set, cf_tab in zip(dsts, ctb_sets, cf_tabs):
        cf_ctb = cf_tab[ctb_set.long()]              # [ch, cw, 7]
        acc = torch.zeros_like(cur)
        for j, diff in enumerate(diffs):
            acc = acc + ctb_rows(cf_ctb[:, :, j], ys, cs_v, cs_h, Wc) * diff
        acc = torch.where(skip[:, None], 0, acc)
        acc = torch.clamp((acc + 64) >> 7, -half, half - 1)
        own = dst[s.top:s.top + s.rows].to(torch.int32)
        outs.append(torch.clamp(own + acc, 0, pix_max).to(torch.int16))
    return outs


@counted
def cc_filter(dsts, luma, ctb_sets, cf_tabs, cs_v, cs_h, hs, vs, half,
              pix_max, edges=None, slab=None, luma_slab=None):
    """CC-ALF of one or two chroma planes in one launch of the CUDA kernel
    on CUDA tensors, `cc_filter_ref` (same arguments) on CPU tensors.
    Returns new int16 [rows, Wc] tensors."""
    name = "cc_filter"
    dev = kernel_device(name, (*dsts, luma), (*ctb_sets, *cf_tabs), edges)
    if dev.type == "cpu":
        return cc_filter_ref(dsts, luma, ctb_sets, cf_tabs, cs_v, cs_h, hs,
                             vs, half, pix_max, edges, slab, luma_slab)
    n = len(dsts)
    _check(name, 1 <= n <= 2 and len(ctb_sets) == len(cf_tabs) == n,
           "one or two planes, each with its parameters")
    Rc, Wc = dsts[0].shape
    R, W = luma.shape
    s = slab or Slab.whole(Rc)
    ls = luma_slab or Slab.whole(R)
    s.check(name, Rc)
    ls.check(name, R)
    ch, cw = ctb_sets[0].shape
    _check(name, (hs, vs) in ((1, 1), (1, 0), (0, 0)) and
           W == Wc << hs and ls.pic_h == s.pic_h << vs and
           (ls.row0, ls.rows) == (s.row0 << vs, s.rows << vs) and
           Wc % 4 == 0 and ch * cs_v >= s.pic_h and cw * cs_h >= Wc and
           min(cs_v, cs_h) >= MIN_CTB and
           all(x.shape == (Rc, Wc) for x in dsts) and
           all(t.shape == (ch, cw) for t in ctb_sets) and
           all(t.ndim == 2 and t.shape[1] == 7 for t in cf_tabs),
           "inconsistent shapes")
    _check(name, ls.at_row0(luma) % 16 == 0, "luma must be 16-byte aligned")
    outs = [x.new_empty((s.rows, Wc)) for x in dsts]
    ptrs = [p for z in range(n) for p in (
        s.at_row0(dsts[z]), outs[z].data_ptr(), ctb_sets[z].data_ptr(),
        cf_tabs[z].data_ptr())]
    run(cc_filter, "ffvvc_cc", dev, n, (ctypes.c_void_p * len(ptrs))(*ptrs),
        ls.at_row0(luma), _edge_ptr(name, edges, ch, cw), s.args(Rc),
        ls.args(R), W, Wc, cw, log2(cs_v, "cs_v"), log2(cs_h, "cs_h"), hs, vs,
        half, pix_max, edges=edges is not None)
    return outs


# ---- the per-stage entry point ----------------------------------------------

def ctb_edges(af):
    """int32 [ch, cw] edge words of `AlfFilter` af: `AlfFilter._edges` of
    every CTB as `EDGE_*` bits."""
    ch, cw = af.pps.ctb_height, af.pps.ctb_width
    bits = (EDGE_LEFT, EDGE_TOP, EDGE_RIGHT, EDGE_BOTTOM)
    words = np.zeros((ch, cw), np.int32)
    for ry in range(ch):
        for rx in range(cw):
            words[ry, rx] = sum(b for b, e in zip(bits, af._edges(rx, ry))
                                if e)
    return words


@trace.traced("alf")
def alf_frame_device(sps, pps, tabs, fb, sh_list, alf_list, device="cuda"):
    """Device ALF + CC-ALF over all planes of a frame, in place on
    fb.planes.  The planes go up as 16-bit samples with the per-CTB sets,
    tables and edge words; the luma is classified per CTB window
    (`fused_device.alf_classify_ctbs`), filtered, both chroma planes are
    filtered in one call and corrected in one call from the luma as it was
    before ALF; the planes that changed come down.  A CTB whose CC-ALF APS
    is missing gets no correction; a missing ALF APS raises KeyError."""
    from . import fused_device as fd
    if not sps.r.sps_alf_enabled_flag:
        return
    if not tabs.alf_ctb_flag.any() and not tabs.alf_cc_idc.any():
        return
    with trace.span("alf.build"):
        ap = fd._alf_ctb_params(sps, pps, tabs, sh_list, alf_list)
        words = ctb_edges(AlfFilter(sps, pps, tabs, fb, sh_list, alf_list))
    dev = torch.device(device)
    nc = 3 if sps.chroma_format_idc else 1
    cs, bd = sps.ctb_size_y, sps.bit_depth
    pix_max = (1 << bd) - 1
    with trace.span("alf.upload"):
        a = {k: upload(v, dev, stats) for k, v in ap.items()}
        edges = upload(words, dev, stats)
        pre = [upload(as_wire(p), dev, stats) for p in fb.planes[:nc]]
    out = {}
    if "alf0_ctb_set" in a:
        ci, ti = fd.alf_classify_ctbs(pre[0], edges, cs, bd)
        out[0] = alf_filter_luma(pre[0], ci, ti, a["alf0_ctb_set"],
                                 a["alf0_cf"], a["alf0_cl"], cs, pix_max,
                                 edges)
    if nc == 3:
        hs, vs = sps.hshift[1], sps.vshift[1]
        csv, csh = cs >> vs, cs >> hs
        on = [c for c in (1, 2) if f"alf{c}_set" in a]
        if on:
            done = alf_filter_chroma(
                [pre[c] for c in on], [a[f"alf{c}_set"] for c in on],
                [a[f"alf{c}_cf"] for c in on], [a[f"alf{c}_cl"] for c in on],
                csv, csh, pix_max, edges)
            out.update(zip(on, done))
        on = [c for c in (1, 2) if f"cc{c}_set" in a]
        if on:
            done = cc_filter(
                [out.get(c, pre[c]) for c in on], pre[0],
                [a[f"cc{c}_set"] for c in on], [a[f"cc{c}_cf"] for c in on],
                csv, csh, hs, vs, 1 << (bd - 1), pix_max, edges)
            out.update(zip(on, done))
    with trace.span("alf.download"):
        out = {c: download(t, stats) for c, t in out.items()}
    for c, t in out.items():
        fb.planes[c][:] = t
    stats["frames"] += 1
