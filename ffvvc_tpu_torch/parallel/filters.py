"""Mesh-sharded in-loop filters: decoded frames over a (gop, tile) mesh.

Port of `ffvvc_tpu/parallel/filters.py` (the form of the reference's
cross-frame and cross-row concurrency, libavcodec/vvc/vvc_thread.c:41-51
task stencil and vvc_refs.c:532-565 row-progress listeners): whole-frame
filter passes run over a mesh of torch devices (`parallel/mesh.py`) —

  * "gop" axis: independent frames filter on different devices (the
    reference's 16-deep frame pipeline, vvcdec.c:830-841);
  * "tile" axis: row slabs of each frame on different devices, each with
    the rows of its neighbours that its pass reads copied in as a halo
    (the form of the sao_pixel_buffer_h/v line buffers,
    vvc_filter.c:123-152).

The JAX package runs each pass as a shard_map over per-pixel parameter
maps.  Here SAO, ALF and CC-ALF run the hand kernels of csrc/filters.cu
(`sao_apply`, `alf_filter_luma`, `alf_filter_chroma`, `cc_filter`) on each
slab, one launch per slab for all the planes a kernel takes, from the same
per-CTB tables and edge words as the per-stage filters (`ctb_tables`,
`ctb_edges`, `alf_classify_ctbs`): each launch is told its slab's first
picture row and the picture's height (`device.Slab`).  Residual add,
LMCS and deblocking are plain PyTorch, deblocking in the slab mode of
`luma_math`/`chroma_math`.  Pictures whose slices or tiles forbid filtering
across their boundaries take SAO's restore regions (in its table) and the
edge-word variants of ALF and CC-ALF.  Planes go up once a drain and come
down once, each slab straight to and from its own device (its own card on
a CUDA mesh); between the passes the slabs stay there, every pass and
kernel launch of a slab runs on its device with the parameters uploaded
to it (`_OnDevice`), and only halos move between devices.

A frame's planes are cut at the same picture rows: chroma into t slabs of
ceil(Hc / t) rows (at least the widest halo, as the JAX package pads its
deblock slabs), luma into the same slabs scaled by the vertical chroma
subsampling, so that the luma under a chroma slab lies in the luma slab of
the same index; the last slabs are padded with the frame's edge row, and
a slab with no row of the picture launches nothing.

All passes are bit-exact against the host golden filters; VVCDecoder uses
them when `DecoderConfig.mesh_shape` spans more than one device
(decoder.py filter stage), with frame batching across all-intra runs and
per-frame drains at inter reference barriers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..alf import AlfFilter
from ..sao import SaoFilter
from ..ops.alf_device import (EDGE_BOTTOM, EDGE_LEFT, EDGE_RIGHT, EDGE_TOP,
                              alf_filter_chroma, alf_filter_luma, cc_filter,
                              ctb_edges)
from ..ops.deblock_device import (chroma_math, luma_math, rasterize_deblock,
                                  seg_array)
from ..ops.fused_device import _alf_ctb_params, alf_classify_ctbs
from ..ops.device import Slab, as_wire, ctb_rows
from ..ops.sao_device import ctb_tables, sao_apply
from .mesh import (cut_rows, exchange_row_halo, join_rows, make_mesh_exact,
                   slab_rows)

__all__ = ["make_mesh_exact", "MeshFilterQueue"]

# Rows a pass reads beyond a slab, so the halo it takes from each
# neighbour (tests/test_torch_mesh.py holds each against every cut):
# SAO's edge classes read the rows next to a sample
SAO_HALO = 1
# luma ALF: the classification of the 4x4 blocks that hold the slab's rows
# reads 3 rows past each block, which begins up to 3 rows above the slab's
# first row and ends up to 3 below its last (a cut need not fall on the
# block grid); the 7x7 diamond reads 3, inside that
ALF_LUMA_HALO = 6
# chroma ALF: the 5x5 diamond
ALF_CHROMA_HALO = 2
# CC-ALF: the luma rows r - 1 .. r + 2 around the luma row r under a
# chroma row
CC_LUMA_HALO = 2
# deblock windows/writes reach <=8 rows past a segment
_DB_HALO = 8


class Cut(NamedTuple):
    """A plane of H picture rows cut into slabs of hs rows; slab i holds
    rows [i * hs, i * hs + hs), padding past the picture."""
    H: int
    hs: int

    def rows(self, i):
        """Rows of the picture in slab i (0 for a slab of padding)."""
        return max(0, min(self.hs, self.H - i * self.hs))


def frame_cuts(H, Hc, t, vs, nc):
    """The Cut of each of a frame's nc planes (luma H rows, chroma Hc):
    chroma slabs of ceil(Hc / t) rows and at least the deblock halo, luma
    slabs as many rows << vs."""
    if nc == 1:
        return [Cut(H, slab_rows(H, t, _DB_HALO))]
    hsc = slab_rows(Hc, t, _DB_HALO)
    return [Cut(H, hsc << vs), Cut(Hc, hsc), Cut(Hc, hsc)]


def _pad_frames(items, g):
    """Pad the frame axis to a multiple of g with empty entries (None): an
    empty frame launches nothing.  Frame k then lies on gop row
    k // (len / g)."""
    return list(items) + [None] * ((-len(items)) % g)


def _tall(slabs, i, halos, halo, cut):
    """Slab i with its halo rows from its neighbours (none past the
    picture's top), and its `Slab`."""
    above, below = halos
    parts = [p for p in (above[i], slabs[i], below[i]) if p is not None]
    top = 0 if above[i] is None else halo
    return torch.cat(parts), Slab(i * cut.hs, cut.rows(i), cut.H, top)


def _land(slab, out):
    """A slab with its picture rows replaced by `out` (padding rows past
    the picture stay as they are)."""
    n = out.shape[0]
    return out if n == slab.shape[0] else torch.cat([out, slab[n:]])


class _OnDevice:
    """A frame's host parameters, uploaded to a device when a slab there
    first needs them; `clamped`: ALF and CC-ALF take the edge words."""

    def __init__(self, arrays, clamped=False):
        self.arrays = arrays
        self.clamped = clamped
        self.cache = {}

    def __contains__(self, key):
        return key in self.arrays

    def get(self, key, dev):
        t = self.cache.get((key, dev))
        if t is None:
            t = self.cache[(key, dev)] = torch.from_numpy(
                np.ascontiguousarray(self.arrays[key])).to(dev)
        return t


# ---- the passes: per frame of a batch, the slabs of its planes -------------

def residual_add_sharded(planes, res, pix_max):
    """Sharded recon residual add: per frame the int32 slabs of one plane
    and of its residual -> clip(planes + res).  Elementwise — no halo."""
    return [[torch.clamp(p + r, 0, pix_max) for p, r in zip(ps, rs)]
            for ps, rs in zip(planes, res)]


def lmcs_batch_sharded(planes, luts, masks, cut, cs):
    """Sharded LMCS inverse mapping of luma slabs: luts [L] int32 and
    masks [ch, cw] (the per-CTB sh_lmcs_used gate) per frame."""
    out = []
    for ps, lut, mask in zip(planes, luts, masks):
        row = []
        for i, p in enumerate(ps):
            ys = torch.arange(i * cut.hs, (i + 1) * cut.hs,
                              device=p.device).clamp(max=cut.H - 1)
            m = ctb_rows(mask.to(p.device), ys, cs, cs, p.shape[1])
            row.append(torch.where(m != 0, lut.to(p.device)[p.long()], p))
        out.append(row)
    return out


def deblock_batch_sharded(planes, segs_per_frame, kind, vertical,
                          pix_max, cut):
    """One deblock direction for a batch of frames: per frame the int32
    slabs of one plane and its segments, tuples or an [N, 7] array (see
    ops/deblock_device.rasterize_deblock).  A slab takes the segments whose
    writes can reach its rows, with an 8-row halo from its neighbours (the
    edge row repeated past the frame's top and bottom), and keeps the
    deltas that land in its own rows."""
    math = luma_math if kind == "luma" else chroma_math
    out = []
    for ps, segs in zip(planes, segs_per_frame):
        if not len(segs):
            out.append(ps)
            continue
        above, below = exchange_row_halo(ps, _DB_HALO)
        seg = np.asarray(segs, np.int32)
        row = []
        for i, p in enumerate(ps):
            r0 = i * cut.hs
            near = seg[(seg[:, 1] >= r0 - _DB_HALO) &
                       (seg[:, 1] < r0 + cut.hs + _DB_HALO)]
            if not cut.rows(i) or not len(near):
                row.append(p)
                continue
            top = above[i] if above[i] is not None else \
                p[:1].expand(_DB_HALO, -1)
            bot = below[i] if below[i] is not None else \
                p[-1:].expand(_DB_HALO, -1)
            s = torch.from_numpy(seg_array(near)).to(p.device)
            tall = math(torch.cat([top, p, bot]), *s.to(torch.int32).unbind(0),
                        vertical, pix_max, r0 - _DB_HALO, cut.hs)
            row.append(tall[_DB_HALO:_DB_HALO + cut.hs])
        out.append(row)
    return out


def sao_batch_sharded(planes, tables, sizes, cuts, shift, pix_max):
    """Batched sharded SAO: per frame the int16 slabs of each plane
    ([nc][t]) and the per-CTB table of each plane (`ctb_tables`, an
    `_OnDevice` key per plane) or None; sizes/cuts: the CTB size and `Cut`
    of each plane.  Each slab filters all its planes in one launch of the
    SAO kernel, with the 1-row halo of each."""
    out = []
    for ps, tabs in zip(planes, tables):
        on = [c for c in range(len(ps)) if tabs is not None and
              f"sao{c}" in tabs]
        if not on:
            out.append(ps)
            continue
        halos = {c: exchange_row_halo(ps[c], SAO_HALO) for c in on}
        new = [list(p) for p in ps]
        for i in range(len(ps[0])):
            live = [c for c in on if cuts[c].rows(i)]
            if not live:
                continue
            dev = ps[live[0]][i].device
            talls, slabs = zip(*(_tall(ps[c], i, halos[c], SAO_HALO, cuts[c])
                                 for c in live))
            done = sao_apply(list(talls), [tabs.get(f"sao{c}", dev)
                                           for c in live],
                             [sizes[c] for c in live], shift, pix_max,
                             list(slabs))
            for c, o in zip(live, done):
                new[c][i] = _land(ps[c][i], o)
        out.append(new)
    return out


def alf_batch_sharded(planes, params, cuts, cs, bd, hs, vs):
    """Batched sharded ALF: per frame the int16 post-SAO slabs of each
    plane and its `_OnDevice` ALF parameters (`_alf_ctb_params` and the
    edge words "edges") or None.  Per slab
    the luma is classified CTB row by CTB row (`alf_classify_ctbs`) and
    filtered in one launch with a 6-row halo; both chroma planes go through
    one launch with a 2-row halo."""
    pix_max = (1 << bd) - 1
    out = []
    for ps, a in zip(planes, params):
        if a is None:
            out.append(ps)
            continue
        new = [list(p) for p in ps]
        if "alf0_ctb_set" in a:
            halos = exchange_row_halo(ps[0], ALF_LUMA_HALO)
            for i in range(len(ps[0])):
                if not cuts[0].rows(i):
                    continue
                dev = ps[0][i].device
                tall, sl = _tall(ps[0], i, halos, ALF_LUMA_HALO, cuts[0])
                edges = a.get("edges", dev)
                ci, ti = alf_classify_ctbs(tall, edges, cs, bd, sl)
                o = alf_filter_luma(
                    tall, ci, ti, a.get("alf0_ctb_set", dev),
                    a.get("alf0_cf", dev), a.get("alf0_cl", dev), cs,
                    pix_max, edges if a.clamped else None, sl)
                new[0][i] = _land(ps[0][i], o)
        on = [c for c in (1, 2) if len(ps) == 3 and f"alf{c}_set" in a]
        if on:
            halos = {c: exchange_row_halo(ps[c], ALF_CHROMA_HALO) for c in on}
            for i in range(len(ps[1])):
                if not cuts[1].rows(i):
                    continue
                dev = ps[1][i].device
                talls = [_tall(ps[c], i, halos[c], ALF_CHROMA_HALO, cuts[c])
                         for c in on]
                done = alf_filter_chroma(
                    [x for x, _ in talls],
                    [a.get(f"alf{c}_set", dev) for c in on],
                    [a.get(f"alf{c}_cf", dev) for c in on],
                    [a.get(f"alf{c}_cl", dev) for c in on], cs >> vs,
                    cs >> hs, pix_max,
                    a.get("edges", dev) if a.clamped else None,
                    talls[0][1])
                for c, o in zip(on, done):
                    new[c][i] = _land(ps[c][i], o)
        out.append(new)
    return out


def cc_batch_sharded(lumas, planes, params, cuts, cs, bd, hs, vs):
    """Batched sharded CC-ALF: per frame the int16 pre-ALF (post-SAO) luma
    slabs, the post-ALF slabs of each plane and the `_OnDevice` ALF
    parameters or None.  Both chroma planes of a slab go through one
    launch, with the luma rows under them and a 2-row luma halo."""
    pix_max = (1 << bd) - 1
    out = []
    for luma, ps, a in zip(lumas, planes, params):
        on = [c for c in (1, 2) if a is not None and len(ps) == 3 and
              f"cc{c}_set" in a]
        if not on:
            out.append(ps)
            continue
        new = [list(p) for p in ps]
        halos = exchange_row_halo(luma, CC_LUMA_HALO)
        for i in range(len(ps[1])):
            if not cuts[1].rows(i):
                continue
            dev = ps[1][i].device
            tall, lsl = _tall(luma, i, halos, CC_LUMA_HALO, cuts[0])
            sl = Slab(i * cuts[1].hs, cuts[1].rows(i), cuts[1].H)
            lsl = lsl._replace(rows=sl.rows << vs)
            done = cc_filter(
                [ps[c][i] for c in on], tall,
                [a.get(f"cc{c}_set", dev) for c in on],
                [a.get(f"cc{c}_cf", dev) for c in on], cs >> vs, cs >> hs,
                hs, vs, 1 << (bd - 1), pix_max,
                a.get("edges", dev) if a.clamped else None, sl, lsl)
            for c, o in zip(on, done):
                new[c][i] = _land(ps[c][i], o)
        out.append(new)
    return out


# ---- the queue --------------------------------------------------------------

def _border_words(ch, cw):
    """The edge words of a picture that clamps its taps at its border
    alone (which the kernels' variants without edge words do)."""
    w = np.zeros((ch, cw), np.int32)
    w[:, 0] |= EDGE_LEFT
    w[0, :] |= EDGE_TOP
    w[:, -1] |= EDGE_RIGHT
    w[-1, :] |= EDGE_BOTTOM
    return w


def _alf_params(e):
    """A queued frame's ALF parameters, or None when ALF is off in it."""
    sps, pps, tabs = e["sps"], e["pps"], e["tabs"]
    if (not sps.r.sps_alf_enabled_flag or e["sh_list"] is None or
            (not tabs.alf_ctb_flag.any() and not tabs.alf_cc_idc.any())):
        return None
    arrs = _alf_ctb_params(sps, pps, tabs, e["sh_list"], e["alf_list"])
    if not arrs:
        return None
    edges = arrs["edges"] = ctb_edges(AlfFilter(
        sps, pps, tabs, e["fb"], e["sh_list"], e["alf_list"]))
    return _OnDevice(arrs, bool((edges != _border_words(*edges.shape)).any()))


def _sao_params(e, nc):
    """A queued frame's SAO tables, or None when SAO is off in it."""
    if not any(int(t) for t in e["tabs"].sao_type.flat):
        return None
    tables = ctb_tables(SaoFilter(e["sps"], e["pps"], e["tabs"], e["fb"]),
                        nc)
    arrs = {f"sao{c}": t for c, t in enumerate(tables) if t is not None}
    return _OnDevice(arrs) if arrs else None


class MeshFilterQueue:
    """Deferred mesh pixel pipeline for decoded frames.

    Frames enqueue after recon/MC with their remaining pixel passes
    described per entry: an optional sharded residual add (inter-only
    frames), optional LMCS inverse mapping, optional deblocking (host
    segment raster, sharded filter math), then SAO / ALF / CC-ALF — all
    batched over the "gop" axis and row-slab sharded over "tile" with
    halos from the neighbouring slabs.  `drain(needed=...)` lands only the
    frames a subsequent inter frame actually references (the form of the
    reference's row-progress gating, vvc_thread.c:281-296), keeping
    non-referenced frames queued so the gop axis stays >1-deep on inter
    content."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.q = []
        self._shape_key = None

    def add(self, sps, pps, tabs, fb, sh_list, alf_list, slice_rpls=None,
            res_planes=None, lmcs_ctx=None):
        """slice_rpls: run deblock on the mesh (host raster at drain);
        res_planes: per-plane int32 residual arrays to add (recon was
        deferred); lmcs_ctx: (inv_lut np[int32], mask np[bool HxW])."""
        key = (pps.width, pps.height, sps.bit_depth,
               sps.chroma_format_idc)
        if self.q and key != self._shape_key:
            self.drain()
        self._shape_key = key
        self.q.append({"sps": sps, "pps": pps, "tabs": tabs, "fb": fb,
                       "sh_list": sh_list, "alf_list": alf_list,
                       "rpls": slice_rpls, "res": res_planes,
                       "lmcs": lmcs_ctx})

    def drain(self, needed=None):
        """Run the deferred passes.  With `needed` (a set of FrameBuffer
        objects) only those frames land; the rest stay queued."""
        if not self.q:
            return
        if needed is None:
            q, self.q = self.q, []
        else:
            q = [e for e in self.q if e["fb"] in needed]
            if not q:
                return
            self.q = [e for e in self.q if e["fb"] not in needed]
        mesh = self.mesh
        g, t = mesh.shape["gop"], mesh.shape["tile"]
        sps = q[0]["sps"]
        bd, cs = sps.bit_depth, sps.ctb_size_y
        pix_max = (1 << bd) - 1
        nc = 3 if sps.chroma_format_idc else 1
        hs, vs = (sps.hshift[1], sps.vshift[1]) if nc == 3 else (0, 0)
        shape = [p.shape for p in q[0]["fb"].planes[:nc]]
        cuts = frame_cuts(shape[0][0], shape[-1][0], t, vs, nc)
        frames = _pad_frames(q, g)
        per = len(frames) // g
        q = [e for e in frames if e is not None]
        gops = [k // per for k, e in enumerate(frames) if e is not None]

        # --- planes up, as 16-bit samples, cut into the mesh's slabs -----
        planes = [[[s.to(torch.int32) for s in cut_rows(
            torch.from_numpy(as_wire(e["fb"].planes[c])), mesh, gop,
            cuts[c].hs)] for c in range(nc)] for gop, e in zip(gops, q)]

        def per_plane(c, idx, slabs):
            for k, s in zip(idx, slabs):
                planes[k][c] = s

        # --- sharded residual add (deferred recon of inter-only frames) --
        idx = [k for k, e in enumerate(q) if e["res"] is not None]
        for c in range(nc if idx else 0):
            res = [cut_rows(torch.from_numpy(np.asarray(q[k]["res"][c],
                                                         np.int32)),
                            mesh, gops[k], cuts[c].hs) for k in idx]
            per_plane(c, idx, residual_add_sharded(
                [planes[k][c] for k in idx], res, pix_max))

        # --- sharded LMCS inverse mapping (luma) -------------------------
        idx = [k for k, e in enumerate(q) if e["lmcs"] is not None]
        if idx:
            luts = [torch.from_numpy(np.asarray(q[k]["lmcs"][0], np.int32))
                    for k in idx]
            masks = [torch.from_numpy(np.ascontiguousarray(
                q[k]["lmcs"][1][::cs, ::cs], np.int32)) for k in idx]
            per_plane(0, idx, lmcs_batch_sharded(
                [planes[k][0] for k in idx], luts, masks, cuts[0], cs))

        # --- sharded deblocking (host segment raster, device math) ------
        idx = [k for k, e in enumerate(q) if e["rpls"] is not None]
        for vertical in (True, False):
            if not idx:
                break
            rasters = [rasterize_deblock(q[k]["sps"], q[k]["pps"],
                                         q[k]["tabs"], q[k]["fb"],
                                         q[k]["rpls"], vertical)
                       for k in idx]
            for c in range(nc):
                # each frame's real segments as an [N, 7] view
                segs = [a[c][:, :n[c]].T for a, n in rasters]
                if any(len(s) for s in segs):
                    per_plane(c, idx, deblock_batch_sharded(
                        [planes[k][c] for k in idx], segs,
                        "luma" if c == 0 else "chroma", vertical, pix_max,
                        cuts[c]))

        # --- hand-over: 16-bit samples from here to the end --------------
        planes = [[[s.to(torch.int16) for s in p] for p in ps]
                  for ps in planes]
        sizes = [(cs, cs)] + [(cs >> vs, cs >> hs)] * (nc - 1)
        # --- batched sharded SAO, all planes of a slab in one launch -----
        planes = sao_batch_sharded(
            planes, [_sao_params(e, nc) for e in q], sizes, cuts,
            bd - 5, pix_max)
        # --- ALF on the post-SAO planes, CC-ALF from the post-SAO luma ---
        params = [_alf_params(e) for e in q]
        post_sao = [ps[0] for ps in planes]
        planes = alf_batch_sharded(planes, params, cuts, cs, bd, hs,
                                   vs)
        planes = cc_batch_sharded(post_sao, planes, params, cuts, cs,
                                  bd, hs, vs)

        # --- planes down -------------------------------------------------
        for e, ps in zip(q, planes):
            for c in range(nc):
                fb = e["fb"].planes[c]
                fb[:] = join_rows(ps[c], fb.shape[0], "cpu").numpy()
