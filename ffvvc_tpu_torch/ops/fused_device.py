"""The fused post-recon filter chain in PyTorch: one chain call per frame.

Port of `ffvvc_tpu/ops/fused_device.py`.  The whole post-recon chain

    [residual-add] -> LMCS-inverse -> deblock-V -> deblock-H
                   -> SAO -> ALF -> CC-ALF

runs on one torch device: the planes upload once, as int16 samples
(`device.as_wire`: CUDA tensors of uint16 support little more than copies,
and samples have at most 12 bits), every intermediate stays on the device,
and only the final planes download.
Every per-pixel parameter derives on the device from per-CTB and
per-segment parameters that the host builds (the builders below are the
JAX package's, copied as NumPy).  `stats` counts the bytes each way
(`device.upload`, `device.download`).

SAO, ALF and CC-ALF run as hand-written CUDA kernels (`sao_device`,
`alf_device`; csrc/filters.cu) when the tensors are on CUDA, and as their
plain PyTorch versions when they are on the CPU; they take and return the
16-bit wire samples.  LMCS, deblocking and the ALF classification are plain
PyTorch here and compute in int32: a plane is widened when the first of
them touches it and narrowed once at the hand-over to SAO.  Their hand
kernels are in ROADMAP.md (performance work on the main path).  The
per-stage entry points (`sao_device.sao_frame_device`,
`alf_device.alf_frame_device`, `deblock_device.deblock_frame_device`,
`lmcs_device.lmcs_frame_device`) run the same stages one at a time.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import trace
from ..alf import ALF_BORDER_LUMA, ALF_VB_POS_ABOVE_LUMA, _ARG_VAR
from ..sao import SaoFilter
from . import data as D

from .alf_device import (EDGE_BOTTOM, EDGE_LEFT, EDGE_RIGHT, EDGE_TOP,
                         _CHROMA_SLOT, alf_filter_chroma, alf_filter_luma,
                         block_rows, cc_filter)
from . import deblock_device
from .deblock_device import rasterize_deblock, luma_math, chroma_math
from .device import Counters, Slab, as_wire, download, upload
from .sao_device import ctb_tables, sao_apply

# transfer accounting (bytes) and host-clock seconds of the two halves of
# fused_frame_filters: building the parameters on the host (build_s) and
# upload + chain + download (device_s, ends in the download's sync);
# reset with reset_stats()
stats = Counters("up_bytes", "down_bytes", "frames", build_s=0.0,
                 device_s=0.0)

# parameter arrays the chain uses as torch indices: int64 on the device
_INDEX_KEYS = frozenset({"cls_r0", "cls_r3"})


def reset_stats():
    """Zero this chain's counters and those of the per-stage filters."""
    from . import alf_device, lmcs_device, sao_device
    stats.reset()
    for mod in (deblock_device, sao_device, alf_device, lmcs_device):
        mod.reset_stats()


def to_device(arrs, device):
    """The host arrays `build_params` builds as tensors on `device`, each
    uploaded once and counted; the index arrays become int64 after the
    upload."""
    dev = torch.device(device)
    out = {k: upload(a, dev, stats) for k, a in arrs.items()}
    for k in _INDEX_KEYS & out.keys():
        out[k] = out[k].long()
    return out


# ---------------------------------------------------------------------------
# device math
# ---------------------------------------------------------------------------

def expand_ctb(a, cs_v, cs_h, H, W):
    """Per-CTB [ch, cw] -> per-pixel [H, W] (repeat + crop)."""
    return a.repeat_interleave(cs_v, 0).repeat_interleave(cs_h, 1)[:H, :W]


def pad_edge(x, b):
    """[H, W] -> [H + 2b, W + 2b], border samples repeated outward
    (jnp.pad(mode="edge"))."""
    H, W = x.shape
    rows = torch.arange(-b, H + b, device=x.device).clamp_(0, H - 1)
    cols = torch.arange(-b, W + b, device=x.device).clamp_(0, W - 1)
    return x.index_select(0, rows).index_select(1, cols)


def lmcs_apply(y, lut, mask, cs, H, W):
    """LMCS inverse mapping: LUT gather gated per CTB."""
    m = expand_ctb(mask, cs, cs, H, W)
    return torch.where(m != 0, lut[y.long()], y)


def _prod_le(a, b, c, d):
    """Exact a*b <= c*d for int32 operands, compared in int64.  Replaces
    `fused_device._cmp_prod_le`, which splits the products only because
    the TPU code avoids 64-bit integers."""
    return a.long() * b.long() <= c.long() * d.long()


def alf_classify(P3, r0sel, r3sel, blk_start1, blk_end3, blk_ac, nby, nbx,
                 bd):
    """ALF luma classification of a whole plane, or of a batch of windows
    (`fused_device._alf_classify`).  P3: [..., H+6, W+6] padded plane(s);
    r0sel/r3sel: int64 [GH] P3-row indices (VB-substituted); blk_*: [nby]
    per-block-row sum window / activity multiplier.  Returns per-4x4
    (class_idx, transpose_idx) [..., nby, nbx] int32."""
    GH = r0sel.shape[0]
    GW = nbx * 2 + 2
    # row planes of the 2x2 gradient grid (rows I, I+1, I+2, I+3 with
    # substituted I/I+3), cols J..J+3 via slicing
    rI = P3.index_select(-2, r0sel)            # [..., GH, W+6]
    r1 = P3[..., 1::2, :][..., :GH, :]         # rows I+1 (I even)
    r2 = P3[..., 2::2, :][..., :GH, :]
    r3 = P3.index_select(-2, r3sel)

    def cols(r, j):                            # [..., GH, GW] cols J+j, J=2gx
        return r[..., j:j + 2 * GW:2][..., :GW]
    v0 = cols(r1, 1) << 1
    v1 = cols(r2, 2) << 1
    g0 = torch.abs(v0 - cols(rI, 1) - cols(r2, 1)) + \
        torch.abs(v1 - cols(r1, 2) - cols(r3, 2))
    g1 = torch.abs(v0 - cols(r1, 0) - cols(r1, 2)) + \
        torch.abs(v1 - cols(r2, 1) - cols(r2, 3))
    g2 = torch.abs(v0 - cols(rI, 0) - cols(r2, 2)) + \
        torch.abs(v1 - cols(r1, 1) - cols(r3, 3))
    g3 = torch.abs(v0 - cols(rI, 2) - cols(r2, 0)) + \
        torch.abs(v1 - cols(r1, 3) - cols(r3, 1))

    def blksum(g):
        # columns: window of 4 starting at 2bx
        c = g[..., 0:2 * nbx:2] + g[..., 1:2 * nbx + 1:2] + \
            g[..., 2:2 * nbx + 2:2] + g[..., 3:2 * nbx + 3:2]   # [GH, nbx]
        # rows: 2by + j for j in [start, end)
        j0 = c[..., 0:2 * nby:2, :]
        j1 = c[..., 1:2 * nby + 1:2, :]
        j2 = c[..., 2:2 * nby + 2:2, :]
        j3 = c[..., 3:2 * nby + 3:2, :]
        s = j0 + j1 + j2 + j3
        s = s - torch.where(blk_start1[:, None] != 0, j0, 0)
        s = s - torch.where(blk_end3[:, None] != 0, j3, 0)
        return s                                             # [nby, nbx]
    sv = blksum(g0)
    sh_ = blksum(g1)
    d0 = blksum(g2)
    d1 = blksum(g3)

    dir_hv = (sv <= sh_).to(torch.int32)
    hv1 = torch.maximum(sv, sh_)
    hv0 = torch.minimum(sv, sh_)
    dir_d = (d0 <= d1).to(torch.int32)
    dd1 = torch.maximum(d0, d1)
    dd0 = torch.minimum(d0, d1)
    dir1 = _prod_le(dd1, hv0, hv1, dd0).to(torch.int32)
    hvd1 = torch.where(dir1 != 0, hv1, dd1)
    hvd0 = torch.where(dir1 != 0, hv0, dd0)
    sum_hv = sh_ + sv
    arg_var = torch.tensor(_ARG_VAR, dtype=torch.int32, device=P3.device)
    ci = arg_var[torch.clamp((sum_hv * blk_ac[:, None]) >> (bd - 1),
                             0, 15).long()]
    ci = ci + torch.where(hvd1 * 2 > 9 * hvd0, ((dir1 << 1) + 2) * 5,
                          torch.where(hvd1 > 2 * hvd0,
                                      ((dir1 << 1) + 1) * 5, 0))
    ti = dir_d * 2 + dir_hv
    return ci, ti


def alf_classify_ctbs(y, edges, cs, bd, slab=None):
    """ALF luma classification CTB by CTB, as the per-stage entry point
    needs it (`AlfFilter._classify` on `AlfFilter._window`): the window of
    every CTB, cs + 6 samples square, is gathered with its coordinates
    clamped to the picture, or to the CTB itself on the sides its edge word
    names, and all windows are classified in one batch as pictures of one
    CTB.  y: int16 or int32 [H, W] luma; edges: int32 [ch, cw]
    (`alf_device.ctb_edges`).  Returns (class_idx, transpose_idx) int32
    [H / 4, W / 4].  In a CTB that the picture cuts short the rows and
    columns of the window past its end hold repeated samples, which only
    the blocks cropped away read.  With a `Slab` (`device.Slab`), y
    holds a slab of the picture's rows, its halo included, and the result
    covers the 4x4 block rows of the slab's output rows
    (`alf_device.block_rows`): the CTB rows they lie in are classified,
    their windows' rows also clamped to the rows y holds."""
    R, W = y.shape
    sl = slab or Slab.whole(R)
    H = sl.pic_h
    cy0, cy1 = sl.row0 // cs, (sl.row0 + sl.rows - 1) // cs + 1
    edges = edges[cy0:cy1]
    ch, cw = edges.shape
    dev = y.device
    b = ALF_BORDER_LUMA
    k = torch.arange(-b, cs + b, device=dev)
    y0 = (torch.arange(cy0, cy1, device=dev) * cs)[:, None]
    x0 = (torch.arange(cw, device=dev) * cs)[None, :]
    ylo = torch.where(edges & EDGE_TOP != 0, y0, 0)
    yhi = torch.where(edges & EDGE_BOTTOM != 0,
                      torch.clamp(y0 + cs, max=H), H) - 1
    xlo = torch.where(edges & EDGE_LEFT != 0, x0, 0)
    xhi = torch.where(edges & EDGE_RIGHT != 0,
                      torch.clamp(x0 + cs, max=W), W) - 1
    rows = sl.local(torch.clamp(y0[..., None] + k, ylo[..., None],
                                yhi[..., None]), R)
    cols = torch.clamp(x0[..., None] + k, xlo[..., None], xhi[..., None])
    win = y.to(torch.int32)[rows[..., :, None], cols[..., None, :]]
    r0, r3, s1, e3, ac = (torch.from_numpy(a).to(dev)
                          for a in _cls_arrays(cs, cs))
    n = cs // 4
    ci, ti = alf_classify(win, r0.long(), r3.long(), s1, e3, ac, n, n, bd)

    first = (sl.row0 >> 2) - cy0 * n

    def plane(a):       # [ch, cw, n, n] -> [block rows, W / 4]
        return a.permute(0, 2, 1, 3).reshape(ch * n, cw * n)[
            first:first + block_rows(sl), :W // 4].contiguous()
    return plane(ci), plane(ti)


# ---------------------------------------------------------------------------
# the fused chain
# ---------------------------------------------------------------------------

def chain(m, a):
    """m: the structural items (`build_params`' dict); a: `to_device`
    tensors.  Returns the filtered planes as int16 wire samples, in the JAX
    `_chain`'s order."""
    bd = m["bd"]
    pix_max = (1 << bd) - 1
    cs = m["cs"]
    nc = m["nc"]
    # int16 as uploaded; a plain-PyTorch stage widens the plane it touches
    planes = [a[f"p{c}"] for c in range(nc)]

    def wide(c):
        if planes[c].dtype != torch.int32:
            planes[c] = planes[c].to(torch.int32)
        return planes[c]
    # --- residual add (deferred inter recon) ---
    if m["has_res"]:
        for c in range(nc):
            planes[c] = torch.clamp(
                wide(c) + a[f"res{c}"].to(torch.int32), 0, pix_max)
    # --- LMCS inverse (luma) ---
    if m["has_lmcs"]:
        H, W = planes[0].shape
        planes[0] = lmcs_apply(wide(0), a["lmcs_lut"], a["lmcs_mask"],
                               cs, H, W)
    # --- deblock: V then H ---
    for d, vertical in ((0, True), (1, False)):
        for c in range(nc):
            key = f"db{d}c{c}"
            if not m[key]:
                continue
            s = a[key].to(torch.int32)     # uploaded int16 (half traffic)
            math = luma_math if c == 0 else chroma_math
            planes[c] = math(wide(c), *s.unbind(0), vertical, pix_max)
    # --- hand-over: 16-bit samples from here to the end ---
    planes = [p if p.dtype == torch.int16 else p.to(torch.int16)
              for p in planes]
    # --- SAO: every plane that has it, in one call ---
    on = [c for c in range(nc) if m[f"sao{c}"]]
    if on:
        sizes = [(cs >> (m["vs"] if c else 0), cs >> (m["hs"] if c else 0))
                 for c in on]
        done = sao_apply([planes[c] for c in on],
                         [a[f"sao{c}_prm"] for c in on], sizes, bd - 5,
                         pix_max)
        for c, p in zip(on, done):
            planes[c] = p
    post_sao = list(planes)
    # --- ALF luma ---
    if m["alf0"]:
        y = post_sao[0]
        H, W = y.shape
        ci, ti = alf_classify(pad_edge(y, ALF_BORDER_LUMA).to(torch.int32),
                              a["cls_r0"], a["cls_r3"], a["blk_start1"],
                              a["blk_end3"], a["blk_ac"], H // 4, W // 4, bd)
        planes[0] = alf_filter_luma(y, ci, ti, a["alf0_ctb_set"],
                                    a["alf0_cf"], a["alf0_cl"], cs, pix_max)
    # --- ALF chroma (both planes in one call) + CC-ALF ---
    if nc == 3:
        csv = cs >> m["vs"]
        csh = cs >> m["hs"]
        on = [c for c in (1, 2) if m[f"alf{c}"]]
        if on:
            done = alf_filter_chroma(
                [post_sao[c] for c in on], [a[f"alf{c}_set"] for c in on],
                [a[f"alf{c}_cf"] for c in on], [a[f"alf{c}_cl"] for c in on],
                csv, csh, pix_max)
            for c, p in zip(on, done):
                planes[c] = p
        on = [c for c in (1, 2) if m[f"cc{c}"]]
        if on:
            done = cc_filter(
                [planes[c] for c in on], post_sao[0],
                [a[f"cc{c}_set"] for c in on], [a[f"cc{c}_cf"] for c in on],
                csv, csh, m["hs"], m["vs"], 1 << (bd - 1), pix_max)
            for c, p in zip(on, done):
                planes[c] = p
    return tuple(planes)


# ---------------------------------------------------------------------------
# host-side parameter rasterization (ffvvc_tpu/ops/fused_device.py, NumPy)
# ---------------------------------------------------------------------------

def _cls_arrays(H, cs):
    """Classification grid row selectors + block-row windows (luma)."""
    GH = (H + 4) // 2
    gy = np.arange(GH)
    I = 2 * gy
    yloc = I & (cs - 1)
    vb = cs - ALF_VB_POS_ABOVE_LUMA
    r0 = np.where(yloc == vb + 2, I + 1, I).astype(np.int32)
    r3 = np.where(yloc == vb, I + 2, I + 3).astype(np.int32)
    nby = H // 4
    by = np.arange(nby)
    bloc = (4 * by) & (cs - 1)
    start1 = (bloc == vb).astype(np.int32)
    end3 = (bloc + 4 == vb).astype(np.int32)
    ac = np.where((bloc + 4 == vb) | (bloc == vb), 3, 2).astype(np.int32)
    return r0, r3, start1, end3, ac


def _alf_ctb_params(sps, pps, tabs, sh_list, alf_list):
    """Per-CTB ALF set indices + the set tables.  Returns None when ALF
    is entirely off; raises KeyError on a missing APS (caller falls
    back)."""
    ch, cw = pps.ctb_height, pps.ctb_width
    bd = sps.bit_depth
    t = D.tables()
    clip_set = np.array([1 << bd, 1 << (bd - 3), 1 << (bd - 5),
                         1 << (bd - 7)], np.int64)
    out = {}
    # --- luma: unique (fixed/filt_idx | aps_id) -> percls [25, 12] ---
    luma_sets = {None: (np.zeros((25, 12), np.int64),
                        np.ones((25, 12), np.int64))}   # set 0: identity
    set_idx = np.zeros((ch, cw), np.int32)
    aps_map = t["alf_aps_class_to_filt_map"]
    for ry in range(ch):
        for rx in range(cw):
            rs = ry * cw + rx
            if not tabs.alf_ctb_flag[rs, 0]:
                continue
            if tabs.alf_fixed[rs]:
                key = ("fix", int(tabs.alf_filt_idx[rs]))
                if key not in luma_sets:
                    c2f = t["alf_class_to_filt_map"][key[1]]
                    cf = t["alf_fix_filt_coeff"].astype(np.int64)[c2f]
                    cl = np.full((25, 12), clip_set[0], np.int64)
                    luma_sets[key] = (cf, cl)
            else:
                key = ("aps", int(tabs.alf_aps_id[rs, 0]))
                if key not in luma_sets:
                    aps = alf_list[key[1]]
                    cf = aps.luma_coeff[aps_map]
                    cl = clip_set[aps.luma_clip_idx[aps_map]]
                    luma_sets[key] = (cf, cl)
            set_idx[ry, rx] = list(luma_sets).index(key)
    if len(luma_sets) > 1:
        cf = np.stack([v[0] for v in luma_sets.values()]).astype(np.int32)
        cl = np.stack([v[1] for v in luma_sets.values()]).astype(np.int32)
        # per CTB: the 4x4 blocks inherit their CTB's set
        out["alf0_ctb_set"] = set_idx
        out["alf0_cf"] = cf
        out["alf0_cl"] = cl
    # --- chroma: unique (aps_id, alt) -> 12-slot coeff/clip ---
    if sps.chroma_format_idc:
        off = (0, 3, 5, 7)
        for c in (1, 2):
            csets = {None: (np.zeros(12, np.int64), np.ones(12, np.int64))}
            sidx = np.zeros((ch, cw), np.int32)
            any_on = False
            for ry in range(ch):
                for rx in range(cw):
                    rs = ry * cw + rx
                    if not tabs.alf_ctb_flag[rs, c]:
                        continue
                    any_on = True
                    rsh = sh_list[int(tabs.slice_idx[ry, rx])].r
                    aid = rsh.sh_alf_aps_id_chroma
                    alt = int(tabs.alf_alt_idx[rs, c - 1])
                    key = (aid, alt)
                    if key not in csets:
                        aps = alf_list[aid]
                        cf = np.zeros(12, np.int64)
                        cl = np.ones(12, np.int64)
                        for k, slot in enumerate(_CHROMA_SLOT):
                            cf[slot] = aps.chroma_coeff[alt][k]
                            cl[slot] = 1 << (
                                bd - off[int(aps.chroma_clip_idx[alt][k])])
                        csets[key] = (cf, cl)
                    sidx[ry, rx] = list(csets).index(key)
            if any_on:
                out[f"alf{c}_set"] = sidx
                out[f"alf{c}_cf"] = np.stack(
                    [v[0] for v in csets.values()]).astype(np.int32)
                out[f"alf{c}_cl"] = np.stack(
                    [v[1] for v in csets.values()]).astype(np.int32)
        # --- CC-ALF: unique (aps_id, idc) -> 7 coeffs ---
        for c in (1, 2):
            ccsets = {None: np.zeros(7, np.int64)}
            sidx = np.zeros((ch, cw), np.int32)
            any_on = False
            for ry in range(ch):
                for rx in range(cw):
                    rs = ry * cw + rx
                    idc = int(tabs.alf_cc_idc[rs, c - 1])
                    if not idc:
                        continue
                    rsh = sh_list[int(tabs.slice_idx[ry, rx])].r
                    aid = rsh.sh_alf_cc_cb_aps_id if c == 1 else \
                        rsh.sh_alf_cc_cr_aps_id
                    aps = alf_list.get(aid)
                    if aps is None:
                        continue
                    any_on = True
                    key = (aid, idc)
                    if key not in ccsets:
                        ccsets[key] = aps.cc_coeff[c - 1][idc - 1]
                    sidx[ry, rx] = list(ccsets).index(key)
            if any_on:
                out[f"cc{c}_set"] = sidx
                out[f"cc{c}_cf"] = np.stack(
                    list(ccsets.values())).astype(np.int32)
    return out


def eligible(sps, pps, tabs):
    """Structural eligibility for the fused chain (everything else falls
    back to the host stages)."""
    if getattr(sps, "num_ladf_intervals", 0):
        return False        # LADF reads pixel averages mid-deblock
    if not pps.r.pps_loop_filter_across_slices_enabled_flag and \
            tabs.slice_idx.max() > 0:
        return False        # SAO/ALF restore regions at slice edges
    if pps.r.num_tiles_in_pic > 1 and \
            not pps.r.pps_loop_filter_across_tiles_enabled_flag:
        return False
    if pps.width % 8 or pps.height % 8:
        return False        # 4x4 ALF block grid alignment
    return True


def fused_frame_filters(sps, pps, tabs, fb, sh_list, alf_list, lmcs,
                        recon_jobs, slice_rpls, res_planes=None,
                        device="cuda"):
    """Run the whole post-recon pixel chain on `device` for one frame.
    Returns True when the chain ran (planes updated in place); False when
    the frame is ineligible (caller runs the host stages instead)."""
    if not eligible(sps, pps, tabs):
        return False
    t0 = time.perf_counter()
    built = build_params(sps, pps, tabs, fb, sh_list, alf_list, lmcs,
                         recon_jobs, slice_rpls, res_planes)
    if built is None:
        return False        # missing APS etc: host fallback handles it
    meta, arrs = built
    t1 = time.perf_counter()
    with trace.span("fused.upload"):
        arrs = to_device(arrs, device)
    with trace.span("fused.chain"):
        out = chain(meta, arrs)
    with trace.span("fused.download"):
        # synchronises with the device
        res = [download(p, stats) for p in out]
    stats["build_s"] += t1 - t0
    stats["device_s"] += time.perf_counter() - t1
    for c, p in enumerate(res):
        fb.planes[c][:] = p
    stats["frames"] += 1
    return True


@trace.traced("fused.build")
def build_params(sps, pps, tabs, fb, sh_list, alf_list, lmcs, recon_jobs,
                 slice_rpls, res_planes):
    """The chain's host half: its metadata and the host arrays `to_device`
    uploads, or None where an APS the frame names is missing."""
    nc = 3 if sps.chroma_format_idc else 1
    meta = {"bd": sps.bit_depth, "cs": sps.ctb_size_y, "nc": nc,
            "hs": sps.hshift[1] if nc == 3 else 0,
            "vs": sps.vshift[1] if nc == 3 else 0}
    arrs = {}
    # --- planes (+ deferred residual); uint16/int16 on the wire ---
    for c in range(nc):
        arrs[f"p{c}"] = as_wire(fb.planes[c])
    meta["has_res"] = res_planes is not None
    if res_planes is not None:
        # spec residual range is [-2^15, 2^15-1] == int16 — except under
        # sps_extended_precision_flag (range up to +-2^20)
        rdt = np.int32 if sps.r.sps_extended_precision_flag else np.int16
        for c in range(nc):
            arrs[f"res{c}"] = np.asarray(res_planes[c], rdt)
    # --- LMCS ---
    meta["has_lmcs"] = False
    if lmcs is not None:
        mask = np.zeros((pps.ctb_height, pps.ctb_width), np.int32)
        for rec, ctus in recon_jobs:
            if not rec.lmcs_used:
                continue
            for rs, rx, ry in ctus:
                mask[ry, rx] = 1
        if mask.any():
            meta["has_lmcs"] = True
            arrs["lmcs_lut"] = np.asarray(lmcs.inv_lut, np.int32)
            arrs["lmcs_mask"] = mask
    # --- deblock segments ---
    with trace.span("fused.deblock_raster"):
        for d, vertical in ((0, True), (1, False)):
            segs, counts = rasterize_deblock(sps, pps, tabs, fb, slice_rpls,
                                             vertical)
            for c in range(nc):
                meta[f"db{d}c{c}"] = bool(counts[c])
                if counts[c]:
                    arrs[f"db{d}c{c}"] = segs[c]
    # --- SAO ---
    with trace.span("fused.sao_tables"):
        tables = ctb_tables(SaoFilter(sps, pps, tabs, fb), nc)
    for c in range(nc):
        meta[f"sao{c}"] = tables[c] is not None
        if tables[c] is not None:
            arrs[f"sao{c}_prm"] = tables[c]
    # --- ALF ---
    for key in ("alf0", "alf1", "alf2", "cc1", "cc2"):
        meta[key] = False
    if sps.r.sps_alf_enabled_flag and sh_list is not None and \
            (tabs.alf_ctb_flag.any() or tabs.alf_cc_idc.any()):
        with trace.span("fused.alf_params"):
            try:
                ap = _alf_ctb_params(sps, pps, tabs, sh_list, alf_list)
            except (KeyError, AttributeError, IndexError):
                return None
            arrs.update(ap)
            if "alf0_ctb_set" in ap:
                meta["alf0"] = True
                r0, r3, s1, e3, ac = _cls_arrays(pps.height, sps.ctb_size_y)
                arrs.update(cls_r0=r0, cls_r3=r3, blk_start1=s1,
                            blk_end3=e3, blk_ac=ac)
        for key in ("alf1", "alf2", "cc1", "cc2"):
            meta[key] = f"{key}_set" in ap
    return meta, arrs
