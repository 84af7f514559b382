"""The fused post-recon filter chain in PyTorch: one chain call per frame.

Port of `ffvvc_tpu/ops/fused_device.py`.  The whole post-recon chain

    [residual-add] -> LMCS-inverse -> deblock-V -> deblock-H
                   -> SAO -> ALF -> CC-ALF

runs on one torch device: the planes upload once (uint16 samples on the
wire, sent as int16 because CUDA tensors of uint16 support little more than
copies; samples are at most 12 bits so the bytes are the same), every
intermediate stays on the device, and only the final planes download.
Every per-pixel parameter derives on the device from per-CTB and
per-segment parameters that the host builds (the builders below are the
JAX package's, copied as NumPy).  `stats` counts the bytes each way with
the same accounting as the JAX package.

SAO, ALF and CC-ALF run as hand-written CUDA kernels (`sao_device`,
`alf_device`; csrc/filters.cu) when the tensors are on CUDA, and as their
plain PyTorch twins when they are on the CPU.  LMCS, deblocking and the
ALF classification are plain PyTorch here; their hand kernels are
ROADMAP.md queue 1 item 6.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ffvvc_tpu.alf import (ALF_BORDER_LUMA, ALF_BORDER_CHROMA,
                           ALF_VB_POS_ABOVE_LUMA, ALF_VB_POS_ABOVE_CHROMA,
                           _TRANSPOSE_IDX, _ARG_VAR)
from ffvvc_tpu.sao import SaoFilter, SAO_BAND, _EDGE_IDX
from ffvvc_tpu.ops import data as D

from .alf_device import (_CHROMA_SLOT, _vb_row_offsets, LUMA_SLOTS,
                         CHROMA_SLOTS, alf_filter_plane, cc_filter)
from .deblock_device import (rasterize_deblock, _pad_pow2, luma_math,
                             chroma_math)
from .sao_device import _log2, expand_ctb, pad_edge, sao_apply

# transfer accounting (bytes) and host-clock seconds of the two halves of
# fused_frame_filters: building the parameters on the host (build_s) and
# upload + chain + download (device_s, ends in the download's sync);
# reset with reset_stats()
stats = {"up_bytes": 0, "down_bytes": 0, "frames": 0, "build_s": 0.0,
         "device_s": 0.0}

# parameter arrays the chain uses as indices: int64 on the device
_INDEX_KEYS = frozenset({"cls_r0", "cls_r3", "alf0_row", "alfc_row",
                         "cc_row", "alf0_set", "alf1_set", "alf2_set",
                         "cc1_set", "cc2_set"})


def reset_stats():
    stats.update(up_bytes=0, down_bytes=0, frames=0, build_s=0.0,
                 device_s=0.0)


def _up(a):
    """Stage a host array for upload, counting its bytes."""
    a = np.ascontiguousarray(a)
    stats["up_bytes"] += a.nbytes
    return a


def to_device(arrs, device):
    """The chain's per-frame parameter dict (the numpy arrays the JAX
    `_chain` receives) as tensors on `device`: uint16 planes travel as
    int16 (same bytes), index arrays become int64 after the upload."""
    dev = torch.device(device)
    out = {}
    for k, a in arrs.items():
        # torch.from_numpy shares memory: copy read-only arrays (e.g. views
        # of JAX arrays) rather than alias them as writable tensors
        a = np.require(a, requirements=["C", "W"])
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        t = torch.from_numpy(a).to(dev)
        out[k] = t.long() if k in _INDEX_KEYS else t
    return out


# ---------------------------------------------------------------------------
# device math
# ---------------------------------------------------------------------------

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
    """Whole-frame ALF luma classification (`fused_device._alf_classify`).
    P3: [H+6, W+6] padded plane; r0sel/r3sel: int64 [GH] P3-row indices
    (VB-substituted); blk_*: [nby] per-block-row sum window / activity
    multiplier.  Returns per-4x4 (class_idx, transpose_idx) [nby, nbx]
    int32."""
    GH = r0sel.shape[0]
    GW = nbx * 2 + 2
    # row planes of the 2x2 gradient grid (rows I, I+1, I+2, I+3 with
    # substituted I/I+3), cols J..J+3 via slicing
    rI = P3.index_select(0, r0sel)            # [GH, W+6]
    r1 = P3[1::2][:GH]                         # rows I+1 (I even)
    r2 = P3[2::2][:GH]
    r3 = P3.index_select(0, r3sel)

    def cols(r, j):                            # [GH, GW] cols J+j, J=2gx
        return r[:, j:j + 2 * GW:2][:, :GW]
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
        c = g[:, 0:2 * nbx:2] + g[:, 1:2 * nbx + 1:2] + \
            g[:, 2:2 * nbx + 2:2] + g[:, 3:2 * nbx + 3:2]   # [GH, nbx]
        # rows: 2by + j for j in [start, end)
        j0 = c[0:2 * nby:2]
        j1 = c[1:2 * nby + 1:2]
        j2 = c[2:2 * nby + 2:2]
        j3 = c[3:2 * nby + 3:2]
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


# ---------------------------------------------------------------------------
# the fused chain
# ---------------------------------------------------------------------------

def chain(meta, a):
    """meta: the structural items (a dict, or JAX's sorted tuple of
    items); a: `to_device` tensors.  Returns the filtered planes as int16
    (the uint16 wire samples), in the JAX `_chain`'s order."""
    m = dict(meta)
    bd = m["bd"]
    pix_max = (1 << bd) - 1
    cs = m["cs"]
    nc = m["nc"]
    planes = [a[f"p{c}"].to(torch.int32) for c in range(nc)]
    # --- residual add (deferred inter recon) ---
    if m["has_res"]:
        for c in range(nc):
            planes[c] = torch.clamp(
                planes[c] + a[f"res{c}"].to(torch.int32), 0, pix_max)
    # --- LMCS inverse (luma) ---
    if m["has_lmcs"]:
        H, W = planes[0].shape
        planes[0] = lmcs_apply(planes[0], a["lmcs_lut"], a["lmcs_mask"],
                               cs, H, W)
    # --- deblock: V then H ---
    for d, vertical in ((0, True), (1, False)):
        for c in range(nc):
            key = f"db{d}c{c}"
            if not m[key]:
                continue
            s = a[key].to(torch.int32)     # uploaded int16 (half traffic)
            math = luma_math if c == 0 else chroma_math
            planes[c] = math(planes[c], *s.unbind(0), vertical, pix_max)
    # --- SAO ---
    shift = bd - 5
    for c in range(nc):
        if not m[f"sao{c}"]:
            continue
        hs = m["hs"] if c else 0
        vs = m["vs"] if c else 0
        planes[c] = sao_apply(
            planes[c],
            {k: a[f"sao{c}_{k}"] for k in
             ("typ", "m1", "offs", "kl", "kr", "kt", "kb", "ax", "bx")},
            cs >> vs, cs >> hs, shift, pix_max)
    post_sao = list(planes)
    # --- ALF luma ---
    P3l = None
    if m["alf0"]:
        y = post_sao[0]
        H, W = y.shape
        P3l = pad_edge(y, ALF_BORDER_LUMA)
        ci, ti = alf_classify(P3l, a["cls_r0"], a["cls_r3"],
                              a["blk_start1"], a["blk_end3"], a["blk_ac"],
                              H // 4, W // 4, bd)
        setidx = a["alf0_set"]                       # [nby, nbx]
        perm = torch.tensor(_TRANSPOSE_IDX, device=y.device)[ti.long()]
        cfb = torch.gather(a["alf0_cf"][setidx, ci.long()], 2, perm)
        clb = torch.gather(a["alf0_cl"][setidx, ci.long()], 2, perm)
        planes[0] = alf_filter_plane(y, P3l, a["alf0_row"], a["alf0_vb"],
                                     cfb.contiguous(), clb.contiguous(),
                                     2, 2, LUMA_SLOTS, ALF_BORDER_LUMA,
                                     pix_max)
    # --- ALF chroma + CC-ALF ---
    half = 1 << (bd - 1)
    for c in (1, 2):
        if nc == 1:
            break
        out = planes[c]
        csv = cs >> m["vs"]
        csh = cs >> m["hs"]
        if m[f"alf{c}"]:
            src = post_sao[c]
            sidx = a[f"alf{c}_set"]                  # [ch, cw]
            out = alf_filter_plane(
                src, pad_edge(src, ALF_BORDER_CHROMA), a["alfc_row"],
                a["alfc_vb"], a[f"alf{c}_cf"][sidx].contiguous(),
                a[f"alf{c}_cl"][sidx].contiguous(), _log2(csv, "cs_v"),
                _log2(csh, "cs_h"), CHROMA_SLOTS, ALF_BORDER_CHROMA,
                pix_max)
        if m[f"cc{c}"]:
            if P3l is None:
                P3l = pad_edge(post_sao[0], ALF_BORDER_LUMA)
            ccb = a[f"cc{c}_cf"][a[f"cc{c}_set"]]    # [ch, cw, 7]
            out = cc_filter(out, P3l, a["cc_row"], a["cc_skip"],
                            ccb.contiguous(), csv, csh, m["hs"], half,
                            pix_max)
        planes[c] = out
    return tuple(p.to(torch.int16) for p in planes)


# ---------------------------------------------------------------------------
# host-side parameter rasterization (ffvvc_tpu/ops/fused_device.py, NumPy)
# ---------------------------------------------------------------------------

def _sao_ctb_params(sf, c, sps, pps, tabs):
    """Per-CTB SAO parameter arrays for component c, or None if SAO is
    off on the whole plane.  Requires restore-free streams (the caller
    gates on loop-filter-across flags)."""
    ch, cw = pps.ctb_height, pps.ctb_width
    hs, vs = sps.hshift[c], sps.vshift[c]
    W = pps.width >> hs
    H = pps.height >> vs
    z = lambda: np.zeros((ch, cw), np.int32)
    typ, m1 = z(), z()
    offs = np.zeros((5, ch, cw), np.int32)
    kl, kr, kt, kb, ax = z(), z(), z(), z(), z()
    bx = np.full((ch, cw), 1 << 30, np.int32)
    any_on = False
    for ry in range(ch):
        for rx in range(cw):
            rs = ry * cw + rx
            t = int(tabs.sao_type[rs, c])
            if t == 0:
                continue
            any_on = True
            typ[ry, rx] = t
            off = tabs.sao_offset[rs, c]
            if t == SAO_BAND:
                m1[ry, rx] = int(tabs.sao_band_pos[rs, c])
                for k in range(4):
                    offs[k, ry, rx] = off[k + 1]
                continue
            eo = int(tabs.sao_eo_class[rs, c])
            m1[ry, rx] = eo
            for i in range(5):
                offs[i, ry, rx] = off[_EDGE_IDX[i]]
            edges = [rx == 0, ry == 0, rx == cw - 1, ry == ch - 1]
            x0 = (rx << sps.ctb_log2_size_y) >> hs
            w = min(sps.ctb_size_y >> hs, W - x0)
            init_x, rw = 0, w
            if eo != 1:
                if edges[0]:
                    kl[ry, rx] = 1
                    init_x = 1
                if edges[2]:
                    kr[ry, rx] = 1
                    rw = w - 1
            if eo != 0:
                if edges[1]:
                    kt[ry, rx] = 1
                if edges[3]:
                    kb[ry, rx] = 1
                ax[ry, rx] = init_x
                bx[ry, rx] = rw
    if not any_on:
        return None
    return dict(typ=typ, m1=m1, offs=offs, kl=kl, kr=kr, kt=kt, kb=kb,
                ax=ax, bx=bx)


def _alf_vb_arrays(H, cs_v, border, vb_above, is_luma):
    """Global tap row-index [7, H] + near-vb [H] arrays composed from the
    per-CTB-row _vb_row_offsets."""
    rowsel = np.zeros((7, H), np.int32)
    vbsel = np.zeros(H, np.int32)
    y0 = 0
    while y0 < H:
        h = min(cs_v, H - y0)
        vb = cs_v - vb_above
        o = _vb_row_offsets(h, vb, is_luma)
        ys = np.arange(h)
        rowsel[:, y0:y0 + h] = border + y0 + ys[None, :] + o
        vbsel[y0:y0 + h] = ((ys >= vb - 1) & (ys <= vb)).astype(np.int32)
        y0 += h
    return rowsel, vbsel


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


def _cc_arrays(Hc, cs, vs):
    """CC-ALF luma tap row indices [4, Hc] + skip [Hc]."""
    b = ALF_BORDER_LUMA
    cs_v = cs >> vs
    rowsel = np.zeros((4, Hc), np.int32)
    skip = np.zeros(Hc, np.int32)
    y0 = 0
    while y0 < Hc:
        h = min(cs_v, Hc - y0)
        vb = (cs_v << vs) - ALF_VB_POS_ABOVE_LUMA
        yy = np.arange(h)
        pos = yy << vs
        sk = (vs == 0) & ((pos == vb) | (pos == vb + 1))
        r0 = pos - 1
        r1 = pos.copy()
        r2 = pos + 1
        r3 = pos + 2
        mm = (pos == vb - 2) | (pos == vb + 1)
        r3 = np.where(mm, r2, r3)
        mm = (pos == vb - 1) | (pos == vb)
        r3 = np.where(mm, r1, r3)
        r2 = np.where(mm, r1, r2)
        r0 = np.where(mm, r1, r0)
        base = b + (y0 << vs)
        for j, rr in enumerate((r0, r1, r2, r3)):
            rowsel[j, y0:y0 + h] = base + rr
        skip[y0:y0 + h] = sk.astype(np.int32)
        y0 += h
    return rowsel, skip


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
        # per-4x4-block set index (blocks inherit their CTB's set)
        nby, nbx = pps.height // 4, pps.width // 4
        blky = np.minimum(np.arange(nby) * 4 // sps.ctb_size_y, ch - 1)
        blkx = np.minimum(np.arange(nbx) * 4 // sps.ctb_size_y, cw - 1)
        out["alf0_set"] = set_idx[np.ix_(blky, blkx)]
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
    nc = 3 if sps.chroma_format_idc else 1
    meta = {"bd": sps.bit_depth, "cs": sps.ctb_size_y, "nc": nc,
            "hs": sps.hshift[1] if nc == 3 else 0,
            "vs": sps.vshift[1] if nc == 3 else 0}
    arrs = {}
    # --- planes (+ deferred residual); uint16/int16 on the wire ---
    for c in range(nc):
        arrs[f"p{c}"] = _up(np.asarray(fb.planes[c], np.uint16))
    meta["has_res"] = res_planes is not None
    if res_planes is not None:
        # spec residual range is [-2^15, 2^15-1] == int16 — except under
        # sps_extended_precision_flag (range up to +-2^20)
        rdt = np.int32 if sps.r.sps_extended_precision_flag else np.int16
        for c in range(nc):
            arrs[f"res{c}"] = _up(np.asarray(res_planes[c], rdt))
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
            arrs["lmcs_lut"] = _up(np.asarray(lmcs.inv_lut, np.int32))
            arrs["lmcs_mask"] = _up(mask)
    # --- deblock segments ---
    for d, vertical in ((0, True), (1, False)):
        ras = rasterize_deblock(sps, pps, tabs, fb, slice_rpls, vertical)
        for c in range(nc):
            segs = ras.luma_segs if c == 0 else \
                (ras.chroma_segs.get(c) or [])
            meta[f"db{d}c{c}"] = bool(segs)
            if segs:
                # int16 on the wire: px/py < 2^15 for any level-supported
                # picture, tc <= 1580 (12-bit), beta <= 1408
                B = _pad_pow2(len(segs))
                a = np.zeros((7, B), np.int16)
                a[:, :len(segs)] = np.asarray(segs, np.int16).T
                arrs[f"db{d}c{c}"] = _up(a)
    # --- SAO ---
    sf = SaoFilter(sps, pps, tabs, fb)
    for c in range(nc):
        p = None
        if tabs.sao_type[:, c].any():
            p = _sao_ctb_params(sf, c, sps, pps, tabs)
        meta[f"sao{c}"] = p is not None
        if p is not None:
            for k, v in p.items():
                arrs[f"sao{c}_{k}"] = _up(v)
    # --- ALF ---
    for key in ("alf0", "alf1", "alf2", "cc1", "cc2"):
        meta[key] = False
    if sps.r.sps_alf_enabled_flag and sh_list is not None and \
            (tabs.alf_ctb_flag.any() or tabs.alf_cc_idc.any()):
        try:
            ap = _alf_ctb_params(sps, pps, tabs, sh_list, alf_list)
        except (KeyError, AttributeError, IndexError):
            return False    # missing APS etc: host fallback handles it
        for k, v in ap.items():
            arrs[k] = _up(v)
        H, W = pps.height, pps.width
        cs = sps.ctb_size_y
        if "alf0_set" in ap:
            meta["alf0"] = True
            r0, r3, s1, e3, ac = _cls_arrays(H, cs)
            arrs["cls_r0"] = _up(r0)
            arrs["cls_r3"] = _up(r3)
            arrs["blk_start1"] = _up(s1)
            arrs["blk_end3"] = _up(e3)
            arrs["blk_ac"] = _up(ac)
            rowsel, vbsel = _alf_vb_arrays(H, cs, ALF_BORDER_LUMA,
                                           ALF_VB_POS_ABOVE_LUMA, True)
            arrs["alf0_row"] = _up(rowsel)
            arrs["alf0_vb"] = _up(vbsel)
        if nc == 3:
            hs, vs = meta["hs"], meta["vs"]
            Hc = H >> vs
            if ("alf1_set" in ap) or ("alf2_set" in ap):
                rowsel, vbsel = _alf_vb_arrays(
                    Hc, cs >> vs, ALF_BORDER_CHROMA,
                    ALF_VB_POS_ABOVE_CHROMA, False)
                arrs["alfc_row"] = _up(rowsel)
                arrs["alfc_vb"] = _up(vbsel)
                meta["alf1"] = "alf1_set" in ap
                meta["alf2"] = "alf2_set" in ap
            if ("cc1_set" in ap) or ("cc2_set" in ap):
                rowsel, skip = _cc_arrays(Hc, cs, vs)
                arrs["cc_row"] = _up(rowsel)
                arrs["cc_skip"] = _up(skip)
                meta["cc1"] = "cc1_set" in ap
                meta["cc2"] = "cc2_set" in ap
    t1 = time.perf_counter()
    out = chain(meta, to_device(arrs, device))
    res = [p.cpu().numpy() for p in out]    # synchronises with the device
    stats["build_s"] += t1 - t0
    stats["device_s"] += time.perf_counter() - t1
    for c in range(nc):
        stats["down_bytes"] += res[c].nbytes
        fb.planes[c][:] = res[c]
    stats["frames"] += 1
    return True
