"""Device intra prediction: wavefront-batched, bit-exact.

Port of the C-planner path of `ffvvc_tpu/ops/intra_device.py` (reference
analogue: libavcodec/vvc/vvc_intra.c:119-263, the recon walk, and
vvc_intra_template.c:467-1015, edge preparation and the predictors).  Intra
prediction is the one pixel stage whose data dependencies (a block predicts
from its reconstructed left and top neighbours) fight batching, so the work
splits in two:

* On the host, the native planner (`plan_intra_ctus`, native/vvc_recon.c)
  walks the frame's CU records and emits one 26-int32 descriptor per
  predict unit: geometry, availability, the mode's angle and filters, and a
  WAVE, one more than the greatest wave among the units that produce its
  reference samples.  Units of one wave are independent.  The descriptors
  are sorted by (wave, kind, w, h, luma/chroma) into buckets and turned into
  21-int32 geo rows; CCLM units get a NumPy plan each
  (`_cclm_plan_from_desc`).  The residuals come from the native record walk
  in residual-only mode (`NativeRecon.residual_ctus`).
* On `device`, the reference-sample gather plans of every unit are built
  from the geo rows at once (`_edge_idx`), then the buckets run in wave
  order on one stream: each gathers and [1 2 1]-filters its references
  from the plane (`_gather_edges`), projects the side references of
  angular modes (`_proj_idx`), predicts (planar/DC/vertical/horizontal with
  PDPC, angular with PDPC, MIP, CCLM), adds the residual window, clips and
  writes the samples back into the plane (`_finish`).  The planes,
  residuals, geo rows and CCLM plans go up once a frame; the planes come
  down once.

Plain PyTorch, as the functions are XLA functions (`jax.jit`) in the JAX
package: no Pallas kernel there, no hand kernel here.  Integer math in
int32 as the JAX functions run it (`jax_enable_x64` is never set), except
the CCLM product, which is int64 as in the golden model (recon.py); no value
of a decode reaches 2^31 there.  Indices that only thrown-away lanes take
out of range (the angular PDPC side gather) are clamped; every index a kept
lane reads is in range.

Left behind from the JAX module: the Python planner (`IntraPlanner`,
`records_to_cus`, `_frame_device_intra_py`), the unused `k_simple`,
`k_cclm`, `k_angular`, `k_mip` and the packed `k_*_p` entry points, the
power-of-two bucket padding (it spares XLA a compile; eager PyTorch
compiles nothing), and the `FFVVC_INTRA_PLANNER`, `FFVVC_INTRA_PLAN_ONLY`
and `FFVVC_PLAN_DEBUG` switches, whose numbers `stats` keeps.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace
from . import data as D
from . import resolve_device
from .device import Counters, download, upload
from ..ctu import INTRA_PLANAR, INTRA_DC, INTRA_HORZ, INTRA_VERT, \
    INTRA_LT_CCLM

I32 = torch.int32

PAD = 68          # negative-index headroom (golden _edge_params PAD)
NREF = 288        # per-side reference array length (PAD + 2*64 + extra)

K_SIMPLE, K_ANG_V, K_ANG_H, K_MIP, K_CCLM = range(5)

# descriptor columns of plan_intra_ctus (vvc_recon.h PL_*)
(PL_KIND, PL_C_IDX, PL_X, PL_Y, PL_W, PL_H, PL_MODE, PL_ANGLE,
 PL_INV_ANGLE, PL_REF_IDX, PL_FF, PL_PDPC, PL_NSCALE, PL_LA, PL_TA,
 PL_CUL, PL_UNF_LEFT, PL_UNF_TOP, PL_REFW, PL_REFH, PL_LEFT_SIZE,
 PL_RFFFSM, PL_AUX0, PL_AUX1, PL_WAVE, PL_RSVD) = range(26)

# geo row columns: what the device functions read of a unit
(G_X, G_Y, G_YF, G_BASE, G_LA, G_TA, G_CUL, G_REF, G_UNFL, G_UNFT,
 G_REFW, G_REFH, G_LSIZE, G_RFFFSM, G_ANGLE, G_INV, G_FF, G_PDPC,
 G_NSCALE, G_A0, G_A1) = range(21)

_DIV_SIG_NP = np.array([0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0],
                       np.int32)

# What the calls since reset_stats() did.  `frames` counts the frames
# reconstructed on the device, `declined` those the planner refused (the
# native C walk then reconstructs them).  The *_s are host-clock seconds:
# walk_s the native plan walk, build_s the bucket build without the CCLM
# plans, cclm_s the CCLM plans, residual_s the native residual walk,
# queue_s the uploads and the queueing of every bucket (no synchronisation
# of its own), download_s the download, which waits for the device.
# last_plan_s is the walk and the build of the last frame, CCLM included.
stats = Counters("frames", "declined", "units", "waves", "simple_buckets",
                 "angular_buckets", "mip_buckets", "cclm_buckets",
                 "cclm_units", "up_bytes", "down_bytes",
                 **dict.fromkeys(("walk_s", "build_s", "cclm_s",
                                  "residual_s", "queue_s", "download_s",
                                  "last_plan_s"), 0.0))
reset_stats = stats.reset


# ---- constants, held once per device ----------------------------------------

@functools.lru_cache()
def _intra_filters_np():
    # stacked [2, 32, 4]: fC (cubic) then fG (smoothing)
    return np.stack([np.asarray(D.intra_filter(0)),
                     np.asarray(D.intra_filter(1))]).astype(np.int32)


@functools.lru_cache()
def _mip_bank_np(size_id: int):
    t = D.tables()
    m = t[("mip_4x4", "mip_8x8", "mip_16x16")[size_id]]
    ps = (4, 4, 8)[size_id]
    return np.ascontiguousarray(m).reshape(
        m.shape[0], ps * ps, -1).astype(np.int32)


@functools.lru_cache()
def _const(name, device):
    """A constant table on `device`, uploaded once."""
    if name == "filters":
        a = _intra_filters_np()
    elif name.startswith("mip"):
        a = _mip_bank_np(int(name[3:]))
    elif name == "div_sig":
        a = _DIV_SIG_NP
    else:       # "pow2": the bit-length thresholds 1 << i, i < 20
        a = (1 << np.arange(20)).astype(np.int32)
    return torch.from_numpy(a).to(device)


@functools.lru_cache(maxsize=None)
def _arange(n, device, start=0):
    """int32 start .. start + n - 1 on `device` (never written to)."""
    return torch.arange(start, start + n, dtype=I32, device=device)


# ---- gather plans from the geo rows -----------------------------------------

def _edge_idx(g, W):
    """geo [B, 21] int32 -> (Lidx, Tidx [B, NREF] int32, fmL, fmT bool):
    each reference sample's flat plane index (-1: the mid value), and
    which samples the [1 2 1] filter replaces.  W: the plane's width, an
    int or a [B, 1] tensor of each row's."""
    ii = _arange(NREF, g.device, -PAD)[None, :]
    x = g[:, G_X, None]
    y = g[:, G_Y, None]
    la = g[:, G_LA, None]
    ta = g[:, G_TA, None]
    cul = g[:, G_CUL, None]
    rl = -1 - g[:, G_REF, None]
    unf_l = g[:, G_UNFL, None]
    unf_t = g[:, G_UNFT, None]
    b = g[:, G_BASE, None]
    corner_common = torch.where(
        la > 0, b + y * W + (x + rl),
        torch.where(ta > 0, b + (y + rl) * W + x, -1))
    cornerL = torch.where(cul != 0, b + (y + ii) * W + (x + rl),
                          corner_common)
    cornerT = torch.where(cul != 0, b + (y + rl) * W + (x + ii),
                          corner_common)
    corner_m1_L = torch.where(cul != 0, b + (y - 1) * W + (x + rl),
                              corner_common)
    corner_m1_T = torch.where(cul != 0, b + (y + rl) * W + (x - 1),
                              corner_common)
    ip = torch.minimum(ii.clamp(min=0), (la - 1).clamp(min=0))
    Lmain = torch.where(la > 0, b + (y + ip) * W + (x + rl), corner_m1_L)
    tp = torch.minimum(ii.clamp(min=0), (ta - 1).clamp(min=0))
    Tmain = torch.where(ta > 0, b + (y + rl) * W + (x + tp), corner_m1_T)
    Lidx = torch.where(ii >= unf_l, -1,
                       torch.where(ii >= 0, Lmain,
                                   torch.where(ii >= rl, cornerL, -1)))
    Tidx = torch.where(ii >= unf_t, -1,
                       torch.where(ii >= 0, Tmain,
                                   torch.where(ii >= rl, cornerT, -1)))
    fsm = g[:, G_RFFFSM, None] != 0
    ul = (g[:, G_LSIZE, None] == unf_l).to(I32)
    fmL = fsm & ((ii == -1) | ((ii >= 0) & (ii < unf_l - ul)))
    fmT = fsm & ((ii == -1) | ((ii >= 0) & (ii < unf_t - ul)))
    return Lidx, Tidx, fmL, fmT


def _proj_idx(g, w: int, h: int, is_v: bool):
    """geo [B, 21] -> (projL, projT [B, NREF] int32): indices into
    cat(L, T) that extend the main reference side with the projected
    samples of the other side (angular modes)."""
    ii = _arange(NREF, g.device, -PAD)[None, :]
    angle = g[:, G_ANGLE, None]
    inv_angle = g[:, G_INV, None]
    ref_idx = g[:, G_REF, None]
    refw = g[:, G_REFW, None]
    refh = g[:, G_REFH, None]
    projL = _arange(NREF, g.device)[None, :]
    projT = projL + NREF
    xx = ii + ref_idx + 1
    if is_v:
        idxs = -1 - ref_idx + ((xx * inv_angle + 256) >> 9).clamp(max=h)
        neg = (angle < 0) & (xx >= -h) & (xx < 0)
        hi = refw + max(1, w // h) * ref_idx + 2
        pos = (angle >= 0) & (ii >= refw) & (ii < hi)
        projT = torch.where(neg, PAD + idxs,
                            torch.where(pos, NREF + PAD + refw - 1, projT))
        projL = projL.expand(g.shape[0], NREF)
    else:
        idxs = -1 - ref_idx + ((xx * inv_angle + 256) >> 9).clamp(max=w)
        neg = (angle < 0) & (xx >= -w) & (xx < 0)
        hi = refh + max(1, h // w) * ref_idx + 2
        pos = (angle >= 0) & (ii >= refh) & (ii < hi)
        projL = torch.where(neg, NREF + PAD + idxs,
                            torch.where(pos, PAD + refh - 1, projL))
        projT = projT.expand(g.shape[0], NREF)
    return projL, projT


# ---- the predictors ---------------------------------------------------------

def _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT):
    """pix: [N] flat plane; returns filtered (L, T) [B, NREF] int32."""
    n = pix.shape[0]
    rawL = torch.where(Lidx >= 0, pix[Lidx.clamp(0, n - 1)], mid)
    rawT = torch.where(Tidx >= 0, pix[Tidx.clamp(0, n - 1)], mid)

    def f121(a):
        return (F.pad(a[:, :-1], (1, 0)) + 2 * a + F.pad(a[:, 1:], (0, 1))
                + 2) >> 2

    corner = (rawL[:, PAD] + 2 * rawL[:, PAD - 1] + rawT[:, PAD] + 2) >> 2
    fLv = f121(rawL)
    fLv[:, PAD - 1] = corner
    fTv = f121(rawT)
    fTv[:, PAD - 1] = corner
    return torch.where(fmL, fLv, rawL), torch.where(fmT, fTv, rawT)


def _res_window(res, xs, ys, w, h, W):
    dev = res.device
    base = ys * W + xs
    off = _arange(h, dev)[:, None] * W + _arange(w, dev)[None, :]
    idx = base[:, None, None] + off
    return res[idx], idx


def _finish(pix, res, pred, xs, ys, w, h, W, mx):
    """clip(pred + residual window), written into the plane in place (the
    units of a bucket cover disjoint samples); returns the plane."""
    rw, idx = _res_window(res, xs, ys, w, h, W)
    out = torch.clamp(pred + rw, 0, mx)
    pix[idx.reshape(-1)] = out.to(I32).reshape(-1)
    return pix


def _simple_impl(pix, res, Lidx, Tidx, fmL, fmT, xs, ys, sel, pdpc,
                 w: int, h: int, W: int, bd: int):
    """planar / DC / vertical / horizontal (+ PDPC), per-block select."""
    dev = pix.device
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    L, T = _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT)
    t = T[:, PAD:PAD + w]                       # [B, w]
    l = L[:, PAD:PAD + h]                       # [B, h]
    logw, logh = w.bit_length() - 1, h.bit_length() - 1
    # planar
    ysr = _arange(h, dev)
    xsr = _arange(w, dev)
    pv = ((h - 1 - ysr)[None, :, None] * t[:, None, :] +
          (ysr + 1)[None, :, None] * L[:, PAD + h, None, None]) << logw
    ph_ = ((w - 1 - xsr)[None, None, :] * l[:, :, None] +
           (xsr + 1)[None, None, :] * T[:, PAD + w, None, None]) << logh
    planar = (pv + ph_ + w * h) >> (logw + logh + 1)
    # dc
    offset = (w << 1) if w == h else max(w, h)
    shift = offset.bit_length() - 1
    if w == h:
        s = t.sum(1, dtype=I32) + l.sum(1, dtype=I32)
    else:
        s = (t if w > h else l).sum(1, dtype=I32)
    dc = ((s + (offset >> 1)) >> shift)[:, None, None]
    vert = t[:, None, :]
    horz = l[:, :, None]
    sel3 = sel[:, None, None]
    out = torch.where(sel3 == 0, planar,
                      torch.where(sel3 == 1, dc,
                                  torch.where(sel3 == 2, vert, horz)))
    # PDPC for planar/DC/V/H (golden _pdpc_hv)
    scale = (logw + logh - 2) >> 2
    wl_row = 32 >> ((xsr << 1) >> scale).clamp(max=31)
    wt_col = 32 >> ((ysr << 1) >> scale).clamp(max=31)
    la = l[:, :, None]
    ta = t[:, None, :]
    is_pd = sel3 <= 1
    lm1 = L[:, PAD - 1, None, None]
    tm1 = T[:, PAD - 1, None, None]
    lref = torch.where(is_pd, la, la - lm1 + out)
    tref = torch.where(is_pd, ta, ta - tm1 + out)
    wl = torch.where(is_pd | (sel3 == 2), wl_row[None, None, :], 0)
    wt = torch.where(is_pd | (sel3 == 3), wt_col[None, :, None], 0)
    pd = out + ((wl * (lref - out) + wt * (tref - out) + 32) >> 6)
    pd = torch.clamp(pd, 0, mx)
    out = torch.where(pdpc[:, None, None] != 0, pd, out)
    return _finish(pix, res, out, xs, ys, w, h, W, mx)


def _angular_impl(pix, res, Lidx, Tidx, fmL, fmT, projL, projT, xs, ys,
                  angle, inv_angle, ref_idx, ff, pdpc, nscale,
                  w: int, h: int, W: int, bd: int, is_h: bool,
                  is_luma: bool):
    """Angular prediction (4-tap luma / 2-tap chroma) + angular PDPC."""
    dev = pix.device
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    B = Lidx.shape[0]
    L0, T0 = _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT)
    cat = torch.cat([L0, T0], 1)                  # [B, 2*NREF]
    L = torch.gather(cat, 1, projL.long())
    T = torch.gather(cat, 1, projT.long())
    mainr = L if is_h else T
    sider = T if is_h else L
    n_main = h if is_h else w
    n_cross = w if is_h else h
    js = _arange(n_cross, dev, 1)
    pos = (js[None, :] + ref_idx[:, None]) * angle[:, None]
    idx = (pos >> 5) + ref_idx[:, None]
    fact = pos & 31
    base = idx - (1 + ref_idx[:, None])
    pn = (PAD + base[:, :, None] + _arange(n_main, dev)[None, None, :]
          ).reshape(B, -1).long()               # [B, nc*nm] >= 0

    def R(d):
        return torch.gather(mainr, 1, pn + d).reshape(B, n_cross, n_main)

    if is_luma:
        banks = _const("filters", dev)            # [2, 32, 4]
        f = banks[ff[:, None], fact]              # [B, nc, 4]
        v = (R(0) * f[..., 0, None] + R(1) * f[..., 1, None] +
             R(2) * f[..., 2, None] + R(3) * f[..., 3, None] + 32) >> 6
        v = torch.clamp(v, 0, mx)
        copy = (ff[:, None, None] == 0) & (fact[:, :, None] == 0)
        v = torch.where(copy, R(1), v)
    else:
        v = ((32 - fact)[:, :, None] * R(1) +
             fact[:, :, None] * R(2) + 16) >> 5
    out = v.transpose(1, 2) if is_h else v        # [B, h, w]

    # angular PDPC (golden _pred_angular_v/_pred_angular_h).  sscale >> 9
    # runs far past the reference array where inv_angle is large; those
    # lanes lie beyond wp or in units without PDPC and are thrown away, so
    # the side gather clamps them (the JAX gather fills them)
    wp_max = w if not is_h else h
    ks = _arange(wp_max, dev)
    sscale = 256 + inv_angle[:, None] * (ks[None, :] + 1)
    wgt = 32 >> ((ks << 1)[None, :] >> nscale[:, None]).clamp(max=31)
    wp = (3 << nscale).clamp(max=wp_max)
    if not is_h:
        sidx = PAD + _arange(h, dev)[None, :, None] + \
            (sscale >> 9)[:, None, :]             # [B, h, wp_max]
        dmask = ks[None, None, :] < wp[:, None, None]
        wgt = wgt[:, None, :]
    else:
        sidx = PAD + _arange(w, dev)[None, None, :] + \
            (sscale >> 9)[:, :, None]             # [B, hp_max, w]
        dmask = ks[None, :, None] < wp[:, None, None]
        wgt = wgt[:, :, None]
    SV = torch.gather(sider, 1, sidx.clamp(0, NREF - 1).reshape(B, -1).long()
                      ).reshape(sidx.shape)
    padd = torch.clamp(out + (((SV - out) * wgt + 32) >> 6), 0, mx)
    pd = torch.where(dmask, padd, out)
    out = torch.where(pdpc[:, None, None] != 0, pd, out)
    return _finish(pix, res, out, xs, ys, w, h, W, mx)


def _mip_impl(pix, res, Lidx, Tidx, fmL, fmT, xs, ys, mode_id, transposed,
              w: int, h: int, W: int, bd: int, size_id: int):
    """Matrix intra prediction: batched matrix product + linear
    upsampling.  The product is an int32 multiply and sum: differences of
    samples (below 2^13) times 7-bit weights, at most 8 terms."""
    dev = pix.device
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    L, T = _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT)
    top = T[:, PAD:PAD + w]
    left = L[:, PAD:PAD + h]
    bs = (2, 4, 4)[size_id]
    ps = (4, 4, 8)[size_id]
    in_size = 2 * bs - (1 if size_id == 2 else 0)

    def dwn(ref, n):
        bd_n = n // bs
        if bd_n == 1:
            return ref
        lg = bd_n.bit_length() - 1
        return (ref.reshape(ref.shape[0], bs, bd_n).sum(-1, dtype=I32) +
                (1 << (lg - 1))) >> lg

    rt, rl = dwn(top, w), dwn(left, h)
    reduced = torch.where(transposed[:, None] != 0,
                          torch.cat([rl, rt], 1),
                          torch.cat([rt, rl], 1))    # [B, 2*bs]
    temp0 = reduced[:, 0]
    if size_id != 2:
        off = 0
        ow0 = mid - temp0
    else:
        off = 1
        ow0 = reduced[:, 1] - temp0
    red = torch.cat(
        [ow0[:, None],
         reduced[:, 1 + off:in_size + off] - temp0[:, None]], 1)
    ow = 32 - 32 * red.sum(1, dtype=I32)
    mat = _const(f"mip{size_id}", dev)[mode_id]   # [B, ps*ps, in]
    pred = (red[:, None, :] * mat).sum(-1, dtype=I32) + ow[:, None]
    pred = (pred >> 6) + temp0[:, None]
    pred = torch.clamp(pred, 0, mx).reshape(-1, ps, ps)
    grid = torch.where(transposed[:, None, None] != 0,
                       pred.transpose(1, 2), pred)     # anchors [B,ps,ps]
    up_h, up_v = w // ps, h // ps
    lg_h, lg_v = up_h.bit_length() - 1, up_v.bit_length() - 1
    # horizontal pass at anchor rows (before = left ref at those rows)
    if up_h > 1:
        lref = left[:, up_v - 1::up_v]                   # [B, ps]
        ah = torch.cat([lref[:, :, None], grid], 2)      # [B, ps, ps+1]
        k = _arange(up_h, dev, 1)
        interp = ((up_h - k)[None, None, None, :] * ah[:, :, :-1, None] +
                  k[None, None, None, :] * ah[:, :, 1:, None] +
                  (up_h >> 1)) >> lg_h
        rows = interp.reshape(-1, ps, w)                 # [B, ps, w]
    else:
        rows = grid
    if up_v > 1:
        av = torch.cat([top[:, None, :], rows], 1)       # [B, ps+1, w]
        k = _arange(up_v, dev, 1)
        interp = ((up_v - k)[None, None, :, None] * av[:, :-1, None, :] +
                  k[None, None, :, None] * av[:, 1:, None, :] +
                  (up_v >> 1)) >> lg_v
        out = interp.reshape(-1, h, w)
    else:
        out = rows
    return _finish(pix, res, out, xs, ys, w, h, W, mx)


def _bitlen(v):
    """The bit length of each of v (> 0, below 2^20)."""
    return (v[:, None] >= _const("pow2", v.device)[None, :]).sum(1, dtype=I32)


def _cclm_impl(luma, chroma, resc, selY_idx, selY_w, selY_add, selY_sh,
               selC_idx, noneigh, xm1, xc, r0, rt, xs, ys,
               w: int, h: int, Wl: int, Wc: int, bd: int, variant: int):
    """CCLM: on-device linear-model derivation + collocated-luma
    downsample + prediction for both chroma components, written into the
    stacked chroma planes in place; returns them.

    variant: 0 = 4:2:0 non-collocated, 1 = 4:2:0 collocated, 2 = 4:2:2,
    3 = 4:4:4 (direct window)."""
    dev = luma.device
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    nl = luma.shape[0]
    nc = chroma.shape[0]
    # selected neighbour luma (tap plans)
    lv = luma[selY_idx.clamp(0, nl - 1)]                 # [B, 4, 6]
    vy = ((lv * selY_w).sum(-1, dtype=I32) + selY_add) >> \
        selY_sh.clamp(min=0)
    cv = torch.where(selC_idx >= 0,
                     chroma[selC_idx.clamp(0, nc - 1)], mid)  # [B, 2, 4]
    # two-min/two-max grouping sort network on indices (cclm_get_min_max)
    i0 = torch.zeros(vy.shape[0], dtype=torch.int64, device=dev)
    i1 = i0 + 1
    i2 = i0 + 2
    i3 = i0 + 3

    def g(ix):
        return torch.gather(vy, 1, ix[:, None])[:, 0]

    mn0, mn1 = i0, i2
    c = g(mn0) > g(mn1)
    mn0, mn1 = torch.where(c, mn1, mn0), torch.where(c, mn0, mn1)
    mx0, mx1 = i1, i3
    c = g(mx0) > g(mx1)
    mx0, mx1 = torch.where(c, mx1, mx0), torch.where(c, mx0, mx1)
    c = g(mn0) > g(mx1)
    mn0, mx0, mn1, mx1 = (torch.where(c, mx0, mn0), torch.where(c, mn0, mx0),
                          torch.where(c, mx1, mn1), torch.where(c, mn1, mx1))
    c = g(mn1) > g(mx0)
    mn1, mx0 = torch.where(c, mx0, mn1), torch.where(c, mn1, mx0)
    min_y = (g(mn0) + g(mn1) + 1) >> 1
    max_y = (g(mx0) + g(mx1) + 1) >> 1
    diff = max_y - min_y

    def gc(ix):
        return torch.gather(cv, 2, ix[:, None, None].expand(-1, 2, 1))[:, :, 0]

    min_c = (gc(mn0) + gc(mn1) + 1) >> 1                 # [B, 2]
    max_c = (gc(mx0) + gc(mx1) + 1) >> 1
    diffc = max_c - min_c
    xsh = _bitlen(diff.clamp(min=1)) - 1
    norm = ((diff << 4) >> xsh) & 15
    xsh = xsh + (norm != 0).to(I32)
    ysh = (diffc.abs()[:, None, :] >=
           _const("pow2", dev)[None, :, None]).sum(1, dtype=I32)  # [B, 2]
    vsig = _const("div_sig", dev)[norm] | 8
    add = (1 << ysh) >> 1
    a = (diffc * vsig[:, None] + add) >> ysh
    kk = 3 + xsh[:, None] - ysh
    a = torch.where(kk < 1, torch.sign(a) * 15, a)
    kk = kk.clamp(min=1)
    b = min_c - ((a * min_y[:, None]) >> kk)
    flat = (diff == 0)[:, None]
    a = torch.where(flat, 0, a)
    b = torch.where(flat, min_c, b)
    kk = torch.where(flat, 0, kk)
    none = noneigh[:, None] != 0
    a = torch.where(none, 0, a)
    b = torch.where(none, mid, b)
    kk = torch.where(none, 0, kk)

    # collocated luma downsample
    def lum(rr, cc):
        return luma[(rr * Wl + cc).clamp(0, nl - 1)]

    R0 = r0[:, :, None]
    RT = rt[:, :, None]
    XM = xm1[:, None, :]
    XC = xc[:, None, :]
    if variant == 3:
        dsy = lum(R0, XC)
    elif variant == 2:
        dsy = (lum(R0, XM) + 2 * lum(R0, XC) + lum(R0, XC + 1) + 2) >> 2
    elif variant == 1:
        dsy = (lum(R0, XM) + lum(RT, XC) + 4 * lum(R0, XC) +
               lum(R0, XC + 1) + lum(R0 + 1, XC) + 4) >> 3
    else:
        dsy = (lum(R0, XM) + lum(R0 + 1, XM) + 2 * lum(R0, XC) +
               2 * lum(R0 + 1, XC) + lum(R0, XC + 1) +
               lum(R0 + 1, XC + 1) + 4) >> 3              # [B, h, w]
    # int64 as recon.py's cclm_pred
    pred = ((dsy.long()[:, None] * a.long()[:, :, None, None])
            >> kk.long()[:, :, None, None]) + b[:, :, None, None]
    pred = torch.clamp(pred, 0, mx).to(I32)              # [B, 2, h, w]
    # residual add + scatter (both chroma components)
    HcWc = nc // 2
    off = _arange(h, dev)[:, None] * Wc + _arange(w, dev)[None, :]
    for ci in range(2):
        base = ci * HcWc + ys * Wc + xs
        idx = base[:, None, None] + off
        v = torch.clamp(pred[:, ci] + resc[idx], 0, mx)
        chroma[idx.reshape(-1)] = v.reshape(-1)
    return chroma


# ---- bucket entry points (the JAX package's jitted functions) ---------------
# Each writes its bucket into the flat plane `pix` in place and returns it.
# `edges` is _edge_idx of the bucket's geo rows: frame_device_intra builds
# it for every unit of a frame at once (per bucket it would be 121 small
# operations, over a third of a bucket's), where the JAX functions build
# it inside each call.

def k_simple_g(pix, res, geo, edges, w, h, W, bd):
    Lidx, Tidx, fmL, fmT = edges
    return _simple_impl(pix, res, Lidx, Tidx, fmL, fmT,
                        geo[:, G_X], geo[:, G_YF], geo[:, G_A0],
                        geo[:, G_PDPC], w, h, W, bd)


def k_angular_g(pix, res, geo, edges, w, h, W, bd, is_h, is_luma):
    Lidx, Tidx, fmL, fmT = edges
    projL, projT = _proj_idx(geo, w, h, not is_h)
    return _angular_impl(pix, res, Lidx, Tidx, fmL, fmT, projL, projT,
                         geo[:, G_X], geo[:, G_YF], geo[:, G_ANGLE],
                         geo[:, G_INV], geo[:, G_REF], geo[:, G_FF],
                         geo[:, G_PDPC], geo[:, G_NSCALE],
                         w, h, W, bd, is_h, is_luma)


def k_mip_g(pix, res, geo, edges, w, h, W, bd, size_id):
    Lidx, Tidx, fmL, fmT = edges
    return _mip_impl(pix, res, Lidx, Tidx, fmL, fmT,
                     geo[:, G_X], geo[:, G_YF], geo[:, G_A0],
                     geo[:, G_A1], w, h, W, bd, size_id)


def k_cclm_p(luma, chroma, resc, blob, w, h, Wl, Wc, bd, variant):
    """Packed CCLM launch: ONE int32 blob [B, 67 + 2w + 2h] holding
    selY_idx(24) selY_w(24) selY_add(4) selY_sh(4) selC_idx(8)
    noneigh xs ys | xm1(w) xc(w) | r0(h) rt(h)."""
    blob = blob.to(I32)
    B = blob.shape[0]
    return _cclm_impl(
        luma, chroma, resc,
        blob[:, 0:24].reshape(B, 4, 6), blob[:, 24:48].reshape(B, 4, 6),
        blob[:, 48:52], blob[:, 52:56], blob[:, 56:64].reshape(B, 2, 4),
        blob[:, 64], blob[:, 67:67 + w], blob[:, 67 + w:67 + 2 * w],
        blob[:, 67 + 2 * w:67 + 2 * w + h],
        blob[:, 67 + 2 * w + h:67 + 2 * w + 2 * h],
        blob[:, 65], blob[:, 66], w, h, Wl, Wc, bd, variant)


# ---- the host plan of a CCLM unit -------------------------------------------

def _cclm_plan_from_desc(sps, fb, x, y, w, h, avail_t, avail_l, ns_top,
                         ns_left, mode):
    """The golden model's CCLM neighbour selection and luma tap plans
    (recon.py:462-561) in index form, driven by the scalars the native
    planner emits (availability runs resolved in C)."""
    hs, vs = sps.hshift[1], sps.vshift[1]
    x0, y0 = x << hs, y << vs
    Hl, Wl = fb.planes[0].shape
    Hc, Wc = fb.planes[1].shape
    plan = {"noneigh": 0}
    mid = 1 << (sps.bit_depth - 1)
    if not hs and not vs:
        xm1 = x0 + np.arange(w)
        xc = x0 + np.arange(w)
        r0 = y0 + np.arange(h)
        rt = r0
    else:
        xm1 = x0 + 2 * np.arange(w) - 1
        xm1[0] = x0 - avail_l
        xc = x0 + 2 * np.arange(w)
        if not vs:
            r0 = y0 + np.arange(h)
            rt = r0
        else:
            r0 = y0 + 2 * np.arange(h)
            rt = r0 - 1
            rt[0] = y0 - avail_t
    plan["xm1"] = np.clip(xm1, 0, Wl - 1)
    plan["xc"] = np.clip(xc, 0, Wl - 1 if (not hs and not vs)
                         else max(Wl - 2, 0))
    plan["r0"] = np.clip(r0, 0, Hl - 1 if not vs else max(Hl - 2, 0))
    plan["rt"] = np.clip(rt, 0, Hl - 1)

    if not ns_top and not ns_left:
        plan["noneigh"] = 1
        plan["selY_idx"] = np.zeros((4, 6), np.int64)
        plan["selY_w"] = np.zeros((4, 6), np.int64)
        plan["selY_add"] = np.zeros(4, np.int64)
        plan["selY_sh"] = np.zeros(4, np.int64)
        plan["selC_idx"] = np.full((2, 4), -1, np.int64)
        plan["mid"] = mid
        return plan
    num_is4 = int(not avail_t or not avail_l or mode != INTRA_LT_CCLM)
    cnt, pos = [0, 0], [[], []]
    for side, ns in enumerate((ns_top, ns_left)):
        start = ns >> (2 + num_is4)
        step = max(1, ns >> (1 + num_is4))
        cnt[side] = min(ns, (1 + num_is4) << 1)
        pos[side] = [start + c * step for c in range(cnt[side])]

    taps = []
    coll = sps.r.sps_chroma_vertical_collocated_flag
    b_ctu_boundary = not (y0 & ((1 << sps.ctb_log2_size_y) - 1))

    def lflat(yy, xx):
        return yy * Wl + xx

    if not hs and not vs:
        for p in pos[0]:
            taps.append(([lflat(y0 - avail_t, x0 + p)] + [0] * 5,
                         [1, 0, 0, 0, 0, 0], 0, 0))
        for p in pos[1]:
            taps.append(([lflat(y0 + p, x0 - avail_l)] + [0] * 5,
                         [1, 0, 0, 0, 0, 0], 0, 0))
    else:
        for p in pos[0]:        # top row(s)
            xx = p << hs
            xl = x0 + xx - 1 if (xx or avail_l) else x0 + xx
            if vs and not b_ctu_boundary:
                yb = y0 - 2
                if coll:
                    taps.append((
                        [lflat(yb - 1, x0 + xx), lflat(yb, xl),
                         lflat(yb, x0 + xx), lflat(yb, x0 + xx + 1),
                         lflat(yb + 1, x0 + xx), 0],
                        [1, 1, 4, 1, 1, 0], 4, 3))
                else:
                    taps.append((
                        [lflat(yb, xl), lflat(yb + 1, xl),
                         lflat(yb, x0 + xx), lflat(yb + 1, x0 + xx),
                         lflat(yb, x0 + xx + 1),
                         lflat(yb + 1, x0 + xx + 1)],
                        [1, 1, 2, 2, 1, 1], 4, 3))
            else:
                yb = y0 - 1
                taps.append((
                    [lflat(yb, xl), lflat(yb, x0 + xx),
                     lflat(yb, x0 + xx + 1), 0, 0, 0],
                    [1, 2, 1, 0, 0, 0], 2, 2))
        x_src = x0 - (1 + hs) * avail_l
        x_l = x_src - avail_l
        for p in pos[1]:        # left column
            yy = y0 + (p << vs)
            if not vs:
                taps.append((
                    [lflat(yy, x_l), lflat(yy, x_src),
                     lflat(yy, x_src + 1), 0, 0, 0],
                    [1, 2, 1, 0, 0, 0], 2, 2))
            elif coll:
                ty = yy - 1 if ((p << vs) or avail_t) else yy
                taps.append((
                    [lflat(yy, x_l), lflat(ty, x_src),
                     lflat(yy, x_src), lflat(yy, x_src + 1),
                     lflat(yy + 1, x_src), 0],
                    [1, 1, 4, 1, 1, 0], 4, 3))
            else:
                taps.append((
                    [lflat(yy, x_l), lflat(yy + 1, x_l),
                     lflat(yy, x_src), lflat(yy + 1, x_src),
                     lflat(yy, x_src + 1), lflat(yy + 1, x_src + 1)],
                    [1, 1, 2, 2, 1, 1], 4, 3))

    selc = [[], []]
    for p in pos[0]:
        for ci in range(2):
            selc[ci].append(ci * Hc * Wc + (y - 1) * Wc + (x + p))
    for p in pos[1]:
        for ci in range(2):
            selc[ci].append(ci * Hc * Wc + (y + p) * Wc + (x - 1))
    if cnt[0] + cnt[1] == 2:
        taps = [taps[1], taps[0], taps[1], taps[0]]
        selc = [[s[1], s[0], s[1], s[0]] for s in selc]
    plan["selY_idx"] = np.array([t[0] for t in taps], np.int64)
    plan["selY_w"] = np.array([t[1] for t in taps], np.int64)
    plan["selY_add"] = np.array([t[2] for t in taps], np.int64)
    plan["selY_sh"] = np.array([t[3] for t in taps], np.int64)
    plan["selC_idx"] = np.array(selc, np.int64)
    plan["mid"] = mid
    return plan


def _cclm_row(sps, fb, d, w, h):
    """The blob row of one CCLM descriptor (layout: k_cclm_p)."""
    pl = _cclm_plan_from_desc(
        sps, fb, int(d[PL_X]), int(d[PL_Y]), w, h, int(d[PL_TA]),
        int(d[PL_LA]), int(d[PL_AUX0]), int(d[PL_AUX1]), int(d[PL_MODE]))
    return np.concatenate([
        pl["selY_idx"].reshape(-1), pl["selY_w"].reshape(-1),
        pl["selY_add"], pl["selY_sh"], pl["selC_idx"].reshape(-1),
        np.array([pl["noneigh"], d[PL_X], d[PL_Y]], np.int64),
        pl["xm1"], pl["xc"], pl["r0"], pl["rt"]]).astype(np.int32)


def _mip_size_id(w, h):
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


# ---- the frame function -----------------------------------------------------

def _plan_walk(jobs, pps, fb):
    """The native plan walk of every job into one descriptor array; None
    when the planner refuses a CU.  Grows its buffer when it is full."""
    cap = max(8192, (pps.width // 2) * (pps.height // 2) // 8)
    while True:
        # the wave maps of the walk: luma, and chroma where there is one
        wl = np.zeros(fb.planes[0].shape, np.int32)
        wc = np.zeros(fb.planes[1].shape, np.int32) \
            if len(fb.planes) > 1 else None
        buf = np.empty((cap, 26), np.int32)
        off = 0
        try:
            for _rec, nr, ctus in jobs:
                off += nr.plan_ctus(ctus, buf[off:], wl, wc)
        except ValueError as e:
            if "err=5" not in str(e):    # unsupported CU
                return None
            cap *= 4                     # descriptor buffer full
            continue
        return buf[:off]


def _geo_rows(Ds, isc, Hc, Wc):
    """The sorted descriptors as geo rows [N, 21] (G_* columns)."""
    geo = np.zeros((Ds.shape[0], 21), np.int32)
    for g_col, pl_col in ((G_X, PL_X), (G_Y, PL_Y), (G_LA, PL_LA),
                          (G_TA, PL_TA), (G_CUL, PL_CUL),
                          (G_REF, PL_REF_IDX), (G_UNFL, PL_UNF_LEFT),
                          (G_UNFT, PL_UNF_TOP), (G_REFW, PL_REFW),
                          (G_REFH, PL_REFH), (G_LSIZE, PL_LEFT_SIZE),
                          (G_RFFFSM, PL_RFFFSM), (G_ANGLE, PL_ANGLE),
                          (G_INV, PL_INV_ANGLE), (G_FF, PL_FF),
                          (G_PDPC, PL_PDPC), (G_NSCALE, PL_NSCALE)):
        geo[:, g_col] = Ds[:, pl_col]
    # chroma planes are stacked [2, Hc, Wc]: the plane offset goes into
    # the row (G_YF) and the flat base (G_BASE)
    geo[:, G_YF] = Ds[:, PL_Y] + np.where(isc > 0,
                                          (Ds[:, PL_C_IDX] - 1) * Hc, 0)
    geo[:, G_BASE] = np.where(isc > 0, (Ds[:, PL_C_IDX] - 1) * (Hc * Wc), 0)
    kind = Ds[:, PL_KIND]
    m = kind == K_SIMPLE
    sel_lut = np.zeros(67, np.int32)
    sel_lut[[INTRA_PLANAR, INTRA_DC, INTRA_VERT, INTRA_HORZ]] = [0, 1, 2, 3]
    geo[m, G_A0] = sel_lut[Ds[m, PL_MODE]]
    m = kind == K_MIP
    geo[m, G_A0] = Ds[m, PL_AUX0]
    geo[m, G_A1] = Ds[m, PL_AUX1]
    return geo


@trace.traced("intra")
def frame_device_intra(recon_jobs, sps, pps, tabs, fb, device="cuda"):
    """Intra reconstruction of an all-intra frame on `device`.

    Returns True when the frame was reconstructed (fb.planes updated),
    False when the native planner declines it (the caller reconstructs
    with the native C walk; no record state was touched).  Once the
    residual walk has run there is no way back: a fault raises."""
    dev = resolve_device(device)
    jobs = []
    for rec, ctus in recon_jobs:
        nr = rec.native_recon
        if nr is None:
            stats["declined"] += 1
            return False
        jobs.append((rec, nr, ctus))
    H, W = fb.planes[0].shape
    chroma_on = bool(sps.chroma_format_idc)
    Hc, Wc = fb.planes[1].shape if chroma_on else (0, 0)

    # --- 1. native plan walk (consumes no record state) -----------------
    t0 = time.perf_counter()
    Dsc = _plan_walk(jobs, pps, fb)
    t_walk = time.perf_counter() - t0
    stats["walk_s"] += t_walk
    if Dsc is None or not len(Dsc):
        stats["declined"] += 1
        return False

    # --- 2. buckets: contiguous runs of equal (wave, kind, w, h,
    # is-chroma) after ONE sort; wave is the most significant key, so the
    # launch order respects the dependencies --------------------------------
    t1 = time.perf_counter()
    bd = sps.bit_depth
    coll = int(sps.r.sps_chroma_vertical_collocated_flag)
    hs, vs = (sps.hshift[1], sps.vshift[1]) if chroma_on else (1, 1)
    variant = 3 if (not hs and not vs) else (2 if not vs else
                                             (1 if coll else 0))
    isc0 = (Dsc[:, PL_C_IDX] > 0).astype(np.int32)
    order = np.lexsort((isc0, Dsc[:, PL_H], Dsc[:, PL_W], Dsc[:, PL_KIND],
                        Dsc[:, PL_WAVE]))
    Ds = Dsc[order]
    isc = isc0[order]
    N = Ds.shape[0]
    keys = np.stack([Ds[:, PL_WAVE], Ds[:, PL_KIND], Ds[:, PL_W],
                     Ds[:, PL_H], isc], axis=1)
    bnd = np.flatnonzero(np.any(keys[1:] != keys[:-1], axis=1)) + 1
    starts = np.concatenate([[0], bnd]).tolist()
    ends = np.concatenate([bnd, [N]]).tolist()
    geo_all = _geo_rows(Ds, isc, Hc, Wc)
    launches = []     # (kind, s0, s1, w, h, is_luma), wave-ordered
    blobs = []        # CCLM blob rows in launch order, uploaded as one
    t_cclm = 0.0
    for s0, s1 in zip(starts, ends):
        kind, w, h = (int(v) for v in Ds[s0, [PL_KIND, PL_W, PL_H]])
        if kind == K_CCLM:
            tc = time.perf_counter()
            blobs += [_cclm_row(sps, fb, Ds[j], w, h) for j in range(s0, s1)]
            t_cclm += time.perf_counter() - tc
        launches.append((kind, s0, s1, w, h, not isc[s0]))
    t_build = time.perf_counter() - t1
    stats["cclm_s"] += t_cclm
    stats["build_s"] += t_build - t_cclm
    stats["last_plan_s"] = t_walk + t_build

    # --- 3. residuals via the native record walk (consumes coefficient
    # state: no way back past here) --------------------------------------
    t2 = time.perf_counter()
    res_planes = [np.zeros_like(p) for p in fb.planes]
    for _rec, nr, ctus in jobs:
        nr.residual_ctus(ctus, res_planes)
    stats["residual_s"] += time.perf_counter() - t2

    # --- 4. device: every upload once, then every bucket in order --------
    t3 = time.perf_counter()

    luma = upload(fb.planes[0].reshape(-1), dev, stats)
    resl = upload(res_planes[0].reshape(-1), dev, stats)
    chroma = resc = None
    if chroma_on:
        chroma = upload(np.stack([fb.planes[1], fb.planes[2]]).reshape(-1),
                        dev, stats)
        resc = upload(np.stack([res_planes[1], res_planes[2]]).reshape(-1),
                      dev, stats)
    geo_d = upload(geo_all, dev, stats)
    # the gather plans of every unit at once, each row with its plane's
    # width
    edges_d = _edge_idx(geo_d, upload(np.where(isc[:, None] > 0, Wc, W)
                                      .astype(np.int32), dev, stats))
    blob_d = upload(np.concatenate(blobs), dev, stats) if blobs else None
    n_cclm = flat = 0
    for kind, s0, s1, w, h, is_luma in launches:
        if kind == K_CCLM:
            size = (s1 - s0) * (67 + 2 * w + 2 * h)
            blob = blob_d[flat:flat + size].reshape(s1 - s0, -1)
            flat += size
            n_cclm += s1 - s0
            k_cclm_p(luma, chroma, resc, blob, w, h, W, Wc, bd, variant)
            stats["cclm_buckets"] += 1
            continue
        pix, res, Wp = (luma, resl, W) if is_luma else (chroma, resc, Wc)
        geo = geo_d[s0:s1]
        edges = tuple(e[s0:s1] for e in edges_d)
        if kind == K_SIMPLE:
            k_simple_g(pix, res, geo, edges, w, h, Wp, bd)
            stats["simple_buckets"] += 1
        elif kind == K_MIP:
            k_mip_g(pix, res, geo, edges, w, h, Wp, bd, _mip_size_id(w, h))
            stats["mip_buckets"] += 1
        else:
            k_angular_g(pix, res, geo, edges, w, h, Wp, bd, kind == K_ANG_H,
                        is_luma)
            stats["angular_buckets"] += 1
    t4 = time.perf_counter()
    stats["queue_s"] += t4 - t3

    fb.planes[0][:] = download(luma, stats).reshape(H, W)
    if chroma_on:
        cc = download(chroma, stats).reshape(2, Hc, Wc)
        fb.planes[1][:] = cc[0]
        fb.planes[2][:] = cc[1]
    stats["download_s"] += time.perf_counter() - t4
    stats["frames"] += 1
    stats["units"] += N
    stats["waves"] += len(np.unique(Ds[:, PL_WAVE]))
    stats["cclm_units"] += n_cclm
    return True
