"""ALF and CC-ALF of the fused chain: CUDA kernel wrappers and plain versions.

`alf_filter_luma` and `alf_filter_chroma` replace
`ffvvc_tpu/ops/alf_device.py::_alf_pallas` in its fused form
(`ffvvc_tpu/ops/fused_device.py::_alf_filter_plane`): the clipped 7x7 (luma)
or 5x5 (chroma) diamond with virtual-boundary row substitution.  `cc_filter`
replaces `_cc_pallas` in its fused form (`fused_device._cc_filter`): the
7-tap luma-to-chroma correction.

All take and return 16-bit samples, read the unpadded plane (coordinates
clamp at the picture edge) and take their coefficients by index: luma ALF
the per-4x4 class and transpose indices, the per-CTB filter set and the
[sets, 25, 12] tables; chroma ALF the per-CTB set and [sets, 12] tables, both
chroma planes in one call; CC-ALF per-CTB coefficients.  The ALF tap rows at
a virtual boundary are computed from the row number (`vb_reach`).  On CUDA
tensors each wrapper launches its kernel in csrc/filters.cu; on CPU tensors
it runs its `*_ref` version, the same integer math in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..alf import (ALF_BORDER_LUMA, ALF_VB_POS_ABOVE_CHROMA,
                   ALF_VB_POS_ABOVE_LUMA, _TRANSPOSE_IDX)

from . import _build
from .sao_device import MIN_CTB, _log2, expand_ctb, pad_edge, stream_of

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


def _vb_row_offsets(h, vb_pos, is_luma):
    """VB-resolved row-plane offsets o[k][y] for k = 0..6 (alf.py
    _filter_luma/_filter_chroma row-substitution), vectorized over y.
    The outer gating ranges differ: luma [vb-4, vb) / [vb, vb+3], chroma
    [vb-2, vb) / [vb, vb+1]; the inner substitutions are identical."""
    ys = np.arange(h)
    o = np.broadcast_to(np.array([0, 1, -1, 2, -2, 3, -3])[:, None],
                        (7, h)).copy()
    below_lo = vb_pos - (4 if is_luma else 2)
    above_hi = vb_pos + (3 if is_luma else 1)
    bel = (ys >= below_lo) & (ys < vb_pos)
    abv = (ys >= vb_pos) & (ys <= above_hi)
    m = bel & (ys == vb_pos - 1)
    o[1][m] = 0
    o[2][m] = 0
    m = bel & (ys >= vb_pos - 2)
    o[3][m] = o[1][m]
    o[4][m] = o[2][m]
    m = bel & (ys >= vb_pos - 3)
    o[5][m] = o[3][m]
    o[6][m] = o[4][m]
    m = abv & (ys == vb_pos)
    o[2][m] = 0
    o[1][m] = 0
    m = abv & (ys <= vb_pos + 1)
    o[4][m] = o[2][m]
    o[3][m] = o[1][m]
    m = abv & (ys <= vb_pos + 2)
    o[6][m] = o[4][m]
    o[5][m] = o[3][m]
    return o


def vb_reach(ys, cs_v, vb_pos):
    """How far a tap row may lie from row y at the virtual boundary of its
    CTB row: every offset of `_vb_row_offsets` is its nominal one clamped
    to +-reach (a substituted row is always a nearer one).  With
    d = (y mod cs_v) - vb_pos: 0 for d in {-1, 0} (the rows that round
    with >>10), 1 for {-2, 1}, 2 for {-3, 2}, else 3.  ys: int tensor of
    picture rows."""
    d = (ys & (cs_v - 1)) - vb_pos
    reach = torch.full_like(d, 3)
    reach[(d == -3) | (d == 2)] = 2
    reach[(d == -2) | (d == 1)] = 1
    reach[(d == -1) | (d == 0)] = 0
    return reach


# ---- ALF --------------------------------------------------------------------

def alf_filter_plane_ref(src, cf_blk, cl_blk, blk_h, blk_w, slots, cs_v,
                         vb_pos, pix_max):
    """Plain PyTorch clipped-diamond ALF (`fused_device._alf_filter_plane`)
    of one plane.  src: int16 [H, W]; cf_blk/cl_blk: int32 [nby, nbx, 12]
    per block of blk_h x blk_w samples; slots: the tap slots in use;
    cs_v: CTB height in the plane's rows; vb_pos: the virtual boundary's
    row within a CTB row."""
    H, W = src.shape
    cur = src.to(torch.int32)
    ys = torch.arange(H, device=src.device)
    xs = torch.arange(W, device=src.device)
    reach = vb_reach(ys, cs_v, vb_pos)
    rows = {}           # row planes of the taps in use

    def at(k, dx):
        if k not in rows:
            o = _ROW_OFFSET[k]
            o = torch.clamp(torch.full_like(reach, o), -reach, reach)
            rows[k] = cur.index_select(0, torch.clamp(ys + o, 0, H - 1))
        return rows[k].index_select(1, torch.clamp(xs + dx, 0, W - 1))

    def px(a):
        return expand_ctb(a, blk_h, blk_w, H, W)
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


def alf_filter_luma_ref(src, ci, ti, ctb_set, cf_tab, cl_tab, cs, pix_max):
    """Plain PyTorch luma ALF.  src: int16 [H, W]; ci/ti: int32
    [H / 4, W / 4] class and transpose index of each 4x4 block
    (`fused_device.alf_classify`); ctb_set: int32 [ch, cw] filter set of
    each CTB of cs x cs samples; cf_tab/cl_tab: int32 [sets, 25, 12]."""
    nby, nbx = ci.shape
    setidx = expand_ctb(ctb_set, cs // 4, cs // 4, nby, nbx).long()
    perm = torch.tensor(_TRANSPOSE_IDX, device=src.device)[ti.long()]
    cfb = torch.gather(cf_tab[setidx, ci.long()], 2, perm)
    clb = torch.gather(cl_tab[setidx, ci.long()], 2, perm)
    return alf_filter_plane_ref(src, cfb, clb, 4, 4, range(12), cs,
                                cs - ALF_VB_POS_ABOVE_LUMA, pix_max)


def alf_filter_chroma_ref(srcs, ctb_sets, cf_tabs, cl_tabs, cs_v, cs_h,
                          pix_max):
    """Plain PyTorch chroma ALF of one or two planes of equal shape.  Per
    plane: src int16 [H, W], ctb_set int32 [ch, cw] and the tables
    cf_tab/cl_tab int32 [sets, 12] (the slots chroma does not use hold
    cf 0); CTBs of cs_v x cs_h samples."""
    return [alf_filter_plane_ref(
        x, cf[s.long()], cl[s.long()], cs_v, cs_h, _CHROMA_SLOT, cs_v,
        cs_v - ALF_VB_POS_ABOVE_CHROMA, pix_max)
        for x, s, cf, cl in zip(srcs, ctb_sets, cf_tabs, cl_tabs)]


def _check(name, ok, what):
    if not ok:
        raise ValueError(f"{name}: {what}")


def _check_cuda(name, i16, i32):
    """Device, type and layout of a kernel's tensors."""
    for t in (*i16, *i32):
        _check(name, t.device.type == "cuda",
               f"unsupported device {t.device}")
        _check(name, t.is_contiguous(), "tensors must be contiguous")
    _check(name, all(t.dtype == torch.int16 for t in i16) and
           all(t.dtype == torch.int32 for t in i32),
           "int16 planes and int32 parameters expected")
    _check(name, all(t.data_ptr() % 8 == 0 for t in i16),
           "planes must be 8-byte aligned")


def alf_filter_luma(src, ci, ti, ctb_set, cf_tab, cl_tab, cs, pix_max):
    """Luma ALF: the CUDA kernel on CUDA tensors, `alf_filter_luma_ref`
    (same arguments) on CPU tensors.  Returns a new int16 [H, W]."""
    if src.device.type == "cpu":
        return alf_filter_luma_ref(src, ci, ti, ctb_set, cf_tab, cl_tab, cs,
                                   pix_max)
    name = "alf_filter_luma"
    _check_cuda(name, (src,), (ci, ti, ctb_set, cf_tab, cl_tab))
    H, W = src.shape
    ch, cw = ctb_set.shape
    _check(name, H % 4 == 0 and W % 4 == 0 and
           ci.shape == ti.shape == (H // 4, W // 4) and
           ch * cs >= H and cw * cs >= W and cs >= 32 and
           cf_tab.shape == cl_tab.shape and cf_tab.shape[1:] == (25, 12),
           "inconsistent shapes")
    out = torch.empty_like(src)
    err = _build.lib().ffvvc_alf_luma(
        src.data_ptr(), out.data_ptr(), H, W, ci.data_ptr(), ti.data_ptr(),
        ctb_set.data_ptr(), cw, cf_tab.data_ptr(), cl_tab.data_ptr(),
        _log2(cs, "cs"), pix_max, stream_of(src))
    _build.check(err, "ffvvc_alf_luma")
    alf_filter_luma.launches += 1
    return out


alf_filter_luma.launches = 0


def alf_filter_chroma(srcs, ctb_sets, cf_tabs, cl_tabs, cs_v, cs_h, pix_max):
    """Chroma ALF of one or two planes in one launch of the CUDA kernel on
    CUDA tensors, `alf_filter_chroma_ref` (same arguments) on CPU tensors.
    Returns new int16 [H, W] tensors."""
    if srcs[0].device.type == "cpu":
        return alf_filter_chroma_ref(srcs, ctb_sets, cf_tabs, cl_tabs, cs_v,
                                     cs_h, pix_max)
    name = "alf_filter_chroma"
    n = len(srcs)
    _check(name, 1 <= n <= 2 and len(ctb_sets) == len(cf_tabs) ==
           len(cl_tabs) == n, "one or two planes, each with its parameters")
    _check_cuda(name, srcs, (*ctb_sets, *cf_tabs, *cl_tabs))
    H, W = srcs[0].shape
    ch, cw = ctb_sets[0].shape
    _check(name, W % 4 == 0 and ch * cs_v >= H and cw * cs_h >= W and
           min(cs_v, cs_h) >= MIN_CTB and
           all(x.shape == (H, W) for x in srcs) and
           all(s.shape == (ch, cw) for s in ctb_sets) and
           all(t.ndim == 2 and t.shape[1] == 12
               for t in (*cf_tabs, *cl_tabs)), "inconsistent shapes")
    outs = [torch.empty_like(x) for x in srcs]
    ptrs = [t.data_ptr() for z in range(n)
            for t in (srcs[z], outs[z], ctb_sets[z], cf_tabs[z], cl_tabs[z])]
    err = _build.lib().ffvvc_alf_chroma(
        n, (ctypes.c_void_p * len(ptrs))(*ptrs), H, W, cw,
        _log2(cs_v, "cs_v"), _log2(cs_h, "cs_h"), pix_max,
        stream_of(srcs[0]))
    _build.check(err, "ffvvc_alf_chroma")
    alf_filter_chroma.launches += 1
    return outs


alf_filter_chroma.launches = 0


# ---- CC-ALF -----------------------------------------------------------------

def cc_filter_ref(dst, luma, rowsel, skip, cf_ctb, cs_v, cs_h, hs, half,
                  pix_max):
    """Plain PyTorch CC-ALF (`fused_device._cc_filter`).  dst: int16
    [Hc, Wc] chroma; luma: int16 [H, W] pre-ALF luma; rowsel: int64
    [4, Hc] rows r0..r3 of the luma plane edge-padded by 3; skip: int32
    [Hc] (rows with no correction); cf_ctb: int32 [ch, cw, 7] per chroma
    CTB of cs_v x cs_h."""
    Hc, Wc = dst.shape
    b = ALF_BORDER_LUMA
    P3l = pad_edge(luma.to(torch.int32), b)
    dst = dst.to(torch.int32)
    r = [P3l.index_select(0, rowsel[j]) for j in range(4)]

    def at(j, dx):      # luma cols (x << hs) + dx
        return r[j][:, b + dx:b + dx + ((Wc - 1) << hs) + 1:1 << hs]
    cur = at(1, 0)
    acc = torch.zeros_like(dst)
    for j, (rk, dx) in enumerate(_CC_TAPS):
        cf = torch.where(skip[:, None] != 0, 0,
                         expand_ctb(cf_ctb[:, :, j], cs_v, cs_h, Hc, Wc))
        acc = acc + cf * (at(rk, dx) - cur)
    acc = torch.clamp((acc + 64) >> 7, -half, half - 1)
    return torch.clamp(dst + acc, 0, pix_max).to(torch.int16)


def cc_filter(dst, luma, rowsel, skip, cf_ctb, cs_v, cs_h, hs, half,
              pix_max):
    """CC-ALF of one chroma plane: the CUDA kernel on CUDA tensors,
    `cc_filter_ref` (same arguments) on CPU tensors.  Returns a new int16
    [Hc, Wc]."""
    if dst.device.type == "cpu":
        return cc_filter_ref(dst, luma, rowsel, skip, cf_ctb, cs_v, cs_h, hs,
                             half, pix_max)
    name = "cc_filter"
    _check_cuda(name, (dst, luma), (skip, cf_ctb))
    Hc, Wc = dst.shape
    H, W = luma.shape
    ch, cw = cf_ctb.shape[:2]
    _check(name, rowsel.is_cuda and rowsel.is_contiguous() and
           rowsel.dtype == torch.int64, "contiguous CUDA int64 rowsel "
           "expected")
    _check(name, rowsel.shape == (4, Hc) and skip.shape == (Hc,) and
           cf_ctb.shape[2] == 7 and ch * cs_v >= Hc and cw * cs_h >= Wc and
           W > (Wc - 1) << hs, "inconsistent shapes")
    out = torch.empty_like(dst)
    err = _build.lib().ffvvc_cc(
        dst.data_ptr(), luma.data_ptr(), H, W, rowsel.data_ptr(),
        skip.data_ptr(), cf_ctb.data_ptr(), cw, _log2(cs_v, "cs_v"),
        _log2(cs_h, "cs_h"), hs, half, pix_max, Hc, Wc, out.data_ptr(),
        stream_of(dst))
    _build.check(err, "ffvvc_cc")
    cc_filter.launches += 1
    return out


cc_filter.launches = 0
