"""ALF and CC-ALF of the fused chain: CUDA kernel wrappers and plain twins.

`alf_filter_plane` replaces `ffvvc_tpu/ops/alf_device.py::_alf_pallas` in
its fused form (`ffvvc_tpu/ops/fused_device.py::_alf_filter_plane`): the
clipped 7x7 (luma) or 5x5 (chroma) diamond with virtual-boundary row
substitution.  `cc_filter` replaces `_cc_pallas` in its fused form
(`fused_device._cc_filter`): the 7-tap luma-to-chroma correction.

Both take their coefficients per block (per 4x4 block for luma ALF, per
CTB for chroma ALF and CC-ALF) instead of per pixel.  On a CUDA tensor each
launches its kernel in csrc/filters.cu; on a CPU tensor each runs its
`*_ref` twin, the same integer math in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from ffvvc_tpu.alf import ALF_BORDER_LUMA

from . import _build
from .sao_device import _log2, expand_ctb

# luma 7x7-diamond tap geometry: (row_key_a, dx_a, row_key_b, dx_b) per
# coefficient, row keys indexing the VB-resolved row planes 0..6
# (0:+0, 1:+1, 2:-1, 3:+2, 4:-2, 5:+3, 6:-3) — alf.py _filter_luma taps
_LUMA_TAPS = ((5, 0, 6, 0), (3, 1, 4, -1), (3, 0, 4, 0), (3, -1, 4, 1),
              (1, 2, 2, -2), (1, 1, 2, -1), (1, 0, 2, 0), (1, -1, 2, 1),
              (1, -2, 2, 2), (0, 3, 0, -3), (0, 2, 0, -2), (0, 1, 0, -1))
# chroma 5x5-diamond taps mapped onto the luma tap slots (alf.py
# _filter_chroma taps k -> luma slot)
_CHROMA_SLOT = (2, 5, 6, 7, 10, 11)
# the kernels' 12-bit slot masks
LUMA_SLOTS = (1 << 12) - 1
CHROMA_SLOTS = sum(1 << s for s in _CHROMA_SLOT)
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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ---- ALF --------------------------------------------------------------------

def alf_filter_plane_ref(cur, P3, rowsel, vbsel, cf_blk, cl_blk,
                         blk_log2_h, blk_log2_w, slots, border, pix_max):
    """Plain PyTorch clipped-diamond ALF (`fused_device._alf_filter_plane`).
    cur: int32 [H, W]; P3: the edge-padded source [H + 2b, W + 2b];
    rowsel: int64 [7, H] P3-row indices; vbsel: int32 [H] (1: round with
    >>10); cf_blk/cl_blk: int32 [nby, nbx, 12] per block of
    2^blk_log2_h x 2^blk_log2_w samples; slots: 12-bit mask of the taps."""
    H, W = cur.shape
    rows = {}           # row planes of the taps in use (chroma: 0..4 only)

    def at(k, dx):
        if k not in rows:
            rows[k] = P3.index_select(0, rowsel[k])
        return rows[k][:, border + dx:border + dx + W]

    def px(a):
        return expand_ctb(a, 1 << blk_log2_h, 1 << blk_log2_w, H, W)
    acc = torch.zeros_like(cur)
    for s, (ka, da, kb, db) in enumerate(_LUMA_TAPS):
        if not (slots >> s) & 1:
            continue
        cl = px(cl_blk[:, :, s])
        d = torch.clamp(at(ka, da) - cur, -cl, cl) + \
            torch.clamp(at(kb, db) - cur, -cl, cl)
        acc = acc + px(cf_blk[:, :, s]) * d
    acc = torch.where(vbsel[:, None] != 0, (acc + (1 << 9)) >> 10,
                      (acc + 64) >> 7)
    return torch.clamp(cur + acc, 0, pix_max)


def alf_filter_plane(cur, P3, rowsel, vbsel, cf_blk, cl_blk, blk_log2_h,
                     blk_log2_w, slots, border, pix_max):
    """ALF of one plane: the CUDA kernel on CUDA tensors,
    `alf_filter_plane_ref` on CPU tensors.  Returns a new int32 [H, W]."""
    args = (cur, P3, rowsel, vbsel, cf_blk, cl_blk, blk_log2_h, blk_log2_w,
            slots, border, pix_max)
    if cur.device.type == "cpu":
        return alf_filter_plane_ref(*args)
    _check_cuda("alf_filter_plane", cur, P3, rowsel, vbsel, cf_blk, cl_blk)
    H, W = cur.shape
    nby, nbx = cf_blk.shape[:2]
    if (cur.dtype, P3.dtype, vbsel.dtype, cf_blk.dtype, cl_blk.dtype) != \
            (torch.int32,) * 5 or rowsel.dtype != torch.int64:
        raise ValueError("alf_filter_plane: int32 planes/params and int64 "
                         "rowsel expected")
    if P3.shape != (H + 2 * border, W + 2 * border) or \
            rowsel.shape != (7, H) or vbsel.shape != (H,) or \
            cl_blk.shape != cf_blk.shape or cf_blk.shape[2] != 12 or \
            nby << blk_log2_h < H or nbx << blk_log2_w < W:
        raise ValueError("alf_filter_plane: inconsistent shapes")
    out = torch.empty_like(cur)
    err = _build.lib().ffvvc_alf(
        cur.data_ptr(), P3.data_ptr(), P3.shape[1], rowsel.data_ptr(),
        vbsel.data_ptr(), cf_blk.data_ptr(), cl_blk.data_ptr(), nbx,
        blk_log2_h, blk_log2_w, slots, border, pix_max, H, W,
        out.data_ptr(), _stream(cur))
    _build.check(err, "ffvvc_alf")
    alf_filter_plane.launches += 1
    return out


alf_filter_plane.launches = 0


# ---- CC-ALF -----------------------------------------------------------------

def cc_filter_ref(dst, P3l, rowsel, skip, cf_ctb, cs_v, cs_h, hs, half,
                  pix_max):
    """Plain PyTorch CC-ALF (`fused_device._cc_filter`).  dst: int32
    [Hc, Wc] chroma; P3l: edge-padded pre-ALF luma [H + 6, W + 6]; rowsel:
    int64 [4, Hc] P3l-row indices r0..r3; skip: int32 [Hc] (rows with no
    correction); cf_ctb: int32 [ch, cw, 7] per chroma CTB of cs_v x cs_h."""
    Hc, Wc = dst.shape
    b = ALF_BORDER_LUMA
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
    return torch.clamp(dst + acc, 0, pix_max)


def cc_filter(dst, P3l, rowsel, skip, cf_ctb, cs_v, cs_h, hs, half,
              pix_max):
    """CC-ALF of one chroma plane: the CUDA kernel on CUDA tensors,
    `cc_filter_ref` on CPU tensors.  Returns a new int32 [Hc, Wc]."""
    args = (dst, P3l, rowsel, skip, cf_ctb, cs_v, cs_h, hs, half, pix_max)
    if dst.device.type == "cpu":
        return cc_filter_ref(*args)
    _check_cuda("cc_filter", dst, P3l, rowsel, skip, cf_ctb)
    Hc, Wc = dst.shape
    ch, cw = cf_ctb.shape[:2]
    if (dst.dtype, P3l.dtype, skip.dtype, cf_ctb.dtype) != \
            (torch.int32,) * 4 or rowsel.dtype != torch.int64:
        raise ValueError("cc_filter: int32 planes/params and int64 rowsel "
                         "expected")
    b = ALF_BORDER_LUMA
    if rowsel.shape != (4, Hc) or skip.shape != (Hc,) or \
            cf_ctb.shape[2] != 7 or ch * cs_v < Hc or cw * cs_h < Wc or \
            P3l.shape[1] < ((Wc - 1) << hs) + b + 2:
        raise ValueError("cc_filter: inconsistent shapes")
    out = torch.empty_like(dst)
    err = _build.lib().ffvvc_cc(
        dst.data_ptr(), P3l.data_ptr(), P3l.shape[1], rowsel.data_ptr(),
        skip.data_ptr(), cf_ctb.data_ptr(), cw, _log2(cs_v, "cs_v"),
        _log2(cs_h, "cs_h"), hs, half, pix_max, Hc, Wc, out.data_ptr(),
        _stream(dst))
    _build.check(err, "ffvvc_cc")
    cc_filter.launches += 1
    return out


cc_filter.launches = 0
