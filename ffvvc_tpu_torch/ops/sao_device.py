"""SAO of the fused chain: the CUDA kernel wrapper and its plain version.

`sao_apply` replaces `ffvvc_tpu/ops/sao_device.py::_sao_pallas` as the
fused chain runs it (`ffvvc_tpu/ops/fused_device.py::_sao_apply`): band
offset or edge offset per CTB, clipped, with the frame-border samples of
the keep map left as they are.  It takes all planes of a picture at once,
as 16-bit samples.  On CUDA tensors it launches `sao_kernel`
(csrc/filters.cu) once for all of them; the kernel expands the per-CTB
parameters itself.  On CPU tensors it runs `sao_apply_ref`, the same integer
math in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sao import SAO_BAND, SAO_EDGE

from . import _build

# per-CTB parameter rows of the packed [13, ch, cw] table the kernel reads
# (`pack_params`): offs takes five rows
_PARAM_ROWS = ("typ", "m1", "offs", "kl", "kr", "kt", "kb", "ax", "bx")
# the narrowest CTB the kernels' tiles are laid out for
MIN_CTB = 16


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


def _log2(n, what):
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")
    return n.bit_length() - 1


def stream_of(t):
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def pack_params(p):
    """The nine per-CTB arrays of `_sao_ctb_params` (numpy, [ch, cw] and
    offs [5, ch, cw]) as the one int32 [13, ch, cw] array the wrapper
    takes."""
    ch, cw = p["typ"].shape
    return np.concatenate([np.asarray(p[k], np.int32).reshape(-1, ch, cw)
                           for k in _PARAM_ROWS])


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


def _sao_plane_ref(plane, prm, cs_v, cs_h, shift, pix_max):
    H, W = plane.shape

    def px(a):
        return expand_ctb(a, cs_v, cs_h, H, W)
    typ, m1 = px(prm[0]), px(prm[1])
    offs = torch.stack([px(prm[2 + k]) for k in range(5)])
    kl, kr, kt, kb, ax, bx = (px(prm[7 + k]) for k in range(6))
    xs = torch.arange(W, dtype=torch.int32, device=plane.device)[None, :]
    ys = torch.arange(H, dtype=torch.int32, device=plane.device)[:, None]
    x_loc = xs & (cs_h - 1)
    in_x = (x_loc >= ax) & (x_loc < bx)
    keep = ((xs == 0) & (kl != 0)) | ((xs == W - 1) & (kr != 0)) | \
        ((ys == 0) & (kt != 0) & in_x) | ((ys == H - 1) & (kb != 0) & in_x)
    out = sao_math(pad_edge(plane.to(torch.int32), 1), typ, m1, offs, keep,
                   shift, pix_max)
    return out.to(torch.int16)


def sao_apply_ref(planes, prms, sizes, shift, pix_max):
    """Plain PyTorch SAO (`fused_device._sao_apply`) of a list of planes.
    planes: int16 [H, W] each; prms: the packed int32 [13, ch, cw]
    per-CTB parameters of each (`pack_params`); sizes: (cs_v, cs_h) CTB
    size of each in its samples.  Returns new int16 planes."""
    return [_sao_plane_ref(x, p, cs_v, cs_h, shift, pix_max)
            for x, p, (cs_v, cs_h) in zip(planes, prms, sizes)]


def sao_apply(planes, prms, sizes, shift, pix_max):
    """SAO of up to three planes: one launch of the CUDA kernel on CUDA
    tensors, `sao_apply_ref` on CPU tensors.  Same arguments as
    `sao_apply_ref`; returns new int16 [H, W] tensors."""
    kind = planes[0].device.type
    if kind == "cpu":
        return sao_apply_ref(planes, prms, sizes, shift, pix_max)
    if kind != "cuda":
        raise ValueError(f"sao_apply: unsupported device {planes[0].device}")
    n = len(planes)
    if not 1 <= n <= 3 or len(prms) != n or len(sizes) != n:
        raise ValueError("sao_apply: one to three planes, each with its "
                         "parameters and CTB size")
    outs, ptrs, dims = [], [], []
    for x, p, (cs_v, cs_h) in zip(planes, prms, sizes):
        H, W = x.shape
        if x.dtype != torch.int16 or p.dtype != torch.int32 or \
                not (x.is_cuda and p.is_cuda and x.is_contiguous()
                     and p.is_contiguous()) or x.data_ptr() % 8:
            raise ValueError("sao_apply: contiguous, 8-byte aligned CUDA "
                             "int16 planes and int32 parameters expected")
        ch, cw = p.shape[1:]
        if p.shape[0] != 13 or ch * cs_v < H or cw * cs_h < W or W % 4 or \
                min(cs_v, cs_h) < MIN_CTB:
            raise ValueError("sao_apply: parameters [13, ch, cw] must cover "
                             "the plane, its width a multiple of 4 and its "
                             f"CTB at least {MIN_CTB}")
        out = torch.empty_like(x)
        outs.append(out)
        ptrs += [x.data_ptr(), out.data_ptr(), p.data_ptr()]
        dims += [H, W, ch, cw, _log2(cs_v, "cs_v"), _log2(cs_h, "cs_h")]
    err = _build.lib().ffvvc_sao(
        n, (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(dims))(*dims), shift, pix_max,
        stream_of(planes[0]))
    _build.check(err, "ffvvc_sao")
    sao_apply.launches += 1
    return outs


# kernel launches (chip_smoke.py resets and reads it)
sao_apply.launches = 0
