"""SAO of the fused chain: the CUDA kernel wrapper and its plain twin.

`sao_apply` replaces `ffvvc_tpu/ops/sao_device.py::_sao_pallas` as the
fused chain runs it (`ffvvc_tpu/ops/fused_device.py::_sao_apply`): band
offset or edge offset per CTB, clipped, with the frame-border samples of
the keep map left as they are.  On a CUDA tensor it launches
`sao_kernel` (csrc/filters.cu), which expands the per-CTB parameters
itself; on a CPU tensor it runs `sao_apply_ref`, the same integer math in
plain PyTorch.
"""
from __future__ import annotations

import torch

from ffvvc_tpu.sao import SAO_BAND, SAO_EDGE

from . import _build

# per-CTB parameter rows of the kernel's packed [13, ch, cw] table
_PARAM_ROWS = ("typ", "m1", "offs", "kl", "kr", "kt", "kb", "ax", "bx")


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


def sao_apply_ref(plane, p, cs_v, cs_h, shift, pix_max):
    """Plain PyTorch SAO of one plane (`fused_device._sao_apply`).
    plane: int32 [H, W]; p: per-CTB int32 [ch, cw] tensors typ, m1, kl,
    kr, kt, kb, ax, bx and offs [5, ch, cw]."""
    H, W = plane.shape

    def px(a):
        return expand_ctb(a, cs_v, cs_h, H, W)
    offs = torch.stack([px(p["offs"][k]) for k in range(5)])
    xs = torch.arange(W, dtype=torch.int32, device=plane.device)[None, :]
    ys = torch.arange(H, dtype=torch.int32, device=plane.device)[:, None]
    x_loc = xs & (cs_h - 1)
    in_x = (x_loc >= px(p["ax"])) & (x_loc < px(p["bx"]))
    keep = ((xs == 0) & (px(p["kl"]) != 0)) | \
        ((xs == W - 1) & (px(p["kr"]) != 0)) | \
        ((ys == 0) & (px(p["kt"]) != 0) & in_x) | \
        ((ys == H - 1) & (px(p["kb"]) != 0) & in_x)
    return sao_math(pad_edge(plane, 1), px(p["typ"]), px(p["m1"]), offs,
                    keep, shift, pix_max)


def sao_apply(plane, p, cs_v, cs_h, shift, pix_max):
    """SAO of one plane: the CUDA kernel on a CUDA tensor, `sao_apply_ref`
    on a CPU tensor.  Same arguments as `sao_apply_ref`; returns a new
    int32 [H, W] tensor."""
    if plane.device.type == "cpu":
        return sao_apply_ref(plane, p, cs_v, cs_h, shift, pix_max)
    if plane.device.type != "cuda":
        raise ValueError(f"sao_apply: unsupported device {plane.device}")
    H, W = plane.shape
    ch, cw = p["typ"].shape
    if plane.dtype != torch.int32 or not plane.is_contiguous():
        raise ValueError("sao_apply: plane must be contiguous int32")
    if ch * cs_v < H or cw * cs_h < W:
        raise ValueError("sao_apply: CTB grid does not cover the plane")
    prm = torch.cat([p[k].reshape(-1, ch, cw) for k in _PARAM_ROWS])
    prm = prm.to(device=plane.device, dtype=torch.int32).contiguous()
    if prm.shape[0] != 13:
        raise ValueError("sao_apply: offs must be [5, ch, cw]")
    out = torch.empty_like(plane)
    err = _build.lib().ffvvc_sao(
        plane.data_ptr(), out.data_ptr(), H, W, prm.data_ptr(), ch, cw,
        _log2(cs_v, "cs_v"), _log2(cs_h, "cs_h"), shift, pix_max,
        torch.cuda.current_stream(plane.device).cuda_stream)
    _build.check(err, "ffvvc_sao")
    sao_apply.launches += 1
    return out


# kernel launches (chip_smoke.py resets and reads it)
sao_apply.launches = 0
