"""Device DMVR refinement + BDOF: batched subblock functions on tensors.

Port of `ffvvc_tpu/ops/inter_device.py` (reference analogue:
libavcodec/x86/vvc/vvc_inter.asm SAD, vvc_inter_template.c:237-323 BDOF,
vvc_inter.c:642-748 refine): all DMVR/BDOF subblocks of a frame are
fixed-size stencils, so each family is one batched call —

* `dmvr_refine_batch`: 25-point SAD search over the bilinear-prefetched pair
  [B, bh+4, bw+4] + the 3-step parametric division, vectorized over
  subblocks with the reference's exact tie-breaking (center-first order,
  strict-< replacement, the center's sad -= sad>>2 handicap).
* `bdof_batch`: per-4x4-cell gradient sums and vx/vy solve over the
  [B, h+2, w+2] integer-ring windows (bit_length computed with exact
  integer compares — float log2 would mis-round), all cells of all blocks
  at once.

Plain PyTorch in int32 throughout (the JAX package has no kernel here
either); bit-exact vs the host golden (inter.py _dmvr_refine / _apply_bdof),
pinned by tests/test_torch_mc.py.
"""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def _bit_length(x):
    """Exact integer bit_length for x >= 0 (31 compares, vectorized)."""
    bl = torch.zeros_like(x)
    for i in range(31):
        bl = bl + (x >= (1 << i)).to(x.dtype)
    return bl


# scan order: center first (strict-< replacement semantics), then the
# golden model's dy-major scan skipping the center
_OFFS = [(2, 2)] + [(dy, dx) for dy in range(5) for dx in range(5)
                    if (dy, dx) != (2, 2)]
# (dy, dx) -> scan index; center sits at 0
_LUT = np.zeros((5, 5), np.int64)
for _i, (_y, _x) in enumerate(_OFFS):
    _LUT[_y, _x] = _i


def _dmvr_refine(t0, t1, bw: int, bh: int):
    """t0/t1: int32 tensors [B, bh+4, bw+4].  Returns (dmv [B, 2] int32,
    skip_bdof [B] bool) on the tensors' device."""
    dev = t0.device
    sads = []
    for dy, dx in _OFFS:
        a = t0[:, dy:dy + bh:2, dx:dx + bw]
        b = t1[:, 4 - dy:4 - dy + bh:2, 4 - dx:4 - dx + bw]
        sads.append((a - b).abs().sum(dim=(1, 2), dtype=I32))
    sad = torch.stack(sads, dim=1)                      # [B, 25]
    center = sad[:, 0] - (sad[:, 0] >> 2)
    sad = sad.clone()
    sad[:, 0] = center
    search = center >= bw * bh
    # the first minimum in scan order, whatever order a reduction visits
    # the 25 candidates in: the scan index rides in the low 5 bits
    # (sad <= 1023 * 8 * 16 < 2^17)
    key = (sad << 5) + torch.arange(25, dtype=I32, device=dev)[None, :]
    best = (key.min(dim=1).values & 31).to(torch.int64)
    best = torch.where(search, best, torch.zeros_like(best))
    offs = torch.tensor(_OFFS, dtype=I32, device=dev)
    mdy = offs[best, 0]
    mdx = offs[best, 1]
    min_sad = sad.gather(1, best[:, None])[:, 0]
    lut = torch.from_numpy(_LUT).to(dev)

    def sad_at(dy, dx):
        idx = lut[dy.to(torch.int64), dx.to(torch.int64)]
        return sad.gather(1, idx[:, None])[:, 0]

    def refine(sm, sc, sp):
        denom = ((sm + sp) - (sc << 1)) << 3
        num = (sm - sp) << 4
        sign = num < 0
        anum = num.abs()
        q = torch.zeros_like(anum)
        d = denom
        for _ in range(3):
            # no d > 0 guard: the golden loop keeps dividing the shifted
            # denominator even when it reaches 0 (anum >= 0 then holds)
            q = q << 1
            ge = anum >= d
            anum = torch.where(ge, anum - d, anum)
            q = torch.where(ge, q + 1, q)
            d = d >> 1
        q = torch.where(sign, -q, q)
        eight = torch.full_like(q, 8)
        return torch.where(denom == 0, torch.zeros_like(q),
                           torch.where(sm == sc, -eight,
                                       torch.where(sp == sc, eight, q)))

    inner = (mdx != 0) & (mdx != 4) & (mdy != 0) & (mdy != 4) & search
    cdx = mdx.clamp(1, 3)
    cdy = mdy.clamp(1, 3)
    rx = refine(sad_at(cdy, cdx - 1), sad_at(cdy, cdx), sad_at(cdy, cdx + 1))
    ry = refine(sad_at(cdy - 1, cdx), sad_at(cdy, cdx), sad_at(cdy + 1, cdx))
    zero = torch.zeros_like(mdx)
    dmvx = torch.where(search, (mdx - 2) << 4, zero) + \
        torch.where(inner, rx, zero)
    dmvy = torch.where(search, (mdy - 2) << 4, zero) + \
        torch.where(inner, ry, zero)
    skip = min_sad < 2 * bw * bh
    return torch.stack([dmvx, dmvy], dim=1), skip


def dmvr_refine_batch(t0, t1, bw, bh, device="cuda"):
    """t0/t1: np.int32 [B, bh+4, bw+4] bilinear-prefetched pair (10-bit
    domain).  Returns (dmv [B, 2] int32 in 1/16-pel, skip_bdof [B] bool)."""
    dev = torch.device(device)
    dmv, skip = _dmvr_refine(
        torch.from_numpy(np.ascontiguousarray(t0, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(t1, np.int32)).to(dev),
        int(bw), int(bh))
    return dmv.cpu().numpy(), skip.cpu().numpy()


def _pad_edge(x):
    """[B, h, w] -> [B, h+2, w+2] with the border rows and columns
    repeated (replicate padding, which torch has for floats only)."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def _cells(x):
    """[B, h+2, w+2] -> the 6x6 window of every 4x4 cell,
    [B, h/4, w/4, 6, 6] (a view)."""
    return x.unfold(1, 6, 4).unfold(2, 6, 4)


def _bdof(s0p, s1p, w: int, h: int, bd: int):
    """s0p/s1p: int32 tensors [B, h+2, w+2] (14-bit blocks inside their
    integer ring).  Returns pixels [B, h, w] int32."""
    def grads(sp):
        gh = (sp[:, 1:1 + h, 2:2 + w] >> 6) - (sp[:, 1:1 + h, 0:w] >> 6)
        gv = (sp[:, 2:2 + h, 1:1 + w] >> 6) - (sp[:, 0:h, 1:1 + w] >> 6)
        return gh, gv

    gh0, gv0 = grads(s0p)
    gh1, gv1 = grads(s1p)
    c0 = s0p[:, 1:1 + h, 1:1 + w]
    c1 = s1p[:, 1:1 + h, 1:1 + w]
    shift4 = 15 - bd
    off4 = 1 << (shift4 - 1)
    diff = _cells(_pad_edge((c0 >> 4) - (c1 >> 4)))
    th = _cells(_pad_edge((gh0 + gh1) >> 1))
    tv = _cells(_pad_edge((gv0 + gv1) >> 1))

    def total(x):
        return x.sum(dim=(3, 4), dtype=I32)             # [B, h/4, w/4]

    sgx2 = total(th.abs())
    sgy2 = total(tv.abs())
    sgxgy = total(torch.sign(tv) * th)
    sgxdi = total(-torch.sign(th) * diff)
    sgydi = total(-torch.sign(tv) * diff)
    thres = 16
    zero = torch.zeros_like(sgx2)
    # the shift of a cell with a zero sum is not used: keep it in range
    vx = torch.where(
        sgx2 > 0,
        ((sgxdi << 2) >> (_bit_length(sgx2) - 1).clamp(min=0)).clamp(
            -thres + 1, thres - 1), zero)
    vy = torch.where(
        sgy2 > 0,
        (((sgydi << 2) - ((vx * sgxgy) >> 1)) >>
         (_bit_length(sgy2) - 1).clamp(min=0)).clamp(-thres + 1, thres - 1),
        zero)

    def per_sample(v):
        return v.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)

    boff = per_sample(vx) * (gh0 - gh1) + per_sample(vy) * (gv0 - gv1)
    out = (c0 + off4 + c1 + boff) >> shift4
    return out.clamp(0, (1 << bd) - 1)


def bdof_batch(s0p, s1p, bd, device="cuda"):
    """s0p/s1p: np.int32 [B, h+2, w+2] 14-bit blocks with the integer
    border ring (bdof_fetch_samples layout).  Returns pixels [B, h, w]."""
    dev = torch.device(device)
    h, w = s0p.shape[1] - 2, s0p.shape[2] - 2
    return _bdof(
        torch.from_numpy(np.ascontiguousarray(s0p, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(s1p, np.int32)).to(dev),
        int(w), int(h), int(bd)).cpu().numpy()
