"""Device inter MC: batched 8-tap (luma) / 4-tap (chroma) fractional-sample
interpolation over same-size block batches.

Port of `ffvvc_tpu/ops/mc_device.py` (reference analogue:
libavcodec/x86/h26x/h2656_inter.asm wrapped at x86/vvc/vvcdsp_init.c:34-171):
instead of one call per block, all MC jobs of one (w, h, is_luma,
frac-class) bucket are a single batched call — clamped gather of the
(h+taps-1, w+taps-1) windows, then separable taps.  Integer math only,
bit-exact vs the host golden (inter.py _mc_put), pinned by
tests/test_torch_mc.py.  Plain PyTorch on tensors: the JAX package has no
kernel here either.

The decoder-side dispatch covers EVERY block shape of the reference's SIMD
(vvcdsp_init.c grid): regular blocks (incl. weighted pred / BCW /
LMCS-forward / wraparound), GPM blends, affine (+PROF gradient refinement)
and SbTMVP subblock grids — subblock MVs expand from the frame's mvf/cp_mv
tab grids — and DMVR/BDOF in frame-batched phases: phase A runs every DMVR
subblock's bilinear prefetch + 25-point SAD refine as batched calls
(ops/inter_device), then the refined MVs feed box-clamped puts, batched
per-4x4 BDOF solves and the TMVP col-grid writeback (the reference
interleaves these per CTU inside the inter task, vvc_inter.c:642-760;
hoisting the refine to a frame phase is what makes it batchable).

The puts of one `frame_device_mc` call go to the device as one table
(`PutTable`: an int32 row a block, ordered by block size) and run as one
launch of the hand-written `mc_put_kernel` (csrc/mc.cu) on CUDA tensors
(`put_table`); on CPU tensors `put_table_ref` groups the rows back into
buckets and runs `_mc_put_math`, the kernel's plain twin.  Every output
lands in one int32 buffer, each block size's outputs together, which PROF,
the BDOF rings and the finals read as [N, h, w] views.

What stays on the device within one `frame_device_mc` call: each reference
plane (uploaded once, as 16-bit samples), every put output through PROF
and the finals; a finals bucket comes down once, as 16-bit pixels.
Integer width: int32, and int64 where the golden model needs it (GPM and
the weighted finals).

On a mesh (`parallel/mesh.py`) the rows of a call's put table split over
the "tile" axis: each part goes to its device with the reference planes it
reads, and the outputs come back into the call's buffer in order
(`sharded_puts`; the planes' bytes each other device received:
`sharded_ref_bytes`).
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .. import trace
from .device import (Counters, as_wire, counted, download, kernel_device,
                     one_device, run, upload)
from .inter_device import _bdof, _dmvr_refine

I32, I64 = torch.int32, torch.int64

# What the calls since reset_stats() did.  `launches` counts batched device
# calls (a put table's kernel launch, or one put bucket of the plain twin,
# prefetch, refine, PROF or finals bucket each), not CUDA kernels; the put
# kernel's own launches are `put_table.launches`.  `put_buckets` counts the
# distinct put groups (reference plane, size, filter class, wrap, box),
# whichever way they ran; `put_class` the put buckets by class (copy, h, v,
# hv).  Where the time goes is in the spans of `frame_device_mc` (trace.py:
# `mc` and its phases `mc.collect` ... `mc.writeback`).
stats = Counters("calls", "descriptors", "put_buckets", "put_blocks",
                 "bilin_buckets", "dmvr_subblocks", "bdof_blocks",
                 "prof_blocks", "gpm_blocks", "weighted_blocks",
                 "finals_buckets", "launches", "up_bytes", "down_bytes",
                 put_class=[0, 0, 0, 0])
reset_stats = stats.reset


@functools.lru_cache()
def _filter_banks(device="cpu"):
    from . import data as D
    t = D.tables()
    dev = torch.device(device)
    return (torch.from_numpy(t["luma_filters"].astype(np.int32)).to(dev),
            torch.from_numpy(t["chroma_filters"].astype(np.int32)).to(dev))


def _mc_put_math(ref, xs, ys, hf, vf, box, w: int, h: int, is_luma: bool,
                 bd: int, fclass: int, wrap: int = 0,
                 boxed: bool = False):
    """Batched put: ref [H, W] int32; xs/ys [B] block origins (integer-pel,
    already including mv>>4); hf/vf [B, taps] filter rows.  fclass selects
    the put variant (0: copy, 1: h only, 2: v only, 3: hv) — the
    put[..][!!my][!!mx] grid of vvcdsp.h:49.  wrap: horizontal wraparound
    offset (spec 8.5.6.3.2 ClipH; 0 = clamp).  boxed: clamp sample
    coordinates into per-block inclusive boxes box [B, 4] = (x0, x1, y0,
    y1) — the DMVR prefetch-window emulation (native fetch()).  Returns
    [B, h, w] int32 in the 14-bit intermediate domain."""
    H, W = ref.shape
    taps = 8 if is_luma else 4
    eb = 3 if is_luma else 1
    dev = ref.device

    def gather(x0s, y0s, gw, gh):
        gx = x0s[:, None] + torch.arange(gw, dtype=I32, device=dev)[None, :]
        if wrap:
            gx = torch.where(gx < 0, gx + wrap,
                             torch.where(gx > W - 1, gx - wrap, gx))
        gy = y0s[:, None] + torch.arange(gh, dtype=I32, device=dev)[None, :]
        if boxed:
            gx = torch.minimum(torch.maximum(gx, box[:, 0:1]), box[:, 1:2])
            gy = torch.minimum(torch.maximum(gy, box[:, 2:3]), box[:, 3:4])
        gx = gx.clamp(0, W - 1).to(I64)
        gy = gy.clamp(0, H - 1).to(I64)
        return ref[gy[:, :, None], gx[:, None, :]]   # [B, gh, gw]

    if fclass == 0:
        return gather(xs, ys, w, h) << (14 - bd)
    if fclass == 1:
        src = gather(xs - eb, ys, w + taps - 1, h)
        acc = src[:, :, 0:w] * hf[:, 0, None, None]
        for k in range(1, taps):
            acc = acc + src[:, :, k:k + w] * hf[:, k, None, None]
        return acc >> (bd - 8)
    if fclass == 2:
        src = gather(xs, ys - eb, w, h + taps - 1)
        acc = src[:, 0:h, :] * vf[:, 0, None, None]
        for k in range(1, taps):
            acc = acc + src[:, k:k + h, :] * vf[:, k, None, None]
        return acc >> (bd - 8)
    src = gather(xs - eb, ys - eb, w + taps - 1, h + taps - 1)
    tmp = src[:, :, 0:w] * hf[:, 0, None, None]
    for k in range(1, taps):
        tmp = tmp + src[:, :, k:k + w] * hf[:, k, None, None]
    tmp = tmp >> (bd - 8)
    acc = tmp[:, 0:h, :] * vf[:, 0, None, None]
    for k in range(1, taps):
        acc = acc + tmp[:, k:k + h, :] * vf[:, k, None, None]
    return acc >> 6


def _mc_avg_batch(s0, s1, bd: int):
    """Bi-prediction average: [B, h, w] 14-bit pair -> pixels."""
    shift = max(3, 15 - bd)
    off = 1 << (shift - 1)
    return ((s0 + s1 + off) >> shift).clamp(0, (1 << bd) - 1)


def _mc_uni_batch(val, bd: int):
    shift = 14 - bd
    off = 1 << (shift - 1)
    return ((val + off) >> shift).clamp(0, (1 << bd) - 1)


def _prof_apply_batch(val, ring, dmx, dmy, bd: int):
    """PROF gradient refinement of affine 4x4 subblocks: val [B, 4, 4]
    (14-bit put output), ring [B, 6, 6] (integer samples << (14-bd),
    fclass-0 put of the 6x6 window), dmx/dmy [B, 4, 4].  Mirrors native
    prof_block: the ring's interior is replaced by the put values before
    the gradients read it."""
    padded = ring.clone()
    padded[:, 1:5, 1:5] = val
    gh = (padded[:, 1:5, 2:6] >> 6) - (padded[:, 1:5, 0:4] >> 6)
    gv = (padded[:, 2:6, 1:5] >> 6) - (padded[:, 0:4, 1:5] >> 6)
    limit = 1 << max(13, bd + 1)
    di = (gh * dmx + gv * dmy).clamp(-limit, limit - 1)
    return padded[:, 1:5, 1:5] + di


def _affine_diff_mvs(cp, num_cp, w, h):
    """Per-4x4 PROF diff-MV grids from the stored control-point MVs —
    the numpy twin of native affine_sb_params + affine_diff_mvs
    (mvs.py _init_subblock_params / _derive_subblock_diff_mvs)."""
    D = 7                                   # MAX_CU_DEPTH
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    cp = np.asarray(cp, np.int64)
    d_hor_x = (cp[1, 0] - cp[0, 0]) << (D - lw)
    d_ver_x = (cp[1, 1] - cp[0, 1]) << (D - lw)
    if num_cp == 3:
        d_hor_y = (cp[2, 0] - cp[0, 0]) << (D - lh)
        d_ver_y = (cp[2, 1] - cp[0, 1]) << (D - lh)
    else:
        d_hor_y = -d_ver_x
        d_ver_y = d_hor_x
    lim = 1 << 5
    xs = np.arange(4, dtype=np.int64)[None, :]
    ys = np.arange(4, dtype=np.int64)[:, None]
    d0 = xs * (d_hor_x << 2) + ys * (d_hor_y << 2) - \
        6 * (d_hor_x + d_hor_y)
    d1 = xs * (d_ver_x << 2) + ys * (d_ver_y << 2) - \
        6 * (d_ver_x + d_ver_y)
    d0 = (d0 + 128 - (d0 >= 0)) >> 8        # round_mv(d, 0, 8)
    d1 = (d1 + 128 - (d1 >= 0)) >> 8
    return (np.clip(d0, -lim + 1, lim - 1).astype(np.int32),
            np.clip(d1, -lim + 1, lim - 1).astype(np.int32))


def _dmvr_bilin_batch(ref, xs, ys, fx, fy, pw: int, ph: int, bd: int,
                      mclass: int, wrap: int):
    """Batched DMVR bilinear prefetch to the 10-bit domain: xs/ys [B]
    window origins (x0 + (mv>>4) - 2), fx/fy [B, 2] 2-tap rows per the
    fractional phases.  mclass like fclass (0 copy, 1 h, 2 v, 3 hv).
    Mirrors native dmvr_bilinear."""
    H, W = ref.shape
    dev = ref.device

    def gather(gw, gh):
        gx = xs[:, None] + torch.arange(gw, dtype=I32, device=dev)[None, :]
        if wrap:
            gx = torch.where(gx < 0, gx + wrap,
                             torch.where(gx > W - 1, gx - wrap, gx))
        gx = gx.clamp(0, W - 1).to(I64)
        gy = (ys[:, None] + torch.arange(gh, dtype=I32, device=dev)[None, :]
              ).clamp(0, H - 1).to(I64)
        return ref[gy[:, :, None], gx[:, None, :]]

    if mclass == 0:
        v = gather(pw, ph)
        if bd > 10:
            return (v + (1 << (bd - 11))) >> (bd - 10)
        return v << (10 - bd)
    shift1 = bd - 6
    off1 = 1 << (shift1 - 1)
    f0x, f1x = fx[:, 0, None, None], fx[:, 1, None, None]
    f0y, f1y = fy[:, 0, None, None], fy[:, 1, None, None]
    if mclass == 1:
        src = gather(pw + 1, ph)
        return (f0x * src[:, :, :pw] + f1x * src[:, :, 1:] + off1) >> shift1
    if mclass == 2:
        src = gather(pw, ph + 1)
        return (f0y * src[:, :ph] + f1y * src[:, 1:] + off1) >> shift1
    src = gather(pw + 1, ph + 1)
    tmp = (f0x * src[:, :, :pw] + f1x * src[:, :, 1:] + off1) >> shift1
    return (f0y * tmp[:, :ph] + f1y * tmp[:, 1:] + 8) >> 4


def _bdof_full_batch(s0, s1, r0, r1, w: int, h: int, bd: int):
    """BDOF finals: puts s0/s1 [B, h, w] placed into their integer rings
    r0/r1 [B, h+2, w+2] (bdof_fetch layout), then the per-4x4 vx/vy
    solve + apply (ops/inter_device._bdof)."""
    r0, r1 = r0.clone(), r1.clone()
    r0[:, 1:1 + h, 1:1 + w] = s0
    r1[:, 1:1 + h, 1:1 + w] = s1
    return _bdof(r0, r1, w, h, bd)


def _dmvr_box(x_sb, y_sb, w, h, is_luma, pw, ph):
    """Native dmvr_box: the inclusive prefetch-window clamp bounds."""
    eb, ea = (3, 4) if is_luma else (1, 2)
    sx = min(max(x_sb - eb, 0), pw - 1)
    sy = min(max(y_sb - eb, 0), ph - 1)
    wdt = max(min(pw, x_sb + w + ea) - sx, 1)
    hgt = max(min(ph, y_sb + h + ea) - sy, 1)
    return (sx, sx + wdt - 1, sy, sy + hgt - 1)


@functools.lru_cache()
def _dmvr_filters():
    from . import data as D
    return np.asarray(D.tables()["luma_dmvr_filters"], np.int32)


def _mc_gpm_batch(s0, s1, wgt, bd: int):
    """GPM two-hypothesis blend: wgt [B, h, w] in 0..8 (host-sliced from
    the partition weight tables); mirrors native pred_gpm_blk."""
    shift = max(5, 17 - bd)
    off = 1 << (shift - 1)
    wgt = wgt.to(I64)
    v = (s0.to(I64) * wgt + s1.to(I64) * (8 - wgt) + off) >> shift
    return v.clamp(0, (1 << bd) - 1).to(I32)


@functools.lru_cache()
def _gpm_tables():
    from . import data as D
    t = D.tables()
    return (t["gpm_angle_idx"], t["gpm_angle_to_weights_idx"],
            t["gpm_weights_offset_x"], t["gpm_weights_offset_y"],
            t["gpm_angle_to_mirror"],
            np.asarray(t["gpm_weights"]).reshape(-1, 112, 112))


def _gpm_weight_block(part, w, h, wl, hl, hs, vs):
    """Host slice of the GPM weight plane for one block: [h, w] int32
    (wl/hl: LUMA block dims for the offset lookup; hs/vs: plane shifts)."""
    angle_idx, a2w, offx, offy, a2m, wmats = _gpm_tables()
    ai = int(angle_idx[part])
    wmat = wmats[int(a2w[ai])]
    wi = (wl.bit_length() - 1) - 3
    hi = (hl.bit_length() - 1) - 3
    off_x = int(offx[part][hi][wi])
    off_y = int(offy[part][hi][wi])
    mirror = int(a2m[ai])
    WS = 112
    wys = np.arange(h) << vs
    wxs = np.arange(w) << hs
    if mirror == 0:
        rows, cols = off_y + wys, off_x + wxs
    elif mirror == 1:
        rows, cols = off_y + wys, WS - 1 - off_x - wxs
    else:
        rows, cols = WS - 1 - off_y - wys, off_x + wxs
    return wmat[np.ix_(rows, cols)].astype(np.int32)


def _mc_w_avg_batch(s0, s1, denom, w0, w1, o0, o1, bd: int):
    """Weighted bi-prediction (explicit WP / BCW): per-block params
    [B]; mirrors native mc_w_avg (vvc_mc.c)."""
    shift = (denom + max(3, 15 - bd))[:, None, None].to(I64)
    off = (((o0 + o1) << (bd - 8)) + 1).to(I64)[:, None, None] << (shift - 1)
    v = (s0.to(I64) * w0[:, None, None] +
         s1.to(I64) * w1[:, None, None] + off) >> shift
    return v.clamp(0, (1 << bd) - 1).to(I32)


def _mc_uni_w_batch(val, denom, wx, ox, bd: int):
    """Weighted uni-prediction: per-block params [B]; mirrors native
    mc_uni_out weighted branch (vvc_mc.c)."""
    shift = (denom + 14 - bd)[:, None, None].to(I64)
    off = torch.ones_like(shift) << (shift - 1)   # shift >= 2 for bd <= 12
    v = ((val.to(I64) * wx[:, None, None] + off) >> shift) + \
        (ox.to(I64) << (bd - 8))[:, None, None]
    return v.clamp(0, (1 << bd) - 1).to(I32)


def _put_bucket(ref, prm, w, h, is_luma, bd, hf_idx, vf_idx, fclass, wrap,
                boxed):
    """One put bucket in plain PyTorch: ref [H, W] int32, prm [B, 4 or 8]
    int32 = (x, y, frac_x, frac_y[, box x0, x1, y0, y1]) per block."""
    lf, cf = _filter_banks(str(ref.device))
    bank = lf[hf_idx] if is_luma else cf[hf_idx]
    bankv = lf[vf_idx] if is_luma else cf[vf_idx]
    stats["launches"] += 1
    return _mc_put_math(ref, prm[:, 0], prm[:, 1], bank[prm[:, 2].to(I64)],
                        bankv[prm[:, 3].to(I64)], prm[:, 4:8] if boxed
                        else None, int(w), int(h), bool(is_luma), int(bd),
                        int(fclass), int(wrap), boxed)


# ---- the put table: every put of a call in one launch -----------------------

TILE = 16          # the largest side of an output tile of csrc/mc.cu
THREADS = 256      # the threads of one of its CUDA blocks
HALO = 7           # the luma filter's taps - 1
PLANE_COLS, CLASS_COLS, JOB_COLS = 4, 10, 8
SMEM_LIMIT = 48 * 1024   # dynamic shared memory a block gets unasked


class PutTable:
    """The puts of one call, an int32 row a block, in the layout that
    `mc_put_kernel` (csrc/mc.cu) reads.

    jobs [N, 8]: x, y, frac_x | frac_y << 8, plane | luma << 16 | fclass
    << 17 | hf << 19 | vf << 21 | boxed << 23, wrap, box x0 | x1 << 16, box
    y0 | y1 << 16, and the offset of the block's h x w outputs (row by row)
    in the call's int32 buffer.  A box is clipped into its plane, which
    leaves the clamp of every sample as it was.  The rows are ordered by
    block size, so that each size's outputs lie together: `runs` holds
    (w, h, first row, rows) of each size in that order."""

    def __init__(self, jobs, runs):
        self.jobs, self.runs = jobs, runs
        self.n_out = int(jobs[-1, 7]) + runs[-1][0] * runs[-1][1] \
            if len(jobs) else 0

    def part(self, lo, hi):
        """Rows [lo, hi) as a table of their own, offsets from 0: its
        outputs are those from jobs[lo, 7] on in this one's buffer."""
        jobs = self.jobs[lo:hi].copy()
        jobs[:, 7] -= self.jobs[lo, 7]
        runs = [(w, h, max(j0, lo) - lo, min(j0 + n, hi) - max(j0, lo))
                for w, h, j0, n in self.runs if j0 < hi and j0 + n > lo]
        return PutTable(jobs, runs)

    def layout(self):
        """The kernel's classes [C, 10], one a size (w, h, the output tile
        tw x th, tiles across, tiles a row, units a CUDA block, first
        row, rows, first CUDA block), the number of CUDA blocks and the
        dynamic shared memory one needs: a window of (th + 7) x (tw + 7)
        int16 samples (an even number) and (th + 7) x tw int32 of the
        horizontal pass a unit."""
        rows, blocks, smem = [], 0, 0
        for w, h, j0, n in self.runs:
            tx, ty = -(-w // TILE), -(-h // TILE)
            tw, th = -(-w // tx), -(-h // ty)
            upb = THREADS // (tw * th)
            rows.append((w, h, tw, th, tx, tx * ty, upb, j0, n, blocks))
            blocks += -(-n * tx * ty // upb)
            win = ((th + HALO) * (tw + HALO) + 1) & ~1
            smem = max(smem, upb * (2 * win + 4 * (th + HALO) * tw))
        return np.array(rows, np.int32).reshape(-1, CLASS_COLS), blocks, smem

    def packed(self, planes, classes):
        """The one int32 array that goes up: planes [P, 4] (the device
        address in two words, W, H; zeros for None), classes, jobs."""
        head = np.zeros((len(planes), PLANE_COLS), np.int32)
        for k, p in enumerate(planes):
            if p is not None:
                head[k, :2] = np.array([p.data_ptr()], np.uint64).view(
                    np.int32)
                head[k, 2:] = p.shape[1], p.shape[0]
        return np.concatenate([head.ravel(), classes.ravel(),
                               self.jobs.ravel()])


def put_table_of(buckets):
    """The put table of `buckets`: [(plane index, (H, W) of the plane, rows
    [B, 4 or 8] of (x, y, frac_x, frac_y[, box x0, x1, y0, y1]), w, h,
    is_luma, hf_idx, vf_idx, fclass, wrap, boxed)].  Returns it and, for
    each bucket, ((w, h), the index of its first block among its size's)."""
    order = sorted(range(len(buckets)), key=lambda i: buckets[i][3:5])
    attrs = []            # per bucket in order: flags, wrap, area, W, H
    first = [((b[3], b[4]), 0) for b in buckets]
    runs = []
    lo = 0
    for i in order:
        k, (H, W), rows, w, h, luma, hf, vf, fclass, wrap, box = buckets[i]
        m = len(rows)
        attrs.append((int(k) | int(luma) << 16 | int(fclass) << 17 |
                      int(hf) << 19 | int(vf) << 21 | int(box) << 23, wrap,
                      w * h, W, H, m))
        if not m:
            continue
        if runs and runs[-1][:2] == [w, h]:
            runs[-1][3] += m
        else:
            runs.append([w, h, lo, m])
        first[i] = ((w, h), lo - runs[-1][2])
        lo += m
    A = np.array(attrs, np.int64).reshape(-1, 6)
    counts = A[:, 5]
    jobs = np.zeros((lo, JOB_COLS), np.int32)
    jobs[:, 3] = np.repeat(A[:, 0], counts)
    jobs[:, 4] = np.repeat(A[:, 1], counts)
    area = np.repeat(A[:, 2], counts)
    end = np.cumsum(area)
    if lo and end[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"put table: {end[-1]} outputs overflow int32")
    jobs[:, 7] = end - area
    # the rows, unboxed and boxed apart, each converted in one pass
    boxed = (A[:, 0] >> 23 & 1).astype(bool)
    at = np.repeat(boxed, counts) if boxed.any() else slice(None)
    for sel, cols in ((False, 4), (True, 8)):
        seq = [buckets[i][2] for i, b in zip(order, boxed) if b == sel]
        m = int(counts[boxed == sel].sum())
        if not m:
            continue
        prm = np.fromiter(
            itertools.chain.from_iterable(itertools.chain.from_iterable(seq)),
            np.int32, m * cols).reshape(m, cols)
        rows = (~at if sel is False else at) if boxed.any() else at
        jobs[rows, 0:2] = prm[:, 0:2]
        jobs[rows, 2] = prm[:, 2] | prm[:, 3] << 8
        if sel:
            lim = np.repeat(A[boxed, 3:5] - 1, counts[boxed], axis=0)
            bx = np.clip(prm[:, 4:6], 0, lim[:, 0:1])
            by = np.clip(prm[:, 6:8], 0, lim[:, 1:2])
            jobs[rows, 5] = bx[:, 0] | bx[:, 1] << 16
            jobs[rows, 6] = by[:, 0] | by[:, 1] << 16
    return PutTable(jobs, [tuple(r) for r in runs]), first


def put_table_ref(planes, table, bd):
    """The plain twin of `mc_put_kernel`: the rows of `table` grouped back
    into buckets by (size, plane and flags, wrap), each through
    `_put_bucket`, its outputs written at their offsets.  Runs on the
    planes' device (int16 or int32 [H, W]; None where the table reads
    none); returns int32 [table.n_out]."""
    dev = one_device("put_table_ref", planes)
    out = torch.empty(table.n_out, dtype=I32, device=dev)
    jobs = table.jobs
    if not len(jobs):
        return out
    size = np.repeat(np.array([r[:2] for r in table.runs], np.int64),
                     [r[3] for r in table.runs], axis=0)
    groups, inv = np.unique(np.concatenate([size, jobs[:, 3:5]], 1),
                            axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    wide = {}
    for (w, h, flags, wrap), rows in zip(
            groups.tolist(), np.split(order, np.cumsum(np.bincount(inv))[:-1])):
        j = jobs[rows]
        k = flags & 0xFFFF
        if k not in wide:
            wide[k] = planes[k].to(I32)
        prm = np.stack([j[:, 0], j[:, 1], j[:, 2] & 0xFF, j[:, 2] >> 8 & 0xFF,
                        j[:, 5] & 0xFFFF, j[:, 5] >> 16 & 0xFFFF,
                        j[:, 6] & 0xFFFF, j[:, 6] >> 16 & 0xFFFF], 1)
        v = _put_bucket(wide[k], torch.from_numpy(prm).to(dev), w, h,
                        bool(flags >> 16 & 1), bd, flags >> 19 & 3,
                        flags >> 21 & 3, flags >> 17 & 3, wrap,
                        bool(flags >> 23 & 1))
        at = j[:, 7:8].astype(np.int64) + np.arange(w * h)
        out[torch.from_numpy(at.reshape(-1)).to(dev)] = v.reshape(-1)
    return out


@counted
def put_table(planes, table, bd):
    """Every put of `table` into one new int32 buffer [table.n_out].

    planes: the call's reference planes, int16 [H, W] tensors on one device
    (None where the table reads none), indexed by the rows' plane field.
    The table goes up as one int32 array (`PutTable.packed`), counted on
    the CPU too, so that up_bytes is what a card takes whichever device
    runs the puts.  On CUDA tensors one launch of `mc_put_kernel`
    (csrc/mc.cu) computes every row; on CPU tensors `put_table_ref` does
    (`device.kernel_device`)."""
    dev = kernel_device("put_table", planes, ())
    classes, blocks, smem = table.layout()
    tab = upload(table.packed(planes, classes), dev, stats)
    if dev.type == "cpu":
        return put_table_ref(planes, table, bd)
    if any(p is not None and p.dim() != 2 for p in planes):
        raise ValueError("put_table: [H, W] planes expected")
    if not 8 <= bd <= 12 or smem > SMEM_LIMIT:
        raise ValueError(f"put_table: bit depth {bd}, {smem} bytes of "
                         "shared memory")
    if len(table.jobs) and int((table.jobs[:, 3] & 0xFFFF).max()) >= \
            len(planes):
        raise ValueError("put_table: a row names a plane it was not given")
    out = torch.empty(table.n_out, dtype=I32, device=dev)
    if blocks:
        stats["launches"] += 1
        run(put_table, "ffvvc_mc_put", dev,
            *put_args(tab, len(planes), classes, blocks, smem, out, bd))
    return out


def put_args(tab, n_planes, classes, blocks, smem, out, bd):
    """The put kernel's launcher arguments, before the stream, for the
    packed table `tab` (a CUDA tensor) and the output buffer `out`."""
    lf, cf = _filter_banks(str(out.device))
    at = tab.data_ptr() + 4 * PLANE_COLS * n_planes
    return (tab.data_ptr(), at, len(classes), at + 4 * classes.size,
            lf.data_ptr(), cf.data_ptr(), out.data_ptr(), blocks, smem, bd)


# mesh-sharded puts: the rows of a call's put table partition over the
# "tile" mesh axis (the reference planes a part reads copied to its device,
# which computes its rows), the outputs come back into the call's buffer.
# The form of the reference's per-CTU inter tasks running on every worker
# (vvc_thread.c:432-450).
sharded_puts = 0      # tables split (tests assert engagement)
# bytes of reference plane copied to each other device for a split table
# ({str(device): bytes}; none when a tile's device is the planes' own)
sharded_ref_bytes = {}


def _put_sharded(planes, table, mesh, bd):
    """`put_table` with the table's rows split over the mesh's "tile"
    devices (gop row 0) when it has at least as many rows as tiles; the
    outputs come back to the planes' device in row order."""
    global sharded_puts
    t = mesh.shape["tile"] if mesh is not None else 1
    n = len(table.jobs)
    if mesh is None or n < t:
        return put_table(planes, table, bd)
    dev = one_device("put_table", planes)
    out = torch.empty(table.n_out, dtype=I32, device=dev)
    for i, rows in enumerate(np.array_split(np.arange(n), t)):
        lo, hi = int(rows[0]), int(rows[-1]) + 1
        part = table.part(lo, hi)
        there = mesh.device(0, i)
        sent = [None] * len(planes)
        for k in np.unique(part.jobs[:, 3] & 0xFFFF).tolist():
            sent[k] = planes[k].to(there)
            if sent[k] is not planes[k]:
                key = str(sent[k].device)
                sharded_ref_bytes[key] = sharded_ref_bytes.get(key, 0) + \
                    planes[k].nbytes
        at = int(table.jobs[lo, 7])
        out[at:at + part.n_out] = put_table(sent, part, bd).to(dev)
    sharded_puts += 1
    return out


def mc_put_batch(ref_plane, xs, ys, frac_x, frac_y, w, h, is_luma, bd,
                 hf_idx=0, vf_idx=0, wrap=0, box=None, device="cuda",
                 mesh=None):
    """Host-facing batched put for one (w, h, frac-class) bucket.

    ref_plane: [H, W] samples (at most 12 bits); xs/ys/frac_x/frac_y: np
    arrays [B].  All blocks in a call share bool(frac_x) / bool(frac_y)
    (the caller buckets by frac-class); per-block fractional phases may
    differ.  box: optional [B, 4] inclusive clamp boxes (DMVR prefetch
    windows).  mesh: optional mesh (`parallel/mesh.py`) — the batch
    partitions across its "tile" devices when it has at least as many
    blocks.  Runs through `put_table` as a one-bucket table.  Returns
    np.int32 [B, h, w] (14-bit domain)."""
    dev = torch.device(device)
    frac_x, frac_y = np.asarray(frac_x), np.asarray(frac_y)
    fclass = (1 if frac_x.any() else 0) | (2 if frac_y.any() else 0)
    cols = [np.asarray(xs), np.asarray(ys), frac_x, frac_y]
    if box is not None:
        cols += list(np.asarray(box).reshape(len(cols[0]), 4).T)
    ref = upload(as_wire(ref_plane), dev, stats)
    table, _ = put_table_of([(0, ref.shape, np.stack(cols, axis=1), w, h,
                              is_luma, hf_idx, vf_idx, fclass, wrap,
                              box is not None)])
    out = _put_sharded([ref], table, mesh, int(bd))
    return download(out, stats).reshape(-1, h, w)


def mc_avg_batch(s0, s1, bd, device="cuda"):
    dev = torch.device(device)
    s0, s1 = (upload(np.asarray(s, np.int32), dev, stats) for s in (s0, s1))
    return download(_mc_avg_batch(s0, s1, int(bd)), stats)


def mc_uni_batch(val, bd, device="cuda"):
    val = upload(np.asarray(val, np.int32), torch.device(device), stats)
    return download(_mc_uni_batch(val, int(bd)), stats)


# ---- decoder-side batched dispatch (ops/itx.py cost-dispatch analogue) -----

PF_L0, PF_L1, PF_BI = 1, 2, 3


class _Planes:
    """Reference planes on the device for the length of one
    frame_device_mc call: each goes up once, as 16-bit samples, whatever
    the number of puts that read it; `wire` holds them in the order of
    first use, which is the put table's plane index."""

    def __init__(self, dev):
        self.dev = dev
        self.wire = []
        self.at = {}          # id(host plane) -> index into wire
        self.wide = {}        # index -> int32 copy (the DMVR prefetch)

    def index(self, plane):
        k = self.at.get(id(plane))
        if k is None:
            k = self.at[id(plane)] = len(self.wire)
            self.wire.append(upload(as_wire(plane), self.dev, stats))
        return k

    def __call__(self, plane):
        """The plane as int32 samples, for the DMVR prefetch's buckets."""
        k = self.index(plane)
        if k not in self.wide:
            self.wide[k] = self.wire[k].to(I32)
        return self.wide[k]


class _Flat:
    """The outputs of all buckets of one block size as one tensor
    [N, h, w], so that a later batch picks its blocks with one index
    tensor: slot (bucket key, i) lies at base[key] + i of flat[(w, h)]."""

    def __init__(self, vals, size_of):
        groups = {}
        for key in vals:
            groups.setdefault(size_of(key), []).append(key)
        self.flat, self.base, self.size = {}, {}, {}
        for size, keys in groups.items():
            n = 0
            for key in keys:
                self.base[key], self.size[key] = n, size
                n += vals[key].shape[0]
            self.flat[size] = vals[keys[0]] if len(keys) == 1 else \
                torch.cat([vals[k] for k in keys])

    @classmethod
    def of_table(cls, buf, table, first):
        """The outputs of a put table's buffer: each size's rows are a view
        of `buf`; first[key] is ((w, h), index of the first block among its
        size's) of bucket key (`put_table_of`)."""
        self = cls({}, None)
        self.base = {key: i for key, (_, i) in first.items()}
        self.size = {key: size for key, (size, _) in first.items()}
        for w, h, j0, n in table.runs:
            at = int(table.jobs[j0, 7])
            self.flat[(w, h)] = buf[at:at + n * w * h].view(n, h, w)
        return self

    def index(self, slots, dev):
        """Slots of one size -> (that size's tensor, their positions)."""
        size = self.size[slots[0][0]]
        idx = upload(np.fromiter((self.base[k] + i for k, i in slots),
                                 np.int64, len(slots)), dev, stats)
        return self.flat[size], idx

    def take(self, slots, dev):
        flat, idx = self.index(slots, dev)
        return flat[idx]


def _dmvr_phase(D, rpls, bd, planes):
    """Phase A of DMVR descriptors: batched bilinear prefetch pairs +
    25-point SAD refinement (ops/inter_device._dmvr_refine).
    Returns {(di, sby, sbx): (mv0, mv1, skip_bdof)} with the refined,
    +/-clipped subblock MVs (native dmvr_refine)."""
    dev = planes.dev
    dfilt = _dmvr_filters()
    buckets = {}        # (id(plane), pw, ph, mclass, wrap) -> lists
    slots = {}          # (di, sby, sbx, hyp) -> (bkey, idx)
    subs = []           # (di, sby, sbx, sbw, sbh, mvs)
    for di in np.nonzero((D[:, 13] & 64) != 0)[0]:
        di = int(di)
        x0, y0, w, h = (int(v) for v in D[di, :4])
        packed = int(D[di, 4])
        wrap = int(D[di, 14])
        nsbx, nsby = (packed >> 4) & 63, (packed >> 10) & 63
        sbw, sbh = w // nsbx, h // nsby
        rpl = rpls[int(D[di, 12])]
        refs = (int(D[di, 5]), int(D[di, 6]))
        mvs = ((int(D[di, 7]), int(D[di, 8])),
               (int(D[di, 9]), int(D[di, 10])))
        for sby in range(nsby):
            for sbx in range(nsbx):
                x = x0 + sbx * sbw
                y = y0 + sby * sbh
                subs.append((di, sby, sbx, sbw, sbh, mvs))
                for i in range(2):
                    plane = rpl[i].frames[refs[i]].buffer.planes[0]
                    mvx, mvy = mvs[i]
                    mx, my = mvx & 15, mvy & 15
                    key = (id(plane), sbw + 4, sbh + 4,
                           (1 if mx else 0) | (2 if my else 0), wrap)
                    b = buckets.get(key)
                    if b is None:
                        b = buckets[key] = {"plane": plane, "prm": []}
                    b["prm"].append((x + (mvx >> 4) - 2, y + (mvy >> 4) - 2,
                                     *dfilt[mx], *dfilt[my]))
                    slots[(di, sby, sbx, i)] = (key, len(b["prm"]) - 1)
    vals = {}
    for key, b in buckets.items():
        _pid, pw, ph, mclass, wrap = key
        prm = upload(np.asarray(b["prm"], np.int32), dev, stats)   # [B, 6]
        vals[key] = _dmvr_bilin_batch(
            planes(b["plane"]), prm[:, 0], prm[:, 1], prm[:, 2:4],
            prm[:, 4:6], pw, ph, int(bd), mclass, wrap)
        stats["bilin_buckets"] += 1
        stats["launches"] += 1
    flat = _Flat(vals, lambda key: (key[1], key[2]))
    by_size = {}
    for di, sby, sbx, sbw, sbh, mvs in subs:
        by_size.setdefault((sbw, sbh), []).append((di, sby, sbx, mvs))
    refined = []
    for (sbw, sbh), items in by_size.items():
        t0 = flat.take([slots[(di, sby, sbx, 0)]
                        for di, sby, sbx, _ in items], dev)
        t1 = flat.take([slots[(di, sby, sbx, 1)]
                        for di, sby, sbx, _ in items], dev)
        dmv, skip = _dmvr_refine(t0, t1, sbw, sbh)
        stats["launches"] += 1
        stats["dmvr_subblocks"] += len(items)
        refined.append((items, dmv, skip))
    # every size's refinement is queued before the first download waits
    with trace.span("mc.download"):
        refined = [(items, download(dmv, stats), download(skip, stats))
                   for items, dmv, skip in refined]
    out = {}
    lim = 1 << 17
    for items, dmv, skip in refined:
        for j, (di, sby, sbx, mvs) in enumerate(items):
            dx, dy = int(dmv[j, 0]), int(dmv[j, 1])
            if dx or dy:
                mv0 = (min(max(mvs[0][0] + dx, -lim), lim - 1),
                       min(max(mvs[0][1] + dy, -lim), lim - 1))
                mv1 = (min(max(mvs[1][0] - dx, -lim), lim - 1),
                       min(max(mvs[1][1] - dy, -lim), lim - 1))
            else:
                mv0, mv1 = mvs
            out[(di, sby, sbx)] = (mv0, mv1, bool(skip[j]))
    return out


def _expand_dmvr_bdof(d, di, rpl, native_jobs, nc, hs, vs, add_put,
                      entries, refined, pic_w, pic_h):
    """Expand a DMVR/BDOF descriptor: per-subblock box-clamped puts with
    the refined MVs (native luma_bi/chroma_bi has_box path), BDOF ring
    gathers where the per-subblock gate holds, plain-average finals
    (DMVR/BDOF imply no weights), and the refined-MV writeback to the
    TMVP col grids (native set_dmvr_info)."""
    (x0, y0, w, h, packed, r0_, r1_, mx0, my0, mx1, my1, hpel, tag,
     flags2, wrap, _wm) = (int(v) for v in d[:16])
    dmvr = bool(flags2 & 64)
    bdof = bool(flags2 & 128)
    nsbx, nsby = (packed >> 4) & 63, (packed >> 10) & 63
    sbw, sbh = w // nsbx, h // nsby
    refs = (r0_, r1_)
    orig = ((mx0, my0), (mx1, my1))
    lm = bool(flags2 & 1)
    nr = native_jobs[tag][0]
    tabs = nr.tabs
    for sby in range(nsby):
        for sbx in range(nsbx):
            x = x0 + sbx * sbw
            y = y0 + sby * sbh
            if dmvr:
                mv0, mv1, skip = refined[(di, sby, sbx)]
                sb_bdof = bdof and not skip
                # set_dmvr_info: refined MVs -> TMVP col grids
                ya, xa = y >> 2, x >> 2
                y1, x1 = (y + sbh) >> 2, (x + sbw) >> 2
                tabs.col_pf[ya:y1, xa:x1] = 3            # PF_BI
                for lx, mv in ((0, mv0), (1, mv1)):
                    tabs.col_mv[lx, ya:y1, xa:x1] = mv
                    tabs.col_ref[lx, ya:y1, xa:x1] = refs[lx]
            else:
                mv0, mv1, sb_bdof = orig[0], orig[1], bdof
            mvs = (mv0, mv1)
            slots = []
            rings = []
            for i in range(2):
                ref = rpl[i].frames[refs[i]].buffer.planes[0]
                mvx, mvy = mvs[i]
                fx, fy = mvx & 15, mvy & 15
                xi, yi = x + (mvx >> 4), y + (mvy >> 4)
                box = _dmvr_box(x + (orig[i][0] >> 4),
                                y + (orig[i][1] >> 4), sbw, sbh, True,
                                pic_w, pic_h) if dmvr else None
                slots.append(add_put(ref, xi, yi, fx, fy, sbw, sbh, True,
                                     hpel, wrap, box))
                if sb_bdof:
                    rings.append(add_put(
                        ref, xi + (fx >> 3) - 1, yi + (fy >> 3) - 1, 0, 0,
                        sbw + 2, sbh + 2, True, 0, wrap, box))
            wp = ("bdof", rings[0], rings[1]) if sb_bdof else None
            entries.append((tag, 0, x, y, sbw, sbh, slots, wp, lm))
            if nc == 1:
                continue
            for c in (1, 2):
                cslots = []
                for i in range(2):
                    ref = rpl[i].frames[refs[i]].buffer.planes[c]
                    mvx, mvy = mvs[i]
                    cfx = (mvx & ((1 << (4 + hs)) - 1)) << (1 - hs)
                    cfy = (mvy & ((1 << (4 + vs)) - 1)) << (1 - vs)
                    xi = (x >> hs) + (mvx >> (4 + hs))
                    yi = (y >> vs) + (mvy >> (4 + vs))
                    box = _dmvr_box(
                        (x >> hs) + (orig[i][0] >> (4 + hs)),
                        (y >> vs) + (orig[i][1] >> (4 + vs)),
                        sbw >> hs, sbh >> vs, False,
                        pic_w >> hs, pic_h >> vs) if dmvr else None
                    cslots.append(add_put(ref, xi, yi, cfx, cfy,
                                          sbw >> hs, sbh >> vs, False, 0,
                                          wrap >> hs, box))
                entries.append((tag, c, x >> hs, y >> vs, sbw >> hs,
                                sbh >> vs, cslots, None, False))


def _expand_subblocks(d, rpl, native_jobs, nc, hs, vs, add_put, entries,
                      prof_jobs):
    """Expand an affine / subblock-grid descriptor into per-subblock put
    slots + finals entries, mirroring native pred_affine_blk /
    pred_regular_blk's nsb walk: luma per subblock (affine: the type-2
    filter and optional PROF refinement; grid: the stored hpel filter),
    chroma per subblock (grid) or per 2x2-group with the spec's averaged
    MV (affine)."""
    (x0, y0, w, h, packed, r0_, r1_, _m7, _m8, _m9, _m10, hpel0, tag,
     flags2, wrap, wmask) = (int(v) for v in d[:16])
    affine = bool(flags2 & 4)
    nsbx, nsby = (packed >> 4) & 63, (packed >> 10) & 63
    sbw, sbh = w // nsbx, h // nsby
    prof = ((flags2 >> 4) & 1, (flags2 >> 5) & 1)
    nr = native_jobs[tag][0]
    tabs = nr.tabs
    lm = bool(flags2 & 1)
    cu_pf = packed & 3
    dm = {}
    if affine:
        cy0, cx0 = y0 >> 2, x0 >> 2
        num_cp = int(tabs.mmi[cy0, cx0]) + 1
        for lx in range(2):
            if prof[lx] and (cu_pf & (lx + 1)):
                dm[lx] = _affine_diff_mvs(tabs.cp_mv[lx, cy0, cx0],
                                          num_cp, w, h)

    def wparams(c):
        return tuple(int(v) for v in d[16 + 5 * c:21 + 5 * c]) \
            if (wmask >> c) & 1 else None

    def luma_put(lx, mv, ref_i, x, y, with_prof, hf):
        ref = rpl[lx].frames[ref_i].buffer.planes[0]
        mvx, mvy = int(mv[0]), int(mv[1])
        fx, fy = mvx & 15, mvy & 15
        xi, yi = x + (mvx >> 4), y + (mvy >> 4)
        slot = add_put(ref, xi, yi, fx, fy, sbw, sbh, True, hf, wrap)
        if with_prof:
            # 6x6 integer-sample ring: an fclass-0 put (<< (14-bd))
            ring = add_put(ref, xi + (fx >> 3) - 1, yi + (fy >> 3) - 1,
                           0, 0, 6, 6, True, 0, wrap)
            dx, dy = dm[lx]
            prof_jobs.append((slot, ring, dx, dy))
        return slot

    def chroma_put(c, lx, mv, ref_i, xc, yc, wc, hc):
        ref = rpl[lx].frames[ref_i].buffer.planes[c]
        mvx, mvy = int(mv[0]), int(mv[1])
        fx = (mvx & ((1 << (4 + hs)) - 1)) << (1 - hs)
        fy = (mvy & ((1 << (4 + vs)) - 1)) << (1 - vs)
        xi = xc + (mvx >> (4 + hs))
        yi = yc + (mvy >> (4 + vs))
        return add_put(ref, xi, yi, fx, fy, wc, hc, False, 0, wrap >> hs)

    for sby in range(nsby):
        for sbx in range(nsbx):
            x = x0 + sbx * sbw
            y = y0 + sby * sbh
            cy, cx = y >> 2, x >> 2
            spf = int(tabs.mvf_pf[cy, cx])
            hyps = [lx for lx in (0, 1) if spf & (lx + 1)]
            hf = 2 if affine else int(tabs.mvf_hpel[cy, cx])
            if not hyps:
                continue
            slots = [
                luma_put(lx, tabs.mvf_mv[lx, cy, cx],
                         int(tabs.mvf_ref[lx, cy, cx]), x, y,
                         affine and prof[lx], hf)
                for lx in hyps]
            entries.append((tag, 0, x, y, sbw, sbh, slots, wparams(0), lm))
            if nc == 1:
                continue
            if affine:
                # per 2x2 group (4:2:0): spec-averaged MV over the pair
                if (sby & vs) or (sbx & hs):
                    continue
                cy2 = (y + vs * sbh) >> 2
                cx2 = (x + hs * sbw) >> 2
                for c in (1, 2):
                    slots = []
                    for lx in hyps:
                        m = tabs.mvf_mv[lx, cy, cx].astype(np.int64) + \
                            tabs.mvf_mv[lx, cy2, cx2]
                        mvc = (m + 1 - (m >= 0)) >> 1
                        slots.append(chroma_put(
                            c, lx, mvc, int(tabs.mvf_ref[lx, cy, cx]),
                            x >> hs, y >> vs,
                            (sbw << hs) >> hs, (sbh << vs) >> vs))
                    entries.append((tag, c, x >> hs, y >> vs,
                                    (sbw << hs) >> hs, (sbh << vs) >> vs,
                                    slots, wparams(c), False))
            else:
                for c in (1, 2):
                    slots = [
                        chroma_put(c, lx, tabs.mvf_mv[lx, cy, cx],
                                   int(tabs.mvf_ref[lx, cy, cx]),
                                   x >> hs, y >> vs, sbw >> hs, sbh >> vs)
                        for lx in hyps]
                    entries.append((tag, c, x >> hs, y >> vs, sbw >> hs,
                                    sbh >> vs, slots, wparams(c), False))


def frame_device_mc(native_jobs, sps, bd, device="cuda", mesh=None):
    """Whole-frame batched device MC for the regular (non-subblock) blocks
    of every native inter job, including explicit-weighted-prediction /
    BCW finals, LMCS forward mapping, and horizontal wraparound; the blocks
    the descriptors do not carry (CIIP) run the host C path inside the same
    collect call (native/vvc_inter.c inter_ctus_dev; descriptor layout
    documented there).

    native_jobs: [(NativeRecon, ctus)].  Puts batch per (ref plane, size,
    filter class), split over the "tile" devices of `mesh` when one is
    given; the uni/bi/weighted finals batch per size.  A failure raises:
    nothing is handed back to the host MC."""
    with trace.span("mc"):
        _frame_mc(native_jobs, sps, bd, torch.device(device), mesh)


def _frame_mc(native_jobs, sps, bd, dev, mesh):
    stats["calls"] += 1
    descs = []
    rpls = []
    with trace.span("mc.collect"):
        for tag, (nr, ctus) in enumerate(native_jobs):
            d = nr.predict_inter_ctus_dev(ctus, tag)
            rpls.append(nr.rpl)
            if len(d):
                descs.append(d)
    if not descs:
        return
    D = np.concatenate(descs)
    stats["descriptors"] += len(D)
    nc = 3 if sps.chroma_format_idc else 1
    hs, vs = (sps.hshift[1], sps.vshift[1]) if nc > 1 else (0, 0)

    put_buckets = {}      # key -> dict(plane, prm rows, w, h, ...)
    entries = []          # (tag, c, xc, yc, wc, hc, slots, wparams, lmcs)
    prof_jobs = []        # (val_slot, ring_slot, dmx44, dmy44)
    pic_h, pic_w = native_jobs[0][0].fb.planes[0].shape
    planes = _Planes(dev)
    with trace.span("mc.dmvr"):
        dmvr_refined = _dmvr_phase(D, rpls, bd, planes) \
            if ((D[:, 13] & 64) != 0).any() else {}

    def add_put(plane, xi, yi, fx, fy, w, h, is_luma, hf_idx, wrap,
                box=None):
        # bucket by actual frac class so fclass is uniform per launch
        key = (id(plane), w, h, is_luma, hf_idx, bool(fx), bool(fy), wrap,
               box is not None)
        b = put_buckets.get(key)
        if b is None:
            b = put_buckets[key] = {"plane": plane, "prm": []}
        b["prm"].append((xi, yi, fx, fy) if box is None
                        else (xi, yi, fx, fy, *box))
        return (key, len(b["prm"]) - 1)

    with trace.span("mc.expand"):
        for di in range(len(D)):
            (x0, y0, w, h, pf, r0, r1, mx0, my0, mx1, my1, hpel, tag,
             flags2, wrap, wmask) = (int(v) for v in D[di, :16])
            rpl = rpls[tag]
            if flags2 & 2:
                # GPM: two uni hypotheses per plane + weight-plane blend
                lx0, lx1, part = (int(v) for v in D[di, 16:19])
                for c in range(nc):
                    chs, cvs = (0, 0) if c == 0 else (hs, vs)
                    wc, hc = w >> chs, h >> cvs
                    slots = []
                    for i, (lx, ref_i, mvx, mvy) in enumerate(
                            ((lx0, r0, mx0, my0), (lx1, r1, mx1, my1))):
                        ref = rpl[lx].frames[ref_i].buffer.planes[c]
                        if c == 0:
                            fx, fy = mvx & 15, mvy & 15
                            xi = x0 + (mvx >> 4)
                            yi = y0 + (mvy >> 4)
                        else:
                            fx = (mvx & ((1 << (4 + chs)) - 1)) << (1 - chs)
                            fy = (mvy & ((1 << (4 + cvs)) - 1)) << (1 - cvs)
                            xi = (x0 >> chs) + (mvx >> (4 + chs))
                            yi = (y0 >> cvs) + (mvy >> (4 + cvs))
                        slots.append(add_put(ref, xi, yi, fx, fy, wc, hc,
                                             c == 0, 0, wrap >> chs))
                    wgt = _gpm_weight_block(part, wc, hc, w, h, chs, cvs)
                    entries.append((tag, c, x0 >> chs, y0 >> cvs, wc, hc,
                                    slots, ("gpm", wgt),
                                    (flags2 & 1) and c == 0))
                continue
            if flags2 & 12:
                # affine (bit2) / subblock grid (bit3): expand per-subblock
                # MVs from the frame's mvf/cp_mv tab grids
                _expand_subblocks(
                    D[di], rpl, native_jobs, nc, hs, vs, add_put, entries,
                    prof_jobs)
                continue
            if flags2 & 192:
                # DMVR (bit6) / BDOF (bit7): refined MVs from phase A,
                # box-clamped puts + BDOF rings, col-grid writeback
                _expand_dmvr_bdof(
                    D[di], di, rpl, native_jobs, nc, hs, vs, add_put,
                    entries, dmvr_refined, pic_w, pic_h)
                continue
            hyps = [0] if pf == PF_L0 else [1] if pf == PF_L1 else [0, 1]
            for c in range(nc):
                chs, cvs = (0, 0) if c == 0 else (hs, vs)
                wc, hc = w >> chs, h >> cvs
                slots = []
                for lx in hyps:
                    ref = rpl[lx].frames[[r0, r1][lx]].buffer.planes[c]
                    mvx, mvy = (mx0, my0) if lx == 0 else (mx1, my1)
                    if c == 0:
                        fx, fy = mvx & 15, mvy & 15
                        xi = x0 + (mvx >> 4)
                        yi = y0 + (mvy >> 4)
                        hf_idx = hpel
                    else:
                        fx = (mvx & ((1 << (4 + chs)) - 1)) << (1 - chs)
                        fy = (mvy & ((1 << (4 + cvs)) - 1)) << (1 - cvs)
                        xi = (x0 >> chs) + (mvx >> (4 + chs))
                        yi = (y0 >> cvs) + (mvy >> (4 + cvs))
                        hf_idx = 0
                    slots.append(add_put(ref, xi, yi, fx, fy, wc, hc,
                                         c == 0, hf_idx, wrap >> chs))
                wparams = tuple(int(v) for v in D[di, 16 + 5 * c:21 + 5 * c]) \
                    if (wmask >> c) & 1 else None
                lm = (flags2 & 1) and c == 0
                entries.append((tag, c, x0 >> chs, y0 >> cvs, wc, hc, slots,
                                wparams, lm))

    with trace.span("mc.put"):
        # one table of every put, one launch (per "tile" device on a mesh)
        buckets = []
        for key, b in put_buckets.items():
            _pid, w, h, is_luma, hf_idx, has_fx, has_fy, wrap, boxed = key
            fclass = (1 if has_fx else 0) | (2 if has_fy else 0)
            k = planes.index(b["plane"])
            buckets.append((k, planes.wire[k].shape, b["prm"], w, h, is_luma,
                            hf_idx, hf_idx, fclass, wrap, boxed))
            stats["put_buckets"] += 1
            stats["put_blocks"] += len(b["prm"])
            stats["put_class"][fclass] += 1
        table, first = put_table_of(buckets)
        flat = _Flat.of_table(_put_sharded(planes.wire, table, mesh, int(bd)),
                              table, dict(zip(put_buckets, first)))

        if prof_jobs:
            # batched PROF refinement overrides the affine put slots
            puts, at = flat.index([s for s, _, _, _ in prof_jobs], dev)
            puts[at] = _prof_apply_batch(
                puts[at], flat.take([r for _, r, _, _ in prof_jobs], dev),
                upload(np.stack([j[2] for j in prof_jobs]), dev, stats),
                upload(np.stack([j[3] for j in prof_jobs]), dev, stats),
                int(bd))
            stats["prof_blocks"] += len(prof_jobs)
            stats["launches"] += 1

    # finals: batch uni/bi/weighted combines per (size, kind); every
    # bucket is queued before the first download waits
    with trace.span("mc.finals"):
        finals = {}   # (w, h, kind) -> (slots0, slots1, wparams, writebacks)
        for tag, c, xc, yc, wc, hc, slots, wp, lm in entries:
            dstplane = native_jobs[tag][0].fb.planes[c]
            wb = (dstplane, xc, yc,
                  getattr(native_jobs[tag][0], "lmcs_fwd_np", None)
                  if lm else None)
            if len(slots) == 1:
                kind = "uni_w" if wp else "uni"
            elif isinstance(wp, tuple) and wp[0] in ("gpm", "bdof"):
                kind = wp[0]
            else:
                kind = "bi_w" if wp else "bi"
            f = finals.setdefault((wc, hc, kind), ([], [], [], []))
            f[0].append(slots[0])
            if len(slots) > 1:
                f[1].append(slots[1])
            f[2].append(wp)
            f[3].append(wb)

        outs = []
        for (wc, hc, kind), (sl0, sl1, wps, wbs) in finals.items():
            s0 = flat.take(sl0, dev)
            s1 = flat.take(sl1, dev) if sl1 else None
            if kind == "bi":
                out = _mc_avg_batch(s0, s1, int(bd))
            elif kind == "uni":
                out = _mc_uni_batch(s0, int(bd))
            elif kind == "gpm":
                out = _mc_gpm_batch(
                    s0, s1,
                    upload(np.stack([wgt for _, wgt in wps]), dev, stats),
                    int(bd))
                stats["gpm_blocks"] += len(wps)
            elif kind == "bdof":
                out = _bdof_full_batch(
                    s0, s1, flat.take([r0 for _, r0, _ in wps], dev),
                    flat.take([r1 for _, _, r1 in wps], dev), wc, hc,
                    int(bd))
                stats["bdof_blocks"] += len(wps)
            else:                      # weighted: (denom, w0, w1, o0, o1)
                wa = upload(np.asarray(wps, np.int32), dev, stats)
                stats["weighted_blocks"] += len(wps)
                if kind == "bi_w":
                    out = _mc_w_avg_batch(s0, s1,
                                          *(wa[:, i] for i in range(5)),
                                          int(bd))
                else:
                    out = _mc_uni_w_batch(s0, wa[:, 0], wa[:, 1], wa[:, 3],
                                          int(bd))
            stats["finals_buckets"] += 1
            stats["launches"] += 1
            outs.append(out.to(torch.int16))    # pixels: at most 12 bits
        with trace.span("mc.download"):
            outs = [download(out, stats) for out in outs]
    with trace.span("mc.writeback"):
        for ((wc, hc, _), (_, _, _, wbs)), out in zip(finals.items(), outs):
            for i, (plane, xc, yc, lut) in enumerate(wbs):
                blk = out[i]
                if lut is not None:
                    # LMCS forward mapping on the inter luma prediction
                    # (predict_inter, vvc_inter.c:888-891)
                    blk = lut[blk]
                plane[yc:yc + hc, xc:xc + wc] = blk
