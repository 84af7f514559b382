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
and SbTMVP subblock grids, and DMVR/BDOF in frame-batched phases: phase A
runs every DMVR subblock's bilinear prefetch + 25-point SAD refine as
batched calls (ops/inter_device), then the refined MVs feed box-clamped
puts, batched per-4x4 BDOF solves and the TMVP col-grid writeback (the
reference interleaves these per CTU inside the inter task,
vvc_inter.c:642-760; hoisting the refine to a frame phase is what makes it
batchable).  Every per-block step on the host is C: one `mc_walk` a call
(native/vvc_inter.c) expands the descriptors, subblock MVs from the
frame's mvf/cp_mv grids, into the put rows, the finals entries and PROF's
rows, and writes the refined MVs to the col grids; one `mc_writeback`
copies the finals' pixels into the planes.  Python keeps what runs once a
size or kind: uploads, launches and the download.

The puts of one `frame_device_mc` call go to the device as one table
(`PutTable`: an int32 row a block, ordered by block size) and run as one
launch of the hand-written `mc_put_kernel` (csrc/mc.cu) on CUDA tensors
(`put_table`); on CPU tensors `put_table_ref` groups the rows back into
buckets and runs `_mc_put_math`, the kernel's plain twin.  Every output
lands in one int32 buffer, each block size's outputs together, which PROF,
the BDOF rings and the finals read as [N, h, w] views (`_by_size`).

What stays on the device within one `frame_device_mc` call: each reference
plane (uploaded once, as 16-bit samples), every put output through PROF
and the finals; the finals come down once, as 16-bit pixels.
Integer width: int32, and int64 where the golden model needs it (GPM and
the weighted finals).

On a mesh (`parallel/mesh.py`) the rows of a call's put table split over
the "tile" axis: each part goes to its device with the reference planes it
reads, and the outputs come back into the call's buffer in order
(`sharded_puts`; the planes' bytes each other device received:
`sharded_ref_bytes`).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..native import recon as _native
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
# hv).  `walked` counts the descriptors `mc_walk` expanded (all of them).
# Where the time goes is in the spans of `frame_device_mc` (trace.py: `mc`
# and its phases `mc.collect` ... `mc.writeback`).
stats = Counters("calls", "descriptors", "walked", "put_buckets",
                 "put_blocks", "bilin_buckets", "dmvr_subblocks",
                 "bdof_blocks", "prof_blocks", "gpm_blocks", "weighted_blocks",
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
def _gpm_weight_planes():
    from . import data as D
    return np.asarray(D.tables()["gpm_weights"]).reshape(-1, 112, 112)


def _gpm_weights(ents, hs, vs):
    """GPM weight blocks [B, h, w] int32 in 0..8 of finals entries of one
    size (`mc_walk`'s rows: parameters weight plane, offsets x and y,
    mirror), sliced from the partition weight planes as native
    pred_gpm_blk reads them, chroma entries at the plane shifts hs/vs."""
    w, h = int(ents[0, 4]), int(ents[0, 5])
    plane, ox, oy, mirror = (ents[:, 10 + k, None] for k in range(4))
    chroma = ents[:, 1, None] > 0
    ys = np.arange(h)[None] << np.where(chroma, vs, 0)
    xs = np.arange(w)[None] << np.where(chroma, hs, 0)
    rows = np.where((mirror != 0) & (mirror != 1), 111 - oy - ys, oy + ys)
    cols = np.where(mirror == 1, 111 - ox - xs, ox + xs)
    return _gpm_weight_planes()[plane[:, :, None], rows[:, :, None],
                                cols[:, None, :]].astype(np.int32)


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

class _Planes:
    """Reference planes on the device for the length of one
    frame_device_mc call.  `index` numbers a host plane at its first
    sight (the put table's plane index); `load` uploads the planes of
    given indices once each, as 16-bit samples, whatever the number of
    puts that read them; `wire` holds the uploads by index (None where a
    plane was never loaded)."""

    def __init__(self, dev):
        self.dev = dev
        self.host, self.wire = [], []
        self.at = {}          # id(host plane) -> index
        self.wide = {}        # index -> int32 copy (the DMVR prefetch)

    def index(self, plane):
        k = self.at.get(id(plane))
        if k is None:
            k = self.at[id(plane)] = len(self.host)
            self.host.append(plane)
            self.wire.append(None)
        return k

    def load(self, ks):
        for k in ks:
            if self.wire[k] is None:
                self.wire[k] = upload(as_wire(self.host[k]), self.dev, stats)

    def __call__(self, plane):
        """The plane as int32 samples, for the DMVR prefetch's buckets."""
        k = self.index(plane)
        self.load([k])
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

    def take(self, slots, dev):
        """The outputs of `slots`, all of one size: [len(slots), h, w]."""
        idx = upload(np.fromiter((self.base[k] + i for k, i in slots),
                                 np.int64, len(slots)), dev, stats)
        return self.flat[self.size[slots[0][0]]][idx]


def _dmvr_phase(D, rpls, bd, planes):
    """Phase A of DMVR descriptors: batched bilinear prefetch pairs +
    25-point SAD refinement (ops/inter_device._dmvr_refine).  Returns the
    refined, +/-clipped MVs (native dmvr_refine) [S, 4] (mv0 x, y, mv1 x,
    y) and the BDOF skips [S], int32, one row a subblock of the DMVR
    descriptors in their order, each descriptor's in raster order."""
    dev = planes.dev
    dfilt = _dmvr_filters()
    buckets = {}        # (id(plane), pw, ph, mclass, wrap) -> lists
    slots = {}          # (subblock, hyp) -> (bkey, idx)
    subs = []           # (sbw, sbh, mvs) of each subblock
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
                j = len(subs)
                subs.append((sbw, sbh, mvs))
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
                    slots[(j, i)] = (key, len(b["prm"]) - 1)
    if not subs:
        return np.zeros((0, 4), np.int32), np.zeros(0, np.int32)
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
    for j, (sbw, sbh, _) in enumerate(subs):
        by_size.setdefault((sbw, sbh), []).append(j)
    refined = []
    for (sbw, sbh), items in by_size.items():
        t0 = flat.take([slots[(j, 0)] for j in items], dev)
        t1 = flat.take([slots[(j, 1)] for j in items], dev)
        dmv, skip = _dmvr_refine(t0, t1, sbw, sbh)
        stats["launches"] += 1
        stats["dmvr_subblocks"] += len(items)
        refined.append((items, dmv, skip))
    # every size's refinement is queued before the first download waits
    with trace.span("mc.download"):
        refined = [(items, download(dmv, stats), download(skip, stats))
                   for items, dmv, skip in refined]
    mv = np.array([m for _, _, m in subs], np.int64).reshape(-1, 4)
    dmv = np.zeros((len(subs), 2), np.int64)
    skip = np.zeros(len(subs), np.int32)
    for items, d, k in refined:
        dmv[items], skip[items] = d, k
    lim = 1 << 17
    moved = (dmv != 0).any(1, keepdims=True)
    mv = np.where(moved, np.clip(mv + np.concatenate([dmv, -dmv], 1), -lim,
                                 lim - 1), mv)
    return mv.astype(np.int32), skip


# ---- the walk: every descriptor of a call into put rows and finals ----------

# a finals entry's kind (native/vvc_inter.c WK_*)
K_UNI, K_UNI_W, K_BI, K_BI_W, K_GPM, K_BDOF = range(6)
WALK_ERRORS = {1: "an output array is too small",
               2: "no such reference plane", 3: "a value out of range",
               4: "out of memory",
               5: "the DMVR subblocks do not match the refined MVs"}


class Walk(NamedTuple):
    """What `mc_walk` makes of a call's descriptors: the put table, its
    groups [G, 5] (w, h, flags, wrap, rows; table order), the finals
    entries [E, 15] (tag, component, x, y, w, h, kind, LMCS flag, put row
    of each hypothesis or -1, five parameters) and PROF's rows [P, 34]
    (put row, ring row, dmx [16], dmy [16]): native/vvc_inter.c mc_walk."""
    table: PutTable
    groups: np.ndarray
    entries: np.ndarray
    prof: np.ndarray


def mc_walk(D, native_jobs, lut, dims, nc, hs, vs, refined):
    """One C walk (native/vvc_inter.c mc_walk, without the interpreter's
    lock) over the descriptors D of `native_jobs` (tag = index): the put
    rows, grouped and ordered as `PutTable` wants them, the finals
    entries, PROF's rows, and DMVR's refined MVs written to the jobs'
    collocated grids.  lut [tags, 2, 16, 3]: the plane index of each
    reference plane (tag, list, ref index, component), -1 for none; dims
    [P, 2]: each plane's (W, H); refined: `_dmvr_phase`'s arrays.
    Raises ValueError if the walk fails."""
    D = np.ascontiguousarray(D, np.int32)
    nsb = np.maximum((D[:, 4] >> 4 & 63) * (D[:, 4] >> 10 & 63), 1)
    nsb = int(nsb.sum())
    cap = 8 * nsb                        # puts: 4 luma and 4 chroma a block
    jobs = np.empty((cap, JOB_COLS), np.int32)
    groups = np.empty((cap, 5), np.int32)
    runs = np.empty((cap, 4), np.int32)
    ents = np.empty((3 * nsb, 15), np.int32)
    prof = np.empty((2 * nsb, 34), np.int32)
    counts = np.zeros(5, np.int32)
    ips = np.array([ctypes.addressof(nr.ip) for nr, _ in native_jobs],
                   np.int64)
    mmis = np.array([nr.tabs.mmi.ctypes.data for nr, _ in native_jobs],
                    np.int64)
    lut = np.ascontiguousarray(lut, np.int32)
    dims = np.ascontiguousarray(dims, np.int32)
    mv, skip = (np.ascontiguousarray(a, np.int32) for a in refined)
    pic_h, pic_w = native_jobs[0][0].fb.planes[0].shape
    if D.shape[1:] != (31,) or lut.shape != (len(native_jobs), 2, 16, 3) \
            or dims.shape[1:] != (2,) or mv.shape != (len(skip), 4):
        raise ValueError("mc_walk: descriptors, lut, dims or refined MVs "
                         "of the wrong shape")
    if any(m.dtype != np.int32 or not m.flags.c_contiguous
           for m in (nr.tabs.mmi for nr, _ in native_jobs)):
        raise ValueError("mc_walk: the mmi grids must be C-contiguous int32")
    err = _native.load_lib().mc_walk(
        len(D), D.ctypes.data, ips.ctypes.data, mmis.ctypes.data,
        lut.ctypes.data, len(native_jobs), dims.ctypes.data, len(dims),
        nc, hs, vs, pic_w, pic_h, mv.ctypes.data, skip.ctypes.data,
        len(skip), jobs.ctypes.data, groups.ctypes.data, runs.ctypes.data,
        cap, ents.ctypes.data, len(ents), prof.ctypes.data, len(prof),
        counts.ctypes.data)
    if err:
        raise ValueError(f"mc_walk failed: {WALK_ERRORS.get(err, err)}")
    n, ng, nr, ne, np_ = counts.tolist()
    stats["walked"] += len(D)
    table = PutTable(jobs[:n], [tuple(r) for r in runs[:nr].tolist()])
    return Walk(table, groups[:ng], ents[:ne], prof[:np_])


def _plane_lookup(rpls, nc, planes):
    """The walk's lut: (tag, list, ref index, component) -> plane index
    (`_Planes.index`, one index a host plane, so that a picture in both
    lists is one plane), -1 for none; and each plane's (W, H)."""
    lut = np.full((len(rpls), 2, 16, 3), -1, np.int32)
    for tag, rpl in enumerate(rpls):
        for lx in range(2):
            for i, f in enumerate(rpl[lx].frames[:16]):
                for c in range(nc):
                    lut[tag, lx, i, c] = planes.index(f.buffer.planes[c])
    dims = np.array([p.shape[::-1] for p in planes.host], np.int32)
    return lut, dims.reshape(-1, 2)


def _by_size(buf, table):
    """Each block size's outputs in the put buffer: (w, h) -> (first row,
    [rows, h, w] view)."""
    views = {}
    for w, h, j0, n in table.runs:
        at = int(table.jobs[j0, 7])
        views[(w, h)] = (j0, buf[at:at + n * w * h].view(n, h, w))
    return views


def _rows(views, rows, w, h, dev):
    """Table rows `rows`, all of size (w, h) -> (that size's outputs, the
    rows' positions among them)."""
    j0, view = views[(w, h)]
    idx = rows.astype(np.int64) - j0
    if len(idx) and not (0 <= idx.min() and idx.max() < len(view)):
        raise ValueError(f"put rows outside the {w}x{h} outputs")
    return view, upload(idx, dev, stats)


def _take(views, rows, w, h, dev):
    """The put outputs of table rows `rows`, all of size (w, h)."""
    view, idx = _rows(views, rows, w, h, dev)
    return view[idx]


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
    bd = int(bd)
    planes = _Planes(dev)
    with trace.span("mc.dmvr"):
        refined = _dmvr_phase(D, rpls, bd, planes)
    with trace.span("mc.expand"):
        lut, dims = _plane_lookup(rpls, nc, planes)
        walk = mc_walk(D, native_jobs, lut, dims, nc, hs, vs, refined)

    with trace.span("mc.put"):
        # one table of every put, one launch (per "tile" device on a mesh)
        table, groups = walk.table, walk.groups
        planes.load(np.unique(groups[:, 2] & 0xFFFF).tolist())
        stats["put_buckets"] += len(groups)
        stats["put_blocks"] += len(table.jobs)
        for c, n in enumerate(np.bincount(groups[:, 2] >> 17 & 3,
                                          minlength=4).tolist()):
            stats["put_class"][c] += n
        views = _by_size(_put_sharded(planes.wire, table, mesh, bd), table)
        P = walk.prof
        if len(P):
            # batched PROF refinement overrides the affine put slots
            puts, at = _rows(views, P[:, 0], 4, 4, dev)
            dm = upload(P[:, 2:], dev, stats).view(-1, 2, 4, 4)
            puts[at] = _prof_apply_batch(
                puts[at], _take(views, P[:, 1], 6, 6, dev), dm[:, 0],
                dm[:, 1], bd)
            stats["prof_blocks"] += len(P)
            stats["launches"] += 1

    # finals: one batch per (size, kind); every batch is queued before the
    # one download waits
    with trace.span("mc.finals"):
        E = walk.entries
        key = E[:, 4].astype(np.int64) << 24 | E[:, 5] << 8 | E[:, 6]
        order = np.argsort(key, kind="stable")
        E, key = E[order], key[order]
        outs = []
        for g in np.split(E, np.flatnonzero(np.diff(key)) + 1):
            out = _finals(g, views, hs, vs, bd, dev)
            stats["finals_buckets"] += 1
            stats["launches"] += 1
            outs.append(out.to(torch.int16).reshape(-1))   # at most 12 bits
        if not outs:
            return
        with trace.span("mc.download"):
            pix = download(torch.cat(outs), stats)
    with trace.span("mc.writeback"):
        _writeback(pix, E, native_jobs)


def _finals(g, views, hs, vs, bd, dev):
    """One batch of finals entries of one size and kind -> pixels [B, h, w]
    int32 on the device."""
    wc, hc, kind = (int(v) for v in g[0, 4:7])
    s0 = _take(views, g[:, 8], wc, hc, dev)
    s1 = _take(views, g[:, 9], wc, hc, dev) if kind >= K_BI else None
    if kind == K_BI:
        return _mc_avg_batch(s0, s1, bd)
    if kind == K_UNI:
        return _mc_uni_batch(s0, bd)
    if kind == K_GPM:
        stats["gpm_blocks"] += len(g)
        return _mc_gpm_batch(s0, s1, upload(_gpm_weights(g, hs, vs), dev,
                                            stats), bd)
    if kind == K_BDOF:
        stats["bdof_blocks"] += len(g)
        return _bdof_full_batch(s0, s1,
                                _take(views, g[:, 10], wc + 2, hc + 2, dev),
                                _take(views, g[:, 11], wc + 2, hc + 2, dev),
                                wc, hc, bd)
    wa = upload(g[:, 10:15], dev, stats)     # (denom, w0, w1, o0, o1)
    stats["weighted_blocks"] += len(g)
    if kind == K_BI_W:
        return _mc_w_avg_batch(s0, s1, *(wa[:, i] for i in range(5)), bd)
    return _mc_uni_w_batch(s0, wa[:, 0], wa[:, 1], wa[:, 3], bd)


def _writeback(pix, E, native_jobs):
    """The finals' pixels (int16, entry after entry of E) into the jobs'
    planes, luma through the LMCS forward mapping where an entry's flag is
    set (predict_inter, vvc_inter.c:888-891): one C call
    (native/vvc_inter.c mc_writeback)."""
    n = len(native_jobs)
    dst = np.zeros((n, 3), np.int64)
    strides = np.zeros((n, 3), np.int32)
    luts = np.zeros(n, np.int64)
    keep = []
    for tag, (nr, _) in enumerate(native_jobs):
        for c, p in enumerate(nr.fb.planes):
            if p.dtype != np.int32 or p.strides[1] != 4:
                raise ValueError("mc writeback: int32 planes with unit "
                                 "column stride expected")
            dst[tag, c] = p.ctypes.data
            strides[tag, c] = p.strides[0] // 4
        lut = getattr(nr, "lmcs_fwd_np", None)
        if lut is not None:
            lut = np.ascontiguousarray(lut, np.int32)
            keep.append(lut)
            luts[tag] = lut.ctypes.data
    pix = np.ascontiguousarray(pix, np.int16)
    E = np.ascontiguousarray(E, np.int32)
    if pix.size != int((E[:, 4].astype(np.int64) * E[:, 5]).sum()) or \
            len(E) and not 0 <= E[:, 0].min() <= E[:, 0].max() < n:
        raise ValueError("mc writeback: the pixels do not match the entries")
    err = _native.load_lib().mc_writeback(
        pix.ctypes.data, E.ctypes.data, len(E), dst.ctypes.data,
        strides.ctypes.data, luts.ctypes.data)
    if err:
        raise ValueError(f"mc writeback: {WALK_ERRORS.get(err, err)}")
