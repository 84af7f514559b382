"""Batched inverse transforms + residual add on the device.

Port of `ffvvc_tpu/ops/itx.py`: the host CABAC front-end emits per-TB
coefficient blocks; blocks are bucketed by (w, h, trh, trv) and each bucket
is inverse-transformed as ONE batched matrix-product pair (column pass then
row pass).

Integer exactness: torch has no integer matrix product on CUDA, so both
passes multiply in float64 (`_int_matmul`).  That is exact here: a
coefficient is below 2^20 in magnitude, a matrix entry at most 128 and a
pass sums at most 64 products, so every partial sum stays below 2^33, far
inside the 2^53 that float64 holds exactly, whatever order the products are
added in.  tests/test_torch_itx.py holds every transform kind and size at
the largest magnitudes against `itx_batch_host` (NumPy int64).

Reference analogue: the function-pointer itx grid of
libavcodec/vvc/vvcdsp.c:94-140 (itx_2d/itx_1d) and the hand-unrolled 1-D
transforms of vvc_itx_1d.c — here one batched call per bucket instead of
per-TB scalar calls.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import trace
from . import data as D
from .device import Counters, download, upload

DCT2, DST7, DCT8 = 0, 1, 2
_MATS = {DCT2: D.dct2_matrix, DST7: D.dst7_matrix, DCT8: D.dct8_matrix}

# what frame_device_residuals did since reset_stats()
stats = Counters("frames", "buckets", "tbs", "up_bytes", "down_bytes")
reset_stats = stats.reset


@functools.lru_cache()
def matrix(kind: int, n: int) -> np.ndarray:
    return _MATS[kind](n)


@functools.lru_cache()
def _matrix_f64(kind: int, n: int, device: str):
    return torch.from_numpy(matrix(kind, n).astype(np.float64)).to(
        torch.device(device))


def _int_matmul(a, m):
    """Exact integer product a [..., k] int64 x m [k, n] float64 (integer
    valued) -> int64, computed in float64 (see the module docstring)."""
    return torch.matmul(a.to(torch.float64), m).to(torch.int64)


def itx_batch(coeffs, w: int, h: int, trh: int, trv: int,
              log2_range: int = 15, bit_depth: int = 8):
    """Inverse 2-D transform of a batch of TBs: coeffs [B, h, w] integer
    tensor -> residual [B, h, w] int32 on the same device.  Matches itx_2d
    (vvcdsp.c:94) bit-exactly."""
    dev = str(coeffs.device)
    return _itx_batch_m(coeffs, _matrix_f64(trv, h, dev),
                        _matrix_f64(trh, w, dev), w, h, log2_range, bit_depth)


def _itx_batch_m(coeffs, mv, mh, w: int, h: int,
                 log2_range: int = 15, bit_depth: int = 8):
    shift0 = 7
    shift1 = 5 + log2_range - bit_depth
    lo = -(1 << log2_range)
    hi = (1 << log2_range) - 1
    c = coeffs.to(torch.int64)
    if w == 1 or h == 1:
        shift = 6 + log2_range - bit_depth
        add = 1 << (shift - 1)
        if w > 1:
            t = _int_matmul(c[:, 0, :], mh)
            out = ((t + add) >> shift)[:, None, :]
        else:
            t = _int_matmul(c[:, :, 0], mv)
            out = ((t + add) >> shift)[:, :, None]
        return out.to(torch.int32)
    # column pass: tmp[b, x, y] = sum_k c[b, k, x] * mv[k, y]
    tmp = _int_matmul(c.transpose(1, 2), mv)              # [B, w, h]
    tmp = ((tmp + (1 << (shift0 - 1))) >> shift0).clamp(lo, hi)
    # row pass: out[b, y, x] = sum_k tmp[b, k, y] * mh[k, x]
    out = _int_matmul(tmp.transpose(1, 2), mh)            # [B, h, w]
    out = (out + (1 << (shift1 - 1))) >> shift1
    return out.to(torch.int32)


def itx_batch_host(coeffs, w: int, h: int, trh: int, trv: int,
                   log2_range: int = 15, bit_depth: int = 8):
    """Host (NumPy) twin of itx_batch, bit-identical.  Used with
    FFVVC_ITX=host, and as the int64 reference the device path is held
    against."""
    mv = matrix(trv, h).astype(np.int64)
    mh = matrix(trh, w).astype(np.int64)
    shift0 = 7
    shift1 = 5 + log2_range - bit_depth
    lo, hi = -(1 << log2_range), (1 << log2_range) - 1
    c = coeffs.astype(np.int64)
    if w == 1 or h == 1:
        shift = 6 + log2_range - bit_depth
        add = 1 << (shift - 1)
        if w > 1:
            t = c[:, 0, :] @ mh
            return ((t + add) >> shift)[:, None, :].astype(np.int32)
        t = c[:, :, 0] @ mv
        return ((t + add) >> shift)[:, :, None].astype(np.int32)
    tmp = np.tensordot(c, mv, axes=([1], [0]))         # [B, w, h]
    tmp = np.clip((tmp + (1 << (shift0 - 1))) >> shift0, lo, hi)
    out = np.tensordot(tmp, mh, axes=([1], [0]))       # [B, h, w]
    out = (out + (1 << (shift1 - 1))) >> shift1
    return out.astype(np.int32)


def _use_device_itx() -> bool:
    """FFVVC_ITX=device|host|auto; auto means the device (there is no
    slow link to a remote chip to weigh against)."""
    return os.environ.get("FFVVC_ITX", "auto") != "host"


def dequant_batch(coeffs, scales, bd_shift, log2_range=15):
    """Batched dequant: coeffs [B,h,w] int32, scales [B] int32 (scale*scale_m),
    bd_shift [B] int32.  Matches scale_coeff (vvc_intra.c:389); the product
    is taken in int64, as the golden model takes it."""
    sh = bd_shift.to(torch.int64)[:, None, None]
    c = coeffs.to(torch.int64) * scales.to(torch.int64)[:, None, None]
    c = (c + (torch.ones_like(sh) << (sh - 1))) >> sh
    lo = -(1 << log2_range)
    hi = (1 << log2_range) - 1
    return c.clamp(lo, hi).to(torch.int32)


def scatter_residual(frame, residuals, xs, ys, w, h, pixel_max):
    """Add a bucket of residual blocks into the frame plane at (xs, ys).

    frame [H, W] int32; residuals [B, h, w]; xs/ys [B] int32 block origins.
    All blocks in a bucket are disjoint, so this is a gather, an add and an
    indexed assignment, with no sort and no atomics.  Returns a new plane.
    """
    dev = frame.device
    rows = (ys.to(torch.int64)[:, None, None] +
            torch.arange(h, device=dev)[None, :, None])
    cols = (xs.to(torch.int64)[:, None, None] +
            torch.arange(w, device=dev)[None, None, :])
    out = frame.clone()
    out[rows, cols] = out[rows, cols] + residuals
    return out.clamp(0, pixel_max)


@trace.traced("itx")
def frame_device_residuals(recon_jobs, tabs, bit_depth: int, device="cuda"):
    """Batched inverse transform of every TB in a parsed frame.

    Host prep (BDPCM/dequant/LFNST/type decision) runs per TB via the job's
    Reconstructor, then TBs are bucketed by (w, h, trh, trv, log2_range) and
    each bucket is one itx_batch call.  TBs come back with tb.coeffs set to
    the final residual (tb.residual_ready), so the sequential intra recon
    only adds them.  Replaces per-TB scalar itx calls of the reference
    (vvcdsp.c:94-140) with one batched matrix-product pair per bucket.
    Only the golden Python parse keeps the CUs this walks; the native parse
    leaves tabs.cus empty and its C recon transforms."""
    buckets = {}
    for rec, ctus in recon_jobs:
        for rs, _rx, _ry in ctus:
            for cu in tabs.cus[rs]:
                for tu in cu.tus:
                    for tb in tu.tbs:
                        if not tb.has_coeffs or \
                                getattr(tb, "residual_ready", False) or \
                                getattr(tb, "itx_queued", False):
                            continue
                        r = rec.prepare_tb_for_itx(cu, tu, tb)
                        if r is None:
                            continue  # transform-skip: residual already final
                        trh, trv, l2r = r
                        key = (tb.w, tb.h, trh, trv, l2r)
                        buckets.setdefault(key, []).append(tb)
                        tb.itx_queued = True
    if not buckets:
        return
    # every bucket is queued on the device before the first download waits
    use_device = _use_device_itx()
    dev = torch.device(device)
    launched = []
    for (w, h, trh, trv, l2r), tbs in buckets.items():
        coeffs = np.stack([t.coeffs for t in tbs]).astype(np.int32)
        if not use_device:
            launched.append((tbs, itx_batch_host(coeffs, w, h, trh, trv,
                                                 log2_range=l2r,
                                                 bit_depth=bit_depth)))
            continue
        stats["buckets"] += 1
        stats["tbs"] += len(tbs)
        launched.append((tbs, itx_batch(
            upload(coeffs, dev, stats), w, h, trh, trv, log2_range=l2r,
            bit_depth=bit_depth)))
    stats["frames"] += 1
    for tbs, out in launched:
        if use_device:
            out = download(out, stats)
        for i, t in enumerate(tbs):
            t.coeffs = out[i].astype(np.int64)
            t.residual_ready = True
