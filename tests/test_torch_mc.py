"""The port's device motion compensation against the JAX package, exactly.

Function level: the same numpy-seeded inputs through each function of
`ffvvc_tpu.ops.mc_device` / `ffvvc_tpu.ops.inter_device` and its counterpart
in `ffvvc_tpu_torch.ops` on device="cpu" (twins of tests/test_device_mc.py
and tests/test_device_inter.py, plus PROF, GPM, the weighted finals, the
bilinear prefetch, boxed and wrapped puts and the NumPy host half).

Walk level: the C walk of a call's descriptors (`mc_device.mc_walk`)
against `golden_walk`, the Python expand it replaced, call by call of a
device_mc decode on nine streams: the same put rows, finals entries, PROF
rows and collocated-grid writes.

Decode level: `DecoderConfig(device="cpu", device_mc=True)` of the port
against the bytes of ffvvc_tpu's host decode on every stream of
tests/test_device_mc.py, one call per inter frame under row_progress with
the references in flight, and device_mc beside the fused chain and beside
the per-stage filters.  The port
gets bytes, never an object of the reference.

Every comparison is integer equality (tolerance 0).
"""
import collections
import concurrent.futures
import functools
import time

import numpy as np
import pytest
import torch

from test_torch_fused import TOOLS
from forge import forge_hier_stream, forge_inter_stream

from ffvvc_tpu.config import DecoderConfig as JaxConfig
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder
from ffvvc_tpu.ops import inter_device as jinter
from ffvvc_tpu.ops import mc_device as jmc
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder, trace
from ffvvc_tpu_torch import decoder as pdecoder
from ffvvc_tpu_torch.ops import fused_device as fd
from ffvvc_tpu_torch.ops import inter_device, mc_device
from ffvvc_tpu_torch.ops.kernel_inputs import put_inputs


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def same(got, want):
    """A tensor of the port against an array of the JAX package."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


# ---- function level ---------------------------------------------------------

def _put_inputs(rng, bd, B, W=128, H=96):
    plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    xs = rng.integers(-8, W + 4, B).astype(np.int32)
    ys = rng.integers(-8, H + 4, B).astype(np.int32)
    return plane, xs, ys


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("size", [(4, 4), (8, 16), (32, 8), (64, 64)])
def test_mc_put_matches_jax(bd, is_luma, size):
    """Twin of test_mc_put_device_matches_golden: all four put classes,
    origins outside the picture included."""
    rng = np.random.default_rng(hash((bd, is_luma, size)) & 0xFFFF)
    w, h = size
    plane, xs, ys = _put_inputs(rng, bd, 9)
    for fclass in range(4):
        fx = rng.integers(1, 16, 9) * bool(fclass & 1)
        fy = rng.integers(1, 16, 9) * bool(fclass & 2)
        hf = int(rng.integers(0, 3)) if is_luma else 0
        want = jmc.mc_put_batch(plane, xs, ys, fx, fy, w, h, is_luma, bd,
                                hf, hf)
        got = mc_device.mc_put_batch(plane, xs, ys, fx, fy, w, h, is_luma,
                                     bd, hf, hf, device="cpu")
        assert got.dtype == np.int32
        assert np.array_equal(got, want), fclass


@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("variant", ["wrap", "boxed", "wrap+boxed"])
def test_mc_put_wrap_and_box(is_luma, variant):
    """Horizontal wraparound and the DMVR prefetch-window boxes."""
    rng = np.random.default_rng(len(variant) * 2 + is_luma)
    bd, B, W, H = 10, 11, 128, 96
    plane, xs, ys = _put_inputs(rng, bd, B, W, H)
    wrap = W - 16 if "wrap" in variant else 0
    box = None
    if "boxed" in variant:
        x0 = rng.integers(0, W - 24, B)
        y0 = rng.integers(0, H - 24, B)
        box = np.stack([x0, x0 + rng.integers(1, 24, B), y0,
                        y0 + rng.integers(1, 24, B)], 1).astype(np.int32)
    for fclass in range(4):
        fx = rng.integers(1, 16, B) * bool(fclass & 1)
        fy = rng.integers(1, 16, B) * bool(fclass & 2)
        want = jmc.mc_put_batch(plane, xs, ys, fx, fy, 16, 8, is_luma, bd,
                                wrap=wrap, box=box)
        got = mc_device.mc_put_batch(plane, xs, ys, fx, fy, 16, 8, is_luma,
                                     bd, wrap=wrap, box=box, device="cpu")
        assert np.array_equal(got, want), fclass


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_mc_avg_uni(bd):
    """Twin of test_mc_avg_uni_device, negatives included."""
    rng = np.random.default_rng(7 + bd)
    s0 = rng.integers(-(1 << 13), 1 << 14, (5, 8, 8)).astype(np.int32)
    s1 = rng.integers(-(1 << 13), 1 << 14, (5, 8, 8)).astype(np.int32)
    assert np.array_equal(mc_device.mc_avg_batch(s0, s1, bd, device="cpu"),
                          jmc.mc_avg_batch(s0, s1, bd))
    assert np.array_equal(mc_device.mc_uni_batch(s0, bd, device="cpu"),
                          jmc.mc_uni_batch(s0, bd))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_prof_apply(bd):
    rng = np.random.default_rng(11 + bd)
    B = 13
    val = rng.integers(-(1 << 13), 1 << 14, (B, 4, 4)).astype(np.int32)
    ring = (rng.integers(0, 1 << bd, (B, 6, 6)) << (14 - bd)).astype(np.int32)
    dmx = rng.integers(-31, 32, (B, 4, 4)).astype(np.int32)
    dmy = rng.integers(-31, 32, (B, 4, 4)).astype(np.int32)
    keep = ring.copy()
    same(mc_device._prof_apply_batch(T(val), T(ring), T(dmx), T(dmy), bd),
         jmc._prof_apply_batch(val, ring, dmx, dmy, bd))
    assert np.array_equal(ring, keep)        # the ring is not written to


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_gpm_blend(bd):
    rng = np.random.default_rng(13 + bd)
    s0 = rng.integers(-(1 << 13), 1 << 14, (7, 8, 16)).astype(np.int32)
    s1 = rng.integers(-(1 << 13), 1 << 14, (7, 8, 16)).astype(np.int32)
    wgt = rng.integers(0, 9, (7, 8, 16)).astype(np.int32)
    same(mc_device._mc_gpm_batch(T(s0), T(s1), T(wgt), bd),
         jmc._mc_gpm_batch(s0, s1, wgt, bd))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_weighted_finals(bd):
    """Explicit weighted prediction and BCW: negative weights and offsets,
    per-block shifts."""
    rng = np.random.default_rng(17 + bd)
    B = 16
    s0 = rng.integers(-(1 << 13), 1 << 14, (B, 8, 8)).astype(np.int32)
    s1 = rng.integers(-(1 << 13), 1 << 14, (B, 8, 8)).astype(np.int32)
    denom = rng.integers(0, 8, B).astype(np.int32)
    w0 = rng.integers(-128, 128, B).astype(np.int32)
    w1 = rng.integers(-128, 128, B).astype(np.int32)
    o0 = rng.integers(-128, 128, B).astype(np.int32)
    o1 = rng.integers(-128, 128, B).astype(np.int32)
    same(mc_device._mc_w_avg_batch(T(s0), T(s1), T(denom), T(w0), T(w1),
                                   T(o0), T(o1), bd),
         jmc._mc_w_avg_batch(s0, s1, denom, w0, w1, o0, o1, bd))
    same(mc_device._mc_uni_w_batch(T(s0), T(denom), T(w0), T(o0), bd),
         jmc._mc_uni_w_batch(s0, denom, w0, o0, bd))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("wrap", [0, 112])
def test_dmvr_bilinear_prefetch(bd, wrap):
    rng = np.random.default_rng(19 + bd + wrap)
    B, pw, ph = 10, 20, 12
    plane, xs, ys = _put_inputs(rng, bd, B)
    dfilt = mc_device._dmvr_filters()
    assert np.array_equal(dfilt, jmc._dmvr_filters())
    for mclass in range(4):
        mx = rng.integers(1, 16, B) * bool(mclass & 1)
        my = rng.integers(1, 16, B) * bool(mclass & 2)
        fx, fy = dfilt[mx], dfilt[my]
        same(mc_device._dmvr_bilin_batch(T(plane), T(xs), T(ys), T(fx),
                                         T(fy), pw, ph, bd, mclass, wrap),
             jmc._dmvr_bilin_batch(plane, xs, ys, fx, fy, pw, ph, bd,
                                   mclass, wrap))


def _bdof_pair(rng, B, w, h):
    s0 = rng.integers(0, 1 << 14, (B, h + 2, w + 2)).astype(np.int32)
    s1 = rng.integers(0, 1 << 14, (B, h + 2, w + 2)).astype(np.int32)
    s1[0] = s0[0]                       # vx/vy zero paths
    s1[1] = s0[1] + 3
    s0[2] = s1[2] = 1 << 12             # flat: sgx2 == sgy2 == 0
    return s0, s1


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("size", [(8, 8), (16, 8), (8, 16), (16, 16)])
def test_bdof_matches_jax(bd, size):
    """Twin of test_bdof_device_matches_golden, and the finals form that
    places the puts into their rings."""
    w, h = size
    rng = np.random.default_rng(bd * 100 + w + h)
    s0, s1 = _bdof_pair(rng, 9, w, h)
    want = jinter.bdof_batch(s0, s1, bd)
    assert np.array_equal(inter_device.bdof_batch(s0, s1, bd, device="cpu"),
                          want)
    p0 = np.ascontiguousarray(s0[:, 1:-1, 1:-1])
    p1 = np.ascontiguousarray(s1[:, 1:-1, 1:-1])
    r0 = s0.copy()
    r0[:, 1:-1, 1:-1] = -1
    r1 = s1.copy()
    r1[:, 1:-1, 1:-1] = -1
    same(mc_device._bdof_full_batch(T(p0), T(p1), T(r0), T(r1), w, h, bd),
         want)
    assert (r0[:, 1:-1, 1:-1] == -1).all()   # the rings are not written to


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [(16, 16), (16, 8), (8, 16), (8, 8)])
def test_dmvr_refine_matches_jax(seed, size):
    """Twin of test_dmvr_refine_device_matches_golden, with equal pairs
    (every SAD zero: the early exit), pairs that differ by a constant (ties
    between all 25 candidates) and shifted copies (a unique minimum off
    the centre, ties around it)."""
    bw, bh = size
    rng = np.random.default_rng(seed * 10 + bw)
    B = 24
    ph, pw = bh + 4, bw + 4
    t0 = rng.integers(0, 1 << 10, (B, ph, pw)).astype(np.int32)
    t1 = np.where(rng.random((B, 1, 1)) < 0.4, t0 + rng.integers(-2, 3),
                  rng.integers(0, 1 << 10, (B, ph, pw))).astype(np.int32)
    t1[0] = t0[0]
    t1[1] = t0[1] + 40
    t0[2] = t1[2] = 512
    t1[2] += 9
    for b, (dy, dx) in zip(range(3, 8), ((1, 0), (-2, 2), (0, -1), (2, 2),
                                         (-1, -2))):
        big = rng.integers(0, 1 << 10, (ph + 8, pw + 8)).astype(np.int32)
        t0[b] = big[4 + dy:4 + dy + ph, 4 + dx:4 + dx + pw]
        t1[b] = big[4 - dy:4 - dy + ph, 4 - dx:4 - dx + pw]
    want_dmv, want_skip = jinter.dmvr_refine_batch(t0, t1, bw, bh)
    dmv, skip = inter_device.dmvr_refine_batch(t0, t1, bw, bh, device="cpu")
    assert dmv.dtype == np.int32 and skip.dtype == np.bool_
    assert np.array_equal(dmv, want_dmv)
    assert np.array_equal(skip, want_skip)
    assert np.abs(want_dmv[3:8]).max() > 0


def test_bit_length_is_exact():
    x = np.array([0, 1, 2, 3, 4, 255, 256, (1 << 24) - 1, 1 << 24,
                  (1 << 30) - 1, 1 << 30, (1 << 31) - 1], np.int32)
    same(inter_device._bit_length(T(x)), jinter._bit_length(x))
    assert inter_device._bit_length(T(x)).tolist() == \
        [int(v).bit_length() for v in x]
    assert inter_device._OFFS == jinter._OFFS


def test_host_half_equals_the_original():
    """The NumPy functions of the golden walk (below) equal the JAX
    package's, and the GPM weight blocks the port slices from the walk's
    entries equal the golden walk's."""
    rng = np.random.default_rng(23)
    for _ in range(40):
        cp = rng.integers(-2000, 2000, (3, 2))
        num_cp = int(rng.integers(2, 4))
        w, h = (int(1 << rng.integers(3, 8)) for _ in range(2))
        for a, b in zip(_affine_diff_mvs(cp, num_cp, w, h),
                        jmc._affine_diff_mvs(cp, num_cp, w, h)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        args = (int(rng.integers(-20, 200)), int(rng.integers(-20, 120)),
                16, 8, bool(rng.integers(0, 2)), 192, 96)
        assert _dmvr_box(*args) == jmc._dmvr_box(*args)
    angle_idx, a2w, offx, offy, a2m, _ = _gpm_tables()
    for part in range(64):
        for wl, hl in ((8, 8), (16, 32), (64, 8)):
            for hs, vs in ((0, 0), (1, 1)):
                args = (part, wl >> hs, hl >> vs, wl, hl, hs, vs)
                want = _gpm_weight_block(*args)
                assert np.array_equal(want, jmc._gpm_weight_block(*args))
                wi, hi = wl.bit_length() - 4, hl.bit_length() - 4
                ai = int(angle_idx[part])
                entry = [0, int(hs > 0), 0, 0, wl >> hs, hl >> vs,
                         mc_device.K_GPM, 0, 0, 0, int(a2w[ai]),
                         int(offx[part][hi][wi]), int(offy[part][hi][wi]),
                         int(a2m[ai]), 0]
                got = mc_device._gpm_weights(np.array([entry] * 2), hs, vs)
                assert got.dtype == np.int32
                assert np.array_equal(got, np.stack([want] * 2))
    for a, b in zip(mc_device._filter_banks("cpu"), jmc._filter_banks()):
        same(a, b)


# ---- the put table -----------------------------------------------------------

def _bucket_math(planes, bucket, bd):
    """One bucket of `put_inputs` through `_mc_put_math` as the per-bucket
    path ran it, its boxes as given."""
    k, _, rows, w, h, luma, hf, vf, fclass, wrap, boxed = bucket
    lf, cf = mc_device._filter_banks("cpu")
    bank = lf if luma else cf
    prm = T(rows)
    return mc_device._mc_put_math(
        T(planes[k]), prm[:, 0], prm[:, 1], bank[hf][prm[:, 2].long()],
        bank[vf][prm[:, 3].long()], prm[:, 4:8] if boxed else None, w, h,
        luma, bd, fclass, wrap, boxed)


@pytest.mark.parametrize("bd,seed", [(8, 1), (10, 2), (10, 3), (12, 4)])
def test_put_table_equals_the_buckets(bd, seed):
    """put_table on the CPU (the kernel's twin reading the packed rows)
    equals `_mc_put_math` bucket by bucket: the four classes, luma and
    chroma, 2x2 to 128x128, PROF and BDOF rings, wraparound, boxes reaching
    past the plane, blocks overhanging all four borders.  Read back through
    the buffer's views by size (`_by_size`), in shuffled bucket order."""
    rng = np.random.default_rng(seed)
    planes, buckets = put_inputs(rng, 72, 136, bd)
    order = rng.permutation(len(buckets))
    buckets = [buckets[i] for i in order]
    table, first = mc_device.put_table_of(buckets)
    buf = mc_device.put_table([torch.from_numpy(p) for p in planes], table,
                              bd)
    views = mc_device._by_size(buf, table)
    for b, ((w, h), at) in zip(buckets, first):
        got = views[(w, h)][1][at:at + len(b[2])]
        assert torch.equal(got, _bucket_math(planes, b, bd)), b[3:]


def _kernel_writes(table):
    """The output elements each CUDA block of `mc_put_kernel` writes, by
    the kernel's own index arithmetic (class search, units, tiles), with
    its shared-memory layout checked against the launch's size."""
    classes, blocks, smem = table.layout()
    written = np.zeros(table.n_out, np.int64)
    for b in range(blocks):
        lo, hi = 0, len(classes) - 1
        while lo < hi:
            m = (lo + hi + 1) >> 1
            if classes[m, 9] <= b:
                lo = m
            else:
                hi = m - 1
        w, h, tw, th, tx, tiles, upb, j0, n, b0 = classes[lo].tolist()
        win = ((th + 7) * (tw + 7) + 1) & ~1
        assert upb * tw * th <= mc_device.THREADS
        assert upb * (2 * win + 4 * (th + 7) * tw) <= smem
        for slot in range(upb):
            u = (b - b0) * upb + slot
            if u >= n * tiles:
                continue
            t = u % tiles
            ox, oy = t % tx * tw, t // tx * th
            cw, ch = min(tw, w - ox), min(th, h - oy)
            at = table.jobs[j0 + u // tiles, 7] + oy * w + ox
            written[at + np.arange(ch)[:, None] * w + np.arange(cw)] += 1
    return written, smem


def test_put_table_layout_covers_every_output_once():
    """The CUDA blocks of one launch write every output of the table
    exactly once, within 48 KB of shared memory, for the whole table and
    for each part a mesh of three tiles would take."""
    planes, buckets = put_inputs(np.random.default_rng(5), 72, 136, 10,
                                 blocks=3)
    table, _ = mc_device.put_table_of(buckets)
    n = len(table.jobs)
    for lo, hi in ((0, n), (0, n // 3), (n // 3, 2 * n // 3),
                   (2 * n // 3, n)):
        part = table.part(lo, hi) if (lo, hi) != (0, n) else table
        written, smem = _kernel_writes(part)
        assert (written == 1).all() and smem <= mc_device.SMEM_LIMIT
        end = table.jobs[hi, 7] if hi < n else table.n_out
        assert part.n_out == end - table.jobs[lo, 7]


def test_one_buffer_flat_equals_the_concatenated_layout():
    """The put buffer's views by size (`_by_size`, which the finals read
    through `_take`) give what the per-bucket outputs concatenated by size
    (`_Flat`) give, for rows of every size in random order."""
    rng = np.random.default_rng(9)
    planes, buckets = put_inputs(rng, 64, 96, 10, blocks=3)
    table, first = mc_device.put_table_of(buckets)
    views = mc_device._by_size(
        mc_device.put_table([torch.from_numpy(p) for p in planes], table, 10),
        table)
    keys = [(i, b[3], b[4]) for i, b in enumerate(buckets)]
    cat = mc_device._Flat({key: _bucket_math(planes, b, 10)
                           for key, b in zip(keys, buckets)},
                          lambda key: (key[1], key[2]))
    sizes = {}
    for key, b, ((w, h), at) in zip(keys, buckets, first):
        j0 = views[(w, h)][0]
        sizes.setdefault((w, h), []).extend(
            ((key, j), j0 + at + j) for j in range(len(b[2])))
    for (w, h), slots in sizes.items():
        slots = [slots[i] for i in rng.permutation(len(slots))]
        rows = np.array([r for _, r in slots])
        assert torch.equal(mc_device._take(views, rows, w, h, "cpu"),
                           cat.take([s for s, _ in slots], "cpu"))
    with pytest.raises(ValueError, match="outside"):
        w, h = next(iter(sizes))
        mc_device._take(views, np.array([len(table.jobs)]), w, h, "cpu")


def test_put_table_refuses_other_devices():
    """Neither CPU nor CUDA: put_table raises, nothing falls back."""
    planes, buckets = put_inputs(np.random.default_rng(2), 32, 64, 10,
                                 blocks=2)
    table, _ = mc_device.put_table_of(buckets[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        mc_device.put_table([torch.zeros(32, 64, dtype=torch.int16,
                                         device="meta")], table, 10)


# ---- decode level -----------------------------------------------------------

def host_yuv(s):
    frames = JaxDecoder(JaxConfig(backend="golden")).decode(s)
    return b"".join(f.to_yuv_bytes() for f in frames)


def port_yuv(s, **kw):
    frames = VVCDecoder(DecoderConfig(device="cpu", **kw)).decode(s)
    return b"".join(f.to_yuv_bytes() for f in frames)


def check_device_mc(s, **kw):
    mc_device.reset_stats()
    assert port_yuv(s, device_mc=True, **kw) == host_yuv(s)
    assert mc_device.stats["calls"] > 0 and mc_device.stats["put_buckets"] > 0
    assert mc_device.stats["walked"] == mc_device.stats["descriptors"]
    return dict(mc_device.stats)


AFFINE_SPS = dict(sps_affine_enabled_flag=1,
                  sps_five_minus_max_num_subblock_merge_cand=0,
                  sps_6param_affine_enabled_flag=1,
                  sps_affine_prof_enabled_flag=1)
# name -> arguments of forge_inter_stream: the streams of
# tests/test_device_mc.py, under their names there
INTER_STREAMS = {
    "p": dict(slice_type=1, nframes=3, width=96, height=64, seed=2),
    "b": dict(slice_type=0, nframes=3, width=96, height=96, seed=1),
    "b_10bit": dict(slice_type=0, nframes=3, width=64, height=64, seed=3,
                    bit_depth=10),
    "mixed": dict(slice_type=0, nframes=3, width=96, height=96, seed=5,
                  sps_temporal_mvp_enabled_flag=1, sps_ciip_enabled_flag=1,
                  sps_bcw_enabled_flag=1, sps_mmvd_enabled_flag=1,
                  **AFFINE_SPS),
    "weighted_p": dict(slice_type=1, nframes=3, width=96, height=64, seed=2,
                       sps_weighted_pred_flag=1,
                       pps_kw=dict(pps_weighted_pred_flag=1)),
    "weighted_bi": dict(slice_type=0, nframes=3, width=96, height=96, seed=1,
                        bit_depth=10, sps_weighted_bipred_flag=1,
                        pps_kw=dict(pps_weighted_bipred_flag=1)),
    "bcw": dict(slice_type=0, nframes=3, width=128, height=128, seed=4,
                sps_bcw_enabled_flag=1),
    # (4:2:0 lmcs streams carry chroma residual scaling, which gates the
    #  whole slice off the native path — mono exercises the device path)
    "lmcs": dict(slice_type=1, nframes=3, width=96, height=64, seed=3,
                 bit_depth=10, sps_lmcs_enabled_flag=1, chroma=0),
    "wraparound": dict(slice_type=1, nframes=3, width=128, height=64, seed=5,
                       sps_ref_wraparound_enabled_flag=1,
                       pps_kw=dict(pps_ref_wraparound_enabled_flag=1,
                                   pps_pic_width_minus_wraparound_offset=0)),
    "gpm_4": dict(slice_type=0, nframes=3, width=96, height=96, seed=4,
                  sps_gpm_enabled_flag=1,
                  sps_max_num_merge_cand_minus_max_num_gpm_cand=0,
                  sps_six_minus_max_num_merge_cand=1),
    "gpm_5": dict(slice_type=0, nframes=3, width=96, height=96, seed=5,
                  sps_gpm_enabled_flag=1,
                  sps_max_num_merge_cand_minus_max_num_gpm_cand=0,
                  sps_six_minus_max_num_merge_cand=1),
    "affine_prof": dict(slice_type=0, nframes=3, width=96, height=96, seed=2,
                        **AFFINE_SPS),
    "sbtmvp": dict(slice_type=0, nframes=3, width=96, height=96, seed=5,
                   sps_temporal_mvp_enabled_flag=1, sps_sbtmvp_enabled_flag=1,
                   **AFFINE_SPS),
    "affine_weighted": dict(slice_type=0, nframes=3, width=96, height=64,
                            seed=6, bit_depth=10, sps_weighted_bipred_flag=1,
                            pps_kw=dict(pps_weighted_bipred_flag=1),
                            **AFFINE_SPS),
}
# what each stream must have put through the device, by mc_device.stats
ENGAGES = {"affine_prof": "prof_blocks", "mixed": "prof_blocks"}


@pytest.mark.parametrize("name", list(INTER_STREAMS))
def test_decoder_device_mc(name):
    """Twins of test_decoder_device_mc, _extended, _gpm and _affine: the
    decode with device_mc equals the host decode byte for byte."""
    stats = check_device_mc(forge_inter_stream(deblock=True,
                                               **INTER_STREAMS[name]))
    if name in ENGAGES:
        assert stats[ENGAGES[name]] > 0, stats


HIER_STREAMS = {
    # twin of test_decoder_device_mc_dmvr_bdof
    "dmvr_bdof": dict(seed=0, width=96, height=96, ngops=2, deblock=True,
                      sps_temporal_mvp_enabled_flag=1,
                      sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1),
    # twin of test_decoder_device_mc_dmvr_12bit
    "dmvr_12bit": dict(seed=2, width=96, height=64, ngops=2, deblock=True,
                       bit_depth=12, sps_temporal_mvp_enabled_flag=1,
                       sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1),
}


@pytest.mark.parametrize("name", list(HIER_STREAMS))
def test_decoder_device_mc_dmvr_bdof(name):
    """DMVR refinement and BDOF on the device, with the refined MVs written
    back to the TMVP col grids: the hierarchical GOP catches a divergence
    there."""
    stats = check_device_mc(forge_hier_stream(**HIER_STREAMS[name]))
    assert stats["dmvr_subblocks"] > 0 and stats["bdof_blocks"] > 0, stats
    assert stats["bilin_buckets"] > 0


# ---- the walk: mc_walk against the Python expand it replaced --------------

PF_L0, PF_L1 = 1, 2


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



def _dmvr_box(x_sb, y_sb, w, h, is_luma, pw, ph):
    """Native dmvr_box: the inclusive prefetch-window clamp bounds."""
    eb, ea = (3, 4) if is_luma else (1, 2)
    sx = min(max(x_sb - eb, 0), pw - 1)
    sy = min(max(y_sb - eb, 0), ph - 1)
    wdt = max(min(pw, x_sb + w + ea) - sx, 1)
    hgt = max(min(ph, y_sb + h + ea) - sy, 1)
    return (sx, sx + wdt - 1, sy, sy + hgt - 1)



@functools.lru_cache()
def _gpm_tables():
    from ffvvc_tpu_torch.ops import data as D
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



def golden_walk(D, rpls, native_jobs, nc, hs, vs, dmvr_refined, pic_w,
                pic_h):
    """The expand of frame_device_mc before mc_walk, unchanged: returns
    its put buckets ({key: {"plane", "prm"}}), finals entries and PROF
    jobs."""
    put_buckets = {}      # key -> dict(plane, prm rows, w, h, ...)
    entries = []          # (tag, c, xc, yc, wc, hc, slots, wparams, lmcs)
    prof_jobs = []        # (val_slot, ring_slot, dmx44, dmy44)

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

    return put_buckets, entries, prof_jobs


def _refined_dict(D, refined):
    """`_dmvr_phase`'s arrays as the golden walk reads them: {(descriptor,
    sby, sbx): (mv0, mv1, skip)}."""
    mv, skip = refined
    out, j = {}, 0
    for di in np.nonzero(D[:, 13] & 64)[0]:
        nsbx, nsby = D[di, 4] >> 4 & 63, D[di, 4] >> 10 & 63
        for sby in range(nsby):
            for sbx in range(nsbx):
                m = mv[j].tolist()
                out[(int(di), sby, sbx)] = ((m[0], m[1]), (m[2], m[3]),
                                            bool(skip[j]))
                j += 1
    assert j == len(skip)
    return out


def _col_grids(native_jobs):
    return [[a.copy() for a in (nr.tabs.col_pf, nr.tabs.col_mv,
                                nr.tabs.col_ref)] for nr, _ in native_jobs]


def _table_rows(table):
    """Each row of a put table as a tuple: its first 7 columns (all but
    the output offset) and its block size."""
    size = np.repeat(np.array([r[:2] for r in table.runs]).reshape(-1, 2),
                     [r[3] for r in table.runs], axis=0)
    return [tuple(r) for r in
            np.concatenate([table.jobs[:, :7], size], 1).tolist()]


def _golden_table(buckets, native_jobs, lut, dims):
    """The golden walk's buckets through `put_table_of`, each plane under
    the walk's index for it: the table and each slot's row."""
    index = {}
    for tag, (nr, _) in enumerate(native_jobs):
        for lx in range(2):
            for i, f in enumerate(nr.rpl[lx].frames[:16]):
                for c, plane in enumerate(f.buffer.planes):
                    if lut[tag, lx, i, c] >= 0:
                        index[id(plane)] = int(lut[tag, lx, i, c])
    rows = []
    for key, b in buckets.items():
        _pid, w, h, luma, hf, has_fx, has_fy, wrap, boxed = key
        k = index[id(b["plane"])]
        rows.append((k, tuple(dims[k][::-1]), b["prm"], w, h, luma, hf, hf,
                     int(has_fx) | int(has_fy) << 1, wrap, boxed))
    table, first = mc_device.put_table_of(rows)
    start = {(w, h): j0 for w, h, j0, _ in table.runs}
    first = dict(zip(buckets, first))

    def row(slot):
        key, i = slot
        size, at = first[key]
        return start[size] + at + i
    return table, row


def check_walk(walk, golden, native_jobs, lut, dims, hs, vs):
    """The walk's table holds the golden walk's put rows (as a multiset;
    its groups are the golden buckets), each finals entry resolves to the
    same rows with the same kind, LMCS flag and parameters, and PROF has
    the same rows and offsets."""
    buckets, entries, prof_jobs = golden
    gtable, grow = _golden_table(buckets, native_jobs, lut, dims)
    want_rows, rows = _table_rows(gtable), _table_rows(walk.table)
    assert collections.Counter(rows) == collections.Counter(want_rows)
    assert len(walk.groups) == len(buckets)
    assert walk.groups[:, 4].sum() == len(rows)
    K = mc_device
    want = {}
    for tag, c, x, y, w, h, slots, wp, lm in entries:
        tagged = isinstance(wp, tuple) and isinstance(wp[0], str)
        if len(slots) == 1:
            kind, extra = (K.K_UNI_W, wp) if wp else (K.K_UNI, None)
        elif tagged and wp[0] == "gpm":
            kind, extra = K.K_GPM, wp[1].tolist()
        elif tagged and wp[0] == "bdof":
            kind = K.K_BDOF
            extra = (want_rows[grow(wp[1])], want_rows[grow(wp[2])])
        else:
            kind, extra = (K.K_BI_W, wp) if wp else (K.K_BI, None)
        want[(tag, c, x, y)] = (w, h, kind, bool(lm),
                                tuple(want_rows[grow(s)] for s in slots),
                                extra)
    got = {}
    for e in walk.entries.tolist():
        tag, c, x, y, w, h, kind, lm = e[:8]
        extra = None
        if kind in (K.K_UNI_W, K.K_BI_W):
            extra = tuple(e[10:15])
        elif kind == K.K_GPM:
            extra = K._gpm_weights(np.array([e]), hs, vs)[0].tolist()
        elif kind == K.K_BDOF:
            extra = (rows[e[10]], rows[e[11]])
        got[(tag, c, x, y)] = (w, h, kind, bool(lm),
                               tuple(rows[r] for r in e[8:10] if r >= 0),
                               extra)
    assert len(got) == len(walk.entries) and len(want) == len(entries)
    assert got == want
    assert collections.Counter(
        (rows[p[0]], rows[p[1]], tuple(p[2:18]), tuple(p[18:34]))
        for p in walk.prof.tolist()) == collections.Counter(
        (want_rows[grow(s)], want_rows[grow(r)], tuple(dx.ravel().tolist()),
         tuple(dy.ravel().tolist())) for s, r, dx, dy in prof_jobs)


# what each stream's walks must have made, by kind of entry or table row
WALK_STREAMS = {
    "mixed": lambda w: len(w.prof) > 0,
    "affine_prof": lambda w: len(w.prof) > 0,
    "sbtmvp": lambda w: len(w.entries) > 0,
    "affine_weighted": lambda w: (w.entries[:, 6] == mc_device.K_BI_W).any(),
    "gpm_4": lambda w: (w.entries[:, 6] == mc_device.K_GPM).any(),
    "weighted_bi": lambda w: (w.entries[:, 6] == mc_device.K_BI_W).any(),
    "wraparound": lambda w: (w.table.jobs[:, 4] > 0).any(),
    "dmvr_bdof": lambda w: (w.entries[:, 6] == mc_device.K_BDOF).any() and
    (w.table.jobs[:, 3] >> 23 & 1).any(),
    "lmcs": lambda w: w.entries[:, 7].any(),
}


@pytest.mark.parametrize("name", list(WALK_STREAMS))
def test_walk_equals_the_golden_walk(name, monkeypatch):
    """mc_walk (C) against the Python expand it replaced, call by call of
    a device_mc decode: the same put rows, finals entries, PROF rows and
    offsets, and the same writes to the collocated grids (each walk runs
    from the grids as they were)."""
    real = mc_device.mc_walk
    seen = []

    def spy(D, native_jobs, lut, dims, nc, hs, vs, refined):
        before = _col_grids(native_jobs)
        pic_h, pic_w = native_jobs[0][0].fb.planes[0].shape
        golden = golden_walk(D, [nr.rpl for nr, _ in native_jobs],
                             native_jobs, nc, hs, vs,
                             _refined_dict(D, refined), pic_w, pic_h)
        want = _col_grids(native_jobs)
        for (nr, _), grids in zip(native_jobs, before):
            for a, b in zip((nr.tabs.col_pf, nr.tabs.col_mv,
                             nr.tabs.col_ref), grids):
                a[...] = b
        walk = real(D, native_jobs, lut, dims, nc, hs, vs, refined)
        for got, grids in zip(_col_grids(native_jobs), want):
            assert all(np.array_equal(a, b) for a, b in zip(got, grids))
        check_walk(walk, golden, native_jobs, lut, dims, hs, vs)
        seen.append(WALK_STREAMS[name](walk))
        return walk
    monkeypatch.setattr(mc_device, "mc_walk", spy)
    s = forge_inter_stream(deblock=True, **INTER_STREAMS[name]) \
        if name in INTER_STREAMS else forge_hier_stream(**HIER_STREAMS[name])
    check_device_mc(s, pipeline_frames=False)
    assert seen and any(seen), seen


class _LatePixels(concurrent.futures.ThreadPoolExecutor):
    """The decoder's pixel thread, each job started `delay` seconds
    late."""

    def __init__(self, delay):
        super().__init__(max_workers=1, thread_name_prefix="ffvvc-pixels")
        self.delay = delay

    def submit(self, fn):
        def late():
            time.sleep(self.delay)
            return fn()
        return super().submit(late)


def late_decode(s, **kw):
    """The port's device_mc decode with every pixel job started late, so
    that the references are still being filtered when the next frame's MC
    runs, whatever the host's load (with the pixel thread on time a busy
    host may finish them first): its frames."""
    dec = VVCDecoder(DecoderConfig(device="cpu", device_mc=True, **kw))
    dec._pix_exec = _LatePixels(0.2)
    try:
        return dec.decode(s)
    finally:
        dec._pix_exec.shutdown()


def yuv(frames):
    return b"".join(f.to_yuv_bytes() for f in frames)


@pytest.mark.parametrize("filters", [{}, dict(device_pipeline=True)],
                         ids=["host", "fused"])
def test_row_progress_with_device_mc(filters, monkeypatch):
    """Twin of tests/test_pipeline.py::test_row_progress_with_device_mc:
    under row_progress, with the references in flight, device MC waits for
    each reference as a whole (`wait.refs`, no row wait) and makes one
    frame_device_mc call per inter frame, whether the host filters publish
    rows or the fused chain filters; the bytes equal the plain decode's and
    the host decode's."""
    s = forge_hier_stream(seed=1, width=192, height=160, qp=32,
                          bit_depth=10, ngops=2, deblock=True,
                          sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                          sps_temporal_mvp_enabled_flag=1,
                          sps_dmvr_enabled_flag=1, sps_bdof_enabled_flag=1)
    log = {"row_waits": 0, "mc": []}
    orig_wait = pdecoder.DecodedFrame.wait_rows
    orig_mc = mc_device.frame_device_mc

    def spy_wait(self, y):
        log["row_waits"] += 1
        return orig_wait(self, y)

    def spy_mc(jobs, sps, bd, device="cuda", mesh=None):
        log["mc"].append(id(jobs[0][0].fb))
        assert device == "cpu" and mesh is None
        return orig_mc(jobs, sps, bd, device=device, mesh=mesh)

    monkeypatch.setattr(pdecoder.DecodedFrame, "wait_rows", spy_wait)
    monkeypatch.setattr(mc_device, "frame_device_mc", spy_mc)
    trace.clear()
    frames = late_decode(s, profile=True, **filters)
    spans = trace.spans()
    trace.clear()
    monkeypatch.undo()
    a = yuv(frames)
    assert a == port_yuv(s, row_progress=False, pipeline_frames=False)
    assert a == host_yuv(s)
    # one call per inter frame (every frame but the IDR), after whole waits
    assert len(log["mc"]) == len(set(log["mc"])) == len(frames) - 1, log
    assert log["row_waits"] == 0, log
    assert any(sp.name == "wait.refs" for sp in spans)


@pytest.mark.parametrize("slice_type", [2, 0])
@pytest.mark.parametrize("path", ["fused", "stages"])
def test_device_mc_with_the_device_filters(slice_type, path, monkeypatch):
    """Twin of test_all_device_paths_end_to_end without device_intra:
    device_mc beside the fused chain (the whole-frame form) and beside the
    four per-stage filters, itx dispatch forced on."""
    toggles = {"fused": dict(device_pipeline=True),
               "stages": dict(device_sao=True, device_alf=True,
                              device_deblock=True, device_lmcs=True)}[path]
    s = forge_inter_stream(slice_type=slice_type, nframes=3, width=96,
                           height=96, seed=7, deblock=True, bit_depth=10,
                           **TOOLS)
    monkeypatch.setenv("FFVVC_ITX", "device")
    mc_device.reset_stats()
    fd.reset_stats()
    assert port_yuv(s, device_mc=True, **toggles) == host_yuv(s)
    if path == "fused":
        assert fd.stats["frames"] > 0


def test_whole_frame_form_with_the_fused_chain():
    """Under the benchmark's condition (row_progress on, the references
    still being filtered when the next frame's MC runs) an inter frame is
    one frame_device_mc call, and the fused chain filters the same
    frames."""
    s = forge_hier_stream(seed=1, width=192, height=160, qp=32, bit_depth=10,
                          ngops=1, deblock=True, sps_sao_enabled_flag=1,
                          sps_alf_enabled_flag=1,
                          sps_temporal_mvp_enabled_flag=1,
                          sps_dmvr_enabled_flag=1, sps_bdof_enabled_flag=1)
    fd.reset_stats()
    mc_device.reset_stats()
    frames = late_decode(s, device_pipeline=True)
    assert yuv(frames) == host_yuv(s)
    stats = dict(mc_device.stats)
    assert stats["calls"] == len(frames) - 1       # every frame but the IDR
    assert fd.stats["frames"] == len(frames)
    assert all(n > 0 for n in stats["put_class"]), stats
    assert stats["up_bytes"] > 0 and stats["down_bytes"] > 0


def test_planes_go_up_once_per_call():
    """A reference plane is uploaded once per frame_device_mc call however
    many buckets read it: the bytes up stay below one copy of every plane
    of both references plus the parameters."""
    s = forge_inter_stream(slice_type=0, nframes=2, width=128, height=128,
                           seed=1, deblock=True)
    stats = check_device_mc(s, row_progress=False)
    assert stats["calls"] == 1 and stats["put_buckets"] > 6
    planes = 2 * (128 * 128 + 2 * 64 * 64) * 2         # 16-bit samples
    params = stats["put_blocks"] * 8 * 4 + stats["descriptors"] * 3 * 2 * 8
    assert stats["up_bytes"] <= planes + params, stats


@pytest.mark.parametrize("name", ["mixed", "dmvr_bdof"])
def test_put_buckets_count_the_table_groups(name, monkeypatch):
    """stats["put_buckets"] counts the distinct put groups (plane, size,
    class, filter, wrap, box) as the per-bucket path did: each call's one
    table, as the walk builds it, holds exactly its groups and blocks.  On
    the CPU no kernel launches."""
    seen = []
    real = mc_device.mc_walk

    def spy(*args):
        walk = real(*args)
        table = walk.table
        size = np.repeat(np.array([r[:2] for r in table.runs]),
                         [r[3] for r in table.runs], axis=0)
        groups = np.unique(np.concatenate([size, table.jobs[:, 3:5]], 1),
                           axis=0)
        seen.append((len(walk.groups), len(groups), len(table.jobs),
                     int(walk.groups[:, 4].sum())))
        return walk
    monkeypatch.setattr(mc_device, "mc_walk", spy)
    s = forge_inter_stream(deblock=True, **INTER_STREAMS[name]) \
        if name in INTER_STREAMS else forge_hier_stream(**HIER_STREAMS[name])
    launches = mc_device.put_table.launches
    stats = check_device_mc(s, pipeline_frames=False)
    assert seen and all(a == b and c == d for a, b, c, d in seen), seen
    assert stats["put_buckets"] == sum(a for a, _, _, _ in seen)
    assert stats["put_blocks"] == sum(c for _, _, c, _ in seen)
    assert mc_device.put_table.launches == launches
    assert len(seen) <= stats["calls"]


def test_device_mc_does_not_fall_back(monkeypatch):
    """A failure inside the device MC raises; the frame is not handed to
    the host MC."""
    def broken(*a, **k):
        raise RuntimeError("put failed")
    monkeypatch.setattr(mc_device, "_put_bucket", broken)
    s = forge_inter_stream(deblock=True, **INTER_STREAMS["p"])
    with pytest.raises(RuntimeError, match="put failed"):
        port_yuv(s, device_mc=True, pipeline_frames=False)
