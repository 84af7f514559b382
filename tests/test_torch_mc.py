"""The port's device motion compensation against the JAX package, exactly.

Function level: the same numpy-seeded inputs through each function of
`ffvvc_tpu.ops.mc_device` / `ffvvc_tpu.ops.inter_device` and its counterpart
in `ffvvc_tpu_torch.ops` on device="cpu" (twins of tests/test_device_mc.py
and tests/test_device_inter.py, plus PROF, GPM, the weighted finals, the
bilinear prefetch, boxed and wrapped puts and the NumPy host half).

Decode level: `DecoderConfig(device="cpu", device_mc=True)` of the port
against the bytes of ffvvc_tpu's host decode on every stream of
tests/test_device_mc.py, one call per inter frame under row_progress with
the references in flight, and device_mc beside the fused chain and beside
the per-stage filters.  The port
gets bytes, never an object of the reference.

Every comparison is integer equality (tolerance 0).
"""
import concurrent.futures
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
    """The NumPy functions the port keeps its own copy of."""
    rng = np.random.default_rng(23)
    for _ in range(40):
        cp = rng.integers(-2000, 2000, (3, 2))
        num_cp = int(rng.integers(2, 4))
        w, h = (int(1 << rng.integers(3, 8)) for _ in range(2))
        for a, b in zip(mc_device._affine_diff_mvs(cp, num_cp, w, h),
                        jmc._affine_diff_mvs(cp, num_cp, w, h)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        args = (int(rng.integers(-20, 200)), int(rng.integers(-20, 120)),
                16, 8, bool(rng.integers(0, 2)), 192, 96)
        assert mc_device._dmvr_box(*args) == jmc._dmvr_box(*args)
    for part in range(64):
        for wl, hl in ((8, 8), (16, 32), (64, 8)):
            for hs, vs in ((0, 0), (1, 1)):
                args = (part, wl >> hs, hl >> vs, wl, hl, hs, vs)
                assert np.array_equal(mc_device._gpm_weight_block(*args),
                                      jmc._gpm_weight_block(*args))
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
    the one-buffer `_Flat`, in shuffled bucket order."""
    rng = np.random.default_rng(seed)
    planes, buckets = put_inputs(rng, 72, 136, bd)
    order = rng.permutation(len(buckets))
    buckets = [buckets[i] for i in order]
    table, first = mc_device.put_table_of(buckets)
    keys = list(range(len(buckets)))
    buf = mc_device.put_table([torch.from_numpy(p) for p in planes], table,
                              bd)
    flat = mc_device._Flat.of_table(buf, table, dict(zip(keys, first)))
    for i, b in zip(keys, buckets):
        got = flat.take([(i, j) for j in range(len(b[2]))], "cpu")
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
    """The one-buffer `_Flat` (views of the put table's buffer) gives what
    the per-bucket outputs concatenated by size give, through `take` and
    `index`, for slots of every size in random order."""
    rng = np.random.default_rng(9)
    planes, buckets = put_inputs(rng, 64, 96, 10, blocks=3)
    table, first = mc_device.put_table_of(buckets)
    keys = [(i, b[3], b[4]) for i, b in enumerate(buckets)]
    one = mc_device._Flat.of_table(
        mc_device.put_table([torch.from_numpy(p) for p in planes], table, 10),
        table, dict(zip(keys, first)))
    cat = mc_device._Flat({key: _bucket_math(planes, b, 10)
                           for key, b in zip(keys, buckets)},
                          lambda key: (key[1], key[2]))
    sizes = {}
    for key, b in zip(keys, buckets):
        sizes.setdefault(key[1:], []).extend(
            (key, j) for j in range(len(b[2])))
    for slots in sizes.values():
        slots = [slots[i] for i in rng.permutation(len(slots))]
        assert torch.equal(one.take(slots, "cpu"), cat.take(slots, "cpu"))
        (a, ia), (b, ib) = one.index(slots, "cpu"), cat.index(slots, "cpu")
        assert torch.equal(a[ia], b[ib])


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
    table holds exactly its buckets' groups and blocks.  On the CPU no
    kernel launches."""
    seen = []
    real = mc_device.put_table_of

    def spy(buckets):
        table, first = real(buckets)
        size = np.repeat(np.array([r[:2] for r in table.runs]),
                         [r[3] for r in table.runs], axis=0)
        groups = np.unique(np.concatenate([size, table.jobs[:, 3:5]], 1),
                           axis=0)
        seen.append((len(buckets), len(groups), len(table.jobs),
                     sum(len(b[2]) for b in buckets)))
        return table, first
    monkeypatch.setattr(mc_device, "put_table_of", spy)
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
