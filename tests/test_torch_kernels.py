"""The plain twins of the port's kernels against the JAX package, exactly.

Inputs come from `np.random.default_rng(seed)` and go, as the same numpy
arrays, through:
  * the JAX Pallas kernels `_sao_pallas`, `_alf_pallas` and `_cc_pallas`
    (interpret mode on the CPU, as the JAX package's own tests run them),
    fed the per-pixel planes they take, expanded here in numpy;
  * the JAX fused-chain forms `_sao_apply`, `_alf_filter_plane` and
    `_cc_filter`;
  * the port's plain versions (`sao_apply_ref`, `alf_filter_luma_ref` and
    `alf_filter_chroma_ref` over `alf_filter_plane_ref`, `cc_filter_ref`),
    which take 16-bit samples and parameters by index, and their wrappers,
    which run the plain versions on CPU tensors.
The plain PyTorch stages of the chain — deblocking (`luma_math`,
`chroma_math`) and the ALF classification — are held against JAX's too.
Every comparison is integer equality (tolerance 0).  Last, the launch rule
of the five hand-kernel wrappers (`ops/device.py`) on a device that is
neither the CPU nor CUDA, and the counters every device module keeps.
"""
import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ffvvc_tpu import alf
from ffvvc_tpu.ops import alf_device as jalf
from ffvvc_tpu.ops import deblock_device as jdb
from ffvvc_tpu.ops import fused_device as jfd
from ffvvc_tpu.ops import sao_device as jsao
from ffvvc_tpu_torch.ops import alf_device, deblock_device, fused_device
from ffvvc_tpu_torch.ops import (device, intra_device, itx, lmcs_device,
                                 mc_device, sao_device)
from ffvvc_tpu_torch.ops.kernel_inputs import (alf_chroma_inputs,
                                               alf_luma_inputs, cc_inputs,
                                               put_inputs, sao_inputs)


def px(a, cs_v, cs_h, H, W):
    """numpy per-CTB/per-block [ch, cw] -> per-pixel [H, W]."""
    return np.repeat(np.repeat(a, cs_v, 0), cs_h, 1)[:H, :W]


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    assert np.array_equal(got.astype(np.int64),
                          np.asarray(want).astype(np.int64))


# ---- SAO --------------------------------------------------------------------

def _sao_case(rng, H, W, cs_v, cs_h, bd):
    """Seeded inputs, and the JAX Pallas kernel's output on them (per-pixel
    maps and the keep map expanded in numpy), checked against the JAX
    fused form."""
    plane, p = sao_inputs(rng, H, W, cs_v, cs_h, bd)
    shift, pix_max = bd - 5, (1 << bd) - 1
    wide = plane.astype(np.int32)
    e = {k: px(v, cs_v, cs_h, H, W) for k, v in p.items() if k != "offs"}
    offs = np.stack([px(p["offs"][k], cs_v, cs_h, H, W) for k in range(5)])
    xs = np.arange(W)[None, :]
    ys = np.arange(H)[:, None]
    in_x = ((xs & (cs_h - 1)) >= e["ax"]) & ((xs & (cs_h - 1)) < e["bx"])
    keep = ((xs == 0) & (e["kl"] != 0)) | ((xs == W - 1) & (e["kr"] != 0)) \
        | ((ys == 0) & (e["kt"] != 0) & in_x) \
        | ((ys == H - 1) & (e["kb"] != 0) & in_x)
    want = jsao._sao_pallas(np.pad(wide, 1, mode="edge"), e["typ"],
                            e["m1"], offs, keep.astype(np.int32), shift,
                            pix_max)
    fused = jfd._sao_apply(jnp.asarray(wide),
                           {k: jnp.asarray(v) for k, v in p.items()},
                           cs_v, cs_h, shift, pix_max)
    same(fused, want)
    assert not np.array_equal(np.asarray(want), wide), "SAO changed nothing"
    return (torch.from_numpy(plane),
            torch.from_numpy(sao_device.pack_params(p, H, W, cs_v, cs_h)),
            np.asarray(want))


@pytest.mark.parametrize("bd,cs_v,cs_h,H,W,seed", [
    (8, 32, 32, 72, 104, 0),     # luma, CTB 32, ragged right/bottom CTBs
    (10, 64, 64, 88, 136, 1),    # luma, CTB 64
    (12, 16, 16, 36, 52, 2),     # 4:2:0 chroma of CTB 32
    (10, 64, 32, 64, 40, 3),     # 4:2:2 chroma of CTB 64
])
def test_sao_twin_matches_jax(bd, cs_v, cs_h, H, W, seed):
    rng = np.random.default_rng(seed)
    plane, prm, want = _sao_case(rng, H, W, cs_v, cs_h, bd)
    args = ([plane], [prm], [(cs_v, cs_h)], bd - 5, (1 << bd) - 1)
    (got,) = sao_device.sao_apply_ref(*args)
    assert got.dtype == torch.int16
    same(got, want)
    same(sao_device.sao_apply(*args)[0], want)


def test_sao_three_planes_in_one_call():
    """The planes of a 4:2:0 picture through one call, as the chain passes
    them: each equals the JAX kernel on that plane."""
    rng = np.random.default_rng(7)
    bd = 10
    cases = [_sao_case(rng, H, W, cs, cs, bd)
             for H, W, cs in ((72, 104, 32), (36, 52, 16), (36, 52, 16))]
    got = sao_device.sao_apply([c[0] for c in cases], [c[1] for c in cases],
                               [(32, 32), (16, 16), (16, 16)], bd - 5,
                               (1 << bd) - 1)
    assert len(got) == 3
    for g, c in zip(got, cases):
        same(g, c[2])


# ---- ALF --------------------------------------------------------------------

def _alf_jax(cur, cf_blk, cl_blk, blk_h, blk_w, cs_v, luma, pix_max):
    """The JAX Pallas kernel (its 48-plane form: tap samples, coefficients,
    clips) on per-block coefficients, with the JAX package's own
    virtual-boundary row tables; checked against the JAX fused form."""
    H, W = cur.shape
    b = 3 if luma else 2
    rowsel, vbsel = jfd._alf_vb_arrays(H, cs_v, b, 4 if luma else 2, luma)
    slots = range(12) if luma else alf_device._CHROMA_SLOT
    P3 = np.pad(cur, b, mode="edge")
    v0 = np.repeat(cur[None], 12, 0)
    v1 = v0.copy()
    for s in slots:
        ka, da, kb, db = alf_device._LUMA_TAPS[s]
        v0[s] = P3[rowsel[ka]][:, b + da:b + da + W]
        v1[s] = P3[rowsel[kb]][:, b + db:b + db + W]
    cf_px = np.stack([px(cf_blk[:, :, s], blk_h, blk_w, H, W)
                      for s in range(12)])
    cl_px = np.stack([px(cl_blk[:, :, s], blk_h, blk_w, H, W)
                      for s in range(12)])
    vb_px = np.repeat(vbsel[:, None], W, 1)
    want = jalf._alf_pallas(cur, v0, v1, cf_px, cl_px, vb_px, pix_max)
    taps = tuple(alf_device._LUMA_TAPS[s] for s in slots)
    fused = jfd._alf_filter_plane(
        jnp.asarray(cur), jnp.asarray(P3), jnp.asarray(rowsel),
        jnp.asarray(vbsel), {s: jnp.asarray(cf_px[s]) for s in slots},
        {s: jnp.asarray(cl_px[s]) for s in slots}, taps, slots, b, pix_max)
    same(fused, want)
    assert not np.array_equal(np.asarray(want), cur), "ALF changed nothing"
    return np.asarray(want)


@pytest.mark.parametrize("bd,luma,cs_v,cs_h,H,W,seed", [
    (10, True, 64, 64, 72, 96, 0),     # luma CTB 64, ragged bottom CTB row
    (8, True, 32, 32, 48, 40, 1),      # luma CTB 32
    (12, False, 32, 32, 36, 52, 2),    # 4:2:0 chroma of CTB 64
    (10, False, 32, 16, 40, 44, 3),    # 4:2:2 chroma of CTB 32
    (10, True, 32, 32, 60, 72, 4),     # last CTB row ends inside the window
    (8, False, 16, 16, 31, 36, 5),     # chroma likewise (rows 12..14 of 16)
    (10, True, 128, 128, 136, 132, 6),  # luma CTB 128
])
def test_alf_twin_matches_jax(bd, luma, cs_v, cs_h, H, W, seed):
    """Every row of the +-4 window around each virtual boundary is in these
    planes (each CTB row has one), with whole and partial last CTB rows."""
    rng = np.random.default_rng(seed)
    pix_max = (1 << bd) - 1
    t = torch.from_numpy
    if luma:
        src, ci, ti, ctb_set, cf, cl = alf_luma_inputs(rng, H, W, cs_v, bd)
        set_blk = px(ctb_set, cs_v // 4, cs_v // 4, H // 4, W // 4)
        perm = np.array(alf._TRANSPOSE_IDX)[ti]
        cf_blk = np.take_along_axis(cf[set_blk, ci], perm, 2)
        cl_blk = np.take_along_axis(cl[set_blk, ci], perm, 2)
        want = _alf_jax(src.astype(np.int32), cf_blk, cl_blk, 4, 4, cs_v,
                        True, pix_max)
        args = (t(src), t(ci), t(ti), t(ctb_set), t(cf), t(cl), cs_v,
                pix_max)
        got = alf_device.alf_filter_luma_ref(*args)
        assert got.dtype == torch.int16
        same(got, want)
        same(alf_device.alf_filter_luma(*args), want)
        return
    planes = [alf_chroma_inputs(rng, H, W, cs_v, cs_h, bd) for _ in range(2)]
    wants = [_alf_jax(src.astype(np.int32), cf[ctb_set], cl[ctb_set], cs_v,
                      cs_h, cs_v, False, pix_max)
             for src, ctb_set, cf, cl in planes]
    args = tuple([t(p[k]) for p in planes] for k in range(4)) + \
        (cs_v, cs_h, pix_max)
    for fn in (alf_device.alf_filter_chroma_ref, alf_device.alf_filter_chroma):
        got = fn(*args)
        assert len(got) == 2 and got[0].dtype == torch.int16
        for g, w in zip(got, wants):
            same(g, w)


@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("cs_v,H", [(32, 1080), (16, 540), (32, 96),
                                    (64, 200), (128, 240), (16, 270)])
def test_vb_reach_matches_row_offsets(luma, cs_v, H):
    """The tap rows the kernels compute from the row number (`vb_reach`:
    nominal offsets clamped to +-reach) equal the host tables
    `_alf_vb_arrays` builds from `_vb_row_offsets`, also in a last CTB row
    that is partial (1080 = 33 * 32 + 24)."""
    b, above = (3, 4) if luma else (2, 2)
    rowsel, vbsel = jfd._alf_vb_arrays(H, cs_v, b, above, luma)
    ys = torch.arange(H)
    reach = alf_device.vb_reach(ys, cs_v, cs_v - above)
    for k, o in enumerate(alf_device._ROW_OFFSET):
        if not luma and abs(o) > 2:
            continue        # chroma has no +-3 taps
        rows = ys + torch.clamp(torch.full_like(reach, o), -reach, reach)
        assert np.array_equal(rows.numpy() + b, rowsel[k]), (k, o)
        assert int(torch.clamp(rows, 0, H - 1).sub(rows).abs().max()) <= b
    assert np.array_equal((reach == 0).numpy(), vbsel != 0)


# ---- CC-ALF -----------------------------------------------------------------

@pytest.mark.parametrize("bd,hs,vs,cs,Hc,Wc,seed", [
    (10, 1, 1, 64, 36, 52, 0),     # 4:2:0, CTB 64, ragged
    (8, 1, 0, 32, 40, 28, 1),      # 4:2:2, CTB 32
    (12, 0, 0, 32, 24, 40, 2),     # 4:4:4, CTB 32
])
def test_cc_twin_matches_jax(bd, hs, vs, cs, Hc, Wc, seed):
    """Both chroma planes through one call, coefficients by index and rows
    from the row number, against the JAX kernel on each plane with the JAX
    package's row tables (`_cc_arrays`); then one plane alone."""
    rng = np.random.default_rng(seed)
    dsts, luma16, ctb_sets, cf_tabs = cc_inputs(rng, Hc, Wc, cs, hs, vs, bd)
    luma = luma16.astype(np.int32)
    b = 3
    pix_max, half = (1 << bd) - 1, 1 << (bd - 1)
    csv, csh = cs >> vs, cs >> hs
    rowsel, skip = jfd._cc_arrays(Hc, cs, vs)
    P3l = np.pad(luma, b, mode="edge")
    # JAX Pallas: collocated luma, 7 tap planes, 7 coefficient planes

    def at(j, dx):
        return P3l[rowsel[j]][:, b + dx:b + dx + ((Wc - 1) << hs) + 1:1 << hs]
    taps = ((0, 0), (1, -1), (1, 1), (2, -1), (2, 0), (2, 1), (3, 0))
    v = np.stack([at(rk, dx) for rk, dx in taps])
    wants = []
    for dst16, ctb_set, cf_tab in zip(dsts, ctb_sets, cf_tabs):
        dst = dst16.astype(np.int32)
        cf = cf_tab[ctb_set]                           # [ch, cw, 7]
        cf_px = np.stack([px(cf[:, :, j], csv, csh, Hc, Wc)
                          for j in range(7)])
        cf_skip = np.where(skip[None, :, None] != 0, 0, cf_px)
        want = jalf._cc_pallas(dst, at(1, 0), v, cf_skip, half, pix_max)
        fused = jfd._cc_filter(jnp.asarray(dst), jnp.asarray(P3l),
                               jnp.asarray(rowsel), jnp.asarray(skip),
                               {j: jnp.asarray(cf_px[j]) for j in range(7)},
                               hs, half, pix_max)
        same(fused, want)
        assert not np.array_equal(np.asarray(want), dst), \
            "CC-ALF changed nothing"
        wants.append(np.asarray(want))
    t = torch.from_numpy
    for n in (2, 1):
        args = ([t(d) for d in dsts[:n]], t(luma16),
                [t(x) for x in ctb_sets[:n]], [t(x) for x in cf_tabs[:n]],
                csv, csh, hs, vs, half, pix_max)
        for fn in (alf_device.cc_filter_ref, alf_device.cc_filter):
            got = fn(*args)
            assert len(got) == n and got[0].dtype == torch.int16
            for g, w in zip(got, wants):
                same(g, w)


@pytest.mark.parametrize("vs", [0, 1])
@pytest.mark.parametrize("cs,H", [(32, 1080), (64, 1080), (128, 1080),
                                  (32, 96), (64, 200), (128, 240)])
def test_cc_rows_match_row_tables(cs, vs, H):
    """The luma tap rows CC-ALF computes from the chroma row number
    (`cc_row_offsets`) equal the JAX package's row tables (`_cc_arrays`),
    also in a last CTB row that is partial (1080 = 33 * 32 + 24)."""
    Hc = H >> vs
    rowsel, skip = jfd._cc_arrays(Hc, cs, vs)
    ys = torch.arange(Hc)
    offs, skips = alf_device.cc_row_offsets(ys, cs >> vs, vs)
    rows = (ys << vs)[None, :] + offs
    # the table indexes a luma plane padded by 3 rows, which the plain
    # version and the kernel replace by clamping to the picture
    assert int(rows.min()) >= -3 and int(rows.max()) <= H + 2
    assert np.array_equal(rows.numpy() + 3, rowsel)
    assert np.array_equal(skips.numpy(), skip != 0)
    assert skips.any() == (vs == 0)


# ---- plain PyTorch stages of the chain --------------------------------------

def _deblock_case(rng, bd, H, W, vertical, chroma, n):
    """A blocky plane (8x8 steps over a ramp, light noise) and n edge
    segments on the 8-sample grid, padded with zero segments to a power of
    two as the chain pads them."""
    base = (np.add.outer(np.arange(H), np.arange(W)) * 2) % (1 << bd)
    steps = px(rng.integers(-6, 7, (H // 8 + 1, W // 8 + 1)) << (bd - 8),
               8, 8, H, W)
    plane = np.clip(base + steps + rng.integers(0, 2, (H, W)), 0,
                    (1 << bd) - 1).astype(np.int32)
    size = rng.choice([2, 4], n) if chroma else None
    along = (H if vertical else W) - 4
    a = np.zeros((7, deblock_device._pad_pow2(n)), np.int32)
    a[0 if vertical else 1, :n] = rng.integers(1, (W if vertical else H) // 8,
                                               n) * 8
    a[1 if vertical else 0, :n] = rng.integers(0, along // 4 + 1, n) * 4
    a[2, :n] = rng.integers(1, 12, n) << max(0, bd - 8)       # tc
    a[3, :n] = rng.integers(16, 64, n) << (bd - 8)            # beta
    ml = [1, 3] if chroma else [1, 2, 3, 5, 7]
    a[4, :n] = rng.choice(ml, n)
    a[5, :n] = rng.choice(ml, n)
    a[6, :n] = size if chroma else rng.integers(0, 2, n)
    return plane, a


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("bd,vertical,seed", [
    (8, True, 0), (10, False, 1), (12, True, 2), (10, True, 3)])
def test_deblock_math_matches_jax(chroma, bd, vertical, seed):
    rng = np.random.default_rng(seed)
    plane, a = _deblock_case(rng, bd, 64, 96, vertical, chroma, 40)
    pix_max = (1 << bd) - 1
    jfn = jdb._chroma_jit if chroma else jdb._luma_jit
    want = jfn(jnp.asarray(plane), *[jnp.asarray(r) for r in a],
               vertical, pix_max)
    fn = deblock_device.chroma_math if chroma else deblock_device.luma_math
    got = fn(torch.from_numpy(plane), *torch.from_numpy(a).unbind(0),
             vertical, pix_max)
    same(got, want)
    assert not np.array_equal(np.asarray(want), plane), "no edge filtered"


@pytest.mark.parametrize("bd,cs,H,W,binary,seed", [
    (10, 64, 72, 96, False, 0),
    (8, 32, 48, 64, False, 1),
    (12, 32, 40, 48, True, 2),     # 0/4095 samples: products past 2^32
])
def test_alf_classify_matches_jax(bd, cs, H, W, binary, seed, monkeypatch):
    rng = np.random.default_rng(seed)
    if binary:
        plane = rng.integers(0, 2, (H, W)) * ((1 << bd) - 1)
    else:
        plane = rng.integers(0, 1 << bd, (H, W))
    P3 = np.pad(plane.astype(np.int32), 3, mode="edge")
    r0, r3, s1, e3, ac = fused_device._cls_arrays(H, cs)
    want = jfd._alf_classify(jnp.asarray(P3), r0, r3, s1, e3, ac, H // 4,
                             W // 4, bd)
    biggest = []
    real = fused_device._prod_le

    def recording(a, b, c, d):
        biggest.append(int(max((a.long() * b.long()).max(),
                               (c.long() * d.long()).max())))
        return real(a, b, c, d)
    monkeypatch.setattr(fused_device, "_prod_le", recording)
    t = torch.from_numpy
    got = fused_device.alf_classify(t(P3), t(r0).long(), t(r3).long(),
                                    t(s1), t(e3), t(ac), H // 4, W // 4, bd)
    same(got[0], want[0])
    same(got[1], want[1])
    if binary:
        assert max(biggest) >= 1 << 32, "no product past 32 bits"


# ---- the launch rule and the counters (ops/device.py) -----------------------

def _meta_calls():
    """Each hand-kernel wrapper's smallest call on "meta" tensors, with the
    name of its plain twin."""
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")
    i16, i32 = torch.int16, torch.int32
    planes, buckets = put_inputs(np.random.default_rng(2), 32, 64, 10,
                                 blocks=2)
    table, _ = mc_device.put_table_of(buckets[:3])
    return {
        "sao_apply": (sao_device, "sao_apply_ref",
                      lambda: sao_device.sao_apply(
                          [z((16, 16), i16)], [z((11, 1, 1), i32)],
                          [(16, 16)], 3, 255)),
        "alf_filter_luma": (alf_device, "alf_filter_luma_ref",
                            lambda: alf_device.alf_filter_luma(
                                z((32, 32), i16), z((8, 8), i32),
                                z((8, 8), i32), z((1, 1), i32),
                                z((1, 25, 12), i32), z((1, 25, 12), i32), 32,
                                255, edges=z((1, 1), i32))),
        "alf_filter_chroma": (alf_device, "alf_filter_chroma_ref",
                              lambda: alf_device.alf_filter_chroma(
                                  [z((16, 16), i16)], [z((1, 1), i32)],
                                  [z((1, 12), i32)], [z((1, 12), i32)], 16,
                                  16, 255)),
        "cc_filter": (alf_device, "cc_filter_ref",
                      lambda: alf_device.cc_filter(
                          [z((16, 16), i16)], z((32, 32), i16),
                          [z((1, 1), i32)], [z((1, 7), i32)], 16, 16, 1, 1,
                          128, 255)),
        "put_table": (mc_device, "put_table_ref",
                      lambda: mc_device.put_table(
                          [z(p.shape, i16) for p in planes], table, 10)),
    }


@pytest.mark.parametrize("name", ["sao_apply", "alf_filter_luma",
                                  "alf_filter_chroma", "cc_filter",
                                  "put_table"])
def test_wrapper_on_another_device_raises_before_anything_runs(
        name, monkeypatch):
    """Tensors on a device that is neither the CPU nor CUDA: the wrapper
    raises ValueError before its twin runs, a byte is counted or a launch
    is counted."""
    mod, twin, call = _meta_calls()[name]
    fn = getattr(mod, name)

    def ran(*a, **k):
        raise AssertionError(f"{twin} ran")
    monkeypatch.setattr(mod, twin, ran)
    before = (fn.launches, fn.edge_launches, dict(fn.launches_by_device),
              mc_device.stats["up_bytes"])
    with pytest.raises(ValueError, match="unsupported device meta"):
        call()
    assert (fn.launches, fn.edge_launches, dict(fn.launches_by_device),
            mc_device.stats["up_bytes"]) == before


def test_put_table_keeps_its_table_alive_through_the_launch(monkeypatch):
    """The packed table the put kernel reads is still alive when the
    kernel's launcher is called, so that no other allocation can take its
    memory before the launch is enqueued.  The call takes the card's path
    on "meta" tensors, with the library's launcher a spy that collects
    garbage and then looks at the table through a weak reference."""
    planes, buckets = put_inputs(np.random.default_rng(2), 32, 64, 10,
                                 blocks=2)
    table, _ = mc_device.put_table_of(buckets[:3])
    meta = torch.device("meta")
    sent, alive = [], []
    upload = mc_device.upload

    def spy_upload(a, dev, counters):
        t = upload(a, dev, counters)
        sent.append(weakref.ref(t))
        return t

    class Lib:
        def ffvvc_mc_put(self, *args):
            gc.collect()
            alive.append([r() is not None for r in sent])
            return 0
    fn = mc_device.put_table
    for k in ("launches", "edge_launches"):
        monkeypatch.setattr(fn, k, 0)
    monkeypatch.setattr(fn, "launches_by_device", {})
    for k in ("up_bytes", "launches"):
        monkeypatch.setitem(mc_device.stats, k, 0)
    monkeypatch.setattr(mc_device, "kernel_device", lambda *a: meta)
    monkeypatch.setattr(mc_device, "upload", spy_upload)
    monkeypatch.setattr(device._build, "lib", lambda: Lib())
    monkeypatch.setattr(device, "stream_of", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    out = fn([torch.from_numpy(p).to(meta) for p in planes], table, 10)
    assert alive == [[True]]
    assert out.shape == (table.n_out,) and fn.launches == 1


# every module's counters: reset_stats sets each declared key back to its
# start value
COUNTED = {"sao": sao_device, "alf": alf_device, "deblock": deblock_device,
           "lmcs": lmcs_device, "fused": fused_device, "mc": mc_device,
           "itx": itx, "intra": intra_device}


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_reset_stats_zeroes_every_declared_key(name):
    stats = COUNTED[name].stats
    keys = set(stats)
    assert {"up_bytes", "down_bytes"} <= keys
    for k, v in stats.items():
        stats[k] = [7] * len(v) if isinstance(v, list) else 7
    COUNTED[name].reset_stats()
    assert set(stats) == keys
    for k, v in stats.items():
        assert v == ([0] * len(v) if isinstance(v, list) else 0), k
    # the start values are not shared with the counters: a second round
    # still starts from zero
    for v in stats.values():
        if isinstance(v, list):
            v[0] += 1
    COUNTED[name].reset_stats()
    assert all(not any(v) if isinstance(v, list) else v == 0
               for v in stats.values())
