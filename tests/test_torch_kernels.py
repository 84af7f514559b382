"""The plain twins of the port's kernels against the JAX package, exactly.

Inputs come from `np.random.default_rng(seed)` and go, as the same numpy
arrays, through:
  * the JAX Pallas kernels `_sao_pallas`, `_alf_pallas` and `_cc_pallas`
    (interpret mode on the CPU, as the JAX package's own tests run them),
    fed the per-pixel planes they take, expanded here in numpy;
  * the JAX fused-chain forms `_sao_apply`, `_alf_filter_plane` and
    `_cc_filter`;
  * the port's twins (`sao_apply_ref`, `alf_filter_plane_ref`,
    `cc_filter_ref`) and their wrappers, which run the twins on CPU
    tensors.
The plain PyTorch stages of the chain — deblocking (`luma_math`,
`chroma_math`) and the ALF classification — are held against JAX's too.
Every comparison is integer equality (tolerance 0).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ffvvc_tpu.ops import alf_device as jalf
from ffvvc_tpu.ops import deblock_device as jdb
from ffvvc_tpu.ops import fused_device as jfd
from ffvvc_tpu.ops import sao_device as jsao
from ffvvc_tpu_torch.ops import alf_device, deblock_device, fused_device
from ffvvc_tpu_torch.ops import sao_device
from ffvvc_tpu_torch.ops.kernel_inputs import (alf_inputs, cc_inputs,
                                               sao_inputs)


def px(a, cs_v, cs_h, H, W):
    """numpy per-CTB/per-block [ch, cw] -> per-pixel [H, W]."""
    return np.repeat(np.repeat(a, cs_v, 0), cs_h, 1)[:H, :W]


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    assert np.array_equal(got.astype(np.int64),
                          np.asarray(want).astype(np.int64))


# ---- SAO --------------------------------------------------------------------

@pytest.mark.parametrize("bd,cs_v,cs_h,H,W,seed", [
    (8, 32, 32, 72, 104, 0),     # luma, CTB 32, ragged right/bottom CTBs
    (10, 64, 64, 88, 136, 1),    # luma, CTB 64
    (12, 16, 16, 36, 52, 2),     # 4:2:0 chroma of CTB 32
    (10, 64, 32, 64, 40, 3),     # 4:2:2 chroma of CTB 64
])
def test_sao_twin_matches_jax(bd, cs_v, cs_h, H, W, seed):
    rng = np.random.default_rng(seed)
    plane, p = sao_inputs(rng, H, W, cs_v, cs_h, bd)
    shift, pix_max = bd - 5, (1 << bd) - 1
    # JAX Pallas: per-pixel maps and the keep map expanded in numpy
    e = {k: px(v, cs_v, cs_h, H, W) for k, v in p.items() if k != "offs"}
    offs = np.stack([px(p["offs"][k], cs_v, cs_h, H, W) for k in range(5)])
    xs = np.arange(W)[None, :]
    ys = np.arange(H)[:, None]
    in_x = ((xs & (cs_h - 1)) >= e["ax"]) & ((xs & (cs_h - 1)) < e["bx"])
    keep = ((xs == 0) & (e["kl"] != 0)) | ((xs == W - 1) & (e["kr"] != 0)) \
        | ((ys == 0) & (e["kt"] != 0) & in_x) \
        | ((ys == H - 1) & (e["kb"] != 0) & in_x)
    want = jsao._sao_pallas(np.pad(plane, 1, mode="edge"), e["typ"],
                            e["m1"], offs, keep.astype(np.int32), shift,
                            pix_max)
    fused = jfd._sao_apply(jnp.asarray(plane),
                           {k: jnp.asarray(v) for k, v in p.items()},
                           cs_v, cs_h, shift, pix_max)
    same(fused, want)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    args = (torch.from_numpy(plane), tp, cs_v, cs_h, shift, pix_max)
    same(sao_device.sao_apply_ref(*args), want)
    same(sao_device.sao_apply(*args), want)
    assert not np.array_equal(np.asarray(want), plane), "SAO changed nothing"


# ---- ALF --------------------------------------------------------------------

@pytest.mark.parametrize("bd,luma,cs_v,cs_h,H,W,seed", [
    (10, True, 64, 64, 72, 96, 0),     # luma CTB 64, ragged bottom CTB row
    (8, True, 32, 32, 48, 40, 1),      # luma CTB 32
    (12, False, 32, 32, 36, 52, 2),    # 4:2:0 chroma of CTB 64
    (10, False, 32, 16, 40, 44, 3),    # 4:2:2 chroma of CTB 32
])
def test_alf_twin_matches_jax(bd, luma, cs_v, cs_h, H, W, seed):
    rng = np.random.default_rng(seed)
    cur, rowsel, vbsel, cf, cl, l2h, l2w = alf_inputs(rng, H, W, cs_v, cs_h,
                                                      bd, luma)
    b = 3 if luma else 2
    pix_max = (1 << bd) - 1
    slots = range(12) if luma else alf_device._CHROMA_SLOT
    P3 = np.pad(cur, b, mode="edge")
    # JAX Pallas: the 48-plane form (tap samples, coefficients, clips)
    v0 = np.repeat(cur[None], 12, 0)
    v1 = v0.copy()
    for s in slots:
        ka, da, kb, db = alf_device._LUMA_TAPS[s]
        v0[s] = P3[rowsel[ka]][:, b + da:b + da + W]
        v1[s] = P3[rowsel[kb]][:, b + db:b + db + W]
    cf_px = np.stack([px(cf[:, :, s], 1 << l2h, 1 << l2w, H, W)
                      for s in range(12)])
    cl_px = np.stack([px(cl[:, :, s], 1 << l2h, 1 << l2w, H, W)
                      for s in range(12)])
    vb_px = np.repeat(vbsel[:, None], W, 1)
    want = jalf._alf_pallas(cur, v0, v1, cf_px, cl_px, vb_px, pix_max)
    taps = tuple(alf_device._LUMA_TAPS[s] for s in slots)
    fused = jfd._alf_filter_plane(
        jnp.asarray(cur), jnp.asarray(P3), jnp.asarray(rowsel),
        jnp.asarray(vbsel), {s: jnp.asarray(cf_px[s]) for s in slots},
        {s: jnp.asarray(cl_px[s]) for s in slots}, taps, slots, b, pix_max)
    same(fused, want)
    tcur = torch.from_numpy(cur)
    args = (tcur, sao_device.pad_edge(tcur, b), torch.from_numpy(rowsel).long(),
            torch.from_numpy(vbsel), torch.from_numpy(cf),
            torch.from_numpy(cl), l2h, l2w,
            alf_device.LUMA_SLOTS if luma else alf_device.CHROMA_SLOTS, b,
            pix_max)
    same(alf_device.alf_filter_plane_ref(*args), want)
    same(alf_device.alf_filter_plane(*args), want)
    assert not np.array_equal(np.asarray(want), cur), "ALF changed nothing"


# ---- CC-ALF -----------------------------------------------------------------

@pytest.mark.parametrize("bd,hs,vs,cs,Hc,Wc,seed", [
    (10, 1, 1, 64, 36, 52, 0),     # 4:2:0, CTB 64, ragged
    (8, 1, 0, 32, 40, 28, 1),      # 4:2:2, CTB 32
    (12, 0, 0, 32, 24, 40, 2),     # 4:4:4, CTB 32
])
def test_cc_twin_matches_jax(bd, hs, vs, cs, Hc, Wc, seed):
    rng = np.random.default_rng(seed)
    dst, luma, rowsel, skip, cf = cc_inputs(rng, Hc, Wc, cs, hs, vs, bd)
    b = 3
    pix_max, half = (1 << bd) - 1, 1 << (bd - 1)
    csv, csh = cs >> vs, cs >> hs
    P3l = np.pad(luma, b, mode="edge")
    # JAX Pallas: collocated luma, 7 tap planes, 7 coefficient planes

    def at(j, dx):
        return P3l[rowsel[j]][:, b + dx:b + dx + ((Wc - 1) << hs) + 1:1 << hs]
    taps = ((0, 0), (1, -1), (1, 1), (2, -1), (2, 0), (2, 1), (3, 0))
    v = np.stack([at(rk, dx) for rk, dx in taps])
    cf_px = np.stack([px(cf[:, :, j], csv, csh, Hc, Wc) for j in range(7)])
    cf_skip = np.where(skip[None, :, None] != 0, 0, cf_px)
    want = jalf._cc_pallas(dst, at(1, 0), v, cf_skip, half, pix_max)
    fused = jfd._cc_filter(jnp.asarray(dst), jnp.asarray(P3l),
                           jnp.asarray(rowsel), jnp.asarray(skip),
                           {j: jnp.asarray(cf_px[j]) for j in range(7)}, hs,
                           half, pix_max)
    same(fused, want)
    args = (torch.from_numpy(dst), sao_device.pad_edge(torch.from_numpy(luma),
                                                       b),
            torch.from_numpy(rowsel).long(), torch.from_numpy(skip),
            torch.from_numpy(cf), csv, csh, hs, half, pix_max)
    same(alf_device.cc_filter_ref(*args), want)
    same(alf_device.cc_filter(*args), want)
    assert not np.array_equal(np.asarray(want), dst), "CC-ALF changed nothing"


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
