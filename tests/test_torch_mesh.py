"""The port's mesh (`mesh_shape`, ffvvc_tpu_torch/parallel/) against the JAX
package, exactly.

  * decodes: twins of tests/test_mesh_decode.py on the same forged bytes
    (all-intra in four mesh shapes, inter, mixed RAP segments, odd height,
    inter-only defer and gop depth, CTU 128, device MC split over "tile"),
    plus a picture that forbids filtering across tiles and slices; each
    decodes on a mesh of "cpu" devices and must equal ffvvc_tpu's
    single-device host decode byte for byte;
  * passes: twins of `test_sao_sharded_matches_single_device`
    (tests/test_device_filters.py) for SAO, ALF, CC-ALF and deblocking — the
    port's sharded pass on a (1, t) mesh against the JAX package's
    single-device function on the same frame;
  * slab origin: for every cut of a small plane into two slabs, at CTB 32
    and 128, the concatenated slab outputs of each kernel's plain version
    equal its whole-picture output, with and without edge words and
    restore regions; with one halo row less some cut differs, which pins
    each halo of parallel/filters.py.
Inputs are numpy from a seed or forged bytes; every comparison is integer
equality (tolerance 0).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import forge as F  # noqa: E402
from test_device_filters import _fake_ctx
from test_torch_fused import TOOLS
from test_torch_stages import across_off_stream, copy_fb

from ffvvc_tpu.config import DecoderConfig as JaxConfig
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder
from ffvvc_tpu.ops import alf_device as jalf
from ffvvc_tpu.ops import deblock_device as jdb
from ffvvc_tpu.ops import sao_device as jsao
from ffvvc_tpu.sao import SaoFilter as JaxSaoFilter
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import alf_device, mc_device, sao_device
from ffvvc_tpu_torch.ops import fused_device as fd
from ffvvc_tpu_torch.ops.kernel_inputs import (alf_chroma_inputs,
                                               alf_luma_inputs, cc_inputs,
                                               edge_words, sao_inputs,
                                               sao_restore_inputs)
from ffvvc_tpu_torch.ops.device import Slab, as_wire
from ffvvc_tpu_torch.parallel import filters as PF
from ffvvc_tpu_torch.parallel.mesh import (cut_rows, exchange_row_halo,
                                           join_rows, make_mesh_exact)


def yuv(frames):
    return b"".join(f.to_yuv_bytes() for f in frames)


def jax_host_yuv(s):
    """ffvvc_tpu's single-device host decode (its inverse transforms on
    the host too: no JAX compile)."""
    old = os.environ.get("FFVVC_ITX")
    os.environ["FFVVC_ITX"] = "host"
    try:
        return yuv(JaxDecoder(JaxConfig()).decode(s))
    finally:
        if old is None:
            del os.environ["FFVVC_ITX"]
        else:
            os.environ["FFVVC_ITX"] = old


def mesh_yuv(s, mesh_shape, **kw):
    return yuv(VVCDecoder(DecoderConfig(
        device="cpu", mesh_shape=mesh_shape, **kw)).decode(s))


def _decode_both(s, mesh_shape, **kw):
    assert mesh_yuv(s, mesh_shape, **kw) == jax_host_yuv(s), \
        f"mesh {mesh_shape} decode differs from ffvvc_tpu's host decode"


# ---- decodes: twins of tests/test_mesh_decode.py ----------------------------

@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (4, 2), (8, 1)])
def test_allintra_mesh(mesh_shape):
    """All-intra frames batch over the full gop axis in one drain."""
    s = F.forge_inter_stream(slice_type=2, nframes=4, width=96, height=96,
                             seed=3, deblock=True, **TOOLS)
    _decode_both(s, mesh_shape)


@pytest.mark.parametrize("slice_type,mesh_shape", [(0, (2, 2)), (1, (1, 4))])
def test_inter_mesh(slice_type, mesh_shape):
    """Inter frames drain per frame at the MC reference barrier."""
    s = F.forge_inter_stream(slice_type=slice_type, nframes=4, width=96,
                             height=64, seed=1, deblock=True, **TOOLS)
    _decode_both(s, mesh_shape)


def test_mixed_rap_segments_mesh():
    """IDR-separated segments: drains at barriers mid-stream and at the end
    of the decode call."""
    a = F.forge_inter_stream(slice_type=2, nframes=2, width=64, height=64,
                             seed=5, deblock=True, **TOOLS)
    b = F.forge_inter_stream(slice_type=1, nframes=3, width=64, height=64,
                             seed=6, deblock=True, **TOOLS)
    _decode_both(a + b, (2, 4))


def test_odd_height_mesh():
    """Frame rows not divisible by the tile axis: slab padding (the edge
    row repeated) and slabs with no row of the picture."""
    s = F.forge_inter_stream(slice_type=2, nframes=2, width=64, height=80,
                             seed=2, deblock=True, **TOOLS)
    _decode_both(s, (1, 8))


def test_inter_only_defer_and_gop_depth(monkeypatch):
    """Sharded residual add for inter-only frames, and the RPL-aware
    selective drain: non-referenced B frames stay queued across inter
    reference barriers, so the final drain batches >1 frame."""

    class InterOnly(F.FuzzPolicy):
        """No intra / CIIP CUs in inter frames -> residual-add defers."""
        def __call__(self, tag, **ctx):
            if tag in ("pred_mode_flag", "ciip_flag"):
                return 0
            return super().__call__(tag, **ctx)

    SLICE_B, SLICE_P = 0, 1
    sps_r = F.build_sps(96, 96, bit_depth=10, min_qt_log2=3,
                        max_mtt_depth=1, sps_sao_enabled_flag=1)
    pps_r = F.build_pps(sps_r)
    stream = F.write_nal(F.NalType.SPS, F.write_sps(sps_r))
    stream += F.write_nal(F.NalType.PPS, F.write_pps(pps_r, sps_r))
    policy = InterOnly(7)
    for poc, st, rd in ((0, None, None), (2, SLICE_P, ([-2], [])),
                        (1, SLICE_B, ([-1], [1])), (4, SLICE_P, ([-2], [])),
                        (3, SLICE_B, ([-1], [1]))):
        nal, _ = F.forge_frame(sps_r, pps_r, policy, qp=32, poc=poc,
                               idr=st is None,
                               slice_type=2 if st is None else st,
                               ref_deltas=rd)
        stream += nal

    log = {"res_adds": 0, "final_batch": 0}
    add, drain = PF.MeshFilterQueue.add, PF.MeshFilterQueue.drain

    def spy_add(self, *a, **kw):
        log["res_adds"] += kw.get("res_planes") is not None
        return add(self, *a, **kw)

    def spy_drain(self, needed=None):
        if needed is None and self.q:
            log["final_batch"] = max(log["final_batch"], len(self.q))
        return drain(self, needed)
    monkeypatch.setattr(PF.MeshFilterQueue, "add", spy_add)
    monkeypatch.setattr(PF.MeshFilterQueue, "drain", spy_drain)
    _decode_both(stream, (2, 4))
    assert log["res_adds"] == 4, log
    assert log["final_batch"] >= 2, log


def test_large_ctu_mesh():
    """CTU-128 frames on the mesh: slab padding, deblock halos and ALF
    virtual boundaries at the largest CTB size."""
    s = F.forge_inter_stream(slice_type=1, nframes=2, width=256, height=256,
                             seed=2, deblock=True, ctu_log2=7,
                             sps_max_luma_transform_size_64_flag=1, **TOOLS)
    _decode_both(s, (2, 4))


def test_mesh_sharded_mc():
    """Device MC's put batches split over the mesh's "tile" axis (the
    reference plane on every device, the batch partitioned)."""
    for s in (F.forge_inter_stream(slice_type=0, nframes=4, width=96,
                                   height=64, seed=1, deblock=True,
                                   sps_sao_enabled_flag=1,
                                   sps_alf_enabled_flag=1),
              F.forge_hier_stream(seed=2, width=96, height=64, qp=32,
                                  ngops=2, deblock=True,
                                  sps_temporal_mvp_enabled_flag=1,
                                  sps_dmvr_enabled_flag=1,
                                  sps_bdof_enabled_flag=1)):
        before = mc_device.sharded_puts
        _decode_both(s, (2, 2), device_mc=True)
        assert mc_device.sharded_puts > before, "no sharded put engaged"


def test_across_off_mesh(monkeypatch):
    """Two tile columns, no filtering across tiles or slices: SAO's restore
    regions and the edge-word variants of ALF and CC-ALF, on slabs."""
    clamped = []
    real = PF._alf_params

    def spy(e):
        a = real(e)
        clamped.append(a is not None and a.clamped)
        return a
    monkeypatch.setattr(PF, "_alf_params", spy)
    _decode_both(across_off_stream(), (1, 2))
    assert clamped and all(clamped), clamped


def test_mesh_config():
    """A mesh constructs; its devices default to `device` repeated, a list
    takes the first gop * tile devices, too few raise."""
    cfg = DecoderConfig(device="cpu", mesh_shape=(2, 3))
    assert VVCDecoder(cfg)._mesh_q.mesh.shape == {"gop": 2, "tile": 3}
    m = make_mesh_exact((1, 2), ["cpu", "cpu", "cpu"])
    assert m.devices.shape == (1, 2) and m.device(0, 1) == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh_exact((2, 2), ["cpu"])


def test_row_cut_and_halo():
    """cut_rows pads with the edge row; exchange_row_halo hands each slab
    its neighbours' boundary rows; join_rows undoes the cut."""
    mesh = make_mesh_exact((1, 3), device="cpu")
    x = torch.arange(7 * 2).reshape(7, 2)
    slabs = cut_rows(x, mesh, 0, 3)
    assert [s.shape[0] for s in slabs] == [3, 3, 3]
    assert torch.equal(slabs[2][1:], x[6:].expand(2, 2))
    above, below = exchange_row_halo(slabs, 2)
    assert above[0] is None and below[2] is None
    assert torch.equal(above[1], x[1:3])
    assert torch.equal(below[1], x[6:].expand(2, 2))
    assert torch.equal(join_rows(slabs, 7, "cpu"), x)


# ---- passes: twins of test_sao_sharded_matches_single_device ----------------

def _slabs(plane, t, hs):
    mesh = make_mesh_exact((1, t), device="cpu")
    return cut_rows(torch.from_numpy(np.ascontiguousarray(plane)), mesh, 0,
                    hs)


@pytest.mark.parametrize("seed,ntiles,t", [(2, 1, 4), (1, 2, 3)])
def test_sao_sharded_matches_single_device(seed, ntiles, t):
    """Slab-sharded SAO, all planes of a slab in one call, == the JAX
    single-device SAO over `_rasterize_plane`'s maps (restore regions with
    two tiles)."""
    sps, pps, tabs, fb = _fake_ctx(seed, W=96, H=64, ntiles=ntiles)
    cuts = PF.frame_cuts(64, 32, t, 1, 3)
    planes = [[_slabs(as_wire(fb.planes[c]), t, cuts[c].hs)
               for c in range(3)]]
    e = {"sps": sps, "pps": pps, "tabs": tabs, "fb": fb}
    (got,) = PF.sao_batch_sharded(planes, [PF._sao_params(e, 3)],
                                  [(32, 32), (16, 16), (16, 16)], cuts,
                                  sps.bit_depth - 5, 255)
    jsf = JaxSaoFilter(sps, pps, tabs, fb)
    for c in range(3):
        plane = fb.planes[c]
        want = np.asarray(jsao._sao_xla(
            np.pad(plane, 1, mode="edge").astype(np.int32),
            *jsao._rasterize_plane(jsf, c, plane), sps.bit_depth - 5, 255))
        assert np.array_equal(join_rows(got[c], plane.shape[0],
                                        "cpu").numpy(), want), c


def _record(mod, name, stream, monkeypatch, **cfg):
    """(arguments, planes before, planes after) of every call of
    mod.name in a JAX decode with the toggles cfg."""
    calls = []
    real = getattr(mod, name)

    def recording(sps, pps, tabs, fb, *rest, **kw):
        before = copy_fb(fb)
        out = real(sps, pps, tabs, fb, *rest, **kw)
        calls.append(((sps, pps, tabs, before) + rest, copy_fb(fb)))
        return out
    monkeypatch.setattr(mod, name, recording)
    JaxDecoder(JaxConfig(**cfg)).decode(stream)
    monkeypatch.undo()
    assert calls, f"the JAX {name} never ran"
    return calls


@pytest.mark.parametrize("name,t", [("across_off", 3), ("tools", 2)])
def test_alf_cc_sharded_match_single_device(name, t, monkeypatch):
    """Slab-sharded ALF and CC-ALF (classification per slab, edge words
    where the picture needs them) == the JAX package's single-device
    `alf_frame_device` on every frame of a stream."""
    s = across_off_stream() if name == "across_off" else \
        F.forge_inter_stream(seed=3, nframes=2, deblock=True, **TOOLS)
    monkeypatch.setenv("FFVVC_ITX", "host")
    for (sps, pps, tabs, fb, sh_list, alf_list), want in _record(
            jalf, "alf_frame_device", s, monkeypatch, device_alf=True):
        e = {"sps": sps, "pps": pps, "tabs": tabs, "fb": fb,
             "sh_list": sh_list, "alf_list": alf_list}
        a = PF._alf_params(e)
        assert a.clamped == (name == "across_off")
        H, Hc = fb.planes[0].shape[0], fb.planes[1].shape[0]
        cuts = PF.frame_cuts(H, Hc, t, 1, 3)
        planes = [[_slabs(as_wire(fb.planes[c]), t, cuts[c].hs)
                   for c in range(3)]]
        cs, bd = sps.ctb_size_y, sps.bit_depth
        alf = PF.alf_batch_sharded(planes, [a], cuts, cs, bd, 1, 1)
        (got,) = PF.cc_batch_sharded([planes[0][0]], alf, [a], cuts, cs, bd,
                                     1, 1)
        for c in range(3):
            assert np.array_equal(join_rows(got[c], cuts[c].H, "cpu").numpy(),
                                  want.planes[c]), c


@pytest.mark.parametrize("t", [2, 4])
def test_deblock_sharded_matches_single_device(t, monkeypatch):
    """Slab-sharded deblocking (8-row halo, the segments near each slab)
    == the JAX package's single-device `deblock_frame_device`, both
    directions, on the segments of its own rasterizer."""
    s = F.forge_inter_stream(slice_type=0, nframes=3, width=96, height=64,
                             seed=1, deblock=True)
    monkeypatch.setenv("FFVVC_ITX", "host")
    for (sps, pps, tabs, fb, rpls), want in _record(
            jdb, "deblock_frame_device", s, monkeypatch,
            device_deblock=True):
        H, Hc = fb.planes[0].shape[0], fb.planes[1].shape[0]
        cuts = PF.frame_cuts(H, Hc, t, 1, 3)
        planes = [_slabs(fb.planes[c].astype(np.int32), t, cuts[c].hs)
                  for c in range(3)]
        for vertical in (True, False):
            ras = jdb.rasterize_deblock(sps, pps, tabs, fb, rpls, vertical)
            for c in range(3):
                segs = ras.luma_segs if c == 0 else ras.chroma_segs.get(c)
                (planes[c],) = PF.deblock_batch_sharded(
                    [planes[c]], [segs or []], "luma" if c == 0 else "chroma",
                    vertical, 255, cuts[c])
        for c in range(3):
            assert np.array_equal(join_rows(planes[c], cuts[c].H,
                                            "cpu").numpy(), want.planes[c])


# ---- slab origin: every cut of a plane equals the whole picture -------------

def _cuts_equal(whole, run, H, halo):
    """For every cut of H rows into [0, r) and [r, H): the two slabs, each
    given `halo` rows of the other, concatenated == whole.  Returns the
    cuts that differ."""
    bad = []
    for r in range(1, H):
        parts = [run(Slab(0, r, H, 0), 0, min(H, r + halo)),
                 run(Slab(r, H - r, H, min(halo, r)), max(0, r - halo), H)]
        if not torch.equal(torch.cat(parts), whole):
            bad.append(r)
    return bad


def _pin(whole, run, H, halo):
    """The halo suffices for every cut, and one row less does not."""
    assert not _cuts_equal(whole, run, H, halo)
    assert _cuts_equal(whole, run, H, halo - 1), "the halo is not the least"


@pytest.mark.parametrize("cs,H,W,restore,seed", [
    (32, 72, 64, False, 0), (32, 72, 64, True, 1),
    (128, 136, 64, True, 134)])     # both CTBs edge offset, not horizontal
def test_sao_slab_origin(cs, H, W, restore, seed):
    rng = np.random.default_rng(seed)
    if restore:
        plane, tab = sao_restore_inputs(rng, H, W, cs, cs, 10)
    else:
        plane, p = sao_inputs(rng, H, W, cs, cs, 10)
        tab = sao_device.pack_params(p, H, W, cs, cs)
    x, prm = torch.from_numpy(plane), torch.from_numpy(tab)

    def run(sl, lo, hi):
        return sao_device.sao_apply_ref([x[lo:hi]], [prm], [(cs, cs)], 5,
                                        1023, [sl])[0]
    whole = run(None, 0, H)
    _pin(whole, run, H, PF.SAO_HALO)


@pytest.mark.parametrize("cs,H,W,edges", [
    (32, 72, 64, False), (32, 72, 64, True), (128, 136, 64, True)])
def test_alf_luma_slab_origin(cs, H, W, edges):
    """Classification per slab (`alf_classify_ctbs`) and the luma filter,
    as the mesh runs them."""
    rng = np.random.default_rng(cs + edges)
    src, _, _, ctb_set, cf, cl = (torch.from_numpy(a) for a in
                                  alf_luma_inputs(rng, H, W, cs, 10))
    words = torch.from_numpy(edge_words(rng, -(-H // cs), -(-W // cs)))
    e = words if edges else None

    def run(sl, lo, hi):
        y = src[lo:hi]
        ci, ti = fd.alf_classify_ctbs(y, words, cs, 10, sl)
        return alf_device.alf_filter_luma_ref(y, ci, ti, ctb_set, cf, cl, cs,
                                              1023, e, sl)
    whole = run(None, 0, H)
    _pin(whole, run, H, PF.ALF_LUMA_HALO)


@pytest.mark.parametrize("cs,H,W,edges", [
    (16, 40, 32, False), (16, 40, 32, True), (64, 72, 32, True)])
def test_alf_chroma_slab_origin(cs, H, W, edges):
    rng = np.random.default_rng(cs + edges)
    a = [alf_chroma_inputs(rng, H, W, cs, cs, 10) for _ in range(2)]
    srcs = [torch.from_numpy(x[0]) for x in a]
    rest = [[torch.from_numpy(x[k]) for x in a] for k in (1, 2, 3)]
    e = torch.from_numpy(edge_words(rng, -(-H // cs), -(-W // cs))) \
        if edges else None

    def run(sl, lo, hi):
        return torch.stack(alf_device.alf_filter_chroma_ref(
            [x[lo:hi] for x in srcs], *rest, cs, cs, 1023, e, sl), 1)
    whole = run(None, 0, H)
    _pin(whole, run, H, PF.ALF_CHROMA_HALO)


@pytest.mark.parametrize("cs,Hc,Wc,hs,vs,edges", [
    (32, 40, 32, 1, 1, False), (32, 40, 32, 1, 1, True),
    (32, 36, 32, 0, 0, True), (128, 72, 64, 1, 1, True)])
def test_cc_slab_origin(cs, Hc, Wc, hs, vs, edges):
    """CC-ALF of chroma slabs from the luma rows under them, with the luma
    halo; 4:4:4 (vs = 0) reads two rows below, which pins the halo."""
    rng = np.random.default_rng(cs + Hc + edges)
    dsts, luma, sets, cfs = cc_inputs(rng, Hc, Wc, cs, hs, vs, 10)
    dsts = [torch.from_numpy(d) for d in dsts]
    luma = torch.from_numpy(luma)
    sets = [torch.from_numpy(s) for s in sets]
    cfs = [torch.from_numpy(c) for c in cfs]
    csv, csh = cs >> vs, cs >> hs
    e = torch.from_numpy(edge_words(rng, -(-Hc // csv), -(-Wc // csh))) \
        if edges else None
    H = Hc << vs

    def runner(halo):
        """The chroma slab's own rows, the luma under them with `halo`
        rows of the neighbouring slabs."""
        def run(sl, lo, hi):
            top = min(sl.row0 << vs, halo)
            llo = (sl.row0 << vs) - top
            lhi = min(H, ((sl.row0 + sl.rows) << vs) + halo)
            ls = Slab(sl.row0 << vs, sl.rows << vs, H, top)
            return torch.stack(alf_device.cc_filter_ref(
                [d[lo:hi] for d in dsts], luma[llo:lhi], sets, cfs, csv, csh,
                hs, vs, 512, 1023, e, sl, ls), 1)
        return run
    whole = runner(0)(Slab.whole(Hc), 0, Hc)
    # chroma needs no halo (lo, hi: the slab's own rows)
    assert not _cuts_equal(whole, runner(PF.CC_LUMA_HALO), Hc, 0)
    if vs == 0:
        # one luma row less below a slab changes some cut
        assert _cuts_equal(whole, runner(PF.CC_LUMA_HALO - 1), Hc, 0), \
            "the luma halo is not the least"


@pytest.mark.parametrize("name", ["p_422", "p_444", "mono_lmcs", "ctu64",
                                  "p_12bit"])
def test_mesh_formats(name):
    """Chroma formats (the luma cut follows the chroma cut by the vertical
    subsampling, or stands alone without chroma), CTU sizes and bit
    depths on a (2, 3) mesh: tests/test_torch_fused.py's streams."""
    from test_torch_fused import stream
    _decode_both(stream(name), (2, 3))
