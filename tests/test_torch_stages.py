"""The port's per-stage device filters against the JAX package, exactly.

`device_sao`, `device_alf`, `device_deblock` and `device_lmcs` of the port
(device="cpu": the kernels' plain versions) against the same toggles of
ffvvc_tpu and against its host decode, byte for byte:

  * twins of tests/test_device_filters.py with the same seeds and streams
    (`test_sao_device_matches_host`, `test_sao_device_10bit`,
    `test_alf_device_matches_host`, `test_device_deblock_matches_host`,
    `test_device_deblock_tiles`, `test_device_deblock_ladf_fallback`);
  * streams whose tiles and slices forbid filtering across their
    boundaries, which the fused chain declines: all four toggles together,
    alone, and beside `device_pipeline`;
  * kernel level: the plain versions with restore regions (SAO) and per-CTB
    edge words (ALF, CC-ALF) against the JAX Pallas kernels (interpret mode)
    over the planes the JAX rasterizers build, and the per-CTB
    classification against the golden model's `AlfFilter._classify`.
Inputs are numpy from a seed or forged bytes; every comparison is integer
equality (tolerance 0).
"""
import functools
import types

import numpy as np
import pytest
import torch

from test_device_filters import _fake_ctx
from test_torch_fused import TOOLS
from forge import forge_inter_stream, forge_tiled_stream

from ffvvc_tpu import alf as jgolden
from ffvvc_tpu.config import DecoderConfig as JaxConfig
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder
from ffvvc_tpu.ops import alf_device as jalf
from ffvvc_tpu.ops import sao_device as jsao
from ffvvc_tpu.sao import SaoFilter as JaxSaoFilter
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import alf_device, sao_device
from ffvvc_tpu_torch.ops.device import as_wire
from ffvvc_tpu_torch.ops import fused_device as fd
from ffvvc_tpu_torch.ops.kernel_inputs import edge_words

STAGES = dict(device_lmcs=True, device_deblock=True, device_sao=True,
              device_alf=True)


def jax_yuv(s, **kw):
    cfg = JaxConfig(**kw) if kw else JaxConfig(backend="golden")
    return b"".join(f.to_yuv_bytes() for f in JaxDecoder(cfg).decode(s))


def port_yuv(s, **kw):
    frames = VVCDecoder(DecoderConfig(device="cpu", **kw)).decode(s)
    return b"".join(f.to_yuv_bytes() for f in frames)


def copy_fb(fb):
    return types.SimpleNamespace(planes=[np.array(p) for p in fb.planes])


# ---- SAO ----------------------------------------------------------------------

def _check_sao_frame(seed, **ctx):
    """Random SAO parameters and a random slice map; for odd seeds one tile
    per CTB column (the densest restore pattern there is)."""
    sps, pps, tabs, fb = _fake_ctx(seed, **ctx)
    host, jax_dev = copy_fb(fb), copy_fb(fb)
    JaxSaoFilter(sps, pps, tabs, host).sao_frame()
    jsao.sao_frame_device(sps, pps, tabs, jax_dev, force_pallas=True)
    sao_device.sao_frame_device(sps, pps, tabs, fb, "cpu")
    for c in range(3):
        assert np.array_equal(fb.planes[c], host.planes[c]), f"plane {c}"
        assert np.array_equal(fb.planes[c], jax_dev.planes[c]), f"plane {c}"


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_sao_device_matches_host(seed):
    _check_sao_frame(seed, ntiles=1 + seed % 2)


@pytest.mark.parametrize("seed", [7])
def test_sao_device_10bit(seed):
    _check_sao_frame(seed, bit_depth=10)


@pytest.mark.parametrize("seed,bd,size", [
    (1, 8, (96, 64)), (3, 10, (96, 64)), (5, 8, (104, 72)),
    (7, 10, (136, 88))])
def test_sao_restore_twin_matches_jax(seed, bd, size):
    """`sao_apply_ref` over the per-CTB table with kept ranges against the
    JAX Pallas kernel over the per-pixel maps of `_rasterize_plane`, on
    pictures whose last CTB column and row are partial too."""
    W, H = size
    sps, pps, tabs, fb = _fake_ctx(seed, W=W, H=H, bit_depth=bd,
                                   ntiles=1 + seed % 2)
    tables = sao_device.ctb_tables(sao_device.SaoFilter(sps, pps, tabs, fb),
                                   3)
    jsf = JaxSaoFilter(sps, pps, tabs, fb)
    kept = 0
    for c in range(3):
        plane = fb.planes[c]
        typ, m1, offs, keep = jsao._rasterize_plane(jsf, c, plane)
        want = np.asarray(jsao._sao_pallas(
            np.pad(plane, 1, mode="edge").astype(np.int32), typ, m1, offs,
            keep, bd - 5, (1 << bd) - 1))
        cs = sps.ctb_size_y
        args = ([torch.from_numpy(as_wire(plane))],
                [torch.from_numpy(tables[c])],
                [(cs >> sps.vshift[c], cs >> sps.hshift[c])], bd - 5,
                (1 << bd) - 1)
        for fn in (sao_device.sao_apply_ref, sao_device.sao_apply):
            (got,) = fn(*args)
            assert got.dtype == torch.int16
            assert np.array_equal(got.numpy(), want), f"plane {c}"
        # samples kept inside the picture, not only on its border
        kept += int(keep[1:-1, 1:-1].sum())
    assert kept > 0, "no restore region inside the picture"


# ---- ALF and CC-ALF -----------------------------------------------------------

@pytest.mark.parametrize("seed,tools,pallas", [
    (2, dict(sps_alf_enabled_flag=1), True),
    (3, dict(sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1), True),
    (3, TOOLS, False)])
def test_alf_device_matches_host(seed, tools, pallas, monkeypatch):
    s = forge_inter_stream(seed=seed, nframes=3, deblock=True, **tools)
    host = jax_yuv(s)
    assert port_yuv(s, device_alf=True) == host
    if pallas:
        monkeypatch.setattr(jalf, "alf_frame_device", functools.partial(
            jalf.alf_frame_device, force_pallas=True))
    assert jax_yuv(s, device_alf=True) == host


def across_off_stream(**kw):
    """Two tile columns, no filtering across tiles or slices, every filter
    on: the fused chain declines it."""
    kw = dict(dict(width=128, height=96, bit_depth=10), **kw)
    return forge_inter_stream(
        slice_type=2, seed=3, nframes=2, deblock=True, info_in_ph=True,
        pps_kw={"lf_across_tiles": 0, "lf_across_slices": 0}, **TOOLS, **kw)


def _record_alf_frames(stream, monkeypatch):
    """The arguments of every `alf_frame_device` call of a JAX decode with
    device_alf, the planes as they were before the call."""
    calls = []
    real = jalf.alf_frame_device

    def recording(sps, pps, tabs, fb, sh_list, alf_list, **kw):
        calls.append((sps, pps, tabs, copy_fb(fb), sh_list, alf_list))
        return real(sps, pps, tabs, fb, sh_list, alf_list, **kw)
    monkeypatch.setattr(jalf, "alf_frame_device", recording)
    JaxDecoder(JaxConfig(device_alf=True)).decode(stream)
    monkeypatch.undo()
    assert calls, "the JAX device ALF never ran"
    return calls


def _golden_classes(ras, luma, edges, cs):
    """Class and transpose index of every 4x4 block by the golden model:
    `AlfFilter._classify` on `AlfFilter._window` of every CTB."""
    H, W = luma.shape
    ci = np.zeros((H // 4, W // 4), np.int32)
    ti = np.zeros_like(ci)
    for ry in range(edges.shape[0]):
        for rx in range(edges.shape[1]):
            x0, y0 = rx * cs, ry * cs
            w, h = min(cs, W - x0), min(cs, H - y0)
            e = [bool(edges[ry, rx] & b) for b in (1, 2, 4, 8)]
            win = jgolden.AlfFilter._window(luma, x0, y0, w, h, 3, e)
            c, t = jgolden.AlfFilter._classify(ras, win, w, h, cs - 4)
            ci[y0 // 4:(y0 + h) // 4, x0 // 4:(x0 + w) // 4] = c
            ti[y0 // 4:(y0 + h) // 4, x0 // 4:(x0 + w) // 4] = t
    return ci, ti


@pytest.mark.parametrize("kw", [
    dict(), dict(chroma=2, width=96, height=96, bit_depth=8),
    dict(chroma=3, width=96, height=64)],
    ids=["420_10bit", "422_8bit", "444_10bit"])
def test_alf_edge_twins_match_jax(kw, monkeypatch):
    """`alf_filter_luma_ref`, `alf_filter_chroma_ref` and `cc_filter_ref`
    with per-CTB edge words, parameters by index and rows from the row
    number, against `_alf_pallas` and `_cc_pallas` over the tap, coefficient
    and clip planes that `_AlfRasterizer.rasterize()` builds, on every frame
    of a stream with tile boundaries that filtering must not cross; the
    per-CTB classification against the golden model on the same frames."""
    t = torch.from_numpy
    for sps, pps, tabs, fb, sh_list, alf_list in _record_alf_frames(
            across_off_stream(**kw), monkeypatch):
        ras = jalf._AlfRasterizer(sps, pps, tabs, fb, sh_list, alf_list)
        maps = ras.rasterize()
        bd, cs = sps.bit_depth, sps.ctb_size_y
        pix_max, half = (1 << bd) - 1, 1 << (bd - 1)
        hs, vs = sps.hshift[1], sps.vshift[1]
        csv, csh = cs >> vs, cs >> hs
        ap = {k: t(v) for k, v in fd._alf_ctb_params(
            sps, pps, tabs, sh_list, alf_list).items()}
        words = alf_device.ctb_edges(ras)
        assert (words[:, 1:] & alf_device.EDGE_LEFT).any(), \
            "no clamped edge inside the picture"
        edges = t(words)
        pre = [t(as_wire(p)) for p in fb.planes]
        # classification
        ci, ti = _golden_classes(ras, np.asarray(fb.planes[0]), words, cs)
        got_ci, got_ti = fd.alf_classify_ctbs(pre[0], edges, cs, bd)
        assert np.array_equal(got_ci.numpy(), ci)
        assert np.array_equal(got_ti.numpy(), ti)
        # luma
        assert maps[0] is not None and maps[1] is not None
        m = maps[0]
        want = np.asarray(jalf._alf_pallas(m["cur"], m["v0"], m["v1"],
                                           m["cf"], m["cl"], m["vb"], pix_max))
        assert not np.array_equal(want, m["cur"]), "ALF changed nothing"
        args = (pre[0], t(ci), t(ti), ap["alf0_ctb_set"], ap["alf0_cf"],
                ap["alf0_cl"], cs, pix_max, edges)
        for fn in (alf_device.alf_filter_luma_ref, alf_device.alf_filter_luma):
            assert np.array_equal(fn(*args).numpy(), want)
        # chroma, both planes in one call
        wants = [np.asarray(jalf._alf_pallas(
            m["cur"], m["v0"], m["v1"], m["cf"], m["cl"], m["vb"], pix_max))
            for m in (maps[1], maps[2])]
        args = (pre[1:], [ap["alf1_set"], ap["alf2_set"]],
                [ap["alf1_cf"], ap["alf2_cf"]], [ap["alf1_cl"], ap["alf2_cl"]],
                csv, csh, pix_max, edges)
        for fn in (alf_device.alf_filter_chroma_ref,
                   alf_device.alf_filter_chroma):
            for g, w in zip(fn(*args), wants):
                assert np.array_equal(g.numpy(), w)
        # CC-ALF of the filtered chroma from the luma before ALF
        ccw = [np.asarray(jalf._cc_pallas(
            w.astype(np.int32), maps["cc", c]["curl"], maps["cc", c]["v"],
            maps["cc", c]["cf"], half, pix_max))
            for c, w in zip((1, 2), wants)]
        assert not np.array_equal(ccw[0], wants[0]), "CC-ALF changed nothing"
        args = ([t(w.astype(np.int16)) for w in wants], pre[0],
                [ap["cc1_set"], ap["cc2_set"]], [ap["cc1_cf"], ap["cc2_cf"]],
                csv, csh, hs, vs, half, pix_max, edges)
        for fn in (alf_device.cc_filter_ref, alf_device.cc_filter):
            for g, w in zip(fn(*args), ccw):
                assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("bd,cs,H,W,seed", [
    (10, 32, 72, 104, 0),      # last CTB column and row 8 samples
    (8, 64, 136, 96, 1),
    (12, 128, 144, 264, 2)])
def test_alf_classify_ctbs_matches_golden(bd, cs, H, W, seed):
    """The batched per-CTB classification with random edge words against
    `AlfFilter._classify` on `AlfFilter._window` of each CTB."""
    rng = np.random.default_rng(seed)
    # smooth waves of several directions under light noise, so that the
    # blocks fall into many classes
    yy, xx = np.mgrid[:H, :W]
    wave = (np.sin(xx / 3.0) * (yy < H // 2) + np.sin(yy / 2.5) * (xx < W // 2)
            + np.sin((xx + yy) / 4.0) + np.sin((xx - 2 * yy) / 5.0))
    luma = np.clip((wave * 0.12 + 0.5) * (1 << bd)
                   + rng.integers(-2, 3, (H, W)), 0,
                   (1 << bd) - 1).astype(np.int16)
    words = edge_words(rng, -(-H // cs), -(-W // cs))
    stub = types.SimpleNamespace(sps=types.SimpleNamespace(bit_depth=bd))
    ci, ti = _golden_classes(stub, luma, words, cs)
    got = fd.alf_classify_ctbs(torch.from_numpy(luma),
                               torch.from_numpy(words), cs, bd)
    assert got[0].dtype == torch.int32 and got[0].is_contiguous()
    assert np.array_equal(got[0].numpy(), ci)
    assert np.array_equal(got[1].numpy(), ti)
    assert len(np.unique(ci)) > 3 and len(np.unique(ti)) == 4


def test_ctb_edges_match_golden():
    """`ctb_edges` packs `AlfFilter._edges` of every CTB."""
    sps, pps, tabs, fb = _fake_ctx(1, ntiles=2)
    af = types.SimpleNamespace(pps=pps, tabs=tabs)
    af._edges = functools.partial(jgolden.AlfFilter._edges, af)
    words = alf_device.ctb_edges(af)
    for ry in range(pps.ctb_height):
        for rx in range(pps.ctb_width):
            want = jgolden.AlfFilter._edges(af, rx, ry)
            assert [bool(words[ry, rx] & b) for b in (1, 2, 4, 8)] == \
                [bool(e) for e in want]


# ---- deblock ------------------------------------------------------------------

def _check_deblock(s):
    host = jax_yuv(s)
    assert port_yuv(s, device_deblock=True) == host
    assert jax_yuv(s, device_deblock=True) == host


@pytest.mark.parametrize("kw", [
    dict(slice_type=2, nframes=2, width=96, height=96, seed=3,
         sps_sao_enabled_flag=1, sps_lmcs_enabled_flag=1),
    dict(slice_type=0, nframes=3, width=96, height=64, seed=1),
    dict(slice_type=1, nframes=3, width=64, height=80, seed=2),
    dict(slice_type=2, nframes=2, width=64, height=64, seed=4, bit_depth=10),
    dict(slice_type=0, nframes=3, width=128, height=128, seed=5, qp=38),
])
def test_device_deblock_matches_host(kw):
    _check_deblock(forge_inter_stream(deblock=True, **kw))


def test_device_deblock_tiles():
    _check_deblock(forge_tiled_stream(seed=2, nframes=2, width=96, height=96,
                                      rows=(2,), cols=(2,)))


def test_device_deblock_ladf_fallback(monkeypatch):
    """LADF reads pixel averages mid-pass: the entry point declines and the
    host deblock runs."""
    from ffvvc_tpu_torch.ops import deblock_device
    s = forge_inter_stream(seed=4, nframes=2, deblock=True,
                           sps_ladf_enabled_flag=1,
                           sps_num_ladf_intervals_minus2=1,
                           sps_ladf_lowest_interval_qp_offset=3,
                           sps_ladf_qp_offset=[-2, 4],
                           sps_ladf_delta_threshold_minus1=[30, 100])
    answers = []
    real = deblock_device.deblock_frame_device

    def recording(*a, **kw):
        answers.append(real(*a, **kw))
        return answers[-1]
    monkeypatch.setattr(deblock_device, "deblock_frame_device", recording)
    _check_deblock(s)
    assert answers and not any(answers)


def test_seg_array_padding():
    """Segments travel as int16 [7, B], B a power of two; the padding keeps
    tc, max-length p and q at 0, which switches every filter off."""
    from ffvvc_tpu_torch.ops.deblock_device import seg_array
    segs = [(8 * i, 4 * i, 5, 40, 3, 3, 1) for i in range(5)]
    a = seg_array(segs)
    assert a.dtype == np.int16 and a.shape == (7, 8)
    assert np.array_equal(a[:, :5].T, np.asarray(segs))
    assert not a[:, 5:].any()
    assert seg_array([]).shape == (7, 8) and not seg_array([]).any()
    assert seg_array(segs * 4).shape == (7, 32)


# ---- whole decodes ------------------------------------------------------------

@pytest.mark.parametrize("name", ["across_off", "tiled_slices"])
def test_stages_on_unfused_streams(name):
    """Pictures that forbid filtering across tiles and slices, all four
    toggles on: equal to ffvvc_tpu's decode with the same toggles and to its
    host decode; with `device_pipeline` beside them the fused chain declines
    every frame and the per-stage filters run."""
    if name == "across_off":
        s = across_off_stream()
    else:
        s = forge_tiled_stream(lf_across_tiles=0, lf_across_slices=0,
                               slices=[(0, 2), (2, 2)],
                               sps_sao_enabled_flag=1)
    host = jax_yuv(s)
    assert jax_yuv(s, **STAGES) == host
    assert port_yuv(s, **STAGES) == host
    fd.reset_stats()
    assert port_yuv(s, device_pipeline=True, **STAGES) == host
    assert fd.stats["frames"] == 0, "the fused chain took an across-off frame"


@pytest.mark.parametrize("toggle", sorted(STAGES))
def test_single_stage_toggle(toggle, monkeypatch):
    """Each toggle alone on a stream with every filter on, inter frames
    included (the row pipeline stands aside), and its entry point runs."""
    import importlib
    stage = toggle.split("_")[1]
    mod = importlib.import_module(f"ffvvc_tpu_torch.ops.{stage}_device")
    calls = []
    real = getattr(mod, f"{stage}_frame_device")

    def recording(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(mod, f"{stage}_frame_device", recording)
    s = forge_inter_stream(slice_type=1, nframes=3, width=96, height=96,
                           seed=7, deblock=True, **TOOLS)
    host = jax_yuv(s)
    assert port_yuv(s, **{toggle: True}) == host
    assert len(calls) == 3
    assert jax_yuv(s, **{toggle: True}) == host


def test_device_lmcs_stream():
    """`device_lmcs` alone on a mono stream whose only tool is LMCS, and on
    one where part of the slices do not use it."""
    s = forge_inter_stream(slice_type=1, nframes=3, width=96, height=96,
                           seed=9, chroma=0, deblock=True,
                           sps_lmcs_enabled_flag=1)
    host = jax_yuv(s)
    assert port_yuv(s, device_lmcs=True) == host
    assert jax_yuv(s, device_lmcs=True) == host


@pytest.mark.parametrize("name", ["p_422", "p_444", "ctu64", "b_10bit"])
def test_stages_formats(name):
    """All four toggles across chroma formats, CTU sizes and bit depths."""
    from test_torch_fused import stream
    s = stream(name)
    assert port_yuv(s, **STAGES) == jax_yuv(s)


def test_missing_cc_aps_skips_the_ctb():
    """A CTB whose CC-ALF APS is missing gets no correction: its set is 0,
    the zero coefficients."""
    sps = types.SimpleNamespace(bit_depth=8, chroma_format_idc=1)
    pps = types.SimpleNamespace(ctb_height=1, ctb_width=2)
    tabs = types.SimpleNamespace(
        alf_ctb_flag=np.zeros((2, 3), np.int32),
        alf_cc_idc=np.array([[1, 0], [1, 1]], np.int32),
        slice_idx=np.array([[0, 1]], np.int32))
    r = [types.SimpleNamespace(sh_alf_cc_cb_aps_id=0, sh_alf_cc_cr_aps_id=0),
         types.SimpleNamespace(sh_alf_cc_cb_aps_id=5, sh_alf_cc_cr_aps_id=0)]
    sh_list = [types.SimpleNamespace(r=x) for x in r]
    cc = np.arange(2 * 4 * 7).reshape(2, 4, 7)
    alf_list = {0: types.SimpleNamespace(cc_coeff=cc)}
    ap = fd._alf_ctb_params(sps, pps, tabs, sh_list, alf_list)
    assert ap["cc1_set"].tolist() == [[1, 0]]       # APS 5 is missing
    assert np.array_equal(ap["cc1_cf"], [np.zeros(7), cc[0][0]])
    assert ap["cc2_set"].tolist() == [[0, 1]]
    assert np.array_equal(ap["cc2_cf"][1], cc[1][0])


# ---- backend "golden" runs no device filter -----------------------------------

_ENTRY = {"device_sao": ("sao_device", "sao_frame_device"),
          "device_alf": ("alf_device", "alf_frame_device"),
          "device_deblock": ("deblock_device", "deblock_frame_device"),
          "device_lmcs": ("lmcs_device", "lmcs_frame_device"),
          "device_pipeline": ("fused_device", "fused_frame_filters")}


@pytest.mark.parametrize("toggle", sorted(_ENTRY))
def test_golden_backend_makes_no_device_calls(toggle, monkeypatch):
    """With backend="golden" a device filter toggle changes nothing: the
    Python model filters on the host, as in ffvvc_tpu, whose decoder
    requires its device backend at each of these stages; no entry point of
    a device filter is called, and the YUV equals the host decode."""
    import importlib
    calls = []
    for mod_name, fn_name in _ENTRY.values():
        mod = importlib.import_module(f"ffvvc_tpu_torch.ops.{mod_name}")
        real = getattr(mod, fn_name)

        def counting(*a, _real=real, **kw):
            calls.append(1)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, fn_name, counting)
    # the stream of ROADMAP.md fault 3.1, with ALF, CC-ALF and LMCS on too
    s = forge_inter_stream(slice_type=2, nframes=2, width=96, height=64,
                           seed=1, deblock=True, **TOOLS)
    assert port_yuv(s, backend="golden", **{toggle: True}) == jax_yuv(s)
    assert not calls
    # the same toggle under backend "cuda" (on device="cpu") does call it
    assert port_yuv(s, **{toggle: True}) == jax_yuv(s)
    assert calls
