"""The port's device intra functions against the JAX package's, exactly.

Buckets captured from ffvvc_tpu's `frame_device_intra` on small one-frame
streams (8, 10 and 12 bits; 4:2:0 with and without collocated chroma,
4:2:2, 4:4:4, mono), each with the JAX function's own output, go through
the port's functions of the same names on the same numpy inputs; the
gather-plan builders against `_edge_idx_jnp` and `_proj_idx_jnp`; the
angular PDPC lanes that run past the reference array; the host CCLM plans.
The JAX functions compile once per bucket shape, which is most of this
file's time.

Every comparison is integer equality (tolerance 0).
"""
import collections
import contextlib
import functools

import numpy as np
import pytest
import torch

from test_torch_intra import _host, _yuv
from forge import forge_tools_stream

from ffvvc_tpu.config import DecoderConfig as JaxConfig
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder
from ffvvc_tpu.ops import intra_device as jidv
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import intra_device as idv

FAMILIES = ("k_simple_g", "k_angular_g", "k_mip_g", "k_cclm_p")


_C = dict(sps_cclm_enabled_flag=1)
# name -> forge_tools_stream arguments, one 128x64 frame each
CAPTURE = {
    "t10_420": dict(seed=2, bit_depth=10,
                    sps_chroma_vertical_collocated_flag=0, **_C),
    "t12_coll": dict(seed=3, bit_depth=12,
                     sps_chroma_vertical_collocated_flag=1, **_C),
    "t8_422": dict(seed=8, bit_depth=8, chroma=2, **_C),
    "t10_444": dict(seed=9, bit_depth=10, chroma=3, **_C),
    "t8_mono": dict(seed=6, bit_depth=8, chroma=0),
}


@contextlib.contextmanager
def _recording(log):
    """Wrap the JAX bucket functions: each call appends (family, arrays,
    static arguments, the JAX output) to `log`."""
    originals = {n: getattr(jidv, n) for n in FAMILIES}

    def wrap(name, fn):
        def call(*args):
            out = fn(*args)
            # copies: a view would share a buffer that JAX frees and reuses
            arrays = [np.array(a) for a in args if hasattr(a, "shape")]
            static = tuple(a for a in args if not hasattr(a, "shape"))
            log.append((name, arrays, static, np.array(out)))
            return out
        return call
    for n, fn in originals.items():
        setattr(jidv, n, wrap(n, fn))
    try:
        yield log
    finally:
        for n, fn in originals.items():
            setattr(jidv, n, fn)


@functools.lru_cache()
def _captured(name):
    """The buckets of ffvvc_tpu's device intra decode of one CAPTURE
    stream, each with its JAX output."""
    stream = forge_tools_stream(width=128, height=64, qp=30, nframes=1,
                                **CAPTURE[name])
    with _recording([]) as log:
        frames = JaxDecoder(JaxConfig(device_intra=True)).decode(stream)
    assert _yuv(frames) == _host(stream)
    return log


def _port(name, arrays, static):
    """The port's function of the same name on the same inputs; it takes
    the gather plans of the bucket's geo rows as an argument."""
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    if name != "k_cclm_p":
        t.append(idv._edge_idx(t[2], static[2]))
    return getattr(idv, name)(*t, *static)


@pytest.mark.parametrize("stream,family", [
    (s, f) for s in CAPTURE for f in FAMILIES
    if not (s == "t8_mono" and f == "k_cclm_p")])
def test_bucket_functions_match_jax(stream, family):
    buckets = [b for b in _captured(stream) if b[0] == family]
    assert buckets, f"no {family} bucket in {stream}"
    for name, arrays, static, want in buckets:
        got = _port(name, arrays, static)
        assert np.array_equal(got.numpy(), want), (name, static)


def test_capture_covers_every_variant():
    """Between them the captured streams hold both angular orientations
    in luma and chroma, all three MIP size ids, all four CCLM variants,
    and 8, 10 and 12 bits."""
    seen = collections.defaultdict(set)
    for s in CAPTURE:
        for name, arrays, static, _ in _captured(s):
            if name == "k_angular_g":
                seen[name].add(static[4:6])          # is_h, is_luma
            elif name == "k_mip_g":
                seen[name].add(static[4])            # size_id
            elif name == "k_cclm_p":
                seen[name].add(static[5])            # variant
            seen["bd"].add(static[3] if name != "k_cclm_p" else static[4])
    assert seen["k_angular_g"] == {(False, False), (False, True),
                                   (True, False), (True, True)}
    assert seen["k_mip_g"] == {0, 1, 2}
    assert seen["k_cclm_p"] == {0, 1, 2, 3}
    assert seen["bd"] == {8, 10, 12}


@pytest.mark.parametrize("stream", list(CAPTURE))
def test_index_builders_match_jax(stream):
    """_edge_idx and _proj_idx against _edge_idx_jnp and _proj_idx_jnp on
    every captured geo row, grouped by their static arguments."""
    edge_rows = collections.defaultdict(list)
    proj_rows = collections.defaultdict(list)
    for name, arrays, static, _ in _captured(stream):
        if name == "k_cclm_p":
            continue
        geo = arrays[2]
        w, h, W = static[:3]
        edge_rows[W].append(geo)
        if name == "k_angular_g":
            proj_rows[w, h, not static[4]].append(geo)
    assert edge_rows and proj_rows
    for W, geos in edge_rows.items():
        g = np.concatenate(geos)
        got = idv._edge_idx(torch.from_numpy(g), W)
        want = jidv._edge_idx_jnp(g, W)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), W
    for (w, h, is_v), geos in proj_rows.items():
        g = np.concatenate(geos)
        got = idv._proj_idx(torch.from_numpy(g), w, h, is_v)
        want = jidv._proj_idx_jnp(g, w, h, is_v)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), (w, h, is_v)


def _side_index_range(geo, w, h, is_h):
    """Least and greatest index of the angular PDPC side gather before the
    clamp (JAX fills what lies outside [0, NREF))."""
    wp_max = h if is_h else w
    n = w if is_h else h
    sscale = 256 + geo[:, jidv.G_INV, None].astype(np.int64) * \
        (np.arange(wp_max) + 1)
    idx = jidv.PAD + (sscale >> 9)
    return int(idx.min()), int(idx.max()) + n - 1


def test_angular_out_of_range_lanes():
    """Buckets whose PDPC side gather runs past the reference array in
    lanes that are thrown away (beyond wp, or units without PDPC) equal
    the JAX function, which fills those lanes where the port clamps them.
    The planner gives nscale 0 to units without PDPC and PDPC needs
    nscale >= 0 (vvc_recon.c need_pdpc), so no decode shifts by a negative
    amount; a bucket with nscale set to -3 on its units without PDPC
    equals the JAX function as well."""
    hits = 0
    negative = None
    for s in CAPTURE:
        for name, arrays, static, want in _captured(s):
            if name != "k_angular_g":
                continue
            geo = arrays[2]
            assert (geo[:, jidv.G_NSCALE] >= 0).all()
            if negative is None and (geo[:, jidv.G_PDPC] == 0).any():
                negative = (arrays, static)
            w, h, _W, _bd, is_h, _luma = static
            lo, hi = _side_index_range(geo, w, h, is_h)
            if lo >= 0 and hi < jidv.NREF:
                continue
            hits += 1
            got = _port(name, arrays, static)
            assert np.array_equal(got.numpy(), want), static
    assert hits > 0
    arrays, static = negative
    geo = arrays[2].copy()
    geo[geo[:, jidv.G_PDPC] == 0, jidv.G_NSCALE] = -3
    arrays = arrays[:2] + [geo]
    want = np.asarray(jidv.k_angular_g(*arrays, *static))
    assert np.array_equal(_port("k_angular_g", arrays, static).numpy(), want)


def test_cclm_plans_match_jax():
    """_cclm_plan_from_desc, the host plan of a CCLM unit, equals the JAX
    package's on the blob rows of every captured CCLM bucket: the blob the
    port builds is the blob the JAX function received."""
    for s in CAPTURE:
        rows = [a[3] for n, a, _, _ in _captured(s) if n == "k_cclm_p"]
        assert all(r.dtype == np.int32 for r in rows) and \
            (s == "t8_mono") == (not rows)
    stream = forge_tools_stream(width=128, height=64, qp=30, nframes=1,
                                **CAPTURE["t10_420"])
    blobs = []
    real = idv._cclm_row

    def spy(sps, fb, d, w, h):
        row = real(sps, fb, d, w, h)
        blobs.append(row)
        return row
    idv._cclm_row = spy
    try:
        VVCDecoder(DecoderConfig(device="cpu", device_intra=True)).decode(
            stream)
    finally:
        idv._cclm_row = real
    want = [r for n, a, _, _ in _captured("t10_420") if n == "k_cclm_p"
            for r in a[3]]
    # the JAX blobs are padded to a power of two per bucket by repeating
    # their first row; every port row is among them, in the same order
    assert blobs and len(want) >= len(blobs)
    it = iter(want)
    for row in blobs:
        assert any(np.array_equal(row, r) for r in it)
