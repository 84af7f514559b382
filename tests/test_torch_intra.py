"""The port's device intra prediction against the JAX package, decode by
decode: `DecoderConfig(device="cpu", device_intra=True)` of the port
against the bytes of ffvvc_tpu's host decode on the 14 streams of
tests/test_device_intra.py, the inter-frame gate, the native planner
engaging (no silent decline) and what `intra_device.stats` counts.  The
functions themselves are held against the JAX functions in
tests/test_torch_intra_functions.py (a file of its own so that the two run
on two test workers).

Every comparison is byte equality (tolerance 0).
"""
import functools
import hashlib

import pytest

from test_device_intra import CASES, _forge
from forge import forge_inter_stream

from ffvvc_tpu.config import DecoderConfig as JaxConfig
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import intra_device as idv


def _yuv(frames):
    return b"".join(f.to_yuv_bytes() for f in frames)


@functools.lru_cache()
def _host(stream):
    return _yuv(JaxDecoder(JaxConfig()).decode(stream))


@pytest.mark.parametrize("case", CASES)
def test_device_intra_matches_host(case):
    """Twin of tests/test_device_intra.py: the port's device intra on the
    CPU gives ffvvc_tpu's host decode, and every frame went through it."""
    stream = _forge(case)
    idv.reset_stats()
    frames = VVCDecoder(DecoderConfig(device="cpu",
                                      device_intra=True)).decode(stream)
    assert _yuv(frames) == _host(stream), case
    st = idv.stats
    assert st["frames"] == len(frames) and not st["declined"], st
    assert st["units"] > 0 and st["down_bytes"] > 0


def test_device_intra_falls_back_on_inter():
    """P and B frames take the native C walk untouched (the gate): only
    the IDR is reconstructed on the device."""
    stream = forge_inter_stream(seed=0, width=64, height=64, qp=32)
    idv.reset_stats()
    frames = VVCDecoder(DecoderConfig(device="cpu",
                                      device_intra=True)).decode(stream)
    assert _yuv(frames) == _host(stream)
    assert idv.stats["frames"] == 1 and len(frames) > 1, idv.stats


@pytest.mark.parametrize("case", ["tools10", "cclm_coll", "dualtree", "422"])
def test_c_planner_engages(case):
    """The native planner takes every CU of the tool-bearing streams:
    units and buckets of each family present are counted, none declined."""
    idv.reset_stats()
    VVCDecoder(DecoderConfig(device="cpu", device_intra=True)).decode(
        _forge(case))
    st = idv.stats
    assert st["frames"] == 2 and not st["declined"], st
    assert st["units"] > st["waves"] > 0
    assert st["simple_buckets"] and st["angular_buckets"] and \
        st["mip_buckets"], st
    assert bool(st["cclm_buckets"]) == (case != "tools10"), st
    assert st["walk_s"] > 0 and st["last_plan_s"] > 0


def test_device_intra_stats_count_the_wire():
    """One upload of planes, residuals, geo rows and plans; one download
    of the planes, at their own size."""
    stream = _forge("444")
    idv.reset_stats()
    VVCDecoder(DecoderConfig(device="cpu", device_intra=True)).decode(stream)
    st = idv.stats
    plane_bytes = 3 * 96 * 128 * 4              # int32, 4:4:4
    assert st["down_bytes"] == 2 * plane_bytes
    assert st["up_bytes"] > 2 * 2 * plane_bytes
    assert st["cclm_units"] >= st["cclm_buckets"] > 0


def test_device_intra_md5_is_stable_across_calls():
    """Two decodes of one stream in one process give the same bytes (the
    constants cached per device are never written to)."""
    stream = _forge("12bit")
    a = hashlib.md5(_yuv(VVCDecoder(DecoderConfig(
        device="cpu", device_intra=True)).decode(stream))).hexdigest()
    b = hashlib.md5(_yuv(VVCDecoder(DecoderConfig(
        device="cpu", device_intra=True)).decode(stream))).hexdigest()
    assert a == b
