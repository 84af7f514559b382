"""Decodes through the port (device="cpu": the kernels' plain twins) must
equal ffvvc_tpu's byte for byte.

Twins of tests/test_device_filters.py's test_fused_chain_formats,
test_fused_chain_transfer_budget, test_fused_chain_fallback_paths and
test_device_pipeline_single_chip.  The reference is ffvvc_tpu's host
decode (backend="golden": native C filters, no device half), which the
JAX package's own tests pin equal to its fused chain.
"""
import pytest

from test_torch_fused import FORMATS, TOOLS, stream
from forge import (forge_hier_stream, forge_inter_stream, forge_subpic_stream,
                   forge_tiled_stream)

from ffvvc_tpu.config import DecoderConfig as JaxConfig
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder
from ffvvc_tpu.ops import fused_device as jfd
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import fused_device as fd


def host_yuv(s):
    frames = JaxDecoder(JaxConfig(backend="golden")).decode(s)
    return b"".join(f.to_yuv_bytes() for f in frames)


def port_yuv(s, **kw):
    frames = VVCDecoder(DecoderConfig(device="cpu", device_pipeline=True,
                                      **kw)).decode(s)
    return b"".join(f.to_yuv_bytes() for f in frames)


@pytest.mark.parametrize("name", list(FORMATS))
def test_fused_chain_formats(name):
    """The port's fused chain is bit-exact against the host decode across
    slice types, bit depths, chroma formats and CTU sizes, and runs."""
    s = stream(name)
    fd.reset_stats()
    assert port_yuv(s) == host_yuv(s)
    assert fd.stats["frames"] > 0, "fused chain never engaged"


def test_fused_chain_transfer_budget():
    """The port moves exactly the bytes the JAX package moves: one uint16
    plane set down per frame, and the same planes + parameters up."""
    W = H = 96
    s = forge_inter_stream(slice_type=2, nframes=3, width=W, height=H,
                           seed=3, deblock=True, **TOOLS)
    jfd.reset_stats()
    JaxDecoder(JaxConfig(device_pipeline=True)).decode(s)
    fd.reset_stats()
    port_yuv(s)
    n = fd.stats["frames"]
    assert n == 3 == jfd.stats["frames"]
    plane_set = (W * H + 2 * (W // 2) * (H // 2)) * 2   # uint16 wire bytes
    assert fd.stats["down_bytes"] == n * plane_set == jfd.stats["down_bytes"]
    assert fd.stats["up_bytes"] == jfd.stats["up_bytes"]
    assert fd.stats["up_bytes"] < n * plane_set * 2.5


def test_fused_chain_fallback_paths():
    """Streams outside the chain's eligibility (loop filters disabled
    across slice/tile boundaries) fall back to the host stages and stay
    byte-exact; an eligible subpicture stream runs fused."""
    s = forge_tiled_stream(seed=2, nframes=2, width=96, height=96,
                           lf_across_tiles=0, lf_across_slices=0,
                           sps_sao_enabled_flag=1, sps_alf_enabled_flag=1)
    fd.reset_stats()
    assert port_yuv(s) == host_yuv(s)
    assert fd.stats["frames"] == 0, "ineligible stream ran fused"
    s = forge_subpic_stream(seed=0, width=128, height=64, qp=30,
                            sps_sao_enabled_flag=1)
    fd.reset_stats()
    assert port_yuv(s) == host_yuv(s)
    assert fd.stats["frames"] > 0


@pytest.mark.parametrize("kind", ["intra", "hier"])
def test_device_pipeline_single_chip(kind):
    """device_pipeline through the port's decoder on intra and on
    hierarchical-GOP inter content (deferred residual add, frames in
    flight on the pixel worker) equals the host decode."""
    if kind == "intra":
        s = forge_inter_stream(slice_type=2, nframes=3, width=96, height=96,
                               seed=3, deblock=True, **TOOLS)
    else:
        s = forge_hier_stream(seed=2, width=96, height=64, qp=32, ngops=2,
                              deblock=True, **TOOLS)
    fd.reset_stats()
    assert port_yuv(s) == host_yuv(s)
    assert fd.stats["frames"] > 0
