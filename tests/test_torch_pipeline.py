"""The port's GOP workers (ffvvc_tpu_torch/pipeline.py) against the JAX
package, exactly.

Twins of tests/test_pipeline.py: segmenting, a parallel decode, the
single-segment fallback, and a parallel decode after a sequential one of a
multi-entry-point stream; plus a decode with the fused chain on
device="cpu" through two workers, and the start method the pool takes.
Every decode equals ffvvc_tpu's sequential host decode of the same bytes.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from forge import (forge_inter_stream, forge_scaling_stream,  # noqa: E402
                   forge_stream)

from ffvvc_tpu.config import DecoderConfig as JaxConfig  # noqa: E402
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder  # noqa: E402
from ffvvc_tpu.pipeline import segment_stream as jax_segment  # noqa: E402
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder  # noqa: E402
from ffvvc_tpu_torch import pipeline  # noqa: E402
from ffvvc_tpu_torch.pipeline import (decode_parallel,  # noqa: E402
                                      segment_stream)

CPU = DecoderConfig(device="cpu")


def _intra_stream(nframes):
    return forge_stream(level=1, seed=3, width=96, height=64, qp=30,
                        nframes=nframes)


def jax_sequential(s):
    """ffvvc_tpu's sequential host decode, per frame (its inverse
    transforms on the host: no JAX compile)."""
    old = os.environ.get("FFVVC_ITX")
    os.environ["FFVVC_ITX"] = "host"
    try:
        return [f.to_yuv_bytes() for f in JaxDecoder(JaxConfig()).decode(s)]
    finally:
        if old is None:
            del os.environ["FFVVC_ITX"]
        else:
            os.environ["FFVVC_ITX"] = old


def test_segmenting_all_intra():
    stream = _intra_stream(4)
    segs = segment_stream(stream)
    assert len(segs) == 4
    # every byte of the stream lands in exactly one segment, in order
    assert b"".join(s for _p, s in segs) == stream
    assert segs == jax_segment(stream)


def test_parallel_matches_sequential():
    stream = _intra_stream(4)
    par = decode_parallel(stream, workers=2, config=CPU)
    assert len(par) == 4
    assert par == jax_sequential(stream)


def test_single_segment_fallback():
    stream = forge_inter_stream(seed=0, nframes=3, slice_type=1,
                                n_refs=(1, 0), deblock=True)
    assert len(segment_stream(stream)) == 1   # one IDR + trailing P frames
    assert decode_parallel(stream, workers=2, config=CPU) == \
        jax_sequential(stream)


def test_parallel_after_sequential_multi_ep():
    """A sequential decode of a multi-entry-point stream fills the shared
    stage-thread pool; GOP workers forked afterwards must not inherit it
    (threads.executor is pid-keyed)."""
    s = forge_scaling_stream(seed=0, width=256, height=128, qp=34,
                             nframes=3)
    want = jax_sequential(s)
    assert [f.to_yuv_bytes() for f in VVCDecoder(CPU).decode(s)] == want
    assert decode_parallel(s, workers=2, config=CPU) == want


def test_parallel_device_pipeline_cpu():
    """The fused chain on device="cpu" in two workers (forked: no CUDA)."""
    stream = _intra_stream(4)
    cfg = DecoderConfig(device="cpu", device_pipeline=True)
    assert pipeline._start_method(cfg) == "fork"
    assert decode_parallel(stream, workers=2, config=cfg) == \
        jax_sequential(stream)


@pytest.mark.parametrize("kw,method", [
    (dict(), "fork"),
    (dict(device_pipeline=True), "fork"),
    (dict(device_sao=True, device="cuda"), "spawn"),
    (dict(device_pipeline=True, device="cuda"), "spawn"),
    (dict(device_mc=True, device="cuda"), "spawn"),
    (dict(mesh_shape=(1, 2), device="cuda"), "spawn"),
    (dict(mesh_shape=(1, 2), device="cuda", backend="golden"), "spawn"),
    (dict(mesh_shape=(1, 2), backend="golden"), "fork"),
    (dict(device="cuda"), "fork"),
    (dict(device_alf=True, device="cuda", backend="golden"), "fork")])
def test_start_method(kw, method):
    """"spawn" where a stage runs on CUDA (a forked child cannot use the
    CUDA its parent initialised), "fork" otherwise.  Decided from the
    config alone: no pool is started and CUDA is not touched (a config for
    "cuda" is built on "cpu" and pointed at the card afterwards, since
    constructing it asks for the card)."""
    kw = dict(kw)
    device = kw.pop("device", "cpu")
    cfg = DecoderConfig(device="cpu", **kw)
    cfg.device = device
    assert pipeline._start_method(cfg) == method


def test_pools_keyed_by_start_method(monkeypatch):
    """One pool per worker count and start method."""
    made = []

    class Ctx:
        def __init__(self, method):
            self.method = method

        def Pool(self, n):
            made.append((n, self.method))
            return object()
    monkeypatch.setattr(pipeline.multiprocessing, "get_context", Ctx)
    monkeypatch.setattr(pipeline, "_POOLS", {})
    a = pipeline._get_pool(2, "fork")
    assert pipeline._get_pool(2, "fork") is a
    assert pipeline._get_pool(2, "spawn") is not a
    assert made == [(2, "fork"), (2, "spawn")]
