"""The port's fused chain against the JAX package's `_chain`, exactly.

JAX's `fused_device._chain` is wrapped to record every (meta, arrays,
output) of a JAX device_pipeline decode; the same numpy arrays then go
through the port's `to_device(..., "cpu")` and `chain`, and each output
plane must be equal.  The streams are those of tests/test_device_filters.py's
test_fused_chain_formats (FORMATS: slice types, bit depths, chroma formats
and CTU sizes, each with SAO, ALF, CC-ALF and LMCS on).  This file takes
the slice-type and bit-depth streams; test_torch_fused_formats.py the
chroma-format and CTU-size ones, and test_torch_decode.py decodes all of
them through the port's decoder.
"""
import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from forge import forge_inter_stream  # noqa: E402

from ffvvc_tpu.config import DecoderConfig as JaxConfig  # noqa: E402
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder  # noqa: E402
from ffvvc_tpu.ops import fused_device as jfd  # noqa: E402
from ffvvc_tpu_torch.ops import fused_device as fd  # noqa: E402

TOOLS = dict(sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
             sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)

FORMATS = {
    "intra_all": dict(slice_type=2, nframes=3, width=96, height=96, seed=3),
    "p_all": dict(slice_type=1, nframes=3, width=128, height=96, seed=4),
    "b_10bit": dict(slice_type=0, nframes=3, width=96, height=96, seed=5,
                    bit_depth=10),
    "p_12bit": dict(slice_type=1, nframes=2, width=96, height=64, seed=6,
                    bit_depth=12),
    "p_422": dict(slice_type=1, nframes=3, width=96, height=96, seed=7,
                  chroma=2),
    "p_444": dict(slice_type=1, nframes=2, width=96, height=96, seed=8,
                  chroma=3),
    "mono_lmcs": dict(slice_type=1, nframes=3, width=96, height=96, seed=9,
                      chroma=0),
    "ctu64": dict(slice_type=1, nframes=2, width=128, height=128, seed=10,
                  ctu_log2=6),
}


@functools.lru_cache(maxsize=None)
def stream(name):
    return forge_inter_stream(deblock=True, **TOOLS, **FORMATS[name])


def record_jax_chain(name, monkeypatch):
    """(meta, numpy arrays, numpy outputs) of every JAX chain call in a
    device_pipeline decode of stream `name`."""
    calls = []
    real = jfd._chain

    def recording(meta, a):
        out = real(meta, a)
        calls.append((meta, {k: np.asarray(v) for k, v in a.items()},
                      [np.asarray(o) for o in out]))
        return out
    monkeypatch.setattr(jfd, "_chain", recording)
    JaxDecoder(JaxConfig(device_pipeline=True)).decode(stream(name))
    monkeypatch.undo()
    assert calls, "the JAX fused chain never ran"
    return calls


def check_chain_matches_jax(name, monkeypatch):
    """Every recorded JAX chain call, replayed through the port's
    `to_device(..., "cpu")` and `chain`, gives equal planes."""
    for meta, arrs, want in record_jax_chain(name, monkeypatch):
        got = fd.chain(meta, fd.to_device(arrs, "cpu"))
        assert len(got) == len(want)
        for c, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g.numpy().astype(np.int32),
                                  w.astype(np.int32)), \
                f"{name}: plane {c} differs ({dict(meta)})"


@pytest.mark.parametrize("name", ["intra_all", "p_all", "b_10bit",
                                  "p_12bit"])
def test_chain_matches_jax(name, monkeypatch):
    check_chain_matches_jax(name, monkeypatch)
