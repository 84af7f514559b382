"""The port's batched inverse transform against the JAX package, exactly.

Function level: `itx_batch` of the port (device="cpu") against both
`ffvvc_tpu.ops.itx.itx_batch` and the NumPy int64 `itx_batch_host`, for
DCT2, DST7 and DCT8 at every size from 1xN to 64x64, on random
coefficients and on coefficients at +-(2^15 - 1), where the float64
products of the port must still be the exact integers; `dequant_batch` and
`scatter_residual` against their JAX counterparts.  Decode level: the
golden-parse path (`native_parse=False`) with `FFVVC_ITX=device` against
the bytes of ffvvc_tpu's host decode, with the buckets counted.

Every comparison is integer equality (tolerance 0).
"""
import numpy as np
import pytest
import torch

from test_torch_fused import TOOLS
from forge import forge_inter_stream

from ffvvc_tpu.config import DecoderConfig as JaxConfig
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder
from ffvvc_tpu.ops import itx as jitx
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import itx

KINDS = {"dct2": itx.DCT2, "dst7": itx.DST7, "dct8": itx.DCT8}
# DCT2 exists from 2 to 64 points, DST7 and DCT8 from 4 to 32; the side of a
# 1xN or Nx1 block that has one sample is not transformed and counts as DCT2
SIZES = {"dct2": (1, 2, 4, 8, 16, 32, 64), "dst7": (4, 8, 16, 32),
         "dct8": (4, 8, 16, 32)}
PEAK = (1 << 15) - 1


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def coefficient_sets(rng, w, h):
    """Random coefficients, then the largest magnitudes: all +PEAK, all
    -PEAK, and the signs of each basis row, which drive every output of a
    pass to its extreme."""
    yield rng.integers(-PEAK, PEAK + 1, (6, h, w)).astype(np.int32)
    signs = rng.choice([-1, 1], (5, h, w))
    yield np.concatenate([np.full((1, h, w), PEAK), np.full((1, h, w), -PEAK),
                          signs * PEAK]).astype(np.int32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_matrices_equal(kind):
    for n in SIZES[kind]:
        m = itx.matrix(KINDS[kind], n)
        assert m.dtype == np.int32 and np.abs(m).max() <= 128
        assert np.array_equal(m, jitx.matrix(KINDS[kind], n))


@pytest.mark.parametrize("bit_depth", [8, 10, 12])
@pytest.mark.parametrize("kv", list(KINDS))
@pytest.mark.parametrize("kh", list(KINDS))
def test_itx_batch_matches_jax_and_host(kh, kv, bit_depth):
    """Every width of kind `kh` against every height of kind `kv`."""
    rng = np.random.default_rng(hash((kh, kv, bit_depth)) & 0xFFFF)
    n = 0
    for w in SIZES[kh]:
        for h in SIZES[kv]:
            if w == 1 and h == 1:
                continue
            for c in coefficient_sets(rng, w, h):
                got = itx.itx_batch(T(c), w, h, KINDS[kh], KINDS[kv],
                                    bit_depth=bit_depth)
                assert got.dtype == torch.int32
                host = itx.itx_batch_host(c, w, h, KINDS[kh], KINDS[kv],
                                          bit_depth=bit_depth)
                assert np.array_equal(got.numpy(), host), (w, h)
                n += 1
            # the JAX function on the last (largest) set
            want = jitx.itx_batch(c, w, h, KINDS[kh], KINDS[kv],
                                  bit_depth=bit_depth)
            assert np.array_equal(got.numpy(), np.asarray(want)), (w, h)
    assert n >= 2 * (len(SIZES[kh]) * len(SIZES[kv]) - 1) >= 30


def test_itx_host_twin_equals_the_original():
    rng = np.random.default_rng(3)
    for w, h, trh, trv in ((8, 4, 1, 2), (1, 16, 0, 0), (32, 1, 0, 0),
                           (64, 64, 0, 0)):
        c = rng.integers(-PEAK, PEAK + 1, (4, h, w)).astype(np.int32)
        assert np.array_equal(itx.itx_batch_host(c, w, h, trh, trv),
                              jitx.itx_batch_host(c, w, h, trh, trv))


def test_float64_product_is_exact_beyond_float32():
    """The products of a pass leave the exact range of float32 (2^24) but
    not of float64: an integer reference agrees to the last bit."""
    c = np.full((1, 64, 64), PEAK, np.int32)
    m = torch.from_numpy(itx.matrix(itx.DCT2, 64).astype(np.float64))
    got = itx._int_matmul(T(c).to(torch.int64).transpose(1, 2), m)
    want = np.tensordot(c.astype(np.int64), itx.matrix(itx.DCT2, 64).astype(
        np.int64), axes=([1], [0]))
    assert np.abs(want).max() > 1 << 24
    assert np.array_equal(got.numpy(), want)


def test_dequant_batch_matches_jax():
    """In the range where the JAX package's int32 product does not wrap."""
    rng = np.random.default_rng(5)
    c = rng.integers(-(1 << 15), 1 << 15, (9, 8, 16)).astype(np.int32)
    scales = rng.integers(1, 1 << 15, 9).astype(np.int32)
    shift = rng.integers(1, 14, 9).astype(np.int32)
    got = itx.dequant_batch(T(c), T(scales), T(shift))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(jitx.dequant_batch(c, scales, shift)))


def test_dequant_width_follows_the_golden_model():
    """coefficient x scale reaches 2^31 at high QP with a scaling list
    (level scale 57 << 10 times a scaling factor): the golden model
    (recon.py _dequant) multiplies in int64 and so does the port; the JAX
    package's `jnp.int64` is int32 there and wraps."""
    c = np.array([[[PEAK, -PEAK, 700]]], np.int32)
    scales = np.array([(57 << 10) * 64], np.int32)
    shift = np.array([12], np.int32)
    want = np.clip((c.astype(np.int64) * int(scales[0]) + (1 << 11)) >> 12,
                   -(1 << 15), (1 << 15) - 1)
    got = itx.dequant_batch(T(c), T(scales), T(shift))
    assert np.array_equal(got.numpy(), want)
    wrapped = np.asarray(jitx.dequant_batch(c, scales, shift))
    assert not np.array_equal(wrapped, want)


@pytest.mark.parametrize("size", [(4, 4), (16, 8), (1, 32)])
def test_scatter_residual_matches_jax(size):
    w, h = size
    rng = np.random.default_rng(7 + w)
    H, W = 96, 128
    frame = rng.integers(0, 1024, (H, W)).astype(np.int32)
    # disjoint blocks on the (w, h) grid
    cells = rng.permutation((H // h) * (W // w))[:40]
    ys = (cells // (W // w) * h).astype(np.int32)
    xs = (cells % (W // w) * w).astype(np.int32)
    res = rng.integers(-1500, 1500, (40, h, w)).astype(np.int32)
    keep = frame.copy()
    got = itx.scatter_residual(T(frame), T(res), T(xs), T(ys), w, h, 1023)
    want = jitx.scatter_residual(frame, res, xs, ys, w, h, 1023)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(frame, keep)        # the input plane is not mutated


def test_use_device_itx(monkeypatch):
    """auto means the device: the port weighs no slow link."""
    for mode, want in (("device", True), ("host", False), ("auto", True)):
        monkeypatch.setenv("FFVVC_ITX", mode)
        assert itx._use_device_itx() is want
    monkeypatch.delenv("FFVVC_ITX")
    assert itx._use_device_itx() is True


def _yuv(frames):
    return b"".join(f.to_yuv_bytes() for f in frames)


@pytest.mark.parametrize("slice_type", [2, 0])
@pytest.mark.parametrize("mode", ["device", "host"])
def test_decode_with_device_itx(slice_type, mode, monkeypatch):
    """The golden-parse decode runs its inverse transforms through
    frame_device_residuals, in buckets, and equals ffvvc_tpu's host
    decode."""
    s = forge_inter_stream(slice_type=slice_type, nframes=2, width=64,
                           height=64, seed=7, deblock=True, bit_depth=10,
                           **TOOLS)
    want = _yuv(JaxDecoder(JaxConfig(backend="golden")).decode(s))
    monkeypatch.setenv("FFVVC_ITX", mode)
    itx.reset_stats()
    got = _yuv(VVCDecoder(DecoderConfig(device="cpu",
                                        native_parse=False)).decode(s))
    assert got == want
    if mode == "device":
        assert itx.stats["frames"] > 0
        assert 0 < itx.stats["buckets"] < itx.stats["tbs"]
        assert itx.stats["up_bytes"] == itx.stats["down_bytes"] > 0
    else:
        assert itx.stats["buckets"] == 0


def test_native_parse_leaves_no_work_for_device_itx(monkeypatch):
    """With the native parse the C recon transforms: no bucket."""
    s = forge_inter_stream(slice_type=2, nframes=1, width=64, height=64,
                           seed=7, deblock=True)
    monkeypatch.setenv("FFVVC_ITX", "device")
    itx.reset_stats()
    VVCDecoder(DecoderConfig(device="cpu")).decode(s)
    assert itx.stats["buckets"] == 0
