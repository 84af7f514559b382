"""The deblock segment rasterizer: vvc_deblock.c's `deblock_frame_segments`
against its golden model, `_Rasterizer`, exactly.

  * exactness: every frame of each stream, captured where the host decode
    deblocks it (`Deblocker.deblock_frame`, whose tab planes are final
    there), both directions, every plane: the C entry's [7, B] arrays ==
    `seg_array` of `_Rasterizer`'s segment tuples, element for element,
    and the counts == the number of tuples;
  * CTBs with deblocking disabled emit no segments: the device paths
    decode a stream forged with deblocking off as the host path does;
  * `deblock_device.stats` counts the directions each path rasterized, and
    without the C library the Python walk gives the same pictures.
"""
import hashlib

import numpy as np
import pytest

from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch import deblock as host_deblock
from ffvvc_tpu_torch.native import deblock as native_deblock
from ffvvc_tpu_torch.ops import deblock_device as dd
from ffvvc_tpu_torch.ops import fused_device as fd
from ffvvc_tpu_torch.tools import forge

from test_torch_fused import FORMATS, TOOLS

# name -> (forge function, arguments): the fused chain's FORMATS streams
# (I/P/B; 8-, 10- and 12-bit; 4:2:0, 4:2:2, 4:4:4, 4:0:0; CTU 64 and 128),
# tiles and slices with filtering across them on and off, and a stream
# with deblocking disabled
STREAMS = {name: ("forge_inter_stream", dict(deblock=True, **TOOLS, **kw))
           for name, kw in FORMATS.items()}
STREAMS.update({
    "tiles_across": ("forge_tiled_stream", dict(
        seed=2, nframes=2, width=96, height=96, lf_across_tiles=1)),
    "tiles_not_across": ("forge_tiled_stream", dict(
        seed=2, nframes=2, width=96, height=96, lf_across_tiles=0)),
    "slices_across": ("forge_rect_slice_stream", dict(
        seed=3, nframes=2, width=128, height=64, lf_across_slices=1)),
    "slices_not_across": ("forge_rect_slice_stream", dict(
        seed=3, nframes=2, width=128, height=64, lf_across_slices=0,
        lf_across_tiles=0)),
    "deblock_off": ("forge_inter_stream", dict(
        slice_type=1, nframes=2, width=128, height=128, seed=4,
        deblock=False, **TOOLS)),
})


def _stream(name):
    fn, kw = STREAMS[name]
    return getattr(forge, fn)(**kw)


def md5(frames):
    return hashlib.md5(b"".join(f.to_yuv_bytes() for f in frames)).hexdigest()


@pytest.mark.parametrize("name", list(STREAMS))
def test_native_segments_equal_golden(name, monkeypatch):
    seen = []
    real = host_deblock.Deblocker.deblock_frame

    def compare(db):
        nc = 3 if db.sps.chroma_format_idc else 1
        for vertical in (True, False):
            before = dict(dd.stats)
            arrays, counts = dd.rasterize_deblock(
                db.sps, db.pps, db.tabs, db.fb, db.slice_rpls, vertical)
            assert dd.stats["raster_native"] == before["raster_native"] + 1
            ras = dd.rasterize_python(db.sps, db.pps, db.tabs, db.fb,
                                      db.slice_rpls, vertical)
            want = [ras.luma_segs] + [ras.chroma_segs[c]
                                      for c in range(1, nc)]
            assert len(arrays) == len(counts) == nc
            for c in range(nc):
                where = (name, len(seen), vertical, c)
                assert counts[c] == len(want[c]), where
                assert arrays[c].dtype == np.int16, where
                assert np.array_equal(arrays[c], dd.seg_array(want[c])), \
                    where
            seen.append(sum(counts))
        return real(db)

    monkeypatch.setattr(host_deblock.Deblocker, "deblock_frame", compare)
    frames = VVCDecoder(DecoderConfig(device="cpu", row_progress=False)
                        ).decode(_stream(name))
    assert len(seen) == 2 * len(frames)
    # every stream but the disabled one has segments to compare
    assert (sum(seen) == 0) == (name == "deblock_off")


@pytest.mark.parametrize("toggle", ["device_pipeline", "device_deblock"])
def test_deblocking_disabled_matches_host(toggle):
    s = _stream("deblock_off")
    want = md5(VVCDecoder(DecoderConfig(device="cpu")).decode(s))
    assert md5(VVCDecoder(DecoderConfig(device="cpu", **{toggle: True})
                          ).decode(s)) == want


def test_raster_counter_and_python_fallback(monkeypatch):
    s = _stream("b_10bit")
    want = md5(VVCDecoder(DecoderConfig(device="cpu")).decode(s))
    fd.reset_stats()
    assert md5(VVCDecoder(DecoderConfig(device="cpu", device_pipeline=True)
                          ).decode(s)) == want
    assert fd.stats["frames"] == 3
    # the fused chain rasterized; the per-stage deblock moved nothing
    assert dd.stats == {"raster_native": 6, "raster_python": 0, "frames": 0,
                        "up_bytes": 0, "down_bytes": 0}

    monkeypatch.setattr(native_deblock, "load_lib", lambda: None)
    fd.reset_stats()
    assert md5(VVCDecoder(DecoderConfig(device="cpu", device_pipeline=True)
                          ).decode(s)) == want
    assert fd.stats["frames"] == 3
    assert dd.stats == {"raster_native": 0, "raster_python": 6, "frames": 0,
                        "up_bytes": 0, "down_bytes": 0}
