"""The frozen forge and reference (`vvcref`) and the segment generator:
recorded bytes, agreement with the port's host decode, and the import
rule of every file of the benchmark."""
import ast
import hashlib
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, SIZE
from harness import cells, reference, segments
from vvcref import forge as F
from vvcref.decoder import VVCDecoder as RefDecoder

# the frozen forge's streams, recorded when it was frozen (the port's forge
# gave the same bytes then)
FORGED = {
    "ac6ee921d3e1dbecd9412e06f15ed5c9": dict(
        seed=3, width=64, height=64, qp=30, bit_depth=10, nframes=2,
        slice_type=2, sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
        sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1),
    "d950c7bb72500663dd73a96de3f119e5": dict(
        seed=4, width=64, height=64, qp=32, nframes=3,
        sps_temporal_mvp_enabled_flag=1),
    "436b81e2c21ab1d840757445a3917482": dict(
        seed=5, width=96, height=64, qp=32, nframes=3, slice_type=0,
        sps_dmvr_enabled_flag=1, sps_bdof_enabled_flag=1),
}
# the segments of seed 7 at SIZE, recorded when the generator was written
SEGMENTS = {
    "ai1080.seg2": ["e77fef37116ecc8655cdb2e499b65eed",
                    "a416f4b268ced89945869e4067007f77",
                    "d90118b6470a10f25a0c859dacfb13a5",
                    "fc3e74aa95b28fdeb81c4bb67386fb04"],
    "ra1080.gop2": ["c18058ca099218ed900528fe7163cd30",
                    "00c45d96ad44fc10377d29194a1f2174",
                    "f7315fec1ffa5a2b7eb5edc92695bf50",
                    "8a99f163578146b9d71e5c05f4232dcd"],
}
FORBIDDEN = {"jax", "jaxlib", "flax", "ffvvc_tpu"}


@pytest.mark.parametrize("md5", sorted(FORGED))
def test_frozen_forge_reproduces_recorded_streams(md5):
    assert hashlib.md5(F.forge_inter_stream(**FORGED[md5])).hexdigest() \
        == md5


@pytest.fixture(scope="module", params=sorted(SEGMENTS))
def forged(request):
    c = cells.cell(request.param)
    return c, segments.forge(c.config, c.traffic, 7, SIZE, processes=1)


def test_generator_reproduces_recorded_segments(forged):
    c, segs = forged
    assert [hashlib.md5(h + b"".join(f)).hexdigest() for h, f in segs] == \
        SEGMENTS[c.name]
    assert len(segs) == c.traffic["segments"]


def test_reference_equals_the_ports_host_decode(forged):
    """vvcref, and the frame-at-a-time form of all-intra segments, against
    the port's host decode (every device toggle off) on the cells' own
    segments at SIZE."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    c, segs = forged
    recs = reference.run(segs, c.traffic, processes=1)
    for (head, frames), want in zip(segs, recs):
        data = head + b"".join(frames)
        port = VVCDecoder(DecoderConfig(device="cpu")).decode(data)
        assert [(f.poc, reference.plane_digests(f.buffer.planes))
                for f in port] == [(r["poc"], r["md5"]) for r in want]
        assert [f.poc for f in RefDecoder().decode(data)] == \
            [r["poc"] for r in want]
        assert all(r["least_s"]["sao"] > 0 and r["least_s"]["alf"] > 0
                   for r in want)


def test_forge_groups_keep_inter_collocated_frames_together():
    tr = {"frames": [{"poc": 0, "slice": "I"},
                     {"poc": 4, "slice": "P", "collocated": 0},
                     {"poc": 2, "slice": "B", "collocated": 4},
                     {"poc": 1, "slice": "B", "collocated": 0}]}
    assert segments.forge_groups(tr) == [[0], [1, 2], [3]]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", ".cache",
                                                ".out")]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, BENCH)
                                        for p in _sources()))
def test_import_rule(path):
    """No file imports JAX or the JAX package (whole top-level names:
    `ffvvc_tpu_torch` begins with `ffvvc_tpu`); the reference imports
    nothing of the port either, and no native code."""
    tops = {m.split(".")[0] for m in _imports(os.path.join(BENCH, path))}
    assert not tops & FORBIDDEN
    if path.startswith("vvcref"):
        assert not tops & {"ffvvc_tpu_torch", "torch", "ctypes"}


def test_reference_loads_no_shared_object():
    code = (f"import sys; sys.path.insert(0, {BENCH!r})\n"
            "from vvcref import forge as F\n"
            "from vvcref.decoder import VVCDecoder\n"
            "d = F.forge_inter_stream(seed=1, width=64, height=64, "
            "nframes=2, slice_type=0)\n"
            "assert len(VVCDecoder().decode(d)) == 2\n"
            "maps = open('/proc/self/maps').read().split()\n"
            f"print([p for p in maps if p.startswith({ROOT!r}) and "
            "'.so' in p])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ffvvc_tpu_torch', 'ffvvc_tpu', 'jax', 'torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert out.split("\n")[:2] == ["[]", "[]"]


def test_tile_columns_without_filtering_across():
    """A traffic mix with two tile columns that no filter crosses (the
    traffic of the `ai1080.tiles` cell that PERF.md keeps for later): the
    generator forges it, and the reference decodes it as the port does."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    c = cells.cell("ai1080.seg2")
    tr = dict(c.traffic, segments=1, tile_columns=2, lf_across_tiles=0,
              lf_across_slices=0)
    (head, frames), = segments.forge(c.config, tr, 9, SIZE, processes=1)
    data = head + b"".join(frames)
    port = VVCDecoder(DecoderConfig(device="cpu")).decode(data)
    ref = RefDecoder().decode(data)
    assert [reference.plane_digests(f.buffer.planes) for f in port] == \
        [reference.plane_digests(f.buffer.planes) for f in ref]


def test_collocated_picture_is_signalled_from_its_list():
    """The B at POC 1 of `gop2` names POC 2, its L1[0], as its collocated
    picture, so TMVP reads an inter picture's motion there."""
    tr = cells.cell("ra1080.gop2").traffic
    by_poc = {f["poc"]: f for f in tr["frames"]}
    assert segments.collocated_from(by_poc[1]) == (0, 0)
    assert segments.collocated_from(by_poc[2]) == (1, 0)
    assert segments.collocated_from(by_poc[0]) == (1, 0)
