"""The tiled all-intra deployment of the benchmark's `ai1080.tiles` cell
through the port's normal path on the CPU device, at 416x240.

The cell's configuration and traffic (two tile columns, no loop filtering
across tiles or slices, one raster slice a picture) and the generator that
forges its segments are the benchmark's own, imported from `vvcbench/` by
path; the decoder takes the configuration's toggles, as the benchmark's
runner does.  The fused chain declines every such picture, so the
per-stage device filters (`ops/{lmcs,deblock,sao,alf}_device.py`: the
kernels' plain versions here) filter every frame, and the tiles' entry
points parse on `parse_workers` threads:

  * pictures: plane for plane equal to the benchmark's independent
    reference (`vvcbench/vvcref`) and to ffvvc_tpu's host decode, with one
    parse worker as with several;
  * spans: each stage's `.build`, `.upload` and `.download` once a frame,
    inside that stage's span; `parse.tile` once a tile, inside its slice's
    `parse.slice`, tagged with its frame;
  * counters: each stage's `stats` counts the frames it filtered and the
    bytes of the planes and parameters it moved, and
    `fused_device.reset_stats` zeroes them;
  * faults at the tile boundary (SAO's restore regions, ALF's edge words
    taken away) read as different from the reference.
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "vvcbench")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import cells, reference, segments  # noqa: E402
from vvcref.decoder import VVCDecoder as RefDecoder  # noqa: E402

from ffvvc_tpu.config import DecoderConfig as JaxConfig  # noqa: E402
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder  # noqa: E402
from ffvvc_tpu_torch import (DecoderConfig, VVCDecoder, threads,  # noqa: E402
                             trace)
from ffvvc_tpu_torch.ops import (alf_device, deblock_device,  # noqa: E402
                                 device, fused_device, lmcs_device,
                                 sao_device)

SIZE = (416, 240)
SEEDS = (9, 11)
CELL = cells.cell("ai1080.tiles")
STAGES = {"lmcs": lmcs_device, "deblock": deblock_device, "sao": sao_device,
          "alf": alf_device}
# the copies every stage makes, as `ops/device.py` defines them
UPLOAD, DOWNLOAD = device.upload, device.download


def config(**kw):
    return DecoderConfig(device="cpu", **dict(CELL.config["decoder"], **kw))


def digests(frames):
    return [(f.poc, reference.plane_digests(f.buffer.planes))
            for f in frames]


@pytest.fixture(scope="module", params=SEEDS)
def seg(request):
    """(seed, one segment of the cell's traffic, its reference digests)."""
    (head, frames), = segments.forge(CELL.config,
                                     dict(CELL.traffic, segments=1),
                                     request.param, SIZE, processes=1)
    data = head + b"".join(frames)
    return request.param, data, digests(RefDecoder().decode(data))


@pytest.fixture(scope="module")
def decoded(seg):
    """The port's decode with its spans recorded and every stage's copies
    watched: (digests, spans, each stage's stats, the fused chain's stats,
    each stage's copies: bytes up, and the shape and dtype of what came
    down)."""
    seed, data, _ = seg
    copies = {k: ([], []) for k in STAGES}
    with pytest.MonkeyPatch.context() as mp:
        for k, mod in STAGES.items():
            ups, downs = copies[k]

            def up(a, dev, counter, ups=ups):
                ups.append(np.ascontiguousarray(a).nbytes)
                return UPLOAD(a, dev, counter)

            def down(t, counter, downs=downs):
                downs.append((tuple(t.shape), str(t.dtype)))
                return DOWNLOAD(t, counter)
            mp.setattr(mod, "upload", up)
            mp.setattr(mod, "download", down)
        fused_device.reset_stats()
        trace.clear()
        frames = VVCDecoder(config(profile=True)).decode(data)
        got = trace.spans()
        trace.clear()
    return (digests(frames), got,
            {k: dict(m.stats) for k, m in STAGES.items()},
            dict(fused_device.stats), copies)


def test_traffic_is_the_tiled_deployment():
    tr = CELL.traffic
    assert (tr["tile_columns"], tr["lf_across_tiles"],
            tr["lf_across_slices"]) == (2, 0, 0)
    assert [f["slice"] for f in tr["frames"]] == ["I", "I"]
    assert CELL.config["decoder"]["device_pipeline"]
    # the configuration states the layout the traffic sets, and the
    # generator forges it at full size: columns of 8 and 7 CTUs, one row
    tiles = CELL.config["tiles"]
    assert (tiles["tile_columns"], tiles["lf_across_tiles"],
            tiles["lf_across_slices"]) == (tr["tile_columns"],
                                           tr["lf_across_tiles"],
                                           tr["lf_across_slices"])
    _, pps = segments._param_sets(CELL.config, tr, None)
    assert (pps.col_width_val, pps.row_height_val) == \
        (tiles["column_widths_ctu"], tiles["row_heights_ctu"])
    assert pps.pps_loop_filter_across_tiles_enabled_flag == 0
    # and is ai1080's in every other respect
    base = cells.load_json(os.path.join(BENCH, "configs", "ai1080.json"))
    same = set(base) - {"name", "source", "deployment", "assumed"}
    assert {k: CELL.config[k] for k in same} == {k: base[k] for k in same}


def test_port_equals_the_reference_and_the_host_decode(seg, decoded):
    seed, data, want = seg
    got, _, stats, fused, _ = decoded
    assert got == want and len(got) == 2
    host = JaxDecoder(JaxConfig()).decode(data)
    assert got == digests(host)
    # the fused chain declined every frame; every stage took each one
    assert fused["frames"] == 0
    assert {k: s["frames"] for k, s in stats.items()} == \
        dict.fromkeys(STAGES, 2)


def test_one_parse_worker_gives_the_same_pictures(seg):
    _, data, want = seg
    assert digests(VVCDecoder(config(parse_workers=1)).decode(data)) == want


def _inside(inner, outer):
    return outer.t0 <= inner.t0 and inner.t1 <= outer.t1


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_spans_nest_once_a_frame(stage, decoded):
    _, spans, _, _, _ = decoded
    outer = [s for s in spans if s.name == stage]
    assert sorted(s.poc for s in outer) == [0, 1]
    for part in ("build", "upload", "download"):
        inner = [s for s in spans if s.name == f"{stage}.{part}"]
        assert sorted(s.poc for s in inner) == [0, 1], part
        for s in inner:
            o, = [o for o in outer if o.poc == s.poc]
            assert s.thread == o.thread and _inside(s, o), part
    # build, then upload, then download
    for poc in (0, 1):
        t = {p: next(s.t0 for s in spans if s.name == f"{stage}.{p}" and
                     s.poc == poc) for p in ("build", "upload", "download")}
        assert t["build"] < t["upload"] < t["download"]


def test_tiles_parse_once_a_tile_inside_their_slice(decoded):
    _, spans, _, _, _ = decoded
    slices = [s for s in spans if s.name == "parse.slice"]
    tiles = [s for s in spans if s.name == "parse.tile"]
    assert len(slices) == 2 and len(tiles) == 2 * CELL.traffic["tile_columns"]
    for t in tiles:
        sl, = [s for s in slices if s.poc == t.poc]
        assert _inside(t, sl) and t.seq == sl.seq
    if threads.resolve(config().parse_workers) > 1:
        # on the parse workers, not on the decoding thread
        assert not {t.thread for t in tiles} & {s.thread for s in slices}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_counters_count_the_bytes_moved(stage, decoded):
    """Every copy a stage makes goes through `upload` or `download` and is
    counted; what comes down is whole 16-bit planes."""
    _, _, stats, _, copies = decoded
    st, (ups, downs) = stats[stage], copies[stage]
    assert st["frames"] == 2
    assert downs and all(d == "torch.int16" and len(s) == 2
                         for s, d in downs)
    assert st["down_bytes"] == sum(2 * h * w for (h, w), _ in downs)
    assert st["up_bytes"] == sum(ups) > st["down_bytes"]
    luma = (SIZE[1], SIZE[0])
    chroma = (SIZE[1] // 2, SIZE[0] // 2)
    assert {s for s, _ in downs} <= {luma, chroma}
    if stage == "lmcs":
        assert [s for s, _ in downs] == [luma] * 2
    if stage == "deblock":
        # every plane of both frames has edges: all three go down once each
        assert sorted(s for s, _ in downs) == sorted([luma, chroma, chroma] *
                                                     2)


def test_reset_zeroes_the_counters():
    """fused_device.reset_stats zeroes every declared key of its own
    counters and of the four stage modules'."""
    for m in (*STAGES.values(), fused_device):
        m.stats.update(dict.fromkeys(m.stats, 1))
    fused_device.reset_stats()
    for m in (*STAGES.values(), fused_device):
        assert {"frames", "up_bytes", "down_bytes"} <= m.stats.keys()
        assert not any(m.stats.values()), m.stats


def _no_sao_restore(monkeypatch):
    """SAO keeps no sample at a tile boundary: it filters across it."""
    from ffvvc_tpu_torch.sao import SaoFilter
    flags = SaoFilter._restore_flags

    def across(self, rx, ry):
        _, edges, _, _, _ = flags(self, rx, ry)
        return False, edges, [0, 0], [0, 0], [0, 0, 0, 0]
    monkeypatch.setattr(SaoFilter, "_restore_flags", across)


def _no_alf_edges(monkeypatch):
    """ALF and CC-ALF take their taps across the tile boundary."""
    monkeypatch.setattr(alf_device, "ctb_edges",
                        lambda af: np.zeros((af.pps.ctb_height,
                                             af.pps.ctb_width), np.int32))


@pytest.mark.parametrize("fault", (_no_sao_restore, _no_alf_edges))
def test_fault_at_the_tile_boundary_reads_different(fault, seg, monkeypatch):
    _, data, want = seg
    fault(monkeypatch)
    got = digests(VVCDecoder(config()).decode(data))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got != want

