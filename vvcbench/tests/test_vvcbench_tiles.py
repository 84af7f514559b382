"""The `ai1080.tiles` cell on the CPU at a small size: a sound run reads
correct, a traced run with the port's recording on reports the per-stage
filters' and the tile parse's metrics (and no roofline off the card), the
control reads not correct; and the cell's readers give None, never 0 and
never an error, where the port has not their spans or counters."""
import sys

import pytest

from conftest import SIZE
from harness import cells, control, runner, spans as bench_spans

import ffvvc_tpu_torch
from ffvvc_tpu_torch import trace
from ffvvc_tpu_torch.ops import deblock_device

NAME = "ai1080.tiles"
SEED = 8
PORT_READ = ("stages.ms", "stages.build_ms", "stages.sync_ms",
             "stages.mb_moved", "parse.tile_parallelism")
READERS = PORT_READ + ("stages.kernels_roofline",)


def run(cache_root, trace_on=False, cell=None):
    return runner.run(cell or cells.cell(NAME), SEED, 0.5, trace_on,
                      device="cpu", size=SIZE, processes=1,
                      cache_root=cache_root)


def test_the_cell_reads_its_metrics():
    c = cells.cell(NAME)
    assert c.traffic["tile_columns"] == 2 and c.config["name"] == "ai1080_tiles"
    assert sorted(m["name"] for m in c.per_layer) == sorted(READERS)


def test_sound_run_is_correct(cache_root):
    r = run(cache_root)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "cpu_s_per_frame", "setup_s"}
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())


def test_traced_run_reads_the_stages_and_the_tile_parse(cache_root):
    """On the CPU the traced run has no profiler; a decoder built with
    `profile` records the port's spans instead.  The roofline needs the
    card's trace: absent here."""
    cell = cells.cell(NAME)
    cell.config["decoder"] = dict(cell.config["decoder"], profile=True)
    trace.clear()
    try:
        r = run(cache_root, True, cell)
    finally:
        trace.clear()
    assert r["correct"]
    assert set(PORT_READ) <= set(r["metrics"])
    assert "stages.kernels_roofline" not in r["metrics"]
    assert all(r["metrics"][k]["value"] > 0 for k in PORT_READ)
    # a frame's three 16-bit planes go up and down through deblock, SAO
    # and ALF, its luma through LMCS, with the parameters beside them
    plane = SIZE[0] * SIZE[1] * 2
    assert r["metrics"]["stages.mb_moved"]["value"] > \
        (3 * 2 * 1.5 + 2) * plane * 1e-6


@pytest.mark.parametrize("bits", (9, 10))
def test_control(bits, cache_root, monkeypatch):
    """The reference in the program's place: one bit below the stated
    precision it reads not correct; at full precision, correct."""
    c = cells.cell(NAME)
    cache = runner.Cache(c, SEED, SIZE, cache_root)
    segs = runner.load_segments(cache, c, SEED, SIZE, 1)
    monkeypatch.setattr(ffvvc_tpu_torch, "VVCDecoder", control.with_bits(
        bits, segs, c.traffic, c.config["bit_depth"], processes=1))
    r = run(cache_root)
    assert r["correct"] is (bits == 10)
    if bits == 9:
        assert r["checks"]["planes_differing"]["value"] > 0


class View:
    """What a reader sees of a run with one decode call, 10-20 s."""
    frames, inter_frames = 2, 0
    trace = None
    least_s = {"sao": 1e-6, "alf": 2e-6, "cc": 1e-6}

    def __init__(self):
        self.spans = bench_spans.Recorder()
        self.spans.spans.append((bench_spans.SEGMENT, 1, 10.0, 20.0))


def port_span(name, t0, t1, thread="MainThread"):
    s = trace.Span(name)
    s.t0, s.t1 = round(t0 * 1e9), round(t1 * 1e9)
    s.cpu_ns, s.thread, s.tid, s.seq, s.poc = s.t1 - s.t0, thread, 1, 0, 0
    return s


KNOWN = [
    port_span("parse.slice", 11.0, 11.2),
    port_span("parse.tile", 11.01, 11.16, "ThreadPoolExecutor-0_0"),
    port_span("parse.tile", 11.01, 11.13, "ThreadPoolExecutor-0_1"),
    port_span("deblock", 12.0, 12.1, "ffvvc-pixels_0"),
    port_span("deblock.build", 12.0, 12.03, "ffvvc-pixels_0"),
    port_span("deblock.download", 12.08, 12.09, "ffvvc-pixels_0"),
    port_span("sao", 12.1, 12.15, "ffvvc-pixels_0"),
    port_span("sao.build", 12.1, 12.11, "ffvvc-pixels_0"),
    port_span("sao.download", 12.14, 12.15, "ffvvc-pixels_0"),
]


class Trace:
    """A device trace whose SAO, ALF and CC-ALF kernels took 8 us."""
    device_s_by_name = {"sao_kernel(...)": 2e-6,
                        "void alf_kernel<true, true>(...)": 4e-6,
                        "void cc_kernel<1, 1, true>(...)": 2e-6,
                        "indexing_backward_kernel": 1e-3}

    def device_s(self, substrings):
        return sum(s for n, s in self.device_s_by_name.items()
                   if any(k in n for k in substrings))


@pytest.mark.parametrize("name,want", [
    ("stages.ms", 150.0 / 2),
    ("stages.build_ms", 40.0 / 2),
    ("stages.sync_ms", 20.0 / 2),
    ("parse.tile_parallelism", 270.0 / 200.0),
    ("stages.kernels_roofline", 100.0 * 4e-6 / 8e-6),
])
def test_reader_reads_known_spans(name, want, monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(KNOWN))
    view = View()
    view.trace = Trace()
    assert cells.reader(name)(view) == pytest.approx(want)


def test_bytes_moved_reads_the_counters(monkeypatch):
    from ffvvc_tpu_torch.ops import alf_device, lmcs_device, sao_device
    for i, mod in enumerate((lmcs_device, deblock_device, sao_device,
                             alf_device)):
        monkeypatch.setitem(mod.stats, "up_bytes", 1_000_000 * (i + 1))
        monkeypatch.setitem(mod.stats, "down_bytes", 500_000)
    assert cells.reader("stages.mb_moved")(View()) == pytest.approx(12 / 2)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_absent_where_the_port_has_nothing(name, monkeypatch):
    """No spans in the window, and a port from before these spans and
    counters (the per-stage modules without `up_bytes`): None, no error."""
    from ffvvc_tpu_torch.ops import alf_device, lmcs_device, sao_device
    view = View()
    view.trace = Trace()
    monkeypatch.setattr(trace, "spans", lambda: [])
    for mod in (lmcs_device, deblock_device, sao_device, alf_device):
        monkeypatch.setattr(mod, "stats", {"raster_native": 0})
    assert cells.reader(name)(view) is None
    # the parent's spans: the stages and the slices, no parts, no tiles
    monkeypatch.setattr(trace, "spans", lambda: [
        s for s in KNOWN if "." not in s.name or s.name == "parse.slice"])
    got = cells.reader(name)(view)
    if name in ("stages.ms", "stages.kernels_roofline"):
        assert got > 0
    else:
        assert got is None


def test_readers_are_absent_without_the_trace_module(monkeypatch):
    monkeypatch.delattr(ffvvc_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "ffvvc_tpu_torch.trace", None)
    view = View()
    view.trace = Trace()
    for name in READERS:
        if name != "stages.mb_moved":
            assert cells.reader(name)(view) is None, name
