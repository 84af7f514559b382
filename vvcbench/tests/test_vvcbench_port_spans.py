"""The per-layer metrics that read the port's own spans
(`harness/port_spans.py`): each gives the expected number from known spans
inside the run's decode calls, ignores spans outside them, and is absent
where the port recorded none or has no `trace` module; and a CPU run with
the port's recording on reports them."""
import sys

import pytest

from conftest import SIZE
from harness import cells, runner, spans as bench_spans

import ffvvc_tpu_torch
from ffvvc_tpu_torch import trace

READERS = ("pipeline.ref_wait_ms", "pipeline.pixel_wait_ms", "mc.sync_ms",
           "host.offcpu_ms")


def port_span(name, t0, t1, cpu=None, thread="MainThread"):
    """A recorded span from t0 to t1 seconds, `cpu` seconds on its thread
    (all of it by default)."""
    s = trace.Span(name)
    s.t0, s.t1 = round(t0 * 1e9), round(t1 * 1e9)
    s.cpu_ns = s.t1 - s.t0 if cpu is None else round(cpu * 1e9)
    s.thread, s.tid, s.seq, s.poc = thread, 1, 0, 0
    return s


class View:
    """What a reader sees: two decode calls, 10-20 s and 30-40 s."""
    frames, inter_frames = 4, 2

    def __init__(self):
        self.spans = bench_spans.Recorder()
        self.spans.spans += [(bench_spans.SEGMENT, 1, 10.0, 20.0),
                             (bench_spans.SEGMENT, 1, 30.0, 40.0)]


KNOWN = [
    port_span("wait.refs", 11.0, 12.0),
    port_span("wait.refs", 31.0, 31.5),
    port_span("wait.pixels", 13.0, 15.0, cpu=0.001),
    port_span("mc", 16.0, 19.0),
    port_span("mc.download", 17.0, 17.25),
    port_span("mc.download", 18.0, 18.05),
    port_span("parse.slice", 32.0, 32.2, cpu=0.15),
    port_span("recon", 33.0, 33.1, cpu=0.1, thread="ffvvc-pixels_0"),
    port_span("fused.build", 34.0, 35.0, cpu=0.6, thread="ffvvc-pixels_0"),
    port_span("mc.put", 16.5, 16.9, cpu=0.4),
    # outside the decode calls: set-up, or another run's
    port_span("wait.refs", 50.0, 60.0),
    port_span("recon", 5.0, 9.0, cpu=0.0),
]


@pytest.fixture
def known(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(KNOWN))


@pytest.mark.parametrize("name,want", [
    ("pipeline.ref_wait_ms", 1500.0 / 2),
    ("pipeline.pixel_wait_ms", 2000.0 / 4),
    ("mc.sync_ms", 300.0 / 2),
    # parse 50 ms, fused.build 400 ms off the CPU; recon and mc.put none
    ("host.offcpu_ms", 450.0 / 4),
])
def test_reader_reads_known_spans(name, want, known):
    assert cells.reader(name)(View()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_absent_without_spans(name, monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert cells.reader(name)(View()) is None
    # spans of the port outside every decode call
    monkeypatch.setattr(trace, "spans", lambda: list(KNOWN[-2:]))
    assert cells.reader(name)(View()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_absent_without_the_module(name, monkeypatch):
    """A port from before `trace.py`: the import fails, nothing raises."""
    monkeypatch.delattr(ffvvc_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "ffvvc_tpu_torch.trace", None)
    assert cells.reader(name)(View()) is None


def test_no_wait_reads_zero_and_no_mc_reads_nothing(monkeypatch):
    only = [port_span("parse.slice", 11.0, 11.1)]
    monkeypatch.setattr(trace, "spans", lambda: only)
    assert cells.reader("pipeline.ref_wait_ms")(View()) == 0.0
    assert cells.reader("pipeline.pixel_wait_ms")(View()) == 0.0
    assert cells.reader("mc.sync_ms")(View()) is None


@pytest.mark.parametrize("name", ("ai1080.seg2", "ra1080.gop2"))
def test_a_run_with_the_ports_recording_on_reports_them(name, cache_root):
    """On the CPU the traced run has no profiler; a decoder built with
    `profile` records instead, in set-up and window alike, and only the
    window's spans count."""
    cell = cells.cell(name)
    cell.config["decoder"] = dict(cell.config["decoder"], profile=True)
    trace.clear()
    try:
        r = runner.run(cell, 8, 0.5, True, device="cpu", size=SIZE,
                       processes=1, cache_root=cache_root)
    finally:
        trace.clear()
    assert r["correct"]
    want = {"pipeline.pixel_wait_ms", "host.offcpu_ms"}
    if name.startswith("ra"):
        want |= {"pipeline.ref_wait_ms", "mc.sync_ms"}
    assert want <= set(r["metrics"])
    assert all(r["metrics"][k]["value"] >= 0 for k in want)
    if name.startswith("ra"):
        assert r["metrics"]["pipeline.ref_wait_ms"]["value"] > 0
