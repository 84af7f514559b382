"""The port's spans (`ffvvc_tpu_torch/trace.py`) on the CPU device: off,
they record nothing and change no pixel; with `DecoderConfig(profile=True)`
under the frame pipeline they tag each span with its frame and thread,
nest on each thread and sum to `stage_times`; under `torch.profiler` each
is a `record_function` range on its thread."""
import concurrent.futures
import hashlib
import json
import os
import time

import pytest
import torch

from ffvvc_tpu_torch import DecoderConfig, VVCDecoder, trace
from ffvvc_tpu_torch.tools import forge as F

CONFIG = dict(device="cpu", device_mc=True, device_pipeline=True)
MC_PHASES = ("mc.collect", "mc.dmvr", "mc.expand", "mc.put", "mc.finals",
             "mc.writeback")


def forge_ibb(seed=1, width=416, height=240):
    """IDR, B at POC 2 (POC 0 in both lists) and B at POC 1 (POC 0 and 2:
    DMVR and BDOF), with SAO, ALF and CC-ALF, as a random-access segment
    of the benchmark."""
    sps_r = F.build_sps(width, height, bit_depth=10, min_qt_log2=2,
                        max_mtt_depth=2, sps_temporal_mvp_enabled_flag=1,
                        sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1,
                        sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                        sps_ccalf_enabled_flag=1)
    pps_r = F.build_pps(sps_r)
    stream = F.write_nal(F.NalType.SPS, F.write_sps(sps_r))
    stream += F.write_nal(F.NalType.PPS, F.write_pps(pps_r, sps_r))
    policy = F.FuzzPolicy(seed)
    aps = F.make_alf_aps(policy.rng, chroma=True, ccalf=True)
    stream += F.write_nal(F.NalType.PREFIX_APS, F.write_aps(aps))
    idr = None
    for poc, slice_type, deltas in ((0, F.SLICE_I, None),
                                    (2, F.SLICE_B, ([-2], [-2])),
                                    (1, F.SLICE_B, ([-1], [1]))):
        nal, shim = F.forge_frame(sps_r, pps_r, policy, qp=32, poc=poc,
                                  idr=poc == 0, slice_type=slice_type,
                                  ref_deltas=deltas, collocated=idr,
                                  alf_aps=aps, ccalf=True)
        stream += nal
        idr = idr or shim
    return stream


class LatePixels(concurrent.futures.ThreadPoolExecutor):
    """The decoder's pixel worker, each job started 0.2 s late: the B
    frames then always find their references in flight."""

    def __init__(self):
        super().__init__(max_workers=1, thread_name_prefix="ffvvc-pixels")

    def submit(self, fn):
        def late():
            time.sleep(0.2)
            return fn()
        return super().submit(late)


def md5s(frames):
    return [(f.poc, hashlib.md5(f.to_yuv_bytes()).hexdigest())
            for f in frames]


@pytest.fixture(scope="module")
def stream():
    return forge_ibb()


@pytest.fixture(scope="module")
def plain(stream):
    """The decode with recording off: its frames and the spans it left."""
    trace.clear()
    frames = VVCDecoder(DecoderConfig(**CONFIG)).decode(stream)
    return md5s(frames), trace.spans()


@pytest.fixture(scope="module")
def profiled(stream):
    """The decode with `profile` under the frame pipeline, its pixel jobs
    started late: (frames, spans, decoder)."""
    trace.clear()
    dec = VVCDecoder(DecoderConfig(profile=True, **CONFIG))
    dec._pix_exec = LatePixels()
    frames = md5s(dec.decode(stream))
    dec._pix_exec.shutdown()
    got = trace.spans()
    trace.clear()
    return frames, got, dec


def nests(spans):
    """Whether the spans of one thread nest: any two are disjoint or one
    holds the other."""
    order = sorted(spans, key=lambda s: (s.t0, -s.t1))
    open_ = []
    for s in order:
        while open_ and open_[-1].t1 <= s.t0:
            open_.pop()
        if open_ and s.t1 > open_[-1].t1:
            return False
        open_.append(s)
    return True


def test_off_records_nothing_and_changes_no_pixel(plain, profiled):
    md5_off, left = plain
    assert left == []
    assert not trace.recording()
    assert trace.span("mc") is trace.span("parse.slice") is \
        trace.span("wait.refs", row=3)
    with trace.span("mc") as s:
        assert s is None
    assert trace.spans() == []
    assert profiled[0] == md5_off and len(md5_off) == 3


def test_profile_tags_every_span_with_its_frame_and_thread(profiled):
    frames, spans, dec = profiled
    assert spans
    threads = {s.thread for s in spans}
    assert "MainThread" in threads
    assert any(t.startswith("ffvvc-pixels") for t in threads)
    # decode order: the IDR, then POC 2, then POC 1
    assert {(s.seq, s.poc) for s in spans} == {(0, 0), (1, 2), (2, 1)}
    for t in threads:
        assert nests([s for s in spans if s.thread == t
                      and s.name != "pixels.queued"]), t
    waits = {s.poc for s in spans if s.name == "wait.refs"}
    assert waits == {1, 2}
    assert all(s.thread == "MainThread" for s in spans
               if s.name.startswith(("wait.", "parse.", "mc")))
    assert all(s.thread.startswith("ffvvc-pixels") for s in spans
               if s.name.startswith(("recon", "fused.", "pixels.")))
    # one queued span and one fused chain a frame, on the worker
    for name in ("pixels.queued", "fused.build", "fused.download"):
        assert sorted(s.poc for s in spans if s.name == name) == [0, 1, 2]
    assert all(s.wall_ns >= 0 and s.cpu_ns >= 0 for s in spans)
    sums = {}
    for s in spans:
        sums[s.name] = sums.get(s.name, 0) + s.wall_ns * 1e-9
    assert dec.stage_times.keys() == sums.keys()
    for k, v in sums.items():
        assert dec.stage_times[k] == pytest.approx(v, rel=1e-9, abs=1e-12)


def test_waits_hold_little_cpu(profiled):
    _, spans, _ = profiled
    waited = [s for s in spans if s.name.startswith("wait.")]
    assert sum(s.wall_ns for s in waited) > 0.2e9
    assert sum(s.cpu_ns for s in waited) < 0.5 * sum(s.wall_ns
                                                     for s in waited)


def test_mc_phases_nest_in_mc(profiled):
    """One `mc` span per inter frame, though every reference was still in
    flight when its MC ran, and in each span every phase once."""
    _, spans, _ = profiled
    calls = [s for s in spans if s.name == "mc"]
    assert sorted((s.poc, s.row) for s in calls) == [(1, None), (2, None)]
    inner = [s for s in spans
             if s.name in MC_PHASES or s.name == "mc.download"]
    for s in inner:
        holders = [c for c in calls if c.tid == s.tid and
                   c.t0 <= s.t0 and s.t1 <= c.t1]
        assert len(holders) == 1, s
        assert holders[0].seq == s.seq
    for c in calls:
        held = [s.name for s in inner if c.t0 <= s.t0 and s.t1 <= c.t1]
        assert set(MC_PHASES) <= set(held), held
        for name in MC_PHASES:
            assert held.count(name) == 1
        # the downloads sit in the phases that wait for the card
        for d in (s for s in inner if s.name == "mc.download" and
                  c.t0 <= s.t0 and s.t1 <= c.t1):
            assert any(p.name in ("mc.dmvr", "mc.finals") and
                       p.t0 <= d.t0 and d.t1 <= p.t1 for p in inner)


def test_profiler_ranges_match_the_spans(stream, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    try:
        from torch._C._profiler import _ExperimentalConfig
        extra = dict(experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    except (ImportError, TypeError):     # no such option: one thread
        extra = None
    config = CONFIG if extra else dict(CONFIG, pipeline_frames=False)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU], **(extra or {})) as p:
        assert trace.recording()
        VVCDecoder(DecoderConfig(**config)).decode(stream)
    spans = [s for s in trace.spans() if s.name != "pixels.queued"]
    trace.clear()
    assert spans and not trace.recording()
    path = os.path.join(tmp_path, "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and
                  str(e.get("name", "")).startswith("ffvvc.")]
    if extra:
        assert len({s.tid for s in spans}) == 2
    assert len(events) == len(spans)
    # one offset puts every range inside its span: the span's clock starts
    # before the range opens and stops after it closes (the two may lie
    # apart by a wait for the interpreter's lock), both clocks in ns
    lo, hi = [], []
    for key in {(s.name, s.tid) for s in spans}:
        ours = sorted((s for s in spans if (s.name, s.tid) == key),
                      key=lambda s: s.t0)
        theirs = sorted((e for e in events if ("ffvvc." + key[0], key[1])
                         == (e["name"], e["tid"])), key=lambda e: e["ts"])
        assert len(ours) == len(theirs), key
        for s, e in zip(ours, theirs):
            lo.append((e["ts"] + e["dur"]) * 1e3 - s.t1)
            hi.append(e["ts"] * 1e3 - s.t0)
    assert max(lo) <= min(hi) + 1e5


def test_span_records_a_frames_tag_on_its_thread():
    totals = {}
    tag = trace.Frame(None, None, totals, True).next(7)
    trace.clear()
    with trace.decoding(tag):
        assert trace.recording()
        with trace.span("a", row=2):
            with trace.span("b"):
                pass
    assert not trace.recording()
    got = trace.spans()
    trace.clear()
    assert [(s.name, s.seq, s.poc, s.row) for s in got] == \
        [("b", 0, 7, None), ("a", 0, 7, 2)]
    assert got[1].t0 <= got[0].t0 <= got[0].t1 <= got[1].t1
    assert set(totals) == {"a", "b"}


def test_wait_records_only_when_it_blocks():
    done = concurrent.futures.Future()
    done.set_result(5)
    tag = trace.Frame(None, None, {}, True)
    trace.clear()
    with trace.decoding(tag), \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        assert trace.wait("wait.refs", done) == 5
        late = pool.submit(lambda: time.sleep(0.05) or 6)
        assert trace.wait("wait.pixels", late) == 6
    got = trace.spans()
    trace.clear()
    assert [s.name for s in got] == ["wait.pixels"]
    assert got[0].wall_ns >= 0.03e9 and got[0].cpu_ns < got[0].wall_ns


def test_torch_profiler_turns_recording_on():
    from torch.profiler import ProfilerActivity, profile
    assert trace.span("x") is trace.span("y")
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        with trace.span("x"):
            torch.zeros(1)
    assert [s.name for s in trace.spans()] == ["x"]
    trace.clear()


def test_threads_add_to_one_decoders_totals_without_losing_any():
    """Eight threads record spans of one decoder's frames at once, the
    interpreter switching threads every microsecond: no span and no second
    is lost from the list or from `stage_times`."""
    import sys
    import threading
    totals = {}
    tag = trace.Frame(None, None, totals, True).next(0)
    n = 400
    trace.clear()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with trace.decoding(tag):
                for _ in range(n):
                    with trace.span(f"t{i % 2}"):
                        pass
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    got = trace.spans()
    trace.clear()
    assert not trace.recording()
    assert len(got) == 8 * n
    for name in ("t0", "t1"):
        mine = [s for s in got if s.name == name]
        assert len(mine) == 4 * n
        assert totals[name] == pytest.approx(
            sum(s.wall_ns for s in mine) * 1e-9, rel=1e-9)
