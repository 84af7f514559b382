"""Spans of the decoder's own work: where a decode's time goes, by frame
and by thread.

A span is one stretch of one thread's work, or of its waiting: its name,
the frame it belongs to (the decoder's decode sequence number and the
POC), the thread's name and native id, its start and end on
`time.perf_counter_ns`, and the thread's CPU time over it
(`time.thread_time_ns`).  Spans of one thread nest.  A wait is a span of
its own (`wait.*`), recorded only when the wait blocks, and never folded
into a compute span.  The one span that does not nest is `pixels.queued`:
the time a frame's pixel job sat in the queue, from its submission to its
start, recorded on the worker when the job starts (it overlaps the
worker's previous job; its CPU time is 0).

Recording is on while a `torch.profiler` records
(`torch.autograd.profiler._is_profiler_enabled`, set by
`torch.profiler.profile` and `emit_nvtx` alike), and while a decoder built
with `DecoderConfig(profile=True)` decodes: from the start of its
`decode` or `flush` call to the end, and while one of its pixel jobs runs.
Off, `span()` checks those two flags and returns one shared no-op context.
While a profiler records, each span is also a
`torch.profiler.record_function("ffvvc.<name>")` range, which the profiler
puts on its trace's clock, with the thread's id, beside the device's work
(NVTX ranges under `emit_nvtx`).  The profiler keeps the ranges of the
thread that started it only, unless it was started with
`_ExperimentalConfig(profile_all_threads=True)`; the spans here are kept
on every thread, on `perf_counter_ns`, whose offset from the trace's clock
is the same for every span.

Recorded spans stay in this module until `clear()`; `spans()` lists them.
Each span's seconds are also added to its decoder's `stage_times` (seconds
by span name; nested spans count under their own names too).

The spans, by thread ("decoding" is the thread that calls `decode`;
"pixels" is the `ffvvc-pixels` worker under `pipeline_frames`, else the
decoding thread):

  decoding  parse.slice   `VVCDecoder._parse_slice`
            parse.tile    one entry point's batched native parse, in
                          `parse.slice`: on a `parse_workers` thread (tagged
                          with the decoding thread's frame) where a slice's
                          tiles parse in parallel, else on this thread
            itx           `ops/itx.py::frame_device_residuals`
            wait.refs     blocked on reference pixels before MC: a
                          reference's rows or pixel job, the mesh's drain
            wait.pixels   blocked on the pixel queue: `pipeline_depth`
                          jobs in flight, or the drain at the end of a call
            mc            `ops/mc_device.py::frame_device_mc`, one call a
                          frame
            mc.collect, mc.dmvr, mc.expand, mc.put, mc.finals,
            mc.writeback  its phases, in `mc`
            mc.download   the downloads of `mc.dmvr` and `mc.finals`: each
                          waits for the card
            mc.host       the host C MC (device MC off), `row` where it
                          runs one CTU row band
            mc.row_needs  the reference rows each CTU row's motion reaches,
                          before the host MC's row bands
  pixels    pixels.queued from submission to start (see above)
            recon         the C recon (`native/recon.py`: a job's CTUs, or
                          their residuals where the add is deferred)
            intra         device intra (`ops/intra_device.py`), its residual
                          walk a `recon` in it
            fused.build   `ops/fused_device.py`'s host parameter build, with
                          fused.deblock_raster, fused.sao_tables and
                          fused.alf_params in it
            fused.upload, fused.chain, fused.download
                          the chain's upload, its launches and the download
                          that waits for the card
            lmcs, deblock, sao, alf
                          the per-stage filters, device or host; in each
                          device one (`ops/<stage>_device.py`):
            lmcs.build, deblock.build, sao.build, alf.build
                          its host parameter build: the CTB mask; both
                          directions' deblock segments; the SAO tables with
                          their restore ranges; the ALF parameters and edge
                          words
            lmcs.upload, deblock.upload, sao.upload, alf.upload
                          its host-to-device copies
            lmcs.download, deblock.download, sao.download, alf.download
                          its device-to-host copies, which wait for the
                          card
            rows          the row-granular host pipeline
"""
from __future__ import annotations

import functools
import threading
import time

import torch.autograd.profiler as _profiler

_lock = threading.Lock()
# decode calls and pixel jobs of `profile` decoders running now
_profiling = 0
_spans = []


class Frame:
    """What a thread's spans are tagged with: a frame's decode sequence
    number and POC (None before a decoder's first frame), its decoder's
    `stage_times`, and whether that decoder records (`profile`)."""
    __slots__ = ("seq", "poc", "totals", "profile")

    def __init__(self, seq, poc, totals, profile):
        self.seq, self.poc = seq, poc
        self.totals, self.profile = totals, profile

    def next(self, poc):
        """The tag of the decoder's next frame."""
        return Frame(self.seq + 1 if self.seq is not None else 0, poc,
                     self.totals, self.profile)


class _Local(threading.local):
    frame = None


_local = _Local()


class Span:
    """One span; times in ns.  Entered as a context, it records itself on
    exit."""
    __slots__ = ("name", "seq", "poc", "row", "thread", "tid", "t0", "t1",
                 "cpu_ns", "_rf")

    def __init__(self, name, row=None):
        self.name, self.row = name, row

    @property
    def wall_ns(self):
        return self.t1 - self.t0

    def __enter__(self):
        # the range sits inside the span's clock: entering and leaving it
        # are calls into torch that let another thread take the
        # interpreter's lock, time the span's caller waits as well
        self.t0 = time.perf_counter_ns()
        self.cpu_ns = time.thread_time_ns()
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function("ffvvc." + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        self.t1 = time.perf_counter_ns()
        _add(self, _local.frame)

    def __repr__(self):
        return (f"Span({self.name!r}, seq={self.seq}, poc={self.poc}, "
                f"row={self.row}, thread={self.thread!r}, "
                f"wall_ns={self.wall_ns}, cpu_ns={self.cpu_ns})")


def _add(s, tag):
    th = threading.current_thread()
    s.thread, s.tid = th.name, threading.get_native_id()
    s.seq, s.poc = (tag.seq, tag.poc) if tag is not None else (None, None)
    _spans.append(s)
    if tag is not None:
        with _lock:
            tag.totals[s.name] = tag.totals.get(s.name, 0.0) + \
                (s.t1 - s.t0) * 1e-9


class _Off:
    """The shared context `span()` returns while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def recording():
    return bool(_profiling or _profiler._is_profiler_enabled)


def span(name, row=None):
    """A context that records the span `name` while recording is on."""
    if not (_profiling or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, row)


def traced(name):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_profiling or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def wait(name, future):
    """`future.result()`, as the span `name` when it blocks."""
    if future.done():
        return future.result()
    with span(name):
        return future.result()


def now():
    """perf_counter_ns while recording is on, else None."""
    return time.perf_counter_ns() if recording() else None


class _Tagged:
    """Tags the thread's spans with `tag`, and counts a `profile` decoder's
    call or pixel job as recording meanwhile."""
    __slots__ = ("tag", "prev", "submitted")

    def __init__(self, tag, submitted=None):
        self.tag, self.submitted = tag, submitted

    def __enter__(self):
        global _profiling
        if self.tag.profile:
            with _lock:
                _profiling += 1
        self.prev, _local.frame = _local.frame, self.tag
        if self.submitted is not None and recording():
            s = Span("pixels.queued")
            s.t0, s.t1, s.cpu_ns = self.submitted, time.perf_counter_ns(), 0
            _add(s, self.tag)

    def __exit__(self, *exc):
        global _profiling
        _local.frame = self.prev
        if self.tag.profile:
            with _lock:
                _profiling -= 1


def decoding(tag):
    """Around a decoder's `decode` or `flush` call; `tag` is its latest
    frame's (waits after the call's last frame carry that frame's)."""
    return _Tagged(tag)


def job(tag, submitted):
    """Around a frame's pixel job on the worker; records `pixels.queued`
    from `submitted` (`now()` at the submission) to the job's start."""
    return _Tagged(tag, submitted)


def enter(tag):
    """Tag the calling thread's spans with `tag` from now on."""
    _local.frame = tag


def current():
    """The calling thread's tag: None outside a decode call or pixel job."""
    return _local.frame


def handed(tag):
    """Around work that a thread tagged `tag` (its `current()`) hands to
    this one: tags this thread's spans with `tag` meanwhile."""
    return _Tagged(tag) if tag is not None else _OFF


def spans():
    """The spans recorded since `clear()`, in the order they ended."""
    return list(_spans)


def clear():
    _spans.clear()
