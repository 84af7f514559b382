"""The device trace of the traced run: `torch.profiler` with CUDA activity
over the window, exported as a Chrome trace and reduced here.

The window is the union of the `vvcbench.segment` ranges (the decode
calls); the harness's own work between them is outside it.  Busy time is
the union of the intervals of kernels, copies and sets on the card inside
the window; an idle gap is named by the benchmark span that holds most of
it on the host, each instant going to the innermost span open then.
"""
from __future__ import annotations

import bisect
import json
import os

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
PREFIX = "vvcbench."


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(iv, windows):
    """Intervals `iv` (merged, sorted) cut to the windows (merged, sorted)."""
    out, j = [], 0
    for a, b in windows:
        while j < len(iv) and iv[j][1] <= a:
            j += 1
        k = j
        while k < len(iv) and iv[k][0] < b:
            out.append([max(a, iv[k][0]), min(b, iv[k][1])])
            k += 1
    return out


class Summary:
    """What the readers take from the trace (times in seconds)."""

    def __init__(self, events, host_spans=()):
        """events: the Chrome trace's; host_spans: the Recorder's (name,
        thread, start, end) on perf_counter, put on the trace's clock by
        the segment ranges both hold."""
        spans, dev = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = str(e.get("cat", "")).lower()
            if cat in DEVICE_CATS:
                dev.append((t0, t1, e["name"]))
            elif cat == "user_annotation" and \
                    str(e["name"]).startswith(PREFIX):
                spans.append((t0, t1, e["name"][len(PREFIX):]))
        windows = _merge([(a, b) for a, b, n in spans if n == "segment"])
        busy = _clip(_merge([(a, b) for a, b, _ in dev]), windows)
        self.window_s = sum(b - a for a, b in windows) * 1e-6
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        starts = [w[0] for w in windows]
        by_name = {}
        for a, b, n in dev:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < windows[i][1]:
                by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        self.device_s_by_name = by_name
        gaps = []
        for w0, w1 in windows:
            t = w0
            for a, b in (iv for iv in busy if w0 <= iv[0] < w1):
                if a > t:
                    gaps.append((a - t, t))
                t = max(t, b)
            if w1 > t:
                gaps.append((w1 - t, t))
        gaps.sort(reverse=True)
        inner = _on_trace_clock(host_spans, spans) or spans
        inner = [(a, b, n) for a, b, n in inner if n != "segment"]
        self.idle_gaps = [[_holder(inner, t, t + g), g * 1e-6]
                          for g, t in gaps[:10]]

    def device_s(self, substrings):
        return sum(s for n, s in self.device_s_by_name.items()
                   if any(k in n for k in substrings))

    def top_ops(self, n=10):
        """The n device operations that took most time, their names cut
        to 160 characters."""
        return [[k[:160], v] for k, v in sorted(
            self.device_s_by_name.items(), key=lambda kv: -kv[1])[:n]]


def _on_trace_clock(host_spans, trace_spans):
    """The host spans (seconds) on the trace's clock (us): shifted by the
    median offset between the segment ranges of the two."""
    ours = sorted(a for n, _, a, _ in host_spans if n == "segment")
    theirs = sorted(a for a, _, n in trace_spans if n == "segment")
    if not ours or len(ours) != len(theirs):
        return None
    off = sorted(t - o * 1e6 for o, t in zip(ours, theirs))[len(ours) // 2]
    return [(a * 1e6 + off, b * 1e6 + off, n) for n, _, a, b in host_spans]


def _holder(spans, t0, t1):
    """The span that holds most of [t0, t1), each instant going to the
    innermost span open then (the one that began last, on any thread)."""
    cuts = sorted({t0, t1} | {x for a, b, _ in spans for x in (a, b)
                              if t0 < x < t1})
    held = {}
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s0, n) for s0, s1, n in spans if s0 <= a and b <= s1]
        name = max(open_)[1] if open_ else "segment"
        held[name] = held.get(name, 0.0) + (b - a)
    return max(held.items(), key=lambda kv: kv[1])[0]


def read(prof, path, host_spans=()):
    """Stop the profiler and summarise its trace (the file is removed)."""
    prof.stop()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return Summary(events, host_spans)
