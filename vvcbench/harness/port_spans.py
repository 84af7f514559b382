"""The port's own spans (`ffvvc_tpu_torch/trace.py`) of a traced run's
window, for the per-layer metrics that read them.

The port records its spans while a profiler runs, and the traced run's
profiler runs over the window alone; a span counts where it lies inside
one of the run's decode calls (the benchmark's `segment` spans, on the
same `perf_counter` clock).  A port without the module, or one that
recorded nothing there, gives None, and so does every reader."""
from __future__ import annotations

from . import spans as bench_spans


def window(run):
    """The port's spans inside the run's decode calls, or None."""
    try:
        from ffvvc_tpu_torch import trace
    except ImportError:
        return None
    calls = sorted((a, b) for n, _, a, b in run.spans.spans
                   if n == bench_spans.SEGMENT)
    got = [s for s in trace.spans()
           if any(a <= s.t0 * 1e-9 and s.t1 * 1e-9 <= b for a, b in calls)]
    return got or None


def wall_ms(spans, names):
    """The summed wall time of the spans named `names`, in ms."""
    return 1e-6 * sum(s.t1 - s.t0 for s in spans if s.name in names)
