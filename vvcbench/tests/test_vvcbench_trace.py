"""The reduction of the device trace on a synthetic Chrome trace."""
import pytest

from harness import trace


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_summary():
    events = [
        ev("user_annotation", "vvcbench.segment", 1000, 1000),
        ev("user_annotation", "vvcbench.segment", 3000, 500),
        ev("kernel", "void sao_kernel(SaoArgs)", 1100, 100),
        ev("kernel", "void alf_kernel<true, false>(AlfArgs)", 1150, 100),
        ev("gpu_memcpy", "Memcpy HtoD", 1900, 50),
        ev("kernel", "outside", 2500, 100),       # between the segments
        ev("kernel", "void cc_kernel<1, 1, false>(CcArgs)", 3100, 50),
        ev("cpu_op", "aten::add", 1000, 900),
    ]
    # the host's spans, on perf_counter seconds: 0.5 s before the trace
    host = [("segment", 1, 0.0005, 0.0015), ("segment", 1, 0.0025, 0.003),
            ("fused.deblock_raster", 2, 0.0008, 0.0014),
            ("decoder.parse", 1, 0.00076, 0.0008)]
    s = trace.Summary(events, host)
    assert s.window_s == pytest.approx(1500e-6)
    assert s.busy_s == pytest.approx(250e-6)
    assert s.device_s(("sao_kernel", "alf_kernel", "cc_kernel")) == \
        pytest.approx(250e-6)
    assert "outside" not in dict(s.top_ops())
    gaps = [(round(g * 1e6), n) for n, g in s.idle_gaps]
    # 1250-1900: the raster span (1300-1900) holds most of it; 1000-1100:
    # parse (1260-1300 on the trace's clock) holds none of it
    assert gaps == [(650, "fused.deblock_raster"), (350, "segment"),
                    (100, "segment"), (100, "segment"), (50, "segment")]
