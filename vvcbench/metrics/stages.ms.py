"""stages.ms: the per-stage filters (the port's `lmcs`, `deblock`, `sao`
and `alf` spans: `ops/<stage>_device.py::<stage>_frame_device`, or the host
stage where its device toggle is off), wall ms a frame output.  Absent
where no frame took them, as where the fused chain filtered every frame."""
from harness import port_spans

STAGES = ("lmcs", "deblock", "sao", "alf")


def read(run):
    spans = port_spans.window(run)
    if spans is None or not run.frames or \
            not any(s.name in STAGES for s in spans):
        return None
    return port_spans.wall_ms(spans, STAGES) / run.frames
