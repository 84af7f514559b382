"""pipeline.pixel_wait_ms: the decoding thread blocked on the pixel queue
(the port's `wait.pixels` spans: `pipeline_depth` jobs in flight, and the
drain at the end of each decode call), ms a frame output; 0 where no wait
blocked."""
from harness import port_spans


def read(run):
    spans = port_spans.window(run)
    if spans is None or not run.frames:
        return None
    return port_spans.wall_ms(spans, ("wait.pixels",)) / run.frames
