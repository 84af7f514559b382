"""pipeline.ref_wait_ms: the decoding thread blocked on its references'
pixels before MC (the port's `wait.refs` spans: a reference's rows, its
pixel job, the mesh's drain), ms an inter frame output; 0 where no wait
blocked."""
from harness import port_spans


def read(run):
    spans = port_spans.window(run)
    if spans is None or not run.inter_frames:
        return None
    return port_spans.wall_ms(spans, ("wait.refs",)) / run.inter_frames
