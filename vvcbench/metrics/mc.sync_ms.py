"""mc.sync_ms: device MC waiting for the card (the port's `mc.download`
spans: the DMVR refinements' and the finals' downloads inside each
`frame_device_mc` call), ms an inter frame output.  Absent where device MC
did not run."""
from harness import port_spans


def read(run):
    spans = port_spans.window(run)
    if spans is None or not run.inter_frames or \
            not any(s.name == "mc" for s in spans):
        return None
    return port_spans.wall_ms(spans, ("mc.download",)) / run.inter_frames
