"""stages.sync_ms: the per-stage device filters waiting for the card (the
port's `lmcs.download`, `deblock.download`, `sao.download` and
`alf.download` spans: each stage's device-to-host copies, which wait for
its launches), wall ms a frame output.  Absent where the port has no such
spans."""
from harness import port_spans

DOWNLOADS = ("lmcs.download", "deblock.download", "sao.download",
             "alf.download")


def read(run):
    spans = port_spans.window(run)
    if spans is None or not run.frames or \
            not any(s.name in DOWNLOADS for s in spans):
        return None
    return port_spans.wall_ms(spans, DOWNLOADS) / run.frames
