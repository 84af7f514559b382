"""stages.build_ms: the per-stage device filters' host parameter builds
(the port's `lmcs.build`, `deblock.build`, `sao.build` and `alf.build`
spans: the LMCS CTB mask, both directions' deblock segments, the SAO
tables with their restore ranges, the ALF parameters and edge words), wall
ms a frame output.  Absent where the port has no such spans."""
from harness import port_spans

BUILDS = ("lmcs.build", "deblock.build", "sao.build", "alf.build")


def read(run):
    spans = port_spans.window(run)
    if spans is None or not run.frames or \
            not any(s.name in BUILDS for s in spans):
        return None
    return port_spans.wall_ms(spans, BUILDS) / run.frames
