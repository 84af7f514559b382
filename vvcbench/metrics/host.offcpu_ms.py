"""host.offcpu_ms: wall time off the CPU inside the host threads' compute
spans, ms a frame output: each span's wall time less its thread's CPU time
over it, summed over the spans that hold no wait and no download, so that
what is left is time the thread was ready but not running (the other
thread holding the interpreter's lock, or the cores taken):

    parse.slice  host parse (decoding thread)
    recon        host recon (pixel thread)
    fused.build  the fused chain's host parameter build (pixel thread)
    mc.collect, mc.expand, mc.put
                 device MC's host descriptor work and launches (decoding
                 thread)
"""
from harness import port_spans

COMPUTE = ("parse.slice", "recon", "fused.build", "mc.collect",
           "mc.expand", "mc.put")


def read(run):
    spans = port_spans.window(run)
    if spans is None or not run.frames:
        return None
    held = [s for s in spans if s.name in COMPUTE]
    if not held:
        return None
    return 1e-6 * sum((s.t1 - s.t0) - s.cpu_ns for s in held) / run.frames
