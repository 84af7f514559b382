"""fused.build_ms: the fused chain's host parameter build
(`ops/fused_device.py`: deblock rasterizer, SAO tables, ALF parameters,
the planes staged for upload), ms a frame it took, from the port's own
counter `fused_device.stats["build_s"]`."""


def read(run):
    n = run.fused.get("frames", 0)
    return 1e3 * run.fused["build_s"] / n if n else None
