"""fused.device_ms: the fused chain's upload, chain and download, ms a
frame it took, from the port's counter `fused_device.stats["device_s"]`
(host clock, ends in the download's synchronisation)."""


def read(run):
    n = run.fused.get("frames", 0)
    return 1e3 * run.fused["device_s"] / n if n else None
