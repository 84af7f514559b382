"""stages.mb_moved: the bytes the per-stage device filters moved between
host and card, both ways (the port's counters `stats["up_bytes"]` and
`stats["down_bytes"]` of `ops/lmcs_device.py`, `deblock_device.py`,
`sao_device.py` and `alf_device.py`, zeroed by `fused_device.reset_stats`
before the window), MB (1e6 bytes) a frame output.  Absent where a module
has no such counter or none moved a byte."""
import importlib

MODULES = ("lmcs_device", "deblock_device", "sao_device", "alf_device")


def read(run):
    if not run.frames:
        return None
    moved = 0
    for name in MODULES:
        try:
            mod = importlib.import_module("ffvvc_tpu_torch.ops." + name)
        except ImportError:
            return None
        stats = getattr(mod, "stats", {})
        if "up_bytes" not in stats or "down_bytes" not in stats:
            return None
        moved += stats["up_bytes"] + stats["down_bytes"]
    return 1e-6 * moved / run.frames if moved else None
