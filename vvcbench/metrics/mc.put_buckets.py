"""mc.put_buckets: device MC's put buckets (batched launches of one filter
class and shape) an inter frame, from `mc_device.stats["put_buckets"]`."""


def read(run):
    n = run.mc.get("put_buckets", 0)
    return n / run.inter_frames if run.inter_frames and n else None
