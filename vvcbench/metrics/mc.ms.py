"""mc.ms: device MC (`ops/mc_device.py::frame_device_mc`), busy ms of the
benchmark's span an inter frame output."""


def read(run):
    if not run.inter_frames or not run.spans.count("mc"):
        return None
    return 1e3 * run.spans.busy_s("mc") / run.inter_frames
