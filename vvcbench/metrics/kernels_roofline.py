"""kernels_roofline: the hand kernels' share of their roofline, in %: the
least time of the work the SAO, ALF and CC-ALF stages had in the window
(`harness/roofline.py`, counted from the reference's per-CTB parameters of
each frame) over the device time of the kernels that did it, by name in
the trace.  Absent where the fused chain took no frame or no such kernel
ran."""

KERNELS = ("sao_kernel", "alf_kernel", "cc_kernel")


def read(run):
    if run.trace is None or not run.fused.get("frames"):
        return None
    device_s = run.trace.device_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(run.least_s.values()) / device_s
