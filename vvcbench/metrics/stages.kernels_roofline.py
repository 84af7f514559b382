"""stages.kernels_roofline: the hand kernels' share of their roofline where
the per-stage filters ran, in %: the least time of the work the SAO, ALF
and CC-ALF stages had in the window (`harness/roofline.py`, counted from
the reference's per-CTB parameters of each frame, whatever implements the
stage) over the device time of the kernels that did it, by name in the
trace (`sao_kernel`, and `alf_kernel` and `cc_kernel` in their edge-word
variants).  Absent off the card, and where no per-stage `sao` or `alf`
span ran or no such kernel did."""
from harness import port_spans

KERNELS = ("sao_kernel", "alf_kernel", "cc_kernel")


def read(run):
    if run.trace is None:
        return None
    spans = port_spans.window(run)
    if spans is None or not any(s.name in ("sao", "alf") for s in spans):
        return None
    device_s = run.trace.device_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(run.least_s.values()) / device_s
