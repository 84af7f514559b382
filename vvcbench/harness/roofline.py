"""The least time of the hand kernels' work: the yardstick of
`kernels_roofline`.

A frozen copy of `chip_smoke.py`'s bound arithmetic (PEAK_BYTES_S,
PEAK_PIPE_OPS_S, ALF_*_OPS, SAO_OPS, CC_*_OPS and the byte counts of
`kernel_cases`), with one change: the work is counted from the samples that
each stage filters as a frame's per-CTB parameters set them, read from the
reference's parse (`frame_work`), and not from a launch's own inputs.  So
the yardstick reads the same work whatever implements the stage.  Where
every CTB is on, the counts equal `chip_smoke.py`'s at its shapes.

The least time of a stage is the larger of its bytes at the peak memory
rate and its integer operations on the busier of the SM's two integer
pipes.  Bytes: every filtered sample read and written once as 16 bits,
and the parameter tables (the chain's layout: SAO 11 int32 a CTB; ALF a
set index a CTB, class and transpose int32 a 4x4 block, 12 coefficients
and 12 clips int32 a filter; CC-ALF a set index a CTB and 7 coefficients
a filter).  Operations: those the function needs a sample, whatever a
kernel spends on addresses and staging.
"""
from __future__ import annotations

import numpy as np

# One H100 SXM at its full 700 W (NVIDIA's data sheet): 3.35 TB/s of device
# memory; 67 TFLOP/s of float32 outside the tensor cores.  32-bit integer
# instructions have two pipes an SM, each 64 lanes wide (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0), so the busier pipe runs at a quarter of the float32 figure in
# instructions a second.
PEAK_BYTES_S = 3.35e12
PEAK_PIPE_OPS_S = 67e12 / 4
# (ALU, FMA) integer operations an output sample needs.  ALF: a slot is
# two taps of subtract (FMA), max and min (ALU), then an add and a
# multiply-add (FMA); the tail a rounding add, a shift, the add to the
# sample and a clip.
ALF_LUMA_OPS = (12 * 4 + 3, 12 * 4 + 2)
ALF_CHROMA_OPS = (6 * 4 + 3, 6 * 4 + 2)
# SAO by the type of the sample's CTB: off; band (shift, mask, compare,
# select and clip on the ALU, subtract and add on the FMA pipe); edge (two
# signs of max and min and the clip; two subtracts, the add of the signs
# and of the offset).
SAO_OPS = {0: (0, 0), 1: (6, 2), 2: (6, 4)}
# CC-ALF: a filtered position has 7 luma differences, whichever planes use
# them; each plane 7 multiply-adds and a tail of a rounding add, a shift, a
# clip, the add to chroma and a clip.
CC_DIFF_OPS = (0, 7)
CC_TAP_OPS = (0, 7)
CC_TAIL_OPS = (5, 2)
SAMPLE_BYTES = 2
SAO_TABLE_BYTES = 11 * 4
ALF_LUMA_FILTER_BYTES = 25 * 12 * 4 * 2
ALF_CHROMA_FILTER_BYTES = 12 * 4 * 2
CC_FILTER_BYTES = 7 * 4
STAGES = ("sao", "alf", "cc")


def least_s(nbytes, ops):
    """max(bytes / peak rate, busier pipe's operations / pipe rate)."""
    return max(nbytes / PEAK_BYTES_S, max(ops) / PEAK_PIPE_OPS_S)


def ctb_samples(h, w, cs_v, cs_h):
    """Samples of each CTB [ch, cw] of an h x w plane (edge CTBs cut)."""
    rows = np.minimum(cs_v, h - np.arange(-(-h // cs_v)) * cs_v)
    cols = np.minimum(cs_h, w - np.arange(-(-w // cs_h)) * cs_h)
    return rows[:, None].astype(np.int64) * cols[None, :]


def sao_work(plane_shapes, sizes, types):
    """One launch over the planes.  plane_shapes [(h, w)], sizes [(cs_v,
    cs_h)], types [ch, cw] SAO type of each CTB of each plane.  Returns
    (bytes, (alu, fma))."""
    nbytes, ops = 0, np.zeros(2, np.int64)
    for (h, w), (cv, chs), typ in zip(plane_shapes, sizes, types):
        n = ctb_samples(h, w, cv, chs)
        on = typ != 0
        if not on.any():
            continue
        nbytes += 2 * SAMPLE_BYTES * int(n[on].sum()) + \
            SAO_TABLE_BYTES * typ.size
        for t, o in SAO_OPS.items():
            ops += int(n[typ == t].sum()) * np.array(o)
    return nbytes, tuple(int(x) for x in ops)


def alf_luma_work(h, w, cs, on, n_sets):
    """Luma ALF over the CTBs `on` [ch, cw] with `n_sets` filters in use."""
    n = ctb_samples(h, w, cs, cs)
    samples = int(n[on].sum())
    if not samples:
        return 0, (0, 0)
    nbytes = 2 * SAMPLE_BYTES * samples + 2 * 4 * (samples // 16) + \
        4 * on.size + ALF_LUMA_FILTER_BYTES * n_sets
    return nbytes, tuple(samples * x for x in ALF_LUMA_OPS)


def alf_chroma_work(h, w, cs_v, cs_h, ons, n_sets):
    """Chroma ALF of the planes (one launch); ons [ch, cw] per plane,
    n_sets filters of each plane in use."""
    n = ctb_samples(h, w, cs_v, cs_h)
    nbytes, samples = 0, 0
    for on, k in zip(ons, n_sets):
        s = int(n[on].sum())
        if s:
            samples += s
            nbytes += 2 * SAMPLE_BYTES * s + 4 * on.size + \
                ALF_CHROMA_FILTER_BYTES * k
    return nbytes, tuple(samples * x for x in ALF_CHROMA_OPS)


def cc_work(h, w, cs_v, cs_h, ons, n_filters, luma_per_chroma):
    """CC-ALF of the chroma planes (one launch): ons [ch, cw] per plane,
    n_filters of each plane in use; luma_per_chroma luma samples a chroma
    position reads its luma from (4 for 4:2:0)."""
    n = ctb_samples(h, w, cs_v, cs_h)
    anyon = np.zeros_like(ons[0], bool)
    nbytes, ops = 0, np.zeros(2, np.int64)
    for on, k in zip(ons, n_filters):
        s = int(n[on].sum())
        if s:
            anyon |= on
            nbytes += 2 * SAMPLE_BYTES * s + 4 * on.size + CC_FILTER_BYTES * k
            ops += s * (np.array(CC_TAP_OPS) + np.array(CC_TAIL_OPS))
    pos = int(n[anyon].sum())
    nbytes += SAMPLE_BYTES * luma_per_chroma * pos
    ops += pos * np.array(CC_DIFF_OPS)
    return nbytes, tuple(int(x) for x in ops)


def frame_work(h, w, cs, hs, vs, sao_type, alf_flag, alf_luma_sets,
               alf_chroma_sets, cc_idc):
    """Least seconds of each stage's work on one 4:2:0 or 4:2:2 frame.
    Per-CTB arrays in the reference's raster layout: sao_type [nctb, 3],
    alf_flag [nctb, 3], cc_idc [nctb, 2]; alf_luma_sets the number of
    luma filter sets in use, alf_chroma_sets [2] the chroma filters of
    each plane in use."""
    ch, cw = -(-h // cs), -(-w // cs)
    hc, wc, cv, chs = h >> vs, w >> hs, cs >> vs, cs >> hs

    def grid(a):
        return np.asarray(a).reshape(ch, cw)
    sao = sao_work([(h, w), (hc, wc), (hc, wc)],
                   [(cs, cs), (cv, chs), (cv, chs)],
                   [grid(sao_type[:, c]) for c in range(3)])
    luma = alf_luma_work(h, w, cs, grid(alf_flag[:, 0]) != 0, alf_luma_sets)
    chroma = alf_chroma_work(hc, wc, cv, chs,
                             [grid(alf_flag[:, c]) != 0 for c in (1, 2)],
                             alf_chroma_sets)
    ons = [grid(cc_idc[:, c]) != 0 for c in (0, 1)]
    cc = cc_work(hc, wc, cv, chs, ons,
                 [len(np.unique(grid(cc_idc[:, c])[o])) for c, o in
                  enumerate(ons)], 1 << (hs + vs))
    return {"sao": least_s(*sao),
            "alf": least_s(*luma) + least_s(*chroma),
            "cc": least_s(*cc)}
