"""The control of `correct`: the frozen reference put in the program's
place and computed one bit below the configuration's precision (its
samples rounded down to 9 of their 10 bits), which the comparison has to
find wrong.  `with_bits(10)` is the same reference at full precision,
which it has to find right.

The segments are decoded once, in parallel processes as the reference
decodes them, and each decode call then returns the stored frames.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from . import reference
from .segments import pool


class _Buffer:
    def __init__(self, planes):
        self.planes = planes


class _Frame:
    def __init__(self, poc, planes):
        self.poc, self.buffer = poc, _Buffer(planes)

    def recycle(self):
        pass


def _decode(args):
    from vvcref.decoder import VVCDecoder
    key, data = args
    return key, [(f.poc, f.buffer.planes) for f in VVCDecoder().decode(data)]


def with_bits(bits, segments, traffic, bit_depth, processes=None):
    """A decoder class for `ffvvc_tpu_torch.VVCDecoder`'s place that
    returns the reference's frames of these segments at `bits` of
    precision."""
    groups = reference.groups(traffic)
    jobs = [((s, k), head + b"".join(frames[i] for i in g))
            for s, (head, frames) in enumerate(segments)
            for k, g in enumerate(groups)]
    with pool(min(len(jobs), processes or os.cpu_count() or 1)) as ex:
        got = dict(ex.map(_decode, jobs))
    drop = np.int32(~((1 << (bit_depth - bits)) - 1))
    stored = {}
    for s, (head, frames) in enumerate(segments):
        out = [x for k in range(len(groups)) for x in got[(s, k)]]
        if len(groups) > 1:
            out.sort(key=lambda x: x[0])
        data = head + b"".join(frames)
        stored[hashlib.sha256(data).digest()] = [
            (poc, [p & drop for p in planes]) for poc, planes in out]

    class Control:
        def __init__(self, config=None):
            pass

        def decode(self, data):
            return [_Frame(poc, [p.copy() for p in planes]) for poc, planes
                    in stored[hashlib.sha256(data).digest()]]
    return Control
