"""What every device module of the port shares: the wire format of samples,
the copies between host and device with their byte counts, the counters,
the rows a launch filters (`Slab`), and the rule by which a hand-written
kernel's wrapper runs (`kernel_device`, `run`).

The rule: the tensors of one launch lie on one device, or the wrapper
raises ValueError before anything runs.  On CPU tensors the wrapper's plain
PyTorch twin runs.  On CUDA tensors the kernel runs on their card, on that
card's current stream, and the launch is counted on the wrapper
(`counted`).  Any other device raises; nothing falls back.
"""
from __future__ import annotations

import copy
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

# the narrowest CTB the kernels' tiles are laid out for
MIN_CTB = 16


class Counters(dict):
    """A module's counters: a dict of declared keys, each set back to its
    start value (0 unless given) by `reset()`."""

    def __init__(self, *keys, **start):
        super().__init__()
        self._start = {**dict.fromkeys(keys, 0), **start}
        self.reset()

    def reset(self):
        self.update(copy.deepcopy(self._start))


def as_wire(plane):
    """A host plane as the contiguous int16 array that travels to the
    device (samples have at most 12 bits)."""
    return np.ascontiguousarray(plane, dtype=np.int16)


def upload(a, dev, counters):
    """The host array `a` as a tensor of its own on `dev`, its bytes
    counted in `counters["up_bytes"]`."""
    a = np.ascontiguousarray(a)
    counters["up_bytes"] += a.nbytes
    return torch.from_numpy(a).to(dev, copy=True)


def download(t, counters):
    """The tensor `t` as a host array (waits for the card), its bytes
    counted in `counters["down_bytes"]`."""
    a = t.cpu().numpy()
    counters["down_bytes"] += a.nbytes
    return a


def log2(n, what):
    """log2 of the power of two n; ValueError for any other n."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")
    return n.bit_length() - 1


def stream_of(dev):
    """The raw handle of PyTorch's current stream on CUDA device dev."""
    return torch.cuda.current_stream(dev).cuda_stream


def one_device(name, tensors):
    """The device that all tensors of one launch lie on (None entries
    skipped); ValueError when they span devices, before anything runs."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: the tensors of one launch must lie on "
                         f"one device, not {sorted(map(str, devs))}")
    return devs.pop()


def counted(wrapper):
    """Declare `wrapper` a hand kernel's wrapper: its launch counters start
    at 0.  `run` adds to them: `launches` in all, `launches_by_device`
    by card index and `edge_launches` those with edge words."""
    wrapper.launches = wrapper.edge_launches = 0
    wrapper.launches_by_device = {}
    return wrapper


def count_launch(wrapper, dev, edges=False):
    """One launch of wrapper's kernel on CUDA device dev."""
    wrapper.launches += 1
    wrapper.edge_launches += bool(edges)
    by = wrapper.launches_by_device
    by[dev.index] = by.get(dev.index, 0) + 1


def kernel_device(name, i16, i32, edges=None):
    """The device a hand kernel's wrapper runs on, by the rule above.

    name: the wrapper's; i16: its sample tensors (int16, 8-byte aligned;
    None entries skipped); i32: its parameter tensors (int32); edges: its
    int32 edge words, or None.  Every tensor must be contiguous.  The
    wrapper runs its twin when this returns the CPU, else its own checks
    and then `run`; any other device raises ValueError here."""
    dev = one_device(name, (*i16, *i32, edges))
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    i16 = [t for t in i16 if t is not None]
    i32 = [t for t in (*i32, edges) if t is not None]
    if any(t.dtype != torch.int16 or t.data_ptr() % 8 for t in i16) or \
            any(t.dtype != torch.int32 for t in i32) or \
            not all(t.is_contiguous() for t in (*i16, *i32)):
        raise ValueError(f"{name}: contiguous, 8-byte aligned int16 "
                         "samples and int32 parameters expected")
    return dev


def run(wrapper, symbol, dev, *c_args, edges=False):
    """One launch of `wrapper`'s kernel: its launcher `symbol` in the
    kernel library, given c_args and the current stream of CUDA device
    dev, counted (`count_launch`).  The tensors c_args point into are the
    caller's to keep alive until this returns."""
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), symbol)(*c_args, stream_of(dev))
    _build.check(err, symbol)
    count_launch(wrapper, dev, edges)


class Slab(NamedTuple):
    """The rows a kernel launch filters, in picture rows: the output holds
    rows [row0, row0 + rows) of a plane pic_h rows high, and the source
    buffer holds the rows from row0 - top on, the slab's halo above
    included (and below it whatever rows the buffer has left).  Rows are
    read as the whole picture reads them, clamped to the picture, and
    further to the rows the buffer holds: a slab's output equals the same
    rows of a whole-picture launch wherever its halo covers what they
    read.  `whole(H)` is the whole picture."""
    row0: int
    rows: int
    pic_h: int
    top: int = 0

    @classmethod
    def whole(cls, H):
        return cls(0, H, H, 0)

    def span(self, R):
        """(rlo, rhi): the picture rows a buffer of R rows holds, inside
        the picture."""
        base = self.row0 - self.top
        return max(base, 0), min(base + R, self.pic_h) - 1

    def local(self, ys, R):
        """Picture rows ys (a tensor) clamped to what a buffer of R rows
        holds, as indices into the buffer."""
        rlo, rhi = self.span(R)
        return ys.clamp(rlo, rhi) - (self.row0 - self.top)

    def args(self, R):
        """The five ints a launcher takes for a buffer of R rows:
        row0, rows, pic_h, the buffer's first picture row, R."""
        return (ctypes.c_int * 5)(self.row0, self.rows, self.pic_h,
                                  self.row0 - self.top, R)

    def check(self, name, R):
        if not (0 <= self.top and self.top + self.rows <= R and
                0 <= self.row0 and self.rows > 0 and
                self.row0 + self.rows <= self.pic_h):
            raise ValueError(f"{name}: slab {tuple(self)} does not fit a "
                             f"buffer of {R} rows")

    def at_row0(self, x):
        """Address of the buffer's row row0 (its row `top`)."""
        return x.data_ptr() + self.top * x.stride(0) * x.element_size()


def ctb_rows(a, ys, cs_v, cs_h, W):
    """Per-CTB [.., ch, cw] -> per-sample [.., len(ys), W] for the picture
    rows ys (a tensor): each sample takes its CTB's value."""
    return a.index_select(-2, ys // cs_v).repeat_interleave(
        cs_h, -1)[..., :W]
