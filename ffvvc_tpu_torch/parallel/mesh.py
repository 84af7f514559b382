"""Multi-device decode over a ("gop", "tile") array of torch devices.

Port of `ffvvc_tpu/parallel/mesh.py`.  Axes:
  * "gop"  — frame-parallel: different frames of a GOP filter on different
    devices (the form of the reference's 16-deep frame pipeline,
    libavcodec/vvc/vvcdec.c:830-841 submit/wait).
  * "tile" — spatial row-slab parallel within a frame (the form of the
    reference's CTU wavefront / tile parallelism,
    libavcodec/vvc/vvc_thread.c:41-51).

The JAX package runs shard_map programs over a jax.sharding.Mesh and moves
its halos with jax.lax.ppermute.  Here the mesh is one process's array of
torch devices and nothing else: a slab is a tensor on its own device, each
pass and kernel launch runs on that device, and the boundary rows of the
slabs above and below move to it as explicit copies (`exchange_row_halo`),
device to device between cards.  PyTorch orders such a copy after the
current streams of both cards, and every launch runs on its card's current
stream, so no event is needed.  As the JAX mesh takes one chip a position,
a CUDA mesh takes one card a position: `cuda:0` .. `cuda:g*t-1` of the
visible cards, gop-major, or an explicit list.  A list may repeat a device
(the form of the JAX tests' virtual devices, which torch lacks): one card
repeated runs the mesh on that card, "cpu" repeated runs it in the tests.

Of the JAX module, `make_mesh` and `build_sharded_residual_step` are not
ported (nothing calls them); `make_mesh_exact`, which the JAX package keeps
in `parallel/filters.py`, lives here.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A ("gop", "tile") array of torch devices: `shape["gop"]`,
    `shape["tile"]` and `devices[gop, tile]`."""

    def __init__(self, devices):
        self.devices = devices
        g, t = devices.shape
        self.shape = {"gop": g, "tile": t}

    def device(self, gop, tile):
        return self.devices[gop, tile]


def make_mesh_exact(shape, devices=None, device="cuda") -> Mesh:
    """("gop", "tile") mesh with exactly the requested shape: the first
    g * t of `devices`, gop-major.  Without a list a CUDA `device` takes
    the visible cards, `cuda:0` first, as the JAX function takes
    jax.devices(); any other device is repeated g * t times.  Fewer
    devices than positions raise."""
    g, t = shape
    if devices is None:
        if torch.device(device).type == "cuda":
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        else:
            devices = [device] * (g * t)
    if g * t > len(devices):
        raise ValueError(f"mesh_shape {shape} needs {g * t} devices, "
                         f"have {len(devices)}")
    arr = np.empty((g, t), dtype=object)
    for i, d in enumerate(devices[:g * t]):
        arr[i // t, i % t] = torch.device(d)
    return Mesh(arr)


def slab_rows(H, t, min_rows=1):
    """Rows of each of the t slabs of a plane H rows high: ceil(H / t), and
    at least `min_rows` (the widest halo: a halo comes from the
    neighbouring slab alone)."""
    return max(min_rows, -(-H // t))


def _pad_rows(x, t, hs):
    """Pad axis -2 of x up to t * hs rows, replicating the last row (the
    bottom halo then holds the frame's edge)."""
    H = x.shape[-2]
    if H == t * hs:
        return x
    last = x[..., H - 1:H, :]
    return torch.cat([x, last.expand(*x.shape[:-2], t * hs - H,
                                     x.shape[-1])], dim=-2)


def cut_rows(x, mesh, gop, hs):
    """[H, W] -> the mesh's t row slabs of hs rows, slab i on
    devices[gop, i]; the last slabs padded by the frame's edge row."""
    t = mesh.shape["tile"]
    x = _pad_rows(x, t, hs)
    return [x[i * hs:(i + 1) * hs].to(mesh.device(gop, i))
            for i in range(t)]


def join_rows(slabs, H, device):
    """The slabs of a plane, on `device`, as one [H, W] tensor."""
    return torch.cat([s.to(device) for s in slabs])[:H]


def exchange_row_halo(slabs, halo: int):
    """Boundary row strips between vertically adjacent slabs.

    slabs: the t slabs [..., slab_h, W] of one plane, each on its device.
    Returns (above, below): above[i] is the bottom `halo` rows of slab
    i - 1 and below[i] the top `halo` rows of slab i + 1, each copied to
    slab i's device; None at the frame's top and bottom edge."""
    t = len(slabs)
    above = [None] + [slabs[i - 1][..., -halo:, :].to(slabs[i].device)
                      for i in range(1, t)]
    below = [slabs[i + 1][..., :halo, :].to(slabs[i].device)
             for i in range(t - 1)] + [None]
    return above, below
