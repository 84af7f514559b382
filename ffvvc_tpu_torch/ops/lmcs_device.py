"""Device LMCS inverse mapping: per-CTB gated LUT gather on the device.

Port of `ffvvc_tpu/ops/lmcs_device.py` (reference analogue:
libavcodec/vvc/vvc_filter.c:1322 ff_vvc_lmcs_filter and the LUT apply of
vvc_filter_template.c:25): the inverse-mapping LUT is a [1 << bd] gather,
gated per CTB by the owning slice's sh_lmcs_used_flag.  The per-CTB gate
travels as it is and `fused_device.lmcs_apply`, the stage of the fused
chain, expands it on the device.  Plain PyTorch: the JAX package has no
kernel here either.  `stats` counts the frames it mapped and the bytes it
moved each way.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .device import Counters, as_wire, download, upload
from .fused_device import lmcs_apply

# frames `lmcs_frame_device` mapped and the bytes it moved each way; reset
# with reset_stats() (which `fused_device.reset_stats` calls)
stats = Counters("frames", "up_bytes", "down_bytes")
reset_stats = stats.reset


@trace.traced("lmcs")
def lmcs_frame_device(sps, pps, fb, lmcs, recon_jobs, device="cuda"):
    """Apply the LMCS inverse mapping to the luma plane on `device`, in
    place on fb.planes[0].  recon_jobs carry the per-slice lmcs_used gates
    (decoder pixel stage)."""
    with trace.span("lmcs.build"):
        used = np.zeros((pps.ctb_height, pps.ctb_width), np.int32)
        for rec, ctus in recon_jobs:
            if not rec.lmcs_used:
                continue
            for rs, rx, ry in ctus:
                used[ry, rx] = 1
    if not used.any():
        return
    dev = torch.device(device)
    plane = fb.planes[0]
    H, W = plane.shape
    with trace.span("lmcs.upload"):
        y = upload(as_wire(plane), dev, stats)
        lut = upload(np.asarray(lmcs.inv_lut, np.int32), dev, stats)
        mask = upload(used, dev, stats)
    out = lmcs_apply(y, lut, mask, sps.ctb_size_y, H, W).to(torch.int16)
    with trace.span("lmcs.download"):
        out = download(out, stats)
    plane[:] = out
    stats["frames"] += 1
