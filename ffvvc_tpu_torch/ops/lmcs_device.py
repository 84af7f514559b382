"""Device LMCS inverse mapping: per-CTB gated LUT gather on the device.

Port of `ffvvc_tpu/ops/lmcs_device.py` (reference analogue:
libavcodec/vvc/vvc_filter.c:1322 ff_vvc_lmcs_filter and the LUT apply of
vvc_filter_template.c:25): the inverse-mapping LUT is a [1 << bd] gather,
gated per CTB by the owning slice's sh_lmcs_used_flag.  The per-CTB gate
travels as it is and `fused_device.lmcs_apply`, the stage of the fused
chain, expands it on the device.  Plain PyTorch: the JAX package has no
kernel here either.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .fused_device import lmcs_apply
from .sao_device import as_wire


@trace.traced("lmcs")
def lmcs_frame_device(sps, pps, fb, lmcs, recon_jobs, device="cuda"):
    """Apply the LMCS inverse mapping to the luma plane on `device`, in
    place on fb.planes[0].  recon_jobs carry the per-slice lmcs_used gates
    (decoder pixel stage)."""
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
    out = lmcs_apply(torch.from_numpy(as_wire(plane)).to(dev),
                     torch.from_numpy(np.asarray(lmcs.inv_lut,
                                                 np.int32)).to(dev),
                     torch.from_numpy(used).to(dev), sps.ctb_size_y, H, W)
    plane[:] = out.to(torch.int16).cpu().numpy()
