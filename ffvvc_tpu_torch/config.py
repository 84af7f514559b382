"""Decoder configuration of the port.

Extends `ffvvc_tpu.config.DecoderConfig` with the torch device.  The
device toggles that the port does not carry yet raise instead of being
ignored; each names its ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses

from ffvvc_tpu.config import DecoderConfig as _BaseConfig

from .ops import resolve_device

# toggle -> ROADMAP.md item that ports it
_UNPORTED = {
    "device_sao": "queue 1 item 2 (per-stage SAO entry point)",
    "device_alf": "queue 1 item 3 (per-stage ALF entry point)",
    "device_deblock": "queue 1 item 4 (per-stage deblock and LMCS entry "
                      "points)",
    "device_lmcs": "queue 1 item 4 (per-stage deblock and LMCS entry "
                   "points)",
    "device_mc": "queue 1 item 7 (device MC and inter)",
    "device_intra": "queue 1 item 8 (device intra)",
}


@dataclasses.dataclass
class DecoderConfig(_BaseConfig):
    # "cuda" never reaches the JAX package's device dispatch (which tests
    # backend == "tpu"); the port's decoder gates on device_pipeline.
    backend: str = "cuda"
    # torch device of the fused filter chain: "cuda" (raises when CUDA is
    # unavailable) or "cpu" (the kernels' plain PyTorch versions; tests).
    device: str = "cuda"

    def __post_init__(self):
        if self.backend == "tpu":
            raise ValueError("backend='tpu' runs the JAX device half; the "
                             "port's backend is 'cuda'")
        for name, item in _UNPORTED.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name} is not ported yet: ROADMAP.md {item}")
        if tuple(self.mesh_shape) != (1, 1):
            raise NotImplementedError(
                "mesh_shape != (1, 1) is not ported yet: ROADMAP.md queue 1 "
                "item 11 (the mesh)")
        resolve_device(self.device)
