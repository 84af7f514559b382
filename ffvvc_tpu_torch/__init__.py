"""ffvvc_tpu_torch — the PyTorch/CUDA port of ffvvc_tpu's device half.

The host half (NAL and header parsing, CABAC, the native C recon and the
golden model) is reused from `ffvvc_tpu` by import; none of it imports JAX.
This package replaces the device half: the fused post-recon filter chain
(`ops/fused_device.py`) runs in PyTorch, with SAO, ALF and CC-ALF as CUDA
kernels written by hand for Hopper (`csrc/filters.cu`).

    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    frames = VVCDecoder(DecoderConfig(device_pipeline=True)).decode(data)

There is no silent CPU path: `DecoderConfig.device` defaults to "cuda" and
raises where CUDA is missing; the CPU tests pass device="cpu" explicitly.
This package never imports JAX.
"""

from .config import DecoderConfig  # noqa: F401
from .decoder import VVCDecoder  # noqa: F401
