"""ffvvc_tpu_torch — the PyTorch/CUDA port of ffvvc_tpu's device half.

The host half (NAL and header parsing, CABAC, the native C parse and recon,
the golden model) is this package's own copy of `ffvvc_tpu`'s, file by file
under the same names; its C libraries and the CUDA kernels are built from
this package's sources into `ffvvc_tpu_torch/build/` at first use.  The
device half is ported: the fused post-recon filter chain
(`ops/fused_device.py`) runs in PyTorch, with SAO, ALF and CC-ALF as CUDA
kernels written by hand for Hopper (`csrc/filters.cu`); device MC's puts
are one hand-written kernel launch a call (`csrc/mc.cu`).

    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    frames = VVCDecoder(DecoderConfig(device_pipeline=True)).decode(data)

There is no silent CPU path: `DecoderConfig.device` defaults to "cuda" and
raises where CUDA is missing; the CPU tests pass device="cpu" explicitly.
This package imports neither JAX nor any module of `ffvvc_tpu`.
"""

from .config import DecoderConfig  # noqa: F401
from .decoder import VVCDecoder  # noqa: F401
