"""Device ops of the port: device resolution.

Unlike `ffvvc_tpu/ops/__init__.py` there is no compile cache to configure:
PyTorch runs eagerly, and the CUDA kernels build once per source hash
(`_build.py`).
"""
import torch


def resolve_device(name: str) -> torch.device:
    """The torch device for a config's `device` string.  "cuda" raises
    where CUDA is unavailable: there is no silent fallback to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain PyTorch "
            "versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
