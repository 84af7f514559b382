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


def resolve_mesh_devices(names, device):
    """The torch devices of a config's `mesh_devices`: a tuple or list of
    device names or torch.device, each resolved as `device` is, every one
    of `device`'s type (no mixing of "cpu" and "cuda"), and each CUDA
    index among the visible cards."""
    if not isinstance(names, (tuple, list)) or not names:
        raise TypeError(f"mesh_devices must be a non-empty tuple of device "
                        f"names, not {names!r}")
    if not all(isinstance(n, (str, torch.device)) for n in names):
        raise TypeError(f"mesh_devices entries must be device names or "
                        f"torch.device, not {names!r}")
    devs = [resolve_device(str(n)) for n in names]
    kind = torch.device(device).type
    if any(d.type != kind for d in devs):
        raise ValueError(f"mesh_devices {names!r} mix device types, or "
                         f"differ from device {device!r}")
    over = [d for d in devs if d.type == "cuda" and
            (d.index or 0) >= torch.cuda.device_count()]
    if over:
        raise ValueError(f"mesh_devices {over} past the "
                         f"{torch.cuda.device_count()} visible cards")
    return devs
