"""Package rules of the port: no JAX, explicit devices, explicit refusals,
and a kernel loader that raises instead of falling back."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import _build, sao_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_DECODE = r"""
import hashlib, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.path[:0] = [ROOT, ROOT + "/tools"]
# both packages before forge, which puts a fixed checkout path first
import ffvvc_tpu, ffvvc_tpu_torch
from ffvvc_tpu.config import DecoderConfig as HostConfig
from ffvvc_tpu.decoder import VVCDecoder as HostDecoder
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import fused_device as fd
from forge import forge_inter_stream
for m in (ffvvc_tpu, ffvvc_tpu_torch):
    assert m.__file__.startswith(ROOT + "/"), (m.__file__, ROOT)
s = forge_inter_stream(slice_type=2, nframes=2, width=96, height=64, seed=1,
                       deblock=True, sps_sao_enabled_flag=1,
                       sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1,
                       sps_lmcs_enabled_flag=1)
def md5(frames):
    return hashlib.md5(b"".join(f.to_yuv_bytes() for f in frames)).hexdigest()
host = md5(HostDecoder(HostConfig(backend="golden")).decode(s))
port = md5(VVCDecoder(DecoderConfig(device="cpu",
                                    device_pipeline=True)).decode(s))
assert port == host, (port, host)
assert fd.stats["frames"] == 2, fd.stats
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "jaxlib")]
assert not loaded, loaded
print("NO_JAX_OK", port)
""".replace("ROOT", repr(ROOT))


def test_decode_without_jax():
    """Forge and decode a SAO/ALF/CC-ALF/LMCS stream through the port in a
    process where JAX cannot be imported; md5 equal to the host decode."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _NO_JAX_DECODE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "NO_JAX_OK" in r.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_jax_imports():
    """No module of the port imports jax, or a module of the JAX package's
    device half (ffvvc_tpu.ops.* but the JAX-free data tables,
    ffvvc_tpu.parallel); chip_smoke.py imports neither jax nor any module
    of the JAX package."""
    smoke = os.path.join(ROOT, "chip_smoke.py")
    bad = [m for m in _imports(smoke)
           if m.split(".")[0] in ("jax", "jaxlib", "ffvvc_tpu")]
    assert not bad, bad
    files = [smoke]
    for d, _, names in os.walk(os.path.join(ROOT, "ffvvc_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")
            if top[0] in ("jax", "jaxlib") or mod.startswith(
                    "ffvvc_tpu.parallel") or (
                    mod.startswith("ffvvc_tpu.ops.") and
                    mod != "ffvvc_tpu.ops.data"):
                bad.append((os.path.relpath(f, ROOT), mod))
    assert len(files) > 10
    assert not bad, bad


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DecoderConfig(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DecoderConfig()                 # the default device is "cuda"


def test_backend_tpu_refused():
    with pytest.raises(ValueError, match="tpu"):
        DecoderConfig(device="cpu", backend="tpu")


@pytest.mark.parametrize("toggle", [
    dict(device_sao=True), dict(device_alf=True), dict(device_deblock=True),
    dict(device_lmcs=True), dict(device_mc=True), dict(device_intra=True),
    dict(mesh_shape=(1, 2))])
def test_unported_toggle_raises(toggle):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        DecoderConfig(device="cpu", **toggle)


def test_decoder_needs_port_config():
    from ffvvc_tpu.config import DecoderConfig as HostConfig
    with pytest.raises(TypeError):
        VVCDecoder(HostConfig(backend="golden"))


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()


def test_loader_raises_on_failed_build(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: fake compiler fault' >&2\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="fake compiler fault"):
        _build.lib()


def test_wrapper_refuses_other_devices():
    """A wrapper runs its twin only for CPU tensors; any other device
    launches the kernel (CUDA) or raises."""
    plane = torch.zeros((8, 8), dtype=torch.int32, device="meta")
    p = {k: torch.zeros((1, 1), dtype=torch.int32, device="meta")
         for k in ("typ", "m1", "kl", "kr", "kt", "kb", "ax", "bx")}
    p["offs"] = torch.zeros((5, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sao_device.sao_apply(plane, p, 8, 8, 3, 255)
