"""Package rules of the port: no JAX, explicit devices, explicit refusals,
and a kernel loader that raises instead of falling back."""
import ast
import hashlib
import os
import subprocess
import sys

import pytest
import torch

from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import _build, alf_device, sao_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STREAM_KW = dict(slice_type=2, nframes=2, width=96, height=64, seed=1,
                 deblock=True, sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                 sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)

HIER_KW = dict(seed=0, width=96, height=96, ngops=1, deblock=True,
               sps_temporal_mvp_enabled_flag=1, sps_bdof_enabled_flag=1,
               sps_dmvr_enabled_flag=1)

# all-intra with MIP, ISP, MRL and CCLM: every family of device intra
INTRA_KW = dict(seed=2, width=64, height=64, nframes=1,
                sps_cclm_enabled_flag=1)

_NO_JAX_DECODE = r"""
import hashlib, sys
# any import of JAX or of the JAX package now raises ImportError
sys.modules["jax"] = None
sys.modules["ffvvc_tpu"] = None
sys.path.insert(0, ROOT)
import ffvvc_tpu_torch
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
from ffvvc_tpu_torch.ops import fused_device as fd
from ffvvc_tpu_torch.ops import inter_device, intra_device, itx, mc_device
from ffvvc_tpu_torch.tools.forge import (forge_hier_stream, forge_inter_stream,
                                         forge_tools_stream)
assert ffvvc_tpu_torch.__file__.startswith(ROOT + "/"), ffvvc_tpu_torch.__file__
s = forge_inter_stream(**STREAM_KW)
def md5(frames):
    return hashlib.md5(b"".join(f.to_yuv_bytes() for f in frames)).hexdigest()
host = md5(VVCDecoder(DecoderConfig(device="cpu",
                                    device_pipeline=False)).decode(s))
port = md5(VVCDecoder(DecoderConfig(device="cpu",
                                    device_pipeline=True)).decode(s))
assert port == host, (port, host)
assert fd.stats["frames"] == 2, fd.stats
# an inter stream through device MC (DMVR and BDOF armed), and the golden
# parse through the batched inverse transform
b = forge_hier_stream(**HIER_KW)
host_b = md5(VVCDecoder(DecoderConfig(device="cpu")).decode(b))
assert md5(VVCDecoder(DecoderConfig(device="cpu", device_mc=True)).decode(b)) \
    == host_b
assert mc_device.stats["dmvr_subblocks"] and mc_device.stats["bdof_blocks"], \
    mc_device.stats
assert md5(VVCDecoder(DecoderConfig(device="cpu", native_parse=False)).decode(
    b)) == host_b
assert itx.stats["buckets"] > 0, itx.stats
# an all-intra stream through device intra
i = forge_tools_stream(**INTRA_KW)
port_i = md5(VVCDecoder(DecoderConfig(device="cpu", device_intra=True)
                        ).decode(i))
assert port_i == md5(VVCDecoder(DecoderConfig(device="cpu")).decode(i))
assert intra_device.stats["frames"] == 1 and \
    intra_device.stats["cclm_buckets"], intra_device.stats
loaded = [m for m, v in sys.modules.items() if v is not None and
          (m.split(".")[0] in ("jax", "jaxlib", "ffvvc_tpu"))]
assert not loaded, loaded
print("NO_JAX_OK", port, host_b, port_i)
""".replace("ROOT", repr(ROOT)).replace("STREAM_KW", repr(STREAM_KW)).replace(
    "HIER_KW", repr(HIER_KW)).replace("INTRA_KW", repr(INTRA_KW))


def test_decode_without_jax():
    """Forge and decode a SAO/ALF/CC-ALF/LMCS stream through the port in a
    process where neither JAX nor ffvvc_tpu can be imported, fused chain on
    and off, a hierarchical inter stream through device MC and through
    the batched inverse transform, and an all-intra stream through device
    intra; each md5 equals ffvvc_tpu's host decode of the same stream."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _NO_JAX_DECODE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    port, port_b, port_i = r.stdout.split("NO_JAX_OK")[1].split()[:3]
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from forge import forge_hier_stream, forge_inter_stream, forge_tools_stream
    from ffvvc_tpu.config import DecoderConfig as HostConfig
    from ffvvc_tpu.decoder import VVCDecoder as HostDecoder
    for got, stream in ((port, forge_inter_stream(**STREAM_KW)),
                        (port_b, forge_hier_stream(**HIER_KW)),
                        (port_i, forge_tools_stream(**INTRA_KW))):
        frames = HostDecoder(HostConfig(backend="golden")).decode(stream)
        assert got == hashlib.md5(
            b"".join(f.to_yuv_bytes() for f in frames)).hexdigest()


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_jax_imports():
    """No module of the port and not chip_smoke.py imports jax, jaxlib,
    ffvvc_tpu or anything under it."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "ffvvc_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(os.path.relpath(f, ROOT), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "ffvvc_tpu")]
    assert len(files) > 40
    # the GOP workers and the mesh are scanned too
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {"ffvvc_tpu_torch/pipeline.py", "ffvvc_tpu_torch/parallel/mesh.py",
            "ffvvc_tpu_torch/parallel/filters.py"} <= rel
    assert not bad, bad


def test_transpose_constants_match_golden_model():
    """The packed slot permutations of csrc/filters.cu (4 bits a slot) are
    alf._TRANSPOSE_IDX."""
    import re
    from ffvvc_tpu_torch.alf import _TRANSPOSE_IDX
    with open(_build.SOURCE) as f:
        found = dict(re.findall(r"kPerm(\d) = 0x([0-9A-Fa-f]+)ull", f.read()))
    assert sorted(found) == ["0", "1", "2", "3"]
    for t_idx, row in enumerate(_TRANSPOSE_IDX):
        packed = int(found[str(t_idx)], 16)
        assert [(packed >> (4 * s)) & 15 for s in range(12)] == list(row)


def test_sass_histogram_counts_opcodes():
    """tools/sass.py on a piece of `cuobjdump -sass` output: instructions
    are counted per kernel under their opcode, predicates and encoding
    lines are not instructions, IMAD's variants keep their second part."""
    from ffvvc_tpu_torch.tools import sass
    enc = " " * 86 + "/* 0x000e300000000800 */"
    text = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN43_GLOBAL__N__ab2f_10_filters_cu_3797ac3e"
        "10alf_kernelILb1EEEvNS_7AlfArgsE",
        '\t.headerflags\t@"EF_CUDA_SM90"',
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */",
        enc,
        "        /*0010*/                   VIADDMNMX R4, R5, -R6, R7, !PT ;",
        enc,
        "        /*0020*/               @P0 BRA 0x120 ;   /* 0x1 */",
        "        /*0030*/              @!P1 IMAD.IADD R2, R3, 0x1, R4 ;",
        "        /*0040*/                   IMAD R2, R3, R5, R4 ;",
        "        /*0050*/                   LDS.128 R8, [R2+0x10] ;",
        "\t\tFunction : _ZN43_GLOBAL__N__ab2f_10_filters_cu_3797ac3e"
        "9cc_kernelEPKsS1_iiPs",
        "        /*0000*/                   ULDC.64 UR4, c[0x0][0x248] ;",
        "\t\tFunction : _ZN43_GLOBAL__N__ab2f_10_filters_cu_3797ac3e"
        "10alf_kernelILb1ELb0EEEvNS_7AlfArgsE",
        "        /*0000*/                   LDS.128 R8, [R2+0x10] ;",
        "\t\tFunction : _ZN43_GLOBAL__N__ab2f_10_filters_cu_3797ac3e"
        "9cc_kernelILi1ELi0ELb1EEEvNS_6CcArgsE",
        "        /*0000*/                   LDG.E.128.CONSTANT R8, [R2.64] ;",
    ])
    got = sass.histogram(text)
    assert got == {
        "alf_kernel<1>": {"LDC": 1, "VIADDMNMX": 1, "BRA": 1, "IMAD.IADD": 1,
                          "IMAD": 1, "LDS": 1},
        "cc_kernel": {"ULDC": 1},
        "alf_kernel<1,0>": {"LDS": 1},
        "cc_kernel<1,0,1>": {"LDG": 1}}


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
    """Every toggle of the JAX package is ported and constructs, the mesh
    (`mesh_shape`) included; nothing is left to refuse."""
    (name, value), = toggle.items()
    assert getattr(DecoderConfig(device="cpu", **toggle), name) == value


def test_stage_toggles_construct_together():
    cfg = DecoderConfig(device="cpu", device_sao=True, device_alf=True,
                        device_deblock=True, device_lmcs=True,
                        device_pipeline=True, device_mc=True,
                        device_intra=True)
    assert cfg.device_sao and cfg.device_alf and cfg.device_deblock and \
        cfg.device_lmcs and cfg.device_pipeline and cfg.device_mc and \
        cfg.device_intra
    VVCDecoder(cfg)


def test_device_mc_on_cuda_raises_without_cuda(monkeypatch):
    """device_mc asks for the card like every other toggle: no CPU stands
    in for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DecoderConfig(device="cuda", device_mc=True)
    with pytest.raises(RuntimeError, match="cuda"):
        DecoderConfig(device_mc=True)


def test_device_intra_on_cuda_raises_without_cuda(monkeypatch):
    """device_intra asks for the card too, in the config and in the frame
    function itself."""
    from ffvvc_tpu_torch.ops import intra_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DecoderConfig(device_intra=True)
    with pytest.raises(RuntimeError, match="cuda"):
        intra_device.frame_device_intra([], None, None, None, None)


def test_decode_tool_flags(tmp_path, capsys):
    """`tools.decode` with the per-stage flags writes the host decode's
    bytes."""
    from ffvvc_tpu_torch.tools import decode
    from ffvvc_tpu_torch.tools.forge import forge_inter_stream
    bit, out = tmp_path / "in.bit", tmp_path / "out.yuv"
    s = forge_inter_stream(**STREAM_KW)
    bit.write_bytes(s)
    want = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device="cpu")).decode(s))
    decode.main([str(bit), str(out), "--device", "cpu", "--device-lmcs",
                 "--device-deblock", "--device-sao", "--device-alf"])
    assert out.read_bytes() == want
    capsys.readouterr()


def test_decode_tool_device_mc_flag(tmp_path, capsys):
    """`tools.decode --device-mc` runs the device MC and writes the host
    decode's bytes."""
    from ffvvc_tpu_torch.ops import mc_device
    from ffvvc_tpu_torch.tools import decode
    from ffvvc_tpu_torch.tools.forge import forge_inter_stream
    bit, out = tmp_path / "in.bit", tmp_path / "out.yuv"
    s = forge_inter_stream(slice_type=0, nframes=3, width=96, height=64,
                           seed=2, deblock=True)
    bit.write_bytes(s)
    want = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device="cpu")).decode(s))
    mc_device.reset_stats()
    decode.main([str(bit), str(out), "--device", "cpu", "--device-mc"])
    assert out.read_bytes() == want
    assert mc_device.stats["calls"] > 0
    capsys.readouterr()


def test_decode_tool_device_intra_flag(tmp_path, capsys):
    """`tools.decode --device-intra` reconstructs the intra frames on the
    device and writes the host decode's bytes."""
    from ffvvc_tpu_torch.ops import intra_device
    from ffvvc_tpu_torch.tools import decode
    from ffvvc_tpu_torch.tools.forge import forge_tools_stream
    bit, out = tmp_path / "in.bit", tmp_path / "out.yuv"
    s = forge_tools_stream(**INTRA_KW)
    bit.write_bytes(s)
    want = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device="cpu")).decode(s))
    intra_device.reset_stats()
    decode.main([str(bit), str(out), "--device", "cpu", "--device-intra"])
    assert out.read_bytes() == want
    assert intra_device.stats["frames"] == 1
    capsys.readouterr()


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
    plane = torch.zeros((16, 16), dtype=torch.int16, device="meta")
    prm = torch.zeros((11, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sao_device.sao_apply([plane], [prm], [(16, 16)], 3, 255)
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        alf_device.alf_filter_luma(
            torch.zeros((32, 32), dtype=torch.int16, device="meta"),
            torch.zeros((8, 8), **i32), torch.zeros((8, 8), **i32),
            torch.zeros((1, 1), **i32), torch.zeros((1, 25, 12), **i32),
            torch.zeros((1, 25, 12), **i32), 32, 255)
    with pytest.raises(ValueError, match="unsupported device"):
        alf_device.alf_filter_chroma(
            [plane], [torch.zeros((1, 1), **i32)],
            [torch.zeros((1, 12), **i32)], [torch.zeros((1, 12), **i32)],
            16, 16, 255)
    with pytest.raises(ValueError, match="unsupported device"):
        alf_device.cc_filter(
            [plane], torch.zeros((32, 32), dtype=torch.int16, device="meta"),
            [torch.zeros((1, 1), **i32)], [torch.zeros((1, 7), **i32)], 16,
            16, 1, 1, 128, 255)
    for fn, args in ((alf_device.alf_filter_chroma,
                      ([plane], [torch.zeros((1, 1), **i32)],
                       [torch.zeros((1, 12), **i32)],
                       [torch.zeros((1, 12), **i32)], 16, 16, 255)),
                     (alf_device.cc_filter,
                      ([plane], torch.zeros((32, 32), dtype=torch.int16,
                                            device="meta"),
                       [torch.zeros((1, 1), **i32)],
                       [torch.zeros((1, 7), **i32)], 16, 16, 1, 1, 128,
                       255))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args, edges=torch.zeros((1, 1), **i32))
