"""The port's own host half: copied from ffvvc_tpu file by file, built from
its own C sources, and equal to ffvvc_tpu's in what it forges and decodes.

  * drift: every copied file equals its original once the two stated
    normalisations are applied (the FFmpeg source tree's absolute prefix in
    comments is dropped, `ffvvc_tpu` import lines name `ffvvc_tpu_torch`);
    the files that differ on purpose are listed with a cap on the lines
    they may differ by;
  * parity, tolerance 0: the port's forge and tools/forge.py give the same
    bytes, and the two decoders the same pictures, in one process,
    alternating between the packages (each loads its own libvvc_*.so with
    the same C symbols);
  * the native build helper raises on a failing compiler.
"""
import difflib
import hashlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import forge as jforge  # noqa: E402

from ffvvc_tpu.config import DecoderConfig as JaxConfig  # noqa: E402
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder  # noqa: E402
from ffvvc_tpu.native import parse as jparse  # noqa: E402
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder  # noqa: E402
from ffvvc_tpu_torch.native import _build as native_build  # noqa: E402
from ffvvc_tpu_torch.tools import forge as pforge  # noqa: E402

# ---- drift ------------------------------------------------------------------

# where the original's comments say the FFmpeg sources lie; the copies cite
# them by their path inside that tree
FFMPEG_PREFIX = "/".join(["", "root", "reference", ""])

NATIVE_C = ["vvc_parse.c", "vvc_parse.h", "vvc_mvs.c", "vvc_cabac.c",
            "vvc_cabac.h", "vvc_recon.c", "vvc_recon.h", "vvc_intra.c",
            "vvc_intra.h", "vvc_mc.c", "vvc_sao.c", "vvc_alf.c"]
# copy (under ffvvc_tpu_torch/) -> original (under the repo root), equal
# after normalisation
SAME = {f: f"ffvvc_tpu/{f}" for f in (
    ["bitstream/__init__.py", "bitstream/reader.py", "bitstream/writer.py",
     "bitstream/nal.py", "bitstream/au.py", "bitstream/mp4.py",
     "bitstream/h266.py", "bitstream/h266_write.py", "ps.py", "threads.py",
     "utils/__init__.py", "utils/bufpool.py", "cabac/__init__.py",
     "cabac/engine.py", "cabac/_ctx_layout.json", "cabac/_ctx_tables.npz",
     "ctu.py", "residual.py", "recon.py", "mvs.py", "inter.py", "deblock.py",
     "sao.py", "alf.py", "ops/data.py", "ops/_data_tables.npz"]
    + [f"native/{n}" for n in NATIVE_C])}
# copy -> (original, most lines that may differ: removed + added), each with
# the change it carries
DIFFER = {
    # the loaders build through native/_build.py and raise on failure
    "native/parse.py": ("ffvvc_tpu/native/parse.py", 20),
    # ... and the bindings of device MC's walk and writeback (6 lines)
    "native/recon.py": ("ffvvc_tpu/native/recon.py", 26),
    "native/intra.py": ("ffvvc_tpu/native/intra.py", 20),
    "native/mc.py": ("ffvvc_tpu/native/mc.py", 20),
    # ... and the segment emitter's binding (5 lines)
    "native/deblock.py": ("ffvvc_tpu/native/deblock.py", 21),
    # the segment emitter of the device deblock (deblock_frame_segments),
    # and the per-edge derivation and CTB walk it shares with the filters
    # (edge_params, walk_ctb_edges, frame_walk) (428 lines)
    "native/vvc_deblock.c": ("ffvvc_tpu/native/vvc_deblock.c", 428),
    # device MC's walk of the descriptors into put rows, finals entries and
    # PROF rows (mc_walk), and the copy of its pixels into the planes
    # (mc_writeback) (605 lines)
    "native/vvc_inter.c": ("ffvvc_tpu/native/vvc_inter.c", 605),
    "native/sao.py": ("ffvvc_tpu/native/sao.py", 16),
    "native/alf.py": ("ffvvc_tpu/native/alf.py", 16),
    "cabac/native.py": ("ffvvc_tpu/cabac/native.py", 22),
    # the reference's fields plus `device` and `mesh_devices`, backend
    # "cuda", and what device_sao, device_alf and device_intra do in the
    # port (61 lines)
    "config.py": ("ffvvc_tpu/config.py", 61),
    # the reference's _decode_frame, mesh included, with backend "cuda" and
    # the torch device passed to every device stage (70 lines); trace.py's
    # spans, waits and frame tags in place of its per-stage clock, most of
    # them blocks indented under a span (169 lines); the `parse.tile` span
    # of each tile entry point, on the thread that parses it (14 lines);
    # device MC in one form, one call a frame once its references have
    # landed, and neither the FFVVC_RPL_GATE nor the FFVVC_BATCH_PARSE
    # switch (21 lines)
    "decoder.py": ("ffvvc_tpu/decoder.py", 274),
    # no path set-up (7 lines)
    "tools/forge.py": ("tools/forge.py", 7),
    # spawned GOP workers when a stage runs on CUDA, pools keyed by start
    # method, segments shipped through the temp directory (50 lines)
    "pipeline.py": ("ffvvc_tpu/pipeline.py", 50),
}


def _read(path, original):
    with open(os.path.join(ROOT, path), "rb") as f:
        data = f.read()
    if path.endswith(".npz"):
        return data
    text = data.decode()
    if original:
        text = text.replace(FFMPEG_PREFIX, "")
        text = "\n".join(
            line.replace("ffvvc_tpu", "ffvvc_tpu_torch", 1)
            if line.lstrip().startswith(("from ffvvc_tpu", "import ffvvc_tpu"))
            else line for line in text.split("\n"))
    return text


@pytest.mark.parametrize("copy", sorted(SAME))
def test_copy_equals_original(copy):
    assert _read(f"ffvvc_tpu_torch/{copy}", False) == _read(SAME[copy], True)


@pytest.mark.parametrize("copy", sorted(DIFFER))
def test_edited_copy_stays_close(copy):
    original, cap = DIFFER[copy]
    a = _read(original, True).split("\n")
    b = _read(f"ffvvc_tpu_torch/{copy}", False).split("\n")
    changed = [d for d in difflib.ndiff(a, b) if d[:2] in ("- ", "+ ")]
    assert 0 < len(changed) <= cap, (len(changed), changed[:40])


def test_every_host_file_is_accounted_for():
    """Every file of the port's host half is in one of the two lists, so a
    new copy cannot escape the drift test."""
    own = {"__init__.py", "ops/__init__.py", "ops/_build.py",
           "ops/alf_device.py", "ops/sao_device.py", "ops/deblock_device.py",
           "ops/device.py",
           "ops/fused_device.py", "ops/kernel_inputs.py",
           "ops/lmcs_device.py", "ops/mc_device.py", "ops/inter_device.py",
           "ops/itx.py", "ops/intra_device.py", "csrc/filters.cu",
           "csrc/mc.cu",
           "native/_build.py", "tools/__init__.py", "tools/alf_ab.py",
           "tools/decode.py", "tools/sass.py", "parallel/__init__.py",
           "parallel/mesh.py", "parallel/filters.py", "trace.py"}
    found = set()
    for d, dirs, names in os.walk(os.path.join(ROOT, "ffvvc_tpu_torch")):
        dirs[:] = [x for x in dirs if x not in ("build", "__pycache__")]
        found |= {os.path.relpath(os.path.join(d, n),
                                  os.path.join(ROOT, "ffvvc_tpu_torch"))
                  for n in names}
    assert found == own | set(SAME) | set(DIFFER)


# ---- parity -----------------------------------------------------------------

TOOLS = dict(sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
             sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)
# name -> (forge function, arguments): intra, P, B, tiled, sub-picture and
# hierarchical streams, as tests/test_torch_decode.py decodes them
STREAMS = {
    "intra": ("forge_inter_stream", dict(
        slice_type=2, nframes=3, width=96, height=96, seed=3, deblock=True,
        **TOOLS)),
    "p": ("forge_inter_stream", dict(
        slice_type=1, nframes=3, width=128, height=96, seed=4, deblock=True,
        **TOOLS)),
    "b_10bit": ("forge_inter_stream", dict(
        slice_type=0, nframes=3, width=96, height=96, seed=5, bit_depth=10,
        deblock=True, **TOOLS)),
    "tiled": ("forge_tiled_stream", dict(
        seed=2, nframes=2, width=96, height=96, lf_across_tiles=0,
        lf_across_slices=0, sps_sao_enabled_flag=1, sps_alf_enabled_flag=1)),
    "subpic": ("forge_subpic_stream", dict(
        seed=0, width=128, height=64, qp=30, sps_sao_enabled_flag=1)),
    "hier": ("forge_hier_stream", dict(
        seed=2, width=96, height=64, qp=32, ngops=2, deblock=True, **TOOLS)),
}


def md5(frames):
    return hashlib.md5(b"".join(f.to_yuv_bytes() for f in frames)).hexdigest()


@pytest.mark.parametrize("name", list(STREAMS))
def test_host_parity(name):
    """Same arguments, same bytes from both forges; same pictures from
    ffvvc_tpu's host decode and the port's, native and golden, each
    package run twice in turn."""
    fn, kw = STREAMS[name]
    want = getattr(jforge, fn)(**kw)
    got = getattr(pforge, fn)(**kw)
    assert got == want, "the port's forge differs from tools/forge.py"
    ref = md5(JaxDecoder(JaxConfig(backend="golden")).decode(want))
    assert md5(VVCDecoder(DecoderConfig(device="cpu")).decode(got)) == ref
    assert md5(JaxDecoder(JaxConfig(backend="golden")).decode(want)) == ref
    assert md5(VVCDecoder(DecoderConfig(
        device="cpu", device_pipeline=True)).decode(got)) == ref
    assert md5(JaxDecoder(JaxConfig(
        backend="golden", native_cabac=False, native_parse=False,
        native_alf=False)).decode(want)) == ref
    assert md5(VVCDecoder(DecoderConfig(
        device="cpu", backend="golden")).decode(got)) == ref


def test_golden_backend_is_the_python_model():
    cfg = DecoderConfig(device="cpu", backend="golden")
    assert not (cfg.native_cabac or cfg.native_parse or cfg.native_alf)
    with pytest.raises(ValueError, match="unknown backend"):
        DecoderConfig(device="cpu", backend="xla")


def test_port_loads_its_own_libraries():
    """Both packages' C libraries are loaded in this process; the port's
    come from its build directory, none from ffvvc_tpu/native/."""
    from ffvvc_tpu_torch.native import parse
    VVCDecoder(DecoderConfig(device="cpu")).decode(
        pforge.forge_inter_stream(slice_type=2, nframes=1, width=64,
                                  height=64, seed=0))
    assert parse.load_lib()._name.startswith(native_build.BUILD_DIR + os.sep)
    with open("/proc/self/maps") as f:
        mapped = {_mapped_path(line) for line in f if "libvvc_" in line}
    ours = {m for m in mapped if m.startswith(native_build.BUILD_DIR)}
    assert ours, mapped
    # the JAX package's libraries lie beside the module that loaded them,
    # wherever `import ffvvc_tpu` found it (not always under ROOT)
    theirs = os.path.dirname(jparse.__file__)
    for m in mapped - ours:
        assert m.startswith(theirs + os.sep), m


def _mapped_path(line):
    """The file of a /proc/self/maps line: its sixth field onward (a path
    may hold spaces), less the " (deleted)" the kernel appends once the
    file was replaced on disk, as another process's build of a missing
    library does while this one holds the old file mapped."""
    path = line.rstrip("\n").split(None, 5)[5]
    return path[:-len(" (deleted)")] if path.endswith(" (deleted)") else path


@pytest.mark.parametrize("line,path", [
    ("7f3a1c000000-7f3a1c004000 r--p 00000000 08:01 1234 "
     "/x/build/libvvc_parse-ab12.so\n", "/x/build/libvvc_parse-ab12.so"),
    ("7f3a1c000000-7f3a1c004000 r-xp 00004000 08:01 1234 "
     "/x/ffvvc_tpu/native/libvvc_parse.so (deleted)\n",
     "/x/ffvvc_tpu/native/libvvc_parse.so"),
    ("7f3a1c000000-7f3a1c004000 r--p 00000000 08:01 1234 "
     "/a dir/libvvc_mc.so\n", "/a dir/libvvc_mc.so"),
])
def test_mapped_path_parses_proc_maps(line, path):
    assert _mapped_path(line) == path


# ---- the native build helper ------------------------------------------------

def _fake_gcc(tmp_path, monkeypatch, script):
    gcc = tmp_path / "bin" / "gcc"
    gcc.parent.mkdir()
    gcc.write_text(script)
    gcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(gcc.parent))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "x.c"
    src.write_text("int x(void) { return 1; }\n")
    return str(src)


def test_native_build_raises_on_failed_build(tmp_path, monkeypatch):
    src = _fake_gcc(tmp_path, monkeypatch,
                    "#!/bin/sh\necho 'error: fake compiler fault' >&2\n"
                    "exit 1\n")
    with pytest.raises(RuntimeError, match="fake compiler fault"):
        native_build.load_native("x", [src])
    assert not os.listdir(tmp_path / "build")


def test_native_build_raises_without_gcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="gcc not found"):
        native_build.load_native("x", [])


def test_native_build_names_by_content(tmp_path, monkeypatch):
    """A changed source, header or flag gives another library name; the
    same content the same name."""
    a, b = tmp_path / "a.c", tmp_path / "a.h"
    a.write_text("int a;\n")
    b.write_text("/* h */\n")
    name = lambda flags=("-O3",): native_build.library_path(  # noqa: E731
        "a", [str(a)], [str(b)], list(flags), str(tmp_path))
    first = name()
    assert name() == first and first.endswith(".so")
    assert name(("-O2",)) != first
    b.write_text("/* h2 */\n")
    second = name()
    assert second != first
    a.write_text("int a2;\n")
    assert name() not in (first, second)


def test_native_build_keeps_the_first_library(tmp_path, monkeypatch):
    """A process that finishes building a library another process has
    built meanwhile leaves that file as it is (a loaded library is never
    replaced) and removes its own."""
    # a compiler that finds the library already there when it is done
    src = _fake_gcc(tmp_path, monkeypatch,
                    '#!/bin/sh\nwhile [ "$1" != -o ]; do shift; done\n'
                    'echo mine > "$2"\necho first > "${2%.so.*}.so"\n')
    out = native_build.build_shared("gcc", ["-O3"], [src], [], "x",
                                    str(tmp_path / "build"))
    assert os.listdir(tmp_path / "build") == [os.path.basename(out)]
    with open(out) as f:
        assert f.read() == "first\n"
