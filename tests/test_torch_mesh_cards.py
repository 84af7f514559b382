"""The port's mesh across several CUDA devices, held on the CPU.

  * placement: with `torch.cuda.is_available` and `device_count` patched to
    2 and 4 cards, `make_mesh_exact` puts `cuda:0 .. cuda:g*t-1` on the
    mesh gop-major, raises for exactly the shapes for which
    `ffvvc_tpu.parallel.filters.make_mesh_exact` raises over as many JAX
    CPU devices, and takes an explicit list, repeats included, as given;
  * configuration: `DecoderConfig.mesh_devices` refuses bad types, mixed
    "cpu" and "cuda" entries and indices past the visible cards; the
    decoder hands its list (or the default) to the mesh; the GOP workers'
    pool is spawned for a mesh on CUDA devices;
  * launches: each hand-kernel wrapper refuses tensors on two devices
    before it runs anything (a CPU tensor beside a "meta" one), counts a
    launch per device, and on the CPU counts none;
  * sharded puts: the bytes of reference plane copied to each other device
    of the "tile" axis, none where a tile's device is the plane's own;
  * a decode on an explicit "cpu" list equals ffvvc_tpu's host decode
    byte for byte.
No card is needed: nothing here launches a kernel.
"""
import os
import re
import sys

import jax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import forge as F  # noqa: E402
from test_torch_fused import TOOLS  # noqa: E402

from ffvvc_tpu.config import DecoderConfig as JaxConfig  # noqa: E402
from ffvvc_tpu.decoder import VVCDecoder as JaxDecoder  # noqa: E402
from ffvvc_tpu.parallel.filters import \
    make_mesh_exact as jax_make_mesh_exact  # noqa: E402
from ffvvc_tpu_torch import DecoderConfig, VVCDecoder, pipeline  # noqa: E402
from ffvvc_tpu_torch.ops import alf_device, mc_device, sao_device  # noqa: E402
from ffvvc_tpu_torch.ops.device import count_launch, counted  # noqa: E402
from ffvvc_tpu_torch.parallel.mesh import make_mesh_exact  # noqa: E402

SHAPES = [(1, 1), (1, 2), (2, 1), (1, 3), (2, 2), (1, 4), (4, 1), (2, 3),
          (1, 5)]


@pytest.fixture
def cards(monkeypatch):
    """Pretend n CUDA cards are visible (nothing here touches one)."""
    def patch(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return patch


# ---- placement --------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_mesh_takes_the_visible_cards(cards, n, shape):
    """Without a list a CUDA mesh takes cuda:0 .. cuda:g*t-1 gop-major, one
    card a position, and raises where the JAX function raises over n
    devices, with its message."""
    cards(n)
    g, t = shape
    jax_devices = jax.devices("cpu")[:n]
    assert len(jax_devices) == n
    try:
        jmesh = jax_make_mesh_exact(shape, jax_devices)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            make_mesh_exact(shape, device="cuda")
        return
    mesh = make_mesh_exact(shape, device="cuda")
    assert mesh.shape == {"gop": g, "tile": t} == dict(jmesh.shape)
    want = [[torch.device("cuda", i * t + j) for j in range(t)]
            for i in range(g)]
    assert mesh.devices.tolist() == want
    # the same positions as the JAX mesh's devices, by their order
    order = {d.id: k for k, d in enumerate(jax_devices)}
    assert [[order[d.id] for d in row] for row in jmesh.devices.tolist()] \
        == [[d.index for d in row] for row in want]


@pytest.mark.parametrize("devices,shape,want", [
    (["cuda:1"] * 4, (2, 2), [["cuda:1", "cuda:1"], ["cuda:1", "cuda:1"]]),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], (1, 4),
     [["cuda:0", "cuda:0", "cuda:1", "cuda:1"]]),
    (["cuda:1", "cuda:0", "cuda:1"], (1, 2), [["cuda:1", "cuda:0"]]),
    (["cpu", "cpu"], (2, 1), [["cpu"], ["cpu"]]),
])
def test_explicit_list_is_taken_as_given(cards, devices, shape, want):
    """A list, repeats included, is the mesh's first g * t positions; the
    visible count does not enter."""
    cards(2)
    mesh = make_mesh_exact(shape, devices)
    assert mesh.devices.tolist() == [[torch.device(d) for d in row]
                                     for row in want]


def test_cpu_mesh_repeats_the_device():
    """Without a list a CPU mesh is "cpu" at every position."""
    mesh = make_mesh_exact((2, 3), device="cpu")
    assert set(mesh.devices.flat) == {torch.device("cpu")}
    assert mesh.devices.shape == (2, 3)


# ---- configuration ----------------------------------------------------------

@pytest.mark.parametrize("devices,device,err", [
    ("cuda:0", "cuda", TypeError),                # not a tuple
    ((), "cuda", TypeError),
    ((0, 1), "cuda", TypeError),                  # ints, not device names
    (("cuda:0", None), "cuda", TypeError),
    (("cpu", "cuda:0"), "cuda", ValueError),      # mixed types
    (("cuda:0", "cpu"), "cpu", ValueError),
    (("cuda:0", "cuda:1"), "cpu", ValueError),    # not `device`'s type
    (("cuda:0", "cuda:2"), "cuda", ValueError),   # past the 2 cards
    (("meta",), "cuda", ValueError),              # neither cpu nor cuda
])
def test_config_refuses_bad_mesh_devices(cards, devices, device, err):
    cards(2)
    with pytest.raises(err):
        DecoderConfig(device=device, mesh_shape=(1, 2), mesh_devices=devices)


def test_config_mesh_devices_without_cuda(monkeypatch):
    """A CUDA entry raises where CUDA is unavailable, as `device` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DecoderConfig(device="cpu", mesh_shape=(1, 2),
                      mesh_devices=("cpu", "cuda:0"))


@pytest.mark.parametrize("devices,shape,want", [
    (("cuda:0", "cuda:1"), (1, 2), [["cuda:0", "cuda:1"]]),
    (("cuda:1", "cuda:1", "cuda:0", "cuda:0"), (2, 2),
     [["cuda:1", "cuda:1"], ["cuda:0", "cuda:0"]]),
    (None, (2, 1), [["cuda:0"], ["cuda:1"]]),
])
def test_decoder_hands_its_devices_to_the_mesh(cards, devices, shape, want):
    cards(2)
    cfg = DecoderConfig(device="cuda", mesh_shape=shape,
                        mesh_devices=devices)
    mesh = VVCDecoder(cfg)._mesh_q.mesh
    assert mesh.devices.tolist() == [[torch.device(d) for d in row]
                                     for row in want]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 3)])
def test_decoder_never_repeats_a_card_silently(cards, shape):
    """A CUDA mesh past the visible cards raises; it does not fold its
    positions onto the cards there are."""
    cards(2)
    with pytest.raises(ValueError, match=f"needs {shape[0] * shape[1]} "
                       "devices, have 2"):
        VVCDecoder(DecoderConfig(device="cuda", mesh_shape=shape))


@pytest.mark.parametrize("kw,want", [
    (dict(device="cuda", mesh_shape=(1, 2),
          mesh_devices=("cuda:0", "cuda:1")), "spawn"),
    (dict(device="cuda", mesh_shape=(2, 2), backend="golden"), "spawn"),
    (dict(device="cuda", mesh_shape=(1, 2), mesh_devices=("cuda:1",) * 2,
          backend="golden"), "spawn"),
    (dict(device="cpu", mesh_shape=(1, 2), mesh_devices=("cpu", "cpu")),
     "fork"),
    (dict(device="cuda"), "fork"),
])
def test_start_method_for_a_cuda_mesh(cards, kw, want):
    cards(2)
    assert pipeline._start_method(DecoderConfig(**kw)) == want


# ---- launches ---------------------------------------------------------------

I16 = dict(dtype=torch.int16)
I32 = dict(dtype=torch.int32)


def _calls(other):
    """Each wrapper's smallest call, with one tensor on device `other` and
    the rest on the CPU."""
    def z(shape, kw, dev="cpu"):
        return torch.zeros(shape, device=dev, **kw)
    return {
        "sao_apply": lambda: sao_device.sao_apply(
            [z((16, 16), I16)], [z((11, 1, 1), I32, other)], [(16, 16)], 3,
            255),
        "alf_filter_luma": lambda: alf_device.alf_filter_luma(
            z((32, 32), I16), z((8, 8), I32), z((8, 8), I32),
            z((1, 1), I32), z((1, 25, 12), I32), z((1, 25, 12), I32, other),
            32, 255),
        "alf_filter_chroma": lambda: alf_device.alf_filter_chroma(
            [z((16, 16), I16, other)], [z((1, 1), I32)], [z((1, 12), I32)],
            [z((1, 12), I32)], 16, 16, 255),
        "alf_filter_chroma/edges": lambda: alf_device.alf_filter_chroma(
            [z((16, 16), I16)], [z((1, 1), I32)], [z((1, 12), I32)],
            [z((1, 12), I32)], 16, 16, 255,
            edges=z((1, 1), I32, other)),
        "cc_filter": lambda: alf_device.cc_filter(
            [z((16, 16), I16)], z((32, 32), I16, other), [z((1, 1), I32)],
            [z((1, 7), I32)], 16, 16, 1, 1, 128, 255),
    }


def _wrapper(name):
    return getattr(sao_device if name == "sao_apply" else alf_device,
                   name.split("/")[0])


@pytest.mark.parametrize("name", sorted(_calls("meta")))
def test_wrapper_refuses_tensors_on_two_devices(name):
    """Tensors of one launch on two devices raise ValueError before the
    wrapper runs its plain version or launches anything."""
    fn = _wrapper(name)
    before = (fn.launches, dict(fn.launches_by_device))
    with pytest.raises(ValueError, match="one device"):
        _calls("meta")[name]()
    assert (fn.launches, fn.launches_by_device) == before


@pytest.mark.parametrize("name", sorted(_calls("cpu")))
def test_plain_version_counts_no_launch(name):
    """The same calls on the CPU alone run the plain version: no launch
    counted, in all or on any device."""
    fn = _wrapper(name)
    before = (fn.launches, dict(fn.launches_by_device))
    _calls("cpu")[name]()
    assert (fn.launches, fn.launches_by_device) == before


def test_launches_counted_per_device():
    """count_launch adds one to the total, one to the card's entry and,
    with edge words, one to `edge_launches`."""
    @counted
    def wrapper():
        pass
    for k, edges in ((0, False), (1, True), (1, False), (3, False)):
        count_launch(wrapper, torch.device("cuda", k), edges)
    assert (wrapper.launches, wrapper.edge_launches) == (4, 1)
    assert wrapper.launches_by_device == {0: 1, 1: 2, 3: 1}
    for fn in (sao_device.sao_apply, alf_device.alf_filter_luma,
               alf_device.alf_filter_chroma, alf_device.cc_filter,
               mc_device.put_table):
        assert isinstance(fn.launches_by_device, dict)


# ---- sharded puts -----------------------------------------------------------

@pytest.mark.parametrize("devices,want", [
    (("cpu", "meta"), {"meta": 1}),
    (("cpu", "cpu"), {}),
    (("meta", "meta", "cpu"), {"meta": 2}),
])
def test_sharded_puts_count_the_plane_sent(monkeypatch, devices, want):
    """Each tile on another device receives the reference planes its part
    of the put table reads, once a call (their bytes counted under that
    device); a tile on the planes' own device receives nothing.  Each part
    of the table goes with its copies of the planes, and the outputs come
    back in row order."""
    import numpy as np
    seen = []

    def put(planes, table, bd):
        seen.append(([p.device.type for p in planes if p is not None],
                     len(table.jobs)))
        return torch.arange(table.n_out)          # row order, on the CPU
    monkeypatch.setattr(mc_device, "put_table", put)
    monkeypatch.setattr(mc_device, "sharded_ref_bytes", {})
    ref = torch.zeros((24, 40), dtype=torch.int16)
    rows = np.zeros((7, 4), np.int32)
    table, _ = mc_device.put_table_of([(0, ref.shape, rows, 2, 2, True, 0, 0,
                                        0, 0, False)])
    mesh = make_mesh_exact((1, len(devices)), list(devices))
    out = mc_device._put_sharded([ref], table, mesh, 10)
    t = len(devices)
    parts = [len(p) for p in torch.tensor_split(torch.arange(7), t)]
    assert seen == [([d], n) for d, n in zip(devices, parts)]
    assert out.tolist() == [k for n in parts for k in range(4 * n)]
    assert mc_device.sharded_ref_bytes == {
        d: n * ref.nbytes for d, n in want.items()}


# ---- a decode on an explicit list -------------------------------------------

def test_explicit_cpu_list_decodes_as_the_host():
    """A (2, 2) mesh over an explicit "cpu" list equals ffvvc_tpu's host
    decode byte for byte, and equals the mesh on the default list."""
    s = F.forge_inter_stream(slice_type=2, nframes=2, width=96, height=96,
                             seed=3, deblock=True, **TOOLS)
    old = os.environ.get("FFVVC_ITX")
    os.environ["FFVVC_ITX"] = "host"
    try:
        want = b"".join(f.to_yuv_bytes()
                        for f in JaxDecoder(JaxConfig()).decode(s))
    finally:
        if old is None:
            del os.environ["FFVVC_ITX"]
        else:
            os.environ["FFVVC_ITX"] = old
    got = [b"".join(f.to_yuv_bytes() for f in VVCDecoder(DecoderConfig(
        device="cpu", mesh_shape=(2, 2), mesh_devices=devs)).decode(s))
        for devs in (("cpu",) * 4, None)]
    assert got == [want, want] and want
