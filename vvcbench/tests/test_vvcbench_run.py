"""The harness end to end on the CPU at a small size: a sound run reads
correct, the control and each fault the cells can have read not correct,
and the command exits non-zero with no result where it has no card or no
port beside it."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, SIZE
from harness import cells, control, runner

CELLS = ("ai1080.seg2", "ra1080.gop2")
SEED = 8


def run(name, cache_root, trace=False, seconds=0.5):
    return runner.run(cells.cell(name), SEED, seconds, trace, device="cpu",
                      size=SIZE, processes=1, cache_root=cache_root)


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "vvcbench", "run.py"),
         "--workload", "ai1080.seg2", "--seed", "1", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "vvcbench",
                    ignore=shutil.ignore_patterns(".cache", ".out",
                                                  "__pycache__"))
    p = _cli(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, cache_root):
    r = run(name, cache_root)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "cpu_s_per_frame", "setup_s"}
    assert list(r)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    assert "parameter_sets_differing" in r["checks"]
    json.dumps(r)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_layers(name, cache_root):
    r = run(name, cache_root, trace=True)
    assert r["correct"]
    want = {"decoder.parse_ms", "decoder.recon_ms", "fused.build_ms",
            "fused.device_ms"}
    if name.startswith("ra"):
        want |= {"mc.ms", "mc.put_buckets"}
    # the device metrics need the card's trace: absent here, never 0
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("bits", (9, 10))
@pytest.mark.parametrize("name", CELLS)
def test_control(name, bits, cache_root, monkeypatch):
    """The reference in the program's place: one bit below the stated
    precision it reads not correct; at full precision, correct."""
    import ffvvc_tpu_torch as port
    c = cells.cell(name)
    cache = runner.Cache(c, SEED, SIZE, cache_root)
    segs = runner.load_segments(cache, c, SEED, SIZE, 1)
    monkeypatch.setattr(port, "VVCDecoder", control.with_bits(
        bits, segs, c.traffic, c.config["bit_depth"], processes=1))
    r = run(name, cache_root)
    assert r["correct"] is (bits == 10)
    if bits == 9:
        assert r["checks"]["planes_differing"]["value"] > 0


def _fault_unchanged(monkeypatch):
    """The filter chain returns its frame unchanged (and says it ran)."""
    from ffvvc_tpu_torch.ops import fused_device
    monkeypatch.setattr(fused_device, "fused_frame_filters",
                        lambda *a, **k: True)


def _fault_half(monkeypatch):
    """Half of the frames of each decode left out."""
    import ffvvc_tpu_torch as port
    decode = port.VVCDecoder.decode
    monkeypatch.setattr(port.VVCDecoder, "decode",
                        lambda self, d: decode(self, d)[::2])


def _fault_sample(monkeypatch):
    """One sample of the last output frame altered where it is made."""
    import ffvvc_tpu_torch as port
    decode = port.VVCDecoder.decode

    def altered(self, d):
        out = decode(self, d)
        out[-1].buffer.planes[2][3, 5] ^= 1
        return out
    monkeypatch.setattr(port.VVCDecoder, "decode", altered)


def _fault_deblock_qp(monkeypatch):
    """The deblocking edge walk that the fused chain shares with the golden
    model takes tC and beta two QP steps high."""
    from ffvvc_tpu_torch import deblock
    edge_qp = deblock.Deblocker._edge_qp
    monkeypatch.setattr(deblock.Deblocker, "_edge_qp",
                        lambda self, *a: edge_qp(self, *a) + 2)


def _fault_sao_band(monkeypatch):
    """The fused chain's SAO tables put every band offset one band up."""
    from ffvvc_tpu_torch.ops import fused_device
    tables = fused_device.ctb_tables

    def shifted(sf, *a, **k):
        sf.tabs.sao_band_pos[:] = (sf.tabs.sao_band_pos + 1) & 31
        return tables(sf, *a, **k)
    monkeypatch.setattr(fused_device, "ctb_tables", shifted)


def _fault_alf_clip(monkeypatch):
    """The ALF coefficient sets that the fused chain shares with the golden
    model clip every luma tap one step tighter."""
    from ffvvc_tpu_torch import alf
    init = alf.VVCALF.__init__

    def tighter(self, aps):
        init(self, aps)
        self.luma_clip_idx = (self.luma_clip_idx + 1).clip(0, 3)
    monkeypatch.setattr(alf.VVCALF, "__init__", tighter)


@pytest.mark.parametrize("fault", (_fault_unchanged, _fault_half,
                                   _fault_sample, _fault_deblock_qp,
                                   _fault_sao_band, _fault_alf_clip))
@pytest.mark.parametrize("name", CELLS)
def test_fault_reads_not_correct(name, fault, cache_root, monkeypatch):
    fault(monkeypatch)
    r = run(name, cache_root)
    assert r["correct"] is False and r["failed"] == r["attempted"] >= 1


def test_a_parse_fault_shared_with_the_reference_reads_not_correct(
        tmp_path, monkeypatch):
    """The port and the reference read ALF APSs with the same code (the
    reference froze it): a fault planted in both decodes alike, and the
    comparison of the reference's reading with the forge's own parameter
    sets is what catches it."""
    from ffvvc_tpu_torch import decoder as port_decoder
    from vvcref import decoder as ref_decoder
    from vvcref.bitstream import h266 as ref_h266

    def misread(read):
        def aps(r):
            a = read(r)
            if a.aps_params_type == ref_h266.APS_ALF and \
                    a.alf_luma_filter_signal_flag:
                a.alf_luma_coeff_abs[0][0] += 1
            return a
        return aps
    for mod in (port_decoder, ref_decoder, ref_h266):
        monkeypatch.setattr(mod, "read_aps", misread(mod.read_aps))
    r = runner.run(cells.cell("ai1080.seg2"), SEED, 0.5, False,
                   device="cpu", size=SIZE, processes=1,
                   cache_root=str(tmp_path))
    assert r["checks"]["planes_differing"]["value"] == 0
    assert r["checks"]["parameter_sets_differing"]["value"] > 0
    assert r["correct"] is False and r["failed"] == r["attempted"]
