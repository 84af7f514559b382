"""Smoke run of the port on one NVIDIA GPU: build, check, decode.

    python3 chip_smoke.py

Phases, each of which raises on a fault (the script then exits non-zero):

1. Environment: torch/CUDA versions, the card, its power limit, nvcc.
2. Build: compile csrc/filters.cu with nvcc (ffvvc_tpu_torch/ops/_build.py).
3. Kernels: SAO, ALF and CC-ALF at the shapes a 1080p 10-bit 4:2:0 frame
   gives them (luma 1080x1920, chroma 540x960, CTB 32), on seeded inputs;
   each must equal its plain PyTorch twin exactly (torch.equal).  Both
   are timed with CUDA events (median of 20 launches).
4. Decode: two 4-frame 1080p10 all-intra streams with SAO, ALF, CC-ALF
   and LMCS on, the first with LMCS chroma residual scaling (its host
   recon runs in the Python golden model), the second without (the
   native C recon runs).  Each is decoded through ffvvc_tpu_torch with
   device_pipeline on the card; its YUV md5 must equal the host decode
   of the same stream (the same decoder with device_pipeline off), every
   frame must run the fused chain and every kernel must launch.  A
   second, serial decode of each prints the time per stage.

The last two lines of stdout are a JSON summary of the kernels and the
contract line {"ok": true, "device": {...}}.
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ffvvc_tpu_torch.ops import _build  # noqa: E402
from ffvvc_tpu_torch.ops import alf_device, sao_device  # noqa: E402
from ffvvc_tpu_torch.ops import fused_device as fd  # noqa: E402
from ffvvc_tpu_torch.ops.kernel_inputs import (  # noqa: E402
    alf_inputs, cc_inputs, sao_inputs)

W, H, CTB, BD, NFRAMES, QP = 1920, 1080, 32, 10, 4, 30
SEED = 0
# the decoded streams: label -> extra forge arguments.  With LMCS chroma
# residual scaling on, the host half declines its native C recon
# (ffvvc_tpu/decoder.py:529-533) and reconstructs in the Python golden
# model; with it off the C recon runs, as on the decoder's main path.
STREAMS = {
    "lmcs-crs": {},
    "c-recon": {"ph_kw": {"ph_chroma_residual_scale_flag": 0}},
}
MAIN = "c-recon"        # the stream whose launch counts the summary reports
KERNELS = {   # wrapper -> (name, TPU kernel it replaces)
    "sao": (sao_device.sao_apply, "ffvvc_tpu/ops/sao_device.py:59"),
    "alf": (alf_device.alf_filter_plane, "ffvvc_tpu/ops/alf_device.py:69"),
    "cc_alf": (alf_device.cc_filter, "ffvvc_tpu/ops/alf_device.py:94"),
}


def card():
    """`nvidia-smi` name and power limit of the card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, n=20):
    """Median time of one call, CUDA events around each: the device time
    of its kernels plus any wait for the host to launch them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def device_ms(fn, n=20):
    """Device time of one call from the profiler's CUDA activity: the sum
    over the kernels and copies it ran, per call.  None when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / n / 1e3 if total_us > 0 else None


def environment():
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)} capability "
          f"{torch.cuda.get_device_capability(0)} count "
          f"{torch.cuda.device_count()}")
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(f"nvcc {nvcc}: {ver.strip().splitlines()[-1]}")


def check_kernels(dev, smi):
    """Each kernel against its twin at 1080p10 4:2:0 shapes.  Returns the
    per-kernel summary (launch counts are filled in by the decode)."""
    rng = np.random.default_rng(SEED)
    pix_max = (1 << BD) - 1
    half = 1 << (BD - 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = {k: [] for k in KERNELS}   # kernel -> [(shape, fn, ref)]
    for plane, (h, w, cs) in (("luma", (H, W, CTB)),
                              ("chroma", (H // 2, W // 2, CTB // 2))):
        x, p = sao_inputs(rng, h, w, cs, cs, BD)
        x, p = t(x), {k: t(v) for k, v in p.items()}
        args = (x, p, cs, cs, BD - 5, pix_max)
        cases["sao"].append((plane, lambda a=args: sao_device.sao_apply(*a),
                             lambda a=args: sao_device.sao_apply_ref(*a)))
        luma = plane == "luma"
        cur, rowsel, vbsel, cf, cl, l2h, l2w = alf_inputs(rng, h, w, cs, cs,
                                                          BD, luma)
        cur = t(cur)
        border = 3 if luma else 2
        args = (cur, sao_device.pad_edge(cur, border), t(rowsel).long(),
                t(vbsel), t(cf), t(cl), l2h, l2w,
                alf_device.LUMA_SLOTS if luma else alf_device.CHROMA_SLOTS,
                border, pix_max)
        cases["alf"].append(
            (plane, lambda a=args: alf_device.alf_filter_plane(*a),
             lambda a=args: alf_device.alf_filter_plane_ref(*a)))
    dst, luma, rowsel, skip, cf = cc_inputs(rng, H // 2, W // 2, CTB, 1, 1,
                                            BD)
    args = (t(dst), sao_device.pad_edge(t(luma), 3), t(rowsel).long(),
            t(skip), t(cf), CTB // 2, CTB // 2, 1, half, pix_max)
    cases["cc_alf"].append(
        ("chroma", lambda a=args: alf_device.cc_filter(*a),
         lambda a=args: alf_device.cc_filter_ref(*a)))

    summary = {}
    for name, runs in cases.items():
        err, ms, plain_ms, dev_ms, plain_dev_ms = 0, 0.0, 0.0, 0.0, 0.0
        for plane, fn, ref in runs:
            got = fn()
            torch.cuda.synchronize()
            want = ref()
            torch.cuda.synchronize()
            err = max(err, int((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"{name} ({plane}) differs from its "
                                     f"twin: max abs err {err}")
            k_ms, p_ms = time_ms(fn), time_ms(ref)
            k_dev, p_dev = device_ms(fn), device_ms(ref)
            # per 4:2:0 frame: one luma launch and two chroma launches
            # (CC-ALF: two chroma launches)
            n = 1 if plane == "luma" else 2
            ms += n * k_ms
            plain_ms += n * p_ms
            dev_ms = None if k_dev is None or dev_ms is None \
                else dev_ms + n * k_dev
            plain_dev_ms = None if p_dev is None or plain_dev_ms is None \
                else plain_dev_ms + n * p_dev
            print(f"kernel {name} {plane} {tuple(got.shape)}: call "
                  f"{k_ms:.4f} ms (device {k_dev} ms), twin {p_ms:.4f} ms "
                  f"(device {p_dev} ms), equal [{smi}]")
        summary[name] = {"name": name, "route": "cuda",
                         "source": "ffvvc_tpu_torch/csrc/filters.cu",
                         "replaces": KERNELS[name][1], "launches": 0,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
                         "per": "1080p10 4:2:0 frame"}
    return summary


def forge_stream(**extra):
    """A 4-frame 1080p10 all-intra stream with SAO, ALF, CC-ALF and LMCS
    switched on in every slice, cached in the temp directory; `extra`
    goes to the forge as well.
    (bench.py's device-leg stream, forge_tools_stream, sets only the SPS
    flags of ALF and LMCS: no APS is sent and no slice enables them, so
    its decode never reaches ALF or CC-ALF.)"""
    from forge import forge_inter_stream
    kw = dict(slice_type=2, seed=SEED, width=W, height=H, qp=QP,
              bit_depth=BD, nframes=NFRAMES, deblock=True,
              sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
              sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1, **extra)
    key = hashlib.sha256(repr(sorted(kw.items())).encode()).hexdigest()[:16]
    cache = os.path.join(tempfile.gettempdir(), f"ffvvc_smoke_{key}.bit")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return f.read()
    t0 = time.monotonic()
    stream = forge_inter_stream(**kw)
    print(f"forged {len(stream)} bytes in {time.monotonic() - t0:.1f} s")
    with open(cache + ".tmp", "wb") as f:
        f.write(stream)
    os.replace(cache + ".tmp", cache)
    return stream


def yuv_md5(frames):
    h = hashlib.md5()
    for fr in frames:
        h.update(fr.to_yuv_bytes())
    return h.hexdigest(), len(frames)


def decode(label, stream, smi):
    """Decode `stream` through the port's main path and check it against
    the host decode of the same stream.  Returns the kernel launch counts
    of the timed decode."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder

    # the host reference: the same decoder with the fused chain off runs
    # the host half's own LMCS, deblock, SAO and ALF stages
    t0 = time.monotonic()
    ref_md5, n = yuv_md5(VVCDecoder(DecoderConfig(
        device="cuda", device_pipeline=False)).decode(stream))
    dt = time.monotonic() - t0
    print(f"[{label}] host decode: {n} frames in {dt:.3f} s = "
          f"{n / dt:.3f} fps (host CPU), md5 {ref_md5}")
    cfg = DecoderConfig(device="cuda", device_pipeline=True)
    VVCDecoder(cfg).decode(stream)                 # warm-up
    # the main path: counts from zero, one decode, counts read after it
    fd.reset_stats()
    for fn, _ in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    frames = VVCDecoder(cfg).decode(stream)
    dt = time.monotonic() - t0
    launches = {k: fn.launches for k, (fn, _) in KERNELS.items()}
    stats = dict(fd.stats)
    md5, n = yuv_md5(frames)
    print(f"[{label}] port decode: {n} frames in {dt:.3f} s = "
          f"{n / dt:.3f} fps, md5 {md5} [{smi}]")
    nf = max(1, stats["frames"])
    print(f"[{label}] wire per frame: {stats['up_bytes'] / nf / 1e6:.3f} MB "
          f"up, {stats['down_bytes'] / nf / 1e6:.3f} MB down [{smi}]")
    print(f"[{label}] launches in the timed decode: {json.dumps(launches)}")
    if md5 != ref_md5 or n != NFRAMES:
        raise AssertionError(f"[{label}] port decode md5 {md5} ({n} frames) "
                             f"!= host {ref_md5}")
    if stats["frames"] != NFRAMES:
        raise AssertionError(f"[{label}] fused chain ran on "
                             f"{stats['frames']} of {NFRAMES} frames")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"[{label}] kernel {k} never launched in "
                                 f"the decode")
    # where the time goes: one more decode with the frame pipeline off so
    # the stage clock is not shared between the parse and pixel threads
    fd.reset_stats()
    dec = VVCDecoder(DecoderConfig(device="cuda", device_pipeline=True,
                                   pipeline_frames=False, profile=True))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        dec.decode(stream)
        dt = time.monotonic() - t0
    busy = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    busy_ms = sum(b[0] for b in busy) / 1e3
    print(f"[{label}] serial decode: device busy {busy_ms / NFRAMES:.3f} ms "
          f"per frame of {dt / NFRAMES * 1e3:.1f} ms wall; top device work "
          "per frame: "
          + "; ".join(f"{k[:60]} x{c // NFRAMES} {us / NFRAMES / 1e3:.3f} ms"
                      for us, c, k in busy[:8]))
    stages = {k: round(v / NFRAMES * 1e3, 3)
              for k, v in dec.stage_times.items()}
    stages["fused.build"] = round(fd.stats["build_s"] / NFRAMES * 1e3, 3)
    stages["fused.device"] = round(fd.stats["device_s"] / NFRAMES * 1e3, 3)
    print(f"[{label}] serial decode {NFRAMES / dt:.3f} fps; ms per frame by "
          f"stage: {json.dumps(stages)} [{smi}]")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    environment()
    smi = card()
    print(f"nvidia-smi: {smi}")
    t0 = time.monotonic()
    _build.lib()
    print(f"build: {_build.library_path()} in "
          f"{time.monotonic() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    summary = check_kernels(dev, smi)
    launches = {}
    for label, extra in STREAMS.items():
        launches[label] = decode(label, forge_stream(**extra), smi)
    for k in summary:
        summary[k]["launches"] = launches[MAIN][k]
    print(f"card: {smi}")
    print(json.dumps({"kernels": list(summary.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
