"""One run of one cell: inputs from the seed, set-up, the timed window,
then the comparison with the frozen reference and the metrics.

The timed path is `ffvvc_tpu_torch.VVCDecoder(config).decode(segment)`, a
fresh decoder a segment, the segments back to back in one process (a
closed loop, as a segment transcoder runs): the window is the sum of those
calls and ends on a whole segment.  Between two calls the harness hashes
the frames it got and recycles them, outside the clock.
"""
from __future__ import annotations

import base64
import dataclasses
import gc
import hashlib
import json
import os
import sys
import threading
import time

from . import cells, reference, roofline, segments, spans, trace

# whole top-level names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "ffvvc_tpu")
# every number compared is exact: its limit is 0
LIMITS = {"segments_raised": 0, "frames_missing": 0, "order_errors": 0,
          "planes_differing": 0, "parameter_sets_differing": 0}
OUT_DIR = os.path.join(cells.BENCH_DIR, ".out")
CACHE_DIR = os.path.join(cells.BENCH_DIR, ".cache")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def source_key(cell, size):
    """Hash of what the inputs and the reference's records depend on: the
    frozen package, the generator, the reference, the roofline arithmetic,
    the configuration, the traffic and the picture size."""
    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.join(here, f) for f in
             ("segments.py", "reference.py", "roofline.py")]
    ref = os.path.join(cells.BENCH_DIR, "vvcref")
    for d, dirs, files in sorted(os.walk(ref)):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        paths += [os.path.join(d, f) for f in sorted(files)]
    for p in paths:
        h.update(os.path.relpath(p, cells.BENCH_DIR).encode() + b"\0")
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(json.dumps([cell.config, cell.traffic, size],
                        sort_keys=True).encode())
    return h.hexdigest()[:16]


class Cache:
    """Forged segments and reference records of (cell, seed), kept under
    `.cache/<cell>/` of the checkout; both depend on nothing else."""

    def __init__(self, cell, seed, size, root=CACHE_DIR):
        self.stem = os.path.join(root, cell.name,
                                 f"{seed}-{source_key(cell, size)}")

    def load(self, kind):
        try:
            with open(f"{self.stem}.{kind}.json") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def save(self, kind, obj):
        path = f"{self.stem}.{kind}.json"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump(obj, f)
        os.replace(path + ".tmp", path)


def load_segments(cache, cell, seed, size, processes):
    got = cache.load("segments")
    if got is None:
        segs = segments.forge(cell.config, cell.traffic, seed, size,
                              processes)
        cache.save("segments", [
            [base64.b64encode(h).decode(),
             [base64.b64encode(f).decode() for f in fr]] for h, fr in segs])
        return segs
    return [(base64.b64decode(h), [base64.b64decode(f) for f in fr])
            for h, fr in got]


def load_reference(cache, segs, traffic, processes):
    got = cache.load("reference")
    if got is None:
        got = reference.run(segs, traffic, processes)
        cache.save("reference", got)
    return got


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader sees of a traced run."""
    frames: int                 # frames output in the window
    inter_frames: int           # of them P or B
    spans: spans.Recorder       # the benchmark's spans of the window
    fused: dict                 # fused_device.stats over the window
    mc: dict                    # mc_device.stats over the window
    trace: trace.Summary | None  # the device trace, None off the card
    least_s: dict               # stage -> least seconds of the window's work


def compare(done, ref):
    """Numbers compared, and the segments that failed."""
    n = dict.fromkeys(LIMITS, 0)
    failed = 0
    for s, out, err in done:
        want = ref[s]
        before = dict(n)
        n["segments_raised"] += err is not None
        n["frames_missing"] += abs(len(want) - len(out))
        for (poc, md5), w in zip(out, want):
            n["order_errors"] += poc != w["poc"]
            n["planes_differing"] += sum(a != b for a, b in
                                         zip(md5, w["md5"]))
            n["planes_differing"] += abs(len(md5) - len(w["md5"]))
        failed += n != before
    return n, failed


def run(cell, seed, seconds, trace_on, device="cuda", size=None,
        processes=None, t0=None, cache_root=CACHE_DIR):
    """Run `cell` once; returns the result line's object."""
    t0 = time.monotonic() if t0 is None else t0
    cache = Cache(cell, seed, size, cache_root)
    tf = time.monotonic()
    segs = load_segments(cache, cell, seed, size, processes)
    forge_s = time.monotonic() - tf
    data = [h + b"".join(fr) for h, fr in segs]

    import torch
    import ffvvc_tpu_torch as port
    from ffvvc_tpu_torch.ops import fused_device, mc_device
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config = port.DecoderConfig(device=device, **cell.config["decoder"])
    rec = spans.Recorder()
    if trace_on:
        rec.install()
    # set-up: one segment, which builds and loads every library and warms
    # every shape the window uses (all segments of a cell share them)
    for f in port.VVCDecoder(config).decode(data[0]):
        f.recycle()
    sync()
    gc.collect()
    fused_device.reset_stats()
    mc_device.reset_stats()
    rec.spans.clear()
    setup_s = time.monotonic() - t0 - forge_s

    prof = trace.start() if trace_on and on_card else None
    rec.profiling = prof is not None
    done = []                  # (segment, [(poc, plane md5s)], error)
    elapsed = cpu = 0.0
    i = 0
    while elapsed < seconds:
        s = i % len(data)
        i += 1
        a, c = time.perf_counter(), time.process_time()
        frames, err = [], None
        try:
            with rec.span(spans.SEGMENT):
                frames = port.VVCDecoder(config).decode(data[s])
                sync()
        except Exception as e:          # a broken decode is a wrong answer
            err = repr(e)
        elapsed += time.perf_counter() - a
        cpu += time.process_time() - c
        done.append((s, [(f.poc, reference.plane_digests(f.buffer.planes))
                         for f in frames], err))
        for f in frames:
            f.recycle()
        del frames
    rec.profiling = False
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    fused, mc = dict(fused_device.stats), dict(mc_device.stats)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference decodes in its own processes while this one reads the
    # device trace: a traced run stays well inside its time limit
    tr = time.monotonic()
    got = {}

    def reference_job():
        try:
            got["ref"] = load_reference(cache, segs, cell.traffic, processes)
        except BaseException as e:          # raised again below
            got["error"] = e
    job = threading.Thread(target=reference_job)
    job.start()
    summary = None
    try:
        if prof is not None:
            os.makedirs(OUT_DIR, exist_ok=True)
            summary = trace.read(prof, os.path.join(
                OUT_DIR, f"trace-{cell.name}-{seed}.json"), rec.spans)
        rec.uninstall()
    finally:
        job.join()
    if "error" in got:
        raise got["error"]
    ref = got["ref"]
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded in the run's process: {', '.join(bad)}")
    print(f"vvcbench: {cell.name} seed {seed}: inputs {forge_s:.1f} s, "
          f"set-up {setup_s:.1f} s, window {elapsed:.1f} s, reference "
          f"(beside the trace's reading) {time.monotonic() - tr:.1f} s",
          file=sys.stderr)
    checks, failed = compare(done, ref)
    # the reference's reading of the parameter sets against the forge's
    checks["parameter_sets_differing"] = sum(
        len(reference.parameter_set_gaps(h, cell.config, cell.traffic, seed,
                                         s, size))
        for s, (h, _) in enumerate(segs))
    if checks["parameter_sets_differing"]:
        failed = len(done)
    nframes = sum(len(out) for _, out, _ in done)
    n_inter = sum(f["slice"] != "I" for f in cell.traffic["frames"])
    ok = [s for s, _, err in done if err is None]
    result = {"correct": bool(done) and all(
        checks[k] <= LIMITS[k] for k in LIMITS),
        "attempted": len(done), "failed": failed}
    if trace_on:
        least = dict.fromkeys(roofline.STAGES, 0.0)
        for s in ok:
            for r in ref[s]:
                for k in least:
                    least[k] += r["least_s"][k]
        view = RunView(nframes, n_inter * len(ok), rec, fused, mc, summary,
                       least)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"spans-{cell.name}-{seed}.json"),
                  "w") as f:
            json.dump(rec.spans, f)
        values = {m["name"]: (cells.reader(m["name"])(view), m["unit"])
                  for m in cell.per_layer}
    else:
        e2e = {"fps": nframes / elapsed if elapsed else None,
               "cpu_s_per_frame": cpu / nframes if nframes else None,
               "setup_s": setup_s}
        values = {m["name"]: (e2e[m["name"]], m["unit"])
                  for m in cell.end_to_end}
    result["metrics"] = {k: {"value": v, "unit": u}
                         for k, (v, u) in values.items() if v is not None}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.top_ops(),
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                        for k, v in checks.items()}
    return result
