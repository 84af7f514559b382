"""Smoke run of the port on one NVIDIA GPU: build, check, decode.

    python3 chip_smoke.py

It needs one card; where several are visible, phase 9 also runs the mesh
across them.

Phases, each of which raises on a fault (the script then exits non-zero):

1. Environment: torch/CUDA versions, the card, its power limit, nvcc.
2. Forge the five 1080p streams below, one process each, into the
   temp-directory cache.  Build, all at once: csrc/filters.cu with nvcc
   (ffvvc_tpu_torch/ops/_build.py) and the host half's eight C libraries
   with gcc (ffvvc_tpu_torch/native/_build.py), each from the package's own
   sources.
3. Kernels: SAO (three planes in one launch), luma ALF, chroma ALF (two
   planes in one launch) and CC-ALF (two planes in one launch) on seeded
   inputs, each held against its plain PyTorch version exactly
   (torch.equal), at the shapes a 1080p 10-bit 4:2:0 frame with CTB 32
   gives them (luma 1080x1920, chroma 540x960; the last CTB row is
   partial) and at 416x240 4:2:0 with CTB 32 and CTB 128 (8-aligned, not
   tile-aligned, last CTB row partial); SAO also with luma and chroma in
   launches of their own, CC-ALF also with one plane.  Each kernel also in
   the variant that pictures with slices or tiles that filtering must not
   cross need: SAO with kept ranges on every edge-offset CTB, ALF and
   CC-ALF with random per-CTB edge words.  At the 1080p shapes each is
   timed on the device by replaying a CUDA graph of its launches: warm (one
   input set, which stays in the L2) and cold (cycling through input sets
   of over 100 MB, twice the L2), beside the least time the card could take
   (`bound`: the larger of its bytes at the memory rate and its integer
   operations at the rate of the busier pipe).  The plain version and one
   eager wrapper call (host overhead included) are timed with CUDA events.
4. Decode: 2-frame 1080p10 all-intra streams with SAO, ALF, CC-ALF and
   LMCS on: `lmcs-crs` with LMCS chroma residual scaling (its host recon
   runs in the Python golden model), `c-recon` without (the native C recon
   runs), and `across-off`, as `c-recon` with two tile columns and no
   filtering across tiles or slices.  Two paths through ffvvc_tpu_torch on
   the card: the fused chain (device_pipeline) on all three, and the
   per-stage device filters (device_lmcs, device_deblock, device_sao,
   device_alf) on `c-recon` and `across-off`.  Every decode's YUV md5 must
   equal the host decode of the same stream (the same decoder with every
   device toggle off).  On the first two streams every frame must run the
   fused chain; it must decline `across-off`, which the per-stage path
   then filters with all kernels, ALF and CC-ALF with edge words.  Each
   path is driven with the launch counts set to 0 just before and read
   just after, and every kernel must have launched.  A second, serial
   decode prints the time per stage.
5. Functions on tensors of device MC and the inverse transform
   (ops/mc_device.py, ops/inter_device.py, ops/itx.py; plain PyTorch, as
   they are XLA functions and no kernels in the JAX package): every family
   on seeded inputs once on the card and once on the CPU, torch.equal: puts
   for luma and chroma in all four classes, with wraparound, with boxes,
   with origins outside the picture, at 8, 10 and 12 bits; the DMVR
   bilinear prefetch; the DMVR refinement on pairs with ties; BDOF; PROF;
   GPM; the plain and weighted finals with negative weights and offsets;
   the inverse transform for DCT2, DST7 and DCT8 at every size from 1xN to
   64x64 with coefficients at +-(2^15 - 1) against the NumPy int64 version
   (its float64 products must be the exact integers), with its time beside
   an int64 multiply-and-sum; dequantisation; the residual scatter.  The
   hand-written put kernel of device MC (csrc/mc.cu) against its plain
   twin on the CPU, torch.equal: one table of every variant (four classes,
   luma and chroma, 2x2 to 128x128, PROF and BDOF rings, wraparound, boxes,
   blocks over each border) on 1080p planes at 8, 10 and 12 bits, whole
   and in the three parts a mesh of three tiles launches.
6. Inter frames: `inter-b`, a 1080p10 hierarchical stream (IDR, P, B with a
   past and a future reference: DMVR and BDOF armed) with deblock, SAO, ALF
   and CC-ALF, decoded by the host, by device_mc alone (once as it comes,
   once with a pixel thread that starts late, so that the references are
   still in flight when the next frame's MC runs) and by device_mc with
   device_pipeline (the hand kernels on the same frames); all md5-equal,
   each with one frame_device_mc call per inter frame; all four put
   classes, DMVR and BDOF counted; on the card every call's puts in one
   put-kernel launch and none eager.  The largest whole frame's put table
   and a small table (its first ninth of rows) replayed: the kernel's
   device time, bytes and bound beside its whole wrapper and its plain
   twin.  Per inter frame: descriptors, buckets,
   batched calls, MB up and down and the ms of the MC stage beside the host
   C MC's.  Then the other inter tools at 416x240 through device_mc (affine
   with PROF, SbTMVP, GPM, weighted P and bi, BCW, wraparound, mono LMCS,
   DMVR at 12 bits) and one golden-parse decode through the batched inverse
   transform, each md5-equal to the host decode.  Also on `inter-b`:
   device_intra, device_mc and the fused chain together (the IDR through
   device intra), md5-equal.
7. Intra frames (ops/intra_device.py; plain PyTorch, as the JAX package's
   intra functions are XLA functions): a one-frame 64x64 intra decode to
   warm the allocator; the 14 small streams of tests/test_device_intra.py
   and a 4:2:0 one without collocated chroma through device_intra, each
   md5-equal to its host decode with every frame on the device, their
   buckets captured and replayed on the card and on the CPU (torch.equal:
   both angular orientations in luma and chroma, the three MIP size ids,
   the four CCLM layouts, 8, 10 and 12 bits, PDPC side gathers outside the
   reference array in thrown-away lanes, a bucket with negative nscale).
   The main path: `c-recon` through device_intra with the fused chain,
   counts from zero just before and read just after: every frame on the
   device, every hand kernel launched (`launches_intra` in the summary).
   `intra-tools`, bench.py's device-leg stream with CCLM at 1080p10 (one
   frame), through device_intra: every family.  Per 1080p frame: units, waves,
   buckets by family, host ms by section, MB up and down, the stage's ms
   beside the host C recon's, and for the first frame of `c-recon` the
   device busy time and kernel count under the profiler.
8. The mesh (ffvvc_tpu_torch/parallel/, `mesh_shape`), every slab on card
   0 (an explicit `mesh_devices` list that repeats it): first one
   slab-origin launch of each kernel and variant at the 1080p shapes, cut
   where the mesh cuts a (1, 2) picture, torch.equal to the same rows of a
   whole-picture launch; then `c-recon` at (2, 2) (one
   drain over a gop of 2), `across-off` at (1, 2) (SAO's restore regions,
   ALF and CC-ALF with edge words, on slabs) and `inter-b` at (1, 2) with
   device_mc (puts split over the tile axis, a selective drain at the
   reference barrier), each md5-equal to its host decode, the launch
   counts set to 0 just before each and read just after: every kernel
   launches (`launches_mesh` in the summary).
9. The mesh across cards (`mesh_devices` left to its default, the visible
   cards): the card count and the peer access of each pair; with one card
   a line that says the cross-card decodes did not run.  With two or more:
   on each card past the first, with card 0 current, one slab launch of
   each kernel against its whole-picture launch; `across-off` and
   `inter-b` at (1, 2) on cuda:0-1, with four cards also `c-recon` at
   (2, 2) on cuda:0-3 (one drain over a gop of 2); each md5-equal to its
   host decode, every kernel launched on every card of its mesh (the
   wrappers' per-device counts), `inter-b`'s puts split over the cards;
   ms a frame beside the one-card form's of phase 8 and the bytes of
   reference plane sent to each other card a frame.
10. GOP workers (ffvvc_tpu_torch/pipeline.py): a 3-frame multi-IDR 1080p10
   stream (forge_scaling_stream) through decode_parallel with 3 workers
   and device_sao on the card: the pool is spawned, and the YUV md5
   equals the sequential host decode; both walls printed.
11. No module of the JAX package and no JAX was loaded.

Each phase prints its seconds.  The last two lines of stdout are a JSON
summary of the kernels and the contract line
{"ok": true, "device": {...}}.
"""
import concurrent.futures
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ffvvc_tpu_torch.cabac import native as cabac_native  # noqa: E402
from ffvvc_tpu_torch.native import _build as native_build  # noqa: E402
from ffvvc_tpu_torch.native import (  # noqa: E402
    alf as n_alf, deblock as n_deblock, intra as n_intra, mc as n_mc,
    parse as n_parse, recon as n_recon, sao as n_sao)
from ffvvc_tpu_torch.ops import _build  # noqa: E402
from ffvvc_tpu_torch.ops import alf_device, sao_device  # noqa: E402
from ffvvc_tpu_torch.ops import fused_device as fd  # noqa: E402
from ffvvc_tpu_torch.ops import inter_device, itx, mc_device  # noqa: E402
from ffvvc_tpu_torch.ops import intra_device as idv  # noqa: E402
from ffvvc_tpu_torch.ops.kernel_inputs import (  # noqa: E402
    alf_chroma_inputs, alf_luma_inputs, cc_inputs, edge_words, put_inputs,
    sao_inputs, sao_restore_inputs)
from ffvvc_tpu_torch.ops.device import Slab, stream_of  # noqa: E402
from ffvvc_tpu_torch.parallel import filters as PF  # noqa: E402
from ffvvc_tpu_torch.pipeline import _decode_segment  # noqa: E402
from ffvvc_tpu_torch import trace  # noqa: E402

W, H, CTB, BD, NFRAMES, QP = 1920, 1080, 32, 10, 2, 30
SEED = 0
# the decoded streams: label -> extra forge arguments.  With LMCS chroma
# residual scaling on, the host half declines its native C recon
# (ffvvc_tpu_torch/decoder.py, native_recon_ok) and reconstructs in the
# Python golden model; with it off the C recon runs, as on the decoder's
# main path.
_NO_CRS = {"ph_kw": {"ph_chroma_residual_scale_flag": 0}}
STREAMS = {
    "lmcs-crs": {},
    "c-recon": _NO_CRS,
    # two tile columns, no loop filter across tiles or slices: the fused
    # chain declines it, the per-stage filters take it
    "across-off": dict(_NO_CRS, info_in_ph=True, pps_kw={
        "lf_across_tiles": 0, "lf_across_slices": 0}),
}
# the two paths through the decoder, as DecoderConfig toggles
PATHS = {
    "fused": dict(device_pipeline=True),
    "stages": dict(device_lmcs=True, device_deblock=True, device_sao=True,
                   device_alf=True),
}
# (stream, path) of every decode; the summary reports the launch counts of
# MAIN for the kernels as the fused chain runs them and of MAIN_STAGES for
# the variants only the per-stage path runs
DECODES = (("lmcs-crs", "fused"), ("c-recon", "fused"), ("c-recon", "stages"),
           ("across-off", "fused"), ("across-off", "stages"))
MAIN = ("c-recon", "fused")
MAIN_STAGES = ("across-off", "stages")
FILTERS_CU = "ffvvc_tpu_torch/csrc/filters.cu"
_SAO, _ALF, _CC = ("ffvvc_tpu/ops/sao_device.py:59",
                   "ffvvc_tpu/ops/alf_device.py:69",
                   "ffvvc_tpu/ops/alf_device.py:94")
# name -> (wrapper, which of its launches: all, those without edge words or
# those with, TPU kernel it replaces, decode whose count the summary reports)
KERNELS = {
    "sao": (sao_device.sao_apply, "all", _SAO, MAIN),
    "sao/restore": (sao_device.sao_apply, "all", _SAO, MAIN_STAGES),
    "alf_luma": (alf_device.alf_filter_luma, "plain", _ALF, MAIN),
    "alf_luma/edges": (alf_device.alf_filter_luma, "edges", _ALF,
                       MAIN_STAGES),
    "alf_chroma": (alf_device.alf_filter_chroma, "plain", _ALF, MAIN),
    "alf_chroma/edges": (alf_device.alf_filter_chroma, "edges", _ALF,
                         MAIN_STAGES),
    "cc_alf": (alf_device.cc_filter, "plain", _CC, MAIN),
    "cc_alf/edges": (alf_device.cc_filter, "edges", _CC, MAIN_STAGES),
}
# Peak rates of one H100 SXM at its full 700 W (NVIDIA's data sheet): 3.35
# TB/s of device memory; 67 TFLOP/s of float32 outside the tensor cores,
# which is 2 operations (a multiply-add) on each of 128 lanes per SM and
# clock.  32-bit integer instructions have two pipes per SM, each 64 lanes
# wide (NVIDIA's CUDA C++ programming manual, arithmetic instruction
# throughput, compute capability 9.0: 64 results per clock and SM for
# integer add, subtract, min, max, compare and shift, and 64 for integer
# multiply and multiply-add): the FMA pipe takes multiply-add and, since the compiler may
# write them as one, add and subtract; the ALU pipe takes min, max, compare,
# select, logic and shift.  A mixed stream can keep both busy, so the least
# time of a function is that of its busier pipe at a quarter of the float32
# figure in instructions per second.
PEAK_BYTES_S = 3.35e12
PEAK_PIPE_OPS_S = 67e12 / 4
# (ALU, FMA) integer operations per output sample that the function itself
# needs, whatever instructions a kernel spends on addresses and staging.
# ALF: a slot is two taps of subtract (FMA), max and min (ALU), then an add
# and a multiply-add (FMA): (4, 4); the tail is a rounding add, a shift, the
# add to the sample and a clip: (3, 2).
ALF_LUMA_OPS = (12 * 4 + 3, 12 * 4 + 2)
ALF_CHROMA_OPS = (6 * 4 + 3, 6 * 4 + 2)
# SAO by the type of the sample's CTB.  Off: none.  Band: shift, mask,
# compare, select and the clip (ALU 6), subtract and add (FMA 2).  Edge: two
# signs of max and min and the clip (ALU 6), two subtracts, the add of the
# signs and the add of the offset (FMA 4).
SAO_OPS = {0: (0, 0), 1: (6, 2), 2: (6, 4)}
# CC-ALF: a position of a filtered row has 7 subtracts, whichever planes use
# them (FMA 7), and in each plane 7 multiply-adds (FMA 7); every sample of a
# plane has a rounding add, a shift, a clip, the add to chroma and a clip:
# (5, 2).
CC_DIFF_OPS = (0, 7)
CC_TAP_OPS = (0, 7)
CC_TAIL_OPS = (5, 2)
L2_BYTES = 50e6


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


def graph_ms(calls, launches=256, reps=5):
    """Device time of one launch: `calls` (each launches one kernel) are
    captured round-robin into one CUDA graph of `launches` launches, which
    the card then replays back to back with no host in between; the median
    over `reps` replays of elapsed time / launches."""
    n = -(-launches // len(calls)) * len(calls)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up outside the capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    return statistics.median(times)


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


def build():
    """Every library of the port from its own sources, all started
    together: nvcc for the kernels, gcc for the host half."""
    loaders = {"ffvvc_filters (nvcc)": _build.lib,
               "vvc_cabac": cabac_native.load_lib,
               "vvc_parse": n_parse.load_lib, "vvc_recon": n_recon.load_lib,
               "vvc_intra": n_intra.load_lib, "vvc_mc": n_mc.load_lib,
               "vvc_deblock": n_deblock.load_lib, "vvc_sao": n_sao.load_lib,
               "vvc_alf": n_alf.load_lib}
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()
    secs = dict(native_build.build_seconds)
    print(f"build: {len(loaders)} libraries in {time.monotonic() - t0:.2f} s "
          f"into {native_build.BUILD_DIR}; seconds each: "
          + json.dumps({k: round(v, 2) for k, v in sorted(secs.items())}))
    print(f"build: kernels {_build.library_path()}")


class Case:
    """One kernel at one shape: `sets` are argument tuples that differ in
    their sample planes only; `call`/`plain` run the wrapper and its plain
    version on one of them and return a list of planes; `ops` are the
    (ALU, FMA) integer operations the function needs on these inputs."""

    def __init__(self, name, label, call, plain, sets, nbytes, ops):
        self.name, self.label = name, label
        self.call, self.plain, self.sets = call, plain, sets
        self.nbytes, self.ops = nbytes, ops


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def kernel_cases(dev, h, w, ctb, cold):
    """The kernels and their variants at the shapes a 4:2:0 h x w picture
    with CTB `ctb` gives them.  With `cold`, each case gets enough input
    sets to exceed the L2 twice over; else one."""
    rng = np.random.default_rng(SEED)
    pix_max, half = (1 << BD) - 1, 1 << (BD - 1)
    hc, wc, cc = h // 2, w // 2, ctb // 2

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def variants(planes, sample_bytes):
        """Plane sets: the seeded one, then shifted copies of it."""
        n = int(2 * L2_BYTES // sample_bytes) + 1 if cold else 1
        return [[(p + 37 * i) & pix_max if i else p for p in planes]
                for i in range(n)]

    def nbytes(*tensors):
        return sum(x.numel() * x.element_size() for x in tensors)
    cases = []
    # SAO: the three planes in one launch
    shapes = ((h, w, ctb, ctb, BD), (hc, wc, cc, cc, BD), (hc, wc, cc, cc, BD))
    sizes = [(ctb, ctb), (cc, cc), (cc, cc)]
    ins = [sao_inputs(rng, *s) for s in shapes]
    planes = [t(x) for x, _ in ins]
    prms = [t(sao_device.pack_params(p, *s[:4])) for (_, p), s in
            zip(ins, shapes)]
    ins_r = [sao_restore_inputs(rng, *s) for s in shapes]
    planes_r = [t(x) for x, _ in ins_r]
    prms_r = [t(p) for _, p in ins_r]

    def sao_ops(prm, plane, size):
        """by the SAO type of each sample's CTB"""
        typ = np.repeat(np.repeat(prm[0].cpu().numpy(), size[0], 0),
                        size[1], 1)[:plane.shape[0], :plane.shape[1]]
        return sum(int((typ == k).sum()) * np.array(n)
                   for k, n in SAO_OPS.items())
    # (name, label, planes): the launch the chain makes; to read beside the
    # times of single-plane launches, luma and chroma apart; then the
    # tables with kept ranges on every edge-offset CTB
    for name, label, pl, pr, sel in (
            ("sao", f"3 planes {h}x{w} + 2x {hc}x{wc}", planes, prms,
             slice(0, 3)),
            ("sao/luma", f"luma {h}x{w} alone", planes, prms, slice(0, 1)),
            ("sao/chroma", f"2 planes {hc}x{wc} alone", planes, prms,
             slice(1, 3)),
            ("sao/restore", f"3 planes {h}x{w} + 2x {hc}x{wc}, kept ranges "
             "on every edge-offset CTB", planes_r, prms_r, slice(0, 3))):
        pb = nbytes(*pl[sel])
        cases.append(Case(
            name, label,
            lambda s, p=pr[sel], z=sizes[sel]: sao_device.sao_apply(
                s, p, z, BD - 5, pix_max),
            lambda s, p=pr[sel], z=sizes[sel]: sao_device.sao_apply_ref(
                s, p, z, BD - 5, pix_max),
            variants(pl[sel], pb), 2 * pb + nbytes(*pr[sel]),
            sum(sao_ops(p, x, z) for p, x, z in
                zip(pr[sel], pl[sel], sizes[sel]))))
    # luma ALF, without and with per-CTB edge words
    src, ci, ti, ctb_set, cf, cl = (t(a) for a in
                                    alf_luma_inputs(rng, h, w, ctb, BD))
    edges = t(edge_words(rng, *ctb_set.shape))
    pb = nbytes(src)
    for name, e in (("alf_luma", None), ("alf_luma/edges", edges)):
        rest = (ci, ti, ctb_set, cf, cl, ctb, pix_max, e)
        # the kernel reads the tables of the sets in use once
        cases.append(Case(
            name, f"luma {h}x{w}",
            lambda s, r=rest: alf_device.alf_filter_luma(s[0], *r),
            lambda s, r=rest: alf_device.alf_filter_luma_ref(s[0], *r),
            variants([src], pb),
            2 * pb + nbytes(ci, ti, ctb_set, cf, cl, *([] if e is None
                                                       else [e])),
            h * w * np.array(ALF_LUMA_OPS)))
    # chroma ALF: both planes in one launch
    ins = [[t(a) for a in alf_chroma_inputs(rng, hc, wc, cc, cc, BD)]
           for _ in range(2)]
    planes = [x[0] for x in ins]
    edges = t(edge_words(rng, *ins[0][1].shape))
    pb = nbytes(*planes)
    for name, e in (("alf_chroma", None), ("alf_chroma/edges", edges)):
        rest = tuple([x[k] for x in ins] for k in (1, 2, 3)) + \
            (cc, cc, pix_max, e)
        cases.append(Case(
            name, f"2 planes {hc}x{wc}",
            lambda s, r=rest: alf_device.alf_filter_chroma(s, *r),
            lambda s, r=rest: alf_device.alf_filter_chroma_ref(s, *r),
            variants(planes, pb),
            2 * pb + nbytes(*[x for p in ins for x in p[1:]],
                            *([] if e is None else [e])),
            2 * hc * wc * np.array(ALF_CHROMA_OPS)))
    # CC-ALF: both chroma planes in one launch; one plane alone
    dsts, luma, sets, tabs = cc_inputs(rng, hc, wc, ctb, 1, 1, BD)
    dsts, sets, tabs = ([t(a) for a in x] for x in (dsts, sets, tabs))
    luma = t(luma)
    _, skip = alf_device.cc_row_offsets(torch.arange(hc), cc, 1)
    rows = hc - int(skip.sum())
    for name, n, e in (("cc_alf", 2, None), ("cc_alf/one", 1, None),
                       ("cc_alf/edges", 2, edges)):
        rest = (sets[:n], tabs[:n], cc, cc, 1, 1, half, pix_max, e)
        ops = wc * (rows * (np.array(CC_DIFF_OPS) + n * np.array(CC_TAP_OPS))
                    + n * hc * np.array(CC_TAIL_OPS))
        pb = nbytes(luma, *dsts[:n])
        cases.append(Case(
            name, f"{n} plane{'s' if n > 1 else ''} {hc}x{wc}",
            lambda s, r=rest, n=n: alf_device.cc_filter(s[1:1 + n], s[0], *r),
            lambda s, r=rest, n=n: alf_device.cc_filter_ref(s[1:1 + n], s[0],
                                                            *r),
            variants([luma, *dsts[:n]], pb),
            pb + nbytes(*dsts[:n], *sets[:n], *tabs[:n],
                        *([] if e is None else [e])), ops))
    return cases


def compare(case):
    """The kernel against its plain version on the case's first input
    set; returns the largest absolute difference (must be 0)."""
    got = _as_list(case.call(case.sets[0]))
    torch.cuda.synchronize()
    want = _as_list(case.plain(case.sets[0]))
    torch.cuda.synchronize()
    err = max(int((g.int() - w_.int()).abs().max())
              for g, w_ in zip(got, want))
    if len(got) != len(want) or not all(
            torch.equal(g, w_) for g, w_ in zip(got, want)):
        raise AssertionError(f"{case.name} ({case.label}) differs from its "
                             f"plain version: max abs err {err}")
    return err


def check_kernels(dev, smi):
    """Each kernel against its plain version at every shape, and its
    times at the 1080p10 shapes.  Returns the per-kernel summary (launch
    counts are filled in by the decode)."""
    for h, w, ctb in ((240, 416, 32), (240, 416, 128)):
        for case in kernel_cases(dev, h, w, ctb, cold=False):
            compare(case)
            print(f"kernel {case.name} {case.label} CTB {ctb}: equal")
    summary = {}
    for case in kernel_cases(dev, H, W, CTB, cold=True):
        err = compare(case)
        warm = graph_ms([lambda: case.call(case.sets[0])])
        cold = graph_ms([(lambda s=s: case.call(s)) for s in case.sets])
        call = time_ms(lambda: case.call(case.sets[0]))
        plain = time_ms(lambda: case.plain(case.sets[0]))
        by_bytes = case.nbytes / PEAK_BYTES_S * 1e3
        alu, fma = (int(n) for n in case.ops)
        by_ops = max(alu, fma) / PEAK_PIPE_OPS_S * 1e3
        bound = max(by_bytes, by_ops)
        print(f"kernel {case.name} {case.label} CTB {CTB}: equal; device "
              f"{warm:.5f} ms warm, {cold:.5f} ms cold over "
              f"{len(case.sets)} input sets (graph replay); eager call "
              f"{call:.4f} ms; "
              f"plain {plain:.4f} ms; {case.nbytes / 1e6:.3f} MB = "
              f"{by_bytes:.5f} ms = {by_bytes / warm:.1%} of warm, "
              f"{by_bytes / cold:.1%} of cold; {alu / 1e6:.1f} M ALU and "
              f"{fma / 1e6:.1f} M FMA-pipe integer operations = "
              f"{by_ops:.5f} ms; bound {bound:.5f} ms = "
              f"{bound / warm:.1%} of warm, {bound / cold:.1%} of cold "
              f"[{smi}]")
        if case.name not in KERNELS:
            continue
        summary[case.name] = {
            "name": case.name, "route": "cuda", "source": FILTERS_CU,
            "replaces": KERNELS[case.name][2], "launches": 0,
            "max_abs_err": err, "ms": warm, "cold_ms": cold,
            "call_ms": call, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_bound_ms": by_bytes, "operations_bound_ms": by_ops,
            "bytes": case.nbytes, "alu_operations": alu,
            "fma_operations": fma,
            "library_ms": None, "shape": case.label}
    return summary


def forge_stream(**extra):
    """A 1080p10 all-intra stream of NFRAMES frames with SAO, ALF, CC-ALF and LMCS
    switched on in every slice, cached in the temp directory; `extra`
    goes to the forge as well.
    (bench.py's device-leg stream, forge_tools_stream, sets only the SPS
    flags of ALF and LMCS: no APS is sent and no slice enables them, so
    its decode never reaches ALF or CC-ALF.)"""
    from ffvvc_tpu_torch.tools.forge import forge_inter_stream
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


def host_decode(label, stream):
    """The host reference: the same decoder with every device toggle off
    runs the host half's own LMCS, deblock, SAO and ALF stages.  Returns
    the YUV md5."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    t0 = time.monotonic()
    ref_md5, n = yuv_md5(VVCDecoder(DecoderConfig(device="cuda")).decode(
        stream))
    dt = time.monotonic() - t0
    print(f"[{label}] host decode: {n} frames in {dt:.3f} s = "
          f"{n / dt:.3f} fps (host CPU), md5 {ref_md5}")
    if n != NFRAMES:
        raise AssertionError(f"[{label}] host decode gave {n} frames")
    return ref_md5


def decode(label, path, stream, ref_md5, smi):
    """Decode `stream` through one path of the port (PATHS) and check it
    against the host decode's md5.  Returns the kernel launch counts of the
    timed decode: {kernel name of KERNELS: count}."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    tag = f"[{label}/{path}]"
    declines = label == "across-off" and path == "fused"
    cfg = DecoderConfig(device="cuda", **PATHS[path])
    VVCDecoder(cfg).decode(stream)                 # warm-up
    # the path: counts from zero, one decode, counts read after it
    fd.reset_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    frames = VVCDecoder(cfg).decode(stream)
    dt = time.monotonic() - t0
    launches = launch_counts()
    stats = dict(fd.stats)
    md5, n = yuv_md5(frames)
    print(f"{tag} port decode: {n} frames in {dt:.3f} s = "
          f"{n / dt:.3f} fps, md5 {md5} [{smi}]")
    print(f"{tag} launches in the timed decode, {n} frames: "
          f"{json.dumps(launches)}; fused chain ran on {stats['frames']} "
          "frames")
    if md5 != ref_md5 or n != NFRAMES:
        raise AssertionError(f"{tag} port decode md5 {md5} ({n} frames) "
                             f"!= host {ref_md5}")
    if declines:
        if stats["frames"] or any(launches.values()):
            raise AssertionError(f"{tag} the fused chain must decline this "
                                 f"stream: {stats['frames']} frames, "
                                 f"{launches}")
        return launches
    if path == "fused":
        nf = max(1, stats["frames"])
        print(f"{tag} wire per frame: {stats['up_bytes'] / nf / 1e6:.3f} MB "
              f"up, {stats['down_bytes'] / nf / 1e6:.3f} MB down [{smi}]")
    if stats["frames"] != (NFRAMES if path == "fused" else 0):
        raise AssertionError(f"{tag} fused chain ran on {stats['frames']} "
                             f"of {NFRAMES} frames")
    # the fused chain launches no kernel with edge words; the per-stage
    # path launches ALF and CC-ALF with them only
    want = {k: which == {"fused": "plain", "stages": "edges"}[path]
            or which == "all" for k, (_, which, _, _) in KERNELS.items()}
    for k, v in launches.items():
        if (v > 0) != want[k]:
            raise AssertionError(f"{tag} kernel {k} launched {v} times in "
                                 "the decode")
    # where the time goes: one more decode with the frame pipeline off, its
    # spans summed by name (ffvvc_tpu_torch/trace.py)
    fd.reset_stats()
    dec = VVCDecoder(DecoderConfig(device="cuda", pipeline_frames=False,
                                   profile=True, **PATHS[path]))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        dec.decode(stream)
        dt = time.monotonic() - t0
    busy = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    busy_ms = sum(b[0] for b in busy) / 1e3
    n_launch = sum(b[1] for b in busy)
    print(f"{tag} serial decode: device busy {busy_ms / NFRAMES:.3f} ms "
          f"per frame of {dt / NFRAMES * 1e3:.1f} ms wall in "
          f"{n_launch / NFRAMES:.1f} kernels and copies per frame; top "
          "device work per frame: "
          + "; ".join(f"{k[:60]} x{c / NFRAMES:g} {us / NFRAMES / 1e3:.3f} ms"
                      for us, c, k in busy[:8]))
    ours = [(us, c, k) for us, c, k in busy
            if any(s in k for s in ("sao_kernel", "alf_kernel", "cc_kernel"))]
    print(f"{tag} hand kernels in the serial decode, per frame: "
          + "; ".join(f"{k[:48]} x{c / NFRAMES:g} "
                      f"{us / NFRAMES / 1e3:.4f} ms" for us, c, k in ours))
    stages = {k: round(v / NFRAMES * 1e3, 3)
              for k, v in dec.stage_times.items()}
    print(f"{tag} serial decode {NFRAMES / dt:.3f} fps; ms per frame by "
          f"stage: {json.dumps(stages)} [{smi}]")
    return launches


# ---- device MC and the inverse transform ------------------------------------

# device of the decodes and functions below ("cpu" rehearses them at a small
# size where there is no card: set DEVICE, W and H before calling them)
DEVICE = "cuda"
INTER_B = dict(seed=SEED, qp=QP, bit_depth=BD,
               sps_temporal_mvp_enabled_flag=1, sps_bdof_enabled_flag=1,
               sps_dmvr_enabled_flag=1, sps_sao_enabled_flag=1,
               sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1)
_AFFINE = dict(sps_affine_enabled_flag=1,
               sps_five_minus_max_num_subblock_merge_cand=0,
               sps_6param_affine_enabled_flag=1,
               sps_affine_prof_enabled_flag=1)
_GPM = dict(sps_gpm_enabled_flag=1,
            sps_max_num_merge_cand_minus_max_num_gpm_cand=0,
            sps_six_minus_max_num_merge_cand=1)
# the other inter tools, 3 frames of 416x240 each: name -> (forge function,
# arguments, the mc_device.stats count that must not be 0)
TOOL_STREAMS = {
    "affine_prof": ("forge_inter_stream", dict(
        slice_type=0, seed=2, **_AFFINE), "prof_blocks"),
    "sbtmvp": ("forge_inter_stream", dict(
        slice_type=0, seed=5, sps_temporal_mvp_enabled_flag=1,
        sps_sbtmvp_enabled_flag=1, **_AFFINE), "put_buckets"),
    "gpm": ("forge_inter_stream", dict(slice_type=0, seed=4, **_GPM),
            "gpm_blocks"),
    "weighted_p": ("forge_inter_stream", dict(
        slice_type=1, seed=2, sps_weighted_pred_flag=1,
        pps_kw=dict(pps_weighted_pred_flag=1)), "weighted_blocks"),
    "weighted_bi_10bit": ("forge_inter_stream", dict(
        slice_type=0, seed=1, bit_depth=10, sps_weighted_bipred_flag=1,
        pps_kw=dict(pps_weighted_bipred_flag=1)), "weighted_blocks"),
    "bcw": ("forge_inter_stream", dict(
        slice_type=0, seed=4, sps_bcw_enabled_flag=1), "weighted_blocks"),
    "wraparound": ("forge_inter_stream", dict(
        slice_type=1, seed=5, sps_ref_wraparound_enabled_flag=1,
        pps_kw=dict(pps_ref_wraparound_enabled_flag=1,
                    pps_pic_width_minus_wraparound_offset=0)), "put_buckets"),
    "lmcs_mono": ("forge_inter_stream", dict(
        slice_type=1, seed=3, bit_depth=10, sps_lmcs_enabled_flag=1,
        chroma=0), "put_buckets"),
    "dmvr_12bit": ("forge_hier_stream", dict(
        seed=2, ngops=1, bit_depth=12, sps_temporal_mvp_enabled_flag=1,
        sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1), "dmvr_subblocks"),
}


def on_both(dev, fn, arrays, *static):
    """fn(*tensors, *static) on the CPU and on `dev`; the results (a tensor
    or a tuple of them) must be equal.  Returns the result on `dev`."""
    cpu = fn(*[torch.from_numpy(a) for a in arrays], *static)
    got = fn(*[torch.from_numpy(a).to(dev) for a in arrays], *static)
    for c, g in zip(_as_list(cpu), _as_list(got)):
        if g.device.type != dev.type or not torch.equal(c, g.cpu()):
            raise AssertionError(
                f"{fn.__name__}{static} differs between cpu and {dev}: "
                f"{int((c != g.cpu()).sum())} of {c.numel()} values")
    return got


def check_functions(dev, smi):
    """Every function on tensors of ops/mc_device.py, ops/inter_device.py
    and ops/itx.py: the card's result equals the CPU's on seeded inputs."""
    rng = np.random.default_rng(SEED)
    i32 = np.int32
    ph, pw = 96, 128                  # the reference plane of the puts

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(i32)

    n = 0
    for bd in (8, 10, 12):
        plane = ints(0, 1 << bd, (ph, pw))
        for is_luma in (True, False):
            for w, h in ((4, 4), (16, 8), (64, 64)):
                B = 24
                for variant in ("plain", "wrap", "boxed"):
                    for fclass in range(4):
                        x0, y0 = ints(0, pw - 24, B), ints(0, ph - 24, B)
                        prm = np.stack([
                            ints(-8, pw + 4, B), ints(-8, ph + 4, B),
                            ints(1, 16, B) * (fclass & 1),
                            ints(1, 16, B) * (fclass >> 1),
                            x0, x0 + ints(1, 24, B), y0, y0 + ints(1, 24, B)],
                            1)
                        hf = int(rng.integers(0, 3)) if is_luma else 0
                        on_both(dev, mc_device._put_bucket, [plane, prm], w,
                                h, is_luma, bd, hf, hf, fclass,
                                pw - 16 if variant == "wrap" else 0,
                                variant == "boxed")
                        n += 1
    print(f"functions: puts equal on {dev} and cpu: {n} buckets (luma and "
          "chroma, 4 classes, plain, wraparound and boxed, origins outside "
          "the picture, 8, 10 and 12 bits)")
    check_put_kernel(dev, rng, smi)
    n = 0
    dfilt = mc_device._dmvr_filters()
    for bd in (10, 12):
        plane = ints(0, 1 << bd, (ph, pw))
        for wrap in (0, pw - 16):
            for mclass in range(4):
                B = 24
                on_both(dev, mc_device._dmvr_bilin_batch, [
                    plane, ints(-8, pw + 4, B), ints(-8, ph + 4, B),
                    dfilt[ints(1, 16, B) * (mclass & 1)],
                    dfilt[ints(1, 16, B) * (mclass >> 1)]],
                    20, 12, bd, mclass, wrap)
                n += 1
    print(f"functions: DMVR bilinear prefetch equal: {n} buckets (4 classes, "
          "10 and 12 bits, with and without wraparound)")
    n = ties = 0
    for bw, bh in ((16, 16), (16, 8), (8, 16), (8, 8)):
        B = 64
        t0 = ints(0, 1 << 10, (B, bh + 4, bw + 4))
        t1 = np.where(rng.random((B, 1, 1)) < 0.4, t0 + ints(-2, 3, (B, 1, 1)),
                      ints(0, 1 << 10, t0.shape)).astype(i32)
        t1[0] = t0[0]                        # every SAD 0: the early exit
        t1[1] = t0[1] + 40                   # 25 equal SADs, search on
        t0[2] = 512
        t1[2] = 521                          # flat pair: denom == 0
        for b, (dy, dx) in zip(range(3, 11), (
                (1, 0), (-2, 2), (0, -1), (2, 2), (-1, -2), (1, 1), (-1, 1),
                (0, 1))):
            # shifted copies: a unique minimum of 0 off the centre, and
            # sm == sc or sp == sc where a neighbour is as good
            big = ints(0, 1 << 10, (bh + 12, bw + 12))
            t0[b] = big[4 + dy:8 + dy + bh, 4 + dx:8 + dx + bw]
            t1[b] = big[4 - dy:8 - dy + bh, 4 - dx:8 - dx + bw]
        dmv, _ = on_both(dev, inter_device._dmvr_refine, [t0, t1], bw, bh)
        if not dmv[3:11].any():
            raise AssertionError("the shifted pairs were not refined")
        ties += 3
        n += B
    print(f"functions: DMVR refinement equal: {n} pairs, {ties} with every "
          "candidate tied")
    n = 0
    for bd in (8, 10, 12):
        for w, h in ((8, 8), (16, 8), (8, 16), (16, 16)):
            B = 32
            s0 = ints(-(1 << 13), 1 << 14, (B, h + 2, w + 2))
            s1 = ints(-(1 << 13), 1 << 14, (B, h + 2, w + 2))
            s1[0] = s0[0]
            s1[1] = s0[1] + 3
            s0[2] = s1[2] = 1 << 12          # flat: sgx2 == sgy2 == 0
            on_both(dev, inter_device._bdof, [s0, s1], w, h, bd)
            on_both(dev, mc_device._bdof_full_batch, [
                np.ascontiguousarray(s0[:, 1:-1, 1:-1]),
                np.ascontiguousarray(s1[:, 1:-1, 1:-1]), s0, s1], w, h, bd)
            n += 2 * B
    print(f"functions: BDOF equal: {n} blocks of 8x8 to 16x16 at 8, 10 and 12 "
          "bits, negative samples and flat blocks included")
    n = 0
    for bd in (8, 10, 12):
        B = 64
        s0 = ints(-(1 << 13), 1 << 14, (B, 8, 16))
        s1 = ints(-(1 << 13), 1 << 14, (B, 8, 16))
        par = [ints(0, 8, B)] + [ints(-128, 128, B) for _ in range(4)]
        on_both(dev, mc_device._mc_avg_batch, [s0, s1], bd)
        on_both(dev, mc_device._mc_uni_batch, [s0], bd)
        on_both(dev, mc_device._mc_gpm_batch, [s0, s1, ints(0, 9, s0.shape)],
                bd)
        on_both(dev, mc_device._mc_w_avg_batch, [s0, s1, *par], bd)
        on_both(dev, mc_device._mc_uni_w_batch, [s0, par[0], par[1], par[3]],
                bd)
        on_both(dev, mc_device._prof_apply_batch, [
            ints(-(1 << 13), 1 << 14, (B, 4, 4)),
            ints(0, 1 << bd, (B, 6, 6)) << (14 - bd),
            ints(-31, 32, (B, 4, 4)), ints(-31, 32, (B, 4, 4))], bd)
        n += 6
    print(f"functions: finals equal: {n} batches (average, uni, GPM, weighted "
          "bi and uni with negative weights and offsets, PROF) at 8, 10 and "
          "12 bits, negative samples included")
    # the inverse transform: float64 products against NumPy int64
    sizes = {itx.DCT2: (1, 2, 4, 8, 16, 32, 64), itx.DST7: (4, 8, 16, 32),
             itx.DCT8: (4, 8, 16, 32)}
    peak = (1 << 15) - 1
    n = 0
    for trh, ws in sizes.items():
        for trv, hs in sizes.items():
            for w in ws:
                for h in hs:
                    if w == h == 1:
                        continue
                    c = np.concatenate([
                        np.full((1, h, w), peak), np.full((1, h, w), -peak),
                        rng.choice([-peak, peak], (6, h, w)),
                        ints(-peak, peak + 1, (8, h, w))]).astype(i32)
                    for bd in (8, 10, 12):
                        got = on_both(dev, itx.itx_batch, [c], w, h, trh, trv,
                                      15, bd)
                        want = itx.itx_batch_host(c, w, h, trh, trv, 15, bd)
                        if not np.array_equal(got.cpu().numpy(), want):
                            raise AssertionError(
                                f"itx_batch {w}x{h} kinds {trh},{trv} at "
                                f"{bd} bits differs from the int64 version")
                        n += 1
    print(f"functions: inverse transform equal on {dev}, on cpu and in NumPy "
          f"int64: {n} buckets (DCT2, DST7, DCT8, 1xN to 64x64, coefficients "
          f"at +-{peak}, 8, 10 and 12 bits)")
    B = 64
    on_both(dev, itx.dequant_batch, [
        ints(-(1 << 15), 1 << 15, (B, 8, 16)), ints(1, (57 << 10) * 64, B),
        ints(1, 14, B)])
    cells = rng.permutation((ph // 8) * (pw // 16))[:B]
    on_both(dev, itx.scatter_residual, [
        ints(0, 1024, (ph, pw)), ints(-1500, 1500, (B, 8, 16)),
        (cells % (pw // 16) * 16).astype(i32),
        (cells // (pw // 16) * 8).astype(i32)], 16, 8, 1023)
    print("functions: dequantisation (products beyond 2^31) and residual "
          "scatter equal")
    if dev.type != "cuda":
        return
    # what the integer product costs: float64 matmul (the port's choice)
    # beside an int64 multiply and sum, on the largest and a common bucket
    for w, B in ((64, 256), (8, 8192)):
        c = torch.from_numpy(ints(-peak, peak + 1, (B, w, w))).to(dev)
        m = torch.from_numpy(itx.matrix(itx.DCT2, w).astype(np.int64)).to(dev)
        c64 = c.to(torch.int64).transpose(1, 2)

        def by_sum():
            return (c64[:, :, :, None] * m[None, None]).sum(2)
        if not torch.equal(by_sum(), itx._int_matmul(c64, m.double())):
            raise AssertionError("float64 product != int64 multiply and sum")
        print(f"functions: one pass over {B} blocks of {w}x{w}: float64 "
              f"matmul {time_ms(lambda: itx._int_matmul(c64, m.double())):.4f}"
              f" ms, int64 multiply and sum {time_ms(by_sum):.4f} ms; the "
              "whole itx_batch "
              f"{time_ms(lambda: itx.itx_batch(c, w, w, 0, 0, 15, BD)):.4f} "
              f"ms [{smi}]")


def check_put_kernel(dev, rng, smi):
    """The put kernel (csrc/mc.cu, through mc_device.put_table) against its
    plain twin on the CPU, torch.equal: one table of every variant
    (`put_inputs`: 4 classes, luma and chroma, 2x2 to 128x128, PROF and
    BDOF rings, wraparound, boxes past the plane, blocks over each border)
    on W x H planes at 8, 10 and 12 bits, and each part a mesh of three
    tiles would launch; synchronised after every launch."""
    n = rows = 0
    for bd in (8, 10, 12):
        planes, buckets = put_inputs(rng, H, W, bd)
        table, _ = mc_device.put_table_of(buckets)
        cpu = [torch.from_numpy(p) for p in planes]
        on = [p.to(dev) for p in cpu]
        k = len(table.jobs)
        for lo, hi in ((0, k), (0, k // 3), (k // 3, 2 * k // 3),
                       (2 * k // 3, k)):
            part = table if (lo, hi) == (0, k) else table.part(lo, hi)
            got = mc_device.put_table(on, part, bd)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            want = mc_device.put_table(cpu, part, bd)
            if got.device.type != dev.type or not torch.equal(got.cpu(),
                                                               want):
                bad = (got.cpu() != want).nonzero()[:5].flatten().tolist()
                raise AssertionError(
                    f"put kernel at {bd} bits, rows [{lo}, {hi}) differs "
                    f"from its twin at outputs {bad}")
            n += 1
            rows += len(part.jobs)
    print(f"functions: put kernel equal to its twin on {dev}: {n} launches "
          f"of {rows} rows ({len(buckets)} buckets a table: 4 classes, luma "
          "and chroma, 2x2 to 128x128, PROF and BDOF rings, wraparound, "
          f"boxes, blocks over every border) on {W}x{H} planes at 8, 10 and "
          f"12 bits [{smi}]")


def put_bytes(table):
    """Bytes one launch of the put kernel moves: the table up, each row's
    window of 16-bit samples (read once a row) and its int32 outputs."""
    j = table.jobs
    size = np.repeat(np.array([r[:2] for r in table.runs]),
                     [r[3] for r in table.runs], axis=0).astype(np.int64)
    ext = np.where((j[:, 3] >> 16) & 1, 7, 3)
    fc = (j[:, 3] >> 17) & 3
    win = (size[:, 0] + (fc & 1) * ext) * (size[:, 1] + (fc >> 1) * ext)
    words = mc_device.PLANE_COLS * (int((j[:, 3] & 0xFFFF).max()) + 1) + \
        mc_device.CLASS_COLS * len(table.runs) + j.size
    return 4 * words + 2 * int(win.sum()) + 4 * table.n_out


def time_put_table(label, planes, table, bd, smi):
    """One captured put table replayed on the card: the kernel's device us
    a launch (a CUDA graph of its launches), its bytes and their bound at
    PEAK_BYTES_S, the whole wrapper (pack, upload, launch, with the host),
    and the plain twin on the same tensors; the kernel's output equals
    the twin's."""
    dev = planes[0].device
    classes, blocks, smem = table.layout()
    tab = torch.from_numpy(table.packed(planes, classes)).to(dev)
    out = torch.empty(table.n_out, dtype=torch.int32, device=dev)
    args = mc_device.put_args(tab, len(planes), classes, blocks, smem, out,
                              bd)
    us = graph_ms([lambda: _build.check(_build.lib().ffvvc_mc_put(
        *args, stream_of(dev)), "ffvvc_mc_put")]) * 1e3
    want = mc_device.put_table_ref(planes, table, bd)
    if not torch.equal(out, want):
        raise AssertionError(f"put kernel on the {label} table differs "
                             "from its twin")
    call = time_ms(lambda: mc_device.put_table(planes, table, bd))
    plain = time_ms(lambda: mc_device.put_table_ref(planes, table, bd), n=3)
    nbytes = put_bytes(table)
    groups = len(np.unique(table.jobs[:, 3:5], axis=0))
    print(f"[inter-b] put kernel, {label}: {len(table.jobs)} rows, "
          f"{len(table.runs)} sizes, >= {groups} buckets, {blocks} CUDA "
          f"blocks, {smem} B shared a block; device {us:.2f} us a launch, "
          f"{nbytes / 1e6:.3f} MB, bound {nbytes / PEAK_BYTES_S * 1e6:.2f} "
          f"us at 3.35 TB/s ({nbytes / PEAK_BYTES_S * 1e8 / us:.1f}%); the "
          f"wrapper (pack, upload, launch) {call:.3f} ms; the plain twin "
          f"{plain:.2f} ms [{smi}]")
    return us


class PutLog:
    """Records the put table of every frame_device_mc call of a decode (its
    planes, table and bit depth) and counts the eager per-bucket puts."""

    def __enter__(self):
        self.tables, self.eager = [], 0
        self.orig = mc_device._put_sharded, mc_device._put_bucket

        def put(planes, table, mesh, bd):
            self.tables.append((planes, table, bd))
            return self.orig[0](planes, table, mesh, bd)

        def bucket(*a):
            self.eager += 1
            return self.orig[1](*a)
        mc_device._put_sharded, mc_device._put_bucket = put, bucket
        return self

    def __exit__(self, *exc):
        mc_device._put_sharded, mc_device._put_bucket = self.orig


def forge_hier_alf(seed, width, height, qp, bit_depth, **sps_kw):
    """The forge's hierarchical GOP (forge_hier_stream with one GOP: an IDR,
    a P frame at POC 2 and a B frame at POC 1 between them, whose one past
    and one future reference at equal distances arm DMVR and BDOF), with
    ALF and CC-ALF switched on in every slice as forge_inter_stream does
    it: forge_hier_stream itself sets their SPS flags only, sends no APS,
    and its decode never reaches ALF.  No LMCS: in 4:2:0 it brings chroma
    residual scaling, which takes the slice off the native path that
    device_mc serves."""
    from ffvvc_tpu_torch.tools import forge as F
    sps_r = F.build_sps(width, height, bit_depth=bit_depth, min_qt_log2=2,
                        max_mtt_depth=2, **sps_kw)
    pps_r = F.build_pps(sps_r)
    stream = F.write_nal(F.NalType.SPS, F.write_sps(sps_r))
    stream += F.write_nal(F.NalType.PPS, F.write_pps(pps_r, sps_r))
    policy = F.FuzzPolicy(seed)
    ccalf = bool(sps_r.sps_ccalf_enabled_flag)
    alf_aps = F.make_alf_aps(policy.rng, chroma=True, ccalf=ccalf)
    stream += F.write_nal(F.NalType.PREFIX_APS, F.write_aps(alf_aps))
    idr = None
    for poc, slice_type, deltas in ((0, F.SLICE_I, None),
                                    (2, F.SLICE_P, ([-2], [])),
                                    (1, F.SLICE_B, ([-1], [1]))):
        nal, shim = F.forge_frame(
            sps_r, pps_r, policy, qp=qp, poc=poc, idr=poc == 0,
            slice_type=slice_type, ref_deltas=deltas, collocated=idr,
            alf_aps=alf_aps, ccalf=ccalf)
        stream += nal
        idr = idr or shim
    return stream


def forge_cached(fn, **kw):
    """A stream of the port's forge (`fn` names one of its functions, or is
    one of this script's), cached in the temp directory."""
    from ffvvc_tpu_torch.tools import forge
    name, fn = (fn, getattr(forge, fn)) if isinstance(fn, str) else \
        (fn.__name__, fn)
    key = hashlib.sha256(repr((name, sorted(kw.items()))).encode()
                         ).hexdigest()[:16]
    cache = os.path.join(tempfile.gettempdir(), f"ffvvc_smoke_{key}.bit")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return f.read()
    t0 = time.monotonic()
    stream = fn(**kw)
    print(f"forged {name} {kw.get('width')}x{kw.get('height')}: {len(stream)} "
          f"bytes in {time.monotonic() - t0:.1f} s")
    with open(cache + ".tmp", "wb") as f:
        f.write(stream)
    os.replace(cache + ".tmp", cache)
    return stream


class McLog:
    """Records every frame_device_mc call of a decode: what it added to
    mc_device.stats, its seconds, and the picture it predicted."""

    def __enter__(self):
        self.calls, self.orig = [], mc_device.frame_device_mc

        def spy(jobs, sps, bd, device="cuda", mesh=None):
            before = dict(mc_device.stats, put_class=None)
            kernel = mc_device.put_table.launches
            t0 = time.perf_counter()
            self.orig(jobs, sps, bd, device=device, mesh=mesh)
            dt = time.perf_counter() - t0
            delta = {k: v - before[k] for k, v in mc_device.stats.items()
                     if k != "put_class"}
            delta["put_kernel_launches"] = \
                mc_device.put_table.launches - kernel
            self.calls.append((id(jobs[0][0].fb), dt, delta))
        mc_device.frame_device_mc = spy
        return self

    def __exit__(self, *exc):
        mc_device.frame_device_mc = self.orig

    def frames(self):
        """Per predicted picture, in decode order: (calls, seconds, sums)."""
        out = {}
        for fb, dt, delta in self.calls:
            n, secs, total = out.get(fb, (0, 0.0, {}))
            out[fb] = (n + 1, secs + dt,
                       {k: total.get(k, 0) + v for k, v in delta.items()})
        return list(out.values())


class LatePixels(concurrent.futures.ThreadPoolExecutor):
    """A pixel thread for the decoder that starts every job `delay` seconds
    late: a host whose pixel stages are still running when the next frame
    has been parsed, as in the benchmark's cells.  Device MC then waits for
    each reference as a whole, and still makes one call per frame."""

    def __init__(self, delay):
        super().__init__(max_workers=1, thread_name_prefix="ffvvc-pixels")
        self.delay = delay

    def submit(self, fn):
        def late():
            time.sleep(self.delay)
            return fn()
        return super().submit(late)


def mc_decode(tag, stream, ref_md5, host_mc, smi, n_inter, late_pixels=0.0,
              keep=None, **toggles):
    """One decode through device_mc on DEVICE, checked against the host
    decode's md5; prints what the device MC did per inter frame, beside
    `host_mc`, the ms the host C MC takes for one, and its phases' ms from
    the decode's spans.  Every inter frame must be one frame_device_mc
    call; on the card every call's puts must go through one launch of the
    put kernel and none through the eager per-bucket path.  Appends the
    put tables to `keep` when given.  Returns the mc_device.stats of the
    decode."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    mc_device.reset_stats()
    fd.reset_stats()
    dec = VVCDecoder(DecoderConfig(device=DEVICE, device_mc=True,
                                   profile=True, **toggles))
    if late_pixels:
        dec._pix_exec = LatePixels(late_pixels)
    trace.clear()
    kernel = mc_device.put_table.launches
    with McLog() as log, PutLog() as puts:
        t0 = time.monotonic()
        frames = dec.decode(stream)
        dt = time.monotonic() - t0
    kernel = mc_device.put_table.launches - kernel
    if keep is not None:
        keep += puts.tables
    phases = {}             # decode sequence number -> {phase: seconds}
    for sp in trace.spans():
        if sp.name.startswith("mc."):
            ph = phases.setdefault(sp.seq, {})
            ph[sp.name[3:]] = ph.get(sp.name[3:], 0.0) + sp.wall_ns * 1e-9
    trace.clear()
    if late_pixels:
        dec._pix_exec.shutdown()
    md5, n = yuv_md5(frames)
    stats = dict(mc_device.stats)
    print(f"{tag} device_mc decode {json.dumps(toggles)}: {n} frames in "
          f"{dt:.3f} s" + (f" with every pixel job started {late_pixels} s "
                           "late" if late_pixels else f" = {n / dt:.3f} fps")
          + f", md5 {md5} [{smi}]")
    if md5 != ref_md5:
        raise AssertionError(f"{tag} device_mc decode md5 {md5} != host "
                             f"{ref_md5}")
    print(f"{tag} put kernel: {kernel} launches for "
          f"{stats['calls']} frame_device_mc calls ({len(puts.tables)} put "
          f"tables), {puts.eager} eager per-bucket puts")
    # (a call whose blocks are all intra or CIIP has no puts)
    if DEVICE == "cuda" and (
            kernel != len(puts.tables) or
            not 0 < len(puts.tables) <= stats["calls"] or puts.eager):
        raise AssertionError(f"{tag} puts did not all go through one "
                             "kernel launch a call")
    per_frame = log.frames()
    if len(per_frame) != n_inter or stats["calls"] != n_inter:
        raise AssertionError(f"{tag} device MC ran on {len(per_frame)} of "
                             f"{n_inter} inter frames in {stats['calls']} "
                             "calls")
    for i, ((calls, secs, d), seq) in enumerate(zip(per_frame,
                                                    sorted(phases))):
        shares = {k: round(v * 1e3, 1) for k, v in phases[seq].items()}
        print(f"{tag} inter frame {i}: {calls} frame_device_mc calls, "
              f"{d['descriptors']} descriptors, {d['put_buckets']} put "
              f"buckets of {d['put_blocks']} blocks, {d['bilin_buckets']} "
              f"prefetch buckets, {d['dmvr_subblocks']} DMVR subblocks, "
              f"{d['bdof_blocks']} BDOF blocks, {d['prof_blocks']} PROF "
              f"blocks, {d['finals_buckets']} finals buckets, "
              f"{d['launches']} batched calls ({d['put_kernel_launches']} "
              f"of the put kernel), {d['up_bytes'] / 1e6:.3f} MB "
              f"up, {d['down_bytes'] / 1e6:.3f} MB down, {secs * 1e3:.1f} ms "
              f"in the MC stage (host C MC {host_mc:.1f} ms): "
              f"{json.dumps(shares)} [{smi}]")
    return stats


def inter_b(smi):
    """The slice at full width: the 1080p10 hierarchical stream on the
    host, through device_mc alone and through device_mc with the fused
    chain.  Returns the hand kernels' launch counts of the last."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    tag = "[inter-b]"
    stream = forge_cached(forge_hier_alf, width=W, height=H, **INTER_B)
    # the host reference, serial and timed per stage: every toggle off
    dec = VVCDecoder(DecoderConfig(device=DEVICE, pipeline_frames=False,
                                   profile=True))
    t0 = time.monotonic()
    ref_md5, n = yuv_md5(dec.decode(stream))
    dt = time.monotonic() - t0
    n_inter = n - 1
    host_mc = dec.stage_times["mc.host"] / n_inter * 1e3
    print(f"{tag} host decode, serial: {n} frames in {dt:.3f} s, md5 "
          f"{ref_md5}; host C MC {host_mc:.1f} ms per inter frame on "
          f"{os.cpu_count()} cores; ms per frame by stage: "
          + json.dumps({k: round(v / n * 1e3, 1)
                        for k, v in dec.stage_times.items()}))
    if n != 3:
        raise AssertionError(f"{tag} host decode gave {n} frames")
    md5_pipelined, _ = yuv_md5(VVCDecoder(DecoderConfig(device=DEVICE)).decode(
        stream))
    if md5_pipelined != ref_md5:
        raise AssertionError(f"{tag} the host decode differs from itself")
    # device_mc alone, as configured by default, then with the references
    # still in flight when the next frame's MC runs: one call a frame both
    mc_decode(tag + "[default]", stream, ref_md5, host_mc, smi, n_inter)
    mc_decode(tag + "[late]", stream, ref_md5, host_mc, smi, n_inter,
              late_pixels=1.0)
    # device_mc with the fused chain, the hand kernels on the same frames:
    # counts from zero just before, read just after
    wholes = []
    reset_launches()
    stats = mc_decode(tag + "[mc+fused]", stream, ref_md5, host_mc, smi,
                      n_inter, device_pipeline=True, keep=wholes)
    launches = {k: fn.launches - fn.edge_launches
                for k, (fn, which, _, _) in KERNELS.items()
                if which != "edges" and "/" not in k}
    print(f"{tag}[mc+fused] hand-kernel launches: {json.dumps(launches)}; "
          f"fused chain ran on {fd.stats['frames']} of {n} frames; put "
          f"buckets by class (copy, h, v, hv): {stats['put_class']}")
    if fd.stats["frames"] != n or \
            (DEVICE == "cuda" and not all(launches.values())):
        raise AssertionError(f"{tag}[mc+fused]: fused on "
                             f"{fd.stats['frames']} frames, launches "
                             f"{launches}")
    if not (all(stats["put_class"]) and stats["dmvr_subblocks"]
            and stats["bdof_blocks"]):
        raise AssertionError(f"{tag} a put class, DMVR or BDOF never ran: "
                             f"{stats}")
    if DEVICE == "cuda":
        # the largest whole frame's table and a small one (its first ninth
        # of rows), replayed: the kernel's device time beside its bound and
        # the twin
        planes, table, bd = max(wholes, key=lambda t: len(t[1].jobs))
        time_put_table(f"whole frame (largest of {len(wholes)})", planes,
                       table, bd, smi)
        time_put_table("small table (the first ninth of its rows)", planes,
                       table.part(0, len(table.jobs) // 9), bd, smi)
    del wholes
    # the three toggles together: the IDR through device intra, the P and B
    # frames through device MC, the fused chain on all three
    idv.reset_stats()
    mc_decode(tag + "[intra+mc+fused]", stream, ref_md5, host_mc, smi,
              n_inter, device_pipeline=True, device_intra=True)
    print(f"{tag}[intra+mc+fused] device intra on {idv.stats['frames']} "
          f"frame ({idv.stats['units']} units, {idv.stats['queue_s']:.3f} s "
          f"of queueing), fused chain on {fd.stats['frames']} of {n} frames")
    if idv.stats["frames"] != 1 or fd.stats["frames"] != n:
        raise AssertionError(f"{tag}[intra+mc+fused] device intra on "
                             f"{idv.stats['frames']} frames, fused chain on "
                             f"{fd.stats['frames']}")
    # where the MC stage's time goes: device_mc alone, serial, under the
    # profiler
    mc_device.reset_stats()
    dec = VVCDecoder(DecoderConfig(device=DEVICE, device_mc=True,
                                   pipeline_frames=False, profile=True))
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dec.decode(stream)
        busy = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()), reverse=True)
        print(f"{tag}[mc] serial decode: device busy "
              f"{sum(b[0] for b in busy) / n_inter / 1e3:.3f} ms per inter "
              f"frame in {sum(b[1] for b in busy) / n_inter:.0f} kernels and "
              "copies; top device work per inter frame: "
              + "; ".join(f"{k[:48]} x{c / n_inter:g} "
                          f"{us / n_inter / 1e3:.3f} ms"
                          for us, c, k in busy[:6]))
    else:
        dec.decode(stream)
    st = mc_device.stats
    print(f"{tag}[mc] serial decode: MC stage "
          f"{dec.stage_times['mc'] / n_inter * 1e3:.1f} ms per inter "
          f"frame (host C MC {host_mc:.1f} ms); ms per inter frame: "
          + json.dumps({k[3:]: round(v / n_inter * 1e3, 1)
                        for k, v in dec.stage_times.items()
                        if k.startswith("mc.")})
          + f"; {st['up_bytes'] / n_inter / 1e6:.3f} MB up, "
          f"{st['down_bytes'] / n_inter / 1e6:.3f} MB down, "
          f"{st['launches'] / n_inter:.0f} batched calls per inter frame "
          f"[{smi}]")
    return launches


def inter_tools(smi):
    """The other inter tools at 416x240 through device_mc, and the
    golden-parse decode through the batched inverse transform."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    for name, (fn, kw, engaged) in TOOL_STREAMS.items():
        if fn == "forge_inter_stream":
            kw = dict(kw, nframes=3)
        stream = forge_cached(fn, width=416, height=240, deblock=True, **kw)
        ref_md5, n = yuv_md5(VVCDecoder(DecoderConfig(device=DEVICE)).decode(
            stream))
        mc_device.reset_stats()
        md5, _ = yuv_md5(VVCDecoder(DecoderConfig(
            device=DEVICE, device_mc=True)).decode(stream))
        st = mc_device.stats
        print(f"[tools/{name}] {n} frames of 416x240 through device_mc: md5 "
              f"{md5}; {st['calls']} calls, {st['descriptors']} descriptors, "
              f"{st['put_buckets']} put buckets, {engaged} {st[engaged]}")
        if md5 != ref_md5 or n != 3 or not st[engaged]:
            raise AssertionError(f"[tools/{name}] md5 {md5} != host "
                                 f"{ref_md5}, or {engaged} is 0")
    stream = forge_cached("forge_inter_stream", width=416, height=240,
                          slice_type=0, nframes=2, seed=7, deblock=True,
                          bit_depth=10, sps_sao_enabled_flag=1)
    ref_md5, n = yuv_md5(VVCDecoder(DecoderConfig(device=DEVICE)).decode(
        stream))
    os.environ["FFVVC_ITX"] = "device"
    itx.reset_stats()
    t0 = time.monotonic()
    md5, _ = yuv_md5(VVCDecoder(DecoderConfig(
        device=DEVICE, native_parse=False)).decode(stream))
    st = itx.stats
    print(f"[itx] {n} frames of 416x240, golden parse, FFVVC_ITX=device: md5 "
          f"{md5} in {time.monotonic() - t0:.1f} s; {st['buckets']} buckets "
          f"of {st['tbs']} transform blocks on {st['frames']} frames, "
          f"{st['up_bytes'] / 1e6:.3f} MB up and down [{smi}]")
    if md5 != ref_md5 or not st["buckets"]:
        raise AssertionError(f"[itx] md5 {md5} != host {ref_md5}, or no "
                             "bucket was launched")


# ---- device intra -----------------------------------------------------------

_CCLM = dict(sps_cclm_enabled_flag=1)
# the small all-intra streams: the 14 cases of tests/test_device_intra.py and
# a 4:2:0 stream whose chroma is not vertically collocated (CCLM variant 0,
# which none of the 14 has), each through the port's forge: name -> (forge
# function, arguments)
INTRA_CASES = {
    "basic": ("forge_stream", dict(level=0, seed=0, width=128, height=96,
                                   qp=30)),
    "fuzz": ("forge_stream", dict(level=1, seed=3, width=128, height=96,
                                  qp=28, bit_depth=10)),
    "tools10": ("forge_tools_stream", dict(seed=0, width=128, height=128,
                                           qp=30)),
    "cclm": ("forge_tools_stream", dict(seed=2, width=128, height=96, qp=30,
                                        **_CCLM)),
    "cclm_coll": ("forge_tools_stream", dict(
        seed=3, width=128, height=96, qp=30,
        sps_chroma_vertical_collocated_flag=1, **_CCLM)),
    "dualtree": ("forge_tools_stream", dict(seed=4, width=128, height=128,
                                            qp=30, dual_tree=True, **_CCLM)),
    "ts_bdpcm": ("forge_ts_stream", dict(seed=0, width=96, height=64, qp=30,
                                         bdpcm=True)),
    "tiled": ("forge_tiled_stream", dict(seed=0, width=96, height=96,
                                         qp=32)),
    "subpic": ("forge_subpic_stream", dict(seed=0, width=128, height=64,
                                           qp=30)),
    "wpp": ("forge_tools_stream", dict(
        seed=5, width=256, height=192, qp=30,
        sps_entropy_coding_sync_enabled_flag=1)),
    "mono": ("forge_tools_stream", dict(seed=6, width=128, height=96, qp=30,
                                        chroma=0)),
    "12bit": ("forge_tools_stream", dict(seed=7, width=96, height=96, qp=30,
                                         bit_depth=12)),
    "422": ("forge_tools_stream", dict(seed=8, width=128, height=96, qp=30,
                                       chroma=2, **_CCLM)),
    "444": ("forge_tools_stream", dict(seed=9, width=128, height=96, qp=30,
                                       chroma=3, **_CCLM)),
    "cclm_noncoll": ("forge_tools_stream", dict(
        seed=2, width=128, height=96, qp=30,
        sps_chroma_vertical_collocated_flag=0, **_CCLM)),
}
INTRA_FAMILIES = ("k_simple_g", "k_angular_g", "k_mip_g", "k_cclm_p")


class IntraLog:
    """Records every frame_device_intra call of a decode: whether it took
    the frame, what it added to intra_device.stats and its seconds.  With
    `profile`, the first call runs under the profiler: the device busy time
    and the kernels and copies of one frame's intra stage."""

    def __init__(self, profile=False):
        self.profile = profile and DEVICE == "cuda"

    def __enter__(self):
        self.calls, self.orig, self.busy = [], idv.frame_device_intra, None

        def spy(*args, **kw):
            before = dict(idv.stats)
            t0 = time.perf_counter()
            if self.profile and not self.calls:
                from torch.profiler import ProfilerActivity, profile
                profile(activities=[ProfilerActivity.CUDA]).start()
                t0 = time.perf_counter()
                ok = self.orig(*args, **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                # stopped through the C API, which hands back the raw
                # events: the profile object's own stop and key_averages()
                # turn the 3 million kernels and copies a 1080p frame
                # queues into Python objects, which took over 6 minutes on
                # the card's machine
                ev = [e for e in torch._C._autograd._disable_profiler()
                      .events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA]
                self.busy = (sum(e.duration_ns() for e in ev) / 1e6,
                             len(ev))
            else:
                ok = self.orig(*args, **kw)
                dt = time.perf_counter() - t0
            self.calls.append((ok, dt, {k: idv.stats[k] - before[k]
                                        for k in before
                                        if k != "last_plan_s"}))
            print(f"[intra] frame_device_intra call {len(self.calls) - 1}: "
                  f"{dt:.3f} s", flush=True)
            return ok
        idv.frame_device_intra = spy
        return self

    def __exit__(self, *exc):
        idv.frame_device_intra = self.orig

    def report(self, tag, host_recon_ms, smi):
        """One line per frame: sizes, host seconds by section, bytes, the
        stage's ms beside the host C recon's."""
        for i, (ok, dt, d) in enumerate(self.calls):
            ms = {k[:-2]: round(d[k] * 1e3, 1) for k in (
                "walk_s", "build_s", "cclm_s", "residual_s", "queue_s",
                "download_s")}
            prof = ""
            if i == 0 and self.busy is not None:
                prof = (f"; under the profiler: device busy "
                        f"{self.busy[0]:.3f} ms in {self.busy[1]} kernels "
                        "and copies")
            print(f"{tag} frame {i}: {d['units']} units in {d['waves']} "
                  f"waves; buckets simple {d['simple_buckets']}, angular "
                  f"{d['angular_buckets']}, MIP {d['mip_buckets']}, CCLM "
                  f"{d['cclm_buckets']} ({d['cclm_units']} CCLM units); ms "
                  f"{json.dumps(ms)}; {d['up_bytes'] / 1e6:.3f} MB up, "
                  f"{d['down_bytes'] / 1e6:.3f} MB down; device intra stage "
                  f"{dt * 1e3:.1f} ms (host C recon {host_recon_ms:.1f} ms)"
                  f"{prof} [{smi}]")


class IntraBuckets:
    """Records the inputs of the intra bucket functions during a decode:
    CPU copies taken before each call (the functions write into the plane
    in place), at most `per_key` buckets of each family and static
    arguments."""

    def __init__(self, per_key=2):
        self.per_key = per_key

    def __enter__(self):
        self.buckets, self.seen = [], {}
        self.orig = {n: getattr(idv, n) for n in INTRA_FAMILIES}

        def wrap(name, fn):
            def call(*args):
                # the tensors but the gather plans (a tuple), which the
                # replay builds again from the geo rows
                static = tuple(a for a in args
                               if not isinstance(a, (torch.Tensor, tuple)))
                n = self.seen.get((name, static), 0)
                if n < self.per_key:
                    self.seen[name, static] = n + 1
                    self.buckets.append((name, [
                        a.cpu().clone() for a in args
                        if isinstance(a, torch.Tensor)], static))
                return fn(*args)
            return call
        for name, fn in self.orig.items():
            setattr(idv, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(idv, name, fn)


def host_serial(stream):
    """The host decode, serial and timed per stage: (md5, frames, ms of the
    host C recon per frame)."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    dec = VVCDecoder(DecoderConfig(device=DEVICE, pipeline_frames=False,
                                   profile=True))
    md5, n = yuv_md5(dec.decode(stream))
    return md5, n, dec.stage_times["recon"] / n * 1e3


def _side_index_range(geo, w, h, is_h):
    """Least and greatest index of the angular PDPC side gather before its
    clamp."""
    wp_max = h if is_h else w
    sscale = 256 + geo[:, idv.G_INV, None].long() * \
        (torch.arange(wp_max) + 1)
    idx = idv.PAD + (sscale >> 9)
    return int(idx.min()), int(idx.max()) + (w if is_h else h) - 1


def replay_intra(dev, buckets):
    """Every captured bucket once on the CPU and once on `dev`, each on
    its own copy of the inputs: torch.equal.  Then a bucket whose units
    without PDPC carry nscale -3 (no decode has one: the planner gives them
    0), the same way.  Returns what the buckets covered."""
    seen = {"angular": set(), "mip": set(), "cclm": set(), "bd": set(),
            "outside": 0}
    negative = None
    def run(name, arrays, static, on):
        t = [a.to(on, copy=True) for a in arrays]
        if name != "k_cclm_p":     # the gather plans of the geo rows
            t.append(idv._edge_idx(t[2], static[2]))
        return getattr(idv, name)(*t, *static)

    for name, arrays, static in buckets:
        want = run(name, arrays, static, "cpu")
        got = run(name, arrays, static, dev)
        if got.device.type != dev.type or not torch.equal(want, got.cpu()):
            raise AssertionError(
                f"{name}{static} differs between cpu and {dev}: "
                f"{int((want != got.cpu()).sum())} of {want.numel()} values")
        if name == "k_angular_g":
            w, h, _W, _bd, is_h, is_luma = static
            seen["angular"].add((is_h, is_luma))
            lo, hi = _side_index_range(arrays[2], w, h, is_h)
            seen["outside"] += lo < 0 or hi >= idv.NREF
            if negative is None and (arrays[2][:, idv.G_PDPC] == 0).any():
                negative = (arrays, static)
        elif name == "k_mip_g":
            seen["mip"].add(static[4])
        elif name == "k_cclm_p":
            seen["cclm"].add(static[5])
        seen["bd"].add(static[4] if name == "k_cclm_p" else static[3])
    arrays, static = negative
    geo = arrays[2].clone()
    geo[geo[:, idv.G_PDPC] == 0, idv.G_NSCALE] = -3
    arrays = arrays[:2] + [geo]
    want = run("k_angular_g", arrays, static, "cpu")
    got = run("k_angular_g", arrays, static, dev)
    if not torch.equal(want, got.cpu()):
        raise AssertionError("an angular bucket with negative nscale "
                             f"differs between cpu and {dev}")
    return seen


def intra_small(dev, smi):
    """A one-frame 64x64 intra stream to warm the allocator, then the small
    intra streams through device_intra, each md5-equal to its host decode,
    with the buckets captured and replayed on the CPU and on the card."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    cfg = DecoderConfig(device=DEVICE, device_intra=True)
    warm = forge_cached("forge_inter_stream", slice_type=2, nframes=1,
                        width=64, height=64, seed=0)
    t0 = time.monotonic()
    md5, _ = yuv_md5(VVCDecoder(cfg).decode(warm))
    print(f"[intra/warm-up] 64x64 intra frame through device_intra in "
          f"{time.monotonic() - t0:.3f} s")
    if md5 != yuv_md5(VVCDecoder(DecoderConfig(device=DEVICE)).decode(
            warm))[0]:
        raise AssertionError("[intra/warm-up] md5 differs from the host")
    with IntraBuckets() as cap:
        for name, (fn, kw) in INTRA_CASES.items():
            stream = forge_cached(fn, **kw)
            ref_md5, n = yuv_md5(VVCDecoder(DecoderConfig(
                device=DEVICE)).decode(stream))
            idv.reset_stats()
            t0 = time.monotonic()
            md5, _ = yuv_md5(VVCDecoder(cfg).decode(stream))
            st = idv.stats
            print(f"[intra/{name}] {n} frames of {kw['width']}x"
                  f"{kw['height']} through device_intra in "
                  f"{time.monotonic() - t0:.2f} s: md5 {md5}; "
                  f"{st['frames']} frames on the device, {st['units']} "
                  f"units, buckets simple {st['simple_buckets']}, angular "
                  f"{st['angular_buckets']}, MIP {st['mip_buckets']}, CCLM "
                  f"{st['cclm_buckets']}")
            if md5 != ref_md5 or st["frames"] != n or st["declined"]:
                raise AssertionError(f"[intra/{name}] md5 {md5} != host "
                                     f"{ref_md5}, or {st['frames']} of {n} "
                                     "frames on the device")
    seen = replay_intra(dev, cap.buckets)
    print(f"functions: intra buckets equal on {dev} and cpu: "
          f"{len(cap.buckets)} buckets of the small streams (angular "
          f"(is_h, is_luma) {sorted(seen['angular'])}, MIP size ids "
          f"{sorted(seen['mip'])}, CCLM variants {sorted(seen['cclm'])}, "
          f"bit depths {sorted(seen['bd'])}; {seen['outside']} angular "
          "buckets whose PDPC side gather runs outside the reference array "
          "in thrown-away lanes) and one angular bucket with negative "
          "nscale on its units without PDPC")
    if (len(seen["angular"]) != 4 or seen["mip"] != {0, 1, 2}
            or seen["cclm"] != {0, 1, 2, 3} or not seen["outside"]):
        raise AssertionError(f"the intra buckets missed a variant: {seen}")


def intra_main(smi, stream, ref_md5):
    """The main path: `c-recon` through device_intra with the fused chain,
    counts from zero just before the decode and read just after.  Serial
    (frame pipeline off), so that the profiler runs on the thread that
    started CUDA: frame 0 under it, frame 1 not.  (inter-b runs device
    intra on the pixel thread.)  Returns the hand kernels' launch
    counts."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    tag = "[c-recon/intra+fused]"
    _, _, host_recon = host_serial(stream)
    cfg = DecoderConfig(device=DEVICE, device_intra=True,
                        device_pipeline=True, pipeline_frames=False)
    idv.reset_stats()
    fd.reset_stats()
    reset_launches()
    with IntraLog(profile=True) as log:
        t0 = time.monotonic()
        frames = VVCDecoder(cfg).decode(stream)
        dt = time.monotonic() - t0
    launches = launch_counts()
    md5, n = yuv_md5(frames)
    st = idv.stats
    print(f"{tag} {n} frames in {dt:.3f} s (frame 0 under the profiler), "
          f"md5 {md5}; intra on the device on {st['frames']} frames, fused "
          f"chain on {fd.stats['frames']}; hand-kernel launches "
          f"{json.dumps(launches)} [{smi}]")
    log.report(tag, host_recon, smi)
    if md5 != ref_md5 or n != NFRAMES:
        raise AssertionError(f"{tag} md5 {md5} ({n} frames) != host "
                             f"{ref_md5}")
    if st["frames"] != NFRAMES or st["declined"] or not (
            st["simple_buckets"] and st["angular_buckets"]):
        raise AssertionError(f"{tag} device intra: {st}")
    # the fused chain launches every kernel but those with edge words
    if fd.stats["frames"] != NFRAMES or (DEVICE == "cuda" and not all(
            v for k, v in launches.items() if KERNELS[k][1] != "edges")):
        raise AssertionError(f"{tag} fused chain on {fd.stats['frames']} "
                             f"frames, launches {launches}")
    return launches


def intra_tools_kw():
    """The forge arguments of `intra-tools`."""
    return dict(seed=SEED, width=W, height=H, qp=QP, bit_depth=BD,
                nframes=1, sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1, **_CCLM)


def intra_tools(smi):
    """bench.py's device-leg stream (forge_tools_stream with the SPS flags
    of SAO, ALF, CC-ALF and LMCS) with CCLM on, at 1080p10, cut to one
    frame (a frame's device intra stage takes about a minute on the card's
    machine), through device_intra alone, serial: every family, md5-equal
    to the host decode.  (Only `c-recon`'s first frame runs under the
    profiler: reading the events of a 1080p device-intra frame takes about
    90 s.)"""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    tag = "[intra-tools]"
    stream = forge_cached("forge_tools_stream", **intra_tools_kw())
    ref_md5, n, host_recon = host_serial(stream)
    idv.reset_stats()
    with IntraLog() as log:
        t0 = time.monotonic()
        md5, _ = yuv_md5(VVCDecoder(DecoderConfig(
            device=DEVICE, device_intra=True,
            pipeline_frames=False)).decode(stream))
        dt = time.monotonic() - t0
    st = idv.stats
    print(f"{tag} {n} frames through device_intra in {dt:.3f} s, md5 {md5} "
          f"(host {ref_md5}) [{smi}]")
    log.report(tag, host_recon, smi)
    if md5 != ref_md5 or st["frames"] != n or st["declined"] or not all(
            st[k] for k in ("simple_buckets", "angular_buckets",
                            "mip_buckets", "cclm_buckets")):
        raise AssertionError(f"{tag} md5 {md5} != host {ref_md5}, or a "
                             f"family never ran: {st}")


# ---- the mesh and the GOP workers -------------------------------------------

def launch_counts():
    """{kernel of KERNELS: its wrapper's launches of its variant}."""
    return {k: {"all": fn.launches, "edges": fn.edge_launches,
                "plain": fn.launches - fn.edge_launches}[which]
            for k, (fn, which, _, _) in KERNELS.items()}


def reset_launches():
    for fn, *_ in KERNELS.values():
        fn.launches = fn.edge_launches = 0     # SAO has no edge variant
        fn.launches_by_device = {}


# the four wrappers, by the name of the kernel each launches
WRAPPERS = {k: fn for k, (fn, *_) in KERNELS.items() if "/" not in k}


def launches_by_card():
    """{wrapper name: {card index: launches}}."""
    return {k: dict(sorted(fn.launches_by_device.items()))
            for k, fn in WRAPPERS.items()}


def check_slab_launches(dev):
    """One slab-origin launch of each kernel and variant at the 1080p10
    shapes, against the same rows of a whole-picture launch (torch.equal):
    the second slab of the mesh's (1, 2) cut (luma from row 540, chroma
    from 270: not on the CTB grid), with the halo parallel/filters.py
    gives it."""
    rng = np.random.default_rng(SEED)
    pix_max, half = (1 << BD) - 1, 1 << (BD - 1)
    hc, wc, cc = H // 2, W // 2, CTB // 2
    cuts = PF.frame_cuts(H, hc, 2, 1, 3)
    r0, c0 = cuts[0].hs, cuts[1].hs

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def slab(row0, pic_h, halo):
        return Slab(row0, pic_h - row0, pic_h, halo)

    def same(name, whole, part, row0):
        for w_, p in zip(_as_list(whole), _as_list(part)):
            if not torch.equal(w_[row0:], p):
                raise AssertionError(f"slab launch of {name} differs from "
                                     "the whole picture's rows")
        print(f"kernel {name}: the slab from row {row0} equals the whole "
              "picture's rows")
    shapes = ((H, W, CTB, CTB, BD), (hc, wc, cc, cc, BD), (hc, wc, cc, cc, BD))
    sizes = [(CTB, CTB), (cc, cc), (cc, cc)]
    for name, ins in (
            ("sao", [(x, sao_device.pack_params(p, *sh[:4])) for (x, p), sh
                     in zip([sao_inputs(rng, *sh) for sh in shapes],
                            shapes)]),
            ("sao/restore", [sao_restore_inputs(rng, *sh) for sh in shapes])):
        planes, prms = [t(x) for x, _ in ins], [t(p) for _, p in ins]
        rows = (r0, c0, c0)
        whole = sao_device.sao_apply(planes, prms, sizes, BD - 5, pix_max)
        part = sao_device.sao_apply(
            [x[r - PF.SAO_HALO:] for x, r in zip(planes, rows)], prms, sizes,
            BD - 5, pix_max, [slab(r, x.shape[0], PF.SAO_HALO)
                              for x, r in zip(planes, rows)])
        for w_, p, r in zip(whole, part, rows):
            same(name, w_, p, r)
    src, ci, ti, ctb_set, cf, cl = (t(a) for a in
                                    alf_luma_inputs(rng, H, W, CTB, BD))
    edges = t(edge_words(rng, *ctb_set.shape))
    for name, e in (("alf_luma", None), ("alf_luma/edges", edges)):
        rest = (ctb_set, cf, cl, CTB, pix_max, e)
        same(name, alf_device.alf_filter_luma(src, ci, ti, *rest),
             alf_device.alf_filter_luma(
                 src[r0 - PF.ALF_LUMA_HALO:], ci[r0 >> 2:], ti[r0 >> 2:],
                 *rest, slab(r0, H, PF.ALF_LUMA_HALO)), r0)
    ins = [[t(a) for a in alf_chroma_inputs(rng, hc, wc, cc, cc, BD)]
           for _ in range(2)]
    edges = t(edge_words(rng, *ins[0][1].shape))
    for name, e in (("alf_chroma", None), ("alf_chroma/edges", edges)):
        rest = tuple([x[k] for x in ins] for k in (1, 2, 3)) + \
            (cc, cc, pix_max, e)
        same(name, alf_device.alf_filter_chroma([x[0] for x in ins], *rest),
             alf_device.alf_filter_chroma(
                 [x[0][c0 - PF.ALF_CHROMA_HALO:] for x in ins], *rest,
                 slab(c0, hc, PF.ALF_CHROMA_HALO)), c0)
    dsts, luma, sets, tabs = cc_inputs(rng, hc, wc, CTB, 1, 1, BD)
    dsts, sets, tabs = ([t(a) for a in x] for x in (dsts, sets, tabs))
    luma = t(luma)
    for name, e in (("cc_alf", None), ("cc_alf/edges", edges)):
        rest = (sets, tabs, cc, cc, 1, 1, half, pix_max, e)
        same(name, alf_device.cc_filter(dsts, luma, *rest),
             alf_device.cc_filter(
                 [d[c0:] for d in dsts], luma[r0 - PF.CC_LUMA_HALO:], *rest,
                 slab(c0, hc, 0), slab(r0, H, PF.CC_LUMA_HALO)), c0)


class MeshLog:
    """Records the drains of the mesh's queue: (frames queued, frames
    asked for, or None for all)."""

    def __enter__(self):
        self.drains, self.orig = [], PF.MeshFilterQueue.drain

        def spy(queue, needed=None):
            if queue.q:
                self.drains.append((len(queue.q), None if needed is None
                                    else sum(e["fb"] in needed
                                             for e in queue.q)))
            return self.orig(queue, needed)
        PF.MeshFilterQueue.drain = spy
        return self

    def __exit__(self, *exc):
        PF.MeshFilterQueue.drain = self.orig


def one_card(mesh_shape):
    """The explicit device list of the one-card form of a mesh: card 0
    (or DEVICE where there is no card) at every position."""
    g, t = mesh_shape
    return ("cuda:0" if DEVICE == "cuda" else DEVICE,) * (g * t)


def mesh_decode(label, stream, ref_md5, mesh_shape, smi, devices=None,
                **toggles):
    """One warm-up decode on a mesh of `mesh_shape` over `devices`
    (`DecoderConfig.mesh_devices`; None: the visible cards), as decode()
    warms up the per-stage path, then the timed decode: counts from zero
    just before it and read just after, checked against the host decode's
    md5.  Returns what the timed decode counted: launches (of KERNELS and
    by card), drains, sharded puts, bytes of reference plane sent to each
    other card, frames, seconds."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    g, t = mesh_shape
    where = "visible cards" if devices is None else ",".join(devices)
    tag = f"[{label}/mesh {g}x{t} on {where}]"
    cfg = DecoderConfig(device=DEVICE, mesh_shape=mesh_shape,
                        mesh_devices=devices, **toggles)
    VVCDecoder(cfg).decode(stream)                 # warm-up
    reset_launches()
    before = mc_device.sharded_puts
    mc_device.sharded_ref_bytes.clear()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    with MeshLog() as log:
        t0 = time.monotonic()
        md5, n = yuv_md5(VVCDecoder(cfg).decode(stream))
        dt = time.monotonic() - t0
    out = dict(launches=launch_counts(), by_card=launches_by_card(),
               drains=log.drains, sharded=mc_device.sharded_puts - before,
               ref_bytes=dict(mc_device.sharded_ref_bytes), frames=n,
               seconds=dt, ms=dt / n * 1e3)
    print(f"{tag} {json.dumps(toggles)} {n} frames in {dt:.3f} s = "
          f"{out['ms']:.1f} ms per frame (warm), md5 {md5}; drains "
          f"(queued, landed of them or all): {log.drains}; hand-kernel "
          f"launches {json.dumps(out['launches'])}, by card "
          f"{json.dumps(out['by_card'])} [{smi}]")
    if md5 != ref_md5:
        raise AssertionError(f"{tag} md5 {md5} != host {ref_md5}")
    return out


def mesh_phase(smi, streams, refs):
    """The mesh on one card (every position on card 0, an explicit list):
    slab launches against whole-picture ones, then three decodes.  Returns
    the hand kernels' launch counts on the mesh path (of `c-recon` for the
    kernels the summary counts on the main path, of `across-off` for those
    it counts on `across-off`) and, for the mesh-cards phase, each decode's
    (label, shape, toggles, stream, host md5, ms a frame)."""
    if DEVICE == "cuda":
        check_slab_launches(torch.device(DEVICE, 0))
    stream = forge_cached(forge_hier_alf, width=W, height=H, **INTER_B)
    ref_md5, _ = yuv_md5(host_frames(stream))
    # c-recon on a (2, 2) mesh: both frames in one drain over the gop axis;
    # across-off on (1, 2): restore regions and edge words on slabs;
    # inter-b on (1, 2) with device_mc: puts over the tile axis, drains of
    # the referenced frames only at the reference barrier
    cases = (("c-recon", (2, 2), {}, streams["c-recon"], refs["c-recon"]),
             ("across-off", (1, 2), {}, streams["across-off"],
              refs["across-off"]),
             ("inter-b", (1, 2), {"device_mc": True}, stream, ref_md5))
    done, runs = [], {}
    for label, shape, toggles, st, ref in cases:
        runs[label] = r = mesh_decode(label, st, ref, shape, smi,
                                      one_card(shape), **toggles)
        done.append((label, shape, toggles, st, ref, r["ms"]))
    if (2, None) not in runs["c-recon"]["drains"]:
        raise AssertionError(f"[c-recon/mesh] no drain over a gop of 2: "
                             f"{runs['c-recon']['drains']}")
    r = runs["inter-b"]
    selective = [d for d in r["drains"] if d[1] is not None]
    print(f"[inter-b/mesh 1x2] sharded puts {r['sharded']}; selective drains "
          f"{selective}")
    if not r["sharded"] or not any(d[1] for d in selective):
        raise AssertionError(f"[inter-b/mesh] sharded puts {r['sharded']}, "
                             f"drains {r['drains']}")
    if DEVICE == "cuda" and not all(
            v for k, v in r["launches"].items() if KERNELS[k][1] != "edges"):
        raise AssertionError(f"[inter-b/mesh] launches {r['launches']}")
    out = {k: runs["c-recon" if KERNELS[k][3] == MAIN else
                   "across-off"]["launches"][k] for k in KERNELS}
    if DEVICE == "cuda" and not all(out.values()):
        raise AssertionError(f"a kernel never launched on the mesh: {out}")
    return out, done


def mesh_cards(smi, done):
    """The mesh across cards: the decodes of the mesh phase again with
    `mesh_devices` left to its default, the visible cards, one a mesh
    position: `across-off` and `inter-b` at (1, 2) where two or more are
    visible, also `c-recon` at (2, 2) where four are.  First, on each card
    past the first (card 0 stays current), one slab launch of each kernel
    against its whole-picture launch.  Each decode must equal its host
    decode, launch every kernel on every card of its mesh and, with
    device_mc, split its puts over the cards; its ms a frame stand beside
    the one-card form's, with the bytes of reference plane each card
    received and the peer access of each pair of cards."""
    tag = "[mesh-cards]"
    n = torch.cuda.device_count() if DEVICE == "cuda" else 1
    peers = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
             for a in range(n) for b in range(n) if a != b}
    print(f"{tag} {n} card(s) visible; peer access {json.dumps(peers)} "
          f"[{smi}]")
    if n < 2:
        print(f"{tag} one card is visible: the cross-card decodes did not "
              "run")
        return
    every = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True, timeout=60).stdout
    print(f"{tag} cards: " + "; ".join(every.strip().splitlines()))
    for k in range(1, n):
        check_slab_launches(torch.device("cuda", k))
    for label, shape, toggles, stream, ref_md5, one_ms in done:
        g, t = shape
        if g * t > n:
            print(f"{tag} {label} at {shape} needs {g * t} cards: not run")
            continue
        r = mesh_decode(label, stream, ref_md5, shape, smi, **toggles)
        if g > 1 and (g, None) not in r["drains"]:
            raise AssertionError(f"{tag} {label}: no drain over a gop of "
                                 f"{g}: {r['drains']}")
        cards = list(range(g * t))
        missing = {k: [c for c in cards if not by.get(c)]
                   for k, by in r["by_card"].items()}
        per_frame = {d: round(b / r["frames"]) for d, b in
                     sorted(r["ref_bytes"].items())}
        print(f"{tag} {label} at {shape} on cuda:0-{g * t - 1}: "
              f"{r['ms']:.1f} ms a frame, one card {one_ms:.1f} ms a frame; "
              f"sharded puts {r['sharded']}, bytes of reference plane sent "
              f"to each other card {json.dumps(r['ref_bytes'])} in "
              f"{r['frames']} frames, {json.dumps(per_frame)} a frame "
              f"[{smi}, {n} cards]")
        if any(missing.values()):
            raise AssertionError(f"{tag} {label}: a kernel never launched "
                                 f"on a card of the mesh: {missing}")
        if toggles.get("device_mc") and not (
                r["sharded"] and set(r["ref_bytes"]) ==
                {f"cuda:{c}" for c in range(1, t)}):
            raise AssertionError(f"{tag} {label}: puts not split over the "
                                 f"cards: {r['sharded']}, "
                                 f"{r['ref_bytes']}")


def host_frames(stream):
    """The host decode (every device toggle off) of DEVICE's config."""
    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder
    return VVCDecoder(DecoderConfig(device=DEVICE)).decode(stream)


def scaling_kw():
    """The forge arguments of the GOP workers' stream: multi-IDR, one
    segment a frame, SAO on."""
    return dict(seed=SEED, width=W, height=H, qp=QP, bit_depth=BD, nframes=3,
                sps_sao_enabled_flag=1)


def _segment_launches_path(idx):
    return os.path.join(tempfile.gettempdir(),
                        f"chip_smoke_seg_{os.getpid()}_{idx}.json")


def _counted_segment(args):
    """pipeline._decode_segment in a worker, with the SAO kernel's
    launches of that segment written beside its result (the counts of a
    worker stay in its process): the proof that the device ran there."""
    sao_device.sao_apply.launches = 0
    out = _decode_segment(args)
    with open(_segment_launches_path(args[0]), "w") as fh:
        json.dump({"pid": os.getpid(), "segment": args[0],
                   "sao_launches": sao_device.sao_apply.launches}, fh)
    return out


def _segment_launches():
    """The records _counted_segment left, read and removed."""
    import glob
    out = []
    for p in glob.glob(os.path.join(tempfile.gettempdir(),
                                    "chip_smoke_seg_*.json")):
        with open(p) as fh:
            out.append(json.load(fh))
        os.unlink(p)
    return sorted(out, key=lambda r: r["segment"])


def gop_workers(smi):
    """decode_parallel with 3 workers and device_sao on DEVICE: the pool
    must be spawned on the card, every segment must launch the SAO kernel
    in its worker, and the YUV must equal the sequential host decode."""
    from ffvvc_tpu_torch import DecoderConfig, pipeline
    tag = "[gop-workers]"
    stream = forge_cached("forge_scaling_stream", **scaling_kw())
    segments = pipeline.segment_stream(stream)
    t0 = time.monotonic()
    want = [f.to_yuv_bytes() for f in host_frames(stream)]
    seq = time.monotonic() - t0
    cfg = DecoderConfig(device=DEVICE, device_sao=True)
    method = pipeline._start_method(cfg)
    _segment_launches()
    # the workers run _counted_segment, which calls the original
    orig = pipeline._decode_segment
    pipeline._decode_segment = _counted_segment
    try:
        t0 = time.monotonic()
        got = pipeline.decode_parallel(stream, workers=3, config=cfg)
        par = time.monotonic() - t0
        pools = list(pipeline._POOLS)
    finally:
        pipeline._decode_segment = orig
        for pool in pipeline._POOLS.values():
            pool.terminate()
            pool.join()
        pipeline._POOLS.clear()
    runs = _segment_launches()
    md5 = hashlib.md5(b"".join(got)).hexdigest()
    ref = hashlib.md5(b"".join(want)).hexdigest()
    print(f"{tag} {len(segments)} segments, {len(got)} frames of {W}x{H}: "
          f"decode_parallel(workers=3, device_sao) {par:.3f} s through a "
          f"{method!r} pool {pools}, md5 {md5}; sequential host decode "
          f"{seq:.3f} s, md5 {ref}; SAO kernel launches in the workers "
          f"{json.dumps(runs)} [{smi}]")
    if md5 != ref or len(segments) != 3 or pools != [(3, method)] or (
            DEVICE == "cuda" and method != "spawn"):
        raise AssertionError(f"{tag} md5 {md5} != {ref}, {len(segments)} "
                             f"segments, pools {pools}")
    if [r["segment"] for r in runs] != [0, 1, 2] or (DEVICE == "cuda" and (
            not all(r["sao_launches"] for r in runs)
            or os.getpid() in {r["pid"] for r in runs})):
        raise AssertionError(f"{tag} the SAO kernel did not launch in "
                             f"every worker: {runs}")


def _forge_job(name):
    """Forge one of the 1080p streams into the temp-directory cache (runs
    in a worker process of prefetch_streams)."""
    if name in STREAMS:
        forge_stream(**STREAMS[name])
    elif name == "inter-b":
        forge_cached(forge_hier_alf, width=W, height=H, **INTER_B)
    elif name == "gop-workers":
        forge_cached("forge_scaling_stream", **scaling_kw())
    else:
        forge_cached("forge_tools_stream", **intra_tools_kw())


def prefetch_streams():
    """The six 1080p streams, forged at once in worker processes (the
    forge is single-threaded Python, about a minute a stream on the card's
    machine); the phases then find them in the cache."""
    import multiprocessing
    names = list(STREAMS) + ["inter-b", "intra-tools", "gop-workers"]
    t0 = time.monotonic()
    with concurrent.futures.ProcessPoolExecutor(
            len(names), mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        list(pool.map(_forge_job, names))
    print(f"forged {len(names)} streams in {time.monotonic() - t0:.1f} s, "
          "one process each")


class Phases:
    """Runs the phases of main(), printing each one's seconds."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        self.seconds[name] = round(time.monotonic() - t0, 1)
        print(f"phase {name}: {self.seconds[name]} s", flush=True)
        return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    environment()
    smi = card()
    print(f"nvidia-smi: {smi}")
    phase = Phases()
    phase("forge", prefetch_streams)
    phase("build", build)
    summary = phase("kernels", check_kernels, dev, smi)

    def decodes():
        launches, streams, refs = {}, {}, {}
        for label, path in DECODES:
            if label not in streams:
                streams[label] = forge_stream(**STREAMS[label])
                refs[label] = host_decode(label, streams[label])
            launches[label, path] = decode(label, path, streams[label],
                                           refs[label], smi)
        return launches, streams, refs
    launches, streams, refs = phase("decodes", decodes)
    phase("functions", check_functions, dev, smi)
    for k, n in phase("inter-b", inter_b, smi).items():
        summary[k]["launches_inter_b"] = n
    phase("inter-tools", inter_tools, smi)
    phase("intra-small", intra_small, dev, smi)
    for k, n in phase("intra-main", intra_main, smi, streams["c-recon"],
                      refs["c-recon"]).items():
        summary[k]["launches_intra"] = n
    mesh, done = phase("mesh", mesh_phase, smi, streams, refs)
    for k, n in mesh.items():
        summary[k]["launches_mesh"] = n
    phase("mesh-cards", mesh_cards, smi, done)
    phase("gop-workers", gop_workers, smi)
    phase("intra-tools", intra_tools, smi)
    for k in summary:
        summary[k]["launches"] = launches[KERNELS[k][3]][k]
        if summary[k]["launches"] <= 0:
            raise AssertionError(f"kernel {k} never launched on its path")
    foreign = [m for m in sys.modules
               if m == "ffvvc_tpu" or m.startswith("ffvvc_tpu.")
               or m.split(".")[0] in ("jax", "jaxlib")]
    if foreign:
        raise AssertionError(f"the run loaded {foreign}")
    print("no module of ffvvc_tpu, jax or jaxlib was loaded")
    print(f"phase seconds: {json.dumps(phase.seconds)}; total "
          f"{time.monotonic() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": list(summary.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
