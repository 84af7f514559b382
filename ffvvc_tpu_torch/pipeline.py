"""GOP-parallel host decode (SURVEY §2.3 P1).

The reference scales decode across a 16-deep in-flight frame pipeline
(libavcodec/vvc/vvcdec.c:830-841 submit/wait and
vvc_thread.c).  The TPU-native equivalent splits the bitstream at IDR
access units into independent segments (RAPs are natural shard boundaries,
SURVEY §5 checkpoint/resume) and decodes them on parallel host worker
processes — the same axis that shards GOPs across hosts in a pod.

Only raw byte ranges are inspected here (NAL type = byte 1 >> 3 after the
start code; the first RBSP bit of a VCL unit is
sh_picture_header_in_slice_header_flag) — no header parsing, so splitting
is O(bytes) and workers re-parse only their own segment plus the
accumulated parameter-set prefix.
"""
from __future__ import annotations

import multiprocessing
import os
import tempfile

from .bitstream.nal import NalType, is_idr, is_vcl
from .config import DecoderConfig

_START = b"\x00\x00\x01"
_PARAM_TYPES = {NalType.OPI, NalType.DCI, NalType.VPS, NalType.SPS,
                NalType.PPS, NalType.PREFIX_APS, NalType.SUFFIX_APS}


def _iter_units(data: bytes):
    """Yield (chunk_bytes, nal_type, first_rbsp_bit) per Annex-B unit.
    Chunk boundaries sit before each start code (including the zero byte of
    a 4-byte code), so concatenating all chunks reproduces the stream."""
    starts = []
    i = data.find(_START)
    while i != -1:
        starts.append((i - 1 if i > 0 and data[i - 1] == 0 else i, i + 3))
        i = data.find(_START, i + 3)
    for n, (s, p) in enumerate(starts):
        end = starts[n + 1][0] if n + 1 < len(starts) else len(data)
        begin = 0 if n == 0 else s   # fold any leading_zero_8bits into unit 0
        t = data[p + 1] >> 3 if p + 1 < end else 0
        fb = (data[p + 2] >> 7) & 1 if p + 2 < end else 0
        yield data[begin:end], t, fb


def segment_stream(data: bytes):
    """Split into independently decodable segments, each beginning at an IDR
    access unit, paired with the parameter-set prefix active at its start.

    Returns [(prefix_bytes, segment_bytes)]; a stream with no mid-stream IDR
    yields a single segment.
    """
    params = bytearray()     # accumulated parameter-set NALs, stream order
    segments = []            # [prefix_bytes, bytearray]
    cur = None               # current segment buffer
    pending = bytearray()    # PH/SEI awaiting the next AU's first slice
    in_au = False            # between an AU's first slice and its end
    seg_has_vcl = False

    def start_segment(prefix: bytes):
        nonlocal cur, seg_has_vcl
        segments.append([prefix, bytearray()])
        cur = segments[-1][1]
        seg_has_vcl = False

    for chunk, t, fb in _iter_units(data):
        if cur is None:
            start_segment(b"")
        if t in _PARAM_TYPES:
            params.extend(chunk)
            cur.extend(chunk)
            continue
        if t == NalType.PH:
            in_au = False
            pending.extend(chunk)
            continue
        if is_vcl(t):
            new_au = (not in_au) or fb == 1
            if new_au:
                if is_idr(t) and seg_has_vcl:
                    start_segment(bytes(params))
                cur.extend(pending)
                pending.clear()
                in_au = True
            cur.extend(chunk)
            seg_has_vcl = True
            continue
        # other non-VCL (SEI/AUD/EOS/...): keep with the AU in flight, or
        # buffer for the next one
        if in_au:
            cur.extend(chunk)
        else:
            pending.extend(chunk)
    if pending and cur is not None:
        cur.extend(pending)
    return [(p, bytes(b)) for p, b in segments]


def _decode_segment(args):
    idx, blob, config, oversub = args
    # workers stay off the device: host itx only (no XLA calls after fork)
    os.environ["FFVVC_ITX"] = "host"
    import dataclasses
    # when the worker pool already saturates the cores, in-worker frame
    # pipelining only oversubscribes (2 threads per worker; measured ~14%
    # slower on the RA bench at workers == cores) — keep it for the
    # many-core case where each worker owns >1 core
    config = dataclasses.replace(
        config, stage_threads=1,
        pipeline_frames=config.pipeline_frames and not oversub)
    from .decoder import VVCDecoder
    frames = VVCDecoder(config).decode(blob)
    # ship pixels via the temp dir, not the pool result pipe: a 1080p10
    # frame is ~6 MB and pickling tens of MB through the queue costs ~20%
    # of a short decode's wall clock
    path = os.path.join(tempfile.gettempdir(),
                        f"ffvvc_seg_{os.getpid()}_{idx}.yuv")
    try:
        sizes = []
        with open(path, "wb") as fh:
            for f in frames:
                b = f.to_yuv_bytes()
                sizes.append(len(b))
                fh.write(b)
                f.recycle()     # planes back to the pool for the next job
        return idx, (path, sizes)
    except OSError:
        out = []
        for f in frames:
            out.append(f.to_yuv_bytes())
            f.recycle()
        return idx, out


def _collect_yuvs(result):
    """Worker result -> list of per-frame YUV bytes."""
    if isinstance(result, tuple):
        path, sizes = result
        with open(path, "rb") as fh:
            data = fh.read()
        os.unlink(path)
        out = []
        pos = 0
        for n in sizes:
            out.append(data[pos:pos + n])
            pos += n
        return out
    return result


def decode_parallel(data: bytes, workers: int = None,
                    config: DecoderConfig = None, force_pool: bool = False):
    """Decode Annex-B bytes with GOP-parallel worker processes; returns the
    YUV bytes of every frame in output order.  Falls back to in-process
    decode when the stream has a single segment or workers <= 1
    (force_pool=True keeps the pool + shm transport even at workers=1 —
    matched machinery for scaling measurements)."""
    from .decoder import VVCDecoder
    config = config or DecoderConfig()
    if workers is None:
        workers = os.cpu_count() or 1
    segments = segment_stream(data)
    if (workers <= 1 and not force_pool) or len(segments) <= 1:
        out = []
        for f in VVCDecoder(config).decode(data):
            out.append(f.to_yuv_bytes())
            f.recycle()
        return out
    n_workers = min(max(workers, 1), len(segments))
    oversub = n_workers * 2 > (os.cpu_count() or 1)
    jobs = [(i, prefix + seg, config, oversub)
            for i, (prefix, seg) in enumerate(segments)]
    pool = _get_pool(n_workers, _start_method(config))
    results = pool.map(_decode_segment, jobs, chunksize=1)
    out = []
    for _idx, res in sorted(results):
        out.extend(_collect_yuvs(res))
    return out


_POOLS = {}

# toggles that put a pixel stage on `config.device`
_DEVICE_TOGGLES = ("device_pipeline", "device_sao", "device_alf",
                   "device_deblock", "device_lmcs", "device_mc",
                   "device_intra")


def _start_method(config: DecoderConfig) -> str:
    """"spawn" when the config puts a stage on a CUDA device (a child forked
    after its parent initialised CUDA cannot use CUDA), else "fork".  The
    decoder's own predicates: a mesh runs on devices of `config.device`'s
    type whatever the backend, a device toggle only under backend "cuda"."""
    import torch
    if torch.device(config.device).type != "cuda":
        return "fork"
    g, t = config.mesh_shape
    toggles = config.backend == "cuda" and any(
        getattr(config, k) for k in _DEVICE_TOGGLES)
    return "spawn" if g * t > 1 or toggles else "fork"


def _get_pool(workers: int, method: str = "fork"):
    """Persistent worker pool per worker count and start method (frame
    pipeline stays warm across decode calls, like the reference's
    long-lived executor threads, executor.c:135-166).

    Plain fork (warm COW state) unless a stage runs on CUDA; the child-side
    thread pools are fork-safe via the pid-keyed executor cache
    (threads.py)."""
    pool = _POOLS.get((workers, method))
    if pool is None:
        ctx = multiprocessing.get_context(method)
        pool = ctx.Pool(workers)
        _POOLS[(workers, method)] = pool
    return pool
