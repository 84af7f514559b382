"""What `correct` compares against: the frozen reference's decode of the
forged segments, kept as digests.

Each segment is decoded by `vvcref` (plain NumPy, no native code, nothing
of the port) in its own spawned process; a segment whose frames are all
intra is decoded a frame at a time, each frame with the segment's
parameter sets, since no frame of it reads another.  A record per output
frame holds its POC, the MD5 of each plane and the least time of the hand
kernels' work on it (`roofline.frame_work`), read from the reference's
own parse.
"""
from __future__ import annotations

import copy
import hashlib
import os

import numpy as np

from . import roofline


def plane_digests(planes):
    """MD5 of each plane's samples as little-endian int32, raster order."""
    return [hashlib.md5(np.ascontiguousarray(p, dtype="<i4")).hexdigest()
            for p in planes]


def _distinct(a, on):
    return len(np.unique(a[on])) if on.any() else 0


def frame_record(frame):
    """The record of one output frame of `vvcref`."""
    sps, tabs = frame.buffer.sps, frame.tabs
    h, w = frame.buffer.planes[0].shape
    on0 = tabs.alf_ctb_flag[:, 0] != 0
    luma_set = np.where(tabs.alf_fixed != 0, tabs.alf_filt_idx,
                        16 + tabs.alf_aps_id[:, 0])
    least = roofline.frame_work(
        h, w, sps.ctb_size_y, sps.hshift[1], sps.vshift[1], tabs.sao_type,
        tabs.alf_ctb_flag, _distinct(luma_set, on0),
        [_distinct(tabs.alf_alt_idx[:, c - 1], tabs.alf_ctb_flag[:, c] != 0)
         for c in (1, 2)],
        tabs.alf_cc_idc)
    return {"poc": frame.poc, "md5": plane_digests(frame.buffer.planes),
            "least_s": least}


def syntax_gaps(want, got, path=""):
    """The fields that the forge's builders set in `want` and that the
    reader gave back otherwise in `got` (trees of syntax objects, lists
    and numbers)."""
    if want is None:                  # left out by the builder: not coded
        return []
    if hasattr(want, "__dict__"):
        return [g for k, v in vars(want).items()
                for g in syntax_gaps(v, getattr(got, k, None), f"{path}.{k}")]
    if isinstance(want, np.ndarray):
        want = want.tolist()
    if isinstance(got, np.ndarray):
        got = got.tolist()
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) < len(want):
            return [path]
        return [g for i, v in enumerate(want)
                for g in syntax_gaps(v, got[i], f"{path}[{i}]")]
    return [] if want == got else [path]


def parameter_set_gaps(head, config, traffic, seed, segment, size=None):
    """Where the reference's reading of a segment's SPS, PPS and APSs
    departs from what the forge's builders put into them.  The port parses
    parameter sets with the code `vvcref` froze, so a fault there would
    read correct against the reference alone; the builders' own objects are
    the second witness."""
    from vvcref.bitstream import split_annexb, BitReader, NalType
    from vvcref.bitstream.h266 import (H266ParamSets, read_sps, read_pps,
                                       read_aps)
    from . import segments
    sps_r, pps_r = segments._param_sets(config, traffic, size)
    want = [sps_r, pps_r] + [a for a in segments._apss(config, sps_r, seed,
                                                       segment) if a]
    ps, got = H266ParamSets(), []
    for nal in split_annexb(head):
        r, t = BitReader(nal.rbsp), nal.nal_unit_type
        if t == NalType.SPS:
            got.append(read_sps(r))
            ps.store_sps(got[-1])
        elif t == NalType.PPS:
            got.append(read_pps(r, ps))
        elif t in (NalType.PREFIX_APS, NalType.SUFFIX_APS):
            got.append(read_aps(r))
    return syntax_gaps([_signed(w) for w in want], [_signed(g) for g in got])


def _signed(aps):
    """A copy of a syntax object whose coefficient signs are 0 where the
    magnitude is 0 (such a sign is not coded)."""
    out = copy.copy(aps)
    for k, v in vars(aps).items():
        if k.endswith("_coeff_sign"):
            mag = np.asarray(getattr(aps, k[:-len("sign")] + "abs", None) or
                             getattr(aps, k.replace("_coeff_sign",
                                                    "_mapped_coeff_abs")))
            setattr(out, k, np.where(mag[..., :np.shape(v)[-1]] != 0,
                                     np.asarray(v), 0).tolist())
    return out


def decode_records(data):
    from vvcref.decoder import VVCDecoder
    return [frame_record(f) for f in VVCDecoder().decode(data)]


def groups(traffic):
    """Frame indices decoded together: each frame alone where every frame
    of the segment is intra, else the whole segment."""
    frames = traffic["frames"]
    if all(f["slice"] == "I" for f in frames):
        return [[i] for i in range(len(frames))]
    return [list(range(len(frames)))]


def _job(args):
    s, data = args
    return s, decode_records(data)


def run(segments, traffic, processes=None):
    """Records of every segment, in output order: a list a segment."""
    from .segments import pool
    jobs = [(s, head + b"".join(frames[i] for i in g))
            for s, (head, frames) in enumerate(segments)
            for g in groups(traffic)]
    out = [[] for _ in segments]
    if processes == 1:
        done = map(_job, jobs)
        for s, recs in done:
            out[s].extend(recs)
    else:
        with pool(min(len(jobs), processes or os.cpu_count() or 1)) as ex:
            for s, recs in ex.map(_job, jobs):
                out[s].extend(recs)
    if len(groups(traffic)) > 1:
        # frames decoded alone: an all-intra segment outputs in POC order
        for recs in out:
            recs.sort(key=lambda r: r["poc"])
    return out
