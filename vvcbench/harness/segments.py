"""The traffic generator: coded segments forged from a seed.

A segment is one Annex-B stream that starts at an IDR: the parameter sets,
the APSs of the configuration's tools, then the frames the traffic mix
lists, in decode order.  Every segment of every seed has the same shapes,
tools and frame structure; only the syntax drawn inside the frames differs.
Each frame is forged by the frozen forge (`vvcref.forge.forge_frame`) with
its own random stream, derived from (seed, segment, frame), so the frames
of all segments forge in parallel processes; a frame whose collocated
picture is an inter frame forges after it in the same process.
"""
from __future__ import annotations

import hashlib
import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor

SLICE_TYPES = {"B": 0, "P": 1, "I": 2}


def derive_seed(*parts) -> int:
    """A 64-bit seed from any parts (the run's seed may be any integer)."""
    d = hashlib.sha256(":".join(map(str, parts)).encode()).digest()
    return int.from_bytes(d[:8], "little")


def geometry(config, size=None):
    """(width, height) of the coded pictures: the configuration's, or
    `size` where a test shrinks them."""
    return tuple(size) if size else (config["width"], config["height"])


def _param_sets(config, traffic, size):
    """(sps_r, pps_r) of the segment, as the forge's builders make them."""
    from vvcref import forge as F
    w, h = geometry(config, size)
    sps_r = F.build_sps(w, h, bit_depth=config["bit_depth"],
                        ctu_log2=config["ctu_log2"],
                        min_qt_log2=config["min_qt_log2"],
                        max_mtt_depth=config["max_mtt_depth"],
                        **config["sps"])
    pps_kw = {"lf_across_tiles": traffic["lf_across_tiles"],
              "lf_across_slices": traffic["lf_across_slices"]}
    cols = traffic["tile_columns"]
    if cols == 1:
        if not (pps_kw["lf_across_tiles"] and pps_kw["lf_across_slices"]):
            raise ValueError("one tile filters across everything")
        return sps_r, F.build_pps(sps_r)
    # tile columns: the forge's picture-header form (forge_inter_stream,
    # info_in_ph=True), one raster slice over the tile grid
    pps_kw.update(pps_rpl_info_in_ph_flag=1, pps_sao_info_in_ph_flag=1,
                  pps_alf_info_in_ph_flag=1, pps_qp_delta_info_in_ph_flag=1,
                  pps_deblocking_filter_control_present_flag=1,
                  pps_deblocking_filter_override_enabled_flag=1,
                  pps_dbf_info_in_ph_flag=1)
    sps_r.sps_entry_point_offsets_present_flag = 1
    ctu = 1 << config["ctu_log2"]
    w_ctu, h_ctu = -(-w // ctu), -(-h // ctu)
    widths = [w_ctu // cols + (i < w_ctu % cols) for i in range(cols)]
    return sps_r, F.build_tiled_pps(sps_r, widths, (h_ctu,), **pps_kw)


def _apss(config, sps_r, seed, segment):
    """(alf_aps, lmcs_aps) of a segment, drawn from its own stream."""
    from vvcref import forge as F
    rng = random.Random(derive_seed(seed, segment, "aps"))
    alf = lmcs = None
    if sps_r.sps_alf_enabled_flag:
        alf = F.make_alf_aps(rng, chroma=True,
                             ccalf=bool(sps_r.sps_ccalf_enabled_flag))
    if sps_r.sps_lmcs_enabled_flag:
        lmcs = F.make_lmcs_aps(rng, chroma=True,
                               bit_depth=config["bit_depth"])
    return alf, lmcs


def header(config, traffic, seed, segment, size=None) -> bytes:
    """SPS, PPS and the APSs that open a segment."""
    from vvcref import forge as F
    sps_r, pps_r = _param_sets(config, traffic, size)
    out = F.write_nal(F.NalType.SPS, F.write_sps(sps_r))
    out += F.write_nal(F.NalType.PPS, F.write_pps(pps_r, sps_r))
    for aps in _apss(config, sps_r, seed, segment):
        if aps is not None:
            out += F.write_nal(F.NalType.PREFIX_APS, F.write_aps(aps))
    return out


def forge_groups(traffic):
    """Frame indices forged together: a frame joins the group of its
    collocated picture where that picture is an inter frame."""
    frames = traffic["frames"]
    by_poc = {f["poc"]: i for i, f in enumerate(frames)}
    group_of, groups = {}, []
    for i, f in enumerate(frames):
        col = f.get("collocated")
        j = by_poc.get(col) if col is not None else None
        if j is not None and frames[j]["slice"] != "I":
            group_of[i] = group_of[j]
            groups[group_of[i]].append(i)
        else:
            group_of[i] = len(groups)
            groups.append([i])
    return groups


def _intra_shim(sps_r, pps_r, poc):
    """The collocated view of an intra picture: every 4x4 intra, so TMVP
    finds nothing there, as the forge's own shim of such a frame says."""
    from vvcref import forge as F
    from vvcref.bitstream import BitReader
    ps0 = F.H266ParamSets()
    sps_raw = F.read_sps(BitReader(F.write_sps(sps_r)))
    ps0.store_sps(sps_raw)
    pps_raw = F.read_pps(BitReader(F.write_pps(pps_r, sps_r)), ps0)
    sps = F.derived.SPS(sps_raw)
    pps = F.derived.PPS(pps_raw, sps)
    return F.ColFrameShim(poc, F.FrameTabs(sps, pps),
                          [F.derived.RefPicList(), F.derived.RefPicList()],
                          sps.ctb_log2_size_y)


def collocated_from(frame):
    """(collocated_from_l0, collocated_ref_idx) naming the frame's
    collocated picture in its reference lists."""
    col, refs = frame.get("collocated"), frame.get("refs")
    if col is None or not refs:
        return 1, 0
    delta = col - frame["poc"]
    for lx in (0, 1):
        if delta in refs[lx]:
            return int(lx == 0), refs[lx].index(delta)
    raise ValueError(f"POC {frame['poc']}: collocated POC {col} is in "
                     "neither reference list")


def forge_group(config, traffic, seed, segment, group, size=None):
    """NAL bytes of the frames `group` of one segment: {index: bytes}."""
    from vvcref import forge as F
    sps_r, pps_r = _param_sets(config, traffic, size)
    alf, lmcs = _apss(config, sps_r, seed, segment)
    frames = traffic["frames"]
    shims, out = {}, {}
    for i in group:
        f = frames[i]
        policy = F.FuzzPolicy(derive_seed(seed, segment, i))
        col = f.get("collocated")
        shim = None
        if col is not None:
            shim = shims.get(col) or _intra_shim(sps_r, pps_r, col)
        refs = f.get("refs")
        nal, shims[f["poc"]] = F.forge_frame(
            sps_r, pps_r, policy, qp=traffic["qp"], poc=f["poc"],
            idr=bool(f.get("idr")), slice_type=SLICE_TYPES[f["slice"]],
            ref_deltas=tuple(refs) if refs else None, collocated=shim,
            collocated_from=collocated_from(f),
            alf_aps=alf, ccalf=bool(sps_r.sps_ccalf_enabled_flag),
            lmcs_aps=lmcs, info_in_ph=traffic["tile_columns"] > 1,
            ph_kw=config.get("picture_header"))
        out[i] = nal
    return out


def _forge_job(args):
    return args[3], forge_group(*args)


def pool(processes):
    """A pool of spawned processes (the caller may hold CUDA or threads)."""
    return ProcessPoolExecutor(processes,
                               mp_context=multiprocessing.get_context("spawn"))


def forge(config, traffic, seed, size=None, processes=None):
    """The segments of one seed: a list of (header, [frame NAL bytes in
    decode order])."""
    n = traffic["segments"]
    jobs = [(config, traffic, seed, s, g, size)
            for s in range(n) for g in forge_groups(traffic)]
    nal = [dict() for _ in range(n)]
    if processes == 1:
        results = map(_forge_job, jobs)
        for s, got in results:
            nal[s].update(got)
    else:
        with pool(min(len(jobs), processes or os.cpu_count() or 1)) as ex:
            for s, got in ex.map(_forge_job, jobs):
                nal[s].update(got)
    return [(header(config, traffic, seed, s, size),
             [nal[s][i] for i in range(len(traffic["frames"]))])
            for s in range(n)]
