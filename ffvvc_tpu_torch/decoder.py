"""Top-level decoder orchestration of the port.

Reference analogue: libavcodec/vvc/vvcdec.c (decode_nal_units
:759, decode_slice :693, frame_setup :679, slice_init_entry_points :453).

The host-side front-end driver: NAL dispatch, parameter-set activation,
DPB and output order, per-slice entry-point CABAC parsing into FrameTabs
tensors, and the host reconstruction.  A copy of `ffvvc_tpu/decoder.py`,
kept diffable line by line against it, with the device half in PyTorch:

  * the mesh (`mesh_shape`) is this package's `parallel/filters.py`
    queue over a (gop, tile) array of torch devices (`config.device`
    repeated);
  * the fused chain (`device_pipeline`, `ops/fused_device.py`) and the
    per-stage device filters (`device_lmcs`, `device_deblock`,
    `device_sao`, `device_alf`; `ops/lmcs_device.py`, `deblock_device.py`,
    `sao_device.py`, `alf_device.py`) are this package's, run on
    `config.device` under backend "cuda";
  * the batched inverse transform (`ops/itx.py`), device MC (`device_mc`,
    `ops/mc_device.py`, one call a frame, its puts split over the mesh's
    "tile" axis) and device intra (`device_intra`,
    `ops/intra_device.py`) are this package's, run on `config.device`
    under backend "cuda".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bitstream import split_annexb, BitReader, NalType, is_vcl, is_idr, is_rap
from .bitstream.h266 import (H266ParamSets, read_sps, read_pps, read_aps,
                             read_vps, read_picture_header, read_slice_header,
                             read_sei, SLICE_I)
from . import ps as derived
from .cabac.engine import CabacDecoder, make_states
from .cabac.native import NativeCabacDecoder, load_lib
from .ctu import CtuCoder, FrameTabs
from .recon import FrameBuffer, Reconstructor
from .config import DecoderConfig
from . import trace


# frame flags (reference VVC_FRAME_FLAG_*, vvc_refs.c)
FLAG_OUTPUT, FLAG_SHORT_REF, FLAG_LONG_REF, FLAG_BUMPING = 1, 2, 4, 8


@dataclasses.dataclass(eq=False)       # identity eq/hash: DPB membership
class DecodedFrame:
    poc: int
    buffer: FrameBuffer
    tabs: FrameTabs
    flags: int = 0
    sequence: int = 0
    slice_rpls: list = dataclasses.field(default_factory=list)

    def to_yuv_bytes(self):
        return self.buffer.to_yuv_bytes()

    # True while the producing decoder still holds this frame in its DPB
    # (it may serve as a prediction reference); recycle() is a no-op then.
    _dpb_held: bool = False
    # pending pixel-stage future (frame pipeline); None once landed or when
    # the frame ran synchronously.  Inter frames wait on their REFERENCE
    # frames' futures only (RPL-aware progress gating).
    _pix_future = None
    # row-granular pixel progress (the host analogue of the reference's
    # per-frame FrameProgress rows, vvc_refs.c:532-565): luma rows
    # [0, _rows_final) are filter-final.  _row_cond is created when the
    # frame is submitted to the pixel worker; publish/wait synchronize
    # a consumer frame's MC with this frame's rolling filter pipeline.
    _row_cond = None
    _rows_final = 0

    def publish_rows(self, y):
        cond = self._row_cond
        if cond is None:
            self._rows_final = y
            return
        with cond:
            if y > self._rows_final:
                self._rows_final = y
            cond.notify_all()

    def wait_rows(self, y):
        """Block until luma rows [0, y) of this frame are filter-final.
        Falls through immediately when the frame has no pending pixel
        work (synchronous decode / already landed)."""
        fut = self._pix_future
        if fut is None or fut.done():
            return
        cond = self._row_cond
        if cond is None:
            trace.wait("wait.refs", fut)
            return
        with cond:
            if self._rows_final < y:
                with trace.span("wait.refs"):
                    while self._rows_final < y:
                        cond.wait()

    def recycle(self):
        """Return the frame's planes/tabs to the per-process pool.  Callers
        may use this once they are done with the pixel data AND the decoder
        that produced the frame is done decoding (e.g. after converting the
        outputs of a completed decode); the arrays are reused by later
        frames.  A frame the decoder still references (in-DPB) is left
        intact — recycling it would let a later frame overwrite live
        reference pixels."""
        if self._dpb_held:
            return
        if self.buffer is not None:
            sps, pps = self.buffer.sps, self.buffer.pps
            self.buffer.recycle()
            self.tabs.recycle(sps, pps)
            self.buffer = None
            self.tabs = None

    # --- TMVP interface (reference ref->tab_dmvr_mvf + rpl_tab) -----------

    def get_mvf(self, x, y):
        """Collocated MV lookup from the post-DMVR grid."""
        from .mvs import MvField
        t = self.tabs
        xi, yi = x >> 2, y >> 2
        f = MvField()
        f.pred_flag = int(t.col_pf[yi, xi])
        f.mv = [[int(t.col_mv[0, yi, xi, 0]), int(t.col_mv[0, yi, xi, 1])],
                [int(t.col_mv[1, yi, xi, 0]), int(t.col_mv[1, yi, xi, 1])]]
        f.ref_idx = [int(t.col_ref[0, yi, xi]), int(t.col_ref[1, yi, xi])]
        return f

    def rpl_at(self, x, y):
        """RPL of the slice containing (x, y) (ff_vvc_get_ref_list)."""
        t = self.tabs
        ctb_log2 = self._ctb_log2
        si = int(t.slice_idx[y >> ctb_log2, x >> ctb_log2])
        return self.slice_rpls[si]

    _ctb_log2 = 6


class VVCDecoder:
    """VVC decoder: Annex-B bytes in, decoded frames out in output (POC
    bumping) order, matching the reference DPB logic (vvc_refs.c:196-292)."""

    def __init__(self, config: DecoderConfig = None):
        self.config = config or DecoderConfig()
        if not isinstance(self.config, DecoderConfig):
            raise TypeError("ffvvc_tpu_torch.VVCDecoder needs an "
                            "ffvvc_tpu_torch.DecoderConfig")
        self.ps = H266ParamSets()
        self.sps = None
        self.pps = None
        self.ph = None
        self.prev_poc = 0
        self.frames = []
        self.dpb = []           # DecodedFrame entries with flags
        self.seq_decode = 0
        self.seq_output = 0
        # GDR recovery state (decode_recovery_flag/poc, vvc_ps.c:745-761)
        self.last_eos = 1
        # decoded-picture-hash suffix SEI pending for the in-flight AU;
        # mesh mode verifies after the deferred filters drain
        self._pending_dph = None
        self._dph_pending = []
        # True once an inter frame was decoded: gates the rolling row
        # pipeline (all-intra streams have no cross-frame pixel waits)
        self._seen_inter = False
        self.no_output_before_recovery = 0
        self.gdr_recovery_point_poc = 0
        self.gdr_recovered = True
        # seconds by span name (trace.py) of this decoder's frames, and
        # the tag of its latest frame
        self.stage_times = {}
        self._trace = trace.Frame(None, None, self.stage_times,
                                  self.config.profile)
        # frame pipeline: pixel stages of queued frames run on this worker
        # while later frames parse (config.pipeline_frames/pipeline_depth)
        self._pix_exec = None
        self._pix_futures = []
        # mesh-sharded filter pipeline (parallel/filters.py): frames over
        # "gop", CTU-row slabs over "tile"; drains at inter ref barriers
        self._mesh_q = None
        g, t = self.config.mesh_shape
        if g * t > 1:
            from .parallel.filters import make_mesh_exact, MeshFilterQueue
            self._mesh_q = MeshFilterQueue(make_mesh_exact(
                (g, t), self.config.mesh_devices, self.config.device))

    def decode(self, data: bytes, flush: bool = True):
        """Decode an Annex-B chunk.  With flush=True (whole-stream call)
        all frames are drained in output order; with flush=False (streaming:
        one access unit per call, see bitstream/au.py) frames are released
        per DPB bumping rules and the tail is drained by flush()."""
        with trace.decoding(self._trace):
            return self._decode(data, flush)

    def _decode(self, data, flush):
        nals = split_annexb(data)
        # group into access units by PH/first-slice boundaries
        frame_nals = []
        out = []
        cur_slices = []
        cur_ph = None

        resilient = self.config.error_resilient

        def flush_frame():
            nonlocal cur_slices, cur_ph
            if cur_slices:
                if resilient:
                    # error latch (vvc_thread.c:605-617): first failure marks
                    # the frame broken; decode resumes at the next AU
                    try:
                        out.extend(self._decode_frame(cur_ph, cur_slices))
                    except Exception:
                        pass
                else:
                    out.extend(self._decode_frame(cur_ph, cur_slices))
            cur_slices = []
            cur_ph = None

        def handle(nal):
            nonlocal cur_ph
            t = nal.nal_unit_type
            r = BitReader(nal.rbsp)
            if t == NalType.SPS:
                # parameter sets decode in NAL order (decode_nal_unit,
                # vvcdec.c:724): a pending frame must decode against the
                # param sets active when its slices arrived, not ones from
                # a following AU
                flush_frame()
                self.ps.store_sps(read_sps(r, nal.nuh_layer_id))
            elif t == NalType.PPS:
                flush_frame()
                self.ps.store_pps(read_pps(r, self.ps))
            elif t in (NalType.PREFIX_APS, NalType.SUFFIX_APS):
                flush_frame()
                self.ps.store_aps(read_aps(r))
            elif t == NalType.VPS:
                flush_frame()
                vps = read_vps(r)
                self.ps.vps[vps.vps_video_parameter_set_id] = vps
            elif t == NalType.PH:
                flush_frame()
                self.ps.ph = read_picture_header(r, self.ps)
            elif is_vcl(t):
                sh = read_slice_header(r, self.ps, t)
                if sh.sh_picture_header_in_slice_header_flag and cur_slices:
                    flush_frame()
                cur_ph = sh.ph
                cur_slices.append((nal, sh, r.pos))
            elif t in (NalType.PREFIX_SEI, NalType.SUFFIX_SEI):
                try:
                    self.last_sei = read_sei(r, t == NalType.PREFIX_SEI)
                except Exception:
                    self.last_sei = []
                if t == NalType.SUFFIX_SEI and cur_slices:
                    # decoded-picture-hash (H.274: suffix SEI) applies to
                    # the access unit it follows
                    for ptype, payload in self.last_sei:
                        if ptype == 132:
                            from .bitstream.h266 import parse_dph
                            try:
                                self._pending_dph = parse_dph(payload)
                            except Exception:
                                self._pending_dph = None
            elif t in (NalType.EOS, NalType.EOB):
                flush_frame()
                self.last_eos = 1
            # AUD/FD/OPI/DCI: no decoder state

        for nal in nals:
            if resilient:
                try:
                    handle(nal)
                except Exception:
                    # broken NAL: drop the in-flight frame's pending slices
                    # (decode_nal_units fail path, vvcdec.c:795-798)
                    cur_slices = []
                    cur_ph = None
            else:
                handle(nal)
        flush_frame()
        self._join_pixels()
        out.extend(self._output_frames(flush=flush))
        if self._mesh_q is not None:
            # frames reference live buffers; deferred mesh filters must
            # land before the caller reads pixels
            with trace.span("wait.pixels"):
                self._mesh_q.drain()
        self._check_pending_dph()
        if flush:
            self._release_dpb()
        return out

    def flush(self):
        """Drain remaining reordered frames (end of stream)."""
        with trace.decoding(self._trace):
            self._join_pixels()
            out = self._output_frames(flush=True)
            if self._mesh_q is not None:
                with trace.span("wait.pixels"):
                    self._mesh_q.drain()
            self._check_pending_dph()
            self._release_dpb()
        return out

    def _check_pending_dph(self):
        pend, self._dph_pending = self._dph_pending, []
        for fr, d in pend:
            self._check_picture_hash(fr, d)

    def _release_dpb(self):
        """End of stream: drop remaining reference holds so output frames
        become recyclable (the analogue of avcodec_flush_buffers clearing
        the DPB)."""
        for f in list(self.dpb):
            f.flags = 0
            self._unref_check(f)

    # --- DPB / output order (vvc_refs.c:196-292) ---------------------------

    def _dpb_max_buffering(self):
        sps_r = self.sps.r if self.sps else None
        if sps_r is None:
            return 1
        dpb = sps_r.sps_dpb_params
        if not dpb:
            return 1
        return dpb.dpb_max_dec_pic_buffering_minus1[
            sps_r.sps_max_sublayers_minus1] + 1

    def _unref_check(self, f):
        if not f.flags and f in self.dpb:
            self.dpb.remove(f)
            f._dpb_held = False

    def _output_frames(self, flush=False, cur_poc=None):
        out = []
        while True:
            cands = [f for f in self.dpb if (f.flags & FLAG_OUTPUT) and
                     f.sequence == self.seq_output]
            if not cands:
                if self.seq_output != self.seq_decode:
                    self.seq_output += 1
                    continue
                break
            if not flush and self.seq_output == self.seq_decode and \
                    len(cands) <= self._dpb_max_buffering():
                break
            f = min(cands, key=lambda fr: fr.poc)
            f.flags &= ~(FLAG_OUTPUT | FLAG_BUMPING)
            self._unref_check(f)
            out.append(f)
        return out

    def _bump_frame(self, cur_poc):
        """ff_vvc_bump_frame (vvc_refs.c:255)."""
        dpb_n = sum(1 for f in self.dpb if f.flags and
                    f.sequence == self.seq_output and f.poc != cur_poc)
        if dpb_n >= self._dpb_max_buffering():
            min_poc = None
            for f in self.dpb:
                if f.flags == FLAG_OUTPUT and f.sequence == self.seq_output \
                        and f.poc != cur_poc:
                    if min_poc is None or f.poc < min_poc:
                        min_poc = f.poc
            if min_poc is not None:
                for f in self.dpb:
                    if (f.flags & FLAG_OUTPUT) and \
                            f.sequence == self.seq_output and \
                            f.poc <= min_poc:
                        f.flags |= FLAG_BUMPING

    def _find_ref(self, poc, use_msb):
        mask = ~0 if use_msb else self.sps.max_pic_order_cnt_lsb - 1
        for f in self.dpb:
            if f.sequence == self.seq_decode and (f.poc & mask) == poc:
                return f
        return None

    def _generate_missing_ref(self, poc):
        """generate_missing_ref (vvc_refs.c:316): mid-gray synthesized."""
        fb = FrameBuffer.acquire(self.sps, self.pps)
        tabs = FrameTabs.acquire(self.sps, self.pps)
        tabs.slice_idx[:] = 0
        f = DecodedFrame(poc=poc, buffer=fb, tabs=tabs,
                         sequence=self.seq_decode)
        f._ctb_log2 = self.sps.ctb_log2_size_y
        f.slice_rpls = [[derived.RefPicList(), derived.RefPicList()]]
        f._dpb_held = True
        self.dpb.append(f)
        return f

    def _build_slice_rpl(self, frame, sh, poc):
        """ff_vvc_slice_rpl (vvc_refs.c:415)."""
        sps, pps = self.sps, self.pps
        rsh, ph = sh.r, sh.ph
        max_poc_lsb = sps.max_pic_order_cnt_lsb
        ref_lists = ph.ph_ref_pic_lists if pps.r.pps_rpl_info_in_ph_flag \
            else rsh.ref_pic_lists
        rpl_pair = []
        collocated = None
        for lx in range(2):
            rpls = ref_lists.rpl_ref_list[lx]
            rpl = derived.RefPicList()
            poc_base = poc
            prev_delta_poc_msb = 0
            j = 0
            for i in range(rpls.num_ref_entries):
                if rpls.inter_layer_ref_pic_flag and \
                        rpls.inter_layer_ref_pic_flag[i]:
                    raise NotImplementedError("inter-layer ref")
                if rpls.st_ref_pic_flag[i]:
                    # delta_poc_st (vvc_refs.c:391)
                    abs_d = rpls.abs_delta_poc_st[i]
                    if not ((sps.r.sps_weighted_pred_flag or
                             sps.r.sps_weighted_bipred_flag) and i != 0):
                        abs_d += 1
                    p = poc_base + (1 - 2 * rpls.strp_entry_sign_flag[i]) * \
                        abs_d
                    poc_base = p
                    is_lt, use_msb = False, True
                else:
                    use_msb = ref_lists.delta_poc_msb_cycle_present_flag[lx][j]
                    lt_poc = ref_lists.poc_lsb_lt[lx][j] \
                        if rpls.ltrp_in_header_flag else \
                        rpls.rpls_poc_lsb_lt[j]
                    if use_msb:
                        delta = ref_lists.delta_poc_msb_cycle_lt[lx][j] + \
                            prev_delta_poc_msb
                        lt_poc += poc - delta * max_poc_lsb - \
                            (poc & (max_poc_lsb - 1))
                        prev_delta_poc_msb = delta
                    p = lt_poc
                    is_lt = True
                    j += 1
                ref = self._find_ref(p, use_msb)
                if ref is frame:
                    raise ValueError("current frame in its own RPL")
                if ref is None:
                    ref = self._generate_missing_ref(p)
                rpl.add(p, is_lt, ref)
                # mark_ref
                ref.flags &= ~(FLAG_LONG_REF | FLAG_SHORT_REF)
                ref.flags |= FLAG_LONG_REF if is_lt else FLAG_SHORT_REF
            rpl_pair.append(rpl)
        lx = 1 - rsh.sh_collocated_from_l0_flag
        if rsh.sh_collocated_ref_idx < rpl_pair[lx].nb_refs:
            collocated = rpl_pair[lx].frames[rsh.sh_collocated_ref_idx]
        return rpl_pair, collocated

    def _decode_frame(self, ph, slices):
        nal0, sh0, _ = slices[0]
        pps_r = self.ps.pps[ph.ph_pic_parameter_set_id]
        sps_r = self.ps.sps[pps_r.pps_seq_parameter_set_id]
        sps = derived.SPS(sps_r)
        pps = derived.PPS(pps_r, sps)
        self.sps, self.pps = sps, pps
        is_clvss = is_rap(nal0.nal_unit_type)  # simplified CLVSS decision
        poc = derived.compute_poc(sps, ph, self.prev_poc, is_clvss and
                                  not ph.ph_poc_msb_cycle_present_flag)
        if is_idr(nal0.nal_unit_type):
            poc = derived.compute_poc(sps, ph, 0, True)
            # ff_vvc_clear_refs on IDR (vvcdec.c:583-585)
            for f in self.dpb:
                f.flags &= ~(FLAG_SHORT_REF | FLAG_LONG_REF)
                self._unref_check(f)
        self.prev_poc = poc
        # this thread's spans are this frame's (trace.py; the reference's
        # VVC_THREAD_DEBUG task trace, vvc_thread.c:568-603)
        tag = self._trace = self._trace.next(poc)
        trace.enter(tag)
        # GDR recovery tracking (decode_recovery_flag/poc, vvc_ps.c:745-761)
        nt = nal0.nal_unit_type
        if is_idr(nt):
            self.no_output_before_recovery = 0
        elif nt in (NalType.CRA, NalType.GDR):
            self.no_output_before_recovery = self.last_eos
            if self.no_output_before_recovery:
                self.gdr_recovered = False
        self.last_eos = 0
        if self.no_output_before_recovery:
            if nt == NalType.GDR:
                self.gdr_recovery_point_poc = poc + ph.ph_recovery_poc_cnt
            if not self.gdr_recovered and \
                    self.gdr_recovery_point_poc <= poc:
                self.gdr_recovered = True
        tabs = FrameTabs.acquire(sps, pps)
        fb = FrameBuffer.acquire(sps, pps)

        # DPB admission + output/bumping (frame_start, vvcdec.c:596-628)
        frame = DecodedFrame(poc=poc, buffer=fb, tabs=tabs,
                             sequence=self.seq_decode)
        frame._ctb_log2 = sps.ctb_log2_size_y
        suppressed = self.no_output_before_recovery and not \
            self.gdr_recovered
        frame.flags = FLAG_SHORT_REF | \
            (FLAG_OUTPUT if ph.ph_pic_output_flag and not suppressed else 0)
        frame._dpb_held = True
        self.dpb.append(frame)
        outputs = self._output_frames()
        self._bump_frame(poc)

        is_inter_frame = any(s[1].sh_slice_type != SLICE_I for s in slices)
        if is_inter_frame:
            self._seen_inter = True
        if is_inter_frame:
            # clear ref marks of all other frames; slice RPLs re-mark
            # (ff_vvc_frame_rpl, vvc_refs.c:468)
            for f in self.dpb:
                if f is not frame:
                    f.flags &= ~(FLAG_SHORT_REF | FLAG_LONG_REF)

        scaling_list = None
        if ph.ph_explicit_scaling_list_enabled_flag:
            raw_sl = self.ps.aps_scaling.get(ph.ph_scaling_list_aps_id)
            if raw_sl is not None:
                scaling_list = derived.VVCScalingList(raw_sl)
        lmcs = None
        if ph.ph_lmcs_enabled_flag:
            raw_lmcs = self.ps.aps_lmcs.get(ph.ph_lmcs_aps_id)
            if raw_lmcs is not None:
                lmcs = derived.VVCLMCS(raw_lmcs, sps.r)
        recon_jobs = []
        inter_jobs = []
        sh_by_slice = {}
        ref_frames = set()      # DPB frames this frame predicts from
        for slice_idx_in_frame, (nal, sh_r, sh_end_bits) in enumerate(slices):
            sh = derived.SH(sh_r, ph, sps, pps)
            sh_by_slice[sh.slice_idx] = sh
            if sh.slice_type != SLICE_I:
                rpl, collocated = self._build_slice_rpl(frame, sh, poc)
                if sps.r.sps_smvd_enabled_flag:
                    derived.smvd_ref_idx(sh, rpl, poc)
                for lst in rpl:
                    ref_frames.update(lst.frames)
            else:
                rpl, collocated = [derived.RefPicList(),
                                   derived.RefPicList()], None
            while len(frame.slice_rpls) <= sh.slice_idx:
                frame.slice_rpls.append(rpl)
            frame.slice_rpls[sh.slice_idx] = rpl
            # native C recon eligibility: no explicit scaling lists and no
            # LMCS chroma residual scaling on this slice (recon.py gates)
            native_recon_ok = (
                (scaling_list is None or
                 not sh.r.sh_explicit_scaling_list_used_flag) and
                not (lmcs is not None and sh.r.sh_lmcs_used_flag and
                     ph.ph_chroma_residual_scale_flag))
            jobs = self._parse_slice(nal, sh, sh_end_bits, tabs, fb,
                                     slice_idx_in_frame,
                                     rpl=rpl, poc=poc, collocated=collocated,
                                     native_recon_ok=native_recon_ok)
            if scaling_list is not None:
                for rec, _ in jobs:
                    rec.scaling_list = scaling_list
                    rec.explicit_sl_used = \
                        bool(sh.r.sh_explicit_scaling_list_used_flag)
            if lmcs is not None:
                for rec, _ in jobs:
                    rec.lmcs = lmcs
                    rec.lmcs_used = bool(sh.r.sh_lmcs_used_flag)
                    rec.chroma_scale_on = \
                        bool(ph.ph_chroma_residual_scale_flag)
            recon_jobs.extend(jobs)
            if sh.slice_type != SLICE_I:
                from .inter import InterPredictor
                for rec, ctus in jobs:
                    nr = rec.native_recon
                    if nr is not None and nr._ip_ref is not None:
                        # native inter MC walk (native/vvc_inter.c)
                        nr.set_lmcs_fwd(
                            lmcs.fwd_lut if lmcs is not None and
                            sh.r.sh_lmcs_used_flag else None)
                        inter_jobs.append((nr, ctus))
                        continue
                    ip = InterPredictor(sps, pps, tabs, fb, sh, rpl,
                                        rec.nbr)
                    if lmcs is not None and sh.r.sh_lmcs_used_flag:
                        ip.lmcs_fwd = lmcs.fwd_lut
                    rec.inter_pred = ip
                    inter_jobs.append((ip, ctus))
        # release frames left unreferenced after RPL marking
        if is_inter_frame:
            for f in list(self.dpb):
                if f is not frame:
                    self._unref_check(f)

        # inter MC needs its REFERENCE frames' filtered pixels — and only
        # those: the host analogue of the reference's per-frame progress
        # wait (schedule_inter, vvc_thread.c:281-296).  Frames this frame
        # does not predict from (e.g. non-referenced B leaves of a
        # hierarchical GOP) keep their pixel stages in flight, overlapping
        # this frame's MC and the next frames' parse.  The queue is then
        # trimmed to config.pipeline_depth to bound in-flight memory (the
        # reference's deep frame contexts, vvcdec.c:830-841).
        row_wait_refs = None
        dev_mc = self.config.backend == "cuda" and self.config.device_mc
        if self._mesh_q is not None:
            if is_inter_frame:
                # reference barrier: MC below reads DPB pixels — land the
                # deferred mesh passes of the frames this frame actually
                # references; non-referenced frames stay queued so the
                # gop axis stays >1-deep on inter content (the collective
                # form of the row-progress wait, vvc_thread.c:281-296)
                self._join_pixels("wait.refs")
                with trace.span("wait.refs"):
                    self._mesh_q.drain(
                        needed={rf.buffer for rf in ref_frames})
        else:
            if is_inter_frame:
                all_native = all(not hasattr(ip, "c")
                                 for ip, _ in inter_jobs)
                # device MC is one call a frame, after its references
                # have landed: only the host filters publish rows early
                if self.config.row_progress and all_native and not dev_mc:
                    # row-granular gating: MC below waits per CTU row on
                    # just the reference rows it needs (wait_rows);
                    # references that can't publish rows degrade to a
                    # whole-frame wait inside wait_rows
                    row_wait_refs = [
                        rf for rf in ref_frames
                        if rf._pix_future is not None
                        and not rf._pix_future.done()]
                else:
                    for rf in ref_frames:
                        fut = rf._pix_future
                        if fut is not None:
                            trace.wait("wait.refs", fut)
            # with row gating the reference frames stay in flight: keep
            # one extra pixel job queued so their rolling filters overlap
            # this frame's MC (memory still bounded by pipeline_depth)
            self._trim_pixels(max(1, self.config.pipeline_depth) -
                              (0 if row_wait_refs else 1))

        if self.config.backend == "cuda":
            # batched inverse transforms on device (one launch per TB bucket);
            # host recon below then only adds the precomputed residuals
            from .ops.itx import frame_device_residuals
            frame_device_residuals(recon_jobs, tabs, sps.bit_depth,
                                   self.config.device)
        # inter MC pass (reference INTER task stage precedes RECON,
        # vvc_thread.c:41-51)
        native_mc = []
        for ip, ctus in inter_jobs:
            if hasattr(ip, "c"):      # Python InterPredictor
                for rs, rx, ry in ctus:
                    ip.c.decode_neighbour(rx << sps.ctb_log2_size_y,
                                          ry << sps.ctb_log2_size_y,
                                          rx, ry, rs)
                    ip.predict_inter_ctu(rs)
            else:                     # NativeRecon (native/vvc_inter.c)
                native_mc.extend((ip, rs, rx, ry) for rs, rx, ry in ctus)
        if native_mc and row_wait_refs:
            # row-granular MC: walk CTU rows in order, waiting on just the
            # reference rows this row's MVs reach (+ filter/refinement
            # margin) — the reference's schedule_inter row gating
            # (vvc_thread.c:281-296, max-y per CU from cu_get_max_y).
            needy = self._mc_row_needs(tabs, sps, pps)
            from collections import defaultdict
            by_row = defaultdict(list)
            for item in native_mc:
                by_row[item[3]].append(item)
            for ry in sorted(by_row):
                need = needy[ry]
                for rf in row_wait_refs:
                    rf.wait_rows(need)
                items = by_row[ry]
                with trace.span("mc.host", row=ry):
                    i = 0
                    while i < len(items):
                        ip = items[i][0]
                        j = i
                        while j < len(items) and items[j][0] is ip:
                            j += 1
                        ip.predict_inter_ctus(
                            [(rs, rx, r2) for _, rs, rx, r2 in items[i:j]])
                        i = j
            native_mc = []
        if native_mc and dev_mc:
            # batched device MC for simple regular blocks; the same C call
            # host-filters the complex ones (ops/mc_device.py).  In mesh
            # mode the put batches shard over the "tile" axis (refs
            # replicated) so an inter frame's MC runs on all devices.
            from .ops.mc_device import frame_device_mc
            njobs = [(ip, ctus) for ip, ctus in inter_jobs
                     if not hasattr(ip, "c")]
            frame_device_mc(njobs, sps, sps.bit_depth,
                            device=self.config.device,
                            mesh=self._mc_mesh())
            native_mc = []
        if native_mc:
            # MC CTUs are data-independent (refs are other frames; DMVR
            # col-grid writes are per-CU disjoint): thread batched C calls
            # (inter_ctus: one ctypes call per contiguous same-job run)
            from .threads import resolve, run_parallel, split_ranges
            nt = resolve(self.config.stage_threads)

            def mc_chunk(lo, hi):
                i = lo
                while i < hi:
                    ip = native_mc[i][0]
                    j = i
                    while j < hi and native_mc[j][0] is ip:
                        j += 1
                    ip.predict_inter_ctus(
                        [(rs, rx, ry) for _, rs, rx, ry in native_mc[i:j]])
                    i = j

            with trace.span("mc.host"):
                run_parallel(nt, [
                    (lambda lo=lo, hi=hi: mc_chunk(lo, hi))
                    for lo, hi in split_ranges(len(native_mc), nt)])

        dph, self._pending_dph = self._pending_dph, None

        # snapshot ALF state on THIS thread: pixel_stages may run on the
        # frame-pipeline worker while the main thread's handle(PREFIX_APS)
        # mutates self.ps.aps_alf for a later AU — a frame must be filtered
        # with the APS contents active when its slices arrived
        alf_list = sh_list = None
        if sps.r.sps_alf_enabled_flag:
            from .alf import VVCALF
            alf_list = {i: VVCALF(a) for i, a in self.ps.aps_alf.items()}
            sh_list = [sh_by_slice.get(i) for i in
                       range(max(sh_by_slice) + 1)]

        def pixel_stages():
            # recon / LMCS / deblock / SAO / ALF: no later frame's PARSE
            # depends on these (TMVP reads the col MV grids written at
            # parse/inter time), so they overlap frame N+1's parse on the
            # frame pipeline (config.pipeline_frames)
            mesh = self._mesh_q
            cfg = self.config
            # the rolling row pipeline only pays off when a later inter
            # frame can overlap its MC with this frame's filters: all-
            # intra streams keep the (stage-threaded) whole-frame passes
            if (mesh is None and cfg.row_progress and cfg.pipeline_frames
                    and self._seen_inter and
                    not (cfg.backend == "cuda" and
                         (cfg.device_intra or cfg.device_deblock or
                          cfg.device_sao or cfg.device_alf or
                          cfg.device_lmcs or cfg.device_pipeline))):
                if self._pixel_stages_rows(frame, sps, pps, tabs, fb,
                                           recon_jobs, lmcs, sh_list,
                                           alf_list):
                    if dph is not None and cfg.verify_picture_hash:
                        self._check_picture_hash(frame, dph)
                    for rec, _ in recon_jobs:
                        tree = getattr(rec.nbr, "native_tree", None)
                        if tree is not None:
                            tree.release_records()
                    return
            # fused device-resident chain (config.device_pipeline,
            # ops/fused_device.py): recon runs host (or as a deferred
            # residual-add stage for inter-only frames), then
            # [residual-add]/LMCS/deblock-V/H/SAO/ALF/CC-ALF run as ONE
            # device chain on cfg.device — planes upload once, download once
            fused = (mesh is None and cfg.backend == "cuda" and
                     cfg.device_pipeline)
            # mesh/fused: defer recon's residual add for inter-only frames
            # (no intra/CIIP CUs — those need the sequential neighbour
            # walk) so the add runs as a batched device pass
            defer_res = self._deferred_residuals(recon_jobs, fb) \
                if ((mesh is not None or fused) and is_inter_frame) \
                else None
            did_dev_intra = False
            if (defer_res is None and self.config.backend == "cuda" and
                    self.config.device_intra and not is_inter_frame):
                # wavefront-batched device intra (ops/intra_device.py);
                # returns False (untouched state) when ineligible
                from .ops.intra_device import frame_device_intra
                did_dev_intra = frame_device_intra(recon_jobs, sps, pps,
                                                   tabs, fb,
                                                   device=cfg.device)
            if defer_res is None and not did_dev_intra:
                for rec, ctus in recon_jobs:
                    nr = rec.native_recon
                    if nr is not None:
                        nr.reconstruct_ctus(ctus)   # one C call per job
                    else:
                        for rs, rx, ry in ctus:
                            rec.reconstruct_ctu(rs, rx, ry)
            if fused:
                from .ops.fused_device import fused_frame_filters
                if fused_frame_filters(sps, pps, tabs, fb, sh_list,
                                       alf_list, lmcs, recon_jobs,
                                       frame.slice_rpls,
                                       res_planes=defer_res,
                                       device=cfg.device):
                    if dph is not None and cfg.verify_picture_hash:
                        self._check_picture_hash(frame, dph)
                    for rec, _ in recon_jobs:
                        tree = getattr(rec.nbr, "native_tree", None)
                        if tree is not None:
                            tree.release_records()
                    return
                if defer_res is not None:
                    # ineligible frame: land the deferred add on host and
                    # fall through to the host stages
                    mxv = (1 << sps.bit_depth) - 1
                    for c, r in enumerate(defer_res):
                        fb.planes[c][:] = np.clip(
                            fb.planes[c].astype(np.int32) + r, 0, mxv)
                    defer_res = None
            # LMCS inverse mapping (stage before deblock, vvc_thread.c:44,
            # ff_vvc_lmcs_filter vvc_filter.c:1322)
            lmcs_ctx = None
            if lmcs is not None:
                if mesh is not None:
                    mask = np.zeros(fb.planes[0].shape, np.bool_)
                    ctb = sps.ctb_size_y
                    for rec, ctus in recon_jobs:
                        if not rec.lmcs_used:
                            continue
                        for rs, rx, ry in ctus:
                            mask[ry * ctb:(ry + 1) * ctb,
                                 rx * ctb:(rx + 1) * ctb] = True
                    if mask.any():
                        lmcs_ctx = (lmcs.inv_lut, mask)
                elif self.config.backend == "cuda" and \
                        self.config.device_lmcs:
                    from .ops.lmcs_device import lmcs_frame_device
                    lmcs_frame_device(sps, pps, fb, lmcs, recon_jobs,
                                      cfg.device)
                else:
                    ctb = sps.ctb_size_y
                    with trace.span("lmcs"):
                        for rec, ctus in recon_jobs:
                            if not rec.lmcs_used:
                                continue
                            for rs, rx, ry in ctus:
                                x0, y0 = rx * ctb, ry * ctb
                                x1 = min(x0 + ctb, pps.width)
                                y1 = min(y0 + ctb, pps.height)
                                blk = fb.planes[0][y0:y1, x0:x1]
                                blk[:] = lmcs.inv_lut[blk]
            # in-loop filters (whole-frame passes per spec 8.8)
            defer_deblock = mesh is not None and \
                not getattr(sps, "num_ladf_intervals", 0)
            done = defer_deblock
            if not done and self.config.backend == "cuda" and \
                    self.config.device_deblock:
                from .ops.deblock_device import deblock_frame_device
                done = deblock_frame_device(sps, pps, tabs, fb,
                                            frame.slice_rpls, cfg.device)
            if not done:
                from .deblock import Deblocker
                from .threads import resolve
                db = Deblocker(sps, pps, tabs, fb)
                db.slice_rpls = frame.slice_rpls
                db.n_threads = resolve(self.config.stage_threads)
                with trace.span("deblock"):
                    db.deblock_frame()
            if mesh is not None:
                # mesh-sharded residual-add/LMCS/deblock/SAO/ALF/CC-ALF
                # (parallel/filters.py): deferred until a reference
                # barrier needs this frame or the decode call ends, so
                # independent frames batch over the "gop" axis
                mesh.add(sps, pps, tabs, fb, sh_list, alf_list,
                         slice_rpls=frame.slice_rpls if defer_deblock
                         else None,
                         res_planes=defer_res, lmcs_ctx=lmcs_ctx)
                if dph is not None and self.config.verify_picture_hash:
                    self._dph_pending.append((frame, dph))
            else:
                if self.config.backend == "cuda" and self.config.device_sao:
                    from .ops.sao_device import sao_frame_device
                    sao_frame_device(sps, pps, tabs, fb, cfg.device)
                else:
                    from .sao import SaoFilter
                    from .threads import resolve
                    sf = SaoFilter(sps, pps, tabs, fb)
                    sf.n_threads = resolve(self.config.stage_threads)
                    with trace.span("sao"):
                        sf.sao_frame()
                if alf_list is not None:
                    if self.config.backend == "cuda" and \
                            self.config.device_alf:
                        from .ops.alf_device import alf_frame_device
                        alf_frame_device(sps, pps, tabs, fb, sh_list,
                                         alf_list, cfg.device)
                    else:
                        done = False
                        with trace.span("alf"):
                            if self.config.native_alf:
                                from .native.alf import alf_frame_native
                                from .threads import resolve
                                done = alf_frame_native(
                                    sps, pps, tabs, fb, sh_list, alf_list,
                                    resolve(self.config.stage_threads))
                            if not done:
                                from .alf import AlfFilter
                                AlfFilter(sps, pps, tabs, fb, sh_list,
                                          alf_list).alf_frame()
            if dph is not None and self.config.verify_picture_hash and \
                    mesh is None:
                self._check_picture_hash(frame, dph)
            # recycle native parse record arenas (everything pixel-level
            # that reads them — MC, CIIP, recon — has run; tabs keep the
            # MV grids).  The pool is lock-guarded against the next
            # frame's concurrent parse (native/parse.py _ARENA_LOCK).
            for rec, _ in recon_jobs:
                tree = getattr(rec.nbr, "native_tree", None)
                if tree is not None:
                    tree.release_records()

        if self.config.pipeline_frames and not self.config.error_resilient:
            if self._pix_exec is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pix_exec = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ffvvc-pixels")
            import threading
            frame._row_cond = threading.Condition()
            submitted = trace.now()

            def pixel_stages_published():
                with trace.job(tag, submitted):
                    try:
                        pixel_stages()
                    finally:
                        # wake any row waiters unconditionally (whole-frame
                        # fallbacks and error paths publish "all rows")
                        frame.publish_rows(1 << 30)

            fut = self._pix_exec.submit(pixel_stages_published)
            frame._pix_future = fut
            self._pix_futures.append(fut)
        else:
            pixel_stages()
        return outputs

    def _mc_mesh(self):
        """Mesh for sharded device-MC puts (None on a single device)."""
        return self._mesh_q.mesh if self._mesh_q is not None else None

    @trace.traced("mc.row_needs")
    def _mc_row_needs(self, tabs, sps, pps):
        """Per-CTU-row max referenced luma row (exclusive) for inter MC:
        the vectorized analogue of the reference's per-CU max-ref-y
        (cu_get_max_y, vvc_ctu.c:2327), with a conservative margin.

        MARGIN derivation (worst read row past `bottom + (mvy >> 4)`,
        where bottom is the 4x4's exclusive bottom and mvy>>4 floors the
        1/16-pel vertical MV to int-pel):
          * 8-tap luma interp: taps reach +4 past the int sample row of
            the block's last row -> +3;
          * 4:2:0 chroma 4-tap: +2 chroma rows = +4 luma, plus the
            half-pel floor -> +5;
          * DMVR: +-2 int-pel refinement on top of the stored (unrefined)
            MV, then the final 8-tap / chroma fetch -> +7 worst
            (2 + chroma 5);
          * BDOF / PROF: +1 sample ring on the (possibly refined)
            prediction -> dominated by the DMVR chroma bound.
        Worst case +7; MARGIN = 12 keeps slack.

        GPM hazard: a GPM block computes BOTH parts' whole-block
        predictions (blended), but the 4x4 grid stores each part's MV
        only in its own region (ff_vvc_set_mvf storage) — a stored MV's
        true reach is the BLOCK bottom, not the storing 4x4's bottom.
        GPM blocks never span CTU rows, so on GPM-capable frames the
        per-4x4 bottom is replaced by its CTU row's bottom (pinned by
        tests/test_pipeline.py::test_mc_row_needs_gpm)."""
        MARGIN = 12
        pf = tabs.mvf_pf
        mvy = tabs.mvf_mv[:, :, :, 1] >> 4        # [2, h4, w4] int-pel
        h4 = pf.shape[0]
        ctb4 = sps.ctb_size_y >> 2
        if sps.r.sps_gpm_enabled_flag:
            rows4 = np.arange(h4, dtype=np.int64)
            bottom = ((rows4 // ctb4 + 1) * sps.ctb_size_y)[:, None]
        else:
            bottom = (np.arange(h4, dtype=np.int64)[:, None] + 1) * 4
        reach = np.where((pf & 1) != 0, bottom + mvy[0] + MARGIN, 0)
        reach = np.maximum(
            reach, np.where((pf & 2) != 0, bottom + mvy[1] + MARGIN, 0))
        return [min(pps.height,
                    int(reach[r * ctb4:(r + 1) * ctb4].max(initial=0)))
                for r in range(pps.ctb_height)]

    @trace.traced("rows")
    def _pixel_stages_rows(self, frame, sps, pps, tabs, fb, recon_jobs,
                           lmcs, sh_list, alf_list):
        """Row-granular pixel pipeline: recon/LMCS/deblock-V/deblock-H/
        SAO/ALF roll down the frame one CTB row at a time with the stage
        lags the filter halos require, publishing per-row progress so a
        consumer frame's inter MC can start before this frame finishes
        (host analogue of the reference's row-progress listeners,
        vvc_thread.c:281-296 / vvc_refs.c:532-565).  Bit-exact with the
        whole-frame passes: H(r) needs V(r+1) (its bottom edges read the
        next row's top taps) and finalizes deblock for row r-1 (its top
        edges write up the halo); SAO(r) then runs after H(r+1) on a
        progressively-snapshotted pre buffer, and ALF(r) one row behind
        SAO (its CC-ALF taps read one luma row past the CTB).  Returns
        False (state untouched) when a stage can't run row-sliced."""
        from .deblock import Deblocker
        from .native.sao import SaoRowPass
        from .native.alf import AlfRowPass
        if not recon_jobs or any(rec.native_recon is None
                                 for rec, _ in recon_jobs):
            return False
        db = Deblocker(sps, pps, tabs, fb)
        db.slice_rpls = frame.slice_rpls
        if not db.frame_ctx():
            return False
        sao = None
        if tabs.sao_type.any():
            sao = SaoRowPass(sps, pps, tabs, fb)
            if not sao.eligible:
                return False
        alf = None
        if sps.r.sps_alf_enabled_flag:
            alf = AlfRowPass(sps, pps, tabs, fb, sh_list, alf_list)
            if alf.needed and not alf.eligible:
                return False
            if not alf.needed:
                alf = None

        R = pps.ctb_height
        ctb = sps.ctb_size_y
        H = pps.height
        y0 = [min(r * ctb, H) for r in range(R + 1)]
        rows = [[] for _ in range(R)]
        lrows = [[] for _ in range(R)] if lmcs is not None else None
        for rec, ctus in recon_jobs:
            for t in ctus:
                rows[t[2]].append((rec, t))
                if lrows is not None and rec.lmcs_used:
                    lrows[t[2]].append(t)
        mx = (1 << sps.bit_depth) - 1

        def recon_row(r):
            items = rows[r]
            i = 0
            while i < len(items):
                rec = items[i][0]
                j = i
                while j < len(items) and items[j][0] is rec:
                    j += 1
                rec.native_recon.reconstruct_ctus(
                    [t for _, t in items[i:j]])
                i = j

        def lmcs_row(r):
            # LMCS inverse lags recon one row: row r+1's intra prediction
            # reads row r's MAPPED-domain bottom samples (spec 8.7.5.2 —
            # inverse mapping is a picture-reconstruction stage, after
            # all intra neighbour reads)
            if lrows is not None:
                for rs, rx, ry in lrows[r]:
                    x0 = rx * ctb
                    blk = fb.planes[0][y0[ry]:y0[ry + 1],
                                       x0:min(x0 + ctb, pps.width)]
                    blk[:] = lmcs.inv_lut[blk]

        def sao_row(k):
            if sao is None:
                return
            sao.fill_pre(y0[k], min(y0[k + 1] + 1, H))
            sao.run_rows(k, k + 1)

        def alf_prep(k):
            if alf is not None:
                alf.fill_pre(y0[k], y0[k + 1])

        def alf_row(k):
            if alf is not None:
                alf.run_rows(k, k + 1)
            frame.publish_rows(y0[k + 1] if k + 1 < R else H)

        # schedule: recon(t) | V(t-1) | H(t-2) | SAO(t-3) | ALF(t-4) —
        # V lags recon one row (intra prediction of row t reads row t-1's
        # UNFILTERED bottom samples), H lags V one row (its bottom edges
        # read the next row's top taps post-V), SAO one more (row final
        # only after H of the row below writes up the halo), ALF one more
        # (CC-ALF reads one luma row past the CTB, post-SAO).
        for t in range(R + 4):
            if t < R:
                recon_row(t)
            if 1 <= t <= R:
                lmcs_row(t - 1)
                db.deblock_rows(True, t - 1, t)        # V(t-1)
            if 2 <= t <= R + 1:
                db.deblock_rows(False, t - 2, t - 1)   # H(t-2)
            if 3 <= t <= R + 2:
                sao_row(t - 3)
                alf_prep(t - 3)
            if 4 <= t <= R + 3:
                alf_row(t - 4)
        return True

    def _deferred_residuals(self, recon_jobs, fb):
        """Mesh mode: when every CU of an inter frame is inter-predicted
        (no intra/CIIP — those recon with the sequential neighbour walk)
        and every job has the native record walk, produce whole-frame
        residual planes (native residual-only mode) for the sharded
        clip(pred + residual) pass at mesh drain.  Returns the per-plane
        int32 residual list, or None when ineligible."""
        from .ctu import MODE_INTRA
        if not recon_jobs:
            return None
        tabs = recon_jobs[0][0].tabs
        for rec, _ in recon_jobs:
            if rec.native_recon is None:
                return None
        if (tabs.cpm[0] == MODE_INTRA).any() or \
                (tabs.cpm[1] == MODE_INTRA).any() or tabs.mvf_ciip.any():
            return None
        res = [np.zeros(p.shape, np.int32) for p in fb.planes]
        for rec, ctus in recon_jobs:
            rec.native_recon.residual_ctus(ctus, res)
        return res

    def _check_picture_hash(self, frame, dph):
        """Verify decoded planes against a decoded-picture-hash SEI
        (payload type 132, H.274).  MD5 only — each sample little-endian
        (bitDepth+7)//8 bytes, raster order, over the full (pre-crop)
        decoded picture."""
        hash_type, single, hashes = dph
        if hash_type != 0:          # CRC/checksum: not verified
            return
        import hashlib
        bd = frame.buffer.sps.bit_depth   # not self.sps: may run on the
        # pixel worker while a later frame's parse re-activates params
        planes = frame.buffer.planes[:1] if single else frame.buffer.planes
        for c, (p, want) in enumerate(zip(planes, hashes)):
            data = (p.astype(np.uint8) if bd == 8 else
                    p.astype("<u2")).tobytes()
            got = hashlib.md5(data).digest()
            if got != want:
                raise ValueError(
                    f"decoded picture hash mismatch (poc={frame.poc}, "
                    f"component={c}): {got.hex()} != {want.hex()}")

    def _join_pixels(self, why="wait.pixels"):
        """Wait for every queued pixel-stage job (frame pipeline)."""
        futs, self._pix_futures = self._pix_futures, []
        for fut in futs:
            trace.wait(why, fut)

    def _trim_pixels(self, depth):
        """Block until at most `depth` pixel-stage jobs remain queued."""
        while len(self._pix_futures) > depth:
            trace.wait("wait.pixels", self._pix_futures.pop(0))

    def _entry_point_offsets(self, nal, sh_r, sh_end_bits):
        """Byte ranges of each entry point within nal.rbsp (EPB-adjusted;
        reference vvcdec.c:434-490)."""
        start = sh_end_bits // 8
        n_eps = sh_r.num_entry_points + 1
        if n_eps == 1:
            return [(start, len(nal.rbsp))]
        # offsets are in pre-EPB-removal (coded) bytes; each skipped-byte
        # position recorded by remove_epb shortens the rbsp advance by one
        # (reference vvcdec.c:434-445)
        skipped = nal.skipped
        ranges = []
        pos = start
        for i in range(sh_r.num_entry_points):
            off = sh_r.sh_entry_point_offset_minus1[i] + 1
            nskip = sum(1 for s in skipped if pos < s <= pos + off)
            nxt = pos + off - nskip
            ranges.append((pos, nxt))
            pos = nxt
        ranges.append((pos, len(nal.rbsp)))
        return ranges

    @trace.traced("parse.slice")
    def _parse_slice(self, nal, sh, sh_end_bits, tabs, fb, slice_idx,
                     rpl=None, poc=0, collocated=None,
                     native_recon_ok=False):
        """CABAC-parse one slice; returns recon jobs [(Reconstructor,
        [(rs, rx, ry), ...])] to run after the (optional) device itx pass."""
        sps, pps = self.sps, self.pps
        eps = self._entry_point_offsets(nal, sh.r, sh_end_bits)
        ctu_addrs = sh.ctu_addrs
        ctu_index = {rs: i for i, rs in enumerate(ctu_addrs)}
        # partition CTUs across entry points (tiles / WPP rows)
        ep_ctus = self._partition_ctus(ctu_addrs, len(eps))
        jobs = []
        engine_cls = NativeCabacDecoder if (self.config.native_cabac and
                                            load_lib() is not None) \
            else CabacDecoder
        wpp = bool(sps.r.sps_entropy_coding_sync_enabled_flag)
        wpp_states = None  # CABAC state after first CTU of the row above
        # tile entry points are CABAC/StatCoeff-independent (reinit at
        # every tile start): parse them on parse_workers threads.  WPP
        # rows hand CABAC state down and stay sequential.
        from .threads import resolve as _resolve
        par_eps = (not wpp and len(eps) > 1 and
                   _resolve(self.config.parse_workers) > 1)
        pending = []     # deferred (tree, coder, items, tmpl) per EP
        for ep_idx, (ep_range, ctus) in enumerate(zip(eps, ep_ctus)):
            engine = engine_cls(nal.rbsp, ep_range[0] * 8)
            coder = CtuCoder(engine, sps, pps, sh, tabs)
            coder.rpl = rpl
            coder.poc = poc
            coder.collocated_ref = collocated
            self._set_alf_counts(coder, sh)
            if self.config.native_parse:
                from .native.parse import make_native_tree
                coder.native_tree = make_native_tree(coder)
                # keep_records: zero-copy native recon (I slices) / native
                # inter MC + recon (P/B; gated on RPL compatibility)
                if coder.native_tree is not None and native_recon_ok:
                    if sh.slice_type == SLICE_I:
                        from .native.recon import load_lib as recon_lib
                        coder.native_tree.keep_records = \
                            recon_lib() is not None
                    else:
                        from .native.recon import native_inter_ok
                        coder.native_tree.keep_records = \
                            native_inter_ok(coder, fb)
            engine.set_states(None)
            rec = Reconstructor(sps, pps, tabs, fb, coder)
            rec.ph_r = sh.ph
            rec.dep_quant = sh.r.sh_dep_quant_used_flag
            job_ctus = []
            if coder.native_tree is not None and \
                    coder.native_tree.keep_records:
                # batched whole-entry-point parse: all per-CTU work
                # (SAO/ALF params, tree, terminate bits, reinits) in one C
                # call (native/vvc_parse.c parse_ctus)
                from .native.parse import parse_entrypoint
                from .cabac.engine import CTX
                if getattr(self, "_np_wpp_buf", None) is None:
                    self._np_wpp_buf = np.zeros((4, CTX.NUM), np.int32)
                wpp_buf = self._np_wpp_buf
                qp = max(0, min(63, sh.slice_qp_y))
                from .cabac.engine import make_states_np
                tmpl = make_states_np(qp, sh.cabac_init_type)
                items = []
                for i, rs in enumerate(ctus):
                    rx = rs % pps.ctb_width
                    ry = rs // pps.ctb_width
                    ctu_idx = ctu_index[rs]
                    first_in_tile = rx == pps.ctb_to_col_bd[rx] and \
                        ry == pps.ctb_to_row_bd[ry]
                    reinit = realign = wpp_inherit = 0
                    if ctu_idx == 0 or first_in_tile:
                        if i == 0:
                            engine.set_states(make_states(
                                qp, sh.cabac_init_type))
                            coder.init_stat_coeff()
                        else:
                            realign = int(len(eps) == 1)
                            reinit = 1
                    elif wpp and i == 0:
                        engine.set_states([wpp_buf[k].copy()
                                           for k in range(4)])
                        coder.init_stat_coeff()
                    elif wpp and rx == pps.ctb_to_col_bd[rx]:
                        # WPP row start inside the same entry point (legal
                        # when sps_entry_point_offsets_present_flag == 0):
                        # byte-realign past the row's terminate bit, then
                        # inherit the row-above contexts from wpp_buf
                        realign = 1
                        wpp_inherit = 1
                    wpp_save = int(wpp and rx == pps.ctb_to_col_bd[rx])
                    term = 0
                    if rx == pps.ctb_to_col_bd[rx + 1] - 1:
                        if ctu_idx == len(ctu_addrs) - 1 or \
                                ry == pps.ctb_to_row_bd[ry + 1] - 1 or wpp:
                            term = 1
                    items.append((ctu_idx, rs, rx, ry, reinit, realign,
                                  wpp_save, term, slice_idx, wpp_inherit))
                    job_ctus.append((rs, rx, ry))
                # per-CTU deblock params are slice-constant: prefill
                tabs.deblock_disabled[ctus] = int(sh.lf_disabled)
                tabs.deblock_beta[ctus] = sh.beta_offset
                tabs.deblock_tc[ctus] = sh.tc_offset
                if par_eps:
                    pending.append((coder, items, tmpl, wpp_buf, rec,
                                    job_ctus))
                else:
                    with trace.span("parse.tile"):
                        parse_entrypoint(coder.native_tree, coder, items,
                                         tmpl, wpp_buf, job_ctus)
                    from .native.recon import make_native_recon
                    rec.native_recon = make_native_recon(coder, fb, sh.ph)
                jobs.append((rec, job_ctus))
                continue
            for i, rs in enumerate(ctus):
                rx = rs % pps.ctb_width
                ry = rs // pps.ctb_width
                ctu_idx = ctu_index[rs]  # index within slice
                # CABAC (re)init at slice/tile starts
                first_in_tile = rx == pps.ctb_to_col_bd[rx] and \
                    ry == pps.ctb_to_row_bd[ry]
                if ctu_idx == 0 or first_in_tile:
                    if len(eps) == 1 and ctu_idx != 0:
                        # re-align to byte boundary within same entry point
                        engine2 = engine_cls(
                            nal.rbsp, engine.byte_pos_after_terminate() * 8)
                        engine = engine2
                        coder.e = engine
                    qp = max(0, min(63, sh.slice_qp_y))
                    engine.set_states(make_states(qp, sh.cabac_init_type))
                    coder.init_stat_coeff()
                elif wpp and i == 0:
                    # WPP: inherit CABAC state saved after the first CTU of
                    # the row above (schedule_next_parse, vvc_thread.c:261)
                    engine.set_states(tuple(list(x) for x in wpp_states))
                    coder.init_stat_coeff()
                elif wpp and rx == pps.ctb_to_col_bd[rx]:
                    # WPP row start inside one entry point (offsets not
                    # signalled): realign past the row terminate, inherit
                    # the row-above contexts
                    engine2 = engine_cls(
                        nal.rbsp, engine.byte_pos_after_terminate() * 8)
                    engine = engine2
                    coder.e = engine
                    engine.set_states(tuple(list(x) for x in wpp_states))
                    coder.init_stat_coeff()
                coder.coding_tree_unit(ctu_idx, rs, rx, ry, len(ctu_addrs),
                                       slice_idx)
                if wpp and rx == pps.ctb_to_col_bd[rx]:
                    wpp_states = tuple(list(x) for x in engine.states)
                job_ctus.append((rs, rx, ry))
            if coder.native_tree is not None and \
                    coder.native_tree.keep_records:
                from .native.recon import make_native_recon
                rec.native_recon = make_native_recon(coder, fb, sh.ph)
            jobs.append((rec, job_ctus))
        if pending:
            # threaded tile-entry-point parse (the C call releases the GIL;
            # the arena pool is lock-guarded, tab writes are disjoint)
            from .native.parse import parse_entrypoint
            from .native.recon import make_native_recon
            from .threads import run_parallel, resolve
            nt = min(resolve(self.config.parse_workers), len(pending))
            tag = trace.current()

            def parse_tile(c, it, t, w, jc):
                with trace.handed(tag), trace.span("parse.tile"):
                    parse_entrypoint(c.native_tree, c, it, t, w, jc)
            run_parallel(nt, [
                (lambda c=c, it=it, t=t, w=w, jc=jc: parse_tile(
                    c, it, t, w, jc))
                for c, it, t, w, _r, jc in pending])
            for c, _it, _t, _w, rec, _jc in pending:
                rec.native_recon = make_native_recon(c, fb, sh.ph)
        return jobs

    def _partition_ctus(self, ctu_addrs, n_eps):
        """Split a slice's CTUs into entry-point groups (tiles or WPP rows)."""
        if n_eps == 1:
            return [ctu_addrs]
        pps = self.pps
        sps = self.sps
        groups = [[]]
        prev = None
        for rs in ctu_addrs:
            rx = rs % pps.ctb_width
            ry = rs // pps.ctb_width
            if prev is not None:
                new_tile = (rx == pps.ctb_to_col_bd[rx] and
                            ry == pps.ctb_to_row_bd[ry] and
                            (pps.ctb_to_col_bd[rx] != pps.ctb_to_col_bd[prev % pps.ctb_width] or
                             pps.ctb_to_row_bd[ry] != pps.ctb_to_row_bd[prev // pps.ctb_width]))
                new_wpp_row = sps.r.sps_entropy_coding_sync_enabled_flag and \
                    ry != prev // pps.ctb_width
                if new_tile or new_wpp_row:
                    groups.append([])
            groups[-1].append(rs)
            prev = rs
        assert len(groups) == n_eps, (len(groups), n_eps)
        return groups

    def _set_alf_counts(self, coder, sh):
        ps = self.ps
        r = sh.r
        if r.sh_alf_enabled_flag and (r.sh_alf_cb_enabled_flag or
                                      r.sh_alf_cr_enabled_flag):
            aps = ps.aps_alf.get(r.sh_alf_aps_id_chroma)
            if aps is not None:
                coder.num_chroma_alt_filters = \
                    aps.alf_chroma_num_alt_filters_minus1 + 1
        ncc = [0, 0]
        if r.sh_alf_cc_cb_enabled_flag:
            aps = ps.aps_alf.get(r.sh_alf_cc_cb_aps_id)
            if aps is not None:
                ncc[0] = aps.alf_cc_cb_filters_signalled_minus1 + 1
        if r.sh_alf_cc_cr_enabled_flag:
            aps = ps.aps_alf.get(r.sh_alf_cc_cr_aps_id)
            if aps is not None:
                ncc[1] = aps.alf_cc_cr_filters_signalled_minus1 + 1
        coder.num_cc_filters = tuple(ncc)
