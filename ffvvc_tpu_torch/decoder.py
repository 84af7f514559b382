"""Decoder of the port: `ffvvc_tpu.decoder.VVCDecoder` with the device
half in PyTorch.

The host half (NAL dispatch, parameter sets, DPB, CABAC parse, native C
recon, host filters) is the JAX package's, inherited.  `_decode_frame` is
a copy of `ffvvc_tpu/decoder.py`'s, kept diffable line by line against it,
with the device dispatch replaced:

  * the device itx call is dropped (the native recon's own transforms run);
  * the row-pipeline gate and the fused-chain gate test `device_pipeline`,
    and the fused chain is this package's (`ops/fused_device.py`), run on
    `config.device`;
  * the branches of the toggles the port refuses (`device_mc`,
    `device_intra`, `device_lmcs`, `device_deblock`, `device_sao`,
    `device_alf`, a mesh) are removed: `DecoderConfig` raises on them.

The decoder therefore never reaches the JAX package's device modules.
"""
from __future__ import annotations

import os

import numpy as np

from ffvvc_tpu import decoder as _ref
from ffvvc_tpu.bitstream import NalType, is_idr, is_rap
from ffvvc_tpu.bitstream.h266 import SLICE_I
from ffvvc_tpu import ps as derived
from ffvvc_tpu.ctu import FrameTabs
from ffvvc_tpu.recon import FrameBuffer

from .config import DecoderConfig

FLAG_OUTPUT, FLAG_SHORT_REF = _ref.FLAG_OUTPUT, _ref.FLAG_SHORT_REF
FLAG_LONG_REF = _ref.FLAG_LONG_REF
DecodedFrame = _ref.DecodedFrame


class VVCDecoder(_ref.VVCDecoder):
    """VVC decoder whose fused post-recon filter chain runs in PyTorch on
    `config.device` (see the module docstring)."""

    def __init__(self, config: DecoderConfig = None):
        config = config or DecoderConfig()
        if not isinstance(config, DecoderConfig):
            raise TypeError("ffvvc_tpu_torch.VVCDecoder needs an "
                            "ffvvc_tpu_torch.DecoderConfig")
        super().__init__(config)

    def _decode_frame(self, ph, slices):
        # per-stage timing (config.profile; reference VVC_THREAD_DEBUG
        # task-trace analogue, vvc_thread.c:568-603)
        if self.config.profile:
            import time as _time
            _t = [_time.monotonic()]

            def _stage(name):
                now = _time.monotonic()
                self.stage_times[name] = self.stage_times.get(name, 0.0) + \
                    (now - _t[0])
                _t[0] = now
        else:
            def _stage(name):
                pass
        self._stage = _stage
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
                from ffvvc_tpu.inter import InterPredictor
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

        _stage("parse")

        # inter MC needs its REFERENCE frames' filtered pixels — and only
        # those: the host analogue of the reference's per-frame progress
        # wait (schedule_inter, vvc_thread.c:281-296).  Frames this frame
        # does not predict from (e.g. non-referenced B leaves of a
        # hierarchical GOP) keep their pixel stages in flight, overlapping
        # this frame's MC and the next frames' parse.  The queue is then
        # trimmed to config.pipeline_depth to bound in-flight memory (the
        # reference's deep frame contexts, vvcdec.c:830-841).
        row_wait_refs = None
        if is_inter_frame:
            if os.environ.get("FFVVC_RPL_GATE", "1") == "0":  # A/B toggle
                self._join_pixels()
            all_native = all(not hasattr(ip, "c")
                             for ip, _ in inter_jobs)
            if self.config.row_progress and all_native:
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
                        fut.result()
        # with row gating the reference frames stay in flight: keep
        # one extra pixel job queued so their rolling filters overlap
        # this frame's MC (memory still bounded by pipeline_depth)
        self._trim_pixels(max(1, self.config.pipeline_depth) -
                          (0 if row_wait_refs else 1))

        # (device itx is not ported: the native recon's transforms run)
        _stage("itx")
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
        if native_mc:
            # MC CTUs are data-independent (refs are other frames; DMVR
            # col-grid writes are per-CU disjoint): thread batched C calls
            # (inter_ctus: one ctypes call per contiguous same-job run)
            from ffvvc_tpu.threads import resolve, run_parallel, split_ranges
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

            run_parallel(nt, [
                (lambda lo=lo, hi=hi: mc_chunk(lo, hi))
                for lo, hi in split_ranges(len(native_mc), nt)])
        _stage("inter")

        dph, self._pending_dph = self._pending_dph, None

        # snapshot ALF state on THIS thread: pixel_stages may run on the
        # frame-pipeline worker while the main thread's handle(PREFIX_APS)
        # mutates self.ps.aps_alf for a later AU — a frame must be filtered
        # with the APS contents active when its slices arrived
        alf_list = sh_list = None
        if sps.r.sps_alf_enabled_flag:
            from ffvvc_tpu.alf import VVCALF
            alf_list = {i: VVCALF(a) for i, a in self.ps.aps_alf.items()}
            sh_list = [sh_by_slice.get(i) for i in
                       range(max(sh_by_slice) + 1)]

        def pixel_stages():
            # recon / LMCS / deblock / SAO / ALF: no later frame's PARSE
            # depends on these (TMVP reads the col MV grids written at
            # parse/inter time), so they overlap frame N+1's parse on the
            # frame pipeline (config.pipeline_frames)
            cfg = self.config
            # the rolling row pipeline only pays off when a later inter
            # frame can overlap its MC with this frame's filters: all-
            # intra streams keep the (stage-threaded) whole-frame passes
            if (cfg.row_progress and cfg.pipeline_frames
                    and self._seen_inter and not cfg.device_pipeline):
                if self._pixel_stages_rows(frame, sps, pps, tabs, fb,
                                           recon_jobs, lmcs, sh_list,
                                           alf_list):
                    _stage("rows")
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
            fused = cfg.device_pipeline
            # fused: defer recon's residual add for inter-only frames
            # (no intra/CIIP CUs — those need the sequential neighbour
            # walk) so the add runs as a batched device pass
            defer_res = self._deferred_residuals(recon_jobs, fb) \
                if (fused and is_inter_frame) else None
            if defer_res is None:
                for rec, ctus in recon_jobs:
                    nr = rec.native_recon
                    if nr is not None:
                        nr.reconstruct_ctus(ctus)   # one C call per job
                    else:
                        for rs, rx, ry in ctus:
                            rec.reconstruct_ctu(rs, rx, ry)
            _stage("recon")
            if fused:
                from .ops.fused_device import fused_frame_filters
                if fused_frame_filters(sps, pps, tabs, fb, sh_list,
                                       alf_list, lmcs, recon_jobs,
                                       frame.slice_rpls,
                                       res_planes=defer_res,
                                       device=cfg.device):
                    _stage("fused")
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
            if lmcs is not None:
                ctb = sps.ctb_size_y
                for rec, ctus in recon_jobs:
                    if not rec.lmcs_used:
                        continue
                    for rs, rx, ry in ctus:
                        x0, y0 = rx * ctb, ry * ctb
                        x1 = min(x0 + ctb, pps.width)
                        y1 = min(y0 + ctb, pps.height)
                        blk = fb.planes[0][y0:y1, x0:x1]
                        blk[:] = lmcs.inv_lut[blk]
            _stage("lmcs")
            # in-loop filters (whole-frame passes per spec 8.8)
            from ffvvc_tpu.deblock import Deblocker
            from ffvvc_tpu.threads import resolve
            db = Deblocker(sps, pps, tabs, fb)
            db.slice_rpls = frame.slice_rpls
            db.n_threads = resolve(self.config.stage_threads)
            db.deblock_frame()
            _stage("deblock")
            from ffvvc_tpu.sao import SaoFilter
            sf = SaoFilter(sps, pps, tabs, fb)
            sf.n_threads = resolve(self.config.stage_threads)
            sf.sao_frame()
            if alf_list is not None:
                done = False
                if self.config.native_alf:
                    from ffvvc_tpu.native.alf import alf_frame_native
                    done = alf_frame_native(
                        sps, pps, tabs, fb, sh_list, alf_list,
                        resolve(self.config.stage_threads))
                if not done:
                    from ffvvc_tpu.alf import AlfFilter
                    AlfFilter(sps, pps, tabs, fb, sh_list,
                              alf_list).alf_frame()
            _stage("sao_alf")
            if dph is not None and self.config.verify_picture_hash:
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

            def pixel_stages_published():
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
