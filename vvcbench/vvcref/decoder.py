"""Decode loop of the frozen reference: the golden model's host path.

Original: `ffvvc_tpu_torch/decoder.py` (itself a copy of
`ffvvc_tpu/decoder.py`; reference analogue libavcodec/vvc/vvcdec.c).
Changes, all of them cuts: the decoder runs only what backend "golden"
ran there, with every native library gone (see the package's
`__init__.py`): NAL dispatch, parameter sets, POC, DPB and output order,
slice RPLs, the Python CABAC parse (`CtuCoder.coding_tree_unit`), Python
inter prediction and reconstruction, host LMCS, the Python deblocking,
SAO and ALF.  Cut: `DecoderConfig` (no options remain), the device
stages, the mesh, the frame pipeline and its row progress, the native
parse, recon, MC and ALF, error resilience, the picture-hash check, the
stage clock.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bitstream import split_annexb, BitReader, NalType, is_vcl, is_idr, is_rap
from .bitstream.h266 import (H266ParamSets, read_sps, read_pps, read_aps,
                             read_vps, read_picture_header, read_slice_header,
                             SLICE_I)
from . import ps as derived
from .cabac.engine import CabacDecoder, make_states
from .ctu import CtuCoder, FrameTabs
from .recon import FrameBuffer, Reconstructor


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
    """Annex-B bytes in, decoded frames out in output (POC bumping) order,
    matching the reference DPB logic (vvc_refs.c:196-292)."""

    def __init__(self):
        self.ps = H266ParamSets()
        self.sps = None
        self.pps = None
        self.prev_poc = 0
        self.dpb = []           # DecodedFrame entries with flags
        self.seq_decode = 0
        self.seq_output = 0
        # GDR recovery state (decode_recovery_flag/poc, vvc_ps.c:745-761)
        self.last_eos = 1
        self.no_output_before_recovery = 0
        self.gdr_recovery_point_poc = 0
        self.gdr_recovered = True

    def decode(self, data: bytes):
        """Decode a whole Annex-B stream; all frames in output order."""
        nals = split_annexb(data)
        out = []
        cur_slices = []
        cur_ph = None

        def flush_frame():
            nonlocal cur_slices, cur_ph
            if cur_slices:
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
            elif t in (NalType.EOS, NalType.EOB):
                flush_frame()
                self.last_eos = 1
            # AUD/FD/OPI/DCI: no decoder state

        for nal in nals:
            handle(nal)
        flush_frame()
        out.extend(self._output_frames(flush=True))
        for f in list(self.dpb):
            f.flags = 0
            self._unref_check(f)
        return out

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
        self.dpb.append(frame)
        outputs = self._output_frames()
        self._bump_frame(poc)

        is_inter_frame = any(s[1].sh_slice_type != SLICE_I for s in slices)
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
        for slice_idx_in_frame, (nal, sh_r, sh_end_bits) in enumerate(slices):
            sh = derived.SH(sh_r, ph, sps, pps)
            sh_by_slice[sh.slice_idx] = sh
            if sh.slice_type != SLICE_I:
                rpl, collocated = self._build_slice_rpl(frame, sh, poc)
                if sps.r.sps_smvd_enabled_flag:
                    derived.smvd_ref_idx(sh, rpl, poc)
            else:
                rpl, collocated = [derived.RefPicList(),
                                   derived.RefPicList()], None
            while len(frame.slice_rpls) <= sh.slice_idx:
                frame.slice_rpls.append(rpl)
            frame.slice_rpls[sh.slice_idx] = rpl
            jobs = self._parse_slice(nal, sh, sh_end_bits, tabs, fb,
                                     slice_idx_in_frame, rpl=rpl, poc=poc,
                                     collocated=collocated)
            for rec, _ in jobs:
                if scaling_list is not None:
                    rec.scaling_list = scaling_list
                    rec.explicit_sl_used = \
                        bool(sh.r.sh_explicit_scaling_list_used_flag)
                if lmcs is not None:
                    rec.lmcs = lmcs
                    rec.lmcs_used = bool(sh.r.sh_lmcs_used_flag)
                    rec.chroma_scale_on = \
                        bool(ph.ph_chroma_residual_scale_flag)
            recon_jobs.extend(jobs)
            if sh.slice_type != SLICE_I:
                from .inter import InterPredictor
                for rec, ctus in jobs:
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

        # inter MC pass (reference INTER task stage precedes RECON,
        # vvc_thread.c:41-51)
        for ip, ctus in inter_jobs:
            for rs, rx, ry in ctus:
                ip.c.decode_neighbour(rx << sps.ctb_log2_size_y,
                                      ry << sps.ctb_log2_size_y,
                                      rx, ry, rs)
                ip.predict_inter_ctu(rs)

        for rec, ctus in recon_jobs:
            for rs, rx, ry in ctus:
                rec.reconstruct_ctu(rs, rx, ry)
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
        # in-loop filters (whole-frame passes per spec 8.8), written for the
        # benchmark apart from the port's (inloop.py)
        from . import inloop
        fr = inloop.Frame(sps, pps, ph, [sh_by_slice.get(i) for i in
                                         range(max(sh_by_slice) + 1)],
                          tabs, fb.planes, frame.slice_rpls)
        inloop.deblock(fr)
        inloop.sao(fr)
        inloop.alf(fr, self.ps.aps_alf)
        return outputs

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

    def _parse_slice(self, nal, sh, sh_end_bits, tabs, fb, slice_idx,
                     rpl=None, poc=0, collocated=None):
        """CABAC-parse one slice; returns recon jobs [(Reconstructor,
        [(rs, rx, ry), ...])]."""
        sps, pps = self.sps, self.pps
        eps = self._entry_point_offsets(nal, sh.r, sh_end_bits)
        ctu_addrs = sh.ctu_addrs
        ctu_index = {rs: i for i, rs in enumerate(ctu_addrs)}
        # partition CTUs across entry points (tiles / WPP rows)
        ep_ctus = self._partition_ctus(ctu_addrs, len(eps))
        jobs = []
        wpp = bool(sps.r.sps_entropy_coding_sync_enabled_flag)
        wpp_states = None  # CABAC state after first CTU of the row above
        for ep_range, ctus in zip(eps, ep_ctus):
            engine = CabacDecoder(nal.rbsp, ep_range[0] * 8)
            coder = CtuCoder(engine, sps, pps, sh, tabs)
            coder.rpl = rpl
            coder.poc = poc
            coder.collocated_ref = collocated
            self._set_alf_counts(coder, sh)
            engine.set_states(None)
            rec = Reconstructor(sps, pps, tabs, fb, coder)
            rec.ph_r = sh.ph
            rec.dep_quant = sh.r.sh_dep_quant_used_flag
            job_ctus = []
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
                        engine2 = CabacDecoder(
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
                    engine2 = CabacDecoder(
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
            jobs.append((rec, job_ctus))
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
