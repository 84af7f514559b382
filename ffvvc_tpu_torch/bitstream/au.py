"""Access-unit assembly for streaming input.

Splits a raw Annex-B byte stream into access units (one coded picture plus
its non-VCL NALs), so a caller can feed a decoder packet-by-packet.

Reference analogue: libavcodec/vvc_parser.c:345-482 — AU
boundary detection: a new AU starts at an AUD/OPI/DCI, or at the first VCL
NAL carrying a new picture header (PH NAL, or slice header with
sh_picture_header_in_slice_header_flag set), spec 7.4.2.4.3.
"""
from __future__ import annotations

from .nal import NalType, NalUnit, is_vcl, split_annexb
from .reader import BitReader


def _starts_new_picture(nal: NalUnit) -> bool:
    """VCL NAL with sh_picture_header_in_slice_header_flag == 1 (first bit
    of the slice header, after the 2-byte NAL header)."""
    if not is_vcl(nal.type):
        return False
    if not nal.rbsp:
        return False
    return bool(nal.rbsp[0] >> 7)


def split_access_units(stream: bytes):
    """Yield lists of NalUnit, one list per access unit (decode order)."""
    au = []
    saw_vcl = False
    for nal in split_annexb(stream):
        t = nal.type
        boundary = False
        if t in (NalType.AUD, NalType.OPI, NalType.DCI):
            boundary = True
        elif saw_vcl:
            # after the AU's VCL NALs, the next picture starts at a PH NAL,
            # a parameter set, or a VCL slice that embeds its own PH
            if t in (NalType.PH, NalType.VPS, NalType.SPS, NalType.PPS,
                     NalType.PREFIX_APS, NalType.AUD):
                boundary = True
            elif _starts_new_picture(nal):
                boundary = True
        if boundary and au:
            yield au
            au = []
            saw_vcl = False
        au.append(nal)
        if is_vcl(t):
            saw_vcl = True
    if au:
        yield au


def split_access_unit_bytes(stream: bytes):
    """Same as split_access_units but yields raw Annex-B byte chunks
    (re-emitted with 4-byte start codes), suitable for decoder.decode()."""
    for au in split_access_units(stream):
        yield b"".join(b"\x00\x00\x00\x01" + n.raw for n in au)


# --- POC-based AU boundary detection (vvc_parser.c:199-331) -----------------

_INT_MAX = 2**31 - 1


class AuDetector:
    """Reference AuDetector semantics (vvc_parser.c:39-43, 240-269;
    spec 7.4.2.4.3): an AU starts at a slice whose nuh_layer_id does not
    increase, or whose PicOrderCntVal changes.  POC follows the VTM
    simplification the reference documents (get_slice_poc,
    vvc_parser.c:202-239): IDR resets MSB, others derive it from the POC of
    the previous tid0 reference picture."""

    def __init__(self):
        self.prev_layer_id = 255
        self.prev_poc = _INT_MAX
        self.prev_tid0_poc = _INT_MAX

    def slice_poc(self, sps, ph, nal_unit_type):
        max_lsb = 1 << (sps.sps_log2_max_pic_order_cnt_lsb_minus4 + 4)
        lsb = ph.ph_pic_order_cnt_lsb
        if nal_unit_type in (NalType.IDR_W_RADL, NalType.IDR_N_LP):
            msb = ph.ph_poc_msb_cycle_val * max_lsb \
                if ph.ph_poc_msb_cycle_present_flag else 0
        elif ph.ph_poc_msb_cycle_present_flag:
            msb = ph.ph_poc_msb_cycle_val * max_lsb
        else:
            prev = self.prev_tid0_poc
            prev_lsb = prev & (max_lsb - 1)
            prev_msb = prev - prev_lsb
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
        return msb + lsb

    def is_au_start(self, nal: NalUnit, ph, poc: int) -> bool:
        start = (nal.nuh_layer_id <= self.prev_layer_id or
                 poc != self.prev_poc)
        self.prev_layer_id = nal.nuh_layer_id
        self.prev_poc = poc
        if nal.nuh_temporal_id_plus1 == 1 and not ph.ph_non_ref_pic_flag \
                and nal.type not in (NalType.RADL, NalType.RASL):
            self.prev_tid0_poc = poc
        return start


def split_access_units_poc(stream: bytes):
    """POC-based AU split (the reference parser's semantics): yields lists
    of NalUnit per AU.  Picture units are segmented structurally (the
    reference's find_frame_end, vvc_parser.c:126-168 — what
    `split_access_units` implements), then consecutive PUs merge into one
    AU while `is_au_start` says the POC did not change and the layer id
    increased (multi-layer AUs; spec 7.4.2.4.3)."""
    from .h266 import (H266ParamSets, read_sps, read_pps, read_aps,
                       read_picture_header, read_slice_header)

    ps = H266ParamSets()
    det = AuDetector()
    au = []
    for pu in split_access_units(stream):
        first = None
        for nal in pu:
            t = nal.type
            if t == NalType.SPS:
                ps.store_sps(read_sps(BitReader(nal.rbsp),
                                      nal.nuh_layer_id))
            elif t == NalType.PPS:
                ps.store_pps(read_pps(BitReader(nal.rbsp), ps))
            elif t in (NalType.PREFIX_APS, NalType.SUFFIX_APS):
                ps.store_aps(read_aps(BitReader(nal.rbsp)))
            elif t == NalType.PH:
                ps.ph = read_picture_header(BitReader(nal.rbsp), ps)
            elif first is None and is_vcl(t):
                first = nal
                sh = read_slice_header(BitReader(nal.rbsp), ps, int(t))
        if first is None:      # parameter-set-only PU: attach forward
            au += pu
            continue
        ph = sh.ph
        pps = ps.pps[ph.ph_pic_parameter_set_id]
        sps = ps.sps[pps.pps_seq_parameter_set_id]
        poc = det.slice_poc(sps, ph, int(first.type))
        if det.is_au_start(first, ph, poc) and au:
            yield au
            au = []
        au += pu
    if au:
        yield au


def split_access_unit_bytes_poc(stream: bytes):
    """POC-based variant of split_access_unit_bytes."""
    for au in split_access_units_poc(stream):
        yield b"".join(b"\x00\x00\x00\x01" + n.raw for n in au)
