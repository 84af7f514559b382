# Frozen copy of ffvvc_tpu_torch/bitstream/nal.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none.
"""Annex-B NAL unit extraction and emulation-prevention removal.

Reference analogue: libavcodec/h2645_parse.c (ff_h2645_packet_split)
— start-code scan, 00 00 03 emulation-prevention-byte (EPB) removal, NAL header
parse.  The skipped-byte positions are retained because slice entry-point
offsets are expressed in pre-EPB-removal bytes (reference: vvcdec.c:438-444).
"""
from __future__ import annotations

import dataclasses
import enum


class NalType(enum.IntEnum):
    """H.266 Table 5 nal_unit_type."""
    TRAIL = 0
    STSA = 1
    RADL = 2
    RASL = 3
    RSV_VCL_4 = 4
    RSV_VCL_5 = 5
    RSV_VCL_6 = 6
    IDR_W_RADL = 7
    IDR_N_LP = 8
    CRA = 9
    GDR = 10
    RSV_IRAP_11 = 11
    OPI = 12
    DCI = 13
    VPS = 14
    SPS = 15
    PPS = 16
    PREFIX_APS = 17
    SUFFIX_APS = 18
    PH = 19
    AUD = 20
    EOS = 21
    EOB = 22
    PREFIX_SEI = 23
    SUFFIX_SEI = 24
    FD = 25
    RSV_NVCL_26 = 26
    RSV_NVCL_27 = 27
    UNSPEC_28 = 28
    UNSPEC_29 = 29
    UNSPEC_30 = 30
    UNSPEC_31 = 31


def is_vcl(t: int) -> bool:
    return t <= NalType.RSV_IRAP_11


def is_idr(t: int) -> bool:
    return t in (NalType.IDR_W_RADL, NalType.IDR_N_LP)


def is_irap(t: int) -> bool:
    return NalType.IDR_W_RADL <= t <= NalType.CRA


def is_rap(t: int) -> bool:
    """Random access point (IRAP or GDR)."""
    return NalType.IDR_W_RADL <= t <= NalType.GDR


@dataclasses.dataclass
class NalUnit:
    nal_unit_type: int
    nuh_layer_id: int
    nuh_temporal_id_plus1: int
    rbsp: bytes           # payload with the 2-byte NAL header stripped and EPBs removed
    skipped: list         # positions (in rbsp coords) where an EPB was removed
    raw_size: int         # size of the NAL payload incl. header, pre-EPB-removal
    raw: bytes = b""      # original NAL bytes incl. header (no start code)

    @property
    def temporal_id(self) -> int:
        return self.nuh_temporal_id_plus1 - 1

    @property
    def type(self) -> NalType:
        return NalType(self.nal_unit_type)


def remove_epb(data: bytes):
    """Strip 00 00 03 emulation prevention bytes.

    Returns (rbsp, skipped_positions) where skipped positions index into the
    *output* rbsp (the byte offset at which an input byte was dropped), needed
    to convert entry-point offsets from coded- to rbsp-byte units.
    """
    if b"\x00\x00\x03" not in data:
        return data, []
    # find()-driven (EPBs are sparse; a per-byte Python loop was ~45% of a
    # 1080p decode).  Greedy leftmost match, resume after the dropped 03 —
    # identical to the byte-scan semantics.
    out = bytearray()
    skipped = []
    pos, n = 0, len(data)
    while True:
        j = data.find(b"\x00\x00\x03", pos)
        if j < 0 or j + 2 >= n:
            out += data[pos:]
            break
        out += data[pos:j + 2]
        skipped.append(len(out))
        pos = j + 3
    return bytes(out), skipped


def insert_epb(rbsp: bytes) -> bytes:
    """Insert emulation prevention bytes (encode direction, for the forge).
    find()-driven equivalent of the stateful zeros-counter byte scan: a 03
    is inserted before any byte <= 3 preceded by two zero bytes, and the
    zero run restarts after each insertion."""
    out = bytearray()
    pos, n = 0, len(rbsp)
    j = 0
    while True:
        j = rbsp.find(b"\x00\x00", j)
        if j < 0 or j + 2 >= n:
            out += rbsp[pos:]
            break
        if rbsp[j + 2] <= 3:
            out += rbsp[pos:j + 2]
            out.append(3)
            pos = j + 2
            j = j + 2
        else:
            j += 1
    return bytes(out)


def split_annexb(data: bytes):
    """Split an Annex-B byte stream into NAL units.

    Accepts 3- or 4-byte start codes.  Returns a list of NalUnit.
    """
    nals = []
    n = len(data)
    # find first start code
    i = data.find(b"\x00\x00\x01")
    if i < 0:
        return nals
    i += 3
    while i < n:
        nxt = data.find(b"\x00\x00\x01", i)
        if nxt < 0:
            payload = data[i:]
            i = n
        else:
            end = nxt
            # trailing zero of a 4-byte start code belongs to the start code
            while end > i and data[end - 1] == 0:
                end -= 1
            payload = data[i:end]
            i = nxt + 3
        if len(payload) < 2:
            continue
        nal = parse_nal(payload)
        if nal is not None:
            nals.append(nal)
    return nals


def parse_nal(payload: bytes):
    """Parse one NAL unit (header + EPB removal). payload excludes start code."""
    b0, b1 = payload[0], payload[1]
    forbidden = b0 >> 7
    if forbidden:
        return None
    nuh_layer_id = b0 & 0x3F
    nal_unit_type = b1 >> 3
    tid_plus1 = b1 & 0x07
    if tid_plus1 == 0:
        return None
    rbsp, skipped = remove_epb(payload[2:])
    return NalUnit(
        nal_unit_type=nal_unit_type,
        nuh_layer_id=nuh_layer_id,
        nuh_temporal_id_plus1=tid_plus1,
        rbsp=rbsp,
        skipped=skipped,
        raw_size=len(payload),
        raw=payload,
    )


def write_nal(nal_unit_type: int, rbsp: bytes, layer_id: int = 0,
              temporal_id: int = 0, long_startcode: bool = True) -> bytes:
    """Serialize one NAL unit with start code + header + EPB insertion."""
    header = bytes([layer_id & 0x3F, ((nal_unit_type & 0x1F) << 3) | (temporal_id + 1)])
    sc = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    return sc + header + insert_epb(rbsp)
