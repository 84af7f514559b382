"""MP4 (ISO BMFF) VVC front-end: vvcC decoder-configuration-record parsing
and length-prefixed-sample -> Annex-B conversion.

Reference analogue: libavcodec/bsf/vvc_mp4toannexb.c (the
bitstream filter) and libavformat/vvc.c (vvcC record read/write,
ISO/IEC 14496-15 section 11.2.4.2).
"""
from __future__ import annotations

import dataclasses

from .reader import BitReader


@dataclasses.dataclass
class VvcDecoderConfigurationRecord:
    length_size: int                  # bytes per NAL length prefix (1/2/4)
    ptl_present: bool
    nal_units: list                   # [(nal_unit_type, bytes)] Annex-B-less
    chroma_format_idc: int = 0
    bit_depth_minus8: int = 0
    max_picture_width: int = 0
    max_picture_height: int = 0


def parse_vvcc(data: bytes) -> VvcDecoderConfigurationRecord:
    """Parse a VvcDecoderConfigurationRecord (the 'vvcC' box payload)."""
    r = BitReader(data)
    r.u(5)                            # reserved '11111'
    length_size = r.u(2) + 1
    ptl_present = bool(r.u(1))
    rec = VvcDecoderConfigurationRecord(length_size, ptl_present, [])
    if ptl_present:
        r.u(9)                        # ols_idx
        num_sublayers = r.u(3)
        r.u(2)                        # constant_frame_rate
        rec.chroma_format_idc = r.u(2)
        rec.bit_depth_minus8 = r.u(3)
        r.u(5)                        # reserved '11111'
        # VvcPTLRecord
        r.u(2)                        # reserved
        num_bytes_constraint_info = r.u(6)
        r.u(7)                        # general_profile_idc
        r.u(1)                        # general_tier_flag
        r.u(8)                        # general_level_idc
        r.u(1)                        # ptl_frame_only_constraint
        r.u(1)                        # ptl_multi_layer_enabled
        if num_bytes_constraint_info:
            r.u(8 * num_bytes_constraint_info - 2)
        sublayer_present = [r.u(1) for _ in range(num_sublayers - 1)] \
            if num_sublayers > 1 else []
        if num_sublayers > 1:
            r.u(8 - (num_sublayers - 1))  # ptl_reserved_zero_bit padding
        for p in sublayer_present:
            if p:
                r.u(8)                # sublayer_level_idc
        num_sub_profiles = r.u(8)
        for _ in range(num_sub_profiles):
            r.u(32)
        rec.max_picture_width = r.u(16)
        rec.max_picture_height = r.u(16)
        r.u(16)                       # avg_frame_rate
    num_arrays = r.u(8)
    for _ in range(num_arrays):
        r.u(1)                        # array_completeness
        r.u(2)                        # reserved
        nal_unit_type = r.u(5)
        num_nalus = 1 if nal_unit_type in (13, 20) else r.u(16)  # DCI/OPI
        for _ in range(num_nalus):
            ln = r.u(16)
            pos = r.pos // 8
            rec.nal_units.append((nal_unit_type, data[pos:pos + ln]))
            r.pos += 8 * ln
    return rec


def vvcc_extradata_to_annexb(data: bytes) -> bytes:
    """Parameter-set NALs from a vvcC record as an Annex-B chunk."""
    rec = parse_vvcc(data)
    return b"".join(b"\x00\x00\x00\x01" + nal for _, nal in rec.nal_units)


def mp4_sample_to_annexb(sample: bytes, length_size: int) -> bytes:
    """Convert one length-prefixed MP4 sample to Annex-B (the
    vvc_mp4toannexb BSF's per-packet transform)."""
    out = bytearray()
    i, n = 0, len(sample)
    while i + length_size <= n:
        ln = int.from_bytes(sample[i:i + length_size], "big")
        i += length_size
        if ln <= 0 or i + ln > n:
            raise ValueError("malformed length-prefixed sample")
        out += b"\x00\x00\x00\x01"
        out += sample[i:i + ln]
        i += ln
    return bytes(out)


def write_vvcc(nal_units, length_size: int = 4) -> bytes:
    """Minimal VvcDecoderConfigurationRecord (ptl_present=0) from
    [(nal_unit_type, nal_bytes)] — the libavformat/vvc.c writer's skeleton."""
    out = bytearray()
    out.append((0x1F << 3) | ((length_size - 1) << 1) | 0)
    by_type = {}
    for t, nal in nal_units:
        by_type.setdefault(t, []).append(nal)
    out.append(len(by_type))
    for t, nals in sorted(by_type.items()):
        out.append(t & 0x1F)
        if t not in (13, 20):
            out += len(nals).to_bytes(2, "big")
        for nal in nals:
            out += len(nal).to_bytes(2, "big")
            out += nal
    return bytes(out)


def annexb_to_mp4_sample(stream: bytes, length_size: int = 4) -> bytes:
    """Inverse helper (testing): Annex-B chunk -> length-prefixed sample."""
    from .nal import split_annexb
    out = bytearray()
    for nal in split_annexb(stream):
        out += len(nal.raw).to_bytes(length_size, "big")
        out += nal.raw
    return bytes(out)
