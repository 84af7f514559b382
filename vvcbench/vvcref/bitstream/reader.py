# Frozen copy of ffvvc_tpu_torch/bitstream/reader.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none.
"""MSB-first bitstream reader for H.266 RBSP payloads.

Reference analogue: the GetBitContext read side used by the CBS layer
(libavcodec/cbs_h2645.c, get_bits.h).  This reader operates on
RBSP bytes (emulation-prevention bytes already removed by bitstream.nal).
"""
from __future__ import annotations


class BitReaderError(Exception):
    pass


class BitReader:
    """Reads bits MSB-first from a bytes-like object."""

    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0  # bit position

    # -- primitive reads ---------------------------------------------------

    def u(self, n: int) -> int:
        """Read n bits as an unsigned integer (f(n)/u(n) descriptors)."""
        if n == 0:
            return 0
        pos = self.pos
        end = pos + n
        if end > self.nbits:
            raise BitReaderError(f"read past end: pos={pos} n={n} total={self.nbits}")
        first_byte = pos >> 3
        last_byte = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first_byte:last_byte], "big")
        shift = 8 * (last_byte - first_byte) - (end - 8 * first_byte)
        self.pos = end
        return (chunk >> shift) & ((1 << n) - 1)

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        """Exp-Golomb ue(v)."""
        # count leading zeros
        zeros = 0
        while True:
            if self.pos >= self.nbits:
                raise BitReaderError("ue(v) ran past end of data")
            if self.u(1):
                break
            zeros += 1
            if zeros > 32:
                raise BitReaderError("ue(v) exceeds 32 leading zeros")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """Exp-Golomb se(v)."""
        k = self.ue()
        if k & 1:
            return (k + 1) >> 1
        return -(k >> 1)

    def i(self, n: int) -> int:
        """Read n bits as a two's-complement signed integer (i(n))."""
        v = self.u(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    # -- positioning -------------------------------------------------------

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def byte_alignment(self):
        """byte_alignment(): alignment_bit_equal_to_one then zeros."""
        one = self.u(1)
        if one != 1:
            raise BitReaderError("byte_alignment: expected bit 1")
        while not self.byte_aligned():
            if self.u(1) != 0:
                raise BitReaderError("byte_alignment: expected bit 0")

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """True if there is payload before rbsp_stop_one_bit (H.266 7.2)."""
        if self.pos >= self.nbits:
            return False
        # find last byte that is non-zero: the stop bit is the lowest set bit
        # of the last non-zero byte.
        data = self.data
        i = len(data) - 1
        while i >= 0 and data[i] == 0:
            i -= 1
        if i < 0:
            return False
        last = data[i]
        # position (from MSB of byte i) of the lowest set bit
        low = 0
        while not (last >> low) & 1:
            low += 1
        stop_pos = 8 * i + (7 - low)
        return self.pos < stop_pos

    def rbsp_trailing_bits(self):
        one = self.u(1)
        if one != 1:
            raise BitReaderError("rbsp_trailing_bits: expected stop bit 1")
        while not self.byte_aligned():
            if self.u(1) != 0:
                raise BitReaderError("rbsp_trailing_bits: expected bit 0")

    def skip(self, n: int):
        if self.pos + n > self.nbits:
            raise BitReaderError("skip past end")
        self.pos += n
