# Frozen copy of ffvvc_tpu_torch/bitstream/writer.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none.
"""MSB-first bitstream writer (mirror of reader).

Used by the stream forge (tools/forge.py) to synthesize test bitstreams and by
CBS-round-trip style tests (read(write(x)) == x), mirroring the reference's
cbs-vvc FATE tests (tests/ref/fate/cbs-vvc-*).
"""
from __future__ import annotations


class BitWriter:
    __slots__ = ("bits", "nbits")

    def __init__(self):
        self.bits = 0  # big integer accumulator, MSB-first
        self.nbits = 0

    def u(self, value: int, n: int):
        if n < 0 or (n and value >> n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        self.bits = (self.bits << n) | value
        self.nbits += n

    def flag(self, v):
        self.u(1 if v else 0, 1)

    def ue(self, value: int):
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        v = value + 1
        n = v.bit_length()
        self.u(0, n - 1)
        self.u(v, n)

    def se(self, value: int):
        if value > 0:
            self.ue(2 * value - 1)
        else:
            self.ue(-2 * value)

    def i(self, value: int, n: int):
        self.u(value & ((1 << n) - 1), n)

    def byte_aligned(self) -> bool:
        return (self.nbits & 7) == 0

    def byte_alignment(self):
        self.u(1, 1)
        while not self.byte_aligned():
            self.u(0, 1)

    def rbsp_trailing_bits(self):
        self.u(1, 1)
        while not self.byte_aligned():
            self.u(0, 1)

    def bytes(self) -> bytes:
        if not self.byte_aligned():
            raise ValueError("bitstream not byte aligned")
        return self.bits.to_bytes(self.nbits // 8, "big")
