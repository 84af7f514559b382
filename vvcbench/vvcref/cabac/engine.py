# Frozen copy of ffvvc_tpu_torch/cabac/engine.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none (its tables _ctx_layout.json and _ctx_tables.npz are copied beside it).
"""VVC CABAC arithmetic coding engine (decoder + encoder).

Implements the H.266 binary arithmetic decoder of clause 9.3.4.3 — the
two-probability-state, per-context adaptive engine with window sizes — and
its encoder mirror (9.3.4.4), used by the stream forge.

Context initialization follows 9.3.2.2: initValue -> (m, n) -> preCtxState,
with per-context adaptation shifts from the shiftIdx table.  The init tables
(`_ctx_tables.npz`, extracted from the spec constants) cover 378 contexts in
the element order of `_ctx_layout.json`.

Reference analogue: libavcodec/vvc/vvc_cabac.c:813-948
(engine) and :111-792 (init tables).  The implementation here follows the
spec register formulation (range/offset), not ffmpeg's low/mask trick.
"""
from __future__ import annotations

import functools
import json
import os

import numpy as np

_DIR = os.path.dirname(__file__)


@functools.lru_cache()
def init_values() -> np.ndarray:
    return np.load(os.path.join(_DIR, "_ctx_tables.npz"))["init_values"]


@functools.lru_cache()
def ctx_layout():
    with open(os.path.join(_DIR, "_ctx_layout.json")) as f:
        d = json.load(f)
    return d["num_contexts"], {k: tuple(v) for k, v in d["layout"].items()}


class _CtxNamespace:
    """Attribute access to context offsets: CTX.SIG_COEFF_FLAG etc."""

    def __init__(self):
        n, layout = ctx_layout()
        self.NUM = n
        for name, (off, cnt) in layout.items():
            setattr(self, name, off)
            setattr(self, name + "_N", cnt)


CTX = _CtxNamespace()


@functools.lru_cache(maxsize=256)
def make_states_np(qp: int, init_type: int):
    """Per-slice context init states as a read-only (4, NUM) int32 array
    (state0, state1, shift0, shift1) — cached per (qp, init_type)."""
    import numpy as np
    iv = init_values()
    qp = max(0, min(63, qp))
    row = iv[init_type].astype(np.int64)
    shift_row = iv[3].astype(np.int64)
    m = (row >> 3) - 4
    v = ((row & 7) * 18) + 1
    pre = np.clip(((m * (qp - 16)) >> 1) + v, 1, 127)
    sh0 = (shift_row >> 2) + 2
    out = np.ascontiguousarray(np.stack(
        [pre << 3, pre << 7, sh0, (shift_row & 3) + 3 + sh0]
    ).astype(np.int32))
    out.setflags(write=False)
    return out


def make_states(qp: int, init_type: int):
    """Per-slice context state arrays (state0, state1, shift0, shift1) as
    mutable Python lists (engines update states in place).

    qp: clipped slice luma QP; init_type: 0/1/2 per slice type and
    sh_cabac_init_flag (9.3.2.2).
    """
    return [r.tolist() for r in make_states_np(qp, init_type)]


class CabacDecoder:
    """H.266 9.3.4.3 arithmetic decoder over a byte buffer."""

    __slots__ = ("data", "nbits", "pos", "range", "offset", "states")

    def __init__(self, data: bytes, bit_pos: int, states=None):
        """bit_pos must be byte-aligned (start of slice data / entry point)."""
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = bit_pos
        self.states = states
        self.range = 510
        self.offset = self._read_bits(9)

    def _read_bits(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        nbits = self.nbits
        for _ in range(n):
            bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1 if pos < nbits else 0
            v = (v << 1) | bit
            pos += 1
        self.pos = pos
        return v

    def set_states(self, states):
        self.states = states

    def decode_bin(self, idx: int) -> int:
        s0, s1, sh0, sh1 = self.states
        st0 = s0[idx]
        st1 = s1[idx]
        p = st1 + (st0 << 4)
        val_mps = p >> 14
        lps = (((self.range >> 5) * ((32767 - p if val_mps else p) >> 9)) >> 1) + 4
        rng = self.range - lps
        if self.offset >= rng:
            bit = 1 - val_mps
            self.offset -= rng
            rng = lps
        else:
            bit = val_mps
        # renormalize
        data = self.data
        nbits = self.nbits
        pos = self.pos
        offset = self.offset
        while rng < 256:
            rng <<= 1
            b = (data[pos >> 3] >> (7 - (pos & 7))) & 1 if pos < nbits else 0
            offset = (offset << 1) | b
            pos += 1
        self.pos = pos
        self.offset = offset
        self.range = rng
        a = sh0[idx]
        s0[idx] = st0 - (st0 >> a) + ((1023 * bit) >> a)
        b_ = sh1[idx]
        s1[idx] = st1 - (st1 >> b_) + ((16383 * bit) >> b_)
        return bit

    def decode_bypass(self) -> int:
        pos = self.pos
        b = (self.data[pos >> 3] >> (7 - (pos & 7))) & 1 if pos < self.nbits else 0
        self.pos = pos + 1
        offset = (self.offset << 1) | b
        if offset >= self.range:
            self.offset = offset - self.range
            return 1
        self.offset = offset
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        """end_of_slice/tile/wpp one-bit (ctxIdx term). 1 = terminated."""
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            pos = self.pos
            b = (self.data[pos >> 3] >> (7 - (pos & 7))) & 1 if pos < self.nbits else 0
            self.offset = (self.offset << 1) | b
            self.pos = pos + 1
        return 0

    def byte_pos_after_terminate(self) -> int:
        """Byte offset just after a terminate==1 (for entry-point math).

        After termination the decoder has consumed `pos` bits of which the
        last 8·k must align; the spec resumes at the next byte boundary.
        """
        return (self.pos + 7) >> 3

    # --- binarizations (9.3.3) -------------------------------------------

    def truncated_rice(self, c_rice: int, c_max_pre: int):
        raise NotImplementedError

    def truncated_binary(self, c_max: int) -> int:
        """9.3.3.4 truncated binary over bypass bins."""
        n = c_max + 1
        if n <= 1:
            return 0
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        v = self.decode_bypass_bits(k)
        if v >= u:
            v = (v << 1) | self.decode_bypass()
            v -= u
        return v

    def limited_egk(self, k: int, max_pre_ext_len: int, trunc_suffix_len: int) -> int:
        """9.3.3.6 limited k-th order Exp-Golomb over bypass bins."""
        pre_ext_len = 0
        while pre_ext_len < max_pre_ext_len and self.decode_bypass():
            pre_ext_len += 1
        if pre_ext_len == max_pre_ext_len:
            escape_length = trunc_suffix_len
        else:
            escape_length = pre_ext_len + k
        val = self.decode_bypass_bits(escape_length) if escape_length > 0 else 0
        val += ((1 << pre_ext_len) - 1) << k
        return val


class CabacEncoder:
    """H.266 9.3.4.4 arithmetic encoder (PutBit register formulation)."""

    __slots__ = ("low", "range", "bits_outstanding", "first_bit",
                 "nbits", "states", "_out", "_cur", "_curn")

    def __init__(self, states=None):
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        # chunked MSB-first accumulator: a big-int grows to megabits and
        # makes every 1-bit append O(n) (quadratic whole-frame encode);
        # flush 32-bit words into a bytearray instead
        self._out = bytearray()
        self._cur = 0
        self._curn = 0
        self.nbits = 0
        self.states = states

    def _emit(self, bits: int, n: int):
        cur = (self._cur << n) | bits
        curn = self._curn + n
        while curn >= 32:
            curn -= 32
            self._out += ((cur >> curn) & 0xFFFFFFFF).to_bytes(4, "big")
            cur &= (1 << curn) - 1
        self._cur = cur
        self._curn = curn
        self.nbits += n

    def _put_bit(self, b: int):
        if self.first_bit:
            self.first_bit = False
        else:
            self._emit(b, 1)
        if self.bits_outstanding:
            n = self.bits_outstanding
            self._emit(((1 << n) - 1) if not b else 0, n)
            self.bits_outstanding = 0

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.bits_outstanding += 1
                self.low -= 256
            self.range <<= 1
            self.low <<= 1

    def encode_bin(self, idx: int, bit: int):
        s0, s1, sh0, sh1 = self.states
        st0 = s0[idx]
        st1 = s1[idx]
        p = st1 + (st0 << 4)
        val_mps = p >> 14
        lps = (((self.range >> 5) * ((32767 - p if val_mps else p) >> 9)) >> 1) + 4
        self.range -= lps
        if bit != val_mps:
            self.low += self.range
            self.range = lps
        self._renorm()
        a = sh0[idx]
        s0[idx] = st0 - (st0 >> a) + ((1023 * bit) >> a)
        b_ = sh1[idx]
        s1[idx] = st1 - (st1 >> b_) + ((16383 * bit) >> b_)

    def encode_bypass(self, bit: int):
        self.low <<= 1
        if bit:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def encode_bypass_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bit: int):
        self.range -= 2
        if bit:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self):
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        # WriteBits(((low >> 7) & 3) | 1, 2)
        self._emit(((self.low >> 7) & 3) | 1, 2)

    def bytes_aligned(self) -> bytes:
        """Final bitstream, zero-padded to byte alignment (the flush's final
        1-bit doubles as rbsp_stop_one_bit)."""
        pad = (-self.nbits) % 8
        tail_n = self._curn + pad
        tail = self._cur << pad
        out = bytes(self._out) + tail.to_bytes((tail_n + 7) // 8, "big") \
            if tail_n else bytes(self._out)
        return out

    def truncated_binary(self, value: int, c_max: int):
        n = c_max + 1
        if n <= 1:
            return
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        if value < u:
            self.encode_bypass_bits(value, k)
        else:
            self.encode_bypass_bits(value + u, k + 1)

    def limited_egk(self, value: int, k: int, max_pre_ext_len: int,
                    trunc_suffix_len: int):
        pre_ext_len = 0
        v = value
        while pre_ext_len < max_pre_ext_len and v >= (1 << (pre_ext_len + k)):
            v -= 1 << (pre_ext_len + k)
            pre_ext_len += 1
        for _ in range(pre_ext_len):
            self.encode_bypass(1)
        if pre_ext_len == max_pre_ext_len:
            self.encode_bypass_bits(v, trunc_suffix_len)
        else:
            self.encode_bypass(0)
            if pre_ext_len + k > 0:
                self.encode_bypass_bits(v, pre_ext_len + k)
