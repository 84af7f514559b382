# Frozen copy of ffvvc_tpu_torch/ops/data.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none (moved to the package root, with _data_tables.npz).
"""Normative H.266 constant tables.

Two sources:
  * closed-form generators for everything the spec defines by formula or by
    a compact kernel: DCT-2 / DST-7 / DCT-8 transform matrices (8.7.4.3),
    diagonal scan order (6.5.2), the intra fG smoothing filter (Table 25),
    GPM weights; and
  * `_data_tables.npz`, extracted by tools/extract_tables.py — the spec's
    literal integer tables (LFNST & MIP matrices, interpolation filter banks,
    ALF fixed filters, GPM index tables, scaling-list defaults).

Reference analogue: libavcodec/vvc/vvc_data.c (the same
normative constants as C arrays).
"""
from __future__ import annotations

import functools
import os

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "_data_tables.npz")


@functools.lru_cache()
def tables():
    # materialize: NpzFile.__getitem__ decompresses on EVERY access
    with np.load(_NPZ) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# Transform matrices (H.266 8.7.4.3)
# ---------------------------------------------------------------------------
# The DCT-2 family is defined by one set of per-size odd-row kernels; row r of
# the N-point matrix equals row r*(64/N) of the 64-point matrix restricted to
# its first N columns.  All entries reduce to a single "cosine table" c[t]
# (t in units of pi/128) built from the per-size kernels below.

_DCT2_ODD = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
    64: [91, 90, 90, 90, 88, 87, 86, 84, 83, 81, 79, 77, 73, 71, 69, 65,
         62, 59, 56, 52, 48, 44, 41, 37, 33, 28, 24, 20, 15, 11, 7, 2],
}

_DST7_KERNEL = {
    4: [29, 55, 74, 84],
    8: [17, 32, 46, 60, 71, 78, 85, 86],
    16: [8, 17, 25, 33, 40, 48, 55, 62, 68, 73, 77, 81, 85, 87, 88, 88],
    32: [4, 9, 13, 17, 21, 26, 30, 34, 38, 42, 46, 50, 53, 56, 60, 63,
         66, 68, 72, 74, 77, 78, 80, 82, 84, 85, 86, 87, 88, 89, 90, 90],
}


@functools.lru_cache()
def _cos_table():
    """c[t] = transMatrix value for angle t*pi/128, t in [0, 128]."""
    c = np.zeros(129, dtype=np.int64)
    c[0] = 64
    for size, kernel in _DCT2_ODD.items():
        step = 64 // size * 2  # odd multiples at this level
        base = 64 // size
        for i, v in enumerate(kernel):
            c[base * (2 * i + 1)] = v
    return c


def _cos_lookup(t: int) -> int:
    c = _cos_table()
    t %= 256
    if t > 128:
        t = 256 - t
    if t > 64:
        return -int(c[128 - t])
    return int(c[t])


@functools.lru_cache()
def dct2_matrix(n: int) -> np.ndarray:
    """Forward DCT-2 transform matrix transMatrix[n][n] (rows = basis)."""
    m = np.zeros((n, n), dtype=np.int32)
    step = 64 // n
    for i in range(n):
        for j in range(n):
            m[i, j] = _cos_lookup(i * step * (2 * j + 1))
    return m


def _sin_lookup(m: int, n: int, kernel) -> int:
    """round(scale*sin(m*pi/(2n+1))) via the kernel list (index 1..n)."""
    period = 2 * (2 * n + 1)
    m %= period
    sign = 1
    if m > 2 * n + 1:
        sign = -1
        m = m - (2 * n + 1)
    if m > n:  # sin(pi - x) = sin(x)
        m = 2 * n + 1 - m
    if m == 0:
        return 0
    return sign * kernel[m - 1]


@functools.lru_cache()
def dst7_matrix(n: int) -> np.ndarray:
    """transMatrix for DST-VII: m[i][j] = sin((2i+1)(j+1)pi/(2n+1)) scaled."""
    kernel = _DST7_KERNEL[n]
    m = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        for j in range(n):
            m[i, j] = _sin_lookup((2 * i + 1) * (j + 1), n, kernel)
    return m


@functools.lru_cache()
def dct8_matrix(n: int) -> np.ndarray:
    """transMatrix for DCT-VIII: m[i][j] = cos((2i+1)(2j+1)pi/(4n+2)) scaled.

    cos(m*pi/(4n+2)) == sin((2n+1-m)*pi/(4n+2)) reduces to the same kernel.
    """
    kernel = _DST7_KERNEL[n]
    mtx = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        for j in range(n):
            m0 = (2 * i + 1) * (2 * j + 1)
            period = 2 * (4 * n + 2)
            m0 %= period
            sign = 1
            if m0 > 4 * n + 2:  # cos(2pi - x) = cos(x)
                m0 = period - m0
            if m0 > 2 * n + 1:  # cos(pi - x) = -cos(x)
                sign = -1
                m0 = (4 * n + 2) - m0
            k = (2 * n + 1 - m0) // 2
            mtx[i, j] = sign * (kernel[k - 1] if k >= 1 else 0)
    return mtx


# self-check against the spec's literal small-matrix patterns
def _verify_matrices():
    a, b, c, d = _DST7_KERNEL[4]
    expect_dst7_4 = np.array([
        [a, b, c, d],
        [c, c, 0, -c],
        [d, -a, -c, b],
        [b, -d, c, -a]], dtype=np.int32)
    assert (dst7_matrix(4) == expect_dst7_4).all(), dst7_matrix(4)
    m4 = dct2_matrix(4)
    aa, bb, cc = 64, 83, 36
    expect_dct2_4 = np.array([
        [aa, aa, aa, aa],
        [bb, cc, -cc, -bb],
        [aa, -aa, -aa, aa],
        [cc, -bb, bb, -cc]], dtype=np.int32)
    assert (m4 == expect_dct2_4).all(), m4
    # row-subsampling property
    assert (dct2_matrix(32)[:, :16][::2] == dct2_matrix(16)).all()
    assert (dct8_matrix(4)[0] == [84, 74, 55, 29]).all(), dct8_matrix(4)


_verify_matrices()


# ---------------------------------------------------------------------------
# scan order (6.5.2) and misc generated tables
# ---------------------------------------------------------------------------

@functools.lru_cache()
def diag_scan(w: int, h: int):
    """Up-right diagonal scan: returns array [(x, y), ...] of length w*h."""
    order = []
    for s in range(w + h - 1):
        for y in range(min(s, h - 1), -1, -1):
            x = s - y
            if x < w:
                order.append((x, y))
    return np.array(order, dtype=np.int32)


@functools.lru_cache()
def intra_filter(filter_type: int) -> np.ndarray:
    """Intra interpolation filters fC (type 0) / fG (type 1), Table 25."""
    if filter_type == 0:
        return tables()["intra_filter_c"].astype(np.int32)
    f = np.arange(32, dtype=np.int32)
    return np.stack([16 - (f >> 1), 32 - (f >> 1), 16 + (f >> 1), f >> 1], axis=1)


def _verify_scans():
    # spec-known vectors (6.5.2): 2x4 block and the 8x8 head
    s24 = diag_scan(2, 4)
    assert s24[:, 0].tolist() == [0, 0, 1, 0, 1, 0, 1, 1]
    assert s24[:, 1].tolist() == [0, 1, 0, 2, 1, 3, 2, 3]
    s88 = diag_scan(8, 8)
    assert s88[:6].tolist() == [[0, 0], [0, 1], [1, 0], [0, 2], [1, 1], [2, 0]]


_verify_scans()


# quantization: levelScale[rectNonTsFlag][qP%6] (8.7.3)
LEVEL_SCALE = np.array([
    [40, 45, 51, 57, 64, 72],
    [57, 64, 72, 80, 90, 102]], dtype=np.int32)
