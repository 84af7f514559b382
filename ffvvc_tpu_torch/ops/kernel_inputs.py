"""Seeded NumPy inputs for the SAO, ALF and CC-ALF kernels.

The kernels' checks (chip_smoke.py on the card, tests/test_torch_kernels.py
on the CPU against the JAX package) feed them the parameter layouts the
fused chain builds, with random values from a numpy Generator.
"""
from __future__ import annotations

import numpy as np

from ffvvc_tpu.alf import (ALF_BORDER_LUMA, ALF_BORDER_CHROMA,
                           ALF_VB_POS_ABOVE_LUMA, ALF_VB_POS_ABOVE_CHROMA)

from .alf_device import _CHROMA_SLOT
from .fused_device import _alf_vb_arrays, _cc_arrays


def _grid(n, size):
    return -(-n // size)


def sao_inputs(rng, H, W, cs_v, cs_h, bd):
    """(plane [H, W], per-CTB params) in `_sao_ctb_params` layout."""
    ch, cw = _grid(H, cs_v), _grid(W, cs_h)

    def ints(lo, hi, shape=(ch, cw)):
        return rng.integers(lo, hi, shape).astype(np.int32)
    typ = ints(0, 3)
    p = dict(typ=typ,
             m1=np.where(typ == 1, ints(0, 32), ints(0, 4)).astype(np.int32),
             offs=ints(-31, 32, (5, ch, cw)),
             kl=ints(0, 2), kr=ints(0, 2), kt=ints(0, 2), kb=ints(0, 2),
             ax=ints(0, 2),
             bx=rng.choice(np.array([cs_h - 1, cs_h, 1 << 30], np.int32),
                           (ch, cw)))
    return ints(0, 1 << bd, (H, W)), p


def alf_inputs(rng, H, W, cs_v, cs_h, bd, luma):
    """ALF of one plane: (cur [H, W], rowsel [7, H], vbsel [H],
    cf/cl [nby, nbx, 12], blk_log2_h, blk_log2_w) with 4x4 blocks for
    luma and cs_v x cs_h CTBs for chroma; the slots chroma does not use
    hold cf 0 and cl 1, as `_alf_ctb_params` builds them."""
    border = ALF_BORDER_LUMA if luma else ALF_BORDER_CHROMA
    above = ALF_VB_POS_ABOVE_LUMA if luma else ALF_VB_POS_ABOVE_CHROMA
    rowsel, vbsel = _alf_vb_arrays(H, cs_v, border, above, luma)
    l2h = 2 if luma else cs_v.bit_length() - 1
    l2w = 2 if luma else cs_h.bit_length() - 1
    shape = (_grid(H, 1 << l2h), _grid(W, 1 << l2w), 12)
    cf = rng.integers(-128, 128, shape).astype(np.int32)
    clip_set = np.array([1 << bd, 1 << (bd - 3), 1 << (bd - 5),
                         1 << (bd - 7)], np.int32)
    cl = clip_set[rng.integers(0, 4, shape)]
    if not luma:
        unused = np.ones(12, bool)
        unused[list(_CHROMA_SLOT)] = False
        cf[:, :, unused] = 0
        cl[:, :, unused] = 1
    cur = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    return cur, rowsel, vbsel, cf, cl, l2h, l2w


def cc_inputs(rng, Hc, Wc, cs, hs, vs, bd):
    """CC-ALF of one chroma plane: (dst [Hc, Wc], luma [Hc << vs,
    Wc << hs], rowsel [4, Hc], skip [Hc], cf [ch, cw, 7])."""
    rowsel, skip = _cc_arrays(Hc, cs, vs)
    shape = (_grid(Hc, cs >> vs), _grid(Wc, cs >> hs), 7)
    cf = rng.integers(-64, 65, shape).astype(np.int32)
    dst = rng.integers(0, 1 << bd, (Hc, Wc)).astype(np.int32)
    luma = rng.integers(0, 1 << bd, (Hc << vs, Wc << hs)).astype(np.int32)
    return dst, luma, rowsel, skip, cf
