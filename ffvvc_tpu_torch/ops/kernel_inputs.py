"""Seeded NumPy inputs for the SAO, ALF, CC-ALF and MC put kernels.

The kernels' checks (chip_smoke.py on the card, tests/test_torch_kernels.py
and tests/test_torch_mc.py on the CPU) feed them the parameter layouts the
fused chain and device MC build, with random values from a numpy Generator.
"""
from __future__ import annotations

import numpy as np

from .alf_device import _CHROMA_SLOT

# filter sets in a seeded ALF table
N_SETS = 5


def _grid(n, size):
    return -(-n // size)


def _samples(rng, shape, bd):
    return rng.integers(0, 1 << bd, shape).astype(np.int16)


def sao_inputs(rng, H, W, cs_v, cs_h, bd):
    """(plane int16 [H, W], per-CTB params) in `_sao_ctb_params` layout
    (`sao_device.pack_params` packs them for the wrapper)."""
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
    return _samples(rng, (H, W), bd), p


def _alf_tables(rng, shape, bd):
    cf = rng.integers(-128, 128, shape).astype(np.int32)
    clip_set = np.array([1 << bd, 1 << (bd - 3), 1 << (bd - 5),
                         1 << (bd - 7)], np.int32)
    return cf, clip_set[rng.integers(0, 4, shape)]


def alf_luma_inputs(rng, H, W, cs, bd):
    """Luma ALF: (src int16 [H, W], ci, ti int32 [H / 4, W / 4], ctb_set
    int32 [ch, cw], cf_tab, cl_tab int32 [N_SETS, 25, 12])."""
    cf, cl = _alf_tables(rng, (N_SETS, 25, 12), bd)
    blocks = (H // 4, W // 4)
    ci = rng.integers(0, 25, blocks).astype(np.int32)
    ti = rng.integers(0, 4, blocks).astype(np.int32)
    ctb_set = rng.integers(0, N_SETS, (_grid(H, cs), _grid(W, cs)))
    return (_samples(rng, (H, W), bd), ci, ti, ctb_set.astype(np.int32), cf,
            cl)


def alf_chroma_inputs(rng, H, W, cs_v, cs_h, bd):
    """Chroma ALF of one plane: (src int16 [H, W], ctb_set int32 [ch, cw],
    cf_tab, cl_tab int32 [N_SETS, 12]); the slots chroma does not use hold
    cf 0 and cl 1, as `_alf_ctb_params` builds them."""
    cf, cl = _alf_tables(rng, (N_SETS, 12), bd)
    unused = np.ones(12, bool)
    unused[list(_CHROMA_SLOT)] = False
    cf[:, unused] = 0
    cl[:, unused] = 1
    ctb_set = rng.integers(0, N_SETS, (_grid(H, cs_v), _grid(W, cs_h)))
    return _samples(rng, (H, W), bd), ctb_set.astype(np.int32), cf, cl


def cc_inputs(rng, Hc, Wc, cs, hs, vs, bd, n=2):
    """CC-ALF of n chroma planes: (dsts n x int16 [Hc, Wc], luma int16
    [Hc << vs, Wc << hs], ctb_sets n x int32 [ch, cw], cf_tabs n x int32
    [N_SETS, 7]) for CTBs of cs luma samples; set 0 holds zeros (no
    correction), as `_alf_ctb_params` builds it."""
    grid = (_grid(Hc, cs >> vs), _grid(Wc, cs >> hs))
    ctb_sets, cf_tabs = [], []
    for _ in range(n):
        cf = rng.integers(-64, 65, (N_SETS, 7)).astype(np.int32)
        cf[0] = 0
        cf_tabs.append(cf)
        ctb_sets.append(rng.integers(0, N_SETS, grid).astype(np.int32))
    dsts = [_samples(rng, (Hc, Wc), bd) for _ in range(n)]
    luma = _samples(rng, (Hc << vs, Wc << hs), bd)
    return dsts, luma, ctb_sets, cf_tabs


def edge_words(rng, ch, cw):
    """Random int32 [ch, cw] edge words (`alf_device.EDGE_*` bits), the
    picture's border always set: what a picture with random slices and
    tiles that filtering must not cross gives ALF and CC-ALF."""
    e = rng.integers(0, 16, (ch, cw)).astype(np.int32)
    e[:, 0] |= 1
    e[0, :] |= 2
    e[:, -1] |= 4
    e[-1, :] |= 8
    return e


def sao_restore_inputs(rng, H, W, cs_v, cs_h, bd):
    """(plane int16 [H, W], table int32 [11, ch, cw]): SAO's per-CTB table
    with random kept ranges on every edge-offset CTB, as a picture with
    random slices and one tile per CTB column gives them
    (`sao_device.ctb_tables`)."""
    ch, cw = _grid(H, cs_v), _grid(W, cs_h)
    tab = np.zeros((11, ch, cw), np.int32)
    tab[0] = rng.integers(0, 3, (ch, cw))
    tab[1] = np.where(tab[0] == 1, rng.integers(0, 32, (ch, cw)),
                      rng.integers(0, 4, (ch, cw)))
    tab[2:7] = rng.integers(-31, 32, (5, ch, cw))
    h = np.minimum(cs_v, H - np.arange(ch) * cs_v)[:, None]
    w = np.minimum(cs_h, W - np.arange(cw) * cs_h)[None, :]
    for row, size in ((7, h), (8, h), (9, w), (10, w)):
        lo = rng.integers(0, 3, (ch, cw))
        hi = size - rng.integers(0, 3, (ch, cw))
        on = (tab[0] == 2) & (rng.integers(0, 2, (ch, cw)) != 0) & (lo < hi)
        tab[row] = np.where(on, lo | (hi << 16), 0)
    return _samples(rng, (H, W), bd), tab


# (w, h, is_luma) of the puts device MC sends: luma and chroma blocks from
# 2x2 to 128x128, and (copies only) the 6x6 PROF rings and the (w + 2) x
# (h + 2) BDOF rings of 8x8, 16x8 and 16x16 subblocks
PUT_SIZES = ((4, 4), (8, 4), (4, 8), (8, 8), (16, 16), (32, 16), (8, 32),
             (64, 64), (128, 128))
PUT_CHROMA_SIZES = ((2, 2), (2, 4), (4, 2), (4, 4), (8, 8), (16, 16),
                    (32, 32), (64, 64))
PUT_RINGS = ((6, 6), (10, 10), (18, 10), (18, 18))


def put_inputs(rng, H, W, bd, blocks=4):
    """Reference planes (int16 luma [H, W], chroma [H / 2, W / 2]) and put
    buckets in `mc_device.put_table_of`'s form, one for each variant of the
    put kernel: the four filter classes of every size in PUT_SIZES (luma)
    and PUT_CHROMA_SIZES (chroma), the rings of PUT_RINGS as copies, each
    plain, with horizontal wraparound, with DMVR boxes (some reaching past
    the plane) and with both.  A bucket's first four blocks overhang the
    plane's left, right, top and bottom border; the others lie anywhere
    from a block's width outside to inside."""
    planes = [_samples(rng, (H, W), bd), _samples(rng, (H // 2, W // 2), bd)]
    kinds = [(w, h, True, range(4)) for w, h in PUT_SIZES] + \
        [(w, h, False, range(4)) for w, h in PUT_CHROMA_SIZES] + \
        [(w, h, True, (0,)) for w, h in PUT_RINGS]
    buckets = []
    for w, h, luma, fclasses in kinds:
        k = 0 if luma else 1
        ph, pw = planes[k].shape
        fmax = 16 if luma else 32
        for fclass in fclasses:
            for wrap, boxed in ((0, False), (pw - 8, False), (0, True),
                                (pw - 8, True)):
                xs = rng.integers(-w - 8, pw + 8, blocks)
                ys = rng.integers(-h - 8, ph + 8, blocks)
                for i, (axis, v) in enumerate(
                        ((0, -w // 2 - 3), (0, pw - w // 2),
                         (1, -h // 2 - 3), (1, ph - h // 2))[:blocks]):
                    (xs, ys)[axis][i] = v
                cols = [xs, ys,
                        rng.integers(1, fmax, blocks) * (fclass & 1),
                        rng.integers(1, fmax, blocks) * (fclass >> 1)]
                if boxed:
                    x0 = rng.integers(-4, pw, blocks)
                    y0 = rng.integers(-4, ph, blocks)
                    cols += [x0, x0 + rng.integers(0, 2 * w + 8, blocks),
                             y0, y0 + rng.integers(0, 2 * h + 8, blocks)]
                hf = int(rng.integers(0, 3))
                vf = hf if rng.integers(0, 2) else int(rng.integers(0, 3))
                buckets.append((k, (ph, pw),
                                np.stack(cols, 1).astype(np.int32), w, h,
                                luma, hf, vf, fclass, wrap, boxed))
    return planes, buckets
