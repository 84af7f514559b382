"""The frozen bound arithmetic against `chip_smoke.py`'s bounds at its
1080p shapes (CTB 32, every CTB on, 5 filter sets)."""
import numpy as np
import pytest

from harness import roofline as R

H, W, C = 1080, 1920, 32
CH, CW = -(-H // C), -(-W // C)
ON = np.ones((CH, CW), bool)


def us(work):
    return R.least_s(*work) * 1e6


def test_sao():
    work = R.sao_work([(H, W), (H // 2, W // 2), (H // 2, W // 2)],
                      [(C, C), (C // 2, C // 2), (C // 2, C // 2)],
                      [np.full((CH, CW), 2)] * 3)
    assert round(work[0] / 1e6, 3) == 12.711
    assert round(us(work), 2) == 3.79


def test_alf_luma_by_operations():
    work = R.alf_luma_work(H, W, C, ON, 5)
    assert round(work[0] / 1e6, 3) == 9.351
    assert round(max(work[1]) / R.PEAK_PIPE_OPS_S * 1e6, 2) == 6.31
    assert round(us(work), 2) == 6.31


def test_alf_chroma():
    work = R.alf_chroma_work(H // 2, W // 2, C // 2, C // 2, [ON, ON], [5, 5])
    assert round(work[0] / 1e6, 3) == 4.164
    assert round(us(work), 2) == 1.67


def test_cc_alf():
    work = R.cc_work(H // 2, W // 2, C // 2, C // 2, [ON, ON], [5, 5], 4)
    assert round(work[0] / 1e6, 3) == 8.311
    assert round(us(work), 2) == 2.48


@pytest.mark.parametrize("stage", R.STAGES)
def test_off_ctbs_count_nothing(stage):
    nctb = CH * CW
    off = np.zeros((nctb, 3), np.int32)
    got = R.frame_work(H, W, C, 1, 1, off, off, 0, [0, 0],
                       np.zeros((nctb, 2), np.int32))
    assert got[stage] == 0.0
