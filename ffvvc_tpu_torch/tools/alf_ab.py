"""Time the luma ALF kernel of another revision against this tree's.

    git show REV:ffvvc_tpu_torch/csrc/filters.cu > other/filters.cu
    python -m ffvvc_tpu_torch.tools.alf_ab other/filters.cu [--args 13]

Both kernels run in one process on the same tensors, in turns, each timed
by the replay of a CUDA graph of 256 launches (`chip_smoke.graph_ms`), so
that neither the inputs nor the call nor the card's state differ between
them; times of different processes compare only to about 2%.  The other
revision's csrc/filters.cu is compiled with this tree's nvcc flags; for
a revision from before the slab rows (the mesh), `--args` is the number of
arguments of its `ffvvc_alf_luma`, which took the plane's height and width:
14 with the edge words, 13 without (before the per-stage filters).  Two
seeded input sets at 1080p10, CTB 32: the kernel's time depends on the
classes and filter sets drawn by a few tenths of a microsecond.  Needs an
NVIDIA GPU and nvcc; run from the repository root.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="the other revision's csrc/filters.cu")
    ap.add_argument("--args", type=int, choices=(13, 14), default=None)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    from ..ops import _build, alf_device
    from ..ops.kernel_inputs import alf_luma_inputs
    from ..ops.device import Slab, stream_of

    print(smoke.card())
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "other.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        args.source], check=True)
        other = ctypes.CDLL(so).ffvvc_alf_luma
    P, I = ctypes.c_void_p, ctypes.c_int
    old = args.args is not None
    other.argtypes = [P, P] + ([I, I] if old else [P, I]) + \
        [P, P, P, I, P, P] + [P] * ((args.args or 14) - 13) + [I, I, P]
    other.restype = I
    dev = torch.device("cuda", 0)
    H, W, cs, bd = smoke.H, smoke.W, smoke.CTB, smoke.BD
    pix_max = (1 << bd) - 1
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        src, ci, ti, ctb_set, cf, cl = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in alf_luma_inputs(rng, H, W, cs, bd))

        def ours():
            return alf_device.alf_filter_luma(src, ci, ti, ctb_set, cf, cl,
                                              cs, pix_max)

        def theirs():
            out = torch.empty_like(src)
            rows = (H,) if old else (Slab.whole(H).args(H),)
            _build.check(other(
                src.data_ptr(), out.data_ptr(), *rows, W, ci.data_ptr(),
                ti.data_ptr(), ctb_set.data_ptr(), ctb_set.shape[1],
                cf.data_ptr(), cl.data_ptr(),
                *[None] * ((args.args or 14) - 13), cs.bit_length() - 1,
                pix_max, stream_of(dev)), "the other ffvvc_alf_luma")
            return out
        if not torch.equal(ours(), theirs()):
            raise AssertionError("the two kernels disagree")
        for _ in range(args.turns):
            print(f"seed {seed}: other {smoke.graph_ms([theirs]) * 1e3:.2f} "
                  f"us, this tree {smoke.graph_ms([ours]) * 1e3:.2f} us")


if __name__ == "__main__":
    main()
