#!/usr/bin/env python3
"""Read the control of `correct` on this machine, at the cell's own size:
for each seed, a run of the cell with the frozen reference in the port's
place at 9 of its 10 bits (`--bits 9`, which has to read not correct) or
at full precision (`--bits 10`, which has to read correct).  Prints one
JSON line a seed with the numbers compared.

    python3 vvcbench/control.py --workload ai1080.seg2 --seeds 11 12 13
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bits", type=int, default=9)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness import cells, control, runner
    import ffvvc_tpu_torch as port
    import torch
    cell = cells.cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    real = port.VVCDecoder
    for seed in args.seeds:
        cache = runner.Cache(cell, seed, None)
        segs = runner.load_segments(cache, cell, seed, None, None)
        port.VVCDecoder = control.with_bits(
            args.bits, segs, cell.traffic, cell.config["bit_depth"])
        try:
            r = runner.run(cell, seed, args.seconds, False, device=device)
        finally:
            port.VVCDecoder = real
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "bits": args.bits, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"]}),
              flush=True)


if __name__ == "__main__":
    main()
