#!/usr/bin/env python3
"""Run one cell of the benchmark of `ffvvc_tpu_torch` once, on this
machine's cards.

    python3 vvcbench/run.py --workload ai1080.seg2 --seed 7 --seconds 30 \
        --trace 0

Prints the checks (each number compared beside its limit) as the last
lines of standard error and one JSON object as the last line of standard
output: the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`.  Exits non-zero, with no result, without enough
CUDA cards, without the port beside the benchmark, or when JAX or the JAX
package was loaded.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    sys.path[:0] = [p for p in (HERE, root) if p not in sys.path]
    # one thread for torch's and the math libraries' own pools, in this
    # process and in the ones it spawns: the port's threads are its own
    for k in THREAD_VARS:
        os.environ[k] = "1"
    from harness import cells, runner
    try:
        cell = cells.cell(args.workload)
    except (FileNotFoundError, KeyError) as e:
        print(f"vvcbench: no cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"vvcbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    try:
        import ffvvc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"vvcbench: the port is not beside the benchmark: {e!r}",
              file=sys.stderr)
        return 4
    try:
        result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                            t0=T0)
    except RuntimeError as e:
        print(f"vvcbench: {e}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
