"""Intra-frame stage threading over GIL-releasing native calls.

The reference scales within a frame via its 8-stage CTU task DAG on a
pthread pool (vvc_thread.c).  Our native stages (inter MC, deblock) release
the GIL for the duration of each C call, so a small shared thread pool
gives the same within-frame parallelism for stages whose work items are
data-independent (MC CTUs; deblock row/column shards).  GOP-parallel
worker processes set stage_threads=1 to avoid oversubscription.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor


def resolve(stage_threads: int) -> int:
    if stage_threads and stage_threads > 0:
        return stage_threads
    return os.cpu_count() or 1


_EXECS = {}


def executor(n: int) -> ThreadPoolExecutor:
    """Shared pool, keyed by (pid, n): a forked child must NOT inherit the
    parent's cached executor — its worker threads do not exist after
    fork, while the executor's bookkeeping still lists them, so submits
    would queue forever (this deadlocked GOP workers parsing multi-
    entry-point streams whenever the parent had parsed one first)."""
    key = (os.getpid(), n)
    ex = _EXECS.get(key)
    if ex is None:
        ex = _EXECS[key] = ThreadPoolExecutor(max_workers=n)
    return ex


def run_parallel(n: int, thunks) -> None:
    """Run thunks on the shared pool; re-raise the first exception."""
    thunks = list(thunks)
    if n <= 1 or len(thunks) <= 1:
        for t in thunks:
            t()
        return
    futs = [executor(n).submit(t) for t in thunks]
    for f in futs:
        f.result()


def split_ranges(total: int, parts: int):
    """[(lo, hi)] covering [0, total) in <= parts contiguous chunks."""
    parts = max(1, min(parts, total))
    step = -(-total // parts)
    return [(lo, min(lo + step, total)) for lo in range(0, total, step)]
