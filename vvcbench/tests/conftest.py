"""CPU tests of the benchmark (`python -m pytest vvcbench/tests -q`).

They put the benchmark's directory and the repository root on sys.path,
as `vvcbench/run.py` does, and keep every forged input and reference
record of a test session in one temporary cache."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# the small size the CPU tests run the cells at (both CTU-128 cells need
# whole 8-sample units and at least two CTU columns)
SIZE = (416, 240)


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("vvcbench_cache"))
