"""Cells, configurations, traffic mixes and per-layer metrics, found by name.

`BENCHMARK.json` at the root of the checkout lists them; each
configuration is `configs/<config>.json`, each traffic mix
`traffic/<traffic>.json` and each per-layer metric a reader
`metrics/<name>.py`, all beside this package.  A cell is added by adding
those files and an entry, never by editing a file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # BENCHMARK.json metrics this cell reports
    per_layer: list


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric, cell_name):
    return cell_name in metric.get("workloads", [cell_name])


def cell(name, bench=None, bench_dir=BENCH_DIR):
    """The cell `name` of the benchmark, with its configuration and traffic
    read from their files.  KeyError for a name the benchmark lacks."""
    bench = bench or benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config = load_json(os.path.join(bench_dir, "configs",
                                    entry["config"] + ".json"))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     entry["traffic"] + ".json"))
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def reader(metric_name, bench_dir=BENCH_DIR):
    """The `read(run)` function of `metrics/<metric_name>.py`."""
    path = os.path.join(bench_dir, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "vvcbench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
