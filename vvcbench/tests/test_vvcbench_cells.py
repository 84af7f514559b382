"""BENCHMARK.json against the contract, and every cell, configuration,
traffic mix and per-layer metric found by name from its files."""
import json
import os
import re
import shutil

from conftest import BENCH, ROOT
from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_JSON = cells.benchmark(ROOT)


def test_benchmark_keys_and_names():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["vvcbench"]
    assert b["command"][1] == "vvcbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    cell_names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cell_names
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"vvcbench/configs/{c['name']}.json"
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_every_cell_and_metric_loads_by_name():
    for w in BENCH_JSON["workloads"]:
        c = cells.cell(w["name"])
        assert c.config["name"] == w["config"]
        assert c.traffic["name"] == w["traffic"]
        assert {m["name"] for m in c.end_to_end} == \
            {"fps", "cpu_s_per_frame", "setup_s"}
        assert c.per_layer
        reduced = next(x["reduced"] for x in BENCH_JSON["configs"]
                       if x["name"] == w["config"])
        assert sorted(reduced) == sorted(c.config["reduced"])
    for m in BENCH_JSON["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_a_cell_added_by_files_alone(tmp_path):
    """A throwaway cell from a new configuration, traffic mix and metric
    file and one more entry of each list: the harness finds all of it."""
    bench_dir = tmp_path / "vvcbench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns(
        ".cache", ".out", "__pycache__"))
    cfg = json.loads((bench_dir / "configs" / "ai1080.json").read_text())
    cfg["name"] = "ai720"
    cfg["width"], cfg["height"] = 1280, 720
    (bench_dir / "configs" / "ai720.json").write_text(json.dumps(cfg))
    tr = json.loads((bench_dir / "traffic" / "seg2.json").read_text())
    tr["name"], tr["segments"] = "seg3", 3
    (bench_dir / "traffic" / "seg3.json").write_text(json.dumps(tr))
    (bench_dir / "metrics" / "segments.count.py").write_text(
        "def read(run):\n    return run.spans.count('segment')\n")
    b = json.loads(json.dumps(BENCH_JSON))
    b["configs"].append(dict(b["configs"][0], name="ai720",
                             file="vvcbench/configs/ai720.json"))
    b["workloads"].append({"name": "ai720.seg3", "config": "ai720",
                           "traffic": "seg3", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "segments.count", "unit": "segments",
                           "better": "higher", "source": "program_span",
                           "layer": "test", "moves": "fps",
                           "workloads": ["ai720.seg3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    listed = [w["name"] for w in cells.benchmark(str(tmp_path))["workloads"]]
    assert "ai720.seg3" in listed
    c = cells.cell("ai720.seg3", cells.benchmark(str(tmp_path)),
                   str(bench_dir))
    assert (c.config["width"], c.traffic["segments"]) == (1280, 3)
    assert [m["name"] for m in c.per_layer] == ["segments.count"]

    class View:
        class spans:
            count = staticmethod(lambda name: 5)
    assert cells.reader("segments.count", str(bench_dir))(View) == 5
    assert os.path.exists(bench_dir / "run.py")
