"""The harness is driven by data: a cell, a configuration or a per-layer
metric is new files and new entries, found by name.  And it refuses to
print a result where it cannot measure."""

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark.tests.helpers import REPO, SEED, TINY, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

PASSES = '''"""Passes the window finished (a test metric)."""


def read(rec):
    return float(len(rec["passes"]))
'''


def test_a_cell_and_a_metric_from_new_files_only(tmp_path):
    from benchmark.harness import run_cell

    entry = {"name": "window_passes", "unit": "passes", "better": "higher",
             "source": "program_counter", "layer": "call pipeline (pipeline/call.py)",
             "moves": "cand_per_s", "workloads": ["new-cell"]}
    root = make_root(str(tmp_path), {"new-cell": ("clair3-hifi", "fixture-hifi-pileup-only", TINY)},
                     {"window_passes": (PASSES, entry)})
    result, rec = run_cell("new-cell", SEED, 0.3, True, "cpu", 0.0, threads=2, workers=2,
                           root=root)
    assert result["correct"], result["checks"]
    assert result["metrics"]["window_passes"] == {"value": float(len(rec["passes"])),
                                                  "unit": "passes"}
    assert "pileup_stage_us_per_cand" in result["metrics"]
    assert "fa_stage_us_per_row" not in result["metrics"]  # not this cell's
    assert list(result)[-1] == "checks"
    result, _ = run_cell("new-cell", SEED, 0.3, False, "cpu", 0.0, threads=2, workers=2,
                         root=root)
    assert set(result["metrics"]) == {"cand_per_s", "setup_s"}


def _run_py(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "fixture-hifi-call",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_result_without_a_card():
    out = _run_py(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run_py(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_specification_keeps_the_contract():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    cells = {w["name"] for w in spec["workloads"]}
    metrics = spec["end_to_end"] + spec["per_layer"]
    for x in spec["configs"] + spec["workloads"] + metrics:
        assert NAME.match(x["name"]), x["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(REPO, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert os.path.exists(os.path.join(REPO, "benchmark", "cells", w["traffic"] + ".json"))
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in spec["per_layer"])
