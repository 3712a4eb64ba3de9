"""Small cells for the CPU tests, defined in a temporary checkout root the
way a later change would add one: a cell file, a workload entry, and the
per-layer metrics of the cell it copies."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2 ** 32 + 2 ** 31 + 7  # wider than 32 signed bits, as the driver's are


def make_root(tmp: str, cells: dict, metrics: dict = None) -> str:
    """``cells``: ``{name: (config, copied cell, traffic overrides)}``;
    ``metrics``: ``{name: (module source, per_layer entry)}``."""
    os.makedirs(os.path.join(tmp, "benchmark"), exist_ok=True)
    os.symlink(os.path.join(REPO, "benchmark", "configs"),
               os.path.join(tmp, "benchmark", "configs"))
    os.symlink(os.path.join(REPO, "tests"), os.path.join(tmp, "tests"))
    for d in ("cells", "metrics"):
        shutil.copytree(os.path.join(REPO, "benchmark", d), os.path.join(tmp, "benchmark", d))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for name, (config, base, over) in cells.items():
        with open(os.path.join(REPO, "benchmark", "cells", base + ".json")) as fh:
            traffic = json.load(fh)
        traffic.update(over)
        with open(os.path.join(tmp, "benchmark", "cells", name + ".json"), "w") as fh:
            json.dump(traffic, fh)
        spec["workloads"].append({"name": name, "config": config, "traffic": name,
                                  "chips": 1, "why": "a CPU test cell"})
        for m in spec["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(name)
    for name, (source, entry) in (metrics or {}).items():
        with open(os.path.join(tmp, "benchmark", "metrics", name + ".py"), "w") as fh:
            fh.write(source)
        spec["per_layer"].append(entry)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return tmp


TINY = {"contigs": 2, "contig_bp": 10_000}
