"""The control of the comparison: the reference nets computed in fp8 (every
matrix product and convolution on float8 e4m3 operands, one scale per
tensor) put in the program's place, the precision below the bfloat16 the
configurations serve in.  The rest of the run is the benchmark's own: the
same input, the same ``VariantCaller`` passes, the same check.  A control
run has to come out not correct; its numbers set the upper reading of each
limit (``PERF.md``).

    python3 benchmark/control.py --workload fixture-hifi-call --seconds 5 --seeds 11 12 13

Prints one JSON line per seed: the workload, the seed, ``correct`` and the
checks.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


class RefEngine:
    """A reference net behind the engine interface ``VariantCaller`` uses."""

    def __init__(self, net, fa_input_channels=None):
        self.net = net
        self.fa_input_channels = fa_input_channels

    def predict(self, x):
        from benchmark.reference.nets import run_blocks

        return run_blocks(self.net, x)


def fp8_engines(paths, config, device, pileup_only):
    from benchmark.reference.nets import (FullAlignmentRef, PileupRef, load_weights,
                                          no_tf32)

    no_tf32()
    pe = RefEngine(PileupRef(load_weights(paths["pileup"]), device, quant="fp8"))
    fe = None
    if not pileup_only:
        fe = RefEngine(FullAlignmentRef(load_weights(paths["full_alignment"]), device,
                                        quant="fp8"),
                       fa_input_channels=config["architecture"]["fa_channels"])
    return pe, fe


def main() -> int:
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    from benchmark.harness import run_cell

    for seed in a.seeds:
        result, _ = run_cell(a.workload, seed, a.seconds, False, a.device, t_start,
                             engines=fp8_engines)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": "fp8",
                          "correct": result["correct"], "checks": result["checks"]}),
              flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
