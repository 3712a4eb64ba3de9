"""One run of one cell of the clair3_tpu_torch benchmark (see BENCHMARK.json):

    python3 benchmark/run.py --workload fixture-hifi-call --seed 7 --seconds 30 --trace 0

Prints the run's checks on standard error and, as the last line of standard
output, one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` and, with ``--trace 1``, ``breakdown``; the numbers
compared with the reference come last, under ``checks``.  Needs a CUDA
device; exits non-zero without printing a result when there is none.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, "benchmark", ".cache")
    # build and kernel caches at fixed places inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    sys.path.insert(0, root)
    from benchmark.harness import main as run

    return run(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
