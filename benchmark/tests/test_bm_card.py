"""On the card: one short run of a cell through ``benchmark/run.py`` is
correct and reports its metrics, and the fp8 control at the cell's own size
is not correct.  Skips without a CUDA device.

    python -m pytest --noconftest -q benchmark/tests/test_bm_card.py
"""

import json
import subprocess
import sys

import pytest

from benchmark.tests.helpers import REPO, SEED


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_a_short_run_is_correct(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "fixture-hifi-pileup-only",
                          "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = _last_json(out.stdout)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["pileup_net_roofline"]["value"] < 100


@pytest.mark.cuda
def test_the_fp8_control_is_not_correct(card):
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                          "fixture-hifi-pileup-only", "--seconds", "1", "--seeds", str(SEED)],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = _last_json(out.stdout)
    assert not line["correct"]
    assert line["checks"]["pileup_logp_gap"]["value"] > line["checks"]["pileup_logp_gap"]["limit"]
