"""The per-layer metrics that read the program's step spans: they read the
seconds ``VariantCaller.run`` puts in ``stage_times`` under each span's
name, and leave their metric out where the program has no such spans."""

import importlib.util
import os

import pytest

from benchmark.tests.helpers import REPO, SEED, TINY, make_root

METRICS = ("pileup_extract_wait_us_per_cand", "fa_extract_wait_us_per_row",
           "decode_us_per_row", "engine_host_us_per_row", "engine_gather_share",
           "phase_reads_ms_per_mb", "phase_solve_ms_per_mb", "vcf_write_ms_per_mb")


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bm_metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rec(steps):
    """Two passes of 500 kb, 1,000 candidates and 200 FA rows in all, in a
    10 s window; each pass's stages, and ``steps`` beside them."""
    stages = {"plan": 0.01, "pileup": 0.5, "phase": 2.0, "full_alignment": 1.0}
    return {"passes": [{"stage_times": {**stages, **steps}} for _ in range(2)],
            "candidates": 1000, "fa_rows": 200, "bp_per_pass": 500_000, "window_s": 10.0}


@pytest.mark.parametrize("name", METRICS)
def test_no_reading_without_the_program_spans(name):
    assert _reader(name)(_rec({})) is None


def test_readings_from_the_step_spans():
    steps = {"pileup.extract_wait": 0.1, "fa.extract_wait": 0.4, "pileup.decode": 0.2,
             "fa.decode": 0.1, "PileupNet.pack": 0.05, "PileupNet.pin": 0.01,
             "FullAlignmentNet.pack": 0.02, "FullAlignmentNet.pin": 0.02,
             "PileupNet.submit": 0.01, "PileupNet.gather": 0.2,
             "FullAlignmentNet.submit": 0.01, "FullAlignmentNet.gather": 0.28,
             "phase.reads": 1.5, "phase.mec": 0.1, "phase.rescue": 0.15,
             "vcf.write": 0.05, "vcf.index": 0.2}
    got = {name: _reader(name)(_rec(steps)) for name in METRICS}
    want = {"pileup_extract_wait_us_per_cand": 0.2 / 1000 * 1e6,
            "fa_extract_wait_us_per_row": 0.8 / 200 * 1e6,
            "decode_us_per_row": 0.6 / 1200 * 1e6,
            "engine_host_us_per_row": 0.2 / 1200 * 1e6,
            "engine_gather_share": 1.0 / 10.0 * 100,
            "phase_reads_ms_per_mb": 3.0 / 1.0 * 1e3,
            "phase_solve_ms_per_mb": 0.5 / 1.0 * 1e3,
            "vcf_write_ms_per_mb": 0.5 / 1.0 * 1e3}
    assert got == pytest.approx(want)


def test_a_pass_without_a_step_counts_it_as_zero():
    rec = _rec({"phase.reads": 1.0})
    del rec["passes"][1]["stage_times"]["phase.reads"]
    assert _reader("phase_reads_ms_per_mb")(rec) == pytest.approx(1.0 / 1.0 * 1e3)


def test_every_metric_reads_in_a_traced_call_on_the_cpu(tmp_path):
    from benchmark.harness import run_cell

    root = make_root(str(tmp_path), {"tiny-call": ("clair3-hifi", "fixture-hifi-call", TINY)})
    result, rec = run_cell("tiny-call", SEED, 0.3, True, "cpu", 0.0, threads=2, workers=2,
                           root=root)
    assert result["correct"], result["checks"]
    for name in METRICS:
        assert result["metrics"][name]["value"] > 0, name
    # the accepted metrics still read
    for name in ("pileup_stage_us_per_cand", "fa_stage_us_per_row", "phase_stage_ms_per_mb",
                 "engine_wait_share", "wire_bytes_per_cand"):
        assert name in result["metrics"], name
    # the program's spans of each pass are the steps beside its stages
    steps = set().union(*(p["stage_times"] for p in rec["passes"]))
    assert {"phase.reads", "fa.extract", "PileupNet.pack"} <= steps
