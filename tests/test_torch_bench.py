"""The port's bench (``clair3_tpu_torch/bench.py``) against the JAX package's
``bench.py``, f32 on the CPU, and the microbench ``bench_history`` in its
wiring mode:

* ``make_workload`` at 0.05 Mb writes a BAM byte-identical to the JAX
  bench's (the same simulator, copied);
* ``route_candidates`` gives the same spans and cutoffs on the same decoded
  rows;
* ``run_cascade``, serial and overlapped, at 0.1 Mb: the port's production
  engines (``build_production_engines("cpu")``, f32) and the JAX bench's
  (``bench.build_production_engines()`` on the CPU: f32, no Pallas) give
  equal ``candidates``, ``fa_candidates`` and ``rows``;
* ``bench_forward`` at tiny sizes gives a finite, positive rate;
* ``bench_history`` with ``C3T_HISTORY_SMOKE=1 --device cpu`` runs its eager
  routes, says the kernel routes were not run, and prints its table.
"""

import math
import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from clair3_tpu_torch import bench


def test_make_workload_bam_equals_the_jax_bench(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_bench.make_workload(str(tmp_path / "jax"), genome_mb=0.05)
    got = bench.make_workload(str(tmp_path / "port"), genome_mb=0.05)
    assert got[1] == want[1] and got[3] == want[3]
    assert [tuple(vars(h).values()) for h in got[2]] == [tuple(vars(h).values()) for h in want[2]]
    with open(got[0], "rb") as a, open(want[0], "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("workload")
    return bench.make_workload(str(d), genome_mb=0.1)


@pytest.fixture(scope="module")
def engines():
    """(port engines, JAX engines): both f32 on the CPU."""
    port = bench.build_production_engines("cpu")
    pe, fe = jax_bench.build_production_engines()[:2]
    return port, (pe, fe)


def test_route_candidates_equal_the_jax_bench(workload, engines):
    from clair3_tpu_torch.decode import DecodeConfig
    from clair3_tpu_torch.native import decode_batch_native, pileup_region_native
    from clair3_tpu_torch.pileup.extractor import candidate_tensors

    bam, ref, _, chunks = workload
    pe = engines[0][0]
    rows = []
    cfg = DecodeConfig(add_indel_length=False, pileup=True, show_ref_calls=True)
    for s, e in chunks:
        tensors, pis, alts = candidate_tensors(
            pileup_region_native(bam, ref, 0, "chr1", s, e, threads=0), "chr1")
        rows += decode_batch_native(pis, alts, pe.predict(tensors).astype(np.float64), cfg)
    got = bench.route_candidates(rows, chunks)
    want = jax_bench.route_candidates(rows, chunks)
    assert got == want
    assert sum(map(len, got[0])) > 50


@pytest.mark.parametrize("overlapped", [False, True])
def test_run_cascade_counts_equal_the_jax_bench(workload, engines, overlapped):
    bam, ref, hets, chunks = workload
    (pe, fe), (jpe, jfe) = engines
    _, got = bench.run_cascade(bam, ref, hets, chunks, pe, fe, overlapped=overlapped)
    _, want = jax_bench.run_cascade(bam, ref, hets, chunks, jpe, jfe, overlapped=overlapped)
    print(f"[port-bench] overlapped={overlapped}: port {got}, jax {want}")
    for key in ("candidates", "fa_candidates", "rows"):
        assert got[key] == want[key], key
    assert got["candidates"] > 1000 and got["fa_candidates"] > 100


def test_bench_forward_gives_a_positive_rate(engines):
    pe, fe = engines[0]
    for model, shape, dtype in ((pe.model, (8, 33, 18), np.int32),
                                (fe.model, (4, 89, 33, 8), np.int8)):
        rate = bench.bench_forward(
            model, lambda: torch.from_numpy(np.ones(shape, dtype)), shape[0], 2)
        assert math.isfinite(rate) and rate > 0


def test_bench_history_smoke_on_the_cpu(capsys, monkeypatch):
    from clair3_tpu_torch import bench_history

    monkeypatch.setenv("C3T_HISTORY_SMOKE", "1")
    assert bench_history.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "kernel routes" in err and "were not run" in err
    assert "vs shipped: max-abs prob diff" in err
    table = [line for line in out.splitlines() if line.startswith("|")]
    assert table[0].startswith("| configuration (cpu)") and len(table) == 4, out
    assert "pileup eager PyTorch" in table[2] and "FA cuDNN" in table[3]
