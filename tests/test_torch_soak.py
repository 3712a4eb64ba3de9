"""The soak's entry point and its f32 CPU twin engine through the port,
against the JAX package, on the CPU.

* ``testing.TorchCpuEngine`` against ``clair3_tpu.testing.FlaxCpuEngine`` on
  the committed hifi and ONT nets, seeded inputs cut into several buckets:
  pileup within atol 1e-5 and full-alignment within atol 1e-4, the f32 bounds
  of tests/test_torch_pileup.py and tests/test_torch_full_alignment.py;
  empty inputs give ``(0, 24)`` and ``(0, 90)``;
* ``python -m clair3_tpu_torch.wgs_scale_demo`` in oracle mode against
  ``scripts/wgs_scale_demo.py`` at 0.4 Mb over 2 contigs: both run copies of
  the same simulator, host code and numpy oracle engines, so the input and
  every output file are byte-identical;
* the port's soak in production mode on ``--device cpu`` at f32 (its parity
  slice included) against the JAX script's ``build_cpu_twin_engines`` on the
  same input: rows ``vcf_rows_numerically_equivalent`` with flip budget 0.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

import scripts.wgs_scale_demo as jax_soak
from clair3_tpu.config import CallConfig
from clair3_tpu.models import FullAlignmentNet as JaxFullAlignmentNet
from clair3_tpu.models import PileupNet as JaxPileupNet
from clair3_tpu.pipeline.call import VariantCaller
from clair3_tpu.testing import FlaxCpuEngine
from clair3_tpu.testing import load_trained_fixture as jax_load_trained_fixture
from clair3_tpu_torch import wgs_scale_demo
from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
from clair3_tpu_torch.models.params_io import flatten_tree
from clair3_tpu_torch.testing import (TorchCpuEngine, load_trained_fixture, random_counts,
                                      trained_fixture_path, vcf_rows_numerically_equivalent)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engines(kind, platform, channels):
    name = f"{'pileup' if kind == 'pileup' else 'fa'}_{platform}.npz"
    v = load_trained_fixture(name)
    if kind == "pileup":
        return (TorchCpuEngine(PileupNet(add_indel_length=False), v, max_batch=64),
                FlaxCpuEngine(JaxPileupNet(add_indel_length=False), v, max_batch=64))
    return (TorchCpuEngine(FullAlignmentNet(input_channels=channels), v, max_batch=64),
            FlaxCpuEngine(JaxFullAlignmentNet(add_indel_length=True, input_channels=channels),
                          v, max_batch=64))


@pytest.mark.parametrize("platform,channels,depth", [("hifi", 8, 55), ("ont", 9, 89)])
def test_cpu_twin_matches_flax_cpu_engine(platform, channels, depth):
    """Rows 0-129 in buckets of 64, 64 and 64 (2 rows zero-padded)."""
    port, ref = _engines("pileup", platform, channels)
    x = random_counts(3, (130, 33, 18))
    got, want = port.predict(x), ref.predict(x)
    assert got.shape == want.shape == (130, 24)
    assert np.abs(got - want).max() <= 1e-5
    port, ref = _engines("fa", platform, channels)
    x = np.random.RandomState(4).randint(-100, 101, (70, depth, 33, channels)).astype(np.int8)
    got, want = port.predict(x), ref.predict(x)
    err = np.abs(got - want).max()
    print(f"[port-soak] TorchCpuEngine vs FlaxCpuEngine, {platform} FA: max |dp| {err:.3g}")
    assert got.shape == want.shape == (70, 90)
    assert err <= 1e-4


def test_cpu_twin_empty_inputs_and_plain_route():
    v = load_trained_fixture("pileup_hifi.npz")
    engine = TorchCpuEngine(PileupNet(add_indel_length=False, use_kernel=True), v)
    assert not engine.model.use_kernel and not engine.model.training
    assert engine.predict(np.zeros((0, 33, 18), np.int32)).shape == (0, 24)
    fa = TorchCpuEngine(FullAlignmentNet(input_channels=8), load_trained_fixture("fa_hifi.npz"))
    assert fa.predict(np.zeros((0, 55, 33, 8), np.int8)).shape == (0, 90)
    assert [engine._bucket(n) for n in (1, 64, 65, 2048, 5000)] == [64, 64, 128, 2048, 2048]


@pytest.mark.parametrize("name", ["pileup_hifi.npz", "fa_ont.npz"])
def test_load_trained_fixture_matches_jax(name):
    got, want = flatten_tree(load_trained_fixture(name)), flatten_tree(
        jax_load_trained_fixture(name))
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


def _run(cwd, argv):
    os.makedirs(cwd)
    proc = subprocess.run([sys.executable, *argv], cwd=cwd, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


SOAK_FILES = ["ref.fa", "reads.bam", "reads.bam.bai", "call/pileup.vcf.gz",
              "call/full_alignment.vcf.gz", "call/merge_output.vcf.gz",
              "call/merge_output.vcf.gz.tbi", "call/merge_output.gvcf.gz"]


def test_oracle_soak_is_byte_identical_to_the_jax_script(tmp_path):
    """Each run in a directory of its own with the same relative --output,
    so the VCF headers name the same reference path."""
    args = ["--mbases", "0.4", "--contigs", "2", "--output", "soak"]
    out = _run(str(tmp_path / "port"), ["-m", "clair3_tpu_torch.wgs_scale_demo", *args,
                                        "--device", "cpu"])
    assert "[soak] OK [oracle engines]" in out, out
    _run(str(tmp_path / "jax"), [os.path.join(REPO, "scripts", "wgs_scale_demo.py"), *args])
    for rel in SOAK_FILES:
        a = (tmp_path / "port" / "soak" / rel).read_bytes()
        assert a == (tmp_path / "jax" / "soak" / rel).read_bytes(), rel
    assert len(a) > 100_000


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


def test_production_soak_on_cpu_matches_the_jax_cpu_twins(tmp_path, capsys):
    """The port's production engines at f32 on the CPU (its parity slice
    against TorchCpuEngine included), then the JAX script's f32 CPU twins
    on the soak's input with the script's calling configuration."""
    out = str(tmp_path / "soak")
    rc = wgs_scale_demo.main([
        "--engines", "production", "--platform", "hifi", "--mbases", "0.12", "--contigs", "2",
        "--coverage", "25", "--read_length", "900", "--output", out, "--device", "cpu",
        "--compute_dtype", "fp32", "--parity_mbases", "0.03"])
    text = capsys.readouterr().out
    assert rc == 0 and "[soak] parity slice OK" in text and "[soak] OK [production" in text, text
    assert "pileup kernel launches {\"pileup_l1_tc\": 0" in text  # no kernel on the CPU
    pe, fe = jax_soak.build_cpu_twin_engines(trained_fixture_path("pileup_hifi.npz"),
                                             trained_fixture_path("fa_hifi.npz"))
    cfg = CallConfig(platform="hifi", bam_fn=os.path.join(out, "reads.bam"),
                     ref_fn=os.path.join(out, "ref.fa"), output_dir=str(tmp_path / "jax"),
                     gvcf=True, no_phasing_for_fa=True, threads=2, enable_dwell_time=False,
                     indel_min_af=0.12, var_pct_full=0.3, ref_pct_full=0.3)
    VariantCaller(cfg, pileup_engine=pe, fa_engine=fe).run()
    for name in ("pileup.vcf.gz", "full_alignment.vcf.gz", "merge_output.vcf.gz",
                 "merge_output.gvcf.gz"):
        a = _rows(os.path.join(out, "call", name))
        b = _rows(str(tmp_path / "jax" / name))
        ok, stats = vcf_rows_numerically_equivalent(a, b, flip_budget=0.0)
        print(f"[port-soak] production cpu f32 vs JAX cpu twins, {name}: "
              f"{len(set(a) & set(b))}/{len(a)} rows byte-identical, max dQUAL "
              f"{stats['max_dqual']:.2f}, flips {stats['flips']}")
        assert len(a) > 50 and ok, stats["violations"][:5]
