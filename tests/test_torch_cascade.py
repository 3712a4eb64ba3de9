"""The whole `call` cascade through the PyTorch port against the JAX
package, both at f32 on the CPU with the committed hifi nets.

A ~20 kb hifi region (the generator of tests/test_trained_fixture_cascade.py,
held-out seed 91) is called twice: through the JAX package's VariantCaller
and InferenceEngine, and through `python -m clair3_tpu_torch call --device
cpu`, which runs the port's own copies of extraction, decode, routing,
phasing and merge (held equal to the originals by test_torch_copies.py)
and its own native library.  So a difference can only come from the nets or
the engines.  The rows must be numerically
equivalent with no routing flip (testing.vcf_rows_numerically_equivalent,
flip_budget 0): QUAL is printed %.2f, so a 1e-6 probability difference may
move its last digit and byte identity is not the bound.
"""

import gzip
import os

import pytest

from clair3_tpu.config import CallConfig
from clair3_tpu.models import FullAlignmentNet, PileupNet
from clair3_tpu.phase import ReadBackedPhaser
from clair3_tpu.pipeline.call import VariantCaller
from clair3_tpu.pipeline.engine import InferenceEngine
from clair3_tpu.testing import (load_trained_fixture, trained_fixture_path,
                                vcf_rows_numerically_equivalent)
from clair3_tpu_torch.cli import main as port_main
from clair3_tpu_torch.testing import simulate

EVAL_BP = 20_000
EVAL_SEED = 91
CALL = dict(platform="hifi", indel_min_af=0.12, threads=2,
            var_pct_full=0.3, ref_pct_full=0.3)


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_cascade")
    fasta, bam, _, _ = simulate(str(tmp), EVAL_BP, seed=EVAL_SEED)

    jax_out = str(tmp / "jax")
    engines = dict(
        pileup_engine=InferenceEngine(PileupNet(add_indel_length=False),
                                      load_trained_fixture("pileup_hifi.npz"),
                                      buckets=(256, 1024)),
        fa_engine=InferenceEngine(
            FullAlignmentNet(add_indel_length=True, input_channels=8),
            load_trained_fixture("fa_hifi.npz"), buckets=(256, 1024)))
    cfg = CallConfig(bam_fn=bam, ref_fn=fasta, output_dir=jax_out, **CALL)
    VariantCaller(cfg, phaser=ReadBackedPhaser(bam, min_mq=20), **engines).run()

    port_out = str(tmp / "port")
    rc = port_main([
        "call", "--bam_fn", bam, "--ref_fn", fasta, "--output", port_out,
        "--pileup_model", trained_fixture_path("pileup_hifi.npz"),
        "--full_alignment_model", trained_fixture_path("fa_hifi.npz"),
        "--device", "cpu", "--compute_dtype", "fp32",
        *(a for k, v in CALL.items() for a in (f"--{k}", str(v)))])
    assert rc == 0
    return jax_out, port_out


@pytest.mark.parametrize("name", ["pileup.vcf.gz", "merge_output.vcf.gz"])
def test_port_rows_match_jax_f32(runs, name):
    jax_out, port_out = runs
    a, b = _rows(os.path.join(jax_out, name)), _rows(os.path.join(port_out, name))
    assert len(a) > 20, f"{name}: too few rows to compare"
    ok, stats = vcf_rows_numerically_equivalent(a, b, flip_budget=0.0)
    same = len(set(a) & set(b))
    print(f"[port-cascade] {name}: {same}/{len(a)} rows byte-identical; "
          f"max dQUAL {stats['max_dqual']:.2f}, max dGQ {stats['max_dgq']}, "
          f"max dPL {stats['max_dpl']}, flips {stats['flips']}")
    assert ok, stats["violations"]


def test_fa_stage_engaged(runs):
    _, port_out = runs
    assert len(_rows(os.path.join(port_out, "full_alignment.vcf.gz"))) > 5
