"""The whole `call` cascade through the PyTorch port against the JAX
package, both at f32 on the CPU with the committed nets.

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

The same port run from the same weights written as the reference's
``pileup.pt`` / ``full_alignment.pt`` (``--model_path``) gives byte-identical
rows.  A ~16 kb ONT region (depth 89, the dwell channel read from simulated
mv tags, the committed ONT nets, the arguments of the JAX ONT gate) goes
through both packages the same way.
"""

import gzip
import os

import numpy as np
import pytest
from chip_smoke import write_reference_checkpoints

from clair3_tpu.config import CallConfig
from clair3_tpu.models import FullAlignmentNet, PileupNet
from clair3_tpu.phase import ReadBackedPhaser
from clair3_tpu.pipeline.call import VariantCaller
from clair3_tpu.pipeline.engine import InferenceEngine
from clair3_tpu.testing import (load_trained_fixture, trained_fixture_path,
                                vcf_rows_numerically_equivalent)
from clair3_tpu_torch.cli import main as port_main
from clair3_tpu_torch.pipeline.engine import InferenceEngine as PortEngine
from clair3_tpu_torch.testing import simulate

EVAL_BP = 20_000
EVAL_SEED = 91
CALL = dict(platform="hifi", indel_min_af=0.12, threads=2,
            var_pct_full=0.3, ref_pct_full=0.3)
ONT_EVAL_BP = 16_000
# tests/test_trained_fixture_cascade.py's ONT call
ONT_CALL = dict(platform="ont", snp_min_af=0.08, indel_min_af=0.15, threads=2,
                var_pct_full=0.7, ref_pct_full=0.1)


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


def _jax_call(bam, fasta, out, call, platform, channels, **extra):
    engines = dict(
        pileup_engine=InferenceEngine(PileupNet(add_indel_length=False),
                                      load_trained_fixture(f"pileup_{platform}.npz"),
                                      buckets=(256, 1024)),
        fa_engine=InferenceEngine(
            FullAlignmentNet(add_indel_length=True, input_channels=channels),
            load_trained_fixture(f"fa_{platform}.npz"), buckets=(256, 1024)))
    cfg = CallConfig(bam_fn=bam, ref_fn=fasta, output_dir=out, **call, **extra)
    VariantCaller(cfg, phaser=ReadBackedPhaser(bam, min_mq=20), **engines).run()


def _port_call(bam, fasta, out, call, *models):
    rc = port_main([
        "call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out, *models,
        "--device", "cpu", "--compute_dtype", "fp32",
        *(a for k, v in call.items() for a in (f"--{k}", str(v)))])
    assert rc == 0


def _npz_models(platform):
    return ("--pileup_model", trained_fixture_path(f"pileup_{platform}.npz"),
            "--full_alignment_model", trained_fixture_path(f"fa_{platform}.npz"))


def _assert_equivalent(a, b, label):
    assert len(a) > 20, f"{label}: too few rows to compare"
    ok, stats = vcf_rows_numerically_equivalent(a, b, flip_budget=0.0)
    same = len(set(a) & set(b))
    print(f"[port-cascade] {label}: {same}/{len(a)} rows byte-identical; "
          f"max dQUAL {stats['max_dqual']:.2f}, max dGQ {stats['max_dgq']}, "
          f"max dPL {stats['max_dpl']}, flips {stats['flips']}")
    assert ok, stats["violations"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_cascade")
    fasta, bam, _, _ = simulate(str(tmp), EVAL_BP, seed=EVAL_SEED)
    jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
    _jax_call(bam, fasta, jax_out, CALL, "hifi", 8)
    _port_call(bam, fasta, port_out, CALL, *_npz_models("hifi"))
    return dict(jax=jax_out, port=port_out, bam=bam, fasta=fasta, tmp=tmp)


@pytest.mark.parametrize("name", ["pileup.vcf.gz", "merge_output.vcf.gz"])
def test_port_rows_match_jax_f32(runs, name):
    _assert_equivalent(_rows(os.path.join(runs["jax"], name)),
                       _rows(os.path.join(runs["port"], name)), name)


def test_fa_stage_engaged(runs):
    assert len(_rows(os.path.join(runs["port"], "full_alignment.vcf.gz"))) > 5


@pytest.fixture(scope="module")
def pt_out(runs):
    """The port run again, from the same weights as reference-layout .pt
    files in a --model_path directory."""
    models = runs["tmp"] / "pt_models"
    models.mkdir()
    write_reference_checkpoints(trained_fixture_path("pileup_hifi.npz"),
                                trained_fixture_path("fa_hifi.npz"), str(models))
    out = str(runs["tmp"] / "port_pt")
    _port_call(runs["bam"], runs["fasta"], out, CALL, "--model_path", str(models))
    return out


@pytest.mark.parametrize("name", ["pileup.vcf.gz", "merge_output.vcf.gz"])
def test_pt_checkpoints_give_the_npz_rows(runs, pt_out, name):
    want = _rows(os.path.join(runs["port"], name))
    assert len(want) > 20
    assert _rows(os.path.join(pt_out, name)) == want


@pytest.fixture(scope="module")
def ont_runs(tmp_path_factory):
    """The ONT region through both packages; the port run records the
    full-alignment batches its engine was given."""
    tmp = tmp_path_factory.mktemp("port_cascade_ont")
    fasta, bam, _, _ = simulate(str(tmp), ONT_EVAL_BP, seed=EVAL_SEED, platform="ont")
    jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
    _jax_call(bam, fasta, jax_out, ONT_CALL, "ont", 9, enable_dwell_time=True)
    fa_batches = []
    predict_async = PortEngine.predict_async

    def recording(self, x):
        if x.ndim == 4:
            fa_batches.append(np.array(x))
        return predict_async(self, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PortEngine, "predict_async", recording)
        _port_call(bam, fasta, port_out, ONT_CALL, *_npz_models("ont"), "--enable_dwell_time")
    return dict(jax=jax_out, port=port_out, fa_batches=fa_batches)


@pytest.mark.parametrize("name", ["pileup.vcf.gz", "merge_output.vcf.gz"])
def test_ont_port_rows_match_jax_f32(ont_runs, name):
    _assert_equivalent(_rows(os.path.join(ont_runs["jax"], name)),
                       _rows(os.path.join(ont_runs["port"], name)), f"ont {name}")


def test_ont_fa_stage_reads_the_dwell_channel(ont_runs):
    assert len(_rows(os.path.join(ont_runs["port"], "full_alignment.vcf.gz"))) > 5
    batches = ont_runs["fa_batches"]
    assert batches and all(b.shape[1:] == (89, 33, 9) for b in batches)
    assert sum(int(np.abs(b[..., 8]).sum()) for b in batches) > 0, "dwell channel empty"
