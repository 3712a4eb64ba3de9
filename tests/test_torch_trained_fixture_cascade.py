"""The hifi and ONT accuracy gates of tests/test_trained_fixture_cascade.py,
through the port on the CPU at f32.

The committed trained nets call a fresh region of the fixtures' generating
distribution (seed 91, which they never saw) through the port's production
engines (``cli._load_engine``: compact wire forms, the FA depth crop; the
pileup kernel's plain twin on the CPU) and its copies of the whole
cascade: extraction, routing, read-backed phasing, haplotagged FA
extraction, merge.  The regions, seeds, calling arguments and gates are the
JAX tests'; on the card chip_smoke.py phases 3 and 6 hold the same gates at
bf16.
"""

import numpy as np
import torch

from clair3_tpu_torch.cli import _load_engine
from clair3_tpu_torch.config import CallConfig
from clair3_tpu_torch.fullalign.extractor import create_fa_tensors
from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord
from clair3_tpu_torch.phase import ReadBackedPhaser
from clair3_tpu_torch.pipeline.call import VariantCaller
from clair3_tpu_torch.postprocess import variant_metrics
from clair3_tpu_torch.testing import simulate, trained_fixture_path

# tests/test_trained_fixture_cascade.py's gates and regions
GATE_SNP_F1 = 0.990
GATE_INDEL_F1 = 0.992
EVAL_BP = 120_000
EVAL_SEED = 91  # != the fixtures' training seed (manifest.json: 7)
GATE_ONT_SNP_F1 = 0.97
GATE_ONT_INDEL_F1 = 0.93
ONT_EVAL_BP = 80_000

CPU = torch.device("cpu")


def _call_and_score(tmp_path, platform, L, **call):
    fasta, bam, _, variants = simulate(str(tmp_path), L, seed=EVAL_SEED, platform=platform)
    p_engine = _load_engine(trained_fixture_path(f"pileup_{platform}.npz"), "pileup", CPU,
                            torch.float32)
    f_engine = _load_engine(trained_fixture_path(f"fa_{platform}.npz"), "full_alignment", CPU,
                            torch.float32)
    cfg = CallConfig(platform=platform, bam_fn=bam, ref_fn=fasta,
                     output_dir=str(tmp_path / "out"), threads=2, **call)
    outputs = VariantCaller(cfg, pileup_engine=p_engine, fa_engine=f_engine,
                            phaser=ReadBackedPhaser(bam)).run()
    fa_rows = sum(1 for _ in VcfReader(outputs["full_alignment"]))
    assert fa_rows > 10, "FA stage never engaged; routing broken"
    truth_recs = [
        VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                  "1/1" if v.genotype == (1, 1) else "0/1")
        for v in variants
    ]
    query_recs = [r for r in VcfReader(outputs["merge_output"])
                  if r.filter in ("PASS", ".")]
    m = variant_metrics(truth_recs, query_recs)
    print(f"[port-fixture-gate/{platform}] SNP F1 {m['SNP'].f1} (P {m['SNP'].precision} "
          f"R {m['SNP'].recall}); INDEL F1 {m['INDEL'].f1} (P {m['INDEL'].precision} "
          f"R {m['INDEL'].recall}); FA rows {fa_rows}")
    return m, fasta, bam


def test_trained_fixture_cascade_clears_hard_gates(tmp_path):
    m, _, _ = _call_and_score(tmp_path, "hifi", EVAL_BP, indel_min_af=0.12,
                              var_pct_full=0.3, ref_pct_full=0.3)
    assert m["SNP"].f1 >= GATE_SNP_F1, m["SNP"]
    assert m["INDEL"].f1 >= GATE_INDEL_F1, m["INDEL"]


def test_trained_ont_fixture_cascade_clears_hard_gates(tmp_path):
    """Depth 89 / 9 channels with the dwell channel parsed from simulated
    mv tags, the ONT routing quantiles, the committed ONT nets."""
    m, fasta, bam = _call_and_score(tmp_path, "ont", ONT_EVAL_BP, snp_min_af=0.08,
                                    indel_min_af=0.15, var_pct_full=0.7, ref_pct_full=0.1,
                                    enable_dwell_time=True)
    # the dwell channel must be populated in this configuration: a silent
    # 9th channel of zeros would defeat the gate
    mat, _, _ = create_fa_tensors(bam, fasta, "chr1", [1000], matrix_depth=89,
                                  no_phasing=True, enable_dwell=True)
    assert mat.shape[-1] == 9 and np.abs(mat[..., 8]).sum() > 0, "dwell channel empty"
    assert m["SNP"].f1 >= GATE_ONT_SNP_F1, m["SNP"]
    assert m["INDEL"].f1 >= GATE_ONT_INDEL_F1, m["INDEL"]
