"""The port's copy of the structural gVCF validator (``gvcf_validate.py``)
on the cases of tests/test_gvcf_validate.py: fuzzed block streams and a
real pipeline gVCF validate, each class of corruption is caught, gaps are
allowed only across region boundaries.  The streams are built with the
port's own copies (``gvcf.py``, ``io/vcf.py``, ``testing.py``), and every
list of problems the port's validator returns equals the JAX package's on
the same lines."""

import random
import re

import pytest
from test_gvcf_validate import MUTATIONS

from clair3_tpu.gvcf_validate import validate_gvcf as jax_validate
from clair3_tpu_torch.config import CallConfig
from clair3_tpu_torch.gvcf import NonVariantBlockWriter, merge_variant_and_nonvariant
from clair3_tpu_torch.gvcf_validate import validate_gvcf
from clair3_tpu_torch.io.vcf import get_header
from clair3_tpu_torch.pipeline.call import VariantCaller
from clair3_tpu_torch.testing import (PileupOracleEngine, SimVariant, random_reference,
                                      write_test_case)


def _validate(lines, **kw):
    """The port's problems, held equal to the JAX validator's."""
    problems = validate_gvcf(lines, **kw)
    assert problems == jax_validate(lines, **kw)
    return problems


def _make_stream(seed: int, L: int = 3000, with_variants: bool = True):
    """A synthetic merged gVCF (header + rows) from fuzzed coverage."""
    rng = random.Random(seed)
    ref = random_reference(L, seed=seed)
    w = NonVariantBlockWriter(contig_lengths={"chr1": L})
    var_positions = sorted(rng.sample(range(100, L - 100), 8)) if with_variants else []
    var_rows = []
    for p in var_positions:
        r = ref[p - 1]
        alt = rng.choice([b for b in "ACGT" if b != r])
        var_rows.append(f"chr1\t{p}\t.\t{r}\t{alt}\t18.3\tPASS\tP\tGT:GQ:DP:AD:AF:PL\t"
                        f"0/1:18:30:15,15:0.5000:18,0,25")
    depth = 25
    for pos1 in range(1, L + 1):
        if pos1 in set(var_positions):
            continue  # the pipeline skips candidate spans in the nonvar stream
        depth = max(3, min(60, depth + rng.choice([-1, 0, 0, 0, 1])))
        n_alt = rng.choice([0, 0, 0, 1])
        w.add_site("chr1", pos1, ref[pos1 - 1], depth - n_alt, depth)
    rows = merge_variant_and_nonvariant(var_rows, w.finish(), lambda c, p: ref[p - 1])
    header = get_header(gvcf=True, contigs=[("chr1", L)])
    return header.splitlines() + rows, ref


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_fuzzed_stream_validates(seed):
    lines, _ = _make_stream(seed)
    assert _validate(lines) == []


def test_pipeline_gvcf_output_validates(tmp_path):
    """The port's VariantCaller gVCF output is structurally valid."""
    L = 1500
    ref = random_reference(L, seed=17)
    variants = [SimVariant(500, ref[500], "C" if ref[500] != "C" else "G", (1, 1)),
                SimVariant(900, ref[900], "T" if ref[900] != "T" else "A", (0, 1))]
    fasta, bam, _, _ = write_test_case(str(tmp_path), ref_length=L, variants=variants,
                                       coverage=25, read_length=500, seed=17)
    cfg = CallConfig(platform="ont", bam_fn=bam, ref_fn=fasta, output_dir=str(tmp_path / "out"),
                     pileup_only=True, gvcf=True)
    outputs = VariantCaller(cfg, pileup_engine=PileupOracleEngine()).run()
    problems = _validate(outputs["merge_output_gvcf"], regions=[("chr1", 0, L)])
    # read coverage starts and ends inside the contig: only head and tail
    # gaps are acceptable
    assert [p for p in problems if "coverage gap" not in p] == []
    for p in problems:
        assert "coverage gap chr1:1-" in p or f"-{L}" in p, p


@pytest.mark.parametrize("name,mutate,expect", MUTATIONS, ids=[m[0] for m in MUTATIONS])
def test_mutations_are_caught(name, mutate, expect):
    lines, _ = _make_stream(7)
    idx = next(i for i, l in enumerate(lines)
               if not l.startswith("#") and "\t<NON_REF>\t" in l and int(l.split("\t")[1]) > 500)
    lines[idx] = "\t".join(mutate(lines[idx].split("\t")))
    problems = _validate(lines)
    assert problems, f"{name}: corruption not detected"
    assert any(expect in p for p in problems), (name, expect, problems[:4])


def _set_sample_field(line, i, value):
    cols = line.split("\t")
    parts = cols[9].split(":")
    parts[i] = value
    cols[9] = ":".join(parts)
    return "\t".join(cols)


def test_variant_row_allele_bookkeeping_caught():
    lines, _ = _make_stream(5)
    idx = next(i for i, l in enumerate(lines)
               if not l.startswith("#") and ",<NON_REF>" in l.split("\t")[4])
    ad = list(lines)
    ad[idx] = _set_sample_field(ad[idx], 3, "15,15")  # AD is Number=R: 3 values
    assert any("AD has 2 values" in p for p in _validate(ad))
    pl = list(lines)
    pl[idx] = _set_sample_field(pl[idx], 5, "18,0,25,990")  # PL is Number=G: 6 values
    assert any("PL has 4 values" in p for p in _validate(pl))


def test_missing_nonref_alt_declaration_caught():
    lines, _ = _make_stream(9)
    lines = [l for l in lines if not l.startswith("##ALT=<ID=NON_REF")]
    assert any("##ALT=<ID=NON_REF>" in p for p in _validate(lines))


def test_region_boundary_gaps_allowed_inside_flagged():
    """Two disjoint calling regions: the gap between them is legal, a gap
    inside one is flagged."""
    lines, _ = _make_stream(13, L=3000, with_variants=False)
    body = [l for l in lines if not l.startswith("#")]
    header = [l for l in lines if l.startswith("#")]

    def span(line):
        cols = line.split("\t")
        return int(cols[1]), int(re.search(r"END=(\d+)", cols[7]).group(1))

    kept = [l for l in body if span(l)[1] <= 1000 or span(l)[0] >= 2001]
    regions = [("chr1", 0, 1000), ("chr1", 2000, 3000)]
    gaps = [p for p in _validate(header + kept, regions=regions) if "coverage gap" in p]
    mid = next(i for i, l in enumerate(kept) if span(l)[0] > 300 and span(l)[1] < 700)
    del kept[mid]
    flagged = [p for p in _validate(header + kept, regions=regions) if "coverage gap" in p]
    assert len(flagged) > len(gaps), "interior gap not flagged"


def test_empty_gvcf_with_header_is_valid():
    header = get_header(gvcf=True, contigs=[("chr1", 100)]).splitlines()
    assert _validate(header) == []
    assert _validate([]) != []
