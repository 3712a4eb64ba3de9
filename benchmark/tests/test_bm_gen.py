"""The traffic generator: one seed, one input; contigs in order."""

import hashlib
import os

from benchmark.gen.traffic import draw_variants, make_input
from benchmark.reference.frozen.io.bam import BamReader
from benchmark.tests.helpers import SEED

TRAFFIC = {"platform": "hifi", "contigs": 3, "contig_bp": 6000, "coverage": 8,
           "read_length": 900, "error_rate": 0.02, "mv_tags": True,
           "spacing_bp": 700, "margin_bp": 500, "guard_bp": 50}


def _digests(inp):
    out = {}
    for path in (inp.bam, inp.bam + ".bai", inp.fasta, inp.truth_vcf):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_same_seed_same_bytes(tmp_path):
    a = make_input(TRAFFIC, SEED, str(tmp_path / "a"))
    b = make_input(TRAFFIC, SEED, str(tmp_path / "b"))
    assert _digests(a) == _digests(b)


def test_other_seed_other_variants_same_work(tmp_path):
    a = make_input(TRAFFIC, SEED, str(tmp_path / "a"))
    b = make_input(TRAFFIC, SEED + 1, str(tmp_path / "b"))
    assert _digests(a)["truth.vcf"] != _digests(b)["truth.vcf"]
    for ctg in a.truth:
        # the same number of each kind of variant, elsewhere
        kinds = lambda vs: sorted((len(v.ref), len(v.alt), v.genotype) for v in vs)  # noqa: E731
        assert len(a.truth[ctg]) == (6000 - 1000) // 700
        assert kinds(a.truth[ctg]) == kinds(b.truth[ctg])
        assert [v.pos for v in a.truth[ctg]] != [v.pos for v in b.truth[ctg]]


def test_contigs_sorted_and_reads_sorted(tmp_path):
    inp = make_input(TRAFFIC, SEED, str(tmp_path / "a"))
    bam = BamReader(inp.bam)
    assert list(bam.references) == ["chr1", "chr2", "chr3"]
    keys = [(r.tid, r.pos) for r in bam]
    assert keys == sorted(keys)
    assert {t for t, _ in keys} == {0, 1, 2}
    assert all("mv" in r.tags for r in BamReader(inp.bam).fetch("chr2", 0, 6000))


def test_variants_keep_their_distance():
    ref = "ACGT" * 5000
    vs = draw_variants(ref, TRAFFIC, SEED)
    gaps = [b.pos - a.pos for a, b in zip(vs, vs[1:])]
    assert min(gaps) >= 2 * TRAFFIC["guard_bp"]
    assert all(500 <= v.pos < len(ref) - 500 for v in vs)
