"""The phaser's read scan in the port's native library
(``native.phase_alleles_native``, ``native/clair3t_phase.cc``) against its
Python twin, ``BamReader.fetch`` followed by ``read_alleles_at_snps``.

The native arrays must hold the Python route's alleles read for read: the
same reads kept (their ordinals), the same SNPs and the same alleles, on the
simulator's hifi and ONT BAMs with and without a ``.bai`` and on crafted
reads that walk every CIGAR operation, filter and base the scan has to get
right.  ``ReadBackedPhaser.phase`` gives the same records on both routes and
the frozen reference phaser's records on a contig of the benchmark's
fixture-hifi-call traffic, and ``phase.native_scan`` closes once a contig on
the native route only.
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest

from clair3_tpu.io.vcf import VcfRecord as JaxVcfRecord
from clair3_tpu.phase import ReadBackedPhaser as JaxPhaser

from clair3_tpu_torch import native, spans
from clair3_tpu_torch.io.bam import BamRead, BamReader, write_bam
from clair3_tpu_torch.io.vcf import VcfRecord
from clair3_tpu_torch.phase import ReadBackedPhaser
from clair3_tpu_torch.phase.phaser import read_alleles_at_snps
from clair3_tpu_torch.testing import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_MQ = 20


@pytest.fixture(scope="module", autouse=True)
def lib():
    assert native.native_available(), "the port's native library did not build"


def python_route(bam, ctg, start, end, positions, ref, alt, min_mq=MIN_MQ):
    """(read ordinal, SNP index, allele) of the Python route, in BAM order."""
    snp_ref = dict(zip(positions, ref))
    snp_alt = dict(zip(positions, alt))
    at = {p: k for k, p in enumerate(positions)}
    rows = []
    for i, read in enumerate(BamReader(bam).fetch(ctg, start, end, min_mq=min_mq)):
        rows += [(i, at[p], a) for p, a in read_alleles_at_snps(read, positions,
                                                                 snp_ref, snp_alt)]
    return rows


def native_route(bam, ctg, start, end, positions, ref, alt, min_mq=MIN_MQ):
    arrays = native.phase_alleles_native(bam, ctg, start, end, positions,
                                         ref.encode(), alt.encode(), min_mq=min_mq)
    assert [a.dtype for a in arrays] == [np.int32, np.int32, np.int8]
    return list(zip(*(a.tolist() for a in arrays)))


def assert_routes_agree(bam, ctg, start, end, positions, ref, alt, min_mq=MIN_MQ):
    want = python_route(bam, ctg, start, end, positions, ref, alt, min_mq)
    have = native_route(bam, ctg, start, end, positions, ref, alt, min_mq)
    assert have == want
    return want


def _unindexed(bam, tmp):
    os.makedirs(tmp, exist_ok=True)
    out = os.path.join(tmp, "reads.bam")
    shutil.copy(bam, out)
    assert not os.path.exists(out + ".bai")
    return out


# ---------------------------------------------------------------- simulator

@pytest.fixture(scope="module", params=["hifi", "ont"])
def simulated(request, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sim_" + request.param))
    fasta, bam, ref, variants = simulate(work, 20_000, seed=5, platform=request.param)
    assert os.path.exists(bam + ".bai")
    if request.param == "ont":
        assert "mv" in next(iter(BamReader(bam))).tags
    # the simulated SNPs (either allele order), and reference positions in
    # between, where reads carry the ref allele and their errors
    snps = {v.pos: (v.ref, v.alt) for v in variants if len(v.ref) == len(v.alt) == 1}
    rng = np.random.default_rng(3)
    for p in rng.choice(np.arange(300, 19_700), 150, replace=False).tolist():
        if p not in snps:
            snps[p] = (ref[p], "ACGT"[("ACGT".index(ref[p]) + 1) % 4])
    positions = sorted(snps)
    return bam, _unindexed(bam, os.path.join(work, "noindex")), positions, snps


@pytest.mark.parametrize("indexed", [True, False], ids=["bai", "no_bai"])
def test_simulated_reads_agree(simulated, indexed):
    bam, plain, positions, snps = simulated
    path = bam if indexed else plain
    ref = "".join(snps[p][0] for p in positions)
    alt = "".join(snps[p][1] for p in positions)
    rows = assert_routes_agree(path, "chr1", positions[0], positions[-1] + 1,
                               positions, ref, alt)
    assert len(rows) > 1000 and {a for _, _, a in rows} == {0, 1}
    # a window in the middle, and one SNP
    mid = [p for p in positions if 8_000 <= p < 12_000]
    assert_routes_agree(path, "chr1", mid[0], mid[-1] + 1, mid,
                        ref[positions.index(mid[0]):positions.index(mid[-1]) + 1],
                        alt[positions.index(mid[0]):positions.index(mid[-1]) + 1])
    k = len(positions) // 2
    assert_routes_agree(path, "chr1", positions[k], positions[k] + 1, positions[k:k + 1],
                        ref[k], alt[k])


def test_simulated_phasing_is_the_same_on_both_routes(simulated, monkeypatch):
    bam, plain, positions, snps = simulated
    het = [VcfRecord("chr1", p + 1, r, a, 30.0, "PASS", ".", "GT", "0/1")
           for p, (r, a) in sorted(snps.items())]
    # an indel and a second record at one position: the phaser keeps SNPs and
    # indexes a repeated position by its last record
    het.append(VcfRecord("chr1", 5001, "A", "AT", 30.0, "PASS", ".", "GT", "0/1"))
    het.append(VcfRecord("chr1", positions[40] + 1, snps[positions[40]][0], "N", 30.0,
                         "PASS", ".", "GT", "0/1"))
    # the JAX package's phaser on the same records: the reference the port's
    # phaser was copied from
    jax_het = [JaxVcfRecord(**dataclasses.asdict(r)) for r in het]
    for path in (bam, plain):
        native_recs = ReadBackedPhaser(path).phase("chr1", het)
        with monkeypatch.context() as m:
            m.setenv("CLAIR3T_DISABLE_NATIVE", "1")
            python_recs = ReadBackedPhaser(path).phase("chr1", het)
        jax_recs = JaxPhaser(path).phase("chr1", jax_het)
        assert [r.to_line() for r in native_recs] == [r.to_line() for r in python_recs]
        assert [r.to_line() for r in native_recs] == [r.to_line() for r in jax_recs]
        assert len({r.sample.split(":")[1] for r in native_recs}) < len(native_recs) / 4


# ------------------------------------------------------------ crafted reads

L = 1000
CONTIGS = ["chr1", "chr2", "chr3"]  # chr3 holds no read
# (0-based position, REF, ALT): lowercase REF at 300 (no decoded base is
# lowercase), IUPAC ALT at 310; the bases read one past a block's end carry an
# allele of the SNP there, so a scan that runs a base too far reads a wrong one
SNPS = [(100, "A", "C"), (103, "G", "T"), (105, "G", "T"), (108, "T", "G"),
        (110, "C", "A"), (120, "T", "G"),
        (130, "A", "G"), (150, "C", "T"), (200, "G", "A"), (201, "T", "C"),
        (210, "A", "T"), (224, "C", "G"), (300, "c", "T"), (310, "A", "R"),
        (320, "G", "C"), (400, "T", "A"), (600, "G", "T")]


def _read(name, pos, cigar, seq, flag=0, mapq=60, tid=0):
    return BamRead(name, flag, tid, pos, mapq, cigar, seq,
                   np.full(len(seq), 30, np.uint8))


def _bases(at, n, pick):
    """``n`` read bases for reference positions ``at .. at + n - 1``, each
    the SNP's REF, ALT or another base as ``pick`` says ('r', 'a', 'o')."""
    snp = {p: (r, a) for p, r, a in SNPS}
    out = []
    for p in range(at, at + n):
        r, a = snp.get(p, ("A", "C"))
        c = {"r": r.upper(), "a": a}.get(pick(p), "N")
        out.append(c if p in snp else "ACGT"[p % 4])
    return "".join(out)


def _crafted_reads():
    alt, ref = (lambda p: "a"), (lambda p: "r")
    alternate = (lambda p: "ra"[p % 2])
    reads = [
        # ends exactly at 100: dropped when the region starts there
        _read("end_at_start", 90, [(0, 10)], _bases(90, 10, ref)),
        # ends at 101: kept, one allele on its last base
        _read("end_after_start", 91, [(0, 10)], _bases(91, 10, alt)),
        # soft clip, SNPs 100, 105, 110 in one block
        _read("soft_clip", 97, [(4, 3), (0, 20)], "TTT" + _bases(97, 20, alternate)),
        # an insertion of SNP 103's ALT between blocks 98..102 (SNP 100) and
        # 103..112 (103 on its first base, 105, 108, 110)
        _read("insertion", 98, [(0, 5), (1, 2), (0, 10)],
              _bases(98, 5, alt) + "TT" + _bases(103, 10, ref)),
        # SNP 100 on block 1's first base, 105 inside the deletion, 108 on block
        # 2's first base (which is 105's REF), 110 later
        _read("deletion", 100, [(0, 5), (2, 3), (0, 10)],
              _bases(100, 5, alt) + _bases(108, 10, alt)),
        # N skip over 110..209; block 2 is 210..224: SNPs on its first and last base
        _read("n_skip", 100, [(0, 10), (3, 100), (0, 15)],
              _bases(100, 10, ref) + _bases(210, 15, alt)),
        # filtered: secondary, supplementary, unmapped, mate unmapped
        _read("secondary", 100, [(0, 30)], _bases(100, 30, alt), flag=0x100),
        _read("supplementary", 100, [(0, 30)], _bases(100, 30, alt), flag=0x800),
        _read("unmapped", 100, [(0, 30)], _bases(100, 30, alt), flag=0x4),
        _read("mate_unmapped", 100, [(0, 30)], _bases(100, 30, alt), flag=0x9),
        # kept: reverse, duplicate (not in the filter)
        _read("reverse_dup", 101, [(0, 30)], _bases(101, 30, alternate), flag=0x410),
        # MAPQ at the limit and one under it
        _read("mq_under", 102, [(0, 30)], _bases(102, 30, alt), mapq=MIN_MQ - 1),
        _read("mq_at", 102, [(0, 30)], _bases(102, 30, alt), mapq=MIN_MQ),
        # = and X blocks: 200 on the last base of a = block, 201 an X block
        _read("eq_x", 195, [(7, 6), (8, 1), (7, 5)], _bases(195, 11, ref)),
        # a hard clip and a pad consume nothing
        _read("hard_pad", 196, [(5, 10), (0, 5), (6, 2), (0, 20)], _bases(196, 25, alt)),
        # a base that is neither allele (N), an IUPAC ALT base read as such,
        # and a lowercase REF that the upper-case read base does not match
        _read("iupac", 295, [(0, 30)], _bases(295, 30, lambda p: "oar"[p % 3])),
        _read("iupac2", 296, [(0, 30)], _bases(296, 30, lambda p: "a" if p == 310 else "r")),
        # a long deletion over two SNPs, then the last SNP of the region
        _read("long_del", 390, [(0, 5), (2, 200), (0, 20)],
              _bases(390, 5, ref) + _bases(595, 20, alt)),
        # starts at the region's end: the scan stops here
        _read("at_end", 601, [(0, 20)], _bases(601, 20, alt)),
        _read("after_end", 650, [(0, 20)], _bases(650, 20, alt)),
        # the second contig: reads, but no SNP under them
        _read("chr2_a", 10, [(0, 50)], "ACGT" * 12 + "AC", tid=1),
        _read("chr2_b", 500, [(0, 50)], "ACGT" * 12 + "AC", tid=1),
    ]
    return sorted(reads, key=lambda r: (r.tid, r.pos))


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("crafted"))
    bam = os.path.join(work, "crafted.bam")
    write_bam(bam, CONTIGS, [L] * 3, _crafted_reads())
    plain = os.path.join(work, "plain", "crafted.bam")
    os.makedirs(os.path.dirname(plain))
    write_bam(plain, CONTIGS, [L] * 3, _crafted_reads(), write_index=False)
    return {"bai": bam, "no_bai": plain}


def _crafted_snps(lo=0, hi=L):
    kept = [s for s in SNPS if lo <= s[0] < hi]
    return ([p for p, _, _ in kept], "".join(r for _, r, _ in kept),
            "".join(a for _, _, a in kept))


@pytest.mark.parametrize("index", ["bai", "no_bai"])
def test_crafted_reads_agree(crafted, index):
    bam = crafted[index]
    positions, ref, alt = _crafted_snps()
    rows = assert_routes_agree(bam, "chr1", positions[0], positions[-1] + 1,
                               positions, ref, alt)
    names = [r.qname for r in BamReader(bam).fetch("chr1", 100, 601, min_mq=MIN_MQ)]
    assert "end_at_start" not in names and "mq_under" not in names
    assert {"end_after_start", "reverse_dup", "mq_at", "long_del"} <= set(names)
    assert "at_end" not in names
    by_read = {}
    for i, k, a in rows:
        by_read.setdefault(names[i], []).append((positions[k], a))
    assert by_read["end_after_start"] == [(100, 1)]
    assert by_read["deletion"] == [(100, 1), (103, 1), (108, 1), (110, 1)]
    assert by_read["n_skip"] == [(100, 0), (103, 0), (105, 0), (108, 0), (210, 1), (224, 1)]
    assert by_read["eq_x"] == [(200, 0), (201, 0)]
    assert by_read["insertion"] == [(100, 1), (103, 0), (105, 0), (108, 0), (110, 0)]
    assert (310, 1) in by_read["iupac2"] and (300, 0) not in by_read["iupac2"]
    assert by_read["long_del"] == [(600, 1)]
    # a region that starts at 101 drops the read that ends there
    positions, ref, alt = _crafted_snps(101)
    assert_routes_agree(bam, "chr1", 101, positions[-1] + 1, positions, ref, alt)
    # without the MAPQ filter the read under it comes back
    positions, ref, alt = _crafted_snps()
    assert_routes_agree(bam, "chr1", positions[0], positions[-1] + 1, positions, ref,
                        alt, min_mq=0)


@pytest.mark.parametrize("index", ["bai", "no_bai"])
def test_empty_region_and_uncovered_contig(crafted, index):
    bam = crafted[index]
    # no read overlaps [700, 900) of chr1, nor any SNP on chr2; chr3 has no
    # read at all (with a .bai the index proves the region empty)
    for ctg, positions in (("chr1", [700, 800, 899]), ("chr2", [5, 300, 700]),
                           ("chr3", [5, 300, 700])):
        rows = assert_routes_agree(bam, ctg, positions[0], positions[-1] + 1, positions,
                                   "ACG", "TTT")
        assert rows == []
    # no SNP at all
    assert native_route(bam, "chr1", 0, L, [], "", "") == []
    with pytest.raises(KeyError):
        native.phase_alleles_native(bam, "chr4", 0, 10, [5], b"A", b"C")
    for positions in ([5, 5], [6, 5]):
        with pytest.raises(ValueError):
            native.phase_alleles_native(bam, "chr1", 5, 7, positions, b"AA", b"CC")
    with pytest.raises(ValueError):
        native.phase_alleles_native(bam, "chr1", 5, 7, [5, 6], b"A", b"CC")


def test_a_base_past_the_sequence_raises_on_both_routes(tmp_path):
    bam = str(tmp_path / "short.bam")
    write_bam(bam, ["chr1"], [L], [_read("short_seq", 100, [(0, 30)], "")])
    with pytest.raises(IndexError):
        python_route(bam, "chr1", 100, 121, [120], "A", "C")
    with pytest.raises(IndexError):
        native_route(bam, "chr1", 100, 121, [120], "A", "C")


# ------------------------------------------------------------- the phaser

def test_native_scan_span_counts_the_native_contigs(crafted, monkeypatch):
    het = [VcfRecord("chr1", p + 1, r.upper(), a, 30.0, "PASS", ".", "GT", "0/1")
           for p, r, a in SNPS]
    het2 = [VcfRecord("chr2", 31, "A", "C", 30.0, "PASS", ".", "GT", "0/1")]

    def calls(name, before):
        return spans.totals().get(name, (0.0, 0))[1] - before.get(name, (0.0, 0))[1]

    before = spans.totals()
    phaser = ReadBackedPhaser(crafted["bai"])
    native_recs = [phaser.phase("chr1", het), phaser.phase("chr2", het2)]
    assert calls("phase.native_scan", before) == calls("phase.reads", before) == 2
    before = spans.totals()
    monkeypatch.setenv("CLAIR3T_DISABLE_NATIVE", "1")
    python_recs = [phaser.phase("chr1", het), phaser.phase("chr2", het2)]
    assert calls("phase.native_scan", before) == 0 and calls("phase.reads", before) == 2
    assert ([[r.to_line() for r in recs] for recs in native_recs]
            == [[r.to_line() for r in recs] for recs in python_recs])


def test_phasing_equals_the_frozen_reference_on_benchmark_traffic(tmp_path):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmark.gen.traffic import make_input
    from benchmark.reference.frozen.io.vcf import VcfRecord as FrozenRecord
    from benchmark.reference.frozen.phaser import ReadBackedPhaser as FrozenPhaser

    with open(os.path.join(REPO, "benchmark", "cells", "fixture-hifi-call.json")) as fh:
        traffic = dict(json.load(fh), contigs=1)
    inp = make_input(traffic, 2**31 + 12345, str(tmp_path))
    snps = [v for v in inp.truth["chr1"] if len(v.ref) == len(v.alt) == 1]
    assert len(snps) > 100
    row = lambda cls, v: cls("chr1", v.pos + 1, v.ref, v.alt, 40.0, "PASS", ".",  # noqa: E731
                             "GT", "0/1")
    before = spans.totals()
    port = ReadBackedPhaser(inp.bam, min_mq=MIN_MQ).phase(
        "chr1", [row(VcfRecord, v) for v in snps])
    assert spans.totals()["phase.native_scan"][1] == before.get(
        "phase.native_scan", (0.0, 0))[1] + 1
    frozen = FrozenPhaser(inp.bam, min_mq=MIN_MQ).phase(
        "chr1", [row(FrozenRecord, v) for v in snps])
    key = lambda recs: [(r.chrom, r.pos, r.ref, r.alt, r.sample) for r in recs]  # noqa: E731
    assert key(port) == key(frozen)
    assert len(port) == len(snps)
