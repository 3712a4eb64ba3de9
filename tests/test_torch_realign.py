"""Illumina realignment through the port: DBG consensus, affine alignment,
CIGAR composition, and recovery of indels hidden by mismatch-only
alignments -- tests/test_realign.py run against ``clair3_tpu_torch`` (its
copies of ``realign/``, ``pileup/``, ``pipeline/`` and its own native
library) -- and the first Illumina call through the port's CLI, against the
JAX CLI at f32 on the CPU."""

import numpy as np
import pytest

from clair3_tpu_torch.io.bam import BamRead
from clair3_tpu_torch.pileup.extractor import pileup_region
from clair3_tpu_torch.realign.align import affine_local_align, _align_python
from clair3_tpu_torch.realign.align import MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND
from clair3_tpu_torch.realign.dbg import consensus_haplotypes
from clair3_tpu_torch.realign.realigner import (
    realign_reads_in_region,
    select_realignment_windows,
)
from clair3_tpu_torch.testing import QUAL_SATURATES, random_reference
# rows above QUAL_SATURATES are held on 1 - p
from clair3_tpu_torch.testing import f32_rows_equivalent as _equivalent_ilmn_rows


def test_affine_align_exact_match():
    a = affine_local_align("ACGTACGT", "TTACGTACGTTT")
    assert a.score == 8 * 4
    assert a.cigar == [(0, 8)]
    assert a.target_start == 2
    assert a.query_start == 0 and a.query_end == 8


def test_affine_align_with_deletion():
    target = "AAACCCGGGTTTAAACCC"
    query = target[:6] + target[9:]  # 3bp deletion
    a = affine_local_align(query, target)
    ops = [op for op, _ in a.cigar]
    assert 2 in ops  # D present
    total_d = sum(l for op, l in a.cigar if op == 2)
    assert total_d == 3


def test_affine_align_with_insertion():
    target = "AAACCCGGGTTTAAACCC"
    query = target[:9] + "TTTT" + target[9:]
    a = affine_local_align(query, target)
    assert sum(l for op, l in a.cigar if op == 1) == 4


def test_python_fallback_matches_native():
    q, t = "ACGTTGCA", "ACGTACGTTGCAAC"
    a = affine_local_align(q, t, use_native=False)
    b = affine_local_align(q, t)
    assert (a.score, a.cigar) == (b.score, b.cigar)


def test_consensus_haplotypes_recovers_alt():
    ref = random_reference(200, seed=81)
    alt = ref[:100] + ref[103:]  # 3bp deletion haplotype
    reads = []
    for s in range(0, 120, 10):
        reads.append(alt[s: s + 80])
        reads.append(ref[s: s + 80])
    haps = consensus_haplotypes(reads, ref, min_edge_weight=2)
    assert ref in haps
    assert alt in haps


def test_consensus_haplotypes_prunes_noise():
    ref = random_reference(150, seed=82)
    noisy = ref[:70] + ("A" if ref[70] != "A" else "C") + ref[71:]
    haps = consensus_haplotypes([noisy], ref, min_edge_weight=2)
    # single-read support < min_edge_weight -> only the reference survives
    assert haps == [ref]


def _misaligned_del_reads(ref, del_start, del_len, n=14, read_len=80):
    """Reads from a deletion haplotype but aligned all-M (as a naive mapper
    would), hiding the deletion as a tail of mismatches."""
    alt = ref[:del_start] + ref[del_start + del_len:]
    reads = []
    for i in range(n):
        s = del_start - 50 + (i * 7) % 30
        seq = alt[s: s + read_len]
        reads.append(BamRead(
            f"m{i}", 0 if i % 2 == 0 else 16, 0, s, 60,
            [(0, len(seq))], seq, np.full(len(seq), 30, np.uint8)))
    return reads


def test_window_selection_finds_misalignment():
    ref = random_reference(400, seed=83)
    reads = _misaligned_del_reads(ref, 200, 4)
    wins = select_realignment_windows(reads, ref, 0, 0, 400)
    assert len(wins) >= 1
    assert any(w.start <= 204 <= w.end for w in wins)


def test_realignment_recovers_hidden_deletion():
    ref = random_reference(400, seed=84)
    del_start, del_len = 200, 4
    reads = _misaligned_del_reads(ref, del_start, del_len, n=16)
    # plus clean reference-matching reads
    for i in range(8):
        s = 120 + i * 10
        reads.append(BamRead(
            f"r{i}", 0, 0, s, 60, [(0, 80)], ref[s: s + 80],
            np.full(80, 30, np.uint8)))
    reads.sort(key=lambda r: r.pos)

    realigned, n = realign_reads_in_region(reads, ref, 0, 0, 400)
    assert n >= 10

    # the deletion now appears in the pileup at the anchor position
    res = pileup_region(realigned, ref, 0, 0, 400, min_indel_af=0.15)
    anchor = del_start - 1
    assert res.counts[anchor, 6] + res.counts[anchor, 15] >= 10  # D_S channels
    cand_pos = [c.pos for c in res.candidates]
    assert anchor in cand_pos
    cand = res.candidates[cand_pos.index(anchor)]
    assert f"D{ref[del_start:del_start + del_len]}" in cand.alt_info

    # before realignment there is no deletion evidence at all
    res0 = pileup_region(reads, ref, 0, 0, 400, min_indel_af=0.15)
    assert res0.counts[anchor, 6] + res0.counts[anchor, 15] == 0


def test_realignment_leaves_clean_reads_alone():
    ref = random_reference(300, seed=85)
    reads = [
        BamRead(f"c{i}", 0, 0, i * 10, 60, [(0, 80)], ref[i * 10: i * 10 + 80],
                np.full(80, 30, np.uint8))
        for i in range(15)
    ]
    realigned, n = realign_reads_in_region(reads, ref, 0, 0, 300)
    assert n == 0
    for a, b in zip(reads, realigned):
        assert a.pos == b.pos and a.cigar == b.cigar


def test_ilmn_pipeline_with_realignment(tmp_path):
    """End-to-end ilmn cascade with reference semantics (CallVarBam.py:99
    ``need_realignment = ... and not pileup``): the PILEUP stage reads the
    raw BAM, where the misaligned deletion shows up as shifted mismatch
    candidates; the FULL-ALIGNMENT stage realigns, re-detects candidates
    inside the 1000 bp region windows, and calls the true deletion; the
    region-scoped merge (MergeVcf.py:59-155) keeps exactly the FA
    representation inside the window and drops the stale pileup rows."""
    from clair3_tpu_torch.config import CallConfig
    from clair3_tpu_torch.io.bam import write_bam
    from clair3_tpu_torch.io.fasta import write_fasta
    from clair3_tpu_torch.io.vcf import VcfReader
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from clair3_tpu_torch.testing import FullAlignmentOracleEngine, PileupOracleEngine

    ref = random_reference(800, seed=86)
    del_start, del_len = 400, 4
    reads = _misaligned_del_reads(ref, del_start, del_len, n=20, read_len=100)
    # reference-haplotype reads across the rest of the contig
    for i in range(60):
        s = (i * 13) % 680
        reads.append(BamRead(
            f"bg{i}", 0 if i % 2 else 16, 0, s, 60, [(0, 100)],
            ref[s: s + 100], np.full(100, 30, np.uint8)))
    reads.sort(key=lambda r: r.pos)
    fasta = str(tmp_path / "ref.fa")
    write_fasta(fasta, {"chr1": ref})
    bam = str(tmp_path / "r.bam")
    write_bam(bam, ["chr1"], [800], reads)

    cfg = CallConfig(platform="ilmn", bam_fn=bam, ref_fn=fasta,
                     output_dir=str(tmp_path / "out"),
                     var_pct_full=1.0, ref_pct_full=1.0,
                     no_phasing_for_fa=True)
    outputs = VariantCaller(cfg, pileup_engine=PileupOracleEngine(),
                            fa_engine=FullAlignmentOracleEngine()).run()
    recs = list(VcfReader(outputs["merge_output"]))
    by_pos = {r.pos: r for r in recs}
    anchor1 = del_start  # 1-based anchor = del_start (0-based anchor del_start-1)
    assert anchor1 in by_pos, f"deletion not called; calls at {sorted(by_pos)}"
    rec = by_pos[anchor1]
    assert rec.ref == ref[del_start - 1: del_start + del_len]
    assert rec.alt == ref[del_start - 1]
    # exactly ONE representation survives inside the window, and it is the
    # FA call (INFO tag F): the raw-BAM pileup saw the deletion as shifted
    # SNP candidates, which the region merge must drop
    in_window = [r for r in recs if abs(r.pos - anchor1) <= 50]
    assert all(r.info == "F" for r in in_window), (
        [(r.pos, r.info, r.ref, r.alt) for r in in_window])
    indels = [r for r in in_window if len(r.ref) != len(r.alt or "")]
    assert len(indels) == 1

    # the pileup VCF alone (raw BAM) must NOT contain the true deletion --
    # proving the FA stage, not the pileup, recovered it
    pileup_recs = list(VcfReader(outputs["pileup"]))
    assert not any(r.pos == anchor1 and len(r.ref) == del_len + 1
                   for r in pileup_recs)
    # and the region windows were materialized for inspection
    import os

    assert os.path.exists(os.path.join(str(tmp_path / "out"), "tmp",
                                       "full_aln_regions.bed"))


def test_dbg_native_matches_python():
    """Native DBG (clair3t_dbg.cc) must return set-identical haplotypes to
    the Python implementation across random windows with SNVs and indels."""
    import random

    from clair3_tpu_torch.native import native_available

    if not native_available():
        import pytest

        pytest.skip("native library unavailable")
    rng = random.Random(33)
    for trial in range(30):
        n = rng.randint(80, 200)
        ref = "".join(rng.choice("ACGT") for _ in range(n))
        # plant a variant
        pos = rng.randint(25, n - 25)
        kind = rng.choice(["snv", "ins", "del"])
        if kind == "snv":
            alt_hap = ref[:pos] + rng.choice([b for b in "ACGT" if b != ref[pos]]) + ref[pos + 1:]
        elif kind == "ins":
            alt_hap = ref[:pos] + "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 6))) + ref[pos:]
        else:
            alt_hap = ref[:pos] + ref[pos + rng.randint(1, 6):]
        reads = []
        for _ in range(rng.randint(4, 14)):
            src = alt_hap if rng.random() < 0.5 else ref
            s = rng.randint(0, max(0, len(src) - 60))
            e = min(len(src), s + rng.randint(40, 80))
            seq = list(src[s:e])
            if rng.random() < 0.3 and seq:  # sprinkle a sequencing error
                i = rng.randrange(len(seq))
                seq[i] = rng.choice("ACGTN")
            reads.append("".join(seq))
        py = consensus_haplotypes(reads, ref, use_native=False)
        nat = consensus_haplotypes(reads, ref, use_native=True)
        assert sorted(py) == sorted(nat), f"trial {trial} kind {kind}"


def test_dbg_native_k_escalation_and_ref_only():
    from clair3_tpu_torch.native import native_available

    if not native_available():
        import pytest

        pytest.skip("native library unavailable")
    # window shorter than the smallest k: both return just the reference
    short = "ACGTACGTACGT"
    assert consensus_haplotypes([], short, use_native=True) == [short]
    assert consensus_haplotypes([], short, use_native=False) == [short]
    # a tandem repeat forces a cycle at small k -> escalation to larger k
    ref = "ACGTTGCA" + "AT" * 20 + "GGCTTACG" + "ACGTTGCAGGCTAACG" * 3
    reads = [ref[5:60], ref[20:90], ref[40:]]
    py = consensus_haplotypes(reads, ref, use_native=False)
    nat = consensus_haplotypes(reads, ref, use_native=True)
    assert sorted(py) == sorted(nat)
    # k > 31 cannot be 2-bit packed: wrapper must fall back, not crash
    big_k = consensus_haplotypes(reads, ref, k_range=(35,), use_native=None)
    assert sorted(big_k) == sorted(
        consensus_haplotypes(reads, ref, k_range=(35,), use_native=False))


def test_window_events_respect_quality_gates():
    """MQ<20 reads and BQ<20 mismatches contribute no events
    (RealignReads.py:258-275 min_dbg_* thresholds)."""
    ref = random_reference(400, seed=85)
    lowmq = _misaligned_del_reads(ref, 200, 4)
    lowmq = [BamRead(r.qname, r.flag, r.tid, r.pos, 10, r.cigar, r.seq, r.qual)
             for r in lowmq]
    assert select_realignment_windows(lowmq, ref, 0, 0, 400) == []

    lowbq = _misaligned_del_reads(ref, 200, 4)
    lowbq = [BamRead(r.qname, r.flag, r.tid, r.pos, 60, r.cigar, r.seq,
                     np.full(len(r.seq), 10, np.uint8)) for r in lowbq]
    assert select_realignment_windows(lowbq, ref, 0, 0, 400) == []


def test_window_softclips_count_as_events():
    """Soft clips spread events over +/- their length
    (RealignReads.py:279-292 'I' and 'S' share a branch)."""
    ref = random_reference(400, seed=86)
    reads = []
    for i in range(6):
        s = 150 + i
        seq = ref[s: s + 60] + "ACGTACGTAC"   # 10bp clipped tail
        reads.append(BamRead(
            f"c{i}", 0, 0, s, 60, [(0, 60), (4, 10)], seq,
            np.full(len(seq), 30, np.uint8)))
    wins = select_realignment_windows(reads, ref, 0, 0, 400)
    assert len(wins) == 1
    # events centered at the clip anchor ~210
    assert wins[0].start <= 210 <= wins[0].end


def test_window_clustering_distance():
    """Candidates > 2x min_windows_distance apart form separate windows,
    each padded by min_windows_distance (RealignReads.py:469-489)."""
    from clair3_tpu_torch.realign.realigner import MIN_WINDOWS_DISTANCE

    ref = random_reference(1200, seed=87)
    reads = _misaligned_del_reads(ref, 200, 4) + [
        BamRead(r.qname + "b", r.flag, r.tid, r.pos + 700, r.mapq, r.cigar,
                r.seq, r.qual)
        for r in _misaligned_del_reads(ref, 200, 4)
    ]
    # second cluster's reads carry first-cluster sequence at +700: plenty of
    # mismatches there too
    wins = select_realignment_windows(reads, ref, 0, 0, 1200)
    assert len(wins) >= 2
    gap = wins[1].start - wins[0].end
    assert gap > 0
    for w in wins:
        assert w.end - w.start >= 2 * MIN_WINDOWS_DISTANCE


def test_assign_reads_max_overlap_single_window():
    """A read overlapping two windows realigns only in the best-overlap one
    (RealignReads.py find_max_overlap_index)."""
    from clair3_tpu_torch.realign.realigner import Window, assign_reads_to_windows

    r = BamRead("r", 0, 0, 100, 60, [(0, 80)], "A" * 80,
                np.full(80, 30, np.uint8))
    w1 = Window(90, 140)    # overlap 40
    w2 = Window(150, 300)   # overlap 30
    got = assign_reads_to_windows([r], [w1, w2])
    assert got[w1] == [0]
    assert got[w2] == []


def test_realignment_full_read_span_haplotypes():
    """Reads extending far past the window still realign end-to-end: the
    haplotype is extended over the assigned reads' span +/- 20bp
    (RealignReads.py:536-558)."""
    ref = random_reference(600, seed=88)
    del_start, del_len = 300, 5
    alt = ref[:del_start] + ref[del_start + del_len:]
    reads = []
    for i in range(14):
        s = del_start - 160 + (i * 9) % 40   # long left anchor
        seq = alt[s: s + 220]
        reads.append(BamRead(
            f"L{i}", 0, 0, s, 60, [(0, len(seq))], seq,
            np.full(len(seq), 30, np.uint8)))
    out, n = realign_reads_in_region(reads, ref, 0, 0, 600)
    assert n >= 10
    with_del = [r for r in out if any(op == 2 and ln == del_len
                                      for op, ln in r.cigar)]
    assert len(with_del) >= 10
    # deletion placed at (an equivalent shift of) the true coordinate
    for r in with_del:
        rp = r.pos
        for op, ln in r.cigar:
            if op == 2:
                assert abs(rp - del_start) <= del_len
                break
            if op in (0, 7, 8):
                rp += ln


ILMN_BP = 20_000


def test_ilmn_cli_matches_the_jax_cli(tmp_path):
    """`call --platform ilmn` through the port's CLI and the JAX CLI, both at
    f32 on the CPU with the committed hifi nets (the ilmn preset has hifi's
    geometry: depth 55, 8 channels), on 150 bp reads: the rows are
    numerically equivalent with no routing flip (``_equivalent_ilmn_rows``),
    and the realigned BAM and its windows (tmp/full_aln_regions.bed) are
    identical."""
    import gzip
    import os
    import random

    from clair3_tpu.cli import main as jax_main
    from clair3_tpu_torch.cli import main as port_main
    from clair3_tpu_torch.testing import SimVariant, trained_fixture_path, write_test_case

    ref = random_reference(ILMN_BP, seed=61)
    rng = random.Random(61)
    variants = []
    for p in range(300, ILMN_BP - 300, 240):
        gt = (1, 1) if rng.random() < 0.4 else (0, 1)
        kind = rng.random()
        if kind < 0.6:
            variants.append(SimVariant(p, ref[p], rng.choice([b for b in "ACGT" if b != ref[p]]),
                                       gt))
        elif kind < 0.8:
            variants.append(SimVariant(p, ref[p], ref[p] + "".join(
                rng.choice("ACGT") for _ in range(rng.randint(1, 4))), gt))
        else:
            variants.append(SimVariant(p, ref[p:p + rng.randint(2, 5)], ref[p], gt))
    fasta, bam, _, _ = write_test_case(str(tmp_path), ref_length=ILMN_BP, variants=variants,
                                       coverage=30, read_length=150, seed=61, error_rate=0.01)
    models = ["--pileup_model", trained_fixture_path("pileup_hifi.npz"),
              "--full_alignment_model", trained_fixture_path("fa_hifi.npz")]
    args = ["call", "--bam_fn", bam, "--ref_fn", fasta, "--platform", "ilmn", "--threads", "2",
            "--compute_dtype", "fp32", *models]
    assert jax_main(args + ["--output", str(tmp_path / "jax")]) == 0
    assert port_main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0

    def rows(side, name):
        with gzip.open(os.path.join(tmp_path, side, name), "rt") as fh:
            return [line for line in fh if not line.startswith("#")]

    for name in ("pileup.vcf.gz", "full_alignment.vcf.gz", "merge_output.vcf.gz"):
        a, b = rows("jax", name), rows("port", name)
        ok, stats, n_high, high_dqual = _equivalent_ilmn_rows(a, b)
        print(f"[port-ilmn] {name}: {len(set(a) & set(b))}/{len(a)} rows byte-identical, "
              f"max dQUAL {stats['max_dqual']:.2f} below QUAL {QUAL_SATURATES}, "
              f"{high_dqual:.2f} on the {n_high} rows above, flips {stats['flips']}")
        assert len(a) > 10 and ok, stats["violations"][:5]
    for rel in ("full_aln_regions.bed", "realigned.bam"):
        got = [(tmp_path / side / "tmp" / rel).read_bytes() for side in ("jax", "port")]
        assert got[0] == got[1] and len(got[0]) > 0, rel
