"""Candidate routing between the pileup and full-alignment stages.

Library-function ports of the reference's per-contig subprocesses:
* ``select_phase_qual`` — qual cutoff for phasing het SNPs (SelectQual.py:10-48)
* ``select_qual`` — (variant, ref) qual cutoffs for FA re-calling (SelectQual.py:52-111)
* ``select_het_snps`` — het SNP subset for the phaser (SelectHetSnp.py:12-78)
* ``select_candidates`` — low-qual candidate batching with phased-SNP
  attachment windows (SelectCandidates.py:128-342)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from benchmark.reference.frozen.io.vcf import VcfRecord


def sequence_entropy(seq: str, k: int = 5) -> float:
    """Normalized k-mer Shannon entropy of a window (0 = homopolymer,
    -> 1 = maximally diverse).  Low-complexity regions (homopolymers,
    tandem repeats) score low; the reference routes such candidates to
    full-alignment re-calling (SelectCandidates.py:41-125 computes the
    same k-mer-distribution entropy with an incremental slide)."""
    import math

    n = len(seq) - k + 1
    if n <= 1:
        return 0.0
    counts: Dict[str, int] = {}
    for i in range(n):
        kmer = seq[i: i + k]
        counts[kmer] = counts.get(kmer, 0) + 1
    h = -sum((c / n) * math.log(c / n) for c in counts.values())
    return h / math.log(n)


def low_entropy_candidates(
    ref_calls: Sequence[Tuple[int, float]],
    var_calls: Sequence[Tuple[int, float]],
    fetch_window,
    var_pct_full: float,
    seq_entropy_pro: float,
) -> List[int]:
    """Positions whose flanking reference window has the lowest sequence
    entropy, drawn from the lowest-QUAL (var_pct_full + seq_entropy_pro)
    fraction of both call lists (SelectCandidates.py:222-233).

    ``fetch_window(pos1)`` returns the 33bp reference window centered on
    the 1-based position."""
    frac = var_pct_full + seq_entropy_pro
    pool = [p for p, _ in sorted(ref_calls, key=lambda x: x[1])[: int(frac * len(ref_calls))]]
    pool += [p for p, _ in sorted(var_calls, key=lambda x: x[1])[: int(frac * len(var_calls))]]
    pool = sorted(set(pool))
    scored = [(p, sequence_entropy(fetch_window(p))) for p in pool]
    scored.sort(key=lambda x: x[1])
    return [p for p, _ in scored[: int(seq_entropy_pro * len(scored))]]


@dataclass
class CandidateBatch:
    """One full-alignment work unit: candidate positions (1-based) plus the
    phased het SNPs overlapping the batch's +-phasing_window_size window
    ('ref-alt-hap-phaseset' descriptors, SelectCandidates.py:322-342)."""

    contig: str
    positions: List[int]
    phased_snps: List[Tuple[int, str]]


# ---------------------------------------------------------------------------
# Compact pileup statistics: the WGS-scale path.  Parsing a VcfRecord per
# pileup row costs O(genome) objects (~10^7 on a real genome); routing only
# needs (pos, qual) arrays plus a few flags, collected in one pass.
# ---------------------------------------------------------------------------

@dataclass
class PileupStats:
    """Per-contig routing arrays over the pileup rows (insertion order)."""

    contigs: List[str]
    pos: Dict[str, "np.ndarray"]        # 1-based positions
    qual: Dict[str, "np.ndarray"]       # float64 QUALs (exact parity with
                                        # the record path cutoff compares)
    gt_ref: Dict[str, "np.ndarray"]     # sample GT == "0/0" (SelectQual buckets)
    ref_call: Dict[str, "np.ndarray"]   # ALT=="." or REF==ALT (SelectCandidates buckets)
    het_idx: Dict[str, "np.ndarray"]    # global row indices of 1bp het SNPs
    phaseq_mask: Dict[str, "np.ndarray"]  # of het_idx rows: GT == "0/1" exactly


def collect_pileup_stats(rows: Sequence[str]) -> PileupStats:
    """Single pass over raw VCF body rows (strings)."""
    import numpy as np  # noqa: F811

    contigs: List[str] = []
    buf: Dict[str, list] = {}
    for i, row in enumerate(rows):
        cols = row.split("\t", 10)
        chrom = cols[0]
        b = buf.get(chrom)
        if b is None:
            b = buf[chrom] = [[], [], [], [], [], []]
            contigs.append(chrom)
        ref, alt = cols[3], cols[4]
        qual = float(cols[5])
        gt = cols[9].split(":", 1)[0]
        b[0].append(int(cols[1]))
        b[1].append(qual)
        b[2].append(gt == "0/0")
        b[3].append(alt == "." or ref == alt)
        if len(ref) == 1 and len(alt) == 1 and \
                gt.replace("|", "/") in ("0/1", "1/0"):
            b[4].append(i)
            b[5].append(gt == "0/1")
    return PileupStats(
        contigs=contigs,
        pos={c: np.asarray(b[0], np.int64) for c, b in buf.items()},
        qual={c: np.asarray(b[1], np.float64) for c, b in buf.items()},
        gt_ref={c: np.asarray(b[2], bool) for c, b in buf.items()},
        ref_call={c: np.asarray(b[3], bool) for c, b in buf.items()},
        het_idx={c: np.asarray(b[4], np.int64) for c, b in buf.items()},
        phaseq_mask={c: np.asarray(b[5], bool) for c, b in buf.items()},
    )


def select_qual_from_stats(
    stats: PileupStats, var_pct_full: float, ref_pct_full: float
) -> Tuple[float, float]:
    """Array form of :func:`select_qual` (identical cutoffs)."""
    import numpy as np  # noqa: F811

    var_parts = [stats.qual[c][~stats.gt_ref[c]] for c in stats.contigs]
    ref_parts = [stats.qual[c][stats.gt_ref[c]] for c in stats.contigs]
    var_quals = np.sort(np.concatenate(var_parts)) if var_parts else np.empty(0)
    ref_quals = np.sort(np.concatenate(ref_parts)) if ref_parts else np.empty(0)
    n_var = int(var_pct_full * len(var_quals))
    n_ref = int(ref_pct_full * len(ref_quals))
    return (float(var_quals[n_var - 1]) if n_var else 0.0,
            float(ref_quals[n_ref - 1]) if n_ref else 0.0)


def select_phase_qual_from_stats(
    stats: PileupStats, var_pct_phasing: float
) -> float:
    """Array form of :func:`select_phase_qual` (identical cutoff)."""
    import numpy as np  # noqa: F811

    parts = [
        stats.qual[c][stats.het_idx[c] - _first_index(stats, c)][stats.phaseq_mask[c]]
        for c in stats.contigs
    ]
    quals = np.sort(np.concatenate(parts)) if parts else np.empty(0)
    n = int((1 - var_pct_phasing) * len(quals))
    return float(quals[n - 1]) if n else 0.0


def _first_index(stats: PileupStats, contig: str) -> int:
    """Global row index of the contig's first row (rows are contig-grouped)."""
    off = 0
    for c in stats.contigs:
        if c == contig:
            return off
        off += len(stats.pos[c])
    raise KeyError(contig)


def select_het_snps_from_stats(
    rows: Sequence[str], stats: PileupStats, phase_qual_cutoff: float,
    contig: str,
) -> List[VcfRecord]:
    """Array-driven form of :func:`select_het_snps`: parses ONLY the het-SNP
    rows above the cutoff instead of every pileup row."""
    from benchmark.reference.frozen.io.vcf import parse_vcf_line

    if contig not in stats.qual:
        return []
    off = _first_index(stats, contig)
    out = []
    for i in stats.het_idx[contig]:
        if stats.qual[contig][i - off] >= phase_qual_cutoff:
            out.append(parse_vcf_line(rows[i]))
    return out


def select_candidates_from_stats(
    stats: PileupStats,
    contig: str,
    var_qual_cutoff: float,
    ref_qual_cutoff: float,
    phased_rows: Sequence[VcfRecord] = (),
    split_bed_size: int = 10_000,
    phasing_window_size: int = 100_000,
    call_low_seq_entropy: bool = False,
    seq_entropy_pro: float = 0.05,
    var_pct_full: float = 0.3,
    fetch_window=None,
) -> List[CandidateBatch]:
    """Array form of :func:`select_candidates` (identical batches)."""
    import numpy as np  # noqa: F811

    if contig not in stats.qual:
        return []
    variant_dict: Dict[int, str] = {}
    for rec in phased_rows:
        if rec.chrom != contig:
            continue
        gt_info = rec.sample.split(":")
        genotype, phase_set = gt_info[0], gt_info[-1]
        if "|" not in genotype:
            continue
        hap = "1" if genotype == "0|1" else "2"
        variant_dict[rec.pos] = "-".join([rec.ref, rec.alt, hap, phase_set])

    pos = stats.pos[contig]
    qual = stats.qual[contig]
    is_ref = stats.ref_call[contig]
    low = np.where(is_ref, qual < ref_qual_cutoff, qual < var_qual_cutoff)
    extra: List[int] = []
    if call_low_seq_entropy and fetch_window is not None:
        ref_calls = list(zip(pos[is_ref].tolist(), qual[is_ref].tolist()))
        var_calls = list(zip(pos[~is_ref].tolist(), qual[~is_ref].tolist()))
        extra = low_entropy_candidates(
            ref_calls, var_calls, fetch_window,
            var_pct_full=var_pct_full, seq_entropy_pro=seq_entropy_pro)
    positions = sorted(set(pos[low].tolist()) | set(extra))
    if not positions:
        return []

    snp_positions = sorted(variant_dict)
    batches: List[CandidateBatch] = []
    n_batches = (len(positions) + split_bed_size - 1) // split_bed_size
    for idx in range(n_batches):
        chunk = positions[idx * split_bed_size: (idx + 1) * split_bed_size]
        lo = chunk[0] - phasing_window_size
        hi = chunk[-1] + phasing_window_size
        snps = [(p, variant_dict[p]) for p in snp_positions if lo <= p < hi]
        batches.append(CandidateBatch(contig, chunk, snps))
    return batches
