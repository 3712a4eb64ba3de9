"""Read-backed het-SNP phasing.

The reference shells out to whatshap or longphase for the intermediate
phasing stage (clair3_c_impl_pipeline.py:405-442); neither exists in this
image, so clair3_tpu_torch carries its own phaser.  The algorithm is the
long-read chain reduction both tools rely on:

1. per read, extract the allele (ref=0 / alt=1) at every covered het SNP,
2. for each read, vote on the relative phase of *consecutive* covered SNPs
   (equal alleles -> same haplotype, different -> opposite),
3. sweep left to right assigning haplotypes greedily from the accumulated
   votes; SNPs with no read connection to the growing block open a new
   phase set (PS = 1-based position of the set's first variant, the
   whatshap convention the FA extractor consumes),
4. MEC refinement: alternate between assigning each read fragment to the
   haplotype it mismatches least and re-setting each SNP's phase to the
   majority among its assigned fragments, until a fixed point.  Each half
   step minimizes the minimum-error-correction objective exactly given the
   other, so the MEC score is non-increasing and the loop terminates; this
   repairs greedy mistakes at SNPs whose consecutive edge was noisy but
   whose long-range fragment support is clear.

Output rows carry ``GT:PS`` with ``0|1`` meaning hap1=ref (genotype code 1
in the FA extractor) and ``1|0`` meaning hap1=alt (code 2).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from clair3_tpu_torch.io.bam import BamRead, BamReader
from clair3_tpu_torch.io.vcf import VcfRecord

MIN_PHASING_MQ = 20


def read_alleles_at_snps(
    read: BamRead, snp_positions: Sequence[int], snp_ref: Dict[int, str],
    snp_alt: Dict[int, str],
) -> List[Tuple[int, int]]:
    """(position0, allele) for het SNPs covered by matched bases."""
    out: List[Tuple[int, int]] = []
    targets = [p for p in snp_positions if read.pos <= p < read.reference_end]
    if not targets:
        return out
    tset = set(targets)
    ref_pos = read.pos
    query_pos = 0
    for op, length in read.cigar:
        if op in (0, 7, 8):
            for p in range(max(ref_pos, targets[0]), ref_pos + length):
                if p in tset:
                    base = read.seq[query_pos + (p - ref_pos)]
                    if base == snp_ref[p]:
                        out.append((p, 0))
                    elif base == snp_alt[p]:
                        out.append((p, 1))
            ref_pos += length
            query_pos += length
        elif op == 2 or op == 3:
            ref_pos += length
        elif op in (1, 4):
            query_pos += length
    return out


def refine_mec(
    hap: List[int],
    fragments: Sequence[Sequence[Tuple[int, int]]],
    max_iters: int = 20,
) -> List[int]:
    """Alternating MEC local search (HapCUT-style heuristic).

    ``hap[i]`` encodes SNP i's orientation (0 = ``0|1``: haplotype A carries
    the ref allele).  ``fragments`` are per-read [(snp_index, allele)] lists.
    Returns the (possibly) improved orientation vector.
    """
    hap = list(hap)
    for _ in range(max_iters):
        # (a) assign each fragment to its best haplotype
        sides: List[int] = []
        for frag in fragments:
            mis_a = sum(1 for i, a in frag if a != hap[i])
            mis_b = len(frag) - mis_a
            sides.append(0 if mis_a <= mis_b else 1)
        # (b) per SNP, majority vote among assigned fragments (tie: keep)
        votes: Dict[int, int] = defaultdict(int)
        for frag, side in zip(fragments, sides):
            for i, a in frag:
                want = a if side == 0 else 1 - a
                votes[i] += 1 if want == 1 else -1
        changed = False
        for i, v in votes.items():
            new = hap[i] if v == 0 else (1 if v > 0 else 0)
            if new != hap[i]:
                hap[i] = new
                changed = True
        if not changed:
            break
    return hap


def rescue_phase_sets(
    hap: List[int],
    phase_set: List[int],
    fragments: Sequence[Sequence[Tuple[int, int]]],
) -> Tuple[List[int], List[int]]:
    """Cross-phase-set read rescue: merge adjacent phase sets whose relative
    orientation is pinned by fragments spanning the boundary.

    The greedy sweep opens a new set whenever SNP j's incoming edge votes
    cancel — but fragments reaching PAST j (coverage gaps, one noisy SNP)
    can still fix the relative orientation of the two blocks.  For every
    adjacent block pair we vote over all spanning fragment allele pairs:
    agreement of (allele_i == allele_j) with (hap_i == hap_j) keeps block B,
    net disagreement flips it; zero net vote leaves the split in place
    (longphase/whatshap behave the same way on truly unlinked blocks)."""
    hap = list(hap)
    phase_set = list(phase_set)
    n = len(hap)
    if n == 0:
        return hap, phase_set
    # contiguous blocks in SNP order
    k = 0
    while True:
        # find current block boundaries each iteration (merges shift them)
        blocks: List[Tuple[int, int]] = []  # [start, end) index ranges
        s = 0
        for i in range(1, n + 1):
            if i == n or phase_set[i] != phase_set[s]:
                blocks.append((s, i))
                s = i
        if k >= len(blocks) - 1:
            break
        a_lo, a_hi = blocks[k]
        b_lo, b_hi = blocks[k + 1]
        vote = 0
        for frag in fragments:
            in_a = [(i, a) for i, a in frag if a_lo <= i < a_hi]
            in_b = [(i, a) for i, a in frag if b_lo <= i < b_hi]
            for i, ai in in_a:
                for j, aj in in_b:
                    same_alleles = ai == aj
                    same_hap = hap[i] == hap[j]
                    vote += 1 if same_alleles == same_hap else -1
        if vote == 0:
            k += 1
            continue
        if vote < 0:
            for j in range(b_lo, b_hi):
                hap[j] = 1 - hap[j]
        for j in range(b_lo, b_hi):
            phase_set[j] = phase_set[a_lo]
        # stay on block k: the merged block may now link to the next one
    return hap, phase_set


class ReadBackedPhaser:
    """Phases pileup het SNPs per contig directly from the BAM."""

    def __init__(self, bam_fn: str, min_mq: int = MIN_PHASING_MQ):
        self.bam_fn = bam_fn
        self.min_mq = min_mq

    def phase(self, ctg_name: str, het_snps: Sequence[VcfRecord]) -> List[VcfRecord]:
        snps = sorted(
            (r for r in het_snps if len(r.ref) == 1 and len(r.alt) == 1),
            key=lambda r: r.pos,
        )
        if not snps:
            return []
        positions = [r.pos - 1 for r in snps]  # 0-based
        index = {p: i for i, p in enumerate(positions)}
        snp_ref = {r.pos - 1: r.ref for r in snps}
        snp_alt = {r.pos - 1: r.alt for r in snps}

        # accumulate relative-phase votes on consecutive-SNP edges, keeping
        # the full fragments for the MEC refinement pass
        edge_votes: Dict[Tuple[int, int], int] = defaultdict(int)
        fragments: List[List[Tuple[int, int]]] = []
        bam = BamReader(self.bam_fn)
        for read in bam.fetch(ctg_name, positions[0], positions[-1] + 1,
                              min_mq=self.min_mq):
            alleles = read_alleles_at_snps(read, positions, snp_ref, snp_alt)
            for (p1, a1), (p2, a2) in zip(alleles, alleles[1:]):
                i, j = index[p1], index[p2]
                edge_votes[(i, j)] += 1 if a1 == a2 else -1
            if len(alleles) >= 2:
                fragments.append([(index[p], a) for p, a in alleles])

        # incoming edges per SNP for the left-to-right sweep
        incoming: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for (i, j), w in edge_votes.items():
            incoming[j].append((i, w))

        hap: List[Optional[int]] = [None] * len(snps)
        phase_set: List[int] = [0] * len(snps)
        current_ps = snps[0].pos
        hap[0] = 0
        phase_set[0] = current_ps
        for j in range(1, len(snps)):
            vote = 0
            for i, w in incoming[j]:
                if hap[i] is not None:
                    vote += w * (1 - 2 * hap[i])
            if vote == 0:
                # unconnected (or perfectly ambiguous): new phase set
                current_ps = snps[j].pos
                hap[j] = 0
            else:
                hap[j] = 0 if vote > 0 else 1
            phase_set[j] = current_ps

        hap = refine_mec(hap, fragments)
        hap, phase_set = rescue_phase_sets(hap, phase_set, fragments)
        hap = refine_mec(hap, fragments)

        out: List[VcfRecord] = []
        for rec, h, ps in zip(snps, hap, phase_set):
            gt = "0|1" if h == 0 else "1|0"
            out.append(VcfRecord(
                rec.chrom, rec.pos, rec.ref, rec.alt, rec.qual, rec.filter,
                rec.info, "GT:PS", f"{gt}:{ps}", id=rec.id,
            ))
        return out
