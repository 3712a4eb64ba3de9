"""Frozen copy of the read simulator of ``clair3_tpu_torch/testing.py``
(``SimVariant`` .. ``simulate_reads``), the distribution the committed
fixture nets were trained on.  The benchmark keeps its own copy so that a
change to the program cannot move the traffic it is measured on.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.reference.frozen.io.bam import BamRead

BASES = "ACGT"

_FA_BASE_FROM_VAL = {100: "A", 25: "C", 75: "G", 50: "T"}


@dataclass(frozen=True)
class SimVariant:
    """A diploid variant at 0-based position ``pos`` (left-aligned)."""

    pos: int
    ref: str
    alt: str
    genotype: Tuple[int, int]  # e.g. (0,1) het, (1,1) hom

    @property
    def is_snp(self) -> bool:
        return len(self.ref) == 1 and len(self.alt) == 1


def random_reference(length: int, seed: int = 0) -> str:
    rng = random.Random(seed)
    return "".join(rng.choice(BASES) for _ in range(length))


def _read_from_reference(
    ref: str,
    start: int,
    end: int,
    variants_by_pos: Dict[int, SimVariant],
    hap: int,
    rng: random.Random,
    error_rate: float = 0.0,
) -> Tuple[str, List[Tuple[int, int]]]:
    """Build (seq, cigar) for a read spanning reference [start, end) on
    haplotype ``hap`` (0 or 1).  Variant alts are injected with exact CIGARs."""
    seq: List[str] = []
    cigar: List[Tuple[int, int]] = []

    def emit(op: int, length: int) -> None:
        if length == 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + length)
        else:
            cigar.append((op, length))

    i = start
    while i < end:
        var = variants_by_pos.get(i)
        apply_alt = var is not None and var.genotype[hap] == 1
        if not apply_alt:
            base = ref[i]
            if error_rate and rng.random() < error_rate:
                base = rng.choice([b for b in BASES if b != base])
            seq.append(base)
            emit(0, 1)  # M
            i += 1
            continue
        if var.is_snp:
            seq.append(var.alt)
            emit(0, 1)
            i += 1
        elif len(var.alt) > len(var.ref):  # insertion after anchor base
            seq.append(var.alt[0])
            emit(0, 1)
            ins = var.alt[1:]
            seq.append(ins)
            emit(1, len(ins))  # I
            i += 1
        else:  # deletion
            seq.append(var.alt[0])
            emit(0, 1)
            dlen = len(var.ref) - len(var.alt)
            emit(2, dlen)  # D
            i += 1 + dlen
    return "".join(seq), cigar


def simulate_reads(
    ref: str,
    variants: Sequence[SimVariant],
    coverage: int = 30,
    read_length: int = 500,
    seed: int = 0,
    error_rate: float = 0.0,
    mapq: int = 60,
    baseq: int = 30,
    contig: str = "chr1",
    with_hp_tags: bool = False,
    with_mv_tags: bool = False,
) -> List[BamRead]:
    """Tile reads across the reference at the requested coverage, alternating
    haplotypes and strands.  Returns coordinate-sorted BamReads."""
    rng = random.Random(seed)
    variants_by_pos = {v.pos: v for v in variants}
    reads: List[BamRead] = []
    n_per_layer = max(1, (len(ref) + read_length - 1) // read_length)
    idx = 0
    for layer in range(coverage):
        offset = int(read_length * layer / coverage) % read_length
        start = -offset if offset else 0
        while start < len(ref):
            s = max(0, start)
            e = min(len(ref), start + read_length)
            if e - s >= 50:
                hap = (layer + (1 if start < 0 else 0)) % 2
                seq, cigar = _read_from_reference(
                    ref, s, e, variants_by_pos, hap, rng, error_rate)
                flag = 0 if (idx % 2 == 0) else 16
                tags: Dict = {}
                if with_hp_tags:
                    tags["HP"] = hap + 1
                if with_mv_tags:
                    # per-base dwell of 1-3 signal blocks: "1" then k-1 zeros
                    mv = [5]
                    for k in range(len(seq)):
                        blocks = 1 + (s + k) % 3
                        mv.append(1)
                        mv.extend([0] * (blocks - 1))
                    tags["mv"] = np.array(mv, np.int8)
                reads.append(
                    BamRead(
                        qname=f"read_{idx}",
                        flag=flag,
                        tid=0,
                        pos=s,
                        mapq=mapq,
                        cigar=cigar,
                        seq=seq,
                        qual=np.full(len(seq), baseq, np.uint8),
                        tags=tags,
                    )
                )
                idx += 1
            start += read_length
    reads.sort(key=lambda r: r.pos)
    return reads

