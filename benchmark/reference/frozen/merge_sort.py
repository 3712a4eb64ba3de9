"""VCF row merging and sorting (library ports of preprocess/MergeVcf.py and
preprocess/SortVcf.py)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MAJOR_CONTIGS_ORDER = (
    ["chr" + str(a) for a in list(range(1, 23)) + ["X", "Y"]]
    + [str(a) for a in list(range(1, 23)) + ["X", "Y"]]
)


def _row_fields(row: str) -> Tuple[str, int, str, str, float, str]:
    cols = row.rstrip("\n").split("\t")
    return cols[0], int(cols[1]), cols[3], cols[4], float(cols[5]), cols[9]


def mark_low_qual(row: str, qual_cutoff: Optional[float]) -> str:
    """FILTER -> LowQual when qual <= cutoff (MergeVcf.py:49-57)."""
    if not row or not qual_cutoff:
        return row
    cols = row.rstrip("\n").split("\t")
    if float(cols[5]) <= qual_cutoff:
        cols[6] = "LowQual"
        return "\t".join(cols) + "\n"
    return row


def update_haploid_precise_genotype(row: str) -> str:
    cols = row.rstrip("\n").split("\t")
    info = cols[9].split(":")
    gt = info[0].replace("|", "/")
    if gt == "1/1":
        genotype = ["1"]
    elif gt == "0/0":
        genotype = ["0"]
    else:
        return ""
    cols[9] = ":".join(genotype + info[1:])
    return "\t".join(cols) + "\n"


def update_haploid_sensitive_genotype(row: str) -> str:
    cols = row.rstrip("\n").split("\t")
    info = cols[9].split(":")
    gt = info[0].replace("|", "/")
    if "," in cols[4]:
        return ""
    genotype = ["1"] if gt in ("0/1", "1/0", "1/1") else ["0"]
    cols[9] = ":".join(genotype + info[1:])
    return "\t".join(cols) + "\n"


def merge_pileup_and_full_alignment(
    pileup_rows: Iterable[str],
    full_alignment_rows: Iterable[str],
    contig: Optional[str] = None,
    qual_cutoff: Optional[float] = None,
    print_ref_calls: bool = False,
    haploid_precise: bool = False,
    haploid_sensitive: bool = False,
) -> List[str]:
    """Full-alignment calls win at their positions; pileup calls are kept
    everywhere else; result sorted by position (MergeVcf.py:158-258)."""
    fa_set = set()
    merged: List[Tuple[int, str]] = []
    for row in full_alignment_rows:
        if row.startswith("#"):
            continue
        ctg, pos, ref, alt, qual, _ = _row_fields(row)
        if contig is not None and ctg != contig:
            continue
        fa_set.add((ctg, pos))
        is_reference = alt == "." or ref == alt
        if haploid_precise:
            row = update_haploid_precise_genotype(row)
        if haploid_sensitive:
            row = update_haploid_sensitive_genotype(row)
        if not row:
            continue
        if not is_reference:
            merged.append((pos, mark_low_qual(row, qual_cutoff)))
        elif print_ref_calls:
            merged.append((pos, row))

    for row in pileup_rows:
        if row.startswith("#"):
            continue
        ctg, pos, ref, alt, qual, _ = _row_fields(row)
        if contig is not None and ctg != contig:
            continue
        if (ctg, pos) in fa_set:
            continue
        is_reference = alt == "." or ref == alt
        if haploid_precise:
            row = update_haploid_precise_genotype(row)
        if haploid_sensitive:
            row = update_haploid_sensitive_genotype(row)
        if not row:
            continue
        if not is_reference:
            merged.append((pos, mark_low_qual(row, qual_cutoff)))
        elif print_ref_calls:
            merged.append((pos, row))

    merged.sort(key=lambda x: x[0])
    return [row for _, row in merged]


def sort_rows(
    rows: Iterable[str], contigs: Optional[Sequence[str]] = None
) -> List[str]:
    """Sort VCF body rows in major-contig order then by position, deduping
    by (contig, position) with last-write-wins (SortVcf.py:115-148)."""
    contig_dict: Dict[str, Dict[int, str]] = defaultdict(dict)
    for row in rows:
        if not row or row.startswith("#"):
            continue
        cols = row.split("\t", 2)
        contig_dict[cols[0]][int(cols[1])] = row
    seen = list(contig_dict.keys()) if contigs is None else list(contigs)
    order = list(MAJOR_CONTIGS_ORDER) + seen
    ordered_contigs = sorted(contig_dict.keys(), key=lambda x: order.index(x))
    out: List[str] = []
    for ctg in ordered_contigs:
        for pos in sorted(contig_dict[ctg]):
            out.append(contig_dict[ctg][pos])
    return out
