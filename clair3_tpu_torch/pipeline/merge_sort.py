"""VCF row merging and sorting (library ports of preprocess/MergeVcf.py and
preprocess/SortVcf.py)."""

from __future__ import annotations

import os
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


class RegionIndex:
    """Point-membership index over full-alignment region windows
    (reference: bed_tree_from with padding, shared/interval_tree.py:8-56).

    The reference SHRINKS each BED row by ``padding`` on both sides
    (interval_tree.py:40-42: start += padding, end -= padding) because
    SelectCandidates wrote the windows pre-padded by ``no_of_positions``
    (SelectCandidates.py:262-269); a shrunk-empty row becomes a 1-wide
    interval.  Queries are point lookups at the (1-based) VCF position,
    exactly like ``is_region_in(tree, ctg, pos)`` (MergeVcf.py:100,144).
    """

    def __init__(self, rows: Iterable[Tuple[str, int, int]], padding: int = 33):
        import bisect

        by_ctg: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for ctg, start, end in rows:
            start, end = int(start) + padding, int(end) - padding
            if start == end:
                end += 1
            by_ctg[ctg].append((start, end))
        self._starts: Dict[str, List[int]] = {}
        self._merged: Dict[str, List[Tuple[int, int]]] = {}
        for ctg, spans in by_ctg.items():
            spans.sort()
            merged: List[Tuple[int, int]] = []
            for s, e in spans:
                if merged and s <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e))
                else:
                    merged.append((s, e))
            self._merged[ctg] = merged
            self._starts[ctg] = [s for s, _ in merged]
        self._bisect = bisect.bisect_right

    def __contains__(self, key: Tuple[str, int]) -> bool:
        ctg, pos = key
        starts = self._starts.get(ctg)
        if not starts:
            return False
        i = self._bisect(starts, pos) - 1
        # IntervalTree.at(pos) matches half-open [start, end)
        return i >= 0 and pos < self._merged[ctg][i][1]


def read_full_aln_regions(paths: Sequence[str]) -> List[Tuple[str, int, int]]:
    """Concatenate full_aln_regions BED files (the reference concatenates
    every ``{ctg}.*`` shard before building the tree, MergeVcf.py:71-80)."""
    rows: List[Tuple[str, int, int]] = []
    for path in paths:
        opener = open
        if path.endswith(".gz"):
            import gzip

            opener = gzip.open
        with opener(path, "rt") as fh:
            for line in fh:
                if not line.strip() or line.startswith("#"):
                    continue
                cols = line.split()
                rows.append((cols[0], int(cols[1]), int(cols[2])))
    return rows


def merge_pileup_and_full_alignment_illumina(
    pileup_rows: Iterable[str],
    full_alignment_rows: Iterable[str],
    regions: RegionIndex,
    contig: Optional[str] = None,
    qual_cutoff: Optional[float] = None,
    print_ref_calls: bool = False,
    haploid_precise: bool = False,
    haploid_sensitive: bool = False,
) -> List[str]:
    """Illumina region-scoped merge (reference: MergeVcf.py:59-155
    ``MergeVcf_illumina``, activated at :344-346): read realignment shifts
    candidate positions inside the full-alignment windows, so *within* a
    window only FA calls survive (position-level matching would keep stale
    pileup rows for shifted indels); outside the windows pileup rows are
    kept.  Same (ctg, position) -> FA wins (dict last-write, FA pass
    second)."""
    out: Dict[Tuple[str, int], str] = {}

    def add(rows, want_in_region):
        for row in rows:
            if row.startswith("#"):
                continue
            ctg, pos, ref, alt, qual, _ = _row_fields(row)
            if contig is not None and ctg != contig:
                continue
            if ((ctg, pos) in regions) != want_in_region:
                continue
            is_reference = alt == "." or ref == alt
            if haploid_precise:
                row = update_haploid_precise_genotype(row)
            if haploid_sensitive:
                row = update_haploid_sensitive_genotype(row)
            if not row:
                continue
            if not is_reference:
                out[(ctg, pos)] = mark_low_qual(row, qual_cutoff)
            elif print_ref_calls:
                out[(ctg, pos)] = row
    add(pileup_rows, want_in_region=False)
    add(full_alignment_rows, want_in_region=True)
    return [row for _, row in sorted(out.items())]


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
