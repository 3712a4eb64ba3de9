"""BED interval handling (replaces the reference's vendored intervaltree;
sorted intervals + bisect are ample for whole-chromosome region filters)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple


class BedIntervals:
    """Per-contig merged half-open intervals with O(log n) point queries."""

    def __init__(self):
        self._raw: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self._starts: Dict[str, List[int]] = {}
        self._ends: Dict[str, List[int]] = {}

    def add(self, ctg: str, start: int, end: int) -> None:
        if end > start:
            self._raw[ctg].append((start, end))
            self._starts.pop(ctg, None)

    def _index(self, ctg: str) -> None:
        ivals = sorted(self._raw.get(ctg, []))
        merged: List[Tuple[int, int]] = []
        for s, e in ivals:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self._starts[ctg] = [s for s, _ in merged]
        self._ends[ctg] = [e for _, e in merged]

    def contains(self, ctg: str, pos: int) -> bool:
        """Is 0-based position inside any interval?"""
        if ctg not in self._raw:
            return False
        if ctg not in self._starts:
            self._index(ctg)
        starts, ends = self._starts[ctg], self._ends[ctg]
        i = bisect.bisect_right(starts, pos) - 1
        return i >= 0 and pos < ends[i]

    def overlaps(self, ctg: str, start: int, end: int) -> bool:
        if ctg not in self._raw:
            return False
        if ctg not in self._starts:
            self._index(ctg)
        starts, ends = self._starts[ctg], self._ends[ctg]
        i = bisect.bisect_right(starts, end - 1) - 1
        return i >= 0 and start < ends[i]

    def contigs(self) -> List[str]:
        return list(self._raw)

    def span(self, ctg: str) -> Optional[Tuple[int, int]]:
        if ctg not in self._raw:
            return None
        if ctg not in self._starts:
            self._index(ctg)
        if not self._starts[ctg]:
            return None
        return self._starts[ctg][0], self._ends[ctg][-1]


def read_bed(path: str, ctg_name: Optional[str] = None,
             padding: int = 0) -> BedIntervals:
    """Load a BED (optionally gzipped) into intervals, +-padding bp."""
    from clair3_tpu_torch.io.bgzf import decompress, is_gzipped

    tree = BedIntervals()
    text = decompress(path).decode() if is_gzipped(path) else open(path).read()
    for line in text.splitlines():
        if not line or line.startswith(("#", "track", "browser")):
            continue
        cols = line.split("\t")
        if len(cols) < 3:
            cols = line.split()
        if len(cols) < 3:
            continue
        ctg = cols[0]
        if ctg_name and ctg != ctg_name:
            continue
        tree.add(ctg, int(cols[1]) - padding, int(cols[2]) + padding)
    return tree


def split_extend_bed_regions(
    path: str,
    ctg_name: Optional[str] = None,
    region_start: Optional[int] = None,
    region_end: Optional[int] = None,
    expand: int = 33,
) -> List[Tuple[str, int, int]]:
    """Per-contig BED regions expanded by ``expand`` bp and merged when they
    touch — the reference SplitExtendBed submodule's output contract
    (preprocess/SplitExtendBed.py:7-57): each input interval becomes
    [start-expand, end+expand) and consecutive intervals whose expanded
    spans overlap merge into one region.

    Matches the reference quirk that the final open region is only flushed
    by a following non-overlapping interval (the trailing region is NOT
    emitted), so outputs are row-identical to the submodule's file."""
    from clair3_tpu_torch.io.bgzf import decompress, is_gzipped

    text = decompress(path).decode() if is_gzipped(path) else open(path).read()
    out: List[Tuple[str, int, int]] = []
    pre_start = pre_end = -1
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        cols = line.split()
        if len(cols) < 3:
            continue
        ctg = cols[0]
        if ctg_name is not None and ctg != ctg_name:
            continue
        start, end = int(cols[1]), int(cols[2])
        if region_start and end < region_start:
            continue
        if region_end and start > region_end:
            break
        if pre_start == -1:
            pre_start = start - expand
            pre_end = end + expand
            continue
        if pre_end >= start - expand:
            pre_end = end + expand
        else:
            out.append((ctg_name or ctg, pre_start, pre_end))
            pre_start = start - expand
            pre_end = end + expand
    return out
