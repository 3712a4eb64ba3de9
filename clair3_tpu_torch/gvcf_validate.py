"""Structural gVCF validator — an in-tree GATK-ValidateVariants(-gvcf)
equivalent.

The reference's gVCF output is consumed by GATK in the wild (it emits
GATK-style ``<NON_REF>`` block rows, reference preprocess/utils.py:608-622),
but neither the reference nor GATK ships in this image, so this module
checks the same structural contract GATK enforces:

* **Ordering** — rows sorted by position per contig, one contiguous run of
  rows per contig (no interleaving).
* **Span sanity** — ``END`` >= POS; spans never overlap the next record.
* **Block continuity** — every base between consecutive records on a contig
  is covered (GATK's "GVCF has no gaps" rule).  When calling was
  region-restricted, gaps are permitted only across the supplied region
  boundaries.
* **PL/GQ/MIN_DP consistency** — ``<NON_REF>`` blocks carry
  ``GT:GQ:MIN_DP:PL`` with 3 non-negative PLs normalized to min 0,
  ``GT=0/0`` ⇒ ``PL[0]==0``, integer ``GQ``/``MIN_DP`` >= 0.
* **Variant-row allele bookkeeping** — ALT ends in ``<NON_REF>``; AD has one
  value per allele (Number=R), PL has A(A+1)/2 values (Number=G), GT allele
  indices are in range.
* **Header contract** — every FORMAT/INFO key and contig used by a row is
  declared; ``##ALT=<ID=NON_REF...`` present; spans stay within declared
  contig lengths.

Used by ``tests/test_gvcf_validate.py`` (fuzzed block streams +
mutation-detection tests) and run automatically by
``scripts/wgs_scale_demo.py`` on its full-genome gVCF output.
"""

from __future__ import annotations

import gzip
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

_END_RE = re.compile(r"(?:^|;)END=(\d+)(?:;|$)")
_HDR_ID_RE = re.compile(r"ID=([^,>]+)")


def _open_rows(source) -> Iterator[str]:
    if isinstance(source, str):
        opener = gzip.open if source.endswith(".gz") else open
        with opener(source, "rt") as fh:
            yield from fh
    else:
        yield from source


def _load_regions(regions) -> Optional[Dict[str, List[Tuple[int, int]]]]:
    """regions: None | BED path | iterable of (chrom, start0, end) tuples.
    Returned intervals are 1-based inclusive, sorted and merged."""
    if regions is None:
        return None
    out: Dict[str, List[Tuple[int, int]]] = {}
    if isinstance(regions, str):
        rows = []
        with open(regions) as fh:
            for line in fh:
                c = line.split()
                if len(c) >= 3:
                    rows.append((c[0], int(c[1]), int(c[2])))
    else:
        rows = list(regions)
    for chrom, start0, end in rows:
        out.setdefault(chrom, []).append((start0 + 1, end))
    for chrom in out:
        merged: List[Tuple[int, int]] = []
        for s, e in sorted(out[chrom]):
            if merged and s <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        out[chrom] = merged
    return out


def _gap_outside_regions(chrom: str, gap_start: int, gap_end: int,
                         regions: Dict[str, List[Tuple[int, int]]]) -> bool:
    """True when [gap_start, gap_end] (1-based inclusive) touches no
    covered region base — i.e. the gap is explained by region restriction."""
    for s, e in regions.get(chrom, ()):
        if s <= gap_end and gap_start <= e:
            return False
    return True


class GvcfValidator:
    """Streaming validator; collect() returns violation strings."""

    MAX_VIOLATIONS = 200

    def __init__(self, regions=None):
        self.regions = _load_regions(regions)
        self.violations: List[str] = []
        self._fmt_declared: set = set()
        self._info_declared: set = set()
        self._filter_declared = {"PASS", "."}
        self._contig_lengths: Dict[str, int] = {}
        self._has_nonref_alt_decl = False
        self._saw_header = False
        self._done_contigs: set = set()
        self._cur_contig: Optional[str] = None
        self._prev_pos = 0
        self._prev_span_end = 0
        self._n_rows = 0
        self._n_blocks = 0

    # -- helpers ----------------------------------------------------------
    def _flag(self, msg: str) -> None:
        if len(self.violations) < self.MAX_VIOLATIONS:
            self.violations.append(msg)
        elif len(self.violations) == self.MAX_VIOLATIONS:
            self.violations.append("... (further violations suppressed)")

    def _header_line(self, line: str) -> None:
        self._saw_header = True
        if line.startswith("##FORMAT=<"):
            m = _HDR_ID_RE.search(line)
            if m:
                self._fmt_declared.add(m.group(1))
        elif line.startswith("##INFO=<"):
            m = _HDR_ID_RE.search(line)
            if m:
                self._info_declared.add(m.group(1))
        elif line.startswith("##FILTER=<"):
            m = _HDR_ID_RE.search(line)
            if m:
                self._filter_declared.add(m.group(1))
        elif line.startswith("##ALT=<") and "ID=NON_REF" in line:
            self._has_nonref_alt_decl = True
        elif line.startswith("##contig=<"):
            m = _HDR_ID_RE.search(line)
            lm = re.search(r"length=(\d+)", line)
            if m:
                self._contig_lengths[m.group(1)] = int(lm.group(1)) if lm else 0

    # -- row checks -------------------------------------------------------
    def _check_block_row(self, where: str, cols: List[str]) -> None:
        self._n_blocks += 1
        fmt = cols[8].split(":")
        if fmt != ["GT", "GQ", "MIN_DP", "PL"]:
            self._flag(f"{where}: <NON_REF> block FORMAT is {cols[8]!r}, "
                       f"expected GT:GQ:MIN_DP:PL")
            return
        vals = cols[9].split(":")
        if len(vals) != 4:
            self._flag(f"{where}: block sample field has {len(vals)} values")
            return
        gt, gq_s, min_dp_s, pl_s = vals
        if gt not in ("0/0", "./."):
            self._flag(f"{where}: block GT {gt!r} not 0/0 or ./.")
        try:
            gq = int(gq_s)
            if gq < 0:
                self._flag(f"{where}: negative GQ {gq}")
        except ValueError:
            self._flag(f"{where}: non-integer GQ {gq_s!r}")
        try:
            if int(min_dp_s) < 0:
                self._flag(f"{where}: negative MIN_DP {min_dp_s}")
        except ValueError:
            self._flag(f"{where}: non-integer MIN_DP {min_dp_s!r}")
        try:
            pls = [int(x) for x in pl_s.split(",")]
        except ValueError:
            self._flag(f"{where}: non-integer PL {pl_s!r}")
            return
        if len(pls) != 3:
            self._flag(f"{where}: block PL has {len(pls)} values, expected 3 "
                       f"(diploid, 2 alleles)")
            return
        if min(pls) < 0:
            self._flag(f"{where}: negative PL in {pls}")
        elif min(pls) != 0:
            self._flag(f"{where}: PL not normalized to min 0: {pls}")
        if gt == "0/0" and pls[0] != 0:
            self._flag(f"{where}: GT=0/0 but PL[0]={pls[0]} (0/0 not the "
                       f"maximum-likelihood genotype)")

    def _check_variant_row(self, where: str, cols: List[str]) -> None:
        ref, alt = cols[3], cols[4]
        alts = alt.split(",")
        if alts[-1] != "<NON_REF>":
            self._flag(f"{where}: variant row ALT {alt!r} does not end in "
                       f"<NON_REF>")
            return
        n_alleles = 1 + len(alts)           # REF + alts (incl. NON_REF)
        n_gts = n_alleles * (n_alleles + 1) // 2
        fmt = cols[8].split(":")
        vals = cols[9].split(":")
        if len(fmt) != len(vals):
            self._flag(f"{where}: FORMAT has {len(fmt)} keys but sample has "
                       f"{len(vals)} values")
            return
        d = dict(zip(fmt, vals))
        if "GT" in d:
            for a in re.split(r"[/|]", d["GT"]):
                if a != "." and int(a) >= n_alleles:
                    self._flag(f"{where}: GT allele index {a} out of range "
                               f"for {n_alleles} alleles")
        if "AD" in d:
            n_ad = len(d["AD"].split(","))
            if n_ad != n_alleles:
                self._flag(f"{where}: AD has {n_ad} values, expected "
                           f"{n_alleles} (Number=R)")
        if "PL" in d:
            n_pl = len(d["PL"].split(","))
            if n_pl != n_gts:
                self._flag(f"{where}: PL has {n_pl} values, expected {n_gts} "
                           f"(Number=G for {n_alleles} alleles)")
        if not ref or any(b not in "ACGTN" for b in ref):
            self._flag(f"{where}: invalid REF {ref!r}")

    # -- main loop --------------------------------------------------------
    def feed(self, line: str) -> None:
        line = line.rstrip("\n")
        if not line:
            return
        if line.startswith("#"):
            if self._n_rows:
                self._flag(f"header line after data rows: {line[:60]!r}")
            self._header_line(line)
            return
        self._n_rows += 1
        cols = line.split("\t")
        where = f"{cols[0]}:{cols[1]}"
        if len(cols) < 10:
            self._flag(f"{where}: {len(cols)} columns, expected >= 10")
            return
        chrom = cols[0]
        try:
            pos = int(cols[1])
        except ValueError:
            self._flag(f"{where}: non-integer POS")
            return
        if pos < 1:
            self._flag(f"{where}: POS < 1")

        # header usage
        if self._saw_header:
            if self._contig_lengths and chrom not in self._contig_lengths:
                self._flag(f"{where}: contig {chrom!r} not declared in header")
            for key in cols[8].split(":"):
                if key not in self._fmt_declared:
                    self._flag(f"{where}: FORMAT key {key!r} not declared")
            if cols[6] not in self._filter_declared:
                self._flag(f"{where}: FILTER {cols[6]!r} not declared")
            for item in cols[7].split(";"):
                if item in (".", ""):
                    continue
                key = item.split("=", 1)[0]
                if key not in self._info_declared:
                    self._flag(f"{where}: INFO key {key!r} not declared")

        # span
        m = _END_RE.search(cols[7])
        if m:
            span_end = int(m.group(1))
            if span_end < pos:
                self._flag(f"{where}: END={span_end} < POS")
        else:
            span_end = pos + len(cols[3]) - 1
        clen = self._contig_lengths.get(chrom)
        if clen:
            if span_end > clen:
                self._flag(f"{where}: span end {span_end} exceeds contig "
                           f"length {clen}")

        # ordering / contiguity / overlap
        if chrom != self._cur_contig:
            if chrom in self._done_contigs:
                self._flag(f"{where}: contig {chrom!r} rows are interleaved "
                           f"(contig seen earlier, then again after others)")
            if self._cur_contig is not None:
                self._done_contigs.add(self._cur_contig)
            self._cur_contig = chrom
            self._prev_pos = 0
            self._prev_span_end = 0
        if pos < self._prev_pos:
            self._flag(f"{where}: unsorted (previous POS {self._prev_pos})")
        if pos <= self._prev_span_end:
            # Known reference quirk (preprocess/utils.py:614-616): a block
            # ending at contig_length-1 has its END bumped to contig_length,
            # which can overlap a final one-base record at POS==length by
            # exactly one base.  Row-identical output inherits it; tolerate
            # only that exact contig-tail pattern.
            if not (clen and pos == clen and self._prev_span_end == clen):
                self._flag(f"{where}: overlaps previous record span ending "
                           f"at {self._prev_span_end}")
        elif self._prev_span_end and pos > self._prev_span_end + 1:
            gap = (self._prev_span_end + 1, pos - 1)
            if self.regions is None or not _gap_outside_regions(
                    chrom, gap[0], gap[1], self.regions):
                self._flag(f"{where}: coverage gap {chrom}:{gap[0]}-{gap[1]} "
                           f"(previous record ended at {self._prev_span_end})")
        self._prev_pos = pos
        self._prev_span_end = max(self._prev_span_end, span_end)

        # row-type checks
        if cols[4] == "<NON_REF>":
            if self._saw_header and not self._has_nonref_alt_decl:
                self._flag(f"{where}: <NON_REF> used but ##ALT=<ID=NON_REF> "
                           f"missing from header")
                self._has_nonref_alt_decl = True  # flag once
            self._check_block_row(where, cols)
        else:
            self._check_variant_row(where, cols)

    def collect(self) -> List[str]:
        if self._n_rows == 0:
            # an empty gVCF with a header is valid (reference emits
            # header-only outputs for empty contig sets)
            if not self._saw_header:
                self._flag("no header and no rows")
        return self.violations

    @property
    def stats(self) -> Dict[str, int]:
        return {"rows": self._n_rows, "blocks": self._n_blocks,
                "violations": len(self.violations)}


def validate_gvcf(source, regions=None) -> List[str]:
    """Validate a gVCF (path, .gz path, or iterable of lines).

    ``regions``: optional BED path or (chrom, start0, end) tuples that the
    calling run was restricted to; coverage gaps are then only permitted
    outside those regions.  Returns a list of violation strings (empty =
    structurally valid).
    """
    v = GvcfValidator(regions=regions)
    for line in _open_rows(source):
        v.feed(line)
    return v.collect()


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        "validate_gvcf", description="Structural gVCF validator "
        "(GATK-ValidateVariants-equivalent checks)")
    ap.add_argument("--gvcf_fn", required=True)
    ap.add_argument("--bed_fn", default=None,
                    help="regions the run was restricted to (gaps allowed "
                    "only across region boundaries)")
    args = ap.parse_args(argv)
    v = GvcfValidator(regions=args.bed_fn)
    for line in _open_rows(args.gvcf_fn):
        v.feed(line)
    problems = v.collect()
    for p in problems:
        print(f"[validate_gvcf] {p}")
    s = v.stats
    print(f"[validate_gvcf] {s['rows']} rows ({s['blocks']} <NON_REF> "
          f"blocks): {'FAIL, ' + str(len(problems)) + ' violations' if problems else 'OK'}")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
