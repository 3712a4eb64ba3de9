"""gVCF: non-variant block construction and variant/non-variant merging.

Behavioral port of the reference gVCF machinery (preprocess/utils.py):
* ``reference_likelihood`` — binomial non-variant site genotype likelihoods
  P(0/0)=(1-p)^n_ref * p^n_alt, P(het)=2^-n, P(1/1) mirrored; GQ capped at
  50 and binned by ``gq_bin_size`` (utils.py:524-568).
* ``NonVariantBlockWriter`` — adaptive block merging: blocks break on GQ-bin
  change, GT change, contig change, N-reference transitions, and DP drifting
  beyond +-30% of the block minimum (utils.py:398-488).  Emitted rows are
  GATK-style ``<NON_REF>`` records ``GT:GQ:MIN_DP:PL`` with ``END=``.
* ``merge_variant_and_nonvariant`` — interleaves non-variant blocks with
  variant calls, splitting blocks around variant spans (utils.py:189-346).

The reference's phred math uses a truncated LOG_10 = 2.3025 in its CFFI fast
path; we keep that constant for output parity.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

_LOG_10 = 2.3025  # truncated, matching the reference CFFI path
_LOG_2 = 0.3010  # truncated literal, matching preprocess/utils.py:19


def _log10sumexp(values: Sequence[float]) -> float:
    # The reference's production (CFFI) log10sumexp reads one element past
    # the array in its max scan (preprocess/utils.py getMyMaxItem
    # `i<=n_list`), which lands on a zeroed heap double — so with all-
    # negative log probabilities the scaling max is effectively pinned to
    # 0.0.  Confident sites then normalize to exactly 0.0 and cap at GQ 50.
    # We reproduce the effective m=0 behavior for row-identical gVCF output
    # (verified against the reference in tests/test_reference_differential.py).
    s = sum(pow(10.0, v) for v in values)
    if s == 0.0:
        return float("-inf")
    return math.log(s) / _LOG_10


def _normalize_log10(values: Sequence[float]) -> List[float]:
    lse = round(_log10sumexp(values), 6)
    return [min(v - lse, 0.0) for v in values]


def _log10p_to_phred(log10p: float) -> float:
    p_true = pow(10.0, log10p)
    if p_true == 1:
        return 50.0
    return round(-10 * (math.log(1.0 - p_true) / _LOG_10), 6)


def reference_likelihood(
    n_ref: int, n_total: int, p_err: float = 0.001, gq_bin_size: int = 5,
    max_gq: int = 50,
) -> Tuple[bool, int, int, List[int]]:
    """(validPL, gq, binned_gq, phred_PLs) for a non-variant site.

    Memoized on the full argument tuple: a 30x genome has only a few
    thousand distinct (n_ref, n_total) pairs but tens of millions of
    sites — the binomial math dominated the gVCF stage otherwise."""
    key = (n_ref, n_total, p_err, gq_bin_size, max_gq)
    hit = _REFLIK_CACHE.get(key)
    if hit is not None:
        return hit
    out = _reference_likelihood_uncached(n_ref, n_total, p_err, gq_bin_size, max_gq)
    if len(_REFLIK_CACHE) < 2_000_000:
        _REFLIK_CACHE[key] = out
    return out


_REFLIK_CACHE: dict = {}


def _reference_likelihood_uncached(
    n_ref: int, n_total: int, p_err: float, gq_bin_size: int, max_gq: int,
) -> Tuple[bool, int, int, List[int]]:
    if n_total == 0:
        log10_probs = _normalize_log10([-1.0, -1.0, -1.0])
    else:
        logp = math.log(p_err) / _LOG_10
        log1p = math.log1p(-p_err) / _LOG_10
        n_alt = n_total - n_ref
        log10_probs = _normalize_log10([
            n_ref * log1p + n_alt * logp,
            -n_total * _LOG_2,
            n_ref * logp + n_alt * log1p,
        ])
    gq = int(min(int(_log10p_to_phred(log10_probs[0])), max_gq))
    if gq >= 1:
        binned_gq = ((gq - 1) // gq_bin_size) * gq_bin_size + 1
    else:
        binned_gq = 0
    valid_pl = log10_probs[0] == max(log10_probs)
    phred = [-10 * x for x in log10_probs]
    min_phred = min(phred)
    pls = [int(x - min_phred) for x in phred]
    return valid_pl, gq, binned_gq, pls


@dataclass
class _Site:
    chrom: str
    pos: int        # 1-based
    ref: str
    gt: str
    gq: int
    binned_gq: int
    pls: List[int]
    dp: int


class NonVariantBlockWriter:
    """Accumulates per-position non-variant info into merged gVCF rows."""

    def __init__(
        self,
        p_err: float = 0.001,
        gq_bin_size: int = 5,
        bp_resolution: bool = False,
        contig_lengths: Optional[dict] = None,
    ):
        self.p_err = p_err
        self.gq_bin_size = gq_bin_size
        self.bp_resolution = bp_resolution
        self.contig_lengths = contig_lengths or {}
        self.rows: List[str] = []
        self._block: List[_Site] = []
        self._min_dp = self._max_dp = 0
        self._min_raw_gq = 0

    def add_site(self, chrom: str, pos: int, ref: str, n_ref: int, n_total: int) -> None:
        valid_pl, gq, binned_gq, pls = reference_likelihood(
            n_ref, n_total, self.p_err, self.gq_bin_size)
        gt = "0/0" if valid_pl else "./."
        if ref not in "ACGT":
            ref, gq, binned_gq, pls = "N", 1, 1, [0, 0, 0]

        head = self._block[0] if self._block else None
        if head is not None:
            # extension fast path: only the head site, the last pos/ref and
            # the dp/gq aggregates are needed unless per-site rows will be
            # emitted (bp_resolution or ./. blocks) — creating and retaining
            # a _Site per genome position dominated WGS-scale gVCF runs
            # position continuity: a gap (e.g. a dist process feeding only
            # its OWNED chunks, which are strided) must close the block —
            # the reference's per-chunk .tmp.gvcf files can never span a
            # gap either (preprocess/CreateTensorPileupFromCffi.py:399-441)
            if not (pos != self._last_pos + 1
                    or binned_gq != head.binned_gq or gt != head.gt
                    or chrom != head.chrom
                    or (ref != self._last_ref
                        and (ref == "N" or self._last_ref == "N"))):
                dp = n_total
                if dp < self._min_dp:
                    if self._max_dp > math.ceil(dp + dp * 0.3):
                        self.flush()
                        head = None
                    else:
                        self._min_dp = dp
                elif dp > self._max_dp:
                    if dp <= math.ceil(self._min_dp + self._min_dp * 0.3):
                        self._max_dp = dp
                    else:
                        self.flush()
                        head = None
                if head is not None:
                    self._min_raw_gq = min(self._min_raw_gq, gq)
                    self._last_pos = pos
                    self._last_ref = ref
                    if self._retain:
                        self._block.append(
                            _Site(chrom, pos, ref, gt, gq, binned_gq, pls, n_total))
                    return
            else:
                self.flush()
        self._start_block(_Site(chrom, pos, ref, gt, gq, binned_gq, pls, n_total))

    def feed(self, chrom: str, start_pos1: int, ref_seq: str,
             n_ref, n_total) -> None:
        """Bulk per-position counts for [start_pos1, start_pos1 + n) —
        same interface as native.NativeGvcfWriter."""
        nr = list(n_ref)
        nt = list(n_total)
        add = self.add_site
        for k in range(len(ref_seq)):
            add(chrom, start_pos1 + k, ref_seq[k], int(nr[k]), int(nt[k]))

    def _start_block(self, site: _Site) -> None:
        self._block = [site]
        self._min_dp = self._max_dp = site.dp
        self._min_raw_gq = site.gq
        self._last_pos = site.pos
        self._last_ref = site.ref
        self._retain = self.bp_resolution or site.gt == "./."

    def _row(self, site: _Site, end: int, gq_field: int, min_dp: int) -> str:
        end_str = str(end)
        length = self.contig_lengths.get(site.chrom)
        if length is not None and end == length - 1:
            end_str = str(length)
        pls = ",".join(str(x) for x in site.pls)
        return (f"{site.chrom}\t{site.pos}\t.\t{site.ref}\t<NON_REF>\t0\t.\t"
                f"END={end_str}\tGT:GQ:MIN_DP:PL\t{site.gt}:{gq_field}:{min_dp}:{pls}")

    def flush(self) -> None:
        if not self._block:
            return
        head = self._block[0]
        if (self.bp_resolution or head.gt == "./.") and head.ref != "N":
            for site in self._block:
                self.rows.append(self._row(site, site.pos, site.binned_gq, site.dp))
        else:
            end = self._last_pos
            if head.ref == "N":
                row_site = _Site(head.chrom, head.pos, "N", "./.", 1, 1, [0, 0, 0], self._min_dp)
                self.rows.append(self._row(row_site, end, 1, self._min_dp))
            else:
                # quirk preserved: the GQ field carries the block's min raw GQ
                self.rows.append(self._row(head, end, self._min_raw_gq, self._min_dp))
        self._block = []

    def drain(self) -> List[str]:
        """Completed rows so far (streaming spill support); the open block
        stays internal until finish()."""
        out = self.rows
        self.rows = []
        return out

    def finish(self) -> List[str]:
        self.flush()
        return self.rows


_END_RE = re.compile(r"END=(\d+)")


def _augment_variant_row(row: str) -> Optional[Tuple[str, int, int]]:
    """Variant row -> gVCF form: ALT += ',<NON_REF>', AD/AF padded, PL += 990s
    (utils.py:118-140).  Returns (row, start, end) or None for ref calls."""
    cols = row.rstrip("\n").split("\t")
    ref, alt = cols[3], cols[4]
    if alt == "." or ref == alt:
        return None
    start = int(cols[1])
    end = start - 1 + len(ref)
    n_alt = len(alt.split(","))
    info = cols[-1].split(":")
    info[-3] += ",0"
    info[-2] += ",0.0000"
    cols[-1] = ":".join(info)
    cols[4] = alt + ",<NON_REF>"
    cols[-1] += ",990,990,990" if n_alt == 1 else ",990,990,990,990"
    return "\t".join(cols), start, end


def merge_variant_and_nonvariant_stream(
    variant_rows: Iterable[str],
    nonvariant_rows: Iterable[str],
    ref_base_at: Callable[[str, int], str],
) -> Iterator[str]:
    """Interleave variant calls with non-variant blocks per contig,
    splitting blocks around variant spans (gvcfGenerator.mergeCalls
    semantics).  Single streaming pass over ``nonvariant_rows`` (which must
    be contig-grouped and start-sorted, as the pipeline produces them), so
    WGS-scale block streams never need to be memory-resident."""
    variants_by_ctg: dict = {}
    ctg_seen: List[str] = []  # variant contigs in insertion order
    for row in variant_rows:
        if row.startswith("#"):
            continue
        aug = _augment_variant_row(row)
        if aug:
            chrom = row.split("\t", 1)[0]
            if chrom not in variants_by_ctg:
                variants_by_ctg[chrom] = []
                ctg_seen.append(chrom)
            variants_by_ctg[chrom].append(aug)

    def split_block(row: str, start: int, end: int, chrom: str,
                    bstart: int, bend: int) -> str:
        if start == bstart and end == bend:  # untouched block (majority)
            return row
        cols = row.split("\t")
        if start != bstart:
            cols[1] = str(start)
            cols[3] = ref_base_at(chrom, start)
        if len(cols) > 7 and cols[7].startswith("END="):
            cols[7] = f"END={end}"
            return "\t".join(cols)
        return re.sub(r"END=\d+", f"END={end}", "\t".join(cols))

    cur_ctg: Optional[str] = None
    variants: List[Tuple[str, int, int]] = []
    vi = 0
    last_var_end = 0
    for row in nonvariant_rows:
        if row.startswith("#"):
            continue
        row = row.rstrip("\n")
        cols = row.split("\t")
        chrom = cols[0]
        bstart = int(cols[1])
        if len(cols) > 7 and cols[7].startswith("END="):  # canonical layout
            bend = int(cols[7][4:])
        else:
            m = _END_RE.search(row)
            bend = int(m.group(1)) if m else bstart
        if chrom != cur_ctg:
            while vi < len(variants):  # flush the previous contig's tail
                yield variants[vi][0]
                vi += 1
            cur_ctg = chrom
            variants = variants_by_ctg.pop(chrom, [])
            vi = 0
            last_var_end = 0
        cur_start = bstart
        # a previously-emitted variant span (e.g. a multi-base deletion) may
        # swallow following blocks entirely or clip their left edge — the
        # reference skips/trims those blocks (utils.py:303-326 "skip the
        # non-var block that is within the variant")
        if last_var_end >= cur_start:
            if last_var_end >= bend:
                continue
            cur_start = last_var_end + 1
        while vi < len(variants) and variants[vi][2] < cur_start:
            yield variants[vi][0]
            vi += 1
        while vi < len(variants) and variants[vi][1] <= bend:
            vrow, vstart, vend = variants[vi]
            if vstart > cur_start:
                yield split_block(row, cur_start, vstart - 1, chrom, bstart, bend)
            yield vrow
            cur_start = max(cur_start, vend + 1)
            last_var_end = max(last_var_end, vend)
            vi += 1
        if cur_start <= bend:
            yield split_block(row, cur_start, bend, chrom, bstart, bend)
    while vi < len(variants):
        yield variants[vi][0]
        vi += 1
    # contigs with variant calls but no non-variant blocks
    for chrom in ctg_seen:
        for vrow, _, _ in variants_by_ctg.get(chrom, ()):
            yield vrow


def merge_variant_and_nonvariant(
    variant_rows: Iterable[str],
    nonvariant_rows: Iterable[str],
    ref_base_at: Callable[[str, int], str],
) -> List[str]:
    """List form of :func:`merge_variant_and_nonvariant_stream`."""
    return list(merge_variant_and_nonvariant_stream(
        variant_rows, nonvariant_rows, ref_base_at))
