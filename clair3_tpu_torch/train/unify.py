"""Representation unification for training truth
(reference: preprocess/UnifyRepresentation.py, docs/representation_unification.md).

Truth sets and a sample's own candidate calls often express the same edit
differently (indels shifted inside repeats, composite edits split
differently).  Training labels must live in the *candidate* representation
space, so for each truth cluster we search bounded genotype assignments of
the nearby candidate alleles whose implied local haplotype pair equals the
truth's haplotype pair, and re-emit the truth in candidate coordinates.
"""

from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from clair3_tpu_torch.train.data import TruthVariant

MAX_CLUSTER_CANDIDATES = 10
MAX_CALCULATE_COUNT = 10_000   # combination budget (UnifyRepresentation.py:1409)
# Max het sites whose phasings are enumerated per partition.  Oversized
# clusters are SPLIT at their largest gaps and each part searched fully —
# the reference's partition-and-search (split_variants_truths caps sites
# per partition at partition_size=15 and the option-product at
# max_calculate_count, UnifyRepresentation.py:660-735) — instead of
# truncating the enumeration as pre-r03 code did.
MAX_PARTITION_HETS = 14
WINDOW_PAD = 16
_GT_OPTIONS = ((0, 1), (1, 0), (1, 1))


@dataclass(frozen=True)
class CandidateAllele:
    """One candidate site's allele in sample coordinates (1-based pos)."""

    pos: int
    ref: str
    alt: str


def apply_variants_to_haplotype(
    ref_window: str,
    window_start: int,  # 1-based position of ref_window[0]
    variants: Sequence[Tuple[int, str, str]],  # (pos1, ref, alt), sorted
) -> Optional[str]:
    """Apply non-overlapping variants to a reference window; None on
    overlap/out-of-window conflicts."""
    out: List[str] = []
    cursor = window_start
    for pos, ref, alt in sorted(variants):
        if pos < cursor:
            return None  # overlapping edits
        if pos + len(ref) - 1 > window_start + len(ref_window) - 1:
            return None
        out.append(ref_window[cursor - window_start: pos - window_start])
        if ref_window[pos - window_start: pos - window_start + len(ref)] != ref:
            return None
        out.append(alt)
        cursor = pos + len(ref)
    out.append(ref_window[cursor - window_start:])
    return "".join(out)


def _haplotype_pair(
    ref_window: str, window_start: int,
    variants: Sequence[Tuple[int, str, str, Tuple[int, int]]],
) -> Optional[Tuple[str, str]]:
    """(hap1, hap2) as an unordered (sorted) pair, or None on conflict."""
    hap_edits: Tuple[List, List] = ([], [])
    for pos, ref, alt, gt in variants:
        for h in (0, 1):
            if gt[h] == 1:
                hap_edits[h].append((pos, ref, alt))
    h1 = apply_variants_to_haplotype(ref_window, window_start, hap_edits[0])
    h2 = apply_variants_to_haplotype(ref_window, window_start, hap_edits[1])
    if h1 is None or h2 is None:
        return None
    return tuple(sorted((h1, h2)))


def read_window_sequence(
    read, window_start: int, window_end: int, ref_window: str,
) -> Optional[str]:
    """The read's implied haplotype over [window_start, window_end] (1-based
    inclusive): read bases where the read covers the window, reference bases
    elsewhere (reference: UnifyRepresentation.py find_read_support 'extended
    the reference sequence with the alternative base').  None when the read
    doesn't overlap the window at all."""
    w0 = window_start - 1  # 0-based window start
    w1 = window_end        # 0-based exclusive end
    if read.pos >= w1:
        return None
    out: List[str] = []
    cursor = w0  # next reference position to fill
    ref_i = read.pos
    read_i = 0
    for op, ln in read.cigar:
        if op in (0, 7, 8):  # M =X
            lo, hi = max(ref_i, w0), min(ref_i + ln, w1)
            if lo < hi:
                if lo > cursor:
                    out.append(ref_window[cursor - w0: lo - w0])
                out.append(read.seq[read_i + (lo - ref_i): read_i + (hi - ref_i)])
                cursor = hi
            ref_i += ln
            read_i += ln
        elif op == 1:  # I anchored at ref_i - 1
            if w0 < ref_i <= w1 and ref_i - 1 >= read.pos and cursor >= ref_i:
                out.append(read.seq[read_i: read_i + ln])
            read_i += ln
        elif op == 2 or op == 3:  # D / N consume reference without output
            lo, hi = max(ref_i, w0), min(ref_i + ln, w1)
            if lo < hi:
                if lo > cursor:
                    out.append(ref_window[cursor - w0: lo - w0])
                cursor = hi
            ref_i += ln
        elif op == 4:  # S
            read_i += ln
    if cursor == w0:
        return None  # no overlap
    if cursor < w1:
        out.append(ref_window[cursor - w0: w1 - w0])
    return "".join(out).upper()


def _read_support_counter(
    reads, window_start: int, window_end: int, ref_window: str,
) -> Counter:
    c: Counter = Counter()
    for r in reads:
        seq = read_window_sequence(r, window_start, window_end, ref_window)
        if seq:
            c[seq] += 1
    return c


def _cluster(items: Sequence, pos_of, gap: int) -> List[List]:
    clusters: List[List] = []
    for item in sorted(items, key=pos_of):
        if clusters and pos_of(item) - pos_of(clusters[-1][-1]) <= gap:
            clusters[-1].append(item)
        else:
            clusters.append([item])
    return clusters


def _is_het(t: TruthVariant) -> bool:
    return t.genotype1 != t.genotype2


def _split_dense_cluster(cluster: List, max_hets: int) -> List[List]:
    """Recursively split a truth cluster at its largest internal gap until
    each part has <= max_hets het sites (reference partition-and-search:
    bounded option-product per partition instead of truncated search)."""
    if sum(1 for t in cluster if _is_het(t)) <= max_hets or len(cluster) < 2:
        return [cluster]
    gaps = [cluster[i + 1].pos - cluster[i].pos for i in range(len(cluster) - 1)]
    cut = max(range(len(gaps)), key=gaps.__getitem__) + 1
    return (_split_dense_cluster(cluster[:cut], max_hets)
            + _split_dense_cluster(cluster[cut:], max_hets))


def unify_representation(
    truths: Sequence[TruthVariant],
    candidates: Sequence[CandidateAllele],
    ref_seq: str,
    ref_offset: int,  # 0-based offset of ref_seq[0]
    *,
    window_pad: int = WINDOW_PAD,
    max_candidates: int = MAX_CLUSTER_CANDIDATES,
    max_calculate_count: int = MAX_CALCULATE_COUNT,
    reads: Optional[Sequence] = None,
) -> List[TruthVariant]:
    """Re-express truth variants using candidate alleles where the local
    haplotypes match; truths with no matching candidate combination pass
    through unchanged.

    When ``reads`` (BamRead-likes over the region) are given, competing
    matches are ranked by read-level haplotype support and relabeling onto
    alleles with zero read support is refused — the reference's guard
    against relabeling onto low-AF systematic errors
    (UnifyRepresentation.py:115-145, 855-875)."""
    out: List[TruthVariant] = []
    cand_sorted = sorted(candidates, key=lambda c: c.pos)

    clusters = [part
                for cl in _cluster(truths, lambda t: t.pos, 2 * window_pad)
                for part in _split_dense_cluster(cl, MAX_PARTITION_HETS)]
    for cluster in clusters:
        ctg = cluster[0].ctg
        lo = cluster[0].pos - window_pad
        hi = cluster[-1].pos + max(len(t.ref) for t in cluster) + window_pad
        window_start = max(1, lo)
        ref_window = ref_seq[window_start - 1 - ref_offset: hi - ref_offset]
        if not ref_window:
            out.extend(cluster)
            continue

        truth_edits = []
        ok = True
        for t in cluster:
            alts = t.alt.split(",")
            gts = sorted((t.genotype1, t.genotype2))
            if gts[1] > len(alts) or t.ctg != ctg:
                ok = False
                break
            # expand to per-haplotype single-alt edits
            if len(alts) == 1:
                gt = (min(t.genotype1, 1), min(t.genotype2, 1))
                if gt == (0, 0):
                    continue
                truth_edits.append((t.pos, t.ref, alts[0], tuple(sorted(gt))))
            else:
                # multiallelic: place each carried alt on its haplotype(s)
                # (handles 1/2 as well as 0/2, 2/2, 1/1 with spurious alts)
                g1, g2 = t.genotype1, t.genotype2
                if g1 == g2 and g1 > 0:  # e.g. 2/2
                    truth_edits.append((t.pos, t.ref, alts[g1 - 1], (1, 1)))
                else:
                    if g1 > 0:
                        truth_edits.append((t.pos, t.ref, alts[g1 - 1], (1, 0)))
                    if g2 > 0:
                        truth_edits.append((t.pos, t.ref, alts[g2 - 1], (0, 1)))
        if not ok:
            out.extend(cluster)
            continue

        # enumerate ALL phasings of the het truth edits (the partition
        # split above bounds this at 2^(MAX_PARTITION_HETS-1); the first
        # het is pinned because the haplotype pair is unordered, so the
        # global flip is a symmetry — unique_genotypes_selection's dedup,
        # UnifyRepresentation.py:92-114)
        het_idx = [i for i, e in enumerate(truth_edits) if e[3] != (1, 1)]
        # one free phase bit per het SITE, not per edit: a multiallelic
        # (e.g. 1/2) site expands to two edits whose base orientation is
        # already complementary — flipping them together keeps the
        # genotype valid, and keeps the product bounded by the
        # MAX_PARTITION_HETS site split (2^13), which a per-edit
        # enumeration would square
        site_of: Dict[int, int] = {}
        for i in het_idx:
            site_of.setdefault(truth_edits[i][0], len(site_of))
        target_pairs = set()
        n_free = max(len(site_of) - 1, 0)
        for tail in itertools.product((0, 1), repeat=n_free):
            phases = (0,) + tail
            edits = []
            for i, e in enumerate(truth_edits):
                pos, ref, alt, gt = e
                if gt == (1, 1):
                    edits.append((pos, ref, alt, (1, 1)))
                else:
                    base = 0 if gt == (0, 1) else 1  # preserve orientation
                    flip = base ^ phases[site_of[pos]]
                    edits.append((pos, ref, alt, (1, 0) if flip else (0, 1)))
            pair = _haplotype_pair(ref_window, window_start, edits)
            if pair is not None:
                target_pairs.add(pair)
        if not target_pairs:
            out.extend(cluster)
            continue

        near = [c for c in cand_sorted if lo <= c.pos <= hi]
        if len(near) > max_candidates:
            # keep the alleles nearest to any truth position (the reference
            # partitions oversized clusters; proximity pruning bounds the
            # same combinatorial blow-up)
            t_pos = [t.pos for t in cluster]
            near = sorted(near, key=lambda c: min(abs(c.pos - p) for p in t_pos))
            near = sorted(near[:max_candidates], key=lambda c: c.pos)
        if not near:
            out.extend(cluster)
            continue

        support: Optional[Counter] = None
        if reads is not None:
            support = _read_support_counter(
                reads, window_start, window_start + len(ref_window) - 1,
                ref_window)

        # DFS over per-site genotype options ((0,0) = skip the site) with
        # HAPLOTYPE-PREFIX PRUNING against the target pair(s): a partial
        # assignment whose built haplotypes are not prefixes of any target
        # cannot complete, so dense clusters stay tractable where blind
        # subset enumeration (and the reference's genotypes_combination
        # product, which collapses to all-(0,0) past its budget) explode.
        matches: List[Tuple[int, int, int, List[TruthVariant]]] = []
        tried = 0
        order = 0
        targets = sorted(target_pairs)

        def _prefix_ok(h1: str, h2: str) -> bool:
            for t1, t2 in targets:
                if (t1.startswith(h1) and t2.startswith(h2)) or \
                        (t1.startswith(h2) and t2.startswith(h1)):
                    return True
            return False

        def _apply(state, c: CandidateAllele):
            s, cursor = state
            if c.pos < cursor:
                return None  # overlaps the previous edit on this haplotype
            off = c.pos - window_start
            if off + len(c.ref) > len(ref_window):
                return None
            if ref_window[off: off + len(c.ref)] != c.ref:
                return None
            return (s + ref_window[cursor - window_start: off] + c.alt,
                    c.pos + len(c.ref))

        def _dfs(i, hap1, hap2, chosen):
            nonlocal tried, order
            if tried > max_calculate_count:
                return
            if i == len(near):
                tried += 1
                if not chosen:
                    return
                f1 = hap1[0] + ref_window[hap1[1] - window_start:]
                f2 = hap2[0] + ref_window[hap2[1] - window_start:]
                pair = tuple(sorted((f1, f2)))
                if pair not in target_pairs:
                    return
                sup = (support[pair[0]] + support[pair[1]]) if support is not None else 0
                subset = [c for c, _ in chosen]
                gts = [g for _, g in chosen]
                rows = _emit_matched(ctg, subset, gts)
                if rows is not None:
                    matches.append((-sup, len(chosen), order, rows))
                    order += 1
                return
            c = near[i]
            for gt in ((0, 0),) + _GT_OPTIONS:
                tried += 1
                if tried > max_calculate_count:
                    return
                if gt == (0, 0):
                    _dfs(i + 1, hap1, hap2, chosen)
                    continue
                n1, n2 = hap1, hap2
                if gt[0]:
                    n1 = _apply(hap1, c)
                if gt[1]:
                    n2 = _apply(hap2, c)
                if n1 is None or n2 is None:
                    continue
                if not _prefix_ok(n1[0], n2[0]):
                    continue
                _dfs(i + 1, n1, n2, chosen + [(c, gt)])

        _dfs(0, ("", window_start), ("", window_start), [])
        if not matches:
            out.extend(cluster)
            continue
        matches.sort(key=lambda m: m[:3])
        best_neg_sup, _, _, best_rows = matches[0]
        if support is not None and best_neg_sup == 0:
            # no read carries either matched haplotype: refuse to relabel
            out.extend(cluster)
            continue
        out.extend(best_rows)
    out.sort(key=lambda t: (t.ctg, t.pos))
    return out


def _emit_matched(ctg, subset, gts) -> Optional[List[TruthVariant]]:
    """Matched candidate alleles -> truth rows, merging two alleles at the
    same position into one multiallelic 1/2 row."""
    by_pos: Dict[Tuple[int, str], List[Tuple[CandidateAllele, Tuple[int, int]]]] = {}
    for c, gt in zip(subset, gts):
        by_pos.setdefault((c.pos, c.ref), []).append((c, gt))
    rows: List[TruthVariant] = []
    for (pos, ref), items in sorted(by_pos.items()):
        if len(items) == 1:
            c, gt = items[0]
            rows.append(TruthVariant(ctg, c.pos, c.ref, c.alt,
                                     *sorted((min(gt[0], 1), min(gt[1], 1)))))
        elif len(items) == 2:
            (c1, g1), (c2, g2) = items
            # the two alts must live on opposite haplotypes
            if g1 == (1, 1) or g2 == (1, 1) or g1 == g2:
                return None
            rows.append(TruthVariant(ctg, pos, ref, f"{c1.alt},{c2.alt}", 1, 2))
        else:
            return None  # >2 alleles at one site cannot be diploid
    return rows
