"""Local read realignment for short reads (Illumina path).

Counterpart of the reference's DeepVariant-derived realigner
(preprocess/RealignReads.py + preprocess/realign/realigner.cpp):

1. pick realignment windows from mismatch/indel event density,
2. build candidate haplotypes per window (de Bruijn consensus, realign/dbg.py),
3. realign each window read against haplotypes + the reference window
   (affine-gap local alignment, realign/align.py) and keep the best,
4. project the read's haplotype alignment back to reference coordinates
   (CIGAR composition through the haplotype->reference alignment).

Reads whose haplotype alignment does not beat their reference alignment are
left untouched.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from clair3_tpu_torch.io.bam import BamRead
from clair3_tpu_torch.realign.align import Alignment, affine_local_align
from clair3_tpu_torch.realign.dbg import consensus_haplotypes

# reference constants (RealignReads.py:17-21)
MIN_DBG_MAPPING_QUALITY = 20
MIN_DBG_BASE_QUALITY = 20
REGION_EXPANSION = 20           # expand_align_ref_region
MIN_WINDOWS_DISTANCE = REGION_EXPANSION * 4   # 80
MAX_WINDOW_SIZE = 1000
MIN_EVENT_COUNT = 2             # run_clair3.py min_coverage default


@dataclass(frozen=True)
class Window:
    start: int  # 0-based
    end: int


def select_realignment_windows(
    reads: Sequence[BamRead],
    ref_seq: str,
    ref_offset: int,
    start: int,
    end: int,
    *,
    min_event_count: int = MIN_EVENT_COUNT,
    min_distance: int = MIN_WINDOWS_DISTANCE,
) -> List[Window]:
    """Candidate positions with mismatch/indel/soft-clip evidence, clustered
    into realignment windows.

    Reference semantics (RealignReads.py:257-301, 469-489):

    * only reads with MQ >= 20 contribute events;
    * mismatches count only when the base quality is >= 20 and the reference
      base is ACGT;
    * insertions AND soft clips spread their event over [pos-len, pos+len)
      (all inserted/clipped bases must have BQ >= 20);
    * deletions spread theirs over [pos, pos+len);
    * positions with >= min_event_count events become candidates; candidates
      within 2x min_windows_distance of each other cluster into one window,
      padded by min_windows_distance on both sides;
    * windows longer than max_window_size are dropped.
    """
    L = end - start
    if L <= 0:
        return []
    events = np.zeros(L, np.int32)
    rlen = len(ref_seq)

    def bump(lo: int, hi: int) -> None:
        lo, hi = max(lo, start), min(hi, end)
        if lo < hi:
            events[lo - start: hi - start] += 1

    for read in reads:
        if read.mapq < MIN_DBG_MAPPING_QUALITY:
            continue
        rpos, qpos = read.pos, 0
        qual = read.qual
        for op, ln in read.cigar:
            if op in (0, 7, 8):
                lo, hi = max(rpos, start), min(rpos + ln, end)
                for p in range(lo, hi):
                    roff = p - ref_offset
                    qp = qpos + (p - rpos)
                    if (0 <= roff < rlen and qual[qp] >= MIN_DBG_BASE_QUALITY
                            and ref_seq[roff] in "ACGT"
                            and read.seq[qp] != ref_seq[roff]):
                        events[p - start] += 1
                rpos += ln
                qpos += ln
            elif op == 1 or op == 4:  # insertion / soft clip
                pre = rpos - 1 - ref_offset
                if (0 <= pre < rlen and ref_seq[pre] in "ACGT"
                        and all(qual[qp] >= MIN_DBG_BASE_QUALITY
                                for qp in range(qpos, min(qpos + ln, len(qual))))):
                    bump(rpos - ln, rpos + ln)
                qpos += ln
            elif op == 2:  # deletion
                pre = rpos - 1 - ref_offset
                if 0 <= pre < rlen and ref_seq[pre] in "ACGT":
                    bump(rpos, rpos + ln)
                rpos += ln
            elif op == 3:
                rpos += ln

    positions = np.nonzero(events >= min_event_count)[0]
    windows: List[Window] = []
    w_start = w_end = None
    for idx in positions:
        p = start + int(idx)
        if w_start is None:
            w_start = w_end = p
        elif p > w_end + 2 * min_distance:
            windows.append(Window(w_start - min_distance, w_end + min_distance))
            w_start = w_end = p
        else:
            w_end = p
    if w_start is not None:
        windows.append(Window(w_start - min_distance, w_end + min_distance))
    return [w for w in windows if w.end - w.start <= MAX_WINDOW_SIZE]


def assign_reads_to_windows(
    reads: Sequence[BamRead], windows: Sequence[Window],
) -> Dict[Window, List[int]]:
    """Each read realigns in at most one window: the one it overlaps most
    (reference find_max_overlap_index, RealignReads.py:493-498)."""
    out: Dict[Window, List[int]] = {w: [] for w in windows}
    if not windows:
        return out
    for i, read in enumerate(reads):
        best = None
        best_ov = 0
        for w in windows:
            ov = min(read.reference_end, w.end) - max(read.pos, w.start)
            if ov > best_ov:
                best_ov = ov
                best = w
        if best is not None:
            out[best].append(i)
    return out


def _hap_to_ref_map(hap: str, ref_window: str) -> Optional[np.ndarray]:
    """Array mapping haplotype position -> ref-window position (-1 for
    haplotype-inserted bases), or None when the alignment is too partial."""
    aln = affine_local_align(hap, ref_window)
    if aln.score <= 0:
        return None
    # require the haplotype to align nearly end to end
    if aln.query_start > 5 or len(hap) - aln.query_end > 5:
        return None
    hmap = np.full(len(hap), -1, np.int64)
    h, r = aln.query_start, aln.target_start
    for op, ln in aln.cigar:
        if op == 0:
            for k in range(ln):
                hmap[h + k] = r + k
            h += ln
            r += ln
        elif op == 1:  # insertion: hap-only bases
            h += ln
        elif op == 2:  # deletion: ref-only bases
            r += ln
    return hmap


def _compose_cigar(
    read_aln: Alignment,
    hmap: np.ndarray,
    window_start: int,
    query_len: int,
) -> Optional[Tuple[int, List[Tuple[int, int]]]]:
    """Project a read->haplotype alignment through the haplotype->reference
    map; returns (new 0-based ref pos, full CIGAR with soft clips)."""
    ops: List[Tuple[int, int]] = []

    def push(op: int, ln: int = 1) -> None:
        if ln <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + ln)
        else:
            ops.append((op, ln))

    h = read_aln.target_start
    new_pos = -1
    prev_ref: Optional[int] = None
    for op, ln in read_aln.cigar:
        if op == 0:  # read bases matched to hap bases
            for k in range(ln):
                r = int(hmap[h + k])
                if r < 0:
                    push(1)  # read base sits on an inserted hap base
                    continue
                if prev_ref is not None and r > prev_ref + 1:
                    push(2, r - prev_ref - 1)  # ref bases skipped: deletion
                if new_pos < 0:
                    new_pos = r
                push(0)
                prev_ref = r
            h += ln
        elif op == 1:  # read-only bases
            push(1, ln)
        elif op == 2:  # hap-only bases consumed
            n_ref = int((hmap[h: h + ln] >= 0).sum())
            if n_ref and prev_ref is not None:
                # deletion across the mapped portion
                last = int(hmap[h: h + ln][hmap[h: h + ln] >= 0][-1])
                push(2, last - prev_ref)
                prev_ref = last
            h += ln
    if new_pos < 0 or not ops:
        return None
    # normalize: leading/trailing insertions become soft clips
    lead_extra = 0
    while ops and ops[0][0] != 0:
        op, ln = ops.pop(0)
        if op == 1:
            lead_extra += ln
        else:
            return None
    tail_extra = 0
    while ops and ops[-1][0] != 0:
        op, ln = ops.pop()
        if op == 1:
            tail_extra += ln
        else:
            return None
    if not ops:
        return None
    full: List[Tuple[int, int]] = []
    lead_clip = read_aln.query_start + lead_extra
    if lead_clip:
        full.append((4, lead_clip))
    full.extend(ops)
    tail_clip = (query_len - read_aln.query_end) + tail_extra
    if tail_clip:
        full.append((4, tail_clip))
    return window_start + new_pos, full


def realign_reads_in_region(
    reads: Sequence[BamRead],
    ref_seq: str,
    ref_offset: int,
    start: int,
    end: int,
) -> Tuple[List[BamRead], int]:
    """Realign reads across all hot windows in [start, end); returns the
    (possibly modified) reads and the number realigned."""
    out = list(reads)
    windows = select_realignment_windows(out, ref_seq, ref_offset, start, end)
    assignment = assign_reads_to_windows(out, windows)
    n_realigned = 0
    for win in windows:
        ref_window = ref_seq[win.start - ref_offset: win.end - ref_offset]
        if not ref_window:
            continue
        window_read_idx = assignment[win]
        if not window_read_idx:
            continue
        # DBG consensus over MQ>=20 reads only (RealignReads.py:513-514)
        dbg_seqs = [out[i].seq for i in window_read_idx
                    if out[i].mapq >= MIN_DBG_MAPPING_QUALITY]
        if not dbg_seqs:
            continue
        haps = consensus_haplotypes(dbg_seqs, ref_window)
        alt_haps = [h for h in haps if h != ref_window]
        if not alt_haps:
            continue
        # extend haplotypes over the assigned reads' full span +/- 20bp so
        # whole reads align end-to-end (RealignReads.py:536-558)
        min_read_start = min(out[i].pos for i in window_read_idx)
        max_read_end = max(out[i].reference_end for i in window_read_idx)
        ext_start = max(ref_offset,
                        min(min_read_start, win.start) - REGION_EXPANSION)
        ext_end = min(ref_offset + len(ref_seq),
                      max(max_read_end, win.end) + REGION_EXPANSION)
        if ext_end < win.end or ext_start > win.start:
            continue
        prefix = ref_seq[ext_start - ref_offset: win.start - ref_offset]
        suffix = ref_seq[win.end - ref_offset: ext_end - ref_offset]
        P, W = len(prefix), win.end - win.start
        ext_ref = prefix + ref_window + suffix
        hmaps = []
        for hap in alt_haps:
            hmap = _hap_to_ref_map(hap, ref_window)
            if hmap is None:
                continue
            # extended hap->ref map: identity flanks, shifted window core
            core = np.where(hmap >= 0, hmap + P, -1)
            ext_map = np.concatenate([
                np.arange(P, dtype=np.int64),
                core,
                np.arange(P + W, P + W + len(suffix), dtype=np.int64),
            ])
            hmaps.append((prefix + hap + suffix, ext_map))
        if not hmaps:
            continue
        for i in window_read_idx:
            read = out[i]
            ref_aln = affine_local_align(read.seq, ext_ref)
            best: Optional[Tuple[Alignment, np.ndarray]] = None
            for hap, hmap in hmaps:
                aln = affine_local_align(read.seq, hap)
                if aln.score > ref_aln.score and (
                        best is None or aln.score > best[0].score):
                    best = (aln, hmap)
            if best is None:
                continue
            composed = _compose_cigar(best[0], best[1], ext_start, len(read.seq))
            if composed is None:
                continue
            new_pos, new_cigar = composed
            out[i] = dc_replace(read, pos=new_pos, cigar=new_cigar)
            n_realigned += 1
    out.sort(key=lambda r: (r.tid, r.pos))
    return out, n_realigned


def realign_bam_region(
    bam_path: str,
    fasta_path: str,
    ctg_name: str,
    start: int,
    end: int,
    out_bam_path: str,
    min_mq: int = 5,
) -> Tuple[str, int]:
    """Realign a region and write a new BAM (keeps all fetched reads)."""
    from clair3_tpu_torch.io.bam import BamReader, write_bam
    from clair3_tpu_torch.io.fasta import FastaFile

    fa = FastaFile(fasta_path)
    ctg_len = fa.contig_length(ctg_name)
    ref_start = max(0, start - 2000)
    ref_seq = fa.fetch(ctg_name, ref_start, min(ctg_len, end + 2000))
    fa.close()
    bam = BamReader(bam_path)
    reads = list(bam.fetch(ctg_name, start, end, min_mq=min_mq))
    realigned, n = realign_reads_in_region(reads, ref_seq, ref_start, start, end)
    write_bam(out_bam_path, bam.references, bam.lengths, realigned)
    return out_bam_path, n
