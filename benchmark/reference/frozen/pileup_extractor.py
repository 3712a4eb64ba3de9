"""Pileup feature extraction + candidate selection.

Numpy reference implementation of the semantics of the reference C extractor
(src/clair3_pileup.c:142-476): per-column 18-channel counts

    A+ C+ G+ T+ I_S+ I1_S+ D_S+ D1_S+ D_R+  A- C- G- T- I_S- I1_S- D_S- D1_S- D_R-

with the two ref-base columns negated to the strand sums, simultaneous
candidate selection (AF/depth thresholds, non-ref-majority and tie-break
rules, contiguous-flank gating), per-candidate alt-info strings, and the
per-position ref/total counts for gVCF.

The C++ fast path (clair3_tpu_torch/native) implements the identical contract for
production throughput; this module is the correctness oracle and the
fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from benchmark.reference.frozen.config import (
    FLANKING_BASE_NUM,
    NO_OF_POSITIONS,
    PILEUP_CHANNEL_SIZE,
)
from benchmark.reference.frozen.io.bam import BamRead

# channel layout (clair3_pileup.h:50-71)
_FWD_INS_ALL = 4
_FWD_INS_BEST = 5
_FWD_DEL_ALL = 6
_FWD_DEL_BEST = 7
_FWD_DEL = 8
_REV_OFFSET = 9

_BASE_INDEX = {"A": 0, "C": 1, "G": 2, "T": 3}
_BASES = "ACGT"


@dataclass
class PileupCandidate:
    pos: int          # 0-based reference position
    depth: int
    ref_base: str
    alt_info: str     # "depth-Xa n Ic.. n Dc.. n Rr n " (decode contract)


@dataclass
class PileupResult:
    start: int                     # 0-based start of the counted window
    counts: np.ndarray             # [L, 18] int32, ref columns negated
    depth: np.ndarray              # [L] int32 reads per column
    candidates: List[PileupCandidate]
    pos_ref_count: Optional[np.ndarray] = None    # [L] gVCF
    pos_total_count: Optional[np.ndarray] = None  # [L] gVCF


def pileup_region(
    reads: Iterable[BamRead],
    ref_seq: str,
    ref_offset: int,
    start: int,
    end: int,
    *,
    min_depth: int = 2,
    min_snp_af: float = 0.08,
    min_indel_af: float = 0.15,
    max_indel_length: int = 50,
    call_snp_only: bool = False,
    gvcf: bool = False,
    call_ht: bool = False,
) -> PileupResult:
    """Count the pileup over reference positions [start, end).

    ``reads`` must already be flag/MQ filtered (io.bam.BamReader.fetch does
    this).  ``ref_seq`` covers at least [start, end + longest deletion) with
    ``ref_offset`` its 0-based reference start.
    """
    L = end - start
    counts = np.zeros((L, PILEUP_CHANNEL_SIZE), dtype=np.int64)
    depth = np.zeros(L, dtype=np.int32)
    # per-position indel events, keyed by window index
    dels: Dict[int, Dict[int, List[int]]] = {}   # idx -> {del_len: [fwd, rev]}
    inss: Dict[int, Dict[str, List[int]]] = {}   # idx -> {ins_seq: [fwd, rev]}

    for read in reads:
        if not read.seq:  # SEQ '*' records carry no bases
            continue
        strand = _REV_OFFSET if read.is_reverse else 0
        rev = read.is_reverse
        rpos = read.pos
        qpos = 0
        for op, ln in read.cigar:
            if op in (0, 7, 8):  # M, =, X
                lo = max(rpos, start)
                hi = min(rpos + ln, end)
                if lo < hi:
                    sub = read.seq[qpos + (lo - rpos): qpos + (hi - rpos)]
                    idxs = np.arange(lo - start, hi - start)
                    depth[idxs] += 1
                    codes = np.frombuffer(sub.encode(), dtype=np.uint8)
                    for base, ch in _BASE_INDEX.items():
                        sel = idxs[codes == ord(base)]
                        if len(sel):
                            np.add.at(counts, (sel, ch + strand), 1)
                rpos += ln
                qpos += ln
            elif op == 1:  # I — anchored at the previous reference position
                anchor = rpos - 1
                if start <= anchor < end and anchor >= read.pos:
                    seq = read.seq[qpos: qpos + ln]
                    d = inss.setdefault(anchor - start, {})
                    pair = d.setdefault(seq, [0, 0])
                    pair[1 if rev else 0] += 1
                qpos += ln
            elif op == 2:  # D — event at anchor; deleted bases fill D_R
                anchor = rpos - 1
                if start <= anchor < end and anchor >= read.pos:
                    d = dels.setdefault(anchor - start, {})
                    pair = d.setdefault(ln, [0, 0])
                    pair[1 if rev else 0] += 1
                lo = max(rpos, start)
                hi = min(rpos + ln, end)
                if lo < hi:
                    idxs = np.arange(lo - start, hi - start)
                    depth[idxs] += 1
                    np.add.at(counts, (idxs, _FWD_DEL + strand), 1)
                rpos += ln
            elif op == 3:  # N refskip: consumes reference, no depth
                rpos += ln
            elif op == 4:  # S
                qpos += ln
            # H, P: nothing

    # finalize indel summary channels
    for idx, d in dels.items():
        f = [c[0] for c in d.values()]
        r = [c[1] for c in d.values()]
        counts[idx, _FWD_DEL_ALL] = sum(f)
        counts[idx, _FWD_DEL_BEST] = max(f) if f else 0
        counts[idx, _FWD_DEL_ALL + _REV_OFFSET] = sum(r)
        counts[idx, _FWD_DEL_BEST + _REV_OFFSET] = max(r) if r else 0
    for idx, d in inss.items():
        f = [c[0] for c in d.values()]
        r = [c[1] for c in d.values()]
        counts[idx, _FWD_INS_ALL] = sum(f)
        counts[idx, _FWD_INS_BEST] = max(f) if f else 0
        counts[idx, _FWD_INS_ALL + _REV_OFFSET] = sum(r)
        counts[idx, _FWD_INS_BEST + _REV_OFFSET] = max(r) if r else 0

    candidates: List[PileupCandidate] = []
    pos_ref_count = np.zeros(L, dtype=np.int64) if gvcf else None
    pos_total_count = np.zeros(L, dtype=np.int64) if gvcf else None

    contiguous = 0
    pre_pos = -2
    for idx in range(L):
        if depth[idx] == 0:
            continue
        pos = start + idx
        if pre_pos + 1 != pos:
            contiguous = 0
        else:
            contiguous += 1
        pre_pos = pos

        ref_base = ref_seq[pos - ref_offset].upper() if 0 <= pos - ref_offset < len(ref_seq) else "N"
        ref_in_acgt = ref_base in _BASE_INDEX
        # like the C path (base2index, clair3_pileup.h:36), unknown reference
        # bases map to index 0 ('A') for counting/negation; candidacy is
        # blocked separately by the ACGT check.
        ref_idx = _BASE_INDEX.get(ref_base, 0)

        fwd = counts[idx, 0:4]
        rev_c = counts[idx, _REV_OFFSET:_REV_OFFSET + 4]
        forward_sum = int(fwd.sum())
        reverse_sum = int(rev_c.sum())

        ref_count = 0
        alt_count = 0
        all_alt_count = 0
        major_alt_base = ""
        for i in range(4):
            current = int(fwd[i] + rev_c[i])
            if i == ref_idx:
                ref_count = current
            elif current > alt_count:
                alt_count = current
                major_alt_base = _BASES[i]
                # reference quirk (clair3_pileup.c:365): accumulates each
                # successive max, not the final one — kept for gVCF parity.
                all_alt_count += alt_count

        del_events = dels.get(idx, {})
        ins_events = inss.get(idx, {})
        del_count = sum(f + r for f, r in del_events.values())
        ins_count = sum(f + r for f, r in ins_events.values())

        # negate the ref-base columns (clair3_pileup.c:370-371), also for
        # non-ACGT reference bases (mapped to 'A'), matching the C path
        counts[idx, ref_idx] = -forward_sum
        counts[idx, ref_idx + _REV_OFFSET] = -reverse_sum

        col_depth = max(1, int(depth[idx]))
        pass_min_depth = col_depth >= min_depth
        non_ref_majority = ref_count < alt_count or ref_count < ins_count or ref_count < del_count
        ref_alt_equal_majority = (
            ref_count > 0 and ref_count == alt_count
            and bool(major_alt_base) and ref_base < major_alt_base
        )
        if call_snp_only:
            pass_af = alt_count / col_depth >= min_snp_af
        else:
            pass_af = (
                non_ref_majority
                or ref_alt_equal_majority
                or alt_count / col_depth >= min_snp_af
                or del_count / col_depth >= min_indel_af
                or ins_count / col_depth >= min_indel_af
            )
        pass_af = pass_af and pass_min_depth and ref_in_acgt
        if not call_ht:
            pass_af = pass_af and contiguous >= FLANKING_BASE_NUM

        if pass_af:
            parts = []
            ref_depth = ref_count
            for i in range(4):
                alt_sum = int(fwd[i] + rev_c[i])
                if i == ref_idx:
                    # ref column was just negated; its original value is ref_count
                    continue
                if alt_sum > 0:
                    parts.append(f"X{_BASES[i]} {alt_sum}")
            for dlen in sorted(del_events):
                n = sum(del_events[dlen])
                ref_depth -= n
                if n > 0 and dlen <= max_indel_length:
                    del_seq = ref_seq[pos - ref_offset + 1: pos - ref_offset + 1 + dlen].upper()
                    parts.append(f"D{del_seq} {n}")
            for seq in sorted(ins_events):
                n = sum(ins_events[seq])
                ref_depth -= n
                if len(seq) <= max_indel_length:
                    parts.append(f"I{ref_base}{seq} {n}")
            if ref_depth > 0:
                parts.append(f"R{ref_base} {ref_depth}")
            alt_info = f"{col_depth}-" + " ".join(parts) + (" " if parts else "")
            candidates.append(PileupCandidate(pos, col_depth, ref_base, alt_info))

        if gvcf:
            pos_ref_count[idx] = ref_count
            pos_total_count[idx] = ref_count + all_alt_count + del_count + ins_count

    return PileupResult(
        start=start,
        counts=counts.astype(np.int32),
        depth=depth,
        candidates=candidates,
        pos_ref_count=pos_ref_count,
        pos_total_count=pos_total_count,
    )


def candidate_tensors(
    result: PileupResult,
    ctg_name: str,
    *,
    head_tail: bool = False,
    positions_filter=None,
) -> Tuple[np.ndarray, List[str], List[str]]:
    """Slice per-candidate [33, 18] windows from the dense counts
    (reference: CreateTensorPileupFromCffi.py:343-396).

    Windows containing any all-zero column are rejected (no coverage in a
    flanking position), except in head/tail mode where out-of-coverage edges
    are zero-padded.  Returns (tensor [N,33,18] int32, position_info list
    "ctg:pos1:ref", alt_info list).
    """
    L = result.counts.shape[0]
    cands = result.candidates
    if positions_filter is not None:
        cands = [c for c in cands if positions_filter(c.pos)]
    if not cands:
        return (np.zeros((0, NO_OF_POSITIONS, PILEUP_CHANNEL_SIZE), np.int32),
                [], [])

    # vectorized window gather (the per-candidate Python loop dominated
    # tensor creation at WGS candidate counts).  Column emptiness is derived
    # from the gathered windows themselves: sweeping the full [L,18] counts
    # for a col_empty mask costs more than the entire gather at WGS chunk
    # sizes (L ~ 1e6 rows vs N*33 ~ 1e4-1e5 gathered rows).  NOTE: depth==0
    # would be cheaper still but differs on all-N columns (nonzero depth,
    # zero matrix row).
    centers = np.fromiter((c.pos - result.start for c in cands), np.int64,
                          count=len(cands))
    los = centers - FLANKING_BASE_NUM
    idx = los[:, None] + np.arange(NO_OF_POSITIONS)[None, :]
    valid = (idx >= 0) & (idx < L)
    idx_clip = np.clip(idx, 0, L - 1)
    in_range = valid.all(axis=1)
    wins = result.counts[idx_clip]  # fancy-index gather (fresh array)
    if wins.dtype != np.int32:
        wins = wins.astype(np.int32)
    if head_tail:
        keep = np.ones(len(cands), bool)
    else:
        empty_within = ~wins.any(axis=2)
        keep = in_range & ~empty_within.any(axis=1)
    if not keep.any():
        return (np.zeros((0, NO_OF_POSITIONS, PILEUP_CHANNEL_SIZE), np.int32),
                [], [])
    kidx = np.nonzero(keep)[0]
    wins = wins[kidx]
    if head_tail and not valid[kidx].all():
        wins *= valid[kidx][:, :, None]  # zero-pad out-of-range rows
    pos_infos = [f"{ctg_name}:{cands[i].pos + 1}:{cands[i].ref_base}" for i in kidx]
    alt_infos = [cands[i].alt_info for i in kidx]
    return wins, pos_infos, alt_infos


def create_pileup_tensors(
    bam_path: str,
    fasta_path: str,
    ctg_name: str,
    ctg_start: int,
    ctg_end: int,
    *,
    min_mq: int = 5,
    min_depth: int = 2,
    min_snp_af: float = 0.08,
    min_indel_af: float = 0.15,
    max_indel_length: int = 50,
    call_snp_only: bool = False,
    gvcf: bool = False,
    head_tail: bool = False,
    positions_filter=None,
) -> Tuple[np.ndarray, List[str], List[str], PileupResult]:
    """End-to-end tensor creation for a 1-based inclusive region
    [ctg_start, ctg_end], expanding by the window size like the reference
    (CreateTensorPileupFromCffi.py:312-317)."""
    from benchmark.reference.frozen.io.fasta import FastaFile

    ctg_start = max(1, ctg_start)
    extend_start0 = max(0, ctg_start - 1 - NO_OF_POSITIONS)
    fa = FastaFile(fasta_path)
    ctg_len = fa.contig_length(ctg_name)
    extend_end0 = min(ctg_len, ctg_end + NO_OF_POSITIONS)

    ref_start = max(0, extend_start0 - 1000)
    ref_end = min(ctg_len, extend_end0 + 1000)
    ref_seq = fa.fetch(ctg_name, ref_start, ref_end)
    fa.close()

    from benchmark.reference.frozen.io.bam import BamReader

    bam = BamReader(bam_path)
    reads = bam.fetch(ctg_name, extend_start0, extend_end0, min_mq=min_mq)
    result = pileup_region(
        reads, ref_seq, ref_start, extend_start0, extend_end0,
        min_depth=min_depth, min_snp_af=min_snp_af, min_indel_af=min_indel_af,
        max_indel_length=max_indel_length, call_snp_only=call_snp_only,
        gvcf=gvcf, call_ht=head_tail,
    )
    tensors, pos_infos, alt_infos = candidate_tensors(
        result, ctg_name, head_tail=head_tail, positions_filter=positions_filter)
    return tensors, pos_infos, alt_infos, result
