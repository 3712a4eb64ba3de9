"""Full-alignment feature extraction with in-process haplotagging.

Numpy reference implementation of the semantics of the reference C extractor
(src/clair3_full_alignment_dwell.c): for a list of candidate positions,
iterate reads once, haplotag each read (WhatsHap-style: per-variant local
realignment scored by Levenshtein distance, phase-set cost vote), decode
CIGARs into per-flanking-position info, then per candidate sort overlapping
reads by haplotype (random down-sample above matrix_depth, center padding
below) and fill an int8 tensor ``[cand, depth, 33, 8|9]``:

    ch0 reference_base  A=100 C=25 G=75 T=50 (N=100)
    ch1 alternative_base  same base code; I=-50, D=-100; 0 when ref match
    ch2 strand  fwd=50 rev=100
    ch3 mapping_quality  100*mq/60 capped 100
    ch4 base_quality     100*bq/40 capped 100
    ch5 candidate_af     100*count/depth, on non-deleted covered columns
    ch6 insert_base      inserted base codes overlaid from the anchor column
    ch7 haplotype        unphased=60 hap1=30 hap2=90
    ch8 dwell            per-base signal block count from the mv:B:c tag

Deleted columns of a read row stay all-zero.  The dwell channel wraps to
int8 like the C cast.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from benchmark.reference.frozen.config import FLANKING_BASE_NUM, NO_OF_POSITIONS
from benchmark.reference.frozen.io.bam import BamRead

OVERHANG = 10            # haplotag realignment window (header:19)
MIN_HAPLOTAG_MQ = 20

_BASE_VAL = {"A": 100, "C": 25, "G": 75, "T": 50, "N": 100}
_INS_VAL = -50
_DEL_VAL = -100
_ACGT = "ACGT"
_ACGT_IDX = {"A": 0, "C": 1, "G": 2, "T": 3}

HAP_UNPHASED, HAP_1, HAP_2 = 0, 1, 2
_HAP_VAL = (60, 30, 90)

_U64 = (1 << 64) - 1


class XorShift64:
    """xorshift64* PRNG, bit-identical to the C++ fast path (native/common.h)
    so read-subsampling decisions agree across implementations."""

    def __init__(self, seed: int):
        self.state = (seed & _U64) or 0x9E3779B97F4A7C15

    def next(self) -> int:
        x = self.state
        x ^= x >> 12
        x = (x ^ (x << 25)) & _U64
        x ^= x >> 27
        self.state = x
        return (x * 0x2545F4914F6CDD1D) & _U64

    def below(self, n: int) -> int:
        return self.next() % n


def candidate_seed(seed: int, cand_pos: int) -> int:
    return (seed ^ ((cand_pos * 0x100000001B3) & _U64)) & _U64


def subsample_indices(indices, depth: int, seed: int):
    """Fisher-Yates shuffle (shared algorithm with the C++ path), keep the
    first ``depth`` entries."""
    a = list(indices)
    rng = XorShift64(seed)
    for i in range(len(a) - 1, 0, -1):
        j = rng.below(i + 1)
        a[i], a[j] = a[j], a[i]
    return a[:depth]


def _norm_mq(mq: int) -> int:
    return int(100 * mq / 60.0) if mq < 60 else 100

def _norm_bq(bq: int) -> int:
    return int(100 * bq / 40.0) if bq < 40 else 100

def _norm_af(af: float) -> int:
    return int(100 * af) if af < 1.0 else 100

def _base_val(ch: str) -> int:
    return _BASE_VAL.get(ch, 0)


def levenshtein(a: str, b: str) -> int:
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


@dataclass(frozen=True)
class PhasedVariant:
    """One phased het SNP from the phaser (header Variant struct)."""

    position: int  # 0-based
    ref_base: str
    alt_base: str
    genotype: int  # 1 for 0|1, 2 for 1|0
    phase_set: int


def compute_signal_lengths(read: BamRead) -> Optional[np.ndarray]:
    """Per-base signal block counts from the Dorado mv:B:c tag; reversed for
    reverse-strand reads; first table entry is stride (skipped)."""
    mv = read.tags.get("mv")
    if mv is None or not isinstance(mv, np.ndarray) or len(mv) <= 1:
        return None
    l_qseq = len(read.seq)
    if l_qseq == 0:
        return None
    signals = np.zeros(l_qseq, np.int32)
    base_index = -1
    for movement in mv[1:]:
        if movement != 0:
            base_index += 1
            if base_index >= l_qseq:
                break
            signals[base_index] += 1
        else:
            if base_index < 0:
                continue
            if base_index >= l_qseq:
                break
            signals[base_index] += 1
    if read.is_reverse:
        signals = signals[::-1].copy()
    return signals


# ---------------------------------------------------------------------------
# haplotagging (clair3_full_alignment_dwell.c:158-422)
# ---------------------------------------------------------------------------

def _cigar_prefix_length(
    cigar: Sequence[Tuple[int, int]],
    reference_bases: int,
    left_idx: int,
    right_idx: int,
    consumed: int,
    reverse: bool,
) -> Tuple[int, int]:
    """Walk CIGAR [left_idx, right_idx) (optionally reversed), first op
    truncated to ``consumed``; returns (ref_bases, query_bases) consumed when
    ``reference_bases`` reference bases have been covered."""
    ref_pos = 0
    query_pos = 0
    for i in range(left_idx, right_idx):
        index = left_idx + right_idx - i - 1 if reverse else i
        op, length = cigar[index]
        if i == left_idx:
            length = consumed
        if length == 0:
            continue
        if op in (0, 7, 8):  # M =X
            query_pos += length
            ref_pos += length
            if ref_pos >= reference_bases:
                return reference_bases, query_pos + reference_bases - ref_pos
        elif op == 2:  # D
            ref_pos += length
            if ref_pos >= reference_bases:
                return reference_bases, query_pos
        elif op == 1:  # I
            query_pos += length
        elif op == 3:  # N
            return reference_bases, query_pos
    return ref_pos, query_pos


def _realign_allele(
    variant: PhasedVariant,
    read: BamRead,
    cigar_index: int,
    consumed: int,
    query_pos: int,
    ref_seq: str,
    ref_start: int,
) -> int:
    """0 = undecided, 1 = supports ref, 2 = supports alt."""
    cigar = read.cigar
    middle_length = cigar[cigar_index][1]
    left_consumed = max(consumed, 0)
    right_consumed = middle_length - consumed if consumed < middle_length else 0
    left_ref, left_query = _cigar_prefix_length(
        cigar, OVERHANG, 0, cigar_index + 1, left_consumed, reverse=True)
    right_ref, right_query = _cigar_prefix_length(
        cigar, OVERHANG + 1, cigar_index, len(cigar), right_consumed, reverse=False)
    qst = query_pos - left_query
    qen = query_pos + right_query
    if qen == qst:
        return 0
    # clamp to the fetched windows (matches the native path,
    # clair3t_fullalign.cc); phased SNPs can sit far outside the candidate
    # span and negative slices would otherwise wrap around
    rst = max(0, variant.position - left_ref - ref_start)
    ren = min(len(ref_seq), variant.position + right_ref - ref_start)
    qst = max(0, qst)
    qen = min(len(read.seq), qen)
    query = read.seq[qst:qen]
    ref = ref_seq[rst:ren]
    alt = ref[:left_ref] + variant.alt_base + ref[left_ref + 1:] if left_ref < len(ref) else ref
    d_ref = levenshtein(query, ref)
    d_alt = levenshtein(query, alt)
    if d_ref < d_alt:
        return 1
    if d_ref > d_alt:
        return 2
    return 0


def haplotag_read(
    read: BamRead,
    variants: Sequence[PhasedVariant],
    start_idx: int,
    ref_seq: str,
    ref_start: int,
) -> int:
    """WhatsHap-style haplotag: vote per phase set whether the read's local
    realignment matches each het SNP's hap1 allele."""
    cost: Dict[int, int] = {}
    j = start_idx
    n = len(variants)
    ref_pos = read.pos
    query_pos = 0
    while j < n and variants[j].position < ref_pos:
        j += 1

    def vote(allele: int, v: PhasedVariant) -> None:
        if allele == 0:
            return
        cost[v.phase_set] = cost.get(v.phase_set, 0) + (1 if allele == v.genotype else -1)

    for i, (op, length) in enumerate(read.cigar):
        if op in (0, 7, 8):
            while j < n and variants[j].position < ref_pos + length:
                v = variants[j]
                allele = _realign_allele(
                    v, read, i, v.position - ref_pos,
                    query_pos + v.position - ref_pos, ref_seq, ref_start)
                vote(allele, v)
                j += 1
            query_pos += length
            ref_pos += length
        elif op == 1:
            if j < n and variants[j].position == ref_pos:
                v = variants[j]
                allele = _realign_allele(v, read, i, 0, query_pos, ref_seq, ref_start)
                vote(allele, v)
                j += 1
            query_pos += length
        elif op == 2:
            while j < n and variants[j].position < ref_pos + length:
                v = variants[j]
                allele = _realign_allele(
                    v, read, i, v.position - ref_pos, query_pos, ref_seq, ref_start)
                vote(allele, v)
                j += 1
            ref_pos += length
        elif op == 3:
            while j < n and variants[j].position < ref_pos + length:
                j += 1
            ref_pos += length
        elif op == 4:
            query_pos += length

    if not cost:
        return HAP_UNPHASED
    max_v = max(max(cost.values()), 0)
    min_v = min(min(cost.values()), 0)
    if max_v == 0 and min_v == 0:
        return HAP_UNPHASED
    return HAP_1 if max_v > abs(min_v) else HAP_2


# ---------------------------------------------------------------------------
# per-read flanking info
# ---------------------------------------------------------------------------

@dataclass
class _ReadInfo:
    read: BamRead
    haplotype: int = HAP_UNPHASED
    read_end: int = 0
    # per flanking position (genome pos) info
    base: Dict[int, Tuple[str, int, int]] = field(default_factory=dict)   # pos -> (char, bq_norm, signal)
    dels: Dict[int, int] = field(default_factory=dict)                    # anchor -> del_len
    inss: Dict[int, Tuple[str, int]] = field(default_factory=dict)        # anchor -> (seq, ins_signal_sum)
    deleted: Set[int] = field(default_factory=set)                        # positions inside deletions


@dataclass
class _CandStats:
    depth: int = 0
    acgt: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    ins_counter: Dict[str, int] = field(default_factory=dict)
    del_counter: Dict[int, int] = field(default_factory=dict)


def fa_region(
    reads: Iterable[BamRead],
    ref_seq: str,
    ref_start: int,
    candidates0: Sequence[int],
    variants: Sequence[PhasedVariant] = (),
    *,
    matrix_depth: int = 89,
    max_indel_length: int = 50,
    need_haplotagging: bool = True,
    enable_dwell: bool = False,
    seed: int = 0,
) -> Tuple[np.ndarray, List[int], List[str]]:
    """Build FA tensors for 0-based candidate centers ``candidates0``.

    Returns (tensor [N, depth, 33, C] int8, candidate positions, alt-info
    strings 'depth-X.. I.. D.. R..')."""
    channels = 9 if enable_dwell else 8
    candidates0 = sorted(set(candidates0))
    n_cand = len(candidates0)
    cand_index = {c: i for i, c in enumerate(candidates0)}
    flanking: Set[int] = set()
    for c in candidates0:
        flanking.update(range(max(0, c - FLANKING_BASE_NUM), c + FLANKING_BASE_NUM + 1))

    stats = [_CandStats() for _ in range(n_cand)]
    infos: List[_ReadInfo] = []
    seen_names: Set[str] = set()
    variants = sorted(variants, key=lambda v: v.position)

    for read in reads:
        if not read.seq:  # SEQ '*' records carry no bases
            continue
        if read.qname in seen_names:
            continue
        seen_names.add(read.qname)
        info = _ReadInfo(read=read)
        info.read_end = read.reference_end
        # overlap check against the flanking set
        if not any(p in flanking for p in (read.pos, info.read_end - 1)) and not any(
            read.pos <= c + FLANKING_BASE_NUM and info.read_end > c - FLANKING_BASE_NUM
            for c in candidates0
        ):
            continue

        if need_haplotagging and variants and read.mapq >= MIN_HAPLOTAG_MQ:
            info.haplotype = haplotag_read(read, variants, 0, ref_seq, ref_start)

        signals = compute_signal_lengths(read) if enable_dwell else None

        ref_pos = read.pos
        query_pos = 0
        for ci, (op, length) in enumerate(read.cigar):
            if op in (0, 7, 8):
                for k in range(length):
                    p = ref_pos + k
                    if p in flanking:
                        qp = query_pos + k
                        sig = int(signals[qp]) if signals is not None and qp < len(read.seq) else 0
                        ch = read.seq[qp]
                        info.base[p] = (ch, _norm_bq(int(read.qual[qp])), sig)
                        idx = cand_index.get(p)
                        if idx is not None:
                            stats[idx].acgt[_ACGT_IDX.get(ch, 0)] += 1
                            stats[idx].depth += 1
                ref_pos += length
                query_pos += length
            elif op == 2:
                anchor = ref_pos - 1
                if anchor in flanking and anchor >= read.pos:
                    info.dels[anchor] = length
                    idx = cand_index.get(anchor)
                    if idx is not None:
                        stats[idx].del_counter[length] = stats[idx].del_counter.get(length, 0) + 1
                for p in range(ref_pos, ref_pos + length):
                    if p in flanking:
                        info.deleted.add(p)
                        idx = cand_index.get(p)
                        if idx is not None:
                            stats[idx].depth += 1
                ref_pos += length
            elif op == 1:
                anchor = ref_pos - 1
                if anchor in flanking and anchor >= read.pos:
                    seq = read.seq[query_pos: query_pos + length]
                    sig_sum = 0
                    if signals is not None:
                        hi = min(query_pos + length, len(read.seq))
                        sig_sum = int(signals[query_pos:hi].sum())
                    info.inss[anchor] = (seq, sig_sum)
                    idx = cand_index.get(anchor)
                    if idx is not None:
                        stats[idx].ins_counter[seq] = stats[idx].ins_counter.get(seq, 0) + 1
                query_pos += length
            elif op == 3:
                ref_pos += length
            elif op == 4:
                query_pos += length
        infos.append(info)

    infos.sort(key=lambda x: x.read.pos)

    matrix = np.zeros((n_cand, matrix_depth, NO_OF_POSITIONS, channels), np.int8)
    alt_infos: List[str] = []

    for i, cand in enumerate(candidates0):
        start_pos = cand - FLANKING_BASE_NUM
        end_pos = cand + FLANKING_BASE_NUM + 1
        overlaps = [
            j for j, info in enumerate(infos)
            if info.read.pos < end_pos and info.read_end > start_pos
        ]
        # random down-sample above matrix_depth, stable hap-sort, center pad
        if len(overlaps) > matrix_depth:
            overlaps = subsample_indices(
                overlaps, matrix_depth, candidate_seed(seed, cand))
        overlaps.sort(key=lambda j: (infos[j].haplotype, j))
        if len(overlaps) < matrix_depth:
            pad = matrix_depth - len(overlaps)
            prefix = pad >> 1
            rows = [-1] * prefix + overlaps + [-1] * (pad - prefix)
        else:
            rows = overlaps

        row_alt: List[Tuple[Optional[str], Optional[str], int]] = []  # (alt_base, ins_bases, del_len)
        depth_stats = stats[i].depth

        for d, j in enumerate(rows):
            if j == -1:
                row_alt.append((None, None, 0))
                continue
            info = infos[j]
            read = info.read
            hap_v = _HAP_VAL[info.haplotype]
            strand_v = 100 if read.is_reverse else 50
            mq_v = _norm_mq(read.mapq)
            center_alt: Tuple[Optional[str], Optional[str], int] = (None, None, 0)

            for p in range(NO_OF_POSITIONS):
                cp = start_pos + p
                if cp in info.deleted:
                    continue  # deleted columns stay all-zero
                entry = info.base.get(cp)
                if entry is None:
                    continue  # not covered by this read
                ch, bq_v, sig = entry
                ref_base = ref_seq[cp - ref_start].upper() if 0 <= cp - ref_start < len(ref_seq) else "N"
                ref_v = _base_val(ref_base)
                alt_v = 0
                is_center = p == FLANKING_BASE_NUM
                ins_entry = info.inss.get(cp)
                del_len = info.dels.get(cp, 0)
                if ins_entry is not None:
                    ins_seq, ins_sig = ins_entry
                    if p < NO_OF_POSITIONS - 1:
                        max_ins = min(len(ins_seq), NO_OF_POSITIONS - p)
                        for k in range(max_ins):
                            matrix[i, d, p + k, 6] = _base_val(ins_seq[k])
                    if is_center:
                        center_alt = (ch, ins_seq, 0)
                    alt_v = _INS_VAL
                    sig = sig + ins_sig if enable_dwell else sig
                elif del_len > 0:
                    if is_center:
                        center_alt = (None, None, del_len)
                    alt_v = _DEL_VAL
                elif ref_base != ch:
                    if is_center:
                        center_alt = (ch, None, 0)
                    alt_v = _base_val(ch)

                matrix[i, d, p, 0] = ref_v
                matrix[i, d, p, 1] = alt_v
                matrix[i, d, p, 2] = strand_v
                matrix[i, d, p, 3] = mq_v
                matrix[i, d, p, 4] = bq_v
                matrix[i, d, p, 7] = hap_v
                if enable_dwell:
                    matrix[i, d, p, 8] = np.int8(sig & 0xFF if sig >= 0 else sig)
            row_alt.append(center_alt)

        # AF channel
        for d, (alt_base, ins_bases, del_len) in enumerate(row_alt):
            if alt_base is None and ins_bases is None and del_len == 0:
                continue
            af_v = 0
            if ins_bases is not None:
                count = stats[i].ins_counter.get(ins_bases, 0)
                if count > 0 and depth_stats > 0:
                    af_v = _norm_af(count / depth_stats)
            elif del_len > 0:
                count = stats[i].del_counter.get(del_len, 0)
                if count > 0 and depth_stats > 0:
                    af_v = _norm_af(count / depth_stats)
            elif alt_base is not None:
                count = stats[i].acgt[_ACGT_IDX.get(alt_base, 0)]
                if depth_stats > 0:
                    af_v = _norm_af(count / depth_stats)
            if af_v > 0:
                mask = matrix[i, d, :, 0] != 0
                matrix[i, d, mask, 5] = af_v

        # alt-info string (I entries before D entries, like the C path)
        center_ref = ref_seq[cand - ref_start].upper() if 0 <= cand - ref_start < len(ref_seq) else "N"
        ref_idx = _ACGT_IDX.get(center_ref, 0)
        ref_count = stats[i].acgt[ref_idx]
        parts = []
        for b in range(4):
            if b != ref_idx and stats[i].acgt[b] > 0:
                parts.append(f"X{_ACGT[b]} {stats[i].acgt[b]}")
        for seq in sorted(stats[i].ins_counter):
            val = stats[i].ins_counter[seq]
            ref_count -= val
            if len(seq) <= max_indel_length:
                parts.append(f"I{center_ref}{seq} {val}")
        for dlen in sorted(stats[i].del_counter):
            val = stats[i].del_counter[dlen]
            ref_count -= val
            if dlen <= max_indel_length:
                del_seq = ref_seq[cand - ref_start + 1: cand - ref_start + 1 + dlen].upper()
                parts.append(f"D{del_seq} {val}")
        if ref_count > 0:
            parts.append(f"R{center_ref} {ref_count}")
        alt_infos.append(f"{depth_stats}-" + " ".join(parts) + (" " if parts else ""))

    return matrix, list(candidates0), alt_infos


def create_fa_tensors(
    bam_path: str,
    fasta_path: str,
    ctg_name: str,
    positions: Sequence[int],  # 1-based candidate centers
    *,
    phased_snps: Sequence[Tuple[int, str]] = (),
    matrix_depth: int = 89,
    min_mq: int = 5,
    no_phasing: bool = False,
    enable_dwell: bool = False,
    max_indel_length: int = 50,
    seed: int = 0,
) -> Tuple[np.ndarray, List[str], List[str]]:
    """End-to-end FA tensor creation for one candidate batch.

    ``phased_snps`` entries are (1-based pos, 'ref-alt-hap-phaseset') like
    SelectCandidates emits."""
    from benchmark.reference.frozen.io.bam import BamReader
    from benchmark.reference.frozen.io.fasta import FastaFile

    if not positions:
        C = 9 if enable_dwell else 8
        return np.zeros((0, matrix_depth, NO_OF_POSITIONS, C), np.int8), [], []

    candidates0 = sorted(int(p) - 1 for p in positions)
    variants = []
    for pos1, desc in phased_snps:
        ref_base, alt_base, hap, phase_set = desc.split("-")
        try:
            ps = int(phase_set)
        except ValueError:
            ps = 0
        variants.append(PhasedVariant(int(pos1) - 1, ref_base, alt_base, int(hap), ps))

    region_start = max(0, candidates0[0] - FLANKING_BASE_NUM)
    region_end = candidates0[-1] + FLANKING_BASE_NUM + 1

    fa = FastaFile(fasta_path)
    ctg_len = fa.contig_length(ctg_name)
    ref_fetch_start = max(0, region_start - 2000)
    ref_fetch_end = min(ctg_len, region_end + 2000)
    ref_seq = fa.fetch(ctg_name, ref_fetch_start, ref_fetch_end)
    fa.close()

    bam = BamReader(bam_path)
    reads = list(bam.fetch(ctg_name, region_start, region_end, min_mq=min_mq))
    tensor, cand_pos, alt_infos = fa_region(
        reads, ref_seq, ref_fetch_start, candidates0, variants,
        matrix_depth=matrix_depth, max_indel_length=max_indel_length,
        need_haplotagging=not no_phasing, enable_dwell=enable_dwell, seed=seed,
    )
    pos_infos = []
    for c in cand_pos:
        ref_base = ref_seq[c - ref_fetch_start].upper() if 0 <= c - ref_fetch_start < len(ref_seq) else "N"
        pos_infos.append(f"{ctg_name}:{c + 1}:{ref_base}")
    return tensor, pos_infos, alt_infos
