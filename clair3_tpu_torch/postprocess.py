"""Post-processing tools.

Ports of the reference postprocess/ suite:
* ``add_back_missing_variants`` — genotyping mode: re-add candidate sites
  missing from the output as ./. rows (AddBackMissingVariantsInGenotyping.py).
* ``switch_zygosity_based_on_sv_calls`` — relabel 1/1 SNPs inside SV
  deletions as 0/1 when every flanking column shows enough deleted-read
  support (SwitchZygosityBasedOnSVCalls.py; README.md:703-719).
* ``variant_metrics`` — precision/recall/F1 per SNP/Indel against a truth
  set (self-contained comparator; hap.py is unavailable in this image), plus
  ``parse_happy_vcf`` mirroring clair3/metrics/GetOverallMetrics.py for
  interop with hap.py outputs.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from clair3_tpu_torch.io.bed import BedIntervals
from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord, parse_vcf_line
from clair3_tpu_torch.pipeline.merge_sort import MAJOR_CONTIGS_ORDER


# ---------------------------------------------------------------------------
# genotyping add-back
# ---------------------------------------------------------------------------

def add_back_missing_variants(
    candidate_rows: Iterable[VcfRecord],
    called_rows: Sequence[str],
    switch_genotype: bool = True,
) -> List[str]:
    """For genotyping mode (--vcf_fn): every candidate site appears in the
    output; sites Clair3 did not call become ./. rows."""
    called_by_key: Dict[Tuple[str, int], str] = {}
    for row in called_rows:
        if row.startswith("#"):
            continue
        cols = row.split("\t", 2)
        called_by_key[(cols[0], int(cols[1]))] = row

    contig_rows: Dict[str, List[Tuple[int, str]]] = defaultdict(list)
    count = 0
    for rec in candidate_rows:
        key = (rec.chrom, rec.pos)
        if key in called_by_key:
            row = called_by_key[key]
        else:
            count += 1
            if switch_genotype:
                ref = rec.ref[0] if rec.ref else "."
                row = (f"{rec.chrom}\t{rec.pos}\t.\t{ref}\t.\t.\t.\t.\tGT\t./.\n")
            else:
                row = rec.to_line() + "\n"
        contig_rows[rec.chrom].append((rec.pos, row))

    order = list(MAJOR_CONTIGS_ORDER) + list(contig_rows)
    out: List[str] = []
    for ctg in sorted(contig_rows, key=lambda x: order.index(x)):
        out.extend(row for _, row in sorted(contig_rows[ctg]))
    return out


# ---------------------------------------------------------------------------
# SV-based zygosity switching
# ---------------------------------------------------------------------------

def _deletion_support_ok(
    bam_fn: str, ctg: str, pos1: int, *, flanking: int = 16, min_mq: int = 5,
    min_del_proportion: float = 0.3,
) -> bool:
    """True when EVERY covered column in pos +- flanking has >= the required
    deleted-read proportion (extract_base semantics)."""
    from clair3_tpu_torch.io.bam import BamReader

    start = pos1 - 1 - flanking
    end = pos1 + flanking
    L = end - start
    depth = [0] * L
    dels = [0] * L
    bam = BamReader(bam_fn)
    for read in bam.fetch(ctg, start, end, min_mq=min_mq):
        rpos = read.pos
        for op, length in read.cigar:
            if op in (0, 7, 8):
                for p in range(max(rpos, start), min(rpos + length, end)):
                    depth[p - start] += 1
                rpos += length
            elif op == 2:
                for p in range(max(rpos, start), min(rpos + length, end)):
                    depth[p - start] += 1
                    dels[p - start] += 1
                rpos += length
            elif op == 3:
                rpos += length
    for d, dl in zip(depth, dels):
        if d == 0:
            continue
        if dl / max(float(d), 1.0) < min_del_proportion:
            return False
    return True


def sv_deletion_intervals_from_vcf(
    sv_vcf_fn: str, filter_tag: str = "PASS", alt_tag: str = "<DEL>"
) -> BedIntervals:
    """SV deletion spans from a Sniffles-style VCF (ALT <DEL> / SVLEN)."""
    tree = BedIntervals()
    for rec in VcfReader(sv_vcf_fn):
        if filter_tag and filter_tag not in rec.filter:
            continue
        is_del = rec.alt == alt_tag or "SVTYPE=DEL" in rec.info
        if not is_del:
            continue
        end = rec.pos + len(rec.ref)
        for field in rec.info.split(";"):
            if field.startswith("END="):
                end = int(field[4:])
            elif field.startswith("SVLEN="):
                end = rec.pos + abs(int(field[6:]))
        tree.add(rec.chrom, rec.pos - 1, end)
    return tree


def switch_zygosity_based_on_sv_calls(
    bam_fn: str,
    clair3_rows: Sequence[str],
    sv_tree: BedIntervals,
    *,
    max_af: float = 0.7,
    flanking: int = 16,
    min_del_proportion: float = 0.3,
    min_mq: int = 5,
) -> Tuple[List[str], int]:
    """Relabel 1/1 SNP rows inside SV deletions as 0/1; adds SVBASEDHET and
    ORG_CLAIR3_SCORE INFO tags.  Returns (rows, n_switched)."""
    out: List[str] = []
    n_switched = 0
    for row in clair3_rows:
        if row.startswith("#"):
            out.append(row)
            continue
        rec = parse_vcf_line(row)
        gt = rec.genotype
        fields = rec.sample.split(":")
        fmt = rec.format.split(":")
        af = None
        if "AF" in fmt:
            try:
                af = float(fields[fmt.index("AF")].split(",")[0])
            except ValueError:
                af = None
        eligible = (
            sum(gt) == 2 and gt[0] == gt[1]
            and af is not None and af <= max_af
            and len(rec.ref) == 1 and len(rec.alt) == 1
            and rec.filter == "PASS"
            and sv_tree.contains(rec.chrom, rec.pos)
        )
        if eligible and _deletion_support_ok(
            bam_fn, rec.chrom, rec.pos, flanking=flanking, min_mq=min_mq,
            min_del_proportion=min_del_proportion,
        ):
            cols = row.rstrip("\n").split("\t")
            cols[9] = cols[9].replace("1/1", "0/1", 1)
            org_qual = cols[5]
            cols[7] += ";SVBASEDHET;ORG_CLAIR3_SCORE=" + org_qual
            row = "\t".join(cols) + "\n"
            n_switched += 1
        out.append(row)
    return out, n_switched


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@dataclass
class MetricsRow:
    variant_type: str
    query_fp: int
    truth_fn: int
    truth_tp: int
    query_tp: int
    precision: float
    recall: float
    f1: float


def _f1(query_fp: int, query_tp: int, truth_fn: int, truth_tp: int):
    precision = query_tp / (query_tp + query_fp) if (query_tp + query_fp) else 0.0
    recall = truth_tp / (truth_tp + truth_fn) if (truth_tp + truth_fn) else 0.0
    f1 = (2 * precision * recall / (precision + recall)) if (precision + recall) else 0.0
    return round(precision, 6), round(recall, 6), round(f1, 6)


def _norm_gt(gt: Tuple[int, int]) -> Tuple[int, int]:
    return tuple(sorted(gt))


def variant_metrics(
    truth: Sequence[VcfRecord], query: Sequence[VcfRecord],
    genotype_match: bool = True,
) -> Dict[str, MetricsRow]:
    """Site+allele(+genotype) exact-match comparison, split SNP/Indel."""
    def kind(rec: VcfRecord) -> str:
        return "SNP" if rec.is_snp else "INDEL"

    def key(rec: VcfRecord):
        alts = ",".join(sorted(rec.alt.split(",")))
        k = (rec.chrom, rec.pos, rec.ref, alts)
        return k + (_norm_gt(rec.genotype),) if genotype_match else k

    truth_by_kind: Dict[str, Set] = {"SNP": set(), "INDEL": set()}
    for rec in truth:
        truth_by_kind[kind(rec)].add(key(rec))
    query_by_kind: Dict[str, Set] = {"SNP": set(), "INDEL": set()}
    for rec in query:
        if rec.alt == "." or rec.ref == rec.alt:
            continue
        query_by_kind[kind(rec)].add(key(rec))

    out = {}
    for vt in ("SNP", "INDEL"):
        t, q = truth_by_kind[vt], query_by_kind[vt]
        tp = len(t & q)
        fp = len(q - t)
        fn = len(t - q)
        p, r, f1 = _f1(fp, tp, fn, tp)
        out[vt] = MetricsRow(vt, fp, fn, tp, tp, p, r, f1)
    return out


def parse_happy_vcf(happy_vcf_fn: str, ctg_name: Optional[str] = None) -> Dict[str, MetricsRow]:
    """Digest a hap.py output VCF into SNP/INDEL P/R/F1 rows
    (GetOverallMetrics.py:26-140 semantics: TRUTH/QUERY sample columns with
    BD (TP/FP/FN) and BVT (SNP/INDEL) fields)."""
    counts = {vt: {"query_fp": 0, "query_tp": 0, "truth_fn": 0, "truth_tp": 0}
              for vt in ("SNP", "INDEL", "INS", "DEL")}
    fmt_idx: Dict[str, int] = {}
    for rec in VcfReader(happy_vcf_fn):
        if ctg_name and rec.chrom != ctg_name:
            continue
        fmt = rec.format.split(":")
        if "BD" not in fmt or "BVT" not in fmt:
            continue
        bd_i, bvt_i = fmt.index("BD"), fmt.index("BVT")
        bi_i = fmt.index("BI") if "BI" in fmt else None
        # sample column layout: TRUTH then QUERY; VcfRecord stores one sample
        # string per column joined by tabs in `sample` when parsed raw; the
        # hap.py VCF has 2 samples, so re-split the raw trailing columns.
        samples = rec.sample.split("\t") if "\t" in rec.sample else [rec.sample]
        if len(samples) < 2:
            continue
        truth_f = samples[0].split(":")
        query_f = samples[1].split(":")
        t_bd = truth_f[bd_i] if bd_i < len(truth_f) else "."
        q_bd = query_f[bd_i] if bd_i < len(query_f) else "."
        t_bvt = truth_f[bvt_i] if bvt_i < len(truth_f) else "."
        q_bvt = query_f[bvt_i] if bvt_i < len(query_f) else "."
        # INDELs additionally split into INS/DEL by the BI sub-type prefix
        # (GetOverallMetrics.py:105-124)
        def _kinds(bvt, bi):
            kinds = [bvt] if bvt in counts else []
            if bvt == "INDEL" and bi:
                if bi.startswith("i"):
                    kinds.append("INS")
                elif bi.startswith("d"):
                    kinds.append("DEL")
            return kinds

        q_bi = query_f[bi_i] if bi_i is not None and bi_i < len(query_f) else ""
        t_bi = truth_f[bi_i] if bi_i is not None and bi_i < len(truth_f) else ""
        for kind in _kinds(q_bvt, q_bi):
            if q_bd == "FP":
                counts[kind]["query_fp"] += 1
            elif q_bd == "TP":
                counts[kind]["query_tp"] += 1
        for kind in _kinds(t_bvt, t_bi):
            if t_bd == "FN":
                counts[kind]["truth_fn"] += 1
            elif t_bd == "TP":
                counts[kind]["truth_tp"] += 1
    out = {}
    for vt, c in counts.items():
        p, r, f1 = _f1(c["query_fp"], c["query_tp"], c["truth_fn"], c["truth_tp"])
        out[vt] = MetricsRow(vt, c["query_fp"], c["truth_fn"], c["truth_tp"],
                             c["query_tp"], p, r, f1)
    return out


# ---------------------------------------------------------------------------
# paired-end allele depth (AddPairEndAlleleDepth.py)
# ---------------------------------------------------------------------------

PEAD_HEADER_LINE = (
    '##FORMAT=<ID=PEAD,Number=1,Type=Integer,Description="Allelic depths for '
    'the alt alleles after removing same pair-end reads in the order listed">'
)


def _alt_support_read_names(bam_fn: str, chrom: str, pos1: int, ref: str,
                            alt: str, min_mq: int = 5) -> Set[str]:
    """Read names supporting the (first) alt allele at a site: SNP base
    match, insertion with the exact inserted sequence, or deletion of the
    exact length — mirroring the mpileup-based reference classification."""
    from clair3_tpu_torch.io.bam import BamReader

    pos0 = pos1 - 1
    names: Set[str] = set()
    bam = BamReader(bam_fn)
    for read in bam.fetch(chrom, pos0, pos0 + 1, min_mq=min_mq):
        rpos, qpos = read.pos, 0
        base = None
        ins_seq = ""
        del_len = 0
        for i, (op, ln) in enumerate(read.cigar):
            if op in (0, 7, 8):
                if rpos <= pos0 < rpos + ln:
                    base = read.seq[qpos + (pos0 - rpos)]
                    # indel immediately following this base?
                    if pos0 == rpos + ln - 1 and i + 1 < len(read.cigar):
                        nop, nln = read.cigar[i + 1]
                        if nop == 1:
                            ins_seq = read.seq[qpos + ln: qpos + ln + nln]
                        elif nop == 2:
                            del_len = nln
                rpos += ln
                qpos += ln
            elif op == 1:
                qpos += ln
            elif op in (2, 3):
                rpos += ln
            elif op == 4:
                qpos += ln
        if base is None:
            continue
        if len(ref) == 1 and len(alt) == 1:
            if base.upper() == alt and not ins_seq and not del_len:
                names.add(read.qname)
        elif len(ref) == 1 and len(alt) > 1:
            if base.upper() == alt[0] and ins_seq.upper() == alt[1:]:
                names.add(read.qname)
        elif len(ref) > 1 and len(alt) == 1:
            if base.upper() == ref[0] and del_len == len(ref) - 1:
                names.add(read.qname)
    return names


def add_pairend_allele_depth(
    bam_fn: str, rows: Sequence[str], min_mq: int = 5
) -> List[str]:
    """Append the PEAD FORMAT tag (unique-fragment alt support) to variant
    rows; ref-call rows pass through."""
    out: List[str] = []
    for row in rows:
        if row.startswith("#"):
            out.append(row)
            continue
        rec = parse_vcf_line(row)
        if rec.alt == "." or rec.ref == rec.alt:
            out.append(row)
            continue
        alt0 = rec.alt.split(",")[0]
        names = _alt_support_read_names(bam_fn, rec.chrom, rec.pos, rec.ref,
                                        alt0, min_mq=min_mq)
        cols = row.rstrip("\n").split("\t")
        cols[8] += ":PEAD"
        cols[9] += f":{len(names)}"
        out.append("\t".join(cols) + "\n")
    return out
