"""Final-output phasing and BAM haplotagging.

The reference optionally phases the merged VCF and haplotags the input BAM
as a last stage (whatshap/longphase + `whatshap haplotag`,
clair3_c_impl_pipeline.py:632-700).  Both are internal here: the read-backed
phaser phases the final het SNPs, and reads get HP/PS tags from the same
local-realignment haplotagger the FA extractor uses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from clair3_tpu_torch.io.vcf import VcfRecord, parse_vcf_line
from clair3_tpu_torch.phase.phaser import ReadBackedPhaser


def phase_final_rows(
    bam_fn: str, rows: Sequence[str], contigs: Sequence[str],
) -> List[str]:
    """Phase het SNP rows of the final VCF; returns rows with phased GT and
    a PS FORMAT field appended for phased sites."""
    phaser = ReadBackedPhaser(bam_fn)
    phased_by_key: Dict[Tuple[str, int], Tuple[str, str]] = {}
    records = [parse_vcf_line(r) for r in rows if not r.startswith("#")]
    for ctg in contigs:
        het_snps = [
            r for r in records
            if r.chrom == ctg and r.alt != "." and len(r.ref) == 1
            and len(r.alt) == 1 and r.genotype in ((0, 1), (1, 0))
        ]
        for rec in phaser.phase(ctg, het_snps):
            gt, ps = rec.sample.split(":")[0], rec.sample.split(":")[-1]
            phased_by_key[(rec.chrom, rec.pos)] = (gt, ps)

    out: List[str] = []
    for row in rows:
        if row.startswith("#"):
            out.append(row)
            continue
        cols = row.rstrip("\n").split("\t")
        key = (cols[0], int(cols[1]))
        if key in phased_by_key:
            gt, ps = phased_by_key[key]
            sample = cols[9].split(":")
            sample[0] = gt
            cols[8] += ":PS"
            cols[9] = ":".join(sample) + f":{ps}"
            out.append("\t".join(cols) + "\n")
        else:
            out.append(row)
    return out


def haplotag_bam(
    bam_fn: str,
    fasta_fn: str,
    phased_rows: Sequence[str],
    out_bam_fn: str,
    min_mq: int = 5,
) -> Tuple[str, int]:
    """Write a copy of the BAM with HP (1|2) and PS tags assigned from the
    phased het SNPs (whatshap-haplotag equivalent)."""
    from clair3_tpu_torch.fullalign.extractor import PhasedVariant, haplotag_read
    from clair3_tpu_torch.io.bam import BamReader, write_bam
    from clair3_tpu_torch.io.fasta import FastaFile

    variants_by_ctg: Dict[str, List[PhasedVariant]] = {}
    ps_by_ctg: Dict[str, Dict[int, int]] = {}
    for row in phased_rows:
        if row.startswith("#"):
            continue
        rec = parse_vcf_line(row)
        gt = rec.sample.split(":")[0]
        if "|" not in gt or len(rec.ref) != 1 or len(rec.alt) != 1:
            continue
        try:
            ps = int(rec.sample.split(":")[-1])
        except ValueError:
            ps = 0
        hap = 1 if gt == "0|1" else 2
        variants_by_ctg.setdefault(rec.chrom, []).append(
            PhasedVariant(rec.pos - 1, rec.ref, rec.alt, hap, ps))

    bam = BamReader(bam_fn)
    fa = FastaFile(fasta_fn)
    all_reads = []
    n_tagged = 0
    for tid, (name, length) in enumerate(zip(bam.references, bam.lengths)):
        variants = sorted(variants_by_ctg.get(name, []),
                          key=lambda v: v.position)
        ref_seq = fa.fetch(name, 0, length) if variants else ""
        for read in bam.fetch(name, 0, length, filter_flag=0, min_mq=0):
            if variants and read.mapq >= min_mq and not read.is_unmapped:
                hap = haplotag_read(read, variants, 0, ref_seq, 0)
                if hap:
                    read.tags["HP"] = hap
                    # PS of the first phased variant the read overlaps
                    for v in variants:
                        if read.pos <= v.position < read.reference_end:
                            read.tags["PS"] = v.phase_set
                            break
                    n_tagged += 1
            all_reads.append(read)
    fa.close()
    write_bam(out_bam_fn, bam.references, bam.lengths, all_reads)
    return out_bam_fn, n_tagged
