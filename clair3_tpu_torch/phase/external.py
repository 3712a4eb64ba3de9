"""External-phaser interop (whatshap / longphase subprocess hook).

The reference treats the intermediate phasing stage as a pluggable
subprocess: ``whatshap phase --distrust-genotypes --ignore-read-groups``
(clair3_c_impl_pipeline.py:427-439) or ``longphase phase -s .. -b .. -r ..
--ont|--pb`` (clair3_c_impl_pipeline.py:405-424), selected with
``--use_whatshap_for_intermediate_phasing`` /
``--use_longphase_for_intermediate_phasing`` (run_clair3.py:148-150).

clair3_tpu_torch phases internally by default (``phase.ReadBackedPhaser``), but
this module preserves the interop contract: when the user points us at a
whatshap or longphase binary we write the per-contig het-SNP VCF
(``phase_vcf/{ctg}.vcf``, the SelectHetSnp output contract), invoke the
external tool with the reference's exact flag set, and parse the phased
``GT``/``PS`` back into the ``GT:PS`` records the full-alignment extractor
consumes (CreateTensorFullAlignmentFromCffi.py:81-107).

``ExternalPhaser`` is interface-compatible with ``ReadBackedPhaser``:
``phase(ctg_name, het_snps) -> List[VcfRecord]``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence

from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord, VcfWriter


class ExternalPhaserError(RuntimeError):
    pass


def _minimal_phase_header(sample: str, ctg_name: str, ctg_len: int) -> str:
    """Header for the het-SNP VCF handed to the external tool.

    Mirrors what SelectHetSnp writes (a full get_header minus PL); external
    tools only need fileformat, contig, and the FORMAT/GT declaration.
    """
    return "\n".join([
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=PASS,Description="All filters passed">',
        f"##contig=<ID={ctg_name},length={ctg_len}>",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample,
    ])


def parse_phased_vcf(path: str) -> List[VcfRecord]:
    """Extract phased het SNPs (``x|y`` GT + PS) from an external tool's
    output VCF into the ``GT:PS`` records the pipeline propagates.

    Unphased rows (``/`` genotypes or missing PS) are dropped — the
    reference's FA extractor likewise only receives rows whose final FORMAT
    field carries a phase set (CreateTensorFullAlignmentFromCffi.py:95-107).
    """
    out: List[VcfRecord] = []
    for rec in VcfReader(path):
        fmt_keys = rec.format.split(":")
        sample_vals = rec.sample.split(":")
        fields = dict(zip(fmt_keys, sample_vals))
        gt = fields.get("GT", "")
        if "|" not in gt:
            continue
        ps = fields.get("PS")
        if ps is None or ps == ".":
            continue
        a, b = gt.split("|")[:2]
        if a == b:  # hom rows can't inform haplotagging
            continue
        out.append(VcfRecord(
            rec.chrom, rec.pos, rec.ref, rec.alt, rec.qual, rec.filter,
            rec.info, "GT:PS", f"{gt}:{ps}", id=rec.id,
        ))
    return out


class ExternalPhaser:
    """Phase per-contig het SNPs through a whatshap or longphase subprocess.

    Parameters
    ----------
    tool:      "whatshap" or "longphase" (reference run_clair3.py:116-117).
    binary:    executable path/name; defaults to the tool name.
    platform:  "ont"/"hifi"/"ilmn" — longphase takes ``--ont`` or ``--pb``
               (clair3_c_impl_pipeline.py:238).
    work_dir:  where ``phase_vcf/`` intermediates live (kept for
               debuggability, like the reference's tmp tree); a temp dir
               when omitted.
    """

    def __init__(
        self,
        tool: str,
        bam_fn: str,
        ref_fn: str,
        platform: str = "ont",
        binary: Optional[str] = None,
        threads: int = 1,
        work_dir: Optional[str] = None,
        sample: str = "SAMPLE",
    ):
        if tool not in ("whatshap", "longphase"):
            raise ExternalPhaserError(f"unknown external phaser: {tool!r}")
        self.tool = tool
        self.bam_fn = bam_fn
        self.ref_fn = ref_fn
        self.platform = platform
        # "EMPTY" is the reference's not-provided sentinel (run_clair3.py:117)
        self.binary = tool if binary in (None, "", "EMPTY") else binary
        self.threads = max(1, int(threads))
        self.sample = sample
        if work_dir is None:
            work_dir = tempfile.mkdtemp(prefix="clair3t_phase_")
        self.phase_vcf_dir = os.path.join(work_dir, "phase_vcf")
        os.makedirs(self.phase_vcf_dir, exist_ok=True)
        resolved = shutil.which(self.binary)
        if resolved is None:
            raise ExternalPhaserError(
                f"external phaser binary not found: {self.binary!r} "
                f"(pass --{tool} with a valid path, or drop "
                f"--use_{tool}_for_intermediate_phasing to use the internal "
                "phaser)")
        self.binary = resolved

    # -- interface-compatible with ReadBackedPhaser ----------------------
    def phase(self, ctg_name: str, het_snps: Sequence[VcfRecord]) -> List[VcfRecord]:
        snps = sorted(
            (r for r in het_snps if len(r.ref) == 1 and len(r.alt) == 1),
            key=lambda r: r.pos,
        )
        if not snps:
            return []
        in_vcf = os.path.join(self.phase_vcf_dir, f"{ctg_name}.vcf")
        ctg_len = snps[-1].pos + 1_000_000  # header-only bound; tools ignore it
        header = _minimal_phase_header(self.sample, ctg_name, ctg_len)
        with VcfWriter(in_vcf, header) as w:
            for rec in snps:
                # strip everything but GT:GQ, like SelectHetSnp.py:60-66
                gq = "20"
                fmt_keys = rec.format.split(":")
                vals = rec.sample.split(":")
                if "GQ" in fmt_keys:
                    gq = vals[fmt_keys.index("GQ")]
                w.write(VcfRecord(
                    rec.chrom, rec.pos, rec.ref, rec.alt, rec.qual,
                    rec.filter, rec.info, "GT:GQ", f"0/1:{gq}", id=rec.id))

        if self.tool == "whatshap":
            out_vcf = os.path.join(self.phase_vcf_dir, f"phased_{ctg_name}.vcf.gz")
            cmd = [
                self.binary, "phase",
                "--output", out_vcf,
                "--reference", self.ref_fn,
                "--chromosome", ctg_name,
                "--distrust-genotypes",
                "--ignore-read-groups",
                in_vcf,
                self.bam_fn,
            ]
        else:
            lp_platform = "ont" if self.platform == "ont" else "pb"
            out_prefix = os.path.join(self.phase_vcf_dir, f"phased_{ctg_name}")
            out_vcf = out_prefix + ".vcf"
            cmd = [
                self.binary, "phase",
                "-s", in_vcf,
                "-b", self.bam_fn,
                "-r", self.ref_fn,
                "-t", str(self.threads),
                "-o", out_prefix,
                "--" + lp_platform,
            ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ExternalPhaserError(
                f"{self.tool} phase failed (rc={proc.returncode}) on "
                f"{ctg_name}: {proc.stderr.strip()[-2000:]}")
        if not os.path.exists(out_vcf):
            raise ExternalPhaserError(
                f"{self.tool} produced no output VCF at {out_vcf}")
        return parse_phased_vcf(out_vcf)
