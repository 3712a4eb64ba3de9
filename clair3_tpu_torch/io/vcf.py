"""VCF/gVCF reading, writing, and the canonical header
(reference semantics: shared/utils.py:253-331 ``get_header``)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, TextIO, Tuple, Union

from clair3_tpu_torch import __version__
from clair3_tpu_torch.io.bgzf import BgzfWriter, decompress, is_gzipped

_HEADER_CORE = """\
##fileformat=VCFv4.2
##source=Clair3
##clair3_version={version}
##FILTER=<ID=PASS,Description="All filters passed">
##FILTER=<ID=LowQual,Description="Low quality variant">
##FILTER=<ID=RefCall,Description="Reference call">
##INFO=<ID=P,Number=0,Type=Flag,Description="Result from pileup calling">
##INFO=<ID=F,Number=0,Type=Flag,Description="Result from full-alignment calling">
"""

_HEADER_GVCF_EXTRA = """\
##ALT=<ID=NON_REF,Description="Represents any possible alternative allele at this location">
##INFO=<ID=END,Number=1,Type=Integer,Description="End position (for use with symbolic alleles)">
"""

_HEADER_FORMATS = """\
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth (reads 1. with MQ below 5 or an user-specified threshold, or 2. selected by 'samtools view -F 2316', are filtered)">
##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths for the ref and alt alleles in the order listed">
"""

_HEADER_GVCF_FORMATS = """\
##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum DP observed within the GVCF block">
"""

_HEADER_TAIL = """\
##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Normalized, Phred-scaled likelihoods for genotypes as defined in the VCF specification">
##FORMAT=<ID=AF,Number=A,Type=Float,Description="Observed allele frequency in reads, for each ALT allele, in the same order as listed, or the REF allele for a RefCall">
"""


def get_header(
    reference_file_path: Optional[str] = None,
    cmd_line: Optional[str] = None,
    sample_name: str = "SAMPLE",
    version: str = __version__,
    gvcf: bool = False,
    contigs: Optional[List[Tuple[str, int]]] = None,
) -> str:
    """Build the canonical VCF header string (no trailing newline on the
    #CHROM line, matching the reference)."""
    header = _HEADER_CORE.format(version=version)
    extra_lines = []
    if reference_file_path:
        extra_lines.append(f"##reference={reference_file_path}")
    if cmd_line:
        extra_lines.append(f"##cmdline={cmd_line}")
    if extra_lines:
        rows = header.rstrip("\n").split("\n")
        for line in reversed(extra_lines):
            rows.insert(3, line)
        header = "\n".join(rows) + "\n"
    if gvcf:
        header += _HEADER_GVCF_EXTRA
    header += _HEADER_FORMATS
    if gvcf:
        header += _HEADER_GVCF_FORMATS
    header += _HEADER_TAIL

    if contigs is None and reference_file_path:
        fai = reference_file_path + ".fai"
        if not os.path.exists(fai):
            alt = os.path.splitext(reference_file_path)[0] + ".fai"
            fai = alt if os.path.exists(alt) else fai
        contigs = []
        if os.path.exists(fai):
            with open(fai) as fh:
                for row in fh:
                    cols = row.strip().split("\t")
                    contigs.append((cols[0], int(cols[1])))
    for name, length in contigs or []:
        header += f"##contig=<ID={name},length={length}>\n"
    header += (
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s" % sample_name
    )
    return header


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 1-based
    ref: str
    alt: str
    qual: float
    filter: str
    info: str
    format: str
    sample: str
    id: str = "."

    @property
    def genotype(self) -> Tuple[int, int]:
        gt = self.sample.split(":")[0]
        sep = "|" if "|" in gt else "/"
        parts = gt.split(sep)
        try:
            g1 = int(parts[0])
        except ValueError:
            g1 = 0
        g2 = g1 if len(parts) < 2 else (int(parts[1]) if parts[1].isdigit() else 0)
        return g1, g2

    @property
    def is_phased(self) -> bool:
        return "|" in self.sample.split(":")[0]

    @property
    def is_snp(self) -> bool:
        return len(self.ref) == 1 and all(len(a) == 1 for a in self.alt.split(","))

    def to_line(self) -> str:
        qual = f"{self.qual:.2f}" if isinstance(self.qual, float) else str(self.qual)
        return "\t".join(
            (self.chrom, str(self.pos), self.id, self.ref, self.alt, qual,
             self.filter, self.info, self.format, self.sample)
        )


def parse_vcf_line(line: str) -> VcfRecord:
    cols = line.rstrip("\n").split("\t")
    qual: float
    try:
        qual = float(cols[5])
    except ValueError:
        qual = 0.0
    fmt = cols[8] if len(cols) > 8 else ""
    # multi-sample VCFs (e.g. hap.py TRUTH/QUERY) keep their extra sample
    # columns tab-joined in `sample`
    sample = "\t".join(cols[9:]) if len(cols) > 9 else ""
    return VcfRecord(cols[0], int(cols[1]), cols[3], cols[4], qual,
                     cols[6], cols[7], fmt, sample, id=cols[2])


class VcfReader:
    """Stream records from a .vcf or .vcf.gz (BGZF or plain gzip)."""

    def __init__(self, path: str):
        self.path = path
        if is_gzipped(path):
            self._text = decompress(path).decode()
        else:
            with open(path) as fh:
                self._text = fh.read()
        self.header_lines: List[str] = []
        self._body_start = 0
        pos = 0
        for line in self._text.splitlines(keepends=True):
            if line.startswith("#"):
                self.header_lines.append(line.rstrip("\n"))
                pos += len(line)
            else:
                break
        self._body_start = pos

    def __iter__(self) -> Iterator[VcfRecord]:
        for line in self._text[self._body_start:].splitlines():
            if not line or line.startswith("#"):
                continue
            yield parse_vcf_line(line)


class VcfWriter:
    """Write a VCF, BGZF-compressed when the path ends in .gz."""

    def __init__(self, path: str, header: str, threads: int = 1):
        self.path = path
        self._bgzf = path.endswith(".gz")
        if self._bgzf:
            self._fh: Union[BgzfWriter, TextIO] = BgzfWriter(path,
                                                             threads=threads)
        else:
            self._fh = open(path, "w")
        self._write_str(header.rstrip("\n") + "\n")

    def _write_str(self, s: str) -> None:
        if self._bgzf:
            self._fh.write(s.encode())
        else:
            self._fh.write(s)

    def write(self, line_or_record: Union[str, VcfRecord]) -> None:
        if isinstance(line_or_record, VcfRecord):
            self._write_str(line_or_record.to_line() + "\n")
        else:
            self._write_str(line_or_record.rstrip("\n") + "\n")

    def write_rows(self, rows, chunk: int = 8192) -> None:
        """Batched row writing: one join + encode per chunk instead of a
        Python call round-trip per row (matters at gVCF scale, ~10^6 rows).
        Accepts any iterable; generators stream without materializing."""
        if isinstance(rows, (list, tuple)):
            for i in range(0, len(rows), chunk):
                s = "\n".join(r.rstrip("\n") for r in rows[i:i + chunk])
                if s:
                    self._write_str(s + "\n")
            return
        from itertools import islice

        it = iter(rows)
        while True:
            part = list(islice(it, chunk))
            if not part:
                return
            s = "\n".join(r.rstrip("\n") for r in part)
            if s:
                self._write_str(s + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
