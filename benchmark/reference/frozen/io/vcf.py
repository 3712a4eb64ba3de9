"""VCF records and row parsing."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
