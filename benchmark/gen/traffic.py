"""The benchmark's one traffic generator: a cell's parameter file and a
seed in, a sorted and indexed multi-contig BAM, its FASTA and the truth
VCF out.

Every seed gets the same work in another place: each contig of
``contig_bp`` holds exactly ``(contig_bp - 2 * margin_bp) // spacing_bp``
variants, one in each ``spacing_bp`` slot at a position drawn from the
seed (at least ``guard_bp`` from the slot's edges, so no two touch), and
the kinds come in equal thirds -- het SNP, het 2 bp insertion, hom 2 bp
deletion -- in an order drawn from the seed.  Reads follow the frozen
simulator: ``coverage`` layers of ``read_length`` reads, alternating
haplotypes and strands, substitutions at ``error_rate``, and with
``mv_tags`` the ONT move tables of the dwell channel.  Each contig is
simulated in its own process.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
import random
import struct
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from benchmark.gen.sim import SimVariant, random_reference, simulate_reads
from benchmark.reference.frozen.io.bai import write_bai
from benchmark.reference.frozen.io.bam import _encode_record
from benchmark.reference.frozen.io.bgzf import BgzfWriter
from benchmark.reference.frozen.io.fasta import write_fasta

TRAFFIC_KEYS = ("platform", "contigs", "contig_bp", "coverage", "read_length",
                "error_rate", "mv_tags", "spacing_bp", "margin_bp", "guard_bp")


@dataclass
class Input:
    bam: str
    fasta: str
    truth_vcf: str
    contigs: List[Tuple[str, int]]
    truth: Dict[str, List[SimVariant]]

    @property
    def bp(self) -> int:
        return sum(n for _, n in self.contigs)


def derive(seed: int, *parts) -> int:
    """A 60-bit seed from ``seed`` and ``parts`` (any size of ``seed``)."""
    key = "/".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 4


def draw_variants(ref: str, traffic: dict, seed: int) -> List[SimVariant]:
    rng = random.Random(seed)
    margin, spacing, guard = (traffic["margin_bp"], traffic["spacing_bp"],
                              traffic["guard_bp"])
    n = (len(ref) - 2 * margin) // spacing
    kinds = [k % 3 for k in range(n)]
    rng.shuffle(kinds)
    out = []
    for k, kind in enumerate(kinds):
        p = margin + k * spacing + guard + rng.randrange(spacing - 2 * guard)
        if kind == 0:
            alt = rng.choice([b for b in "ACGT" if b != ref[p]])
            out.append(SimVariant(p, ref[p], alt, (0, 1)))
        elif kind == 1:
            ins = "".join(rng.choice("ACGT") for _ in range(2))
            out.append(SimVariant(p, ref[p], ref[p] + ins, (0, 1)))
        else:
            out.append(SimVariant(p, ref[p:p + 3], ref[p], (1, 1)))
    return out


def _contig(args) -> Tuple[str, List[SimVariant], bytes]:
    """One contig: its sequence, its variants and its reads as BAM records."""
    tid, name, seed, traffic = args
    L = traffic["contig_bp"]
    ref = random_reference(L, seed=derive(seed, name, "ref"))
    variants = draw_variants(ref, traffic, derive(seed, name, "variants"))
    reads = simulate_reads(
        ref, variants, coverage=traffic["coverage"],
        read_length=traffic["read_length"], seed=derive(seed, name, "reads"),
        error_rate=traffic["error_rate"], contig=name,
        with_mv_tags=traffic["mv_tags"])
    for r in reads:
        r.tid = tid
    return ref, variants, b"".join(_encode_record(r) for r in reads)


def write_truth(path: str, contigs: Sequence[Tuple[str, int]],
                truth: Dict[str, List[SimVariant]]) -> None:
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        for name, length in contigs:
            fh.write(f"##contig=<ID={name},length={length}>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
        for name, _ in contigs:
            for v in truth[name]:
                gt = "/".join(map(str, v.genotype))
                fh.write(f"{name}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t50\tPASS\t.\tGT\t{gt}\n")


def make_input(traffic: dict, seed: int, out_dir: str) -> Input:
    """Simulate the cell's input under ``out_dir``, one process per contig."""
    missing = [k for k in TRAFFIC_KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic lacks {missing}")
    os.makedirs(out_dir, exist_ok=True)
    names = [f"chr{i + 1}" for i in range(traffic["contigs"])]
    L = traffic["contig_bp"]
    jobs = [(tid, name, seed, traffic) for tid, name in enumerate(names)]
    with ProcessPoolExecutor(max_workers=len(jobs),
                             mp_context=mp.get_context("spawn")) as pool:
        done = list(pool.map(_contig, jobs))
    contigs = [(name, L) for name in names]
    fasta = os.path.join(out_dir, "ref.fa")
    write_fasta(fasta, {name: ref for name, (ref, _, _) in zip(names, done)})
    bam = os.path.join(out_dir, "reads.bam")
    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{L}\n" for n in names)
    with BgzfWriter(bam) as out:
        text = header.encode()
        out.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        out.write(struct.pack("<i", len(names)))
        for name in names:
            nb = name.encode() + b"\x00"
            out.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", L))
        for _, _, records in done:
            out.write(records)
    write_bai(bam)
    truth = {name: variants for name, (_, variants, _) in zip(names, done)}
    truth_vcf = os.path.join(out_dir, "truth.vcf")
    write_truth(truth_vcf, contigs, truth)
    return Input(bam, fasta, truth_vcf, contigs, truth)
