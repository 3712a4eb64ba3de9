"""The comparison that decides ``correct``: the plain reference against what
the last pass of the measured window produced.

The reference is the frozen pure-Python host side (``frozen/``: candidate
extraction, QUAL-quantile routing, read-backed phasing, full-alignment
extraction with haplotagging, decode, merge) and the float32 nets of
``nets.py`` with TF32 off.  It imports nothing of the program and takes no
weights, scales or tables from it: it reads the checkpoint files and the
simulated BAM and FASTA itself.

What the port produced, stage by stage, and what each is held to:

``pileup_tensors_differ``
    the port's pileup batches (as its engine received them) against the
    reference's own extraction of every contig, row by row: exact.
``pileup_logp_gap``
    the port's pileup probabilities against the reference net on the
    reference's tensors: the widest absolute gap of their logarithms (which
    follow the logits: each head is a softmax) over every class of every
    candidate.
``pileup_rows_differ``
    the port's ``pileup.vcf.gz`` rows against the reference decoder run
    on the port's probabilities: exact.
``final_rows_differ``
    ``merge_output.vcf.gz`` against the reference's merge (or, with
    ``--pileup_only``, its final filter) of the port's pileup and
    full-alignment rows: exact.
``phasing_differ``
    the het SNPs the port's phaser was handed and what it returned,
    against the reference's selection from the port's pileup rows and the
    reference phaser on them: exact.
``fa_routing_differ``
    the rows of each full-alignment batch the port ran against the
    reference's routing of the port's pileup rows: exact.
``fa_tensors_differ``
    a sample of the port's full-alignment rows, drawn from the seed,
    against the reference's extraction of those candidates: exact.
``fa_logp_gap``
    the port's full-alignment probabilities of the sample against the
    reference net on the reference's tensors: the widest absolute gap of
    their logarithms.
``fa_rows_differ``
    the port's ``full_alignment.vcf.gz`` rows of the sample against the
    reference decoder on the port's probabilities: exact.

Stages that decode, route or merge start from the port's own outputs of
the stage before (probabilities, pileup rows), which the stage before is
itself held to; the numbers therefore single out the stage at fault.
"""

from __future__ import annotations

import dataclasses
import gzip
import multiprocessing as mp
import os
import random
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.frozen import select as fselect
from benchmark.reference.frozen.config import CallConfig
from benchmark.reference.frozen.decoder import DecodeConfig, batch_decode
from benchmark.reference.frozen.fa_extractor import create_fa_tensors
from benchmark.reference.frozen.io.vcf import parse_vcf_line
from benchmark.reference.frozen.merge_sort import (mark_low_qual,
                                                   merge_pileup_and_full_alignment,
                                                   sort_rows)
from benchmark.reference.frozen.phaser import ReadBackedPhaser
from benchmark.reference.frozen.pileup_extractor import create_pileup_tensors

EXACT = ("pileup_tensors_differ", "pileup_rows_differ", "final_rows_differ",
         "phasing_differ", "fa_routing_differ", "fa_tensors_differ", "fa_rows_differ")
FA_SAMPLE = 1024       # full-alignment rows re-extracted per run
PIECE_BP = 32_000      # pileup extraction split, for the worker pool
LOGP_FLOOR = 69.0      # log-probabilities below -69 (p < 1e-30) count as -69


@dataclasses.dataclass
class PortPass:
    """What one pass of the port produced, as the harness recorded it."""

    out_dir: str
    pileup_inputs: List[np.ndarray]
    pileup_probs: List[np.ndarray]
    fa_inputs: List[np.ndarray]
    fa_probs: List[np.ndarray]
    phase_calls: List[Tuple[str, list, list]]  # (contig, het SNPs, phased)


def call_config(flags: Sequence[str], bam: str, fasta: str) -> CallConfig:
    """The frozen ``CallConfig`` of a cell's ``call`` flags: ``--name
    value`` for a valued field, ``--name`` for a switch."""
    fields = {f.name: f for f in dataclasses.fields(CallConfig)}
    kw = {"bam_fn": bam, "ref_fn": fasta}
    i = 0
    while i < len(flags):
        name = flags[i][2:]
        if name not in fields:
            raise ValueError(f"flag {flags[i]} is not a CallConfig field")
        default = fields[name].default
        if isinstance(default, bool):
            kw[name] = True
            i += 1
            continue
        raw = flags[i + 1]
        typ = fields[name].type
        if "float" in str(typ) or isinstance(default, float):
            kw[name] = float(raw)
        elif "int" in str(typ) or isinstance(default, int):
            kw[name] = int(raw)
        else:
            kw[name] = raw
        i += 2
    return CallConfig(**kw).resolved()


def rescale_high_coverage_pileup(tensors: np.ndarray, alt_infos: Sequence[str],
                                 max_depth: int = 144) -> np.ndarray:
    """Integer-truncated rescale of extreme-coverage pileup tensors
    (Clair3 CallVariantsFromCffi.py:278-285)."""
    for i, alt_info in enumerate(alt_infos):
        depth = int(str(alt_info).split("-", maxsplit=1)[0])
        if depth > 0 and depth > max_depth * 1.5:
            scale = depth / max_depth
            tensors[i] = (tensors[i] / scale).astype(tensors.dtype)
    return tensors


def pileup_decode_config(cfg: CallConfig) -> DecodeConfig:
    return DecodeConfig(add_indel_length=False, pileup=True, show_ref_calls=True,
                        gvcf=cfg.gvcf, enable_long_indel=cfg.enable_long_indel,
                        maximum_variant_length_that_need_infer=cfg.max_indel_length,
                        keep_iupac_bases=cfg.keep_iupac_bases)


def fa_decode_config(cfg: CallConfig) -> DecodeConfig:
    return DecodeConfig(add_indel_length=True, pileup=False, show_ref_calls=True,
                        gvcf=cfg.gvcf, enable_long_indel=cfg.enable_long_indel,
                        maximum_variant_length_that_need_infer=cfg.max_indel_length,
                        keep_iupac_bases=cfg.keep_iupac_bases)


# --------------------------------------------------------------------------
# worker tasks (module level: they run in spawned processes)

def _pileup_piece(args):
    cfg, contig, start, end = args
    tensors, pos_infos, alt_infos, _ = create_pileup_tensors(
        cfg.bam_fn, cfg.ref_fn, contig, start, end, min_mq=cfg.min_mq,
        min_depth=cfg.min_coverage, min_snp_af=cfg.snp_min_af,
        min_indel_af=cfg.indel_min_af, max_indel_length=cfg.max_indel_length,
        call_snp_only=cfg.call_snp_only, gvcf=cfg.gvcf,
        head_tail=cfg.enable_variant_calling_at_sequence_head_and_tail)
    keep = [i for i, p in enumerate(pos_infos)
            if start <= int(p.split(":")[-2]) <= end]
    return tensors[keep], [pos_infos[i] for i in keep], [alt_infos[i] for i in keep]


def _phase(args):
    bam, min_mq, contig, het_snps = args
    return ReadBackedPhaser(bam, min_mq=min_mq).phase(contig, het_snps)


def _fa_extract(args):
    cfg, contig, positions, phased_snps = args
    return create_fa_tensors(
        cfg.bam_fn, cfg.ref_fn, contig, positions, phased_snps=phased_snps,
        matrix_depth=cfg.matrix_depth, min_mq=cfg.min_mq,
        no_phasing=cfg.no_phasing_for_fa, enable_dwell=cfg.enable_dwell_time)


def _decode(args):
    pos_infos, alt_infos, probs, dcfg = args
    return batch_decode(pos_infos, alt_infos, probs, dcfg)


# --------------------------------------------------------------------------

def read_rows(path: str) -> List[str]:
    """Body rows of a (b)gzipped VCF, without their newlines."""
    if not os.path.exists(path):
        return []
    with gzip.open(path, "rt") as fh:
        return [line.rstrip("\n") for line in fh if not line.startswith("#")]


def _multiset_diff(a: Sequence, b: Sequence) -> int:
    from collections import Counter

    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def _rows_differ(want: Sequence[str], got: Sequence[str]) -> float:
    """Rows in one list and not the other, plus one when the same rows
    come in another order."""
    n = _multiset_diff(want, got)
    return float(n + (n == 0 and list(want) != list(got)))


def _records(recs) -> List[tuple]:
    return [(r.chrom, r.pos, r.ref, r.alt, r.sample) for r in recs]


def _final_filter(rows: Sequence[str], cfg: CallConfig) -> List[str]:
    """The caller's postfilter of ``--pileup_only`` rows (Clair3
    SortVcf.py:93-112): variant rows are marked LowQual under ``--qual``,
    reference rows are kept only with ``--print_ref_calls``."""
    out = []
    for row in rows:
        cols = row.split("\t")
        if cols[4] == "." or cols[3] == cols[4]:
            if cfg.print_ref_calls:
                out.append(row)
            continue
        out.append(mark_low_qual(row, cfg.qual).rstrip("\n"))
    return out


def _decode_all(pool, pos_infos, alt_infos, probs, dcfg, block=2048) -> List[str]:
    jobs = [(pos_infos[lo: lo + block], alt_infos[lo: lo + block],
             probs[lo: lo + block], dcfg) for lo in range(0, len(pos_infos), block)]
    rows: List[str] = []
    for part in pool.map(_decode, jobs):
        rows.extend(part)
    return rows


def _logp(p: np.ndarray) -> np.ndarray:
    return np.log(np.maximum(p, np.exp(-LOGP_FLOOR)))


def logp_gap(port_p: np.ndarray, ref_p: np.ndarray) -> float:
    """The widest absolute gap between the two sides' log-probabilities."""
    return float(np.abs(_logp(port_p) - _logp(ref_p)).max())


def gap_stats(port_p: np.ndarray, ref_p: np.ndarray) -> Dict[str, float]:
    """How far the port's probabilities lie from the reference's: the
    widest absolute gap, and the widest and the median (over rows) gap of
    the log-probabilities, which follow the logits."""
    d = np.abs(_logp(port_p) - _logp(ref_p))
    return {"prob_max": float(np.abs(port_p - ref_p).max()),
            "logp_max": float(d.max()),
            "logp_row_p99": float(np.quantile(d.max(axis=1), 0.99)),
            "logp_row_median": float(np.median(d.max(axis=1)))}


def compare(port: PortPass, flags: Sequence[str], bam: str, fasta: str,
            contigs: Sequence[Tuple[str, int]], pileup_net, fa_net,
            seed: int, workers: int, diag: Optional[Dict] = None) -> Dict[str, float]:
    """The numbers of the comparison (see the module docstring);
    ``diag`` gathers further readings of the two nets' gaps."""
    from benchmark.reference.nets import run_blocks

    cfg = call_config(flags, bam, fasta)
    names = [c for c, _ in contigs]
    out: Dict[str, float] = {}
    port_pileup_rows = read_rows(os.path.join(port.out_dir, "pileup.vcf.gz"))
    port_final_rows = read_rows(os.path.join(port.out_dir, "merge_output.vcf.gz"))
    port_fa_rows = read_rows(os.path.join(port.out_dir, "full_alignment.vcf.gz"))
    ctx = mp.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        # phasing starts from the port's pileup rows, beside the extraction
        stats = fselect.collect_pileup_stats([r + "\n" for r in port_pileup_rows])
        phasing = not (cfg.pileup_only or cfg.no_phasing_for_fa)
        het = {}
        phase_futs = {}
        if phasing:
            phase_qual = fselect.select_phase_qual_from_stats(stats, cfg.var_pct_phasing)
            for ctg in names:
                het[ctg] = fselect.select_het_snps_from_stats(
                    port_pileup_rows, stats, phase_qual, ctg)
                phase_futs[ctg] = pool.submit(
                    _phase, (bam, max(cfg.min_mq, 20), ctg, het[ctg]))

        # pileup: every candidate of every contig
        pieces = [(cfg, ctg, s + 1, min(L, s + PIECE_BP))
                  for ctg, L in contigs for s in range(0, L, PIECE_BP)]
        tensors, pos_infos, alt_infos = [], [], []
        for t, p, a in pool.map(_pileup_piece, pieces):
            tensors.append(t)
            pos_infos += p
            alt_infos += a
        ref_x = rescale_high_coverage_pileup(
            np.concatenate(tensors), alt_infos, max_depth=cfg.preset.max_depth)
        port_x = (np.concatenate(port.pileup_inputs) if port.pileup_inputs
                  else np.zeros((0,) + ref_x.shape[1:], ref_x.dtype))
        if port_x.shape == ref_x.shape:
            same = (port_x == ref_x).reshape(len(ref_x), -1).all(axis=1)
            out["pileup_tensors_differ"] = float((~same).sum())
        else:
            out["pileup_tensors_differ"] = float(abs(len(port_x) - len(ref_x)) or len(ref_x))
        ref_p = run_blocks(pileup_net, ref_x)
        port_p = (np.concatenate(port.pileup_probs) if port.pileup_probs
                  else np.zeros((0, ref_p.shape[1]), np.float32))
        aligned = port_p.shape == ref_p.shape
        if diag is not None and aligned and len(ref_p):
            diag["pileup"] = gap_stats(port_p, ref_p)
        out["pileup_logp_gap"] = (logp_gap(port_p, ref_p) if aligned and len(ref_p)
                                  else (0.0 if aligned else LOGP_FLOOR))
        if aligned:
            ref_rows = sort_rows(_decode_all(pool, pos_infos, alt_infos, port_p,
                                             pileup_decode_config(cfg)), names)
            ref_rows = [r.rstrip("\n") for r in ref_rows]
            out["pileup_rows_differ"] = _rows_differ(ref_rows, port_pileup_rows)
        else:
            out["pileup_rows_differ"] = float(max(1, len(port_pileup_rows)))

        if cfg.pileup_only:
            want = _final_filter(port_pileup_rows, cfg)
            out["final_rows_differ"] = _rows_differ(want, port_final_rows)
            return out

        # routing, from the port's pileup rows
        var_qual, ref_qual = fselect.select_qual_from_stats(
            stats, cfg.var_pct_full, cfg.ref_pct_full)
        phased = {ctg: f.result() for ctg, f in phase_futs.items()}
        if phasing:
            port_het = {c: h for c, h, _ in port.phase_calls}
            port_phased = {c: p for c, _, p in port.phase_calls}
            diff = 0
            for ctg in names:
                diff += _multiset_diff(_records(het[ctg]), port_het.get(ctg, []))
                diff += _multiset_diff(_records(phased[ctg]), port_phased.get(ctg, []))
            out["phasing_differ"] = float(diff)
        batches = []
        for ctg in names:
            batches += fselect.select_candidates_from_stats(
                stats, ctg, var_qual, ref_qual, phased_rows=phased.get(ctg, ()),
                call_low_seq_entropy=cfg.call_low_seq_entropy,
                seq_entropy_pro=cfg.seq_entropy_pro, var_pct_full=cfg.var_pct_full)

        # full alignment: the port ran one batch per routed batch that has
        # rows; a batch whose row count is the routed count is sampled, one
        # that is not is extracted whole to count how far it is off
        routing_diff = 0
        matched = {}   # port batch index -> routed batch
        k = 0
        for b in batches:
            have = len(port.fa_inputs[k]) if k < len(port.fa_inputs) else -1
            if have == len(b.positions):
                matched[k] = b
                k += 1
                continue
            t, _, _ = pool.submit(_fa_extract, (cfg, b.contig, b.positions,
                                                b.phased_snps)).result()
            if len(t) == 0:
                continue  # the port skips a batch with no rows
            routing_diff += abs(have - len(t)) if have >= 0 else len(t)
            k += 1
        routing_diff += sum(len(x) for x in port.fa_inputs[k:])
        out["fa_routing_differ"] = float(routing_diff)

        rng = random.Random(seed)
        pool_rows = [(kk, i) for kk, b in matched.items() for i in range(len(b.positions))]
        pick = sorted(rng.sample(pool_rows, min(FA_SAMPLE, len(pool_rows))))
        by_batch: Dict[int, List[int]] = {}
        for kk, i in pick:
            by_batch.setdefault(kk, []).append(i)
        tasks, order = [], []
        for kk, rows in by_batch.items():
            b = matched[kk]
            for lo in range(0, len(rows), 64):
                part = rows[lo: lo + 64]
                tasks.append((cfg, b.contig, [b.positions[i] for i in part], b.phased_snps))
                order.append((kk, part))
        ref_t, ref_pi, ref_ai, port_t, port_fp = [], [], [], [], []
        tensors_diff = 0
        for (kk, part), (t, pi, ai) in zip(order, pool.map(_fa_extract, tasks)):
            if len(t) != len(part):
                tensors_diff += abs(len(t) - len(part)) or len(part)
                continue
            pt = port.fa_inputs[kk][part]
            tensors_diff += int((~(pt == t).reshape(len(t), -1).all(axis=1)).sum())
            ref_t.append(t)
            ref_pi += pi
            ref_ai += ai
            port_t.append(pt)
            port_fp.append(port.fa_probs[kk][part])
        out["fa_tensors_differ"] = float(tensors_diff)
        if ref_t:
            rp = run_blocks(fa_net, np.concatenate(ref_t))
            pp = np.concatenate(port_fp)
            out["fa_logp_gap"] = logp_gap(pp, rp)
            if diag is not None:
                diag["fa"] = gap_stats(pp, rp)
            decoded = _decode_all(pool, ref_pi, ref_ai, pp, fa_decode_config(cfg))
            want = {tuple(r.split("\t", 2)[:2]): r.rstrip("\n") for r in decoded}
            port_by_pos = {tuple(r.split("\t", 2)[:2]): r for r in port_fa_rows}
            keys = {tuple(p.split(":")[:2]) for p in ref_pi}
            out["fa_rows_differ"] = float(sum(want.get(key) != port_by_pos.get(key)
                                              for key in keys))
        else:
            out["fa_logp_gap"] = 0.0 if not pool_rows else LOGP_FLOOR
            out["fa_rows_differ"] = 0.0 if not pool_rows else float(len(pick))

    # the merge of the port's own pileup and full-alignment rows
    pileup_by, fa_by = {}, {}
    for r in port_pileup_rows:
        pileup_by.setdefault(r.split("\t", 1)[0], []).append(r + "\n")
    for r in port_fa_rows:
        fa_by.setdefault(r.split("\t", 1)[0], []).append(r + "\n")
    merged = []
    for ctg in names:
        merged += merge_pileup_and_full_alignment(
            pileup_by.get(ctg, []), fa_by.get(ctg, []), contig=ctg,
            qual_cutoff=cfg.qual, print_ref_calls=cfg.print_ref_calls,
            haploid_precise=cfg.haploid_precise, haploid_sensitive=cfg.haploid_sensitive)
    want = [r.rstrip("\n") for r in sort_rows(merged, names)]
    out["final_rows_differ"] = _rows_differ(want, port_final_rows)
    return out


def truth_f1(rows: Sequence[str], truth_vcf: str) -> Dict[str, float]:
    """SNP and INDEL F1 of PASS variant rows against the simulated truth,
    matching chromosome, position, alleles and genotype."""
    def key(rec):
        gt = rec.sample.split(":")[0].replace("|", "/")
        gt = "/".join(sorted(gt.split("/")))
        return rec.chrom, rec.pos, rec.ref, rec.alt, gt

    truth = [parse_vcf_line(l) for l in open(truth_vcf) if not l.startswith("#")]
    calls = [parse_vcf_line(r) for r in rows]
    calls = [c for c in calls if c.filter == "PASS" and c.alt not in (".", c.ref)]
    res = {}
    for kind, is_kind in (("snp", lambda r: r.is_snp), ("indel", lambda r: not r.is_snp)):
        t = {key(r) for r in truth if is_kind(r)}
        c = {key(r) for r in calls if is_kind(r)}
        tp = len(t & c)
        p = tp / len(c) if c else 0.0
        r = tp / len(t) if t else 0.0
        res[f"{kind}_f1"] = 2 * p * r / (p + r) if p + r else 0.0
    return res
