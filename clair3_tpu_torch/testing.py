"""Seeded inputs and weights for the port's tests and its chip check, and
the synthetic calling cases of the JAX package.

``random_variables``, ``random_counts``, ``bf16_ulps``, ``ArrayDataset``,
``TorchCpuEngine`` and ``load_trained_fixture`` are the port's own.  The read simulator (``SimVariant`` .. ``write_test_case``), the two
numpy oracle engines behind ``--use_oracle_engines``,
``trained_fixture_path`` and the VCF-row parity check
``vcf_rows_numerically_equivalent`` are copied from
``clair3_tpu/testing.py``, and
``PLATFORMS`` and ``simulate`` from ``scripts/full_cascade_demo.py``;
``tests/test_torch_copies.py`` holds each equal to its original.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from clair3_tpu_torch.io.bam import BamRead, write_bam
from clair3_tpu_torch.io.fasta import write_fasta
from clair3_tpu_torch.models.bridge import from_jax_variables, to_jax_variables
from clair3_tpu_torch.models.params_io import flatten_tree, unflatten_tree
from clair3_tpu_torch.train.data import BinDataset


def random_variables(net: nn.Module, seed: int) -> Dict:
    """A JAX-layout variable tree with ``net``'s shapes, drawn with numpy:
    weights ~ N(0, 1/fan_in) (lecun-normal scale), biases and BatchNorm
    shifts ~ N(0, 0.1), BatchNorm scales near 1 and variances in
    [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    flat = {}
    for key, v in flatten_tree(to_jax_variables(net.state_dict())).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "var":
            w = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "scale":
            w = 1.0 + 0.1 * rng.randn(*v.shape)
        elif v.ndim == 1:
            w = 0.1 * rng.randn(*v.shape)
        else:
            w = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        flat[key] = w.astype(np.float32)
    return unflatten_tree(flat)


def random_counts(seed: int, shape, low: int = -30, high: int = 30) -> np.ndarray:
    """Integer pileup-like counts in ``[low, high)``."""
    return np.random.RandomState(seed).randint(low, high, shape).astype(np.int32)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want|`` in units of the bf16 ulp of ``|want|``, with an
    absolute floor of 1e-5 for values near 0."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(want.abs())
    ulp = torch.clamp(torch.ldexp(torch.ones_like(want), e - 8), min=1e-5)
    return ((got - want).abs() / ulp).max().item()


class ArrayDataset(BinDataset):
    """``BinDataset`` over arrays held in memory, one per would-be bin: the
    same chunks, offsets, batches and split, without writing HDF5 (for a
    host without h5py)."""

    def __init__(self, tensors: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                 chunk_size: int = 250):
        self.paths = []
        self.chunk_size = chunk_size
        self._tensors, self._labels = list(tensors), list(labels)
        self.chunks = []
        for bin_idx, t in enumerate(self._tensors):
            n_chunks = len(t) // chunk_size or (1 if len(t) else 0)
            self.chunks.extend((bin_idx, c) for c in range(n_chunks))


class TorchCpuEngine:
    """f32 CPU twin of ``pipeline.engine.InferenceEngine``, the counterpart
    of ``clair3_tpu.testing.FlaxCpuEngine``: the port's plain net (kernels
    off) with the given JAX-layout variables, on the CPU at float32, with
    none of the production engine's machinery (no wire forms, no depth
    crop, no transfer thread).  Batches are zero-padded to FlaxCpuEngine's
    buckets (64, doubling up to ``max_batch``).  The differential oracle for
    the soak's parity slice: same trained nets, independent execution path.
    """

    def __init__(self, model: nn.Module, variables: Dict, max_batch: int = 2048):
        model.load_state_dict(from_jax_variables(variables), strict=True)
        model.compute_dtype = torch.float32
        for switch in ("use_kernel", "use_kernel_conv1"):
            if hasattr(model, switch):
                setattr(model, switch, False)
        self.model = model.to(torch.device("cpu"), torch.float32).eval()
        self.max_batch = max_batch

    def _bucket(self, n: int) -> int:
        b = 64
        while b < min(n, self.max_batch):
            b *= 2
        return b

    def predict(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, 24 if self.model.n_heads == 2 else 90), np.float32)
        outs = []
        with torch.inference_mode():
            for lo in range(0, n, self.max_batch):
                chunk = x[lo: lo + self.max_batch]
                b = self._bucket(chunk.shape[0])
                pad = b - chunk.shape[0] % b if chunk.shape[0] % b else 0
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                y = self.model(torch.from_numpy(np.ascontiguousarray(chunk))).numpy()
                outs.append(y[: y.shape[0] - pad] if pad else y)
        return np.concatenate(outs, axis=0)


BASES = "ACGT"

_FA_BASE_FROM_VAL = {100: "A", 25: "C", 75: "G", 50: "T"}


@dataclass(frozen=True)
class SimVariant:
    """A diploid variant at 0-based position ``pos`` (left-aligned)."""

    pos: int
    ref: str
    alt: str
    genotype: Tuple[int, int]  # e.g. (0,1) het, (1,1) hom

    @property
    def is_snp(self) -> bool:
        return len(self.ref) == 1 and len(self.alt) == 1


def random_reference(length: int, seed: int = 0) -> str:
    rng = random.Random(seed)
    return "".join(rng.choice(BASES) for _ in range(length))


def _read_from_reference(
    ref: str,
    start: int,
    end: int,
    variants_by_pos: Dict[int, SimVariant],
    hap: int,
    rng: random.Random,
    error_rate: float = 0.0,
) -> Tuple[str, List[Tuple[int, int]]]:
    """Build (seq, cigar) for a read spanning reference [start, end) on
    haplotype ``hap`` (0 or 1).  Variant alts are injected with exact CIGARs."""
    seq: List[str] = []
    cigar: List[Tuple[int, int]] = []

    def emit(op: int, length: int) -> None:
        if length == 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + length)
        else:
            cigar.append((op, length))

    i = start
    while i < end:
        var = variants_by_pos.get(i)
        apply_alt = var is not None and var.genotype[hap] == 1
        if not apply_alt:
            base = ref[i]
            if error_rate and rng.random() < error_rate:
                base = rng.choice([b for b in BASES if b != base])
            seq.append(base)
            emit(0, 1)  # M
            i += 1
            continue
        if var.is_snp:
            seq.append(var.alt)
            emit(0, 1)
            i += 1
        elif len(var.alt) > len(var.ref):  # insertion after anchor base
            seq.append(var.alt[0])
            emit(0, 1)
            ins = var.alt[1:]
            seq.append(ins)
            emit(1, len(ins))  # I
            i += 1
        else:  # deletion
            seq.append(var.alt[0])
            emit(0, 1)
            dlen = len(var.ref) - len(var.alt)
            emit(2, dlen)  # D
            i += 1 + dlen
    return "".join(seq), cigar


def simulate_reads(
    ref: str,
    variants: Sequence[SimVariant],
    coverage: int = 30,
    read_length: int = 500,
    seed: int = 0,
    error_rate: float = 0.0,
    mapq: int = 60,
    baseq: int = 30,
    contig: str = "chr1",
    with_hp_tags: bool = False,
    with_mv_tags: bool = False,
) -> List[BamRead]:
    """Tile reads across the reference at the requested coverage, alternating
    haplotypes and strands.  Returns coordinate-sorted BamReads."""
    rng = random.Random(seed)
    variants_by_pos = {v.pos: v for v in variants}
    reads: List[BamRead] = []
    n_per_layer = max(1, (len(ref) + read_length - 1) // read_length)
    idx = 0
    for layer in range(coverage):
        offset = int(read_length * layer / coverage) % read_length
        start = -offset if offset else 0
        while start < len(ref):
            s = max(0, start)
            e = min(len(ref), start + read_length)
            if e - s >= 50:
                hap = (layer + (1 if start < 0 else 0)) % 2
                seq, cigar = _read_from_reference(
                    ref, s, e, variants_by_pos, hap, rng, error_rate)
                flag = 0 if (idx % 2 == 0) else 16
                tags: Dict = {}
                if with_hp_tags:
                    tags["HP"] = hap + 1
                if with_mv_tags:
                    # per-base dwell of 1-3 signal blocks: "1" then k-1 zeros
                    mv = [5]
                    for k in range(len(seq)):
                        blocks = 1 + (s + k) % 3
                        mv.append(1)
                        mv.extend([0] * (blocks - 1))
                    tags["mv"] = np.array(mv, np.int8)
                reads.append(
                    BamRead(
                        qname=f"read_{idx}",
                        flag=flag,
                        tid=0,
                        pos=s,
                        mapq=mapq,
                        cigar=cigar,
                        seq=seq,
                        qual=np.full(len(seq), baseq, np.uint8),
                        tags=tags,
                    )
                )
                idx += 1
            start += read_length
    reads.sort(key=lambda r: r.pos)
    return reads


def write_test_case(
    dir_path: str,
    ref_length: int = 2000,
    variants: Optional[Sequence[SimVariant]] = None,
    coverage: int = 30,
    read_length: int = 500,
    seed: int = 0,
    error_rate: float = 0.0,
    contig: str = "chr1",
    with_hp_tags: bool = False,
    with_mv_tags: bool = False,
) -> Tuple[str, str, str, Sequence[SimVariant]]:
    """Materialise (fasta, bam) under dir_path; returns their paths + truth."""
    import os

    ref = random_reference(ref_length, seed)
    if variants is None:
        variants = []
    fasta_path = os.path.join(dir_path, "ref.fa")
    write_fasta(fasta_path, {contig: ref})
    reads = simulate_reads(
        ref, variants, coverage=coverage, read_length=read_length, seed=seed,
        error_rate=error_rate, contig=contig, with_hp_tags=with_hp_tags,
        with_mv_tags=with_mv_tags)
    bam_path = os.path.join(dir_path, "reads.bam")
    write_bam(bam_path, [contig], [ref_length], reads)
    return fasta_path, bam_path, ref, variants


class PileupOracleEngine:
    """Derives near-one-hot pileup head probabilities [N, 24] from the
    center column of each [33, 18] tensor."""

    def __init__(self, hom_threshold: float = 0.75, het_threshold: float = 0.25):
        self.hom = hom_threshold
        self.het = het_threshold

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Vectorized; bit-identical to ``predict_reference`` (asserted by
        tests/test_oracle_engines.py), ~50x faster on bench-scale batches."""
        from clair3_tpu_torch.task.labels import GT21, Genotype, gt21_enum_from_label

        n = x.shape[0]
        out = np.full((n, 24), 1e-4, np.float32)
        if n == 0:
            return out
        ar = np.arange(n)
        center = x[:, 16, :].astype(np.int64)                      # [N, 18]
        totals = center[:, 0:4] + center[:, 9:13]                  # [N, 4]
        ref_idx = np.argmin(totals, axis=1)                        # negated ref
        base_total = -totals[ar, ref_idx]
        masked = totals.copy()
        masked[ar, ref_idx] = np.iinfo(np.int64).min
        best_alt = np.argmax(masked, axis=1)  # first max among non-ref cols
        denom = np.maximum(base_total, 1)
        opts = np.stack([totals[ar, best_alt],
                         center[:, 4] + center[:, 13],
                         center[:, 6] + center[:, 15]], axis=1) / denom[:, None]
        kind = np.argmax(opts, axis=1)         # 0 snp, 1 ins, 2 del priority
        af = opts[ar, kind]
        is_ref = af < self.het
        hom = af >= self.hom
        conf = np.where(
            is_ref, 0.55 + 0.44 * np.minimum(1.0, 1.0 - af),
            0.55 + 0.44 * np.minimum(
                1.0, np.where(hom, af, 2 * np.minimum(af, 1 - af))))
        # gt21 lookup tables over (ref_idx, best_alt) base indices
        t_rr = np.array([gt21_enum_from_label(b + b) for b in BASES])
        t_pair = np.array([[gt21_enum_from_label("".join(sorted(r + a)))
                            for a in BASES] for r in BASES])
        t_ins = np.array([gt21_enum_from_label(b + "Ins") for b in BASES])
        t_del = np.array([gt21_enum_from_label(b + "Del") for b in BASES])
        gt21_snp = np.where(hom, t_rr[best_alt], t_pair[ref_idx, best_alt])
        gt21_ins = np.where(hom, int(GT21.InsIns), t_ins[ref_idx])
        gt21_del = np.where(hom, int(GT21.DelDel), t_del[ref_idx])
        gt21 = np.select([is_ref, kind == 0, kind == 1],
                         [t_rr[ref_idx], gt21_snp, gt21_ins], gt21_del)
        zyg = np.select(
            [is_ref, hom], [int(Genotype.homo_reference),
                            int(Genotype.homo_variant)],
            int(Genotype.hetero_variant))
        out[ar, gt21] = conf
        out[ar, 21 + zyg] = conf
        out[:, :21] /= out[:, :21].sum(axis=1, keepdims=True)
        out[:, 21:24] /= out[:, 21:24].sum(axis=1, keepdims=True)
        return out

    def predict_reference(self, x: np.ndarray) -> np.ndarray:
        """Original per-candidate loop: the readable spec of the oracle and
        the differential target for the vectorized ``predict``."""
        from clair3_tpu_torch.task.labels import GT21, Genotype, gt21_enum_from_label

        n = x.shape[0]
        out = np.full((n, 24), 1e-4, np.float32)
        for i in range(n):
            center = x[i, 16].astype(np.int64)
            fwd, rev = center[0:4], center[9:13]
            totals = fwd + rev
            ref_idx = int(np.argmin(totals))  # ref columns are negated
            base_total = -int(totals[ref_idx])
            alt_counts = {b: int(totals[b]) for b in range(4) if b != ref_idx}
            ins_count = int(center[4] + center[13])
            del_count = int(center[6] + center[15])
            denom = max(base_total, 1)

            best_alt = max(alt_counts, key=alt_counts.get)
            options = {
                "snp": alt_counts[best_alt] / denom,
                "ins": ins_count / denom,
                "del": del_count / denom,
            }
            kind = max(options, key=options.get)
            af = options[kind]
            ref_base = BASES[ref_idx]

            if af < self.het:
                gt21 = gt21_enum_from_label(ref_base + ref_base)
                zyg = Genotype.homo_reference
                conf = 0.55 + 0.44 * min(1.0, 1.0 - af)
            else:
                hom = af >= self.hom
                zyg = Genotype.homo_variant if hom else Genotype.hetero_variant
                # confidence scales with evidence so QUALs vary per candidate
                # (the pileup->FA routing cutoffs are quantiles over QUAL)
                conf = 0.55 + 0.44 * min(1.0, af if hom else 2 * min(af, 1 - af))
                if kind == "snp":
                    alt_base = BASES[best_alt]
                    pair = alt_base + alt_base if hom else "".join(sorted(ref_base + alt_base))
                    gt21 = gt21_enum_from_label(pair)
                elif kind == "ins":
                    gt21 = GT21.InsIns if hom else gt21_enum_from_label(ref_base + "Ins")
                else:
                    gt21 = GT21.DelDel if hom else gt21_enum_from_label(ref_base + "Del")

            out[i, gt21] = conf
            out[i, 21 + zyg] = conf
            out[i, :21] /= out[i, :21].sum()
            out[i, 21:24] /= out[i, 21:24].sum()
        return out


class FullAlignmentOracleEngine:
    """Derives [N, 90] probabilities from the center column of each
    [depth, 33, 8|9] full-alignment tensor."""

    def __init__(self, hom_threshold: float = 0.75, het_threshold: float = 0.25):
        self.hom = hom_threshold
        self.het = het_threshold

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Vectorized; bit-identical to ``predict_reference`` (asserted by
        tests/test_oracle_engines.py)."""
        from clair3_tpu_torch.task.labels import (
            GT21, Genotype, VariantLength, gt21_enum_from_label)

        n = x.shape[0]
        out = np.full((n, 90), 1e-4, np.float32)
        if n == 0:
            return out
        ar = np.arange(n)
        off = VariantLength.index_offset
        col_alt = x[:, :, 16, 1].astype(np.int64)                  # [N, D]
        col_ref = x[:, :, 16, 0].astype(np.int64)
        covered = col_ref != 0
        n_cov = np.maximum(covered.sum(axis=1), 1)
        snp_rows = covered & ~np.isin(col_alt, (0, -50, -100))
        ins_rows = col_alt == -50
        del_rows = col_alt == -100
        opts = np.stack([snp_rows.sum(axis=1), ins_rows.sum(axis=1),
                         del_rows.sum(axis=1)], axis=1) / n_cov[:, None]
        kind = np.argmax(opts, axis=1)         # 0 snp, 1 ins, 2 del priority
        af = opts[ar, kind]
        is_ref = af < self.het
        hom = af >= self.hom

        def base_idx_from_vals(vals):
            idx = np.zeros(len(vals), np.int64)   # default "A"
            for code, b in _FA_BASE_FROM_VAL.items():
                idx[vals == code] = BASES.index(b)
            return idx

        has_cov = covered.any(axis=1)
        ref_val = np.where(has_cov, col_ref[ar, np.argmax(covered, axis=1)], 0)
        ref_idx = base_idx_from_vals(ref_val)
        # per-row mode of the SNP alt codes; ties resolve to the smallest
        # value (np.unique sorts ascending, argmax takes the first max)
        counts = np.zeros((n, 256), np.int64)
        rr, cc = np.nonzero(snp_rows)
        np.add.at(counts, (rr, col_alt[rr, cc] + 128), 1)
        alt_idx = base_idx_from_vals(np.argmax(counts, axis=1) - 128)
        # indel lengths from the first ins/del row's overlay
        ins_row = np.argmax(ins_rows, axis=1)
        overlay = x[ar, ins_row, 16:, 6]                           # [N, 17]
        z = overlay == 0
        ins_len = np.where(z.any(axis=1), np.argmax(z, axis=1), z.shape[1])
        del_row = np.argmax(del_rows, axis=1)
        after = x[ar, del_row, 17:, 0]                             # [N, 16]
        nz = after != 0
        del_len = np.where(nz.any(axis=1), np.argmax(nz, axis=1), nz.shape[1])

        t_rr = np.array([gt21_enum_from_label(b + b) for b in BASES])
        t_pair = np.array([[gt21_enum_from_label("".join(sorted(r + a)))
                            for a in BASES] for r in BASES])
        t_ins = np.array([gt21_enum_from_label(b + "Ins") for b in BASES])
        t_del = np.array([gt21_enum_from_label(b + "Del") for b in BASES])
        gt21_snp = np.where(hom, t_rr[alt_idx], t_pair[ref_idx, alt_idx])
        gt21_ins = np.where(hom, int(GT21.InsIns), t_ins[ref_idx])
        gt21_del = np.where(hom, int(GT21.DelDel), t_del[ref_idx])
        gt21 = np.select([is_ref, kind == 0, kind == 1],
                         [t_rr[ref_idx], gt21_snp, gt21_ins], gt21_del)
        zyg = np.select(
            [is_ref, hom], [int(Genotype.homo_reference),
                            int(Genotype.homo_variant)],
            int(Genotype.hetero_variant))
        var = ~is_ref
        l2i = np.minimum(ins_len, VariantLength.max)
        l1d = -np.minimum(del_len, VariantLength.max)
        len1 = np.where(var & (kind == 1) & hom, l2i, 0) \
            + np.where(var & (kind == 2), l1d, 0)
        len2 = np.where(var & (kind == 1), l2i, 0) \
            + np.where(var & (kind == 2) & hom, l1d, 0)
        out[ar, gt21] = 1.0
        out[ar, 21 + zyg] = 1.0
        out[ar, 24 + len1 + off] = 1.0
        out[ar, 57 + len2 + off] = 1.0
        for s, e in ((0, 21), (21, 24), (24, 57), (57, 90)):
            out[:, s:e] /= out[:, s:e].sum(axis=1, keepdims=True)
        return out

    def predict_reference(self, x: np.ndarray) -> np.ndarray:
        """Original per-candidate loop: the readable spec of the oracle and
        the differential target for the vectorized ``predict``."""
        from clair3_tpu_torch.task.labels import (
            GT21, Genotype, VariantLength, gt21_enum_from_label)

        n = x.shape[0]
        out = np.full((n, 90), 1e-4, np.float32)
        center = 16
        for i in range(n):
            col_alt = x[i, :, center, 1].astype(np.int64)
            col_ref = x[i, :, center, 0].astype(np.int64)
            covered = col_ref != 0
            n_cov = max(int(covered.sum()), 1)
            snp_rows = covered & ~np.isin(col_alt, (0, -50, -100))
            ins_rows = col_alt == -50
            del_rows = col_alt == -100

            options = {
                "snp": int(snp_rows.sum()) / n_cov,
                "ins": int(ins_rows.sum()) / n_cov,
                "del": int(del_rows.sum()) / n_cov,
            }
            kind = max(options, key=options.get)
            af = options[kind]

            ref_vals = col_ref[covered]
            ref_base = _FA_BASE_FROM_VAL.get(int(np.sign(ref_vals[0]) * abs(ref_vals[0])), "A") if len(ref_vals) else "A"

            len1 = len2 = 0
            if af < self.het:
                gt21 = gt21_enum_from_label(ref_base + ref_base)
                zyg = Genotype.homo_reference
            else:
                hom = af >= self.hom
                zyg = Genotype.homo_variant if hom else Genotype.hetero_variant
                if kind == "snp":
                    vals, counts = np.unique(col_alt[snp_rows], return_counts=True)
                    alt_base = _FA_BASE_FROM_VAL.get(int(vals[np.argmax(counts)]), "A")
                    pair = alt_base + alt_base if hom else "".join(sorted(ref_base + alt_base))
                    gt21 = gt21_enum_from_label(pair)
                elif kind == "ins":
                    gt21 = GT21.InsIns if hom else gt21_enum_from_label(ref_base + "Ins")
                    # insertion length from the ch6 overlay of one ins row
                    row = int(np.nonzero(ins_rows)[0][0])
                    overlay = x[i, row, center:, 6]
                    ins_len = int(np.argmax(overlay == 0)) if (overlay == 0).any() else len(overlay)
                    len2 = min(ins_len, VariantLength.max)
                    len1 = len2 if hom else 0
                else:
                    gt21 = GT21.DelDel if hom else gt21_enum_from_label(ref_base + "Del")
                    row = int(np.nonzero(del_rows)[0][0])
                    after = x[i, row, center + 1:, 0]
                    del_len = int(np.argmax(after != 0)) if (after != 0).any() else len(after)
                    len1 = -min(del_len, VariantLength.max)
                    len2 = len1 if hom else 0
                    if not hom:
                        len1, len2 = sorted((len1, 0))

            out[i, gt21] = 1.0
            out[i, 21 + zyg] = 1.0
            out[i, 24 + len1 + VariantLength.index_offset] = 1.0
            out[i, 57 + len2 + VariantLength.index_offset] = 1.0
            for s, e in ((0, 21), (21, 24), (24, 57), (57, 90)):
                out[i, s:e] /= out[i, s:e].sum()
        return out


def trained_fixture_path(name: str) -> str:
    """Path of a committed trained-checkpoint fixture (see
    scripts/train_fixture_checkpoints.py)."""
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tests", "fixtures", "trained", name)


def load_trained_fixture(name: str) -> Dict:
    """Load a committed fp16 checkpoint fixture as a float32 variable tree.

    Raises FileNotFoundError with regeneration instructions if absent."""
    import os

    from clair3_tpu_torch.models.params_io import load_variables

    path = trained_fixture_path(name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing; regenerate it with `python -m "
            f"clair3_tpu_torch.train_fixture_checkpoints OUT_DIR` and copy it there")
    return load_variables(path)


def vcf_rows_numerically_equivalent(
    a: Sequence[str], b: Sequence[str],
    qual_tol: float = 0.5, gq_tol: int = 1, pl_tol: int = 1,
    flip_budget: float = 0.0, lone_qual_max: float = 20.0,
) -> Tuple[bool, Dict]:
    """Structured VCF-row parity across compute dtypes/backends.

    Byte-identity between a bf16 TPU run and its f32 CPU twin is
    unattainable for two reasons:

    * probabilities differ in the last decimals, so the printed QUAL and
      occasionally the derived integer GQ/PL move by one unit;
    * the FA routing cutoff is a QUANTILE of those probabilities, so a
      candidate sitting exactly at the cutoff can be routed to the
      full-alignment stage in one run and kept as a pileup call in the
      other (INFO tag F vs P) — a discrete flip from float noise, bounded
      by how many candidates straddle the cutoff.

    Rows are joined by (CHROM, POS).  Same-source rows must agree on
    every discrete field (REF/ALT/FILTER/INFO/GT/DP/AD/AF byte-identical)
    with |dQUAL| <= qual_tol, |dGQ| <= gq_tol, per-entry |dPL| <= pl_tol.
    Source-flipped rows (INFO exactly P-vs-F, or a position present on one
    side only) must still agree on REF/ALT/GT when paired, and their total
    count must be <= flip_budget * rows.  A one-sided row only counts
    against the budget when it is plausibly a routing artifact — a ref
    call (GT 0/0 or ./., or FILTER RefCall) or a low-QUAL call
    (QUAL <= lone_qual_max, the routed quantiles are the low-QUAL tail);
    a confidently-called lone variant is a violation regardless of budget,
    and any paired INFO difference other than P-vs-F fails outright.

    Returns (ok, stats); stats records max deltas, the flip count, and
    the first violations.
    """
    stats: Dict = {"rows": len(a), "max_dqual": 0.0, "max_dgq": 0,
                   "max_dpl": 0, "flips": 0, "violations": []}

    def _fail(key, what):
        if len(stats["violations"]) < 8:
            stats["violations"].append(f"{key}: {what}")

    def _index(rows):
        out = {}
        for r in rows:
            f = r.rstrip("\n").split("\t")
            out[(f[0], int(f[1]))] = f
        return out

    ia, ib = _index(a), _index(b)
    for key in set(ia) ^ set(ib):
        stats["flips"] += 1
        side = "production" if key in ia else "twin"
        f = (ia.get(key) or ib.get(key))
        if flip_budget == 0.0:
            _fail(key, f"row only in {side} run")
            continue
        gt = f[9].split(":", 1)[0] if len(f) > 9 else ""
        is_ref_call = gt in ("0/0", "./.") or "RefCall" in f[6]
        try:
            low_qual = float(f[5]) <= lone_qual_max
        except ValueError:
            low_qual = False
        if not (is_ref_call or low_qual):
            _fail(key, f"confident variant row only in {side} run "
                       f"(QUAL {f[5]}, GT {gt}): not a routing artifact")

    for key in sorted(set(ia) & set(ib)):
        fa, fb = ia[key], ib[key]
        if fa == fb:
            continue
        gt_a = fa[9].split(":", 1)[0] if len(fa) > 9 else ""
        gt_b = fb[9].split(":", 1)[0] if len(fb) > 9 else ""
        if fa[7] != fb[7]:
            if {fa[7], fb[7]} != {"P", "F"}:
                # only the P<->F source tag may differ; any other INFO
                # delta is a regression, not a routing boundary
                _fail(key, f"INFO {fa[7]!r} vs {fb[7]!r} (not a P/F "
                           f"routing flip)")
                continue
            stats["flips"] += 1
            if fa[3] != fb[3] or fa[4] != fb[4] or gt_a != gt_b:
                _fail(key, f"source flip changed the call: "
                           f"{fa[3]}>{fa[4]} {gt_a} vs {fb[3]}>{fb[4]} {gt_b}")
            continue
        if len(fa) != len(fb):
            _fail(key, "field count")
            continue
        for col in (2, 3, 4, 6, 7, 8):
            if col < len(fa) and fa[col] != fb[col]:
                _fail(key, f"column {col}: {fa[col]!r} vs {fb[col]!r}")
        try:
            dq = abs(float(fa[5]) - float(fb[5]))
        except ValueError:
            dq = 0.0 if fa[5] == fb[5] else float("inf")
        stats["max_dqual"] = max(stats["max_dqual"], dq)
        if dq > qual_tol:
            _fail(key, f"QUAL {fa[5]} vs {fb[5]}")
        if len(fa) > 9:
            keys = fa[8].split(":")
            va, vb = fa[9].split(":"), fb[9].split(":")
            for k, xa, xb in zip(keys, va, vb):
                if xa == xb:
                    continue
                if k == "GQ":
                    d = abs(int(xa) - int(xb))
                    stats["max_dgq"] = max(stats["max_dgq"], d)
                    if d > gq_tol:
                        _fail(key, f"GQ {xa} vs {xb}")
                elif k == "PL":
                    try:
                        d = max(abs(int(p) - int(q)) for p, q in
                                zip(xa.split(","), xb.split(",")))
                    except ValueError:
                        d = pl_tol + 1
                    stats["max_dpl"] = max(stats["max_dpl"], d)
                    if d > pl_tol or xa.count(",") != xb.count(","):
                        _fail(key, f"PL {xa} vs {xb}")
                else:
                    _fail(key, f"{k} {xa!r} vs {xb!r}")
    if stats["flips"] > flip_budget * max(len(a), 1):
        stats["violations"].append(
            f"{stats['flips']} routing flips > budget "
            f"{flip_budget:.4f} * {len(a)} rows")
    return not stats["violations"], stats


PLATFORMS = {
    "hifi": dict(coverage=25, read_length=900, error_rate=0.02,
                 with_mv_tags=False, matrix_depth=55, channels=8,
                 snp_min_af=0.08, indel_min_af=0.12,
                 var_pct_full=0.3, ref_pct_full=0.3),
    "ont": dict(coverage=45, read_length=1200, error_rate=0.04,
                with_mv_tags=True, matrix_depth=89, channels=9,
                snp_min_af=0.08, indel_min_af=0.15,
                var_pct_full=0.7, ref_pct_full=0.1),
}


def simulate(out_dir, L, seed=7, step=130, platform="hifi"):
    P = PLATFORMS[platform]
    ref = random_reference(L, seed=seed)
    rng = random.Random(seed)
    variants = []
    for pos in range(400, L - 400, step):
        kind = rng.random()
        gt = (1, 1) if rng.random() < 0.5 else ((0, 1) if rng.random() < 0.5 else (1, 0))
        if kind < 0.7:
            alt = rng.choice([b for b in "ACGT" if b != ref[pos]])
            variants.append(SimVariant(pos, ref[pos], alt, gt))
        elif kind < 0.85:
            ins = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 3)))
            variants.append(SimVariant(pos, ref[pos], ref[pos] + ins, gt))
        else:
            dlen = rng.randint(1, 3)
            variants.append(SimVariant(pos, ref[pos:pos + dlen + 1], ref[pos], gt))
    fasta, bam, _, _ = write_test_case(
        out_dir, ref_length=L, variants=variants, coverage=P["coverage"],
        read_length=P["read_length"], seed=seed, error_rate=P["error_rate"],
        with_mv_tags=P["with_mv_tags"])
    return fasta, bam, ref, variants


# QUAL = 10 - 10 log10((1 - p) / p) of a probability p that is a product of
# f32 head outputs near 1, whose resolution is one f32 ulp below 1 (2**-24);
# above QUAL 60 (1 - p < 1e-5) one ulp of one head moves QUAL by more than
# 0.1 (at QUAL 77.47, 1 - p is three ulps and one ulp moves it by 1.76).
# Such rows are held on 1 - p instead: within four ulps (one per head) plus
# the printed QUAL's rounding.
QUAL_SATURATES = 60.0
F32_ULP_BELOW_1 = 2.0 ** -24


def _one_minus_p(qual):
    return 10.0 ** (-(float(qual) - 10.0) / 10.0)


def f32_rows_equivalent(a, b):
    """Two f32 runs' VCF rows: ``vcf_rows_numerically_equivalent`` with flip
    budget 0 and its default tolerances on every row below QUAL_SATURATES on
    both sides; above it, every discrete field equal, no routing flip, and
    1 - p within four f32 ulps plus the print rounding (0.005 QUAL, 0.12% of
    1 - p).  Returns (ok, stats, rows above, max QUAL delta above)."""
    def key(r):
        return tuple(r.split("\t")[:2])

    qa, qb = ({key(r): float(r.split("\t")[5]) for r in rows} for rows in (a, b))
    high = {k for k in set(qa) & set(qb) if min(qa[k], qb[k]) >= QUAL_SATURATES}
    ok, stats = vcf_rows_numerically_equivalent([r for r in a if key(r) not in high],
                                                [r for r in b if key(r) not in high],
                                                flip_budget=0.0)
    ok_high, high_stats = vcf_rows_numerically_equivalent(
        [r for r in a if key(r) in high], [r for r in b if key(r) in high],
        qual_tol=float("inf"), gq_tol=1 << 30, pl_tol=1 << 30, flip_budget=0.0)
    worst = 0.0
    for k in high:
        pa, pb = _one_minus_p(qa[k]), _one_minus_p(qb[k])
        worst = max(worst, abs(pa - pb) / (4 * F32_ULP_BELOW_1 + 1.2e-3 * max(pa, pb)))
    stats["violations"] += high_stats["violations"]
    if worst > 1.0:
        stats["violations"].append(f"1 - p of a row above QUAL {QUAL_SATURATES} moved by "
                                   f"{worst:.2f}x its bound")
    return ok and ok_high and worst <= 1.0, stats, len(high), high_stats["max_dqual"]
