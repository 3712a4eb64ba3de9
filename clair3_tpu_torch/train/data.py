"""Training data: truth labeling and HDF5 tensor bins.

Ports of the reference training-data tooling:
* GetTruth (GetTruth.py:14-85) — truth VCF -> simplified var rows
* Tensor2Bin (clair3/utils.py:79-520) — labeled tensors -> HDF5 bins with
  ``position_matrix`` / ``position`` / ``label`` / ``alt_info`` datasets and
  non-variant subsampling (1:5 pileup, 1:1 FA)
* MergeBin (MergeBin.py:11-96) — concatenate bins chunk-compressed
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from clair3_tpu_torch.config import LABEL_SIZE
from clair3_tpu_torch.task.labels import (
    output_labels_from_reference,
    output_labels_from_vcf_columns,
)


@dataclass(frozen=True)
class TruthVariant:
    ctg: str
    pos: int  # 1-based
    ref: str
    alt: str
    genotype1: int
    genotype2: int


def truth_variants_from_vcf(path: str, ctg_name: Optional[str] = None) -> List[TruthVariant]:
    """Parse a truth VCF into simplified rows (GetTruth semantics)."""
    from clair3_tpu_torch.io.vcf import VcfReader

    out = []
    for rec in VcfReader(path):
        if ctg_name and rec.chrom != ctg_name:
            continue
        g1, g2 = rec.genotype
        out.append(TruthVariant(rec.chrom, rec.pos, rec.ref, rec.alt, g1, g2))
    return out


def build_labels(
    pos_infos: Sequence[str],
    truths: Sequence[TruthVariant],
    *,
    maximum_non_variant_ratio: Optional[float] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-hot 90-dim labels for candidate tensors, keyed by position.

    Returns (labels [N, 90] float32, keep_mask [N] bool) where the mask
    applies non-variant subsampling at `maximum_non_variant_ratio` non-variants
    per variant (reference: clair3/utils.py maximum_non_variant_ratio)."""
    truth_map: Dict[Tuple[str, int], TruthVariant] = {
        (t.ctg, t.pos): t for t in truths
    }
    labels = np.zeros((len(pos_infos), LABEL_SIZE), np.float32)
    is_variant = np.zeros(len(pos_infos), bool)
    for i, pos_info in enumerate(pos_infos):
        parts = pos_info.split(":")
        ctg, pos, seq = ":".join(parts[:-2]), int(parts[-2]), parts[-1]
        ref_base = seq[len(seq) // 2] if len(seq) > 1 else seq
        t = truth_map.get((ctg, pos))
        if t is None:
            labels[i] = output_labels_from_reference(ref_base)
        else:
            labels[i] = output_labels_from_vcf_columns(
                [t.ctg, str(t.pos), t.ref, t.alt, str(t.genotype1), str(t.genotype2)])
            is_variant[i] = True

    keep = np.ones(len(pos_infos), bool)
    if maximum_non_variant_ratio is not None:
        n_var = int(is_variant.sum())
        max_nonvar = int(maximum_non_variant_ratio * max(n_var, 1))
        nonvar_idx = np.nonzero(~is_variant)[0]
        if len(nonvar_idx) > max_nonvar:
            rng = random.Random(seed)
            drop = rng.sample(list(nonvar_idx), len(nonvar_idx) - max_nonvar)
            keep[drop] = False
    return labels, keep


def write_bin(
    path: str,
    tensors: np.ndarray,
    labels: np.ndarray,
    pos_infos: Sequence[str],
    alt_infos: Sequence[str],
    chunk_rows: int = 500,
) -> None:
    """Write an HDF5 training bin (reference dataset names/layout)."""
    import h5py

    str_dt = "S64"
    alt_dt = "S2048"
    with h5py.File(path, "w") as f:
        f.create_dataset("position_matrix", data=tensors,
                         chunks=(min(chunk_rows, max(1, len(tensors))),) + tensors.shape[1:],
                         compression="gzip", compression_opts=1)
        f.create_dataset("label", data=labels.astype(np.float32),
                         compression="gzip", compression_opts=1)
        f.create_dataset("position", data=np.array(
            [p.encode()[:64] for p in pos_infos], dtype=str_dt))
        f.create_dataset("alt_info", data=np.array(
            [a.encode()[:2048] for a in alt_infos], dtype=alt_dt))


def read_bin(path: str) -> Tuple[np.ndarray, np.ndarray, List[str], List[str]]:
    import h5py

    with h5py.File(path, "r") as f:
        tensors = f["position_matrix"][:]
        labels = f["label"][:]
        positions = [p.decode() for p in f["position"][:]]
        alt_infos = [a.decode() for a in f["alt_info"][:]]
    return tensors, labels, positions, alt_infos


def merge_bins(paths: Sequence[str], out_path: str, chunk_rows: int = 500) -> None:
    """Concatenate bins (MergeBin semantics)."""
    all_t, all_l, all_p, all_a = [], [], [], []
    for p in paths:
        t, l, pi, ai = read_bin(p)
        if len(t):
            all_t.append(t)
            all_l.append(l)
            all_p.extend(pi)
            all_a.extend(ai)
    tensors = np.concatenate(all_t) if all_t else np.zeros((0,), np.int32)
    labels = np.concatenate(all_l) if all_l else np.zeros((0, LABEL_SIZE), np.float32)
    write_bin(out_path, tensors, labels, all_p, all_a, chunk_rows=chunk_rows)


class BinDataset:
    """Chunked access over one or more bins, mirroring the reference's
    chunk-of-chunks batching (Train.py:109-135, chunk_size 250/200 assembled
    into batches of 2000)."""

    def __init__(self, paths: Sequence[str], chunk_size: int = 250):
        self.paths = list(paths)
        self.chunk_size = chunk_size
        self._tensors: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        for p in self.paths:
            t, l, _, _ = read_bin(p)
            self._tensors.append(t)
            self._labels.append(l)
        self.chunks: List[Tuple[int, int]] = []
        for bin_idx, t in enumerate(self._tensors):
            # a bin smaller than chunk_size still yields one (partial) chunk
            n_chunks = len(t) // chunk_size or (1 if len(t) else 0)
            self.chunks.extend((bin_idx, c) for c in range(n_chunks))

    @property
    def n_samples(self) -> int:
        return sum(len(t) for t in self._tensors)

    def get_chunk(self, bin_idx: int, chunk_idx: int, offset: int = 0):
        lo = offset + chunk_idx * self.chunk_size
        hi = lo + self.chunk_size
        return self._tensors[bin_idx][lo:hi], self._labels[bin_idx][lo:hi]

    def batches(
        self,
        chunk_list: Sequence[Tuple[int, int]],
        chunks_per_batch: int = 8,
        offset: int = 0,
    ):
        """Yield (x, y) batches of ~chunks_per_batch*chunk_size samples."""
        for i in range(0, len(chunk_list), chunks_per_batch):
            group = chunk_list[i: i + chunks_per_batch]
            xs, ys = zip(*(self.get_chunk(b, c, offset) for b, c in group))
            x = np.concatenate(xs)
            y = np.concatenate(ys)
            if len(x):
                yield x, y

    def split_chunks(
        self, validation_fraction: float = 0.1, seed: int = 0
    ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        rng = random.Random(seed)
        chunks = list(self.chunks)
        rng.shuffle(chunks)
        n_val = int(len(chunks) * validation_fraction)
        return chunks[n_val:], chunks[:n_val]
