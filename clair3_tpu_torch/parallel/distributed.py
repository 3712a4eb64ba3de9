"""Multi-process calling over ``torch.distributed``: the port's counterpart
of ``clair3_tpu.parallel.distributed``, with the same function names.

* ``init_distributed`` joins a gloo process group at a ``host:port``
  coordinator (process 0's address), with a 30-minute timeout.
* ``own_tasks`` strides the ordered genome chunks across processes; each
  process writes its own output directory, and one ``sort_vcf`` over the
  per-process VCFs (``sort_vcf --gvcf`` over the gVCFs) gives the merged
  result, as the reference's GNU-parallel fan-out does.
* ``gather_rowpack`` all-gathers every process's pileup rows, so that the
  QUAL-quantile routing cutoffs are those of the whole genome.
* ``GatheredPhaser`` phases each contig from every process's het SNPs, so
  that the reads near a chunk another process owns are haplotagged as one
  process would tag them (the reference phases whole contigs too).
* ``DistributedCaller`` is ``VariantCaller`` for one process of the group:
  it adds back only the known sites (``--vcf_fn``) of its own chunks, and
  its final phasing phases each contig from every process's final rows,
  writes its own rows and haplotags the BAM on process 0 only.

The group carries only these host-side rows, so it is gloo's whatever
``--device`` the nets run on: several processes may share one GPU.
"""

from __future__ import annotations

import bisect
import logging
import os
import time
from datetime import timedelta
from typing import Dict, List, Sequence, Tuple

import numpy as np

from clair3_tpu_torch.pipeline.call import VariantCaller

logger = logging.getLogger(__name__)

# processes reach the gather after unequal amounts of calling work
TIMEOUT = timedelta(seconds=1800)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> Tuple[int, int]:
    """Join the process group of ``num_processes`` processes whose process
    0 listens at ``coordinator_address`` (``host:port``); returns
    ``(rank, world_size)``.  A group this process joined before is kept,
    and then it raises when that group's size differs from a requested
    ``num_processes > 1``: every process would otherwise call the whole
    genome into the same output directory."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT)
    rank, count = dist.get_rank(), dist.get_world_size()
    if num_processes > 1 and count != num_processes:
        raise RuntimeError(f"requested num_processes={num_processes} but the process "
                           f"group has world_size={count}")
    return rank, count


def own_tasks(tasks: Sequence, process_id: int, process_count: int) -> List:
    """Strided process-local ownership of an ordered task list (chunks are
    size-homogeneous, so striding balances load like the reference's
    round-robin GNU-parallel dispatch)."""
    if process_count <= 1:
        return list(tasks)
    return [t for i, t in enumerate(tasks) if i % process_count == process_id]


def _all_gather_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` (int64, ``[n, k]``) of every process, concatenated in process
    order: the row counts first, then the rows padded to the longest."""
    import torch
    import torch.distributed as dist

    count = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(count)]
    dist.all_gather(lens, torch.tensor([len(rows)], dtype=torch.int64))
    lens = [int(n) for n in lens]
    pad = torch.zeros((max(max(lens), 1), rows.shape[1]), dtype=torch.int64)
    pad[: len(rows)] = torch.from_numpy(rows)
    parts = [torch.zeros_like(pad) for _ in range(count)]
    dist.all_gather(parts, pad)
    return np.concatenate([p.numpy()[:n] for p, n in zip(parts, lens)])


def gather_rowpack(pack):
    """All-gather the per-process (ctg, pos, qual, flags) row pack across
    every process of the group (concatenated in process order); the pack
    itself when no group is initialized.

    The float64 quals travel as their raw bits (an int64 view): the
    quantile cutoffs must equal a single-process run's exactly, since a
    cutoff one ulp off flips the routing of the row that defines it."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return pack
    t0 = time.perf_counter()
    # waits out the peers' unequal calling work, under the group's timeout
    dist.monitored_barrier(timeout=TIMEOUT)
    t1 = time.perf_counter()
    ctg, pos, qual, flags = pack
    qbits = np.ascontiguousarray(qual, np.float64).view(np.int64)
    rows = _all_gather_rows(np.stack([np.asarray(ctg, np.int64), np.asarray(pos, np.int64),
                                      qbits, np.asarray(flags, np.int64)], axis=1))
    logger.info("[gather] %d of %d rows from %d processes: barrier %.3f ms, "
                "all_gather %.3f ms", len(qual), len(rows), dist.get_world_size(),
                (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
    return (rows[:, 0].astype(np.asarray(ctg).dtype), rows[:, 1].astype(np.asarray(pos).dtype),
            np.ascontiguousarray(rows[:, 2]).view(np.float64),
            rows[:, 3].astype(np.asarray(flags).dtype))


class GatheredPhaser:
    """A phaser (``phase(ctg_name, het_snps)``) that phases each contig from
    the het SNPs of every process of the group, not only from those of the
    chunks this process owns.

    A process that phased its own SNPs alone would cut the phase blocks at
    the edges of its chunks: reads that reach into a neighbour's chunk then
    take other haplotags, and the full-alignment net re-calls the
    candidates near those edges from other tensors than one process would.
    Every process phases every contig in the same order, so the gather is
    one collective per contig.  A boundary SNP reported by both owners of
    its chunks is kept once."""

    def __init__(self, phaser):
        self.phaser = phaser

    def phase(self, ctg_name, het_snps):
        import torch.distributed as dist

        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, list(het_snps))
        by_pos = {}
        for rec in (r for part in parts for r in part):
            if by_pos.setdefault(rec.pos, rec) != rec:
                raise ValueError(f"processes disagree on the het SNP at {ctg_name}:{rec.pos}: "
                                 f"{by_pos[rec.pos]} vs {rec}")
        return self.phaser.phase(ctg_name, [by_pos[p] for p in sorted(by_pos)])


class DistributedCaller(VariantCaller):
    """``VariantCaller`` for process ``cfg.dist_process_id`` of a group of
    ``cfg.dist_process_count``: ``sort_vcf`` over the processes' outputs
    gives one process's, in genotyping mode and with final phasing too.

    * Genotyping mode (``--vcf_fn``): each process loads every known site,
      and ``VariantCaller`` writes a ``./.`` row for each one it did not
      call, including the sites of the chunks other processes call, which
      ``sort_vcf`` may then keep over the called row.  Here a known site
      belongs to the process that owns the chunk holding it (process 0
      when no chunk holds it), and each process adds back its own sites.
    * ``--use_phasing_for_final_output``: one collective gathers every
      process's final rows, each contig is phased whole from them, and each
      process writes its own rows, phased; only process 0 haplotags the BAM
      (``--use_haplotagging_for_final_output``), from all the phased rows."""

    def run_pileup(self, tasks):
        # the chunks this process owns, and the contigs every process's
        # chunks cover (plan_chunks covers 1..length), for the known sites
        self._own_spans: Dict[str, List[Tuple[int, int]]] = {}
        for t in tasks:
            self._own_spans.setdefault(t.contig, []).append((t.start, t.end))
        for spans in self._own_spans.values():
            spans.sort()
        self._lengths = dict(self._contigs)
        return super().run_pileup(tasks)

    def _owns_site(self, chrom: str, pos: int) -> bool:
        spans = self._own_spans.get(chrom, [])
        i = bisect.bisect_right(spans, (pos, float("inf"))) - 1
        if i >= 0 and spans[i][0] <= pos <= spans[i][1]:
            return True
        held = 1 <= pos <= self._lengths.get(chrom, 0)
        return not held and self.cfg.dist_process_id == 0

    def _genotyping_add_back(self, rows: List[str]) -> List[str]:
        if not self._known_records:
            return rows
        from clair3_tpu_torch.postprocess import add_back_missing_variants

        own = [r for r in self._known_records if self._owns_site(r.chrom, r.pos)]
        return add_back_missing_variants(own, rows)

    def _final_phasing(self, final_rows, contig_names, outputs) -> None:
        cfg = self.cfg
        if not (cfg.use_phasing_for_final_output or cfg.use_haplotagging_for_final_output):
            return
        import torch.distributed as dist

        from clair3_tpu_torch.phase.final_phasing import haplotag_bam, phase_final_rows

        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, list(final_rows))
        # every process's rows in one process's order: by contig, then
        # position (the processes' chunks do not overlap)
        rows = sorted((r for part in parts for r in part),
                      key=lambda r: (r.split("\t", 1)[0], int(r.split("\t", 2)[1])))
        phased = phase_final_rows(cfg.bam_fn, rows, contig_names)
        phased_of = dict(zip(rows, phased))  # a row's phasing is a function of its row
        path = os.path.join(cfg.output_dir, "phased_merge_output.vcf.gz")
        self._write_vcf(path, [phased_of[r] for r in final_rows], None)
        outputs["phased_merge_output"] = path
        if cfg.use_haplotagging_for_final_output and cfg.dist_process_id == 0:
            out_bam = os.path.join(cfg.output_dir, "phased_output.bam")
            _, n = haplotag_bam(cfg.bam_fn, cfg.ref_fn, phased, out_bam, min_mq=cfg.min_mq)
            logger.info("[haplotag] %d reads tagged -> %s", n, out_bam)
            outputs["phased_output_bam"] = out_bam
