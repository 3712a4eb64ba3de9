"""End-to-end variant calling driver.

Replaces the reference's shell orchestration (scripts/clair3_c_impl_pipeline.py:
GNU-parallel job arrays glued by intermediate files) with one in-process
pipeline:

    plan chunks -> [pileup extract -> jit forward -> decode]  (per chunk)
    -> sort/dedup -> pileup.vcf.gz
    -> select qual cutoffs -> (phase) -> select candidates
    -> [full-alignment extract -> jit forward -> decode]
    -> merge -> merge_output.vcf.gz

Extraction runs on host threads; the device sees fixed-shape batches through
InferenceEngine.  Decode is plain Python on the host.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from clair3_tpu_torch.config import CallConfig, NO_OF_POSITIONS
from clair3_tpu_torch.decode import (DecodeConfig, batch_decode,
                               batch_decode_parallel, shutdown_decode_pool)
from clair3_tpu_torch.io.bam import BamReader
from clair3_tpu_torch.io.fasta import FastaFile
from clair3_tpu_torch.io.vcf import VcfReader, VcfWriter, get_header
from clair3_tpu_torch.pipeline.engine import rescale_high_coverage_pileup
from clair3_tpu_torch.pipeline.merge_sort import (
    mark_low_qual,
    merge_pileup_and_full_alignment,
    sort_rows,
    update_haploid_precise_genotype,
    update_haploid_sensitive_genotype,
)
from clair3_tpu_torch.pipeline.select import (
    CandidateBatch,
    collect_pileup_stats,
    select_candidates_from_stats,
    select_het_snps_from_stats,
    select_phase_qual_from_stats,
    select_qual_from_stats,
)
from clair3_tpu_torch.pileup.extractor import create_pileup_tensors

logger = logging.getLogger(__name__)


@dataclass
class ChunkTask:
    contig: str
    start: int  # 1-based inclusive
    end: int    # 1-based inclusive


def plan_chunks(
    contigs: Sequence[Tuple[str, int]], chunk_size: int
) -> List[ChunkTask]:
    """Split contigs into fixed-size chunks (CheckEnvs.py:378-388 semantics:
    chunk_num = ceil(len / chunk_size))."""
    tasks = []
    for name, length in contigs:
        chunk_num = (length + chunk_size - 1) // chunk_size
        for i in range(chunk_num):
            tasks.append(ChunkTask(name, i * chunk_size + 1, min((i + 1) * chunk_size, length)))
    return tasks


class VariantCaller:
    """Single-host calling pipeline over a device mesh.

    ``pileup_engine`` / ``fa_engine`` are objects with
    ``predict(tensors) -> probabilities`` (InferenceEngine in production;
    tests may inject oracles)."""

    def __init__(
        self,
        config: CallConfig,
        pileup_engine=None,
        fa_engine=None,
        phaser=None,
    ):
        self.cfg = config.resolved()
        if self.cfg.bam_fn and self.cfg.bam_fn.lower().endswith(".cram"):
            # CRAM input (reference: README.md:127): decode once into an
            # indexed BAM so the native extractors and .bai windowed loads
            # run unchanged; outputs are byte-identical to BAM input.
            from clair3_tpu_torch.io.cram import cram_to_bam

            os.makedirs(os.path.join(self.cfg.output_dir, "tmp"), exist_ok=True)
            converted = os.path.join(self.cfg.output_dir, "tmp",
                                     "input_from_cram.bam")
            logger.info("[cram] decoding %s -> %s", self.cfg.bam_fn, converted)
            cram_to_bam(self.cfg.bam_fn, converted, self.cfg.ref_fn)
            self.cfg = dataclasses.replace(self.cfg, bam_fn=converted)
        self.pileup_engine = pileup_engine
        self.fa_engine = fa_engine
        self.phaser = phaser
        self.nonvariant_rows: List[str] = []
        import threading

        self._dump_lock = threading.Lock()
        if self.cfg.output_probabilities_fn:
            open(self.cfg.output_probabilities_fn, "w").close()
        # candidate gating (reference: CreateTensorPileupFromCffi.py:345-354)
        self._bed_tree = None
        if self.cfg.bed_fn:
            from clair3_tpu_torch.io.bed import read_bed

            self._bed_tree = read_bed(self.cfg.bed_fn)
        self._known_sites = None          # {(ctg, pos1)} for genotyping mode
        self._known_records = None
        if self.cfg.vcf_fn:
            self._known_records = list(VcfReader(self.cfg.vcf_fn))
            self._known_sites = {(r.chrom, r.pos) for r in self._known_records}

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------

    def resolve_contigs(self) -> List[Tuple[str, int]]:
        """Contig-set resolution (reference: CheckEnvs.py:244-311): the
        major-contig filter (chr{1..22,X,Y} and {1..22,X,Y}) applies only
        when none of --ctg_name/--bed_fn/--vcf_fn restricts the set and
        --include_all_ctgs is off; --ctg_name accepts a comma list."""
        cfg = self.cfg
        ctg_set = set(cfg.ctg_name.split(",")) if cfg.ctg_name else None
        bed_ctgs = (set(self._bed_tree.contigs())
                    if self._bed_tree is not None else None)
        vcf_ctgs = (
            {r.chrom for r in self._known_records}
            if self._known_records is not None else None
        )
        restricted = any(s is not None for s in (ctg_set, bed_ctgs, vcf_ctgs))
        major = {f"chr{i}" for i in list(range(1, 23)) + ["X", "Y"]}
        major |= {str(i) for i in list(range(1, 23)) + ["X", "Y"]}

        fa = FastaFile(self.cfg.ref_fn)
        bam = BamReader(self.cfg.bam_fn)
        bam_refs = set(bam.references)
        out = []
        for name in fa.references:
            if name not in bam_refs:
                continue
            if not cfg.include_all_ctgs and not restricted and name not in major:
                continue
            if ctg_set is not None and name not in ctg_set:
                continue
            if bed_ctgs is not None and name not in bed_ctgs:
                continue
            if vcf_ctgs is not None and name not in vcf_ctgs:
                continue
            if fa.contig_length(name) < self.cfg.min_contig_size:
                continue
            out.append((name, fa.contig_length(name)))
        fa.close()
        if not out and not cfg.include_all_ctgs and not restricted:
            logger.warning(
                "no major contigs (chr{1..22,X,Y}) found in BAM+FASTA; "
                "use --include_all_ctgs to call on all contigs")
        return out

    # ------------------------------------------------------------------
    # pileup stage
    # ------------------------------------------------------------------

    def _pileup_decode_config(self) -> DecodeConfig:
        return DecodeConfig(
            add_indel_length=False,
            pileup=True,
            show_ref_calls=True,  # ref-call quals drive FA routing
            gvcf=self.cfg.gvcf,
            enable_long_indel=self.cfg.enable_long_indel,
            maximum_variant_length_that_need_infer=self.cfg.max_indel_length,
            keep_iupac_bases=self.cfg.keep_iupac_bases,
            debug=self.cfg.debug,
        )

    def _extract_pileup_chunk(self, task: ChunkTask):
        # split cores between chunk-level workers and the in-call C++
        # counting shards (native counting threads over genome subranges)
        per_call = max(1, (os.cpu_count() or 1) // max(1, self.cfg.threads))
        # Filter BEFORE window slicing: in genotyping mode (AF gates at 0)
        # every covered position is a candidate, and tensorizing them all
        # before dropping non-known sites would cost GBs per chunk
        # (reference filters at CreateTensorPileupFromCffi.py:345-354 too).
        positions_filter = None
        if self._known_sites is not None or self._bed_tree is not None:
            ctg = task.contig

            def positions_filter(pos0: int) -> bool:
                pos1 = pos0 + 1
                if self._known_sites is not None and (ctg, pos1) not in self._known_sites:
                    return False
                if self._bed_tree is not None and not self._bed_tree.overlaps(
                        ctg, pos1 - 1, pos1 + 1):
                    return False
                return True

        tensors, pos_infos, alt_infos, res = create_pileup_tensors(
            self.cfg.bam_fn,
            self.cfg.ref_fn,
            task.contig,
            task.start,
            task.end,
            min_mq=self.cfg.min_mq,
            min_depth=self.cfg.min_coverage,
            min_snp_af=self.cfg.snp_min_af,
            min_indel_af=self.cfg.indel_min_af,
            max_indel_length=self.cfg.max_indel_length,
            call_snp_only=self.cfg.call_snp_only,
            gvcf=self.cfg.gvcf,
            head_tail=self.cfg.enable_variant_calling_at_sequence_head_and_tail,
            threads=per_call,
            positions_filter=positions_filter,
        )
        # window slicing is done; only the gVCF count arrays are consumed
        # downstream — drop the dense [L,18] matrix so the bounded-prefetch
        # window holds MBs per chunk, not the ~380 MB counts of a 5 Mb chunk
        res.counts = None
        res.depth = None
        return tensors, pos_infos, alt_infos, res

    @staticmethod
    def _bounded_map(pool, fn, items, window: int):
        """Ordered pool.map with a bounded submission window.  Eager
        ``pool.map`` schedules every chunk up front, so on a whole genome
        the extracted-but-unconsumed tensors of hundreds of chunks pile up
        in completed futures; this caps in-flight work at ``window``."""
        from collections import deque

        futs = deque()
        it = iter(items)

        def fill():
            while len(futs) < window:
                try:
                    item = next(it)
                except StopIteration:
                    return
                futs.append((item, pool.submit(fn, item)))

        fill()
        while futs:
            item, fut = futs.popleft()
            fill()  # keep workers busy while we block on the head
            yield item, fut.result()

    def run_pileup(self, tasks: Sequence[ChunkTask]) -> List[str]:
        """Pileup-call all chunks; returns unsorted VCF body rows.  When
        gVCF is enabled, completed non-variant blocks stream to the
        ``tmp/nonvar.gvcf.gz`` spill as chunks finish (consumed by
        _write_gvcf; reference: CreateTensorPileupFromCffi.py:399-441)."""
        decode_cfg = self._pileup_decode_config()
        rows: List[str] = []
        t0 = time.time()
        n_candidates = 0
        gvcf_writer = None
        fa = None
        if self.cfg.gvcf:
            fa = FastaFile(self.cfg.ref_fn)
            lengths = {n: fa.contig_length(n) for n in fa.references}
            gvcf_writer = None
            try:
                from clair3_tpu_torch.native import NativeGvcfWriter, native_available

                if native_available():  # ~10x the Python writer at WGS scale
                    gvcf_writer = NativeGvcfWriter(
                        p_err=self.cfg.base_err,
                        gq_bin_size=self.cfg.gq_bin_size,
                        contig_lengths=lengths)
            except Exception:
                gvcf_writer = None
            if gvcf_writer is None:
                from clair3_tpu_torch.gvcf import NonVariantBlockWriter

                gvcf_writer = NonVariantBlockWriter(
                    p_err=self.cfg.base_err, gq_bin_size=self.cfg.gq_bin_size,
                    contig_lengths=lengths)
            # spill completed non-variant blocks to disk as chunks finish:
            # WGS-scale block streams (tens of GB of rows) must never be
            # memory-resident (reference keeps per-chunk .tmp.gvcf files)
            from clair3_tpu_torch.io.bgzf import BgzfWriter

            os.makedirs(os.path.join(self.cfg.output_dir, "tmp"), exist_ok=True)
            self._nonvar_spill_path = os.path.join(
                self.cfg.output_dir, "tmp", "nonvar.gvcf.gz")
            # level 1: the spill is a temp file, favor speed over ratio
            # (the reference lz4-compresses its gvcf intermediates for the
            # same reason, SortVcf.py:203-216)
            nonvar_spill = BgzfWriter(self._nonvar_spill_path, level=1,
                                      threads=self.cfg.threads)
        with ThreadPoolExecutor(max_workers=max(1, self.cfg.threads)) as pool:
            for task, (tensors, pos_infos, alt_infos, res) in self._bounded_map(
                pool, self._extract_pileup_chunk, tasks,
                window=max(2, self.cfg.threads + 1),
            ):
                if gvcf_writer is not None and res.pos_ref_count is not None:
                    ref_seq = fa.fetch(task.contig, task.start - 1, task.end)
                    # assemble chunk-span count arrays (zero-padded outside
                    # the extracted range) and bulk-feed the block writer
                    span = task.end - (task.start - 1)
                    lo = (task.start - 1) - res.start
                    hi = task.end - res.start
                    nr = np.zeros(span, np.int64)
                    nt = np.zeros(span, np.int64)
                    s0, s1 = max(0, lo), min(len(res.pos_ref_count), max(0, hi))
                    if s1 > s0:
                        d0 = s0 - lo
                        nr[d0: d0 + (s1 - s0)] = res.pos_ref_count[s0:s1]
                        nt[d0: d0 + (s1 - s0)] = res.pos_total_count[s0:s1]
                    gvcf_writer.feed(task.contig, task.start, ref_seq, nr, nt)
                    # close the open block at the chunk boundary: the
                    # reference's per-chunk .tmp.gvcf intermediates can
                    # never span chunks either (SortVcf.py concatenates
                    # rows without re-merging blocks), and per-chunk
                    # closure makes single-process and --dist_* shard
                    # outputs byte-identical (tests/test_distributed.py)
                    gvcf_writer.flush()
                    done = gvcf_writer.drain()
                    if done:
                        nonvar_spill.write(
                            ("\n".join(done) + "\n").encode())
                if self._bed_tree is not None or self._known_sites is not None:
                    tensors, pos_infos, alt_infos = self._filter_candidates(
                        task.contig, tensors, pos_infos, alt_infos)
                if tensors.shape[0] == 0:
                    continue
                n_candidates += tensors.shape[0]
                tensors = rescale_high_coverage_pileup(
                    tensors, alt_infos, max_depth=self.cfg.preset.max_depth)
                # one-deep pipelining: decode chunk i-1 on host while the
                # device computes chunk i
                pending = self._submit(self.pileup_engine, tensors, pos_infos,
                                       alt_infos, getattr(self, "_p_pending", None),
                                       rows, decode_cfg)
                self._p_pending = pending
            rows.extend(self._drain(self.pileup_engine,
                                    getattr(self, "_p_pending", None), decode_cfg))
            self._p_pending = None
        if gvcf_writer is not None:
            tail = gvcf_writer.finish()
            if tail:
                nonvar_spill.write(("\n".join(tail) + "\n").encode())
            nonvar_spill.close()
            fa.close()
        logger.info(
            "[pileup] %d candidates -> %d rows in %.1fs",
            n_candidates, len(rows), time.time() - t0)
        return rows

    def _submit(self, engine, tensors, pos_infos, alt_infos, pending, rows,
                decode_cfg):
        """Enqueue one batch on the device; decode the previous batch while
        it runs.  Falls back to synchronous predict for engines without the
        async API (test oracles)."""
        if not hasattr(engine, "predict_async"):
            probs = engine.predict(tensors)
            self._dump_probabilities(pos_infos, alt_infos, probs)
            rows.extend(batch_decode_parallel(
                pos_infos, alt_infos, probs, decode_cfg,
                processes=self.cfg.threads))
            return None
        handles = engine.predict_async(tensors)
        if pending is not None:
            rows.extend(self._drain(engine, pending, decode_cfg))
        return (pos_infos, alt_infos, handles)

    def _drain(self, engine, pending, decode_cfg) -> List[str]:
        if pending is None:
            return []
        pos_infos, alt_infos, handles = pending
        probs = engine.gather(handles)
        self._dump_probabilities(pos_infos, alt_infos, probs)
        return batch_decode_parallel(pos_infos, alt_infos, probs, decode_cfg,
                                     processes=self.cfg.threads)

    def _dump_probabilities(self, pos_infos, alt_infos, probs) -> None:
        """Debug hook: append raw head probabilities per candidate
        (reference: CallVariants --output_probabilities)."""
        if not self.cfg.output_probabilities_fn:
            return
        with self._dump_lock:
            with open(self.cfg.output_probabilities_fn, "a") as fh:
                for pi, ai, p in zip(pos_infos, alt_infos, probs):
                    fh.write(f"{pi}\t{ai}\t" + " ".join(f"{x:.6f}" for x in p) + "\n")

    def _filter_candidates(self, ctg, tensors, pos_infos, alt_infos):
        keep = []
        for i, pos_info in enumerate(pos_infos):
            pos1 = int(pos_info.split(":")[-2])
            # reference window is [pos-1, pos+1) 0-based
            # (CreateTensorPileupFromCffi.py:349-352 is_region_in)
            if self._bed_tree is not None and not self._bed_tree.overlaps(
                    ctg, pos1 - 1, pos1 + 1):
                continue
            if self._known_sites is not None and (ctg, pos1) not in self._known_sites:
                continue
            keep.append(i)
        if len(keep) == len(pos_infos):
            return tensors, pos_infos, alt_infos
        return (tensors[keep], [pos_infos[i] for i in keep],
                [alt_infos[i] for i in keep])

    # ------------------------------------------------------------------
    # full-alignment stage
    # ------------------------------------------------------------------

    def _fa_decode_config(self) -> DecodeConfig:
        return DecodeConfig(
            add_indel_length=True,   # FA calling always uses length heads
            pileup=False,
            show_ref_calls=True,     # merge filters ref rows at the end
            gvcf=self.cfg.gvcf,
            enable_long_indel=self.cfg.enable_long_indel,
            maximum_variant_length_that_need_infer=self.cfg.max_indel_length,
            keep_iupac_bases=self.cfg.keep_iupac_bases,
            debug=self.cfg.debug,
        )

    def run_full_alignment(
        self, batches: Sequence[CandidateBatch]
    ) -> List[str]:
        from clair3_tpu_torch.fullalign.extractor import create_fa_tensors

        decode_cfg = self._fa_decode_config()
        rows: List[str] = []

        def _extract(batch: CandidateBatch):
            return create_fa_tensors(
                self.cfg.bam_fn,
                self.cfg.ref_fn,
                batch.contig,
                batch.positions,
                phased_snps=batch.phased_snps,
                matrix_depth=self.cfg.matrix_depth,
                min_mq=self.cfg.min_mq,
                no_phasing=self.cfg.no_phasing_for_fa,
                enable_dwell=self.cfg.enable_dwell_time,
            )

        pending = None
        with ThreadPoolExecutor(max_workers=max(1, self.cfg.threads)) as pool:
            for _, (tensors, pos_infos, alt_infos) in self._bounded_map(
                pool, _extract, batches, window=max(2, self.cfg.threads + 1),
            ):
                if tensors.shape[0] == 0:
                    continue
                pending = self._submit(self.fa_engine, tensors, pos_infos,
                                       alt_infos, pending, rows, decode_cfg)
            rows.extend(self._drain(self.fa_engine, pending, decode_cfg))
        return rows

    # ------------------------------------------------------------------
    # orchestration
    # ------------------------------------------------------------------

    def _write_vcf(self, path: str, rows: Sequence[str], contigs=None) -> str:
        header = get_header(
            reference_file_path=self.cfg.ref_fn,
            sample_name=self.cfg.sample_name,
            gvcf=False,
            contigs=contigs or getattr(self, "_contigs", None),
        )
        with VcfWriter(path, header, threads=self.cfg.threads) as w:
            w.write_rows(rows)
        if path.endswith(".gz"):
            from clair3_tpu_torch.io.tabix import write_tabix_index

            write_tabix_index(path)
        return path

    def _write_gvcf(self, final_rows: Sequence[str]) -> Optional[str]:
        """Merge the final variant rows with the non-variant blocks into
        merge_output.gvcf.gz (reference: MergeVcf.mergeNonVariant).  The
        block stream comes from the pileup stage's disk spill and is merged
        and written incrementally — O(variants) memory, not O(genome)."""
        if not self.cfg.gvcf:
            return None
        from clair3_tpu_torch.gvcf import merge_variant_and_nonvariant_stream
        from clair3_tpu_torch.io.bgzf import iter_lines

        fa = FastaFile(self.cfg.ref_fn)

        def ref_base_at(chrom: str, pos1: int) -> str:
            return fa.fetch(chrom, pos1 - 1, pos1) or "N"

        def nonvariant_iter():
            spill = getattr(self, "_nonvar_spill_path", None)
            if spill and os.path.exists(spill):
                yield from iter_lines(spill)
            else:  # tests may inject rows directly
                yield from self.nonvariant_rows

        merged = merge_variant_and_nonvariant_stream(
            final_rows, nonvariant_iter(), ref_base_at)
        path = os.path.join(self.cfg.output_dir, "merge_output.gvcf.gz")
        # Header contigs: called contigs by default; --output_all_contigs_in_
        # gvcf_header keeps every fai contig (reference: SortVcf.py:276,346
        # check_header_in_gvcf filtering).
        if self.cfg.output_all_contigs_in_gvcf_header:
            fai = FastaFile(self.cfg.ref_fn)
            header_contigs = [(n, fai.contig_length(n)) for n in fai.references]
            fai.close()
        else:
            header_contigs = getattr(self, "_contigs", None)
        header = get_header(
            reference_file_path=self.cfg.ref_fn,
            sample_name=self.cfg.sample_name, gvcf=True,
            contigs=header_contigs)
        try:
            with VcfWriter(path, header, threads=self.cfg.threads) as w:
                w.write_rows(merged)
        finally:
            fa.close()
        return path

    def _final_phasing(self, final_rows, contig_names, outputs) -> None:
        """Optional last stage: phase the merged VCF and haplotag the BAM
        (reference: whatshap final phasing/haplotagging,
        clair3_c_impl_pipeline.py:632-700)."""
        cfg = self.cfg
        if not (cfg.use_phasing_for_final_output or cfg.use_haplotagging_for_final_output):
            return
        from clair3_tpu_torch.phase.final_phasing import haplotag_bam, phase_final_rows

        phased_rows = phase_final_rows(cfg.bam_fn, final_rows, contig_names)
        path = os.path.join(cfg.output_dir, "phased_merge_output.vcf.gz")
        self._write_vcf(path, phased_rows, None)
        outputs["phased_merge_output"] = path
        if cfg.use_haplotagging_for_final_output:
            out_bam = os.path.join(cfg.output_dir, "phased_output.bam")
            _, n = haplotag_bam(cfg.bam_fn, cfg.ref_fn, phased_rows, out_bam,
                                min_mq=cfg.min_mq)
            logger.info("[haplotag] %d reads tagged -> %s", n, out_bam)
            outputs["phased_output_bam"] = out_bam

    def _genotyping_add_back(self, rows: List[str]) -> List[str]:
        """Genotyping mode (--vcf_fn): re-add candidate sites missing from
        the output as ./. rows (AddBackMissingVariantsInGenotyping)."""
        if not self._known_records:
            return rows
        from clair3_tpu_torch.postprocess import add_back_missing_variants

        return add_back_missing_variants(self._known_records, rows)

    def _final_filter(self, rows: Sequence[str]) -> List[str]:
        """Postfilters applied to the final merged rows (SortVcf.py:93-112)."""
        out = []
        for row in rows:
            cols = row.rstrip("\n").split("\t")
            ref_base, alt_base = cols[3], cols[4]
            is_reference = alt_base == "." or ref_base == alt_base
            if self.cfg.haploid_precise:
                row = update_haploid_precise_genotype(row)
            if self.cfg.haploid_sensitive:
                row = update_haploid_sensitive_genotype(row)
            if not row:
                continue
            if not is_reference:
                row = mark_low_qual(row, self.cfg.qual)
                out.append(row)
            elif self.cfg.print_ref_calls:
                out.append(row)
        return out

    def _realign_illumina(self, contigs) -> str:
        """ilmn platform: local read realignment for the full-alignment
        stage (reference: RealignReads as the first stage of the ilmn FA
        pipe, CallVarBam.py:99,160-175 — the pileup stage reads the RAW
        BAM).  Returns the realigned BAM path."""
        from clair3_tpu_torch.io.bam import BamReader, write_bam
        from clair3_tpu_torch.io.fasta import FastaFile
        from clair3_tpu_torch.realign.realigner import realign_reads_in_region

        bam = BamReader(self.cfg.bam_fn)
        fa = FastaFile(self.cfg.ref_fn)
        all_reads = []
        total = 0
        step = 2_000_000  # bound memory; reads partition by start position
        for name, length in contigs:
            for cs in range(0, length, step):
                ce = min(length, cs + step)
                reads = [r for r in bam.fetch(name, cs, ce, min_mq=self.cfg.min_mq)
                         if r.pos >= cs]
                if not reads:
                    continue
                ref_start = max(0, cs - 2000)
                ref_seq = fa.fetch(name, ref_start, min(length, ce + 2000))
                realigned, n = realign_reads_in_region(
                    reads, ref_seq, ref_start, cs, ce)
                total += n
                all_reads.extend(realigned)
        fa.close()
        all_reads.sort(key=lambda r: (r.tid, r.pos))
        os.makedirs(os.path.join(self.cfg.output_dir, "tmp"), exist_ok=True)
        out_path = os.path.join(self.cfg.output_dir, "tmp", "realigned.bam")
        write_bam(out_path, bam.references, bam.lengths, all_reads)
        logger.info("[realign] %d reads realigned -> %s", total, out_path)
        return out_path

    def _ilmn_fa_regions_and_candidates(self, contig, positions, fa_bam):
        """ilmn full-alignment work units: 1000 bp windows anchored at the
        routed low-qual positions (SelectCandidates.py:262-269), candidates
        RE-DETECTED inside each window from the REALIGNED BAM (realignment
        shifts them; reference CreateTensorFullAlignment re-runs candidate
        selection over the realigned reads).  Returns (bed_rows, cand_pos):
        bed_rows in the full_aln_regions file convention for the
        region-scoped merge."""
        region_size = 1000
        pad = NO_OF_POSITIONS
        # the reference clamps the padded window START, not the anchor
        # (SelectCandidates.py:264: max(a - pad, 1), end = a + 1000 + pad);
        # clamping the anchor would shift the first window's end by one
        anchors = sorted({p // region_size * region_size for p in positions})
        bed_rows = []
        spans = []
        for a in anchors:
            win_start = max(a - pad, 1)           # 1-based inclusive
            win_end = a + region_size + pad       # 1-based exclusive-ish
            bed_rows.append((contig, max(win_start - 1, 0), win_end - 1))
            if spans and win_start <= spans[-1][1]:
                spans[-1] = (spans[-1][0], max(spans[-1][1], win_end))
            else:
                spans.append((win_start, win_end))
        cand_pos: List[int] = []
        for s, e in spans:
            _, pos_infos, _, _ = create_pileup_tensors(
                fa_bam, self.cfg.ref_fn, contig, s, e,
                min_mq=self.cfg.min_mq,
                min_depth=self.cfg.min_coverage,
                min_snp_af=self.cfg.snp_min_af,
                min_indel_af=self.cfg.indel_min_af,
                max_indel_length=self.cfg.max_indel_length,
                call_snp_only=self.cfg.call_snp_only,
            )
            cand_pos.extend(int(p.split(":")[-2]) for p in pos_infos)
        return bed_rows, sorted(set(cand_pos))

    def _join_warmups(self) -> None:
        """Join in-flight warmup_async compiles before returning: a daemon
        thread killed mid-XLA-compile at interpreter exit aborts the
        process (pthread cancel inside C++)."""
        for eng in (self.pileup_engine, self.fa_engine):
            if eng is not None and hasattr(eng, "wait_warmup"):
                eng.wait_warmup()
        shutdown_decode_pool()

    def run(self) -> Dict[str, str]:
        """Execute the cascade; returns paths of the written VCFs.  Stage
        wall-times land in ``self.stage_times`` (observability; the
        reference only had per-job logs from GNU parallel).

        Warmup threads are joined even on failure: a daemon thread killed
        mid-XLA-compile at interpreter exit SIGABRTs and masks the real
        error."""
        try:
            outputs = self._run_impl()
        finally:
            self._join_warmups()
        if self.cfg.remove_intermediate_dir:
            # reference: clair3_c_impl_pipeline.py:711 removes tmp/ after a
            # successful run (CRAM-converted / ilmn-realigned BAMs here)
            import shutil

            tmp_dir = os.path.join(self.cfg.output_dir, "tmp")
            if os.path.isdir(tmp_dir):
                logger.info("[cleanup] removing intermediate dir %s", tmp_dir)
                shutil.rmtree(tmp_dir, ignore_errors=True)
        return outputs

    def _run_impl(self) -> Dict[str, str]:
        self.stage_times: Dict[str, float] = {}

        def _timed(name):
            class _T:
                def __enter__(_s):
                    _s.t0 = time.time()

                def __exit__(_s, *exc):
                    self.stage_times[name] = (
                        self.stage_times.get(name, 0.0) + time.time() - _s.t0)

            return _T()

        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        contigs = self.resolve_contigs()
        self._contigs = contigs  # for ##contig header lines
        # overlap jit compilation of all batch buckets with extraction
        if hasattr(self.pileup_engine, "warmup_async"):
            self.pileup_engine.warmup_async((NO_OF_POSITIONS, 18), np.int32)
        if self.fa_engine is not None and hasattr(self.fa_engine, "warmup_async"):
            self.fa_engine.warmup_async(
                (self.cfg.matrix_depth, NO_OF_POSITIONS, self.cfg.fa_channels),
                np.int8)
        self._timed = _timed
        contig_names = [c for c, _ in contigs]
        chunk_size = cfg.chunk_size
        if cfg.chunk_num is not None:
            # CheckEnvs --chunk_num semantics: N chunks per contig
            # (<=0: one whole-contig chunk)
            n = max(1, cfg.chunk_num)
            longest = max((l for _, l in contigs), default=1)
            chunk_size = (longest + n - 1) // n if cfg.chunk_num > 0 else 1 << 40
        tasks = plan_chunks(contigs, chunk_size)
        if cfg.dist_process_count > 1:
            from clair3_tpu_torch.parallel.distributed import own_tasks

            tasks = own_tasks(tasks, cfg.dist_process_id,
                              cfg.dist_process_count)
            logger.info("[plan] process %d/%d owns %d chunks",
                        cfg.dist_process_id, cfg.dist_process_count,
                        len(tasks))
        logger.info("[plan] %d contigs, %d chunks", len(contigs), len(tasks))

        with self._timed("pileup"):
            pileup_rows = self.run_pileup(tasks)
        with self._timed("sort"):
            pileup_rows = sort_rows(pileup_rows, contig_names)
        outputs: Dict[str, str] = {}
        pileup_path = os.path.join(cfg.output_dir, "pileup.vcf.gz")
        with self._timed("write_vcf"):
            self._write_vcf(pileup_path, pileup_rows, contigs)
        outputs["pileup"] = pileup_path

        merge_path = os.path.join(cfg.output_dir, "merge_output.vcf.gz")
        if cfg.pileup_only or self.fa_engine is None:
            final_rows = self._genotyping_add_back(self._final_filter(pileup_rows))
            self._write_vcf(merge_path, final_rows, contigs)
            outputs["merge_output"] = merge_path
            gvcf_path = self._write_gvcf(final_rows)
            if gvcf_path:
                outputs["merge_output_gvcf"] = gvcf_path
            self._final_phasing(final_rows, contig_names, outputs)
            logger.info("[timing] %s", {k: round(v, 2) for k, v in self.stage_times.items()})
            return outputs

        # --- full-alignment cascade ---
        # compact routing stats: one pass over the row strings instead of a
        # parsed VcfRecord per row (O(genome) objects on a real genome)
        pileup_stats = collect_pileup_stats(pileup_rows)
        global_phase_qual = None
        if cfg.dist_process_count > 1:
            # multi-host: quantile cutoffs must come from EVERY process's
            # rows or shards route different candidates than a single
            # process (the reference's SelectQual likewise runs over the
            # complete pileup VCF, preprocess/SelectQual.py)
            from clair3_tpu_torch.parallel.distributed import gather_rowpack
            from clair3_tpu_torch.pipeline.select import (cutoffs_from_rowpack,
                                                    stats_rowpack)

            pack = gather_rowpack(stats_rowpack(pileup_stats, contig_names))
            var_qual, ref_qual, global_phase_qual = cutoffs_from_rowpack(
                *pack, cfg.var_pct_full, cfg.ref_pct_full,
                cfg.var_pct_phasing)
        else:
            var_qual, ref_qual = select_qual_from_stats(
                pileup_stats, cfg.var_pct_full, cfg.ref_pct_full)
        logger.info("[select] var_qual=%.2f ref_qual=%.2f", var_qual, ref_qual)

        phased_by_contig: Dict[str, List] = {}
        if self.phaser is not None and not cfg.no_phasing_for_fa:
            with self._timed("phase"):
                phase_qual = (global_phase_qual
                              if global_phase_qual is not None else
                              select_phase_qual_from_stats(
                                  pileup_stats, cfg.var_pct_phasing))
                for ctg in contig_names:
                    het_snps = select_het_snps_from_stats(
                        pileup_rows, pileup_stats, phase_qual, ctg)
                    phased_by_contig[ctg] = self.phaser.phase(ctg, het_snps)

        # ilmn: realign reads for the FA stage only (the pileup stage read
        # the raw BAM, matching the reference's CallVarBam.py:99 split)
        fa_bam = None
        ilmn_bed_rows: List[Tuple[str, int, int]] = []
        if cfg.platform == "ilmn":
            with self._timed("realign"):
                fa_bam = self._realign_illumina(contigs)

        fa_rows: List[str] = []
        _ent_fa = FastaFile(cfg.ref_fn) if cfg.call_low_seq_entropy else None
        try:
            with self._timed("full_alignment"):
                for ctg in contig_names:
                    fetch_window = None
                    if _ent_fa is not None:
                        def fetch_window(pos1, _ctg=ctg, _fa=_ent_fa):
                            return _fa.fetch(_ctg, max(0, pos1 - 17), pos1 + 16)

                    batches = select_candidates_from_stats(
                        pileup_stats, ctg, var_qual, ref_qual,
                        phased_rows=phased_by_contig.get(ctg, ()),
                        call_low_seq_entropy=cfg.call_low_seq_entropy,
                        seq_entropy_pro=cfg.seq_entropy_pro,
                        var_pct_full=cfg.var_pct_full,
                        fetch_window=fetch_window,
                    )
                    if batches and fa_bam is not None:
                        # region windows + candidate re-detection on the
                        # realigned BAM (positions shift under realignment)
                        routed = [p for b in batches for p in b.positions]
                        bed_rows, cand_pos = self._ilmn_fa_regions_and_candidates(
                            ctg, routed, fa_bam)
                        ilmn_bed_rows.extend(bed_rows)
                        phased_all = sorted(
                            {ps for b in batches for ps in b.phased_snps})
                        batches = [
                            CandidateBatch(ctg, cand_pos[i: i + 10_000],
                                           phased_all)
                            for i in range(0, len(cand_pos), 10_000)
                        ]
                    if batches:
                        if fa_bam is not None:
                            raw_cfg = self.cfg
                            self.cfg = dataclasses.replace(
                                self.cfg, bam_fn=fa_bam)
                            try:
                                fa_rows.extend(self.run_full_alignment(batches))
                            finally:
                                self.cfg = raw_cfg
                        else:
                            fa_rows.extend(self.run_full_alignment(batches))
        finally:
            if _ent_fa is not None:
                _ent_fa.close()
        with self._timed("sort"):
            fa_rows = sort_rows(fa_rows, contig_names)
        fa_path = os.path.join(cfg.output_dir, "full_alignment.vcf.gz")
        with self._timed("write_vcf"):
            self._write_vcf(fa_path, fa_rows, contigs)
        outputs["full_alignment"] = fa_path

        # bucket once per contig (O(rows)) instead of rescanning per contig
        from collections import defaultdict

        pileup_by_ctg: Dict[str, List[str]] = defaultdict(list)
        for r in pileup_rows:
            pileup_by_ctg[r.split("\t", 1)[0]].append(r)
        fa_by_ctg: Dict[str, List[str]] = defaultdict(list)
        for r in fa_rows:
            fa_by_ctg[r.split("\t", 1)[0]].append(r)
        merged: List[str] = []
        _merge_t = self._timed("merge")
        _merge_t.__enter__()
        region_index = None
        if fa_bam is not None:
            from clair3_tpu_torch.pipeline.merge_sort import RegionIndex

            region_index = RegionIndex(ilmn_bed_rows)
            # keep the windows inspectable, as the reference's
            # candidate_bed/ shards are (SelectCandidates.py:262-294)
            regions_path = os.path.join(cfg.output_dir, "tmp",
                                        "full_aln_regions.bed")
            os.makedirs(os.path.dirname(regions_path), exist_ok=True)
            with open(regions_path, "w") as fh:
                for row in ilmn_bed_rows:
                    fh.write("\t".join(str(x) for x in row) + "\n")
        for ctg in contig_names:
            if region_index is not None:
                from clair3_tpu_torch.pipeline.merge_sort import (
                    merge_pileup_and_full_alignment_illumina)

                merged.extend(
                    merge_pileup_and_full_alignment_illumina(
                        pileup_by_ctg.get(ctg, []),
                        fa_by_ctg.get(ctg, []),
                        region_index,
                        contig=ctg,
                        qual_cutoff=cfg.qual,
                        print_ref_calls=cfg.print_ref_calls,
                        haploid_precise=cfg.haploid_precise,
                        haploid_sensitive=cfg.haploid_sensitive,
                    )
                )
                continue
            merged.extend(
                merge_pileup_and_full_alignment(
                    pileup_by_ctg.get(ctg, []),
                    fa_by_ctg.get(ctg, []),
                    contig=ctg,
                    qual_cutoff=cfg.qual,
                    print_ref_calls=cfg.print_ref_calls,
                    haploid_precise=cfg.haploid_precise,
                    haploid_sensitive=cfg.haploid_sensitive,
                )
            )
        _merge_t.__exit__(None, None, None)
        with self._timed("sort"):
            merged = self._genotyping_add_back(sort_rows(merged, contig_names))
        with self._timed("write_vcf"):
            self._write_vcf(merge_path, merged, contigs)
        outputs["merge_output"] = merge_path
        with self._timed("gvcf"):
            gvcf_path = self._write_gvcf(merged)
        if gvcf_path:
            outputs["merge_output_gvcf"] = gvcf_path
        self._final_phasing(merged, contig_names, outputs)
        logger.info("[timing] %s", {k: round(v, 2) for k, v in self.stage_times.items()})
        return outputs
