"""The port's copies of the JAX package's framework-free modules stay equal
to their originals.

Each copied file equals its original once the package name is substituted
(``clair3_tpu`` -> ``clair3_tpu_torch``, whole word).  A few files differ on
purpose; for each the differences are named here, as edits applied to the
substituted original, or as the list of definitions that were copied into a
module of the port's own.  When the reference changes, its copy fails here
instead of drifting.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "clair3_tpu")
PORT = os.path.join(REPO, "clair3_tpu_torch")

VERBATIM = [
    "compat.py", "config.py", "gvcf.py", "gvcf_validate.py", "postprocess.py",
    "models/convert.py", "models/schema.py", "models/zoo.py",
    "task/__init__.py", "task/labels.py", "utils/__init__.py",
    "io/__init__.py", "io/arith.py", "io/bai.py", "io/bam.py", "io/bed.py", "io/bgzf.py",
    "io/cram.py", "io/fasta.py", "io/fqzcomp.py", "io/rans.py", "io/rans_nx16.py",
    "io/tok3.py", "io/vcf.py",
    "pileup/__init__.py", "pileup/extractor.py", "fullalign/__init__.py",
    "fullalign/extractor.py", "decode/__init__.py", "decode/decoder.py",
    "pipeline/merge_sort.py", "pipeline/select.py",
    "phase/__init__.py", "phase/external.py", "phase/final_phasing.py",
    "realign/__init__.py", "realign/align.py", "realign/dbg.py", "realign/realigner.py",
    "train/data.py", "train/unify.py",
    "native/common.h", "native/inflate.h",
    "native/clair3t_align.cc", "native/clair3t_arith.cc", "native/clair3t_bzip2.cc",
    "native/clair3t_cram.cc", "native/clair3t_dbg.cc", "native/clair3t_decode.cc",
    "native/clair3t_fullalign.cc", "native/clair3t_gvcf.cc", "native/clair3t_pack.cc",
    "native/clair3t_pileup.cc", "native/clair3t_rans.cc", "native/clair3t_rans_nx16.cc",
    "native/clair3t_xz.cc",
]



def _wrap(opener: str, block: str):
    """The edit that puts ``block`` (whole lines) inside ``with <opener>:``
    at the block's own indentation."""
    indent = block[:len(block) - len(block.lstrip(" "))]
    body = "".join("    " + line if line.strip() else line
                   for line in block.splitlines(keepends=True))
    return block, f"{indent}with {opener}:\n{body}"


def _span(name: str, block: str, opener: str = "span"):
    return _wrap(f'{opener}("{name}")', block)


def _call_span(name: str, block: str):
    return _span(name, block, "host_spans.span")


# file -> the (old, new) edits that turn the substituted original into the copy;
# ("CUT", name) drops the original's definition `name`, ("OWN", name) names a
# top-level definition of the port's own that the original lacks
EDITED = {
    # the override has a name of the port's own; one build under a file lock
    "native/__init__.py": [
        ("import ctypes\nimport os\n", "import ctypes\nimport fcntl\nimport os\n"),
        ("CLAIR3T_NATIVE_SO", "CLAIR3T_TORCH_NATIVE_SO"),
        ("""        return _SO
    # compile to a temp path then rename: concurrent worker processes must
    # never dlopen a half-written .so
    tmp = _SO + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", *_SRCS, "-o", tmp, "-lz",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
""", """        return _SO
    # one build for all processes: the others wait on the lock, then find
    # the library the first one built
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest_src:
            return _SO
        # compile to a temp path then rename: concurrent worker processes must
        # never dlopen a half-written .so
        tmp = _SO + f".tmp.{os.getpid()}"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", *_SRCS, "-o", tmp, "-lz",
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
"""),
        # the phaser's read scan (clair3t_phase.cc has no original)
        ('         os.path.join(_DIR, "clair3t_pack.cc")]\n',
         '         os.path.join(_DIR, "clair3t_pack.cc"),\n'
         '         os.path.join(_DIR, "clair3t_phase.cc")]\n'),
        ("OWN", "_PhaseAllelesOut"), ("OWN", "_bind_phase"), ("OWN", "phase_alleles_native"),
        # the tabix indexer (clair3t_tabix.cc has no original)
        ('         os.path.join(_DIR, "clair3t_phase.cc")]\n',
         '         os.path.join(_DIR, "clair3t_phase.cc"),\n'
         '         os.path.join(_DIR, "clair3t_tabix.cc")]\n'),
        ("OWN", "_TabixOut"), ("OWN", "_bind_tabix"), ("OWN", "tabix_payload_native"),
    ],
    # the index is built in the native library where it is available, under
    # the span vcf.index_native; the Python indexer is the rest of the function
    "io/tabix.py": [
        ("get from the index.\n\"\"\"\n",
         "get from the index.\n\n"
         "``write_tabix_index`` builds the index in the native library where it is\n"
         "available (``native.tabix_payload_native``, one call under the span\n"
         "``vcf.index_native`` of ``clair3_tpu_torch.spans``), else, or where the library\n"
         "declines the file, in Python (``tabix_payload_python``): the same bytes either\n"
         "way, and the Python indexer raises on what it cannot index.\n"
         '"""\n'),
        ("from clair3_tpu_torch.io.bgzf import BgzfWriter\n",
         "from clair3_tpu_torch.io.bgzf import BgzfWriter\n"
         "from clair3_tpu_torch.native import native_available, tabix_payload_native\n"
         "from clair3_tpu_torch.spans import span\n"),
        # the Python indexer returns its payload, which write_tabix_index writes
        ("    with BgzfWriter(tbi_path) as out:\n"
         "        out.write(bytes(payload))\n"
         "    return tbi_path\n",
         "    return payload\n"),
        ('    tbi_path = tbi_path or vcf_gz_path + ".tbi"\n\n'
         "    # walk rows with their virtual offsets\n",
         '    tbi_path = tbi_path or vcf_gz_path + ".tbi"\n'
         "    payload = None\n"
         "    if native_available():\n"
         '        with span("vcf.index_native"):\n'
         "            payload = tabix_payload_native(vcf_gz_path)\n"
         "    if payload is None:\n"
         "        payload = tabix_payload_python(vcf_gz_path)\n"
         "    with BgzfWriter(tbi_path) as out:\n"
         "        out.write(bytes(payload))\n"
         "    return tbi_path\n\n\n"
         "def tabix_payload_python(vcf_gz_path: str) -> bytearray:\n"
         '    """The uncompressed .tbi of a coordinate-sorted BGZF VCF, built in Python."""\n'
         "    # walk rows with their virtual offsets\n"),
    ],
    # enable_compilation_cache imports jax; the decoder needs the rest
    "utils/common.py": [("CUT", "enable_compilation_cache")],
    # the server loads the port's engines on a device; the wire format, the
    # coalescer, the server and the client are the JAX package's
    "serve.py": [
        ('"""Remote inference serving: a TPU-resident engine server + thin client.',
         '"""Remote inference serving: a GPU-resident engine server + thin client.'),
        ("The\nTPU-native equivalent is this pair:", "The\nport's equivalent is this pair:"),
        ("  production engines on the TPU host (bf16 + Pallas + compact wire forms,\n"
         "  exactly `cli call`'s engines)",
         "  production engines on the GPU host (bf16 + CUDA kernels + compact wire\n"
         "  forms, exactly `cli call`'s engines)"),
        ("  forward passes execute on the serving TPU.", "  forward passes execute on the serving GPU."),
        ("submitter thread (jit dispatch already serialized)",
         "submitter thread (one CUDA stream per engine)"),
        ('                 fa_prefix: str = "full_alignment") -> EngineServer:\n'
         '    """Load `cli call`\'s production engines and wrap them in a server."""\n'
         "    from clair3_tpu_torch.cli import _load_engine, resolve_model_file\n",
         '                 fa_prefix: str = "full_alignment",\n'
         '                 device: str = "cuda") -> EngineServer:\n'
         '    """Load `cli call`\'s production engines on ``device`` and wrap them in\n'
         '    a server; ``cuda`` splits each batch over every visible card, and\n'
         '    raises when no GPU is visible."""\n'
         "    from clair3_tpu_torch.cli import _load_engine, resolve_compute_dtype, resolve_model_file\n"
         "    from clair3_tpu_torch.device import resolve_device\n\n"
         "    dev = resolve_device(device)\n"
         "    dt = resolve_compute_dtype(compute_dtype, dev)\n"),
        ("        engines[kind] = _load_engine(path, kind, platform,\n"
         "                                     compute_dtype=compute_dtype)\n",
         "        engines[kind] = _load_engine(path, kind, dev, dt)\n"),
    ],
    # torch.profiler spans inside `call`: every stage a `call.<stage>` span
    # timed on perf_counter, and spans (clair3_tpu_torch/spans.py) for the
    # extraction, its wait, decode, the VCF writer and index, and the
    # phaser's het-SNP selection, whose seconds join stage_times
    "pipeline/call.py": [
        ('InferenceEngine.  Decode is plain Python on the host.\n"""\n',
         "InferenceEngine.  Decode is plain Python on the host.\n\n"
         "Each stage is a ``call.<stage>`` span of ``torch.profiler`` whose duration\n"
         "also lands in ``VariantCaller.stage_times[<stage>]``; inside the stages,\n"
         "spans (``clair3_tpu_torch.spans``) name the extraction on the pool threads\n"
         "(``pileup.extract``, ``fa.extract``), the calling thread's wait for it\n"
         "(``*.extract_wait``), each decode (``*.decode``), the VCF writer and its\n"
         "index (``vcf.write``, ``vcf.index``) and the phaser's het-SNP selection\n"
         "(``phase.select``); with the phaser's and the engines' own spans, their\n"
         "seconds land in ``stage_times`` under the span's name.  One span per stage,\n"
         'chunk, batch or contig: with the profiler off they cost microseconds.\n"""\n'),
        ("import dataclasses\n", "import contextlib\nimport dataclasses\n"),
        ("import numpy as np\n\n",
         "import numpy as np\nfrom torch.profiler import record_function\n\n"
         "from clair3_tpu_torch import spans as host_spans\n"),
        _call_span("pileup.extract",
              "        tensors, pos_infos, alt_infos, res = create_pileup_tensors(\n"
              "            self.cfg.bam_fn,\n"
              "            self.cfg.ref_fn,\n"
              "            task.contig,\n"
              "            task.start,\n"
              "            task.end,\n"
              "            min_mq=self.cfg.min_mq,\n"
              "            min_depth=self.cfg.min_coverage,\n"
              "            min_snp_af=self.cfg.snp_min_af,\n"
              "            min_indel_af=self.cfg.indel_min_af,\n"
              "            max_indel_length=self.cfg.max_indel_length,\n"
              "            call_snp_only=self.cfg.call_snp_only,\n"
              "            gvcf=self.cfg.gvcf,\n"
              "            head_tail=self.cfg.enable_variant_calling_at_sequence_head_and_tail,\n"
              "            threads=per_call,\n"
              "            positions_filter=positions_filter,\n"
              "        )\n"),
        ("    def _bounded_map(pool, fn, items, window: int):\n",
         "    def _bounded_map(pool, fn, items, window: int, wait_span: str):\n"),
        ("        in completed futures; this caps in-flight work at ``window``.\"\"\"\n",
         "        in completed futures; this caps in-flight work at ``window``.\n"
         "        Each wait on the head is a ``wait_span`` span.\"\"\"\n"),
        ("            yield item, fut.result()\n",
         "            with host_spans.span(wait_span):\n"
         "                result = fut.result()\n"
         "            yield item, result\n"),
        ("                window=max(2, self.cfg.threads + 1),\n",
         '                window=max(2, self.cfg.threads + 1), wait_span="pileup.extract_wait",\n'),
        _wrap("host_spans.span(self._decode_span(decode_cfg))",
              "            rows.extend(batch_decode_parallel(\n"
              "                pos_infos, alt_infos, probs, decode_cfg,\n"
              "                processes=self.cfg.threads))\n"),
        _wrap("host_spans.span(self._decode_span(decode_cfg))",
              "        return batch_decode_parallel(pos_infos, alt_infos, probs, decode_cfg,\n"
              "                                     processes=self.cfg.threads)\n"),
        ("                                         processes=self.cfg.threads)\n\n",
         "                                         processes=self.cfg.threads)\n\n"
         "    @staticmethod\n"
         "    def _decode_span(decode_cfg) -> str:\n"
         '        return "pileup.decode" if decode_cfg.pileup else "fa.decode"\n\n'),
        _call_span("fa.extract",
              "            return create_fa_tensors(\n"
              "                self.cfg.bam_fn,\n"
              "                self.cfg.ref_fn,\n"
              "                batch.contig,\n"
              "                batch.positions,\n"
              "                phased_snps=batch.phased_snps,\n"
              "                matrix_depth=self.cfg.matrix_depth,\n"
              "                min_mq=self.cfg.min_mq,\n"
              "                no_phasing=self.cfg.no_phasing_for_fa,\n"
              "                enable_dwell=self.cfg.enable_dwell_time,\n"
              "            )\n"),
        ("                pool, _extract, batches, window=max(2, self.cfg.threads + 1),\n",
         "                pool, _extract, batches, window=max(2, self.cfg.threads + 1),\n"
         '                wait_span="fa.extract_wait",\n'),
        _call_span("vcf.write",
              "        with VcfWriter(path, header, threads=self.cfg.threads) as w:\n"
              "            w.write_rows(rows)\n"),
        _call_span("vcf.index", "            write_tabix_index(path)\n"),
        # the stage clock: a method, one span per stage, on perf_counter
        ("        try:\n"
         "            outputs = self._run_impl()\n"
         "        finally:\n"
         "            self._join_warmups()\n",
         "        self.stage_times: Dict[str, float] = {}\n"
         "        before = host_spans.totals()\n"
         "        try:\n"
         "            outputs = self._run_impl()\n"
         "        finally:\n"
         '            with self._timed("join"):\n'
         "                self._join_warmups()\n"
         "            # the steps inside the stages, on every thread of the process\n"
         "            self.stage_times.update(host_spans.seconds_since(before))\n"),
        ("        reference only had per-job logs from GNU parallel).\n",
         "        reference only had per-job logs from GNU parallel), and beside them\n"
         "        the seconds of each step span (``pileup.decode``, ``phase.reads``,\n"
         "        ``PileupNet.pack``, ...) closed during the call.\n"),
        ("    def _run_impl(self) -> Dict[str, str]:\n"
         "        self.stage_times: Dict[str, float] = {}\n"
         "\n"
         "        def _timed(name):\n"
         "            class _T:\n"
         "                def __enter__(_s):\n"
         "                    _s.t0 = time.time()\n"
         "\n"
         "                def __exit__(_s, *exc):\n"
         "                    self.stage_times[name] = (\n"
         "                        self.stage_times.get(name, 0.0) + time.time() - _s.t0)\n"
         "\n"
         "            return _T()\n"
         "\n",
         "    @contextlib.contextmanager\n"
         "    def _timed(self, name: str):\n"
         '        """One stage: a ``call.<name>`` span on the profiler\'s clock, whose\n'
         '        ``perf_counter`` duration adds to ``stage_times[name]``."""\n'
         '        with record_function("call." + name):\n'
         "            t0 = time.perf_counter()\n"
         "            try:\n"
         "                yield\n"
         "            finally:\n"
         "                self.stage_times[name] = (\n"
         "                    self.stage_times.get(name, 0.0) + time.perf_counter() - t0)\n"
         "\n"
         "    def _run_impl(self) -> Dict[str, str]:\n"),
        ("        self._timed = _timed\n", ""),
        _wrap('self._timed("plan")',
              "        os.makedirs(cfg.output_dir, exist_ok=True)\n"
              "        contigs = self.resolve_contigs()\n"
              "        self._contigs = contigs  # for ##contig header lines\n"
              "        # overlap jit compilation of all batch buckets with extraction\n"
              "        if hasattr(self.pileup_engine, \"warmup_async\"):\n"
              "            self.pileup_engine.warmup_async((NO_OF_POSITIONS, 18), np.int32)\n"
              "        if self.fa_engine is not None and hasattr(self.fa_engine, \"warmup_async\"):\n"
              "            self.fa_engine.warmup_async(\n"
              "                (self.cfg.matrix_depth, NO_OF_POSITIONS, self.cfg.fa_channels),\n"
              "                np.int8)\n"
              "        contig_names = [c for c, _ in contigs]\n"
              "        chunk_size = cfg.chunk_size\n"
              "        if cfg.chunk_num is not None:\n"
              "            # CheckEnvs --chunk_num semantics: N chunks per contig\n"
              "            # (<=0: one whole-contig chunk)\n"
              "            n = max(1, cfg.chunk_num)\n"
              "            longest = max((l for _, l in contigs), default=1)\n"
              "            chunk_size = (longest + n - 1) // n if cfg.chunk_num > 0 else 1 << 40\n"
              "        tasks = plan_chunks(contigs, chunk_size)\n"
              "        if cfg.dist_process_count > 1:\n"
              "            from clair3_tpu_torch.parallel.distributed import own_tasks\n"
              "\n"
              "            tasks = own_tasks(tasks, cfg.dist_process_id,\n"
              "                              cfg.dist_process_count)\n"
              "            logger.info(\"[plan] process %d/%d owns %d chunks\",\n"
              "                        cfg.dist_process_id, cfg.dist_process_count,\n"
              "                        len(tasks))\n"
              "        logger.info(\"[plan] %d contigs, %d chunks\", len(contigs), len(tasks))\n"),
        # --pileup_only: the final filter, VCF and gVCF are stages too
        ("            final_rows = self._genotyping_add_back(self._final_filter(pileup_rows))\n"
         "            self._write_vcf(merge_path, final_rows, contigs)\n"
         "            outputs[\"merge_output\"] = merge_path\n"
         "            gvcf_path = self._write_gvcf(final_rows)\n",
         "            # the final filter is this branch's merge\n"
         "            with self._timed(\"merge\"):\n"
         "                final_rows = self._genotyping_add_back(self._final_filter(pileup_rows))\n"
         "            with self._timed(\"write_vcf\"):\n"
         "                self._write_vcf(merge_path, final_rows, contigs)\n"
         "            outputs[\"merge_output\"] = merge_path\n"
         "            with self._timed(\"gvcf\"):\n"
         "                gvcf_path = self._write_gvcf(final_rows)\n"),
        _wrap('self._timed("route")',
              "        pileup_stats = collect_pileup_stats(pileup_rows)\n"
              "        global_phase_qual = None\n"
              "        if cfg.dist_process_count > 1:\n"
              "            # multi-host: quantile cutoffs must come from EVERY process's\n"
              "            # rows or shards route different candidates than a single\n"
              "            # process (the reference's SelectQual likewise runs over the\n"
              "            # complete pileup VCF, preprocess/SelectQual.py)\n"
              "            from clair3_tpu_torch.parallel.distributed import gather_rowpack\n"
              "            from clair3_tpu_torch.pipeline.select import (cutoffs_from_rowpack,\n"
              "                                                    stats_rowpack)\n"
              "\n"
              "            pack = gather_rowpack(stats_rowpack(pileup_stats, contig_names))\n"
              "            var_qual, ref_qual, global_phase_qual = cutoffs_from_rowpack(\n"
              "                *pack, cfg.var_pct_full, cfg.ref_pct_full,\n"
              "                cfg.var_pct_phasing)\n"
              "        else:\n"
              "            var_qual, ref_qual = select_qual_from_stats(\n"
              "                pileup_stats, cfg.var_pct_full, cfg.ref_pct_full)\n"
              "        logger.info(\"[select] var_qual=%.2f ref_qual=%.2f\", var_qual, ref_qual)\n"),
        _call_span("phase.select",
              "                    het_snps = select_het_snps_from_stats(\n"
              "                        pileup_rows, pileup_stats, phase_qual, ctg)\n"),
    ],
    # spans (clair3_tpu_torch/spans.py) of the phaser's steps, one each per
    # contig; the read scan in the native library where it is available
    "phase/phaser.py": [
        ('in the FA extractor) and ``1|0`` meaning hap1=alt (code 2).\n"""\n',
         "in the FA extractor) and ``1|0`` meaning hap1=alt (code 2).\n\n"
         "``ReadBackedPhaser.phase`` opens one span (``clair3_tpu_torch.spans``) per\n"
         "step of a contig: ``phase.reads`` (fetch, decode and allele scan of its reads),\n"
         "``phase.mec`` (the greedy sweep with the first refinement, and the second\n"
         "refinement) and ``phase.rescue`` (``rescue_phase_sets``).  Where the native\n"
         "library is available the read scan is one call into it\n"
         "(``native.phase_alleles_native``), inside ``phase.reads`` under a span of its\n"
         "own, ``phase.native_scan``: its calls against those of ``phase.reads`` count the\n"
         "contigs that took the native route.  Without the library the reads are fetched\n"
         "and scanned in Python (``BamReader.fetch`` + ``read_alleles_at_snps``), with the\n"
         "same alleles read for read.\n"
         '"""\n'),
        ("from typing import Dict, List, Optional, Sequence, Tuple\n\n",
         "from typing import Dict, List, Optional, Sequence, Tuple\n\n"
         "import numpy as np\n\n"),
        ("from clair3_tpu_torch.io.vcf import VcfRecord\n",
         "from clair3_tpu_torch.io.vcf import VcfRecord\n"
         "from clair3_tpu_torch.native import native_available, phase_alleles_native\n"
         "from clair3_tpu_torch.spans import span\n"),
        ("OWN", "native_read_alleles"),
        ("        bam = BamReader(self.bam_fn)\n"
         "        for read in bam.fetch(ctg_name, positions[0], positions[-1] + 1,\n"
         "                              min_mq=self.min_mq):\n"
         "            alleles = read_alleles_at_snps(read, positions, snp_ref, snp_alt)\n"
         "            for (p1, a1), (p2, a2) in zip(alleles, alleles[1:]):\n"
         "                i, j = index[p1], index[p2]\n"
         "                edge_votes[(i, j)] += 1 if a1 == a2 else -1\n"
         "            if len(alleles) >= 2:\n"
         "                fragments.append([(index[p], a) for p, a in alleles])\n",
         '        with span("phase.reads"):\n'
         "            if native_available():\n"
         "                reads = native_read_alleles(self.bam_fn, ctg_name, snp_ref, snp_alt,\n"
         "                                            self.min_mq)\n"
         "            else:\n"
         "                bam = BamReader(self.bam_fn)\n"
         "                reads = (read_alleles_at_snps(read, positions, snp_ref, snp_alt)\n"
         "                         for read in bam.fetch(ctg_name, positions[0], positions[-1] + 1,\n"
         "                                               min_mq=self.min_mq))\n"
         "            for alleles in reads:\n"
         "                for (p1, a1), (p2, a2) in zip(alleles, alleles[1:]):\n"
         "                    i, j = index[p1], index[p2]\n"
         "                    edge_votes[(i, j)] += 1 if a1 == a2 else -1\n"
         "                if len(alleles) >= 2:\n"
         "                    fragments.append([(index[p], a) for p, a in alleles])\n"),
        _span("phase.mec",
              "        # incoming edges per SNP for the left-to-right sweep\n"
              "        incoming: Dict[int, List[Tuple[int, int]]] = defaultdict(list)\n"
              "        for (i, j), w in edge_votes.items():\n"
              "            incoming[j].append((i, w))\n"
              "\n"
              "        hap: List[Optional[int]] = [None] * len(snps)\n"
              "        phase_set: List[int] = [0] * len(snps)\n"
              "        current_ps = snps[0].pos\n"
              "        hap[0] = 0\n"
              "        phase_set[0] = current_ps\n"
              "        for j in range(1, len(snps)):\n"
              "            vote = 0\n"
              "            for i, w in incoming[j]:\n"
              "                if hap[i] is not None:\n"
              "                    vote += w * (1 - 2 * hap[i])\n"
              "            if vote == 0:\n"
              "                # unconnected (or perfectly ambiguous): new phase set\n"
              "                current_ps = snps[j].pos\n"
              "                hap[j] = 0\n"
              "            else:\n"
              "                hap[j] = 0 if vote > 0 else 1\n"
              "            phase_set[j] = current_ps\n"
              "\n"
              "        hap = refine_mec(hap, fragments)\n"),
        _span("phase.rescue",
              "        hap, phase_set = rescue_phase_sets(hap, phase_set, fragments)\n"),
        _span("phase.mec", "        hap = refine_mec(hap, fragments)\n\n"),
    ],
}

# port module -> (original, the definitions copied into it, edits by name)
DEFINITIONS = {
    # the help text describes the port's backend, not the TPU's
    "cli.py": ("clair3_tpu/cli.py", ["_add_call_args", "_reconcile_dwell",
                                     "resolve_model_file", "_validate_call_inputs",
                                     "cmd_serve", "cmd_tensor2bin",
                                     "cmd_decode_probabilities", "cmd_sort_vcf",
                                     "cmd_merge_vcf", "cmd_dump_tensors", "cmd_split_bam",
                                     "cmd_models", "cmd_metrics", "cmd_validate_gvcf"], {
        "_add_call_args": [
            ('"server (e.g. http://tpu-host:8618); no local "\n'
             '                        "models needed")',
             '"server (e.g. http://gpu-host:8618); no local "\n'
             '                        "models needed, and --device is not used")'),
            ('help="inference compute dtype; auto = bf16 on TPU "\n'
             '                        "(benchmarked production config), fp32 elsewhere")',
             'help="inference compute dtype; auto = bf16 on CUDA, "\n'
             '                        "fp32 on the CPU")'),
            ('help="write a jax.profiler trace', 'help="write a torch.profiler trace'),
            ('help="coordinator address host:port of process 0 "\n'
             '                        "(omit on TPU pod slices with runtime bootstrap)")',
             'help="coordinator address host:port of process 0")'),
        ],
        # the engines load on --device; the kernels need no compilation cache
        "cmd_serve": [
            ("(TPU host side of", "(GPU host side of"),
            ("    from clair3_tpu_torch.utils.common import enable_compilation_cache\n", ""),
            ("so TPU-host operators", "so GPU-host operators"),
            ("    enable_compilation_cache()\n", ""),
            ("fa_model=args.full_alignment_model)",
             "fa_model=args.full_alignment_model,\n        device=args.device)"),
        ]}),
    # the class weights are numpy; the losses are the port's own
    "train/loss.py": ("clair3_tpu/train/loss.py", ["effective_class_weights"], {}),
    # convert.py's main writes .npz through the JAX package's save_variables
    "models/params_io.py": ("clair3_tpu/models/params_io.py", ["save_variables"], {}),
    # the mesh itself is a torch.distributed process group here
    "parallel/mesh.py": ("clair3_tpu/parallel/mesh.py", ["pad_to_multiple"], {}),
    "testing.py": ("clair3_tpu/testing.py", [
        "BASES", "_FA_BASE_FROM_VAL", "SimVariant", "random_reference",
        "_read_from_reference", "simulate_reads", "write_test_case", "PileupOracleEngine",
        "FullAlignmentOracleEngine", "trained_fixture_path",
        "vcf_rows_numerically_equivalent"], {}),
    # simulate() drops its import of the simulator, which is its own module here
    "testing.py#demo": ("scripts/full_cascade_demo.py", ["PLATFORMS", "simulate"], {
        "simulate": [("    from clair3_tpu_torch.testing import SimVariant, random_reference, "
                      "write_test_case\n\n", "")]}),
    # the soak's input simulation, its peak-RSS probe and its VCF reader
    "wgs_scale_demo.py": ("scripts/wgs_scale_demo.py", [
        "SEG", "peak_rss_gb", "build_input", "_vcf_body"], {}),
    "train_fixture_checkpoints.py": ("scripts/train_fixture_checkpoints.py", ["_freeze"], {}),
    # the bench's workload, routing, cascade and decode microbench
    "bench.py": ("bench.py", [
        "GENOME_MB", "N_CHUNKS", "PLATS", "VAR_PCT_FULL", "MATRIX_DEPTH", "make_workload",
        "route_candidates", "run_cascade", "bench_oracle_decode"], {}),
    "visualize_tensor.py": ("scripts/visualize_tensor.py", [
        "PILEUP_CHANNELS", "FA_CHANNELS", "SHADES", "shade", "show_pileup", "show_fa",
        "main"], {}),
    "ops/fa_compact.py": ("clair3_tpu/ops/fa_compact.py", [
        "_pack_base", "pack_fa", "_unpack", "unpack_fa_numpy", "K_BUCKETS", "_SPARSE_CH",
        "pack_fa_sparse", "_unpack_sparse", "unpack_fa_sparse_numpy"], {}),
    "ops/pileup_compact.py": ("clair3_tpu/ops/pileup_compact.py", [
        "_NO_NEG", "pack_pileup", "_unpack", "unpack_pileup_numpy"], {}),
}
# what the port's copies must not carry (jax)
ABSENT = {"ops/fa_compact.py": ["unpack_fa_jax", "unpack_fa_sparse_jax"],
          "ops/pileup_compact.py": ["unpack_pileup_jax"],
          "testing.py": ["FlaxCpuEngine"],
          "utils/common.py": ["enable_compilation_cache"]}


def _sub(text: str) -> str:
    return re.sub(r"\bclair3_tpu\b", "clair3_tpu_torch", text)


def _read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def _definitions(path: str):
    """Top-level name -> its source (decorators included), substituted."""
    src = _read(path)
    lines = src.splitlines(keepends=True)
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
        else:
            continue
        first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        out[name] = _sub("".join(lines[first - 1: node.end_lineno]))
    return out


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_equals_original(rel):
    assert _read(os.path.join(PORT, rel)) == _sub(_read(os.path.join(JAX, rel))), (
        f"clair3_tpu_torch/{rel} drifted from clair3_tpu/{rel}")


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_copy_differs_only_as_named(rel):
    want = _sub(_read(os.path.join(JAX, rel)))
    have = _read(os.path.join(PORT, rel))
    for old, new in EDITED[rel]:
        if old == "OWN":
            # a top-level definition of the port's own, which the original lacks
            assert new not in _definitions(os.path.join(JAX, rel)), f"{rel}: {new} is a copy"
            own = "\n\n" + _definitions(os.path.join(PORT, rel))[new]
            assert own in have, f"{rel}: {new} is not where the file's layout puts it"
            have = have.replace(own, "", 1)
            continue
        if old == "CUT":
            cut = _definitions(os.path.join(JAX, rel))[new]
            old, new = "\n\n" + cut, ""
        assert old in want, f"{rel}: the named edit no longer applies: {old[:80]!r}"
        want = want.replace(old, new)
    assert have == want


@pytest.mark.parametrize("key", sorted(DEFINITIONS))
def test_copied_definitions_equal_originals(key):
    rel = key.split("#")[0]
    original, names, edits = DEFINITIONS[key]
    have = _definitions(os.path.join(PORT, rel))
    want = _definitions(os.path.join(REPO, original))
    for name in names:
        expected = want[name]
        for old, new in edits.get(name, []):
            assert old in expected, f"{name}: the named edit no longer applies"
            expected = expected.replace(old, new)
        assert have.get(name) == expected, f"{rel}::{name} drifted from {original}"
    for name in ABSENT.get(rel, []):
        assert name not in have, f"{rel} carries {name}, which needs jax"


# the parsers of the JAX CLI's main(), as blocks of the port's main();
# `train` names the process group behind --data_parallel and adds --device
PARSER_BLOCKS = {
    "sort_vcf..decode_probabilities": (
        '    sv = sub.add_parser("sort_vcf"',
        '    dp.set_defaults(func=cmd_decode_probabilities)\n', []),
    "dump_tensors..split_bam": ('    dt = sub.add_parser("dump_tensors"',
                                '    sb.set_defaults(func=cmd_split_bam)\n', []),
    "models..validate_gvcf": ('    zl = sub.add_parser(',
                              '    vg.set_defaults(func=cmd_validate_gvcf)\n', []),
    "tensor2bin": ('    t2b = sub.add_parser("tensor2bin"', '    t2b.set_defaults(func=cmd_tensor2bin)\n',
                   []),
    "train": ('    tr = sub.add_parser("train"', '    tr.set_defaults(func=cmd_train)\n', [
        ('                    help="shard batches over all devices via a Mesh")\n',
         '                    help="shard batches over all devices via a process group "\n'
         '                         "(torchrun --nproc_per_node=<cards>, else one rank per "\n'
         '                         "visible GPU)")\n'),
        ('    tr.set_defaults(func=cmd_train)\n',
         '    tr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),\n'
         '                    help="device of the trained net; cuda raises when no GPU "\n'
         '                         "is present")\n'
         '    tr.set_defaults(func=cmd_train)\n'),
    ]),
}


def _block(text, start, end):
    i = text.index(start)
    return text[i: text.index(end, i) + len(end)]


@pytest.mark.parametrize("name", sorted(PARSER_BLOCKS))
def test_parser_blocks_equal_originals(name):
    start, end, edits = PARSER_BLOCKS[name]
    want = _block(_sub(_read(os.path.join(JAX, "cli.py"))), start, end)
    for old, new in edits:
        assert old in want, f"{name}: the named edit no longer applies: {old[:80]!r}"
        want = want.replace(old, new)
    assert _block(_read(os.path.join(PORT, "cli.py")), start, end) == want


# the reference-flag entry point: --device passes on to the port's `call`,
# whose default is the GPU, where the original drops it
ENTRY_EDITS = [
    ("    python run_clair3_tpu.py --bam_fn", "    python run_clair3_tpu_torch.py --bam_fn"),
    ("    # external-tool paths and device selection the reference accepts but the\n"
     "    # single-program design has no use for (value-taking flags)\n"
     '    ignored = {"--pypy", "--python", "--samtools", "--parallel", "--device"}\n',
     "    # external-tool paths the reference accepts but the single-program design\n"
     "    # has no use for (value-taking flags); --device passes on to `call`,\n"
     "    # which runs on the GPU unless it says cpu\n"
     '    ignored = {"--pypy", "--python", "--samtools", "--parallel"}\n'),
]


def test_entry_point_differs_only_as_named():
    want = _sub(_read(os.path.join(REPO, "run_clair3_tpu.py")))
    for old, new in ENTRY_EDITS:
        assert old in want, f"the named edit no longer applies: {old[:80]!r}"
        want = want.replace(old, new)
    assert _read(os.path.join(REPO, "run_clair3_tpu_torch.py")) == want


def test_every_copy_is_listed():
    """Every file of the port that shares a relative path with the JAX
    package is checked above (the port's twins of ``scripts/`` are named in
    DEFINITIONS besides)."""
    listed = set(VERBATIM) | set(EDITED) | {k.split("#")[0] for k, (original, _, _) in
                                            DEFINITIONS.items()
                                            if original.startswith("clair3_tpu/")}
    shared = set()
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cc", ".h")):
                rel = os.path.relpath(os.path.join(root, name), PORT)
                if os.path.exists(os.path.join(JAX, rel)):
                    shared.add(rel)
    # the port's own modules that share a name with the JAX package's
    own = {"__init__.py", "__main__.py", "models/__init__.py", "models/fb.py",
           "models/full_alignment.py",
           "models/pileup.py", "ops/__init__.py", "ops/lstm.py",
           "parallel/__init__.py", "parallel/distributed.py",
           "pipeline/__init__.py", "pipeline/engine.py",
           "train/__init__.py", "train/step.py", "train/trainer.py"}
    assert shared - own == listed, sorted((shared - own) ^ listed)
