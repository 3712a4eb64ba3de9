"""Multi-process calling in the port (``parallel/distributed.py`` over
``torch.distributed``, gloo, on the CPU).

* ``own_tasks`` strides chunks into a disjoint cover.
* ``gather_rowpack`` over 2 and 3 processes, with unequal shards and an
  empty one, returns every process's rows in process order, the float64
  quals bit for bit; the routing cutoffs of the gather are those of the
  concatenation.  With no process group it returns the pack itself.
* ``init_distributed`` keeps a process group joined before and raises when
  its size is not the one asked for.
* ``python -m clair3_tpu_torch call --device cpu --dist_*`` in 2 and in 4 OS
  processes, with the committed trained nets and ``--gvcf``, on the 24 kb
  hifi case of tests/test_distributed.py (``--chunk_size 6000``) and on a
  30 kb hifi region of the held-out seed 91 (``--chunk_size 7500``, where
  phasing crosses chunk edges): ``sort_vcf`` over their VCFs and ``sort_vcf
  --gvcf`` over their gVCFs give one port process's merged VCF and gVCF,
  full text and header included, and the rows are those of one JAX process
  within ``vcf_rows_numerically_equivalent`` with no routing flip.
* Genotyping mode under ``--dist_*`` (2 processes, the 24 kb case with a
  ``--vcf_fn`` of its simulated variants): the merged VCF and gVCF are one
  process's, byte for byte, and, as there, no known site is added back as
  a ``./.`` row (each process adds back only the known sites of its own
  chunks).
* ``--use_phasing_for_final_output --use_haplotagging_for_final_output``
  under ``--dist_*`` (2 processes, the 30 kb seed-91 case): the merged
  ``phased_merge_output.vcf.gz`` is one process's, byte for byte (each
  contig phased whole), process 0's ``phased_output.bam`` carries one
  process's ``HP``/``PS`` tags on every read, and process 1 writes no BAM.

Child processes write to files, not pipes, and every wait has a timeout.
"""

import functools
import gzip
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

from clair3_tpu.testing import vcf_rows_numerically_equivalent
from clair3_tpu_torch.cli import main as port_main
from clair3_tpu_torch.parallel.distributed import gather_rowpack, init_distributed, own_tasks
from clair3_tpu_torch.pipeline.select import cutoffs_from_rowpack
from clair3_tpu_torch.testing import (SimVariant, random_reference, simulate, trained_fixture_path,
                                      write_test_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, log_path, cwd):
    log = open(log_path, "w")
    try:
        return subprocess.Popen([sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
                                cwd=str(cwd), env=dict(os.environ, PYTHONPATH=REPO))
    finally:
        log.close()


def _wait_all(procs, logs, what):
    """Wait for every process; on a timeout or a failure, kill the rest."""
    try:
        for p, log in zip(procs, logs):
            p.wait(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"{what} failed:\n{open(log).read()[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_own_tasks_disjoint_cover():
    tasks = list(range(17))
    parts = [own_tasks(tasks, i, 4) for i in range(4)]
    assert sorted(t for p in parts for t in p) == tasks
    assert all(len(p) in (4, 5) for p in parts)
    assert own_tasks(tasks, 0, 1) == tasks


def test_known_sites_have_one_owner():
    """Genotyping mode's add-back: each known site is added back by exactly
    one of 3 processes, the owner of the chunk holding it; a site that no
    chunk holds (past a contig's end, or on a contig not called) by
    process 0."""
    from types import SimpleNamespace

    from clair3_tpu_torch.parallel.distributed import DistributedCaller
    from clair3_tpu_torch.pipeline.call import plan_chunks

    contigs = [("chr1", 2500), ("chr2", 900)]
    tasks = plan_chunks(contigs, 400)
    callers = []
    for p in range(3):
        c = DistributedCaller.__new__(DistributedCaller)
        c.cfg, c._contigs = SimpleNamespace(dist_process_id=p), contigs
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("clair3_tpu_torch.pipeline.call.VariantCaller.run_pileup",
                       lambda self, t: [])
            c.run_pileup(own_tasks(tasks, p, 3))
        callers.append(c)
    sites = [("chr1", pos) for pos in range(0, 2503)] + [("chr2", pos) for pos in (1, 900, 901)]
    sites.append(("chr3", 5))
    for chrom, pos in sites:
        owners = [p for p, c in enumerate(callers) if c._owns_site(chrom, pos)]
        held = [i for i, t in enumerate(tasks) if t.contig == chrom and t.start <= pos <= t.end]
        assert owners == ([held[0] % 3] if held else [0]), (chrom, pos, owners)


GATHER_WORKER = textwrap.dedent("""
    import sys

    import numpy as np
    import torch.distributed as dist

    from clair3_tpu_torch.parallel.distributed import gather_rowpack, init_distributed

    port, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    n = [int(x) for x in sys.argv[5].split(",")][rank]
    rng = np.random.default_rng(100 + rank)
    # full-mantissa quals: a float32 round trip would change every one
    qual = rng.random(n) * 60
    if n:
        qual[0] = np.nextafter(30.0, 31.0)
    pack = (np.full(n, rank, np.uint32),
            np.sort(rng.choice(1 << 30, n, replace=False)).astype(np.uint32), qual,
            rng.integers(0, 4, n).astype(np.uint32))
    assert init_distributed(f"127.0.0.1:{port}", world, rank) == (rank, world)
    try:
        got = gather_rowpack(pack)
    finally:
        dist.destroy_process_group()
    np.savez(out, *pack, *got)
""")


@pytest.mark.parametrize("lengths", [(7, 0), (5, 0, 9)], ids=["2proc", "3proc"])
def test_gather_rowpack_over_gloo(tmp_path, lengths):
    world = len(lengths)
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    logs = [str(tmp_path / f"rank{r}.log") for r in range(world)]
    procs = [_spawn(["-c", GATHER_WORKER, str(port), str(r), str(world), outs[r],
                     ",".join(map(str, lengths))], logs[r], tmp_path) for r in range(world)]
    _wait_all(procs, logs, "gather worker")
    packs, gathers = [], []
    for out in outs:
        with np.load(out) as z:
            arrays = [z[f"arr_{i}"] for i in range(8)]
        packs.append(arrays[:4])
        gathers.append(arrays[4:])
    want = [np.concatenate([p[i] for p in packs]) for i in range(4)]
    assert len(want[0]) == sum(lengths)
    for got in gathers:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert np.array_equal(got[2].view(np.int64), want[2].view(np.int64))
        assert np.array_equal(got[3], want[3])
        assert (cutoffs_from_rowpack(*got, 0.3, 0.3, 0.7)
                == cutoffs_from_rowpack(*want, 0.3, 0.3, 0.7))


def test_gather_rowpack_without_a_group_is_the_identity():
    assert not dist.is_initialized()
    pack = (np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32), np.ones(2), np.zeros(2, np.uint32))
    assert gather_rowpack(pack) is pack


def test_init_distributed_raises_on_world_size_mismatch():
    addr = f"127.0.0.1:{_free_port()}"
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="num_processes=2 .* world_size=1"):
            init_distributed(addr, 2, 0)
        assert init_distributed(addr, 1, 0) == (0, 1)
    finally:
        dist.destroy_process_group()


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


def _text(path):
    with gzip.open(path, "rt") as fh:
        return fh.read()


NETS = ["--platform", "hifi", "--threads", "2", "--gvcf",
        "--pileup_model", trained_fixture_path("pileup_hifi.npz"),
        "--full_alignment_model", trained_fixture_path("fa_hifi.npz")]


def _seed93_case(tmp):
    """tests/test_distributed.py's 24 kb case, in 6 kb chunks."""
    L = 24_000
    ref = random_reference(L, seed=93)
    variants = []
    for p in range(600, L - 600, 900):
        kind = (p // 900) % 3
        if kind == 0:
            variants.append(SimVariant(p, ref[p], "A" if ref[p] != "A" else "C", (0, 1)))
        elif kind == 1:
            variants.append(SimVariant(p, ref[p], ref[p] + "GT", (1, 1)))
        else:
            variants.append(SimVariant(p, ref[p:p + 2], ref[p], (0, 1)))
    fasta, bam, _, _ = write_test_case(str(tmp), ref_length=L, variants=variants, coverage=20,
                                       read_length=900, seed=93, error_rate=0.02)
    return fasta, bam, variants, ["--chunk_size", "6000"]


def _seed91_case(tmp):
    """A 30 kb hifi region of the held-out simulator seed (91), in 7.5 kb
    chunks, with the routing of the trained-fixture cascade: full-alignment
    candidates near a chunk edge are phased with het SNPs of the
    neighbouring chunk, which another process owns."""
    fasta, bam, _, variants = simulate(str(tmp), 30_000, seed=91)
    return fasta, bam, variants, ["--chunk_size", "7500", "--indel_min_af", "0.12",
                                  "--var_pct_full", "0.3", "--ref_pct_full", "0.3"]


@pytest.fixture(scope="module", params=["seed93", "seed91"])
def case(request, tmp_path_factory):
    """A region called by one port process (an OS process, as the dist runs
    are) and by one JAX process (this one, its engines compiled for two
    batch buckets)."""
    import clair3_tpu.pipeline.engine as jax_engine
    from clair3_tpu.cli import main as jax_main

    tmp = tmp_path_factory.mktemp(f"dist_cli_{request.param}")
    fasta, bam, variants, extra = {"seed93": _seed93_case,
                                   "seed91": _seed91_case}[request.param](tmp)
    args = ["--bam_fn", bam, "--ref_fn", fasta, *NETS, *extra]
    single = tmp / "single"
    p = _spawn(["-m", "clair3_tpu_torch", "call", *args, "--device", "cpu",
                "--output_dir", str(single)], str(tmp / "single.log"), tmp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "InferenceEngine",
                   functools.partial(jax_engine.InferenceEngine, buckets=(256, 1024)))
        assert jax_main(["call", *args, "--output_dir", str(tmp / "jax")]) == 0
    _wait_all([p], [str(tmp / "single.log")], "single-process port call")
    return {"fasta": fasta, "bam": bam, "variants": variants, "args": args, "single": single,
            "jax": tmp / "jax"}


@pytest.mark.parametrize("n_procs", [2, 4])
def test_dist_cli_os_processes_merge_identically(case, tmp_path, n_procs):
    port = _free_port()
    dist_dir = tmp_path / "dist"
    logs = [str(tmp_path / f"dist{i}.log") for i in range(n_procs)]
    procs = [_spawn(["-m", "clair3_tpu_torch", "call", *case["args"], "--device", "cpu",
                     "--output_dir", str(dist_dir), "--dist_coordinator", f"127.0.0.1:{port}",
                     "--dist_num_processes", str(n_procs), "--dist_process_id", str(i)],
                    logs[i], tmp_path) for i in range(n_procs)]
    _wait_all(procs, logs, "dist call")
    for i, log in enumerate(logs):
        text = open(log).read()
        assert f"[plan] process {i}/{n_procs} owns" in text, text
        assert f"from {n_procs} processes" in text, text  # the cutoffs' gather ran

    merged = {}
    for name, extra in (("merge_output.vcf.gz", []), ("merge_output.gvcf.gz", ["--gvcf"])):
        shards = [str(dist_dir / f"proc{i}" / name) for i in range(n_procs)]
        for shard in shards:
            assert _rows(shard), f"{shard}: no rows"
        merged[name] = str(tmp_path / f"merged_{name}")
        assert port_main(["sort_vcf", "--input_fn", *shards, "--output_fn", merged[name],
                          "--ref_fn", case["fasta"], *extra]) == 0
        assert _text(merged[name]) == _text(case["single"] / name), name

    vcf_rows = _rows(merged["merge_output.vcf.gz"])
    gvcf_rows = _rows(merged["merge_output.gvcf.gz"])
    assert len(vcf_rows) > 10 and len(gvcf_rows) > len(vcf_rows)
    for name, rows in (("merge_output.vcf.gz", vcf_rows), ("merge_output.gvcf.gz", gvcf_rows)):
        ok, stats = vcf_rows_numerically_equivalent(_rows(case["jax"] / name), rows,
                                                    flip_budget=0.0)
        assert ok, (name, stats["violations"])


def _single_and_pair(case, tmp_path, *extra):
    """One port process and a pair of ``--dist_*`` processes, all started
    together, with ``extra`` arguments; returns their output directories."""
    port = _free_port()
    single, dist_dir = tmp_path / "single", tmp_path / "dist"
    argvs = [["--output_dir", str(single)]] + [
        ["--output_dir", str(dist_dir), "--dist_coordinator", f"127.0.0.1:{port}",
         "--dist_num_processes", "2", "--dist_process_id", str(i)] for i in range(2)]
    logs = [str(tmp_path / f"run{i}.log") for i in range(3)]
    procs = [_spawn(["-m", "clair3_tpu_torch", "call", *case["args"], "--device", "cpu",
                     *extra, *argv], log, tmp_path) for argv, log in zip(argvs, logs)]
    _wait_all(procs, logs, "call")
    return single, [dist_dir / f"proc{i}" for i in range(2)]


def _merged_text(case, tmp_path, shards, name, *extra):
    out = str(tmp_path / f"merged_{name}")
    assert port_main(["sort_vcf", "--input_fn", *map(str, shards), "--output_fn", out,
                      "--ref_fn", case["fasta"], *extra]) == 0
    return _text(out)


def _added_back_rows(text):
    """Genotyping mode's rows for a known site that was not called."""
    return [r for r in text.splitlines()
            if not r.startswith("#") and r.split("\t")[4] == "." and r.endswith("\t./.")]


@pytest.mark.parametrize("case", ["seed93"], indirect=True)
def test_dist_genotyping_adds_back_only_own_sites(case, tmp_path):
    from clair3_tpu_torch.io.vcf import VcfRecord, VcfWriter, get_header

    known = str(tmp_path / "known.vcf")
    with VcfWriter(known, get_header(contigs=[("chr1", 24_000)])) as w:
        for v in case["variants"]:
            w.write(VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                              "1/1" if v.genotype == (1, 1) else "0/1"))
    single, procs = _single_and_pair(case, tmp_path, "--vcf_fn", known)
    for name, extra in (("merge_output.vcf.gz", []), ("merge_output.gvcf.gz", ["--gvcf"])):
        want = _text(single / name)
        merged = _merged_text(case, tmp_path, [p / name for p in procs], name, *extra)
        print(f"[dist] genotyping {name}: {len(_rows(single / name))} rows, ./. rows added "
              f"back: single {len(_added_back_rows(want))}, merged "
              f"{len(_added_back_rows(merged))}")
        assert merged == want, name
        assert not _added_back_rows(want), name
    assert len(_rows(single / "merge_output.vcf.gz")) == len(case["variants"])


def _tags(bam):
    from clair3_tpu_torch.io.bam import BamReader

    return sorted((r.qname, r.flag, r.pos, r.tags.get("HP"), r.tags.get("PS"))
                  for r in BamReader(str(bam)))


@pytest.mark.parametrize("case", ["seed91"], indirect=True)
def test_dist_final_phasing_phases_whole_contigs(case, tmp_path):
    single, procs = _single_and_pair(case, tmp_path, "--use_phasing_for_final_output",
                                     "--use_haplotagging_for_final_output")
    name = "phased_merge_output.vcf.gz"
    want = _text(single / name)
    merged = _merged_text(case, tmp_path, [p / name for p in procs], name)
    sets = {r.split("\t")[9].split(":")[-1] for r in want.splitlines()
            if not r.startswith("#") and "|" in r.split("\t")[9]}
    print(f"[dist] final phasing: {len(_rows(single / name))} rows, phase sets {sorted(sets)}")
    assert sets and merged == want
    assert not (procs[1] / "phased_output.bam").exists()
    want_tags = _tags(single / "phased_output.bam")
    assert any(t[3] for t in want_tags)
    assert _tags(procs[0] / "phased_output.bam") == want_tags
