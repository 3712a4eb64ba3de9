"""The port never loads jax, flax, optax or the JAX package `clair3_tpu`:
`python -m clair3_tpu_torch call --device cpu` in a subprocess, on the 3 kb
case of the verify recipe with the committed hifi nets, once where the
import system refuses those packages (a host without them) and once where
they are importable (a GPU host may have jax installed; the port must
still not load it).  With them refused, `train --device cpu` trains a net
from a bin, and `python -m clair3_tpu_torch.full_cascade_demo` runs end to
end at a tiny scale.  The refusal matches the top-level name exactly, so
`clair3_tpu_torch` itself loads.  `train --data_parallel` runs so too, as the
one rank of a group of one.  With them refused, the same call also
runs from the reference's `.pt` files (`models/convert.py`,
`models/schema.py`), as a `--remote_engines` client of a port server
(`serve.py`) and as two `--dist_*` processes that gather their rows, and
`sort_vcf` runs under its own name and the reference's `SortVcf`.  The soak
(`python -m clair3_tpu_torch.wgs_scale_demo`) and the fixture trainer run
so too, at a tiny scale, and so do the bench and its two microbenches (at
their wiring sizes), the graft entry points and the notebook generator."""

import gzip
import os
import subprocess
import sys
import textwrap

import pytest

from clair3_tpu_torch.testing import SimVariant, random_reference, trained_fixture_path, write_test_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = textwrap.dedent("""
    import runpy
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "clair3_tpu")
    attempts = []

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                attempts.append(name)
                raise ModuleNotFoundError(f"{name} is refused in this test")
            return None

    if sys.argv[1] == "refused":
        sys.meta_path.insert(0, Refuse())
    mode, target, args = ((sys.argv[2], sys.argv[3], sys.argv[4:])
                          if sys.argv[2] in ("-m", "-c")
                          else ("-m", "clair3_tpu_torch", sys.argv[2:]))
    sys.argv = [target] + args
    try:
        if mode == "-m":
            runpy.run_module(target, run_name="__main__")
        else:
            exec(target)
        rc = 0
    except SystemExit as exc:
        rc = exc.code or 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print(f"BLOCKED_LOADED={loaded}")
    print(f"IMPORT_ATTEMPTS={sorted(set(attempts))}")
    sys.exit(rc)
""")


def _verify_case(tmp_path):
    ref = random_reference(3000, seed=42)
    variants = [
        SimVariant(600, ref[600], "C" if ref[600] != "C" else "G", (1, 1)),
        SimVariant(1200, ref[1200], "T" if ref[1200] != "T" else "A", (0, 1)),
        SimVariant(1800, ref[1800], ref[1800] + "ACG", (0, 1)),
        SimVariant(2400, ref[2400:2404], ref[2400], (1, 1)),
    ]
    return write_test_case(str(tmp_path), ref_length=3000, variants=variants, coverage=25,
                           read_length=700, seed=42, error_rate=0.02)[:2]


def _port_call(tmp_path, jax_import, fasta, bam, *args):
    """The port's `call` in a subprocess: it succeeds, loads none of the
    refused packages and writes its VCFs."""
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, jax_import, "call", "--bam_fn", bam, "--ref_fn", fasta,
         "--output", str(out), "--platform", "hifi", "--threads", "1", *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_LOADED=[]" in proc.stdout, proc.stdout
    with gzip.open(out / "merge_output.vcf.gz", "rt") as fh:
        rows = [line for line in fh if not line.startswith("#")]
    assert len(rows) >= 4, rows
    assert os.path.getsize(out / "full_alignment.vcf.gz") > 0


PILEUP_NPZ = trained_fixture_path("pileup_hifi.npz")
FA_NPZ = trained_fixture_path("fa_hifi.npz")


@pytest.mark.parametrize("jax_import", ["refused", "installed"])
def test_call_runs_without_jax(tmp_path, jax_import):
    fasta, bam = _verify_case(tmp_path)
    _port_call(tmp_path, jax_import, fasta, bam, "--pileup_model", PILEUP_NPZ,
               "--full_alignment_model", FA_NPZ, "--device", "cpu")


def test_pt_call_runs_without_jax(tmp_path):
    from chip_smoke import write_reference_checkpoints

    fasta, bam = _verify_case(tmp_path)
    models = tmp_path / "models"
    models.mkdir()
    write_reference_checkpoints(PILEUP_NPZ, FA_NPZ, str(models))
    _port_call(tmp_path, "refused", fasta, bam, "--model_path", str(models), "--device", "cpu")


def test_remote_engines_call_runs_without_jax(tmp_path):
    """The client process loads no net and names no device; the port's
    engines answer from this process."""
    import torch

    from clair3_tpu_torch.cli import _load_engine
    from clair3_tpu_torch.serve import EngineServer

    fasta, bam = _verify_case(tmp_path)
    cpu = torch.device("cpu")
    server = EngineServer({
        "pileup": _load_engine(PILEUP_NPZ, "pileup", cpu, torch.float32),
        "full_alignment": _load_engine(FA_NPZ, "full_alignment", cpu, torch.float32)},
        platform="hifi")
    server.serve_background()
    try:
        _port_call(tmp_path, "refused", fasta, bam, "--remote_engines", server.address)
    finally:
        server.shutdown()


def _refused_run(tmp_path, *argv, env=None):
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, "refused", *argv], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})), capture_output=True, text=True,
        timeout=300)
    assert "BLOCKED_LOADED=[]" in proc.stdout, proc.stdout
    return proc


def _train_bin(tmp_path):
    import numpy as np

    from clair3_tpu_torch.config import LABEL_SIZE
    from clair3_tpu_torch.testing import random_counts
    from clair3_tpu_torch.train.data import write_bin

    n = 60
    labels = np.zeros((n, LABEL_SIZE), np.float32)
    labels[np.arange(n), np.arange(n) % 21] = 1.0
    labels[np.arange(n), 21 + np.arange(n) % 3] = 1.0
    write_bin(str(tmp_path / "p.bin"), random_counts(1, (n, 33, 18)), labels,
              [f"chr1:{i + 1}:A" for i in range(n)], ["" for _ in range(n)])
    return str(tmp_path / "p.bin")


def test_train_runs_without_jax(tmp_path):
    proc = _refused_run(tmp_path, "train", "--bin_fn", _train_bin(tmp_path), "--output_dir",
                        str(tmp_path / "m"), "--pileup", "--max_epoch", "1", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(tmp_path / "m" / "best_val_loss.npz")


def test_train_data_parallel_runs_without_jax(tmp_path):
    """One rank: the group of one this process forms (`parallel/mesh.py`)
    and the step's `DistributedDataParallel`."""
    proc = _refused_run(tmp_path, "train", "--bin_fn", _train_bin(tmp_path), "--output_dir",
                        str(tmp_path / "m"), "--pileup", "--max_epoch", "1", "--device", "cpu",
                        "--data_parallel")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(tmp_path / "m" / "best_val_loss.npz")


def test_full_cascade_demo_runs_without_jax(tmp_path):
    """The demo at a tiny scale (8 kb, 1 step a net): it trains, calls and
    scores; its accuracy gates are for the default scale, so it exits 1."""
    env = {"C3T_DEMO_L": "8000", "C3T_DEMO_TRAIN_END": "6000", "C3T_DEMO_STEPS_P": "1",
           "C3T_DEMO_STEPS_F": "1", "C3T_DEMO_BATCH_P": "100", "C3T_DEMO_BATCH_F": "100"}
    proc = _refused_run(tmp_path, "-m", "clair3_tpu_torch.full_cascade_demo",
                        str(tmp_path / "demo"), "hifi", "--device", "cpu", env=env)
    assert proc.returncode in (0, 1), proc.stderr[-3000:]
    assert "F1-score" in proc.stdout and "[full] total" in proc.stdout, proc.stdout[-3000:]
    assert os.path.exists(tmp_path / "demo" / "pileup_model" / "best_val_loss.npz")


def test_soak_runs_without_jax(tmp_path):
    """The soak in production mode at a tiny scale (20 kb, its parity
    slice against the f32 CPU twin included): every gate of the script."""
    proc = _refused_run(tmp_path, "-m", "clair3_tpu_torch.wgs_scale_demo", "--engines",
                        "production", "--device", "cpu", "--mbases", "0.02", "--contigs", "1",
                        "--coverage", "25", "--read_length", "900", "--parity_mbases", "0.01",
                        "--output", str(tmp_path / "soak"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[soak] parity slice OK" in proc.stdout and "[soak] OK" in proc.stdout, proc.stdout


def test_fixture_trainer_runs_without_jax(tmp_path):
    """The fixture trainer at the demo's tiny scale with its gates at 0:
    it trains, calls, scores and freezes."""
    env = {"C3T_DEMO_L": "8000", "C3T_DEMO_TRAIN_END": "6000", "C3T_DEMO_STEPS_P": "1",
           "C3T_DEMO_STEPS_F": "1", "C3T_DEMO_BATCH_P": "100", "C3T_DEMO_BATCH_F": "100",
           "C3T_GATE_SNP": "0", "C3T_GATE_INDEL": "0"}
    proc = _refused_run(tmp_path, "-m", "clair3_tpu_torch.train_fixture_checkpoints",
                        str(tmp_path / "fixture"), "hifi", "--device", "cpu", env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(tmp_path / "fixture" / "pileup_hifi.npz")


_VCF_HEADER = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"


@pytest.mark.parametrize("spelling", ["sort_vcf", "SortVcf"])
def test_sort_vcf_runs_without_jax(tmp_path, spelling):
    """The port's `sort_vcf` and the reference's `SortVcf` spelling of it."""
    shards = tmp_path / "shards"
    shards.mkdir()
    (shards / "a.vcf").write_text(_VCF_HEADER + "chr1\t500\t.\tA\tG\t20\tPASS\t.\tGT\t0/1\n")
    (shards / "b.vcf").write_text(_VCF_HEADER + "chr1\t100\t.\tC\tT\t30\tPASS\t.\tGT\t1/1\n")
    out = tmp_path / "sorted.vcf.gz"
    args = (["sort_vcf", "--input_fn", str(shards / "a.vcf"), str(shards / "b.vcf")]
            if spelling == "sort_vcf" else ["SortVcf", "--input_dir", str(shards)])
    proc = _refused_run(tmp_path, *args, "--output_fn", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with gzip.open(out, "rt") as fh:
        assert [l.split("\t")[1] for l in fh if not l.startswith("#")] == ["100", "500"]


def test_dist_call_runs_without_jax(tmp_path):
    """Two `call --dist_*` processes: the gather of their rows
    (`gather_rowpack`) and everything around it load none of the refused
    packages."""
    import socket

    fasta, bam = _verify_case(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for i in range(2):
        logs.append(tmp_path / f"dist{i}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _DRIVER, "refused", "call", "--bam_fn", bam,
                 "--ref_fn", fasta, "--output", str(tmp_path / "out"), "--platform", "hifi",
                 "--threads", "1", "--chunk_size", "1500", "--pileup_model", PILEUP_NPZ,
                 "--full_alignment_model", FA_NPZ, "--device", "cpu",
                 "--dist_coordinator", f"127.0.0.1:{port}", "--dist_num_processes", "2",
                 "--dist_process_id", str(i)],
                cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO), stdout=log,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        text = log.read_text()
        assert p.returncode == 0, text[-3000:]
        assert "BLOCKED_LOADED=[]" in text and "from 2 processes" in text, text[-3000:]
        assert os.path.exists(tmp_path / "out" / f"proc{i}" / "merge_output.vcf.gz")


@pytest.mark.parametrize("module,env", [
    ("clair3_tpu_torch.bench", {"C3T_BENCH_SMOKE": "1"}),
    ("clair3_tpu_torch.bench_fa_conv1", {"C3T_BENCH_SMOKE": "1"}),
    ("clair3_tpu_torch.bench_history", {"C3T_HISTORY_SMOKE": "1"}),
])
def test_bench_runs_without_jax(tmp_path, module, env):
    """The bench and its two microbenches, each at its wiring size on the
    CPU."""
    proc = _refused_run(tmp_path, "-m", module, "--device", "cpu",
                        env={**env, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[kernels] " in proc.stdout, proc.stdout[-3000:]


def test_graft_entry_runs_without_jax(tmp_path):
    """``entry`` on the CPU and ``dryrun_multichip`` with two gloo ranks (the
    ranks are processes of their own, spawned from this one's modules)."""
    code = ("from clair3_tpu_torch.graft_entry import dryrun_multichip, entry\n"
            "fn, args = entry(device='cpu')\n"
            "assert tuple(fn(*args).shape) == (256, 90)\n"
            "dryrun_multichip(2)\n")
    proc = _refused_run(tmp_path, "-c", code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[dryrun_multichip] n_devices=2" in proc.stdout, proc.stdout[-3000:]


def test_build_notebooks_runs_without_jax(tmp_path):
    """The notebook generator writes all four notebooks (unexecuted, into a
    directory of the test's own)."""
    proc = _refused_run(tmp_path, "-m", "clair3_tpu_torch.build_notebooks", "--no-exec",
                        "--device", "cpu", "--out_dir", str(tmp_path / "nb"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(list((tmp_path / "nb").glob("*.ipynb"))) == 4
