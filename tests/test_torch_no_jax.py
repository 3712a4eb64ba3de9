"""The port never loads jax, flax, optax or the JAX package `clair3_tpu`:
`python -m clair3_tpu_torch call --device cpu` in a subprocess, on the 3 kb
case of the verify recipe with the committed hifi nets, once where the
import system refuses those packages (a host without them) and once where
they are importable (a GPU host may have jax installed; the port must
still not load it).  The refusal matches the top-level name exactly, so
`clair3_tpu_torch` itself loads."""

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
    sys.argv = ["clair3_tpu_torch"] + sys.argv[2:]
    try:
        runpy.run_module("clair3_tpu_torch", run_name="__main__")
        rc = 0
    except SystemExit as exc:
        rc = exc.code or 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print(f"BLOCKED_LOADED={loaded}")
    print(f"IMPORT_ATTEMPTS={sorted(set(attempts))}")
    sys.exit(rc)
""")


@pytest.mark.parametrize("jax_import", ["refused", "installed"])
def test_call_runs_without_jax(tmp_path, jax_import):
    ref = random_reference(3000, seed=42)
    variants = [
        SimVariant(600, ref[600], "C" if ref[600] != "C" else "G", (1, 1)),
        SimVariant(1200, ref[1200], "T" if ref[1200] != "T" else "A", (0, 1)),
        SimVariant(1800, ref[1800], ref[1800] + "ACG", (0, 1)),
        SimVariant(2400, ref[2400:2404], ref[2400], (1, 1)),
    ]
    fasta, bam, _, _ = write_test_case(str(tmp_path), ref_length=3000,
                                       variants=variants, coverage=25,
                                       read_length=700, seed=42, error_rate=0.02)
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, jax_import, "call", "--bam_fn", bam, "--ref_fn", fasta,
         "--output", str(out), "--platform", "hifi", "--threads", "1",
         "--pileup_model", trained_fixture_path("pileup_hifi.npz"),
         "--full_alignment_model", trained_fixture_path("fa_hifi.npz"),
         "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_LOADED=[]" in proc.stdout, proc.stdout
    with gzip.open(out / "merge_output.vcf.gz", "rt") as fh:
        rows = [line for line in fh if not line.startswith("#")]
    assert len(rows) >= 4, rows
    assert os.path.getsize(out / "full_alignment.vcf.gz") > 0
