"""The port CLI's subcommands that run no net (``sort_vcf``, ``merge_vcf``,
``decode_probabilities``, ``dump_tensors``, ``split_bam``, ``models``,
``metrics``, ``validate_gvcf``) and its reference-flag entry point
(``run_clair3_tpu_torch.py``) against the JAX CLI's, on the cases of
tests/test_cli.py.

Every command runs through ``clair3_tpu.cli.main`` and then through
``clair3_tpu_torch.cli.main`` in the same fresh working directory, on the
same input files: exit codes, standard output and error (the package's
name substituted) and every file written are equal, byte for byte.  The
inputs of the merge and scoring commands are the outputs of ``call`` with
the oracle engines, which need no net and no device (the port's ``call``
with ``--device cpu``); those outputs are held byte-identical too.
"""

import gzip
import importlib.util
import os

import numpy as np
import pytest
from test_torch_compat import both

from clair3_tpu.cli import main as jax_main
from clair3_tpu_torch import cli as port_cli
from clair3_tpu_torch.io.vcf import VcfWriter, get_header
from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """tests/test_cli.py's case: 2 kb, a hom and a het SNP at 22x."""
    d = tmp_path_factory.mktemp("cli_tools")
    ref = random_reference(2000, seed=71)
    variants = [SimVariant(600, ref[600], "C" if ref[600] != "C" else "G", (1, 1)),
                SimVariant(1300, ref[1300], "T" if ref[1300] != "T" else "A", (0, 1))]
    fasta, bam, _, _ = write_test_case(str(d), ref_length=2000, variants=variants,
                                       coverage=22, read_length=600, seed=71, error_rate=0.01)
    return {"dir": d, "fasta": fasta, "bam": bam, "variants": variants}


def _oracle_call(cli_case, out, *extra):
    """`call` with the oracle engines through both CLIs (the port's on the
    CPU): the outputs are byte-identical; the port's stay in ``out``."""
    both_out = {}
    for label, main, dev in (("jax", jax_main, []), ("port", port_cli.main, ["--device", "cpu"])):
        path = cli_case["dir"] / f"{out}_{label}"
        assert main(["call", "--bam_fn", cli_case["bam"], "--ref_fn", cli_case["fasta"],
                     "--output", str(path), "--use_oracle_engines", *extra, *dev]) == 0
        both_out[label] = path
    names = sorted(n for n in os.listdir(both_out["jax"]) if n.endswith((".gz", ".tbi")))
    assert names == sorted(n for n in os.listdir(both_out["port"]) if n.endswith((".gz", ".tbi")))
    for name in names:
        assert ((both_out["port"] / name).read_bytes() == (both_out["jax"] / name).read_bytes()), name
    return both_out["port"]


@pytest.fixture(scope="module")
def cascade_out(cli_case):
    return _oracle_call(cli_case, "cascade", "--no_phasing_for_fa", "--var_pct_full", "1.0",
                        "--ref_pct_full", "1.0", "--gvcf")


def test_sort_vcf_matches_jax(cli_case, cascade_out, tmp_path, monkeypatch, capsys):
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "sort_vcf", "--input_fn", str(cascade_out / "pileup.vcf.gz"),
        str(cascade_out / "full_alignment.vcf.gz"), "--output_fn", "sorted.vcf.gz",
        "--ref_fn", cli_case["fasta"]])
    assert rc == 0 and "sorted.vcf.gz.tbi" in files


def test_sort_vcf_gvcf_matches_jax(cli_case, cascade_out, tmp_path, monkeypatch, capsys):
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "sort_vcf", "--gvcf", "--input_fn", str(cascade_out / "merge_output.gvcf.gz"),
        "--output_fn", "sorted.gvcf.gz", "--ref_fn", cli_case["fasta"]])
    assert rc == 0 and "sorted.gvcf.gz" in files


def test_merge_vcf_matches_jax(cli_case, cascade_out, tmp_path, monkeypatch, capsys):
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "merge_vcf", "--pileup_vcf_fn", str(cascade_out / "pileup.vcf.gz"),
        "--full_alignment_vcf_fn", str(cascade_out / "full_alignment.vcf.gz"),
        "--output_fn", "merged.vcf.gz", "--ref_fn", cli_case["fasta"]])
    assert rc == 0 and "merged.vcf.gz.tbi" in files


def test_validate_gvcf_matches_jax(cascade_out, tmp_path, monkeypatch, capsys):
    gvcf = cascade_out / "merge_output.gvcf.gz"
    assert both(tmp_path, monkeypatch, capsys, ["validate_gvcf", "--gvcf_fn", str(gvcf)])[0] == 0
    # a block moved past its successor: both validators fail it alike
    lines = gzip.decompress(gvcf.read_bytes()).decode().splitlines()
    i = next(i for i, l in enumerate(lines)
             if not l.startswith("#") and "\t<NON_REF>\t" in l and int(l.split("\t")[1]) > 500)
    cols = lines[i].split("\t")
    cols[1] = str(int(cols[1]) + 10_000)
    lines[i] = "\t".join(cols)
    broken = cascade_out.parent / "broken.gvcf"
    broken.write_text("\n".join(lines) + "\n")
    assert both(tmp_path, monkeypatch, capsys, ["validate_gvcf", "--gvcf_fn", str(broken)])[0] == 1


def test_metrics_matches_jax(cli_case, tmp_path, monkeypatch, capsys):
    out = _oracle_call(cli_case, "pileup_only", "--pileup_only")
    truth_fn = str(cli_case["dir"] / "truth.vcf")
    with VcfWriter(truth_fn, get_header(reference_file_path=cli_case["fasta"])) as w:
        for v in cli_case["variants"]:
            gt = "1/1" if v.genotype == (1, 1) else "0/1"
            w.write(f"chr1\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\tGT\t{gt}")
    assert both(tmp_path, monkeypatch, capsys, [
        "metrics", "--truth_vcf_fn", truth_fn,
        "--query_vcf_fn", str(out / "merge_output.vcf.gz")])[0] == 0


def test_decode_probabilities_matches_jax(cli_case, tmp_path, monkeypatch, capsys):
    probs = str(cli_case["dir"] / "probs.txt")
    _oracle_call(cli_case, "probs", "--pileup_only", "--output_probabilities_fn", probs)
    for extra in ([], ["--show_ref"]):
        rc, files = both(tmp_path, monkeypatch, capsys, [
            "decode_probabilities", "--probabilities_fn", probs, "--pileup",
            "--output_fn", "rows.txt", *extra])
        assert rc == 0 and files["rows.txt"]
    # --debug prints the heads' probabilities in place of rows
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "decode_probabilities", "--probabilities_fn", probs, "--pileup", "--debug"])
    assert rc == 0 and files == {}


def test_dump_tensors_matches_jax(cli_case, tmp_path, monkeypatch, capsys):
    base = ["dump_tensors", "--bam_fn", cli_case["bam"], "--ref_fn", cli_case["fasta"],
            "--ctg_name", "chr1"]
    rc, files = both(tmp_path, monkeypatch, capsys, [*base, "--tensor_fn", "p_chr1"])
    assert rc == 0
    info = files["p_chr1.npy.info"].decode().splitlines()
    positions = [int(line.split("\t")[0].split(":")[1]) for line in info]
    assert 601 in positions and 1301 in positions
    cands = cli_case["dir"] / "cands.txt"
    cands.write_text("".join(f"{p}\n" for p in positions))
    rc, files = both(tmp_path, monkeypatch, capsys, [
        *base, "--tensor_fn", "f_chr1", "--full_alignment", "--candidates_fn", str(cands),
        "--platform", "hifi"])
    assert rc == 0
    assert np.load(tmp_path / "work" / "f_chr1.npy").shape[1:] == (55, 33, 8)


def test_split_bam_matches_jax(tmp_path, monkeypatch, capsys):
    d = tmp_path / "case"
    d.mkdir()
    ref = random_reference(1500, seed=13)
    v = SimVariant(700, ref[700], "C" if ref[700] != "C" else "G", (0, 1))
    _, bam, _, _ = write_test_case(str(d), ref_length=1500, variants=[v], coverage=24,
                                   read_length=500, seed=13, error_rate=0.0, with_hp_tags=True)
    for extra in ([], ["--include_untagged"]):
        rc, files = both(tmp_path, monkeypatch, capsys, [
            "split_bam", "--bam_fn", bam, "--output_dir", "split", *extra])
        assert rc == 0 and files[os.path.join("split", "hap1.bam")]


def test_models_and_version_match_jax(tmp_path, monkeypatch, capsys):
    assert both(tmp_path, monkeypatch, capsys, ["models"])[0] == 0
    for main in (jax_main, port_cli.main):
        with pytest.raises(SystemExit):
            main(["--version"])
    assert capsys.readouterr().out.splitlines() == ["clair3_tpu 0.3.0", "clair3_tpu_torch 0.3.0"]


def _entry(name):
    spec = importlib.util.spec_from_file_location(name[:-3], os.path.join(REPO, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_clair3_tpu_torch_entry_point(cli_case, tmp_path, monkeypatch):
    """The reference's flag spellings through `run_clair3_tpu_torch.py
    --device cpu` give the files `run_clair3_tpu.py` gives."""
    outs = {}
    for name, device in (("run_clair3_tpu.py", []), ("run_clair3_tpu_torch.py", ["--device", "cpu"])):
        out = str(tmp_path / name)
        monkeypatch.setattr("sys.argv", [
            name, "--bam_fn", cli_case["bam"], "--ref_fn", cli_case["fasta"], "--output", out,
            "--ctgName", "chr1", "--use_oracle_engines", "--pileup_only",
            "--fast_mode", "False", *device])
        assert _entry(name).main() == 0
        outs[name] = out
    for vcf in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        with open(os.path.join(outs["run_clair3_tpu.py"], vcf), "rb") as a, \
                open(os.path.join(outs["run_clair3_tpu_torch.py"], vcf), "rb") as b:
            assert a.read() == b.read(), vcf
