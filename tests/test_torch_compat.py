"""The reference's submodule spellings through the port's dispatcher
(``python -m clair3_tpu_torch <Submodule>``, ``compat.py``) against the JAX
package's, on the 13 cases of tests/test_compat.py.

Each case runs the JAX package's ``cli.main`` and then the port's in the
same empty working directory, on the same inputs and arguments: the exit
codes are equal, the standard output and error are equal once the
package's name is substituted, and every file written is byte-identical.
The reference tree those cases compare against is not needed: the JAX
package is the reference here.  ``Train`` trains a net in each framework,
so there the checkpoints are held to their names, shapes and finite
values, not to their bytes.
"""

import gzip
import io
import os
import random
import re
import shutil
import sys

import numpy as np
import pytest
import torch
from test_compat import HEADER, _pileup_vcf_text

from clair3_tpu.cli import main as jax_main
from clair3_tpu_torch import cli as port_cli


def _sub(text):
    return re.sub(r"\bclair3_tpu\b", "clair3_tpu_torch", text)


def _snapshot(root):
    files = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, root)] = fh.read()
    return files


def _run(main, argv, work, stdin_text, monkeypatch, capsys):
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    monkeypatch.chdir(work)
    if stdin_text is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    capsys.readouterr()
    rc = main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err, _snapshot(work)


def both(tmp_path, monkeypatch, capsys, argv, stdin_text=None):
    """``argv`` through the JAX dispatcher, then the port's, each in the
    same fresh working directory; returns the port's exit code and files
    after holding them equal to the JAX package's."""
    work = tmp_path / "work"
    want = _run(jax_main, argv, work, stdin_text, monkeypatch, capsys)
    have = _run(port_cli.main, argv, work, stdin_text, monkeypatch, capsys)
    assert have[0] == want[0], (have[2], want[2])
    assert have[1] == _sub(want[1])
    assert have[2] == _sub(want[2])
    assert sorted(have[3]) == sorted(want[3])
    for name, data in want[3].items():
        assert have[3][name] == data, f"{argv[0]}: {name} differs"
    return have[0], have[3]


@pytest.fixture
def inputs(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    return d


@pytest.mark.parametrize("extra", [[], ["--phase"]])
def test_select_qual_compat_matches_jax(tmp_path, monkeypatch, capsys, extra):
    argv = ["SelectQual", "--output_fn", ".", "--var_pct_full", "0.3", "--ref_pct_full", "0.1",
            "--var_pct_phasing", "0.7", *extra]
    rc, files = both(tmp_path, monkeypatch, capsys, argv, stdin_text=_pileup_vcf_text())
    assert rc == 0 and ("phase_qual" if extra else "qual") in files


def test_select_het_snp_compat_matches_jax(tmp_path, monkeypatch, capsys, inputs):
    vcf_fn = inputs / "pileup.vcf"
    vcf_fn.write_text(_pileup_vcf_text(seed=9))
    split = inputs / "split"

    def run(main):
        shutil.rmtree(split, ignore_errors=True)
        split.mkdir()
        (split / "phase_qual").write_text("8.0")  # the pipeline's layout
        return main(["SelectHetSnp", "--vcf_fn", str(vcf_fn), "--split_folder", str(split),
                     "--ctgName", "chr1"])

    assert run(jax_main) == 0
    want = _snapshot(split)
    assert run(port_cli.main) == 0
    assert _snapshot(split) == want and "chr1.vcf" in want


def test_select_candidates_compat_matches_jax(tmp_path, monkeypatch, capsys, inputs):
    vcf_fn = inputs / "pileup.vcf"
    vcf_fn.write_text(_pileup_vcf_text(seed=11, n=300))
    split = inputs / "split"

    def run(main):
        shutil.rmtree(split, ignore_errors=True)
        split.mkdir()
        (split / "qual").write_text("14.0 9.0")
        return main(["SelectCandidates", "--split_folder", str(split), "--pileup_vcf_fn",
                     str(vcf_fn), "--ctgName", "chr1", "--split_bed_size", "40",
                     "--platform", "ont"])

    assert run(jax_main) == 0
    want = _snapshot(split)
    assert run(port_cli.main) == 0
    assert _snapshot(split) == want
    assert any(name.startswith("FULL_ALN_FILE") for name in want)


def test_get_truth_compat_matches_jax(tmp_path, monkeypatch, capsys, inputs):
    rows = ["chr1\t101\t.\tA\tG\t50\tPASS\t.\tGT:GQ\t0/1:50",
            "chr1\t205\t.\tC\tCAT\t44\tPASS\t.\tGT:GQ\t1/1:44",
            "chr1\t390\t.\tGTT\tG\t31\tPASS\t.\tGT:GQ\t1|0:31",
            "chr1\t500\t.\tT\tTA,*\t28\tPASS\t.\tGT:GQ\t1/2:28",
            "chr2\t101\t.\tA\tT\t50\tPASS\t.\tGT:GQ\t0/1:50"]
    vcf_fn = inputs / "truth.vcf"
    vcf_fn.write_text(HEADER + "\n".join(rows) + "\n")
    rc, files = both(tmp_path, monkeypatch, capsys, ["GetTruth", "--vcf_fn", str(vcf_fn),
                                                     "--ctgName", "chr1", "--var_fn", "var.gz"])
    assert rc == 0 and gzip.decompress(files["var.gz"])


def test_split_extend_bed_compat_matches_jax(tmp_path, monkeypatch, capsys, inputs):
    bed_fn = inputs / "in.bed"
    bed_fn.write_text("chr1\t100\t200\nchr1\t220\t300\nchr1\t5000\t6000\nchr2\t10\t50\n")
    rc, files = both(tmp_path, monkeypatch, capsys, ["SplitExtendBed", "--bed_fn", str(bed_fn),
                                                     "--ctgName", "chr1", "--output_fn", "o.bed"])
    assert rc == 0 and files["o.bed"]


def test_merge_bin_compat(tmp_path, monkeypatch, capsys, inputs):
    from clair3_tpu_torch.train.data import read_bin, write_bin

    bins = []
    for i in range(2):
        path = str(inputs / f"b{i}.bin")
        write_bin(path, np.full((3, 33, 18), i, np.int32), np.eye(90, dtype=np.float32)[:3],
                  [f"chr1:{i}00" for _ in range(3)], ["10-" for _ in range(3)])
        bins.append(path)
    rc, _ = both(tmp_path, monkeypatch, capsys, ["MergeBin", *bins, "--out_fn", "merged.bin"])
    assert rc == 0
    assert read_bin(str(tmp_path / "work" / "merged.bin"))[0].shape[0] == 6


def test_sort_vcf_compat_dir_mode(tmp_path, monkeypatch, capsys, inputs):
    d = inputs / "shards"
    d.mkdir()
    (d / "full_alignment_chr1_a.vcf").write_text(HEADER + "chr1\t500\t.\tA\tG\t20\tPASS\t.\tGT\t0/1\n")
    (d / "full_alignment_chr1_b.vcf").write_text(HEADER + "chr1\t100\t.\tC\tT\t30\tPASS\t.\tGT\t1/1\n")
    (d / "other.txt").write_text("ignored\n")
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "SortVcf", "--input_dir", str(d), "--vcf_fn_prefix", "full_alignment",
        "--output_fn", "sorted.vcf.gz"])
    assert rc == 0
    body = [l for l in gzip.decompress(files["sorted.vcf.gz"]).decode().splitlines()
            if not l.startswith("#")]
    assert [int(r.split("\t")[1]) for r in body] == [100, 500]


def test_redirect_submodules(tmp_path, monkeypatch, capsys):
    for name in ("CallVariantsFromCffi", "Tensor2Bin"):
        assert both(tmp_path, monkeypatch, capsys, [name])[0] == 2


def test_train_compat_spelling(tmp_path, monkeypatch, capsys, inputs):
    """`Train` with the reference's spellings (--bin_fn dir, --ochk_prefix,
    --maxEpoch) trains a pileup net in both packages (the port's on the
    CPU: `Train` names no device); the '_20_' bin is held out in both."""
    from clair3_tpu_torch.train.data import write_bin

    bin_dir = inputs / "bins"
    bin_dir.mkdir()
    rng = np.random.default_rng(0)
    x = rng.integers(-20, 20, size=(64, 33, 18)).astype(np.int32)
    y = np.zeros((64, 90), np.float32)
    y[:, rng.integers(0, 21, 64)] = 1.0
    y[:, 21 + rng.integers(0, 3, 64)] = 1.0
    y[:, 24 + 16] = 1.0
    y[:, 57 + 16] = 1.0
    write_bin(str(bin_dir / "sample_1_chr1.bin"), x, y, [f"chr1:{i}" for i in range(64)],
              ["10-"] * 64)
    write_bin(str(bin_dir / "sample_1_20_held.bin"), x[:4], y[:4],
              [f"chr20:{i}" for i in range(4)], ["10-"] * 4)
    monkeypatch.setattr(port_cli, "resolve_device", lambda name: torch.device("cpu"))
    checkpoints = {}
    for label, main in (("jax", jax_main), ("port", port_cli.main)):
        argv = ["Train", "--bin_fn", str(bin_dir), "--ochk_prefix",
                str(tmp_path / label / "ck"), "--maxEpoch", "1", "--pileup", "--platform", "ont"]
        assert main(argv) == 0
        with np.load(tmp_path / label / "best_val_loss.npz") as z:
            checkpoints[label] = {k: z[k] for k in z.files}
    jax_ck, port_ck = checkpoints["jax"], checkpoints["port"]
    assert sorted(port_ck) == sorted(jax_ck)
    for k, v in port_ck.items():
        assert v.shape == jax_ck[k].shape, k
        assert np.isfinite(v).all(), k


def test_merge_vcf_compat_matches_jax(tmp_path, monkeypatch, capsys, inputs):
    rng = random.Random(88)
    pileup_rows = []
    pos = 100
    for _ in range(200):
        pos += rng.randint(3, 40)
        q = round(rng.uniform(0.5, 30), 2)
        gt = rng.choice(["0/0", "0/1", "1/1"])
        ref, alt = ("A", ".") if gt == "0/0" else ("A", "T")
        pileup_rows.append(f"chr1\t{pos}\t.\t{ref}\t{alt}\t{q:.2f}\tPASS\tP\t"
                           f"GT:GQ:DP:AD:AF\t{gt}:{int(q)}:30:15,15:0.5")
    fa_rows = []
    for r in pileup_rows[::3]:
        q = round(rng.uniform(5, 35), 2)
        gt = rng.choice(["0/1", "1/1"])
        fa_rows.append(f"chr1\t{r.split(chr(9))[1]}\t.\tA\tG\t{q:.2f}\tPASS\tF\t"
                       f"GT:GQ:DP:AD:AF\t{gt}:{int(q)}:30:15,15:0.5")
    p_vcf, f_vcf = inputs / "pileup.vcf.gz", inputs / "fa.vcf.gz"
    with gzip.open(p_vcf, "wt") as f:
        f.write(HEADER + "\n".join(pileup_rows) + "\n")
    with gzip.open(f_vcf, "wt") as f:
        f.write(HEADER + "\n".join(fa_rows) + "\n")
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "MergeVcf", "--pileup_vcf_fn", str(p_vcf), "--full_alignment_vcf_fn", str(f_vcf),
        "--output_fn", "merged.vcf", "--ctgName", "chr1", "--qual", "5",
        "--print_ref_calls", "True"])
    assert rc == 0 and b"\tF\t" in files["merged.vcf"]


def _ilmn_case(inputs):
    """tests/test_compat.py's ilmn merge inputs: region shards as
    SelectCandidates writes them, a decoy contig's shard, and pileup/FA
    VCFs whose FA rows are shifted by realignment."""
    rng = random.Random(1234)
    window_anchors = [2000, 5000, 9000]
    prefix = inputs / "candidates"
    prefix.mkdir()
    rows0, rows1 = [], []
    for i, anchor in enumerate(window_anchors):
        start, end = max(anchor - 33, 1), anchor + 1000 + 33
        (rows0 if i % 2 == 0 else rows1).append(f"chr1\t{max(start - 1, 0)}\t{end - 1}")
    (prefix / "chr1.0_2").write_text("\n".join(rows0) + "\n")
    (prefix / "chr1.1_2").write_text("\n".join(rows1) + "\n")
    (prefix / "chr2.0_1").write_text("chr2\t0\t100000\n")

    def vcf_row(pos, qual, gt, ref="A", alt="T", tag="P"):
        if gt == "0/0":
            ref, alt = "A", "."
        return (f"chr1\t{pos}\t.\t{ref}\t{alt}\t{qual:.2f}\tPASS\t{tag}\t"
                f"GT:GQ:DP:AD:AF\t{gt}:{int(qual)}:30:15,15:0.5")

    pileup_rows, fa_rows = [], []
    pos = 150
    while pos < 11_000:
        pos += rng.randint(5, 60)
        q = round(rng.uniform(0.5, 30), 2)
        pileup_rows.append(vcf_row(pos, q, rng.choice(["0/0", "0/1", "1/1"])))
        for anchor in window_anchors:
            if anchor <= pos < anchor + 1000:
                q2 = round(rng.uniform(5, 35), 2)
                fa_rows.append(vcf_row(pos + rng.randint(-3, 3), q2,
                                       rng.choice(["0/1", "1/1"]), alt="G", tag="F"))
    p_vcf, f_vcf = inputs / "pileup.vcf.gz", inputs / "fa.vcf.gz"
    with gzip.open(p_vcf, "wt") as f:
        f.write(HEADER + "\n".join(pileup_rows) + "\n")
    with gzip.open(f_vcf, "wt") as f:
        f.write(HEADER + "\n".join(fa_rows) + "\n")
    return p_vcf, f_vcf, prefix


@pytest.mark.parametrize("extra", [[], ["--print_ref_calls", "True"],
                                   ["--haploid_sensitive", "True"]])
def test_merge_vcf_illumina_compat_matches_jax(tmp_path, monkeypatch, capsys, inputs, extra):
    p_vcf, f_vcf, prefix = _ilmn_case(inputs)
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "MergeVcf", "--pileup_vcf_fn", str(p_vcf), "--full_alignment_vcf_fn", str(f_vcf),
        "--output_fn", "merged.vcf", "--ctgName", "chr1", "--platform", "ilmn", "--qual", "5",
        "--bed_fn_prefix", str(prefix), *extra])
    assert rc == 0
    # the merge did route by region: FA rows in, pileup rows kept outside
    assert b"\tF\t" in files["merged.vcf"] and b"\tP\t" in files["merged.vcf"]


def test_merge_vcf_illumina_multi_contig_no_ctg_name(tmp_path, monkeypatch, capsys, inputs):
    pileup, fa = inputs / "pileup.vcf", inputs / "fa.vcf"
    row = "{}\t{}\t.\tA\tC\t30\tPASS\t{}\tGT:GQ:DP:AF\t0/1:30:20:0.4\n"
    pileup.write_text(row.format("chr1", 15000, "P") + row.format("chr2", 15000, "P"))
    fa.write_text(row.format("chr1", 15000, "F"))
    cand = inputs / "candidates"
    cand.mkdir()
    (cand / "chr1.0_1").write_text("chr1\t14000\t16066\n")
    (cand / "FULL_ALN_FILE_chr1").write_text("chr1.0_1\n")  # not a BED
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "merge_vcf", "--pileup_vcf_fn", str(pileup), "--full_alignment_vcf_fn", str(fa),
        "--output_fn", "merged.vcf.gz", "--platform", "ilmn", "--bed_fn_prefix", str(cand)])
    assert rc == 0
    body = [l for l in gzip.decompress(files["merged.vcf.gz"]).decode().splitlines()
            if not l.startswith("#")]
    assert {(l.split("\t")[0], l.split("\t")[7]) for l in body} == {("chr1", "F"), ("chr2", "P")}


def test_merge_vcf_illumina_no_shards_degrades_to_pileup(tmp_path, monkeypatch, capsys, inputs):
    pileup, fa = inputs / "pileup.vcf", inputs / "fa.vcf"
    pileup.write_text("chr3\t500\t.\tG\tT\t25\tPASS\tP\tGT:GQ:DP:AF\t1/1:25:18:0.9\n")
    fa.write_text("")
    cand = inputs / "candidates"
    cand.mkdir()
    rc, files = both(tmp_path, monkeypatch, capsys, [
        "merge_vcf", "--pileup_vcf_fn", str(pileup), "--full_alignment_vcf_fn", str(fa),
        "--output_fn", "merged.vcf.gz", "--platform", "ilmn", "--ctg_name", "chr3",
        "--bed_fn_prefix", str(cand)])
    assert rc == 0
    body = [l for l in gzip.decompress(files["merged.vcf.gz"]).decode().splitlines()
            if not l.startswith("#")]
    assert len(body) == 1 and body[0].startswith("chr3\t500")
