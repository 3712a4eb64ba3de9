"""The reference against the port at float32 on the CPU, under the
comparison the harness uses, and what a single wrong row does to it."""

import ast
import dataclasses
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.tests.helpers import REPO, SEED, TINY, make_root

CELLS = {"tiny-hifi-call": ("clair3-hifi", "fixture-hifi-call", TINY),
         "tiny-ont-fa": ("clair3-ont", "fixture-ont-fa", dict(TINY, contig_bp=8000)),
         "tiny-pileup-only": ("clair3-hifi", "fixture-hifi-pileup-only", TINY)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("root")), CELLS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_agrees_with_the_port_at_f32(root, cell):
    from benchmark.harness import run_cell

    result, rec = run_cell(cell, SEED, 0.5, False, "cpu", 0.0, threads=2, workers=2, root=root)
    assert result["correct"], result["checks"]
    assert rec["candidates"] > 100
    checks = result["checks"]
    assert checks["pileup_logp_gap"]["value"] < 1e-4
    if cell != "tiny-pileup-only":
        assert rec["fa_rows"] > 10
        assert checks["fa_logp_gap"]["value"] < 1e-4
    assert ("phasing_differ" in checks) == (cell == "tiny-hifi-call")


def _one_pass(root, cell, work):
    from benchmark.harness import build, run_pass
    from benchmark.reference.check import PortPass

    s = build(cell, SEED, "cpu", work, threads=2, root=root)
    out = os.path.join(work, "pass")
    p = run_pass(s, out)
    return s, PortPass(out, s.pileup.inputs, s.pileup.pass_probs(), s.fa.inputs,
                       s.fa.pass_probs(), p["phase_calls"])


def _compare(s, port):
    from benchmark.reference.check import compare
    from benchmark.reference.nets import FullAlignmentRef, PileupRef, load_weights

    return compare(port, s.flags, s.inp.bam, s.inp.fasta, s.inp.contigs,
                   PileupRef(load_weights(s.paths["pileup"])),
                   FullAlignmentRef(load_weights(s.paths["full_alignment"])), SEED, 2)


def _rewrite(path, fn):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines(keepends=True)
    with gzip.open(path, "wt") as fh:
        fh.writelines(fn(lines))


def _flip_first_variant(lines):
    out, done = [], False
    for line in lines:
        cols = line.split("\t")
        if not done and not line.startswith("#") and cols[9].startswith("0/1"):
            cols[9] = "1/1" + cols[9][3:]
            line, done = "\t".join(cols), True
        out.append(line)
    assert done
    return out


def test_a_flipped_genotype_fails(root, tmp_path):
    s, port = _one_pass(root, "tiny-hifi-call", str(tmp_path))
    clean = _compare(s, port)
    assert all(v == 0 for k, v in clean.items() if k.endswith("_differ")), clean
    _rewrite(os.path.join(port.out_dir, "merge_output.vcf.gz"), _flip_first_variant)
    assert _compare(s, port)["final_rows_differ"] >= 1
    _rewrite(os.path.join(port.out_dir, "pileup.vcf.gz"), _flip_first_variant)
    assert _compare(s, port)["pileup_rows_differ"] >= 1


def test_a_changed_tensor_or_probability_fails(root, tmp_path):
    s, port = _one_pass(root, "tiny-hifi-call", str(tmp_path))
    x = port.pileup_inputs[0].copy()
    x[len(x) // 2, 16, 0] += 1
    probs = [p.copy() for p in port.fa_probs]
    probs[0][:, :21] = probs[0][:, :21][:, ::-1]
    bad = dataclasses.replace(port, pileup_inputs=[x] + port.pileup_inputs[1:], fa_probs=probs)
    got = _compare(s, bad)
    assert got["pileup_tensors_differ"] == 1
    assert got["fa_logp_gap"] > 2.5


def test_pileup_pieces_equal_the_whole_contig(tmp_path):
    from benchmark.gen.traffic import make_input
    from benchmark.reference.check import PIECE_BP, _pileup_piece, call_config

    traffic = json.load(open(os.path.join(REPO, "benchmark", "cells", "fixture-hifi-call.json")))
    traffic.update(contigs=1, contig_bp=3 * 7000 + 123)
    inp = make_input(traffic, SEED, str(tmp_path))
    cfg = call_config(traffic["call_flags"], inp.bam, inp.fasta)
    L = inp.contigs[0][1]
    whole = _pileup_piece((cfg, "chr1", 1, L))
    parts = [_pileup_piece((cfg, "chr1", s + 1, min(L, s + 7000))) for s in range(0, L, 7000)]
    assert np.array_equal(whole[0], np.concatenate([p[0] for p in parts]))
    assert whole[1] == sum((p[1] for p in parts), [])
    assert whole[2] == sum((p[2] for p in parts), [])
    assert PIECE_BP >= 10_000


def test_fa_rows_do_not_depend_on_their_batch(tmp_path):
    from benchmark.gen.traffic import make_input
    from benchmark.reference.check import _fa_extract, _pileup_piece, call_config

    traffic = json.load(open(os.path.join(REPO, "benchmark", "cells", "fixture-ont-fa.json")))
    traffic.update(contigs=1, contig_bp=6000)
    inp = make_input(traffic, SEED, str(tmp_path))
    cfg = call_config(traffic["call_flags"], inp.bam, inp.fasta)
    _, pos_infos, _ = _pileup_piece((cfg, "chr1", 1, 6000))
    positions = [int(p.split(":")[1]) for p in pos_infos]
    whole = _fa_extract((cfg, "chr1", positions, []))
    pick = positions[3::7]
    part = _fa_extract((cfg, "chr1", pick, []))
    idx = [positions.index(p) for p in pick]
    assert np.array_equal(whole[0][idx], part[0])
    assert [whole[2][i] for i in idx] == part[2]


def test_no_forbidden_module_after_a_pass(root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import run_cell, forbidden_modules\n"
        "run_cell('tiny-pileup-only', %d, 0.2, False, 'cpu', 0.0, threads=1, workers=1, root=%r)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % (REPO, SEED, root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "clair3_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "clair3_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.check, benchmark.reference.nets, benchmark.gen.traffic\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"clair3_tpu_torch", "clair3_tpu", "jax", "flax"}
    for base in ("reference", "gen"):
        for dirpath, _, files in os.walk(os.path.join(REPO, "benchmark", base)):
            for f in files:
                if not f.endswith(".py"):
                    continue
                tree = ast.parse(open(os.path.join(dirpath, f)).read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                             else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    assert not any(n.split(".")[0].startswith("clair3_tpu") for n in names), f
