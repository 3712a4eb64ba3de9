"""bf16-vs-f32 parity of the port's shipped configuration, the twin of
tests/test_bf16_parity.py, on the CPU.

The port CLI ships bf16 on a GPU (``cli.resolve_compute_dtype``).  The same
cascade runs through ``python -m clair3_tpu_torch call --device cpu`` with
reference-layout ``.pt`` checkpoints (the JAX test's seeded random Clair3_P
and Clair3_F) under ``--compute_dtype fp32`` and ``bf16``, and the output
delta is bounded as the JAX test bounds it: at most 1% of rows change, a
changed row is an f32 argmax near-tie (top-2 margin < 0.02), QUAL moves by
< 1.5 on the others; the pileup engine's probabilities move by < 1e-2.  On
the card, chip_smoke.py phase 3 holds the bf16-vs-f32 bound on the trained
nets.  The JAX file's third test (an explicit --compute_dtype wins over
CLAIR3T_COMPUTE_DTYPE) has its twin in tests/test_torch_cli.py.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from clair3_tpu_torch.cli import _load_engine, main as port_main
from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

CPU = torch.device("cpu")


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [l for l in fh if not l.startswith("#")]


@pytest.fixture(scope="module")
def parity_case(tmp_path_factory):
    """A ~40 kb region with a realistic variant mix, called twice (fp32 and
    bf16) through the port's CLI with reference-layout .pt checkpoints."""
    from tests.test_convert_real_checkpoint import RefClair3F, RefClair3P

    tmp_path = tmp_path_factory.mktemp("bf16")
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    torch.manual_seed(7)
    torch.save(RefClair3P(add_indel_length=False).state_dict(),
               str(model_dir / "pileup.pt"))
    torch.save(RefClair3F(add_indel_length=True).state_dict(),
               str(model_dir / "full_alignment.pt"))

    L = 40_000
    d = tmp_path / "case"
    d.mkdir()
    ref = random_reference(L, seed=31)
    variants = []
    for p in range(600, L - 600, 900):
        kind = p % 3
        if kind == 0:
            variants.append(SimVariant(p, ref[p], "G" if ref[p] != "G" else "T", (0, 1)))
        elif kind == 1:
            variants.append(SimVariant(p, ref[p], ref[p] + "TG", (1, 1)))
        else:
            variants.append(SimVariant(p, ref[p:p + 2], ref[p], (0, 1)))
    fasta, bam, _, _ = write_test_case(
        str(d), ref_length=L, variants=variants, coverage=25,
        read_length=3000, seed=31, error_rate=0.02)

    outputs = {}
    for dtype in ("fp32", "bf16"):
        out = str(tmp_path / f"out_{dtype}")
        os.makedirs(out, exist_ok=True)
        rc = port_main([
            "call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out,
            "--model_path", str(model_dir), "--platform", "ont",
            "--no_phasing_for_fa", "--compute_dtype", dtype, "--device", "cpu",
            "--output_probabilities_fn", os.path.join(out, "probs.tsv"),
        ])
        assert rc == 0
        outputs[dtype] = out
    return outputs


def _top2_margin(path):
    """f32 top-2 gt21 probability margin per position (near-tie detector)."""
    margins = {}
    with open(path) as fh:
        for line in fh:
            pos_info, _, probs_s = line.rstrip("\n").split("\t")
            pos = pos_info.split(":")[-2]
            p = np.sort(np.array(probs_s.split(), np.float64)[:21])
            margins[pos] = min(margins.get(pos, 1.0), float(p[-1] - p[-2]))
    return margins


def test_bf16_cascade_rows_match_f32(parity_case):
    """Final merged rows: bf16 may only flip rows at genuine argmax
    near-ties (f32 top-2 probability margin < 0.02 — untrained random nets
    are tie-dense); total flips bounded at <1%."""
    margins = _top2_margin(os.path.join(parity_case["fp32"], "probs.tsv"))
    for name in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        r32 = _rows(os.path.join(parity_case["fp32"], name))
        r16 = _rows(os.path.join(parity_case["bf16"], name))
        assert len(r32) > 50, f"{name}: parity case produced too few rows"

        def keyed(rows):
            out = {}
            for r in rows:
                c = r.rstrip("\n").split("\t")
                out[c[1]] = (c[3], c[4], c[9].split(":")[0], float(c[5]))
            return out

        k32, k16 = keyed(r32), keyed(r16)
        shared = set(k32) & set(k16)
        diffs = set(k32) ^ set(k16)
        diffs |= {p for p in shared if k32[p][:3] != k16[p][:3]}
        print(f"[port-bf16] {name}: {len(diffs)}/{len(k32)} rows changed under bf16")
        assert len(diffs) <= max(1, len(k32) // 100), (
            f"{name}: {len(diffs)}/{len(k32)} rows changed under bf16")
        hard_flips = [p for p in diffs if margins.get(p, 1.0) > 0.02]
        assert not hard_flips, (
            f"{name}: bf16 flipped decisively-classified rows (f32 margin "
            f">0.02): {[(p, margins.get(p)) for p in hard_flips[:5]]}")
        qual_delta = max(abs(k32[p][3] - k16[p][3])
                         for p in shared if k32[p][:3] == k16[p][:3])
        assert qual_delta < 1.5, f"{name}: max QUAL delta {qual_delta}"


def test_bf16_probability_delta_bounded(parity_case):
    """Head probabilities under bf16 stay within ~1e-2 of f32 (softmax of
    SELU logits is well-conditioned; a blowup here means a kernel bug)."""
    pt = os.path.join(os.path.dirname(parity_case["fp32"]), "models", "pileup.pt")
    rng = np.random.RandomState(3)
    x = rng.randint(-30, 30, size=(64, 33, 18)).astype(np.int32)
    p32 = _load_engine(pt, "pileup", CPU, torch.float32).predict(x)
    p16 = _load_engine(pt, "pileup", CPU, torch.bfloat16).predict(x)
    assert np.max(np.abs(p32 - p16)) < 1e-2
    # int16 transfer narrowing must be lossless for in-range counts
    assert np.all(np.abs(x) < 2 ** 15)

