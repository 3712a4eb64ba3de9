"""The comparison has to fail: the fp8 control in the program's place, and
the timed path broken underneath a whole run (the harness's look for a
chip skipped, the rest of the run as the benchmark runs it).  The faults
are those a cell of this benchmark can have: part of each batch left out
(its rows given the mean of the rest), an answer altered where it is
produced (one probability row; one genotype as the decoder writes it), and
a stage that returns its input unchanged (the phaser).  Every cell runs on
one chip, so there is no exchange between chips to leave out."""

import numpy as np
import pytest
import torch

from benchmark.control import fp8_engines
from benchmark.tests.helpers import SEED, TINY, make_root

CELLS = {"tiny-hifi-call": ("clair3-hifi", "fixture-hifi-call", TINY),
         "tiny-ont-fa": ("clair3-ont", "fixture-ont-fa", dict(TINY, contig_bp=8000)),
         "tiny-pileup-only": ("clair3-hifi", "fixture-hifi-pileup-only", TINY)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("root")), CELLS)


def _run(root, cell, **kw):
    from benchmark.harness import run_cell

    result, _ = run_cell(cell, SEED, 0.5, False, "cpu", 0.0, threads=2, workers=2,
                         root=root, **kw)
    return result


class Broken:
    """The port's engine with a fault planted in what it returns."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault
        self.fa_input_channels = getattr(inner, "fa_input_channels", None)

    def predict(self, x):
        p = np.array(self.inner.predict(x))
        if self.fault == "half" and len(p) > 1:
            p[len(p) // 2:] = p[: len(p) // 2].mean(axis=0)
        elif self.fault == "altered":
            i = len(p) // 2
            p[i, :21] = p[i, :21][::-1]
        return p


def _broken(fault):
    def engines(paths, config, device, pileup_only):
        from clair3_tpu_torch import cli

        pe = cli._load_engine(paths["pileup"], "pileup", device, torch.float32)
        fe = (None if pileup_only else
              cli._load_engine(paths["full_alignment"], "full_alignment", device, torch.float32))
        return Broken(pe, fault), (Broken(fe, fault) if fe is not None else None)
    return engines


def _failed(result, names):
    assert not result["correct"]
    over = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    assert over & set(names), result["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fp8_control_is_not_correct(root, cell):
    _failed(_run(root, cell, engines=fp8_engines), {"pileup_logp_gap", "fa_logp_gap"})


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_a_broken_engine_is_not_correct(root, fault):
    _failed(_run(root, "tiny-hifi-call", engines=_broken(fault)),
            {"pileup_logp_gap", "fa_logp_gap"})


def test_a_genotype_altered_by_the_decoder_is_not_correct(root, monkeypatch):
    from clair3_tpu_torch.pipeline import call

    real = call.batch_decode_parallel

    def flipped(*args, **kwargs):
        # the first het call of every decoded batch comes out hom
        rows = real(*args, **kwargs)
        for i, row in enumerate(rows):
            cols = row.split("\t")
            if cols[9].startswith("0/1"):
                rows[i] = "\t".join(cols[:9] + ["1/1" + cols[9][3:]])
                break
        return rows

    monkeypatch.setattr(call, "batch_decode_parallel", flipped)
    _failed(_run(root, "tiny-pileup-only"), {"pileup_rows_differ"})


def test_a_phaser_that_returns_its_input_is_not_correct(root, monkeypatch):
    from clair3_tpu_torch.phase import ReadBackedPhaser

    monkeypatch.setattr(ReadBackedPhaser, "phase", lambda self, ctg, het: list(het))
    _failed(_run(root, "tiny-hifi-call"), {"phasing_differ"})
