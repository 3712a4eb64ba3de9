"""The port's own native host library (``clair3_tpu_torch/native``).

It builds from the port's sources into ``clair3_tpu_torch/native/`` (once
for all test processes: ``_build`` holds a file lock while it compiles),
and on the 3 kb case of the verify recipe the port's extractors and native
packers give what the JAX package's give: equal pileup and full-alignment
tensors (``np.array_equal``), candidates and sparse packs.
"""

import os

import numpy as np
import pytest

from clair3_tpu import native as jax_native
from clair3_tpu.fullalign.extractor import create_fa_tensors as jax_fa
from clair3_tpu.ops.fa_compact import K_BUCKETS as JAX_K_BUCKETS
from clair3_tpu.pileup.extractor import create_pileup_tensors as jax_pileup
from clair3_tpu_torch import native
from clair3_tpu_torch.fullalign.extractor import create_fa_tensors
from clair3_tpu_torch.ops.fa_compact import K_BUCKETS
from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

PORT_NATIVE = os.path.dirname(os.path.abspath(native.__file__))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_case")
    ref = random_reference(3000, seed=42)
    variants = [
        SimVariant(600, ref[600], "C" if ref[600] != "C" else "G", (1, 1)),
        SimVariant(1200, ref[1200], "T" if ref[1200] != "T" else "A", (0, 1)),
        SimVariant(1800, ref[1800], ref[1800] + "ACG", (0, 1)),
        SimVariant(2400, ref[2400:2404], ref[2400], (1, 1)),
    ]
    fasta, bam, _, _ = write_test_case(str(tmp), ref_length=3000, variants=variants,
                                       coverage=25, read_length=700, seed=42,
                                       error_rate=0.02)
    return fasta, bam


@pytest.fixture(scope="module")
def lib():
    assert native.native_available(), "the port's native library did not build"
    return native.get_lib()


def test_library_is_the_ports_own(lib, monkeypatch):
    path = native._build()
    assert os.path.dirname(path) == PORT_NATIVE and os.path.exists(path)
    assert path != jax_native._SO
    # the JAX package's override never points the port at another build
    monkeypatch.setenv("CLAIR3T_NATIVE_SO", jax_native._SO)
    assert native._build() == path
    monkeypatch.setenv("CLAIR3T_TORCH_NATIVE_SO", "/elsewhere/libclair3t.so")
    assert native._build() == "/elsewhere/libclair3t.so"


@pytest.mark.parametrize("use_native", [True, False])
def test_pileup_tensors_equal_jax(case, lib, use_native):
    fasta, bam = case
    got = create_pileup_tensors(bam, fasta, "chr1", 1, 3000, use_native=use_native)
    want = jax_pileup(bam, fasta, "chr1", 1, 3000, use_native=use_native)
    assert len(got[1]) >= 4
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
    assert got[1] == want[1] and got[2] == want[2]


@pytest.mark.parametrize("depth,dwell", [(55, False), (89, False)])
def test_fa_tensors_and_sparse_packs_equal_jax(case, lib, depth, dwell):
    fasta, bam = case
    cands = create_pileup_tensors(bam, fasta, "chr1", 1, 3000)[1]
    positions = [int(c.split(":")[1]) for c in cands]
    got = create_fa_tensors(bam, fasta, "chr1", positions, matrix_depth=depth,
                            no_phasing=True, enable_dwell=dwell)
    want = jax_fa(bam, fasta, "chr1", positions, matrix_depth=depth, no_phasing=True,
                  enable_dwell=dwell)
    assert got[0].shape == (len(positions), depth, 33, 8)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] and got[2] == want[2]
    assert K_BUCKETS == JAX_K_BUCKETS
    mine = native.fa_pack_sparse_native(got[0], K_BUCKETS)
    theirs = jax_native.fa_pack_sparse_native(want[0], JAX_K_BUCKETS)
    assert mine is not None and sorted(mine) == sorted(theirs)
    for key in mine:
        assert np.array_equal(mine[key], theirs[key]), key
    assert native.fa_band_native(got[0]) == jax_native.fa_band_native(want[0])


def test_pileup_pack_equals_jax(case, lib):
    fasta, bam = case
    x = create_pileup_tensors(bam, fasta, "chr1", 1, 3000)[0].astype(np.int16)
    mine, theirs = native.pileup_pack_native(x), jax_native.pileup_pack_native(x)
    assert mine is not None and sorted(mine) == sorted(theirs)
    for key in mine:
        assert np.array_equal(mine[key], theirs[key]), key
