"""The compact wire forms and the FA depth crop in the port.

* ``unpack_*_torch`` rebuild what the JAX package's ``unpack_*_numpy``
  rebuild from the same packs, bit for bit (the packers are the JAX
  package's own);
* the port's engine with ``depth_crop``/``fa_compact``/``pileup_compact``
  returns what its net returns on the dense tensor (atol 1e-6, as
  ``test_torch_engine.py``: rows are independent; only batch-size-dependent
  CPU matmul blocking moves the float rounding), on every route, and ships
  fewer bytes than the dense form.

Inputs are seeded batches with the extractors' structure: per-read
strand/MQ/haplotype/AF scalars, a per-column reference, a centred band of
reads, and sparse alt/insert cells."""

import numpy as np
import pytest
import torch

from clair3_tpu.ops.fa_compact import (K_BUCKETS, pack_fa, pack_fa_sparse,
                                       unpack_fa_numpy, unpack_fa_sparse_numpy)
from clair3_tpu.ops.pileup_compact import pack_pileup, unpack_pileup_numpy
from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.ops.fa_compact import unpack_fa_sparse_torch, unpack_fa_torch
from clair3_tpu_torch.ops.pileup_compact import unpack_pileup_torch
from clair3_tpu_torch.pipeline import engine as engine_mod
from clair3_tpu_torch.pipeline.engine import InferenceEngine
from clair3_tpu_torch.testing import random_variables

DEPTH = 55
BAND = (11, 43)  # inside the 32-row centred crop of depth 55


def _pileup_batch(seed, n):
    rng = np.random.RandomState(seed)
    packed = {"mags": rng.randint(0, 60, (n, 33, 18)).astype(np.uint8),
              "negidx": rng.choice([0, 1, 2, 3, 18], (n, 33)).astype(np.int8)}
    return unpack_pileup_numpy(packed).astype(np.int32)


def _fa_batch(seed, n, channels=8, depth=DEPTH, band=BAND, n_alt=4):
    """[n, depth, 33, channels] int8 that packs: reads in rows band[0]..
    band[1]-1, each covering one span of columns."""
    rng = np.random.RandomState(seed)
    lo, hi = band
    m = np.zeros((n, depth, 33, channels), np.int8)
    start = rng.randint(0, 20, (n, hi - lo))
    end = start + rng.randint(1, 14, (n, hi - lo))
    cover = ((np.arange(33) >= start[..., None]) & (np.arange(33) < end[..., None]))
    refcol = 25 * rng.randint(1, 5, (n, 33))
    per_read = lambda *vals: rng.choice(vals, (n, hi - lo, 1))  # noqa: E731
    m[:, lo:hi, :, 0] = refcol[:, None, :] * cover
    m[:, lo:hi, :, 2] = per_read(50, 100) * cover
    m[:, lo:hi, :, 3] = rng.randint(0, 101, (n, hi - lo, 1)) * cover
    m[:, lo:hi, :, 5] = rng.randint(0, 101, (n, hi - lo, 1)) * cover
    m[:, lo:hi, :, 7] = per_read(0, 50, 100) * cover
    m[:, lo:hi, :, 4] = rng.randint(-100, 101, (n, hi - lo, 33)) * cover
    if channels == 9:
        m[:, lo:hi, :, 8] = rng.randint(0, 101, (n, hi - lo, 33)) * cover
    for ch in (1, 6):  # sparse alt and insert cells
        rows = rng.randint(lo, hi, (n, n_alt))
        cols = rng.randint(0, 33, (n, n_alt))
        m[np.arange(n)[:, None], rows, cols, ch] = rng.randint(1, 101, (n, n_alt))
    return m


def _torch_planes(packed):
    return {k: torch.from_numpy(v.view(np.int16) if v.dtype == np.uint16 else v)
            for k, v in packed.items()}


def test_unpack_pileup_matches_numpy():
    x = _pileup_batch(0, 12)
    packed = pack_pileup(x)
    assert packed is not None
    got = unpack_pileup_torch(*(torch.from_numpy(packed[k]) for k in ("mags", "negidx")))
    want = unpack_pileup_numpy(packed)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x)
    x[0, 0, 0] = 300  # beyond uint8: the packer refuses
    assert pack_pileup(x) is None


@pytest.mark.parametrize("channels", [8, 9])
def test_unpack_fa_v1_matches_numpy(channels):
    x = _fa_batch(1, 6, channels)
    packed = pack_fa(x)
    assert packed is not None
    got = unpack_fa_torch(*(torch.from_numpy(packed[k])
                            for k in ("cells", "bitmask", "scalars", "refcol")))
    np.testing.assert_array_equal(got.numpy(), unpack_fa_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("channels,k", [(8, K_BUCKETS[0]), (9, K_BUCKETS[0]),
                                        (8, K_BUCKETS[-1])])
def test_unpack_fa_sparse_matches_numpy(channels, k):
    x = _fa_batch(2, 6, channels)
    if k > K_BUCKETS[0]:  # one row with > K0 alt cells forces the larger K
        x[3, BAND[0]: BAND[0] + K_BUCKETS[0] // 33 + 1, :, 1] = 7
    packed = pack_fa_sparse(x)
    assert packed is not None and packed["sidx"].shape[1] == k
    got = unpack_fa_sparse_torch(_torch_planes(packed))
    np.testing.assert_array_equal(got.numpy(), unpack_fa_sparse_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), x)
    noise = np.random.RandomState(3).randint(-100, 101, x.shape).astype(np.int8)
    assert pack_fa_sparse(noise) is None and pack_fa(noise) is None


def test_sparse_indices_past_int16_cross_as_int16_bits():
    """uint16 indices >= 32768 are negative as int16 and widen back with
    & 0xFFFF."""
    x = _fa_batch(4, 1, depth=520, band=(500, 510))
    packed = pack_fa_sparse(x)
    assert packed is not None and packed["sidx"][packed["sval"] != 0].min() >= 32768
    got = unpack_fa_sparse_torch(_torch_planes(packed))
    np.testing.assert_array_equal(got.numpy(), x)


def _net(net, seed):
    net.load_state_dict(from_jax_variables(random_variables(net, seed)))
    return net.eval()


@pytest.fixture(scope="module")
def fa_engine():
    net = _net(FullAlignmentNet(input_channels=8), seed=21)
    return InferenceEngine(net, torch.device("cpu"), buckets=(64, 256),
                           transfer_dtype=np.int8, depth_crop=True, fa_compact=True)


def _fa_routes(n):
    """name -> (batch, expected route of its first chunk)"""
    x = _fa_batch(5, n)
    big_k = x.copy()
    big_k[0, BAND[0]: BAND[0] + K_BUCKETS[0] // 33 + 1, :, 1] = 7
    v1 = x.copy()  # more alt cells than the largest K: the v1 pack
    v1[0, BAND[0]: BAND[0] + K_BUCKETS[-1] // 33 + 1, :, 1] = 7
    full = _fa_batch(6, n, band=(2, 50))  # reads outside the crop band
    noise = np.random.RandomState(7).randint(-100, 101, x.shape).astype(np.int8)
    return {"sparse": (x, engine_mod.FA_SPARSE), "sparse_big_k": (big_k, engine_mod.FA_SPARSE),
            "v1": (v1, engine_mod.FA_V1), "full_depth": (full, engine_mod.FA_SPARSE),
            "dense": (noise, engine_mod.DENSE)}


@pytest.mark.parametrize("n", [1, 70, 300])
def test_fa_engine_compact_equals_dense_net(fa_engine, n):
    dense_bytes = sum(fa_engine._bucket_for(min(256, n - lo)) for lo in range(0, n, 256)
                      ) * DEPTH * 33 * 8
    for name, (x, route) in _fa_routes(n).items():
        form, planes, full_depth = fa_engine._wire_form(x[:256])
        assert form == route, name
        assert (full_depth is None) == (name in ("full_depth", "dense")), name
        before, dense_before = fa_engine.bytes_shipped, fa_engine.dense_bytes
        got = fa_engine.predict(x)
        with torch.inference_mode():
            want = fa_engine.model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
        shipped = fa_engine.bytes_shipped - before
        assert fa_engine.dense_bytes - dense_before == dense_bytes, name
        if route == engine_mod.DENSE:
            assert shipped == dense_bytes, name
        else:
            assert shipped < dense_bytes, name


@pytest.fixture(scope="module")
def pileup_engine():
    net = _net(PileupNet(add_indel_length=True, lstm1_units=8, lstm2_units=8,
                         l4_units=8, l5_units=8, use_kernel=True), seed=22)
    return InferenceEngine(net, torch.device("cpu"), transfer_dtype=np.int16,
                           pileup_compact=True)


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_pileup_engine_compact_equals_dense_net(pileup_engine, n):
    x = _pileup_batch(n, n)
    assert pileup_engine._wire_form(x[:4096])[0] == engine_mod.PILEUP_COMPACT
    before = pileup_engine.bytes_shipped
    got = pileup_engine.predict(x)
    with torch.inference_mode():
        want = pileup_engine.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rows = sum(pileup_engine._bucket_for(min(4096, n - lo)) for lo in range(0, n, 4096))
    # 627 B per padded row against int16's 1188
    assert pileup_engine.bytes_shipped - before == rows * 627 < rows * 1188


def test_pileup_engine_falls_back_to_dense(pileup_engine):
    x = _pileup_batch(8, 5)
    x[2, 4, 1] = 400  # beyond uint8: the pack refuses, the batch crosses dense
    assert pileup_engine._wire_form(x)[0] == engine_mod.DENSE
    before = pileup_engine.bytes_shipped
    got = pileup_engine.predict(x)
    with torch.inference_mode():
        want = pileup_engine.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert pileup_engine.bytes_shipped - before == 256 * 1188


def test_warmup_batches_cover_every_route(fa_engine):
    routes = []
    for x in fa_engine.warmup_batches((DEPTH, 33, 8), np.int8):
        form, planes, full_depth = fa_engine._wire_form(x)
        routes.append((form, planes["sidx"].shape[1], full_depth))
    assert sorted(routes, key=str) == sorted(
        [(engine_mod.FA_SPARSE, k, d) for k in K_BUCKETS for d in (DEPTH, None)], key=str)
