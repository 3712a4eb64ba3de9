"""The port's InferenceEngine over several devices, on the CPU:

* the twins of ``tests/test_sharded_parity.py``'s inference tests: the same
  candidates through the port's engine over 1 and over 8 CPU replicas give
  probabilities within 1e-6 and byte-identical ``batch_decode`` rows;
* the port's engine over 8 CPU replicas against the JAX ``InferenceEngine``
  over ``conftest.py``'s 8 virtual CPU devices, on bridged weights and the
  same seeded inputs, on every wire form (pileup dense and compact; FA
  dense, and with ``depth_crop`` + ``fa_compact`` the sparse and v1 packs),
  on a batch past the top bucket and on one that pads: equal ``buckets``
  (also over 3 devices), probabilities within the nets' f32 bounds (pileup
  1e-5, FA 1e-4: the two conv and matmul libraries sum in other orders),
  and equal ``bytes_shipped``;
* ``parallel.mesh.local_devices`` on the CPU, and ``cli._load_engine`` on
  the CPU still over one device.
"""

import numpy as np
import pytest
import torch
from test_torch_compact import BAND, _fa_batch, _pileup_batch

from clair3_tpu import models as jax_models
from clair3_tpu.parallel.mesh import get_mesh
from clair3_tpu.pipeline.engine import InferenceEngine as JaxEngine
from clair3_tpu_torch.cli import _load_engine
from clair3_tpu_torch.decode import DecodeConfig, batch_decode
from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.ops.fa_compact import K_BUCKETS
from clair3_tpu_torch.parallel.mesh import local_devices
from clair3_tpu_torch.pipeline import engine as engine_mod
from clair3_tpu_torch.pipeline.engine import InferenceEngine
from clair3_tpu_torch.testing import random_variables, trained_fixture_path

CPU = torch.device("cpu")
PILEUP_TOL, FA_TOL = 1e-5, 1e-4
SMALL_PILEUP = dict(lstm1_units=8, lstm2_units=8, l4_units=8, l5_units=8)


def _port_net(net, seed):
    variables = random_variables(net, seed)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net.eval(), variables


def _replicas(n):
    return [CPU] * n


# -- 1 vs 8 replicas (the twins of tests/test_sharded_parity.py) ----------


def _engines_1_and_8(net, buckets):
    e1 = InferenceEngine(net, CPU, buckets=buckets)
    e8 = InferenceEngine(net, CPU, buckets=buckets, devices=_replicas(8))
    assert len(e8.devices) == 8 and len(e8.replicas) == 8
    assert all(r is not net for r in e8.replicas[1:])
    return e1, e8


@pytest.mark.parametrize("add_indel_length", [False, True])
def test_pileup_inference_parity_1_vs_8_replicas(add_indel_length):
    net, _ = _port_net(PileupNet(add_indel_length=add_indel_length), seed=0)
    e1, e8 = _engines_1_and_8(net, buckets=(64,))
    x = np.random.default_rng(1).integers(-30, 30, (50, 33, 18)).astype(np.int32)  # pads to 64
    p1, p8 = e1.predict(x), e8.predict(x)
    np.testing.assert_allclose(p8, p1, atol=1e-6, rtol=1e-6)

    pos_infos = [f"chr1:{1000 + 40 * i}:{'ACGTA' * 6}ACG" for i in range(50)]
    alt_infos = ["30-XC 14 RA 16 " for _ in range(50)]
    cfg = DecodeConfig(add_indel_length=add_indel_length, pileup=True, show_ref_calls=True)
    assert batch_decode(pos_infos, alt_infos, p1, cfg) == batch_decode(
        pos_infos, alt_infos, p8, cfg)


@pytest.mark.parametrize("n", [23, 40])
def test_fa_inference_parity_1_vs_8_replicas(n):
    net, _ = _port_net(FullAlignmentNet(add_indel_length=True), seed=0)
    e1, e8 = _engines_1_and_8(net, buckets=(32,))
    x = np.random.default_rng(2).integers(-100, 100, (n, 55, 33, 8)).astype(np.int8)
    np.testing.assert_allclose(e8.predict(x), e1.predict(x), atol=1e-6, rtol=1e-6)


# -- 8 replicas against the JAX engine on 8 virtual devices ---------------


def _pileup_pair(compact, buckets):
    net, v = _port_net(PileupNet(add_indel_length=True, **SMALL_PILEUP), seed=22)
    opts = dict(buckets=buckets, transfer_dtype=np.int16, pileup_compact=compact)
    jax_net = jax_models.PileupNet(add_indel_length=True, **SMALL_PILEUP)
    return net, v, jax_net, opts


def _fa_pair(compact, buckets):
    net, v = _port_net(FullAlignmentNet(input_channels=8, l4_units=16, l5_units=16), seed=21)
    opts = dict(buckets=buckets, transfer_dtype=np.int8, depth_crop=compact,
                fa_compact=compact)
    jax_net = jax_models.FullAlignmentNet(input_channels=8, l4_units=16, l5_units=16)
    return net, v, jax_net, opts


def _fa_v1(n):
    x = _fa_batch(5, n)  # more alt cells than the largest K: the v1 pack
    x[0, BAND[0]: BAND[0] + K_BUCKETS[-1] // 33 + 1, :, 1] = 7
    return x


# case -> (engine pair, its buckets, the batch, the first chunk's wire form)
CASES = {
    "pileup_dense": (lambda: _pileup_pair(False, (16, 64)), lambda: _pileup_batch(3, 50),
                     engine_mod.DENSE),
    "pileup_compact": (lambda: _pileup_pair(True, (16, 64)), lambda: _pileup_batch(4, 50),
                       engine_mod.PILEUP_COMPACT),
    "pileup_past_top": (lambda: _pileup_pair(True, (16, 64)), lambda: _pileup_batch(5, 150),
                        engine_mod.PILEUP_COMPACT),
    "pileup_pads_to_the_device_count": (lambda: _pileup_pair(True, (3, 12)),
                                        lambda: _pileup_batch(6, 5), engine_mod.PILEUP_COMPACT),
    "fa_dense": (lambda: _fa_pair(False, (16,)), lambda: _fa_batch(6, 11), engine_mod.DENSE),
    "fa_sparse": (lambda: _fa_pair(True, (16,)), lambda: _fa_batch(7, 11),
                  engine_mod.FA_SPARSE),
    "fa_v1": (lambda: _fa_pair(True, (16,)), lambda: _fa_v1(11), engine_mod.FA_V1),
    "fa_sparse_past_top": (lambda: _fa_pair(True, (16,)), lambda: _fa_batch(8, 37),
                           engine_mod.FA_SPARSE),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_8_replicas_match_the_jax_engine_on_8_devices(case):
    make_pair, make_batch, form = CASES[case]
    net, variables, jax_net, opts = make_pair()
    x = make_batch()
    port = InferenceEngine(net, CPU, devices=_replicas(8), **opts)
    jax_engine = JaxEngine(jax_net, variables, mesh=get_mesh(), **opts)
    assert jax_engine.mesh.devices.size == 8
    assert port.buckets == jax_engine.buckets
    assert all(b % 8 == 0 for b in port.buckets)
    assert port._wire_form(x[: port.buckets[-1]])[0] == form

    got, want = port.predict(x), jax_engine.predict(x)
    assert got.shape == want.shape == (len(x), want.shape[1])
    tol = FA_TOL if x.ndim == 4 else PILEUP_TOL
    err = np.abs(got - want).max()
    print(f"[sharded] {case}: max |dp| {err:.3g} (bound {tol}), bytes_shipped "
          f"{port.bytes_shipped}")
    assert err <= tol
    assert port.bytes_shipped == jax_engine.bytes_shipped
    assert port.bytes_shipped <= port.dense_bytes


@pytest.mark.parametrize("buckets", [(256, 1024, 2048, 4096), (1, 2, 16), (5, 7)])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_buckets_round_as_the_jax_engine(buckets, n):
    net, v, jax_net, _ = _pileup_pair(False, buckets)
    port = InferenceEngine(net, CPU, buckets=buckets, devices=_replicas(n))
    jax_engine = JaxEngine(jax_net, v, mesh=get_mesh(n_devices=n), buckets=buckets)
    assert port.buckets == jax_engine.buckets
    top = port.buckets[-1]
    for m in (1, top, top + 1, 3 * top - 1):
        assert port._bucket_for(m) == jax_engine._bucket_for(m)


# -- the devices of the engines' callers ----------------------------------


def test_local_devices_on_the_cpu():
    assert local_devices("cpu") == [CPU]
    assert local_devices(CPU, n_devices=1) == [CPU]
    assert local_devices("cpu", n_devices=0) == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the no-card error")
def test_local_devices_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_devices("cuda")


@pytest.mark.parametrize("kind,name", [("pileup", "pileup_hifi.npz"),
                                       ("full_alignment", "fa_hifi.npz")])
def test_load_engine_on_the_cpu_is_one_device(kind, name):
    engine = _load_engine(trained_fixture_path(name), kind, CPU, torch.float32)
    assert engine.devices == (CPU,) and engine.device == CPU
    assert engine.replicas == [engine.model]
    two = _load_engine(trained_fixture_path(name), kind, CPU, torch.float32,
                       devices=_replicas(2))
    assert two.devices == (CPU, CPU) and two.replicas[1] is not two.model
    shape = (33, 18) if kind == "pileup" else (55, 33, 8)
    x = (_pileup_batch(9, 40) if kind == "pileup" else _fa_batch(9, 40))
    assert x.shape[1:] == shape
    np.testing.assert_allclose(two.predict(x), engine.predict(x), atol=1e-6, rtol=0)
    assert two.bytes_shipped == engine.bytes_shipped
