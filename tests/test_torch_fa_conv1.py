"""The FA conv1 kernel's plain twin (``ops/fa_conv1.py``) and the net's
kernel route against the JAX package, on the CPU.

* twin vs ``fa_conv1_pallas(..., interpret=True)`` at f32, atol 1e-5 under
  matmul precision "highest" (both are the same conv+BN+ReLU, exact up to
  summation order), on the geometries of ``tests/test_pallas_fa.py``;
* ``FullAlignmentNet(use_kernel_conv1=True)`` vs the JAX
  ``FullAlignmentNet(use_pallas_conv1=True)`` at f32, atol 2e-4 (the bound
  of ``test_pallas_fa.py``), through the bridged weights;
* the bf16 kernel's GEMM form in plain torch at f32: ``im2col`` (the
  kernel's K order) times ``pack_weights`` (the ``[K, 64]`` matrix the
  kernel reads), + ``b_eff``, ReLU, equals the twin within 1e-5 (the same
  exact products, summed in another order), on the four geometries of
  ``chip_smoke.py`` at B = 1, 11;
* the loader's guard, with the device in place of the JAX test's faked
  backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair3_tpu.models import FullAlignmentNet as JaxFullAlignmentNet
from clair3_tpu.ops.pallas_fa import fa_conv1_pallas
from clair3_tpu_torch import cli
from clair3_tpu_torch.models import FullAlignmentNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.ops import fa_conv1 as k3
from clair3_tpu_torch.testing import random_variables, trained_fixture_path

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _operands(rs, c):
    return (rs.randn(3, 3, c, 64) * 0.2, rs.randn(64) * 0.1, rs.rand(64) + 0.5,
            rs.randn(64) * 0.1, rs.randn(64) * 0.3, rs.rand(64) + 0.5)


@pytest.mark.parametrize("d,w,c,b", [(89, 33, 8, 12), (55, 33, 9, 12), (56, 34, 8, 12),
                                     (89, 33, 8, 11)])
def test_twin_matches_pallas_interpret(d, w, c, b):
    rs = np.random.RandomState(0)
    x = rs.randint(-100, 101, (b, d, w, c)).astype(np.int8)
    ops = [o.astype(np.float32) for o in _operands(rs, c)]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(fa_conv1_pallas(jnp.asarray(x), *map(jnp.asarray, ops),
                                          compute_dtype=jnp.float32, batch_tile=8,
                                          interpret=True))
    got = k3.fa_conv1(torch.from_numpy(x), *map(torch.from_numpy, ops),
                      compute_dtype=torch.float32)
    assert got.shape == want.shape == (b, -(-d // 2), -(-w // 2), 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("in_ch", [8, 9])
def test_kernel_route_net_matches_jax(in_ch):
    rs = np.random.RandomState(2)
    x = rs.randint(-100, 101, (3, 89, 33, in_ch)).astype(np.int8)
    net = FullAlignmentNet(input_channels=in_ch, use_kernel_conv1=True)
    v = random_variables(net, seed=3)
    net.load_state_dict(from_jax_variables(v), strict=True)
    net.eval()
    jax_net = JaxFullAlignmentNet(add_indel_length=True, input_channels=in_ch,
                                  use_pallas_conv1=True)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_net.apply(v, x, train=False))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
        std = FullAlignmentNet(input_channels=in_ch)
        std.load_state_dict(net.state_dict())
        plain = std.eval()(torch.from_numpy(x)).numpy()
        net.compute_dtype = torch.bfloat16
        got16 = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 90)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, plain, rtol=0, atol=2e-4)
    # bf16 stays within softmax tolerance of f32, as in test_pallas_fa.py
    assert np.abs(got16 - plain).max() < 2e-2


@pytest.mark.parametrize("b", [1, 11])
@pytest.mark.parametrize("d,c", [(55, 8), (89, 9), (89, 8), (55, 9)])
def test_gemm_form_equals_twin(d, c, b):
    rs = np.random.RandomState(d * c + b)
    x = torch.from_numpy(rs.randint(-128, 128, (b, d, 33, c)).astype(np.int8))
    ops = [torch.from_numpy(o.astype(np.float32)) for o in _operands(rs, c)]
    w_eff, b_eff = k3.fold_bn(*ops, 1e-3, 100.0, torch.float32)
    packed = k3.pack_weights(w_eff)
    assert packed.shape == ((80 if c == 8 else 96), 64)
    # the padding rows are zero: tap 9 of the two-tap steps, taps 9..15 of
    # the channel-8 step
    assert not packed[72:80].any() and (c == 8 or not packed[89:].any())
    cols = k3.im2col(x)
    assert cols.shape == (b, -(-d // 2), 17, packed.shape[0])
    got = torch.relu(cols @ packed + b_eff)
    want = k3.fa_conv1_reference(x, *ops, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_pack_weights_takes_8_or_9_channels():
    with pytest.raises(ValueError, match="8 or 9 channels"):
        k3.pack_weights(torch.zeros(3, 3, 7, 64))


def test_guard_truth_table(monkeypatch):
    monkeypatch.delenv("CLAIR3T_ENABLE_FA_CONV1", raising=False)
    monkeypatch.delenv("CLAIR3T_DISABLE_PALLAS", raising=False)
    assert cli._use_kernel_fa_conv1(CUDA, torch.bfloat16) is False  # default: off
    assert cli._use_kernel_pileup() is True                          # K1 default: on
    monkeypatch.setenv("CLAIR3T_ENABLE_FA_CONV1", "1")
    assert cli._use_kernel_fa_conv1(CUDA, torch.bfloat16) is True
    assert cli._use_kernel_fa_conv1(CUDA, torch.float32) is False    # bf16 only
    assert cli._use_kernel_fa_conv1(CPU, torch.bfloat16) is False    # CUDA only
    monkeypatch.setenv("CLAIR3T_DISABLE_PALLAS", "1")
    assert cli._use_kernel_fa_conv1(CUDA, torch.bfloat16) is False   # kill switch wins
    assert cli._use_kernel_pileup() is False


def test_loader_wires_guards_and_wire_forms(monkeypatch):
    seen = []

    def guard(device, dtype):
        seen.append((device, dtype))
        return True

    monkeypatch.setattr(cli, "_use_kernel_fa_conv1", guard)
    monkeypatch.delenv("CLAIR3T_DISABLE_PALLAS", raising=False)
    fa = cli._load_engine(trained_fixture_path("fa_hifi.npz"), "full_alignment", CPU,
                          torch.bfloat16)
    assert fa.model.use_kernel_conv1 is True and seen == [(CPU, torch.bfloat16)]
    assert fa.depth_crop and fa.fa_compact and not fa.pileup_compact
    assert fa.fa_input_channels == 8
    pileup = cli._load_engine(trained_fixture_path("pileup_hifi.npz"), "pileup", CPU,
                              torch.float32)
    assert pileup.pileup_compact and not (pileup.depth_crop or pileup.fa_compact)
    assert pileup.model.use_kernel is True
    monkeypatch.setenv("CLAIR3T_DISABLE_PALLAS", "1")
    assert cli.load_model(trained_fixture_path("pileup_hifi.npz"), "pileup", CPU,
                          torch.float32).use_kernel is False
