"""The BiLSTM recurrence kernel's plain twin (``ops/bilstm.py``) and
``BiLSTM(use_kernel=True)`` against the JAX package, on the CPU.

* twin vs ``bilstm_pallas(..., interpret=True)``: f32 atol 1e-5 (the bound
  of ``tests/test_pallas_lstm.py``; same rounding points, summation order
  only); bf16 atol 1e-2 (h and c rounded to bf16 every step on both sides,
  so an order-dependent rounding flip moves an output by one ulp, <= 2^-8);
* ``BiLSTM(use_kernel=True)`` vs the JAX ``_bilstm_fused_scan`` (the plain
  route of the JAX ``BiLSTM``) at f32, atol 1e-5.  The JAX
  ``BiLSTM(use_pallas=True)`` passes no ``interpret`` flag, so it cannot run
  here.  Inputs as in ``test_pallas_lstm.py``: normal ``xw``, ``wh`` x 0.1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair3_tpu.ops.lstm import _bilstm_fused_scan
from clair3_tpu.ops.pallas_lstm import bilstm_pallas
from clair3_tpu_torch.models import PileupNet
from clair3_tpu_torch.ops.bilstm import bilstm_recurrence
from clair3_tpu_torch.ops.lstm import BiLSTM, bilstm

T = 33


def _inputs(seed, B, H):
    rs = np.random.RandomState(seed)
    return (rs.randn(T, 2, B, 4 * H).astype(np.float32),
            (rs.randn(2, H, 4 * H) * 0.1).astype(np.float32))


@pytest.mark.parametrize("B,H,dtype,tol", [(8, 128, "float32", 1e-5),
                                           (12, 128, "float32", 1e-5),
                                           (8, 128, "bfloat16", 1e-2)])
def test_twin_matches_pallas_interpret(B, H, dtype, tol):
    xw, wh = _inputs(B, B, H)
    want = bilstm_pallas(jnp.asarray(xw, dtype), jnp.asarray(wh, dtype), batch_tile=8,
                         interpret=True)
    tdt = getattr(torch, dtype)
    got = bilstm_recurrence(torch.from_numpy(xw).to(tdt), torch.from_numpy(wh).to(tdt))
    assert got.shape == (T, 2, B, H) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def test_kernel_route_module_matches_jax_scan():
    B, C, H = 8, 18, 128
    rs = np.random.RandomState(4)
    x = rs.randn(B, T, C).astype(np.float32)
    mod = BiLSTM(C, H, use_kernel=True)
    with torch.no_grad():
        mod.wi.copy_(torch.from_numpy(rs.randn(2, C, 4 * H) / np.sqrt(C)))
        mod.wh.copy_(torch.from_numpy(rs.randn(2, H, 4 * H) * 0.1))
        mod.b.copy_(torch.from_numpy(rs.randn(2, 4 * H) * 0.1))
    wi, wh, b = (p.detach().numpy() for p in (mod.wi, mod.wh, mod.b))
    xw = x @ np.concatenate([wi[0], wi[1]], axis=1)
    want = np.asarray(_bilstm_fused_scan(jnp.asarray(xw[..., :4 * H] + b[0]),
                                         jnp.asarray(xw[..., 4 * H:] + b[1]),
                                         jnp.asarray(wh[0]), jnp.asarray(wh[1])))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x)).numpy()
        plain = bilstm(torch.from_numpy(x), mod.wi, mod.wh, mod.b).numpy()
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)


def test_pileup_net_keeps_the_plain_recurrence():
    """The JAX PileupNet never sets BiLSTM.use_pallas; the port's does not
    set use_kernel either (its kernel route is the whole-net K1)."""
    net = PileupNet()
    assert not net.LSTM1.use_kernel and not net.LSTM2.use_kernel
