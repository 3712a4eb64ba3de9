"""The BiLSTM recurrence kernel's plain twin (``ops/bilstm.py``) and
``BiLSTM(use_kernel=True)`` against the JAX package, on the CPU.

* twin vs ``bilstm_pallas(..., interpret=True)``: f32 atol 1e-5 (the bound
  of ``tests/test_pallas_lstm.py``; same rounding points, summation order
  only); bf16 atol 1e-2 (h and c rounded to bf16 every step on both sides,
  so an order-dependent rounding flip moves an output by one ulp, <= 2^-8);
* the batch-major layout (``[B, T, 8H]`` -> ``[B, T, 2H]``, the module's)
  equals the TPU layout's twin exactly, and is held against
  ``bilstm_pallas`` as the TPU layout is;
* ``BiLSTM(use_kernel=True)`` vs the JAX ``_bilstm_fused_scan`` (the plain
  route of the JAX ``BiLSTM``) at f32, atol 1e-5.  The JAX
  ``BiLSTM(use_pallas=True)`` passes no ``interpret`` flag, so it cannot run
  here.  Inputs as in ``test_pallas_lstm.py``: normal ``xw``, ``wh`` x 0.1;
* the tensor-core kernel's weight packing and fragment map, by a plain
  emulation of mma.sync m16n8k16 (PTX ISA fragment layouts): one step's
  ``h @ wh`` rebuilt from the packed fragments equals the product, atol
  1e-6 (f32 inputs, both sides summed in float64, so the order of the sums
  moves nothing; a misplaced fragment moves a gate by ~0.1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair3_tpu.ops.lstm import _bilstm_fused_scan
from clair3_tpu.ops.pallas_lstm import bilstm_pallas
from clair3_tpu_torch.models import PileupNet
from clair3_tpu_torch.ops import lstm as lstm_mod
from clair3_tpu_torch.ops.bilstm import (TC_WIDTHS, bilstm_batch_major, bilstm_recurrence,
                                         pack_wh_fragments)
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
    _module_matches_jax_scan(18, 128, seed=4)


def test_kernel_route_module_matches_jax_scan_h160():
    _module_matches_jax_scan(256, 160, seed=5)


def _module_matches_jax_scan(C, H, seed):
    B = 8
    rs = np.random.RandomState(seed)
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


def _tpu_layout(xw_bt):
    """[B, T, 8H] -> [T, 2, B, 4H], slot 1 reversed, by numpy."""
    H4 = xw_bt.shape[-1] // 2
    fwd = xw_bt[..., :H4].transpose(1, 0, 2)
    bwd = xw_bt[..., H4:].transpose(1, 0, 2)[::-1]
    return np.ascontiguousarray(np.stack([fwd, bwd], axis=1))


def _batch_major(hs):
    """[T, 2, B, H] (slot 1 reversed) -> [B, T, 2H], by numpy."""
    return np.concatenate([hs[:, 0].transpose(1, 0, 2), hs[::-1, 1].transpose(1, 0, 2)],
                          axis=-1)


@pytest.mark.parametrize("B,H,dtype,tol", [(8, 128, "float32", 1e-5),
                                           (5, 160, "float32", 1e-5),
                                           (8, 128, "bfloat16", 1e-2)])
def test_batch_major_twin_matches_tpu_layout_and_pallas(B, H, dtype, tol):
    rs = np.random.RandomState(B * H)
    xw_bt = rs.randn(B, T, 8 * H).astype(np.float32)
    wh = (rs.randn(2, H, 4 * H) * 0.1).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = bilstm_batch_major(torch.from_numpy(xw_bt).to(tdt), torch.from_numpy(wh).to(tdt))
    assert got.shape == (B, T, 2 * H) and got.dtype == tdt
    tpu = bilstm_recurrence(torch.from_numpy(_tpu_layout(xw_bt)).to(tdt),
                            torch.from_numpy(wh).to(tdt))
    assert torch.equal(got, torch.from_numpy(_batch_major(tpu.float().numpy())).to(tdt))
    want = bilstm_pallas(jnp.asarray(_tpu_layout(xw_bt), dtype), jnp.asarray(wh, dtype),
                         batch_tile=8, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), _batch_major(np.asarray(want, np.float32)),
                               rtol=0, atol=tol)


def test_kernel_route_is_one_addmm_and_one_launch(monkeypatch):
    """The module's kernel route hands the addmm's [B, T, 8H] to the
    kernel's wrapper as it is: no flip, stack or contiguous copy."""
    from torch.overrides import TorchFunctionMode

    B, C, H = 3, 18, 128
    calls, seen = [], []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            calls.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    def wrapper(xw, wh):
        seen.append((tuple(xw.shape), xw.is_contiguous()))
        return torch.zeros(B, T, 2 * H)

    monkeypatch.setattr(lstm_mod, "bilstm_batch_major", wrapper)
    mod = BiLSTM(C, H, use_kernel=True)
    with torch.inference_mode(), Record():
        mod(torch.zeros(B, T, C))
    assert seen == [((B, T, 8 * H), True)]
    assert calls.count("addmm") == 1
    assert not {"flip", "stack", "contiguous"} & set(calls), calls


# mma.sync m16n8k16 fragment positions (PTX ISA), lane = 4 g + p, as
# [32 lanes, elements] index tensors of (row, column) in the tile
_L, _J8, _J4 = torch.arange(32)[:, None], torch.arange(8)[None, :], torch.arange(4)[None, :]
_A_RC = (_L // 4 + 8 * ((_J8 // 2) % 2), 2 * (_L % 4) + _J8 % 2 + 8 * (_J8 // 4))  # 16 x 16
_B_KN = (2 * (_L % 4) + _J4 % 2 + 8 * (_J4 // 2), (_L // 4).expand(32, 4))        # 16 x 8
_D_RC = (_L // 4 + 8 * (_J4 // 2), 2 * (_L % 4) + _J4 % 2)                         # 16 x 8


def _mma(d_frag, a_frag, b_frag):
    """One mma.sync m16n8k16 on per-lane fragments ([32, 8], [32, 4], [32, 4])."""
    a, b = torch.zeros(16, 16, dtype=a_frag.dtype), torch.zeros(16, 8, dtype=a_frag.dtype)
    a[_A_RC] = a_frag
    b[_B_KN] = b_frag
    return d_frag + (a @ b)[_D_RC]


@pytest.mark.parametrize("H", TC_WIDTHS)
def test_packed_fragments_hold_the_warps_gate_columns(H):
    """Each packed element is wh[k, col] with k and col where the kernel's
    lane expects its B fragment: warp w, gate q, n8 tile s, lane 4g + p,
    element e -> col q*H + 16w + 8s + g, k = 16kk + 2p + (e & 1) + 8(e >> 1)."""
    n = H // 16
    k_idx = torch.arange(H, dtype=torch.float64)[None, :, None].expand(2, H, 4 * H)
    c_idx = torch.arange(4 * H, dtype=torch.float64)[None, None, :].expand(2, H, 4 * H)
    pk = pack_wh_fragments(k_idx).reshape(2, n, n, 4, 32, 2, 4)
    pc = pack_wh_fragments(c_idx).reshape(2, n, n, 4, 32, 2, 4)
    kk, w, q, lane, s, e = np.meshgrid(np.arange(n), np.arange(n), np.arange(4), np.arange(32),
                                       np.arange(2), np.arange(4), indexing="ij")
    want_c = q * H + 16 * w + 8 * s + lane // 4
    want_k = 16 * kk + 2 * (lane % 4) + e % 2 + 8 * (e // 2)
    for d in range(2):
        np.testing.assert_array_equal(pc[d].numpy(), want_c)
        np.testing.assert_array_equal(pk[d].numpy(), want_k)
    # warp w's columns are units [16w, 16w + 16) of i, f, g and o
    for ww in range(n):
        cols = set(pc[0, :, ww].reshape(-1).long().tolist())
        assert cols == {g * H + 16 * ww + u for g in range(4) for u in range(16)}


@pytest.mark.parametrize("H", TC_WIDTHS)
def test_fragment_emulation_equals_matmul(H):
    """One step of the tensor-core kernel in plain torch: A fragments read
    from h as the kernel reads them, B fragments from the packed weights,
    the products by the PTX map, the accumulators put back at the gate
    columns the kernel's cell update takes them from."""
    n, BM = H // 16, 32
    rs = np.random.RandomState(H)
    h = torch.from_numpy(rs.uniform(-1, 1, (BM, H)).astype(np.float32)).double()
    wh = torch.from_numpy((rs.randn(2, H, 4 * H) * 0.1).astype(np.float32)).double()
    packed = pack_wh_fragments(wh).reshape(2, n, n, 4, 32, 2, 4)
    lanes = torch.arange(32)
    g, p = lanes // 4, lanes % 4
    for d in range(2):
        gates = torch.full((BM, 4 * H), float("nan"), dtype=h.dtype)
        for w in range(n):
            acc = torch.zeros(2, 4, 2, 32, 4, dtype=h.dtype)   # mt, gate, s, lane, e
            for kk in range(n):
                for mt in range(2):
                    col = kk * 16 + 2 * p
                    row = mt * 16 + g
                    # a[0] (g, 2p), a[1] (g + 8, 2p), a[2] (g, 2p + 8), a[3] (g + 8, 2p + 8)
                    regs = [h[row, col], h[row, col + 1], h[row + 8, col], h[row + 8, col + 1],
                            h[row, col + 8], h[row, col + 9], h[row + 8, col + 8],
                            h[row + 8, col + 9]]
                    a_frag = torch.stack(regs, dim=1)
                    for q in range(4):
                        for s in range(2):
                            acc[mt, q, s] = _mma(acc[mt, q, s], a_frag, packed[d, kk, w, q, :, s])
            for mt in range(2):
                for q in range(4):
                    for s in range(2):
                        for e in range(4):
                            gates[mt * 16 + g + 8 * (e // 2),
                                  q * H + 16 * w + 8 * s + 2 * p + e % 2] = acc[mt, q, s, :, e]
        assert not torch.isnan(gates).any()
        torch.testing.assert_close(gates, h @ wh[d], rtol=0, atol=1e-6)
