"""Pileup net of the PyTorch port against the JAX package, on the CPU.

* the port's plain ``PileupNet`` (f32) against the JAX ``PileupNet`` scan
  path: atol 1e-5 (both compute the same f32 graph; measured ~1e-6);
* the port's ``pileup_full_reference`` (the CUDA kernel's plain twin)
  against ``pileup_full_pallas`` run in Pallas interpret mode, as
  ``tests/test_pallas_pileup.py`` runs it: f32 atol 2e-4, bf16 within 1e-2
  (the bounds of that file);
* the flatten-order isolation of ``tests/test_pallas_pileup.py``, on the
  port's trunk;
* ``PileupNet``'s kernel route packs its operands once per (dtype, device)
  and again after ``load_state_dict``.

Inputs are numpy arrays made from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair3_tpu.models import PileupNet as JaxPileupNet
from clair3_tpu.ops.lstm import _bilstm_fused_scan
from clair3_tpu.ops.pallas_pileup import pileup_full_pallas, pileup_trunk_pallas
from clair3_tpu.testing import load_trained_fixture
from clair3_tpu_torch.models import PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.ops import pileup_full as pf
from clair3_tpu_torch.testing import random_counts, random_variables


def _variables(which):
    if which == "hifi":
        return False, load_trained_fixture("pileup_hifi.npz")
    return True, random_variables(PileupNet(add_indel_length=True), seed=5)


def _port(variables, add_indel, **kw):
    net = PileupNet(add_indel_length=add_indel, **kw)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net


def _pallas_args(v):
    p = v["params"]
    stack = lambda name: [np.stack([p[name]["fwd"][k], p[name]["bwd"][k]])  # noqa: E731
                          for k in ("wi", "wh", "b")]
    wd = p["L4"]["kernel"].reshape(33, -1, p["L4"]["kernel"].shape[-1])
    heads = []
    names = ("Y_gt21_logits", "Y_genotype_logits", "Y_indel_length_logits_1",
             "Y_indel_length_logits_2")
    for i in range(4 if "L5_3" in p else 2):
        heads += [p[f"L5_{i + 1}"]["kernel"], p[f"L5_{i + 1}"]["bias"],
                  p[names[i]]["kernel"], p[names[i]]["bias"]]
    return (*stack("LSTM1"), *stack("LSTM2"), wd, p["L4"]["bias"]), tuple(heads)


@pytest.mark.parametrize("which", ["hifi", "random4"])
def test_plain_net_matches_jax_scan_f32(which):
    add_indel, v = _variables(which)
    x = random_counts(0, (12, 33, 18))
    want = np.asarray(JaxPileupNet(add_indel_length=add_indel).apply(v, x, train=False))
    got = _port(v, add_indel)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (12, 90 if add_indel else 24)
    err = np.abs(got - want).max()
    print(f"[port-pileup] plain vs JAX scan f32, {which}: max |dp| {err:.3g}")
    assert err <= 1e-5


@pytest.mark.parametrize("which", ["hifi", "random4"])
def test_kernel_twin_matches_pallas_interpret(which):
    add_indel, v = _variables(which)
    x = random_counts(1, (12, 33, 18))
    trunk, heads = _pallas_args(v)
    net = _port(v, add_indel, use_kernel=True)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 2e-4),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = np.asarray(pileup_full_pallas(
            x, *trunk, heads, compute_dtype=jdt, batch_tile=8, interpret=True))
        net.compute_dtype = tdt
        before = pf.launches
        got = net(torch.from_numpy(x)).detach().numpy()
        assert pf.launches == before  # a CPU tensor never reaches the kernel
        err = np.abs(got - want).max()
        print(f"[port-pileup] twin vs Pallas interpret {tdt}, {which}: "
              f"max |dp| {err:.3g}")
        assert got.shape == want.shape and err <= tol


def _tiny_trunk_args(seed, T=5, C=4, H1=8, H2=8):
    r = np.random.RandomState(seed)
    f = lambda *s: (r.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    return (f(2, C, 4 * H1), f(2, H1, 4 * H1), f(2, 4 * H1),
            f(2, 2 * H1, 4 * H2), f(2, H2, 4 * H2), f(2, 4 * H2)), r


def test_trunk_twin_matches_pallas_interpret_ragged_batch():
    """The trunk mode at a batch that is not a multiple of the tile."""
    T, C, D = 5, 4, 8
    args, r = _tiny_trunk_args(3, T=T, C=C)
    x = r.randint(-30, 30, (11, T, C)).astype(np.int32)
    wd, bd = (r.randn(T, 16, D) * 0.3).astype(np.float32), np.zeros(D, np.float32)
    want = np.asarray(pileup_trunk_pallas(x, *args, wd, bd, compute_dtype=jnp.float32,
                                          batch_tile=8, interpret=True))
    got = pf.pileup_trunk(*(torch.from_numpy(a) for a in (x, *args, wd, bd)),
                          compute_dtype=torch.float32).numpy()
    assert got.shape == (11, D)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_trunk_flatten_order():
    """The dense accumulation must follow reshape(B, T*2H) row order:
    zeroing all wd rows except time t's forward (or backward) block
    isolates h_fwd(t) (or h_bwd(t))."""
    T, C, H2, D = 5, 4, 8, 8
    args, r = _tiny_trunk_args(2, T=T, C=C, H2=H2)
    x = (r.randn(8, T, C) * 0.3).astype(np.float32)
    wi1, wh1, b1, wi2, wh2, b2 = args
    xw = x @ wi1[0], x @ wi1[1]
    h1 = _bilstm_fused_scan(xw[0] + b1[0], xw[1] + b1[1], wh1[0], wh1[1])
    xw2 = h1 @ wi2[0], h1 @ wi2[1]
    h2 = np.asarray(_bilstm_fused_scan(xw2[0] + b2[0], xw2[1] + b2[1], wh2[0], wh2[1]))
    for t, half in ((1, 0), (3, 1)):
        wd = np.zeros((T, 2 * H2, D), np.float32)
        block = r.randn(H2, D).astype(np.float32)
        wd[t, half * H2:(half + 1) * H2] = block
        out = pf.pileup_trunk(*(torch.from_numpy(a) for a in (x, *args, wd)),
                              torch.zeros(D), compute_dtype=torch.float32)
        want = h2[:, t, half * H2:(half + 1) * H2] @ block
        scale, alpha = 1.0507009873554805, 1.6732632423543772
        want = scale * np.where(want > 0, want, alpha * np.expm1(want))
        np.testing.assert_allclose(out.numpy(), want, atol=1e-4)


def test_kernel_launch_refuses_a_cpu_tensor():
    """The launch path never computes on the CPU: it raises."""
    args, _ = _tiny_trunk_args(4)
    x = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pf._launch(x, tuple(torch.from_numpy(a) for a in args)
                   + (torch.zeros(5, 16, 8), torch.zeros(8)), (), torch.float32)


def test_packed_operands_are_kept_and_rebuilt_after_load_state_dict():
    net = PileupNet(add_indel_length=True, use_kernel=True)
    net.load_state_dict(from_jax_variables(random_variables(net, seed=5)))
    first = net.packed_operands(torch.bfloat16, torch.device("cpu"))
    assert net.packed_operands(torch.bfloat16, torch.device("cpu")) is first
    other = net.packed_operands(torch.float32, torch.device("cpu"))
    assert other is not first and other.dtype == torch.float32
    wh1_before = other.trunk[1].clone()

    net.load_state_dict(from_jax_variables(random_variables(net, seed=6)))
    again = net.packed_operands(torch.float32, torch.device("cpu"))
    assert again is not other
    assert not torch.equal(again.trunk[1], wh1_before)
    assert torch.equal(again.trunk[1], net.LSTM1.wh.detach())
    fresh = PileupNet(add_indel_length=True, use_kernel=True)
    fresh.load_state_dict(net.state_dict())
    x = torch.from_numpy(random_counts(2, (3, 33, 18)))
    with torch.inference_mode():
        assert torch.equal(net(x), fresh(x))
