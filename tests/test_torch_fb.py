"""The port's ``FullAlignmentBinaryNet`` (``clair3_tpu_torch/models/fb.py``)
against the JAX package's, f32 on the CPU: the twin of
``tests/test_models.py::test_fb_binary_net``; the net on seeded weights
carried across by the bridge, on seeded int8 input, in eval mode, within
atol 1e-5 (the same f32 graph; convolution and einsum sum in other
orders); and the bridge's round trip of every leaf of the JAX net's own
initialisation, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair3_tpu.models import FullAlignmentBinaryNet as JaxFullAlignmentBinaryNet
from clair3_tpu_torch.models import FullAlignmentBinaryNet
from clair3_tpu_torch.models.bridge import from_jax_variables, to_jax_variables
from clair3_tpu_torch.models.params_io import flatten_tree
from clair3_tpu_torch.testing import random_variables


def _jax_init(depth=89, channels=8):
    x = jnp.zeros((2, depth, 33, channels), jnp.int8)
    return jax.device_get(JaxFullAlignmentBinaryNet(input_channels=channels).init(
        jax.random.PRNGKey(0), x, train=False))


def test_fb_binary_net():
    """``tests/test_models.py:78-86`` on the port: zeros in, ``(2, 1)`` out,
    every value in (0, 1)."""
    net = FullAlignmentBinaryNet()
    net.load_state_dict(from_jax_variables(_jax_init()), strict=True)
    with torch.inference_mode():
        y = net.eval()(torch.zeros((2, 89, 33, 8), dtype=torch.int8))
    assert y.shape == (2, 1)
    assert ((y > 0) & (y < 1)).all()


@pytest.mark.parametrize("depth,channels,seed", [(89, 8, 3), (55, 9, 4)])
def test_net_matches_jax_f32(depth, channels, seed):
    net = FullAlignmentBinaryNet(input_channels=channels)
    variables = random_variables(net, seed=seed)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    x = np.random.RandomState(seed).randint(-100, 101, (4, depth, 33, channels)).astype(np.int8)
    want = np.asarray(JaxFullAlignmentBinaryNet(input_channels=channels)
                      .apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max()
    print(f"[port-fb] depth {depth} x {channels}: p {got.ravel()} max |dp| {err:.3g}")
    assert got.shape == want.shape == (4, 1)
    assert np.ptp(want) > 1e-3  # the inputs separate the rows
    assert err <= 1e-5


def test_bridge_round_trips_every_leaf():
    v = _jax_init()
    state = from_jax_variables(v)
    net = FullAlignmentBinaryNet()
    assert set(state) == set(net.state_dict())
    assert state["conv1.conv.depthwise.weight"].shape == (8, 1, 3, 3)
    assert state["attn_mha.query.kernel"].shape == (96, 4, 24)
    assert state["attn_mha.out.kernel"].shape == (4, 24, 96)
    want, got = flatten_tree(v), flatten_tree(to_jax_variables(state))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype and np.array_equal(got[key], leaf), key
