"""Full-alignment net of the PyTorch port against the JAX package, f32 on
the CPU, on both committed geometries (hifi: depth 55 x 8 channels; ont:
depth 89 x 9 channels with dwell).  Bound: atol 1e-4 on probabilities (the
two conv libraries sum in different orders; measured ~1e-13 here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair3_tpu.models import FullAlignmentNet as JaxFullAlignmentNet
from clair3_tpu.models.full_alignment import pyramid_pool as jax_pyramid_pool
from clair3_tpu.testing import load_trained_fixture
from clair3_tpu_torch.models import FullAlignmentNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.models.full_alignment import pyramid_pool


@pytest.mark.parametrize("name,depth,channels", [("fa_hifi.npz", 55, 8),
                                                 ("fa_ont.npz", 89, 9)])
def test_net_matches_jax_f32(name, depth, channels):
    v = load_trained_fixture(name)
    x = np.random.RandomState(7).randint(-100, 101, (3, depth, 33, channels)).astype(np.int8)
    want = np.asarray(JaxFullAlignmentNet(add_indel_length=True, input_channels=channels)
                      .apply(v, x, train=False))
    net = FullAlignmentNet(input_channels=channels)
    net.load_state_dict(from_jax_variables(v), strict=True)
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max()
    print(f"[port-fa] {name}: max |dp| {err:.3g}")
    assert got.shape == want.shape == (3, 90)
    assert err <= 1e-4


@pytest.mark.parametrize("hw", [(28, 17), (7, 5), (45, 17), (4, 3)])
def test_pyramid_pool_flattens_in_nhwc_order(hw):
    """Centred padding and the NHWC flatten must match the JAX pool exactly,
    or the L4 weights line up wrong."""
    H, W = hw
    x = np.random.RandomState(H * W).rand(2, H, W, 6).astype(np.float32)
    want = np.asarray(jax_pyramid_pool(jnp.asarray(x)))
    got = pyramid_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_array_equal(got, want)
