"""Weight bridge of the PyTorch port: the committed JAX fixtures go to a
torch state_dict and back bit for bit, and load into the port's nets."""

import numpy as np
import pytest

from clair3_tpu.testing import trained_fixture_path
from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables, to_jax_variables
from clair3_tpu_torch.models.params_io import flatten_tree, load_variables

FIXTURES = ("pileup_hifi.npz", "pileup_ont.npz", "fa_hifi.npz", "fa_ont.npz")


@pytest.mark.parametrize("name", FIXTURES)
def test_npz_torch_npz_round_trip_is_bit_identical(name):
    raw = load_variables(trained_fixture_path(name), upcast=False)
    back = flatten_tree(to_jax_variables(from_jax_variables(raw)))
    want = flatten_tree(raw)
    assert set(back) == set(want)
    for key, v in want.items():
        assert back[key].dtype == v.dtype and back[key].shape == v.shape, key
        assert back[key].tobytes() == v.tobytes(), key


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_state_dict_loads_strictly(name):
    variables = load_variables(trained_fixture_path(name))
    params = variables["params"]
    if name.startswith("pileup"):
        net = PileupNet(add_indel_length="L5_3" in params)
    else:
        net = FullAlignmentNet(
            input_channels=params["conv1"]["conv"]["kernel"].shape[2])
    net.load_state_dict(from_jax_variables(variables), strict=True)
    net.eval()
    # the conv layout change: JAX [kh, kw, I, O] -> torch [O, I, kh, kw]
    if name.startswith("fa"):
        k = params["conv1"]["conv"]["kernel"]
        w = net.conv1.conv.weight.detach().numpy()
        np.testing.assert_array_equal(w[5, 2, 0, 1], k[0, 1, 2, 5])
    else:  # LSTM directions stack with the forward one in slot 0
        np.testing.assert_array_equal(net.LSTM2.wh.detach().numpy()[1],
                                      params["LSTM2"]["bwd"]["wh"])


def test_load_variables_upcasts_fp16():
    path = trained_fixture_path("pileup_hifi.npz")
    assert load_variables(path, upcast=False)["params"]["L4"]["kernel"].dtype == np.float16
    assert load_variables(path)["params"]["L4"]["kernel"].dtype == np.float32
