"""The pileup CUDA kernel against its plain twin, on the card.

These tests need a CUDA device and skip without one (run them on a GPU host
with `python -m pytest --noconftest tests/test_torch_kernel_cuda.py`; the
repository's conftest imports jax).  Bounds: f32 kernel vs f32 twin atol
2e-4 (summation order only), with the trained hifi weights and with seeded
random 4-head weights; bf16 kernel vs the f32 twin within 1e-2 (the bf16
bound of tests/test_pallas_pileup.py, which holds it with random weights
and random counts, as here: with trained weights, random counts are no
pileup a caller makes and bf16 itself moves them by ~2e-2).
"""

import pytest
import torch

from clair3_tpu.testing import trained_fixture_path
from clair3_tpu_torch.cli import load_model
from clair3_tpu_torch.models import PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.ops import pileup_full as pf
from clair3_tpu_torch.testing import random_counts, random_variables

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _net(which, device):
    if which == "hifi":
        return load_model(trained_fixture_path("pileup_hifi.npz"), "pileup", device,
                          torch.float32)
    net = PileupNet(add_indel_length=True)
    net.load_state_dict(from_jax_variables(random_variables(net, seed=5)))
    return net.to(device)


@pytest.mark.parametrize("batch", [1, 256, 1000])
@pytest.mark.parametrize("which,dtype,tol", [("hifi", torch.float32, 2e-4),
                                             ("random4", torch.float32, 2e-4),
                                             ("random4", torch.bfloat16, 1e-2)])
def test_kernel_matches_plain(device, batch, which, dtype, tol):
    net = _net(which, device)
    trunk, heads = net.kernel_operands()
    x = torch.from_numpy(random_counts(batch, (batch, 33, 18))).to(device)
    with torch.inference_mode():
        before = pf.launches
        got = pf.pileup_full(x, *trunk, heads, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert pf.launches == before + 1
        assert got.shape == (batch, 24 if which == "hifi" else 90)
        assert torch.isfinite(got).all()
        want = pf.pileup_full_reference(x, *trunk, heads, compute_dtype=torch.float32)
        assert (got - want).abs().max().item() <= tol

        t_got = pf.pileup_trunk(x, *trunk, compute_dtype=dtype).float()
        t_want = pf.pileup_trunk_reference(x, *trunk, compute_dtype=dtype)
        if dtype == torch.float32:
            assert (t_got - t_want).abs().max().item() <= 2e-4 * max(1.0, t_want.abs().max().item())
        else:  # ~2.5 bf16 ulps: summation order flips the rounding of h and c
            assert torch.allclose(t_got, t_want, rtol=2e-2, atol=1e-2)


def test_empty_batch_launches_nothing(device):
    trunk, heads = _net("hifi", device).kernel_operands()
    before = pf.launches
    out = pf.pileup_full(torch.zeros(0, 33, 18, device=device), *trunk, heads,
                         compute_dtype=torch.float32)
    assert out.shape == (0, 24) and pf.launches == before
