"""The CUDA kernels against their plain twins, on the card.

These tests need a CUDA device and skip without one (run them on a GPU host
with `python -m pytest --noconftest tests/test_torch_kernel_cuda.py`; the
repository's conftest imports jax).  Bounds: f32 kernel vs f32 twin atol
2e-4 (summation order only), with the trained hifi weights and with seeded
random 4-head weights; bf16 kernel vs the f32 twin within 1e-2 (the bf16
bound of tests/test_pallas_pileup.py, which holds it with random weights
and random counts, as here: with trained weights, random counts are no
pileup a caller makes and bf16 itself moves them by ~2e-2).  bf16 at the
pileup net's widths runs the three tensor-core launches of
csrc/pileup_tc.cu; each is held against its plain twin on the same input,
with the random 4-head weights: max |d| <= 2e-2 (a rounding flip of h, one
bf16 ulp, 2^-8 near 1, carried through the recurrence's later steps: up to
4 ulps measured) and mean |d| <= 1e-4 (flips are rare, ~1e-6 on average;
a misplaced fragment moves the mean by ~1e-1).
"""

import numpy as np
import pytest
import torch

from clair3_tpu_torch.cli import load_model
from clair3_tpu_torch.models import PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.ops import bilstm as k2
from clair3_tpu_torch.ops import fa_conv1 as k3
from clair3_tpu_torch.ops import pileup_full as pf
from clair3_tpu_torch.ops.lstm import BiLSTM, bilstm
from clair3_tpu_torch.testing import (bf16_ulps, random_counts, random_variables,
                                      trained_fixture_path)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _net(which, device):
    if which == "hifi":
        return load_model(trained_fixture_path("pileup_hifi.npz"), "pileup", device,
                          torch.float32)
    net = PileupNet(add_indel_length=True)
    net.load_state_dict(from_jax_variables(random_variables(net, seed=5)))
    return net.to(device).eval()


@pytest.mark.parametrize("batch", [1, 31, 32, 33, 256, 1000, 4096])
@pytest.mark.parametrize("which,dtype,tol", [("hifi", torch.float32, 2e-4),
                                             ("random4", torch.float32, 2e-4),
                                             ("random4", torch.bfloat16, 1e-2)])
def test_kernel_matches_plain(device, batch, which, dtype, tol):
    net = _net(which, device)
    trunk, heads = net.kernel_operands()
    x = torch.from_numpy(random_counts(batch, (batch, 33, 18))).to(device)
    with torch.inference_mode():
        before, kernels = pf.launches, dict(pf.kernel_launches)
        got = pf.pileup_full(x, *trunk, heads, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert pf.launches == before + 1
        # f32: the SIMT kernel; bf16: the three tensor-core launches
        tc = dtype == torch.bfloat16
        assert {k: v - kernels[k] for k, v in pf.kernel_launches.items()} == {
            "pileup_l1_tc": tc, "pileup_l2_tc": tc, "pileup_head": tc, "pileup_full": not tc}
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


@pytest.mark.parametrize("batch", [1, 33, 1000])
def test_pileup_tc_launches_match_their_twins(device, batch):
    """L1, L2 and L3 each against its plain twin on the same input."""
    net = _net("random4", device)
    trunk, heads = net.kernel_operands()
    wi1, wh1, b1, wi2, wh2, b2, wd, bd = trunk
    dt = torch.bfloat16
    packed = net.packed_operands(dt, device)
    assert packed.tc
    x = torch.from_numpy(random_counts(batch, (batch, 33, 18))).to(device, dt)
    with torch.inference_mode():
        h1 = pf.launch_l1(x, packed)
        h2 = pf.launch_l2(h1, packed)
        probs = pf.launch_head(h2, packed)
        trunk_out = pf.launch_head(h2, packed, with_heads=False)
        torch.cuda.synchronize()
        pairs = ((h1, pf.pileup_l1_reference(x, wi1, wh1, b1, dt)),
                 (h2, pf.pileup_l2_reference(h1, wi2, wh2, b2, dt)),
                 (probs, pf.pileup_head_reference(h2, wd, bd, heads, dt)),
                 (trunk_out, pf.pileup_head_reference(h2, wd, bd, (), dt)))
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        d = (got.float() - want.float()).abs()
        assert d.max().item() <= 2e-2 and d.mean().item() <= 1e-4


def test_pileup_tc_empty_batch_launches_nothing(device):
    net = _net("hifi", device)
    net.compute_dtype, net.use_kernel = torch.bfloat16, True
    before = pf.launches
    with torch.inference_mode():
        out = net(torch.zeros(0, 33, 18, dtype=torch.int16, device=device))
    assert out.shape == (0, 24) and pf.launches == before


def test_bf16_at_other_widths_is_refused(device):
    """bf16 runs only on the tensor-core launches, at the net's widths:
    other widths raise and launch nothing."""
    rs = np.random.RandomState(3)
    shapes = ((2, 4, 64), (2, 16, 64), (2, 64), (2, 32, 64), (2, 16, 64), (2, 64), (5, 32, 8),
              (8,))
    trunk = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(device) for s in shapes]
    x = torch.from_numpy(random_counts(1, (4, 5, 4))).to(device)
    before = dict(pf.kernel_launches)
    with pytest.raises(ValueError, match="widths"):
        pf.pileup_trunk(x, *trunk, compute_dtype=torch.bfloat16)
    assert pf.kernel_launches == before
    got = pf.pileup_trunk(x, *trunk, compute_dtype=torch.float32)
    want = pf.pileup_trunk_reference(x, *trunk, compute_dtype=torch.float32)
    assert (got - want).abs().max().item() <= 2e-4 * max(1.0, want.abs().max().item())


def test_pileup_tc_refused_launch_raises(device):
    """A head whose L5 needs more shared memory than a block may have: the
    refused launch raises, nothing falls back."""
    trunk, _ = _net("hifi", device).kernel_operands()
    L5 = 2000
    heads = (torch.zeros(128, L5, device=device), torch.zeros(L5, device=device),
             torch.zeros(L5, 3, device=device), torch.zeros(3, device=device))
    packed = pf.pack_pileup_operands(trunk, heads, torch.bfloat16, device)
    assert packed.tc
    with pytest.raises(RuntimeError, match="pileup_head"):
        pf.pileup_full_packed(torch.zeros(4, 33, 18, device=device), packed)


@pytest.mark.parametrize("batch", [1, 11, 256])
@pytest.mark.parametrize("depth,channels", [(55, 8), (89, 9), (89, 8), (55, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fa_conv1_matches_plain(device, batch, depth, channels, dtype):
    rs = np.random.RandomState(depth * channels + batch)
    x = torch.from_numpy(rs.randint(-100, 101, (batch, depth, 33, channels))
                         .astype(np.int8)).to(device)
    ops = [torch.from_numpy(o.astype(np.float32)).to(device) for o in (
        rs.randn(3, 3, channels, 64) * 0.2, rs.randn(64) * 0.1, rs.rand(64) + 0.5,
        rs.randn(64) * 0.1, rs.randn(64) * 0.3, rs.rand(64) + 0.5)]
    before = k3.launches
    got = k3.fa_conv1(x, *ops, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = k3.fa_conv1_reference(x, *ops, compute_dtype=dtype)
    assert got.shape == want.shape == (batch, -(-depth // 2), 17, 64)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    # NCHW memory under the NHWC shape: the net's permute is free
    assert got.permute(0, 3, 1, 2).is_contiguous()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert bf16_ulps(got, want) <= 2


@pytest.mark.parametrize("batch", [1, 256, 1000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_bilstm_matches_plain(device, batch, dtype, tol):
    H = 128
    rs = np.random.RandomState(batch)
    xw = torch.from_numpy(rs.randn(33, 2, batch, 4 * H).astype(np.float32)).to(device, dtype)
    wh = torch.from_numpy((rs.randn(2, H, 4 * H) * 0.1).astype(np.float32)).to(device, dtype)
    before = k2.launches
    got = k2.bilstm_recurrence(xw, wh)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = k2.bilstm_recurrence_reference(xw, wh)
    assert got.shape == (33, 2, batch, H) and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("batch", [256, 1000, 4096])
@pytest.mark.parametrize("H", [128, 160])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("layout", ["tpu", "batch-major"])
def test_bilstm_layouts_and_widths(device, batch, H, dtype, tol, layout):
    """Both layouts (the batch-major one read and written by strides, with
    direction 1 walked backwards) at both layer widths; bf16 at these widths
    is the tensor-core kernel."""
    rs = np.random.RandomState(batch + H)
    shape = (33, 2, batch, 4 * H) if layout == "tpu" else (batch, 33, 8 * H)
    xw = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device, dtype)
    wh = torch.from_numpy((rs.randn(2, H, 4 * H) * 0.1).astype(np.float32)).to(device, dtype)
    kernel, twin = ((k2.bilstm_recurrence, k2.bilstm_recurrence_reference) if layout == "tpu"
                    else (k2.bilstm_batch_major, k2.bilstm_batch_major_reference))
    before = k2.launches
    got = kernel(xw, wh)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = twin(xw, wh)
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_bilstm_module_kernel_route_bf16(device):
    C, H = 18, 128
    rs = np.random.RandomState(10)
    mod = BiLSTM(C, H, use_kernel=True)
    with torch.no_grad():
        for p, scale in ((mod.wi, 1 / np.sqrt(C)), (mod.wh, 0.1), (mod.b, 0.1)):
            p.copy_(torch.from_numpy(rs.randn(*p.shape) * scale))
    mod = mod.to(device, torch.bfloat16)
    x = torch.from_numpy(rs.randn(300, 33, C).astype(np.float32)).to(device, torch.bfloat16)
    with torch.inference_mode():
        before = k2.launches
        got = mod(x)
        assert k2.launches == before + 1
        wi = mod.wi
        xw = torch.addmm(mod.b.reshape(-1), x.reshape(-1, C), torch.cat([wi[0], wi[1]], 1))
        want = k2.bilstm_batch_major_reference(xw.view(300, 33, -1), mod.wh)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2


def test_bilstm_module_kernel_route(device):
    C, H = 256, 160
    rs = np.random.RandomState(9)
    mod = BiLSTM(C, H, use_kernel=True)
    with torch.no_grad():
        for p, scale in ((mod.wi, 1 / np.sqrt(C)), (mod.wh, 0.1), (mod.b, 0.1)):
            p.copy_(torch.from_numpy(rs.randn(*p.shape) * scale))
    mod = mod.to(device)
    x = torch.from_numpy(rs.randn(300, 33, C).astype(np.float32)).to(device)
    with torch.inference_mode():
        before = k2.launches
        got = mod(x)
        assert k2.launches == before + 1
        want = bilstm(x, mod.wi, mod.wh, mod.b)
    assert (got - want).abs().max().item() <= 1e-5


def test_new_kernels_launch_nothing_on_empty_batches(device):
    ops = [torch.ones(3, 3, 8, 64, device=device)] + [torch.ones(64, device=device)] * 5
    before = k3.launches
    out = k3.fa_conv1(torch.zeros(0, 55, 33, 8, dtype=torch.int8, device=device), *ops)
    assert out.shape == (0, 28, 17, 64) and k3.launches == before
    before = k2.launches
    hs = k2.bilstm_recurrence(torch.zeros(33, 2, 0, 512, device=device),
                              torch.zeros(2, 128, 512, device=device))
    assert hs.shape == (33, 2, 0, 128) and k2.launches == before
