"""The tensor-core route of the pileup net (``csrc/pileup_tc.cu``) on the
CPU: its three launches' plain twins, their operand packing and the
packed-operand cache, against the JAX package.

* the twins' composition (L1 -> L2 -> L3) equals ``pileup_full_reference``
  at f32 within 1e-5 (only the dense's summation order differs: one GEMM
  against the Pallas kernel's per-step sums);
* the composition equals ``pileup_full_pallas`` / ``pileup_trunk_pallas``
  in interpret mode: f32 within 2e-4, bf16 within 1e-2 (the bounds of
  ``tests/test_pallas_pileup.py``), hifi and random 4-head weights, ragged
  batches B = 1, 33 and 70;
* the packed wi1 (zero-padded from 18 to 32 rows), wi2 (K = 256) and wd
  (one "gate", K = T*2*H2) rebuild ``a @ w`` through a plain emulation of
  mma.sync m16n8k16 (PTX ISA fragment layouts) within 1e-6, float64 sums
  (a misplaced fragment moves a sum by ~0.1);
* the rounding point ``h = o * tanh(c_new)`` from the unrounded c: a
  variant of the L1 twin that takes tanh of the rounded c (K2's rounding)
  lands further from the Pallas kernel than the twin does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair3_tpu.ops.pallas_pileup import pileup_full_pallas, pileup_trunk_pallas
from clair3_tpu.testing import load_trained_fixture
from clair3_tpu_torch.models import PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.ops import pileup_full as pf
from clair3_tpu_torch.testing import random_counts, random_variables


def _net(which):
    if which == "hifi":
        net = PileupNet(add_indel_length=False)
        net.load_state_dict(from_jax_variables(load_trained_fixture("pileup_hifi.npz")))
    else:
        net = PileupNet(add_indel_length=True)
        net.load_state_dict(from_jax_variables(random_variables(net, seed=5)))
    return net.eval()


def _operands(which):
    trunk, heads = _net(which).kernel_operands()
    return tuple(w.detach() for w in trunk), tuple(w.detach() for w in heads)


def _composition(x, trunk, heads, dt):
    wi1, wh1, b1, wi2, wh2, b2, wd, bd = trunk
    h1 = pf.pileup_l1_reference(x, wi1, wh1, b1, dt)
    h2 = pf.pileup_l2_reference(h1, wi2, wh2, b2, dt)
    return pf.pileup_head_reference(h2, wd, bd, heads, dt)


@pytest.mark.parametrize("which", ["hifi", "random4"])
def test_twins_compose_to_the_whole_net_f32(which):
    trunk, heads = _operands(which)
    x = torch.from_numpy(random_counts(3, (9, 33, 18)))
    got = _composition(x, trunk, heads, torch.float32)
    want = pf.pileup_full_reference(x, *trunk, heads, compute_dtype=torch.float32)
    assert got.shape == want.shape == (9, 90 if which == "random4" else 24)
    assert (got - want).abs().max().item() <= 1e-5
    t_got = _composition(x, trunk, (), torch.float32)
    t_want = pf.pileup_trunk_reference(x, *trunk, compute_dtype=torch.float32)
    assert t_got.shape == (9, 128)
    assert (t_got - t_want).abs().max().item() <= 1e-5 * max(1.0, t_want.abs().max().item())


@pytest.mark.parametrize("batch", [1, 33, 70])
@pytest.mark.parametrize("which", ["hifi", "random4"])
def test_composition_matches_pallas_interpret(which, batch):
    trunk, heads = _operands(which)
    x = random_counts(batch + 7, (batch, 33, 18))
    np_trunk = [w.numpy() for w in trunk]
    np_heads = tuple(w.numpy() for w in heads)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 2e-4),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = np.asarray(pileup_full_pallas(x, *np_trunk, np_heads, compute_dtype=jdt,
                                             batch_tile=32, interpret=True))
        got = _composition(torch.from_numpy(x), trunk, heads, tdt).numpy()
        err = np.abs(got - want).max()
        print(f"[port-pileup-tc] composition vs Pallas interpret {tdt}, {which}, "
              f"B={batch}: max |dp| {err:.3g}")
        assert got.shape == want.shape and err <= tol


def test_trunk_composition_matches_pallas_interpret_ragged():
    trunk, _ = _operands("random4")
    x = random_counts(11, (33, 33, 18))
    want = np.asarray(pileup_trunk_pallas(x, *(w.numpy() for w in trunk),
                                          compute_dtype=jnp.float32, batch_tile=32,
                                          interpret=True))
    got = _composition(torch.from_numpy(x), trunk, (), torch.float32).numpy()
    assert got.shape == (33, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * max(1.0, np.abs(want).max()))


# mma.sync m16n8k16 fragment positions (PTX ISA), lane = 4 g + p, as
# [32 lanes, elements] index tensors of (row, column) in the tile
_L, _J8, _J4 = torch.arange(32)[:, None], torch.arange(8)[None, :], torch.arange(4)[None, :]
_A_RC = (_L // 4 + 8 * ((_J8 // 2) % 2), 2 * (_L % 4) + _J8 % 2 + 8 * (_J8 // 4))  # 16 x 16
_B_KN = (2 * (_L % 4) + _J4 % 2 + 8 * (_J4 // 2), (_L // 4).expand(32, 4))        # 16 x 8
_D_RC = (_L // 4 + 8 * (_J4 // 2), 2 * (_L % 4) + _J4 % 2)                         # 16 x 8


def _emulate(a, packed, gates):
    """``a [32, K]`` times the matrix packed by ``pack_wh_fragments``
    (``[K/16, warps, gates, 32, 2, 4]``), as the kernels' warps compute it:
    A fragments of two m16 tiles per k16 step, B fragments from the packed
    lanes, mma.sync by the PTX map, accumulators put back at the columns
    the kernels read them from (``q*N/gates + 16w + 8s + 2p + (e & 1)``,
    row ``mt*16 + g + 8*(e >> 1)``)."""
    KS, NW, G = packed.shape[:3]
    assert packed.shape[3:] == (32, 2, 4)
    N = NW * 16 * G
    a_frag = a.reshape(2, 16, KS, 16).permute(0, 2, 1, 3)[:, :, _A_RC[0], _A_RC[1]]
    a_tile = torch.zeros(2, KS, 16, 16, dtype=a.dtype)
    a_tile[:, :, _A_RC[0], _A_RC[1]] = a_frag
    b_tile = torch.zeros(KS, NW, G, 2, 16, 8, dtype=a.dtype)
    b_tile[..., _B_KN[0], _B_KN[1]] = packed.permute(0, 1, 2, 4, 3, 5)
    d = torch.einsum("mkij,kwqsjn->mwqsin", a_tile, b_tile)[..., _D_RC[0], _D_RC[1]]
    mt, w, q, s, lane, e = torch.meshgrid(*(torch.arange(n) for n in d.shape), indexing="ij")
    out = torch.full((32, N), float("nan"), dtype=a.dtype)
    out[mt * 16 + lane // 4 + 8 * (e // 2),
        q * (N // G) + 16 * w + 8 * s + 2 * (lane % 4) + e % 2] = d
    assert G == gates and not torch.isnan(out).any()
    return out


def test_packed_operands_rebuild_the_products():
    trunk, heads = _operands("hifi")
    packed = pf.pack_pileup_operands(trunk, heads, torch.bfloat16, "cpu")
    assert packed.tc
    wi1, wh1, _, wi2, wh2, _, wd, _ = (w.double() for w in packed.trunk)
    fr = {k: v.double() for k, v in packed.frags.items()}
    rs = np.random.RandomState(8)
    a = lambda K: torch.from_numpy(rs.uniform(-1, 1, (32, K))).to(torch.bfloat16).double()  # noqa: E731
    x = torch.zeros(32, pf.TC_MAX_C, dtype=torch.float64)
    x[:, :18] = a(18)                          # the kernel stages C = 18 zero-padded to 32
    h1, h2, seq = a(128), a(160), a(wd.shape[0] * 320)
    cases = (("wi1", x, fr["wi1"], x[:, :18] @ wi1[1], 4, 1),
             ("wh1", h1, fr["wh1"], h1 @ wh1[0], 4, 0),
             ("wi2", seq[:, :256], fr["wi2"], seq[:, :256] @ wi2[1], 4, 1),
             ("wh2", h2, fr["wh2"], h2 @ wh2[1], 4, 1),
             ("wd", seq, fr["wd"][None], seq @ wd.reshape(-1, 128), 1, 0))
    for name, a_in, frags, want, gates, d in cases:
        got = _emulate(a_in, frags[d], gates)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6, msg=name)


def _step_tanh_of_rounded_c(gates, c, dt):
    """K2's rounding (pallas_lstm._kernel): tanh of the rounded c."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = (torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)).to(dt)
    return (torch.sigmoid(o) * torch.tanh(c_new.float())).to(dt), c_new


def test_l1_twin_takes_tanh_of_the_unrounded_c(monkeypatch):
    trunk, _ = _operands("hifi")
    wi1, wh1, b1, wi2, wh2, b2, wd, bd = trunk
    x = random_counts(21, (24, 33, 18))
    want = np.asarray(pileup_trunk_pallas(x, *(w.numpy() for w in trunk),
                                          compute_dtype=jnp.bfloat16, batch_tile=8,
                                          interpret=True), np.float32)
    dt, xt = torch.bfloat16, torch.from_numpy(x)

    def trunk_from(h1):
        h2 = pf.pileup_l2_reference(h1, wi2, wh2, b2, dt)
        return pf.pileup_head_reference(h2, wd, bd, (), dt).float().numpy()

    twin = trunk_from(pf.pileup_l1_reference(xt, wi1, wh1, b1, dt))
    with monkeypatch.context() as m:
        m.setattr(pf, "_lstm_step", _step_tanh_of_rounded_c)
        h1_variant = pf.pileup_l1_reference(xt, wi1, wh1, b1, dt)
    variant = trunk_from(h1_variant)
    e_twin, e_variant = np.abs(twin - want).mean(), np.abs(variant - want).mean()
    print(f"[port-pileup-tc] mean |d trunk| vs Pallas bf16: twin {e_twin:.3g}, "
          f"tanh of rounded c {e_variant:.3g}")
    assert e_variant > 2 * e_twin


def test_route_by_dtype_and_shape():
    assert pf.tc_route(torch.bfloat16, 18, 33, 128, 160, 128)
    assert pf.tc_route(torch.bfloat16, 32, 33, 128, 160, 128)
    assert not pf.tc_route(torch.float32, 18, 33, 128, 160, 128)
    assert not pf.tc_route(torch.bfloat16, 33, 33, 128, 160, 128)
    assert not pf.tc_route(torch.bfloat16, 18, 33, 64, 160, 128)
    trunk, heads = _operands("random4")
    f32 = pf.pack_pileup_operands(trunk, heads, torch.float32, "cpu")
    assert not f32.tc and f32.frags is None and f32.n_heads == 4
    bf = pf.pack_pileup_operands(trunk, heads, torch.bfloat16, "cpu")
    assert bf.tc and bf.offsets == (0, 21, 24, 57, 90)
    assert {k: tuple(v.shape) for k, v in bf.frags.items()} == {
        "wi1": (2, 2, 8, 4, 32, 2, 4), "wh1": (2, 8, 8, 4, 32, 2, 4),
        "wi2": (2, 16, 10, 4, 32, 2, 4), "wh2": (2, 10, 10, 4, 32, 2, 4),
        "wd": (660, 8, 1, 32, 2, 4)}
    assert all(v.dtype == torch.bfloat16 and v.is_contiguous() for v in bf.frags.values())
    # bf16 at other widths: packed for the plain version, refused by the launches
    args = [torch.zeros(s) for s in ((2, 4, 32), (2, 8, 32), (2, 32), (2, 16, 32), (2, 8, 32),
                                     (2, 32), (5, 16, 8), (8,))]
    narrow = pf.pack_pileup_operands(args, (), torch.bfloat16, "cpu")
    assert not narrow.tc and narrow.frags is None
    before = dict(pf.kernel_launches)
    with pytest.raises(ValueError, match="widths"):
        pf._run(torch.zeros(2, 5, 4), narrow, with_heads=False)
    assert pf.kernel_launches == before


def test_packed_route_on_the_cpu_is_the_plain_net():
    trunk, heads = _operands("random4")
    x = torch.from_numpy(random_counts(4, (5, 33, 18)))
    for dt in (torch.float32, torch.bfloat16):
        packed = pf.pack_pileup_operands(trunk, heads, dt, "cpu")
        before, kernels = pf.launches, dict(pf.kernel_launches)
        got = pf.pileup_full_packed(x, packed)
        assert pf.launches == before and pf.kernel_launches == kernels
        assert torch.equal(got, pf.pileup_full_reference(x, *trunk, heads, compute_dtype=dt))
        assert torch.equal(pf.pileup_trunk_packed(x, packed),
                           pf.pileup_trunk(x, *trunk, compute_dtype=dt))


def test_launches_refuse_cpu_tensors():
    trunk, heads = _operands("hifi")
    packed = pf.pack_pileup_operands(trunk, heads, torch.bfloat16, "cpu")
    for launch, t in ((pf.launch_l1, torch.zeros(2, 33, 18, dtype=torch.bfloat16)),
                      (pf.launch_l2, torch.zeros(2, 33, 256, dtype=torch.bfloat16)),
                      (pf.launch_head, torch.zeros(2, 33, 320, dtype=torch.bfloat16))):
        with pytest.raises(ValueError, match="CUDA"):
            launch(t, packed)
