"""Reference ``.pt`` checkpoints through the port's loader, against the JAX
package and against the reference modules themselves.

``RefClair3P`` / ``RefClair3F`` (tests/test_convert_real_checkpoint.py)
rebuild the reference's torch module layout key for key.  Seeded random
weights are saved as ``torch.save(state_dict)`` files; the port loads them
with ``cli.load_model`` (``models/convert.py`` -> ``models/bridge.py`` ->
the port's net, the route of ``call --model_path``), the JAX package with
``clair3_tpu.models.convert`` -> its flax net.  Both nets then see the same
numpy input at f32 on the CPU: pileup within 1e-5, full alignment within
1e-4, at 8 and 9 input channels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_convert_real_checkpoint import RefClair3F, RefClair3P, _randomize
from test_zoo_schema import synth_state_dict

from clair3_tpu.models import FullAlignmentNet as JaxFullAlignmentNet
from clair3_tpu.models import PileupNet as JaxPileupNet
from clair3_tpu.models.convert import convert_checkpoint as jax_convert_checkpoint
from clair3_tpu_torch.cli import load_model
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.models.convert import convert_checkpoint
from clair3_tpu_torch.models.convert import main as convert_main
from clair3_tpu_torch.models.params_io import load_variables
from clair3_tpu_torch.models.schema import (full_alignment_state_dict_schema,
                                            pileup_state_dict_schema)
from clair3_tpu_torch.models.zoo import _MODELS

CPU = torch.device("cpu")
PILEUP_TOL = 1e-5
FA_TOL = 1e-4


def _port(path, kind):
    return load_model(path, kind, CPU, torch.float32)


def _port_forward(net, x):
    with torch.inference_mode():
        return net(torch.from_numpy(x)).numpy()


def _save(tmp_path, obj, name):
    path = str(tmp_path / name)
    torch.save(obj, path)
    return path


@pytest.mark.parametrize("add_indel_length", [False, True], ids=["2heads", "4heads"])
def test_pileup_pt_matches_jax_and_reference(tmp_path, add_indel_length):
    ref = _randomize(RefClair3P(add_indel_length=add_indel_length), 0).eval()
    path = _save(tmp_path, ref.state_dict(), "pileup.pt")
    x = np.random.default_rng(0).integers(-30, 30, size=(5, 33, 18)).astype(np.int32)

    port = _port(path, "pileup")
    assert port.n_heads == (4 if add_indel_length else 2)
    got = _port_forward(port, x)
    jax_net = JaxPileupNet(add_indel_length=add_indel_length)
    want = np.asarray(jax_net.apply(jax_convert_checkpoint(path, "pileup"), jnp.asarray(x)))
    with torch.no_grad():
        ref_out = ref(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 90 if add_indel_length else 24)
    np.testing.assert_allclose(got, want, atol=PILEUP_TOL, rtol=0)
    np.testing.assert_allclose(got, ref_out, atol=PILEUP_TOL, rtol=0)


@pytest.mark.parametrize("channels", [8, 9])  # 9: the *_with_mv dwell channel
def test_full_alignment_pt_matches_jax_and_reference(tmp_path, channels):
    ref = _randomize(RefClair3F(add_indel_length=True, input_channels=channels),
                     2 + channels).eval()
    path = _save(tmp_path, ref.state_dict(), "full_alignment.pt")
    x = np.random.default_rng(2).integers(-100, 100, size=(3, 89, 33, channels)).astype(np.int8)

    port = _port(path, "full_alignment")
    assert port.input_channels == channels
    got = _port_forward(port, x)
    want = np.asarray(JaxFullAlignmentNet(add_indel_length=True).apply(
        jax_convert_checkpoint(path, "full_alignment"), jnp.asarray(x), train=False))
    with torch.no_grad():
        ref_out = ref(torch.from_numpy(x.astype(np.int32))).numpy()
    assert got.shape == want.shape == (3, 90)
    np.testing.assert_allclose(got, want, atol=FA_TOL, rtol=0)
    np.testing.assert_allclose(got, ref_out, atol=FA_TOL, rtol=0)


@pytest.mark.parametrize("wrap", ["state_dict", "ddp", "both"])
def test_wrapped_and_prefixed_checkpoints_load_the_same_net(tmp_path, wrap):
    """``{"state_dict": ...}`` wrappers and DDP ``module.`` prefixes give the
    plain dict's net, which computes the reference module's output."""
    ref = _randomize(RefClair3P(add_indel_length=False), 1).eval()
    sd = ref.state_dict()
    plain = _port(_save(tmp_path, sd, "plain.pt"), "pileup").state_dict()
    if wrap in ("ddp", "both"):
        sd = {f"module.{k}": v for k, v in sd.items()}
    if wrap in ("state_dict", "both"):
        sd = {"state_dict": sd, "epoch": 7}
    port = _port(_save(tmp_path, sd, "wrapped.pt"), "pileup")
    for name, t in port.state_dict().items():
        assert torch.equal(t, plain[name]), name
    x = np.random.default_rng(1).integers(-30, 30, size=(3, 33, 18)).astype(np.int32)
    with torch.no_grad():
        ref_out = ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_port_forward(port, x), ref_out, atol=PILEUP_TOL, rtol=0)


def test_strict_loading_rejects_unconsumed_keys(tmp_path):
    sd = _randomize(RefClair3P(add_indel_length=False), 3).state_dict()
    sd["mystery.weight"] = torch.zeros(3)
    path = _save(tmp_path, sd, "extra.pt")
    with pytest.raises(ValueError, match="unexpected tensor"):
        _port(path, "pileup")
    convert_checkpoint(path, "pileup", strict=False)  # non-strict tolerates it


def test_strict_loading_rejects_missing_keys(tmp_path):
    sd = _randomize(RefClair3P(add_indel_length=False), 4).state_dict()
    del sd["L5_2.bias"]
    with pytest.raises(ValueError, match="missing tensor 'L5_2.bias'"):
        _port(_save(tmp_path, sd, "missing.pt"), "pileup")


def test_convert_main_pt_to_npz_roundtrip(tmp_path):
    """``python -m clair3_tpu_torch.models.convert in.pt out.npz`` (kind from
    the file name) writes an .npz that loads to the same net as the .pt."""
    src = _save(tmp_path, _randomize(RefClair3P(add_indel_length=False), 3).state_dict(),
                "pileup.pt")
    dst = str(tmp_path / "pileup.npz")
    assert convert_main([src, dst]) == 0
    from_npz = from_jax_variables(load_variables(dst))
    from_pt = from_jax_variables(convert_checkpoint(src, "pileup"))
    assert from_npz.keys() == from_pt.keys()
    for name in from_pt:
        assert torch.equal(from_npz[name], from_pt[name]), name
    a, b = _port(dst, "pileup").state_dict(), _port(src, "pileup").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def zoo_checkpoints(tmp_path_factory):
    """Synthetic state dicts by the reference schema: the pileup net and the
    full-alignment net at 8 and 9 input channels."""
    d = tmp_path_factory.mktemp("zoo_pt")
    paths = {"pileup": _save(d, synth_state_dict(pileup_state_dict_schema()), "pileup.pt")}
    for ch in (8, 9):
        sd = synth_state_dict(full_alignment_state_dict_schema(input_channels=ch), seed=1)
        paths[ch] = _save(d, sd, f"full_alignment_{ch}.pt")
    return paths


@pytest.mark.parametrize("info", _MODELS, ids=lambda m: m.name)
def test_zoo_entry_checkpoints_load_strict(zoo_checkpoints, info):
    """Twin of tests/test_zoo_schema.py::test_zoo_entry_checkpoints_convert:
    every registry entry's checkpoints load ``strict=True`` into the port's
    nets (2 pileup heads; 9 FA channels for dwell entries)."""
    pileup = _port(zoo_checkpoints["pileup"], "pileup")
    assert pileup.n_heads == 2 and pileup.LSTM1.wi.shape[1] == 18
    ch = 9 if info.dwell else 8
    fa = _port(zoo_checkpoints[ch], "full_alignment")
    assert fa.input_channels == ch
