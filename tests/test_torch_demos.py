"""The port's fixture trainer, quick demo and tensor viewer, on the CPU.

* ``python -m clair3_tpu_torch.train_fixture_checkpoints`` with the
  ``C3T_DEMO_*`` knobs scaled down (8 kb, one step a net) and the gates set
  to 0: it writes only into the directory it is given (the demo's work in
  ``demo/``, the fp16 ``.npz`` pair and the JAX script's manifest keys), its
  checkpoints load in the port and in ``clair3_tpu.models.params_io`` (the
  same values; the pileup nets' probabilities within atol 1e-5 of each other
  at f32), it freezes nothing
  when the gates fail, and it refuses any path under ``tests/fixtures/``;
* ``python -m clair3_tpu_torch.quick_demo`` at 8 kb: it trains (from an
  HDF5 bin, or from memory when h5py does not import), calls the held-out
  tail and scores it;
* ``clair3_tpu_torch.visualize_tensor`` prints what
  ``scripts/visualize_tensor.py`` prints;
* each entry point raises on ``--device cuda`` without a GPU.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import scripts.visualize_tensor as jax_viewer
from clair3_tpu_torch import (full_cascade_demo, quick_demo, train_fixture_checkpoints,
                              visualize_tensor, wgs_scale_demo)
from clair3_tpu_torch.cli import load_model
from clair3_tpu_torch.models.bridge import to_jax_variables
from clair3_tpu_torch.models.params_io import flatten_tree, load_variables
from clair3_tpu_torch.testing import random_counts, trained_fixture_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
TINY = {"C3T_DEMO_L": "8000", "C3T_DEMO_TRAIN_END": "6000", "C3T_DEMO_STEPS_P": "1",
        "C3T_DEMO_STEPS_F": "1", "C3T_DEMO_BATCH_P": "100", "C3T_DEMO_BATCH_F": "100"}


def _fixture_digest():
    h = hashlib.sha256()
    for root, _, files in sorted(os.walk(FIXTURES)):
        for name in sorted(files):
            with open(os.path.join(root, name), "rb") as fh:
                h.update(name.encode() + fh.read())
    return h.hexdigest()


def _tiny_env(monkeypatch, gates):
    for key, value in TINY.items():
        monkeypatch.setenv(key, value)
    for key in ("C3T_GATE_SNP", "C3T_GATE_INDEL"):
        if gates is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, gates)


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    """One scaled-down fixture training run with the gates at 0, from an
    empty working directory."""
    tmp = tmp_path_factory.mktemp("fixture")
    cwd = tmp / "cwd"
    cwd.mkdir()
    before = _fixture_digest()
    with pytest.MonkeyPatch.context() as mp:
        _tiny_env(mp, "0")
        mp.chdir(cwd)
        rc = train_fixture_checkpoints.main([str(tmp / "out"), "hifi", "--device", "cpu"])
    return dict(rc=rc, out=tmp / "out", cwd=cwd, fixtures_unchanged=_fixture_digest() == before)


def test_fixture_trainer_writes_only_into_its_directory(frozen):
    assert frozen["rc"] == 0
    assert sorted(os.listdir(frozen["out"])) == ["demo", "fa_hifi.npz", "manifest.json",
                                                 "pileup_hifi.npz"]
    assert os.listdir(frozen["cwd"]) == []
    assert frozen["fixtures_unchanged"]


def test_fixture_manifest_has_the_jax_scripts_keys(frozen):
    with open(frozen["out"] / "manifest.json") as fh:
        got = json.load(fh)
    with open(trained_fixture_path("manifest.json")) as fh:
        committed = json.load(fh)
    assert set(got) == set(committed)
    assert got["scale_bp"] == 8000 and got["gates"] == [0.0, 0.0]
    assert got["simulator"] == dict(committed["simulator"], with_mv_tags=False)
    assert (got["fa"], got["pileup"], got["matrix_depth"]) == (
        committed["fa"], committed["pileup"], committed["matrix_depth"])


@pytest.mark.parametrize("kind", ["pileup", "fa"])
def test_frozen_checkpoints_load_in_both_packages(frozen, kind):
    """Both loaders read the same values (the JAX one keeps the fp16 leaves,
    the port's upcasts them to f32), and the port's net holds them bit for
    bit; both nets run on them.  The pileup nets agree within 1e-5.  The
    FA net after one training step is not compared: its BatchNorm running
    statistics (still near their initial values) do not scale its
    activations, which grow through the layers until f32 summation order
    moves p by ~1e-4 (the trained FA nets agree within 1e-12,
    tests/test_torch_full_alignment.py)."""
    from clair3_tpu.models import FullAlignmentNet as JaxFullAlignmentNet
    from clair3_tpu.models import PileupNet as JaxPileupNet
    from clair3_tpu.models.params_io import load_variables as jax_load_variables

    path = str(frozen["out"] / f"{kind}_hifi.npz")
    with np.load(path) as z:
        assert {z[k].dtype for k in z.files if z[k].dtype.kind == "f"} == {np.dtype(np.float16)}
    tree = flatten_tree(jax_load_variables(path))  # fp16 leaves as stored
    ours = flatten_tree(load_variables(path))  # upcast to f32
    net = load_model(path, "pileup" if kind == "pileup" else "full_alignment",
                     torch.device("cpu"), torch.float32)
    held = flatten_tree(to_jax_variables(net.state_dict()))
    assert sorted(held) == sorted(tree) == sorted(ours)
    for k in tree:
        assert ours[k].dtype == held[k].dtype == np.float32, k
        assert np.array_equal(ours[k], tree[k].astype(np.float32)), k
        assert np.array_equal(held[k], ours[k]), k
    if kind == "pileup":
        x, jax_net = random_counts(5, (6, 33, 18)), JaxPileupNet(add_indel_length=False)
    else:
        x = np.random.RandomState(5).randint(-100, 101, (6, 55, 33, 8)).astype(np.int8)
        jax_net = JaxFullAlignmentNet(add_indel_length=True, input_channels=8)
    want = np.asarray(jax_net.apply(jax_load_variables(path), x, train=False))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all() and np.isfinite(want).all()
    if kind == "pileup":
        assert np.abs(got - want).max() <= 1e-5


def test_fixture_trainer_freezes_nothing_when_the_gates_fail(tmp_path, monkeypatch):
    _tiny_env(monkeypatch, None)  # the demo's own gates, which 8 kb and one step miss
    assert train_fixture_checkpoints.main([str(tmp_path / "out"), "--device", "cpu"]) == 1
    assert os.listdir(tmp_path / "out") == ["demo"]


@pytest.mark.parametrize("path", [FIXTURES, os.path.join(FIXTURES, "trained"),
                                  "elsewhere/tests/fixtures/new"])
def test_fixture_trainer_refuses_tests_fixtures(path, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    before = _fixture_digest()
    assert train_fixture_checkpoints.main([path, "--device", "cpu"]) == 2
    assert "refusing" in capsys.readouterr().err
    assert _fixture_digest() == before and os.listdir(tmp_path) == []
    assert not train_fixture_checkpoints.under_fixtures(str(tmp_path / "tests" / "fixtures2"))


@pytest.mark.parametrize("data", ["bin", "memory"])
def test_quick_demo_trains_calls_and_scores(tmp_path, monkeypatch, capsys, data):
    monkeypatch.setattr(quick_demo, "L", 8_000)
    monkeypatch.setattr(quick_demo, "TRAIN_END", 6_000)
    monkeypatch.setattr(quick_demo, "STEPS", 2)
    if data == "memory":
        monkeypatch.setattr(full_cascade_demo, "_have_h5py", lambda: False)
    elif not full_cascade_demo._have_h5py():
        pytest.skip("h5py does not import here")
    rc = quick_demo.main([str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc in (0, 1)  # its SNP gate (0.9) is for the default 260 kb and 400 steps
    assert "F1-score" in text and "[demo] best_val_loss=" in text, text
    assert os.path.exists(tmp_path / "model" / "best_val_loss.npz")
    assert os.path.exists(tmp_path / "out" / "merge_output.vcf.gz")
    assert os.path.exists(tmp_path / "train.bin") == (data == "bin")


@pytest.mark.parametrize("kind,index", [("pileup", 0), ("pileup", 1), ("fa", 0), ("fa", 1)])
def test_visualize_tensor_prints_the_jax_scripts_output(tmp_path, monkeypatch, capsys, kind,
                                                       index):
    rng = np.random.RandomState(11)
    if kind == "pileup":
        t = random_counts(11, (2, 33, 18))
    else:
        t = rng.randint(-100, 101, (2, 55, 33, 8)).astype(np.int8)
        t[:, 30:] = 0  # reads past the depth print nothing
    path = str(tmp_path / f"{kind}.npy")
    np.save(path, t)
    with open(path + ".info", "w") as fh:
        fh.write("chr1:101:A\tx\nchr1:202:C\ty\n")
    outs = []
    for module in (visualize_tensor, jax_viewer):
        monkeypatch.setattr(sys, "argv", ["viewer", path, str(index)])
        assert module.main() == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and len(outs[0].splitlines()) > 18


@pytest.mark.parametrize("entry", ["wgs_scale_demo", "quick_demo", "train_fixture_checkpoints"])
def test_entry_points_on_cuda_raise_without_a_gpu(tmp_path, monkeypatch, entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    _tiny_env(monkeypatch, None)
    argv = {"wgs_scale_demo": ["--output", str(tmp_path / "soak"), "--mbases", "0.01",
                               "--contigs", "1"],
            "quick_demo": [str(tmp_path / "demo")],
            "train_fixture_checkpoints": [str(tmp_path / "fixture")]}[entry]
    module = {"wgs_scale_demo": wgs_scale_demo, "quick_demo": quick_demo,
              "train_fixture_checkpoints": train_fixture_checkpoints}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
