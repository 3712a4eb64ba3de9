"""The port's trainer against the JAX package's, f32 on the CPU.

One tiny pileup bin (170 rows of seeded counts and labels, chunk 25,
batch 50, 4 steps: three in epoch 0, one in epoch 1), both trainers started
from the same ``init_variables`` (the JAX net's ``model.init``) with
dropout off on both sides (in JAX by the interceptor of
``tests/test_torch_train.py``, active for the whole run so every step is
traced inside it; in the port by making ``Dropout`` the identity):

* ``history`` within rtol 1e-4;
* ``best_val_loss.npz`` has the JAX checkpoint's keys and agrees within 1e-4
  (on all but at most a 1e-5 share of a leaf's entries, where Adam's steps
  amplify the f32 noise of a gradient near 0: within 2 lr a step there);
* that checkpoint, loaded by the JAX package's ``load_variables`` into the
  flax net, gives the port net's probabilities within 1e-5, and the JAX
  checkpoint in the flax net gives them within 1e-5 too (the entries let
  past 1e-4 above leave the trained function where JAX's is).

With dropout on, two port runs with one seed give equal histories and two
seeds different ones.
"""

import flax.linen as fnn
import numpy as np
import pytest
import torch
from test_torch_train import no_dropout, one_hot_labels

from clair3_tpu.models import PileupNet as JaxPileupNet
from clair3_tpu.models.params_io import load_variables as jax_load_variables
from clair3_tpu.train.trainer import train_model as jax_train_model
from clair3_tpu_torch.config import TrainConfig
from clair3_tpu_torch.models import PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.models.layers import Dropout
from clair3_tpu_torch.models.params_io import load_variables
from clair3_tpu_torch.testing import random_counts
from clair3_tpu_torch.train.data import write_bin
from clair3_tpu_torch.train.trainer import train_model


def _cfg(seed=0):
    return TrainConfig(pileup=True, add_indel_length=False, batch_size=50,
                       chunk_size_pileup=25, max_epoch=3, seed=seed)


@pytest.fixture(scope="module")
def tiny_bin(tmp_path_factory):
    d = tmp_path_factory.mktemp("bin")
    n = 170
    x = random_counts(3, (n, 33, 18))
    y = one_hot_labels(np.random.RandomState(4), n)
    path = str(d / "tiny.bin")
    write_bin(path, x, y, [f"chr1:{1000 + i}:A" for i in range(n)], ["" for _ in range(n)])
    return path


@pytest.fixture(scope="module")
def init_variables():
    import jax

    x0 = np.zeros((2, 33, 18), np.int32)
    return jax.device_get(jax.jit(lambda k: JaxPileupNet().init(k, x0, train=False))(
        jax.random.PRNGKey(9)))


def test_train_model_matches_jax(tmp_path, tiny_bin, init_variables, monkeypatch):
    with fnn.intercept_methods(no_dropout):
        want = jax_train_model([tiny_bin], str(tmp_path / "jax"), _cfg(), max_steps=4,
                               init_variables=init_variables)
    with monkeypatch.context() as m:
        m.setattr(Dropout, "forward", lambda self, x, generator: x)
        got = train_model([tiny_bin], str(tmp_path / "port"), _cfg(), max_steps=4,
                          init_variables=init_variables, device="cpu")
    check_trained_like_jax(got, want)


def check_trained_like_jax(got, want, unit_past=False, p_tol=1e-5):
    """The port trainer's result ``got`` against the JAX trainer's ``want``
    (both ``{'history', 'epochs', 'best_val_loss', 'model_path'}``), within
    the bounds of the module's docstring; with ``unit_past``, a leaf may
    have one unit's fan-in (its first dimension) of entries past 1e-4, and
    ``p_tol`` bounds the two trained nets' probabilities."""
    print(f"[trainer] history jax {want['history']}\n[trainer] history port {got['history']}")
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(g[2:], w[2:], rtol=1e-4)
    assert got["epochs"] == want["epochs"]
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=1e-4)

    with np.load(got["model_path"]) as gz, np.load(want["model_path"]) as wz:
        assert sorted(gz.files) == sorted(wz.files)
        diffs = {k: np.abs(gz[k] - wz[k]) for k in wz.files}
    over = {k: int((d > 1e-4).sum()) for k, d in diffs.items()}
    print(f"[trainer] best_val_loss.npz max |d| {max(d.max() for d in diffs.values()):.3g}; "
          f"entries over 1e-4: {sum(over.values())} of {sum(d.size for d in diffs.values())}")
    for k, d in diffs.items():
        # within 1e-4 but for at most a 1e-5 share of a leaf: Adam's steps
        # (lr * m / (sqrt(v) + 1e-8)) turn the f32 noise of a gradient near 0
        # into up to lr a step, so such an entry may part by up to 2 lr a step
        assert over[k] <= max(int(1e-5 * d.size), d.shape[0] if unit_past else 0), (k, over[k])
        assert d.max() <= 4 * 2 * 1e-3, k

    x = random_counts(8, (16, 33, 18))
    flax_p = np.asarray(JaxPileupNet().apply(jax_load_variables(got["model_path"]), x))
    net = PileupNet()
    net.load_state_dict(from_jax_variables(load_variables(got["model_path"])), strict=True)
    with torch.inference_mode():
        port_p = net.eval()(torch.from_numpy(x)).numpy()
    err = np.abs(flax_p - port_p).max()
    jax_p = np.asarray(JaxPileupNet().apply(jax_load_variables(want["model_path"]), x))
    trained_err = np.abs(jax_p - port_p).max()
    print(f"[trainer] port checkpoint in the flax net: max |dp| {err:.3g}; the two trained "
          f"nets: max |dp| {trained_err:.3g}")
    assert err <= 1e-5
    # the entries let past 1e-4 above may not move the function: the two
    # trained nets within the forward-parity bound of an untrained pair
    assert trained_err <= p_tol


def test_dropout_runs_follow_the_seed(tmp_path, tiny_bin):
    runs = [train_model([tiny_bin], str(tmp_path / f"r{i}"), _cfg(seed), max_steps=3,
                        device="cpu")["history"]
            for i, seed in enumerate((0, 0, 1))]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_fit_defaults_to_cuda(tmp_path):
    """``fit`` runs on the card unless told otherwise, as ``train_model``
    does: without a device on a host with no GPU it raises
    ``resolve_device``'s error before it trains or writes anything."""
    from clair3_tpu_torch.testing import ArrayDataset
    from clair3_tpu_torch.train.trainer import fit

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default resolves")
    data = ArrayDataset([random_counts(3, (50, 33, 18))],
                        [one_hot_labels(np.random.RandomState(4), 50)], chunk_size=25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(data, str(tmp_path / "m"), _cfg(), max_steps=1)
    assert not (tmp_path / "m").exists()
