"""The port's InferenceEngine returns what its net returns, for every batch
size that exercises a different route: empty, one row, a ragged bucket,
and more rows than the largest bucket (split into chunks)."""

import numpy as np
import pytest
import torch

from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.pipeline.engine import InferenceEngine, rescale_high_coverage_pileup
from clair3_tpu_torch.testing import random_counts, random_variables


def _net(net, seed):
    net.load_state_dict(from_jax_variables(random_variables(net, seed)))
    return net.eval()


@pytest.fixture(scope="module")
def pileup_engine():
    # narrow widths keep 5000 CPU rows cheap; the kernel twin runs the net
    net = _net(PileupNet(add_indel_length=True, lstm1_units=8, lstm2_units=8,
                         l4_units=8, l5_units=8, use_kernel=True), seed=11)
    return InferenceEngine(net, torch.device("cpu"), transfer_dtype=np.int16)


@pytest.mark.parametrize("n", [0, 1, 300, 5000])
def test_pileup_engine_equals_model(pileup_engine, n):
    x = random_counts(n, (n, 33, 18))
    got = pileup_engine.predict(x)
    if n == 0:
        assert got.shape == (0, 90) and got.dtype == np.float32
        return
    with torch.inference_mode():
        want = pileup_engine.model(torch.from_numpy(x)).numpy()
    assert got.shape == (n, 90)
    # rows are computed independently; padding and chunking change no row
    # beyond the float rounding of batch-size-dependent CPU matmul blocking
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pileup_engine_async_and_accounting(pileup_engine):
    x = random_counts(3, (300, 33, 18))
    before = pileup_engine.bytes_shipped
    handles = pileup_engine.predict_async(x)
    assert len(handles) == 1 and handles[0][1] == 300
    out = pileup_engine.gather(handles)
    assert out.shape == (300, 90)
    # one int16 batch padded to the 1024 bucket
    assert pileup_engine.bytes_shipped - before == 1024 * 33 * 18 * 2
    assert pileup_engine.gather([]).shape == (0, 90)
    pileup_engine.warmup_async((33, 18), np.int32)
    pileup_engine.wait_warmup()


@pytest.mark.parametrize("n", [1, 300])
def test_fa_engine_equals_model(n):
    net = _net(FullAlignmentNet(input_channels=8), seed=12)
    engine = InferenceEngine(net, torch.device("cpu"), buckets=(64, 256),
                             transfer_dtype=np.int8)
    x = np.random.RandomState(n).randint(-100, 101, (n, 17, 33, 8)).astype(np.int8)
    got = engine.predict(x)
    with torch.inference_mode():
        want = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_rescale_matches_jax_engine():
    from clair3_tpu.pipeline.engine import rescale_high_coverage_pileup as jax_rescale

    x = random_counts(4, (3, 33, 18), 0, 400)
    infos = ["500-X", "100-Y", "217-Z"]
    np.testing.assert_array_equal(rescale_high_coverage_pileup(x.copy(), infos),
                                  jax_rescale(x.copy(), infos))


def _loaded_by(source, kind):
    """The net each production loader hands its caller, on the CPU."""
    from clair3_tpu_torch.cli import load_model
    from clair3_tpu_torch.serve import build_server
    from clair3_tpu_torch.testing import trained_fixture_path

    path = trained_fixture_path("pileup_hifi.npz" if kind == "pileup" else "fa_hifi.npz")
    cpu = torch.device("cpu")
    if source == "load_model":
        return load_model(path, kind, cpu, torch.float32)
    if source == "engine":
        net = FullAlignmentNet(input_channels=8) if kind == "fa" else PileupNet()
        return InferenceEngine(_net(net, seed=3).train(), cpu).model
    server = build_server(None, platform="hifi", port=0, device="cpu",
                          pileup_model=trained_fixture_path("pileup_hifi.npz"),
                          fa_model=trained_fixture_path("fa_hifi.npz"))
    server.serve_background()  # shutdown() stops a serving loop
    try:
        return server.engines["pileup" if kind == "pileup" else "full_alignment"].model
    finally:
        server.shutdown()


@pytest.mark.parametrize("kind", ["pileup", "fa"])
@pytest.mark.parametrize("source", ["load_model", "engine", "build_server"])
def test_loaded_nets_are_in_eval_mode(source, kind):
    """A net from load_model, InferenceEngine or serve.build_server is in
    eval mode (BatchNorm on its running statistics, no dropout), so two
    calls on one batch agree exactly."""
    net = _loaded_by(source, kind)
    assert not any(m.training for m in net.modules())
    shape = (4, 33, 18) if kind == "pileup" else (4, 55, 33, 8)
    x = torch.from_numpy(random_counts(6, shape, -50, 50).astype(
        np.int32 if kind == "pileup" else np.int8))
    with torch.inference_mode():
        assert torch.equal(net(x), net(x))
