"""The port's remote inference serving: twins of tests/test_serve.py with
the port's engines, built by the port's loader on the CPU at f32, behind
the port's EngineServer; `serve` and `call --remote_engines` through the
port's CLI; and the wire format shared with the JAX package (a port client
against a JAX server, and the reverse)."""

import gzip
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from chip_smoke import write_reference_checkpoints

from clair3_tpu_torch.cli import _load_engine
from clair3_tpu_torch.cli import main as port_main
from clair3_tpu_torch.serve import EngineServer, RemoteEngine, build_server
from clair3_tpu_torch.testing import trained_fixture_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _engine(name, kind):
    """A port engine as `call` loads it, on the CPU at f32, with one small
    bucket so the tests' batches stay cheap."""
    engine = _load_engine(trained_fixture_path(name), kind, CPU, torch.float32)
    engine.buckets = (32,)
    return engine


@pytest.fixture(scope="module")
def real_engines():
    return _engine("pileup_hifi.npz", "pileup"), _engine("fa_hifi.npz", "full_alignment")


def _concurrently(clients, batches):
    """Each client predicts its batch, all released together."""
    got = [None] * len(batches)
    errs = []
    start = threading.Barrier(len(batches))

    def worker(i):
        try:
            start.wait(timeout=30)
            got[i] = clients[i].predict(batches[i])
        except Exception as exc:  # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    return got


def test_remote_predict_identical_to_local(real_engines):
    pe, fe = real_engines
    server = EngineServer({"pileup": pe, "full_alignment": fe})
    server.serve_background()
    try:
        rp = RemoteEngine(server.address, "pileup")
        rf = RemoteEngine(server.address, "full_alignment")
        assert rf.fa_input_channels == 8  # propagated through /info
        rng = np.random.default_rng(0)
        x = rng.integers(-30, 30, (17, 33, 18)).astype(np.int32)
        np.testing.assert_array_equal(rp.predict(x), pe.predict(x))
        xf = rng.integers(-100, 100, (9, 55, 33, 8)).astype(np.int8)
        np.testing.assert_array_equal(rf.predict(xf), fe.predict(xf))
        # async protocol: handles -> gather, same rows
        np.testing.assert_array_equal(rf.gather(rf.predict_async(xf)), fe.predict(xf))
    finally:
        server.shutdown()


def test_remote_engine_error_surfacing(real_engines):
    pe, _ = real_engines
    server = EngineServer({"pileup": pe}, platform="ont")
    server.serve_background()
    try:
        with pytest.raises(RuntimeError, match="does not serve"):
            RemoteEngine(server.address, "full_alignment")
        with pytest.raises(RuntimeError, match="platform"):
            RemoteEngine(server.address, "pileup", platform="hifi")
        RemoteEngine(server.address, "pileup", platform="ont")  # ok
        # a server-side failure surfaces with the remote detail
        client = RemoteEngine(server.address, "pileup")
        with pytest.raises(RuntimeError, match="remote engine pileup failed"):
            client.predict(np.zeros((2, 33, 7), np.int32))  # 7 channels: the net refuses
        client.kind = "nope"
        with pytest.raises(Exception):
            client.predict(np.zeros((1, 33, 18), np.int32))
    finally:
        server.shutdown()


def test_concurrent_clients_consistent(real_engines):
    pe, _ = real_engines
    server = EngineServer({"pileup": pe})
    server.serve_background()
    rng = np.random.default_rng(1)
    batches = [rng.integers(-30, 30, (5 + i, 33, 18)).astype(np.int32) for i in range(6)]
    want = [pe.predict(b) for b in batches]
    try:
        clients = [RemoteEngine(server.address, "pileup") for _ in batches]
        for g, w in zip(_concurrently(clients, batches), want):
            np.testing.assert_array_equal(g, w)
    finally:
        server.shutdown()


def test_many_concurrent_clients_coalesce_byte_identically(real_engines):
    """12 concurrent clients are merged into fewer forwards, and each gets
    the rows of a solo forward byte for byte."""
    pe, _ = real_engines
    server = EngineServer({"pileup": pe}, coalesce_window_s=0.2)
    server.serve_background()
    rng = np.random.default_rng(7)
    batches = [rng.integers(-30, 30, (2 + (i % 5), 33, 18)).astype(np.int32)
               for i in range(12)]
    want = [pe.predict(b) for b in batches]
    try:
        clients = [RemoteEngine(server.address, "pileup") for _ in batches]
        for g, w in zip(_concurrently(clients, batches), want):
            np.testing.assert_array_equal(g, w)
        stats = server.stats()["pileup"]
        assert stats["requests"] == len(batches)
        assert stats["rows"] == sum(b.shape[0] for b in batches)
        assert stats["batches"] < len(batches), stats
    finally:
        server.shutdown()


def test_coalescer_groups_mismatched_shapes(real_engines):
    """Concurrent full-alignment requests at two depths are not
    concatenated; each gets its own rows."""
    _, fe = real_engines
    server = EngineServer({"full_alignment": fe}, coalesce_window_s=0.2)
    server.serve_background()
    rng = np.random.default_rng(8)
    batches = [rng.integers(-100, 100, s).astype(np.int8)
               for s in ((3, 89, 33, 8), (4, 55, 33, 8), (2, 89, 33, 8))]
    want = [fe.predict(b) for b in batches]
    try:
        clients = [RemoteEngine(server.address, "full_alignment") for _ in batches]
        for g, w in zip(_concurrently(clients, batches), want):
            np.testing.assert_array_equal(g, w)
    finally:
        server.shutdown()


def test_coalescer_oversized_single_request(real_engines):
    """A request larger than the coalescer's max_rows forms a group of its
    own, and the queue behind it drains."""
    pe, _ = real_engines
    server = EngineServer({"pileup": pe}, coalesce_window_s=0.01)
    server._coalescers["pileup"].max_rows = 8
    server.serve_background()
    rng = np.random.default_rng(9)
    big = rng.integers(-30, 30, (40, 33, 18)).astype(np.int32)  # two engine chunks
    small = rng.integers(-30, 30, (3, 33, 18)).astype(np.int32)
    try:
        client = RemoteEngine(server.address, "pileup")
        np.testing.assert_array_equal(client.predict(big), pe.predict(big))
        np.testing.assert_array_equal(client.predict(small), pe.predict(small))
    finally:
        server.shutdown()


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_build_server_from_model_dir(tmp_path, fmt):
    """`serve --model_path DIR` loads the engines `call` builds, from .npz
    or from the reference's .pt files, on the device it is given."""
    if fmt == "npz":
        os.symlink(trained_fixture_path("pileup_hifi.npz"), tmp_path / "pileup.npz")
        os.symlink(trained_fixture_path("fa_hifi.npz"), tmp_path / "full_alignment.npz")
    else:
        write_reference_checkpoints(trained_fixture_path("pileup_hifi.npz"),
                                    trained_fixture_path("fa_hifi.npz"), str(tmp_path))
    server = build_server(str(tmp_path), platform="hifi", compute_dtype="fp32", device="cpu")
    assert set(server.engines) == {"pileup", "full_alignment"}
    pileup = server.engines["pileup"]
    assert pileup.device == CPU and pileup.model.compute_dtype == torch.float32
    server.serve_background()
    try:
        x = np.random.default_rng(2).integers(-20, 20, (4, 33, 18)).astype(np.int32)
        np.testing.assert_array_equal(RemoteEngine(server.address, "pileup").predict(x),
                                      pileup.predict(x))
        assert RemoteEngine(server.address, "full_alignment").fa_input_channels == 8
    finally:
        server.shutdown()


def test_serve_on_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here")
    os.symlink(trained_fixture_path("pileup_hifi.npz"), tmp_path / "pileup.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["serve", "--model_path", str(tmp_path), "--host", "127.0.0.1",
                   "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(str(tmp_path))


def test_server_over_two_replicas_answers_as_one_device(monkeypatch):
    """A server whose engines span two CPU replicas (``build_server`` with
    ``local_devices`` made to give two, as it gives every card on a GPU
    host) answers with the rows of a one-device server: probabilities within
    1e-6 (the CPU's matmul blocking follows the batch size) and the same
    calls."""
    from clair3_tpu_torch import cli

    models = dict(pileup_model=trained_fixture_path("pileup_hifi.npz"),
                  fa_model=trained_fixture_path("fa_hifi.npz"))
    one = build_server(None, platform="hifi", compute_dtype="fp32", port=0, device="cpu",
                       **models)
    monkeypatch.setattr(cli, "local_devices", lambda device, n_devices=None: [CPU, CPU])
    two = build_server(None, platform="hifi", compute_dtype="fp32", port=0, device="cpu",
                       **models)
    assert {k: e.devices for k, e in two.engines.items()} == {
        "pileup": (CPU, CPU), "full_alignment": (CPU, CPU)}
    assert all(e.devices == (CPU,) for e in one.engines.values())
    rng = np.random.default_rng(4)
    batches = {"pileup": rng.integers(-30, 30, (17, 33, 18)).astype(np.int32),
               "full_alignment": rng.integers(-100, 100, (9, 55, 33, 8)).astype(np.int8)}
    for server in (one, two):
        server.serve_background()
    try:
        for kind, x in batches.items():
            want = RemoteEngine(one.address, kind, platform="hifi").predict(x)
            got = RemoteEngine(two.address, kind, platform="hifi").predict(x)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=kind)
            assert (got.argmax(axis=1) == want.argmax(axis=1)).all(), kind
            assert two.engines[kind].bytes_shipped == one.engines[kind].bytes_shipped
    finally:
        one.shutdown()
        two.shutdown()


def test_serve_subcommand_answers_a_client():
    """`python -m clair3_tpu_torch serve --device cpu` in its own process
    loads and warms the engines, then answers a port client."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "clair3_tpu_torch", "serve", "--device", "cpu",
         "--compute_dtype", "fp32", "--platform", "hifi", "--host", "127.0.0.1",
         "--port", str(port), "--pileup_model", trained_fixture_path("pileup_hifi.npz")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.time() + 120
        while "[INFO] serving" not in line and time.time() < deadline:
            line = proc.stderr.readline()
            assert line or proc.poll() is None, "the server exited"
        assert "['pileup']" in line, line
        client = RemoteEngine(f"http://127.0.0.1:{port}", "pileup", platform="hifi")
        x = np.random.default_rng(3).integers(-20, 20, (6, 33, 18)).astype(np.int32)
        local = _load_engine(trained_fixture_path("pileup_hifi.npz"), "pileup", CPU,
                             torch.float32)
        np.testing.assert_array_equal(client.predict(x), local.predict(x))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()


def _rows(path):
    with gzip.open(path, "rt") as f:
        return [line for line in f if not line.startswith("##")]


def test_cli_call_with_remote_engines(tmp_path):
    """The whole cascade through --remote_engines equals a local oracle run
    byte for byte: the server hosts the oracle engines, the calling process
    only extracts and decodes (and names no device)."""
    from clair3_tpu_torch.testing import (FullAlignmentOracleEngine, PileupOracleEngine,
                                          SimVariant, random_reference, write_test_case)

    L = 12000
    ref = random_reference(L, seed=21)
    variants = [
        SimVariant(2000, ref[2000], "C" if ref[2000] != "C" else "G", (1, 1)),
        SimVariant(4000, ref[4000], "T" if ref[4000] != "T" else "A", (0, 1)),
        SimVariant(6000, ref[6000], ref[6000] + "AG", (0, 1)),
        SimVariant(8000, ref[8000:8003], ref[8000], (1, 1)),
    ]
    write_test_case(str(tmp_path), ref_length=L, variants=variants,
                    coverage=25, read_length=1500, seed=21, error_rate=0.02)
    common = ["--bam_fn", str(tmp_path / "reads.bam"), "--ref_fn", str(tmp_path / "ref.fa"),
              "--no_phasing_for_fa", "--var_pct_full", "1.0", "--ref_pct_full", "1.0",
              "--threads", "1"]
    local_out = tmp_path / "local"
    assert port_main(["call", "--output", str(local_out), "--use_oracle_engines",
                      "--device", "cpu"] + common) == 0

    server = EngineServer({"pileup": PileupOracleEngine(),
                           "full_alignment": FullAlignmentOracleEngine()})
    server.serve_background()
    try:
        remote_out = tmp_path / "remote"
        assert port_main(["call", "--output", str(remote_out),
                          "--remote_engines", server.address] + common) == 0
    finally:
        server.shutdown()
    for name in ("merge_output.vcf.gz", "pileup.vcf.gz", "full_alignment.vcf.gz"):
        assert _rows(local_out / name) == _rows(remote_out / name), name
    body = [r for r in _rows(remote_out / "merge_output.vcf.gz") if not r.startswith("#")]
    assert len(body) == len(variants)


def _jax_pileup_engine():
    from clair3_tpu.models import PileupNet
    from clair3_tpu.pipeline.engine import InferenceEngine
    from clair3_tpu.testing import load_trained_fixture

    return InferenceEngine(PileupNet(add_indel_length=False),
                           load_trained_fixture("pileup_hifi.npz"), buckets=(32,),
                           transfer_dtype=np.int16, pileup_compact=True)


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_wire_format_shared_with_the_jax_package(server_side):
    """A port client gets a JAX server's engine bytes, and a JAX client a
    port server's: both packages speak the same .npy wire format."""
    from clair3_tpu import serve as jax_serve

    if server_side == "jax":
        engine, server_cls, client_cls = (_jax_pileup_engine(), jax_serve.EngineServer,
                                          RemoteEngine)
    else:
        engine, server_cls, client_cls = (_engine("pileup_hifi.npz", "pileup"), EngineServer,
                                          jax_serve.RemoteEngine)
    server = server_cls({"pileup": engine}, platform="hifi")
    server.serve_background()
    try:
        client = client_cls(server.address, "pileup", platform="hifi")
        x = np.random.default_rng(4).integers(-30, 30, (11, 33, 18)).astype(np.int32)
        got = client.predict(x)
        assert got.dtype == np.float32 and got.shape == (11, 24)
        np.testing.assert_array_equal(got, np.asarray(engine.predict(x)))
    finally:
        server.shutdown()
