"""The port's CLI surface: device and dtype resolution, and the flags that
are not ported yet (exit 1 with a message, before any input is read)."""

import pytest
import torch

from clair3_tpu_torch.testing import trained_fixture_path
from clair3_tpu_torch.cli import main, resolve_compute_dtype, resolve_device

CPU = torch.device("cpu")
CUDA = torch.device("cuda")


def test_compute_dtype_defaults_and_overrides(monkeypatch):
    monkeypatch.delenv("CLAIR3T_COMPUTE_DTYPE", raising=False)
    assert resolve_compute_dtype("auto", CPU) == torch.float32
    assert resolve_compute_dtype("auto", CUDA) == torch.bfloat16
    monkeypatch.setenv("CLAIR3T_COMPUTE_DTYPE", "bf16")
    assert resolve_compute_dtype("auto", CPU) == torch.bfloat16
    # an explicit flag wins over a leftover export
    assert resolve_compute_dtype("fp32", CUDA) == torch.float32


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == CPU


@pytest.mark.parametrize("extra,what", [
    (["--remote_engines", "http://localhost:1"], "--remote_engines"),
    (["--dist_num_processes", "2"], "--dist_*"),
    (["--profile_dir", "trace"], "--profile_dir"),
    (["--use_whatshap_for_intermediate_phasing"], "whatshap"),
    (["--model_path", "r941_prom_sup_g5014"], "model-zoo"),
    (["--pileup_model", "pileup.pt"], ".pt checkpoints"),
])
def test_unported_flags_exit_1(tmp_path, capsys, extra, what):
    argv = ["call", "--bam_fn", str(tmp_path / "missing.bam"),
            "--ref_fn", str(tmp_path / "missing.fa"), "--output", str(tmp_path / "out"),
            "--device", "cpu", *extra]
    if "--pileup_model" not in extra and "--model_path" not in extra:
        argv += ["--pileup_model", trained_fixture_path("pileup_hifi.npz")]
    assert main(argv) == 1
    err = capsys.readouterr().err
    assert "not yet ported" in err and what in err
