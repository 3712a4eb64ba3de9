"""The port's CLI surface: device and dtype resolution, the flags that are
not ported yet (exit 1 with a message, before any input is read), model-zoo
names and the move-table probe (twins of ``tests/test_zoo.py``, with the
JAX CLI's exit codes), and the help text."""

import os
import re
import shutil

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


@pytest.fixture(scope="module")
def tagless_case(tmp_path_factory):
    """The simulator's BAM without mv tags, and its reference."""
    from clair3_tpu_torch.testing import write_test_case

    fa, bam, _, _ = write_test_case(str(tmp_path_factory.mktemp("tagless")),
                                    ref_length=1500, coverage=12, error_rate=0.02)
    return fa, bam


def _zoo_dir(tmp_path, name, platform):
    """A model directory named ``name`` holding the trained ``platform`` nets
    under the default prefixes."""
    d = tmp_path / name
    d.mkdir()
    shutil.copy(trained_fixture_path(f"pileup_{platform}.npz"), d / "pileup.npz")
    shutil.copy(trained_fixture_path(f"fa_{platform}.npz"), d / "full_alignment.npz")
    return str(d)


def _call(tmp_path, bam, ref, *extra):
    return main(["call", "--bam_fn", bam, "--ref_fn", ref,
                 "--output", str(tmp_path / "out"), "--device", "cpu", *extra])


class _Stop(Exception):
    pass


def test_zoo_platform_mismatch_exits_1(tmp_path, capsys, tagless_case):
    # twin of test_zoo.py::test_call_rejects_platform_mismatch
    fa, bam = tagless_case
    rc = _call(tmp_path, bam, fa, "--model_path", _zoo_dir(tmp_path, "hifi_revio", "hifi"),
               "--platform", "ont")
    assert rc == 1
    assert "--platform hifi" in capsys.readouterr().err


def test_zoo_name_sets_var_pct_phasing(tmp_path, monkeypatch, tagless_case):
    # the Guppy5 set phases at 0.8 (reference run_clair3.py:323-326), not at
    # the ont preset's 0.7
    import clair3_tpu_torch.config as config

    seen = {}

    class Spy(config.CallConfig):
        def __init__(self, **kw):
            seen.update(kw)
            raise _Stop

    monkeypatch.setattr(config, "CallConfig", Spy)
    fa, bam = tagless_case
    with pytest.raises(_Stop):
        _call(tmp_path, bam, fa, "--platform", "ont",
              "--model_path", _zoo_dir(tmp_path, "r941_prom_sup_g5014", "ont"))
    assert seen["var_pct_phasing"] == 0.8


def test_bare_zoo_name_is_looked_up(tmp_path, capsys, tagless_case):
    # a zoo name that is no directory passes the zoo check; then no model
    # file resolves, and the call exits 1 as the JAX CLI does
    fa, bam = tagless_case
    assert _call(tmp_path, bam, fa, "--model_path", "r941_prom_sup_g5014") == 1
    err = capsys.readouterr().err
    assert "no pileup model given" in err and "not yet ported" not in err


def test_with_mv_model_rejects_untagged_bam(tmp_path, capsys, tagless_case):
    # twin of test_zoo.py::test_call_with_mv_model_rejects_untagged_bam
    fa, bam = tagless_case
    model_dir = tmp_path / "self_trained_with_mv"
    model_dir.mkdir()
    assert _call(tmp_path, bam, fa, "--model_path", str(model_dir), "--platform", "ont") == 1
    err = capsys.readouterr().err
    assert "mv" in err and "move table" in err


def test_with_mv_model_rejects_non_ont_platform(tmp_path, capsys):
    # twin of test_zoo.py::test_call_with_mv_model_rejects_non_ont_platform
    model_dir = tmp_path / "net_with_mv"
    model_dir.mkdir()
    rc = _call(tmp_path, str(tmp_path / "none.bam"), str(tmp_path / "none.fa"),
               "--model_path", str(model_dir), "--platform", "hifi")
    assert rc == 1
    assert "ONT-only" in capsys.readouterr().err


def test_enable_dwell_time_rejected_on_non_ont(tmp_path, capsys):
    # twin of test_zoo.py::test_enable_dwell_time_rejected_on_non_ont
    rc = _call(tmp_path, str(tmp_path / "none.bam"), str(tmp_path / "none.fa"),
               "--enable_dwell_time", "--platform", "ilmn")
    assert rc == 1
    assert "not supported for non-ONT" in capsys.readouterr().err


def test_dwell_flag_probes_before_loading(tmp_path, capsys, tagless_case):
    # --enable_dwell_time on a tagless BAM exits 1 even with an 8-channel
    # model, whose loading would turn the dwell channel off again
    fa, bam = tagless_case
    rc = _call(tmp_path, bam, fa, "--platform", "ont", "--enable_dwell_time",
               "--pileup_model", trained_fixture_path("pileup_hifi.npz"),
               "--full_alignment_model", trained_fixture_path("fa_hifi.npz"))
    assert rc == 1
    assert "move table" in capsys.readouterr().err


def test_nine_channel_model_without_mv_name_calls(tmp_path, capsys, tagless_case):
    # a 9-channel model under a name without with_mv is not probed: the
    # call runs, with the dwell channel turned on from the loaded width
    fa, bam = tagless_case
    rc = _call(tmp_path, bam, fa, "--platform", "ont", "--threads", "1",
               "--model_path", _zoo_dir(tmp_path, "self_trained", "ont"))
    assert rc == 0
    err = capsys.readouterr().err
    assert "enabling the dwell channel" in err and "move table" not in err
    assert os.path.exists(tmp_path / "out" / "merge_output.vcf.gz")


def test_help_describes_the_port(capsys, monkeypatch):
    monkeypatch.setenv("COLUMNS", "1000")  # no wrapping inside a word
    with pytest.raises(SystemExit):
        main(["call", "--help"])
    text = capsys.readouterr().out
    assert "--compute_dtype" in text and "torch.profiler" in text
    # "TPU" as a word: OUTPUT_DIR holds the letters
    assert not re.search(r"\bTPU\b", text)
    for word in ("tpu-host", "jax"):
        assert word not in text, word
