"""The port's CLI surface: device and dtype resolution, the flag that is not
ported yet (``train --data_parallel``: exit 1 with a message, before any
input is read), ``--dist_process_id`` alone and a wrong-sized process
group, model-zoo
names and the move-table probe (twins of ``tests/test_zoo.py``, with the
JAX CLI's exit codes), external phasers (twins of
``tests/test_external_phaser.py``, with its stub binaries), ``--profile_dir``,
a ``--remote_engines`` client on a host without a GPU, and the help text."""

import json
import os
import re
import shutil
import socket

import numpy as np
import pytest
import torch
from test_external_phaser import LONGPHASE_STUB, WHATSHAP_STUB, _write_stub

from clair3_tpu_torch.io.vcf import VcfReader
from clair3_tpu_torch.testing import SimVariant, random_reference, trained_fixture_path
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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["process_id_only", "world_size_mismatch"])
def test_dist_flags(tmp_path, capsys, tagless_case, case):
    """``--dist_process_id`` alone runs single-process, as in clair3_tpu
    (outputs in ``--output`` itself); a process group whose size is not
    ``--dist_num_processes`` raises instead of running every process as a
    single-process job over one output directory, and is left destroyed."""
    import torch.distributed as dist

    fa, bam = tagless_case
    models = ("--pileup_model", trained_fixture_path("pileup_hifi.npz"), "--pileup_only",
              "--platform", "hifi")
    if case == "process_id_only":
        assert _call(tmp_path, bam, fa, *models, "--dist_process_id", "0") == 0
        assert os.path.exists(tmp_path / "out" / "merge_output.vcf.gz")
        assert not os.path.exists(tmp_path / "out" / "proc0")
        assert "multi-process" not in capsys.readouterr().err
        return
    addr = f"127.0.0.1:{_free_port()}"
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="world_size=1"):
            _call(tmp_path, bam, fa, *models, "--dist_coordinator", addr,
                  "--dist_num_processes", "2", "--dist_process_id", "0")
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not os.path.exists(tmp_path / "out")


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


def test_remote_engines_client_needs_no_device(tmp_path, capsys, tagless_case):
    """A --remote_engines client loads no net: with the default --device
    cuda and no GPU it does not raise; an unreachable server exits 1 with
    the connection error, before any extraction."""
    with socket.socket() as sock:  # a local port that nothing listens on
        sock.bind(("127.0.0.1", 0))
        url = f"http://127.0.0.1:{sock.getsockname()[1]}"
    fa, bam = tagless_case
    rc = main(["call", "--bam_fn", bam, "--ref_fn", fa, "--output", str(tmp_path / "out"),
               "--platform", "hifi", "--remote_engines", url])
    assert rc == 1
    err = capsys.readouterr().err
    assert "[ERROR]" in err and "refused" in err and "not yet ported" not in err
    assert not os.path.exists(tmp_path / "out" / "pileup.vcf.gz")


def test_profile_dir_writes_a_trace(tmp_path, tagless_case):
    """--profile_dir on the CPU: a Chrome trace that parses as JSON and
    names both nets' forwards and the pileup net's recurrence ops, which
    run on the engine's own submitter thread."""
    fa, bam = tagless_case
    trace_dir = tmp_path / "trace"
    assert _call(tmp_path, bam, fa, "--platform", "hifi", "--threads", "1",
                 "--pileup_model", trained_fixture_path("pileup_hifi.npz"),
                 "--full_alignment_model", trained_fixture_path("fa_hifi.npz"),
                 "--profile_dir", str(trace_dir)) == 0
    with open(trace_dir / "call.pt.trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"PileupNet.forward", "FullAlignmentNet.forward", "aten::tanh",
            "aten::sigmoid"} <= names
    forwards = {e["tid"] for e in events if e.get("name") == "PileupNet.forward"}
    assert forwards and forwards == {e["tid"] for e in events if e.get("name") == "aten::tanh"}


@pytest.fixture(scope="module")
def het_case(tmp_path_factory):
    """The case of tests/test_external_phaser.py: six het SNPs on 4 kb."""
    from clair3_tpu_torch.testing import write_test_case

    d = tmp_path_factory.mktemp("extphase")
    ref = random_reference(4000, seed=77)
    variants = [SimVariant(p, ref[p], "A" if ref[p] != "A" else "T", (0, 1))
                for p in (500, 900, 1300, 1700, 2100, 2500)]
    fasta, bam, _, _ = write_test_case(str(d), ref_length=4000, variants=variants,
                                       coverage=24, read_length=900, seed=77, error_rate=0.01)
    return fasta, bam, variants


@pytest.mark.parametrize("tool,stub", [("whatshap", WHATSHAP_STUB),
                                       ("longphase", LONGPHASE_STUB)])
def test_cascade_with_external_phaser(tmp_path, het_case, tool, stub):
    """Twin of tests/test_external_phaser.py::test_cli_cascade_with_external_whatshap,
    and the same with longphase: the stub binary runs per contig and the
    cascade completes with every het SNP called het."""
    fasta, bam, variants = het_case
    binary = _write_stub(str(tmp_path / tool), stub)
    out_dir = tmp_path / "out"
    rc = main(["call", "--bam_fn", bam, "--ref_fn", fasta, "--output_dir", str(out_dir),
               "--platform", "ont", "--use_oracle_engines", "--device", "cpu",
               "--var_pct_full", "1.0", "--ref_pct_full", "1.0", "--var_pct_phasing", "0.1",
               f"--use_{tool}_for_intermediate_phasing", f"--{tool}", binary])
    assert rc == 0
    recs = {r.pos: r for r in VcfReader(str(out_dir / "merge_output.vcf.gz"))}
    for v in variants:
        assert recs[v.pos + 1].genotype in ((0, 1), (1, 0))
    # the stub really ran: the phaser's intermediates are in the output tree
    phased = "phased_chr1.vcf.gz" if tool == "whatshap" else "phased_chr1.vcf"
    assert os.path.exists(out_dir / "phase_vcf" / "chr1.vcf")
    assert os.path.exists(out_dir / "phase_vcf" / phased)


@pytest.fixture(scope="module")
def verify_case(tmp_path_factory):
    """The 3 kb case of the verify recipe, with its truth as a VCF."""
    from clair3_tpu_torch.io.vcf import VcfRecord, VcfWriter, get_header
    from clair3_tpu_torch.testing import write_test_case

    d = tmp_path_factory.mktemp("verify")
    ref = random_reference(3000, seed=42)
    variants = [
        SimVariant(600, ref[600], "C" if ref[600] != "C" else "G", (1, 1)),
        SimVariant(1200, ref[1200], "T" if ref[1200] != "T" else "A", (0, 1)),
        SimVariant(1800, ref[1800], ref[1800] + "ACG", (0, 1)),
        SimVariant(2400, ref[2400:2404], ref[2400], (1, 1)),
    ]
    fasta, bam, _, _ = write_test_case(str(d), ref_length=3000, variants=variants, coverage=25,
                                       read_length=700, seed=42, error_rate=0.02)
    truth = str(d / "truth.vcf")
    with VcfWriter(truth, get_header(contigs=[("chr1", 3000)])) as w:
        for v in variants:
            w.write(VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                              "1/1" if v.genotype == (1, 1) else "0/1"))
    return fasta, bam, truth


def _read_bin_datasets(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f.keys()}


@pytest.mark.parametrize("pileup", [True, False], ids=["pileup", "fa"])
@pytest.mark.parametrize("unify", [False, True], ids=["", "unify_repr"])
def test_tensor2bin_matches_the_jax_cli(tmp_path, verify_case, pileup, unify):
    """`tensor2bin` of the port and of the JAX package write the same four
    datasets (tensors, labels, positions, alt info)."""
    from clair3_tpu.cli import main as jax_main

    fasta, bam, truth = verify_case
    args = ["tensor2bin", "--bam_fn", bam, "--ref_fn", fasta, "--truth_vcf_fn", truth,
            "--platform", "hifi", "--indel_min_af", "0.12"]
    args += ["--pileup"] if pileup else []
    args += ["--unify_repr"] if unify else []
    assert jax_main(args + ["--bin_fn", str(tmp_path / "jax.bin")]) == 0
    assert main(args + ["--bin_fn", str(tmp_path / "port.bin")]) == 0
    want = _read_bin_datasets(tmp_path / "jax.bin")
    got = _read_bin_datasets(tmp_path / "port.bin")
    assert sorted(got) == sorted(want) == ["alt_info", "label", "position", "position_matrix"]
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert want["label"].sum(axis=0)[:21].max() > 0 and len(want["position"]) > 4


def test_train_then_call_on_the_cpu(tmp_path, verify_case, capsys):
    """`train --device cpu` writes the JAX-format checkpoints, and `call`
    loads the trained nets and writes rows (reference calls included: one
    epoch of a handful of rows calls no variant)."""
    fasta, bam, truth = verify_case
    common = ["--bam_fn", bam, "--ref_fn", fasta, "--truth_vcf_fn", truth, "--platform", "hifi"]
    models = {}
    for kind, extra in (("pileup", ["--pileup"]), ("fa", [])):
        bin_fn = str(tmp_path / f"{kind}.bin")
        assert main(["tensor2bin", *common, "--bin_fn", bin_fn, *extra]) == 0
        out = tmp_path / f"{kind}_model"
        assert main(["train", "--bin_fn", bin_fn, "--output_dir", str(out), "--platform", "hifi",
                     "--max_epoch", "1", "--device", "cpu",
                     *(["--pileup"] if kind == "pileup" else ["--add_indel_length"])]) == 0
        assert sorted(os.listdir(out)) == ["best_val_loss.npz", "epoch_0_0.npz"]
        models[kind] = str(out / "best_val_loss.npz")
    assert "best_val_loss=" in capsys.readouterr().out
    assert _call(tmp_path, bam, fasta, "--platform", "hifi", "--threads", "1",
                 "--pileup_model", models["pileup"],
                 "--full_alignment_model", models["fa"], "--print_ref_calls") == 0
    rows = list(VcfReader(str(tmp_path / "out" / "merge_output.vcf.gz")))
    assert rows


def test_train_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--bin_fn", str(tmp_path / "missing.bin"), "--output_dir",
              str(tmp_path / "out")])
