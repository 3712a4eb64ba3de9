"""The port's ``call`` names its host steps on the profiler's clock.

A ~20 kb hifi region is called through the port's ``VariantCaller`` with
its ``InferenceEngine`` pair on the CPU (the committed trained nets, f32),
phasing and full alignment on, once plainly and once under
``torch.profiler`` with every thread recorded.  The trace must hold every
span of the call pipeline, the phaser and the engines, each on the thread
that does the work; the phaser's spans sit inside the phase stage; each
VCF's index is built in the native library, inside its ``vcf.index``; each
stage's ``stage_times`` entry is its ``call.<stage>`` spans' duration, and
each step span's seconds sit beside them under its name; and the profiler
changes no byte of the VCFs.
"""

import os
import sys
import threading
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile, record_function

from clair3_tpu_torch import spans as host_spans
from clair3_tpu_torch.cli import _load_engine
from clair3_tpu_torch.config import CallConfig
from clair3_tpu_torch.phase import ReadBackedPhaser
from clair3_tpu_torch.pipeline.call import VariantCaller
from clair3_tpu_torch.testing import simulate, trained_fixture_path

EVAL_BP = 20_000
NETS = ("PileupNet", "FullAlignmentNet")
STAGES = ("plan", "pileup", "sort", "write_vcf", "route", "phase", "full_alignment",
          "merge", "gvcf", "join")
SPANS = ({"call." + s for s in STAGES}
         | {f"{k}.{step}" for k in ("pileup", "fa")
            for step in ("extract", "extract_wait", "decode")}
         | {"vcf.write", "vcf.index", "vcf.index_native", "phase.select", "phase.reads",
            "phase.native_scan", "phase.mec", "phase.rescue"}
         | {f"{n}.{step}" for n in NETS
            for step in ("submit", "gather", "pack", "pin", "warmup")})
VCFS = ("pileup.vcf.gz", "full_alignment.vcf.gz", "merge_output.vcf.gz")


def _mark(name):
    with record_function(name):
        pass


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spans"))
    fasta, bam, _, _ = simulate(work, EVAL_BP, seed=91)
    cpu = torch.device("cpu")
    engines = {
        "pileup_engine": _load_engine(trained_fixture_path("pileup_hifi.npz"), "pileup",
                                      cpu, torch.float32),
        "fa_engine": _load_engine(trained_fixture_path("fa_hifi.npz"), "full_alignment",
                                  cpu, torch.float32)}

    def call(out):
        cfg = CallConfig(bam_fn=bam, ref_fn=fasta, output_dir=os.path.join(work, out),
                         platform="hifi", indel_min_af=0.12, threads=2, chunk_size=8_000,
                         var_pct_full=0.3, ref_pct_full=0.3)
        caller = VariantCaller(cfg, phaser=ReadBackedPhaser(bam, min_mq=20), **engines)
        caller.run()
        return caller

    call("plain")
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        # one marker on each engine's submitter thread, to know its id
        for net, engine in zip(NETS, engines.values()):
            engine._submitter.submit(_mark, "submitter." + net).result(timeout=60)
        caller = call("traced")
    events = defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            events[ev.name()].append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                                      ev.start_thread_id()))
    return work, caller, events


def _threads(events, name):
    return {t for _, _, t in events[name]}


def test_every_span_is_in_the_trace(traced):
    _, _, events = traced
    assert SPANS <= set(events), sorted(SPANS - set(events))


def test_spans_run_on_the_threads_that_do_the_work(traced):
    _, _, events = traced
    caller_thread = _threads(events, "call.pileup")
    assert len(caller_thread) == 1
    for net in NETS:
        submitter = _threads(events, "submitter." + net)
        assert len(submitter) == 1 and submitter != caller_thread
        for step in ("pack", "pin", "warmup"):
            assert _threads(events, f"{net}.{step}") == submitter, (net, step)
        for step in ("submit", "gather"):
            assert _threads(events, f"{net}.{step}") == caller_thread, (net, step)
    submitters = set().union(*(_threads(events, "submitter." + n) for n in NETS))
    for stage in ("pileup", "fa"):
        pool = _threads(events, f"{stage}.extract")
        assert pool and not pool & (caller_thread | submitters), stage
        assert _threads(events, f"{stage}.extract_wait") == caller_thread
        assert _threads(events, f"{stage}.decode") == caller_thread
    for name in ("vcf.write", "vcf.index", "vcf.index_native", "phase.select", "phase.reads",
                 "phase.native_scan", "phase.mec", "phase.rescue"):
        assert _threads(events, name) == caller_thread, name


def test_phase_spans_nest_inside_the_phase_stage(traced):
    _, _, events = traced
    stage = events["call.phase"]
    assert len(stage) == 1
    s0, e0, t0 = stage[0]
    for name in ("phase.select", "phase.reads", "phase.native_scan", "phase.mec",
                 "phase.rescue"):
        for s, e, t in events[name]:
            assert t == t0 and s0 <= s and e <= e0, name


def test_every_index_is_built_in_the_native_library(traced):
    """``vcf.index_native`` closes once inside each ``vcf.index``: one a VCF."""
    _, _, events = traced
    index, native = sorted(events["vcf.index"]), sorted(events["vcf.index_native"])
    assert len(index) == len(native) == len(VCFS)
    for (s0, e0, t0), (s, e, t) in zip(index, native):
        assert t == t0 and s0 <= s and e <= e0


def test_stage_times_are_the_stage_spans(traced):
    _, caller, events = traced
    spans = {n[len("call."):]: sum(e - s for s, e, _ in iv) / 1e9
             for n, iv in events.items() if n.startswith("call.")}
    stages = {k: v for k, v in caller.stage_times.items() if "." not in k}
    assert set(spans) == set(stages) == set(STAGES)
    for stage, seconds in stages.items():
        assert abs(spans[stage] - seconds) < 1e-3, (stage, spans[stage], seconds)


def test_stage_times_hold_the_step_spans(traced):
    _, caller, events = traced
    steps = {k: v for k, v in caller.stage_times.items() if "." in k}
    assert set(steps) == {n for n in SPANS if not n.startswith("call.")}
    for name, seconds in steps.items():
        iv = events[name]
        traced_s = sum(e - s for s, e, _ in iv) / 1e9
        # each perf_counter interval lies inside its profiler range; between
        # the two ends the thread may wait a switch interval for the GIL
        slack = 1e-3 + len(iv) * sys.getswitchinterval()
        assert seconds <= traced_s + 1e-6 and traced_s - seconds < slack, (
            name, traced_s, seconds)


def test_the_profiler_changes_no_vcf(traced):
    work, _, _ = traced
    for name in VCFS:
        with open(os.path.join(work, "plain", name), "rb") as a, \
                open(os.path.join(work, "traced", name), "rb") as b:
            assert a.read() == b.read(), name


def test_the_span_table_loses_no_update():
    """More threads than cores close spans of one name with a short switch
    interval: every call is counted, and ``seconds_since`` reads only what
    closed after ``before``."""
    name, per = "test.stress", 100
    n_threads = (os.cpu_count() or 1) + 2
    before = host_spans.totals()

    def work():
        for _ in range(per):
            with host_spans.span(name):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert host_spans.totals()[name][1] - before.get(name, (0.0, 0))[1] == n_threads * per
    since = host_spans.seconds_since(before)
    assert set(since) == {name} and since[name] > 0
