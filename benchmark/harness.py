"""The benchmark of ``clair3_tpu_torch``: one run of one cell.

Set-up simulates the cell's input from the seed, builds the engines as the
port's ``call`` builds them (``cli._load_engine``: bf16 on the card, the
pileup kernels, the compact wire forms, the depth crop, every local card)
and warms them with one pass (``warm_up``): every kernel is built, every
route of both engines and every stage of the pass has run once.  The window
then repeats whole calls --
``pipeline.call.VariantCaller(cfg, pileup_engine, fa_engine, phaser).run()``
over the same input, with ``cfg`` from the CLI's own ``call`` arguments and
the cell's flags -- until ``--seconds`` have passed, and finishes the pass
in flight.  Once the window has closed, the last pass is held to the plain
reference (``reference/check.py``).

Everything that belongs to one cell, configuration or metric is a file
found by its name in ``BENCHMARK.json``: ``cells/<traffic>.json``, the
configuration's ``file``, and ``metrics/<metric>.py``, whose ``read(rec)``
returns the metric's value or ``None``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "clair3_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# the specification, found by name

def load_spec(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_spec(spec: Dict, name: str, root: str = ROOT):
    """``(workload, configuration entry, configuration, traffic)``."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "benchmark", "cells", wl["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    if traffic["contigs"] * traffic["contig_bp"] > config["genome_bp"]:
        raise SystemExit(f"cell {name} calls more than its configuration's genome_bp")
    return wl, entry, config, traffic


def cell_metrics(spec: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports: the end-to-end ones without trace,
    the per-layer ones with it."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def read_metric(name: str, rec: Dict, root: str = ROOT) -> Optional[float]:
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"bm_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(rec)


def weight_path(config: Dict, net: str, root: str = ROOT) -> str:
    w = config["weights"][net]
    path = os.path.join(root, w["file"])
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    if digest != w["sha256"]:
        raise SystemExit(f"{w['file']}: sha256 {digest} is not the configuration's {w['sha256']}")
    return path


# --------------------------------------------------------------------------
# what the window drives, seen through the harness's spans

class EngineProxy:
    """Stands where ``VariantCaller`` expects an engine: passes every call
    on, times the calling thread inside it, keeps the current pass's
    batches and probabilities for the check, and counts rows."""

    def __init__(self, inner):
        self.inner = inner
        self.fa_input_channels = getattr(inner, "fa_input_channels", None)
        self.wait_s = 0.0
        self.rows = 0
        self.inputs: List = []
        self.probs: Dict[int, object] = {}

    def start_pass(self) -> None:
        self.inputs, self.probs, self.rows = [], {}, 0

    @property
    def bytes_shipped(self) -> int:
        return getattr(self.inner, "bytes_shipped", 0)

    def warmup_async(self, *args):
        if hasattr(self.inner, "warmup_async"):
            return self.inner.warmup_async(*args)
        return None

    def wait_warmup(self) -> None:
        if hasattr(self.inner, "wait_warmup"):
            self.inner.wait_warmup()

    def predict_async(self, x):
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function("bm.engine"):
            if hasattr(self.inner, "predict_async"):
                handle = self.inner.predict_async(x)
            else:
                handle = self.inner.predict(x)
        self.wait_s += time.perf_counter() - t
        self.rows += len(x)
        self.inputs.append(x)
        return len(self.inputs) - 1, handle

    def gather(self, handle):
        from torch.profiler import record_function

        index, inner = handle
        t = time.perf_counter()
        with record_function("bm.engine"):
            probs = (self.inner.gather(inner) if hasattr(self.inner, "predict_async")
                     else inner)
        self.wait_s += time.perf_counter() - t
        self.probs[index] = probs
        return probs

    def pass_probs(self) -> List:
        return [self.probs[i] for i in range(len(self.inputs))]


class PhaserProxy:
    """Passes ``phase`` on and keeps what went in and came out."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def phase(self, ctg_name, het_snps):
        from torch.profiler import record_function

        with record_function("bm.phase"):
            phased = self.inner.phase(ctg_name, het_snps)
        rec = lambda rs: [(r.chrom, r.pos, r.ref, r.alt, r.sample) for r in rs]  # noqa: E731
        self.calls.append((ctg_name, rec(het_snps), rec(phased)))
        return phased


def _spanned(fn, label):
    from torch.profiler import record_function

    def inner(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return inner


@dataclasses.dataclass
class Session:
    config: Dict
    traffic: Dict
    flags: List[str]
    inp: object
    cfg: object
    pileup: EngineProxy
    fa: Optional[EngineProxy]
    phaser_factory: Optional[Callable]
    devices: List
    paths: Dict[str, str]
    work: str


def call_args(flags: List[str]):
    """The port CLI's own ``call`` arguments for ``flags``."""
    from clair3_tpu_torch import cli

    parser = argparse.ArgumentParser(prog="call")
    cli._add_call_args(parser)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(flags)


def build(name: str, seed: int, device: str, work: str, threads: Optional[int] = None,
          engines: Optional[Callable] = None, root: str = ROOT) -> Session:
    """Set-up: the input, the engines as ``call`` builds them (or, for the
    control and the tests, ``engines(paths, config, device, pileup_only)``'s),
    the configuration from the CLI's own ``call`` arguments."""
    from benchmark.gen.traffic import make_input

    _, _, config, traffic = cell_spec(load_spec(root), name, root)
    paths = {"pileup": weight_path(config, "pileup", root),
             "full_alignment": weight_path(config, "full_alignment", root)}
    flags = list(traffic["call_flags"])
    if threads is not None:
        i = flags.index("--threads")
        flags[i + 1] = str(threads)
    inp = make_input(traffic, seed, os.path.join(work, "input"))

    from clair3_tpu_torch import cli
    from clair3_tpu_torch.config import CallConfig
    from clair3_tpu_torch.device import resolve_device

    args = call_args(flags + [
        "--bam_fn", inp.bam, "--ref_fn", inp.fasta, "--output", os.path.join(work, "out"),
        "--pileup_model", paths["pileup"], "--full_alignment_model", paths["full_alignment"],
        "--device", device])
    dev = resolve_device(args.device)
    fields = {f.name for f in dataclasses.fields(CallConfig)}
    cfg = CallConfig(**{**{k: v for k, v in vars(args).items() if k in fields},
                        "dist_process_id": 0, "dist_process_count": 1})
    if engines is None:
        dt = cli.resolve_compute_dtype(args.compute_dtype, dev)
        pe = cli._load_engine(paths["pileup"], "pileup", dev, dt)
        fe = (None if args.pileup_only
              else cli._load_engine(paths["full_alignment"], "full_alignment", dev, dt))
    else:
        pe, fe = engines(paths, config, dev, args.pileup_only)
    if fe is not None:
        cli._reconcile_dwell(fe, cfg)
    phaser_factory = None
    if fe is not None and not cfg.no_phasing_for_fa:
        from clair3_tpu_torch.phase import ReadBackedPhaser

        phaser_factory = lambda: ReadBackedPhaser(cfg.bam_fn, min_mq=max(cfg.min_mq, 20))  # noqa: E731
    devices = list(getattr(pe, "devices", [dev]))
    return Session(config, traffic, flags, inp, cfg, EngineProxy(pe),
                   EngineProxy(fe) if fe is not None else None, phaser_factory,
                   devices, paths, work)


def run_pass(s: Session, out_dir: str, bed: Optional[str] = None) -> Dict:
    """One whole ``call`` over the cell's input (with ``bed``, over the
    candidates it covers)."""
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from torch.profiler import record_function

    t = time.perf_counter()
    for e in (s.pileup, s.fa):
        if e is not None:
            e.start_pass()
    phaser = PhaserProxy(s.phaser_factory()) if s.phaser_factory else None
    cfg = dataclasses.replace(s.cfg, output_dir=out_dir)
    if bed is not None:
        cfg = dataclasses.replace(cfg, bed_fn=bed)
    caller = VariantCaller(cfg, pileup_engine=s.pileup, fa_engine=s.fa, phaser=phaser)
    caller.run_pileup = _spanned(caller.run_pileup, "bm.pileup")
    caller.run_full_alignment = _spanned(caller.run_full_alignment, "bm.full_alignment")
    caller._write_vcf = _spanned(caller._write_vcf, "bm.write_vcf")
    with record_function("bm.pass"):
        caller.run()
    return {"seconds": time.perf_counter() - t,
            "candidates": s.pileup.rows,
            "fa_rows": s.fa.rows if s.fa is not None else 0,
            "stage_times": dict(caller.stage_times),
            "phase_calls": phaser.calls if phaser else []}


def warm_up(s: Session) -> Dict:
    """Set-up's warm-up: one pass over the cell's input, or, where the cell
    file gives ``warm_bp``, one whose candidates a BED keeps to the first
    ``warm_bp`` of the first contig.  ``VariantCaller.run`` warms every route
    of both engines, and the pass runs each stage once (extraction, decode,
    routing, phasing, full alignment, merge, VCF writing)."""
    bed = None
    if s.traffic.get("warm_bp"):
        bed = os.path.join(s.work, "warm.bed")
        with open(bed, "w") as fh:
            fh.write(f"{s.inp.contigs[0][0]}\t0\t{s.traffic['warm_bp']}\n")
    out_dir = os.path.join(s.work, "warm")
    try:
        return run_pass(s, out_dir, bed=bed)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def window(s: Session, seconds: float):
    """Whole passes until ``seconds`` have passed; the last one finishes.
    Returns (passes, failed, window seconds, last pass's output dir)."""
    from torch.profiler import record_function

    passes, failed = [], 0
    prev = None
    t0 = time.perf_counter()
    with record_function("bm.window"):
        while True:
            out_dir = os.path.join(s.work, f"pass{len(passes) + failed}")
            try:
                passes.append(run_pass(s, out_dir))
            except Exception:
                failed += 1
                log("[bench] pass failed:\n" + traceback.format_exc())
                break
            if prev is not None:
                shutil.rmtree(prev, ignore_errors=True)
            prev = out_dir
            if time.perf_counter() - t0 >= seconds:
                break
    return passes, failed, time.perf_counter() - t0, prev


# --------------------------------------------------------------------------

def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def limits_of(config: Dict) -> Dict[str, float]:
    from benchmark.reference.check import EXACT

    out = {k: 0.0 for k in EXACT}
    out.update(config["limits"])
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, threads: Optional[int] = None,
             engines: Optional[Callable] = None, workers: Optional[int] = None,
             root: str = ROOT):
    """One run; returns the result line's object (and ``rec`` beside it)."""
    import torch

    from benchmark import flops
    from benchmark.reference.check import PortPass, compare, read_rows, truth_f1
    from benchmark.reference.nets import (FullAlignmentRef, PileupRef, load_weights,
                                          no_tf32)

    spec = load_spec(root)
    work = tempfile.mkdtemp(prefix="clair3-bench-")
    try:
        s = build(name, seed, device, work, threads=threads, engines=engines, root=root)
        warm = warm_up(s)
        cuda = s.devices[0].type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        bytes0 = s.pileup.bytes_shipped + (s.fa.bytes_shipped if s.fa else 0)
        wait0 = s.pileup.wait_s + (s.fa.wait_s if s.fa else 0.0)
        setup_s = time.perf_counter() - t_start
        log(f"[bench] set-up {setup_s:.3f} s (warm pass {warm['seconds']:.3f} s, "
            f"{warm['candidates']} candidates, {warm['fa_rows']} full-alignment rows)")

        prof_result = None
        if trace:
            from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

            from benchmark import trace as tr

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts, experimental_config=_ExperimentalConfig(
                    profile_all_threads=True)) as prof:
                passes, failed, window_s, last_dir = window(s, seconds)
                if cuda:
                    torch.cuda.synchronize()
            prof_result = tr.reduce(prof, tr.window_bounds(prof))
            del prof
            log("[trace] " + json.dumps({k: prof_result[k] for k in (
                "label_device_s", "label_calls", "streams", "stream_kernel_s", "busy_s")}))
        else:
            passes, failed, window_s, last_dir = window(s, seconds)
        if cuda:
            torch.cuda.synchronize()
        wire = s.pileup.bytes_shipped + (s.fa.bytes_shipped if s.fa else 0) - bytes0
        wait = s.pileup.wait_s + (s.fa.wait_s if s.fa else 0.0) - wait0
        peak = (max(torch.cuda.max_memory_allocated(d) for d in s.devices) if cuda else 0)

        rec = {
            "cell": name, "seed": seed, "config": s.config, "traffic": s.traffic,
            "setup_s": setup_s, "window_s": window_s, "passes": passes,
            "candidates": sum(p["candidates"] for p in passes),
            "fa_rows": sum(p["fa_rows"] for p in passes),
            "bp_per_pass": s.inp.bp, "engine_wait_s": wait, "wire_bytes": wire,
            "flops": flops.nets(s.config["architecture"]), "trace": prof_result,
            "devices": len(s.devices),
        }
        from clair3_tpu_torch.ops import pileup_full

        launches = dict(pileup_full.kernel_launches)
        port = None
        if passes:
            port = PortPass(last_dir, s.pileup.inputs, s.pileup.pass_probs(),
                            s.fa.inputs if s.fa else [], s.fa.pass_probs() if s.fa else [],
                            passes[-1]["phase_calls"])
        inp, flags, s_paths = s.inp, s.flags, s.paths
        # the program's state goes before the reference runs
        del s
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        numbers: Dict[str, float] = {}
        diag: Dict = {}
        f1 = {}
        if port is not None:
            no_tf32()
            dev = "cuda" if cuda else "cpu"
            t = time.perf_counter()
            numbers = compare(
                port, flags, inp.bam, inp.fasta, inp.contigs,
                PileupRef(load_weights(s_paths["pileup"]), dev),
                FullAlignmentRef(load_weights(s_paths["full_alignment"]), dev),
                seed, workers or min(8, os.cpu_count() or 1), diag=diag)
            log(f"[bench] reference check {time.perf_counter() - t:.3f} s")
            log(f"[bench] gaps {json.dumps(diag)}")
            f1 = truth_f1(read_rows(os.path.join(port.out_dir, "merge_output.vcf.gz")),
                          inp.truth_vcf)
        limits = limits_of(rec["config"])
        checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
        correct = bool(passes) and failed == 0 and all(
            c["value"] <= c["limit"] for c in checks.values())

        metrics = {}
        for m in cell_metrics(spec, name, trace):
            v = read_metric(m["name"], rec, root)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {"correct": correct, "attempted": len(passes) + failed, "failed": failed,
                  "metrics": metrics}
        result["device"] = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": rec["devices"],
            "memory_peak_bytes": int(peak),
            "power_limit": power_limit() if cuda else None,
        }
        if prof_result is not None:
            result["device"]["busy_s"] = prof_result["busy_s"]
            result["device"]["window_s"] = prof_result["window_s"]
            result["breakdown"] = {"device_ops": prof_result["device_ops"],
                                   "idle_gaps": prof_result["idle_gaps"]}
        result["checks"] = checks
        log(f"[bench] accuracy vs simulated truth: {json.dumps(f1)}")
        log(f"[bench] pass seconds {json.dumps([round(p['seconds'], 4) for p in passes])}")
        if len(passes) > 2:
            rest = sorted(p["seconds"] for p in passes[1:])
            log(f"[bench] first window pass {passes[0]['seconds']:.4f} s, "
                f"median of the others {rest[len(rest) // 2]:.4f} s")
        log(f"[bench] passes {len(passes)}, window {window_s:.3f} s, "
            f"stage seconds per pass {json.dumps(_mean_stages(passes))}")
        log(f"[bench] pileup kernel launches {json.dumps(launches)}")
        return result, rec
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _mean_stages(passes: List[Dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in passes:
        for k, v in p["stage_times"].items():
            out[k] = out.get(k, 0.0) + v / len(passes)
    return {k: round(v, 4) for k, v in out.items()}


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        import torch

        import clair3_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"[bench] cannot import the program: {exc}")
        return 2
    wl = cell_spec(load_spec(), a.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        log(f"[bench] {a.workload} needs {wl['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result, rec = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        log(f"[bench] modules that must not load were loaded: {bad}")
        return 4
    for k, c in result["checks"].items():
        log(f"[check] {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
