#!/usr/bin/env python3
"""Chip check of the PyTorch port (clair3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc, g++ and the repository's sources; exits
non-zero without them.  Imports only the port: it loads neither jax, flax
or optax nor any module of the JAX package clair3_tpu (checked at the end),
whether or not they are installed.

Every kernel is timed beside its bound: the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its operations over
the dense peak of their type (989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32), the H100 SXM data sheet's figures.

Phase 1  builds the CUDA kernels from clair3_tpu_torch/csrc/ (nvcc, sm_90a)
         and, beside them, the port's native host library (g++,
         clair3_tpu_torch/native), and prints both times.
Phase 2  holds the pileup kernel against its plain PyTorch twin on the card,
         with the committed hifi weights (2 heads) and seeded random 4-head
         weights, on real pileup tensors (extracted from the phase-3 region)
         and on random counts, at B = 256, 4096, 1000 (not a multiple of
         the tile) and 2048 (the engine's buckets are 256/1024/2048/4096),
         timed at each B beside its bound, with its trunk mode (no PyTorch
         call computes the whole net or its trunk, so neither has a library
         time):
           f32 kernel vs f32 twin        max |dp| <= 2e-4
           bf16 kernel vs f32 twin       max |dp| <  1e-2
           trunk mode (n_heads = 0): f32 within 2e-4 (relative to the
           largest value), bf16 within ~2.5 ulps of the bf16 twin
         except trained weights on random counts at bf16, which is reported
         only: those counts are no pileup a caller makes, and there bf16
         itself moves the twin by ~2e-2 against f32.  The bf16 kernel is not
         bounded against the bf16 twin: both round independently, each
         ~8e-3 away from f32 on real tensors, so their difference reaches
         twice that (printed).  Times kernel and twin with CUDA events.
Phase 3  calls a simulated 120 kb hifi region (held-out seed 91, the region
         of tests/test_trained_fixture_cascade.py) through
         `clair3_tpu_torch call --device cuda` with the committed hifi nets,
         at bf16, at f32, and at bf16 with CLAIR3T_ENABLE_FA_CONV1=1; the
         engines ship the compact wire forms and the FA depth crop, as the
         JAX loader's do.  Checks: full-alignment rows > 10; SNP F1 >= 0.990
         and INDEL F1 >= 0.992 at bf16 (both bf16 runs); the pileup kernel
         launched and the plain pileup path never ran on the card; the FA
         conv1 kernel launched in the opt-in run only; bf16 rows agree with
         f32 rows (<= 1% of rows change call or source, QUAL delta < 1.5
         on pileup-decided rows; after tests/test_bf16_parity.py); the
         opt-in run's pileup.vcf.gz rows equal the default bf16 run's and
         <= 1% of its merged rows change call or source.  Prints each
         engine's bytes_shipped beside the dense int16/int8 count of the
         same batches, and checks it is below that count.
Phase 4  holds the FA conv1 kernel against its plain twin
         (ops/fa_conv1.py) on all four geometries: the committed hifi
         weights (depth 55 x 8 channels) on real FA tensors of the phase-3
         region, the committed ONT weights (89 x 9) on seeded random int8,
         and seeded random weights at 89 x 8 and 55 x 9; B = 1, 11, 256,
         1024, 2048, 4096.  f32 (direct kernel) within 1e-5; bf16 (tensor-core implicit
         GEMM) within 2 bf16 ulps of the bf16 twin's output (floor 1e-5).  Also FullAlignmentNet(use_kernel_conv1=True)
         against the standard f32 net, with seeded random weights on random
         int8 and with the hifi weights on the real tensors: f32 within
         2e-4; bf16 within 2e-2 with random weights, the condition of
         tests/test_pallas_fa.py (reported only for the trained net on real
         tensors, where the JAX package's own bf16 nets move p by up to
         ~5e-2).  Times kernel, twin and the library call (F.conv2d on the
         batch already cast to the compute dtype, + relu_, cuDNN; the
         faster of NCHW and channels_last) beside the bound at B = 1024,
         2048, 4096.
Phase 5  holds the BiLSTM recurrence kernel against its plain twin
         (ops/bilstm.py) at the pileup net's two layer shapes (C=18, H=128;
         C=256, H=160), B = 256, 1000, 4096, random xw and wh x 0.1: f32
         within 1e-5, bf16 within 1e-2; drives BiLSTM(use_kernel=True) (the
         kernel's module path) against the plain bilstm at f32 within 1e-5
         and against torch.nn.LSTM(bidirectional=True) (cuDNN) with the
         same weights within 1e-4; times kernel and twin beside the bound,
         and the module against nn.LSTM (the library call), at B = 1024,
         4096.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import copy
import gzip
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

BATCHES = (256, 4096, 1000, 2048)
F32_TOL = 2e-4
BF16_TOL = 1e-2
K3_BATCHES = (1, 11, 256, 1024)
K3_F32_TOL = 1e-5
K3_BF16_ULPS = 2
K2_BATCHES = (256, 1000, 4096)
K2_SHAPES = ((18, 128), (256, 160))
K2_F32_TOL = 1e-5
K2_BF16_TOL = 1e-2
TIME_BATCHES = (1024, 4096)
K3_TIME_BATCHES = (1024, 2048, 4096)
LSTM_LIB_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
EVAL_BP = 120_000
EVAL_SEED = 91
GATE_SNP_F1 = 0.990
GATE_INDEL_F1 = 0.992
DEVICE = "cuda"
CALL_ARGS = ["--platform", "hifi", "--indel_min_af", "0.12", "--threads", "4",
             "--var_pct_full", "0.3", "--ref_pct_full", "0.3"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def print_ptxas_report(log):
    """One line per kernel of the ptxas report: registers and spills."""
    name, spills = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?((?:pileup_full|bilstm|fa_conv1_tc|fa_conv1)"
                      r"_kernel)(?:I(13__nv_bfloat16|f|Li(\d+)E))?", line)
        if m:
            arg = {"13__nv_bfloat16": "bf16", "f": "f32"}.get(m.group(2), m.group(3))
            name = m.group(1) + (f"<{arg}>" if arg else "")
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            print(f"[phase1] {name}: {line.split(':', 1)[1].strip()}; {spills}")


def bound(flops, nbytes, dt):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dt)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_macs(trunk, heads):
    """Multiply-adds per candidate of the pileup net: every LSTM weight at
    each of the 33 steps, the dense and head matrices once."""
    wi1, wh1, _, wi2, wh2, _, wd, _ = trunk
    lstm = sum(w.numel() for w in (wi1, wh1, wi2, wh2))
    return 33 * lstm + wd.numel() + sum(w.numel() for w in heads if w.dim() == 2)


def phase2_kernel_vs_plain(torch, nets, real):
    import numpy as np

    from clair3_tpu_torch.ops import pileup_full as pf
    from clair3_tpu_torch.testing import random_counts

    f32, bf16 = torch.float32, torch.bfloat16
    timing = {}
    worst = {}
    for label, net in nets:
        trunk, heads = net.kernel_operands()
        for B in BATCHES:
            # real pileup tensors, repeated cyclically up to B rows
            inputs = {"random": torch.from_numpy(random_counts(B, (B, 33, 18))).to(DEVICE),
                      "real": torch.from_numpy(np.resize(real, (B, 33, 18))).to(DEVICE)}
            for dt in (f32, bf16):
                for kind, x in inputs.items():
                    got = pf.pileup_full(x, *trunk, heads, compute_dtype=dt)
                    torch.cuda.synchronize()
                    same = pf.pileup_full_reference(x, *trunk, heads, compute_dtype=dt)
                    ref32 = pf.pileup_full_reference(x, *trunk, heads, compute_dtype=f32)
                    check(got.shape == ref32.shape and bool(torch.isfinite(got).all()),
                          f"{label} B={B} {dt} {kind}: shape or non-finite output")
                    e_same = (got - same).abs().max().item()
                    e_f32 = (got - ref32).abs().max().item()
                    gap = (same - ref32).abs().max().item()
                    # trained weights on random counts: bf16 itself moves p
                    # by ~2e-2 there (gap), so that case is reported only
                    bounded = dt == f32 or label != "hifi" or kind == "real"
                    print(f"[phase2] {label:7s} B={B:5d} {str(dt):14s} {kind:6s} "
                          f"kernel vs twin same dtype {e_same:.3g}, vs f32 twin "
                          f"{e_f32:.3g}; twin vs f32 twin {gap:.3g}"
                          + ("" if bounded else " (reported only)"))
                    if not bounded:
                        continue
                    if dt == f32:
                        check(e_f32 <= F32_TOL, f"{label} B={B} f32 {kind}: {e_f32}")
                    else:
                        check(e_f32 < BF16_TOL, f"{label} B={B} bf16 {kind} vs f32: {e_f32}")
                    worst[str(dt)] = max(worst.get(str(dt), 0.0), e_f32)
                # trunk mode: the n_heads = 0 launch of the same kernel
                x = inputs["real" if label == "hifi" else "random"]
                got = pf.pileup_trunk(x, *trunk, compute_dtype=dt).float()
                torch.cuda.synchronize()
                want = pf.pileup_trunk_reference(x, *trunk, compute_dtype=dt)
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                print(f"[phase2] {label:7s} B={B:5d} {str(dt):14s} trunk  "
                      f"max |d| {err:.3g} (max |trunk| {scale:.3g})")
                if dt == f32:
                    check(err <= F32_TOL * max(1.0, scale), f"{label} B={B} trunk f32: {err}")
                else:
                    check(bool(torch.allclose(got, want, rtol=2e-2, atol=1e-2)),
                          f"{label} B={B} trunk bf16: {err}")
            if label == "hifi":
                x = inputs["real"]
                for dt in (bf16, f32):
                    y = pf.pileup_full(x, *trunk, heads, compute_dtype=dt)
                    k = cuda_ms(torch, lambda: pf.pileup_full(x, *trunk, heads, compute_dtype=dt), 10)
                    p = cuda_ms(torch, lambda: pf.pileup_full_reference(
                        x, *trunk, heads, compute_dtype=dt), 5)
                    b_ms, by = bound(2 * B * k1_macs(trunk, heads), nbytes(x, y, *trunk, *heads), dt)
                    timing[(B, str(dt))] = (k, p, b_ms, by)
                    print(f"[phase2] time B={B:5d} {str(dt):14s} kernel {k:.3f} ms, "
                          f"plain {p:.3f} ms, bound {b_ms:.4f} ms ({by}), kernel at "
                          f"{100 * b_ms / k:.1f}% of the bound, {B / k * 1e3:.0f} cand/s")
                    # trunk mode (n_heads = 0), the counterpart of pileup_trunk_pallas
                    y = pf.pileup_trunk(x, *trunk, compute_dtype=dt)
                    k = cuda_ms(torch, lambda: pf.pileup_trunk(x, *trunk, compute_dtype=dt), 10)
                    p = cuda_ms(torch, lambda: pf.pileup_trunk_reference(
                        x, *trunk, compute_dtype=dt), 5)
                    b_ms, by = bound(2 * B * k1_macs(trunk, ()), nbytes(x, y, *trunk), dt)
                    print(f"[phase2] time B={B:5d} {str(dt):14s} trunk mode {k:.3f} ms, "
                          f"plain {p:.3f} ms, bound {b_ms:.4f} ms ({by}), kernel at "
                          f"{100 * b_ms / k:.1f}% of the bound")
    return timing, worst


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


def rows_changed(out_a, out_b, name):
    """Rows of ``name`` whose call (REF/ALT/GT, or present on one side
    only) or source (INFO P/F: a candidate routed across the QUAL-quantile
    cutoff) differ, with the max QUAL delta by source among the others."""
    def keyed(rows):
        out = {}
        for r in rows:
            c = r.rstrip("\n").split("\t")
            out[c[1]] = (c[3], c[4], c[9].split(":")[0], c[7], float(c[5]))
        return out

    ka = keyed(_rows(os.path.join(out_a, name)))
    kb = keyed(_rows(os.path.join(out_b, name)))
    shared = set(ka) & set(kb)
    changed = (set(ka) ^ set(kb)) | {p for p in shared if ka[p][:4] != kb[p][:4]}
    dq = {src: max((abs(ka[p][4] - kb[p][4]) for p in shared
                    if ka[p][:4] == kb[p][:4] and ka[p][3] == src), default=0.0)
          for src in ("P", "F")}
    return changed, len(ka), dq


def bf16_vs_f32(out16, out32):
    """bf16 rows against f32 rows, after tests/test_bf16_parity.py: at most
    1% of rows change their call or their source; QUAL moves by < 1.5 on
    rows decided by the pileup net, whose kernel this checks.  Rows decided
    by the full-alignment net are only reported: that net's bf16
    convolutions move its probabilities by up to ~4e-2 against f32 in the
    JAX package too (measured on the CPU), which moves QUAL by a few
    units."""
    for name in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        changed, n, dq = rows_changed(out32, out16, name)
        print(f"[phase3] bf16 vs f32 {name}: {len(changed)}/{n} rows changed "
              f"call or source; max QUAL delta {dq['P']:.2f} on pileup rows, "
              f"{dq['F']:.2f} on full-alignment rows")
        check(n > 50, f"{name}: too few rows")
        check(len(changed) <= max(1, n // 100), f"{name}: {len(changed)} rows changed")
        check(dq["P"] < 1.5, f"{name}: QUAL delta {dq['P']} on pileup rows")


def conv1_vs_default(out_k3, out16):
    """The opt-in FA conv1 run against the default bf16 run: the pileup
    stage is the same, so pileup.vcf.gz rows are equal; at most 1% of the
    merged rows change call or source (the kernel folds /100 into float32
    weights where the standard route rounds x/100 to bf16, which moves the
    FA net's probabilities by up to ~5e-2 at bf16)."""
    check(_rows(os.path.join(out_k3, "pileup.vcf.gz")) == _rows(os.path.join(out16, "pileup.vcf.gz")),
          "FA conv1 run: pileup.vcf.gz rows differ from the default bf16 run")
    changed, n, dq = rows_changed(out16, out_k3, "merge_output.vcf.gz")
    print(f"[phase3] FA conv1 vs default bf16: pileup.vcf.gz rows equal; "
          f"merge_output.vcf.gz {len(changed)}/{n} rows changed call or source, "
          f"max QUAL delta {dq['P']:.2f} on pileup rows, {dq['F']:.2f} on "
          f"full-alignment rows")
    check(len(changed) <= max(1, n // 100), f"FA conv1 run: {len(changed)} merged rows changed")


class _LogTap(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


PHASE3_RUNS = (("bf16", "bf16", {}), ("fp32", "fp32", {}),
               ("bf16+fa_conv1", "bf16", {"CLAIR3T_ENABLE_FA_CONV1": "1"}))


def phase3_cascade(torch, work, fasta, bam, variants):
    from clair3_tpu_torch import cli as port_cli
    from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord
    from clair3_tpu_torch.models import pileup as pileup_model
    from clair3_tpu_torch.ops import fa_conv1 as k3
    from clair3_tpu_torch.ops import pileup_full as pf
    from clair3_tpu_torch.postprocess import variant_metrics
    from clair3_tpu_torch.testing import trained_fixture_path

    truth = [VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                       "1/1" if v.genotype == (1, 1) else "0/1") for v in variants]
    tap = _LogTap()
    logging.getLogger().addHandler(tap)
    logging.getLogger().setLevel(logging.INFO)
    engines = []
    load_engine = port_cli._load_engine

    def recording_load_engine(*args, **kwargs):
        engine = load_engine(*args, **kwargs)
        engines.append((args[1], engine))
        return engine

    port_cli._load_engine = recording_load_engine
    outs, result = {}, {}
    for label, flag, env in PHASE3_RUNS:
        out = os.path.join(work, f"out_{label}")
        argv = ["call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out,
                "--pileup_model", trained_fixture_path("pileup_hifi.npz"),
                "--full_alignment_model", trained_fixture_path("fa_hifi.npz"),
                "--device", DEVICE, "--compute_dtype", flag, *CALL_ARGS]
        del tap.lines[:]
        del engines[:]
        os.environ.update(env)
        pf.launches = 0
        k3.launches = 0
        pileup_model.plain_cuda_forwards = 0
        t0 = time.time()
        rc = port_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, conv1, plain = pf.launches, k3.launches, pileup_model.plain_cuda_forwards
        for key in env:
            del os.environ[key]
        check(rc == 0, f"call at {label} returned {rc}")
        outs[label] = out
        for line in tap.lines:
            if line.startswith(("[pileup]", "[select]", "[timing]")):
                print(f"[phase3] {label} {line}")
        for kind, engine in engines:
            ratio = engine.bytes_shipped / engine.dense_bytes
            print(f"[phase3] {label} {kind} engine: bytes_shipped {engine.bytes_shipped} "
                  f"against {engine.dense_bytes} dense ({ratio:.4f}x)")
            check(engine.bytes_shipped < engine.dense_bytes,
                  f"{label} {kind}: the compact forms shipped no fewer bytes than dense")
        fa_rows = sum(1 for _ in VcfReader(os.path.join(out, "full_alignment.vcf.gz")))
        query = [r for r in VcfReader(os.path.join(out, "merge_output.vcf.gz"))
                 if r.filter in ("PASS", ".")]
        m = variant_metrics(truth, query)
        print(f"[phase3] {label}: wall {wall:.2f} s, pileup kernel launches {launches}, "
              f"FA conv1 kernel launches {conv1}, plain pileup forwards on the card {plain}, "
              f"FA rows {fa_rows}, "
              f"SNP F1 {m['SNP'].f1:.6f} (P {m['SNP'].precision:.6f} R {m['SNP'].recall:.6f}), "
              f"INDEL F1 {m['INDEL'].f1:.6f} (P {m['INDEL'].precision:.6f} "
              f"R {m['INDEL'].recall:.6f})")
        check(launches > 0, f"{label}: the pileup kernel never launched")
        check(plain == 0, f"{label}: the plain pileup path ran on the card")
        check(fa_rows > 10, f"{label}: FA stage never engaged ({fa_rows} rows)")
        if env:
            check(conv1 > 0, f"{label}: the FA conv1 kernel never launched")
        else:
            check(conv1 == 0, f"{label}: the FA conv1 kernel launched without the opt-in")
        if flag == "bf16":
            check(m["SNP"].f1 >= GATE_SNP_F1, f"{label}: SNP F1 {m['SNP'].f1}")
            check(m["INDEL"].f1 >= GATE_INDEL_F1, f"{label}: INDEL F1 {m['INDEL'].f1}")
        result[label] = {"pileup_full": launches, "fa_conv1": conv1}
    port_cli._load_engine = load_engine
    logging.getLogger().removeHandler(tap)
    bf16_vs_f32(outs["bf16"], outs["fp32"])
    conv1_vs_default(outs["bf16+fa_conv1"], outs["bf16"])
    return result


def conv1_operands(torch, variables, rng, channels):
    """(kernel [3,3,C,64], bias, gamma, beta, mean, var) on the card: a
    checkpoint's conv1, or seeded random ones when ``variables`` is None."""
    import numpy as np

    if variables is None:
        ops = (rng.randn(3, 3, channels, 64) * 0.2, rng.randn(64) * 0.1, rng.rand(64) + 0.5,
               rng.randn(64) * 0.1, rng.randn(64) * 0.3, rng.rand(64) + 0.5)
    else:
        p, s = variables["params"]["conv1"], variables["batch_stats"]["conv1"]["bn"]
        ops = (p["conv"]["kernel"], p["conv"]["bias"], p["bn"]["scale"], p["bn"]["bias"],
               s["mean"], s["var"])
    return [torch.from_numpy(np.asarray(o, np.float32)).to(DEVICE) for o in ops]


def conv1_library_ms(torch, x, ops, dt):
    """The one PyTorch call that computes conv1 (cuDNN): ``F.conv2d`` on the
    batch already cast to ``dt`` (the cast is not timed), with the folded
    weights and bias, then ``relu_``; the faster of NCHW and channels_last.
    The port never calls it."""
    import torch.nn.functional as F

    from clair3_tpu_torch.ops import fa_conv1 as k3

    w_eff, b_eff = k3.fold_bn(*ops, 1e-3, 100.0, dt)
    w, b = w_eff.permute(3, 2, 0, 1).contiguous(), b_eff.to(dt)
    xl = x.to(dt).permute(0, 3, 1, 2)  # NCHW shape, channels_last memory
    times = {}
    for layout, xin, win in (("nchw", xl.contiguous(), w),
                             ("channels_last", xl, w.to(memory_format=torch.channels_last))):
        times[layout] = cuda_ms(torch, lambda: F.conv2d(xin, win, b, stride=2, padding=1).relu_(),
                                20)
    return min(times.values()), times


def phase4_fa_conv1(torch, real_fa):
    import numpy as np

    from clair3_tpu_torch.cli import load_model
    from clair3_tpu_torch.models import FullAlignmentNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.models.params_io import load_variables
    from clair3_tpu_torch.ops import fa_conv1 as k3
    from clair3_tpu_torch.testing import bf16_ulps, random_variables, trained_fixture_path

    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(41)
    cases = (("hifi", 55, 8, load_variables(trained_fixture_path("fa_hifi.npz")), "real"),
             ("ont", 89, 9, load_variables(trained_fixture_path("fa_ont.npz")), "random"),
             ("rand89x8", 89, 8, None, "random"),
             ("rand55x9", 55, 9, None, "random"))
    worst, timing = {}, {}
    for label, depth, channels, variables, kind in cases:
        ops = conv1_operands(torch, variables, rng, channels)
        errs = {f32: [], bf16: []}
        for B in sorted(set(K3_BATCHES + K3_TIME_BATCHES)):
            if kind == "real":
                x = np.resize(real_fa, (B, depth, 33, channels))
            else:
                x = rng.randint(-100, 101, (B, depth, 33, channels)).astype(np.int8)
            x = torch.from_numpy(x).to(DEVICE)
            for dt in (f32, bf16):
                got = k3.fa_conv1(x, *ops, compute_dtype=dt)
                torch.cuda.synchronize()
                want = k3.fa_conv1_reference(x, *ops, compute_dtype=dt)
                check(got.shape == want.shape == (B, -(-depth // 2), 17, 64)
                      and bool(torch.isfinite(got.float()).all()),
                      f"fa_conv1 {label} B={B} {dt}: shape or non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                ulps = bf16_ulps(got, want)
                errs[dt].append(f"B={B} {err:.3g}" + ("" if dt == f32 else f" ({ulps:.2f} ulps)"))
                if dt == f32:
                    check(err <= K3_F32_TOL, f"fa_conv1 {label} B={B} f32: {err}")
                else:
                    check(ulps <= K3_BF16_ULPS, f"fa_conv1 {label} B={B} bf16: {ulps} ulps")
                worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
                if B in K3_TIME_BATCHES:
                    w, b = k3.prepare(*ops, compute_dtype=dt)
                    k = cuda_ms(torch, lambda: k3.fa_conv1_prepared(x, w, b, dt), 20)
                    p = cuda_ms(torch, lambda: k3.fa_conv1_reference(x, *ops, compute_dtype=dt), 20)
                    lib, layouts = conv1_library_ms(torch, x, ops, dt)
                    flops = 2 * got.numel() * 9 * channels
                    b_ms, by = bound(flops, nbytes(x, got, w, b), dt)
                    timing[(label, B, str(dt))] = (k, p, lib, b_ms, by)
                    print(f"[phase4] time {label:8s} B={B:5d} {str(dt):14s} kernel {k:.4f} ms, "
                          f"plain {p:.4f} ms, library {lib:.4f} ms (nchw {layouts['nchw']:.4f}, "
                          f"channels_last {layouts['channels_last']:.4f}), bound {b_ms:.4f} ms "
                          f"({by}), kernel at {100 * b_ms / k:.1f}% of the bound")
        for dt, found in errs.items():
            print(f"[phase4] {label:8s} {kind:6s} {str(dt):14s} kernel vs twin max |d|: "
                  + ", ".join(found))

    # the net's kernel route against its standard route: the trained hifi
    # net on real tensors, and seeded random weights on random int8 (the
    # condition of tests/test_pallas_fa.py)
    rand_net = FullAlignmentNet(input_channels=8)
    rand_net.load_state_dict(from_jax_variables(random_variables(rand_net, seed=43)))
    nets = {"hifi real": (load_model(trained_fixture_path("fa_hifi.npz"), "fa",
                                     torch.device("cpu"), f32),
                          np.resize(real_fa, (256,) + real_fa.shape[1:])),
            "random": (rand_net, rng.randint(-100, 101, (256, 55, 33, 8)).astype(np.int8))}
    for label, (template, xs) in nets.items():
        x = torch.from_numpy(xs).to(DEVICE)

        def at(dt, use_kernel_conv1=False):
            net = copy.deepcopy(template).to(DEVICE).eval()
            net.compute_dtype, net.use_kernel_conv1 = dt, use_kernel_conv1
            return net

        with torch.inference_mode():
            std32, std16 = at(f32)(x), at(bf16)(x)
            gap16 = (std16 - std32).abs().max().item()
            for dt in (f32, bf16):
                net = at(dt, use_kernel_conv1=True)
                before = k3.launches
                got = net(x)
                check(k3.launches == before + 1, "the FA net's kernel route did not launch K3")
                err = (got - std32).abs().max().item()
                # bf16 is bounded where tests/test_pallas_fa.py bounds it
                # (random weights, random int8); the trained net on real
                # tensors is reported only: there the JAX package's own bf16
                # nets move p by 1.6e-2 (standard) and 3.4e-2 (Pallas
                # conv1) from f32 on these tensors (measured on the CPU)
                bounded = dt == f32 or label == "random"
                tol = 2e-4 if dt == f32 else 2e-2
                print(f"[phase4] FullAlignmentNet(use_kernel_conv1) {label:9s} {str(dt):14s} "
                      f"vs standard f32 net max |dp| {err:.3g}"
                      + (f" (bound {tol:g})" if bounded else " (reported only)")
                      + f"; vs standard bf16 net {(got - std16).abs().max().item():.3g}; "
                      f"standard bf16 vs f32 {gap16:.3g}")
                if bounded:
                    check(err <= tol, f"FA net kernel route {label} {dt}: {err}")
    return timing, worst


def phase5_bilstm(torch):
    import numpy as np

    from clair3_tpu_torch.ops import bilstm as k2
    from clair3_tpu_torch.ops.lstm import BiLSTM, bilstm

    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(51)
    worst, timing = {}, {}
    for C, H in K2_SHAPES:
        wh32 = torch.from_numpy((rng.randn(2, H, 4 * H) * 0.1).astype(np.float32)).to(DEVICE)
        for B in sorted(set(K2_BATCHES + TIME_BATCHES)):
            xw32 = torch.from_numpy(rng.randn(33, 2, B, 4 * H).astype(np.float32)).to(DEVICE)
            for dt, tol in ((f32, K2_F32_TOL), (bf16, K2_BF16_TOL)):
                xw, wh = xw32.to(dt), wh32.to(dt)
                if B in K2_BATCHES:
                    got = k2.bilstm_recurrence(xw, wh)
                    torch.cuda.synchronize()
                    want = k2.bilstm_recurrence_reference(xw, wh)
                    check(got.shape == want.shape == (33, 2, B, H)
                          and bool(torch.isfinite(got.float()).all()),
                          f"bilstm H={H} B={B} {dt}: shape or non-finite output")
                    err = (got.float() - want.float()).abs().max().item()
                    print(f"[phase5] C={C:3d} H={H} B={B:5d} {str(dt):14s} kernel vs twin "
                          f"max |d| {err:.3g}")
                    check(err <= tol, f"bilstm H={H} B={B} {dt}: {err}")
                    worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
                if B in TIME_BATCHES:
                    y = k2.bilstm_recurrence(xw, wh)
                    k = cuda_ms(torch, lambda: k2.bilstm_recurrence(xw, wh), 10)
                    p = cuda_ms(torch, lambda: k2.bilstm_recurrence_reference(xw, wh), 5)
                    b_ms, by = bound(2 * 33 * 2 * B * H * 4 * H, nbytes(xw, wh, y), dt)
                    timing[(H, B, str(dt))] = (k, p, b_ms, by)
                    print(f"[phase5] time C={C:3d} H={H} B={B:5d} {str(dt):14s} kernel "
                          f"{k:.4f} ms, plain {p:.4f} ms, bound {b_ms:.4f} ms ({by}), kernel "
                          f"at {100 * b_ms / k:.1f}% of the bound")

    # the kernel's module path: BiLSTM(use_kernel=True) at both layer shapes
    mods = []
    for C, H in K2_SHAPES:
        mod = BiLSTM(C, H, use_kernel=True)
        with torch.no_grad():
            for p, scale in ((mod.wi, 1 / np.sqrt(C)), (mod.wh, 0.1), (mod.b, 0.1)):
                p.copy_(torch.from_numpy(rng.randn(*p.shape) * scale))
        x = torch.from_numpy(rng.randn(1000, 33, C).astype(np.float32)).to(DEVICE)
        mods.append((mod.to(DEVICE), x))
    k2.launches = 0
    with torch.inference_mode():
        outs = [mod(x) for mod, x in mods]
        torch.cuda.synchronize()
        launches = k2.launches
        for (mod, x), got in zip(mods, outs):
            err = (got - bilstm(x, mod.wi, mod.wh, mod.b)).abs().max().item()
            print(f"[phase5] BiLSTM(use_kernel=True) C={mod.wi.shape[1]} H={mod.wh.shape[1]} "
                  f"B=1000 f32 vs plain bilstm max |d| {err:.3g}")
            check(err <= K2_F32_TOL, f"BiLSTM kernel route: {err}")
    print(f"[phase5] BiLSTM(use_kernel=True) run: bilstm kernel launches {launches}")
    check(launches == len(mods), f"the BiLSTM module path launched the kernel {launches} times")

    # the library call: torch.nn.LSTM(bidirectional=True) (cuDNN) with the
    # module's weights, timed against the module (its projection + K2)
    library = {}
    with torch.inference_mode():
        for mod, x in mods:
            C, H = mod.wi.shape[1], mod.wh.shape[1]
            lstm = lstm_like(torch, mod)
            err = (lstm(x)[0] - mod(x)).abs().max().item()
            print(f"[phase5] nn.LSTM(bidirectional) C={C} H={H} B=1000 f32 vs "
                  f"BiLSTM(use_kernel=True) max |d| {err:.3g}")
            check(err <= LSTM_LIB_TOL, f"nn.LSTM with the module's weights: {err}")
            for B in TIME_BATCHES:
                xb = torch.from_numpy(rng.randn(B, 33, C).astype(np.float32)).to(DEVICE)
                for dt in (f32, bf16):
                    m, lib = copy.deepcopy(mod).to(dt), copy.deepcopy(lstm).to(dt)
                    lib.flatten_parameters()
                    xd = xb.to(dt)
                    mod_ms = cuda_ms(torch, lambda: m(xd), 10)
                    try:
                        lib_ms = cuda_ms(torch, lambda: lib(xd), 10)
                    except RuntimeError as exc:  # no cuDNN LSTM at this dtype
                        print(f"[phase5] nn.LSTM at {dt}: {exc}")
                        lib_ms = None
                    library[(H, B, str(dt))] = (mod_ms, lib_ms)
                    print(f"[phase5] time C={C:3d} H={H} B={B:5d} {str(dt):14s} "
                          f"BiLSTM(use_kernel=True) {mod_ms:.4f} ms, nn.LSTM (library) "
                          + ("n/a" if lib_ms is None else f"{lib_ms:.4f} ms"))
    return timing, worst, launches, library


def lstm_like(torch, mod):
    """``torch.nn.LSTM(bidirectional=True, batch_first=True)`` holding the
    weights of ``ops.lstm.BiLSTM`` ``mod``: slot 0 forward, slot 1
    reverse, gate order i, f, g, o in both, the folded bias as bias_ih."""
    C, H = mod.wi.shape[1], mod.wh.shape[1]
    lstm = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).to(mod.wi.device)
    with torch.no_grad():
        for d, sfx in ((0, ""), (1, "_reverse")):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(mod.wi[d].T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(mod.wh[d].T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(mod.b[d])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    lstm.flatten_parameters()
    return lstm.eval()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from clair3_tpu_torch import native as host_native
    from clair3_tpu_torch.cli import load_model
    from clair3_tpu_torch.decode import shutdown_decode_pool
    from clair3_tpu_torch.fullalign.extractor import create_fa_tensors
    from clair3_tpu_torch.models import PileupNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.ops import _build
    from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
    from clair3_tpu_torch.testing import random_variables, simulate, trained_fixture_path

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[chip_smoke] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    def timed_native_build():
        t_start = time.time()
        return host_native._build(), time.time() - t_start

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=1) as pool:  # g++ beside the nvcc jobs
        native_build = pool.submit(timed_native_build)
        lib_path = _build.build()
        print(f"[phase1] built {os.path.relpath(lib_path)} in {time.time() - t0:.2f} s "
              f"(nvcc {_build.build_seconds:.2f} s)")
        so_path, so_seconds = native_build.result()
    print(f"[phase1] built the native host library {os.path.relpath(so_path)} in "
          f"{so_seconds:.2f} s (g++)")
    check(host_native.native_available(), "the port's native host library does not load")
    print_ptxas_report(_build.build_log)
    _build.load_library()

    try:
        with tempfile.TemporaryDirectory() as work:
            t0 = time.time()
            fasta, bam, _, variants = simulate(work, EVAL_BP, seed=EVAL_SEED)
            real, cands, _, _ = create_pileup_tensors(bam, fasta, "chr1", 1, EVAL_BP)
            # FA tensors of the first 1024 candidates ("chr1:<pos>:<base>")
            positions = [int(str(c).split(":")[1]) for c in cands[:1024]]
            real_fa, _, _ = create_fa_tensors(bam, fasta, "chr1", positions, matrix_depth=55,
                                              no_phasing=True)
            print(f"[setup] simulated {EVAL_BP} bp, {len(variants)} variants, "
                  f"{len(real)} pileup candidates, FA tensors {tuple(real_fa.shape)} "
                  f"in {time.time() - t0:.2f} s")

            dev = torch.device(DEVICE)
            hifi = load_model(trained_fixture_path("pileup_hifi.npz"), "pileup", dev,
                              torch.float32)
            rand4 = PileupNet(add_indel_length=True)
            rand4.load_state_dict(from_jax_variables(random_variables(rand4, seed=5)))
            rand4 = rand4.to(dev).eval()
            with torch.inference_mode():
                timing, worst = phase2_kernel_vs_plain(
                    torch, [("hifi", hifi), ("random4", rand4)], np.asarray(real))
            launches = phase3_cascade(torch, work, fasta, bam, variants)
            with torch.inference_mode():
                k3_timing, k3_worst = phase4_fa_conv1(torch, np.asarray(real_fa))
            k2_timing, k2_worst, k2_launches, k2_library = phase5_bilstm(torch)
    finally:
        shutdown_decode_pool()

    blocked = ("jax", "flax", "optax", "clair3_tpu")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
    check(not loaded, f"the port loaded {loaded[:5]}")
    bf16 = str(torch.bfloat16)
    k_ms, p_ms, k_bound, k_by = timing[(max(BATCHES), bf16)]
    k3_ms, k3_plain, k3_lib, k3_bound, k3_by = k3_timing[("hifi", max(K3_TIME_BATCHES), bf16)]
    k2_ms, k2_plain, k2_bound, k2_by = k2_timing[(K2_SHAPES[0][1], max(TIME_BATCHES), bf16)]
    k2_lib = k2_library[(K2_SHAPES[0][1], max(TIME_BATCHES), bf16)][1]
    record = {"kernels": [
        {"name": "pileup_full", "route": "cuda",
         "source": "clair3_tpu_torch/csrc/pileup_full.cu",
         "replaces": "clair3_tpu/ops/pallas_pileup.py:267",
         "launches": launches["bf16"]["pileup_full"], "max_abs_err": worst[bf16],
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": k_bound, "bound_by": k_by,
         "library_ms": None},
        {"name": "fa_conv1", "route": "cuda",
         "source": "clair3_tpu_torch/csrc/fa_conv1.cu",
         "replaces": "clair3_tpu/ops/pallas_fa.py:101",
         "launches": launches["bf16+fa_conv1"]["fa_conv1"], "max_abs_err": k3_worst[bf16],
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": k3_lib},
        {"name": "bilstm", "route": "cuda",
         "source": "clair3_tpu_torch/csrc/bilstm.cu",
         "replaces": "clair3_tpu/ops/pallas_lstm.py:60",
         "launches": k2_launches, "max_abs_err": k2_worst[bf16],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": k2_lib},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
