#!/usr/bin/env python3
"""Chip check of the PyTorch port (clair3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and the repository's sources; exits non-zero
without them.  Loads neither jax nor any module of the JAX package that
needs it (checked at the end), whether or not jax is installed.

Phase 1  builds the CUDA kernels from clair3_tpu_torch/csrc/ (nvcc, sm_90a).
Phase 2  holds the pileup kernel against its plain PyTorch twin on the card,
         with the committed hifi weights (2 heads) and seeded random 4-head
         weights, on real pileup tensors (extracted from the phase-3 region)
         and on random counts, at B = 256, 4096, 1000 (not a multiple of
         the tile) and 2048 (the engine's buckets are 256/1024/2048/4096):
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
         once at bf16 and once at f32, and checks: full-alignment rows > 10;
         SNP F1 >= 0.990 and INDEL F1 >= 0.992 at bf16; the kernel launched
         and the plain pileup path never ran on the card; bf16 rows agree with
         f32 rows (<= 1% of rows change call or source, QUAL delta < 1.5
         on pileup-decided rows; after tests/test_bf16_parity.py).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import gzip
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

BATCHES = (256, 4096, 1000, 2048)
F32_TOL = 2e-4
BF16_TOL = 1e-2
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
                    k = cuda_ms(torch, lambda: pf.pileup_full(x, *trunk, heads, compute_dtype=dt), 10)
                    p = cuda_ms(torch, lambda: pf.pileup_full_reference(
                        x, *trunk, heads, compute_dtype=dt), 5)
                    timing[(B, str(dt))] = (k, p)
                    print(f"[phase2] time B={B:5d} {str(dt):14s} kernel {k:.3f} ms, "
                          f"plain {p:.3f} ms, kernel {B / k * 1e3:.0f} cand/s")
    return timing, worst


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


def bf16_vs_f32(out16, out32):
    """bf16 rows against f32 rows, after tests/test_bf16_parity.py: at most
    1% of rows change their call (REF/ALT/GT, or present on one side only)
    or their source (INFO P/F: a candidate routed across the QUAL-quantile
    cutoff); QUAL moves by < 1.5 on rows decided by the pileup net, whose
    kernel this checks.  Rows decided by the full-alignment net are only
    reported: that net's bf16 convolutions move its probabilities by up to
    ~4e-2 against f32 in the JAX package too (measured on the CPU), which
    moves QUAL by a few units."""
    for name in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        def keyed(rows):
            out = {}
            for r in rows:
                c = r.rstrip("\n").split("\t")
                out[c[1]] = (c[3], c[4], c[9].split(":")[0], c[7], float(c[5]))
            return out

        k32 = keyed(_rows(os.path.join(out32, name)))
        k16 = keyed(_rows(os.path.join(out16, name)))
        shared = set(k32) & set(k16)
        changed = (set(k32) ^ set(k16)) | {p for p in shared if k32[p][:4] != k16[p][:4]}
        dq = {src: max((abs(k32[p][4] - k16[p][4]) for p in shared
                        if k32[p][:4] == k16[p][:4] and k32[p][3] == src), default=0.0)
              for src in ("P", "F")}
        print(f"[phase3] bf16 vs f32 {name}: {len(changed)}/{len(k32)} rows changed "
              f"call or source; max QUAL delta {dq['P']:.2f} on pileup rows, "
              f"{dq['F']:.2f} on full-alignment rows")
        check(len(k32) > 50, f"{name}: too few rows")
        check(len(changed) <= max(1, len(k32) // 100), f"{name}: {len(changed)} rows changed")
        check(dq["P"] < 1.5, f"{name}: QUAL delta {dq['P']} on pileup rows")


class _LogTap(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase3_cascade(torch, work, fasta, bam, variants):
    from clair3_tpu.io.vcf import VcfReader, VcfRecord
    from clair3_tpu.postprocess import variant_metrics
    from clair3_tpu.testing import trained_fixture_path
    from clair3_tpu_torch.cli import main as port_main
    from clair3_tpu_torch.models import pileup as pileup_model
    from clair3_tpu_torch.ops import pileup_full as pf

    truth = [VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                       "1/1" if v.genotype == (1, 1) else "0/1") for v in variants]
    tap = _LogTap()
    logging.getLogger().addHandler(tap)
    logging.getLogger().setLevel(logging.INFO)
    outs, result = {}, {}
    for flag in ("bf16", "fp32"):
        out = os.path.join(work, f"out_{flag}")
        argv = ["call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out,
                "--pileup_model", trained_fixture_path("pileup_hifi.npz"),
                "--full_alignment_model", trained_fixture_path("fa_hifi.npz"),
                "--device", DEVICE, "--compute_dtype", flag, *CALL_ARGS]
        del tap.lines[:]
        pf.launches = 0
        pileup_model.plain_cuda_forwards = 0
        t0 = time.time()
        rc = port_main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, plain = pf.launches, pileup_model.plain_cuda_forwards
        check(rc == 0, f"call at {flag} returned {rc}")
        outs[flag] = out
        for line in tap.lines:
            if line.startswith(("[pileup]", "[select]", "[timing]")):
                print(f"[phase3] {flag} {line}")
        fa_rows = sum(1 for _ in VcfReader(os.path.join(out, "full_alignment.vcf.gz")))
        query = [r for r in VcfReader(os.path.join(out, "merge_output.vcf.gz"))
                 if r.filter in ("PASS", ".")]
        m = variant_metrics(truth, query)
        print(f"[phase3] {flag}: wall {wall:.2f} s, pileup kernel launches {launches}, "
              f"plain pileup forwards on the card {plain}, FA rows {fa_rows}, "
              f"SNP F1 {m['SNP'].f1:.6f} (P {m['SNP'].precision:.6f} R {m['SNP'].recall:.6f}), "
              f"INDEL F1 {m['INDEL'].f1:.6f} (P {m['INDEL'].precision:.6f} "
              f"R {m['INDEL'].recall:.6f})")
        check(launches > 0, f"{flag}: the pileup kernel never launched")
        check(plain == 0, f"{flag}: the plain pileup path ran on the card")
        check(fa_rows > 10, f"{flag}: FA stage never engaged ({fa_rows} rows)")
        if flag == "bf16":
            check(m["SNP"].f1 >= GATE_SNP_F1, f"SNP F1 {m['SNP'].f1}")
            check(m["INDEL"].f1 >= GATE_INDEL_F1, f"INDEL F1 {m['INDEL'].f1}")
        result[flag] = launches
    logging.getLogger().removeHandler(tap)
    bf16_vs_f32(outs["bf16"], outs["fp32"])
    return result


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this check runs only on a GPU",
              file=sys.stderr)
        return 2
    import scripts.full_cascade_demo as demo
    from clair3_tpu.decode import shutdown_decode_pool
    from clair3_tpu.pileup.extractor import create_pileup_tensors
    from clair3_tpu.testing import trained_fixture_path
    from clair3_tpu_torch.cli import load_model
    from clair3_tpu_torch.models import PileupNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.ops import _build
    from clair3_tpu_torch.testing import random_variables

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

    t0 = time.time()
    lib_path = _build.build()
    print(f"[phase1] built {os.path.relpath(lib_path)} in {time.time() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[phase1] {line.strip()}")
    _build.load_library()

    try:
        with tempfile.TemporaryDirectory() as work:
            t0 = time.time()
            fasta, bam, _, variants = demo.simulate(work, EVAL_BP, seed=EVAL_SEED)
            real, _, _, _ = create_pileup_tensors(bam, fasta, "chr1", 1, EVAL_BP)
            print(f"[setup] simulated {EVAL_BP} bp, {len(variants)} variants, "
                  f"{len(real)} pileup candidates in {time.time() - t0:.2f} s")

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
    finally:
        shutdown_decode_pool()

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax"))
    check(not loaded, f"the port loaded {loaded[:5]}")
    k_ms, p_ms = timing[(max(BATCHES), str(torch.bfloat16))]
    record = {"kernels": [{
        "name": "pileup_full",
        "route": "cuda",
        "source": "clair3_tpu_torch/csrc/pileup_full.cu",
        "replaces": "clair3_tpu/ops/pallas_pileup.py:267",
        "launches": launches["bf16"],
        "max_abs_err": worst[str(torch.bfloat16)],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
