#!/usr/bin/env python3
"""Chip check of the PyTorch port (clair3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, ends with the ok line
    python3 chip_smoke.py --phases 1,6   # the build and the named phases only

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
Phase 2  holds the pileup kernels against their plain PyTorch twins on the
         card (bf16: the three tensor-core launches of csrc/pileup_tc.cu;
         f32: the SIMT kernel of csrc/pileup_full.cu), with the committed
         hifi weights (2 heads) and seeded random 4-head weights, on real
         pileup tensors (extracted from the phase-3 region) and on random
         counts, at B = 256, 4096, 1000 and 2048 (the engine's buckets are
         256/1024/2048/4096), 1024, 1 and 33 (not multiples of the tile),
         with its trunk mode; each bf16 launch (L1, L2, L3) against its twin
         on the same input, max |d| <= 2e-2 and mean |d| <= 1e-4; timed at
         B = 256, 1024, 2048, 4096 on packed operands beside the bound, with
         each launch and the packing (no PyTorch call computes the whole net
         or its trunk, so neither has a library time):
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
         launched and the plain pileup path never ran on the card (at
         bf16 L1, L2 and L3 once per call and the SIMT kernel never, at f32
         the reverse, by the per-kernel counts); the FA
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
Phase 5  holds the BiLSTM recurrence kernel against its plain twins
         (ops/bilstm.py) at the pileup net's two layer shapes (C=18, H=128;
         C=256, H=160), B = 256, 1000, 4096, random xw and wh x 0.1, in both
         layouts (the TPU one, [T, 2, B, 4H] -> [T, 2, B, H], and the
         module's batch-major one, [B, T, 8H] -> [B, T, 2H], read and
         written by strides): f32 (SIMT kernel) within 1e-5, bf16
         (tensor-core kernel) within 1e-2; drives BiLSTM(use_kernel=True)
         (the kernel's module path: one addmm, one launch) at f32 against
         the plain bilstm within 1e-5 and at bf16 against its twin within
         1e-2, and against torch.nn.LSTM(bidirectional=True) (cuDNN) with
         the same weights within 1e-4; times the kernel in both layouts and
         the twin beside the bound, and the module against nn.LSTM (the
         library call), at B = 1024, 4096, f32 and bf16.
Phase 6  drives the rest of the inference surface through the port's CLI,
         every run at bf16 unless named, each with its kernel counts set to 0
         just before it and read just after:
         - ONT: a simulated 80 kb ONT region (seed 91; depth 89, the dwell
           channel read from simulated mv tags) with the committed ONT nets
           and --enable_dwell_time, the call of the JAX package's ONT gate
           (tests/test_trained_fixture_cascade.py), at bf16 and f32: SNP F1
           >= 0.97 and INDEL F1 >= 0.93 at bf16, FA rows > 10, every FA
           batch 89 x 33 x 9 with a non-zero dwell channel, bytes_shipped
           below the dense count; bf16-vs-f32 row changes printed;
         - .pt: the hifi nets written as the reference's pileup.pt and
           full_alignment.pt (write_reference_checkpoints) and called with
           --model_path on the phase-3 region: pileup.vcf.gz rows equal the
           .npz bf16 run's, merge_output.vcf.gz passes
           vcf_rows_numerically_equivalent with flip budget 0 (byte
           equality printed), the hifi F1 gates, and the pileup operands
           packed once, under one cache key for every forward;
         - serve: build_server(device=cuda) on the hifi nets, warmed as
           `serve` warms them, on 127.0.0.1, then `call --remote_engines`
           on the phase-3 region: rows against the local bf16 run within
           flip budget 0 (byte equality printed); the kernels counted in
           the serving engines; server.stats() and the remote wall time
           beside the local one printed;
         - profile: a warm hifi call with --profile_dir: the Chrome trace
           holds CUDA kernel events of L1, L2 and L3; prints the device-busy
           share (summed kernel time over the call's wall time) and the
           kernels that take it.
         Every run launches L1, L2 and L3 once per pileup call and the SIMT
         kernel never (f32: the reverse), and no plain pileup forward runs
         on the card.

Phase 7  trains both nets on the card: the port's full-cascade demo
         (clair3_tpu_torch/full_cascade_demo.py) at its defaults on the hifi
         geometry (260 kb simulated, seed 7; pileup 400 steps at batch 1000,
         FA 300 steps at batch 500, f32, with this script's TF32 setting),
         its bins written as HDF5 when h5py imports and trained from memory
         with the same chunks, offsets and batches when it does not.  With
         h5py it also runs `tensor2bin --pileup` and `train --device cuda`
         (one epoch) through the CLI on the training region.  Prints each
         net's training step (median of 20 after 5 warm steps, CUDA events)
         split into forward + loss, backward and the AdamW step, with
         samples/s, at the demo's batch and, for pileup, at 2000
         (TrainConfig's default); each net's training wall and
         best_val_loss.  Checks: every parameter and batch of every step on
         the card; best_val_loss finite; both checkpoints load through
         load_model in eval mode; the held-out call (the last 40 kb) at bf16
         launches L1, L2 and L3 once per pileup call, the SIMT kernel never,
         and no plain pileup forward on the card; FA rows > 10; SNP F1 >=
         0.985 (the demo's gate) and INDEL F1 >= 0.834437 at bf16: the
         lowest INDEL F1 of the JAX package's own demo over training seeds
         0-4 (tools/demo_seed_sweep.py, CPU).  The demo's INDEL gate of 0.97
         is missed by every one of those seeds and by the port; its verdict
         is printed.  Training and the calls run with cudnn.deterministic,
         so one seed gives one F1.  The same call at f32 is printed beside
         it.

Phase 8  multi-process calling, every call an OS process of its own: one
         bf16 `call --gvcf` on the phase-3 region in four 30 kb chunks, then
         the same call in two `--dist_*` processes (gloo on 127.0.0.1, a
         free port) that share cuda:0, merged by the port's `sort_vcf` and
         `sort_vcf --gvcf`, then one `run_clair3_tpu_torch.py` call with the
         reference's spellings (--ctgName, --sampleName, --threads_num,
         --fast_mode False, --device).  Checks: the merged VCF and gVCF rows
         and the run_clair3_tpu_torch.py rows against the single process's,
         flip budget 0 (byte identity printed); every child's `[kernels]`
         line shows L1, L2 and L3 launched once per pileup call and the SIMT
         kernel never; no child loaded jax, flax, optax or clair3_tpu; every
         process wrote rows; `validate_gvcf` passes on the merged gVCF.
         Prints each process's wall (spawn to exit, host clock), the pair's
         wall, each process's gather (barrier and all_gather ms) and the
         pair's summed launches.  Then genotyping mode (`--vcf_fn` of the
         region's simulated variants) and final phasing
         (`--use_phasing_for_final_output --use_haplotagging_for_final_output`),
         each as one process and as a pair, all three started together:
         the merged VCF and gVCF, and the merged phased VCF, against the
         single process's, flip budget 0 (byte identity printed; known
         sites added back as ./. counted); process 0's phased_output.bam
         carries the single process's HP/PS tags on every read, and process
         1 writes none; the same launch and import checks for every child.

Phase 9  data-parallel training (`fit(..., data_parallel=True)`, the path of
         `train --data_parallel`; h5py is not needed: seeded arrays from
         memory through testing.ArrayDataset), every rank an OS process
         under `python -m torch.distributed.run --standalone`, f32 with
         TF32 off and cudnn.deterministic, the demo's geometry (chunks of
         100 rows; pileup batch 1000, 3 steps; FA batch 500, 3 steps and 1
         step).  One rank on NCCL against the plain single-device `fit` in
         this process: losses and parameters within 1e-6 (bit-for-bit
         equality printed).  Two gloo ranks sharing cuda:0 (NCCL refuses
         two ranks on one GPU) against the one rank on the same batches,
         the two ranks' nets equal bit for bit: the pileup net's losses
         within rtol 1e-5 and its parameters within 1e-5 on all but a 1e-5
         share of the entries (AdamW moves an entry whose gradient is
         rounding noise by up to lr a step, bounded at 2 lr); the FA net
         after one step: training loss within rtol 1e-5, the cross-rank
         BatchNorm's running statistics within 1e-6, validation loss within
         rtol 1e-3, parameters within 2 lr.  Then each net's step at its
         batch, plain and as the one NCCL rank's DDP replica, timed in turns
         (plain, DDP, DDP, plain; each the median of 20 after 5 warm steps,
         CUDA events), and the DDP overhead.  Every
         rank's parameters on the card, and no rank loaded jax or
         clair3_tpu.  Two ranks sharing one card give no speed figure.

Phase 10 the port's soak (clair3_tpu_torch/wgs_scale_demo.py) with the
         committed hifi pair, on input simulated from the fixtures' manifest
         (tests/fixtures/trained/manifest.json: 25x, 900 bp reads, 2%
         error), simulated by the script's build_input in a process started
         right after phase 1, beside phases 2-9 (its walls printed).  First
         the parity slice (one 1 Mb contig, seed 23, the script's calling
         configuration), called by the f32 CPU twin
         (testing.TorchCpuEngine, on this host's CPU), then on the card at
         f32 (TF32 off) and at bf16, each card run with its kernel counts
         set to 0 just before it and read just after.  Checks: f32 rows
         against the twin's within vcf_rows_numerically_equivalent, flip
         budget 0; bf16 rows against the twin's with every discrete field
         equal on every same-route row (the script's structural check, its
         flip budget 0.005), at most 1% of rows changing call or P/F source
         and QUAL moving < 1.5 on pileup-decided rows (the bf16-vs-f32 bound
         of phase 3); the script's own qual_tol of 1.0 and the largest QUAL
         move on FA-decided rows are printed.  Then the soak itself, as a
         user runs it: `python -m clair3_tpu_torch.wgs_scale_demo --engines
         production --reuse_input` in an OS process of its own, bf16 on the
         card, gVCF on, over 12 Mb in 2 contigs, each longer than one 5 Mb
         chunk.  Every gate of the script holds: site recall >= 0.95, SNP
         F1 >= 0.95, INDEL F1 >= 0.90, contig-ordered output with a .tbi, 0
         gVCF violations, and peak RSS <= --max_rss_gb, set to the script's
         default 8 GB above the peak RSS of the torch/CUDA runtime alone
         (import torch, a CUDA context, one cuDNN convolution, in a process
         of its own: ~5.6 GB on the card host).  L1,
         L2 and L3 launch equally often and above 0, the SIMT kernel never,
         no plain pileup forward runs on the card, and the process loads
         nothing of jax or clair3_tpu.  Prints the simulation and calling
         walls, Mb/min, the stage times, peak RSS, the BAM's size, truth
         sites, recall, F1, the validator's counts and K1's launches per Mb,
         each beside the card's name and power limit.

Phase 11 the port's bench and its two microbenches, each run as a user runs it
         (`python -m clair3_tpu_torch.bench`, then `.bench_fa_conv1` and
         `.bench_history`, no arguments: cuda), an OS process of its own,
         alone on the card, one after the other; every line they print is
         printed beside the card's name and power limit.  Checks: each exits
         0 and loads nothing of jax or clair3_tpu; the bench's result line
         parses with value > 0; its `[kernels]` line shows L1, L2 and L3
         launched equally often and above 0, the SIMT kernel and the plain
         pileup path never; its ONT line and its serve line were printed,
         with more requests than forwards (coalescing); each engine's
         bytes_shipped is below the dense count; bench_fa_conv1's route
         check held (the K3 route against the cuDNN net, bf16, random
         weights, 2e-2) and K3 launched; bench_history's three route checks
         held (0.02 against the shipped route on real pileup rows) and its
         kernel routes ran (L1/L2/L3 and the SIMT kernel).

Phase 12 Illumina on the card: the Illumina notebook's sample (60 kb, 150 bp
         reads, 40x, 0.2% error, seed 11, a variant every 160 bp), called by
         `call --platform ilmn --no_phasing_for_fa` with the committed hifi
         nets (the ilmn preset has hifi's geometry) on the card at f32 and
         bf16, and on the CPU at f32, as tests/test_torch_realign.py calls
         it.  Checks: tmp/realigned.bam and tmp/full_aln_regions.bed
         byte-identical between each card run and the CPU run; card f32 rows
         against CPU f32 rows by `testing.f32_rows_equivalent` (flip budget
         0; rows above QUAL 60 held on 1 - p) for pileup.vcf.gz,
         full_alignment.vcf.gz and merge_output.vcf.gz; bf16 against f32
         within phase 3's bound; L1, L2 and L3 once per pileup call at bf16,
         the SIMT kernel at f32, no plain pileup forward on the card; FA rows
         > 10.  F1 against the simulated truth is printed with no gate: the
         nets were trained on hifi reads.

Phase 13 the engine over several devices, as the JAX engine shards each
         batch over its local mesh: with the committed hifi and ONT nets,
         built as `cli._load_engine` builds them (compact wire forms, FA
         depth crop), on phase 3's pileup and FA tensors and on the same of
         phase 6's ONT region (seed 91, depth 89, dwell channel): engines
         over `parallel.mesh.local_devices("cuda")` (their device count
         printed) and over two replicas of cuda:0, each on its own stream,
         held against the one-device engine at f32 (TF32 off), bf16, and
         for the FA nets bf16 with CLAIR3T_ENABLE_FA_CONV1=1.  Checks: f32
         max |dp| <= 1e-5 (pileup and FA), bytes_shipped and dense_bytes
         equal; bf16 pileup max |dp| <= 1e-6, FA printed; K3 launched by
         every replica of the opt-in engines and by none otherwise; no
         plain pileup forward on the card.  Then `call` on the 120 kb region
         at f32 and bf16, once on one device and once with its engines over
         the two replicas: f32 merged and pileup rows against the one-device
         run by `vcf_rows_numerically_equivalent`, flip budget 0; the bf16
         run within phase 3's bf16-vs-f32 bound, byte-identical rows against
         the one-device bf16 run printed; K1's launches counted per replica
         (each replica's forwards, read around it): at bf16 each replica
         launches L1, L2 and L3 and never the SIMT kernel, at f32 the
         reverse.  Each engine's wall per batch is printed beside the card's
         name and power limit (one card: the replicas share it, and their
         times say nothing of several cards).

With --phases (a comma-separated subset of 1-13) only those phases run (the
kernels are built in any case) and the script ends without the kernels'
record and the ok line.  Otherwise the line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import copy
import gzip
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time

BATCHES = (256, 4096, 1000, 2048, 1024, 1, 33)
K1_TIME_BATCHES = (256, 1024, 2048, 4096)
F32_TOL = 2e-4
BF16_TOL = 1e-2
LAUNCH_MAX, LAUNCH_MEAN = 2e-2, 1e-4
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
PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)
CALL_ARGS = ["--platform", "hifi", "--indel_min_af", "0.12", "--threads", "4",
             "--var_pct_full", "0.3", "--ref_pct_full", "0.3"]
# the ONT region and gates of tests/test_trained_fixture_cascade.py
ONT_EVAL_BP = 80_000
GATE_ONT_SNP_F1 = 0.97
GATE_ONT_INDEL_F1 = 0.93
# INDEL F1 of the held-out call through nets trained on the card: the
# lowest the JAX package's own demo reaches over training seeds 0-4 at this
# scale (scripts/full_cascade_demo.py on the CPU, f32, through
# tools/demo_seed_sweep.py: 0.937143, 0.954023, 0.834437, 0.924855,
# 0.948571), with no margin.  The demo's own 260 kb gate (0.97) is missed by
# every one of those seeds; its verdict is printed beside the check.  The SNP
# check is the demo's gate (0.985).
GATE_TRAINED_INDEL_F1 = 0.834437
JAX_DEMO_INDEL_F1 = (0.937143, 0.954023, 0.834437, 0.924855, 0.948571)
ONT_CALL_ARGS = ["--platform", "ont", "--snp_min_af", "0.08", "--indel_min_af", "0.15",
                 "--threads", "4", "--var_pct_full", "0.7", "--ref_pct_full", "0.1",
                 "--enable_dwell_time"]


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
        m = re.search(r"Compiling entry function '\w*?((?:pileup_full|pileup_l1_tc|pileup_l2_tc|"
                      r"pileup_head|bilstm_tc|bilstm|fa_conv1_tc|fa_conv1)_kernel)"
                      r"(?:I(13__nv_bfloat16|f|Li(\d+)E))?", line)
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


def route_launches(got, dt, calls, label):
    """``got`` (launches by kernel) is each kernel of ``dt``'s route
    ``calls`` times and the other route's never."""
    tc = dt == "torch.bfloat16"
    want = {"pileup_l1_tc": calls * tc, "pileup_l2_tc": calls * tc, "pileup_head": calls * tc,
            "pileup_full": calls * (not tc)}
    check(got == want, f"{label}: pileup kernels launched {got}, expected {want}")


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
                    before = dict(pf.kernel_launches)
                    got = pf.pileup_full(x, *trunk, heads, compute_dtype=dt)
                    torch.cuda.synchronize()
                    route_launches({k: v - before[k] for k, v in pf.kernel_launches.items()},
                                   str(dt), 1, str(dt))
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
                # trunk mode: the n_heads = 0 launch of the same kernels
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
                if dt == bf16:
                    launch_vs_twins(torch, pf, label, B, x, trunk, heads)
            if label == "hifi" and B in K1_TIME_BATCHES:
                for dt in (bf16, f32):
                    timing[(B, str(dt))] = time_k1(torch, pf, B, inputs["real"], trunk, heads, dt)
    return timing, worst


def launch_vs_twins(torch, pf, label, B, x, trunk, heads):
    """Each tensor-core launch against its plain twin on the same input
    (L2 on L1's output, L3 on L2's): a rounding flip of h (one bf16 ulp)
    carried through later steps moves the max; a misplaced fragment would
    move the mean by ~1e-1."""
    wi1, wh1, b1, wi2, wh2, b2, wd, bd = trunk
    dt = torch.bfloat16
    packed = pf.pack_pileup_operands(trunk, heads, dt, x.device)
    check(packed.tc, f"{label}: the bf16 operands did not take the tensor-core route")
    xc = x.to(dt).contiguous()
    h1 = pf.launch_l1(xc, packed)
    h2 = pf.launch_l2(h1, packed)
    probs = pf.launch_head(h2, packed)
    trunk_out = pf.launch_head(h2, packed, with_heads=False)
    torch.cuda.synchronize()
    errs = {
        "L1": (h1.float() - pf.pileup_l1_reference(xc, wi1, wh1, b1, dt).float()),
        "L2": (h2.float() - pf.pileup_l2_reference(h1, wi2, wh2, b2, dt).float()),
        "L3": probs - pf.pileup_head_reference(h2, wd, bd, heads, dt),
        "L3 trunk": (trunk_out.float() - pf.pileup_head_reference(h2, wd, bd, (), dt).float()),
    }
    for name, d in errs.items():
        check(bool(torch.isfinite(d).all()), f"{label} B={B} {name}: non-finite output")
        check(d.abs().max().item() <= LAUNCH_MAX and d.abs().mean().item() <= LAUNCH_MEAN,
              f"{label} B={B} {name} vs its twin: max {d.abs().max().item()}, "
              f"mean {d.abs().mean().item()}")
    print(f"[phase2] {label:7s} B={B:5d} bf16 launches vs their twins, max |d| (mean |d|): "
          + ", ".join(f"{n} {d.abs().max().item():.3g} ({d.abs().mean().item():.2g})"
                      for n, d in errs.items()))


def time_k1(torch, pf, B, x, trunk, heads, dt):
    """K1 at batch B: the call on packed operands, the packing, each
    tensor-core launch, the trunk mode and the plain twin (CUDA events),
    beside the bound.  Returns the numbers by name."""
    packed = pf.pack_pileup_operands(trunk, heads, dt, x.device)
    y = pf.pileup_full_packed(x, packed)
    t = {"ms": cuda_ms(torch, lambda: pf.pileup_full_packed(x, packed), 10),
         "pack_ms": cuda_ms(torch, lambda: pf.pack_pileup_operands(trunk, heads, dt, x.device), 5),
         "plain_ms": cuda_ms(torch, lambda: pf.pileup_full_reference(
             x, *trunk, heads, compute_dtype=dt), 5)}
    t["bound_ms"], t["bound_by"] = bound(2 * B * k1_macs(trunk, heads),
                                         nbytes(x, y, *trunk, *heads), dt)
    launch = ""
    if packed.tc:
        xc = x.to(dt).contiguous()
        h1 = pf.launch_l1(xc, packed)
        h2 = pf.launch_l2(h1, packed)
        t["launch_ms"] = {"l1": cuda_ms(torch, lambda: pf.launch_l1(xc, packed), 10),
                          "l2": cuda_ms(torch, lambda: pf.launch_l2(h1, packed), 10),
                          "head": cuda_ms(torch, lambda: pf.launch_head(h2, packed), 10)}
        launch = ", launches " + ", ".join(f"{k} {v:.4f}" for k, v in t["launch_ms"].items()) + " ms"
    print(f"[phase2] time B={B:5d} {str(dt):14s} kernel {t['ms']:.4f} ms (packed operands){launch}; "
          f"packing {t['pack_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), kernel at "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound, {B / t['ms'] * 1e3:.0f} cand/s")
    # trunk mode (n_heads = 0), the counterpart of pileup_trunk_pallas
    packed_t = pf.pack_pileup_operands(trunk, (), dt, x.device)
    y = pf.pileup_trunk_packed(x, packed_t)
    k = cuda_ms(torch, lambda: pf.pileup_trunk_packed(x, packed_t), 10)
    p = cuda_ms(torch, lambda: pf.pileup_trunk_reference(x, *trunk, compute_dtype=dt), 5)
    b_ms, by = bound(2 * B * k1_macs(trunk, ()), nbytes(x, y, *trunk), dt)
    t["trunk_ms"] = k
    print(f"[phase2] time B={B:5d} {str(dt):14s} trunk mode {k:.4f} ms, "
          f"plain {p:.3f} ms, bound {b_ms:.4f} ms ({by}), kernel at "
          f"{100 * b_ms / k:.1f}% of the bound")
    return t


def _rows(path):
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


def write_reference_checkpoints(pileup_npz, fa_npz, out_dir):
    """``pileup.pt`` and ``full_alignment.pt`` in the reference's torch
    layout (the inverse of ``models/convert.py``) from two .npz checkpoints,
    written to ``out_dir``.  An LSTM's one bias ``b`` becomes
    ``bias_ih = b``, ``bias_hh = 0``, so converting back is exact."""
    import numpy as np
    import torch

    from clair3_tpu_torch.models.params_io import flatten_tree, load_variables

    for src, name in ((pileup_npz, "pileup.pt"), (fa_npz, "full_alignment.pt")):
        sd = {}
        for key, v in flatten_tree(load_variables(src)).items():
            collection, *path = key.split("/")
            leaf = path[-1]
            if path[0].startswith("LSTM"):  # LSTMn/{fwd,bwd}/{wi,wh,b}
                suffix = "_reverse" if path[1] == "bwd" else ""
                if leaf == "b":
                    sd[f"{path[0]}.bias_ih_l0{suffix}"] = v
                    sd[f"{path[0]}.bias_hh_l0{suffix}"] = np.zeros_like(v)
                else:
                    gate = "ih" if leaf == "wi" else "hh"
                    sd[f"{path[0]}.weight_{gate}_l0{suffix}"] = v.T
                continue
            if path[0].startswith("res_block"):
                path.insert(1, "0")  # the reference wraps each block in nn.Sequential
            if collection == "batch_stats":
                path[-1] = "running_" + leaf
            elif leaf == "kernel":  # Dense [in, out], conv [kh, kw, I, O]
                path[-1] = "weight"
                v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
            elif leaf == "scale":
                path[-1] = "weight"
            sd[".".join(path)] = v
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   os.path.join(out_dir, name))


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


def bf16_vs_f32(out16, out32, tag="phase3"):
    """bf16 rows against f32 rows, after tests/test_bf16_parity.py: at most
    1% of rows change their call or their source; QUAL moves by < 1.5 on
    rows decided by the pileup net, whose kernel this checks.  Rows decided
    by the full-alignment net are only reported: that net's bf16
    convolutions move its probabilities by up to ~4e-2 against f32 in the
    JAX package too (measured on the CPU), which moves QUAL by a few
    units."""
    for name in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        changed, n, dq = rows_changed(out32, out16, name)
        print(f"[{tag}] bf16 vs f32 {name}: {len(changed)}/{n} rows changed "
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


def zero_kernel_counts():
    from clair3_tpu_torch.models import pileup as pileup_model
    from clair3_tpu_torch.ops import fa_conv1 as k3
    from clair3_tpu_torch.ops import pileup_full as pf

    pf.launches = 0
    pf.kernel_launches.update(dict.fromkeys(pf.kernel_launches, 0))
    k3.launches = 0
    pileup_model.plain_cuda_forwards = 0


def kernel_counts():
    from clair3_tpu_torch.models import pileup as pileup_model
    from clair3_tpu_torch.ops import fa_conv1 as k3
    from clair3_tpu_torch.ops import pileup_full as pf

    return {"calls": pf.launches, "kernels": dict(pf.kernel_launches), "conv1": k3.launches,
            "plain": pileup_model.plain_cuda_forwards}


def counted_call(torch, tag, label, argv, env=None):
    """``clair3_tpu_torch call`` with ``argv``, in this process, with every
    kernel count set to 0 just before it and read just after.  Prints the
    pipeline's stage lines and each engine it loaded with its bytes_shipped
    beside the dense count (and checks it is below).  Returns the wall time,
    the counts, the engines and how often the pileup operands were packed."""
    from clair3_tpu_torch import cli as port_cli
    from clair3_tpu_torch.models import pileup as pileup_model

    engines, packs = [], []
    load_engine, pack = port_cli._load_engine, pileup_model.pack_pileup_operands

    def recording_load_engine(*args, **kwargs):
        engine = load_engine(*args, **kwargs)
        engines.append((args[1], engine))
        return engine

    def recording_pack(*args, **kwargs):
        packs.append(1)
        return pack(*args, **kwargs)

    tap = _LogTap()
    root = logging.getLogger()
    root.addHandler(tap)
    root.setLevel(logging.INFO)
    port_cli._load_engine, pileup_model.pack_pileup_operands = recording_load_engine, recording_pack
    env = env or {}
    os.environ.update(env)
    zero_kernel_counts()
    t0 = time.time()
    try:
        rc = port_cli.main(argv)
        torch.cuda.synchronize()
    finally:
        port_cli._load_engine, pileup_model.pack_pileup_operands = load_engine, pack
        root.removeHandler(tap)
        for key in env:
            del os.environ[key]
    wall = time.time() - t0
    result = {"wall": wall, **kernel_counts(), "engines": engines, "packs": len(packs)}
    check(rc == 0, f"call at {label} returned {rc}")
    for line in tap.lines:
        if line.startswith(("[pileup]", "[select]", "[timing]")):
            print(f"[{tag}] {label} {line}")
    for kind, engine in engines:
        print_bytes_shipped(tag, f"{label} {kind}", engine)
    return result


def print_bytes_shipped(tag, label, engine):
    ratio = engine.bytes_shipped / engine.dense_bytes
    print(f"[{tag}] {label} engine: bytes_shipped {engine.bytes_shipped} "
          f"against {engine.dense_bytes} dense ({ratio:.4f}x)")
    check(engine.bytes_shipped < engine.dense_bytes,
          f"{label}: the compact forms shipped no fewer bytes than dense")


def score(out, variants):
    """(full-alignment rows, variant_metrics of the merged PASS rows
    against the simulated truth)."""
    from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord
    from clair3_tpu_torch.postprocess import variant_metrics

    truth = [VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                       "1/1" if v.genotype == (1, 1) else "0/1") for v in variants]
    fa_rows = sum(1 for _ in VcfReader(os.path.join(out, "full_alignment.vcf.gz")))
    query = [r for r in VcfReader(os.path.join(out, "merge_output.vcf.gz"))
             if r.filter in ("PASS", ".")]
    return fa_rows, variant_metrics(truth, query)


def f1_text(m):
    return (f"SNP F1 {m['SNP'].f1:.6f} (P {m['SNP'].precision:.6f} R {m['SNP'].recall:.6f}), "
            f"INDEL F1 {m['INDEL'].f1:.6f} (P {m['INDEL'].precision:.6f} "
            f"R {m['INDEL'].recall:.6f})")


def check_pileup_route(torch, label, r, flag):
    """The pileup kernels ran on the card and the plain pileup path never
    did: at bf16 L1, L2 and L3 once per call and the SIMT kernel never, at
    f32 the reverse."""
    check(r["calls"] > 0, f"{label}: the pileup kernel never launched")
    route_launches(r["kernels"], str(torch.bfloat16 if flag == "bf16" else torch.float32),
                      r["calls"], label)
    check(r["plain"] == 0, f"{label}: the plain pileup path ran on the card")


PHASE3_RUNS = (("bf16", "bf16", {}), ("fp32", "fp32", {}),
               ("bf16+fa_conv1", "bf16", {"CLAIR3T_ENABLE_FA_CONV1": "1"}))


def hifi_argv(fasta, bam, out, flag, *models):
    """`call` on the phase-3 region at ``flag``, with the committed hifi nets
    unless ``models`` names others."""
    from clair3_tpu_torch.testing import trained_fixture_path

    models = models or ("--pileup_model", trained_fixture_path("pileup_hifi.npz"),
                        "--full_alignment_model", trained_fixture_path("fa_hifi.npz"))
    return ["call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out,
            *models, "--device", DEVICE, "--compute_dtype", flag, *CALL_ARGS]


def phase3_cascade(torch, work, fasta, bam, variants):
    outs, result = {}, {}
    for label, flag, env in PHASE3_RUNS:
        out = os.path.join(work, f"out_{label}")
        r = counted_call(torch, "phase3", label, hifi_argv(fasta, bam, out, flag), env)
        outs[label] = out
        fa_rows, m = score(out, variants)
        print(f"[phase3] {label}: wall {r['wall']:.2f} s, pileup kernel calls {r['calls']} "
              f"(launches {r['kernels']}), "
              f"FA conv1 kernel launches {r['conv1']}, plain pileup forwards on the card "
              f"{r['plain']}, FA rows {fa_rows}, {f1_text(m)}")
        check_pileup_route(torch, label, r, flag)
        check(fa_rows > 10, f"{label}: FA stage never engaged ({fa_rows} rows)")
        if env:
            check(r["conv1"] > 0, f"{label}: the FA conv1 kernel never launched")
        else:
            check(r["conv1"] == 0, f"{label}: the FA conv1 kernel launched without the opt-in")
        if flag == "bf16":
            check(m["SNP"].f1 >= GATE_SNP_F1, f"{label}: SNP F1 {m['SNP'].f1}")
            check(m["INDEL"].f1 >= GATE_INDEL_F1, f"{label}: INDEL F1 {m['INDEL'].f1}")
        result[label] = {"pileup_full": r["calls"], "pileup_kernels": r["kernels"],
                         "fa_conv1": r["conv1"], "out": out, "wall": r["wall"]}
    bf16_vs_f32(outs["bf16"], outs["fp32"])
    conv1_vs_default(outs["bf16+fa_conv1"], outs["bf16"])
    return result


def rows_equivalent(tag, label, out_a, out_b, name):
    """``name``'s rows of two runs: byte-identical rows counted, and
    vcf_rows_numerically_equivalent with flip budget 0 checked."""
    from clair3_tpu_torch.testing import vcf_rows_numerically_equivalent

    a, b = _rows(os.path.join(out_a, name)), _rows(os.path.join(out_b, name))
    ok, stats = vcf_rows_numerically_equivalent(a, b, flip_budget=0.0)
    print(f"[{tag}] {label} {name}: {len(set(a) & set(b))}/{len(a)} rows byte-identical "
          f"({len(b)} rows); max dQUAL {stats['max_dqual']:.2f}, max dGQ {stats['max_dgq']}, "
          f"max dPL {stats['max_dpl']}, flips {stats['flips']}")
    check(len(a) > 50, f"{label} {name}: too few rows")
    check(ok, f"{label} {name}: {stats['violations']}")


def phase6_ont(torch, work):
    """The simulated ONT region at bf16 and f32 (the dwell channel from the
    BAM's mv tags); returns the bf16 call's counts."""
    import numpy as np

    from clair3_tpu_torch.pipeline.engine import InferenceEngine
    from clair3_tpu_torch.testing import simulate, trained_fixture_path

    t0 = time.time()
    os.makedirs(os.path.join(work, "ont"))
    fasta, bam, _, variants = simulate(os.path.join(work, "ont"), ONT_EVAL_BP, seed=EVAL_SEED,
                                       platform="ont")
    print(f"[phase6] simulated ONT {ONT_EVAL_BP} bp, {len(variants)} variants in "
          f"{time.time() - t0:.2f} s")
    predict_async = InferenceEngine.predict_async
    fa_batches = []

    def recording(self, x):
        if x.ndim == 4:  # a full-alignment batch: (shape, |dwell channel| summed)
            fa_batches.append((x.shape[1:], int(np.abs(x[..., -1].astype(np.int64)).sum())))
        return predict_async(self, x)

    outs, result = {}, None
    for flag in ("bf16", "fp32"):
        out = os.path.join(work, f"ont_{flag}")
        argv = ["call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out,
                "--pileup_model", trained_fixture_path("pileup_ont.npz"),
                "--full_alignment_model", trained_fixture_path("fa_ont.npz"),
                "--device", DEVICE, "--compute_dtype", flag, *ONT_CALL_ARGS]
        del fa_batches[:]
        InferenceEngine.predict_async = recording
        try:
            r = counted_call(torch, "phase6", f"ont {flag}", argv)
        finally:
            InferenceEngine.predict_async = predict_async
        outs[flag] = out
        fa_rows, m = score(out, variants)
        dwell = sum(d for _, d in fa_batches)
        print(f"[phase6] ont {flag}: wall {r['wall']:.2f} s, pileup kernel calls {r['calls']} "
              f"(launches {r['kernels']}), plain pileup forwards on the card {r['plain']}, "
              f"FA rows {fa_rows}, FA batches {len(fa_batches)} of "
              f"{sorted({tuple(s) for s, _ in fa_batches})}, |dwell channel| {dwell}, "
              f"{f1_text(m)}")
        check_pileup_route(torch, f"ont {flag}", r, flag)
        check(fa_rows > 10, f"ont {flag}: FA stage never engaged ({fa_rows} rows)")
        check(fa_batches and all(tuple(s) == (89, 33, 9) for s, _ in fa_batches),
              f"ont {flag}: FA batches {fa_batches[:3]}")
        check(dwell > 0, f"ont {flag}: the dwell channel is empty")
        if flag == "bf16":
            check(m["SNP"].f1 >= GATE_ONT_SNP_F1, f"ont: SNP F1 {m['SNP'].f1}")
            check(m["INDEL"].f1 >= GATE_ONT_INDEL_F1, f"ont: INDEL F1 {m['INDEL'].f1}")
            result = r
    for name in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        changed, n, dq = rows_changed(outs["fp32"], outs["bf16"], name)
        print(f"[phase6] ont bf16 vs f32 {name}: {len(changed)}/{n} rows changed call or "
              f"source; max QUAL delta {dq['P']:.2f} on pileup rows, {dq['F']:.2f} on "
              f"full-alignment rows")
    return result


def phase6_pt(torch, work, fasta, bam, variants, base):
    """The hifi nets as the reference's .pt files: the rows of the .npz
    run, and one packing of the pileup operands, whose key every call
    keeps."""
    from clair3_tpu_torch.models import PileupNet
    from clair3_tpu_torch.testing import trained_fixture_path

    models = os.path.join(work, "pt_models")
    os.makedirs(models)
    write_reference_checkpoints(trained_fixture_path("pileup_hifi.npz"),
                                trained_fixture_path("fa_hifi.npz"), models)
    keys = []
    packed_operands = PileupNet.packed_operands

    def recording(self, dtype, device):
        packed = packed_operands(self, dtype, device)
        keys.append(self._packed[0])
        return packed

    out = os.path.join(work, "out_pt")
    PileupNet.packed_operands = recording
    try:
        r = counted_call(torch, "phase6", "pt", hifi_argv(fasta, bam, out, "bf16",
                                                          "--model_path", models))
    finally:
        PileupNet.packed_operands = packed_operands
    fa_rows, m = score(out, variants)
    print(f"[phase6] pt: wall {r['wall']:.2f} s, pileup kernel calls {r['calls']} "
          f"(launches {r['kernels']}), plain pileup forwards on the card {r['plain']}, "
          f"operand packings {r['packs']}, distinct cache keys {len(set(keys))} over "
          f"{len(keys)} forwards, FA rows {fa_rows}, {f1_text(m)}")
    check_pileup_route(torch, "pt", r, "bf16")
    check(r["packs"] == 1 and len(keys) == r["calls"] and len(set(keys)) == 1,
          f"pt: {r['packs']} packings, {len(set(keys))} keys over {len(keys)} forwards")
    check(_rows(os.path.join(out, "pileup.vcf.gz")) == _rows(os.path.join(base, "pileup.vcf.gz")),
          "pt: pileup.vcf.gz rows differ from the .npz run's")
    print("[phase6] pt pileup.vcf.gz: rows byte-identical to the .npz run's")
    rows_equivalent("phase6", "pt vs npz", base, out, "merge_output.vcf.gz")
    check(fa_rows > 10, f"pt: FA stage never engaged ({fa_rows} rows)")
    check(m["SNP"].f1 >= GATE_SNP_F1, f"pt: SNP F1 {m['SNP'].f1}")
    check(m["INDEL"].f1 >= GATE_INDEL_F1, f"pt: INDEL F1 {m['INDEL'].f1}")
    return r


def phase6_serve(torch, work, fasta, bam, base, walls):
    """`call --remote_engines` against build_server(device=cuda) on
    127.0.0.1: the kernels count in the serving engines of this process.
    ``walls``: the local runs' wall times to print beside the remote one."""
    import numpy as np

    from clair3_tpu_torch.serve import build_server
    from clair3_tpu_torch.testing import trained_fixture_path

    server = build_server(None, platform="hifi", compute_dtype="bf16", host="127.0.0.1",
                          port=0, pileup_model=trained_fixture_path("pileup_hifi.npz"),
                          fa_model=trained_fixture_path("fa_hifi.npz"), device=DEVICE)
    for kind, engine in server.engines.items():  # as `serve` warms them
        engine.warmup((33, 18) if kind == "pileup" else (55, 33, 8),
                      np.int32 if kind == "pileup" else np.int8)
    address = server.serve_background()
    out = os.path.join(work, "out_remote")
    try:
        r = counted_call(torch, "phase6", "remote",
                         ["call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out,
                          "--remote_engines", address, *CALL_ARGS])
        stats = server.stats()
    finally:
        server.shutdown()
    local = ", ".join(f"{w:.2f} s {name}" for name, w in walls)
    print(f"[phase6] remote: wall {r['wall']:.2f} s against local bf16 runs {local}; "
          f"pileup kernel calls {r['calls']} (launches {r['kernels']}), "
          f"plain pileup forwards on the card {r['plain']}, server stats {stats}")
    for kind, engine in server.engines.items():
        print_bytes_shipped("phase6", f"served {kind}", engine)
    check_pileup_route(torch, "remote", r, "bf16")
    for name in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        rows_equivalent("phase6", "remote vs local", base, out, name)
    return r, stats


def kernel_time_by_origin(events):
    """Milliseconds of CUDA kernel time in a Chrome trace by (net, origin):
    the net is the engine forward (``PileupNet.forward``, ...) whose span
    holds the launching CPU op, the origin that op's name, or the kernel's
    own name where no op launched it (the port's kernels)."""
    ops, spans = {}, []
    for e in events:
        if e.get("cat") == "cpu_op":
            ops[e.get("args", {}).get("External id")] = e
        elif e.get("cat") == "user_annotation" and e.get("name", "").endswith(".forward"):
            spans.append(e)

    def net_of(op):
        for sp in spans:
            if sp["tid"] == op["tid"] and sp["ts"] <= op["ts"] <= sp["ts"] + sp["dur"]:
                return sp["name"].split(".")[0]
        return "outside the nets"

    out = {}
    for k in events:
        if k.get("cat") != "kernel":
            continue
        op = ops.get(k.get("args", {}).get("External id"))
        name = re.sub(r"^void |\(anonymous namespace\)::", "", k["name"])
        key = ((net_of(op), op["name"]) if op is not None else
               ("-", re.sub(r"<.*", "", name.split("(")[0])))
        out[key] = out.get(key, 0.0) + k["dur"] / 1e3
    return out


def phase6_profile(torch, work, fasta, bam, warm_wall):
    """A warm hifi call with --profile_dir: the trace's CUDA kernel events,
    L1, L2 and L3 among them, and the device-busy share (summed kernel time
    over the call's wall time, and over ``warm_wall``, an unprofiled warm
    run of the same call)."""
    trace_dir = os.path.join(work, "trace")
    r = counted_call(torch, "phase6", "profile",
                     hifi_argv(fasta, bam, os.path.join(work, "out_profile"), "bf16")
                     + ["--profile_dir", trace_dir])
    with open(os.path.join(trace_dir, "call.pt.trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = sum(e["dur"] for e in kernels) / 1e3
    share = busy_ms / 1e3 / warm_wall
    counts = {k: sum(1 for e in kernels if k + "_kernel" in e["name"])
              for k in ("pileup_l1_tc", "pileup_l2_tc", "pileup_head")}
    print(f"[phase6] profile: wall {r['wall']:.2f} s profiled, {len(kernels)} kernel events, "
          f"summed kernel time {busy_ms:.3f} ms: device busy "
          f"{100 * busy_ms / 1e3 / r['wall']:.2f}% of the profiled wall, "
          f"{100 * share:.2f}% of the unprofiled warm run's {warm_wall:.2f} s; "
          f"pileup kernel events {counts} against launches {r['kernels']}")
    by_origin = sorted(kernel_time_by_origin(events).items(), key=lambda kv: -kv[1])
    for (net, origin), ms in by_origin[:12]:
        print(f"[phase6] profile kernel time {ms:8.3f} ms ({100 * ms / busy_ms:5.1f}% of busy) "
              f"{net:17s} {origin[:70]}")
    check_pileup_route(torch, "profile", r, "bf16")
    check(all(counts.values()), f"profile: no L1/L2/L3 kernel events in the trace ({counts})")
    return r, share


def phase6_surface(torch, work, fasta, bam, variants, base):
    """The rest of the inference surface on the card: ONT with the dwell
    channel, .pt checkpoints, a served engine behind --remote_engines and a
    --profile_dir trace.  ``base`` is phase 3's bf16 run (None: run it)."""
    if base is None:
        out = os.path.join(work, "out_bf16")
        r = counted_call(torch, "phase6", "bf16", hifi_argv(fasta, bam, out, "bf16"))
        check_pileup_route(torch, "bf16", r, "bf16")
        base = {"out": out, "wall": r["wall"]}
    result = {"ont": phase6_ont(torch, work)}
    result["pt"] = phase6_pt(torch, work, fasta, bam, variants, base["out"])
    warm = result["pt"]["wall"]  # a warm local bf16 run of the same region
    result["remote"], result["server"] = phase6_serve(
        torch, work, fasta, bam, base["out"],
        (("(first of the process, .npz)", base["wall"]), ("(warm, .pt)", warm)))
    result["profile"], result["busy"] = phase6_profile(torch, work, fasta, bam, warm)
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
    rand_net = FullAlignmentNet(input_channels=8).eval()
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


def module_twin(torch, mod, x):
    """BiLSTM(use_kernel=True)'s route with the kernel's plain twin: the same
    addmm, then the batch-major twin."""
    from clair3_tpu_torch.ops import bilstm as k2

    B, T, C = x.shape
    dt = x.dtype
    wi = mod.wi.to(dt)
    xw = torch.addmm(mod.b.to(dt).reshape(-1), x.reshape(B * T, C),
                     torch.cat([wi[0], wi[1]], dim=1))
    return k2.bilstm_batch_major_reference(xw.view(B, T, -1), mod.wh.to(dt))


def phase5_bilstm(torch):
    import numpy as np

    from clair3_tpu_torch.ops import bilstm as k2
    from clair3_tpu_torch.ops.lstm import BiLSTM, bilstm

    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(51)
    worst, timing = {}, {}
    layouts = (("tpu", k2.bilstm_recurrence, k2.bilstm_recurrence_reference),
               ("batch-major", k2.bilstm_batch_major, k2.bilstm_batch_major_reference))
    for C, H in K2_SHAPES:
        wh32 = torch.from_numpy((rng.randn(2, H, 4 * H) * 0.1).astype(np.float32)).to(DEVICE)
        for B in sorted(set(K2_BATCHES + TIME_BATCHES)):
            xw32 = torch.from_numpy(rng.randn(33, 2, B, 4 * H).astype(np.float32)).to(DEVICE)
            inputs = {"tpu": xw32, "batch-major": xw32.view(33, B, 8 * H).transpose(0, 1)
                      .contiguous()}
            for dt, tol in ((f32, K2_F32_TOL), (bf16, K2_BF16_TOL)):
                wh = wh32.to(dt)
                for layout, kernel, twin in layouts:
                    xw = inputs[layout].to(dt)
                    if B in K2_BATCHES:
                        got = kernel(xw, wh)
                        torch.cuda.synchronize()
                        want = twin(xw, wh)
                        check(got.shape == want.shape and bool(torch.isfinite(got.float()).all()),
                              f"bilstm {layout} H={H} B={B} {dt}: shape or non-finite output")
                        err = (got.float() - want.float()).abs().max().item()
                        print(f"[phase5] C={C:3d} H={H} B={B:5d} {str(dt):14s} {layout:11s} "
                              f"kernel vs twin max |d| {err:.3g}")
                        check(err <= tol, f"bilstm {layout} H={H} B={B} {dt}: {err}")
                        worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
                    if B in TIME_BATCHES:
                        y = kernel(xw, wh)
                        k = cuda_ms(torch, lambda: kernel(xw, wh), 10)
                        p = cuda_ms(torch, lambda: twin(xw, wh), 3)
                        b_ms, by = bound(2 * 33 * 2 * B * H * 4 * H, nbytes(xw, wh, y), dt)
                        timing[(layout, H, B, str(dt))] = (k, p, b_ms, by)
                        print(f"[phase5] time C={C:3d} H={H} B={B:5d} {str(dt):14s} {layout:11s} "
                              f"kernel {k:.4f} ms, plain {p:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                              f"kernel at {100 * b_ms / k:.1f}% of the bound")

    # the kernel's module path: BiLSTM(use_kernel=True) at both layer shapes,
    # f32 (SIMT route) and bf16 (tensor-core route)
    mods = []
    for C, H in K2_SHAPES:
        mod = BiLSTM(C, H, use_kernel=True)
        with torch.no_grad():
            for p, scale in ((mod.wi, 1 / np.sqrt(C)), (mod.wh, 0.1), (mod.b, 0.1)):
                p.copy_(torch.from_numpy(rng.randn(*p.shape) * scale))
        x = torch.from_numpy(rng.randn(1000, 33, C).astype(np.float32)).to(DEVICE)
        mods.append((mod.to(DEVICE), x))
    runs = [(mod, x, f32) for mod, x in mods] + [
        (copy.deepcopy(mod).to(bf16), x.to(bf16), bf16) for mod, x in mods]
    k2.launches = 0
    with torch.inference_mode():
        outs = [mod(x) for mod, x, _ in runs]
        torch.cuda.synchronize()
        launches = k2.launches
        for (mod, x, dt), got in zip(runs, outs):
            if dt == f32:
                err = (got - bilstm(x, mod.wi, mod.wh, mod.b)).abs().max().item()
                tol, what = K2_F32_TOL, "plain bilstm"
            else:
                err = (got.float() - module_twin(torch, mod, x).float()).abs().max().item()
                tol, what = K2_BF16_TOL, "its twin"
            print(f"[phase5] BiLSTM(use_kernel=True) C={mod.wi.shape[1]} H={mod.wh.shape[1]} "
                  f"B=1000 {str(dt):14s} vs {what} max |d| {err:.3g}")
            check(err <= tol, f"BiLSTM kernel route {dt}: {err}")
    print(f"[phase5] BiLSTM(use_kernel=True) runs: bilstm kernel launches {launches}")
    check(launches == len(runs), f"the BiLSTM module path launched the kernel {launches} times")

    # the library call: torch.nn.LSTM(bidirectional=True) (cuDNN) with the
    # module's weights, timed against the module (its addmm + K2)
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


def time_train_steps(torch, net, opt, x, y, generator, add_indel_length, warm=5, iters=20):
    """Median ms of one training step on the card (CUDA events), split into
    forward + loss, backward and the AdamW step, after ``warm`` steps."""
    from clair3_tpu_torch.train.step import batch_loss

    net.train()
    parts = []
    for i in range(warm + iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = batch_loss(net, x, y, generator, add_indel_length)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        if i >= warm:
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    med = [sorted(p[j] for p in parts)[len(parts) // 2] for j in range(3)]
    return {"forward_ms": med[0], "backward_ms": med[1], "adamw_ms": med[2],
            "step_ms": sum(med), "samples_per_s": len(x) / (sum(med) / 1e3)}


def phase7_step_times(torch, setup, cfgs):
    """Each net's training step at the demo's batch, and the pileup net's at
    TrainConfig's default batch of 2000, on fresh nets started as the
    trainer starts them."""
    from clair3_tpu_torch.models.init import init_weights
    from clair3_tpu_torch.train.step import make_optimizer
    from clair3_tpu_torch.train.trainer import build_model

    times = {}
    for kind, batch in (("pileup", setup.batch["pileup"]), ("pileup", 2000),
                        ("fa", setup.batch["fa"])):
        cfg, data = cfgs[kind], setup.datasets[kind]
        x, y = next(data.batches(data.chunks, max(1, batch // cfg.chunk_size)))
        x = torch.from_numpy(x[:batch]).to(DEVICE)
        y = torch.from_numpy(y[:batch]).to(DEVICE)
        net = build_model(cfg, x.shape[-1])
        init_weights(net, torch.Generator().manual_seed(cfg.seed))
        net.to(DEVICE)
        opt = make_optimizer(net, cfg.learning_rate, cfg.weight_decay)
        gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
        t = time_train_steps(torch, net, opt, x, y, gen, cfg.add_indel_length)
        times[(kind, len(x))] = t
        print(f"[phase7] {kind} train step B={len(x)} f32: {t['step_ms']:.3f} ms "
              f"(forward + loss {t['forward_ms']:.3f}, backward {t['backward_ms']:.3f}, "
              f"AdamW {t['adamw_ms']:.3f}), {t['samples_per_s']:.0f} samples/s "
              f"(median of 20 after 5 warm steps, CUDA events)")
    return times


def phase7_cli(torch, work, setup):
    """``tensor2bin`` then ``train --device cuda`` through the port's CLI on
    the demo's training region (one epoch at the CLI's defaults)."""
    from clair3_tpu_torch.cli import main as port_main
    from clair3_tpu_torch.io.vcf import VcfRecord, VcfWriter, get_header

    truth = os.path.join(work, "truth.vcf")
    with VcfWriter(truth, get_header(contigs=[("chr1", setup.L)])) as w:
        for v in setup.variants:
            w.write(VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                              "1/1" if v.genotype == (1, 1) else "0/1"))
    bin_fn, out = os.path.join(work, "cli_pileup.bin"), os.path.join(work, "cli_model")
    t0 = time.time()
    check(port_main(["tensor2bin", "--bam_fn", setup.bam, "--ref_fn", setup.fasta,
                     "--truth_vcf_fn", truth, "--bin_fn", bin_fn, "--platform", "hifi",
                     "--ctg_end", str(setup.train_end), "--pileup", "--snp_min_af", "0.08",
                     "--indel_min_af", "0.12", "--maximum_non_variant_ratio", "5"]) == 0,
          "tensor2bin failed")
    t1 = time.time()
    check(port_main(["train", "--bin_fn", bin_fn, "--output_dir", out, "--platform", "hifi",
                     "--pileup", "--max_epoch", "1", "--device", DEVICE]) == 0, "train failed")
    torch.cuda.synchronize()
    check(os.path.exists(os.path.join(out, "best_val_loss.npz")), "train wrote no checkpoint")
    print(f"[phase7] CLI: tensor2bin {t1 - t0:.2f} s, train --device {DEVICE} (one epoch) "
          f"{time.time() - t1:.2f} s")


def phase7_training(torch, work):
    """Training on the card: the port's full-cascade demo at its defaults
    (hifi geometry) trains both nets on the card at f32, then calls the
    held-out region with them through the production loader at bf16 (the
    pileup kernels, counted) and at f32, and scores it against the demo's
    gates."""
    import math

    from clair3_tpu_torch import full_cascade_demo as demo
    from clair3_tpu_torch.cli import load_model
    from clair3_tpu_torch.train import trainer

    t0 = time.time()
    setup = demo.prepare(os.path.join(work, "demo"), "hifi")
    print(f"[phase7] simulated {setup.L} bp ({len(setup.variants)} variants) and built the "
          f"training data ({'HDF5 bins' if setup.bins else 'in memory: no h5py here'}) in "
          f"{time.time() - t0:.2f} s")
    if setup.bins:
        phase7_cli(torch, work, setup)
    cfgs = demo.train_configs(setup)
    times = phase7_step_times(torch, setup, cfgs)

    # cuDNN's deterministic algorithms, so one seed gives one trained net
    # and one F1 on every run of this check
    torch.backends.cudnn.deterministic = True
    print("[phase7] training and calling with cudnn.deterministic=True")
    seen = {"params": set(), "batches": set(), "steps": 0}
    step = trainer.train_step

    def recording(net, opt, x, y, *args):
        seen["params"].update(p.device.type for p in net.parameters())
        seen["batches"].update((x.device.type, y.device.type))
        seen["steps"] += 1
        return step(net, opt, x, y, *args)

    trainer.train_step = recording
    try:
        results = demo.train_nets(setup, torch.device(DEVICE))
    finally:
        trainer.train_step = step
    torch.cuda.synchronize()
    print(f"[phase7] {seen['steps']} training steps; parameters on {sorted(seen['params'])}, "
          f"batches on {sorted(seen['batches'])}")
    check(seen["params"] == {DEVICE} and seen["batches"] == {DEVICE},
          "a training step ran off the card")
    check(0 < seen["steps"] <= sum(setup.steps.values()), "training steps out of range")
    for kind, r in results.items():
        print(f"[phase7] {kind}: trained in {r['wall']:.2f} s (wall), {r['epochs']} epochs, "
              f"best_val_loss {r['best_val_loss']:.6f}, last (epoch, mini-epoch, train "
              f"loss, val loss) {r['history'][-1]}")
        check(math.isfinite(r["best_val_loss"]), f"{kind}: best_val_loss is not finite")
        net = load_model(r["model_path"], "pileup" if kind == "pileup" else "full_alignment",
                         torch.device(DEVICE), torch.bfloat16)
        check(not net.training, f"{kind}: load_model returned a net in training mode")

    gates = demo.gates(setup)
    scores = {}
    for flag in ("bf16", "fp32"):
        zero_kernel_counts()
        t1 = time.time()
        outs = demo.call_held_out(setup, results["pileup"]["model_path"],
                                  results["fa"]["model_path"], torch.device(DEVICE), flag,
                                  tag=f"out_{flag}")
        torch.cuda.synchronize()
        wall = time.time() - t1
        r = kernel_counts()
        fa_rows, m = demo.score(setup, outs)
        print(f"[phase7] held-out call {flag}: wall {wall:.2f} s, pileup kernel calls "
              f"{r['calls']} (launches {r['kernels']}), plain pileup forwards on the card "
              f"{r['plain']}, FA rows {fa_rows}, {f1_text(m)}")
        demo.print_metrics(m)
        check_pileup_route(torch, f"phase7 {flag}", r, flag)
        check(fa_rows > 10, f"phase7 {flag}: FA stage never engaged ({fa_rows} rows)")
        scores[flag] = (m, r)
    torch.backends.cudnn.deterministic = False
    m16 = scores["bf16"][0]
    print(f"[phase7] the demo's gates at this scale: SNP F1 {gates[0]} "
          f"{'met' if m16['SNP'].f1 >= gates[0] else 'missed'}, INDEL F1 {gates[1]} "
          f"{'met' if m16['INDEL'].f1 >= gates[1] else 'missed'} (the JAX demo's INDEL F1 "
          f"over training seeds 0-4 on the CPU: {JAX_DEMO_INDEL_F1}); checked: SNP F1 >= "
          f"{gates[0]}, INDEL F1 >= {GATE_TRAINED_INDEL_F1} (the lowest of those)")
    check(m16["SNP"].f1 >= gates[0], f"phase7 bf16: SNP F1 {m16['SNP'].f1} (gate {gates[0]})")
    check(m16["INDEL"].f1 >= GATE_TRAINED_INDEL_F1,
          f"phase7 bf16: INDEL F1 {m16['INDEL'].f1} (gate {GATE_TRAINED_INDEL_F1})")
    return {"times": times, "results": results, "scores": scores}


# a child process of phase 8: the port's CLI (``-m clair3_tpu_torch``) or a
# script, then the names of the JAX package's modules it loaded (none may be)
PHASE8_CHILD = """
import runpy
import sys

target, args = sys.argv[1], sys.argv[2:]
sys.argv = [target] + args
try:
    if target.endswith(".py"):
        runpy.run_path(target, run_name="__main__")
    else:
        runpy.run_module(target, run_name="__main__")
    rc = 0
except SystemExit as exc:
    rc = exc.code or 0
blocked = ("jax", "jaxlib", "flax", "optax", "clair3_tpu")
print(f"[child] loaded {sorted(m for m in sys.modules if m.split('.')[0] in blocked)}",
      flush=True)
sys.exit(rc)
"""
PHASE8_TIMEOUT_S = 600


def spawn_child(work, tag, target, args, own_peak_rss=False):
    """``target`` (a module or a script) with ``args`` in an OS process of
    its own, its output to ``{work}/{tag}.log``; returns (process, log
    path, start time).  A process exec'd straight from this one reports
    this process's peak RSS as its own (Linux keeps the larger across
    exec); with ``own_peak_rss`` a shell forks it, so its peak RSS is its
    own, as when a user starts it; the shell then leads a process group
    of its own, so ``os.killpg`` stops both."""
    log_path = os.path.join(work, f"{tag}.log")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-c", PHASE8_CHILD, target, *args]
    if own_peak_rss:
        argv = ["bash", "-c", '"$@"; exit $?', "child", *argv]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, env=env,
                                start_new_session=own_peak_rss)
    return proc, log_path, time.time()


def wait_children(children, phase="phase 8", timeout=PHASE8_TIMEOUT_S):
    """Each child's wall time (spawn to exit) once every one has exited 0,
    with its log; a child still running at the time limit is killed, and so
    is every other when one fails."""
    walls, deadline = {}, time.time() + timeout
    try:
        while len(walls) < len(children):
            for tag, (proc, _, t0) in children.items():
                if tag not in walls and proc.poll() is not None:
                    walls[tag] = time.time() - t0
                    check(proc.returncode == 0, f"{phase} {tag} exited {proc.returncode}:\n"
                          + open(children[tag][1]).read()[-4000:])
            check(time.time() < deadline, f"{phase}: {sorted(set(children) - set(walls))} "
                  f"still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for proc, _, _ in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {tag: (walls[tag], open(children[tag][1]).read()) for tag in children}


def child_report(tag, log):
    """What a phase-8 child's log says: its pileup kernels' launches, its
    gather's times, and that it loaded nothing of jax or clair3_tpu."""
    kernels = [json.loads(line.split(" ", 1)[1]) for line in log.splitlines()
               if line.startswith("[kernels] ")]
    check(len(kernels) == 1, f"phase 8 {tag}: {len(kernels)} [kernels] lines")
    k = kernels[0]
    check(k["pileup_l1_tc"] > 0 and k["pileup_l1_tc"] == k["pileup_l2_tc"] == k["pileup_head"],
          f"phase 8 {tag}: L1/L2/L3 launches {k}")
    check(k["pileup_full"] == 0, f"phase 8 {tag}: the SIMT pileup kernel launched {k}")
    check("[child] loaded []" in log, f"phase 8 {tag}: loaded jax or clair3_tpu")
    gather = re.search(r"barrier ([0-9.]+) ms, all_gather ([0-9.]+) ms", log)
    for line in log.splitlines():
        if line.startswith(("[plan]", "[select]", "[gather]", "[timing]")):
            print(f"[phase8] {tag} {line}")
    return k, gather and (float(gather.group(1)), float(gather.group(2)))


def phase8_multiprocess(torch, work, fasta, bam, variants, smi):
    """Multi-process calling on the card: one bf16 `call --gvcf` on the
    phase-3 region, then two `--dist_*` processes sharing cuda:0, merged by
    the port's `sort_vcf` and `sort_vcf --gvcf`, then one
    run_clair3_tpu_torch.py call with the reference's spellings; every
    child an OS process of its own."""
    from clair3_tpu_torch import cli as port_cli
    from clair3_tpu_torch.testing import trained_fixture_path

    # four chunks, so that each process of the pair owns two
    chunking = ["--chunk_size", str(EVAL_BP // 4)]
    args = ["--bam_fn", bam, "--ref_fn", fasta, "--device", DEVICE, "--compute_dtype", "bf16",
            "--gvcf", *chunking, *CALL_ARGS]
    models = ["--pileup_model", trained_fixture_path("pileup_hifi.npz"),
              "--full_alignment_model", trained_fixture_path("fa_hifi.npz")]
    single, dist_dir = os.path.join(work, "p8_single"), os.path.join(work, "p8_dist")
    ran = wait_children({"single": spawn_child(
        work, "p8_single", "clair3_tpu_torch", ["call", *args, *models, "--output", single])})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    ran.update(wait_children({f"proc{i}": spawn_child(
        work, f"p8_proc{i}", "clair3_tpu_torch",
        ["call", *args, *models, "--output", dist_dir, "--dist_coordinator", f"127.0.0.1:{port}",
         "--dist_num_processes", "2", "--dist_process_id", str(i)]) for i in range(2)}))
    pair_wall = time.time() - t0
    model_dir = os.path.join(work, "p8_models")
    os.makedirs(model_dir)
    os.symlink(trained_fixture_path("pileup_hifi.npz"), os.path.join(model_dir, "pileup.npz"))
    os.symlink(trained_fixture_path("fa_hifi.npz"), os.path.join(model_dir, "full_alignment.npz"))
    entry = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run_clair3_tpu_torch.py")
    ref_out = os.path.join(work, "p8_run_clair3")
    ran.update(wait_children({"run_clair3_tpu_torch.py": spawn_child(
        work, "p8_run_clair3", entry,
        ["--bam_fn", bam, "--ref_fn", fasta, "--output", ref_out, "--model_path", model_dir,
         "--ctgName", "chr1", "--sampleName", "SAMPLE", "--fast_mode", "False",
         "--device", DEVICE, "--compute_dtype", "bf16", "--gvcf", *chunking,
         *({"--threads": "--threads_num"}.get(a, a) for a in CALL_ARGS)])}))

    launches, gathers = {}, {}
    for tag, (wall, log) in ran.items():
        launches[tag], gathers[tag] = child_report(tag, log)
        print(f"[phase8] {tag}: wall {wall:.3f} s ({smi}); pileup launches {launches[tag]}")
    print(f"[phase8] pair of processes: wall {pair_wall:.3f} s against the single process's "
          f"{ran['single'][0]:.3f} s ({smi})")
    for tag in ("proc0", "proc1"):
        check(gathers[tag] is not None, f"phase 8 {tag}: no [gather] line")
        print(f"[phase8] {tag} gather: barrier {gathers[tag][0]:.3f} ms, all_gather "
              f"{gathers[tag][1]:.3f} ms ({smi})")

    merged = os.path.join(work, "p8_merged")
    os.makedirs(merged)
    for name, extra in (("merge_output.vcf.gz", []), ("merge_output.gvcf.gz", ["--gvcf"])):
        shards = [os.path.join(dist_dir, f"proc{i}", name) for i in range(2)]
        check(all(_rows(s) for s in shards), f"phase 8: a process wrote no {name} rows")
        check(port_cli.main(["sort_vcf", "--input_fn", *shards, "--output_fn",
                             os.path.join(merged, name), "--ref_fn", fasta, *extra]) == 0,
              f"sort_vcf {name}")
        with gzip.open(os.path.join(merged, name), "rt") as a, \
                gzip.open(os.path.join(single, name), "rt") as b:
            print(f"[phase8] merged {name} byte-identical to the single process's: "
                  f"{a.read() == b.read()}")
        rows_equivalent("phase8", "merged vs single", single, merged, name)
        rows_equivalent("phase8", "run_clair3_tpu_torch.py vs single", single, ref_out, name)
    check(port_cli.main(["validate_gvcf", "--gvcf_fn",
                         os.path.join(merged, "merge_output.gvcf.gz")]) == 0,
          "validate_gvcf failed on the merged gVCF")
    pair = {k: launches["proc0"][k] + launches["proc1"][k] for k in launches["proc0"]}
    print(f"[phase8] pileup launches of the pair: {pair}")
    phase8_genotyping_and_final_phasing(work, args + models, fasta, variants, smi)
    return {"walls": {tag: wall for tag, (wall, _) in ran.items()}, "pair_wall": pair_wall,
            "gathers": gathers, "launches": launches}


def bam_tags(path):
    """(name, flag, position, HP, PS) of every read of a BAM."""
    from clair3_tpu_torch.io.bam import BamReader

    return sorted((r.qname, r.flag, r.pos, r.tags.get("HP"), r.tags.get("PS"))
                  for r in BamReader(path))


def phase8_genotyping_and_final_phasing(work, argv, fasta, variants, smi):
    """Genotyping mode (`--vcf_fn` of the region's simulated variants) and
    final phasing with haplotagging, each as one process and as a pair of
    `--dist_*` processes on cuda:0, all three started together; the pair's
    files merged by `sort_vcf` against the single process's."""
    from clair3_tpu_torch import cli as port_cli
    from clair3_tpu_torch.io.vcf import VcfRecord, VcfWriter, get_header

    known = os.path.join(work, "p8_known.vcf")
    with VcfWriter(known, get_header(contigs=[("chr1", EVAL_BP)])) as w:
        for v in variants:
            w.write(VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                              "1/1" if v.genotype == (1, 1) else "0/1"))
    runs = {"genotyping": (["--vcf_fn", known], ["merge_output.vcf.gz", "merge_output.gvcf.gz"]),
            "final_phasing": (["--use_phasing_for_final_output",
                               "--use_haplotagging_for_final_output"],
                              ["phased_merge_output.vcf.gz"])}
    for mode, (extra, names) in runs.items():
        single, dist_dir = os.path.join(work, f"p8_{mode}"), os.path.join(work, f"p8_{mode}_dist")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        children = {"single": spawn_child(work, f"p8_{mode}_single", "clair3_tpu_torch",
                                          ["call", *argv, *extra, "--output", single])}
        children.update({f"proc{i}": spawn_child(
            work, f"p8_{mode}_proc{i}", "clair3_tpu_torch",
            ["call", *argv, *extra, "--output", dist_dir, "--dist_coordinator",
             f"127.0.0.1:{port}", "--dist_num_processes", "2", "--dist_process_id", str(i)])
            for i in range(2)})
        for tag, (wall, log) in wait_children(children).items():
            print(f"[phase8] {mode} {tag}: wall {wall:.3f} s ({smi}); pileup launches "
                  f"{child_report(f'{mode} {tag}', log)[0]}")
        merged = os.path.join(work, f"p8_{mode}_merged")
        os.makedirs(merged)
        for name in names:
            shards = [os.path.join(dist_dir, f"proc{i}", name) for i in range(2)]
            check(port_cli.main(["sort_vcf", "--input_fn", *shards, "--output_fn",
                                 os.path.join(merged, name), "--ref_fn", fasta,
                                 *(["--gvcf"] if "gvcf" in name else [])]) == 0,
                  f"sort_vcf {mode} {name}")
            with gzip.open(os.path.join(merged, name), "rt") as a, \
                    gzip.open(os.path.join(single, name), "rt") as b:
                print(f"[phase8] {mode}: merged {name} byte-identical to the single process's: "
                      f"{a.read() == b.read()}")
            rows_equivalent("phase8", f"{mode} merged vs single", single, merged, name)
        if mode == "genotyping":
            # a known site not called is written as ./. (postprocess.py)
            added = [r for r in _rows(os.path.join(merged, "merge_output.vcf.gz"))
                     if r.split("\t")[4] == "." and r.rstrip("\n").endswith("\t./.")]
            print(f"[phase8] genotyping: {len(variants)} known sites, {len(added)} added back "
                  "as ./. in the merged VCF")
        else:
            check(not os.path.exists(os.path.join(dist_dir, "proc1", "phased_output.bam")),
                  "phase 8: process 1 wrote a haplotagged BAM")
            want = bam_tags(os.path.join(single, "phased_output.bam"))
            got = bam_tags(os.path.join(dist_dir, "proc0", "phased_output.bam"))
            print(f"[phase8] final_phasing: process 0's phased_output.bam, {len(got)} reads, "
                  f"{sum(t[3] is not None for t in got)} tagged, HP/PS equal to the single "
                  f"process's: {got == want}")
            check(got == want, "phase 8: process 0's HP/PS tags differ from one process's")


# one rank of phase 9, started by torchrun: `fit` on the arrays of each net
# named in the JSON argument as rank RANK of the group torchrun describes
# (`parallel/mesh.py::run_ranks`); writes each net's history and state to
# {out}.{net}.{rank}.npz and, with "time", the step times to {out}.times.json
PHASE9_RANK = """
import json
import sys

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

from clair3_tpu_torch.parallel.mesh import run_ranks

args = json.loads(sys.argv[1])


def rank(device):
    import torch.distributed as dist

    import chip_smoke
    from clair3_tpu_torch.train import trainer

    nets, replicate = [], trainer.replicate

    def recording(net, dev):
        nets.append(net)
        return replicate(net, dev)

    trainer.replicate = recording
    r = dist.get_rank()
    for name, spec in args["nets"].items():
        hist, state = chip_smoke.phase9_fit(spec, device, data_parallel=True)
        on_card = all(p.device == device for p in nets[-1].parameters())
        np.savez(f"{args['out']}.{name}.{r}.npz", history=hist, on_card=on_card,
                 backend=dist.get_backend(), world=dist.get_world_size(), **state)
    if args.get("time") and r == 0:
        with open(f"{args['out']}.times.json", "w") as fh:
            json.dump(chip_smoke.phase9_step_times(torch, args["nets"], device), fh)
    blocked = ("jax", "jaxlib", "flax", "optax", "clair3_tpu")
    print(f"[rank {r}] loaded {sorted(m for m in sys.modules if m.split('.')[0] in blocked)}",
          flush=True)


run_ranks(rank, torch.device(args["device"]), backend=args.get("backend"))
"""
PHASE9_TIMEOUT_S = 600
# the demo's training geometry (full_cascade_demo.train_configs): chunks of
# 100 rows, batches of 1000 pileup and 500 FA rows
PHASE9_NETS = {
    "pileup": dict(pileup=True, add_indel_length=False, batch_size=1000, chunk_size_pileup=100,
                   seed=0),
    "fa": dict(pileup=False, add_indel_length=True, batch_size=500, chunk_size_fa=100, seed=0),
}


def phase9_rows(kind, n, seed):
    """``n`` seeded rows of ``kind``'s tensors and one-hot labels."""
    import numpy as np

    from clair3_tpu_torch.config import LABEL_SHAPE

    rng = np.random.RandomState(seed)
    if kind == "pileup":
        x = rng.randint(-30, 30, (n, 33, 18)).astype(np.int32)
    else:
        x = rng.randint(-100, 101, (n, 55, 33, 8)).astype(np.int8)
    y, start = np.zeros((n, sum(LABEL_SHAPE)), np.float32), 0
    for size in LABEL_SHAPE:
        y[np.arange(n), start + rng.randint(0, size, n)] = 1.0
        start += size
    return x, y


def phase9_fit(spec, device, data_parallel=False):
    """``trainer.fit`` from memory on one spec of phase 9; returns its
    history and the trained net's state, on the host."""
    import numpy as np

    from clair3_tpu_torch.config import TrainConfig
    from clair3_tpu_torch.testing import ArrayDataset
    from clair3_tpu_torch.train import trainer

    nets, build = [], trainer.build_model
    trainer.build_model = lambda *a: nets.append(build(*a)) or nets[-1]
    try:
        with np.load(spec["data"]) as z:
            data = ArrayDataset([z["x"]], [z["y"]], chunk_size=spec["cfg"]["chunk_size_" + (
                "pileup" if spec["cfg"]["pileup"] else "fa")])
        r = trainer.fit(data, spec["out_dir"], TrainConfig(**spec["cfg"]),
                        max_steps=spec["steps"], device=device, data_parallel=data_parallel)
    finally:
        trainer.build_model = build
    return (np.array(r["history"], np.float64),
            {k: v.cpu().numpy() for k, v in nets[-1].state_dict().items()})


def phase9_step_times(torch, specs, device):
    """Each net's step at its batch, plain and as the one rank of the
    joined group (``train/step.py::replicate``), on fresh nets started as
    the trainer starts them: ``time_train_steps`` of each, in turns (plain,
    DDP, DDP, plain), since a launch-bound step moves with the host."""
    import numpy as np

    from clair3_tpu_torch.config import TrainConfig
    from clair3_tpu_torch.models.init import init_weights
    from clair3_tpu_torch.train.step import make_optimizer, replicate
    from clair3_tpu_torch.train.trainer import build_model

    out = {}
    for name in ("pileup", "fa"):
        cfg = TrainConfig(**specs[name]["cfg"])
        with np.load(specs[name]["data"]) as z:
            x = torch.from_numpy(z["x"][:cfg.batch_size]).to(device)
            y = torch.from_numpy(z["y"][:cfg.batch_size]).to(device)
        runs = {}
        for route in ("plain", "ddp"):
            net = build_model(cfg, x.shape[-1])
            init_weights(net, torch.Generator().manual_seed(cfg.seed))
            net.to(device)
            opt = make_optimizer(net, cfg.learning_rate, cfg.weight_decay)
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
            runs[route] = (replicate(net, device) if route == "ddp" else net, opt, gen)
        for route in ("plain", "ddp", "ddp", "plain"):
            model, opt, gen = runs[route]
            out.setdefault(f"{name} {route}", []).append(time_train_steps(
                torch, model, opt, x, y, gen, cfg.add_indel_length))
    return out


def run_torchrun(work, tag, nproc, args):
    """PHASE9_RANK on ``nproc`` ranks under ``python -m torch.distributed.run
    --standalone`` (its own session, killed whole at the time limit);
    returns its log."""
    script = os.path.join(work, "phase9_rank.py")
    with open(script, "w") as fh:
        fh.write(PHASE9_RANK)
    log_path = os.path.join(work, f"p9_{tag}.log")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", str(nproc), script, json.dumps(args)],
                                stdout=log, stderr=subprocess.STDOUT, env=env,
                                start_new_session=True)
    try:
        proc.wait(timeout=PHASE9_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    text = open(log_path).read()
    check(proc.returncode == 0, f"phase 9 {tag} exited {proc.returncode}:\n{text[-4000:]}")
    check(text.count("] loaded []") == nproc, f"phase 9 {tag}: a rank loaded jax or clair3_tpu")
    return text


def phase9_compare(a, b):
    """Two runs' (history, state): the largest relative loss difference,
    the largest parameter or statistic difference, the entries over 1e-5,
    all entries, and whether both are equal bit for bit."""
    import numpy as np

    (ha, sa), (hb, sb) = a, b
    check(np.array_equal(ha[:, :2], hb[:, :2]), f"phase 9: histories of other epochs {ha} {hb}")
    loss = float((np.abs(ha[:, 2:] - hb[:, 2:]) / np.abs(hb[:, 2:])).max())
    diffs = [np.abs(sa[k] - sb[k]) for k in sb]
    bitwise = np.array_equal(ha, hb) and all(np.array_equal(sa[k], sb[k]) for k in sb)
    return (loss, float(max(d.max() for d in diffs)), sum(int((d > 1e-5).sum()) for d in diffs),
            sum(d.size for d in diffs), bitwise)


def phase9_data_parallel(torch, work, smi):
    """Data-parallel training on the card (`fit(..., data_parallel=True)`,
    the path of `train --data_parallel`), every rank an OS process under
    torchrun: one rank on NCCL against the plain single-device `fit` in
    this process, then two gloo ranks sharing the card against the one
    rank; and the one rank's step time beside the plain step's."""
    import numpy as np

    specs = {}
    for name, kind, steps, n_chunks in (("pileup", "pileup", 3, 34), ("fa", "fa", 3, 17),
                                        ("fa1", "fa", 1, 17)):
        cfg = dict(PHASE9_NETS[kind], max_epoch=2)
        chunk = cfg["chunk_size_" + kind]
        data = os.path.join(work, f"p9_{kind}.npz")
        if not os.path.exists(data):
            # half a chunk of slack: every chunk is whole at any offset, so
            # every batch splits over 2 ranks with no padding
            x, y = phase9_rows(kind, n_chunks * chunk + chunk // 2, seed=11)
            np.savez(data, x=x, y=y)
        specs[name] = {"cfg": cfg, "steps": steps, "data": data,
                       "out_dir": os.path.join(work, f"p9_{name}")}

    # cuDNN's deterministic algorithms, as phase 7 trains, in every run
    torch.backends.cudnn.deterministic = True
    try:
        plain = {name: phase9_fit(dict(spec, out_dir=spec["out_dir"] + "_plain"),
                                  torch.device(DEVICE)) for name, spec in specs.items()}
    finally:
        torch.backends.cudnn.deterministic = False
    out = os.path.join(work, "p9")
    t0 = time.time()
    run_torchrun(work, "one", 1, {"device": DEVICE, "nets": specs, "out": out + "_one",
                                  "time": True})
    t1 = time.time()
    two_specs = {k: specs[k] for k in ("pileup", "fa1")}
    run_torchrun(work, "two", 2, {"device": DEVICE, "backend": "gloo", "nets": two_specs,
                                  "out": out + "_two"})
    print(f"[phase9] torchrun: one rank {t1 - t0:.2f} s, two ranks {time.time() - t1:.2f} s "
          f"(spawn to exit, host clock)")

    def load(path):
        with np.load(path) as z:
            return (z["history"], {k: z[k] for k in z.files if k not in (
                "history", "on_card", "backend", "world")}), z["on_card"], str(z["backend"])

    one = {}
    for name in specs:
        one[name], on_card, backend = load(f"{out}_one.{name}.0.npz")
        check(bool(on_card), f"phase 9 one rank {name}: parameters off the card")
        loss, par, over, total, bitwise = phase9_compare(one[name], plain[name])
        print(f"[phase9] {name} ({specs[name]['steps']} steps): one rank ({backend}) vs the plain "
              f"fit: losses max rel {loss:.3g}, parameters and statistics max |d| {par:.3g}, "
              f"bit for bit equal: {bitwise}")
        check(loss <= 1e-6 and par <= 1e-6, f"phase 9 one rank {name}: {loss} {par}")
    for name in two_specs:
        ranks = [load(f"{out}_two.{name}.{r}.npz") for r in range(2)]
        check(all(bool(on) for _, on, _ in ranks), f"phase 9 two ranks {name}: off the card")
        check(all(np.array_equal(ranks[1][0][1][k], ranks[0][0][1][k]) for k in ranks[0][0][1]),
              f"phase 9 two ranks {name}: the ranks hold other nets")
        got, ref = ranks[0][0], one[name]
        loss, par, over, total, _ = phase9_compare(got, ref)
        train_rel = float((np.abs(got[0][:, 2] - ref[0][:, 2]) / np.abs(ref[0][:, 2])).max())
        val_rel = float((np.abs(got[0][:, 3] - ref[0][:, 3]) / np.abs(ref[0][:, 3])).max())
        print(f"[phase9] {name} ({specs[name]['steps']} steps): two ranks ({ranks[0][2]}, one "
              f"card) vs one rank: training loss max rel {train_rel:.3g}, validation loss "
              f"{val_rel:.3g}; parameters and statistics max |d| {par:.3g}, {over} of {total} "
              f"entries over 1e-5; the two ranks' nets equal bit for bit")
        check(train_rel <= 1e-5, f"phase 9 two ranks {name}: training loss {train_rel}")
        # AdamW moves an entry whose gradient is rounding noise by up to lr a step
        check(par <= 2.01e-3 * specs[name]["steps"], f"phase 9 two ranks {name}: {par}")
        if name == "pileup":
            check(val_rel <= 1e-5 and over <= 1e-5 * total,
                  f"phase 9 two ranks pileup: validation {val_rel}, {over} entries over 1e-5")
        else:
            stats = max(float(np.abs(got[1][k] - ref[1][k]).max()) for k in ref[1]
                        if k.endswith((".mean", ".var")))
            print(f"[phase9] fa1: BatchNorm running statistics max |d| {stats:.3g} (two ranks "
                  f"vs one)")
            check(stats <= 1e-6 and val_rel <= 1e-3,
                  f"phase 9 two ranks fa1: statistics {stats}, validation {val_rel}")

    with open(f"{out}_one.times.json") as fh:
        times = json.load(fh)
    def text(runs):
        return "; ".join(f"{t['step_ms']:.3f} ms (forward + loss {t['forward_ms']:.3f}, backward "
                         f"{t['backward_ms']:.3f}, AdamW {t['adamw_ms']:.3f})" for t in runs)

    for name in ("pileup", "fa"):
        p, d = times[f"{name} plain"], times[f"{name} ddp"]
        p_ms, d_ms = (sum(t["step_ms"] for t in r) / len(r) for r in (p, d))
        print(f"[phase9] {name} train step B={PHASE9_NETS[name]['batch_size']} f32 ({smi}), "
              f"timed in turns plain, DDP, DDP, plain (each the median of 20 after 5 warm "
              f"steps, CUDA events): plain {text(p)}; DDP, one rank on {backend}: {text(d)}; "
              f"overhead {d_ms - p_ms:.3f} ms ({100 * (d_ms / p_ms - 1):.1f}%)")
    return times


# phase 10: the parity slice's and the soak's sizes; each soak contig is
# longer than CallConfig's 5 Mb chunk, so it is cut into two chunks
PARITY_MB = 1.0
SOAK_MB = 12.0
SOAK_CONTIGS = 2
SOAK_THREADS = 4
SOAK_TIMEOUT_S = 600
# the soak's memory budget: the JAX script's default --max_rss_gb (8 GB,
# set for a JAX process) above what the torch/CUDA runtime alone holds
# resident in a process of its own on this host (RUNTIME_RSS)
SOAK_RSS_BUDGET_GB = 8.0
RUNTIME_RSS = """
import resource

import torch

x = torch.zeros(8, 8, 55, 33, device="cuda")
torch.nn.functional.conv2d(x, torch.zeros(64, 8, 3, 3, device="cuda"), stride=2, padding=1)
torch.cuda.synchronize()
print(f"RUNTIME_PEAK_RSS_GB={resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}")
"""
# phase 10's inputs, simulated by the soak's own build_input in a process
# started right after the build, beside phases 2-9 (one core of the host):
# the parity slice (seed 23, one contig) and the soak's genome (seed 7)
SOAK_INPUTS = """
import json
import sys
import time

from clair3_tpu_torch.wgs_scale_demo import build_input

for spec in json.loads(sys.argv[1]):
    t0 = time.time()
    build_input(*spec)
    print(f"BUILT {spec[1]} Mb in {time.time() - t0:.2f} s", flush=True)
"""
SOAK_INPUTS_TIMEOUT_S = 900


def soak_input_specs(work):
    """build_input's arguments for the parity slice and the soak, with the
    fixtures' simulator settings (manifest.json: coverage, read length,
    error rate)."""
    from clair3_tpu_torch.testing import trained_fixture_path

    with open(trained_fixture_path("manifest.json")) as fh:
        sim = json.load(fh)["simulator"]
    reads = (sim["coverage"], sim["read_length"], sim["error_rate"])
    return [[os.path.join(work, "soak_parity"), PARITY_MB, 1, *reads, 23],
            [os.path.join(work, "soak"), SOAK_MB, SOAK_CONTIGS, *reads, 7]]


def start_soak_inputs(work):
    """The simulation of phase 10's inputs, in a process group of its own;
    returns (process, log path, start time)."""
    specs = soak_input_specs(work)
    for spec in specs:
        os.makedirs(spec[0])
    log_path = os.path.join(work, "soak_inputs.log")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", SOAK_INPUTS, json.dumps(specs)],
                                stdout=log, stderr=subprocess.STDOUT, env=env,
                                start_new_session=True)
    return proc, log_path, time.time()


def stop(proc):
    """Kill ``proc``'s process group if it still runs."""
    if proc is not None and proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def soak_parity_slice(torch, spec, smi):
    """The soak's parity slice on its built input (``spec``: build_input's
    arguments): the f32 CPU twin, then the card at f32 and at bf16."""
    from clair3_tpu_torch import wgs_scale_demo as soak
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from clair3_tpu_torch.testing import trained_fixture_path, vcf_rows_numerically_equivalent

    d = spec[0]
    models = (trained_fixture_path("pileup_hifi.npz"), trained_fixture_path("fa_hifi.npz"))
    args = argparse.Namespace(platform="hifi", threads=SOAK_THREADS)
    # the truth list again from the seed; the reads were simulated beforehand
    fasta, bam, _, truth = soak.build_input(*spec, reuse=True)
    print(f"[phase10] parity slice: {PARITY_MB} Mb x {spec[3]}x, {len(truth)} variants")
    outs, rows = {}, {}
    for label in ("cpu_twin", "fp32", "bf16"):
        if label == "cpu_twin":
            engines = soak.build_cpu_twin_engines(*models)
        else:
            engines = soak.build_production_engines(*models, DEVICE, label)
        outs[label] = os.path.join(d, label)
        cfg = soak.production_config(args, fasta, bam, outs[label])
        zero_kernel_counts()
        t0 = time.time()
        outputs = VariantCaller(cfg, pileup_engine=engines[0], fa_engine=engines[1]).run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        r = kernel_counts()
        rows[label] = soak._vcf_body(outputs["merge_output"])
        where = "this host's CPU" if label == "cpu_twin" else smi
        print(f"[phase10] parity {label}: wall {wall:.2f} s ({where}), "
              f"{len(rows[label])} merged rows, pileup kernel calls {r['calls']} "
              f"(launches {r['kernels']}), plain pileup forwards on the card {r['plain']}")
        if label == "cpu_twin":
            check(r["calls"] == 0 and r["plain"] == 0, f"phase 10 twin: counts {r}")
        else:
            check_pileup_route(torch, f"phase 10 parity {label}", r, label)
    check(len(rows["cpu_twin"]) > 50, "phase 10: too few parity rows")
    ok, st = vcf_rows_numerically_equivalent(rows["fp32"], rows["cpu_twin"], flip_budget=0.0)
    print(f"[phase10] parity f32 card vs f32 CPU twin: "
          f"{len(set(rows['fp32']) & set(rows['cpu_twin']))}/{len(rows['cpu_twin'])} rows "
          f"byte-identical; max dQUAL {st['max_dqual']:.2f}, dGQ {st['max_dgq']}, dPL "
          f"{st['max_dpl']}, flips {st['flips']}")
    check(ok, f"phase 10 parity f32: {st['violations'][:5]}")
    script_ok, script = vcf_rows_numerically_equivalent(rows["bf16"], rows["cpu_twin"],
                                                        qual_tol=1.0, flip_budget=0.005)
    ok, st = vcf_rows_numerically_equivalent(rows["bf16"], rows["cpu_twin"], qual_tol=float("inf"),
                                             gq_tol=1 << 30, pl_tol=1 << 30, flip_budget=0.005)
    changed, n, dq = rows_changed(outs["cpu_twin"], outs["bf16"], "merge_output.vcf.gz")
    print(f"[phase10] parity bf16 card vs f32 CPU twin: discrete fields equal on every "
          f"same-route row: {ok} ({st['flips']} routing flips); {len(changed)}/{n} rows changed "
          f"call or source; max QUAL delta {dq['P']:.2f} on pileup-decided rows, {dq['F']:.2f} "
          f"on FA-decided rows; the script's check (qual_tol 1.0, flip budget 0.005): "
          f"{'met' if script_ok else 'missed'}, max dQUAL {script['max_dqual']:.2f}, "
          f"dGQ {script['max_dgq']}, dPL {script['max_dpl']}")
    check(ok, f"phase 10 parity bf16, discrete fields: {st['violations'][:5]}")
    check(len(changed) <= max(1, n // 100), f"phase 10 parity bf16: {len(changed)} rows changed")
    check(dq["P"] < 1.5, f"phase 10 parity bf16: QUAL delta {dq['P']} on pileup rows")


def phase10_soak(torch, work, smi, inputs):
    """The parity slice, then the soak in an OS process of its own, both
    on the inputs that ``inputs`` (start_soak_inputs) simulated."""
    t_phase = time.time()
    proc, log_path, t0 = inputs
    try:
        proc.wait(timeout=max(1.0, t0 + SOAK_INPUTS_TIMEOUT_S - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop(proc)
    log = open(log_path).read()
    check(proc.returncode == 0, f"phase 10 input simulation exited {proc.returncode}:\n"
          f"{log[-4000:]}")
    walls = [float(w) for w in re.findall(r"^BUILT \S+ Mb in ([0-9.]+) s$", log, re.M)]
    specs = soak_input_specs(work)
    for spec, wall in zip(specs, walls):
        print(f"[phase10] simulated {spec[1]} Mb over {spec[2]} contig(s) x {spec[3]}x, "
              f"{spec[4]} bp reads, {spec[5]} error (seed {spec[6]}) in {wall:.2f} s, "
              f"{spec[1] * 1e3 / wall:.2f} kb/s (host clock, one core, beside phases 2-9; {smi})")
    print(f"[phase10] waited {time.time() - t_phase:.2f} s for the input simulation")
    soak_parity_slice(torch, specs[0], smi)
    # a shell forks the probe, so its peak RSS is its own (see spawn_child)
    probe = subprocess.run(["bash", "-c", '"$@"; exit $?', "probe", sys.executable, "-c",
                            RUNTIME_RSS], capture_output=True, text=True, timeout=300)
    check(probe.returncode == 0, f"phase 10 runtime probe: {probe.stderr[-2000:]}")
    runtime_gb = float(probe.stdout.split("RUNTIME_PEAK_RSS_GB=")[1].split()[0])
    max_rss_gb = round(runtime_gb + SOAK_RSS_BUDGET_GB, 2)
    print(f"[phase10] the torch/CUDA runtime alone (import torch, a CUDA context, one cuDNN "
          f"convolution) holds {runtime_gb:.2f} GB resident at its peak; the soak runs with "
          f"--max_rss_gb {max_rss_gb} (the script's default {SOAK_RSS_BUDGET_GB} GB above it; "
          f"{smi})")
    out, mb, contigs, coverage, read_length, error_rate, _ = specs[1]
    args = ["--engines", "production", "--platform", "hifi", "--mbases", str(mb),
            "--contigs", str(contigs), "--coverage", str(coverage),
            "--read_length", str(read_length), "--error_rate", str(error_rate),
            "--threads", str(SOAK_THREADS), "--output", out, "--device", DEVICE,
            "--max_rss_gb", str(max_rss_gb), "--reuse_input"]
    proc, log_path, t0 = spawn_child(work, "soak", "clair3_tpu_torch.wgs_scale_demo", args,
                                     own_peak_rss=True)
    try:
        proc.wait(timeout=SOAK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop(proc)
    wall = time.time() - t0
    log = open(log_path).read()
    for line in log.splitlines():
        if line.startswith(("[soak]", "VariantType", "SNP ", "INDEL ")):
            print(f"[phase10] {line}")
    check(proc.returncode == 0, f"phase 10 soak exited {proc.returncode}:\n{log[-4000:]}")
    check("[soak] OK [production engines]" in log, "phase 10: the soak did not pass its gates")
    check("[soak] reusing existing ref.fa + reads.bam" in log,
          "phase 10: the soak simulated its input again")
    check("[child] loaded []" in log, "phase 10 soak: loaded jax or clair3_tpu")
    m = re.search(r"pileup kernel launches (\{.*?\}), plain pileup forwards on the card (\d+)",
                  log)
    check(m is not None, "phase 10 soak: no kernel line")
    k, plain = json.loads(m.group(1)), int(m.group(2))
    check(k["pileup_l1_tc"] > 0 and k["pileup_l1_tc"] == k["pileup_l2_tc"] == k["pileup_head"],
          f"phase 10 soak: L1/L2/L3 launches {k}")
    check(k["pileup_full"] == 0 and plain == 0,
          f"phase 10 soak: the SIMT kernel or the plain path ran on the card {k} {plain}")
    rss = float(re.search(r"\[soak\] OK .*peak RSS ([0-9.]+) GB", log).group(1))
    print(f"[phase10] soak peak RSS {rss:.2f} GB: {rss - runtime_gb:.2f} GB above the runtime's "
          f"{runtime_gb:.2f} (budget {SOAK_RSS_BUDGET_GB}); against the script's default "
          f"{SOAK_RSS_BUDGET_GB} GB for the whole process: "
          f"{'met' if rss <= SOAK_RSS_BUDGET_GB else 'missed'} ({smi})")
    stages = re.search(r"\[soak\] stage times: (\{.*\})", log).group(1)
    pileup_s = json.loads(stages.replace("'", '"'))["pileup"]
    launches = sum(k[name] for name in ("pileup_l1_tc", "pileup_l2_tc", "pileup_head"))
    print(f"[phase10] soak: {SOAK_MB} Mb over {SOAK_CONTIGS} contigs, process wall {wall:.2f} s "
          f"(its input built beforehand; spawn to exit, {smi}); K1 launches {k} = "
          f"{launches / SOAK_MB:.2f} per Mb ({k['pileup_l1_tc'] / SOAK_MB:.2f} pileup calls "
          f"per Mb), pileup stage {pileup_s} s")
    print(f"[phase10] phase wall {time.time() - t_phase:.2f} s ({smi})")
    return {"kernels": k, "pileup_s": pileup_s}


# the bench (python -m clair3_tpu_torch.bench) and its microbenches, in
# this order, each an OS process of its own
BENCH_RUNS = (("bench", "clair3_tpu_torch.bench", "[bench]"),
              ("bench_fa_conv1", "clair3_tpu_torch.bench_fa_conv1", "[fa_conv1]"),
              ("bench_history", "clair3_tpu_torch.bench_history", "[history]"))
BENCH_TIMEOUT_S = 900


def bench_kernels(tag, log):
    """The last ``[kernels]`` line of a bench child's log."""
    lines = [line for line in log.splitlines() if line.startswith("[kernels] ")]
    check(lines, f"phase 11 {tag}: no [kernels] line")
    return json.loads(lines[-1].split(" ", 1)[1])


def phase11_bench(work, smi):
    """The port's bench and its two microbenches on the card, each run as a
    user runs it (``python -m ...``, no arguments: cuda), alone on the card,
    one after the other."""
    t_phase = time.time()
    logs = {}
    for tag, module, prefix in BENCH_RUNS:
        ran = wait_children({tag: spawn_child(work, f"p11_{tag}", module, [])},
                            phase="phase 11", timeout=BENCH_TIMEOUT_S)
        wall, log = ran[tag]
        logs[tag] = log
        for line in log.splitlines():
            if line.startswith((prefix, "|", "{")):
                print(f"[phase11] {tag}: {line}" + ("" if smi in line else f" ({smi})"))
        print(f"[phase11] {tag}: process wall {wall:.2f} s (spawn to exit; {smi})")
        check("[child] loaded []" in log, f"phase 11 {tag}: loaded jax or clair3_tpu")

    # the bench: its last line, its kernels, the ONT and serve lines, the bytes
    lines = [line for line in logs["bench"].splitlines() if line.startswith('{"metric"')]
    check(len(lines) == 1, f"phase 11 bench: {len(lines)} result lines")
    result = json.loads(lines[0])
    check(set(result) == {"metric", "value", "unit", "vs_baseline"} and result["value"] > 0,
          f"phase 11 bench: result line {lines[0][:200]}")
    k = bench_kernels("bench", logs["bench"])
    check(k["pileup_l1_tc"] > 0 and k["pileup_l1_tc"] == k["pileup_l2_tc"] == k["pileup_head"],
          f"phase 11 bench: L1/L2/L3 launches {k}")
    check(k["pileup_full"] == 0 and k["plain_cuda_forwards"] == 0,
          f"phase 11 bench: the SIMT kernel or the plain pileup path ran on the card {k}")
    check("[bench] ONT e2e cascade" in logs["bench"], "phase 11 bench: no ONT line")
    serve = re.search(r"\[bench\] serve mode: .*\((\d+) requests coalesced into (\d+) forwards\)",
                      logs["bench"])
    check(serve is not None, "phase 11 bench: no serve line")
    requests, batches = int(serve.group(1)), int(serve.group(2))
    check(requests > batches, f"phase 11 bench: no coalescing ({requests} requests, "
          f"{batches} forwards)")
    shipped = re.findall(r"\[bench\] bytes_shipped (\w+): (\d+) against (\d+) dense",
                         logs["bench"])
    check(len(shipped) == 2, "phase 11 bench: no bytes_shipped lines")
    for kind, got, dense in shipped:
        check(int(got) < int(dense), f"phase 11 bench: {kind} shipped {got} of {dense} dense")

    # the microbenches: their route checks held (they exit 1 otherwise) and
    # their kernels ran
    check("route check:" in logs["bench_fa_conv1"] and "fa_net_mfu" in logs["bench_fa_conv1"],
          "phase 11 bench_fa_conv1: no route check or MFU line")
    k3 = bench_kernels("bench_fa_conv1", logs["bench_fa_conv1"])
    check(k3["fa_conv1"] > 0, f"phase 11 bench_fa_conv1: K3 never launched {k3}")
    hist = bench_kernels("bench_history", logs["bench_history"])
    check(hist["pileup_l1_tc"] > 0 and hist["pileup_full"] > 0,
          f"phase 11 bench_history: a kernel route did not run {hist}")
    check(logs["bench_history"].count("vs shipped: max-abs prob diff") == 3
          and "| configuration" in logs["bench_history"],
          "phase 11 bench_history: a route check or the table is missing")
    print(f"[phase11] bench {result['value']} {result['unit']} ({result['vs_baseline']}x the "
          f"reference's RTX 4090 figure); serve {requests} requests in {batches} forwards; "
          f"kernels: bench {k}, bench_fa_conv1 K3 {k3['fa_conv1']}, bench_history {hist}; "
          f"phase wall {time.time() - t_phase:.2f} s ({smi})")
    return {"bench": k, "fa_conv1": k3["fa_conv1"], "history": hist, "value": result["value"]}


# the Illumina notebook's geometry (scripts/build_notebooks.py: 60 kb, 150 bp
# reads, 40x, 0.2% error, seed 11, a variant every 160 bp)
ILMN_BP = 60_000
ILMN_CALL_ARGS = ["--platform", "ilmn", "--no_phasing_for_fa", "--threads", "4"]


def simulate_ilmn(work):
    """The Illumina notebook's simulated sample; (fasta, bam, variants)."""
    import random

    from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

    ref = random_reference(ILMN_BP, seed=11)
    rng = random.Random(11)
    variants = []
    for pos in range(500, ILMN_BP - 500, 160):
        gt = (1, 1) if rng.random() < 0.5 else (0, 1)
        kind = rng.random()
        if kind < 0.7:  # SNP
            alt = rng.choice([b for b in "ACGT" if b != ref[pos]])
            variants.append(SimVariant(pos, ref[pos], alt, gt))
        elif kind < 0.85:  # insertion
            ins = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 3)))
            variants.append(SimVariant(pos, ref[pos], ref[pos] + ins, gt))
        else:  # deletion
            dlen = rng.randint(1, 3)
            variants.append(SimVariant(pos, ref[pos:pos + dlen + 1], ref[pos], gt))
    d = os.path.join(work, "ilmn")
    os.makedirs(d)
    fasta, bam, _, _ = write_test_case(d, ref_length=ILMN_BP, variants=variants, coverage=40,
                                       read_length=150, seed=11, error_rate=0.002)
    return fasta, bam, variants


def phase12_ilmn(torch, work, smi):
    """``call --platform ilmn --no_phasing_for_fa`` with the committed hifi
    nets on the card at f32 and bf16, and on the CPU at f32."""
    from clair3_tpu_torch import cli as port_cli
    from clair3_tpu_torch.testing import QUAL_SATURATES, f32_rows_equivalent, trained_fixture_path

    t_phase = time.time()
    fasta, bam, variants = simulate_ilmn(work)
    print(f"[phase12] simulated {ILMN_BP} bp, 40x 150 bp reads, 0.2% error, "
          f"{len(variants)} variants in {time.time() - t_phase:.2f} s")
    models = ["--pileup_model", trained_fixture_path("pileup_hifi.npz"),
              "--full_alignment_model", trained_fixture_path("fa_hifi.npz")]
    outs = {}
    for label, device, flag in (("cuda fp32", DEVICE, "fp32"), ("cuda bf16", DEVICE, "bf16"),
                                ("cpu fp32", "cpu", "fp32")):
        out = os.path.join(work, "ilmn_" + label.replace(" ", "_"))
        argv = ["call", "--bam_fn", bam, "--ref_fn", fasta, "--output", out, *models,
                "--device", device, "--compute_dtype", flag, *ILMN_CALL_ARGS]
        if device == "cpu":
            t0 = time.time()
            check(port_cli.main(argv) == 0, "phase 12: the CPU call failed")
            r = {"wall": time.time() - t0}
        else:
            r = counted_call(torch, "phase12", label, argv)
            check_pileup_route(torch, f"phase 12 {label}", r, flag)
        outs[label] = out
        fa_rows, m = score(out, variants)
        print(f"[phase12] {label}: wall {r['wall']:.2f} s"
              + (f", pileup kernel calls {r['calls']} (launches {r['kernels']}), plain "
                 f"pileup forwards on the card {r['plain']}" if device != "cpu" else "")
              + f", FA rows {fa_rows}, {f1_text(m)} (no gate: the nets were trained on hifi "
              f"reads; {smi if device != 'cpu' else 'host CPU'})")
        check(fa_rows > 10, f"phase 12 {label}: FA stage never engaged ({fa_rows} rows)")
    for label in ("cuda fp32", "cuda bf16"):
        for rel in ("realigned.bam", "full_aln_regions.bed"):
            got, want = (open(os.path.join(outs[k], "tmp", rel), "rb").read()
                         for k in (label, "cpu fp32"))
            check(got == want and len(want) > 0,
                  f"phase 12 {label}: tmp/{rel} differs from the CPU run's")
    print("[phase12] tmp/realigned.bam and tmp/full_aln_regions.bed byte-identical between "
          "the card runs and the CPU run")
    for name in ("pileup.vcf.gz", "full_alignment.vcf.gz", "merge_output.vcf.gz"):
        a, b = (_rows(os.path.join(outs[k], name)) for k in ("cpu fp32", "cuda fp32"))
        ok, stats, n_high, high_dqual = f32_rows_equivalent(a, b)
        print(f"[phase12] card f32 vs CPU f32 {name}: {len(set(a) & set(b))}/{len(a)} rows "
              f"byte-identical, max dQUAL {stats['max_dqual']:.2f} below QUAL "
              f"{QUAL_SATURATES}, {high_dqual:.2f} on the {n_high} rows above, flips "
              f"{stats['flips']}")
        check(len(a) > 10 and ok, f"phase 12 {name}: {stats['violations'][:5]}")
    bf16_vs_f32(outs["cuda bf16"], outs["cuda fp32"], tag="phase12")
    print(f"[phase12] phase wall {time.time() - t_phase:.2f} s ({smi})")


PHASE13_F32_TOL = 1e-5
PHASE13_BF16_PILEUP_TOL = 1e-6
PHASE13_NETS = {("hifi", "pileup"): "pileup_hifi.npz",
                ("hifi", "full_alignment"): "fa_hifi.npz",
                ("ont", "pileup"): "pileup_ont.npz",
                ("ont", "full_alignment"): "fa_ont.npz"}


def sharded_inputs(work, real, real_fa):
    """(platform, kind) -> tensors: phase 3's pileup and FA tensors, and the
    same of phase 6's ONT region (its first 1024 candidates' FA tensors at
    depth 89 with the dwell channel)."""
    from clair3_tpu_torch.fullalign.extractor import create_fa_tensors
    from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
    from clair3_tpu_torch.testing import simulate

    d = os.path.join(work, "sharded_ont")
    os.makedirs(d)
    fasta, bam, _, _ = simulate(d, ONT_EVAL_BP, seed=EVAL_SEED, platform="ont")
    ont, cands, _, _ = create_pileup_tensors(bam, fasta, "chr1", 1, ONT_EVAL_BP)
    positions = [int(str(c).split(":")[1]) for c in cands[:1024]]
    ont_fa, _, _ = create_fa_tensors(bam, fasta, "chr1", positions, matrix_depth=89,
                                     no_phasing=True, enable_dwell=True)
    return {("hifi", "pileup"): real, ("hifi", "full_alignment"): real_fa,
            ("ont", "pileup"): ont, ("ont", "full_alignment"): ont_fa}


def replica_launches():
    """K1's launches by kernel and K3's (``fa_conv1``), since the counts
    were last set to 0."""
    from clair3_tpu_torch.ops import fa_conv1 as k3
    from clair3_tpu_torch.ops import pileup_full as pf

    return {**pf.kernel_launches, "fa_conv1": k3.launches}


def count_by_replica(engine):
    """The kernels' launches by replica of ``engine``, read around each
    replica's forward (one submitter thread issues every shard, so no other
    forward runs in between); returns one dict per replica, filled as it
    runs."""
    counts = [dict.fromkeys(replica_launches(), 0) for _ in engine.replicas]
    for net, c in zip(engine.replicas, counts):
        before = {}

        def pre(mod, args, before=before):
            before.update(replica_launches())

        def post(mod, args, out, before=before, c=c):
            for k, v in replica_launches().items():
                c[k] += v - before[k]

        net.register_forward_pre_hook(pre)
        net.register_forward_hook(post)
    return counts


def replica_route(counts, flag, label):
    """Each replica ran K1 on ``flag``'s route only: at bf16 L1, L2 and L3
    equally often and never the SIMT kernel, at f32 the reverse."""
    for i, c in enumerate(counts):
        tc = [c["pileup_l1_tc"], c["pileup_l2_tc"], c["pileup_head"]]
        if flag == "bf16":
            check(tc[0] > 0 and len(set(tc)) == 1 and c["pileup_full"] == 0,
                  f"{label}: replica {i} launched {c}")
        else:
            check(c["pileup_full"] > 0 and not any(tc), f"{label}: replica {i} launched {c}")


def timed_predict(torch, engine, x):
    """(probabilities, host wall per batch in ms) of the second of two
    predicts (the first builds, packs and warms)."""
    engine.predict(x)
    t0 = time.perf_counter()
    p = engine.predict(x)
    wall = time.perf_counter() - t0
    return p, wall * 1e3 / -(-len(x) // engine.buckets[-1])


PHASE13_RUNS = (("fp32", "float32", {}), ("bf16", "bfloat16", {}),
                ("bf16+fa_conv1", "bfloat16", {"CLAIR3T_ENABLE_FA_CONV1": "1"}))


def phase13_engines(torch, inputs, smi):
    """Engines over ``local_devices`` and over two replicas of one card
    against the one-device engine, on each net's tensors, at f32, bf16 and
    (the FA nets) bf16 with K3; returns K3's launches by replica of the
    two-replica opt-in engines."""
    import numpy as np

    from clair3_tpu_torch.cli import _load_engine
    from clair3_tpu_torch.parallel.mesh import local_devices
    from clair3_tpu_torch.testing import trained_fixture_path

    every = local_devices(DEVICE)
    dev = every[0]
    print(f"[phase13] local_devices({DEVICE!r}): {len(every)} device(s) "
          f"{[str(d) for d in every]} ({smi})")
    configs = ((f"local_devices ({len(every)})", every), (f"2 replicas on {dev}", [dev, dev]))
    k3_by_replica = {}
    for flag, dt, env in PHASE13_RUNS:
        for (plat, kind), x in inputs.items():
            if env and kind == "pileup":
                continue
            path = trained_fixture_path(PHASE13_NETS[plat, kind])
            os.environ.update(env)  # read when the net is loaded
            try:
                zero_kernel_counts()
                one = _load_engine(path, kind, dev, getattr(torch, dt), [dev])
                p1, w1 = timed_predict(torch, one, x)
                line = (f"[phase13] {plat} {kind} {flag} {tuple(x.shape)}: one device "
                        f"{w1:.3f} ms/batch")
                for label, devices in configs:
                    engine = _load_engine(path, kind, dev, getattr(torch, dt), devices)
                    counts = count_by_replica(engine)
                    p, wall = timed_predict(torch, engine, x)
                    err = float(np.abs(p - p1).max())
                    line += (f"; {label}: {wall:.3f} ms/batch, max |dp| {err:.3g}, "
                             f"bytes_shipped {engine.bytes_shipped} / {one.bytes_shipped}")
                    tag = f"phase 13 {plat} {kind} {flag} {label}"
                    check(p.shape == p1.shape and np.isfinite(p).all(), f"{tag}: {p.shape}")
                    check((engine.bytes_shipped, engine.dense_bytes)
                          == (one.bytes_shipped, one.dense_bytes),
                          f"{tag}: bytes {engine.bytes_shipped}/{engine.dense_bytes} against "
                          f"{one.bytes_shipped}/{one.dense_bytes}")
                    if flag == "fp32":
                        check(err <= PHASE13_F32_TOL, f"{tag}: max |dp| {err}")
                    elif kind == "pileup":
                        check(err <= PHASE13_BF16_PILEUP_TOL, f"{tag}: max |dp| {err}")
                    check(len(counts) == len(devices), f"{tag}: {len(counts)} replicas")
                    if kind == "pileup":
                        replica_route(counts, flag, tag)
                    else:
                        check(all((c["fa_conv1"] > 0) == bool(env) for c in counts),
                              f"{tag}: K3 launches by replica {counts}")
                        if env and len(devices) > 1:
                            k3_by_replica[plat] = [c["fa_conv1"] for c in counts]
            finally:
                for key in env:
                    del os.environ[key]
            check(kernel_counts()["plain"] == 0, f"phase 13 {plat} {kind} {flag}: the plain "
                  "pileup path ran on the card")
            print(f"{line} ({smi})")
    return k3_by_replica


def phase13_cascade(torch, work, fasta, bam, variants, smi):
    """`call` on the 120 kb region at f32 and bf16, on one device and with
    its engines over two replicas of that device; returns K1's launches by
    replica of the two-replica runs."""
    from clair3_tpu_torch import cli as port_cli
    from clair3_tpu_torch.parallel.mesh import local_devices

    dev = local_devices(DEVICE)[0]
    local, load = port_cli.local_devices, port_cli._load_engine
    by_replica = {}

    def counting_load(path, kind, device, dt, devices=None):
        engine = load(path, kind, device, dt, devices)
        if kind == "pileup":
            by_replica[current] = count_by_replica(engine)
        return engine

    outs = {}
    port_cli._load_engine = counting_load
    try:
        for n in (1, 2):
            port_cli.local_devices = lambda device, n_devices=None, n=n: [dev] * n
            for flag in ("fp32", "bf16"):
                current = (n, flag)
                label = f"{n} replica(s) {flag}"
                out = os.path.join(work, f"sharded_{n}_{flag}")
                r = counted_call(torch, "phase13", label, hifi_argv(fasta, bam, out, flag))
                fa_rows, m = score(out, variants)
                print(f"[phase13] {label}: wall {r['wall']:.2f} s, launches {r['kernels']}, "
                      f"by replica {by_replica[current]}, FA rows {fa_rows}, {f1_text(m)} "
                      f"({smi})")
                check_pileup_route(torch, label, r, flag)
                check(all(len(e.devices) == n for _, e in r["engines"]),
                      f"{label}: engines over {[len(e.devices) for _, e in r['engines']]}")
                replica_route(by_replica[current], flag, label)
                check(fa_rows > 10, f"{label}: FA stage never engaged ({fa_rows} rows)")
                outs[n, flag] = out
    finally:
        port_cli.local_devices, port_cli._load_engine = local, load
    for name in ("pileup.vcf.gz", "merge_output.vcf.gz"):
        rows_equivalent("phase13", "2 replicas vs one device f32", outs[1, "fp32"],
                        outs[2, "fp32"], name)
        a, b = _rows(os.path.join(outs[1, "bf16"], name)), _rows(os.path.join(outs[2, "bf16"], name))
        print(f"[phase13] 2 replicas vs one device bf16 {name}: "
              f"{len(set(a) & set(b))}/{len(a)} rows byte-identical ({len(b)} rows)")
    bf16_vs_f32(outs[2, "bf16"], outs[1, "fp32"], tag="phase13")
    return {flag: by_replica[2, flag] for flag in ("bf16", "fp32")}


def phase13_sharded(torch, work, fasta, bam, variants, real, real_fa, smi):
    """Phase 13; returns K1's launches by replica of the two-replica calls
    and K3's of the two-replica opt-in engines."""
    t0 = time.time()
    k3 = phase13_engines(torch, sharded_inputs(work, real, real_fa), smi)
    k1 = phase13_cascade(torch, work, fasta, bam, variants, smi)
    print(f"[phase13] phase wall {time.time() - t0:.2f} s ({smi})")
    return {"k1": k1, "k3": k3}


def setup(work):
    """The simulated phase-3 region, its pileup tensors and the FA tensors
    of its first 1024 candidates."""
    from clair3_tpu_torch.fullalign.extractor import create_fa_tensors
    from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
    from clair3_tpu_torch.testing import simulate

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
    return fasta, bam, variants, real, real_fa


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="chip check of clair3_tpu_torch on one GPU")
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phases to run (default: all); the kernels are "
                         "built in any case, and a subset ends without the ok line")
    phases = {int(p) for p in ap.parse_args(argv).phases.split(",")}
    check(phases <= set(PHASES), f"--phases: no phase {sorted(phases - set(PHASES))}")
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from clair3_tpu_torch import native as host_native
    from clair3_tpu_torch.cli import load_model
    from clair3_tpu_torch.decode import shutdown_decode_pool
    from clair3_tpu_torch.models import PileupNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.ops import _build
    from clair3_tpu_torch.testing import random_variables, trained_fixture_path

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

    inputs = None
    try:
        with tempfile.TemporaryDirectory() as work:
            if 10 in phases:
                inputs = start_soak_inputs(work)
            if phases & {2, 3, 4, 6, 8, 13}:
                fasta, bam, variants, real, real_fa = setup(work)
            if 2 in phases:
                dev = torch.device(DEVICE)
                hifi = load_model(trained_fixture_path("pileup_hifi.npz"), "pileup", dev,
                                  torch.float32)
                rand4 = PileupNet(add_indel_length=True)
                rand4.load_state_dict(from_jax_variables(random_variables(rand4, seed=5)))
                rand4 = rand4.to(dev).eval()
                with torch.inference_mode():
                    timing, worst = phase2_kernel_vs_plain(
                        torch, [("hifi", hifi), ("random4", rand4)], np.asarray(real))
            if 3 in phases:
                launches = phase3_cascade(torch, work, fasta, bam, variants)
            if 4 in phases:
                with torch.inference_mode():
                    k3_timing, k3_worst = phase4_fa_conv1(torch, np.asarray(real_fa))
            if 5 in phases:
                k2_timing, k2_worst, k2_launches, k2_library = phase5_bilstm(torch)
            if 6 in phases:
                phase6_surface(torch, work, fasta, bam, variants,
                               launches["bf16"] if 3 in phases else None)
            if 7 in phases:
                phase7_training(torch, work)
            if 8 in phases:
                phase8_multiprocess(torch, work, fasta, bam, variants, smi)
            if 9 in phases:
                phase9_data_parallel(torch, work, smi)
            if 10 in phases:
                soak = phase10_soak(torch, work, smi, inputs)
            if 11 in phases:
                bench = phase11_bench(work, smi)
            if 12 in phases:
                phase12_ilmn(torch, work, smi)
            if 13 in phases:
                sharded = phase13_sharded(torch, work, fasta, bam, variants, real, real_fa,
                                          smi)
    finally:
        stop(inputs and inputs[0])
        shutdown_decode_pool()

    blocked = ("jax", "flax", "optax", "clair3_tpu")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
    check(not loaded, f"the port loaded {loaded[:5]}")
    if phases != set(PHASES):
        print(f"[chip_smoke] phases {sorted(phases)} passed; no record without every phase")
        return 0
    bf16 = str(torch.bfloat16)
    k1 = timing[(max(K1_TIME_BATCHES), bf16)]
    # the engine cuts a chunk's candidates into batches of its largest
    # bucket (4096 rows): every call but a chunk's last is full
    k1_soak_s = soak["kernels"]["pileup_l1_tc"] * k1["ms"] / 1e3
    print(f"[phase10] K1 in the soak's pileup stage: at most {k1_soak_s:.3f} s of device "
          f"time (its calls x phase 2's time at B=4096) of {soak['pileup_s']} s, "
          f"{100 * k1_soak_s / soak['pileup_s']:.2f}% ({smi})")
    k1_kernels = launches["bf16"]["pileup_kernels"]
    k3_ms, k3_plain, k3_lib, k3_bound, k3_by = k3_timing[("hifi", max(K3_TIME_BATCHES), bf16)]
    k2_key = (K2_SHAPES[0][1], max(TIME_BATCHES), bf16)
    k2_ms, k2_plain, k2_bound, k2_by = k2_timing[("tpu",) + k2_key]
    k2_module, k2_lib = k2_library[k2_key]
    record = {"kernels": [
        {"name": "pileup_full", "route": "cuda",
         "source": "clair3_tpu_torch/csrc/pileup_tc.cu",
         "replaces": "clair3_tpu/ops/pallas_pileup.py:267",
         # launches of the source's three kernels on the main path, and by kernel
         "launches": sum(k1_kernels[k] for k in ("pileup_l1_tc", "pileup_l2_tc", "pileup_head")),
         "kernel_launches": k1_kernels, "calls": launches["bf16"]["pileup_full"],
         "max_abs_err": worst[bf16],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None, "launch_ms": k1["launch_ms"],
         "pack_ms": k1["pack_ms"], "trunk_ms": k1["trunk_ms"],
         # the soak's (phase 10) and the bench's (phase 11) launches, each
         # from its own process
         "soak_launches": soak["kernels"], "bench_launches": bench["bench"],
         # phase 13's calls with the engines over two replicas of one card:
         # each replica's launches, by kernel
         "replica_launches": {k: [{n: c[n] for n in k1_kernels} for c in by_replica]
                              for k, by_replica in sharded["k1"].items()}},
        {"name": "fa_conv1", "route": "cuda",
         "source": "clair3_tpu_torch/csrc/fa_conv1.cu",
         "replaces": "clair3_tpu/ops/pallas_fa.py:101",
         "launches": launches["bf16+fa_conv1"]["fa_conv1"], "max_abs_err": k3_worst[bf16],
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": k3_lib,
         # launches in bench_fa_conv1's process (phase 11), and by replica
         # of phase 13's two-replica opt-in FA engines
         "bench_fa_conv1_launches": bench["fa_conv1"], "replica_launches": sharded["k3"]},
        {"name": "bilstm", "route": "cuda",
         "source": "clair3_tpu_torch/csrc/bilstm.cu",
         "replaces": "clair3_tpu/ops/pallas_lstm.py:60",
         "launches": k2_launches, "max_abs_err": k2_worst[bf16],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": k2_lib, "module_ms": k2_module},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
