"""End-to-end bench of the port, the twin of the JAX package's ``bench.py``:
cascade throughput through the production code path, plus device-resident
forward capacity, on ``--device`` (default ``cuda``).

    python -m clair3_tpu_torch.bench [--device cuda|cpu]

Phases, as in ``bench.py``:

1. **Forward capacity** of both nets in the shipped configuration (the
   engines ``cli call`` builds: bf16 and the pileup kernels on a GPU), with
   one realistic random batch staged on the device up front
   (``bench_forward``): each iteration adds ``i % 3`` to it, so the forward
   cannot be hoisted, and sums the full output into a device scalar; one
   ``.item()`` at the end.  Best of 3 timed runs after one warm run.
2. **End-to-end cascade, serial**: a synthetic HiFi-like workload (2 Mb
   in 4 chunks, 25x, 900 bp reads, 2% error, het SNPs for haplotagging;
   the distribution the committed fixture nets were trained on) through
   native pileup extraction, the engine's measured forward (pinned
   host->device copy, bucket padding, compact wire forms), native decode of
   the engine's own probabilities, production QUAL-quantile routing, then
   the routed subset through native full-alignment extraction with in-C
   haplotagging, the FA engine and its decode.  No oracle stand-ins.
3. **End-to-end cascade, overlapped**: the same chunks with a 2-deep
   extraction prefetch feeding ``predict_async`` while the previous chunk
   decodes (the production pipeline's structure).

Plus stderr lines: serve-mode throughput (8 concurrent clients through
``serve.EngineServer``'s HTTP front with cross-request coalescing), the
ONT-geometry cascade (depth 89, dwell channel, 0.7/0.1 routing, the
committed ONT nets, 1 Mb), worst-case decode, the host->device copy of this
card host (the engines' forward time beyond device-resident compute, and
the bytes they shipped), and the kernels' launches (``[kernels]``).  Every
timing line follows one ``[bench] device:`` line that names the card and
its power limit.

Baseline: ``E2E_4090_BASELINE``, the reference's published RTX 4090 figure
(~20 min for ONT WGS 30x on 32 CPU threads + an RTX 4090,
docs/gpu_quick_start.md:3, ~= 3 Gb / 1200 s with ~5M pileup candidates ->
~4,200 candidates/s end to end).

The last line on stdout is one JSON object: ``{"metric", "value", "unit",
"vs_baseline"}``.  ``C3T_BENCH_SMOKE=1`` is a wiring check at tiny sizes
(forward batches of 64 and 16 rows, 2 iterations; 0.05 Mb workloads; 2
serve clients of 64 rows): its numbers measure nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

# cand/s: the reference's published RTX 4090 figure (WGS 30x on 32 cores + 4090)
E2E_4090_BASELINE = 4_200.0

GENOME_MB = 2.0
N_CHUNKS = 4

# per-platform routing quantiles (run_clair3.py:304-313), FA geometry
# (shared/param_f.py:11), and the fixtures' training distributions
PLATS = {
    "hifi": dict(var_pct=0.3, ref_pct=0.3, depth=55, channels=8,
                 coverage=25, read_length=900, err=0.02, mv=False,
                 fix_p="pileup_hifi.npz", fix_f="fa_hifi.npz"),
    "ont": dict(var_pct=0.7, ref_pct=0.1, depth=89, channels=9,
                coverage=45, read_length=1200, err=0.04, mv=True,
                fix_p="pileup_ont.npz", fix_f="fa_ont.npz"),
}

VAR_PCT_FULL = PLATS["hifi"]["var_pct"]
MATRIX_DEPTH = PLATS["hifi"]["depth"]


def make_workload(tmp_dir: str, plat=PLATS["hifi"], genome_mb=GENOME_MB):
    """Synthetic case drawn from the fixture nets' training distribution;
    returns (bam, ref, phased_hets, chunks)."""
    from clair3_tpu_torch.fullalign.extractor import PhasedVariant
    from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

    L = int(genome_mb * 1e6)
    ref = random_reference(L, seed=11)
    variants = []
    hets = []
    for p in range(500, L - 500, 700):
        kind = p % 3
        if kind == 0:
            alt = "G" if ref[p] != "G" else "T"
            variants.append(SimVariant(p, ref[p], alt, (0, 1)))
            hets.append(PhasedVariant(p, ref[p], alt, 1, 1))
        elif kind == 1:
            variants.append(SimVariant(p, ref[p], ref[p] + "AC", (0, 1)))
        else:
            variants.append(SimVariant(p, ref[p:p + 3], ref[p], (1, 1)))
    _, bam, _, _ = write_test_case(
        tmp_dir, ref_length=L, variants=variants, coverage=plat["coverage"],
        read_length=plat["read_length"], seed=11, error_rate=plat["err"],
        with_mv_tags=plat["mv"])
    step = L // N_CHUNKS
    chunks = [(i * step, min(L, (i + 1) * step)) for i in range(N_CHUNKS)]
    return bam, ref, hets, chunks


def route_candidates(all_rows, chunks, plat=PLATS["hifi"]):
    """Production QUAL-quantile routing (pipeline/call.py:743-786 math):
    decoded pileup rows -> (var_qual, ref_qual) cutoffs -> low-qual
    positions, re-chunked for the FA stage."""
    from clair3_tpu_torch.pipeline.select import (collect_pileup_stats,
                                            select_qual_from_stats)

    stats = collect_pileup_stats(all_rows)
    var_q, ref_q = select_qual_from_stats(stats, plat["var_pct"],
                                          plat["ref_pct"])
    routed = []
    if "chr1" in stats.qual:
        qual = stats.qual["chr1"]
        low = np.where(stats.ref_call["chr1"], qual < ref_q, qual < var_q)
        routed = sorted(int(p) - 1 for p in stats.pos["chr1"][low])
    spans = []
    for s, e in chunks:
        spans.append([p for p in routed if s <= p < e])
    return spans, (var_q, ref_q)


def run_cascade(bam, ref, hets, chunks, pe, fe, *, overlapped: bool,
                plat=PLATS["hifi"]):
    """One full cascade pass over the chunks; returns (wall_s, details).

    ``overlapped=False``: extract -> sync predict -> decode, chunk by
    chunk (serial composition).  ``overlapped=True``: a 2-deep extraction
    prefetch window feeds predict_async while the previous chunk decodes
    (the production pipeline's structure, call.py:299-345)."""
    from concurrent.futures import ThreadPoolExecutor

    from clair3_tpu_torch.decode import DecodeConfig
    from clair3_tpu_torch.native import (decode_batch_native, fa_region_native,
                                   pileup_region_native)
    from clair3_tpu_torch.pileup.extractor import candidate_tensors

    cfg_p = DecodeConfig(add_indel_length=False, pileup=True, show_ref_calls=True)
    cfg_f = DecodeConfig(add_indel_length=True, pileup=False, show_ref_calls=True)

    def extract_pileup(span):
        s, e = span
        res = pileup_region_native(bam, ref, 0, "chr1", s, e, threads=0)
        return candidate_tensors(res, "chr1")

    def extract_fa(span_cands):
        mat, pos, alts = fa_region_native(
            bam, ref, 0, "chr1", span_cands, variants=hets,
            matrix_depth=plat["depth"], need_haplotagging=True,
            enable_dwell=plat["channels"] == 9)
        pis = [f"chr1:{p + 1}:{ref[max(0, p - 16):p + 17]}" for p in pos]
        return mat, pis, alts

    n_cand = n_fa = n_rows = 0
    timings = {"t_extract": 0.0, "t_forward": 0.0, "t_decode": 0.0,
               "t_fa_extract": 0.0, "t_fa_forward": 0.0, "t_fa_decode": 0.0}

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        timings[key] += time.perf_counter() - t0
        return out

    all_rows = []  # decoded pileup rows (the engine's own probabilities)
    t_wall = time.perf_counter()
    if not overlapped:
        for span in chunks:
            tensors, pis, alts = timed("t_extract", extract_pileup, span)
            probs = timed("t_forward", pe.predict, tensors)
            rows = timed("t_decode", decode_batch_native, pis, alts,
                         probs.astype(np.float64), cfg_p)
            all_rows.extend(rows)
            n_cand += len(pis)
            n_rows += len(rows)
        fa_spans, _ = route_candidates(all_rows, chunks, plat)
        for cands in fa_spans:
            if not cands:
                continue
            mat, pis, alts = timed("t_fa_extract", extract_fa, cands)
            probs = timed("t_fa_forward", fe.predict, mat)
            timed("t_fa_decode", decode_batch_native, pis, alts,
                  probs.astype(np.float64), cfg_f)
            n_fa += len(pis)
    else:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(extract_pileup, s) for s in chunks[:2]]
            pending = None
            for i, span in enumerate(chunks):
                tensors, pis, alts = futs[i].result()
                if i + 2 < len(chunks):
                    futs.append(pool.submit(extract_pileup, chunks[i + 2]))
                handles = pe.predict_async(tensors)
                if pending is not None:
                    p_pis, p_alts, p_handles = pending
                    p_probs = pe.gather(p_handles)
                    rows = decode_batch_native(
                        p_pis, p_alts, p_probs.astype(np.float64), cfg_p)
                    all_rows.extend(rows)
                    n_rows += len(rows)
                pending = (pis, alts, handles)
                n_cand += len(pis)
            p_pis, p_alts, p_handles = pending
            p_probs = pe.gather(p_handles)
            rows = decode_batch_native(p_pis, p_alts,
                                       p_probs.astype(np.float64), cfg_p)
            all_rows.extend(rows)
            n_rows += len(rows)
        fa_spans, _ = route_candidates(all_rows, chunks, plat)
        fa_spans = [c for c in fa_spans if c]
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(extract_fa, c) for c in fa_spans[:2]]
            pending = None
            for i, cands in enumerate(fa_spans):
                mat, pis, alts = futs[i].result()
                if i + 2 < len(fa_spans):
                    futs.append(pool.submit(extract_fa, fa_spans[i + 2]))
                handles = fe.predict_async(mat)
                if pending is not None:
                    p_pis, p_alts, p_handles = pending
                    p_probs = fe.gather(p_handles)
                    decode_batch_native(p_pis, p_alts,
                                        p_probs.astype(np.float64), cfg_f)
                pending = (pis, alts, handles)
                n_fa += len(pis)
            if pending is not None:
                p_pis, p_alts, p_handles = pending
                p_probs = fe.gather(p_handles)
                decode_batch_native(p_pis, p_alts,
                                    p_probs.astype(np.float64), cfg_f)
    wall = time.perf_counter() - t_wall
    details = {"candidates": n_cand, "fa_candidates": n_fa, "rows": n_rows}
    if not overlapped:
        details.update({k: round(v, 3) for k, v in timings.items()})
    return wall, details


def bench_oracle_decode(tmp_dir: str):
    """Worst-case decode microbench: near-uniform (untrained-like)
    probabilities maximize the decoder's argmax-fallback work.  Reported to
    stderr only — the headline path decodes the engine's own outputs."""
    from clair3_tpu_torch.decode import DecodeConfig
    from clair3_tpu_torch.native import decode_batch_native

    rng = np.random.RandomState(3)
    n = 20_000
    probs = rng.dirichlet(np.ones(21) * 2.0, n)
    zyg = rng.dirichlet(np.ones(3) * 2.0, n)
    probs = np.concatenate([probs, zyg], axis=1)
    pis = [f"chr1:{i + 1000}:ACGTACGTACGTACGTNACGTACGTACGTACGT" for i in range(n)]
    alts = [f"25-{i % 3}-A 12 C 8-0.5" for i in range(n)]
    cfg = DecodeConfig(add_indel_length=False, pileup=True, show_ref_calls=True)
    t0 = time.perf_counter()
    decode_batch_native(pis, alts, probs, cfg)
    dt = time.perf_counter() - t0
    print(f"[bench] worst-case decode (near-uniform probs): "
          f"{n / dt:,.0f} rows/s", file=sys.stderr)


# the wiring check's sizes (C3T_BENCH_SMOKE=1) and the bench's own
SMOKE = {"forward": ((64, 2), (16, 2)), "genome_mb": 0.05, "ont_mb": 0.05,
         "serve": (2, 2, 64)}
FULL = {"forward": ((8192, 30), (2048, 30)), "genome_mb": GENOME_MB, "ont_mb": 1.0,
        "serve": (8, 4, 1024)}


def sizes() -> dict:
    return SMOKE if os.environ.get("C3T_BENCH_SMOKE") == "1" else FULL


def bench_forward(model, stage_batch, batch: int, iters: int) -> float:
    """Candidates/sec of ``model`` over ``iters`` on-device batches.

    ``stage_batch()`` materializes one realistic batch on the device; each
    iteration adds the loop index mod 3 to it (one cheap elementwise add),
    so the forward cannot be hoisted, and adds the sum of the FULL output
    to a device scalar, so no row's work can be skipped; one ``.item()``
    returns to the host at the end.  The loop is a host-side Python loop
    under ``inference_mode``: the kernels' own launches are what is timed
    (no ``torch.compile``, no CUDA graph).  Best of 3 timed runs after one
    warm run."""
    x0 = stage_batch()

    def run() -> float:
        with torch.inference_mode():
            total = torch.zeros((), dtype=torch.float32, device=x0.device)
            for i in range(iters):
                total += model(x0 + (i % 3)).float().sum()
            return total.item()

    run()  # warm: kernel builds, library initialisation, first launches
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return batch * iters / best


def build_production_engines(device="cuda", plat=PLATS["hifi"]):
    """The engines ``cli call`` builds (``cli._load_engine``), each batch
    split over every visible card: bf16 on a GPU (f32 on the CPU); the
    pileup net on its kernels with int16 transfer and
    the compact form; the FA net on cuDNN with the depth crop and the
    compact form (its conv1 kernel stays opt-in: ``CLAIR3T_ENABLE_FA_CONV1``),
    loaded with the committed fixture checkpoints of ``plat``, so the
    decode stage consumes trained-net probabilities.  A missing fixture
    raises (no random weights)."""
    from clair3_tpu_torch import wgs_scale_demo
    from clair3_tpu_torch.testing import trained_fixture_path

    return wgs_scale_demo.build_production_engines(
        trained_fixture_path(plat["fix_p"]), trained_fixture_path(plat["fix_f"]), device)


def bench_serve(pe, n_clients: int = 8, iters: int = 4, rows: int = 1024) -> None:
    """Serve-mode throughput: the production pileup engine behind
    ``serve.EngineServer``'s HTTP front, hammered by ``n_clients``
    concurrent clients of ``iters`` requests of ``rows`` rows.  Measures the
    full remote path (npy serialization, HTTP loopback, cross-request
    coalescing, engine forward) and reports the coalescing from the
    server's own ``/stats`` counters."""
    import threading

    from clair3_tpu_torch.serve import EngineServer, RemoteEngine

    srv = EngineServer({"pileup": pe}, port=0)
    srv.serve_background()
    try:
        x = np.random.RandomState(5).randint(-30, 30, (rows, 33, 18)).astype(np.int32)
        clients = [RemoteEngine(srv.address, "pileup") for _ in range(n_clients)]
        clients[0].predict(x)  # warmup
        base = srv.stats()["pileup"]
        start = threading.Barrier(n_clients + 1)
        errors = []

        def worker(c):
            try:
                start.wait()
                for _ in range(iters):
                    c.predict(x)
            except Exception as exc:  # re-raised below, after the join
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(c,)) for c in clients]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        s = srv.stats()["pileup"]
    finally:
        srv.shutdown()
    reqs = s["requests"] - base["requests"]
    batches = s["batches"] - base["batches"]
    total = n_clients * iters * rows
    print(f"[bench] serve mode: {n_clients} concurrent clients, "
          f"{total / dt:,.0f} rows/s over HTTP loopback "
          f"({reqs} requests coalesced into {batches} forwards)",
          file=sys.stderr)


def bench_ont_e2e(device, tmp_dir: str, genome_mb: float = 1.0):
    """ONT-geometry cascade: depth-89 / 9-channel FA tensors with the dwell
    channel parsed from simulated mv:B:c tags, ONT routing quantiles
    (0.7/0.1), through the committed ONT fixtures.  One serial pass at
    ``genome_mb``, stderr only (the headline stays the hifi best-of-N)."""
    plat = PLATS["ont"]
    pe, fe = build_production_engines(device, plat)
    bam, ref, hets, chunks = make_workload(tmp_dir, plat, genome_mb=genome_mb)
    pe.warmup((33, 18), np.int32)
    fe.warmup((plat["depth"], 33, plat["channels"]), np.int8)
    wall, details = run_cascade(bam, ref, hets, chunks, pe, fe,
                                overlapped=False, plat=plat)
    print(f"[bench] ONT e2e cascade (depth 89, dwell channel, 0.7/0.1 "
          f"routing, serial 1 pass, {genome_mb} Mb): {wall:.2f}s = "
          f"{details['candidates'] / wall:,.0f} candidates/s "
          f"({details['fa_candidates']} routed to FA) {details}",
          file=sys.stderr)
    return wall, details


def kernel_counts() -> dict:
    """The pileup kernels' launches (L1/L2/L3 of the bf16 route, the f32
    SIMT kernel), the plain pileup forwards that ran on the card, and the FA
    conv1 kernel's launches, since the process started."""
    from clair3_tpu_torch.models import pileup as pileup_model
    from clair3_tpu_torch.ops import fa_conv1, pileup_full

    return {**pileup_full.kernel_launches, "fa_conv1": fa_conv1.launches,
            "plain_cuda_forwards": pileup_model.plain_cuda_forwards}


def main(argv=None) -> int:
    from clair3_tpu_torch.decode import shutdown_decode_pool
    from clair3_tpu_torch.device import resolve_device
    from clair3_tpu_torch.wgs_scale_demo import device_label

    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the engines; cuda raises when no GPU is present")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    try:
        with tempfile.TemporaryDirectory(prefix="c3t_bench_") as d:
            return run(device, d, device_label(device))
    finally:
        shutdown_decode_pool()


def run(device, tmp_dir: str, label: str) -> int:
    size = sizes()
    pe, fe = build_production_engines(device)
    # each engine batch is split over every visible card, as the JAX
    # bench's engines shard it over the mesh: its rates are "per card"
    n_dev = len(pe.devices)
    print(f"[bench] device: {label}; {n_dev} device(s): "
          f"{', '.join(map(str, pe.devices))}", file=sys.stderr)

    (B_P, ITERS_P), (B_F, ITERS_F) = size["forward"]

    def stage_pileup():
        return torch.from_numpy(np.random.RandomState(0).randint(
            -30, 30, (B_P, 33, 18)).astype(np.int32)).to(device)

    pileup_cps = bench_forward(pe.model, stage_pileup, B_P, ITERS_P)
    print(f"[bench] pileup forward (production config, B={B_P}): "
          f"{pileup_cps:,.0f} candidates/s", file=sys.stderr)

    # FA capacity at the harder ONT shape (depth 89), as the JAX bench
    # measures it; the e2e cascade below runs the hifi shape (depth 55)
    def stage_fa():
        return torch.from_numpy(np.random.RandomState(1).randint(
            -100, 100, (B_F, 89, 33, 8)).astype(np.int8)).to(device)

    fa_cps = bench_forward(fe.model, stage_fa, B_F, ITERS_F)
    print(f"[bench] full-alignment forward (depth 89, B={B_F}; see "
          f"clair3_tpu_torch.bench_fa_conv1): {fa_cps:,.0f} candidates/s",
          file=sys.stderr)

    fwd_combined = 1.0 / (1.0 / pileup_cps + VAR_PCT_FULL / fa_cps)
    print(f"[bench] forward-only cascade capacity: {fwd_combined:,.0f} candidates/s "
          f"({fwd_combined / n_dev:,.0f}/card)", file=sys.stderr)

    bench_serve(pe, *size["serve"])

    bench_oracle_decode(tmp_dir)
    genome_mb = size["genome_mb"]
    os.makedirs(os.path.join(tmp_dir, "hifi"))
    bam, ref, hets, chunks = make_workload(os.path.join(tmp_dir, "hifi"),
                                           genome_mb=genome_mb)
    # run every engine route once before timing (production warms up
    # beside extraction; here timing stays clean)
    pe.warmup((33, 18), np.int32)
    fe.warmup((MATRIX_DEPTH, 33, 8), np.int8)
    shipped = [(e.bytes_shipped, e.dense_bytes) for e in (pe, fe)]

    # serial composition: best of 3 passes
    serial_wall, serial_details = run_cascade(
        bam, ref, hets, chunks, pe, fe, overlapped=False)
    for _ in range(2):
        w2, d2 = run_cascade(bam, ref, hets, chunks, pe, fe, overlapped=False)
        if w2 < serial_wall:
            serial_wall, serial_details = w2, d2
    print(f"[bench] serial cascade: {serial_wall:.2f}s "
          f"{serial_details}", file=sys.stderr)

    over_wall, over_details = run_cascade(
        bam, ref, hets, chunks, pe, fe, overlapped=True)
    for _ in range(2):
        w2, _ = run_cascade(bam, ref, hets, chunks, pe, fe, overlapped=True)
        over_wall = min(over_wall, w2)

    n = over_details["candidates"]
    speedup = serial_wall / over_wall
    print(
        f"[bench] overlapped cascade: {over_wall:.2f}s = {n / over_wall:,.0f} "
        f"candidates/s, {genome_mb / over_wall:.2f} Mbases/s "
        f"(overlap speedup {speedup:.2f}x vs serial; "
        f"{over_details['fa_candidates']} candidates QUAL-routed to FA)",
        file=sys.stderr,
    )
    best_wall = min(over_wall, serial_wall)
    best_name = "overlapped" if over_wall <= serial_wall else "serial"
    e2e_cps = n / best_wall

    # the host->device copy of this card host: the engines' measured
    # forward time minus the device-resident compute for the same candidate
    # counts, beside the bytes the engines handed to the copy (post
    # pack/pad) over the 6 cascade passes above (3 serial + 3 overlapped)
    fa_cps_55 = fa_cps * 89.0 / MATRIX_DEPTH  # conv FLOPs scale with depth
    t_compute = n / pileup_cps + over_details["fa_candidates"] / fa_cps_55
    t_transfer = max(
        0.0,
        serial_details["t_forward"] + serial_details["t_fa_forward"] - t_compute)
    moved = [(e.bytes_shipped - b0, e.dense_bytes - d0)
             for e, (b0, d0) in zip((pe, fe), shipped)]
    mb_moved = sum(b for b, _ in moved) / 1e6 / 6
    print(
        f"[bench] host->device copy of this card host: ~{mb_moved:.1f} MB of candidate "
        f"tensors per pass took ~{t_transfer:.3f}s of the {serial_wall:.2f}s serial wall "
        f"beyond device-resident compute ({mb_moved / max(t_transfer, 1e-9):.0f} MB/s "
        f"effective; pack, pad, pinned copy and unpack included)",
        file=sys.stderr,
    )
    for kind, (b, dense) in zip(("pileup", "full_alignment"), moved):
        print(f"[bench] bytes_shipped {kind}: {b} against {dense} dense "
              f"({b / max(dense, 1):.4f}x) over the 6 passes", file=sys.stderr)

    os.makedirs(os.path.join(tmp_dir, "ont"))
    bench_ont_e2e(device, os.path.join(tmp_dir, "ont"), size["ont_mb"])

    print(f"[kernels] {json.dumps(kernel_counts())}")
    per_card = e2e_cps / n_dev
    print(json.dumps({
        "metric": ("e2e cascade candidates/s/card, production path with no "
                   "stand-ins (best of serial/overlapped composition, here "
                   "%s) on %s: native extract + %s engine infer (committed "
                   "fixture checkpoints) + compact wire forms + pinned "
                   "host->device copies + native decode of the engine's own "
                   "probabilities + production QUAL-quantile FA routing + "
                   "in-C haplotagging FA; vs the reference's published RTX "
                   "4090 figure; see stderr for the host->device copy and "
                   "forward capacity"
                   % (best_name, label,
                      "bf16" if pe.model.compute_dtype == torch.bfloat16 else "f32")),
        "value": round(per_card, 1),
        "unit": "candidates/s/card",
        "vs_baseline": round(per_card / E2E_4090_BASELINE, 3),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
