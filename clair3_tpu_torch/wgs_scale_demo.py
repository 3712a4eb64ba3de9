"""WGS-scale soak of the port, the twin of ``scripts/wgs_scale_demo.py``:
multi-contig, 30x, gVCF-on end-to-end run with peak-RSS and per-stage
wall-clock accounting, on ``--device`` (default ``cuda``).

    python -m clair3_tpu_torch.wgs_scale_demo --mbases 50 --contigs 3 --coverage 30
    python -m clair3_tpu_torch.wgs_scale_demo --engines production --platform hifi \\
        --coverage 25 --read_length 900 --parity_mbases 1

Simulation streams per 2 Mb segment through a generator into the BAM
writer, so building the input itself stays in bounded memory.  The input
simulation, the arguments, the calling configuration and the gates (site recall
>= 0.95, SNP F1 >= 0.95, INDEL F1 >= 0.90, peak RSS <= --max_rss_gb,
contig-ordered output with a .tbi, a gVCF with no structural violation) are
the JAX script's.  ``production`` engines are the port CLI's
(``cli._load_engine``: bf16 and the pileup kernels on a GPU unless
``--compute_dtype`` says otherwise); their parity oracle is
``testing.TorchCpuEngine``, the plain nets at f32 on the CPU.  On a GPU every
timing line names the card and its power limit; with production engines
the pileup kernels' launches are printed after the call (none on the
CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import torch

from clair3_tpu_torch.config import CallConfig
from clair3_tpu_torch.device import resolve_device
from clair3_tpu_torch.io.vcf import VcfReader
from clair3_tpu_torch.testing import (
    FullAlignmentOracleEngine,
    PileupOracleEngine,
    SimVariant,
    random_reference,
    simulate_reads,
)

SEG = 2_000_000  # simulation segment (bounds sim memory)


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def build_input(out_dir: str, mbases: float, contigs: int, coverage: int,
                read_length: int, error_rate: float, seed: int,
                with_mv_tags: bool = False, reuse: bool = False):
    """Multi-contig FASTA + coordinate-sorted indexed BAM + truth list,
    streamed segment by segment.  With ``reuse``, an existing ref.fa +
    reads.bam pair in out_dir is kept as-is (everything is deterministic
    in the seed, so the truth list is reconstructed without re-simulating
    the reads — re-timing the calling phase only)."""
    from clair3_tpu_torch.io.bam import write_bam

    per_ctg = int(mbases * 1e6 / contigs)
    names = [f"chr{i + 1}" for i in range(contigs)]
    lengths = [per_ctg] * contigs
    fasta = os.path.join(out_dir, "ref.fa")
    bam = os.path.join(out_dir, "reads.bam")
    reuse = (reuse and os.path.exists(fasta) and os.path.exists(bam)
             and os.path.exists(bam + ".bai"))
    truth = []
    refs = {}
    for ci, name in enumerate(names):
        refs[name] = random_reference(per_ctg, seed=seed + ci)
    if not reuse:
        with open(fasta, "w") as f:
            for ci, name in enumerate(names):
                f.write(f">{name}\n")
                seq = refs[name]
                for off in range(0, per_ctg, 80):
                    f.write(seq[off: off + 80] + "\n")

    def variants_for(name, seq, ci):
        out = []
        for p in range(500, per_ctg - 500, 1500):
            # NOT p % 3: the 1500 step is 0 mod 3, which made every
            # variant the same kind (pre-r03 the soak was all-deletions)
            kind = (p // 1500) % 3
            if kind == 0:
                out.append(SimVariant(p, seq[p], "G" if seq[p] != "G" else "T",
                                      (0, 1) if p % 2 else (1, 1)))
            elif kind == 1:
                out.append(SimVariant(p, seq[p], seq[p] + "AC", (0, 1)))
            else:
                out.append(SimVariant(p, seq[p:p + 3], seq[p], (1, 1)))
        return out

    all_variants = {}
    for ci, name in enumerate(names):
        vs = variants_for(name, refs[name], ci)
        all_variants[name] = vs
        truth.extend((name, v) for v in vs)

    def read_stream():
        for ci, name in enumerate(names):
            seq = refs[name]
            vs = all_variants[name]
            for lo in range(0, per_ctg, SEG):
                hi = min(per_ctg, lo + SEG)
                # margin so segment-boundary reads exist exactly once
                seg_vs = [SimVariant(v.pos - lo, v.ref, v.alt, v.genotype)
                          for v in vs if lo <= v.pos < hi]
                reads = simulate_reads(
                    seq[lo:hi], seg_vs, coverage=coverage,
                    read_length=read_length, seed=seed + ci * 1000 + lo,
                    error_rate=error_rate, contig=name,
                    with_mv_tags=with_mv_tags)
                for r in reads:
                    r = type(r)(r.qname + f".{ci}.{lo}", r.flag, ci,
                                r.pos + lo, r.mapq, r.cigar, r.seq, r.qual,
                                r.tags)
                    yield r

    if reuse:
        from clair3_tpu_torch.io.fasta import FastaFile

        fa = FastaFile(fasta)
        assert (list(fa.references) == names
                and [fa.contig_length(n) for n in names] == lengths), (
            "existing fixture geometry does not match --mbases/--contigs; "
            "remove the output dir or drop --reuse_input")
        fa.close()
        print("[soak] reusing existing ref.fa + reads.bam (truth "
              "reconstructed from the seed)", flush=True)
    else:
        write_bam(bam, names, lengths, read_stream())
    return fasta, bam, names, truth


def build_production_engines(pileup_model: str, fa_model: str, device="cuda",
                             compute_dtype: str = "auto"):
    """The port CLI's shipped engine configuration (bf16 and the pileup
    kernels on a GPU, compact wire forms, the FA depth crop) carrying
    TRAINED checkpoints, on ``device``: with ``cuda`` each batch is split
    over every visible card (``cli._load_engine``)."""
    from clair3_tpu_torch.cli import _load_engine, resolve_compute_dtype

    dev = resolve_device(device)
    dt = resolve_compute_dtype(compute_dtype, dev)
    return (_load_engine(pileup_model, "pileup", dev, dt),
            _load_engine(fa_model, "full_alignment", dev, dt))


def build_cpu_twin_engines(pileup_model: str, fa_model: str):
    """f32 host-CPU twins of the production engines (same weights,
    independent execution path) — the soak parity oracle."""
    from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
    from clair3_tpu_torch.models.params_io import load_variables
    from clair3_tpu_torch.testing import TorchCpuEngine

    vp = load_variables(pileup_model)
    vf = load_variables(fa_model)
    in_ch = vf["params"]["conv1"]["conv"]["kernel"].shape[2]
    return (TorchCpuEngine(PileupNet(add_indel_length=False), vp),
            TorchCpuEngine(FullAlignmentNet(add_indel_length=True,
                                            input_channels=in_ch), vf))


def production_config(args, fasta: str, bam: str, output_dir: str) -> CallConfig:
    """The soak's calling configuration with trained nets: gVCF on, no
    phasing for the FA stage, the platform's geometry and routing (hifi:
    depth 55 / 8 channels; ont: depth 89 / 9 channels, the dwell channel)."""
    ont = args.platform == "ont"
    return CallConfig(
        platform=args.platform, bam_fn=bam, ref_fn=fasta, output_dir=output_dir,
        gvcf=True, no_phasing_for_fa=True, threads=args.threads,
        enable_dwell_time=ont,
        **(dict(indel_min_af=0.15, var_pct_full=0.7, ref_pct_full=0.1)
           if ont else
           dict(indel_min_af=0.12, var_pct_full=0.3, ref_pct_full=0.3)))


def _vcf_body(path: str):
    from clair3_tpu_torch.io.bgzf import decompress

    return [l for l in decompress(path).decode().splitlines()
            if l and not l.startswith("#")]


def device_label(device: torch.device) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi`` prints
    them."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        return smi[device.index or 0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def run_parity_slice(args):
    """Call the same small genome through the production engines AND their
    f32 CPU twins; assert structurally identical merged rows (every discrete
    field byte-identical — alleles, genotypes, filters, DP/AD/AF — and
    QUAL/GQ/PL within one printed unit; bf16-vs-f32 makes exact byte
    identity unattainable for the probability-derived decimals).  Returns
    the comparison's stats."""
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from clair3_tpu_torch.testing import vcf_rows_numerically_equivalent

    d = os.path.join(args.output, "parity")
    os.makedirs(d, exist_ok=True)
    ont = args.platform == "ont"
    print(f"[soak] parity slice: {args.parity_mbases} Mb ({args.platform}), "
          f"production engines vs f32 CPU twins ...", flush=True)
    fasta, bam, names, truth = build_input(
        d, args.parity_mbases, 1, args.coverage, args.read_length,
        args.error_rate, seed=23, with_mv_tags=ont)
    rows = {}
    for mode in ("production", "cpu_twin"):
        if mode == "production":
            pe, fe = build_production_engines(args.pileup_model, args.fa_model,
                                              args.device, args.compute_dtype)
        else:
            pe, fe = build_cpu_twin_engines(args.pileup_model, args.fa_model)
        cfg = production_config(args, fasta, bam, os.path.join(d, mode))
        outputs = VariantCaller(cfg, pileup_engine=pe, fa_engine=fe).run()
        rows[mode] = _vcf_body(outputs["merge_output"])
    a, b = rows["production"], rows["cpu_twin"]
    # flip_budget: candidates sitting exactly at the QUAL-quantile routing
    # cutoff can route to FA in one run and not the other (bf16-vs-f32
    # noise made discrete); the call itself must still agree on those rows
    ok, stats = vcf_rows_numerically_equivalent(a, b, qual_tol=1.0,
                                                flip_budget=0.005)
    if not ok:
        for v in stats["violations"]:
            print(f"[soak] parity violation: {v}")
        raise AssertionError(
            f"parity slice rows differ structurally: {stats['violations']}")
    print(f"[soak] parity slice OK: {len(a)} rows, discrete fields "
          f"byte-identical on all same-route rows; max deltas "
          f"QUAL {stats['max_dqual']:.3f}, GQ {stats['max_dgq']}, "
          f"PL {stats['max_dpl']}; {stats['flips']} routing-boundary flips "
          f"(calls agree) (production engines on {device_label(resolve_device(args.device))} "
          f"vs f32 CPU twins)", flush=True)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.wgs_scale_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mbases", type=float, default=50.0)
    ap.add_argument("--contigs", type=int, default=3)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read_length", type=int, default=5000)
    ap.add_argument("--error_rate", type=float, default=0.02)
    ap.add_argument("--output", default="wgs_soak_out")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--max_rss_gb", type=float, default=8.0,
                    help="fail if peak RSS exceeds this")
    ap.add_argument("--engines", choices=["oracle", "production"],
                    default="oracle",
                    help="oracle: numpy stand-in engines (no net); "
                         "production: the port CLI's engines with the "
                         "committed trained checkpoints on --device")
    ap.add_argument("--platform", choices=["hifi", "ont"], default="hifi",
                    help="production-engine geometry: hifi (depth 55, 8ch) "
                         "or ont (depth 89, 9ch dwell from simulated mv "
                         "tags); pair with --coverage/--error_rate matching "
                         "the fixtures' training distribution")
    ap.add_argument("--pileup_model", default=None,
                    help="default: the committed trained fixture for "
                         "--platform")
    ap.add_argument("--fa_model", default=None)
    ap.add_argument("--reuse_input", action="store_true",
                    help="keep an existing ref.fa/reads.bam in --output "
                         "(same seed => same truth) and re-time calling only")
    ap.add_argument("--parity_mbases", type=float, default=0.0,
                    help="also run this many Mb through BOTH the production "
                         "engines and their f32 CPU twins and assert "
                         "structurally identical merged rows")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the production engines; cuda raises when "
                         "no GPU is present")
    ap.add_argument("--compute_dtype", default="auto",
                    choices=("auto", "fp32", "bf16"),
                    help="production engines' compute dtype; auto = bf16 on "
                         "CUDA, fp32 on the CPU (the CLI's)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    try:
        return soak(args)
    finally:
        from clair3_tpu_torch.decode import shutdown_decode_pool

        shutdown_decode_pool()


def soak(args) -> int:
    """The parity slice when asked, then the soak and its gates."""
    from clair3_tpu_torch.testing import trained_fixture_path

    device = resolve_device(args.device)
    label = device_label(device)
    if args.pileup_model is None:
        args.pileup_model = trained_fixture_path(f"pileup_{args.platform}.npz")
    if args.fa_model is None:
        args.fa_model = trained_fixture_path(f"fa_{args.platform}.npz")
    ont = args.platform == "ont"

    os.makedirs(args.output, exist_ok=True)
    print(f"[soak] device: {label}", flush=True)
    if args.parity_mbases > 0:
        run_parity_slice(args)
    t0 = time.time()
    print(f"[soak] simulating {args.mbases} Mb x {args.coverage}x over "
          f"{args.contigs} contigs ({args.platform} geometry) ...", flush=True)
    fasta, bam, names, truth = build_input(
        args.output, args.mbases, args.contigs, args.coverage,
        args.read_length, args.error_rate, seed=7,
        with_mv_tags=ont and args.engines == "production",
        reuse=args.reuse_input)
    t_sim = time.time() - t0
    print(f"[soak] simulation: {t_sim:.2f}s, BAM "
          f"{os.path.getsize(bam) / 1e6:.0f} MB, RSS {peak_rss_gb():.2f} GB",
          flush=True)

    if args.engines == "production":
        p_engine, f_engine = build_production_engines(
            args.pileup_model, args.fa_model, device, args.compute_dtype)
        cfg = production_config(args, fasta, bam, os.path.join(args.output, "call"))
    else:
        p_engine, f_engine = PileupOracleEngine(), FullAlignmentOracleEngine()
        cfg = CallConfig(
            platform="ont", bam_fn=bam, ref_fn=fasta,
            output_dir=os.path.join(args.output, "call"),
            gvcf=True, no_phasing_for_fa=True, threads=args.threads,
            var_pct_full=0.3, ref_pct_full=0.1,
        )
    from clair3_tpu_torch.models import pileup as pileup_model
    from clair3_tpu_torch.ops import pileup_full
    from clair3_tpu_torch.pipeline.call import VariantCaller

    caller = VariantCaller(cfg, pileup_engine=p_engine, fa_engine=f_engine)
    pileup_full.kernel_launches.update(dict.fromkeys(pileup_full.kernel_launches, 0))
    pileup_model.plain_cuda_forwards = 0
    t1 = time.time()
    outputs = caller.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_call = time.time() - t1
    rss = peak_rss_gb()
    print(f"[soak] calling: {t_call:.2f}s "
          f"({args.mbases / max(t_call, 1e-9) * 60:.1f} Mb/min), "
          f"peak RSS {rss:.2f} GB ({label})", flush=True)
    print(f"[soak] stage times: "
          f"{ {k: round(v, 1) for k, v in caller.stage_times.items()} }",
          flush=True)
    if args.engines == "production":
        print(f"[soak] pileup kernel launches {json.dumps(pileup_full.kernel_launches)}, "
              f"plain pileup forwards on the card {pileup_model.plain_cuda_forwards} "
              f"({label})", flush=True)

    # --- verification ---
    recs = list(VcfReader(outputs["merge_output"]))
    # contig-ordered output
    order = {n: i for i, n in enumerate(names)}
    keys = [(order[r.chrom], r.pos) for r in recs]
    assert keys == sorted(keys), "output not contig-ordered"
    # indexed
    assert os.path.exists(outputs["merge_output"] + ".tbi"), "missing .tbi"
    assert "merge_output_gvcf" in outputs, "gVCF missing"
    # recall of simulated variants
    called = {(r.chrom, r.pos) for r in recs}
    hits = sum(1 for ctg, v in truth if (ctg, v.pos + 1) in called)
    recall = hits / max(len(truth), 1)
    print(f"[soak] truth sites: {len(truth)}, called rows: {len(recs)}, "
          f"site recall: {recall:.4f}", flush=True)
    # precision / recall / F1, genotype-exact, per variant class
    from clair3_tpu_torch.io.vcf import VcfRecord
    from clair3_tpu_torch.postprocess import variant_metrics

    truth_recs = [
        VcfRecord(ctg, v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                  "1/1" if tuple(sorted(v.genotype)) == (1, 1) else "0/1")
        for ctg, v in truth
    ]
    m = variant_metrics(truth_recs, recs)
    header = ["VariantType", "FP", "FN", "TP", "Precision", "Recall", "F1-score"]
    print("".join(h.ljust(13) for h in header))
    for vt in ("SNP", "INDEL"):
        r = m[vt]
        print("".join(str(x).ljust(13) for x in (
            vt, r.query_fp, r.truth_fn, r.truth_tp, r.precision, r.recall,
            r.f1)), flush=True)
    # structural gVCF validation (GATK-ValidateVariants-equivalent): block
    # continuity, END ordering, PL/GQ consistency, header contract
    from clair3_tpu_torch.gvcf_validate import GvcfValidator, _open_rows

    per_ctg = int(args.mbases * 1e6 / args.contigs)
    v = GvcfValidator(regions=[(n, 0, per_ctg) for n in names])
    for line in _open_rows(outputs["merge_output_gvcf"]):
        v.feed(line)
    problems = [p for p in v.collect()
                # head/tail of each contig may be uncovered by reads
                if not ("coverage gap" in p and
                        (":1-" in p.split("gap ")[-1]
                         or p.rstrip().endswith(f"-{per_ctg}")
                         or f"ended at {per_ctg}" in p))]
    s = v.stats
    print(f"[soak] gVCF validator: {s['rows']} rows ({s['blocks']} blocks), "
          f"{len(problems)} violations", flush=True)
    for p in problems[:10]:
        print(f"[soak]   {p}")
    assert not problems, f"gVCF structural violations: {len(problems)}"

    assert recall >= 0.95, f"recall {recall:.3f} too low"
    assert m["SNP"].f1 >= 0.95, f"SNP F1 {m['SNP'].f1} too low"
    assert m["INDEL"].f1 >= 0.90, f"INDEL F1 {m['INDEL'].f1} too low"
    assert rss <= args.max_rss_gb, f"peak RSS {rss:.2f} GB > {args.max_rss_gb}"
    print(f"[soak] OK [{args.engines} engines] — total "
          f"{time.time() - t0:.2f}s, peak RSS {rss:.2f} GB ({label})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
