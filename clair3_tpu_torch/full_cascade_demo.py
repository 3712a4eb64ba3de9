"""Full-cascade acceptance run of the port, the twin of
``scripts/full_cascade_demo.py``: train BOTH nets from scratch on simulated
data on ``--device`` (default ``cuda``), then call a held-out region through
the port's production loader (``cli._load_engine``: the pileup net through
its kernels, at bf16 on a GPU, each batch split over every visible card)
with the complete two-stage pipeline, and
score genotype-exact SNP/INDEL F1 against the simulation's truth.

    python -m clair3_tpu_torch.full_cascade_demo OUT [hifi|ont] [--device cpu]

The simulation (seed 7, a variant every 130 bp), labels, bins, training
configs, ``C3T_DEMO_*`` scale knobs and their defaults (260 kb, training on
the first 220 kb, 400/300 steps at batch 1000/500) and the scale-keyed F1
gates are the JAX demo's.  Bins are written as HDF5 when h5py imports;
otherwise the same arrays are trained from memory (``testing.ArrayDataset``:
the same chunks, offsets and batches).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from clair3_tpu_torch.device import resolve_device


@dataclass
class DemoSetup:
    """The simulated genome, its training data and the demo's scale."""

    out_dir: str
    platform: str
    L: int
    train_end: int
    eval_start: int
    steps: Dict[str, int]
    batch: Dict[str, int]
    fasta: str
    bam: str
    variants: list
    datasets: Dict[str, object] = field(default_factory=dict)  # "pileup"/"fa" -> dataset
    bins: Dict[str, str] = field(default_factory=dict)         # written when h5py imports


def _have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def train_configs(setup: DemoSetup):
    """The JAX demo's two ``TrainConfig``s."""
    from clair3_tpu_torch.config import TrainConfig

    p_cfg = TrainConfig(pileup=True, add_indel_length=False, batch_size=setup.batch["pileup"],
                        chunk_size_pileup=100, max_epoch=60, seed=0,
                        early_stop_patience=15)
    f_cfg = TrainConfig(pileup=False, add_indel_length=True, batch_size=setup.batch["fa"],
                        chunk_size_fa=100, max_epoch=60, seed=0,
                        early_stop_patience=15)
    return {"pileup": p_cfg, "fa": f_cfg}


def prepare(out_dir: str, platform: str = None) -> DemoSetup:
    """Simulate the genome and build both nets' labelled training data from
    its first ``C3T_DEMO_TRAIN_END`` bases."""
    from clair3_tpu_torch.fullalign.extractor import create_fa_tensors
    from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
    from clair3_tpu_torch.testing import PLATFORMS, ArrayDataset, simulate
    from clair3_tpu_torch.train.data import BinDataset, TruthVariant, build_labels, write_bin

    os.makedirs(out_dir, exist_ok=True)
    platform = platform or os.environ.get("C3T_DEMO_PLATFORM", "hifi")
    P = PLATFORMS[platform]
    dwell = P["channels"] == 9
    # scale knobs (env): larger runs give stronger accuracy evidence
    L = int(os.environ.get("C3T_DEMO_L", 260_000))
    train_end = int(os.environ.get("C3T_DEMO_TRAIN_END", L - 40_000))
    print(f"[full] simulating {L // 1000}kb diploid genome "
          f"({platform} geometry) -> {out_dir}")
    fasta, bam, _, variants = simulate(out_dir, L, platform=platform)
    setup = DemoSetup(
        out_dir=out_dir, platform=platform, L=L, train_end=train_end,
        eval_start=int(os.environ.get("C3T_DEMO_EVAL_START", train_end)),
        steps={"pileup": int(os.environ.get("C3T_DEMO_STEPS_P", 400)),
               "fa": int(os.environ.get("C3T_DEMO_STEPS_F", 300))},
        batch={"pileup": int(os.environ.get("C3T_DEMO_BATCH_P", 1000)),
               "fa": int(os.environ.get("C3T_DEMO_BATCH_F", 500))},
        fasta=fasta, bam=bam, variants=variants)
    truths = [TruthVariant("chr1", v.pos + 1, v.ref, v.alt, *sorted(v.genotype))
              for v in variants]

    print("[full] pileup tensors + labels")
    p_tensors, p_pos, p_alt, _ = create_pileup_tensors(
        bam, fasta, "chr1", 1, train_end, min_snp_af=P["snp_min_af"],
        min_indel_af=P["indel_min_af"])
    labels, keep = build_labels(p_pos, truths, maximum_non_variant_ratio=5.0)
    data = {"pileup": (p_tensors[keep], labels[keep], [x for x, k in zip(p_pos, keep) if k],
                       [x for x, k in zip(p_alt, keep) if k])}

    print("[full] full-alignment tensors (haplotagged) + labels")
    # phased het SNPs from the simulation truth: haplotype 0 carries the alt
    # for gt (1,0) -> extractor genotype code 2; gt (0,1) -> code 1
    phased = [
        (v.pos + 1, f"{v.ref}-{v.alt}-{1 if v.genotype == (0, 1) else 2}-1")
        for v in variants
        if len(v.ref) == 1 and len(v.alt) == 1 and v.genotype in ((0, 1), (1, 0))
    ]
    cand_positions = [int(p.split(":")[-2]) for p in p_pos]
    f_tensors, f_pos, f_alt = create_fa_tensors(
        bam, fasta, "chr1", cand_positions, phased_snps=phased,
        matrix_depth=P["matrix_depth"], no_phasing=False, enable_dwell=dwell)
    f_labels, f_keep = build_labels(
        f_pos, truths,
        maximum_non_variant_ratio=float(os.environ.get("C3T_DEMO_FA_NVR", 1.0)))
    data["fa"] = (f_tensors[f_keep], f_labels[f_keep], [x for x, k in zip(f_pos, f_keep) if k],
                  [x for x, k in zip(f_alt, f_keep) if k])

    cfgs = train_configs(setup)
    h5 = _have_h5py()
    for kind, (tensors, labels, pos, alt) in data.items():
        if h5:
            path = os.path.join(out_dir, f"{kind}.bin")
            write_bin(path, tensors, labels, pos, alt)
            setup.bins[kind] = path
            setup.datasets[kind] = BinDataset([path], chunk_size=cfgs[kind].chunk_size)
        else:
            setup.datasets[kind] = ArrayDataset([tensors], [labels],
                                                chunk_size=cfgs[kind].chunk_size)
        print(f"[full] {kind} training data: {len(tensors)} rows "
              f"{tuple(tensors.shape[1:])} ({'HDF5 bin' if h5 else 'in memory: no h5py'})")
    return setup


def train_nets(setup: DemoSetup, device: torch.device) -> Dict[str, dict]:
    """Both nets trained on ``device`` (``train_model`` over the bins, or
    its loop over the in-memory datasets); returns each net's result."""
    from clair3_tpu_torch.train.trainer import fit, train_model

    cfgs = train_configs(setup)
    results = {}
    for kind, name in (("pileup", "PileupNet"), ("fa", "FullAlignmentNet")):
        print(f"[full] training {name}")
        out = os.path.join(setup.out_dir, f"{kind}_model")
        t0 = time.time()
        if kind in setup.bins:
            r = train_model([setup.bins[kind]], out, cfgs[kind],
                            max_steps=setup.steps[kind], device=device)
        else:
            r = fit(setup.datasets[kind], out, cfgs[kind],
                    max_steps=setup.steps[kind], device=device)
        r["wall"] = time.time() - t0
        print(f"[full] {name} best_val_loss={r['best_val_loss']:.4f} ({r['wall']:.1f} s)")
        results[kind] = r
    return results


def call_held_out(setup: DemoSetup, pileup_model: str, fa_model: str, device: torch.device,
                  compute_dtype: str = "auto", tag: str = "out") -> Dict[str, str]:
    """The two-stage cascade on ``[eval_start, L)`` with both nets loaded as
    ``call`` loads them (bf16 and the pileup kernels on a GPU unless
    ``compute_dtype`` says otherwise); returns the output paths."""
    from clair3_tpu_torch.cli import _load_engine, resolve_compute_dtype
    from clair3_tpu_torch.config import CallConfig
    from clair3_tpu_torch.phase import ReadBackedPhaser
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from clair3_tpu_torch.testing import PLATFORMS

    P = PLATFORMS[setup.platform]
    dt = resolve_compute_dtype(compute_dtype, device)
    print(f"[full] running the two-stage cascade on the held-out region ({dt})")
    p_engine = _load_engine(pileup_model, "pileup", device, dt)
    f_engine = _load_engine(fa_model, "full_alignment", device, dt)
    eval_bed = os.path.join(setup.out_dir, "eval.bed")
    with open(eval_bed, "w") as fh:
        fh.write(f"chr1\t{setup.eval_start}\t{setup.L}\n")
    call_cfg = CallConfig(
        platform=setup.platform,  # sets matrix_depth to match the trained FA net
        bam_fn=setup.bam, ref_fn=setup.fasta, bed_fn=eval_bed,
        output_dir=os.path.join(setup.out_dir, tag),
        snp_min_af=P["snp_min_af"], indel_min_af=P["indel_min_af"], threads=4,
        var_pct_full=P["var_pct_full"], ref_pct_full=P["ref_pct_full"],
        enable_dwell_time=P["channels"] == 9,
    )
    caller = VariantCaller(call_cfg, pileup_engine=p_engine, fa_engine=f_engine,
                           phaser=ReadBackedPhaser(setup.bam))
    return caller.run()


def score(setup: DemoSetup, outputs: Dict[str, str]):
    """(full-alignment rows, variant_metrics of the merged PASS rows
    against the held-out truth)."""
    from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord
    from clair3_tpu_torch.postprocess import variant_metrics

    fa_calls = sum(1 for _ in VcfReader(outputs["full_alignment"]))
    truth_recs = [
        VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                  "1/1" if v.genotype == (1, 1) else "0/1")
        for v in setup.variants if v.pos >= setup.eval_start
    ]
    # PASS-only scoring, like hap.py's PASS rows (the reference's demo
    # tables): LowQual-marked calls are what a user filters out
    query_recs = [r for r in VcfReader(outputs["merge_output"])
                  if r.filter in ("PASS", ".")]
    return fa_calls, variant_metrics(truth_recs, query_recs)


def gates(setup: DemoSetup):
    """(SNP, INDEL) F1 gates: the JAX demo's scale-keyed defaults (accuracy
    scales with training data: 260 kb -> ~0.99/0.977, >= 1 Mb ->
    >= 0.995/0.99), overridable by env for scaled-down runs."""
    full_scale = setup.L >= 1_000_000
    # ONT gates sit below hifi (4% simulated error vs 2%), mirroring the
    # reference's own demo tables (ONT indel F1 0.833 vs HiFi 1.0,
    # ont_quick_demo.md:95-99 / pacbio_hifi_quick_demo.md:94-99)
    if setup.platform == "ont":
        default_snp, default_indel = ((0.995, 0.97) if full_scale else (0.985, 0.95))
    else:
        default_snp, default_indel = ((0.995, 0.99) if full_scale else (0.985, 0.97))
    gate_snp = float(os.environ.get("C3T_GATE_SNP", default_snp))
    gate_indel = float(os.environ.get("C3T_GATE_INDEL", default_indel))
    if "C3T_GATE_SNP" in os.environ or "C3T_GATE_INDEL" in os.environ:
        print("=" * 70)
        print(f"[full] WARNING: ACCEPTANCE GATES OVERRIDDEN BY ENV "
              f"(C3T_GATE_SNP={os.environ.get('C3T_GATE_SNP', '-')}, "
              f"C3T_GATE_INDEL={os.environ.get('C3T_GATE_INDEL', '-')}). "
              f"This run does NOT certify the default gates "
              f"({default_snp}/{default_indel} at this scale).")
        print("=" * 70)
    return gate_snp, gate_indel


def print_metrics(m) -> None:
    header = ["VariantType", "FP", "FN", "TP", "Precision", "Recall", "F1-score"]
    print("".join(h.ljust(13) for h in header))
    for vt in ("SNP", "INDEL"):
        r = m[vt]
        print("".join(str(x).ljust(13) for x in (
            vt, r.query_fp, r.truth_fn, r.truth_tp, r.precision, r.recall, r.f1)))


def run(out_dir: str, platform: str = None, device="cuda") -> dict:
    """Train both nets, call the held-out region and score it; returns the
    metrics, the gates and the trained checkpoints' paths."""
    device = resolve_device(device)
    t_start = time.time()
    setup = prepare(out_dir, platform)
    results = train_nets(setup, device)
    outputs = call_held_out(setup, results["pileup"]["model_path"],
                            results["fa"]["model_path"], device)
    fa_calls, m = score(setup, outputs)
    print(f"[full] full-alignment stage re-called {fa_calls} candidates")
    print_metrics(m)
    print(f"[full] total {time.time() - t_start:.0f}s; outputs in {out_dir}")
    gate_snp, gate_indel = gates(setup)
    ok = m["SNP"].f1 >= gate_snp and m["INDEL"].f1 >= gate_indel
    if not ok:
        print(f"[full] FAIL: SNP F1 {m['SNP'].f1} (gate {gate_snp}), "
              f"INDEL F1 {m['INDEL'].f1} (gate {gate_indel})")
    return {
        "ok": ok,
        "platform": setup.platform,
        "snp_f1": m["SNP"].f1,
        "indel_f1": m["INDEL"].f1,
        "fa_calls": fa_calls,
        "gates": (gate_snp, gate_indel),
        "scale_bp": setup.L,
        "pileup_model": results["pileup"]["model_path"],
        "fa_model": results["fa"]["model_path"],
    }


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.full_cascade_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("platform", nargs="?", default=None, choices=("hifi", "ont"),
                    help="or C3T_DEMO_PLATFORM (default hifi)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of training and calling; cuda raises when no GPU "
                         "is present")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="c3t_full_")
    try:
        return 0 if run(out_dir, args.platform, args.device)["ok"] else 1
    finally:
        from clair3_tpu_torch.decode import shutdown_decode_pool

        shutdown_decode_pool()


if __name__ == "__main__":
    raise SystemExit(main())
