"""Quick demo / acceptance run of the port, the twin of
``scripts/quick_demo.py`` (self-contained: no genome data is needed), on
``--device`` (default ``cuda``):

1. simulate a diploid genome with SNPs + indels and 2% read error,
2. build labeled training data from the TRAIN region (an HDF5 bin when
   h5py imports, else the same arrays in memory),
3. train a real PileupNet for a few hundred steps,
4. call variants on the held-out EVAL region with the trained model
   through the port CLI's engine (bf16 and the pileup kernels on a GPU,
   each batch split over every visible card),
5. score SNP/Indel precision/recall/F1 against the simulated truth.

    python -m clair3_tpu_torch.quick_demo [output_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile
import time

L = 260_000
TRAIN_END = 220_000  # train region; evaluate on the held-out tail
STEPS = 400


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.quick_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of training and calling; cuda raises when no GPU "
                         "is present")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    from clair3_tpu_torch.decode import shutdown_decode_pool
    from clair3_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="c3t_demo_")
    os.makedirs(out_dir, exist_ok=True)
    try:
        return run(out_dir, device)
    finally:
        shutdown_decode_pool()


def run(out_dir: str, device) -> int:
    from clair3_tpu_torch.cli import _load_engine, resolve_compute_dtype
    from clair3_tpu_torch.config import CallConfig, TrainConfig
    from clair3_tpu_torch.full_cascade_demo import _have_h5py
    from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord
    from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from clair3_tpu_torch.postprocess import variant_metrics
    from clair3_tpu_torch.testing import (ArrayDataset, SimVariant, random_reference,
                                          write_test_case)
    from clair3_tpu_torch.train.data import TruthVariant, build_labels, write_bin
    from clair3_tpu_torch.train.trainer import fit, train_model

    t_start = time.time()
    print(f"[demo] simulating {L/1000:.0f}kb diploid genome -> {out_dir}")
    ref = random_reference(L, seed=7)
    rng = random.Random(7)
    variants = []
    for pos in range(400, L - 400, 130):
        kind = rng.random()
        gt = (1, 1) if rng.random() < 0.5 else (0, 1)
        if kind < 0.7:
            alt = rng.choice([b for b in "ACGT" if b != ref[pos]])
            variants.append(SimVariant(pos, ref[pos], alt, gt))
        elif kind < 0.85:
            ins = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 3)))
            variants.append(SimVariant(pos, ref[pos], ref[pos] + ins, gt))
        else:
            dlen = rng.randint(1, 3)
            variants.append(SimVariant(pos, ref[pos:pos + dlen + 1], ref[pos], gt))
    fasta, bam, _, _ = write_test_case(
        out_dir, ref_length=L, variants=variants, coverage=25,
        read_length=800, seed=7, error_rate=0.02)

    print("[demo] extracting + labeling training tensors")
    tensors, pos_infos, alt_infos, _ = create_pileup_tensors(
        bam, fasta, "chr1", 1, TRAIN_END, min_snp_af=0.08, min_indel_af=0.12)
    truths = [TruthVariant("chr1", v.pos + 1, v.ref, v.alt, *sorted(v.genotype))
              for v in variants]
    labels, keep = build_labels(pos_infos, truths, maximum_non_variant_ratio=5.0)
    cfg = TrainConfig(pileup=True, add_indel_length=False, batch_size=1000,
                      chunk_size_pileup=100, max_epoch=60, seed=0,
                      early_stop_patience=15)
    if _have_h5py():
        bin_path = os.path.join(out_dir, "train.bin")
        write_bin(bin_path, tensors[keep], labels[keep],
                  [p for p, k in zip(pos_infos, keep) if k],
                  [a for a, k in zip(alt_infos, keep) if k])
        print(f"[demo] {int(keep.sum())} training samples (HDF5 bin)")
    else:
        bin_path = None
        print(f"[demo] {int(keep.sum())} training samples (in memory: no h5py)")

    print(f"[demo] training PileupNet on {device}")
    if bin_path:
        result = train_model([bin_path], os.path.join(out_dir, "model"), cfg,
                             max_steps=STEPS, device=device)
    else:
        data = ArrayDataset([tensors[keep]], [labels[keep]], chunk_size=cfg.chunk_size)
        result = fit(data, os.path.join(out_dir, "model"), cfg, max_steps=STEPS,
                     device=device)
    print(f"[demo] best_val_loss={result['best_val_loss']:.4f}")

    print("[demo] calling the held-out region with the trained model")
    engine = _load_engine(result["model_path"], "pileup", device,
                          resolve_compute_dtype("auto", device))
    eval_bed = os.path.join(out_dir, "eval.bed")
    with open(eval_bed, "w") as fh:
        fh.write(f"chr1\t{TRAIN_END}\t{L}\n")
    call_cfg = CallConfig(
        platform="ont", bam_fn=bam, ref_fn=fasta, bed_fn=eval_bed,
        output_dir=os.path.join(out_dir, "out"), pileup_only=True,
        indel_min_af=0.12, threads=4)
    outputs = VariantCaller(call_cfg, pileup_engine=engine).run()

    truth_recs = [
        VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                  "1/1" if v.genotype == (1, 1) else "0/1")
        for v in variants if v.pos >= TRAIN_END
    ]
    query_recs = list(VcfReader(outputs["merge_output"]))
    m = variant_metrics(truth_recs, query_recs)
    header = ["VariantType", "FP", "FN", "TP", "Precision", "Recall", "F1-score"]
    print("".join(h.ljust(13) for h in header))
    for vt in ("SNP", "INDEL"):
        r = m[vt]
        print("".join(str(x).ljust(13) for x in (
            vt, r.query_fp, r.truth_fn, r.truth_tp, r.precision, r.recall, r.f1)))
    print(f"[demo] total {time.time() - t_start:.0f}s; outputs in {out_dir}")
    return 0 if m["SNP"].f1 >= 0.9 else 1


if __name__ == "__main__":
    raise SystemExit(main())
