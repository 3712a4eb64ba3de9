"""Reference submodule compatibility dispatcher.

The reference exposes ~28 CLI submodules through ``python clair3.py
<Submodule> ...`` (reference: clair3.py:80-104).  Users drive the documented
training / post-processing workflows through them, so the same names work
here:

    python -m clair3_tpu_torch GetTruth --vcf_fn truth.vcf.gz --ctgName chr1 ...
    gzip -fdc pileup.vcf.gz | python -m clair3_tpu_torch SelectQual --output_fn dir

Each handler accepts the reference flag spellings (``--ctgName``,
``--sampleName``, True/False-valued booleans) and reproduces the
reference's file contracts (qual files, split candidate BEDs,
``FULL_ALN_FILE_{ctg}`` indexes, gzip'd var files) on top of the
clair3_tpu_torch library functions.  Submodules that are internals of the
reference's process pipeline (per-chunk tensor creation / calling) are
superseded by the single-program ``call`` pipeline and print a redirect.
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
from typing import List, Optional, Tuple


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "y", "1")


def _open_text(path: str):
    """VCF text reader: plain, gzip, or BGZF."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path)


def _read_vcf_text(path: str) -> Tuple[str, List[str]]:
    """(header_text, body_rows) of a VCF, transparently decompressed."""
    header: List[str] = []
    body: List[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            (header if line.startswith("#") else body).append(line)
    return "\n".join(header), body


def _write_vcf_text(path: str, header: str, rows: List[str]) -> None:
    from clair3_tpu_torch.io.vcf import VcfWriter

    with VcfWriter(path, header) as w:
        w.write_rows(rows)
    if path.endswith(".gz"):
        from clair3_tpu_torch.io.tabix import write_tabix_index

        write_tabix_index(path)


def _vcf_records(path: str, ctg_name: Optional[str] = None):
    from clair3_tpu_torch.io.vcf import VcfReader

    for rec in VcfReader(path):
        if ctg_name and rec.chrom != ctg_name:
            continue
        yield rec


# ---------------------------------------------------------------------------
# GetTruth (reference: preprocess/GetTruth.py:14-85)
# ---------------------------------------------------------------------------

def cmd_get_truth(argv: List[str]) -> int:
    p = argparse.ArgumentParser("GetTruth")
    p.add_argument("--vcf_fn", required=True)
    p.add_argument("--var_fn", default="PIPE")
    p.add_argument("--ctgName", default=None)
    p.add_argument("--ctgStart", type=int, default=None)
    p.add_argument("--ctgEnd", type=int, default=None)
    p.add_argument("--truth_vcf_fn", default=None)
    args = p.parse_args(argv)

    rows = []
    last_chrom = args.ctgName or ""
    seen = set()
    with _open_text(args.vcf_fn) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.split()
            chrom, pos = cols[0], cols[1]
            if args.ctgName and chrom != args.ctgName:
                continue
            if args.ctgStart is not None and args.ctgEnd is not None:
                if not (args.ctgStart <= int(pos) <= args.ctgEnd):
                    continue
            ref, alt, last = cols[3], cols[4], cols[-1]
            gt = last.split(":")[0].replace("/", "|").replace(".", "0").split("|")
            g1, g2 = gt[0], gt[1] if len(gt) > 1 else gt[0]
            if int(g1) > int(g2):
                g1, g2 = g2, g1
            if "*" in alt:
                # reference drops the spanning-deletion allele and forces 0/1
                alts = alt.split(",")
                if int(g1) + int(g2) != 3 or len(alts) != 2:
                    print("error with variant represatation")  # reference spelling
                    continue
                # concatenates the non-* alleles of the split list, so the
                # comma separator disappears too (GetTruth.py:58-62)
                alt = "".join(a for a in alts if a != "*")
                g1, g2 = "0", "1"
            rows.append(" ".join((chrom, pos, ref, alt, g1, g2)))
            seen.add(int(pos))
            last_chrom = chrom
    if args.truth_vcf_fn:
        for rec in _vcf_records(args.truth_vcf_fn, args.ctgName):
            if rec.pos not in seen:
                rows.append(" ".join((last_chrom, str(rec.pos), "None", "None", "-1", "-1")))

    body = "\n".join(rows) + ("\n" if rows else "")
    if args.var_fn == "PIPE":
        sys.stdout.write(body)
    else:
        with gzip.open(args.var_fn, "wt") as fh:
            fh.write(body)
    return 0


# ---------------------------------------------------------------------------
# SelectQual (reference: preprocess/SelectQual.py:10-111; reads VCF on stdin)
# ---------------------------------------------------------------------------

def cmd_select_qual(argv: List[str]) -> int:
    p = argparse.ArgumentParser("SelectQual")
    p.add_argument("--platform", default="ont")
    p.add_argument("--output_fn", required=True)
    p.add_argument("--var_pct_full", type=float, default=0.3)
    p.add_argument("--ref_pct_full", type=float, default=None)
    p.add_argument("--var_pct_phasing", type=float, default=0.7)
    p.add_argument("--phase", action="store_true")
    p.add_argument("--vcf_fn", default=None)
    p.add_argument("--qual_fn", default=None)
    args = p.parse_args(argv)

    var_quals: List[float] = []
    ref_quals: List[float] = []
    het_snp_quals: List[float] = []
    for line in sys.stdin:
        if not line.strip() or line[0] == "#":
            continue
        cols = line.rstrip().split()
        qual = float(cols[5])
        gt = cols[9].split(":")[0]
        if args.phase:
            if gt in ("0/1", "1/0", "0|1", "1|0") and \
                    len(cols[3]) == 1 and len(cols[4]) == 1:
                het_snp_quals.append(qual)
        elif gt == "0/0":
            ref_quals.append(qual)
        else:
            var_quals.append(qual)

    os.makedirs(args.output_fn, exist_ok=True)
    if args.phase:
        low_pct = (1 - args.var_pct_phasing
                   if args.var_pct_phasing is not None else args.var_pct_full)
        quals = sorted(het_snp_quals)
        low = quals[: int(low_pct * len(quals))]
        cutoff = low[-1] if low else 0.0
        print(f"[INFO] Set phasing quality cutoff {round(cutoff, 0)}")
        with open(os.path.join(args.output_fn, args.qual_fn or "phase_qual"), "w") as fh:
            fh.write(str(cutoff))
        return 0

    vcf_given = args.vcf_fn not in (None, "EMPTY")
    ref_pct = args.ref_pct_full if args.ref_pct_full else args.var_pct_full
    var_quals.sort()
    ref_quals.sort()
    low_var = var_quals[: int(args.var_pct_full * len(var_quals))]
    var_cut = low_var[-1] if low_var else 0.0
    pct = args.ref_pct_full if vcf_given else ref_pct
    low_ref = ref_quals[: int((pct or 0.0) * len(ref_quals))]
    ref_cut = low_ref[-1] if low_ref else 0.0
    print(f"[INFO] Set variants quality cutoff {round(var_cut, 0)}")
    print(f"[INFO] Set reference calls quality cutoff {round(ref_cut, 0)}")
    with open(os.path.join(args.output_fn, args.qual_fn or "qual"), "w") as fh:
        fh.write(f"{var_cut} {ref_cut}")
    return 0


# ---------------------------------------------------------------------------
# SelectHetSnp, phasing mode (reference: preprocess/SelectHetSnp.py:12-78)
# ---------------------------------------------------------------------------

def cmd_select_het_snp(argv: List[str]) -> int:
    p = argparse.ArgumentParser("SelectHetSnp")
    p.add_argument("--vcf_fn", required=True)
    p.add_argument("--split_folder", required=True)
    p.add_argument("--ctgName", required=True)
    p.add_argument("--var_pct_full", type=float, default=0.3)
    p.add_argument("--qual_fn", default=None)
    args, _ = p.parse_known_args(argv)

    qual_path = os.path.join(args.split_folder, args.qual_fn or "phase_qual")
    cutoff = None
    if os.path.exists(qual_path):
        cutoff = float(open(qual_path).read().rstrip())

    header: List[str] = []
    variant_rows = {}
    qual_by_pos = {}
    with _open_text(args.vcf_fn) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line[0] == "#":
                header.append(line + "\n")
                continue
            cols = line.split()
            if cols[0] != args.ctgName:
                continue
            gt = cols[9].split(":")[0].replace("|", "/")
            if len(cols[3]) == 1 and len(cols[4]) == 1 and gt in ("0/1", "1/0"):
                # strip PL from FORMAT (whatshap contract)
                if "PL" in cols[-2]:
                    fmt = cols[-2].split(":")
                    i = fmt.index("PL")
                    del fmt[i]
                    cols[-2] = ":".join(fmt)
                    vals = cols[-1].split(":")
                    del vals[i]
                    cols[-1] = ":".join(vals)
                    line = "\t".join(cols)
                pos = int(cols[1])
                variant_rows[pos] = line
                qual_by_pos[pos] = float(cols[5])

    if cutoff is not None:
        drop = [pos for pos, q in qual_by_pos.items() if q < cutoff]
    else:
        ranked = sorted(qual_by_pos.items(), key=lambda kv: kv[1])
        drop = [pos for pos, _ in ranked[: int(args.var_pct_full * len(qual_by_pos))]]
    for pos in drop:
        del variant_rows[pos]

    print(f"[INFO] Total heterozygous SNP positions selected: "
          f"{args.ctgName}: {len(variant_rows)}")
    os.makedirs(args.split_folder, exist_ok=True)
    with open(os.path.join(args.split_folder, f"{args.ctgName}.vcf"), "w") as fh:
        fh.write("".join(header))
        for pos in sorted(variant_rows):
            fh.write(variant_rows[pos] + "\n")
    return 0


# ---------------------------------------------------------------------------
# SelectCandidates (reference: preprocess/SelectCandidates.py:128-294,
# the phasing_info_in_bam=True default branch the C pipeline uses)
# ---------------------------------------------------------------------------

def cmd_select_candidates(argv: List[str]) -> int:
    p = argparse.ArgumentParser("SelectCandidates")
    p.add_argument("--pileup_vcf_fn", required=True)
    p.add_argument("--split_folder", required=True)
    p.add_argument("--ref_fn", default=None)
    p.add_argument("--var_pct_full", type=float, default=0.3)
    p.add_argument("--ref_pct_full", type=float, default=0.3)
    p.add_argument("--platform", default="ont")
    p.add_argument("--ctgName", required=True)
    p.add_argument("--call_low_seq_entropy", type=_str2bool, default=False)
    p.add_argument("--seq_entropy_pro", type=float, default=0.05)
    p.add_argument("--split_bed_size", type=int, default=10000)
    p.add_argument("--qual_fn", default=None)
    args, _ = p.parse_known_args(argv)

    flanking = 16  # param.flankingBaseNum
    no_of_positions = 33
    split_region_size = 40_000_000

    qual_path = os.path.join(args.split_folder, args.qual_fn or "qual")
    var_cut = ref_cut = None
    if os.path.exists(qual_path):
        parts = open(qual_path).read().rstrip().split(" ")
        var_cut, ref_cut = float(parts[0]), float(parts[1])

    ref_calls: List[Tuple[int, float]] = []
    var_calls: List[Tuple[int, float]] = []
    for rec in _vcf_records(args.pileup_vcf_fn, args.ctgName):
        if rec.alt == "." or rec.ref == rec.alt:
            ref_calls.append((rec.pos, rec.qual))
        else:
            var_calls.append((rec.pos, rec.qual))

    if var_cut is not None:
        low_ref = [pos for pos, q in ref_calls if q < ref_cut]
        low_var = [pos for pos, q in var_calls if q < var_cut]
    else:
        low_ref = [pos for pos, _ in
                   sorted(ref_calls, key=lambda x: x[1])[: int(args.ref_pct_full * len(ref_calls))]]
        low_var = [pos for pos, _ in
                   sorted(var_calls, key=lambda x: x[1])[: int(args.var_pct_full * len(var_calls))]]

    entropy_positions: List[int] = []
    if args.call_low_seq_entropy and args.ref_fn:
        from clair3_tpu_torch.io.fasta import FastaFile
        from clair3_tpu_torch.pipeline.select import low_entropy_candidates

        fa = FastaFile(args.ref_fn)

        def fetch_window(pos1):
            return fa.fetch(args.ctgName, max(0, pos1 - 17), pos1 + 16)

        entropy_positions = low_entropy_candidates(
            ref_calls, var_calls, fetch_window,
            var_pct_full=args.var_pct_full, seq_entropy_pro=args.seq_entropy_pro)
        fa.close()

    need = sorted(set(low_ref) | set(low_var) | set(entropy_positions))
    print(f"[INFO] Low quality reference calls to be processed in "
          f"{args.ctgName}: {len(low_ref)}")
    print(f"[INFO] Low quality variants to be processed in "
          f"{args.ctgName}: {len(low_var)}")
    os.makedirs(args.split_folder, exist_ok=True)
    if not need:
        print(f"[WARNING] Cannot find any low-quality 0/0, 0/1 or 1/1 variant "
              f"in pileup output in contig {args.ctgName}")
        return 0

    region_num = (len(need) // args.split_bed_size + 1
                  if len(need) % args.split_bed_size else len(need) // args.split_bed_size)
    paths = []
    for idx in range(region_num):
        chunk = need[idx * args.split_bed_size: (idx + 1) * args.split_bed_size]
        if args.platform == "ilmn":
            spans = [(max(pos // split_region_size * split_region_size - no_of_positions, 1),
                      pos // split_region_size * split_region_size + split_region_size + no_of_positions)
                     for pos in chunk]
        else:
            spans = [(pos - flanking, pos + flanking + 2) for pos in chunk]
        spans.sort(key=lambda x: x[0])
        out_path = os.path.join(args.split_folder, f"{args.ctgName}.{idx}_{region_num}")
        paths.append(out_path)
        with open(out_path, "w") as fh:
            fh.write("\n".join(
                "\t".join([args.ctgName, str(max(s - 1, 0)), str(e - 1)])
                for s, e in spans) + "\n")

    with open(os.path.join(args.split_folder, f"FULL_ALN_FILE_{args.ctgName}"), "w") as fh:
        fh.write("\n".join(paths) + "\n")
    return 0


# ---------------------------------------------------------------------------
# SplitExtendBed (reference: preprocess/SplitExtendBed.py:7-57)
# ---------------------------------------------------------------------------

def cmd_split_extend_bed(argv: List[str]) -> int:
    p = argparse.ArgumentParser("SplitExtendBed")
    p.add_argument("--bed_fn", required=True)
    p.add_argument("--output_fn", required=True)
    p.add_argument("--ctgName", default=None)
    p.add_argument("--expand_region_size", type=int, default=33)
    args = p.parse_args(argv)

    from clair3_tpu_torch.io.bed import split_extend_bed_regions

    rows = split_extend_bed_regions(
        args.bed_fn, ctg_name=args.ctgName, expand=args.expand_region_size)
    # reference output: space-separated, no trailing newline
    # (SplitExtendBed.py:46,51)
    with open(args.output_fn, "w") as fh:
        fh.write("\n".join(f"{ctg} {s} {e}" for ctg, s, e in rows))
    return 0


# ---------------------------------------------------------------------------
# SortVcf (reference: preprocess/SortVcf.py:115-452)
# ---------------------------------------------------------------------------

def cmd_sort_vcf(argv: List[str]) -> int:
    p = argparse.ArgumentParser("SortVcf")
    p.add_argument("--output_fn", required=True)
    p.add_argument("--input_dir", default=None)
    p.add_argument("--vcf_fn_prefix", default=None)
    p.add_argument("--vcf_fn_suffix", default=".vcf")
    p.add_argument("--ref_fn", default=None)
    p.add_argument("--sampleName", default="SAMPLE")
    p.add_argument("--contigs_fn", default=None)
    args, _ = p.parse_known_args(argv)

    inputs: List[str] = []
    if args.input_dir:
        for name in sorted(os.listdir(args.input_dir)):
            if args.vcf_fn_prefix and not name.startswith(args.vcf_fn_prefix):
                continue
            if not name.endswith(args.vcf_fn_suffix):
                continue
            inputs.append(os.path.join(args.input_dir, name))

    from clair3_tpu_torch.cli import main as cli_main

    cmd = ["sort_vcf", "--output_fn", args.output_fn,
           "--sample_name", args.sampleName]
    if args.ref_fn and args.ref_fn != "EMPTY":
        cmd += ["--ref_fn", args.ref_fn]
    if not inputs:
        # reference writes a header-only output when no shard exists
        from clair3_tpu_torch.io.tabix import write_tabix_index
        from clair3_tpu_torch.io.vcf import VcfWriter, get_header

        header = get_header(reference_file_path=args.ref_fn,
                            sample_name=args.sampleName)
        with VcfWriter(args.output_fn, header):
            pass
        if args.output_fn.endswith(".gz"):
            write_tabix_index(args.output_fn)
        return 0
    return cli_main(cmd + ["--input_fn"] + inputs)


# ---------------------------------------------------------------------------
# MergeVcf / MergeBin / GetOverallMetrics / postprocess trio: thin arg maps
# ---------------------------------------------------------------------------

def cmd_merge_vcf(argv: List[str]) -> int:
    p = argparse.ArgumentParser("MergeVcf")
    p.add_argument("--pileup_vcf_fn", required=True)
    p.add_argument("--full_alignment_vcf_fn", required=True)
    p.add_argument("--output_fn", required=True)
    p.add_argument("--ref_fn", default=None)
    p.add_argument("--ctgName", default=None)
    p.add_argument("--sampleName", default="SAMPLE")
    p.add_argument("--qual", type=float, default=2)
    p.add_argument("--print_ref_calls", type=_str2bool, default=False)
    p.add_argument("--haploid_precise", type=_str2bool, default=False)
    p.add_argument("--haploid_sensitive", type=_str2bool, default=False)
    p.add_argument("--platform", default="ont")
    p.add_argument("--bed_fn_prefix", default=None)
    args, _ = p.parse_known_args(argv)

    from clair3_tpu_torch.cli import main as cli_main

    cmd = ["merge_vcf",
           "--pileup_vcf_fn", args.pileup_vcf_fn,
           "--full_alignment_vcf_fn", args.full_alignment_vcf_fn,
           "--output_fn", args.output_fn,
           "--sample_name", args.sampleName,
           "--platform", args.platform,
           "--qual", str(args.qual)]
    if args.bed_fn_prefix:
        cmd += ["--bed_fn_prefix", args.bed_fn_prefix]
    if args.ref_fn and args.ref_fn != "EMPTY":
        cmd += ["--ref_fn", args.ref_fn]
    if args.ctgName and args.ctgName != "EMPTY":
        cmd += ["--ctg_name", args.ctgName]
    if args.print_ref_calls:
        cmd.append("--print_ref_calls")
    if args.haploid_precise:
        cmd.append("--haploid_precise")
    if args.haploid_sensitive:
        cmd.append("--haploid_sensitive")
    return cli_main(cmd)


def cmd_merge_bin(argv: List[str]) -> int:
    p = argparse.ArgumentParser("MergeBin")
    p.add_argument("in_fn", nargs="+")
    p.add_argument("--out_fn", required=True)
    p.add_argument("--platform", default="ont")
    p.add_argument("--pileup", action="store_true")
    p.add_argument("--enable_dwell_time", action="store_true")
    args, _ = p.parse_known_args(argv)

    from clair3_tpu_torch.train.data import merge_bins

    merge_bins(args.in_fn, args.out_fn)
    print(f"[INFO] Merged {len(args.in_fn)} bins -> {args.out_fn}")
    return 0


def cmd_get_overall_metrics(argv: List[str]) -> int:
    p = argparse.ArgumentParser("GetOverallMetrics")
    p.add_argument("--happy_vcf_fn", required=True)
    p.add_argument("--ctgName", default=None)
    p.add_argument("--output_fn", default=None)
    args, _ = p.parse_known_args(argv)

    from clair3_tpu_torch.cli import main as cli_main

    cmd = ["metrics", "--happy_vcf_fn", args.happy_vcf_fn]
    if args.ctgName:
        cmd += ["--ctg_name", args.ctgName]
    if args.output_fn:
        out = open(args.output_fn, "w")
        saved = sys.stdout
        sys.stdout = out
        try:
            return cli_main(cmd)
        finally:
            sys.stdout = saved
            out.close()
    return cli_main(cmd)


def cmd_switch_zygosity(argv: List[str]) -> int:
    p = argparse.ArgumentParser("SwitchZygosityBasedOnSVCalls")
    p.add_argument("--bam_fn", required=True)
    p.add_argument("--clair3_vcf_input", required=True)
    p.add_argument("--sv_vcf_input", default=None)
    p.add_argument("--sv_bed_input", default=None)
    p.add_argument("--vcf_output", required=True)
    p.add_argument("--threads", type=int, default=8)
    args, _ = p.parse_known_args(argv)

    from clair3_tpu_torch.postprocess import (
        sv_deletion_intervals_from_vcf, switch_zygosity_based_on_sv_calls)

    if not args.sv_vcf_input:
        print("[ERROR] --sv_vcf_input required", file=sys.stderr)
        return 1
    tree = sv_deletion_intervals_from_vcf(args.sv_vcf_input)
    header, body = _read_vcf_text(args.clair3_vcf_input)
    rows, n = switch_zygosity_based_on_sv_calls(args.bam_fn, body, tree)
    _write_vcf_text(args.vcf_output, header, rows)
    print(f"[INFO] Switched zygosity for {n} variants")
    return 0


def cmd_add_back_missing(argv: List[str]) -> int:
    p = argparse.ArgumentParser("AddBackMissingVariantsInGenotyping")
    p.add_argument("--vcf_fn", required=True,
                   help="known-sites VCF given to genotyping mode")
    p.add_argument("--clair3_input_vcf_fn", required=True)
    p.add_argument("--output_fn", required=True)
    args, _ = p.parse_known_args(argv)

    from clair3_tpu_torch.io.vcf import VcfReader
    from clair3_tpu_torch.postprocess import add_back_missing_variants

    header, body = _read_vcf_text(args.clair3_input_vcf_fn)
    rows = add_back_missing_variants(list(VcfReader(args.vcf_fn)), body)
    _write_vcf_text(args.output_fn, header, rows)
    print(f"[INFO] Wrote {len(rows)} rows ({len(rows) - len(body)} added back)")
    return 0


# ---------------------------------------------------------------------------
# Redirects: per-chunk internals superseded by the single-program design
# ---------------------------------------------------------------------------

_REDIRECTS = {
    "CallVarBam": "call",
    "CallVariants": "call",
    "CallVariantsFromCffi": "call",
    "CallVariantsFromCffiGPU": "call",
    "CreateTensorPileup": "call (tensors are created in-process)",
    "CreateTensorFullAlignment": "call (tensors are created in-process)",
    "CreateTensorPileupFromCffi": "call (tensors are created in-process)",
    "CreateTensorFullAlignmentFromCffi": "call (tensors are created in-process)",
    "CreateTrainingTensor": "tensor2bin",
    "CreateTrainingTensorDirect": "tensor2bin",
    "Tensor2Bin": "tensor2bin",
    "RealignReads": "call --platform ilmn (realignment is automatic)",
    "CheckEnvs": "call (inputs are validated in-process)",
    "CheckExitCode": "(not needed: in-process exceptions replace joblog scraping)",
    "UnifyRepresentation": "tensor2bin --unify_repr",
}


# ---------------------------------------------------------------------------
# Train (reference: clair3/Train.py flag surface -> clair3_tpu_torch train)
# ---------------------------------------------------------------------------

def cmd_train_compat(argv: List[str]) -> int:
    p = argparse.ArgumentParser("Train")
    p.add_argument("--platform", default="ont")
    p.add_argument("--bin_fn", required=True,
                   help="directory of HDF5 bins (reference layout)")
    p.add_argument("--chkpnt_fn", default=None)
    p.add_argument("--ochk_prefix", required=True)
    p.add_argument("--maxEpoch", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--exclude_training_samples", default=None)
    p.add_argument("--mini_epochs", type=int, default=1)
    p.add_argument("--pileup", action="store_true")
    p.add_argument("--add_indel_length", type=_str2bool, default=False)
    p.add_argument("--enable_dwell_time", action="store_true")
    args, _ = p.parse_known_args(argv)

    bins: List[str] = []
    if os.path.isdir(args.bin_fn):
        excludes = (args.exclude_training_samples.split(",")
                    if args.exclude_training_samples else [])
        for name in sorted(os.listdir(args.bin_fn)):
            # reference quirk: bins whose name contains '_20_' (chr20,
            # held out for evaluation) are excluded (Train.py:335)
            if "_20_" in name:
                continue
            if any(name.startswith(e) for e in excludes):
                continue
            bins.append(os.path.join(args.bin_fn, name))
    else:
        bins = [args.bin_fn]
    if not bins:
        print("[ERROR] no training bins found", file=sys.stderr)
        return 1

    from clair3_tpu_torch.cli import main as cli_main

    out_dir = os.path.dirname(args.ochk_prefix) or "."
    cmd = ["train", "--bin_fn"] + bins + [
        "--output_dir", out_dir,
        "--platform", args.platform,
        "--learning_rate", str(args.learning_rate),
        "--mini_epochs", str(args.mini_epochs),
    ]
    if args.maxEpoch:
        cmd += ["--max_epoch", str(args.maxEpoch)]
    if args.pileup:
        cmd.append("--pileup")
    if args.add_indel_length:
        cmd.append("--add_indel_length")
    if args.chkpnt_fn:
        cmd += ["--chkpnt_fn", args.chkpnt_fn]
    return cli_main(cmd)


def _redirect(name: str) -> int:
    print(f"[INFO] '{name}' is a per-process internal of the reference "
          f"pipeline; in clair3_tpu_torch its capability lives in: "
          f"python -m clair3_tpu_torch {_REDIRECTS[name]}", file=sys.stderr)
    return 2


SUBMODULES = {
    "GetTruth": cmd_get_truth,
    "SelectQual": cmd_select_qual,
    "SelectHetSnp": cmd_select_het_snp,
    "SelectCandidates": cmd_select_candidates,
    "SplitExtendBed": cmd_split_extend_bed,
    "SortVcf": cmd_sort_vcf,
    "MergeVcf": cmd_merge_vcf,
    "MergeBin": cmd_merge_bin,
    "GetOverallMetrics": cmd_get_overall_metrics,
    "SwitchZygosityBasedOnSVCalls": cmd_switch_zygosity,
    "AddBackMissingVariantsInGenotyping": cmd_add_back_missing,
    "Train": cmd_train_compat,
}


def dispatch(argv: List[str]) -> Optional[int]:
    """If argv[0] names a reference submodule, run it; else None."""
    if not argv:
        return None
    name = argv[0]
    if name in SUBMODULES:
        return SUBMODULES[name](argv[1:])
    if name in _REDIRECTS:
        return _redirect(name)
    return None
