"""Command-line interface of the port: ``python -m clair3_tpu_torch call``.

The argument surface is ``clair3_tpu.cli._add_call_args`` plus ``--device``
(the counterpart of ``JAX_PLATFORMS``).  That function, the input
validation, the model-file resolution and the dwell-channel reconciliation
are copies of the JAX CLI's framework-free helpers (held equal to them by
``tests/test_torch_copies.py``).  ``--device cuda`` (the default) raises
when no GPU is present: there is no silent CPU path.

Not yet ported (exit 1 with a message): ``.pt`` checkpoints, model-zoo
names, ``--remote_engines``, ``--dist_*``, ``--profile_dir`` and
whatshap/longphase phasing.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import Optional

import numpy as np
import torch

_DTYPES = {"fp32": torch.float32, "f32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _add_call_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--bam_fn", required=True, help="Sorted BAM input")
    p.add_argument("--ref_fn", required=True, help="Reference FASTA input")
    p.add_argument("--output", "--output_dir", dest="output_dir", required=True)
    p.add_argument("--platform", default="ont", choices=("ont", "hifi", "ilmn"))
    p.add_argument("--model_path", default=None,
                   help="Directory containing pileup.{npz,pt} and full_alignment.{npz,pt}")
    p.add_argument("--pileup_model", default=None)
    p.add_argument("--full_alignment_model", default=None)
    p.add_argument("--sample_name", default="SAMPLE")
    p.add_argument("--ctg_name", default=None)
    p.add_argument("--bed_fn", default=None)
    p.add_argument("--vcf_fn", default=None)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--qual", type=int, default=2,
                   help="mark variants with QUAL<=N as LowQual (reference default 2)")
    p.add_argument("--snp_min_af", type=float, default=None)
    p.add_argument("--indel_min_af", type=float, default=None)
    p.add_argument("--var_pct_full", type=float, default=None)
    p.add_argument("--ref_pct_full", type=float, default=None)
    p.add_argument("--var_pct_phasing", type=float, default=None)
    p.add_argument("--chunk_size", type=int, default=5_000_000)
    p.add_argument("--chunk_num", type=int, default=None,
                   help="override: split each contig into N chunks "
                        "(<=0 = one chunk per contig)")
    p.add_argument("--min_mq", type=int, default=5)
    p.add_argument("--min_coverage", type=int, default=2)
    p.add_argument("--min_contig_size", type=int, default=0)
    p.add_argument("--base_err", type=float, default=0.001)
    p.add_argument("--gq_bin_size", type=int, default=5)
    p.add_argument("--pileup_model_prefix", default="pileup")
    p.add_argument("--fa_model_prefix", default="full_alignment")
    p.add_argument("--pileup_only", action="store_true")
    p.add_argument("--print_ref_calls", action="store_true")
    p.add_argument("--gvcf", action="store_true")
    p.add_argument("--haploid_precise", action="store_true")
    p.add_argument("--haploid_sensitive", action="store_true")
    p.add_argument("--enable_long_indel", action="store_true")
    p.add_argument("--enable_dwell_time", action="store_true")
    p.add_argument("--call_snp_only", action="store_true")
    p.add_argument("--fast_mode", action="store_true",
                   help="ONT: skip variants with <=0.15 AF or <4x coverage "
                        "(reference: CreateTensorPileupFromCffi.py:276-278)")
    p.add_argument("--include_all_ctgs", action="store_true",
                   help="call on all contigs, not just chr{1..22,X,Y} and "
                        "{1..22,X,Y} (reference: CheckEnvs.py:288-292)")
    p.add_argument("--remove_intermediate_dir", action="store_true",
                   help="remove intermediate files (tmp/) after a "
                        "successful run")
    p.add_argument("--output_all_contigs_in_gvcf_header", action="store_true",
                   help="gVCF header lists every reference contig instead "
                        "of only the called ones")
    p.add_argument("--disable_c_impl", action="store_true",
                   help="use the pure-Python extractors/decoders instead of "
                        "the native C++ fast paths (differential debugging)")
    p.add_argument("--call_low_seq_entropy", action="store_true",
                   help="also route the lowest-entropy (repetitive) windows "
                        "to full-alignment re-calling")
    p.add_argument("--seq_entropy_pro", type=float, default=0.05)
    p.add_argument("--no_phasing_for_fa", action="store_true")
    p.add_argument("--keep_iupac_bases", action="store_true")
    p.add_argument("--enable_variant_calling_at_sequence_head_and_tail",
                   action="store_true")
    p.add_argument("--use_oracle_engines", action="store_true",
                   help="TESTING: use tensor-sniffing oracle predictors instead of models")
    p.add_argument("--remote_engines", default=None, metavar="URL",
                   help="run forward passes on a `clair3_tpu_torch serve` engine "
                        "server (e.g. http://tpu-host:8618); no local "
                        "models needed")
    p.add_argument("--use_phasing_for_final_output", action="store_true",
                   help="phase the final merged VCF (internal phaser)")
    # external-phaser interop (reference run_clair3.py:116-117,148-150):
    # internal read-backed phasing is the default; these route the
    # intermediate phasing stage through a whatshap/longphase subprocess
    p.add_argument("--use_whatshap_for_intermediate_phasing",
                   action="store_true",
                   help="phase intermediate het SNPs with an external "
                        "whatshap subprocess instead of the internal phaser")
    p.add_argument("--use_longphase_for_intermediate_phasing",
                   action="store_true",
                   help="phase intermediate het SNPs with an external "
                        "longphase subprocess instead of the internal phaser")
    p.add_argument("--whatshap", default="whatshap",
                   help="path to the whatshap binary")
    p.add_argument("--longphase", default="longphase",
                   help="path to the longphase binary")
    p.add_argument("--use_haplotagging_for_final_output", action="store_true",
                   help="also write an HP/PS-tagged BAM (phased_output.bam)")
    p.add_argument("--compute_dtype", default="auto",
                   choices=("auto", "fp32", "bf16"),
                   help="inference compute dtype; auto = bf16 on TPU "
                        "(benchmarked production config), fp32 elsewhere")
    p.add_argument("--output_probabilities_fn", default=None,
                   help="DEBUG: dump raw head probabilities per candidate")
    p.add_argument("--debug", action="store_true",
                   help="DEBUG: print raw head probabilities per candidate "
                        "to stdout instead of emitting VCF rows "
                        "(reference CallVariants --debug)")
    p.add_argument("--profile_dir", default=None,
                   help="write a jax.profiler trace of the run to this directory")
    # multi-host (pod slice) execution: every process runs this same
    # command; chunks are strided across processes and each writes
    # {output}/proc{i}; merge the per-process VCFs with `sort_vcf`
    p.add_argument("--dist_coordinator", default=None,
                   help="coordinator address host:port of process 0 "
                        "(omit on TPU pod slices with runtime bootstrap)")
    p.add_argument("--dist_num_processes", type=int, default=None)
    p.add_argument("--dist_process_id", type=int, default=None)


def _reconcile_dwell(fa_engine, cfg) -> None:
    """Match the extractor's dwell channel to the model's input width
    (reference auto-detects dwell from '*_with_mv' model names,
    run_clair3.py:414-430; we read the served/loaded conv1 width)."""
    fa_in = getattr(fa_engine, "fa_input_channels", None)
    if fa_in is not None and fa_in != cfg.fa_channels:
        want_dwell = fa_in == 9
        print(f"[INFO] full-alignment model expects {fa_in} input "
              f"channels; {'enabling' if want_dwell else 'disabling'} "
              "the dwell channel to match", file=sys.stderr)
        cfg.enable_dwell_time = want_dwell


def resolve_model_file(model_path: str, prefix: str) -> Optional[str]:
    """First existing {model_path}/{prefix}.{npz,pt}; shared by `call` and
    `serve` so both resolve the same checkpoint for the same directory."""
    for ext in (".npz", ".pt"):
        cand = os.path.join(model_path, prefix + ext)
        if os.path.exists(cand):
            return cand
    return None


def _validate_call_inputs(args) -> Optional[str]:
    """Input validation (reference: preprocess/CheckEnvs.py:180-388);
    returns an error string or None."""
    import os

    if not os.path.exists(args.bam_fn):
        return f"BAM/CRAM file not found: {args.bam_fn}"
    if not os.path.exists(args.ref_fn):
        return f"reference FASTA not found: {args.ref_fn}"
    is_cram = args.bam_fn.lower().endswith(".cram")
    with open(args.bam_fn, "rb") as fh:
        magic = fh.read(4)
        if is_cram:
            if magic != b"CRAM":
                return f"{args.bam_fn} is not a CRAM file"
        elif magic[:2] != b"\x1f\x8b":
            return f"{args.bam_fn} is not a BGZF/BAM file"
    if args.bed_fn and not os.path.exists(args.bed_fn):
        return f"BED file not found: {args.bed_fn}"
    if args.vcf_fn and not os.path.exists(args.vcf_fn):
        return f"known-sites VCF not found: {args.vcf_fn}"
    if args.threads < 1:
        return "--threads must be >= 1"
    try:
        from clair3_tpu_torch.io.bam import BamReader
        from clair3_tpu_torch.io.fasta import FastaFile

        fa = FastaFile(args.ref_fn)
        if is_cram:
            from clair3_tpu_torch.io.cram import CramReader

            bam = CramReader(args.bam_fn, ref_fn=args.ref_fn)
        else:
            bam = BamReader(args.bam_fn)
        shared = set(fa.references) & set(bam.references)
        fa.close()
        if args.ctg_name:
            missing = [c for c in args.ctg_name.split(",") if c not in shared]
            if missing:
                return (f"contig(s) {','.join(missing)} absent from BAM+FASTA "
                        f"intersection (have: {sorted(shared)[:5]}...)")
        if not shared:
            return "no contigs shared between the BAM and the reference"
    except Exception as e:  # malformed inputs
        return f"failed to open inputs: {e}"
    return None


def resolve_device(name: str) -> torch.device:
    """The ``--device`` choice; ``cuda`` without a visible GPU raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible to "
                           "torch (use --device cpu to call on the CPU)")
    return torch.device(name)


def resolve_compute_dtype(choice: str, device: torch.device) -> torch.dtype:
    """bf16 on a GPU, f32 on the CPU; ``--compute_dtype`` or, when the flag
    is ``auto``, ``CLAIR3T_COMPUTE_DTYPE`` overrides."""
    choice = (choice or "auto").lower()
    if choice == "auto":  # an explicit flag wins over a leftover export
        choice = os.environ.get("CLAIR3T_COMPUTE_DTYPE", "auto").lower()
    if choice in _DTYPES:
        return _DTYPES[choice]
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _use_kernel_pileup() -> bool:
    """The pileup net runs through its kernel (K1) unless
    ``CLAIR3T_DISABLE_PALLAS`` is set, which sends it to its plain route:
    the counterpart of ``clair3_tpu.cli._use_pallas_lstm``'s switch.  On the
    CPU the kernel route is the kernel's plain twin."""
    return not os.environ.get("CLAIR3T_DISABLE_PALLAS")


def _use_kernel_fa_conv1(device: torch.device, compute_dtype: torch.dtype) -> bool:
    """The FA conv1 kernel (K3) is opt-in, as in the JAX package
    (``clair3_tpu.cli._use_pallas_fa_conv1``): on only with
    ``CLAIR3T_ENABLE_FA_CONV1=1``, on a CUDA device, at bf16;
    ``CLAIR3T_DISABLE_PALLAS`` wins over it."""
    if os.environ.get("CLAIR3T_DISABLE_PALLAS"):
        return False
    return (os.environ.get("CLAIR3T_ENABLE_FA_CONV1") == "1"
            and torch.device(device).type == "cuda"
            and compute_dtype == torch.bfloat16)


def load_model(path: str, kind: str, device: torch.device,
               compute_dtype: torch.dtype) -> torch.nn.Module:
    """A net from a .npz checkpoint, on ``device``, in eval mode, with its
    kernels switched as ``_use_kernel_pileup`` and ``_use_kernel_fa_conv1``
    say."""
    from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.models.params_io import load_variables

    variables = load_variables(path)
    params = variables["params"]
    if kind == "pileup":
        model = PileupNet(add_indel_length="L5_3" in params,
                          compute_dtype=compute_dtype, use_kernel=_use_kernel_pileup())
    else:
        model = FullAlignmentNet(
            add_indel_length=True,
            input_channels=params["conv1"]["conv"]["kernel"].shape[2],
            compute_dtype=compute_dtype,
            use_kernel_conv1=_use_kernel_fa_conv1(device, compute_dtype))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.to(device).eval()


def _load_engine(path: str, kind: str, device: torch.device,
                 compute_dtype: torch.dtype):
    """The engines as ``clair3_tpu.cli._load_engine`` builds them: pileup
    batches as int16 or their compact form; full-alignment batches cropped
    to their depth band and packed."""
    from clair3_tpu_torch.pipeline.engine import InferenceEngine

    model = load_model(path, kind, device, compute_dtype)
    if kind == "pileup":
        # counts are bounded by ~1.5x max_depth after the high-coverage
        # rescale, so int16 halves the host->device copy losslessly, and
        # the compact form halves it again
        return InferenceEngine(model, device, transfer_dtype=np.int16,
                               pileup_compact=True)
    engine = InferenceEngine(model, device, transfer_dtype=np.int8,
                             depth_crop=True, fa_compact=True)
    engine.fa_input_channels = model.input_channels
    return engine


def _not_yet_ported(args) -> Optional[str]:
    if args.remote_engines:
        return "--remote_engines"
    if (args.dist_coordinator is not None or args.dist_num_processes
            or args.dist_process_id is not None):
        return "--dist_* (multi-process calling)"
    if args.profile_dir:
        return "--profile_dir"
    if (args.use_whatshap_for_intermediate_phasing
            or args.use_longphase_for_intermediate_phasing):
        return "whatshap/longphase intermediate phasing"
    if args.model_path and not os.path.isdir(args.model_path):
        return f"model-zoo names (--model_path {args.model_path})"
    for path in _model_paths(args):
        if path and not path.endswith(".npz"):
            return f".pt checkpoints ({path})"
    return None


def _model_paths(args):
    pileup_path, fa_path = args.pileup_model, args.full_alignment_model
    if args.model_path:
        pileup_path = pileup_path or resolve_model_file(
            args.model_path, args.pileup_model_prefix)
        fa_path = fa_path or resolve_model_file(args.model_path,
                                                args.fa_model_prefix)
    return pileup_path, fa_path


def cmd_call(args: argparse.Namespace) -> int:
    from clair3_tpu_torch.config import CallConfig
    from clair3_tpu_torch.pipeline.call import VariantCaller

    if args.disable_c_impl:  # also governs the readers the validators open
        os.environ["CLAIR3T_DISABLE_NATIVE"] = "1"
    missing = _not_yet_ported(args)
    if missing:
        print(f"[ERROR] not yet ported to clair3_tpu_torch: {missing}; use "
              "`python -m clair3_tpu call`", file=sys.stderr)
        return 1
    if args.enable_dwell_time and args.platform != "ont":
        print("[ERROR] --enable_dwell_time is not supported for non-ONT "
              "platforms", file=sys.stderr)
        return 1
    err = _validate_call_inputs(args)
    if err:
        print(f"[ERROR] {err}", file=sys.stderr)
        return 1
    if args.debug and not args.pileup_only:
        print("[INFO] --debug suppresses VCF rows, so the full-alignment "
              "stage has no candidates to re-call; implying --pileup_only",
              file=sys.stderr)
        args.pileup_only = True

    device = resolve_device(args.device)
    fields = {f.name for f in dataclasses.fields(CallConfig)}
    cfg = CallConfig(**{k: v for k, v in vars(args).items() if k in fields})

    if args.use_oracle_engines:
        from clair3_tpu_torch.testing import FullAlignmentOracleEngine, PileupOracleEngine

        pileup_engine = PileupOracleEngine()
        fa_engine = None if args.pileup_only else FullAlignmentOracleEngine()
    else:
        pileup_path, fa_path = _model_paths(args)
        if pileup_path is None or (fa_path is None and not args.pileup_only):
            print("[ERROR] no pileup and full-alignment models given "
                  "(--model_path, --pileup_model, --full_alignment_model)",
                  file=sys.stderr)
            return 1
        dt = resolve_compute_dtype(args.compute_dtype, device)
        pileup_engine = _load_engine(pileup_path, "pileup", device, dt)
        fa_engine = None
        if not args.pileup_only:
            fa_engine = _load_engine(fa_path, "full_alignment", device, dt)
            _reconcile_dwell(fa_engine, cfg)

    if cfg.enable_dwell_time and not cfg.bam_fn.endswith(".cram"):
        # a BAM without move tables would give a silent all-zero dwell channel
        from clair3_tpu_torch.io.bam import probe_mv_tag

        has_mv, _, checked = probe_mv_tag(cfg.bam_fn)
        if not has_mv:
            print(f"[ERROR] dwell time is enabled but none of the first "
                  f"{checked} alignments carries a valid 'mv' tag",
                  file=sys.stderr)
            return 1

    phaser = None
    if fa_engine is not None and not cfg.no_phasing_for_fa:
        from clair3_tpu_torch.phase import ReadBackedPhaser

        phaser = ReadBackedPhaser(cfg.bam_fn, min_mq=max(cfg.min_mq, 20))

    caller = VariantCaller(cfg, pileup_engine=pileup_engine,
                           fa_engine=fa_engine, phaser=phaser)
    outputs = caller.run()
    for name, path in outputs.items():
        print(f"[INFO] {name}: {path}")
    return 0


def main(argv=None) -> int:
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="clair3_tpu_torch",
        description="germline small-variant caller on PyTorch/CUDA")
    from clair3_tpu_torch import __version__

    parser.add_argument("--version", action="version",
                        version=f"clair3_tpu_torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    call_p = sub.add_parser("call", help="Run the two-stage calling cascade")
    _add_call_args(call_p)
    call_p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device of both nets; cuda raises when no GPU "
                             "is present")
    call_p.set_defaults(func=cmd_call)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return args.func(args)
