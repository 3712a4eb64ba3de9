"""Command-line interface of the port: ``python -m clair3_tpu_torch
{call,serve,tensor2bin,train}``.

The argument surface of ``call`` is ``clair3_tpu.cli._add_call_args`` plus
``--device`` (the counterpart of ``JAX_PLATFORMS``).  That function, the
input validation, the model-file resolution, the dwell-channel
reconciliation, ``cmd_serve``, ``cmd_tensor2bin`` and the ``tensor2bin``
and ``train`` parsers are copies of the JAX CLI's framework-free code (held
equal to it by ``tests/test_torch_copies.py``; ``train`` adds ``--device``).
``cmd_call`` checks model-zoo names and probes the BAM for move tables in
the JAX CLI's order, before any engine loads.  Both nets load from ``.npz``
or from the reference's ``.pt`` state dicts (``models/convert.py``).
``--device cuda`` (the default of ``call``, ``serve`` and ``train``) raises
when no GPU is present: there is no silent CPU path.

    # a directory with pileup.{npz,pt} and full_alignment.{npz,pt}; ONT with
    # the dwell channel read from the BAM's mv tags
    python -m clair3_tpu_torch call --bam_fn in.bam --ref_fn ref.fa \
        --output out --model_path DIR --platform ont --enable_dwell_time
    # the nets on one GPU host, extraction and decode elsewhere
    python -m clair3_tpu_torch serve --model_path DIR --platform ont --device cuda
    python -m clair3_tpu_torch call ... --remote_engines http://gpu-host:8618
    # a torch.profiler Chrome trace of the run
    python -m clair3_tpu_torch call ... --profile_dir trace/
    # a labelled bin from a BAM and a truth VCF, then a net trained on it;
    # the checkpoints are the JAX package's .npz trees
    python -m clair3_tpu_torch tensor2bin --bam_fn in.bam --ref_fn ref.fa \
        --truth_vcf_fn truth.vcf --bin_fn p.bin --pileup --platform hifi
    python -m clair3_tpu_torch train --bin_fn p.bin --output_dir m --pileup

Intermediate phasing runs in-process unless
``--use_{whatshap,longphase}_for_intermediate_phasing`` hands it to that
binary.  Not yet ported (exit 1 with a message): ``call --dist_*`` and
``train --data_parallel`` (multi-process calling and training).
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

from clair3_tpu_torch.device import resolve_device

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
                        "server (e.g. http://gpu-host:8618); no local "
                        "models needed, and --device is not used")
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
                   help="inference compute dtype; auto = bf16 on CUDA, "
                        "fp32 on the CPU")
    p.add_argument("--output_probabilities_fn", default=None,
                   help="DEBUG: dump raw head probabilities per candidate")
    p.add_argument("--debug", action="store_true",
                   help="DEBUG: print raw head probabilities per candidate "
                        "to stdout instead of emitting VCF rows "
                        "(reference CallVariants --debug)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run to this directory")
    # multi-host (pod slice) execution: every process runs this same
    # command; chunks are strided across processes and each writes
    # {output}/proc{i}; merge the per-process VCFs with `sort_vcf`
    p.add_argument("--dist_coordinator", default=None,
                   help="coordinator address host:port of process 0")
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
    """A net from a .npz checkpoint or a reference ``.pt`` state dict, on
    ``device``, in eval mode, with its kernels switched as
    ``_use_kernel_pileup`` and ``_use_kernel_fa_conv1`` say."""
    from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.models.convert import convert_checkpoint
    from clair3_tpu_torch.models.params_io import load_variables

    if path.endswith(".pt"):
        variables = convert_checkpoint(path, kind)
    else:
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
    if getattr(args, "data_parallel", False):
        return "--data_parallel (multi-process training)"
    if (getattr(args, "dist_coordinator", None) is not None
            or getattr(args, "dist_num_processes", None)
            or getattr(args, "dist_process_id", None) is not None):
        return "--dist_* (multi-process calling)"
    return None


def _model_paths(args):
    pileup_path, fa_path = args.pileup_model, args.full_alignment_model
    if args.model_path:
        pileup_path = pileup_path or resolve_model_file(
            args.model_path, args.pileup_model_prefix)
        fa_path = fa_path or resolve_model_file(args.model_path,
                                                args.fa_model_prefix)
    return pileup_path, fa_path


def _profiled_run(caller, profile_dir: str, device: Optional[torch.device]):
    """``caller.run()`` under ``torch.profiler``: CPU activity on every
    thread (the engines run their nets on their own submitter threads), and
    CUDA activity when the nets run on a GPU; the Chrome trace goes to
    ``{profile_dir}/call.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        outputs = caller.run()
    path = os.path.join(profile_dir, "call.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"[INFO] profile: {path}", file=sys.stderr)
    return outputs


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
    # the model block of clair3_tpu.cli.cmd_call, in its order: zoo names
    # are validated, and the mv probe runs, before any input or engine loads
    if args.enable_dwell_time and args.platform != "ont":
        # reference run_clair3.py:433-437: dwell time is ONT-only
        print("[ERROR] --enable_dwell_time is not supported for non-ONT "
              "platforms", file=sys.stderr)
        return 1
    dwell_expected = args.enable_dwell_time
    if args.model_path:
        from clair3_tpu_torch.models.zoo import (lookup_model, name_implies_dwell,
                                                 validate_model_choice)

        zoo_info = lookup_model(args.model_path)
        if zoo_info is not None:
            err = validate_model_choice(zoo_info, args.platform)
            if err:
                print(f"[ERROR] {err}", file=sys.stderr)
                return 1
        model_dwell = (zoo_info.dwell if zoo_info is not None
                       else name_implies_dwell(args.model_path))
        if model_dwell and args.platform != "ont":
            # move-table models are ONT-only (reference run_clair3.py:419-425)
            name = os.path.basename(os.path.normpath(args.model_path))
            print(f"[ERROR] model '{name}' is a move-table (signal-aware) "
                  f"model and is ONT-only, but --platform is "
                  f"'{args.platform}'. Use --platform ont with ONT data, or "
                  "choose a non move-table model for this platform.",
                  file=sys.stderr)
            return 1
        if zoo_info is not None and (args.var_pct_phasing is None
                                     and zoo_info.var_pct_phasing is not None):
            args.var_pct_phasing = zoo_info.var_pct_phasing
        if model_dwell and not args.enable_dwell_time:
            name = os.path.basename(os.path.normpath(args.model_path))
            print(f"[INFO] '{name}' is a signal-aware "
                  "(*_with_mv) model: the dwell-time channel will be "
                  "enabled to match its 9-channel input (Clair3 itself "
                  "requires --enable_dwell_time here); the "
                  "BAM must carry mv/ts basecaller tags",
                  file=sys.stderr)
        dwell_expected = dwell_expected or model_dwell

    err = _validate_call_inputs(args)
    if err:
        print(f"[ERROR] {err}", file=sys.stderr)
        return 1

    if dwell_expected and not args.bam_fn.endswith(".cram"):
        # the reference verifies the first 50 alignments actually carry a
        # usable mv tag and fails early otherwise (run_clair3.py:442-463):
        # without it a tagless BAM degrades silently to a zero dwell channel
        from clair3_tpu_torch.io.bam import probe_mv_tag

        has_mv, mv_no_value, checked = probe_mv_tag(args.bam_fn)
        if not has_mv:
            detail = ("an 'mv' tag was found without a valid value"
                      if mv_no_value else "no valid 'mv' tag was found")
            print(f"[ERROR] dwell time is enabled but within the first "
                  f"{checked} alignments {detail}. The 'mv' move table "
                  "(Dorado --emit-moves) is required for the dwell-time "
                  "channel; provide a tagged BAM or use a non move-table "
                  "model / drop --enable_dwell_time.", file=sys.stderr)
            return 1

    if args.debug and not args.pileup_only:
        print("[INFO] --debug suppresses VCF rows, so the full-alignment "
              "stage has no candidates to re-call; implying --pileup_only",
              file=sys.stderr)
        args.pileup_only = True

    # a --remote_engines client loads no net and runs nothing on a device
    device = None if args.remote_engines else resolve_device(args.device)
    fields = {f.name for f in dataclasses.fields(CallConfig)}
    cfg = CallConfig(**{k: v for k, v in vars(args).items() if k in fields})

    if args.use_oracle_engines:
        from clair3_tpu_torch.testing import FullAlignmentOracleEngine, PileupOracleEngine

        pileup_engine = PileupOracleEngine()
        fa_engine = None if args.pileup_only else FullAlignmentOracleEngine()
    elif args.remote_engines:
        # forward passes on a serving GPU host (`clair3_tpu_torch serve`);
        # this process only extracts and decodes
        from clair3_tpu_torch.serve import RemoteEngine

        try:
            pileup_engine = RemoteEngine(args.remote_engines, "pileup",
                                         platform=args.platform)
            fa_engine = None
            if not args.pileup_only:
                fa_engine = RemoteEngine(args.remote_engines, "full_alignment",
                                         platform=args.platform)
        except Exception as exc:
            print(f"[ERROR] {exc}", file=sys.stderr)
            return 1
        if fa_engine is not None:
            _reconcile_dwell(fa_engine, cfg)
    else:
        pileup_path, fa_path = _model_paths(args)
        if pileup_path is None:
            print("[ERROR] no pileup model given (--pileup_model / --model_path)",
                  file=sys.stderr)
            return 1
        if fa_path is None and not args.pileup_only:
            print("[ERROR] no full-alignment model given "
                  "(--full_alignment_model / --model_path)", file=sys.stderr)
            return 1
        dt = resolve_compute_dtype(args.compute_dtype, device)
        pileup_engine = _load_engine(pileup_path, "pileup", device, dt)
        fa_engine = None
        if not args.pileup_only:
            fa_engine = _load_engine(fa_path, "full_alignment", device, dt)
            _reconcile_dwell(fa_engine, cfg)

    phaser = None
    if fa_engine is not None and not cfg.no_phasing_for_fa:
        if (args.use_whatshap_for_intermediate_phasing
                or args.use_longphase_for_intermediate_phasing):
            from clair3_tpu_torch.phase.external import ExternalPhaser

            tool = ("longphase" if args.use_longphase_for_intermediate_phasing
                    else "whatshap")
            phaser = ExternalPhaser(
                tool, cfg.bam_fn, cfg.ref_fn, platform=cfg.platform,
                binary=getattr(args, tool), threads=cfg.threads,
                work_dir=cfg.output_dir, sample=cfg.sample_name)
        else:
            from clair3_tpu_torch.phase import ReadBackedPhaser

            phaser = ReadBackedPhaser(cfg.bam_fn, min_mq=max(cfg.min_mq, 20))

    caller = VariantCaller(cfg, pileup_engine=pileup_engine,
                           fa_engine=fa_engine, phaser=phaser)
    if args.profile_dir:
        outputs = _profiled_run(caller, args.profile_dir, device)
    else:
        outputs = caller.run()
    for name, path in outputs.items():
        print(f"[INFO] {name}: {path}")
    return 0


def cmd_tensor2bin(args: argparse.Namespace) -> int:
    """Create a labeled HDF5 training bin from a BAM + truth VCF
    (reference workflow: CreateTrainingTensorDirect + Tensor2Bin)."""
    from clair3_tpu_torch.io.fasta import FastaFile
    from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
    from clair3_tpu_torch.train.data import build_labels, truth_variants_from_vcf, write_bin

    fa = FastaFile(args.ref_fn)
    ctg = args.ctg_name or fa.references[0]
    end = args.ctg_end or fa.contig_length(ctg)
    fa.close()

    if args.pileup:
        tensors, pos_infos, alt_infos, _ = create_pileup_tensors(
            args.bam_fn, args.ref_fn, ctg, args.ctg_start, end,
            min_snp_af=args.snp_min_af, min_indel_af=args.indel_min_af)
    else:
        from clair3_tpu_torch.config import PLATFORMS
        from clair3_tpu_torch.train.data import TruthVariant  # noqa: F401
        from clair3_tpu_torch.fullalign.extractor import create_fa_tensors
        from clair3_tpu_torch.pileup.extractor import create_pileup_tensors as _cpt

        _, pos_infos_p, _, _ = _cpt(
            args.bam_fn, args.ref_fn, ctg, args.ctg_start, end,
            min_snp_af=args.snp_min_af, min_indel_af=args.indel_min_af)
        positions = [int(p.split(":")[-2]) for p in pos_infos_p]
        tensors, pos_infos, alt_infos = create_fa_tensors(
            args.bam_fn, args.ref_fn, ctg, positions,
            matrix_depth=PLATFORMS[args.platform].matrix_depth,
            no_phasing=True, enable_dwell=args.enable_dwell_time)

    truths = truth_variants_from_vcf(args.truth_vcf_fn, ctg)
    if args.unify_repr:
        from clair3_tpu_torch.io.fasta import FastaFile as _FF
        from clair3_tpu_torch.train.unify import CandidateAllele, unify_representation

        cands = []
        for pos_info, alt_info in zip(pos_infos, alt_infos):
            pos1 = int(pos_info.split(":")[-2])
            ref_base = pos_info.split(":")[-1]
            ref_base = ref_base[len(ref_base) // 2] if len(ref_base) > 1 else ref_base
            for token in str(alt_info).split("-", 1)[-1].split(" "):
                if not token or token[0] not in "XID" or not token[1:]:
                    continue
                if token[0] == "X":
                    cands.append(CandidateAllele(pos1, ref_base, token[1]))
                elif token[0] == "I":
                    cands.append(CandidateAllele(pos1, ref_base, token[1:]))
                else:  # D<deleted>
                    cands.append(CandidateAllele(pos1, ref_base + token[1:], ref_base))
        _fa = _FF(args.ref_fn)
        ref_seq = _fa.fetch(ctg, 0, _fa.contig_length(ctg))
        _fa.close()
        # read-level support gates relabeling (find_read_support semantics)
        from clair3_tpu_torch.io.bam import BamReader as _BR

        _bam = _BR(args.bam_fn)
        _reads = list(_bam.fetch(ctg, max(0, args.ctg_start - 1), end))
        truths = unify_representation(truths, cands, ref_seq, 0, reads=_reads)
    labels, keep = build_labels(
        pos_infos, truths, maximum_non_variant_ratio=args.maximum_non_variant_ratio)
    write_bin(args.bin_fn, tensors[keep], labels[keep],
              [p for p, k in zip(pos_infos, keep) if k],
              [a for a, k in zip(alt_infos, keep) if k])
    print(f"[INFO] wrote {int(keep.sum())} samples to {args.bin_fn}")
    return 0


def cmd_train(args: argparse.Namespace) -> int:
    """Train a net from HDF5 bins on ``--device``; the counterpart of
    ``clair3_tpu.cli.cmd_train`` without a mesh."""
    from clair3_tpu_torch.config import TrainConfig
    from clair3_tpu_torch.train.trainer import train_model

    missing = _not_yet_ported(args)
    if missing:
        print(f"[ERROR] not yet ported to clair3_tpu_torch: {missing}; use "
              "`python -m clair3_tpu train`", file=sys.stderr)
        return 1
    device = resolve_device(args.device)
    init_variables = None
    if args.chkpnt_fn:
        from clair3_tpu_torch.models.params_io import load_variables

        init_variables = load_variables(args.chkpnt_fn)
    cfg = TrainConfig(
        pileup=args.pileup,
        add_indel_length=args.add_indel_length,
        platform=args.platform,
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        max_epoch=args.max_epoch,
        mini_epochs=args.mini_epochs,
        seed=args.seed,
    )
    result = train_model(args.bin_fn, args.output_dir, cfg,
                         init_variables=init_variables,
                         use_class_weights=args.use_class_weights, device=device)
    print(f"[INFO] best_val_loss={result['best_val_loss']:.4f} "
          f"model={result['model_path']}")
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """Serve the production inference engines over HTTP (GPU host side of
    the remote-inference split; reference analogue: the Triton serving
    mode, CallVariantsFromCffi.py:201-214)."""
    import numpy as np

    from clair3_tpu_torch.config import PLATFORMS
    from clair3_tpu_torch.serve import build_server

    if not args.model_path and not args.pileup_model:
        print("[ERROR] serve needs --model_path or --pileup_model",
              file=sys.stderr)
        return 1
    if args.model_path:
        from clair3_tpu_torch.models.zoo import (lookup_model, name_implies_dwell,
                                           validate_model_choice)

        zoo_info = lookup_model(args.model_path)
        if zoo_info is not None:
            err = validate_model_choice(zoo_info, args.platform)
            if err:
                print(f"[ERROR] {err}", file=sys.stderr)
                return 1
        if (zoo_info.dwell if zoo_info is not None
                else name_implies_dwell(args.model_path)):
            # mirror the `call` dwell notice so GPU-host operators see it
            # too: clients must extract with the dwell channel (mv/ts tags)
            name = os.path.basename(os.path.normpath(args.model_path))
            print(f"[INFO] '{name}' is a signal-aware (*_with_mv) model: "
                  "clients must send 9-channel full-alignment tensors "
                  "(dwell enabled; BAM needs mv/ts basecaller tags)",
                  file=sys.stderr)
    server = build_server(
        args.model_path, platform=args.platform,
        compute_dtype=args.compute_dtype, host=args.host, port=args.port,
        pileup_model=args.pileup_model, fa_model=args.full_alignment_model,
        device=args.device)
    # compile every bucket up front so first client batches are fast
    plat = PLATFORMS[args.platform]
    for kind, eng in server.engines.items():
        if not hasattr(eng, "warmup"):
            continue
        if kind == "pileup":
            eng.warmup((33, 18), np.int32)
        else:
            ch = getattr(eng, "fa_input_channels", 8)
            eng.warmup((plat.matrix_depth, 33, ch), np.int8)
    print(f"[INFO] serving {sorted(server.engines)} on {server.address}",
          file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
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

    t2b = sub.add_parser("tensor2bin", help="Create labeled HDF5 training bins")
    t2b.add_argument("--bam_fn", required=True)
    t2b.add_argument("--ref_fn", required=True)
    t2b.add_argument("--truth_vcf_fn", required=True)
    t2b.add_argument("--bin_fn", required=True)
    t2b.add_argument("--platform", default="ont", choices=("ont", "hifi", "ilmn"))
    t2b.add_argument("--ctg_name", default=None)
    t2b.add_argument("--ctg_start", type=int, default=1)
    t2b.add_argument("--ctg_end", type=int, default=None)
    t2b.add_argument("--pileup", action="store_true")
    t2b.add_argument("--enable_dwell_time", action="store_true")
    t2b.add_argument("--snp_min_af", type=float, default=0.08)
    t2b.add_argument("--indel_min_af", type=float, default=0.15)
    t2b.add_argument("--maximum_non_variant_ratio", type=float, default=None)
    t2b.add_argument("--unify_repr", action="store_true",
                     help="re-express truth variants in the sample's own "
                          "candidate representation space before labeling")
    t2b.set_defaults(func=cmd_tensor2bin)

    tr = sub.add_parser("train", help="Train a model from HDF5 bins")
    tr.add_argument("--bin_fn", nargs="+", required=True)
    tr.add_argument("--output_dir", required=True)
    tr.add_argument("--platform", default="ont", choices=("ont", "hifi", "ilmn"))
    tr.add_argument("--pileup", action="store_true")
    tr.add_argument("--add_indel_length", action="store_true")
    tr.add_argument("--learning_rate", type=float, default=1e-3)
    tr.add_argument("--batch_size", type=int, default=2000)
    tr.add_argument("--max_epoch", type=int, default=30)
    tr.add_argument("--mini_epochs", type=int, default=1)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--data_parallel", action="store_true",
                    help="not yet ported (exits 1): multi-process training")
    tr.add_argument("--chkpnt_fn", default=None,
                    help="initial .npz checkpoint for fine-tuning/resume")
    tr.add_argument("--use_class_weights", action="store_true",
                    help="effective-number class-balanced focal loss weights")
    tr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the trained net; cuda raises when no GPU "
                         "is present")
    tr.set_defaults(func=cmd_train)

    srv = sub.add_parser(
        "serve", help="serve the inference engines over HTTP (remote "
                      "calling hosts use `call --remote_engines`)")
    srv.add_argument("--model_path", default=None,
                     help="directory with pileup.{npz,pt} / "
                          "full_alignment.{npz,pt}")
    srv.add_argument("--pileup_model", default=None)
    srv.add_argument("--full_alignment_model", default=None)
    srv.add_argument("--platform", default="ont",
                     choices=("ont", "hifi", "ilmn"))
    srv.add_argument("--compute_dtype", default="auto",
                     choices=("auto", "fp32", "bf16"))
    srv.add_argument("--host", default="0.0.0.0")
    srv.add_argument("--port", type=int, default=8618)
    srv.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="device of the served nets; cuda raises when no GPU "
                          "is present")
    srv.set_defaults(func=cmd_serve)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return args.func(args)
