"""Command-line interface of the port: ``python -m clair3_tpu_torch
{call,serve,tensor2bin,train,sort_vcf,merge_vcf,decode_probabilities,
dump_tensors,split_bam,models,metrics,validate_gvcf}``, and the reference's
submodule names (``SelectQual``, ``SortVcf``, ``MergeVcf``, ``Train``, ...;
``compat.py``).

The argument surface of ``call`` is ``clair3_tpu.cli._add_call_args`` plus
``--device`` (the counterpart of ``JAX_PLATFORMS``).  That function, the
input validation, the model-file resolution, the dwell-channel
reconciliation, ``cmd_serve``, ``cmd_tensor2bin``, the subcommands that run
no net and their parsers, and the ``tensor2bin`` and ``train`` parsers are
copies of the JAX CLI's framework-free code (held equal to it by
``tests/test_torch_copies.py``; ``train`` adds ``--device``).
``cmd_call`` checks model-zoo names and probes the BAM for move tables in
the JAX CLI's order, before any engine loads.  Both nets load from ``.npz``
or from the reference's ``.pt`` state dicts (``models/convert.py``).
``--device cuda`` (the default of ``call``, ``serve`` and ``train``) raises
when no GPU is present: there is no silent CPU path.

    # a directory with pileup.{npz,pt} and full_alignment.{npz,pt}; ONT with
    # the dwell channel read from the BAM's mv tags
    python -m clair3_tpu_torch call --bam_fn in.bam --ref_fn ref.fa \
        --output out --model_path DIR --platform ont --enable_dwell_time
    # one genome over two processes (run both; on the card process i uses
    # cuda:{i % device count}), each writing out/proc{i}, then merged
    python -m clair3_tpu_torch call ... --output out --dist_coordinator 127.0.0.1:29500 \
        --dist_num_processes 2 --dist_process_id 0      # and 1
    python -m clair3_tpu_torch sort_vcf --input_fn out/proc*/merge_output.vcf.gz \
        --output_fn merged.vcf.gz --ref_fn ref.fa
    python -m clair3_tpu_torch sort_vcf --gvcf --input_fn out/proc*/merge_output.gvcf.gz \
        --output_fn merged.gvcf.gz --ref_fn ref.fa
    python -m clair3_tpu_torch validate_gvcf --gvcf_fn merged.gvcf.gz
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

Under ``--dist_*`` the processes join one gloo group: each calls the chunks
it owns, the QUAL-quantile cutoffs come from every process's rows, and
each contig is phased from every process's het SNPs, so the merged output
is one process's.  Intermediate phasing runs in-process unless
``--use_{whatshap,longphase}_for_intermediate_phasing`` hands it to that
binary.  Known sites (``--vcf_fn``) are added back by the process that owns
their chunk, and ``--use_phasing_for_final_output`` phases each contig from
every process's final rows, haplotagging the BAM on process 0 only.

``train --data_parallel`` trains on every rank of a process group, the JAX
CLI's global mesh: under ``torchrun`` (NCCL on CUDA, gloo on the CPU),
else one rank per visible GPU, else this process alone:

    torchrun --nproc_per_node=<cards> -m clair3_tpu_torch train --bin_fn p.bin \
        --output_dir m --pileup --data_parallel
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import sys
from typing import Optional

import numpy as np
import torch

from clair3_tpu_torch.device import resolve_device
from clair3_tpu_torch.parallel.mesh import local_devices

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
                 compute_dtype: torch.dtype, devices=None):
    """The engines as ``clair3_tpu.cli._load_engine`` builds them: pileup
    batches as int16 or their compact form; full-alignment batches cropped
    to their depth band and packed.  Each batch is split over ``devices``
    (default ``parallel.mesh.local_devices(device)``: every visible card
    for ``cuda``, the one card for ``cuda:k``, ``[cpu]`` on the CPU), as
    the JAX loader's engines shard it over the local mesh; the net is
    loaded once, on the first, and replicated on the others."""
    from clair3_tpu_torch.pipeline.engine import InferenceEngine

    devices = list(devices or local_devices(device))
    model = load_model(path, kind, devices[0], compute_dtype)
    if kind == "pileup":
        # counts are bounded by ~1.5x max_depth after the high-coverage
        # rescale, so int16 halves the host->device copy losslessly, and
        # the compact form halves it again
        return InferenceEngine(model, devices[0], transfer_dtype=np.int16,
                               pileup_compact=True, devices=devices)
    engine = InferenceEngine(model, devices[0], transfer_dtype=np.int8,
                             depth_crop=True, fa_compact=True, devices=devices)
    engine.fa_input_channels = model.input_channels
    return engine


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
    if args.disable_c_impl:  # also governs the readers the validators open
        os.environ["CLAIR3T_DISABLE_NATIVE"] = "1"
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

    # --dist_process_id alone runs single-process, as in clair3_tpu
    multi = args.dist_coordinator is not None or (args.dist_num_processes or 0) > 1
    if multi and None in (args.dist_coordinator, args.dist_num_processes,
                          args.dist_process_id):
        print("[ERROR] multi-process calling needs --dist_coordinator, "
              "--dist_num_processes and --dist_process_id", file=sys.stderr)
        return 1
    dist_id, dist_count = 0, 1
    try:
        if multi:
            from clair3_tpu_torch.parallel.distributed import init_distributed

            dist_id, dist_count = init_distributed(
                coordinator_address=args.dist_coordinator,
                num_processes=args.dist_num_processes,
                process_id=args.dist_process_id)
            if dist_count > 1:
                args.output_dir = os.path.join(args.output_dir, f"proc{dist_id}")
                print(f"[INFO] multi-process: process {dist_id}/{dist_count}, "
                      f"outputs -> {args.output_dir}; merge the per-process "
                      "VCFs afterwards with `clair3_tpu_torch sort_vcf`",
                      file=sys.stderr)
        return _run_call(args, dist_id, dist_count)
    finally:
        # a peer blocked in a collective sees this process leave, not a hang
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _run_call(args: argparse.Namespace, dist_id: int, dist_count: int) -> int:
    """``call`` once its inputs are validated (and, under ``--dist_*``, the
    process group is joined).  A lone process on ``--device cuda`` splits
    each engine batch over every visible card (``CUDA_VISIBLE_DEVICES``
    narrows them); process ``dist_id`` of ``dist_count`` calls its own
    chunks on its own card alone (``cuda:{dist_id % device_count}``), the
    port's rule for processes that share a host."""
    from clair3_tpu_torch.config import CallConfig
    from clair3_tpu_torch.pipeline.call import VariantCaller

    if args.debug and not args.pileup_only:
        print("[INFO] --debug suppresses VCF rows, so the full-alignment "
              "stage has no candidates to re-call; implying --pileup_only",
              file=sys.stderr)
        args.pileup_only = True

    # a --remote_engines client loads no net and runs nothing on a device
    device = None if args.remote_engines else resolve_device(args.device)
    if device is not None and device.type == "cuda" and dist_count > 1:
        device = torch.device("cuda", dist_id % torch.cuda.device_count())
    fields = {f.name for f in dataclasses.fields(CallConfig)}
    cfg = CallConfig(**{**{k: v for k, v in vars(args).items() if k in fields},
                        "dist_process_id": dist_id, "dist_process_count": dist_count})

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
        logging.getLogger(__name__).info(
            "[engine] each batch split over %d device(s): %s", len(pileup_engine.devices),
            ", ".join(map(str, pileup_engine.devices)))
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
        if dist_count > 1:
            from clair3_tpu_torch.parallel.distributed import GatheredPhaser

            phaser = GatheredPhaser(phaser)

    caller_cls = VariantCaller
    if dist_count > 1:
        from clair3_tpu_torch.parallel.distributed import DistributedCaller

        caller_cls = DistributedCaller
    caller = caller_cls(cfg, pileup_engine=pileup_engine, fa_engine=fa_engine, phaser=phaser)
    if args.profile_dir:
        outputs = _profiled_run(caller, args.profile_dir, device)
    else:
        outputs = caller.run()
    for name, path in outputs.items():
        print(f"[INFO] {name}: {path}")
    if device is not None and device.type == "cuda":
        from clair3_tpu_torch.ops import pileup_full

        logging.getLogger(__name__).info("[kernels] %s",
                                         json.dumps(pileup_full.kernel_launches))
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
    ``clair3_tpu.cli.cmd_train``.  With ``--data_parallel`` every rank of a
    data-parallel group (``parallel/mesh.py::run_ranks``: torchrun's ranks,
    else one per visible GPU, else this process) trains on its share of
    each batch, the counterpart of the JAX CLI's global mesh."""
    device = resolve_device(args.device)
    if args.data_parallel:
        from clair3_tpu_torch.parallel.mesh import run_ranks

        run_ranks(functools.partial(_train, args, data_parallel=True), device)
    else:
        _train(args, device)
    return 0


def _train(args: argparse.Namespace, device: torch.device, data_parallel: bool = False) -> None:
    """``train`` on ``device``; with ``data_parallel``, as this process's
    rank of the joined group (rank 0 reports)."""
    from clair3_tpu_torch.config import TrainConfig
    from clair3_tpu_torch.train.trainer import train_model

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
                         use_class_weights=args.use_class_weights, device=device,
                         data_parallel=data_parallel)
    import torch.distributed as dist

    if not data_parallel or dist.get_rank() == 0:
        print(f"[INFO] best_val_loss={result['best_val_loss']:.4f} "
              f"model={result['model_path']}")


def cmd_decode_probabilities(args: argparse.Namespace) -> int:
    """Re-decode dumped probabilities into VCF rows (reference:
    CallVariants --input_probabilities)."""
    import numpy as np

    from clair3_tpu_torch.decode import DecodeConfig, decode_candidate

    cfg = DecodeConfig(
        add_indel_length=not args.pileup,
        pileup=args.pileup,
        show_ref_calls=args.show_ref,
        gvcf=False,
        debug=getattr(args, "debug", False),
    )
    out = open(args.output_fn, "w") if args.output_fn else sys.stdout
    with open(args.probabilities_fn) as fh:
        for line in fh:
            pos_info, alt_info, probs_s = line.rstrip("\n").split("\t")
            probs = np.fromstring(probs_s, sep=" ")
            row = decode_candidate(pos_info, alt_info, probs, cfg)
            if row:
                out.write(row)
    if args.output_fn:
        out.close()
    return 0


def cmd_sort_vcf(args: argparse.Namespace) -> int:
    """Sort/dedup VCF body rows from input files into one indexed VCF
    (SortVcf equivalent).  With ``--gvcf`` the inputs are gVCF shards
    (e.g. per-process ``merge_output.gvcf.gz`` from a ``--dist_*`` run,
    whose non-variant blocks close at chunk boundaries): rows merge in
    contig/position order under the gVCF header, byte-identical to a
    single-process run's merged gVCF."""
    from clair3_tpu_torch.io.vcf import VcfWriter, get_header
    from clair3_tpu_torch.io.bgzf import decompress, is_gzipped
    from clair3_tpu_torch.pipeline.merge_sort import sort_rows

    rows = []
    for path in args.input_fn:
        text = decompress(path).decode() if is_gzipped(path) else open(path).read()
        rows.extend(l + "\n" for l in text.splitlines() if l and not l.startswith("#"))
    out_rows = sort_rows(rows)
    header_contigs = None
    if getattr(args, "gvcf", False) and args.ref_fn:
        # called-contig header lines, like VariantCaller._write_gvcf:
        # fai order + lengths, restricted to contigs present in the rows
        from clair3_tpu_torch.io.fasta import FastaFile

        seen = {r.split("\t", 1)[0] for r in out_rows}
        fai = FastaFile(args.ref_fn)
        header_contigs = [(n, fai.contig_length(n)) for n in fai.references
                          if n in seen]
        fai.close()
    header = get_header(reference_file_path=args.ref_fn,
                        sample_name=args.sample_name,
                        gvcf=getattr(args, "gvcf", False),
                        contigs=header_contigs)
    with VcfWriter(args.output_fn, header) as w:
        for row in out_rows:
            w.write(row)
    if args.output_fn.endswith(".gz"):
        from clair3_tpu_torch.io.tabix import write_tabix_index

        write_tabix_index(args.output_fn)
    print(f"[INFO] wrote {len(out_rows)} rows to {args.output_fn}")
    return 0


def cmd_merge_vcf(args: argparse.Namespace) -> int:
    """Merge pileup + full-alignment VCFs (MergeVcf equivalent).  Default:
    FA calls win at their positions.  --platform ilmn: region-scoped merge
    (realignment shifts candidate positions, so inside each full-alignment
    window only FA calls survive; reference MergeVcf.py:59-155)."""
    import os

    from clair3_tpu_torch.io.vcf import VcfWriter, get_header
    from clair3_tpu_torch.io.bgzf import decompress, is_gzipped
    from clair3_tpu_torch.pipeline.merge_sort import (
        RegionIndex, merge_pileup_and_full_alignment,
        merge_pileup_and_full_alignment_illumina, read_full_aln_regions,
        sort_rows)

    def read_rows(path):
        text = decompress(path).decode() if is_gzipped(path) else open(path).read()
        return [l + "\n" for l in text.splitlines() if l and not l.startswith("#")]

    if args.platform == "ilmn":
        if not args.full_aln_regions and not args.bed_fn_prefix:
            print("[ERROR] --platform ilmn merge needs --full_aln_regions "
                  "or --bed_fn_prefix", file=sys.stderr)
            return 1
        paths = list(args.full_aln_regions or [])
        if args.bed_fn_prefix:
            if not os.path.isdir(args.bed_fn_prefix):
                print(f"[ERROR] Input directory: {args.bed_fn_prefix} not "
                      "exists!", file=sys.stderr)
                return 1
            # the reference concatenates every {ctg}.* candidate shard in
            # the folder (MergeVcf.py:71-80); shards are named
            # {ctg}.{idx}_{num}, so without --ctg_name match that shape
            # rather than every file (the folder also holds FULL_ALN_FILE_*
            # bookkeeping rows, which are not BED)
            import re

            if args.ctg_name:
                keep = lambda f: f.startswith(args.ctg_name + ".")  # noqa: E731
            else:
                keep = lambda f: re.fullmatch(r".+\.\d+_\d+", f)  # noqa: E731
            paths += sorted(
                os.path.join(args.bed_fn_prefix, f)
                for f in os.listdir(args.bed_fn_prefix) if keep(f))
        # zero matching shards => empty region tree => pileup-only merge
        # (the reference's bed_fn stays None and bed_tree_from returns an
        # empty tree, MergeVcf.py:73-85)
        merged = merge_pileup_and_full_alignment_illumina(
            read_rows(args.pileup_vcf_fn),
            read_rows(args.full_alignment_vcf_fn),
            RegionIndex(read_full_aln_regions(paths)),
            contig=args.ctg_name, qual_cutoff=args.qual,
            print_ref_calls=args.print_ref_calls,
            haploid_precise=args.haploid_precise,
            haploid_sensitive=args.haploid_sensitive)
    else:
        merged = merge_pileup_and_full_alignment(
            read_rows(args.pileup_vcf_fn), read_rows(args.full_alignment_vcf_fn),
            contig=args.ctg_name, qual_cutoff=args.qual,
            print_ref_calls=args.print_ref_calls,
            haploid_precise=args.haploid_precise,
            haploid_sensitive=args.haploid_sensitive)
    merged = sort_rows(merged)
    header = get_header(reference_file_path=args.ref_fn,
                        sample_name=args.sample_name)
    with VcfWriter(args.output_fn, header) as w:
        for row in merged:
            w.write(row)
    if args.output_fn.endswith(".gz"):
        from clair3_tpu_torch.io.tabix import write_tabix_index

        write_tabix_index(args.output_fn)
    print(f"[INFO] wrote {len(merged)} rows to {args.output_fn}")
    return 0


def cmd_dump_tensors(args: argparse.Namespace) -> int:
    """Dump candidate tensors + positions/alt-info to the reference's
    fixture format — `{prefix}.npy` plus `{prefix}.npy.info` rows
    `pos_info\\talt_info` (reference: CreateTensorPileupFromCffi.py:443-452,
    read back by CallVariantsFromCffi.py:107-133).  Debug/visualization
    aid and golden-fixture generator."""
    import numpy as np

    from clair3_tpu_torch.config import PLATFORMS

    preset = PLATFORMS[args.platform]
    if args.full_alignment:
        from clair3_tpu_torch.fullalign.extractor import create_fa_tensors

        if not args.candidates_fn:
            print("[ERROR] --full_alignment needs --candidates_fn "
                  "(1-based positions, one per line)", file=sys.stderr)
            return 1
        with open(args.candidates_fn) as fh:
            positions = [int(l.split()[0]) for l in fh if l.strip()]
        tensors, pos_infos, alt_infos = create_fa_tensors(
            args.bam_fn, args.ref_fn, args.ctg_name, positions,
            matrix_depth=preset.matrix_depth, min_mq=args.min_mq,
            no_phasing=True, enable_dwell=args.enable_dwell_time)
    else:
        from clair3_tpu_torch.pileup.extractor import create_pileup_tensors

        from clair3_tpu_torch.io.fasta import FastaFile

        end = args.ctg_end
        if end is None:
            fa = FastaFile(args.ref_fn)
            end = fa.contig_length(args.ctg_name)
            fa.close()
        tensors, pos_infos, alt_infos, _ = create_pileup_tensors(
            args.bam_fn, args.ref_fn, args.ctg_name, args.ctg_start, end,
            min_mq=args.min_mq,
            min_snp_af=preset.snp_min_af, min_indel_af=preset.indel_min_af)
    np.save(args.tensor_fn, tensors)
    path = args.tensor_fn if args.tensor_fn.endswith(".npy") \
        else args.tensor_fn + ".npy"
    with open(path + ".info", "w") as fh:
        for pos_info, alt_info in zip(pos_infos, alt_infos):
            fh.write(f"{pos_info}\t{alt_info}\n")
    print(f"[INFO] dumped {len(pos_infos)} candidate tensors "
          f"{tuple(tensors.shape)} -> {path}(.info)")
    return 0


def cmd_split_bam(args: argparse.Namespace) -> int:
    """Split a haplotagged BAM into per-haplotype BAMs (the reference's
    split-into-haplotypes haploid calling workflow,
    docs/split_haplotype_into_haploid_calling.md, uses whatshap haplotag
    + samtools split; here the HP tags written by
    --use_haplotagging_for_final_output feed this directly)."""
    import os

    from clair3_tpu_torch.io.bam import BamReader, write_bam

    os.makedirs(args.output_dir, exist_ok=True)
    bam = BamReader(args.bam_fn)
    outs = {}
    untagged = 0
    # one streaming pass per haplotype: write_bam consumes a generator, so
    # a WGS-scale BAM never needs its reads resident in memory
    for hap, name in ((1, "hap1"), (2, "hap2")):
        n = untagged = 0

        def reads():
            nonlocal n, untagged
            for read in BamReader(args.bam_fn):
                hp = read.tags.get("HP")
                if hp == hap or (hp not in (1, 2) and args.include_untagged):
                    n += 1
                    yield read
                if hp not in (1, 2):
                    untagged += 1

        path = os.path.join(args.output_dir, f"{name}.bam")
        write_bam(path, bam.references, bam.lengths, reads())
        outs[name] = path
        print(f"[INFO] {name}: {n} reads -> {path}")
    print(f"[INFO] untagged reads: {untagged} "
          f"({'included in both' if args.include_untagged else 'dropped'})")
    print("[INFO] call each haplotype with: clair3_tpu_torch call --bam_fn "
          f"{outs['hap1']} ... --haploid_precise (or --haploid_sensitive)")
    return 0


def cmd_models(args: argparse.Namespace) -> int:
    from clair3_tpu_torch.models.zoo import format_zoo_table

    print(format_zoo_table())
    return 0


def cmd_metrics(args: argparse.Namespace) -> int:
    """SNP/Indel precision-recall-F1 (GetOverallMetrics equivalent)."""
    from clair3_tpu_torch.postprocess import parse_happy_vcf, variant_metrics

    if args.happy_vcf_fn:
        rows = parse_happy_vcf(args.happy_vcf_fn, args.ctg_name)
    else:
        from clair3_tpu_torch.io.vcf import VcfReader

        truth = [r for r in VcfReader(args.truth_vcf_fn)
                 if not args.ctg_name or r.chrom == args.ctg_name]
        query = [r for r in VcfReader(args.query_vcf_fn)
                 if not args.ctg_name or r.chrom == args.ctg_name]
        rows = variant_metrics(truth, query,
                               genotype_match=not args.ignore_genotype)
    header = ["VariantType", "Query_FP", "Truth_FN", "Truth_TP", "Query_TP",
              "Precision", "Recall", "F1-score"]
    print("".join(h.ljust(14) for h in header))
    for vt in ("SNP", "INDEL"):
        m = rows[vt]
        print("".join(str(x).ljust(14) for x in (
            vt, m.query_fp, m.truth_fn, m.truth_tp, m.query_tp,
            m.precision, m.recall, m.f1)))
    return 0


def cmd_validate_gvcf(args: argparse.Namespace) -> int:
    """Structural gVCF validation (gvcf_validate.py)."""
    from clair3_tpu_torch.gvcf_validate import main as validate_main

    argv = ["--gvcf_fn", args.gvcf_fn]
    if args.bed_fn:
        argv += ["--bed_fn", args.bed_fn]
    return validate_main(argv)



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
    if argv is None:
        argv = sys.argv[1:]
    # reference submodule spellings: `python -m clair3_tpu_torch SelectQual ...`
    # (reference: clair3.py:80-104 dispatcher)
    from clair3_tpu_torch.compat import dispatch

    rc = dispatch(list(argv))
    if rc is not None:
        return rc
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
                    help="shard batches over all devices via a process group "
                         "(torchrun --nproc_per_node=<cards>, else one rank per "
                         "visible GPU)")
    tr.add_argument("--chkpnt_fn", default=None,
                    help="initial .npz checkpoint for fine-tuning/resume")
    tr.add_argument("--use_class_weights", action="store_true",
                    help="effective-number class-balanced focal loss weights")
    tr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the trained net; cuda raises when no GPU "
                         "is present")
    tr.set_defaults(func=cmd_train)

    sv = sub.add_parser("sort_vcf", help="sort/dedup VCFs into one indexed VCF")
    sv.add_argument("--input_fn", nargs="+", required=True)
    sv.add_argument("--output_fn", required=True)
    sv.add_argument("--ref_fn", default=None)
    sv.add_argument("--sample_name", default="SAMPLE")
    sv.add_argument("--gvcf", action="store_true",
                    help="inputs are gVCF shards: emit the gVCF header "
                         "(non-variant blocks merge in position order)")
    sv.set_defaults(func=cmd_sort_vcf)

    mv = sub.add_parser("merge_vcf", help="merge pileup + full-alignment VCFs")
    mv.add_argument("--pileup_vcf_fn", required=True)
    mv.add_argument("--full_alignment_vcf_fn", required=True)
    mv.add_argument("--output_fn", required=True)
    mv.add_argument("--ref_fn", default=None)
    mv.add_argument("--sample_name", default="SAMPLE")
    mv.add_argument("--ctg_name", default=None)
    mv.add_argument("--qual", type=float, default=None)
    mv.add_argument("--print_ref_calls", action="store_true")
    mv.add_argument("--haploid_precise", action="store_true")
    mv.add_argument("--haploid_sensitive", action="store_true")
    mv.add_argument("--platform", default="ont", choices=("ont", "hifi", "ilmn"))
    mv.add_argument("--full_aln_regions", nargs="+", default=None,
                    help="ilmn: full-alignment region BED file(s)")
    mv.add_argument("--bed_fn_prefix", default=None,
                    help="ilmn: candidate folder holding {ctg}.* region "
                         "shards (reference spelling)")
    mv.set_defaults(func=cmd_merge_vcf)

    dp = sub.add_parser("decode_probabilities",
                        help="re-decode dumped head probabilities to VCF rows")
    dp.add_argument("--probabilities_fn", required=True)
    dp.add_argument("--output_fn", default=None)
    dp.add_argument("--pileup", action="store_true")
    dp.add_argument("--show_ref", action="store_true")
    dp.add_argument("--debug", action="store_true",
                    help="print raw head probabilities instead of VCF rows")
    dp.set_defaults(func=cmd_decode_probabilities)

    dt = sub.add_parser("dump_tensors",
                        help="dump candidate tensors to the reference's "
                             ".npy + .info fixture format")
    dt.add_argument("--bam_fn", required=True)
    dt.add_argument("--ref_fn", required=True)
    dt.add_argument("--ctg_name", required=True)
    dt.add_argument("--ctg_start", type=int, default=1)
    dt.add_argument("--ctg_end", type=int, default=None)
    dt.add_argument("--tensor_fn", required=True,
                    help="output prefix; writes {prefix}.npy + .npy.info")
    dt.add_argument("--platform", default="ont", choices=("ont", "hifi", "ilmn"))
    dt.add_argument("--min_mq", type=int, default=5)
    dt.add_argument("--full_alignment", action="store_true",
                    help="dump FA tensors for --candidates_fn positions "
                         "instead of pileup tensors")
    dt.add_argument("--candidates_fn", default=None)
    dt.add_argument("--enable_dwell_time", action="store_true")
    dt.set_defaults(func=cmd_dump_tensors)

    sb = sub.add_parser("split_bam",
                        help="split a haplotagged BAM (HP tags) into "
                             "per-haplotype BAMs for haploid calling")
    sb.add_argument("--bam_fn", required=True)
    sb.add_argument("--output_dir", required=True)
    sb.add_argument("--include_untagged", action="store_true",
                    help="route untagged reads into both haplotype BAMs")
    sb.set_defaults(func=cmd_split_bam)


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

    zl = sub.add_parser(
        "models",
        help="list the known pretrained checkpoint registry (models/zoo.py)")
    zl.set_defaults(func=cmd_models)

    mt = sub.add_parser("metrics", help="SNP/Indel P/R/F1 vs a truth set")
    mt.add_argument("--truth_vcf_fn", default=None)
    mt.add_argument("--query_vcf_fn", default=None)
    mt.add_argument("--happy_vcf_fn", default=None,
                    help="digest a hap.py output VCF instead")
    mt.add_argument("--ctg_name", default=None)
    mt.add_argument("--ignore_genotype", action="store_true")
    mt.set_defaults(func=cmd_metrics)

    vg = sub.add_parser(
        "validate_gvcf",
        help="structural gVCF validator (GATK-ValidateVariants-equivalent: "
             "block continuity, END ordering, PL/GQ consistency, header "
             "contract)")
    vg.add_argument("--gvcf_fn", required=True)
    vg.add_argument("--bed_fn", default=None,
                    help="regions the run was restricted to (coverage gaps "
                         "allowed only across region boundaries)")
    vg.set_defaults(func=cmd_validate_gvcf)

    args = parser.parse_args(argv)
    return args.func(args)
