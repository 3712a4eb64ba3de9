"""Command-line interface of the port: ``python -m clair3_tpu_torch call``.

The argument surface is ``clair3_tpu.cli._add_call_args`` plus ``--device``
(the counterpart of ``JAX_PLATFORMS``); input validation, model-file
resolution and the dwell-channel reconciliation are the JAX package's own
framework-free helpers.  ``--device cuda`` (the default) raises when no GPU
is present: there is no silent CPU path.

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

from clair3_tpu.cli import (_add_call_args, _reconcile_dwell,
                            _validate_call_inputs, resolve_model_file)

_DTYPES = {"fp32": torch.float32, "f32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


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
    from clair3_tpu.config import CallConfig
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
        from clair3_tpu.testing import FullAlignmentOracleEngine, PileupOracleEngine

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
        from clair3_tpu.io.bam import probe_mv_tag

        has_mv, _, checked = probe_mv_tag(cfg.bam_fn)
        if not has_mv:
            print(f"[ERROR] dwell time is enabled but none of the first "
                  f"{checked} alignments carries a valid 'mv' tag",
                  file=sys.stderr)
            return 1

    phaser = None
    if fa_engine is not None and not cfg.no_phasing_for_fa:
        from clair3_tpu.phase import ReadBackedPhaser

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
