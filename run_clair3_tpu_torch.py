#!/usr/bin/env python
"""Reference-style entry point: accepts the familiar run_clair3.py flag
surface and dispatches to ``clair3_tpu_torch call``.

    python run_clair3_tpu_torch.py --bam_fn in.bam --ref_fn ref.fa \
        --output out/ --platform ont --model_path models/
"""

import sys


def main() -> int:
    from clair3_tpu_torch.cli import main as cli_main

    argv = sys.argv[1:]
    if "--version" in argv:
        return cli_main(["--version"])
    # reference spellings that differ from the clair3_tpu_torch CLI
    renames = {
        "--ctgName": "--ctg_name",
        "--sampleName": "--sample_name",
        "--threads_num": "--threads",
    }
    # external-tool paths the reference accepts but the single-program design
    # has no use for (value-taking flags); --device passes on to `call`,
    # which runs on the GPU unless it says cpu
    ignored = {"--pypy", "--python", "--samtools", "--parallel"}
    # reference boolean flags take an explicit True/False value
    # (run_clair3.py add_bool_arg); ours are store_true.  Emit the flag only
    # when the value is truthy.  --longphase_for_phasing is the legacy alias
    # for --use_longphase_for_intermediate_phasing (run_clair3.py:328).
    bool_valued = {
        "--use_whatshap_for_intermediate_phasing":
            "--use_whatshap_for_intermediate_phasing",
        "--use_longphase_for_intermediate_phasing":
            "--use_longphase_for_intermediate_phasing",
        "--longphase_for_phasing": "--use_longphase_for_intermediate_phasing",
        "--use_whatshap_for_final_output_phasing":
            "--use_phasing_for_final_output",
        "--use_longphase_for_final_output_phasing":
            "--use_phasing_for_final_output",
        "--enable_phasing": "--use_phasing_for_final_output",
        "--use_whatshap_for_final_output_haplotagging":
            "--use_haplotagging_for_final_output",
        "--fast_mode": "--fast_mode",
        "--include_all_ctgs": "--include_all_ctgs",
        "--remove_intermediate_dir": "--remove_intermediate_dir",
        "--output_all_contigs_in_gvcf_header":
            "--output_all_contigs_in_gvcf_header",
        "--disable_c_impl": "--disable_c_impl",
    }
    out = ["call"]
    skip_value = False
    pending_bool = None
    for arg in argv:
        if pending_bool is not None:
            if arg.lower() in ("true", "1", "yes"):
                out.append(pending_bool)
            pending_bool = None
            continue
        if skip_value:
            skip_value = False
            continue
        if arg.startswith("--"):
            key = arg.split("=", 1)[0]
            if key in ignored:
                print(f"[INFO] ignoring {key} (not needed by clair3_tpu_torch)",
                      file=sys.stderr)
                skip_value = "=" not in arg
                continue
            if key in bool_valued:
                if "=" in arg:
                    if arg.split("=", 1)[1].lower() in ("true", "1", "yes"):
                        out.append(bool_valued[key])
                else:
                    pending_bool = bool_valued[key]
                continue
        if "=" in arg and arg.startswith("--"):
            key, val = arg.split("=", 1)
            out.append(f"{renames.get(key, key)}={val}")
        else:
            out.append(renames.get(arg, arg))
    return cli_main(out)


if __name__ == "__main__":
    raise SystemExit(main())
