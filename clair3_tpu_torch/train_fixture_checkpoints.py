"""Train the fixture checkpoints through the port, the twin of
``scripts/train_fixture_checkpoints.py``.

Runs the port's full-cascade demo (``full_cascade_demo.run``) at the 1.2 Mb
configuration on ``--device`` (default ``cuda``): both nets trained for
real, the held-out 200 kb called and its F1 gated at 0.995/0.99.  Then it
freezes the two checkpoints as float16 .npz files together with a manifest
recording the training configuration and the achieved held-out accuracy.
Either package loads them (``models/params_io.load_variables``).

    python -m clair3_tpu_torch.train_fixture_checkpoints OUT_DIR [hifi|ont] [--device cpu]

Everything goes under OUT_DIR: the demo's work in OUT_DIR/demo, the frozen
``pileup_{platform}.npz`` / ``fa_{platform}.npz`` and the manifest in
OUT_DIR.  OUT_DIR may not lie under ``tests/fixtures/``: the committed
fixtures are replaced only by copying reviewed files there by hand.  Nothing
is frozen when the demo's gates fail (exit 1).  The ``C3T_DEMO_*`` and
``C3T_GATE_*`` variables of the demo scale the run, as in the JAX script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _freeze(src_npz: str, dst_npz: str) -> None:
    """Re-save a checkpoint with float params narrowed to fp16 (halves the
    committed size; inference runs bf16 anyway so fp16's 10 mantissa bits
    are not the precision floor)."""
    with np.load(src_npz) as data:
        flat = {k: data[k] for k in data.files}
    flat = {k: (v.astype(np.float16) if v.dtype == np.float32 else v)
            for k, v in flat.items()}
    np.savez_compressed(dst_npz, **flat)


def under_fixtures(path: str) -> bool:
    """Whether ``path`` is, or lies under, a ``tests/fixtures`` directory
    (this checkout's, or any other)."""
    real = os.path.realpath(path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ours = os.path.realpath(os.path.join(repo, "tests", "fixtures"))
    parts = real.split(os.sep)
    return (real == ours or real.startswith(ours + os.sep)
            or any(parts[i:i + 2] == ["tests", "fixtures"] for i in range(len(parts))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.train_fixture_checkpoints",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", help="where the frozen checkpoints and the manifest go "
                                    "(not under tests/fixtures/)")
    ap.add_argument("platform", nargs="?", default="hifi", choices=("hifi", "ont"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of training and calling; cuda raises when no GPU "
                         "is present")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if under_fixtures(args.out_dir):
        print(f"[fixture] refusing to write under tests/fixtures/: {args.out_dir}; "
              f"freeze into another directory and copy reviewed files there by hand",
              file=sys.stderr)
        return 2
    # the calibrated 1.2 Mb configuration: 1 Mb training region, 200 kb
    # held out, 1500/1000 optimization steps — the demo's defaults
    # (400/300) undertrain at this scale
    os.environ.setdefault("C3T_DEMO_L", "1200000")
    os.environ.setdefault("C3T_DEMO_TRAIN_END", "1000000")
    os.environ.setdefault("C3T_DEMO_STEPS_P", "1500")
    os.environ.setdefault("C3T_DEMO_STEPS_F", "1000")
    from clair3_tpu_torch import full_cascade_demo as demo
    from clair3_tpu_torch.decode import shutdown_decode_pool
    from clair3_tpu_torch.testing import PLATFORMS

    platform = args.platform
    P = PLATFORMS[platform]
    try:
        result = demo.run(os.path.join(args.out_dir, "demo"), platform=platform,
                          device=args.device)
    finally:
        shutdown_decode_pool()
    if not result["ok"]:
        print(f"[fixture] demo gates failed; NOT freezing fixtures: {result}")
        return 1

    names = (f"pileup_{platform}.npz", f"fa_{platform}.npz")
    _freeze(result["pileup_model"], os.path.join(args.out_dir, names[0]))
    _freeze(result["fa_model"], os.path.join(args.out_dir, names[1]))
    manifest = {
        "scale_bp": result["scale_bp"],
        "held_out_snp_f1": result["snp_f1"],
        "held_out_indel_f1": result["indel_f1"],
        "gates": result["gates"],
        "platform": platform,
        "matrix_depth": P["matrix_depth"],
        "pileup": {"add_indel_length": False},
        "fa": {"add_indel_length": True, "input_channels": P["channels"]},
        "simulator": {"seed": 7, "coverage": P["coverage"],
                      "read_length": P["read_length"],
                      "error_rate": P["error_rate"], "variant_step": 130,
                      "with_mv_tags": P["with_mv_tags"]},
        "trainer": (f"clair3_tpu_torch/full_cascade_demo.py run() at "
                    f"C3T_DEMO_L={result['scale_bp']} on {args.device}"),
    }
    # hifi keeps the historical manifest.json name; other platforms get
    # manifest_{platform}.json alongside
    mf = "manifest.json" if platform == "hifi" else f"manifest_{platform}.json"
    with open(os.path.join(args.out_dir, mf), "w") as fh:
        json.dump(manifest, fh, indent=2)
        fh.write("\n")
    for f in names:
        sz = os.path.getsize(os.path.join(args.out_dir, f)) / 1e6
        print(f"[fixture] {f}: {sz:.1f} MB")
    print(f"[fixture] frozen [{platform}] into {args.out_dir}; held-out SNP F1 "
          f"{result['snp_f1']} INDEL F1 {result['indel_f1']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
