"""Seed sweep of the full-cascade demo: how the held-out SNP/INDEL F1 of the
demo's 260 kb hifi run varies with the training seed (initial weights,
dropout masks, chunk offset and shuffle), for the JAX package's demo or the
PyTorch port's.

    JAX_PLATFORMS=cpu python tools/demo_seed_sweep.py jax OUT 1 2 3
    python tools/demo_seed_sweep.py torch OUT 0 1 2 3 4 5   # on a GPU

Both demos fix ``TrainConfig(seed=0)``; this script replaces that seed and
changes nothing else.  ``jax`` runs ``scripts/full_cascade_demo.py`` once per
seed (simulation, bins, training, call).  ``torch`` simulates and builds the
bins once, then trains both nets on the GPU and calls the held-out region at
bf16 for each seed, with ``cudnn.deterministic`` and TF32 off as
``chip_smoke.py`` phase 7 runs it.  One JSON line per seed is printed.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _seeded(config_module, seed: int) -> None:
    """Make every ``TrainConfig(...)`` built after this call use ``seed``."""
    base = config_module.TrainConfig

    def train_config(**kw):
        kw["seed"] = seed
        return base(**kw)

    config_module.TrainConfig = train_config


def sweep_jax(out_dir: str, seeds) -> None:
    import clair3_tpu.config as config

    spec = importlib.util.spec_from_file_location(
        "full_cascade_demo", os.path.join(ROOT, "scripts", "full_cascade_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    base = config.TrainConfig
    for seed in seeds:
        _seeded(config, seed)
        r = demo.run(os.path.join(out_dir, f"seed_{seed}"))
        config.TrainConfig = base
        print(json.dumps({"impl": "jax", "seed": seed, "snp_f1": r["snp_f1"],
                          "indel_f1": r["indel_f1"]}), flush=True)


def sweep_torch(out_dir: str, seeds) -> None:
    import torch

    import clair3_tpu_torch.config as config
    from clair3_tpu_torch import full_cascade_demo as demo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda")
    setup = demo.prepare(out_dir)
    base = config.TrainConfig
    for seed in seeds:
        _seeded(config, seed)
        results = demo.train_nets(setup, device)
        config.TrainConfig = base
        outputs = demo.call_held_out(setup, results["pileup"]["model_path"],
                                     results["fa"]["model_path"], device,
                                     tag=f"out_seed_{seed}")
        _, m = demo.score(setup, outputs)
        demo.print_metrics(m)
        print(json.dumps({"impl": "torch", "seed": seed, "snp_f1": m["SNP"].f1,
                          "indel_f1": m["INDEL"].f1,
                          "best_val_loss": {k: r["best_val_loss"] for k, r in results.items()}}),
              flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3 or argv[0] not in ("jax", "torch"):
        print(__doc__)
        return 2
    impl, out_dir, seeds = argv[0], argv[1], [int(s) for s in argv[2:]]
    os.makedirs(out_dir, exist_ok=True)
    try:
        (sweep_jax if impl == "jax" else sweep_torch)(out_dir, seeds)
    finally:
        if impl == "torch":
            from clair3_tpu_torch.decode import shutdown_decode_pool

            shutdown_decode_pool()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
