"""Graft entry points of the port, the twin of ``__graft_entry__.py``: a
one-device forward check and a multi-rank dry run.

    python -c "from clair3_tpu_torch.graft_entry import entry; fn, args = entry(); fn(*args)"
    python -c "from clair3_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(8)"

``entry`` runs on ``cuda`` unless asked for the CPU.  ``dryrun_multichip``,
like its JAX original (which forces N virtual CPU devices), is a dry run on
the CPU by design: N gloo ranks, each an OS process (``parallel/mesh.py``),
for the training step, and N CPU replicas of one engine for inference.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch


def entry(device="cuda"):
    """``(fn, args)``: the flagship full-alignment net
    (``FullAlignmentNet(add_indel_length=True)``, flax's initialisers drawn
    from seed 0) in eval mode on ``device``, and int8 ``[256, 89, 33, 8]``
    from ``np.random.default_rng(0)``; ``fn(*args)`` gives ``[256, 90]``
    probabilities."""
    from clair3_tpu_torch.device import resolve_device
    from clair3_tpu_torch.models import FullAlignmentNet
    from clair3_tpu_torch.models.init import init_weights

    dev = resolve_device(device)
    model = FullAlignmentNet(add_indel_length=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -100, 100, size=(256, 89, 33, 8)).astype(np.int8)).to(dev)

    def fn(model, x):
        with torch.inference_mode():
            return model(x)

    return fn, (model, x)


def _dryrun_batch(n_devices: int):
    """The JAX dry run's padded global batch: ``B = max(2n, 8)`` rows of
    int8 ``[55, 33, 8]`` and its fixed labels."""
    B = max(2 * n_devices, 8)
    x = np.random.default_rng(0).integers(-100, 100, size=(B, 55, 33, 8)).astype(np.int8)
    y = np.zeros((B, 90), np.float32)
    y[:, 0] = 1.0
    y[:, 21] = 1.0
    y[:, 24 + 16] = 1.0
    y[:, 57 + 16] = 1.0
    return x, y


def _dryrun_rank(n_devices: int, device: torch.device) -> None:
    """One rank of ``dryrun_multichip``: a DDP training step of the FA net
    on this rank's shard of the global batch; then on rank 0 the JAX dry
    run's inference: one engine batch sharded over ``n_devices`` replicas of
    the trained net on this rank's device, and the miniature cascade on
    engines over the same devices."""
    import torch.distributed as dist

    from clair3_tpu_torch.models import FullAlignmentNet
    from clair3_tpu_torch.models.init import init_weights
    from clair3_tpu_torch.parallel.mesh import pad_to_multiple, shard_rows
    from clair3_tpu_torch.pipeline.engine import InferenceEngine
    from clair3_tpu_torch.train.step import make_optimizer, replicate, train_step

    rank, world = dist.get_rank(), dist.get_world_size()
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    x_np, y_np = _dryrun_batch(n_devices)
    B = len(x_np)
    xs, ys = (shard_rows(pad_to_multiple(a, world)[0], rank, world) for a in (x_np, y_np))

    net = FullAlignmentNet(add_indel_length=True)
    init_weights(net, torch.Generator().manual_seed(0))  # one seed: equal on every rank
    net.to(device)
    opt = make_optimizer(net, learning_rate=1e-3, weight_decay=1e-7)
    loss = train_step(replicate(net, device), opt, torch.from_numpy(xs).to(device),
                      torch.from_numpy(ys).to(device),
                      torch.Generator(device=device).manual_seed(1), add_indel_length=True)

    if rank == 0:
        # the sharded inference batch through the engine the calling
        # pipeline uses: B rows split over n_devices replicas of the trained
        # weights (a fresh net: the trained one carries DDP's hooks, which
        # do not copy)
        trained = FullAlignmentNet(add_indel_length=True)
        trained.load_state_dict(net.state_dict())
        devices = [device] * n_devices
        engine = InferenceEngine(trained.to(device), device, buckets=(B,), devices=devices)
        probs = engine.predict(x_np)
        assert probs.shape == (B, 90), probs.shape
        print(f"[dryrun_multichip] engine batch of {B} rows over {len(engine.devices)} "
              f"devices ({engine.devices[0]}), {B // len(engine.devices)} rows each",
              flush=True)
        rows = _miniature_cascade(trained, n_devices, devices)
        print(f"[dryrun_multichip] n_devices={n_devices} loss={loss:.4f} "
              f"infer={tuple(probs.shape)} cascade_rows={rows} ok", flush=True)
    dist.barrier()


def _miniature_cascade(fa_net, n_devices: int, devices) -> int:
    """The JAX dry run's miniature cascade: a 4 kb simulated case through
    the production ``VariantCaller`` with both nets (a seeded ``PileupNet``
    and the FA net after its training step), each engine over ``devices``;
    returns the merged VCF's row count."""
    import gzip
    import tempfile

    from clair3_tpu_torch.config import CallConfig
    from clair3_tpu_torch.models import PileupNet
    from clair3_tpu_torch.models.init import init_weights
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from clair3_tpu_torch.pipeline.engine import InferenceEngine
    from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

    with tempfile.TemporaryDirectory(prefix="dryrun_cascade_") as d:
        ref = random_reference(4000, seed=5)
        variants = [
            SimVariant(900, ref[900], "C" if ref[900] != "C" else "G", (1, 1)),
            SimVariant(2000, ref[2000], ref[2000] + "AT", (0, 1)),
            SimVariant(3100, ref[3100:3103], ref[3100], (1, 1)),
        ]
        fasta, bam, _, _ = write_test_case(
            d, ref_length=4000, variants=variants, coverage=18,
            read_length=800, seed=5, error_rate=0.02)

        pileup = PileupNet(add_indel_length=False)
        init_weights(pileup, torch.Generator().manual_seed(2))
        buckets = (max(2 * n_devices, 8),)
        p_engine = InferenceEngine(pileup.to(devices[0]), devices[0], buckets=buckets,
                                   transfer_dtype=np.int16, devices=devices)
        fa_engine = InferenceEngine(fa_net.eval(), devices[0], buckets=buckets,
                                    devices=devices)
        fa_engine.fa_input_channels = 8

        cfg = CallConfig(platform="hifi", bam_fn=bam, ref_fn=fasta,
                         output_dir=d + "/out", no_phasing_for_fa=True,
                         var_pct_full=1.0, ref_pct_full=1.0, threads=2)
        outputs = VariantCaller(cfg, pileup_engine=p_engine, fa_engine=fa_engine).run()
        assert "merge_output" in outputs and "full_alignment" in outputs
        with gzip.open(outputs["merge_output"], "rt") as fh:
            return sum(1 for line in fh if not line.startswith("#"))


def dryrun_multichip(n_devices: int) -> None:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: ``n_devices``
    gloo ranks on the CPU, each an OS process (``parallel/mesh.py``), take
    one data-parallel training step of the FA net on the padded global batch
    (``B = max(2n, 8)``); rank 0 then predicts that batch through an
    ``InferenceEngine`` over ``n_devices`` CPU replicas and runs the
    miniature cascade on engines over the same devices, as the JAX dry run
    does on its mesh, and prints
    ``[dryrun_multichip] n_devices=... loss=... infer=... cascade_rows=... ok``."""
    from clair3_tpu_torch.parallel.mesh import spawn_ranks

    spawn_ranks(functools.partial(_dryrun_rank, n_devices), torch.device("cpu"), n_devices)
