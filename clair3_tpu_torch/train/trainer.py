"""Model training loop, the counterpart of ``clair3_tpu/train/trainer.py``.

Reference semantics (clair3/Train.py:260-568): AdamW (lr 1e-3, per-mode
weight decay), per-task focal loss, bin chunks assembled into batches, a
random per-epoch chunk offset, mini-epoch subdivision, a 90/10 validation
split, early stopping on validation loss, per-epoch checkpoints and
``best_val_loss.npz``.  Checkpoints are the JAX package's ``.npz`` trees
(``models/bridge.py``), so either package loads the other's.  The nets
start from flax's initializers (``models/init.py``) drawn on the CPU from
``cfg.seed``, dropout draws from a generator on the device seeded from
``cfg.seed``, and every batch moves to the device for its step.

With ``data_parallel`` (the JAX trainer's ``mesh``) this process is one
rank of the group ``parallel/mesh.py`` joined, and every rank runs this
loop with the same seeds, so each holds the same net and walks the same
chunks.  Each training and validation batch is padded to a multiple of the
ranks with zero rows and zero labels (the JAX trainer's ``_pad_batch``),
each rank takes its slice, the step is ``train/step.py::replicate``'s, and
the losses are the means over the ranks.  Rank 0 alone writes the
checkpoints while the others wait.
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from clair3_tpu_torch.config import LABEL_SHAPE, TrainConfig
from clair3_tpu_torch.device import resolve_device
from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables, to_jax_variables
from clair3_tpu_torch.models.init import init_weights
from clair3_tpu_torch.models.params_io import save_variables
from clair3_tpu_torch.parallel.mesh import pad_to_multiple, shard_rows
from clair3_tpu_torch.train.data import BinDataset
from clair3_tpu_torch.train.loss import effective_class_weights
from clair3_tpu_torch.train.step import (batch_loss, make_optimizer, mean_over_ranks,
                                         replicate, train_step)

logger = logging.getLogger(__name__)


def build_model(cfg: TrainConfig, input_channels: Optional[int] = None) -> nn.Module:
    """The net ``cfg`` trains, at float32, on its plain route."""
    if cfg.pileup:
        return PileupNet(add_indel_length=cfg.add_indel_length,
                         input_channels=input_channels or 18)
    return FullAlignmentNet(add_indel_length=cfg.add_indel_length,
                            input_channels=input_channels or 8)


def _load_init_variables(net: nn.Module, variables: dict) -> None:
    """Fine-tuning / resume: the tree's params replace the net's, and its
    batch_stats, where it has them, the BatchNorm statistics."""
    missing, unexpected = net.load_state_dict(from_jax_variables(variables), strict=False)
    buffers = {name for name, _ in net.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise ValueError(f"init_variables do not fit the net: missing "
                         f"{sorted(set(missing) - buffers)[:5]}, unexpected {unexpected[:5]}")


def _class_weights(dataset, device) -> list:
    """Effective-number class weights from the label distribution
    (reference: Train.py:79-84 with --effective_label_num)."""
    counts = np.zeros(sum(LABEL_SHAPE))
    for b, c in dataset.chunks:
        _, y = dataset.get_chunk(b, c)
        counts += y.sum(axis=0)
    weights, start = [], 0
    for size in LABEL_SHAPE:
        w = effective_class_weights(np.maximum(counts[start:start + size], 1))
        weights.append(torch.as_tensor(w, dtype=torch.float32, device=device))
        start += size
    return weights


def train_model(
    bin_paths: Sequence[str],
    output_dir: str,
    cfg: TrainConfig,
    max_steps: Optional[int] = None,
    init_variables: Optional[dict] = None,
    use_class_weights: bool = False,
    device="cuda",
    data_parallel: bool = False,
) -> dict:
    """Train from HDF5 bins on ``device`` (``cuda`` raises without a GPU),
    as one rank of the joined group with ``data_parallel``; returns
    ``{'best_val_loss', 'epochs', 'model_path', 'history'}``."""
    device = resolve_device(device)
    return fit(BinDataset(bin_paths, chunk_size=cfg.chunk_size), output_dir, cfg,
               max_steps=max_steps, init_variables=init_variables,
               use_class_weights=use_class_weights, device=device,
               data_parallel=data_parallel)


def fit(
    dataset,
    output_dir: str,
    cfg: TrainConfig,
    max_steps: Optional[int] = None,
    init_variables: Optional[dict] = None,
    use_class_weights: bool = False,
    device="cuda",
    data_parallel: bool = False,
) -> dict:
    """``train_model``'s loop over ``dataset``, any object with
    ``BinDataset``'s ``chunks``, ``get_chunk``, ``batches`` and
    ``split_chunks``, on ``device`` (this rank's, with ``data_parallel``;
    ``cuda`` raises without a GPU)."""
    import torch.distributed as dist

    device = resolve_device(device)

    rank, world = (dist.get_rank(), dist.get_world_size()) if data_parallel else (0, 1)
    os.makedirs(output_dir, exist_ok=True)
    if not dataset.chunks:
        raise ValueError("no training chunks found in bins")
    train_chunks, val_chunks = dataset.split_chunks(cfg.validation_fraction, cfg.seed)
    if not val_chunks:
        val_chunks = train_chunks[-1:]

    x0, _ = dataset.get_chunk(*dataset.chunks[0])
    net = build_model(cfg, x0.shape[-1])
    init_weights(net, torch.Generator().manual_seed(cfg.seed))
    if init_variables is not None:
        _load_init_variables(net, init_variables)
    net.to(device)
    model = replicate(net, device) if data_parallel else net
    opt = make_optimizer(net, cfg.learning_rate, cfg.weight_decay)
    dropout = torch.Generator(device=device).manual_seed(cfg.seed)
    task_class_weights = _class_weights(dataset, device) if use_class_weights else None

    def on_device(x, y):
        """This rank's rows of the batch, on the device."""
        if data_parallel:
            x, y = (shard_rows(pad_to_multiple(a, world)[0], rank, world) for a in (x, y))
        return (torch.from_numpy(np.ascontiguousarray(x)).to(device),
                torch.from_numpy(np.ascontiguousarray(y)).to(device))

    @torch.no_grad()
    def eval_loss(x, y):
        net.eval()
        loss = batch_loss(net, *on_device(x, y), None, cfg.add_indel_length,
                          cfg.focal_gamma, task_class_weights)
        return float(mean_over_ranks(loss) if data_parallel else loss)

    chunks_per_batch = max(1, cfg.batch_size // cfg.chunk_size)
    py_rng = random.Random(cfg.seed)
    best_val = float("inf")
    best_path = os.path.join(output_dir, "best_val_loss.npz")
    patience = cfg.early_stop_patience * cfg.mini_epochs
    bad_epochs = 0
    total_steps = 0
    history = []

    def result(epochs):
        return {"best_val_loss": best_val, "epochs": epochs,
                "model_path": best_path, "history": history}

    for epoch in range(cfg.max_epoch):
        offset = py_rng.randrange(max(1, cfg.chunk_size // 2))
        order = list(train_chunks)
        py_rng.shuffle(order)
        mini = max(1, len(order) // cfg.mini_epochs)
        for mini_epoch in range(cfg.mini_epochs):
            t0 = time.time()
            epoch_loss, n_batches = 0.0, 0
            for x, y in dataset.batches(
                order[mini_epoch * mini: (mini_epoch + 1) * mini],
                chunks_per_batch, offset,
            ):
                epoch_loss += train_step(model, opt, *on_device(x, y), dropout,
                                         cfg.add_indel_length, cfg.focal_gamma,
                                         task_class_weights)
                n_batches += 1
                total_steps += 1
                if max_steps is not None and total_steps >= max_steps:
                    break
            train_loss = epoch_loss / max(1, n_batches)

            val_loss, n_val = 0.0, 0
            for x, y in dataset.batches(val_chunks, chunks_per_batch, 0):
                val_loss += eval_loss(x, y)
                n_val += 1
            val_loss /= max(1, n_val)
            history.append((epoch, mini_epoch, train_loss, val_loss))
            logger.info("[train] epoch %d.%d loss=%.4f val=%.4f (%.1fs)",
                        epoch, mini_epoch, train_loss, val_loss, time.time() - t0)

            # the losses are equal on every rank, so every rank decides alike
            improved = val_loss < best_val
            if rank == 0:
                variables = to_jax_variables(net.state_dict())
                save_variables(os.path.join(output_dir, f"epoch_{epoch}_{mini_epoch}.npz"),
                               variables)
                if improved:
                    save_variables(best_path, variables)
            if data_parallel:
                dist.barrier()
            if improved:
                best_val = val_loss
                bad_epochs = 0
            else:
                bad_epochs += 1
            if bad_epochs >= patience:
                logger.info("[train] early stop at epoch %d.%d", epoch, mini_epoch)
                return result(epoch + 1)
            if max_steps is not None and total_steps >= max_steps:
                return result(epoch + 1)

    return result(cfg.max_epoch)
