"""One training step, the counterpart of ``clair3_tpu/train/step.py``.

``torch.optim.AdamW`` over every parameter, with optax.adamw's settings
(betas 0.9/0.999, eps 1e-8, the decay scaled by the learning rate and
applied to every parameter, no mask): weight decay 1e-4 for the pileup net
and 1e-7 for the full-alignment net (``TrainConfig.weight_decay``;
reference Train.py:386-388).  No kernel has a backward, so a step runs the
nets' plain modules under autograd, as the JAX step runs ``lax.scan`` and
XLA's convolutions under ``jax.grad``.

``replicate`` is the counterpart of the JAX step's mesh branch
(``make_train_step(..., mesh=...)``, ``shard_train_state``): the net in
``DistributedDataParallel`` over the group ``parallel/mesh.py`` joined.
Every rank holds ``B_pad / world`` rows of the padded global batch, so
DDP's mean of the ranks' gradients is the gradient of the global batch's
mean loss, which is what XLA reduces to under the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from clair3_tpu_torch.models.full_alignment import BatchNorm
from clair3_tpu_torch.models.layers import Dropout
from clair3_tpu_torch.train.loss import multitask_loss


def make_optimizer(net: nn.Module, learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(net.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def replicate(net: nn.Module, device: torch.device) -> DistributedDataParallel:
    """``net`` (on ``device``, the same weights on every rank) as one replica
    of the data-parallel group this process joined.

    Its dropout masks are cut from the global batch's and its BatchNorm
    normalizes with the global batch's statistics (see ``Dropout`` and
    ``BatchNorm``), so N ranks compute what one device computes on the
    whole batch.  ``broadcast_buffers`` is off: the BatchNorm running
    statistics are moved by the same all-reduced values on every rank, so
    they stay equal without rank 0's copy."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    for m in net.modules():
        if isinstance(m, Dropout):
            m.shard = (rank, world)
        elif isinstance(m, BatchNorm):
            m.group = dist.group.WORLD
    return DistributedDataParallel(net, device_ids=[device] if device.type == "cuda" else None,
                                   broadcast_buffers=False)


def mean_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The mean of ``value`` over the ranks of the group (equal shards: the
    global batch's mean of a per-rank batch mean)."""
    import torch.distributed as dist

    total = value.detach().clone()
    dist.all_reduce(total)
    return total / dist.get_world_size()


def batch_loss(net: nn.Module, x: torch.Tensor, y: torch.Tensor,
               generator: Optional[torch.Generator], add_indel_length: bool,
               gamma: float = 2.0,
               task_class_weights: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The forward pass in the net's current mode and the multi-task loss."""
    preds = net(x, generator)
    return multitask_loss(preds, y, add_indel_length=add_indel_length, gamma=gamma,
                          task_class_weights=task_class_weights)


def train_step(net: nn.Module, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, generator: torch.Generator, add_indel_length: bool,
               gamma: float = 2.0,
               task_class_weights: Optional[Sequence[torch.Tensor]] = None) -> float:
    """Forward in training mode (dropout masks from ``generator``, BatchNorm
    on batch statistics, its running statistics updated), loss, backward,
    one AdamW step.  Returns the loss; for a ``replicate``d net, whose
    ``x`` and ``y`` are this rank's rows, the mean over the ranks."""
    net.train()
    opt.zero_grad(set_to_none=True)
    loss = batch_loss(net, x, y, generator, add_indel_length, gamma, task_class_weights)
    loss.backward()
    opt.step()
    if isinstance(net, DistributedDataParallel):
        loss = mean_over_ranks(loss)
    return float(loss.detach())
