"""One training step, the counterpart of ``clair3_tpu/train/step.py``.

``torch.optim.AdamW`` over every parameter, with optax.adamw's settings
(betas 0.9/0.999, eps 1e-8, the decay scaled by the learning rate and
applied to every parameter, no mask): weight decay 1e-4 for the pileup net
and 1e-7 for the full-alignment net (``TrainConfig.weight_decay``;
reference Train.py:386-388).  No kernel has a backward, so a step runs the
nets' plain modules under autograd, as the JAX step runs ``lax.scan`` and
XLA's convolutions under ``jax.grad``.  One device; multi-process training
is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from clair3_tpu_torch.train.loss import multitask_loss


def make_optimizer(net: nn.Module, learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(net.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


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
    one AdamW step.  Returns the loss."""
    net.train()
    opt.zero_grad(set_to_none=True)
    loss = batch_loss(net, x, y, generator, add_indel_length, gamma, task_class_weights)
    loss.backward()
    opt.step()
    return float(loss.detach())
