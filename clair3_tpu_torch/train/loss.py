"""Multi-task focal loss, the counterpart of ``clair3_tpu/train/loss.py``
(reference semantics: clair3/Train.py:87-107).

The nets output per-task softmax *probabilities* (not logits), so the focal
loss works on probabilities directly:

    p clamped to [1e-9, 1-1e-9]
    loss = sum_k  -(1-p_k)^gamma * y_k * log(p_k) * w_k

summed per task over classes, averaged over the batch, summed over tasks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from clair3_tpu_torch.config import LABEL_SHAPE


def effective_class_weights(samples_per_cls: np.ndarray, beta: float = 0.999) -> np.ndarray:
    """Class-balanced weights from effective numbers (Train.py:79-84)."""
    effective_num = 1.0 - np.power(beta, samples_per_cls)
    w = (1.0 - beta) / effective_num
    return w / w.sum() * len(samples_per_cls)


def focal_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    gamma: float = 2.0,
    class_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sample focal loss over one task's probability vector."""
    y_pred = y_pred.clamp(1e-9, 1 - 1e-9)
    ce = -y_true * torch.log(y_pred)
    weight = ((1 - y_pred) ** gamma) * y_true
    fl = ce * weight
    if class_weights is not None:
        fl = fl * class_weights
    return fl.sum(dim=-1)


def multitask_loss(
    predictions: torch.Tensor,
    labels: torch.Tensor,
    add_indel_length: bool = True,
    gamma: float = 2.0,
    task_class_weights: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> torch.Tensor:
    """Total loss: per-task focal losses (batch-meaned) summed.

    ``predictions`` is the concatenated head output ``[B, 24|90]``;
    ``labels`` the one-hot 90-vector (sliced to match)."""
    n_tasks = 4 if add_indel_length else 2
    total = predictions.new_zeros(())
    start = 0
    for task in range(n_tasks):
        size = LABEL_SHAPE[task]
        cw = task_class_weights[task] if task_class_weights else None
        total = total + focal_loss(
            labels[:, start:start + size],
            predictions[:, start:start + size],
            gamma=gamma,
            class_weights=cw,
        ).mean()
        start += size
    return total
