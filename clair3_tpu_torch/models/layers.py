"""Layers shared by both nets."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clair3_tpu_torch.config import (
    GENOTYPE_LABEL_COUNT,
    GT21_LABEL_COUNT,
    VARIANT_LENGTH_LABEL_COUNT,
)

HEAD_SIZES = (GT21_LABEL_COUNT, GENOTYPE_LABEL_COUNT,
              VARIANT_LENGTH_LABEL_COUNT, VARIANT_LENGTH_LABEL_COUNT)
HEAD_NAMES = ("Y_gt21_logits", "Y_genotype_logits",
              "Y_indel_length_logits_1", "Y_indel_length_logits_2")


class Dense(nn.Module):
    """flax ``nn.Dense`` in its own layout: ``kernel [in, out]``,
    ``bias [out]``; inputs and parameters are cast to the compute dtype."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode each value is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; in eval mode
    the identity.  The mask is drawn from ``generator``, the counterpart of
    flax's ``rngs={"dropout": ...}``: a net in training mode called without
    one raises, so a net left in training mode at inference shows itself.
    Holds no parameters.

    ``shard = (rank, ranks)`` (``train/step.py::replicate`` sets it):
    ``x`` is rank ``rank``'s slice of a global batch ``ranks`` times as
    long.  The mask is drawn for the global batch and this rank keeps its
    rows, so, as flax's mask is a function of the key and the global shape,
    N ranks drop what one device drops on the whole batch."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.shard = (0, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator; "
                             "call .eval() on a net used for inference")
        keep = 1.0 - self.rate
        rank, ranks = self.shard
        n = x.shape[0]
        mask = torch.rand((n * ranks,) + tuple(x.shape[1:]), generator=generator,
                          device=x.device)[rank * n: (rank + 1) * n] < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
