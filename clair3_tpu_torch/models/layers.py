"""Layers shared by both nets."""

from __future__ import annotations

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
