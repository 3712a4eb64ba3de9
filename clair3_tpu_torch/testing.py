"""Seeded inputs and weights for the port's tests and its chip check."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from clair3_tpu_torch.models.bridge import to_jax_variables
from clair3_tpu_torch.models.params_io import flatten_tree, unflatten_tree


def random_variables(net: nn.Module, seed: int) -> Dict:
    """A JAX-layout variable tree with ``net``'s shapes, drawn with numpy:
    weights ~ N(0, 1/fan_in) (lecun-normal scale), biases and BatchNorm
    shifts ~ N(0, 0.1), BatchNorm scales near 1 and variances in
    [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    flat = {}
    for key, v in flatten_tree(to_jax_variables(net.state_dict())).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "var":
            w = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "scale":
            w = 1.0 + 0.1 * rng.randn(*v.shape)
        elif v.ndim == 1:
            w = 0.1 * rng.randn(*v.shape)
        else:
            w = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        flat[key] = w.astype(np.float32)
    return unflatten_tree(flat)


def random_counts(seed: int, shape, low: int = -30, high: int = 30) -> np.ndarray:
    """Integer pileup-like counts in ``[low, high)``."""
    return np.random.RandomState(seed).randint(low, high, shape).astype(np.int32)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want|`` in units of the bf16 ulp of ``|want|``, with an
    absolute floor of 1e-5 for values near 0."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(want.abs())
    ulp = torch.clamp(torch.ldexp(torch.ones_like(want), e - 8), min=1e-5)
    return ((got - want).abs() / ulp).max().item()
