"""flax's initializers for both nets, drawn from an explicit generator.

The counterpart of ``model.init`` in the JAX package
(``clair3_tpu/train/step.py``), matched in distribution, not bit for bit:

* ``lecun_normal`` for every input projection ``LSTMn.wi``, Dense
  ``kernel`` and convolution ``weight``: a normal truncated at two standard
  deviations, scaled to the variance ``1 / fan_in`` (std
  ``sqrt(1 / fan_in) / 0.8796``, flax's correction for the truncation);
  fan_in is ``C``, ``in`` or ``kh * kw * I``;
* ``orthogonal`` for each direction's recurrent ``LSTMn.wh [H, 4H]``:
  orthonormal rows, one draw per direction;
* zeros for every bias, BatchNorm ``scale`` 1 and ``bias`` 0, running
  ``mean`` 0 and ``var`` 1.

Weights are drawn in float32 on ``generator``'s device and copied into the
net, wherever it lies: the trainer draws on the CPU, so one seed gives one
starting net on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from clair3_tpu_torch.models.full_alignment import BatchNorm, Conv
from clair3_tpu_torch.models.layers import Dense
from clair3_tpu_torch.ops.lstm import BiLSTM

# std of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Unit normal truncated to [-2, 2], by the inverse CDF of a uniform
    draw (as ``jax.random.truncated_normal`` does)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=generator, device=generator.device)
    z = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
    return z.clamp(-2.0, 2.0)


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return truncated_normal(shape, generator) * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STD)


def orthogonal(rows: int, cols: int, generator: torch.Generator) -> torch.Tensor:
    """``[rows, cols]`` with orthonormal rows (``rows <= cols``), as flax's
    ``orthogonal()``: the Q of a Gaussian matrix's QR, signs fixed by R's
    diagonal."""
    a = torch.randn(cols, rows, generator=generator, device=generator.device)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).T


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draws every parameter of ``net`` (either net) as ``model.init`` does,
    in module order, and resets the BatchNorm statistics.  Returns ``net``."""
    for mod in net.modules():
        if isinstance(mod, BiLSTM):
            _, C, H4 = mod.wi.shape
            for d in range(2):
                mod.wi[d].copy_(lecun_normal((C, H4), C, generator))
                mod.wh[d].copy_(orthogonal(H4 // 4, H4, generator))
            mod.b.zero_()
        elif isinstance(mod, Dense):
            mod.kernel.copy_(lecun_normal(mod.kernel.shape, mod.kernel.shape[0], generator))
            mod.bias.zero_()
        elif isinstance(mod, Conv):
            O, I, kh, kw = mod.weight.shape
            mod.weight.copy_(lecun_normal((O, I, kh, kw), I * kh * kw, generator))
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
    return net
