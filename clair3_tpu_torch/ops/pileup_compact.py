"""Rebuild a pileup batch from its compact wire form on the device.

Counterpart of ``clair3_tpu/ops/pileup_compact.py::unpack_pileup_jax``.
The packer stays the JAX package's jax-free ``pack_pileup`` (native
``pileup_pack_native`` when the library is built): ``mags`` uint8
``[N, 33, 18]`` absolute counts and ``negidx`` int8 ``[N, 33]``, the base
index whose forward/reverse channel pair ``(j, j + 9)`` is negated
(18: none).  627 bytes per candidate instead of int16's 1188.
"""

from __future__ import annotations

import torch


def unpack_pileup_torch(mags: torch.Tensor, negidx: torch.Tensor) -> torch.Tensor:
    """The exact int16 ``[N, 33, 18]`` tensor; integer ops only."""
    ch = torch.arange(mags.shape[-1], dtype=torch.int8, device=mags.device)
    idx = negidx[..., None]
    neg = (ch == idx) | (ch == idx + 9)
    vals = mags.to(torch.int16)
    return torch.where(neg, -vals, vals)
