"""Compact wire form of a pileup batch: the host packer and its numpy
rebuild, and the rebuild on the device.

The numpy half (``pack_pileup``, ``unpack_pileup_numpy``) is copied from
``clair3_tpu/ops/pileup_compact.py`` without ``unpack_pileup_jax``;
``tests/test_torch_copies.py`` holds each definition equal to its
original.  ``pack_pileup`` takes the native packer
(``clair3_tpu_torch/native``) when the library is built: ``mags`` uint8
``[N, 33, 18]`` absolute counts and ``negidx`` int8 ``[N, 33]``, the base
index whose forward/reverse channel pair ``(j, j + 9)`` is negated
(18: none).  627 bytes per candidate instead of int16's 1188.

``unpack_pileup_torch`` is the counterpart of ``unpack_pileup_jax``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_NO_NEG = 18  # out-of-range channel: matches nothing during reconstruction


def pack_pileup(matrix: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """Decompose [N, 33, 18] integer counts; None if values exceed uint8
    or the negation pattern is not the ref-channel-pair structure.  A
    single-pass native C packer (clair3t_pack.cc) serves production; this
    numpy body is its differential oracle (tests/test_native_pack.py)."""
    if matrix.ndim != 3 or matrix.shape[2] != 18:
        return None
    import os

    if (matrix.shape[1] == 33 and matrix.dtype in (np.int16, np.int32)
            and matrix.flags.c_contiguous
            and not os.environ.get("CLAIR3T_VERIFY_PACK")):
        from clair3_tpu_torch.native import pack_native_available, pileup_pack_native

        if pack_native_available():
            # rc != 0 <=> the rebuild-and-compare below would fail too
            return pileup_pack_native(matrix)
    m = matrix
    a = np.abs(m)
    if m.size and int(a.max()) > 255:
        return None
    neg = m < 0
    has = neg.any(axis=2)
    negidx = np.where(has, neg.argmax(axis=2) % 9, _NO_NEG).astype(np.int8)
    mags = a.astype(np.uint8)
    packed = {"mags": mags, "negidx": negidx}
    if not (unpack_pileup_numpy(packed) == m).all():
        return None
    return packed


def _unpack(xp, mags, negidx):
    """Shared numpy/jax reconstruction: returns [N, 33, 18] int16."""
    ch = xp.arange(18, dtype=xp.int8)[None, None, :]
    idx = negidx[..., None]
    neg = (ch == idx) | (ch == idx + 9)
    vals = mags.astype(xp.int16)
    return xp.where(neg, -vals, vals)


def unpack_pileup_numpy(packed: Dict[str, np.ndarray]) -> np.ndarray:
    return _unpack(np, packed["mags"], packed["negidx"])


def unpack_pileup_torch(mags: torch.Tensor, negidx: torch.Tensor) -> torch.Tensor:
    """The exact int16 ``[N, 33, 18]`` tensor; integer ops only."""
    ch = torch.arange(mags.shape[-1], dtype=torch.int8, device=mags.device)
    idx = negidx[..., None]
    neg = (ch == idx) | (ch == idx + 9)
    vals = mags.to(torch.int16)
    return torch.where(neg, -vals, vals)
