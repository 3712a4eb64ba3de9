"""Rebuild a full-alignment batch from its compact wire forms on the device.

Counterparts of ``clair3_tpu/ops/fa_compact.py::unpack_fa_jax`` (v1:
per-cell channel planes) and ``unpack_fa_sparse_jax`` (v2: dense BQ and
dwell, alt and insert as padded sparse pairs).  The packers stay the JAX
package's jax-free ``pack_fa``, ``pack_fa_sparse`` and the native
``fa_pack_sparse_native``; both forms rebuild the exact int8
``[N, D, 33, 8|9]`` tensor.

The sparse index plane is ``uint16`` on the host.  It crosses as the same
bytes viewed as int16 (torch has few CUDA ops for uint16) and is widened
here with ``& 0xFFFF``.  Padding entries point at the dummy slot past the
end of the flat ``[N, D*33*2 + 1]`` scatter buffer and carry 0.
"""

from __future__ import annotations

from typing import Dict

import torch


def _cover(bitmask: torch.Tensor, n_pos: int) -> torch.Tensor:
    """Coverage ``[N, D, n_pos]`` int8 from the packbits mask (bit 7 of
    byte 0 is column 0)."""
    pos = torch.arange(n_pos, device=bitmask.device)
    shift = (7 - pos % 8).to(torch.uint8)
    return ((bitmask[..., pos // 8] >> shift) & 1).to(torch.int8)


def _derived(cover, scalars, refcol):
    """The channels rebuilt from the per-read scalars and the ref column:
    ref, strand, MQ, haplotype and AF."""
    ref = refcol[:, None, :] * cover
    strand = scalars[..., 0:1] * cover
    mq = scalars[..., 1:2] * cover
    hap = scalars[..., 2:3] * cover
    af = scalars[..., 3:4] * (ref != 0).to(torch.int8)
    return ref, strand, mq, hap, af


def unpack_fa_torch(cells: torch.Tensor, bitmask: torch.Tensor,
                    scalars: torch.Tensor, refcol: torch.Tensor) -> torch.Tensor:
    """v1 form: ``cells`` int8 ``[N, D, 33, 3|4]`` (alt, BQ, insert[, dwell]),
    ``bitmask`` uint8 ``[N, D, 5]``, ``scalars`` int8 ``[N, D, 4]``,
    ``refcol`` int8 ``[N, 33]``."""
    ref, strand, mq, hap, af = _derived(_cover(bitmask, cells.shape[2]),
                                        scalars, refcol)
    chans = [ref, cells[..., 0], strand, mq, cells[..., 1], af, cells[..., 2], hap]
    if cells.shape[-1] == 4:
        chans.append(cells[..., 3])
    return torch.stack(chans, dim=-1)


def unpack_fa_sparse_torch(packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """v2 form: ``bq`` int8 ``[N, D, 33]``, ``bitmask``, ``scalars``,
    ``refcol`` as in v1, ``sidx`` ``[N, K]`` (uint16 values, as uint16,
    int16 bits or a wider integer type), ``sval`` int8 ``[N, K]``, and
    ``dwell`` int8 ``[N, D, 33]`` for 9-channel batches."""
    bq = packed["bq"]
    N, D, n_pos = bq.shape
    ref, strand, mq, hap, af = _derived(_cover(packed["bitmask"], n_pos),
                                        packed["scalars"], packed["refcol"])
    sidx = packed["sidx"]
    if sidx.dtype in (torch.int16, torch.uint16):
        sidx = sidx.view(torch.int16).to(torch.int64) & 0xFFFF
    flat = torch.zeros(N, D * n_pos * 2 + 1, dtype=torch.int8, device=bq.device)
    flat.scatter_(1, sidx.to(torch.int64), packed["sval"])
    alt_ins = flat[:, :-1].reshape(N, D, n_pos, 2)
    chans = [ref, alt_ins[..., 0], strand, mq, bq, af, alt_ins[..., 1], hap]
    if "dwell" in packed:
        chans.append(packed["dwell"])
    return torch.stack(chans, dim=-1)
