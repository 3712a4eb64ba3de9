"""Compact wire forms of a full-alignment batch: the host packers and their
numpy rebuild, and the rebuild on the device.

The numpy half (``pack_fa``, ``pack_fa_sparse`` and ``unpack_fa*_numpy``)
is copied from ``clair3_tpu/ops/fa_compact.py`` without its ``*_jax``
functions; ``tests/test_torch_copies.py`` holds each definition equal to
its original.  ``pack_fa_sparse`` takes the native packer
(``clair3_tpu_torch/native``, ``clair3t_pack.cc``) when the library is
built.

The torch half is the counterpart of ``unpack_fa_jax`` (v1: per-cell
channel planes) and ``unpack_fa_sparse_jax`` (v2: dense BQ and dwell, alt
and insert as padded sparse pairs).  Both forms rebuild the exact int8
``[N, D, 33, 8|9]`` tensor.

The sparse index plane is ``uint16`` on the host.  It crosses as the same
bytes viewed as int16 (torch has few CUDA ops for uint16) and is widened
here with ``& 0xFFFF``.  Padding entries point at the dummy slot past the
end of the flat ``[N, D*33*2 + 1]`` scatter buffer and carry 0.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def _pack_base(matrix: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """Validate the per-read/per-column structure and build the shared
    bitmask/scalars/refcol planes; None if the batch violates it."""
    if matrix.ndim != 4 or matrix.shape[2] != 33 or matrix.shape[3] not in (8, 9):
        return None
    if matrix.dtype != np.int8:
        # the packed planes (and unpack's astype) are int8: wider inputs
        # would validate here yet truncate on reconstruction — reject so
        # callers ship the dense tensor instead
        return None
    m = matrix
    cover = m[..., 2] != 0                      # strand set <=> cell filled
    strand = m[..., 2].max(axis=2)              # per-read scalars (all >= 0)
    mq = m[..., 3].max(axis=2)
    hap = m[..., 7].max(axis=2)
    af = m[..., 5].max(axis=2)
    refcol = m[..., 0].max(axis=1)              # per-column ref value
    if not (
        (m[..., 2] == strand[..., None] * cover).all()
        and (m[..., 3] == mq[..., None] * cover).all()
        and (m[..., 7] == hap[..., None] * cover).all()
        and (m[..., 0] == refcol[:, None, :] * cover).all()
        and (m[..., 5] == af[..., None] * (m[..., 0] != 0)).all()
    ):
        return None
    return {
        "bitmask": np.packbits(cover, axis=2),  # [N, D, 5], bit 7 = col 0
        "scalars": np.ascontiguousarray(
            np.stack([strand, mq, hap, af], axis=-1)),
        "refcol": np.ascontiguousarray(refcol),
    }


def pack_fa(matrix: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """Decompose [N, D, 33, 8|9] int8; None if the batch violates the
    per-read/per-column structure (then callers ship the full tensor)."""
    base = _pack_base(matrix)
    if base is None:
        return None
    cell_ch = (1, 4, 6) if matrix.shape[3] == 8 else (1, 4, 6, 8)
    base["cells"] = np.ascontiguousarray(matrix[..., cell_ch])
    return base


def _unpack(xp, cells, bitmask, scalars, refcol):
    """Shared numpy/jax reconstruction: returns [N, D, 33, 8|9] int8."""
    n_pos = cells.shape[2]
    idx = xp.arange(n_pos) // 8
    shift = (7 - xp.arange(n_pos) % 8).astype(xp.uint8)
    cover = ((bitmask[..., idx] >> shift) & 1).astype(xp.int8)  # [N, D, 33]
    ref = (refcol[:, None, :] * cover).astype(xp.int8)
    strand = (scalars[..., 0:1] * cover).astype(xp.int8)
    mq = (scalars[..., 1:2] * cover).astype(xp.int8)
    hap = (scalars[..., 2:3] * cover).astype(xp.int8)
    af = (scalars[..., 3:4] * (ref != 0)).astype(xp.int8)
    chans = [ref, cells[..., 0], strand, mq, cells[..., 1], af,
             cells[..., 2], hap]
    if cells.shape[-1] == 4:
        chans.append(cells[..., 3])
    return xp.stack(chans, axis=-1)


def unpack_fa_numpy(packed: Dict[str, np.ndarray]) -> np.ndarray:
    return _unpack(np, packed["cells"], packed["bitmask"],
                   packed["scalars"], packed["refcol"])


K_BUCKETS = (128, 512)  # max sparse entries per candidate; ~8%/32% of cells
_SPARSE_CH = (1, 6)     # alt, insert


def pack_fa_sparse(matrix: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """Decompose [N, D, 33, 8|9] int8 with sparse alt/insert; None if the
    batch violates the structure or overflows every K bucket (then callers
    fall back to ``pack_fa`` / the full tensor).  A single-pass native C
    packer (clair3t_pack.cc) serves production; this numpy body is its
    differential oracle (tests/test_native_pack.py)."""
    from clair3_tpu_torch.native import fa_pack_sparse_native, pack_native_available

    if (matrix.ndim == 4 and matrix.dtype == np.int8
            and matrix.flags.c_contiguous
            and not os.environ.get("CLAIR3T_VERIFY_PACK")
            and pack_native_available()):
        # rc != 0 <=> the numpy path would return None too (same checks)
        return fa_pack_sparse_native(matrix, K_BUCKETS)
    base = _pack_base(matrix)  # (also rejects non-int8 dtypes)
    if base is None:
        return None
    m = matrix
    N, D = m.shape[0], m.shape[1]
    n_cells = D * 33
    pad_idx = n_cells * 2  # scatter target = the dummy slot past the end
    if pad_idx >= np.iinfo(np.uint16).max:
        return None
    alt_ins = np.stack([m[..., c] for c in _SPARSE_CH], axis=-1)  # [N,D,33,2]
    nz = alt_ins.reshape(N, -1)
    rows, flats = np.nonzero(nz)
    per_row = np.bincount(rows, minlength=N)
    k_need = int(per_row.max()) if N else 0
    k = next((kb for kb in K_BUCKETS if k_need <= kb), None)
    if k is None:
        return None
    idx = np.full((N, k), pad_idx, np.uint16)
    val = np.zeros((N, k), np.int8)
    starts = np.zeros(N + 1, np.int64)
    np.cumsum(per_row, out=starts[1:])
    ppos = np.arange(len(rows)) - starts[rows]
    idx[rows, ppos] = flats
    val[rows, ppos] = nz[rows, flats]
    packed = {
        "bq": np.ascontiguousarray(m[..., 4]),
        "bitmask": base["bitmask"],
        "scalars": base["scalars"],
        "refcol": base["refcol"],
        "sidx": idx,
        "sval": val,
    }
    if m.shape[3] == 9:
        packed["dwell"] = np.ascontiguousarray(m[..., 8])
    # Losslessness is by construction once _pack_base validated the derived
    # channels: bq/dwell ship dense, alt/insert are the exact nonzero set
    # (unique indices, so the scatter cannot collide).  The full dense
    # roundtrip is therefore only a debug assertion — it costs ~5x the
    # pack itself (tests/test_fa_compact.py pins bit-identity instead).
    if os.environ.get("CLAIR3T_VERIFY_PACK"):
        if not (unpack_fa_sparse_numpy(packed) == m).all():
            return None
    return packed


def _unpack_sparse(xp, packed):
    bq, bitmask = packed["bq"], packed["bitmask"]
    scalars, refcol = packed["scalars"], packed["refcol"]
    sidx, sval = packed["sidx"], packed["sval"]
    N, D = bq.shape[0], bq.shape[1]
    n_pos = bq.shape[2]
    idx = xp.arange(n_pos) // 8
    shift = (7 - xp.arange(n_pos) % 8).astype(xp.uint8)
    cover = ((bitmask[..., idx] >> shift) & 1).astype(xp.int8)
    ref = (refcol[:, None, :] * cover).astype(xp.int8)
    strand = (scalars[..., 0:1] * cover).astype(xp.int8)
    mq = (scalars[..., 1:2] * cover).astype(xp.int8)
    hap = (scalars[..., 2:3] * cover).astype(xp.int8)
    af = (scalars[..., 3:4] * (ref != 0)).astype(xp.int8)
    flat = xp.zeros((N, D * n_pos * 2 + 1), xp.int8)
    if xp is np:
        flat[np.arange(N)[:, None], sidx.astype(np.int64)] = sval
    else:
        flat = flat.at[xp.arange(N)[:, None], sidx.astype(xp.int32)].set(sval)
    ai = flat[:, :-1].reshape(N, D, n_pos, 2)
    chans = [ref, ai[..., 0], strand, mq, bq.astype(xp.int8), af,
             ai[..., 1], hap]
    if "dwell" in packed:
        chans.append(packed["dwell"].astype(xp.int8))
    return xp.stack(chans, axis=-1)


def unpack_fa_sparse_numpy(packed: Dict[str, np.ndarray]) -> np.ndarray:
    return _unpack_sparse(np, packed)


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
