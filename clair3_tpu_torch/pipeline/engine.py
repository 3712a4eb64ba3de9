"""Batched inference engine, the counterpart of
``clair3_tpu/pipeline/engine.py``.

* candidate tensors stream in from the host extractors;
* batches are cut at the largest bucket and zero-padded to a small set of
  static bucket sizes, as the JAX engine does;
* each padded batch is split by rows over the engine's devices, as the JAX
  engine shards it over its mesh's data axis: one replica of the net per
  device, the bucket sizes rounded to multiples of the device count;
* one submitter thread copies each shard to its device (from pinned host
  memory, on that replica's own CUDA stream) and runs the replica there, so
  the caller can decode batch i-1 while batch i is in flight;
* probabilities come back to pinned host memory, and ``gather`` waits for
  every shard and joins them in device order.

Wire forms, in the JAX engine's routing order (``_wire_form``): with
``fa_compact``, a full-alignment batch crosses as its sparse pack (native
band scan and pack straight from the full-depth tensor, else the numpy
crop and the sparse pack), else as the v1 pack; with ``pileup_compact``, a
pileup batch crosses as uint8 magnitudes and the negated-channel index.
A pack that returns ``None`` leaves the batch dense (int16 pileup, int8
full alignment).  With ``depth_crop`` only the centred band of non-empty
depth rows crosses, and the device pads it back to the full depth.  Every
form is an exact re-encoding of the batch, rebuilt on the device before
the net (``ops/pileup_compact.py``, ``ops/fa_compact.py``, which also hold
the host packers, numpy and native).  The form, the depth band, the sparse
pack's K bucket and the pad are decided once per batch, before it is split,
as the JAX engine decides them before ``device_put``: the bytes shipped are
the JAX engine's for the same batches, whatever the device count.

The pileup high-coverage rescale (``rescale_high_coverage_pileup``) is the
JAX engine's, copied; ``pipeline/call.py`` takes it from here.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from clair3_tpu_torch.ops import fa_compact as _fa_compact
from clair3_tpu_torch.ops import pileup_compact as _pileup_compact
from clair3_tpu_torch.ops.fa_compact import unpack_fa_sparse_torch, unpack_fa_torch
from clair3_tpu_torch.ops.pileup_compact import unpack_pileup_torch

_DEFAULT_BUCKETS = (256, 1024, 2048, 4096)
_EMPTY = np.zeros((0, 90), np.float32)
_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32}

# how a batch crosses: the dense tensor or one of the packed forms
DENSE, FA_SPARSE, FA_V1, PILEUP_COMPACT = "dense", "fa_sparse", "fa_v1", "pileup_compact"


def _indexed(device) -> torch.device:
    """``device`` with an explicit index when it is a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _pad_to_bucket(planes: Dict[str, np.ndarray], m: int, bucket: int) -> Dict[str, np.ndarray]:
    """Zero-pad every plane from ``m`` to ``bucket`` rows."""
    if m >= bucket:
        return planes
    return {k: np.concatenate([v, np.zeros((bucket - m,) + v.shape[1:], v.dtype)])
            for k, v in planes.items()}


class InferenceEngine:
    """Batch forward of one net, data-sharded over one or more devices.

    ``model`` is an ``nn.Module`` already on ``device``; ``devices`` (a
    sequence of ``torch.device``, repeats allowed; default ``[device]``)
    are the devices each batch is split over, the counterpart of the JAX
    engine's mesh (``parallel.mesh.local_devices``).  The first replica is
    ``model`` itself, every further entry a deep copy moved to its device,
    so each replica keeps its own packed kernel operands.
    ``transfer_dtype`` is the numpy dtype of a dense host->device copy (the
    net widens it to its compute dtype on the device).  ``depth_crop``,
    ``fa_compact`` and ``pileup_compact`` are the JAX engine's options of
    the same names."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 buckets: Sequence[int] = _DEFAULT_BUCKETS,
                 transfer_dtype=None, depth_crop: bool = False,
                 fa_compact: bool = False, pileup_compact: bool = False,
                 devices: Optional[Sequence[torch.device]] = None):
        # a CUDA device without an index would follow the thread's current
        # device, which the kernel libraries set behind torch's back
        self.devices = tuple(_indexed(d) for d in (devices or (device,)))
        self.device = self.devices[0]
        self.model = model.eval()
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d).eval()
                                        for d in self.devices[1:]]
        n = len(self.devices)
        # every bucket splits evenly over the devices (the JAX engine's rule)
        self.buckets = tuple(sorted(max(b, n) - (max(b, n) % n) or n for b in buckets))
        self.transfer_dtype = transfer_dtype
        self.depth_crop = depth_crop
        self.fa_compact = fa_compact
        self.pileup_compact = pileup_compact
        # bytes handed to the host->device copies (post pack/pad, over every
        # shard), on the submitter thread; dense_bytes: what the dense form
        # of the same padded batches would have shipped, for comparison
        self.bytes_shipped = 0
        self.dense_bytes = 0
        self.fa_input_channels: Optional[int] = None
        # the forward's name in a torch.profiler trace
        self._label = f"{type(model).__name__}.forward"
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self._submitter = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-submit")
        self._warmup: Optional[Future] = None

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top

    @staticmethod
    def _depth_buckets(full_depth: int) -> Tuple[int, ...]:
        """(cropped, full): one reduced band covering typical coverage, and
        the full depth."""
        crop = min(full_depth, ((int(full_depth * 0.55) + 7) // 8) * 8)
        return (crop, full_depth) if crop < full_depth else (full_depth,)

    def _band(self, D: int, lo: int, hi: int) -> Tuple[int, int]:
        """(top, rows) of the smallest depth bucket whose centred window
        holds the non-empty rows ``[lo, hi)``."""
        if self.depth_crop:
            for db in self._depth_buckets(D):
                top = (D - db) // 2
                if top <= lo and hi <= top + db:
                    return top, db
        return 0, D

    def _crop_depth(self, chunk: np.ndarray) -> Tuple[np.ndarray, Optional[int]]:
        """Crop the centred depth band; (cropped, full depth), or
        (chunk, None) when cropping is off or does not apply."""
        if not self.depth_crop or chunk.ndim != 4:
            return chunk, None
        D = chunk.shape[1]
        nz = np.flatnonzero(chunk.any(axis=(0, 2, 3)))
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (D // 2, D // 2)
        top, db = self._band(D, lo, hi)
        if db == D:
            return chunk, None
        return np.ascontiguousarray(chunk[:, top: top + db]), D

    def _sparse_fast_path(self, chunk: np.ndarray):
        """Native band scan and sparse pack straight from the full-depth
        tensor (no numpy crop); (planes, full depth) or None when it does
        not apply."""
        if (chunk.dtype != np.int8 or not chunk.flags.c_contiguous
                or os.environ.get("CLAIR3T_VERIFY_PACK")):
            return None
        from clair3_tpu_torch.native import (fa_band_native, fa_pack_sparse_native,
                                             pack_native_available)

        if not pack_native_available():
            return None
        band = fa_band_native(chunk)
        if band is None:
            return None
        D = chunk.shape[1]
        top, db = self._band(D, *band)
        sp = fa_pack_sparse_native(chunk, _fa_compact.K_BUCKETS, row_off=top, rows=db)
        if sp is None:
            return None
        return sp, (D if db < D else None)

    def _wire_form(self, chunk: np.ndarray):
        """``(form, planes, full_depth)``: the host planes of one chunk, in
        the JAX engine's routing order (``engine.py:287-334``)."""
        if self.transfer_dtype is not None and chunk.dtype != self.transfer_dtype:
            chunk = chunk.astype(self.transfer_dtype)
        fa = chunk.ndim == 4
        if self.fa_compact and fa:
            fast = self._sparse_fast_path(chunk)
            if fast is not None:
                return (FA_SPARSE,) + fast
        chunk, full_depth = self._crop_depth(chunk)
        if self.fa_compact and fa:
            sp = _fa_compact.pack_fa_sparse(chunk)
            if sp is not None:
                return FA_SPARSE, sp, full_depth
            v1 = _fa_compact.pack_fa(chunk)
            if v1 is not None:
                return FA_V1, v1, full_depth
        if self.pileup_compact and chunk.ndim == 3:
            packed = _pileup_compact.pack_pileup(chunk)
            if packed is not None:
                return PILEUP_COMPACT, packed, None
        return DENSE, {"x": chunk}, full_depth

    def _host_plane(self, plane: np.ndarray, device: torch.device) -> torch.Tensor:
        """A plane as a host tensor, in pinned memory when ``device`` is a
        GPU; uint16 crosses as the same bytes viewed as int16."""
        if plane.dtype == np.uint16:
            plane = plane.view(np.int16)
        if device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(plane))
        host = torch.empty(plane.shape, dtype=_TORCH_DTYPE[plane.dtype], pin_memory=True)
        host.numpy()[...] = plane
        return host

    def _net_input(self, form: str, dev: Dict[str, torch.Tensor],
                   full_depth: Optional[int]) -> torch.Tensor:
        """The dense batch on the device: unpack, then pad the depth band
        back to the full depth."""
        if form == FA_SPARSE:
            x = unpack_fa_sparse_torch(dev)
        elif form == FA_V1:
            x = unpack_fa_torch(dev["cells"], dev["bitmask"], dev["scalars"], dev["refcol"])
        elif form == PILEUP_COMPACT:
            x = unpack_pileup_torch(dev["mags"], dev["negidx"])
        else:
            x = dev["x"]
        if full_depth is not None and x.shape[1] < full_depth:
            top = (full_depth - x.shape[1]) // 2
            x = F.pad(x, (0, 0, 0, 0, top, full_depth - x.shape[1] - top))
        return x

    def _put_and_forward(self, chunk: np.ndarray, bucket: int) -> List[Tuple]:
        """One chunk: its wire form, band, K bucket and pad decided once,
        then its rows split into one equal shard per device; returns each
        shard's ``(probabilities, event)`` in device order."""
        form, planes, full_depth = self._wire_form(chunk)
        planes = _pad_to_bucket(planes, chunk.shape[0], bucket)
        self.bytes_shipped += sum(v.nbytes for v in planes.values())
        self.dense_bytes += (bucket * int(np.prod(chunk.shape[1:]))
                             * np.dtype(self.transfer_dtype or chunk.dtype).itemsize)
        rows = bucket // len(self.devices)
        return [self._forward_shard(i, form, {k: v[i * rows: (i + 1) * rows]
                                              for k, v in planes.items()}, full_depth)
                for i in range(len(self.devices))]

    def _forward_shard(self, i: int, form: str, planes: Dict[str, np.ndarray],
                       full_depth: Optional[int]):
        """Replica ``i``'s shard on its device: the pinned copy, the unpack,
        the forward and the copy back, all queued on the replica's stream
        (one event recorded after them); on the CPU, done in place."""
        net, device, stream = self.replicas[i], self.devices[i], self._streams[i]
        host = {k: self._host_plane(v, device) for k, v in planes.items()}
        if stream is None:
            with torch.inference_mode(), record_function(self._label):
                return net(self._net_input(form, host, full_depth)), None
        # the device too: a kernel library may have set another current
        # device on this thread, and unindexed allocations follow it
        with torch.cuda.device(device), torch.cuda.stream(stream), torch.inference_mode():
            dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            with record_function(self._label):
                y = net(self._net_input(form, dev, full_depth))
            out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            out.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def predict_async(self, x: np.ndarray) -> List:
        """Enqueue a host batch; returns handles for ``gather``."""
        handles: List = []
        top = self.buckets[-1]
        for lo in range(0, x.shape[0], top):
            chunk = x[lo: lo + top]
            m = chunk.shape[0]
            handles.append((self._submitter.submit(
                self._put_and_forward, chunk, self._bucket_for(m)), m))
        return handles

    @staticmethod
    def gather(handles: List) -> np.ndarray:
        """Wait for async handles; host probabilities ``[N, 24|90]``."""
        if not handles:
            return _EMPTY.copy()
        out = []
        for fut, m in handles:
            shards = fut.result()
            for _, done in shards:
                if done is not None:
                    done.synchronize()
            out.append(np.concatenate([y.float().numpy() for y, _ in shards])[:m])
        return np.concatenate(out, axis=0)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Forward a host batch; probabilities ``[N, 24|90]`` float32."""
        if x.shape[0] == 0:
            return _EMPTY.copy()
        return self.gather(self.predict_async(x))

    def warmup_batches(self, input_shape, dtype) -> List[np.ndarray]:
        """One smallest-bucket batch per route the engine can take: every
        depth band, and with ``fa_compact`` every sparse K bucket (rows
        with more than K0 alt entries force the larger one)."""
        D = input_shape[0]
        depths = (self._depth_buckets(D) if self.depth_crop and len(input_shape) == 3
                  else (D,))
        batches = []
        for db in depths:
            x = np.zeros((self.buckets[0],) + tuple(input_shape), dtype)
            if len(input_shape) == 3:
                top = (D - db) // 2
                x[:, top: top + db, :, 2] = 1  # covered reads fill the band
            batches.append(x)
            if self.fa_compact and len(input_shape) == 3:
                w = x.copy()
                w[:, top: top + _fa_compact.K_BUCKETS[0] // 33 + 1, :, 1] = 1
                batches.append(w)
        return batches

    def warmup(self, input_shape, dtype) -> None:
        """Run every route once on every GPU replica (``warmup_batches``),
        so the kernel build, the library initialisation and each route's
        first launches happen before the first real batch.  On the CPU
        there is nothing to prepare."""
        if all(s is None for s in self._streams):
            return
        for x in self.warmup_batches(input_shape, dtype):
            for _, done in self._put_and_forward(x, self.buckets[0]):
                if done is not None:
                    done.synchronize()

    def warmup_async(self, input_shape, dtype) -> Future:
        """Queue ``warmup`` on the submitter thread, ahead of any batch."""
        self._warmup = self._submitter.submit(self.warmup, input_shape, dtype)
        return self._warmup

    def wait_warmup(self) -> None:
        """Wait for a queued warmup and raise what it raised."""
        if self._warmup is not None:
            self._warmup.result()
            self._warmup = None


def rescale_high_coverage_pileup(
    tensors: np.ndarray, alt_infos: Sequence[str], max_depth: int = 144
) -> np.ndarray:
    """Integer-truncated rescale of extreme-coverage pileup tensors
    (reference: CallVariantsFromCffi.py:278-285)."""
    for i, alt_info in enumerate(alt_infos):
        depth = int(str(alt_info).split("-", maxsplit=1)[0])
        if depth > 0 and depth > max_depth * 1.5:
            scale = depth / max_depth
            tensors[i] = (tensors[i] / scale).astype(tensors.dtype)
    return tensors
