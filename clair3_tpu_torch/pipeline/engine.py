"""Batched inference engine, the counterpart of
``clair3_tpu/pipeline/engine.py``.

* candidate tensors stream in from the host extractors;
* batches are cut at the largest bucket and zero-padded to a small set of
  static bucket sizes, as the JAX engine does;
* one submitter thread copies each batch to the device (from pinned host
  memory, on the engine's own CUDA stream) and runs the net there, so the
  caller can decode batch i-1 while batch i is in flight;
* probabilities come back to pinned host memory, and ``gather`` waits for
  them.

Pileup batches cross as int16 and full-alignment batches as int8, dense.
The JAX engine's compact wire forms and FA depth crop are exact reshapings
of the same input and are not ported yet.

The pileup high-coverage rescale (``rescale_high_coverage_pileup``) is a
jax-free copy of the JAX engine's, so the pipeline can run where jax is not
installed.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

_DEFAULT_BUCKETS = (256, 1024, 2048, 4096)
_EMPTY = np.zeros((0, 90), np.float32)
_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


class InferenceEngine:
    """Batch forward of one net on one device.

    ``model`` is an ``nn.Module`` already on ``device``; ``transfer_dtype``
    is the numpy dtype of the host->device copy (the net widens it to its
    compute dtype on the device)."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 buckets: Sequence[int] = _DEFAULT_BUCKETS,
                 transfer_dtype=None):
        self.model = model.eval()
        self.device = torch.device(device)
        self.buckets = tuple(sorted(buckets))
        self.transfer_dtype = transfer_dtype
        # bytes handed to the host->device copy (post pad), on the submitter
        self.bytes_shipped = 0
        self.fa_input_channels: Optional[int] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._submitter = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-submit")
        self._warmup: Optional[Future] = None

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top

    def _host_batch(self, chunk: np.ndarray, bucket: int) -> torch.Tensor:
        """The chunk in the transfer dtype, zero-padded to ``bucket`` rows,
        in pinned memory when the device is a GPU."""
        dtype = np.dtype(self.transfer_dtype or chunk.dtype)
        host = torch.empty((bucket,) + chunk.shape[1:], dtype=_TORCH_DTYPE[dtype],
                           pin_memory=self._stream is not None)
        view = host.numpy()
        view[: len(chunk)] = chunk
        view[len(chunk):] = 0
        return host

    def _put_and_forward(self, chunk: np.ndarray, bucket: int):
        host = self._host_batch(chunk, bucket)
        self.bytes_shipped += host.numel() * host.element_size()
        if self._stream is None:
            with torch.inference_mode():
                return self.model(host), None
        with torch.cuda.stream(self._stream), torch.inference_mode():
            x = host.to(self.device, non_blocking=True)
            y = self.model(x)
            out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            out.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
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
            y, done = fut.result()
            if done is not None:
                done.synchronize()
            out.append(y.float().numpy()[:m])
        return np.concatenate(out, axis=0)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Forward a host batch; probabilities ``[N, 24|90]`` float32."""
        if x.shape[0] == 0:
            return _EMPTY.copy()
        return self.gather(self.predict_async(x))

    def warmup(self, input_shape, dtype) -> None:
        """Run the smallest bucket once on a GPU, so the kernel build and
        the library initialisation happen before the first real batch.  On
        the CPU there is nothing to prepare."""
        if self._stream is None:
            return
        _, done = self._put_and_forward(
            np.zeros((1,) + tuple(input_shape), dtype), self.buckets[0])
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
