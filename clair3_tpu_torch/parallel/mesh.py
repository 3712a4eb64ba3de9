"""The port's counterpart of ``clair3_tpu/parallel/mesh.py``: the local
devices an inference engine shards its batches over, and data-parallel
training over ``torch.distributed``.

``local_devices`` is ``get_mesh(local=True)`` (and ``get_mesh(n_devices=...)``):
``pipeline/engine.py::InferenceEngine`` splits each batch by rows over
them, one replica of the net per device.

The JAX package trains on one jit program over a 1-D ``Mesh`` of every
process's devices (``get_mesh(local=False)``): the parameters replicated,
each batch padded to a multiple of the device count and sharded along the
data axis, XLA reducing over the whole batch.  Here each device is a rank
of one process group, the counterpart of that mesh:

* ``run_ranks`` runs a function once on every rank.  Under ``torchrun``
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) this process is its rank.  Without those variables it
  starts one rank per visible CUDA device with ``torch.multiprocessing``;
  with one device, or on the CPU, that one rank is this process.
* ``init_data_parallel`` joins the group (NCCL on CUDA, gloo on the CPU),
  and ``shard_rows`` gives rank ``r`` its rows of a batch padded by
  ``pad_to_multiple``, the counterpart of ``shard_batch`` /
  ``parallel/distributed.py::global_batch``.

The step (``train/step.py::replicate``) wraps the net in
``DistributedDataParallel``; its BatchNorm and dropout see the global
batch, so N ranks compute the function one device computes on the padded
batch.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Callable, List, Optional

import numpy as np
import torch

from clair3_tpu_torch.device import resolve_device

# ranks reach a collective after unequal host work (checkpoints, data)
TIMEOUT = timedelta(seconds=1800)


def local_devices(device, n_devices: Optional[int] = None) -> List[torch.device]:
    """This process's devices of ``device``'s kind, each with its index:
    ``cuda`` gives every visible card (``cuda:0`` ... ``cuda:{count - 1}``;
    ``CUDA_VISIBLE_DEVICES`` narrows them), ``cuda:k`` that card alone,
    ``cpu`` ``[cpu]``; ``n_devices`` keeps the first n.  ``cuda`` with no
    visible card raises, as ``device.resolve_device`` does."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    return devices if n_devices is None else devices[:n_devices]


def pad_to_multiple(x: np.ndarray, multiple: int) -> tuple:
    """Pad the batch axis up to a multiple; returns (padded, original_n)."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad = np.zeros((target - n,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n


def shard_rows(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s rows of a batch whose length is a multiple of
    ``world``: the ``rank``-th of ``world`` equal, contiguous slices, as
    the mesh's data axis splits it."""
    if len(x) % world:
        raise ValueError(f"a batch of {len(x)} rows does not split over {world} ranks; "
                         "pad it with pad_to_multiple first")
    n = len(x) // world
    return x[rank * n: (rank + 1) * n]


def init_data_parallel(device: torch.device, rank: int, world: int,
                       init_method: str = "env://", local_rank: Optional[int] = None,
                       backend: Optional[str] = None) -> torch.device:
    """Join the group of ``world`` ranks as ``rank`` (NCCL on CUDA, gloo on
    the CPU, unless ``backend`` says otherwise); returns this rank's
    device: ``cuda:{local_rank % device count}`` on CUDA.

    A group this process joined before is kept, and then it raises when
    that group's size or this process's rank in it is not the one asked
    for: the ranks would otherwise split the batch wrongly."""
    import torch.distributed as dist

    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is visible to torch "
                               "(use --device cpu to run on the CPU)")
        local = rank if local_rank is None else local_rank
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank, timeout=TIMEOUT)
    if (dist.get_world_size(), dist.get_rank()) != (world, rank):
        raise RuntimeError(f"requested rank {rank} of world_size={world} but the process "
                           f"group has rank {dist.get_rank()} of "
                           f"world_size={dist.get_world_size()}")
    return device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, fn: Callable,
               device: torch.device, backend: Optional[str], local_rank: Optional[int]):
    """``fn(device)`` on rank ``rank`` of the group; the group is destroyed
    on success and on error, so a peer blocked in a collective sees this
    rank leave instead of waiting out the timeout."""
    import torch.distributed as dist

    try:
        return fn(init_data_parallel(device, rank, world, init_method, local_rank=local_rank,
                                     backend=backend))
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _spawned(index: int, world: int, init_method: str, fn: Callable, device: torch.device):
    _rank_main(index, world, init_method, fn, device, None, index)


def run_ranks(fn: Callable, device: torch.device, backend: Optional[str] = None):
    """Run ``fn(rank_device)`` on every rank of a data-parallel group:

    * with torchrun's variables set, as rank ``RANK`` of ``WORLD_SIZE``
      (``init_method="env://"``, device ``cuda:{LOCAL_RANK}``);
    * else, on CUDA with several visible devices, one rank per device, each
      a process spawned by ``torch.multiprocessing`` (``fn`` must pickle);
      a rank that raises ends the others and raises here;
    * else (one device, or the CPU) as the one rank of a group of one.

    Returns ``fn``'s result on this process's rank (None after a spawn)."""
    env = os.environ
    if "RANK" in env:
        return _rank_main(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://", fn, device,
                          backend, int(env.get("LOCAL_RANK", env["RANK"])))
    world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world <= 1:
        return _rank_main(0, 1, f"tcp://127.0.0.1:{_free_port()}", fn, device, backend, 0)
    spawn_ranks(fn, device, world)
    return None


def spawn_ranks(fn: Callable, device: torch.device, world: int) -> None:
    """Run ``fn(rank_device)`` on ``world`` ranks, each a process spawned by
    ``torch.multiprocessing`` and joined at a free port of 127.0.0.1 (NCCL
    on CUDA, one card per rank; gloo on the CPU, where any number of ranks
    share the host).  ``fn`` must pickle; a rank that raises ends the
    others and raises here."""
    import torch.multiprocessing as mp

    init_method = f"tcp://127.0.0.1:{_free_port()}"
    mp.spawn(_spawned, args=(world, init_method, fn, device), nprocs=world, join=True)
