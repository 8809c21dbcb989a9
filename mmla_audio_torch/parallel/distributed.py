"""Multi-process data and tensor parallelism over ``torch.distributed``
(counterpart of ``mmla_audio_tpu.parallel.distributed``).

PyTorch's idiom is one process a card: each process captures or ingests
its own windows and holds its own batch, and the only traffic between
processes is the training's (the corpus gathered once, the gradients and
BatchNorm's batch sums each step, and with a model axis the parameters'
all-gather; ``Trainer.fit(mesh=)``).  Serving sends nothing between
processes.

``initialize()`` is a no-op unless a multi-process run is configured, and
``host_local_batch_to_global`` is ``shard_batch`` in one process, so the
same program runs in one process or many::

    from mmla_audio_torch.parallel import distributed as dist
    dist.initialize()                    # torchrun's environment, or nothing
    mesh = dist.global_mesh()
    xg = dist.host_local_batch_to_global(local_features, mesh)
    history = trainer.fit(xg, yg, epochs=..., batch_size=..., mesh=mesh)

Launch: ``torchrun --nproc_per_node=<cards> train.py`` (NCCL, one card a
process), or ``initialize("host:port", world, rank)`` in each process.
``global_mesh(n_model=k)`` lays the ranks out as a (world / k, k) grid
whose model axis splits the parameters and their optimizer state.
NCCL refuses two ranks on one card; on one card it runs at world size 1,
and several processes on one machine without cards use gloo
(``device="cpu"``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mmla_audio_torch.core.config import MeshConfig
from mmla_audio_torch.parallel.mesh import (Mesh, ShardedBatch,
                                            batch_sharding, make_mesh,
                                            shard_batch)

__all__ = ["initialize", "process_info", "global_mesh",
           "host_local_batch_to_global"]

_initialized = False


def _backend(device: str) -> str:
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device; "
                               "pass device='cpu' for gloo")
        return "nccl"
    if device == "cpu":
        return "gloo"
    raise ValueError(f"device must be 'cuda' or 'cpu': {device!r}")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda") -> None:
    """Join (or skip joining) the default process group.

    Explicit arguments (all three, or none) join at
    ``tcp://<coordinator_address>`` with NCCL for ``device="cuda"`` (this
    process then uses card ``process_id`` modulo the cards it sees) or gloo
    for ``"cpu"``.  Without arguments it joins only where torchrun's
    environment names a multi-process run (``WORLD_SIZE`` > 1 and
    ``MASTER_ADDR``; the card is ``LOCAL_RANK``'s), else does nothing.
    Safe to call more than once."""
    global _initialized
    if _initialized:
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit) \
            and any(a is None for a in explicit):
        raise ValueError(
            "initialize(): coordinator_address, num_processes and "
            f"process_id must be given together, got {explicit!r}")
    if dist.is_initialized():
        _initialized = True
        return
    if coordinator_address is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1 \
                or "MASTER_ADDR" not in os.environ:
            return                         # one process: nothing to join
        backend = _backend(device)
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        dist.init_process_group(backend)   # env://, torchrun's variables
    else:
        backend = _backend(device)
        local = int(process_id)
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    if backend == "nccl":
        torch.cuda.set_device(local % torch.cuda.device_count())
    _initialized = True


def process_info() -> tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(n_model: int = 1, device: str = "cuda") -> Mesh:
    """In one process, ``make_mesh`` over its cards (``device="cpu"``: the
    CPU).  Once a process group exists (at any world size), a ``(world /
    n_model, n_model)`` grid of one device a rank: rank ``r`` at ``(r //
    n_model, r % n_model)``, its device card ``r`` modulo the cards of a
    host (torchrun's layout).  With ``n_model == 1`` the data axis carries
    the default group; otherwise every rank creates, in the same order, the
    group of each model coordinate (a column of the grid: the ranks that
    split the batch) and of each data coordinate (a row: the ranks that
    split the parameters), and the mesh carries its own two."""
    if not (dist.is_available() and dist.is_initialized()):
        devices = None if device == "cuda" else [torch.device(device)]
        return make_mesh(n_model=n_model, devices=devices)
    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"global_mesh: a model axis of {n_model} does not "
                         f"divide the {world} processes")
    n_data = world // n_model
    grid = np.empty((n_data, n_model), dtype=object)
    for r in range(world):
        grid[r // n_model, r % n_model] = \
            torch.device("cuda", r % torch.cuda.device_count()) \
            if device == "cuda" else torch.device(device)
    cfg = MeshConfig()
    axes = (cfg.data_axis, cfg.model_axis)
    if n_model == 1:
        return Mesh(grid, axes, group=dist.group.WORLD)
    rank = dist.get_rank()
    columns = [dist.new_group([i * n_model + j for i in range(n_data)])
               for j in range(n_model)]
    rows = [dist.new_group([i * n_model + j for j in range(n_model)])
            for i in range(n_data)]
    return Mesh(grid, axes, group=columns[rank % n_model],
                model_group=rows[rank // n_model])


def host_local_batch_to_global(x, mesh: Mesh) -> ShardedBatch:
    """Each process's ``(B_local, ...)`` rows as one ``(world * B_local,
    ...)`` batch split over the data axis: this rank's block is its own
    rows, on its device; no row crosses processes.  In one process (or a
    mesh without a group) this is ``shard_batch``."""
    if mesh.group is None or dist.get_world_size(mesh.group) == 1:
        return shard_batch(x, mesh)
    x = torch.as_tensor(x)
    world = dist.get_world_size(mesh.group)
    return ShardedBatch([x.to(mesh.local_devices[0])], batch_sharding(mesh),
                        (world * x.shape[0],) + tuple(x.shape[1:]))
