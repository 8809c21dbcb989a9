"""Device meshes, data parallelism and the tensor-parallel parameter rule
(counterpart of ``mmla_audio_tpu.parallel.mesh``).

Conversation windows are independent, so serving scales by data
parallelism: a window batch splits into equal row blocks along its first
axis, one block a device of the mesh's ``data`` axis, and the model is
replicated.  Training can also spread its parameters and optimizer state
over the mesh's ``model`` axis (``param_shardings``, ``shard_params``,
``Trainer.fit`` on a ``distributed.global_mesh(n_model=k)``).

Two kinds of mesh:

* a **single-process** mesh spans one process's devices (``make_mesh``):
  ``DataParallel`` runs one program a shard, in turn, each on its device,
  and the multiplexer splits its batches this way.  A device may be listed
  more than once: that is how a many-shard mesh is built on one card or on
  the CPU.
* a **multi-process** mesh (``distributed.global_mesh``) has one device a
  rank and carries the process groups: ``group``, the ranks of this
  process's model coordinate (they split the batch), and, with a model axis
  over 1, ``model_group``, the ranks of its data coordinate (they split the
  parameters).  Each process holds only its own shard; the reductions over
  the batch and the gathers of the parameters are the trainer's
  (``Trainer.fit(mesh=)``), through the groups.

Why not ``torch.distributed.device_mesh.DeviceMesh``: it puts one device on
each rank and needs a process group even at world size 1, while a JAX mesh
(and the multiplexer's) spans the cards of one process.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmla_audio_torch.core.config import MeshConfig

__all__ = ["Mesh", "Sharding", "ShardedBatch", "canonical_device", "make_mesh",
           "replicated", "batch_sharding", "shard_batch", "replicate_tree",
           "param_shardings", "shard_params", "DataParallel"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, shape ``(n_data,
    n_model)``; ``axis_names``: the data axis first; ``group``: the process
    group of the data axis when it spans processes (the ranks that share
    this process's model coordinate, in data order), else None;
    ``model_group``: the ranks that share this process's data coordinate,
    in model order, when the model axis spans processes, else None."""

    devices: np.ndarray
    axis_names: tuple
    group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_devices(self) -> List[torch.device]:
        """The data-axis devices whose shards this process holds, in axis
        order: all of them in one process (the model axis's first column),
        this rank's own across processes."""
        if self.group is None:
            return list(self.devices[:, 0])
        import torch.distributed as dist

        j = 0 if self.model_group is None else \
            dist.get_rank(self.model_group)
        return [self.devices[dist.get_rank(self.group), j]]

    def _key(self) -> tuple:
        return (tuple(self.devices.ravel().tolist()), self.devices.shape,
                tuple(self.axis_names), self.group, self.model_group)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: ``spec`` names the mesh axis each
    leading array axis is split over (``()``: replicated)."""

    mesh: Mesh
    spec: tuple = ()


def canonical_device(d) -> torch.device:
    """A device with its index where the card is present (``"cuda"`` ->
    ``cuda:<current>``), so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None) -> Mesh:
    """An ``(n_data, n_model)`` mesh over ``devices`` (default: every card
    of this process; without a card, pass ``devices``, e.g.
    ``[torch.device("cpu")] * 8``).  Explicit ``n_data``/``n_model`` win;
    otherwise ``cfg``'s ``data_parallel``/``model_parallel`` (-1: every
    device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= to build a mesh "
                "without a card (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    n_model = cfg.model_parallel if n_model is None else n_model
    n_data = cfg.data_parallel if n_data is None else n_data
    if n_data == -1:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"need {n_data}x{n_model} devices, have "
                         f"{len(devices)}")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[: n_data * n_model]):
        grid[i // n_model, i % n_model] = d
    return Mesh(grid, (cfg.data_axis, cfg.model_axis))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, axis: Optional[str] = None) -> Sharding:
    """Rows split over ``axis`` (default: the mesh's first, data, axis)."""
    return Sharding(mesh, (mesh.axis_names[0] if axis is None else axis,))


@dataclasses.dataclass(eq=False)
class ShardedBatch:
    """A ``shape``-row batch split in equal row blocks over the data axis.
    ``shards``: the blocks this process holds, on their devices, in axis
    order (every block in one process; its own across processes)."""

    shards: List[torch.Tensor]
    sharding: Sharding
    shape: tuple

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch on ``device`` (default: the first local device).
        Across processes, an all-gather of every rank's block."""
        mesh = self.sharding.mesh
        device = mesh.local_devices[0] if device is None else device
        if mesh.group is None:
            return torch.cat([s.to(device) for s in self.shards])
        import torch.distributed as dist

        local = self.shards[0].contiguous()
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(mesh.group))]
        dist.all_gather(parts, local, group=mesh.group)
        return torch.cat(parts).to(device)


def shard_batch(x, mesh: Mesh) -> ShardedBatch:
    """Equal row blocks of ``x`` (a tensor or array, every process's whole
    batch) along dim 0, one on each data-axis device; raises where the
    rows do not divide by the data axis.  A block already on its device is
    a view of ``x``."""
    x = torch.as_tensor(x)
    n = mesh.devices.shape[0]
    if x.ndim == 0 or x.shape[0] % n:
        raise ValueError(f"shard_batch: {tuple(x.shape)} rows do not divide "
                         f"by the data axis ({n})")
    rows = x.shape[0] // n
    picks = range(n)
    if mesh.group is not None:
        import torch.distributed as dist

        picks = [dist.get_rank(mesh.group)]
    shards = [x[i * rows:(i + 1) * rows].to(d)
              for i, d in zip(picks, mesh.local_devices)]
    return ShardedBatch(shards, batch_sharding(mesh), tuple(x.shape))


def _copy_to(tree, device: torch.device):
    if isinstance(tree, nn.Module):
        if all(t.device == device for t in
               list(tree.parameters()) + list(tree.buffers())):
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    raise TypeError(f"replicate_tree: an nn.Module, tensor or dict of "
                    f"them, got {type(tree).__name__}")


def replicate_tree(tree: Any, mesh: Mesh) -> Dict[torch.device, Any]:
    """One copy of ``tree`` (an ``nn.Module``, a tensor or a dict of
    tensors) on each distinct local device of the mesh, keyed by device; a
    tree already on a device is that device's copy."""
    out: Dict[torch.device, Any] = {}
    for d in mesh.local_devices:
        if d not in out:
            out[d] = _copy_to(tree, d)
    return out


def param_shardings(tree, mesh: Mesh, axis: Optional[str] = None
                    ) -> Dict[str, Optional[int]]:
    """The tensor-parallel rule of the JAX package, per tensor of ``tree``
    (an ``nn.Module``'s parameters, or a state dict): split along its
    output-feature dimension over ``axis`` (default the model axis, the
    mesh's last) every tensor of at least 2 dimensions whose output-feature
    dimension divides by the axis's size; replicate the rest (biases,
    BatchNorm vectors and statistics, a head whose width does not divide).

    The output-feature dimension is the JAX layout's last axis; in the
    port's layouts (``params.py``) it is dim 0: OIHW and (out, in, k)
    convolutions, (out, in) Dense and (4H, in) LSTM weights.  Returns
    ``{name: 0 or None}`` (None: replicated); with an axis of size 1 every
    tensor is replicated."""
    axis = mesh.axis_names[-1] if axis is None else axis
    n = mesh.shape[axis]
    items = tree.named_parameters() if isinstance(tree, nn.Module) \
        else tree.items()
    return {name: 0 if n > 1 and t.ndim >= 2 and t.shape[0] % n == 0
            else None for name, t in items}


def shard_params(tree, mesh: Mesh, axis: Optional[str] = None
                 ) -> Dict[str, List[torch.Tensor]]:
    """``tree``'s tensors laid out by ``param_shardings``: for each name,
    this process's blocks in model-axis order, each on its device (the
    mesh's first data row in one process; across processes the one block
    of this rank's model coordinate, on its device).  A replicated tensor's
    block is the whole tensor."""
    axis = mesh.axis_names[-1] if axis is None else axis
    n = mesh.shape[axis]
    split = param_shardings(tree, mesh, axis)
    items = dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else dict(tree)
    if mesh.model_group is None:
        picks = list(enumerate(mesh.devices[0, :]))
    else:
        import torch.distributed as dist

        picks = [(dist.get_rank(mesh.model_group), mesh.local_devices[0])]
    out = {}
    for name, t in items.items():
        t = t.detach()
        if split[name] is None:
            out[name] = [t.to(d) for _, d in picks]
        else:
            size = t.shape[0] // n
            out[name] = [t[j * size:(j + 1) * size].to(d) for j, d in picks]
    return out


class DataParallel:
    """``fn(state, *batch)`` over a mesh: the state replicated, each batch
    argument split into row blocks (``shard_batch``, or a ``ShardedBatch``
    as given); ``fn`` runs once a local shard, on that shard's device with
    that device's replica, and the outputs are concatenated along dim 0 on
    the first local device.

    ``fn`` must be row-independent, as every serving program is (e.g.
    ``predictor.lower_fn()``).  An output without the batch axis (a
    reduction over the batch) raises ``ValueError``: reductions over the
    batch belong to the trainer, through the process group.  Across
    processes each rank gets the outputs of its own rows; no row crosses
    processes."""

    def __init__(self, fn: Callable, mesh: Mesh):
        self.fn = fn
        self.mesh = mesh

    def __call__(self, state, *batch):
        replicas = replicate_tree(state, self.mesh)
        batch = [b if isinstance(b, ShardedBatch) else shard_batch(b, self.mesh)
                 for b in batch]
        devices = self.mesh.local_devices
        outs = []
        for i, d in enumerate(devices):
            args = [b.shards[i] for b in batch]
            out = self.fn(replicas[d], *args)
            single = not isinstance(out, (tuple, list))
            out = (out,) if single else tuple(out)
            rows = args[0].shape[0]
            for o in out:
                if not isinstance(o, torch.Tensor) or o.ndim == 0 \
                        or o.shape[0] != rows:
                    raise ValueError(
                        "DataParallel: every output must keep the batch "
                        f"axis ({rows} rows a shard), got "
                        f"{getattr(o, 'shape', type(o).__name__)}; a "
                        f"reduction over the batch is not row-independent")
            outs.append(out)
        merged = tuple(torch.cat([o[j].to(devices[0]) for o in outs])
                       for j in range(len(outs[0])))
        return merged[0] if single else merged
