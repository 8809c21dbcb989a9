"""Keras-flavoured training loop (counterpart of
``mmla_audio_tpu.train.trainer``).

``Trainer.fit`` runs epochs of shuffled batches.  A partial last batch is
zero-padded and loss-masked, as in the JAX package, so BatchNorm's batch
statistics see the padding rows (Keras runs a smaller batch instead).
Early stopping on ``val_loss`` (patience, no restore: the Keras default)
and an epoch-indexed learning rate (``lr_schedule_epoch``, written into
every parameter group's ``lr``) reproduce the reference's callbacks
(`overlap_detector.py:405-421`).

Randomness comes from explicit generators seeded by ``seed``: each epoch's
permutation from a CPU generator (the same on every device), the dropout
masks from one on the model's device.  ``fit`` also takes the permutations
themselves, so a caller can replay another run's order.  The model's
convolutions, LSTM and GEMMs run in IEEE fp32 (TF32 off on the card).

``fit(mesh=)`` is the JAX package's data-parallel fit in PyTorch's idiom of
one process a device (``parallel.distributed``): every rank holds the whole
corpus (a host-local ``ShardedBatch`` is all-gathered once), draws the same
permutation and takes its ``batch_size / world`` rows of each global batch.
The masked loss is normalised by the global batch's real rows, the
gradients are all-reduced as a sum, the penalty counts once (rank 0's),
BatchNorm's statistics and dropout's masks are the global batch's
(``models.layers``), and the parameters are broadcast from rank 0 first,
so the fit equals the one-process fit.  A one-process mesh must hold a
single device and runs exactly as ``mesh=None``, whatever its shape.

A mesh whose model axis spans processes (``distributed.global_mesh(
n_model=k)``) also splits the parameters: parameter-sharded data
parallelism, the storage GSPMD's layout of the JAX package gives.  Each
rank keeps, of every parameter that ``parallel.param_shardings`` splits,
only its block of the master weights, and the optimizer is built over
those blocks (and the replicated parameters), so its state is split the
same way; Keras Adadelta and RMSprop are elementwise, so a block's update
is the full update's block.  The batch is split over the data axis alone
(the ranks of one data coordinate see the same rows); after backward the
gradients are all-reduced over the data group, each rank copies its block
of every split gradient into its block's ``.grad`` and steps, and one flat
all-gather over the model group rebuilds the module's whole working
weights for the next step (and for evaluation and ``variables_of``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mmla_audio_torch.models.layers import (KerasBatchNorm, KerasBatchNorm1d,
                                            SeededDropout)
from mmla_audio_torch.parallel.mesh import ShardedBatch, param_shardings
from mmla_audio_torch.precision import fp32_policy

__all__ = ["Trainer", "pad_to_batches", "masked_mean"]


def pad_to_batches(x: torch.Tensor, y: torch.Tensor, batch_size: int):
    """Pad ``(x, y)`` with zero rows to a multiple of ``batch_size``;
    returns ``(x, y, mask)``, the mask 1.0 on the real rows, on ``x``'s
    device."""
    n = x.shape[0]
    total = -(-n // batch_size) * batch_size
    mask = (torch.arange(total, device=x.device) < n).to(torch.float32)
    if total > n:
        x = torch.cat([x, x.new_zeros((total - n,) + tuple(x.shape[1:]))])
        y = torch.cat([y, y.new_zeros((total - n,) + tuple(y.shape[1:]))])
    return x, y, mask


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``sum(values * mask) / max(sum(mask), 1)``."""
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _correct(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, -1) == torch.argmax(y, -1)).to(torch.float32)


class _Blocks:
    """A rank's blocks of the split parameters on a model axis: ``masters``
    (what the optimizer steps: each split parameter's block along dim 0 as
    a leaf tensor, each replicated parameter itself), the gradient copy
    into the blocks and the all-gather back into the whole parameters."""

    def __init__(self, params: List[nn.Parameter], split, group):
        self.group = group
        self.k, self.j = dist.get_world_size(group), dist.get_rank(group)
        self.masters: List[torch.Tensor] = []
        self.pairs = []                        # (parameter, its block)
        for p, dim in zip(params, split):
            if dim is None:
                self.masters.append(p)
                continue
            rows = p.shape[0] // self.k
            block = p.detach()[self.j * rows:(self.j + 1) * rows].clone()
            block.requires_grad_(True)
            self.masters.append(block)
            self.pairs.append((p, block))

    def grads_to_blocks(self) -> None:
        """Each split parameter's gradient block into its block's ``.grad``
        (the parameter's own gradient is then dropped: no optimizer owns
        it)."""
        for p, block in self.pairs:
            if p.grad is not None:
                rows = block.shape[0]
                block.grad = p.grad[self.j * rows:(self.j + 1) * rows].clone()
                p.grad = None

    @torch.no_grad()
    def gather(self) -> None:
        """One flat all-gather of every block over the model group, each
        parameter rebuilt from its ``k`` blocks in model order."""
        if not self.pairs:
            return
        flat = torch.cat([b.reshape(-1) for _, b in self.pairs])
        parts = [torch.empty_like(flat) for _ in range(self.k)]
        dist.all_gather(parts, flat, group=self.group)
        whole = torch.stack(parts)                   # (k, blocks' numel)
        offset = 0
        for p, block in self.pairs:
            n = block.numel()
            p.view(self.k, n).copy_(whole[:, offset: offset + n])
            offset += n


class Trainer:
    """Trains ``model`` in place.

    ``tx``: an optimizer factory (``optimizers.rmsprop(lr)``), applied to
    every parameter that requires a gradient.  ``loss_fn(logits, y)`` ->
    per-example loss; the step adds ``extra_penalty_fn(model)`` (e.g. the
    Keras l2 regularizers, ``models.speaker.l2_penalty``) to the masked
    batch mean.
    """

    def __init__(self, model: nn.Module, tx: Callable, loss_fn: Callable, *,
                 extra_penalty_fn: Optional[Callable] = None,
                 device: torch.device | str = "cuda", seed: int = 0):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._tx = tx
        self.optimizer = tx(self._params)
        self._blocks: Optional[_Blocks] = None   # a model axis's blocks
        self.loss_fn = loss_fn
        self.extra_penalty_fn = extra_penalty_fn
        self.generator = torch.Generator().manual_seed(seed)
        dropout_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, SeededDropout):
                m.generator = dropout_generator

    def variables_of(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict, copied to the CPU."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.model.state_dict().items()}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    # -- steps ---------------------------------------------------------------
    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor, denom: Optional[torch.Tensor] = None,
                   penalty: bool = True, group=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on a batch; returns its (loss, accuracy) as
        device scalars.  The loss is ``sum(loss * mask) / denom`` (default
        ``max(sum(mask), 1)``) plus the penalty where ``penalty``.  With a
        process ``group`` the batch is this rank's rows of a global batch
        with ``denom`` real rows, the gradients are all-reduced over the
        group, and the returned values are this rank's parts."""
        if denom is None:
            denom = torch.clamp(torch.sum(mask), min=1.0)
        self.model.train()
        with fp32_policy(False):
            logits = self.model(x)
            loss = torch.sum(self.loss_fn(logits, y) * mask) / denom
            if penalty and self.extra_penalty_fn is not None:
                loss = loss + self.extra_penalty_fn(self.model)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if group is not None:
                self._all_reduce_grads(group)
            if self._blocks is not None:
                self._blocks.grads_to_blocks()
            self.optimizer.step()
            if self._blocks is not None:
                self._blocks.gather()
        correct = torch.sum(_correct(logits.detach(), y) * mask) / denom
        return loss.detach(), correct

    def _all_reduce_grads(self, group) -> None:
        """Sum every gradient over ``group`` in one flat all-reduce."""
        grads = [p.grad for p in self._params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()

    def _run_epoch(self, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                   perm, batch_size: int, group=None) -> tuple[float, float]:
        """One epoch over the padded ``(x, y, mask)`` in the order ``perm``;
        returns the mean of the batches' losses and accuracies.  With a
        ``group`` each rank steps on its block of every batch and the
        batches' parts are summed over the group once, at the end."""
        perm = torch.from_numpy(np.array(perm, np.int64)).to(self.device)
        rank, world = (0, 1) if group is None else \
            (dist.get_rank(group), dist.get_world_size(group))
        local = batch_size // world
        stats = []
        for b in range(x.shape[0] // batch_size):
            idx = perm[b * batch_size:(b + 1) * batch_size]
            denom = torch.clamp(torch.sum(mask[idx]), min=1.0)
            idx = idx[rank * local:(rank + 1) * local]
            stats.append(torch.stack(self.train_step(
                x[idx], y[idx], mask[idx], denom, rank == 0, group)))
        stats = torch.stack(stats)
        if group is not None:
            dist.all_reduce(stats, group=group)
        loss, acc = stats.mean(0).tolist()
        return loss, acc

    def _mesh_groups(self, mesh, batch_size: int) -> tuple:
        """The process groups a fit on ``mesh`` reduces over: (data group,
        model group), each None where the fit needs none (``(None, None)``:
        the one-process fit), after the mesh's checks."""
        if mesh is None:
            return None, None
        data_axis, model_axis = mesh.axis_names[0], mesh.axis_names[-1]
        n_data = mesh.shape[data_axis]
        n_model = mesh.shape[model_axis] if model_axis != data_axis else 1
        if batch_size % n_data:
            raise ValueError(f"Trainer.fit: batch_size {batch_size} does not "
                             f"divide by the data axis ({n_data})")
        if mesh.group is None:
            distinct = set(mesh.devices.ravel().tolist())
            if len(distinct) > 1:
                raise ValueError(
                    f"Trainer.fit: a one-process mesh over {len(distinct)} "
                    f"devices; training runs one process a card (torchrun "
                    f"--nproc_per_node=<cards>, then "
                    f"parallel.distributed.initialize() and global_mesh())")
            (only,) = distinct
            if only.type != self.device.type or (
                    only.index is not None and self.device.index is not None
                    and only.index != self.device.index):
                raise ValueError(f"Trainer.fit: the mesh is on {only}, the "
                                 f"trainer on {self.device}")
            return None, None
        if dist.get_world_size(mesh.group) != n_data:
            raise ValueError(f"Trainer.fit: a data axis of {n_data} over "
                             f"{dist.get_world_size(mesh.group)} processes; "
                             f"one device a rank")
        if n_model == 1:
            return mesh.group, None
        if mesh.model_group is None or \
                dist.get_world_size(mesh.model_group) != n_model:
            raise ValueError(f"Trainer.fit: a model axis of {n_model} needs "
                             f"its process group (global_mesh(n_model="
                             f"{n_model}))")
        return mesh.group, mesh.model_group

    def _split_parameters(self, mesh, group) -> None:
        """Keep only this rank's blocks of the split parameters' master
        weights and optimizer state (``_Blocks``); the optimizer is rebuilt
        over them once for a model group and kept across fits on it."""
        if self._blocks is not None and self._blocks.group is group:
            return
        if self._blocks is not None:
            raise ValueError("Trainer.fit: this trainer's optimizer holds "
                             "the blocks of another model axis")
        names = {id(p): n for n, p in self.model.named_parameters()}
        split = param_shardings(self.model, mesh)
        self._blocks = _Blocks(self._params,
                               [split[names[id(p)]] for p in self._params],
                               group)
        self.optimizer = self._tx(self._blocks.masters)

    def _shard_layers(self, group) -> None:
        """Point the model's BatchNorms and dropouts at ``group`` (None:
        back to one process)."""
        shard = None if group is None else \
            (dist.get_rank(group), dist.get_world_size(group))
        for m in self.model.modules():
            if isinstance(m, (KerasBatchNorm, KerasBatchNorm1d)):
                m.group = group
            elif isinstance(m, SeededDropout):
                m.shard = shard

    # -- public API -----------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, x, y, batch_size: Optional[int] = None
                 ) -> tuple[float, float]:
        """Loss (without the penalty) and accuracy in inference mode, over
        the whole split at once or in chunks of ``batch_size`` rows."""
        x, y = self._tensor(x), self._tensor(y)
        n = x.shape[0]
        step = batch_size if batch_size is not None and n > batch_size else n
        self.model.eval()
        loss = correct = 0.0
        with fp32_policy(False):
            for i in range(0, n, step):
                logits = self.model(x[i:i + step])
                loss = loss + torch.sum(self.loss_fn(logits, y[i:i + step]))
                correct = correct + torch.sum(_correct(logits, y[i:i + step]))
        denom = max(n, 1)
        return float(loss) / denom, float(correct) / denom

    def fit(self, x_train, y_train, *, epochs: int, batch_size: int,
            x_val=None, y_val=None,
            early_stop_patience: Optional[int] = None,
            lr_schedule_epoch: Optional[Callable[[int], float]] = None,
            permutations: Optional[Sequence] = None,
            mesh=None, verbose: bool = False) -> Dict[str, List[float]]:
        """Keras-flavoured fit; returns the history.  ``permutations[e]``,
        if given, orders epoch ``e``'s padded rows instead of the trainer's
        generator.

        ``mesh`` (``parallel.distributed.global_mesh()``): data-parallel
        across the processes of its group, one device a rank, and with a
        model axis over 1 (``global_mesh(n_model=k)``) the parameters and
        optimizer state split over it (see the module docstring);
        ``batch_size`` is global and must divide by the data axis.  ``x_train``/``y_train`` may be host-local
        ``ShardedBatch``es (``host_local_batch_to_global``)."""
        group, model_group = self._mesh_groups(mesh, batch_size)
        if model_group is None and self._blocks is not None:
            raise ValueError("Trainer.fit: this trainer's optimizer holds a "
                             "model axis's blocks; fit it on that mesh")
        x_train, y_train = (a.gather(self.device)
                            if isinstance(a, ShardedBatch) else a
                            for a in (x_train, y_train))
        x, y, mask = pad_to_batches(self._tensor(x_train),
                                    self._tensor(y_train), batch_size)
        if x_val is not None:
            x_val, y_val = self._tensor(x_val), self._tensor(y_val)
        with torch.no_grad():
            for g in (group, model_group):
                if g is not None:
                    src = dist.get_global_rank(g, 0)
                    for t in self.model.state_dict().values():
                        dist.broadcast(t, src=src, group=g)
        if model_group is not None:
            self._split_parameters(mesh, model_group)
        self._shard_layers(group)
        try:
            history: Dict[str, List[float]] = {"loss": [], "acc": [],
                                               "val_loss": [], "val_acc": []}
            best_val = np.inf
            patience_left = early_stop_patience
            for epoch in range(epochs):
                if lr_schedule_epoch is not None:
                    for pg in self.optimizer.param_groups:
                        pg["lr"] = float(lr_schedule_epoch(epoch))
                perm = permutations[epoch] if permutations is not None else \
                    torch.randperm(x.shape[0], generator=self.generator)
                loss, acc = self._run_epoch(x, y, mask, perm, batch_size, group)
                history["loss"].append(loss)
                history["acc"].append(acc)
                if x_val is None:
                    if verbose:
                        print(f"epoch {epoch}: loss={loss:.4f} acc={acc:.4f}")
                    continue
                vl, va = self.evaluate(x_val, y_val)
                history["val_loss"].append(vl)
                history["val_acc"].append(va)
                if verbose:
                    print(f"epoch {epoch}: loss={loss:.4f} acc={acc:.4f} "
                          f"val_loss={vl:.4f} val_acc={va:.4f}")
                if early_stop_patience is not None:
                    if vl < best_val:
                        best_val, patience_left = vl, early_stop_patience
                    else:
                        patience_left -= 1
                        if patience_left <= 0:
                            break
        finally:
            self._shard_layers(None)
        return history
