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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmla_audio_torch.models.layers import SeededDropout
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
        self.optimizer = tx([p for p in model.parameters()
                             if p.requires_grad])
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
                   mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on a batch; returns its (loss, accuracy) as
        device scalars."""
        self.model.train()
        with fp32_policy(False):
            logits = self.model(x)
            loss = masked_mean(self.loss_fn(logits, y), mask)
            if self.extra_penalty_fn is not None:
                loss = loss + self.extra_penalty_fn(self.model)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        return loss.detach(), masked_mean(_correct(logits.detach(), y), mask)

    def _run_epoch(self, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                   perm, batch_size: int) -> tuple[float, float]:
        """One epoch over the padded ``(x, y, mask)`` in the order ``perm``;
        returns the mean of the batches' losses and accuracies."""
        perm = torch.from_numpy(np.array(perm, np.int64)).to(self.device)
        stats = []
        for b in range(x.shape[0] // batch_size):
            idx = perm[b * batch_size:(b + 1) * batch_size]
            stats.append(torch.stack(self.train_step(x[idx], y[idx],
                                                     mask[idx])))
        loss, acc = torch.stack(stats).mean(0).tolist()
        return loss, acc

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
            verbose: bool = False) -> Dict[str, List[float]]:
        """Keras-flavoured fit; returns the history.  ``permutations[e]``,
        if given, orders epoch ``e``'s padded rows instead of the trainer's
        generator."""
        x, y, mask = pad_to_batches(self._tensor(x_train),
                                    self._tensor(y_train), batch_size)
        if x_val is not None:
            x_val, y_val = self._tensor(x_val), self._tensor(y_val)
        history: Dict[str, List[float]] = {"loss": [], "acc": [],
                                           "val_loss": [], "val_acc": []}
        best_val = np.inf
        patience_left = early_stop_patience
        for epoch in range(epochs):
            if lr_schedule_epoch is not None:
                for group in self.optimizer.param_groups:
                    group["lr"] = float(lr_schedule_epoch(epoch))
            perm = permutations[epoch] if permutations is not None else \
                torch.randperm(x.shape[0], generator=self.generator)
            loss, acc = self._run_epoch(x, y, mask, perm, batch_size)
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
        return history
