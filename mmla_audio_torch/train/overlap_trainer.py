"""Overlap-detector training (counterpart of
``mmla_audio_tpu.train.overlap_trainer``; the reference's `OverlapDetector`
workflow).

Stratified 5-fold split (fold 0; its test split is also the validation set
for early stopping and best-val-accuracy checkpointing), class weights,
optional pyramid rebalancing of the minority class, weighted-CCE Adadelta
under an epoch-indexed cosine-annealed learning rate, one ``fit`` epoch at a
time; continue-training from a checkpoint; evaluation with a confusion
matrix (`overlap_detector.py:399-543`).

The corpus lives on the trainer's device: a tensor given there stays
there (the featurizer kernel's output is a permuted view, and gathers keep
its layout), numpy is uploaded once.  Training steps run the model in train
mode, so every residual block takes the unfused autograd path; evaluation
runs it in eval mode without autograd, so on the card each non-pooling
block is one launch of the fused kernel, chunk by chunk of
``eval_batch_size`` rows.  Randomness: the Keras init from ``seed``, each
epoch's permutation and the dropout masks from the ``Trainer``'s generators
(seeded ``seed + 1``, as the JAX package draws its permutations from
``PRNGKey(seed + 1)``); ``train`` and ``continue_train`` also take an
initial state_dict and the permutations themselves, so a caller can replay
another run.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mmla_audio_torch.core.config import OverlapModelConfig, OverlapTrainConfig
from mmla_audio_torch.models.overlap import OverlapResBLSTM
from mmla_audio_torch.models.layers import keras_init_
from mmla_audio_torch.ops.image import pyramid_augment
from mmla_audio_torch.precision import fp32_policy
from mmla_audio_torch.train.checkpoints import BestCheckpointer, load_variables
from mmla_audio_torch.train.losses import (cal_weighted_penalty,
                                           keras_categorical_crossentropy,
                                           weighted_categorical_crossentropy)
from mmla_audio_torch.train.optimizers import adadelta
from mmla_audio_torch.train.schedules import cosine_annealing
from mmla_audio_torch.train.trainer import Trainer
from mmla_audio_torch.train.transfer import train_val_split

__all__ = ["stratified_kfold_indices", "augment_to_balance",
           "confusion_matrix", "OverlapTrainer"]


def stratified_kfold_indices(labels: np.ndarray, n_splits: int = 5,
                             seed: int = 0, fold: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn ``StratifiedKFold(shuffle=True, random_state=seed)``'s
    ``_make_test_folds``, transcribed, so fold membership is the
    reference's split (`overlap_detector.py:274-275`): classes encoded by
    first appearance, each fold's allocation from the sorted label vector
    taken every ``n_splits``-th, each class's fold vector shuffled with the
    shared RandomState in encoded-class order."""
    rng = np.random.RandomState(seed)
    y = np.asarray(labels)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes)
         for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype=np.int32)
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    test_mask = test_folds == fold
    return np.where(~test_mask)[0], np.where(test_mask)[0]


def augment_to_balance(x, y_onehot):
    """Class rebalancing by the pyramid ladder (`augment_images`,
    overlap_detector.py:142-225): each minority class is copied ``round(
    max_count / count - 1)`` times, copy i blurred through i + 1 pyrDown/
    pyrUp rounds.  Returns the originals followed by the copies, and their
    one-hot labels (numpy).

    A tensor stays on its device (the ladder runs there and the originals
    are not copied back); numpy in gives numpy out, only the minority rows
    going through the float32 ladder.  Balanced classes (every ratio 0, the
    reference's 6,300 + 6,300 corpus) come back untouched."""
    y_np = np.asarray(y_onehot)
    counts = y_np.sum(axis=0)
    base = counts.max()
    plans = []                  # (class indices, pyramid rounds)
    for c in range(y_np.shape[1]):
        if counts[c] == 0:
            continue
        ratio = int(round(base / counts[c] - 1))
        cls = np.where(y_np[:, c] == 1)[0]
        for i in range(ratio):
            plans.append((cls, i + 1))
    if not plans:
        return x, y_onehot
    ys = np.concatenate([y_np] + [y_np[cls] for cls, _ in plans])
    if isinstance(x, torch.Tensor):
        xs = [x] + [pyramid_augment(x[torch.from_numpy(cls).to(x.device)],
                                    rounds).to(x.dtype)
                    for cls, rounds in plans]
        return torch.cat(xs), ys
    aug = [pyramid_augment(torch.from_numpy(
               np.ascontiguousarray(x[cls], np.float32)), rounds).numpy()
           .astype(x.dtype) for cls, rounds in plans]
    return np.concatenate([x] + aug), ys.astype(y_onehot.dtype)


def confusion_matrix(y_true_idx: np.ndarray, y_pred_idx: np.ndarray,
                     n_classes: int) -> np.ndarray:
    m = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(m, (np.asarray(y_true_idx), np.asarray(y_pred_idx)), 1)
    return m


class OverlapTrainer:
    """``train`` / ``continue_train`` / ``evaluation`` on ``device``.  After
    ``train``, ``report`` holds each epoch's host-clock seconds of the
    ``fit`` epoch and of the validation (each ends synchronized)."""

    def __init__(self, model_cfg: OverlapModelConfig = OverlapModelConfig(),
                 train_cfg: OverlapTrainConfig = OverlapTrainConfig(),
                 device: torch.device | str = "cuda"):
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = torch.device(device)
        self.report: Dict[str, Any] = {}
        self.trainer: Optional[Trainer] = None

    def _schedule(self):
        return cosine_annealing(self.cfg.cosine_t_max, self.cfg.cosine_eta_max,
                                self.cfg.cosine_eta_min)

    def _make_trainer(self, weights: Optional[np.ndarray], seed: int,
                      init: Optional[Mapping[str, torch.Tensor]]) -> Trainer:
        """A ``Trainer`` of a fresh model: Keras init from ``seed``, or
        ``init``; Adadelta at ``cfg.lr``; weighted CCE if ``weights``."""
        model = OverlapResBLSTM(self.model_cfg)
        if init is None:
            keras_init_(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(init)
        if weights is not None:
            w = np.asarray(weights, np.float32)

            def loss_fn(logits, y):
                return weighted_categorical_crossentropy(logits, y, w)
        else:
            loss_fn = keras_categorical_crossentropy
        return Trainer(model, adadelta(self.cfg.lr), loss_fn,
                       device=self.device, seed=seed + 1)

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    def _rows(self, x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        return x[torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)]

    def train(self, x, y_onehot, *, weighted: bool = True,
              augmented: bool = False, epochs: Optional[int] = None,
              batch_size: Optional[int] = None, checkpoint_dir=None,
              seed: int = 0, verbose: bool = False,
              init: Optional[Mapping[str, torch.Tensor]] = None,
              permutations: Optional[Sequence] = None):
        """The reference's train_model.  Returns ``(state_dict on the CPU,
        history, (x_test on the device, y_test))``.  ``permutations[e]``
        orders epoch ``e``'s padded training rows."""
        y_np = np.asarray(y_onehot, np.float32)
        train_idx, test_idx = stratified_kfold_indices(y_np.argmax(1), 5,
                                                       seed=0)
        x = self._on_device(x)
        x_train, y_train = self._rows(x, train_idx), y_np[train_idx]
        x_test, y_test = self._rows(x, test_idx), y_np[test_idx]
        if augmented:
            x_train, y_train = augment_to_balance(x_train, y_train)
        weights = cal_weighted_penalty(y_train) if weighted else None
        trainer = self._make_trainer(weights, seed, init)
        ckpt = BestCheckpointer(checkpoint_dir, self.model_cfg) \
            if checkpoint_dir else None
        sched = self._schedule()
        history: Dict[str, list] = {"loss": [], "acc": [], "val_loss": [],
                                    "val_acc": []}
        self.report = {"epoch_s": [], "val_s": []}
        best_val = np.inf
        patience = self.cfg.early_stop_patience
        n_epochs = self.cfg.epochs if epochs is None else epochs
        bsz = self.cfg.batch_size if batch_size is None else batch_size
        for epoch in range(n_epochs):
            t0 = time.perf_counter()
            h = trainer.fit(x_train, y_train, epochs=1, batch_size=bsz,
                            lr_schedule_epoch=lambda _: sched(epoch),
                            permutations=None if permutations is None
                            else [permutations[epoch]])
            t1 = time.perf_counter()
            vl, va = trainer.evaluate(x_test, y_test,
                                      batch_size=self.cfg.eval_batch_size)
            self.report["epoch_s"].append(t1 - t0)
            self.report["val_s"].append(time.perf_counter() - t1)
            history["loss"].append(h["loss"][0])
            history["acc"].append(h["acc"][0])
            history["val_loss"].append(vl)
            history["val_acc"].append(va)
            if verbose:
                print(f"epoch {epoch}: loss={h['loss'][0]:.4f} "
                      f"val_acc={va:.4f}")
            if ckpt is not None:
                ckpt.update(va, trainer.model.state_dict(),
                            {"epoch": epoch, "val_loss": vl})
            if vl < best_val:
                best_val, patience = vl, self.cfg.early_stop_patience
            else:
                patience -= 1
                if patience <= 0:
                    break
        self.trainer = trainer
        return trainer.variables_of(), history, (x_test, y_test)

    def continue_train(self, checkpoint_dir, x, y_onehot, *,
                       weighted: bool = True, epochs: int = 10,
                       batch_size: Optional[int] = None, seed: int = 0,
                       permutations: Optional[Sequence] = None):
        """The reference's continue_train_model (`overlap_detector.py:
        480-511`): the checkpoint's variables trained on with the same
        callbacks as ``train`` (early stopping on the validation loss, the
        cosine lr), validating on an 80/20 stratified split of the data
        (``train_val_split(..., 0.2, seed=0)``).  Returns ``(state_dict on
        the CPU, history)``."""
        y_np = np.asarray(y_onehot, np.float32)
        weights = cal_weighted_penalty(y_np) if weighted else None
        state_dict, _ = load_variables(checkpoint_dir, self.model_cfg)
        trainer = self._make_trainer(weights, seed, state_dict)
        x = self._on_device(x)
        idx_tr, y_tr, idx_val, y_val = train_val_split(
            np.arange(len(y_np)), y_np, val_ratio=0.2, seed=0)
        history = trainer.fit(
            self._rows(x, idx_tr), y_tr, epochs=epochs,
            batch_size=self.cfg.batch_size if batch_size is None
            else batch_size,
            x_val=self._rows(x, idx_val), y_val=y_val,
            early_stop_patience=self.cfg.early_stop_patience,
            lr_schedule_epoch=self._schedule(), permutations=permutations)
        self.trainer = trainer
        return trainer.variables_of(), history

    @torch.no_grad()
    def evaluation(self, state_dict: Mapping[str, torch.Tensor], x,
                   y_onehot) -> Dict[str, np.ndarray | float]:
        """Confusion matrix, recall, precision and accuracy (`evaluation`,
        :513-543), predicting in chunks of ``eval_batch_size`` rows; the
        ragged tail is zero-padded to a chunk when the split is larger than
        one."""
        model = OverlapResBLSTM(self.model_cfg)
        model.load_state_dict(state_dict)
        model = model.to(self.device).eval()
        x = self._on_device(x)
        n, chunk = x.shape[0], self.cfg.eval_batch_size
        preds = []
        with fp32_policy(False):
            for i in range(0, n, chunk):
                bx = x[i:i + chunk]
                n_i = bx.shape[0]
                if n_i < chunk and n > chunk:
                    bx = torch.cat([bx, bx.new_zeros(
                        (chunk - n_i,) + tuple(bx.shape[1:]))])
                preds.append(torch.argmax(model(bx), -1)[:n_i])
        pred = torch.cat(preds).cpu().numpy() if preds else \
            np.zeros(0, np.int64)
        y_np = np.asarray(y_onehot)
        true = np.argmax(y_np, axis=1)
        cm = confusion_matrix(true, pred, y_np.shape[1])
        with np.errstate(invalid="ignore", divide="ignore"):
            recall = np.diag(cm) / cm.sum(axis=1)
            precision = np.diag(cm) / cm.sum(axis=0)
        return {"confusion": cm, "recall": recall, "precision": precision,
                "accuracy": float((pred == true).mean())}
