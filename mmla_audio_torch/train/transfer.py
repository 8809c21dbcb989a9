"""Speaker registration by transfer learning (counterpart of
``mmla_audio_tpu.train.transfer``).

Reference flow (`speaker_identification.py:401-503`,
`record_on_pc.py:340-346`): slice the base model at ``layers[-2]`` (the
post-BiLSTM dropout), freeze it, add a fresh ``Dense(n_speakers,
sigmoid)`` head and fit 500 epochs (b16, RMSprop 1e-4) on the enrolled
corpus's MFCC windows; then unfreeze everything and fit 20 more (b8,
RMSprop 1e-6), each phase with a fresh optimizer; retrain from scratch
until the validation accuracy reaches 0.80, at most 5 rounds.

As in the reference, the trunk runs in inference mode in both phases
(BatchNorm on its running statistics, dropout off; ``transfer_mode_``), the
loss is Keras CCE on the sigmoid head plus the trunk's l2 penalty, and the
training split is zero-padded to a multiple of both batch sizes, the
padding masked out of the loss.

Phase 1 on the card: the frozen trunk in inference mode is a fixed
function, so its ``(N, 512)`` embeddings of the training split are the
same in every one of its ~1,500 steps.  They are computed once, and the
phase runs as head-only steps on them, the trunk's constant penalty added
to the reported loss.  The JAX package re-runs the trunk in every step; the
result is the same function of the same inputs.  The corpus stays on the
device through both phases; each step is a plain Python loop (an epoch as a
CUDA graph is later work).

Randomness: the head's initial kernel (glorot uniform) and every epoch's
permutation come from CPU generators seeded by ``seed`` and ``seed + 1``,
so the card and the CPU start from the same head and see the same order.
``fit_once`` also takes both, so a caller can replay another run's.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mmla_audio_torch.core.config import SpeakerModelConfig, TransferConfig
from mmla_audio_torch.models.layers import keras_init_, transfer_mode_
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.precision import fp32_policy
from mmla_audio_torch.train.losses import keras_categorical_crossentropy
from mmla_audio_torch.train.optimizers import rmsprop
from mmla_audio_torch.train.trainer import masked_mean

__all__ = ["TransferLearner", "train_val_split"]


def train_val_split(x: np.ndarray, y: np.ndarray, val_ratio: float, seed: int):
    """Per-class proportional split (sklearn stratified semantics)."""
    rng = np.random.RandomState(seed)
    classes = np.argmax(y, axis=1)
    train_idx, val_idx = [], []
    for c in np.unique(classes):
        idx = np.where(classes == c)[0]
        rng.shuffle(idx)
        if len(idx) == 1:
            # too few windows to split: the lone window serves both sides
            # (the reference's sklearn split would simply error here)
            train_idx.extend(idx)
            val_idx.extend(idx)
            continue
        n_val = min(max(1, int(round(len(idx) * val_ratio))), len(idx) - 1)
        val_idx.extend(idx[:n_val])
        train_idx.extend(idx[n_val:])
    train_idx = np.array(train_idx, dtype=np.int64)
    val_idx = np.array(val_idx, dtype=np.int64)
    rng.shuffle(train_idx)
    rng.shuffle(val_idx)
    return x[train_idx], y[train_idx], x[val_idx], y[val_idx]


def _sigmoid_cce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return keras_categorical_crossentropy(logits, y, activation="sigmoid")


class TransferLearner:
    """``base_state_dict``: a ``SpeakerResBLSTM`` state_dict (any head; only
    its ``trunk.*`` entries are read).  After each ``fit_once``,
    ``report`` holds the split and step counts, the phases' host-clock
    seconds (synchronized), on the card the mean phase-2 step time from
    CUDA events, and the validation loss and logits."""

    def __init__(self, base_state_dict: Mapping[str, torch.Tensor],
                 n_speakers: int,
                 model_cfg: SpeakerModelConfig = SpeakerModelConfig(),
                 cfg: TransferConfig = TransferConfig(),
                 device: torch.device | str = "cuda",
                 matmul_precision: str | None = "highest"):
        if matmul_precision not in (None, "highest"):
            raise ValueError(f"matmul_precision must be 'highest' or None: "
                             f"{matmul_precision!r}")
        self.trunk_state = {k[len("trunk."):]: v
                            for k, v in base_state_dict.items()
                            if k.startswith("trunk.")}
        self.n_speakers = n_speakers
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        self.allow_tf32 = matmul_precision is None
        self.report: Dict[str, Any] = {}

    # -- model pieces ---------------------------------------------------------
    def init_model(self, seed: int,
                   head: Optional[Mapping[str, Any]] = None
                   ) -> SpeakerResBLSTM:
        """The base trunk under a fresh head on the device, in transfer
        mode: the head glorot uniform from ``seed`` with zero bias, or
        ``head`` (``{"weight": (n, 512), "bias": (n,)}``)."""
        model = SpeakerResBLSTM(self.model_cfg, self.n_speakers)
        model.trunk.load_state_dict(self.trunk_state)
        if head is None:
            keras_init_(model.head, torch.Generator().manual_seed(seed))
        else:
            model.head.load_state_dict(
                {k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in head.items()})
        return transfer_mode_(model.to(self.device))

    def _permutations(self, seed: int, n: int, n1: int, n2: int):
        g = torch.Generator().manual_seed(seed + 1)
        perms = [torch.randperm(n, generator=g) for _ in range(n1 + n2)]
        return perms[:n1], perms[n1:]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the two phases -------------------------------------------------------
    def _phase1(self, model, x, y, mask, perms, batch: int) -> list:
        """Head-only steps on the frozen trunk's embeddings; the epochs'
        mean losses (device scalars), the trunk's penalty included."""
        with torch.no_grad():
            emb = model.trunk(x)
            penalty = l2_penalty(model, self.model_cfg)
        opt = rmsprop(self.cfg.phase1_lr)(model.head.parameters())
        losses = []
        for perm in perms:
            steps = []
            for idx in perm.split(batch):
                loss = masked_mean(_sigmoid_cce(model.head(emb[idx]), y[idx]),
                                   mask[idx])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                steps.append(loss.detach() + penalty)
            losses.append(torch.stack(steps).mean())
        return losses

    def _phase2(self, model, x, y, mask, perms, batch: int) -> list:
        """Steps of every parameter that requires a gradient, the trunk's
        penalty in the loss; the epochs' mean losses."""
        opt = rmsprop(self.cfg.phase2_lr)(
            [p for p in model.parameters() if p.requires_grad])
        losses = []
        for perm in perms:
            steps = []
            for idx in perm.split(batch):
                loss = masked_mean(_sigmoid_cce(model(x[idx]), y[idx]),
                                   mask[idx]) + l2_penalty(model,
                                                           self.model_cfg)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                steps.append(loss.detach())
            losses.append(torch.stack(steps).mean())
        return losses

    # -- public ---------------------------------------------------------------
    def fit_once(self, x: np.ndarray, y: np.ndarray, seed: int = 0,
                 epochs_override: Tuple[int, int] | None = None,
                 head: Optional[Mapping[str, Any]] = None,
                 permutations: Optional[Tuple[Sequence, Sequence]] = None):
        """One two-phase fine-tune.  Returns ``(state_dict on the CPU,
        val_acc, per-epoch losses of both phases)``.  ``permutations``: the
        two phases' per-epoch orders of the padded training split."""
        cfg = self.cfg
        n1, n2 = epochs_override or (cfg.phase1_epochs, cfg.phase2_epochs)
        x_tr, y_tr, x_val, y_val = train_val_split(
            np.asarray(x, np.float32), np.asarray(y, np.float32), 0.3, seed)
        n = x_tr.shape[0]
        lcm = math.lcm(cfg.phase1_batch, cfg.phase2_batch)
        total = max(lcm, -(-n // lcm) * lcm)
        dev = self.device
        pad = np.zeros((total - n,) + x_tr.shape[1:], np.float32)
        xt = torch.from_numpy(np.concatenate([x_tr, pad])).to(dev)
        yt = torch.from_numpy(np.concatenate(
            [y_tr, np.zeros((total - n, y_tr.shape[1]), np.float32)])).to(dev)
        mask = (torch.arange(total, device=dev) < n).to(torch.float32)
        perms1, perms2 = permutations or self._permutations(seed, total,
                                                            n1, n2)
        perms1, perms2 = ([torch.from_numpy(np.array(p, np.int64)).to(dev)
                           for p in ps] for ps in (perms1, perms2))
        model = self.init_model(seed, head)
        with fp32_policy(self.allow_tf32):
            t0 = time.perf_counter()
            losses = self._phase1(model, xt, yt, mask, perms1,
                                  cfg.phase1_batch)
            self._sync()
            t1 = time.perf_counter()
            if dev.type == "cuda":
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            losses += self._phase2(model, xt, yt, mask, perms2,
                                   cfg.phase2_batch)
            if dev.type == "cuda":
                events[1].record()
            self._sync()
            t2 = time.perf_counter()
            with torch.no_grad():
                logits = model(torch.from_numpy(x_val).to(dev))
        yv = torch.from_numpy(y_val).to(dev)
        val_loss = float(torch.mean(_sigmoid_cce(logits, yv)))
        val_acc = float(torch.mean((torch.argmax(logits, -1)
                                    == torch.argmax(yv, -1)).float()))
        steps2 = n2 * (total // cfg.phase2_batch)
        self.report = dict(
            n_train=n, n_val=int(x_val.shape[0]), n_padded=total,
            phase1_steps=n1 * (total // cfg.phase1_batch),
            phase2_steps=steps2, phase1_s=t1 - t0, phase2_s=t2 - t1,
            phase2_step_ms=(events[0].elapsed_time(events[1]) / steps2
                            if dev.type == "cuda" and steps2 else None),
            val_loss=val_loss, val_logits=logits.cpu().numpy())
        state_dict = {k: v.detach().to("cpu", copy=True)
                      for k, v in model.state_dict().items()}
        return state_dict, val_acc, torch.stack(losses).cpu().numpy() \
            if losses else np.zeros(0, np.float32)

    def fit_until_gate(self, x, y, seed: int = 0,
                       epochs_override: Tuple[int, int] | None = None):
        """Retrain from scratch (seed + round) until the validation accuracy
        reaches the gate, at most ``max_retrain_rounds`` times; returns the
        first round that reaches it, else the best (record_on_pc.py:344-346).
        ``report["rounds"]`` counts the rounds run."""
        best = None
        for round_ in range(self.cfg.max_retrain_rounds):
            result = self.fit_once(x, y, seed=seed + round_,
                                   epochs_override=epochs_override)
            self.report["rounds"] = round_ + 1
            if best is None or result[1] > best[1]:
                best = result
            if result[1] >= self.cfg.accuracy_gate:
                return result
        return best
