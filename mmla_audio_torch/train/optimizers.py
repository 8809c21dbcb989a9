"""Optimizers with Keras hyperparameters on ``torch.optim`` (counterpart of
``mmla_audio_tpu.train.optimizers``).

The reference uses Adadelta(lr=1e-3) for the overlap detector
(`overlap_detector.py:402`) and RMSprop(lr=1e-4 / 1e-6) for speaker training
(`speaker_identification.py:244, 414, 441`).  Keras defaults: Adadelta
rho=0.95 eps=1e-7; RMSprop rho=0.9 eps=1e-7, no momentum, uncentered;
torch's defaults differ (Adadelta 0.9 / 1e-6, RMSprop 0.99 / 1e-8).

Each function returns a factory, as an optax transformation is not yet
bound to parameters: ``rmsprop(1e-4)(params)`` is a fresh optimizer.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch

__all__ = ["adadelta", "rmsprop"]

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]],
                            torch.optim.Optimizer]


def adadelta(learning_rate: float = 1e-3, rho: float = 0.95,
             eps: float = 1e-7) -> OptimizerFactory:
    """Keras Adadelta: acc = rho acc + (1 - rho) g^2; delta = g sqrt(acc_delta
    + eps) / sqrt(acc + eps); acc_delta = rho acc_delta + (1 - rho) delta^2;
    p -= lr delta.  torch places eps inside both square roots, as Keras
    does."""
    return functools.partial(torch.optim.Adadelta, lr=learning_rate, rho=rho,
                             eps=eps)


def rmsprop(learning_rate: float = 1e-4, decay: float = 0.9,
            eps: float = 1e-7) -> OptimizerFactory:
    """Keras RMSprop (uncentered, no momentum): rms = rho rms + (1 - rho)
    g^2; p -= lr g / (sqrt(rms) + eps).  torch adds eps outside the square
    root, as Keras does."""
    return functools.partial(torch.optim.RMSprop, lr=learning_rate,
                             alpha=decay, eps=eps)
