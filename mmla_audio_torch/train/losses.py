"""Losses and metrics with Keras semantics (counterpart of
``mmla_audio_tpu.train.losses``).

The reference trains in probability space: its models end in a softmax or a
sigmoid and use ``categorical_crossentropy`` (which renormalizes and clips)
or ``weighted_categorical_crossentropy``
(`overlap_features_generator.py:9-26`).  Each function here takes logits and
applies the activation itself.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["keras_categorical_crossentropy",
           "weighted_categorical_crossentropy", "categorical_accuracy",
           "cal_weighted_penalty"]

_EPSILON = 1e-7  # Keras backend epsilon


def _normalized_probs(logits: torch.Tensor, activation: str) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1) if activation == "softmax" \
        else torch.sigmoid(logits)
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return torch.clamp(probs, _EPSILON, 1.0 - _EPSILON)


def keras_categorical_crossentropy(logits: torch.Tensor, y_true: torch.Tensor,
                                   activation: str = "softmax"
                                   ) -> torch.Tensor:
    """Keras CCE on activated outputs: renormalize, clip to [1e-7, 1 -
    1e-7], ``-sum(y log p)`` per example.  ``activation="sigmoid"`` is the
    transfer head's (`speaker_identification.py:409`), whose outputs do not
    sum to 1, so the renormalization matters."""
    probs = _normalized_probs(logits, activation)
    return -torch.sum(y_true * torch.log(probs), dim=-1)


def weighted_categorical_crossentropy(logits: torch.Tensor,
                                      y_true: torch.Tensor, weights,
                                      activation: str = "softmax"
                                      ) -> torch.Tensor:
    """Per-class ``weights`` multiply the log-probability terms before the
    sum (overlap_features_generator.py:9-26)."""
    probs = _normalized_probs(logits, activation)
    w = torch.as_tensor(weights, dtype=probs.dtype, device=probs.device)
    return -torch.sum(y_true * torch.log(probs) * w, dim=-1)


def categorical_accuracy(logits: torch.Tensor,
                         y_true: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1)
                       == torch.argmax(y_true, dim=-1)).to(torch.float32))


def cal_weighted_penalty(y_onehot: np.ndarray) -> np.ndarray:
    """Class weights ``1 - count_c / total`` (overlap_detector.py:123-140)."""
    quantity = y_onehot.sum(axis=0).astype(np.float64)
    return 1.0 - quantity / quantity.sum()
