"""Shared model building blocks (counterpart of ``mmla_audio_tpu.models.layers``).

Keras semantics carried over: LeakyReLU alpha 0.3; BatchNorm eps 1e-3 and
Keras momentum 0.99 (torch's ``momentum`` is its complement, 0.01); LSTM gate
order i, f, c, o, which is torch's i, f, g, o, with sigmoid recurrent
activation and tanh activation.  Keras' single LSTM ``bias`` maps to
``bias_ih`` with ``bias_hh`` zero (``params.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["leaky_relu", "KerasBatchNorm", "KerasBatchNorm1d", "BiLSTM",
           "keras_init_"]


def leaky_relu(x: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """Keras LeakyReLU default alpha=0.3."""
    return torch.where(x >= 0, x, alpha * x)


class KerasBatchNorm(nn.BatchNorm2d):
    """BatchNorm over the channel axis of NCHW input, Keras defaults."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)


class KerasBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the channel axis of ``(B, C, T)`` input, Keras
    defaults."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)


class BiLSTM(nn.Module):
    """Keras ``Bidirectional(LSTM(units))``, merge_mode='concat', over
    ``x (B, T, C)`` -> ``(B, 2 * units)``: the forward direction's state at
    t=T-1 followed by the backward direction's state at t=0 (Keras
    ``go_backwards``)."""

    def __init__(self, input_size: int, units: int):
        super().__init__()
        self.lstm = nn.LSTM(input_size, units, batch_first=True,
                            bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, (h_n, _) = self.lstm(x)                  # h_n (2, B, H)
        return torch.cat([h_n[0], h_n[1]], dim=-1)


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(w, -limit, limit, generator=generator)


@torch.no_grad()
def keras_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize in place with the JAX models' initializers: glorot
    uniform conv/dense/LSTM-input kernels, orthogonal recurrent kernels,
    zero biases except the LSTM forget slice (1), BatchNorm at identity."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            rf = m.weight[0, 0].numel() if m.weight.ndim > 2 else 1
            _glorot_uniform_(m.weight, m.weight.shape[1] * rf,
                             m.weight.shape[0] * rf, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (KerasBatchNorm, KerasBatchNorm1d)):
            m.reset_parameters()
        elif isinstance(m, nn.LSTM):
            H = m.hidden_size
            for sfx in ("", "_reverse"):
                w_ih = getattr(m, f"weight_ih_l0{sfx}")       # (4H, C)
                _glorot_uniform_(w_ih, w_ih.shape[1], 4 * H, generator)
                # Keras orthogonalizes the (H, 4H) kernel; torch holds its
                # transpose
                w_hh = getattr(m, f"weight_hh_l0{sfx}")
                q = torch.empty(H, 4 * H, dtype=w_hh.dtype)
                nn.init.orthogonal_(q, generator=generator)
                w_hh.copy_(q.T)
                b_ih = getattr(m, f"bias_ih_l0{sfx}")
                b_ih.zero_()
                b_ih[H: 2 * H] = 1.0
                getattr(m, f"bias_hh_l0{sfx}").zero_()
    return model
