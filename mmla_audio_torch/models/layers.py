"""Shared model building blocks (counterpart of ``mmla_audio_tpu.models.layers``).

Keras semantics carried over: LeakyReLU alpha 0.3; BatchNorm eps 1e-3 and
Keras momentum 0.99 (torch's ``momentum`` is its complement, 0.01); LSTM gate
order i, f, c, o, which is torch's i, f, g, o, with sigmoid recurrent
activation and tanh activation.  Keras' single LSTM ``bias`` maps to
``bias_ih`` with ``bias_hh`` zero (``params.py``).

Training keeps the JAX package's numerics where torch's differ:

* a train-mode BatchNorm normalizes with the batch's biased variance
  ``E[x^2] - E[x]^2`` and moves its running variance toward that same
  biased value (torch's own BatchNorm moves it toward the unbiased one,
  n/(n-1) larger);
* ``bias_hh`` stays zero and out of every optimizer: if both torch biases
  trained, each would get the full gradient and their sum, the Keras bias,
  would move twice per step;
* ``SeededDropout`` draws its mask from an explicit generator.

Data-parallel training across processes (``Trainer.fit(mesh=)``) sets two
attributes for the length of the fit: a BatchNorm's ``group`` makes its
train-mode statistics those of the global batch (``Σx``, ``Σx²`` and the
count all-reduced through autograd), and a dropout's ``shard = (rank,
world)`` makes it draw the global batch's mask and keep its own rows, so
the fit equals the one-process fit of the whole batch.  A group of one
process (a data axis of 1, as on a (1, k) tensor-parallel mesh) computes
both as the one-process fit does, so that fit is the same bits.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["leaky_relu", "KerasBatchNorm", "KerasBatchNorm1d", "BiLSTM",
           "SeededDropout", "transfer_mode_", "keras_init_"]


def leaky_relu(x: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """Keras LeakyReLU default alpha=0.3."""
    return torch.where(x >= 0, x, alpha * x)


def _train_batch_norm(bn: nn.modules.batchnorm._BatchNorm,
                      x: torch.Tensor) -> torch.Tensor:
    """The JAX package's train-mode BatchNorm over the channel axis 1 of
    ``x``: mean and variance ``E[x^2] - E[x]^2`` (clipped at 0) over every
    other axis, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and
    ``running = m * running + (1 - m) * batch`` for both statistics."""
    dims = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    # a group of one holds the whole batch: its statistics are the local
    # ones, computed as the one-process fit computes them
    if bn.group is None or dist.get_world_size(bn.group) == 1:
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    else:
        mean, var = _global_moments(x, dims, bn.group)
    with torch.no_grad():
        m = bn.keras_momentum
        bn.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        bn.running_var.mul_(m).add_(var, alpha=1.0 - m)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.reshape(shape)) * mul.reshape(shape) + \
        bn.bias.reshape(shape)


def _global_moments(x: torch.Tensor, dims, group) -> tuple:
    """Mean and biased variance over ``dims`` of the batch every rank of
    ``group`` holds a block of: one autograd-aware all-reduce of ``(Σx,
    Σx², count)``, whose backward all-reduces the gradient, so each rank's
    rows get the gradient through the global statistics."""
    import warnings

    from torch.distributed.nn.functional import all_reduce

    C = x.shape[1]
    count = x.new_full((1,), x.numel() // C)
    local = torch.cat([x.sum(dims), (x * x).sum(dims), count])
    with warnings.catch_warnings():
        # deprecated for _functional_collectives.all_reduce, which has no
        # backward
        warnings.simplefilter("ignore", FutureWarning)
        total = all_reduce(local, op=dist.ReduceOp.SUM, group=group)
    n = total[2 * C]
    mean = total[:C] / n
    var = torch.clamp(total[C:2 * C] / n - mean * mean, min=0.0)
    return mean, var


class KerasBatchNorm(nn.BatchNorm2d):
    """BatchNorm over the channel axis of NCHW input, Keras defaults; train
    mode as the JAX package's (``_train_batch_norm``)."""

    group = None            # a process group: global-batch statistics

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.keras_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _train_batch_norm(self, x)
        return super().forward(x)


class KerasBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the channel axis of ``(B, C, T)`` input, Keras
    defaults; train mode as the JAX package's (``_train_batch_norm``)."""

    group = None            # a process group: global-batch statistics

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.keras_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _train_batch_norm(self, x)
        return super().forward(x)


class BiLSTM(nn.Module):
    """Keras ``Bidirectional(LSTM(units))``, merge_mode='concat', over
    ``x (B, T, C)`` -> ``(B, 2 * units)``: the forward direction's state at
    t=T-1 followed by the backward direction's state at t=0 (Keras
    ``go_backwards``)."""

    def __init__(self, input_size: int, units: int):
        super().__init__()
        self.lstm = nn.LSTM(input_size, units, batch_first=True,
                            bidirectional=True)
        for sfx in ("", "_reverse"):         # Keras has one bias: bias_ih
            getattr(self.lstm, f"bias_hh_l0{sfx}").requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, (h_n, _) = self.lstm(x)                  # h_n (2, B, H)
        return torch.cat([h_n[0], h_n[1]], dim=-1)


class SeededDropout(nn.Dropout):
    """Dropout whose train-mode keep mask is drawn from ``generator`` (a
    ``torch.Generator`` on the input's device, set by the trainer), scaled
    by 1 / keep as the JAX package's; without a generator it is
    ``nn.Dropout``.  With ``shard = (rank, world)`` the mask is drawn for
    the ``world`` blocks of the global batch and this rank's block kept."""

    generator: torch.Generator | None = None
    shard: tuple | None = None      # (rank, world): keep a global mask's rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0 or self.generator is None:
            return super().forward(x)
        if self.shard is None or self.shard[1] == 1:
            keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                                  generator=self.generator)
        else:
            rank, world = self.shard
            B = x.shape[0]
            keep = x.new_empty((world * B,) + tuple(x.shape[1:])).bernoulli_(
                1.0 - self.p, generator=self.generator)[rank * B:(rank + 1) * B]
        return x * keep / (1.0 - self.p)


def transfer_mode_(model: nn.Module) -> nn.Module:
    """In place: every module in inference mode (BatchNorm on its running
    statistics, dropout off) except each ``nn.LSTM``, which stays in train
    mode.  This is the JAX package's ``train=False`` forward with gradients
    flowing through it: cuDNN computes an RNN's backward only in train mode,
    and a one-layer LSTM without inter-layer dropout gives the same output
    in either mode."""
    model.eval()
    for m in model.modules():
        if isinstance(m, nn.LSTM):
            m.train()
    return model


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
