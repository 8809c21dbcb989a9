"""Speaker identifier: 1-D ResNet -> AvgPool -> BiLSTM -> Dense
(counterpart of ``mmla_audio_tpu.models.speaker``).

Conv1D(32, k4) stem; 3 stages x 3 ``ResUnit1D`` (32/64/128 filters; the
first unit of a stage max-pools its main path and projects the shortcut
with a strided 1x1); BN + ReLU + Dropout 0.25; AveragePooling1D(4, valid);
BiLSTM(256); Dropout 0.2; Dense(630), or the enrollment corpus's head
(``head_units``, sigmoid at the caller).  Input ``(B, 256, 39)`` as in JAX,
internally ``(B, C, T)``.  Geometry: 256 -> 128 -> 64 -> 32 frames ->
AvgPool(4) -> (B, 8, 128) -> BiLSTM -> (B, 512) -> logits.

Padding as the JAX model's ``SAME``: the k4 stem pads 1 before and 2
after; the 2-wide stride-2 max-pool pads an odd length with -inf after; a
strided 1x1 needs none.  The Keras l2 of the inner convs is part of the
training loss, ``l2_penalty``, not weight decay.  Convolutions and the LSTM
are cuDNN on the card: the JAX model runs them outside any Pallas kernel,
so there is no kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmla_audio_torch.core.config import SpeakerModelConfig
from mmla_audio_torch.models.layers import (BiLSTM, KerasBatchNorm1d,
                                            SeededDropout)

__all__ = ["ResUnit1D", "SpeakerTrunk", "SpeakerResBLSTM", "l2_penalty"]


class ResUnit1D(nn.Module):
    """res_unit (speaker_identification.py:168-190).  Unlike the 2-D block,
    a pooling unit max-pools the main path's input before its first
    BatchNorm, and its shortcut is a strided 1x1 of the unpooled input."""

    def __init__(self, in_channels: int, filters: int, pool: bool = False,
                 bn_momentum: float = 0.99, bn_eps: float = 1e-3):
        super().__init__()
        self.pool = pool
        self.shortcut = nn.Conv1d(in_channels, filters, 1, stride=2) \
            if pool else None
        self.bn0 = KerasBatchNorm1d(in_channels, bn_momentum, bn_eps)
        self.conv_a = nn.Conv1d(in_channels, filters, 3, padding=1)
        self.bn1 = KerasBatchNorm1d(filters, bn_momentum, bn_eps)
        self.conv_b = nn.Conv1d(filters, filters, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        if self.pool:
            res = self.shortcut(x)
            x = F.max_pool1d(F.pad(x, (0, x.shape[-1] % 2),
                                   value=float("-inf")), 2, 2)
        out = self.conv_a(F.relu(self.bn0(x)))
        out = self.conv_b(F.relu(self.bn1(out)))
        return res + out


class SpeakerTrunk(nn.Module):
    """Everything up to the post-BiLSTM dropout: the ``layers[-2]`` slice
    point of the reference's transfer learner."""

    def __init__(self, cfg: SpeakerModelConfig = SpeakerModelConfig(),
                 feat_dim: int = 39):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Conv1d(feat_dim, cfg.stem_filters, cfg.stem_kernel)
        units, ch = [], cfg.stem_filters
        for f in cfg.stage_filters:
            for block in range(cfg.blocks_per_stage):
                units.append(ResUnit1D(ch, f, pool=block == 0,
                                       bn_momentum=cfg.bn_momentum,
                                       bn_eps=cfg.bn_eps))
                ch = f
        self.units = nn.Sequential(*units)
        self.bn = KerasBatchNorm1d(ch, cfg.bn_momentum, cfg.bn_eps)
        self.dropout_trunk = SeededDropout(cfg.dropout_trunk)
        self.bilstm = BiLSTM(ch, cfg.lstm_units)
        self.dropout_head = SeededDropout(cfg.dropout_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x (B, T, feat_dim)`` -> ``(B, 2 * lstm_units)``."""
        k = self.cfg.stem_kernel
        net = self.stem(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)))
        net = self.dropout_trunk(F.relu(self.bn(self.units(net))))
        net = F.avg_pool1d(net, self.cfg.avg_pool)         # VALID: floor
        return self.dropout_head(self.bilstm(net.transpose(1, 2)))


class SpeakerResBLSTM(nn.Module):
    """Trunk + Dense head of ``head_units`` (None: ``cfg.num_speakers``)
    -> logits."""

    def __init__(self, cfg: SpeakerModelConfig = SpeakerModelConfig(),
                 head_units: int | None = None, feat_dim: int = 39):
        super().__init__()
        self.cfg = cfg
        self.trunk = SpeakerTrunk(cfg, feat_dim)
        self.head = nn.Linear(2 * cfg.lstm_units,
                              head_units or cfg.num_speakers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x (B, T, feat_dim)`` MFCC-39 rows -> logits ``(B, units)``."""
        return self.head(self.trunk(x))


def l2_penalty(model: SpeakerResBLSTM,
               cfg: SpeakerModelConfig = SpeakerModelConfig()) -> torch.Tensor:
    """The Keras kernel regularizers as a loss term: the sum of ``coeff *
    sum(kernel ** 2)`` over ``conv_a`` and ``conv_b`` of the units of every
    stage whose ``stage_l2`` coefficient is positive, the first (pooling)
    unit of each stage excepted (speaker_identification.py:176-187)."""
    units = model.trunk.units
    total = torch.zeros((), device=model.head.weight.device)
    for stage, coeff in enumerate(cfg.stage_l2):
        if coeff <= 0:
            continue
        for block in range(1, cfg.blocks_per_stage):
            unit = units[stage * cfg.blocks_per_stage + block]
            for conv in (unit.conv_a, unit.conv_b):
                total = total + coeff * torch.sum(torch.square(conv.weight))
    return total
