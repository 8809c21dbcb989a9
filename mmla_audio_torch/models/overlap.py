"""Overlap detector: ResNet-CNN -> mel-mean -> BiLSTM -> logits
(counterpart of ``mmla_audio_tpu.models.overlap``).

Conv2D(16, k1) stem; 3 stages x 3 pre-activation residual blocks (32/64/128
filters; each stage's first block downsamples by 2 with a strided 1x1
shortcut and a 2x2 max-pool on the main path; inner convs k3 then k(4,1));
mean over the mel axis; Bidirectional LSTM(256); Dropout 0.25
(``SeededDropout``: a trainer's generator draws its masks); LeakyReLU;
Dense.  Input is the feature image ``(B, 128, 151, 3)`` in 0..255, as in
JAX; internally NCHW.  Geometry: 128x151 -> 64x76 -> 32x38 -> 16x19 ->
(B, 19, 128) -> BiLSTM -> (B, 512).

Padding matches Flax ``SAME``: the (4,1) conv pads 1 above and 2 below; the
2x2 stride-2 pool on 151 columns needs ``ceil_mode=True`` (76 columns, the
last window holding one column, as ``SAME``'s -inf padding gives).

In inference on the card, each non-pooling block is one launch of the
hand-written fused kernel (``ops/cuda_resblock.py``; the rule is in
``ResBlock2D``'s docstring).  ``OverlapResBLSTM.segments`` is the forward
as its stretches that never reach that kernel and the fused blocks between
them; ``forward`` runs them, and ``inference.OverlapPredictor`` replays the
stretches as CUDA graphs.  A forward spans each stage (``model.stage``, the
first with the stem) and the mel-mean, BiLSTM and head (``model.lstm``):
``utils.timers``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmla_audio_torch.core.config import OverlapModelConfig
from mmla_audio_torch.utils.timers import span
from mmla_audio_torch.models.layers import (BiLSTM, KerasBatchNorm,
                                            SeededDropout, keras_init_,
                                            leaky_relu)
from mmla_audio_torch.ops.cuda_resblock import fold_bn, fused_resblock_cuda

__all__ = ["ResBlock2D", "OverlapResBLSTM", "keras_init_"]


class ResBlock2D(nn.Module):
    """Pre-activation residual block.

    Dispatch rule of ``forward``: a non-pooling block in eval mode, with
    autograd not recording, on a CUDA float32 tensor outside autocast, runs
    the fused kernel ``fused_resblock_cuda`` on its folded operands (it
    serves widths up to ``FUSED_MAX_CHANNELS``; ``OverlapPredictor`` checks
    them when it builds a model for the card).
    Every other case runs the unfused composition ``forward_unfused``:
    training normalizes with batch statistics, which cannot be folded, and
    the kernel has no backward; under bf16 autocast the convolutions run in
    bf16."""

    def __init__(self, in_channels: int, filters: int, pool: bool = False,
                 bn_momentum: float = 0.99, bn_eps: float = 1e-3):
        super().__init__()
        self.pool = pool
        self.shortcut = nn.Conv2d(in_channels, filters, 1, stride=2) \
            if pool else None
        self.bn0 = KerasBatchNorm(in_channels, bn_momentum, bn_eps)
        self.conv0 = nn.Conv2d(in_channels, filters, 3, padding=1)
        self.bn1 = KerasBatchNorm(filters, bn_momentum, bn_eps)
        self.conv1 = nn.Conv2d(filters, filters, (4, 1))
        self._fused_key = None
        self._fused = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (not self.pool and not self.training
                and not torch.is_grad_enabled() and x.is_cuda
                and x.dtype == torch.float32
                and not torch.is_autocast_enabled(x.device.type)):
            return fused_resblock_cuda(x, *self.fused_operands())
        return self.forward_unfused(x)

    def forward_unfused(self, x: torch.Tensor) -> torch.Tensor:
        res = self.shortcut(x) if self.pool else x
        out = self.conv0(F.elu(self.bn0(x)))
        out = F.elu(self.bn1(out))
        out = self.conv1(F.pad(out, (0, 0, 1, 2)))
        if self.pool:
            out = F.max_pool2d(out, 2, 2, ceil_mode=True)
        return res + out

    @torch.no_grad()
    def fused_operands(self) -> tuple:
        """``(k1, b1, k2, b2, g1, bb1, g2, bb2)`` for the kernel: HWIO
        convolution kernels, biases and both folded BatchNorms.  Cached, and
        rebuilt when a source tensor changes storage or is updated in
        place."""
        src = (self.conv0.weight, self.conv0.bias, self.conv1.weight,
               self.conv1.bias) + tuple(
            t for bn in (self.bn0, self.bn1)
            for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var))
        key = tuple((t.data_ptr(), t._version) for t in src)
        if key != self._fused_key:
            g1, bb1 = fold_bn(self.bn0)
            g2, bb2 = fold_bn(self.bn1)
            self._fused = tuple(t.contiguous() for t in (
                self.conv0.weight.permute(2, 3, 1, 0), self.conv0.bias,
                self.conv1.weight.permute(2, 3, 1, 0), self.conv1.bias,
                g1, bb1, g2, bb2))
            self._fused_key = key
        return self._fused


class OverlapResBLSTM(nn.Module):
    def __init__(self, cfg: OverlapModelConfig = OverlapModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Conv2d(3, cfg.stem_filters, 1)
        blocks, ch = [], cfg.stem_filters
        for f in cfg.stage_filters:
            for block in range(cfg.blocks_per_stage):
                blocks.append(ResBlock2D(ch, f, pool=block == 0,
                                         bn_momentum=cfg.bn_momentum,
                                         bn_eps=cfg.bn_eps))
                ch = f
        self.blocks = nn.Sequential(*blocks)
        self.bilstm = BiLSTM(ch, cfg.lstm_units)
        self.dropout = SeededDropout(cfg.dropout)
        self.head = nn.Linear(2 * cfg.lstm_units, cfg.num_classes)

    def segments(self) -> list:
        """The forward in order, as ``(span, stretch, blocks)`` a segment:
        the layers of ``stretch`` (the stem and a stage's pooling block, or
        the mel-mean, BiLSTM and head), none of which reaches the fused
        block, then ``blocks``, the stage's non-pooling blocks (B3 at
        inference on the card), each on the previous layer's output."""
        blocks, n = list(self.blocks), self.cfg.blocks_per_stage
        stages = [blocks[i: i + n] for i in range(0, len(blocks), n)]
        segs = [("model.stage", (self._stem, stages[0][0]),
                 tuple(stages[0][1:]))]
        segs += [("model.stage", (stage[0],), tuple(stage[1:]))
                 for stage in stages[1:]]
        segs.append(("model.lstm", (self._lstm_head,), ()))
        return segs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x (B, 128, 151, 3)`` -> logits ``(B, num_classes)``: the
        layers of ``segments`` in order."""
        for name, stretch, blocks in self.segments():
            with span(name):
                for layer in stretch + blocks:
                    x = layer(x)
        return x

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """The scaled image, channels first, through the stem.  The
        channels-first image is made contiguous (a no-op for the featurizer
        kernel's output, a permuted view of it): from a channels-last image
        the convolutions would keep the channels-last layout, which the
        fused block refuses."""
        if self.cfg.input_scale != 1.0:
            x = x * self.cfg.input_scale
        return self.stem(x.permute(0, 3, 1, 2).contiguous())

    def _lstm_head(self, net: torch.Tensor) -> torch.Tensor:
        net = net.mean(dim=2).transpose(1, 2)    # mel-axis mean -> (B, T, C)
        net = leaky_relu(self.dropout(self.bilstm(net)))
        return self.head(net)
