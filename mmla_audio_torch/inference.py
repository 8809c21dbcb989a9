"""Window-to-label inference (counterpart of ``mmla_audio_tpu.inference``).

    (B, >=24000) int16-scale samples + (B,) valid counts
        -> masked prefix / 32768 -> featurize -> model -> softmax, argmax
        -> silent gate -> (labels (B,), probs (B, C))

The featurizer is ``overlap_model_input_cuda``: on the card it is the
hand-written kernel; for CPU tensors its plain version.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import torch

from mmla_audio_torch.core.config import (OverlapFeatureConfig,
                                          OverlapModelConfig)
from mmla_audio_torch.models.overlap import OverlapResBLSTM
from mmla_audio_torch.ops.cuda_features import (
    check_feature_config,
    overlap_model_input_cuda,
)
from mmla_audio_torch.ops.cuda_resblock import check_block_width
from mmla_audio_torch.precision import fp32_policy

__all__ = ["SILENT", "OverlapPredictor"]

SILENT = -1  # label index for the silent gate (the log writes "silent")


def _masked_prefix(buf: torch.Tensor, n: torch.Tensor,
                   length: int) -> torch.Tensor:
    """First ``length`` samples of each row, zero beyond the valid count."""
    pre = buf[..., :length]
    idx = torch.arange(pre.shape[-1], device=buf.device)
    return torch.where(idx < n[..., None], pre, torch.zeros_like(pre))


def _as_pcm(buf, device: torch.device) -> torch.Tensor:
    """int16 and float32 pass through (int16 moves at half the bytes and is
    cast on the device); anything else is cast to float32."""
    buf = torch.as_tensor(buf)
    if buf.dtype not in (torch.int16, torch.float32):
        buf = buf.to(torch.float32)
    return buf.to(device)


class OverlapPredictor:
    """Overlap detection over (denoised, VAD-trimmed) windows.

    ``predict(buf, n)``: ``buf (B, >=24000)`` or ``(>=24000,)`` raw PCM,
    int16 or float32 at int16 scale, with valid counts ``n`` ->
    ``(labels, probs)`` on ``device``; label ``SILENT`` where
    ``n < silent_threshold``.
    """

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 model_cfg: OverlapModelConfig = OverlapModelConfig(),
                 feat_cfg: OverlapFeatureConfig = OverlapFeatureConfig(),
                 device: torch.device | str = "cuda",
                 compute_dtype: torch.dtype | None = None,
                 matmul_precision: str | None = "auto",
                 silent_threshold: int = 4000):
        """``compute_dtype=torch.bfloat16`` runs the model under autocast
        (the featurizer stays fp32).  ``matmul_precision="highest"`` keeps
        the model's convolutions, LSTM and GEMMs in IEEE fp32 (TF32 off);
        ``None`` allows TF32; ``"auto"`` is the overlap model's fast
        default, ``None``, as in the JAX predictor.  ``silent_threshold``:
        post-VAD sample count below which the window is SILENT
        (`record_on_pc.py:142`); pass ``cfg.vad.silent_samples`` to mirror
        a tuned session gate."""
        if matmul_precision == "auto":
            matmul_precision = None
        if matmul_precision not in (None, "highest"):
            raise ValueError(f"matmul_precision must be 'auto', 'highest' "
                             f"or None: {matmul_precision!r}")
        self.device = torch.device(device)
        check_feature_config(feat_cfg, on_card=self.device.type == "cuda")
        if self.device.type == "cuda":
            for width in model_cfg.stage_filters:
                check_block_width(width)
        self.model = OverlapResBLSTM(model_cfg)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.feat_cfg = feat_cfg
        self.compute_dtype = compute_dtype
        self.matmul_precision = matmul_precision
        self.silent_threshold = silent_threshold

    def apply_model(self, x: torch.Tensor) -> torch.Tensor:
        """Model forward under this predictor's numerics policy; float32
        logits."""
        autocast = torch.autocast(self.device.type, dtype=self.compute_dtype) \
            if self.compute_dtype is not None else contextlib.nullcontext()
        with fp32_policy(self.matmul_precision is None), autocast:
            return self.model(x).float()

    @torch.no_grad()
    def predict(self, buf, n):
        buf = _as_pcm(buf, self.device)
        n = torch.as_tensor(n).to(self.device, torch.int32)
        if buf.ndim == 1:
            labels, probs = self.predict(buf[None], n.reshape(1))
            return labels[0], probs[0]
        y = _masked_prefix(buf.to(torch.float32), n,
                           self.feat_cfg.n_samples) / 32768.0
        img = overlap_model_input_cuda(y, self.feat_cfg)   # (B, 128, 151, 3)
        probs = torch.softmax(self.apply_model(img), dim=-1)
        labels = torch.argmax(probs, dim=-1).to(torch.int32)
        labels = torch.where(n < self.silent_threshold,
                             torch.full_like(labels, SILENT), labels)
        return labels, probs
