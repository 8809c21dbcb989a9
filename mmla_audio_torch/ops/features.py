"""Overlap window featurizer in plain PyTorch (counterpart of
``mmla_audio_tpu.ops.features``).

1.5 s of audio -> (128, 151, 3) "ZCR-enhanced image": R = per-frame ZCR
broadcast down the mel axis, G = B = 1 - minmax(log-mel), mel axis flipped
(``origin="lower"``) and uint8-quantized as the reference's PNG round-trip
does, returned as float32 0..255.

This is the plain version of the hand-written kernel in
``ops/cuda_features.py``: it serves CPU tensors, and the kernel is held
against it on the card.

Speaker ID: a 2.56 s (VAD-trimmed) window -> (256, 39) MFCC + delta +
delta-delta, rows past the valid frames zero (``ops/mfcc.py``; torch ops on
the window's device, no kernel of their own).
"""

from __future__ import annotations

import torch

from mmla_audio_torch.core.config import (OverlapFeatureConfig,
                                          SpeakerFeatureConfig)
from mmla_audio_torch.ops.mfcc import mfcc39_windowed_batch
from mmla_audio_torch.ops.spectral import (
    melspectrogram_power,
    minmax_normalize,
    power_to_db,
    zero_crossing_rate,
)

__all__ = ["fit_length", "quantize_png_u8", "overlap_image",
           "overlap_model_input", "speaker_feature", "speaker_feature_batch"]


def fit_length(y: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate or zero-pad the last axis of ``y`` to ``n`` samples."""
    if y.shape[-1] < n:
        return torch.nn.functional.pad(y, (0, n - y.shape[-1]))
    return y[..., :n]


def quantize_png_u8(x: torch.Tensor) -> torch.Tensor:
    """matplotlib ``imsave`` float->uint8: truncate ``clip(x, 0, 1) * 255``,
    kept as float32 0..255 (the reference feeds decoded PNG floats to the
    model unscaled)."""
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0)


def overlap_image(y: torch.Tensor,
                  cfg: OverlapFeatureConfig = OverlapFeatureConfig()
                  ) -> torch.Tensor:
    """ZCR-enhanced image of float audio ``y (..., n)`` in [-1, 1] ->
    ``(..., 128, 151, 3)``; audio is truncated or zero-padded to
    ``cfg.n_samples``."""
    y = fit_length(y, cfg.n_samples)
    mel = melspectrogram_power(y, cfg.sample_rate, cfg.win_length,
                               cfg.hop_length, cfg.n_mels,
                               cfg.fmin, cfg.fmax)               # (..., M, T)
    s_norm = minmax_normalize(power_to_db(mel))
    zcr = zero_crossing_rate(y, cfg.win_length, cfg.hop_length)  # (..., T)
    r = zcr[..., None, :].expand(s_norm.shape)
    gb = 1.0 - s_norm
    return torch.stack([r, gb, gb], dim=-1)


def overlap_model_input(y: torch.Tensor,
                        cfg: OverlapFeatureConfig = OverlapFeatureConfig()
                        ) -> torch.Tensor:
    """What the model sees: the PNG-round-tripped image, 0..255 float32,
    mel axis flipped (``decode_png(imsave(img))``)."""
    img = overlap_image(y, cfg)
    if cfg.flip_mel_axis:
        img = torch.flip(img, dims=(-3,))
    if cfg.png_quantize:
        img = quantize_png_u8(img)
    return img


def speaker_feature_batch(bufs: torch.Tensor, n_samples,
                          cfg: SpeakerFeatureConfig = SpeakerFeatureConfig()
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speaker-ID windows: ``bufs (B, max_samples)`` int16-scale values and
    valid counts ``(B,)`` -> ``((B, 256, 39), valid frames (B,))``."""
    return mfcc39_windowed_batch(
        bufs, n_samples, max_frames=cfg.max_frames, delta_n=cfg.delta_n,
        win_length=cfg.win_length, hop_length=cfg.hop_length,
        sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, n_filt=cfg.n_filt,
        n_cep=cfg.n_cep, preemph=cfg.preemph, ceplifter=cfg.ceplifter,
        append_energy=cfg.append_energy)


def speaker_feature(buf: torch.Tensor, n_samples,
                    cfg: SpeakerFeatureConfig = SpeakerFeatureConfig()
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One speaker-ID window: ``(max_samples,)`` + valid count ->
    ``((256, 39), valid frames)``."""
    feat, valid = speaker_feature_batch(
        buf[None], torch.as_tensor(n_samples).reshape(1), cfg)
    return feat[0], valid[0]
