"""The overlap featurizer's hand-written CUDA kernel and its wrapper.

``overlap_model_input_cuda`` replaces ``overlap_model_input_pallas``
(``mmla_audio_tpu/ops/pallas_features.py``, TPU kernels ``_kernel`` and, with
``group > 1``, ``_kernel_grouped``).  The kernel source, with its design and
cost notes, is ``mmla_audio_torch/csrc/overlap_features.cu``; it is built
with nvcc for ``sm_90a`` at first use and bound with ctypes.

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
version (``ops.features.overlap_model_input``); a CUDA tensor launches the
kernel or raises.  ``overlap_model_input_cuda.launches`` counts launches with
one window per CTA, ``.launches_grouped`` those with several.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mmla_audio_torch.core.config import OverlapFeatureConfig
from mmla_audio_torch.ops.features import fit_length, overlap_model_input
from mmla_audio_torch.ops.spectral import _dft_basis, mel_filterbank

__all__ = ["GROUPS", "check_feature_config", "pick_group",
           "overlap_model_input_cuda"]

GROUPS = (1, 2, 4)         # windows per CTA the kernel is built for
ONE_WINDOW_PER_SM = 3      # pick_group: G=1 up to this many windows per SM


def check_feature_config(cfg: OverlapFeatureConfig) -> None:
    """The kernel hardcodes the PNG quantize and the mel-axis flip; a config
    that disables either would make the two paths disagree."""
    if not cfg.png_quantize or not cfg.flip_mel_axis:
        raise ValueError(
            "the overlap feature kernel requires png_quantize=True and "
            "flip_mel_axis=True (it hardcodes both)")


@functools.lru_cache(maxsize=None)
def _kernel_bases(cfg: OverlapFeatureConfig, device: torch.device):
    win = cfg.win_length
    cos, sin = _dft_basis(win, win, windowed=True)
    # (bins, M) with mel columns reversed: image rows come out pre-flipped
    fb = mel_filterbank(cfg.sample_rate, win, cfg.n_mels, cfg.fmin,
                        cfg.fmax).T[:, ::-1]
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (cos, sin, fb))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pick_group(batch: int, sm_count: int) -> int:
    """Windows per CTA: 1 while the batch is at most ``ONE_WINDOW_PER_SM``
    windows per SM, 2 above.  Every G gives the same output.

    The cut-over is measured (H100 SXM, 132 SMs, CUDA events).  At G=1 one
    CTA holds its mel tile in shared memory (137 KB), so one CTA runs per SM
    at ~0.48 ms per window: 0.52 ms at B <= 132, 1.0 at 200, 1.47 at 300.
    At G=2 a CTA of two windows takes ~1.1 ms alone on an SM, but two CTAs
    fit an SM and hide each other's basis-load latency, ~0.4 ms per window:
    G=2 wins from B=400 (1.64 vs 1.93 ms) to 2,400 (7.63 vs 9.08).  G=4 is
    never faster than G=2 (3.20 vs 3.21 ms at 1,024, 7.88 vs 7.63 at
    2,400); it stays for callers that pass it."""
    return 1 if batch <= ONE_WINDOW_PER_SM * sm_count else 2


def overlap_model_input_cuda(y: torch.Tensor,
                             cfg: OverlapFeatureConfig = OverlapFeatureConfig(),
                             group: int | None = None) -> torch.Tensor:
    """``y (B, n)`` or ``(n,)`` float32 audio in [-1, 1] -> ``(B, 128, 151, 3)``
    (or ``(128, 151, 3)``) float32 0..255, as ``overlap_model_input``.

    ``group``: windows per CTA, one of ``GROUPS``; ``None`` takes
    ``pick_group(B, SM count)``.  Every group gives the same output.  For a
    CUDA tensor the result is a permuted view of the kernel's
    ``(B, 3, 128, 151)`` output."""
    check_feature_config(cfg)
    if group is not None and group not in GROUPS:
        raise ValueError(f"overlap_model_input_cuda: group must be one of "
                         f"{GROUPS}, got {group}")
    if y.device.type == "cpu":
        return overlap_model_input(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"overlap_model_input_cuda: unsupported device "
                         f"{y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"overlap_model_input_cuda: float32 required, got "
                        f"{y.dtype}")
    if y.ndim not in (1, 2):
        raise ValueError(f"overlap_model_input_cuda: (B, n) or (n,) audio "
                         f"required, got shape {tuple(y.shape)}")
    squeeze = y.ndim == 1
    y2 = fit_length(y[None] if squeeze else y, cfg.n_samples)
    if y2.stride(-1) != 1:
        raise ValueError("overlap_model_input_cuda: samples must be "
                         "contiguous along the last axis")
    B, n = y2.shape
    T, M = cfg.n_frames, cfg.n_mels
    out = torch.empty((B, 3, M, T), dtype=torch.float32, device=y.device)
    if B:
        from mmla_audio_torch._build import cuda_library

        if group is None:
            group = pick_group(B, _sm_count(y.device))
        cos, sin, fb = _kernel_bases(cfg, y.device)
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            err = cuda_library("overlap_features").overlap_features_launch(
                y2.data_ptr(), y2.stride(0), B, n, cos.data_ptr(),
                sin.data_ptr(), fb.data_ptr(), out.data_ptr(),
                cfg.win_length, cfg.hop_length, T, M, group, stream)
        if err != 0:
            raise RuntimeError(f"overlap_features kernel launch failed "
                               f"(cudaError {err})")
        if group == 1:
            overlap_model_input_cuda.launches += 1
        else:
            overlap_model_input_cuda.launches_grouped += 1
    img = out.permute(0, 2, 3, 1)                  # (B, M, T, 3)
    return img[0] if squeeze else img


overlap_model_input_cuda.launches = 0
overlap_model_input_cuda.launches_grouped = 0
