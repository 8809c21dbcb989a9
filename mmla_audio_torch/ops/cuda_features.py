"""The overlap featurizer's hand-written CUDA kernel and its wrapper.

``overlap_model_input_cuda`` replaces ``overlap_model_input_pallas``
(``mmla_audio_tpu/ops/pallas_features.py``, TPU kernels ``_kernel`` and, with
``group > 1``, ``_kernel_grouped``).  The kernel source, with its design and
cost notes, is ``mmla_audio_torch/csrc/overlap_features.cu``; it is built
with nvcc for ``sm_90a`` at first use and bound with ctypes.  The kernel
computes each frame's spectrum with a mixed-radix FFT and each mel row as
the band of bins its filter covers; ``feature_tables`` builds the tables it
reads (window, twiddles, FFT plan, mel bands).

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
version (``ops.features.overlap_model_input``); a CUDA tensor launches the
kernel or raises.  ``overlap_model_input_cuda.launches`` counts launches with
one window per CTA, ``.launches_grouped`` those with several (G = 2 or 4,
served and held but never the default: G = 1 was the fastest at every batch
measured, ``PERF.md``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mmla_audio_torch.core.config import OverlapFeatureConfig
from mmla_audio_torch.ops.features import fit_length, overlap_model_input
from mmla_audio_torch.ops.spectral import hann_periodic, mel_filterbank

__all__ = ["GROUPS", "MAX_RADIX", "SMEM_LIMIT", "FeatureTables",
           "check_feature_config", "feature_tables", "fft_radices",
           "launch_overlap_features", "overlap_model_input_cuda"]

GROUPS = (1, 2, 4)          # windows per CTA the kernel is built for
# the largest prime factor of win/2 the kernel's FFT takes: a factor without
# a written-out butterfly (7 and up) runs the generic stage, R complex
# multiply-adds a point, so a large one would make the FFT the frame's cost
MAX_RADIX = 17
# shared memory one CTA may opt into on the H100 (227 KB), and the smallest
# block the launcher falls back to
SMEM_LIMIT, MIN_THREADS = 232_448, 256


def _primes(lo: int, hi: int):
    return [p for p in range(lo, hi + 1)
            if all(p % d for d in range(2, int(p ** 0.5) + 1))]


def fft_radices(n: int) -> tuple:
    """The kernel's radix plan for an ``n``-point complex FFT: the factors 3
    and 5 first, then any other prime factor up to ``MAX_RADIX`` (the
    generic stage), then 4 and 2, radix 8 last (its stage writes contiguous
    runs).  ``None`` where ``n`` has a prime factor above ``MAX_RADIX``."""
    radices, m = [], n
    for r in [3, 5] + _primes(7, MAX_RADIX):
        while m % r == 0:
            radices.append(r)
            m //= r
    tail = []
    while m % 8 == 0:
        tail.append(8)
        m //= 8
    for r in (4, 2):
        if m % r == 0:
            radices.append(r)
            m //= r
    return tuple(radices + tail) if m == 1 else None


def _smem_bytes(cfg: OverlapFeatureConfig, K: int, threads: int) -> int:
    """The kernel's shared memory at one window a CTA (``smem_floats`` of
    ``csrc/overlap_features.cu``); ``K``: the widest mel band."""
    def round4(x):
        return (x + 3) & ~3

    win, T, M, nwarps = cfg.win_length, cfg.n_frames, cfg.n_mels, threads // 32
    return 4 * (2 * win + nwarps * 2 * win + round4(K * M) + round4(2 * M)
                + round4(T) + round4(nwarps * 3) + round4(M * T))


def check_feature_config(cfg: OverlapFeatureConfig,
                         on_card: bool = True) -> None:
    """The kernel hardcodes the PNG quantize and the mel-axis flip; a config
    that disables either would make the two paths disagree.  On the card it
    takes an even window whose half has no prime factor above
    ``MAX_RADIX``, and whose tables fit the shared memory of a CTA of
    ``MIN_THREADS``; the plain version (``on_card=False``) takes any
    window."""
    if not cfg.png_quantize or not cfg.flip_mel_axis:
        raise ValueError(
            "the overlap feature kernel requires png_quantize=True and "
            "flip_mel_axis=True (it hardcodes both)")
    if not on_card:
        return
    win = cfg.win_length
    geometry = (f"win_length {win} (sample_rate {cfg.sample_rate}, win_ms "
                f"{cfg.win_ms})")
    if win < 2 or win % 2:
        raise ValueError(f"the overlap feature kernel's FFT needs an even "
                         f"window; {geometry} is odd")
    if fft_radices(win // 2) is None:
        raise ValueError(
            f"the overlap feature kernel's FFT takes no prime factor of "
            f"win/2 above {MAX_RADIX}; {geometry} has one")
    smem = _smem_bytes(cfg, _mel_bands(cfg)[2].shape[0], MIN_THREADS)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the overlap feature kernel needs {smem} bytes of shared memory "
            f"at {MIN_THREADS} threads for {geometry}, {cfg.n_frames} frames "
            f"and {cfg.n_mels} mels; a CTA has {SMEM_LIMIT}")


class FeatureTables(NamedTuple):
    """What the kernel reads besides the audio, for one config."""
    window: np.ndarray      # (win,) periodic Hann
    twiddle: np.ndarray     # (win, 2) cos and -sin of 2 pi m / win
    radices: tuple          # FFT plan of the win/2-point complex FFT
    mel_first: np.ndarray   # (M,) int32 first bin of each mel row
    mel_count: np.ndarray   # (M,) int32 bins in the row's band
    mel_weight: np.ndarray  # (K, M) band weights, K = the widest band


@functools.lru_cache(maxsize=None)
def _mel_bands(cfg: OverlapFeatureConfig) -> tuple:
    """Mel rows in image order (reversed: the flip), each as the contiguous
    band of bins between its first and last nonzero weight: ``(first (M,),
    count (M,), weight (K, M))``, K the widest band."""
    fb = mel_filterbank(cfg.sample_rate, cfg.win_length, cfg.n_mels,
                        cfg.fmin, cfg.fmax)[::-1]          # (M, bins)
    nz = fb != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), fb.shape[1] - 1 - nz[:, ::-1].argmax(1), -1)
    count = last - first + 1
    weight = np.zeros((max(int(count.max()), 1), fb.shape[0]), np.float32)
    for m, (f, c) in enumerate(zip(first, count)):
        weight[:c, m] = fb[m, f:f + c]
    return first.astype(np.int32), count.astype(np.int32), weight


@functools.lru_cache(maxsize=None)
def feature_tables(cfg: OverlapFeatureConfig,
                   dtype=np.float32) -> FeatureTables:
    """The kernel's tables for ``cfg``.  Twiddles are computed in float64
    and rounded to ``dtype``; the window is ``hann_periodic``'s float32;
    the mel bands are ``_mel_bands``."""
    check_feature_config(cfg)
    win = cfg.win_length
    ang = 2.0 * np.pi * np.arange(win) / win
    twiddle = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(dtype)
    first, count, weight = _mel_bands(cfg)
    return FeatureTables(hann_periodic(win).astype(dtype), twiddle,
                         fft_radices(win // 2), first, count,
                         weight.astype(dtype))


@functools.lru_cache(maxsize=None)
def _device_tables(cfg: OverlapFeatureConfig, device: torch.device):
    """``(ftab, itab)`` on ``device``: float32 [window, twiddles, mel
    weights] and int32 [radices, mel first bins, mel counts]."""
    tab = feature_tables(cfg)
    ftab = np.concatenate([tab.window, tab.twiddle.ravel(),
                           tab.mel_weight.ravel()])
    itab = np.concatenate([np.asarray(tab.radices, np.int32), tab.mel_first,
                           tab.mel_count])
    return (torch.as_tensor(ftab, device=device),
            torch.as_tensor(itab, device=device))


def launch_overlap_features(y2: torch.Tensor, cfg: OverlapFeatureConfig,
                            group: int, launch=None) -> torch.Tensor:
    """Launch the kernel on ``y2 (B, n)`` float32 CUDA audio, ``B >= 1``,
    samples contiguous, at ``group`` windows per CTA -> ``(B, 3, M, T)``
    float32.  Counts nothing: the wrapper does.  ``launch``: the library's
    ``overlap_features_launch`` (default) or that of another build of the
    source, which a probe times against it."""
    from mmla_audio_torch._build import cuda_library

    if launch is None:
        launch = cuda_library("overlap_features").overlap_features_launch
    B, n = y2.shape
    T, M = cfg.n_frames, cfg.n_mels
    out = torch.empty((B, 3, M, T), dtype=torch.float32, device=y2.device)
    ftab, itab = _device_tables(cfg, y2.device)
    tab = feature_tables(cfg)
    with torch.cuda.device(y2.device):
        stream = torch.cuda.current_stream(y2.device).cuda_stream
        err = launch(
            y2.data_ptr(), y2.stride(0), B, n, ftab.data_ptr(),
            itab.data_ptr(), out.data_ptr(), cfg.win_length, cfg.hop_length,
            T, M, tab.mel_weight.shape[0], len(tab.radices), group, stream)
    if err != 0:
        raise RuntimeError(f"overlap_features kernel launch failed "
                           f"(cudaError {err})")
    return out


def overlap_model_input_cuda(y: torch.Tensor,
                             cfg: OverlapFeatureConfig = OverlapFeatureConfig(),
                             group: int | None = None) -> torch.Tensor:
    """``y (B, n)`` or ``(n,)`` float32 audio in [-1, 1] -> ``(B, 128, 151, 3)``
    (or ``(128, 151, 3)``) float32 0..255, as ``overlap_model_input``.

    ``group``: windows per CTA, one of ``GROUPS``; ``None`` takes 1.  Every
    group gives the same output.  For a CUDA tensor the result is a permuted
    view of the kernel's ``(B, 3, 128, 151)`` output."""
    check_feature_config(cfg, on_card=y.device.type != "cpu")
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
    B = y2.shape[0]
    if B:
        group = group or 1
        out = launch_overlap_features(y2, cfg, group)
        if group == 1:
            overlap_model_input_cuda.launches += 1
        else:
            overlap_model_input_cuda.launches_grouped += 1
    else:
        out = torch.empty((0, 3, cfg.n_mels, cfg.n_frames),
                          dtype=torch.float32, device=y.device)
    img = out.permute(0, 2, 3, 1)                  # (B, M, T, 3)
    return img[0] if squeeze else img


overlap_model_input_cuda.launches = 0
overlap_model_input_cuda.launches_grouped = 0
