"""Launchers of the denoise's hand-written CUDA kernels.

D1 is the STFT and ISTFT of every frame as a 1024-point real FFT
(``stft_rfft_launch``, ``istft_irfft_launch``), float32 in and out and
float64 inside, so each output is the exact transform rounded once: one
plan, whose sequence of operations depends on nothing but the frame, so a
window's spectrum and frames are the same bits alone and in any batch.  D2
(``smooth_mask_launch``) is the gate mask's smoothing as two banded passes
(frequency, then time) instead of the dense ``(K, K)`` and ``(T, T)``
matrices.  Neither replaces a Pallas kernel: the JAX package runs these
steps as XLA GEMMs (``mmla_audio_tpu/ops/denoise.py``).  The source, with
its design and cost notes, is ``mmla_audio_torch/csrc/denoise.cu``, built
with nvcc for ``sm_90a`` at first use and bound with ctypes.

These functions check shapes and launch; they count nothing.  The wrappers
that dispatch on the device and count launches are ``ops.denoise.stft_ri``
and ``ops.denoise.istft_frames`` (D1) and ``ops.denoise.smooth_mask`` (D2).
"""

from __future__ import annotations

import torch

from mmla_audio_torch._build import cuda_library

__all__ = ["FFT_N", "SMOOTH_TILE_T", "launch_stft_rfft",
           "launch_istft_irfft", "launch_smooth_mask"]

# the one n_fft D1 is built for (DenoiseConfig's)
FFT_N = 1024
# frames of one window a D2 block smooths: with the 6 halo frames of the
# 7-tap time band, 2 x 22 x 513 floats of shared memory (90 KB)
SMOOTH_TILE_T = 16


def _err(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _launch(name: str, t: torch.Tensor, fn, *args) -> None:
    """``fn(*args, stream)`` on ``t``'s device and its current stream;
    raise on a launch error.  Lean, because the single-window path is bound
    by this host work: the device is switched only when another is
    current, and the stream is read as its raw handle."""
    index = t.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(name, t, fn, *args)
    _err(name, fn(*args, torch._C._cuda_getCurrentRawStream(index)))


def launch_stft_rfft(y: torch.Tensor, frames: int, hop: int,
                     plan: torch.Tensor) -> torch.Tensor:
    """``(2, ..., frames, 513)`` spectra, the re plane then the im plane,
    of the centered frames of each row of ``y (..., n)`` (contiguous, ``n >
    512``): frame ``t`` of a row is its samples ``t * hop - 512 ...``,
    reflected at both ends, each multiplied by the window as it is read.
    ``plan`` is ``ops.denoise._fft_plan``'s on ``y``'s device, float64:
    the twiddles ``e^{-2 pi i t / 1024}`` as ``(cos, sin)`` pairs, then the
    window."""
    if y.dtype != torch.float32:
        raise TypeError("stft_rfft: float32 signal required")
    if plan.dtype != torch.float64:
        raise TypeError("stft_rfft: float64 plan required")
    n = y.shape[-1]
    if n <= FFT_N // 2 or not y.is_contiguous():
        raise ValueError(f"stft_rfft: contiguous rows of more than "
                         f"{FFT_N // 2} samples required, got "
                         f"{tuple(y.shape)} strides {y.stride()}")
    out = y.new_empty((2, *y.shape[:-1], frames, FFT_N // 2 + 1))
    m = y.numel() // n * frames
    if m:
        _launch("stft_rfft", y, cuda_library("denoise").stft_rfft_launch,
                y.data_ptr(), n, frames, hop, m, plan.data_ptr(),
                out.data_ptr())
    return out


def launch_istft_irfft(re: torch.Tensor, im: torch.Tensor,
                       plan: torch.Tensor) -> torch.Tensor:
    """The unwindowed inverse rDFT ``(..., 1024)`` of each row of ``(re,
    im)``, contiguous float32 ``(..., 513)`` of one shape on one CUDA
    device; ``plan`` as for ``launch_stft_rfft``."""
    k = FFT_N // 2 + 1
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError("istft_irfft: float32 spectra required")
    if plan.dtype != torch.float64:
        raise TypeError("istft_irfft: float64 plan required")
    if re.shape[-1] != k or im.shape != re.shape \
            or not (re.is_contiguous() and im.is_contiguous()) \
            or im.get_device() != re.get_device():
        raise ValueError(f"istft_irfft: re and im must be contiguous (..., "
                         f"{k}) tensors of one shape on one device, got "
                         f"{tuple(re.shape)} on {re.device}, "
                         f"{tuple(im.shape)} on {im.device}")
    out = re.new_empty((*re.shape[:-1], FFT_N))
    m = re.numel() // k
    if m:
        _launch("istft_irfft", re,
                cuda_library("denoise").istft_irfft_launch, re.data_ptr(),
                im.data_ptr(), m, plan.data_ptr(), out.data_ptr())
    return out


def launch_smooth_mask(mask: torch.Tensor, v_f: torch.Tensor,
                       v_t: torch.Tensor) -> torch.Tensor:
    """``mask (G, T, K)`` contiguous float32 on the card, taps ``v_f``
    (odd length) and ``v_t`` (odd length) float32 on the same device ->
    the smoothed ``(G, T, K)``."""
    if mask.ndim != 3 or not mask.is_contiguous() \
            or mask.dtype != torch.float32:
        raise ValueError(f"smooth_mask: a contiguous float32 (G, T, K) mask "
                         f"required, got {mask.dtype} {tuple(mask.shape)}")
    G, T, K = mask.shape
    out = torch.empty_like(mask)
    if mask.numel():
        _launch("smooth_mask", mask,
                cuda_library("denoise").smooth_mask_launch, mask.data_ptr(),
                out.data_ptr(), G, T, K, v_f.data_ptr(), len(v_f),
                v_t.data_ptr(), len(v_t), SMOOTH_TILE_T)
    return out
