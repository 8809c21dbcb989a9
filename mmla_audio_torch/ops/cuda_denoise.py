"""Launchers of the denoise's hand-written CUDA kernels.

D1 is the STFT and ISTFT of every frame as a 1024-point real FFT
(``stft_rfft_launch``, ``istft_irfft_launch``), float32 in and out and
float64 inside, so each output is the exact transform rounded once: one
plan, whose sequence of operations depends on nothing but the frame, so a
window's spectrum and frames are the same bits alone and in any batch.  D2
(``smooth_mask_launch``) is the gate mask's smoothing as two banded passes
(frequency, then time) instead of the dense ``(K, K)`` and ``(T, T)``
matrices: a block streams a strip of one window's frames once, at one tile
of bins, and ``smooth_plan`` picks the strip and the tile from the shape
(each output's sequence of operations depends on neither, so neither
changes a bit of it).  Neither replaces a Pallas kernel: the JAX package
runs these steps as XLA GEMMs (``mmla_audio_tpu/ops/denoise.py``).  The
source, with its design and cost notes, is
``mmla_audio_torch/csrc/denoise.cu``, built with nvcc for ``sm_90a`` at
first use and bound with ctypes.

These functions check shapes and launch; they count nothing.  The wrappers
that dispatch on the device and count launches are ``ops.denoise.stft_ri``
and ``ops.denoise.istft_frames`` (D1) and ``ops.denoise.smooth_mask`` (D2).
"""

from __future__ import annotations

import functools

import torch

from mmla_audio_torch._build import cuda_library

__all__ = ["FFT_N", "SMOOTH_BINS_PER_THREAD", "SMOOTH_MAX_TILE",
           "smooth_plan", "launch_stft_rfft", "launch_istft_irfft",
           "launch_smooth_mask"]

# the one n_fft D1 is built for (DenoiseConfig's)
FFT_N = 1024
# D2's streaming instance (the (33, 7) taps of DenoiseConfig at 16 kHz;
# other odd tap counts take the generic kernel, which has no grid to plan):
# bins a thread, bins a block at most (a multiple of the former), the
# longest and shortest strip of frames a block streams, and the blocks per
# SM the plan aims for before it shortens the strip
SMOOTH_BINS_PER_THREAD = 6
SMOOTH_MAX_TILE = 768
SMOOTH_STRIPS = (64, 4)
SMOOTH_BLOCKS_PER_SM = 4


def smooth_plan(groups: int, frames: int, bins: int,
                sms: int = 132) -> tuple[int, int]:
    """D2's ``(strip, tile)`` for a ``(groups, frames, bins)`` mask on a card
    of ``sms`` SMs: frames and bins a block.  The tile is all the bins (in
    pieces of at most ``SMOOTH_MAX_TILE``); the strip halves from 64 frames
    down to 4 until the grid holds ``SMOOTH_BLOCKS_PER_SM`` blocks an SM.
    A strip recomputes the frequency pass of its ``len(v_t) - 1`` halo
    frames, so it stays long where the grid is full anyway."""
    r = SMOOTH_BINS_PER_THREAD
    pieces = -(-bins // SMOOTH_MAX_TILE)
    tile = -(-(-(-bins // pieces)) // r) * r
    strip, shortest = SMOOTH_STRIPS
    while strip > shortest and groups * -(-frames // strip) * pieces \
            < SMOOTH_BLOCKS_PER_SM * sms:
        strip //= 2
    return strip, tile


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    the smoothed ``(G, T, K)``.  Taps of 33 and 7 stream on
    ``smooth_plan``'s grid; any other odd pair runs the generic kernel."""
    if mask.ndim != 3 or not mask.is_contiguous() \
            or mask.dtype != torch.float32:
        raise ValueError(f"smooth_mask: a contiguous float32 (G, T, K) mask "
                         f"required, got {mask.dtype} {tuple(mask.shape)}")
    G, T, K = mask.shape
    out = torch.empty_like(mask)
    if mask.numel():
        strip, tile = smooth_plan(G, T, K, _sm_count(mask.get_device()))
        _launch("smooth_mask", mask,
                cuda_library("denoise").smooth_mask_launch, mask.data_ptr(),
                out.data_ptr(), G, T, K, v_f.data_ptr(), len(v_f),
                v_t.data_ptr(), len(v_t), strip, tile)
    return out
