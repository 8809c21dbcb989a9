"""Stationary spectral-gating noise reduction, noisereduce semantics
(counterpart of ``mmla_audio_tpu.ops.denoise``).

  1. noise profile: ``|STFT|`` (n_fft 1024, hop 256, Hann, centered) -> dB
     (20 log10, amin 1e-20, top_db 80) -> per-frequency ``mean + 1.5 * std``
     (population std).
  2. signal: same STFT -> gate mask ``db > threshold`` -> ``mask *
     prop_decrease + (1 - prop_decrease)`` -> smoothed by the outer
     triangular kernel (~500 Hz x 50 ms), a frequency band then a time band.
  3. ``STFT * mask`` -> inverse STFT (overlap-add, squared-window
     normalization), after zero-padding each side (noisereduce's chunk
     padding, shortened phase-aligned; see :func:`_chunk_pad`).

Three wrappers dispatch on the tensor's device: ``stft_ri`` and
``istft_frames`` (kernel D1, ``csrc/denoise.cu``) and ``smooth_mask`` (D2).
A CPU tensor takes the plain version: GEMMs of the framed signal against
float64-built bases and the dense banded matrices (``torch.matmul``, under
``DenoiseConfig.precision``), in the input's dtype (float32 on every
path; float64 gives the exact chain the card is held to).  A CUDA tensor
launches the kernel or raises: D1 is a 1024-point real FFT a frame,
float32 in and out and float64 inside (one plan, ``_fft_table``'s float64
twiddles; ``n_fft`` 1024 only), D2 sums the taps in ascending order, so
each window of a batch gets the bits it gets alone.  Each wrapper counts
its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mmla_audio_torch.core.config import DenoiseConfig
from mmla_audio_torch.ops.cuda_denoise import (FFT_N, launch_istft_irfft,
                                               launch_smooth_mask,
                                               launch_stft_rfft)
from mmla_audio_torch.ops.spectral import frame_signal, hann_periodic, pad_last
from mmla_audio_torch.precision import fp32_policy

__all__ = ["quantize_i16", "amp_to_db", "gate_mask", "noise_threshold",
           "reduce_noise", "reduce_noise_plain", "stft_ri", "stft_ri_plain",
           "istft_frames", "istft_frames_plain", "smooth_mask",
           "smooth_mask_plain"]

_PAD = 30_000     # noisereduce chunk padding
_AMIN = 1e-20     # librosa amplitude_to_db amin
_TOP_DB = 80.0    # librosa amplitude_to_db top_db


def quantize_i16(y: torch.Tensor) -> torch.Tensor:
    """PCM16 WAV round-trip of float audio: scale, round half to even, clip
    (the reference writes the denoised window to disk and re-reads it)."""
    return torch.clamp(torch.round(y * 32768.0), -32768.0, 32767.0)


@functools.lru_cache(maxsize=None)
def _smoothing_factors(sr: int, n_fft: int, hop: int, freq_hz: float,
                       time_ms: float) -> tuple[np.ndarray, np.ndarray]:
    """The smoothing kernel's rank-1 factors (it is an outer product of two
    triangular windows), each carrying half the sum-normalization."""
    n_grad_freq = int(freq_hz / (sr / (n_fft / 2)))
    n_grad_time = int(time_ms / ((hop / sr) * 1000))
    v_f = np.concatenate([
        np.linspace(0, 1, n_grad_freq + 1, endpoint=False),
        np.linspace(1, 0, n_grad_freq + 2),
    ])[1:-1]
    v_t = np.concatenate([
        np.linspace(0, 1, n_grad_time + 1, endpoint=False),
        np.linspace(1, 0, n_grad_time + 2),
    ])[1:-1]
    scale = np.sqrt(v_f.sum() * v_t.sum())
    return v_f / scale, v_t / scale


def _chunk_pad(cfg: DenoiseConfig, sr: int) -> int:
    """Effective zero-pad per side: the smallest pad that keeps the
    30 000-pad frame-grid phase (pad = 30 000 mod hop) and holds every edge
    effect inside the zero region (time-smoothing half-width * hop plus
    2 * n_fft).  Equal to the full pad within fp tolerance."""
    _, v_t = _smoothing_factors(sr, cfg.n_fft, cfg.hop_length,
                                cfg.freq_mask_smooth_hz,
                                cfg.time_mask_smooth_ms)
    margin = (len(v_t) // 2) * cfg.hop_length + 2 * cfg.n_fft
    rem = _PAD % cfg.hop_length
    pad = rem + cfg.hop_length * (
        (margin - rem + cfg.hop_length - 1) // cfg.hop_length)
    return min(pad, _PAD)


@functools.lru_cache(maxsize=None)
def _bases_f64(n_fft: int):
    """Windowed forward rDFT bases ``(n_fft, K)``, unwindowed inverse bases
    ``(n_fft, K)`` and the synthesis window, in float64."""
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft
    w = hann_periodic(n_fft).astype(np.float64)
    fwd_cos = np.cos(ang) * w[:, None]
    fwd_sin = -np.sin(ang) * w[:, None]
    # inverse: x_t = (1/N) [sum_k c_k (a_k cos - b_k sin)], c = 2 except DC/Nyq
    c = np.full(n_fft // 2 + 1, 2.0)
    c[0] = 1.0
    c[-1] = 1.0
    inv_cos = np.cos(ang) * c[None, :] / n_fft
    inv_sin = np.sin(ang) * c[None, :] / n_fft
    return fwd_cos, fwd_sin, inv_cos, inv_sin, w


@functools.lru_cache(maxsize=None)
def _bases(n_fft: int, device: torch.device,
           dtype: torch.dtype = torch.float32):
    """``(fwd_cos, fwd_sin, inv_cos.T, inv_sin.T, window)`` in ``dtype`` on
    ``device``."""
    fc, fs, ic, isn, w = _bases_f64(n_fft)
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dtype)
                 .to(device) for a in (fc, fs, ic.T, isn.T, w))


@functools.lru_cache(maxsize=None)
def _window(n_fft: int, device: torch.device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The periodic Hann window's float32 values in ``dtype`` (``_bases``'
    window)."""
    return torch.as_tensor(hann_periodic(n_fft), device=device).to(dtype)


def _fft_table(n_fft: int) -> np.ndarray:
    """D1's twiddles ``e^{-2 pi i t / n_fft}``, ``t < n_fft``, as float64
    ``(cos, sin)`` rows."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1)


def _fft_size(n_fft: int, name: str) -> None:
    if n_fft != FFT_N:
        raise ValueError(f"{name}: the card's FFT kernel is built for n_fft "
                         f"{FFT_N}, got {n_fft}")


@functools.lru_cache(maxsize=None)
def _fft_plan(n_fft: int, device_index: int) -> torch.Tensor:
    """D1's plan on CUDA device ``device_index``: the twiddle table's
    ``(cos, sin)`` pairs, then the window's float32 values, one float64
    vector (one pointer for the kernels; keyed by the index: the
    single-window path is bound by host work)."""
    plan = np.concatenate([_fft_table(n_fft).ravel(),
                           hann_periodic(n_fft).astype(np.float64)])
    return torch.as_tensor(plan, device=f"cuda:{device_index}")


def _band_matrix(v: np.ndarray, n: int, dtype=np.float32) -> np.ndarray:
    """(n, n) matrix M with ``(x @ M)[i] = sum_k v[k] * x[i + c - k]``
    (zero-padded 'same' convolution with the odd-length kernel v)."""
    c = len(v) // 2
    m = np.zeros((n, n), dtype)
    for d, val in enumerate(v):
        k = d - c
        i = np.arange(max(0, -k), min(n, n - k))
        m[i, i + k] = val
    return m


# The CPU's plain version only: a whole post-time recording gets a (T, T)
# time matrix of its own (1.4 GB for 5 minutes): keep only the last two
# shapes.
@functools.lru_cache(maxsize=2)
def _smoothing_matrices(cfg: DenoiseConfig, sr: int, n_bins: int,
                        n_frames: int, device: torch.device,
                        dtype: torch.dtype = torch.float32):
    """Banded matrices for the frequency axis ``(K, K)`` and, transposed, the
    time axis ``(T, T)``, in ``dtype``."""
    v_f, v_t = _smoothing_factors(sr, cfg.n_fft, cfg.hop_length,
                                  cfg.freq_mask_smooth_hz,
                                  cfg.time_mask_smooth_ms)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return (torch.as_tensor(_band_matrix(v_f, n_bins, np_dtype),
                            device=device).to(dtype),
            torch.as_tensor(np.ascontiguousarray(
                _band_matrix(v_t, n_frames, np_dtype).T),
                device=device).to(dtype))


@functools.lru_cache(maxsize=None)
def _smoothing_taps(cfg: DenoiseConfig, sr: int, device: torch.device):
    """D2's taps ``(v_f, v_t)``: the float32 values of the banded
    matrices' diagonals."""
    return tuple(torch.as_tensor(v.astype(np.float32), device=device)
                 for v in _smoothing_factors(sr, cfg.n_fft, cfg.hop_length,
                                             cfg.freq_mask_smooth_hz,
                                             cfg.time_mask_smooth_ms))


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA float32 tensor, False for a CPU one; raise for any
    other device or dtype."""
    if x.is_cpu:
        return False
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    return True


@functools.lru_cache(maxsize=None)
def _inv_window_sum(n_fft: int, hop: int, n_frames: int, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The sum of squared synthesis windows at each overlap-add sample (the
    divisor), in ``dtype``."""
    w = hann_periodic(n_fft).astype(np.float64)
    wsq = np.zeros(n_fft + (n_frames - 1) * hop, np.float64)
    for t in range(n_frames):
        wsq[t * hop: t * hop + n_fft] += w * w
    return torch.as_tensor(np.maximum(wsq, 1e-10)).to(dtype).to(device)


def stft_ri_plain(y: torch.Tensor, n_fft: int, hop: int):
    """``stft_ri``'s plain version: the frames of the reflect-padded signal
    against the forward bases, two ``torch.matmul``."""
    frames = frame_signal(pad_last(y, n_fft // 2, n_fft // 2, "reflect"),
                          n_fft, hop, 1 + y.shape[-1] // hop)
    fc, fs, _, _, _ = _bases(n_fft, y.device, y.dtype)
    return torch.matmul(frames, fc), torch.matmul(frames, fs)


def stft_ri(y: torch.Tensor, n_fft: int, hop: int):
    """Centered (reflect) STFT of ``y (..., n)`` -> ``(re, im)``, each
    ``(..., frames, bins)``.  On the card, one launch of D1's forward FFT
    reading the frames from the signal itself (the reflect padding folded
    into its loads); ``re`` and ``im`` are then the two planes of one
    ``(2, ..., frames, bins)`` spectrum."""
    if not _on_card(y, "stft_ri"):
        return stft_ri_plain(y, n_fft, hop)
    _fft_size(n_fft, "stft_ri")
    spec = launch_stft_rfft(y if y.is_contiguous() else y.contiguous(),
                            1 + y.shape[-1] // hop, hop,
                            _fft_plan(n_fft, y.get_device()))
    stft_ri.launches += bool(spec.numel())
    return spec[0], spec[1]


stft_ri.launches = 0


def istft_frames_plain(re: torch.Tensor, im: torch.Tensor,
                       n_fft: int) -> torch.Tensor:
    """``istft_frames``' plain version: two ``torch.matmul``."""
    _, _, ic_t, is_t, _ = _bases(n_fft, re.device, re.dtype)
    return torch.matmul(re, ic_t) - torch.matmul(im, is_t)


def istft_frames(re: torch.Tensor, im: torch.Tensor,
                 n_fft: int) -> torch.Tensor:
    """Unwindowed inverse rDFT frames ``(..., frames, n_fft)`` of ``(re,
    im)``, each ``(..., frames, bins)``.  On the card, one launch of D1's
    inverse FFT (on contiguous copies of views)."""
    if not _on_card(re, "istft_frames"):
        return istft_frames_plain(re, im, n_fft)
    _fft_size(n_fft, "istft_frames")
    out = launch_istft_irfft(re if re.is_contiguous() else re.contiguous(),
                             im if im.is_contiguous() else im.contiguous(),
                             _fft_plan(n_fft, re.get_device()))
    istft_frames.launches += bool(out.numel())
    return out


istft_frames.launches = 0


def smooth_mask_plain(mask: torch.Tensor, cfg: DenoiseConfig,
                      sr: int) -> torch.Tensor:
    """``smooth_mask``'s plain version: the dense banded pair,
    ``mt_t @ (mask @ mf)``."""
    mf, mt_t = _smoothing_matrices(cfg, sr, mask.shape[-1], mask.shape[-2],
                                   mask.device, mask.dtype)
    return torch.matmul(mt_t, torch.matmul(mask, mf))


def smooth_mask(mask: torch.Tensor, cfg: DenoiseConfig,
                sr: int) -> torch.Tensor:
    """The gate mask ``(..., frames, bins)`` smoothed by the outer
    triangular kernel: the frequency band, then the time band within each
    window, both zero-padded "same".  On the card, one launch of D2, whose
    memory does not grow with the frame count."""
    if not _on_card(mask, "smooth_mask"):
        return smooth_mask_plain(mask, cfg, sr)
    T, K = mask.shape[-2:]
    out = launch_smooth_mask(mask.reshape(-1, T, K).contiguous(),
                             *_smoothing_taps(cfg, sr, mask.device))
    smooth_mask.launches += bool(out.numel())
    return out.reshape(mask.shape)


smooth_mask.launches = 0


def _istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
           out_len: int, inverse) -> torch.Tensor:
    """librosa.istft: windowed inverse frames (``inverse``), overlap-add,
    divided by the squared-window sum, ``n_fft // 2`` head trimmed
    (centered)."""
    T = re.shape[-2]
    total = n_fft + (T - 1) * hop
    frames = inverse(re, im, n_fft) * _window(n_fft, re.device, re.dtype)
    lead = frames.shape[:-2]
    cols = frames.reshape(-1, T, n_fft).transpose(1, 2)          # (N, win, T)
    y = F.fold(cols, output_size=(1, total), kernel_size=(1, n_fft),
               stride=(1, hop)).reshape(lead + (total,))
    y = y / _inv_window_sum(n_fft, hop, T, re.device, re.dtype)
    start = n_fft // 2
    return y[..., start: start + out_len]


def amp_to_db(x: torch.Tensor, top_db: float = _TOP_DB) -> torch.Tensor:
    """librosa.amplitude_to_db(ref=1.0, amin=1e-20): 20 log10, clamped to
    ``top_db`` below the max over the last two axes."""
    db = 20.0 * torch.log10(torch.clamp(x.abs(), min=_AMIN))
    peak = torch.amax(db, dim=(-2, -1), keepdim=True)
    return torch.maximum(db, peak - top_db)


def gate_mask(re: torch.Tensor, im: torch.Tensor, noise_thresh: torch.Tensor,
              prop_decrease: float) -> torch.Tensor:
    """The spectral gate's pre-smoothing mask in the squared-magnitude
    domain: ``amp_to_db(mag) > nt`` holds iff ``max(mag^2, amin^2) >
    10^(nt/10)`` or the window's peak is more than ``top_db`` above the
    threshold."""
    magsq = torch.clamp(re * re + im * im, min=_AMIN * _AMIN)
    thr_sq = torch.pow(10.0, noise_thresh / 10.0)
    peak_sq = torch.amax(magsq, dim=(-2, -1), keepdim=True)
    mask = torch.logical_or(
        magsq > thr_sq,
        peak_sq > thr_sq * 10.0 ** (_TOP_DB / 10.0)).to(re.dtype)
    return mask * prop_decrease + (1.0 - prop_decrease)


def noise_threshold(noise: torch.Tensor,
                    cfg: DenoiseConfig = DenoiseConfig()) -> torch.Tensor:
    """Per-frequency gate threshold ``(K,)`` from the ambient-noise clip
    ``noise (n,)`` float in [-1, 1]: ``mean_db + n_std * std_db`` over time."""
    with fp32_policy(cfg.precision != "highest"):
        re, im = stft_ri(noise, cfg.n_fft, cfg.hop_length)
    db = amp_to_db(torch.sqrt(re * re + im * im))                # (T, K)
    mean = db.mean(dim=-2)
    std = db.std(dim=-2, correction=0)
    return mean + std * cfg.n_std_thresh


def _reduce(y, noise_thresh, cfg, sr, passes, stft, inverse, smooth):
    n = y.shape[-1]
    pad = _chunk_pad(cfg, sr)
    with fp32_policy(cfg.precision != "highest"):
        for pass_idx in range(passes):
            if pass_idx > 0:
                y = quantize_i16(y) / 32768.0
            yp = F.pad(y, (pad, pad))
            re, im = stft(yp, cfg.n_fft, cfg.hop_length)         # (..., T, K)
            mask = smooth(gate_mask(re, im, noise_thresh, cfg.prop_decrease),
                          cfg, sr)
            y = _istft(re * mask, im * mask, cfg.n_fft, cfg.hop_length,
                       yp.shape[-1], inverse)[..., pad: pad + n]
    return y


def reduce_noise(y: torch.Tensor, noise_thresh: torch.Tensor,
                 cfg: DenoiseConfig = DenoiseConfig(), sr: int = 16_000,
                 passes: int = 1) -> torch.Tensor:
    """Denoise ``y (..., n)`` (float [-1, 1]) against a precomputed
    threshold.  ``passes > 1`` re-applies the gate, quantizing to int16
    between passes as the reference's WAV round-trips do.  On the card
    every window of a batch gets the bits it gets alone (D1, D2)."""
    return _reduce(y, noise_thresh, cfg, sr, passes, stft_ri, istft_frames,
                   smooth_mask)


def reduce_noise_plain(y: torch.Tensor, noise_thresh: torch.Tensor,
                       cfg: DenoiseConfig = DenoiseConfig(),
                       sr: int = 16_000, passes: int = 1) -> torch.Tensor:
    """``reduce_noise`` through the plain versions on any device (what the
    CPU runs; on the card, the kernels' yardstick)."""
    return _reduce(y, noise_thresh, cfg, sr, passes, stft_ri_plain,
                   istft_frames_plain, smooth_mask_plain)
