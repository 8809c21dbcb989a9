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

STFT and ISTFT are GEMMs on framed signals against float64-built bases.
Three wrappers dispatch on the tensor's device: ``stft_ri`` and
``istft_frames`` (kernel D1, ``csrc/denoise.cu``) and ``smooth_mask`` (D2).
A CPU tensor takes the plain version: ``torch.matmul`` against the bases
and the dense banded matrices, under ``DenoiseConfig.precision``.  A CUDA
tensor launches the kernel or raises: D1 sums every output over K in one
fixed order in IEEE fp32 (whatever the precision policy), D2 sums the taps
in ascending order, so each window of a batch gets the bits it gets alone.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mmla_audio_torch.core.config import DenoiseConfig
from mmla_audio_torch.ops.cuda_denoise import (launch_fixed_order_gemm,
                                               launch_smooth_mask)
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
def _bases(n_fft: int, device: torch.device):
    """float32 ``(fwd_cos, fwd_sin, inv_cos.T, inv_sin.T, window)`` on
    ``device``."""
    fc, fs, ic, isn, w = _bases_f64(n_fft)
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                 device=device)
                 for a in (fc, fs, ic.T, isn.T, w))


@functools.lru_cache(maxsize=None)
def _kernel_bases(n_fft: int, device: torch.device):
    """D1's operands, the same float32 values as ``_bases``: the forward
    ``[fwd_cos | fwd_sin]`` ``(n_fft, 2K)`` and the inverse ``[inv_cos.T;
    -inv_sin.T]`` ``(2K, n_fft)``."""
    fc, fs, ic_t, is_t, _ = (a.cpu() for a in _bases(n_fft, device))
    return (torch.cat([fc, fs], dim=1).to(device),
            torch.cat([ic_t, -is_t], dim=0).to(device))


def _band_matrix(v: np.ndarray, n: int) -> np.ndarray:
    """(n, n) matrix M with ``(x @ M)[i] = sum_k v[k] * x[i + c - k]``
    (zero-padded 'same' convolution with the odd-length kernel v)."""
    c = len(v) // 2
    m = np.zeros((n, n), np.float32)
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
                        n_frames: int, device: torch.device):
    """Banded matrices for the frequency axis ``(K, K)`` and, transposed, the
    time axis ``(T, T)``."""
    v_f, v_t = _smoothing_factors(sr, cfg.n_fft, cfg.hop_length,
                                  cfg.freq_mask_smooth_hz,
                                  cfg.time_mask_smooth_ms)
    return (torch.as_tensor(_band_matrix(v_f, n_bins), device=device),
            torch.as_tensor(np.ascontiguousarray(
                _band_matrix(v_t, n_frames).T), device=device))


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
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    return True


@functools.lru_cache(maxsize=None)
def _inv_window_sum(n_fft: int, hop: int, n_frames: int,
                    device: torch.device) -> torch.Tensor:
    """1 / sum of squared synthesis windows at each overlap-add sample."""
    w = hann_periodic(n_fft).astype(np.float64)
    wsq = np.zeros(n_fft + (n_frames - 1) * hop, np.float64)
    for t in range(n_frames):
        wsq[t * hop: t * hop + n_fft] += w * w
    return torch.as_tensor(np.maximum(wsq, 1e-10).astype(np.float32),
                           device=device)


def stft_ri_plain(y: torch.Tensor, n_fft: int, hop: int):
    """``stft_ri``'s plain version: the frames of the reflect-padded signal
    against the forward bases, two ``torch.matmul``."""
    frames = frame_signal(pad_last(y, n_fft // 2, n_fft // 2, "reflect"),
                          n_fft, hop, 1 + y.shape[-1] // hop)
    fc, fs, _, _, _ = _bases(n_fft, y.device)
    return torch.matmul(frames, fc), torch.matmul(frames, fs)


def stft_ri(y: torch.Tensor, n_fft: int, hop: int):
    """Centered (reflect) STFT of ``y (..., n)`` -> ``(re, im)``, each
    ``(..., frames, bins)``.  On the card, one launch of D1 reading the
    frames from the reflect-padded signal (row stride ``hop``); ``re`` and
    ``im`` are then the two halves of one ``(..., frames, 2 * bins)``
    spectrum."""
    if not _on_card(y, "stft_ri"):
        return stft_ri_plain(y, n_fft, hop)
    lead, n = y.shape[:-1], y.shape[-1]
    T, K = 1 + n // hop, n_fft // 2 + 1
    yr = F.pad(y.reshape(-1, n), (n_fft // 2, n_fft // 2), mode="reflect")
    spec = launch_fixed_order_gemm(yr, T, yr.stride(0), hop,
                                   yr.shape[0] * T, n_fft,
                                   _kernel_bases(n_fft, y.device)[0])
    stft_ri.launches += bool(spec.numel())
    spec = spec.reshape(lead + (T, 2 * K))
    return spec[..., :K], spec[..., K:]


stft_ri.launches = 0


def istft_frames_plain(re: torch.Tensor, im: torch.Tensor,
                       n_fft: int) -> torch.Tensor:
    """``istft_frames``' plain version: two ``torch.matmul``."""
    _, _, ic_t, is_t, _ = _bases(n_fft, re.device)
    return torch.matmul(re, ic_t) - torch.matmul(im, is_t)


def istft_frames(re: torch.Tensor, im: torch.Tensor,
                 n_fft: int) -> torch.Tensor:
    """Unwindowed inverse rDFT frames ``(..., frames, n_fft)`` of ``(re,
    im)``, each ``(..., frames, bins)``.  On the card, one launch of D1 on
    ``[re | im]`` against ``[inv_cos.T; -inv_sin.T]`` (K = 2 * bins)."""
    if not _on_card(re, "istft_frames"):
        return istft_frames_plain(re, im, n_fft)
    a = torch.cat([re, im], dim=-1)
    a2 = a.reshape(-1, a.shape[-1])
    out = launch_fixed_order_gemm(a2, 1, a2.shape[1], 0, a2.shape[0],
                                  a2.shape[1],
                                  _kernel_bases(n_fft, re.device)[1])
    istft_frames.launches += bool(out.numel())
    return out.reshape(a.shape[:-1] + (n_fft,))


istft_frames.launches = 0


def smooth_mask_plain(mask: torch.Tensor, cfg: DenoiseConfig,
                      sr: int) -> torch.Tensor:
    """``smooth_mask``'s plain version: the dense banded pair,
    ``mt_t @ (mask @ mf)``."""
    mf, mt_t = _smoothing_matrices(cfg, sr, mask.shape[-1], mask.shape[-2],
                                   mask.device)
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
    w = _bases(n_fft, re.device)[4]
    frames = inverse(re, im, n_fft) * w
    lead = frames.shape[:-2]
    cols = frames.reshape(-1, T, n_fft).transpose(1, 2)          # (N, win, T)
    y = F.fold(cols, output_size=(1, total), kernel_size=(1, n_fft),
               stride=(1, hop)).reshape(lead + (total,))
    y = y / _inv_window_sum(n_fft, hop, T, re.device)
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
        peak_sq > thr_sq * 10.0 ** (_TOP_DB / 10.0)).to(torch.float32)
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
