"""Stationary spectral-gating noise reduction, noisereduce semantics
(counterpart of ``mmla_audio_tpu.ops.denoise``).

  1. noise profile: ``|STFT|`` (n_fft 1024, hop 256, Hann, centered) -> dB
     (20 log10, amin 1e-20, top_db 80) -> per-frequency ``mean + 1.5 * std``
     (population std).
  2. signal: same STFT -> gate mask ``db > threshold`` -> ``mask *
     prop_decrease + (1 - prop_decrease)`` -> smoothed by the outer
     triangular kernel (~500 Hz x 50 ms), applied as two banded GEMMs.
  3. ``STFT * mask`` -> inverse STFT (overlap-add, squared-window
     normalization), after zero-padding each side (noisereduce's chunk
     padding, shortened phase-aligned; see :func:`_chunk_pad`).

STFT and ISTFT are GEMMs on framed signals against float64-built bases.
``DenoiseConfig.precision == "highest"`` keeps them in IEEE fp32 on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mmla_audio_torch.core.config import DenoiseConfig
from mmla_audio_torch.ops.spectral import frame_signal, hann_periodic, pad_last
from mmla_audio_torch.precision import fp32_policy

__all__ = ["quantize_i16", "amp_to_db", "gate_mask", "noise_threshold",
           "reduce_noise"]

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


# A whole post-time recording gets a (T, T) time matrix of its own (1.4 GB
# for 5 minutes): keep only the last two shapes.
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
def _inv_window_sum(n_fft: int, hop: int, n_frames: int,
                    device: torch.device) -> torch.Tensor:
    """1 / sum of squared synthesis windows at each overlap-add sample."""
    w = hann_periodic(n_fft).astype(np.float64)
    wsq = np.zeros(n_fft + (n_frames - 1) * hop, np.float64)
    for t in range(n_frames):
        wsq[t * hop: t * hop + n_fft] += w * w
    return torch.as_tensor(np.maximum(wsq, 1e-10).astype(np.float32),
                           device=device)


def _stft_ri(y: torch.Tensor, n_fft: int, hop: int):
    """Centered (reflect) STFT -> ``(re, im)``, each ``(..., frames, bins)``."""
    frames = frame_signal(pad_last(y, n_fft // 2, n_fft // 2, "reflect"),
                          n_fft, hop, 1 + y.shape[-1] // hop)
    fc, fs, _, _, _ = _bases(n_fft, y.device)
    return torch.matmul(frames, fc), torch.matmul(frames, fs)


def _istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
           out_len: int) -> torch.Tensor:
    """librosa.istft: windowed inverse frames, overlap-add, divided by the
    squared-window sum, ``n_fft // 2`` head trimmed (centered)."""
    T = re.shape[-2]
    total = n_fft + (T - 1) * hop
    _, _, ic_t, is_t, w = _bases(n_fft, re.device)
    frames = (torch.matmul(re, ic_t) - torch.matmul(im, is_t)) * w
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
        re, im = _stft_ri(noise, cfg.n_fft, cfg.hop_length)
    db = amp_to_db(torch.sqrt(re * re + im * im))                # (T, K)
    mean = db.mean(dim=-2)
    std = db.std(dim=-2, correction=0)
    return mean + std * cfg.n_std_thresh


def reduce_noise(y: torch.Tensor, noise_thresh: torch.Tensor,
                 cfg: DenoiseConfig = DenoiseConfig(), sr: int = 16_000,
                 passes: int = 1) -> torch.Tensor:
    """Denoise ``y (..., n)`` (float [-1, 1]) against a precomputed
    threshold.  ``passes > 1`` re-applies the gate, quantizing to int16
    between passes as the reference's WAV round-trips do."""
    n = y.shape[-1]
    pad = _chunk_pad(cfg, sr)
    with fp32_policy(cfg.precision != "highest"):
        for pass_idx in range(passes):
            if pass_idx > 0:
                y = quantize_i16(y) / 32768.0
            yp = F.pad(y, (pad, pad))
            re, im = _stft_ri(yp, cfg.n_fft, cfg.hop_length)     # (..., T, K)
            mask = gate_mask(re, im, noise_thresh, cfg.prop_decrease)
            mf, mt_t = _smoothing_matrices(cfg, sr, mask.shape[-1],
                                           mask.shape[-2], y.device)
            mask = torch.matmul(mt_t, torch.matmul(mask, mf))
            y = _istft(re * mask, im * mask, cfg.n_fft, cfg.hop_length,
                       yp.shape[-1])[..., pad: pad + n]
    return y
