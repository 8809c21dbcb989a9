"""MFCC + delta features, python_speech_features semantics (counterpart of
``mmla_audio_tpu.ops.mfcc``).

The speaker-ID front end: 13 MFCCs (25 ms / 10 ms frames, NFFT 512, 26 HTK
mel filters snapped to FFT bins, DCT-II ortho, ceplifter 22, log-energy in
c0, preemphasis 0.97, rectangular window) of raw int16-valued samples, plus
the reference's delta (regression over +-2 frames, edge padding).

The real DFT, the mel projection and the DCT are fp32 GEMMs against bases
built once in float64 numpy.  They and the delta contraction run in IEEE
fp32 (TF32 off) whatever the caller's policy, as the JAX package pins them
to ``Precision.HIGHEST``.  A streaming window is a fixed-size buffer plus a
valid-sample count; frame validity is masks and per-row clipped gathers, so
a batch of windows of different lengths is one call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mmla_audio_torch.ops.spectral import _dft_basis, _on_device, frame_signal
from mmla_audio_torch.precision import fp32_policy

__all__ = ["max_frames_for", "num_valid_frames", "mfcc13", "delta",
           "mfcc39", "mfcc39_windowed", "mfcc39_windowed_batch"]

# psf clamps zeros with the FLOAT64 eps (log -36.04); float32's (1.19e-7,
# log -15.94) would shift a silent frame by ~20 and bleed into its
# neighbours' deltas.  2.220446e-16 is exact in float32.
_EPS = float(np.finfo(np.float64).eps)


@functools.lru_cache(maxsize=None)
def _psf_filterbank(n_filt: int, n_fft: int, sample_rate: int,
                    low_freq: float = 0.0, high_freq: float | None = None
                    ) -> np.ndarray:
    """python_speech_features ``get_filterbanks``: HTK mel points snapped to
    integer FFT bins by ``floor((nfft + 1) * hz / sr)``, not librosa's
    continuous triangles.  ``(n_filt, n_fft // 2 + 1)``."""
    high_freq = high_freq or sample_rate / 2

    def hz2mel(hz):
        return 2595 * np.log10(1 + np.asarray(hz, dtype=np.float64) / 700.0)

    def mel2hz(mel):
        return 700 * (10 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1)

    melpoints = np.linspace(hz2mel(low_freq), hz2mel(high_freq), n_filt + 2)
    bins = np.floor((n_fft + 1) * mel2hz(melpoints) / sample_rate)
    fbank = np.zeros((n_filt, n_fft // 2 + 1))
    for j in range(n_filt):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct2_ortho(n_in: int, n_out: int) -> np.ndarray:
    """DCT-II, ortho norm, as a matrix ``(n_in, n_out)`` (scipy.fftpack.dct
    type 2, truncated to the first ``n_out`` coefficients)."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    scale = np.full((1, n_out), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return (mat * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lifter(n_cep: int, L: int) -> np.ndarray:
    return (1.0 + (L / 2.0) * np.sin(np.pi * np.arange(n_cep) / L)
            ).astype(np.float32)


def _mfcc_bases(n_fft, win_length, n_filt, sample_rate, n_cep, ceplifter):
    """``(cos, sin, fb.T, dct, lifter)`` as float32 numpy."""
    cos, sin = _dft_basis(n_fft, win_length, False)
    return (cos, sin, _psf_filterbank(n_filt, n_fft, sample_rate).T,
            _dct2_ortho(n_filt, n_cep), _lifter(n_cep, ceplifter))


def max_frames_for(n_samples: int, win_length: int = 400,
                   hop_length: int = 160) -> int:
    """psf frame count of a signal of exactly ``n_samples``."""
    if n_samples <= win_length:
        return 1
    return 1 + int(np.ceil((n_samples - win_length) / hop_length))


def num_valid_frames(n_samples: torch.Tensor, win_length: int = 400,
                     hop_length: int = 160) -> torch.Tensor:
    """psf frame count of each count in ``n_samples``: 1 if n <= win, else
    1 + ceil((n - win) / hop)."""
    n = torch.as_tensor(n_samples).to(torch.int64)
    extra = torch.clamp(n - win_length, min=0)
    return torch.where(n <= win_length, torch.ones_like(n),
                       1 + torch.div(extra + hop_length - 1, hop_length,
                                     rounding_mode="floor"))


def _preemphasis(sig: torch.Tensor, coeff: float) -> torch.Tensor:
    return torch.cat([sig[..., :1], sig[..., 1:] - coeff * sig[..., :-1]],
                     dim=-1)


def mfcc13(sig: torch.Tensor, *, sample_rate: int = 16_000,
           win_length: int = 400, hop_length: int = 160, n_fft: int = 512,
           n_filt: int = 26, n_cep: int = 13, preemph: float = 0.97,
           ceplifter: int = 22, append_energy: bool = True,
           n_frames: int | None = None) -> torch.Tensor:
    """MFCC-13 of ``sig (..., n_samples)`` (int16-scale values as floats)
    -> ``(..., n_frames, n_cep)``, on ``sig``'s device.  The signal is
    zero-padded to cover the last frame, as psf frames it."""
    if n_frames is None:
        n_frames = max_frames_for(sig.shape[-1], win_length, hop_length)
    sig = _preemphasis(sig.to(torch.float32), preemph)
    pad_to = (n_frames - 1) * hop_length + win_length
    if sig.shape[-1] < pad_to:
        sig = F.pad(sig, (0, pad_to - sig.shape[-1]))
    frames = frame_signal(sig, win_length, hop_length, n_frames)
    cos, sin, fb_t, dct, lift = _on_device(
        _mfcc_bases, (n_fft, win_length, n_filt, sample_rate, n_cep,
                      ceplifter), sig.device)
    with fp32_policy(False):
        re = torch.matmul(frames, cos)
        im = torch.matmul(frames, sin)
        powspec = (re * re + im * im) / n_fft                   # (..., T, bins)
        energy = torch.sum(powspec, dim=-1)                     # (..., T)
        energy = energy.masked_fill(energy == 0, _EPS)
        feat = torch.matmul(powspec, fb_t)
        feat = torch.log(feat.masked_fill(feat == 0, _EPS))
        feat = torch.matmul(feat, dct)
    if ceplifter > 0:
        feat = feat * lift
    if append_energy:
        feat = torch.cat([torch.log(energy)[..., None], feat[..., 1:]],
                         dim=-1)
    return feat


def delta(feat: torch.Tensor, N: int = 2,
          valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's delta (`speaker_identification.py:141-151`):
    ``d[t] = sum_{i=-N..N} i * feat[t+i] / (2 * sum i^2)``, edge padded.

    ``feat (..., T, C)``.  With ``valid_len`` (one count per leading index,
    or one for all), the edge is each row's own ``valid_len - 1`` instead
    of ``T - 1``, as the reference computes deltas on the unpadded frames;
    every row takes its clipped frames in one gather."""
    T, C = feat.shape[-2:]
    lead = feat.shape[:-2]
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    offsets = torch.arange(-N, N + 1, device=feat.device)
    pos = torch.arange(T, device=feat.device)[:, None] + offsets  # (T, 2N+1)
    flat = feat.reshape(-1, T, C)
    B = flat.shape[0]
    if valid_len is None:
        hi = torch.full((B,), T - 1, device=feat.device)
    else:
        hi = torch.as_tensor(valid_len, device=feat.device).to(
            torch.int64).expand(lead).reshape(B) - 1
    idx = torch.minimum(pos.clamp(min=0)[None], hi[:, None, None])
    rows = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
    rows = rows.reshape(B, T, offsets.numel(), C)
    with fp32_policy(False):
        out = torch.einsum("k,btkc->btc", offsets.to(feat.dtype), rows)
    return (out / denom).reshape(feat.shape)


def mfcc39(sig: torch.Tensor, *, n_frames: int | None = None,
           delta_n: int = 2, **kw) -> torch.Tensor:
    """MFCC + delta + delta-delta -> ``(..., n_frames, 39)``, the deltas'
    edges at the last frame."""
    m = mfcc13(sig, n_frames=n_frames, **kw)
    d = delta(m, delta_n)
    dd = delta(d, delta_n)
    return torch.cat([m, d, dd], dim=-1)


def mfcc39_windowed_batch(bufs: torch.Tensor, n_samples, *,
                          max_frames: int = 256, delta_n: int = 2,
                          win_length: int = 400, hop_length: int = 160,
                          **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape streaming path: ``bufs (B, max_samples)`` zero-padded,
    ``n_samples (B,)`` valid counts -> ``((B, max_frames, 39), valid frames
    (B,))``.

    As `input_feature_gen` (`speaker_identification.py:372-398`): MFCCs of
    each valid prefix, deltas with their edge at each row's own last valid
    frame, rows past it zero, padded (or truncated) to ``max_frames``.  The
    buffer is masked, preemphasized, then masked again: psf preemphasizes
    the trimmed signal, and preemphasis of a masked buffer would leak one
    sample past its end.  The silent gate is the caller's."""
    n = torch.as_tensor(n_samples).to(bufs.device, torch.int64)
    T_max = min(max_frames_for(bufs.shape[-1], win_length, hop_length),
                max_frames)
    mask = torch.arange(bufs.shape[-1], device=bufs.device) < n[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=bufs.device)
    sig = torch.where(mask, bufs.to(torch.float32), zero)
    sig = torch.where(mask, _preemphasis(sig, kw.pop("preemph", 0.97)), zero)
    m = mfcc13(sig, n_frames=T_max, preemph=0.0, win_length=win_length,
               hop_length=hop_length, **kw)                   # (B, T_max, 13)
    valid = torch.clamp(num_valid_frames(n, win_length, hop_length),
                        max=T_max)
    d = delta(m, delta_n, valid_len=valid)
    dd = delta(d, delta_n, valid_len=valid)
    feat = torch.cat([m, d, dd], dim=-1)
    if T_max < max_frames:
        feat = F.pad(feat, (0, 0, 0, max_frames - T_max))
    keep = torch.arange(max_frames, device=bufs.device) < valid[:, None]
    return torch.where(keep[..., None], feat, zero), valid


def mfcc39_windowed(buf: torch.Tensor, n_samples, **kw
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One window: ``buf (max_samples,)`` and its valid count ->
    ``((max_frames, 39), valid frames)``."""
    feat, valid = mfcc39_windowed_batch(
        buf[None], torch.as_tensor(n_samples).reshape(1), **kw)
    return feat[0], valid[0]
