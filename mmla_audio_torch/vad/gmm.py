"""WebRTC-architecture GMM voice-activity detector (counterpart of
``mmla_audio_tpu.vad.gmm``).

The float approximation of webrtcvad: a six-band filterbank of half-band
allpass splits (each IIR replaced by its truncated 64-tap impulse
response, so the filterbank is a stack of causal FIRs), band log
energies a 30 ms frame, and per band two-component Gaussian mixtures for
noise and speech, adapted frame by frame.  A frame is speech when the
spectrum-weighted log-likelihood ratio or any band's exceeds the
aggressiveness's threshold and its energy is above ``_MIN_ENERGY_DB``.

A benchmark probe, not a serving option (``VadConfig`` refuses
``decision="gmm"``): ``streaming.session.preprocess_window(gmm_state=)``
is its only caller in the pipeline.

The filterbank is plain tensor code on the signal's device (each FIR an
unfold-and-sum, IEEE fp32 on the card: no cuDNN, no TF32).  The
adaptation is a serial scan over the window's frames:

* ``gmm_vad_plain``: the frame loop of the JAX package's ``lax.scan``, step
  for step, in torch ops (``_scan``; about 60 small operations a frame);
* ``gmm_vad_rows``: many streams' scans at once, one state row each
  (``state_rows``); for CUDA tensors one launch of G1, the kernel of
  ``csrc/gmm_vad.cu`` (a warp a stream), or a raise; for CPU tensors the
  plain loop over the rows.

``gmm_vad`` takes G1 with one row for a CUDA signal and the plain loop for
a CPU one.  G1 runs the update with the same IEEE operations in the same
order as ``_scan`` (no contraction into FMAs), so given the same decisions
its state is the plain loop's bit for bit; the decisions can differ only
where ``logf``/``expf`` round differently, i.e. at a threshold margin of
a few ulps (``_scan`` returns the margins).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["GmmVadState", "GMM_THRESHOLDS", "GMM_STATE_SLOTS",
           "band_log_energies", "gmm_init_from_noise", "gmm_vad",
           "gmm_vad_plain", "gmm_vad_rows", "gmm_vad_rows_plain",
           "state_rows", "state_from_rows", "total_db"]

_N_BANDS = 6
_FIR_TAPS = 64
# WebRTC's split-filter allpass coefficients (vad_filterbank.c, Q13 5243 and
# 1392 -> 0.64 and 0.17)
_AP_UPPER = 0.64
_AP_LOWER = 0.17
# spectrum weights per band, low to high (vad_core.c kSpectrumWeight)
_SPECTRUM_WEIGHT = np.asarray([6.0, 8.0, 10.0, 12.0, 14.0, 16.0])
_SPECTRUM_WEIGHT /= _SPECTRUM_WEIGHT.sum()

# aggressiveness -> (global weighted log-LR threshold, per-band threshold)
GMM_THRESHOLDS = {
    0: (0.5, 2.0),
    1: (1.0, 3.0),
    2: (1.5, 4.0),
    3: (2.0, 5.0),
}

# frames whose total energy is at most this (dB, int16 scale) are never
# speech: WebRTC's kMinEnergy short-circuit
_MIN_ENERGY_DB = 10.0
_LOG_SQRT_2PI = 0.9189385
_LOG_HALF = math.log(0.5)
# one state row: noise_mean, noise_std, speech_mean, speech_std (6, 2) each,
# then min_track (6,)
GMM_STATE_SLOTS = 4 * 2 * _N_BANDS + _N_BANDS


def _allpass_fir(a: float, n: int = _FIR_TAPS) -> np.ndarray:
    """Truncated impulse response of H(z) = (a + z^-1) / (1 + a z^-1)."""
    h = np.zeros(n)
    h[0] = a
    h[1:] = (1.0 - a * a) * (-a) ** np.arange(n - 1)
    return h


def _hp80_fir(n: int = _FIR_TAPS) -> np.ndarray:
    """The 80 Hz high-pass biquad of the 0-250 Hz band at the 500 Hz rate
    (vad_filterbank.c HighPassFilter, Q14 {6631,-13262,6631} /
    {16384,-7756,5620}), as its truncated impulse response."""
    b = np.asarray([6631.0, -13262.0, 6631.0]) / 16384.0
    a = np.asarray([16384.0, -7756.0, 5620.0]) / 16384.0
    h = np.zeros(n)
    x = np.zeros(n)
    x[0] = 1.0
    s1 = s2 = 0.0
    for i in range(n):          # direct form II transposed
        y = b[0] * x[i] + s1
        s1 = b[1] * x[i] - a[1] * y + s2
        s2 = b[2] * x[i] - a[2] * y
        h[i] = y
    return h


# the taps reversed, for the correlation form of the causal FIR
_R_UPPER = _allpass_fir(_AP_UPPER).astype(np.float32)[::-1].copy()
_R_LOWER = _allpass_fir(_AP_LOWER).astype(np.float32)[::-1].copy()
_R_HP80 = _hp80_fir().astype(np.float32)[::-1].copy()


def _corr(x: torch.Tensor, taps_rev: np.ndarray, n: int) -> torch.Tensor:
    """Causal FIR of the last axis, its first ``n`` outputs: the signal
    left-padded with ``taps - 1`` zeros, each window of taps against the
    reversed taps, summed (the JAX package's ``_corr``)."""
    k = len(taps_rev)
    xp = torch.nn.functional.pad(x, (k - 1, 0))
    h = torch.from_numpy(taps_rev).to(x.device)
    return torch.sum(xp.unfold(-1, k, 1)[..., :n, :] * h, dim=-1)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-band split and decimation by 2: (high band, low band)."""
    n = x.shape[-1] // 2
    up = _corr(x[..., 0::2], _R_UPPER, n)
    lo = _corr(x[..., 1::2], _R_LOWER, n)
    return up - lo, up + lo


def band_log_energies(x: torch.Tensor, frame_len: int = 480
                      ) -> torch.Tensor:
    """int16-scale float signal ``(..., n)`` -> band log energies ``(...,
    T, 6)`` in dB, ``T = n // frame_len``: 80-250, 250-500, 500-1000,
    1000-2000, 2000-3000 and 3000-4000 Hz at 16 kHz.  The filterbank runs
    over the whole signal, then each decimated band is framed at its own
    rate."""
    x = torch.as_tensor(x).to(torch.float32)
    T = x.shape[-1] // frame_len
    _, x8 = _split(x)                   # 8 kHz (the 4-8 kHz half dropped)
    hp24, lp02 = _split(x8)             # 4 kHz
    # hp24 is 2-4 kHz decimated, spectrally inverted: its high output is
    # the lower original band
    b23, b34 = _split(hp24)             # 2 kHz
    b12, lp01 = _split(lp02)            # 2 kHz
    b051, lp005 = _split(lp01)          # 1 kHz
    b0205, lp0025 = _split(lp005)       # 500 Hz
    b008 = _corr(lp0025, _R_HP80, lp0025.shape[-1])   # 80-250 Hz

    def frame_energy(sig, decim):
        m = frame_len // decim
        s = sig[..., : T * m].reshape(sig.shape[:-1] + (T, m))
        e = torch.mean(torch.square(s), dim=-1)
        return 10.0 * torch.log10(torch.clamp(e, min=1e-10))

    return torch.stack([frame_energy(b008, 32), frame_energy(b0205, 32),
                        frame_energy(b051, 16), frame_energy(b12, 8),
                        frame_energy(b23, 8), frame_energy(b34, 8)], dim=-1)


def total_db(x: torch.Tensor, frame_len: int = 480) -> torch.Tensor:
    """Each whole frame's energy ``(..., T)`` in dB (int16 scale)."""
    x = torch.as_tensor(x).to(torch.float32)
    T = x.shape[-1] // frame_len
    frames = x[..., : T * frame_len].reshape(x.shape[:-1] + (T, frame_len))
    e = torch.mean(torch.square(frames), dim=-1)
    return 10.0 * torch.log10(torch.clamp(e, min=1e-10))


class GmmVadState(NamedTuple):
    """Per-band two-component mixtures over log energy (dB), fp32."""
    noise_mean: torch.Tensor     # (6, 2)
    noise_std: torch.Tensor      # (6, 2)
    speech_mean: torch.Tensor    # (6, 2)
    speech_std: torch.Tensor     # (6, 2)
    min_track: torch.Tensor      # (6,) running energy minimum per band


def state_rows(state: GmmVadState) -> torch.Tensor:
    """A state (its leaves ``(..., 6, 2)`` and ``(..., 6)``) -> rows
    ``(..., 54)`` float32: the four mixtures row-major, then ``min_track``
    (the layout G1 reads)."""
    lead = state.min_track.shape[:-1]
    return torch.cat([t.reshape(lead + (-1,)) for t in state],
                     dim=-1).to(torch.float32)


def state_from_rows(rows: torch.Tensor) -> GmmVadState:
    """The inverse of ``state_rows``."""
    lead, k = rows.shape[:-1], 2 * _N_BANDS
    parts = [rows[..., i * k:(i + 1) * k].reshape(lead + (_N_BANDS, 2))
             for i in range(4)]
    return GmmVadState(*parts, rows[..., 4 * k:])


def gmm_init_from_noise(noise_i16, frame_len: int = 480,
                        device: torch.device | str = "cuda") -> GmmVadState:
    """The mixtures initialised from the session's ambient-noise clip (int16
    samples): the noise components at the band mean -/+ half the band's
    spread, the speech components at +12 and +24 dB; on ``device``."""
    x = torch.from_numpy(np.asarray(noise_i16, np.float32)).to(device)
    e = band_log_energies(x, frame_len).cpu().numpy()      # (T, 6)
    if e.shape[0] == 0:
        e = np.full((1, _N_BANDS), -10.0, np.float32)
    mean = e.mean(axis=0)
    std = np.maximum(e.std(axis=0), 1.5)
    leaves = (np.stack([mean - 0.5 * std, mean + 0.5 * std], axis=-1),
              np.stack([std, std], axis=-1),
              np.stack([mean + 12.0, mean + 24.0], axis=-1),
              np.full((_N_BANDS, 2), 6.0), mean)
    return GmmVadState(*(torch.from_numpy(np.asarray(a, np.float32))
                         .to(device) for a in leaves))


def _log_mix(e: torch.Tensor, means: torch.Tensor, stds: torch.Tensor
             ) -> torch.Tensor:
    """log(0.5 N(e; m0, s0) + 0.5 N(e; m1, s1)) per band: ``e (..., 6)``,
    the mixtures ``(..., 6, 2)``."""
    z = (e[..., None] - means) / stds
    comp = -0.5 * z * z - torch.log(stds) - _LOG_SQRT_2PI
    return torch.logsumexp(comp + _LOG_HALF, dim=-1)


def _update(e, means, stds, rate):
    """The winning component (the first on a tie) of each band moves toward
    the observation at ``rate (..., 1, 1)``; every std is clipped."""
    z = torch.abs(e[..., None] - means) / stds
    onehot = torch.nn.functional.one_hot(torch.argmin(z, dim=-1), 2).to(
        torch.float32)
    m = means + rate * onehot * (e[..., None] - means)
    s = stds + rate * onehot * (torch.abs(e[..., None] - m) - stds)
    return m, torch.clamp(s, 1.0, 12.0)


def _scan(energies: torch.Tensor, tot: torch.Tensor, state: GmmVadState,
          g_thr: float, l_thr: float, adapt: bool):
    """The frame loop over ``energies (B, T, 6)`` and ``tot (B, T)`` from
    ``state`` (leaves ``(B, 6, 2)``/``(B, 6)``).  Returns (decisions ``(B,
    T)`` bool, final state, margins ``(B, T, 2)``: |weighted log-LR sum -
    g_thr| and |max band log-LR - l_thr|)."""
    w = torch.from_numpy(_SPECTRUM_WEIGHT.astype(np.float32)).to(
        energies.device)
    decisions, margins = [], []
    st = state
    for t in range(energies.shape[1]):
        e = energies[:, t]
        llr = _log_mix(e, st.speech_mean, st.speech_std) \
            - _log_mix(e, st.noise_mean, st.noise_std)
        weighted = torch.sum(w * llr, dim=-1)
        peak = torch.amax(llr, dim=-1)
        is_speech = ((weighted > g_thr) | torch.any(llr > l_thr, dim=-1)) \
            & (tot[:, t] > _MIN_ENERGY_DB)
        decisions.append(is_speech)
        margins.append(torch.stack([torch.abs(weighted - g_thr),
                                    torch.abs(peak - l_thr)], dim=-1))
        if not adapt:
            continue
        min_track = torch.minimum(st.min_track * 0.998 + 0.002 * e, e)
        nm, ns = _update(e, st.noise_mean, st.noise_std,
                         torch.where(is_speech, 0.0, 0.05)[:, None, None])
        sm, ss = _update(e, st.speech_mean, st.speech_std,
                         torch.where(is_speech, 0.05, 0.0)[:, None, None])
        nm = torch.minimum(nm, (min_track + 6.0)[..., None])
        sm = torch.maximum(sm, torch.amax(nm, dim=-1, keepdim=True) + 4.0)
        st = GmmVadState(nm, ns, sm, ss, min_track)
    B, T = tot.shape
    if not T:
        return (torch.zeros((B, 0), dtype=torch.bool, device=tot.device), st,
                torch.zeros((B, 0, 2), device=tot.device))
    return torch.stack(decisions, 1), st, torch.stack(margins, 1)


def _check_rows(energies, tot, states, mode) -> None:
    if mode not in GMM_THRESHOLDS:
        raise ValueError(f"invalid aggressiveness mode: {mode}")
    if energies.ndim != 3 or energies.shape[2] != _N_BANDS \
            or energies.dtype != torch.float32:
        raise ValueError(f"energies must be (B, T, 6) float32, got "
                         f"{energies.dtype} {tuple(energies.shape)}")
    B, T = energies.shape[:2]
    if tot.shape != (B, T) or tot.dtype != torch.float32:
        raise ValueError(f"total_db must be ({B}, {T}) float32, got "
                         f"{tot.dtype} {tuple(tot.shape)}")
    if states.shape != (B, GMM_STATE_SLOTS) or states.dtype != torch.float32:
        raise ValueError(f"states must be ({B}, {GMM_STATE_SLOTS}) float32, "
                         f"got {states.dtype} {tuple(states.shape)}")
    if not (energies.device == tot.device == states.device):
        raise ValueError(f"energies on {energies.device}, total_db on "
                         f"{tot.device}, states on {states.device}")


def gmm_vad_rows_plain(energies: torch.Tensor, tot: torch.Tensor,
                       states: torch.Tensor, mode: int = 3,
                       adapt: bool = True, with_margins: bool = False):
    """The plain version of ``gmm_vad_rows`` (``_scan``, all rows at once)
    on the tensors' device; with ``with_margins`` the margins ``(B, T, 2)``
    follow."""
    _check_rows(energies, tot, states, mode)
    g_thr, l_thr = GMM_THRESHOLDS[mode]
    dec, st, margins = _scan(energies, tot, state_from_rows(states), g_thr,
                             l_thr, adapt)
    out = (dec, state_rows(st))
    return out + (margins,) if with_margins else out


def gmm_vad_rows(energies: torch.Tensor, tot: torch.Tensor,
                 states: torch.Tensor, mode: int = 3, adapt: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The adaptation scan of ``B`` streams: band energies ``(B, T, 6)``,
    frame energies ``(B, T)`` (``total_db``) and state rows ``(B, 54)``
    (``state_rows``), all float32 -> (decisions ``(B, T)`` bool, final state
    rows ``(B, 54)``, new tensors).  CUDA tensors launch G1; CPU tensors
    take the plain version."""
    if energies.device.type == "cpu":
        return gmm_vad_rows_plain(energies, tot, states, mode, adapt)
    if energies.device.type != "cuda":
        raise ValueError(f"gmm_vad_rows: unsupported device "
                         f"{energies.device}")
    from mmla_audio_torch._build import cuda_library

    _check_rows(energies, tot, states, mode)
    B, T = tot.shape
    energies, tot, states = (a.contiguous() for a in (energies, tot, states))
    decisions = torch.empty((B, T), dtype=torch.uint8, device=tot.device)
    out = torch.empty_like(states)
    if B == 0:
        return decisions.view(torch.bool), out
    g_thr, l_thr = GMM_THRESHOLDS[mode]
    launch = cuda_library("gmm_vad").gmm_vad_launch
    with torch.cuda.device(tot.device):
        stream = torch.cuda.current_stream(tot.device).cuda_stream
        err = launch(energies.data_ptr(), tot.data_ptr(), states.data_ptr(),
                     B, T, g_thr, l_thr, int(adapt), decisions.data_ptr(),
                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gmm_vad kernel launch failed (cudaError {err})")
    gmm_vad_rows.launches += 1
    # G1 writes 0 or 1 a byte: the bool view is the same bits
    return decisions.view(torch.bool), out


gmm_vad_rows.launches = 0


def _signal(x, state: GmmVadState) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x, np.float32)).to(state.min_track.device)
    if x.ndim != 1:
        raise ValueError(f"gmm_vad: one window (n,), got {tuple(x.shape)}")
    if x.device != state.min_track.device:
        raise ValueError(f"gmm_vad: the signal on {x.device}, the state on "
                         f"{state.min_track.device}")
    return x.to(torch.float32)


def gmm_vad_plain(x, state: GmmVadState, *, aggressiveness: int = 3,
                  frame_len: int = 480, adapt: bool = True
                  ) -> tuple[torch.Tensor, GmmVadState]:
    """``gmm_vad`` through the plain frame loop, on the signal's device."""
    x = _signal(x, state)
    rows = state_rows(state)[None]
    dec, out = gmm_vad_rows_plain(band_log_energies(x, frame_len)[None],
                                  total_db(x, frame_len)[None], rows,
                                  aggressiveness, adapt)
    return dec[0], state_from_rows(out[0])


def gmm_vad(x, state: GmmVadState, *, aggressiveness: int = 3,
            frame_len: int = 480, adapt: bool = True
            ) -> tuple[torch.Tensor, GmmVadState]:
    """Per-frame speech decisions of one window.

    ``x``: int16-scale signal ``(n,)`` on the state's device.  Returns
    (decisions ``(T,)`` bool, final state); thread the state across windows
    for a long-lived detector, or re-pass the calibrated state for
    per-window independence.  A CUDA signal launches G1 with one row, a CPU
    signal takes the plain loop."""
    x = _signal(x, state)
    if x.device.type == "cpu":
        return gmm_vad_plain(x, state, aggressiveness=aggressiveness,
                             frame_len=frame_len, adapt=adapt)
    dec, out = gmm_vad_rows(band_log_energies(x, frame_len)[None],
                            total_db(x, frame_len)[None],
                            state_rows(state)[None], aggressiveness, adapt)
    return dec[0], state_from_rows(out[0])
