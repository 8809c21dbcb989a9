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

On the card one launch of G1, the kernel of ``csrc/gmm_vad.cu``, takes a
batch of windows from their samples to their decisions and final state
rows: the filterbank and the energies in shared memory, then the
adaptation scan (``gmm_vad_windows``; ``window_log_energies`` runs the same
launch without the scan, for ``gmm_init_from_noise``).  Its chunk schedule
is ``g1_plan``.  The plain versions, which CPU tensors take and the tests
hold G1 against, are ``band_log_energies`` (each FIR an unfold-and-sum),
``total_db`` and the frame loop of the JAX package's ``lax.scan``, step for
step, in torch ops (``_scan``; about 60 small operations a frame).
``gmm_vad_rows`` runs the scan alone from given energies (G1's second
entry on the card, the plain loop on the CPU), one state row a stream
(``state_rows``).

G1 runs the update with the same IEEE operations in the same order as
``_scan`` (no contraction into FMAs), so given the same energies and
decisions its state is the plain loop's bit for bit; the decisions can
differ only where ``logf``/``expf`` round differently, i.e. at a threshold
margin of a few ulps (``_scan`` returns the margins).  Its energies are an
fp32 filterbank summed in another order than the plain version's, within
1e-3 dB where a band is within 40 dB of its frame's energy.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["GmmVadState", "GMM_THRESHOLDS", "GMM_STATE_SLOTS",
           "band_log_energies", "g1_cluster", "g1_plan",
           "gmm_init_from_noise", "gmm_vad", "gmm_vad_rows",
           "gmm_vad_rows_plain", "gmm_vad_windows", "gmm_vad_windows_plain",
           "state_rows", "state_from_rows", "total_db",
           "window_log_energies"]

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


# G1's chunk schedule: every window cut into chunks of about
# G1_CHUNK_SAMPLES input samples (16 frames of 480), each CTA's span of
# frames (a cluster of up to G1_MAX_CLUSTER CTAs splits a window of at most
# G1_CLUSTER_FRAMES frames) walked chunk by chunk.  Eight ranges a chunk,
# one a group of signals computed together (csrc/gmm_vad.cu): x, x8, (hp24,
# lp02), (b23, b34), (b12, lp01), (b051, lp005), (b0205, lp0025), b008.
G1_CHUNK_SAMPLES = 7680
G1_MAX_CLUSTER = 8
G1_CLUSTER_FRAMES = 512
G1_SMEM_BYTES = 227 * 1024
G1_ROW_INTS = 32            # a plan row: f0, f1, start, keep[8], clo[8], hi[8]
_G1_PAD = 32                # floats past a buffer's range (a thread's tail)
_G1_GROUPS = 8
_G1_BUFFER_GROUP = (0, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7)
_G1_E_STRIDE = 8            # floats a frame in the kernel's energies
_G1_ADAPT, _G1_SCAN = 1, 2
_HIST = 2 * (_FIR_TAPS - 1)
# the upper, lower and 80 Hz taps, reversed, as G1's parameters
_G1_TAPS = np.concatenate([_R_UPPER, _R_LOWER, _R_HP80]).astype(np.float32)
_G1_TAPS_PTR = _G1_TAPS.ctypes.data


def _g1_ranges(f0: int, f1: int, prev, frame_len: int) -> tuple:
    """(keep, clo, hi) of the eight groups for frames ``[f0, f1)``: hi one
    past the last index the chunk needs, clo the first it computes, keep
    the first it holds (a split reads its parent from ``2 clo - 126``, the
    80 Hz FIR from ``clo - 63``, a band frame from its first sample; kept
    indices are even, so a split reads its parent's pairs aligned).  With
    ``prev``, the last chunk's ranges, the chunk continues a span and
    computes from the last chunk's ``hi``; without, it starts one and
    computes its whole range (indices below 0 are the left padding's
    zeros)."""
    m8, m16, m32 = frame_len // 8, frame_len // 16, frame_len // 32
    keep, clo, hi = [0] * _G1_GROUPS, [0] * _G1_GROUPS, [0] * _G1_GROUPS

    def put(g, h, needs):
        if prev is None:
            k = min(needs) & ~1
            c = max(k, 0)
        else:
            c = prev[2][g]
            k = min([c] + needs) & ~1
        keep[g], clo[g], hi[g] = k, c, h

    half = _FIR_TAPS - 1
    put(7, f1 * m32, [f0 * m32])
    put(6, f1 * m32, [f0 * m32, clo[7] - half])
    put(5, max(f1 * m16, 2 * hi[6]), [f0 * m16, 2 * clo[6] - _HIST])
    put(4, max(f1 * m8, 2 * hi[5]), [f0 * m8, 2 * clo[5] - _HIST])
    put(3, f1 * m8, [f0 * m8])
    put(2, max(2 * hi[3], 2 * hi[4]), [2 * clo[3] - _HIST,
                                       2 * clo[4] - _HIST])
    put(1, 2 * hi[2], [2 * clo[2] - _HIST])
    put(0, max(2 * hi[1], f1 * frame_len), [2 * clo[1] - _HIST,
                                            f0 * frame_len])
    return keep, clo, hi


def g1_cluster(batch: int, frames: int) -> int:
    """CTAs a stream: a cluster splits each window's frames where the batch
    leaves SMs idle (8 up to B=8, 4 up to 16, 2 up to 64; on the H100 at
    B=64 a cluster of 2 took 0.089 ms against one CTA's 0.121), one CTA a
    stream otherwise and for windows over ``G1_CLUSTER_FRAMES`` frames."""
    if frames == 0 or frames > G1_CLUSTER_FRAMES:
        return 1
    k = 8 if batch <= 8 else 4 if batch <= 16 else 2 if batch <= 64 else 1
    return min(k, frames)


@functools.lru_cache(maxsize=64)
def g1_plan(n: int, frame_len: int = 480, cluster: int = 1) -> dict:
    """G1's schedule for windows of ``n`` samples: ``rows`` (int32, one
    ``G1_ROW_INTS`` row a chunk: f0, f1, start, keep[8], clo[8], hi[8]),
    ``rank_rows`` (each cluster rank's rows), ``chunk_frames``, each
    buffer's float ``offsets`` in shared memory and ``caps``, ``e_off``,
    ``smem_bytes`` and the kernel's ``layout`` ints.  The same for every
    stream.  Raises where a window's chunk would not fit in shared memory.
    """
    if frame_len < 32:
        raise ValueError(f"G1 needs frame_len >= 32 (a sample of the "
                         f"500 Hz bands a frame), got {frame_len}")
    if not 1 <= cluster <= G1_MAX_CLUSTER:
        raise ValueError(f"cluster must be 1 to {G1_MAX_CLUSTER}")
    T = n // frame_len
    F = max(1, -(-G1_CHUNK_SAMPLES // frame_len))
    span = -(-T // cluster) if T else 0
    while True:
        rows, rank_rows, ok = [], [0], True
        for r in range(cluster):
            prev = None
            for f0 in range(r * span, min((r + 1) * span, T), F):
                f1 = min(f0 + F, (r + 1) * span, T)
                cur = _g1_ranges(f0, f1, prev, frame_len)
                if prev is not None:
                    for g in range(_G1_GROUPS):
                        shift = cur[0][g] - prev[0][g]
                        # the carry copies forward in one pass
                        ok &= shift >= 0 and (
                            shift == 0 or cur[1][g] - cur[0][g] <= shift)
                rows.append([f0, f1, int(prev is None)] + cur[0] + cur[1]
                            + cur[2])
                prev = cur
            rank_rows.append(len(rows))
        if ok:
            break
        F *= 2                       # a longer chunk carries less than it moves
    caps = [0] * _G1_GROUPS
    for row in rows:
        for g in range(_G1_GROUPS):
            caps[g] = max(caps[g], row[3 + 2 * _G1_GROUPS + g] - row[3 + g])
    offsets, at = [], 0
    for b, g in enumerate(_G1_BUFFER_GROUP):
        offsets.append(at)
        at += -(-(caps[g] + _G1_PAD) // 4) * 4
    e_frames = 2 * F if cluster == 1 else T
    smem = 4 * (at + e_frames * _G1_E_STRIDE)
    if smem > G1_SMEM_BYTES:
        raise ValueError(f"G1: {smem} bytes of shared memory for n={n}, "
                         f"frame_len={frame_len}, cluster={cluster}")
    table = np.zeros((len(rows), G1_ROW_INTS), np.int32)
    if rows:
        table[:, :len(rows[0])] = rows
    rank_rows += [len(rows)] * (G1_MAX_CLUSTER + 1 - len(rank_rows))
    layout = np.asarray(offsets + [at, cluster, F] + rank_rows, np.int32)
    return dict(rows=table, rank_rows=rank_rows, chunk_frames=F,
                offsets=offsets, caps=caps, e_off=at, smem_bytes=smem,
                layout=layout)


@functools.lru_cache(maxsize=64)
def _g1_device_plan(n: int, frame_len: int, cluster: int,
                    device: torch.device) -> tuple:
    """(the plan's rows on ``device``, its layout ints, their address,
    shared-memory bytes): the tuple holds the array the address points
    into."""
    plan = g1_plan(n, frame_len, cluster)
    rows = torch.from_numpy(plan["rows"]).to(device)
    layout = plan["layout"]
    return rows, layout, layout.ctypes.data, plan["smem_bytes"]


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
    spread, the speech components at +12 and +24 dB; on ``device`` (the
    band energies from G1 on the card, from the plain filterbank on the
    CPU)."""
    x = torch.from_numpy(np.asarray(noise_i16, np.float32)).to(device)
    e = window_log_energies(x[None], frame_len)[0][0].cpu().numpy()  # (T, 6)
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
    rows ``(B, 54)``, new tensors).  CUDA tensors launch G1's scan alone
    (a warp a stream, the energies staged in shared memory); CPU tensors
    take the plain version."""
    if energies.device.type == "cpu":
        return gmm_vad_rows_plain(energies, tot, states, mode, adapt)
    if energies.device.type != "cuda":
        raise ValueError(f"gmm_vad_rows: unsupported device "
                         f"{energies.device}")
    from mmla_audio_torch._build import cuda_library
    from mmla_audio_torch.ops.cuda_denoise import _launch

    _check_rows(energies, tot, states, mode)
    B, T = tot.shape
    energies, tot, states = (a.contiguous() for a in (energies, tot, states))
    decisions = torch.empty((B, T), dtype=torch.uint8, device=tot.device)
    out = torch.empty_like(states)
    if B == 0:
        return decisions.view(torch.bool), out
    g_thr, l_thr = GMM_THRESHOLDS[mode]
    _launch("gmm_vad", tot, cuda_library("gmm_vad").gmm_vad_launch,
            energies.data_ptr(), tot.data_ptr(), states.data_ptr(), B, T,
            g_thr, l_thr, int(adapt), decisions.data_ptr(), out.data_ptr())
    gmm_vad_rows.launches += 1
    # G1 writes 0 or 1 a byte: the bool view is the same bits
    return decisions.view(torch.bool), out


gmm_vad_rows.launches = 0


def _check_windows(x, states, mode, frame_len) -> None:
    if mode not in GMM_THRESHOLDS:
        raise ValueError(f"invalid aggressiveness mode: {mode}")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"windows must be (B, n) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if states is not None and (
            states.shape != (x.shape[0], GMM_STATE_SLOTS)
            or states.dtype != torch.float32 or states.device != x.device):
        raise ValueError(f"states must be ({x.shape[0]}, {GMM_STATE_SLOTS}) "
                         f"float32 on {x.device}, got {states.dtype} "
                         f"{tuple(states.shape)} on {states.device}")
    if frame_len < 1:
        raise ValueError(f"frame_len must be positive, got {frame_len}")


def _g1(x, states, mode, adapt, frame_len, scan: bool, energies: bool):
    """One launch of G1 over windows ``x (B, n)`` on the card: (decisions,
    state rows) with ``scan``, then (band energies, frame energies) with
    ``energies``, each None where not asked for."""
    from mmla_audio_torch._build import cuda_library
    from mmla_audio_torch.ops.cuda_denoise import _launch

    if x.device.type != "cuda":
        raise ValueError(f"G1: unsupported device {x.device}")
    B, n = x.shape
    T = n // frame_len
    dev = x.device
    rows, _, layout, smem = _g1_device_plan(n, frame_len, g1_cluster(B, T),
                                            dev)
    dec = torch.empty((B, T), dtype=torch.uint8, device=dev) if scan \
        else None
    out = torch.empty_like(states) if scan else None
    bands = torch.empty((B, T, _N_BANDS), device=dev) if energies else None
    tot = torch.empty((B, T), device=dev) if energies else None
    if B:
        x = x.contiguous()
        states = states.contiguous() if scan else None
        g_thr, l_thr = GMM_THRESHOLDS[mode]
        flags = (_G1_SCAN if scan else 0) | (_G1_ADAPT if adapt else 0)
        ptr = lambda t: 0 if t is None or not t.numel() \
            else t.data_ptr()                                 # noqa: E731
        _launch("gmm_vad", x,
                cuda_library("gmm_vad").gmm_vad_windows_launch,
                x.data_ptr(), n, B, T, frame_len, ptr(rows), layout,
                _G1_TAPS_PTR, smem, ptr(states), g_thr, l_thr, flags,
                ptr(dec), ptr(out), ptr(bands), ptr(tot))
    # G1 writes 0 or 1 a byte: the bool view is the same bits
    return (None if dec is None else dec.view(torch.bool)), out, bands, tot


def gmm_vad_windows_plain(x: torch.Tensor, states: torch.Tensor,
                          mode: int = 3, adapt: bool = True,
                          frame_len: int = 480, with_energies: bool = False):
    """The plain version of ``gmm_vad_windows`` on the tensors' device:
    ``band_log_energies``, ``total_db`` and ``_scan``."""
    _check_windows(x, states, mode, frame_len)
    e, tot = band_log_energies(x, frame_len), total_db(x, frame_len)
    dec, out = gmm_vad_rows_plain(e, tot, states, mode, adapt)
    return (dec, out, e, tot) if with_energies else (dec, out)


def gmm_vad_windows(x: torch.Tensor, states: torch.Tensor, mode: int = 3,
                    adapt: bool = True, frame_len: int = 480,
                    with_energies: bool = False):
    """The GMM VAD of ``B`` windows: samples ``(B, n)`` (int16 scale) and
    state rows ``(B, 54)`` (``state_rows``), float32 -> (decisions ``(B,
    T)`` bool, final state rows ``(B, 54)``), ``T = n // frame_len``; with
    ``with_energies`` also the band energies ``(B, T, 6)`` and frame
    energies ``(B, T)`` the scan read.  CUDA tensors launch G1 once (no
    filterbank op; ``frame_len`` from 32 to about 20,000 samples, so that
    a frame's chunk fits in shared memory: ``g1_plan`` raises beyond);
    CPU tensors take the plain version."""
    _check_windows(x, states, mode, frame_len)
    if x.device.type == "cpu":
        return gmm_vad_windows_plain(x, states, mode, adapt, frame_len,
                                     with_energies)
    dec, out, bands, tot = _g1(x, states, mode, adapt, frame_len, True,
                               with_energies)
    gmm_vad_windows.launches += bool(len(x))
    return (dec, out, bands, tot) if with_energies else (dec, out)


gmm_vad_windows.launches = 0


def window_log_energies(x: torch.Tensor, frame_len: int = 480
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows ``(B, n)`` float32 -> (band log energies ``(B, T, 6)``, frame
    energies ``(B, T)``).  CUDA tensors launch G1 without its scan; CPU
    tensors take ``band_log_energies`` and ``total_db``."""
    _check_windows(x, None, 3, frame_len)
    if x.device.type == "cpu":
        return band_log_energies(x, frame_len), total_db(x, frame_len)
    _, _, bands, tot = _g1(x, None, 3, False, frame_len, False, True)
    window_log_energies.launches += bool(len(x))
    return bands, tot


window_log_energies.launches = 0


def _signal(x, state: GmmVadState) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x, np.float32)).to(state.min_track.device)
    if x.ndim != 1:
        raise ValueError(f"gmm_vad: one window (n,), got {tuple(x.shape)}")
    if x.device != state.min_track.device:
        raise ValueError(f"gmm_vad: the signal on {x.device}, the state on "
                         f"{state.min_track.device}")
    return x.to(torch.float32)


def gmm_vad(x, state: GmmVadState, *, aggressiveness: int = 3,
            frame_len: int = 480, adapt: bool = True
            ) -> tuple[torch.Tensor, GmmVadState]:
    """Per-frame speech decisions of one window.

    ``x``: int16-scale signal ``(n,)`` on the state's device.  Returns
    (decisions ``(T,)`` bool, final state); thread the state across windows
    for a long-lived detector, or re-pass the calibrated state for
    per-window independence.  A CUDA signal launches G1 once (samples to
    decisions), a CPU signal takes the plain filterbank and frame loop
    (``gmm_vad_windows``)."""
    x = _signal(x, state)
    dec, out = gmm_vad_windows(x[None], state_rows(state)[None],
                               aggressiveness, adapt, frame_len)
    return dec[0], state_from_rows(out[0])
