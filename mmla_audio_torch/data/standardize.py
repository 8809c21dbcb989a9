"""Audio standardization + fixed-stride segmentation, the post-time front door
(counterpart of ``mmla_audio_tpu.data.standardize``).

``standardize_audio`` reproduces the reference's effective behavior
(`overlap_detection_post_processing.py:101-148` /
`speaker_identification_post_processing.py:136-188`): resample to 16 kHz,
optional dBFS gain, N stationary-denoise passes against the session noise
profile (``ops.denoise``, on ``device``), optional VAD trim
(``vad.collector`` with the native webrtcvad engine or the energy detector).

``segment_signal`` is the reference's ``segmentation`` (`…:23-85`): fixed
windows of ``win_time`` seconds every ``step_time`` seconds,
``cut_num = int((n - win) / step + 1)`` (remainder dropped).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch

from mmla_audio_torch.core.config import DenoiseConfig, VadConfig
from mmla_audio_torch.ops.denoise import noise_threshold, reduce_noise
from mmla_audio_torch.vad import collector as vadc

__all__ = ["resample", "apply_gain_dbfs", "standardize_audio", "segment_signal"]


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample (ffmpeg/pydub set_frame_rate equivalent)."""
    if sr_in == sr_out:
        return y
    g = math.gcd(sr_in, sr_out)
    return scipy.signal.resample_poly(y.astype(np.float64),
                                      sr_out // g, sr_in // g)


def apply_gain_dbfs(y: np.ndarray, target_dbfs: float) -> np.ndarray:
    """pydub: gain = target_dBFS - current_dBFS; dBFS = 20 log10(rms / 2^15)."""
    rms = np.sqrt(np.mean(np.square(y.astype(np.float64))))
    if rms <= 0:
        return y
    current = 20.0 * np.log10(rms / 32768.0)
    gain = target_dbfs - current
    return y * (10.0 ** (gain / 20.0))


def _as_float(a: np.ndarray) -> np.ndarray:
    """int16 -> float32 / 32768; float passes through as float32."""
    return a.astype(np.float32) / 32768.0 if a.dtype == np.int16 \
        else a.astype(np.float32)


def standardize_audio(y: np.ndarray, sr: int, *, target_sr: int = 16_000,
                      dbfs: float | None = None,
                      noise: np.ndarray | None = None,
                      noise_passes: int = 0,
                      silence_remove: bool = False,
                      vad_threshold_db: float | None = None,
                      denoise_cfg: DenoiseConfig = DenoiseConfig(),
                      vad_cfg: VadConfig = VadConfig(),
                      vad=None,
                      device: torch.device | str = "cuda") -> np.ndarray:
    """Standardize one conversation/corpus recording.

    ``y``: int16 samples (or float [-1, 1], auto-detected).  Returns int16 @
    ``target_sr``.  ``noise``: ambient-noise clip at ``target_sr`` (int16 or
    float) for the denoise passes and VAD calibration.  The denoise runs on
    ``device``.

    With ``vad_cfg.decision == "webrtc"`` the trim's per-frame decisions come
    from the native webrtcvad engine; pass one
    :class:`~mmla_audio_torch.vad.native.NativeWebRtcVad` as ``vad`` across
    calls to reproduce the reference's shared long-lived detector (a fresh
    one per call is used otherwise).
    """
    y = np.asarray(y)
    yf = resample(_as_float(y), sr, target_sr).astype(np.float32)

    gain_db = 0.0
    if dbfs is not None:
        # pydub operates on int16-scale values.  (None disables; an explicit
        # 0 dBFS target is a legitimate full-scale normalization.)
        rms = float(np.sqrt(np.mean(np.square(yf * 32768.0)))) or 1.0
        gain_db = dbfs - 20.0 * np.log10(rms / 32768.0)
        yf = (apply_gain_dbfs(yf * 32768.0, dbfs) / 32768.0).astype(np.float32)

    if noise is not None and noise_passes > 0:
        thr = noise_threshold(torch.from_numpy(_as_float(noise)).to(device),
                              denoise_cfg)
        yf = reduce_noise(torch.from_numpy(yf).to(device), thr, denoise_cfg,
                          sr=target_sr, passes=noise_passes).cpu().numpy()

    out = np.clip(yf * 32768.0, -32768, 32767).astype(np.int16)

    if silence_remove:
        if vad_threshold_db is None:
            if noise is not None:
                ni = noise if noise.dtype == np.int16 else \
                    (noise * 32768.0).astype(np.int16)
                # the gated signal was gain-adjusted: shift the noise-derived
                # threshold by the same gain, or the energy scales disagree
                vad_threshold_db = vadc.calibrate_threshold(
                    ni, vad_cfg.aggressiveness) + float(gain_db)
            else:
                vad_threshold_db = 30.0
        frame_len = int(target_sr * vad_cfg.frame_ms / 1000)
        T = vadc.frame_count(len(out), frame_len)
        if T > 0:
            frames = out[: T * frame_len].reshape(T, frame_len)
            if vad_cfg.decision == "webrtc":
                from mmla_audio_torch.vad.native import NativeWebRtcVad

                engine = vad if vad is not None \
                    else NativeWebRtcVad(vad_cfg.aggressiveness)
                dec = engine.decisions(out[: T * frame_len], frame_len,
                                       target_sr)
            else:
                dec = vadc.energy_vad(torch.from_numpy(
                    frames.astype(np.float32)), vad_threshold_db)
            keep = vadc.collect_mask(dec, ring=vad_cfg.ring_frames).numpy()
            out = frames[keep].reshape(-1)
        else:
            out = out[:0]
    return out


def segment_signal(y: np.ndarray, sr: int, win_time: float, step_time: float
                   ) -> np.ndarray:
    """Fixed windows: ``(cut_num, win)`` with the reference's count formula."""
    win = int(sr * win_time)
    step = int(sr * step_time)
    if len(y) < win:
        return np.zeros((0, win), y.dtype)
    cut_num = int((len(y) - win) / step + 1)
    idx = np.arange(cut_num)[:, None] * step + np.arange(win)[None, :]
    return y[idx]
