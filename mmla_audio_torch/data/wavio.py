"""PCM16 WAV IO on the stdlib ``wave`` module (counterpart of
``mmla_audio_tpu.data.wavio``): mono, 16-bit, rate in {8, 16, 32, 48} kHz."""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

__all__ = ["read_wav", "read_wav_float", "write_wav"]

VALID_RATES = (8000, 16000, 32000, 48000)


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a PCM16 WAV -> (int16 samples, sample_rate); multi-channel files
    keep channel 0."""
    with wave.open(str(path), "rb") as wf:
        n_ch = wf.getnchannels()
        if wf.getsampwidth() != 2:
            raise ValueError(f"{path}: 16-bit PCM required "
                             f"(sampwidth={wf.getsampwidth()})")
        rate = wf.getframerate()
        if rate not in VALID_RATES:
            raise ValueError(f"{path}: unsupported rate {rate}")
        raw = wf.readframes(wf.getnframes())
    data = np.frombuffer(raw, dtype=np.int16)
    if n_ch > 1:
        data = data.reshape(-1, n_ch)[:, 0]
    return data.copy(), rate


def read_wav_float(path) -> tuple[np.ndarray, int]:
    """``librosa.load(sr=None)``'s convention: the int16 samples as float32
    in [-1, 1) (/ 32768), and the file's rate."""
    data, rate = read_wav(path)
    return data.astype(np.float32) / 32768.0, rate


def write_wav(path, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono PCM16.  Accepts int16, or float in [-1, 1] (scaled)."""
    samples = np.asarray(samples)
    if samples.ndim != 1:
        raise ValueError(f"write_wav expects mono 1-D samples, "
                         f"got shape {samples.shape}")
    if samples.dtype != np.int16:
        samples = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(samples.tobytes())
