"""Capture sources (counterpart of ``mmla_audio_tpu.streaming.capture``).

A source has one method the sessions need: blocking ``read(n) -> int16[n]``.
``FakePCMSource`` is a deterministic speech-like generator, ``ArraySource``
replays a buffer.  ``CaptureThread`` pumps a source into a ring buffer
(``streaming.native.make_ring``: the native SPSC ring where the host library
builds) so capture jitter never blocks the session loop;
``PrefilledCapture`` is a ring loaded with a whole replay up front.  With
native rings the multiplexer gathers all its streams' windows in one call.
``PyAudioSource`` is a microphone (it needs the ``pyaudio`` package and
raises at construction without it).  ``CaptureThread.suspend``/``resume``
are the edge runners' gate: the producer thread itself suspends and resumes
the source (`record_on_pi.py:139-159`).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from mmla_audio_torch.core.config import AudioConfig
from mmla_audio_torch.streaming.native import make_ring

__all__ = ["FakePCMSource", "ArraySource", "PyAudioSource", "CaptureThread",
           "PrefilledCapture"]


class FakePCMSource:
    """Deterministic speech-like PCM: tones with drifting pitch + noise, with
    silent gaps; optionally paced to real time.  The same seed gives the
    same samples as the JAX package's source."""

    def __init__(self, cfg: AudioConfig = AudioConfig(), seed: int = 0,
                 speech_ratio: float = 0.7, realtime: bool = False,
                 amplitude: int = 8000):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.realtime = realtime
        self.speech_ratio = speech_ratio
        self.amplitude = amplitude
        self._phase = 0.0
        self._freq = 200.0
        self._seg_left = 0
        self._speaking = True

    def read(self, n: int) -> np.ndarray:
        sr = self.cfg.sample_rate
        out = np.zeros(n, np.float64)
        i = 0
        while i < n:
            if self._seg_left <= 0:
                self._speaking = self.rng.rand() < self.speech_ratio
                self._seg_left = int(self.rng.uniform(0.3, 1.5) * sr)
                self._freq = self.rng.uniform(100, 1500)
            k = min(self._seg_left, n - i)
            if self._speaking:
                t = np.arange(k)
                phase = self._phase + 2 * np.pi * self._freq * t / sr
                out[i: i + k] = np.sin(phase) + 0.1 * self.rng.randn(k)
                self._phase = float(phase[-1] % (2 * np.pi))
            else:
                out[i: i + k] = 0.003 * self.rng.randn(k)
            i += k
            self._seg_left -= k
        if self.realtime:
            time.sleep(n / sr)
        return (out * self.amplitude).astype(np.int16)


class ArraySource:
    """Replay a prerecorded int16 buffer (zero-fill past the end)."""

    def __init__(self, samples: np.ndarray):
        self.samples = np.asarray(samples, np.int16)
        self.pos = 0

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.samples)

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.int16)
        k = min(n, max(len(self.samples) - self.pos, 0))
        if k:
            out[:k] = self.samples[self.pos: self.pos + k]
        self.pos += n
        return out


class PyAudioSource:
    """A microphone through PyAudio (int16 mono), with the reference's
    suspend/resume (`record_on_pi.py:139-159`).  Raises at construction
    when ``pyaudio`` is not installed."""

    def __init__(self, cfg: AudioConfig = AudioConfig(), device_index=None):
        import pyaudio

        self.cfg = cfg
        self._pa = pyaudio.PyAudio()
        self._kwargs = dict(
            format=pyaudio.paInt16, channels=cfg.channels,
            rate=cfg.sample_rate, input=True,
            frames_per_buffer=cfg.chunk_samples,
            input_device_index=device_index)
        self._stream = self._pa.open(**self._kwargs)

    def read(self, n: int) -> np.ndarray:
        data = self._stream.read(n, exception_on_overflow=False)
        return np.frombuffer(data, np.int16).copy()

    def suspend(self) -> None:
        self._stream.stop_stream()
        self._stream.close()

    def resume(self) -> None:
        self._stream = self._pa.open(**self._kwargs)

    def close(self) -> None:
        try:
            self._stream.stop_stream()
            self._stream.close()
        finally:
            self._pa.terminate()


class CaptureThread:
    """Producer thread: ``source.read(chunk)`` -> ring, until stopped or the
    source is exhausted.  ``drained`` turns true only after the final chunk
    is pushed; a source exception is kept in ``error`` (sessions re-raise
    it, so a microphone fault is told apart from a clean end).

    ``suspend()``/``resume()`` park and un-park the producer, which runs
    ``source.suspend()``/``source.resume()`` on its own thread (closing a
    PyAudio stream from another thread while the producer is blocked in
    ``read`` kills capture); a suspension clears the ring, so audio from
    before it is never classified after the resume."""

    def __init__(self, source, cfg: AudioConfig = AudioConfig(),
                 ring_seconds: float = 30.0):
        self.source = source
        self.cfg = cfg
        self.ring = make_ring(int(ring_seconds * cfg.sample_rate))
        self.drained = False
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._pause_req = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CaptureThread":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                if self._pause_req.is_set():
                    if hasattr(self.source, "suspend"):
                        self.source.suspend()
                    self.ring.clear()
                    self._paused.set()
                    while self._pause_req.is_set() and \
                            not self._stop.is_set():
                        time.sleep(0.005)
                    self._paused.clear()
                    if self._stop.is_set():
                        break
                    if hasattr(self.source, "resume"):
                        self.source.resume()
                    continue
                self.ring.push(self.source.read(self.cfg.chunk_samples))
                if getattr(self.source, "exhausted", False):
                    break
        except Exception as e:  # noqa: BLE001 — surfaced through self.error
            self.error = e
        finally:
            self.drained = True

    def suspend(self, timeout: float = 2.0) -> None:
        """Gate released: park the producer (it suspends the source on its
        own thread) and drop the buffered audio.  Callable before
        ``start()``: the producer then parks before its first read, so a
        capture created while the gate is released reads nothing."""
        self._pause_req.set()
        if self._thread is not None:
            self._paused.wait(timeout)

    def resume(self) -> None:
        """Gate pressed again: un-park the producer (it resumes the
        source)."""
        self._pause_req.clear()

    @property
    def suspended(self) -> bool:
        """True while a suspension is requested."""
        return self._pause_req.is_set()

    def read_window(self, n_samples: int, timeout: float = 10.0
                    ) -> Optional[np.ndarray]:
        """Block until a whole window is buffered; None on timeout or at the
        end of the source (a sub-window tail is dropped)."""
        deadline = time.monotonic() + timeout
        while True:
            out = self.ring.pop(n_samples)
            if out is not None:
                return out
            if self.drained and self.ring.available < n_samples:
                self.ring.clear()
                return None
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.001)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class PrefilledCapture:
    """A capture whose ring holds an entire replay from the start."""

    def __init__(self, samples: np.ndarray):
        samples = np.ascontiguousarray(samples, np.int16)
        self.ring = make_ring(len(samples))
        if self.ring.push(samples) != len(samples):
            raise RuntimeError("ring smaller than the replay")
        self.drained = True             # the producer has finished
        self.source = self
        self.exhausted = True

    def read_window(self, n_samples: int, timeout: float = 0.0
                    ) -> Optional[np.ndarray]:
        return self.ring.pop(n_samples)

    def stop(self) -> None:
        pass
