"""Inputs made from the seed: the model weights, the conversations and the
ambient noise.  The program receives only what is made here.

* ``weights``: a state dict for a ``param_spec`` (``perfbench/reference``),
  drawn on the device by one ``torch.Generator`` in two calls (a normal and
  a uniform draw over every parameter at once), then cut into leaves:
  kernels ``N(0, 2 / (fan_in + fan_out))``, biases and shifts ``N(0, 0.01)``,
  BatchNorm scales and variances ``U(0.5, 2)``.
* ``voice``: syllables of six harmonics of a gliding pitch between short
  pauses, the voice's pitch and harmonic weights drawn from its speaker.
* ``ambient``: four profiles of room noise (white, low-passed, mains hum
  with noise, a murmur of filtered noise), each a level and a shape.
* ``conversations``: a pool of recordings, each 1-3 voices that speak in
  turns with pauses and overlapped stretches, over one ambient profile; a
  stream plays one of them from an offset, wrapping around.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["rng", "weights", "voice", "ambient", "Pool", "conversations"]

SR = 16_000
PROFILES = ("white", "lowpass", "hum", "murmur")


def rng(seed: int, *salt: int) -> np.random.Generator:
    """The generator of ``seed`` for one purpose (``salt``)."""
    return np.random.default_rng([int(seed) % (2 ** 63), *salt])


def weights(spec, seed: int, device) -> dict:
    """A state dict for ``spec`` (``name -> (shape, kind)``) on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    sizes = [int(np.prod(shape)) for shape, _ in spec.values()]
    total = sum(sizes)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for (name, (shape, kind)), n in zip(spec.items(), sizes):
        z, u = normal[at: at + n], uniform[at: at + n]
        at += n
        if kind == "kernel":
            fan = int(np.prod(shape[1:])) + shape[0]
            leaf = z * float(np.sqrt(2.0 / fan))
        elif kind in ("bias", "shift"):
            leaf = z * 0.1
        elif kind in ("scale", "var"):
            leaf = 0.5 + 1.5 * u
        elif kind == "zero":
            leaf = torch.zeros_like(z)
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = leaf.reshape(shape).clone()
    return out


def voice(seconds: float, speaker: int, r: np.random.Generator) -> np.ndarray:
    """Float speech of one voice, peak 1."""
    spk = np.random.default_rng([1000, speaker])
    f0, amps = spk.uniform(90.0, 300.0), spk.uniform(0.1, 1.0, 6)
    n = int(seconds * SR)
    out = np.zeros(n)
    i = 0
    while i < n:
        k = int(r.uniform(0.15, 0.45) * SR)
        pitch = f0 * r.uniform(0.9, 1.1) * (1 + 0.08 * np.linspace(-1, 1, k))
        phase = 2 * np.pi * np.cumsum(pitch) / SR
        harm = np.sin(np.outer(np.arange(1, 7), phase))
        syllable = np.hanning(k) * (amps @ harm)
        out[i:i + k] = syllable[: n - i]
        i += k + int(r.uniform(0.05, 0.25) * SR)
    return out / max(np.abs(out).max(), 1e-9)


def ambient(profile: int, seconds: float, level: float,
            r: np.random.Generator) -> np.ndarray:
    """Float room noise of one profile at RMS ``level`` (int16 units)."""
    n = int(seconds * SR)
    x = r.standard_normal(n)
    kind = PROFILES[profile % len(PROFILES)]
    if kind == "lowpass":
        x = np.convolve(x, np.ones(8) / 8, mode="same")
    elif kind == "hum":
        t = np.arange(n) / SR
        x = 0.3 * x + sum(np.sin(2 * np.pi * f * t) / h
                          for h, f in enumerate((50, 100, 150), start=1))
    elif kind == "murmur":
        x = np.convolve(x, np.hanning(64), mode="same")
        x *= 1 + 0.5 * np.sin(2 * np.pi * 0.7 * np.arange(n) / SR)
    return x / x.std() * level


@dataclass
class Pool:
    """Recordings a stream plays from: ``audio (P, L)`` int16, the ambient
    profile of each, and each profile's 10 s calibration clip."""

    audio: np.ndarray
    profile: np.ndarray
    noise: list

    def samples(self, entry: int, start: int, n: int) -> np.ndarray:
        """``n`` samples of recording ``entry`` from ``start``, wrapping."""
        row = self.audio[entry]
        L = row.shape[0]
        a = start % L
        if a + n <= L:
            return row[a: a + n]
        return np.concatenate([row[a:], np.resize(row, a + n - L)])


def conversations(seed: int, count: int, seconds: float,
                  profiles: int = 4) -> Pool:
    """A pool of ``count`` conversations of ``seconds`` each."""
    n = int(seconds * SR)
    audio = np.empty((count, n), np.int16)
    levels = [20.0, 35.0, 15.0, 30.0]
    noise = [np.clip(ambient(p, 10.0, levels[p], rng(seed, 1, p)),
                     -32768, 32767).astype(np.int16) for p in range(profiles)]
    kinds = np.arange(count) % profiles
    for c in range(count):
        r = rng(seed, 2, c)
        mix = np.zeros(n)
        for v in range(int(r.integers(1, 4))):
            track = voice(seconds, int(r.integers(0, 64)), r)
            # turns: the voice speaks in stretches of 1-4 s between pauses
            # of 0.5-3 s, so voices overlap where their stretches meet
            gate = np.zeros(n)
            i = int(r.uniform(0.0, 2.0) * SR)
            while i < n:
                k = int(r.uniform(1.0, 4.0) * SR)
                gate[i: i + k] = 1.0
                i += k + int(r.uniform(0.5, 3.0) * SR)
            mix += track * gate * r.uniform(4000.0, 12000.0)
        mix += ambient(int(kinds[c]), seconds, levels[kinds[c]], r)
        audio[c] = np.clip(np.round(mix), -32768, 32767).astype(np.int16)
    return Pool(audio, kinds, noise)
