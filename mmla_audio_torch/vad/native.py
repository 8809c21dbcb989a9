"""Host-native webrtcvad through ctypes (counterpart of
``mmla_audio_tpu.vad.native``).

The engine is the JAX package's C++ transcription of ``webrtcvad.Vad``,
copied unchanged to ``mmla_audio_torch/csrc/host/webrtcvad.cpp`` and
bit-identical to the golden in ``tests/golden/webrtc_vad_ref.py``.  ``_build.host_library`` compiles it into
the port's own build directory.  The filterbank is a sample-serial int16 IIR
cascade, so a single stream runs it on the host.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess

import numpy as np

from mmla_audio_torch._build import host_library

__all__ = ["native_available", "NativeWebRtcVad"]


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured library, or None when it cannot be built or loaded."""
    try:
        lib = host_library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.wv_create.restype = ctypes.c_void_p
    lib.wv_create.argtypes = [ctypes.c_int]
    lib.wv_destroy.argtypes = [ctypes.c_void_p]
    lib.wv_set_mode.restype = ctypes.c_int
    lib.wv_set_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wv_process.restype = ctypes.c_int64
    lib.wv_process.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    return lib


def native_available() -> bool:
    return _lib() is not None


class NativeWebRtcVad:
    """``webrtcvad.Vad``-compatible detector backed by the C++ engine; the
    detector state lives as long as the object, like the reference's
    module-level ``Vad(3)``."""

    def __init__(self, mode: int = 3):
        if mode not in (0, 1, 2, 3):
            raise ValueError(f"invalid aggressiveness mode: {mode}")
        lib = _lib()
        if lib is None:
            raise RuntimeError("native webrtcvad unavailable "
                               "(libmmla_host.so failed to build or load)")
        self._lib = lib
        self.mode = mode
        self._inst = lib.wv_create(mode)
        if not self._inst:
            raise RuntimeError("wv_create failed")

    def __del__(self):
        inst = getattr(self, "_inst", None)
        if inst:
            self._lib.wv_destroy(inst)
            self._inst = None

    def decisions(self, x_i16, frame_len: int = 480,
                  sample_rate: int = 16000) -> np.ndarray:
        """Per-frame speech decisions over all complete frames of ``x``,
        advancing the held state.  Returns a bool array of n // frame_len."""
        x = np.ascontiguousarray(np.asarray(x_i16), dtype=np.int16)
        n_frames = x.shape[-1] // frame_len
        out = np.zeros(max(n_frames, 1), np.uint8)
        got = self._lib.wv_process(
            self._inst, x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            n_frames * frame_len, frame_len, sample_rate,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if got < 0:
            raise ValueError(
                f"invalid frame length {frame_len} @ {sample_rate} Hz")
        return out[:n_frames].astype(bool)
