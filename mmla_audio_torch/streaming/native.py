"""Capture rings, the multiplexer's one-call window gather and the host
library's WAV IO (counterpart of ``mmla_audio_tpu.streaming.native``).

``load_native()`` is the port's ``libmmla_host.so`` with its ring and WAV
functions typed (``wav_read``, ``wav_free``, ``wav_write`` from
``csrc/host/wavio.cpp``), or None where it cannot be built or loaded.

``NativeRingBuffer`` is the lock-free SPSC int16 ring of
``csrc/host/ringbuffer.cpp`` in the port's ``libmmla_host.so``
(``_build.host_library``); ``PyRingBuffer`` is the same interface in
Python, for where the library cannot be built.  ``BatchGather`` polls many
native rings in one ``rb_pop_batch`` call and copies each ready window
straight into a row of the caller's int16 staging matrix.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import threading

import numpy as np

from mmla_audio_torch._build import host_library

__all__ = ["load_native", "NativeRingBuffer", "PyRingBuffer", "BatchGather",
           "make_ring"]

_I16P = ctypes.POINTER(ctypes.c_int16)


@functools.lru_cache(maxsize=None)
def load_native():
    """The host library with its ring and WAV functions typed, or None when
    it cannot be built or loaded."""
    try:
        lib = host_library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_uint64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    for name in ("rb_capacity", "rb_available", "rb_overruns",
                 "rb_underruns"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    for name in ("rb_push", "rb_pop", "rb_pop_upto"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p, _I16P, ctypes.c_uint64]
    lib.rb_clear.argtypes = [ctypes.c_void_p]
    lib.rb_pop_batch.restype = ctypes.c_uint64
    lib.rb_pop_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_uint64,
        _I16P, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32)]
    # wav_read(path, &samples, &rate) -> count (< 0 on any error); the
    # samples are the library's to free with wav_free
    lib.wav_read.restype = ctypes.c_int64
    lib.wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_I16P),
                             ctypes.POINTER(ctypes.c_int32)]
    lib.wav_free.restype = None
    lib.wav_free.argtypes = [_I16P]
    lib.wav_write.restype = ctypes.c_int32
    lib.wav_write.argtypes = [ctypes.c_char_p, _I16P, ctypes.c_int64,
                              ctypes.c_int32]
    return lib


class NativeRingBuffer:
    """SPSC int16 ring (capacity rounded up to a power of two) backed by the
    C++ implementation."""

    def __init__(self, capacity: int):
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native ring buffer unavailable "
                               "(libmmla_host.so failed to build or load)")
        self._ptr = self._lib.rb_create(capacity)
        if not self._ptr:
            raise MemoryError("rb_create failed")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.rb_destroy(self._ptr)
            self._ptr = None

    @property
    def capacity(self) -> int:
        return self._lib.rb_capacity(self._ptr)

    @property
    def available(self) -> int:
        return self._lib.rb_available(self._ptr)

    @property
    def overruns(self) -> int:
        return self._lib.rb_overruns(self._ptr)

    @property
    def underruns(self) -> int:
        return self._lib.rb_underruns(self._ptr)

    def push(self, samples) -> int:
        """Append what fits; the rest is dropped and counted in overruns."""
        samples = np.ascontiguousarray(samples, np.int16)
        return self._lib.rb_push(self._ptr, samples.ctypes.data_as(_I16P),
                                 len(samples))

    def pop(self, n: int):
        """``n`` samples, or None (nothing consumed) if fewer are buffered."""
        out = np.empty(n, np.int16)
        got = self._lib.rb_pop(self._ptr, out.ctypes.data_as(_I16P), n)
        return out if got == n else None

    def pop_upto(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int16)
        got = self._lib.rb_pop_upto(self._ptr, out.ctypes.data_as(_I16P), n)
        return out[:got]

    def clear(self) -> None:
        self._lib.rb_clear(self._ptr)


class PyRingBuffer:
    """The same ring in Python, lock-protected."""

    def __init__(self, capacity: int):
        cap = 1
        while cap < capacity:
            cap <<= 1
        self._buf = np.zeros(cap, np.int16)
        self._cap = cap
        self._head = 0
        self._tail = 0
        self.overruns = 0
        self.underruns = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def available(self) -> int:
        with self._lock:
            return self._head - self._tail

    def push(self, samples) -> int:
        samples = np.asarray(samples, np.int16)
        with self._lock:
            free = self._cap - (self._head - self._tail)
            n = min(len(samples), free)
            self.overruns += len(samples) - n
            pos = self._head & (self._cap - 1)
            first = min(n, self._cap - pos)
            self._buf[pos: pos + first] = samples[:first]
            self._buf[: n - first] = samples[first:n]
            self._head += n
            return n

    def pop(self, n: int):
        with self._lock:
            if self._head - self._tail < n:
                self.underruns += 1
                return None
            pos = self._tail & (self._cap - 1)
            first = min(n, self._cap - pos)
            out = np.empty(n, np.int16)
            out[:first] = self._buf[pos: pos + first]
            out[first:] = self._buf[: n - first]
            self._tail += n
            return out

    def pop_upto(self, n: int) -> np.ndarray:
        with self._lock:
            got = min(n, self._head - self._tail)
        return self.pop(got) if got else np.empty(0, np.int16)

    def clear(self) -> None:
        with self._lock:
            self._tail = self._head


class BatchGather:
    """One-call window gather across many native rings (``rb_pop_batch``).

    Holds the ring pointers and an active mask; ``pop_into`` polls every
    active ring once from a rotating start and copies one whole window per
    ready ring into consecutive rows of the caller's int16 matrix."""

    def __init__(self, rings):
        if not all(isinstance(r, NativeRingBuffer) for r in rings):
            raise RuntimeError("all rings must be native")
        self._lib = load_native()
        self._rings = list(rings)            # keep refs: prevents rb_destroy
        n = len(rings)
        self._ptrs = (ctypes.c_void_p * n)(*[r._ptr for r in rings])
        self.active = np.ones(n, np.uint8)
        self._idx = np.empty(n, np.int32)

    def __len__(self) -> int:
        return len(self._rings)

    def set_active(self, i: int, on: bool) -> None:
        self.active[i] = 1 if on else 0

    def pop_into(self, dst: np.ndarray, row0: int, start: int, limit: int,
                 n_win: int) -> np.ndarray:
        """Pop up to ``limit`` windows into ``dst[row0:]``; the ring indices
        of the filled rows (a view: consume it before the next call)."""
        if dst.dtype != np.int16 or not dst.flags.c_contiguous \
                or dst.shape[-1] != n_win \
                or row0 + min(limit, len(self._rings)) > len(dst):
            raise ValueError("dst must be a C-contiguous int16 (rows, n_win) "
                             "matrix with room for the pops")
        popped = self._lib.rb_pop_batch(
            self._ptrs, len(self._rings), start,
            self.active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            limit, n_win, dst.ctypes.data_as(_I16P), row0,
            self._idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return self._idx[:popped]


def make_ring(capacity: int):
    """A native ring where the host library builds, else the Python one."""
    try:
        return NativeRingBuffer(capacity)
    except RuntimeError:
        return PyRingBuffer(capacity)
