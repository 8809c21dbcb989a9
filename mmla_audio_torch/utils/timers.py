"""Stage timers, real-time-factor counters, device traces and the
program's spans (counterpart of ``mmla_audio_tpu.utils.timers``).

``StageTimer`` sums host wall clock a named stage; ``RtfMeter`` turns
decisions into the real-time factor and the p50 window-to-decision time.
Both read the host clock: a stage that enqueues work on the card must end
in a synchronizing read (``.cpu()``, ``torch.cuda.synchronize()``) to
count it.  ``device_trace`` records a ``torch.profiler`` trace and writes
it as a Chrome trace.

Spans.  ``span(name)`` names a stretch of the program's host work in a
trace: while a ``torch.profiler`` records (``device_trace``, a
``torch.profiler.profile`` of the caller's, the benchmark's ``--trace 1``:
the only switch) it opens ``torch.profiler.record_function(name)``, on the
same clock as the card's events; otherwise it costs one flag check.
``phase(totals, key, name)`` is a span that also adds its seconds to
``totals[key]`` (the multiplexer's ``phase_seconds``).  ``setup_span(name)``
is a span that also adds its seconds and count to ``PROGRAM``, always: the
program's set-up record for the process, which ``PROGRAM.summary()`` and
``setup_seconds()`` read after a run.  The names, ``<layer>.<phase>``:

* session (``streaming/session.py``): ``session.window`` a window of
  ``StreamingSession.run``, inside it ``session.read``, ``session.chain``
  (``session.vad_fetch``, ``session.vad_engine``, ``session.trim``),
  ``session.predict``, ``session.probs_fetch``, ``session.log``,
  ``session.callback``;
* multiplexer (``streaming/multiplex.py``): ``mux.gather``, ``mux.stage``,
  ``mux.dispatch`` (inside it ``chain.denoise``, ``chain.detect``,
  ``chain.trim``, ``model.features``, ``model.forward``, ``model.labels``),
  ``mux.fetch``, ``mux.log``;
* predictor (``inference.py``): ``model.features``, ``model.forward``
  (inside it the overlap model's ``model.stage`` a stage and ``model.lstm``,
  ``models/overlap.py``; WavLM's and the Conformer's ``model.encoder``,
  ``model.layers`` with a ``model.layer`` a layer, and ``model.head``,
  ``models/wavlm.py``, and inside each Conformer layer ``model.attention``
  and ``model.conv_module``, ``models/conformer.py``), ``model.labels``;
* logs (``analyze/logs.py``): ``logs.reopen``, an append handle opened on
  a miss of the handle LRU;
* set-up: ``setup.kernels`` (a kernel library built or loaded),
  ``setup.predictor``, ``setup.stream`` (``Multiplexer.add_stream``, a
  session's construction and noise profile), ``setup.calibrate`` (a miss of
  the multiplexer's calibration cache).

The counters beside them are plain integers, always on:
``analyze.logs.handle_stats()``, ``Multiplexer.calib_hits`` and
``calib_misses``, ``_build.compiles`` and ``_build.found``; kernel A1's
``wavlm_attention.launches``, kernel A2's ``conformer_attention.launches``
and ``.launches_split``, the Conformer's position-table builds
(``Wav2Vec2ConformerForSequenceClassification.table_builds``) and
``WavLMPredictor.frame_stats()`` (frames computed and frames within the
rows' valid lengths; ``ConformerPredictor``'s too).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np
import torch

__all__ = ["StageTimer", "RtfMeter", "device_trace", "span", "phase",
           "setup_span", "setup_seconds", "PROGRAM"]


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000.0 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


# one flag check: is a profiler recording?  (record_function costs several
# microseconds even with no profiler running)
_recording = getattr(torch._C._autograd, "_profiler_enabled", lambda: True)
_NOTHING = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    no-op context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NOTHING


@contextlib.contextmanager
def phase(totals: Dict[str, float], key: str, name: str):
    """``span(name)``, its host seconds added to ``totals[key]``."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        totals[key] += time.perf_counter() - t0


PROGRAM = StageTimer()       # the process's set-up spans, by name
_setup_lock = threading.Lock()
_setup_depth = 0             # set-up spans open now, in any thread
_setup_outer = 0.0           # seconds of the outermost set-up spans


@contextlib.contextmanager
def setup_span(name: str):
    """``span(name)``, its seconds and count added to ``PROGRAM`` (also as
    a decorator).  Set-up spans nest (a stream's calibration inside its
    ``add_stream``): ``setup_seconds`` counts the outermost only."""
    global _setup_depth, _setup_outer
    with _setup_lock:
        outer = _setup_depth == 0
        _setup_depth += 1
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _setup_lock:
            _setup_depth -= 1
            PROGRAM.totals[name] += dt
            PROGRAM.counts[name] += 1
            if outer:
                _setup_outer += dt


def setup_seconds() -> float:
    """The process's seconds in the program's set-up spans, nested spans
    counted once."""
    return _setup_outer


class RtfMeter:
    """Track decisions: audio seconds processed vs wall clock."""

    def __init__(self, window_seconds: float):
        self.window_seconds = window_seconds
        self.latencies: list[float] = []   # wall seconds per step
        self.windows: list[int] = []       # windows decided per step

    @contextlib.contextmanager
    def window(self, batch: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0, batch)

    def record(self, seconds: float, batch: int = 1):
        self.latencies.append(seconds)
        self.windows.append(batch)

    @property
    def rtf(self) -> float:
        if not self.latencies:
            return 0.0
        audio = self.window_seconds * sum(self.windows)
        return audio / sum(self.latencies)

    @property
    def p50_ms(self) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies) * 1000.0, 50))


@contextlib.contextmanager
def device_trace(log_dir):
    """Profile the block with ``torch.profiler``: CPU activity always, CUDA
    activity when a card is present (every kernel the block launches, with
    its device time); on exit the trace is written to
    ``log_dir/trace-<pid>.json`` (Chrome trace format: chrome://tracing,
    Perfetto).  Yields the profiler, whose ``key_averages()`` sums the
    trace by operator and kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"trace-{os.getpid()}.json"))
