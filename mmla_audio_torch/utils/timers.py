"""Stage timers, real-time-factor counters and device traces (counterpart
of ``mmla_audio_tpu.utils.timers``).

``StageTimer`` sums host wall clock a named stage; ``RtfMeter`` turns
decisions into the real-time factor and the p50 window-to-decision time.
Both read the host clock: a stage that enqueues work on the card must end
in a synchronizing read (``.cpu()``, ``torch.cuda.synchronize()``) to
count it.  ``device_trace`` records a ``torch.profiler`` trace and writes
it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np

__all__ = ["StageTimer", "RtfMeter", "device_trace"]


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
