"""The traffic generator's drivers, one file a kind of load, found by name:
a traffic mix (``perfbench/traffic/<mix>.json``) names its ``driver``, and
``load(name)`` imports ``perfbench/drivers/<name>.py``, whose

    run(system, traffic, seed, seconds, trace, dirs, t_start) -> Run

warms up every shape it uses, measures for ``seconds`` and hands back a
``Run``.  Its sizes, rates and sampling are the mix's keys.  This module
holds what the drivers share: the ``Run``, the tracer, the stamped result
lists, the multiplexer's set-up and warm-up, and ``settle``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench import gen
from perfbench.system import Tap

__all__ = ["Run", "Tracer", "load", "settle"]


def load(name: str):
    """The ``run`` function of ``perfbench/drivers/<name>.py``."""
    return importlib.import_module(f"perfbench.drivers.{name}").run


@dataclass
class Run:
    """What a driver hands back: latencies of the windows due inside the
    window (``inf``: never labelled within the grace), the windows labelled
    inside it, the host's phase counters, the tap and what the comparison
    needs to replay the sampled streams."""

    seconds: float
    latencies: list = field(default_factory=list)
    labelled: int = 0
    attempted: int = 0
    failed: int = 0          # not labelled within the grace
    missing: int = 0         # never labelled
    phase: dict = field(default_factory=dict)
    phase_windows: int = 0
    phase_span: float = 0.0
    lateness: list = field(default_factory=list)
    tap: Tap = None
    sampled: list = field(default_factory=list)
    audio: dict = field(default_factory=dict)    # stream -> (entry, start)
    labels: dict = field(default_factory=dict)   # stream -> [names]
    noise: dict = field(default_factory=dict)    # stream -> profile
    pool: gen.Pool = None
    trace: dict = None
    notes: dict = field(default_factory=dict)


def settle() -> None:
    """Called once set-up is done, before the window opens: collect what
    set-up left, and move every object that survives into the collector's
    permanent generation, so that a full collection in the window scans
    only what the window itself makes."""
    gc.collect()
    gc.freeze()


class Capture:
    """A stream's capture as the multiplexer reads it: a native ring the
    driver pushes into, never drained (the conversation goes on)."""

    def __init__(self, window: int, windows: int):
        from mmla_audio_torch.streaming.native import make_ring

        self.ring = make_ring(window * windows)
        self.drained = False

    def read_window(self, n, timeout=0.0):
        return self.ring.pop(n)

    def stop(self) -> None:
        pass


class Stamped(list):
    """A stream's ``results`` list that stamps each appended label with the
    host clock (the append follows the label's log write)."""

    def __init__(self):
        super().__init__()
        self.at = []

    def append(self, item):
        super().append(item)
        self.at.append(time.perf_counter())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Traces the last ``seconds`` of the window.  The profiler starts
    ``warm`` seconds before them (device events are dropped at a trace's
    start); two host events mark the stretch's ends, which
    ``harness.Context`` cuts the trace at; ``close`` marks the end when the
    window closes, and ``stop`` ends the profiler once the driver's work is
    done, so that its parsing delays no window."""

    OPEN, CLOSE = "perfbench.stretch.open", "perfbench.stretch.close"

    def __init__(self, run: Run, end: float, seconds: float,
                 warm: float = 0.5):
        self.run = run
        self.t1 = end - seconds
        self.t0 = self.t1 - warm
        self.state, self.prof, self.snap, self.end = 0, None, None, None
        self.started = None

    def _mark(self, name, counters):
        from torch.profiler import record_function

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with record_function(name):
            return (time.perf_counter(), counters())

    def poll(self, now: float, counters) -> None:
        from torch.profiler import ProfilerActivity, profile

        if self.state == 0 and now >= self.t0:
            self.started = (time.perf_counter(), counters())
            self.prof = profile(activities=[ProfilerActivity.CPU]
                                + [ProfilerActivity.CUDA]
                                * torch.cuda.is_available())
            self.prof.start()
            self.state = 1
        elif self.state == 1 and now >= self.t1:
            self.snap = self._mark(self.OPEN, counters)
            self.state = 2

    def close(self, counters) -> None:
        if self.state == 2:
            self.end = self._mark(self.CLOSE, counters)
            self.state = 3

    def stop(self) -> None:
        if self.prof is None:
            print("trace: the profiler never started", file=sys.stderr)
            return
        self.prof.stop()
        if self.state == 3:
            self.run.trace = dict(events=list(self.prof.events()),
                                  start=self.snap, end=self.end)
        else:
            print(f"trace: the stretch never opened (state {self.state})",
                  file=sys.stderr)
        self.prof = None


def span(name: str, on: bool):
    """A host span named in the trace (what the host was doing when the
    device idled); nothing when not tracing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def counters(mux, tap):
    def snap():
        out = dict(mux.phase_seconds) if mux is not None else {}
        out["windows"] = sum(tap.count.values())
        out["batches"] = len(tap.batches)
        return out
    return snap


def warm_mux(system, dirs, buckets, pool):
    """Run every bucket once on a throwaway multiplexer of the same
    predictor, so that no kernel loads or plan is chosen in the window."""
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    n_win = system.cfg.audio.window_samples
    for b in buckets:
        mux = Multiplexer(system.pred, dirs / f"warm{b}", kind=system.kind,
                          bucket=b, cfg=system.cfg, device=system.device)
        for s in range(b):
            mux.add_stream(f"w{s}", PrefilledCapture(
                pool.samples(s % len(pool.audio), s * 977, 2 * n_win)),
                pool.noise[int(pool.profile[s % len(pool.audio)])])
        mux.run_until_exhausted()
    sync(system.device)


def streams(seed, n, pool):
    """Each stream's recording and starting sample."""
    r = gen.rng(seed, 3)
    entries = r.integers(0, len(pool.audio), n)
    starts = r.integers(0, pool.audio.shape[1], n)
    return entries, starts


def sample(seed, n, k):
    """The streams the comparison samples."""
    return sorted(gen.rng(seed, 4).choice(n, size=min(k, n),
                                          replace=False).tolist())


def multiplexer(system, dirs, traffic, pool, entries, n_win, windows):
    """The multiplexer under test with one ``Capture`` a stream."""
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    mux = Multiplexer(system.pred, dirs, kind=system.kind,
                      buckets=tuple(traffic["buckets"]),
                      min_fill=traffic.get("min_fill"), cfg=system.cfg,
                      device=system.device)
    caps = []
    for s in range(len(entries)):
        cap = Capture(n_win, windows)
        st = mux.add_stream(f"s{s}", cap,
                            pool.noise[int(pool.profile[entries[s]])])
        st.results = Stamped()
        caps.append(cap)
    return mux, caps


def mux_run(system, traffic, seed, seconds, mux_windows, dirs: Path):
    """The pool, the warmed buckets, the multiplexer under test with its
    tap, and the ``Run`` that the multiplexer's drivers start from."""
    n_win = system.cfg.audio.window_samples
    N = traffic["streams"]
    pool = gen.conversations(seed, traffic["pool_conversations"],
                             traffic["pool_seconds"])
    warm_mux(system, dirs, traffic["buckets"], pool)
    entries, starts = streams(seed, N, pool)
    sampled = sample(seed, N, traffic["check_streams"])
    mux, caps = multiplexer(system, dirs / "serve", traffic, pool, entries,
                            n_win, mux_windows)
    tap = system.tap(lambda: [s.index for s in mux._pending_streams],
                     sampled, traffic["check_windows"])
    run = Run(seconds=seconds, tap=tap, sampled=sampled, pool=pool)
    run.audio = {s: (int(entries[s]), int(starts[s])) for s in sampled}
    run.noise = {s: int(pool.profile[entries[s]]) for s in sampled}
    return run, mux, caps, entries, starts


def phase(run: Run, mux, snap0, snap1, tracer):
    """Host phase seconds and windows over the window until the profiler
    started (its own cost falls after)."""
    if tracer is not None and tracer.started is not None:
        snap1 = tracer.started
    d = {k: snap1[1][k] - snap0[1][k] for k in mux.phase_seconds}
    run.phase, run.phase_windows = d, snap1[1]["windows"] - snap0[1]["windows"]
    run.phase_span = snap1[0] - snap0[0]
