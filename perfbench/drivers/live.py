"""Open loop in real time.  Each of ``streams`` conversations produces
``chunk_samples`` every chunk period; stream s's first chunk is due at a
phase drawn uniformly over ``phase_spread`` of one window period (1: spread
over the period; 0: every stream in step, as classes that start on the
hour).  Before each ``Multiplexer.tick()`` every chunk that is due is pushed
into its stream's native ring.  A window is due when the chunk holding its
last sample is; its latency runs from then to the append of its label, so
a slow tick also delays the generator.  After the window every window due
inside it waits up to ``grace_s`` on the clock for its label (then without
limit for the comparison, a minute at most)."""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np

from perfbench import gen
from perfbench.drivers import (Tracer, counters, mux_run, phase, settle,
                               span)


def run(system, traffic, seed, seconds, trace, dirs: Path, t_start):
    cfg = system.cfg
    n_win = cfg.audio.window_samples
    chunk = traffic["chunk_samples"]
    period = n_win / cfg.audio.sample_rate
    dt = chunk / cfg.audio.sample_rate
    N = traffic["streams"]
    run, mux, caps, entries, starts = mux_run(
        system, traffic, seed, seconds, traffic["ring_windows"], dirs)
    tap, pool, sampled = run.tap, run.pool, run.sampled
    offsets = gen.rng(seed, 5).uniform(
        0.0, traffic["phase_spread"] * period, N)
    pushed = np.zeros(N, np.int64)          # chunks pushed a stream
    settle()
    t0 = time.perf_counter()
    t_a = t0 + traffic["warmup_periods"] * period
    setup_s = t_a - t_start         # the queue's ramp is warm-up too
    t_b = t_a + seconds
    tracer = Tracer(run, t_b, traffic["trace_seconds"]) if trace else None
    due0 = t0 + offsets                      # stream s's first chunk is due
    opened = False
    snap0 = None

    def chunk_due(j, s):
        return due0[s] + (j + 1) * dt

    def window_due(k, s):
        # the chunk holding sample (k + 1) * n_win - 1
        j = ((k + 1) * n_win - 1) // chunk
        return chunk_due(j, s)

    def push(s, j1, now=None):
        j0 = int(pushed[s])
        caps[s].ring.push(pool.samples(int(entries[s]),
                                       int(starts[s]) + j0 * chunk,
                                       (j1 - j0) * chunk))
        if now is not None:
            run.lateness.append(now - chunk_due(j0, s))
        pushed[s] = j1

    snap = counters(mux, tap)
    idle = 0
    while True:
        now = time.perf_counter()
        if now >= t_b:
            break
        if not opened and now >= t_a:
            tap.open(range(N))
            tap.recording = True
            snap0 = (now, snap())
            opened = True
        if tracer is not None:
            tracer.poll(now, snap)
        n_due = np.floor((now - due0) / dt).astype(np.int64)
        with span("perfbench.push", trace):
            for s in np.nonzero(n_due > pushed)[0].tolist():
                push(s, int(n_due[s]), now if opened else None)
        # the program's own serving loop: tick, and back off while idle
        # (Multiplexer.run_until_exhausted), never past the next chunk
        with span("Multiplexer.tick", trace):
            got = mux.tick()
        if got == 0 and mux._inflight is None:
            idle += 1
            nxt = float(np.min(due0 + (pushed + 1) * dt))
            pause = min(0.001 * idle, 0.05, nxt - time.perf_counter())
            if pause > 0:
                time.sleep(pause)
        else:
            idle = 0
    if tracer is not None:
        tracer.close(snap)
    snap1 = (time.perf_counter(), snap())
    tap.recording = False
    # what fell due before the close reaches the rings, however late
    n_due = np.floor((t_b - due0) / dt).astype(np.int64)
    for s in np.nonzero(n_due > pushed)[0].tolist():
        push(s, int(n_due[s]))
    # every window due inside [t_a, t_b]
    due_k = {}
    for s in range(N):
        k_lo = max(0, math.ceil((t_a - due0[s]) * cfg.audio.sample_rate
                                / n_win) - 1)
        due_k[s] = [k for k in range(k_lo, k_lo + int(seconds / period) + 3)
                    if t_a <= window_due(k, s) < t_b]
    last = {s: max(ks) for s, ks in due_k.items() if ks}

    def all_labelled() -> bool:
        return all(len(mux.streams[s].results) > k for s, k in last.items())

    # tick until every due window is labelled, a minute at most (a window
    # labelled late is late, not missing); the check every 20 ms, so that
    # it takes no tick's time
    checked = 0.0
    while time.perf_counter() < t_b + 60.0:
        mux.tick()
        now = time.perf_counter()
        if now - checked > 0.02:
            checked = now
            if all_labelled():
                break
    thirds = ([], [], [])
    for s, ks in due_k.items():
        at = mux.streams[s].results.at
        for k in ks:
            lat = at[k] - window_due(k, s) \
                if k < len(at) and at[k] <= t_b + traffic["grace_s"] \
                else math.inf
            run.latencies.append(lat)
            part = min(2, int(3 * (window_due(k, s) - t_a) / seconds))
            thirds[part].append(lat)
    # a backlog that grows shows as later thirds waiting longer
    run.notes["thirds_ms"] = [float(np.median(t)) * 1e3 if t else None
                              for t in thirds]
    run.attempted = sum(len(ks) for ks in due_k.values())
    mux.flush()
    run.failed = sum(1 for x in run.latencies if x == math.inf)
    run.missing = sum(1 for s, ks in due_k.items() for k in ks
                      if k >= len(mux.streams[s].results))
    run.labels = {s: [r[1] for r in mux.streams[s].results] for s in sampled}
    if tracer is not None:
        tracer.stop()
    phase(run, mux, snap0, snap1, tracer)
    run.notes.update(setup_s=setup_s, mux=mux, caps=caps)
    return run
