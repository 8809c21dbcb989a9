"""Capacity: ``streams`` conversations whose rings are topped up to
``topup_windows`` windows before each ``Multiplexer.tick()``, so that the
top bucket is always full; the rate is the work completed in the window.
``warmup_ticks`` ticks fill the pipeline before it opens."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from perfbench.drivers import (Tracer, counters, mux_run, phase, settle,
                               span, sync)


def run(system, traffic, seed, seconds, trace, dirs: Path, t_start):
    n_win = system.cfg.audio.window_samples
    N = traffic["streams"]
    run, mux, caps, entries, starts = mux_run(
        system, traffic, seed, seconds, traffic["topup_windows"] + 1, dirs)
    tap, pool = run.tap, run.pool
    fed = np.zeros(N, np.int64)               # samples pushed a stream
    want = traffic["topup_windows"] * n_win

    def top_up():
        for s in range(N):
            short = want - caps[s].ring.available
            if short > 0:
                caps[s].ring.push(pool.samples(int(entries[s]),
                                               int(starts[s] + fed[s]),
                                               int(short)))
                fed[s] += short

    for _ in range(traffic["warmup_ticks"]):
        top_up()
        mux.tick()
    sync(system.device)
    settle()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_b = t0 + seconds
    tracer = Tracer(run, t_b, traffic["trace_seconds"]) if trace else None
    snap = counters(mux, tap)
    tap.open(range(N))
    tap.recording = True
    snap0 = (t0, snap())
    while True:
        now = time.perf_counter()
        if now >= t_b:
            break
        if tracer is not None:
            tracer.poll(now, snap)
        with span("perfbench.top_up", trace):
            top_up()
        with span("Multiplexer.tick", trace):
            mux.tick()
    if tracer is not None:
        tracer.close(snap)
    snap1 = (time.perf_counter(), snap())
    tap.recording = False
    run.labelled = sum(sum(1 for a in st.results.at if t0 <= a < t_b)
                       for st in mux.streams)
    mux.flush()
    # every window dispatched from the window's opening on is due
    run.attempted = sum(tap.count[s] - tap.first[s] for s in range(N))
    run.failed = run.missing = sum(
        max(0, tap.count[s] - len(mux.streams[s].results)) for s in range(N))
    run.labels = {s: [r[1] for r in mux.streams[s].results]
                  for s in run.sampled}
    if tracer is not None:
        tracer.stop()
    phase(run, mux, snap0, snap1, tracer)
    run.notes.update(setup_s=setup_s, mux=mux, caps=caps)
    return run
