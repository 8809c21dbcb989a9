"""One room, closed loop: the configuration kind's streaming session
(``OverlapSession``, ``SpeakerSession``) runs over one stream's windows
back to back, its detector state carried; each window is handed over as
soon as the session asks for it, and its latency runs from then to the
label.  ``warmup_windows`` windows run before the window opens."""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np

from perfbench import gen
from perfbench.drivers import Run, Tracer, counters, settle, streams, sync


class _RoomCapture:
    """One room's microphone for the closed loop: the next window as soon
    as it is asked for, until the driver's clock says stop."""

    def __init__(self, pool, entry, start, n_win):
        self.pool, self.entry, self.start, self.n_win = pool, entry, start, \
            n_win
        self.k = 0
        self.stop_at = math.inf
        self.handed: list = []

    def read_window(self, n, timeout=0.0):
        now = time.perf_counter()
        if now >= self.stop_at:
            return None
        w = self.pool.samples(self.entry, self.start + self.k * self.n_win, n)
        self.k += 1
        self.handed.append(now)
        return np.array(w, np.int16)


def run(system, traffic, seed, seconds, trace, dirs: Path, t_start):
    n_win = system.cfg.audio.window_samples
    pool = gen.conversations(seed, traffic["pool_conversations"],
                             traffic["pool_seconds"])
    entries, starts = streams(seed, 1, pool)
    cap = _RoomCapture(pool, int(entries[0]), int(starts[0]), n_win)
    tap = system.tap(lambda: [0], [0], traffic["check_windows"])
    sess = system.session(cap, dirs)
    sess.set_noise_profile(pool.noise[int(pool.profile[entries[0]])])
    run = Run(seconds=seconds, tap=tap, sampled=[0], pool=pool)
    run.audio = {0: (int(entries[0]), int(starts[0]))}
    run.noise = {0: int(pool.profile[entries[0]])}
    done: list = []
    labels: list = []

    def on_result(idx, label, prob):
        done.append(time.perf_counter())
        labels.append(label)

    sess.run(max_windows=traffic["warmup_windows"], on_result=on_result)
    sync(system.device)
    settle()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    first = len(done)
    tap.open([0])
    tap.recording = True
    snap = counters(None, tap)
    tracer = None
    if trace:
        tracer = Tracer(run, t0 + seconds, traffic["trace_seconds"])

        def on_result_traced(idx, label, prob):
            on_result(idx, label, prob)
            tracer.poll(time.perf_counter(), snap)
        callback = on_result_traced
    else:
        callback = on_result
    cap.stop_at = t0 + seconds
    sess.run(on_result=callback)
    if tracer is not None:
        tracer.close(snap)
        tracer.stop()
    tap.recording = False
    handed = cap.handed[first:]
    run.latencies = [d - h for h, d in zip(handed, done[first:])]
    run.attempted = len(handed)
    run.failed = run.missing = len(handed) - len(done[first:])
    run.labels = {0: labels}
    run.notes.update(setup_s=setup_s, session=sess)
    return run
