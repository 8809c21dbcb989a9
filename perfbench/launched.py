"""Device time of the kernels that the host launched inside a program span
(``mmla_audio_torch.utils.timers``), from a traced run's profiler events.

A kernel runs after the host launches it, so a span's host stretch does
not hold its kernels' device time when the host runs ahead of the card.
The profiler hands each host operator the kernels it launched
(``FunctionEvent.kernels``, linked by correlation id); an operator's
kernels count for a span when the operator started inside one of the
span's stretches and inside the traced stretch.  Copies and sets are left
out.  Where the program opens no such span, or the profiler links no
kernel to any operator, there is nothing to read: None.
"""

from __future__ import annotations

import bisect

__all__ = ["device_us_inside", "per_window_ms"]

COPIES = ("Memcpy", "Memset")


def device_us_inside(ctx, name: str):
    """Microseconds of device time of the kernels launched inside the host
    spans named ``name`` in the traced stretch, or None."""
    trace = getattr(ctx.run, "trace", None)
    if trace is None:
        return None
    from torch.autograd import DeviceType

    from perfbench.drivers import Tracer

    events = trace["events"]
    marks = {e.name: e.time_range.start for e in events
             if e.name in (Tracer.OPEN, Tracer.CLOSE)}
    if len(marks) != 2:
        return None
    lo, hi = marks[Tracer.OPEN], marks[Tracer.CLOSE]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == name and e.device_type == DeviceType.CPU)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    # each span's end as a running maximum, so that the last span starting
    # before a launch says whether any span holds it
    ends, far = [], float("-inf")
    for _, e in spans:
        far = max(far, e)
        ends.append(far)
    total, linked = 0.0, False
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        kernels = [k for k in getattr(e, "kernels", ())
                   if not k.name.startswith(COPIES)]
        if not kernels:
            continue
        linked = True
        at = e.time_range.start
        i = bisect.bisect_right(starts, at) - 1
        if lo <= at < hi and i >= 0 and ends[i] >= at:
            total += sum(k.duration for k in kernels)
    return total if linked else None


def per_window_ms(ctx, name: str):
    """``device_us_inside`` as milliseconds a traced window, or None."""
    us = device_us_inside(ctx, name)
    if us is None or not ctx.traced_windows:
        return None
    return us / ctx.traced_windows / 1e3
