"""Span arithmetic over a traced stretch's host events
(``harness.Context.host_events``: ``(start, end, name)`` in microseconds,
cut at the stretch's ends), for the readers of the program's spans
(``mmla_audio_torch.utils.timers``).

A span's self time is its length less the time that the program spans
inside it cover; the aten operators and launches inside it count as its
own host work.  Where the program opens no span (a program older than its
spans), every reader finds nothing and returns None.
"""

from __future__ import annotations

__all__ = ["PROGRAM", "named", "union_us", "total_us", "inside", "self_us",
           "per_window_ms"]

# the program's span names start so (the harness's own are ``perfbench.*``
# and ``Multiplexer.tick``)
PROGRAM = ("session.", "mux.", "chain.", "model.", "logs.", "setup.")


def named(ctx, *names) -> list:
    """The host events of ``ctx`` named one of ``names``, in start order."""
    want = set(names)
    return [e for e in ctx.host_events if e[2] in want]


def union_us(spans) -> float:
    """Microseconds that at least one of ``spans`` covers."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def total_us(spans) -> float:
    """The summed lengths of ``spans`` (each of them whole)."""
    return sum(e - s for s, e, _ in spans)


def inside(outer, spans) -> list:
    """``spans`` clipped to ``outer``, those that overlap it."""
    s0, e0 = outer[0], outer[1]
    return [(max(s, s0), min(e, e0), n) for s, e, n in spans
            if s < e0 and e > s0]


def self_us(outer, spans=None, ctx=None) -> float:
    """``outer``'s length less the time ``spans`` cover inside it (by
    default the program spans of ``ctx`` that lie within ``outer``)."""
    if spans is None:
        spans = [e for e in ctx.host_events if e != outer
                 and outer[0] <= e[0] and e[1] <= outer[1]
                 and e[2].startswith(PROGRAM)]
    return (outer[1] - outer[0]) - union_us(inside(outer, spans))


def per_window_ms(ctx, us: float):
    """``us`` microseconds of the traced stretch as milliseconds a traced
    window (None without windows)."""
    if not ctx.traced_windows:
        return None
    return us / ctx.traced_windows / 1e3
