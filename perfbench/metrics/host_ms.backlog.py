"""Host milliseconds a window in the multiplexer's own phases: ring gather,
staging and log appends (``Multiplexer.phase_seconds``), over the window
until the profiler started."""


def read(ctx):
    p, w = ctx.run.phase, ctx.run.phase_windows
    if not p or not w:
        return None
    return (p["gather"] + p["stage"] + p["resolve_log"]) / w * 1e3
