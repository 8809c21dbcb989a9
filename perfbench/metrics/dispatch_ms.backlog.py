"""Host milliseconds a window spent enqueueing the batched program (the
multiplexer's ``dispatch`` phase), over the window until the profiler
started."""


def read(ctx):
    p, w = ctx.run.phase, ctx.run.phase_windows
    if not p or not w:
        return None
    return p["dispatch"] / w * 1e3
