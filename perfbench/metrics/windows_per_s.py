"""End to end: the windows labelled inside the measured window over its
seconds, all work over all wall time."""


def read(ctx):
    run = ctx.run
    return run.labelled / run.seconds if run.seconds > 0 else None
