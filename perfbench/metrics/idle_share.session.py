"""The share of the traced stretch in which no operation ran on the
device, in %."""


def read(ctx):
    if not ctx.window_s or not ctx.busy_s:
        return None
    return (1.0 - ctx.busy_s / ctx.window_s) * 100.0
