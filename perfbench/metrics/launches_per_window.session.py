"""Device operations (kernels, copies, fills) launched a window in the
traced stretch."""


def read(ctx):
    if not ctx.traced_windows or not ctx.device_events:
        return None
    return len(ctx.device_events) / ctx.traced_windows
