"""Device milliseconds a window of the pre-decision chain's kernels (D1,
D2, W1, W2) in the traced stretch."""

from perfbench.harness import CHAIN_KERNELS


def read(ctx):
    if not ctx.traced_windows or not ctx.device_events:
        return None
    t = ctx.device_s(lambda n: any(k in n for k in CHAIN_KERNELS))
    return t / ctx.traced_windows * 1e3 if t > 0 else None
