"""Device milliseconds a window of every other kernel in the traced
stretch: the featurizer or MFCC, the model, and the chain's elementwise
steps between its kernels."""

from perfbench.harness import CHAIN_KERNELS


def read(ctx):
    if not ctx.traced_windows or not ctx.device_events:
        return None
    t = ctx.device_s(lambda n: not any(k in n for k in CHAIN_KERNELS))
    return t / ctx.traced_windows * 1e3 if t > 0 else None
