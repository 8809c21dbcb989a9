"""D1's share of its roofline: the least time of the traced batches' STFT
and inverse STFT (``counts.d1_work`` at each batch's rows and padded
length) over D1's traced device time, in %."""

from perfbench import counts
from perfbench.harness import D1_KERNELS


def read(ctx):
    t = ctx.device_s(lambda n: any(k in n for k in D1_KERNELS))
    if t <= 0 or not ctx.traced_batches:
        return None
    n = ctx.system.cfg.audio.window_samples + 2 * counts.denoise_pad()
    least = sum(counts.bound_s(*counts.d1_work(b, n))
                for b in ctx.traced_batches)
    return least / t * 100.0
