"""B3's share of its roofline: the least time of the traced batches' fused
residual blocks (``counts.block_work`` at each shape of the kind's
``b3_shapes``) over B3's traced device time, in %.  Nothing to read where
no B3 kernel ran or the kind has no fused block."""

import re

from perfbench import counts

B3 = re.compile(r"(^|[^\w])f?mma_kernel")


def read(ctx):
    t = ctx.device_s(lambda n: bool(B3.search(n)))
    shapes_of = getattr(counts.of(ctx.system.kind), "b3_shapes", None)
    if t <= 0 or not ctx.traced_batches or shapes_of is None:
        return None
    shapes = shapes_of(ctx.system.model, ctx.system.feature)
    least = sum(counts.bound_s(*counts.block_work(b, *shape))
                for b in ctx.traced_batches for shape in shapes)
    return least / t * 100.0
