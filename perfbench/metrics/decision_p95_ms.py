"""End to end: the nearest-rank 95th percentile, over every window due in
the measured window, of the time from when it was due to its label, in
ms.  A window not labelled within the grace counts as the longest: where
one falls at the 95th rank, the value is the longest wait given."""

import math

from perfbench.harness import percentile


def read(ctx):
    lat = ctx.run.latencies
    finite = [x for x in lat if x != math.inf]
    if not finite:
        return None
    p95 = percentile(lat, 95)
    if p95 == math.inf:
        p95 = max(finite)
    return p95 * 1e3
