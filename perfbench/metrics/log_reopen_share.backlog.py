"""The share of the traced windows' log appends that reopened their log,
in %: the program's ``logs.reopen`` spans inside its ``mux.log`` spans (a
miss of the log-handle LRU) over the traced windows, one append each.
Nothing to read without the ``mux.log`` spans."""

from perfbench import spans


def read(ctx):
    logs = spans.named(ctx, "mux.log")
    if not logs or not ctx.traced_windows:
        return None
    reopens = spans.named(ctx, "logs.reopen")
    n = sum(1 for r in reopens
            if any(s <= r[0] and r[1] <= e for s, e, _ in logs))
    return n / ctx.traced_windows * 100.0
