"""Host milliseconds a traced window in the multiplexer's blocking label
fetch, the program's ``mux.fetch`` span (``resolve_fetch``): how far the
device sets the tick's pace.  Nothing to read without the span."""

from perfbench import spans


def read(ctx):
    fetches = spans.named(ctx, "mux.fetch")
    if not fetches:
        return None
    return spans.per_window_ms(ctx, spans.total_us(fetches))
