"""Host milliseconds a traced window in the detector's call, the
program's ``session.vad_engine`` span: the native webrtc engine at B=1,
which the profiler cannot see inside.  Nothing to read without the
span."""

from perfbench import spans


def read(ctx):
    calls = spans.named(ctx, "session.vad_engine")
    if not calls:
        return None
    return spans.per_window_ms(ctx, spans.total_us(calls))
