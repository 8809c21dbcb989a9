"""Host milliseconds a traced window of the session's own work: the time
inside the program's ``session.window`` spans outside ``session.read`` and
``session.callback`` (the capture and the caller's callback), the two
blocking fetches (``session_wait_ms.session``) and the detector
(``vad_engine_ms.session``); the chain's and the model's enqueueing, the
trim and the log row.  Nothing to read without the spans."""

from perfbench import spans

APART = ("session.read", "session.callback", "session.vad_fetch",
         "session.probs_fetch", "session.vad_engine")


def read(ctx):
    windows = spans.named(ctx, "session.window")
    if not windows:
        return None
    apart = spans.named(ctx, *APART)
    return spans.per_window_ms(
        ctx, sum(spans.self_us(w, apart) for w in windows))
