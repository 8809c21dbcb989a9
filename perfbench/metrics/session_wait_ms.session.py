"""Host milliseconds a traced window blocked on the card: the program's
``session.vad_fetch`` (the denoised PCM to the host, for the detector) and
``session.probs_fetch`` (the probabilities).  Nothing to read without the
spans."""

from perfbench import spans


def read(ctx):
    waits = spans.named(ctx, "session.vad_fetch", "session.probs_fetch")
    if not waits:
        return None
    return spans.per_window_ms(ctx, spans.total_us(waits))
