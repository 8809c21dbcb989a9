"""The share of the frames WavLM's forwards computed that lay beyond their
rows' valid frames (padding: the trimmed window's tail, and the bucket's
padding rows), in %, from the predictor's frame counter
(``WavLMPredictor.frame_stats()``) over the run.  Nothing to read where
the predictor keeps no such counter."""


def read(ctx):
    stats = getattr(ctx.system.pred, "frame_stats", None)
    if stats is None:
        return None
    s = stats()
    if not s["computed"]:
        return None
    return (s["computed"] - s["valid"]) / s["computed"] * 100.0
