"""Device milliseconds a window of the kernels launched inside WavLM's
``model.encoder`` span (the conv encoder, the feature projection and the
positional convolution), in the traced stretch."""

from perfbench.launched import per_window_ms


def read(ctx):
    return per_window_ms(ctx, "model.encoder")
