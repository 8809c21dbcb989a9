"""Device milliseconds a window of the kernels launched inside WavLM's
``model.layers`` span (the 24 transformer layers, kernel A1 among them),
in the traced stretch."""

from perfbench.launched import per_window_ms


def read(ctx):
    return per_window_ms(ctx, "model.layers")
