"""Device milliseconds a window of the kernels launched inside the
Conformer's ``model.conv_module`` spans (each layer's LayerNorm, pointwise
products, GLU, depthwise convolution, BatchNorm and swish), in the traced
stretch."""

from perfbench.launched import per_window_ms


def read(ctx):
    return per_window_ms(ctx, "model.conv_module")
