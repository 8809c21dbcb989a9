"""Counts of kernel E1, WavLM's conv encoder (one launch a layer), from the
configuration's shapes."""

from __future__ import annotations


def conv_encoder_work(model: dict, feature: dict, batch: int) -> tuple:
    """(FLOPs, bytes) of the conv encoder over ``batch`` windows: every
    layer's products (``2 C_in C_out k T_out`` a window, multiply-adds as
    two); the window's samples read, the weights, the convolutions' biases
    where there are any and the LayerNorm vectors read, and the last layer's
    output written, each once.  What a launch keeps on the chip between
    layers is not counted, so the count does not depend on what is fused."""
    n = feature["window_samples"]
    cin, flop, params = 1, 0, 0
    for c, k, s in zip(model["conv_dim"], model["conv_kernel"],
                       model["conv_stride"]):
        n = (n - k) // s + 1
        flop += 2 * cin * c * k * n
        params += cin * c * k + c * (2 + int(model["conv_bias"]))
        cin = c
    nbytes = 4 * (batch * feature["window_samples"] + params
                  + batch * n * cin)
    return flop * batch, nbytes
