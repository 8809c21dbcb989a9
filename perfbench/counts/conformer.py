"""Counts of wav2vec 2.0 Conformer's sequence classifier from its shapes,
and of kernel A2 (its relative-position attention, one launch a layer)."""

from __future__ import annotations

from perfbench.counts.wavlm import frames


def a2_shape(model: dict, feature: dict) -> tuple:
    """(frames, heads, head size) of one window's A2 launch, and the
    launches a forward (one a layer)."""
    H = model["num_attention_heads"]
    return (frames(model, feature["window_samples"]), H,
            model["hidden_size"] // H, model["num_hidden_layers"])


def a2_work(batch: int, T: int, heads: int, head_dim: int) -> tuple:
    """(FLOPs, bytes) of one A2 launch: three products of ``T^2 d`` a head
    (``(q + u) k^T``, the used band of ``(q + v) p^T``, ``prob v``;
    multiply-adds as two); q, k, v read and the output written once, the
    position table, ``u``, ``v`` and the key lengths read once."""
    flop = 3 * 2 * batch * heads * T * T * head_dim
    nbytes = 4 * (4 * batch * heads * T * head_dim
                  + heads * (2 * T - 1) * head_dim + 2 * heads * head_dim
                  + batch)
    return flop, nbytes


def model_flops(model: dict, feature: dict) -> float:
    """Forward FLOPs of one window (multiply-adds as two): the conv
    encoder, the projection, each layer's two FFNs, four projections,
    attention (``a2_work``'s three products) and conv module (two pointwise
    products and the depthwise convolution), and the head.  The position
    tables depend on the weights and the length alone and are made once,
    not a window, so they are not counted."""
    n = feature["window_samples"]
    cin, flop = 1, 0
    for c, k, s in zip(model["conv_dim"], model["conv_kernel"],
                       model["conv_stride"]):
        n = (n - k) // s + 1
        flop += 2 * cin * c * k * n
        cin = c
    T, D = n, model["hidden_size"]
    F = model["intermediate_size"]
    flop += 2 * T * cin * D                                  # projection
    layer = (2 * 2 * 2 * T * D * F                           # two FFNs
             + 2 * T * D * D * 4                             # q, k, v, out
             + 3 * 2 * T * T * D                             # attention
             + 2 * T * D * 2 * D + 2 * T * D * D             # pointwise
             + 2 * T * D * model["conv_depthwise_kernel_size"])
    flop += model["num_hidden_layers"] * layer
    P = model["classifier_proj_size"]
    flop += 2 * T * D * P + 2 * P * model["num_labels"]
    return float(flop)
