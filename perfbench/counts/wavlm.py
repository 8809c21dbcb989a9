"""Counts of WavLM Large's sequence classifier from its shapes, and of
kernel A1 (its attention, one launch a layer)."""

from __future__ import annotations


def frames(model: dict, n: int) -> int:
    """Whole frames of the conv encoder over ``n`` samples."""
    for k, s in zip(model["conv_kernel"], model["conv_stride"]):
        n = (n - k) // s + 1
    return n


def a1_shape(model: dict, feature: dict) -> tuple:
    """(frames, heads, head size) of one window's A1 launch, and the
    launches a forward (one a layer)."""
    H = model["num_attention_heads"]
    return (frames(model, feature["window_samples"]), H,
            model["hidden_size"] // H, model["num_hidden_layers"])


def attn_work(batch: int, T: int, heads: int, head_dim: int) -> tuple:
    """(FLOPs, bytes) of one A1 launch: both products (``q k^T`` and ``p
    v``, multiply-adds as two); q, k, v read and the output written once,
    the gate, layer 0's bias table and the key lengths read once."""
    flop = 2 * 2 * batch * heads * T * T * head_dim
    nbytes = 4 * (4 * batch * heads * T * head_dim + batch * heads * T
                  + heads * (2 * T - 1) + batch)
    return flop, nbytes


def model_flops(model: dict, feature: dict) -> float:
    """Forward FLOPs of one window (multiply-adds as two): the conv
    encoder, the projection, the positional convolution, each layer's four
    projections, gate, attention and FFN, and the head."""
    n = feature["window_samples"]
    cin, flop = 1, 0
    for c, k, s in zip(model["conv_dim"], model["conv_kernel"],
                       model["conv_stride"]):
        n = (n - k) // s + 1
        flop += 2 * cin * c * k * n
        cin = c
    T, D = n, model["hidden_size"]
    H, F = model["num_attention_heads"], model["intermediate_size"]
    flop += 2 * T * cin * D                                  # projection
    flop += 2 * T * D * (D // model["num_conv_pos_embedding_groups"]) \
        * model["num_conv_pos_embeddings"]
    layer = (2 * T * D * D * 4 + 2 * T * D * 8                # proj, gate
             + 2 * 2 * T * T * D                             # attention
             + 2 * 2 * T * D * F)                            # FFN
    flop += model["num_hidden_layers"] * layer
    P = model["classifier_proj_size"]
    flop += 2 * T * D * P + 2 * P * model["num_labels"]
    return float(flop)
