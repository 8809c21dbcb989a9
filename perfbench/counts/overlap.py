"""Counts of the overlap model (``OverlapResBLSTM``) from its shapes."""

from __future__ import annotations

from perfbench.counts import lstm, pool


def b3_shapes(model: dict, feature: dict) -> list:
    """(C, H, W) of each non-pooling block, the blocks kernel B3 runs."""
    H = feature["n_mels"]
    W = feature["time_dim"] + 1
    out = []
    for f in model["stage_filters"]:
        H, W = pool(H), pool(W)
        out += [(f, H, W)] * (model["blocks_per_stage"] - 1)
    return out


def model_flops(model: dict, feature: dict) -> float:
    """Forward FLOPs of one window: convolutions, the bidirectional LSTM
    and the head (multiply-adds as two)."""
    H, W = feature["n_mels"], feature["time_dim"] + 1
    ch = model["stem_filters"]
    flop = 2 * 3 * ch * H * W
    for f in model["stage_filters"]:
        Ho, Wo = pool(H), pool(W)
        flop += 2 * ch * f * Ho * Wo                      # strided shortcut
        flop += 2 * 9 * ch * f * H * W + 2 * 4 * f * f * H * W
        flop += (model["blocks_per_stage"] - 1) * 26 * f * f * Ho * Wo
        H, W, ch = Ho, Wo, f
    flop += lstm(ch, model["lstm_units"], W)
    return float(flop + 2 * 2 * model["lstm_units"] * model["num_classes"])
